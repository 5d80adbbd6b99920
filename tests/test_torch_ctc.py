"""vietasr_tpu_torch's CTC loss (ops/ctc_loss.py) and the plain version of
its kernel pair (ops/fused_ctc.py) vs the JAX package's `ctc_loss`, on the
CPU, on the same seeded numpy inputs.

Routes compared: the port's impl="plain" (autograd through the alpha loop)
against JAX's impl="scan" (autodiff through lax.scan), and the port's
impl="kernel" (the autograd Function; on CPU tensors its plain alpha/beta
versions) against JAX's impl="pallas_interpret" (the Pallas pair in
interpret mode) and, on feasible rows, against "scan" too.

Tolerances: losses within 1e-5 relative (fp32 exp/log chains over <= 40
steps, summed in another order by XLA's and PyTorch's CPU kernels: ~1e-7
measured); gradients within 1e-5 absolute (entries lie in [-1, 0] per
sample; ~1e-6 measured). torch.nn.CTCLoss is the third oracle for the
loss, as in tests/test_ctc_loss.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vietasr_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from vietasr_tpu_torch.ops import fused_ctc
from vietasr_tpu_torch.ops.ctc_loss import (ctc_loss, emission_lookup,
                                            lattice_masks)

torch.set_num_threads(1)

V, BLANK = 6, 5
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5


def _random_case(seed, b=5, t=24, l=7, tmin=12):
    """B = 5 (not a multiple of 8), S = 2L+1 = 15 (not a multiple of 128)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, V).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    targets = rng.randint(0, V - 1, size=(b, l)).astype(np.int32)
    ilens = rng.randint(tmin, t + 1, size=(b,)).astype(np.int32)
    tlens = rng.randint(1, l + 1, size=(b,)).astype(np.int32)
    return lp, targets, ilens, tlens


def _edge_case():
    """A row with target length 0, an infeasible row (3 frames for 4
    labels), repeated labels (skips refused), a frozen short row."""
    rng = np.random.RandomState(3)
    b, t = 4, 20
    lp = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.randn(b, t, V).astype(np.float32)), axis=-1))
    targets = np.array([[1, 1, 2, 2, 1, 0],
                        [3, 0, 0, 0, 0, 0],
                        [0, 0, 0, 0, 0, 0],
                        [1, 2, 3, 4, 0, 0]], np.int32)
    ilens = np.array([20, 9, 15, 3], np.int32)
    tlens = np.array([6, 1, 0, 4], np.int32)
    return lp, targets, ilens, tlens


def _long_label_case():
    """B = 1, S = 2 * 64 + 1 = 129: just above a multiple of 128 (and of a
    warp), and a lattice wider than the frames are many."""
    rng = np.random.RandomState(7)
    t, l = 140, 64
    lp = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.randn(1, t, V).astype(np.float32) * 2), axis=-1))
    targets = rng.randint(0, V - 1, size=(1, l)).astype(np.int32)
    return lp, targets, np.array([t], np.int32), np.array([l], np.int32)


CASES = {"seed0": lambda: _random_case(0), "seed1": lambda: _random_case(1),
         "edge": _edge_case, "long": _long_label_case}


def _jax_value_grad(case, reduction, impl):
    lp, targets, ilens, tlens = case
    weights = jnp.arange(1, lp.shape[0] + 1, dtype=jnp.float32)

    def f(x):
        out = jax_ctc_loss(x, jnp.asarray(targets), jnp.asarray(ilens),
                           jnp.asarray(tlens), blank=BLANK,
                           reduction=reduction, impl=impl)
        # distinct per-row weights: a row's gradient scale is checked too
        return (jnp.sum(out * weights) if reduction == "none" else out), out

    (_, out), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(lp))
    return np.asarray(out), np.asarray(g)


def _port_value_grad(case, reduction, impl):
    lp, targets, ilens, tlens = case
    x = torch.tensor(lp, requires_grad=True)
    out = ctc_loss(x, torch.from_numpy(targets), torch.from_numpy(ilens),
                   torch.from_numpy(tlens), blank=BLANK, reduction=reduction,
                   impl=impl)
    weights = torch.arange(1, lp.shape[0] + 1, dtype=torch.float32)
    (out * weights).sum().backward() if reduction == "none" \
        else out.backward()
    return out.detach().numpy(), x.grad.numpy()


def _check(got, want):
    (v, g), (v_want, g_want) = got, want
    np.testing.assert_allclose(v, v_want, rtol=LOSS_RTOL)
    assert np.abs(g - g_want).max() <= GRAD_ATOL


@pytest.mark.parametrize("reduction", ["none", "mean_batch", "mean"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_scan(case, reduction):
    c = CASES[case]()
    _check(_port_value_grad(c, reduction, "plain"),
           _jax_value_grad(c, reduction, "scan"))


@pytest.mark.parametrize("reduction", ["none", "mean_batch", "mean"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_route_matches_jax_pallas(case, reduction):
    c = CASES[case]()
    _check(_port_value_grad(c, reduction, "kernel"),
           _jax_value_grad(c, reduction, "pallas_interpret"))


@pytest.mark.parametrize("case", ["seed0", "seed1"])
def test_kernel_route_matches_scan_autodiff(case):
    """On feasible rows the analytic beta gradient equals autodiff through
    the recursion. (Only at T = 24: exp(alpha + beta - ll) takes the
    rounding of alpha + beta, ~1e-7 of their size, so at T = 140 the two
    gradients differ by ~9e-5 in JAX as in the port; the "long" case is
    held against the Pallas pair above instead.)"""
    c = CASES[case]()
    _check(_port_value_grad(c, "none", "kernel"),
           _jax_value_grad(c, "none", "scan"))


def test_infeasible_row_and_padding_grads():
    """The kernel route: an infeasible row's loss is the ~1e30 sentinel
    with an all-zero gradient; frames past each input length get exactly
    zero gradient."""
    lp, targets, ilens, tlens = _edge_case()
    loss, g = _port_value_grad((lp, targets, ilens, tlens), "none", "kernel")
    assert loss[3] > 1e29 and (loss[:3] < 1e5).all()
    assert np.abs(g[3]).max() == 0.0
    for row in range(3):
        assert not g[row, ilens[row]:].any()
        assert np.abs(g[row, :ilens[row]]).sum() > 0


def test_gradient_sign_and_occupancy():
    """d(-ll)/d lp_ext = -exp(alpha + beta - ll): every entry <= 0, and on a
    feasible row each valid frame's occupancies sum to one, so the loss
    gradient summed over the classes is -1 per frame. A flipped sign in
    the Function (it differentiates +ll; the loss is -ll) fails here."""
    lp, targets, ilens, tlens = _random_case(2)
    for impl in ("kernel", "plain"):
        _, g = _port_value_grad((lp, targets, ilens, tlens), "none", impl)
        g = g / np.arange(1, lp.shape[0] + 1)[:, None, None]
        for row in range(lp.shape[0]):
            per_frame = g[row, :ilens[row]].sum(-1)
            np.testing.assert_allclose(per_frame, -1.0, atol=1e-5)


def test_plain_function_matches_pallas_lattice():
    """The kernel pair's plain versions on the lattice itself: the loss and
    d(-ll)/d lp_ext against JAX's ctc_neg_ll_pallas (interpret mode)."""
    from vietasr_tpu.ops.pallas_ctc import ctc_neg_ll_pallas

    lp, targets, ilens, tlens = _edge_case()
    ext, can, valid = lattice_masks(torch.from_numpy(targets),
                                    torch.from_numpy(tlens), BLANK)
    lp_ext = emission_lookup(torch.from_numpy(lp), ext)
    args = (jnp.asarray(can.numpy()), jnp.asarray(valid.numpy()),
            jnp.asarray(ilens), jnp.asarray(tlens))

    def f(x):
        return jnp.sum(ctc_neg_ll_pallas(x, *args, interpret=True)[:3])

    want_loss = np.asarray(ctc_neg_ll_pallas(jnp.asarray(lp_ext.numpy()),
                                             *args, interpret=True))
    want_g = np.asarray(jax.grad(f)(jnp.asarray(lp_ext.numpy())))
    x = lp_ext.clone().requires_grad_(True)
    loss = fused_ctc.ctc_neg_ll(x, can, valid, torch.from_numpy(ilens),
                                torch.from_numpy(tlens), plain=True)
    loss[:3].sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want_loss,
                               rtol=LOSS_RTOL)
    assert np.abs(x.grad.numpy() - want_g).max() <= GRAD_ATOL


def test_emission_lookup_is_exact():
    """The one-hot product returns the looked-up log-probs bit for bit
    (and zero rows for labels outside [0, V))."""
    lp, targets, _, tlens = _random_case(4)
    targets[0, -1] = -1
    ext, _, _ = lattice_masks(torch.from_numpy(targets),
                              torch.from_numpy(tlens), BLANK)
    got = emission_lookup(torch.from_numpy(lp), ext).numpy()
    e = ext.numpy()
    want = np.take_along_axis(lp, np.clip(e, 0, V - 1)[:, None, :], axis=2)
    want[np.broadcast_to((e < 0)[:, None, :], want.shape)] = 0.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_loss_matches_torch_ctcloss(impl):
    """Third oracle: torch.nn.CTCLoss(reduction='none') on feasible rows;
    an infeasible row is torch's inf and the port's finite ~1e30 sentinel
    (masked per sample by the train step, zero_infinity semantics)."""
    lp, targets, ilens, tlens = _edge_case()
    want = torch.nn.CTCLoss(blank=BLANK, reduction="none")(
        torch.from_numpy(lp).transpose(0, 1),
        torch.from_numpy(targets.astype(np.int64)),
        torch.from_numpy(ilens.astype(np.int64)),
        torch.from_numpy(tlens.astype(np.int64))).numpy()
    got, _ = _port_value_grad((lp, targets, ilens, tlens), "none", impl)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-4, atol=1e-4)
    assert np.isinf(want[3]) and 1e29 < got[3] < np.inf


def test_bad_arguments_raise():
    lp, targets, ilens, tlens = _random_case(0)
    args = (torch.from_numpy(lp), torch.from_numpy(targets),
            torch.from_numpy(ilens), torch.from_numpy(tlens))
    with pytest.raises(ValueError, match="impl"):
        ctc_loss(*args, blank=BLANK, impl="pallas")
    with pytest.raises(ValueError, match="reduction"):
        ctc_loss(*args, blank=BLANK, reduction="sum")
