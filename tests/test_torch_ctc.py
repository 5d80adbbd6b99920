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


# ---------------------------------------------------------------------------
# the kernels' per-cell arithmetic and launch plan (csrc/ctc.cu), on the CPU


def _kernel_lse3(a, b, c, two):
    """A torch mirror of csrc/ctc.cu::lse3_k: the max's term as 1 + (m - m)
    and only the other exps taken; `two` (a gated cell) with c = NEG, whose
    term is left out as 0."""
    neg = torch.full_like(a, fused_ctc.NEG)
    if two:
        c = neg
    m = torch.maximum(a, torch.maximum(b, c))
    d = m - m
    one = 1.0 + d
    am = a == m
    ex = torch.exp(torch.where(am, b, a) - m)
    if two:
        e = one + ex
    else:
        cm = ~am & ~(b == m)
        ey = torch.exp(torch.where(cm, b, c) - m)
        e = torch.where(cm, (ex + ey) + one, (one + ex) + ey)
    return torch.where(m <= fused_ctc.NEG / 2, neg, (m + torch.log(e)) + d)


def _lse3_grid():
    """Every triple of special and ordinary values: ties, 0 and -0, exps
    that underflow, NEG and the NEG / 2 threshold with its neighbours,
    -1e29, -inf, +inf and NaN, then seeded random triples, some with
    repeated entries."""
    half = np.float32(fused_ctc.NEG / 2)
    special = np.array(
        [0.0, -0.0, -1e-3, -0.5, -1.5, -4.5, -20.0, -87.5, -104.0, -110.0,
         -1e29, fused_ctc.NEG, half, np.nextafter(half, np.float32(0)),
         np.nextafter(half, np.float32(-np.inf)), -np.inf, np.inf, np.nan],
        np.float32)
    a, b, c = (x.ravel() for x in np.meshgrid(special, special, special,
                                              indexing="ij"))
    rng = np.random.RandomState(9)
    r = (rng.randn(3, 20000) * 30).astype(np.float32)
    r[1, ::3] = r[0, ::3]                      # ties
    r[2, 1::3] = r[1, 1::3]
    return [torch.from_numpy(np.concatenate([x, y]))
            for x, y in zip((a, b, c), r)]


@pytest.mark.parametrize("two", [False, True], ids=["three-term", "gated"])
def test_kernel_lse3_is_bit_exact(two):
    """The kernels' lse3 (the max's exp as 1 + (m - m), a gated s-2 / s+2
    term as 0) equals fused_ctc.lse3 bit for bit, NaN for NaN."""
    a, b, c = _lse3_grid()
    if two:
        c = torch.full_like(a, fused_ctc.NEG)
    got = _kernel_lse3(a, b, c, two)
    want = fused_ctc.lse3(a, b, c)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), [(float(x), float(y), float(z)) for x, y, z in
                              zip(a[~same][:4], b[~same][:4], c[~same][:4])]
    assert bool(torch.isnan(want).any())
    assert bool((want == fused_ctc.NEG).any())


@pytest.mark.parametrize("smem_limit", [232448, 100 * 1024])
@pytest.mark.parametrize("streams", [1, 2], ids=["alpha", "beta"])
def test_launch_plan_covers_every_width(streams, smem_limit):
    """Every lattice width 1 ... 4096 gets a plan the kernels are built for:
    its threads' positions s = tid * items + k, those < S, are exactly
    0 ... S - 1, no warp holds only positions >= S, the fewest positions a
    thread within the thread cap, and the deepest built ring whose shared
    memory fits the limit (4 frames or more in the H100's)."""
    widest = fused_ctc.PLAN_MAX_THREADS * fused_ctc.PLAN_ITEMS[-1]
    assert widest == 4096
    for s in range(1, widest + 1):
        p = fused_ctc.launch_plan(s, streams, smem_limit)
        assert p.items in fused_ctc.PLAN_ITEMS
        assert p.ring in fused_ctc.PLAN_RINGS
        # at least 4 frames ahead in the H100's shared memory
        assert p.ring >= (4 if smem_limit >= 232448 else 2)
        assert p.threads % 32 == 0 and p.threads <= fused_ctc.PLAN_MAX_THREADS
        assert p.threads * p.items >= s > (p.threads - 32) * p.items
        smaller = [k for k in fused_ctc.PLAN_ITEMS if k < p.items]
        assert all(-(-s // k) > fused_ctc.PLAN_MAX_THREADS for k in smaller)
        assert p.smem == fused_ctc.plan_smem(streams, p.items, p.threads,
                                             p.ring) <= smem_limit
        deeper = [r for r in fused_ctc.PLAN_RINGS if r > p.ring]
        assert all(fused_ctc.plan_smem(streams, p.items, p.threads, r)
                   > smem_limit for r in deeper)
    owned = sorted(tid * p.items + k for tid in range(p.threads)
                   for k in range(p.items) if tid * p.items + k < widest)
    assert owned == list(range(widest))
    for bad in (0, widest + 1):
        with pytest.raises(ValueError, match="plan"):
            fused_ctc.launch_plan(bad, streams, smem_limit)
