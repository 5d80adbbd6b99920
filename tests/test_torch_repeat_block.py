"""vietasr_tpu_torch fused repeat block vs the JAX package's, on the CPU.

The port's wrapper takes its plain version for CPU tensors; it is held
against the Pallas kernel in interpret mode on the same seeded numpy
inputs. Both compute the depthwise in fp32 and round its result and the
residual input to bf16 for fp32-accumulated products, so they agree to
within one bf16 rounding step of the output: tolerance 2^-7 * max|want|
(the JAX package's own test allows 0.03 * max|want|).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietasr_tpu.ops.pallas_repeat import block_eligible as jax_eligible
from vietasr_tpu.ops.pallas_repeat import fused_repeat_block as jax_block
from vietasr_tpu_torch.config import BlockConfig
from vietasr_tpu_torch.ops.repeat_block import (block_eligible,
                                                fused_repeat_block)

torch.set_num_threads(1)

REL_TOL = 2.0 ** -7


def _operands(c_in, c_out, k, r, t, bsz=3, residual=True, seed=0,
              lens=None):
    rng = np.random.RandomState(seed)
    x = (rng.randn(bsz, t, c_in) * 0.5).astype(np.float32)
    lens = np.array([t, t - 7, max(t // 2, 1)][:bsz] if lens is None
                    else lens, np.int32)
    cs = [c_in] + [c_out] * (r - 1)
    dws = [(rng.randn(k, c) * k ** -0.5).astype(np.float32) for c in cs]
    pws = [(rng.randn(c, c_out) * c ** -0.5).astype(np.float32) for c in cs]
    bs = [(rng.randn(c_out) * 0.1).astype(np.float32) for _ in cs]
    res_w = (rng.randn(c_in, c_out) * c_in ** -0.5).astype(np.float32) \
        if residual else None
    res_b = (rng.randn(c_out) * 0.1).astype(np.float32) if residual else None
    return x, lens, dws, pws, bs, res_w, res_b


def _jax(x, lens, dws, pws, bs, res_w, res_b, k):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = jax_block(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(lens),
                    [j(a) for a in dws], [j(a) for a in pws],
                    [j(a) for a in bs], j(res_w), j(res_b), kernel=k,
                    interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(x, lens, dws, pws, bs, res_w, res_b, k, fn=fused_repeat_block):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = fn(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(lens),
             [t(a) for a in dws], [t(a) for a in pws], [t(a) for a in bs],
             t(res_w), t(res_b), kernel=k)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _case(c_in, c_out, k, r, t, lens=None, name=None):
    return pytest.param(c_in, c_out, k, r, t, lens,
                        id=name or f"{c_in}-{c_out}-{k}-{r}-{t}")


@pytest.mark.parametrize("c_in,c_out,k,r,t,lens", [
    _case(8, 8, 9, 3, 64),        # square, multi-repeat
    _case(8, 16, 7, 2, 50),       # widening first repeat
    _case(16, 16, 33, 5, 40),     # halo wider than T
    _case(16, 32, 33, 1, 48),     # C_in < C_out, R = 1 (QuartzNet12x1 block 7)
    # the CUDA kernel's tile geometry (64- or 32-row tiles; a tile that
    # starts at or past len is skipped and written from the biases): a
    # zero-length and a length-1 row, T not a multiple of 64 with lengths
    # that leave whole 64-row tiles (and 32-row ones) of padding
    _case(16, 16, 9, 1, 70, [70, 0, 1], "len0-len1-T70"),
    _case(32, 16, 33, 1, 130, [130, 64, 5], "T130-whole-pad-tiles"),
    _case(16, 32, 17, 2, 130, [1, 129, 63], "T130-R2-len1"),
    _case(32, 32, 33, 1, 70, [0, 32, 64], "T70-tile-boundaries"),
])
def test_matches_jax_pallas_block(c_in, c_out, k, r, t, lens):
    ops = _operands(c_in, c_out, k, r, t, lens=lens)
    want = _jax(*ops, k)
    launches = fused_repeat_block.launches
    got = _port(*ops, k)
    assert fused_repeat_block.launches == launches    # no kernel on CPU
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def test_no_residual_block_matches_jax():
    ops = _operands(8, 8, 5, 2, 30, bsz=2, residual=False, seed=1)
    want = _jax(*ops, 5)
    got = _port(*ops, 5)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def test_rows_beyond_len_are_relu_of_biases():
    """Rows t >= len come out as relu(b_pw + b_res), as in JAX."""
    x, lens, dws, pws, bs, res_w, res_b = _operands(16, 16, 9, 1, 40)
    got = _port(x, lens, dws, pws, bs, res_w, res_b, 9)
    want = np.maximum(bs[0] + res_b, 0.0)
    tail = got[2, lens[2]:]
    np.testing.assert_allclose(tail, np.broadcast_to(want, tail.shape),
                               rtol=2.0 ** -8, atol=1e-6)


def test_eligibility_gate_matches_jax():
    bcfg = BlockConfig(filters=16, repeat=2, kernel=5, residual=True,
                       separable=True)
    folded = {"sub": [{"dw_w": 0, "pw_w": 0, "b": 0}] * 2,
              "res": [{"conv_w": 0, "b": 0}], "se": []}
    unfolded = {"sub": [{"dw_w": 0, "pw_w": 0, "bn": {}}] * 2,
                "res": [{"conv_w": 0, "bn": {}}], "se": []}
    variants = [(bcfg, folded, False), (bcfg, folded, True),
                (bcfg, unfolded, False)]
    for change in ({"stride": 2}, {"separable": False}, {"dilation": 2},
                   {"groups": 2}, {"se": True}, {"heads": 4}):
        variants.append((dataclasses.replace(bcfg, **change), folded, False))
    for cfg, params, training in variants:
        assert block_eligible(cfg, params, training) \
            == jax_eligible(cfg, params, training)
    assert block_eligible(bcfg, folded, False)
    assert not block_eligible(bcfg, unfolded, False)
