"""vietasr_tpu_torch fused repeat block vs the JAX package's, on the CPU.

The port's wrapper takes its plain version for CPU tensors; it is held
against the Pallas kernel in interpret mode on the same seeded numpy
inputs. Both compute the depthwise in fp32 and round its result and the
residual input to bf16 for fp32-accumulated products, so they agree to
within one bf16 rounding step of the output: tolerance 2^-7 * max|want|
(the JAX package's own test allows 0.03 * max|want|). The same bar holds
at R = 5 and QuartzNet15x5's kernel sizes.

The whole-block CUDA kernel (csrc/repeat_whole_block.cu) runs only on a
GPU; here its launch plan (`whole_block_plan`) is checked, and a torch
transliteration of its tile schedule (the halo'd rows, the cluster's
column slices, the clamped depthwise reads, the masks, the residual and
padding tiles) is held to the plain version within the same bar.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietasr_tpu.ops.pallas_repeat import block_eligible as jax_eligible
from vietasr_tpu.ops.pallas_repeat import fused_repeat_block as jax_block
from vietasr_tpu_torch import _build
from vietasr_tpu_torch.config import BlockConfig
from vietasr_tpu_torch.ops.repeat_block import (WholeBlockPlan,
                                                block_eligible,
                                                fused_repeat_block,
                                                fused_repeat_block_plain,
                                                repeat_whole_block_cuda,
                                                whole_block_plan,
                                                whole_block_smem,
                                                whole_block_takes)

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
    # R = 5 at QuartzNet15x5's kernel sizes, narrow: a zero-length row, a
    # widening first repeat, halos of 5 x 37 rows a side wider than T
    _case(16, 16, 33, 5, 100, [100, 0, 37], "R5-K33-len0"),
    _case(16, 32, 39, 5, 64, [64, 63, 9], "R5-K39-widening"),
    _case(32, 32, 51, 5, 90, [90, 1, 45], "R5-K51-len1"),
    _case(16, 16, 63, 5, 120, [120, 64, 0], "R5-K63-len0"),
    _case(32, 32, 75, 5, 60, [60, 0, 1], "R5-K75-halo-wider-than-T"),
    _case(16, 32, 75, 5, 200, [200, 150, 0], "R5-K75-T200"),
])
def test_matches_jax_pallas_block(c_in, c_out, k, r, t, lens):
    ops = _operands(c_in, c_out, k, r, t, lens=lens)
    want = _jax(*ops, k)
    launches = (fused_repeat_block.launches,
                repeat_whole_block_cuda.launches)
    got = _port(*ops, k)
    assert (fused_repeat_block.launches,
            repeat_whole_block_cuda.launches) == launches  # no kernel on CPU
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


# QuartzNet15x5's R = 5 block shapes (C_in, C_out, K) and the encoder grid
# of a 16.7 s bucket at B = 8
QN15X5_SHAPES = ((256, 256, 33), (256, 256, 39), (256, 512, 51),
                 (512, 512, 51), (512, 512, 63), (512, 512, 75))


@pytest.mark.parametrize("bsz,t", [(8, 840), (1, 100), (16, 420), (27, 752)])
@pytest.mark.parametrize("c_in,c_out,k", QN15X5_SHAPES)
def test_whole_block_plan_fits_every_15x5_block(c_in, c_out, k, bsz, t):
    """Every R = 5 block of QuartzNet15x5 has a plan: a cluster of at most
    8 blocks, each within the shared memory one H100 block may use, its
    column slices of <= 64 columns covering C_in and C_out, its tiles
    covering T."""
    plan = whole_block_plan(bsz, t, c_in, c_out, k, 5)
    assert 1 <= plan.cluster <= 8
    assert plan.smem_bytes == whole_block_smem(plan.tile_rows, k, 5,
                                               plan.cols, plan.in_cols)
    assert plan.smem_bytes <= _build.SMEM_LIMIT
    assert plan.cols * plan.cluster == c_out and plan.cols <= 64
    assert plan.in_cols * plan.cluster == c_in and plan.in_cols <= 64
    assert plan.cols % 16 == 0 and plan.in_cols % 8 == 0
    assert plan.tile_rows % 16 == 0
    assert plan.tiles * plan.tile_rows >= t > (plan.tiles - 1) \
        * plan.tile_rows
    assert whole_block_takes(c_in, c_out, k, 5)


@pytest.mark.parametrize("shape", [
    dict(c_in=512, c_out=1024, kernel=75),   # 16 blocks of 64 columns
    dict(c_in=512, c_out=512, kernel=201),   # a 16-row tile's halo too big
    dict(c_in=24, c_out=32, kernel=9),       # C_in not a multiple of 16
    dict(c_in=16, c_out=512, kernel=9),      # 2 input channels a block
    dict(c_in=32, c_out=32, kernel=8),       # an even kernel
])
def test_whole_block_plan_refuses_with_the_shape(shape):
    with pytest.raises(ValueError, match=f"C_in={shape['c_in']}, "
                       f"C_out={shape['c_out']}, K={shape['kernel']}"):
        whole_block_plan(8, 840, shape["c_in"], shape["c_out"],
                         shape["kernel"], 5)
    # the model's route asks the same question and runs such a block per op
    assert not whole_block_takes(shape["c_in"], shape["c_out"],
                                 shape["kernel"], 5)


def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def _whole_block_mirror(x, lens, dws, pws, bs, res_w, res_b, k, last_act,
                        plan):
    """csrc/repeat_whole_block.cu's schedule, transliterated: per (row,
    tile) a cluster of plan.cluster blocks, each with its own slice of x
    over the E0 halo'd rows (index = halo-frame row), fp32 activations and
    bf16 depthwise output over E1 = E0 - 2 * K/2 rows (index = row - K/2),
    the depthwise reading rows clamped to the repeat's last input row, the
    1x1 gathering every block's slice, the residual from x's centre rows,
    a tile at or past len written from the biases. Index checks stand for
    the kernel's buffer bounds."""
    bsz, t, c_in = x.shape
    r, c_out = len(dws), pws[-1].shape[1]
    tt, ncl, cw, cw_in = (plan.tile_rows, plan.cluster, plan.cols,
                          plan.in_cols)
    k2 = k // 2
    halo = r * k2
    e0 = tt + 2 * halo
    e1 = e0 - 2 * k2
    k8 = -(-k // 8) * 8
    out = torch.full((bsz, t, c_out), float("nan"))
    res_b0 = res_b if res_w is not None else torch.zeros(c_out)
    for b in range(bsz):
        ln = min(int(lens[b]), t)
        for tile in range(plan.tiles):
            t0 = tile * tt
            rows = min(tt, t - t0)
            if t0 >= ln:
                z = bs[-1].clone()
                if last_act:
                    z = torch.relu(z)
                out[b, t0:t0 + rows] = torch.relu(z + res_b0)
                continue
            g = torch.arange(e0) + t0 - halo
            valid = (g >= 0) & (g < ln)
            xs = x[b, g.clamp(0, t - 1)].float()
            staged = [torch.where(valid[:, None],
                                  xs[:, rank * cw_in:(rank + 1) * cw_in], 0.0)
                      for rank in range(ncl)]
            act = [torch.full((e1, cw), float("nan")) for _ in range(ncl)]
            for rr in range(r):
                last = rr == r - 1
                cwx = cw_in if rr == 0 else cw
                lo, hi = (rr + 1) * k2, e0 - (rr + 1) * k2
                assert 0 <= lo - k2 and hi + k2 <= e0
                taps = torch.zeros(k8, dws[rr].shape[1])
                taps[:k] = dws[rr]
                i = torch.arange(lo, hi)
                src = (i[:, None] - k2 + torch.arange(k8)[None, :]) \
                    .clamp(max=hi + k2 - 1)
                assert int(src.min()) >= rr * k2
                if rr:
                    src = src - k2
                    assert int(src.min()) >= 0 and int(src.max()) < e1
                ybuf = []
                for rank in range(ncl):
                    a = act[rank] if rr else staged[rank]
                    w = taps[:, rank * cwx:(rank + 1) * cwx]
                    y = (a[src] * w[None]).sum(1)
                    y = torch.where(valid[lo:hi, None], y, 0.0)
                    yb = torch.zeros(e1, cwx)
                    assert hi - k2 <= yb.shape[0]
                    yb[lo - k2:hi - k2] = _bf16(y)
                    ybuf.append(yb)
                a_full = torch.cat(ybuf, 1)[lo - k2:hi - k2]     # (rows, cx)
                for rank in range(ncl):
                    cols = slice(rank * cw, (rank + 1) * cw)
                    z = a_full @ _bf16(pws[rr][:, cols].float())
                    if not last:
                        z = torch.relu(z + bs[rr][cols])
                        act[rank][lo - k2:hi - k2] = torch.where(
                            valid[lo:hi, None], z, 0.0)
                        continue
                    assert (lo, hi) == (halo, halo + tt)
                    z = z + bs[rr][cols]
                    if last_act:
                        z = torch.relu(z)
                    if res_w is not None:
                        centre = torch.where(valid[lo:hi, None],
                                             _bf16(xs[lo:hi]), 0.0)
                        z = z + centre @ _bf16(res_w[:, cols].float()) \
                            + res_b[cols]
                    out[b, t0:t0 + rows, cols] = torch.relu(z)[:rows]
    return out


# small grids take 16-row tiles; a card that holds few clusters at once
# makes the plan take larger ones; `tile_rows` forces a tile in between


def _at_once(clusters):
    return lambda cluster, smem_bytes: clusters


@pytest.mark.parametrize("c_in,c_out,k,r,t,lens,last_act,residual,plan_kw,"
                         "tile_rows", [
    (64, 128, 33, 5, 100, [100, 0, 37], False, True, {}, None),
    (32, 128, 9, 3, 150, [150, 20, 149], True, True,
     {"clusters_at_once": _at_once(1)}, None),
    (64, 64, 75, 5, 60, [60, 1, 0], False, True,
     {"clusters_at_once": _at_once(1)}, None),
    (32, 48, 7, 2, 70, [70, 33, 3], False, False, {}, None),
    (64, 128, 17, 5, 130, [130, 5, 64], True, True, {}, 48),
    (128, 128, 11, 5, 97, [1, 97, 40], False, True, {}, 48),
])
def test_whole_block_schedule_matches_plain(c_in, c_out, k, r, t, lens,
                                            last_act, residual, plan_kw,
                                            tile_rows):
    ops = _operands(c_in, c_out, k, r, t, residual=residual, seed=k + r,
                    lens=lens)
    x, ln, dws, pws, bs, res_w, res_b = (
        None if a is None else [torch.from_numpy(w) for w in a]
        if isinstance(a, list) else torch.from_numpy(a) for a in ops)
    x = x.to(torch.bfloat16)
    plan = whole_block_plan(len(lens), t, c_in, c_out, k, r, **plan_kw)
    if tile_rows:
        plan = WholeBlockPlan(tile_rows, plan.cluster, plan.cols,
                              plan.in_cols,
                              whole_block_smem(tile_rows, k, r, plan.cols,
                                               plan.in_cols),
                              -(-t // tile_rows))
    got = _whole_block_mirror(x, ln, dws, pws, bs, res_w, res_b, k,
                              last_act, plan).to(torch.bfloat16).float()
    want = fused_repeat_block_plain(x, ln, dws, pws, bs, res_w, res_b,
                                    kernel=k, last_act=last_act).float()
    assert not torch.isnan(got).any()
    assert float((got - want).abs().max()) \
        <= REL_TOL * float(want.abs().max())
