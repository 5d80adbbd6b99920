"""vietasr_tpu_torch fused repeat block vs the JAX package's, on the CPU.

The port's wrapper takes its plain version for CPU tensors; it is held
against the Pallas kernel in interpret mode on the same seeded numpy
inputs. Both compute the depthwise in fp32 and round its result and the
residual input to bf16 for fp32-accumulated products, so they agree to
within one bf16 rounding step of the output: tolerance 2^-7 * max|want|
(the JAX package's own test allows 0.03 * max|want|). The same bar holds
at R = 5 and QuartzNet15x5's kernel sizes.

The whole-block CUDA kernel (csrc/repeat_whole_block.cu) runs only on a
GPU; here its launch plan (`whole_block_plan`) and its weight packing
are checked, and a torch transliteration of its schedule (the halo'd
rows, the cluster's column slices, the 128-row chunks with their 2-deep
stage ring, the epilogue of chunk j only after chunk j + 1's depthwise,
x aliased into the activation bytes, the clamped depthwise reads, the
masks, the residual and padding tiles) is held to the plain version
within the same bar.
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
from vietasr_tpu_torch.ops import repeat_block as rb
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
    # K/2 > 128: chunk j + 2's depthwise would read rows chunk j's
    # epilogue may be writing (this shape's smem and chunks would fit)
    dict(c_in=64, c_out=64, kernel=259, r=3),
])
def test_whole_block_plan_refuses_with_the_shape(shape):
    r = shape.get("r", 5)
    with pytest.raises(ValueError, match=f"C_in={shape['c_in']}, "
                       f"C_out={shape['c_out']}, K={shape['kernel']}, "
                       f"R={r}"):
        whole_block_plan(8, 840, shape["c_in"], shape["c_out"],
                         shape["kernel"], r)
    # the model's route asks the same question and runs such a block per op
    assert not whole_block_takes(shape["c_in"], shape["c_out"],
                                 shape["kernel"], r)


def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def _whole_block_mirror(x, lens, dws, pws, bs, res_w, res_b, k, last_act,
                        plan):
    """csrc/repeat_whole_block.cu's schedule, transliterated. Per (row,
    tile) a cluster of plan.cluster blocks, each with its own activation
    region as bytes: the fp32 outputs of the repeats over E1 = E0 - 2 *
    K/2 rows (halo-frame row i at i - K/2, pitch cols) and, aliased into
    the same bytes at the kernel's offset, x's E0 halo'd rows in x's type.
    A repeat runs in 128-row chunks numbered across repeats; each block's
    depthwise output of chunk q goes into stage q % 2 of its own ring
    (rows it does not reach keep what the stage held: NaN at first), and
    each epilogue runs as early as its waits allow: the depthwise of chunk
    q + 1, then the 1x1 of chunk q over every block's stage, then chunk
    q's epilogue over its activation rows in place (or to the output),
    before the depthwise of chunk q + 2 (which the kernel may run before or
    beside it). An in-place write thus lands before every later read it
    could race with, and `writer` asserts that a depthwise chunk reads only
    rows of the previous repeat written by the epilogue it waits on or an
    earlier one; index checks stand for the kernel's buffer bounds."""
    bsz, t, c_in = x.shape
    r, c_out = len(dws), pws[-1].shape[1]
    tt, ncl, cw, cw_in = (plan.tile_rows, plan.cluster, plan.cols,
                          plan.in_cols)
    mr, ys, rpt = rb._WHOLE_MR, rb._WHOLE_YSTAGES, rb._WHOLE_RPT
    k2 = k // 2
    halo = r * k2
    e0 = tt + 2 * halo
    e1 = e0 - 2 * k2
    k8 = -(-k // 8) * 8
    xb = x.element_size()
    p_bytes, q_bytes = cw * 4, cw_in * xb
    xoff = max(0, e1 * (p_bytes - q_bytes))
    region_bytes = max(e1 * p_bytes, xoff + e0 * q_bytes)
    assert plan.smem_bytes == whole_block_smem(tt, k, r, cw, cw_in, xb)
    # the repeats' rows and chunks: repeat rr writes rows [lo, hi)
    spans = [((rr + 1) * k2, e0 - (rr + 1) * k2) for rr in range(r)]
    chunks = [(rr, j) for rr, (lo, hi) in enumerate(spans)
              for j in range(-(-(hi - lo) // mr))]
    assert all(-(-(hi - lo) // mr) <= rb._WHOLE_MAX_CHUNKS
               for lo, hi in spans)
    first = {}                       # repeat -> its first chunk's number
    for q, (rr, j) in enumerate(chunks):
        first.setdefault(rr, q)
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
            xs_all = torch.where(valid[:, None],
                                 x[b, g.clamp(0, t - 1)].float(), 0.0)
            regions, acts, xss = [], [], []
            for rank in range(ncl):
                reg = torch.full((region_bytes,), 0xFF, dtype=torch.uint8)
                act = reg[:e1 * p_bytes].view(torch.float32).view(e1, cw)
                xs = reg[xoff:xoff + e0 * q_bytes].view(x.dtype) \
                    .view(e0, cw_in)
                xs[:] = xs_all[:, rank * cw_in:(rank + 1) * cw_in] \
                    .to(x.dtype)
                regions.append(reg)
                acts.append(act)
                xss.append(xs)
            stages = [[torch.full((mr, max(cw, cw_in)), float("nan"))
                       for _ in range(ys)] for _ in range(ncl)]
            # act row -> the chunk whose epilogue wrote it last
            writer = torch.full((e1,), -1, dtype=torch.long)

            def reach(q):
                """(rows of its passes, the last input row its windows
                read, the epilogue it waits on or -1) of chunk q's
                depthwise"""
                rr, j = chunks[q]
                lo, hi = spans[rr]
                m0 = lo + j * mr
                npass = -(-(min(m0 + mr, hi) - m0) // rpt)
                top = min(m0 + (npass - 1) * rpt - k2 + rpt + k8 - 1,
                          hi + k2 - 1)
                need = first[rr - 1] + (top - rr * k2) // mr if rr else -1
                return npass, top, need

            def depthwise(q):
                rr, j = chunks[q]
                lo, hi = spans[rr]
                cwx = cw_in if rr == 0 else cw
                m0 = lo + j * mr
                npass, top, need = reach(q)
                if rr:
                    # the epilogue this chunk waits on, and no later one
                    # of the previous repeat, wrote every row it reads
                    assert chunks[need][0] == rr - 1
                    assert q - need < rb._WHOLE_EPI_RING
                    assert need <= q - 2 or j == 0
                    read = writer[m0 - k2 - k2:top - k2 + 1]
                    assert int(read.max()) < first[rr], \
                        "in-place hazard: an epilogue of this repeat " \
                        "overwrote rows this depthwise chunk reads"
                    assert int(read.min()) >= first[rr - 1]
                    assert int(read.max()) <= need
                    assert m0 - 2 * k2 >= 0 and top - k2 < e1
                else:
                    assert top < e0
                taps = torch.zeros(k8, dws[rr].shape[1])
                taps[:k] = dws[rr]
                i = torch.arange(m0, m0 + npass * rpt)
                src = (i[:, None] - k2 + torch.arange(k8)[None, :]) \
                    .clamp(max=hi + k2 - 1)
                for rank in range(ncl):
                    a = (acts[rank] if rr else xss[rank]).float()
                    w = taps[:, rank * cwx:(rank + 1) * cwx]
                    y = (a[src - (k2 if rr else 0)] * w[None]).sum(1)
                    keep = (i < hi) & (i - halo + t0 >= 0) \
                        & (i - halo + t0 < ln)
                    y = torch.where(keep[:, None], y, 0.0)
                    st = stages[rank][q % ys]
                    st[:npass * rpt, :cwx] = _bf16(y)

            def gemm_epilogue(q):
                rr, j = chunks[q]
                lo, hi = spans[rr]
                cwx = cw_in if rr == 0 else cw
                last = rr == r - 1
                m0 = lo + j * mr
                a_full = torch.cat([stages[p][q % ys][:, :cwx]
                                    for p in range(ncl)], 1)   # (mr, cx)
                n = min(m0 + mr, hi) - m0                     # rows kept
                i = torch.arange(m0, m0 + n)
                gi = i - halo + t0
                for rank in range(ncl):
                    cols = slice(rank * cw, (rank + 1) * cw)
                    z = (a_full @ _bf16(pws[rr][:, cols].float()))[:n]
                    if not last:
                        z = torch.relu(z + bs[rr][cols])
                        v = (gi >= 0) & (gi < ln)
                        acts[rank][m0 - k2:m0 - k2 + n] = \
                            torch.where(v[:, None], z, 0.0)
                        continue
                    z = z + bs[rr][cols]
                    if last_act:
                        z = torch.relu(z)
                    if res_w is not None:
                        v = (gi >= 0) & (gi < ln)
                        centre = torch.where(
                            v[:, None], _bf16(x[b, gi.clamp(0, t - 1)]
                                              .float()), 0.0)
                        z = z + centre @ _bf16(res_w[:, cols].float()) \
                            + res_b[cols]
                    keep = gi < t
                    out[b, gi[keep], cols] = torch.relu(z)[keep]
                if not last:
                    writer[m0 - k2:m0 - k2 + n] = q

            for q in range(len(chunks) + 1):
                # a chunk that waits on the epilogue of the one before
                # (the last of the previous repeat, which waits on none)
                # runs after it
                if q < len(chunks) and reach(q)[2] == q - 1:
                    gemm_epilogue(q - 1)
                    depthwise(q)
                    continue
                if q < len(chunks):
                    depthwise(q)
                if q >= 1:
                    gemm_epilogue(q - 1)
    return out


def test_whole_block_mirror_catches_the_in_place_hazard():
    """At K/2 > 128 rows the depthwise of chunk j + 2 reads rows that chunk
    j's in-place epilogue writes, and nothing orders the two: the plan
    refuses such a kernel, and the mirror, given the plan by hand, trips
    on the overwritten rows (its second repeat has 3 chunks here)."""
    c_in = c_out = 64
    k, r, t = 259, 3, 40
    ops = _operands(c_in, c_out, k, r, t, bsz=1, seed=1, lens=[t])
    x, ln, dws, pws, bs, res_w, res_b = (
        [torch.from_numpy(w) for w in a] if isinstance(a, list)
        else torch.from_numpy(a) for a in ops)
    with pytest.raises(ValueError, match="at most 257 taps"):
        whole_block_plan(1, t, c_in, c_out, k, r)
    plan = WholeBlockPlan(48, 2, 32, 32, whole_block_smem(48, k, r, 32, 32),
                          1)
    assert plan.smem_bytes <= _build.SMEM_LIMIT
    with pytest.raises(AssertionError, match="in-place hazard"):
        _whole_block_mirror(x.to(torch.bfloat16), ln, dws, pws, bs, res_w,
                            res_b, k, False, plan)


def _at_once(clusters):
    return lambda cluster, smem_bytes: clusters


# small grids take 16-row tiles; a card that holds few clusters at once
# makes the plan take larger ones; `tile_rows` forces a tile in between.
# The first six cases are the old schedule's (their ids kept); then a tile
# whose repeats end in a partial 128-row chunk (144 rows: 128 + 16), a
# chunk ring that wraps inside a repeat (3 chunks; 4, where an epilogue's
# rows would reach x rows still to be read but for x's place in the
# bytes), clusters of 1, 2, 4 and 8 blocks, fp32 x, and 8-channel halves
# of a 16-channel pair split between blocks
@pytest.mark.parametrize("c_in,c_out,k,r,t,lens,last_act,residual,plan_kw,"
                         "tile_rows,x_dtype,cluster", [
    pytest.param(64, 128, 33, 5, 100, [100, 0, 37], False, True, {}, None,
                 "bf16", 2,
                 id="64-128-33-5-100-lens0-False-True-plan_kw0-None"),
    pytest.param(32, 128, 9, 3, 150, [150, 20, 149], True, True,
                 {"clusters_at_once": _at_once(1)}, None, "bf16", 2,
                 id="32-128-9-3-150-lens1-True-True-plan_kw1-None"),
    pytest.param(64, 64, 75, 5, 60, [60, 1, 0], False, True,
                 {"clusters_at_once": _at_once(1)}, None, "bf16", 1,
                 id="64-64-75-5-60-lens2-False-True-plan_kw2-None"),
    pytest.param(32, 48, 7, 2, 70, [70, 33, 3], False, False, {}, None,
                 "bf16", 1, id="32-48-7-2-70-lens3-False-False-plan_kw3-None"),
    pytest.param(64, 128, 17, 5, 130, [130, 5, 64], True, True, {}, 48,
                 "bf16", 2, id="64-128-17-5-130-lens4-True-True-plan_kw4-48"),
    pytest.param(128, 128, 11, 5, 97, [1, 97, 40], False, True, {}, 48,
                 "bf16", 2, id="128-128-11-5-97-lens5-False-True-plan_kw5-48"),
    (64, 64, 9, 2, 300, [300, 150, 299], False, True, {}, 144, "bf16", 1),
    (64, 64, 33, 5, 420, [420, 300, 5], False, True, {}, 256, "bf16", 1),
    (64, 64, 33, 5, 800, [800, 700, 9], False, True, {}, 384, "bf16", 1),
    (256, 256, 9, 2, 80, [80, 41, 0], False, True, {}, None, "bf16", 4),
    (512, 512, 9, 2, 40, [40, 17, 1], False, True, {}, None, "bf16", 8),
    (128, 128, 9, 3, 120, [120, 61, 2], True, True, {}, 64, "fp32", 2),
    (64, 512, 9, 2, 50, [50, 0, 26], False, True, {}, None, "fp32", 8),
])
def test_whole_block_schedule_matches_plain(c_in, c_out, k, r, t, lens,
                                            last_act, residual, plan_kw,
                                            tile_rows, x_dtype, cluster):
    ops = _operands(c_in, c_out, k, r, t, residual=residual, seed=k + r,
                    lens=lens)
    x, ln, dws, pws, bs, res_w, res_b = (
        None if a is None else [torch.from_numpy(w) for w in a]
        if isinstance(a, list) else torch.from_numpy(a) for a in ops)
    x = x.to(torch.bfloat16 if x_dtype == "bf16" else torch.float32)
    xb = x.element_size()
    plan = whole_block_plan(len(lens), t, c_in, c_out, k, r, x_bytes=xb,
                            **plan_kw)
    assert plan.cluster == cluster
    if tile_rows:
        plan = WholeBlockPlan(tile_rows, plan.cluster, plan.cols,
                              plan.in_cols,
                              whole_block_smem(tile_rows, k, r, plan.cols,
                                               plan.in_cols, xb),
                              -(-t // tile_rows), xb)
    assert plan.smem_bytes <= _build.SMEM_LIMIT
    got = _whole_block_mirror(x, ln, dws, pws, bs, res_w, res_b, k,
                              last_act, plan).to(x.dtype).float()
    want = fused_repeat_block_plain(x, ln, dws, pws, bs, res_w, res_b,
                                    kernel=k, last_act=last_act).float()
    assert not torch.isnan(got).any()
    assert float((got - want).abs().max()) \
        <= REL_TOL * float(want.abs().max())


def _pw_offset(k, col, c_x, c_out, cluster):
    """Where the kernel's weight copies and wgmma descriptors read weight
    (k, col) in pack_whole_weights' flat result: rank col // cw's tiles,
    64-deep chunk k // 64, then core matrices of 8 columns x 8 input
    channels (16 bytes a column), the column groups of one 8-channel slice
    side by side."""
    cw, nk = c_out // cluster, -(-c_x // 64)
    rank, n = col // cw, col % cw
    kc, kk = k // 64, k % 64
    return ((rank * nk + kc) * 64 * cw
            + ((kk // 8) * (cw // 8) + n // 8) * 64 + (n % 8) * 8 + kk % 8)


@pytest.mark.parametrize("c_in,c_out,k", QN15X5_SHAPES)
def test_whole_block_packing_unpacks_bit_for_bit(c_in, c_out, k):
    """The packed 1x1, residual and tap tiles of every 15x5 shape, read
    back through the offsets the kernel's descriptors and copies assume,
    are the weights bit for bit; every other packed entry is zero."""
    rng = np.random.RandomState(c_in + c_out + k)
    n = whole_block_plan(8, 840, c_in, c_out, k, 5).cluster
    for cx in (c_in, c_out):
        w = torch.from_numpy(rng.randn(cx, c_out).astype(np.float32)) \
            .to(torch.bfloat16)
        packed = rb.pack_whole_weights(w, n).reshape(-1)
        kk, col = np.meshgrid(np.arange(cx), np.arange(c_out),
                              indexing="ij")
        off = torch.from_numpy(_pw_offset(kk, col, cx, c_out, n).ravel())
        assert off.unique().numel() == cx * c_out
        assert torch.equal(packed[off].view(torch.int16),
                           w.reshape(-1).view(torch.int16))
        rest = torch.ones(packed.numel(), dtype=torch.bool)
        rest[off] = False
        assert not packed[rest].view(torch.int16).any()
        taps = torch.from_numpy(rng.randn(k, cx).astype(np.float32))
        tp = rb.pack_whole_taps(taps, n)
        assert tp.shape == (n, k, cx // n)
        for rank in range(n):
            assert torch.equal(tp[rank].view(torch.int32),
                               taps[:, rank * (cx // n):(rank + 1)
                                    * (cx // n)].view(torch.int32))


def test_whole_block_packs_once_per_weight_tensor():
    """The launch path packs a weight tensor once and reuses it while the
    tensor lives unchanged; an in-place update or a new tensor packs anew,
    and an entry goes with its tensor."""
    import gc

    w = torch.randn(64, 128)
    packs = repeat_whole_block_cuda.packs
    a = rb._packed(w, 2, "w")
    assert rb._packed(w, 2, "w") is a
    assert repeat_whole_block_cuda.packs == packs + 1
    rb._packed(w, 2, "dw")                     # another packing: its own
    assert repeat_whole_block_cuda.packs == packs + 2
    w.mul_(2.0)                                # a new version packs anew
    b = rb._packed(w, 2, "w")
    assert b is not a and torch.equal(b, rb.pack_whole_weights(w, 2))
    assert repeat_whole_block_cuda.packs == packs + 3
    key = id(w)
    del w
    gc.collect()
    assert key not in rb._WHOLE_PACKED


def test_whole_block_packs_an_inference_tensor_once():
    """A weight made in inference mode (no version counter) is packed once
    too, and its entry goes with it."""
    import gc

    with torch.inference_mode():
        w = torch.randn(64, 128)
    packs = repeat_whole_block_cuda.packs
    a = rb._packed(w, 4, "w")
    assert rb._packed(w, 4, "w") is a
    assert torch.equal(a, rb.pack_whole_weights(w, 4))
    assert repeat_whole_block_cuda.packs == packs + 1
    key = id(w)
    del w
    gc.collect()
    assert key not in rb._WHOLE_PACKED
