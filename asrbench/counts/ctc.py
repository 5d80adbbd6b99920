"""The CTC alpha and beta kernels (csrc/ctc.cu): the larger of each
one's operations over the lattice cells the data needs (forward: frames
1..len-1 of each row's 2 L + 1 positions; backward: frames 0..len-1) at
the fp32 rate, or its bytes (the needed emission and alpha cells in, the
whole (B, T, S) lattice or gradient out, the (B, S) gates and (B,)
scalars)."""

from __future__ import annotations

from asrbench import peaks

ALPHA_OPS, BETA_OPS = 15, 21    # operations a lattice cell


def launches(ilen, tlen, t_max: int, s: int):
    """((seconds, operations, bytes) of alpha, of beta) for one step."""
    bsz = len(ilen)
    s_b = [2 * int(t) + 1 for t in tlen]
    n = [min(max(int(i), 1), t_max) for i in ilen]
    fwd = sum((a - 1) * w for a, w in zip(n, s_b))
    bwd = sum(a * w for a, w in zip(n, s_b))
    lattice = 4 * bsz * t_max * s
    gates = 2 * bsz * s
    out = []
    for ops, nbytes in ((ALPHA_OPS * fwd, 4 * bwd + lattice + gates + 4 * bsz),
                        (BETA_OPS * bwd, 8 * bwd + lattice + gates + 16 * bsz)):
        out.append((max(ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES),
                    ops, nbytes))
    return out
