#!/usr/bin/env python3
"""Where a tile of the bf16 frontend kernel (csrc/frontend_fast.cu) spends
its time, on one NVIDIA GPU.

    python3 tools/fast_phases.py [--root DIR] [--cut PHASE ...]

Copies DIR's vietasr_tpu_torch (default: this checkout) to a temporary
directory and puts clock64() marks into that copy's frontend_fast.cu
(never into the shipped source) after each phase of a tile, as consumer
thread 0 sees it: the sample staging (the block's first tile) or the wait
for the stagers' (its later tiles), the frame fragments' load, the waits
for the producer's DFT chunks (full mbarriers), the DFT wgmmas (issue,
commit and wait), the power, the mel product (with the wait for its
blocks), the log, store and partials. Thread 0 of each block adds each phase's cycles up. It prints,
for one row of 2.0 s (one block per tile: a tile's latency), for B = 8 x
16.7 s (one tile a block) and for B = 32 x 16.7 s (3 or 4 tiles a block),
the mean cycles per block per phase over 10 calls, and the call's time by
chip_smoke.event_ms.

`--cut` takes phases out of the copy, to see what is left without them:
`mma` (the DFT wgmmas), `copy` (the DFT chunks' bulk copies; the producer
then arrives on the full barrier itself and the loop reads stale chunks),
`mel` (the mel product). Outputs are then wrong; only the times mean
anything.

A DIR that holds the mma.sync kernel this one replaced (it has no wgmma)
is split as that kernel was: staging, frame load, DFT loop, mel, log +
store + partials, with its cuts `mma`, `copy`, `mel` and `ldsm` (each
chunk's B fragments read from shared memory once and reused at every
k16 step).
"""

import argparse
import ctypes
import os
import re
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (phase names, [(anchor in the source, phase whose mark goes after it)],
# {cut: [(old, new)]}) of the wgmma kernel
PHASES = ("staging", "frame load", "producer wait", "DFT wgmma", "power",
          "mel", "log+store+partials")
MARKS = (
    ("      mbar_wait(sig_bars, (t - 1) & 1);\n    }", 0),
    ("        ldmatrix_x4(a[ks], sig + i + pad * __umulhi(i, hop_magic));\n"
     "      }\n    }", 1),
    ("      mbar_wait(bars + 8 * stage, phase);     // chunk c has landed", 2),
    ("      wgmma_commit();\n", 3),
    ("        wgmma_wait<1>();                       // chunk c - 1 is done",
     3),
    ("        store_power(pw, prow, (c - 1) * CHUNK_BINS + (lane & 3), o);",
     4),
    ("    wgmma_wait<0>();\n", 3),
    ("    store_power(pw, prow, (CHUNKS - 1) * CHUNK_BINS + (lane & 3), "
     "acc[0]);", 4),
    ("            mma_bf16(macc[nt], af, bv.x, bv.y);\n          }\n"
     "        }\n      }\n    }", 5),
    ("    __syncwarp();      // before the next tile's power over these rows",
     6),
)
CUTS = {
    "mma": [("      wgmma_n32<0>(d, a[0], desc_b(st));",
             "      d[0] += __uint_as_float(a[0][0]);"),
            ("        wgmma_n32<1>(d, a[ks], desc_b(st + 2 * LBO * ks));",
             "        d[1] += __uint_as_float(a[ks][1]);")],
    "copy": [("          mbar_expect_tx(full, L.stage);\n"
              "          bulk_copy(ring + stage * L.stage,\n"
              "                    dft + (size_t)c * CHUNK_COLS * KROWS, "
              "L.stage, full);",
              "          mbar_arrive(full);")],
    "mel": [("            mma_bf16(macc[nt], af, bv.x, bv.y);",
             "            if (j < 0) mma_bf16(macc[nt], af, bv.x, bv.y);")],
}
# the same for the mma.sync kernel that the wgmma one replaced
PHASES_MMA_SYNC = ("staging", "frame load", "DFT loop", "mel",
                   "log+store+partials")
MARKS_MMA_SYNC = tuple((a, k) for k, a in enumerate((
    "    __syncthreads();\n\n    // this warp's 16 frames, every k16 step, "
    "into registers",
    "        if (ks < ksteps) ldmatrix_x4(a[ks], base + 16 * ks);\n    }",
    "      __syncthreads();                 // this ring stage is free again"
    "\n    }",
    "    __syncthreads();                   // every read of the power tile",
    "    __syncthreads();                   // the float tile is read",
)))
CUTS_MMA_SYNC = {
    "mma": [("          mma_bf16(acc[0], a[ks], bf[0], bf[1]);\n"
             "          mma_bf16(acc[1], a[ks], bf[2], bf[3]);\n",
             "          acc[0][0] += __uint_as_float(bf[0] ^ a[ks][0]);\n"
             "          acc[1][0] += __uint_as_float(bf[2]);\n")],
    "copy": [("      cp_async16(dst + row * kp + 8 * s,",
              "      if (g < 0) cp_async16(dst + row * kp + 8 * s,")],
    "mel": [("          mma_bf16(macc[j], af,",
             "          if (ks < 0) mma_bf16(macc[j], af,")],
    "ldsm": [("#pragma unroll\n      for (int ks = 0; ks < MAX_KSTEPS; ++ks) {\n"
              "        if (ks < ksteps) {\n          unsigned bf[4];\n"
              "          ldmatrix_x4(bf, bbase + 16 * ks);\n",
              "      unsigned bf[4];\n      ldmatrix_x4(bf, bbase);\n"
              "#pragma unroll\n      for (int ks = 0; ks < MAX_KSTEPS; ++ks) {\n"
              "        if (ks < ksteps) {\n")],
}


def design(src: str):
    """(phases, marks, cuts) of the kernel in `src`."""
    if "wgmma_n32" in src:
        return PHASES, MARKS, CUTS
    return PHASES_MMA_SYNC, MARKS_MMA_SYNC, CUTS_MMA_SYNC


READER = '''
extern "C" int vt_phase_marks(void* host, int zero) {
  static long long z[1024][8];
  return zero ? (int)cudaMemcpyToSymbol(g_marks, z, sizeof(g_marks))
              : (int)cudaMemcpyFromSymbol(host, g_marks, sizeof(g_marks));
}
'''


def instrument(src: str, cuts) -> str:
    """The kernel source with the phase marks (and the cuts) put in."""
    _, marks, known = design(src)
    s = src.replace("namespace {\n",
                    "__device__ long long g_marks[1024][8];\nnamespace {\n", 1)
    s = s.replace("    const int f0 = tile * FRAMES;\n"
                  if "FRAMES;" in s else "    const int f0 = tile * frames;\n",
                  "    const int f0 = tile * %s;\n    long long t_mark = "
                  "clock64();\n" % ("FRAMES" if "FRAMES;" in s else "frames"),
                  1)
    for anchor, k in marks:
        if anchor not in s:
            raise RuntimeError(f"fast_phases: mark {k} found no anchor")
        s = s.replace(anchor, anchor + (
            "\n    if (tid == 0 && blockIdx.x < 1024)"
            f" g_marks[blockIdx.x][{k}] += clock64() - t_mark;"
            "\n    t_mark = clock64();"), 1)
    for name in cuts:
        if name not in known:
            raise RuntimeError(f"fast_phases: no cut {name} for this kernel")
        for old, new in known[name]:
            if old not in s:
                raise RuntimeError(f"fast_phases: cut {name} found no anchor")
            s = s.replace(old, new)
    return s + READER


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cut", nargs="*", default=[],
                    choices=sorted(set(CUTS) | set(CUTS_MMA_SYNC)))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fast_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(tmp, "vietasr_tpu_torch")
        shutil.copytree(os.path.join(os.path.abspath(args.root),
                                     "vietasr_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(pkg, "csrc", "frontend_fast.cu")
        with open(path) as f:
            src = f.read()
        phases = design(src)[0]
        with open(path, "w") as f:
            f.write(instrument(src, args.cut))
        sys.path.insert(0, tmp)
        from vietasr_tpu_torch.frontend import cuda_frontend as cf
        from vietasr_tpu_torch.frontend.features import (
            FeaturizerConfig, feature_seq_len, preemphasize_and_pad)

        lib = cf._fast_lib()
        lib.vt_phase_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        cfg = FeaturizerConfig(dither=0.0)
        out = {"cuts": args.cut, "card": chip_smoke.nvidia_smi_line()}
        for bsz, seconds in ((1, 2.0), (8, 16.7), (32, 16.7)):
            rng = np.random.RandomState(bsz)
            n = int(seconds * cfg.sample_rate)
            sig = torch.from_numpy(
                (rng.randn(bsz, n) * 0.1).astype(np.float32)).cuda()
            lens = torch.full((bsz,), n, dtype=torch.int32, device="cuda")
            xp = preemphasize_and_pad(sig, cfg).contiguous()
            seq_len = feature_seq_len(lens, cfg.hop_length)
            tables = cf.fast_tables(cfg, "cuda")

            def call():
                cf.log_mel_tiles_fast_cuda(xp, seq_len, tables, cfg=cfg)

            call()
            torch.cuda.synchronize()
            lib.vt_phase_marks(None, 1)
            reps = 10
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (1024 * 8))()
            lib.vt_phase_marks(ctypes.cast(buf, ctypes.c_void_p), 0)
            marks = np.frombuffer(buf, dtype=np.int64).reshape(1024, 8)
            blocks = int((marks[:, 0] > 0).sum())
            per = marks[:blocks, :len(phases)].sum(0) / reps / blocks
            key = re.sub(r"\W", "", f"B{bsz}x{seconds}s")
            out[key] = {"blocks": blocks, "ms": chip_smoke.event_ms(call),
                        **{p: round(float(c)) for p, c in zip(phases, per)}}
        import json
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
