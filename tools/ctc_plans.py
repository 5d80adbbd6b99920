#!/usr/bin/env python3
"""The CTC kernel pair (vietasr_tpu_torch/csrc/ctc.cu) under every built
launch plan, on one NVIDIA GPU.

    python3 tools/ctc_plans.py [--shapes 3,19,201,435,1025,4095] [--ptxas]
                               [--root DIR]

For each lattice width S, seeded inputs from chip_smoke.ctc_case: S = 435
is phase 7's training batch (B = 32, T = 840, 1.5-16.7 s at 50 frames and
~13 characters a second, row 0 the longest); every other S is B = 4 rows,
row 0 of full length and full target length, the others ragged, at T = 840
(or 1.05 x S for S > 800). Then every plan the kernels are built for
(positions per thread from fused_ctc.PLAN_ITEMS within PLAN_MAX_THREADS
threads, ring depths from PLAN_RINGS that fit the card's shared memory):
both kernels' outputs must equal the plain versions' (ctc_alpha_plain,
ctc_beta_plain) bit for bit, and each kernel's ms per call is timed by
chip_smoke.event_ms (CUDA events over 20 calls behind a sleep kernel,
after a warm-up). "floor" is phase 7's sequential floor: B = 1, S = 3,
T = 840. `--ptxas` builds the kernels with ptxas's register report and
prints it. `--root DIR` imports vietasr_tpu_torch from DIR (a scratch copy
with one design lever cut out or added), so that copies are timed on one
card in one run; a plan that copy does not launch is reported.
Prints a line per (S, plan), then one JSON line with the card's name and
power limit; exits 1 if any output differs.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shape_case(np, torch, dev, s):
    """(name, case) for lattice width s, as the module docstring says."""
    import chip_smoke

    if s == 435:
        ilen, tlen = chip_smoke.ctc_training_lengths(np)
        return "S=435 training B=32 T=840", chip_smoke.ctc_case(
            np, torch, dev, 8, ilen, tlen, 840)
    if s == "floor":
        return "floor B=1 S=3 T=840", chip_smoke.ctc_case(
            np, torch, dev, 12, [840], [1], 840)
    l_max = (s - 1) // 2
    t_max = 840 if s <= 800 else int(1.05 * s)
    rng = np.random.RandomState(s)
    ilen = rng.randint(t_max // 2, t_max + 1, size=4)
    tlen = rng.randint(0, l_max + 1, size=4)
    ilen[0], tlen[0] = t_max, l_max
    return f"S={s} B=4 T={t_max}", chip_smoke.ctc_case(
        np, torch, dev, 20 + s, ilen, tlen, t_max)


def plans(fc, s, streams, smem_limit):
    for items in fc.PLAN_ITEMS:
        threads = -(-s // (32 * items)) * 32
        if threads > fc.PLAN_MAX_THREADS:
            continue
        for ring in fc.PLAN_RINGS:
            smem = fc.plan_smem(streams, items, threads, ring)
            if smem <= smem_limit:
                yield fc.CTCPlan(items, threads, ring, smem)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="floor,3,19,201,435,1025,4095")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ctc_plans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from vietasr_tpu_torch import _build
    from vietasr_tpu_torch.ops import fused_ctc as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ptxas:
        for name, info in _build.build(["ctc"], ptxas_verbose=True).items():
            print(f"build {name}: {info['seconds']:.1f} s")
            for line in info["log"].splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling")):
                    print("  " + line.strip())
    dev = torch.device("cuda")
    limit = fc._smem_limit(torch.cuda.current_device())
    out = {"root": os.path.abspath(args.root), "smem_limit": limit,
           "shapes": {}}
    bad = 0
    for key in args.shapes.split(","):
        s = key if key == "floor" else int(key)
        name, c = shape_case(np, torch, dev, s)
        lat = (c["lp_ext"], c["can"], c["valid"], c["ilen"])
        width = c["lp_ext"].shape[2]
        want_a = fc.ctc_alpha_plain(*lat)
        ll = fc.final_ll(want_a[:, -1], c["tlen"])
        ybar = torch.linspace(0.5, 1.5, len(ll), device=dev)
        tail = (c["can"], c["valid"], c["ilen"], c["tlen"], ll, ybar)
        want_g = fc.ctc_beta_plain(c["lp_ext"], want_a, *tail)
        default = [fc.device_plan(width, n, dev) for n in (1, 2)]
        rows = []
        for streams in (1, 2):
            for plan in plans(fc, width, streams, limit):
                if streams == 1:
                    fn = lambda p=plan: fc.ctc_alpha_cuda(*lat, plan=p)
                    want = want_a
                else:
                    fn = lambda p=plan: fc.ctc_beta_cuda(c["lp_ext"], want_a,
                                                         *tail, plan=p)
                    want = want_g
                kernel = "alpha" if streams == 1 else "beta"
                try:
                    got = fn()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"{name} {kernel} {tuple(plan)}: not launched: {e}")
                    continue
                diff = int((got != want).sum())
                ms = chip_smoke.event_ms(fn)
                tag = " (default)" if plan == default[streams - 1] else ""
                print(f"{name} {kernel} items={plan.items} threads="
                      f"{plan.threads} ring={plan.ring} smem={plan.smem}: "
                      f"{ms:.4f} ms, {diff} elements differ{tag}")
                bad += diff != 0
                rows.append({"kernel": kernel, **plan._asdict(), "ms": ms,
                             "differ": diff, "default": bool(tag)})
        out["shapes"][name] = rows
    out["card"] = chip_smoke.nvidia_smi_line()
    print(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
