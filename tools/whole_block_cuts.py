#!/usr/bin/env python3
"""Where the whole-block repeat kernel (csrc/repeat_whole_block.cu) spends
its time, on one NVIDIA GPU, by taking phases out of a copy of it.

    python3 tools/whole_block_cuts.py [--root DIR] [--cut PHASE ...]
                                      [--tile-rows N]

Copies DIR's vietasr_tpu_torch (default: this checkout) to a temporary
directory, takes the named phases out of that copy's kernel (never out of
the shipped source), and times one launch at each of QuartzNet15x5's six
R = 5 block shapes (B = 8, T = 840, chip_smoke.py phase 4's ragged
lengths) by chip_smoke.event_ms. Cuts: `dw` (the depthwise taps), `dsmem`
(the 1x1's A chunks read from the block's own depthwise output in place
of the cluster's), `mma` (the 1x1s' ldmatrix + mma.sync steps), `csync`
(the cluster barriers, as block barriers). Outputs are then wrong; only
the times mean anything. `--tile-rows` launches every shape with that
many rows a tile in place of whole_block_plan's choice, where it fits.
It prints one JSON line: the cuts, the card, and per shape the plan
(tile rows, cluster, tiles, shared memory, clusters the card holds at
once) and ms.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUTS = {
    "dw": [("        for (int j0 = 0; j0 < k; j0 += 8) {",
            "        for (int j0 = 0; j0 < 0; j0 += 8) {")],
    "dsmem": [("cluster.map_shared_rank(ybuf, p);", "ybuf;")],
    "mma": [("        for (int kk = 0; kk < kw; kk += 16) {",
             "        for (int kk = 0; kk < 0; kk += 16) {")],
    "csync": [("    cluster.sync();", "    __syncthreads();")],
}


def cut_source(src: str, cuts) -> str:
    for cut in cuts:
        for old, new in CUTS[cut]:
            if old not in src:
                raise RuntimeError(f"cut {cut}: anchor not in the source")
            src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cut", nargs="*", default=[], choices=sorted(CUTS))
    ap.add_argument("--tile-rows", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("whole_block_cuts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(tmp, "vietasr_tpu_torch")
        shutil.copytree(os.path.join(os.path.abspath(args.root),
                                     "vietasr_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(pkg, "csrc", "repeat_whole_block.cu")
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(cut_source(src, args.cut))
        sys.path.insert(0, tmp)
        from vietasr_tpu_torch.ops import repeat_block as rb

        plan_fn = rb.whole_block_plan
        if args.tile_rows:
            def forced(bsz, t, c_in, c_out, k, r, **kw):
                p = plan_fn(bsz, t, c_in, c_out, k, r, **kw)
                smem = rb.whole_block_smem(args.tile_rows, k, r, p.cols,
                                           p.in_cols)
                if smem > rb._build.SMEM_LIMIT:
                    return p
                return p._replace(tile_rows=args.tile_rows, smem_bytes=smem,
                                  tiles=-(-t // args.tile_rows))
            rb.whole_block_plan = forced
        dev = torch.device("cuda")
        out = {"cuts": args.cut, "tile_rows": args.tile_rows or None,
               "card": chip_smoke.nvidia_smi_line()}
        for c_in, c_out, k, _ in chip_smoke.QN15X5_REPEAT_SHAPES:
            a = chip_smoke.repeat_inputs(np, torch, dev, c_in, c_out, k, 5,
                                         840, 8)
            # the plan the wrapper launches (a DIR from before the plan
            # asked the card for its clusters took a model of it)
            at_once = getattr(rb, "whole_block_clusters_at_once", None)
            kw = {"clusters_at_once": at_once} if at_once else {}
            plan = rb.whole_block_plan(8, 840, c_in, c_out, k, 5, **kw)
            held = at_once(plan.cluster, plan.smem_bytes) if at_once \
                else None
            ms = chip_smoke.event_ms(
                lambda: rb.repeat_whole_block_cuda(*a, kernel=k))
            out[f"{c_in}-{c_out}-{k}"] = {
                "plan": [plan.tile_rows, plan.cluster, plan.tiles,
                         plan.smem_bytes, held], "ms": ms}
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
