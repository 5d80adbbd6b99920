"""Deployment export: the Transcriber's forward as a torch.export program
(counterpart of vietasr_tpu/export.py, which serializes StableHLO).

`export_transcriber` traces `Transcriber.forward_program` (featurize ->
encode -> greedy: log_probs, enc_lens, greedy_preds, keep_mask) for each
(batch, bucket) shape, with the weights baked into the program, and saves
each with torch.export.save, plus a manifest.json whose fields are the
JAX package's (the files end in .pt2 where JAX's end in .stablehlo).
The kernels enter the program as the custom ops `vietasr::log_mel_tiles`
and `vietasr::repeat_block` (ops/custom_ops.py): a CUDA Transcriber's
program launches the same kernels as its eager forward, a CPU one runs
their plain versions.

`load_exported` loads one back as a callable. Unlike JAX's StableHLO,
which any XLA runtime runs alone, a program that calls the kernels needs
the ops registered: `import vietasr_tpu_torch` first (this module does).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import torch

import vietasr_tpu_torch  # noqa: F401  (registers the vietasr:: ops)
from vietasr_tpu_torch.ops.custom_ops import through_ops


class _Forward(torch.nn.Module):
    def __init__(self, transcriber):
        super().__init__()
        self.transcriber = transcriber

    def forward(self, signal, lengths):
        return self.transcriber.forward_program(signal, lengths)


def export_transcriber(transcriber, out_dir: str, *,
                       batch_sizes: Sequence[int] = (1, 8),
                       buckets: Optional[Sequence[int]] = None) -> dict:
    """Save the Transcriber's forward for each (batch, bucket) shape.

    Writes {out_dir}/fwd_b{B}_s{S}.pt2 plus a manifest.json describing
    shapes, labels and sample rate (JAX's fields). Returns the manifest
    dict."""
    os.makedirs(out_dir, exist_ok=True)
    buckets = list(buckets or transcriber.buckets)
    module = _Forward(transcriber).eval()
    entries = []
    for b in batch_sizes:
        for s in buckets:
            signal = torch.zeros((b, s), dtype=torch.float32,
                                 device=transcriber.device)
            lens = torch.zeros((b,), dtype=torch.int32,
                               device=transcriber.device)
            with through_ops(), torch.no_grad():
                program = torch.export.export(module, (signal, lens))
            name = f"fwd_b{b}_s{s}.pt2"
            torch.export.save(program, os.path.join(out_dir, name))
            entries.append({"file": name, "batch": b, "samples": s})
    cfg = transcriber.cfg
    manifest = {
        "model": cfg.name,
        "sample_rate": cfg.featurizer.sample_rate,
        "labels": cfg.labels,
        "blank_id": cfg.num_classes,
        "outputs": ["log_probs", "enc_lens", "greedy_preds", "keep_mask"],
        "functions": entries,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, ensure_ascii=False, indent=2)
    return manifest


def load_exported(path: str):
    """A saved .pt2 program as a callable (signal, lengths) -> the four
    outputs, on the device it was exported on."""
    return torch.export.load(path).module()
