"""What the drivers share: the configuration written as the program reads
it, the weights, the program's launch counters, synchronization, and the
reference's float32 setting."""

from __future__ import annotations

import contextlib
import os

import numpy as np

from asrbench import core, weights


def write_yaml(cfg: dict, tmpdir: str) -> str:
    """The configuration as the program's YAML (NeMo's sections), under
    the run's own temporary directory."""
    import yaml

    raw = {"model": cfg["name"],
           "AudioToTextDataLayer": {"max_duration": 16.7,
                                    "trim_silence": False,
                                    "normalize_transcripts": False},
           "AudioToMelSpectrogramPreprocessor": cfg["featurizer"],
           "JasperEncoder": {"activation": "relu", "conv_mask": True,
                             "jasper": cfg["blocks"]},
           "labels": cfg["labels"]}
    path = os.path.join(tmpdir, cfg["name"] + ".yaml")
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(raw, f, allow_unicode=True, sort_keys=False)
    return path


def variables(cfg: dict, seed: int, device) -> dict:
    """The unfolded variables tree, as float32 tensors on `device`: the
    anchor read from its file, or drawn from the seed on the device."""
    import torch

    w = cfg["weights"]
    n_out = len(cfg["labels"]) + 1
    feat_in = cfg["featurizer"]["features"]
    if w["kind"] == "anchor":
        tree = weights.read_anchor(os.path.join(core.ROOT, w["path"]))
        return _map(lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                              device=device), tree)
    if w["kind"] == "seeded":
        return weights.seeded_variables(cfg["blocks"], feat_in, n_out, seed,
                                        device)
    raise ValueError(f"unknown weights kind {w['kind']!r}")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


class Marks:
    """The set-up's split: seconds from the previous mark (the first from
    process start) under each name."""

    def __init__(self, t_start: float):
        import time
        self.clock = time.perf_counter
        self.last = t_start
        self.split = {}

    def __call__(self, name: str) -> None:
        now = self.clock()
        self.split[name] = now - self.last
        self.last = now


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """The program's kernel wrappers' launch counters."""
    from vietasr_tpu_torch.frontend import cuda_frontend as cf
    from vietasr_tpu_torch.ops import fused_ctc as fc
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                    repeat_whole_block_cuda)

    return {"frontend": cf.fused_log_mel_features.launches,
            "frontend_fast": cf.log_mel_tiles_fast_cuda.launches,
            "repeat_block": fused_repeat_block.launches,
            "repeat_whole_block": repeat_whole_block_cuda.launches,
            "beam_search": fused_beam_search.launches,
            "ctc_alpha": fc.fused_ctc_alpha.launches,
            "ctc_beta": fc.fused_ctc_beta.launches}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


@contextlib.contextmanager
def strict_fp32():
    """The reference's float32: no TF32 in matmuls or cuDNN convolutions."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
