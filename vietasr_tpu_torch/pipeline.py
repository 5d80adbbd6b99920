"""End-to-end inference facade (counterpart of vietasr_tpu/pipeline.py,
greedy tier).

waveform -> log-mel (the fused frontend kernel on the GPU) -> folded-BN
QuartzNet (the fused repeat-block kernel on blocks 1-13 in bf16) -> CTC
head log-softmax -> greedy collapse. Audio is zero-padded up to the next
duration bucket and utterances of one bucket are batched together, as in
the JAX package; the frontend reflects at the bucket end, as JAX does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from vietasr_tpu_torch.config import ModelConfig, load_config
from vietasr_tpu_torch.frontend.cuda_frontend import (fused_supported,
                                                      make_fused_featurizer)
from vietasr_tpu_torch.frontend.features import make_featurizer
from vietasr_tpu_torch.models.convert import load_anchor, params_from_jax
from vietasr_tpu_torch.models.quartznet import (BLOCK_IMPLS,
                                                cast_matmul_weights,
                                                fold_batchnorm,
                                                quartznet_apply)
from vietasr_tpu_torch.ops.greedy import (collapse_batch, greedy_decode,
                                          ids_to_text)
from vietasr_tpu_torch.utils.device import resolve_device
from vietasr_tpu_torch.utils.typing import assert_waveform

_DTYPES = {None: None, "bfloat16": torch.bfloat16, "float32": None}


@dataclasses.dataclass
class TranscriberOptions:
    """The JAX package's option names. Beam decoding (`decoder="beam"`,
    `"device_beam"`, `lm_path`) is the next slice of the port (ROADMAP A.6)
    and raises NotImplementedError until then."""

    beam_width: int = 100
    lm_path: Optional[str] = None
    lm_alpha: float = 0.5
    lm_beta: float = 1.5
    fold_bn: bool = True
    buckets_seconds: Sequence[float] = (2.0, 4.0, 6.0, 8.0, 11.0, 16.7)
    max_batch: int = 8
    decoder: str = "greedy"
    device_beam_cutoff_top_n: int = 8
    device_beam_lm: str = "auto"
    # bf16 operands with fp32 accumulation; None (or "float32") for fp32
    compute_dtype: Optional[str] = "bfloat16"
    # "auto": the fused frontend kernel on the GPU when fused_supported,
    # the plain chain on the CPU; "on" / "off" force one or the other
    fused_frontend: str = "auto"
    # eligible encoder blocks in bf16: "auto" / "kernel" = the fused
    # repeat-block kernel, "plain" = its plain PyTorch version
    # (models/quartznet.py)
    block_impl: str = "auto"


class Transcriber:
    """Config + weights -> `.transcribe(np.ndarray) -> str`.

    `variables` is a JAX-layout variables tree (numpy leaves, unfolded or
    folded); `checkpoint` a `*.msgpack.gz` file of one (models/convert.py).
    `device=None` means CUDA, and raises when there is no GPU."""

    def __init__(self, config_file: str, *, variables: Optional[dict] = None,
                 checkpoint: Optional[str] = None,
                 options: Optional[TranscriberOptions] = None, device=None):
        self.device = resolve_device(device)
        cfg: ModelConfig = load_config(config_file)
        # inference forces dither off
        self.cfg = dataclasses.replace(
            cfg, featurizer=dataclasses.replace(cfg.featurizer, dither=0.0))
        self.opts = opts = options or TranscriberOptions()
        if self.cfg.architecture != "quartznet":
            raise NotImplementedError(
                "only QuartzNet configs are ported (Conformer: ROADMAP A.10)")
        if opts.decoder in ("beam", "device_beam") or opts.lm_path:
            raise NotImplementedError(
                f"decoder={opts.decoder!r} / lm_path: the beam tier is "
                "ROADMAP A.6, not ported yet")
        if opts.decoder != "greedy":
            raise ValueError(f"unknown decoder {opts.decoder!r}")
        if opts.fused_frontend not in ("auto", "on", "off"):
            raise ValueError("fused_frontend must be 'auto', 'on' or 'off' "
                             f"('fast' is not ported), got "
                             f"{opts.fused_frontend!r}")
        if opts.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        if opts.block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}")
        self.compute_dtype = _DTYPES[opts.compute_dtype]

        if variables is None:
            if checkpoint is None:
                raise ValueError("Transcriber needs `variables` or "
                                 "`checkpoint`")
            variables = load_anchor(checkpoint)
        variables = params_from_jax(variables, device=self.device)
        first_sub = variables["params"]["encoder"][0]["sub"][0]
        if opts.fold_bn and "bn" in first_sub:
            variables = fold_batchnorm(variables, self.cfg.encoder)
        self.variables = cast_matmul_weights(variables, self.compute_dtype)

        fcfg = self.cfg.featurizer
        use_fused = opts.fused_frontend == "on" or (
            opts.fused_frontend == "auto" and self.device.type == "cuda"
            and fused_supported(fcfg))
        self._featurize = (make_fused_featurizer if use_fused
                           else make_featurizer)(fcfg, device=self.device)
        sr = fcfg.sample_rate
        self.buckets = [int(s * sr) for s in opts.buckets_seconds]
        self._pinned: dict = {}     # bucket samples -> page-locked buffer

    # -- core ----------------------------------------------------------------

    @torch.inference_mode()
    def _forward(self, signal: torch.Tensor, lengths: torch.Tensor):
        feats, flens = self._featurize(signal, lengths)
        log_probs, enc_lens = quartznet_apply(
            self.variables, feats, flens, cfg=self.cfg.encoder,
            compute_dtype=self.compute_dtype, block_impl=self.opts.block_impl)
        preds, keep = greedy_decode(log_probs, enc_lens,
                                    blank=self.cfg.num_classes)
        return log_probs, enc_lens, preds, keep

    def _fwd(self, batch: np.ndarray, lens: np.ndarray):
        return self._forward(
            torch.from_numpy(batch).to(self.device, non_blocking=True),
            torch.from_numpy(lens).to(self.device))

    def _host_batch(self, rows: int, samples: int) -> np.ndarray:
        """A zeroed (rows, samples) float32 host array to pad a batch into.
        On the GPU a batch of a fixed bucket goes into page-locked memory,
        one (max_batch, bucket) buffer per bucket (24 MB for the default
        buckets), so the upload is one DMA at full rate; callers read the
        forward's results back (which synchronises) before the buffer is
        filled again. Long audio (rounded up to whole seconds past the last
        bucket) and oversized batches use ordinary memory, so the pinned
        total stays bounded."""
        if (self.device.type != "cuda" or samples not in self.buckets
                or rows > self.opts.max_batch):
            return np.zeros((rows, samples), np.float32)
        buf = self._pinned.get(samples)
        if buf is None:
            buf = torch.empty((self.opts.max_batch, samples),
                              dtype=torch.float32, pin_memory=True)
            self._pinned[samples] = buf
        arr = buf.numpy()[:rows]
        arr.fill(0.0)
        return arr

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return ((n + 15999) // 16000) * 16000   # round long audio up to 1 s

    # -- public API ----------------------------------------------------------

    def log_probs(self, signal: np.ndarray, lengths=None):
        """(B?, S) or (S,) waveform -> (log_probs, enc_lens) as numpy.

        `lengths` gives per-row valid sample counts (default: every row is
        full length); rows may be zero-padded beyond their length."""
        signal = np.asarray(signal, np.float32)
        if signal.ndim == 1:
            signal = signal[None]
        n = signal.shape[1]
        bl = self._bucket_len(n)
        padded = self._host_batch(signal.shape[0], bl)
        padded[:, :n] = signal
        if lengths is None:
            lengths = np.full((signal.shape[0],), n, np.int32)
        lp, el, _, _ = self._fwd(padded, np.asarray(lengths, np.int32))
        return lp.cpu().numpy(), el.cpu().numpy()

    def transcribe(self, signal: np.ndarray) -> str:
        """Single-utterance transcription."""
        return self.transcribe_batch([signal])[0]

    def transcribe_batch(self, signals: List[np.ndarray]) -> List[str]:
        """Sort by length, then batch up to max_batch utterances of one
        bucket per forward."""
        for s in signals:
            assert_waveform(np.asarray(s), port="transcribe.signal")
        out: List[Optional[str]] = [None] * len(signals)
        order = sorted(range(len(signals)), key=lambda i: len(signals[i]))
        i = 0
        while i < len(order):
            bl = self._bucket_len(len(signals[order[i]]))
            group = []
            while (i < len(order) and len(group) < self.opts.max_batch
                   and self._bucket_len(len(signals[order[i]])) == bl):
                group.append(order[i])
                i += 1
            batch = self._host_batch(len(group), bl)
            lens = np.zeros((len(group),), np.int32)
            for row, gi in enumerate(group):
                s = np.asarray(signals[gi], np.float32)
                batch[row, : len(s)] = s[:bl]
                lens[row] = min(len(s), bl)
            _, _, preds, keep = self._fwd(batch, lens)
            texts = [ids_to_text(ids, self.cfg.labels)
                     for ids in collapse_batch(preds, keep)]
            for row, gi in enumerate(group):
                out[gi] = texts[row]
        return out  # type: ignore
