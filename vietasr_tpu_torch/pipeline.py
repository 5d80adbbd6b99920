"""End-to-end inference facade (counterpart of vietasr_tpu/pipeline.py).

waveform -> log-mel (the fused frontend kernel on the GPU; with
`fused_frontend="fast"` its bf16 tensor-core kernel) -> the encoder:
folded-BN QuartzNet (in bf16, one repeat-block kernel launch per eligible
block: the one-repeat kernel on 12x1's blocks 1-13, the whole-block kernel
on 15x5's R = 5 blocks; after `calibrate_int8`, int8 pointwise GEMMs with
every block per-op) or
the Conformer (models/conformer.py, per op, BN unfolded as in JAX) -> CTC
head log-softmax -> one of three decoders:
- greedy collapse on the device (the default);
- `decoder="beam"` (or an `lm_path` with the greedy decoder): the host
  prefix beam search with word-LM fusion (ops/beam_search.py, C++ tier in
  native/), over an ARPA file or a KenLM `.binary`, as the reference's
  infer.py decodes; the log-probs come to the host;
- `decoder="device_beam"`: the batched beam search on the device with
  optional char- or word-LM fusion (the fused beam kernel on the GPU,
  ops/fused_beam.py).
Audio is zero-padded up to the next duration bucket and utterances of one
bucket are batched together, as in the JAX package; the frontend reflects
at the bucket end, as JAX does. Audio of any length goes through
`transcribe_long` (streaming.py), which `transcribe_file` takes past the
last bucket.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vietasr_tpu_torch.audio.io import read_audio
from vietasr_tpu_torch.config import ModelConfig, load_config
from vietasr_tpu_torch.frontend.cuda_frontend import (fused_supported,
                                                      make_fused_featurizer)
from vietasr_tpu_torch.frontend.features import make_featurizer
from vietasr_tpu_torch.models import model_apply, model_init
from vietasr_tpu_torch.models.conformer import \
    cast_matmul_weights as conformer_cast_weights
from vietasr_tpu_torch.models.convert import (decoder_from_state_dict,
                                              encoder_from_state_dict,
                                              load_anchor,
                                              load_torch_state_dict,
                                              params_from_jax, to_numpy,
                                              variables_from_checkpoints)
from vietasr_tpu_torch.models.quantize import (calibrate_activations,
                                               int8_pw_fn,
                                               quantize_quartznet)
from vietasr_tpu_torch.models.quartznet import (BLOCK_IMPLS,
                                                cast_matmul_weights,
                                                fold_batchnorm)
from vietasr_tpu_torch.ops.beam_search import BeamSearchDecoderLM
from vietasr_tpu_torch.ops.device_beam import (device_beam_transcripts,
                                               word_lm_to_device)
from vietasr_tpu_torch.ops.greedy import (collapse_batch, greedy_decode,
                                          ids_to_text)
from vietasr_tpu_torch.ops.lm import (SPACE_TOKEN, char_lm_table, load_lm,
                                      word_lm_tables)
from vietasr_tpu_torch.utils import tracing
from vietasr_tpu_torch.utils.device import resolve_device
from vietasr_tpu_torch.utils.typing import assert_waveform

_DTYPES = {None: None, "bfloat16": torch.bfloat16, "float32": None}
# the beam decoder decodes up to this many x max_batch rows in one search
_BEAM_BATCHES_PER_DECODE = 4


@dataclasses.dataclass
class TranscriberOptions:
    """The JAX package's option names and defaults. JAX's batch switch
    for the fused frontend (the XLA chain above B = 64, or 96 for "fast")
    is a TPU tuning the port drops: every batch takes the configured
    frontend."""

    beam_width: int = 100
    lm_path: Optional[str] = None
    lm_alpha: float = 0.5
    lm_beta: float = 1.5
    fold_bn: bool = True
    buckets_seconds: Sequence[float] = (2.0, 4.0, 6.0, 8.0, 11.0, 16.7)
    max_batch: int = 8
    # "greedy" | "beam" (host C++ prefix beam + word LM; an lm_path with
    # "greedy" means this too) | "device_beam" (batched beam on the
    # device; char-LM table or hashed word-LM fusion, no host round trip
    # of the log-probs)
    decoder: str = "greedy"
    device_beam_cutoff_top_n: int = 8
    # "auto": sniff the ARPA (multi-char unigrams => word LM);
    # "char" / "word" force the on-device fusion kind
    device_beam_lm: str = "auto"
    # bf16 operands with fp32 accumulation; None (or "float32") for fp32
    compute_dtype: Optional[str] = "bfloat16"
    # "auto": the fused frontend kernel on the GPU when fused_supported,
    # the plain chain on the CPU; "on" / "off" force one or the other;
    # "fast": the fused frontend at precision="default", single-pass bf16
    # DFT and mel products (the bf16 kernel on the GPU, its plain version
    # on the CPU), the default-precision accuracy class (O(1) log-mel
    # error on spectral-floor bins)
    fused_frontend: str = "auto"
    # eligible encoder blocks in bf16: "auto" / "kernel" = the fused
    # repeat-block kernels, "plain" = their plain PyTorch version
    # (models/quartznet.py)
    block_impl: str = "auto"


class Transcriber:
    """Config + weights -> `.transcribe(np.ndarray) -> str`.

    The weights, first given wins: `variables`, a JAX-layout variables
    tree (numpy leaves, unfolded or folded); `checkpoint`, a
    `*.msgpack.gz` file of one (models/convert.py); `encoder_checkpoint`
    and `decoder_checkpoint`, the reference's two NeMo `.pt` files. With
    neither or one of those, the model is initialised randomly
    (`model_init` under a torch.Generator seeded 0) and the one given
    overlays its part, as JAX does. A Conformer config (`ConformerEncoder`
    section) takes `variables` / `checkpoint` or the random init; the `.pt`
    files are QuartzNet's. `device=None` means CUDA, and raises when there
    is no GPU."""

    def __init__(self, config_file: str, *,
                 encoder_checkpoint: Optional[str] = None,
                 decoder_checkpoint: Optional[str] = None,
                 variables: Optional[dict] = None,
                 checkpoint: Optional[str] = None,
                 options: Optional[TranscriberOptions] = None, device=None):
        self.device = resolve_device(device)
        cfg: ModelConfig = load_config(config_file)
        # inference forces dither off
        self.cfg = dataclasses.replace(
            cfg, featurizer=dataclasses.replace(cfg.featurizer, dither=0.0))
        self.opts = opts = options or TranscriberOptions()
        if opts.decoder not in ("greedy", "beam", "device_beam"):
            raise ValueError(f"unknown decoder {opts.decoder!r}")
        if opts.device_beam_lm not in ("auto", "char", "word"):
            raise ValueError("device_beam_lm must be 'auto', 'char' or "
                             f"'word', got {opts.device_beam_lm!r}")
        if opts.fused_frontend not in ("auto", "on", "off", "fast"):
            raise ValueError("fused_frontend must be 'auto', 'on', 'off' "
                             f"or 'fast', got {opts.fused_frontend!r}")
        if opts.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        if opts.block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}")
        self.compute_dtype = _DTYPES[opts.compute_dtype]

        if variables is None and checkpoint is not None:
            variables = load_anchor(checkpoint)
        if variables is None:
            variables = self._variables_from_pt(encoder_checkpoint,
                                                decoder_checkpoint)
        variables = params_from_jax(variables, device=self.device)
        if self.cfg.architecture == "conformer":
            # no BN fold (JAX folds QuartzNet only); the matmul weights
            # stored in the compute dtype, the values the forward rounds to
            self._float_variables = variables
            self.variables = conformer_cast_weights(variables,
                                                    self.compute_dtype)
        else:
            first_sub = variables["params"]["encoder"][0]["sub"][0]
            if opts.fold_bn and "bn" in first_sub:
                variables = fold_batchnorm(variables, self.cfg.encoder)
            # fp32 folded weights: calibrate_int8 quantizes from them, as JAX
            self._float_variables = variables
            self.variables = cast_matmul_weights(variables,
                                                 self.compute_dtype)
        self._q_tables: dict = {}    # int8 serving tables (calibrate_int8)

        fcfg = self.cfg.featurizer
        if opts.fused_frontend == "fast":
            self._featurize = make_fused_featurizer(
                fcfg, device=self.device, precision="default")
        else:
            use_fused = opts.fused_frontend == "on" or (
                opts.fused_frontend == "auto" and self.device.type == "cuda"
                and fused_supported(fcfg))
            self._featurize = (make_fused_featurizer if use_fused
                               else make_featurizer)(fcfg,
                                                     device=self.device)
        sr = fcfg.sample_rate
        self.buckets = [int(s * sr) for s in opts.buckets_seconds]
        self._pinned: dict = {}     # bucket samples -> page-locked buffer
        self._uploaded: dict = {}   # bucket samples -> its last upload's event
        self._device_lm_table = None
        self._device_word_lm = None
        self._device_wlm_probes = 8
        self._device_n_ctx = 2
        self._decoder = None
        if opts.decoder == "device_beam":
            if opts.lm_path:
                self._load_device_lm(opts.lm_path, opts.device_beam_lm)
        elif opts.lm_path is not None or opts.decoder == "beam":
            self._decoder = BeamSearchDecoderLM(
                self.cfg.labels, lm_path=opts.lm_path, alpha=opts.lm_alpha,
                beta=opts.lm_beta, beam_width=opts.beam_width)

    def _variables_from_pt(self, encoder_checkpoint: Optional[str],
                           decoder_checkpoint: Optional[str]) -> dict:
        """The unfolded numpy tree from the reference's `.pt` files: both
        given, converted; else a random init, seed 0, overlaid with the
        one given."""
        ecfg = self.cfg.encoder
        if self.cfg.architecture != "quartznet" and (encoder_checkpoint
                                                     or decoder_checkpoint):
            raise NotImplementedError(
                "NeMo .pt checkpoints hold a QuartzNet (JasperEncoder / "
                "JasperDecoderForCTC); a Conformer takes variables= or "
                "checkpoint= (a msgpack variables file)")
        if encoder_checkpoint and decoder_checkpoint:
            return variables_from_checkpoints(encoder_checkpoint,
                                              decoder_checkpoint, ecfg)
        variables = to_numpy(model_init(torch.Generator().manual_seed(0),
                                        self.cfg, device="cpu"))
        if encoder_checkpoint:
            enc = encoder_from_state_dict(
                load_torch_state_dict(encoder_checkpoint), ecfg)
            variables["params"]["encoder"] = enc["params"]
            variables["batch_stats"]["encoder"] = enc["batch_stats"]
        if decoder_checkpoint:
            variables["params"]["decoder"] = decoder_from_state_dict(
                load_torch_state_dict(decoder_checkpoint))
        return variables

    def _load_device_lm(self, path: str, kind: str) -> None:
        """The LM's device tables, moved to the device once."""
        lm = load_lm(path)
        if kind == "auto":
            specials = {"<s>", "</s>", "<unk>", SPACE_TOKEN}
            kind = "word" if any(len(w) > 1 and w not in specials
                                 for w in lm.vocab) else "char"
        if kind == "word":
            tables, self._device_wlm_probes = word_lm_tables(
                lm, self.cfg.labels)
            self._device_word_lm = word_lm_to_device(tables, self.device)
        else:
            self._device_lm_table = torch.from_numpy(
                char_lm_table(lm, self.cfg.labels)).to(self.device)
            self._device_n_ctx = lm.order - 1

    # -- core ----------------------------------------------------------------

    @torch.inference_mode()
    def _forward(self, signal: torch.Tensor, lengths: torch.Tensor):
        return self.forward_program(signal, lengths)

    def forward_program(self, signal: torch.Tensor, lengths: torch.Tensor):
        """The whole device forward, (B, S) float32 signal + (B,) int32
        lengths -> (log_probs, enc_lens, greedy_preds, keep_mask): the
        frontend, the encoder and the greedy decode, with no host read
        (export.py traces it)."""
        with tracing.span("pipeline.featurize"):
            feats, flens = self._featurize(signal, lengths)
        kwargs = {}
        if self.cfg.architecture == "quartznet":
            kwargs["block_impl"] = self.opts.block_impl
            if self._q_tables:
                kwargs["pw_fn"] = int8_pw_fn(self._q_tables)
        with tracing.span("pipeline.encoder"):
            log_probs, enc_lens = model_apply(
                self.variables, feats, flens, cfg=self.cfg,
                compute_dtype=self.compute_dtype, **kwargs)
        with tracing.span("pipeline.greedy"):
            preds, keep = greedy_decode(log_probs, enc_lens,
                                        blank=self.cfg.num_classes)
        return log_probs, enc_lens, preds, keep

    def _fwd(self, batch: np.ndarray, lens: np.ndarray):
        if tracing.enabled():
            signal_samples = int(lens.sum())
            tracing.count("pipeline.forwards")
            tracing.count("pipeline.rows", batch.shape[0])
            tracing.count("pipeline.signal_samples", signal_samples)
            tracing.count("pipeline.padded_samples",
                          batch.size - signal_samples)
        with tracing.span("pipeline.upload"):
            signal = torch.from_numpy(batch).to(self.device,
                                                non_blocking=True)
            buf = self._pinned.get(batch.shape[1])
            if buf is not None and batch.ctypes.data == buf.data_ptr():
                # the copy ran on the target device's current stream
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                self._uploaded[batch.shape[1]] = done
            # from pageable memory: returns once the stream's queued work,
            # the signal's copy among it, is done
            lengths = torch.from_numpy(lens).to(self.device)
        return self._forward(signal, lengths)

    def _host_batch(self, rows: int, samples: int) -> np.ndarray:
        """A zeroed (rows, samples) float32 host array to pad a batch into.
        On the GPU a batch of a fixed bucket goes into page-locked memory,
        one (max_batch, bucket) buffer per bucket (24 MB for the default
        buckets), so the upload is one DMA at full rate. That upload is
        asynchronous, and the beam decoder runs every forward of a call
        before it reads anything back, so a bucket with more than
        max_batch signals refills its buffer while the last upload from it
        may still be in flight: `_fwd` records an event after each upload
        from a page-locked buffer, and this waits on it before the buffer
        is handed out again. Long audio (rounded up to whole seconds past
        the last bucket) and oversized batches use ordinary memory, so the
        pinned total stays bounded."""
        if (self.device.type != "cuda" or samples not in self.buckets
                or rows > self.opts.max_batch):
            return np.zeros((rows, samples), np.float32)
        buf = self._pinned.get(samples)
        if buf is None:
            buf = torch.empty((self.opts.max_batch, samples),
                              dtype=torch.float32, pin_memory=True)
            self._pinned[samples] = buf
        done = self._uploaded.pop(samples, None)
        if done is not None:
            with tracing.span("pipeline.buffer_wait"):
                done.synchronize()
        arr = buf.numpy()[:rows]
        arr.fill(0.0)
        return arr

    @torch.inference_mode()
    def calibrate_int8(self, signals: Sequence[np.ndarray]) -> None:
        """Switch the forward to int8 pointwise GEMMs (models/quantize.py),
        with static activation scales calibrated on the given
        representative waveforms: one forward over all of them, each
        zero-padded to the largest bucket they need (padding is masked out
        and cannot raise an abs-max), then the tables from the fp32 folded
        weights. QuartzNet with fold_bn=True only. Blocks then run per-op
        (no repeat-block kernel), as in JAX."""
        if self.cfg.architecture != "quartznet" or not self.opts.fold_bn:
            raise ValueError(
                "int8 serving requires a QuartzNet with fold_bn=True")
        sigs = [np.asarray(s, np.float32).reshape(-1) for s in signals]
        bl = max(self._bucket_len(len(s)) for s in sigs)
        padded = np.zeros((len(sigs), bl), np.float32)
        lens = np.zeros((len(sigs),), np.int32)
        for i, s in enumerate(sigs):
            n = min(len(s), bl)
            padded[i, :n] = s[:n]
            lens[i] = n
        feats, flens = self._featurize(
            torch.from_numpy(padded).to(self.device),
            torch.from_numpy(lens).to(self.device))
        amaxes = calibrate_activations(self.variables, self.cfg.encoder,
                                       feats, flens,
                                       compute_dtype=self.compute_dtype)
        self._q_tables = quantize_quartznet(self._float_variables,
                                            self.cfg.encoder, amaxes)

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return ((n + 15999) // 16000) * 16000   # round long audio up to 1 s

    @torch.inference_mode()
    def _device_beam(self, lp: torch.Tensor, enc_lens: torch.Tensor):
        """Beam-decode device log-probs (they stay on the device)."""
        labels = self.cfg.labels
        space = labels.index(" ") if " " in labels else -1
        opts = self.opts
        if self._device_word_lm is not None:
            return device_beam_transcripts(
                lp, enc_lens, labels, beam_width=opts.beam_width,
                word_lm=self._device_word_lm,
                wlm_probes=self._device_wlm_probes, space=space,
                alpha=opts.lm_alpha, beta=opts.lm_beta,
                cutoff_top_n=opts.device_beam_cutoff_top_n)
        # char-LM fusion scores raw sequences (space=-1 keeps raw-prefix
        # identity); without any LM, canonical identity
        return device_beam_transcripts(
            lp, enc_lens, labels, beam_width=opts.beam_width,
            lm_table=self._device_lm_table, n_ctx=self._device_n_ctx,
            space=-1 if self._device_lm_table is not None else space,
            alpha=opts.lm_alpha, beta=0.0,
            cutoff_top_n=opts.device_beam_cutoff_top_n)

    # -- public API ----------------------------------------------------------

    def log_probs(self, signal: np.ndarray, lengths=None, *,
                  as_numpy: bool = True):
        """(B?, S) or (S,) waveform -> (log_probs, enc_lens), numpy arrays.

        `lengths` gives per-row valid sample counts (default: every row is
        full length); rows may be zero-padded beyond their length.
        `as_numpy=False` keeps the log-probs on the device (enc_lens still
        comes to the host), for callers that decode on the device."""
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
        if as_numpy:
            return lp.cpu().numpy(), el.cpu().numpy()
        return lp, el.cpu().numpy()

    def transcribe(self, signal: np.ndarray) -> str:
        """Single-utterance transcription."""
        return self.transcribe_batch([signal])[0]

    def _decode_beam(self, beam: list, out: list) -> None:
        """One beam search over the rows of `beam`'s forwards ((rows,
        log_probs, enc_lens) each), their log-probs padded to the longest
        T; each row's text goes to its signal's place in `out`."""
        with tracing.span("pipeline.beam"):
            t_max = max(lp.shape[1] for _, lp, _ in beam)
            lp = torch.cat([F.pad(lp, (0, 0, 0, t_max - lp.shape[1]))
                            for _, lp, _ in beam])
            enc_lens = torch.cat([el for _, _, el in beam])
            rows = [gi for group, _, _ in beam for gi in group]
            for gi, text in zip(rows, self._device_beam(lp, enc_lens)):
                out[gi] = text
            beam.clear()

    def transcribe_batch(self, signals: List[np.ndarray]) -> List[str]:
        """Sort by length, then batch up to max_batch utterances of one
        bucket per forward. The greedy decoder decodes each forward's rows
        as it comes; so does the host beam decoder, after one copy of the
        forward's fp32 log-probs to the host. `decoder="device_beam"` keeps
        the forwards' log-probs on the device and decodes up to 4 x
        max_batch rows of the configured buckets in one beam search (one
        kernel launch on the GPU; rows are independent, each stopping at
        its own length), padded to the longest T among them; audio past
        the last bucket decodes one forward at a time. So a search holds
        at most 4 x max_batch rows of the last bucket's frames, however
        many signals a call has."""
        with tracing.span("pipeline.batch"):
            for s in signals:
                assert_waveform(np.asarray(s), port="transcribe.signal")
            out: List[Optional[str]] = [None] * len(signals)
            beam = []          # (rows, log_probs, enc_lens) per forward
            per_decode = _BEAM_BATCHES_PER_DECODE * self.opts.max_batch
            order = sorted(range(len(signals)),
                           key=lambda i: len(signals[i]))
            i = 0
            while i < len(order):
                bl = self._bucket_len(len(signals[order[i]]))
                group = []
                while (i < len(order) and len(group) < self.opts.max_batch
                       and self._bucket_len(len(signals[order[i]])) == bl):
                    group.append(order[i])
                    i += 1
                with tracing.span("pipeline.pad"):
                    batch = self._host_batch(len(group), bl)
                    lens = np.zeros((len(group),), np.int32)
                    for row, gi in enumerate(group):
                        s = np.asarray(signals[gi], np.float32)
                        batch[row, : len(s)] = s[:bl]
                        lens[row] = min(len(s), bl)
                lp, enc_lens, preds, keep = self._fwd(batch, lens)
                if self.opts.decoder == "device_beam":
                    held = sum(len(g) for g, _, _ in beam)
                    if beam and (bl not in self.buckets
                                 or held + len(group) > per_decode):
                        self._decode_beam(beam, out)
                    beam.append((group, lp, enc_lens))
                    if bl not in self.buckets:
                        self._decode_beam(beam, out)
                    continue
                if self._decoder is not None:
                    with tracing.span("pipeline.readback"):
                        lp_host = lp.float().cpu().numpy()
                        lens_host = enc_lens.cpu().numpy()
                    with tracing.span("pipeline.text"):
                        texts = self._decoder.decode_batch(lp_host,
                                                           lens_host)
                else:
                    with tracing.span("pipeline.readback"):
                        ids = collapse_batch(preds, keep)
                    with tracing.span("pipeline.text"):
                        texts = [ids_to_text(row_ids, self.cfg.labels)
                                 for row_ids in ids]
                for row, gi in enumerate(group):
                    out[gi] = texts[row]
            if beam:
                self._decode_beam(beam, out)
        return out  # type: ignore

    def transcribe_long(self, signal: np.ndarray, *,
                        chunk_seconds: float = 15.0,
                        overlap_seconds: float = 2.0,
                        signal_sr: Optional[int] = None,
                        signal_encoding: Optional[str] = None) -> str:
        """Audio of any length, in overlapping chunks (streaming.py). int16
        PCM, uint8 G.711 (signal_encoding 'ulaw' / 'alaw') and native-rate
        input (signal_sr) are converted and resampled on the device."""
        from vietasr_tpu_torch.streaming import transcribe_long

        return transcribe_long(self, signal, chunk_seconds=chunk_seconds,
                               overlap_seconds=overlap_seconds,
                               signal_sr=signal_sr,
                               signal_encoding=signal_encoding)

    def transcribe_long_batch(self, signals: Sequence[np.ndarray], *,
                              chunk_seconds: float = 15.0,
                              overlap_seconds: float = 2.0,
                              signal_sr: Optional[int] = None,
                              signal_encoding: Optional[str] = None
                              ) -> List[str]:
        """Several long utterances, every one queued on the device before
        any result is read (streaming.transcribe_long_batch)."""
        from vietasr_tpu_torch.streaming import transcribe_long_batch

        return transcribe_long_batch(self, signals,
                                     chunk_seconds=chunk_seconds,
                                     overlap_seconds=overlap_seconds,
                                     signal_sr=signal_sr,
                                     signal_encoding=signal_encoding)

    def transcribe_file(self, path: str) -> str:
        """Read a WAV (PCM, float, G.711) or mp3 file, resample it to the
        model's rate and transcribe it; audio past the last bucket goes
        through transcribe_long."""
        samples, _ = read_audio(
            path, target_sr=self.cfg.featurizer.sample_rate)
        if len(samples) > self.buckets[-1]:
            return self.transcribe_long(samples)
        return self.transcribe(samples)
