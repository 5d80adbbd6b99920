"""Online (stateful) streaming inference over a folded QuartzNet
(counterpart of vietasr_tpu/streaming_online.py).

A step `(state, audio chunk) -> (state, new log-probs)` in which every
conv layer carries its last k - 1 input frames: each "same"-padded conv
becomes a valid conv over [carry ++ chunk], the residual 1x1 taps that
input at the conv's centre offset k // 2, and the new carry is the last
k - 1 frames. Each sample is convolved once, and with a flush the streamed
output equals the offline forward of the audio: the audio carry is
reflect-filled from the first chunk (the offline featurizer's left
reflect padding), pre-audio positions of every layer are zeroed (the
offline zero conv padding), the end runs one reflect-tail step (the
offline right reflect padding) and then pad steps on zero features.
Normalization is causal running stats, the statistics of the offline
`normalize="causal_per_feature"`.

Everything is batched: a state holds B streams (rows), and `step` takes a
(B, S) chunk with per-row flush flags, so StreamPool (serve/streams.py)
advances all its slots in one call; `stream` is B = 1. The step runs per
op (`depthwise_conv1d` + `pointwise_conv`, models/layers.py), in IEEE
fp32 (utils/device.py::strict_fp32), as JAX runs it per op; the repeat
kernel is an offline-forward kernel and is not on this path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from vietasr_tpu_torch.config import ModelConfig
from vietasr_tpu_torch.frontend.features import (CAUSAL_STD_GUARD,
                                                 FeaturizerConfig,
                                                 _mel_matrix,
                                                 _windowed_dft_matrix)
from vietasr_tpu_torch.models.layers import (dense_conv1d, depthwise_conv1d,
                                             pointwise_conv)
from vietasr_tpu_torch.models.quartznet import map_tree
from vietasr_tpu_torch.streaming import encoder_stride
from vietasr_tpu_torch.utils.device import resolve_device, strict_fp32


def _per_row(v, bsz: int, dtype, device) -> torch.Tensor:
    """A scalar or (B,) flag/int as a (B,) tensor."""
    return torch.as_tensor(v, dtype=dtype, device=device).expand(bsz)


def where_rows(rows: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """Row i of a where rows[i], else of b (rows (B,) bool)."""
    return torch.where(rows.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


class StreamingFeaturizer:
    """Stateful chunked log-mel frontend. Its state is the 5 fields
    (audio carry (B, L), last raw sample before it (B,), frames processed
    (B,), running sums (B, n_mels) x 2); `step(fields, chunk)` takes (B, S)
    raw samples, S a multiple of hop, and emits S / hop frames a row whose
    centres land on the offline hop grid."""

    def __init__(self, fc: FeaturizerConfig, *, causal_norm: bool = True,
                 junk_align: int = 1, device=None):
        if fc.frame_splicing != 1:
            raise NotImplementedError(
                "online streaming requires frame_splicing == 1")
        self.fc = fc
        self.causal_norm = causal_norm
        self.device = resolve_device(device)
        self._dft = torch.from_numpy(_windowed_dft_matrix(fc)).to(self.device)
        self._mel = torch.from_numpy(_mel_matrix(fc)).to(self.device)
        # audio carry length L: L = n_fft // 2 (mod hop) puts emitted
        # frame centres on the offline hop grid, and a junk-frame count
        # that is a multiple of junk_align (the encoder's stride product)
        # keeps the stride-2 prologue in phase with the offline forward
        n_fft, hop = fc.fft_length, fc.hop_length
        base = n_fft - hop
        self.audio_carry = base + ((n_fft // 2 - base) % hop)
        j0 = -(-(self.audio_carry - n_fft // 2) // hop)
        self.audio_carry += ((-j0) % max(junk_align, 1)) * hop

    @property
    def junk_frames(self) -> int:
        """Emitted frames at stream start whose centres fall before the
        audio: ceil((L - n_fft / 2) / hop)."""
        return -(-(self.audio_carry - self.fc.fft_length // 2)
                 // self.fc.hop_length)

    @property
    def tail_valid_frames(self) -> int:
        """Frames of the end-reflect tail step whose centres are still
        inside the audio."""
        return -(-(self.fc.fft_length // 2) // self.fc.hop_length)

    def reflect_carry(self, first_chunk: torch.Tensor) -> torch.Tensor:
        """(B, L) audio-carry contents that make the stream's first frames
        equal the offline featurizer's: the carry holds raw samples c that
        the step pre-emphasizes, so its tail solves c_j - p c_{j-1} =
        xp[half - j] (the offline reflected pre-emphasized values) with a
        zero last cell, c_m = -sum_{j > m} T_j p^{m - j}, a scaled reverse
        cumsum. Cells before the tail feed only junk frames."""
        fc = self.fc
        half = fc.fft_length // 2
        if first_chunk.shape[1] <= half:
            raise ValueError(
                f"first chunk must exceed n_fft/2={half} samples to "
                "build the reflect carry")
        bsz, lc = first_chunk.shape[0], self.audio_carry
        carry = first_chunk.new_zeros((bsz, lc))
        p = fc.preemph
        if not p:
            carry[:, lc - half:] = first_chunk[:, 1: half + 1].flip(1)
            return carry
        x = first_chunk[:, : half + 1]
        xp = x - p * torch.cat([x.new_zeros((bsz, 1)), x[:, :-1]], 1)
        t = xp[:, 1: half + 1].flip(1)                   # T_j = xp[half - j]
        j = torch.arange(half, dtype=torch.float32, device=x.device)
        a = t * p ** (-j)
        s = torch.cumsum(a.flip(1), 1).flip(1) - a      # sum_{j' > j} a_j'
        c = -(p ** j) * s
        carry[:, lc - half:] = c
        if lc > half:
            # the cell before the tail: pre-emphasis of cell 0 gives T_0
            carry[:, lc - half - 1] = (c[:, 0] - t[:, 0]) / p
        return carry

    def end_reflect_tail(self, carry: torch.Tensor) -> torch.Tensor:
        """(B, half) raw samples that extend each stream with the offline
        featurizer's end reflect padding, from the last half + 2 samples:
        y_i = T_i + p y_{i-1}, T_i = xp[N - 2 - i], in closed form by a
        scaled cumsum."""
        half = self.fc.fft_length // 2
        if carry.shape[1] < half + 2:
            raise ValueError("audio carry shorter than n_fft/2 + 2")
        p = self.fc.preemph
        x = carry[:, -(half + 2):]
        if not p:
            return x[:, 2: half + 1].flip(1)           # plain end reflect
        xp = x[:, 1:] - p * x[:, :-1]
        t = xp[:, :-1].flip(1)                          # T_i = xp[N-2-i]
        i = torch.arange(half, dtype=torch.float32, device=x.device)
        a = t * p ** (-i)
        return (p ** i) * torch.cumsum(a, 1) + (p ** (i + 1)) * x[:, -1:]

    def with_end_tail(self, audio: torch.Tensor, chunk: torch.Tensor,
                      is_tail: torch.Tensor, tail_real: torch.Tensor
                      ) -> torch.Tensor:
        """The (B, S) chunk with the rows where is_tail holds replaced by
        their end-reflect tail: the first tail_real samples are the last
        real audio, then the offline featurizer's end reflect padding
        (end_reflect_tail of the last half + 2 real samples, read from the
        (B, L) audio carry and the chunk), then zeros."""
        s_len = chunk.shape[1]
        dev = chunk.device
        half = self.fc.fft_length // 2
        lc = audio.shape[1]
        buf = torch.cat([audio, chunk], 1)
        start = torch.clamp(lc + tail_real - (half + 2), 0,
                            lc + s_len - (half + 2))
        seg = torch.gather(buf, 1, start[:, None] + torch.arange(
            half + 2, device=dev))
        refl = self.end_reflect_tail(seg)
        pos = torch.arange(s_len, device=dev)[None]
        rel = pos - tail_real[:, None]
        masked = torch.where(pos < tail_real[:, None], chunk, 0.0)
        tail_chunk = torch.where(
            (rel >= 0) & (rel < half),
            torch.gather(refl, 1, rel.clamp(0, refl.shape[1] - 1)), masked)
        return torch.where(is_tail[:, None], tail_chunk, chunk)

    def init_fields(self, bsz: int = 1):
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=self.device)
        m = self.fc.features
        return (z(bsz, self.audio_carry), z(bsz), z(bsz), z(bsz, m),
                z(bsz, m))

    def step(self, fields, chunk: torch.Tensor):
        """fields: the 5-tuple; chunk (B, S). Returns (new_fields,
        (B, S / hop, n_mels) frames)."""
        audio, preemph_last, norm_count, norm_s1, norm_s2 = fields
        fc = self.fc
        hop, n_fft = fc.hop_length, fc.fft_length
        x = torch.cat([audio, chunk], 1)
        prev = torch.cat([preemph_last[:, None], x[:, :-1]], 1)
        xp = x - fc.preemph * prev if fc.preemph else x
        n_frames = chunk.shape[1] // hop
        need = (n_frames - 1) * hop + n_fft
        spec = xp[:, :need].unfold(1, n_fft, hop) @ self._dft
        n_bins = n_fft // 2 + 1
        power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
        mel = torch.log(power @ self._mel + fc.log_zero_guard_value)

        # the first junk_frames outputs come from the carry before the
        # audio: they are left out of the running stats (which then equal
        # the offline causal stats frame for frame) and output as zero
        g = norm_count[:, None] + torch.arange(
            n_frames, dtype=torch.float32, device=x.device)
        keep = (g >= float(self.junk_frames)).to(mel.dtype)     # (B, n)
        if self.causal_norm:
            eff0 = torch.clamp_min(norm_count - float(self.junk_frames), 0.0)
            cnt = eff0[:, None] + torch.cumsum(keep, 1)
            mel_k = mel * keep[..., None]
            s1 = norm_s1[:, None] + torch.cumsum(mel_k, 1)
            s2 = norm_s2[:, None] + torch.cumsum(mel_k * mel_k, 1)
            cnt_safe = torch.clamp_min(cnt, 1.0)[..., None]
            mean = s1 / cnt_safe
            var = torch.clamp_min(s2 / cnt_safe - mean * mean, 0.0) \
                * (cnt_safe / torch.clamp_min(cnt_safe - 1.0, 1.0))
            std = torch.sqrt(var) + CAUSAL_STD_GUARD
            out = ((mel - mean) / std) * keep[..., None]
            new_norm = (norm_count + float(n_frames), s1[:, -1], s2[:, -1])
        else:
            out = mel * keep[..., None]
            new_norm = (norm_count + float(n_frames), norm_s1, norm_s2)
        lc = self.audio_carry
        return (x[:, -lc:], x[:, -(lc + 1)]) + new_norm, out


@dataclasses.dataclass
class StreamState:
    """Every carry of B streams (each field's first dimension is B)."""

    audio: torch.Tensor                 # (B, L) raw-sample carry
    preemph_last: torch.Tensor          # (B,) raw sample before it
    norm_count: torch.Tensor            # (B,) frames seen
    norm_s1: torch.Tensor               # (B, n_mels) running sum
    norm_s2: torch.Tensor               # (B, n_mels) running sum of squares
    feat_pos: torch.Tensor              # (B,) int32 feature frames processed
    real_feat_end: torch.Tensor         # (B,) int32 frames before the flush
    blocks: Tuple[torch.Tensor, ...]    # per conv block: (B, k - 1, C)

    def fields(self) -> list:
        return [self.audio, self.preemph_last, self.norm_count, self.norm_s1,
                self.norm_s2, self.feat_pos, self.real_feat_end,
                *self.blocks]

    @classmethod
    def from_fields(cls, fields) -> "StreamState":
        return cls(*fields[:7], blocks=tuple(fields[7:]))

    def where(self, rows: torch.Tensor, other: "StreamState"
              ) -> "StreamState":
        """Row b from self where rows[b], else from other."""
        return StreamState.from_fields([
            where_rows(rows, a, b)
            for a, b in zip(self.fields(), other.fields())])


def _tree_to(tree, device):
    def leaf(a):
        if torch.is_tensor(a):
            return a.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return map_tree(leaf, tree)


class OnlineTranscriber:
    """Stateful streaming over a folded QuartzNet. `folded_variables`: the
    folded-BN variables tree (numpy or torch leaves); they are held in fp32
    on `device` (None: CUDA)."""

    def __init__(self, cfg: ModelConfig, folded_variables: dict, *,
                 causal_norm: bool = True, device=None):
        if cfg.architecture != "quartznet":
            raise NotImplementedError(
                "OnlineTranscriber streams a QuartzNet; a chunked-causal "
                "Conformer streams through streaming_conformer."
                "ConformerOnlineTranscriber")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.variables = _tree_to(folded_variables, self.device)
        self.causal_norm = causal_norm
        stride_prod = 1
        for b in cfg.encoder.blocks:
            stride_prod *= b.stride
        self._sf = StreamingFeaturizer(cfg.featurizer,
                                       causal_norm=causal_norm,
                                       junk_align=stride_prod,
                                       device=self.device)
        for b in cfg.encoder.blocks[1:]:
            if b.stride != 1 or b.dilation != 1 or b.repeat != 1:
                raise NotImplementedError(
                    "online streaming requires stride/dilation/repeat 1 "
                    "after the prologue")
        # each strided conv must consume the junk region in whole strides
        j = self._sf.junk_frames
        for b in cfg.encoder.blocks:
            half = (b.effective_kernel - 1) // 2
            if (j + half) % b.stride:
                raise NotImplementedError(
                    f"stride {b.stride} block with half-kernel {half} "
                    f"breaks offline grid alignment at junk={j}")
            j = (j + half) // b.stride
        self._audio_carry = self._sf.audio_carry
        # per block: output positions before the audio (the prefix_frames
        # recurrence after that block) and the cumulative stride; the step
        # zeroes those positions and those past the utterance, as the
        # offline forward's conv padding and mask_padding do
        self._junk_after, self._stride_after = [], []
        j, cum = self._sf.junk_frames, 1
        for b in cfg.encoder.blocks:
            half = (b.effective_kernel - 1) // 2
            j = -(-(j + half) // b.stride)
            cum *= b.stride
            self._junk_after.append(j)
            self._stride_after.append(cum)

    @property
    def prefix_frames(self) -> int:
        """Encoder frames at stream start that correspond to the zero
        context before the audio (callers drop them): a valid conv (k,
        stride s) over J leading context frames emits ceil((J + (k-1)/2)
        / s) of them."""
        return self._junk_after[-1]

    def out_frames(self, samples: int) -> int:
        """Encoder frames emitted per `samples`-long raw chunk."""
        return samples // (self.cfg.featurizer.hop_length
                           * encoder_stride(self.cfg.encoder))

    def init_state(self, bsz: int = 1) -> StreamState:
        carries = []
        c_in = self.cfg.featurizer.features
        for b in self.cfg.encoder.blocks:
            carries.append(torch.zeros(
                (bsz, b.effective_kernel - 1, c_in), dtype=torch.float32,
                device=self.device))
            c_in = b.filters
        zi = torch.zeros((bsz,), dtype=torch.int32, device=self.device)
        return StreamState(*self._sf.init_fields(bsz), feat_pos=zi,
                           real_feat_end=zi.clone(), blocks=tuple(carries))

    def seed_carry(self, state: StreamState, first_chunk: torch.Tensor
                   ) -> StreamState:
        """The state with each row's audio carry reflect-filled from that
        row's first chunk (StreamingFeaturizer.reflect_carry), which makes
        the boundary frames offline-identical. `stream` applies it itself;
        StreamPool applies it to the rows of fresh slots."""
        return dataclasses.replace(
            state, audio=self._sf.reflect_carry(first_chunk))

    def _block_chunk(self, carry, x, params, bcfg):
        """x (B, T, C_in) new frames -> (new carry, (B, T_out, C_out))."""
        k = bcfg.effective_kernel
        xin = torch.cat([carry, x], 1)                # (B, k-1+T, C)
        sub = params["sub"][0]
        if bcfg.separable:
            y = depthwise_conv1d(xin, sub["dw_w"], stride=bcfg.stride)
            y = pointwise_conv(y, sub["pw_w"]) + sub["b"]
        else:
            y = dense_conv1d(xin, sub["conv_w"], stride=bcfg.stride) \
                + sub["b"]
        if params["res"]:
            pane = params["res"][0]
            # the residual taps the conv-centre-aligned input
            start = k // 2
            x_res = xin[:, start: start + y.shape[1] * bcfg.stride:
                        bcfg.stride]
            y = y + pointwise_conv(x_res, pane["conv_w"]) + pane["b"]
        y = torch.relu(y)
        return (xin[:, -(k - 1):] if k > 1 else carry), y

    @torch.inference_mode()
    def step(self, state: StreamState, chunk: torch.Tensor, is_pad=False,
             is_tail=False, tail_real=0):
        """One chunk step of B streams: chunk (B, S) raw samples, S a
        multiple of 2 * hop; is_pad / is_tail (bool) and tail_real (int),
        each a scalar or one per row. Returns (state, (B, T_out, V + 1)
        log-probs). Two flush modes:

        is_tail: the end-reflect step, run once when the audio ends: the
        chunk's first tail_real samples are the last real audio, followed
        by the end reflect padding (end_reflect_tail) and zeros; only the
        frames whose centres precede the audio end count as real.

        is_pad: a drain step: the encoder advances on zero features (the
        offline right conv padding) with the featurizer frozen."""
        with strict_fp32():
            return self._step(state, chunk, is_pad, is_tail, tail_real)

    def _step(self, state: StreamState, chunk, is_pad, is_tail, tail_real):
        bsz = chunk.shape[0]
        dev = chunk.device
        is_pad = _per_row(is_pad, bsz, torch.bool, dev)
        is_tail = _per_row(is_tail, bsz, torch.bool, dev)
        tail_real = _per_row(tail_real, bsz, torch.int64, dev)
        sf = self._sf
        hop = sf.fc.hop_length
        chunk = sf.with_end_tail(state.audio, chunk, is_tail, tail_real)

        fields = (state.audio, state.preemph_last, state.norm_count,
                  state.norm_s1, state.norm_s2)
        new_fields, feats = sf.step(fields, chunk)
        feats = torch.where(is_pad[:, None, None], 0.0, feats)
        fields = [where_rows(is_pad, b, a)
                  for a, b in zip(new_fields, fields)]
        feat_pos = state.feat_pos
        n = feats.shape[1]
        # real_feat_end: the utterance's offline frame count in stream
        # coordinates, from which each block's offline length follows.
        # Normal steps: every emitted frame is real; the tail step: the
        # frames still in the carry plus ceil(tail_real / hop); pad
        # steps: frozen
        tail_end = feat_pos + sf.junk_frames + (tail_real + hop - 1) // hop
        real_end = torch.where(
            is_pad, state.real_feat_end,
            torch.where(is_tail, tail_end, feat_pos + n)).to(torch.int32)
        fidx = feat_pos[:, None] + torch.arange(n, device=dev)
        x = torch.where((fidx >= real_end[:, None])[..., None], 0.0, feats)
        real_len = torch.clamp_min(real_end - sf.junk_frames, 0)
        new_carries = []
        for i, bcfg in enumerate(self.cfg.encoder.blocks):
            carry, x = self._block_chunk(
                state.blocks[i], x, self.variables["params"]["encoder"][i],
                bcfg)
            real_len = (real_len + bcfg.stride - 1) // bcfg.stride
            if self.cfg.encoder.conv_mask:
                # zero this block's outputs before the audio and past the
                # utterance's per-block offline length (position-based:
                # deeper blocks lag, so real positions still come out in
                # the flush's pad steps)
                idx = (feat_pos // self._stride_after[i])[:, None] \
                    + torch.arange(x.shape[1], device=dev)
                ja = self._junk_after[i]
                bad = (idx < ja) | (idx >= ja + real_len[:, None])
                x = torch.where(bad[..., None], 0.0, x)
            new_carries.append(carry)
        dec = self.variables["params"]["decoder"]
        log_probs = torch.log_softmax(x @ dec["w"] + dec["b"], dim=-1)
        new_state = StreamState(*fields, feat_pos=feat_pos + n,
                                real_feat_end=real_end,
                                blocks=tuple(new_carries))
        return new_state, log_probs

    def stream(self, chunks, *, drop_prefix: bool = True,
               flush: bool = False, true_samples: Optional[int] = None
               ) -> np.ndarray:
        """Feed raw-sample chunks of one stream (each a multiple of 2 * hop
        samples); returns the emitted log-probs, (T, V + 1) numpy, with the
        zero-context prefix frames dropped unless drop_prefix=False.

        flush=True drains the model's latency after the last chunk: one
        end-reflect tail step, then pad steps on zero features, so the
        output matches the offline forward end to end. true_samples
        (implies flush): the real length when the last chunk is
        zero-padded; the chunk holding the end runs as the tail step."""
        hop = self.cfg.featurizer.hop_length
        state = self.init_state(1)
        outs: List[np.ndarray] = []
        chunk_len = 0
        first = True
        fed = 0
        did_tail = False

        def emit(lp):
            if lp.shape[1]:
                outs.append(lp[0].cpu().numpy())

        for chunk in chunks:
            if len(chunk) % (2 * hop) != 0:
                raise ValueError(
                    f"chunk length {len(chunk)} must be a multiple of "
                    f"2*hop={2 * hop} (an even frame count keeps the "
                    "stride-2 prologue's phase); pad the final chunk")
            chunk_len = len(chunk)
            x = torch.as_tensor(np.asarray(chunk, np.float32),
                                device=self.device)[None]
            if first:
                state = self.seed_carry(state, x)
                first = False
            if true_samples is not None and fed + len(chunk) > true_samples:
                # the chunk holding the true end: the tail step
                state, lp = self.step(state, x, False, True,
                                      max(true_samples - fed, 0))
                did_tail = True
                emit(lp)
                break
            fed += len(chunk)
            state, lp = self.step(state, x)
            emit(lp)
        if (flush or true_samples is not None) and chunk_len:
            zero = torch.zeros((1, chunk_len), dtype=torch.float32,
                               device=self.device)
            per_chunk = max(self.out_frames(chunk_len), 1)
            if not did_tail:
                # the audio ended on the chunk grid: a pure-reflect tail
                state, lp = self.step(state, zero, False, True)
                emit(lp)
            for _ in range(-(-self.prefix_frames // per_chunk)):
                state, lp = self.step(state, zero, True)
                emit(lp)
        if not outs:
            return np.zeros((0, 1))
        out = np.concatenate(outs, axis=0)
        return out[self.prefix_frames:] if drop_prefix else out
