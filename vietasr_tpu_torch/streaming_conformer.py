"""Stateful chunked streaming over a chunked-causal Conformer (counterpart
of vietasr_tpu/streaming_conformer.py).

The model is configured chunked-causal (`ConformerConfig.chunk_size > 0`:
chunk-limited attention with `left_chunks` chunks of left context,
left-padded depthwise conv and conv2d subsampling, models/conformer.py),
and inference advances one attention chunk at a time, carrying:

- conv2d subsampling: the last 2 input-time rows of each stage (a valid
  conv over [carry ++ chunk] is the offline left-padded conv);
- per block: the last `left_chunks * chunk_size` frames of the post-FF1
  residual stream (the attention's key/value source), right-aligned, with
  a valid count `kv_len` per stream, and the last conv_kernel - 1 frames
  of the GLU output (the depthwise conv's carry);
- BatchNorm in eval mode (running statistics).

The chunk-by-chunk output equals the offline `conformer_apply` forward of
the same chunked-causal model. Everything is batched over B streams, as
streaming_online.OnlineTranscriber is (JAX vmaps one stream), so
serve/streams.py::StreamPool advances all its slots in one step. The step
runs in IEEE fp32 (utils/device.py::strict_fp32), as JAX runs it. Its
LayerNorm is two-pass, as JAX's streamer's is (the offline forward's is
one-pass).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vietasr_tpu_torch.config import ConformerConfig, ModelConfig
from vietasr_tpu_torch.models.conformer import (_sigmoid,
                                                rel_pos_encoding_range)
from vietasr_tpu_torch.models.layers import batchnorm_apply
from vietasr_tpu_torch.streaming_online import (StreamingFeaturizer,
                                                _per_row, _tree_to,
                                                where_rows)
from vietasr_tpu_torch.utils.device import resolve_device, strict_fp32


@dataclasses.dataclass
class ConformerStreamState:
    """Every encoder carry of B streams (each field's first dim is B)."""

    sub1: torch.Tensor                   # (B, 2, F, 1) stage-1 time carry
    sub2: torch.Tensor                   # (B, 2, F/2, C) stage-2 time carry
    kv: Tuple[torch.Tensor, ...]         # per block (B, L, D) post-FF1 cache
    kv_len: torch.Tensor                 # (B,) int32 valid cached frames
    conv: Tuple[torch.Tensor, ...]       # per block (B, k - 1, D) GLU carry

    def fields(self) -> list:
        return [self.sub1, self.sub2, self.kv_len, *self.kv, *self.conv]

    @classmethod
    def from_fields(cls, fields) -> "ConformerStreamState":
        n = (len(fields) - 3) // 2
        return cls(fields[0], fields[1], kv=tuple(fields[3:3 + n]),
                   kv_len=fields[2], conv=tuple(fields[3 + n:]))

    def where(self, rows: torch.Tensor, other: "ConformerStreamState"
              ) -> "ConformerStreamState":
        """Row b from self where rows[b], else from other."""
        return ConformerStreamState.from_fields([
            where_rows(rows, a, b)
            for a, b in zip(self.fields(), other.fields())])


def _ln(x, p, eps: float = 1e-5):
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.mean((x - m) ** 2, dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * p["scale"] + p["bias"]


def _lin(x, p):
    return x @ p["w"] + p["b"]


def _swish(x):
    return x * _sigmoid(x)


class ConformerStream:
    """Chunk-at-a-time inference of B streams over a chunked-causal
    Conformer: each step takes (B, 4 * chunk_size, F) mel frames (the
    subsampling is 4x) and emits (B, chunk_size, V + 1) log-probs.
    `variables`: the model's tree (numpy or torch leaves), held in fp32 on
    `device` (None: CUDA)."""

    def __init__(self, cfg: ModelConfig, variables: dict, *, device=None):
        if cfg.architecture != "conformer":
            raise ValueError("ConformerStream requires a conformer config")
        ccfg: ConformerConfig = cfg.conformer
        if ccfg.chunk_size <= 0:
            raise ValueError(
                "streaming requires a chunked-causal model "
                "(ConformerConfig.chunk_size > 0); full-context conformers "
                "attend to the whole utterance and cannot stream exactly")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ccfg = ccfg
        self.variables = _tree_to(variables, self.device)
        self.feat_in = cfg.featurizer.features * cfg.featurizer.frame_splicing
        self.c_out = ccfg.chunk_size                      # frames emitted
        self.t_in = 4 * ccfg.chunk_size                   # mel frames fed
        self.l_ctx = ccfg.left_chunks * ccfg.chunk_size
        c, l = self.c_out, self.l_ctx
        # encodings of the offsets (L + i) - j, i in [0, C), j in [0, L + C):
        # [L + C - 1 ... -(C - 1)], the offline values at equal offsets
        self._pos = torch.from_numpy(rel_pos_encoding_range(
            l + c - 1, -(c - 1), ccfg.d_model)).to(self.device)
        # the shift as a gather: position[i, j] = raw[i, (C - 1) - i + j]
        self._pos_idx = torch.from_numpy(
            (c - 1) - np.arange(c)[:, None] + np.arange(l + c)[None, :]
        ).to(self.device)
        dh = ccfg.d_model // ccfg.num_heads
        self._scale = torch.full((1,), float(dh), device=self.device).sqrt()

    def init_state(self, bsz: int = 1) -> ConformerStreamState:
        p = self.variables["params"]
        f, d = self.feat_in, self.ccfg.d_model
        k, n = self.ccfg.conv_kernel, self.ccfg.num_blocks

        def z(*shape):
            return torch.zeros((bsz,) + shape, device=self.device)

        if self.ccfg.subsampling_mode == "stack":
            # frame stacking has no cross-chunk context: empty carries
            sub1, sub2 = z(0, f, 1), z(0, 1, 1)
        else:
            c_sub = p["sub1"]["w"].shape[-1]
            sub1, sub2 = z(2, f, 1), z(2, (f + 2 - 3) // 2 + 1, c_sub)
        return ConformerStreamState(
            sub1=sub1, sub2=sub2,
            kv=tuple(z(self.l_ctx, d) for _ in range(n)),
            kv_len=torch.zeros((bsz,), dtype=torch.int32,
                               device=self.device),
            conv=tuple(z(k - 1, d) for _ in range(n)))

    def _sub_stage(self, carry, x, p):
        """x (B, T, F, Cin), carry (B, 2, F, Cin): the causal-in-time conv2d
        k3 s2 as a valid conv over [carry ++ x] (time), frequency padded
        (1, 1). Returns (new carry, (B, T / 2, F', Cout))."""
        xin = torch.cat([carry, x], 1)                    # (B, T+2, F, Cin)
        w = p["w"].permute(3, 2, 0, 1)                    # HWIO -> OIHW
        y = F.conv2d(F.pad(xin.permute(0, 3, 1, 2), (1, 1)), w, stride=2)
        y = torch.relu(y + p["b"][None, :, None, None])
        return xin[:, -2:], y.permute(0, 2, 3, 1)

    def _mhsa_chunk(self, x_cur, cache, kv_len, p, cur_valid):
        """x_cur (B, C, D) post-FF1 frames (before the LN), cache (B, L, D)
        right-aligned with kv_len (B,) valid frames."""
        ccfg = self.ccfg
        h, d = ccfg.num_heads, ccfg.d_model
        dh = d // h
        c, l = self.c_out, self.l_ctx
        bsz = x_cur.shape[0]
        y = _ln(torch.cat([cache, x_cur], 1), p["ln"])    # (B, S, D)
        q = _lin(y[:, l:], p["q"]).reshape(bsz, c, h, dh).transpose(1, 2)
        k = _lin(y, p["k"]).reshape(bsz, l + c, h, dh).transpose(1, 2)
        v = _lin(y, p["v"]).reshape(bsz, l + c, h, dh).transpose(1, 2)
        pos = (self._pos @ p["pos"]["w"]).reshape(-1, h, dh).permute(1, 2, 0)
        qu = q + p["u"][None, :, None]
        qv = q + p["vb"][None, :, None]
        content = qu @ k.transpose(2, 3)                  # (B, H, C, S)
        raw = qv @ pos                                    # (B, H, C, Lp)
        position = torch.gather(
            raw, 3, self._pos_idx.expand(bsz, h, c, l + c))
        scores = (content + position) / self._scale
        # the cache is right-aligned: key j < L is valid iff j >= L - kv_len;
        # keys of this chunk past cur_valid (past the utterance's end) are
        # masked like the offline length mask
        jpos = torch.arange(l + c, device=x_cur.device)[None]
        valid = jpos >= (l - kv_len)[:, None]             # (B, S)
        if cur_valid is not None:
            valid = valid & ((jpos < l) | (jpos - l < cur_valid[:, None]))
        scores = torch.where(valid[:, None, None, :], scores, -1e30)
        attn = torch.softmax(scores, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(bsz, c, d)
        return _lin(out, p["out"])

    def _conv_chunk(self, x, carry, p, stats, vmask):
        y = _lin(_ln(x, p["ln"]), p["pw1"])
        a, g = y.chunk(2, dim=-1)
        y = a * _sigmoid(g)                               # GLU (B, C, D)
        if vmask is not None:
            y = y * vmask                # the offline mask of the conv input
        k, d = p["dw"].shape
        yin = torch.cat([carry, y], 1)                    # (B, k-1+C, D)
        z = F.conv1d(yin.transpose(1, 2), p["dw"].t().unsqueeze(1),
                     groups=d).transpose(1, 2)
        z, _ = batchnorm_apply(z, p["bn"], stats["conv_bn"], training=False)
        return yin[:, yin.shape[1] - (k - 1):], _lin(_swish(z), p["pw2"])

    def _ffn(self, x, p):
        return _lin(_swish(_lin(_ln(x, p["ln"]), p["in"])), p["out"])

    @torch.inference_mode()
    def step(self, state: ConformerStreamState, feats: torch.Tensor,
             cur_valid=None):
        """feats (B, 4 * chunk_size, F) mel frames -> (state, (B,
        chunk_size, V + 1) log-probs). cur_valid (a scalar or (B,)): output
        frames of this chunk inside the utterance; those past it are masked
        as the offline forward's length mask does (the final chunk)."""
        with strict_fp32():
            return self._step(state, feats, cur_valid)

    def _step(self, state: ConformerStreamState, feats, cur_valid):
        p = self.variables["params"]
        stats = self.variables["batch_stats"]
        bsz = feats.shape[0]
        vmask = None
        if cur_valid is not None:
            cur_valid = _per_row(cur_valid, bsz, torch.int64, feats.device)
            vmask = (torch.arange(self.c_out, device=feats.device)[None]
                     < cur_valid[:, None])[..., None].float()
        if self.ccfg.subsampling_mode == "stack":
            s1, s2 = state.sub1, state.sub2
            y = feats.reshape(bsz, self.c_out, -1)        # (B, C, 4F)
        else:
            s1, y = self._sub_stage(state.sub1, feats[..., None], p["sub1"])
            s2, y = self._sub_stage(state.sub2, y, p["sub2"])
            y = y.reshape(bsz, y.shape[1], -1)
        x = _lin(y, p["proj"])                            # (B, C, D)
        if vmask is not None:
            x = x * vmask                # offline: x = x * length_mask

        new_kv: List[torch.Tensor] = []
        new_conv: List[torch.Tensor] = []
        for bi, bp in enumerate(p["blocks"]):
            x = x + 0.5 * self._ffn(x, bp["ff1"])
            new_kv.append(torch.cat([state.kv[bi], x], 1)[:, -self.l_ctx:])
            x = x + self._mhsa_chunk(x, state.kv[bi], state.kv_len,
                                     bp["mhsa"], cur_valid)
            carry, conv = self._conv_chunk(x, state.conv[bi], bp["conv"],
                                           stats["blocks"][bi], vmask)
            new_conv.append(carry)
            x = x + conv
            x = x + 0.5 * self._ffn(x, bp["ff2"])
            x = _ln(x, bp["final_ln"])

        log_probs = torch.log_softmax(_lin(x, p["decoder"]), dim=-1)
        new_state = ConformerStreamState(
            sub1=s1, sub2=s2, kv=tuple(new_kv),
            kv_len=torch.clamp_max(state.kv_len + self.c_out, self.l_ctx),
            conv=tuple(new_conv))
        return new_state, log_probs

    def stream(self, feat_chunks) -> np.ndarray:
        """Feed (4 * chunk_size, F) mel-frame chunks of one stream; returns
        the concatenated (T_out, V + 1) log-probs, numpy."""
        state = self.init_state(1)
        outs: List[np.ndarray] = []
        for ch in feat_chunks:
            ch = torch.as_tensor(np.asarray(ch, np.float32),
                                 device=self.device)
            if ch.shape[0] != self.t_in:
                raise ValueError(
                    f"feature chunk must be exactly {self.t_in} frames "
                    f"(4 * chunk_size); pad the final chunk")
            state, lp = self.step(state, ch[None])
            outs.append(lp[0].cpu().numpy())
        if not outs:
            return np.zeros((0, 1), np.float32)
        return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------------
# raw-audio online transcriber (StreamPool-compatible)


@dataclasses.dataclass
class ConformerOnlineState:
    """The featurizer's 5 fields and the encoder's carries, B streams."""

    feat: Tuple[torch.Tensor, ...]
    enc: ConformerStreamState

    def where(self, rows: torch.Tensor, other: "ConformerOnlineState"
              ) -> "ConformerOnlineState":
        """Row b from self where rows[b], else from other."""
        return ConformerOnlineState(
            feat=tuple(where_rows(rows, a, b)
                       for a, b in zip(self.feat, other.feat)),
            enc=self.enc.where(rows, other.enc))


class ConformerOnlineTranscriber:
    """Raw-audio real-time streaming over a chunked-causal Conformer, with
    OnlineTranscriber's interface (`device`, `cfg`, `init_state(bsz)`,
    `seed_carry`, `step`, `prefix_frames`, `out_frames`) so StreamPool
    takes either. Each step consumes exactly `required_chunk_samples` =
    4 * chunk_size * hop samples a stream (one attention chunk: 0.64 s at
    chunk_size 16, 10 ms hop) and emits chunk_size frames. Normalization
    is causal running stats unless causal_norm=False (no normalization).

    The featurizer's junk region (frames before the audio) is aligned to
    a whole attention chunk (junk_align = 4 * chunk_size), so the first
    step covers exactly that region (`skip_first_step`) and runs with the
    encoder frozen (`enc_skip`): pre-audio frames never enter the KV cache
    or the conv carries, as offline chunk 0 has no left context."""

    def __init__(self, cfg: ModelConfig, variables: dict, *,
                 causal_norm: bool = True, device=None):
        self.device = resolve_device(device)
        self._enc = ConformerStream(cfg, variables, device=self.device)
        self.cfg = cfg
        self.variables = self._enc.variables
        self._sf = StreamingFeaturizer(
            cfg.featurizer, causal_norm=causal_norm,
            junk_align=4 * max(cfg.conformer.chunk_size, 1),
            device=self.device)
        self.required_chunk_samples = \
            self._enc.t_in * cfg.featurizer.hop_length
        self.skip_first_step = self._sf.junk_frames == self._enc.t_in

    @property
    def prefix_frames(self) -> int:
        """Output frames at stream start that come from the featurizer's
        junk frames, ceil(junk / 4): with skip_first_step one chunk's (the
        frozen first step's placeholders). Callers drop them."""
        return -(-self._sf.junk_frames // 4)

    def out_frames(self, samples: int) -> int:
        """Encoder frames emitted per `samples`-long raw chunk."""
        return samples // (self.cfg.featurizer.hop_length * 4)

    def init_state(self, bsz: int = 1) -> ConformerOnlineState:
        return ConformerOnlineState(feat=self._sf.init_fields(bsz),
                                    enc=self._enc.init_state(bsz))

    def seed_carry(self, state: ConformerOnlineState,
                   first_chunk: torch.Tensor) -> ConformerOnlineState:
        """The state with each row's audio carry reflect-filled from that
        row's first chunk (StreamingFeaturizer.reflect_carry)."""
        feat = (self._sf.reflect_carry(first_chunk),) + tuple(state.feat[1:])
        return ConformerOnlineState(feat=feat, enc=state.enc)

    @torch.inference_mode()
    def step(self, state: ConformerOnlineState, chunk: torch.Tensor,
             is_pad=False, is_tail=False, tail_real=0, enc_skip=False,
             cur_valid=None):
        """One step of B streams: chunk (B, required_chunk_samples); each
        flag a scalar or one per row. Returns (state, (B, chunk_size,
        V + 1) log-probs).

        is_pad: a drain step on zero features, the featurizer frozen.
        is_tail: the chunk's samples past tail_real are replaced by the end
        reflect tail made from the audio carry (the offline featurizer's
        right padding). enc_skip: the featurizer advances, the encoder's
        state does not (the rows' output frames are placeholders): the
        all-junk first step. cur_valid: output frames of this chunk inside
        the utterance (ConformerStream.step)."""
        with strict_fp32():
            return self._step(state, chunk, is_pad, is_tail, tail_real,
                              enc_skip, cur_valid)

    def _step(self, state, chunk, is_pad, is_tail, tail_real, enc_skip,
              cur_valid):
        bsz = chunk.shape[0]
        dev = chunk.device
        is_pad = _per_row(is_pad, bsz, torch.bool, dev)
        enc_skip = _per_row(enc_skip, bsz, torch.bool, dev)
        chunk = self._sf.with_end_tail(
            state.feat[0], chunk, _per_row(is_tail, bsz, torch.bool, dev),
            _per_row(tail_real, bsz, torch.int64, dev))
        feat, frames = self._sf.step(state.feat, chunk)
        frames = torch.where(is_pad[:, None, None], 0.0, frames)
        feat = tuple(where_rows(is_pad, old, new)
                     for new, old in zip(feat, state.feat))
        enc, lp = self._enc._step(state.enc, frames, cur_valid)
        enc = state.enc.where(enc_skip, enc)
        return ConformerOnlineState(feat=feat, enc=enc), lp

    def stream(self, chunks, *, drop_prefix: bool = True,
               true_samples: Optional[int] = None) -> np.ndarray:
        """Feed raw-sample chunks of one stream, each exactly
        `required_chunk_samples`; returns the (T_out, V + 1) log-probs,
        numpy, the prefix frames dropped unless drop_prefix=False.

        true_samples: the utterance's real length when the last chunk is
        zero-padded: the chunk holding the end runs as the tail step, the
        featurizer's lag is drained, and the output is cut to the real
        frame count."""
        hop = self.cfg.featurizer.hop_length
        t_out = self._enc.c_out
        true_out = None
        if true_samples is not None:
            true_out = -(-(-(-true_samples // hop)) // 4)

        def valid_for(step_idx):
            # step 0 is the junk step; step k >= 1 emits offline frames
            # [(k - 1) * t_out, k * t_out)
            if true_out is None:
                return None
            return int(np.clip(true_out - (step_idx - 1) * t_out, 0, t_out))

        def run(x, tail, r, skip):
            nonlocal state, step_idx
            state, lp = self.step(state, x, False, tail, r, skip,
                                  valid_for(step_idx))
            outs.append(lp[0].cpu().numpy())
            step_idx += 1

        state = self.init_state(1)
        outs: List[np.ndarray] = []
        first, fed, step_idx, did_tail = True, 0, 0, False
        for chunk in chunks:
            if len(chunk) != self.required_chunk_samples:
                raise ValueError(
                    f"chunk must be exactly {self.required_chunk_samples} "
                    f"samples (4 * chunk_size * hop); pad the final chunk")
            x = torch.as_tensor(np.asarray(chunk, np.float32),
                                device=self.device)[None]
            if first:
                state = self.seed_carry(state, x)
            skip = first and self.skip_first_step
            first = False
            if true_samples is not None and fed + len(chunk) > true_samples:
                run(x, True, max(true_samples - fed, 0), skip)
                fed += len(chunk)
                did_tail = True
                break
            run(x, False, 0, skip)
            fed += len(chunk)
        if true_samples is not None and outs:
            # the featurizer's junk-frame lag: the last frames (the end
            # reflect held in the audio carry too) come out one step later
            zero = torch.zeros((1, self.required_chunk_samples),
                               device=self.device)
            if not did_tail:
                run(zero, True, 0, False)
            while (step_idx - 1) * t_out < true_out:
                run(zero, False, 0, False)
        if not outs:
            return np.zeros((0, 1), np.float32)
        out = np.concatenate(outs, axis=0)
        if drop_prefix:
            out = out[self.prefix_frames:]
        if true_out is not None:
            out = out[:true_out]
        return out
