"""Batched streaming CTC beam search on the device (counterpart of
vietasr_tpu/ops/streaming_beam.py).

The packed per-beam state of ops/device_beam.py (hashes, p_b / p_nb, LM
score, word-LM context) is carried across chunks, one (B, W, n_cols)
tensor for a whole StreamPool. Each chunk of (B, T_c, V + 1) log-probs is
one search resumed from that state (`fused_beam_search(carry_state=...)`:
one beam-kernel launch on the GPU, the plain `device_beam_search` on the
CPU), then a chunk-local traceback of ALL W final beams (the pointer
doubling of ops/device_beam.py::suffix_maps) appends each beam's emitted
chars to its parent's transcript buffer (B, W, max_chars). The search
resumed chunk by chunk is the offline search over the whole stream; a
transcript differs from the offline one only if a beam's prefix outgrows
`max_chars`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vietasr_tpu_torch.ops.device_beam import (KERNEL_MAX_BEAM_WIDTH, NEG,
                                               WordLMTables,
                                               device_beam_search,
                                               init_packed_state,
                                               packed_beam_totals,
                                               suffix_maps)
from vietasr_tpu_torch.ops.fused_beam import fused_beam_search


class BeamCarry(NamedTuple):
    """Pool-wide streaming beam state (device tensors)."""

    st: torch.Tensor     # (B, W, n_cols) int32 packed beam state
    buf: torch.Tensor    # (B, W, L) int32 per-beam transcript char ids
    lens: torch.Tensor   # (B, W) int32 chars valid in buf
    skip: torch.Tensor   # (B,) int32 warm-up frames left to neutralize


class DeviceStreamingBeam:
    """The pool's device beam: init / reset_rows / chunk / render. The
    caller (serve/streams.py::StreamPool) owns the carry."""

    def __init__(self, *, blank: int, beam_width: int = 16,
                 space: int = -1, cutoff_top_n: int = 8,
                 word_lm: Optional[WordLMTables] = None,
                 alpha: float = 0.5, beta: float = 1.5,
                 wlm_probes: int = 8, max_chars: int = 512,
                 skip_frames: int = 0, impl: str = "auto", device=None):
        self.blank = blank
        self.w = beam_width
        self.space = space
        self.cutoff_top_n = cutoff_top_n
        self.word_lm = word_lm
        self.alpha = alpha
        self.beta = beta
        self.wlm_probes = wlm_probes
        self.max_chars = max_chars
        # the first skip_frames output frames of a fresh stream come from
        # the zero context before the audio: they become certain blanks
        # (log 1 added, nothing emitted), so scores and texts are as if
        # they were dropped (the greedy tier drops them on the host)
        self.skip_frames = skip_frames
        self.device = device
        # "auto": the fused search (the kernel on the GPU) within its
        # contract (canonical identity, pruned expansion, W <= 128), the
        # plain search otherwise; "plain": always the plain search
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        self.kernel_route = (impl == "auto" and space >= 0
                             and cutoff_top_n > 0
                             and beam_width <= KERNEL_MAX_BEAM_WIDTH)

    def init(self, bsz: int) -> BeamCarry:
        dev = self.device
        return BeamCarry(
            st=init_packed_state(bsz, self.w, self.word_lm, dev),
            buf=torch.zeros((bsz, self.w, self.max_chars), dtype=torch.int32,
                            device=dev),
            lens=torch.zeros((bsz, self.w), dtype=torch.int32, device=dev),
            skip=torch.full((bsz,), self.skip_frames, dtype=torch.int32,
                            device=dev))

    def reset_rows(self, carry: BeamCarry, mask: torch.Tensor) -> BeamCarry:
        """Re-initialize the rows where mask (B,) is True."""
        fresh = self.init(carry.st.shape[0])
        return commit_rows(mask, fresh, carry)

    def _search(self, log_probs: torch.Tensor, st: torch.Tensor):
        bsz, t_c, _ = log_probs.shape
        lens = torch.full((bsz,), t_c, dtype=torch.int32,
                          device=log_probs.device)
        kw = dict(beam_width=self.w, blank=self.blank, space=self.space,
                  cutoff_top_n=self.cutoff_top_n, word_lm=self.word_lm,
                  alpha=self.alpha, beta=self.beta,
                  wlm_probes=self.wlm_probes, carry_state=st,
                  return_raw=True)
        if self.kernel_route:
            return fused_beam_search(log_probs, lens, **kw)
        return device_beam_search(log_probs, lens, **kw)

    @torch.inference_mode()
    def chunk(self, carry: BeamCarry, log_probs: torch.Tensor
              ) -> Tuple[BeamCarry, torch.Tensor, torch.Tensor]:
        """Advance every row's beam over (B, T_c, V + 1) log-probs.
        Returns (carry', best_ids (B, L), best_len (B,)): each row's
        current best hypothesis, for partial results."""
        bsz, t_c, v1 = log_probs.shape
        w, dev = self.w, log_probs.device
        log_probs = log_probs.to(torch.float32)
        if self.skip_frames:
            warm = torch.arange(t_c, device=dev)[None] < carry.skip[:, None]
            blank_row = torch.full((v1,), NEG, dtype=torch.float32,
                                   device=dev)
            blank_row[self.blank] = 0.0
            log_probs = torch.where(warm[..., None], blank_row, log_probs)
        new_skip = torch.clamp_min(carry.skip - t_c, 0)
        st, parents, chars = self._search(log_probs.contiguous(), carry.st)

        # chunk-local traceback of every final beam: suffix[t, b, j] is the
        # index after step t of final beam j's ancestor
        s = suffix_maps(parents)                                # (T, B, W)
        ident = torch.arange(w, device=dev).expand(1, bsz, w)
        suffix = torch.cat([s[1:], ident])
        path_chars = torch.gather(chars, 2, suffix)             # (T, B, W)
        start_parent = s[0]                                     # (B, W)

        # the chunk's emitted chars (>= 0) of each final beam, in order
        pc = path_chars.permute(1, 2, 0)                        # (B, W, T)
        vd = pc >= 0
        t_idx = torch.arange(t_c, device=dev)
        order = torch.argsort(torch.where(vd, t_idx, t_c + t_idx), dim=2,
                              stable=True)
        appended = torch.gather(torch.where(vd, pc, 0), 2, order)
        n_app = vd.sum(2).to(torch.int32)                       # (B, W)

        # new_buf[j] = old_buf[parent(j)] ++ appended[j]
        L = self.max_chars
        parent_buf = torch.gather(
            carry.buf, 1, start_parent[..., None].expand(bsz, w, L))
        parent_len = torch.gather(carry.lens, 1, start_parent)
        l_idx = torch.arange(L, device=dev)[None, None]
        app_pos = l_idx - parent_len[..., None]
        app_g = torch.gather(appended, 2,
                             app_pos.clamp(0, t_c - 1).to(torch.int64))
        new_buf = torch.where(
            l_idx < parent_len[..., None], parent_buf,
            torch.where(app_pos < n_app[..., None], app_g, 0)
        ).to(torch.int32)
        new_lens = torch.clamp_max(parent_len + n_app, L)

        total = packed_beam_totals(st, word_lm=self.word_lm,
                                   alpha=self.alpha, beta=self.beta,
                                   wlm_probes=self.wlm_probes)
        best = torch.argmax(total, dim=1)                       # (B,)
        best_ids = torch.gather(
            new_buf, 1, best[:, None, None].expand(bsz, 1, L))[:, 0]
        best_len = torch.gather(new_lens, 1, best[:, None])[:, 0]
        return (BeamCarry(st=st, buf=new_buf, lens=new_lens, skip=new_skip),
                best_ids, best_len)

    def render(self, labels, ids, length) -> str:
        """Host text of one row's hypothesis (canonical identity ignores
        leading, trailing and repeated spaces)."""
        text = "".join(labels[i] for i in ids[:length])
        if self.space >= 0:
            text = " ".join(text.split())
        return text


def commit_rows(mask: torch.Tensor, new: BeamCarry, old: BeamCarry
                ) -> BeamCarry:
    """Row b of `new` where mask[b], else of `old`."""
    return BeamCarry(*[
        torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        for a, b in zip(new, old)])
