"""Multi-stream online serving: many concurrent real-time streams on one
GPU (counterpart of vietasr_tpu/serve/streams.py).

The transcriber is streaming_online.OnlineTranscriber (QuartzNet) or
streaming_conformer.ConformerOnlineTranscriber (a chunked-causal
Conformer, which fixes chunk_samples to its attention chunk and runs each
stream's all-junk first step with the encoder frozen). Its `step` is
batched, so the pool's slots are the batch dimension of one step: one
call advances every slot by one chunk. Idle slots are fed silence so
shapes stay fixed, and only the fed slots' state rows are committed
(`torch.where`), so sessions never push phantom audio through each
other's state. Chunks arrive as float32, int16 PCM or
uint8 G.711 (`wire_encoding`), go to the device in that dtype and are
decoded there (ops/g711.py).

Decoders:
- "greedy": per-slot greedy collapse on the host (IncrementalGreedy);
- "beam": the device beam carried across chunks (ops/streaming_beam.py,
  the beam kernel on the GPU; `beam_impl="plain"` for its plain version),
  W = beam_width, cutoff 8, optional word-LM fusion; the tick returns each
  slot's best hypothesis;
- "beam_host": the host prefix beam per slot (IncrementalBeam).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from vietasr_tpu_torch.ops.g711 import decode_wire
from vietasr_tpu_torch.ops.greedy import ctc_collapse
from vietasr_tpu_torch.streaming_online import OnlineTranscriber
from vietasr_tpu_torch.utils.typing import assert_waveform


class IncrementalGreedy:
    """Greedy CTC collapse across chunk boundaries."""

    def __init__(self, labels, blank: int):
        self.labels = labels
        self.blank = blank
        self.last = -1
        self.ids: List[int] = []

    def feed(self, log_probs: np.ndarray) -> str:
        """Feed (T, V) new frames; returns the newly emitted text."""
        preds = np.argmax(log_probs, axis=-1)
        new = ctc_collapse(preds, blank=self.blank, prev=self.last)
        if len(preds):
            self.last = int(preds[-1])
        self.ids.extend(new)
        return "".join(self.labels[i] for i in new)

    @property
    def text(self) -> str:
        return "".join(self.labels[i] for i in self.ids)


class IncrementalBeam:
    """Host streaming prefix beam search of one slot. The best beam can
    revise earlier output; a revision is emitted as "\\r" + the whole
    current hypothesis (clients replace the line)."""

    def __init__(self, labels, blank: int, *, beam_width: int = 16,
                 lm=None, alpha: float = 0.5, beta: float = 1.5):
        from vietasr_tpu_torch.ops.beam_search import StreamingPrefixBeam

        self._dec = StreamingPrefixBeam(labels, beam_width=beam_width,
                                        lm=lm, alpha=alpha, beta=beta)
        self._emitted = ""

    def feed(self, log_probs: np.ndarray) -> str:
        self._dec.feed(np.asarray(log_probs))
        cur = self._dec.best()
        piece = _diff(self._emitted, cur)
        self._emitted = cur
        return piece

    @property
    def text(self) -> str:
        return self._dec.best()


def _diff(prev: str, cur: str) -> str:
    """The wire piece that turns line `prev` into `cur`: the appended
    text, "" when equal, or "\\r" + cur on a revision."""
    if cur == prev:
        return ""
    if cur.startswith(prev):
        return cur[len(prev):]
    return "\r" + cur


class StreamPool:
    """A fixed pool of streaming slots advanced by one batched step."""

    def __init__(self, transcriber: OnlineTranscriber, *, slots: int = 8,
                 chunk_samples: int = 3200, decoder: str = "greedy",
                 lm_path: Optional[str] = None, beam_width: int = 16,
                 lm_alpha: float = 0.5, lm_beta: float = 1.5,
                 wire_encoding: str = "ulaw", beam_impl: str = "auto"):
        if wire_encoding not in ("ulaw", "alaw"):
            raise ValueError("wire_encoding must be 'ulaw' or 'alaw'")
        if decoder not in ("greedy", "beam", "beam_host"):
            raise ValueError(f"unknown decoder {decoder!r}")
        self.wire_encoding = wire_encoding   # the law of uint8 chunks
        self.ot = transcriber
        self.device = transcriber.device
        self.slots = slots
        # a chunked-causal encoder consumes a fixed attention chunk
        self.chunk_samples = getattr(transcriber, "required_chunk_samples",
                                     None) or chunk_samples
        # rows on their first chunk run with the encoder frozen
        self._skip_first = bool(getattr(transcriber, "skip_first_step",
                                        False))
        labels = transcriber.cfg.labels
        if decoder == "beam" and lm_path and " " not in labels:
            # word-LM fusion needs a separator label; without one only the
            # host prefix beam (which scores the trailing partial) applies
            decoder = "beam_host"
        self.decoder_kind = decoder
        self._lm = None
        if decoder == "beam_host" and lm_path:
            from vietasr_tpu_torch.ops.lm import NGramLM

            self._lm = NGramLM(lm_path)
        self._beam_kw = dict(beam_width=beam_width, lm=self._lm,
                             alpha=lm_alpha, beta=lm_beta)
        self._dsb = None
        if decoder == "beam":
            from vietasr_tpu_torch.ops.device_beam import word_lm_to_device
            from vietasr_tpu_torch.ops.lm import load_lm, word_lm_tables
            from vietasr_tpu_torch.ops.streaming_beam import \
                DeviceStreamingBeam

            word_lm, wlm_probes = None, 8
            if lm_path:
                tables, wlm_probes = word_lm_tables(load_lm(lm_path), labels)
                word_lm = word_lm_to_device(tables, self.device)
            self._dsb = DeviceStreamingBeam(
                blank=transcriber.cfg.num_classes, beam_width=beam_width,
                space=labels.index(" ") if " " in labels else -1,
                cutoff_top_n=8, word_lm=word_lm, alpha=lm_alpha,
                beta=lm_beta, wlm_probes=wlm_probes,
                skip_frames=transcriber.prefix_frames, impl=beam_impl,
                device=self.device)
            self.beam_carry = self._dsb.init(slots)
            self._emitted: Dict[int, str] = {}
        self.states = transcriber.init_state(slots)
        self._fresh = transcriber.init_state(slots)
        self.decoders: Dict[int, object] = {}
        self.skip: Dict[int, int] = {}
        self._free = list(range(slots))
        self._virgin = set()                 # slots awaiting a first chunk
        self._lock = threading.Lock()

    def _rows(self, slots) -> torch.Tensor:
        mask = np.zeros((self.slots,), bool)
        mask[list(slots)] = True
        return torch.from_numpy(mask).to(self.device)

    def open(self) -> Optional[int]:
        """Claim a slot for a new stream; None if the pool is full."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            rows = self._rows([slot])
            self.states = self._fresh.where(rows, self.states)
            self._virgin.add(slot)
            labels, blank = self.ot.cfg.labels, self.ot.cfg.num_classes
            if self.decoder_kind == "beam":
                self.beam_carry = self._dsb.reset_rows(self.beam_carry, rows)
                self._emitted[slot] = ""
            elif self.decoder_kind == "beam_host":
                self.decoders[slot] = IncrementalBeam(labels, blank,
                                                      **self._beam_kw)
                self.skip[slot] = self.ot.prefix_frames
            else:
                self.decoders[slot] = IncrementalGreedy(labels, blank)
                self.skip[slot] = self.ot.prefix_frames
        return slot

    def close(self, slot: int) -> str:
        """Release a slot; returns its final transcript."""
        if self.decoder_kind == "beam":
            text = self._emitted.get(slot, "")
        else:
            text = self.decoders[slot].text if slot in self.decoders else ""
        with self._lock:
            self.decoders.pop(slot, None)
            self.skip.pop(slot, None)
            if self.decoder_kind == "beam":
                self._emitted.pop(slot, None)
            self._free.append(slot)
        return text

    def flush(self, slot: int, *, return_pieces: bool = False,
              tail_done: bool = False):
        """Drain the model's lookahead after a stream's last chunk: one
        tail step (the offline featurizer's end reflect padding, made from
        the slot's audio carry) unless `tail_done` (the caller fed the last
        chunk with tail_slots / tail_real), then pad steps on zero features
        until every real frame is out. Returns the text that surfaced, or
        with return_pieces the per-chunk wire pieces."""
        frames_per_chunk = self.ot.out_frames(self.chunk_samples)
        silence = np.zeros(self.chunk_samples, np.float32)
        emitted = []
        if not tail_done:
            emitted.append(self.feed({slot: silence},
                                     tail_slots=(slot,))[slot])
        for _ in range(self.ot.prefix_frames // max(frames_per_chunk, 1)
                       + 1):
            emitted.append(self.feed({slot: silence},
                                     pad_slots=(slot,))[slot])
        return emitted if return_pieces else "".join(emitted)

    def _batch(self, inputs: Dict[int, np.ndarray]):
        """(wire batch (slots, chunk_samples), fed mask): all fed chunks
        in one wire dtype (uint8 G.711, int16 PCM), else float32 with the
        others converted on the host."""
        arrs = {s: np.asarray(c) for s, c in inputs.items()}
        u8 = bool(arrs) and all(a.dtype == np.uint8 for a in arrs.values())
        i16 = bool(arrs) and all(a.dtype == np.int16 for a in arrs.values())
        wire = np.uint8 if u8 else np.int16 if i16 else np.float32
        batch = np.zeros((self.slots, self.chunk_samples), wire)
        if u8:                                   # the law's code for 0
            batch[:] = 0xFF if self.wire_encoding == "ulaw" else 0xD5
        for slot, chunk in arrs.items():
            if chunk.dtype == np.uint8 and not u8:
                from vietasr_tpu_torch.audio.g711 import (alaw_decode,
                                                          ulaw_decode)

                dec = alaw_decode if self.wire_encoding == "alaw" \
                    else ulaw_decode
                chunk = dec(chunk).astype(np.float32) / 32768.0
            if chunk.dtype == np.int16 and not i16:
                chunk = chunk.astype(np.float32) / 32768.0
            if chunk.dtype not in (np.int16, np.uint8):
                assert_waveform(chunk, port="stream.chunk")
            if len(chunk) != self.chunk_samples:
                raise ValueError(
                    f"chunk must be exactly {self.chunk_samples} samples")
            batch[slot] = chunk
        return batch

    @torch.inference_mode()
    def _tick(self, batch, fed, pad, tail, treal, virgin):
        """One step of every slot; commits the fed rows. Returns the
        step's (slots, T, V + 1) log-probs."""
        x = decode_wire(torch.from_numpy(batch).to(self.device),
                        self.wire_encoding)
        # fresh slots: the audio carry reflect-filled from their first
        # chunk, so boundary frames and the running stats they seed match
        # the offline featurizer
        states = self.ot.seed_carry(self.states, x).where(virgin,
                                                          self.states)
        kw = {"enc_skip": virgin} if self._skip_first else {}
        new_states, lp = self.ot.step(states, x, pad, tail, treal, **kw)
        self.states = new_states.where(fed, states)
        return lp

    def feed(self, inputs: Dict[int, np.ndarray], pad_slots=(),
             tail_slots=(), tail_real=None) -> Dict[int, str]:
        """Advance the fed slots one chunk: `inputs` maps slot -> a chunk
        of exactly chunk_samples (float waveform in [-1, 1], int16 PCM or
        uint8 G.711 in `wire_encoding`). `pad_slots`: slots whose chunk is
        a flush pad (zero features, featurizer frozen); `tail_slots` and
        `tail_real` (slot -> real samples in the chunk): the end-reflect
        step at a stream's true end. Thread-safe. Returns the new wire
        piece of each fed slot."""
        batch = self._batch(inputs)
        treal = np.zeros((self.slots,), np.int64)
        for slot, r in (tail_real or {}).items():
            treal[slot] = r
        dev = self.device
        with self._lock:
            virgin = [s for s in inputs if s in self._virgin
                      and s not in pad_slots]
            self._virgin.difference_update(virgin)
            lp = self._tick(batch, self._rows(inputs), self._rows(pad_slots),
                            self._rows(tail_slots),
                            torch.from_numpy(treal).to(dev),
                            self._rows(virgin))
            if self.decoder_kind == "beam":
                return self._beam_pieces(inputs, lp)
            lp = lp.cpu().numpy()
            out: Dict[int, str] = {}
            for slot in inputs:
                frames = lp[slot]
                drop = min(self.skip.get(slot, 0), len(frames))
                if drop:
                    self.skip[slot] -= drop
                    frames = frames[drop:]
                out[slot] = self.decoders[slot].feed(frames) \
                    if len(frames) else ""
        return out

    def _beam_pieces(self, inputs, lp) -> Dict[int, str]:
        """The device beam's chunk over every slot, committed where fed;
        each fed slot's best hypothesis comes back in one copy, and the
        host only diffs strings for the wire protocol."""
        fed = self._rows(inputs)
        with torch.inference_mode():
            carry, best_ids, best_len = self._dsb.chunk(self.beam_carry, lp)
            from vietasr_tpu_torch.ops.streaming_beam import commit_rows

            self.beam_carry = commit_rows(fed, carry, self.beam_carry)
            packed = torch.cat([best_len[:, None], best_ids], 1).cpu().numpy()
        labels = self.ot.cfg.labels
        out = {}
        for slot in inputs:
            cur = self._dsb.render(labels, packed[slot, 1:],
                                   int(packed[slot, 0]))
            out[slot] = _diff(self._emitted.get(slot, ""), cur)
            self._emitted[slot] = cur
        return out
