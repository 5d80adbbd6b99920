"""CTC prefix beam search with n-gram LM shallow fusion on the host (the
port's copy of vietasr_tpu/ops/beam_search.py, numpy only).

The reference decodes with pyctcdecode + KenLM on the CPU, one utterance
at a time (its beam_search_decoder.py:14-102). Two tiers here, on the
host:

1. `prefix_beam_search` / `StreamingPrefixBeam`: the log-space prefix
   beam search in Python with word-level LM fusion (score = log p_ctc +
   alpha * log p_lm + beta per word).
2. `CtcBeamNative` (vietasr_tpu_torch.native): the same algorithm in C++,
   through ctypes, with the reference's pruning (cutoff_top_n, a beam
   floor).

`BeamSearchDecoderLM` is the batch facade `Transcriber(decoder="beam")`
uses. The device tier is ops/device_beam.py.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vietasr_tpu_torch.ops.kenlm_binary import is_kenlm_binary
from vietasr_tpu_torch.ops.lm import NGramLM, load_lm, write_arpa
from vietasr_tpu_torch.utils.typing import ContractError

NEG_INF = -math.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


@dataclass
class _Beam:
    words: Tuple[str, ...] = ()
    partial: str = ""
    last_char: int = -1
    p_b: float = 0.0            # log prob of prefix ending in blank
    p_nb: float = NEG_INF       # log prob of prefix ending in non-blank
    lm_score: float = 0.0       # accumulated alpha*logp + beta bonuses

    def total(self) -> float:
        return _logsumexp2(self.p_b, self.p_nb) + self.lm_score

    def key(self):
        return (self.words, self.partial, self.last_char)


class StreamingPrefixBeam:
    """Stateful prefix beam search: feed log-prob chunks as they arrive,
    read the current best hypothesis at any point. `prefix_beam_search`
    (the whole-utterance oracle) is feed-everything + best()."""

    def __init__(self, labels: Sequence[str], *, beam_width: int = 100,
                 lm: Optional[NGramLM] = None, alpha: float = 0.5,
                 beta: float = 1.5, token_min_logp: float = -10.0,
                 space: str = " "):
        self.labels = list(labels)
        self.beam_width = beam_width
        self.lm = lm
        self.alpha = alpha
        self.beta = beta
        self.token_min_logp = token_min_logp
        self.space_id = self.labels.index(space) if space in self.labels \
            else -1
        self.beams: Dict[tuple, _Beam] = {b.key(): b for b in [_Beam()]}

    def _lm_word_score(self, words: Tuple[str, ...], w: str) -> float:
        if self.lm is None or not w:
            return 0.0
        return self.alpha * self.lm.log_prob(w, words) + self.beta

    def feed(self, log_probs: np.ndarray) -> None:
        """Advance over (T, V+1) new frames (blank = last column)."""
        v = log_probs.shape[1]
        blank = v - 1
        for t in range(log_probs.shape[0]):
            lp = log_probs[t]
            # token pruning: always keep blank
            cand = [c for c in range(v)
                    if lp[c] >= self.token_min_logp or c == blank]
            next_beams: Dict[tuple, _Beam] = {}

            def bump(key, words, partial, last_char, lm_score, *,
                     add_b=NEG_INF, add_nb=NEG_INF):
                nb = next_beams.get(key)
                if nb is None:
                    nb = _Beam(words=words, partial=partial,
                               last_char=last_char, p_b=NEG_INF,
                               p_nb=NEG_INF, lm_score=lm_score)
                    next_beams[key] = nb
                nb.p_b = _logsumexp2(nb.p_b, add_b)
                nb.p_nb = _logsumexp2(nb.p_nb, add_nb)

            for beam in self.beams.values():
                p_tot = _logsumexp2(beam.p_b, beam.p_nb)
                for c in cand:
                    p_c = float(lp[c])
                    if c == blank:
                        bump(beam.key(), beam.words, beam.partial,
                             beam.last_char, beam.lm_score,
                             add_b=p_tot + p_c)
                        continue
                    ch = self.labels[c]
                    if c == beam.last_char:
                        # repeat: extends p_nb of same prefix
                        bump(beam.key(), beam.words, beam.partial,
                             beam.last_char, beam.lm_score,
                             add_nb=beam.p_nb + p_c)
                        # after a blank: genuinely new char (doubled letter)
                        new = _extend(beam, c, ch, self.space_id,
                                      self._lm_word_score)
                        bump(new.key(), new.words, new.partial,
                             new.last_char, new.lm_score,
                             add_nb=beam.p_b + p_c)
                    else:
                        new = _extend(beam, c, ch, self.space_id,
                                      self._lm_word_score)
                        bump(new.key(), new.words, new.partial,
                             new.last_char, new.lm_score,
                             add_nb=p_tot + p_c)

            ranked = sorted(next_beams.values(), key=_Beam.total,
                            reverse=True)
            self.beams = {b.key(): b for b in ranked[:self.beam_width]}

    def best(self) -> str:
        """Current best hypothesis (trailing partial word LM-scored)."""
        best, best_score = None, NEG_INF
        for b in self.beams.values():
            score = _logsumexp2(b.p_b, b.p_nb) + b.lm_score \
                + self._lm_word_score(b.words, b.partial)
            if score > best_score:
                best, best_score = b, score
        if best is None:
            return ""
        text = " ".join(best.words)
        if best.partial:
            text = (text + " " + best.partial) if text else best.partial
        return text


def prefix_beam_search(
    log_probs: np.ndarray,
    labels: Sequence[str],
    *,
    beam_width: int = 100,
    lm: Optional[NGramLM] = None,
    alpha: float = 0.5,
    beta: float = 1.5,
    token_min_logp: float = -10.0,
    space: str = " ",
) -> str:
    """Decode one utterance. log_probs: (T, V+1), blank = V (last column).

    LM fusion at word boundaries: when a space completes a word w after
    context ctx, the beam score gains alpha * ln p_lm(w | ctx) + beta; the
    trailing partial word is scored the same way at the end (the shallow-
    fusion scheme of the Baidu/DeepSpeech decoder the reference uses).
    """
    dec = StreamingPrefixBeam(labels, beam_width=beam_width, lm=lm,
                              alpha=alpha, beta=beta,
                              token_min_logp=token_min_logp, space=space)
    dec.feed(log_probs)
    return dec.best()


def _extend(beam: _Beam, c: int, ch: str, space_id: int, lm_word_score):
    if c == space_id:
        if beam.partial:
            return _Beam(words=beam.words + (beam.partial,), partial="",
                         last_char=c, p_b=NEG_INF, p_nb=NEG_INF,
                         lm_score=beam.lm_score
                         + lm_word_score(beam.words, beam.partial))
        return _Beam(words=beam.words, partial="", last_char=c,
                     p_b=NEG_INF, p_nb=NEG_INF, lm_score=beam.lm_score)
    return _Beam(words=beam.words, partial=beam.partial + ch, last_char=c,
                 p_b=NEG_INF, p_nb=NEG_INF, lm_score=beam.lm_score)


class BeamSearchDecoderLM:
    """Batch decoder facade over the C++ tier (`use_native=True`, the
    default) or the Python tier (`use_native=False`). The native library
    is built at first use; a build or load failure raises, with no quiet
    fallback to the Python tier. `lm_path` is an ARPA file or a KenLM
    `.binary`: the C++ tier parses ARPA text, so a binary is rebuilt
    (ops/lm.py:load_lm), spilled to a temporary ARPA file for the C++ LM
    to read, and the spill is deleted once it has been read."""

    def __init__(self, labels: Sequence[str], *, lm_path: Optional[str] = None,
                 alpha: float = 0.5, beta: float = 1.5,
                 beam_width: int = 100, use_native: bool = True):
        self.labels = list(labels)
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width
        self.lm = load_lm(lm_path) if lm_path else None
        self._native = None
        if use_native:
            from vietasr_tpu_torch.native import CtcBeamNative

            if lm_path and is_kenlm_binary(lm_path):
                fd, spill = tempfile.mkstemp(suffix=".arpa")
                os.close(fd)
                try:
                    write_arpa(self.lm, spill)
                    self._native = CtcBeamNative(self.labels, lm_path=spill,
                                                 alpha=alpha, beta=beta)
                finally:
                    os.unlink(spill)
            else:
                self._native = CtcBeamNative(self.labels, lm_path=lm_path,
                                             alpha=alpha, beta=beta)

    def decode(self, log_probs: np.ndarray,
               length: Optional[int] = None) -> str:
        if log_probs.ndim != 2 or log_probs.shape[1] != len(self.labels) + 1:
            raise ContractError(
                "port 'beam.decode.log_probs': expected (T, "
                f"{len(self.labels) + 1}) with blank last, got shape "
                f"{tuple(log_probs.shape)}")
        lp = log_probs[:length] if length is not None else log_probs
        if lp.shape[0] == 0:
            return ""
        if self._native is not None:
            return self._native.decode(np.ascontiguousarray(lp, np.float32),
                                       self.beam_width)
        return prefix_beam_search(lp, self.labels, beam_width=self.beam_width,
                                  lm=self.lm, alpha=self.alpha,
                                  beta=self.beta)

    def decode_batch(self, log_probs: np.ndarray,
                     lengths: np.ndarray) -> List[str]:
        return [self.decode(log_probs[i], int(lengths[i]))
                for i in range(log_probs.shape[0])]
