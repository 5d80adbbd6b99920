"""n-gram language model: ARPA reader + Katz backoff scorer, and the tables
the on-device beam search fuses (counterpart of vietasr_tpu/ops/lm.py).

numpy only. Scores are natural-log (converted from ARPA log10).

- `NGramLM`: pure-Python backoff scorer over an ARPA file (`.gz` too).
- `train_ngram_arpa` / `write_arpa`: estimate / serialize a small LM.
- `char_lm_table`: a CHAR-level LM densified into a ((V+1)^(order-1), V)
  table of fully backed-off log-probs (one row gather per beam step).
- `word_lm_tables`: a WORD-level LM (order <= 5) as hashed open-addressing
  tables (ops/device_beam.py probes them). The hashing is uint32
  wraparound arithmetic, done here with Python ints masked to 32 bits, and
  matches the device side bit for bit.

`load_lm` also reads KenLM `.binary` files (PROBING, TRIE and QUANT_TRIE:
ops/kenlm_binary.py, ops/kenlm_trie.py), rebuilt into an `NGramLM`, so the
device tables and the host beam tier take them as they take an ARPA.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

LOG10 = math.log(10.0)
UNK = "<unk>"
BOS = "<s>"
EOS = "</s>"
SPACE_TOKEN = "<sp>"   # char-level LMs can't store a literal " " in ARPA


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def load_lm(path: str) -> "NGramLM":
    """Load an n-gram LM from an ARPA text file (optionally gzipped) or a
    KenLM `.binary` (sniffed by magic, like kenlm's own loader; PROBING,
    TRIE or QUANT_TRIE by its header), a binary rebuilt into the explicit
    word-keyed form so that every consumer works unchanged. The scorers
    `KenLMBinary` / `KenLMTrie` score a binary too large to rebuild."""
    # imported here: ops/kenlm_binary.py imports this module
    from vietasr_tpu_torch.ops.kenlm_binary import (is_kenlm_binary,
                                                    read_kenlm_binary)

    if is_kenlm_binary(path):
        return read_kenlm_binary(path).to_ngram_lm()
    return NGramLM(path)


class NGramLM:
    """Katz-backoff n-gram LM over an ARPA file.

    p(w | ctx) = p_exact(ctx + w)              if the n-gram exists
               = backoff(ctx) + p(w | ctx[1:])  otherwise
    """

    def __init__(self, path: str):
        self.ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.order = 0
        self.vocab: List[str] = []
        self._parse(path)
        self.has_unk = (UNK,) in self.ngrams

    def _parse(self, path: str):
        section = None
        with _open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "grams:" in line:
                    section = int(line[1:].split("-")[0])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\") or line.startswith("ngram") \
                        or line == "\\data\\":
                    if line == "\\end\\":
                        break
                    continue
                if section is None:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    logp = float(parts[0])
                    words = tuple(parts[1 : 1 + section])
                    backoff = float(parts[1 + section]) \
                        if len(parts) > 1 + section else 0.0
                else:
                    logp = float(parts[0])
                    words = tuple(parts[1].split())
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.ngrams[words] = (logp * LOG10, backoff * LOG10)
                if section == 1:
                    self.vocab.append(words[0])

    def log_prob(self, word: str, context: Sequence[str] = ()) -> float:
        """Natural-log p(word | context) with backoff; OOV gets <unk> score
        or -inf-ish floor. A literal " " token aliases to <sp> (char LMs)."""
        if word == " ":
            word = SPACE_TOKEN
        context = tuple(SPACE_TOKEN if w == " " else w for w in context)
        context = context[-(self.order - 1):] if self.order > 1 else ()
        return self._score(context + (word,))

    def _score(self, ngram: Tuple[str, ...]) -> float:
        if ngram in self.ngrams:
            return self.ngrams[ngram][0]
        if len(ngram) == 1:
            if self.has_unk:
                return self.ngrams[(UNK,)][0]
            return -1e30 / 2  # truly unknown token, no <unk> entry
        context = ngram[:-1]
        bo = self.ngrams[context][1] if context in self.ngrams else 0.0
        return bo + self._score(ngram[1:])

    def score_sentence(self, words: Sequence[str], *, bos: bool = True,
                       eos: bool = True) -> float:
        """Sum of conditional log-probs (natural log)."""
        context: Tuple[str, ...] = (BOS,) if bos else ()
        total = 0.0
        seq = list(words) + ([EOS] if eos else [])
        for w in seq:
            total += self.log_prob(w, context)
            context = context + (w,)
        return total


# ---------------------------------------------------------------------------
# training a small LM


def train_ngram_arpa(corpus_lines: Sequence[str], out_path: str, *,
                     order: int = 3, discount: float = 0.5,
                     char_level: bool = False) -> None:
    """Estimate an absolute-discounting backoff LM and write ARPA (valid,
    well-formed, kenlm/pyctcdecode compatible; not modified Kneser-Ney)."""
    counts: List[Dict[Tuple[str, ...], int]] = [dict() for _ in range(order)]
    for line in corpus_lines:
        if char_level:
            toks = [SPACE_TOKEN if ch == " " else ch
                    for ch in line.strip()]
        else:
            toks = line.split()
        if not toks:
            continue
        seq = [BOS] + toks + [EOS]
        for n in range(1, order + 1):
            for i in range(len(seq) - n + 1):
                g = tuple(seq[i : i + n])
                if n == 1 and g == (BOS,):
                    continue    # ARPA convention: <s> has prob only as context
                counts[n - 1][g] = counts[n - 1].get(g, 0) + 1

    probs: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]
    backoffs: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]

    total_uni = sum(counts[0].values())
    n_types = len(counts[0]) + 1
    for g, c in counts[0].items():
        probs[0][g] = math.log10(max(c - discount, 1e-12) / total_uni)
    probs[0][(UNK,)] = math.log10(discount * len(counts[0]) / total_uni
                                  / n_types)
    probs[0][(BOS,)] = -99.0     # convention: <s> never predicted

    for n in range(2, order + 1):
        ctx_totals: Dict[Tuple[str, ...], int] = {}
        ctx_types: Dict[Tuple[str, ...], int] = {}
        for g, c in counts[n - 1].items():
            ctx = g[:-1]
            ctx_totals[ctx] = ctx_totals.get(ctx, 0) + c
            ctx_types[ctx] = ctx_types.get(ctx, 0) + 1
        for g, c in counts[n - 1].items():
            ctx = g[:-1]
            probs[n - 1][g] = math.log10(
                max(c - discount, 1e-12) / ctx_totals[ctx])
        # backoff mass per context
        for ctx, total in ctx_totals.items():
            mass = discount * ctx_types[ctx] / total
            # denominator: 1 - sum of lower-order probs of seen continuations
            seen = [g[-1] for g in counts[n - 1] if g[:-1] == ctx]
            lower = sum(10 ** probs[n - 2].get(tuple(ctx[1:]) + (w,),
                                               probs[0].get((w,), -99))
                        for w in seen) if n > 2 else \
                sum(10 ** probs[0].get((w,), -99) for w in seen)
            denom = max(1.0 - lower, 1e-12)
            backoffs[n - 2][ctx] = math.log10(max(mass / denom, 1e-12))

    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n in range(1, order + 1):
            f.write(f"ngram {n}={len(probs[n-1])}\n")
        f.write("\n")
        for n in range(1, order + 1):
            f.write(f"\\{n}-grams:\n")
            for g in sorted(probs[n - 1]):
                lp = probs[n - 1][g]
                bo = backoffs[n - 1].get(g) if n < order else None
                if bo is not None:
                    f.write(f"{lp:.6f}\t{' '.join(g)}\t{bo:.6f}\n")
                else:
                    f.write(f"{lp:.6f}\t{' '.join(g)}\n")
            f.write("\n")
        f.write("\\end\\\n")


def write_arpa(lm: "NGramLM", out_path: str) -> None:
    """Serialize an NGramLM (natural-log internal) back to ARPA (log10)."""
    by_order: List[List[Tuple[Tuple[str, ...], float, float]]] = \
        [[] for _ in range(lm.order)]
    for g, (lp, bo) in lm.ngrams.items():
        by_order[len(g) - 1].append((g, lp / LOG10, bo / LOG10))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n in range(1, lm.order + 1):
            f.write(f"ngram {n}={len(by_order[n - 1])}\n")
        f.write("\n")
        for n in range(1, lm.order + 1):
            f.write(f"\\{n}-grams:\n")
            for g, lp, bo in sorted(by_order[n - 1]):
                if n < lm.order:
                    f.write(f"{lp:.7f}\t{' '.join(g)}\t{bo:.7f}\n")
                else:
                    f.write(f"{lp:.7f}\t{' '.join(g)}\n")
            f.write("\n")
        f.write("\\end\\\n")


# ---------------------------------------------------------------------------
# tables for on-device fusion


def char_lm_table(lm: NGramLM, labels: Sequence[str]) -> np.ndarray:
    """Densify a CHAR-level n-gram LM into a ((V+1)^(order-1), V) float32
    table of conditional natural-log-probs with all backoff applied.

    Row index encodes the char context in base (V+1), oldest digit first,
    digit 0 = "no char yet" (prefix shorter than the context window);
    column j = log p(labels[j] | context)."""
    v = len(labels)
    n_ctx = max(lm.order - 1, 1)
    rows = (v + 1) ** n_ctx
    table = np.zeros((rows, v), np.float32)
    for row in range(rows):
        digits = []
        r = row
        for _ in range(n_ctx):
            digits.append(r % (v + 1))
            r //= (v + 1)
        digits.reverse()            # most-recent char is the LAST digit
        ctx = tuple(labels[d - 1] for d in digits if d > 0)
        for j, ch in enumerate(labels):
            table[row, j] = lm.log_prob(ch, ctx)
    return table


def word_lm_tables(lm: NGramLM, labels: Sequence[str]):
    """Densify a WORD-level n-gram LM (order <= 5) into hashed
    open-addressing tables for on-device shallow fusion.

    Each n-gram is keyed by two independent 32-bit hash lanes folded over
    its words' rolling hashes; a word is hashed as fold(h*P + (id+1)) over
    its chars' label indices, as the beam emits them. Words with chars
    outside `labels` can never be produced and are skipped. Returns
    (WordLMTables of numpy arrays, probes), `probes` being the worst
    linear-probe displacement; ops/device_beam.py:word_lm_to_device moves
    the tables to a device."""
    from vietasr_tpu_torch.ops.device_beam import MAX_WLM_ORDER, WordLMTables

    if lm.order > MAX_WLM_ORDER:
        raise ValueError(
            f"on-device word LM supports order <= {MAX_WLM_ORDER}; "
            f"got order {lm.order} (truncate the ARPA)")
    n_levels = max(lm.order, 1)
    # plain-int arithmetic masked to 32 bits == the device's uint32
    # wraparound (numpy >= 2 warns on scalar overflow, so avoid np.uint32)
    M32 = 0xFFFFFFFF
    P1, P2 = 1000003, 69069
    Q1, Q2 = 2654435761, 40503
    MIX = 0x9E3779B9
    char_id = {ch: i for i, ch in enumerate(labels)
               if isinstance(ch, str) and len(ch) == 1}

    def word_hash(word: str):
        h1 = 0
        h2 = 0
        for ch in word:
            if ch not in char_id:
                return None
            cplus = char_id[ch] + 1
            h1 = (h1 * P1 + cplus) & M32
            h2 = (h2 * P2 + cplus) & M32
        return h1, h2

    def ngram_key(words: Tuple[str, ...]):
        k1 = 1
        k2 = 1
        for wd in words:
            wh = word_hash(wd)
            if wh is None:
                return None
            k1 = (k1 * Q1 + wh[0]) & M32
            k2 = (k2 * Q2 + wh[1]) & M32
        if k1 == 0:
            k1 = 1   # 0 is the empty-slot marker
        return k1, k2

    levels: List[List[Tuple[int, int, float, float]]] = \
        [[] for _ in range(n_levels)]
    for g, (logp, bo) in lm.ngrams.items():
        if any(wd in (BOS, EOS, UNK) for wd in g):
            continue
        key = ngram_key(g)
        if key is None:
            continue
        levels[len(g) - 1].append((key[0], key[1], logp, bo))

    max_probes = 1

    def build(entries):
        nonlocal max_probes
        size = 1
        while size < max(2 * len(entries), 2):
            size *= 2
        k1 = np.zeros(size, np.uint32)
        k2 = np.zeros(size, np.uint32)
        val = np.zeros(size, np.float32)
        bo = np.zeros(size, np.float32)
        mask = size - 1
        for e1, e2, lp, b in entries:
            idx = (e1 ^ ((e2 * MIX) & M32)) & mask
            d = 0
            while k1[idx] != 0:
                if k1[idx] == e1 and k2[idx] == e2:
                    break       # duplicate n-gram (last write wins)
                idx = (idx + 1) % size
                d += 1
            k1[idx] = e1
            k2[idx] = e2
            val[idx] = lp
            bo[idx] = b
            max_probes = max(max_probes, d + 1)
        return k1, k2, val, bo

    built = [build(entries) for entries in levels]
    # every level interleaved into one (N, 4) uint32 array:
    # [key1, key2, logp_bits, backoff_bits]
    packed = np.concatenate([
        np.stack([k1, k2,
                  val.view(np.uint32), bo.view(np.uint32)], axis=1)
        for (k1, k2, val, bo) in built])
    sizes = [b[0].shape[0] for b in built]
    unk = lm.ngrams[(UNK,)][0] if lm.has_unk else -5e29
    tables = WordLMTables(
        packed=packed,
        masks=np.asarray([s - 1 for s in sizes], np.uint32),
        bases=np.asarray(np.cumsum([0] + sizes[:-1]), np.uint32),
        unk_logp=np.float32(unk))
    return tables, max_probes


def context_row_index(context_ids: Sequence[int], v: int, n_ctx: int) -> int:
    """Row index for char_lm_table given the last n_ctx label ids."""
    padded = [-1] * max(n_ctx - len(context_ids), 0) + \
        list(context_ids)[-n_ctx:]
    row = 0
    for d in padded:
        row = row * (v + 1) + (d + 1)
    return row
