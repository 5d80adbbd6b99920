"""KenLM PROBING `.binary` format: reader + writer (the port's copy of
vietasr_tpu/ops/kenlm_binary.py, numpy only).

The reference ships its production LMs as KenLM binaries (3/4/5-gram
models, loaded by its beam_search_decoder.py:82-87 through
pyctcdecode/kenlm). This module reads and writes them:

- `read_kenlm_binary(path)` -> a `KenLMBinary` scorer (hash-probe lookups,
  Katz backoff identical to ops/lm.py:NGramLM._score), or a `KenLMTrie`
  (ops/kenlm_trie.py) for the TRIE family.
- `KenLMBinary.to_ngram_lm()` rebuilds an explicit `NGramLM`, so every
  consumer (the device word/char LM tables of ops/lm.py, the C++ host tier
  of native/ctc_beam.cc through an ARPA spill, the Python beam search)
  works on a `.binary` unchanged.
- `write_kenlm_binary(arpa_or_lm, path)` compiles an ARPA model to the
  probing binary (what kenlm's `build_binary` does); the tests make their
  fixtures with it.
- `is_kenlm_binary(path)` sniffs the magic (ops/lm.py:load_lm routes on it).

Format (implemented from KenLM's published layout; kenlm itself is not a
dependency, so the writer makes the fixtures and the reader is validated
by round-trip score equality against the ARPA scorer):

  [Sanity]                  lm/binary_format.cc struct Sanity
    char  magic[56]         kMagicBytes = "mmap lm http://kheafield.com/
                            code format version 5\\n\\0", zero-padded to 8B
    f32   zero=0, one=1, minus_half=-0.5     (float byte-order check)
    u32   one_word_index=1, max_word_index=0xFFFFFFFF
    u64   one_uint64=1
    (struct 8-aligned -> 88 bytes)
  [FixedWidthParameters]    lm/binary_format.hh
    u8    order  (3B pad)
    f32   probing_multiplier
    i32   model_type         0 = PROBING (this module); 2/3 = TRIE /
                             QUANT_TRIE (ops/kenlm_trie.py)
    u8    has_vocabulary (3B pad)
    u32   search_version
  [u64 counts[order]]        n-grams per order; header ALIGN8
  [Vocabulary]               lm/vocab.cc ProbingVocabulary
    u64   bound              highest word id + 1
    buckets(counts[0]) x {u64 murmur64a(word,seed=0); u32 id; u32 pad}
  [Unigrams]                 lm/search_hashed.hh Unigram
    (bound + 1) x {f32 prob; f32 backoff}     indexed directly by word id
  [Middle tables, orders 2..order-1]          util/probing_hash_table.hh
    buckets(counts[n-1]) x {u64 key; f32 prob; f32 backoff}
  [Longest table, order n]
    buckets(counts[order-1]) x {u64 key; f32 prob}   12-byte packed
  [Vocab strings]            if has_vocabulary: words NUL-separated in
                             word-id order ("<unk>\\0<s>\\0</s>\\0...")

  buckets(n) = max(n + 1, ceil(probing_multiplier * n)); empty slot key 0;
  insertion at key % buckets with linear probing (IdentityHash — vocab
  keys are already murmur hashes). N-gram keys chain word ids:
      h = id[0];  h = h * 8978948897894561157 + id[i]   (u64 wraparound)
  (lm/search_hashed.cc detail::CombineWordHash). Probabilities/backoffs
  are stored as the ARPA's log10 floats.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vietasr_tpu_torch.ops.lm import BOS, EOS, LOG10, UNK, NGramLM

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
MAGIC_PAD = (len(MAGIC) + 7) // 8 * 8          # 56
SANITY_SIZE = (MAGIC_PAD + 12 + 8 + 8 + 7) // 8 * 8   # 88
FIXED_FMT = "<B3xfi B3x I"                      # order, mult, type, vocab?, ver
FIXED_SIZE = struct.calcsize(FIXED_FMT)         # 20
MODEL_PROBING = 0
MODEL_TRIE = 2            # lm/model_type.hh: TRIE
MODEL_QUANT_TRIE = 3      #                   QUANT_TRIE
COMBINE = np.uint64(8978948897894561157)
M64 = 0xFFFFFFFFFFFFFFFF


def _align8(n: int) -> int:
    return (n + 7) // 8 * 8


def _buckets(entries: int, multiplier: float) -> int:
    return max(entries + 1, int(math.ceil(multiplier * entries)))


def murmur64a(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A (the kenlm vocabulary hash, util/murmur_hash.cc)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ (len(data) * m)) & M64
    n8 = len(data) // 8 * 8
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i : i + 8], "little")
        k = (k * m) & M64
        k ^= k >> r
        k = (k * m) & M64
        h = ((h ^ k) * m) & M64
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & M64
    h ^= h >> r
    h = (h * m) & M64
    h ^= h >> r
    return h


def _chain_hash_np(ids: np.ndarray) -> np.ndarray:
    """Chained n-gram key over word-id columns (..., order) -> (...,) u64."""
    ids = ids.astype(np.uint64)
    h = ids[..., 0]
    with np.errstate(over="ignore"):
        for i in range(1, ids.shape[-1]):
            h = h * COMBINE + ids[..., i]
    return h


def _probe_insert(keys: np.ndarray, table_keys: np.ndarray) -> np.ndarray:
    """Linear-probe insertion slots for `keys` into a table of
    `len(table_keys)` buckets (key 0 = empty). Returns slot indices and
    fills table_keys in place."""
    n = len(table_keys)
    slots = np.empty(len(keys), np.int64)
    for j, k in enumerate(keys):
        idx = int(k % n)
        while table_keys[idx] != 0:
            idx = (idx + 1) % n
        table_keys[idx] = k
        slots[j] = idx
    return slots


def is_kenlm_binary(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(len(MAGIC))
    except OSError:
        return False
    return head == MAGIC


# ---------------------------------------------------------------------------
# writer (build_binary equivalent)


def write_kenlm_binary(lm, path: str, *,
                       probing_multiplier: float = 1.5) -> None:
    """Compile an ARPA model (path or NGramLM) to a probing binary."""
    if isinstance(lm, str):
        lm = NGramLM(lm)
    order = lm.order

    # word ids: kenlm fixes <unk>=0 <s>=1 </s>=2, then insertion order
    words: List[str] = [UNK, BOS, EOS]
    word_id: Dict[str, int] = {UNK: 0, BOS: 1, EOS: 2}
    for g in lm.ngrams:
        if len(g) == 1 and g[0] not in word_id:
            word_id[g[0]] = len(words)
            words.append(g[0])
    bound = len(words)

    by_order: List[List[Tuple[Tuple[str, ...], float, float]]] = \
        [[] for _ in range(order)]
    for g, (logp_nat, bo_nat) in lm.ngrams.items():
        by_order[len(g) - 1].append((g, logp_nat / LOG10, bo_nat / LOG10))
    counts = [len(e) for e in by_order]

    header = bytearray()
    header += MAGIC + b"\x00" * (MAGIC_PAD - len(MAGIC))
    header += struct.pack("<fff", 0.0, 1.0, -0.5)
    header += struct.pack("<II", 1, 0xFFFFFFFF)
    header += struct.pack("<Q", 1)
    header += b"\x00" * (SANITY_SIZE - len(header))
    header += struct.pack(FIXED_FMT, order, probing_multiplier,
                          MODEL_PROBING, 1, 0)
    header += struct.pack(f"<{order}Q", *counts)
    header += b"\x00" * (_align8(len(header)) - len(header))

    out = bytearray(header)

    # vocabulary probing table
    vb = _buckets(counts[0], probing_multiplier)
    vkeys = np.zeros(vb, np.uint64)
    vvals = np.zeros(vb, np.uint32)
    for w, i in word_id.items():
        k = murmur64a(w.encode("utf-8")) or 1
        slot = _probe_insert(np.array([k], np.uint64), vkeys)[0]
        vvals[slot] = i
    out += struct.pack("<Q", bound)
    vocab_tab = np.zeros(vb, dtype=[("key", "<u8"), ("id", "<u4"),
                                    ("pad", "<u4")])
    vocab_tab["key"] = vkeys
    vocab_tab["id"] = vvals
    out += vocab_tab.tobytes()
    out += b"\x00" * (_align8(len(out)) - len(out))

    # unigram array indexed by word id (+1 sentinel row, search_hashed.hh).
    # NaN marks "word id exists but has no unigram entry" — in a
    # well-formed model that is only possible for <unk>/<s>/</s> when the
    # ARPA omits them (every other id comes FROM a unigram line).
    uni = np.zeros(bound + 1, dtype=[("prob", "<f4"), ("bo", "<f4")])
    uni["prob"][:] = np.nan
    for g, lp, bo in by_order[0]:
        i = word_id[g[0]]
        uni["prob"][i] = lp
        uni["bo"][i] = bo
    out += uni.tobytes()
    out += b"\x00" * (_align8(len(out)) - len(out))

    # middle orders: {u64 key, f32 prob, f32 backoff}
    for n in range(2, order):
        entries = by_order[n - 1]
        nb = _buckets(len(entries), probing_multiplier)
        tab = np.zeros(nb, dtype=[("key", "<u8"), ("prob", "<f4"),
                                  ("bo", "<f4")])
        tkeys = np.zeros(nb, np.uint64)
        for g, lp, bo in entries:
            ids = np.array([word_id[w] for w in g], np.int64)
            k = int(_chain_hash_np(ids)) or 1
            slot = _probe_insert(np.array([k], np.uint64), tkeys)[0]
            tab["prob"][slot] = lp
            tab["bo"][slot] = bo
        tab["key"] = tkeys
        out += tab.tobytes()
        out += b"\x00" * (_align8(len(out)) - len(out))

    # longest order: 12-byte packed {u64 key, f32 prob}
    if order >= 2:
        entries = by_order[order - 1]
        nb = _buckets(len(entries), probing_multiplier)
        tkeys = np.zeros(nb, np.uint64)
        probs = np.zeros(nb, np.float32)
        for g, lp, _ in entries:
            ids = np.array([word_id[w] for w in g], np.int64)
            k = int(_chain_hash_np(ids)) or 1
            slot = _probe_insert(np.array([k], np.uint64), tkeys)[0]
            probs[slot] = lp
        packed = bytearray()
        for i in range(nb):
            packed += struct.pack("<Qf", int(tkeys[i]), float(probs[i]))
        out += packed
        out += b"\x00" * (_align8(len(out)) - len(out))

    out += b"\x00".join(w.encode("utf-8") for w in words) + b"\x00"
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# reader


def read_kenlm_binary(path: str):
    """Open any supported KenLM `.binary`, dispatching on model_type:
    PROBING(0) -> KenLMBinary, TRIE(2)/QUANT_TRIE(3) -> KenLMTrie
    (ops/kenlm_trie.py); ARRAY tries (4/5, bhiksha-compressed pointers)
    raise with a rebuild hint."""
    with open(path, "rb") as f:
        head = f.read(SANITY_SIZE + FIXED_SIZE)
    if head[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: not a KenLM binary (magic mismatch)")
    _, _, mtype, _, _ = struct.unpack_from(FIXED_FMT, head, SANITY_SIZE)
    if mtype == MODEL_PROBING:
        return KenLMBinary(path)
    if mtype in (MODEL_TRIE, MODEL_QUANT_TRIE):
        from vietasr_tpu_torch.ops.kenlm_trie import KenLMTrie
        return KenLMTrie(path)
    raise ValueError(
        f"{path}: model_type={mtype} (ARRAY/bhiksha trie family) is not "
        "supported; rebuild with 'build_binary probing' or 'build_binary "
        "trie' (no -a), or supply the ARPA")


class KatzScorerMixin:
    """Katz-backoff scoring over any exact-n-gram lookup backend.

    Requires: self.order, self.word_id (str -> id), self.has_unk,
    self._unk_log10() and self._lookup(ids) -> (log10 prob, log10 backoff)
    or None. Scores in natural log, matching ops/lm.py NGramLM._score."""

    def log_prob(self, word: str, context: Sequence[str] = ()) -> float:
        from vietasr_tpu_torch.ops.lm import SPACE_TOKEN

        if word == " ":
            word = SPACE_TOKEN
        context = tuple(SPACE_TOKEN if w == " " else w for w in context)
        context = context[-(self.order - 1):] if self.order > 1 else ()
        return self._score_words(context + (word,))

    def _score_words(self, ngram: Tuple[str, ...]) -> float:
        ids = [self.word_id.get(w, 0) for w in ngram]
        return self._score_ids(ids)

    def _score_ids(self, ids: Sequence[int]) -> float:
        hit = self._lookup(ids)
        if hit is not None:
            return hit[0] * LOG10
        if len(ids) == 1:
            if self.has_unk:
                return self._unk_log10() * LOG10
            return -1e30 / 2    # matches NGramLM's no-<unk> floor
        ctx = self._lookup(ids[:-1])
        bo = ctx[1] * LOG10 if ctx is not None else 0.0
        return bo + self._score_ids(ids[1:])

    def score_sentence(self, words: Sequence[str], *, bos: bool = True,
                       eos: bool = True) -> float:
        context: Tuple[str, ...] = (BOS,) if bos else ()
        total = 0.0
        for w in list(words) + ([EOS] if eos else []):
            total += self.log_prob(w, context)
            context = context + (w,)
        return total


class KenLMBinary(KatzScorerMixin):
    """Probing-binary scorer with the NGramLM interface (natural log)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[: len(MAGIC)] != MAGIC:
            raise ValueError(
                f"{path}: not a KenLM binary (magic mismatch); expected "
                "'mmap lm ... format version 5'")
        zero, one, half = struct.unpack_from("<fff", data, MAGIC_PAD)
        if (zero, one, half) != (0.0, 1.0, -0.5):
            raise ValueError(f"{path}: float sanity check failed "
                             "(byte order / format drift)")
        order, mult, mtype, has_vocab, _ver = struct.unpack_from(
            FIXED_FMT, data, SANITY_SIZE)
        if mtype != MODEL_PROBING:
            raise ValueError(
                f"{path}: model_type={mtype} is not PROBING; use "
                "read_kenlm_binary() which dispatches TRIE/QUANT_TRIE to "
                "ops/kenlm_trie.KenLMTrie")
        off = SANITY_SIZE + FIXED_SIZE
        counts = struct.unpack_from(f"<{order}Q", data, off)
        off = _align8(off + 8 * order)

        self.order = order
        self.counts = list(counts)
        (self.bound,) = struct.unpack_from("<Q", data, off)
        off += 8
        vb = _buckets(counts[0], mult)
        vocab_tab = np.frombuffer(
            data, dtype=[("key", "<u8"), ("id", "<u4"), ("pad", "<u4")],
            count=vb, offset=off)
        off = _align8(off + vocab_tab.nbytes)

        uni = np.frombuffer(data, dtype=[("prob", "<f4"), ("bo", "<f4")],
                            count=self.bound + 1, offset=off)
        self._uni_prob = uni["prob"][: self.bound].astype(np.float64)
        self._uni_bo = uni["bo"][: self.bound].astype(np.float64)
        off = _align8(off + uni.nbytes)

        self._mid: List[np.ndarray] = []
        for n in range(2, order):
            nb = _buckets(counts[n - 1], mult)
            tab = np.frombuffer(
                data, dtype=[("key", "<u8"), ("prob", "<f4"), ("bo", "<f4")],
                count=nb, offset=off)
            self._mid.append(tab)
            off = _align8(off + tab.nbytes)

        self._longest: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if order >= 2:
            nb = _buckets(counts[order - 1], mult)
            raw = data[off : off + nb * 12]
            keys = np.empty(nb, np.uint64)
            probs = np.empty(nb, np.float32)
            for i in range(nb):
                k, p = struct.unpack_from("<Qf", raw, i * 12)
                keys[i] = k
                probs[i] = p
            self._longest = (keys, probs)
            off = _align8(off + nb * 12)

        if not has_vocab:
            raise ValueError(
                f"{path}: binary was built without vocabulary strings "
                "(build_binary -v?); word lookup is impossible — supply "
                "the ARPA instead")
        strings = data[off:].split(b"\x00")
        self.words = [s.decode("utf-8") for s in strings[: self.bound]]
        self.word_id = {w: i for i, w in enumerate(self.words)}
        self.vocab = [w for i, w in enumerate(self.words)
                      if not np.isnan(self._uni_prob[i])]
        self.has_unk = not np.isnan(self._uni_prob[0])

    # -- lookups ------------------------------------------------------------

    def _probe(self, table_keys: np.ndarray, key: int) -> int:
        n = len(table_keys)
        idx = int(key % n)
        while True:
            k = int(table_keys[idx])
            if k == key:
                return idx
            if k == 0:
                return -1
            idx = (idx + 1) % n

    def _lookup(self, ids: Sequence[int]) -> Optional[Tuple[float, float]]:
        """(log10 prob, log10 backoff) of an n-gram of word ids, or None."""
        n = len(ids)
        if n == 1:
            i = ids[0]
            p = float(self._uni_prob[i])
            if np.isnan(p):
                return None
            return p, float(self._uni_bo[i])
        key = int(_chain_hash_np(np.asarray(ids, np.int64))) or 1
        if n == self.order:
            keys, probs = self._longest
            slot = self._probe(keys, key)
            return None if slot < 0 else (float(probs[slot]), 0.0)
        tab = self._mid[n - 2]
        slot = self._probe(tab["key"], key)
        if slot < 0:
            return None
        return float(tab["prob"][slot]), float(tab["bo"][slot])

    def _unk_log10(self) -> float:
        return float(self._uni_prob[0])    # <unk> is word id 0

    # -- full reconstruction for the table builders --------------------------

    def to_ngram_lm(self, *, max_probes: int = 50_000_000) -> NGramLM:
        """Rebuild an explicit word-keyed NGramLM by vectorized candidate
        probing: the binary stores hashed keys, so higher orders are
        recovered by probing (known (n-1)-grams) x vocab — exact because a
        valid model's n-gram contexts all exist at order n-1 (the ARPA
        well-formedness rule kenlm enforces). Gated by `max_probes`:
        domain-sized LMs are far under the gate; scoring itself never
        needs this."""
        lm = NGramLM.__new__(NGramLM)
        lm.order = self.order
        lm.vocab = []
        lm.ngrams = {}
        for i, w in enumerate(self.words):
            p = float(self._uni_prob[i])
            if np.isnan(p):
                continue
            lm.ngrams[(w,)] = (p * LOG10, float(self._uni_bo[i]) * LOG10)
            lm.vocab.append(w)
        lm.has_unk = self.has_unk

        prev_ids = np.arange(self.bound, dtype=np.int64)[:, None]  # (N, 1)
        all_ids = np.arange(self.bound, dtype=np.int64)
        for n in range(2, self.order + 1):
            cand = np.concatenate(
                [np.repeat(prev_ids, self.bound, axis=0),
                 np.tile(all_ids, len(prev_ids))[:, None]], axis=1)
            if len(cand) > max_probes:
                raise ValueError(
                    f"binary LM too large to reconstruct explicitly "
                    f"({len(cand)} candidate {n}-grams > {max_probes}); "
                    "use KenLMBinary scoring directly or supply the ARPA")
            keys = _chain_hash_np(cand)
            keys[keys == 0] = 1
            if n == self.order:
                tkeys, tprobs = self._longest
                tbos = None
            else:
                tab = self._mid[n - 2]
                tkeys, tprobs, tbos = tab["key"], tab["prob"], tab["bo"]
            nb = len(tkeys)
            idx = (keys % nb).astype(np.int64)
            found = np.full(len(cand), -1, np.int64)
            active = np.ones(len(cand), bool)
            for _ in range(nb):        # displacement bound
                tk = tkeys[idx[active]]
                hit = tk == keys[active]
                empty = tk == 0
                ai = np.nonzero(active)[0]
                found[ai[hit]] = idx[ai[hit]]
                active[ai[hit | empty]] = False
                if not active.any():
                    break
                idx[active] = (idx[active] + 1) % nb
            hits = np.nonzero(found >= 0)[0]
            kept = []
            for ci in hits:
                slot = found[ci]
                g = tuple(self.words[int(i)] for i in cand[ci])
                lp = float(tprobs[slot]) * LOG10
                bo = float(tbos[slot]) * LOG10 if tbos is not None else 0.0
                lm.ngrams[g] = (lp, bo)
                kept.append(cand[ci])
            prev_ids = np.asarray(kept, np.int64).reshape(len(kept), n)
        return lm
