"""KenLM TRIE / QUANT_TRIE `.binary` format: reader + writer (the port's
copy of vietasr_tpu/ops/kenlm_trie.py, numpy only).

`build_binary trie` / `build_binary -q 8 -b 8 trie` emit model_type
TRIE(2) / QUANT_TRIE(3), the memory-compact family of the KenLM binaries
the reference deploys (its beam_search_decoder.py:82-87).
`ops/kenlm_binary.py` covers PROBING(0); this module covers the trie
family; `read_kenlm_binary` dispatches on the header's model_type, so
`ops/lm.py:load_lm` accepts both.

Layout (implemented from KenLM's published sources — lm/trie.hh,
lm/search_trie.cc, lm/quantize.hh, lm/vocab.cc SortedVocabulary,
util/bit_packing.hh; kenlm itself is not a dependency, so as with the
probing module the writer makes the fixtures and the reader is validated
by score parity against the ARPA scorer):

  [Sanity][FixedWidthParameters][u64 counts[order]]  as probing
    (kenlm_binary.py header docs), ALIGN8; model_type 2 or 3
  [SortedVocabulary]        lm/vocab.cc: u64 n_hashes ("Lead with the
    number of entries", SortedVocabulary::Size), then n_hashes murmur64a
    word hashes ASCENDING; word id = 1 + rank (<unk> = 0),
    bound = n_hashes + 1. The vocabulary precedes the WHOLE search
    section (GenericModel::SetupMemory does vocab_.SetupMemory before
    search_.SetupMemory — quant tables are part of search).
  [Quant tables]            QUANT_TRIE only (lm/quantize.hh
                            SeparatelyQuantize; first search member):
    u8 prob_bits, u8 backoff_bits, 6B pad
    (order-2) x [2^prob_bits f32 prob bin centers]
               [2^backoff_bits f32 backoff bin centers]
    [2^prob_bits f32]       longest order's prob centers
  [Unigram]                 lm/trie.hh UnigramValue:
    (counts[0] + 2) x {f32 prob; f32 backoff; u64 next} — kenlm's
    Unigram::Size comment: "+1 in case unknown doesn't appear. +1 for
    the final next." Entries beyond the live range (ids 0..bound-1 plus
    the end sentinel at index bound) are zero spare. `next` = begin
    index of this word's children in the order-2 table; entry i's child
    range is [next[i], next[i+1]). prob NaN marks "id exists, no
    unigram entry" (only <unk>/<s>).
  [Middle tables, k=2..order-1]   bit-packed records, LSB-first within
    a little-endian stream (util/bit_packing.hh ReadInt57):
    (counts[k-1] + 1) x [word: word_bits][prob][backoff][next: next_bits]
    prob/backoff are raw floats (prob: 31-bit sign-stripped
    NonPositiveFloat, backoff: full 32-bit) for TRIE, or bin indices
    (prob_bits/backoff_bits) for QUANT_TRIE. The +1 record is the end
    sentinel (next = counts[k]). Table byte size =
    ceil(n_records*total_bits/8) + 8 slop (so 8-byte windowed reads
    never run off the end — BitPacked::BaseSize's "+sizeof(uint64_t) so
    that ReadInt57 etc don't go segfault"); NO alignment padding between
    bit-packed tables.
  [Longest table, order n]  (counts[order-1]) x [word][prob] bit-packed
  [Vocab strings]           words NUL-separated in word-id order

INTEROP CONFIDENCE (no real `build_binary` artifact is in the repo, so
the byte layout is reconstructed
from knowledge of kenlm's sources and validated by self-round-trip +
ARPA score parity): section ORDER and the vocabulary count prefix are
high-confidence; the unigram spare slot and the absence of inter-table
padding are medium; word_bits uses the minimal RequiredBits(bound - 1)
which matches self-written files but has NOT been verified against a
real artifact (kenlm may size conservatively from counts[0] + 1). If a
real TRIE binary fails to load (the reader checks that the strings
section starts with "<unk>" and raises), the supported workaround is to
rebuild from the ARPA: `--lm-path model.arpa` loads directly, and
write_kenlm_trie re-emits a loadable binary.

Trie structure: the path for n-gram (g1..gn) is REVERSED —
(gn, g_{n-1}, ..., g1) — so lookup starts at unigram[gn] and extends
left through the context; a record at depth k stores word g_{n-k+1} and
represents the k-gram suffix-path; children of a record are contiguous
in the next table (records sorted by reversed-gram tuple), found by
binary search on the word field. Requires suffix-closure (every k-gram's
(k-1)-suffix present) — automatic for count-based models, enforced by
the writer.

word_bits = bits(bound-1); next_bits(k) = bits(counts[k]) (the sentinel
stores counts[k] itself). Quantization bins are trained equal-count
(Federico & Bertoldi 2006, what kenlm implements); decode is a pure
table gather so a real kenlm file's stored bins decode exactly.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vietasr_tpu_torch.ops.kenlm_binary import (FIXED_FMT, FIXED_SIZE,
                                                MAGIC, MAGIC_PAD,
                                                MODEL_QUANT_TRIE, MODEL_TRIE,
                                                SANITY_SIZE, KatzScorerMixin,
                                                _align8, murmur64a)
from vietasr_tpu_torch.ops.lm import LOG10, UNK, NGramLM

PROB_BITS_RAW = 31     # sign-stripped non-positive float (bit_packing.hh)
BACKOFF_BITS_RAW = 32  # full f32


def _required_bits(max_value: int) -> int:
    return max(1, int(max_value).bit_length())


# ---------------------------------------------------------------------------
# bit-packed stream helpers (little-endian, LSB-first, like
# util/bit_packing.hh ReadInt57/WriteInt57)


class _BitWriter:
    def __init__(self):
        self.acc = 0          # pending bits, LSB-first
        self.nbits = 0
        self.out = bytearray()

    def write(self, value: int, bits: int) -> None:
        assert 0 <= value < (1 << bits)
        self.acc |= value << self.nbits
        self.nbits += bits
        while self.nbits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def finish(self) -> bytes:
        if self.nbits:
            self.out.append(self.acc & 0xFF)
        return bytes(self.out) + b"\x00" * 8      # 8B slop for u64 windows


def _read_bits_np(buf: np.ndarray, bit_offsets: np.ndarray,
                  bits: int) -> np.ndarray:
    """Vectorized field extraction: u64 window at byte (bit>>3), shifted by
    (bit & 7). Fields are <= 57 bits so the 64-bit window always covers
    them (the writer appends 8 slop bytes)."""
    byte = (bit_offsets >> 3).astype(np.int64)
    shift = (bit_offsets & 7).astype(np.uint64)
    window = np.zeros(len(bit_offsets), np.uint64)
    for j in range(8):
        window |= buf[byte + j].astype(np.uint64) << np.uint64(8 * j)
    mask = np.uint64((1 << bits) - 1)
    return (window >> shift) & mask


def _decode_prob31(raw: np.ndarray) -> np.ndarray:
    """31-bit sign-stripped non-positive float -> f32 (sets the sign bit
    back, bit_packing.hh ReadNonPositiveFloat31)."""
    return (raw.astype(np.uint32) | np.uint32(0x80000000)).view(np.float32)


def _encode_prob31(values: np.ndarray) -> np.ndarray:
    return (np.asarray(values, np.float32).view(np.uint32)
            & np.uint32(0x7FFFFFFF))


# ---------------------------------------------------------------------------
# quantization bins (lm/quantize.hh SeparatelyQuantize)


def _train_bins(values: Sequence[float], bits: int) -> np.ndarray:
    """Equal-count bins over the sorted values; center = chunk mean."""
    n_bins = 1 << bits
    v = np.sort(np.asarray(values, np.float32))
    if len(v) == 0:
        return np.zeros(n_bins, np.float32)
    centers = np.empty(n_bins, np.float32)
    # chunk boundaries like kenlm's MakeBins: proportional slices
    for b in range(n_bins):
        lo = (b * len(v)) // n_bins
        hi = ((b + 1) * len(v)) // n_bins
        centers[b] = v[lo:hi].mean() if hi > lo else \
            (centers[b - 1] if b else v[0])
    return centers


def _encode_bins(values: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest-center index (centers ascending)."""
    idx = np.searchsorted(centers, values).clip(0, len(centers) - 1)
    lower = np.maximum(idx - 1, 0)
    pick_lower = (np.abs(centers[lower] - values)
                  <= np.abs(centers[idx] - values))
    return np.where(pick_lower, lower, idx).astype(np.int64)


# ---------------------------------------------------------------------------
# writer (build_binary trie / -q equivalent; fixture generator)


def write_kenlm_trie(lm, path: str, *,
                     quant_bits: Optional[Tuple[int, int]] = None) -> None:
    """Compile an ARPA model (path or NGramLM) to a TRIE binary.

    quant_bits=(prob_bits, backoff_bits) emits QUANT_TRIE (build_binary
    -q P -b B); None emits the raw-float TRIE."""
    if isinstance(lm, str):
        lm = NGramLM(lm)
    order = lm.order
    quant = quant_bits is not None
    if quant:
        prob_bits, backoff_bits = quant_bits
        if not (1 <= prob_bits <= 25 and 1 <= backoff_bits <= 25):
            raise ValueError("quant bits must be in [1, 25]")

    # sorted vocabulary: <unk>=0; every other word id = 1 + rank of its
    # murmur hash in ascending order
    vocab_words = sorted({g[0] for g in lm.ngrams if len(g) == 1
                          and g[0] != UNK})
    hashed = sorted((murmur64a(w.encode("utf-8")), w) for w in vocab_words)
    word_id: Dict[str, int] = {UNK: 0}
    for i, (_, w) in enumerate(hashed):
        word_id[w] = i + 1
    bound = len(hashed) + 1

    by_order: List[List[Tuple[Tuple[int, ...], float, float]]] = \
        [[] for _ in range(order)]
    for g, (logp_nat, bo_nat) in lm.ngrams.items():
        try:
            ids = tuple(word_id[w] for w in g)
        except KeyError as e:
            raise ValueError(
                f"n-gram {g} uses word {e} with no unigram entry; the trie "
                "needs every word in the vocabulary") from None
        by_order[len(g) - 1].append((ids, logp_nat / LOG10, bo_nat / LOG10))
    counts = [len(e) for e in by_order]

    # sort every order by reversed-gram path; verify suffix-closure
    paths: List[List[Tuple[Tuple[int, ...], float, float]]] = []
    for k in range(order):
        rows = sorted(((tuple(reversed(ids)), lp, bo)
                       for ids, lp, bo in by_order[k]))
        paths.append(rows)
    for k in range(1, order):
        parents = {p for p, _, _ in paths[k - 1]} if k > 1 else None
        for p, _, _ in paths[k]:
            if k == 1:
                continue
            if p[:-1] not in parents:
                sfx = tuple(reversed(p[:-1]))
                raise ValueError(
                    f"suffix-closure violated: {k+1}-gram path {p} needs "
                    f"{k}-gram {sfx}; kenlm inserts blanks here, this "
                    "writer requires count-closed models")

    # next pointers: children of paths[k-1][i] are the contiguous run of
    # paths[k] whose path[:-1] == that parent path
    nexts: List[np.ndarray] = []        # per order k-1: len = count + 1
    for k in range(order - 1):
        parent_rows = paths[k]
        child_rows = paths[k + 1]
        if k == 0:
            # unigram "paths" are (id,); index children by id directly
            nxt = np.zeros(bound + 1, np.int64)
            ci = 0
            for wid in range(bound):
                nxt[wid] = ci
                while ci < len(child_rows) and child_rows[ci][0][0] == wid:
                    ci += 1
            if ci != len(child_rows):
                raise ValueError("bigram child with out-of-range head id")
            nxt[bound] = len(child_rows)
        else:
            nxt = np.zeros(len(parent_rows) + 1, np.int64)
            ci = 0
            for pi, (ppath, _, _) in enumerate(parent_rows):
                nxt[pi] = ci
                while (ci < len(child_rows)
                       and child_rows[ci][0][:-1] == ppath):
                    ci += 1
            if ci != len(child_rows):
                raise ValueError("orphaned child records (unsorted input?)")
            nxt[len(parent_rows)] = len(child_rows)
        nexts.append(nxt)

    # quant bin training (middle orders share per-order tables)
    prob_centers: List[np.ndarray] = []
    bo_centers: List[np.ndarray] = []
    if quant:
        for k in range(1, order - 1):
            prob_centers.append(_train_bins([lp for _, lp, _ in paths[k]],
                                            prob_bits))
            bo_centers.append(_train_bins([bo for _, _, bo in paths[k]],
                                          backoff_bits))
        prob_centers.append(_train_bins([lp for _, lp, _ in paths[order - 1]],
                                        prob_bits))

    header = bytearray()
    header += MAGIC + b"\x00" * (MAGIC_PAD - len(MAGIC))
    header += struct.pack("<fff", 0.0, 1.0, -0.5)
    header += struct.pack("<II", 1, 0xFFFFFFFF)
    header += struct.pack("<Q", 1)
    header += b"\x00" * (SANITY_SIZE - len(header))
    header += struct.pack(FIXED_FMT, order, 1.5,
                          MODEL_QUANT_TRIE if quant else MODEL_TRIE, 1, 1)
    header += struct.pack(f"<{order}Q", *counts)
    header += b"\x00" * (_align8(len(header)) - len(header))
    out = bytearray(header)

    # vocabulary precedes the whole search section (incl. quant tables)
    out += struct.pack("<Q", len(hashed))
    out += np.array([h for h, _ in hashed], "<u8").tobytes()

    if quant:
        out += struct.pack("<BB6x", prob_bits, backoff_bits)
        for k in range(order - 2):
            out += prob_centers[k].astype("<f4").tobytes()
            out += bo_centers[k].astype("<f4").tobytes()
        out += prob_centers[order - 2].astype("<f4").tobytes()

    # unigrams: counts[0] + 2 slots (Unigram::Size — spare for a missing
    # <unk> plus the end sentinel); live entries are ids 0..bound-1 and
    # the sentinel at index bound, the rest zero spare
    uni = np.zeros(counts[0] + 2, dtype=[("prob", "<f4"), ("bo", "<f4"),
                                         ("next", "<u8")])
    uni["prob"][: bound] = np.nan
    for (wid,), lp, bo in paths[0]:
        uni["prob"][wid] = lp
        uni["bo"][wid] = bo
    uni["next"][: bound + 1] = nexts[0]
    out += uni.tobytes()

    word_bits = _required_bits(bound - 1)
    for k in range(1, order):
        rows = paths[k]
        longest = k == order - 1
        if quant:
            pb = prob_bits
            bb = 0 if longest else backoff_bits
            p_idx = _encode_bins(
                np.array([lp for _, lp, _ in rows], np.float32),
                prob_centers[k - 1])
            if not longest:
                b_idx = _encode_bins(
                    np.array([bo for _, _, bo in rows], np.float32),
                    bo_centers[k - 1])
        else:
            pb = PROB_BITS_RAW
            bb = 0 if longest else BACKOFF_BITS_RAW
            p_idx = _encode_prob31(
                np.array([lp for _, lp, _ in rows], np.float32))
            if not longest:
                b_idx = np.array([bo for _, _, bo in rows],
                                 np.float32).view(np.uint32)
        next_bits = 0 if longest else _required_bits(counts[k + 1])
        w = _BitWriter()
        for i, (p, _, _) in enumerate(rows):
            w.write(p[-1], word_bits)
            w.write(int(p_idx[i]), pb)
            if not longest:
                w.write(int(b_idx[i]), bb)
                w.write(int(nexts[k][i]), next_bits)
        if not longest:      # end sentinel: word 0, zero payload, end next
            w.write(0, word_bits)
            w.write(0, pb)
            w.write(0, bb)
            w.write(int(nexts[k][len(rows)]), next_bits)
        out += w.finish()                 # no inter-table padding

    words = [UNK] + [w for _, w in hashed]
    out += b"\x00".join(w.encode("utf-8") for w in words) + b"\x00"
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# reader


class KenLMTrie(KatzScorerMixin):
    """TRIE/QUANT_TRIE scorer with the NGramLM interface (natural log).

    Decodes every bit-packed table into flat numpy arrays at load (the
    file is the storage format; columnar arrays are the runtime — they
    also feed the on-device LM table builders via to_ngram_lm)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a KenLM binary (magic mismatch)")
        zero, one, half = struct.unpack_from("<fff", data, MAGIC_PAD)
        if (zero, one, half) != (0.0, 1.0, -0.5):
            raise ValueError(f"{path}: float sanity check failed")
        order, _mult, mtype, has_vocab, _ver = struct.unpack_from(
            FIXED_FMT, data, SANITY_SIZE)
        if mtype not in (MODEL_TRIE, MODEL_QUANT_TRIE):
            raise ValueError(f"{path}: model_type={mtype} is not a "
                             "TRIE/QUANT_TRIE binary")
        quant = mtype == MODEL_QUANT_TRIE
        off = SANITY_SIZE + FIXED_SIZE
        counts = struct.unpack_from(f"<{order}Q", data, off)
        off = _align8(off + 8 * order)

        self.order = order
        self.counts = list(counts)

        # vocabulary first (precedes the whole search section)
        (n_hashes,) = struct.unpack_from("<Q", data, off)
        off += 8
        off += 8 * n_hashes          # hashes: ids come from string order
        self.bound = n_hashes + 1

        prob_centers: List[np.ndarray] = []
        bo_centers: List[np.ndarray] = []
        if quant:
            prob_bits, backoff_bits = struct.unpack_from("<BB6x", data, off)
            off += 8
            for _ in range(order - 2):
                prob_centers.append(np.frombuffer(
                    data, "<f4", 1 << prob_bits, off))
                off += 4 << prob_bits
                bo_centers.append(np.frombuffer(
                    data, "<f4", 1 << backoff_bits, off))
                off += 4 << backoff_bits
            prob_centers.append(np.frombuffer(
                data, "<f4", 1 << prob_bits, off))
            off += 4 << prob_bits

        # unigram section spans counts[0] + 2 slots (spare included)
        uni = np.frombuffer(data, dtype=[("prob", "<f4"), ("bo", "<f4"),
                                         ("next", "<u8")],
                            count=self.bound + 1, offset=off)
        self._uni_prob = uni["prob"][: self.bound].astype(np.float64)
        self._uni_bo = uni["bo"][: self.bound].astype(np.float64)
        self._uni_next = uni["next"].astype(np.int64)
        off += (counts[0] + 2) * 16

        word_bits = _required_bits(self.bound - 1)
        buf = np.frombuffer(data, np.uint8)
        # per order k=2..n: (words, probs, backoffs, nexts) flat arrays
        self._tables: List[Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray],
                                 Optional[np.ndarray]]] = []
        for k in range(2, order + 1):
            longest = k == order
            n_rec = counts[k - 1] + (0 if longest else 1)
            if quant:
                pb = prob_bits
                bb = 0 if longest else backoff_bits
            else:
                pb = PROB_BITS_RAW
                bb = 0 if longest else BACKOFF_BITS_RAW
            next_bits = 0 if longest else _required_bits(counts[k])
            total_bits = word_bits + pb + bb + next_bits
            base_bit = off * 8
            rec = np.arange(n_rec, dtype=np.int64) * total_bits + base_bit
            words = _read_bits_np(buf, rec, word_bits).astype(np.int64)
            praw = _read_bits_np(buf, rec + word_bits, pb)
            if quant:
                probs = prob_centers[k - 2][praw.astype(np.int64)] \
                    .astype(np.float64)
            else:
                probs = _decode_prob31(praw.astype(np.uint32)) \
                    .astype(np.float64)
            bos_ = None
            nxt = None
            if not longest:
                braw = _read_bits_np(buf, rec + word_bits + pb, bb)
                if quant:
                    bos_ = bo_centers[k - 2][braw.astype(np.int64)] \
                        .astype(np.float64)
                else:
                    bos_ = braw.astype(np.uint32).view(np.float32) \
                        .astype(np.float64)
                nxt = _read_bits_np(buf, rec + word_bits + pb + bb,
                                    next_bits).astype(np.int64)
            self._tables.append((words, probs, bos_, nxt))
            off += (n_rec * total_bits + 7) // 8 + 8   # no inter-table pad

        if not has_vocab:
            raise ValueError(f"{path}: binary lacks vocabulary strings; "
                             "word lookup is impossible")
        if not data[off:].startswith(UNK.encode("utf-8") + b"\x00"):
            raise ValueError(
                f"{path}: vocab strings section not found where the "
                "computed layout ends — the file's section sizes diverge "
                "from this reader's layout (see the module docstring's "
                "interop-confidence note). Workaround: load the ARPA "
                "directly (--lm-path model.arpa) or re-emit with "
                "write_kenlm_trie")
        strings = data[off:].split(b"\x00")
        self.words = [s.decode("utf-8") for s in strings[: self.bound]]
        self.word_id = {w: i for i, w in enumerate(self.words)}
        self.vocab = [w for i, w in enumerate(self.words)
                      if not np.isnan(self._uni_prob[i])]
        self.has_unk = not np.isnan(self._uni_prob[0])

    def _unk_log10(self) -> float:
        return float(self._uni_prob[0])

    # -- trie walk -----------------------------------------------------------

    def _lookup(self, ids: Sequence[int]) -> Optional[Tuple[float, float]]:
        """(log10 prob, log10 backoff) of the exact n-gram, or None.
        Walks the reversed path: unigram[last] then context words
        right-to-left, binary-searching each child range."""
        last = ids[-1]
        if not 0 <= last < self.bound:
            return None
        p = float(self._uni_prob[last])
        if np.isnan(p):
            if len(ids) == 1:
                return None
            # traversable blank (<s> has no unigram PROB) — but its stored
            # backoff weight is real and must still apply (ADVICE r4)
            p = None
            bo = float(self._uni_bo[last])
            if not np.isfinite(bo):
                bo = 0.0
        else:
            bo = float(self._uni_bo[last])
        lo = int(self._uni_next[last])
        hi = int(self._uni_next[last + 1])
        for depth, w in enumerate(reversed(ids[:-1])):
            words, probs, bos_, nxt = self._tables[depth]
            j = lo + int(np.searchsorted(words[lo:hi], w))
            if j >= hi or words[j] != w:
                return None
            p = float(probs[j])
            if nxt is None:
                bo = 0.0
                lo = hi = 0
            else:
                bo = float(bos_[j])
                lo = int(nxt[j])
                hi = int(nxt[j + 1])
        if p is None:
            return None
        return p, bo

    # -- exact reconstruction (trie enumerates directly) ---------------------

    def to_ngram_lm(self) -> NGramLM:
        """Rebuild the explicit word-keyed NGramLM by trie traversal (no
        hash inversion needed, unlike the probing reader)."""
        lm = NGramLM.__new__(NGramLM)
        lm.order = self.order
        lm.vocab = list(self.vocab)
        lm.ngrams = {}
        lm.has_unk = self.has_unk
        for i, w in enumerate(self.words):
            p = float(self._uni_prob[i])
            if not np.isnan(p):
                lm.ngrams[(w,)] = (p * LOG10, float(self._uni_bo[i]) * LOG10)

        def walk(depth: int, lo: int, hi: int, suffix: Tuple[str, ...]):
            words, probs, bos_, nxt = self._tables[depth]
            for j in range(lo, hi):
                g = (self.words[int(words[j])],) + suffix
                bo = float(bos_[j]) if bos_ is not None else 0.0
                lm.ngrams[g] = (float(probs[j]) * LOG10, bo * LOG10)
                if nxt is not None and depth + 1 < len(self._tables):
                    walk(depth + 1, int(nxt[j]), int(nxt[j + 1]), g)

        if self.order >= 2:
            for wid in range(self.bound):
                walk(0, int(self._uni_next[wid]),
                     int(self._uni_next[wid + 1]), (self.words[wid],))
        return lm
