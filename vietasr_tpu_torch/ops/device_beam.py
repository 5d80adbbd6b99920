"""Batched CTC prefix beam search on the device, with char- or word-LM
shallow fusion: the plain PyTorch counterpart of
vietasr_tpu/ops/device_beam.py (the JAX package's XLA scan).

The step is the JAX step, op for op, as a Python loop over T:

- fixed beam width W; every step expands all W*(K+1) candidates (K = the
  frame's top-`cutoff_top_n` chars, or all V);
- the only possible prefix merge is stay(j) <- extension(i, c) when
  prefix_j == prefix_i + [c], a dense (W, W*K) equality test on two
  independent 32-bit rolling hashes;
- with `space` given and no char-LM table, beam identity is the CANONICAL
  text (leading/trailing/repeated spaces collapse): a separator is folded
  into the hash only when a non-space char starts a new word, a space
  extension leaves the hash unchanged, and the last-emitted char joins the
  equality test;
- word-LM fusion scores a completed word with full Katz backoff against
  the hashed open-addressing tables of ops/lm.py:word_lm_tables.

All per-beam scalars live in one packed (B, W, n_cols) int32 state (the
JAX package's uint32 state, bit for bit; f32 fields are bit views). The
uint32 hash arithmetic runs in int64 masked to 32 bits, because PyTorch's
uint32 lacks `+`, comparisons and gathers on the CPU. Ties in the two top-k
selections go to the lower index, as XLA's top_k: a stable descending sort.

`device_beam_transcripts` routes eligible calls (canonical identity, no
char-LM table, pruned expansion, W <= 128) to the fused CUDA kernel
(ops/fused_beam.py) and the rest to `device_beam_search`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vietasr_tpu_torch.utils.typing import assert_log_probs

NEG = -1e30
# widest beam routed to the fused kernel (ops/fused_beam.py); wider beams
# take device_beam_search
KERNEL_MAX_BEAM_WIDTH = 128
# widest n-gram order the on-device word-LM fusion supports
MAX_WLM_ORDER = 5

_M32 = 0xFFFFFFFF
_HASH_P1 = 1000003
_HASH_P2 = 69069
# hash-lane fold multipliers for combining word hashes into n-gram keys
_Q1 = 2654435761
_Q2 = 40503
_KEY_SEED = 1
_MIX = 0x9E3779B9


class WordLMTables(NamedTuple):
    """Hashed n-gram tables for on-device word-LM fusion (order <= 5).

    Every level is an open-addressing table (linear probing, power-of-two
    size, key 0 = empty slot) keyed by two 32-bit hash lanes. All L levels
    live interleaved in one (N, 4) array, [key1, key2, logp_bits,
    backoff_bits] per row; rows [bases[j], bases[j] + masks[j] + 1) hold
    the (j+1)-grams. ops/lm.py:word_lm_tables builds it with numpy uint32
    fields; `word_lm_to_device` gives the tensor form the search takes:
    packed (N, 4) int32 bit patterns, masks and bases (L,) int64, unk_logp
    a 0-d float32."""

    packed: object
    masks: object
    bases: object
    unk_logp: object


def word_lm_to_device(tables: WordLMTables, device) -> WordLMTables:
    """The tensor form of numpy WordLMTables, on `device`."""
    packed = np.ascontiguousarray(np.asarray(tables.packed, np.uint32))
    return WordLMTables(
        packed=torch.from_numpy(packed.view(np.int32)).to(device),
        masks=torch.from_numpy(np.asarray(tables.masks, np.int64)).to(device),
        bases=torch.from_numpy(np.asarray(tables.bases, np.int64)).to(device),
        unk_logp=torch.tensor(float(np.float32(tables.unk_logp)),
                              dtype=torch.float32, device=device))


# packed beam-state column layout: trailing columns past C_CTX scale with
# the word-LM order (context hash pairs, then carried backoff weights)
(C_H1, C_H2, C_PB, C_PNB, C_LM, C_LAST, C_ROW, C_PLEN,
 C_WH1, C_WH2) = range(10)
C_CTX = 10                       # pairs: c_j at (C_CTX+2j, C_CTX+2j+1)


def _wlm_levels(word_lm: Optional[WordLMTables]) -> int:
    return int(word_lm.masks.shape[0]) if word_lm is not None else 0


def packed_state_cols(word_lm: Optional[WordLMTables]) -> int:
    """Number of packed-state columns for a given word-LM config."""
    levels = _wlm_levels(word_lm)
    return C_CTX + 2 * max(levels - 1, 1) + max(levels - 1, 0)


# -- 32-bit helpers ----------------------------------------------------------

def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding its uint32 value."""
    return x.to(torch.int64) & _M32


def _i(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> the int32 bit pattern."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _f(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> float32 view."""
    return x.view(torch.float32)


def _fi(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 bit pattern."""
    return x.view(torch.int32)


def _mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) (tensor or int), c a constant:
    split so no int64 product overflows."""
    if c < 2 ** 31:
        return (x * c) & _M32
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _add32(a, b):
    return (a + b) & _M32


def _fold_key(seed1, seed2, h1, h2):
    return _add32(_mul32(seed1, _Q1), h1), _add32(_mul32(seed2, _Q2), h2)


def init_packed_state(bsz: int, w: int,
                      word_lm: Optional[WordLMTables] = None,
                      device=None) -> torch.Tensor:
    """Fresh packed (B, W, n_cols) int32 state: slot 0 is the live empty
    prefix, the rest are dead with poisoned (unique, never-matching)
    hashes."""
    n_cols = packed_state_cols(word_lm)
    slot = torch.arange(w, dtype=torch.int64, device=device)
    st0 = torch.zeros((w, n_cols), dtype=torch.int32, device=device)
    st0[:, C_H1] = _i(torch.where(slot == 0, 0, 0x80000000 + slot))
    st0[:, C_H2] = torch.where(slot == 0, 0, -1).to(torch.int32)
    neg = torch.full((w,), NEG, dtype=torch.float32, device=device)
    st0[:, C_PB] = _fi(torch.where(slot == 0, 0.0, neg))
    st0[:, C_PNB] = _fi(neg)
    return st0[None].expand(bsz, w, n_cols).contiguous()


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    dead = m <= NEG / 2
    safe = torch.where(dead, 0.0, m)
    out = safe + torch.log(torch.exp(torch.clamp(a - safe, min=NEG))
                           + torch.exp(torch.clamp(b - safe, min=NEG)))
    return torch.where(dead, NEG, out)


def _word_lm_score(tables: WordLMTables, probes: int, ctx, wh1, wh2,
                   bo_carries, dense: bool = False):
    """alpha-less natural-log p(word | c_{L-1} ... c_1) with Katz backoff.

    `ctx` is a list of (h1, h2) context-word hash pairs (int64 uint32
    values), MOST RECENT FIRST; hash 0 = absent. The context backoff
    weights are passed in (`bo_carries`, len L-1): the search carries them
    as state. Returns (logp, new_bos), new_bos being the word's own
    per-chain backoff weights (len L-1). `dense` matches every query
    against every row; otherwise each chain probes `probes` rows. At most
    one row matches a query, so both give the same result."""
    n_levels = int(tables.masks.shape[0])
    keys1, keys2 = [], []
    for j in range(1, n_levels + 1):     # chain j = j-gram (c_{j-1}..c_1 w)
        s1 = s2 = _KEY_SEED
        for i in range(j - 1, 0, -1):    # fold oldest context first
            s1, s2 = _fold_key(s1, s2, ctx[i - 1][0], ctx[i - 1][1])
        k1, k2 = _fold_key(s1, s2, wh1, wh2)
        keys1.append(k1)
        keys2.append(k2)
    q1 = torch.stack(keys1, dim=-1)                         # (..., L) int64
    q2 = torch.stack(keys2, dim=-1)
    q1_bits, q2_bits = _i(q1), _i(q2)
    masks, bases, packed = tables.masks, tables.bases, tables.packed
    if dense:
        n = packed.shape[0]
        row_id = torch.arange(n, dtype=torch.int64, device=packed.device)
        level_ok = (row_id[None, :] >= bases[:, None]) \
            & (row_id[None, :] < (bases + masks + 1)[:, None])   # (L, N)
        hit = (q1_bits[..., None] == packed[:, 0]) \
            & (q2_bits[..., None] == packed[:, 1]) \
            & level_ok & (q1[..., None] != 0)                # (..., L, N)
        any_hit = hit.any(dim=-1)
        val = torch.where(hit, _f(packed[:, 2]), NEG).amax(dim=-1)
        bo = torch.where(hit, _f(packed[:, 3]), NEG).amax(dim=-1)
        bo = torch.where(any_hit, bo, 0.0)
    else:
        idx0 = (q1 ^ _mul32(q2, _MIX)) & masks
        offs = torch.arange(probes, dtype=torch.int64, device=q1.device)
        idx = bases[:, None] + ((idx0[..., None] + offs) & masks[:, None])
        rows = packed[idx]                                   # (..., L, P, 4)
        hit = (rows[..., 0] == q1_bits[..., None]) \
            & (rows[..., 1] == q2_bits[..., None]) \
            & (q1[..., None] != 0)      # key 0 marks empty slots
        any_hit = hit.any(dim=-1)
        first = torch.argmax(hit.to(torch.int32), dim=-1)    # first hit
        picked = torch.gather(
            rows, -2, first[..., None, None].expand(
                *first.shape, 1, 4))[..., 0, :]              # (..., L, 4)
        val = _f(picked[..., 2])
        bo = torch.where(any_hit, _f(picked[..., 3]), 0.0)

    p = torch.where(any_hit[..., 0], val[..., 0], tables.unk_logp)
    exists = None
    for j in range(1, n_levels):
        ex_j = ctx[j - 1][0] != 0
        exists = ex_j if exists is None else exists & ex_j
        pj = torch.where(any_hit[..., j], val[..., j], bo_carries[j - 1] + p)
        p = torch.where(exists, pj, p)
    new_bos = [bo[..., j] for j in range(n_levels - 1)]
    return p, new_bos


def packed_beam_totals(st: torch.Tensor, *, word_lm=None, alpha=0.5,
                       beta=0.0, wlm_probes=8) -> torch.Tensor:
    """Per-beam total scores from a packed state: p_total + LM, plus the
    trailing-partial-word bonus when a word LM is in play (the final
    ranking of device_beam_search)."""
    total = _logsumexp2(_f(st[..., C_PB]), _f(st[..., C_PNB])) \
        + _f(st[..., C_LM])
    if word_lm is not None:
        levels = _wlm_levels(word_lm)
        n_ctxw, n_bo = max(levels - 1, 1), max(levels - 1, 0)
        c_bo = C_CTX + 2 * n_ctxw
        wh1 = _u(st[..., C_WH1])
        fctx = [(_u(st[..., C_CTX + 2 * j]), _u(st[..., C_CTX + 2 * j + 1]))
                for j in range(n_ctxw)]
        fbos = [_f(st[..., c_bo + j]) for j in range(n_bo)]
        sw, _ = _word_lm_score(word_lm, wlm_probes, fctx, wh1,
                               _u(st[..., C_WH2]), fbos,
                               dense=word_lm.packed.shape[0] <= 4096)
        total = total + torch.where(wh1 != 0, alpha * sw + beta, 0.0)
    return total


def frame_topk(log_probs: torch.Tensor, k_c: int):
    """Per-frame expansion set: the top-k_c non-blank log-probs and their
    char ids (B, T, k_c), ties to the lower id as XLA's top_k; all V chars
    in id order when k_c == V."""
    bsz, t_max, v1 = log_probs.shape
    v = v1 - 1
    if k_c < v:
        vals, idx = torch.sort(log_probs[:, :, :v], dim=-1, descending=True,
                               stable=True)
        return (vals[..., :k_c].contiguous(),
                idx[..., :k_c].to(torch.int32).contiguous())
    ids = torch.arange(v, dtype=torch.int32, device=log_probs.device)
    return log_probs[:, :, :v], ids.expand(bsz, t_max, v)


def expansion_width(v: int, cutoff_top_n: int) -> int:
    return v if cutoff_top_n <= 0 or cutoff_top_n >= v else cutoff_top_n


@torch.inference_mode()
def device_beam_search(
    log_probs: torch.Tensor,
    lengths: torch.Tensor,
    *,
    beam_width: int = 16,
    blank: int,
    lm_table: Optional[torch.Tensor] = None,
    n_ctx: int = 2,
    alpha: float = 0.5,
    beta: float = 0.0,
    max_len: int = 0,
    cutoff_top_n: int = 0,
    word_lm: Optional[WordLMTables] = None,
    wlm_probes: int = 8,
    space: int = -1,
    carry_state: Optional[torch.Tensor] = None,
    return_raw: bool = False,
):
    """(B, T, V+1) log-probs -> (prefixes (B, L) int32, lens (B,) int32).

    lm_table: ((V+1)^n_ctx, V) char-LM table or None. word_lm: tensor
    WordLMTables (requires `space`, the word-separator label). alpha/beta:
    fusion weight and per-word (per-char for the char LM) bonus.
    cutoff_top_n > 0 expands only the frame's top-N chars.
    `carry_state` resumes from a packed (B, W, n_cols) state;
    `return_raw=True` returns (final_state, parents, chars), the last two
    (T, B, W) int32 backpointers."""
    assert_log_probs(log_probs, num_classes=blank,
                     port="device_beam_search.log_probs")
    bsz, t_max, v1 = log_probs.shape
    v = v1 - 1
    w = beam_width
    l_max = max_len or t_max
    k_c = expansion_width(v, cutoff_top_n)
    if word_lm is not None and space < 0:
        raise ValueError("word_lm requires the space label index")
    if word_lm is not None and lm_table is not None:
        raise ValueError("char-LM table and word-LM fusion are exclusive")
    dev = log_probs.device
    lengths = lengths.to(dev)
    # canonical-text beam identity needs the space id; char-LM fusion
    # scores RAW sequences, so it keeps raw hashing
    normalize = space >= 0 and lm_table is None
    lm_dense = word_lm is not None and word_lm.packed.shape[0] <= 4096
    levels = _wlm_levels(word_lm)
    n_ctxw, n_bo = max(levels - 1, 1), max(levels - 1, 0)
    c_bo = C_CTX + 2 * n_ctxw
    n_cols = c_bo + n_bo

    slot_poison = 0x80000000 + torch.arange(w, dtype=torch.int64, device=dev)
    slots = torch.arange(w, dtype=torch.int64, device=dev)[None]
    st = carry_state if carry_state is not None \
        else init_packed_state(bsz, w, word_lm, dev)
    rows_mod = (v + 1) ** max(n_ctx - 1, 0) if lm_table is not None else 1
    all_top_lp, all_top_ci = frame_topk(log_probs, k_c)

    def step(st, t):
        hashes = _u(st[..., C_H1])
        hashes2 = _u(st[..., C_H2])
        p_b = _f(st[..., C_PB])
        p_nb = _f(st[..., C_PNB])
        lm_score = _f(st[..., C_LM])
        last = st[..., C_LAST] - 1
        wh1 = _u(st[..., C_WH1])
        wh2 = _u(st[..., C_WH2])
        ctx = [(_u(st[..., C_CTX + 2 * j]), _u(st[..., C_CTX + 2 * j + 1]))
               for j in range(n_ctxw)]
        bos = [_f(st[..., c_bo + j]) for j in range(n_bo)]
        c1h1, c1h2 = ctx[0]

        lp = log_probs[:, t]                                # (B, V+1)
        p_tot = _logsumexp2(p_b, p_nb)                      # (B, W)

        # ---- "stay" candidates: one per beam (same prefix) ----
        stay_pb = p_tot + lp[:, blank][:, None]
        lp_last = torch.gather(lp, 1, last.clamp(min=0).long())
        stay_pnb = torch.where(last >= 0, p_nb + lp_last, NEG)

        # ---- "extend" candidates: (B, W, K) over (pruned) tokens ----
        top_lp = all_top_lp[:, t]                           # (B, K)
        top_ci = all_top_ci[:, t]
        char_ids = top_ci[:, None, :].expand(bsz, w, k_c)
        is_rep = last[:, :, None] == char_ids
        base = torch.where(is_rep, p_b[:, :, None], p_tot[:, :, None])
        ext_pnb = base + top_lp[:, None, :]                 # (B, W, K)
        cplus3 = char_ids.to(torch.int64) + 1
        if normalize:
            # fold a single separator before a char that starts a new
            # word; a space never changes the hash
            has_words = ((c1h1 != 0) | (c1h2 != 0))[:, :, None]
            need_sep = (wh1 == 0)[:, :, None] & has_words
            sp_u = space + 1
            base1 = torch.where(
                need_sep, _add32(_mul32(hashes, _HASH_P1), sp_u)[:, :, None],
                hashes[:, :, None])
            base2 = torch.where(
                need_sep, _add32(_mul32(hashes2, _HASH_P2), sp_u)[:, :, None],
                hashes2[:, :, None])
            is_space_c = char_ids == space
            ext_hash = torch.where(is_space_c, hashes[:, :, None],
                                   _add32(_mul32(base1, _HASH_P1), cplus3))
            ext_hash2 = torch.where(is_space_c, hashes2[:, :, None],
                                    _add32(_mul32(base2, _HASH_P2), cplus3))
        else:
            ext_hash = _add32(_mul32(hashes, _HASH_P1)[:, :, None], cplus3)
            ext_hash2 = _add32(_mul32(hashes2, _HASH_P2)[:, :, None], cplus3)
        ext_lm = lm_score[:, :, None].expand(bsz, w, k_c)
        if lm_table is not None:
            lm_all = lm_table[st[..., C_ROW].long()]       # (B, W, V)
            lm_add = alpha * torch.gather(lm_all, 2, char_ids.long()) + beta
            ext_lm = ext_lm + lm_add
        if word_lm is not None:
            # completed-word bonus on the space extension of beams with a
            # non-empty partial word: one backoff chain per BEAM per step
            raw_sw, new_bos_vals = _word_lm_score(
                word_lm, wlm_probes, ctx, wh1, wh2, bos, dense=lm_dense)
            sw = torch.where(wh1 != 0, alpha * raw_sw + beta, 0.0)
            ext_lm = ext_lm + torch.where(char_ids == space,
                                          sw[:, :, None], 0.0)
        else:
            new_bos_vals = []

        # ---- merge: stay(j) absorbs extension(i, c) iff equal prefix ----
        eqm = (hashes[:, :, None, None] == ext_hash[:, None]) \
            & (hashes2[:, :, None, None] == ext_hash2[:, None])  # (B,W,W,K)
        if normalize:
            eqm = eqm & (last[:, :, None, None] == char_ids[:, None])
        ext_masked = torch.where(eqm, ext_pnb[:, None], NEG)
        mmax = torch.maximum(stay_pnb, ext_masked.amax(dim=(2, 3)))
        mdead = mmax <= NEG / 2
        msafe = torch.where(mdead, 0.0, mmax)
        msum = torch.exp(torch.clamp(stay_pnb - msafe, min=NEG)) + torch.exp(
            torch.clamp(ext_masked - msafe[:, :, None, None], min=NEG)
        ).sum(dim=(2, 3))
        stay_pnb_m = torch.where(
            mdead, NEG, msafe + torch.log(torch.clamp(msum, min=1e-38)))
        ext_pnb = torch.where(eqm.any(dim=1), NEG, ext_pnb)

        # ---- rank all W*(K+1) candidates, keep top W ----
        stay_total = _logsumexp2(stay_pb, stay_pnb_m) + lm_score
        ext_total = ext_pnb + ext_lm
        totals = torch.cat([stay_total, ext_total.reshape(bsz, w * k_c)], 1)
        top_val, top_idx = torch.sort(totals, dim=1, descending=True,
                                      stable=True)
        top_val, top_idx = top_val[:, :w], top_idx[:, :w]

        is_stay = top_idx < w
        ext_idx = (top_idx - w).clamp(min=0)
        sel_parent = torch.where(is_stay, top_idx, ext_idx // k_c)

        # ---- selection: the parent's packed state plus its per-beam
        # stay values and word-LM payloads as extra columns, one gather;
        # extension payloads are recomputed from the parent's columns ----
        extra = [stay_pb, stay_pnb_m] + new_bos_vals \
            + ([sw] if word_lm is not None else [])
        par_pack = torch.cat(
            [st, _fi(torch.stack(extra, dim=-1).contiguous())], dim=-1)
        sel = torch.gather(par_pack, 1, sel_parent[:, :, None].expand(
            bsz, w, par_pack.shape[-1]))
        p_bpb, p_bpnb = n_cols, n_cols + 1
        p_newbo = n_cols + 2
        p_sw = p_newbo + n_bo

        c_idx = ext_idx % k_c
        sel_char = torch.where(is_stay, -1, torch.gather(top_ci, 1, c_idx))
        sel_lp_c = torch.gather(top_lp, 1, c_idx)
        sel_p_b = _f(sel[..., C_PB])
        sel_p_tot = _logsumexp2(sel_p_b, _f(sel[..., C_PNB]))
        sel_is_rep = (sel[..., C_LAST] - 1) == sel_char
        sel_ext_pnb = torch.where(sel_is_rep, sel_p_b, sel_p_tot) + sel_lp_c
        if lm_table is not None:
            sel_ext_lm = torch.gather(ext_lm.reshape(bsz, w * k_c), 1,
                                      ext_idx)
        elif word_lm is not None:
            sel_ext_lm = _f(sel[..., C_LM]) + torch.where(
                sel_char == space, _f(sel[..., p_sw]), 0.0)
        else:
            sel_ext_lm = _f(sel[..., C_LM])

        new_pb = torch.where(is_stay, _f(sel[..., p_bpb]), NEG)
        new_pnb = torch.where(is_stay, _f(sel[..., p_bpnb]), sel_ext_pnb)
        new_lm = torch.where(is_stay, _f(sel[..., C_LM]), sel_ext_lm)
        cplus = sel_char.to(torch.int64) + 1
        p_h1 = _u(sel[..., C_H1])
        p_h2 = _u(sel[..., C_H2])
        p_wh1 = _u(sel[..., C_WH1])
        p_wh2 = _u(sel[..., C_WH2])
        p_ctx = [(_u(sel[..., C_CTX + 2 * j]), _u(sel[..., C_CTX + 2 * j + 1]))
                 for j in range(n_ctxw)]
        p_c1h1, p_c1h2 = p_ctx[0]
        if normalize:
            sel_sep = (p_wh1 == 0) & ((p_c1h1 != 0) | (p_c1h2 != 0))
            sp_u = space + 1
            b1 = torch.where(sel_sep, _add32(_mul32(p_h1, _HASH_P1), sp_u),
                             p_h1)
            b2 = torch.where(sel_sep, _add32(_mul32(p_h2, _HASH_P2), sp_u),
                             p_h2)
            keep = is_stay | (sel_char == space)
            new_hash = torch.where(keep, p_h1,
                                   _add32(_mul32(b1, _HASH_P1), cplus))
            new_hash2 = torch.where(keep, p_h2,
                                    _add32(_mul32(b2, _HASH_P2), cplus))
        else:
            new_hash = torch.where(is_stay, p_h1,
                                   _add32(_mul32(p_h1, _HASH_P1), cplus))
            new_hash2 = torch.where(is_stay, p_h2,
                                    _add32(_mul32(p_h2, _HASH_P2), cplus))
        p_row = sel[..., C_ROW]
        if lm_table is not None:
            ext_row = (p_row % rows_mod) * (v + 1) + (sel_char + 1)
            new_row = torch.where(is_stay, p_row, ext_row)
        else:
            new_row = p_row

        # word-LM state transition (recomputed from parent state + char)
        is_space_ext = (~is_stay) & (sel_char == space)
        shift = is_space_ext & (p_wh1 != 0)
        hold = is_stay | is_space_ext
        new_wh1 = torch.where(hold, torch.where(is_space_ext, 0, p_wh1),
                              _add32(_mul32(p_wh1, _HASH_P1), cplus))
        new_wh2 = torch.where(hold, torch.where(is_space_ext, 0, p_wh2),
                              _add32(_mul32(p_wh2, _HASH_P2), cplus))
        # completed-word context shift: c_1 <- w, c_j <- c_{j-1}
        new_ctx = [(torch.where(shift, p_wh1, p_c1h1),
                    torch.where(shift, p_wh2, p_c1h2))]
        for j in range(1, n_ctxw):
            new_ctx.append((torch.where(shift, p_ctx[j - 1][0], p_ctx[j][0]),
                            torch.where(shift, p_ctx[j - 1][1], p_ctx[j][1])))
        # on word completion the new context's backoff weights are the
        # completed word's own chain rows, fetched above
        new_bo_cols = [torch.where(shift, sel[..., p_newbo + j],
                                   sel[..., c_bo + j]) for j in range(n_bo)]

        # dead slots (filled from NEG-score padding) get poisoned hashes so
        # they never absorb a live extension's probability mass
        dead = top_val <= NEG / 2
        new_hash = torch.where(dead, slot_poison[None], new_hash)
        new_hash2 = torch.where(dead, _M32, new_hash2)
        new_pb = torch.where(dead, NEG, new_pb)
        new_pnb = torch.where(dead, NEG, new_pnb)

        is_ext = sel_char >= 0
        new_plen = sel[..., C_PLEN] + is_ext.to(torch.int32)
        new_last = torch.where(is_ext, sel_char, sel[..., C_LAST] - 1)

        new_st = torch.stack(
            [_i(new_hash), _i(new_hash2), _fi(new_pb), _fi(new_pnb),
             _fi(new_lm), new_last + 1, new_row, new_plen,
             _i(new_wh1), _i(new_wh2)]
            + [_i(h) for pair in new_ctx for h in pair]
            + new_bo_cols, dim=-1)

        # freeze finished utterances; frozen steps record identity
        # backpointers so the backtrace passes through them unchanged
        act2 = (t < lengths)[:, None]
        bp_parent = torch.where(act2, sel_parent, slots).to(torch.int32)
        bp_char = torch.where(act2, sel_char, -1).to(torch.int32)
        return torch.where(act2[:, :, None], new_st, st), bp_parent, bp_char

    parents, chars = [], []
    for t in range(t_max):
        st, bp_p, bp_c = step(st, t)
        parents.append(bp_p)
        chars.append(bp_c)
    parents = torch.stack(parents) if parents else \
        torch.zeros((0, bsz, w), dtype=torch.int32, device=dev)
    chars = torch.stack(chars) if chars else torch.zeros_like(parents)
    if return_raw:
        return st, parents, chars
    return best_path_from_raw(st, parents, chars, word_lm=word_lm,
                              alpha=alpha, beta=beta, wlm_probes=wlm_probes,
                              l_max=l_max)


def best_path_from_raw(st, parents, chars, *, word_lm=None, alpha=0.5,
                       beta=0.0, wlm_probes=8, l_max: int = 0):
    """Final ranking (trailing partial word scored, first maximum wins)
    and the best beam's label ids from a raw search result."""
    t_max, bsz, w = parents.shape
    total = packed_beam_totals(st, word_lm=word_lm, alpha=alpha, beta=beta,
                               wlm_probes=wlm_probes)
    best = torch.argmax(total, dim=1)                         # (B,)
    return reconstruct_best_path(parents, chars, best, w=w, bsz=bsz,
                                 t_max=t_max, l_max=l_max or t_max)


def suffix_maps(parents: torch.Tensor) -> torch.Tensor:
    """(T, B, W) int64 S with S[t] = parents[t] o parents[t+1] o ... o
    parents[T-1]: S[t][b, j] is the index before step t of the beam that
    is j after the last step. ceil(log2 T) doubling passes of one gather
    each, in place of the JAX package's step-by-step reverse scan."""
    t_max = parents.shape[0]
    s = parents.long()
    span = 1
    while span < t_max:
        head = torch.gather(s[:t_max - span], 2, s[span:])
        s = torch.cat([head, s[t_max - span:]])
        span *= 2
    return s


def reconstruct_best_path(parents, chars, best, *, w: int, bsz: int,
                          t_max: int, l_max: int):
    """The best beam's label ids from (T, B, W) backpointers.

    parents[t][b, j] maps a beam index after step t to its index before
    step t. The JAX package walks that chain back with a reverse scan,
    one step at a time; here the suffix compositions
    S[t] = parents[t] o parents[t+1] o ... o parents[T-1] come from
    ceil(log2 T) doubling passes of one gather each (a step-by-step loop
    is T launches on the GPU). The beam index after step t on the best
    path is S[t+1][best]; the output is the same integers."""
    dev = parents.device
    if t_max == 0:
        return (torch.zeros((bsz, l_max), dtype=torch.int32, device=dev),
                torch.zeros((bsz,), dtype=torch.int32, device=dev))
    s = suffix_maps(parents)
    best = best.long().to(dev)
    j_next = torch.gather(s[1:], 2, best[None, :, None].expand(
        t_max - 1, bsz, 1))[..., 0]                           # (T-1, B)
    j_at = torch.cat([j_next, best[None]], 0)                 # (T, B)
    path_chars = torch.gather(chars, 2, j_at[..., None])[..., 0]   # (T, B)

    # compact the emitted chars (char >= 0) to the front, in time order
    cp = path_chars.t()                                       # (B, T)
    vd = cp >= 0
    t_idx = torch.arange(t_max, device=dev)[None]
    order = torch.argsort(torch.where(vd, t_idx, t_max + t_idx), dim=1,
                          stable=True)
    if l_max < t_max:
        take = order[:, :l_max]
    else:
        take = torch.cat([order, order[:, -1:].expand(bsz, l_max - t_max)],
                         dim=1)
    best_prefix = torch.gather(torch.where(vd, cp, 0), 1,
                               take.clamp(max=t_max - 1))
    best_len = vd.sum(dim=1).clamp(max=l_max).to(torch.int32)
    best_prefix = torch.where(
        torch.arange(l_max, device=dev)[None] < best_len[:, None],
        best_prefix, 0).to(chars.dtype)
    return best_prefix, best_len


def device_beam_transcripts(log_probs, lengths, labels: Sequence[str],
                            **kwargs):
    """Run the device beam search and render texts on the host.

    Eligible calls (canonical identity: `space` >= 0 and no char-LM table;
    cutoff_top_n > 0; beam_width <= 128) go to `fused_beam_search`, which
    launches the CUDA kernel on a GPU tensor (its plain version on a CPU
    one); the rest go to `device_beam_search`. Under canonical identity the
    surviving representative's char path may carry redundant spaces that
    its identity ignores; rendering collapses them."""
    log_probs = torch.as_tensor(log_probs)
    lengths = torch.as_tensor(lengths).to(log_probs.device)
    eligible = (kwargs.get("lm_table") is None
                and kwargs.get("space", -1) >= 0
                and kwargs.get("cutoff_top_n", 0) > 0
                and kwargs.get("beam_width", 16) <= KERNEL_MAX_BEAM_WIDTH)
    if eligible:
        from vietasr_tpu_torch.ops.fused_beam import fused_beam_search

        fk = {k: val for k, val in kwargs.items()
              if k in ("beam_width", "cutoff_top_n", "alpha", "beta", "space",
                       "max_len", "word_lm", "wlm_probes")}
        ids, lens = fused_beam_search(log_probs, lengths, blank=len(labels),
                                      **fk)
    else:
        ids, lens = device_beam_search(log_probs, lengths, blank=len(labels),
                                       **kwargs)
    packed = torch.cat([lens.to(ids.dtype)[:, None], ids], 1).cpu().numpy()
    lens, ids = packed[:, 0], packed[:, 1:]
    texts = ["".join(labels[i] for i in ids[b, : lens[b]])
             for b in range(ids.shape[0])]
    if kwargs.get("space", -1) >= 0 and kwargs.get("lm_table") is None:
        texts = [" ".join(t.split()) for t in texts]
    return texts
