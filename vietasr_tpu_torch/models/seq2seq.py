"""Attention seq2seq (counterpart of vietasr_tpu/models/seq2seq.py): the
GRU encoder and decoder, Luong attention, the greedy and beam generators,
the Jasper-to-RNN connector of the LAS recipes and `las_evaluate`.

The weights keep the JAX package's layout (a GRU's `wi` is (in, 3H) with
the gates in torch's order r, z, n), so `models/convert.py::
params_from_jax` carries a JAX tree across as it is. The cell is stepped
here rather than through `torch.nn.GRU`, because the encoder's padded
steps hold the last valid state in their outputs (JAX's masked scan),
where a packed `torch.nn.GRU` gives zeros.

The generators run a fixed `max_len` steps over the whole batch, as JAX's
scans do: a finished row (greedy) or beam keeps its state and emits only
eos. The beam takes its top W candidates by a stable descending sort, so
among equal scores the lower index wins, as `jax.lax.top_k` has it; ties
are common once beams finish, since -1e30 + x rounds to -1e30 in fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vietasr_tpu_torch.models.layers import xavier_uniform
from vietasr_tpu_torch.train.metrics import word_error_rate

NEG_INF = -1e30


def _gru_init(generator, in_dim: int, hidden: int, device=None) -> dict:
    return {
        "wi": xavier_uniform(generator, (in_dim, 3 * hidden), in_dim,
                             3 * hidden, device=device),
        "wh": xavier_uniform(generator, (hidden, 3 * hidden), hidden,
                             3 * hidden, device=device),
        "bi": torch.zeros((3 * hidden,), device=device),
        "bh": torch.zeros((3 * hidden,), device=device),
    }


def _gru_step(p: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One GRU cell step (gates r, z, n, as torch.nn.GRU)."""
    i_r, i_z, i_n = torch.chunk(x @ p["wi"] + p["bi"], 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(h @ p["wh"] + p["bh"], 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def init_encoder_rnn(generator, in_dim: int, hidden: int, *, device=None
                     ) -> dict:
    return {"gru": _gru_init(generator, in_dim, hidden, device)}


def encoder_rnn_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor):
    """x (B, T, D) -> (outputs (B, T, H), final state (B, H)). A step past
    a row's length keeps the state, and outputs it."""
    b, t, _ = x.shape
    hidden = params["gru"]["wh"].shape[0]
    valid = torch.arange(t, device=x.device)[None, :] \
        < lengths.to(x.device)[:, None]                         # (B, T)
    h = torch.zeros((b, hidden), dtype=x.dtype, device=x.device)
    outs = []
    for i in range(t):
        h_new = _gru_step(params["gru"], h, x[:, i])
        h = torch.where(valid[:, i, None], h_new, h)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def init_attention(generator, hidden: int, *, device=None) -> dict:
    return {"w": xavier_uniform(generator, (hidden, hidden), hidden, hidden,
                                device=device)}


def attention_apply(params: dict, query: torch.Tensor, keys: torch.Tensor,
                    key_lengths: torch.Tensor):
    """Luong "general" attention: query (B, H), keys (B, S, H) ->
    (context (B, H), weights (B, S)); keys past a row's length score
    -1e30."""
    scores = torch.einsum("bh,bsh->bs", query @ params["w"], keys)
    mask = torch.arange(keys.shape[1], device=keys.device)[None, :] \
        < key_lengths.to(keys.device)[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bs,bsh->bh", weights, keys), weights


def init_decoder_rnn(generator, vocab: int, hidden: int, *, device=None
                     ) -> dict:
    """The embedding (0.1 * N(0, 1)), the GRU, the attention and the
    output layer over [h, context], drawn from `generator` in that
    order."""
    embed = 0.1 * torch.randn((vocab, hidden), generator=generator,
                              device=device)
    return {
        "embed": embed,
        "gru": _gru_init(generator, hidden, hidden, device),
        "attn": init_attention(generator, hidden, device=device),
        "out": {"w": xavier_uniform(generator, (2 * hidden, vocab),
                                    2 * hidden, vocab, device=device),
                "b": torch.zeros((vocab,), device=device)},
    }


def decoder_rnn_step(params: dict, h: torch.Tensor, token: torch.Tensor,
                     enc_outputs: torch.Tensor, enc_lengths: torch.Tensor):
    """One autoregressive step -> (new h (B, H), log_probs (B, V))."""
    h = _gru_step(params["gru"], h, params["embed"][token.long()])
    context, _ = attention_apply(params["attn"], h, enc_outputs, enc_lengths)
    logits = torch.cat([h, context], dim=-1) @ params["out"]["w"] \
        + params["out"]["b"]
    return h, torch.log_softmax(logits, dim=-1)


def decoder_rnn_apply(params: dict, targets: torch.Tensor,
                      init_state: torch.Tensor, enc_outputs: torch.Tensor,
                      enc_lengths: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode: targets (B, L) -> log_probs (B, L, V)."""
    h, lps = init_state, []
    for i in range(targets.shape[1]):
        h, lp = decoder_rnn_step(params, h, targets[:, i], enc_outputs,
                                 enc_lengths)
        lps.append(lp)
    return torch.stack(lps, dim=1)


# ---------------------------------------------------------------------------
# autoregressive generators


def greedy_generate(params: dict, init_state: torch.Tensor,
                    enc_outputs: torch.Tensor, enc_lengths: torch.Tensor, *,
                    bos_id: int, eos_id: int, max_len: int):
    """(tokens (B, max_len) int32, lengths (B,) int32). A row's length
    counts its steps up to and including the one that emitted eos; after
    it the row emits eos and keeps its state."""
    b = enc_outputs.shape[0]
    dev = enc_outputs.device
    h = init_state
    tok = torch.full((b,), bos_id, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    length = torch.zeros((b,), dtype=torch.int32, device=dev)
    toks = []
    for _ in range(max_len):
        h_new, lp = decoder_rnn_step(params, h, tok, enc_outputs,
                                     enc_lengths)
        nxt = torch.argmax(lp, dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        h = torch.where(done[:, None], h, h_new)
        length = length + (~done).to(torch.int32)
        done = done | (nxt == eos_id)
        tok = nxt
        toks.append(nxt)
    return torch.stack(toks, dim=1), length


def beam_generate(params: dict, init_state: torch.Tensor,
                  enc_outputs: torch.Tensor, enc_lengths: torch.Tensor, *,
                  bos_id: int, eos_id: int, max_len: int, beam_width: int,
                  len_penalty: float = 0.0):
    """Beam search over a flattened (B * W) batch: the best (tokens
    (B, max_len) int32, score (B,)) of each row. Beam 0 starts live and
    the others at -1e30. A finished beam keeps its score and state and
    extends only by eos. With `len_penalty` p, a final score is divided by
    (len + 1e-6)^p, len counting the tokens that are neither eos nor 0."""
    b = enc_outputs.shape[0]
    w = beam_width
    dev = enc_outputs.device
    vocab = params["out"]["b"].shape[0]
    enc_t = torch.repeat_interleave(enc_outputs, w, dim=0)
    len_t = torch.repeat_interleave(enc_lengths, w, dim=0)
    h = torch.repeat_interleave(init_state, w, dim=0)
    scores = torch.tensor([0.0] + [NEG_INF] * (w - 1),
                          device=dev).repeat(b)
    tok = torch.full((b * w,), bos_id, dtype=torch.int32, device=dev)
    done = torch.zeros((b * w,), dtype=torch.bool, device=dev)
    toks = torch.zeros((b * w, max_len), dtype=torch.int32, device=dev)
    only_eos = torch.where(torch.arange(vocab, device=dev) == eos_id,
                           0.0, NEG_INF)[None, :]
    row_base = (torch.arange(b, device=dev) * w)[:, None]
    for t in range(max_len):
        h_new, lp = decoder_rnn_step(params, h, tok, enc_t, len_t)
        lp = torch.where(done[:, None], only_eos, lp)
        cand = (scores[:, None] + lp).reshape(b, w * vocab)
        top_scores, top_idx = torch.sort(cand, dim=1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :w], top_idx[:, :w]
        parent = (torch.div(top_idx, vocab, rounding_mode="floor")
                  + row_base).reshape(b * w)
        token = (top_idx % vocab).to(torch.int32).reshape(b * w)
        h = torch.where(done[parent][:, None], h[parent], h_new[parent])
        done = done[parent] | (token == eos_id)
        toks = toks[parent]
        toks[:, t] = token
        tok, scores = token, top_scores.reshape(b * w)
    if len_penalty:
        lengths = torch.sum((toks != eos_id) & (toks != 0), dim=1)
        scores = scores / ((lengths.to(torch.float32) + 1e-6)
                           ** len_penalty)
    scores = scores.reshape(b, w)
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(b, device=dev)
    return toks.reshape(b, w, max_len)[rows, best], scores[rows, best]


# ---------------------------------------------------------------------------
# LAS glue: the Jasper/QuartzNet encoder's output into the RNN decoder


def init_jasper_rnn_connector(generator, in_channels: int, out_channels: int,
                              *, device=None) -> dict:
    """A 1x1 convolution (xavier (C_in, C_out), zero bias) and a batch
    norm (scale 1, bias 0, running mean 0 and variance 1)."""
    return {
        "w": xavier_uniform(generator, (in_channels, out_channels),
                            in_channels, out_channels, device=device),
        "b": torch.zeros((out_channels,), device=device),
        "scale": torch.ones((out_channels,), device=device),
        "bias": torch.zeros((out_channels,), device=device),
        "mean": torch.zeros((out_channels,), device=device),
        "var": torch.ones((out_channels,), device=device),
    }


def jasper_rnn_connector_apply(params: dict, feats: torch.Tensor,
                               lengths: torch.Tensor, *,
                               training: bool = False, momentum: float = 0.9,
                               eps: float = 1e-5):
    """(B, T, C_in) encoder features -> ((B, T, C_out), new_params): the
    1x1 convolution, then the batch norm, zero past each row's length. In
    training the statistics are the biased mean and variance over the
    valid frames (at least 1), and new_params is a new dict whose running
    stats are momentum * old + (1 - momentum) * new; in eval it is
    `params` itself."""
    x = torch.einsum("btc,cd->btd", feats, params["w"]) + params["b"]
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths.to(x.device)[:, None])[..., None]
    if training:
        n = torch.clamp_min(torch.sum(mask), 1).to(torch.float32)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        mean = torch.sum(torch.where(mask, x, zero), dim=(0, 1)) / n
        var = torch.sum(torch.where(mask, (x - mean) ** 2, zero),
                        dim=(0, 1)) / n
        new_params = dict(params)
        new_params["mean"] = momentum * params["mean"] \
            + (1 - momentum) * mean
        new_params["var"] = momentum * params["var"] + (1 - momentum) * var
    else:
        mean, var = params["mean"], params["var"]
        new_params = params
    x = (x - mean) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return torch.where(mask, x, torch.zeros_like(x)), new_params


def las_evaluate(generated_ids, target_texts: Sequence[str],
                 labels: Sequence[str], *, eos_id: int, pad_id: int = 0
                 ) -> dict:
    """Corpus WER and CER of generations against `target_texts`: each row
    read up to its first eos, pad ids skipped, ids outside `labels`
    dropped. Returns {"wer", "cer", "hypotheses"}."""
    if torch.is_tensor(generated_ids):
        generated_ids = generated_ids.cpu().numpy()
    hyps = []
    for row in np.asarray(generated_ids):
        chars = []
        for t in row:
            t = int(t)
            if t == eos_id:
                break
            if t == pad_id:
                continue
            if 0 <= t < len(labels):
                chars.append(labels[t])
        hyps.append("".join(chars))
    return {
        "wer": word_error_rate(hyps, list(target_texts), use_cer=False),
        "cer": word_error_rate(hyps, list(target_texts), use_cer=True),
        "hypotheses": hyps,
    }
