"""Conformer-CTC encoder (counterpart of vietasr_tpu/models/conformer.py):
init, the inference forward and the training forward.

Macaron FFN halves, multi-head self-attention with Transformer-XL relative
positions, the conv module (pointwise GLU -> masked depthwise -> BN ->
swish -> pointwise), all pre-norm; 4x subsampling by two k3 s2 conv2d
stages or by frame stacking. Activations are (B, T, D), channels last.

Variables are the JAX package's tree with torch tensors for leaves:
`{"params": {"sub1", "sub2" (conv2d mode), "proj", "blocks": [block, ...],
"decoder"}, "batch_stats": {"blocks": [{"conv_bn": ...}, ...]}}`; conv2d
weights are HWIO and depthwise weights (K, D), as in JAX, so
models/convert.py carries a JAX tree across unchanged. `conformer_apply`
is a plain function over that tree, as `quartznet_apply` is.

Precision follows the JAX package's rounding points for
`compute_dtype=bfloat16`: matmul and conv operands are rounded to bf16 and
accumulate in fp32 (JAX's `preferred_element_type=float32`); `_linear`
rounds after its fp32 bias; the residual stream, LayerNorm outputs, GLU
and FFN swish are bf16 tensors; qkv, the position term's `ws*sq + wc*cq`,
the scores, softmax and the head's log-softmax are fp32; the depthwise and
conv2d outputs round to bf16 before their fp32 bias / BN. Every product
runs as an fp32 GEMM or convolution of the rounded values: a bf16 value is
exact in TF32, so on the GPU the forward allows TF32 tensor cores in bf16
mode (the same products and fp32 accumulation) and forbids them in fp32
mode (`utils/device.py`). The attention is written out (scores, masked
softmax, product), not routed through a fused library attention, which
would move the rounding points.

The relative-position term is the JAX package's matmul form (no
Transformer-XL shift): with w[i] = W_pos^T qv[i] and sinusoids of angle
o * w_m, pos[i, j] = w[i] . e_{i-j} = sum_m (ws si + wc ci)[i, m] cos(j w_m)
+ (wc si - ws ci)[i, m] sin(j w_m). The sin/cos tables are those of the
fp32 angles (float64 positions times float64 frequencies, rounded), taken
in float64 and rounded once; XLA's fp32 sin may differ in the last bit.
`_rel_shift` is kept as the oracle the tests hold the matmul form to.

Training (`training=True`) draws dropout at JAX's six sites a block (the
two FFN halves' inner and outer, attention, conv module) from the
caller's torch.Generator, in JAX's order (the draws themselves differ from
JAX's keys), and runs the conv module's BN on batch statistics, returning
the new running stats. `remat=True` recomputes each block in the backward
pass (torch.utils.checkpoint, non-reentrant): the block's dropout masks
come from a copy of the generator's state taken before the block, so the
recomputation draws the same masks. `scan_blocks` runs the same loop, the
JAX package's own test holds its scan equal to the unrolled blocks.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch.utils.checkpoint

import numpy as np
import torch
import torch.nn.functional as F

from vietasr_tpu_torch.config import ConformerConfig
from vietasr_tpu_torch.models.layers import (batchnorm_apply, dropout,
                                             init_batchnorm, length_mask,
                                             symmetric_uniform,
                                             xavier_uniform)
from vietasr_tpu_torch.parallel.collectives import (copy_to_group,
                                                    reduce_from_group)
from vietasr_tpu_torch.utils.device import exact_tensor_cores, strict_fp32

# matmul / conv weights of the tree, by key, which the forward rounds to
# the compute dtype (biases, LayerNorm, BN and u / vb stay fp32)
_MATMUL_KEYS = ("w", "dw")


def _range(name: str):
    """While a torch.profiler records, a range around part of the forward
    ("conformer.subsample", "conformer.mhsa", "conformer.depthwise"), so
    a trace can attribute device time to it (chip_smoke.py phase 11);
    otherwise nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of compute-dtype operands with fp32 accumulation and result
    (bf16 values widen exactly)."""
    return torch.matmul(a.float(), b.float())


def _linear(x, p, cast):
    return cast(_mm(cast(x), cast(p["w"])) + p["b"])


def _linear_rows(x, p, cast, tp_group):
    """_linear of a row-sharded weight: the partial products are summed
    over `tp_group` before the bias is added once."""
    return cast(reduce_from_group(_mm(cast(x), cast(p["w"])), tp_group)
                + p["b"])


def _layernorm(x, p, eps: float = 1e-5):
    """fp32 statistics, one pass (E[x^2] - E[x]^2, clamped at 0), as JAX;
    the output returns to the stream's dtype."""
    x32 = x.float()
    m = torch.mean(x32, dim=-1, keepdim=True)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    v = torch.clamp_min(ms - m * m, 0.0)
    y = (x32 - m) * torch.rsqrt(v + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def _sigmoid(x):
    """1 / (1 + exp(-x)), each op in x's dtype: the form XLA expands the
    logistic into, so bf16 rounds where JAX's does."""
    return 1.0 / (1.0 + torch.exp(-x))


def _swish(x):
    return x * _sigmoid(x)


# ---------------------------------------------------------------------------
# init


def _linear_init(generator, fan_in: int, fan_out: int, device):
    return {"w": xavier_uniform(generator, (fan_in, fan_out), fan_in,
                                fan_out, device=device),
            "b": symmetric_uniform(generator, (fan_out,), fan_in ** -0.5,
                                   device=device)}


def _layernorm_init(d: int, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def _init_block(generator, cfg: ConformerConfig, device):
    d, h = cfg.d_model, cfg.num_heads
    ff = cfg.ff_expansion * d
    k = cfg.conv_kernel

    def lin(a, b):
        return _linear_init(generator, a, b, device)

    ff1 = {"ln": _layernorm_init(d, device), "in": lin(d, ff),
           "out": lin(ff, d)}
    mhsa = {"ln": _layernorm_init(d, device), "q": lin(d, d),
            "k": lin(d, d), "v": lin(d, d),
            "pos": {"w": xavier_uniform(generator, (d, d), d, d,
                                        device=device)},
            "out": lin(d, d),
            # Transformer-XL global content / position biases
            "u": torch.zeros((h, d // h), device=device),
            "vb": torch.zeros((h, d // h), device=device)}
    bn_p, bn_s = init_batchnorm(d, device=device)
    conv = {"ln": _layernorm_init(d, device), "pw1": lin(d, 2 * d),
            "dw": xavier_uniform(generator, (k, d), k, d * k, device=device),
            "bn": bn_p, "pw2": lin(d, d)}
    ff2 = {"ln": _layernorm_init(d, device), "in": lin(d, ff),
           "out": lin(ff, d)}
    params = {"ff1": ff1, "mhsa": mhsa, "conv": conv, "ff2": ff2,
              "final_ln": _layernorm_init(d, device)}
    return params, {"conv_bn": bn_s}


def init_conformer(generator: Optional[torch.Generator],
                   cfg: ConformerConfig, feat_in: int, num_classes: int, *,
                   device=None) -> dict:
    """The variables tree of `cfg`, drawn from `generator` (on `device`;
    None: the device's default generator) in the JAX package's key order:
    the subsampling convs, the projection, the head, then each block. JAX
    splits keys instead: the shapes and distributions are the same, the
    values differ."""
    c = cfg.subsampling_channels
    params: dict = {}
    if cfg.subsampling_mode == "stack":
        proj_in = 4 * feat_in
    else:
        params["sub1"] = {"w": xavier_uniform(generator, (3, 3, 1, c), 9,
                                              9 * c, device=device),
                          "b": torch.zeros(c, device=device)}
        params["sub2"] = {"w": xavier_uniform(generator, (3, 3, c, c), 9 * c,
                                              9 * c, device=device),
                          "b": torch.zeros(c, device=device)}
        proj_in = c * (feat_in // 4)
    params["proj"] = _linear_init(generator, proj_in, cfg.d_model, device)
    params["blocks"] = []
    params["decoder"] = _linear_init(generator, cfg.d_model, num_classes + 1,
                                     device)
    stats: dict = {"blocks": []}
    for _ in range(cfg.num_blocks):
        p, s = _init_block(generator, cfg, device)
        params["blocks"].append(p)
        stats["blocks"].append(s)
    return {"params": params, "batch_stats": stats}


def cast_matmul_weights(variables: dict, compute_dtype: Optional[torch.dtype]
                        ) -> dict:
    """The tree with every matmul / conv weight stored in the compute dtype
    once, the values the forward would round them to; biases and norms stay
    fp32, where the forward adds them."""
    if compute_dtype is None:
        return variables

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (v.to(compute_dtype) if k in _MATMUL_KEYS
                        and torch.is_tensor(v) else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return tree

    return {"params": walk(variables["params"]),
            "batch_stats": variables["batch_stats"]}


# ---------------------------------------------------------------------------
# relative-position MHSA


def rel_pos_encoding_range(max_off: int, min_off: int, d: int) -> np.ndarray:
    """Sinusoidal encodings of the relative offsets max_off, max_off - 1,
    ..., min_off: (max_off - min_off + 1, d) fp32, computed in float64.
    The streamer reads these; the offline forward's tables have the same
    frequencies."""
    pos = np.arange(max_off, min_off - 1, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * (-np.log(10000.0) / d))
    enc = np.zeros((pos.shape[0], d))
    enc[:, 0::2] = np.sin(pos * div)
    enc[:, 1::2] = np.cos(pos * div)
    return enc.astype(np.float32)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T): out[i, j] = x[i, (T-1) - i + j],
    the entry of relative offset i - j in the [T-1 ... -(T-1)] order (the
    Transformer-XL shift). The oracle of the matmul form."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))                                  # (B, H, T, 2T)
    flat = x.reshape(b, h, 2 * t * t)[:, :, t - 1: t - 1 + t * (2 * t - 1)]
    return flat.reshape(b, h, t, 2 * t - 1)[:, :, :, :t]


def position_tables(t: int, d: int, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(sin, cos) of the fp32 angles position * w_m, (T, D/2) each: the
    angles from float64 positions and frequencies rounded to fp32, their
    sin and cos taken in float64 and rounded once."""
    inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * (-np.log(10000.0) / d))
    pos = torch.arange(t, dtype=torch.float64, device=device)
    ang = (pos[:, None] * inv[None, :]).float().double()
    return torch.sin(ang).float(), torch.cos(ang).float()


def _mhsa(x, params, mask, cfg: ConformerConfig, pos_enc, scale, cast,
          tp_group=None):
    """Relative-position MHSA. Under tensor parallelism `params` holds this
    rank's heads (the q / k / v / pos columns, u / vb rows, out rows of
    parallel/tp.py), and the output projection sums over `tp_group`."""
    b, t, d = x.shape
    x = copy_to_group(x, tp_group)
    dh = d // cfg.num_heads
    h = params["u"].shape[0]                # this rank's heads
    dl = h * dh
    # one (D, 3D) product for q/k/v; its fp32 bias added before rounding
    w_qkv = torch.cat([cast(params[n]["w"]) for n in "qkv"], 1)
    b_qkv = torch.cat([params[n]["b"] for n in "qkv"])
    qkv = cast(_mm(cast(x), w_qkv) + b_qkv)
    q, k, v = (a.reshape(b, t, h, dh).transpose(1, 2)       # (B, H, T, dh)
               for a in qkv.split(dl, dim=-1))
    qu = q + params["u"][None, :, None]                   # fp32
    qv = q + params["vb"][None, :, None]
    content = _mm(cast(qu), cast(k).transpose(2, 3))      # (B, H, T, S)
    si, ci = pos_enc                                      # (T, D/2)
    wp = cast(params["pos"]["w"])
    # (H, dh, D/2) sin and cos rows of W_pos per head
    w_sin = wp[0::2].reshape(d // 2, h, dh).permute(1, 2, 0)
    w_cos = wp[1::2].reshape(d // 2, h, dh).permute(1, 2, 0)
    qv = cast(qv)
    ws = _mm(qv, w_sin)                                   # (B, H, T, D/2)
    wc = _mm(qv, w_cos)
    position = (_mm(cast(ws * si + wc * ci), cast(ci).t())
                + _mm(cast(wc * si - ws * ci), cast(si).t()))
    scores = (content + position) / scale
    if mask.ndim == 2:                                    # (B, S) keys only
        mask = mask[:, None, None, :]
    scores = torch.where(mask, scores, -1e30)
    attn = torch.softmax(scores, dim=-1)
    out = _mm(cast(attn), cast(v))                        # (B, H, T, dh)
    return _linear_rows(out.transpose(1, 2).reshape(b, t, dl),
                        params["out"], cast, tp_group)


# ---------------------------------------------------------------------------
# conv module, FFN, subsampling


def _depthwise(y, w, pad: Tuple[int, int], cast):
    """Depthwise conv of (B, T, D) by w (K, D), time padded (left, right),
    fp32 accumulation, the result rounded to the compute dtype (JAX's conv
    output dtype) and returned in fp32."""
    d = w.shape[1]
    yt = F.pad(cast(y).float().transpose(1, 2), pad)
    z = F.conv1d(yt, cast(w).float().t().unsqueeze(1), groups=d)
    return cast(z.transpose(1, 2)).float()


def _conv_module(x, params, stats, lens, cast, causal: bool,
                 training: bool = False, bn_group=None):
    y = _layernorm(x, params["ln"])
    y = _linear(y, params["pw1"], cast)                   # (B, T, 2D)
    a, g = y.chunk(2, dim=-1)
    y = a * _sigmoid(g)                                   # GLU
    y = y * length_mask(y.shape[1], lens, y.dtype)        # mask before conv
    k = params["dw"].shape[0]
    pad = (k - 1, 0) if causal else (k // 2, k // 2)
    with _range("conformer.depthwise"):
        y = _depthwise(y, params["dw"], pad, cast)
    y, new_bn = batchnorm_apply(y, params["bn"], stats["conv_bn"],
                                training=training, group=bn_group)
    y = cast(_swish(y))
    return _linear(y, params["pw2"], cast), {"conv_bn": new_bn}


def _ffn(x, params, cast, drop=lambda a: a, tp_group=None):
    y = copy_to_group(_layernorm(x, params["ln"]), tp_group)
    y = drop(_swish(_linear(y, params["in"], cast)))
    return _linear_rows(y, params["out"], cast, tp_group)


def _stack_subsample(x, lens):
    """Frame stacking: (B, T, F) -> (B, ceil(T/4), 4F); each output frame
    is its own 4 inputs, so it is causal as it stands."""
    b, t, f = x.shape
    pad = (-t) % 4
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(b, (t + pad) // 4, 4 * f), \
        torch.div(lens + 3, 4, rounding_mode="floor")


def conv2d_stage(y, p, tpad: Tuple[int, int], cast):
    """One k3 s2 conv2d stage on NCHW (B, Cin, T, F): time padded `tpad`,
    frequency (1, 1), HWIO weights; the conv output rounds to the compute
    dtype, then the fp32 bias and ReLU, then the compute dtype again."""
    w = cast(p["w"]).float().permute(3, 2, 0, 1)          # HWIO -> OIHW
    y = F.conv2d(F.pad(cast(y).float(), (1, 1) + tuple(tpad)), w, stride=2)
    y = cast(y).float() + p["b"][None, :, None, None]
    return cast(torch.relu(y))


def _subsample(x, lens, params, cast, causal: bool):
    """Conv2d 4x subsampling: (B, T, F) -> (B, T/4, C * F/4), the features
    flattened as JAX's NHWC reshape does (index f * C + c). causal=True
    pads time (2, 0) instead of (1, 1): the same length, past input only."""
    tpad = (2, 0) if causal else (1, 1)
    y = x[:, None]                                        # (B, 1, T, F)
    for name in ("sub1", "sub2"):
        y = conv2d_stage(y, params[name], tpad, cast)
        lens = torch.div(lens + 2 - 3, 2, rounding_mode="floor") + 1
    b, c, t, f = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, t, f * c), lens


def conformer_apply(
    variables: dict,
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    *,
    cfg: ConformerConfig,
    compute_dtype: Optional[torch.dtype] = None,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
    bn_group=None,
    tp_group=None,
):
    """feats (B, T, F) -> (log_probs (B, T', V + 1) fp32, out_lens (B,)
    int32); with training=True also the new batch stats, as
    quartznet_apply returns them. With `cfg.chunk_size > 0` the attention
    is chunked-causal (a query sees its chunk and `left_chunks` chunks
    before it) and the convolutions pad on the left only.

    `bn_group` (a process group) takes the conv module's training-mode BN
    statistics over the global batch of its ranks. `tp_group` runs the
    blocks tensor-parallel over its ranks: `variables` is then this rank's
    shard (parallel/tp.py shard_conformer_variables), and every rank of
    the group returns the whole output. Dropout draws in a tensor-parallel
    forward must be the same on every rank of `tp_group` (one generator
    seed), and the FFN's inner dropout acts on this rank's columns."""
    if compute_dtype is None or compute_dtype == torch.float32:
        flags, cast = strict_fp32(), (lambda a: a)
    elif compute_dtype in (torch.bfloat16, torch.float16):
        flags = exact_tensor_cores()
        cast = lambda a: a.to(compute_dtype)              # noqa: E731
    else:
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    with flags:
        log_probs, lens, new_stats = _apply(
            variables, feats, feat_lens, cfg, cast, training, generator,
            remat, (bn_group, tp_group))
    if training:
        return log_probs, lens, new_stats
    return log_probs, lens


def _block(x, bp, bstat, lens, att_mask, cfg: ConformerConfig, pos_enc,
           scale, cast, chunked: bool, training: bool, groups, generator):
    """One Conformer block; dropout at JAX's sites in JAX's order. `groups`
    is (bn_group, tp_group)."""
    rate = cfg.dropout
    bn_group, tp_group = groups

    def drop(a):
        return dropout(a, rate, generator, training)

    x = x + 0.5 * drop(_ffn(x, bp["ff1"], cast, drop, tp_group))
    with _range("conformer.mhsa"):
        attn = _mhsa(_layernorm(x, bp["mhsa"]["ln"]), bp["mhsa"], att_mask,
                     cfg, pos_enc, scale, cast, tp_group)
    x = x + drop(attn)
    conv, new_stats = _conv_module(x, bp["conv"], bstat, lens, cast, chunked,
                                   training, bn_group)
    x = x + drop(conv)
    x = x + 0.5 * drop(_ffn(x, bp["ff2"], cast, drop, tp_group))
    return _layernorm(x, bp["final_ln"]), new_stats


def _remat_block(x, generator, *args):
    """_block under torch.utils.checkpoint. With a generator, the block
    draws from a copy made from the generator's state before it (the
    recomputation makes the same copy) and the generator then moves on to
    the copy's end state, as if the block had drawn from it."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(
            _block, x, *args, None, use_reentrant=False)
    start = generator.get_state()
    end = {}

    def run(x):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = _block(x, *args, g)
        end.setdefault("state", g.get_state())
        return out

    out = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
    generator.set_state(end["state"])
    return out


def _apply(variables, feats, feat_lens, cfg: ConformerConfig, cast,
           training: bool, generator, remat: bool, groups=(None, None)):
    params = variables["params"]
    stats = variables["batch_stats"]
    chunked = cfg.chunk_size > 0
    with _range("conformer.subsample"):
        if cfg.subsampling_mode == "stack":
            x, lens = _stack_subsample(feats, feat_lens)
        else:
            x, lens = _subsample(feats, feat_lens, params, cast,
                                 causal=chunked)
    x = _linear(x, params["proj"], cast)      # the stream's dtype from here

    t = x.shape[1]
    pos_enc = position_tables(t, cfg.d_model, x.device)
    # sqrt(d_head) in fp32, divided by as JAX does
    scale = torch.full((1,), float(cfg.d_model // cfg.num_heads),
                       device=x.device).sqrt()
    mask = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    x = x * mask[..., None].to(x.dtype)
    if chunked:
        # query i sees key chunks [chunk(i) - left_chunks, chunk(i)]
        ci = torch.arange(t, device=x.device) // cfg.chunk_size
        ok = (ci[None, :] <= ci[:, None]) \
            & (ci[None, :] >= ci[:, None] - cfg.left_chunks)    # (T, S)
        att_mask = mask[:, None, None, :] & ok[None, None]      # (B,1,T,S)
    else:
        att_mask = mask

    new_stats = {"blocks": []}
    for bp, bstat in zip(params["blocks"], stats["blocks"]):
        args = (bp, bstat, lens, att_mask, cfg, pos_enc, scale, cast,
                chunked, training, groups)
        if remat:
            x, st = _remat_block(x, generator, *args)
        else:
            x, st = _block(x, *args, generator)
        new_stats["blocks"].append(st)

    logits = _linear(x, params["decoder"], cast)
    return (torch.log_softmax(logits.float(), dim=-1), lens.to(torch.int32),
            new_stats)


def num_params(variables: dict) -> int:
    """Parameter count of a variables tree's `params`."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(count(v) for v in tree)
        return int(np.prod(tree.shape))

    return count(variables["params"])


__all__ = ["ConformerConfig", "init_conformer", "conformer_apply",
           "rel_pos_encoding_range", "cast_matmul_weights", "num_params",
           "position_tables"]
