"""QuartzNet/Jasper encoder + CTC head (counterpart of
vietasr_tpu/models/quartznet.py): init, inference and training forward.

Variables are the JAX package's tree with torch tensors for leaves:
`{"params": {"encoder": [block, ...], "decoder": {"w", "b"}},
"batch_stats": {"encoder": [...]}}`, each block `{"sub": [...], "res":
[...], "se": []}`. `quartznet_apply` is a plain function over that tree,
as in JAX, so each weight is found under the same path in both packages
(models/convert.py loads it). `init_quartznet` builds the unfolded tree
from a `torch.Generator`.

Block routing. A block that `block_eligible` accepts (separable, stride 1,
folded BN: blocks 1-13 of QuartzNet12x1) goes through the fused repeat
block kernel (ops/repeat_block.py) whenever the compute dtype is bf16 and
`block_impl` is "auto" or "kernel": this is the encoder's main-path kernel
on the GPU (in the JAX package the Pallas block was opt-in, through
`block_impl="pallas"`). `block_impl="plain"` runs the same blocks through
the kernel's plain PyTorch version. Other blocks, and every block outside
bf16, take the per-op path (`_apply_block_ops`), as JAX's default XLA path
does: blocks 0 (stride 2) and 14 (dense 1x1) and the head always do. In
training every block takes the per-op path: BN is unfolded and uses batch
statistics, which the fused block cannot (JAX's `block_eligible` refuses
training too).

bf16 semantics follow the JAX package: convolutions take bf16 operands,
1x1 products accumulate in fp32 and return fp32, biases and BN are fp32,
and the head's log-softmax is fp32.

`pw_fn(tag, x, w)` intercepts every 1x1 product of the per-op path, at
JAX's call sites and tags: "enc{i}.sub{r}" (separable, ungrouped
sub-layers), "enc{i}.res{p}" (residual panes) and "dec" (the head).
models/quantize.py calibrates and serves int8 through it. A pw_fn other
than the default turns the fused repeat-block route off for every block,
as in JAX. A folded bias adds in the dtype pw_fn returns (an int8 site
returns the compute dtype), as JAX's `x + cast(b)` does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from vietasr_tpu_torch.config import BlockConfig, EncoderConfig
from vietasr_tpu_torch.models.layers import (batchnorm_apply,
                                             conv_out_length, dense_conv1d,
                                             depthwise_conv1d, dropout,
                                             fold_bn_into_conv,
                                             init_batchnorm, kaiming_uniform,
                                             mask_padding, pointwise_conv,
                                             symmetric_uniform,
                                             xavier_uniform)
from vietasr_tpu_torch.ops.repeat_block import (block_eligible,
                                                fused_repeat_block,
                                                fused_repeat_block_plain)

BLOCK_IMPLS = ("auto", "kernel", "plain")


def map_tree(fn: Callable, tree):
    """Apply fn to every tensor/array leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def assign_tree(dst, src, where: Optional[torch.Tensor] = None) -> None:
    """dst <- src leaf by leaf, matched by key, in place; with `where` (a
    0-d bool tensor) only where it holds."""
    if isinstance(dst, dict):
        for k in dst:
            assign_tree(dst[k], src[k], where)
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            assign_tree(a, b, where)
    else:
        dst.copy_(src if where is None else torch.where(where, src, dst))


def tree_leaves(tree) -> list:
    """The tensor/array leaves of a dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _check_supported(cfg: EncoderConfig) -> None:
    if cfg.activation != "relu" or cfg.residual_mode != "add":
        raise NotImplementedError(
            "only activation='relu' with residual_mode='add' is ported")
    for b in cfg.blocks:
        if b.groups > 1 or b.heads != -1 or b.se or b.residual_dense:
            raise NotImplementedError(
                "grouped, multi-head, SE and dense-residual blocks are not "
                "ported yet")


def _conv_init(generator, shape, mode: str, fan_in: int, fan_out: int,
               device):
    if mode == "xavier_uniform":
        return xavier_uniform(generator, shape, fan_in, fan_out,
                              device=device)
    if mode == "kaiming_uniform":
        return kaiming_uniform(generator, shape, fan_in, device=device)
    if mode in ("xavier_normal", "kaiming_normal"):
        std = (2.0 / (fan_in + fan_out)) ** 0.5 if mode == "xavier_normal" \
            else (2.0 / fan_in) ** 0.5
        return std * torch.randn(shape, generator=generator, device=device)
    raise ValueError(f"unknown init mode {mode!r}")


def _init_sub(generator, bcfg: BlockConfig, c_in: int, c_out: int,
              mode: str, device):
    """One conv + BN sub-layer. Weight layouts: depthwise (K, C), pointwise
    (Cin, Cout), dense (K, Cin, Cout); fans as torch computes them."""
    k = bcfg.effective_kernel
    params: dict = {}
    if bcfg.separable:
        params["dw_w"] = _conv_init(generator, (k, c_in), mode, k, c_in * k,
                                    device)
        params["pw_w"] = _conv_init(generator, (c_in, c_out), mode, c_in,
                                    c_out, device)
    else:
        params["conv_w"] = _conv_init(generator, (k, c_in, c_out), mode,
                                      c_in * k, c_out * k, device)
    params["bn"], stats = init_batchnorm(c_out, device=device)
    return params, {"bn": stats}


def init_quartznet(generator: Optional[torch.Generator], cfg: EncoderConfig,
                   num_classes: int, *, device=None) -> dict:
    """The unfolded variables tree, drawn from `generator` (on `device`;
    None: the device's default generator) in block order: each sub-layer's
    weights, then the residual pane's, then the head. num_classes excludes
    the blank; the head outputs num_classes + 1. The JAX package splits a
    key instead, so the values differ and the shapes, fans and
    distributions are the same."""
    _check_supported(cfg)
    mode = cfg.init_mode
    enc_params, enc_stats = [], []
    feat_in = cfg.feat_in
    for bcfg in cfg.blocks:
        params = {"sub": [], "res": [], "se": []}
        stats = {"sub": [], "res": []}
        c = feat_in
        for _ in range(bcfg.repeat):
            p, st = _init_sub(generator, bcfg, c, bcfg.filters, mode, device)
            params["sub"].append(p)
            stats["sub"].append(st)
            c = bcfg.filters
        if bcfg.residual:
            bn, bn_stats = init_batchnorm(bcfg.filters, device=device)
            params["res"].append({"conv_w": _conv_init(
                generator, (feat_in, bcfg.filters), mode, feat_in,
                bcfg.filters, device), "bn": bn})
            stats["res"].append({"bn": bn_stats})
        enc_params.append(params)
        enc_stats.append(stats)
        feat_in = bcfg.filters
    v = num_classes + 1
    dec = {"w": _conv_init(generator, (feat_in, v), cfg.init_mode, feat_in, v,
                           device),
           # torch Conv1d's default bias init: U(-1/sqrt(fan_in), +)
           "b": symmetric_uniform(generator, (v,), feat_in ** -0.5,
                                   device=device)}
    return {"params": {"encoder": enc_params, "decoder": dec},
            "batch_stats": {"encoder": enc_stats}}


def _default_pw(tag, x, w):
    return pointwise_conv(x, w)


def _apply_sub(x, lens, params, stats, bcfg: BlockConfig, conv_mask: bool,
               compute_dtype, training: bool = False, pw_fn=_default_pw,
               tag: str = ""):
    """conv + BN (or folded bias). Returns (y, new_lens, new_stats); y is
    fp32 unless pw_fn returns another dtype."""
    cast = (lambda a: a.to(compute_dtype)) if compute_dtype \
        else (lambda a: a)
    if conv_mask:
        x = mask_padding(x, lens)
    if bcfg.separable:
        x = depthwise_conv1d(cast(x), cast(params["dw_w"]),
                             stride=bcfg.stride, dilation=bcfg.dilation,
                             padding=bcfg.same_padding)
        lens = conv_out_length(lens, bcfg.effective_kernel, bcfg.stride,
                               bcfg.dilation, bcfg.same_padding)
        if conv_mask:
            x = mask_padding(x, lens)
        x = pw_fn(tag, cast(x), cast(params["pw_w"]))
    else:
        x = dense_conv1d(cast(x), cast(params["conv_w"]), stride=bcfg.stride,
                         dilation=bcfg.dilation, padding=bcfg.same_padding)
        lens = conv_out_length(lens, bcfg.effective_kernel, bcfg.stride,
                               bcfg.dilation, bcfg.same_padding)
    if "bn" in params:
        y, new_bn = batchnorm_apply(x, params["bn"], stats["bn"],
                                    training=training)
        return y, lens, {"bn": new_bn}
    return x + cast(params["b"]), lens, stats


def _apply_block(x, lens, params, stats, bcfg: BlockConfig,
                 cfg: EncoderConfig, compute_dtype, block_impl: str,
                 pw_fn=_default_pw, block_idx: int = 0):
    """Inference JasperBlock: R sub-layers (ReLU between), + residual,
    ReLU; an eligible bf16 block as one fused repeat block unless pw_fn
    intercepts the 1x1 products."""
    if (compute_dtype == torch.bfloat16 and cfg.conv_mask
            and pw_fn is _default_pw
            and block_eligible(bcfg, params, False)):
        fused = fused_repeat_block_plain if block_impl == "plain" \
            else fused_repeat_block
        r = bcfg.repeat
        res = params["res"][0] if params["res"] else None
        out = fused(x.to(compute_dtype), lens,
                    [params["sub"][j]["dw_w"] for j in range(r)],
                    [params["sub"][j]["pw_w"] for j in range(r)],
                    [params["sub"][j]["b"] for j in range(r)],
                    res["conv_w"] if res else None,
                    res["b"] if res else None,
                    kernel=bcfg.effective_kernel)
        return out, lens
    return _apply_block_ops(x, lens, params, stats, bcfg, cfg,
                            compute_dtype, pw_fn=pw_fn,
                            block_idx=block_idx)[:2]


def _apply_block_ops(x, lens, params, stats, bcfg: BlockConfig,
                     cfg: EncoderConfig, compute_dtype,
                     training: bool = False,
                     generator: Optional[torch.Generator] = None,
                     pw_fn=_default_pw, block_idx: int = 0):
    """The per-op JasperBlock: each sub-layer's conv and BN (or bias)
    apart; dropout (training only) after each ReLU. Returns (out, lens,
    new_block_stats)."""
    out, out_lens = x, lens
    new_stats = {"sub": [], "res": []}
    for r in range(bcfg.repeat):
        out, out_lens, st = _apply_sub(out, out_lens, params["sub"][r],
                                       stats["sub"][r] if stats else None,
                                       bcfg, cfg.conv_mask, compute_dtype,
                                       training, pw_fn,
                                       f"enc{block_idx}.sub{r}")
        new_stats["sub"].append(st)
        if r < bcfg.repeat - 1:
            out = dropout(torch.relu(out), bcfg.dropout, generator, training)
    cast = (lambda a: a.to(compute_dtype)) if compute_dtype \
        else (lambda a: a)
    for i, pane in enumerate(params["res"]):
        res = mask_padding(x, lens) if cfg.conv_mask else x
        res = pw_fn(f"enc{block_idx}.res{i}", cast(res),
                    cast(pane["conv_w"]))
        pane_stats = stats["res"][i] if stats else {}
        if "bn" in pane:
            res, new_bn = batchnorm_apply(res, pane["bn"], pane_stats["bn"],
                                          training=training)
            pane_stats = {"bn": new_bn}
        else:
            res = res + cast(pane["b"])
        new_stats["res"].append(pane_stats)
        out = out + res
    out = dropout(torch.relu(out), bcfg.dropout, generator, training)
    return out, out_lens, new_stats


def quartznet_apply(
    variables: dict,
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    *,
    cfg: EncoderConfig,
    compute_dtype: Optional[torch.dtype] = None,
    block_impl: str = "auto",
    training: bool = False,
    generator: Optional[torch.Generator] = None,
    pw_fn: Callable = _default_pw,
):
    """Forward pass.

    feats: (B, T, feat_in) from the frontend (channels last); feat_lens:
    (B,) int. Returns (log_probs (B, T', num_classes + 1) fp32, out_lens
    (B,) int32). With training=True (unfolded BN on batch statistics,
    dropout drawn from `generator`) it returns (log_probs, out_lens,
    new_batch_stats), as the JAX function does; the new stats carry no
    gradient. `pw_fn(tag, x, w) -> y` intercepts every 1x1 product (see
    the module docstring); the default is `pointwise_conv`."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, "
                         f"got {block_impl!r}")
    _check_supported(cfg)
    params = variables["params"]
    stats = variables.get("batch_stats", {}).get("encoder")
    x, lens = feats, feat_lens
    new_enc_stats = []
    for i, bcfg in enumerate(cfg.blocks):
        block_stats = stats[i] if stats else None
        if training:
            x, lens, st = _apply_block_ops(x, lens, params["encoder"][i],
                                           block_stats, bcfg, cfg,
                                           compute_dtype, True, generator,
                                           pw_fn, i)
            new_enc_stats.append(st)
        else:
            x, lens = _apply_block(x, lens, params["encoder"][i],
                                   block_stats, bcfg, cfg, compute_dtype,
                                   block_impl, pw_fn, i)
    dec = params["decoder"]
    logits = pw_fn("dec", x, dec["w"]) + dec["b"]
    log_probs = torch.log_softmax(logits, dim=-1)
    if training:
        return log_probs, lens.to(torch.int32), {"encoder": new_enc_stats}
    return log_probs, lens.to(torch.int32)


def fold_batchnorm(variables: dict, cfg: EncoderConfig) -> dict:
    """Fold every BN into its preceding conv; returns inference variables
    whose batch_stats slots carry empty dicts (apply detects the "b" keys)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    new_enc, new_enc_stats = [], []
    for i, bcfg in enumerate(cfg.blocks):
        block = params["encoder"][i]
        bp = {"sub": [], "res": [], "se": list(block.get("se", []))}
        bs = {"sub": [], "res": []}
        for r, sub in enumerate(block["sub"]):
            key = "pw_w" if bcfg.separable else "conv_w"
            w, b = fold_bn_into_conv(sub[key], sub["bn"],
                                     stats["encoder"][i]["sub"][r]["bn"])
            new_sub = {k: v for k, v in sub.items() if k != "bn"}
            new_sub[key] = w
            new_sub["b"] = b
            bp["sub"].append(new_sub)
            bs["sub"].append({})
        for pane, pane_stats in zip(block["res"], stats["encoder"][i]["res"]):
            w, b = fold_bn_into_conv(pane["conv_w"], pane["bn"],
                                     pane_stats["bn"])
            new_pane = {k: v for k, v in pane.items() if k != "bn"}
            new_pane["conv_w"] = w
            new_pane["b"] = b
            bp["res"].append(new_pane)
            bs["res"].append({})
        new_enc.append(bp)
        new_enc_stats.append(bs)
    return {"params": {"encoder": new_enc, "decoder": params["decoder"]},
            "batch_stats": {"encoder": new_enc_stats}}


def cast_matmul_weights(variables: dict, compute_dtype: Optional[torch.dtype]
                        ) -> dict:
    """Store the encoder's 1x1 / dense weights (`pw_w`, `conv_w`) in the
    compute dtype once, instead of casting them on every forward; the
    values are those the forward would cast to. Depthwise weights and
    biases stay fp32 (the repeat kernel reads them so), as does the head."""
    if compute_dtype is None:
        return variables

    def cast_layer(layer):
        return {k: (v.to(compute_dtype) if k in ("pw_w", "conv_w") else v)
                for k, v in layer.items()}

    enc = [{"sub": [cast_layer(s) for s in b["sub"]],
            "res": [cast_layer(p) for p in b["res"]],
            "se": b.get("se", [])} for b in variables["params"]["encoder"]]
    return {"params": {"encoder": enc,
                       "decoder": variables["params"]["decoder"]},
            "batch_stats": variables.get("batch_stats", {})}
