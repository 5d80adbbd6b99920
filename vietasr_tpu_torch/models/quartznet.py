"""QuartzNet/Jasper encoder + CTC head (counterpart of
vietasr_tpu/models/quartznet.py): init, inference and training forward.

Variables are the JAX package's tree with torch tensors for leaves:
`{"params": {"encoder": [block, ...], "decoder": {"w", "b"}},
"batch_stats": {"encoder": [...]}}`, each block `{"sub": [...], "res":
[...], "se": []}`. `quartznet_apply` is a plain function over that tree,
as in JAX, so each weight is found under the same path in both packages
(models/convert.py loads it). `init_quartznet` builds the unfolded tree
from a `torch.Generator`.

Every block variant of the JAX package runs: grouped separable 1x1s
(a grouped conv, then a channel shuffle after BN), heads (one depthwise
filter shared by channel groups), squeeze-excite (per repeat and once at
the end without a residual, on each residual pane with one), dense
residual panes over every earlier dense block's input, `residual_mode=
"max"`, and relu / hardtanh / selu.

Block routing. A block goes through the fused repeat block kernel
(ops/repeat_block.py) when `block_impl` is "auto" or "kernel" and
`kernel_route` holds: JAX's fused conditions (bf16, relu, add,
conv_mask, the default pw_fn, no dense residual, the block input the only
earlier output) and `block_eligible` (separable, stride 1, folded BN: blocks
1-13 of QuartzNet12x1). This is the encoder's main-path kernel on the GPU
(in the JAX package the Pallas block was opt-in, through
`block_impl="pallas"`). `block_impl="plain"` runs the same blocks through
the kernel's plain PyTorch version. Every other block takes the per-op path
(`_apply_block_ops`), as JAX's default XLA path does: blocks 0 (stride 2)
and 14 (dense 1x1) of 12x1, every Jasper block, and every block in
training, where BN is unfolded and uses batch statistics.

bf16 semantics follow the JAX package: convolutions take bf16 operands,
1x1 products accumulate in fp32 and return fp32, a grouped or dense conv
returns bf16 (JAX's conv output dtype), biases, BN and the SE gate are
fp32, and the head's log-softmax is fp32.

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
from vietasr_tpu_torch.models.layers import (activation_fn,
                                             batchnorm_apply,
                                             conv_out_length, dense_conv1d,
                                             depthwise_conv1d, dropout,
                                             fold_bn_into_conv, group_shuffle,
                                             init_batchnorm, kaiming_uniform,
                                             mask_padding, pointwise_conv,
                                             squeeze_excite,
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


def tree_paths(tree, prefix: str = "") -> list:
    """Each leaf's path ("encoder/0/sub/0/pw_w", the JAX package's
    `_path_str` of its key path), in tree_leaves order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    return [p for k, v in items
            for p in tree_paths(v, f"{prefix}/{k}" if prefix else str(k))]


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
    """One conv + BN sub-layer. Weight layouts: depthwise (K, C) or (K,
    heads), pointwise (Cin, Cout) or, grouped, (1, Cin // groups, Cout),
    dense (K, Cin // groups, Cout); fans as torch computes them."""
    k, g = bcfg.effective_kernel, bcfg.groups
    params: dict = {}
    if bcfg.separable:
        dw_ch = bcfg.heads if bcfg.heads != -1 else c_in
        params["dw_w"] = _conv_init(generator, (k, dw_ch), mode, k,
                                    dw_ch * k, device)
        shape = (1, c_in // g, c_out) if g > 1 else (c_in, c_out)
        params["pw_w"] = _conv_init(generator, shape, mode, c_in // g, c_out,
                                    device)
    else:
        params["conv_w"] = _conv_init(generator, (k, c_in // g, c_out), mode,
                                      (c_in // g) * k, c_out * k, device)
    params["bn"], stats = init_batchnorm(c_out, device=device)
    return params, {"bn": stats}


def _init_se(generator, c: int, ratio: int, mode: str, device) -> dict:
    hidden = c // ratio
    return {"w1": _conv_init(generator, (c, hidden), mode, c, hidden,
                             device),
            "w2": _conv_init(generator, (hidden, c), mode, hidden, c,
                             device)}


def init_quartznet(generator: Optional[torch.Generator], cfg: EncoderConfig,
                   num_classes: int, *, device=None) -> dict:
    """The unfolded variables tree, drawn from `generator` (on `device`;
    None: the device's default generator) in block order: each sub-layer's
    weights (and its SE when the block has SE and no residual), then each
    residual pane's (1x1 weight, then its SE), then the head. A dense-
    residual block has one pane per earlier dense block's input and its
    own. num_classes excludes the blank; the head outputs num_classes + 1.
    The JAX package splits a key instead, so the values differ and the
    shapes, fans and distributions are the same."""
    mode = cfg.init_mode
    enc_params, enc_stats = [], []
    feat_in = cfg.feat_in
    dense_panes: list = []
    for bcfg in cfg.blocks:
        if bcfg.residual_dense:
            dense_panes.append(feat_in)
            panes = list(dense_panes)
        else:
            panes = [feat_in] if bcfg.residual else []
        params = {"sub": [], "res": [], "se": []}
        stats = {"sub": [], "res": []}
        c = feat_in
        for _ in range(bcfg.repeat):
            p, st = _init_sub(generator, bcfg, c, bcfg.filters, mode, device)
            params["sub"].append(p)
            stats["sub"].append(st)
            c = bcfg.filters
            if bcfg.se and not bcfg.residual:
                params["se"].append(_init_se(generator, bcfg.filters,
                                             bcfg.se_reduction_ratio, mode,
                                             device))
        for pane_c in panes:
            pane = {"conv_w": _conv_init(generator, (pane_c, bcfg.filters),
                                         mode, pane_c, bcfg.filters, device)}
            pane["bn"], bn_stats = init_batchnorm(bcfg.filters,
                                                  device=device)
            if bcfg.se:
                pane["se"] = _init_se(generator, bcfg.filters,
                                      bcfg.se_reduction_ratio, mode, device)
            params["res"].append(pane)
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


def _apply_depthwise(x, w, bcfg: BlockConfig):
    """The block's depthwise conv; with `heads`, one (K, heads) filter
    shared by the C / heads channel groups (channel g * heads + j takes
    filter j)."""
    conv = lambda a: depthwise_conv1d(  # noqa: E731
        a, w, stride=bcfg.stride, dilation=bcfg.dilation,
        padding=bcfg.same_padding)
    if bcfg.heads == -1:
        return conv(x)
    b, t, c = x.shape
    h = bcfg.heads
    y = conv(x.reshape(b, t, c // h, h).transpose(1, 2)
             .reshape(b * (c // h), t, h))
    t2 = y.shape[1]
    return y.reshape(b, c // h, t2, h).transpose(1, 2).reshape(b, t2, c)


def _apply_sub(x, lens, params, stats, bcfg: BlockConfig, conv_mask: bool,
               compute_dtype, training: bool = False, pw_fn=_default_pw,
               tag: str = "", bn_group=None):
    """conv (+ channel shuffle) + BN (or folded bias). Returns (y,
    new_lens, new_stats). A plain 1x1 product returns fp32 (unless pw_fn
    returns another dtype); a grouped or dense conv returns the compute
    dtype, as JAX's conv does; BN runs in fp32."""
    cast = (lambda a: a.to(compute_dtype)) if compute_dtype \
        else (lambda a: a)
    if conv_mask:
        x = mask_padding(x, lens)
    if bcfg.separable:
        x = _apply_depthwise(cast(x), cast(params["dw_w"]), bcfg)
        lens = conv_out_length(lens, bcfg.effective_kernel, bcfg.stride,
                               bcfg.dilation, bcfg.same_padding)
        if conv_mask:
            x = mask_padding(x, lens)
        if bcfg.groups > 1:
            w = params["pw_w"]
            x = dense_conv1d(cast(x), cast(w[None] if w.ndim == 2 else w),
                             groups=bcfg.groups)
        else:
            x = pw_fn(tag, cast(x), cast(params["pw_w"]))
    else:
        x = dense_conv1d(cast(x), cast(params["conv_w"]), stride=bcfg.stride,
                         dilation=bcfg.dilation, padding=bcfg.same_padding,
                         groups=bcfg.groups)
        lens = conv_out_length(lens, bcfg.effective_kernel, bcfg.stride,
                               bcfg.dilation, bcfg.same_padding)
    if "bn" in params:
        x, new_bn = batchnorm_apply(x.to(torch.float32), params["bn"],
                                    stats["bn"], training=training,
                                    group=bn_group)
        stats = {"bn": new_bn}
    else:
        x = x + cast(params["b"])
    if bcfg.groups > 1:
        x = group_shuffle(x, bcfg.groups)
    return x, lens, stats


def kernel_route(xs: list, params, bcfg: BlockConfig, cfg: EncoderConfig,
                 compute_dtype, training: bool, pw_fn) -> bool:
    """Does this block go through the fused repeat-block kernel? Only where
    JAX's own fused conditions hold (bf16, relu, add, conv_mask, the
    default pw_fn, no dense residual, and the block input is the only
    earlier output: after a dense-residual block pane 0 reads xs[0], not
    the block input) and `block_eligible` accepts the block."""
    return (compute_dtype == torch.bfloat16
            and cfg.activation == "relu"
            and cfg.residual_mode == "add"
            and cfg.conv_mask
            and pw_fn is _default_pw
            and not bcfg.residual_dense
            and len(xs) == 1
            and block_eligible(bcfg, params, training))


def _apply_block(xs, lens, params, stats, bcfg: BlockConfig,
                 cfg: EncoderConfig, compute_dtype, block_impl: str,
                 training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 pw_fn=_default_pw, block_idx: int = 0, bn_group=None):
    """JasperBlock over `xs`, the outputs a block may read its residual
    panes from (the block input last). Returns (xs', lens, new_stats): a
    dense-residual block appends its output to xs, any other returns
    [out]. A block that `kernel_route` accepts is one fused repeat block;
    every other takes the per-op path."""
    if not kernel_route(xs, params, bcfg, cfg, compute_dtype, training,
                        pw_fn):
        return _apply_block_ops(xs, lens, params, stats, bcfg, cfg,
                                compute_dtype, training, generator, pw_fn,
                                block_idx, bn_group)
    fused = fused_repeat_block_plain if block_impl == "plain" \
        else fused_repeat_block
    r = bcfg.repeat
    res = params["res"][0] if params["res"] else None
    out = fused(xs[-1].to(compute_dtype), lens,
                [params["sub"][j]["dw_w"] for j in range(r)],
                [params["sub"][j]["pw_w"] for j in range(r)],
                [params["sub"][j]["b"] for j in range(r)],
                res["conv_w"] if res else None,
                res["b"] if res else None,
                kernel=bcfg.effective_kernel)
    return [out], lens, stats


def _apply_block_ops(xs, lens, params, stats, bcfg: BlockConfig,
                     cfg: EncoderConfig, compute_dtype,
                     training: bool = False,
                     generator: Optional[torch.Generator] = None,
                     pw_fn=_default_pw, block_idx: int = 0, bn_group=None):
    """The per-op JasperBlock (JAX's `_apply_block` past its fused branch):
    R sub-layers with the activation, dropout (training only) and, with SE
    and no residual, SE between them; the final SE; each residual pane p
    from xs[p] (1x1, BN or bias, SE) added or max-ed in; the activation
    and dropout. Returns (xs', lens, new_block_stats)."""
    act = activation_fn(cfg.activation)
    out, out_lens = xs[-1], lens
    new_stats = {"sub": [], "res": []}
    se_per_repeat = bcfg.se and not bcfg.residual
    for r in range(bcfg.repeat):
        out, out_lens, st = _apply_sub(out, out_lens, params["sub"][r],
                                       stats["sub"][r] if stats else None,
                                       bcfg, cfg.conv_mask, compute_dtype,
                                       training, pw_fn,
                                       f"enc{block_idx}.sub{r}", bn_group)
        new_stats["sub"].append(st)
        if r < bcfg.repeat - 1:
            out = dropout(act(out), bcfg.dropout, generator, training)
            if se_per_repeat:
                out = squeeze_excite(out, params["se"][r])
    if se_per_repeat and params["se"]:
        out = squeeze_excite(out, params["se"][-1])
    cast = (lambda a: a.to(compute_dtype)) if compute_dtype \
        else (lambda a: a)
    for i, pane in enumerate(params["res"]):
        res = mask_padding(xs[i], lens) if cfg.conv_mask else xs[i]
        res = pw_fn(f"enc{block_idx}.res{i}", cast(res),
                    cast(pane["conv_w"]))
        pane_stats = stats["res"][i] if stats else {}
        if "bn" in pane:
            res, new_bn = batchnorm_apply(res.to(torch.float32), pane["bn"],
                                          pane_stats["bn"],
                                          training=training, group=bn_group)
            pane_stats = {"bn": new_bn}
        else:
            res = res + cast(pane["b"])
        if "se" in pane:
            res = squeeze_excite(res, pane["se"])
        new_stats["res"].append(pane_stats)
        out = out + res if cfg.residual_mode == "add" \
            else torch.maximum(out, res)
    out = dropout(act(out), bcfg.dropout, generator, training)
    if params["res"] and bcfg.residual_dense:
        return list(xs) + [out], out_lens, new_stats
    return [out], out_lens, new_stats


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
    bn_group=None,
):
    """Forward pass.

    feats: (B, T, feat_in) from the frontend (channels last); feat_lens:
    (B,) int. Returns (log_probs (B, T', num_classes + 1) fp32, out_lens
    (B,) int32). With training=True (unfolded BN on batch statistics,
    dropout drawn from `generator`) it returns (log_probs, out_lens,
    new_batch_stats), as the JAX function does; the new stats carry no
    gradient. `pw_fn(tag, x, w) -> y` intercepts every 1x1 product (see
    the module docstring); the default is `pointwise_conv`. `bn_group`, a
    process group, takes the training-mode BN statistics over the global
    batch of its ranks (models/layers.py batchnorm_apply)."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, "
                         f"got {block_impl!r}")
    activation_fn(cfg.activation)
    if cfg.residual_mode not in ("add", "max"):
        raise ValueError(f"unsupported residual_mode {cfg.residual_mode!r}")
    params = variables["params"]
    stats = variables.get("batch_stats", {}).get("encoder")
    xs, lens = [feats], feat_lens
    new_enc_stats = []
    for i, bcfg in enumerate(cfg.blocks):
        xs, lens, st = _apply_block(xs, lens, params["encoder"][i],
                                    stats[i] if stats else None, bcfg, cfg,
                                    compute_dtype, block_impl, training,
                                    generator, pw_fn, i, bn_group)
        new_enc_stats.append(st)
    dec = params["decoder"]
    logits = pw_fn("dec", xs[-1], dec["w"]) + dec["b"]
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
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


class QuartzNet:
    """An object facade over the functional API: init, apply and fold.
    `apply` returns what `quartznet_apply` returns, (log_probs, out_lens)
    in eval mode, where the JAX package's returns a third item, the
    unchanged batch stats; with training=True both return three."""

    def __init__(self, cfg: EncoderConfig, num_classes: int):
        self.cfg = cfg
        self.num_classes = num_classes

    def init(self, generator: Optional[torch.Generator], *,
             device=None) -> dict:
        return init_quartznet(generator, self.cfg, self.num_classes,
                              device=device)

    def apply(self, variables: dict, feats: torch.Tensor,
              feat_lens: torch.Tensor, **kw):
        return quartznet_apply(variables, feats, feat_lens, cfg=self.cfg,
                               **kw)

    def fold(self, variables: dict) -> dict:
        return fold_batchnorm(variables, self.cfg)
