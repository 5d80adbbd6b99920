"""QuartzNet/Jasper encoder + CTC head for inference (counterpart of
vietasr_tpu/models/quartznet.py).

Variables are the JAX package's tree with torch tensors for leaves:
`{"params": {"encoder": [block, ...], "decoder": {"w", "b"}},
"batch_stats": {"encoder": [...]}}`, each block `{"sub": [...], "res":
[...], "se": []}`. `quartznet_apply` is a plain function over that tree,
as in JAX, so each weight is found under the same path in both packages
(models/convert.py loads it).

Block routing. A block that `block_eligible` accepts (separable, stride 1,
folded BN: blocks 1-13 of QuartzNet12x1) goes through the fused repeat
block kernel (ops/repeat_block.py) whenever the compute dtype is bf16 and
`block_impl` is "auto" or "kernel": this is the encoder's main-path kernel
on the GPU (in the JAX package the Pallas block was opt-in, through
`block_impl="pallas"`). `block_impl="plain"` runs the same blocks through
the kernel's plain PyTorch version. Other blocks, and every block outside
bf16, take the per-op path (`_apply_block_ops`), as JAX's default XLA path
does: blocks 0 (stride 2) and 14 (dense 1x1) and the head always do.

bf16 semantics follow the JAX package: convolutions take bf16 operands,
1x1 products accumulate in fp32 and return fp32, biases are added in
fp32, and the head's log-softmax is fp32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from vietasr_tpu_torch.config import BlockConfig, EncoderConfig
from vietasr_tpu_torch.models.layers import (batchnorm_apply,
                                             conv_out_length, dense_conv1d,
                                             depthwise_conv1d,
                                             fold_bn_into_conv, mask_padding,
                                             pointwise_conv)
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


def _check_supported(cfg: EncoderConfig) -> None:
    if cfg.activation != "relu" or cfg.residual_mode != "add":
        raise NotImplementedError(
            "only activation='relu' with residual_mode='add' is ported")
    for b in cfg.blocks:
        if b.groups > 1 or b.heads != -1 or b.se or b.residual_dense:
            raise NotImplementedError(
                "grouped, multi-head, SE and dense-residual blocks are not "
                "ported yet")


def _apply_sub(x, lens, params, stats, bcfg: BlockConfig, conv_mask: bool,
               compute_dtype):
    """conv + BN (or folded bias). Returns (y fp32, new_lens)."""
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
        x = pointwise_conv(cast(x), cast(params["pw_w"]))
    else:
        x = dense_conv1d(cast(x), cast(params["conv_w"]), stride=bcfg.stride,
                         dilation=bcfg.dilation, padding=bcfg.same_padding)
        lens = conv_out_length(lens, bcfg.effective_kernel, bcfg.stride,
                               bcfg.dilation, bcfg.same_padding)
    if "bn" in params:
        return batchnorm_apply(x, params["bn"], stats["bn"]), lens
    return x + cast(params["b"]).to(torch.float32), lens


def _apply_block(x, lens, params, stats, bcfg: BlockConfig,
                 cfg: EncoderConfig, compute_dtype, block_impl: str):
    """JasperBlock forward: R sub-layers (ReLU between), + residual, ReLU;
    an eligible bf16 block as one fused repeat block."""
    if (compute_dtype == torch.bfloat16 and cfg.conv_mask
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
    return _apply_block_ops(x, lens, params, stats, bcfg, cfg, compute_dtype)


def _apply_block_ops(x, lens, params, stats, bcfg: BlockConfig,
                     cfg: EncoderConfig, compute_dtype):
    """The per-op JasperBlock: each sub-layer's conv and bias apart."""
    out, out_lens = x, lens
    for r in range(bcfg.repeat):
        out, out_lens = _apply_sub(out, out_lens, params["sub"][r],
                                   stats["sub"][r] if stats else None, bcfg,
                                   cfg.conv_mask, compute_dtype)
        if r < bcfg.repeat - 1:
            out = torch.relu(out)
    cast = (lambda a: a.to(compute_dtype)) if compute_dtype \
        else (lambda a: a)
    for i, pane in enumerate(params["res"]):
        res = mask_padding(x, lens) if cfg.conv_mask else x
        res = pointwise_conv(cast(res), cast(pane["conv_w"]))
        if "bn" in pane:
            res = batchnorm_apply(res, pane["bn"], stats["res"][i]["bn"])
        else:
            res = res + cast(pane["b"]).to(torch.float32)
        out = out + res
    return torch.relu(out), out_lens


def quartznet_apply(
    variables: dict,
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    *,
    cfg: EncoderConfig,
    compute_dtype: Optional[torch.dtype] = None,
    block_impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference forward pass.

    feats: (B, T, feat_in) from the frontend (channels last); feat_lens:
    (B,) int. Returns (log_probs (B, T', num_classes + 1) fp32, out_lens
    (B,) int32)."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, "
                         f"got {block_impl!r}")
    _check_supported(cfg)
    params = variables["params"]
    stats = variables.get("batch_stats", {}).get("encoder")
    x, lens = feats, feat_lens
    for i, bcfg in enumerate(cfg.blocks):
        x, lens = _apply_block(x, lens, params["encoder"][i],
                               stats[i] if stats else None, bcfg, cfg,
                               compute_dtype, block_impl)
    dec = params["decoder"]
    logits = pointwise_conv(x, dec["w"]) + dec["b"].to(torch.float32)
    return torch.log_softmax(logits, dim=-1), lens.to(torch.int32)


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
