"""QuartzNet / Jasper's forward, plain (Kriman et al. 2019, arXiv:1910.10261;
NeMo's JasperEncoder with `conv_mask: true`): float32, channels last, BN
unfolded (running statistics in eval, batch statistics over every (row,
frame) in training), no kernel, no fold, no cast.

A block: R sub-layers, each the input masked past the row's length, a
depthwise conv ('same' padding, the block's stride or dilation), masked
again at the new lengths, a 1x1, BN (or, unseparable, one dense conv and
BN), ReLU between sub-layers; a residual 1x1 + BN of the block input
masked at its own lengths, added; ReLU. The head: a 1x1 with bias and a
log-softmax.

`quant`, where given, rounds every convolution's two operands before the
product (the control's lower precision); the reference itself passes
none. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


def same_padding(b: dict) -> int:
    k, d = b["kernel"][0], b["dilation"][0]
    return (d * k) // 2 - 1 if d > 1 else k // 2


def out_lengths(lens: torch.Tensor, b: dict) -> torch.Tensor:
    k, s, d = b["kernel"][0], b["stride"][0], b["dilation"][0]
    return torch.div(lens + 2 * same_padding(b) - d * (k - 1) - 1, s,
                     rounding_mode="floor") + 1


def check_blocks(blocks: List[dict]) -> None:
    """The reference covers what the benchmark's configurations use."""
    for b in blocks:
        for key, want in (("groups", 1), ("heads", -1), ("se", False),
                          ("residual_dense", False)):
            if b.get(key, want) != want:
                raise ValueError(f"reference: block option {key}="
                                 f"{b[key]!r} is not covered")
        if b["kernel"][0] % 2 == 0:
            raise ValueError("reference: even kernels are not covered")


def _mask(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    t = x.shape[1]
    keep = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    return x * keep[..., None].to(x.dtype)


def _bn(x, p, s, training: bool):
    if training:
        mean = x.mean(dim=(0, 1))
        var = ((x - mean) ** 2).mean(dim=(0, 1))
    else:
        mean, var = s["mean"], s["var"]
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * p["scale"]) + p["bias"]


def _sub(x, lens, p, s, b, training, quant):
    q = quant or (lambda a: a)
    x = _mask(x, lens)
    new_lens = out_lengths(lens, b)
    pad, st, dil = same_padding(b), b["stride"][0], b["dilation"][0]
    if b["separable"]:
        w = p["dw_w"]                                         # (K, C)
        y = F.conv1d(q(x).transpose(1, 2), q(w).t().unsqueeze(1), stride=st,
                     padding=pad, dilation=dil, groups=w.shape[1])
        x = _mask(y.transpose(1, 2), new_lens)
        x = q(x) @ q(p["pw_w"])
    else:
        w = p["conv_w"]                                       # (K, Cin, Cout)
        y = F.conv1d(q(x).transpose(1, 2), q(w).permute(2, 1, 0), stride=st,
                     padding=pad, dilation=dil)
        x = y.transpose(1, 2)
    return _bn(x, p["bn"], s["bn"], training), new_lens


def forward(variables: dict, feats: torch.Tensor, lens: torch.Tensor,
            blocks: List[dict], *, training: bool = False,
            quant: Optional[Callable] = None):
    """(B, T, C) float32 features + (B,) frame counts -> (log-probs (B,
    T', V) float32, output lengths (B,))."""
    check_blocks(blocks)
    q = quant or (lambda a: a)
    params = variables["params"]
    stats = variables["batch_stats"]["encoder"]
    x, lens = feats, lens.to(torch.int64)
    for i, b in enumerate(blocks):
        p, s = params["encoder"][i], stats[i]
        inp, inp_lens = x, lens
        for r in range(b["repeat"]):
            x, lens = _sub(x, lens, p["sub"][r], s["sub"][r], b, training,
                           quant)
            if r < b["repeat"] - 1:
                x = torch.relu(x)
        if b["residual"]:
            pane, ps = p["res"][0], s["res"][0]
            res = q(_mask(inp, inp_lens)) @ q(pane["conv_w"])
            x = x + _bn(res, pane["bn"], ps["bn"], training)
        x = torch.relu(x)
    dec = params["decoder"]
    logits = q(x) @ q(dec["w"]) + dec["b"]
    return torch.log_softmax(logits, dim=-1), lens.to(torch.int32)

