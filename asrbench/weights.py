"""The weights both sides get: the trained anchor read from its file, or a
QuartzNet drawn from the run's seed on the card.

Both come as the JAX-layout variables tree the port's `Transcriber` and
`TrainState` take (`{"params": {"encoder": [...], "decoder": {...}},
"batch_stats": {...}}`, BN unfolded), and the plain reference reads the
same tree. Nothing here imports the program: the anchor is decoded by a
copy of the msgpack subset flax writes.
"""

from __future__ import annotations

import gzip
import struct
from typing import Any, List, Tuple

import numpy as np

_EXT_NDARRAY = 1     # flax: an ext payload is msgpack [shape, dtype, bytes]
# the seeded model's head: logits of a few units' spread, as a trained CTC
# head gives (a random 1/sqrt(fan_in) head gives near-flat log-probs)
HEAD_GAIN = 4.0
# BN scale on the two branches a residual block sums: 1 grows the
# activations ~1.3x a block over 15x5's 18 blocks, 1/sqrt(2) shrinks them
# ~0.93x; this keeps them within ~2x of the input's
RESIDUAL_BN_SCALE = 0.8


class _Reader:
    """msgpack decoder for the types flax writes: maps, arrays, str, bin,
    int, float, bool, nil and ext type 1 (an ndarray)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, code: int, n: int):
        data = bytes(self._take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, raw = _Reader(data).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return bytes(self._take(b & 0x1f)).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",           # bin
                 0xd9: ">B", 0xda: ">H", 0xdb: ">I"}           # str
        if b in sized:
            raw = bytes(self._take(self._unpack(sized[b])))
            return raw if b <= 0xc6 else raw.decode("utf-8")
        if b in (0xc7, 0xc8, 0xc9):                            # ext 8/16/32
            n = self._unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        if 0xd4 <= b <= 0xd8:                                  # fixext
            return self._ext(self._unpack(">b"), 1 << (b - 0xd4))
        scalars = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in scalars:
            return self._unpack(scalars[b])
        if b in (0xdc, 0xdd):
            n = self._unpack(">H" if b == 0xdc else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def read_anchor(path: str) -> dict:
    """A gzip'd flax msgpack variables file -> a tree of numpy arrays."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the document")
    return out


def leaf_specs(blocks: List[dict], feat_in: int, n_out: int
               ) -> List[Tuple[tuple, tuple, str]]:
    """(tree path, shape, kind) of every leaf of a QuartzNet's unfolded
    variables tree in a fixed order. kind: "dw" (depthwise taps, K x C),
    "pw" (a 1x1, Cin x Cout), "conv" (K x Cin x Cout), "head", "bias",
    "bn_scale", "bn_bias", "bn_mean", "bn_var"."""
    specs = []
    c_in = feat_in
    for i, b in enumerate(blocks):
        k, f = b["kernel"][0], b["filters"]
        c = c_in
        for r in range(b["repeat"]):
            base = ("params", "encoder", i, "sub", r)
            if b["separable"]:
                specs.append((base + ("dw_w",), (k, c), "dw"))
                specs.append((base + ("pw_w",), (c, f), "pw"))
            else:
                specs.append((base + ("conv_w",), (k, c, f), "conv"))
            specs += _bn_specs(base, ("batch_stats", "encoder", i, "sub", r),
                               f)
            c = f
        if b["residual"]:
            base = ("params", "encoder", i, "res", 0)
            specs.append((base + ("conv_w",), (c_in, f), "pw"))
            specs += _bn_specs(base, ("batch_stats", "encoder", i, "res", 0),
                               f)
        c_in = f
    specs.append((("params", "decoder", "w"), (c_in, n_out), "head"))
    specs.append((("params", "decoder", "b"), (n_out,), "bias"))
    return specs


def _bn_specs(pbase, sbase, f):
    return [(pbase + ("bn", "scale"), (f,), "bn_scale"),
            (pbase + ("bn", "bias"), (f,), "bn_bias"),
            (sbase + ("bn", "mean"), (f,), "bn_mean"),
            (sbase + ("bn", "var"), (f,), "bn_var")]


def _std(shape, kind) -> float:
    """He-normal for a conv followed by ReLU, 1/sqrt(fan_in) for the
    depthwise taps and the head, so that activations keep their scale
    through every block and the head's log-probs are not flat."""
    if kind == "dw":
        return shape[0] ** -0.5
    if kind == "pw":
        return (2.0 / shape[0]) ** 0.5
    if kind == "conv":
        return (2.0 / (shape[0] * shape[1])) ** 0.5
    if kind == "head":
        return HEAD_GAIN * shape[0] ** -0.5
    return 0.0


def seeded_variables(blocks: List[dict], feat_in: int, n_out: int,
                     seed: int, device) -> dict:
    """A QuartzNet's unfolded variables drawn from `seed` on `device`: one
    normal draw for every weight at once, sliced and scaled per leaf; BN
    at identity (bias 0, mean 0, var 1), its scale 1, but RESIDUAL_BN_SCALE
    on the two branches a residual block adds (its last sub-layer and its
    pane), so that the sum keeps about the input's scale through the
    blocks; a zero head bias."""
    import torch

    specs = leaf_specs(blocks, feat_in, n_out)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    drawn = [s for s in specs if _std(s[1], s[2]) > 0]
    total = sum(int(np.prod(shape)) for _, shape, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    tree: dict = {}
    at = 0
    for path, shape, kind in specs:
        n = int(np.prod(shape))
        if _std(shape, kind) > 0:
            leaf = flat[at:at + n].view(shape) * _std(shape, kind)
            at += n
        else:
            fill = 1.0 if kind in ("bn_scale", "bn_var") else 0.0
            if kind == "bn_scale" and _on_residual_branch(blocks, path):
                fill = RESIDUAL_BN_SCALE
            leaf = torch.full(shape, fill, device=device)
        _put(tree, path, leaf)
    return _listify(tree)


def _on_residual_branch(blocks: List[dict], path: tuple) -> bool:
    """Is this BN one of the two a residual block sums: its last
    sub-layer's or its pane's?"""
    i, part, j = path[2], path[3], path[4]
    b = blocks[i]
    return b["residual"] and (part == "res" or j == b["repeat"] - 1)


def _put(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def _listify(node):
    """Dicts keyed 0..n-1 -> lists (the tree's encoder blocks, sub-layers
    and panes are lists)."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listify(node[k]) for k in sorted(node)]
    out = {k: _listify(v) for k, v in node.items()}
    enc = out.get("encoder")
    if isinstance(enc, list):
        for blk in enc:
            if isinstance(blk, dict):
                blk.setdefault("res", [])
                if "sub" in blk and any("dw_w" in s or "conv_w" in s
                                        for s in blk["sub"]):
                    blk.setdefault("se", [])
    return out

