"""Weights in and out: the JAX package's variables tree <-> the port's.

`load_anchor(path)` reads a `*.msgpack.gz` variables file as flax's
`msgpack_serialize` writes it, with a small msgpack decoder of its own
(neither flax nor the `msgpack` package is needed). `params_from_jax`
turns such a tree of numpy arrays (unfolded or folded) into torch tensors
on a device; the structure and key names stay those of the JAX package,
so `quartznet_apply` computes what JAX's does on the same tree.
`train_state_from_jax` builds the port's TrainState from JAX's unfolded
tree (and a Novograd state), so a train step from the same state computes
the same thing in both; `to_numpy` is the way back.
"""

from __future__ import annotations

import gzip
import struct
from typing import Any

import numpy as np
import torch

from vietasr_tpu_torch.models.quartznet import map_tree
from vietasr_tpu_torch.utils.device import resolve_device

_EXT_NDARRAY = 1     # flax: ext payload is msgpack [shape, dtype name, bytes]


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
            return self._array(b & 0x0f)
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
            return self._array(self._unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def msgpack_restore(data: bytes) -> Any:
    """Decode one msgpack document (as flax serializes a variables tree)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the document")
    return out


def load_anchor(path: str) -> dict:
    """Read a gzip'd flax msgpack variables file into a tree of numpy
    arrays (dicts and lists as written; e.g. params.encoder is a list)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return msgpack_restore(f.read())


def params_from_jax(variables: dict, *, device=None) -> dict:
    """JAX variables tree (numpy or array-like leaves, unfolded or folded)
    -> the same tree with fp32 torch tensors on `device` (None: CUDA)."""
    dev = resolve_device(device)

    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return map_tree(leaf, variables)


def to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays (on the host)."""
    return map_tree(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t)
                    else np.asarray(t), tree)


def _paired_leaves(a, b) -> list:
    """[(leaf of a, leaf of b)] matched by key and position (two trees of
    the same structure whose dicts may list their keys in other orders)."""
    if isinstance(a, dict):
        return [pair for k in a for pair in _paired_leaves(a[k], b[k])]
    if isinstance(a, (list, tuple)):
        return [pair for x, y in zip(a, b) for pair in _paired_leaves(x, y)]
    return [(a, b)]


def train_state_from_jax(variables: dict, novograd_state=None, step: int = 0,
                         *, optimizer, device=None):
    """JAX's unfolded {params, batch_stats} tree (numpy leaves) -> the
    port's TrainState on `device` (None: CUDA), its optimizer built by
    `optimizer` (a make_optimizer constructor). `novograd_state` (JAX's
    NovogradState, or a dict of its fields: exp_avg shaped like params,
    scalar exp_avg_sq per tensor, step) sets the moments and the step count
    of a Novograd."""
    # imported here: the train package imports this module
    from vietasr_tpu_torch.train.optim import Novograd
    from vietasr_tpu_torch.train.state import TrainState

    dev = resolve_device(device)
    state = TrainState.create(params_from_jax(variables, device=dev),
                              optimizer, step=step)
    if novograd_state is None:
        return state
    field = (novograd_state.get if isinstance(novograd_state, dict)
             else lambda k: getattr(novograd_state, k))
    opt = state.optimizer
    if not isinstance(opt, Novograd):
        raise TypeError(f"novograd_state given for a {type(opt).__name__}")
    moments = params_from_jax({"m": field("exp_avg"),
                               "v": field("exp_avg_sq")}, device=dev)
    for p, m in _paired_leaves(state.params, moments["m"]):
        opt.state[p]["exp_avg"] = m.reshape(p.shape)
    for p, v in _paired_leaves(state.params, moments["v"]):
        opt.state[p]["exp_avg_sq"] = v.reshape(())
    for group in opt.param_groups:
        group["step"] = torch.tensor(int(np.asarray(field("step"))),
                                     dtype=torch.int32, device=dev)
    return state
