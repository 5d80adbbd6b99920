"""Weights in and out: the JAX package's variables tree <-> the port's.

`load_anchor(path)` reads a `*.msgpack.gz` variables file as flax's
`msgpack_serialize` writes it, with a small msgpack decoder of its own
(neither flax nor the `msgpack` package is needed). `params_from_jax`
turns such a tree of numpy arrays (unfolded or folded) into torch tensors
on a device; the structure and key names stay those of the JAX package,
so `quartznet_apply` computes what JAX's does on the same tree.
`q_tables_from_jax` carries JAX's int8 serving tables
(models/quantize.py) across the same way.
`train_state_from_jax` builds the port's TrainState from JAX's unfolded
tree and the optax state of any optimizer `make_optimizer` builds
(`assign_jax_opt_state`, which the checkpoint manager also uses to resume
a JAX `state-STEP-<n>.msgpack`), so a train step from the same state
computes the same thing in both; `to_numpy` is the way back.

The reference's NeMo `.pt` state_dicts (`JasperEncoder-STEP-{n}.pt` /
`JasperDecoderForCTC-STEP-{n}.pt`, its nemo/backends/pytorch/nm.py:92-103)
convert to the same JAX-layout numpy tree (`variables_from_checkpoints`,
the counterpart of vietasr_tpu/models/convert.py), and back
(`state_dict_from_variables`). Key layout (the reference's
parts/jasper.py:172-448):

  encoder.{b}.mconv.{i}.conv.weight      MaskedConv1d wraps nn.Conv1d
  encoder.{b}.mconv.{i}.{weight,bias,running_mean,running_var,...}   BN
  encoder.{b}.res.{p}.{0}.conv.weight    residual 1x1 conv
  encoder.{b}.res.{p}.{1}.*              residual BN
  decoder_layers.0.{weight,bias}         CTC head 1x1 conv

mconv indices: each repeat contributes [conv, (pointwise conv), BN] then
[activation, dropout] between repeats — activation/dropout own no params but
DO consume indices, so the stride is 5 per repeat for separable blocks and
4 for dense blocks.

Weight layout conversion (torch OIW -> ours):
  depthwise (C, 1, K)        -> (K, C)
  pointwise (Cout, Cin, 1)   -> (Cin, Cout)
  dense     (Cout, Cin/g, K) -> (K, Cin/g, Cout)
  head      (V, C, 1)        -> (C, V)

K is the block's `effective_kernel` (kernel_size_factor applied), the
rows `init_quartznet` draws and the model convolves with; a checkpoint
with another K raises.
"""

from __future__ import annotations

import gzip
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

from vietasr_tpu_torch.config import EncoderConfig
from vietasr_tpu_torch.models.quantize import (QuantizedPointwise,
                                               gemm_weight)
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
    """JAX variables tree (numpy, array-like or tensor leaves, unfolded or
    folded) -> the same tree with fp32 torch tensors on `device` (None:
    CUDA), each a copy."""
    dev = resolve_device(device)

    def leaf(a):
        if torch.is_tensor(a):
            return a.detach().to(device=dev, dtype=torch.float32, copy=True)
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return map_tree(leaf, variables)


def q_tables_from_jax(tables: Mapping[str, Any], *, device=None
                      ) -> Dict[str, QuantizedPointwise]:
    """JAX's int8 tables ({tag: QuantizedPointwise(w_i8, w_scale,
    x_scale)}, numpy or array-like leaves) -> the port's, on `device`
    (None: CUDA), with the weights laid out for the device's int8 GEMM."""
    dev = resolve_device(device)
    out = {}
    for tag, (w_i8, w_scale, x_scale) in tables.items():
        out[tag] = QuantizedPointwise(
            gemm_weight(torch.tensor(np.asarray(w_i8, np.int8), device=dev)),
            torch.tensor(np.asarray(w_scale, np.float32), device=dev),
            torch.tensor(np.asarray(x_scale, np.float32), device=dev))
    return out


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


def _plain_tree(tree):
    """NamedTuples -> dicts of their fields, tuples -> lists (the shape
    flax's msgpack gives an optax state, once its "0".."n-1" dicts are
    lists again)."""
    if hasattr(tree, "_fields"):
        return {k: _plain_tree(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain_tree(v) for v in tree]
    return tree


# the state that each of make_optimizer's optax chains keeps, by its keys
_JAX_STATES = ((("exp_avg", "exp_avg_sq", "step"), "novograd"),
               (("count", "mu", "nu"), "adam"),
               (("trace",), "sgd"))
# the length of the chain around scale_by_adam: optax.adam, adamw, lamb
_ADAM_CHAINS = {2: "adam", 3: "adamw", 4: "lamb"}
# the port's optimizer classes and the JAX kinds each one resumes
_RESUMES = {"Novograd": ("novograd",), "Adam": ("adam", "adamw"),
            "Lamb": ("lamb",), "SGD": ("sgd",)}


def _find_states(tree, parent=None, found=None) -> list:
    """[(state dict, the chain list holding it)] in depth-first order."""
    found = [] if found is None else found
    if isinstance(tree, dict):
        for keys, _ in _JAX_STATES:
            if all(k in tree for k in keys):
                found.append((tree, parent))
                return found
        if set(tree) == {"count"}:          # a schedule's ScaleByScheduleState
            found.append((tree, parent))
            return found
        for v in tree.values():
            _find_states(v, None, found)
    elif isinstance(tree, list):
        for v in tree:
            _find_states(v, tree, found)
    return found


def jax_optimizer_kind(opt_state) -> tuple:
    """(kind, moments state, schedule count or None) of an optax state
    from the JAX package's make_optimizer: kind is "novograd", "adam",
    "adamw", "lamb" or "sgd" (LARC and weight decay included), with or
    without grad_clip_norm's chain."""
    states = _find_states(_plain_tree(opt_state))
    main = [(st, chain) for st, chain in states if set(st) != {"count"}]
    if len(main) != 1:
        raise TypeError("the checkpoint's optimizer state is none of "
                        "make_optimizer's (Novograd, Adam, AdamW, SGD, LAMB)")
    st, chain = main[0]
    kind = next(name for keys, name in _JAX_STATES
                if all(k in st for k in keys))
    if kind == "adam":
        kind = _ADAM_CHAINS.get(len(chain) if chain else 0, "adam")
    sched = [s["count"] for s, _ in states if set(s) == {"count"}]
    return kind, st, (sched[0] if sched else None)


def assign_jax_opt_state(state, opt_state, *, applied_updates: int) -> None:
    """Load an optax state of the JAX package's make_optimizer into the
    TrainState's optimizer, in place: the moments of each parameter and
    the group's step count. Raises TypeError, naming both, when the
    state is not of the optimizer's kind (JAX's restore fails there too).
    `applied_updates` (the train step count less the skipped steps) is
    the step count of an SGD, whose optax state keeps none without a
    schedule."""
    opt = state.optimizer
    kind, st, sched_count = jax_optimizer_kind(opt_state)
    mine = type(opt).__name__
    if kind not in _RESUMES.get(mine, ()):
        raise TypeError(f"the checkpoint holds a JAX {kind} state; the "
                        f"TrainState's optimizer is {mine}")
    dev = state.step.device
    if kind == "novograd":
        moments, count = {"exp_avg": st["exp_avg"],
                          "exp_avg_sq": st["exp_avg_sq"]}, st["step"]
    elif kind == "sgd":
        moments = {"momentum_buffer": st["trace"]}
        count = applied_updates if sched_count is None else sched_count
    else:
        moments, count = {"exp_avg": st["mu"],
                          "exp_avg_sq": st["nu"]}, st["count"]
    for key, tree in moments.items():
        for p, m in _paired_leaves(state.params,
                                   params_from_jax(tree, device=dev)):
            opt.state[p][key] = m.reshape(() if key == "exp_avg_sq"
                                          and kind == "novograd"
                                          else p.shape)
    for group in opt.param_groups:
        group["step"] = torch.tensor(int(np.asarray(count)),
                                     dtype=torch.int32, device=dev)


def train_state_from_jax(variables: dict, opt_state=None, step: int = 0,
                         *, optimizer, device=None):
    """JAX's unfolded {params, batch_stats} tree (numpy leaves) -> the
    port's TrainState on `device` (None: CUDA), its optimizer built by
    `optimizer` (a make_optimizer constructor). `opt_state` (JAX's
    TrainState.opt_state, as live optax NamedTuples or as its msgpack
    dicts) sets the optimizer's moments and step count
    (assign_jax_opt_state)."""
    # imported here: the train package imports this module
    from vietasr_tpu_torch.train.state import TrainState

    dev = resolve_device(device)
    state = TrainState.create(params_from_jax(variables, device=dev),
                              optimizer, step=step)
    if opt_state is not None:
        assign_jax_opt_state(state, opt_state, applied_updates=step)
    return state


# -- NeMo .pt checkpoints -----------------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A `.pt` state_dict as numpy arrays (tensors only, loaded on the CPU,
    weights only: no code in the file runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in sd.items()
            if torch.is_tensor(v)}


def _bn_from(sd: Mapping[str, np.ndarray], prefix: str):
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


def _check_kernel(w: np.ndarray, k: int, key: str) -> None:
    if w.shape[-1] != k:
        raise ValueError(f"{key}: kernel {w.shape[-1]}, but the config's "
                         f"block has effective_kernel {k}")


def _check_jasper(cfg: EncoderConfig) -> None:
    if not cfg.blocks:
        raise ValueError(
            "the NeMo .pt converters hold a QuartzNet (JasperEncoder "
            "blocks); this config has none (a Conformer's weights travel as "
            "a msgpack variables tree)")


def encoder_from_state_dict(sd: Mapping[str, np.ndarray],
                            cfg: EncoderConfig) -> dict:
    """{"params": [per block], "batch_stats": [per block]} (numpy leaves,
    JAX layout) from a reference JasperEncoder state_dict."""
    _check_jasper(cfg)
    enc_params = []
    enc_stats = []
    feat_in = cfg.feat_in
    residual_panes = []
    for b, bcfg in enumerate(cfg.blocks):
        if bcfg.se:
            raise NotImplementedError(
                "squeeze-excite checkpoints are not supported by the "
                "converter yet")
        bp: dict = {"sub": [], "res": [], "se": []}
        bs: dict = {"sub": [], "res": []}
        stride = 5 if bcfg.separable else 4
        for r in range(bcfg.repeat):
            base = r * stride
            sub: dict = {}
            key = f"encoder.{b}.mconv.{base}.conv.weight"
            if bcfg.separable:
                dw = sd[key]                                        # (C,1,K)
                _check_kernel(dw, bcfg.effective_kernel, key)
                sub["dw_w"] = np.ascontiguousarray(dw[:, 0, :].T)   # (K,C)
                pw = sd[f"encoder.{b}.mconv.{base+1}.conv.weight"]  # (Co,Ci,1)
                if bcfg.groups > 1:
                    sub["pw_w"] = np.ascontiguousarray(pw.transpose(2, 1, 0))
                else:
                    sub["pw_w"] = np.ascontiguousarray(pw[:, :, 0].T)
                bn_idx = base + 2
            else:
                w = sd[key]                                         # (Co,Ci,K)
                _check_kernel(w, bcfg.effective_kernel, key)
                sub["conv_w"] = np.ascontiguousarray(w.transpose(2, 1, 0))
                bn_idx = base + 1
            sub["bn"], bn_stats = _bn_from(sd, f"encoder.{b}.mconv.{bn_idx}")
            bp["sub"].append(sub)
            bs["sub"].append({"bn": bn_stats})
        if bcfg.residual_dense:
            residual_panes.append(feat_in)
            n_panes = len(residual_panes)
        elif bcfg.residual:
            n_panes = 1
        else:
            n_panes = 0
        for p in range(n_panes):
            rw = sd[f"encoder.{b}.res.{p}.0.conv.weight"]           # (Co,Ci,1)
            pane = {"conv_w": np.ascontiguousarray(rw[:, :, 0].T)}
            pane["bn"], pane_stats = _bn_from(sd, f"encoder.{b}.res.{p}.1")
            bp["res"].append(pane)
            bs["res"].append({"bn": pane_stats})
        enc_params.append(bp)
        enc_stats.append(bs)
        feat_in = bcfg.filters
    return {"params": enc_params, "batch_stats": enc_stats}


def decoder_from_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    w = sd["decoder_layers.0.weight"]                               # (V, C, 1)
    return {"w": np.ascontiguousarray(w[:, :, 0].T),
            "b": np.asarray(sd["decoder_layers.0.bias"])}


def variables_from_checkpoints(encoder_path: str, decoder_path: str,
                               cfg: EncoderConfig) -> dict:
    """The unfolded variables tree (numpy, JAX layout) from the reference's
    two checkpoint files (the layout its infer.py:142-143 restores)."""
    enc = encoder_from_state_dict(load_torch_state_dict(encoder_path), cfg)
    return {
        "params": {"encoder": enc["params"],
                   "decoder": decoder_from_state_dict(
                       load_torch_state_dict(decoder_path))},
        "batch_stats": {"encoder": enc["batch_stats"]},
    }


def state_dict_from_variables(variables: dict, cfg: EncoderConfig
                              ) -> Dict[str, np.ndarray]:
    """The inverse (an unfolded tree -> the reference's key layout), for
    exporting checkpoints the reference stack loads. Leaves may be numpy
    arrays or tensors."""
    _check_jasper(cfg)
    variables = to_numpy(variables)
    out: Dict[str, np.ndarray] = {}
    enc = variables["params"]["encoder"]
    stats = variables["batch_stats"]["encoder"]
    for b, bcfg in enumerate(cfg.blocks):
        stride = 5 if bcfg.separable else 4
        for r in range(bcfg.repeat):
            base = r * stride
            sub = enc[b]["sub"][r]
            sub_stats = stats[b]["sub"][r]
            if bcfg.separable:
                out[f"encoder.{b}.mconv.{base}.conv.weight"] = \
                    sub["dw_w"].T[:, None, :]
                pw = sub["pw_w"]
                out[f"encoder.{b}.mconv.{base+1}.conv.weight"] = \
                    pw.transpose(2, 1, 0) if pw.ndim == 3 else pw.T[:, :, None]
                bn_idx = base + 2
            else:
                out[f"encoder.{b}.mconv.{base}.conv.weight"] = \
                    sub["conv_w"].transpose(2, 1, 0)
                bn_idx = base + 1
            pre = f"encoder.{b}.mconv.{bn_idx}"
            out[f"{pre}.weight"] = sub["bn"]["scale"]
            out[f"{pre}.bias"] = sub["bn"]["bias"]
            out[f"{pre}.running_mean"] = sub_stats["bn"]["mean"]
            out[f"{pre}.running_var"] = sub_stats["bn"]["var"]
        for p, pane in enumerate(enc[b]["res"]):
            out[f"encoder.{b}.res.{p}.0.conv.weight"] = \
                pane["conv_w"].T[:, :, None]
            pre = f"encoder.{b}.res.{p}.1"
            out[f"{pre}.weight"] = pane["bn"]["scale"]
            out[f"{pre}.bias"] = pane["bn"]["bias"]
            out[f"{pre}.running_mean"] = stats[b]["res"][p]["bn"]["mean"]
            out[f"{pre}.running_var"] = stats[b]["res"][p]["bn"]["var"]
    dec = variables["params"]["decoder"]
    out["decoder_layers.0.weight"] = dec["w"].T[:, :, None]
    out["decoder_layers.0.bias"] = dec["b"]
    return out
