"""Megatron-style tensor parallelism for the Conformer over the 'model'
mesh axis (counterpart of vietasr_tpu/parallel/tp.py, with its
assignment):

- FFN: the in-projection column-sharded (and its bias), the
  out-projection row-sharded;
- MHSA: the q / k / v / pos projections column-sharded (the heads split
  over 'model'), the per-head biases u / vb sharded on the head axis, the
  output projection row-sharded;
- everything else replicated (LayerNorms, the conv module, the
  subsampling, the decoder).

The JAX package annotates the shardings and GSPMD inserts the
collectives. Here `shard_conformer_variables` gives each rank its slices,
and `conformer_apply(..., tp_group=)` runs each rank's H / world heads and
FFN columns whole, all-reducing after each row-sharded product before its
bias is added once (models/conformer.py), through the f / g pair of
parallel/collectives.py.
"""

from __future__ import annotations

from typing import Optional

import torch


# (path fragment, axis split over 'model'): JAX's _spec_for_path in order
_SPECS = (("ff1/in/w", 1), ("ff2/in/w", 1), ("ff1/in/b", 0),
          ("ff2/in/b", 0), ("ff1/out/w", 0), ("ff2/out/w", 0),
          ("mhsa/q/w", 1), ("mhsa/k/w", 1), ("mhsa/v/w", 1),
          ("mhsa/pos/w", 1), ("mhsa/q/b", 0), ("mhsa/k/b", 0),
          ("mhsa/v/b", 0), ("mhsa/u", 0), ("mhsa/vb", 0),
          ("mhsa/out/w", 0))


def conformer_tp_spec(path: str) -> Optional[int]:
    """The axis of the leaf at `path` ("params/blocks/0/ff1/in/w" or
    "blocks/0/ff1/in/w") split over 'model', or None for a replicated
    leaf. Axis 1 is JAX's P(None, 'model'), axis 0 its P('model') /
    P('model', None)."""
    for fragment, axis in _SPECS:
        if fragment in path:
            return axis
    return None


def shard_leaf(t: torch.Tensor, axis: Optional[int], rank: int,
               size: int) -> torch.Tensor:
    """Rank `rank`'s contiguous 1/size slice of `t` on `axis` (a copy), or
    `t` itself for a replicated leaf."""
    if axis is None or size == 1:
        return t
    n = t.shape[axis]
    if n % size:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split "
                         f"over {size} model shards")
    m = n // size
    return t.narrow(axis, rank * m, m).clone()


def shard_conformer_variables(variables: dict, mesh) -> dict:
    """This rank's variables: each leaf of the spec sliced to its 'model'
    coordinate, every other leaf as it is."""
    rank = mesh.get_local_rank("model")
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    return _map_with_paths(
        lambda path, t: shard_leaf(t, conformer_tp_spec(path), rank, size),
        variables)


def _map_with_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)
