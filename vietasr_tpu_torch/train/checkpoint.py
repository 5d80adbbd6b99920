"""Checkpoint manager: step-stamped saves, keep-last-K, restore of the
newest (counterpart of vietasr_tpu/train/checkpoint.py).

The port writes `state-STEP-<n>.pt`: params, batch stats, the optimizer's
state_dict, step and skipped_steps, by torch.save (an atomic rename, so a
crash never leaves a torn file). Both restores also read the JAX
package's `state-STEP-<n>.msgpack` (flax's serialized TrainState) through
the port's own msgpack decoder: `restore` the whole TrainState (params,
batch stats, step, skipped steps and the optax state of any optimizer
the JAX package's make_optimizer builds, models/convert.py
assign_jax_opt_state), `restore_variables` params and batch stats only.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from vietasr_tpu_torch.models.convert import (assign_jax_opt_state,
                                              msgpack_restore,
                                              params_from_jax)
from vietasr_tpu_torch.models.quartznet import assign_tree, map_tree
from vietasr_tpu_torch.utils.device import resolve_device

_CKPT_RE = re.compile(r"state-STEP-(\d+)\.(pt|msgpack)$")


def _lists_from_state_dict(tree):
    """flax writes a list as a dict keyed "0".."n-1": turn those back into
    lists (an empty list stays an empty dict, which iterates the same)."""
    if isinstance(tree, dict):
        if tree and sorted(tree) == sorted(str(i) for i in range(len(tree))):
            return [_lists_from_state_dict(tree[str(i)])
                    for i in range(len(tree))]
        return {k: _lists_from_state_dict(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """`folder` of step-stamped checkpoints; restores go to `device` (None:
    CUDA)."""

    def __init__(self, folder: str, *, keep: int = 4, device=None):
        self.folder = folder
        self.keep = keep
        self.device = resolve_device(device)
        os.makedirs(folder, exist_ok=True)

    def _files(self) -> dict:
        """{step: file name}; a port checkpoint wins over a JAX one."""
        found: dict = {}
        for name in sorted(os.listdir(self.folder),
                           key=lambda n: n.endswith(".pt")):
            m = _CKPT_RE.search(name)
            if m:
                found[int(m.group(1))] = name
        return found

    def list_steps(self) -> List[int]:
        return sorted(self._files())

    def _pick(self, step: Optional[int]) -> Optional[str]:
        files = self._files()
        if not files:
            return None
        step = max(files) if step is None else int(step)
        return os.path.join(self.folder, files[step])

    def save(self, state, step: Optional[int] = None) -> str:
        step = int(state.step) if step is None else int(step)
        cpu = lambda t: t.detach().cpu()  # noqa: E731
        payload = {"params": map_tree(cpu, state.params),
                   "batch_stats": map_tree(cpu, state.batch_stats),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step),
                   "skipped_steps": int(state.skipped_steps)}
        path = os.path.join(self.folder, f"state-STEP-{step}.pt")
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._prune()
        return path

    def restore(self, state, step: Optional[int] = None):
        """Load the newest (or the given) checkpoint, the port's or the JAX
        package's, into `state` (a TrainState with the same tree and
        optimizer kind), in place. Returns it, or None when the folder
        holds no checkpoint."""
        path = self._pick(step)
        if path is None:
            return None
        if path.endswith(".msgpack"):
            return self._restore_jax(state, path)
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        with torch.no_grad():
            assign_tree(state.params, payload["params"])
            assign_tree(state.batch_stats, payload["batch_stats"])
            state.step.fill_(payload["step"])
            state.skipped_steps.fill_(payload["skipped_steps"])
        state.optimizer.load_state_dict(payload["optimizer"])
        return state

    def _restore_jax(self, state, path: str):
        with open(path, "rb") as f:
            raw = _lists_from_state_dict(msgpack_restore(f.read()))
        variables = params_from_jax({"params": raw["params"],
                                     "batch_stats": raw["batch_stats"]},
                                    device=self.device)
        step, skipped = int(raw["step"]), int(raw["skipped_steps"])
        with torch.no_grad():
            assign_tree(state.params, variables["params"])
            assign_tree(state.batch_stats, variables["batch_stats"])
            state.step.fill_(step)
            state.skipped_steps.fill_(skipped)
        assign_jax_opt_state(state, raw["opt_state"],
                             applied_updates=step - skipped)
        return state

    def restore_variables(self, step: Optional[int] = None
                          ) -> Optional[dict]:
        """{params, batch_stats} of the newest (or given) checkpoint as
        tensors on the device, whichever optimizer wrote it: a port `.pt`
        or a JAX `.msgpack`."""
        path = self._pick(step)
        if path is None:
            return None
        if path.endswith(".pt"):
            payload = torch.load(path, map_location=self.device,
                                 weights_only=True)
            return {"params": payload["params"],
                    "batch_stats": payload["batch_stats"]}
        with open(path, "rb") as f:
            raw = _lists_from_state_dict(msgpack_restore(f.read()))
        return params_from_jax({"params": raw["params"],
                                "batch_stats": raw["batch_stats"]},
                               device=self.device)

    def _prune(self):
        files = self._files()
        steps = sorted(files)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            try:
                os.remove(os.path.join(self.folder, files[s]))
            except OSError:
                pass

