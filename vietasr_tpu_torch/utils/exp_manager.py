"""Experiment manager (counterpart of vietasr_tpu/utils/exp_manager.py): a
work directory, timestamped by rank 0's clock on every process
(`parallel/distributed.py::broadcast_string`), a checkpoints/ directory,
metrics.jsonl, copies of the config files and the run's provenance
(cmd-args.log, git-info.log), written by the main process only.
TensorBoard scalars are mirrored where `torch.utils.tensorboard` imports.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional, Sequence

from vietasr_tpu_torch.parallel.distributed import (broadcast_string,
                                                    is_main_process)


class ExpManager:
    def __init__(
        self,
        work_dir: str,
        *,
        use_timestamp: bool = True,
        make_checkpoint_dir: bool = True,
        use_tensorboard: bool = False,
        config_files: Sequence[str] = (),
    ):
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S") if use_timestamp else ""
        stamp = broadcast_string(stamp)      # every process the same suffix
        self.work_dir = os.path.join(work_dir, stamp) if stamp else work_dir
        self.is_main = is_main_process()
        os.makedirs(self.work_dir, exist_ok=True)
        self.checkpoint_dir = None
        if make_checkpoint_dir:
            self.checkpoint_dir = os.path.join(self.work_dir, "checkpoints")
            os.makedirs(self.checkpoint_dir, exist_ok=True)

        self._metrics_path = os.path.join(self.work_dir, "metrics.jsonl")
        self._tb = None
        if use_tensorboard and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=os.path.join(self.work_dir, "tb"))
            except ImportError:
                self._tb = None

        if self.is_main:
            for cf in config_files:
                try:
                    shutil.copy(cf, self.work_dir)
                except OSError:
                    pass
            self._dump_provenance()

    def _dump_provenance(self):
        """argv, and the git commit and diff of the working directory."""
        with open(os.path.join(self.work_dir, "cmd-args.log"), "w") as f:
            f.write(" ".join(sys.argv) + "\n")
        try:
            rev = subprocess.run(["git", "rev-parse", "HEAD"],
                                 capture_output=True, text=True,
                                 timeout=10).stdout.strip()
            diff = subprocess.run(["git", "diff"], capture_output=True,
                                  text=True, timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            return
        with open(os.path.join(self.work_dir, "git-info.log"), "w") as f:
            f.write(f"commit: {rev}\n\n{diff}")

    def log_metrics(self, metrics: dict, step: Optional[int] = None):
        """Append a record to metrics.jsonl (main process only), and its
        numbers to TensorBoard when a step is given."""
        if not self.is_main:
            return
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
        if self._tb is not None and step is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
