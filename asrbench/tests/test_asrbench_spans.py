"""The per-layer metrics read from the program's own spans and counters
(asrbench/spans.py): a traced CPU run of each cell reports them, and a
program without the tracing module leaves them out without raising."""

import math
import sys

import pytest

from asrbench import core
from asrbench.tests.conftest import SMALL

GREEDY = ["pipeline.pad_ms_per_forward", "pipeline.dispatch_ms_per_forward",
          "pipeline.device_wait_ms_per_forward", "pipeline.padded_share",
          "pipeline.padding_s_per_row"]
TRAIN = ["trainer.batch_wait_ms_per_step", "trainer.upload_ms_per_step",
         "trainer.dispatch_ms_per_step", "trainer.optimizer_ms_per_step",
         "trainer.padded_share", "trainer.padding_s_per_row"]
ABOVE_ZERO = {"pipeline.pad_ms_per_forward",
              "pipeline.dispatch_ms_per_forward",
              "pipeline.padded_share", "pipeline.padding_s_per_row",
              "trainer.dispatch_ms_per_step", "trainer.padded_share",
              "trainer.padding_s_per_row"}


@pytest.mark.parametrize("workload, names", [
    ("qn12x1_vi.greedy_b32", GREEDY), ("qn12x1_vi.train_b64", TRAIN)])
def test_traced_run_reports_the_span_metrics(cpu_run, workload, names):
    mix = core.workload(workload)["traffic"]
    # a window long enough that the stretch (1 s in) starts on a loaded host
    res = cpu_run(workload, SMALL[mix], trace=1, seconds=4.0)
    assert res["correct"] is True
    units = {m["name"]: m["unit"]
             for m in core.cell_metrics(workload)["per_layer"]}
    for name in names:
        value = res["metrics"][name]["value"]
        assert res["metrics"][name]["unit"] == units[name]
        assert math.isfinite(value) and value >= 0, name
        if name in ABOVE_ZERO:
            assert value > 0, name
        if name.endswith("padded_share"):
            assert value < 100, name


def test_without_the_tracing_module_the_readers_give_none(monkeypatch):
    import vietasr_tpu_torch.utils

    monkeypatch.delattr(vietasr_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "vietasr_tpu_torch.utils.tracing",
                        None)
    for name in GREEDY + TRAIN:
        assert core.load("metrics", name).read({}) is None, name


def test_a_session_without_the_work_gives_none(monkeypatch):
    """A stretch that ran none of a metric's work reads nothing."""
    from vietasr_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "summary", lambda: {})
    tr = {"config": core.config(core.workload("qn12x1_vi.greedy_b32")
                                ["config"])}
    for name in GREEDY + TRAIN:
        assert core.load("metrics", name).read(tr) is None, name
