"""The trainer's `trainer.multi_tensor_share` (the program's optimizer
counters, read by asrbench/metrics/trainer.multi_tensor_share.py): 100
when every tensor takes the list-wise step, None where neither counter
was counted, as on a program whose optimizer counts nothing."""

import pytest

from asrbench import core


def _read():
    return core.load("metrics", "trainer.multi_tensor_share").read({})


@pytest.mark.parametrize("counts, want", [
    ({"optim.multi_tensor": 100}, 100.0),
    ({"optim.multi_tensor": 75, "optim.per_tensor": 25}, 75.0),
    ({"train.steps": 3, "train.rows": 12}, None),
    ({}, None)])
def test_share_of_the_counters(monkeypatch, counts, want):
    from vietasr_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "summary", lambda: counts)
    assert _read() == want


def test_a_traced_step_of_the_program_reads_100():
    """One Novograd step of the cell's settings, traced, on the CPU."""
    import torch

    from vietasr_tpu_torch.train import make_optimizer

    params = [torch.ones(s, requires_grad=True)
              for s in ((4, 3), (3,), (1,), (2, 2, 2))]
    opt = make_optimizer("novograd", 0.01, betas=(0.95, 0.98),
                         weight_decay=0.001, grad_clip_norm=5.0)(params)
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    with torch.profiler.profile():
        opt.step(finite=torch.tensor(True))
        share = _read()
    assert share == 100.0
