"""The output check fails where the timed path is broken underneath: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a small size with one fault planted in the program. The controls (the
program's own int8 path, its bf16 frontend; the reference in float8 in
the trainer's place) fail it too."""

import pytest

from asrbench.tests.conftest import SMALL

GREEDY = [("qn12x1_vi.greedy_b32", SMALL["offline_greedy_b32"]),
          ("qn15x5_vi.greedy_b32", SMALL["offline_greedy_b32"])]
TRAIN = ("qn12x1_vi.train_b64", SMALL["train_bucketed_b64"])


@pytest.mark.parametrize("workload, small", GREEDY)
def test_token_altered_where_produced(cpu_run, monkeypatch, workload, small):
    from vietasr_tpu_torch import pipeline
    real = pipeline.greedy_decode

    def altered(log_probs, lengths, *, blank):
        preds, keep = real(log_probs, lengths, blank=blank)
        preds = preds.clone()
        preds[:, 1] = (preds[:, 1] + 1) % (blank + 1)
        return preds, keep

    monkeypatch.setattr(pipeline, "greedy_decode", altered)
    res = cpu_run(workload, small)
    assert res["correct"] is False
    assert res["checks"]["ids_mismatch"][0] > 0


@pytest.mark.parametrize("workload, small", GREEDY)
def test_answer_altered_where_produced(cpu_run, monkeypatch, workload,
                                       small):
    from vietasr_tpu_torch import pipeline
    real = pipeline.ids_to_text
    monkeypatch.setattr(pipeline, "ids_to_text",
                        lambda ids, labels: real(ids, labels) + "a")
    res = cpu_run(workload, small)
    assert res["correct"] is False
    assert res["checks"]["text_mismatch"][0] > 0


@pytest.mark.parametrize("workload, small, number", [
    (*GREEDY[0], "logp_max_abs"), (*GREEDY[1], "logp_row_max_ratio")])
def test_one_row_garbled_in_the_encoder(cpu_run, monkeypatch, workload,
                                        small, number):
    """The last row of each forward's head output garbled (its label axis
    rolled) before the greedy decode: the served ids and texts agree with
    what was served, and the frontend is untouched, so only a number held
    row by row can see it."""
    from vietasr_tpu_torch import pipeline
    real = pipeline.model_apply

    def garbled(*a, **kw):
        lp, lens = real(*a, **kw)
        lp = lp.clone()
        lp[-1] = lp[-1].roll(1, dims=-1)
        return lp, lens

    monkeypatch.setattr(pipeline, "model_apply", garbled)
    res = cpu_run(workload, small)
    assert res["correct"] is False
    value, limit = res["checks"][number]
    assert value > limit
    assert res["checks"]["ids_mismatch"][0] == 0
    assert res["checks"]["text_mismatch"][0] == 0
    assert 0 < res["failed"] < res["attempted"]


def test_step_returns_its_state_unchanged(cpu_run, monkeypatch):
    from vietasr_tpu_torch.train import optim
    monkeypatch.setattr(optim.Novograd, "_update",
                        lambda self, p, g, state, group, count:
                        (p, dict(state)))
    res = cpu_run(*TRAIN)
    assert res["correct"] is False
    assert res["checks"]["change_gap"][0] == pytest.approx(1.0)


def test_half_the_batch_left_out(cpu_run, monkeypatch):
    from vietasr_tpu_torch.train import loop
    real = loop.batch_to_tensors

    def half(batch, device):
        t = real(batch, device)
        t["signal_lens"] = t["signal_lens"].clone()
        t["signal_lens"][len(t["signal_lens"]) // 2:] = 0
        return t

    monkeypatch.setattr(loop, "batch_to_tensors", half)
    res = cpu_run(*TRAIN)
    assert res["correct"] is False


@pytest.mark.parametrize("workload, small, control", [
    *((w, s, c) for w, s in GREEDY for c in ("int8", "fast")),
    (*TRAIN, "fp8"), (*TRAIN, "half_batch")])
def test_controls_fail(cpu_run, workload, small, control):
    res = cpu_run(workload, small, "--control", control)
    assert res["correct"] is False


def test_plain_route_is_a_witness_not_a_control(cpu_run):
    res = cpu_run(*GREEDY[1], "--control", "plain")
    assert res["correct"] is True
