"""vietasr_tpu_torch/utils/tracing.py: spans and counters that live only
while a torch.profiler records, on a narrow QuartzNet `Transcriber` on the
CPU (random init, seed 0).

Five signals over two buckets with max_batch 2 make three forwards: two
of the 0.5 s bucket (2 rows, 1 row) and one of the 1 s bucket (2 rows).
"""

import gc
import json
import time

import numpy as np
import pytest
import torch
import yaml

from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions
from vietasr_tpu_torch.utils import tracing

torch.set_num_threads(1)

BUCKETS = (0.5, 1.0)
LENGTHS = (3000, 8000, 5200, 12000, 16000)   # 3 in the 0.5 s bucket
GROUPS = [(8000, [3000, 5200]), (8000, [8000]), (16000, [12000, 16000])]
CHILDREN = ("pipeline.pad", "pipeline.upload", "pipeline.featurize",
            "pipeline.encoder", "pipeline.greedy", "pipeline.readback",
            "pipeline.text")


def _yaml(tmp_path):
    path = tmp_path / "narrow.yaml"
    block = dict(repeat=1, stride=[1], dilation=[1], dropout=0.0,
                 separable=True)
    path.write_text(yaml.safe_dump({
        "model": "narrow",
        "AudioToMelSpectrogramPreprocessor": {
            "sample_rate": 16000, "window_size": 0.02,
            "window_stride": 0.01, "window": "hann",
            "normalize": "per_feature", "n_fft": 512, "features": 16,
            "dither": 0.0, "pad_to": 8},
        "JasperEncoder": {"activation": "relu", "conv_mask": True, "jasper": [
            dict(block, filters=32, kernel=[11], stride=[2],
                 residual=False),
            dict(block, filters=32, kernel=[9], residual=True),
            dict(block, filters=48, kernel=[1], residual=False,
                 separable=False)]},
        "labels": [" ", "a", "b", "c"]}))
    return str(path)


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    cfg = _yaml(tmp_path_factory.mktemp("tracing"))

    def make(**opts):
        return Transcriber(cfg, device="cpu", options=TranscriberOptions(
            compute_dtype=None, max_batch=2, buckets_seconds=BUCKETS,
            **opts))
    return make


@pytest.fixture(scope="module")
def signals():
    rng = np.random.RandomState(0)
    return [(rng.randn(n) * 0.1).astype(np.float32) for n in LENGTHS]


def _off_call():
    """A span, as a program makes between traced stretches."""
    with tracing.span("between"):
        pass


def ranges(path):
    """The chrome trace's `vietasr.*` ranges as (name, start, end, parent),
    the parent the index of the innermost range around it on its thread
    (None at the top)."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
              and e["name"].startswith(tracing.PREFIX)]
    spans = [(e["name"][len(tracing.PREFIX):], e["ts"], e["ts"] + e["dur"],
              e["tid"]) for e in ev]
    out = []
    for i, (name, a, b, tid) in enumerate(spans):
        around = [j for j, (_, x, y, t) in enumerate(spans)
                  if j != i and t == tid and x <= a and b <= y]
        parent = min(around, key=lambda j: spans[j][2] - spans[j][1],
                     default=None)
        out.append((name, a, b, parent))
    return out


def test_off_returns_the_null_context_and_records_nothing(
        narrow, signals, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    _off_call()
    before = tracing.summary()

    def refuse(*a, **k):
        raise AssertionError("record_function entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("pipeline.batch") is tracing.span("x")
    assert tracing.span("x") is tracing._NULL
    tracing.count("pipeline.forwards", 3)
    assert not tracing.enabled()
    narrow().transcribe_batch(signals)
    assert tracing.summary() == before


def _traced(tr, signals, path=None):
    _off_call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        texts = [tr.transcribe_batch(signals) for _ in range(2)]
    if path is not None:
        prof.export_chrome_trace(str(path))
    return texts


def test_pipeline_spans_counters_and_request_ids(narrow, signals, tmp_path):
    """Each call (a request) holds its forwards' spans: every span's
    innermost range is its call's `pipeline.batch`."""
    _traced(narrow(), signals, tmp_path / "trace.json")
    spans = ranges(tmp_path / "trace.json")
    calls = [i for i, r in enumerate(spans) if r[0] == "pipeline.batch"]
    assert len(calls) == 2 and all(spans[i][3] is None for i in calls)
    assert {r[0] for r in spans} == {"pipeline.batch", *CHILDREN}
    for call in calls:
        inside = [r[0] for r in spans if r[3] == call]
        assert sorted(inside) == sorted(CHILDREN * len(GROUPS))
    assert all(r[3] in calls for r in spans if r[0] != "pipeline.batch")
    s = tracing.summary()
    assert s["pipeline.batch"]["n"] == 2
    assert s["pipeline.encoder"]["n"] == 2 * len(GROUPS)
    assert set(s) == {"pipeline.batch", *CHILDREN, "pipeline.forwards",
                      "pipeline.rows", "pipeline.signal_samples",
                      "pipeline.padded_samples"}
    rows = sum(len(g) for _, g in GROUPS)
    signal = sum(sum(g) for _, g in GROUPS)
    padded = sum(b * len(g) for b, g in GROUPS) - signal
    assert (s["pipeline.forwards"], s["pipeline.rows"],
            s["pipeline.signal_samples"], s["pipeline.padded_samples"]) \
        == (2 * len(GROUPS), 2 * rows, 2 * signal, 2 * padded)
    # the call's own time is what its children leave
    inner = sum(s[n]["total_s"] for n in CHILDREN)
    assert s["pipeline.batch"]["self_s"] == pytest.approx(
        s["pipeline.batch"]["total_s"] - inner, abs=1e-6)


def test_beam_and_host_beam_spans(narrow, signals, tmp_path):
    for decoder, extra in (("device_beam", "pipeline.beam"),
                           ("beam", None)):
        path = tmp_path / f"{decoder}.json"
        _traced(narrow(decoder=decoder, beam_width=4), signals[:2], path)
        spans = ranges(path)
        names = {r[0] for r in spans}
        if extra:
            assert extra in names
            assert "pipeline.readback" not in names
        else:
            assert {"pipeline.readback", "pipeline.text"} <= names
        assert all(spans[r[3]][0] == "pipeline.batch"
                   for r in spans if r[0] != "pipeline.batch")
        assert names == set(tracing.summary()) - {
            "pipeline.forwards", "pipeline.rows", "pipeline.signal_samples",
            "pipeline.padded_samples"}


def test_texts_equal_with_tracing_on_and_off(narrow, signals):
    tr = narrow()
    off = tr.transcribe_batch(signals)
    assert _traced(tr, signals) == [off, off]
    lp_off, el_off = tr.log_probs(signals[3])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        lp_on, el_on = tr.log_probs(signals[3])
    np.testing.assert_array_equal(lp_on, lp_off)
    np.testing.assert_array_equal(el_on, el_off)


def test_a_new_session_excludes_the_last(narrow, signals):
    _traced(narrow(), signals)
    assert tracing.summary()["pipeline.batch"]["n"] == 2
    _off_call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("only"):
            tracing.count("c", 2)
    s = tracing.summary()
    assert set(s) == {"only", "c"}
    assert s["only"]["n"] == 1 and s["c"] == 2


def test_self_time_on_a_nest(monkeypatch):
    clock = [0]
    _off_call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        monkeypatch.setattr(time, "perf_counter_ns", lambda: clock[0])
        with tracing.span("outer"):                        # 0 .. 75
            clock[0] += 20
            with tracing.span("a"):                        # 20 .. 50
                clock[0] += 30
            with tracing.span("b"):                        # 50 .. 70
                clock[0] += 10
                with tracing.span("c"):                    # 60 .. 70
                    clock[0] += 10
            clock[0] += 5
        with tracing.span("a"):                            # 75 .. 79
            clock[0] += 4
        monkeypatch.undo()
    s = tracing.summary()
    ns = lambda v: round(v * 1e9)  # noqa: E731
    assert {k: (v["n"], ns(v["total_s"]), ns(v["self_s"]))
            for k, v in s.items()} == {
        "outer": (1, 75, 25), "a": (2, 34, 34), "b": (1, 20, 10),
        "c": (1, 10, 10)}


def test_a_long_session_keeps_nothing_a_span():
    """The totals are a few numbers a name: a session of many spans leaves
    no objects behind for the garbage collector."""
    _off_call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(10):               # the names' totals exist
            with tracing.span("x"), tracing.span("y"):
                tracing.count("z")
        gc.collect()
        before = len(gc.get_objects())
        for _ in range(2000):
            with tracing.span("x"), tracing.span("y"):
                tracing.count("z")
        gc.collect()
        after = len(gc.get_objects())
    assert after - before < 100
    s = tracing.summary()
    assert (s["x"]["n"], s["y"]["n"], s["z"]) == (2010, 2010, 2010)
