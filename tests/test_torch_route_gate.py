"""The end-to-end gate of a bf16 kernel route held to the fp32 forward
(`logp_gate` and `route_divergence` in tools/synth_lang_run_torch.py), at
the full width of QuartzNet12x1_vi on the JAX-trained anchors, on the CPU.

Three seeded noise clips of 1.5, 1.9 and 3.1 s (tests/test_torch_pipeline.py's)
go through the port and through `vietasr_tpu.pipeline.Transcriber`.

- Two bf16 routes of two packages, each from its own fp32 forward: the
  port's (the fused repeat blocks at the kernel's rounding points,
  through its plain version on the CPU) as the gate's kernel side and
  JAX's default bf16 route (XLA) as its plain side, over the frames
  inside each clip's length. Measured max |d log p| from fp32: on
  `real_speech_qn12x1_vi` the port's 0.1121 and JAX's 0.0937 (ratio
  1.20); on the causal anchor 0.1483 and 0.1928 (0.77). Both within the
  bar max(0.25, 1.5 d_p). The port's fp32 forward lies 5.7e-5 from JAX's
  on the offline anchor (bar 1e-4) and 1.95e-3 on the causal one (bar
  2.5e-3): `causal_per_feature` divides each frame by the running std of
  the frames so far (JAX's cumulative one-pass formula, ROADMAP C.2),
  which magnifies the two packages' fp32 summation orders, most over the
  first frames (1.95e-3 at frame 4 of the 1.9 s clip, 2.3e-4 at frame 8,
  1.4e-4 past frame 16 of the 3.1 s clip).
- `route_divergence` on the CPU, where the kernel route and the plain
  route are both the plain version: 15 block records and the head's,
  every kernel-vs-plain difference 0, the head's bound sum_k |w_kc|
  |dx_k| at least the measured d logit from fp32.
- Faults injected into the kernel route alone (a monkeypatched
  `quartznet.fused_repeat_block`, which only the default bf16 Transcriber
  calls): each fault that the old rule (|d log p| <= 0.25 kernel vs
  plain) catches on the anchor, the new rule catches too. The expected
  verdicts of both rules are recorded per fault.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from vietasr_tpu_torch.models import quartznet as qn
from vietasr_tpu_torch.models.convert import load_anchor
from vietasr_tpu_torch.ops.repeat_block import (bf16_matmul,
                                                fused_repeat_block_plain)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = importlib.import_module("tools.synth_lang_run_torch")
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHORS = {
    "offline": (CONFIG, os.path.join(ROOT, "artifacts",
                                     "real_speech_qn12x1_vi.msgpack.gz")),
    "causal": (os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                            "quartznet12x1_vi_causal.yaml"),
               os.path.join(ROOT, "artifacts",
                            "real_speech_qn12x1_vi_causal.msgpack.gz"))}
# the two packages' fp32 forwards on the same weights: fp32 sums in
# another order over 15 blocks, and on the causal anchor over the running
# statistics, which its first frames take over a few frames
FP32_TOL = {"offline": 1e-4, "causal": 2.5e-3}
# what the docstring records, to 1e-3: {anchor: (port d, JAX d)}
MEASURED = {"offline": (0.1121, 0.0937), "causal": (0.1483, 0.1928)}


@pytest.fixture(scope="module")
def clips():
    rng = np.random.RandomState(0)
    return [(rng.randn(n) * 0.1).astype(np.float32)
            for n in (24000, 30400, 49600)]


@pytest.fixture(scope="module")
def variables():
    return {k: load_anchor(path) for k, (_, path) in ANCHORS.items()}


@pytest.fixture(scope="module")
def routes(variables):
    """route_transcribers of the offline anchor (kernel, plain, fp32)."""
    return TOOL.route_transcribers(CONFIG, variables["offline"],
                                   device="cpu")


@pytest.fixture(scope="module")
def reference(routes, clips):
    """The plain route's and the fp32 forward's (lp, logits) per clip."""
    return {n: [TOOL.route_forward(routes[n], c) for c in clips]
            for n in ("plain", "fp32")}


@pytest.mark.parametrize("anchor", list(ANCHORS))
def test_port_and_jax_bf16_routes_each_from_their_fp32(anchor, variables,
                                                       clips):
    """The port's bf16 route against its fp32 forward, JAX's against its
    own, by the new gate (JAX's logits read as its log-probs: the row's
    logits up to a shift, which moves no log p)."""
    from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
    from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions

    config, _ = ANCHORS[anchor]
    v = variables[anchor]
    port = TOOL.route_transcribers(config, v, device="cpu")
    jax_bf16 = JaxTranscriber(config, variables=v)
    jax_fp32 = JaxTranscriber(config, variables=v,
                              options=JaxOptions(compute_dtype=None))
    items, fp32_gap = [], 0.0
    for c in clips:
        (lp, el), lg = TOOL.route_forward(port["kernel"], c)
        (lp32, el32), lg32 = TOOL.route_forward(port["fp32"], c)
        jlp, jel = jax_bf16.log_probs(c)
        jlp32, jel32 = jax_fp32.log_probs(c)
        jlp, jlp32 = (np.asarray(a, np.float32) for a in (jlp, jlp32))
        for e in (el32, jel, jel32):
            np.testing.assert_array_equal(np.asarray(e), el)
        n = int(el[0])
        fp32_gap = max(fp32_gap, float(np.abs(lp32[0, :n]
                                              - jlp32[0, :n]).max()))
        items.append(tuple(a[0, :n] for a in (lp, jlp, lg, jlp, lp32, lg32,
                                              jlp32, jlp32)))
    g = TOOL.logp_gate(items)
    assert fp32_gap <= FP32_TOL[anchor]
    assert g["rule"] == "fp32" and g["ok"], TOOL.gate_line(g)
    assert g["d_k"] <= max(TOOL.E2E_LOGP_TOL, TOOL.ROUTE_RATIO * g["d_p"])
    assert (g["d_k"], g["d_p"]) == pytest.approx(MEASURED[anchor], abs=1e-3)


def test_route_divergence_on_the_cpu(variables, routes, clips):
    """Both bf16 routes are the plain version on the CPU: every
    kernel-vs-plain delta is 0, both lie equally far from fp32."""
    r = TOOL.route_divergence(variables["offline"], CONFIG, clips,
                              device="cpu", routes=routes)
    assert len(r["blocks"]) == 15
    assert [b["block"] for b in r["blocks"]] == list(range(15))
    assert [b["channels"] for b in r["blocks"]] == \
        [256] * 7 + [512] * 7 + [1024]
    for b in r["blocks"]:
        assert b["kernel_vs_plain"] == {"max_abs": 0.0, "share_differ": 0.0,
                                        "max_steps": 0.0}
        kf, pf = b["kernel_vs_fp32"], b["plain_vs_fp32"]
        assert kf == pf and 0 < kf["rel_mean"] < kf["rel_max"] < 0.2
        assert b["rms_fp32"] > 0 and b["rows"] > 0
    assert r["first_block_past_one_step"] is None
    g = r["gate"]
    assert g["ok"] and g["max_abs_dlogp"] == 0.0 and g["past_tol"] == 0
    assert g["d_k"] == g["d_p"] > 0
    assert r["tf32"] == TOOL.tf32_flags()
    w = routes["fp32"].variables["params"]["decoder"]["w"].numpy()
    (h,) = r["head"]                     # no entry past 0.25: the worst
    col = w[:, h["cls"]].astype(np.float64)
    assert h["channels"] == 1024 and h["channels_differ"] == 0
    assert (h["bound"], h["dlogit"], h["dlogz"]) == (0.0, 0.0, 0.0)
    assert h["w_l1"] == pytest.approx(np.abs(col).sum(), rel=1e-9)
    assert h["w_l2"] == pytest.approx(np.sqrt((col * col).sum()), rel=1e-9)
    for side in ("kernel", "plain"):
        s = h[side]
        # |sum_k w_kc dx_k| <= sum_k |w_kc| |dx_k| (fp32 sums: 1e-4)
        assert abs(s["dlogit_fp32"]) <= s["bound_fp32"] + 1e-4
        assert s["dlogp_fp32"] == pytest.approx(
            s["dlogit_fp32"] - s["dlogz_fp32"], abs=1e-4)
        assert s["logit"] - h["fp32"]["logit"] == pytest.approx(
            s["dlogit_fp32"], abs=1e-6)


def _block(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *, kernel,
           last_act=False, mask_in=True, pw_round=False,
           round_out="nearest"):
    """The plain version of the repeat block, with knobs that move its
    rounding points or its masking: `mask_in` masks the rows past len
    before each depthwise, `pw_round` rounds each 1x1 product to bf16
    before its bias, `round_out` rounds the output to bf16 to "nearest"
    or "toward_zero"."""
    t = x.shape[1]
    mask = (torch.arange(t)[None, :] < lens[:, None])[:, :, None]
    zero = torch.zeros(())
    cur = x.to(torch.float32)
    for i in range(len(dw_ws)):
        if mask_in:
            cur = torch.where(mask, cur, zero)
        w = dw_ws[i].to(torch.float32)
        y = torch.nn.functional.conv1d(
            cur.transpose(1, 2), w.t().unsqueeze(1), padding=kernel // 2,
            groups=w.shape[1]).transpose(1, 2)
        y = torch.where(mask, y, zero)
        z = bf16_matmul(y, pw_ws[i])
        if pw_round:
            z = z.to(torch.bfloat16).to(torch.float32)
        z = z + bs[i].to(torch.float32)
        if i < len(dw_ws) - 1 or last_act:
            z = torch.relu(z)
        cur = z
    if res_w is not None:
        center = torch.where(mask, x.to(torch.float32), zero)
        cur = cur + (bf16_matmul(center, res_w) + res_b.to(torch.float32))
    out = torch.relu(cur)
    if round_out == "toward_zero":
        out = (out.view(torch.int32) & -65536).view(torch.float32)
    return out.to(x.dtype)


def _zero_last_tap(dw):
    dw = dw.clone()
    dw[-1] = 0.0
    return dw


# (fault, the blocks it hits (1-13, the fused ones), how: "args" edits
# the call's (dw_ws, res_b) or "knobs" runs _block with those knobs, and
# whether the old rule and the new rule catch it on the anchor)
FAULTS = [
    ("last depthwise tap zeroed, block 7", {7},
     ("args", lambda dw, rb: ([_zero_last_tap(w) for w in dw], rb)),
     True, True),
    ("output rounded toward zero, every block", set(range(1, 14)),
     ("knobs", {"round_out": "toward_zero"}), True, True),
    ("residual bias dropped, block 13", {13},
     ("args", lambda dw, rb: (dw, torch.zeros_like(rb))), True, True),
    ("rows past len not masked before the depthwise, every block",
     set(range(1, 14)), ("knobs", {"mask_in": False}), True, True),
    ("1x1 product rounded to bf16 before its bias, every block",
     set(range(1, 14)), ("knobs", {"pw_round": True}), False, False),
    ("depthwise weights rounded to bf16, every block", set(range(1, 14)),
     ("args", lambda dw, rb: ([w.to(torch.bfloat16).to(torch.float32)
                               for w in dw], rb)), False, False),
    ("last depthwise tap zeroed, block 1", {1},
     ("args", lambda dw, rb: ([_zero_last_tap(w) for w in dw], rb)),
     True, True),
]


def test_fault_mirror_is_the_plain_version():
    """_block with no knob is fused_repeat_block_plain bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 16, generator=g).to(torch.bfloat16)
    lens = torch.tensor([40, 23])
    dw = [torch.randn(5, 16, generator=g)]
    pw = [torch.randn(16, 24, generator=g).to(torch.bfloat16)]
    b = [torch.randn(24, generator=g)]
    rw = torch.randn(16, 24, generator=g).to(torch.bfloat16)
    rb = torch.randn(24, generator=g)
    assert torch.equal(_block(x, lens, dw, pw, b, rw, rb, kernel=5),
                       fused_repeat_block_plain(x, lens, dw, pw, b, rw, rb,
                                                kernel=5))
    assert sum(f[3] for f in FAULTS) >= 3


@pytest.mark.parametrize("fault,blocks,how,old_catches,new_catches", FAULTS,
                         ids=[f[0] for f in FAULTS])
def test_injected_faults(fault, blocks, how, old_catches, new_catches,
                         monkeypatch, routes, reference, clips):
    """A fault of the kernel route that the old rule catches, the new one
    catches too."""
    calls = []
    kind, edit = how

    def faulty(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *, kernel,
               last_act=False):
        block = len(calls) % 13 + 1
        calls.append(block)
        knobs = {}
        if block in blocks:
            if kind == "args":
                dw_ws, res_b = edit(dw_ws, res_b)
            else:
                knobs = edit
        return _block(x, lens, dw_ws, pw_ws, bs, res_w, res_b,
                      kernel=kernel, last_act=last_act, **knobs)

    monkeypatch.setattr(qn, "fused_repeat_block", faulty)
    old, new = [], []
    for i, c in enumerate(clips):
        (lp, el), lg = TOOL.route_forward(routes["kernel"], c)
        (lp_p, el_p), lg_p = reference["plain"][i]
        (lp32, _), lg32 = reference["fp32"][i]
        np.testing.assert_array_equal(el, el_p)
        old.append((lp, lp_p, lg, lg_p))
        new.append((lp, lp_p, lg, lg_p, lp32, lg32))
    assert len(calls) == 13 * len(clips)
    g_old, g_new = TOOL.logp_gate(old), TOOL.logp_gate(new)
    assert g_old["rule"] == "kernel_vs_plain" and g_new["rule"] == "fp32"
    assert g_new["kernel_vs_plain_ok"] is g_old["ok"]
    line = f"{fault}: {TOOL.gate_line(g_new)}"
    assert (not g_old["ok"], not g_new["ok"]) == (old_catches,
                                                  new_catches), line
    if not g_old["ok"]:
        assert not g_new["ok"], line
