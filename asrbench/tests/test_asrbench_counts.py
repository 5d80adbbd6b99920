"""The counts reproduce PERF.md's kernel-table bounds at the shapes the
table states (chip_smoke.py's phase 3, 4 and 7 shapes, drawn the same
way)."""

import numpy as np
import pytest

from asrbench.counts import ctc, frontend, quartznet, repeat_block

FCFG = {"sample_rate": 16000, "window_size": 0.02, "window_stride": 0.01,
        "n_fft": 512, "features": 64, "pad_to": 16}


def test_frontend_bound_b8_16_7s():
    secs, _, nbytes = frontend.launch(FCFG, 8, 267200)
    assert round(secs * 1e3, 4) == 0.0037
    assert abs(nbytes - 12.45e6) < 0.01e6


def _phase4_rows(c_in, c_out, k, r, bsz=8, t=840):
    """The ragged lengths of phase 4's operands: a seeded draw after the
    block input's normals, row 0 full."""
    rng = np.random.RandomState(c_in + c_out + k + r)
    rng.randn(bsz, t, c_in)
    lens = rng.randint(t // 4, t + 1, size=bsz)
    lens[0] = t
    return int(lens.sum())


@pytest.mark.parametrize("r, shapes, want_ms", [
    (1, [(256, 256, 33, 3), (256, 256, 39, 3), (256, 512, 51, 1),
         (512, 512, 51, 2), (512, 512, 63, 3), (512, 512, 75, 1)], 0.0411),
    (5, [(256, 256, 33, 3), (256, 256, 39, 3), (256, 512, 51, 1),
         (512, 512, 51, 2), (512, 512, 63, 3), (512, 512, 75, 3)], 0.2461),
])
def test_repeat_bounds_per_forward(r, shapes, want_ms):
    total = sum(n * repeat_block.launch(8, 840, c_in, c_out, k, r, True,
                                        _phase4_rows(c_in, c_out, k, r))[0]
                for c_in, c_out, k, n in shapes)
    assert round(total * 1e3, 4) == want_ms


def test_ctc_bounds_training_shape():
    rng = np.random.RandomState(7)
    secs = rng.uniform(1.5, 16.7, size=32)
    secs[0] = 16.7
    ilen = np.minimum((secs * 50).astype(np.int32), 840)
    tlen = np.round(secs * 13).astype(np.int32)
    (a, _, _), (b, _, _) = ctc.launches(ilen, tlen, 840,
                                        2 * int(tlen.max()) + 1)
    assert (round(a * 1e3, 4), round(b * 1e3, 4)) == (0.0195, 0.0250)


def test_model_flops_match_a_hand_count():
    blocks = [{"filters": 8, "repeat": 2, "kernel": [3], "stride": [1],
               "dilation": [1], "residual": True, "separable": True},
              {"filters": 16, "repeat": 1, "kernel": [1], "stride": [1],
               "dilation": [1], "residual": False, "separable": False}]
    frames = np.array([10, 4])
    per_frame = ((2 * 3 * 4 + 2 * 4 * 8) + (2 * 3 * 8 + 2 * 8 * 8)
                 + 2 * 4 * 8) + 2 * 8 * 16 + 2 * 16 * 5
    assert quartznet.forward_flops(blocks, 4, 5, frames) == 14 * per_frame


def test_eligible_blocks_are_the_kernel_routes():
    from asrbench import core
    for name, want in (("qn12x1_vi", 13), ("qn15x5_vi", 15)):
        blocks = core.config(name)["blocks"]
        assert sum(repeat_block.eligible(b) for b in blocks) == want
