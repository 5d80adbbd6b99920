"""Polyphase FIR resampling on the device (counterpart of
vietasr_tpu/ops/resample.py).

The same filter as the host path (audio/io.py::resample, scipy's
`resample_poly`): `firwin` taps with a Kaiser window (beta 5.0), half
length 10 * max(up, down), scaled by `up`; the signal zero-padded as
`upfirdn` pads it; the output trimmed by the filter's delay to
ceil(N * up / down) samples. JAX computes it as one convolution of the
zero-stuffed signal; here the zero taps are skipped: output m = p * up + s
is sum_j x[a_s + p * down + j] * h[j * up + r_s], so the `up` phases are
the output channels of ONE strided `conv1d` over the signal, each phase's
sub-filter shifted right by its start offset a_s - a_0 (< down + 1 taps).
That costs ceil(K / up) + down multiply-adds an output sample.

The convolution runs in IEEE fp32 whatever the global cuDNN flags say
(utils/device.py::strict_fp32): cuDNN's TF32 default would move the result
away from scipy's.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from vietasr_tpu_torch.utils.device import strict_fp32


def _scipy_taps(up: int, down: int) -> np.ndarray:
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    return (firwin(2 * half_len + 1, 1.0 / max_rate,
                   window=("kaiser", 5.0)) * up).astype(np.float32)


def polyphase_weights(up: int, down: int):
    """(weight (up, 1, L) f32, a_0): phase s's sub-filter h[j * up + r_s]
    at taps a_s - a_0 + j of output channel s; a_0 is the input offset of
    output 0 (may be negative: zero padding)."""
    taps = _scipy_taps(up, down)
    k = len(taps)
    half = (k - 1) // 2
    q = np.arange(up) * down - half                # output s at x_up[q + k]
    a = -(-q // up)                                # first input sample used
    r = a * up - q                                 # its tap, in [0, up)
    sub = -(-k // up)
    width = sub + int(a[-1] - a[0])
    w = np.zeros((up, 1, width), np.float32)
    for s in range(up):
        g = taps[r[s]::up]
        w[s, 0, a[s] - a[0]: a[s] - a[0] + len(g)] = g
    return w, int(a[0])


def make_device_resampler(orig_sr: int, target_sr: int, *, device=None
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """resample(x: (..., N) f32) -> (..., ceil(N * up / down)) f32 on x's
    device, equal to audio/io.py::resample to fp32 rounding. The weights
    are built once, here, and moved to `device` (None: the first call's)."""
    if orig_sr == target_sr:
        return lambda x: x
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    w_np, a0 = polyphase_weights(up, down)
    cache = {}
    if device is not None:
        cache[torch.device(device)] = torch.from_numpy(w_np).to(device)

    def resample(x: torch.Tensor) -> torch.Tensor:
        w = cache.get(x.device)
        if w is None:
            w = cache[x.device] = torch.from_numpy(w_np).to(x.device)
        lead, n = x.shape[:-1], x.shape[-1]
        n_out = -(-n * up // down)
        n_pos = -(-n_out // up)                    # outputs a phase
        width = w.shape[-1]
        need = (n_pos - 1) * down + width          # input span from a_0
        pad_l = -a0
        pad_r = max(need - pad_l - n, 0)
        xb = F.pad(x.reshape(-1, 1, n).to(torch.float32), (pad_l, pad_r))
        with strict_fp32():
            y = F.conv1d(xb[..., :need], w, stride=down)    # (B, up, P)
        y = y.transpose(1, 2).reshape(-1, n_pos * up)[:, :n_out]
        return y.reshape(lead + (n_out,))

    return resample
