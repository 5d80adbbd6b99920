"""SpecAugment / SpecCutout as masks drawn from a torch.Generator
(counterpart of vietasr_tpu/ops/specaug.py).

Reference semantics (SpectrogramAugmentation): per-sample random bands and
rectangles with widths drawn uniform in [0, width) and starts uniform in
[0, dim - width), built vectorized on the device. x is (B, T, D), time-major
and channels last: frequency masks act on D, time masks on T.

Every random number is a U[0, 1) tensor, drawn in a fixed order (cutout:
f0, t0, wf, wt; then the frequency bands' starts and widths, then the time
bands'). `draws`, where given, supplies those tensors in that order instead
of the generator: the tests hand in JAX's own uniforms so that the masks
can be compared exactly.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from vietasr_tpu_torch.config import SpecAugmentConfig


def _uniform_source(generator: Optional[torch.Generator],
                    draws: Optional[Iterable[torch.Tensor]], device):
    it = iter(draws) if draws is not None else None

    def take(shape) -> torch.Tensor:
        if it is not None:
            u = next(it).to(device=device, dtype=torch.float32)
            if tuple(u.shape) != tuple(shape):
                raise ValueError(f"specaug: a draw of shape {tuple(u.shape)}"
                                 f" where {tuple(shape)} is needed")
            return u
        return torch.rand(shape, generator=generator, device=device)

    return take


def _scaled_floor(u: torch.Tensor, scale: int) -> torch.Tensor:
    return torch.floor(u * float(scale)).to(torch.int32)


def _band_mask(u_start: torch.Tensor, u_width: torch.Tensor, dim: int,
               width: int, active=None) -> torch.Tensor:
    """(B, dim) bool, True where zeroed: n_masks bands per sample from the
    (B, n_masks) uniforms of their starts and widths. `active` (optional
    scalar) keeps band i only where i < active."""
    starts = _scaled_floor(u_start, max(dim - width, 1))
    widths = _scaled_floor(u_width, width)
    idx = torch.arange(dim, device=u_start.device)[None, None, :]
    bands = (idx >= starts[..., None]) & (idx < (starts + widths)[..., None])
    if active is not None:
        n = u_start.shape[1]
        bands = bands & (torch.arange(n, device=u_start.device)[None, :, None]
                         < active)
    return torch.any(bands, dim=1)


def spec_augment(x: torch.Tensor, cfg: SpecAugmentConfig, *,
                 generator: Optional[torch.Generator] = None,
                 active_freq=None, active_time=None, draws=None
                 ) -> torch.Tensor:
    """Frequency + time band masking (SpecAugment, arXiv:1904.08779)."""
    b, t, d = x.shape
    take = _uniform_source(generator, draws, x.device)
    mask = torch.zeros((b, t, d), dtype=torch.bool, device=x.device)
    if cfg.freq_masks > 0:
        shape = (b, cfg.freq_masks)
        fm = _band_mask(take(shape), take(shape), d, cfg.freq_width,
                        active_freq)
        mask = mask | fm[:, None, :]
    if cfg.time_masks > 0:
        shape = (b, cfg.time_masks)
        tm = _band_mask(take(shape), take(shape), t, cfg.time_width,
                        active_time)
        mask = mask | tm[:, :, None]
    return torch.where(mask, torch.zeros_like(x), x)


def spec_cutout(x: torch.Tensor, cfg: SpecAugmentConfig, *,
                generator: Optional[torch.Generator] = None, draws=None
                ) -> torch.Tensor:
    """Random rectangle cutout (arXiv:1708.04552), the reference's exact
    semantics: start_f in [0, D - rect_freq), extent_f in [0, rect_freq);
    start_t in [0, T - rect_time), extent_t in [0, rect_time)."""
    b, t, d = x.shape
    n = cfg.rect_masks
    if n <= 0:
        return x
    take = _uniform_source(generator, draws, x.device)
    f0 = _scaled_floor(take((b, n)), max(d - cfg.rect_freq, 1))
    t0 = _scaled_floor(take((b, n)), max(t - cfg.rect_time, 1))
    wf = _scaled_floor(take((b, n)), cfg.rect_freq)
    wt = _scaled_floor(take((b, n)), cfg.rect_time)
    fi = torch.arange(d, device=x.device)[None, None, :]
    ti = torch.arange(t, device=x.device)[None, None, :]
    f_band = (fi >= f0[..., None]) & (fi < (f0 + wf)[..., None])  # (B, n, D)
    t_band = (ti >= t0[..., None]) & (ti < (t0 + wt)[..., None])  # (B, n, T)
    rects = torch.any(t_band[:, :, :, None] & f_band[:, :, None, :], dim=1)
    return torch.where(rects, torch.zeros_like(x), x)


def apply_spec_augment(x: torch.Tensor, cfg: SpecAugmentConfig, *,
                       generator: Optional[torch.Generator] = None,
                       active_freq=None, active_time=None, draws=None
                       ) -> torch.Tensor:
    """SpectrogramAugmentation: cutout, then SpecAugment (the reference's
    order). `draws` feeds both, cutout's four first."""
    it = iter(draws) if draws is not None else None
    x = spec_cutout(x, cfg, generator=generator, draws=it)
    if cfg.freq_masks > 0 or cfg.time_masks > 0:
        x = spec_augment(x, cfg, generator=generator, active_freq=active_freq,
                         active_time=active_time, draws=it)
    return x
