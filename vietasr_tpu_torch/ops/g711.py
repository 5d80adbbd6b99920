"""G.711 decode on the device (counterpart of vietasr_tpu/ops/g711.py).

The 8-bit telephony wire format goes to the card as uint8, a quarter of
the bytes of float32 samples, and is decoded there by integer bit
arithmetic: the same formulas as the host codec (audio/g711.py), scaled
to float32 in [-1, 1] by 1/32768, so both give the same floats.
"""

from __future__ import annotations

import torch

_SCALE = 1.0 / 32768.0


def ulaw_decode_f32(u: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law codes -> float32 in [-1, 1] (int16-compatible scale)."""
    u = (~u.to(torch.int32)) & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = torch.bitwise_left_shift((mant << 3) + 0x84, exp) - 0x84
    return torch.where(sign != 0, -mag, mag).to(torch.float32) * _SCALE


def alaw_decode_f32(u: torch.Tensor) -> torch.Tensor:
    """uint8 A-law codes -> float32 in [-1, 1] (int16-compatible scale)."""
    u = u.to(torch.int32) ^ 0x55
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag0 = (mant << 4) + 8
    magn = torch.bitwise_left_shift((mant << 4) + 0x108,
                                    torch.clamp_min(exp - 1, 0))
    mag = torch.where(exp == 0, mag0, magn)
    return torch.where(sign != 0, mag, -mag).to(torch.float32) * _SCALE


def decode_wire(x: torch.Tensor, encoding: str = "ulaw") -> torch.Tensor:
    """A device buffer in its wire dtype -> float32: uint8 G.711 codes
    (`encoding` "ulaw" or "alaw"), int16 PCM (/ 32768) or float."""
    if x.dtype == torch.uint8:
        if encoding not in ("ulaw", "alaw"):
            raise ValueError("uint8 samples are G.711 wire bytes; the "
                             "encoding must be 'ulaw' or 'alaw'")
        return (ulaw_decode_f32 if encoding == "ulaw"
                else alaw_decode_f32)(x)
    if x.dtype == torch.int16:
        return x.to(torch.float32) * _SCALE
    return x.to(torch.float32)
