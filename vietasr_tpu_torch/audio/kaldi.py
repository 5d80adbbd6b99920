"""Kaldi ark / scp feature I/O (counterpart of vietasr_tpu/audio/kaldi.py).

Binary matrix records: uncompressed "FM" (fp32) and "DM" (fp64, read back
as fp32) and the compressed "CM" format (per-column percentile headers and
one byte per element), read and written; text-format arks raise
ValueError and the "CM2" / "CM3" variants NotImplementedError. This is
host I/O, so it stays numpy, and the writers produce the same bytes as the
JAX package's on the same matrices.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def _read_token(f) -> bytes:
    tok = b""
    while True:
        ch = f.read(1)
        if not ch or ch == b" ":
            break
        tok += ch
    return tok


def _read_matrix(f) -> np.ndarray:
    binary = f.read(2)
    if binary != b"\x00B":
        raise ValueError(f"expected binary kaldi header, got {binary!r} "
                         "(text-format arks are not supported)")
    mtype = _read_token(f)
    if mtype == b"CM":
        return _read_compressed(f)
    if mtype in (b"CM2", b"CM3"):
        raise NotImplementedError(
            f"kaldi compression variant {mtype!r} not supported (only the "
            "default per-column-percentile 'CM' format)")
    if mtype not in (b"FM", b"DM"):
        raise ValueError(f"unsupported kaldi matrix type {mtype!r}")
    dtype = np.float32 if mtype == b"FM" else np.float64

    def read_dim():
        size = struct.unpack("<b", f.read(1))[0]
        if size != 4:
            raise ValueError(f"kaldi matrix dimension of {size} bytes, "
                             "expected 4")
        return struct.unpack("<i", f.read(4))[0]

    rows, cols = read_dim(), read_dim()
    data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype=dtype)
    return data.reshape(rows, cols).astype(np.float32)


def _read_compressed(f) -> np.ndarray:
    """Kaldi 'CM' CompressedMatrix: global {min, range, rows, cols}, then a
    per-column header of four uint16 percentiles (0/25/75/100) and one uint8
    per element, piecewise-linearly mapped within the percentile segments."""
    min_value, value_range = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    headers = np.frombuffer(f.read(cols * 8), dtype="<u2").reshape(cols, 4)
    data = np.frombuffer(f.read(rows * cols), dtype=np.uint8) \
        .reshape(cols, rows)                       # column-major
    p = min_value + value_range * (headers.astype(np.float64) / 65535.0)
    p0, p25, p75, p100 = p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]
    c = data.astype(np.float64)
    out = np.where(
        c <= 64, p0 + (p25 - p0) * c / 64.0,
        np.where(c <= 192, p25 + (p75 - p25) * (c - 64) / 128.0,
                 p75 + (p100 - p75) * (c - 192) / 63.0))
    return out.T.astype(np.float32)                # (rows, cols)


def write_compressed_ark(path: str, records: Dict[str, np.ndarray]) -> None:
    """Write 'CM'-compressed records (lossy, ~1 byte/element), for tests and
    interchange with kaldi tooling that expects --compress=true arks."""
    with open(path, "wb") as f:
        for key, mat in records.items():
            mat = np.ascontiguousarray(mat, np.float64)
            rows, cols = mat.shape
            mn = float(mat.min())
            rng = max(float(mat.max()) - mn, 1e-10)
            f.write(key.encode("utf-8") + b" \x00BCM ")
            f.write(struct.pack("<ffii", mn, rng, rows, cols))
            to_u16 = lambda v: np.clip(
                np.round((v - mn) / rng * 65535.0), 0, 65535).astype("<u2")
            pct = np.percentile(mat, [0, 25, 75, 100], axis=0)   # (4, cols)
            # quantize the percentiles exactly as they will be decoded
            pct_q = mn + rng * (to_u16(pct).astype(np.float64) / 65535.0)
            headers = to_u16(pct).T.copy()                       # (cols, 4)
            f.write(headers.astype("<u2").tobytes())
            p0, p25, p75, p100 = (pct_q[i][None, :] for i in range(4))
            x = mat
            seg1 = np.clip((x - p0) / np.maximum(p25 - p0, 1e-10), 0, 1) * 64
            seg2 = 64 + np.clip((x - p25) / np.maximum(p75 - p25, 1e-10),
                                0, 1) * 128
            seg3 = 192 + np.clip((x - p75) / np.maximum(p100 - p75, 1e-10),
                                 0, 1) * 63
            codes = np.where(x <= p25, seg1, np.where(x <= p75, seg2, seg3))
            codes = np.clip(np.round(codes), 0, 255).astype(np.uint8)
            f.write(codes.T.tobytes())             # column-major


def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (utterance_id, features (T, D)) from a binary ark file."""
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            yield key.decode("utf-8"), _read_matrix(f)


def read_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate records via an scp index ("key ark_path:offset" lines)."""
    with open(path, "r", encoding="utf-8") as scp:
        for line in scp:
            line = line.strip()
            if not line:
                continue
            key, loc = line.split(None, 1)
            ark_path, offset = loc.rsplit(":", 1)
            with open(ark_path, "rb") as f:
                f.seek(int(offset))
                yield key, _read_matrix(f)


def write_ark(path: str, records: Dict[str, np.ndarray],
              scp_path: Optional[str] = None) -> None:
    """Write binary float-matrix ark (+ optional scp), for tests and
    interchange with Kaldi tooling."""
    scp_lines: List[str] = []
    with open(path, "wb") as f:
        for key, mat in records.items():
            f.write(key.encode("utf-8") + b" ")
            scp_lines.append(f"{key} {path}:{f.tell()}")
            f.write(b"\x00BFM ")
            mat = np.ascontiguousarray(mat, np.float32)
            for dim in mat.shape:
                f.write(struct.pack("<b", 4) + struct.pack("<i", dim))
            f.write(mat.tobytes())
    if scp_path:
        with open(scp_path, "w", encoding="utf-8") as f:
            f.write("\n".join(scp_lines) + "\n")


class KaldiFeatureDataset:
    """Pre-computed features + text from kaldi-style dirs (feats.scp,
    text), mirroring the reference KaldiFeatureDataset capabilities."""

    def __init__(self, feats_scp: str, text_path: str, tokenizer,
                 *, min_len: int = 0, max_len: int = 0):
        texts: Dict[str, str] = {}
        with open(text_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split(None, 1)
                if len(parts) == 2:
                    texts[parts[0]] = parts[1]
        self.items: List[Tuple[str, np.ndarray, List[int]]] = []
        self.num_dropped = 0
        for key, feats in read_scp(feats_scp):
            text = texts.get(key)
            ids = tokenizer.encode(text) if text else None
            t = feats.shape[0]
            if ids is None or (min_len and t < min_len) \
                    or (max_len and t > max_len):
                self.num_dropped += 1
                continue
            self.items.append((key, feats, ids))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int):
        return self.items[i]
