"""Runtime tensor contracts at the public API boundaries (counterpart of
vietasr_tpu/utils/typing.py; the same messages, for numpy arrays and torch
tensors alike)."""

from __future__ import annotations

from typing import Optional


class ContractError(TypeError):
    """Semantic tensor mismatch at an API boundary."""


def _fail(port: str, expected: str, got) -> None:
    raise ContractError(
        f"port {port!r}: expected {expected}, got shape "
        f"{tuple(got.shape)} dtype {got.dtype}")


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def assert_waveform(signal, *, port: str = "signal"):
    """(S,) or (B, S) float waveform (int16 PCM must be scaled first)."""
    if getattr(signal, "ndim", None) not in (1, 2):
        _fail(port, "(S,) or (B, S) float waveform", signal)
    if not _dtype_name(signal).startswith("float"):
        raise ContractError(
            f"port {port!r}: expected float waveform in [-1, 1], got dtype "
            f"{signal.dtype} (scale int PCM by 1/32768 first)")


def assert_audio_batch(signal, lengths=None, *, port: str = "audio_signal"):
    """(B, S) float waveform [+ (B,) int lengths]."""
    if signal.ndim != 2 or not _dtype_name(signal).startswith("float"):
        _fail(port, "(B, S) float waveform", signal)
    if lengths is not None:
        if lengths.ndim != 1 or lengths.shape[0] != signal.shape[0] \
                or not _dtype_name(lengths).startswith("int"):
            _fail(f"{port}.lengths", f"({signal.shape[0]},) int", lengths)


def assert_labels(tokens, lengths=None, *, port: str = "targets"):
    """(B, L) int label ids [+ (B,) int lengths]."""
    if tokens.ndim != 2 or not _dtype_name(tokens).startswith("int"):
        _fail(port, "(B, L) int labels", tokens)
    if lengths is not None and (lengths.ndim != 1
                                or lengths.shape[0] != tokens.shape[0]):
        _fail(f"{port}.lengths", f"({tokens.shape[0]},) int", lengths)


def assert_features(feats, *, n_features: Optional[int] = None,
                    port: str = "features"):
    """(B, T, D) float features, channels last. A (B, D, T) tensor passed
    by mistake is named as transposed."""
    if feats.ndim != 3 or not _dtype_name(feats).startswith(
            ("float", "bfloat")):
        _fail(port, "(B, T, D) float features", feats)
    if n_features is not None and feats.shape[2] != n_features:
        if feats.shape[1] == n_features:
            raise ContractError(
                f"port {port!r}: axes look TRANSPOSED — expected channels "
                f"last (B, T, {n_features}), got {tuple(feats.shape)} "
                "(channels-first, the reference's torch layout)")
        _fail(port, f"(B, T, {n_features}) features", feats)


def assert_log_probs(log_probs, *, num_classes: Optional[int] = None,
                     port: str = "log_probs"):
    """(B, T, V+1) float log-probabilities (blank = last class)."""
    if log_probs.ndim != 3 or not _dtype_name(log_probs).startswith("float"):
        _fail(port, "(B, T, V+1) float log-probs", log_probs)
    if num_classes is not None and log_probs.shape[2] != num_classes + 1:
        if log_probs.shape[1] == num_classes + 1:
            raise ContractError(
                f"port {port!r}: axes look TRANSPOSED — expected "
                f"(B, T, {num_classes + 1}) with classes last, got "
                f"{tuple(log_probs.shape)}")
        _fail(port, f"(B, T, {num_classes + 1}) log-probs", log_probs)
