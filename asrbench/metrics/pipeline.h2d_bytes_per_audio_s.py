"""Host-to-device copy bytes (CUPTI's memcpy records) over the audio
seconds of the traced stretch: the upload, padding included."""

from asrbench.trace import h2d_bytes


def read(tr):
    n = h2d_bytes(tr)
    return n / tr["audio_s"] if n and tr.get("audio_s") else None
