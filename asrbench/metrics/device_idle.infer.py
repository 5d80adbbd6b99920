"""The device's idle share of the traced stretch on the inference cells
(asrbench/readers.py)."""

from asrbench.readers import device_idle as read  # noqa: F401
