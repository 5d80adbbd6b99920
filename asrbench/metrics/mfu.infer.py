"""The forwards' share of the bf16 dense peak on the inference cells
(asrbench/readers.py)."""

from asrbench.readers import mfu as read  # noqa: F401
