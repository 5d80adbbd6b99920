"""The train steps' share of the bf16 dense peak on the train cells
(asrbench/readers.py)."""

from asrbench.readers import mfu as read  # noqa: F401
