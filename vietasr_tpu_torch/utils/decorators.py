"""Decorators (counterpart of vietasr_tpu/utils/decorators.py)."""

from __future__ import annotations

import functools

from vietasr_tpu_torch.utils.logging import get_logger, log_once


def deprecated(version: str = "", explanation: str = ""):
    """Log, once, that the wrapped callable is deprecated when it is
    used."""

    def wrapper(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            msg = f"{fn.__name__} is deprecated"
            if version:
                msg += f" and will be removed in {version}"
            if explanation:
                msg += f". {explanation}"
            log_once(get_logger(), msg)
            return fn(*args, **kwargs)

        return inner

    return wrapper
