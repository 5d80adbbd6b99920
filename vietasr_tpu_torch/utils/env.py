"""Typed environment-variable getters (counterpart of
vietasr_tpu/utils/env.py): get_env with a default or RequiredSettingMissing,
and the bool / int / float / list / dict coercions.

The JAX module's `enable_compilation_cache` turns on JAX's persistent
compilation cache; nothing in this package compiles through JAX, and its
CUDA kernels are built once per checkout by `_build.py`, so it has no
counterpart here.
"""

from __future__ import annotations

import json
import os
from typing import Any, List


class RequiredSettingMissing(Exception):
    def __init__(self, key: str):
        super().__init__(f"required env var {key!r} is missing")


def get_env(key: str, *default: Any, coerce=lambda x: x) -> Any:
    """os.environ[key] coerced; the first `default` when it is unset, or
    RequiredSettingMissing without one."""
    if key not in os.environ:
        if default:
            return default[0]
        raise RequiredSettingMissing(key)
    return coerce(os.environ[key])


def _bool(value: str) -> bool:
    return value.strip().lower() in ("true", "1", "y", "yes", "on")


def get_envbool(key: str, *default) -> bool:
    return get_env(key, *default, coerce=_bool)


def get_envint(key: str, *default) -> int:
    return get_env(key, *default, coerce=int)


def get_envfloat(key: str, *default) -> float:
    return get_env(key, *default, coerce=float)


def get_envlist(key: str, *default, separator: str = " ") -> List[str]:
    return get_env(key, *default, coerce=lambda x: x.split(separator))


def get_envdict(key: str, *default) -> dict:
    return get_env(key, *default, coerce=json.loads)
