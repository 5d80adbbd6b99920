from vietasr_tpu_torch.utils.decorators import deprecated
from vietasr_tpu_torch.utils.device import resolve_device
from vietasr_tpu_torch.utils.env import (get_env, get_envbool, get_envfloat,
                                         get_envint, get_envlist)
from vietasr_tpu_torch.utils.exp_manager import ExpManager
from vietasr_tpu_torch.utils.logging import LogMode, get_logger

__all__ = [
    "get_logger",
    "LogMode",
    "ExpManager",
    "get_envbool",
    "get_envint",
    "get_envfloat",
    "get_envlist",
    "get_env",
    "deprecated",
    "resolve_device",
]
