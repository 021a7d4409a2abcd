"""Global flag registry — paddle.set_flags/get_flags shim.

Port of paddle_tpu/core/flags.py, holding only the flags the eager path
reads: FLAGS_check_nan_inf (the eager dispatch raises on a non-finite
float output when it is set). A flag's default can be set from the
environment variable of its name.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_: str = "") -> None:
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    env = os.environ.get(name)
    if env is not None:
        if isinstance(default, bool):
            default = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            default = int(env)
        elif isinstance(default, float):
            default = float(env)
        else:
            default = env
    _REGISTRY[name] = default


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        if not k.startswith("FLAGS_"):
            k = "FLAGS_" + k
        _REGISTRY[k] = v


def get_flags(keys) -> Dict[str, Any]:
    if isinstance(keys, str):
        keys = [keys]
    out = {}
    for k in keys:
        kk = k if k.startswith("FLAGS_") else "FLAGS_" + k
        out[k] = _REGISTRY.get(kk)
    return out


def flag(name: str) -> Any:
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    return _REGISTRY.get(name)


define_flag("FLAGS_check_nan_inf", False,
            "raise on nan/inf in op outputs (debug)")
