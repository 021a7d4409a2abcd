"""Dtype system: Paddle-shaped dtype names over torch dtypes.

Port of paddle_tpu/core/dtype.py. The canonical dtype objects are torch
dtypes (`paddle.float32` is `torch.float32`); the names, the aliases and
the default float dtype are the JAX package's. Promotion is torch's.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "bfloat16": bfloat16,
    "float32": float32, "float64": float64, "complex64": complex64,
    "complex128": complex128, "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2,
    # paddle VarType-style spellings
    "FP16": float16, "FP32": float32, "FP64": float64, "BF16": bfloat16,
    "INT8": int8, "INT16": int16, "INT32": int32, "INT64": int64,
    "BOOL": bool_, "UINT8": uint8,
    "half": float16, "float": float32, "double": float64, "int": int32,
    "long": int64,
}

FLOATING = {float16, bfloat16, float32, float64, float8_e4m3fn, float8_e5m2}
INTEGER = {uint8, int8, int16, int32, int64}
COMPLEX = {complex64, complex128}

# Default dtypes (Paddle: float32 for python floats, int64 for python ints).
_default_float = float32


def set_default_dtype(d) -> None:
    global _default_float
    d = convert_dtype(d)
    if d not in FLOATING:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_float = d


def get_default_dtype():
    return _default_float


def convert_dtype(d) -> torch.dtype:
    """Normalize any dtype spec (str, torch dtype, numpy dtype or type)
    to a torch dtype; None is the default float dtype."""
    if d is None:
        return _default_float
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        name = d
        if name.startswith("paddle."):
            name = name.split(".", 1)[1]
        if name in _ALIASES:
            return _ALIASES[name]
        return _ALIASES[np.dtype(name).name]
    # numpy dtypes and scalar types (ml_dtypes' bfloat16 names itself so)
    return _ALIASES[np.dtype(d).name]

