"""paddle_tpu_torch.quantization.kv — single-source int8 paged-KV math.

Port of paddle_tpu/quantization/kv.py on torch tensors, same names. The
serving stack can store the paged KV pool as int8 codes with ONE
per-(layer, block) abs-max scale kept in a sibling scale pool
(`nlp/paged.py` wires the commit writes; `nlp/ragged_attention.py`'s
kernel and its plain version dequantize the gathered blocks). Every
quantize / rescale / dequantize on that path routes through these
helpers, so the plain version, the kernel's wrapper and the commit write
agree on the math by construction.

Scale discipline (grow-only, rescale-on-growth): a block's scale is
abs-max over every value EVER written to it divided by the int8 bound.
When a later write raises the block's abs-max, the block's existing
codes rescale ONCE under the new scale (`rescale_codes` — an exact
identity when the scale did not change, one extra rounding when it
did), so a block's codes always dequantize under the single scale its
pool slot stores. Empty blocks carry scale 0 and all-zero codes, which
dequantize to exact zeros — the same contents a fresh fp pool holds.

No host syncs: these run inside every decode and prefill step when
``kv_dtype="int8"``.
"""
from __future__ import annotations

import torch

__all__ = [
    "KV_DTYPES", "BOUND", "resolve_kv_dtype", "scale_of", "quantize",
    "dequantize", "rescale_codes", "kv_block_bytes",
]

#: Supported paged-KV storage modes: "fp" stores the compute dtype;
#: "int8" stores int8 codes plus per-(layer, block) f32 abs-max scales.
KV_DTYPES = ("fp", "int8")

#: Symmetric int8 code range: codes live in [-127, 127] so that
#: quantize(-absmax) == -quantize(absmax) (no -128 asymmetry).
BOUND = 127.0


def resolve_kv_dtype(kv_dtype) -> str:
    """Normalize a ``kv_dtype`` choice: None and "fp" mean the fp pool;
    "int8" selects the quantized pool. Anything else raises
    ValueError."""
    if kv_dtype is None:
        return "fp"
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES} (or None), "
            f"got {kv_dtype!r}")
    return kv_dtype


def scale_of(amax):
    """Abs-max → symmetric int8 scale (amax / 127). A zero abs-max
    yields scale 0: the all-zero-block sentinel `dequantize` maps back
    to exact zeros."""
    return amax / BOUND


def quantize(x, scale):
    """Quantize `x` to int8 codes under `scale` (broadcastable), in f32.
    Scale 0 marks a block nothing was ever written to — its codes stay
    0 via the safe divisor (x is 0 wherever scale is legitimately 0)."""
    s = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(x.float() / s), -BOUND,
                       BOUND).to(torch.int8)


def dequantize(codes, scale):
    """int8 codes → f32 values under `scale` (broadcastable). Scale 0
    (a never-written block) dequantizes to exact zeros."""
    return codes.float() * scale


def rescale_codes(codes, old_scale, new_scale):
    """Re-express existing codes under a grown scale. Exact identity
    when the scale did not change (round(q * 1.0) == q for |q| <= 127
    in f32); one extra rounding when it did."""
    pos = new_scale > 0.0
    safe = torch.where(pos, new_scale, torch.ones_like(new_scale))
    ratio = torch.where(pos, old_scale / safe, torch.ones_like(new_scale))
    return torch.clamp(torch.round(codes.float() * ratio), -BOUND,
                       BOUND).to(torch.int8)


def kv_block_bytes(num_layers: int, block_size: int, kv_heads: int,
                   head_dim: int, kv_dtype: str,
                   fp_itemsize: int = 2) -> int:
    """Device bytes ONE pool block occupies across all layers, K and V
    pools together, INCLUDING the sibling scale pool's per-block
    overhead in int8 mode (2 pools x num_layers x 4-byte f32 scales)."""
    elems = num_layers * block_size * kv_heads * head_dim * 2
    if resolve_kv_dtype(kv_dtype) == "int8":
        return elems + num_layers * 2 * 4
    return elems * int(fp_itemsize)
