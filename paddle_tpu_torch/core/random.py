"""Seeded random generators, one per device.

Port of paddle_tpu/core/random.py. The JAX package splits one global key
for every random op; here each device has its own `torch.Generator`,
made on first use from the global seed, and the initializers and dropout
draw from the generator of the device they fill. `seed(s)` reseeds every
generator. The two packages give different numbers from the same seed
(parity tests copy weights instead).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .device import _device

_seed = 0
_generators: Dict[Tuple[str, int], torch.Generator] = {}


def default_generator(device=None) -> torch.Generator:
    """The generator of `device` (default: the current place's)."""
    dev = torch.device(device) if device is not None else _device()
    key = (dev.type, dev.index or 0)
    g = _generators.get(key)
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(_seed)
        _generators[key] = g
    return g


def seed(s: int) -> None:
    """paddle.seed — reseed the generator of every device."""
    global _seed
    _seed = int(s)
    for g in _generators.values():
        g.manual_seed(_seed)
