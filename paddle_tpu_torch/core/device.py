"""Device / Place abstraction over torch devices.

Port of paddle_tpu/core/device.py. A Place is a named handle onto a
`torch.device`. The default place is `gpu:0`: tensors are created on the
card unless the caller asks for the CPU with `set_device("cpu")`. Without
a card and without that request, the first tensor creation raises; nothing
lands on the CPU silently.
"""
from __future__ import annotations

from typing import Optional

import torch

_ACCEL_ALIASES = ("gpu", "cuda")


class Place:
    """A device handle. Compares by (platform, index) like phi::Place."""

    __slots__ = ("_device",)

    def __init__(self, device):
        self._device = torch.device(device)

    @property
    def torch_device(self) -> torch.device:
        return self._device

    @property
    def platform(self) -> str:
        return "cpu" if self._device.type == "cpu" else "gpu"

    @property
    def index(self) -> int:
        return self._device.index or 0

    def is_cpu_place(self) -> bool:
        return self.platform == "cpu"

    def is_gpu_place(self) -> bool:
        return self.platform == "gpu"

    def __eq__(self, other):
        return isinstance(other, Place) and \
            (self.platform, self.index) == (other.platform, other.index)

    def __hash__(self):
        return hash((self.platform, self.index))

    def __repr__(self):
        return f"Place({self.platform}:{self.index})"


def CPUPlace(idx: int = 0) -> Place:
    return Place("cpu")


def CUDAPlace(idx: int = 0) -> Place:
    return Place(torch.device("cuda", idx))


GPUPlace = CUDAPlace

_current_place: Optional[Place] = None


def set_device(device) -> Place:
    """paddle.device.set_device — 'cpu', 'gpu', 'gpu:1', 'cuda:0', ...
    Asking for a card on a machine without one raises."""
    global _current_place
    if isinstance(device, Place):
        place = device
    else:
        name, _, idx = str(device).partition(":")
        name = name.lower()
        if name == "cpu":
            place = CPUPlace()
        elif name in _ACCEL_ALIASES:
            place = CUDAPlace(int(idx) if idx else 0)
        else:
            raise ValueError(f"unknown device {device!r}")
    if place.is_gpu_place():
        _check_cuda()
    _current_place = place
    return place


def get_device() -> str:
    p = _default_place()
    return f"{p.platform}:{p.index}" if not p.is_cpu_place() else "cpu"


def _default_place() -> Place:
    return _current_place if _current_place is not None else CUDAPlace(0)


def _check_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch places tensors on gpu:0 and no CUDA device is "
            "available; call paddle_tpu_torch.set_device('cpu') to run on "
            "the CPU")


def _device() -> torch.device:
    """The torch device new tensors go to: the current place's. Raises
    when that is the card and there is none."""
    place = _default_place()
    if place.is_gpu_place():
        _check_cuda()
    return place.torch_device
