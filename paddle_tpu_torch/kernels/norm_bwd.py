"""The launch plan of the two norm backward kernels (rows 8 and 10 of
PERF.md's kernel table: `rms_norm.rms_norm_bwd`, `layer_norm.
layer_norm_bwd`), which share one walk (`csrc/norm_bwd_core.cuh`).

The plan is data, computed on the host from the shapes alone, so a
launch needs no host sync and can be captured in a CUDA graph:

- a team of `warps` warps owns a row, each lane holding `vpt` 16-byte
  vectors of it (at most 32 values); a 256-thread block holds `teams`
  teams;
- `blocks` blocks make the persistent grid, as many as fit on the card
  at once (`n_sm` multiprocessors × `resident` blocks each, from the
  runtime's occupancy query), fewer when the rows are fewer; team g of
  the grid walks the rows `team_rows(plan, rows, g)`, and each block
  writes one f32 partial row of the column sums (dw; dw and db);
- the fold sums those partial rows: a 256-thread block takes `fold_cols`
  columns of the `n_acc * D`, each cut into `fold_segs` segments of the
  partial rows (`fold_segments`), a segment summed in row order, then
  the segments in order. Its width is the widest that still gives every
  multiprocessor a block.

So the summation order of dw and db depends on (rows, D, n_sm,
resident) alone: within a team row by row, then the block's teams in
order, then each segment's partial rows in order, then the segments.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from .. import _build

THREADS = 256                  # a walk or fold block
_FOLD_WIDTHS = (32, 16, 8)     # fold columns a block, widest first


class BwdPlan(NamedTuple):
    warps: int         # warps that share one row (a team)
    vpt: int           # 16-byte vectors of a row a lane holds
    teams: int         # teams a 256-thread block
    blocks: int        # the persistent grid; one partial row a block
    fold_cols: int     # columns a fold block sums
    fold_segs: int     # segments a fold column's partial rows are cut into


def team_shape(D: int, vec: int) -> Tuple[int, int]:
    """(warps, vpt) of a row of D values, `vec` of them to a 16-byte
    vector (8 bf16, 4 f32): one warp holding 1, 2 or 4 vectors a lane (f32
    also 6 or 8), else 2, 4 or 8 warps holding 32 values a lane, the
    fewest warps that hold the row. These are the kernels' instantiations."""
    nvec, vmax = D // vec, 32 // vec
    for v in ((1, 2, 4) if vec == 8 else (1, 2, 4, 6, 8)):
        if nvec <= 32 * v:
            return 1, v
    for w in (2, 4, 8):
        if nvec <= 32 * w * vmax:
            return w, vmax
    raise ValueError(f"a row of {D} values does not fit a team")


def bwd_plan(rows: int, D: int, vec: int, n_acc: int, n_sm: int,
             resident: int) -> BwdPlan:
    """The plan of one backward call over `rows` rows of D values, with
    `n_acc` column sums (1: dw; 2: dw and db) on a card of `n_sm`
    multiprocessors that hold `resident` walk blocks each."""
    warps, vpt = team_shape(D, vec)
    teams = THREADS // (32 * warps)
    blocks = max(1, min(n_sm * max(resident, 1), -(-rows // teams)))
    cols = next((c for c in _FOLD_WIDTHS if -(-n_acc * D // c) >= n_sm),
                _FOLD_WIDTHS[-1])
    return BwdPlan(warps, vpt, teams, blocks, cols, THREADS // cols)


def team_rows(plan: BwdPlan, rows: int, g: int) -> Tuple[int, int]:
    """The rows [lo, hi) team g of the grid walks (block g // teams)."""
    n = plan.blocks * plan.teams
    return g * rows // n, (g + 1) * rows // n


def fold_segments(plan: BwdPlan) -> List[Tuple[int, int]]:
    """The partial rows [lo, hi) of each fold segment, in fold order."""
    b, s = plan.blocks, plan.fold_segs
    return [(k * b // s, (k + 1) * b // s) for k in range(s)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident(lib: str, symbol: str, index: int, flag: int, warps: int,
              vpt: int) -> int:
    fn = _build.function(lib, symbol, [ctypes.c_int] * 3
                         + [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(flag, warps, vpt, ctypes.byref(n))
    _build.check(err, symbol)
    return n.value


def device_plan(device: torch.device, lib: str, symbol: str, flag: int,
                rows: int, D: int, vec: int, n_acc: int) -> BwdPlan:
    """`bwd_plan` for the card holding `device`, its resident blocks
    asked of the runtime once per (kernel, device) through the library's
    `symbol(flag, warps, vpt, &per_sm)`."""
    warps, vpt = team_shape(D, vec)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return bwd_plan(rows, D, vec, n_acc, _sm_count(index),
                    _resident(lib, symbol, index, flag, warps, vpt))
