"""The launch plan of the three norm backward kernels (rows 8, 10 and 12
of PERF.md's kernel table: `rms_norm.rms_norm_bwd`, `layer_norm.
layer_norm_bwd`, `adaln.adaln_bwd`), which share one walk
(`csrc/norm_bwd_core.cuh`).

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

The adaLN backward (`adaln_plan`) differs in two ways. Its weight is
per sample (1 + scale[b]) and its column sums (dscale, dshift) are
taken per sample, so its persistent grid's block ranges (x viewed as
[B·N, D], block k taking `adaln_block_rows`) are cut at sample
boundaries into pieces (`adaln_pieces`): the block reloads the weight
for each piece, its teams split the piece's rows (`adaln_team_rows`),
and the piece of sample b writes partial row k + b
(`adaln_partial_row`), distinct for every piece since blocks walk their
rows in order. Sample b's partial rows are then k0 + b .. k1 + b, k0
and k1 the blocks holding its first and last row (`adaln_sample_parts`),
which the fold sums in that order, in fixed segments; no partial row
spans two samples. Its fold is wider (up to 256 columns a block), as a
sample's parts are few.
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


class AdaLNPlan(NamedTuple):
    warps: int         # warps that share one row (a team)
    vpt: int           # vectors of a row a lane holds
    teams: int         # teams a 256-thread block
    blocks: int        # the persistent grid; one partial row a piece
    fold_cols: int     # columns a fold block sums
    fold_segs: int     # segments a fold column's partial rows are cut into


_ADALN_FOLD_WIDTHS = (256, 128, 64, 32, 16, 8)


def adaln_plan(B: int, N: int, D: int, vec: int, n_sm: int,
               resident: int) -> AdaLNPlan:
    """The plan of one adaLN backward call over x [B, N, D], `vec` values
    a vector (8 bf16 in 16 bytes; 4 f32, or 4 bf16 in 8 bytes for D % 8
    == 4), on a card of `n_sm` multiprocessors holding `resident` walk
    blocks each: as many blocks as fit at once, fewer when the rows are
    fewer, and a fold as wide as still gives every multiprocessor a
    block."""
    warps, vpt = team_shape(D, vec)
    teams = THREADS // (32 * warps)
    blocks = max(1, min(n_sm * max(resident, 1), -(-B * N // teams)))
    C = 2 * B * D
    cols = next((c for c in _ADALN_FOLD_WIDTHS if -(-C // c) >= n_sm),
                _ADALN_FOLD_WIDTHS[-1])
    return AdaLNPlan(warps, vpt, teams, blocks, cols, THREADS // cols)


def adaln_block_rows(plan: AdaLNPlan, R: int, k: int) -> Tuple[int, int]:
    """The rows [lo, hi) of x viewed as [R = B·N, D] that block k walks."""
    return k * R // plan.blocks, (k + 1) * R // plan.blocks


def adaln_pieces(plan: AdaLNPlan, B: int, N: int,
                 k: int) -> List[Tuple[int, int, int]]:
    """Block k's rows cut at sample boundaries: (b, lo, hi) in order."""
    lo, hi = adaln_block_rows(plan, B * N, k)
    return [(b, max(lo, b * N), min(hi, (b + 1) * N))
            for b in range(lo // N, -(-hi // N))]


def adaln_team_rows(plan: AdaLNPlan, lo: int, hi: int,
                    team: int) -> Tuple[int, int]:
    """The rows of the piece [lo, hi) that team `team` of its block walks."""
    n = hi - lo
    return lo + team * n // plan.teams, lo + (team + 1) * n // plan.teams


def adaln_partial_row(k: int, b: int) -> int:
    """The partial row the piece of sample b in block k writes."""
    return k + b


def adaln_sample_parts(plan: AdaLNPlan, B: int, N: int, b: int) -> List[int]:
    """Sample b's partial rows in fold order: k + b for the blocks k0..k1
    holding its first and last row (block of row r: the last k with
    k·R // blocks <= r, i.e. ((r + 1)·blocks - 1) // R)."""
    R = B * N

    def block_of(r):
        return ((r + 1) * plan.blocks - 1) // R

    return [k + b for k in range(block_of(b * N), block_of((b + 1) * N - 1)
                                 + 1)]


def adaln_fold_segments(plan: AdaLNPlan, n: int) -> List[Tuple[int, int]]:
    """The segments [lo, hi) of a fold column's n parts, in fold order."""
    s = plan.fold_segs
    return [(k * n // s, (k + 1) * n // s) for k in range(s)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device `index` (asked once)."""
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


def _card(device: torch.device, lib: str, symbol: str, flag: int,
          shape: Tuple[int, int]) -> Tuple[int, int]:
    """(multiprocessors, resident walk blocks each) of the card holding
    `device` for a team shape (warps, vpt), the latter asked of the
    runtime once per (kernel, device) through the library's
    `symbol(flag, warps, vpt, &per_sm)`."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return sm_count(index), _resident(lib, symbol, index, flag, *shape)


def device_plan(device: torch.device, lib: str, symbol: str, flag: int,
                rows: int, D: int, vec: int, n_acc: int) -> BwdPlan:
    """`bwd_plan` for the card holding `device`."""
    return bwd_plan(rows, D, vec, n_acc,
                    *_card(device, lib, symbol, flag, team_shape(D, vec)))


def device_adaln_plan(device: torch.device, B: int, N: int, D: int,
                      vec: int, x_kind: int) -> AdaLNPlan:
    """`adaln_plan` for the card holding `device` (csrc/adaln.cu's
    `adaln_bwd_resident`, x_kind as its `adaln_bwd` takes it)."""
    return adaln_plan(B, N, D, vec,
                      *_card(device, "adaln", "adaln_bwd_resident", x_kind,
                             team_shape(D, vec)))
