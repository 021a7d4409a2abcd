"""Ragged paged attention: plain PyTorch version + CUDA kernel.

Port of paddle_tpu/nlp/ragged_attention.py. The serving decode path is
memory bound, and a gather of the full block-table width makes every
request pay `M * block_size` keys of traffic however short its live
sequence is. The kernel (`csrc/ragged_paged_attention.cu`) walks only
each query tile's LIVE block chain through the table, with per-query
causal masking at absolute positions, so one kernel serves single-token
decode rows, chunked-prefill continuations and the mixed decode+prefill
batch of the fused step. Invalid queries return zeros.

`ragged_paged_attention` runs the kernel on a CUDA tensor and the plain
version (`ragged_paged_attention_ref`, the full-table gather) on a CPU
tensor. The int8-pool and suffix-slab options and the tensor-parallel
mesh of the JAX wrapper are later slices.

The kernel splits each chain across thread blocks by a plan fixed from
the shapes alone (`split_plan`), so a call is capturable in a CUDA
graph; `split_ranges` and `query_splits` are the keys each split reads
and the splits each query's result is merged from, as the kernel computes
them, and `_split_merge_ref` is its split-and-merge algebra in plain
torch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from .. import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "resolve_attention_impl", "split_plan", "split_ranges",
           "query_splits"]

# ragged_paged_attention_bf16(q, k_pool, v_pool, table, positions, valid,
#     out, part_o, part_ml, R, P, H, KV, hd, N, bs, M, narrow, split_keys,
#     n_splits, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
    ctypes.c_float, ctypes.c_void_p]
# keys of K and V per stage of the kernel's copy ring; a split is a whole
# number of stages, at most _MAX_SPLIT_STAGES (its table entries sit in
# shared memory)
_STAGE_KEYS = 64
_MAX_SPLIT_STAGES = 64


class SplitPlan(NamedTuple):
    narrow: bool       # 16-row query tiles (decode) rather than 64-row
    tile_pos: int      # query positions a tile
    n_ptiles: int      # query tiles a row
    split_keys: int    # chain keys a split, a multiple of _STAGE_KEYS
    n_splits: int      # splits of the longest chain, M * bs keys


def split_plan(R: int, P: int, H: int, KV: int, M: int, bs: int,
               n_sm: int) -> SplitPlan:
    """The kernel's grid, from the shapes alone (no data, so the call
    stays capturable in a CUDA graph): (row, KV head, query tile x key
    split) blocks. A tile is one GQA group of 16 // rep positions where
    P * rep <= 16 (decode), else 64 // rep positions. The longest chain
    (M * bs keys) is cut into splits of whole 64-key stages, as many as
    bring the grid nearest to one wave of two blocks a streaming
    multiprocessor (two fit beside each other: their copy rings take
    ~100 KB of shared memory each at hd 128)."""
    rep = H // KV
    narrow = rep * P <= 16
    tile_pos = (16 if narrow else 64) // rep
    n_ptiles = -(-P // tile_pos)
    stages = max(1, -(-M * bs // _STAGE_KEYS))
    want = max(1, round(2 * n_sm / (R * KV * n_ptiles)))
    per = min(max(1, -(-stages // want)), _MAX_SPLIT_STAGES)
    return SplitPlan(narrow, tile_pos, n_ptiles, per * _STAGE_KEYS,
                     -(-stages // per))


def split_ranges(plan: SplitPlan, live: int) -> List[Tuple[int, int]]:
    """The chain keys [lo, hi) each split reads for a query tile whose
    live chain is `live` keys (one past its largest valid position,
    capped at M * bs); an empty range reads nothing. Split 0 always
    runs: it writes the tile's final outputs."""
    return [(lo, max(lo, min(lo + plan.split_keys, live)))
            for lo in range(0, plan.n_splits * plan.split_keys,
                            plan.split_keys)]


def query_splits(plan: SplitPlan, position: int, valid: bool,
                 max_keys: int) -> int:
    """How many splits hold the keys a query sees (0 for an invalid
    query). At most one: split 0 writes its final output; more: the
    merge folds splits 0 .. n - 1 in that order."""
    n = min(position + 1, max_keys) if valid else 0
    return -(-n // plan.split_keys) if n > 0 else 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def resolve_attention_impl(impl: str, device) -> str:
    """Resolve an `attention_impl` choice for tensors on `device`: "auto"
    is "kernel" on CUDA and "ref" (the plain version) on the CPU.
    "kernel" on the CPU raises — the kernel runs only on the card."""
    dev = torch.device(device)
    if impl == "auto":
        return "kernel" if dev.type == "cuda" else "ref"
    if impl not in ("kernel", "ref"):
        raise ValueError(
            f"attention_impl must be 'auto', 'kernel' or 'ref', got {impl!r}")
    if impl == "kernel" and dev.type != "cuda":
        raise ValueError("attention_impl='kernel' needs a CUDA device")
    return impl


def ragged_paged_attention_ref(q, k_pool, v_pool, table, positions,
                               valid=None):
    """The kernel's plain version: gather the full table width, mask
    per query (key j visible to query p iff j <= positions[r, p] and p is
    valid), softmax in f32; invalid queries return zeros."""
    R, P, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    M = table.shape[1]
    if valid is None:
        valid = torch.ones((R, P), dtype=torch.bool, device=q.device)
    tb = table.long().clamp(0, N - 1)
    k = k_pool[tb].reshape(R, M * bs, KV, hd).float()
    v = v_pool[tb].reshape(R, M * bs, KV, hd).float()
    rep = H // KV
    qg = q.float().reshape(R, P, KV, rep, hd)
    s = torch.einsum("bpkrd,btkd->bkrpt", qg, k) / math.sqrt(hd)
    vis = (torch.arange(M * bs, device=q.device)[None, None, :]
           <= positions[:, :, None].long()) & valid[:, :, None]
    s = torch.where(vis[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrpt,btkd->bpkrd", p, v).reshape(R, P, H, hd)
    return torch.where(valid[:, :, None, None], o, 0.0).to(q.dtype)


def _split_merge_ref(q, k_pool, v_pool, table, positions, valid, plan):
    """The kernel's split-and-merge algebra in plain torch, in f32. Each
    split gives every query a partial over the split's keys: O
    unnormalised, the max m of its scores (scaled by log2(e) / sqrt(hd))
    and the sum l of 2^(s - m). A query held in at most one split takes
    split 0's O / l; any other folds its splits 0 .. n - 1 in that order:
    m* = max m_s, O = sum 2^(m_s - m*) O_s, l = sum 2^(m_s - m*) l_s,
    out = O / l. Invalid queries return zeros. Computes in f32, or in
    f64 for f64 inputs."""
    R, P, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    T = table.shape[1] * bs
    dt = torch.promote_types(q.dtype, torch.float32)
    if valid is None:
        valid = torch.ones((R, P), dtype=torch.bool, device=q.device)
    tb = table.long().clamp(0, N - 1)
    k = k_pool[tb].reshape(R, T, KV, hd).to(dt)
    v = v_pool[tb].reshape(R, T, KV, hd).to(dt)
    qg = q.to(dt).reshape(R, P, KV, H // KV, hd)
    s = torch.einsum("bpkrd,btkd->bkrpt", qg, k) * (
        1.4426950408889634 / math.sqrt(hd))
    vis = ((torch.arange(T, device=q.device)[None, None, :]
            <= positions[:, :, None].long()) & valid[:, :, None])[:, None,
                                                                   None]
    parts = []
    for lo, _ in split_ranges(plan, T):
        hi = min(lo + plan.split_keys, T)
        seen = vis[..., lo:hi]
        m = torch.where(seen, s[..., lo:hi], -1e30).amax(-1)
        p = torch.where(seen, torch.exp2(s[..., lo:hi] - m[..., None]), 0.0)
        parts.append((torch.einsum("bkrpt,btkd->bkrpd", p, v[:, lo:hi]), m,
                      p.sum(-1)))
    n = torch.where(valid, torch.clamp(positions.long() + 1, max=T), 0)
    ns = torch.where(n > 0, -(-n // plan.split_keys), 0)[:, None, None]
    m_all = torch.full_like(parts[0][1], -1e30)
    for i, (_, m, _) in enumerate(parts):
        m_all = torch.where(i < ns, torch.maximum(m_all, m), m_all)
    o_sum = torch.zeros_like(parts[0][0])
    l_sum = torch.zeros_like(parts[0][2])
    for i, (o, m, l) in enumerate(parts):
        f = torch.where(i < ns, torch.exp2(m - m_all), 0.0)
        o_sum = o_sum + f[..., None] * o
        l_sum = l_sum + f * l
    o0, _, l0 = parts[0]
    o = torch.where((ns <= 1)[..., None], o0, o_sum)
    l = torch.where(ns <= 1, l0, l_sum)
    o = torch.where((l > 0)[..., None], o / l.clamp(min=1e-30)[..., None],
                    0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(R, P, H, hd).to(q.dtype)


def ragged_paged_attention(q, k_pool, v_pool, table, positions, valid=None):
    """Paged GQA attention walking only each request's live block chain.

      q [R, P, H, hd]; k_pool/v_pool [N, bs, KV, hd]; table [R, M] pool
      block ids per row; positions [R, P] absolute query positions (query
      p sees chain keys j <= positions[r, p]); valid [R, P] bool query
      mask (None = all valid). Returns [R, P, H, hd] in q's dtype;
      INVALID queries return zeros.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (bf16 q and pools, hd 64 or 128, H / KV dividing 64, int32 table and
    positions, bool valid); anything it does not take raises. Each
    kernel launch adds one to `ragged_paged_attention.launches`."""
    if not q.is_cuda:
        return ragged_paged_attention_ref(q, k_pool, v_pool, table,
                                          positions, valid)
    R, P, H, hd = q.shape
    N, bs, KV, hdk = k_pool.shape
    M = table.shape[1]
    if valid is None:
        valid = torch.ones((R, P), dtype=torch.bool, device=q.device)
    if v_pool.shape != k_pool.shape or hdk != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % KV or 64 % (H // KV):
        raise ValueError(f"H / KV = {H}/{KV} must be an integer dividing 64")
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not supported (64 or 128)")
    if tuple(table.shape) != (R, M) or tuple(positions.shape) != (R, P) \
            or tuple(valid.shape) != (R, P):
        raise ValueError("table [R, M], positions and valid [R, P] expected")
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pool", k_pool, torch.bfloat16),
                        ("v_pool", v_pool, torch.bfloat16),
                        ("table", table, torch.int32),
                        ("positions", positions, torch.int32),
                        ("valid", valid, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device:
            raise TypeError(f"{name} must be a contiguous {dt} tensor on "
                            f"{q.device}")
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("q and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    plan = split_plan(R, P, H, KV, M, bs, _sm_count(q.device.index))
    part_o = part_ml = None
    if plan.n_splits > 1:
        part_o = torch.empty((plan.n_splits, R * P * H, hd),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((plan.n_splits, R * P * H, 2),
                              dtype=torch.float32, device=q.device)
    fn = _build.function("ragged_paged_attention",
                         "ragged_paged_attention_bf16", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 table.data_ptr(), positions.data_ptr(), valid.data_ptr(),
                 out.data_ptr(),
                 None if part_o is None else part_o.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 R, P, H, KV, hd, N, bs, M, int(plan.narrow),
                 plan.split_keys, plan.n_splits, 1.0 / math.sqrt(hd), stream)
    _build.check(err, "ragged_paged_attention_bf16")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
