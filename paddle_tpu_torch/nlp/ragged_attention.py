"""Ragged paged attention: plain PyTorch version + CUDA kernel.

Port of paddle_tpu/nlp/ragged_attention.py. The serving decode path is
memory bound, and a gather of the full block-table width makes every
request pay `M * block_size` keys of traffic however short its live
sequence is. The kernel (`csrc/ragged_paged_attention.cu`) walks only
each query tile's LIVE block chain through the table, with per-query
causal masking at absolute positions, so one kernel serves single-token
decode rows, chunked-prefill continuations and the mixed decode+prefill
batch of the fused step. Invalid queries return zeros.

Both options of the TPU kernel are here: an int8 pool (`k_scale` /
`v_scale`: one f32 scale a pool block, `quantization.kv`'s dequantize
after the gather) and the speculative suffix slab (`suffix_k`,
`suffix_v`, `suffix_vis`: K/V rows that live only in the caller's slab,
one softmax over the pool keys and the visible slab rows). The
tensor-parallel mesh of the JAX wrapper is a later slice.

`ragged_paged_attention` runs the kernel on a CUDA tensor and the plain
version (`ragged_paged_attention_ref`, the full-table gather) on a CPU
tensor.

The kernel splits each chain across thread blocks by a plan fixed from
the shapes alone (`split_plan`), so a call is capturable in a CUDA
graph; `split_ranges` and `query_splits` are the keys each split reads
and the splits each query's result is merged from, as the kernel computes
them, and `_split_merge_ref` is its split-and-merge algebra in plain
torch, the slab as one more split folded last.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from .. import _build
from ..quantization import kv as kvq

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "resolve_attention_impl", "split_plan", "split_ranges",
           "query_splits"]

# ragged_paged_attention_{bf16,f16,f32}(q, k_pool, v_pool, k_scale,
#     v_scale, table, positions, valid, suffix_k, suffix_v, suffix_vis, out,
#     part_o, part_ml, R, P, H, KV, hd, N, bs, M, S, narrow, split_keys,
#     n_splits, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 12 + [
    ctypes.c_float, ctypes.c_void_p]
# slab rows the kernel folds: one 64-key stage
_MAX_SLAB = 64
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


def _gather_pools(k_pool, v_pool, table, k_scale, v_scale, dt):
    """Each row's whole table width of K and V, [R, M * bs, KV, hd] in
    `dt`; an int8 pool dequantized after the gather under its blocks'
    scales (the JAX package's XLA formulation)."""
    R, M = table.shape
    N, bs, KV, hd = k_pool.shape
    tb = table.long().clamp(0, N - 1)
    if k_scale is not None:
        k = kvq.dequantize(k_pool[tb], k_scale[tb][:, :, None, None, None])
        v = kvq.dequantize(v_pool[tb], v_scale[tb][:, :, None, None, None])
    else:
        k, v = k_pool[tb], v_pool[tb]
    return (k.reshape(R, M * bs, KV, hd).to(dt),
            v.reshape(R, M * bs, KV, hd).to(dt))


def ragged_paged_attention_ref(q, k_pool, v_pool, table, positions,
                               valid=None, *, k_scale=None, v_scale=None,
                               suffix_k=None, suffix_v=None,
                               suffix_vis=None):
    """The kernel's plain version: gather the full table width, mask
    per query (key j visible to query p iff j <= positions[r, p] and p is
    valid; with a slab, slab row s too iff suffix_vis[r, p, s]), one
    softmax in f32 over both; invalid queries return zeros."""
    R, P, H, hd = q.shape
    KV = k_pool.shape[2]
    if valid is None:
        valid = torch.ones((R, P), dtype=torch.bool, device=q.device)
    k, v = _gather_pools(k_pool, v_pool, table, k_scale, v_scale,
                         torch.float32)
    T = k.shape[1]
    rep = H // KV
    qg = q.float().reshape(R, P, KV, rep, hd)
    s = torch.einsum("bpkrd,btkd->bkrpt", qg, k) / math.sqrt(hd)
    vis = (torch.arange(T, device=q.device)[None, None, :]
           <= positions[:, :, None].long()) & valid[:, :, None]
    s = torch.where(vis[:, None, None], s, -1e30)
    if suffix_k is not None:
        ss = torch.einsum("bpkrd,bskd->bkrps", qg,
                          suffix_k.float()) / math.sqrt(hd)
        svis = suffix_vis.bool() & valid[:, :, None]
        ss = torch.where(svis[:, None, None], ss, -1e30)
        s = torch.cat([s, ss], dim=-1)
        v = torch.cat([v, suffix_v.float()], dim=1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrpt,btkd->bpkrd", p, v).reshape(R, P, H, hd)
    return torch.where(valid[:, :, None, None], o, 0.0).to(q.dtype)


def _split_merge_ref(q, k_pool, v_pool, table, positions, valid, plan, *,
                     k_scale=None, v_scale=None, suffix_k=None,
                     suffix_v=None, suffix_vis=None):
    """The kernel's split-and-merge algebra in plain torch, in f32. Each
    split gives every query a partial over the split's keys: O
    unnormalised, the max m of its scores (scaled by log2(e) / sqrt(hd))
    and the sum l of 2^(s - m). With a slab, the slab is one more split
    (index n_splits) over the slab rows the query sees. Without a slab a
    query held in at most one split takes split 0's O / l; any other,
    and with a slab every valid query, folds its pool splits 0 .. n - 1
    and then the slab's partial, in that order: m* = max m_s,
    O = sum 2^(m_s - m*) O_s, l = sum 2^(m_s - m*) l_s, out = O / l.
    Invalid queries return zeros. Computes in f32, or in f64 for f64
    inputs."""
    R, P, H, hd = q.shape
    KV = k_pool.shape[2]
    dt = torch.promote_types(q.dtype, torch.float32)
    if valid is None:
        valid = torch.ones((R, P), dtype=torch.bool, device=q.device)
    k, v = _gather_pools(k_pool, v_pool, table, k_scale, v_scale, dt)
    T = k.shape[1]
    qg = q.to(dt).reshape(R, P, KV, H // KV, hd)
    c = 1.4426950408889634 / math.sqrt(hd)
    s = torch.einsum("bpkrd,btkd->bkrpt", qg, k) * c
    vis = ((torch.arange(T, device=q.device)[None, None, :]
            <= positions[:, :, None].long()) & valid[:, :, None])[:, None,
                                                                   None]

    def partial(s, seen, v):
        m = torch.where(seen, s, -1e30).amax(-1)
        p = torch.where(seen, torch.exp2(s - m[..., None]), 0.0)
        return torch.einsum("bkrpt,btkd->bkrpd", p, v), m, p.sum(-1)

    parts = []
    for lo, _ in split_ranges(plan, T):
        hi = min(lo + plan.split_keys, T)
        parts.append(partial(s[..., lo:hi], vis[..., lo:hi], v[:, lo:hi]))
    n = torch.where(valid, torch.clamp(positions.long() + 1, max=T), 0)
    ns = torch.where(n > 0, -(-n // plan.split_keys), 0)[:, None, None]
    slab = suffix_k is not None
    if slab:
        ss = torch.einsum("bpkrd,bskd->bkrps", qg, suffix_k.to(dt)) * c
        svis = (suffix_vis.bool() & valid[:, :, None])[:, None, None]
        parts.append(partial(ss, svis, suffix_v.to(dt)))
    # which partials each query folds: its pool splits, then the slab's
    take = [i < ns for i in range(plan.n_splits)]
    if slab:
        take.append(valid[:, None, None].expand_as(ns))
    m_all = torch.full_like(parts[0][1], -1e30)
    for t, (_, m, _) in zip(take, parts):
        m_all = torch.where(t, torch.maximum(m_all, m), m_all)
    o_sum = torch.zeros_like(parts[0][0])
    l_sum = torch.zeros_like(parts[0][2])
    for t, (o, m, l) in zip(take, parts):
        f = torch.where(t, torch.exp2(m - m_all), 0.0)
        o_sum = o_sum + f[..., None] * o
        l_sum = l_sum + f * l
    if slab:
        o, l = o_sum, l_sum
    else:
        o0, _, l0 = parts[0]
        o = torch.where((ns <= 1)[..., None], o0, o_sum)
        l = torch.where(ns <= 1, l0, l_sum)
    o = torch.where((l > 0)[..., None], o / l.clamp(min=1e-30)[..., None],
                    0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(R, P, H, hd).to(q.dtype)


def _check(name, t, dtype, device, shape=None):
    if t.dtype != dtype or not t.is_contiguous() or t.device != device \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        want = "" if shape is None else f" of shape {tuple(shape)}"
        raise TypeError(f"{name} must be a contiguous {dtype} tensor"
                        f"{want} on {device}")


def ragged_paged_attention(q, k_pool, v_pool, table, positions, valid=None,
                           *, k_scale=None, v_scale=None, suffix_k=None,
                           suffix_v=None, suffix_vis=None):
    """Paged GQA attention walking only each request's live block chain.

      q [R, P, H, hd]; k_pool/v_pool [N, bs, KV, hd]; table [R, M] pool
      block ids per row; positions [R, P] absolute query positions (query
      p sees chain keys j <= positions[r, p]); valid [R, P] bool query
      mask (None = all valid). Returns [R, P, H, hd] in q's dtype;
      INVALID queries return zeros.

      k_scale/v_scale [N] f32 mark int8 pools (codes x scale).
      suffix_k/suffix_v [R, S, KV, hd] add the speculative slab and
      suffix_vis [R, P, S] (bool) each query's visible slab rows: one
      softmax runs over the visible chain keys and slab rows.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (q bf16, f16 or f32; pools in q's dtype or int8; a slab in q's dtype
    of at most 64 rows; hd 64 or 128, H / KV dividing 64, int32 table and
    positions, bool valid); anything it does not take raises. Each kernel
    launch adds one to `ragged_paged_attention.launches`, to q's dtype's
    `launches_bf16`, `launches_f16` or `launches_f32`, and one to
    `launches_int8` when its pools are int8 and to `launches_suffix` when
    it folds a slab."""
    if not q.is_cuda:
        return ragged_paged_attention_ref(
            q, k_pool, v_pool, table, positions, valid, k_scale=k_scale,
            v_scale=v_scale, suffix_k=suffix_k, suffix_v=suffix_v,
            suffix_vis=suffix_vis)
    R, P, H, hd = q.shape
    N, bs, KV, hdk = k_pool.shape
    M = table.shape[1]
    dev = q.device
    if valid is None:
        valid = torch.ones((R, P), dtype=torch.bool, device=dev)
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
    q8 = k_scale is not None
    if q8 != (v_scale is not None):
        raise ValueError("k_scale and v_scale go together")
    # the TPU kernel computes in the pools' dtype: bf16, f16 or f32 (q,
    # an fp pool and the slab in one dtype)
    tag = _build.DTYPE_TAGS.get(str(q.dtype))
    if tag is None:
        raise TypeError(f"q is {q.dtype}; the kernel takes bf16, f16 and "
                        f"f32")
    pool_dt = torch.int8 if q8 else q.dtype
    for name, t, dt in (("q", q, q.dtype),
                        ("k_pool", k_pool, pool_dt),
                        ("v_pool", v_pool, pool_dt),
                        ("table", table, torch.int32),
                        ("positions", positions, torch.int32),
                        ("valid", valid, torch.bool)):
        _check(name, t, dt, dev)
    if q8:
        _check("k_scale", k_scale, torch.float32, dev, (N,))
        _check("v_scale", v_scale, torch.float32, dev, (N,))
    slab = suffix_k is not None
    S = 0
    if slab:
        if suffix_v is None or suffix_vis is None:
            raise ValueError("suffix_k, suffix_v and suffix_vis go together")
        S = suffix_k.shape[1]
        if not 1 <= S <= _MAX_SLAB:
            raise ValueError(f"slab of {S} rows (1 to {_MAX_SLAB} taken)")
        _check("suffix_k", suffix_k, q.dtype, dev, (R, S, KV, hd))
        _check("suffix_v", suffix_v, q.dtype, dev, (R, S, KV, hd))
        _check("suffix_vis", suffix_vis, torch.bool, dev, (R, P, S))
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)
           + ((suffix_k, suffix_v) if slab else ())):
        raise ValueError("q, the pools and the slab must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    plan = split_plan(R, P, H, KV, M, bs, _sm_count(dev.index))
    n_parts = plan.n_splits + int(slab)
    part_o = part_ml = None
    if n_parts > 1:
        part_o = torch.empty((n_parts, R * P * H, hd), dtype=torch.float32,
                             device=dev)
        part_ml = torch.empty((n_parts, R * P * H, 2), dtype=torch.float32,
                              device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    sym = f"ragged_paged_attention_{tag}"
    fn = _build.function("ragged_paged_attention", sym, _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 ptr(k_scale), ptr(v_scale), table.data_ptr(),
                 positions.data_ptr(), valid.data_ptr(), ptr(suffix_k),
                 ptr(suffix_v), ptr(suffix_vis), out.data_ptr(),
                 ptr(part_o), ptr(part_ml), R, P, H, KV, hd, N, bs, M, S,
                 int(plan.narrow), plan.split_keys, plan.n_splits,
                 1.0 / math.sqrt(hd), stream)
    _build.check(err, sym)
    _build.count_dtype(ragged_paged_attention, q.dtype)
    _build.count(ragged_paged_attention, "launches_int8", int(q8))
    _build.count(ragged_paged_attention, "launches_suffix", int(slab))
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_bf16 = 0
ragged_paged_attention.launches_f16 = 0
ragged_paged_attention.launches_f32 = 0
ragged_paged_attention.launches_int8 = 0
ragged_paged_attention.launches_suffix = 0
