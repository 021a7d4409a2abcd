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
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "resolve_attention_impl"]

# ragged_paged_attention_bf16(q, k_pool, v_pool, table, positions, valid,
#     out, R, P, H, KV, hd, N, bs, M, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


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
    fn = _build.function("ragged_paged_attention",
                         "ragged_paged_attention_bf16", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 table.data_ptr(), positions.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), R, P, H, KV, hd, N, bs, M,
                 1.0 / math.sqrt(hd), stream)
    _build.check(err, "ragged_paged_attention_bf16")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
