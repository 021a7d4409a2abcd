"""MoE dispatch and combine: plain PyTorch versions + CUDA kernels.

Port of the single-device half of paddle_tpu/kernels/moe_dispatch.py.
Because GShard slot assignment is injective (each expert slot holds at
most one (token, choice), each (token, choice) fills at most one slot),
both directions of the MoE dispatch and both of their gradients are row
gathers over a pair of inverse index maps, never scatters:

    gather_wsum       out[b, m] = Σ_j w[b, m, j] · src[b, idx[b, m, j]]
                      (the Pallas `_gather_wsum_kernel`; here
                      `csrc/moe_dispatch.cu`)
    gather_scale_dot  out[b, m] = scale[b, m] · src[b, idx[b, m]] and
                      dot[b, m] = src[b, idx[b, m]] · other[b, m]
                      (the Pallas `_gather_scale_dot_kernel`; here
                      `csrc/moe_dispatch.cu`)
    dispatch_gather   token rows → expert slots, as a k = 1 gather_wsum;
                      its backward a k-row gather_wsum over the forward map
    combine_wsum      expert slots → token rows, the probability-weighted
                      k-sum; its backward one gather_scale_dot over the
                      inverse map

`gather_wsum` and `gather_scale_dot` launch their kernel on a CUDA tensor
and run their plain version (`_gather_wsum_ref`, `_gather_scale_dot_ref`)
on a CPU tensor; there is no fallback between the two. The plain versions
compute as the Pallas kernels do: f32 weights and products, the k-sum in
the order j = 0..k-1, one rounding to the source's dtype. Indices are
int32 throughout, pre-clipped by the caller to valid rows; a weight of 0
marks an empty slot or a dropped choice.

The masked row gather (`gather_rows`, `combine_gather`) and the gather
fused with the expert GEMMs (`gather_mlp`) are reached by no path of the
JAX package on one device and are not ported here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

# gather_wsum_bf16(src, idx, w, out, B, N, M, k, D, stream)
_WSUM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
# gather_scale_dot_bf16(src, idx, scale, other, out, dot, B, N, M, D,
#                       stream)
_SDOT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_MAX_K = 8


def _take_rows(src, idx):
    """src [B, N, D], idx [B, R] → src[b, idx[b, r]] as [B, R, D]."""
    B, N, D = src.shape
    off = (torch.arange(B, device=src.device) * N)[:, None]
    flat = (idx.long() + off).reshape(-1)
    return src.reshape(B * N, D).index_select(0, flat).reshape(
        B, idx.shape[1], D)


def _gather_wsum_ref(src, idx, w):
    """Plain version of the gather_wsum kernel: src [B, N, D]; idx
    [B, M, k] int32 pre-clipped; w [B, M, k] f32 → [B, M, D] in src's
    dtype."""
    B, M, k = idx.shape
    rows = _take_rows(src, idx.reshape(B, M * k)).reshape(B, M, k, -1)
    wf = w.float()
    acc = rows[:, :, 0].float() * wf[..., 0:1]
    for j in range(1, k):
        acc = acc + rows[:, :, j].float() * wf[..., j:j + 1]
    return acc.to(src.dtype)


def _gather_scale_dot_ref(src, idx, scale, other):
    """Plain version of the gather_scale_dot kernel: src [B, N, D]; idx
    [B, M] int32 pre-clipped; scale [B, M] f32; other [B, M, D] →
    (out [B, M, D] in src's dtype, dot [B, M] f32)."""
    rows = _take_rows(src, idx).float()
    out = (rows * scale.float()[..., None]).to(src.dtype)
    dot = torch.sum(rows * other.float(), dim=-1)
    return out, dot


def _check_src(src, what):
    if src.dim() != 3 or src.dtype != torch.bfloat16 \
            or not src.is_contiguous() or src.data_ptr() % 16:
        raise TypeError(f"{what}: src must be a contiguous, 16-byte aligned "
                        f"bf16 CUDA tensor [B, N, D]")
    if src.shape[2] % 8:
        raise ValueError(f"{what}: the row width D = {src.shape[2]} must be "
                         f"a multiple of 8 (16-byte rows)")
    if src.shape[1] < 1:
        raise ValueError(f"{what}: src has no rows to gather from")


def _check_like(t, shape, dtype, device, what, name):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise TypeError(f"{what}: {name} must be a contiguous {dtype} "
                        f"tensor {list(shape)} on {device}; got "
                        f"{t.dtype} {list(t.shape)} on {t.device}")


def gather_wsum(src, idx, w):
    """Weighted k-row gather-sum: out[b, m] = Σ_j w[b, m, j] ·
    src[b, idx[b, m, j]], accumulated in f32 in the order j = 0..k-1.

    src [B, N, D]; idx [B, M, k] int32, PRE-CLIPPED to [0, N); w
    [B, M, k] f32, 0 at empty slots and dropped choices → [B, M, D] in
    src's dtype. On a CPU tensor: the plain version. On a CUDA tensor: the
    kernel (bf16 src with D a multiple of 8, int32 idx, f32 w, k <= 8);
    anything else raises. Each launch adds one to `gather_wsum.launches`."""
    if not src.is_cuda:
        return _gather_wsum_ref(src, idx, w)
    _check_src(src, "gather_wsum")
    B, N, D = src.shape
    if idx.dim() != 3 or idx.shape[0] != B:
        raise ValueError(f"gather_wsum: idx must be [B={B}, M, k]; got "
                         f"{list(idx.shape)}")
    M, k = idx.shape[1], idx.shape[2]
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"gather_wsum: k = {k} rows per output; the kernel "
                         f"takes 1 to {_MAX_K}")
    _check_like(idx, (B, M, k), torch.int32, src.device, "gather_wsum", "idx")
    _check_like(w, (B, M, k), torch.float32, src.device, "gather_wsum", "w")
    out = torch.empty(B, M, D, dtype=src.dtype, device=src.device)
    if B * M == 0:
        return out
    fn = _build.function("moe_dispatch", "gather_wsum_bf16", _WSUM_ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), idx.data_ptr(), w.data_ptr(),
                 out.data_ptr(), B, N, M, k, D, stream)
    _build.check(err, "gather_wsum_bf16")
    gather_wsum.launches += 1
    return out


gather_wsum.launches = 0


def gather_scale_dot(src, idx, scale, other):
    """One row gather serving the combine backward: (out, dot) with
    out[b, m] = scale[b, m] · src[b, idx[b, m]] in src's dtype and
    dot[b, m] = src[b, idx[b, m]] · other[b, m] in f32.

    src [B, N, D]; idx [B, M] int32, PRE-CLIPPED to [0, N); scale [B, M]
    f32; other [B, M, D]. On a CPU tensor: the plain version. On a CUDA
    tensor: the kernel (bf16 src and other, D a multiple of 8, int32
    idx, f32 scale); anything else raises. Each launch adds one to
    `gather_scale_dot.launches`."""
    if not src.is_cuda:
        return _gather_scale_dot_ref(src, idx, scale, other)
    _check_src(src, "gather_scale_dot")
    B, N, D = src.shape
    if idx.dim() != 2 or idx.shape[0] != B:
        raise ValueError(f"gather_scale_dot: idx must be [B={B}, M]; got "
                         f"{list(idx.shape)}")
    M = idx.shape[1]
    _check_like(idx, (B, M), torch.int32, src.device, "gather_scale_dot",
                "idx")
    _check_like(scale, (B, M), torch.float32, src.device,
                "gather_scale_dot", "scale")
    _check_like(other, (B, M, D), torch.bfloat16, src.device,
                "gather_scale_dot", "other")
    if other.data_ptr() % 16:
        raise TypeError("gather_scale_dot: other must be 16-byte aligned")
    out =torch.empty(B, M, D, dtype=src.dtype, device=src.device)
    dot = torch.empty(B, M, dtype=torch.float32, device=src.device)
    if B * M == 0:
        return out, dot
    fn = _build.function("moe_dispatch", "gather_scale_dot_bf16",
                         _SDOT_ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), idx.data_ptr(), scale.data_ptr(),
                 other.data_ptr(), out.data_ptr(), dot.data_ptr(), B, N, M,
                 D, stream)
    _build.check(err, "gather_scale_dot_bf16")
    gather_scale_dot.launches += 1
    return out, dot


gather_scale_dot.launches = 0


# ----------------------------------------------------------- dispatch
def _dispatch_bwd(g, flat, k):
    """dx[b, t] = Σ_j g[b, flat[b, t·k + j]] over the routed choices: a
    k-row gather_wsum over the forward map (clipped, weight 0 where the
    choice was dropped)."""
    B, Mk = flat.shape
    idx = flat.clamp(min=0).reshape(B, Mk // k, k)
    w = (flat >= 0).float().reshape(B, Mk // k, k)
    return gather_wsum(g.contiguous(), idx, w)


class _DispatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inv_tok, flat, k):
        ctx.save_for_backward(flat)
        ctx.k = k
        idx1 = inv_tok.clamp(min=0)[..., None]
        w1 = (inv_tok >= 0).float()[..., None]
        return gather_wsum(x.contiguous(), idx1, w1)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        return _dispatch_bwd(g, flat, ctx.k), None, None, None


def dispatch_gather(x, inv_tok, flat, k: int):
    """MoE dispatch: x [B, S, D]; inv_tok [B, E·C] int32 (the token
    filling each slot, -1 = empty) → expert_in [B, E·C, D], zero rows at
    empty slots. flat [B, S·k] int32 (the slot of each (token, choice),
    -1 = dropped) is the inverse map, used only by the gradient
    (`_dispatch_bwd`)."""
    return _DispatchGather.apply(x, inv_tok, flat, k)


# ------------------------------------------------------------ combine
class _CombineWsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eout, idx_tk, w, inv_pos):
        ctx.save_for_backward(eout, w, inv_pos)
        return gather_wsum(eout.contiguous(), idx_tk, w)

    @staticmethod
    def backward(ctx, dy):
        eout, w, inv_pos = ctx.saved_tensors
        B, T, k = w.shape
        live = inv_pos >= 0
        # per-slot scale: the gate prob of the (token, choice) filling it
        w_slot = torch.where(
            live, torch.gather(w.reshape(B, T * k), 1,
                               inv_pos.clamp(min=0).long()), 0.0)
        tok = torch.where(live, torch.div(inv_pos, k, rounding_mode="floor"),
                          0)
        d_eout, dot = gather_scale_dot(dy.contiguous(), tok, w_slot,
                                       eout.contiguous())
        # d_w[t, j] = dy[t] · eout[slot(t, j)]: each slot's dot goes back
        # to its (token, choice); the slot map is injective, so the
        # scatter writes each position at most once, and empty slots
        # write to a sink past the end that is dropped
        pos = torch.where(live, inv_pos, T * k).long()
        d_w = torch.zeros(B, T * k + 1, dtype=torch.float32,
                          device=dy.device).scatter_(1, pos, dot)
        return d_eout, None, d_w[:, :T * k].reshape(B, T, k).to(w.dtype), \
            None


def combine_wsum(eout, idx_tk, w, inv_pos):
    """Fused MoE combine: y[b, t] = Σ_j w[b, t, j] · eout[b, idx_tk[b, t, j]].

    CONTRACT (the backward depends on it): idx_tk [B, T, k] int32 is
    CLIPPED to valid rows and w [B, T, k] f32 is PRE-ZEROED at dropped
    choices, w = where(flat >= 0, probs, 0). The backward returns d_w = 0
    for dropped choices, which is the gradient only under that
    pre-zeroing: with raw gate probs and clipped indices the forward
    would have d_w = dy · eout[0] there. inv_pos [B, M] int32 is the
    inverse map (the flat position t·k + j filling each slot, -1 = empty),
    used only by the backward: d_eout[m] = w_slot[m] · dy[inv_pos[m] // k]
    and its per-slot dot, one gather_scale_dot."""
    return _CombineWsum.apply(eout, idx_tk, w, inv_pos)
