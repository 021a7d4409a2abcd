"""Flash attention: plain PyTorch versions + CUDA kernels.

Port of paddle_tpu/kernels/flash_attention.py: `mha_ref` (the exact
reference), the Pallas forward `_flash_fwd_kernel` (Hopper counterpart
`csrc/flash_fwd.cu`), the Pallas backward kernels (the resident,
streamed and split schedules of `flash_attention_pallas_bwd`, one
Hopper design in `csrc/flash_bwd.cu`) and the differentiable entry, the
`custom_vjp` `flash_attention_fwd` there, here the autograd Function
behind `flash_attention`. Layout is [batch, seq, heads, head_dim]
('bshd'); k/v may have fewer heads than q (GQA). The key mask and the
'bhsd' layout are later slices.

The LSE is taken in the scaled-score domain, as the TPU kernel keeps
it: lse[b, h, i] = log Σ_j exp(scale · q_i·k_j) over the visible keys.

`flash_attention_fwd` and `flash_attention_bwd` run the kernel on a CUDA
tensor and the plain version on a CPU tensor; there is no fallback
between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30
# flash_fwd_bf16(q, k, v, out, lse, B, Sq, Sk, H, KV, hd, scale, causal,
#                stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# flash_bwd_bf16(q, k, v, out, dout, lse, dcap, dq, dk, dv, B, Sq, Sk, H,
#                KV, hd, scale, causal, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _expand_kv(q, k, v):
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def _causal_mask(sq, sk, device):
    """[sq, sk] visibility of the bottom-right causal alignment: query i
    sees keys j <= i + sk - sq."""
    return torch.ones((sq, sk), dtype=torch.bool,
                      device=device).tril(diagonal=sk - sq)


def mha_ref(q, k, v, *, causal=False, scale=None, mask=None):
    """Exact attention reference. q,k,v: [B, S, H, D] → [B, S, H, D].
    Supports GQA: k/v may have fewer heads (H % Hkv == 0). Causal is
    the bottom-right alignment (query i sees keys j <= i + Sk - Sq)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _expand_kv(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if causal:
        cm = _causal_mask(q.shape[1], k.shape[1], q.device)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_fwd_ref(q, k, v, causal=True, scale=None,
                            return_lse=False):
    """The forward kernel's plain version: causal GQA attention with
    Sq <= Sk, scores and accumulation in f32, output in q's dtype; with
    `return_lse`, also the f32 LSE [B, H, Sq] of the scaled scores."""
    if not return_lse:
        return mha_ref(q, k, v, causal=causal, scale=scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ke, ve = _expand_kv(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke.float()) * scale
    if causal:
        cm = _causal_mask(q.shape[1], k.shape[1], q.device)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, ve.float())
    return out.to(q.dtype), lse


def flash_attention_fwd(q, k, v, causal=True, scale=None, return_lse=False):
    """Flash attention forward, q [B, Sq, H, hd], k/v [B, Sk, KV, hd];
    with `return_lse`, returns (out, lse [B, H, Sq] f32).

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (bf16, hd 64 or 128, Sq <= Sk when causal); anything it does not
    take raises. Each kernel launch adds one to
    `flash_attention_fwd.launches`."""
    if not q.is_cuda:
        return flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale,
                                       return_lse=return_lse)
    B, Sq, H, hd = q.shape
    _check(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    fn = _build.function("flash_fwd", "flash_fwd_bf16", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None, B, Sq, k.shape[1],
                 H, k.shape[2], hd, float(scale), int(causal), stream)
    _build.check(err, "flash_fwd_bf16")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def _check(q, k, v, causal, extra=()):
    B, Sq, H, hd = q.shape
    Bk, Sk, KV, hdk = k.shape
    if v.shape != k.shape or Bk != B or hdk != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"query heads {H} not a multiple of KV heads {KV}")
    if causal and Sq > Sk:
        raise ValueError(f"causal flash needs Sq <= Sk, got {Sq} > {Sk}")
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not supported (64 or 128)")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device or t.data_ptr() % 16:
            raise TypeError(f"{name} must be a contiguous, 16-byte aligned "
                            f"bf16 tensor on {q.device}")


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True,
                            scale=None):
    """The backward kernel's plain version: (dq, dk, dv) in the inputs'
    dtypes, from the forward's output and LSE (not through autograd).
    f32 einsums; P = exp(scale·QKᵀ − lse), dcap = rowsum(dO·O),
    dS = P∘(dP − dcap)·scale; dk/dv summed over each KV head's group of
    query heads."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    ke, ve = _expand_kv(q, k, v)
    qf, kf, vf = q.float(), ke.float(), ve.float()
    dof = dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        cm = _causal_mask(Sq, Sk, q.device)
        p = torch.where(cm[None, None], p, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dcap = (dof * out.float()).sum(-1).transpose(1, 2)       # [B, H, Sq]
    ds = p * (dp - dcap[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if KV != H:
        dk = dk.reshape(B, Sk, KV, H // KV, hd).sum(3)
        dv = dv.reshape(B, Sk, KV, H // KV, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, scale=None):
    """Flash attention backward: (dq, dk, dv) from the forward's `out`
    and `lse` [B, H, Sq] and the output cotangent `dout`.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (bf16 q/k/v/out/dout, f32 lse; the shapes the forward kernel takes);
    anything else raises. GQA is accumulated over each KV head's query
    group inside the kernel. Each launch adds one to
    `flash_attention_bwd.launches`."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, scale=scale)
    dout = dout.contiguous()
    B, Sq, H, hd = q.shape
    _check(q, k, v, causal, (("out", out), ("dout", dout)))
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("out and dout must have q's shape")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 [{B}, {H}, {Sq}]")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dcap = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    fn = _build.function("flash_bwd", "flash_bwd_bf16", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq,
                 k.shape[1], H, k.shape[2], hd, float(scale), int(causal),
                 stream)
    _build.check(err, "flash_bwd_bf16")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The port of the `custom_vjp` around the JAX package's flash
    attention: the forward keeps (q, k, v, out, lse), the backward runs
    the flash backward from them (O(S) memory, no score matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None):
    """Differentiable flash attention, q [B, Sq, H, hd], k/v
    [B, Sk, KV, hd] → [B, Sq, H, hd]: the kernels on the card, their
    plain versions on the CPU."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(q, k, v, causal, scale)
