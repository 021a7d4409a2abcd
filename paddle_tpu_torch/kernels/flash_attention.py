"""Flash attention forward: plain PyTorch version + CUDA kernel.

Port of the forward half of paddle_tpu/kernels/flash_attention.py:
`mha_ref` (the exact reference) and the Pallas `_flash_fwd_kernel`,
whose Hopper counterpart is `csrc/flash_fwd.cu`. Layout is
[batch, seq, heads, head_dim] ('bshd'). The key mask, the LSE output
and the backward kernels are later slices.

`flash_attention_fwd` runs the kernel on a CUDA tensor and the plain
version on a CPU tensor; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30
# flash_fwd_bf16(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def mha_ref(q, k, v, *, causal=False, scale=None, mask=None):
    """Exact attention reference. q,k,v: [B, S, H, D] → [B, S, H, D].
    Supports GQA: k/v may have fewer heads (H % Hkv == 0). Causal is
    the bottom-right alignment (query i sees keys j <= i + Sk - Sq)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_fwd_ref(q, k, v, causal=True, scale=None):
    """The kernel's plain version: causal GQA attention with Sq <= Sk,
    scores and accumulation in f32, output in q's dtype."""
    return mha_ref(q, k, v, causal=causal, scale=scale)


def flash_attention_fwd(q, k, v, causal=True, scale=None):
    """Flash attention forward, q [B, Sq, H, hd], k/v [B, Sk, KV, hd].

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (bf16, hd 64 or 128, Sq <= Sk when causal); anything it does not
    take raises. Each kernel launch adds one to
    `flash_attention_fwd.launches`."""
    if not q.is_cuda:
        return flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale)
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device or t.data_ptr() % 16:
            raise TypeError(f"{name} must be a contiguous, 16-byte aligned "
                            f"bf16 tensor on {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.function("flash_fwd", "flash_fwd_bf16", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, KV, hd, float(scale), int(causal), stream)
    _build.check(err, "flash_fwd_bf16")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
