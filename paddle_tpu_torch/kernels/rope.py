"""Rotary position embedding (RoPE) — plain PyTorch.

Port of paddle_tpu/kernels/rope.py (`rope_freqs`, `apply_rope`,
`apply_rope_half`): pure elementwise work that the JAX package left to
XLA, so here it is plain torch ops, not a kernel.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, max_seq: int, base: float = 10000.0,
               dtype=torch.float32, device=None):
    """Precompute cos/sin tables [max_seq, head_dim//2]."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(q, k, cos, sin, position_ids=None):
    """The 'interleaved' convention: rotates pairs (x[2i], x[2i+1]).
    q, k: [B, S, H, D] or [B, S, D]; cos/sin [S_max, D/2]; position_ids
    [B, S] (None = 0..S-1). (The JAX package's `apply_rope` broadcasts its
    table rows against [B, S, D] only and raises on [B, S, H, D].)"""
    def rot(x):
        d = x.shape[-1]
        if position_ids is None:
            c = cos[: x.shape[1], : d // 2]
            s = sin[: x.shape[1], : d // 2]
        else:
            c = cos[position_ids.long()][..., : d // 2]
            s = sin[position_ids.long()][..., : d // 2]
        if x.ndim == 4:     # broadcast over the head axis
            c, s = c.unsqueeze(-2), s.unsqueeze(-2)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        o1 = x1 * c - x2 * s
        o2 = x2 * c + x1 * s
        return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


def apply_rope_half(q, k, cos, sin, position_ids=None):
    """NeoX/Llama 'rotate_half' convention: split head dim in halves.
    q, k: [B, S, H, D]; position_ids [B, S] (None = 0..S-1)."""
    def rot(x):
        d = x.shape[-1]
        if position_ids is None:
            c = cos[: x.shape[1], : d // 2]
            s = sin[: x.shape[1], : d // 2]
        else:
            c = cos[position_ids.long()][..., : d // 2]
            s = sin[position_ids.long()][..., : d // 2]
        c = torch.cat([c, c], dim=-1)
        s = torch.cat([s, s], dim=-1)
        # broadcast over the head axis: [B, S, 1, D] (or [S, 1, D])
        c, s = c.unsqueeze(-2), s.unsqueeze(-2)
        half = d // 2
        rot_x = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return (x * c + rot_x * s).to(x.dtype)

    return rot(q), rot(k)
