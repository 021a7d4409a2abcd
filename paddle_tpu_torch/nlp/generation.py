"""Serving-side model pieces shared by the paged path.

Port of paddle_tpu/nlp/generation.py's `_wq`, `_mlp_cached`,
`_final_head_cached` and `_sample`. Weight-only int8 (`:scale` leaves)
and the dense-cache `generate` are later slices.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import llama

_TOPP_CANDIDATES = 4096


def _wq(tree, name, cd):
    """Read a weight in the compute dtype (a no-op for the serving tree,
    which already holds it so)."""
    if name + ":scale" in tree:
        raise NotImplementedError(
            "weight-only int8 trees are not ported yet (quantized serving "
            "is a later slice)")
    return tree[name].to(cd)


def _mlp_cached(x, lp, cfg):
    """SwiGLU MLP."""
    g = x @ _wq(lp, "gate_proj", cfg.dtype)
    u = x @ _wq(lp, "up_proj", cfg.dtype)
    return (F.silu(g) * u) @ _wq(lp, "down_proj", cfg.dtype)


def _final_head_cached(params, x, cfg):
    """Final RMSNorm + LM head → f32 logits."""
    if "lm_head:scale" in params:
        raise NotImplementedError(
            "a weight-only int8 LM head is not ported yet (quantized "
            "serving is a later slice)")
    return llama._final_head(params, x, cfg)


def _sample(logits, generator: Optional[torch.Generator],
            temperature: float, top_k: int, top_p: float, greedy: bool):
    """logits [B, V] → token ids [B] (int32). Greedy is argmax, exactly
    the JAX function's; top-k then top-p filter sequentially (top-p
    renormalizes over the top-k survivors) and draw from `generator`,
    whose random bits differ from jax.random's, so sampling agrees with
    the JAX function in distribution only."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / max(temperature, 1e-6)
    V = logits.shape[-1]
    sorted_l = None
    if top_k:
        k = min(int(top_k), V)
        sorted_l = torch.topk(logits, k, dim=-1).values     # descending
        logits = torch.where(logits < sorted_l[:, -1:], -1e30, logits)
    if top_p < 1.0:
        if sorted_l is None:
            cand = torch.topk(logits, min(_TOPP_CANDIDATES, V), dim=-1).values
            # exact head of the full-vocab cumulative distribution: the
            # denominator is logsumexp over ALL logits, not the candidates
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            probs = torch.exp(cand - lse)
        else:
            cand = sorted_l
            probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set whose cumulative prob >= top_p; the clamp keeps at
        # least the top token even at top_p == 0
        cutoff_idx = torch.clamp(
            torch.sum((cum - probs) < top_p, dim=-1) - 1, min=0)
        cutoff = torch.gather(cand, -1, cutoff_idx[:, None])
        if sorted_l is None and cand.shape[-1] < V:
            cutoff = torch.where(cum[:, -1:] >= top_p, cutoff,
                                 torch.full_like(cutoff, -float("inf")))
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
