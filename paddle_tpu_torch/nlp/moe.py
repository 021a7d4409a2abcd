"""Mixture-of-Experts: GShard top-k routing with capacity, the MoE block
and the MoE transformer (DeepSeekMoE / Qwen2-MoE shape: routed experts
plus an always-on shared expert), on one device.

Port of paddle_tpu/nlp/moe.py with `mesh=None`: `gshard_capacity`,
`top_k_routing` (index form), `top_k_gating` (one-hot form), `MoeConfig`,
`init_params`, `params_from_numpy`, `moe_block`, the decoder stack,
`forward`, `loss_fn`, `num_params`, `active_params` and
`flops_per_token`. The parameter tree keeps the JAX package's keys and
its stacked [L, ...] layer and [L, E, ...] expert weights, so a tree made
there moves here with `params_from_numpy`. Sharding tables, expert
parallelism and the pipeline schedules are the multi-GPU slice and raise
`NotImplementedError`.

Routing runs in f32 and int32, all on the device: the iterative argmax
top-k, capacity slots by f32 cumsum (later choices stack after earlier
choices' occupancy), the capacity drop and the inverse maps through a
sink slot. The MoE block uses the expert-leading layout [E, B·C, D]: the
dispatch and the combine are the row-gather kernels of
`kernels.moe_dispatch`, the expert FFNs batched `torch.matmul`, plain
GEMMs as they are XLA einsums in the JAX package. Attention and the two
norms of each layer reuse `llama._attention` and `llama._make_norm`, so
they run the flash and RMSNorm kernels.

With `cfg.remat` each layer is recomputed in the backward, router
included: the JAX package saves the routing maps instead
(`checkpoint_name("moe_routing")`). The step is deterministic, so the
recomputed maps are the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..kernels.moe_dispatch import combine_wsum, dispatch_gather
from ..kernels.rms_norm import rms_norm_ref
from ..kernels.rope import rope_freqs
from . import llama as _llama

_MULTI_GPU = ("is not ported yet: sharded MoE (expert parallelism, the "
              "mesh and the pipeline schedules) comes with the multi-GPU "
              "slice")


def gshard_capacity(tokens: int, k: int, num_experts: int,
                    factor: float) -> int:
    """GShard expert capacity: the share of k·T routed slots per expert,
    scaled by the capacity factor and rounded half up."""
    per = tokens * k / num_experts
    return max(int(per * factor + 0.5), 1)


def _one_hot(idx, n: int):
    """f32 one-hot of int idx [...] over n classes (no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k_routing(gate_logits, k: int, capacity: int,
                  renormalize: bool = True):
    """GShard top-k gating with capacity, INDEX form.

    gate_logits [..., T, E] (f32; leading dims are independent groups,
    as `jax.vmap` maps them in the JAX package). Returns (eidx [..., T, k]
    int32, slot [..., T, k] int32, probs [..., T, k] f32, valid
    [..., T, k] bool, inv [..., E, C] int32, aux): token t's j-th choice
    goes to expert eidx[t, j] at capacity slot slot[t, j] with gate
    weight probs[t, j], and is dropped where not valid; inv names the
    token filling slot [e, c] (-1 = empty). aux holds the Switch
    load-balance loss and the router z-loss, one per group."""
    with torch.profiler.record_function("moe_routing"):
        T, E = gate_logits.shape[-2:]
        probs_full = torch.softmax(gate_logits.float(), dim=-1)

        # iterative top-k: mask out the chosen expert each round; argmax
        # returns the first maximum, as jnp.argmax does
        masked = probs_full
        sel_idx, sel_masks, sel_probs = [], [], []
        for _ in range(k):
            idx = torch.argmax(masked, dim=-1)
            onehot = _one_hot(idx, E)
            sel_idx.append(idx.to(torch.int32))
            sel_masks.append(onehot)
            sel_probs.append(torch.sum(probs_full * onehot, dim=-1))
            masked = masked * (1.0 - onehot)
        if renormalize:
            denom = sum(sel_probs)
            sel_probs = [p / torch.clamp(denom, min=1e-9) for p in sel_probs]

        # capacity slots: each token's position within its expert, later
        # choices stacking after earlier choices' occupancy (f32 counts,
        # exact below 2^24)
        slots, valids = [], []
        prior = torch.zeros(gate_logits.shape[:-2] + (E,),
                            dtype=torch.float32, device=gate_logits.device)
        for mask in sel_masks:
            pos = torch.cumsum(mask, dim=-2) - 1.0 + prior[..., None, :]
            prior = prior + torch.sum(mask, dim=-2)
            in_cap = (pos < capacity) & (mask > 0)
            slots.append(torch.sum(pos * mask, dim=-1).to(torch.int32))
            valids.append(torch.any(in_cap, dim=-1))

        eidx = torch.stack(sel_idx, dim=-1)
        slot = torch.stack(slots, dim=-1)
        probs = torch.stack(sel_probs, dim=-1)
        valid = torch.stack(valids, dim=-1)

        # inverse map: the token filling each (e, c) slot, scattered into
        # a flat [E·C] table with one sink slot past the end for the
        # dropped choices, then cut off
        flat = torch.where(valid, eidx * capacity + slot, E * capacity)
        lead = flat.shape[:-2]
        tok = torch.arange(T, dtype=torch.int32, device=flat.device)
        tok = tok[:, None].expand(flat.shape).reshape(lead + (T * k,))
        inv = torch.full(lead + (E * capacity + 1,), -1, dtype=torch.int32,
                         device=flat.device)
        inv.scatter_(-1, flat.reshape(lead + (T * k,)).long(), tok)
        inv = inv[..., :-1].reshape(lead + (E, capacity))

        # Switch load-balance loss from the FIRST choice, and the z-loss
        frac = torch.mean(sel_masks[0], dim=-2)
        mean_p = torch.mean(probs_full, dim=-2)
        aux = {
            "load_balance_loss": E * torch.sum(frac * mean_p, dim=-1),
            "router_z_loss": torch.mean(
                torch.logsumexp(gate_logits, dim=-1) ** 2, dim=-1),
        }
    return eidx, slot, probs, valid, inv, aux


def top_k_gating(gate_logits, k: int, capacity: int,
                 renormalize: bool = True):
    """GShard top-k gating, ONE-HOT form: (dispatch, combine) [T, E, C]
    f32 built from `top_k_routing`'s indices, and aux. It materialises
    O(T·E·C) tensors; the MoE block uses the index form."""
    T, E = gate_logits.shape
    eidx, slot, probs, valid, _, aux = top_k_routing(
        gate_logits, k, capacity, renormalize)
    dispatch = torch.zeros(T, E, capacity, dtype=torch.float32,
                           device=gate_logits.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        oh = (_one_hot(eidx[:, j], E)[..., None]
              * _one_hot(slot[:, j], capacity)[:, None]
              * valid[:, j, None, None].float())
        dispatch = dispatch + oh
        combine = combine + oh * probs[:, j, None, None]
    return dispatch, combine, aux


@dataclasses.dataclass
class MoeConfig:
    """MoE transformer config (Qwen2-MoE / DeepSeekMoE shape: routed
    experts plus an optional always-on shared expert)."""
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632       # dense (shared) FFN width
    moe_intermediate_size: int = 1408   # per-expert FFN width
    num_experts: int = 8
    num_experts_per_tok: int = 2
    num_shared_experts: int = 1         # 0 disables the shared expert
    capacity_factor: float = 1.25
    num_hidden_layers: int = 4
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    router_aux_loss_coef: float = 0.01
    router_z_loss_coef: float = 0.001
    dtype: Any = torch.bfloat16         # compute dtype
    param_dtype: Any = torch.float32    # storage dtype of every leaf
    remat: bool = True                  # recompute each layer in backward
    attn_impl: str = "flash"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def capacity(self, tokens: int) -> int:
        return gshard_capacity(tokens, self.num_experts_per_tok,
                               self.num_experts, self.capacity_factor)

    @staticmethod
    def tiny(**over) -> "MoeConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    moe_intermediate_size=32, num_experts=4,
                    num_experts_per_tok=2, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=128)
        base.update(over)
        return MoeConfig(**base)

    @staticmethod
    def qwen2_moe_a14b(**over) -> "MoeConfig":
        """Qwen2-57B-A14B-shaped config (public card numbers)."""
        base = dict(vocab_size=151936, hidden_size=3584,
                    intermediate_size=18944, moe_intermediate_size=2560,
                    num_experts=64, num_experts_per_tok=8,
                    num_shared_experts=1, num_hidden_layers=28,
                    num_attention_heads=28, num_key_value_heads=4,
                    max_position_embeddings=32768, rope_theta=1000000.0)
        base.update(over)
        return MoeConfig(**base)

    @staticmethod
    def deepseek_moe_16b(**over) -> "MoeConfig":
        """DeepSeekMoE-16B-shaped config (public card numbers)."""
        base = dict(vocab_size=102400, hidden_size=2048,
                    intermediate_size=10944, moe_intermediate_size=1408,
                    num_experts=64, num_experts_per_tok=6,
                    num_shared_experts=2, num_hidden_layers=28,
                    num_attention_heads=16, num_key_value_heads=16,
                    max_position_embeddings=4096)
        base.update(over)
        return MoeConfig(**base)

    @staticmethod
    def flagship_moe(**over) -> "MoeConfig":
        """The JAX package's single-chip MoE training config (bench.py:98
        `run_moe`): ~1.57B params (~0.51B active), 16 experts top-2 of
        width 1024 plus one shared expert, 12 layers, GQA 16/8, bf16
        params."""
        base = dict(vocab_size=32000, hidden_size=2048,
                    intermediate_size=5632, moe_intermediate_size=1024,
                    num_experts=16, num_experts_per_tok=2,
                    num_shared_experts=1, num_hidden_layers=12,
                    num_attention_heads=16, num_key_value_heads=8,
                    max_position_embeddings=2048,
                    param_dtype=torch.bfloat16)
        base.update(over)
        return MoeConfig(**base)


def _llama_cfg(cfg: MoeConfig) -> _llama.LlamaConfig:
    """Attention and the layer norms reuse the llama implementation."""
    return _llama.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        dtype=cfg.dtype, param_dtype=cfg.param_dtype, remat=cfg.remat,
        attn_impl=cfg.attn_impl)


# ---------------------------------------------------------------- params
def _shapes(cfg: MoeConfig) -> Dict[str, Any]:
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers
    E, Fm = cfg.num_experts, cfg.moe_intermediate_size
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    layers = {
        "input_layernorm": (L, D),
        "q_proj": (L, D, H * hd),
        "k_proj": (L, D, KV * hd),
        "v_proj": (L, D, KV * hd),
        "o_proj": (L, H * hd, D),
        "post_attention_layernorm": (L, D),
        "gate": (L, D, E),
        "expert_gate_proj": (L, E, D, Fm),
        "expert_up_proj": (L, E, D, Fm),
        "expert_down_proj": (L, E, Fm, D),
    }
    if cfg.num_shared_experts:
        Fs = Fm * cfg.num_shared_experts
        layers.update({"shared_gate_proj": (L, D, Fs),
                       "shared_up_proj": (L, D, Fs),
                       "shared_down_proj": (L, Fs, D)})
    return {"embed_tokens": (V, D), "layers": layers, "norm": (D,),
            "lm_head": (D, V)}


def init_params(cfg: MoeConfig, generator: Optional[torch.Generator] = None,
                device="cuda", training: bool = True) -> Dict[str, Any]:
    """Random parameters made on `device`, every leaf in
    `cfg.param_dtype`: N(0, 0.02) projections, experts and embeddings,
    ones for the norm scales — the JAX `init_params` recipe. `generator`
    (on `device`) seeds the draws; torch's numbers differ from
    jax.random's, so parity tests carry a JAX tree across with
    `params_from_numpy`. `training` is accepted for the train step's
    uniform call; the MoE model has only the training tree."""
    if not training:
        raise ValueError("the MoE model has one parameter tree, the "
                         "training tree (every leaf in cfg.param_dtype)")
    dev = resolve_device(device)

    def make(name, shape):
        if name.endswith("layernorm") or name == "norm":
            return torch.ones(shape, dtype=cfg.param_dtype, device=dev)
        w = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        return w.normal_(0.0, 0.02, generator=generator)

    shapes = _shapes(cfg)
    params = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: MoeConfig,
                      device="cuda") -> Dict[str, Any]:
    """Carry a JAX MoE `init_params` tree (numpy arrays, same keys,
    stacked [L, ...] and [L, E, ...] leaves) to `device`, every leaf at
    `cfg.param_dtype`."""
    dev = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=cfg.param_dtype)

    out = {k: conv(a) for k, a in tree.items() if k != "layers"}
    out["layers"] = {k: conv(a) for k, a in tree["layers"].items()}
    return out


def param_specs(cfg: MoeConfig, pp: bool = False):
    raise NotImplementedError(f"param_specs {_MULTI_GPU}")


# --------------------------------------------------------------- forward
def _no_mesh(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(f"{what} with a mesh {_MULTI_GPU}")


def _routing_maps(eidx, slot, probs, valid, C: int, E: int):
    """The expert-leading index maps of one device's MoE block, from
    routing over B groups of S tokens ([B, S, k] each). Rows: slot
    (e, b, c) at e·B·C + b·C + c; (token, choice) (b, s, j) at
    b·S·k + s·k + j. Returns (flat_g [1, B·S·k] int32, the slot of each
    (token, choice), -1 = dropped; inv_pos [1, E·B·C] int32, the
    (token, choice) filling each slot, -1 = empty; inv_tok [1, E·B·C]
    int32, its token; idx_tk [1, B·S, k] the clipped slots and w_tk
    [1, B·S, k] f32 the gate probs, 0 where dropped — combine_wsum's
    contract)."""
    B, S, k = eidx.shape
    boff = (torch.arange(B, dtype=torch.int32, device=eidx.device)
            * C)[:, None, None]
    flat_g = torch.where(valid, eidx * (B * C) + boff + slot, -1)
    flat_g = flat_g.reshape(1, B * S * k)
    # inverse map through a sink slot at E·B·C, then cut off
    safe = torch.where(flat_g >= 0, flat_g, E * B * C).long()
    inv_pos = torch.full((1, E * B * C + 1), -1, dtype=torch.int32,
                         device=eidx.device)
    inv_pos.scatter_(1, safe, torch.arange(
        B * S * k, dtype=torch.int32, device=eidx.device)[None])
    inv_pos = inv_pos[:, :-1]
    inv_tok = torch.where(inv_pos >= 0,
                          torch.div(inv_pos, k, rounding_mode="floor"), -1)
    idx_tk = flat_g.clamp(min=0).reshape(1, B * S, k)
    w_tk = torch.where(flat_g >= 0, probs.reshape(1, B * S * k).float(),
                       0.0).reshape(1, B * S, k)
    return flat_g, inv_pos, inv_tok, idx_tk, w_tk


def moe_block(x, lp: Dict[str, Any], cfg: MoeConfig, mesh=None):
    """x [B, S, D] (compute dtype) → (y [B, S, D], aux). Routed experts
    plus the optional shared expert, one device.

    GShard grouped routing: capacity is per batch row (group), C =
    capacity(S) slots per expert per row. The expert-leading layout
    [E, B·C, D] is one flat row space for dispatch, expert GEMMs and
    combine: `dispatch_gather` gathers token rows into expert slots,
    `combine_wsum` gathers them back weighted by the gate probs."""
    _no_mesh(mesh, "moe_block")
    B, S, D = x.shape
    cd = cfg.dtype
    k = cfg.num_experts_per_tok
    E = cfg.num_experts
    C = cfg.capacity(S)

    logits = x.float() @ lp["gate"].float()                   # [B, S, E]
    eidx, slot, probs, valid, _, aux = top_k_routing(logits, k, C)
    aux = {n: torch.mean(v) for n, v in aux.items()}
    flat_g, inv_pos, inv_tok, idx_tk, w_tk = _routing_maps(
        eidx, slot, probs, valid, C, E)
    expert_in = dispatch_gather(x.reshape(1, B * S, D).to(cd), inv_tok,
                                flat_g, k).reshape(E, B * C, D)
    g = torch.matmul(expert_in, lp["expert_gate_proj"].to(cd))
    u = torch.matmul(expert_in, lp["expert_up_proj"].to(cd))
    expert_out = torch.matmul(F.silu(g) * u, lp["expert_down_proj"].to(cd))
    y = combine_wsum(expert_out.reshape(1, E * B * C, D), idx_tk, w_tk,
                     inv_pos).reshape(B, S, D).to(cd)
    if cfg.num_shared_experts:
        sg = x @ lp["shared_gate_proj"].to(cd)
        su = x @ lp["shared_up_proj"].to(cd)
        y = y + (F.silu(sg) * su) @ lp["shared_down_proj"].to(cd)
    return y, aux


def _decoder_layer(x, lp, cfg: MoeConfig, lcfg, cos, sin):
    """One MoE decoder layer → (x, load-balance loss, z-loss)."""
    norm = _llama._make_norm(lcfg)
    a = norm(x, lp["input_layernorm"])
    h = x + _llama._attention(a, lp, lcfg, cos, sin)
    a = norm(h, lp["post_attention_layernorm"])
    y, aux = moe_block(a, lp, cfg)
    return h + y, aux["load_balance_loss"], aux["router_z_loss"]


def _backbone(params, tokens, cfg: MoeConfig):
    """Embed + MoE decoder stack → (pre-norm x [B, S, D], aux losses
    averaged over the layers). With `cfg.remat` each layer keeps only its
    input and is recomputed, router included, in the backward."""
    lcfg = _llama_cfg(cfg)
    x = params["embed_tokens"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_freqs(cfg.head_dim, tokens.shape[1], cfg.rope_theta,
                          torch.float32, device=x.device)
    names = list(params["layers"])
    views = [params["layers"][k].unbind(0) for k in names]
    lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(cfg.num_hidden_layers):
        lp = {k: vs[layer] for k, vs in zip(names, views)}
        if cfg.remat:
            x, dlb, dzl = checkpoint(_decoder_layer, x, lp, cfg, lcfg, cos,
                                     sin, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            x, dlb, dzl = _decoder_layer(x, lp, cfg, lcfg, cos, sin)
        lb, zl = lb + dlb, zl + dzl
    L = cfg.num_hidden_layers
    return x, {"load_balance_loss": lb / L, "router_z_loss": zl / L}


def forward(params: Dict[str, Any], tokens, cfg: MoeConfig, mesh=None):
    """tokens [B, S] → (logits [B, S, V] f32, aux losses)."""
    _no_mesh(mesh, "forward")
    x, aux = _backbone(params, tokens, cfg)
    x = rms_norm_ref(x, params["norm"], cfg.rms_norm_eps)
    logits = x.to(cfg.dtype) @ params["lm_head"].to(cfg.dtype)
    return logits.float(), aux


def forward_pp(params, tokens, cfg: MoeConfig, mesh, num_microbatches: int):
    raise NotImplementedError(f"forward_pp {_MULTI_GPU}")


def loss_and_grad_pp(params, tokens, cfg: MoeConfig, mesh,
                     num_microbatches: int, virtual_pp: int = 1):
    raise NotImplementedError(f"loss_and_grad_pp {_MULTI_GPU}")


def loss_fn(params, tokens, cfg: MoeConfig, mesh=None,
            pp_microbatches: Optional[int] = None, pp_virtual: int = 1):
    """Next-token CE through the fused head (`llama.fused_head_ce`), plus
    the router losses: router_aux_loss_coef · load-balance +
    router_z_loss_coef · z, each averaged over the layers."""
    _no_mesh(mesh, "loss_fn")
    if pp_microbatches or pp_virtual > 1:
        raise NotImplementedError(f"pipeline microbatches {_MULTI_GPU}")
    x, aux = _backbone(params, tokens, cfg)
    x = rms_norm_ref(x, params["norm"], cfg.rms_norm_eps)
    ce = _llama.fused_head_ce(x.to(cfg.dtype),
                              params["lm_head"].to(cfg.dtype), tokens)
    return (ce + cfg.router_aux_loss_coef * aux["load_balance_loss"]
            + cfg.router_z_loss_coef * aux["router_z_loss"])


# ----------------------------------------------------------------- counts
def num_params(cfg: MoeConfig) -> int:
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers
    E, Fm = cfg.num_experts, cfg.moe_intermediate_size
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per = (2 * D + D * (H + 2 * KV) * hd + H * hd * D
           + D * E + 3 * E * D * Fm)
    if cfg.num_shared_experts:
        per += 3 * D * Fm * cfg.num_shared_experts
    return V * D + L * per + D + D * V


def active_params(cfg: MoeConfig) -> int:
    """Parameters touched per token (the 'A14B' in Qwen2-57B-A14B)."""
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers
    Fm = cfg.moe_intermediate_size
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per = (2 * D + D * (H + 2 * KV) * hd + H * hd * D + D * cfg.num_experts
           + 3 * D * Fm * cfg.num_experts_per_tok)
    if cfg.num_shared_experts:
        per += 3 * D * Fm * cfg.num_shared_experts
    return V * D + L * per + D + D * V


def flops_per_token(cfg: MoeConfig, seq_len: int) -> float:
    """Approx. train FLOPs/token over ACTIVE params (the MoE convention:
    only routed and shared experts do work), the 6x fwd+bwd and
    causal-halved attention count of `llama.flops_per_token`; capacity
    padding and recompute are not credited."""
    D, Fm, L = (cfg.hidden_size, cfg.moe_intermediate_size,
                cfg.num_hidden_layers)
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    matmul = L * (D * (H + 2 * KV) * hd + H * hd * D + D * cfg.num_experts
                  + 3 * D * Fm * (cfg.num_experts_per_tok
                                  + cfg.num_shared_experts)) \
        + cfg.vocab_size * D
    attn = L * H * hd * seq_len
    return 6.0 * (matmul + attn)
