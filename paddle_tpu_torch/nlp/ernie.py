"""ERNIE-family encoder — the BASELINE 'ERNIE-3.0 finetune' workload.

Port of paddle_tpu/nlp/ernie.py on one device: `ErnieConfig` (with
`ernie3_base`, BASELINE config 1, and `tiny`), `init_params`,
`params_from_numpy`, the post-LN encoder (`_layer_norm`,
`_encoder_layer`, `encode`, `forward`), the heads (`cls_logits`,
`mlm_logits`) and losses (`finetune_loss`, `mlm_loss`), `num_params` and
`flops_per_token`. The parameter tree keeps the JAX package's keys and
its stacked [L, ...] layer weights, so a tree made there moves here with
`params_from_numpy`. The sharding tables (`param_specs`, `batch_spec`)
are the multi-GPU slice.

Attention is einsum-form and head-major: q/k/v come out of the
projections as [B, H, S, hd] and run the flash kernels in 'bhsd'
(`kernels.flash_attention`), with the [B, S] `attention_mask` as the
kernels' key-padding mask, chosen as the JAX package chooses
(`_encoder_layer`). The norms are plain f32 torch, as they are plain jnp
in the JAX package, so this path launches no LayerNorm kernel. The
layer scan is a Python loop over per-layer views; `remat` wraps each
layer in `torch.utils.checkpoint`, as `jax.checkpoint` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..kernels import flash_attention as fa


@dataclasses.dataclass
class ErnieConfig:
    """`remat`: recompute each layer in the backward
    (`torch.utils.checkpoint`). `scan_unroll` is accepted for the JAX
    package's configs and has no effect: the port's layer loop is a
    Python loop, which is already unrolled."""
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12
    num_labels: int = 2                 # classification head width
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False
    scan_unroll: Any = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**over) -> "ErnieConfig":
        base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=64, type_vocab_size=2)
        base.update(over)
        return ErnieConfig(**base)

    @staticmethod
    def ernie3_base(**over) -> "ErnieConfig":
        base = dict(vocab_size=40000, hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, intermediate_size=3072)
        base.update(over)
        return ErnieConfig(**base)


def _shapes(cfg: ErnieConfig) -> Dict[str, Any]:
    D, F_, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    return {
        "word_embeddings": (cfg.vocab_size, D),
        "position_embeddings": (cfg.max_position_embeddings, D),
        "token_type_embeddings": (cfg.type_vocab_size, D),
        "embed_norm_scale": (D,), "embed_norm_bias": (D,),
        "layers": {
            "q_w": (L, D, D), "q_b": (L, D),
            "k_w": (L, D, D), "k_b": (L, D),
            "v_w": (L, D, D), "v_b": (L, D),
            "out_w": (L, D, D), "out_b": (L, D),
            "attn_norm_scale": (L, D), "attn_norm_bias": (L, D),
            "ffn_in_w": (L, D, F_), "ffn_in_b": (L, F_),
            "ffn_out_w": (L, F_, D), "ffn_out_b": (L, D),
            "ffn_norm_scale": (L, D), "ffn_norm_bias": (L, D),
        },
        "pooler_w": (D, D), "pooler_b": (D,),
        "classifier_w": (D, cfg.num_labels), "classifier_b": (cfg.num_labels,),
        "mlm_transform_w": (D, D), "mlm_transform_b": (D,),
        "mlm_norm_scale": (D,), "mlm_norm_bias": (D,),
        "mlm_bias": (cfg.vocab_size,),
    }


def init_params(cfg: ErnieConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in `cfg.param_dtype` made on `device`, the JAX
    `init_params` recipe: N(0, 0.02) matrices and embeddings, ones for
    the norm scales, zeros for the biases. `generator` (on `device`)
    seeds the draws; torch's numbers differ from jax.random's, so parity
    tests carry a JAX tree across with `params_from_numpy` instead."""
    dev = resolve_device(device)

    def make(name, shape):
        if name.endswith("_scale"):
            return torch.ones(shape, dtype=cfg.param_dtype, device=dev)
        if name.endswith(("_b", "_bias")):
            return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        w = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        return w.normal_(0.0, 0.02, generator=generator)

    shapes = _shapes(cfg)
    params = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: ErnieConfig,
                      device="cuda") -> Dict[str, Any]:
    """Carry a JAX `init_params` tree (numpy arrays, the same keys,
    stacked [L, ...] layers) to `device` in `cfg.param_dtype`."""
    dev = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=cfg.param_dtype)

    out = {k: conv(a) for k, a in tree.items() if k != "layers"}
    out["layers"] = {k: conv(a) for k, a in tree["layers"].items()}
    return out


def param_specs(cfg: ErnieConfig):
    raise NotImplementedError(
        "ernie.param_specs: the TP + ZeRO-3 sharding table comes with the "
        "multi-GPU slice (ROADMAP.md Queue 1)")


def batch_spec():
    raise NotImplementedError(
        "ernie.batch_spec: data-parallel batch sharding comes with the "
        "multi-GPU slice (ROADMAP.md Queue 1)")


def _layer_norm(x, scale, bias, eps):
    """Plain f32 LayerNorm, as the JAX package's (plain jnp there too)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _encoder_layer(x, lp, cfg: ErnieConfig, mask):
    dt = cfg.dtype
    B, S, D = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    # einsum-form attention, head-major: q/k/v land [B, H, S, hd] and the
    # flash kernels read them through their strides ('bhsd')
    q, k, v = [torch.einsum("bsd,dhe->bhse", x,
                            lp[w].to(dt).reshape(D, H, hd)) +
               lp[b].to(dt).reshape(H, hd)[None, :, None, :]
               for w, b in (("q_w", "q_b"), ("k_w", "k_b"), ("v_w", "v_b"))]
    if mask is None and not fa.block_aligned(S):
        # the JAX package's route for an unaligned length: an all-ones
        # key mask keeps it on the masked kernel
        mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    if mask is None:
        ctx = fa.flash_attention(q, k, v, False, None, "bhsd")
    else:
        ctx = fa.flash_attention_masked(q, k, v, mask, None, "bhsd")
    attn_out = torch.einsum("bhse,hed->bsd", ctx,
                            lp["out_w"].to(dt).reshape(H, hd, D)) + \
        lp["out_b"].to(dt)
    x = _layer_norm(x + attn_out, lp["attn_norm_scale"],
                    lp["attn_norm_bias"], cfg.layer_norm_eps)
    h = F.gelu(x @ lp["ffn_in_w"].to(dt) + lp["ffn_in_b"].to(dt),
               approximate="tanh")
    h = h @ lp["ffn_out_w"].to(dt) + lp["ffn_out_b"].to(dt)
    return _layer_norm(x + h, lp["ffn_norm_scale"], lp["ffn_norm_bias"],
                       cfg.layer_norm_eps)


def encode(params, input_ids, token_type_ids=None, attention_mask=None,
           cfg: ErnieConfig = None):
    """→ sequence output [B, S, D] (compute dtype). attention_mask
    [B, S]: nonzero = a real token, the others hidden as keys."""
    dt = cfg.dtype
    B, S = input_ids.shape
    dev = params["word_embeddings"].device
    tt = token_type_ids if token_type_ids is not None \
        else torch.zeros_like(input_ids)
    x = params["word_embeddings"][input_ids] + \
        params["position_embeddings"][torch.arange(S, device=dev)][None] + \
        params["token_type_embeddings"][tt]
    x = _layer_norm(x.to(dt), params["embed_norm_scale"],
                    params["embed_norm_bias"], cfg.layer_norm_eps)
    if attention_mask is not None:
        attention_mask = torch.as_tensor(attention_mask, device=dev)
    layers = params["layers"]
    for i in range(cfg.num_hidden_layers):
        lp = {k: t[i] for k, t in layers.items()}
        if cfg.remat:
            x = checkpoint(_encoder_layer, x, lp, cfg, attention_mask,
                           use_reentrant=False)
        else:
            x = _encoder_layer(x, lp, cfg, attention_mask)
    return x


def forward(params, input_ids, token_type_ids=None, attention_mask=None,
            cfg: ErnieConfig = None):
    """→ (sequence_output [B, S, D], pooled_output [B, D]) like the
    reference's ErnieModel.forward."""
    seq = encode(params, input_ids, token_type_ids, attention_mask, cfg)
    pooled = torch.tanh(seq[:, 0] @ params["pooler_w"].to(cfg.dtype) +
                        params["pooler_b"].to(cfg.dtype))
    return seq, pooled


def cls_logits(params, pooled, cfg: ErnieConfig):
    return (pooled.float() @ params["classifier_w"].float() +
            params["classifier_b"].float())


def mlm_logits(params, seq, cfg: ErnieConfig):
    h = F.gelu(seq @ params["mlm_transform_w"].to(cfg.dtype) +
               params["mlm_transform_b"].to(cfg.dtype), approximate="tanh")
    h = _layer_norm(h, params["mlm_norm_scale"], params["mlm_norm_bias"],
                    cfg.layer_norm_eps)
    # decoder tied to the word embeddings (the reference ties the MLM head)
    return (h.float() @ params["word_embeddings"].float().T +
            params["mlm_bias"].float())


def finetune_loss(params, input_ids, labels, cfg: ErnieConfig,
                  token_type_ids=None, attention_mask=None):
    """Sequence-classification CE (the BASELINE finetune objective)."""
    _, pooled = forward(params, input_ids, token_type_ids, attention_mask,
                        cfg)
    logp = torch.log_softmax(cls_logits(params, pooled, cfg), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def mlm_loss(params, input_ids, mlm_labels, cfg: ErnieConfig,
             token_type_ids=None, attention_mask=None, ignore_index=-100):
    seq = encode(params, input_ids, token_type_ids, attention_mask, cfg)
    logp = torch.log_softmax(mlm_logits(params, seq, cfg), dim=-1)
    mask = mlm_labels != ignore_index
    safe = torch.where(mask, mlm_labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def num_params(cfg: ErnieConfig) -> int:
    D, F_, L, V = (cfg.hidden_size, cfg.intermediate_size,
                   cfg.num_hidden_layers, cfg.vocab_size)
    per_layer = 3 * D * D + 3 * D + D * D + D + 2 * D * F_ + F_ + D + 4 * D
    emb = V * D + cfg.max_position_embeddings * D + cfg.type_vocab_size * D
    return emb + L * per_layer + 2 * D + (D * D + D) + \
        (D * cfg.num_labels + cfg.num_labels) + (D * D + D + 2 * D + V)


def flops_per_token(cfg: ErnieConfig, seq_len: int) -> float:
    """Approx. train FLOPs/token (fwd+bwd = 6x fwd MACs): encoder qkvo +
    ffn matmuls + BIDIRECTIONAL attention (every token attends all
    seq_len keys — no causal halving, unlike llama.flops_per_token)."""
    D, F_, H = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    matmul = 4 * D * D + 2 * D * F_
    attn = 2 * H * cfg.head_dim * seq_len
    return 6.0 * cfg.num_hidden_layers * (matmul + attn)
