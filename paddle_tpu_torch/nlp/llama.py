"""Llama-family model config and parameters — the serving slice.

Port of the parts of paddle_tpu/nlp/llama.py the serving path reads:
`LlamaConfig` (with `tiny` and `llama3_8b`), `init_params`,
`_final_head` and `num_params`. The parameter tree keeps the JAX
package's keys and its stacked [L, ...] layer weights, so a tree made
there moves here with `params_from_numpy`. The training forward, loss
and sharding tables are later slices.

Unlike the JAX package, which stores f32 master weights and casts at
every use, the serving tree holds projection, embedding and head weights
in the compute dtype from the start (norm scales stay f32): the same
numbers, without re-reading an f32 8B tree on every step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.rms_norm import rms_norm_ref

# tree keys whose weights feed a matmul or the embedding gather
_CAST_KEYS = ("embed_tokens", "lm_head", "q_proj", "k_proj", "v_proj",
              "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32       # < heads → GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16         # compute dtype

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**over) -> "LlamaConfig":
        """Test-sized config."""
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
        base.update(over)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b(**over) -> "LlamaConfig":
        base = dict(vocab_size=128256, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=8192, rope_theta=500000.0)
        base.update(over)
        return LlamaConfig(**base)


def _shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    D, F, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    shapes = {
        "embed_tokens": (V, D),
        "layers": {
            "input_layernorm": (L, D),
            "q_proj": (L, D, H * hd),
            "k_proj": (L, D, KV * hd),
            "v_proj": (L, D, KV * hd),
            "o_proj": (L, H * hd, D),
            "post_attention_layernorm": (L, D),
            "gate_proj": (L, D, F),
            "up_proj": (L, D, F),
            "down_proj": (L, F, D),
        },
        "norm": (D,),
    }
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters made on `device`: N(0, 0.02) projections and
    embeddings in the compute dtype, ones for the norm scales (f32) — the
    JAX `init_params` recipe. `generator` (on `device`) seeds the draws;
    torch's numbers differ from jax.random's, so parity tests carry a
    JAX tree across with `params_from_numpy` instead."""
    dev = resolve_device(device)

    def make(name, shape):
        if name.endswith("layernorm") or name == "norm":
            return torch.ones(shape, dtype=torch.float32, device=dev)
        w = torch.empty(shape, dtype=cfg.dtype, device=dev)
        return w.normal_(0.0, 0.02, generator=generator)

    shapes = _shapes(cfg)
    params = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig,
                      device="cuda") -> Dict[str, Any]:
    """Carry a JAX `init_params` tree (numpy arrays, same keys, stacked
    [L, ...] layers) to `device`: projection, embedding and head weights
    cast once to `cfg.dtype`, norm scales kept f32."""
    dev = resolve_device(device)

    def conv(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        dt = cfg.dtype if name in _CAST_KEYS else torch.float32
        return t.to(device=dev, dtype=dt)

    out = {k: conv(k, a) for k, a in tree.items() if k != "layers"}
    out["layers"] = {k: conv(k, a) for k, a in tree["layers"].items()}
    return out


def _head_weights(params, cfg: LlamaConfig):
    """The LM head matrix [D, V] (tied: the embedding's transpose)."""
    return (params["embed_tokens"].T if cfg.tie_word_embeddings
            else params["lm_head"])


def _final_head(params, x, cfg: LlamaConfig):
    """Final RMSNorm + LM head: x [B,S,D] → logits [B,S,V] (f32)."""
    cd = cfg.dtype
    x = rms_norm_ref(x, params["norm"], cfg.rms_norm_eps)
    logits = x.to(cd) @ _head_weights(params, cfg).to(cd)
    return logits.float()


def num_params(cfg: LlamaConfig) -> int:
    D, F, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per_layer = 2 * D + D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    total = V * D + L * per_layer + D
    if not cfg.tie_word_embeddings:
        total += D * V
    return total
