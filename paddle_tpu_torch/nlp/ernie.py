"""ERNIE-family encoder config and its counts — port of the jax-free part
of paddle_tpu/nlp/ernie.py that the eager ERNIE path uses: `ErnieConfig`
(with `ernie3_base`, BASELINE config 1, and `tiny`), `num_params` and
`flops_per_token`. The functional model (`init_params`, the scanned
forward, `finetune_loss` and its key-padding mask) arrives with the ERNIE
slice (ROADMAP.md Queue 1)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class ErnieConfig:
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


def num_params(cfg: ErnieConfig) -> int:
    D, F, L, V = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    per_layer = 3 * D * D + 3 * D + D * D + D + 2 * D * F + F + D + 4 * D
    emb = V * D + cfg.max_position_embeddings * D + cfg.type_vocab_size * D
    return emb + L * per_layer + 2 * D + (D * D + D) + \
        (D * cfg.num_labels + cfg.num_labels) + (D * D + D + 2 * D + V)


def flops_per_token(cfg: ErnieConfig, seq_len: int) -> float:
    """Approx. train FLOPs/token (fwd+bwd = 6x fwd MACs): encoder qkvo +
    ffn matmuls + BIDIRECTIONAL attention (every token attends all
    seq_len keys — no causal halving, unlike llama.flops_per_token)."""
    D, F, H = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    matmul = 4 * D * D + 2 * D * F
    attn = 2 * H * cfg.head_dim * seq_len
    return 6.0 * cfg.num_hidden_layers * (matmul + attn)
