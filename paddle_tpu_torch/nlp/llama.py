"""Llama-family model: config, parameters, the training forward and loss.

Port of paddle_tpu/nlp/llama.py on one device: `LlamaConfig` (with
`tiny` and `llama3_8b`), `init_params`, `params_from_numpy`, the forward
(`_attention`, `_mlp`, `_decoder_layer`, `_backbone`, `forward`,
`_final_head`), the losses (`_mb_loss`, `fused_head_ce`, `loss_fn`),
`num_params` and `flops_per_token`. The parameter tree keeps the JAX
package's keys and its stacked [L, ...] layer weights, so a tree made
there moves here with `params_from_numpy`. Sharding tables, the mesh
and the pipeline schedules are the multi-GPU slice.

The decoder's `lax.scan` over stacked weights is a loop over per-layer
views (`unbind`, whose backward stacks the layer grads once), and
`jax.checkpoint(..., nothing_saveable)` is `torch.utils.checkpoint`
with `use_reentrant=False`: only each layer's input is kept, the layer
is recomputed in the backward. Attention runs the flash kernels
(`kernels.flash_attention.flash_attention`; the exact `mha_ref` with
`use_flash=False`, as in the JAX package), the two norms of each
layer the RMSNorm kernels (`kernels.rms_norm.rms_norm_train`); the
final norm, the loss, RoPE, SiLU, the embedding gather and every GEMM
are plain torch, as they are jnp/XLA in the JAX package.

Two trees: the serving tree (`init_params(cfg)`, `params_from_numpy`'s
default) holds projection, embedding and head weights in the compute
dtype from the start and norm scales in f32, the same numbers without
re-reading an f32 tree on every decode step; the training tree
(`training=True`) holds every leaf in `cfg.param_dtype`, as the JAX
package stores its master weights, and is cast to the compute dtype at
each use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..kernels.flash_attention import flash_attention, mha_ref
from ..kernels.rms_norm import rms_norm_ref, rms_norm_train
from ..kernels.rope import apply_rope_half, rope_freqs

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
    param_dtype: Any = torch.float32    # storage dtype of the training tree
    remat: bool = True                  # recompute each layer in backward
    # attention through the flash kernels; False runs the exact `mha_ref`
    # (the JAX package's switch, which its generation tests turn off)
    use_flash: bool = True
    # loss path: True routes loss_fn through fused_head_ce (no [B, S, V]
    # f32 logits kept for the backward)
    fused_ce: bool = False
    # attention schedule: "flash" on one device; the context-parallel
    # "ring" / "ulysses" schedules belong to the multi-GPU slice
    attn_impl: str = "flash"

    def __post_init__(self):
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} (context-parallel attention "
                f"over a mesh) is not ported yet: it comes with the "
                f"multi-GPU slice")
        if self.attn_impl != "flash":
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")

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

    @staticmethod
    def flagship_2b(**over) -> "LlamaConfig":
        """The JAX package's ~2.1B single-chip training config
        (bench.py:120 `flagship_2b_cfg`): bf16 params, GQA 32/8."""
        base = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=9472, num_hidden_layers=11,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=2048,
                    param_dtype=torch.bfloat16)
        base.update(over)
        return LlamaConfig(**base)


# ---------------------------------------------------------------- params
def _shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    D, F_, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
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
            "gate_proj": (L, D, F_),
            "up_proj": (L, D, F_),
            "down_proj": (L, F_, D),
        },
        "norm": (D,),
    }
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def _leaf_dtype(name: str, cfg: LlamaConfig, training: bool):
    if training:
        return cfg.param_dtype
    return cfg.dtype if name in _CAST_KEYS else torch.float32


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda", training: bool = False) -> Dict[str, Any]:
    """Random parameters made on `device`: N(0, 0.02) projections and
    embeddings, ones for the norm scales — the JAX `init_params` recipe.
    The serving tree (default) holds matmul weights in the compute dtype
    and norms in f32; `training=True` makes every leaf in
    `cfg.param_dtype`. `generator` (on `device`) seeds the draws;
    torch's numbers differ from jax.random's, so parity tests carry a
    JAX tree across with `params_from_numpy` instead."""
    dev = resolve_device(device)

    def make(name, shape):
        dt = _leaf_dtype(name, cfg, training)
        if name.endswith("layernorm") or name == "norm":
            return torch.ones(shape, dtype=dt, device=dev)
        w = torch.empty(shape, dtype=dt, device=dev)
        return w.normal_(0.0, 0.02, generator=generator)

    shapes = _shapes(cfg)
    params = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig,
                      device="cuda", training: bool = False
                      ) -> Dict[str, Any]:
    """Carry a JAX `init_params` tree (numpy arrays, same keys, stacked
    [L, ...] layers) to `device`. The serving tree (default): projection,
    embedding and head weights cast once to `cfg.dtype`, norm scales
    f32. `training=True`: every leaf kept at `cfg.param_dtype`, the
    dtype the JAX training tree stores."""
    dev = resolve_device(device)

    def conv(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=_leaf_dtype(name, cfg, training))

    out = {k: conv(k, a) for k, a in tree.items() if k != "layers"}
    out["layers"] = {k: conv(k, a) for k, a in tree["layers"].items()}
    return out


# --------------------------------------------------------------- forward
def _no_mesh(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{what} with a mesh is not ported yet: sharded training comes "
            f"with the multi-GPU slice")


def _attention(x, lp, cfg: LlamaConfig, cos, sin):
    """x: [B, S, D] (compute dtype); lp: this layer's weights."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cd = cfg.dtype
    q = (x @ lp["q_proj"].to(cd)).reshape(B, S, H, hd)
    k = (x @ lp["k_proj"].to(cd)).reshape(B, S, KV, hd)
    v = (x @ lp["v_proj"].to(cd)).reshape(B, S, KV, hd)
    q, k = apply_rope_half(q, k, cos, sin)
    if cfg.use_flash:
        o = flash_attention(q, k, v, True, None)
    else:
        o = mha_ref(q, k, v, causal=True)
    return o.reshape(B, S, H * hd) @ lp["o_proj"].to(cd)


def _mlp(x, lp, cfg: LlamaConfig):
    cd = cfg.dtype
    g = x @ lp["gate_proj"].to(cd)
    u = x @ lp["up_proj"].to(cd)
    return (F.silu(g) * u) @ lp["down_proj"].to(cd)


def _make_norm(cfg: LlamaConfig, mesh=None):
    """The layers' RMSNorm: the training kernels (their plain twins on
    the CPU)."""
    _no_mesh(mesh, "the layer norm")
    return lambda h, w: rms_norm_train(h, w, cfg.rms_norm_eps)


def _decoder_layer(x, lp, cfg: LlamaConfig, cos, sin):
    norm = _make_norm(cfg)
    h = norm(x, lp["input_layernorm"])
    x = x + _attention(h, lp, cfg, cos, sin)
    h = norm(x, lp["post_attention_layernorm"])
    return x + _mlp(h, lp, cfg)


def _backbone(params, tokens, cfg: LlamaConfig):
    """Embed + decoder stack → pre-norm hidden states [B, S, D]. With
    `cfg.remat` each layer keeps only its input and is recomputed in the
    backward."""
    x = params["embed_tokens"][tokens.long()].to(cfg.dtype)
    cos, sin = rope_freqs(cfg.head_dim, tokens.shape[1], cfg.rope_theta,
                          torch.float32, device=x.device)
    names = list(params["layers"])
    views = [params["layers"][k].unbind(0) for k in names]
    for layer in range(cfg.num_hidden_layers):
        lp = {k: vs[layer] for k, vs in zip(names, views)}
        if cfg.remat:
            x = checkpoint(_decoder_layer, x, lp, cfg, cos, sin,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _decoder_layer(x, lp, cfg, cos, sin)
    return x


def forward(params: Dict[str, Any], tokens, cfg: LlamaConfig, mesh=None):
    """tokens [B, S] → logits [B, S, V] (f32)."""
    _no_mesh(mesh, "forward")
    return _final_head(params, _backbone(params, tokens, cfg), cfg)


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


# ------------------------------------------------------------------ loss
def _valid(S: int, device):
    return (torch.arange(S, device=device) < S - 1).float()


def _mb_loss(logits, tokens):
    """Next-token cross entropy, masked at the final position: targets by
    roll + mask, shapes [B, S] throughout, f32 softmax."""
    tokens = tokens.long()
    targets = torch.roll(tokens, -1, dims=1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    B, S = tokens.shape
    valid = _valid(S, logits.device).to(logits.dtype)
    return torch.sum((logz - gold) * valid[None]) / (B * (S - 1))


_CE_CHUNKS = 8


def _ce_chunks(S: int) -> int:
    # largest chunk count <= _CE_CHUNKS dividing S
    return next(n for n in range(_CE_CHUNKS, 0, -1) if S % n == 0)


class _FusedHeadCE(torch.autograd.Function):
    """LM head + next-token CE without keeping [B, S, V] f32 logits for
    the backward: the forward walks sequence chunks keeping logsumexp
    and the gold logit; the backward recomputes each chunk's logits and
    feeds (softmax − onehot) into the dx / dhead products. Plain torch,
    as it is XLA in the JAX package."""

    @staticmethod
    def forward(ctx, x, head, tokens):
        B, S, _ = x.shape
        nc = _ce_chunks(S)
        c = S // nc
        targets = torch.roll(tokens.long(), -1, dims=1)
        logz, gold = [], []
        for i in range(nc):
            lg = (x[:, i * c:(i + 1) * c] @ head).float()
            logz.append(torch.logsumexp(lg, dim=-1))
            gold.append(torch.gather(
                lg, -1, targets[:, i * c:(i + 1) * c, None])[..., 0])
        logz, gold = torch.cat(logz, 1), torch.cat(gold, 1)
        valid = _valid(S, x.device)
        loss = torch.sum((logz - gold) * valid[None]) / (B * (S - 1))
        ctx.save_for_backward(x, head, targets, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, head, targets, logz = ctx.saved_tensors
        B, S, D = x.shape
        V = head.shape[1]
        nc = _ce_chunks(S)
        c = S // nc
        valid = _valid(S, x.device)
        scale = g / (B * (S - 1))
        dhead = torch.zeros(D, V, dtype=torch.float32, device=x.device)
        dx = []
        for i in range(nc):
            sl = slice(i * c, (i + 1) * c)
            xc = x[:, sl]
            p = torch.exp((xc @ head).float() - logz[:, sl, None])
            d = p - F.one_hot(targets[:, sl], V).float()
            d = (d * (valid[sl, None] * scale)).to(x.dtype)     # [B, c, V]
            dx.append(d @ head.T)
            dhead += torch.einsum("bcd,bcv->dv", xc, d).float()
        return torch.cat(dx, 1), dhead.to(head.dtype), None


def fused_head_ce(x, head, tokens):
    """Scalar mean next-token CE of x [B, S, D] (post-norm, compute dtype)
    through head [D, V], without materialising the f32 logits for the
    backward."""
    return _FusedHeadCE.apply(x, head, tokens)


def _head_ce(params, x, cfg: LlamaConfig, tokens):
    """Final norm + fused head/CE (the loss-path twin of _final_head)."""
    cd = cfg.dtype
    x = rms_norm_ref(x, params["norm"], cfg.rms_norm_eps)
    return fused_head_ce(x.to(cd), _head_weights(params, cfg).to(cd),
                         tokens)


def loss_fn(params, tokens, cfg: LlamaConfig, mesh=None,
            pp_microbatches: Optional[int] = None, pp_virtual: int = 1):
    """Next-token cross entropy, masked at the final position, f32
    softmax. The mesh and the pipeline schedules are the multi-GPU
    slice and raise."""
    _no_mesh(mesh, "loss_fn")
    if pp_microbatches:
        raise NotImplementedError(
            "pipeline-parallel microbatches are not ported yet: they come "
            "with the multi-GPU slice")
    if cfg.fused_ce:
        return _head_ce(params, _backbone(params, tokens, cfg), cfg, tokens)
    return _mb_loss(forward(params, tokens, cfg), tokens)


# ----------------------------------------------------------------- counts
def num_params(cfg: LlamaConfig) -> int:
    D, F_, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_hidden_layers)
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per_layer = 2 * D + D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F_
    total = V * D + L * per_layer + D
    if not cfg.tie_word_embeddings:
        total += D * V
    return total


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approx. train FLOPs/token (fwd+bwd = 6·matmul params + causal
    attention), the JAX package's count: the embedding gather counts
    nothing, attention visits ~seq/2 keys per query, and the recompute of
    checkpointed layers is not credited."""
    D, F_, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    matmul = L * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F_) \
        + cfg.vocab_size * D
    attn = L * H * hd * seq_len
    return 6.0 * (matmul + attn)

