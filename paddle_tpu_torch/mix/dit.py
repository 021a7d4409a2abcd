"""DiT (Diffusion Transformer) — the BASELINE 'DiT/SD3' workload (config 3).

Port of paddle_tpu/mix/dit.py on one device: `DiTConfig` (`tiny`,
`dit_xl_2`), `init_params`, `params_from_numpy`, `timestep_embedding`,
`patchify`/`unpatchify`, the adaLN-Zero block (`_block`), `forward`,
`diffusion_loss` (and `diffusion_loss_given`, which takes the timesteps,
the noise and the label drop as arguments), `num_params` and
`flops_per_image`. The parameter tree keeps the JAX package's keys and
its stacked [L, ...] block weights, so a tree made there moves here with
`params_from_numpy`. The sharding tables (`param_specs`, `batch_spec`)
are the multi-GPU slice.

Attention is einsum-form and head-major: q/k/v come out of the fused
qkv projection as [B, H, N, hd] and run the non-causal flash kernels in
'bhsd' (`kernels.flash_attention`, head_dim 72 at DiT-XL/2). The norm
and the modulation (`_ln`, `_modulate`) are plain torch, as the JAX
package keeps them plain jnp (dit.py:156-163); the fused adaLN kernel
(`kernels.adaln`) computes the same function and is held at this
model's shapes in `chip_smoke.py`. The block loop is a Python loop over
`unbind` views of the stacked weights (whose backward stacks the
blocks' grads once); `remat` wraps each block in
`torch.utils.checkpoint`, as `jax.checkpoint` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..kernels import flash_attention as fa


@dataclasses.dataclass
class DiTConfig:
    image_size: int = 32            # latent spatial size
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    learn_sigma: bool = True
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @staticmethod
    def tiny(**over) -> "DiTConfig":
        base = dict(image_size=8, patch_size=2, in_channels=4,
                    hidden_size=64, depth=2, num_heads=4, num_classes=10)
        base.update(over)
        return DiTConfig(**base)

    @staticmethod
    def dit_xl_2(**over) -> "DiTConfig":
        base = dict(patch_size=2, hidden_size=1152, depth=28, num_heads=16)
        base.update(over)
        return DiTConfig(**base)


def _shapes(cfg: DiTConfig) -> Dict[str, Any]:
    D, L = cfg.hidden_size, cfg.depth
    F_ = int(D * cfg.mlp_ratio)
    pc = cfg.patch_size * cfg.patch_size * cfg.in_channels
    po = cfg.patch_size * cfg.patch_size * cfg.out_channels
    return {
        "patch_embed_w": (pc, D), "patch_embed_b": (D,),
        "pos_embed": (cfg.n_patches, D),
        "t_mlp1_w": (256, D), "t_mlp1_b": (D,),
        "t_mlp2_w": (D, D), "t_mlp2_b": (D,),
        "label_embed": (cfg.num_classes + 1, D),
        "blocks": {
            "ada_w": (L, D, 6 * D), "ada_b": (L, 6 * D),
            "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
            "proj_w": (L, D, D), "proj_b": (L, D),
            "mlp_in_w": (L, D, F_), "mlp_in_b": (L, F_),
            "mlp_out_w": (L, F_, D), "mlp_out_b": (L, D),
        },
        "final_ada_w": (D, 2 * D), "final_ada_b": (2 * D,),
        "final_w": (D, po), "final_b": (po,),
    }


# drawn N(0, 0.02) at init (JAX: `norm(...)`); every other leaf starts at
# zero: the biases, and the adaLN-Zero `ada_*` / `final_*` weights, so
# each block starts as the identity (the DiT recipe)
_NORMAL = ("patch_embed_w", "pos_embed", "t_mlp1_w", "t_mlp2_w",
           "label_embed", "qkv_w", "proj_w", "mlp_in_w", "mlp_out_w")


def init_params(generator: Optional[torch.Generator], cfg: DiTConfig,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in `cfg.param_dtype` on `device`, the JAX
    `init_params` recipe: N(0, 0.02) for the patch, position, timestep
    and label embeddings and the block matrices, zeros for the biases
    and for `ada_*`/`final_*`. `generator` (on `device`) seeds the draws;
    torch's numbers differ from jax.random's, so parity tests carry a JAX
    tree across with `params_from_numpy` instead."""
    dev = resolve_device(device)

    def make(name, shape):
        t = torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        if name in _NORMAL:
            t.normal_(0.0, 0.02, generator=generator)
        return t

    shapes = _shapes(cfg)
    params = {k: make(k, s) for k, s in shapes.items() if k != "blocks"}
    params["blocks"] = {k: make(k, s) for k, s in shapes["blocks"].items()}
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: DiTConfig,
                      device="cuda") -> Dict[str, Any]:
    """Carry a JAX `init_params` tree (numpy arrays, the same keys,
    stacked [L, ...] blocks) to `device` in `cfg.param_dtype`."""
    dev = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=cfg.param_dtype)

    out = {k: conv(a) for k, a in tree.items() if k != "blocks"}
    out["blocks"] = {k: conv(a) for k, a in tree["blocks"].items()}
    return out


def param_specs(cfg: DiTConfig):
    raise NotImplementedError(
        "dit.param_specs: the TP/FSDP sharding table comes with the "
        "multi-GPU slice (ROADMAP.md Queue 1)")


def batch_spec():
    raise NotImplementedError(
        "dit.batch_spec: data-parallel batch sharding comes with the "
        "multi-GPU slice (ROADMAP.md Queue 1)")


def timestep_embedding(t, dim=256, max_period=10000.0):
    """Sinusoidal embedding of the timesteps t [B] → f32 [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _ln(x):
    """Affine-free LayerNorm in f32 (biased variance, eps 1e-6), cast
    back: plain torch, as the JAX package keeps it plain jnp."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _block(x, c, bp, cfg: DiTConfig):
    dt = cfg.dtype
    B, N, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    mods = c @ bp["ada_w"].to(dt) + bp["ada_b"].to(dt)
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mods, 6, dim=-1)
    h = _modulate(_ln(x), sh_a, sc_a)
    # head-major projections: q/k/v land [B, H, N, hd] and the flash
    # kernels read them through their strides ('bhsd')
    wqkv = bp["qkv_w"].to(dt).reshape(D, 3, H, hd)
    bqkv = bp["qkv_b"].to(dt).reshape(3, H, hd)
    q, k, v = [torch.einsum("bnd,dhe->bhne", h, wqkv[:, i]) +
               bqkv[i][None, :, None, :] for i in range(3)]
    ctx = fa.flash_attention(q, k, v, False, None, "bhsd")
    ctx = torch.einsum("bhne,hed->bnd", ctx,
                       bp["proj_w"].to(dt).reshape(H, hd, D))
    x = x + g_a[:, None] * (ctx + bp["proj_b"].to(dt))
    h = _modulate(_ln(x), sh_m, sc_m)
    h = F.gelu(h @ bp["mlp_in_w"].to(dt) + bp["mlp_in_b"].to(dt),
               approximate="tanh")
    h = h @ bp["mlp_out_w"].to(dt) + bp["mlp_out_b"].to(dt)
    return x + g_m[:, None] * h


def patchify(x, cfg: DiTConfig):
    """[B, C, H, W] → [B, N, p*p*C]."""
    B, C, H, W = x.shape
    p = cfg.patch_size
    x = x.reshape(B, C, H // p, p, W // p, p)
    x = x.permute(0, 2, 4, 3, 5, 1)            # B, H/p, W/p, p, p, C
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(x, cfg: DiTConfig):
    B, N, _ = x.shape
    p, c = cfg.patch_size, cfg.out_channels
    g = int(math.sqrt(N))
    x = x.reshape(B, g, g, p, p, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(B, c, g * p, g * p)


def forward(params, x, t, y, cfg: DiTConfig):
    """x: [B, C, H, W] noisy latents; t: [B] timesteps; y: [B] labels
    (num_classes = the null label) → [B, out_channels, H, W] in the
    compute dtype."""
    dt = cfg.dtype
    h = patchify(x.to(dt), cfg)
    h = h @ params["patch_embed_w"].to(dt) + params["patch_embed_b"].to(dt)
    h = h + params["pos_embed"].to(dt)[None]
    temb = timestep_embedding(t).to(dt)
    temb = F.silu(temb @ params["t_mlp1_w"].to(dt) +
                  params["t_mlp1_b"].to(dt))
    temb = temb @ params["t_mlp2_w"].to(dt) + params["t_mlp2_b"].to(dt)
    c = F.silu(temb + params["label_embed"][y.long()].to(dt))
    names = sorted(params["blocks"])
    views = [params["blocks"][k].unbind(0) for k in names]
    for layer in range(cfg.depth):
        bp = {k: vs[layer] for k, vs in zip(names, views)}
        if cfg.remat:
            h = checkpoint(_block, h, c, bp, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _block(h, c, bp, cfg)
    sh, sc = torch.chunk(c @ params["final_ada_w"].to(dt) +
                         params["final_ada_b"].to(dt), 2, dim=-1)
    h = _modulate(_ln(h), sh, sc)
    h = h @ params["final_w"].to(dt) + params["final_b"].to(dt)
    return unpatchify(h, cfg)


def _alphas_bar(n_timesteps, device):
    betas = torch.linspace(1e-4, 0.02, n_timesteps, dtype=torch.float32,
                           device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def diffusion_loss_given(params, x0, y, t, eps, drop, cfg: DiTConfig,
                         n_timesteps=1000):
    """The DDPM epsilon-prediction MSE with its draws given: t [B] int
    timesteps, eps [B, C, H, W] f32 noise, drop [B] bool (the label
    replaced by the null label). Linear beta schedule; the sigma
    channels (learn_sigma) are left out of the loss, as the reference's
    'simple' loss term."""
    ab = _alphas_bar(n_timesteps, x0.device)[t.long()][:, None, None, None]
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    y = torch.where(drop, torch.full_like(y, cfg.num_classes), y)
    pred = forward(params, xt, t, y, cfg).float()
    return torch.mean((pred[:, :cfg.in_channels] - eps) ** 2)


def draw(gen: torch.Generator, x0, cfg: DiTConfig, n_timesteps=1000):
    """(t, eps, drop) for `diffusion_loss_given`, drawn as the JAX
    package's `diffusion_loss` draws them (uniform timesteps, N(0, 1)
    noise, Bernoulli(class_dropout_prob) label drop) from a seeded
    torch.Generator on x0's device; torch's numbers are not jax.random's."""
    B = x0.shape[0]
    t = torch.randint(0, n_timesteps, (B,), generator=gen,
                      device=x0.device)
    eps = torch.randn(x0.shape, generator=gen, device=x0.device,
                      dtype=torch.float32)
    drop = torch.rand((B,), generator=gen, device=x0.device) \
        < cfg.class_dropout_prob
    return t, eps, drop


def diffusion_loss(params, gen: torch.Generator, x0, y, cfg: DiTConfig,
                   n_timesteps=1000):
    """The DiT training objective (JAX `diffusion_loss`): draws t, the
    noise and the label drop from `gen` (`draw`), then
    `diffusion_loss_given`."""
    t, eps, drop = draw(gen, x0, cfg, n_timesteps)
    return diffusion_loss_given(params, x0, y, t, eps, drop, cfg,
                                n_timesteps)


def num_params(cfg: DiTConfig) -> int:
    """From the shapes alone (no allocation)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return math.prod(tree)
    return count(_shapes(cfg))


def flops_per_image(cfg: DiTConfig) -> float:
    """Approx. train FLOPs per image (fwd+bwd = 6x fwd MACs), the JAX
    package's count: per patch token qkvo + mlp + full attention over
    n_patches, plus the per-block adaLN modulation MLP (6·D per block
    from the conditioning vector) and the patch/final projections."""
    D, T = cfg.hidden_size, cfg.n_patches
    per_tok = 4 * D * D + 2 * D * int(cfg.mlp_ratio * D) + 2 * D * T
    per_block = T * per_tok + D * 6 * D
    pd = cfg.patch_size ** 2 * cfg.in_channels
    patch_io = T * (pd * D + D * pd * (2 if cfg.learn_sigma else 1))
    return 6.0 * (cfg.depth * per_block + patch_io)
