"""Blockwise-quantized Adam state: 8-bit moments, and the fused AdamW.

Port of paddle_tpu/optimizer/quant_state.py. The moments are stored as
float8_e4m3 codes with one f32 scale per 256-value block (m directly, v
in sqrt-space), about 2 bytes of state per parameter instead of 8.

The update is the JAX package's single-device form,
`adamw_q_fused(...).apply_fused(grads, state, params, grad_norm)`: one
pass per leaf that reads g, p and both moments and writes p and the
moments in place. On a CUDA tensor it is the kernel of `csrc/adamw_q.cu` (the
counterpart of `_fused_adamw_kernel`); on a CPU tensor its plain version
`fused_leaf_update_ref`. Its codes are x · (448 / amax), the kernel's
arithmetic form.

The unfused chain `adamw_q(...)` = `scale_by_adam_q` → optax-style
`add_decayed_weights` → `scale_by_learning_rate` (`transform.chain`) is
the JAX package's too, in plain torch ops as it is plain jnp there:
bench.py's DiT step (`tools/dit_train.py`) uses it. It streams each leaf
through chunks of `CHUNK_BLOCKS` blocks, as JAX's `lax.map` does, so no
full-leaf f32 moment is built; its codes are x / (amax / 448), JAX's
`_q_blocks`.

The four step scalars [gscale, lr, bc1, bc2] stay on the device as an
f32[4] tensor, as the TPU kernel reads them from SMEM, so a step never
waits for the card. The global norm of the streamed clip is plain torch
on the device, as it is XLA in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional

import torch

from .. import _build
from . import transform
from .transform import tree_leaves

BLOCK = 256
# blocks per chunk of the unfused update: 65536 · 256 = 16M values, ~4 f32
# transients of that size at a time (JAX's lax.map chunk)
CHUNK_BLOCKS = 65536
F8 = torch.float8_e4m3fn
# e4m3's largest finite value: block maxima are normalised to it
F8_MAX = 448.0
# adamw_q_fused_{bf16,f16,f32}(g, p, mc, ms, vc, vs, scalars, n, nb, b1,
#                              1-b1, b2, 1-b2, eps, wd, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_long] * 2 + [
    ctypes.c_float] * 6 + [ctypes.c_void_p]


class _QTensor(NamedTuple):
    """Blockwise-quantized tensor: float8_e4m3 codes [nb, BLOCK] + f32
    scale [nb, 1] (x ≈ codes * scale). The second moment is stored in
    sqrt-space."""
    codes: torch.Tensor
    scale: torch.Tensor


def _q_blocks(blocks, sqrt_space: bool) -> _QTensor:
    """blocks [c, BLOCK] f32 → f8 codes + per-block scale."""
    if sqrt_space:
        blocks = torch.sqrt(blocks)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / F8_MAX
    return _QTensor((blocks / scale).to(F8), scale)


def _dq_blocks(q: _QTensor, sqrt_space: bool):
    blocks = q.codes.float() * q.scale
    return blocks * blocks if sqrt_space else blocks


def _dequantize(q: _QTensor, shape, sqrt_space: bool):
    n = 1
    for s in shape:
        n *= s
    return _dq_blocks(q, sqrt_space).reshape(-1)[:n].reshape(shape)


def _blocks(x, nb: int):
    """x flattened, zero-padded to nb blocks, as f32 [nb, BLOCK]."""
    flat = x.reshape(-1).float()
    pad = nb * BLOCK - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.view(nb, BLOCK)


def _quantize(x, sqrt_space: bool) -> _QTensor:
    flat = x.reshape(-1)
    return _q_blocks(_blocks(flat, (flat.numel() + BLOCK - 1) // BLOCK),
                     sqrt_space)


def _global_norm_scale(grad_norm, clip_norm):
    """Streamed ClipGradByGlobalNorm factor min(1, clip / (norm + 1e-6))
    of the pre-clip global norm (an f32 device tensor)."""
    return torch.clamp(clip_norm / (grad_norm + 1e-6), max=1.0)


def _grads_scale(grads, clip_norm):
    """The factor of the unfused update's streamed clip: 1 without a
    clip, else from the f32 global norm of `grads` (JAX's
    `_global_norm_scale`, the squares summed leaf by leaf)."""
    dev = tree_leaves(grads)[0].device
    if clip_norm is None:
        return torch.ones((), dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.clamp(clip_norm / (torch.sqrt(total) + 1e-6), max=1.0)


class ScaleByAdamQState(NamedTuple):
    count: torch.Tensor
    m: Any   # tree of _QTensor
    v: Any   # tree of _QTensor


def _zero_q(p) -> _QTensor:
    nb = (p.numel() + BLOCK - 1) // BLOCK
    return _QTensor(torch.zeros(nb, BLOCK, dtype=F8, device=p.device),
                    torch.full((nb, 1), 1e-30 / F8_MAX, dtype=torch.float32,
                               device=p.device))


def _is_q(x) -> bool:
    return isinstance(x, _QTensor)


def _map_q(fn, tree, *rest):
    """tree_map that treats each _QTensor as one leaf."""
    if _is_q(tree) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_q(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return type(tree)(_map_q(fn, t, *(r[i] for r in rest))
                      for i, t in enumerate(tree))


def _bias_corrections(count, b1, b2):
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=cf.device), cf)
    return bc1, bc2


def _zero_state(params):
    # zero state needs no data-dependent quantization
    return ScaleByAdamQState(
        torch.zeros((), dtype=torch.int32,
                    device=tree_leaves(params)[0].device),
        _map_q(_zero_q, params), _map_q(_zero_q, params))


# ---------------------------------------------------------------- unfused
def scale_by_adam_q(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    clip_norm: Optional[float] = None
                    ) -> transform.GradientTransformation:
    """optax's scale_by_adam with 8-bit blockwise state (f8 codes and
    block scales, v in sqrt-space), JAX's `scale_by_adam_q`: per leaf,
    in chunks of `CHUNK_BLOCKS` blocks, the gradient (times the streamed
    clip's factor when `clip_norm` is set: min(1, clip / (norm + 1e-6)))
    updates the dequantized moments, which are quantized again; the
    update m̂ / (sqrt(v̂) + eps) leaves in the gradient's dtype. The new
    moments are new tensors, as JAX's."""

    def update(grads, state, params=None):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, b1, b2)
        gscale = _grads_scale(grads, clip_norm)

        def blockwise(gb, mq, vq):
            g = gb.float() * gscale
            m = b1 * _dq_blocks(mq, False) + (1 - b1) * g
            v = b2 * _dq_blocks(vq, True) + (1 - b2) * g * g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            out_dt = gb.dtype if gb.dtype != torch.float64 else torch.float32
            return upd.to(out_dt), _q_blocks(m, False), _q_blocks(v, True)

        def leaf(g, mq, vq):
            nb = mq.codes.shape[0]
            flat = g.reshape(-1)
            if nb * BLOCK != flat.numel():
                flat = torch.nn.functional.pad(
                    flat, (0, nb * BLOCK - flat.numel()))
            gb = flat.view(nb, BLOCK)
            outs = [blockwise(gb[i:i + CHUNK_BLOCKS],
                              _QTensor(mq.codes[i:i + CHUNK_BLOCKS],
                                       mq.scale[i:i + CHUNK_BLOCKS]),
                              _QTensor(vq.codes[i:i + CHUNK_BLOCKS],
                                       vq.scale[i:i + CHUNK_BLOCKS]))
                    for i in range(0, nb, CHUNK_BLOCKS)]
            if len(outs) == 1:
                upd, nm, nv = outs[0]
            else:
                upd = torch.cat([o[0] for o in outs])
                nm, nv = (_QTensor(torch.cat([o[j].codes for o in outs]),
                                   torch.cat([o[j].scale for o in outs]))
                          for j in (1, 2))
            upd = upd.reshape(-1)[:g.numel()].view(g.shape).to(g.dtype)
            return upd, nm, nv

        out = _map_q(leaf, grads, state.m, state.v)
        pick = (lambda j: _map_q(lambda _, o: o[j], grads, out))
        return pick(0), ScaleByAdamQState(count, pick(1), pick(2))

    return transform.GradientTransformation(_zero_state, update)


def adamw_q(learning_rate, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8, weight_decay: float = 0.0,
            clip_norm: Optional[float] = None
            ) -> transform.GradientTransformation:
    """AdamW with 8-bit moments, JAX's `adamw_q`: `scale_by_adam_q`
    (with the streamed clip), `add_decayed_weights`,
    `scale_by_learning_rate`, chained."""
    return transform.chain(
        scale_by_adam_q(b1, b2, eps, clip_norm=clip_norm),
        transform.add_decayed_weights(weight_decay),
        transform.scale_by_learning_rate(learning_rate))


# ------------------------------------------------------------------ fused
def fused_leaf_update_ref(scalars, g, p, mq: _QTensor, vq: _QTensor, *,
                          b1, b2, eps, wd):
    """The fused kernel's plain version, in place: p and the moments'
    codes and scales are overwritten. Same arithmetic form as the
    kernel (`_fused_adamw_kernel`): codes m·(448/amax) and
    sqrt(v)·(448/amax), amax floored at 1e-30; the tail of a leaf that
    is not a multiple of BLOCK is padded with zeros."""
    gscale, lr, bc1, bc2 = scalars[0], scalars[1], scalars[2], scalars[3]
    nb = mq.codes.shape[0]
    inv_bc1 = 1.0 / bc1
    rs_bc2 = torch.rsqrt(bc2)
    gf = _blocks(g, nb) * gscale
    m = b1 * (mq.codes.float() * mq.scale) + (1 - b1) * gf
    sv = vq.codes.float() * vq.scale
    v = b2 * sv * sv + (1 - b2) * gf * gf
    sq = torch.sqrt(v)
    upd = (m * inv_bc1) / (sq * rs_bc2 + eps)
    pn = _blocks(p, nb) * (1.0 - lr * wd) - lr * upd
    with torch.no_grad():
        p.copy_(pn.reshape(-1)[:p.numel()].view(p.shape).to(p.dtype))
        for q, x in ((mq, m), (vq, sq)):
            amax = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-30)
            q.codes.copy_((x * (F8_MAX / amax)).to(F8))
            q.scale.copy_(amax * (1.0 / F8_MAX))
    return p, mq, vq


def fused_leaf_update(scalars, g, p, mq: _QTensor, vq: _QTensor, *,
                      b1, b2, eps, wd):
    """One leaf of the fused AdamW-8bit, in place (p, mq, vq are
    overwritten and returned). `scalars` is the device f32[4]
    [gscale, lr, bc1, bc2].

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel (p
    bf16, f16 or f32 and g in p's dtype, both contiguous; codes
    float8_e4m3fn [nb, 256], scales f32 [nb, 1]); anything else raises.
    Each launch adds one to `fused_leaf_update.launches` and to its
    dtype's `launches_bf16`, `launches_f16` or `launches_f32`."""
    if not p.is_cuda:
        return fused_leaf_update_ref(scalars, g, p, mq, vq, b1=b1, b2=b2,
                                     eps=eps, wd=wd)
    n = p.numel()
    nb = (n + BLOCK - 1) // BLOCK
    # the TPU kernel computes in the leaf's dtype: bf16, f16 or f32
    tag = _build.DTYPE_TAGS.get(str(p.dtype))
    if tag is None:
        raise TypeError(f"fused_leaf_update: a {p.dtype} leaf; the kernel "
                        f"takes bf16, f16 and f32")
    for name, t in (("g", g), ("p", p)):
        if t.dtype != p.dtype or not t.is_contiguous() \
                or t.device != p.device or t.data_ptr() % 16 \
                or t.numel() != n:
            raise TypeError(f"fused_leaf_update: {name} must be a "
                            f"contiguous, 16-byte aligned {p.dtype} tensor "
                            f"of {n} values on {p.device}; got {t.dtype}")
    for q in (mq, vq):
        if q.codes.shape != (nb, BLOCK) or q.codes.dtype != F8 \
                or q.scale.shape != (nb, 1) \
                or q.scale.dtype != torch.float32 \
                or not q.codes.is_contiguous() \
                or not q.scale.is_contiguous() \
                or q.codes.device != p.device:
            raise TypeError(f"fused_leaf_update: moments must be f8 codes "
                            f"[{nb}, {BLOCK}] and f32 scales [{nb}, 1]")
    if scalars.shape != (4,) or scalars.dtype != torch.float32 \
            or scalars.device != p.device:
        raise TypeError("fused_leaf_update: scalars must be f32[4] on the "
                        "params' device")
    if n == 0:
        return p, mq, vq
    sym = f"adamw_q_fused_{tag}"
    fn = _build.function("adamw_q", sym, _ARGTYPES)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), p.data_ptr(), mq.codes.data_ptr(),
                 mq.scale.data_ptr(), vq.codes.data_ptr(),
                 vq.scale.data_ptr(), scalars.data_ptr(), n, nb,
                 float(b1), float(1 - b1), float(b2), float(1 - b2),
                 float(eps), float(wd), stream)
    _build.check(err, sym)
    _build.count_dtype(fused_leaf_update, p.dtype)
    return p, mq, vq


fused_leaf_update.launches = 0
fused_leaf_update.launches_bf16 = 0
fused_leaf_update.launches_f16 = 0
fused_leaf_update.launches_f32 = 0


class FusedTransformation(NamedTuple):
    """`init(params) -> state` and `apply_fused(grads, state, params,
    grad_norm)`, which updates params and state in place and returns
    them; `grad_norm` is the pre-clip global norm of `grads` (the step
    computes it once, for its metrics and for the clip)."""
    init: Any
    apply_fused: Any


def adamw_q_fused(learning_rate, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, weight_decay: float = 0.0,
                  clip_norm: Optional[float] = None) -> FusedTransformation:
    """Single-transform AdamW-8bit: the state is one ScaleByAdamQState;
    `apply_fused` runs the one-pass update per leaf. `learning_rate` may
    be a float or a schedule of the step count."""
    sched = (learning_rate if callable(learning_rate)
             else (lambda _: learning_rate))

    def apply_fused(grads, state, params, grad_norm):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, b1, b2)
        dev = count.device
        lr = torch.as_tensor(sched(state.count), dtype=torch.float32,
                             device=dev)
        gscale = (torch.ones((), dtype=torch.float32, device=dev)
                  if clip_norm is None
                  else _global_norm_scale(grad_norm, clip_norm))
        scalars = torch.stack([gscale, lr, bc1, bc2]).float()
        _map_q(lambda g, p, mq, vq: fused_leaf_update(
            scalars, g, p, mq, vq, b1=b1, b2=b2, eps=eps, wd=weight_decay),
            grads, params, state.m, state.v)
        return params, ScaleByAdamQState(count, state.m, state.v)

    return FusedTransformation(_zero_state, apply_fused)
