"""Fused adaLN: affine-free LayerNorm + per-sample modulation.

Port of paddle_tpu/kernels/adaln.py: `adaln_ref` (the reference), the
Pallas forward `_adaln_fwd_kernel` and backward `_adaln_bwd_kernel`
(Hopper counterparts in `csrc/adaln.cu`) and the differentiable entry
`adaln_modulate`:

    y = ((x - mu) * rsqrt(var + eps)) * (1 + scale_b) + shift_b

with x [B, N, D] and shift/scale [B, D] per sample, broadcast over the
tokens; the forward saves (mu, rstd) f32 [B, N, 1] and the backward gives
dx and the per-sample dshift/dscale summed over the tokens.

`adaln_fwd` and `adaln_bwd` run the kernel on a CUDA tensor and their
plain versions (`_adaln_fwd_twin`, `_adaln_bwd_plain`) on a CPU tensor;
there is no fallback between the two. `adaln_modulate` is twice
differentiable, as the JAX package's `_adaln_*_diffable` pairs make it:
the backward kernel's own gradient is the vjp of the plain
`_adaln_ref_bwd`, which recomputes the statistics from x.

No path of the JAX package launches these kernels: DiT's norm stays
plain jnp there (mix/dit.py:156-163) and plain torch in the port's
`mix/dit.py`; `chip_smoke.py` holds the kernels at DiT-XL/2's shapes.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import norm_bwd

EPS = 1e-6
# adaln_fwd(x, shift, scale, out, mu, rstd, B, N, D, eps, is_bf16, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# adaln_bwd(x, scale, mu, rstd, dy, dx, dshift, dscale, partials, B, N, D,
#           x_kind, scale_bf16, warps, vpt, blocks, cols, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]
# the widest row the forward's registers hold (12 vectors of 4 a lane)
_MAX_D = 1536


def adaln_ref(x, shift, scale, epsilon: float = EPS):
    """The reference: x [B, N, D]; shift/scale [B, D] → x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xhat = (xf - mu) * torch.rsqrt(var + epsilon)
    out = xhat * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    return out.to(x.dtype)


def _adaln_fwd_twin(x, shift, scale, epsilon: float = EPS):
    """The forward kernel's plain version: (out, mu, rstd), mu/rstd f32
    [B, N, 1]; the variance as the mean of the centred squares."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + epsilon)
    out = (xc * rstd) * (1.0 + scale.float()[:, None]) \
        + shift.float()[:, None]
    return out.to(x.dtype), mu, rstd


def _adaln_bwd_plain(x, scale, mu, rstd, dy):
    """The backward kernel's plain version, from the forward's mu and
    rstd: (dx in x's dtype, dshift f32 [B, D], dscale f32 [B, D])."""
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mu) * rstd
    dyw = dyf * (1.0 + scale.float()[:, None])
    m1 = dyw.mean(-1, keepdim=True)
    m2 = (dyw * xhat).mean(-1, keepdim=True)
    dx = (rstd * (dyw - m1 - xhat * m2)).to(x.dtype)
    return dx, dyf.sum(1), (dyf * xhat).sum(1)


def _adaln_ref_bwd(x, scale, dy, epsilon: float = EPS):
    """The backward from x alone (the statistics recomputed), in torch
    ops: the differentiable twin of the backward kernel."""
    xf, dyf = x.float(), dy.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + epsilon)
    xhat = xc * r
    dyw = dyf * (1.0 + scale.float()[:, None])
    m1 = dyw.mean(-1, keepdim=True)
    m2 = (dyw * xhat).mean(-1, keepdim=True)
    dx = (r * (dyw - m1 - xhat * m2)).to(x.dtype)
    return dx, dyf.sum(1), (dyf * xhat).sum(1)


def _check(x, what):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise TypeError(f"{what}: x must be a contiguous, 16-byte aligned "
                        f"f32 or bf16 CUDA tensor [B, N, D]; got {x.dtype} "
                        f"{list(x.shape)}")
    B, N, D = x.shape
    if D % 4 or D > _MAX_D:
        raise ValueError(f"{what}: D = {D} must be a multiple of 4 and at "
                         f"most {_MAX_D}")
    return B, N, D


def _row_param(t, B, D, device, what, name):
    """shift/scale as the kernel reads them: contiguous f32 [B, D]."""
    if tuple(t.shape) != (B, D) or t.device != device:
        raise ValueError(f"{what}: {name} must be [{B}, {D}] on {device}; "
                         f"got {list(t.shape)} on {t.device}")
    return t.float().contiguous()


def _x_kind(dtype, D):
    """(x_kind, values a vector) of csrc/adaln.cu's backward: f32 rows in
    16-byte vectors of 4; bf16 rows in 16-byte vectors of 8, or, where D %
    8 == 4 leaves rows that are not whole 16-byte multiples, in 8-byte
    vectors of 4."""
    if dtype == torch.float32:
        return 0, 4
    return (1, 8) if D % 8 == 0 else (2, 4)


def adaln_fwd(x, shift, scale, epsilon: float = EPS):
    """(out, mu, rstd) of the fused LN + modulate: x [B, N, D]; shift and
    scale [B, D] → out in x's dtype, mu/rstd f32 [B, N, 1].

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (contiguous f32 or bf16 x, D a multiple of 4 up to 1536); anything
    else raises. Each launch adds one to `adaln_fwd.launches`."""
    if not x.is_cuda:
        return _adaln_fwd_twin(x, shift, scale, epsilon)
    B, N, D = _check(x, "adaln_fwd")
    sh = _row_param(shift, B, D, x.device, "adaln_fwd", "shift")
    sc = _row_param(scale, B, D, x.device, "adaln_fwd", "scale")
    out = torch.empty_like(x)
    mu = torch.empty(B, N, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty(B, N, 1, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, mu, rstd
    fn = _build.function("adaln", "adaln_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), sh.data_ptr(), sc.data_ptr(), out.data_ptr(),
                 mu.data_ptr(), rstd.data_ptr(), B, N, D, float(epsilon),
                 int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "adaln_fwd")
    _build.count(adaln_fwd)
    return out, mu, rstd


adaln_fwd.launches = 0


def adaln_bwd(x, scale, mu, rstd, dy):
    """(dx, dshift, dscale) from the forward's mu and rstd: dx in x's
    dtype, dshift/dscale f32 [B, D] summed over each sample's tokens.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (x and dy contiguous of one dtype, f32 or bf16, D as the forward);
    anything else raises; scale is read as f32 or bf16, any other dtype
    cast to f32. The kernel walks the sample pieces of
    `norm_bwd.adaln_plan` and folds each sample's partial rows in a fixed
    order (no atomics): two runs give the same bits. Each launch adds one
    to `adaln_bwd.launches`."""
    if not x.is_cuda:
        return _adaln_bwd_plain(x, scale, mu, rstd, dy)
    B, N, D = _check(x, "adaln_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise TypeError("adaln_bwd: dy must be a contiguous, 16-byte "
                        "aligned tensor of x's shape and dtype")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.shape != (B, N, 1) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise TypeError(f"adaln_bwd: {name} must be a contiguous f32 "
                            f"[{B}, {N}, 1] on {x.device}")
    if scale.dtype == torch.bfloat16 and tuple(scale.shape) == (B, D) \
            and scale.device == x.device:
        sc = scale.contiguous()
    else:
        sc = _row_param(scale, B, D, x.device, "adaln_bwd", "scale")
    dx = torch.empty_like(x)
    dsh = torch.empty(B, D, dtype=torch.float32, device=x.device)
    dsc = torch.empty(B, D, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dsh.zero_(), dsc.zero_()
    kind, vec = _x_kind(x.dtype, D)
    plan = norm_bwd.device_adaln_plan(x.device, B, N, D, vec, kind)
    partials = torch.empty(plan.blocks + B, 2, D, dtype=torch.float32,
                           device=x.device)
    fn = _build.function("adaln", "adaln_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), sc.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dsh.data_ptr(),
                 dsc.data_ptr(), partials.data_ptr(), B, N, D, kind,
                 int(sc.dtype == torch.bfloat16), plan.warps, plan.vpt,
                 plan.blocks, plan.fold_cols, stream)
    _build.check(err, "adaln_bwd")
    _build.count(adaln_bwd)
    return dx, dsh, dsc


adaln_bwd.launches = 0


class _AdaLNBwd(torch.autograd.Function):
    """The backward kernel as a differentiable function of (x, scale,
    dy): its own backward is the vjp of `_adaln_ref_bwd` (the JAX
    `_adaln_bwd_diffable`); mu and rstd get no gradient, since the twin
    recomputes them from x."""

    @staticmethod
    def forward(ctx, x, scale, mu, rstd, dy, epsilon):
        ctx.save_for_backward(x, scale, dy)
        ctx.epsilon = epsilon
        return adaln_bwd(x, scale, mu, rstd, dy)

    @staticmethod
    def backward(ctx, gdx, gdsh, gdsc):
        x, scale, dy = ctx.saved_tensors
        with torch.enable_grad():
            xs, scs, dys = (t.detach().requires_grad_(True)
                            for t in (x, scale, dy))
            outs = _adaln_ref_bwd(xs, scs, dys, ctx.epsilon)
            gx, gsc, gdy = torch.autograd.grad(
                outs, (xs, scs, dys), (gdx, gdsh, gdsc),
                create_graph=torch.is_grad_enabled(), allow_unused=True)
        return gx, gsc, None, None, gdy, None


class _AdaLN(torch.autograd.Function):
    """The JAX `custom_vjp` `adaln_modulate`: the forward kernel, saving
    (x, shift, scale, mu, rstd); the backward kernel through `_AdaLNBwd`,
    so the gradient is itself differentiable."""

    @staticmethod
    def forward(ctx, x, shift, scale, epsilon):
        out, mu, rstd = adaln_fwd(x, shift, scale, epsilon)
        ctx.save_for_backward(x, shift, scale, mu, rstd)
        ctx.epsilon = epsilon
        return out

    @staticmethod
    def backward(ctx, dy):
        x, shift, scale, mu, rstd = ctx.saved_tensors
        dx, dsh, dsc = _AdaLNBwd.apply(x, scale, mu, rstd,
                                       dy.contiguous(), ctx.epsilon)
        return dx, dsh.to(shift.dtype), dsc.to(scale.dtype), None


def adaln_modulate(x, shift, scale, epsilon: float = EPS):
    """Fused LN + modulate, differentiable (twice): x [B, N, D];
    shift/scale [B, D] per sample → x's shape and dtype. The kernels on
    the card, their plain versions on the CPU; equal to `adaln_ref` in
    value."""
    return _AdaLN.apply(x, shift, scale, epsilon)
