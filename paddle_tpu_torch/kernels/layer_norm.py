"""LayerNorm: plain PyTorch versions + the fused-backward CUDA kernels.

Port of paddle_tpu/kernels/layer_norm.py. `layer_norm_ref` is the plain
norm; `layer_norm_train` is the differentiable norm of the fused layers
(the `custom_vjp` of the JAX package): its forward runs `layer_norm_fwd`
and saves (x, weight, mu, rstd), its backward runs `layer_norm_bwd`. On a
CUDA tensor those two wrappers launch the kernels of
`csrc/layer_norm.cu` (the counterparts of `_ln_fwd_pallas` and
`_ln_bwd_pallas`); on a CPU tensor they run their plain twins
(`_ln_fwd_twin`, `_ln_ref_bwd`), the same f32 expressions. The backward
is itself differentiable: its second-order rule is the vjp of the plain
twin `_ln_ref_bwd`, which recomputes mu and r from x (so their
cotangents are zero), as the JAX package's `_ln_bwd_diffable` does.

Formulas (x̂ = (x − μ)·r, out = x̂·w + b, r = rsqrt(mean((x − μ)²) + eps)),
per row, dyw = dy·w:
    dx = r·(dyw − mean(dyw) − x̂·mean(dyw·x̂))
    dw = Σ_rows dy ⊙ x̂ ;  db = Σ_rows dy
Affine-free (weight and bias None) is the w = 1, no dw/db case.

The kernels take f32, bf16 or f16 x (the TPU kernels compute in their
input's dtype) and read the weight and bias as f32, or, with f16 x and
an f16 pair (O2's form), as f16 in the kernel; each wrapper also counts
its launches by dtype (`launches_f32`, `launches_bf16`,
`launches_f16`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import norm_bwd

# ln_fwd_<dt>(x, w, b, out, mu, rstd, rows, D, eps, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_void_p]
# ln_bwd_<dt>(x, w, mu, rstd, dy, dx, dw, db, partials, rows, D, warps,
#             vpt, blocks, fold_cols, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
# the f16 entries take an int w_f16 before the stream
_F16_ARGTYPES = {"fwd": _FWD_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p],
                 "bwd": _BWD_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]}
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.float16: "f16"}
# ln_bwd_resident's x_kind
# (3: f16 x with an f16 weight)
_X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def layer_norm_ref(x, weight=None, bias=None, epsilon: float = 1e-5):
    """Accumulates in f32 and casts back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _ln_fwd_twin(x, weight, bias, epsilon, affine):
    """Plain version of the forward kernel: (out in x's dtype, mu and
    rstd f32 [rows, 1])."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + epsilon)
    out = xc * rstd
    if affine:
        out = out * weight.float() + bias.float()
    return out.to(x.dtype), mu.reshape(-1, 1), rstd.reshape(-1, 1)


def _ln_ref_bwd(x, weight, dy, eps, affine):
    """Plain version of the backward kernel: (dx in x's dtype, dw f32,
    db f32). Recomputes mu and r from x, so it is differentiable in x,
    weight and dy."""
    xf, dyf = x.float(), dy.float()
    d = x.shape[-1]
    mu = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mu
    r = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    xhat = xc * r
    dyw = dyf * weight.float() if affine else dyf
    m1 = torch.mean(dyw, dim=-1, keepdim=True)
    m2 = torch.mean(dyw * xhat, dim=-1, keepdim=True)
    dx = (r * (dyw - m1 - xhat * m2)).to(x.dtype)
    dw = torch.sum((dyf * xhat).reshape(-1, d), dim=0)
    db = torch.sum(dyf.reshape(-1, d), dim=0)
    return dx, dw, db


def _check_rows(x, what):
    d = x.shape[-1]
    if x.dtype not in _KERNEL_DTYPES or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise TypeError(f"{what}: x must be a contiguous, 16-byte aligned "
                        f"f32, bf16 or f16 CUDA tensor, got {x.dtype}")
    if d % 8 or d > 8192:
        raise ValueError(f"{what}: hidden size {d} must be a multiple of 8 "
                         f"and at most 8192")
    return d


def _check_dy(x, dy, what):
    """dy as the backward kernel reads it: x's shape and dtype, contiguous
    and 16-byte aligned (a contiguous view may start at any element)."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} {dy.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        raise TypeError(f"{what}: dy must be 16-byte aligned")
    return dy


def _param(t, d, device, what, f16=False):
    """A weight or bias as the kernels read it: contiguous, 16-byte
    aligned f32 [D] (an f32 parameter as it is), or with `f16` the f16
    parameter as it is."""
    if t is None:
        return None
    if tuple(t.shape) != (d,) or t.device != device:
        raise ValueError(f"{what}: parameter {tuple(t.shape)} does not "
                         f"match hidden size {d} on {device}")
    t = (t if f16 else t.float()).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _f16_params(x, *params):
    """Whether the kernels read the parameters as f16: f16 x with every
    given parameter f16 (the O2 form)."""
    return x.dtype == torch.float16 and all(
        p is None or p.dtype == torch.float16 for p in params) and \
        any(p is not None for p in params)


def _function(x, which, w16):
    """The C entry point for x's dtype and the extra (w_f16,) argument
    the f16 entry points take."""
    dt = _KERNEL_DTYPES[x.dtype]
    if dt != "f16":
        return _build.function("layer_norm", f"ln_{which}_{dt}",
                               _FWD_ARGTYPES if which == "fwd"
                               else _BWD_ARGTYPES), ()
    return _build.function("layer_norm", f"ln_{which}_f16",
                           _F16_ARGTYPES[which]), (int(w16),)


def layer_norm_fwd(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm forward saving its statistics: (out like x, mu and rstd
    f32 [rows, 1]). weight and bias are both given (affine) or both None.
    On a CPU tensor: the plain twin. On a CUDA tensor: the kernel (f32,
    bf16 or f16 x, hidden size a multiple of 8 up to 8192; weight and bias
    read as f32, or as f16 where x and both are f16); anything else
    raises. Each launch adds one to
    `layer_norm_fwd.launches` and to its x dtype's count."""
    affine = weight is not None
    if not x.is_cuda:
        return _ln_fwd_twin(x, weight, bias, epsilon, affine)
    d = _check_rows(x, "layer_norm_fwd")
    if affine != (bias is not None):
        raise ValueError("layer_norm_fwd: weight and bias go together")
    w16 = _f16_params(x, weight, bias)
    w = _param(weight, d, x.device, "layer_norm_fwd", w16)
    b = _param(bias, d, x.device, "layer_norm_fwd", w16)
    rows = x.numel() // d
    out = torch.empty_like(x)
    mu = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    if rows == 0:
        return out, mu, rstd
    fn, extra = _function(x, "fwd", w16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr() if affine else None,
                 b.data_ptr() if affine else None, out.data_ptr(),
                 mu.data_ptr(), rstd.data_ptr(), rows, d, float(epsilon),
                 *extra, stream)
    _build.check(err, "ln_fwd")
    _build.count_dtype(layer_norm_fwd, x.dtype)
    return out, mu, rstd


layer_norm_fwd.launches = 0
layer_norm_fwd.launches_f32 = 0
layer_norm_fwd.launches_bf16 = 0
layer_norm_fwd.launches_f16 = 0


def layer_norm_bwd(x, weight, mu, rstd, dy, epsilon: float = 1e-5):
    """LayerNorm backward: (dx like x, dw f32 [D], db f32 [D]); weight
    None is the affine-free form (w = 1). On a CPU tensor: the plain twin,
    which recomputes mu and r from x. On a CUDA tensor: the kernel, which
    reads the forward's `mu` and `rstd`; dw and db are summed in the
    fixed order of `norm_bwd.bwd_plan` (no float atomics), so two runs
    give identical bits. Each launch adds one to `layer_norm_bwd.launches`
    and to its x dtype's count."""
    affine = weight is not None
    if not x.is_cuda:
        return _ln_ref_bwd(x, weight, dy, epsilon, affine)
    d = _check_rows(x, "layer_norm_bwd")
    dy = _check_dy(x, dy, "layer_norm_bwd")
    rows = x.numel() // d
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.numel() != rows or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"layer_norm_bwd: {name} must be f32 with "
                             f"{rows} rows on {x.device}")
    mu, rstd = mu.contiguous(), rstd.contiguous()
    w16 = _f16_params(x, weight)
    w = _param(weight, d, x.device, "layer_norm_bwd", w16)
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, *torch.zeros(2, d, dtype=torch.float32, device=x.device)
    plan = norm_bwd.device_plan(x.device, "layer_norm", "ln_bwd_resident",
                                3 if w16 else _X_KIND[x.dtype], rows, d,
                                16 // x.element_size(), 2)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty(d, dtype=torch.float32, device=x.device)
    partials = torch.empty(plan.blocks, 2, d, dtype=torch.float32,
                           device=x.device)
    fn, extra = _function(x, "bwd", w16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr() if affine else None,
                 mu.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 partials.data_ptr(), rows, d, plan.warps, plan.vpt,
                 plan.blocks, plan.fold_cols, *extra, stream)
    _build.check(err, "ln_bwd")
    _build.count_dtype(layer_norm_bwd, x.dtype)
    return dx, dw, db


layer_norm_bwd.launches = 0
layer_norm_bwd.launches_f32 = 0
layer_norm_bwd.launches_bf16 = 0
layer_norm_bwd.launches_f16 = 0


class _LnBwd(torch.autograd.Function):
    """`layer_norm_bwd` made differentiable (the JAX package's
    `_ln_bwd_diffable`): the first-order backward is the kernel on the
    card; the rule for grad-of-grad is the vjp of the plain twin."""

    @staticmethod
    def forward(ctx, x, weight, mu, rstd, dy, eps):
        ctx.save_for_backward(x, weight, dy)
        ctx.eps = eps
        return layer_norm_bwd(x, weight, mu, rstd, dy, eps)

    @staticmethod
    def backward(ctx, ddx, ddw, ddb):
        x, weight, dy = ctx.saved_tensors
        affine = weight is not None
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (x, weight, dy) if t is not None]
            xg, dyg = ins[0], ins[-1]
            wg = ins[1] if affine else None
            outs = _ln_ref_bwd(xg, wg, dyg, ctx.eps, affine)
            grads = torch.autograd.grad(
                outs, ins, (ddx, ddw, ddb), allow_unused=True,
                create_graph=torch.is_grad_enabled())
        gx, gdy = grads[0], grads[-1]
        gw = grads[1] if affine else None
        return gx, gw, None, None, gdy, None


class _LnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        out, mu, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mu, rstd)
        ctx.eps = eps
        ctx.dtypes = (None if weight is None else weight.dtype,
                      None if bias is None else bias.dtype)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, mu, rstd = ctx.saved_tensors
        dx, dw, db = _LnBwd.apply(x, weight, mu, rstd, dy.contiguous(),
                                  ctx.eps)
        if weight is None:
            return dx, None, None, None
        return dx, dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None


def layer_norm_train(x, weight, bias, epsilon: float = 1e-5):
    """Differentiable last-axis LayerNorm of the fused layers: equal in
    value to `layer_norm_ref(x, weight, bias, epsilon)`; weight and bias
    may both be None (affine-free). Forward and backward are the two
    kernels on the card, their plain twins on the CPU."""
    return _LnTrain.apply(x.contiguous(), weight, bias, epsilon)
