"""RMSNorm: plain PyTorch versions + three CUDA kernels.

Port of paddle_tpu/kernels/rms_norm.py. `rms_norm_ref` is the plain form
the serving path and the final norm use. `rms_norm_fused` is the
counterpart of `rms_norm_pallas` (row 6 of PERF.md's kernel table): one
pass, no statistics, f32, bf16 or f16 x (its launches also counted by
dtype: `launches_f32`, `launches_bf16`, `launches_f16`); `rms_norm` is the JAX package's
dispatch over it, and `rms_norm_fused_train` the differentiable norm of
the eager API's `incubate.nn.functional.fused_rms_norm`, whose backward
is the plain version's vjp in torch ops (`_rms_train_ref_bwd`): the JAX
package has no backward kernel for row 6 either; its eager tape
differentiates the function. `rms_norm_train` is the
differentiable norm of the training stack (the `custom_vjp` of the JAX
package): its forward runs `rms_norm_fwd` and saves the per-row
reciprocal RMS, its backward runs `rms_norm_bwd`. On a CUDA tensor those
two wrappers launch the kernels of `csrc/rms_norm.cu` (the counterparts
of `_rms_fwd_pallas` and `_rms_bwd_pallas`, in bf16, f16 or f32 x, out
and dx in x's dtype as the JAX kernels write them; launches also
counted by x's dtype); on a CPU tensor they run their plain twins
(`_rms_fwd_twin`, `_rms_train_ref_bwd`). The CPU
backward is written in differentiable torch ops that recompute r from x,
so grad-of-grad works there, as the JAX package's jnp twins allow.

Formulas (out = x·r·w, r = rsqrt(mean(x²) + eps)), per row:
    dx = r·(w⊙dy) − x·(r³/D)·Σ_j dy_j w_j x_j
    dw = Σ_rows dy ⊙ x ⊙ r
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import norm_bwd

# rms_fwd_<dt>(x, w, out, rstd, rows, D, eps, w_x, stream); w_x: the
# weight is in x's dtype (else f32)
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# rms_bwd_<dt>(x, w, rstd, dy, dx, dw, partials, rows, D, w_x, warps,
#              vpt, blocks, fold_cols, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]
# rms_fused_<dt>(x, w, out, rows, D, eps, w_x, stream); w null: no weight
_FUSED_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# the x dtypes of the three kernels, by their entry points' suffix
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
# csrc/rms_norm.cu::rms_bwd_resident's kinds: (x dtype, weight in x's
# dtype) -> kind
_BWD_KINDS = {(torch.float32, True): 0, (torch.bfloat16, False): 1,
              (torch.bfloat16, True): 2, (torch.float16, False): 3,
              (torch.float16, True): 4}


def rms_norm_ref(x, weight=None, epsilon: float = 1e-6):
    """Accumulates in f32 for bf16 inputs and casts back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(dt)


def _rms_fwd_twin(x, weight, epsilon):
    """Plain version of the forward kernel: (out in x's dtype, rstd f32
    [rows, 1])."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + epsilon)
    out = (xf * rstd * weight.float()).to(x.dtype)
    return out, rstd.reshape(-1, 1)


def _rms_train_ref_bwd(x, weight, dy, epsilon):
    """Plain version of the backward kernel, and the vjp of
    `rms_norm_ref`: (dx in x's dtype, dw in weight's dtype, or None
    without a weight). Recomputes r from x, so it is differentiable in x,
    weight and dy."""
    xf, dyf = x.float(), dy.float()
    d = x.shape[-1]
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + epsilon)
    dyw = dyf if weight is None else dyf * weight.float()
    s = torch.sum(dyw * xf, dim=-1, keepdim=True)
    dx = (r * dyw - xf * (r * r * r / d) * s).to(x.dtype)
    if weight is None:
        return dx, None
    dw = torch.sum((dyf * xf * r).reshape(-1, d), dim=0).to(weight.dtype)
    return dx, dw


def _check_rows(x, weight, what):
    d = x.shape[-1]
    if x.dtype not in _DTYPES or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise TypeError(f"{what}: x must be a contiguous, 16-byte aligned "
                        f"bf16, f16 or f32 CUDA tensor, got {x.dtype}")
    if d % 8 or d > 8192:
        raise ValueError(f"{what}: hidden size {d} must be a multiple of 8 "
                         f"and at most 8192")
    if weight is not None and (weight.shape != (d,)
                               or weight.device != x.device):
        raise ValueError(f"{what}: weight {tuple(weight.shape)} does not "
                         f"match hidden size {d} on {x.device}")


def _kernel_weight(weight, x):
    """The weight as the kernels read it: in x's dtype or f32 as it is,
    any other dtype cast to f32; contiguous and 16-byte aligned."""
    w = weight if weight.dtype in (x.dtype, torch.float32) \
        else weight.float()
    if not w.is_contiguous() or w.data_ptr() % 16:
        w = w.clone(memory_format=torch.contiguous_format)
    return w


def _fused_weight(weight, x):
    """The weight as row 6 reads it: `_kernel_weight`'s, or None for the
    affine-free form (the kernel then reads and applies none)."""
    return None if weight is None else _kernel_weight(weight, x)


def rms_norm_fwd(x, weight, epsilon: float = 1e-6):
    """RMSNorm forward saving the reciprocal RMS: (out like x, rstd f32
    [rows, 1]). On a CPU tensor: the plain twin. On a CUDA tensor: the
    kernel (bf16, f16 or f32 x, hidden size a multiple of 8 up to 8192; a
    weight in x's dtype or f32 is read as it is, in the kernel, any other
    dtype cast to f32 first); anything else raises. Each launch adds one
    to `rms_norm_fwd.launches` and to its x dtype's count."""
    if not x.is_cuda:
        return _rms_fwd_twin(x, weight, epsilon)
    _check_rows(x, weight, "rms_norm_fwd")
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    rstd = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    if rows == 0:
        return out, rstd
    w = _kernel_weight(weight, x)
    sym = f"rms_fwd_{_DTYPES[x.dtype]}"
    fn = _build.function("rms_norm", sym, _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 rstd.data_ptr(), rows, d, float(epsilon),
                 int(w.dtype == x.dtype), stream)
    _build.check(err, sym)
    _build.count_dtype(rms_norm_fwd, x.dtype)
    return out, rstd


rms_norm_fwd.launches = 0
rms_norm_fwd.launches_f32 = 0
rms_norm_fwd.launches_bf16 = 0
rms_norm_fwd.launches_f16 = 0


def rms_norm_bwd(x, weight, rstd, dy, epsilon: float = 1e-6):
    """RMSNorm backward: (dx like x, dw in weight's dtype). On a CPU
    tensor: the plain twin, which recomputes r from x (differentiable).
    On a CUDA tensor: the kernel (bf16, f16 or f32 x and dy), which reads
    the forward's `rstd` and a weight in x's dtype or f32 as it is (any
    other dtype cast to f32 first) and writes dw in that dtype; dw is
    summed in the fixed order of `norm_bwd.bwd_plan` (no float atomics),
    so two runs give identical bits. Each launch adds one to
    `rms_norm_bwd.launches` and to its x dtype's count."""
    if not x.is_cuda:
        return _rms_train_ref_bwd(x, weight, dy, epsilon)
    _check_rows(x, weight, "rms_norm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rms_norm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        raise TypeError("rms_norm_bwd: dy must be 16-byte aligned")
    d = x.shape[-1]
    rows = x.numel() // d
    if rstd.numel() != rows or rstd.dtype != torch.float32:
        raise ValueError(f"rms_norm_bwd: rstd must be f32 with {rows} rows")
    rstd = rstd.contiguous()
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight)
    w = _kernel_weight(weight, x)
    w_x = w.dtype == x.dtype
    plan = norm_bwd.device_plan(x.device, "rms_norm", "rms_bwd_resident",
                                _BWD_KINDS[(x.dtype, w_x)], rows, d,
                                16 // x.element_size(), 1)
    partials = torch.empty(plan.blocks, d, dtype=torch.float32,
                           device=x.device)
    dw = torch.empty(d, dtype=w.dtype, device=x.device)
    sym = f"rms_bwd_{_DTYPES[x.dtype]}"
    fn = _build.function("rms_norm", sym, _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dw.data_ptr(), partials.data_ptr(), rows, d,
                 int(w_x), plan.warps, plan.vpt, plan.blocks,
                 plan.fold_cols, stream)
    _build.check(err, sym)
    _build.count_dtype(rms_norm_bwd, x.dtype)
    return dx, dw if dw.dtype == weight.dtype else dw.to(weight.dtype)


rms_norm_bwd.launches = 0
rms_norm_bwd.launches_f32 = 0
rms_norm_bwd.launches_bf16 = 0
rms_norm_bwd.launches_f16 = 0


class _RmsNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, epsilon):
        out, rstd = rms_norm_fwd(x, weight, epsilon)
        ctx.save_for_backward(x, weight, rstd)
        ctx.epsilon = epsilon
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, rstd, dy, ctx.epsilon)
        return dx, dw, None


def rms_norm_train(x, weight, epsilon: float = 1e-6):
    """Differentiable RMSNorm of the training stack: equal in value to
    `rms_norm_ref(x, weight, epsilon)`; forward and backward are the two
    kernels on the card, their plain twins on the CPU."""
    x = x.contiguous()
    return _RmsNormTrain.apply(x, weight, epsilon)


def rms_norm_fused(x, weight=None, epsilon: float = 1e-6):
    """Row 6, the counterpart of `rms_norm_pallas`: x·rsqrt(mean(x²) +
    eps)·weight in x's dtype, no statistics. On a CPU tensor: the plain
    version `rms_norm_ref`. On a CUDA tensor: the kernel (f32, bf16 or
    f16 x, hidden size a multiple of 8 up to 8192; a weight in x's dtype
    or f32 is read as it is, in the kernel, any other dtype cast to f32
    first, as `rms_norm_fwd` takes it; None for the affine-free form);
    anything else raises. Each launch adds one to
    `rms_norm_fused.launches` and to its x dtype's count."""
    if not x.is_cuda:
        return rms_norm_ref(x, weight, epsilon)
    _check_rows(x, weight, "rms_norm_fused")
    d = x.shape[-1]
    w = _fused_weight(weight, x)
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    sym = f"rms_fused_{_DTYPES[x.dtype]}"
    fn = _build.function("rms_norm", sym, _FUSED_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), None if w is None else w.data_ptr(),
                 out.data_ptr(), rows, d, float(epsilon),
                 int(w is not None and w.dtype == x.dtype), stream)
    _build.check(err, sym)
    _build.count_dtype(rms_norm_fused, x.dtype)
    return out


rms_norm_fused.launches = 0
rms_norm_fused.launches_f32 = 0
rms_norm_fused.launches_bf16 = 0
rms_norm_fused.launches_f16 = 0


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """The JAX package's dispatch (kernels/rms_norm.py:68-86): the row-6
    kernel on a CUDA tensor, with or without a weight; the plain version
    on a CPU tensor. It never falls back on CUDA."""
    return rms_norm_fused(x, weight, epsilon)


class _RmsNormFused(torch.autograd.Function):
    """Row 6 made differentiable for the eager API: the forward is the
    dispatch, the backward the plain version's vjp in torch ops, itself
    differentiable (grad-of-grad works, as the JAX tape's does)."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        return rms_norm(x, weight, epsilon)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = _rms_train_ref_bwd(x, weight, dy, ctx.epsilon)
        return dx, dw, None


def rms_norm_fused_train(x, weight=None, epsilon: float = 1e-6):
    """Differentiable row-6 norm (weight None: affine-free): equal in
    value to `rms_norm_ref(x, weight, epsilon)`."""
    return _RmsNormFused.apply(x.contiguous(), weight, epsilon)
