"""Optimizers of the eager API — port of paddle_tpu/optimizer/optimizers.py
(:30 ClipGradByValue, :41 ClipGradByNorm, :52 ClipGradByGlobalNorm,
:64 Optimizer, :211 SGD, :222 Momentum, :246 Adagrad, :265 RMSProp,
:298 Adam, :349 AdamW, :364 Adamax, :386 Lamb, :423 Adadelta, :445
L1Decay and L2Decay, :455 Rprop, :482 ASGD, :514 NAdam, :548 RAdam,
:583 LBFGS).

The update formulas, the bias-correction powers (f32 scalars per
parameter), decoupled decay, `apply_decay_param_fun`, the regularizers
(L1Decay adds c·sign(w) to the gradient; L2Decay, like a float, flows
into the update as `wd`), amsgrad, master weights and the learning-rate
multiplier are the JAX package's. The JAX package jits each parameter's
update into one XLA computation; here the parameters of one (device,
dtype) group are updated together, in runs of up to 2^27 values
(`transform.grouped_chunks`, which the tree optimizers share), by
`torch._foreach_*` ops, one multi-tensor launch per step of the formula,
in the formula's own order (no torch.optim, no fused kernel: XLA, not
Pallas, runs this update in JAX). The new moments are new tensors, as
JAX's arrays are, so a `state_dict()` taken earlier keeps its values. A
new parameter value of the parameter's dtype is written into its
storage; one of another dtype (a bf16 parameter's f32 update without
master weights, as JAX's `value - step` promotes) replaces the
parameter's tensor, as JAX's `_rebind` does, and layers keep reading it
through the Parameter. The learning rate is a float or an
`lr.LRScheduler`, read once a step.

Master weights (`multi_precision`, set by `amp.decorate`): an f16 or
bf16 parameter gets an f32 `master` in its state, made from the
parameter's value at its first step (after decorate's cast, as in the
JAX package). The clip acts on the gradients as they come; the update
runs on the masters (one multi-tensor pass over a group, in place), and
each group's parameters take the masters rounded to their dtype in one
multi-tensor copy. `state_dict` carries `"<name>.master"`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core import dtype as dtypes
from .lr import LRScheduler
from .transform import grouped_chunks


class _GradClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _grad_groups(params_grads):
    """Indices of the gradients by (device, dtype) group, in order."""
    groups = {}
    for i, (_, g) in enumerate(params_grads):
        groups.setdefault((g.device, g.dtype), []).append(i)
    return groups.values()


class ClipGradByValue(_GradClipBase):
    """Each gradient clipped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        out = [g for _, g in params_grads]
        for idx in _grad_groups(params_grads):
            gs = torch._foreach_clamp_min([out[i] for i in idx], self.min)
            torch._foreach_clamp_max_(gs, self.max)
            for i, g in zip(idx, gs):
                out[i] = g
        return [(p, g) for (p, _), g in zip(params_grads, out)]


class ClipGradByNorm(_GradClipBase):
    """Each gradient times min(1, clip_norm / its own L2 norm), in its
    dtype: one multi-tensor norm and scaling per (device, dtype)
    group."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = [g for _, g in params_grads]
        for idx in _grad_groups(params_grads):
            gs = [out[i] for i in idx]
            norms = torch._foreach_clamp_min(torch._foreach_norm(gs), 1e-12)
            scales = torch._foreach_reciprocal(norms)
            torch._foreach_mul_(scales, self.clip_norm)
            torch._foreach_clamp_max_(scales, 1.0)
            for i, g in zip(idx, torch._foreach_mul(gs, scales)):
                out[i] = g
        return [(p, g) for (p, _), g in zip(params_grads, out)]


class ClipGradByGlobalNorm(_GradClipBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        """min(1, clip / global norm) times every gradient, in f32, cast
        back to each gradient's dtype. Per (device, dtype) group the
        squares and the scaling are multi-tensor ops; each gradient's sum
        of squares stays its own reduction, summed in the list's order, so
        the norm has the per-parameter formula's bits. No gradient: []."""
        if not params_grads:
            return []
        grads = [g.float() for _, g in params_grads]
        sums = [None] * len(grads)
        for idx in grouped_chunks(grads):
            gs = [grads[i] for i in idx]
            for i, sq in zip(idx, torch._foreach_mul(gs, gs)):
                sums[i] = torch.sum(sq)
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for s in sums:
            total = total + s.to(total.device)
        scale = self.clip_norm / torch.clamp(torch.sqrt(total),
                                             min=self.clip_norm)
        out = [None] * len(grads)
        for idx in grouped_chunks(grads):
            gs = [grads[i] for i in idx]
            for i, g in zip(idx, torch._foreach_mul(
                    gs, scale.to(gs[0].device))):
                out[i] = g.to(params_grads[i][1].dtype)
        return [(p, g) for (p, _), g in zip(params_grads, out)]


def _rebind(p: Tensor, value: torch.Tensor) -> None:
    """`value` becomes the parameter's tensor: a leaf that requires grad
    as the old one did, its accumulated gradient cast along."""
    old = p._data
    new = value.detach().requires_grad_(old.requires_grad)
    if old.grad is not None:
        new.grad = old.grad.to(new.dtype)
    p._data = new


class Optimizer:
    """Base: the learning rate (a float or an LRScheduler), weight decay,
    clipping, per-parameter state and its state_dict."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError(
                "parameters=None: pass model.parameters() (the static-graph "
                "global-collection mode is not supported; eager only)")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        sched = self._lr_scheduler
        return float(sched() if sched is not None else self._learning_rate)

    def set_lr(self, value: float):
        if self._lr_scheduler is not None:
            raise RuntimeError("set_lr cannot override an LRScheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    @property
    def _lr_scheduler(self):
        lr = self._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    # -- state ---------------------------------------------------------------
    def _param_state(self, p: Tensor) -> Dict[str, torch.Tensor]:
        st = self._state.get(id(p))
        if st is None:
            st = self._init_state(p)
            if self._multi_precision and p._data.dtype in (
                    dtypes.float16, dtypes.bfloat16):
                st["master"] = p._data.detach().float()
            self._state[id(p)] = st
        return st

    def _init_state(self, p: Tensor) -> Dict[str, torch.Tensor]:
        return {}

    # -- the update ----------------------------------------------------------
    def _steps(self, values, grads, states, lrs, wds):
        """One chunk of a (device, dtype) group (`grouped_chunks`): (param
        values, grads in the values' dtype, state dicts, per-parameter
        lr · lr_mult and decay coefficients, f32 values as python floats)
        → (the steps to subtract from the values, new state dicts)."""
        raise NotImplementedError

    def _decay_info(self, p: Optional[Tensor]):
        """→ (coeff, is_l1). L1 decay is applied to the gradient in
        step() (c·sign(w)); L2 or a float flows into the update as
        `wd`."""
        wd = self._weight_decay
        if wd is None:
            return 0.0, False
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None and p is not None and not fn(p.name):
            return 0.0, False
        if isinstance(wd, L1Decay):
            return float(wd._coeff), True
        if isinstance(wd, L2Decay):
            return float(wd._coeff), False
        return float(wd), False

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p._data.grad) for p in self._parameter_list
                        if p._data.grad is not None and not p.stop_gradient]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        # the f32 scalars of the JAX step's jitted update: lr and the decay
        # as f32; lr · lr_mult rounded to f32, as the f32 product
        # `lr * lr_mult` of a per-parameter update rounds it
        lr = np.float32(self.get_lr())
        # the values the update runs on: the f32 master where there is one
        masters = [self._param_state(p).get("master")
                   for p, _ in params_grads]
        vals = [p._data if m is None else m
                for (p, _), m in zip(params_grads, masters)]
        for idx in grouped_chunks(vals):
            items = [params_grads[i] for i in idx]
            values = [vals[i] for i in idx]
            grads = [g for _, g in items]
            if any(g.dtype != v.dtype for g, v in zip(grads, values)):
                # the gradients in their values' dtype (a master's f32),
                # as JAX's `g.astype(value.dtype)`: one multi-tensor copy
                grads, raw = [torch.empty_like(v) for v in values], grads
                torch._foreach_copy_(grads, raw)
            states = [{k: v for k, v in self._state[id(p)].items()
                       if k != "master"} for p, _ in items]
            lrs = [float(lr * np.float32(getattr(p, "optimize_attr", {})
                                         .get("learning_rate", 1.0)))
                   for p, _ in items]
            decays = [self._decay_info(p) for p, _ in items]
            l1 = [j for j, (c, is_l1) in enumerate(decays) if is_l1 and c]
            if l1:
                pen = torch._foreach_mul(
                    torch._foreach_sign([values[j] for j in l1]),
                    [decays[j][0] for j in l1])
                for j, t in zip(l1, pen):
                    grads[j] = grads[j] + t
            wds = [0.0 if is_l1 else float(np.float32(c))
                   for c, is_l1 in decays]
            steps, new_states = self._steps(values, grads, states, lrs, wds)
            for i, (p, _), st in zip(idx, items, new_states):
                if masters[i] is not None:
                    st["master"] = masters[i]
                self._state[id(p)] = st
            if all(s.dtype == v.dtype for s, v in zip(steps, values)):
                torch._foreach_sub_(values, steps)
            else:
                # a step of another dtype promotes the value, as JAX's
                # `value - step` does; the result replaces the parameter's
                # tensor, as `_rebind` stores it (no master here: a master
                # is f32, and so are its steps)
                for (p, _), v, s in zip(items, values, steps):
                    _rebind(p, v - s)
            # the masters rounded back into their parameters, one
            # multi-tensor copy (the group's parameters share a dtype)
            back = [i for i in idx if masters[i] is not None]
            if back:
                torch._foreach_copy_([params_grads[i][0]._data
                                      for i in back],
                                     [masters[i] for i in back])
        self._step_count += 1

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # -- persistence ----------------------------------------------------------
    def state_dict(self):
        """The moments and masters by parameter name (`{name}.{key}`),
        the step and, with a scheduler, its state under "LR_Scheduler".
        A master is copied: the update writes it in place."""
        out = {"_step_count": self._step_count}
        for p in self._parameter_list:
            st = self._state.get(id(p))
            if st:
                for k, v in st.items():
                    out[f"{p.name}.{k}"] = Tensor(
                        v.clone() if k == "master" else v)
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("_step_count", 0))
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        for p in self._parameter_list:
            st = {}
            for k, v in state.items():
                if isinstance(k, str) and k.startswith(p.name + "."):
                    t = v._data if isinstance(v, Tensor) else \
                        Tensor(v)._data
                    st[k[len(p.name) + 1:]] = t.to(p._data.device).clone()
            if st:
                self._state[id(p)] = st


def _promoted(values):
    """The values as the JAX update's decay term sees them: a product
    with the f32 array `wd` promotes a bf16 or f16 value to f32."""
    return [v if v.dtype in (torch.float32, torch.float64) else v.float()
            for v in values]


class SGD(Optimizer):
    """paddle SGD: value - lr · (grad + wd · value)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _steps(self, values, grads, states, lrs, wds):
        g = torch._foreach_add(grads, torch._foreach_mul(_promoted(values),
                                                         wds))
        torch._foreach_mul_(g, lrs)
        return g, states


class Momentum(Optimizer):
    """paddle Momentum: v = mu · v + (grad + wd · value); the step is v,
    or grad + mu · v with Nesterov, times lr. The velocity has the
    parameter's dtype (f32 once a bf16 parameter's f32 decay term has
    promoted it, as in the JAX update)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(
            p._data, dtype=torch.float32 if self._multi_precision
            else None)}

    def _steps(self, values, grads, states, lrs, wds):
        mu = self._momentum
        g = torch._foreach_add(grads, torch._foreach_mul(_promoted(values),
                                                         wds))
        vel = torch._foreach_mul([s["velocity"].to(gi.dtype)
                                  for s, gi in zip(states, g)], mu)
        torch._foreach_add_(vel, g)
        if self._nesterov:
            step = torch._foreach_add(g, torch._foreach_mul(vel, mu))
            torch._foreach_mul_(step, lrs)
        else:
            step = torch._foreach_mul(vel, lrs)
        return step, [{"velocity": v} for v in vel]


class Adam(Optimizer):
    """paddle Adam: weight_decay is L2 regularization (coupled)."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision or p.dtype in (
            dtypes.float16, dtypes.bfloat16) else p.dtype
        dev = p._data.device
        st = {"moment1": torch.zeros(p.shape, dtype=dt, device=dev),
              "moment2": torch.zeros(p.shape, dtype=dt, device=dev),
              "beta1_pow": torch.ones((), dtype=torch.float32, device=dev),
              "beta2_pow": torch.ones((), dtype=torch.float32, device=dev)}
        if self._amsgrad:
            st["moment2_max"] = torch.zeros(p.shape, dtype=dt, device=dev)
        return st

    def _steps(self, values, grads, states, lrs, wds):
        # the per-parameter formula's operations in its order, each one
        # multi-tensor op over the group (in place only on temporaries)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        fe = torch
        # the decay terms are products with an f32 array in JAX, so a
        # bf16 value enters them promoted to f32
        vf = _promoted(values)
        if not self._decoupled:
            grads = fe._foreach_add(grads, fe._foreach_mul(vf, wds))
        m1 = fe._foreach_mul([s["moment1"] for s in states], b1)
        fe._foreach_add_(m1, fe._foreach_mul(grads, 1 - b1))
        g2 = fe._foreach_mul(grads, grads)
        fe._foreach_mul_(g2, 1 - b2)
        m2 = fe._foreach_mul([s["moment2"] for s in states], b2)
        fe._foreach_add_(m2, g2)
        del g2
        b1p = fe._foreach_mul([s["beta1_pow"] for s in states], b1)
        b2p = fe._foreach_mul([s["beta2_pow"] for s in states], b2)
        # each parameter's own 0-dim bias corrections 1 - b^t (as -b^t + 1,
        # the same rounding)
        bc1, bc2 = fe._foreach_neg(b1p), fe._foreach_neg(b2p)
        fe._foreach_add_(bc1, 1.0)
        fe._foreach_add_(bc2, 1.0)
        step = fe._foreach_div(m1, bc1)
        if self._amsgrad:
            m2max = fe._foreach_maximum([s["moment2_max"] for s in states],
                                        m2)
        den = fe._foreach_div(m2max if self._amsgrad else m2, bc2)
        fe._foreach_sqrt_(den)
        fe._foreach_add_(den, eps)
        fe._foreach_mul_(step, lrs)
        fe._foreach_div_(step, den)
        del den
        if self._decoupled:
            fe._foreach_add_(step, fe._foreach_mul(
                vf, [float(np.float32(np.float32(lr) * np.float32(wd)))
                         for lr, wd in zip(lrs, wds)]))
        new = [{"moment1": a, "moment2": b, "beta1_pow": c, "beta2_pow": d}
               for a, b, c, d in zip(m1, m2, b1p, b2p)]
        if self._amsgrad:
            for st, mx in zip(new, m2max):
                st["moment2_max"] = mx
        return step, new


class AdamW(Adam):
    """paddle AdamW: decoupled weight decay (default coeff 0.01)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._apply_decay_param_fun = apply_decay_param_fun


def _coupled(grads, values, wds):
    """grad + wd · value, the coupled decay of the JAX updates: `wd` is
    an f32 array there, so a bf16 value enters the product promoted."""
    return torch._foreach_add(grads, torch._foreach_mul(_promoted(values),
                                                        wds))


def _ema(prev, new, rho):
    """rho · prev + (1 - rho) · new: each product in its own dtype (a
    bf16 state times a Python float stays bf16, as with JAX's weak
    scalars), the sum promoted."""
    out = torch._foreach_mul(prev, rho)
    return torch._foreach_add(out, torch._foreach_mul(new, 1 - rho))


def _one_minus(xs):
    """1 - x for a list of 0-dim tensors (as -x + 1: the same rounding)."""
    out = torch._foreach_neg(xs)
    torch._foreach_add_(out, 1.0)
    return out


def _scalar(p, value):
    """An f32 0-dim state on p's device (a power, a count, a product)."""
    return torch.full((), value, dtype=torch.float32, device=p._data.device)


class Adagrad(Optimizer):
    """paddle Adagrad: m += g², value - lr · g / (√m + ε), with the
    coupled decay. The accumulator has the parameter's dtype."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p._data, self._init_acc)}

    def _steps(self, values, grads, states, lrs, wds):
        g = _coupled(grads, values, wds)
        m = torch._foreach_add([s["moment"] for s in states],
                               torch._foreach_mul(g, g))
        den = torch._foreach_sqrt(m)
        torch._foreach_add_(den, self._epsilon)
        step = torch._foreach_mul(g, lrs)
        torch._foreach_div_(step, den)
        return step, [{"moment": a} for a in m]


class RMSProp(Optimizer):
    """paddle RMSProp: ms = ρ·ms + (1-ρ)·g²; centered, also the mean
    gradient mg and √(ms - mg² + ε) as the denominator; the velocity
    v = momentum·v + lr·g / denominator is the step. States have the
    parameter's dtype until an f32 term promotes them."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, p):
        st = {"mean_square": torch.zeros_like(p._data),
              "velocity": torch.zeros_like(p._data)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p._data)
        return st

    def _steps(self, values, grads, states, lrs, wds):
        rho, eps = self._rho, self._epsilon
        g = _coupled(grads, values, wds)
        ms = _ema([s["mean_square"] for s in states],
                  torch._foreach_mul(g, g), rho)
        new = [{"mean_square": a} for a in ms]
        den = ms
        if self._centered:
            mg = _ema([s["mean_grad"] for s in states], g, rho)
            den = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            for st, a in zip(new, mg):
                st["mean_grad"] = a
        den = torch._foreach_add(den, eps)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_mul(g, lrs)
        torch._foreach_div_(upd, den)
        vel = torch._foreach_add(
            torch._foreach_mul([s["velocity"] for s in states],
                               self._momentum), upd)
        for st, a in zip(new, vel):
            st["velocity"] = a
        return vel, new


class Adamax(Optimizer):
    """paddle Adamax: m = β1·m + (1-β1)·g, u = max(β2·u, |g|), the step
    lr·m / ((1 - β1^t)·(u + ε)). `multi_precision` goes to **kw, as in
    the JAX package; amp.decorate O2 still sets masters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p._data),
                "inf_norm": torch.zeros_like(p._data),
                "beta1_pow": _scalar(p, 1.0)}

    def _steps(self, values, grads, states, lrs, wds):
        b1, b2 = self._beta1, self._beta2
        g = _coupled(grads, values, wds)
        m = _ema([s["moment"] for s in states], g, b1)
        u = torch._foreach_maximum(
            torch._foreach_mul([s["inf_norm"] for s in states], b2),
            torch._foreach_abs(g))
        b1p = torch._foreach_mul([s["beta1_pow"] for s in states], b1)
        den = torch._foreach_add(u, self._epsilon)
        torch._foreach_mul_(den, _one_minus(b1p))
        step = torch._foreach_mul(m, lrs)
        torch._foreach_div_(step, den)
        return step, [{"moment": a, "inf_norm": b, "beta1_pow": c}
                      for a, b, c in zip(m, u, b1p)]


class Lamb(Optimizer):
    """paddle Lamb: Adam's moments with bias correction give r = m̂ /
    (√v̂ + ε); then r + wd · value (decay from `lamb_weight_decay`,
    formed after the moments); the step is lr · trust · r with the trust
    ratio ‖w‖ / ‖r‖ per parameter (1 where either norm is 0), computed
    on the device. `exclude_from_weight_decay_fn` takes the Parameter."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_info(self, p):
        if self._exclude_fn is not None and p is not None \
                and self._exclude_fn(p):
            return 0.0, False
        return super()._decay_info(p)

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p._data),
                "moment2": torch.zeros_like(p._data),
                "beta1_pow": _scalar(p, 1.0), "beta2_pow": _scalar(p, 1.0)}

    @staticmethod
    def _trust(w_norms, r_norms):
        """where(‖w‖ > 0 and ‖r‖ > 0, ‖w‖ / ‖r‖, 1) for every parameter
        of a group at once: [P] tensors, no host read. The norms arrive
        in f64 and the ratio is taken in f32, as in the JAX update."""
        wn = torch.stack(w_norms).float()
        rn = torch.stack(r_norms).float()
        return torch.where((wn > 0) & (rn > 0), wn / rn, 1.0)

    def _steps(self, values, grads, states, lrs, wds):
        b1, b2 = self._beta1, self._beta2
        m1 = _ema([s["moment1"] for s in states], grads, b1)
        m2 = _ema([s["moment2"] for s in states],
                  torch._foreach_mul(grads, grads), b2)
        b1p = torch._foreach_mul([s["beta1_pow"] for s in states], b1)
        b2p = torch._foreach_mul([s["beta2_pow"] for s in states], b2)
        # a bf16 moment over the f32 bias correction promotes, as JAX's
        # division by a strong f32 array does
        r = torch._foreach_div(_promoted(m1), _one_minus(b1p))
        den = torch._foreach_div(_promoted(m2), _one_minus(b2p))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(r, den)
        del den
        r = torch._foreach_add(r, torch._foreach_mul(_promoted(values), wds))
        # the norms accumulate in f64: torch's f32 vector norm on the CPU
        # loses digits over an embedding's tens of millions of elements
        # (the card's does not; PERF.md §6); in f64 both are
        # exact to f32
        trust = self._trust(torch._foreach_norm(values, dtype=torch.float64),
                            torch._foreach_norm(r, dtype=torch.float64))
        coef = torch._foreach_mul(list(trust.unbind(0)), lrs)
        torch._foreach_mul_(r, coef)
        return r, [{"moment1": a, "moment2": b, "beta1_pow": c,
                    "beta2_pow": d} for a, b, c, d in zip(m1, m2, b1p, b2p)]


class Adadelta(Optimizer):
    """paddle Adadelta: Eg² = ρ·Eg² + (1-ρ)·g², the update
    g·√(EΔ² + ε) / √(Eg² + ε), EΔ² = ρ·EΔ² + (1-ρ)·update², the step
    lr · update."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p._data),
                "avg_squared_update": torch.zeros_like(p._data)}

    def _steps(self, values, grads, states, lrs, wds):
        rho, eps = self._rho, self._epsilon
        g = _coupled(grads, values, wds)
        asu = [s["avg_squared_update"] for s in states]
        asg = _ema([s["avg_squared_grad"] for s in states],
                   torch._foreach_mul(g, g), rho)
        # EΔ² + ε in the state's dtype (ε rounded to bf16 on O2's first
        # step), its root in the gradient's f32, as XLA computes the
        # fused √(EΔ² + ε) of the JAX update
        num = [a.to(x.dtype) for a, x in
               zip(torch._foreach_add(asu, eps), g)]
        torch._foreach_sqrt_(num)
        upd = torch._foreach_mul(g, num)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        asu = _ema(asu, torch._foreach_mul(upd, upd), rho)
        return torch._foreach_mul(upd, lrs), [
            {"avg_squared_grad": a, "avg_squared_update": b}
            for a, b in zip(asg, asu)]


class Rprop(Optimizer):
    """paddle Rprop (3.0): each element's step size grows by eta+ where
    the gradient keeps its sign, shrinks by eta- where it flips, clipped
    to `learning_rate_range`; a flip also zeroes the carried gradient
    and moves nothing. The step size starts at get_lr() (read at the
    parameter's first step); the update uses neither lr nor decay."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _init_state(self, p):
        return {"prev_grad": torch.zeros_like(p._data),
                "step_size": torch.full_like(p._data, float(self.get_lr()))}

    def _steps(self, values, grads, states, lrs, wds):
        eta_n, eta_p = self._etas
        lo, hi = self._lr_range
        sizes = [s["step_size"] for s in states]
        sign = torch._foreach_sign(torch._foreach_mul(
            grads, [s["prev_grad"] for s in states]))
        # the factor in the step size's dtype, as JAX's weak scalars
        factor = [torch.where(sg > 0, eta_p, torch.where(sg < 0, eta_n, 1.0))
                  .to(sz.dtype) for sg, sz in zip(sign, sizes)]
        size = torch._foreach_mul(sizes, factor)
        torch._foreach_clamp_min_(size, lo)
        torch._foreach_clamp_max_(size, hi)
        g_eff = [torch.where(sg < 0, 0.0, g) for sg, g in zip(sign, grads)]
        step = torch._foreach_mul(torch._foreach_sign(g_eff), size)
        return step, [{"prev_grad": a, "step_size": b}
                      for a, b in zip(g_eff, size)]


class ASGD(Optimizer):
    """paddle ASGD (3.0): averaged SGD over the last `batch_num`
    gradients. Each parameter keeps the f32 sum d of a ring `ys` of its
    last batch_num (coupled-decay) gradients and the ring's position
    `idx`, all on the device; the step is lr · d / batch_num."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._batch_num = batch_num

    def _init_state(self, p):
        dev = p._data.device
        return {"d": torch.zeros_like(p._data, dtype=torch.float32),
                "ys": torch.zeros((max(self._batch_num, 1),) + tuple(p.shape),
                                  dtype=torch.float32, device=dev),
                "idx": torch.zeros((), dtype=torch.int32, device=dev)}

    def _steps(self, values, grads, states, lrs, wds):
        g = [a.float() for a in _coupled(grads, values, wds)]
        n = states[0]["ys"].shape[0]
        at = [s["idx"].view(1) for s in states]
        old = [s["ys"].index_select(0, i).squeeze(0)
               for s, i in zip(states, at)]
        d = torch._foreach_sub([s["d"] for s in states], old)
        torch._foreach_add_(d, g)
        ys = [s["ys"].index_copy(0, i.long(), a.unsqueeze(0))
              for s, i, a in zip(states, at, g)]
        idx = [(s["idx"] + 1) % n for s in states]
        step = torch._foreach_mul(d, lrs)
        torch._foreach_div_(step, n)
        return step, [{"d": a, "ys": b, "idx": c}
                      for a, b, c in zip(d, ys, idx)]


class NAdam(Optimizer):
    """paddle NAdam (3.0): Nesterov momentum with the momentum schedule
    μ_t = β1·(1 - ½·0.96^(t·ψ)); t and Πμ are per-parameter f32 0-dim
    tensors on the device, the moments f32."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._b1, self._b2 = beta1, beta2
        self._eps = epsilon
        self._psi = momentum_decay

    def _init_state(self, p):
        return {"m": torch.zeros_like(p._data, dtype=torch.float32),
                "v": torch.zeros_like(p._data, dtype=torch.float32),
                "mu_prod": _scalar(p, 1.0), "t": _scalar(p, 0.0)}

    def _mu(self, t):
        """β1 · (1 - 0.5 · 0.96^(t·ψ)) for each 0-dim t."""
        mu = torch._foreach_mul(
            torch._foreach_pow(0.96, torch._foreach_mul(t, self._psi)), 0.5)
        mu = _one_minus(mu)
        torch._foreach_mul_(mu, self._b1)
        return mu

    def _steps(self, values, grads, states, lrs, wds):
        b1, b2 = self._b1, self._b2
        g = _coupled(grads, values, wds)
        t = torch._foreach_add([s["t"] for s in states], 1.0)
        mu_t = self._mu(t)
        mu_t1 = self._mu(torch._foreach_add(t, 1.0))
        mu_prod = torch._foreach_mul([s["mu_prod"] for s in states], mu_t)
        m = _ema([s["m"] for s in states], g, b1)
        v = _ema([s["v"] for s in states], torch._foreach_mul(g, g), b2)
        m_hat = torch._foreach_mul(m, mu_t1)
        torch._foreach_div_(m_hat, _one_minus(
            torch._foreach_mul(mu_prod, mu_t1)))
        cur = torch._foreach_mul(g, _one_minus(mu_t))
        torch._foreach_div_(cur, _one_minus(mu_prod))
        torch._foreach_add_(m_hat, cur)
        del cur
        den = torch._foreach_div(v, _one_minus(torch._foreach_pow(b2, t)))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._eps)
        step = torch._foreach_mul(m_hat, lrs)
        torch._foreach_div_(step, den)
        return step, [{"m": a, "v": b, "mu_prod": c, "t": d}
                      for a, b, c, d in zip(m, v, mu_prod, t)]


class RAdam(Optimizer):
    """paddle RAdam (3.0): Adam's step rectified by r_t once the
    variance estimate is tractable (ρ_t > 5), the bias-corrected
    momentum step before that. t and ρ_t are per-parameter f32 0-dim
    tensors, and the choice is a `where` on the device."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._b1, self._b2 = beta1, beta2
        self._eps = epsilon

    def _init_state(self, p):
        return {"m": torch.zeros_like(p._data, dtype=torch.float32),
                "v": torch.zeros_like(p._data, dtype=torch.float32),
                "t": _scalar(p, 0.0)}

    @staticmethod
    def _rectified(rho_t):
        return rho_t > 5.0

    def _steps(self, values, grads, states, lrs, wds):
        b1, b2, eps = self._b1, self._b2, self._eps
        g = _coupled(grads, values, wds)
        t = torch._foreach_add([s["t"] for s in states], 1.0)
        m = _ema([s["m"] for s in states], g, b1)
        v = _ema([s["v"] for s in states], torch._foreach_mul(g, g), b2)
        m_hat = torch._foreach_div(m, _one_minus(torch._foreach_pow(b1, t)))
        rho_inf = 2.0 / (1 - b2) - 1
        b2t = torch._foreach_pow(b2, t)
        bc2 = _one_minus(b2t)
        rho_t = torch._foreach_mul(torch._foreach_mul(t, 2.0), b2t)
        torch._foreach_div_(rho_t, bc2)
        rho_t = torch._foreach_neg(rho_t)
        torch._foreach_add_(rho_t, rho_inf)
        num = torch._foreach_mul(torch._foreach_sub(rho_t, 4.0),
                                 torch._foreach_sub(rho_t, 2.0))
        torch._foreach_mul_(num, rho_inf)
        den = torch._foreach_mul(rho_t, (rho_inf - 4) * (rho_inf - 2))
        torch._foreach_clamp_min_(den, 1e-12)
        torch._foreach_div_(num, den)
        r = torch._foreach_sqrt(num)
        v_hat = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(v_hat)
        torch._foreach_add_(v_hat, eps)
        rect = torch._foreach_mul(m_hat, torch._foreach_mul(r, lrs))
        torch._foreach_div_(rect, v_hat)
        plain = torch._foreach_mul(m_hat, lrs)
        step = [torch.where(self._rectified(rt), a, b)
                for rt, a, b in zip(rho_t, rect, plain)]
        return step, [{"m": a, "v": b, "t": c} for a, b, c in zip(m, v, t)]


class LBFGS(Optimizer):
    """paddle LBFGS: closure-driven L-BFGS with the two-loop recursion.

    `step(closure)` runs up to `max_iter` iterations, each calling the
    closure for the loss and the gradients. The gradients, parameters
    and writes all go through one `_active` subset, so the flat offsets
    agree. The history of (s, y) pairs and every scalar of the two-loop
    recursion stay on the device (the recursion's scalars in f64, as the
    JAX package computes them in Python floats); an iteration reads the
    device three times, where the JAX step does: the largest gradient
    against `tolerance_grad`, y·s against the curvature floor, and the
    largest move against `tolerance_change`."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        if weight_decay is not None or grad_clip is not None:
            raise NotImplementedError(
                "LBFGS does not support weight_decay/grad_clip (fold decay "
                "into the closure's loss)")
        super().__init__(learning_rate, parameters, None, None, name)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._hist = history_size
        self._s, self._y = [], []
        self._prev_flat_grad = None
        self._prev_params = None

    def _active(self):
        return [p for p in self._parameter_list
                if p._data.grad is not None and not p.stop_gradient]

    @staticmethod
    def _flat(ts):
        return torch.cat([t.detach().reshape(-1).float() for t in ts])

    def _set_flat_params(self, params, flat):
        off = 0
        with torch.no_grad():
            for p in params:
                n = p._data.numel()
                p._data.copy_(flat[off:off + n].view(p._data.shape))
                off += n

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step needs a closure that recomputes "
                             "the loss and calls backward()")
        loss = None
        for _ in range(max(self._max_iter, 1)):
            loss = closure()
            params = self._active()
            if not params:
                return loss
            g = self._flat([p._data.grad for p in params])
            if float(g.abs().max()) <= self._tol_grad:
                break
            if self._prev_flat_grad is not None and \
                    self._prev_flat_grad.shape == g.shape:
                s = self._flat([p._data for p in params]) - self._prev_params
                y = g - self._prev_flat_grad
                if float(torch.dot(y, s)) > 1e-10:
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self._hist:
                        self._s.pop(0)
                        self._y.pop(0)
            q = g
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / torch.dot(y, s).double()
                a = rho * torch.dot(s, q).double()
                alphas.append((a, rho))
                q = q - a.float() * y
            if self._s:
                sy, yy = self._s[-1], self._y[-1]
                gamma = torch.dot(sy, yy) / torch.clamp(torch.dot(yy, yy),
                                                        min=1e-12)
                q = q * gamma
            for (a, rho), s, y in zip(reversed(alphas), self._s, self._y):
                b = rho * torch.dot(y, q).double()
                q = q + (a - b).float() * s
            self._prev_flat_grad = g
            self._prev_params = self._flat([p._data for p in params])
            step_vec = self.get_lr() * -q
            self._set_flat_params(params, self._prev_params + step_vec)
            self._step_count += 1
            if float(step_vec.abs().max()) <= self._tol_change:
                break
        return loss


class L1Decay:
    """paddle.regularizer.L1Decay: coeff · sign(w) added to the
    gradient."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L2Decay:
    """paddle.regularizer.L2Decay: coeff · w, as a float weight_decay."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff
