"""Optimizers of the eager API — port of paddle_tpu/optimizer/optimizers.py
(:30 ClipGradByValue, :41 ClipGradByNorm, :52 ClipGradByGlobalNorm,
:64 Optimizer, :211 SGD, :222 Momentum, :298 Adam, :349 AdamW, :445
L1Decay and L2Decay).

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


class L1Decay:
    """paddle.regularizer.L1Decay: coeff · sign(w) added to the
    gradient."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L2Decay:
    """paddle.regularizer.L2Decay: coeff · w, as a float weight_decay."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff
