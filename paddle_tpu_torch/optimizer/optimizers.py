"""Optimizers of the eager API — port of paddle_tpu/optimizer/optimizers.py
(:52 ClipGradByGlobalNorm, :64 Optimizer, :298 Adam, :349 AdamW).

The update formulas, the bias-correction powers (f32 scalars per
parameter), decoupled decay, `apply_decay_param_fun` and the
learning-rate multiplier are the JAX package's. Each update is plain
torch ops on each parameter, as the JAX package runs plain jnp per
parameter (no torch.optim, no fused multi-tensor kernel); the new value
is written into the parameter's storage in place (JAX rebinds a new
array). LR schedulers, L1/L2Decay objects, master weights
(`multi_precision`, with `amp.decorate`), amsgrad and the other
optimizers arrive with the rest of the eager API and raise
`NotImplementedError` until then.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.tensor import Tensor
from ..core import dtype as dtypes


class _GradClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByGlobalNorm(_GradClipBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for _, g in params_grads))
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype)) for p, g in params_grads]


class Optimizer:
    """Base: the learning rate (a float), weight decay, clipping,
    per-parameter state and its state_dict."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError(
                "parameters=None: pass model.parameters() (the static-graph "
                "global-collection mode is not supported; eager only)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers arrive with the rest of the eager "
                "API (optimizer/lr.py); pass a float")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "L1Decay/L2Decay objects arrive with the rest of the eager "
                "API; pass a float coefficient")
        if multi_precision:
            raise NotImplementedError(
                "master weights (multi_precision) arrive with amp.decorate "
                "(O2) in the rest of the eager API")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    def get_lr(self) -> float:
        return float(self._learning_rate)

    # -- state ---------------------------------------------------------------
    def _param_state(self, p: Tensor) -> Dict[str, torch.Tensor]:
        st = self._state.get(id(p))
        if st is None:
            st = self._state[id(p)] = self._init_state(p)
        return st

    def _init_state(self, p: Tensor) -> Dict[str, torch.Tensor]:
        return {}

    # -- the update ----------------------------------------------------------
    def _update(self, value, grad, state, lr, lr_mult, wd):
        """(param value, grad in its dtype, state, f32 lr, lr multiplier,
        f32 decay coefficient) → (new value, new state)."""
        raise NotImplementedError

    def _decay_info(self, p: Optional[Tensor]) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None and p is not None and not fn(p.name):
            return 0.0
        return float(wd)

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p._data.grad) for p in self._parameter_list
                        if p._data.grad is not None and not p.stop_gradient]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        scalars: Dict = {}

        def f32(v, dev):
            # the f32 scalars the JAX step passes its jitted update
            key = (v, dev)
            if key not in scalars:
                scalars[key] = torch.tensor(v, dtype=torch.float32,
                                            device=dev)
            return scalars[key]

        for p, g in params_grads:
            lr_mult = p.optimize_attr.get("learning_rate", 1.0) \
                if hasattr(p, "optimize_attr") else 1.0
            value, dev = p._data, p._data.device
            new_value, self._state[id(p)] = self._update(
                value, g.to(value.dtype), self._param_state(p),
                f32(lr, dev), lr_mult, f32(self._decay_info(p), dev))
            value.copy_(new_value)
        self._step_count += 1

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.clear_grad()

    clear_gradients = clear_grad

    # -- persistence ----------------------------------------------------------
    def state_dict(self):
        """The moments by parameter name (`{name}.{key}`), and the step."""
        out = {"_step_count": self._step_count}
        for p in self._parameter_list:
            st = self._state.get(id(p))
            if st:
                for k, v in st.items():
                    out[f"{p.name}.{k}"] = Tensor(v)
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("_step_count", 0))
        for p in self._parameter_list:
            st = {}
            for k, v in state.items():
                if isinstance(k, str) and k.startswith(p.name + "."):
                    t = v._data if isinstance(v, Tensor) else \
                        Tensor(v)._data
                    st[k[len(p.name) + 1:]] = t.to(p._data.device).clone()
            if st:
                self._state[id(p)] = st


class Adam(Optimizer):
    """paddle Adam: weight_decay is L2 regularization (coupled)."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False, **kw):
        if amsgrad:
            raise NotImplementedError(
                "amsgrad arrives with the rest of the eager API")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        dt = torch.float32 if p.dtype in (dtypes.float16, dtypes.bfloat16) \
            else p.dtype
        dev = p._data.device
        return {"moment1": torch.zeros(p.shape, dtype=dt, device=dev),
                "moment2": torch.zeros(p.shape, dtype=dt, device=dev),
                "beta1_pow": torch.ones((), dtype=torch.float32, device=dev),
                "beta2_pow": torch.ones((), dtype=torch.float32, device=dev)}

    def _update(self, value, grad, state, lr, lr_mult, wd):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        if not self._decoupled:
            grad = grad + wd * value
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * torch.square(grad)
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        step = lr * lr_mult * m1_hat / (torch.sqrt(m2_hat) + eps)
        if self._decoupled:
            step = step + lr * lr_mult * wd * value
        return value - step, {"moment1": m1, "moment2": m2,
                              "beta1_pow": b1p, "beta2_pow": b2p}


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
