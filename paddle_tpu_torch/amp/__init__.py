"""AMP — auto_cast with the JAX package's O1/O2 lists, decorate (O2 master
weights) and GradScaler (dynamic loss scaling).

Port of paddle_tpu/amp/__init__.py (:27-212). auto_cast is a thread-local
policy that the eager dispatch (ops/_registry.eager) consults to cast the
float inputs of each op: an explicit cast per op by name, not
torch.autocast, so every op's output dtype is the JAX package's. Under O1
the white-list ops (`linear`, `sdpa`, ...) run in the AMP dtype, the
black-list ops (`cross_entropy`, `mean`, ...) in f32, and every other op
(`add`, `fused_dropout_add`, `fused_layer_norm`, ...) follows its inputs:
a bf16 + f32 residual gives f32. Under O2 every op off the black list
runs in the AMP dtype.

`decorate` casts a model's floating parameters to the AMP dtype in place
(each Parameter keeps its identity, so an optimizer built before keeps
its list) and turns on the optimizer's master weights
(`multi_precision`): an f32 copy made from the cast value at the first
step, as the JAX package makes it. `GradScaler` keeps the JAX package's
schedule (scale, good and bad counters, `incr_every_n_steps`,
`decr_every_n_nan_or_inf`, a floor of 1.0; `step()` calls `update()`).
Its unscale and inf/nan check is one multi-tensor pass per (device,
dtype) group of gradients and one host read a step, where the JAX
package reads each gradient's finiteness on the host: the same values,
fewer syncs (a recorded divergence).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor

# O1 lists — the JAX package's, unchanged
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "sdpa", "flash_attention", "addmm",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "cross_entropy",
    "softmax_with_cross_entropy", "mean", "sum", "cumsum", "softmax",
    "log_softmax", "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "rms_norm", "norm", "dist", "cosine_similarity", "pow", "square",
    "mse_loss", "nll_loss", "binary_cross_entropy", "bce_with_logits",
    "kl_div",
}

_state = threading.local()


def _amp_state():
    if not hasattr(_state, "enabled"):
        _state.enabled = False
        _state.dtype = dtypes.bfloat16
        _state.level = "O1"
        _state.custom_white = set()
        _state.custom_black = set()
    return _state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    st = _amp_state()
    prev = (st.enabled, st.dtype, st.level, st.custom_white, st.custom_black)
    st.enabled = bool(enable)
    st.dtype = dtypes.convert_dtype(dtype)
    st.level = level
    st.custom_white = set(custom_white_list or ())
    st.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.dtype, st.level, st.custom_white,
         st.custom_black) = prev


amp_guard = auto_cast


def amp_dtype_for_op(op_name: str) -> Optional[torch.dtype]:
    """Consulted by the eager dispatcher: the dtype to cast an op's float
    inputs to, or None to leave them alone."""
    st = _amp_state()
    if not st.enabled:
        return None
    if st.level == "O2":
        if op_name in BLACK_LIST or op_name in st.custom_black:
            return dtypes.float32
        return st.dtype
    white = (WHITE_LIST | st.custom_white) - st.custom_black
    if op_name in white:
        return st.dtype
    if op_name in (BLACK_LIST | st.custom_black):
        return dtypes.float32
    return None


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: every floating parameter of `models` cast to `dtype` (the
    leaf's tensor rebound, the Parameter kept); each optimizer keeps f32
    master weights (`_multi_precision`, or `master_weight` when given).
    As in the JAX package the cast does not depend on `level`. Returns
    `models`, or (models, optimizers) when optimizers are given."""
    from ..nn.layer import _rebind_leaf
    d = dtypes.convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    for m in model_list:
        if m is None:
            continue
        for _, p in m.named_parameters():
            if p._data.is_floating_point() and p._data.dtype != d:
                _rebind_leaf(p, p._data.to(d))
    opt_list = optimizers if isinstance(optimizers, (list, tuple)) \
        else [optimizers]
    for o in opt_list:
        if o is not None:
            o._multi_precision = True if master_weight is None \
                else bool(master_weight)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (paddle_tpu/amp/__init__.py:109-204): the loss
    is multiplied by the scale before backward; `unscale_` divides the
    gradients by it once per cycle and finds whether any is inf or nan;
    `step` skips the optimizer's step on such a cycle; `update` halves
    the scale (down to 1.0) after `decr_every_n_nan_or_inf` bad cycles in
    a row and doubles it after `incr_every_n_steps` good ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = set()  # ids of optimizers already unscaled

    def scale(self, var: Tensor) -> Tensor:
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient of `optimizer` by the scale, in place and
        in its dtype, and record whether any is inf or nan: one
        multi-tensor launch per (device, dtype) group and one host read.
        Idempotent within a cycle: unscale_ then step() divides once."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        groups = {}
        for p in optimizer._parameter_list:
            g = p._data.grad
            if g is not None:
                groups.setdefault((g.device, g.dtype), []).append(g)
        found = []
        for (dev, _), grads in groups.items():
            f = torch.zeros(1, dtype=torch.float32, device=dev)
            inv = torch.full((1,), 1.0 / self._scale, dtype=torch.float32,
                             device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, f, inv)
            found.append(f)
        self._found_inf = bool(found) and bool(
            sum(f.to(found[0].device) for f in found).item())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled.discard(id(optimizer))
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

    set_state_dict = load_state_dict


def is_bfloat16_supported(place=None):
    return True


def is_float16_supported(place=None):
    return True
