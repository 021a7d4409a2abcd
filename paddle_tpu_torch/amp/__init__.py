"""AMP — auto_cast with the JAX package's O1/O2 lists.

Port of paddle_tpu/amp/__init__.py (:27-87). auto_cast is a thread-local
policy that the eager dispatch (ops/_registry.eager) consults to cast the
float inputs of each op: an explicit cast per op by name, not
torch.autocast, so every op's output dtype is the JAX package's. Under O1
the white-list ops (`linear`, `sdpa`, ...) run in the AMP dtype, the
black-list ops (`cross_entropy`, `mean`, ...) in f32, and every other op
(`add`, `fused_dropout_add`, `fused_layer_norm`, ...) follows its inputs:
a bf16 + f32 residual gives f32. `decorate` (O2 master weights) and
`GradScaler` arrive with the rest of the eager API.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from ..core import dtype as dtypes

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
