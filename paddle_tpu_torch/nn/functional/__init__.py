"""paddle_tpu_torch.nn.functional — the functional namespace (F.*) of
the eager API: port of paddle_tpu/nn/functional/, holding the functions
the eager path uses, and the in-place twins of the activations
(`relu_`, `gelu_`, `silu_`, `swish_`, `tanh_`: `ops.attach_inplace`)."""
from .activation import (relu, gelu, silu, swish, tanh,  # noqa: F401
                         log_softmax)
from .common import linear, dropout, embedding  # noqa: F401
from .norm import (layer_norm, rms_norm, batch_norm,  # noqa: F401
                   group_norm, instance_norm)
from .loss import cross_entropy  # noqa: F401
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        flash_attention)
from .conv import (conv1d, conv2d, conv3d, conv1d_transpose,  # noqa: F401
                   conv2d_transpose, conv3d_transpose, max_pool1d,
                   max_pool2d, max_pool3d, avg_pool1d, avg_pool2d,
                   avg_pool3d, adaptive_avg_pool1d, adaptive_avg_pool2d,
                   adaptive_avg_pool3d, adaptive_max_pool1d,
                   adaptive_max_pool2d, adaptive_max_pool3d, max_unpool1d,
                   max_unpool2d, max_unpool3d, lp_pool1d, lp_pool2d,
                   fractional_max_pool2d, fractional_max_pool3d)

from ...ops import attach_inplace as _attach_inplace  # noqa: E402

INPLACE_OPS = _attach_inplace(globals())
