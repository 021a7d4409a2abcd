"""paddle_tpu_torch.nn.functional — the functional namespace (F.*) of
the eager API: port of paddle_tpu/nn/functional/, holding the functions
the eager path uses."""
from .activation import relu, gelu, silu, swish, tanh  # noqa: F401
from .common import linear, dropout, embedding  # noqa: F401
from .norm import layer_norm, rms_norm  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        flash_attention)
