"""paddle_tpu_torch.nn — the layers and functionals of the eager API.

Port of paddle_tpu/nn/, holding what the eager training path uses:
`Layer`/`ParamAttr`, the initializers, Linear, Embedding, Dropout,
Sequential, LayerList, LayerNorm, ReLU, GELU, SiLU, Tanh,
CrossEntropyLoss and the functionals of `nn.functional`. The rest of the
layer zoo (convs, pools, RNNs, transformer layers, the other losses)
arrives with later slices (ROADMAP.md Queue 1)."""
from .layer import Layer, ParamAttr  # noqa: F401
from . import initializer  # noqa: F401
from . import functional  # noqa: F401
from . import functional as F  # noqa: F401
from .layers_common import (Linear, Embedding, Dropout,  # noqa: F401
                            Sequential, LayerList)
from .layers_conv import LayerNorm  # noqa: F401
from .layers_act_loss import (ReLU, GELU, SiLU, Silu, Tanh,  # noqa: F401
                              CrossEntropyLoss)
# grad-clip classes live in paddle.nn too (reference re-export)
from ..optimizer.optimizers import ClipGradByGlobalNorm  # noqa: F401
