"""paddle_tpu_torch.nn — the layers and functionals of the eager API.

Port of paddle_tpu/nn/, holding what the eager training paths use:
`Layer`/`ParamAttr`, the initializers, Linear, Embedding, Dropout,
Sequential, LayerList, the convolutions, pools and norms of
`layers_conv` (LayerNorm, BatchNorm*, GroupNorm, InstanceNorm*), the
recurrent cells and layers of `layers_rnn`, BeamSearchDecoder and
dynamic_decode, ReLU, GELU, SiLU, Tanh, CrossEntropyLoss and the
functionals of `nn.functional`. The rest of the layer zoo (transformer
layers, the other losses) arrives with later slices (ROADMAP.md
Queue 1)."""
from .layer import Layer, ParamAttr  # noqa: F401
from . import initializer  # noqa: F401
from . import functional  # noqa: F401
from . import functional as F  # noqa: F401
from .layers_common import (Linear, Embedding, Dropout,  # noqa: F401
                            Sequential, LayerList)
from .layers_conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose, MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
    AvgPool3D, AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D, LPPool1D, LPPool2D, FractionalMaxPool2D,
    FractionalMaxPool3D, LayerNorm, BatchNorm, BatchNorm1D, BatchNorm2D,
    BatchNorm3D, SyncBatchNorm, GroupNorm, InstanceNorm1D, InstanceNorm2D,
    InstanceNorm3D)
from .layers_rnn import (  # noqa: F401
    SimpleRNNCell, LSTMCell, GRUCell, SimpleRNN, LSTM, GRU, RNN, BiRNN,
    RNNCellBase)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .layers_act_loss import (ReLU, GELU, SiLU, Silu, Tanh,  # noqa: F401
                              CrossEntropyLoss)
# grad-clip classes live in paddle.nn too (reference re-export)
from ..optimizer.optimizers import (ClipGradByGlobalNorm,  # noqa: F401
                                    ClipGradByNorm, ClipGradByValue)
