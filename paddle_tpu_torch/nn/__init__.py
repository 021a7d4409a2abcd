"""paddle_tpu_torch.nn — the layers and functionals of the eager API.

Port of paddle_tpu/nn/, every public name of it but two: `quant`
(its layers import `paddle_tpu.quantization`, ROADMAP.md Queue 1 item
7) and `DataParallel` (item 8). The layer zoo of `layers_common`,
`layers_conv`, `layers_act_loss`, `layers_rnn` and
`layers_transformer`, BeamSearchDecoder and dynamic_decode, the
grad-clip classes, `utils` (clip_grad_norm_, clip_grad_value_,
parameters_to_vector, vector_to_parameters, weight_norm,
remove_weight_norm, spectral_norm) and `nn.functional`.
"""
from .layer import Layer, ParamAttr  # noqa: F401
from . import initializer  # noqa: F401
from . import functional  # noqa: F401
from . import functional as F  # noqa: F401
from .layers_common import (  # noqa: F401
    Identity, Linear, Embedding, Dropout, Dropout2D, Dropout3D, AlphaDropout,
    FeatureAlphaDropout,
    Flatten, Unflatten, Upsample, UpsamplingBilinear2D, UpsamplingNearest2D,
    PixelShuffle, PixelUnshuffle, ChannelShuffle, Pad1D, Pad2D, Pad3D,
    ZeroPad2D, ZeroPad1D, ZeroPad3D, CosineSimilarity, PairwiseDistance,
    Sequential, LayerList, ParameterList, LayerDict, Bilinear, Fold, Unfold,
)
from .layers_conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose, MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
    AvgPool3D, AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D, LPPool1D, LPPool2D, FractionalMaxPool2D,
    FractionalMaxPool3D, LayerNorm, RMSNorm, BatchNorm, BatchNorm1D,
    BatchNorm2D, BatchNorm3D, SyncBatchNorm, GroupNorm, InstanceNorm1D,
    InstanceNorm2D, InstanceNorm3D, LocalResponseNorm, SpectralNorm)
from .layers_act_loss import (  # noqa: F401
    ReLU, ReLU6, GELU, SiLU, Silu, Swish, ELU, SELU, CELU, LeakyReLU,
    Hardshrink, Softshrink, Tanhshrink, Hardtanh, Hardsigmoid, Hardswish,
    Mish, Softplus, Softsign, LogSigmoid, Tanh, Sigmoid, LogSoftmax, Softmax,
    Softmax2D, Maxout, PReLU, ThresholdedReLU, RReLU, GLU,
    CrossEntropyLoss, MSELoss, L1Loss, NLLLoss, BCELoss, BCEWithLogitsLoss,
    SmoothL1Loss, KLDivLoss, MarginRankingLoss, TripletMarginLoss,
    TripletMarginWithDistanceLoss, CosineEmbeddingLoss, HingeEmbeddingLoss,
    HuberLoss, SoftMarginLoss, MultiLabelSoftMarginLoss, MultiMarginLoss,
    PoissonNLLLoss, GaussianNLLLoss, CTCLoss, RNNTLoss,
    AdaptiveLogSoftmaxWithLoss, HSigmoidLoss, GumbelSoftmax,
)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
# grad-clip classes live in paddle.nn too (reference re-export)
from ..optimizer.optimizers import (ClipGradByGlobalNorm,  # noqa: F401
                                    ClipGradByNorm, ClipGradByValue)
from .layers_transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoderLayer, TransformerEncoder,
    TransformerDecoderLayer, TransformerDecoder, Transformer,
)
from . import layers_transformer  # noqa: F401
from .layers_rnn import (  # noqa: F401
    SimpleRNNCell, LSTMCell, GRUCell, SimpleRNN, LSTM, GRU, RNN, BiRNN,
    RNNCellBase,
)


def utils_clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Scale every gradient by min(max_norm / (‖g‖ + 1e-6), 1) in place,
    the norm taken over all of them (paddle_tpu/nn/__init__.py:56).
    Returns the norm as a 0-d f32 Tensor; nothing is read on the host."""
    import torch
    from ..core.device import _device
    from ..core.tensor import Tensor

    grads = [p._data.grad for p in parameters if p.grad is not None]
    if not grads:
        return Tensor(torch.zeros((), dtype=torch.float32,
                                  device=_device()))
    if norm_type == 2.0:
        total = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(torch.abs(g), norm_type))
                              for g in grads), 1.0 / norm_type)
    clip = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(clip.to(g.dtype))
    return Tensor(total)


def _norm_except(v, axes):
    """‖v‖₂ over `axes` (kept as size 1), or over every element."""
    import torch
    from ..ops._registry import eager
    return eager(lambda a: torch.sqrt(torch.sum(a * a, dim=axes,
                                                keepdim=True))
                 if axes is not None else torch.sqrt(torch.sum(a * a)),
                 (v,), {}, name="norm")


class _Utils:
    clip_grad_norm_ = staticmethod(utils_clip_grad_norm_)

    @staticmethod
    def clip_grad_value_(parameters, clip_value):
        for p in parameters:
            if p.grad is not None:
                p._data.grad.clamp_(-clip_value, clip_value)

    @staticmethod
    def parameters_to_vector(parameters):
        from ..ops.manipulation import concat
        return concat([p.flatten() for p in parameters], axis=0)

    @staticmethod
    def vector_to_parameters(vec, parameters):
        offset = 0
        for p in parameters:
            n = p.size
            p.set_value(vec[offset:offset + n].reshape(p.shape))
            offset += n

    @staticmethod
    def weight_norm(layer, name="weight", dim=0):
        """Reparameterize `name` as the magnitude name_g times the
        direction name_v / ‖name_v‖, recomputed by a forward pre-hook at
        every call, so an optimizer trains g and v."""
        from ..core.tensor import Parameter
        w = getattr(layer, name)
        if dim is None:
            axes = None
        else:
            d = dim % w.ndim
            axes = tuple(a for a in range(w.ndim) if a != d)
        g = Parameter(_norm_except(w, axes)._data.detach())
        v = Parameter(w._data.detach())
        del layer._parameters[name]
        layer.add_parameter(name + "_g", g)
        layer.add_parameter(name + "_v", v)

        def compute(lyr, *unused):
            vv = getattr(lyr, name + "_v")
            gg = getattr(lyr, name + "_g")
            setattr(lyr, name, vv * (gg / _norm_except(vv, axes)))

        compute(layer)
        handle = layer.register_forward_pre_hook(
            lambda lyr, inputs: compute(lyr))
        layer._weight_norm_hooks = getattr(layer, "_weight_norm_hooks", {})
        layer._weight_norm_hooks[name] = (handle, compute)
        return layer

    @staticmethod
    def remove_weight_norm(layer, name="weight"):
        """Fold name_g and name_v back into a plain `name` parameter."""
        from ..core.tensor import Parameter
        handle, compute = layer._weight_norm_hooks.pop(name)
        handle.remove()
        # from the live g and v: the cached weight predates any step
        # taken since the last forward
        compute(layer)
        w = getattr(layer, name)
        # the cached attribute would shadow the re-added Parameter
        layer.__dict__.pop(name, None)
        del layer._parameters[name + "_g"]
        del layer._parameters[name + "_v"]
        layer.add_parameter(name, Parameter(w._data.detach()))
        return layer

    @staticmethod
    def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                      dim=0):
        """Divide `name` by its largest singular value at every forward
        (power iteration from the persistent buffer name_u)."""
        import numpy as np
        import torch
        from ..core.tensor import Tensor
        from . import functional as F
        w = getattr(layer, name)
        h = w.shape[dim % w.ndim]
        layer.register_buffer(name + "_u", Tensor(torch.full(
            (h,), 1.0 / np.sqrt(h), dtype=w.dtype, device=w._data.device)))
        orig = layer._parameters.pop(name)
        layer.add_parameter(name + "_orig", orig)

        def compute(lyr, *unused):
            wn, u_new = F.spectral_norm(
                getattr(lyr, name + "_orig"), axis=dim,
                power_iters=n_power_iterations, epsilon=eps,
                u=getattr(lyr, name + "_u"))
            getattr(lyr, name + "_u").set_value(u_new)
            setattr(lyr, name, wn)

        compute(layer)
        layer.register_forward_pre_hook(lambda lyr, inputs: compute(lyr))
        return layer


utils = _Utils()
