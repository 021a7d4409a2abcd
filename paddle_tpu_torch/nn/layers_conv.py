"""Conv, pool and norm layers — port of paddle_tpu/nn/layers_conv.py:
Conv1D-3D and their transposes, every pool layer, LayerNorm, BatchNorm
with BatchNorm1D/2D/3D, GroupNorm and InstanceNorm1D/2D/3D, over the
functionals of nn/functional/conv.py and norm.py. BatchNorm keeps its
running statistics as buffers named `_mean` and `_variance`, as the JAX
package does, so a JAX `state_dict()` carries across as numpy.
SyncBatchNorm (batch statistics across GPUs) belongs to the multi-GPU
slice and raises. RMSNorm runs F.rms_norm's plain route, as in the JAX
package; SpectralNorm keeps its power-iteration vector as the buffer
`weight_u`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import _device
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor
from .layer import Layer
from . import functional as F
from . import initializer as I


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, (int, np.integer)) else \
        tuple(int(x) for x in v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, ndim,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, ndim)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._transpose = transpose
        self._output_padding = output_padding
        self._ndim = ndim
        if transpose:
            wshape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            wshape = [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in,
                                                 negative_slope=np.sqrt(5.0),
                                                 nonlinearity="leaky_relu"))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._dilation, self._groups,
                                  output_size, self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._dilation, self._groups,
                                  output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._dilation, self._groups,
                                  output_size, self._data_format)


# ---- pooling layers --------------------------------------------------------

class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p, self.return_mask,
                            self.ceil_mode)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.return_mask,
                            self.ceil_mode, self.data_format)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.ceil_mode = exclusive, ceil_mode

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.exclusive,
                            self.ceil_mode)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.ceil_mode = exclusive, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.exclusive, None, self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


# ---- norm layers -----------------------------------------------------------

class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", Tensor(torch.zeros(
            [num_features], dtype=self._dtype, device=_device())))
        self.register_buffer("_variance", Tensor(torch.ones(
            [num_features], dtype=self._dtype, device=_device())))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch statistics reduced across GPUs: the JAX package gets them
    from XLA's cross-replica reduce under a mesh; here they need the
    multi-GPU slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm is not ported yet: statistics across GPUs come "
            "with the multi-GPU slice (ROADMAP.md Queue 1 item 8); use "
            "BatchNorm2D on one GPU")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError(
            "SyncBatchNorm is not ported yet: it comes with the multi-GPU "
            "slice (ROADMAP.md Queue 1 item 8)")


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """Normalizes an incoming weight by its largest singular value,
    estimated by power iteration whose left singular vector persists
    across forwards as the buffer `weight_u` (state_dict carries it)."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", name=None):
        super().__init__()
        self.axis, self.power_iters, self.eps = axis, power_iters, epsilon
        h = weight_shape[axis]
        self.register_buffer("weight_u", Tensor(torch.full(
            (h,), 1.0 / np.sqrt(h), dtype=convert_dtype(dtype),
            device=_device())))

    def forward(self, weight):
        out, u_new = F.spectral_norm(
            weight, axis=self.axis, power_iters=self.power_iters,
            epsilon=self.eps, u=self.weight_u)
        self.weight_u.set_value(u_new)  # the persistent iteration state
        return out


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask = return_mask
        self.ceil_mode, self.data_format = ceil_mode, data_format

    def forward(self, x):
        return F.max_pool3d(x, self.k, self.s, self.p, self.return_mask,
                            self.ceil_mode, self.data_format)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.ceil_mode = exclusive, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool3d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.exclusive, None, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class MaxUnPool1D(Layer):
    """Inverse of MaxPool1D(return_mask=True) — reference nn.MaxUnPool1D
    over the phi unpool kernel."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.data_format, self.output_size = data_format, output_size

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, self.k, self.s, self.p,
                              self.data_format, self.output_size)


class MaxUnPool2D(MaxUnPool1D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.k, self.s, self.p,
                              self.data_format, self.output_size)


class MaxUnPool3D(MaxUnPool1D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, self.k, self.s, self.p,
                              self.data_format, self.output_size)


class LPPool1D(Layer):
    """paddle.nn.LPPool1D (3.0) — Lp-norm pooling."""

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self._a = (norm_type, kernel_size, stride, padding, ceil_mode,
                   data_format)

    def forward(self, x):
        from .functional.conv import lp_pool1d
        n, k, s, p, c, df = self._a
        return lp_pool1d(x, n, k, s, p, c, df)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self._a = (norm_type, kernel_size, stride, padding, ceil_mode,
                   data_format)

    def forward(self, x):
        from .functional.conv import lp_pool2d
        n, k, s, p, c, df = self._a
        return lp_pool2d(x, n, k, s, p, c, df)


class FractionalMaxPool2D(Layer):
    """paddle.nn.FractionalMaxPool2D (3.0)."""

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        from .functional.conv import fractional_max_pool2d
        o, k, u, m = self._a
        return fractional_max_pool2d(x, o, k, u, m)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        from .functional.conv import fractional_max_pool3d
        o, k, u, m = self._a
        return fractional_max_pool3d(x, o, k, u, m)
