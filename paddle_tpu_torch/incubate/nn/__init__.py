"""paddle.incubate.nn — the fused layers of the eager path.

Port of paddle_tpu/incubate/nn/__init__.py: `FusedRMSNorm` (:18),
`FusedLayerNorm` (:34), `FusedLinear` (:52), `FusedDropoutAdd` (:70) and
`FusedBiasDropoutResidualLayerNorm` (:86), each over its functional in
`incubate.nn.functional`. `FusedMultiHeadAttention` and the transformer
layers arrive with the rest of the eager API.
"""
from . import functional  # noqa: F401
from ...nn.layer import Layer
from ...nn import initializer as I


class FusedRMSNorm(Layer):
    """RMS normalization over the last axis with a learned gain, through
    `functional.fused_rms_norm` (the row-6 kernel on the card)."""

    def __init__(self, hidden_size, epsilon=1e-6, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=I.Constant(1.0))
        self._eps = epsilon

    def forward(self, x):
        return functional.fused_rms_norm(x, self.weight, epsilon=self._eps)


class FusedLayerNorm(Layer):
    """LayerNorm with learned gain and bias through the fused
    `functional.fused_layer_norm` kernels."""

    def __init__(self, hidden_size, epsilon=1e-5, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [hidden_size], default_initializer=I.Constant(0.0))
        self._eps = epsilon

    def forward(self, x):
        return functional.fused_layer_norm(x, self.weight, self.bias,
                                           epsilon=self._eps)


class FusedLinear(Layer):
    """Linear layer over `functional.fused_linear`; `bias_attr=False`
    drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self.weight = self.create_parameter([in_features, out_features])
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], default_initializer=I.Constant(0.0))
        self._tw = transpose_weight

    def forward(self, x):
        return functional.fused_linear(x, self.weight, self.bias, self._tw)


class FusedDropoutAdd(Layer):
    """dropout(x) + y — the transformer residual pattern."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self._p = p
        self._mode = mode

    def forward(self, x, y):
        return functional.fused_dropout_add(
            x, y, p=self._p, training=self.training, mode=self._mode)


class FusedBiasDropoutResidualLayerNorm(Layer):
    """The attention-output epilogue:
    layer_norm(dropout(x + linear_bias) + residual) with learned LN
    scale and bias."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 name=None, **kw):
        super().__init__()
        self.linear_bias = self.create_parameter(
            [embed_dim], default_initializer=I.Constant(0.0))
        self.ln_scale = self.create_parameter(
            [embed_dim], default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter(
            [embed_dim], default_initializer=I.Constant(0.0))
        self._p = dropout_rate
        self._eps = epsilon

    def forward(self, x, residual):
        y = functional.fused_dropout_add(
            x + self.linear_bias, residual, p=self._p,
            training=self.training)
        return functional.fused_layer_norm(
            y, self.ln_scale, self.ln_bias, epsilon=self._eps)
