"""Activation and loss layers — port of paddle_tpu/nn/layers_act_loss.py,
the whole file: every activation and loss layer of
paddle_tpu/nn/__init__.py:27-37, each over its functional in
`nn.functional`. PReLU's slope, HSigmoidLoss's weight and bias and
AdaptiveLogSoftmaxWithLoss's head and tail projections are parameters.
"""
from __future__ import annotations

import torch

from .layer import Layer
from . import functional as F
from . import initializer as I
from ..ops._registry import as_array, eager


def _act_layer(fname, **fixed):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            # positional args map onto the functional's keyword order
            self._kwargs = dict(fixed)
            self._args = args
            self._kwargs.update({k: v for k, v in kwargs.items() if k != "name"})

        def forward(self, x):
            return getattr(F, fname)(x, *self._args, **self._kwargs)

    _Act.__name__ = "".join(p.capitalize() for p in fname.split("_"))
    return _Act


ReLU = _act_layer("relu")
ReLU6 = _act_layer("relu6")
GELU = _act_layer("gelu")
SiLU = _act_layer("silu")
Swish = _act_layer("swish")
ELU = _act_layer("elu")
SELU = _act_layer("selu")
CELU = _act_layer("celu")
LeakyReLU = _act_layer("leaky_relu")
Hardshrink = _act_layer("hardshrink")
Softshrink = _act_layer("softshrink")
Tanhshrink = _act_layer("tanhshrink")
Hardtanh = _act_layer("hardtanh")
Hardsigmoid = _act_layer("hardsigmoid")
Hardswish = _act_layer("hardswish")
Mish = _act_layer("mish")
Softplus = _act_layer("softplus")
Softsign = _act_layer("softsign")
LogSigmoid = _act_layer("log_sigmoid")
Tanh = _act_layer("tanh")
Sigmoid = _act_layer("sigmoid")
LogSoftmax = _act_layer("log_softmax")
Maxout = _act_layer("maxout")
ThresholdedReLU = _act_layer("thresholded_relu")


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


# ---- loss layers -----------------------------------------------------------

class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.weight,
                                                  self.reduction,
                                                  self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p, self.epsilon, self.swap = margin, p, epsilon, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin, self.reduction)


GLU = _act_layer("glu")
Silu = SiLU  # paddle spells it Silu; keep both


class RReLU(Layer):
    """Randomized leaky ReLU: slope ~ U(lower, upper) in training, the mean
    slope in eval."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW inputs."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class HuberLoss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.huber_loss(input, label, self.delta, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self.args)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__()
        self.args = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, *self.args)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean", name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class TripletMarginWithDistanceLoss(Layer):
    """The layer's default distance is the euclidean one with nothing
    under the root (the functional's has 1e-12), as in the JAX
    package."""

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        dist = self.distance_function or (
            lambda a, b: F.loss._euclidean(a, b, 0.0))
        return F.loss._triplet_with_distance(
            dist, input, positive, negative, self.margin, self.swap,
            self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax (Grave et al.): the frequent classes in the head,
    the rare ones in down-projected tail clusters; the head and each
    cluster's two projections are Linear layers (their weights the
    parameters)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if not cutoffs or cutoffs != sorted(cutoffs) or \
                cutoffs[-1] >= n_classes:
            raise ValueError("cutoffs must be increasing ints < n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.cutoffs[0] + self.n_clusters
        from . import layers_common as LC
        self.head = LC.Linear(in_features, self.head_size,
                              bias_attr=head_bias if head_bias else False)
        self.tail = LC.LayerList()
        for i in range(self.n_clusters):
            hsz = int(in_features // (div_value ** (i + 1)))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            self.tail.append(LC.Sequential(
                LC.Linear(in_features, max(hsz, 1), bias_attr=False),
                LC.Linear(max(hsz, 1), osz, bias_attr=False)))

    def _full_log_prob(self, input):
        def raw(head_out, *tails):
            head_logp = torch.log_softmax(head_out, dim=-1)
            c0 = self.cutoffs[0]
            pieces = [head_logp[:, :c0]]
            for i, t in enumerate(tails):
                pieces.append(torch.log_softmax(t, dim=-1)
                              + head_logp[:, c0 + i:c0 + i + 1])
            return torch.cat(pieces, dim=-1)

        return eager(raw, (self.head(input),
                           *[t(input) for t in self.tail]), {},
                     name="adaptive_log_prob")

    def forward(self, input, label):
        """(the target log-probabilities [N], the mean NLL): the head's
        entry, or each label's own cluster entry plus its gate; the
        [N, n_classes] matrix is never formed."""
        sizes = [self.cutoffs[i + 1] - self.cutoffs[i]
                 for i in range(self.n_clusters)]
        lbl = as_array(label)
        return eager(lambda h, *t: F.loss._adaptive_raw(
            lbl, self.cutoffs, sizes, h, *t),
            (self.head(input), *[t(input) for t in self.tail]), {},
            name="adaptive_log_softmax_with_loss")

    def log_prob(self, input):
        return self._full_log_prob(input)

    def predict(self, input):
        return eager(lambda lp: torch.argmax(lp, dim=-1),
                     (self._full_log_prob(input),), {}, name="argmax")


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid loss: a learned binary tree over the
    classes, O(log C) a sample instead of a full softmax, over the
    default complete binary tree (a custom tree raises, as in the JAX
    package). weight [C-1, D] and bias [C-1] are parameters."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError(
                "custom-tree HSigmoidLoss is not supported (the default "
                "complete binary tree only)")
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size), attr=weight_attr)
        self.bias = (None if bias_attr is False else self.create_parameter(
            (num_classes - 1,), attr=bias_attr, is_bias=True))

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)


class GumbelSoftmax(Layer):
    """The layer form of F.gumbel_softmax."""

    def __init__(self, temperature=1.0, hard=False, axis=-1, name=None):
        super().__init__()
        self._temperature = temperature
        self._hard = hard
        self._axis = axis

    def forward(self, x):
        return F.gumbel_softmax(x, temperature=self._temperature,
                                hard=self._hard, axis=self._axis)


class RNNTLoss(Layer):
    """The RNN-Transducer loss (F.rnnt_loss)."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, self.fastemit_lambda, self.reduction)
