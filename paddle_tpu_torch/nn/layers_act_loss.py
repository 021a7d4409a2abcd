"""Activation and loss layers — port of paddle_tpu/nn/layers_act_loss.py
(ReLU, GELU, SiLU/Silu, Tanh, CrossEntropyLoss :77)."""
from __future__ import annotations

from .layer import Layer
from . import functional as F


def _act_layer(fname, **fixed):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            # positional args map onto the functional's keyword order
            self._kwargs = dict(fixed)
            self._args = args
            self._kwargs.update({k: v for k, v in kwargs.items()
                                 if k != "name"})

        def forward(self, x):
            return getattr(F, fname)(x, *self._args, **self._kwargs)

    _Act.__name__ = "".join(p.capitalize() for p in fname.split("_"))
    return _Act


ReLU = _act_layer("relu")
GELU = _act_layer("gelu")
SiLU = _act_layer("silu")
Silu = SiLU  # paddle spells it Silu; keep both
Tanh = _act_layer("tanh")


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
