"""Loss functionals — port of paddle_tpu/nn/functional/loss.py (:59
cross_entropy, with hard labels; soft labels, class weights and label
smoothing arrive with the rest of the eager API)."""
from __future__ import annotations

import torch

from ...ops._registry import as_array, eager


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def _xent_raw(logits, label, ignore_index=-100, reduction="mean",
              axis=-1):
    logp = torch.log_softmax(logits, dim=axis)
    lbl = label.to(logits.device)
    if lbl.ndim == logits.ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.to(torch.int64)
    mask = lbl != ignore_index
    safe = torch.where(mask, lbl, 0)
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(mask, -picked, 0.0)
    if reduction == "mean":
        denom = torch.clamp(torch.sum(mask.to(loss.dtype)), min=1.0)
        return torch.sum(loss) / denom
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    if weight is not None or soft_label or label_smoothing > 0.0:
        raise NotImplementedError(
            "cross_entropy: class weights, soft labels and label smoothing "
            "arrive with the rest of the eager API")
    lbl = as_array(label)
    return eager(lambda x: _xent_raw(x, lbl, ignore_index, reduction, axis),
                 (input,), {}, name="cross_entropy")
