"""Loss functionals — port of paddle_tpu/nn/functional/loss.py, the whole
file (the `margin_cross_entropy` of one program: `group` is accepted and
not used, as in the JAX package).

Each is the JAX package's expression in torch, so values and gradients
agree to f32 rounding. Where the port does what Paddle documents instead
(recorded in ROADMAP.md Queue 3):

  * `cross_entropy` with class weights divides the mean by the sum of
    the weights of the rows not ignored, for a [N] label and a [N, 1]
    label alike; the JAX package takes weight[0] for every row of a
    [N, 1] label (`_xent_raw`, :52-55). With soft labels the weights
    apply as Paddle documents (each row weighted by label · weight, the
    mean divided by their sum); the JAX package drops them.
  * `softmax_with_cross_entropy` keeps the label axis for a [N, 1] label
    and for soft labels too; the JAX package drops it there.

`ctc_loss` and `rnnt_loss` run their alpha recursions as loops of
device operations over the time steps (and, for the transducer, over
the label positions within a step), with no value read on the host,
and keep the JAX package's −1e30 sentinel for log(0), so an infeasible
alignment gives the JAX package's value.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.tensor import Tensor
from ...ops._registry import as_array, eager
from .activation import _inexact


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def _tensor(v, like):
    """A label given as a Tensor passes as it is; an array or Python
    value becomes a Tensor on `like`'s device (the JAX package wraps it
    with jnp.asarray)."""
    if isinstance(v, Tensor):
        return v
    return Tensor(torch.as_tensor(np.asarray(v), device=as_array(like).device))


def _take(logp, idx, axis):
    """logp's entries at class `idx` along `axis` (idx lacks that axis)."""
    return torch.gather(logp, axis, idx.unsqueeze(axis)).squeeze(axis)


def _xent_raw(logits, label, weight=None, ignore_index=-100,
              reduction="mean", soft_label=False, axis=-1,
              label_smoothing=0.0):
    logp = torch.log_softmax(_inexact(logits), dim=axis)
    n_class = logits.shape[axis]
    axis = axis % logits.ndim
    if soft_label:
        soft = label.to(logp.device)
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_class
        loss = -torch.sum(soft * logp, dim=axis)
        if weight is None:
            return _reduce(loss, reduction)
        # Paddle's soft-label weights: each row by label · weight
        wrow = torch.tensordot(soft.to(weight.dtype).movedim(axis, -1),
                               weight, dims=([-1], [0]))
        loss = loss * wrow
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(torch.sum(wrow), min=1e-12)
        return _reduce(loss, reduction)
    lbl = label.to(logits.device)
    if lbl.ndim == logits.ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.to(torch.int64)
    mask = lbl != ignore_index
    safe = torch.where(mask, lbl, 0)
    picked = _take(logp, safe, axis)
    if label_smoothing > 0.0:
        # smoothed target (1-ε)·one_hot + ε/K: (1-ε)·picked + ε·mean(logp)
        smooth = torch.mean(logp, dim=axis)
        loss = -((1 - label_smoothing) * picked + label_smoothing * smooth)
    else:
        loss = -picked
    if weight is not None:
        wrow = weight[safe]
        loss = loss * wrow
    loss = torch.where(mask, loss, 0.0)
    if reduction == "mean":
        if weight is not None:
            denom = torch.clamp(torch.sum(torch.where(mask, wrow, 0.0)),
                                min=1e-12)
        else:
            denom = torch.clamp(torch.sum(mask.to(loss.dtype)), min=1.0)
        return torch.sum(loss) / denom
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """`use_softmax` is accepted and not used: the input is taken as
    logits either way, as in the JAX package."""
    args = (input,) + ((weight,) if weight is not None else ())
    if soft_label and isinstance(label, Tensor) and not label.stop_gradient:
        # a soft label that is differentiated comes in as an operand
        def raw_l(x, lab, *w):
            return _xent_raw(x, lab, w[0] if w else None, ignore_index,
                             reduction, True, axis, label_smoothing)

        return eager(raw_l, (input, label) + args[1:], {},
                     name="cross_entropy")
    lbl = as_array(label)

    def raw(x, *w):
        return _xent_raw(x, lbl, w[0] if w else None, ignore_index,
                         reduction, soft_label, axis, label_smoothing)

    return eager(raw, args, {}, name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-row loss with the label axis kept (size 1), as Paddle
    documents it, for a [N], a [N, 1] and a soft label alike."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = eager(lambda a: a.unsqueeze(axis % (a.ndim + 1)), (loss,), {},
                 name="unsqueeze")
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return eager(lambda x, y: _reduce(torch.square(x - y), reduction),
                 (input, _tensor(label, input)), {}, name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return eager(lambda x, y: _reduce(torch.abs(x - y), reduction),
                 (input, _tensor(label, input)), {}, name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def raw(x, y):
        d = torch.abs(x - y)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        # paddle's smooth_l1_loss multiplies by delta
        return _reduce(loss * delta, reduction)

    return eager(raw, (input, label), {}, name="smooth_l1_loss")


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    lbl = as_array(label).to(torch.int64)
    args = (input,) + ((weight,) if weight is not None else ())

    def raw(logp, *w):
        lb = lbl.to(logp.device)
        mask = lb != ignore_index
        safe = torch.where(mask, lb, 0)
        loss = -_take(logp, safe, 1)
        if w:
            loss = loss * w[0][safe]
        loss = torch.where(mask, loss, 0.0)
        if reduction == "mean":
            denom = torch.sum(torch.where(mask, w[0][safe], 0.0)) if w \
                else torch.clamp(torch.sum(mask.to(loss.dtype)), min=1.0)
            return torch.sum(loss) / denom
        return _reduce(loss, reduction)

    return eager(raw, args, {}, name="nll_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    args = (input, label) + ((weight,) if weight is not None else ())

    def raw(x, y, *w):
        eps = 1e-12
        loss = -(y * torch.log(torch.clamp(x, min=eps)) +
                 (1 - y) * torch.log(torch.clamp(1 - x, min=eps)))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)

    return eager(raw, args, {}, name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    args = [logit, label]
    if weight is not None:
        args.append(weight)
    if pos_weight is not None:
        args.append(pos_weight)

    def raw(x, y, *rest):
        if pos_weight is not None:
            pw = rest[-1]
            loss = -(y * pw * TF.logsigmoid(x) + (1 - y) * TF.logsigmoid(-x))
        else:
            # numerically stable: max(x,0) - x*y + log(1+exp(-|x|))
            loss = torch.clamp(x, min=0) - x * y + \
                torch.log1p(torch.exp(-torch.abs(x)))
        if weight is not None:
            loss = loss * rest[0]
        return _reduce(loss, reduction)

    return eager(raw, tuple(args), {}, name="bce_with_logits")


def kl_div(input, label, reduction="mean", name=None):
    def raw(x, y):
        loss = y * (torch.log(torch.clamp(y, min=1e-12)) - x)
        if reduction == "batchmean":
            return torch.sum(loss) / x.shape[0]
        return _reduce(loss, reduction)

    return eager(raw, (input, label), {}, name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return eager(lambda x, y, l: _reduce(
        torch.clamp(-l * (x - y) + margin, min=0.0), reduction),
        (input, other, label), {}, name="margin_ranking_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return eager(lambda x, y: _reduce(
        torch.where(y == 1, x, torch.clamp(margin - x, min=0.0)), reduction),
        (input, label), {}, name="hinge_embedding_loss")


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def raw(x1, x2, l):
        cos = torch.sum(x1 * x2, -1) / torch.clamp(
            torch.linalg.vector_norm(x1, dim=-1) *
            torch.linalg.vector_norm(x2, dim=-1), min=1e-12)
        loss = torch.where(l == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
        return _reduce(loss, reduction)

    return eager(raw, (input1, input2, label), {},
                 name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return torch.pow(torch.sum(torch.pow(torch.abs(u - v) + epsilon, p),
                                   -1), 1 / p)

    def raw(a, pos, neg):
        dp = dist(a, pos)
        dn = dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return eager(raw, (input, positive, negative), {},
                 name="triplet_margin_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    norm = None if normalizer is None else as_array(normalizer)

    def raw(x, y):
        p = torch.sigmoid(x)
        ce = torch.clamp(x, min=0) - x * y + \
            torch.log1p(torch.exp(-torch.abs(x)))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if norm is not None:
            loss = loss / norm.to(loss.device)
        return _reduce(loss, reduction)

    return eager(raw, (logit, label), {}, name="sigmoid_focal_loss")


def square_error_cost(input, label, name=None):
    return eager(lambda x, y: torch.square(x - y), (input, label), {},
                 name="square_error_cost")


# log(0): -inf breeds nans through where and the gradient; a huge
# negative number is safe (paddle_tpu/nn/functional/loss.py:253)
_CTC_NEG_INF = -1e30


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) +
                         torch.exp(c - m))


def _ctc_raw(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """The CTC forward algorithm (the alpha recursion in log space) of
    paddle_tpu/nn/functional/loss.py:256-334. log_probs [T, N, C]
    log-softmax outputs, labels [N, S] padded targets."""
    t_max, n, _ = log_probs.shape
    s_max = labels.shape[1]
    dev, dt = log_probs.device, log_probs.dtype
    labels = labels.to(dev, torch.int64)
    input_lengths = input_lengths.to(dev, torch.int64)
    label_lengths = label_lengths.to(dev, torch.int64)
    # the extended target: blank, l1, blank, l2, ... blank  (2S+1)
    ext = torch.full((n, 2 * s_max + 1), blank, dtype=torch.int64,
                     device=dev)
    ext[:, 1::2] = labels
    positions = torch.arange(2 * s_max + 1, device=dev)[None, :]
    valid = positions < (2 * label_lengths[:, None] + 1)
    # s → s-2 allowed only onto a non-blank that differs from ext[s-2]
    skip_ok = torch.cat(
        [torch.zeros((n, 2), dtype=torch.bool, device=dev),
         (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], dim=1)
    neg = torch.full((), _CTC_NEG_INF, dtype=dt, device=dev)
    emit0 = torch.gather(log_probs[0], 1, ext)
    alpha = torch.cat([emit0[:, :2], neg.expand(n, 2 * s_max - 1)], dim=1)
    alpha = torch.where(valid, alpha, neg)
    pad1 = neg.expand(n, 1)
    pad2 = neg.expand(n, 2)
    for t in range(1, t_max):
        prev1 = torch.cat([pad1, alpha[:, :-1]], 1)
        prev2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], 1),
                            neg)
        new = torch.gather(log_probs[t], 1, ext) + \
            _logaddexp3(alpha, prev1, prev2)
        new = torch.where(valid, new, neg)
        # frozen once past each sequence's input length
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    # the total: last blank (2L) and last label (2L-1)
    end = 2 * label_lengths
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_end1 = torch.where(
        label_lengths > 0,
        torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0],
        neg)
    loss = -torch.logaddexp(a_end, a_end1)
    if norm_by_times:
        loss = loss / input_lengths.to(loss.dtype)
    if reduction == "mean":
        return torch.mean(loss / torch.clamp(label_lengths, min=1)
                          .to(loss.dtype))
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    return eager(lambda lp, lb, il, ll: _ctc_raw(lp, lb, il, ll, blank,
                                                 reduction, norm_by_times),
                 (log_probs, labels, input_lengths, label_lengths), {},
                 name="ctc_loss")


def _poisson_nll_raw(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:  # Stirling's approximation of the log(label!) term
        stirling = label * torch.log(label) - label + \
            0.5 * torch.log(2 * math.pi * label)
        loss = loss + torch.where(label > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    return eager(lambda i, l: _poisson_nll_raw(i, l, log_input, full,
                                               epsilon, reduction),
                 (input, label), {}, name="poisson_nll_loss")


def _gaussian_nll_raw(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + (input - label) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    return eager(lambda i, l, v: _gaussian_nll_raw(i, l, v, full, epsilon,
                                                   reduction),
                 (input, label, variance), {}, name="gaussian_nll_loss")


def _dice_loss_raw(input, label, epsilon=1e-5):
    # input [N, ..., C] probabilities; label [N, ..., 1] class ids
    n_class = input.shape[-1]
    classes = torch.arange(n_class, device=input.device)
    onehot = (label.squeeze(-1)[..., None] == classes).to(input.dtype)
    flat_i = input.reshape(input.shape[0], -1)
    flat_l = onehot.reshape(onehot.shape[0], -1)
    intersect = torch.sum(flat_i * flat_l, dim=1)
    union = torch.sum(flat_i, dim=1) + torch.sum(flat_l, dim=1)
    return torch.mean(1.0 - (2.0 * intersect + epsilon) / (union + epsilon))


def dice_loss(input, label, epsilon=1e-5, name=None):
    return eager(lambda i, l: _dice_loss_raw(i, l, epsilon), (input, label),
                 {}, name="dice_loss")


def log_loss(input, label, epsilon=1e-4, name=None):
    return eager(
        lambda i, l: -l * torch.log(i + epsilon) -
        (1.0 - l) * torch.log(1.0 - i + epsilon),
        (input, label), {}, name="log_loss")


def _npair_loss_raw(anchor, positive, labels, l2_reg=0.002):
    labels = labels.reshape(-1)
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    target = same / torch.sum(same, dim=1, keepdim=True)
    sim = anchor @ positive.T
    logp = torch.log_softmax(sim, dim=1)
    xent = torch.mean(torch.sum(-target * logp, dim=1))
    reg = l2_reg * 0.25 * (torch.mean(torch.sum(anchor * anchor, dim=1)) +
                           torch.mean(torch.sum(positive * positive, dim=1)))
    return xent + reg


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    return eager(lambda a, p, l: _npair_loss_raw(a, p, l, l2_reg),
                 (anchor, positive, labels), {}, name="npair_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):
    # log(1+exp(-z)) = -log_sigmoid(z), the overflow-free form
    return eager(
        lambda i, l: _reduce(-TF.logsigmoid(l.to(i.dtype) * i), reduction),
        (input, label), {}, name="soft_margin_loss")


def _mlsm_raw(input, label, weight=None, reduction="mean"):
    l = label.to(input.dtype)
    loss = -(l * TF.logsigmoid(input) + (1.0 - l) * TF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight.to(loss.device)
    loss = torch.mean(loss, dim=-1)
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    w = None if weight is None else as_array(weight)
    return eager(lambda i, l: _mlsm_raw(i, l, w, reduction),
                 (input, label), {}, name="multi_label_soft_margin_loss")


def _multi_margin_raw(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    n, c = input.shape
    lbl = label.to(torch.int64).reshape(-1)
    correct = torch.gather(input, 1, lbl[:, None])
    m = torch.clamp(margin - correct + input, min=0.0) ** p
    if weight is not None:
        m = m * weight.to(m.device)[lbl][:, None]
    m = m * (1.0 - TF.one_hot(lbl, c).to(input.dtype))
    loss = torch.sum(m, dim=1) / c
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    w = None if weight is None else as_array(weight)
    return eager(lambda i, l: _multi_margin_raw(i, l, p, margin, w,
                                                reduction),
                 (input, label), {}, name="multi_margin_loss")


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    def raw(i, l):
        d = i - l
        ad = torch.abs(d)
        loss = torch.where(ad <= delta, 0.5 * d * d,
                           delta * (ad - 0.5 * delta))
        return _reduce(loss, reduction)

    return eager(raw, (input, label), {}, name="huber_loss")


def _hsigmoid_raw(x, label, weight, bias, num_classes):
    """The hierarchical sigmoid over the default complete binary tree:
    heap-style node ids, the leaves label + num_classes, each ancestor
    down to the root (id 1) an internal node whose row of `weight` is
    id - 1. The loss is f32 [N, 1], as in the JAX package."""
    label = label.reshape(-1)  # the documented label shape is [N, 1]
    cur = label.to(x.device, torch.int64) + num_classes
    depth = int(np.ceil(np.log2(2 * num_classes)))
    loss = torch.zeros(x.shape[:1], dtype=torch.float32, device=x.device)
    xf = x.to(torch.float32)
    for _ in range(depth):
        parent = torch.div(cur, 2, rounding_mode="floor")
        bit = (cur % 2).to(torch.float32)      # which child was taken
        active = parent >= 1
        row = torch.clamp(parent - 1, 0, num_classes - 2)
        score = torch.sum(xf * weight[row], dim=-1)
        if bias is not None:
            score = score + bias[row].to(torch.float32).reshape(-1)
        # BCE-with-logits against the path bit
        step = torch.clamp(score, min=0) - score * bit + torch.log1p(
            torch.exp(-torch.abs(score)))
        loss = loss + torch.where(active, step, 0.0)
        cur = parent
    return loss[:, None]


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The default tree only: a custom path_table / path_code raises, as
    in the JAX package."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom path_table/path_code hsigmoid is not supported "
            "(the default complete binary tree only)")
    lbl = as_array(label)
    args = (input, weight) if bias is None else (input, weight, bias)

    def raw(x, w, b=None):
        return _hsigmoid_raw(x, lbl, w, b, num_classes)

    return eager(raw, args, {}, name="hsigmoid_loss")


def _euclidean(a, b, eps=1e-12):
    """‖a − b‖ over the last axis, eps under the root: d sqrt(0) is
    infinite, so identical anchor and positive rows would give nan
    gradients (the layer's default takes eps 0, as in the JAX
    package)."""
    return eager(lambda u, v: torch.sqrt(torch.sum((u - v) ** 2, -1) + eps),
                 (a, b), {}, name="pairwise_distance")


def _triplet_with_distance(dist, input, positive, negative, margin, swap,
                           reduction):
    from .activation import relu
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = eager(torch.minimum, (dn, dist(positive, negative)), {},
                   name="minimum")
    loss = relu(dp - dn + margin)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet margin loss over `distance_function` (Tensors in,
    Tensor out); the default is the euclidean distance with 1e-12 under
    the root."""
    return _triplet_with_distance(distance_function or _euclidean,
                                  input, positive, negative, margin, swap,
                                  reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """The ArcFace-style margin softmax: the label's logit cos(θ) becomes
    cos(margin1·θ + margin2) − margin3, then everything is scaled by
    `scale`. One program: `group` is accepted and not used."""
    lbl = as_array(label)

    def raw(lg):
        lab = lbl.to(lg.device, torch.int64).reshape(-1)
        # strictly inside [-1, 1]: arccos' derivative is infinite at the
        # ends, and a saturated label cosine would give nan gradients
        cos_t = torch.clamp(torch.gather(lg, 1, lab[:, None])[:, 0],
                            -1.0 + 1e-6, 1.0 - 1e-6)
        theta = torch.arccos(cos_t)
        target = torch.cos(margin1 * theta + margin2) - margin3
        hit = TF.one_hot(lab, lg.shape[1]).to(torch.bool)
        modified = torch.where(hit, target[:, None].to(lg.dtype), lg) * scale
        logp = torch.log_softmax(modified, dim=-1)
        nll = -torch.gather(logp, 1, lab[:, None])[:, 0]
        return nll, torch.exp(logp)

    loss, sm = eager(raw, (logits,), {}, name="margin_cross_entropy")
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    return (loss, sm) if return_softmax else loss


def ctc_greedy_decoder(input, blank=0, name=None):
    """The greedy CTC decode: the argmax a frame, repeats collapsed,
    blanks dropped. input [B, T, C] → (decoded [B, T] int64 padded with
    -1, lengths [B] int64)."""

    def raw(x):
        ids = torch.argmax(x, dim=-1)                        # [B, T]
        prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
        keep = (ids != blank) & (ids != prev)
        # the kept tokens moved left, in order: sort by a key that puts
        # every kept position before every dropped one
        T = ids.shape[1]
        ar = torch.arange(T, device=x.device)[None, :]
        pos = torch.where(keep, ar, T + ar)
        order = torch.argsort(pos, dim=1)
        compacted = torch.gather(torch.where(keep, ids, -1), 1, order)
        return compacted.to(torch.int64), torch.sum(keep, dim=1)

    return eager(raw, (input,), {}, name="ctc_greedy_decoder")


def _adaptive_raw(label, cutoffs, sizes, head_out, *tails):
    """The target log-probabilities of the adaptive softmax from the
    head's logits and each cluster's logits: the head's entry for a
    label below cutoffs[0], else its cluster's gate plus the cluster's
    entry."""
    lab = label.to(head_out.device, torch.int64).reshape(-1)
    head_logp = torch.log_softmax(head_out, dim=-1)
    cut0 = cutoffs[0]
    output = torch.gather(head_logp, 1,
                          torch.clamp(lab, 0, cut0 - 1)[:, None])[:, 0]
    for i, tail in enumerate(tails):
        lo, size = cutoffs[i], sizes[i]
        in_cluster = (lab >= lo) & (lab < lo + size)
        rel = torch.clamp(lab - lo, 0, size - 1)
        c_logp = torch.log_softmax(tail, dim=-1)
        val = head_logp[:, cut0 + i] + torch.gather(c_logp, 1,
                                                    rel[:, None])[:, 0]
        output = torch.where(in_cluster, val, output)
    return output, -torch.mean(output)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """The functional adaptive softmax: head_weight [in, cut0 +
    n_clusters]; tail_weights, one [down_proj [in, h], out_proj [h,
    size]] pair a cluster; cutoffs without n_classes. Returns (the
    target log-probabilities [N], the mean NLL)."""
    from ...ops.math import matmul
    head_out = matmul(input, head_weight)
    if head_bias is not None:
        head_out = head_out + head_bias
    tails = [matmul(matmul(input, t[0]), t[1]) for t in tail_weights]
    sizes = [int(t[1].shape[-1]) for t in tail_weights]
    lbl = as_array(label)
    return eager(lambda h, *t: _adaptive_raw(lbl, list(cutoffs), sizes, h,
                                             *t),
                 (head_out, *tails), {},
                 name="adaptive_log_softmax_with_loss")


def _rnnt_raw(logits, labels, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean"):
    """The RNN-Transducer loss (Graves 2012) of paddle_tpu/nn/functional/
    loss.py:631-716: the alpha recursion over T, with the same-frame
    label transitions a prefix recursion over u inside each step.

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u),
                            alpha[t, u-1] + emit(t, u-1))
    loss = -(alpha[T-1, U] + blank(T-1, U)).

    fastemit_lambda is a (1 + λ) weight on the label-emission term, as
    in the JAX package."""
    b, t_max, u1, _ = logits.shape
    u_max = u1 - 1
    dev = logits.device
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = labels.to(dev, torch.int64)
    input_lengths = input_lengths.to(dev, torch.int64)
    label_lengths = label_lengths.to(dev, torch.int64)
    blank_lp = lp[..., blank]                                 # [B, T, U+1]
    lab = torch.gather(lp[:, :, :u_max, :], 3,
                       labels[:, None, :, None].expand(b, t_max, u_max, 1)
                       )[..., 0]
    lab = lab + float(np.log1p(fastemit_lambda))              # [B, T, U]
    upos = torch.arange(u1, device=dev)[None, :]
    uvalid = upos <= label_lengths[:, None]                   # [B, U+1]
    neg = torch.full((), _CTC_NEG_INF, dtype=torch.float32, device=dev)
    # t = 0: alpha[0, 0] = 0, alpha[0, u] the sum of the label emissions
    alpha = torch.cat([torch.zeros((b, 1), dtype=torch.float32, device=dev),
                       torch.cumsum(lab[:, 0], dim=1)], dim=1)
    alpha = torch.where(uvalid, alpha, neg)
    alphas = [alpha]
    for t in range(1, t_max):
        from_below = alpha + blank_lp[:, t - 1]
        a = from_below[:, 0]
        row = [a]
        for u in range(1, u1):
            a = torch.logaddexp(from_below[:, u], a + lab[:, t, u - 1])
            row.append(a)
        new = torch.where(uvalid, torch.stack(row, dim=1), neg)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=0)                      # [T, B, U+1]
    il = torch.clamp(input_lengths - 1, min=0)
    ar = torch.arange(b, device=dev)
    a_fin = torch.gather(alphas[il, ar], 1, label_lengths[:, None])[:, 0]
    blank_fin = torch.gather(blank_lp[ar, il], 1,
                             label_lengths[:, None])[:, 0]
    nll = -(a_fin + blank_fin)
    if reduction == "mean":
        return torch.mean(nll)
    if reduction == "sum":
        return torch.sum(nll)
    return nll


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    return eager(lambda lg, lb, il, ll: _rnnt_raw(
        lg, lb, il, ll, blank, fastemit_lambda, reduction),
        (input, label, input_lengths, label_lengths), {}, name="rnnt_loss")
