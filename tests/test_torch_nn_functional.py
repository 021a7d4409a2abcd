"""The port's `nn.functional` against the JAX package's, on the CPU.

Every function of `paddle_tpu.nn.functional` runs through both packages
on the same numpy inputs (drawn from a seed): values, dtypes and shapes,
and, for the differentiable ones, the gradient of sum(out · c) (c a
fixed numpy draw) for every float input. Integer, bool and mixed-dtype
operands and Python scalars go in wherever the JAX function takes them;
an integer input that the JAX package computes in float64 gives the
default float dtype (float32) in the port (F7's family, ROADMAP.md
Queue 3).

Tolerances (f32): 1e-6 of each output's largest element for elementwise
functions, 1e-5 for losses and reductions and every gradient (the same
expressions summed in another order); `ctc_loss` and `rnnt_loss` 1e-5
(their recursions add logs of sums of exponentials step by step).

The recorded divergences pinned here: the weighted mean of a [N, 1]
label and soft-label class weights (Paddle's documented rule, not the
JAX package's), `softmax_with_cross_entropy` keeping the label axis,
`interpolate`'s documented modes, and the random functions drawing from
torch generators (equal in eval mode, checked by distribution in
training).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jp  # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402

ELEM_TOL = 1e-6
LOSS_TOL = 1e-5
PKGS = (jp, tp)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _dt(x):
    return str(x.dtype).replace("torch.", "")


def _want_dt(jdt, arrays, f7=False):
    """The port's dtype for the JAX package's: float64 from an integer
    or bool input, or from a float64 constant the JAX function makes
    under x64 (`f7`), is the default float32 in the port (F7)."""
    ints = any(isinstance(a, np.ndarray) and a.dtype.kind in "iub"
               for a in arrays)
    return "float32" if jdt == "float64" and (ints or f7) else jdt


def _close(t, j, tol, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    if t.size == 0:
        return
    fin = np.isfinite(j)
    assert (np.isfinite(t) == fin).all(), what
    scale = max(np.abs(j[fin]).max(initial=0.0), 1e-30)
    err = np.abs(t[fin] - j[fin]).max(initial=0.0) / scale
    assert err <= tol, f"{what}: {err} > {tol}"


def _cotangents(outs):
    rng = np.random.default_rng(99)
    return [rng.standard_normal(tuple(o.shape)).astype(np.float32)
            if o.shape else np.float32(1.0) for o in outs]


def _is_float(dt):
    return dt in ("float32", "float64")


def _run(fn, arrays, diff):
    """The port: fn(F, *Tensors) on Tensors made from `arrays` (the
    `diff` ones differentiable); returns (outputs, grads of Σ out·c over
    the float outputs, for each differentiable input)."""
    ts = [a if not isinstance(a, np.ndarray) else
          tp.to_tensor(a, stop_gradient=not d) for a, d in zip(arrays, diff)]
    out = fn(tp.nn.functional, *ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    loss = None
    for o, c in zip(outs, _cotangents(outs)):
        if _is_float(_dt(o)) and not o.stop_gradient:
            term = (o * tp.to_tensor(c)).sum()
            loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = [(t.grad.numpy(), _dt(t.grad)) if d and t.grad is not None
             else None for t, d in zip(ts, diff)]
    return [(np.asarray(o.numpy()), _dt(o), list(o.shape)) for o in outs], \
        grads


def _run_jax(fn, arrays, diff):
    """The JAX package: the same, with fn and its gradient traced as one
    jitted program (Tensors are pytrees), which compiles once where the
    eager tape compiles every op; a function that reads a value on the
    host runs eagerly instead."""
    idx = [i for i, a in enumerate(arrays) if isinstance(a, np.ndarray)]

    def outputs(arrs):
        full = list(arrays)
        for i, a in zip(idx, arrs):
            full[i] = JTensor(a)
        out = fn(jp.nn.functional, *full)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def loss(dargs, arrs):
        arrs = list(arrs)
        for k, a in zip(didx, dargs):
            arrs[k] = a
        outs = [o._data for o in outputs(arrs)]
        total = 0.0
        for o, c in zip(outs, _cotangents(outs)):
            if jnp.issubdtype(o.dtype, jnp.floating) and o.dtype != \
                    jnp.bfloat16:
                total = total + jnp.sum(o * c)
        return total, outs

    didx = [k for k, i in enumerate(idx) if diff[i]]
    arrs = [jnp.asarray(arrays[i]) for i in idx]
    try:
        (_, outs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            [arrs[k] for k in didx], arrs)
    except jax.errors.ConcretizationTypeError:
        return _run_eager_jax(fn, arrays, diff)
    gi = dict(zip([idx[k] for k in didx], g))
    grads = [(np.asarray(gi[i]), str(gi[i].dtype)) if i in gi else None
             for i in range(len(arrays))]
    return [(np.asarray(o), str(o.dtype), list(o.shape)) for o in outs], \
        grads


def _run_eager_jax(fn, arrays, diff):
    ts = [a if not isinstance(a, np.ndarray) else
          jp.to_tensor(a, stop_gradient=not d) for a, d in zip(arrays, diff)]
    out = fn(jp.nn.functional, *ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    loss = None
    for o, c in zip(outs, _cotangents(outs)):
        if _is_float(_dt(o)) and not o.stop_gradient:
            term = (o * jp.to_tensor(c)).sum()
            loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = [(np.asarray(t.grad.numpy()), _dt(t.grad))
             if d and t.grad is not None else None
             for t, d in zip(ts, diff)]
    return [(np.asarray(o.numpy()), _dt(o), list(o.shape)) for o in outs], \
        grads


def _check(fn, arrays, diff, tol, what, grads=True, f7=False):
    (jo, jg), (to, tg) = _run_jax(fn, arrays, diff), _run(fn, arrays, diff)
    assert len(jo) == len(to), what
    for (ja, jdt, js), (ta, tdt, ts) in zip(jo, to):
        assert tdt == _want_dt(jdt, arrays, f7) and ts == js, (what, jdt, tdt, js, ts)
        _close(ta, ja, tol, what)
    if grads:
        for i, (a, b) in enumerate(zip(jg, tg)):
            assert (a is None) == (b is None), (what, i)
            if a is not None:
                assert b[1] == a[1], (what, i, a[1], b[1])
                _close(b[0], a[0], LOSS_TOL, f"{what} grad {i}")


RNG = np.random.default_rng(0)
X = (2.0 * RNG.standard_normal((3, 8))).astype(np.float32)
XI = np.array([[-3, -1, 0, 1], [2, 5, 7, -8]], np.int32)
XB = np.array([[True, False, True, False]])

# name: (kwargs, takes int, takes bool) — the JAX function's own refusals
ACTS = {
    "relu6": ({}, True, True), "elu": ({"alpha": 0.7}, True, True),
    "selu": ({}, True, True), "celu": ({"alpha": 1.3}, True, True),
    "leaky_relu": ({"negative_slope": 0.2}, True, True),
    "hardshrink": ({"threshold": 0.6}, True, True),
    "softshrink": ({"threshold": 0.4}, True, True),
    "tanhshrink": ({}, True, True),
    "hardtanh": ({"min": -1.5, "max": 2.0}, True, True),
    "hardsigmoid": ({}, True, True), "hardswish": ({}, True, True),
    "mish": ({}, True, True),
    "softplus": ({"beta": 2.0, "threshold": 5.0}, True, True),
    "softsign": ({}, True, True), "log_sigmoid": ({}, True, False),
    "sigmoid": ({}, False, False), "softmax": ({"axis": 0}, True, False),
    "thresholded_relu": ({"threshold": 0.5}, True, True),
    "glu": ({"axis": -1}, False, False), "log_softmax": ({}, True, False),
}


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation_f32_values_and_grads(name):
    kw = ACTS[name][0]
    _check(lambda F, x: getattr(F, name)(x, **kw), [X], [True], ELEM_TOL,
           name)


@pytest.mark.parametrize("name", sorted(n for n in ACTS if ACTS[n][1]))
def test_activation_integer_input(name):
    kw = ACTS[name][0]
    _check(lambda F, x: getattr(F, name)(x, **kw), [XI], [False], ELEM_TOL,
           name)


@pytest.mark.parametrize("name", sorted(n for n in ACTS if ACTS[n][2]))
def test_activation_bool_input(name):
    kw = ACTS[name][0]
    _check(lambda F, x: getattr(F, name)(x, **kw), [XB], [False], ELEM_TOL,
           name)


@pytest.mark.parametrize("name", sorted(n for n in ACTS
                                        if not ACTS[n][1]))
def test_activation_refuses_integers_as_jax(name):
    for P in PKGS:
        with pytest.raises(TypeError):
            getattr(P.nn.functional, name)(P.to_tensor(XI))


def test_activation_bf16_keeps_dtype():
    xb = jp.to_tensor(X).astype("bfloat16")
    xt = tp.to_tensor(X).astype("bfloat16")
    for name, (kw, _, _) in ACTS.items():
        j = getattr(jp.nn.functional, name)(xb, **kw)
        t = getattr(tp.nn.functional, name)(xt, **kw)
        assert _dt(t) == _dt(j) == "bfloat16", name
        _close(t.astype("float32").numpy(),
               np.asarray(j.astype("float32").numpy()), 8e-3, name)


@pytest.mark.parametrize("case", [
    "prelu1", "prelu_nchw", "prelu_nhwc", "maxout", "maxout_int", "softmax_dt",
    "gelu_tanh", "swish", "silu", "relu_int"])
def test_activation_more(case):
    x4 = RNG.standard_normal((2, 4, 3, 3)).astype(np.float32)
    w1 = np.array([0.3], np.float32)
    w4 = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    w3 = np.array([0.1, 0.2, 0.3], np.float32)
    table = {
        "prelu1": (lambda F, x, w: F.prelu(x, w), [x4, w1], [True, True]),
        "prelu_nchw": (lambda F, x, w: F.prelu(x, w), [x4, w4],
                       [True, True]),
        "prelu_nhwc": (lambda F, x, w: F.prelu(x, w, data_format="NHWC"),
                       [x4, w3], [True, True]),
        "maxout": (lambda F, x: F.maxout(x, 2), [x4], [True]),
        "maxout_int": (lambda F, x: F.maxout(x, 2, axis=1),
                       [(10 * x4).astype(np.int32)], [False]),
        "softmax_dt": (lambda F, x: F.softmax(x, axis=1, dtype="float64"),
                       [X], [True]),
        "gelu_tanh": (lambda F, x: F.gelu(x, approximate=True), [X],
                      [True]),
        "swish": (lambda F, x: F.swish(x), [X], [True]),
        "silu": (lambda F, x: F.silu(x), [X], [True]),
        "relu_int": (lambda F, x: F.relu(x), [XI], [False]),
    }
    fn, arrays, diff = table[case]
    _check(fn, arrays, diff, ELEM_TOL, case)


def test_inplace_twins_write_into_x():
    for name in ("relu6_", "elu_", "sigmoid_", "hardswish_", "mish_",
                 "thresholded_relu_", "leaky_relu_", "softplus_"):
        x = tp.to_tensor(X)
        out = getattr(tp.nn.functional, name)(x)
        want = getattr(tp.nn.functional, name[:-1])(tp.to_tensor(X))
        assert out is x and np.array_equal(x.numpy(), want.numpy()), name


# ----------------------------------------------------------------- losses
N, C = 6, 5
LOGITS = RNG.standard_normal((N, C)).astype(np.float32)
LAB = np.array([0, 3, 1, 4, 2, 3], np.int64)
PROB = (RNG.uniform(0.05, 0.95, (N, C))).astype(np.float32)
BIN = (RNG.uniform(size=(N, C)) > 0.5).astype(np.float32)
Y = RNG.standard_normal((N, C)).astype(np.float32)
PM1 = np.where(RNG.uniform(size=N) > 0.5, 1, -1).astype(np.float32)
WC = np.array([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)
E = RNG.standard_normal((N, 8)).astype(np.float32)
E2 = RNG.standard_normal((N, 8)).astype(np.float32)
E3 = RNG.standard_normal((N, 8)).astype(np.float32)

LOSSES = {
    "mse": (lambda F, x, y: F.mse_loss(x, y), [LOGITS, Y], [1, 1]),
    "mse_sum_int_label": (lambda F, x, y: F.mse_loss(x, y, "sum"),
                          [LOGITS, LAB.reshape(N, 1) * np.ones((1, C),
                                                              np.int64)],
                          [1, 0]),
    "mse_scalar_label": (lambda F, x: F.mse_loss(x, 1.5), [LOGITS], [1]),
    "mse_bf16_f32": (lambda F, x, y: F.mse_loss(x.astype("bfloat16"), y),
                     [LOGITS, Y], [0, 1]),
    "l1": (lambda F, x, y: F.l1_loss(x, y, "none"), [LOGITS, Y], [1, 1]),
    "l1_scalar": (lambda F, x: F.l1_loss(x, 2), [LOGITS], [1]),
    "smooth_l1": (lambda F, x, y: F.smooth_l1_loss(x, y, delta=0.5),
                  [LOGITS, Y], [1, 1]),
    "nll": (lambda F, x: F.nll_loss(F.log_softmax(x), LAB_T(F)), [LOGITS],
            [1]),
    "nll_weight_ignore": (lambda F, x, w: F.nll_loss(
        F.log_softmax(x), LAB_T(F), weight=w, ignore_index=3), [LOGITS, WC],
        [1, 0]),
    "nll_4d": (lambda F, x: F.nll_loss(x, LAB4_T(F), reduction="sum"),
               [RNG.standard_normal((2, C, 3, 2)).astype(np.float32)], [1]),
    "bce": (lambda F, x, y: F.binary_cross_entropy(x, y), [PROB, BIN],
            [1, 0]),
    "bce_weight_int_label": (lambda F, x, y, w: F.binary_cross_entropy(
        x, y, w, "sum"), [PROB, BIN.astype(np.int64), WC], [1, 0, 0]),
    "bce_logits": (lambda F, x, y: F.binary_cross_entropy_with_logits(x, y),
                   [LOGITS, BIN], [1, 1]),
    "bce_logits_pos_weight": (
        lambda F, x, y, w, pw: F.binary_cross_entropy_with_logits(
            x, y, w, "none", pw), [LOGITS, BIN, WC, WC[::-1].copy()],
        [1, 0, 1, 1]),
    "kl_div": (lambda F, x, y: F.kl_div(F.log_softmax(x), y),
               [LOGITS, PROB], [1, 1]),
    "kl_div_batchmean": (lambda F, x, y: F.kl_div(x, y, "batchmean"),
                         [LOGITS, PROB], [1, 1]),
    "margin_ranking": (lambda F, a, b, l: F.margin_ranking_loss(
        a, b, l, margin=0.3), [X[0, :6].copy(), X[1, :6].copy(), PM1],
        [1, 1, 0]),
    "hinge_embedding": (lambda F, x, l: F.hinge_embedding_loss(x, l, 0.8),
                        [LOGITS, np.sign(Y).astype(np.float32)], [1, 0]),
    "hinge_embedding_int": (lambda F, x, l: F.hinge_embedding_loss(x, l),
                            [LOGITS, np.sign(Y).astype(np.int64)], [1, 0]),
    "cosine_embedding": (lambda F, a, b, l: F.cosine_embedding_loss(
        a, b, l, 0.1), [E, E[::-1].copy(), PM1], [1, 1, 0]),
    "triplet_margin": (lambda F, a, p, n: F.triplet_margin_loss(
        a, p, n, swap=True), [E, E2, E3],
        [1, 1, 1]),
    "triplet_margin_p1": (lambda F, a, p, n: F.triplet_margin_loss(
        a, p, n, p=1.0, reduction="none"),
        [E, E2, E3], [1, 1, 1]),
    "sigmoid_focal": (lambda F, x, y: F.sigmoid_focal_loss(x, y),
                      [LOGITS, BIN], [1, 0]),
    "sigmoid_focal_norm": (lambda F, x, y, n: F.sigmoid_focal_loss(
        x, y, n, reduction="mean"), [LOGITS, BIN,
                                     np.array([3.0], np.float32)], [1, 0, 0]),
    "square_error_cost": (lambda F, x, y: F.square_error_cost(x, y),
                          [LOGITS, Y], [1, 1]),
    "poisson_nll": (lambda F, x, y: F.poisson_nll_loss(x, y),
                    [LOGITS, np.abs(3 * Y).round()], [1, 0]),
    "poisson_nll_full": (lambda F, x, y: F.poisson_nll_loss(
        x, y, log_input=False, full=True), [PROB, np.abs(3 * Y).round()],
        [1, 0]),
    "gaussian_nll": (lambda F, x, y, v: F.gaussian_nll_loss(x, y, v,
                                                            full=True),
                     [LOGITS, Y, PROB], [1, 1, 1]),
    "dice": (lambda F, x: F.dice_loss(F.softmax(x), LAB2_T(F)), [LOGITS],
             [1]),
    "log_loss": (lambda F, x, y: F.log_loss(x, y), [PROB, BIN], [1, 0]),
    "npair": (lambda F, a, p: F.npair_loss(a, p, LAB_T(F)), [E, E[::-1].copy()],
              [1, 1]),
    "soft_margin": (lambda F, x, y: F.soft_margin_loss(x, y),
                    [LOGITS, np.sign(Y).astype(np.float32)], [1, 0]),
    "soft_margin_int": (lambda F, x, y: F.soft_margin_loss(x, y, "sum"),
                        [LOGITS, np.sign(Y).astype(np.int64)], [1, 0]),
    "multi_label_soft_margin": (
        lambda F, x, y: F.multi_label_soft_margin_loss(x, y), [LOGITS, BIN],
        [1, 0]),
    "multi_label_soft_margin_w": (
        lambda F, x, y: F.multi_label_soft_margin_loss(
            x, y, weight=WC, reduction="none"), [LOGITS, BIN], [1, 0]),
    "multi_margin": (lambda F, x: F.multi_margin_loss(x, LAB_T(F)), [LOGITS],
                     [1]),
    "multi_margin_p2_w": (lambda F, x, w: F.multi_margin_loss(
        x, LAB_T(F), p=2, margin=0.5, weight=w), [LOGITS, WC], [1, 0]),
    "huber": (lambda F, x, y: F.huber_loss(x, y, delta=0.7), [LOGITS, Y],
              [1, 1]),
    "triplet_distance": (lambda F, a, p, n:
                         F.triplet_margin_with_distance_loss(a, p, n),
                         [E, E2, E3], [1, 1, 1]),
    "triplet_distance_custom_swap": (
        lambda F, a, p, n: F.triplet_margin_with_distance_loss(
            a, p, n, distance_function=lambda u, v: F.pairwise_distance(
                u, v), swap=True, reduction="sum"),
        [E, E2, E3], [1, 1, 1]),
    "margin_cross_entropy": (lambda F, x: F.margin_cross_entropy(
        x, LAB_T(F), return_softmax=True),
        [np.tanh(LOGITS)], [1]),
    "softmax_with_xent": (lambda F, x: F.softmax_with_cross_entropy(
        x, LAB_T(F), return_softmax=True), [LOGITS], [1]),
}


def LAB_T(F):
    return (jp if F is jp.nn.functional else tp).to_tensor(LAB)


def LAB2_T(F):
    return (jp if F is jp.nn.functional else tp).to_tensor(LAB[:, None])


def LAB4_T(F):
    return (jp if F is jp.nn.functional else tp).to_tensor(
        RNG_LAB4)


RNG_LAB4 = np.random.default_rng(4).integers(0, C, (2, 3, 2))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_values_and_input_grads(name):
    fn, arrays, diff = LOSSES[name]
    _check(fn, arrays, [bool(d) for d in diff], LOSS_TOL, name)


# ------------------------------------------------ cross_entropy's matrix
def _xent(P, w, soft, ls, ignore, red, shape):
    x = P.to_tensor(LOGITS, stop_gradient=False)
    if soft:
        lab = P.to_tensor(PROB / PROB.sum(-1, keepdims=True))
    else:
        lab = P.to_tensor(LAB if shape == "N" else LAB[:, None])
    out = P.nn.functional.cross_entropy(
        x, lab, weight=None if w is None else P.to_tensor(w),
        ignore_index=ignore, reduction=red, soft_label=soft,
        label_smoothing=ls)
    c = np.random.default_rng(5).standard_normal(out.shape).astype(
        np.float32)
    (out * (P.to_tensor(c) if out.shape else 1.0)).sum().backward()
    return out, x.grad


XENT_CASES = [(w, False, ls, ig, red, sh)
              for w in (None, "w") for ls in (0.0, 0.1) for ig in (-100, 3)
              for red in ("mean", "sum", "none") for sh in ("N", "N1")] + \
    [(w, True, ls, -100, red, "N") for w in (None, "w") for ls in (0.0, 0.2)
     for red in ("mean", "sum", "none")]


def _xent_numpy(w, soft, ls, ignore, red, shape):
    """Paddle's documented cross entropy in float64."""
    z = LOGITS.astype(np.float64)
    logp = z - z.max(-1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    if soft:
        s = PROB / PROB.sum(-1, keepdims=True)
        s = s * (1 - ls) + ls / C
        loss = -(s * logp).sum(-1)
        wr = s @ w if w is not None else np.ones(N)
        loss = loss * wr
        if red == "mean":
            return loss.sum() / wr.sum()
    else:
        mask = LAB != ignore
        safe = np.where(mask, LAB, 0)
        picked = logp[np.arange(N), safe]
        loss = -((1 - ls) * picked + ls * logp.mean(-1))
        wr = w[safe] if w is not None else np.ones(N)
        loss = np.where(mask, loss * wr, 0.0)
        if red == "mean":
            return loss.sum() / np.where(mask, wr, 0.0).sum()
    return loss.sum() if red == "sum" else loss


@pytest.mark.parametrize("w,soft,ls,ignore,red,shape", XENT_CASES)
def test_cross_entropy_matrix(w, soft, ls, ignore, red, shape):
    """Every combination of class weights, soft labels, label smoothing,
    ignore_index, reduction and label shape: the JAX package's value
    and gradient wherever its algebra is Paddle's; Paddle's documented
    value (in float64) everywhere."""
    wv = WC if w else None
    j, jg = _xent(jp, wv, soft, ls, ignore, red, shape)
    t, tg = _xent(tp, wv, soft, ls, ignore, red, shape)
    assert _dt(t) == "float32" and list(t.shape) == list(j.shape)
    _close(t.numpy(), _xent_numpy(wv, soft, ls, ignore, red, shape),
           LOSS_TOL, "vs numpy")
    divergent = w and red == "mean" and (soft or shape == "N1")
    divergent = divergent or (w and soft)
    if not divergent:
        _close(t.numpy(), j.numpy(), LOSS_TOL, "value")
        _close(tg.numpy(), jg.numpy(), LOSS_TOL, "grad")


def test_pin_weighted_mean_of_n1_label():
    """Recorded divergence: with class weights, a [N, 1] label divides
    the mean by Σ weight[label] like a [N] label (Paddle documents the
    shapes as equivalent); the JAX package divides by N · weight[0]."""
    lab6 = np.array([0, 1, 2, 3, 1, 0])
    w = np.array([1, 2, 3, 4], np.float32)
    x = RNG.standard_normal((6, 4)).astype(np.float32)

    def run(P, lab):
        return float(P.nn.functional.cross_entropy(
            P.to_tensor(x), P.to_tensor(lab), weight=P.to_tensor(w)))
    t_n, t_n1 = run(tp, lab6), run(tp, lab6[:, None])
    j_n, j_n1 = run(jp, lab6), run(jp, lab6[:, None])
    assert math.isclose(t_n, t_n1, rel_tol=1e-6)
    assert math.isclose(t_n, j_n, rel_tol=1e-5)
    assert not math.isclose(j_n1, j_n, rel_tol=1e-2)
    assert math.isclose(j_n1 * 6 * w[0], t_n * w[lab6].sum(), rel_tol=1e-5)


def test_pin_softmax_with_cross_entropy_keeps_label_axis():
    """Recorded divergence: the loss keeps the label axis (size 1) for a
    [N, 1] label and for soft labels; the JAX package drops it there."""
    F, JF = tp.nn.functional, jp.nn.functional
    for lab, soft in ((LAB[:, None], False), (PROB, True), (LAB, False)):
        t = F.softmax_with_cross_entropy(tp.to_tensor(LOGITS),
                                         tp.to_tensor(lab), soft_label=soft)
        j = JF.softmax_with_cross_entropy(jp.to_tensor(LOGITS),
                                          jp.to_tensor(lab), soft_label=soft)
        assert list(t.shape) == [N, 1]
        _close(t.numpy().reshape(-1), np.asarray(j.numpy()).reshape(-1),
               LOSS_TOL, "value")


def test_cross_entropy_soft_label_gradient_to_label():
    """A soft label that is differentiated receives its gradient."""
    outs = []
    for P in PKGS:
        x = P.to_tensor(LOGITS, stop_gradient=False)
        s = P.to_tensor(PROB, stop_gradient=False)
        P.nn.functional.cross_entropy(x, s, soft_label=True,
                                      label_smoothing=0.1).backward()
        outs.append((x.grad.numpy(), s.grad.numpy()))
    for a, b in zip(*outs):
        _close(b, a, LOSS_TOL, "grad")


# ------------------------------------------------------------ CTC / RNN-T
def _ctc_inputs(infeasible=False):
    rng = np.random.default_rng(11)
    T, B, Cc, S = 7, 3, 5, 3
    lp = rng.standard_normal((T, B, Cc)).astype(np.float32)
    labels = rng.integers(1, Cc, (B, S)).astype(np.int32)
    il = np.array([7, 6, 2 if infeasible else 5], np.int64)
    ll = np.array([3, 2, 3 if infeasible else 1], np.int64)
    return lp, labels, il, ll


@pytest.mark.parametrize("red,norm,infeasible", [
    ("mean", False, False), ("sum", True, False), ("none", False, False),
    ("none", False, True)])
def test_ctc_loss(red, norm, infeasible):
    """Values and the gradient to the log-probabilities; an infeasible
    alignment (3 labels in 2 frames) gives the JAX package's value from
    the −1e30 sentinel."""
    lp, labels, il, ll = _ctc_inputs(infeasible)

    def fn(F, x, lb, i, l):
        return F.ctc_loss(F.log_softmax(x), lb, i, l, reduction=red,
                          norm_by_times=norm)
    # the infeasible row's "gradient" is float absorption around the
    # sentinel, not a derivative: compared by value only
    _check(fn, [lp, labels, il, ll], [True, False, False, False], LOSS_TOL,
           "ctc", grads=not infeasible)


@pytest.mark.parametrize("red,lam", [("mean", 0.001), ("none", 0.0),
                                     ("sum", 0.01)])
def test_rnnt_loss(red, lam):
    rng = np.random.default_rng(12)
    B, T, U, V = 2, 4, 3, 5
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    il = np.array([4, 3], np.int64)
    ll = np.array([3, 2], np.int64)
    _check(lambda F, x, lb, i, l: F.rnnt_loss(x, lb, i, l,
                                              fastemit_lambda=lam,
                                              reduction=red),
           [logits, labels, il, ll], [True, False, False, False], LOSS_TOL,
           "rnnt")


def test_hsigmoid_and_adaptive_functionals():
    """Both index by label: dtypes and shapes as well as values."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    lab = rng.integers(0, 7, (5, 1))
    w = rng.standard_normal((6, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    _check(lambda F, a, ww, bb: F.hsigmoid_loss(
        a, _T(F, lab), 7, ww, bb), [x, w, b], [True, True, True], LOSS_TOL,
        "hsigmoid")
    head = rng.standard_normal((6, 5)).astype(np.float32)
    t1 = [rng.standard_normal((6, 3)).astype(np.float32),
          rng.standard_normal((3, 4)).astype(np.float32)]
    t2 = [rng.standard_normal((6, 2)).astype(np.float32),
          rng.standard_normal((2, 5)).astype(np.float32)]
    lab2 = np.array([0, 2, 4, 9, 11])
    _check(lambda F, a, h, a1, b1, a2, b2: F.adaptive_log_softmax_with_loss(
        a, _T(F, lab2), h, [[a1, b1], [a2, b2]], [3, 7]),
        [x, head, *t1, *t2], [True] * 6, LOSS_TOL, "adaptive")


def _T(F, a):
    return (jp if F is jp.nn.functional else tp).to_tensor(a)


def test_ctc_greedy_decoder():
    rng = np.random.default_rng(14)
    probs = rng.standard_normal((3, 9, 4)).astype(np.float32)
    probs[0, 2:4, 1] = 9.0                       # a repeat to collapse
    probs[1, :, 0] = 9.0                         # all blank
    _check(lambda F, p: F.ctc_greedy_decoder(p, blank=0), [probs], [False],
           0.0, "ctc_greedy", grads=False)


# ----------------------------------------------------------------- common
X4 = RNG.standard_normal((2, 4, 6, 6)).astype(np.float32)
GRID = np.clip(1.2 * RNG.standard_normal((2, 3, 5, 2)), -1.3, 1.3).astype(
    np.float32)
COMMON = {
    "normalize": (lambda F, x: F.normalize(x, p=3, axis=1), [X4], [1]),
    "normalize_int": (lambda F, x: F.normalize(x), [XI], [0]),
    "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b, axis=1),
                          [X4, X4[::-1].copy()], [1, 1]),
    "pixel_shuffle": (lambda F, x: F.pixel_shuffle(x, 2), [X4], [1]),
    "pixel_shuffle_nhwc": (lambda F, x: F.pixel_shuffle(
        x, 2, data_format="NHWC"), [X4.transpose(0, 2, 3, 1).copy()], [1]),
    "pixel_unshuffle": (lambda F, x: F.pixel_unshuffle(x, 2), [X4], [1]),
    "channel_shuffle": (lambda F, x: F.channel_shuffle(x, 2), [X4], [1]),
    "channel_shuffle_int": (lambda F, x: F.channel_shuffle(x, 2),
                            [(X4 * 9).astype(np.int64)], [0]),
    "unfold": (lambda F, x: F.unfold(x, 3, strides=2, paddings=1), [X4],
               [1]),
    "unfold_pad4_dil": (lambda F, x: F.unfold(x, [2, 3], paddings=[1, 0, 2, 1],
                                              dilations=[1, 2]), [X4], [1]),
    "fold": (lambda F, x: F.fold(x, [5, 6], 2, strides=1),
             [RNG.standard_normal((2, 3 * 4, 20)).astype(np.float32)], [1]),
    "label_smooth": (lambda F, l: F.label_smooth(l, epsilon=0.2), [PROB],
                     [1]),
    "label_smooth_prior": (lambda F, l, p: F.label_smooth(l, p, 0.1),
                           [PROB, WC / WC.sum()], [1, 0]),
    "pairwise_distance": (lambda F, a, b: F.pairwise_distance(
        a, b, keepdim=True), [E, E[::-1].copy()], [1, 1]),
    "pairwise_distance_p1": (lambda F, a, b: F.pairwise_distance(a, b, 1.0),
                             [E, E[::-1].copy()], [1, 1]),
    "zeropad2d": (lambda F, x: F.zeropad2d(x, [1, 2, 0, 3]), [X4], [1]),
    "bilinear": (lambda F, a, b, w, bb: F.bilinear(a, b, w, bb),
                 [E[:, :3].copy(), E[:, 3:7].copy(),
                  RNG.standard_normal((2, 3, 4)).astype(np.float32),
                  np.array([0.1, -0.2], np.float32)], [1, 1, 1, 1]),
    "sequence_mask": (lambda F, x: F.sequence_mask(x, 6),
                      [np.array([2, 0, 5, 6])], [0]),
    "sequence_mask_bool_nomax": (lambda F, x: F.sequence_mask(
        x, dtype="bool"), [np.array([[2, 1], [3, 0]])], [0]),
    "sequence_mask_f32": (lambda F, x: F.sequence_mask(x, 4, "float32"),
                          [np.array([1, 3])], [0]),
    "temporal_shift": (lambda F, x: F.temporal_shift(x, 2, 0.25),
                       [RNG.standard_normal((4, 8, 2, 2)).astype(np.float32)],
                       [1]),
    "temporal_shift_nhwc": (lambda F, x: F.temporal_shift(
        x, 2, 0.25, "NHWC"), [RNG.standard_normal((4, 2, 2, 8)).astype(
            np.float32)], [1]),
    "affine_grid": (lambda F, t: F.affine_grid(t, [2, 3, 4, 5]),
                    [RNG.standard_normal((2, 2, 3)).astype(np.float32)], [1]),
    "affine_grid_nac": (lambda F, t: F.affine_grid(t, [2, 3, 4, 5], False),
                        [RNG.standard_normal((2, 2, 3)).astype(np.float32)],
                        [1]),
    "grid_sample": (lambda F, x, g: F.grid_sample(x, g), [X4, GRID], [1, 1]),
    "grid_sample_nearest_ac0": (lambda F, x, g: F.grid_sample(
        x, g, mode="nearest", align_corners=False), [X4, GRID], [1, 0]),
    "grid_sample_border": (lambda F, x, g: F.grid_sample(
        x, g, padding_mode="border"), [X4, GRID], [1, 1]),
    "gather_tree": (lambda F, i, p: F.gather_tree(i, p),
                    [np.random.default_rng(3).integers(0, 9, (5, 2, 3)),
                     np.random.default_rng(4).integers(0, 3, (5, 2, 3))],
                    [0, 0]),
    "local_response_norm": (lambda F, x: F.local_response_norm(
        x, 3, alpha=0.1, k=2.0), [X4], [1]),
    "local_response_norm_even": (lambda F, x: F.local_response_norm(x, 4),
                                 [X4[:, :, :, 0].copy()], [1]),
    "spectral_norm": (lambda F, w: F.spectral_norm(w, power_iters=3),
                      [RNG.standard_normal((4, 6)).astype(np.float32)], [1]),
    "spectral_norm_u_axis1": (lambda F, w, u: F.spectral_norm(
        w, axis=1, power_iters=2, u=u),
        [RNG.standard_normal((3, 5, 2)).astype(np.float32),
         np.full(5, 5 ** -0.5, np.float32)], [1, 0]),
    "one_hot": (lambda F, x: F.one_hot(x, 5), [np.array([[0, 4], [2, 7]])],
                [0]),
    "interpolate_nearest_up": (lambda F, x: F.interpolate(
        x, scale_factor=2), [X4], [1]),
    "interpolate_bilinear_up": (lambda F, x: F.interpolate(
        x, size=[9, 12], mode="bilinear"), [X4], [1]),
    "interpolate_linear_nwc": (lambda F, x: F.interpolate(
        x, scale_factor=3, mode="linear", data_format="NWC"),
        [X4[:, :, 0].transpose(0, 2, 1).copy()], [1]),
    "interpolate_trilinear": (lambda F, x: F.interpolate(
        x, scale_factor=2, mode="trilinear"), [X4[:, :, :3, :3, None].repeat(
            2, -1)], [1]),
}


@pytest.mark.parametrize("name", sorted(COMMON))
def test_common_functionals(name):
    fn, arrays, diff = COMMON[name]
    tol = ELEM_TOL if not name.startswith(("spectral", "grid", "local",
                                           "fold", "bilinear", "affine")) \
        else LOSS_TOL
    # affine_grid's base grid is a float64 linspace under x64 in the JAX
    # package, f32 in the port
    _check(fn, arrays, [bool(d) for d in diff], tol, name,
           f7=name.startswith("affine"))


PAD_X = RNG.standard_normal((2, 3, 4, 5)).astype(np.float32)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("fmt,pad", [("NCHW", [1, 2, 0, 3]),
                                     ("NHWC", [1, 0, 2, 1]),
                                     ("NCHW", [0, 1, 1, 0, 2, 0, 1, 2]),
                                     ("NCL", [2, 1])])
def test_pad_modes_and_layouts(mode, fmt, pad):
    x = PAD_X if fmt != "NCL" else PAD_X[:, :, 0]
    _check(lambda F, a: F.pad(a, pad, mode=mode, value=0.5,
                              data_format=fmt), [x], [True], ELEM_TOL,
           f"pad {mode} {fmt}")


def test_pad_integer_and_bool_keep_dtype():
    _check(lambda F, a: F.pad(a, [1, 1], value=3), [XI], [False], 0.0,
           "pad int")
    _check(lambda F, a: F.pad(a, [1, 1]), [XB], [False], 0.0, "pad bool")


def test_pin_grid_sample_reflection():
    """Recorded divergence: reflection padding reflects only the
    coordinates outside the image, as Paddle documents; the JAX package
    also mirrors those inside it, so an identity grid flips the image."""
    x = np.arange(12, dtype=np.float32).reshape(1, 1, 3, 4)
    theta = np.array([[[1, 0, 0], [0, 1, 0]]], np.float32)
    for ac in (True, False):
        outs = []
        for P in PKGS:
            F = P.nn.functional
            g = F.affine_grid(P.to_tensor(theta), [1, 1, 3, 4],
                              align_corners=ac)
            outs.append(np.asarray(F.grid_sample(
                P.to_tensor(x), g, padding_mode="reflection",
                align_corners=ac).numpy()))
        np.testing.assert_allclose(outs[1], x, atol=1e-5)
        assert not np.allclose(outs[0], x, atol=1e-2)
    # outside the image: a coordinate past the edge comes back inside
    g = tp.to_tensor(np.array([[[[1.5, 0.0]]]], np.float32))
    out = tp.nn.functional.grid_sample(tp.to_tensor(x), g,
                                       padding_mode="reflection")
    # x = 3.75 on [0, 3] comes back to 2.25 on row 1 (values 4..7)
    np.testing.assert_allclose(out.numpy().ravel(), [6.25], atol=1e-5)


def test_flash_attn_unpadded_refuses():
    for P in PKGS:
        with pytest.raises(NotImplementedError):
            P.nn.functional.flash_attn_unpadded(None)


def test_pin_interpolate_documented_modes():
    """Recorded divergence: the port follows Paddle's documented modes
    where `jax.image.resize` does not: align_corners=True maps the
    corners onto each other, align_mode=1 samples at dst·in/out, area
    averages, and downsampling takes no antialias."""
    x = np.arange(2 * 5, dtype=np.float32).reshape(1, 2, 5)
    F = tp.nn.functional
    ac = F.interpolate(tp.to_tensor(x), size=[9], mode="linear",
                       align_corners=True, data_format="NCW").numpy()
    np.testing.assert_allclose(ac[0, 0], np.linspace(0, 4, 9), atol=1e-6)
    am1 = F.interpolate(tp.to_tensor(x), size=[10], mode="linear",
                        align_mode=1, data_format="NCW").numpy()
    want = np.interp(np.arange(10) * 0.5, np.arange(5), x[0, 0])
    np.testing.assert_allclose(am1[0, 0], want, atol=1e-6)
    x2 = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    area = F.interpolate(tp.to_tensor(x2), size=[2, 2], mode="area").numpy()
    np.testing.assert_allclose(area[0, 0], [[2.5, 4.5], [10.5, 12.5]])
    near = F.interpolate(tp.to_tensor(x2), size=[2, 2]).numpy()
    np.testing.assert_allclose(near[0, 0], [[0, 2], [8, 10]])
    jac = jp.nn.functional.interpolate(jp.to_tensor(x), size=[9],
                                       mode="linear", align_corners=True,
                                       data_format="NCW").numpy()
    assert not np.allclose(np.asarray(jac), ac, atol=1e-3)


# ------------------------------------------------------------ random draws
@pytest.mark.parametrize("name", ["rrelu", "gumbel_softmax", "dropout2d",
                                  "dropout3d", "alpha_dropout"])
def test_random_functions_eval_mode_exact(name):
    """Recorded divergence family: the draws come from torch generators.
    In eval mode (no draw) the two packages agree exactly."""
    x5 = RNG.standard_normal((2, 3, 4, 2, 2)).astype(np.float32)
    fns = {"rrelu": lambda F, x: F.rrelu(x, 0.1, 0.3, training=False),
           "gumbel_softmax": None,
           "dropout2d": lambda F, x: F.dropout2d(x[:, :, 0], 0.5,
                                                 training=False),
           "dropout3d": lambda F, x: F.dropout3d(x, 0.5, training=False),
           "alpha_dropout": lambda F, x: F.alpha_dropout(x, 0.5,
                                                         training=False)}
    if name == "gumbel_softmax":
        # no eval mode: at logit gaps far above the Gumbel noise the hard
        # sample is the argmax's one-hot in both
        for P in PKGS:
            y = P.nn.functional.gumbel_softmax(
                P.to_tensor(1e4 * LOGITS), hard=True)
            assert np.array_equal(np.asarray(y.numpy()).sum(-1), np.ones(N))
            assert np.array_equal(np.asarray(y.numpy()).argmax(-1),
                                  LOGITS.argmax(-1))
        return
    _check(fns[name], [x5], [True], 0.0, name)


def test_random_functions_training_by_distribution():
    tp.seed(3)
    F = tp.nn.functional
    x = tp.to_tensor(-np.ones((200, 100), np.float32))
    slope = -F.rrelu(x, 0.1, 0.3).numpy()
    assert 0.1 <= slope.min() and slope.max() <= 0.3
    assert abs(slope.mean() - 0.2) < 2e-3 and abs(slope.std() - 0.2 /
                                                  math.sqrt(12)) < 2e-3
    ones = tp.to_tensor(np.ones((400, 50, 3, 3), np.float32))
    d = F.dropout2d(ones, 0.3).numpy()
    per_ch = d.reshape(400, 50, 9)
    assert (per_ch.min(-1) == per_ch.max(-1)).all()      # whole channels
    assert abs((per_ch[..., 0] == 0).mean() - 0.3) < 0.02
    assert set(np.unique(d)) <= {0.0, np.float32(1 / 0.7)}
    a = F.alpha_dropout(tp.to_tensor(np.random.default_rng(0).standard_normal(
        (500, 400)).astype(np.float32)), 0.2).numpy()
    assert abs(a.mean()) < 0.02 and abs(a.std() - 1.0) < 0.02
    g = F.gumbel_softmax(tp.to_tensor(np.zeros((20000, 4), np.float32)),
                         hard=True)
    assert np.allclose(g.numpy().sum(-1), 1.0)
    assert np.abs(g.numpy().mean(0) - 0.25).max() < 0.02
    logits = tp.to_tensor(LOGITS, stop_gradient=False)
    y = F.gumbel_softmax(logits, hard=True)
    (y * tp.to_tensor(Y)).sum().backward()       # straight-through
    assert np.abs(logits.grad.numpy()).max() > 0


# ------------------------------------------------------------- namespaces
# names of the JAX package's namespaces that are not part of its API: the
# import leaks of nn/functional, and the two that wait for later items
_LEAKS = {"Tensor", "annotations", "as_array", "defop", "eager",
          "flash_attention_fwd", "mha_ref"}
_LATER = {"DataParallel": "ROADMAP Queue 1 item 8 (multi-GPU)",
          "quant": "ROADMAP Queue 1 item 7 (quantization/)"}


def _public(mod):
    import types
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("ns", ["nn", "nn.functional"])
def test_namespace_matches_the_jax_package(ns):
    """Every public name of the JAX package's namespace is in the port's,
    less the import leaks and the two later items; what the port has
    beyond it are the in-place twins of ops.INPLACE and their list."""
    jmod, tmod = jp, tp
    for part in ns.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    want = _public(jmod) - _LEAKS - set(_LATER)
    have = _public(tmod)
    assert want - have == set()
    extra = have - want
    assert all(n.endswith("_") and n[:-1] in have or n == "INPLACE_OPS"
               for n in extra), sorted(extra)
    if ns == "nn":
        assert "layers_transformer" in dir(tmod) and "utils" in have
