"""The port's vision path against the JAX package, on the CPU: the conv
and pool functionals, batch_norm, the norm layers, ResNet-18 and -50,
the optimizers SGD and Momentum with the LR schedulers, and the
transforms.

Tolerances (f32; both sides run the same arithmetic in another order):
  * conv, pool and norm functionals: 1e-5 relative to the output's
    largest magnitude; pool indices, unpooling and the pool values they
    select exactly.
  * batch_norm: outputs and the running statistics after 3 training
    steps within 1e-5; eval mode likewise.
  * ResNet forwards (2 x 3 x 64 x 64, weights carried by
    `state_dict()`): logits within 1e-4 of their largest magnitude (50
    layers of f32 convolutions and batch statistics); one Momentum step
    (lr 0.1, momentum 0.9, weight decay 1e-4) moves every parameter to
    within 1e-4 of the parameters' largest move, and every BatchNorm
    running statistic within 1e-4 of the statistics' largest move.
  * SGD, Momentum and Nesterov on a Linear over 5 steps under a
    scheduler: parameters within 1e-6 relative.
  * LR schedulers: the 30-step sequences of both packages are equal.
  * transforms: seeded crops and flips bit-equal; Resize (the port's
    antialiased `F.interpolate` against `jax.image.resize`) is measured:
    f32 within 2e-3 of the 0-255 range when it downsamples by 2-3x and
    within 1e-4 when it upsamples, uint8 within 1 level.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402,F401
import paddle_tpu as jp  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu.vision import models as jmodels  # noqa: E402
from paddle_tpu.vision import transforms as JT  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nn import functional as TFn  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402
from paddle_tpu_torch.vision import models as tmodels  # noqa: E402
from paddle_tpu_torch.vision import transforms as TT  # noqa: E402

FN_TOL = 1e-5
BN_TOL = 1e-5
RESNET_TOL = 1e-4
STEP_TOL = 1e-4
OPT_TOL = 1e-6
RESIZE_DOWN_TOL = 2e-3 * 255
RESIZE_UP_TOL = 1e-4 * 255


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _both(fn_j, fn_t, *arrays, **kw):
    j = fn_j(*[jp.to_tensor(a) for a in arrays], **kw)
    t = fn_t(*[tp.to_tensor(a) for a in arrays], **kw)
    return j, t


# ------------------------------------------------------------ convolutions
CONV2D_CASES = [
    dict(stride=1, padding=0),
    dict(stride=2, padding=1),
    dict(stride=1, padding="SAME"),
    dict(stride=2, padding="SAME"),
    dict(stride=2, padding="VALID"),
    dict(stride=1, padding=[1, 2]),
    dict(stride=1, padding=[0, 1, 2, 1]),           # uneven (lo, hi) pairs
    dict(stride=1, padding=2, dilation=2),
    dict(stride=1, padding=1, groups=2),
    dict(stride=2, padding=1, data_format="NHWC"),
]


@pytest.mark.parametrize("case", CONV2D_CASES, ids=str)
def test_conv2d_matches_jax(case):
    nhwc = case.get("data_format") == "NHWC"
    x = _x((2, 9, 11, 4) if nhwc else (2, 4, 9, 11))
    w = _x((6, 4 // case.get("groups", 1), 3, 3), 1)
    b = _x((6,), 2)
    j, t = _both(JF.conv2d, TFn.conv2d, x, w, b, **case)
    _rel(t.numpy(), j.numpy(), FN_TOL)


@pytest.mark.parametrize("nd,case", [
    (1, dict(stride=2, padding="SAME")), (1, dict(padding=1, dilation=2)),
    (1, dict(padding=[[0, 0], [0, 0], [2, 1]])),
    (3, dict(stride=2, padding=1)), (3, dict(padding="SAME", groups=2))],
    ids=str)
def test_conv1d_3d_match_jax(nd, case):
    shape = (2, 4) + (7,) * nd
    w = _x((4, 4 // case.get("groups", 1)) + (3,) * nd, 1)
    j, t = _both(getattr(JF, f"conv{nd}d"), getattr(TFn, f"conv{nd}d"),
                 _x(shape), w, **case)
    _rel(t.numpy(), j.numpy(), FN_TOL)


@pytest.mark.parametrize("case", [
    dict(stride=2, padding=1, output_padding=1),
    dict(stride=2, padding=0),
    dict(stride=3, padding=[1, 2]),
    dict(stride=2, padding=1, groups=2),
    dict(stride=1, padding=1, data_format="NHWC")], ids=str)
def test_conv2d_transpose_matches_jax(case):
    nhwc = case.get("data_format") == "NHWC"
    x = _x((2, 5, 6, 4) if nhwc else (2, 4, 5, 6))
    w = _x((4, 6 // case.get("groups", 1), 3, 3), 1)
    b = _x((6,), 2)
    j, t = _both(JF.conv2d_transpose, TFn.conv2d_transpose, x, w, b, **case)
    _rel(t.numpy(), j.numpy(), FN_TOL)


def test_conv2d_transpose_string_padding():
    """The JAX package refuses string paddings for transposes; the port
    gives in · stride outputs for "SAME" and the full result for "VALID"
    (its first and last rows then hold a lone tap of the kernel)."""
    x = tp.to_tensor(_x((1, 2, 5, 6)))
    w = tp.to_tensor(_x((2, 3, 3, 3), 1))
    assert TFn.conv2d_transpose(x, w, stride=2, padding="SAME").shape == \
        [1, 3, 10, 12]
    full = TFn.conv2d_transpose(x, w, stride=2, padding="VALID")
    assert full.shape == [1, 3, 11, 13]
    same = TFn.conv2d_transpose(x, w, stride=2, padding=[0, 1, 0, 1])
    np.testing.assert_array_equal(full.numpy()[:, :, :10, :12], same.numpy())


@pytest.mark.parametrize("nd", [1, 3])
def test_conv_transpose_1d_3d_match_jax(nd):
    x = _x((2, 3) + (5,) * nd)
    w = _x((3, 4) + (3,) * nd, 1)
    j, t = _both(getattr(JF, f"conv{nd}d_transpose"),
                 getattr(TFn, f"conv{nd}d_transpose"), x, w, stride=2,
                 padding=1, output_padding=1)
    _rel(t.numpy(), j.numpy(), FN_TOL)


# ------------------------------------------------------------------ pools
POOL_CASES = [
    dict(kernel_size=2),
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, stride=2, padding="SAME"),
    dict(kernel_size=3, stride=1, padding="VALID"),
    dict(kernel_size=3, stride=2, padding=[0, 1, 1, 2]),
    dict(kernel_size=(2, 3), stride=(1, 2), padding=(1, 1)),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=str)
@pytest.mark.parametrize("op", ["max", "avg"])
def test_pool2d_matches_jax(case, op):
    x = _x((2, 3, 9, 10))
    j, t = _both(getattr(JF, f"{op}_pool2d"), getattr(TFn, f"{op}_pool2d"),
                 x, **case)
    _rel(t.numpy(), j.numpy(), FN_TOL)


@pytest.mark.parametrize("exclusive", [True, False])
def test_avg_pool_exclusive_matches_jax(exclusive):
    x = _x((2, 3, 8, 8))
    j, t = _both(JF.avg_pool2d, TFn.avg_pool2d, x, kernel_size=3, stride=2,
                 padding=1, exclusive=exclusive)
    _rel(t.numpy(), j.numpy(), FN_TOL)
    j, t = _both(JF.avg_pool1d, TFn.avg_pool1d, x[:, :, 0], kernel_size=3,
                 stride=2, padding=1, exclusive=exclusive)
    _rel(t.numpy(), j.numpy(), FN_TOL)


def test_pool_nhwc_and_3d_match_jax():
    x = _x((2, 7, 8, 3))
    for op in ("max", "avg"):
        j, t = _both(getattr(JF, f"{op}_pool2d"),
                     getattr(TFn, f"{op}_pool2d"), x, kernel_size=3,
                     stride=2, padding=1, data_format="NHWC")
        _rel(t.numpy(), j.numpy(), FN_TOL)
        j, t = _both(getattr(JF, f"{op}_pool3d"),
                     getattr(TFn, f"{op}_pool3d"), _x((1, 2, 6, 7, 8)),
                     kernel_size=2, stride=2)
        _rel(t.numpy(), j.numpy(), FN_TOL)


@pytest.mark.parametrize("nd,case", [
    (1, dict(kernel_size=3, stride=2, padding=1)),
    (2, dict(kernel_size=2)),
    (2, dict(kernel_size=3, stride=2, padding=1)),
    (2, dict(kernel_size=3, stride=2, padding=[0, 1, 1, 2])),
    (3, dict(kernel_size=2, stride=2))], ids=str)
def test_max_pool_mask_and_unpool_match_jax(nd, case):
    x = _x((2, 3) + (8,) * nd)
    (jo, ji), (to, ti) = _both(getattr(JF, f"max_pool{nd}d"),
                               getattr(TFn, f"max_pool{nd}d"), x,
                               return_mask=True, **case)
    np.testing.assert_array_equal(to.numpy(), jo.numpy())
    np.testing.assert_array_equal(ti.numpy(), ji.numpy())
    if case.get("padding") in (0, None) or isinstance(case.get("padding"),
                                                      int):
        kw = {k: v for k, v in case.items()}
        ju = getattr(JF, f"max_unpool{nd}d")(jo, ji, **kw)
        tu = getattr(TFn, f"max_unpool{nd}d")(to, ti, **kw)
        np.testing.assert_array_equal(tu.numpy(), ju.numpy())


@pytest.mark.parametrize("size", [(1, 1), (3, 4), (4, 5), 5])
@pytest.mark.parametrize("op", ["avg", "max"])
def test_adaptive_pool2d_matches_jax(size, op):
    x = _x((2, 3, 10, 12))
    j, t = _both(getattr(JF, f"adaptive_{op}_pool2d"),
                 getattr(TFn, f"adaptive_{op}_pool2d"), x, output_size=size)
    _rel(t.numpy(), j.numpy(), FN_TOL)


def test_adaptive_pool_1d_3d_and_mask_match_jax():
    for op in ("avg", "max"):
        j, t = _both(getattr(JF, f"adaptive_{op}_pool1d"),
                     getattr(TFn, f"adaptive_{op}_pool1d"), _x((2, 3, 11)),
                     output_size=4)
        _rel(t.numpy(), j.numpy(), FN_TOL)
        j, t = _both(getattr(JF, f"adaptive_{op}_pool3d"),
                     getattr(TFn, f"adaptive_{op}_pool3d"),
                     _x((1, 2, 4, 6, 8)), output_size=(2, 3, 4))
        _rel(t.numpy(), j.numpy(), FN_TOL)
    (jo, ji), (to, ti) = _both(JF.adaptive_max_pool2d,
                               TFn.adaptive_max_pool2d, _x((2, 3, 8, 12)),
                               output_size=(2, 3), return_mask=True)
    np.testing.assert_array_equal(ti.numpy(), ji.numpy())


def test_lp_and_fractional_pools_match_jax():
    x = np.abs(_x((2, 3, 9, 9))) + 0.1
    for p in (1.0, 2.0, 3.0):
        j, t = _both(JF.lp_pool2d, TFn.lp_pool2d, x, norm_type=p,
                     kernel_size=3, stride=2)
        _rel(t.numpy(), j.numpy(), FN_TOL)
    j, t = _both(JF.lp_pool1d, TFn.lp_pool1d, x[:, :, 0], norm_type=2,
                 kernel_size=2)
    _rel(t.numpy(), j.numpy(), FN_TOL)
    for u in (0.2, 0.7):
        j, t = _both(JF.fractional_max_pool2d, TFn.fractional_max_pool2d, x,
                     output_size=4, random_u=u)
        np.testing.assert_array_equal(t.numpy(), j.numpy())
        j, t = _both(JF.fractional_max_pool3d, TFn.fractional_max_pool3d,
                     _x((1, 2, 7, 8, 9)), output_size=(3, 4, 5), random_u=u)
        np.testing.assert_array_equal(t.numpy(), j.numpy())


# ------------------------------------------------------------------- norms
def _twin(build):
    jp.seed(0)
    j = build(jp)
    t = build(tp)
    missing, unexpected = t.set_state_dict(
        {k: v.numpy() for k, v in j.state_dict().items()})
    assert not missing and not unexpected
    return j, t


@pytest.mark.parametrize("layer,shape", [
    ("BatchNorm2D", (4, 3, 5, 6)), ("BatchNorm1D", (6, 3, 7)),
    ("BatchNorm3D", (2, 3, 4, 5, 3)), ("BatchNorm", (4, 3, 5, 5))])
def test_batch_norm_train_eval_and_running_stats(layer, shape):
    j, t = _twin(lambda p: getattr(p.nn, layer)(3, momentum=0.8))
    assert list(t.state_dict()) == list(j.state_dict())
    for step in range(3):
        x = _x(shape, step) * 2.0 + 0.5
        jo, to = j(jp.to_tensor(x)), t(tp.to_tensor(x))
        _rel(to.numpy(), jo.numpy(), BN_TOL)
    _rel(t._mean.numpy(), j._mean.numpy(), BN_TOL)
    _rel(t._variance.numpy(), j._variance.numpy(), BN_TOL)
    j.eval()
    t.eval()
    x = _x(shape, 9)
    _rel(t(tp.to_tensor(x)).numpy(), j(jp.to_tensor(x)).numpy(), BN_TOL)


def test_batch_norm_functional_nhwc_and_global_stats():
    x = _x((4, 5, 6, 3)) + 1.0
    rm, rv = np.zeros(3, np.float32), np.ones(3, np.float32)
    w, b = _x((3,), 1), _x((3,), 2)
    outs = []
    for p, F in ((jp, JF), (tp, TFn)):
        m, v = p.to_tensor(rm), p.to_tensor(rv)
        o = F.batch_norm(p.to_tensor(x), m, v, p.to_tensor(w), p.to_tensor(b),
                         training=True, data_format="NHWC")
        g = F.batch_norm(p.to_tensor(x), m, v, training=True,
                         use_global_stats=True, data_format="NHWC")
        outs.append((o.numpy(), m.numpy(), v.numpy(), g.numpy()))
    for a, b_ in zip(outs[1], outs[0]):
        _rel(a, b_, BN_TOL)


def test_batch_norm_under_o1_computes_in_f32():
    bn = tp.nn.BatchNorm2D(3)
    conv = tp.nn.Conv2D(3, 3, 3, padding=1)
    with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
        h = conv(tp.to_tensor(_x((2, 3, 6, 6))))
        out = bn(h)
    assert h.dtype == torch.bfloat16
    assert out.dtype == torch.float32 and bn._mean.dtype == torch.float32


@pytest.mark.parametrize("layer", ["GroupNorm", "InstanceNorm2D"])
def test_group_and_instance_norm_match_jax(layer):
    build = (lambda p: p.nn.GroupNorm(2, 4)) if layer == "GroupNorm" else \
        (lambda p: p.nn.InstanceNorm2D(4))
    j, t = _twin(build)
    x = _x((3, 4, 5, 6)) * 3.0
    _rel(t(tp.to_tensor(x)).numpy(), j(jp.to_tensor(x)).numpy(), BN_TOL)


def test_sync_batch_norm_raises():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tp.nn.SyncBatchNorm(4)


def test_conv_layers_and_buffers_carry_across():
    j, t = _twin(lambda p: p.nn.Sequential(
        p.nn.Conv2D(3, 4, 3, stride=2, padding=1), p.nn.BatchNorm2D(4),
        p.nn.Conv2DTranspose(4, 2, 3, stride=2, padding=1, output_padding=1),
        p.nn.MaxPool2D(2), p.nn.AdaptiveAvgPool2D(1)))
    assert [k for k, _ in t.named_buffers()] == ["1._mean", "1._variance"]
    x = _x((2, 3, 8, 8))
    _rel(t(tp.to_tensor(x)).numpy(), j(jp.to_tensor(x)).numpy(), FN_TOL)


# ----------------------------------------------------------------- ResNet
def _resnet_twin(name):
    jp.seed(0)
    j = getattr(jmodels, name)(num_classes=10)
    tp.seed(0)
    t = getattr(tmodels, name)(num_classes=10)
    sd = {k: v.numpy() for k, v in j.state_dict().items()}
    assert list(sd) == list(t.state_dict())
    missing, unexpected = t.set_state_dict(sd)
    assert not missing and not unexpected
    return j, t


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_forward_matches_jax(name):
    j, t = _resnet_twin(name)
    x = _x((2, 3, 64, 64))
    _rel(t(tp.to_tensor(x)).numpy(), j(jp.to_tensor(x)).numpy(), RESNET_TOL)
    j.eval()
    t.eval()
    _rel(t(tp.to_tensor(x)).numpy(), j(jp.to_tensor(x)).numpy(), RESNET_TOL)


def test_resnet_constructors_and_pretrained():
    tp.seed(0)
    m = tmodels.resnext50_32x4d(num_classes=4)
    assert m.layer1[0].conv2._groups == 32
    assert tmodels.wide_resnet50_2(num_classes=4).layer1[0].conv1 \
        ._out_channels == 128
    with pytest.raises(NotImplementedError):
        tmodels.resnet50(pretrained=True)


def test_resnet18_momentum_step_matches_jax():
    j, t = _resnet_twin("resnet18")
    x = _x((2, 3, 64, 64))
    y = np.array([1, 7], np.int64)
    before = {k: v.numpy().copy() for k, v in t.state_dict().items()}
    for p, m in ((jp, j), (tp, t)):
        opt = p.optimizer.Momentum(
            learning_rate=p.optimizer.lr.PiecewiseDecay([10], [0.1, 0.01]),
            momentum=0.9, weight_decay=1e-4, parameters=m.parameters())
        loss = p.nn.functional.cross_entropy(m(p.to_tensor(x)),
                                             p.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
    jsd = {k: v.numpy() for k, v in j.state_dict().items()}
    tsd = {k: v.numpy() for k, v in t.state_dict().items()}
    stats = {k for k, _ in t.named_buffers()}
    # the parameters against their own largest move, the running
    # statistics against theirs
    for group in (set(jsd) - stats, stats):
        moves = max(float(np.abs(jsd[k] - before[k]).max()) for k in group)
        assert moves > 0
        for k in group:
            err = float(np.abs(tsd[k] - jsd[k]).max())
            assert err <= STEP_TOL * moves, (k, err, moves)


# ------------------------------------------------------- optimizers, lr
@pytest.mark.parametrize("kind", ["SGD", "Momentum", "Nesterov"])
def test_sgd_and_momentum_match_jax(kind):
    j, t = _twin(lambda p: p.nn.Linear(8, 6))
    xs = [_x((4, 8), s) for s in range(5)]
    for p, m in ((jp, j), (tp, t)):
        sched = p.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        if kind == "SGD":
            opt = p.optimizer.SGD(sched, parameters=m.parameters(),
                                  weight_decay=0.01)
        else:
            opt = p.optimizer.Momentum(sched, momentum=0.9,
                                       parameters=m.parameters(),
                                       use_nesterov=kind == "Nesterov",
                                       weight_decay=0.01)
        for x in xs:
            loss = (m(p.to_tensor(x)) ** 2).mean() \
                if p is jp else (m(p.to_tensor(x)) * m(p.to_tensor(x))).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
        m._opt = opt
    for k, v in t.state_dict().items():
        _rel(v.numpy(), j.state_dict()[k].numpy(), OPT_TOL)
    sd = t._opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 5
    assert t._opt.get_lr() == j._opt.get_lr()
    if kind != "SGD":
        for jpar, tpar in zip(j.parameters(), t.parameters()):
            _rel(t._opt._state[id(tpar)]["velocity"].numpy(),
                 np.asarray(j._opt._state[id(jpar)]["velocity"]), OPT_TOL)


def test_optimizer_lr_api():
    m = tp.nn.Linear(2, 2)
    opt = tp.optimizer.Momentum(0.1, parameters=m.parameters())
    opt.set_lr(0.05)
    assert opt.get_lr() == 0.05
    sched = tp.optimizer.lr.CosineAnnealingDecay(0.1, T_max=4)
    opt.set_lr_scheduler(sched)
    with pytest.raises(RuntimeError):
        opt.set_lr(0.2)
    sched.step()
    state = opt.state_dict()
    fresh = tp.optimizer.Momentum(tp.optimizer.lr.CosineAnnealingDecay(
        0.1, T_max=4), parameters=m.parameters())
    fresh.set_state_dict(state)
    assert fresh.get_lr() == opt.get_lr()


def _schedulers(lr):
    return [
        lr.NoamDecay(64, 5, learning_rate=2.0),
        lr.PiecewiseDecay([5, 12], [0.1, 0.05, 0.01]),
        lr.NaturalExpDecay(0.1, 0.3),
        lr.InverseTimeDecay(0.1, 0.5),
        lr.PolynomialDecay(0.1, 10, end_lr=0.001, power=2.0),
        lr.PolynomialDecay(0.1, 7, cycle=True),
        lr.LinearWarmup(0.1, 5, 0.0, 0.1),
        lr.LinearWarmup(lr.StepDecay(0.1, 4), 5, 0.01, 0.1),
        lr.ExponentialDecay(0.1, 0.9),
        lr.MultiStepDecay(0.1, [4, 9, 20]),
        lr.StepDecay(0.1, 6, 0.5),
        lr.LambdaDecay(0.1, lambda e: 0.95 ** e),
        lr.CosineAnnealingDecay(0.1, 12, eta_min=0.001),
        lr.CosineAnnealingWarmRestarts(0.1, 5, T_mult=2, eta_min=0.01),
        lr.OneCycleLR(0.1, 30),
        lr.OneCycleLR(0.1, 30, anneal_strategy="linear"),
        lr.CyclicLR(0.01, 0.1, 4),
        lr.CyclicLR(0.01, 0.1, 3, mode="triangular2"),
        lr.CyclicLR(0.01, 0.1, 3, mode="exp_range", exp_gamma=0.9),
        lr.MultiplicativeDecay(0.1, lambda e: 0.9),
        lr.LinearLR(0.1, 10),
    ]


def test_every_scheduler_matches_jax_over_30_steps():
    for js, ts in zip(_schedulers(jlr), _schedulers(tlr)):
        want, got = [], []
        for _ in range(30):
            want.append(js())
            got.append(ts())
            js.step()
            ts.step()
        assert got == want, type(ts).__name__
        assert ts.state_dict() == js.state_dict()


def test_reduce_on_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9]
    js = jlr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    ts = tlr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    for mval in metrics:
        js.step(mval)
        ts.step(tp.to_tensor(np.float32(mval)))
        assert ts() == js()


# ------------------------------------------------------------- transforms
def _seeded(tf_j, tf_t, img, seed=3):
    random.seed(seed)
    a = tf_j(img)
    random.seed(seed)
    b = tf_t(img)
    return a, b


def _img(h=40, w=48, seed=0, dtype=np.uint8):
    a = np.random.default_rng(seed).uniform(0, 255, (h, w, 3))
    return a.astype(dtype)


def test_seeded_crops_and_flips_equal_jax():
    img = _img()
    for name, args in (("RandomCrop", (24,)),
                       ("RandomCrop", (24, 4)),
                       ("RandomHorizontalFlip", (0.5,)),
                       ("RandomVerticalFlip", (0.5,)),
                       ("CenterCrop", (20,)), ("Pad", ((1, 2, 3, 4),)),
                       ("Transpose", ()), ("ToTensor", ()),
                       ("Normalize", ([0.5] * 3, [0.25] * 3, "HWC")),
                       ("BrightnessTransform", (0.4,)),
                       ("ColorJitter", (0.3, 0.3)),
                       ("ContrastTransform", (0.3,)),
                       ("SaturationTransform", (0.3,)),
                       ("HueTransform", (0.2,)), ("Grayscale", (3,)),
                       ("RandomRotation", (30,)),
                       ("RandomAffine", (20, (0.1, 0.1), (0.9, 1.1), 5)),
                       ("RandomPerspective", (1.0,)),
                       ("RandomErasing", (1.0,))):
        for seed in range(3):
            a, b = _seeded(getattr(JT, name)(*args), getattr(TT, name)(*args),
                           img, seed)
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_functional_transforms_equal_jax():
    img = _img()
    for name, args in (("hflip", ()), ("vflip", ()), ("crop", (2, 3, 10, 12)),
                       ("pad", (3, 0, "reflect")), ("rotate", (17,)),
                       ("adjust_brightness", (1.3,)),
                       ("adjust_contrast", (0.7,)), ("adjust_hue", (0.1,)),
                       ("adjust_saturation", (1.4,)),
                       ("to_grayscale", (1,)),
                       ("affine", (10, (2, 1), 1.1, (3, 2))),
                       ("perspective", ([(0, 0), (47, 0), (47, 39), (0, 39)],
                                        [(2, 1), (45, 3), (44, 37), (1, 38)])),
                       ("erase", (3, 4, 5, 6, 0))):
        np.testing.assert_array_equal(getattr(TT, name)(img, *args),
                                      getattr(JT, name)(img, *args),
                                      err_msg=name)
    chw = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    je = JT.erase(jp.to_tensor(chw), 1, 2, 2, 3, -1.0)
    te = TT.erase(tp.to_tensor(chw), 1, 2, 2, 3, -1.0)
    np.testing.assert_array_equal(te.numpy(), je.numpy())


@pytest.mark.parametrize("size,tol", [((17, 21), RESIZE_DOWN_TOL),
                                      ((20, 16), RESIZE_DOWN_TOL),
                                      ((64, 80), RESIZE_UP_TOL)])
def test_resize_gap_to_jax(size, tol):
    """The stated Resize tolerance: float images against
    jax.image.resize's antialiased bilinear, uint8 within one level."""
    img = _img(40, 48, dtype=np.float32)
    a = JT.Resize(size)(img)
    b = TT.Resize(size)(img)
    assert b.shape == a.shape == size + (3,)
    assert float(np.abs(b - a).max()) <= tol
    a8 = JT.Resize(size)(img.astype(np.uint8))
    b8 = TT.Resize(size)(img.astype(np.uint8))
    assert np.abs(b8.astype(int) - a8.astype(int)).max() <= 1
    an = JT.Resize(size, "nearest")(img)
    bn = TT.Resize(size, "nearest")(img)
    np.testing.assert_array_equal(bn, an)


def test_random_resized_crop_seeded_matches_jax():
    img = _img(64, 80)
    for seed in range(4):
        a, b = _seeded(JT.RandomResizedCrop(32), TT.RandomResizedCrop(32),
                       img, seed)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(b.astype(int) - a.astype(int)).max() <= 1
