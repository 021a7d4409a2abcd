"""The port's layer zoo of this slice against the JAX package's, on the
CPU: every activation and loss layer of `layers_act_loss`, the layers of
`layers_common`, RMSNorm, LocalResponseNorm and SpectralNorm, and
`nn.utils`.

Each layer is built in both packages with the same arguments; a layer
with parameters gets the same numpy values through `set_state_dict`.
Inputs are numpy draws from a seed. Compared: outputs (values, dtypes,
shapes) and, where a layer has parameters or the check is about
training, every parameter's gradient of sum(out · c). The JAX side of
a layer runs as one jitted program of its state
(`paddle_tpu.jit.functional_call` under `jax.value_and_grad`).

Tolerances (f32): 1e-6 of the largest element for elementwise layers,
1e-5 for losses, norms and gradients (the same expressions in another
summation order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jp  # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor  # noqa: E402
from paddle_tpu.jit import functional_call, state_of  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402

ELEM_TOL = 1e-6
TOL = 1e-5
PKGS = (jp, tp)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _dt(x):
    return str(x.dtype).replace("torch.", "")


def _close(t, j, tol, what=""):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    scale = max(np.abs(j).max(initial=0.0), 1e-30)
    err = np.abs(t - j).max(initial=0.0) / scale
    assert err <= tol, f"{what}: {err} > {tol}"


def _same(j, t, tol, what=""):
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t), what
        for a, b in zip(j, t):
            _same(a, b, tol, what)
        return
    assert _dt(t) == _dt(j) and list(t.shape) == list(j.shape), \
        (what, _dt(j), _dt(t), j.shape, t.shape)
    _close(t.numpy(), np.asarray(j.numpy()), tol, what)


RNG = np.random.default_rng(0)
X = (2.0 * RNG.standard_normal((2, 4, 3, 3))).astype(np.float32)
P = RNG.uniform(0.05, 0.95, (6, 5)).astype(np.float32)
Y = RNG.standard_normal((6, 5)).astype(np.float32)
B = (RNG.uniform(size=(6, 5)) > 0.5).astype(np.float32)
LAB = np.array([0, 3, 1, 4, 2, 3])
PM = np.where(RNG.uniform(size=6) > 0.5, 1.0, -1.0).astype(np.float32)
E = [RNG.standard_normal((6, 8)).astype(np.float32) for _ in range(3)]

ACT_LAYERS = [
    ("ReLU", (), {}), ("ReLU6", (), {}), ("GELU", (), {"approximate": True}),
    ("SiLU", (), {}), ("Silu", (), {}), ("Swish", (), {}),
    ("ELU", (0.5,), {}), ("SELU", (), {}), ("CELU", (), {"alpha": 2.0}),
    ("LeakyReLU", (0.1,), {}), ("Hardshrink", (), {"threshold": 1.0}),
    ("Softshrink", (), {}), ("Tanhshrink", (), {}),
    ("Hardtanh", (-0.5, 0.5), {}), ("Hardsigmoid", (), {}),
    ("Hardswish", (), {}), ("Mish", (), {}), ("Softplus", (), {"beta": 3.0}),
    ("Softsign", (), {}), ("LogSigmoid", (), {}), ("Tanh", (), {}),
    ("Sigmoid", (), {}), ("LogSoftmax", (), {"axis": 1}),
    ("Softmax", (), {"axis": 2}), ("Softmax2D", (), {}),
    ("Maxout", (2,), {}), ("ThresholdedReLU", (), {"threshold": 0.3}),
    ("GLU", (), {"axis": 1}), ("RReLU", (0.2, 0.4), {}),
]


def test_activation_layers():
    """Every activation layer in eval mode (RReLU's mean slope) on the
    same input; the JAX layers traced together in one program."""
    jls, tls = [], []
    for name, args, kw in ACT_LAYERS:
        j, t = (getattr(Pk.nn, name)(*args, **kw) for Pk in PKGS)
        j.eval()
        t.eval()
        jls.append(j)
        tls.append(t)
    jouts = jax.jit(lambda x: [L(JTensor(x))._data for L in jls])(
        jnp.asarray(X))
    for (name, _, _), jo, t in zip(ACT_LAYERS, jouts, tls):
        to = t(tp.to_tensor(X))
        assert _dt(to) == str(jo.dtype) and list(to.shape) == list(
            jo.shape), name
        _close(to.numpy(), np.asarray(jo), ELEM_TOL, name)


LOSS_LAYERS = [
    ("CrossEntropyLoss", {"label_smoothing": 0.1}, lambda T: (T(Y), T(LAB))),
    ("CrossEntropyLoss", {"soft_label": True, "reduction": "sum"},
     lambda T: (T(Y), T(P))),
    ("MSELoss", {}, lambda T: (T(Y), T(P))),
    ("L1Loss", {"reduction": "sum"}, lambda T: (T(Y), T(P))),
    ("NLLLoss", {"ignore_index": 3}, lambda T: (T(Y), T(LAB))),
    ("BCELoss", {}, lambda T: (T(P), T(B))),
    ("BCEWithLogitsLoss", {"reduction": "none"}, lambda T: (T(Y), T(B))),
    ("SmoothL1Loss", {"delta": 0.5}, lambda T: (T(Y), T(P))),
    ("KLDivLoss", {"reduction": "batchmean"}, lambda T: (T(Y), T(P))),
    ("MarginRankingLoss", {"margin": 0.2},
     lambda T: (T(Y[:, 0].copy()), T(Y[:, 1].copy()), T(PM))),
    ("TripletMarginLoss", {"swap": True}, lambda T: tuple(map(T, E))),
    ("TripletMarginWithDistanceLoss", {"margin": 0.5},
     lambda T: tuple(map(T, E))),
    ("CosineEmbeddingLoss", {"margin": 0.1},
     lambda T: (T(E[0]), T(E[1]), T(PM))),
    ("HingeEmbeddingLoss", {}, lambda T: (T(Y), T(np.sign(P - 0.5)))),
    ("HuberLoss", {"delta": 0.3}, lambda T: (T(Y), T(P))),
    ("SoftMarginLoss", {}, lambda T: (T(Y), T(np.sign(P - 0.5)))),
    ("MultiLabelSoftMarginLoss", {}, lambda T: (T(Y), T(B))),
    ("MultiMarginLoss", {"p": 2}, lambda T: (T(Y), T(LAB))),
    ("PoissonNLLLoss", {}, lambda T: (T(Y), T(np.round(3 * P)))),
    ("GaussianNLLLoss", {"full": True}, lambda T: (T(Y), T(E[0][:, :5]),
                                                   T(P))),
]


@pytest.mark.parametrize("i", range(len(LOSS_LAYERS)),
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(LOSS_LAYERS)])
def test_loss_layers(i):
    """Each loss layer: its value and the gradient to its first input."""
    name, kw, make = LOSS_LAYERS[i]
    arrays = make(lambda a: np.asarray(a))
    jl, tl = (getattr(Pk.nn, name)(**kw) for Pk in PKGS)
    jo, jg, _ = _jax_layer(jl, arrays[:1], arrays[1:])
    to, tg, _ = _fwd_bwd(tl, tp, arrays[0], labels=arrays[1:])
    _same_np(jo, to, TOL, name)
    _same_np(jg, [g for g in tg], TOL, name + " grad")


def _same_np(j, t, tol, what):
    """JAX arrays against port Tensors: dtype, shape, values."""
    assert len(j) == len(t), what
    for a, b in zip(j, t):
        assert _dt(b) == str(a.dtype) and list(b.shape) == list(a.shape), \
            (what, a.dtype, b.dtype, a.shape, b.shape)
        _close(b.numpy(), np.asarray(a), tol, what)


def _cot(k, shape):
    return np.random.default_rng(k).standard_normal(shape).astype(
        np.float32) if shape else np.float32(1.0)


def _jax_layer(layer, arrays, labels=()):
    """The JAX layer on `arrays` (differentiable) and `labels`, traced as
    one program of its state: (outputs, input grads, parameter grads) of
    Σ out_k · c_k with c_k = _cot(k, shape)."""
    state = state_of(layer)
    names = sorted(n for n, p in layer.named_parameters())
    rest = {n: v for n, v in state.items() if n not in names}

    def loss(params, ins):
        out, _ = functional_call(layer, dict(rest, **params),
                                 *[JTensor(a) for a in ins],
                                 *[JTensor(jnp.asarray(b)) for b in labels])
        outs = [o._data for o in (out if isinstance(out, (tuple, list))
                                  else (out,))]
        total = sum(jnp.sum(o * _cot(k, o.shape)) for k, o in
                    enumerate(outs))
        return total, outs

    params = {n: state[n] for n in names}
    (_, outs), (gp, gi) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            params, [jnp.asarray(a) for a in arrays])
    return outs, list(gi), gp


def _move(j, t):
    """The JAX layer's parameters (and buffers) into the port's."""
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})


def _grads(layer):
    return {n: p.grad for n, p in layer.named_parameters()}


def _fwd_bwd(layer, Pk, *arrays, labels=()):
    ins = [Pk.to_tensor(a, stop_gradient=False) for a in arrays]
    out = layer(*ins, *[Pk.to_tensor(lb) for lb in labels])
    outs = out if isinstance(out, (tuple, list)) else (out,)
    total = None
    for k, o in enumerate(outs):
        term = (o * Pk.to_tensor(_cot(k, o.shape))).sum()
        total = term if total is None else total + term
    total.backward()
    return outs, [i.grad for i in ins], _grads(layer)


@pytest.mark.parametrize("name", ["PReLU", "HSigmoidLoss",
                                  "AdaptiveLogSoftmaxWithLoss", "Bilinear",
                                  "RMSNorm", "LocalResponseNorm"])
def test_layers_with_parameters(name):
    """Values, dtypes and shapes of every output, the input gradients and
    every parameter's gradient; HSigmoidLoss and the adaptive softmax
    index by label, so dtypes and shapes matter most there."""
    rng = np.random.default_rng(5)
    x6 = rng.standard_normal((5, 6)).astype(np.float32)
    make = {
        "PReLU": (lambda Pk: Pk.nn.PReLU(4, init=0.1), (X,), ()),
        "HSigmoidLoss": (lambda Pk: Pk.nn.HSigmoidLoss(6, 7), (x6,),
                         (rng.integers(0, 7, (5, 1)),)),
        "AdaptiveLogSoftmaxWithLoss": (
            lambda Pk: Pk.nn.AdaptiveLogSoftmaxWithLoss(6, 12, [3, 7],
                                                        div_value=2.0,
                                                        head_bias=True),
            (x6,), (np.array([0, 2, 4, 9, 11]),)),
        "Bilinear": (lambda Pk: Pk.nn.Bilinear(6, 6, 3), (x6, x6[::-1]
                                                          .copy()), ()),
        "RMSNorm": (lambda Pk: Pk.nn.RMSNorm(6, epsilon=1e-5), (x6,), ()),
        "LocalResponseNorm": (lambda Pk: Pk.nn.LocalResponseNorm(
            3, alpha=0.05), (X,), ()),
    }
    build, arrays, labels = make[name]
    jl, tl = build(jp), build(tp)
    if name != "LocalResponseNorm":
        for p in jl.parameters():
            p.set_value(rng.standard_normal(p.shape).astype(np.float32))
        _move(jl, tl)
    jo, jg, jpg = _jax_layer(jl, arrays, labels)
    to, tg, tpg = _fwd_bwd(tl, tp, *arrays, labels=labels)
    _same_np(jo, list(to), TOL, name)
    _same_np(jg, tg, TOL, name + " input grads")
    assert sorted(jpg) == sorted(tpg)
    for k in jpg:
        _same_np([jpg[k]], [tpg[k]], TOL, f"{name} {k}")
    if name == "AdaptiveLogSoftmaxWithLoss":
        lp = [L.log_prob(Pk.to_tensor(x6)) for L, Pk in ((jl, jp), (tl, tp))]
        _same(lp[0], lp[1], TOL, "log_prob")
        pr = [L.predict(Pk.to_tensor(x6)) for L, Pk in ((jl, jp), (tl, tp))]
        assert np.array_equal(np.asarray(pr[0].numpy()), pr[1].numpy())


def test_common_layers():
    x5 = RNG.standard_normal((2, 3, 4, 5)).astype(np.float32)
    cases = [
        ("Identity", (7,), {}), ("Flatten", (), {}),
        ("Flatten", (2, 3), {}),
        ("Unflatten", (1, [3, 1]), {}),
        ("Upsample", (), {"scale_factor": 2}),
        ("Upsample", (), {"size": [6, 8], "mode": "bilinear"}),
        ("UpsamplingNearest2D", (), {"scale_factor": 3}),
        ("PixelShuffle", (1,), {}), ("PixelUnshuffle", (2,),
                                     {"data_format": "NCHW"}),
        ("Pad2D", ([1, 0, 2, 1],), {"mode": "reflect"}),
        ("Pad1D", ([1, 2],), {"mode": "replicate"}),
        ("Pad3D", ([1, 1, 0, 2, 1, 0],), {"mode": "circular"}),
        ("ZeroPad2D", ([1, 2, 3, 0],), {}),
        ("Dropout2D", (0.5,), {}), ("Dropout3D", (), {}),
        ("AlphaDropout", (0.3,), {}), ("FeatureAlphaDropout", (0.3,), {}),
        ("Unfold", ([2, 2],), {"strides": 2}),
    ]
    x6 = RNG.standard_normal((2, 4, 3, 3, 2)).astype(np.float32)
    cases += [("ChannelShuffle", (2,), {}), ("ZeroPad1D", ([2, 1],), {}),
              ("ZeroPad3D", ([1, 0, 0, 1, 2, 0],), {}),
              ("Fold", ([4, 5], 2), {}), ("CosineSimilarity", (),
                                          {"axis": 1}),
              ("PairwiseDistance", (), {"p": 3.0, "keepdim": True})]
    inputs = {"Pad3D": (x5[..., None],), "Dropout3D": (x5[..., None],),
              "Pad1D": (x5[:, :, 0],), "PixelUnshuffle": (x5[:, :, :4, :4],),
              "ChannelShuffle": (x6[..., 0],), "ZeroPad1D": (x6[:, :, 0, 0],),
              "ZeroPad3D": (x6,),
              "Fold": (RNG.standard_normal((2, 12, 12)).astype(np.float32),),
              "CosineSimilarity": (E[0], E[1]),
              "PairwiseDistance": (E[0], E[1])}
    jls, tls, ins = [], [], []
    for name, args, kw in cases:
        j, t = (getattr(Pk.nn, name)(*args, **kw) for Pk in PKGS)
        j.eval()
        t.eval()
        jls.append(j)
        tls.append(t)
        ins.append(tuple(np.ascontiguousarray(a) for a in
                         inputs.get(name, (x5,))))
    # the JAX layers traced together in one program
    jouts = jax.jit(lambda xs: [L(*[JTensor(a) for a in x])._data
                                for L, x in zip(jls, xs)])(
        [[jnp.asarray(a) for a in x] for x in ins])
    for (name, _, _), jo, t, x in zip(cases, jouts, tls, ins):
        _same_np([jo], [t(*[tp.to_tensor(a) for a in x])], TOL, name)


def test_containers():
    for Pk in PKGS:
        nn = Pk.nn
        pl = nn.ParameterList([nn.Linear(1, 2).weight for _ in range(2)])
        pl.append(nn.Linear(2, 3).bias)
        assert len(pl) == 3 and pl[-1].shape == [3]
        assert len(list(pl)) == 3 and len(list(nn.Layer.parameters(pl))) == 3
        d = nn.LayerDict({"a": nn.ReLU(), "b": nn.Linear(2, 2)})
        d["c"] = nn.Tanh()
        del d["a"]
        assert list(d.keys()) == ["b", "c"] and "c" in d and len(d) == 2
        assert [k for k, _ in d.items()] == ["b", "c"]
        assert len(d.parameters()) == 2
        sig = nn.Sigmoid()
        ll = nn.LayerList([nn.ReLU(), nn.Tanh()])
        ll.insert(1, sig)
        assert len(ll) == 3 and ll[1] is sig


def test_spectral_norm_layer_keeps_its_vector():
    """The power-iteration vector is the buffer `weight_u`: it advances
    at every forward and travels in state_dict."""
    w = RNG.standard_normal((5, 3, 2)).astype(np.float32)
    outs = []
    for Pk in PKGS:
        sn = Pk.nn.SpectralNorm([5, 3, 2], axis=1, power_iters=1)
        wt = Pk.to_tensor(w, stop_gradient=False)
        o1, o2 = sn(wt), sn(wt)
        (o2 * Pk.to_tensor(w)).sum().backward()
        outs.append((o1, o2, sn.weight_u, wt.grad,
                     sorted(sn.state_dict().keys())))
    for a, b in zip(outs[0][:4], outs[1][:4]):
        _same(a, b, TOL, "spectral")
    assert outs[0][4] == outs[1][4] == ["weight_u"]
    assert not np.allclose(outs[1][0].numpy(), outs[1][1].numpy())


def test_utils_clip_and_vectors():
    rng = np.random.default_rng(7)
    res = []
    for Pk in PKGS:
        lins = [Pk.nn.Linear(3, 4), Pk.nn.Linear(4, 2)]
        params = [p for L in lins for p in L.parameters()]
        for p in params:
            p.set_value(rng.standard_normal(p.shape).astype(np.float32))
        rng = np.random.default_rng(7)
        x = Pk.to_tensor(np.ones((2, 3), np.float32))
        (lins[1](lins[0](x)) ** 2).sum().backward()
        n2 = Pk.nn.utils.clip_grad_norm_(params, 1.0)
        g2 = [p.grad.numpy().copy() for p in params]
        n1 = Pk.nn.utils.clip_grad_norm_(params, 0.5, norm_type=1.0)
        Pk.nn.utils.clip_grad_value_(params, 0.01)
        gv = [p.grad.numpy().copy() for p in params]
        vec = Pk.nn.utils.parameters_to_vector(params)
        Pk.nn.utils.vector_to_parameters(vec * 2.0, params)
        res.append((float(n2), float(n1), g2, gv, vec.numpy(),
                    [p.numpy().copy() for p in params]))
    j, t = res
    assert abs(j[0] - t[0]) <= TOL * j[0] and abs(j[1] - t[1]) <= TOL * j[1]
    for a, b in zip(j[2] + j[3] + [j[4]] + j[5], t[2] + t[3] + [t[4]] + t[5]):
        _close(b, a, TOL)


def test_utils_weight_norm_and_spectral_norm():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((2, 4)).astype(np.float32)
    res = []
    for Pk in PKGS:
        lin = Pk.nn.Linear(4, 3)
        lin.weight.set_value(w)
        Pk.nn.utils.weight_norm(lin, dim=1)
        names = sorted(n for n, _ in lin.named_parameters())
        out = lin(Pk.to_tensor(x))
        (out * out).sum().backward()
        g = {n: p.grad.numpy().copy() for n, p in lin.named_parameters()}
        Pk.nn.utils.remove_weight_norm(lin)
        back = sorted(n for n, _ in lin.named_parameters())
        sn = Pk.nn.Linear(4, 3)
        sn.weight.set_value(w)
        Pk.nn.utils.spectral_norm(sn, n_power_iterations=2)
        o2 = sn(Pk.to_tensor(x))
        res.append((names, out.numpy(), g, back, lin.weight.numpy(),
                    o2.numpy(), sn.weight_u.numpy()))
    j, t = res
    assert j[0] == t[0] == ["bias", "weight_g", "weight_v"]
    assert j[3] == t[3] == ["bias", "weight"]
    _close(t[1], j[1], TOL)
    for k in j[2]:
        _close(t[2][k], j[2][k], TOL, k)
    for a, b in zip(j[4:], t[4:]):
        _close(b, a, TOL)


def test_feature_alpha_dropout_training():
    """Training mode draws from the port's generator (the random-draw
    family): whole channels take SELU's saturation value, the moments
    are kept, and the result is differentiable."""
    tp.seed(1)
    layer = tp.nn.FeatureAlphaDropout(0.2)
    x = tp.to_tensor(np.random.default_rng(2).standard_normal(
        (200, 100, 4)).astype(np.float32), stop_gradient=False)
    y = layer(x)
    d = y.numpy()
    assert abs(d.mean()) < 0.03 and abs(d.std() - 1.0) < 0.03
    dropped = np.ptp(d, axis=-1) == 0
    assert abs(dropped.mean() - 0.2) < 0.02
    y.sum().backward()
    assert x.grad is not None
