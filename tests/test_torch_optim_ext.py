"""The eager optimizers' regularizers, amsgrad, clips, `minimize` and
master weights against the JAX package, on the CPU.

The same parameters and the same gradients (numpy draws, set as each
parameter's `.grad`) go through `paddle_tpu.optimizer` (JAX: one jitted
update a parameter) and `paddle_tpu_torch.optimizer` (multi-tensor
updates a dtype group): L1Decay (c·sign(w) added to the gradient) and
L2Decay (the update's `wd`) in SGD, Momentum, Adam and AdamW, with
`apply_decay_param_fun`; amsgrad; ClipGradByNorm, ClipGradByValue and
ClipGradByGlobalNorm; `minimize`; Momentum and AdamW with
`multi_precision` over bf16 parameters, their masters in `state_dict`.

Tolerances: f32 updates are the same f32 expressions in another order
of operations inside a fused update: 1e-6 relative of each tensor's
largest value after a few steps. bf16 parameters are the f32 masters
rounded once: within one bf16 ulp of JAX's, masters within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402

TOL = 1e-6
PKGS = (jp, tp)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _params(P, dtype="float32", seed=0):
    """A weight [4, 3] named "w" and a bias [3] named "b"."""
    rng = np.random.default_rng(seed)
    w = P.Parameter(rng.standard_normal((4, 3)).astype(np.float32),
                    name="w")
    b = P.Parameter(rng.standard_normal(3).astype(np.float32), name="b")
    if dtype != "float32":
        for p in (w, b):
            if P is tp:
                p._data = p._data.detach().to(getattr(torch, dtype)) \
                    .requires_grad_(True)
            else:
                p._data = p._data.astype(getattr(jnp, dtype))
    return [w, b]


def _set_grads(P, params, step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    for p in params:
        g = (scale * rng.standard_normal(p.shape)).astype(np.float32)
        p.grad = P.to_tensor(g).astype(p.dtype) if P is tp else \
            P.to_tensor(g).astype(str(p.dtype))


def _run(P, make_opt, steps=3, dtype="float32", scale=1.0):
    params = _params(P, dtype)
    opt = make_opt(P, params)
    for s in range(steps):
        _set_grads(P, params, s, scale)
        opt.step()
        opt.clear_grad()
    return params, opt


def _np(t):
    return np.asarray(t.astype("float32").numpy(), np.float64)


def _close(a, b, tol, what):
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


OPTS = {
    "SGD": lambda P, ps, wd: P.optimizer.SGD(0.1, parameters=ps,
                                             weight_decay=wd),
    "Momentum": lambda P, ps, wd: P.optimizer.Momentum(
        0.1, 0.9, parameters=ps, weight_decay=wd, use_nesterov=True),
    "Adam": lambda P, ps, wd: P.optimizer.Adam(0.05, parameters=ps,
                                               weight_decay=wd),
    "AdamW": lambda P, ps, wd: P.optimizer.AdamW(
        0.05, parameters=ps, weight_decay=wd,
        apply_decay_param_fun=lambda n: n == "w"),
}


@pytest.mark.parametrize("decay", ["L1Decay", "L2Decay", "float"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_regularizers_match_jax(opt, decay):
    out = {}
    for P in PKGS:
        wd = 0.3 if decay == "float" else getattr(P.regularizer, decay)(0.3)
        params, _ = _run(P, lambda P_, ps: OPTS[opt](P_, ps, wd))
        out[P] = [_np(p) for p in params]
    for a, b in zip(out[tp], out[jp]):
        _close(a, b, TOL, f"{opt} {decay}")


@pytest.mark.parametrize("opt", ["Adam", "AdamW"])
def test_amsgrad_matches_jax(opt):
    """Gradients that shrink after the first step, so the running max of
    the second moment, not the moment, divides the later steps. AdamW
    takes `amsgrad` in **kw and drops it in both packages (its keyword
    never reaches Adam: `paddle_tpu/optimizer/optimizers.py:349-359`), so
    there the state has no moment2_max and the steps are Adam's without
    it."""
    out = {}
    for P in PKGS:
        params = _params(P)
        o = getattr(P.optimizer, opt)(0.05, parameters=params, amsgrad=True)
        if opt == "AdamW":
            assert not o._amsgrad
        for s, scale in enumerate((4.0, 0.5, 0.25, 1.0)):
            _set_grads(P, params, s, scale)
            o.step()
            o.clear_grad()
        sd = o.state_dict()
        out[P] = ([_np(p) for p in params],
                  _np(sd["w.moment2_max"] if opt == "Adam"
                      else sd["w.moment2"]))
    for a, b in zip(out[tp][0] + [out[tp][1]], out[jp][0] + [out[jp][1]]):
        _close(a, b, TOL, opt)


CLIPS = {
    "ByNorm": lambda P: P.nn.ClipGradByNorm(1.0),
    "ByValue": lambda P: P.nn.ClipGradByValue(0.5, min=-0.25),
    "ByGlobalNorm": lambda P: P.nn.ClipGradByGlobalNorm(1.0),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_clips_match_jax(clip):
    """The clip on gradients that it changes (norms above 1, values past
    the bounds), then an SGD step with it."""
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) * 2,
             rng.standard_normal(3).astype(np.float32)]
    j = CLIPS[clip](jp)([(None, jnp.asarray(g)) for g in grads])
    t = CLIPS[clip](tp)([(None, torch.from_numpy(g)) for g in grads])
    for (_, a), (_, b) in zip(t, j):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close(a.numpy(), np.asarray(b), TOL, clip)
    assert not np.allclose(t[0][1].numpy(), grads[0])
    out = {}
    for P in PKGS:
        params, _ = _run(P, lambda P_, ps: P_.optimizer.SGD(
            0.1, parameters=ps, grad_clip=CLIPS[clip](P_)), scale=3.0)
        out[P] = [_np(p) for p in params]
    for a, b in zip(out[tp], out[jp]):
        _close(a, b, TOL, clip)


def test_minimize_matches_jax():
    out = {}
    for P in PKGS:
        params = _params(P)
        x = P.to_tensor(np.random.default_rng(4).standard_normal(
            (5, 4)).astype(np.float32))
        opt = P.optimizer.Adam(0.05, parameters=params)
        for _ in range(2):
            loss = ((x @ params[0] + params[1]) ** 2).mean()
            assert opt.minimize(loss) == (None, None)
            opt.clear_grad()
        out[P] = [_np(p) for p in params]
    for a, b in zip(out[tp], out[jp]):
        _close(a, b, TOL, "minimize")


@pytest.mark.parametrize("opt", ["Momentum", "AdamW"])
def test_master_weights_match_jax(opt):
    """bf16 parameters with multi_precision: f32 masters made at the
    first step from the bf16 values, updated in f32 and rounded into the
    parameters; the state_dict carries `<name>.master`."""
    make = {"Momentum": lambda P, ps: P.optimizer.Momentum(
                0.1, 0.9, parameters=ps, weight_decay=0.01,
                multi_precision=True),
            "AdamW": lambda P, ps: P.optimizer.AdamW(
                0.05, parameters=ps, multi_precision=True,
                weight_decay=P.regularizer.L2Decay(0.02))}[opt]
    out = {}
    for P in PKGS:
        params, o = _run(P, make, steps=4, dtype="bfloat16")
        sd = o.state_dict()
        out[P] = ([_np(p) for p in params],
                  [_np(sd[f"{n}.master"]) for n in ("w", "b")],
                  [str(p.dtype).replace("torch.", "") for p in params],
                  sorted(sd))
    assert out[tp][2] == out[jp][2] == ["bfloat16", "bfloat16"]
    assert out[tp][3] == out[jp][3]
    for a, b in zip(out[tp][1], out[jp][1]):
        _close(a, b, TOL, f"{opt} masters")
    for a, b, m in zip(out[tp][0], out[jp][0], out[tp][1]):
        # one bf16 ulp of each value
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        assert (np.abs(a - b) <= ulp).all(), opt
        np.testing.assert_array_equal(
            a, torch.from_numpy(m).bfloat16().double().numpy())


def test_master_state_dict_round_trip_and_snapshot():
    """A state_dict taken before a step keeps its master; loading it into
    a fresh optimizer continues as the original does."""
    params, opt = _run(tp, lambda P, ps: P.optimizer.AdamW(
        0.05, parameters=ps, multi_precision=True), steps=2,
        dtype="bfloat16")
    sd = opt.state_dict()
    before = sd["w.master"].numpy().copy()
    twin = [tp.Parameter(p.numpy(), name=p.name) for p in params]
    for t, p in zip(twin, params):
        t._data = p._data.detach().clone().requires_grad_(True)
    opt2 = tp.optimizer.AdamW(0.05, parameters=twin, multi_precision=True)
    opt2.set_state_dict(sd)
    for ps, o in ((params, opt), (twin, opt2)):
        _set_grads(tp, ps, 7)
        o.step()
    np.testing.assert_array_equal(sd["w.master"].numpy(), before)
    for a, b in zip(params, twin):
        assert torch.equal(a._data, b._data)


def test_no_refusal_remains():
    ps = _params(tp)
    tp.optimizer.AdamW(parameters=ps, weight_decay=tp.regularizer.L1Decay(
        0.1), multi_precision=True, amsgrad=True)
    tp.optimizer.SGD(parameters=ps, weight_decay=tp.regularizer.L2Decay(.1),
                     multi_precision=True)
