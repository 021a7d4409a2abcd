"""The ten optimizers of the eager API's second half against the JAX
package, on the CPU: Adagrad, RMSProp, Adamax, Lamb, Adadelta, Rprop,
ASGD, NAdam, RAdam and LBFGS.

The same Linear(4, 3) (weights from numpy, parameters named "w" and
"b") and the same gradients (numpy draws, set as each parameter's
`.grad`) go through `paddle_tpu.optimizer` (one jitted update a
parameter) and `paddle_tpu_torch.optimizer` (multi-tensor updates a
dtype group). After every step the parameters and the whole
`state_dict` are compared: its keys, each entry's dtype and its values.
Covered: the decays each optimizer takes (L1Decay, L2Decay, a float),
Lamb's `exclude_from_weight_decay_fn`, `amp.decorate` O2 bf16 with f32
masters, which constructors take `multi_precision`, a `set_state_dict`
round trip, no host read in `step()` (every tensor-to-Python conversion
raises while it runs) and LBFGS on a small least-squares problem with
the host reads the JAX step makes.

Tolerances: f32 updates are the same f32 expressions in another order
of operations inside a fused update: 1e-6 relative of each tensor's
largest value. Under O2 the masters are f32 (1e-6) and the bf16
parameters are the masters rounded once: within one bf16 ulp of JAX's.
A state that stays bf16 (Rprop's step size) is within one bf16 ulp
(8e-3 relative). LBFGS: 1e-5 relative after 3 iterations (its dot
products are summed in another order and the recursion divides by
them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402

TOL = 1e-6
BF16_TOL = 8e-3
PKGS = (jp, tp)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _model(P, seed=0):
    """Linear(4, 3) with numpy weights; its parameters named w and b."""
    rng = np.random.default_rng(seed)
    lin = P.nn.Linear(4, 3)
    lin.set_state_dict({
        "weight": rng.standard_normal((4, 3)).astype(np.float32),
        "bias": rng.standard_normal(3).astype(np.float32)})
    lin.weight.name, lin.bias.name = "w", "b"
    return lin


def _set_grads(P, params, step):
    rng = np.random.default_rng(100 + step)
    for p in params:
        g = P.to_tensor(rng.standard_normal(p.shape).astype(np.float32))
        p.grad = g.astype(p.dtype) if P is tp else g.astype(str(p.dtype))


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def _np(t):
    return np.asarray(t.astype("float32").numpy(), np.float64)


def _snapshot(params, opt):
    """(parameter dtypes and values, {state key: (dtype, values)})."""
    sd = opt.state_dict()
    return ([(_dt(p), _np(p)) for p in params],
            {k: (_dt(v), _np(v)) for k, v in sd.items()
             if k not in ("_step_count", "LR_Scheduler")})


def _run(P, make, steps, o2=False):
    lin = _model(P)
    opt = make(P, lin.parameters())
    if o2:
        lin, opt = P.amp.decorate(lin, opt, level="O2", dtype="bfloat16")
    params = lin.parameters()
    out = []
    for s in range(steps):
        _set_grads(P, params, s)
        opt.step()
        opt.clear_grad()
        out.append(_snapshot(params, opt))
    return out


def _close(a, b, tol, what):
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


def _bf16_ulp_close(a, b, what):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert (np.abs(a - b) <= ulp).all(), what


def _same_run(t_run, j_run, what, tol=TOL):
    for step, ((tparams, tstate), (jparams, jstate)) in enumerate(
            zip(t_run, j_run)):
        at = f"{what}, step {step + 1}"
        assert sorted(tstate) == sorted(jstate), at
        for k in jstate:
            assert tstate[k][0] == jstate[k][0], (at, k, tstate[k][0],
                                                  jstate[k][0])
            if jstate[k][0] == "bfloat16":
                _close(tstate[k][1], jstate[k][1], BF16_TOL, f"{at} {k}")
            else:
                _close(tstate[k][1], jstate[k][1], tol, f"{at} {k}")
        for (tdt, a), (jdt, b) in zip(tparams, jparams):
            assert tdt == jdt, at
            if jdt == "bfloat16":
                _bf16_ulp_close(a, b, at)
            else:
                _close(a, b, tol, at)


# (factory, steps): RAdam's beta2 0.9 and 7 steps reach rho_t > 5 at t 6,
# so both of its branches run; ASGD's ring of 2 wraps in 3 steps
OPTS = {
    "Adagrad": (lambda P, ps, wd: P.optimizer.Adagrad(
        0.1, parameters=ps, weight_decay=wd,
        initial_accumulator_value=0.1), 3),
    "RMSProp": (lambda P, ps, wd: P.optimizer.RMSProp(
        0.01, rho=0.9, parameters=ps, weight_decay=wd), 3),
    "RMSProp_centered": (lambda P, ps, wd: P.optimizer.RMSProp(
        0.01, rho=0.9, momentum=0.5, centered=True, parameters=ps,
        weight_decay=wd), 3),
    "Adamax": (lambda P, ps, wd: P.optimizer.Adamax(
        0.05, parameters=ps, weight_decay=wd), 3),
    "Lamb": (lambda P, ps, wd: P.optimizer.Lamb(
        0.05, lamb_weight_decay=0.0 if wd is None else wd, parameters=ps),
        3),
    "Adadelta": (lambda P, ps, wd: P.optimizer.Adadelta(
        1.0, parameters=ps, weight_decay=wd), 3),
    "ASGD": (lambda P, ps, wd: P.optimizer.ASGD(
        0.1, batch_num=2, parameters=ps, weight_decay=wd), 3),
    "NAdam": (lambda P, ps, wd: P.optimizer.NAdam(
        0.02, parameters=ps, weight_decay=wd), 3),
    "RAdam": (lambda P, ps, wd: P.optimizer.RAdam(
        0.05, beta2=0.9, parameters=ps, weight_decay=wd), 7),
    "Rprop": (lambda P, ps, wd: P.optimizer.Rprop(
        0.01, learning_rate_range=(1e-3, 0.05), parameters=ps), 3),
}
DECAYED = sorted(n for n in OPTS if n != "Rprop")


def _decay(P, decay):
    if decay == "none":
        return None
    return 0.3 if decay == "float" else getattr(P.regularizer, decay)(0.3)


@pytest.mark.parametrize("decay", ["L1Decay", "L2Decay", "float"])
@pytest.mark.parametrize("name", DECAYED)
def test_optimizer_matches_jax(name, decay):
    """f32, with each decay the optimizer takes: the parameters and the
    state_dict's keys, dtypes and values after every step."""
    make, steps = OPTS[name]
    runs = {P: _run(P, lambda P_, ps: make(P_, ps, _decay(P_, decay)),
                    steps) for P in PKGS}
    _same_run(runs[tp], runs[jp], f"{name} {decay}")


def test_rprop_matches_jax():
    """Rprop takes no decay and ignores lr in its update: the step sizes
    start at lr, grow and shrink with the gradients' signs and are held
    to learning_rate_range."""
    make, steps = OPTS["Rprop"]
    runs = {P: _run(P, lambda P_, ps: make(P_, ps, None), steps)
            for P in PKGS}
    _same_run(runs[tp], runs[jp], "Rprop")
    sizes = runs[tp][-1][1]["w.step_size"][1]
    assert len(np.unique(sizes)) > 1 and sizes.min() >= 1e-3 - 1e-9 \
        and sizes.max() <= 0.05 + 1e-9


@pytest.mark.parametrize("name", sorted(OPTS))
def test_o2_bf16_masters_match_jax(name):
    """amp.decorate(level="O2", dtype="bfloat16") gives every optimizer
    f32 masters, whatever its constructor takes: the masters within
    1e-6, the bf16 parameters within one bf16 ulp, the states promoted
    to f32 by the first step (Rprop's step size stays bf16) with JAX's
    keys and dtypes after every step."""
    make, steps = OPTS[name]
    wd = None if name == "Rprop" else 0.01
    runs = {P: _run(P, lambda P_, ps: make(P_, ps, wd), steps, o2=True)
            for P in PKGS}
    _same_run(runs[tp], runs[jp], f"{name} O2")
    params, state = runs[tp][-1]
    assert [dt for dt, _ in params] == ["bfloat16", "bfloat16"]
    assert state["w.master"][0] == "float32"


def _run_bf16(P, make, steps):
    """As _run over bf16 parameters with no master weights."""
    lin = _model(P)
    for p in lin.parameters():
        if P is tp:
            p._data = p._data.detach().bfloat16().requires_grad_(True)
        else:
            p._data = p._data.astype("bfloat16")
    opt = make(P, lin.parameters())
    out = []
    for s in range(steps):
        _set_grads(P, lin.parameters(), s)
        opt.step()
        opt.clear_grad()
        out.append(_snapshot(lin.parameters(), opt))
    return out


@pytest.mark.parametrize("name", sorted(OPTS))
def test_bf16_parameters_without_masters(name):
    """bf16 parameters, no master weights: the states and parameters
    take JAX's dtypes after every step (an f32 term of the update, such
    as the decay's f32 coefficient, promotes them, as JAX's
    `value - step` does; Rprop stays bf16) and JAX's values. Lamb, which
    has no f32 term before its moments, is within 2e-4 of the JAX
    package's parameters, a recorded divergence: XLA rounds the update's
    Python constants ((1 - β1) and the rest) to bf16 against bf16
    moments and keeps their products in f32, where torch multiplies in
    f32 and rounds each result to bf16."""
    make, steps = OPTS[name]
    wd = None if name == "Rprop" else 0.01
    runs = {P: _run_bf16(P, lambda P_, ps: make(P_, ps, wd), steps)
            for P in PKGS}
    if name != "Lamb":
        _same_run(runs[tp], runs[jp], f"{name} bf16")
        return
    for (tparams, tstate), (jparams, jstate) in zip(runs[tp], runs[jp]):
        assert sorted(tstate) == sorted(jstate)
        assert {k: v[0] for k, v in tstate.items()} == \
            {k: v[0] for k, v in jstate.items()}
        for (tdt, a), (jdt, b) in zip(tparams, jparams):
            assert tdt == jdt == "float32"
            _close(a, b, 2e-4, "Lamb bf16")


# constructors that pass multi_precision to the base, and the ones whose
# **kw swallows it (paddle_tpu/optimizer/optimizers.py:246-583)
TEN = ["Adagrad", "RMSProp", "Adamax", "Lamb", "Adadelta", "Rprop", "ASGD",
       "NAdam", "RAdam", "LBFGS"]
TAKES_MP = {"Adagrad", "RMSProp", "Lamb", "ASGD"}


@pytest.mark.parametrize("name", TEN)
def test_multi_precision_argument(name):
    """multi_precision=True over bf16 parameters: Adagrad, RMSProp, Lamb
    and ASGD keep f32 masters; Adamax, Adadelta, Rprop, NAdam, RAdam and
    LBFGS swallow the keyword and keep none, in both packages."""
    out = {}
    for P in PKGS:
        lin = _model(P)
        for p in lin.parameters():
            if P is tp:
                p._data = p._data.detach().bfloat16().requires_grad_(True)
            else:
                p._data = p._data.astype("bfloat16")
        ps = lin.parameters()
        opt = getattr(P.optimizer, name)(learning_rate=0.05, parameters=ps,
                                         multi_precision=True)
        keys = []
        if name != "LBFGS":
            _set_grads(P, ps, 0)
            opt.step()
            keys = sorted(opt.state_dict())
        out[P] = (opt._multi_precision, keys)
    assert out[tp] == out[jp]
    assert out[tp][0] == (name in TAKES_MP)
    assert any(k.endswith(".master") for k in out[tp][1]) == \
        (name in TAKES_MP)


def test_lamb_exclude_fn_takes_the_parameter():
    """exclude_from_weight_decay_fn is called with each Parameter (not
    its name); the excluded bias moves without decay."""
    seen = {}

    def make(P, ps, wd):
        def exclude(p):
            seen.setdefault(P, set()).add(type(p).__name__)
            return p.name == "b"
        return P.optimizer.Lamb(0.05, lamb_weight_decay=0.5,
                                exclude_from_weight_decay_fn=exclude,
                                parameters=ps)

    runs = {P: _run(P, lambda P_, ps: make(P_, ps, None), 3) for P in PKGS}
    _same_run(runs[tp], runs[jp], "Lamb exclude")
    assert seen[tp] == {"Parameter"} and seen[jp] == {"Parameter"}
    plain = _run(tp, lambda P_, ps: P_.optimizer.Lamb(
        0.05, lamb_weight_decay=0.5, parameters=ps), 3)
    b_ex, b_dec = runs[tp][-1][0][1][1], plain[-1][0][1][1]
    assert not np.allclose(b_ex, b_dec)


PER_STEP = sorted(n for n in OPTS if n != "RMSProp_centered")


@pytest.mark.parametrize("name", PER_STEP)
def test_set_state_dict_round_trip(name):
    """A state_dict taken after 2 steps and loaded into a fresh
    optimizer over copies of the parameters: the next step gives the
    same parameters and states bit for bit, and the snapshot keeps its
    values across that step (the new states are new tensors)."""
    make = OPTS[name][0]
    wd = None if name == "Rprop" else 0.01
    lin = _model(tp)
    opt = make(tp, lin.parameters(), wd)
    for s in range(2):
        _set_grads(tp, lin.parameters(), s)
        opt.step()
        opt.clear_grad()
    sd = opt.state_dict()
    frozen = {k: v.numpy().copy() for k, v in sd.items()
              if isinstance(v, tp.Tensor)}
    twin = _model(tp)
    for a, b in zip(twin.parameters(), lin.parameters()):
        a.set_value(b)
    opt2 = make(tp, twin.parameters(), wd)
    opt2.set_state_dict(sd)
    for m, o in ((lin, opt), (twin, opt2)):
        _set_grads(tp, m.parameters(), 2)
        o.step()
    for k, v in frozen.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    for a, b in zip(lin.parameters(), twin.parameters()):
        assert torch.equal(a._data, b._data)
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert sorted(s1) == sorted(s2)
    for k in s1:
        if isinstance(s1[k], tp.Tensor):
            assert torch.equal(s1[k]._data, s2[k]._data), k


@pytest.fixture
def _no_host_reads(monkeypatch):
    """Every conversion of a tensor to a Python or numpy value raises."""
    def refuse(self, *a, **k):
        raise AssertionError("a host read of a tensor inside step()")

    for meth in ("item", "tolist", "numpy", "__bool__", "__float__",
                 "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, meth, refuse)
    yield
    monkeypatch.undo()


@pytest.mark.parametrize("name", PER_STEP)
def test_step_reads_nothing_on_the_host(name, request):
    """The nine per-step updates (RAdam's rectification, NAdam's
    momentum schedule, ASGD's ring position and Lamb's trust ratio
    included) never bring a tensor's value to the host: 3 steps under
    O2 run with every tensor-to-Python conversion refused."""
    make = OPTS[name][0]
    lin = _model(tp)
    opt = make(tp, lin.parameters(), None if name == "Rprop" else 0.01)
    lin, opt = tp.amp.decorate(lin, opt, level="O2", dtype="bfloat16")
    grads = []
    for s in range(3):
        _set_grads(tp, lin.parameters(), s)
        grads.append([p._data.grad for p in lin.parameters()])
    request.getfixturevalue("_no_host_reads")
    for g in grads:
        for p, gi in zip(lin.parameters(), g):
            p._data.grad = gi
        opt.step()


def _lstsq(P, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((16, 4)).astype(np.float32)
    x_true = rng.standard_normal((4, 1)).astype(np.float32)
    b = a @ x_true + 0.01 * rng.standard_normal((16, 1)).astype(np.float32)
    x = P.Parameter(np.zeros((4, 1), np.float32), name="x")
    return P.to_tensor(a), P.to_tensor(b), x, a, b


@pytest.mark.parametrize("max_iter", [1, 3])
def test_lbfgs_least_squares(max_iter):
    """LBFGS with a closure over ‖Ax - b‖² / n from x = 0: the iterates
    and the losses are JAX's within 1e-5, and the loss falls."""
    out, losses = {}, {}
    for P in PKGS:
        A, B, x, _, _ = _lstsq(P)
        opt = P.optimizer.LBFGS(learning_rate=1.0, max_iter=max_iter,
                                parameters=[x])
        trace = []

        def closure():
            opt.clear_grad()
            d = A @ x - B
            loss = (d * d).mean()
            loss.backward()
            trace.append(float(loss))
            return loss

        opt.step(closure)
        out[P], losses[P] = _np(x), trace
    _close(out[tp], out[jp], 1e-5, "LBFGS")
    np.testing.assert_allclose(losses[tp], losses[jp], rtol=1e-5)
    assert len(losses[tp]) == max_iter
    if max_iter > 1:
        assert losses[tp][-1] < losses[tp][0]


def test_lbfgs_reads_the_host_where_jax_does(monkeypatch):
    """An iteration reads three device values, as the JAX step does
    (the largest gradient, y·s once there is history, the largest
    move); the two-loop recursion reads none. 3 iterations: 3 + 2 + 3
    reads."""
    A, B, x, _, _ = _lstsq(tp)
    opt = tp.optimizer.LBFGS(learning_rate=1.0, max_iter=3, parameters=[x])
    reads = []
    real = torch.Tensor.__float__

    def counted(self):
        reads.append(tuple(self.shape))
        return real(self)

    def closure():
        opt.clear_grad()
        d = A @ x - B
        loss = (d * d).mean()
        loss.backward()
        return loss

    monkeypatch.setattr(torch.Tensor, "__float__", counted)
    monkeypatch.setattr(torch.Tensor, "item", lambda s: pytest.fail(
        "item() inside LBFGS.step"))
    opt.step(closure)
    monkeypatch.undo()
    assert len(reads) == 8 and len(opt._s) == 2


def test_lbfgs_refuses_decay_and_clip():
    for P in PKGS:
        x = P.Parameter(np.zeros(2, np.float32))
        for kw in ({"weight_decay": 0.1},
                   {"grad_clip": P.nn.ClipGradByNorm(1.0)}):
            with pytest.raises(NotImplementedError):
                P.optimizer.LBFGS(parameters=[x], **kw)
        with pytest.raises(ValueError):
            P.optimizer.LBFGS(parameters=[x]).step()


def test_exports_every_jax_optimizer():
    names = {n for n in dir(jp.optimizer) if n[0].isupper()}
    assert names <= set(dir(tp.optimizer))
    for n in ("Adagrad", "RMSProp", "Adamax", "Lamb", "Adadelta", "Rprop",
              "ASGD", "NAdam", "RAdam", "LBFGS"):
        assert n in tp.optimizer.__doc__
