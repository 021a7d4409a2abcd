"""The port's Paddle-shaped eager API against the JAX package, on the CPU.

Each check runs the same code through `paddle_tpu` (JAX) and
`paddle_tpu_torch` with the same numpy inputs: Tensor and autograd
semantics, the AMP O1 output dtype of every op of the eager ERNIE path,
parameter names and order, AdamW with the global-norm clip, and a tiny
ERNIE encoder composed from layers (`tools/eager_ernie.py`, written once
over the package module) whose weights move across by `set_state_dict`.

Tolerances: in f32 the two sides run the same expressions and differ in
summation order only: 1e-5 relative for logits and the loss, 1e-4 for
every gradient (relative to the largest element of each; a gradient that
cancels to ~0, such as the key bias's under the shift-invariant softmax,
relative to a thousandth of the model's largest gradient): the
embeddings' gradients pass the embedding LayerNorm's backward, whose
r = 1/std is ~30 at N(0, 0.02) embeddings and multiplies the f32 rounding
of dyw − mean(dyw) − x̂·mean(dyw·x̂), a difference of nearly equal terms,
so their relative error is ~10x that of the logits. Parameters:
1e-6 relative after 5 AdamW steps on a Linear whose gradients are all
large; after the tiny ERNIE's 3 steps of lr 1e-3, within 1 % of the
distance those steps can move a parameter (3 lr): Adam divides each
gradient by its own running magnitude, so where a gradient is ~0 (rows of
the embeddings, the key bias) the f32 summation noise in it becomes a
visible part of a step. Under O1 both round
the GEMM and attention inputs and outputs to bf16 at the same places, but
XLA's and torch's CPU bf16 products round their results at other points:
logits and loss within 2e-2, gradients within 6e-2 of each tensor's
largest element.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import paddle_tpu as jp  # noqa: E402
from paddle_tpu.nlp import ernie as jernie  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nlp import ernie as ternie  # noqa: E402
from paddle_tpu_torch.tools.eager_ernie import build_model, train_step  # noqa: E402,E501

F32_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
STEP_TOL = 1e-2         # of the distance `steps` AdamW steps can move
O1_TOL = 2e-2
O1_RATIO = 1.5
PKGS = {"jax": jp, "torch": tp}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _close(a, b, tol, what="", floor=0.0):
    """max |a - b| within tol of max |b|, or of `floor` where that is
    larger."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(b).max(initial=0.0), floor)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= tol * scale + 1e-30, f"{what}: {err} > {tol} x {scale}"


def _both(fn):
    """fn(pkg) for both packages → (jax result, torch result)."""
    return fn(jp), fn(tp)


# ------------------------------------------------ places
def test_default_place_is_the_card():
    """Without set_device the place is gpu:0: on a machine without a card
    the first tensor creation raises, naming set_device("cpu")."""
    tdevice._current_place = None
    assert tp.get_device() == "gpu:0"
    if torch.cuda.is_available():
        assert tp.to_tensor([1.0])._data.is_cuda
    else:
        with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
            tp.to_tensor([1.0])
        with pytest.raises(RuntimeError):
            tp.set_device("gpu")
    tp.set_device("cpu")
    assert tp.get_device() == "cpu"
    assert tp.to_tensor([1.0]).place.is_cpu_place()


# ------------------------------------------------ Tensor and autograd
def test_stop_gradient_defaults_and_leaves():
    def run(p):
        x = p.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        w = p.to_tensor(np.ones((3, 2), np.float32), stop_gradient=False)
        par = p.nn.Linear(3, 2).weight
        y = p.matmul(x, w)
        i = p.arange(4) + 1
        with p.no_grad():
            z = p.matmul(x, w)
        return [x.stop_gradient, w.stop_gradient, par.stop_gradient,
                y.stop_gradient, i.stop_gradient, z.stop_gradient,
                x.is_leaf, w.is_leaf, y.is_leaf, list(y.shape),
                _dtype_name(i)]

    j, t = _both(run)
    assert j == t == [True, False, False, False, True, True, True, True,
                      False, [2, 2], "int64"]


def test_grad_accumulates_until_clear_grad():
    x0 = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)

    def run(p):
        x = p.to_tensor(x0, stop_gradient=False)
        (x * x).sum().backward()
        g1 = x.grad.numpy().copy()
        p.tanh(x).mean().backward()
        g2 = x.grad.numpy().copy()
        x.clear_grad()
        none = x.grad is None
        p.exp(x).sum().backward()
        return g1, g2, none, x.grad.numpy()

    j, t = _both(run)
    assert j[2] and t[2]
    for a, b in zip(t[:2] + t[3:], j[:2] + j[3:]):
        _close(a, b, F32_TOL)


def test_backward_with_grad_tensor_and_no_grad():
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((2, 3)).astype(np.float32)
    g0 = rng.standard_normal((2, 6)).astype(np.float32)

    def run(p):
        x = p.to_tensor(x0, stop_gradient=False)
        y = p.concat([x * 3.0, p.divide(x, 2.0) - 1.0], axis=1)
        y.backward(p.to_tensor(g0))
        with p.no_grad():
            z = x * 2.0
        a, b = p.split(y, 2, axis=1)
        return x.grad.numpy(), z.stop_gradient, a.stop_gradient, b.shape

    j, t = _both(run)
    _close(t[0], j[0], F32_TOL)
    assert t[1:] == j[1:] == (True, False, [2, 3])


# ------------------------------------------------------ AMP O1 dtypes
def _amp_case(name, p):
    """One op of the eager ERNIE path under O1 bf16 from f32 inputs;
    returns the output Tensor."""
    rng = np.random.default_rng(2)
    F = p.nn.functional
    inc = p.incubate.nn.functional
    x = p.to_tensor(rng.standard_normal((2, 8, 64)).astype(np.float32))
    w = p.to_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    v = p.to_tensor(rng.standard_normal(64).astype(np.float32))
    ids = p.to_tensor(rng.integers(0, 10, (2, 8)))
    table = p.to_tensor(rng.standard_normal((10, 64)).astype(np.float32))
    q = p.to_tensor(rng.standard_normal((2, 8, 1, 64)).astype(np.float32))
    with p.amp.auto_cast(dtype="bfloat16"):
        xb = F.linear(x, w)                      # a bf16 activation
        ops = {
            "linear": lambda: F.linear(x, w, v),
            "matmul": lambda: p.matmul(x, w),
            "sdpa": lambda: F.scaled_dot_product_attention(q, q, q),
            "cross_entropy": lambda: F.cross_entropy(
                xb[:, 0], p.to_tensor(np.array([1, 2]))),
            "add_bf16_f32": lambda: xb + v,
            "fused_dropout_add": lambda: inc.fused_dropout_add(
                xb, x, p=0.0),
            "fused_layer_norm": lambda: inc.fused_layer_norm(x, v, v),
            "embedding": lambda: F.embedding(ids, table),
            "gelu": lambda: F.gelu(xb, approximate=True),
            "tanh": lambda: F.tanh(xb),
            "reshape": lambda: xb.reshape([2, 8, 2, 32]),
            "getitem": lambda: xb[:, 0],
            "mean": lambda: xb.mean(),
            "sum": lambda: p.sum(xb),
            "exp": lambda: p.exp(xb),
            "layer_norm": lambda: F.layer_norm(xb, 64, v, v),
            "fused_linear": lambda: inc.fused_linear(x, w, v),
            "dropout_eval": lambda: F.dropout(xb, 0.1, training=False),
        }
        return ops[name]()


@pytest.mark.parametrize("name", [
    "linear", "matmul", "sdpa", "cross_entropy", "add_bf16_f32",
    "fused_dropout_add", "fused_layer_norm", "embedding", "gelu", "tanh",
    "reshape", "getitem", "mean", "sum", "exp", "layer_norm",
    "fused_linear", "dropout_eval"])
def test_amp_o1_output_dtype(name):
    j, t = _both(lambda p: _amp_case(name, p))
    assert _dtype_name(t) == np.dtype(j.dtype).name, name
    assert t.shape == j.shape


# --------------------------------------------------------- optimizer
# ------------------------------------------------ F4-F7
# F4: 0-d data keeps its shape through every path into a Tensor
_ZERO_D = {
    "int": lambda p: p.to_tensor(3),
    "float": lambda p: p.to_tensor(2.5),
    "bool": lambda p: p.to_tensor(True),
    "np_float32": lambda p: p.to_tensor(np.float32(2)),
    "array_0d": lambda p: p.to_tensor(np.array(1.5, np.float32)),
    "tensor_ctor": lambda p: p.Tensor(np.array(4, np.int32)),
    "set_value": lambda p: p.to_tensor(np.float32(1)).set_value(
        np.array(3, np.float32)),
    "rsub": lambda p: 1 - p.to_tensor(np.ones((2, 3), np.float32)).mean(),
    "rtruediv": lambda p: 2 / p.to_tensor(np.full((4,), 2, np.float32)).sum(),
    "rsub_float": lambda p: 1.5 - p.to_tensor(2.5),
}


@pytest.mark.parametrize("name", sorted(_ZERO_D))
def test_zero_d_keeps_its_shape(name):
    j, t = _both(_ZERO_D[name])
    assert t.shape == j.shape == [], (t.shape, j.shape)
    assert _dtype_name(t) == _dtype_name(j)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


# F5: == and != are the elementwise equal / not_equal, bool Tensors
_EQ = {
    "eq": lambda p: p.to_tensor([1., 2.]) == p.to_tensor([1., 3.]),
    "ne": lambda p: p.to_tensor([1., 2.]) != p.to_tensor([1., 3.]),
    "broadcast": lambda p: p.to_tensor([[1.], [2.]]) == p.to_tensor(
        [1., 2., 3.]),
    "scalar": lambda p: p.to_tensor([1, 2, 3]) != 2,
    "int_float": lambda p: p.to_tensor([1, 2]) == p.to_tensor([1., 2.5]),
    "method": lambda p: p.to_tensor([0., 5.]).equal(p.to_tensor([0., 4.])),
    "op": lambda p: p.not_equal(p.to_tensor([True, False]),
                                p.to_tensor([True, True])),
    "zero_d": lambda p: p.to_tensor(2.0) == 2.0,
}


@pytest.mark.parametrize("name", sorted(_EQ))
def test_eq_ne_are_elementwise(name):
    j, t = _both(_EQ[name])
    assert t.shape == j.shape
    assert _dtype_name(t) == _dtype_name(j) == "bool"
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    assert t.stop_gradient and j.stop_gradient


def test_eq_records_no_gradient_and_tensors_key_on_identity():
    def run(p):
        x = p.to_tensor(np.array([1., 2.], np.float32), stop_gradient=False)
        e = x == x
        y = p.to_tensor(np.array([1., 2.], np.float32))
        keyed = {x: "x", y: "y"}
        return (e.stop_gradient, e.numpy().tolist(), len(keyed), keyed[y],
                len({x, y, x}), hash(x) == id(x))

    j, t = _both(run)
    assert j == t == (True, [True, True], 2, "y", 2, True)


# F6 (recorded divergence): dtypes are the framework's dtype objects.
# They equal paddle.float32; unlike the JAX package's numpy dtypes they do
# not equal their names, as in Paddle itself.
def test_dtype_compares_to_dtype_objects_not_names():
    x = tp.to_tensor([1.0])
    assert x.dtype == tp.float32 and x.dtype != "float32"
    assert tp.get_default_dtype() is tp.float32 is torch.float32
    jx = jp.to_tensor([1.0])
    assert jx.dtype == jp.float32 and jx.dtype == "float32"


# F7 (recorded divergence): an integer tensor with a python float, and the
# mean of an integer tensor, give the default float dtype (float32); the
# JAX package gives float64 under jax_enable_x64.
_PROMOTE = {
    "mul": lambda p: p.to_tensor([1, 2]) * 2.0,
    "add": lambda p: p.to_tensor([1, 2]) + 1.5,
    "rtruediv": lambda p: 1 / p.to_tensor([1, 2]),
    "mean": lambda p: p.mean(p.to_tensor([1, 2])),
    "exp": lambda p: p.exp(p.to_tensor([1, 2])),
    "tanh": lambda p: p.tanh(p.to_tensor([1, -2])),
    "divide": lambda p: p.divide(p.to_tensor([1, 2]), p.to_tensor([3, 3])),
}


@pytest.mark.parametrize("name", sorted(_PROMOTE))
def test_int_promotes_to_the_default_float_dtype(name):
    j, t = _both(_PROMOTE[name])
    assert t.dtype == tp.get_default_dtype() == tp.float32
    assert _dtype_name(j) == "float64"
    assert t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=1e-6)


def test_adamw_global_clip_five_steps():
    """AdamW (decay 0.01, bias excluded by apply_decay_param_fun) with
    ClipGradByGlobalNorm(1.0) on a Linear, f32, 5 steps: the parameters
    after every step, and the state_dict round trip continuing the same."""
    rng = np.random.default_rng(3)
    x0 = (10 * rng.standard_normal((16, 8))).astype(np.float32)
    y0 = rng.standard_normal((16, 4)).astype(np.float32)
    sd = {"weight": rng.standard_normal((8, 4)).astype(np.float32),
          "bias": rng.standard_normal(4).astype(np.float32)}

    def run(p):
        lin = p.nn.Linear(8, 4)
        lin.set_state_dict(sd)
        bias_name = lin.bias.name
        opt = p.optimizer.AdamW(
            learning_rate=1e-3, parameters=lin.parameters(),
            apply_decay_param_fun=lambda n: n != bias_name,
            grad_clip=p.nn.ClipGradByGlobalNorm(1.0))
        x, y = p.to_tensor(x0), p.to_tensor(y0)
        out = []
        for _ in range(5):
            d = lin(x) - y
            (d * d).mean().backward()
            opt.step()
            opt.clear_grad()
            out.append([lin.weight.numpy().copy(), lin.bias.numpy().copy()])
        return out, opt

    (j, _), (t, topt) = _both(run)
    for step_j, step_t in zip(j, t):
        for a, b in zip(step_t, step_j):
            _close(a, b, PARAM_TOL)
    state = topt.state_dict()
    assert state["_step_count"] == 5
    assert sum(k.endswith(".moment1") for k in state) == 2


def test_optimizer_state_dict_resumes():
    """Moments carried by parameter name: a second optimizer loaded from
    the first's state_dict continues exactly as the first would."""
    rng = np.random.default_rng(4)
    x = tp.to_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    lin = tp.nn.Linear(6, 3)
    start = {k: v.numpy().copy() for k, v in lin.state_dict().items()}

    def loss():
        return (lin(x) * lin(x)).mean()

    opt = tp.optimizer.AdamW(1e-2, parameters=lin.parameters())
    for _ in range(2):
        loss().backward()
        opt.step()
        opt.clear_grad()
    saved = opt.state_dict()
    mid = {k: v.numpy().copy() for k, v in lin.state_dict().items()}
    loss().backward()
    opt.step()
    opt.clear_grad()
    want = {k: v.numpy().copy() for k, v in lin.state_dict().items()}
    lin.set_state_dict(mid)
    opt2 = tp.optimizer.AdamW(1e-2, parameters=lin.parameters())
    opt2.set_state_dict(saved)
    loss().backward()
    opt2.step()
    for k, v in lin.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
        assert not np.array_equal(want[k], start[k])


def test_clip_with_no_gradient():
    """F1: ClipGradByGlobalNorm over no gradients gives [] (JAX's sum of
    nothing), and AdamW with the clip steps before any backward."""
    for p in (jp, tp):
        assert p.nn.ClipGradByGlobalNorm(1.0)([]) == []
        lin = p.nn.Linear(4, 2)
        before = lin.weight.numpy().copy()
        opt = p.optimizer.AdamW(1e-2, parameters=lin.parameters(),
                                grad_clip=p.nn.ClipGradByGlobalNorm(1.0))
        opt.step()
        np.testing.assert_array_equal(lin.weight.numpy(), before)


class _Scale(object):
    """y = x @ w with w a bf16 parameter of either package."""

    def __new__(cls, p, w0):
        class Net(p.nn.Layer):
            def __init__(self):
                super().__init__()
                self.w = self.create_parameter(list(w0.shape),
                                               dtype="bfloat16")
                self.w.set_value(w0)

            def forward(self, x):
                return p.matmul(x, self.w)
        return Net()


def test_bf16_param_becomes_f32_after_adam_step():
    """F2: without master weights, one Adam/AdamW step on a bf16
    parameter leaves it f32 (`value - step` promotes and `_rebind` stores
    it), within 2 bf16 ulps of a step of JAX's value (the port rounds
    (1 - b1)·g and g² to bf16 as written; XLA's CPU code keeps them in
    f32), and the layer's next forward reads the new f32 tensor."""
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    c = rng.standard_normal((8, 4)).astype(np.float32)
    x0 = rng.standard_normal((3, 8)).astype(np.float32)
    lr, wd = 1e-2, 0.1
    for opt_name in ("Adam", "AdamW"):
        def run(p):
            net = _Scale(p, w0)
            opt = getattr(p.optimizer, opt_name)(
                lr, parameters=net.parameters(), weight_decay=wd)
            # d/dw sum(w * c) = c exactly, in bf16 on both sides
            (net.w * p.to_tensor(c).astype("bfloat16")).sum().backward()
            opt.step()
            opt.clear_grad()
            y = net(p.to_tensor(x0))
            return str(net.w.dtype), net.w.numpy(), y.numpy()

        (jdt, jw, jy), (tdt, tw, ty) = _both(run)
        assert jdt.endswith("float32") and tdt.endswith("float32"), \
            (jdt, tdt)
        step = lr * (1 + wd * np.abs(w0).max())
        assert np.abs(tw - jw).max() <= 2 * 2.0 ** -8 * step, opt_name
        for w, y in ((tw, ty), (jw, jy)):
            _close(y, x0 @ w, 1e-6, opt_name)


def _old_clip(params_grads, clip_norm):
    """ClipGradByGlobalNorm as the port ran it per parameter."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for _, g in params_grads))
    scale = clip_norm / torch.clamp(gn, min=clip_norm)
    return [(p, (g.float() * scale).to(g.dtype)) for p, g in params_grads]


def _old_adam_update(value, grad, state, lr, lr_mult, wd, decoupled,
                     b1=0.9, b2=0.999, eps=1e-8):
    """One parameter's Adam/AdamW update as the port ran it (`lr`, `wd`
    f32 0-dim tensors)."""
    if not decoupled:
        grad = grad + wd * value
    m1 = b1 * state["moment1"] + (1 - b1) * grad
    m2 = b2 * state["moment2"] + (1 - b2) * torch.square(grad)
    b1p = state["beta1_pow"] * b1
    b2p = state["beta2_pow"] * b2
    step = lr * lr_mult * (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p))
                                              + eps)
    if decoupled:
        step = step + lr * lr_mult * wd * value
    return value - step, {"moment1": m1, "moment2": m2, "beta1_pow": b1p,
                          "beta2_pow": b2p}


@pytest.mark.parametrize("name,clip,chunk", [
    ("Adam", False, None), ("AdamW", False, None), ("AdamW", True, None),
    ("AdamW", True, 64)])
def test_fused_update_matches_per_parameter(name, clip, chunk, monkeypatch):
    """F3: the grouped foreach update against the per-parameter one it
    replaced, over 3 steps of f32 parameters of mixed sizes, a parameter
    with lr multiplier 0.5 and one excluded from decay: bit for bit (the
    same operations in the same order), the global clip's gradients
    included; also with the groups cut into runs of at most 64 values
    (`transform.CHUNK_NUMEL`, which bounds the multi-tensor ops'
    temporaries)."""
    from paddle_tpu_torch.core.tensor import Parameter
    from paddle_tpu_torch.optimizer import transform
    if chunk is not None:
        monkeypatch.setattr(transform, "CHUNK_NUMEL", chunk)
    rng = np.random.default_rng(7)
    shapes = [(16, 8), (8,), (3, 5, 7), (1,)]
    ps = [Parameter(torch.from_numpy(rng.standard_normal(s)
                                     .astype(np.float32))) for s in shapes]
    ps[1].optimize_attr["learning_rate"] = 0.5
    excluded = ps[2].name
    kw = {"grad_clip": tp.nn.ClipGradByGlobalNorm(0.5)} if clip else {}
    if name == "AdamW":
        kw["apply_decay_param_fun"] = lambda n: n != excluded
    opt = getattr(tp.optimizer, name)(1e-2, parameters=ps, weight_decay=0.1,
                                      **kw)
    ref = [p._data.detach().clone() for p in ps]
    ref_st = [None] * len(ps)
    for _ in range(3):
        grads = [torch.from_numpy((3 * rng.standard_normal(s))
                                  .astype(np.float32)) for s in shapes]
        for p, g in zip(ps, grads):
            p._data.grad = g.clone()
        opt.step()
        opt.clear_grad()
        pg = list(zip(range(len(ps)), grads))
        if clip:
            pg = _old_clip(pg, 0.5)
        for (i, g), p in zip(pg, ps):
            st = ref_st[i] or {
                "moment1": torch.zeros_like(ref[i]),
                "moment2": torch.zeros_like(ref[i]),
                "beta1_pow": torch.ones(()), "beta2_pow": torch.ones(())}
            wd = 0.0 if p.name == excluded and name == "AdamW" else 0.1
            ref[i], ref_st[i] = _old_adam_update(
                ref[i], g, st, torch.tensor(1e-2),
                p.optimize_attr["learning_rate"], torch.tensor(wd),
                name == "AdamW")
    for p, r in zip(ps, ref):
        assert torch.equal(p._data.detach(), r)


def test_fused_update_launches_per_group():
    """F3: with the global clip, a step dispatches two operators more per
    parameter (the sum of its squares and its addition to the total, kept
    per tensor for the norm's bits) and otherwise as many for 30
    parameters as for 3: one
    multi-tensor op per operation of the formula, per (device, dtype)
    group. The per-parameter update dispatched ~20 per parameter."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from paddle_tpu_torch.core.tensor import Parameter

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def ops_per_step(n):
        ps = [Parameter(torch.ones(4, 3)) for _ in range(n)]
        opt = tp.optimizer.AdamW(
            1e-3, parameters=ps, grad_clip=tp.nn.ClipGradByGlobalNorm(1.0))
        for _ in range(2):     # the first step also builds the state
            for p in ps:
                p._data.grad = torch.full((4, 3), 0.5)
            Count.n = 0
            with Count():
                opt.step()
        return Count.n

    assert ops_per_step(30) - ops_per_step(3) == 2 * 27


def test_tree_adamw_matches_per_leaf():
    """F3: the tree `adamw` (and `clip_by_global_norm`, `apply_updates`)
    over foreach groups, bit for bit against optax's per-leaf formula as
    the port computed it, on a tree of f32 and bf16 leaves."""
    _tree_adamw_vs_per_leaf()


def test_tree_adamw_matches_per_leaf_chunked(monkeypatch):
    """The same with the groups cut into runs of at most 8 values
    (`transform.CHUNK_NUMEL`), so that each leaf of the tree runs alone:
    still bit for bit. The cut itself: consecutive tensors of one group
    share a run while they fit, other dtypes go to their own."""
    from paddle_tpu_torch.optimizer import transform as T
    monkeypatch.setattr(T, "CHUNK_NUMEL", 8)
    assert T.grouped_chunks([torch.ones(6), torch.ones(5, 4).bfloat16(),
                             torch.ones(3), torch.ones(2)]) == \
        [[0], [2, 3], [1]]
    _tree_adamw_vs_per_leaf()


def _tree_adamw_vs_per_leaf():
    from paddle_tpu_torch.optimizer import transform as T
    rng = np.random.default_rng(8)

    def leaf(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dt)

    params = {"b": leaf((6,), torch.float32),
              "a": {"w": leaf((5, 4), torch.bfloat16),
                    "v": leaf((3,), torch.float32)}}
    tx = T.chain(T.clip_by_global_norm(1.0), T.adamw(1e-2,
                                                      weight_decay=0.1))
    st = tx.init(params)
    ref = T.tree_map(torch.clone, params)
    mu = T.tree_map(torch.zeros_like, params)
    nu = T.tree_map(torch.zeros_like, params)
    for count in range(1, 4):
        grads = T.tree_map(lambda p: leaf(tuple(p.shape), p.dtype), params)
        upd, st = tx.update(grads, st, params)
        params = T.apply_updates(params, upd)
        # the per-leaf formulas
        sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32).square()
                 for g in T.tree_leaves(grads))
        gn = torch.sqrt(sq)
        g2 = T.tree_map(lambda t: torch.where(
            gn < 1.0, t, (t / gn.to(t.dtype)) * 1.0), grads)
        mu = T.tree_map(lambda g, t: (1 - 0.9) * g + 0.9 * t, g2, mu)
        nu = T.tree_map(lambda g, t: (1 - 0.999) * (g * g) + 0.999 * t,
                        g2, nu)
        bc1 = 1 - torch.pow(torch.tensor(0.9), torch.tensor(float(count)))
        bc2 = 1 - torch.pow(torch.tensor(0.999), torch.tensor(float(count)))
        u = T.tree_map(lambda m, v: (m / bc1.to(m.dtype)) / (
            torch.sqrt(v / bc2.to(v.dtype)) + 1e-8), mu, nu)
        u = T.tree_map(lambda g, p: g + 0.1 * p, u, ref)
        u = T.tree_map(lambda g: -1e-2 * g, u)
        ref = T.tree_map(lambda p, d: (p + d).to(p.dtype), ref, u)
    for a, b in zip(T.tree_leaves(params), T.tree_leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------- the tiny ERNIE
def _cfg(p):
    mod = jernie if p is jp else ternie
    return mod.ErnieConfig.tiny(hidden_size=128, num_attention_heads=2,
                                intermediate_size=256,
                                max_position_embeddings=64)


@pytest.fixture(scope="module")
def ernie_pair():
    """The same composition from both packages, dropout 0, the JAX
    model's initial weights (numpy) and one batch."""
    prev = tdevice._current_place
    tp.set_device("cpu")
    try:
        models = {n: build_model(p, _cfg(p), dropout=0.0)
                  for n, p in PKGS.items()}
    finally:
        tdevice._current_place = prev
    sd = {k: np.array(v.numpy()) for k, v in
          models["jax"].state_dict().items()}
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (2, 32))
    labels = rng.integers(0, 2, (2,))
    return models, sd, ids, labels


def test_ernie_same_names_and_counts(ernie_pair):
    models, sd, _, _ = ernie_pair
    names = {n: [k for k, _ in m.named_parameters()]
             for n, m in models.items()}
    assert names["jax"] == names["torch"]
    assert len(names["torch"]) == 5 + 2 * 16 + 4
    shapes = {k: tuple(v.shape) for k, v in models["torch"].state_dict()
              .items()}
    assert shapes == {k: v.shape for k, v in sd.items()}
    cfg = _cfg(tp)
    assert ternie.flops_per_token(cfg, 32) == \
        jernie.flops_per_token(_cfg(jp), 32)
    # the encoder's own count: num_params minus the MLM head this
    # classifier does not have
    D, V = cfg.hidden_size, cfg.vocab_size
    assert sum(int(np.prod(s)) for s in shapes.values()) == \
        ternie.num_params(cfg) - (D * D + D + 2 * D + V) - 2 * D + 2 * D
    sq = {n: [k for k, _ in p.nn.Sequential(
        p.nn.Linear(4, 8), p.nn.ReLU(), p.nn.Linear(8, 2))
        .named_parameters()] for n, p in PKGS.items()}
    assert sq["jax"] == sq["torch"] == ["0.weight", "0.bias", "2.weight",
                                        "2.bias"]


def _grad_floor(grads):
    """A thousandth of the largest gradient of the model."""
    return 1e-3 * max(np.abs(g).max() for g in grads.values())


def _ernie_run(models, sd, ids, labels, amp, steps):
    """Per package: logits, loss, every parameter's grad of one forward +
    backward, then the parameters after `steps` AdamW steps (the grads of
    the first step included), all from the weights `sd`."""
    out = {}
    for n, p in PKGS.items():
        m = models[n]
        m.set_state_dict(sd)
        loss_fn = p.nn.CrossEntropyLoss()
        x, y = p.to_tensor(ids), p.to_tensor(labels)
        with p.amp.auto_cast(enable=amp is not None,
                             dtype=amp or "bfloat16"):
            logits = m(x)
            loss = loss_fn(logits, y)
        loss.backward()
        grads = {k: q.grad.numpy().copy() for k, q in m.named_parameters()}
        m.clear_gradients()
        opt = p.optimizer.AdamW(learning_rate=1e-3,
                                parameters=m.parameters(),
                                grad_clip=p.nn.ClipGradByGlobalNorm(1.0))
        losses = [train_step(p, m, loss_fn, opt, x, y, amp).item()
                  for _ in range(steps)]
        assert _dtype_name(logits) == ("bfloat16" if amp else "float32")
        out[n] = (logits.numpy(), loss.item(), grads, losses,
                  {k: q.numpy().copy() for k, q in m.named_parameters()})
    return out


@pytest.fixture(scope="module")
def ernie_runs(ernie_pair):
    """The f32 run (with 3 AdamW steps) and the O1 bf16 run of both
    packages from the same weights and batch."""
    models, sd, ids, labels = ernie_pair
    prev = tdevice._current_place
    tp.set_device("cpu")
    try:
        return {"f32": _ernie_run(models, sd, ids, labels, None, STEPS),
                "o1": _ernie_run(models, sd, ids, labels, "bfloat16", 0)}
    finally:
        tdevice._current_place = prev


STEPS, LR = 3, 1e-3


def test_ernie_f32_logits_grads_and_steps(ernie_pair, ernie_runs):
    sd = ernie_pair[1]
    res = ernie_runs["f32"]
    (lj, loss_j, gj, sj, pj), (lt, loss_t, gt, st, pt) = \
        res["jax"], res["torch"]
    _close(lt, lj, F32_TOL, "logits")
    _close([loss_t], [loss_j], F32_TOL, "loss")
    _close(st, sj, F32_TOL, "step losses")
    assert set(gt) == set(gj) and len(gt) == 41
    for k in gj:
        _close(gt[k], gj[k], GRAD_TOL, f"grad {k}", _grad_floor(gj))
    moved = 0.0
    for k in pj:
        err = np.abs(pt[k] - pj[k]).max()
        assert err <= STEP_TOL * STEPS * LR, f"param {k}: {err}"
        moved = max(moved, np.abs(pj[k] - sd[k]).max())
    assert moved > LR                               # the steps did move


def test_ernie_o1_bf16(ernie_runs):
    """Under O1 the logits and the loss agree with JAX's O1; each
    gradient is held against the f32 evaluation: the port's O1 may be no
    further from it than 1.5x JAX's O1 (+1e-3, for the key biases whose
    gradient is f32 noise around 0)."""
    f32, o1 = ernie_runs["f32"], ernie_runs["o1"]
    (lj, loss_j, gj, _, _), (lt, loss_t, gt, _, _) = o1["jax"], o1["torch"]
    _close(lt, lj, O1_TOL, "logits")
    _close([loss_t], [loss_j], O1_TOL, "loss")
    g32 = f32["jax"][2]
    floor = 1e-3 * max(np.linalg.norm(g) for g in g32.values())
    for k, ref in g32.items():
        scale = max(np.linalg.norm(ref), floor)
        d_t = np.linalg.norm(gt[k] - ref) / scale
        d_j = np.linalg.norm(gj[k] - ref) / scale
        assert d_t <= O1_RATIO * d_j + 1e-3, (k, d_t, d_j)
