"""The port's autograd surface against the JAX package, on the CPU:
PyLayer, `paddle.grad` (with retain_graph, allow_unused and
create_graph), the functional transforms (jacobian, hessian, vjp, jvp
and their views), Tensor hooks and `retain_grads`, and the in-place ops.

The same numpy values go through `paddle_tpu` (JAX, its eager tape) and
`paddle_tpu_torch` (torch autograd) by one function written against
either package (`_both`). Results compare in dtype and shape and within
1e-6 relative in f32 (the same expressions; torch.func and jax compute
the transforms' products in another order: 1e-5 for second
derivatives). The recorded divergences are pinned here too: a hook runs
once on the summed gradient (the JAX tape runs it on each use's part),
`mark_non_differentiable` stops the gradient, `inplace_version` counts
the in-place writes (the JAX package's reads an attribute nothing sets
and stays 0), and the functional transforms refuse the port's kernel
ops (torch.func has no rule for their autograd.Functions; the JAX
package's jacobian passes through its kernels' custom_vjp, and its jvp
refuses them as well).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import paddle_tpu as jp  # noqa: E402
from paddle_tpu.ops import method_ext as jmethod_ext  # noqa: E402
import paddle_tpu.ops as jops  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402

TOL = 1e-6
TOL2 = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _both(fn):
    return fn(jp), fn(tp)


def _t(P, values, sg=False):
    return P.to_tensor(np.asarray(values, np.float32), stop_gradient=sg)


def _np(x):
    return np.asarray(x.numpy(), np.float64)


def _dt(x):
    return str(x.dtype).replace("torch.", "")


def _same(j, t, tol=TOL, what=""):
    """Tensors, or (nested) tuples / lists of them and None."""
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), what
        for a, b in zip(j, t):
            _same(a, b, tol, what)
        return
    if j is None or t is None:
        assert j is None and t is None, what
        return
    assert _dt(j) == _dt(t) and list(j.shape) == list(t.shape), \
        (what, _dt(j), _dt(t), j.shape, t.shape)
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol,
                               err_msg=what)


# ------------------------------------------------------------ PyLayer
def _scale_layer(P):
    class ScaleMul(P.PyLayer):
        """(k·x·y, x + y) with a non-tensor k; saved tensors."""

        @staticmethod
        def forward(ctx, x, k, y):
            ctx.save_for_backward(x, y)
            ctx.k = k
            return x * y * k, x + y

        @staticmethod
        def backward(ctx, g_prod, g_sum):
            x, y = ctx.saved_tensor()
            return g_prod * y * ctx.k + g_sum, g_prod * x * ctx.k + g_sum

    return ScaleMul


def test_pylayer_one_output():
    def run(P):
        class Double(P.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 2

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensor()
                return g * 2 + x * 0

        x = _t(P, [3.0, -1.0])
        y = Double.apply(x)
        (y * y).sum().backward()
        return y, x.grad, y.stop_gradient

    j, t = _both(run)
    _same(j[:2], t[:2])
    assert j[2] is t[2] is False


def test_pylayer_several_outputs_and_a_python_argument():
    def run(P):
        x, y = _t(P, [1.0, 2.0]), _t(P, [3.0, -4.0])
        prod, total = _scale_layer(P).apply(x, 0.5, y)
        (prod * prod + total * 3.0).sum().backward()
        return prod, total, x.grad, y.grad

    _same(*_both(run))


def test_pylayer_non_float_output_gets_none():
    """A bool output is stop_gradient and its gradient arrives as None;
    a float output the loss does not use arrives as zeros."""
    def run(P):
        seen = {}

        class Split(P.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 2, x > 0, x * 3

            @staticmethod
            def backward(ctx, g, g_mask, g_unused):
                seen["mask"] = g_mask
                seen["unused"] = _np(g_unused)
                return g * 2 + g_unused

        x = _t(P, [1.0, -2.0])
        a, mask, _ = Split.apply(x)
        a.sum().backward()
        return (x.grad, mask.stop_gradient, _dt(mask), seen["mask"],
                seen["unused"].tolist())

    j, t = _both(run)
    _same(j[0], t[0])
    assert j[1:] == t[1:] == (True, "bool", None, [0.0, 0.0])


def test_pylayer_without_a_differentiable_input_records_nothing():
    """Under no_grad, or with every Tensor argument stop_gradient, apply
    returns forward's outputs with no node: backward never runs."""
    def run(P):
        calls = []

        class Twice(P.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, g):
                calls.append(1)
                return g

        x = _t(P, [1.0])
        with P.no_grad():
            a = Twice.apply(x)
        b = Twice.apply(_t(P, [1.0], sg=True))
        return a.stop_gradient, b.stop_gradient, _np(a).tolist(), calls

    j, t = _both(run)
    assert j == t == (True, True, [2.0], [])


def test_pylayer_double_grad_raises():
    def run(P):
        x = _t(P, [1.0, 2.0])
        prod, _ = _scale_layer(P).apply(x, 1.0, x * 1.0)
        with pytest.raises(RuntimeError):
            g = P.grad(prod.sum(), [x], create_graph=True)
            P.grad(g[0].sum(), [x])
        return True

    assert _both(run) == (True, True)


def test_mark_non_differentiable_is_a_recorded_divergence():
    """The port stops the marked output's gradient (Paddle's documented
    meaning; its backward gets zeros for it); the JAX package records
    the call and keeps the output differentiable."""
    def run(P):
        class Pair(P.PyLayer):
            @staticmethod
            def forward(ctx, x):
                b = x * 3
                ctx.mark_non_differentiable(b)
                return x * 2, b

            @staticmethod
            def backward(ctx, g, gb):
                return g * 2 + gb

        a, b = Pair.apply(_t(P, [1.0]))
        return a.stop_gradient, b.stop_gradient

    j, t = _both(run)
    assert j == (False, False) and t == (False, True)


def test_legacy_pylayer_and_exports():
    for P in (jp, tp):
        assert P.PyLayer is P.autograd.PyLayer
        for n in ("grad", "is_grad_enabled"):
            assert callable(getattr(P, n)) and callable(
                getattr(P.autograd, n))
        for n in ("PyLayerContext", "jacobian", "hessian", "vjp", "jvp",
                  "Jacobian", "Hessian", "backward", "no_grad"):
            assert hasattr(P.autograd, n), (P.__name__, n)
    assert issubclass(tp.autograd.LegacyPyLayer, tp.PyLayer)
    assert tp.is_grad_enabled() and jp.is_grad_enabled()


# --------------------------------------------------------- paddle.grad
def test_grad_leaves_every_grad_as_it_was():
    """paddle.grad of a loss over a weight and an intermediate: JAX's
    values; the leaves' accumulated .grad and a non-leaf's retain state
    are as before."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((3, 2)).astype(np.float32)
    x0 = rng.standard_normal((4, 3)).astype(np.float32)

    def run(P):
        w, x = _t(P, w0), _t(P, x0, sg=True)
        (x @ w).sum().backward()
        before = _np(w.grad)
        h = x @ w
        loss = (h.tanh() * h).sum()
        gw, gh = P.grad(loss, [w, h])
        return gw, gh, _np(w.grad) - before, h.grad

    j, t = _both(run)
    _same(j[:2], t[:2])
    assert not j[2].any() and not t[2].any()
    assert j[3] is None and t[3] is None


def test_grad_retain_graph_and_grad_outputs():
    def run(P):
        x = _t(P, [1.0, 2.0, 3.0])
        y = x * x * 2.0
        v = _t(P, [1.0, 0.5, -1.0], sg=True)
        (a,) = P.grad(y, x, grad_outputs=v, retain_graph=True)
        (b,) = P.grad(y, x, grad_outputs=v)
        with pytest.raises(RuntimeError):
            P.grad(y, x, grad_outputs=v)
        with pytest.raises(RuntimeError):
            P.grad(y, x)            # non-scalar with no grad_outputs
        return a, b

    _same(*_both(run))


def test_grad_unused_inputs():
    def run(P):
        x, z = _t(P, [1.0]), _t(P, [2.0])
        frozen = _t(P, [3.0], sg=True)
        with pytest.raises(RuntimeError):
            P.grad((x * 2).sum(), [z])
        with pytest.raises(RuntimeError):
            P.grad((x * frozen).sum(), [frozen])
        return P.grad((x * 2).sum(), [x, z], allow_unused=True)

    j, t = _both(run)
    _same(j, t)
    assert t[1] is None


def test_double_grad():
    """d²(Σx³)/dx² and a third derivative through create_graph."""
    def run(P):
        x = _t(P, [2.0, -1.5, 0.5])
        (g1,) = P.grad((x * x * x).sum(), [x], create_graph=True)
        (g2,) = P.grad(g1.sum(), [x], create_graph=True)
        (g3,) = P.grad((g2 * g2).sum(), [x])
        return g1, g2, g3, g1.stop_gradient

    j, t = _both(run)
    _same(j[:3], t[:3], TOL2)
    assert j[3] is t[3] is False


def test_gradient_penalty_on_a_small_mlp():
    """‖∂D/∂x‖² of a two-layer tanh MLP through create_graph, then
    backward: every weight's gradient is JAX's."""
    rng = np.random.default_rng(1)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.5
          for s in ((4, 8), (8,), (8, 1))]
    x0 = rng.standard_normal((5, 4)).astype(np.float32)

    def run(P):
        w1, b1, w2 = (_t(P, w) for w in ws)
        x = _t(P, x0)
        d = ((x @ w1 + b1).tanh() @ w2).sum()
        (gx,) = P.grad(d, [x], create_graph=True)
        pen = (gx * gx).sum()
        pen.backward()
        return pen, w1.grad, b1.grad, w2.grad

    _same(*_both(run), tol=TOL2)


# ------------------------------------------------ functional transforms
def _two_in(a, b):
    return ((a * b).tanh() * a).sum()


@pytest.mark.parametrize("batch_axis", [None, 0])
def test_jacobian(batch_axis):
    x0 = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    y0 = np.random.default_rng(3).standard_normal((3, 4)).astype(np.float32)

    def run(P):
        x, y = _t(P, x0), _t(P, y0)
        one = P.autograd.jacobian(lambda a: (a * a).tanh(), x,
                                  batch_axis=batch_axis)
        two = P.autograd.jacobian(lambda a, b: a * b + a, [x, y],
                                  batch_axis=batch_axis)
        view = P.autograd.Jacobian(lambda a: (a * a).tanh(), x,
                                   is_batched=batch_axis == 0)
        return one, two, view[0]

    _same(*_both(run))


@pytest.mark.parametrize("batch_axis", [None, 0])
def test_hessian(batch_axis):
    x0 = np.random.default_rng(4).standard_normal((2, 3)).astype(np.float32)
    y0 = np.random.default_rng(5).standard_normal((2, 3)).astype(np.float32)

    def run(P):
        x, y = _t(P, x0), _t(P, y0)
        if batch_axis is None:
            one = P.autograd.hessian(lambda a: (a * a * a).sum(), x)
            two = P.autograd.hessian(_two_in, [x, y])
            view = P.autograd.Hessian(_two_in, [x, y])[0][1]
        else:
            one = P.autograd.hessian(lambda a: (a * a * a).sum(), x,
                                     batch_axis=0)
            two = P.autograd.hessian(_two_in, [x, y], batch_axis=0)
            view = P.autograd.Hessian(_two_in, [x, y],
                                      is_batched=True)[1][1]
        return one, two, view

    _same(*_both(run), tol=TOL2)


def test_vjp_and_jvp():
    x0 = np.random.default_rng(6).standard_normal((3,)).astype(np.float32)
    v0 = np.random.default_rng(7).standard_normal((3,)).astype(np.float32)

    def run(P):
        x, v = _t(P, x0), _t(P, v0, sg=True)
        f = lambda a: (a * a * a).sum(axis=-1)    # noqa: E731
        g = lambda a: (a * a).tanh()              # noqa: E731
        return (P.autograd.vjp(g, x), P.autograd.vjp(g, x, v),
                P.autograd.vjp(lambda a, b: (a * b, a + b), [x, v],
                               [v, v]),
                P.autograd.jvp(g, x), P.autograd.jvp(g, x, v),
                P.autograd.vjp(f, x))

    _same(*_both(run))


def test_transforms_over_a_kernel_op_are_a_recorded_divergence():
    """Through the fused LayerNorm (a kernel op: an autograd.Function
    with no torch.func rule) the port's transforms raise, on the CPU
    too; the JAX package's jacobian passes through its custom_vjp and
    its jvp refuses it."""
    x0 = np.random.default_rng(8).standard_normal((2, 8)).astype(np.float32)

    def ln(P):
        w = P.to_tensor(np.ones(8, np.float32))
        b = P.to_tensor(np.zeros(8, np.float32))
        return lambda a: P.incubate.nn.functional.fused_layer_norm(a, w, b)

    jac = jp.autograd.jacobian(ln(jp), _t(jp, x0))
    assert list(jac.shape) == [2, 8, 2, 8]
    with pytest.raises(RuntimeError, match="torch.func"):
        tp.autograd.jacobian(ln(tp), _t(tp, x0))
    with pytest.raises(RuntimeError, match="torch.func"):
        tp.autograd.jvp(ln(tp), _t(tp, x0))
    with pytest.raises(TypeError):
        jp.autograd.jvp(ln(jp), _t(jp, x0))


# -------------------------------------------------------------- hooks
def test_hooks_and_handle_removal():
    def run(P):
        x = _t(P, [1.0, 2.0])
        seen = []

        def hook(g):
            seen.append(_np(g).tolist())
            return g * 2

        h = x.register_hook(hook)
        (x * 3).sum().backward()
        first = _np(x.grad).tolist()
        h.remove()
        x.clear_grad()
        (x * 3).sum().backward()
        return seen, first, _np(x.grad).tolist()

    j, t = _both(run)
    assert j == t == ([[3.0, 3.0]], [6.0, 6.0], [3.0, 3.0])


def test_hooks_on_a_non_leaf_in_backward_and_grad():
    """A hook on an intermediate changes the gradient flowing on, in
    backward and in paddle.grad, and paddle.grad's result for a hooked
    input is the hook's. Asked for together with an input its gradient
    flows on to, torch captures the hooked intermediate's gradient
    before its hook (the JAX tape after it): a recorded divergence."""
    def run(P):
        x = _t(P, [1.0, -2.0])
        h = x * x
        h.register_hook(lambda g: g * 10)
        loss = (h * 3.0).sum()
        (gx,) = P.grad(loss, [x], retain_graph=True)
        (gh,) = P.grad(loss, [h], retain_graph=True)
        both = P.grad(loss, [x, h], retain_graph=True)
        loss.backward()
        return gx, gh, x.grad, both

    j, t = _both(run)
    _same(j[:3], t[:3])
    _same(j[3][0], t[3][0])
    assert _np(j[3][1]).tolist() == [30.0, 30.0]
    assert _np(t[3][1]).tolist() == [3.0, 3.0]


def test_hook_on_a_tensor_used_twice_is_a_recorded_divergence():
    """torch calls the hook once with the summed gradient (as Paddle
    does); the JAX tape calls it on each use's part. The gradients
    agree for a linear hook."""
    def run(P):
        x = _t(P, [1.0, 2.0])
        calls = []
        x.register_hook(lambda g: calls.append(_np(g).tolist()) or g * 2)
        (x * 3 + x * 5).sum().backward()
        return calls, _np(x.grad).tolist()

    j, t = _both(run)
    assert sorted(j[0]) == [[3.0, 3.0], [5.0, 5.0]]
    assert t[0] == [[8.0, 8.0]] and j[1] == t[1] == [16.0, 16.0]


def test_retain_grads():
    def run(P):
        x = _t(P, [2.0])
        y = x * 3
        y.retain_grads()
        (y * y).sum().backward()
        z = x * 4
        (z * z).sum().backward()
        return y.grad, x.grad, z.grad

    _same(*_both(run))


# ------------------------------------------------------ in-place ops
INPLACE_CASES = {
    "add_": lambda P, x: x.add_(_t(P, [1.0, 2.0, 3.0], sg=True)),
    "subtract_": lambda P, x: x.subtract_(_t(P, [0.5, 0.5, 0.5], sg=True)),
    "multiply_": lambda P, x: x.multiply_(_t(P, [2.0, 3.0, 4.0], sg=True)),
    "divide_": lambda P, x: x.divide_(_t(P, [2.0, 4.0, 8.0], sg=True)),
    "exp_": lambda P, x: x.exp_(),
    "tanh_": lambda P, x: x.tanh_(),
    "abs_": lambda P, x: x.abs_(),
    "neg_": lambda P, x: x.neg_(),
    "pow_": lambda P, x: x.pow_(2),
    "reshape_": lambda P, x: x.reshape_([3, 1]),
    "unsqueeze_": lambda P, x: x.unsqueeze_(0),
    "cast_": lambda P, x: x.cast_("float16"),
    "gelu_": lambda P, x: x.gelu_(),
    "silu_": lambda P, x: x.silu_(),
    "less_than_": lambda P, x: x.less_than_(_t(P, [0.0, 0.0, 0.0], sg=True)),
}


@pytest.mark.parametrize("name", sorted(INPLACE_CASES))
def test_inplace_op_matches_jax(name):
    """On a stop_gradient tensor: the result is the receiver, with JAX's
    dtype, shape and values."""
    def run(P):
        x = _t(P, [0.5, -1.0, 2.0], sg=True)
        out = INPLACE_CASES[name](P, x)
        assert out is x
        return x

    _same(*_both(run))


def test_backward_through_inplace_ops():
    def run(P):
        x = _t(P, [0.5, -1.0, 2.0])
        y = x * 2.0
        y.exp_()
        y.multiply_(x)
        y.tanh_()
        y.sum().backward()
        return y, x.grad, y.stop_gradient

    j, t = _both(run)
    _same(j[:2], t[:2])
    assert j[2] is t[2] is False


def test_inplace_version_counts_the_writes():
    """Each in-place op (and `x[i] = v`) adds one; the JAX package's
    property reads an attribute nothing sets and stays 0 (a recorded
    divergence)."""
    def run(P):
        x = _t(P, [1.0, 2.0], sg=True)
        x.add_(_t(P, [1.0, 1.0], sg=True))
        x.exp_()
        x[0] = 3.0
        return x.inplace_version

    assert _both(run) == (0, 3)


def test_unrecorded_write_to_a_non_leaf_raises():
    def run(P):
        x = _t(P, [1.0, 2.0])
        y = x * 2
        with P.no_grad():
            with pytest.raises(RuntimeError):
                y.add_(_t(P, [1.0, 1.0], sg=True))
        w = P.Parameter(np.array([1.0, 2.0], np.float32))
        with P.no_grad():
            w.multiply_(_t(P, [3.0, 3.0], sg=True))
        return w, w.stop_gradient

    j, t = _both(run)
    _same(j[0], t[0])
    assert j[1] is t[1] is False


def test_where_inplace_writes_into_x():
    def run(P):
        cond = P.to_tensor(np.array([True, False, True]))
        x = _t(P, [1.0, 2.0, 3.0], sg=True)
        y = _t(P, [-1.0, -2.0, -3.0], sg=True)
        out = P.where_(cond, x, y)
        cond.where_(x, P.zeros([3]))
        return out is x, x, cond, P.where(cond, x, 9.0)

    j, t = _both(run)
    assert j[0] is t[0] is True
    _same(j[1:], t[1:])


def test_inplace_names_against_jax():
    """Every in-place op of the port is named in the JAX package's
    in-place lists (`ops._INPLACE`, `method_ext._MORE_INPLACE`) or is
    `where_`, and exists there too; every op of the port's `ops` in
    `_INPLACE` has its in-place twin."""
    jax_names = set(jops._INPLACE) | set(jmethod_ext._MORE_INPLACE)
    ported = set(tp.ops.INPLACE_OPS) | set(tp.nn.functional.INPLACE_OPS)
    assert ported - {"where_"} == {n + "_" for n in jax_names
                                   if n + "_" in ported}
    for n in ported:
        assert hasattr(jp.Tensor, n) or hasattr(jp.nn.functional, n), n
        assert hasattr(tp.Tensor, n) or hasattr(tp.nn.functional, n), n
    have = [n for n in jops._INPLACE if callable(getattr(tp.ops, n, None))]
    assert {n + "_" for n in have} <= ported
    assert {"add_", "exp_", "reshape_", "cast_", "where_"} <= ported
    assert {"relu_", "gelu_", "silu_", "swish_"} <= ported
    for n in tp.ops.INPLACE_OPS:
        assert getattr(tp, n) is getattr(tp.ops, n)
