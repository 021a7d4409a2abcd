"""The port's Tensor protocol and the F8-F12 repairs against the JAX
package, on the CPU.

The same numpy values go through `paddle_tpu` (JAX) and
`paddle_tpu_torch`: every operator of the Tensor protocol (`// % ** & |
^ < <= > >=`, unary `-`, `abs`, `~`) over each pair of {f32, bf16,
int32, int64, bool}, `__setitem__` with a gradient through it, `clone`,
`trainable`; matmul and linear over mixed dtypes (F8), dropout with
p = 1 (F9), negative-step slicing (F11). Each comparison holds the
result's dtype and shape as well as its values: where the JAX package
raises, the port must raise too. The recorded divergences are pinned
here as well: `squeeze` of an axis longer than 1 (F11), the order of
`init_params`' arguments (F12), max pools over bf16 and the JAX
package's `%` operator, which raises TypeError (`paddle_tpu/ops/
__init__.py:158` calls the name `mod`, which is a module there); the
port's `%` is `ops.mod`, held against the JAX package's `ops.mod`.
The F13-F16 repairs: subtraction with a bool operand, `sum(dtype=)`
summing before its cast, the bool operands of `//`, `%`, `**` and `@`,
integer inputs of `gelu`, `log_softmax` and `layer_norm`, and reflected
Python scalars on narrow tensors (a recorded divergence, as a uint8
sum's int64).

Tolerances: f32 results are the same expressions in both (1e-6
relative); bf16 results are rounded once to bf16 in both, from f32
values that may differ in their last f32 bits: one bf16 ulp (2^-8
relative of each value, held at 8e-3); f16 results likewise within one
f16 ulp (2^-10, held at 1e-3). Integer and bool results are exact.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.ops import math as tmath  # noqa: E402

DTYPES = ["float32", "bfloat16", "int32", "int64", "bool"]
F32_TOL = 1e-6
BF16_TOL = 8e-3
F16_TOL = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _name(dt):
    return str(dt).replace("torch.", "")


def _values(dtype, seed, divisor=False):
    """[2, 3] values of `dtype`'s kind: floats in [0.5, 3), integers in
    1..4, bools (all True for a divisor: no division by zero)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return np.ones((2, 3), bool) if divisor else rng.random((2, 3)) < .5
    if dtype.startswith(("int", "uint")):
        return rng.integers(1, 5, (2, 3))
    return rng.uniform(0.5, 3.0, (2, 3))


def _tensors(values, dtype):
    return jp.to_tensor(values).astype(dtype), \
        tp.to_tensor(values).astype(dtype)


def _outcome(fn, *args):
    """("ok", dtype name, shape, float64 values) or ("raise",)."""
    try:
        out = fn(*args)
    except Exception:               # noqa: BLE001 - both must raise
        return ("raise",)
    return ("ok", _name(out.dtype), tuple(out.shape),
            np.asarray(out.astype("float32").numpy(), np.float64))


def _same(j, t, what):
    assert j[0] == t[0], f"{what}: JAX {j[0]}, port {t[0]}"
    if j[0] == "raise":
        return
    assert j[1:3] == t[1:3], f"{what}: JAX {j[1:3]}, port {t[1:3]}"
    tol = {"bfloat16": BF16_TOL, "float16": F16_TOL}.get(j[1], F32_TOL)
    np.testing.assert_allclose(t[3], j[3], rtol=tol, atol=tol,
                               err_msg=what)


BINARY = {
    "sub": lambda a, b: a - b,
    "floordiv": lambda a, b: a // b,
    "pow": lambda a, b: a ** b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
}


@pytest.mark.parametrize("left", DTYPES)
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_operator_matches_jax(op, left):
    """Every right operand dtype: the result's dtype, shape and values
    are the JAX package's, or both raise (bitwise ops on floats)."""
    fn = BINARY[op]
    for right in DTYPES:
        aj, at = _tensors(_values(left, 1), left)
        bj, bt = _tensors(_values(right, 2, divisor=op == "floordiv"),
                          right)
        _same(_outcome(fn, aj, bj), _outcome(fn, at, bt),
              f"{left} {op} {right}")


@pytest.mark.parametrize("left", DTYPES)
def test_mod_operator_is_ops_mod(left):
    """`%` is `ops.mod` (the remainder with the divisor's sign) for each
    dtype pair; the JAX package's `%` raises TypeError, a recorded
    divergence, so the port is held to its `ops.mod`."""
    for right in DTYPES:
        aj, at = _tensors(_values(left, 3) * (-1 if left != "bool" else 1),
                          left)
        bj, bt = _tensors(_values(right, 4, divisor=True), right)
        _same(_outcome(jp.ops.mod, aj, bj), _outcome(lambda a, b: a % b,
                                                     at, bt),
              f"{left} % {right}")
    aj, _ = _tensors(_values("float32", 3), "float32")
    with pytest.raises(TypeError):
        aj % aj


@pytest.mark.parametrize("op", ["neg", "abs", "invert"])
def test_unary_operator_matches_jax(op):
    fn = {"neg": lambda a: -a, "abs": lambda a: abs(a),
          "invert": lambda a: ~a}[op]
    for dtype in DTYPES:
        aj, at = _tensors(_values(dtype, 5) - (1.5 if dtype != "bool"
                                               else 0), dtype)
        _same(_outcome(fn, aj), _outcome(fn, at), f"{op} {dtype}")


# (case, reflected, the scalar's kind)
SCALAR_CASES = [
    (lambda a: a // 2, False, int), (lambda a: a < 1, False, int),
    (lambda a: a >= 2, False, int), (lambda a: a ** 2, False, int),
    (lambda a: 2 ** a, True, int), (lambda a: 7 // a, True, int),
    (lambda a: -a, False, None), (lambda a: a - 2, False, int),
    (lambda a: 2 - a, True, int), (lambda a: a.__rsub__(2), True, int),
    (lambda a: -3 - a, True, int), (lambda a: 0.5 - a, True, float),
    (lambda a: 2.5 / a, True, float), (lambda a: 2.5 // a, True, float),
    (lambda a: 0.5 ** a, True, float), (lambda a: a - 0.5, False, float),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "uint8", "int32", "int64"])
def test_python_scalar_operands(dtype):
    """A python scalar on either side keeps the tensor's dtype, as JAX's
    weak types do, except where these divergences are recorded:
    - reflected (F16, F7's family): the JAX package's `_swap` makes the
      scalar a tensor of the default dtype first, so `0.5 - x`, `2.5 / x`,
      `2.5 // x` and `0.5 ** x` on bf16 or f16 give f32, and `2 ** x`,
      `7 // x`, `2 - x`, `-3 - x` on int8, uint8 or int32 give int64; the
      port keeps the tensor's dtype, as Paddle does, with JAX's value in
      that dtype (rounded; wrapped in uint8);
    - a float scalar on an integer tensor (F7): float64 in the JAX
      package (x64), the default float32 in the port."""
    for i, (fn, reflected, kind) in enumerate(SCALAR_CASES):
        aj, at = _tensors(_values(dtype, 6), dtype)
        j, t = _outcome(fn, aj), _outcome(fn, at)
        what = f"case {i} on {dtype}"
        integer = dtype.startswith(("int", "uint"))
        if kind is float and not reflected and integer:
            assert (j[1], t[1]) == ("float64", "float32"), what
            j = (j[0], "float32") + j[2:]
        elif reflected and ((kind is float and dtype in ("bfloat16",
                                                         "float16"))
                            or (kind is int and dtype in ("int8", "uint8",
                                                          "int32"))):
            assert (j[1], t[1]) == ("float32" if kind is float
                                    else "int64", dtype), what
            src = torch.from_numpy(j[3])
            if integer:
                src = src.long()
            j = (j[0], dtype, j[2],
                 src.to(getattr(torch, dtype)).double().numpy())
        _same(j, t, what)


# ----------------------------------------------------------------- F13
BOOL_SUB = {
    "1.0 - mask": lambda P, m, x: 1.0 - m,
    "1 - mask": lambda P, m, x: 1 - m,
    "x - mask": lambda P, m, x: x - m,
    "mask - x": lambda P, m, x: m - x,
    "x - True": lambda P, m, x: x - True,
    "mask - 2": lambda P, m, x: m - 2,
    "i32 - mask": lambda P, m, x: x.astype("int32") - m,
    "bf16 - mask": lambda P, m, x: x.astype("bfloat16") - m,
    "(1.0 - mask) * -1e4": lambda P, m, x: (1.0 - m) * -1e4,
    "subtract(x, mask)": lambda P, m, x: P.subtract(x, m),
    "mask - mask": lambda P, m, x: m - m,
    "mask - True": lambda P, m, x: m - True,
    "True - mask": lambda P, m, x: True - m,
}


@pytest.mark.parametrize("case", sorted(BOOL_SUB))
def test_subtract_with_a_bool_operand(case):
    """The bool side is cast to the promoted dtype (JAX's dtype, shape
    and values); bool minus bool raises in both packages."""
    fn = BOOL_SUB[case]
    args = {P: (P.to_tensor(np.array([True, False, True])),
                P.to_tensor(np.array([1.0, 2.0, 3.0], np.float32)))
            for P in (jp, tp)}
    _same(_outcome(lambda P: fn(P, *args[P]), jp),
          _outcome(lambda P: fn(P, *args[P]), tp), case)


def test_bool_minus_a_python_float_is_f7():
    """mask - 1.5: float64 in the JAX package (x64), float32 here."""
    j = jp.to_tensor(np.array([True, False])) - 1.5
    t = tp.to_tensor(np.array([True, False])) - 1.5
    assert (_name(j.dtype), _name(t.dtype)) == ("float64", "float32")
    np.testing.assert_array_equal(t.numpy(), j.numpy())


# ----------------------------------------------------------------- F14
def test_sum_with_dtype_sums_then_casts():
    """sum(x, dtype=) sums in x's dtype and casts the sum, as the JAX
    package does: f32 -> int64 truncates each row's f32 sum (casting each
    element first would give other integers), and a bf16 sum is rounded
    to bf16 before it becomes f32."""
    rng = np.random.default_rng(2)
    x32 = (3 * rng.standard_normal((4, 24))).astype(np.float32)
    xb = (3 * rng.standard_normal(24)).astype(np.float32)
    for make in (lambda P: P.sum(P.to_tensor(x32), axis=1, dtype="int64"),
                 lambda P: P.sum(P.to_tensor(xb).astype("bfloat16"),
                                 dtype="float32"),
                 lambda P: P.to_tensor(x32).sum(dtype="float16")):
        _same(_outcome(make, jp), _outcome(make, tp), "sum dtype")
    t = tp.sum(tp.to_tensor(x32), axis=1, dtype="int64").numpy()
    np.testing.assert_array_equal(t, np.trunc(x32.sum(1)).astype(np.int64))
    assert (t != x32.astype(np.int64).sum(1)).any()


def test_uint8_sum_is_a_recorded_divergence():
    """A uint8 sum is int64 in the port (torch has no uint64 sum) and
    uint64 in the JAX package; the values agree."""
    v = np.array([1, 2, 250], np.uint8)
    j, t = jp.sum(jp.to_tensor(v)), tp.sum(tp.to_tensor(v))
    assert (_name(j.dtype), _name(t.dtype)) == ("uint64", "int64")
    assert int(j) == int(t) == 253


# ----------------------------------------------------------------- F15
BOOL_OPS = {
    "mask // True": lambda P, m: m // True,
    "mod(mask, True)": lambda P, m: P.ops.mod(m, True),
    "mask ** 2": lambda P, m: m ** 2,
    "mask ** True": lambda P, m: m ** True,
    "mask ** mask": lambda P, m: m ** m,
    "mask @ mask": lambda P, m: m.reshape([1, 3]) @ m.reshape([3, 1]),
    "mask2 @ mask2": lambda P, m: P.to_tensor(
        np.array([[True, False], [False, False]])) @ P.to_tensor(
            np.array([[False, True], [True, True]])),
}


@pytest.mark.parametrize("case", sorted(BOOL_OPS))
def test_bool_operands_match_jax(case):
    """`//`, mod and `**` of a bool tensor by a bool or an int compute in
    int32, and a bool matmul is bool, as in the JAX package."""
    fn = BOOL_OPS[case]
    m = np.array([True, False, True])
    _same(_outcome(lambda P: fn(P, P.to_tensor(m)), jp),
          _outcome(lambda P: fn(P, P.to_tensor(m)), tp), case)


INT_FUNCTIONALS = {
    "gelu": lambda F, x: F.gelu(x),
    "gelu_tanh": lambda F, x: F.gelu(x, approximate=True),
    "log_softmax": lambda F, x: F.log_softmax(x),
    "layer_norm": lambda F, x: F.layer_norm(x, 3),
}


@pytest.mark.parametrize("dtype", ["int32", "int64", "bool"])
@pytest.mark.parametrize("name", sorted(INT_FUNCTIONALS))
def test_integer_inputs_of_float_functionals(name, dtype):
    """An integer or bool tensor into gelu, log_softmax or layer_norm
    computes in the default float dtype. int32 and bool give float32 in
    both packages; int64 gives float64 in the JAX package (x64), F7's
    divergence."""
    fn = INT_FUNCTIONALS[name]
    v = np.array([[1, 0, 3], [2, 2, 1]])
    out = {P: _outcome(lambda x: fn(P.nn.functional, x),
                       P.to_tensor(v).astype(dtype)) for P in (jp, tp)}
    j, t = out[jp], out[tp]
    if dtype == "int64":
        assert (j[1], t[1]) == ("float64", "float32")
        j = (j[0], "float32") + j[2:]
    _same(j, t, f"{name} {dtype}")


def test_uint8_log_softmax_is_a_recorded_divergence():
    """The JAX package's log_softmax of a uint8 tensor gives -inf (it
    computes in uint8); the port gives the float32 values."""
    v = np.array([1, 2, 3], np.uint8)
    j = jp.nn.functional.log_softmax(jp.to_tensor(v))
    t = tp.nn.functional.log_softmax(tp.to_tensor(v))
    assert np.isneginf(j.numpy()).all()
    ref = tp.nn.functional.log_softmax(tp.to_tensor(v.astype(np.float32)))
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), ref.numpy())


def test_setitem_records_the_gradient():
    """y = 2x; y[1:, ::-2] = v; loss = sum(y * w): x and v get JAX's
    gradients; y is a non-leaf with x's dtype; `_version` counts the
    write."""
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((3, 4)).astype(np.float32)
    v0 = rng.standard_normal((2, 2)).astype(np.float32)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = {}
    for P in (jp, tp):
        x = P.to_tensor(x0, stop_gradient=False)
        v = P.to_tensor(v0, stop_gradient=False)
        y = x * 2.0
        y[1:, ::-2] = v
        (y * P.to_tensor(w0)).sum().backward()
        assert y.dtype == x.dtype and y.shape == [3, 4]
        assert y._version == 1 and not y.stop_gradient
        grads[P] = (x.grad.numpy(), v.grad.numpy(), y.numpy())
    for a, b in zip(grads[tp], grads[jp]):
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("value", ["int", "float", "array"])
def test_setitem_keeps_the_dtype(value):
    """Writing an int, a float or an array into int32, bf16 and f32
    tensors: the tensor keeps its dtype, shape and (for a leaf) its
    stop_gradient state, as in JAX."""
    v = {"int": 3, "float": 2.75, "array": np.array([1.5, -2.5])}[value]
    for dtype in ("int32", "bfloat16", "float32"):
        out = {}
        for P in (jp, tp):
            t = P.to_tensor(np.arange(6).reshape(3, 2)).astype(dtype)
            t[1] = v
            t[-1, ::-1] = v
            assert t.stop_gradient and t._version == 2
            out[P] = (_name(t.dtype), t.shape, t.astype("float32").numpy())
        assert out[jp][:2] == out[tp][:2], (value, dtype)
        np.testing.assert_array_equal(out[tp][2], out[jp][2])


def test_setitem_on_a_parameter_without_grad_keeps_the_leaf():
    p = tp.Parameter(np.zeros(3, np.float32))
    with tp.no_grad():
        p[1] = 4.0
    assert p.is_leaf and not p.stop_gradient and p._data.requires_grad
    np.testing.assert_array_equal(p.numpy(), [0, 4, 0])


def test_clone_and_trainable():
    """clone copies and records (its gradient reaches the source);
    `trainable` starts as JAX's (True for a Parameter, False for a
    to_tensor) and in the port is tied to stop_gradient."""
    for P in (jp, tp):
        x = P.to_tensor(np.array([1.0, 2.0], np.float32),
                        stop_gradient=False)
        c = x.clone()
        assert not c.stop_gradient and c.dtype == x.dtype
        (c * c).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0])
        assert P.Parameter(np.ones(2, np.float32)).trainable
        assert not P.to_tensor(np.ones(2, np.float32)).trainable
    p = tp.Parameter(np.ones(2, np.float32))
    p.trainable = False
    assert p.stop_gradient and not p._data.requires_grad
    p.trainable = True
    assert not p.stop_gradient and p._data.requires_grad


# ------------------------------------------------------------------ F8
@pytest.mark.parametrize("pair", [("float32", "bfloat16"),
                                  ("float16", "bfloat16"),
                                  ("int64", "float32"), ("int32", "int64"),
                                  ("bfloat16", "float32")])
def test_matmul_and_linear_promote(pair):
    """x @ y, matmul(transpose_y) and F.linear over mixed dtypes give the
    promoted dtype and JAX's values."""
    rng = np.random.default_rng(8)
    a = rng.integers(-3, 4, (2, 3)).astype(np.float64)
    b = rng.integers(-3, 4, (3, 4)).astype(np.float64)
    res = {}
    for P in (jp, tp):
        x, y = P.to_tensor(a).astype(pair[0]), P.to_tensor(b).astype(pair[1])
        yt = P.to_tensor(b.T.copy()).astype(pair[1])
        outs = [x @ y, P.matmul(x, yt, transpose_y=True)]
        if all(d.startswith(("float", "bfloat")) for d in pair):
            outs.append(P.nn.functional.linear(x, y))
        res[P] = [(_name(o.dtype), o.shape, o.astype("float64").numpy())
                  for o in outs]
    for j, t in zip(res[jp], res[tp]):
        assert j[:2] == t[:2], (pair, j[:2], t[:2])
        np.testing.assert_array_equal(t[2], j[2])


def test_promotion_casts_nothing_of_one_dtype():
    """Operands already of one dtype (the auto_cast route) pass through
    unchanged: no cast is made."""
    a = torch.ones(2, 3, dtype=torch.bfloat16)
    b = torch.ones(3, 2, dtype=torch.bfloat16)
    pa, pb = tmath._promote(a, b)
    assert pa is a and pb is b
    with tp.amp.auto_cast(dtype="bfloat16"):
        out = tp.matmul(tp.to_tensor(np.ones((2, 3), np.float32)),
                        tp.to_tensor(np.ones((3, 2), np.float32)))
    assert out.dtype == torch.bfloat16


# ------------------------------------------------------------------ F9
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_p1_gives_zeros(dtype):
    for P in (jp, tp):
        x = P.to_tensor(np.ones((3, 4), np.float32)).astype(dtype)
        out = P.nn.functional.dropout(x, p=1.0)
        assert _name(out.dtype) == dtype and out.shape == [3, 4]
        assert not out.astype("float32").numpy().any()
        layer = P.nn.Dropout(1.0)
        assert not layer(x).astype("float32").numpy().any()
        with pytest.raises(ZeroDivisionError):
            P.nn.functional.dropout(x, p=1.0, axis=1)


# ----------------------------------------------------------------- F11
@pytest.mark.parametrize("index", ["::-1", ":, ::-2", "1::-1", "..., ::-1",
                                   "-1:0:-2, 1", "::-1, None, 2:"])
def test_negative_step_slicing_reverses(index):
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((4, 5)).astype(np.float32)
    idx = eval(f"np.s_[{index}]")          # noqa: S307 - a test literal
    out = {}
    for P in (jp, tp):
        x = P.to_tensor(x0, stop_gradient=False)
        y = x[idx]
        (y * y).sum().backward()
        out[P] = (y.shape, y.numpy(), x.grad.numpy())
    assert out[jp][0] == out[tp][0]
    np.testing.assert_array_equal(out[tp][1], out[jp][1])
    np.testing.assert_allclose(out[tp][2], out[jp][2], rtol=F32_TOL)
    np.testing.assert_array_equal(out[tp][1], x0[idx])


def test_squeeze_of_a_longer_axis_is_a_recorded_divergence():
    """squeeze(axis=k) where x.shape[k] > 1: the port returns x unchanged,
    as Paddle documents; the JAX package raises ValueError."""
    x = np.ones((2, 1, 3), np.float32)
    assert tp.squeeze(tp.to_tensor(x), axis=0).shape == [2, 1, 3]
    assert tp.squeeze(tp.to_tensor(x), axis=[0, 1]).shape == [2, 3]
    with pytest.raises(ValueError):
        jp.squeeze(jp.to_tensor(x), axis=0)
    assert jp.squeeze(jp.to_tensor(x), axis=1).shape == [2, 3]


# ----------------------------------------------------------------- F12
def test_init_params_argument_order_is_a_recorded_divergence():
    """The port's Llama, MoE and ERNIE init_params take (cfg, generator),
    DiT's (generator, cfg); the JAX package's all take (key, cfg)."""
    from paddle_tpu.mix import dit as jdit
    from paddle_tpu.nlp import ernie as jernie, llama as jllama, moe as jmoe
    from paddle_tpu_torch.mix import dit as tdit
    from paddle_tpu_torch.nlp import ernie as ternie, llama as tllama
    from paddle_tpu_torch.nlp import moe as tmoe

    def first_two(fn):
        return list(inspect.signature(fn).parameters)[:2]

    for j in (jllama, jmoe, jernie, jdit):
        assert first_two(j.init_params) == ["key", "cfg"]
    for t in (tllama, tmoe, ternie):
        assert first_two(t.init_params) == ["cfg", "generator"]
    assert first_two(tdit.init_params) == ["generator", "cfg"]


# -------------------------------------------------- max pools over bf16
@pytest.mark.parametrize("dims", [1, 2])
def test_bf16_max_pool_is_a_recorded_divergence(dims):
    """The port's max pools take bf16 (the f32 pool of the same values,
    which a max leaves exact); the JAX package's raise ValueError."""
    rng = np.random.default_rng(10)
    shape = (2, 3, 8) if dims == 1 else (2, 3, 8, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    name = f"max_pool{dims}d"
    tf = getattr(tp.nn.functional, name)
    out = tf(tp.to_tensor(x).astype("bfloat16"), 2)
    ref = tf(tp.to_tensor(x).astype("bfloat16").astype("float32"), 2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.astype("float32").numpy(),
                                  ref.numpy())
    jref = getattr(jp.nn.functional, name)(
        jp.to_tensor(x).astype("bfloat16").astype("float32"), 2)
    np.testing.assert_array_equal(ref.numpy(), jref.numpy())
    with pytest.raises(ValueError):
        getattr(jp.nn.functional, name)(jp.to_tensor(x).astype("bfloat16"),
                                        2)
