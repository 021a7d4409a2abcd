"""The port's fused LayerNorm (kernels/layer_norm.py) against the JAX
package, on the CPU.

On a CPU tensor `layer_norm_fwd` and `layer_norm_bwd` run their plain
versions, so these tests pin the arithmetic the CUDA kernels of
`csrc/layer_norm.cu` are held to on the card (`chip_smoke.py`): the same
numpy inputs go through the JAX Pallas kernels in interpret mode
(`_ln_fwd_pallas`, `_ln_bwd_pallas`) and the port's plain versions.

Tolerances: in f32 the two sides differ only in summation order (the
Pallas interpret kernel reduces a block of rows at a time, torch one row
at a time), so values of O(1) agree to 1e-5 and row sums (dw, db) over
300 rows to 1e-4. bf16 outputs are the same f32 values rounded once to
bf16: they agree within one bf16 ulp (2^-8 relative), held at 8e-3.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags as jflags  # noqa: E402
from paddle_tpu.kernels import layer_norm as jln  # noqa: E402

import paddle_tpu_torch  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as tln  # noqa: E402

TOL = 1e-5
SUM_TOL = 1e-4
BF16_TOL = 8e-3
EPS = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current_place = prev


def _inputs(dtype, affine, rows=300, d=128, seed=0):
    """x [3, rows / 3, d] (300 rows: not a multiple of the Pallas block of
    256), w/b [d] f32 or None, dy like x."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((3, rows // 3, d)) + 0.5)
    dy = rng.standard_normal(x.shape)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) \
        if affine else None
    b = (0.1 * rng.standard_normal(d)).astype(np.float32) if affine else None
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    # the same (rounded) values on both sides
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    dyt = torch.from_numpy(np.array(dyj.astype(jnp.float32))).to(tdt)
    wj = None if w is None else jnp.asarray(w)
    bj = None if b is None else jnp.asarray(b)
    wt = None if w is None else torch.from_numpy(w)
    bt = None if b is None else torch.from_numpy(b)
    return (xj, wj, bj, dyj), (xt, wt, bt, dyt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fwd_matches_pallas(dtype, affine):
    (xj, wj, bj, _), (xt, wt, bt, _) = _inputs(dtype, affine)
    out_j, mu_j, r_j = jln._ln_fwd_pallas(xj, wj, bj, EPS, affine,
                                          interpret=True)
    out_t, mu_t, r_t = tln.layer_norm_fwd(xt, wt, bt, EPS)
    assert out_t.dtype == xt.dtype and out_t.shape == xt.shape
    assert mu_t.shape == (300, 1) and r_t.dtype == torch.float32
    tol = BF16_TOL if dtype == "bf16" else TOL
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(mu_t), _np(mu_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(r_t), _np(r_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bwd_matches_pallas(dtype, affine):
    (xj, wj, bj, dyj), (xt, wt, bt, dyt) = _inputs(dtype, affine, seed=1)
    _, mu_j, r_j = jln._ln_fwd_pallas(xj, wj, bj, EPS, affine,
                                      interpret=True)
    dx_j, dw_j, db_j = jln._ln_bwd_pallas(xj, wj, mu_j, r_j, dyj, affine,
                                          interpret=True)
    _, mu_t, r_t = tln.layer_norm_fwd(xt, wt, bt, EPS)
    dx_t, dw_t, db_t = tln.layer_norm_bwd(xt, wt, mu_t, r_t, dyt, EPS)
    assert dx_t.dtype == xt.dtype and dw_t.dtype == torch.float32
    tol = BF16_TOL if dtype == "bf16" else TOL
    np.testing.assert_allclose(_np(dx_t), _np(dx_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(dw_t), _np(dw_j), rtol=SUM_TOL,
                               atol=SUM_TOL)
    np.testing.assert_allclose(_np(db_t), _np(db_j), rtol=SUM_TOL,
                               atol=SUM_TOL)


@contextlib.contextmanager
def _interpret():
    """FLAGS_pallas_interpret on, and back to its previous value after."""
    prev = jflags.get_flags("FLAGS_pallas_interpret")
    jflags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        yield
    finally:
        jflags.set_flags(prev)


@pytest.mark.parametrize("affine", [True, False])
def test_train_grads_match_jax(affine):
    """The values and the grads of sum(sin(layer_norm_train(...))) against
    the JAX custom_vjp running its Pallas kernels (interpret mode), in the
    manner of tests/test_rms_norm.py::TestLayerNormTrain."""
    rng = np.random.default_rng(2)
    x = (2.0 * rng.standard_normal((4, 6, 256))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    ws = (w, b) if affine else (None, None)
    with _interpret():
        def loss_j(x, w, b):
            return jnp.sum(jnp.sin(jln.layer_norm_train(x, w, b, 1e-5,
                                                        True)))

        out_j = jln.layer_norm_train(jnp.asarray(x), *[
            None if a is None else jnp.asarray(a) for a in ws], 1e-5, True)
        argn = (0, 1, 2) if affine else (0,)
        g_j = jax.grad(loss_j, argnums=argn)(
            jnp.asarray(x), *[None if a is None else jnp.asarray(a)
                              for a in ws])
    xt = torch.from_numpy(x).requires_grad_(True)
    wt, bt = [None if a is None else torch.from_numpy(a).requires_grad_(True)
              for a in ws]
    out_t = tln.layer_norm_train(xt, wt, bt, 1e-5)
    leaves = [xt, wt, bt] if affine else [xt]
    g_t = torch.autograd.grad(torch.sum(torch.sin(out_t)), leaves)
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=TOL, atol=TOL)
    for a, r in zip(g_t, g_j):
        np.testing.assert_allclose(_np(a), _np(r), rtol=SUM_TOL,
                                   atol=SUM_TOL)


def test_hvp_matches_jax():
    """A Hessian-vector product through layer_norm_train: its backward is
    differentiable (the second-order rule is the plain twin's vjp), as
    in tests/test_rms_norm.py::test_ln_hvp_matches_ref."""
    x = np.random.RandomState(3).randn(8, 128).astype(np.float32)
    w = np.random.RandomState(4).rand(128).astype(np.float32)
    b = np.random.RandomState(5).randn(128).astype(np.float32)
    v = np.random.RandomState(6).randn(8, 128).astype(np.float32)
    wj, bj, vj = jnp.asarray(w), jnp.asarray(b), jnp.asarray(v)
    with _interpret():
        g = jax.grad(lambda a: jnp.sum(
            jln.layer_norm_train(a, wj, bj, 1e-5, True) ** 2))
        hvp_j = jax.grad(lambda a: jnp.vdot(g(a), vj))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt, bt, vt = (torch.from_numpy(a) for a in (w, b, v))
    out = tln.layer_norm_train(xt, wt, bt, 1e-5)
    (gx,) = torch.autograd.grad(torch.sum(out ** 2), xt, create_graph=True)
    (hvp_t,) = torch.autograd.grad(torch.sum(gx * vt), xt)
    np.testing.assert_allclose(_np(hvp_t), _np(hvp_j), rtol=SUM_TOL,
                               atol=SUM_TOL)


def test_fused_layer_norm_eager_matches_jax():
    """incubate.nn.functional.fused_layer_norm through both eager APIs:
    the output, and the grads of x, weight and bias from backward()."""
    import paddle_tpu as jp
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    c = rng.standard_normal((2, 5, 64)).astype(np.float32)
    res = {}
    for name, pkg in (("jax", jp), ("torch", paddle_tpu_torch)):
        xs, ws, bs = (pkg.to_tensor(a, stop_gradient=False)
                      for a in (x, w, b))
        out = pkg.incubate.nn.functional.fused_layer_norm(xs, ws, bs,
                                                          epsilon=1e-5)
        (out * pkg.to_tensor(c)).sum().backward()
        res[name] = [out.numpy()] + [t.grad.numpy() for t in (xs, ws, bs)]
    for a, r in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), rtol=TOL,
                                   atol=TOL)


def test_wrappers_refuse_what_the_kernel_cannot_take():
    """The kernel's shape limits, held by the same checks the wrappers
    make before a launch (on a CPU tensor the plain version takes any
    shape, so the checks are called directly)."""
    for d, ok in ((768, True), (8192, True), (12, False), (8200, False)):
        x = torch.zeros(2, d)
        if ok:
            assert tln._check_rows(x, "t") == d
        else:
            with pytest.raises(ValueError):
                tln._check_rows(x, "t")
    # f32, bf16 and f16 rows are the kernels' (f16 since the O2 option);
    # f64 is not
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert tln._check_rows(torch.zeros(2, 16, dtype=dt), "t") == 16
    with pytest.raises(TypeError):
        tln._check_rows(torch.zeros(2, 16, dtype=torch.float64), "t")
    # a contiguous view one element into its storage: 4 bytes off
    x = torch.zeros(2, 16)
    odd = torch.zeros(33)[1:].view(2, 16)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(TypeError):
        tln._check_rows(odd, "t")
    with pytest.raises(TypeError):
        tln._check_dy(x, odd, "t")
    with pytest.raises(ValueError):
        tln._check_dy(x, torch.zeros(2, 8), "t")
    assert tln._check_dy(x, torch.zeros(16, 2).t(), "t").is_contiguous()
