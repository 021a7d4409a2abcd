"""The port's fused adaLN (kernels/adaln.py) against the JAX package, on
the CPU.

On a CPU tensor `adaln_fwd` and `adaln_bwd` run their plain versions, so
these tests pin the arithmetic the CUDA kernels of `csrc/adaln.cu` are
held to on the card (`chip_smoke.py`): the same numpy inputs go through
the JAX Pallas kernels in interpret mode (`_adaln_fwd_pallas`,
`_adaln_bwd_pallas`, and `adaln_modulate` under FLAGS_pallas_interpret,
as tests/test_rms_norm.py runs it) and the port's plain versions.

Tolerances: in f32 the two sides differ only in summation order (a row of
128 values; the per-sample sums over 64 tokens), so values of O(1) agree
to 1e-5 and the sums and second derivatives to 1e-4. bf16 outputs are the
same f32 values rounded once to bf16: within one bf16 ulp (2^-8
relative), held at 8e-3.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags as jflags  # noqa: E402
from paddle_tpu.kernels import adaln as jad  # noqa: E402

from paddle_tpu_torch.kernels import adaln as tad  # noqa: E402

TOL = 1e-5
SUM_TOL = 1e-4
BF16_TOL = 8e-3
EPS = 1e-6


def _inputs(dtype, B=2, N=64, D=128, seed=0):
    """x [B, N, D] (N(0.5, 2)), shift/scale [B, D] f32 (0.1 N(0, 1)), dy
    like x; the same rounded values on both sides."""
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.standard_normal((B, N, D)) + 0.5
    dy = rng.standard_normal((B, N, D))
    sh = (0.1 * rng.standard_normal((B, D))).astype(np.float32)
    sc = (0.1 * rng.standard_normal((B, D))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    dyt = torch.from_numpy(np.array(dyj.astype(jnp.float32))).to(tdt)
    return ((xj, jnp.asarray(sh), jnp.asarray(sc), dyj),
            (xt, torch.from_numpy(sh), torch.from_numpy(sc), dyt))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@contextlib.contextmanager
def _interpret():
    prev = jflags.get_flags("FLAGS_pallas_interpret")
    jflags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        yield
    finally:
        jflags.set_flags(prev)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fwd_and_bwd_match_pallas(dtype):
    """Rows 11 and 12: the plain versions against the Pallas kernels in
    interpret mode: out, mu, rstd; dx, dshift, dscale."""
    (xj, shj, scj, dyj), (xt, sht, sct, dyt) = _inputs(dtype)
    out_j, mu_j, r_j = jad._adaln_fwd_pallas(xj, shj, scj, EPS,
                                             interpret=True)
    out_t, mu_t, r_t = tad.adaln_fwd(xt, sht, sct, EPS)
    assert out_t.dtype == xt.dtype and mu_t.shape == (2, 64, 1)
    tol = BF16_TOL if dtype == "bf16" else TOL
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=tol, atol=tol)
    for a, b in ((mu_t, mu_j), (r_t, r_j)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)
    dx_j, dsh_j, dsc_j = jad._adaln_bwd_pallas(xj, scj, mu_j, r_j, dyj,
                                               interpret=True)
    dx_t, dsh_t, dsc_t = tad.adaln_bwd(xt, sct, mu_t, r_t, dyt)
    assert dx_t.dtype == xt.dtype and dsh_t.dtype == torch.float32
    np.testing.assert_allclose(_np(dx_t), _np(dx_j), rtol=tol, atol=tol)
    for a, b in ((dsh_t, dsh_j), (dsc_t, dsc_j)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=SUM_TOL,
                                   atol=SUM_TOL * np.abs(_np(b)).max())
    # the plain twins agree with the kernels' plain versions
    ref_dx, ref_dsh, ref_dsc = tad._adaln_ref_bwd(xt, sct, dyt, EPS)
    np.testing.assert_allclose(_np(ref_dx), _np(dx_t), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tad.adaln_ref(xt, sht, sct, EPS)),
                               _np(out_t), rtol=tol, atol=tol)


def test_modulate_value_and_grads_match_jax():
    """adaln_modulate's value and its dx, dshift, dscale for sum(y²),
    against the JAX custom_vjp running its Pallas kernels."""
    (xj, shj, scj, _), (xt, sht, sct, _) = _inputs("f32", seed=1)

    with _interpret():
        vj, gj = jax.value_and_grad(
            lambda a, b, c: jnp.sum(jad.adaln_modulate(a, b, c) ** 2),
            (0, 1, 2))(xj, shj, scj)
    ts = [t.clone().requires_grad_(True) for t in (xt, sht, sct)]
    vt = (tad.adaln_modulate(*ts) ** 2).sum()
    gt = torch.autograd.grad(vt, ts)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=TOL)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(_np(a), _np(b), rtol=SUM_TOL,
                                   atol=SUM_TOL * np.abs(_np(b)).max())


def test_modulate_double_grad_matches_jax():
    """The HVP of sum(y²) in x, as tests/test_rms_norm.py's
    test_double_grad takes it but along a random direction (along ones it
    cancels to ~1e-7: the norm ignores a constant shift of x): the
    backward's own gradient (the vjp of the plain twin) against JAX's
    `_adaln_bwd_diffable`."""
    (xj, shj, scj, dyj), (xt, sht, sct, dyt) = _inputs("f32", seed=2, N=128)
    v = dyj

    def g(a):
        return jax.grad(lambda a_: jnp.sum(
            jad.adaln_modulate(a_, shj, scj) ** 2))(a)

    with _interpret():
        hvp_j = jax.grad(lambda a: jnp.vdot(g(a), v))(xj)
    x = xt.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((tad.adaln_modulate(x, sht, sct) ** 2).sum(),
                                x, create_graph=True)
    (hvp_t,) = torch.autograd.grad((gx * dyt).sum(), x)
    np.testing.assert_allclose(_np(hvp_t), _np(hvp_j), rtol=SUM_TOL,
                               atol=SUM_TOL * np.abs(_np(hvp_j)).max())


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    """On the CPU the wrappers never reach the kernel; the checks they run
    on a CUDA tensor are plain Python: a width that is not a multiple of
    4, or wider than 1536, is refused before any launch."""
    for D in (6, 1540):
        x = torch.zeros(1, 2, D)
        with pytest.raises(ValueError):
            tad._check(x, "adaln_fwd")
    assert tad._check(torch.zeros(1, 2, 1152), "adaln_fwd") == (1, 2, 1152)
