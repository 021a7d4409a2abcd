"""The f16 and f32 options of the training kernels' plain versions against
the JAX package, on the CPU.

On a CPU tensor `rms_norm_fwd` and `rms_norm_bwd` (rows 7-8 of PERF.md's
kernel table) run their plain versions, which the CUDA kernels are held
to on the card (`chip_smoke.py`'s kernels phase); here the same numpy
inputs go through the JAX package's Pallas kernels `_rms_fwd_pallas` and
`_rms_bwd_pallas` in interpret mode. The JAX kernels write out and dx in
x's dtype, rstd in f32 and dw in the weight's dtype; so must the port.

Tolerances. f32: the two sides compute the same f32 expressions in
another summation order (a 256-value row, a 37-row column sum): 1e-5 of
each row's (or dw's) largest value. f16: both sides compute in f32 and
round out and dx to f16 once, so an element may land one f16 ulp apart
(2^-10 of its binade's top): 1e-3 of the row's largest value.

The trainer at `LlamaConfig(dtype=float16)` (f32 parameters and moments,
f16 compute: rows 1-5 and 7-8 in f16 on the card) takes three
`make_train_step` steps beside the JAX package's. Each side rounds its
activations to f16 at its own points (the matmuls' outputs, the norms'
and attention's outputs), about 2^-11 relative each, so the losses
agree to 1e-3 relative (a 5.58 loss read 5.580894 here against
5.580866 in JAX) and the grad norms to 1e-2 relative; the parameters,
updated from f32 moments by lr 1e-3 steps, agree to 1e-4 save the
elements whose Adam direction the f16 noise decides (at most 1 % of a
leaf, none by more than twice the learning rates taken).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import rms_norm as jrms  # noqa: E402
from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import train as jtrain  # noqa: E402

from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import train as ttrain  # noqa: E402

ROWS, D, EPS = 37, 256, 1e-5          # an odd row count: JAX pads to 256
_TOLS = {np.float32: 1e-5, np.float16: 1e-3}
_TORCH = {np.float32: torch.float32, np.float16: torch.float16}


def _rows_close(a, b, tol, what):
    """Each row of a within tol of that row's largest |b|."""
    a = np.asarray(a, np.float32).reshape(-1, np.shape(b)[-1])
    b = np.asarray(b, np.float32).reshape(a.shape)
    scale = np.maximum(np.abs(b).max(-1), 1e-30)
    err = (np.abs(a - b).max(-1) / scale).max()
    assert err <= tol, (what, err)


def _inputs(x_dt, w_dt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((ROWS, D)) + 0.3).astype(x_dt)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(w_dt)
    dy = rng.standard_normal((ROWS, D)).astype(x_dt)
    return x, w, dy


@pytest.mark.parametrize("x_dt,w_dt", [(np.float32, np.float32),
                                       (np.float16, np.float16),
                                       (np.float16, np.float32)],
                         ids=["f32", "f16", "f16_w32"])
def test_rms_train_plain_matches_pallas_interpret(x_dt, w_dt):
    """Rows 7-8's plain versions in f32 and f16 (an f16 x with an f16 or
    an f32 weight) == `_rms_fwd_pallas` and `_rms_bwd_pallas` in
    interpret mode: out and dx in x's dtype, rstd f32 [rows, 1], dw in
    the weight's dtype, at an odd row count."""
    x, w, dy = _inputs(x_dt, w_dt)
    jout, jrstd = jrms._rms_fwd_pallas(jnp.asarray(x), jnp.asarray(w), EPS,
                                       interpret=True)
    jdx, jdw = jrms._rms_bwd_pallas(jnp.asarray(x), jnp.asarray(w), jrstd,
                                    jnp.asarray(dy), interpret=True)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    out, rstd = trms.rms_norm_fwd(tx, tw, EPS)
    dx, dw = trms.rms_norm_bwd(tx, tw, rstd, tdy, EPS)
    tol = _TOLS[x_dt]
    assert out.dtype == dx.dtype == _TORCH[x_dt] == tx.dtype
    assert jout.dtype == jdx.dtype == x_dt
    assert rstd.dtype == torch.float32 and jrstd.dtype == jnp.float32
    assert dw.dtype == _TORCH[w_dt] and jdw.dtype == w_dt
    assert out.shape == dx.shape == jout.shape == (ROWS, D)
    assert tuple(rstd.shape) == jrstd.shape == (ROWS, 1)
    assert tuple(dw.shape) == jdw.shape == (D,)
    _rows_close(out.numpy(), np.asarray(jout), tol, "out")
    _rows_close(dx.numpy(), np.asarray(jdx), tol, "dx")
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-5)
    # dw: a sum over the rows, rounded once to the weight's dtype
    _rows_close(dw.numpy()[None], np.asarray(jdw)[None], _TOLS[w_dt], "dw")


@pytest.mark.parametrize("x_dt,w_dt,kept", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.float16, torch.float16, torch.float16),
    (torch.float16, torch.float32, torch.float32),
    (torch.float16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float16, torch.float32)])
def test_rms_kernel_weight_dtype(x_dt, w_dt, kept):
    """The training kernels read a weight in x's dtype or in f32 as it
    is, and any other dtype cast to f32 first; the backward's resident
    query names each (x, weight) pair the kernels instantiate."""
    x = torch.zeros(2, 16, dtype=x_dt)
    w = trms._kernel_weight(torch.ones(16, dtype=w_dt), x)
    assert w.dtype == kept
    assert (x.dtype, w.dtype == x.dtype) in trms._BWD_KINDS


# ------------------------------------------------ the f16 trainer
B, S, LR = 2, 16, 1e-3
LR_SUM_3 = 1.5e-3      # warm-up over 2 steps from 0: lr 0, 5e-4, ~1e-3


def _flat(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    return [("", tree)]


def test_train_steps_f16_match_jax():
    """Three `make_train_step` steps of the tiny Llama at dtype=float16
    (f32 parameters, AdamW with f32 moments, clip 1.0): losses, grad
    norms and parameters against the JAX package's (module docstring)."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float16,
                                   param_dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float16,
                                   param_dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tok = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    kw = dict(learning_rate=LR, warmup_steps=2, total_steps=10)
    jtx, ttx = jtrain.make_optimizer(**kw), ttrain.make_optimizer(**kw)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp))
    jstep = jtrain.make_train_step(jcfg, jtx, donate=False)
    tp = tllama.params_from_numpy(tree, tcfg, device="cpu", training=True)
    tstate = ttrain.TrainState(torch.zeros((), dtype=torch.int32), tp,
                               ttx.init(tp))
    tstep = ttrain.make_train_step(tcfg, ttx, device="cpu")
    jm, tm = [], []
    for _ in range(3):
        jstate, m = jstep(jstate, jnp.asarray(tok))
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, torch.from_numpy(tok))
        tm.append({k: float(v) for k, v in m.items()})
    for a, b in zip(tm, jm):
        assert np.isfinite(a["loss"]) and np.isfinite(a["grad_norm"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-3)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-2)
    for (path, t), (_, j) in zip(_flat(tstate.params), _flat(jstate.params)):
        assert t.dtype == torch.float32 and j.dtype == jnp.float32, path
        assert tuple(t.shape) == j.shape, path
        d = np.abs(t.numpy() - np.asarray(j))
        assert np.mean(d > 1e-4) <= 1e-2, (path, np.mean(d > 1e-4))
        assert d.max() <= 2 * LR_SUM_3, (path, d.max())
