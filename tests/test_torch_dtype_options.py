"""The f16 and f32 options of the kernels' plain versions against the JAX
package, on the CPU.

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

Rows 14, 15, 17 and 18 (the MoE dispatch gathers, the fused 8-bit AdamW
and ragged paged attention) take f16 and f32 on the card too; here
their plain versions meet the JAX Pallas kernels in interpret mode on
the same numpy inputs (f32 of rows 14-15 and 17:
tests/test_torch_moe_kernels.py, tests/test_torch_train_kernels.py).
Both sides compute in f32 and round once to the rows' dtype: the f16
gathers agree to one f16 ulp of each element (XLA may contract the
k-sum's multiply-adds, the port's plain version does not), the scale-dot
products bit for bit and its f32 dots to 1e-5; the f16 AdamW's p to one
f16 ulp and its codes to one e4m3 step; ragged attention in f16 to one
f16 ulp of each output vector's scale, in f32 to 1e-5 of it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import moe_dispatch as jmd  # noqa: E402
from paddle_tpu.kernels import rms_norm as jrms  # noqa: E402
from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import ragged_attention as jra  # noqa: E402
from paddle_tpu.nlp import train as jtrain  # noqa: E402
from paddle_tpu.optimizer import quant_state as jqs  # noqa: E402

from paddle_tpu_torch.kernels import moe_dispatch as tmd  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import ragged_attention as tra  # noqa: E402
from paddle_tpu_torch.nlp import train as ttrain  # noqa: E402
from paddle_tpu_torch.optimizer import quant_state as tqs  # noqa: E402

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


@pytest.mark.parametrize("row,x_dt,w_dt,kept", [
    (7, torch.float32, torch.float32, torch.float32),
    (7, torch.float32, torch.bfloat16, torch.float32),
    (7, torch.float16, torch.float16, torch.float16),
    (7, torch.float16, torch.float32, torch.float32),
    (7, torch.float16, torch.bfloat16, torch.float32),
    (7, torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (7, torch.bfloat16, torch.float16, torch.float32),
    (6, torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (6, torch.bfloat16, torch.float32, torch.float32),
    (6, torch.float16, torch.bfloat16, torch.float32),
    (6, torch.float32, None, None),
    (6, torch.bfloat16, None, None),
    (6, torch.float16, None, None)])
def test_rms_kernel_weight_dtype(row, x_dt, w_dt, kept):
    """The RMSNorm kernels (rows 6-8) read a weight in x's dtype or in
    f32 as it is, and any other dtype cast to f32 first; row 6 also takes
    none (affine-free). A weight kept as it is is passed without a copy
    (an O2 bf16 weight costs no cast a call); the backward's resident
    query names each (x, weight) pair the kernels instantiate."""
    x = torch.zeros(2, 16, dtype=x_dt)
    weight = None if w_dt is None else torch.ones(16, dtype=w_dt)
    pick = trms._fused_weight if row == 6 else trms._kernel_weight
    w = pick(weight, x)
    if kept is None:
        assert w is None
        return
    assert w.dtype == kept
    assert (w is weight) == (kept == w_dt)
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


# ------------------------------------------ rows 14, 15, 17 and 18
def _f16_ulps(a, b):
    """The largest |a - b| in f16 ulps of the larger magnitude (at least
    the subnormal spacing 2^-24)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.maximum(2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -30)))
                             - 10), 2.0 ** -24)
    return float((np.abs(a - b) / ulp).max())


def test_moe_gathers_f16_plain_match_pallas_interpret():
    """Rows 14-15 in f16: gather_wsum (k = 2, dropped choices at weight
    0) and gather_scale_dot's plain versions against
    `gather_wsum_pallas` / `gather_scale_dot_pallas(interpret=True)`: out
    in f16 (one rounding of f32 sums), dot in f32."""
    rng = np.random.RandomState(2)
    B, N, M, D, k = 1, 10, 12, 128, 2
    src = rng.randn(B, N, D).astype(np.float16)
    idx = rng.randint(0, N, (B, M, k)).astype(np.int32)
    w = (rng.rand(B, M, k) * (rng.rand(B, M, k) > 0.2)).astype(np.float32)
    ref = jmd.gather_wsum_pallas(jnp.asarray(src), jnp.asarray(idx),
                                 jnp.asarray(w), interpret=True)
    out = tmd.gather_wsum(*(torch.from_numpy(a) for a in (src, idx, w)))
    assert out.dtype == torch.float16 and ref.dtype == jnp.float16
    assert _f16_ulps(out.numpy(), ref) <= 1.0
    scale = rng.rand(B, M).astype(np.float32)
    other = rng.randn(B, M, D).astype(np.float16)
    jout, jdot = jmd.gather_scale_dot_pallas(
        jnp.asarray(src), jnp.asarray(idx[..., 0]), jnp.asarray(scale),
        jnp.asarray(other), interpret=True)
    tout, tdot = tmd.gather_scale_dot(*(torch.from_numpy(a) for a in (
        src, idx[..., 0], scale, other)))
    assert tout.dtype == torch.float16 and tdot.dtype == torch.float32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_allclose(tdot.numpy(), np.asarray(jdot), rtol=1e-5,
                               atol=1e-5)


def _jq_to_t(q):
    return tqs._QTensor(
        torch.from_numpy(np.array(q.codes.astype(jnp.float32))).to(tqs.F8),
        torch.from_numpy(np.array(q.scale)))


def test_fused_adamw_f16_leaf_matches_pallas_interpret():
    """Row 17 over an f16 leaf (g and p f16, the moments' codes and f32
    scales): two steps of the plain version against
    `_fused_leaf_update(interpret=True)` on a padded [3, 100] leaf; p
    stays f16, within one f16 ulp, the codes within one e4m3 step."""
    rng = np.random.RandomState(0)
    shape = (3, 100)
    p = (0.02 * rng.randn(*shape)).astype(np.float16)
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    jm = jqs._quantize(jnp.asarray(1e-2 * rng.randn(*shape), jnp.float32),
                       False)
    jv = jqs._quantize(jnp.asarray(1e-4 * rng.rand(*shape), jnp.float32),
                       True)
    tm, tv = _jq_to_t(jm), _jq_to_t(jv)
    jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    for step in (1, 2):
        g = rng.randn(*shape).astype(np.float16)
        sc = np.array([0.7, 1e-3, 1 - 0.9 ** step, 1 - 0.95 ** step],
                      np.float32)
        jp, jm, jv = jqs._fused_leaf_update(
            jnp.asarray(sc), jnp.asarray(g), jp, jm, jv, interpret=True,
            **hp)
        tp, tm, tv = tqs.fused_leaf_update(torch.from_numpy(sc),
                                           torch.from_numpy(g), tp, tm, tv,
                                           **hp)
        assert tp.dtype == torch.float16 and jp.dtype == jnp.float16
        assert _f16_ulps(tp.numpy(), jp) <= 1.0, step
        for tq, jq in ((tm, jm), (tv, jv)):
            tc = tq.codes.float().numpy()
            jc = np.asarray(jq.codes.astype(jnp.float32))
            step8 = 2.0 ** (np.floor(np.log2(np.maximum(
                np.maximum(np.abs(tc), np.abs(jc)), 2.0 ** -6))) - 3)
            assert np.all(np.abs(tc - jc) <= step8)
            np.testing.assert_allclose(tq.scale.numpy(),
                                       np.asarray(jq.scale), rtol=1e-6)


def _ragged_batch(rng, dt, q8, S, R=3, P=2, H=4, KV=2, hd=16, M=4, bs=4,
                  lengths=(13, 1, 6)):
    """Rows of P queries ending at lengths[r] - 1, distinct chains, q and
    the pools (or their int8 codes, one f32 scale a block, block 0 never
    written) and a slab of S rows in `dt`."""
    N = R * M + 3
    pos = np.zeros((R, P), np.int32)
    val = np.zeros((R, P), np.bool_)
    for r, L in enumerate(lengths):
        j = L - P + np.arange(P)
        pos[r] = np.clip(j, 0, M * bs - 1)
        val[r] = (j >= 0) & (L > 0)
    table = rng.permutation(N)[:R * M].reshape(R, M).astype(np.int32)
    q = rng.randn(R, P, H, hd).astype(dt)
    kp, vp = (rng.randn(N, bs, KV, hd).astype(np.float32) for _ in range(2))
    opts = {}
    if q8:
        pools = []
        for x in (kp, vp):
            sc = (np.abs(x).max(axis=(1, 2, 3)) / 127.0).astype(np.float32)
            sc[0] = 0.0
            codes = np.clip(np.round(x / np.where(sc > 0, sc, 1.0)
                                     [:, None, None, None]), -127, 127)
            codes[0] = 0
            pools.append((codes.astype(np.int8), sc))
        (kp, opts["k_scale"]), (vp, opts["v_scale"]) = pools
    else:
        kp, vp = kp.astype(dt), vp.astype(dt)
    if S:
        opts["suffix_k"] = rng.randn(R, S, KV, hd).astype(dt)
        opts["suffix_v"] = rng.randn(R, S, KV, hd).astype(dt)
        opts["suffix_vis"] = rng.rand(R, P, S) < 0.5
    return (q, kp, vp, table, pos, val), opts


@pytest.mark.parametrize("dt,q8,S", [(np.float16, False, 0),
                                     (np.float16, True, 4),
                                     (np.float32, False, 4),
                                     (np.float32, True, 0)],
                         ids=["f16_fp", "f16_int8_slab", "f32_fp_slab",
                              "f32_int8"])
def test_ragged_dtypes_match_pallas_interpret(dt, q8, S):
    """Row 18 in f16 and f32, over fp and int8 pools and with the slab:
    the plain version (the CPU wrapper) against `ragged_paged_attention(
    interpret=True)`, out in q's dtype, invalid queries zero."""
    arrays, opts = _ragged_batch(np.random.RandomState(0), dt, q8, S)
    targs = [torch.from_numpy(a) for a in arrays]
    topts = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in opts.items()}
    got = tra.ragged_paged_attention(*targs, **topts)
    pallas = np.asarray(jra.ragged_paged_attention(
        *(jnp.asarray(a) for a in arrays), interpret=True,
        **{k: jnp.asarray(v) for k, v in opts.items()}))
    assert got.dtype == _TORCH[dt] and pallas.dtype == dt
    g, p = got.numpy().astype(np.float32), pallas.astype(np.float32)
    val = arrays[5]
    assert not g[~val].any()
    scale = np.maximum(np.abs(p).max(-1), 1e-30)
    err = (np.abs(g - p).max(-1) / scale)[val].max()
    assert err <= (2.0 ** -10 if dt == np.float16 else 1e-5), err
