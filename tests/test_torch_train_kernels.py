"""The training kernels' plain versions against the JAX package, on the CPU.

On a CPU tensor each wrapper of the port's training path
(`flash_attention_fwd(return_lse=True)`, `flash_attention_bwd`,
`rms_norm_fwd`, `rms_norm_bwd`, `fused_leaf_update`) runs its plain
PyTorch version, so these tests pin the arithmetic that the CUDA kernels
are held to on the card (`chip_smoke.py`): the same numpy inputs go
through the JAX Pallas kernels (interpret mode off-TPU) and the port.

Tolerances: float32 throughout; the two sides differ in summation order
only (blockwise online softmax and per-block reductions in interpret
mode, one pass in the plain versions), so O(1) values agree to 2e-5 and
gradients, whose sums run over up to 256 keys, to 5e-5. The 8-bit AdamW
is held as the kernel is on the card: params to 1e-6, decoded moments to
one float8 step of their block, and at most 0.1 % of codes different (a
value within an ulp of a float8 rounding boundary may round either way
when two f32 computations differ in their last bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags  # noqa: E402
from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu.kernels import rms_norm as jrms  # noqa: E402
from paddle_tpu.optimizer import quant_state as jqs  # noqa: E402

from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402
from paddle_tpu_torch.optimizer import quant_state as tqs  # noqa: E402
from paddle_tpu_torch.optimizer import transform  # noqa: E402

TOL = 2e-5
GRAD_TOL = 5e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- flash
B, H, KV, HD = 2, 4, 2, 32


def _qkv(seed, S):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, HD).astype(np.float32)
    k = rng.randn(B, S, KV, HD).astype(np.float32)
    v = rng.randn(B, S, KV, HD).astype(np.float32)
    do = rng.randn(B, S, H, HD).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("S", [128, 256])
def test_flash_lse_matches_pallas_interpret(S):
    """The forward's plain (out, lse) == JAX's Pallas forward with
    return_lse (interpret mode): the LSE in the scaled-score domain."""
    q, k, v, _ = _qkv(S, S)
    jout, jlse = jfa.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True, return_lse=True)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True,
                                       return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S", [128, 256])
def test_flash_bwd_plain_matches_pallas_interpret(S):
    """dq, dk, dv of the plain backward == JAX's Pallas backward
    (interpret mode, 128-blocks; GQA H=4/KV=2 summed over the group),
    both from the same forward output and LSE."""
    q, k, v, do = _qkv(S + 1, S)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = jfa.flash_attention_pallas(jq, jk, jv, causal=True,
                                            interpret=True, return_lse=True)
    ref = jfa.flash_attention_pallas_bwd(jq, jk, jv, jout, jlse, jdo,
                                         causal=True, interpret=True,
                                         block_q=128, block_k=128)
    got = tfa.flash_attention_bwd(_t(q), _t(k), _t(v),
                                  _t(np.asarray(jout)), _t(np.asarray(jlse)),
                                  _t(do), causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_flash_autograd_matches_jax_vjp():
    """The differentiable entry's gradients == jax.vjp of JAX's
    flash_attention_fwd (the exact path off-TPU), Sq < Sk included via a
    ragged length."""
    q, k, v, do = _qkv(7, 40)
    jgrads = jax.vjp(lambda a, b, c: jfa.flash_attention_fwd(a, b, c, True),
                     *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, True, None)
    out.backward(_t(do))
    for a, b in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_flash_bwd_cpu_counts_no_launch():
    q, k, v, do = _qkv(3, 64)
    n0 = (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), return_lse=True)
    tfa.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(do))
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches) == n0


# -------------------------------------------------------------- rms norm
D = 128


def _rows(seed, n=200):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, D).astype(np.float32)
    w = rng.rand(D).astype(np.float32) + 0.5
    dy = rng.randn(n, D).astype(np.float32)
    return x, w, dy


def test_rms_twins_match_pallas_interpret():
    """The forward twin (out, rstd) and the backward twin (dx, dw) ==
    JAX's `_rms_fwd_pallas` / `_rms_bwd_pallas` (interpret mode) at
    D=128 over 200 rows (a padded tail block)."""
    x, w, dy = _rows(0)
    jout, jrstd = jrms._rms_fwd_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                       interpret=True)
    out, rstd = trms.rms_norm_fwd(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), atol=TOL,
                               rtol=TOL)
    jdx, jdw = jrms._rms_bwd_pallas(jnp.asarray(x), jnp.asarray(w), jrstd,
                                    jnp.asarray(dy), interpret=True)
    dx, dw = trms.rms_norm_bwd(_t(x), _t(w), rstd, _t(dy), 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=TOL,
                               rtol=TOL)
    # dw sums 200 rows: summation order differs
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=GRAD_TOL,
                               rtol=GRAD_TOL)


def test_rms_norm_train_grads_match_jax():
    """rms_norm_train's autograd == JAX's custom_vjp on a [2, 5, 128]
    input (leading dims folded into rows)."""
    x, w, dy = _rows(1, 10)
    x3, dy3 = x.reshape(2, 5, D), dy.reshape(2, 5, D)
    jg = jax.vjp(lambda a, b: jrms.rms_norm_train(a, b, 1e-5, True),
                 jnp.asarray(x3), jnp.asarray(w))[1](jnp.asarray(dy3))
    tx, tw = _t(x3).requires_grad_(True), _t(w).requires_grad_(True)
    trms.rms_norm_train(tx, tw, 1e-5).backward(_t(dy3))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg[1]),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_rms_norm_train_hvp_matches_jax():
    """Double grad (reverse over reverse) through rms_norm_train == the
    JAX package's HVP of its rms_norm_train (tests/test_rms_norm.py's
    formulation): the CPU backward is differentiable."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, D).astype(np.float32)
    w = rng.rand(D).astype(np.float32)
    v = rng.randn(8, D).astype(np.float32)
    jw = jnp.asarray(w)

    def jloss(a):
        return jnp.sum(jrms.rms_norm_train(a, jw, 1e-6, True) ** 2)

    jg = jax.grad(jloss)
    jhvp = jax.grad(lambda a: jnp.vdot(jg(a), jnp.asarray(v)))(
        jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    loss = torch.sum(trms.rms_norm_train(tx, _t(w), 1e-6) ** 2)
    (g,) = torch.autograd.grad(loss, tx, create_graph=True)
    (hvp,) = torch.autograd.grad(torch.sum(g * _t(v)), tx)
    np.testing.assert_allclose(hvp.numpy(), np.asarray(jhvp), rtol=1e-4,
                               atol=1e-4)


def test_rms_cpu_counts_no_launch():
    x, w, dy = _rows(2, 4)
    n0 = (trms.rms_norm_fwd.launches, trms.rms_norm_bwd.launches)
    out, rstd = trms.rms_norm_fwd(_t(x), _t(w))
    trms.rms_norm_bwd(_t(x), _t(w), rstd, _t(dy))
    assert (trms.rms_norm_fwd.launches, trms.rms_norm_bwd.launches) == n0


# ------------------------------------------------------------ 8-bit AdamW
def _f8_to_np(codes):
    """JAX float8 codes → f32 numpy (exact)."""
    return np.asarray(codes).astype(np.float32)


def _jq_to_t(q):
    return tqs._QTensor(_t(_f8_to_np(q.codes)).to(tqs.F8),
                        _t(np.asarray(q.scale, np.float32)))


def _assert_codes_close(tq, jq, sqrt_space, what):
    """Decoded moments within one float8 step of their block (the
    block's scale times 32, e4m3's spacing at the top binade), and at
    most 0.1 % of codes different."""
    tc = tq.codes.float().numpy()
    jc = _f8_to_np(jq.codes)
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6, err_msg=what)
    dec_t = tc * tq.scale.numpy()
    dec_j = jc * np.asarray(jq.scale)
    step = 32.0 * np.asarray(jq.scale)
    assert np.all(np.abs(dec_t - dec_j) <= step), what
    assert np.mean(tc != jc) <= 1e-3, (what, np.mean(tc != jc))


def test_fused_adamw_plain_matches_pallas_interpret():
    """Two steps of the fused update's plain version == JAX's
    `_fused_leaf_update(interpret=True)` on a [3, 100] leaf (300 values:
    2 blocks, the second padded with 212 zeros)."""
    rng = np.random.RandomState(0)
    shape = (3, 100)
    p = rng.randn(*shape).astype(np.float32)
    m0 = (rng.randn(*shape) * 1e-2).astype(np.float32)
    v0 = (rng.rand(*shape) * 1e-4).astype(np.float32)
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    jm, jv = jqs._quantize(jnp.asarray(m0), False), \
        jqs._quantize(jnp.asarray(v0), True)
    tm, tv = _jq_to_t(jm), _jq_to_t(jv)
    jp, tp = jnp.asarray(p), _t(p.copy())
    for step in (1, 2):
        g = rng.randn(*shape).astype(np.float32)
        sc = np.array([0.7, 1e-3, 1 - 0.9 ** step, 1 - 0.95 ** step],
                      np.float32)
        jp, jm, jv = jqs._fused_leaf_update(
            jnp.asarray(sc), jnp.asarray(g), jp, jm, jv, interpret=True,
            **hp)
        tp, tm, tv = tqs.fused_leaf_update(_t(sc), _t(g), tp, tm, tv, **hp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6,
                                   rtol=0)
        _assert_codes_close(tm, jm, False, f"m step {step}")
        _assert_codes_close(tv, jv, True, f"v step {step}")
    # the padded tail of the last block stays exactly zero
    assert not tm.codes.float()[1, 300 - 256:].any()


def test_quantize_matches_jax():
    """`_quantize` (codes x / scale, the form a moment starts from) ==
    the JAX package's, bit for bit."""
    x = np.random.RandomState(1).randn(5, 77).astype(np.float32)
    for sqrt_space, a in ((False, x), (True, np.abs(x))):
        jq = jqs._quantize(jnp.asarray(a), sqrt_space)
        tq = tqs._quantize(_t(a), sqrt_space)
        np.testing.assert_array_equal(tq.codes.float().numpy(),
                                      _f8_to_np(jq.codes))
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=1e-7)


@pytest.mark.parametrize("clip_norm", [None, 1.0])
def test_apply_fused_matches_jax(clip_norm):
    """Two steps of `adamw_q_fused(...).apply_fused` on a tree with a
    padded leaf == the JAX package's (its Pallas kernel in interpret
    mode), with the streamed clip off and on (the gradients' global norm
    is ~9, so the clip acts) and the pre-clip norm given as the train
    step gives it: params to 1e-6, codes as the fused check holds
    them."""
    rng = np.random.RandomState(2)
    shapes = {"w": (4, 64), "b": (100,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jtx = jqs.adamw_q_fused(1e-3, 0.9, 0.95, 1e-8, 0.1, clip_norm=clip_norm)
    ttx = tqs.adamw_q_fused(1e-3, 0.9, 0.95, 1e-8, 0.1, clip_norm=clip_norm)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v.copy()) for k, v in params.items()}
    jst, tst = jtx.init(jp), ttx.init(tp)
    flags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        for _ in range(2):
            g = {k: (rng.randn(*s) * 0.5).astype(np.float32)
                 for k, s in shapes.items()}
            jp, jst = jtx.apply_fused({k: jnp.asarray(v) for k, v in
                                       g.items()}, jst, jp)
            tg = {k: _t(v) for k, v in g.items()}
            tp, tst = ttx.apply_fused(tg, tst, tp, transform.global_norm(tg))
            for k in shapes:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                           atol=1e-6, rtol=0, err_msg=k)
                _assert_codes_close(tst.m[k], jst.m[k], False, f"m {k}")
                _assert_codes_close(tst.v[k], jst.v[k], True, f"v {k}")
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})
    assert int(tst.count) == int(jst.count) == 2


def test_fused_adamw_cpu_counts_no_launch():
    p = torch.zeros(256)
    q = tqs._zero_q(p)
    n0 = tqs.fused_leaf_update.launches
    tqs.fused_leaf_update(torch.tensor([1.0, 1e-3, 0.1, 0.05]),
                          torch.ones(256), p, q, tqs._zero_q(p), b1=0.9,
                          b2=0.95, eps=1e-8, wd=0.0)
    assert tqs.fused_leaf_update.launches == n0
    assert (p < 0).all()

