"""The MoE dispatch kernels' plain versions against the JAX package, on the CPU.

On a CPU tensor `gather_wsum` and `gather_scale_dot` run their plain
PyTorch versions, so these tests pin the arithmetic that the CUDA kernels
of `csrc/moe_dispatch.cu` and `csrc/gather_mlp.cu` are held to on the
card (`chip_smoke.py`): the
same numpy inputs go through the JAX Pallas kernels in interpret mode and
through the port. `dispatch_gather` and `combine_wsum` (the autograd
Functions) are held against the JAX package's custom VJPs: at D=128 with
`FLAGS_pallas_interpret` (its Pallas route) and at D=64 (its jnp route).
The masked row gather (`gather_rows`, `combine_gather`) and the gather
fused into the expert gate/up products (`gather_mlp`) are held against
the JAX package's with `use_pallas=True` in interpret mode, values and
every gradient.

The index maps are those of a real routing: each (token, choice) fills a
distinct slot or is dropped, and the inverse maps name who fills each
slot. Tolerances: float32 throughout; a row sum of k terms and a dot over
D terms in another order, so values and gradients agree to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags  # noqa: E402
from paddle_tpu.kernels import moe_dispatch as jmd  # noqa: E402

from paddle_tpu_torch.kernels import moe_dispatch as tmd  # noqa: E402

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _maps(seed, B, S, k, M):
    """Injective (token, choice) → slot maps with a few dropped choices:
    flat [B, S·k] (slot or -1), inv_pos [B, M] (position t·k + j or -1),
    inv_tok [B, M] (token or -1), and gate probs [B, S, k]."""
    rng = np.random.RandomState(seed)
    flat = np.full((B, S * k), -1, np.int32)
    inv_pos = np.full((B, M), -1, np.int32)
    for b in range(B):
        n = min(S * k - 3, M - 2)          # drops and empty slots both
        pos = rng.choice(S * k, n, replace=False)
        slots = rng.choice(M, n, replace=False)
        flat[b, pos] = slots
        inv_pos[b, slots] = pos
    inv_tok = np.where(inv_pos >= 0, inv_pos // k, -1).astype(np.int32)
    probs = rng.rand(B, S, k).astype(np.float32)
    return flat, inv_pos, inv_tok, probs


@pytest.fixture
def interpret():
    flags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        yield
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})


@pytest.mark.parametrize("k", [1, 2, 3])
def test_gather_wsum_plain_matches_pallas_interpret(k):
    """gather_wsum's plain version == `gather_wsum_pallas(interpret=True)`
    on pre-clipped indices with zero weights at dropped choices."""
    rng = np.random.RandomState(k)
    B, N, M, D = 2, 20, 24, 128
    src = rng.randn(B, N, D).astype(np.float32)
    idx = rng.randint(0, N, (B, M, k)).astype(np.int32)
    w = rng.rand(B, M, k).astype(np.float32) * (rng.rand(B, M, k) > 0.2)
    ref = jmd.gather_wsum_pallas(jnp.asarray(src), jnp.asarray(idx),
                                 jnp.asarray(w), interpret=True)
    out = tmd.gather_wsum(_t(src), _t(idx), _t(w))
    assert out.shape == (B, M, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_gather_scale_dot_plain_matches_pallas_interpret():
    """gather_scale_dot's plain (out, dot) == `gather_scale_dot_pallas(
    interpret=True)`."""
    rng = np.random.RandomState(7)
    B, N, M, D = 2, 20, 24, 128
    src = rng.randn(B, N, D).astype(np.float32)
    idx = rng.randint(0, N, (B, M)).astype(np.int32)
    scale = rng.rand(B, M).astype(np.float32)
    other = rng.randn(B, M, D).astype(np.float32)
    jout, jdot = jmd.gather_scale_dot_pallas(
        jnp.asarray(src), jnp.asarray(idx), jnp.asarray(scale),
        jnp.asarray(other), interpret=True)
    out, dot = tmd.gather_scale_dot(_t(src), _t(idx), _t(scale), _t(other))
    assert dot.shape == (B, M) and dot.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(dot.numpy(), np.asarray(jdot), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("D", [64, 128])
def test_dispatch_gather_matches_jax_vjp(D, interpret):
    """dispatch_gather's value and x-gradient == the JAX custom VJP (at
    D=128 its Pallas forward and backward in interpret mode, at D=64 its
    jnp route); empty slots give zero rows."""
    B, S, k, M = 1, 12, 2, 28
    flat, _, inv_tok, _ = _maps(D, B, S, k, M)
    rng = np.random.RandomState(D + 1)
    x = rng.randn(B, S, D).astype(np.float32)
    ct = rng.randn(B, M, D).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jmd.dispatch_gather(
        a, jnp.asarray(inv_tok), jnp.asarray(flat), k, True),
        jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    tx = _t(x).requires_grad_(True)
    y = tmd.dispatch_gather(tx, _t(inv_tok), _t(flat), k)
    y.backward(_t(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=TOL)
    assert not y.detach().numpy()[inv_tok < 0].any()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("D", [64, 128])
def test_combine_wsum_matches_jax_vjp(D, interpret):
    """combine_wsum's value and its gradients in eout and w == the JAX
    custom VJP, under the contract (clipped indices, weights zeroed at
    dropped choices): the backward's per-slot dot routed back to
    (token, choice), zero where the choice was dropped."""
    B, S, k, M = 1, 12, 2, 28
    flat, inv_pos, _, probs = _maps(D + 3, B, S, k, M)
    rng = np.random.RandomState(D + 4)
    eout = rng.randn(B, M, D).astype(np.float32)
    ct = rng.randn(B, S, D).astype(np.float32)
    idx_tk = np.clip(flat, 0, None).reshape(B, S, k)
    w = np.where(flat >= 0, probs.reshape(B, S * k), 0.0).astype(
        np.float32).reshape(B, S, k)
    jy, vjp = jax.vjp(lambda e, ww: jmd.combine_wsum(
        e, jnp.asarray(idx_tk), ww, jnp.asarray(inv_pos), True),
        jnp.asarray(eout), jnp.asarray(w))
    jde, jdw = vjp(jnp.asarray(ct))
    te = _t(eout).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    y = tmd.combine_wsum(te, _t(idx_tk), tw, _t(inv_pos))
    y.backward(_t(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jde), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=TOL,
                               rtol=TOL)
    assert not tw.grad.numpy().reshape(B, S * k)[flat < 0].any()


def test_gather_rows_matches_jax_vjp(interpret):
    """Row 13: gather_rows' plain version == `gather_rows_pallas(
    interpret=True)` bit for bit, -1 rows exactly 0; its value and src
    gradient (the scatter-add, a source row read twice summing both
    cotangents) == the JAX custom VJP with use_pallas=True."""
    rng = np.random.RandomState(11)
    B, N, M, D = 2, 20, 24, 128
    src = rng.randn(B, N, D).astype(np.float32)
    idx = rng.randint(-1, N, (B, M)).astype(np.int32)
    idx[0, :3] = [-1, 5, 5]
    ct = rng.randn(B, M, D).astype(np.float32)
    ref = jmd.gather_rows_pallas(jnp.asarray(src), jnp.asarray(idx),
                                 interpret=True)
    np.testing.assert_array_equal(
        tmd.gather_rows_kernel(_t(src), _t(idx)).numpy(), np.asarray(ref))
    jy, vjp = jax.vjp(lambda a: jmd.gather_rows(a, jnp.asarray(idx), True),
                      jnp.asarray(src))
    (jds,) = vjp(jnp.asarray(ct))
    ts = _t(src).requires_grad_(True)
    y = tmd.gather_rows(ts, _t(idx))
    y.backward(_t(ct))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    assert not y.detach().numpy()[idx < 0].any()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), atol=TOL,
                               rtol=TOL)


def test_combine_gather_matches_jax_vjp(interpret):
    """combine_gather's value and eout gradient (a gather over the
    inverse map) == the JAX custom VJP with use_pallas=True."""
    B, S, k, M = 1, 12, 2, 28
    flat, inv_pos, _, _ = _maps(5, B, S, k, M)
    rng = np.random.RandomState(6)
    eout = rng.randn(B, M, 128).astype(np.float32)
    ct = rng.randn(B, S * k, 128).astype(np.float32)
    jy, vjp = jax.vjp(lambda e: jmd.combine_gather(
        e, jnp.asarray(flat), jnp.asarray(inv_pos), True), jnp.asarray(eout))
    (jde,) = vjp(jnp.asarray(ct))
    te = _t(eout).requires_grad_(True)
    y = tmd.combine_gather(te, _t(flat), _t(inv_pos))
    y.backward(_t(ct))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(te.grad.numpy(), np.asarray(jde))


def test_gather_mlp_matches_jax_vjp(interpret):
    """Row 16: gather_mlp's (g, u) and its gradients in src, wg and wu ==
    the JAX custom VJP with use_pallas=True (its Pallas forward in
    interpret mode), on a routing of 12 tokens, top-2, into 4 experts of
    7 slots with dropped choices and empty slots; the plain version's
    xin == the Pallas kernel's."""
    S, k, E, Ms, D, F = 12, 2, 4, 7, 128, 64
    flat, _, inv_tok, _ = _maps(9, 1, S, k, E * Ms)
    idx = inv_tok.reshape(E, Ms)
    inv_flat = np.clip(flat, 0, None).reshape(S, k)
    w_flat = (flat >= 0).astype(np.float32).reshape(S, k)
    rng = np.random.RandomState(10)
    src = rng.randn(S, D).astype(np.float32)
    wg = (0.1 * rng.randn(E, D, F)).astype(np.float32)
    wu = (0.1 * rng.randn(E, D, F)).astype(np.float32)
    cg, cu = (rng.randn(E, Ms, F).astype(np.float32) for _ in range(2))
    _, _, jxin = jmd.gather_mlp_pallas(jnp.asarray(src), jnp.asarray(idx),
                                       jnp.asarray(wg), jnp.asarray(wu),
                                       interpret=True)
    np.testing.assert_array_equal(
        tmd.gather_mlp_kernel(_t(src), _t(idx), _t(wg), _t(wu))[2].numpy(),
        np.asarray(jxin))
    (jg, ju), vjp = jax.vjp(lambda a, b, c: jmd.gather_mlp(
        a, jnp.asarray(idx), jnp.asarray(inv_flat), jnp.asarray(w_flat), b,
        c, True), jnp.asarray(src), jnp.asarray(wg), jnp.asarray(wu))
    jgrads = vjp((jnp.asarray(cg), jnp.asarray(cu)))
    ts, twg, twu = (_t(a).requires_grad_(True) for a in (src, wg, wu))
    g, u = tmd.gather_mlp(ts, _t(idx), _t(inv_flat), _t(w_flat), twg, twu)
    torch.autograd.backward((g, u), (_t(cg), _t(cu)))
    for a, b in ((g, jg), (u, ju)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL, rtol=TOL)
    assert not g.detach().numpy()[idx < 0].any()
    for a, b in zip((ts, twg, twu), jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL)


def test_cpu_counts_no_launch():
    """On CPU tensors the wrappers run their plain versions and count no
    launch."""
    fns = (tmd.gather_wsum, tmd.gather_scale_dot, tmd.gather_rows_kernel,
           tmd.gather_mlp_kernel)
    n0 = [f.launches for f in fns]
    src = torch.randn(1, 4, 16)
    idx = torch.zeros(1, 3, 2, dtype=torch.int32)
    tmd.gather_wsum(src, idx, torch.ones(1, 3, 2))
    tmd.gather_scale_dot(src, idx[..., 0], torch.ones(1, 3),
                         torch.randn(1, 3, 16))
    tmd.gather_rows(src, idx[..., 0])
    tmd.gather_mlp(src[0], idx[..., 0], idx[0], torch.ones(3, 2),
                   torch.randn(1, 16, 8), torch.randn(1, 16, 8))
    assert [f.launches for f in fns] == n0
