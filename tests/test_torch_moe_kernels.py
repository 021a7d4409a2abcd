"""The MoE dispatch kernels' plain versions against the JAX package, on the CPU.

On a CPU tensor `gather_wsum` and `gather_scale_dot` run their plain
PyTorch versions, so these tests pin the arithmetic that the CUDA kernels
of `csrc/moe_dispatch.cu` are held to on the card (`chip_smoke.py`): the
same numpy inputs go through the JAX Pallas kernels in interpret mode and
through the port. `dispatch_gather` and `combine_wsum` (the autograd
Functions) are held against the JAX package's custom VJPs: at D=128 with
`FLAGS_pallas_interpret` (its Pallas route) and at D=64 (its jnp route).

The index maps are those of a real routing: each (token, choice) fills a
distinct slot or is dropped, and the inverse maps name who fills each
slot. Tolerances: float32 throughout; a row sum of k terms and a dot over
D terms in another order, so values and gradients agree to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def test_cpu_counts_no_launch():
    """On CPU tensors the wrappers run their plain versions and count no
    launch."""
    n0 = (tmd.gather_wsum.launches, tmd.gather_scale_dot.launches)
    src = torch.randn(1, 4, 16)
    idx = torch.zeros(1, 3, 2, dtype=torch.int32)
    tmd.gather_wsum(src, idx, torch.ones(1, 3, 2))
    tmd.gather_scale_dot(src, idx[..., 0], torch.ones(1, 3),
                         torch.randn(1, 3, 16))
    assert (tmd.gather_wsum.launches, tmd.gather_scale_dot.launches) == n0
