"""The launch plan of the three norm backward kernels (kernels/norm_bwd.py:
rows 8, 10 and 12 of PERF.md's table, `rms_norm_bwd`, `layer_norm_bwd`
and `adaln_bwd`) and the first two's plain twins, on the CPU.

The kernels of `csrc/rms_norm.cu`, `csrc/layer_norm.cu` and
`csrc/adaln.cu` run only on the card (`chip_smoke.py`,
`tools/bench_kernels.py --check`); what they share with the host is the
plan, which these tests hold: every row is walked by exactly one team and
every partial row folded exactly once (adaLN's per sample, none spanning
two).
(The order of the sums shows only in the card's f32 results, which
those two hold bit for bit twice and against the twins.) The plain
twins are held against the JAX Pallas backward kernels in
interpret mode at row counts off their blocks, in bf16 (one bf16 ulp,
8e-3, for dx and a bf16 dw) and f32 (2e-5; the sums over rows 1e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import layer_norm as jln  # noqa: E402
from paddle_tpu.kernels import rms_norm as jrms  # noqa: E402

from paddle_tpu_torch.kernels import layer_norm as tln  # noqa: E402
from paddle_tpu_torch.kernels import norm_bwd  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402

# (rows, D, values a 16-byte vector, column sums, SMs, resident blocks):
# one row, 4099 rows, more teams than rows, a grid capped by the rows,
# rows that fill the grid's teams exactly and one past, the narrowest
# fold, every team shape, a million rows, the H100's 132 SMs
PLANS = [(1, 8, 8, 1, 132, 2), (1, 8192, 4, 2, 132, 1),
         (3, 8192, 8, 1, 132, 2), (5, 768, 4, 2, 132, 1),
         (4099, 776, 8, 1, 132, 2), (4099, 1032, 4, 2, 132, 1),
         (4099, 136, 8, 1, 3, 2), (16384, 4096, 8, 1, 132, 2),
         (40960, 2048, 8, 1, 132, 2), (32768, 768, 4, 2, 132, 1),
         (300, 6144, 4, 2, 7, 1), (97, 2056, 8, 1, 1, 1),
         (8, 8, 8, 1, 132, 2), (9, 8, 8, 1, 132, 2), (64, 16, 4, 2, 132, 4),
         (2112, 1024, 8, 1, 132, 2), (4099, 2048, 4, 2, 132, 1),
         (2048, 8192, 4, 2, 132, 1), (5000, 6144, 8, 1, 1, 1),
         (1 << 20, 4096, 8, 1, 132, 2)]


@pytest.mark.parametrize("rows,D,vec,n_acc,n_sm,resident", PLANS)
def test_plan_covers_every_row_and_partial_once(rows, D, vec, n_acc, n_sm,
                                                resident):
    plan = norm_bwd.bwd_plan(rows, D, vec, n_acc, n_sm, resident)
    assert plan.teams * 32 * plan.warps == norm_bwd.THREADS
    assert 1 <= plan.blocks <= max(n_sm * resident, 1)
    assert plan.blocks <= -(-rows // plan.teams)
    # every row once, the teams' ranges in grid order
    seen = np.zeros(rows, np.int64)
    last = 0
    for g in range(plan.blocks * plan.teams):
        lo, hi = norm_bwd.team_rows(plan, rows, g)
        assert lo == last and lo <= hi
        seen[lo:hi] += 1
        last = hi
    assert last == rows and (seen == 1).all()
    # every partial row once in the fold, every column in a fold block
    parts = np.zeros(plan.blocks, np.int64)
    for lo, hi in norm_bwd.fold_segments(plan):
        parts[lo:hi] += 1
    assert (parts == 1).all()
    assert len(norm_bwd.fold_segments(plan)) == plan.fold_segs
    assert plan.fold_cols * plan.fold_segs == norm_bwd.THREADS


# (B, N, D, values a vector, SMs, resident blocks): DiT-XL/2's [96, 256,
# 1152] bf16, the f32 [4, 100, 776] held case, one token, odd token counts,
# more samples than the card's blocks, a bf16 width of 8-byte vectors, a
# small card
ADALN_PLANS = [(96, 256, 1152, 8, 132, 2), (4, 100, 776, 4, 132, 2),
               (1, 1, 772, 4, 132, 2), (1, 7, 1536, 8, 132, 2),
               (1, 257, 1152, 8, 132, 2), (5, 7, 776, 4, 132, 1),
               (300, 3, 1152, 8, 132, 2), (3, 257, 772, 4, 7, 3),
               (2, 1, 8, 8, 1, 1)]


@pytest.mark.parametrize("B,N,D,vec,n_sm,resident", ADALN_PLANS)
def test_adaln_plan_walks_every_row_once_per_sample(B, N, D, vec, n_sm,
                                                    resident):
    """Every row of x [B·N, D] is walked by exactly one team; no piece
    crosses a sample, so a piece's weight and sums are one sample's; the
    pieces' partial rows are distinct; every sample's partial rows are
    listed exactly once, in block order, each written by a piece of that
    sample; the fold's segments cover them once."""
    plan = norm_bwd.adaln_plan(B, N, D, vec, n_sm, resident)
    assert plan.teams * 32 * plan.warps == norm_bwd.THREADS
    assert 1 <= plan.blocks <= max(n_sm * resident, 1)
    assert plan.blocks <= B * N
    seen = np.zeros(B * N, np.int64)
    writer = {}
    for k in range(plan.blocks):
        pieces = norm_bwd.adaln_pieces(plan, B, N, k)
        assert (pieces[0][1], pieces[-1][2]) == \
            norm_bwd.adaln_block_rows(plan, B * N, k)
        for b, lo, hi in pieces:
            assert b * N <= lo < hi <= (b + 1) * N
            last = lo
            for team in range(plan.teams):
                tlo, thi = norm_bwd.adaln_team_rows(plan, lo, hi, team)
                assert tlo == last and tlo <= thi
                seen[tlo:thi] += 1
                last = thi
            assert last == hi
            p = norm_bwd.adaln_partial_row(k, b)
            assert p not in writer and p < plan.blocks + B
            writer[p] = b
    assert (seen == 1).all()
    listed = []
    for b in range(B):
        parts = norm_bwd.adaln_sample_parts(plan, B, N, b)
        assert parts == sorted(parts)
        assert [writer[p] for p in parts] == [b] * len(parts)
        listed += parts
        covered = np.zeros(len(parts), np.int64)
        for lo, hi in norm_bwd.adaln_fold_segments(plan, len(parts)):
            covered[lo:hi] += 1
        assert (covered == 1).all()
    assert sorted(listed) == sorted(writer)
    assert plan.fold_cols * plan.fold_segs == norm_bwd.THREADS


@pytest.mark.parametrize("vec", [4, 8])
def test_team_shapes_are_the_instantiated_ones(vec):
    """Every D the kernels take (multiples of 8 up to 8192) gets a team
    that holds its row with at most 32 values a lane, from the shapes
    csrc/norm_bwd_core.cuh's dispatch instantiates."""
    vmax = 32 // vec
    one_warp = {1, 2, 4} if vec == 8 else {1, 2, 4, 6, 8}
    for D in range(8, 8193, 8):
        warps, vpt = norm_bwd.team_shape(D, vec)
        assert (vpt in one_warp) if warps == 1 else \
            (warps in (2, 4, 8) and vpt == vmax)
        assert D // vec <= 32 * warps * vpt and vpt * vec <= 32


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(shape, dtype, seed):
    """The same bf16- or f32-rounded values for JAX and torch."""
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal(shape) + 0.5, dtype)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def test_rms_twin_matches_pallas_bf16():
    """The RMSNorm backward twin in the paths' form (bf16 x, dy and
    weight, dw in bf16) == `_rms_bwd_pallas(interpret=True)` over 300
    rows (a padded Pallas block)."""
    rows, D = 300, 136
    xj, xt = _pair((rows, D), jnp.bfloat16, 0)
    dyj, dyt = _pair((rows, D), jnp.bfloat16, 1)
    wj, wt = _pair((D,), jnp.bfloat16, 2)
    _, rj = jrms._rms_fwd_pallas(xj, wj, 1e-6, interpret=True)
    jdx, jdw = jrms._rms_bwd_pallas(xj, wj, rj, dyj, interpret=True)
    dx, dw = trms.rms_norm_bwd(xt, wt, None, dyt, 1e-6)
    assert dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(_np(dw), _np(jdw), rtol=8e-3,
                               atol=8e-3 * np.abs(_np(jdw)).max())


@pytest.mark.parametrize("dtype,affine", [(jnp.float32, True),
                                          (jnp.bfloat16, False)])
def test_ln_twin_matches_pallas_odd_rows(dtype, affine):
    """The LayerNorm backward twin == `_ln_bwd_pallas(interpret=True)`
    over 259 rows (one past a Pallas block) at D 24."""
    rows, D = 259, 24
    xj, xt = _pair((rows, D), dtype, 3)
    dyj, dyt = _pair((rows, D), dtype, 4)
    wj, wt = _pair((D,), jnp.float32, 5) if affine else (None, None)
    bj = jnp.zeros((D,), jnp.float32) if affine else None
    _, mj, rj = jln._ln_fwd_pallas(xj, wj, bj, 1e-12, affine,
                                   interpret=True)
    jdx, jdw, jdb = jln._ln_bwd_pallas(xj, wj, mj, rj, dyj, affine,
                                       interpret=True)
    dx, dw, db = tln.layer_norm_bwd(xt, wt, None, None, dyt, 1e-12)
    tol = 2e-5 if dtype == jnp.float32 else 8e-3
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=tol, atol=tol)
    for a, ref in ((dw, jdw), (db, jdb)):
        np.testing.assert_allclose(_np(a), _np(ref).reshape(-1), rtol=1e-4,
                                   atol=1e-4 * np.abs(_np(ref)).max())
