"""The host side of row 16, the gather fused into the expert gate and up
products (kernels/moe_dispatch.py: `mlp_plan`, `mlp_tiles`,
`mlp_halves`, `mlp_tma_dims`), on the CPU.

The kernel (`csrc/gather_mlp.cu`) runs only on the card, where
`chip_smoke.py` and `tools/bench_kernels.py --check --rows 16` hold it
against its plain version (whose values `test_torch_moe_kernels.py` holds
against the JAX package). What it shares with the host is held here: the
persistent grid's tiles cover every (expert, live half, F tile) once with
F innermost, the halves it leaves out (and writes zero rows for) are
exactly those whose slots are all empty, and the tensor-map values
describe the tensors the wrapper passes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

from paddle_tpu_torch.kernels import moe_dispatch as md  # noqa: E402

# (E, M, F, SMs): the MoE step's shape on 132 SMs, M and F off the tile,
# fewer tiles than SMs, one SM
PLANS = [(16, 6400, 1024, 132), (3, 200, 776, 132), (2, 131, 136, 7),
         (5, 1, 8, 132), (4, 320, 1024, 1)]


def _routing(seed, E, M, T):
    """Groups of 64 slots filled from the front to random depths; expert 0
    wholly empty, expert 1 wholly filled, one slot holding T - 1 and one
    an index past T (empty, as -1 is)."""
    rng = np.random.RandomState(seed)
    idx = np.full((E, M), -1, np.int64)
    for e in range(E):
        for g0 in range(0, M, 64):
            n = rng.randint(0, min(64, M - g0) + 1)
            idx[e, g0:g0 + n] = rng.randint(0, T, n)
    idx[0] = -1
    if E > 1:
        idx[1] = rng.randint(0, T, M)
        idx[1, 0] = T - 1
        if M > 1:
            idx[1, -1] = T + 5
    return idx


@pytest.mark.parametrize("E,M,F,n_sm", PLANS)
def test_tiles_cover_every_live_half_once_f_innermost(E, M, F, n_sm):
    """The grid's tiles, pairs of an expert's live halves, cover every
    (expert, live half, F tile) once; the dead halves are exactly those
    with no filled slot and get no tile; the F tiles of one pair are
    consecutive tiles; every block's share differs from another's by at
    most one tile."""
    T = 50
    idx = _routing(E + M, E, M, T)
    plan = md.mlp_plan(E, M, F, n_sm)
    assert plan.halves == -(-M // md.MLP_HALF)
    assert plan.f_tiles == -(-F // md.MLP_COLS)
    assert 1 <= plan.grid <= n_sm
    halves = md.mlp_halves(torch.from_numpy(idx).int(), T)
    tiles = md.mlp_tiles(plan, halves)
    seen = {}
    shares = []
    for c in range(plan.grid):
        mine = tiles[c::plan.grid]
        shares.append(len(mine))
        for e, ha, hb, f0 in mine:
            for h in (ha, hb):
                if h >= 0:
                    seen[(e, h, f0)] = seen.get((e, h, f0), 0) + 1
    assert max(shares) - min(shares) <= 1
    for e in range(E):
        live, dead = halves[e]
        assert sorted(live + dead) == list(range(plan.halves))
        for h in range(plan.halves):
            rows = idx[e, h * md.MLP_HALF:(h + 1) * md.MLP_HALF]
            assert (h in live) == bool(((rows >= 0) & (rows < T)).any())
    want = {(e, h, f0) for e in range(E) for h in halves[e][0]
            for f0 in range(0, F, md.MLP_COLS)}
    assert set(seen) == want and set(seen.values()) <= {1}
    assert not halves[0][0]
    if E > 1:
        assert halves[1][0] == list(range(plan.halves))
    for t in range(1, len(tiles)):
        if tiles[t][3] != 0:
            assert tiles[t][:3] == tiles[t - 1][:3]


@pytest.mark.parametrize("E,M,T", [(4, 200, 50), (3, 128, 9), (2, 1, 3)])
def test_scratch_holds_the_plan_lists(E, M, T):
    """The plan's scratch holds both half lists and their counts."""
    H = -(-M // md.MLP_HALF)
    assert md.mlp_scratch_ints(E, M) == 2 * E * H + 2 * E
    live = md.mlp_live_halves(torch.from_numpy(_routing(1, E, M, T)).int(),
                              T)
    assert live.shape == (E, H)


@pytest.mark.parametrize("E,M,D,F", [(16, 6400, 2048, 1024),
                                     (3, 200, 520, 776), (5, 1, 8, 8)])
def test_tma_dims_describe_the_tensors(E, M, D, F):
    """Extents innermost first and byte strides of dimensions 1-3, as
    hopper_core.cuh's encode_map takes them: those of contiguous wg, wu
    [E, D, F], xin [E, M, D] and g, u [E, M, F] in bf16, every stride a
    whole number of 16-byte units (TMA's rule)."""
    vals = md.mlp_tma_dims(E, M, D, F)
    assert len(vals) == 35
    w = torch.empty(E, D, F, dtype=torch.bfloat16)
    x = torch.empty(E, M, D, dtype=torch.bfloat16)
    o = torch.empty(E, M, F, dtype=torch.bfloat16)
    for k, t in enumerate((w, w, x, o, o)):
        v = vals[7 * k:7 * k + 7]
        assert v[:4] == [t.shape[2], t.shape[1], t.shape[0], 1]
        st = [s * t.element_size() for s in t.stride()]
        assert v[4:6] == [st[1], st[0]]
        assert v[6] == t.numel() * t.element_size()
        assert all(s % 16 == 0 for s in v[4:])
