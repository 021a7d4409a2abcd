"""The ragged paged-attention kernel's split plan and merge, on the CPU.

The CUDA kernel (`csrc/ragged_paged_attention.cu`) cuts each query tile's
live block chain into splits of whole 64-key stages, one thread block
each, by a plan the wrapper computes from the shapes alone
(`split_plan`); each split writes a partial (O, max, sum) and a second
kernel folds a query's partials in split order. These tests hold the
host side of that on the CPU: every live key of every (row, KV head) is
read by exactly one split, the table blocks each split reads cover the
chain, each query is merged from exactly the splits holding its keys,
and the merge algebra (`_split_merge_ref`, in f32) equals the plain
version `ragged_paged_attention_ref` to 1e-6 of the output's scale (the
two differ only in summation order and exp2 against exp), and in f64
equals the one-pass softmax to 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

from paddle_tpu_torch.nlp import ragged_attention as tra  # noqa: E402

MERGE_TOL = 1e-6


def _batch(seed, R, P, H, KV, hd, M, bs, lengths, valid_rows=None):
    """Rows of P queries ending at position lengths[r] - 1 (a row of
    length 0 is all invalid; rows shorter than P left-pad as invalid),
    distinct block chains, f32 pools."""
    rng = np.random.RandomState(seed)
    N = R * M + 3
    pos = np.zeros((R, P), np.int32)
    val = np.zeros((R, P), np.bool_)
    for r, L in enumerate(lengths):
        for p in range(P):
            j = L - P + p
            pos[r, p] = min(max(j, 0), M * bs - 1)
            val[r, p] = j >= 0 and L > 0
    if valid_rows is not None:
        val &= np.asarray(valid_rows, np.bool_)[:, None]
    perm = rng.permutation(N)
    table = perm[:R * M].reshape(R, M).astype(np.int32)
    q = rng.randn(R, P, H, hd).astype(np.float32)
    kp = rng.randn(N, bs, KV, hd).astype(np.float32)
    vp = rng.randn(N, bs, KV, hd).astype(np.float32)
    return q, kp, vp, table, pos, val


# (R, P, H, KV, M, bs, n_sm, lengths, what it holds)
PLAN_CASES = [
    # bs 48 does not divide the 64-key split: boundaries inside blocks
    (3, 1, 4, 2, 8, 48, 132, [384, 65, 200], "boundary inside a block"),
    # one short chain in a plan of many splits
    (4, 1, 8, 2, 64, 16, 132, [1, 20, 1024, 63], "shorter than a split"),
    (4, 1, 4, 4, 16, 16, 132, [0, 256, 17, 0], "all-invalid rows"),
    # wide tiles (prefill continuation), several query tiles a row
    (2, 40, 8, 2, 32, 16, 132, [512, 41], "wide tiles"),
    # a large grid: one split of the whole chain
    (64, 1, 32, 8, 64, 16, 132, [1024] * 64, "one split"),
    # a block larger than a split
    (2, 2, 2, 1, 4, 128, 132, [300, 129], "block larger than a split"),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[-1] for c in PLAN_CASES])
def test_split_plan_covers_every_live_key_once(case):
    R, P, H, KV, M, bs, n_sm, lengths, _ = case
    _, _, _, table, pos, val = _batch(0, R, P, H, KV, 8, M, bs, lengths)
    plan = tra.split_plan(R, P, H, KV, M, bs, n_sm)
    rep, max_keys = H // KV, M * bs
    assert plan.narrow == (rep * P <= 16)
    assert plan.tile_pos * rep == (16 if plan.narrow else 64)
    assert plan.n_ptiles * plan.tile_pos >= P
    assert plan.split_keys % 64 == 0 and plan.split_keys > 0
    assert (plan.n_splits - 1) * plan.split_keys < max_keys \
        <= plan.n_splits * plan.split_keys
    # the grid nearest to two blocks a multiprocessor, as far as whole
    # stages allow
    base = R * KV * plan.n_ptiles
    if plan.split_keys > 64:
        for n in (plan.n_splits - 1, plan.n_splits + 1):
            assert abs(base * n - 2 * n_sm) >= \
                abs(base * plan.n_splits - 2 * n_sm) - base or n < 1
    for r in range(R):
        for t in range(plan.n_ptiles):
            sl = slice(t * plan.tile_pos, (t + 1) * plan.tile_pos)
            seen = np.where(val[r, sl], pos[r, sl] + 1, 0)
            live = min(int(seen.max(initial=0)), max_keys)
            ranges = tra.split_ranges(plan, live)
            assert len(ranges) == plan.n_splits
            keys = [k for lo, hi in ranges for k in range(lo, hi)]
            # every live key once, in order; nothing past the chain
            assert keys == list(range(live))
            # the table entries the splits read: each live block, and only
            # the blocks of the split's own keys
            read = [b for lo, hi in ranges if hi > lo
                    for b in range(lo // bs, (hi - 1) // bs + 1)]
            assert sorted(set(read)) == list(range(-(-live // bs)))
            for p in range(sl.start, min(sl.stop, P)):
                n = tra.query_splits(plan, int(pos[r, p]), bool(val[r, p]),
                                     max_keys)
                want = min(int(pos[r, p]) + 1, max_keys) if val[r, p] else 0
                holding = [i for i, (lo, hi) in enumerate(ranges)
                           if lo < min(hi, want)]
                assert holding == list(range(n))
                # the merged splits' keys are exactly the query's
                assert [k for lo, hi in ranges[:n]
                        for k in range(lo, min(hi, want))] == \
                    list(range(want))
    if case[-1] == "boundary inside a block":
        assert any(lo % bs for lo, hi in tra.split_ranges(plan, max_keys)
                   if hi > lo)
    if case[-1] == "shorter than a split":
        assert 0 < min(L for L in lengths if L) < plan.split_keys \
            < max(lengths)
    if case[-1] == "block larger than a split":
        assert bs > plan.split_keys and plan.n_splits > 1
    if case[-1] == "one split":
        assert plan.n_splits == 1


# (R, P, H, KV, hd, M, bs, n_sm, lengths, valid rows or None)
MERGE_CASES = [
    (6, 1, 4, 2, 16, 10, 48, 132, [1, 48, 49, 200, 480, 0], None),
    (4, 1, 8, 2, 8, 40, 16, 132, [640, 64, 65, 7], None),
    (3, 1, 4, 4, 8, 16, 16, 24, [256, 0, 129], None),
    (3, 12, 4, 2, 8, 20, 16, 132, [300, 12, 5], None),
    (3, 24, 8, 2, 8, 12, 32, 132, [384, 30, 200], [1, 0, 1]),
    (2, 1, 2, 1, 16, 3, 128, 132, [384, 129], None),
]


@pytest.mark.parametrize("case", MERGE_CASES,
                         ids=[f"case{i}" for i in range(len(MERGE_CASES))])
def test_split_merge_matches_plain(case):
    """Partials over the plan's splits, merged in split order, equal the
    plain one-pass softmax in f32 on every valid query, to MERGE_TOL of
    the output's scale (the largest |ref|: an output vector that
    averages hundreds of values is ~10x smaller than its terms, and the
    f32 plain version's own rounding is ~1e-6 of such a vector); in f64
    the same merge equals one split over the whole chain (the one-pass
    softmax) to 1e-12 of each vector's own scale. Invalid queries are
    zeros."""
    R, P, H, KV, hd, M, bs, n_sm, lengths, rows = case
    q, kp, vp, table, pos, val = _batch(1, R, P, H, KV, hd, M, bs, lengths,
                                        rows)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos, val)]
    plan = tra.split_plan(R, P, H, KV, M, bs, n_sm)
    assert plan.n_splits > 1
    got = tra._split_merge_ref(*args, plan)
    ref = tra.ragged_paged_attention_ref(*args)
    v = torch.from_numpy(val)
    err = (got - ref).abs()[v].max() / ref.abs().max()
    assert err.item() <= MERGE_TOL
    assert not got[~v].any()
    a64 = [a.double() if a.is_floating_point() else a for a in args]
    whole = plan._replace(split_keys=plan.n_splits * plan.split_keys,
                          n_splits=1)
    g64 = tra._split_merge_ref(*a64, plan)
    w64 = tra._split_merge_ref(*a64, whole)
    rel = (g64 - w64).abs().amax(-1)[v] / w64.abs().amax(-1)[v]
    assert rel.max().item() <= 1e-12
    # a query that needs several splits is among them
    n = [tra.query_splits(plan, int(pos[r, p]), bool(val[r, p]), M * bs)
         for r in range(R) for p in range(P)]
    assert max(n) > 1
