"""Row 18's two options on the CPU: the int8 pool and the speculative
suffix slab of ragged paged attention, against the JAX package.

The port's plain version (`ragged_paged_attention_ref`) is held to the
JAX package's XLA formulations (`paged._paged_gqa_attention` over an
int8 pool with `k_scale`/`v_scale`; `paged._spec_gqa_attention`, the
pool read-only at positions < base_len plus the slab under a chain or
tree visibility) and to its Pallas kernel (`_rpa_kernel` with
`quantized=True` and `suffix=True`) in interpret mode, on seeded f32
inputs, to ATOL (f32 softmaxes summed in other orders: a few ulps of
O(1) values). The XLA formulations leave invalid queries' rows as
garbage nobody reads, so only valid queries are compared with them;
against the kernel, invalid queries are zeros on both sides.

`_split_merge_ref` — the kernel's split-and-merge algebra with the slab
as the last split — must equal the plain version in f32 to MERGE_TOL of
the output's scale, and in f64 the same merge must equal one split over
the whole chain to 1e-12, over fp and int8 pools, with and without a
slab.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import paged as jpaged  # noqa: E402
from paddle_tpu.nlp import ragged_attention as jra  # noqa: E402
from paddle_tpu.serving.speculative import SpecConfig  # noqa: E402

from paddle_tpu_torch.nlp import ragged_attention as tra  # noqa: E402
from paddle_tpu_torch.quantization import kv as tkv  # noqa: E402

ATOL = 1e-5
MERGE_TOL = 1e-6


def _batch(seed, R, P, H, KV, hd, M, bs, lengths, q8=False, S=0,
           vis="random"):
    """Rows of P queries ending at position lengths[r] - 1 (rows shorter
    than P left-pad as invalid), distinct block chains, f32 pools or
    their int8 codes with one scale a block (block 0 never written), and
    a slab of S rows whose visibility is random, the chain's causal
    triangle over the last P rows, or a packed tree's ancestor mask.
    Returns numpy arrays: (q, k_pool, v_pool, table, pos, val) and the
    options dict."""
    rng = np.random.RandomState(seed)
    N = R * M + 3
    pos = np.zeros((R, P), np.int32)
    val = np.zeros((R, P), np.bool_)
    for r, L in enumerate(lengths):
        for p in range(P):
            j = L - P + p
            pos[r, p] = min(max(j, 0), M * bs - 1)
            val[r, p] = j >= 0 and L > 0
    table = rng.permutation(N)[:R * M].reshape(R, M).astype(np.int32)
    q = rng.randn(R, P, H, hd).astype(np.float32)
    kp = rng.randn(N, bs, KV, hd).astype(np.float32)
    vp = rng.randn(N, bs, KV, hd).astype(np.float32)
    opts = {}
    if q8:
        pools = []
        for x in (kp, vp):
            sc = np.abs(x).max(axis=(1, 2, 3)) / 127.0
            sc[0] = 0.0
            codes = np.clip(np.round(x / np.where(sc > 0, sc, 1.0)
                                     [:, None, None, None]), -127, 127)
            codes[0] = 0
            pools.append((codes.astype(np.int8), sc.astype(np.float32)))
        (kp, opts["k_scale"]), (vp, opts["v_scale"]) = pools
    if S:
        if vis == "random":
            v = rng.rand(R, P, S) < 0.5
        elif vis == "chain":
            v = np.broadcast_to(np.arange(S)[None, :]
                                <= (S - P + np.arange(P))[:, None],
                                (R, P, S))
        else:
            v = np.broadcast_to(np.array(SpecConfig(tree=vis)
                                         .ancestor_mask()), (R, P, S))
        opts["suffix_k"] = rng.randn(R, S, KV, hd).astype(np.float32)
        opts["suffix_v"] = rng.randn(R, S, KV, hd).astype(np.float32)
        opts["suffix_vis"] = np.ascontiguousarray(v)
    return (q, kp, vp, table, pos, val), opts


def _t(arrays, opts):
    return ([torch.from_numpy(a) for a in arrays],
            {k: torch.from_numpy(v) for k, v in opts.items()})


def _j(arrays, opts):
    return ([jnp.asarray(a) for a in arrays],
            {k: jnp.asarray(v) for k, v in opts.items()})


# (R, P, H, KV, hd, M, bs, lengths)
INT8_CASES = [
    (3, 1, 4, 2, 16, 4, 4, [13, 1, 16]),           # decode rows
    (2, 5, 4, 1, 8, 6, 4, [20, 5]),                # a continuing chunk
    (3, 3, 2, 2, 8, 3, 8, [0, 17, 24]),            # an all-invalid row
]


@pytest.mark.parametrize("case", INT8_CASES,
                         ids=[f"case{i}" for i in range(len(INT8_CASES))])
def test_int8_pool_matches_jax(case):
    R, P, H, KV, hd, M, bs, lengths = case
    arrays, opts = _batch(0, R, P, H, KV, hd, M, bs, lengths, q8=True)
    targs, topts = _t(arrays, opts)
    got = tra.ragged_paged_attention_ref(*targs, **topts).numpy()
    # the CPU wrapper is the plain version, and counts no launch
    n = tra.ragged_paged_attention.launches_int8
    np.testing.assert_array_equal(
        tra.ragged_paged_attention(*targs, **topts).numpy(), got)
    assert tra.ragged_paged_attention.launches_int8 == n
    jargs, jopts = _j(arrays, opts)
    xla = np.asarray(jpaged._paged_gqa_attention(*jargs, impl="xla",
                                                 **jopts))
    pallas = np.asarray(jra.ragged_paged_attention(*jargs, interpret=True,
                                                   **jopts))
    val = arrays[5]
    np.testing.assert_allclose(got[val], xla[val], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert not got[~val].any()
    # a row whose chain is the never-written block 0 alone reads zeros:
    # its scale-0 codes dequantize to exact zeros, as an fp pool's would
    fp = tra.ragged_paged_attention_ref(
        targs[0], tkv.dequantize(targs[1], topts["k_scale"][:, None, None,
                                                           None]),
        tkv.dequantize(targs[2], topts["v_scale"][:, None, None, None]),
        *targs[3:]).numpy()
    np.testing.assert_allclose(got, fp, atol=ATOL, rtol=0)


# (R, P, S, H, KV, hd, M, bs, base lengths, visibility, int8 pool)
SLAB_CASES = [
    (3, 4, 4, 4, 2, 16, 4, 4, [9, 1, 0], "chain", False),   # chain verify
    (2, 7, 7, 4, 1, 8, 4, 4, [13, 4], [2, 2], True),        # tree verify
    (3, 1, 4, 4, 2, 8, 4, 4, [6, 16, 3], "chain", True),    # a draft step
]


@pytest.mark.parametrize("case", SLAB_CASES,
                         ids=[f"case{i}" for i in range(len(SLAB_CASES))])
def test_suffix_slab_matches_jax_spec_attention(case):
    """The speculative score path: every query valid at position
    base_len - 1 (the pool read-only), the slab under a shared chain or
    tree visibility. The port's plain version equals JAX's XLA
    `_spec_gqa_attention` and its Pallas suffix kernel."""
    R, P, S, H, KV, hd, M, bs, base, vis, q8 = case
    arrays, opts = _batch(1, R, P, H, KV, hd, M, bs, [M * bs] * R, q8=q8,
                          S=S, vis=vis)
    base = np.array(base, np.int32)
    pos = np.repeat(base[:, None] - 1, P, axis=1)
    val = np.ones((R, P), np.bool_)
    arrays = arrays[:4] + (pos, val)
    targs, topts = _t(arrays, opts)
    got = tra.ragged_paged_attention_ref(*targs, **topts).numpy()
    jargs, jopts = _j(arrays, opts)
    sp = np.asarray(jpaged._spec_gqa_attention(
        jargs[0], jargs[1], jargs[2], jargs[3], jnp.asarray(base),
        jopts["suffix_k"], jopts["suffix_v"],
        jnp.asarray(opts["suffix_vis"][0]), jopts.get("k_scale"),
        jopts.get("v_scale"), impl="xla"))
    pallas = np.asarray(jra.ragged_paged_attention(*jargs, interpret=True,
                                                   **jopts))
    np.testing.assert_allclose(got, sp, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


def test_suffix_slab_random_visibility_matches_pallas():
    """Per-query random slab visibility (a query that sees no slab row
    among them), invalid queries, ragged chains, an int8 pool: the plain
    version equals the Pallas suffix kernel, zeros included."""
    arrays, opts = _batch(2, 3, 5, 4, 2, 16, 4, 4, [16, 3, 0], q8=True,
                          S=6)
    opts["suffix_vis"][1, 4] = False
    targs, topts = _t(arrays, opts)
    got = tra.ragged_paged_attention_ref(*targs, **topts).numpy()
    jargs, jopts = _j(arrays, opts)
    pallas = np.asarray(jra.ragged_paged_attention(*jargs, interpret=True,
                                                   **jopts))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert not got[~arrays[5]].any()


# (R, P, S, H, KV, hd, M, bs, n_sm, lengths, int8 pool, slab visibility)
MERGE_CASES = [
    (6, 1, 0, 4, 2, 16, 10, 48, 132, [1, 48, 49, 200, 480, 0], True, None),
    (4, 1, 4, 8, 2, 8, 40, 16, 132, [640, 64, 65, 7], False, "chain"),
    (3, 5, 5, 4, 1, 8, 20, 16, 132, [300, 12, 0], True, "chain"),
    (2, 11, 11, 8, 2, 8, 12, 32, 24, [384, 30], True, [2, 2, 1]),
    (3, 1, 9, 2, 1, 16, 3, 128, 132, [384, 129, 5], False, "random"),
]


@pytest.mark.parametrize("case", MERGE_CASES,
                         ids=[f"case{i}" for i in range(len(MERGE_CASES))])
def test_split_merge_with_slab_matches_plain(case):
    """The slab folded as the last split, after each query's pool splits
    in order: the merge equals the one-pass plain softmax to MERGE_TOL of
    the output's scale in f32, and in f64 equals one split over the whole
    chain (the slab still last) to 1e-12 of each vector's scale."""
    R, P, S, H, KV, hd, M, bs, n_sm, lengths, q8, vis = case
    arrays, opts = _batch(3, R, P, H, KV, hd, M, bs, lengths, q8=q8, S=S,
                          vis=vis)
    targs, topts = _t(arrays, opts)
    plan = tra.split_plan(R, P, H, KV, M, bs, n_sm)
    assert plan.n_splits > 1
    got = tra._split_merge_ref(*targs, plan, **topts)
    ref = tra.ragged_paged_attention_ref(*targs, **topts)
    v = targs[5]
    err = (got - ref).abs()[v].max() / ref.abs().max()
    assert err.item() <= MERGE_TOL
    assert not got[~v].any()

    def f64(t):
        return t.double() if t.is_floating_point() else t

    a64 = [f64(a) for a in targs]
    o64 = {k: f64(x) for k, x in topts.items()}
    whole = plan._replace(split_keys=plan.n_splits * plan.split_keys,
                          n_splits=1)
    g64 = tra._split_merge_ref(*a64, plan, **o64)
    w64 = tra._split_merge_ref(*a64, whole, **o64)
    held = v[:, :, None] & (w64.abs().amax(-1) > 0)
    rel = (g64 - w64).abs().amax(-1)[held] / w64.abs().amax(-1)[held]
    assert rel.max().item() <= 1e-12
