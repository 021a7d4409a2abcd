"""The PyTorch port's speculative serving against the JAX package, on the
CPU.

`serving.speculative` (SpecConfig, SpecStats) is a copy of the JAX
module: the same inputs give the same geometry, keys, dicts, counters
and errors. `_forward_spec` — the score path over the read-only pool
plus the slab — equals JAX's on the same cache and slab (logits to
LOGIT_TOL, the slab rows it writes to SLAB_TOL), over fp and int8 pools,
under the chain's triangle and a tree's ancestor mask.

The batcher: over a tiny f32 Llama (the JAX tree carried across by
`params_from_numpy`), greedy tokens of chain and tree speculation, with
full-depth, truncated and draft-from-w8 drafts, equal the JAX plain
batcher's (xla attention, prefix cache off) and the port's plain decode,
token for token; the truncated and w8 drafts also accept exactly what the
JAX spec batcher accepts (the same counters and depth histogram). Under
int8 KV the spec tokens match the plain int8 tokens at the JAX test's
floor, 0.9. Verify-then-commit holds at the write-set level: a tick
writes the pool at exactly the accepted rows, and an int8 block's scale
changes only where an accepted row landed. Budgets are exact, a request
can opt out, and the engine takes the kwargs and reports them in
`snapshot()`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402
from paddle_tpu.serving import speculative as jspec  # noqa: E402

from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402
from paddle_tpu_torch.serving import ServingEngine  # noqa: E402
from paddle_tpu_torch.serving import speculative as tspec  # noqa: E402

LOGIT_TOL = 1e-4
SLAB_TOL = 1e-5
MATCH_FLOOR = 0.9
BATCHER_KW = dict(max_batch=2, block_size=4, max_total_len=48,
                  max_new_tokens=8, chunk=3, prefill_buckets=(8, 16))
LENGTHS = [5, 9, 12, 7, 20]
# the JAX spec batchers the port's counters are held to
JAX_SPEC = {"chain_trunc": dict(spec_k=3, draft_layers=1),
            "tree_w8": dict(spec_tree=[2, 2], draft_layers=1,
                            spec_draft_w8=True)}
# (name, batcher kwargs) of every spec form held to plain greedy
SPEC_FORMS = [
    ("chain_full", dict(spec_k=3)),
    ("chain_trunc", JAX_SPEC["chain_trunc"]),
    ("tree_full", dict(spec_tree=[2, 1, 1])),
    ("tree_trunc", dict(spec_tree=[2, 2], draft_layers=1)),
    ("chain_w8", dict(spec_k=3, draft_layers=1, spec_draft_w8=True)),
    ("tree_w8", JAX_SPEC["tree_w8"]),
]


def _prompts(seed=17):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, 250, n))) for n in LENGTHS]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _serve(cb, prompts, budgets=None):
    rids = [cb.submit(p, max_new_tokens=mn)
            for p, mn in zip(prompts, budgets or [None] * len(prompts))]
    cb.run()
    return [list(cb.outputs[r]) for r in rids]


def _port(tparams, tcfg, **kw):
    return tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                    **{**BATCHER_KW, **kw})


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX plain batcher's tokens and the JAX spec batchers' counters
    for the shared schedule, computed once."""
    jcfg, jparams, _, _ = models
    out = {}
    for name, kw in [("plain", {})] + [(n, dict(speculative=True, **k))
                                       for n, k in JAX_SPEC.items()]:
        cb = jpaged.ContinuousBatcher(jparams, jcfg, prefix_cache=False,
                                      attention_impl="xla", **kw,
                                      **BATCHER_KW)
        out[name] = (_serve(cb, _prompts()), cb.spec.as_dict())
    return out


@pytest.fixture(scope="module")
def port_plain(models):
    _, _, tcfg, tparams = models
    return _serve(_port(tparams, tcfg), _prompts())


# -- serving.speculative -----------------------------------------------------
SPEC_CONFIGS = [
    ((3,), {}), ((3, 1), {"num_layers": 2}), ((), {"tree": [2, 2]}),
    ((4, 1), {"num_layers": 2, "tree": [2, 1, 1], "draft_w8": True}),
    ((1,), {"draft_w8": True}), ((), {"tree": [1, 1, 1]}),
    ((0,), {}), ((4, 0), {}), ((4, 5), {"num_layers": 2}),
    ((), {"tree": []}), ((), {"tree": [2, 0]}),
]


@pytest.mark.parametrize("args,kw", SPEC_CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(SPEC_CONFIGS))])
def test_spec_config_matches_jax(args, kw):
    try:
        j = jspec.SpecConfig(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tspec.SpecConfig(*args, **kw)
        assert str(got.value) == str(e)
        return
    t = tspec.SpecConfig(*args, **kw)
    for name in ("tree_depth", "level_sizes", "level_offsets", "slab_rows",
                 "row_levels", "row_parents", "ancestor_mask", "as_dict"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert (t.k, t.tree, t.draft_layers, t.draft_w8) == \
        (j.k, j.tree, j.draft_layers, j.draft_w8)
    for L in (2, 8):
        if t.draft_layers is None or t.draft_layers <= L:
            assert t.depth(L) == j.depth(L)
            assert t.key(L) == j.key(L)
            assert t.as_dict(L) == j.as_dict(L)


def test_spec_stats_matches_jax():
    steps = [dict(drafted=6, accepted=3, emitted=4, slots=2, depths=[1, 2]),
             dict(drafted=6, accepted=6, emitted=7, slots=2, depths=[3, 3]),
             dict(drafted=0, accepted=0, emitted=2, slots=2),
             dict(drafted=8, accepted=0, emitted=1, slots=1, depths=[0])]
    j, t = jspec.SpecStats(), tspec.SpecStats()
    assert t.as_dict() == j.as_dict()
    for i, s in enumerate(steps):
        j.record_step(**s)
        t.record_step(**s)
        assert t.as_dict() == j.as_dict()
        if i == 1:
            assert t.drain_depths() == j.drain_depths() == [1, 2, 3, 3]
    assert (t.accept_rate(), t.tokens_per_step(), t.accepted_per_sweep()) \
        == (j.accept_rate(), j.tokens_per_step(), j.accepted_per_sweep())
    assert t.drain_depths() == j.drain_depths() == [0]


# -- _forward_spec -----------------------------------------------------------
@pytest.mark.parametrize("kv_dtype,vis", [("fp", "chain"), ("int8", "chain"),
                                          ("fp", [2, 1]), ("int8", [2, 2])])
def test_forward_spec_matches_jax(models, kv_dtype, vis):
    """A committed prefix written by a prefill, then the score path over
    it: P tokens at their positions (siblings of a tree share one), the
    pool read-only, the new rows into slab rows [row0, row0 + P)."""
    jcfg, jparams, tcfg, tparams = models
    bs, B, N, L = 4, 2, 8, jcfg.num_hidden_layers
    KV, hd = jcfg.num_key_value_heads, jcfg.head_dim
    rng = np.random.RandomState(5)
    table = np.array([[3, 1, 4, 6], [0, 5, 2, 7]], np.int32)
    base = np.array([6, 3], np.int32)
    k, v, ks, vs = jpaged.init_pool(jcfg, N, bs, kv_dtype=kv_dtype)
    jc = jpaged.PagedKVCache(k, v, jnp.asarray(table),
                             jnp.zeros((B,), jnp.int32), ks, vs)
    tk, tv, tks, tvs = tpaged.init_pool(tcfg, N, bs, device="cpu",
                                        kv_dtype=kv_dtype)
    tc = tpaged.PagedKVCache(tk, tv, torch.from_numpy(table),
                             torch.zeros((B,), dtype=torch.int32), tks, tvs)
    toks = rng.randint(1, 250, (B, 6)).astype(np.int32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (B, 6)).copy()
    val = pos < base[:, None]
    _, jc = jpaged.forward_paged(jparams, jnp.asarray(toks), jc,
                                 jnp.asarray(pos), jnp.asarray(val), jcfg,
                                 is_prefill=True, attention_impl="xla")
    _, tc = tpaged.forward_paged(tparams, torch.from_numpy(toks), tc,
                                 torch.from_numpy(pos),
                                 torch.from_numpy(val), tcfg,
                                 is_prefill=True)
    if vis == "chain":
        P, S, row0, jvis, tvis = 2, 4, 1, None, None
        lv = np.arange(P)
    else:
        sc = tspec.SpecConfig(tree=vis)
        S = P = sc.slab_rows()
        row0, lv = 0, np.array(sc.row_levels())
        m = np.array(sc.ancestor_mask())
        jvis, tvis = jnp.asarray(m), torch.from_numpy(m)
    qtok = rng.randint(1, 250, (B, P)).astype(np.int32)
    qpos = (base[:, None] + lv[None]).astype(np.int32)
    slab = rng.randn(L, B, S, KV, hd).astype(np.float32)
    jl, jsk, jsv = jpaged._forward_spec(
        jparams, jparams["layers"], jnp.asarray(qtok), jc, jnp.asarray(qpos),
        jnp.asarray(base), jnp.asarray(slab), jnp.asarray(slab), row0, jcfg,
        vis=jvis)
    tsk, tsv = torch.from_numpy(slab.copy()), torch.from_numpy(slab.copy())
    tl, tsk, tsv = tpaged._forward_spec(
        tparams, tparams["layers"], torch.from_numpy(qtok), tc,
        torch.from_numpy(qpos), torch.from_numpy(base), tsk, tsv, row0, tcfg,
        vis=tvis)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(tsk), np.asarray(jsk), atol=SLAB_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(tsv), np.asarray(jsv), atol=SLAB_TOL,
                               rtol=0)


# -- the batcher -------------------------------------------------------------
@pytest.mark.parametrize("name,kw", SPEC_FORMS,
                         ids=[n for n, _ in SPEC_FORMS])
def test_spec_tokens_match_jax_and_plain(models, jax_runs, port_plain, name,
                                         kw):
    _, _, tcfg, tparams = models
    assert port_plain == jax_runs["plain"][0]
    cb = _port(tparams, tcfg, speculative=True, **kw)
    if kw.get("spec_draft_w8"):
        assert cb._spec_dlayers["q_proj"].dtype == torch.int8
        assert cb._spec_dlayers["q_proj"].shape[0] == 1
    got = _serve(cb, _prompts())
    assert got == port_plain
    assert cb.spec.steps > 0 and cb.alloc.stats()["blocks_in_use"] == 0
    st = cb.spec_stats()
    assert st["enabled"] and st["k"] == cb.spec_k
    if name in JAX_SPEC:
        j = jax_runs[name][1]
        assert cb.spec.as_dict() == j
        assert 0 < j["accepted"] < j["drafted"]       # real rejections
    if kw.get("draft_layers") is None:
        assert cb.spec.accepted_per_sweep() > 1.0     # draft == target


def test_int8_kv_spec_match_floor(models):
    """Spec over an int8 pool reads full-precision slab rows where plain
    decode reads the committed codes, so tokens may differ near a tie:
    the JAX package's floor, a 0.9 match rate, holds here too."""
    _, _, tcfg, tparams = models
    ref = _serve(_port(tparams, tcfg, kv_dtype="int8"), _prompts())
    for kw in (dict(spec_k=3, draft_layers=1), dict(spec_tree=[2, 1, 1])):
        cb = _port(tparams, tcfg, kv_dtype="int8", speculative=True, **kw)
        got = _serve(cb, _prompts())
        n = sum(len(t) for t in ref)
        m = sum(x == y for a, b in zip(ref, got) for x, y in zip(a, b))
        assert m / n >= MATCH_FLOOR, (kw, m, n)
        assert [len(t) for t in got] == [len(t) for t in ref]


@pytest.mark.parametrize("kw", [dict(spec_k=3, draft_layers=1),
                                dict(spec_tree=[2, 1], draft_layers=1)],
                         ids=["chain", "tree"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_rejected_rows_never_write_the_pool(models, kw, kv_dtype):
    """Per spec tick, the pool changes at EXACTLY the accepted rows'
    (block, slot) positions, and an int8 block's scales change only at
    blocks holding accepted rows: a rejected draft row (the truncated
    draft guarantees some) never lands."""
    _, _, tcfg, tparams = models
    cb = _port(tparams, tcfg, speculative=True, kv_dtype=kv_dtype, **kw)
    cb.submit(_prompts()[0])
    cb._admit()
    assert cb.active[0]
    N, rejected = cb.alloc.num_blocks, False
    width = (cb.spec_k if cb.spec_tree is None else len(cb.spec_tree)) + 1
    while cb.active[0]:
        len0, bud0 = int(cb.cache.lengths[0]), cb.budget[0]
        pre = [t[:, :N].clone() for t in (cb.cache.k, cb.cache.v)]
        pre_s = None if cb.cache.k_scale is None else \
            cb.cache.k_scale[:, :N].clone()
        out, n_emit = cb._step_spec()
        n = int(n_emit[0])
        assert 1 <= n <= width
        rejected |= n < min(width, bud0)
        chain = cb.slot_blocks[0]
        expect = {(chain[p // cb.bs], p % cb.bs)
                  for p in range(len0, len0 + n)}
        for a, b in zip(pre, (cb.cache.k, cb.cache.v)):
            changed = {tuple(c) for c in np.argwhere(_np(
                (a != b[:, :N]).any(dim=(0, 3, 4))))}
            if kv_dtype == "fp":
                assert changed == expect
            else:
                # a grown scale rescales the block's older codes too
                assert {blk for blk, _ in changed} <= {b_ for b_, _ in
                                                       expect}
                assert expect <= changed or not n
        if pre_s is not None:
            grew = set(np.argwhere(_np(
                (pre_s != cb.cache.k_scale[:, :N]).any(dim=0))).ravel())
            assert grew <= {blk for blk, _ in expect}
        cb._emit_spec([0], out, n_emit)
    assert rejected


def test_budget_exactness_and_opt_out(models, port_plain):
    """A verify sweep never emits past a request's budget; a request
    submitted with speculative=False decodes plain inside a spec batcher
    (it drafts nothing) with its tokens unchanged, and the opt-out set
    empties as requests retire."""
    _, _, tcfg, tparams = models
    budgets = [1, 2, 3, 8, 5]
    cb = _port(tparams, tcfg, speculative=True, spec_k=4)
    got = _serve(cb, _prompts(), budgets)
    assert [len(t) for t in got] == budgets
    assert got == [t[:n] for t, n in zip(port_plain, budgets)]
    cb = _port(tparams, tcfg, speculative=True, spec_k=3)
    p = _prompts()
    r0 = cb.submit(p[0], speculative=False)
    r1 = cb.submit(p[1])
    cb.run()
    assert [cb.outputs[r0], cb.outputs[r1]] == port_plain[:2]
    assert cb.spec.drafted == cb.spec.steps * cb.spec_k
    assert not cb._no_spec
    # with every active request opted out the batcher decodes plain
    cb = _port(tparams, tcfg, speculative=True, spec_k=3)
    r = cb.submit(p[2], speculative=False)
    cb.run()
    assert cb.outputs[r] == port_plain[2] and cb.spec.steps == 0
    with pytest.raises(ValueError):
        _port(tparams, tcfg, speculative=True, spec_k=0)
    with pytest.raises(ValueError):
        _port(tparams, tcfg, speculative=True, draft_layers=3)


@pytest.mark.parametrize("kw", [dict(speculative=True, spec_tree=[2, 1, 1]),
                                dict(kv_dtype="int8", weight_dtype="int8",
                                     speculative=True, spec_k=3,
                                     draft_layers=1, spec_draft_w8=True)],
                         ids=["tree", "quant_chain"])
def test_engine_serves_and_reports(models, kw):
    """The engine takes the quantization and speculation kwargs, serves
    the batcher's tokens, and reports the resolved config, the byte
    accounting and the acceptance (gauges, and the accept-depth histogram
    holding every depth once)."""
    _, _, tcfg, tparams = models
    ekw = dict(max_batch=2, block_size=4, max_total_len=48,
               max_new_tokens=8, chunk=3, prefill_buckets=(8, 16),
               device="cpu")
    cb = _port(tparams, tcfg, **kw)
    ref = _serve(cb, _prompts())
    eng = ServingEngine(tparams, tcfg, **ekw, **kw)
    try:
        outs = [r.result(300) for r in [eng.submit(p) for p in _prompts()]]
        assert eng.drain(60)
        snap = eng.snapshot()
    finally:
        assert eng.shutdown(timeout=60)
    assert outs == ref
    q = snap["quantization"]
    assert (q["weight_dtype"], q["kv_dtype"]) == \
        (kw.get("weight_dtype", "fp"), kw.get("kv_dtype", "fp"))
    b = eng.batcher
    assert q["kv_bytes_per_token"] == b.kv_bytes_per_token()
    assert q["kv_pool_bytes"] == b.kv_pool_bytes() == \
        snap["gauges"]["kv_pool_bytes"]
    assert q["weight_bytes"] == b.weight_bytes() == \
        snap["gauges"]["weight_bytes"]
    sp = snap["speculative"]
    assert sp["enabled"] and sp["k"] == b.spec_k and sp["steps"] > 0
    assert sp["tokens_per_step"] >= 1.0
    g = snap["gauges"]
    assert g["spec_steps"] == sp["steps"]
    assert g["spec_accept_rate"] == pytest.approx(sp["accept_rate"],
                                                 abs=1e-4)   # as_dict rounds
    assert g["spec_accepted_tokens"] == sp["accepted"]
    h = snap["histograms"]["spec_accept_depth"]
    assert h["count"] == sum(sp["accept_depth_hist"].values())
    assert h["buckets"][-1][1] == h["count"]
    assert g["kv_blocks_in_use"] == 0
