"""The port batcher's memo of step shapes against the JAX batcher's, on
the CPU.

The JAX `ContinuousBatcher` memoizes one AOT executable per step shape
(`_prefill_exe`, `_fused_exe`, `_chunk_exe`, `_spec_draft_exe`,
`_spec_verify_exe`); the port memoizes one CUDA graph per shape on the
card and, on the CPU, the eager step bound to its key. The keys,
`warmup_prefill()`'s return and `compile_count` must be the JAX
package's for the same config. The JAX side's counts come from its own
warmup code with the lowering stubbed out (`_no_lowering`: the memo,
the keys and the reachability rules are JAX's, only the XLA compile is
skipped), so a dozen configs cost no compile time.

The capture itself runs only on the card (`chip_smoke.py` holds the
graphs' tokens to the eager twin's). What the CPU can hold: the pass
before a capture, run on an entry's idle inputs, writes no live block
and moves no live state; the live state tensors stay in place through
admissions, retirements and every step kind; greedy tokens equal the
JAX batcher's; the prefill entry's first tokens (the LM head on the
read rows only) equal the argmax of `forward_paged`'s full logits.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402

from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402

BASE = dict(max_batch=2, block_size=4, max_total_len=32, chunk=3,
            max_new_tokens=6)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, 200, n))) for n in lengths]


class _Lowered:
    """Stands in for a jitted step: `.lower(...)` and `.compile()` give a
    placeholder, so the JAX memo fills without an XLA compile."""

    def lower(self, *args, **kw):
        return self

    def compile(self):
        return object()


def _no_lowering(cb):
    stub = _Lowered()
    cb._prefill_fns = {True: stub, False: stub}
    cb._fused_fn = cb._chunk_fn = stub
    cb._spec_draft_fn = cb._spec_verify_fn = stub
    return cb


def _jax_keys(cb):
    return {name: set(getattr(cb, name)) for name in
            ("_prefill_cache", "_fused_cache", "_chunk_cache",
             "_spec_cache")}


def _port_keys(cb):
    """The port's memo keys with its backend names ("ref" on the CPU)
    spelled as the JAX package's CPU backend ("xla"), and the JAX
    package's mesh key part (() without a mesh) appended."""
    def norm(k):
        return tuple("xla" if x == "ref" else x for x in k)
    return {name: {norm(k) for k in getattr(cb, name)} for name in
            ("_prefill_cache", "_fused_cache", "_chunk_cache",
             "_spec_cache")}


WARMUP_CASES = {
    "prefix": dict(prefix_cache=True),
    "unfused": dict(fused_prefill=False),
    "ladder_4_8": dict(prefill_buckets=(4, 8), prefix_cache=True),
    "unbucketed": dict(prefill_buckets=()),
    "batch4_units2": dict(max_batch=4, fused_units=2),
    "int8": dict(kv_dtype="int8", weight_dtype="int8"),
    "spec_chain": dict(speculative=True, spec_k=3),
    "spec_tree_w8": dict(speculative=True, spec_tree=[2, 1],
                         draft_layers=1, spec_draft_w8=True),
}


@pytest.mark.parametrize("case", list(WARMUP_CASES))
def test_warmup_matches_jax_memo(models, case):
    """warmup_prefill() returns the JAX batcher's count and fills the
    memo with the JAX batcher's keys: the ladder x group sizes x
    {cold, cached}, the reachable fused row counts, the decode chunk,
    and with speculation the draft/verify pair."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BASE, **WARMUP_CASES[case])
    jb = _no_lowering(jpaged.ContinuousBatcher(jparams, jcfg,
                                               attention_impl="xla", **kw))
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **kw)
    assert tb.compile_count == 0
    assert tb.warmup_prefill() == jb.warmup_prefill()
    assert tb.compile_count == jb.compile_count
    assert tb.prefill_compile_count == jb.prefill_compile_count
    jk, tk = _jax_keys(jb), _port_keys(tb)
    for name in jk:
        assert {k + () for k in tk[name]} == jk[name], name
    # every entry is the eager step on the CPU
    for memo in (tb._prefill_cache, tb._fused_cache, tb._chunk_cache,
                 tb._spec_cache):
        assert all(not e.graphed for e in memo.values())
    assert tb.warmup_prefill() == 0                # all there already


def test_warmup_prefill_covers_all_admission_shapes(models):
    """The twin of test_prefill_buckets.py's: 3 buckets x 2 groups x
    {cold, cached} + 3 fused shapes + the decode chunk; with fusion off
    3 x 2 x 2 + 1; and a burst spanning the ladder, then warm repeats,
    adds no entry."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BASE, prefix_cache=True)
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **kw)
    jb = _no_lowering(jpaged.ContinuousBatcher(jparams, jcfg,
                                               attention_impl="xla", **kw))
    warmed = tb.warmup_prefill()
    assert warmed == jb.warmup_prefill() == 3 * 2 * 2 + 3 * 1 + 1
    off = dict(BASE, fused_prefill=False)
    assert tpaged.ContinuousBatcher(
        tparams, tcfg, device="cpu", **off).warmup_prefill() == \
        _no_lowering(jpaged.ContinuousBatcher(
            jparams, jcfg, attention_impl="xla", **off)).warmup_prefill() \
        == 3 * 2 * 2 + 1
    c0 = tb.compile_count
    for p in _prompts(44, (3, 9, 17, 4, 10, 3)):
        tb.submit(p)
    tb.run()
    for p in _prompts(44, (3, 9, 17)):
        tb.submit(p)
    tb.run()
    assert tb.compile_count == c0
    assert tb.prefix_stats()["hits"] > 0


def _mid_decode_schedule(cb, first, rest):
    """Admit `first`, step until it decodes, then land `rest` one step
    apart — every later admission arrives while a slot is decoding."""
    rids = [cb.submit(first)]
    cb.step()
    for p in rest:
        rids.append(cb.submit(p))
        cb.step()
    out = cb.run()
    return [out[r] for r in rids]


def test_no_compiles_after_warmup_with_fusion(models):
    """The twin of test_fused_step.py's: a mixed admission-during-decode
    run (groups, COW, a chunked long prompt) after warmup never adds an
    entry, and its tokens are the JAX batcher's."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BASE, max_new_tokens=8, prefill_buckets=(4, 8),
              prefix_cache=True, fused_prefill=True)
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **kw)
    assert tb.warmup_prefill() == 2 * 2 * 2 + 2 * 1 + 1
    c0 = tb.compile_count
    a, b, long_p = _prompts(84, (5, 7, 19))
    got = _mid_decode_schedule(tb, a, [b, long_p])
    r = tb.submit(a)                          # warm repeat (cache hit)
    again = tb.run()[r]
    assert tb.fused_steps > 0
    assert tb.compile_count == c0
    jb = jpaged.ContinuousBatcher(jparams, jcfg, attention_impl="xla", **kw)
    want = _mid_decode_schedule(jb, a, [b, long_p])
    assert got == want and again == want[0]
    # lazily, the JAX batcher compiled exactly the shapes the port met
    lazy = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **kw)
    assert _mid_decode_schedule(lazy, a, [b, long_p]) == want
    assert _port_keys(lazy)["_prefill_cache"] == \
        _jax_keys(jb)["_prefill_cache"]
    assert lazy.compile_count == jb.compile_count


def test_decode_only_stretch_after_fused_is_warm(models):
    """The twin of test_fused_step.py's: the decode chunk warms with the
    ladder, so a decode-only stretch after a fused one adds nothing."""
    _, _, tcfg, tparams = models
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  **dict(BASE, max_new_tokens=8,
                                         prefill_buckets=(8,)))
    tb.warmup_prefill()
    c0 = tb.compile_count
    assert len(tb._chunk_cache) == 1
    a, b = _prompts(85, (5, 7))
    tb.submit(a)
    tb.step()
    tb.submit(b)
    tb.step()
    assert tb.fused_steps >= 1
    while any(tb.active):
        tb.step()
    assert tb.compile_count == c0


@pytest.mark.parametrize("spec", [dict(spec_k=3),
                                  dict(spec_tree=[2, 1], draft_layers=1)],
                         ids=["chain", "tree"])
def test_speculative_pair_adds_two(models, spec):
    """A spec batcher warms the plain ladder plus the draft and verify
    entries (+2, as the JAX batcher's), and a spec burst after warmup
    adds none."""
    _, _, tcfg, tparams = models
    plain = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **BASE)
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  speculative=True, **spec, **BASE)
    assert tb.warmup_prefill() == plain.warmup_prefill() + 2
    assert len(tb._spec_cache) == 2
    c0 = tb.compile_count
    for p in _prompts(90, (5, 11, 3)):
        tb.submit(p)
    tb.run()
    assert tb.spec.steps > 0
    assert tb.compile_count == c0


def _pool_view(cb):
    c, N = cb.cache, cb.alloc.num_blocks
    out = [c.k[:, :N].clone(), c.v[:, :N].clone()]
    if c.k_scale is not None:
        out += [c.k_scale[:, :N].clone(), c.v_scale[:, :N].clone()]
    return out


def _live_state(cb):
    return [t.clone() for t in (cb.cache.table, cb.cache.lengths, cb.cur_tok,
                                cb._dev_active, cb._dev_budget,
                                cb._dev_stop)]


@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"),
                                dict(speculative=True, spec_k=3),
                                dict(speculative=True, spec_tree=[2, 1],
                                     kv_dtype="int8")],
                         ids=["fp", "int8", "chain", "tree_int8"])
def test_idle_pass_writes_only_the_sink(models, kw):
    """The pass before a capture executes for real, on the entry's idle
    inputs: with requests in flight (the pool holding live K/V, slots
    mid-decode), running every entry's step on its idle inputs leaves
    every allocatable block, every int8 scale and the live slot state
    exactly as they were."""
    _, _, tcfg, tparams = models
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  **dict(BASE, **kw))
    tb.warmup_prefill()
    for p in _prompts(91, (5, 11)):
        tb.submit(p)
    tb.step()
    assert any(tb.active)
    pool, live = _pool_view(tb), _live_state(tb)
    entries = [e for memo in (tb._prefill_cache, tb._fused_cache,
                              tb._chunk_cache, tb._spec_cache)
               for e in memo.values()]
    for e in entries:
        e.fn(**e.idle)
    for a, b in zip(pool, _pool_view(tb)):
        assert torch.equal(a, b)
    for a, b in zip(live, _live_state(tb)):
        assert torch.equal(a, b)
    # and serving carries on to the same tokens as an untouched twin
    out = tb.run()
    twin = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                    **dict(BASE, **kw))
    for p in _prompts(91, (5, 11)):
        twin.submit(p)
    assert out == twin.run()


def test_live_state_stays_in_place(models):
    """A replay reads fixed storage: the table, lengths, current tokens
    and the device mirrors keep their storage through admissions,
    chunked and fused prefills, COW hits, spec ticks and retirements."""
    _, _, tcfg, tparams = models
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  prefix_cache=True, speculative=True,
                                  spec_k=2, **BASE)
    tensors = [tb.cache.table, tb.cache.lengths, tb.cur_tok, tb._dev_active,
               tb._dev_budget, tb._dev_stop, tb._spec_ok, tb.cache.k,
               tb.cache.v]
    ptrs = [t.data_ptr() for t in tensors]
    p = _prompts(92, (8, 19, 6))
    _mid_decode_schedule(tb, p[0], [p[1], p[2], p[0]])
    assert tb.prefix_stats()["hits"] > 0 and tb.spec.steps > 0
    now = [tb.cache.table, tb.cache.lengths, tb.cur_tok, tb._dev_active,
           tb._dev_budget, tb._dev_stop, tb._spec_ok, tb.cache.k, tb.cache.v]
    assert [t.data_ptr() for t in now] == ptrs
    assert all(a is b for a, b in zip(now, tensors))


def test_prefill_entry_reads_only_the_last_rows(models):
    """The prefill entry returns tokens, not logits: the LM head runs on
    each row's last real position only. Its tokens equal the argmax of
    `forward_paged`'s full logits there, and of the JAX package's."""
    jcfg, jparams, tcfg, tparams = models
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **BASE)
    G, Pb = 2, 8
    rng = np.random.RandomState(93)
    rows = rng.randint(1, 200, (G, Pb)).astype(np.int32)
    lens = np.array([5, 8])
    pos = np.broadcast_to(np.arange(Pb), (G, Pb)).astype(np.int32)
    val = pos < lens[:, None]
    tab = np.array([[0, 1, 0, 0, 0, 0, 0, 0], [2, 3, 0, 0, 0, 0, 0, 0]],
                   np.int32)
    last = lens - 1
    got = tb._prefill_exe(G, Pb, True)(
        rows=torch.from_numpy(rows), pos=torch.from_numpy(pos),
        val=torch.from_numpy(val), tab=torch.from_numpy(tab),
        last=torch.from_numpy(last))
    k, v, _, _ = tpaged.init_pool(tcfg, tb.alloc.num_blocks, 4, "cpu")
    logits, _ = tpaged.forward_paged(
        tparams, torch.from_numpy(rows),
        tpaged.PagedKVCache(k, v, torch.from_numpy(tab),
                            torch.zeros(G, dtype=torch.int32)),
        torch.from_numpy(pos), torch.from_numpy(val), tcfg, is_prefill=True)
    full = logits[torch.arange(G), torch.from_numpy(last)]
    assert torch.equal(got, torch.argmax(full, -1).to(torch.int32))
    jk = jnp.zeros((jcfg.num_hidden_layers, tb.alloc.num_blocks, 4,
                    jcfg.num_key_value_heads, jcfg.head_dim), jnp.float32)
    jlogits, _ = jpaged.forward_paged(
        jparams, jnp.asarray(rows),
        jpaged.PagedKVCache(jk, jk, jnp.asarray(tab),
                            jnp.zeros((G,), jnp.int32)),
        jnp.asarray(pos), jnp.asarray(val), jcfg, is_prefill=True,
        attention_impl="xla")
    want = np.asarray(jlogits)[np.arange(G), last]
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5)
    assert got.tolist() == want.argmax(-1).tolist()


def test_step_graph_eager_entry_calls_its_step():
    """On the CPU an entry is the eager step bound to its key: calling it
    runs the step on the caller's tensors, and no graph exists."""
    seen = []

    def fn(x):
        seen.append(x)
        return x + 1

    idle = {"x": torch.zeros(3)}
    e = tpaged._StepGraph(fn, idle, graphed=False)
    x = torch.arange(3.0)
    assert torch.equal(e(x=x), x + 1)
    assert seen == [x] and not e.graphed and e.idle is idle


def test_capture_tally_is_not_touched_by_concurrent_replays():
    """A capture counts into its own thread's tally while other threads
    launch and replay at once: the capture leaves the shared counters
    alone, the replays' additions all land, and the tally holds only the
    capturing thread's launches (the graphs of two replicas on one
    card, one respawning while the other serves)."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.nlp.ragged_attention import ragged_paged_attention

    class _Replayed:
        def replay(self):
            pass

    entry = tpaged._StepGraph(lambda x: x, {"x": torch.zeros(1)},
                              graphed=False)
    entry.graph, entry.static, entry.out = _Replayed(), {"x": torch.zeros(1)}, 0
    entry.deltas = {(flash_attention_fwd, "launches"): 1,
                    (ragged_paged_attention, "launches"): 32}
    n, replayers = 2000, 3
    f0, r0 = flash_attention_fwd.launches, ragged_paged_attention.launches
    tallies, go = [], threading.Barrier(replayers + 1)

    def capture():
        go.wait()
        with _build.capture_tally() as tally:
            for _ in range(n):
                _build.count(ragged_paged_attention)
        tallies.append(dict(tally))

    def replay():
        go.wait()
        for _ in range(n):
            entry(x=torch.zeros(1))
            _build.count(flash_attention_fwd)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=capture)] + [
            threading.Thread(target=replay) for _ in range(replayers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert tallies == [{(ragged_paged_attention, "launches"): n}]
    assert flash_attention_fwd.launches - f0 == replayers * n * 2
    assert ragged_paged_attention.launches - r0 == replayers * n * 32
