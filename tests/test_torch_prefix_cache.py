"""Prefix caching in the port against the JAX package, on the CPU.

Three layers, as tests/test_prefix_cache.py has them:

  * `RefcountingBlockAllocator` units against the port's class (share /
    release refcounts, double-free detection, cached-LRU parking and
    revival, eviction order and callback, no half-applied call), and one
    random sequence of calls through both packages' allocators with the
    same results at every step;
  * `PrefixCacheIndex` units against the port's own copy;
  * the batcher: greedy tokens and allocator / prefix statistics of the
    port's batcher equal the JAX batcher's on the same schedule — a
    shared prefix, a copy-on-write full hit, generated tokens cached, LRU
    eviction under pool pressure, the COW degrade in an exactly full
    pool, the cached-aware defer — and the two twins that waited for
    prefix caching: speculation over a warm prefix cache, and a COW full
    hit over the int8 pool with its scales copied with the block.

Both sides run `LlamaConfig.tiny` in float32 with the same weights; the
JAX batcher uses its xla attention reference, the port its plain
versions. Tokens must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402
from paddle_tpu.serving.cache import PrefixCacheIndex as JIndex  # noqa: E402

from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402
from paddle_tpu_torch.serving.cache import PrefixCacheIndex  # noqa: E402

Alloc = tpaged.RefcountingBlockAllocator


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


# ---------------------------------------------------------------- allocator
def test_allocate_release_lifecycle():
    alloc = Alloc(4)
    blocks = alloc.allocate(2)
    assert all(alloc.refcount(b) == 1 for b in blocks)
    assert alloc.free_blocks == 2
    alloc.share(blocks)
    assert all(alloc.refcount(b) == 2 for b in blocks)
    alloc.release(blocks)
    assert all(alloc.refcount(b) == 1 for b in blocks)
    assert alloc.free_blocks == 2
    alloc.release(blocks)
    assert alloc.free_blocks == 4
    assert alloc.stats()["blocks_in_use"] == 0


def test_double_release_raises():
    alloc = Alloc(2)
    b = alloc.allocate(1)
    alloc.release(b)
    with pytest.raises(ValueError, match="double free"):
        alloc.release(b)
    with pytest.raises(ValueError, match="out of range"):
        alloc.release([9])
    with pytest.raises(ValueError, match="double free"):
        alloc.free(b)
    plain = tpaged.BlockAllocator(2)
    got = plain.allocate(1)
    plain.release(got)                       # release() is free() here
    with pytest.raises(ValueError, match="double free"):
        plain.free(got)
    with pytest.raises(ValueError, match="out of range"):
        plain.free([-1])


def test_share_requires_live_or_cached():
    alloc = Alloc(2)
    with pytest.raises(ValueError, match="neither"):
        alloc.share([0])


def test_cached_parking_and_revival():
    alloc = Alloc(2)
    b = alloc.allocate(1)
    alloc.mark_cached(b)
    alloc.release(b)
    assert alloc.is_cached(b[0])
    assert alloc.free_blocks == 2
    assert alloc.stats()["blocks_in_use"] == 0
    assert alloc.stats()["cached_blocks"] == 1
    alloc.share(b)
    assert alloc.refcount(b[0]) == 1
    assert not alloc.is_cached(b[0])
    alloc.release(b)
    assert alloc.is_cached(b[0])


def test_lru_eviction_order_and_callback():
    evicted = []
    alloc = Alloc(3, on_evict=evicted.append)
    blocks = alloc.allocate(3)
    alloc.mark_cached(blocks)
    for b in blocks:
        alloc.release([b])
    got = alloc.allocate(2)
    assert evicted == blocks[:2]
    assert sorted(got) == sorted(blocks[:2])
    assert alloc.evicted_blocks == 2
    assert alloc.is_cached(blocks[2])


def test_allocate_prefers_free_over_cached():
    alloc = Alloc(3, on_evict=lambda b: None)
    b = alloc.allocate(1)
    alloc.mark_cached(b)
    alloc.release(b)
    alloc.allocate(2)
    assert alloc.is_cached(b[0])
    assert alloc.evicted_blocks == 0


def test_exhaustion_counts_cached():
    alloc = Alloc(2)
    alloc.allocate(2)
    with pytest.raises(RuntimeError, match="pool exhausted"):
        alloc.allocate(1)


def test_release_never_half_applies():
    alloc = Alloc(4)
    good = alloc.allocate(2)
    with pytest.raises(ValueError, match="out of range"):
        alloc.release([good[0], 99])
    with pytest.raises(ValueError, match="double free"):
        alloc.release([good[0], good[0]])
    assert all(alloc.refcount(b) == 1 for b in good)
    alloc.release(good)
    assert alloc.free_blocks == 4


def test_share_never_half_applies():
    alloc = Alloc(4)
    good = alloc.allocate(1)
    with pytest.raises(ValueError, match="neither"):
        alloc.share([good[0], 2])
    assert alloc.refcount(good[0]) == 1


def test_allocator_sequence_matches_jax():
    """A seeded random sequence of allocate / share / mark_cached /
    release through both packages' refcounting allocators: the same
    blocks, refcounts, evictions (in order), errors and stats."""
    rng = np.random.RandomState(7)
    ev_j, ev_t = [], []
    ja = jpaged.RefcountingBlockAllocator(8, on_evict=ev_j.append)
    ta = Alloc(8, on_evict=ev_t.append)
    held = []
    for _ in range(300):
        op = rng.randint(4)
        if op == 0:
            n = int(rng.randint(1, 4))
            res = []
            for a in (ja, ta):
                try:
                    res.append(a.allocate(n))
                except RuntimeError as e:
                    res.append(type(e))
            assert res[0] == res[1]
            if isinstance(res[1], list):
                held.append(res[1])
        elif op == 1 and held:
            b = held[rng.randint(len(held))]
            for a in (ja, ta):
                a.share(b)
            held.append(b)
        elif op == 2 and held:
            b = held[rng.randint(len(held))]
            for a in (ja, ta):
                a.mark_cached(b)
        elif held:
            b = held.pop(rng.randint(len(held)))
            for a in (ja, ta):
                a.release(list(reversed(b)))
        assert ja.stats() == ta.stats()
        assert [ja.refcount(i) for i in range(8)] == \
            [ta.refcount(i) for i in range(8)]
        assert ja.free_blocks == ta.free_blocks
    assert ev_j == ev_t and ev_t


# -------------------------------------------------------------------- index
def test_match_insert_roundtrip():
    idx = PrefixCacheIndex(4)
    toks = list(range(100, 112))
    assert idx.match(toks) == []
    assert idx.insert(toks, [7, 8, 9]) == [7, 8, 9]
    assert idx.match(toks) == [7, 8, 9]
    assert idx.match(toks[:8]) == [7, 8]
    assert idx.match(toks[:7]) == [7]
    assert idx.match(toks[:3]) == []
    assert idx.match(toks[:4] + [1, 2, 3, 4]) == [7]


def test_insert_first_writer_wins():
    idx = PrefixCacheIndex(2)
    assert idx.insert([1, 2], [0]) == [0]
    assert idx.insert([1, 2, 3, 4], [5, 6]) == [6]
    assert idx.match([1, 2, 3, 4]) == [0, 6]


def test_insert_rejects_partial_blocks():
    idx = PrefixCacheIndex(4)
    with pytest.raises(ValueError, match="full blocks"):
        idx.insert([1, 2, 3], [0])
    with pytest.raises(ValueError):
        PrefixCacheIndex(0)


def test_evict_unlinks_and_orphans_descendants():
    idx = PrefixCacheIndex(2)
    idx.insert([1, 2, 3, 4, 5, 6], [0, 1, 2])
    idx.evict(1)
    assert idx.match([1, 2, 3, 4, 5, 6]) == [0]
    assert len(idx) == 2
    idx.evict(2)
    assert len(idx) == 1
    idx.evict(2)
    assert idx.evicted_blocks == 2
    assert idx.unlink(0) and not idx.unlink(0)
    assert idx.evicted_blocks == 2          # unlink is not an eviction


def test_admission_stats_match_jax():
    t, j = PrefixCacheIndex(4), JIndex(4)
    for idx in (t, j):
        idx.insert(list(range(12)), [3, 4, 5])
        idx.note_admission(10, 8)
        idx.note_admission(10, 0)
        idx.evict(4)
    s = t.stats()
    assert (s["hits"], s["misses"]) == (1, 1)
    assert s["hit_tokens"] == 8 and s["prompt_tokens"] == 20
    assert t.hit_rate == pytest.approx(0.4)
    assert s == j.stats()


# ------------------------------------------------------------------ batcher
def _run_both(models, prompts, rounds=1, max_new=6, port_only=False,
              **kw):
    """Serve `prompts` (`rounds` times, each round drained before the
    next) through a JAX and a port batcher of the same config; returns
    the tokens of each and both batchers (the JAX ones None with
    `port_only`)."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(dict(max_batch=2, block_size=4, max_total_len=32, chunk=3),
              **kw)
    jb = None if port_only else jpaged.ContinuousBatcher(
        jparams, jcfg, attention_impl="xla", max_new_tokens=max_new, **kw)
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  max_new_tokens=max_new, **kw)
    outs = [None]
    for cb in (jb, tb):
        if cb is None:
            continue
        got = []
        for _ in range(rounds):
            rids = [cb.submit(p) for p in prompts]
            out = cb.run()
            got.append([out[r] for r in rids])
        outs.append(got)
    return outs[-2], outs[-1], jb, tb


def _same_stats(jb, tb):
    assert tb.prefix_stats() == jb.prefix_stats()
    assert tb.alloc.stats() == jb.alloc.stats()


def test_shared_prefix_matches_cold(models):
    rng = np.random.RandomState(11)
    common = list(map(int, rng.randint(1, 200, 8)))
    prompts = [common + list(map(int, rng.randint(1, 200, n)))
               for n in (3, 5, 2)]
    want, got, jb, tb = _run_both(models, prompts, prefix_cache=True)
    assert got == want
    _same_stats(jb, tb)
    st = tb.prefix_stats()
    assert st["hits"] >= 2 and st["hit_tokens"] >= 16
    astats = tb.alloc.stats()
    assert astats["blocks_in_use"] == 0 and astats["cached_blocks"] > 0
    _, cold, _, _ = _run_both(models, prompts, port_only=True)
    assert got == cold


def test_full_hit_cow_matches_cold(models):
    """A prompt cached whole (a multiple of block_size, served before)
    copies its last block and recomputes only its last token."""
    rng = np.random.RandomState(12)
    p = list(map(int, rng.randint(1, 200, 8)))
    want, got, jb, tb = _run_both(models, [p], rounds=2, max_batch=1,
                                  prefix_cache=True)
    assert got == want and got[0] == got[1]
    assert tb.prefix_stats()["hit_tokens"] == len(p) - 1
    _same_stats(jb, tb)
    assert tb.alloc.stats()["blocks_in_use"] == 0


def test_generated_tokens_are_cached_too(models):
    """Retirement registers FULL blocks of prompt + generated KV: a
    follow-up prompt equal to prompt + generated (the multi-turn
    pattern) hits past the original prompt."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(13)
    p = list(map(int, rng.randint(1, 200, 6)))
    extra = list(map(int, rng.randint(1, 200, 3)))
    res = []
    for cb in (jpaged.ContinuousBatcher(
                   jparams, jcfg, attention_impl="xla", max_batch=1,
                   block_size=4, max_total_len=32, max_new_tokens=6,
                   chunk=3, prefix_cache=True),
               tpaged.ContinuousBatcher(
                   tparams, tcfg, device="cpu", max_batch=1, block_size=4,
                   max_total_len=32, max_new_tokens=6, chunk=3,
                   prefix_cache=True)):
        r1 = cb.submit(p)
        out1 = cb.run()[r1]
        hit0 = cb.prefix_stats()["hit_tokens"]
        r2 = cb.submit(p + out1 + extra)
        out2 = cb.run()[r2]
        res.append((out1, out2, cb.prefix_stats()["hit_tokens"] - hit0))
        last = cb
    assert res[0] == res[1]
    assert res[1][2] == 8            # (6 + 6 - 1) // 4 = 2 full blocks
    assert last.prefix_stats()["hit_tokens"] > 0


def test_eviction_under_pool_pressure(models):
    """A pool too small to cache every retired request evicts LRU cached
    blocks and keeps serving the JAX batcher's tokens."""
    rng = np.random.RandomState(14)
    prompts = [list(map(int, rng.randint(1, 200, 8))) for _ in range(4)]
    want, got, jb, tb = _run_both(models, prompts, max_new=4,
                                  max_total_len=16, chunk=2, num_blocks=6,
                                  prefix_cache=True)
    assert got == want
    assert tb.prefix_stats()["evictions"] > 0
    _same_stats(jb, tb)
    assert tb.alloc.stats()["blocks_in_use"] == 0


def test_full_hit_cow_degrades_in_exactly_full_pool(models):
    """A whole-prompt hit whose COW source is cached needs one pool unit
    more than blocks_needed() promised: in a pool sized for exactly one
    request admission recomputes the final block instead of raising."""
    rng = np.random.RandomState(17)
    p = list(map(int, rng.randint(1, 200, 8)))
    want, got, jb, tb = _run_both(models, [p], rounds=2, max_new=4,
                                  max_batch=1, max_total_len=16, chunk=2,
                                  num_blocks=3, prefix_cache=True)
    assert got == want and got[0] == got[1]
    _same_stats(jb, tb)
    assert tb.alloc.stats()["blocks_in_use"] == 0


def test_cached_aware_defer_admits_on_shared_blocks(models):
    """blocks_needed(tokens=...) discounts blocks an in-flight sibling
    pins: two 11-token prompts sharing 2 full blocks fit together in an
    8-block pool that could not hold two cold copies."""
    _, _, tcfg, tparams = models
    rng = np.random.RandomState(15)
    common = list(map(int, rng.randint(1, 200, 8)))
    prompts = [common + list(map(int, rng.randint(1, 200, 3)))
               for _ in range(2)]
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", max_batch=2,
                                  block_size=4, max_total_len=32,
                                  max_new_tokens=6, chunk=3, num_blocks=8,
                                  prefix_cache=True)
    r1, r2 = [tb.submit(p) for p in prompts]
    tb.step()
    assert tb.active == [True, True]
    assert tb.alloc.stats()["blocks_in_use"] == 8
    out = tb.run()
    _, want, _, _ = _run_both(models, prompts, port_only=True)
    assert [out[r1], out[r2]] == want[0]


def test_abort_pending_requeues_poisoned_siblings(models):
    """Aborting a pending admission whose registered blocks a co-pending
    sibling matched rolls the sibling back onto the queue front (it must
    not skip a prefix no one will compute), and serving then gives the
    cold tokens."""
    _, _, tcfg, tparams = models
    rng = np.random.RandomState(18)
    common = list(map(int, rng.randint(1, 200, 8)))
    a, b = (common + list(map(int, rng.randint(1, 200, n)))
            for n in (3, 5))
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", max_batch=2,
                                  block_size=4, max_total_len=32,
                                  max_new_tokens=6, chunk=3,
                                  prefix_cache=True)
    ra, rb = tb.submit(a), tb.submit(b)
    tb._drain_queue()
    assert tb._pending[1][0].matched               # b leans on a's blocks
    assert tb.abort(ra)
    assert not tb._pending and tb.queue[0][0] == rb
    out = tb.run()
    _, want, _, _ = _run_both(models, [b], port_only=True)
    assert out[rb] == want[0][0]
    assert tb.alloc.stats()["blocks_in_use"] == 0


def test_bit_identical_prefix_cache_warm(models):
    """The twin of test_speculative.py's: speculation over a warm prefix
    cache — the second round hits the first round's blocks — gives the
    JAX plain batcher's tokens, and the acceptance counters of the JAX
    spec batcher."""
    rng = np.random.RandomState(19)
    common = list(map(int, rng.randint(1, 200, 8)))
    prompts = [common + list(map(int, rng.randint(1, 200, n)))
               for n in (3, 6)]
    _, plain, _, _ = _run_both(models, prompts, port_only=True)
    want, got, jb, tb = _run_both(models, prompts, rounds=2,
                                  prefix_cache=True, speculative=True,
                                  spec_k=3)
    assert got == want == [plain[0], plain[0]]
    assert tb.prefix_stats()["hit_tokens"] > 0
    assert tb.spec.as_dict() == jb.spec.as_dict()
    _same_stats(jb, tb)


def test_cow_full_hit_under_int8(models):
    """The twin of test_quantized_serving.py's: a COW full hit over the
    int8 pool copies the source block's scales with its codes, so the
    warm request decodes the cold request's tokens; the JAX batcher's
    tokens and statistics; and the clone's scales equal its source's."""
    rng = np.random.RandomState(20)
    p = list(map(int, rng.randint(1, 200, 8)))
    want, got, jb, tb = _run_both(models, [p], rounds=2, max_batch=1,
                                  prefix_cache=True, kv_dtype="int8")
    assert got == want and got[0] == got[1]
    assert tb.prefix_stats()["hit_tokens"] == len(p) - 1
    _same_stats(jb, tb)
    # the COW path in isolation: prepare a full hit, apply the clone
    r = tb.submit(p)
    tb._drain_queue()
    rec = tb._pending[0][0]
    assert rec.cow_src is not None
    tb._apply_cow([rec])
    c = tb.cache
    for pool in (c.k, c.v, c.k_scale, c.v_scale):
        assert torch.equal(pool[:, rec.fresh[0]], pool[:, rec.cow_src])
    assert c.k_scale[:, rec.cow_src].any()
    tb.run()
    assert tb.outputs[r] == want[0][0]
