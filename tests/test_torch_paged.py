"""The PyTorch port's paged serving path against the JAX package, on
the CPU: `forward_paged` (cold prefill, then decode through the block
table), `paged_generate`, the `ContinuousBatcher` (bucketed, chunked and
fused prefill, decode chunks) and the sampler.

Both sides run `LlamaConfig.tiny` in float32 with the same weights: the
JAX `init_params` tree carried across by `params_from_numpy`. The JAX
batcher uses its xla attention reference with the prefix cache off; the
port runs its plain versions (a CPU tensor never reaches a kernel).

Tolerances: f32 logits of a 2-layer tiny model agree to 1e-5 absolute
(values are O(0.1); the two frameworks sum matmuls and softmaxes in
different orders, a few ulps per op). Greedy token streams must be
identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402

from paddle_tpu_torch.nlp import generation as tgen  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402

LOGIT_TOL = 1e-5
BATCHER_KW = dict(max_batch=2, block_size=4, max_total_len=40,
                  max_new_tokens=6, chunk=3, prefill_buckets=(8, 16))
# prompt lengths and per-request budgets: 20 tokens chunks at bucket 16,
# staggered budgets retire slots at different steps so admissions land
# while the other slot decodes (fused steps)
LENGTHS = [5, 20, 9, 3, 12, 7]
BUDGETS = [6, 3, 5, 4, 6, 2]


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, 250, n))) for n in LENGTHS]


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jax_batcher_run(models):
    """The JAX batcher's outputs and counters for the shared schedule,
    computed once."""
    jcfg, jparams, _, _ = models
    cb = jpaged.ContinuousBatcher(jparams, jcfg, prefix_cache=False,
                                  attention_impl="xla", **BATCHER_KW)
    rids = [cb.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), BUDGETS)]
    cb.run()
    return {"outputs": [cb.outputs[r] for r in rids],
            "fused_steps": cb.fused_steps,
            "decode_stall_steps": cb.decode_stall_steps,
            "prefill_pad_tokens": cb.prefill_pad_tokens}


def test_params_from_numpy_dtypes(models):
    _, jparams, _, _ = models
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = tllama.LlamaConfig.tiny()                      # bf16 compute
    p = tllama.params_from_numpy(tree, cfg, device="cpu")
    assert p["embed_tokens"].dtype == torch.bfloat16
    assert p["lm_head"].dtype == torch.bfloat16
    assert p["layers"]["q_proj"].dtype == torch.bfloat16
    assert p["layers"]["q_proj"].shape == (2, 64, 64)
    assert p["layers"]["input_layernorm"].dtype == torch.float32
    assert p["norm"].dtype == torch.float32
    n = sum(w.numel() for k, w in p.items() if k != "layers") + sum(
        w.numel() for w in p["layers"].values())
    assert n == tllama.num_params(cfg) == jllama.num_params(
        jllama.LlamaConfig.tiny())


def test_init_params_recipe():
    cfg = tllama.LlamaConfig.tiny()
    g = torch.Generator().manual_seed(0)
    p = tllama.init_params(cfg, g, device="cpu")
    w = p["layers"]["gate_proj"].float()
    assert p["layers"]["gate_proj"].dtype == torch.bfloat16
    assert abs(w.std().item() - 0.02) < 2e-3
    assert torch.equal(p["norm"], torch.ones(64))
    again = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(again["lm_head"], p["lm_head"])


def test_forward_paged_matches_jax(models):
    """Cold prefill of a ragged batch, then two decode steps through the
    block table: logits (valid positions) and the pool contents match."""
    jcfg, jparams, tcfg, tparams = models
    bs, B, P = 4, 2, 6
    lengths = np.array([5, 3])
    rng = np.random.RandomState(1)
    toks = rng.randint(1, 250, (B, P)).astype(np.int32)
    table = np.array([[3, 1, 4], [0, 5, 2]], np.int32)
    N = 6
    L, KV, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, \
        jcfg.head_dim
    jk = jnp.zeros((L, N, bs, KV, hd), jnp.float32)
    jcache = jpaged.PagedKVCache(jk, jk, jnp.asarray(table),
                                 jnp.zeros((B,), jnp.int32))
    tk, tv, _, _ = tpaged.init_pool(tcfg, N, bs, device="cpu")
    tcache = tpaged.PagedKVCache(tk, tv, torch.from_numpy(table),
                                 torch.zeros((B,), dtype=torch.int32))
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    val = pos < lengths[:, None]
    jl, jcache = jpaged.forward_paged(jparams, jnp.asarray(toks), jcache,
                                      jnp.asarray(pos), jnp.asarray(val),
                                      jcfg, is_prefill=True)
    tl, tcache = tpaged.forward_paged(tparams, torch.from_numpy(toks),
                                      tcache, torch.from_numpy(pos),
                                      torch.from_numpy(val), tcfg,
                                      is_prefill=True)
    np.testing.assert_allclose(tl.numpy()[val], np.asarray(jl)[val],
                               atol=LOGIT_TOL, rtol=0)
    cur = lengths.copy()
    tok = np.asarray(jl)[np.arange(B), cur - 1].argmax(-1).astype(np.int32)
    jcache = jcache._replace(lengths=jnp.asarray(cur, jnp.int32))
    tcache = tcache._replace(lengths=torch.from_numpy(cur.astype(np.int32)))
    for _ in range(2):
        dpos = cur[:, None].astype(np.int32)
        dval = np.ones((B, 1), np.bool_)
        jl, jcache = jpaged.forward_paged(
            jparams, jnp.asarray(tok[:, None]), jcache, jnp.asarray(dpos),
            jnp.asarray(dval), jcfg, is_prefill=False, attention_impl="xla")
        tl, tcache = tpaged.forward_paged(
            tparams, torch.from_numpy(tok[:, None]), tcache,
            torch.from_numpy(dpos), torch.from_numpy(dval), tcfg,
            is_prefill=False)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(tcache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
        cur = cur + 1
    # every cached token sits at the same pool slot on both sides; the
    # port's sink block (index N) is past the JAX pool
    for b in range(B):
        for j in range(int(cur[b])):
            blk, off = table[b, j // bs], j % bs
            np.testing.assert_allclose(
                tcache.k[:, blk, off].numpy(),
                np.asarray(jcache.k[:, blk, off]), atol=LOGIT_TOL)
            np.testing.assert_allclose(
                tcache.v[:, blk, off].numpy(),
                np.asarray(jcache.v[:, blk, off]), atol=LOGIT_TOL)
    assert tcache.k.shape[1] == N + 1


def test_paged_generate_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(2)
    toks = rng.randint(1, 250, (3, 7)).astype(np.int32)
    lengths = np.array([7, 2, 5])
    jids, _, _ = jpaged.paged_generate(jparams, jnp.asarray(toks), lengths,
                                       jcfg, max_new_tokens=5, block_size=4,
                                       attention_impl="xla")
    tids, alloc, owned = tpaged.paged_generate(
        tparams, toks, lengths, tcfg, max_new_tokens=5, block_size=4,
        device="cpu")
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids.dtype == torch.int32
    for blocks in owned:
        alloc.free(blocks)
    assert alloc.stats()["blocks_in_use"] == 0


def test_batcher_tokens_identical_to_jax(models, jax_batcher_run):
    """Bucketed prefill, a chunked 20-token prompt, fused admissions and
    decode chunks: the same token streams and scheduler counters."""
    _, _, tcfg, tparams = models
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **BATCHER_KW)
    rids = [cb.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), BUDGETS)]
    cb.run()
    assert [cb.outputs[r] for r in rids] == jax_batcher_run["outputs"]
    assert [len(cb.outputs[r]) for r in rids] == BUDGETS
    assert cb.fused_steps == jax_batcher_run["fused_steps"] >= 1
    assert cb.decode_stall_steps == jax_batcher_run["decode_stall_steps"]
    assert cb.prefill_pad_tokens == jax_batcher_run["prefill_pad_tokens"]
    assert cb.alloc.stats()["blocks_in_use"] == 0


def test_batcher_two_fused_units_match_jax(models):
    """fused_units=2 at max_batch=3: a chunked prompt's chunk and a cold
    prompt of the same bucket ride one fused call (more units than fused
    steps); tokens and counters equal the JAX batcher's."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BATCHER_KW, max_batch=3, fused_units=2)
    rng = np.random.RandomState(3)
    lengths, budgets = [5, 20, 9, 3, 12, 7, 18, 10], [6, 3, 5, 4, 6, 2, 4, 5]
    prompts = [list(map(int, rng.randint(1, 250, n))) for n in lengths]
    runs = []
    for cb in (jpaged.ContinuousBatcher(jparams, jcfg, prefix_cache=False,
                                        attention_impl="xla", **kw),
               tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **kw)):
        rids = [cb.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        cb.run()
        runs.append(([cb.outputs[r] for r in rids], cb.fused_steps,
                     cb.fused_unit_count, cb.prefill_pad_tokens))
    assert runs[1] == runs[0]
    assert runs[1][2] > runs[1][1] >= 1


def test_batcher_unfused_same_tokens(models, jax_batcher_run):
    """fused_prefill=False runs every admission standalone (stalls are
    counted) and emits the same greedy tokens."""
    _, _, tcfg, tparams = models
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  fused_prefill=False, **BATCHER_KW)
    rids = [cb.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), BUDGETS)]
    cb.run()
    assert [cb.outputs[r] for r in rids] == jax_batcher_run["outputs"]
    assert cb.fused_steps == 0 and cb.decode_stall_steps >= 1


def test_batcher_stop_token_and_abort(models, jax_batcher_run):
    """A per-request stop id ends that request at its first emission
    (the stop token included); an aborted request returns its blocks."""
    _, _, tcfg, tparams = models
    ref = jax_batcher_run["outputs"]
    prompts = _prompts()
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **BATCHER_KW)
    stop = ref[0][2]
    r0 = cb.submit(prompts[0], stop_token_id=stop, max_new_tokens=6)
    r1 = cb.submit(prompts[2], max_new_tokens=5)
    r2 = cb.submit(prompts[4], max_new_tokens=6)
    cb.step()
    assert cb.abort(r2)
    cb.run()
    assert cb.outputs[r0] == ref[0][:ref[0].index(stop) + 1]
    assert cb.outputs[r1] == ref[2]
    assert not cb.abort(r2)
    assert cb.alloc.stats()["blocks_in_use"] == 0


def test_batcher_validation(models):
    _, _, tcfg, tparams = models
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **BATCHER_KW)
    with pytest.raises(ValueError):
        cb.submit([1] * 36)                         # 36 + 6 > 40
    with pytest.raises(ValueError):
        cb.submit([])
    with pytest.raises(ValueError):
        cb.submit([1, 2], max_new_tokens=7)
    assert cb.prefill_buckets == (8, 16)
    ladder = tpaged.ContinuousBatcher(tparams, tcfg, max_batch=2,
                                      block_size=4, max_total_len=100,
                                      max_new_tokens=4, device="cpu",
                                      max_prefill_bucket=64)
    assert ladder.prefill_buckets == (8, 16, 32, 64)


def test_entry_points_need_cuda_or_cpu(models):
    """Without CUDA, entry points that default to the card raise instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tparams = models
    with pytest.raises(RuntimeError, match="CUDA"):
        tllama.init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpaged.ContinuousBatcher(tparams, tcfg, **BATCHER_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpaged.paged_generate(tparams, np.ones((1, 3), np.int32), [3], tcfg,
                              max_new_tokens=2, block_size=4)


def test_sample_greedy_and_distribution():
    """Greedy is argmax, exactly JAX's; top-k/top-p draw only from the
    allowed set, with frequencies near the renormalised probabilities
    (torch's random bits differ from jax.random's)."""
    from paddle_tpu.nlp import generation as jgen
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 50).astype(np.float32)
    g = np.asarray(jgen._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                                1.0, 0, 1.0, True))
    t = tgen._sample(torch.from_numpy(logits), None, 1.0, 0, 1.0, True)
    np.testing.assert_array_equal(t.numpy(), g)
    row = np.array([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]], np.float32)
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([tgen._sample(torch.from_numpy(row).repeat(500, 1),
                                    gen, 1.0, 3, 1.0, False)
                       for _ in range(4)]).numpy()
    assert set(np.unique(draws)) <= {0, 1, 2}
    p = np.exp(row[0, :3]) / np.exp(row[0, :3]).sum()
    freq = np.bincount(draws, minlength=3)[:3] / len(draws)
    np.testing.assert_allclose(freq, p, atol=0.04)
    # top-p 0.5 over softmax(row): token 0 alone holds 0.57 of the mass
    tp = tgen._sample(torch.from_numpy(row).repeat(200, 1), gen, 1.0, 0,
                      0.5, False)
    assert set(tp.tolist()) == {0}
