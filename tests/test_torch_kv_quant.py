"""The PyTorch port's int8 paged KV against the JAX package, on the CPU.

`quantization.kv` (scale_of, quantize, dequantize, rescale_codes,
kv_block_bytes) must equal the JAX module bit for bit on the same seeded
f32 arrays, zero scales and scale growth included. `_write_pool_int8`
must store the JAX write's codes and scales exactly across a write that
grows the scales, and leave every real block alone for an invalid slot.
Over a tiny f32 Llama, `forward_paged` on an int8 pool and the batcher
with `kv_dtype="int8"` and `weight_dtype="int8"` are held to the JAX
package's (the JAX batcher with its xla attention, prefix cache off):
logits to LOGIT_TOL, greedy tokens identical, the byte accounting equal.

Tolerances: the kv math and the write are exact (both packages compute
the same f32 operations). The forward's K/V come out of matmuls summed in
another order, so a value a few ulps from a rounding midpoint may take
the neighbouring code: codes agree to one step and in all but
CODE_FLIP_FRAC of places, scales to 1e-6 relative, and the logits (O(1))
to 1e-4 absolute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402
from paddle_tpu.quantization import kv as jkv  # noqa: E402

from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402
from paddle_tpu_torch.quantization import kv as tkv  # noqa: E402

LOGIT_TOL = 1e-4
CODE_FLIP_FRAC = 1e-3
BATCHER_KW = dict(max_batch=2, block_size=4, max_total_len=40,
                  max_new_tokens=6, chunk=3, prefill_buckets=(8, 16))
LENGTHS = [5, 20, 9, 3, 12]
BUDGETS = [6, 3, 5, 4, 6]


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, 250, n))) for n in LENGTHS]


@pytest.fixture(scope="module")
def jax_quant_runs(models):
    """The JAX batcher's greedy tokens under int8 KV and under int8
    weights, for the shared schedule, computed once."""
    jcfg, jparams, _, _ = models
    out = {}
    for name, kw in (("kv", {"kv_dtype": "int8"}),
                     ("w8", {"weight_dtype": "int8"})):
        cb = jpaged.ContinuousBatcher(jparams, jcfg, prefix_cache=False,
                                      attention_impl="xla", **kw,
                                      **BATCHER_KW)
        rids = [cb.submit(p, max_new_tokens=n)
                for p, n in zip(_prompts(), BUDGETS)]
        cb.run()
        out[name] = [cb.outputs[r] for r in rids]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_math_bit_equal(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(7, 4, 3, 16) * rng.uniform(0.01, 30, (7, 1, 1, 1))
         ).astype(np.float32)
    x[2] = 0.0                                   # a never-written block
    amax = np.abs(x).max(axis=(1, 2, 3))
    js, ts = jkv.scale_of(jnp.asarray(amax)), tkv.scale_of(
        torch.from_numpy(amax))
    np.testing.assert_array_equal(_np(js), _np(ts))
    assert _np(ts)[2] == 0.0
    b = (slice(None), None, None, None)
    jc = jkv.quantize(jnp.asarray(x), js[b])
    tc = tkv.quantize(torch.from_numpy(x), ts[b])
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(_np(jc), _np(tc))
    assert np.abs(_np(tc)).max() <= 127
    assert not _np(tc)[2].any()
    jd, td = jkv.dequantize(jc, js[b]), tkv.dequantize(tc, ts[b])
    np.testing.assert_array_equal(_np(jd), _np(td))
    assert not _np(td)[2].any()                  # scale 0: exact zeros
    # growth: some blocks grow, some keep their scale (an exact identity),
    # the zero block gets its first scale
    grow = np.where(rng.rand(7) < 0.5, 1.0,
                    rng.uniform(1.0, 4.0, 7)).astype(np.float32)
    new = (_np(ts) * grow).astype(np.float32)
    new[2] = 0.7
    jr = jkv.rescale_codes(jc, js[b], jnp.asarray(new)[b])
    tr = tkv.rescale_codes(tc, ts[b], torch.from_numpy(new)[b])
    np.testing.assert_array_equal(_np(jr), _np(tr))
    same = grow == 1.0
    np.testing.assert_array_equal(_np(tr)[same], _np(tc)[same])
    # and a rescale to scale 0 (nothing written) keeps the codes
    z = np.zeros(7, np.float32)
    np.testing.assert_array_equal(
        _np(tkv.rescale_codes(tc, ts[b], torch.from_numpy(z)[b])), _np(tc))


@pytest.mark.parametrize("L,bs,KV,hd,isz", [(2, 4, 2, 16, 4), (32, 16, 8, 128, 2),
                                           (11, 64, 8, 128, 2)])
def test_kv_block_bytes(L, bs, KV, hd, isz):
    for dt in ("fp", "int8", None):
        assert tkv.kv_block_bytes(L, bs, KV, hd, dt, isz) == \
            jkv.kv_block_bytes(L, bs, KV, hd, dt, isz)
    fp = tkv.kv_block_bytes(L, bs, KV, hd, "fp", 2)
    assert tkv.kv_block_bytes(L, bs, KV, hd, "int8") == fp // 2 + L * 8
    for bad in ("int4", "bf16"):
        with pytest.raises(ValueError):
            tkv.resolve_kv_dtype(bad)
        with pytest.raises(ValueError):
            jkv.resolve_kv_dtype(bad)
    assert tkv.KV_DTYPES == jkv.KV_DTYPES and tkv.BOUND == jkv.BOUND


def test_write_pool_int8_matches_jax():
    """Three writes through the block table: a prefill of two ragged rows
    (scales set), a decode step of larger values (scales grow, the
    blocks' codes rescale), and an invalid slot of huge values (no real
    block changes). Codes, scales and the returned dequantized rows
    equal JAX's after each."""
    N, bs, KV, hd = 6, 4, 2, 8
    rng = np.random.RandomState(3)
    table = np.array([[4, 1, 3], [0, 5, 2]], np.int32)
    steps = []
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    steps.append((pos, pos < np.array([[5], [3]]), 0.5))
    steps.append((np.array([[5], [3]], np.int32), np.ones((2, 1), bool),
                  3.0))
    steps.append((np.array([[6], [4]], np.int32),
                  np.array([[False], [False]]), 1e3))
    jp = jnp.zeros((N, bs, KV, hd), jnp.int8)
    js = jnp.zeros((N,), jnp.float32)
    tp = torch.zeros((N + 1, bs, KV, hd), dtype=torch.int8)
    ts = torch.zeros((N + 1,), dtype=torch.float32)
    tt = torch.from_numpy(table)
    for pos, val, mag in steps:
        new = (rng.randn(2, pos.shape[1], KV, hd) * mag).astype(np.float32)
        js0 = _np(js).copy()
        jp, js, jdq = jpaged._write_pool_int8(
            jp, js, jnp.asarray(table), jnp.asarray(pos), jnp.asarray(new),
            jnp.asarray(val))
        slots = tpaged._pool_slots(tt, torch.from_numpy(pos),
                                   torch.from_numpy(val), N, bs)
        tdq = tpaged._write_pool_int8(tp, ts, slots, torch.from_numpy(new))
        np.testing.assert_array_equal(_np(tp)[:N], _np(jp))
        np.testing.assert_array_equal(_np(ts)[:N], _np(js))
        np.testing.assert_array_equal(_np(tdq)[val], _np(jdq)[val])
        if not val.any():
            np.testing.assert_array_equal(_np(ts)[:N], js0)
    assert (_np(ts)[:N] > 0).sum() == 3          # blocks 4, 1 and 0


def test_forward_paged_int8_matches_jax(models):
    """Cold prefill of a ragged batch, then two decode steps through the
    table, both over int8 pools: logits of the valid positions, the
    codes and the scales match JAX's."""
    jcfg, jparams, tcfg, tparams = models
    bs, B, P, N = 4, 2, 6, 6
    lengths = np.array([5, 3])
    rng = np.random.RandomState(1)
    toks = rng.randint(1, 250, (B, P)).astype(np.int32)
    table = np.array([[3, 1, 4], [0, 5, 2]], np.int32)
    k, v, ks, vs = jpaged.init_pool(jcfg, N, bs, kv_dtype="int8")
    jcache = jpaged.PagedKVCache(k, v, jnp.asarray(table),
                                 jnp.zeros((B,), jnp.int32), ks, vs)
    tk, tv, tks, tvs = tpaged.init_pool(tcfg, N, bs, device="cpu",
                                        kv_dtype="int8")
    assert tk.dtype == torch.int8 and tks.shape == (2, N + 1)
    tcache = tpaged.PagedKVCache(tk, tv, torch.from_numpy(table),
                                 torch.zeros((B,), dtype=torch.int32), tks,
                                 tvs)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    val = pos < lengths[:, None]
    calls = [(toks, pos, val, True)]
    for step in range(2):
        dpos = (lengths + step)[:, None].astype(np.int32)
        calls.append((rng.randint(1, 250, (B, 1)).astype(np.int32), dpos,
                      np.ones((B, 1), bool), False))
    for tk_, ps, vl, cold in calls:
        jl, jcache = jpaged.forward_paged(
            jparams, jnp.asarray(tk_), jcache, jnp.asarray(ps),
            jnp.asarray(vl), jcfg, is_prefill=cold, attention_impl="xla")
        tl, tcache = tpaged.forward_paged(
            tparams, torch.from_numpy(tk_), tcache, torch.from_numpy(ps),
            torch.from_numpy(vl), tcfg, is_prefill=cold)
        np.testing.assert_allclose(_np(tl)[vl], np.asarray(jl)[vl],
                                   atol=LOGIT_TOL, rtol=0)
        for tpool, jpool in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            d = np.abs(_np(tpool)[:, :N].astype(np.int32)
                       - np.asarray(jpool).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= CODE_FLIP_FRAC
        for ts_, js_ in ((tcache.k_scale, jcache.k_scale),
                         (tcache.v_scale, jcache.v_scale)):
            np.testing.assert_allclose(_np(ts_)[:, :N], np.asarray(js_),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,kw", [("kv", {"kv_dtype": "int8"}),
                                     ("w8", {"weight_dtype": "int8"})])
def test_quantized_batcher_tokens_match_jax(models, jax_quant_runs, name,
                                            kw):
    _, _, tcfg, tparams = models
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **kw,
                                  **BATCHER_KW)
    rids = [cb.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), BUDGETS)]
    cb.run()
    assert [cb.outputs[r] for r in rids] == jax_quant_runs[name]
    assert cb.alloc.stats()["blocks_in_use"] == 0


@pytest.mark.parametrize("wd,kd", [(None, None), (None, "int8"),
                                   ("int8", None), ("int8", "int8")])
def test_byte_accounting_matches_jax(models, wd, kd):
    """kv_block_bytes / kv_pool_bytes / kv_bytes_per_token / weight_bytes
    equal the JAX batcher's (codes plus scales for an int8 tree); the
    pool tensors hold kv_pool_bytes plus the write sink's block."""
    jcfg, jparams, tcfg, tparams = models
    jb = jpaged.ContinuousBatcher(jparams, jcfg, prefix_cache=False,
                                  weight_dtype=wd, kv_dtype=kd, **BATCHER_KW)
    tb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  weight_dtype=wd, kv_dtype=kd, **BATCHER_KW)
    for name in ("kv_block_bytes", "kv_pool_bytes", "kv_bytes_per_token",
                 "weight_bytes"):
        assert getattr(tb, name)() == getattr(jb, name)(), name
    c = tb.cache
    held = sum(t.numel() * t.element_size()
               for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None)
    assert held == tb.kv_pool_bytes() + tb.kv_block_bytes()
    if kd == "int8":
        assert tb.kv_bytes_per_token() < 0.55 * tpaged.ContinuousBatcher(
            tparams, tcfg, device="cpu", **BATCHER_KW).kv_bytes_per_token()
    if wd == "int8":
        assert tb.params["layers"]["q_proj"].dtype == torch.int8
        assert "lm_head:scale" in tb.params
        # a tree that already holds codes passes through unchanged
        again = tpaged.ContinuousBatcher(tb.params, tcfg, device="cpu",
                                         weight_dtype="int8", **BATCHER_KW)
        assert again.params["layers"]["q_proj"] is \
            tb.params["layers"]["q_proj"]


def test_admission_resets_recycled_scales(models):
    """A recycled block keeps its last tenant's scale until an admission
    takes it: then its scales return to 0 in every layer, and no other
    block's change."""
    _, _, tcfg, tparams = models
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  kv_dtype="int8", **BATCHER_KW)
    cb.cache.k_scale.fill_(5.0)
    cb.cache.v_scale.fill_(5.0)
    cb.submit(_prompts()[1])
    cb._drain_queue()
    blocks = cb._pending[0][0].blocks
    other = [b for b in range(cb.alloc.num_blocks) if b not in blocks]
    for s in (cb.cache.k_scale, cb.cache.v_scale):
        assert not s[:, blocks].any()
        assert (s[:, other] == 5.0).all()
    with pytest.raises(ValueError):
        tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                 kv_dtype="int4", **BATCHER_KW)
    with pytest.raises(ValueError):
        tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                 weight_dtype="int4", **BATCHER_KW)
