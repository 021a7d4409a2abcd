"""Serving an f16 model, and the 8-bit trainers over f32 and f16
parameters, through the port against the JAX package, on the CPU.

On the card these paths run rows 14, 15, 17 and 18 in f16 and f32
(`chip_smoke.py`'s serve_f16, serve_f32, train_p32, train_moe_f32 and
train_moe_f16); on the CPU every wrapper runs its plain version, and the
same weights go through both packages: numpy draws of the JAX
`init_params` trees' shapes and dtypes (its recipe: N(0, 0.02) weights,
unit norm scales), carried across by `params_from_numpy`.

Serving (`LlamaConfig.tiny(dtype=float16)`): greedy tokens of
`paged_generate` and of the `ContinuousBatcher` with int8 KV and a
speculative chain must equal the JAX package's (its xla attention), as
the f32 and bf16 tests require.

Training, two 8-bit steps (the fused AdamW; JAX: its Pallas kernels in
interpret mode) with a warm-up of 2 (lr 0, then 5e-4): the tiny Llama at
bf16 compute over f32 parameters (`param_dtype=float32`, the JAX
default) and the tiny MoE at `dtype=param_dtype=float16`. Each side
rounds activations to the compute dtype at its own points, so losses
agree to 1e-4 relative and grad norms to 2e-3; the parameters keep their
dtype, and an element whose Adam direction that rounding noise decides
may move by a whole step the other way: at most 1 % of a leaf's
elements lie more than 1e-4 apart, none by more than 2.5 times the
learning rate taken (a sign flip moves an element by twice its update,
and at the second step m̂/sqrt(v̂) may exceed 1 slightly).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags  # noqa: E402
from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import moe as jmoe  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402
from paddle_tpu.nlp import train as jtrain  # noqa: E402

from paddle_tpu_torch.kernels import moe_dispatch as tmd  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import moe as tmoe  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402
from paddle_tpu_torch.nlp import ragged_attention as tra  # noqa: E402
from paddle_tpu_torch.nlp import train as ttrain  # noqa: E402
from paddle_tpu_torch.optimizer import quant_state as tqs  # noqa: E402

BATCHER_KW = dict(max_batch=2, block_size=4, max_total_len=40,
                  max_new_tokens=6, chunk=3, prefill_buckets=(8,))
LR = 1e-3
LR_TAKEN = 5e-4          # warm-up over 2 steps from 0: lr 0, then 5e-4


def _tree(jmod, jcfg, seed):
    """A tree of the JAX `init_params`'s structure, shapes and dtypes
    (read by `jax.eval_shape`, nothing compiled), drawn by numpy as its
    recipe draws: N(0, 0.02) weights, ones for the norm scales."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmod.init_params(jax.random.PRNGKey(0),
                                                     jcfg))

    def draw(path, leaf):
        name = str(path[-1])
        if "norm" in name:
            return np.ones(leaf.shape, leaf.dtype)
        return (0.02 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def f16_models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float16)
    tree = _tree(jllama, jcfg, 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float16)
    return jcfg, jparams, tcfg, tllama.params_from_numpy(tree, tcfg,
                                                         device="cpu")


def test_paged_generate_f16_matches_jax(f16_models):
    jcfg, jparams, tcfg, tparams = f16_models
    toks = np.random.RandomState(2).randint(1, 250, (3, 7)).astype(np.int32)
    lengths = np.array([7, 2, 5])
    jids, _, _ = jpaged.paged_generate(jparams, jnp.asarray(toks), lengths,
                                       jcfg, max_new_tokens=8, block_size=4,
                                       attention_impl="xla")
    tids, alloc, owned = tpaged.paged_generate(
        tparams, toks, lengths, tcfg, max_new_tokens=8, block_size=4,
        device="cpu")
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    for blocks in owned:
        alloc.free(blocks)
    assert alloc.stats()["blocks_in_use"] == 0


def test_batcher_f16_int8_spec_matches_jax(f16_models):
    """The batcher over an int8 pool with a speculative chain of 3, in
    f16: the same greedy tokens as the JAX spec batcher, and the port's
    plain f16 batcher (an f16 pool, no speculation) the same again."""
    jcfg, jparams, tcfg, tparams = f16_models
    rng = np.random.RandomState(5)
    prompts = [list(map(int, rng.randint(1, 250, n))) for n in (5, 7)]
    kw = dict(kv_dtype="int8", speculative=True, spec_k=3)

    def serve(cb):
        rids = [cb.submit(p) for p in prompts]
        cb.run()
        return [list(cb.outputs[r]) for r in rids]

    want = serve(jpaged.ContinuousBatcher(jparams, jcfg, prefix_cache=False,
                                          attention_impl="xla", **kw,
                                          **BATCHER_KW))
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu", **kw,
                                  **BATCHER_KW)
    assert cb.cache.k.dtype == torch.int8
    assert serve(cb) == want
    assert cb.spec.steps > 0 and cb.alloc.stats()["blocks_in_use"] == 0
    plain = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                     **BATCHER_KW)
    assert plain.cache.k.dtype == torch.float16
    assert serve(plain) == want


def _flat(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    return [("", tree)]


def _steps_match(jmod, tmod, jcfg, tcfg, pdtype, seed, **conv):
    tree = _tree(jmod, jcfg, seed)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tok = np.random.default_rng(seed + 1).integers(0, 256, (1, 16)).astype(
        np.int32)
    kw = dict(learning_rate=LR, state_quant="8bit", warmup_steps=2,
              total_steps=10)
    jtx, ttx = jtrain.make_optimizer(**kw), ttrain.make_optimizer(**kw)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp))
    jstep = jtrain.make_train_step(jcfg, jtx, donate=False, model=jmod)
    tp = tmod.params_from_numpy(tree, tcfg, device="cpu", **conv)
    tstate = ttrain.TrainState(torch.zeros((), dtype=torch.int32), tp,
                               ttx.init(tp))
    tstep = ttrain.make_train_step(tcfg, ttx, device="cpu", model=tmod)
    jm, tm = [], []
    # the fused 8-bit JAX apply runs only where Pallas runs (interpret)
    flags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        for _ in range(2):
            jstate, m = jstep(jstate, jnp.asarray(tok))
            jm.append({k: float(v) for k, v in m.items()})
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})
    for _ in range(2):
        tstate, m = tstep(tstate, torch.from_numpy(tok))
        tm.append({k: float(v) for k, v in m.items()})
    for a, b in zip(tm, jm):
        assert np.isfinite(a["loss"]) and np.isfinite(a["grad_norm"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=2e-3)
    assert int(tstate.opt_state.count) == int(jstate.opt_state.count) == 2
    for (path, t), (_, j) in zip(_flat(tstate.params), _flat(jstate.params)):
        assert t.dtype == pdtype and tuple(t.shape) == j.shape, path
        d = np.abs(t.float().numpy() - np.asarray(j, np.float32))
        assert np.mean(d > 1e-4) <= 1e-2, (path, np.mean(d > 1e-4))
        assert d.max() <= 2.5 * LR_TAKEN, (path, d.max())


def test_llama_8bit_steps_f32_params_match_jax():
    """The tiny Llama at bf16 compute over f32 parameters (the JAX
    default param_dtype) with 8-bit moments: row 17 over f32 leaves."""
    _steps_match(jllama, tllama,
                 jllama.LlamaConfig.tiny(param_dtype=jnp.float32),
                 tllama.LlamaConfig.tiny(param_dtype=torch.float32),
                 torch.float32, 0, training=True)


def test_moe_8bit_steps_f16_match_jax():
    """The tiny MoE at dtype = param_dtype = float16 with 8-bit moments:
    rows 14-15 and 17 over f16 rows and leaves."""
    _steps_match(jmoe, tmoe,
                 jmoe.MoeConfig.tiny(dtype=jnp.float16,
                                     param_dtype=jnp.float16),
                 tmoe.MoeConfig.tiny(dtype=torch.float16,
                                     param_dtype=torch.float16),
                 torch.float16, 3)


def test_params_from_numpy_f16_trees(f16_models):
    """An f16 serving tree keeps its matmul weights in f16 and its norms
    in f32; the training tree at param_dtype=float16 holds every leaf in
    f16; values are the numpy tree's, rounded once."""
    _, jparams, tcfg, tparams = f16_models
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert tree["layers"]["q_proj"].dtype == np.float32
    for name in ("embed_tokens", "lm_head"):
        assert tparams[name].dtype == torch.float16
        np.testing.assert_array_equal(tparams[name].numpy(),
                                      tree[name].astype(np.float16))
    assert tparams["norm"].dtype == torch.float32
    assert tparams["layers"]["q_proj"].dtype == torch.float16
    assert tparams["layers"]["input_layernorm"].dtype == torch.float32
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float16,
                                  param_dtype=torch.float16)
    train = tllama.params_from_numpy(tree, cfg, device="cpu", training=True)
    assert {t.dtype for _, t in _flat(train)} == {torch.float16}
    np.testing.assert_array_equal(
        train["layers"]["down_proj"].numpy(),
        tree["layers"]["down_proj"].astype(np.float16))


_COUNTERS = (tmd.gather_wsum, tmd.gather_scale_dot, tqs.fused_leaf_update,
             tra.ragged_paged_attention)


def _counts():
    return [(f, a, getattr(f, a)) for f in _COUNTERS for a in sorted(vars(f))
            if a == "launches" or a.startswith("launches_")]


@pytest.mark.parametrize("dt", [torch.float16, torch.float32],
                         ids=["f16", "f32"])
def test_cpu_wrappers_launch_nothing(dt):
    """On CPU tensors of every dtype the wrappers of rows 14, 15, 17 and
    18 run their plain versions and count no launch, in any of their
    counters (by dtype and by option)."""
    before = _counts()
    assert {a for _, a, _ in before} >= {"launches", "launches_bf16",
                                         "launches_f16", "launches_f32"}
    src = torch.randn(1, 4, 16).to(dt)
    idx = torch.zeros(1, 3, 2, dtype=torch.int32)
    out = tmd.gather_wsum(src, idx, torch.ones(1, 3, 2))
    o2, _ = tmd.gather_scale_dot(src, idx[..., 0], torch.ones(1, 3),
                                 torch.randn(1, 3, 16).to(dt))
    assert out.dtype == o2.dtype == dt
    p, g = torch.zeros(300, dtype=dt), torch.ones(300, dtype=dt)
    mq, vq = tqs._zero_q(p), tqs._zero_q(p)
    tqs.fused_leaf_update(torch.tensor([1.0, 1e-3, 0.1, 0.05]), g, p, mq,
                          vq, b1=0.9, b2=0.95, eps=1e-8, wd=0.0)
    assert p.dtype == dt and bool((p < 0).all())
    q = torch.randn(2, 1, 4, 16).to(dt)
    pool = torch.randn(3, 4, 2, 16).to(dt)
    table = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    pos = torch.tensor([[5], [2]], dtype=torch.int32)
    assert tra.ragged_paged_attention(q, pool, pool, table,
                                      pos).dtype == dt
    assert _counts() == before
