"""The port's inference entry point against the JAX package, on the CPU.

A `.pdllm` written by `paddle_tpu.inference.llm.save_llm` (a tiny f32
Llama, 2 layers, GQA 4/2, weights drawn with numpy) is served by both
packages' `create_predictor`: greedy tokens of the dense run, the paged
run (right-padded prompts of three lengths, block 4) and the int8
weight-only run must be identical, since both sides run the same f32
expressions and argmax over logits that differ by summation order only.
The port's own file round-trips bit for bit, a file of f32 leaves
written by either package loads in the other, and bf16 leaves travel as
uint16 bit patterns. Sampling is checked in distribution: 2000 draws of
the first token under top_k=5 against the JAX model's top-5
probabilities (chi-square, 4 degrees of freedom, rejected above 18.47,
p = 0.001), and the draws of one seed repeat.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu.inference import llm as jllm  # noqa: E402
from paddle_tpu.nlp import llama as jl  # noqa: E402

from paddle_tpu_torch import inference as tinf  # noqa: E402
from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.nlp import llama as tl  # noqa: E402

NEW = 6
CHI2_P001_DOF4 = 18.47


def _tree(cfg_t, seed=0):
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name.endswith("layernorm") or name == "norm":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    shapes = tl._shapes(cfg_t)
    tree = {k: draw(k, s) for k, s in shapes.items() if k != "layers"}
    tree["layers"] = {k: draw(k, s) for k, s in shapes["layers"].items()}
    return tree


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A tiny f32 .pdllm written by the JAX package."""
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2, dtype=jnp.float32)
    tree = _tree(tl.LlamaConfig.tiny(num_hidden_layers=2))
    prefix = str(tmp_path_factory.mktemp("pdllm") / "tiny")
    jllm.save_llm(prefix, jax.tree.map(jnp.asarray, tree), jcfg)
    return prefix, tree


def _run(pred, ids):
    pred.get_input_handle("input_ids").copy_from_cpu(ids)
    pred.run()
    return pred.get_output_handle("generated_ids").copy_to_cpu()


def _predictors(prefix, weight_only=None, paged=False, **gen):
    preds = []
    for mod in (jinf, tinf):
        c = mod.Config(prefix)
        c.enable_llm_generation(max_new_tokens=NEW, **gen)
        if weight_only:
            c.enable_weight_only(weight_only)
        if paged:
            c.enable_paged_kv(block_size=4)
        if mod is tinf:
            c.disable_gpu()
        preds.append(mod.create_predictor(c))
    return preds


def _prompt(batch=2, length=8, seed=0):
    return np.random.RandomState(seed).randint(
        1, 256, (batch, length)).astype(np.int32)


@pytest.mark.parametrize("weight_only", [None, "int8"])
def test_dense_greedy_matches_jax(jax_file, weight_only):
    jp, tp = _predictors(jax_file[0], weight_only)
    assert isinstance(tp, tllm.LLMPredictor)
    ids = _prompt()
    want = _run(jp, ids)
    got = _run(tp, ids)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2, NEW)
    # a second run reuses the compiled generate of this shape
    np.testing.assert_array_equal(_run(tp, ids), want)
    assert list(tp._compiled) == [(2, 8)]


def test_paged_greedy_matches_jax(jax_file):
    jp, tp = _predictors(jax_file[0], paged=True)
    ids = _prompt(3, 9)
    ids[1, 4:] = 0            # right-padded: lengths 9, 4, 6
    ids[2, 6:] = 0
    np.testing.assert_array_equal(_run(tp, ids), _run(jp, ids))
    first = tp._paged_alloc
    assert tp._paged_stats["blocks_in_use"] > 0
    assert first.stats()["blocks_in_use"] == 0
    # a larger batch grows the pool; the same batch again reuses it
    big = _prompt(5, 9, seed=1)
    np.testing.assert_array_equal(_run(tp, big), _run(jp, big))
    grown = tp._paged_alloc
    assert grown is not first and grown.num_blocks > first.num_blocks
    np.testing.assert_array_equal(_run(tp, ids), _run(jp, ids))
    assert tp._paged_alloc is grown
    assert tp._paged_stats["reused_blocks"] > 0


def test_port_file_round_trips_and_loads_in_jax(tmp_path, jax_file):
    params, cfg = tllm.load_llm(jax_file[0])
    assert cfg == tl.LlamaConfig.tiny(num_hidden_layers=2,
                                      dtype=torch.float32)
    prefix = str(tmp_path / "port")
    tllm.save_llm(prefix, params, cfg)
    again, cfg2 = tllm.load_llm(prefix)
    assert cfg2 == cfg
    for k in ("embed_tokens", "norm", "lm_head"):
        assert torch.equal(again[k], params[k])
    for k, v in params["layers"].items():
        assert torch.equal(again["layers"][k], v)
    # the JAX package reads the port's f32 file
    jparams, jcfg = jllm.load_llm(prefix)
    assert jcfg == jl.LlamaConfig.tiny(num_hidden_layers=2,
                                       dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(jparams["layers"]["q_proj"]),
                                  jax_file[1]["layers"]["q_proj"])


@pytest.mark.parametrize("leaf_dtype", ["float16", "int8"])
def test_f16_and_int8_leaves_load_in_both(tmp_path, jax_file, leaf_dtype):
    tree = jax_file[1]
    tree = dict(tree, embed_tokens=tree["embed_tokens"].astype(leaf_dtype))
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=2, dtype=torch.float32)
    prefix = str(tmp_path / "leaves")
    tllm.save_llm(prefix, {k: torch.from_numpy(v) if k != "layers" else
                           {n: torch.from_numpy(a) for n, a in v.items()}
                           for k, v in tree.items()}, cfg)
    jparams, _ = jllm.load_llm(prefix)
    assert np.asarray(jparams["embed_tokens"]).dtype == leaf_dtype
    tparams, _ = tllm.load_llm(prefix)
    np.testing.assert_array_equal(tparams["embed_tokens"].numpy(),
                                  tree["embed_tokens"])


def test_bf16_leaves_travel_as_uint16_bits(tmp_path):
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=2)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prefix = str(tmp_path / "bf16")
    tllm.save_llm(prefix, params, cfg)
    with open(prefix + tllm.LLM_SUFFIX, "rb") as f:
        payload = pickle.load(f)
    assert "layers/q_proj" in payload["bf16_bits"]
    assert "norm" not in payload["bf16_bits"]
    assert payload["params"]["layers"]["q_proj"].dtype == np.uint16
    assert payload["config"]["dtype"] == "bfloat16"
    back, cfg2 = tllm.load_llm(prefix)
    assert cfg2.dtype == torch.bfloat16
    assert back["layers"]["q_proj"].dtype == torch.bfloat16
    assert torch.equal(back["layers"]["q_proj"].view(torch.int16),
                       params["layers"]["q_proj"].view(torch.int16))
    # a JAX-written bf16 leaf (an ml_dtypes array) is read through its bits
    jprefix = str(tmp_path / "jbf16")
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2)
    jtree = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jtree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree)
    jllm.save_llm(jprefix, jtree, jcfg)
    tback, _ = tllm.load_llm(jprefix)
    want = np.asarray(jtree["layers"]["k_proj"]).view(np.uint16)
    np.testing.assert_array_equal(
        tback["layers"]["k_proj"].view(torch.int16).numpy().view(np.uint16),
        want)


def test_parallel_and_static_configs_raise(jax_file, tmp_path):
    c = tinf.Config(jax_file[0])
    c.enable_llm_generation()
    c.disable_gpu()
    c.set_llm_parallel(mp=2)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tinf.create_predictor(c)
    with pytest.raises(NotImplementedError, match="item 7"):
        tinf.create_predictor(tinf.Config(str(tmp_path / "model.pdmodel")))
    c = tinf.Config(jax_file[0])
    assert c._device == "cuda"
    c.enable_use_gpu(100, 1)
    assert c._device == "cuda:1"
    with pytest.raises(ValueError):
        c.enable_llm_generation(decode_strategy="beam_search")
    with pytest.raises(ValueError):
        c.enable_weight_only("int2")


def test_sampling_distribution_and_seed(jax_file):
    """2000 first tokens drawn under top_k=5 against the JAX model's
    top-5 probabilities; one seed repeats its sequence of draws."""
    prefix, tree = jax_file
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2, dtype=jnp.float32)
    prompt = _prompt(1, 8)
    logits = np.asarray(jl.forward(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(prompt), jcfg))[0, -1]
    top = np.argsort(-logits)[:5]
    p = np.exp(logits[top] - logits[top].max())
    p /= p.sum()

    def predictor(seed):
        c = tinf.Config(prefix)
        c.enable_llm_generation(max_new_tokens=2, decode_strategy="sampling",
                                top_k=5, seed=seed)
        c.disable_gpu()
        return tinf.create_predictor(c)

    pred = predictor(3)
    n = 2000
    first = _run(pred, np.repeat(prompt, n, axis=0))[:, 0]
    assert set(first.tolist()) <= set(top.tolist())
    counts = np.array([(first == t).sum() for t in top])
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < CHI2_P001_DOF4, (counts, n * p)
    # each run draws afresh; a new predictor of the same seed repeats
    second = _run(pred, np.repeat(prompt, 64, axis=0))
    again = predictor(3)
    np.testing.assert_array_equal(
        _run(again, np.repeat(prompt, n, axis=0))[:, 0], first)
    np.testing.assert_array_equal(
        _run(again, np.repeat(prompt, 64, axis=0)), second)
