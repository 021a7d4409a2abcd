"""The port's dense-cache generation and its bench twin against the JAX
package, on the CPU.

The same numpy-drawn parameters (a tiny f32 Llama, 2 layers, GQA 4/2, in
the shape of tests/test_generation.py's fixture) go through
`paddle_tpu.nlp.generation` (jitted) and `paddle_tpu_torch.nlp.generation`
(`params_from_numpy`): `forward_cached` prefill and decode logits within
the JAX tests' own tolerances (1e-5 for the prefill, 1e-4 for decode
steps, relative and absolute: both sides run the same f32 expressions in
another summation order), greedy `generate` tokens identical, with and
without eos and from the weight-only trees, `quantize_for_serving`'s
codes equal and its scales within one f32 ulp, `pos` as an int and as a
device tensor, and `mesh=` refused. On the CPU the flash prefill runs the
kernel's plain version; the 130-token case holds it against the Pallas
kernel in interpret mode (`FLAGS_pallas_interpret`). `tools/bench.py`'s
runs are driven at tiny configs and give bench.py's keys. The decode
loop's CUDA graph runs only on the card (`chip_smoke.py`'s generate
phase holds its tokens to the eager loop's).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags as jflags  # noqa: E402
from paddle_tpu.nlp import generation as jg  # noqa: E402
from paddle_tpu.nlp import llama as jl  # noqa: E402

from paddle_tpu_torch.nlp import generation as tg  # noqa: E402
from paddle_tpu_torch.nlp import llama as tl  # noqa: E402

PREFILL_TOL = 1e-5
DECODE_TOL = 1e-4
LAYERS = 2


def _cfgs(use_flash):
    return (jl.LlamaConfig.tiny(use_flash=use_flash, num_hidden_layers=LAYERS,
                                dtype=jnp.float32),
            tl.LlamaConfig.tiny(use_flash=use_flash, num_hidden_layers=LAYERS,
                                dtype=torch.float32))


@pytest.fixture(scope="module")
def trees():
    """One numpy draw: N(0, 0.02) weights, norm scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(0)
    shapes = tl._shapes(_cfgs(False)[1])

    def draw(name, shape):
        if name.endswith("layernorm") or name == "norm":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    tree = {k: draw(k, s) for k, s in shapes.items() if k != "layers"}
    tree["layers"] = {k: draw(k, s) for k, s in shapes["layers"].items()}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = tl.params_from_numpy(tree, _cfgs(False)[1], device="cpu")
    return jtree, ttree


@pytest.fixture(scope="module")
def prompt():
    return np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.int32)


def _quantized(trees, bits):
    jtree, ttree = trees
    if bits is None:
        return jtree, ttree
    return (jg.quantize_for_serving(jtree, bits=bits),
            tg.quantize_for_serving(ttree, bits=bits))


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("use_flash,bits", [
    (False, None), (True, None), (False, 8), (False, 4)])
def test_forward_cached_prefill_and_decode_match_jax(trees, prompt,
                                                     use_flash, bits):
    """A prefill at the int position 0, then three decode steps at a
    traced (JAX) / int (port) position, each feeding JAX's greedy token;
    and `llama.forward` over the prompt (`use_flash` routes it too)."""
    jcfg, tcfg = _cfgs(use_flash)
    jtree, ttree = _quantized(trees, bits)
    B, P = prompt.shape
    T = P + 4

    @jax.jit
    def jrun(p, t):
        lg, c = jg.forward_cached(p, t, jg.init_cache(jcfg, B, T), 0, jcfg)
        out, toks = [lg, jl.forward(p, t, jcfg)], []
        for i in range(3):
            nxt = jnp.argmax(out[-2 if i == 0 else -1][:, -1],
                             axis=-1).astype(jnp.int32)
            lg, c = jg.forward_cached(p, nxt[:, None], c, jnp.int32(P + i),
                                      jcfg)
            out.append(lg)
            toks.append(nxt)
        return out, toks, c

    jlogits, jtoks, jc = jrun(jtree, jnp.asarray(prompt))
    tc = tg.init_cache(tcfg, B, T, device="cpu")
    tl_, tc2 = tg.forward_cached(ttree, torch.from_numpy(prompt), tc, 0, tcfg)
    assert tc2 is tc and tl_.dtype == torch.float32
    assert tuple(tl_.shape) == (B, P, tcfg.vocab_size)
    _close(tl_, jlogits[0], PREFILL_TOL, "prefill logits")
    if bits is None:        # the training forward (flash or mha_ref)
        _close(tl.forward(ttree, torch.from_numpy(prompt), tcfg),
               jlogits[1], PREFILL_TOL, "llama.forward")
    for i in range(3):
        nxt = torch.from_numpy(np.array(jtoks[i]))[:, None]
        tl_, _ = tg.forward_cached(ttree, nxt, tc, P + i, tcfg)
        _close(tl_, jlogits[i + 2], DECODE_TOL, f"decode step {i}")
    _close(tc.k, jc.k, PREFILL_TOL, "cache k")
    _close(tc.v, jc.v, PREFILL_TOL, "cache v")


@pytest.mark.parametrize("use_flash,bits", [
    (False, None), (True, None), (False, 8), (False, 4)])
def test_greedy_generate_tokens_identical(trees, prompt, use_flash, bits):
    """Greedy tokens without eos, then with an eos that row 0 emits at
    step 2 (its tail takes pad_token_id)."""
    jcfg, tcfg = _cfgs(use_flash)
    jtree, ttree = _quantized(trees, bits)
    n = 6
    plain = None
    for kw in ({}, "eos"):
        if kw == "eos":
            kw = dict(eos_token_id=int(plain[0, 1]), pad_token_id=-1)
        j = np.asarray(jax.jit(lambda p, t: jg.generate(
            p, t, jcfg, max_new_tokens=n, **kw))(jtree, jnp.asarray(prompt)))
        t = tg.generate(ttree, torch.from_numpy(prompt), tcfg,
                        max_new_tokens=n, device="cpu", **kw)
        assert t.dtype == torch.int32 and tuple(t.shape) == (2, n)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(kw))
        plain = j
    assert (t[0, 2:] == -1).all()


def test_flash_prefill_against_pallas_interpret(trees):
    """A 130-token prompt: JAX runs its Pallas flash kernel in interpret
    mode, the port the kernel's plain version."""
    jcfg, tcfg = _cfgs(True)
    jtree, ttree = trees
    p = np.random.RandomState(1).randint(0, 256, (1, 130)).astype(np.int32)
    jflags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        jlg, jc = jg.forward_cached(jtree, jnp.asarray(p),
                                    jg.init_cache(jcfg, 1, 140), 0, jcfg)
    finally:
        jflags.set_flags({"FLAGS_pallas_interpret": False})
    tc = tg.init_cache(tcfg, 1, 140, device="cpu")
    tlg, _ = tg.forward_cached(ttree, torch.from_numpy(p), tc, 0, tcfg)
    _close(tlg, jlg, PREFILL_TOL, "flash prefill logits")
    _close(tc.k, jc.k, PREFILL_TOL, "cache k")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_for_serving_codes_and_scales(trees, bits):
    jq, tq = _quantized(trees, bits)
    keys = [("layers", n) for n in tg.QUANT_KEYS] + [(None, "lm_head")]
    assert tg.QUANT_KEYS == jg.QUANT_KEYS
    for group, name in keys:
        jt = jq if group is None else jq[group]
        tt = tq if group is None else tq[group]
        codes = tt[name]
        assert codes.dtype == torch.int8
        bound = 127 if bits == 8 else 7
        assert int(codes.abs().max()) <= bound
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(jt[name]).astype(np.int8), err_msg=name)
        scale = tt[name + ":scale"]
        assert scale.dtype == torch.float32
        assert tuple(scale.shape) == tuple(jt[name + ":scale"].shape)
        assert scale.shape[-2] == 1
        np.testing.assert_array_max_ulp(
            scale.numpy(), np.asarray(jt[name + ":scale"]), maxulp=1)
    assert set(tq["layers"]) == set(jq["layers"]) and set(tq) == set(jq)
    with pytest.raises(ValueError):
        tg.quantize_for_serving(trees[1], bits=3)


def test_pos_as_int_and_as_device_tensor(trees, prompt):
    """A decode step and a continuing chunk at an int pos and at a 0-d
    int64 tensor pos take the same route and give the same logits; a
    prefill at tensor pos 0 takes the grouped path (as a traced pos does
    in JAX) and agrees with the flash route within f32 tolerance."""
    _, tcfg = _cfgs(True)
    ttree = trees[1]
    B, P = prompt.shape
    x = torch.from_numpy(prompt)
    out = {}
    for kind in ("int", "tensor"):
        cache = tg.init_cache(tcfg, B, P + 8, device="cpu")

        def at(p):
            return p if kind == "int" else torch.tensor(p)

        pre, _ = tg.forward_cached(ttree, x, cache, at(0), tcfg)
        chunk, _ = tg.forward_cached(ttree, x[:, :3], cache, at(P), tcfg)
        step, _ = tg.forward_cached(ttree, x[:, :1], cache, at(P + 3), tcfg)
        out[kind] = (pre, chunk, step, cache.k.clone())
    a, b = out["int"], out["tensor"]
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    for x1, x2 in zip(a[1:], b[1:]):
        np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=PREFILL_TOL,
                                   atol=PREFILL_TOL)


def test_sampling_is_seeded_and_in_range(trees, prompt):
    _, tcfg = _cfgs(False)
    kw = dict(max_new_tokens=5, greedy=False, temperature=0.8, top_k=16,
              top_p=0.9, device="cpu")
    runs = [tg.generate(trees[1], prompt, tcfg,
                        key=torch.Generator().manual_seed(s), **kw)
            for s in (1, 1, 2)]
    assert tuple(runs[0].shape) == (2, 5)
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tcfg.vocab_size


@pytest.mark.parametrize("call", ["init_cache", "forward_cached",
                                  "generate", "make_generate"])
def test_mesh_raises(trees, prompt, call):
    _, tcfg = _cfgs(False)
    mesh = object()
    cache = tg.init_cache(tcfg, 2, 10, device="cpu")
    fns = {
        "init_cache": lambda: tg.init_cache(tcfg, 2, 10, mesh=mesh,
                                            device="cpu"),
        "forward_cached": lambda: tg.forward_cached(
            trees[1], torch.from_numpy(prompt), cache, 0, tcfg, mesh=mesh),
        "generate": lambda: tg.generate(trees[1], prompt, tcfg, mesh=mesh,
                                        device="cpu"),
        "make_generate": lambda: tg.make_generate(
            trees[1], tcfg, 2, 8, mesh=mesh, device="cpu"),
    }
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        fns[call]()


# ------------------------------------------------ tools/bench.py
def _bench_runs():
    from paddle_tpu_torch.mix import dit
    from paddle_tpu_torch.nlp import ernie, moe
    from paddle_tpu_torch.tools import bench
    f32 = torch.float32
    tiny = tl.LlamaConfig.tiny(dtype=f32)
    return {
        "big": lambda: bench.run_config(tl.LlamaConfig.tiny(), 2, 32, 2,
                                        state_quant="8bit", device="cpu"),
        "05b": lambda: bench.run_config(tiny, 2, 32, 2, device="cpu"),
        "layer8b_4k": lambda: bench.run_8b_layer(
            32, timed_steps=2, device="cpu", cfg=tl.LlamaConfig.tiny(
                num_hidden_layers=1, remat=False, dtype=f32)),
        "moe": lambda: bench.run_moe(2, 32, 2, device="cpu",
                                     cfg=moe.MoeConfig.tiny(dtype=f32)),
        "ernie": lambda: bench.run_ernie(
            2, 32, 2, device="cpu", cfg=ernie.ErnieConfig.tiny(dtype=f32)),
        "dit": lambda: bench.run_dit(4, 2, device="cpu",
                                     cfg=dit.DiTConfig.tiny(dtype=f32)),
        "prefill": lambda: bench.run_prefill(24, 2, cfg=tiny, device="cpu"),
        "decode_w8": lambda: bench.run_decode(2, 8, 4, 2, weight_only=8,
                                              cfg=tiny, device="cpu"),
    }


_RUN_KEYS = {"big": {"tok_s", "mfu", "loss", "params"},
             "05b": {"tok_s", "mfu"}, "layer8b_4k": {"mfu"},
             "moe": {"tok_s", "mfu", "params"}, "ernie": {"tok_s", "mfu"},
             "dit": {"img_s", "mfu"}, "prefill": {"prefill_tok_s"},
             "decode_w8": {"decode_tok_s"}}


@pytest.mark.parametrize("run", sorted(_RUN_KEYS))
def test_bench_run_at_tiny_config(run):
    res = _bench_runs()[run]()
    assert _RUN_KEYS[run] <= set(res)
    assert res.get("mfu") is None        # no device rate off the card
    rates = [v for k, v in res.items() if k.endswith(("_s", "_ms"))]
    assert rates and all(np.isfinite(v) and v > 0 for v in rates)


def test_bench_headline_has_bench_py_keys():
    """The JSON object carries every key bench.py's main prints, and
    the card's `nvidia-smi` line."""
    from paddle_tpu_torch.tools import bench
    src = (Path(__file__).resolve().parents[1] / "bench.py").read_text()
    start = src.index("print(json.dumps({")
    keys = re.findall(r'"(\w+)":', src[start:src.index("}))", start)])
    runs = _bench_runs()
    res = {k: runs[k]() for k in ("big", "prefill")}
    line = bench.headline(res, "cpu", None)
    assert list(line)[:len(keys)] == keys
    assert set(line) - set(keys) == {"nvidia_smi"}
    assert line["value"] == res["big"]["tok_s"]
    assert line["prefill_tok_s"] == res["prefill"]["prefill_tok_s"]
    assert line["decode_tok_s"] is None
    assert set(bench.RUNS) >= {"long8k", "prefill", "decode", "decode_w8",
                               "decode_w8_b32", "layer8b_4k", "layer8b_8k",
                               "05b"}
