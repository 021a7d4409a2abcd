"""The PyTorch port's ServingEngine on the CPU: greedy outputs through
`generate` and `stream` are identical to the JAX batcher's for the same
prompts (f32 tiny model, weights carried across with
`params_from_numpy`), admissions land mid-decode (fused steps), the pool
drains, and what the port does not serve yet is refused by name.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402

from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.serving import (EngineStopped, RequestState,  # noqa: E402
                                      ServingEngine)

ENGINE_KW = dict(max_batch=2, block_size=4, max_total_len=40,
                 max_new_tokens=5, chunk=3, prefill_buckets=(8, 16))
LENGTHS = [6, 19, 4, 11, 8]


def _prompts():
    rng = np.random.RandomState(7)
    return [list(map(int, rng.randint(1, 250, n))) for n in LENGTHS]


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    cb = jpaged.ContinuousBatcher(
        jparams, jcfg, prefix_cache=False, attention_impl="xla",
        max_batch=2, block_size=4, max_total_len=40, max_new_tokens=5,
        chunk=3, prefill_buckets=(8, 16))
    rids = [cb.submit(p) for p in _prompts()]
    cb.run()
    ref = [cb.outputs[r] for r in rids]
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return tcfg, tparams, ref


def test_generate_and_stream_match_jax(setup):
    """One request streams while the rest are submitted from threads, so
    admissions land while a slot decodes; every output equals the JAX
    batcher's, fused steps ran, and the pool drains."""
    tcfg, tparams, ref = setup
    prompts = _prompts()
    eng = ServingEngine(tparams, tcfg, device="cpu", **ENGINE_KW)
    try:
        results = [None] * len(prompts)
        it = eng.stream(prompts[0])
        first = next(it)

        def gen(i):
            results[i] = eng.generate(prompts[i], timeout=120)

        threads = [threading.Thread(target=gen, args=(i,))
                   for i in range(1, len(prompts))]
        for t in threads:
            t.start()
        results[0] = [first] + list(it)
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert results == ref
        assert eng.drain(timeout=60)
        snap = eng.snapshot()
        g = snap["gauges"]
        assert g["kv_blocks_in_use"] == 0
        assert g["fused_steps"] >= 1
        assert snap["counters"]["requests_completed"] == len(prompts)
        assert snap["counters"]["tokens_generated"] == sum(map(len, ref))
        assert snap["attention_impl"] == "ref"
        assert snap["device"] == "cpu"
    finally:
        assert eng.shutdown(timeout=60)


def test_submit_cancel_and_shutdown(setup):
    tcfg, tparams, ref = setup
    prompts = _prompts()
    eng = ServingEngine(tparams, tcfg, device="cpu", start=False,
                        **ENGINE_KW)
    req = eng.submit(prompts[1], max_new_tokens=3, priority=1)
    dropped = eng.submit(prompts[2])
    eng.cancel(dropped)
    eng.start()
    assert req.result(timeout=120) == ref[1][:3]
    assert req.state == RequestState.FINISHED
    assert dropped.state == RequestState.CANCELLED
    with pytest.raises(ValueError):
        eng.submit([1] * 40)                  # can never fit the table
    assert eng.shutdown(timeout=60)
    with pytest.raises(EngineStopped):
        eng.submit(prompts[0])
    assert eng.snapshot()["allocator"]["blocks_in_use"] == 0


@pytest.mark.parametrize("kw", [
    {"prefix_cache": True}, {"mesh": object()},
    {"slo": True}, {"trace": True}, {"watchdog_s": 1.0},
    {"fault_injector": object()}, {"role": "prefill"},
    {"spec_attention_impl": "pallas"},
])
def test_unported_options_raise(setup, kw):
    """Options of later slices are accepted only at their off value, and
    the spec backend switch only as None (the device decides)."""
    tcfg, tparams, _ = setup
    with pytest.raises(NotImplementedError,
                       match="later slice|no backend switch"):
        ServingEngine(tparams, tcfg, device="cpu", start=False, **kw,
                      **ENGINE_KW)


def test_off_values_accepted_and_kv_export_refused(setup):
    tcfg, tparams, _ = setup
    eng = ServingEngine(tparams, tcfg, device="cpu", start=False,
                        prefix_cache=False, speculative=False, slo=False,
                        trace=False, kv_dtype="fp", role="both",
                        mesh=None, watchdog_s=None, **ENGINE_KW)
    with pytest.raises(NotImplementedError):
        eng.drain_export()
    with pytest.raises(NotImplementedError):
        eng.submit_import(object())
    for unknown in ({"no_such_option": 1}, {"attention_impl": "ref"}):
        with pytest.raises(TypeError):
            ServingEngine(tparams, tcfg, device="cpu", start=False,
                          **unknown, **ENGINE_KW)
    assert eng.shutdown(timeout=10)


def test_no_cpu_fallback(setup):
    """Without device="cpu" the engine wants the card: on a machine with
    no CUDA it raises rather than serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tcfg, tparams, _ = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tparams, tcfg, start=False, **ENGINE_KW)
