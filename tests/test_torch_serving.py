"""The PyTorch port's ServingEngine on the CPU: greedy outputs through
`generate` and `stream` are identical to the JAX batcher's for the same
prompts (f32 tiny model, weights carried across with
`params_from_numpy`), admissions land mid-decode (fused steps), the pool
drains, the roles, the watchdog and fault injection do what they say,
and what the port does not serve yet is refused by name.
"""
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
    {"mesh": object()},
    {"spec_attention_impl": "xla"}, {"spec_attention_impl": "pallas"},
])
def test_unported_options_raise(setup, kw):
    """The tensor-parallel mesh is a later slice, accepted only at its
    off value; the spec backend switch only as None (the device
    decides)."""
    tcfg, tparams, _ = setup
    with pytest.raises(NotImplementedError,
                       match="later slice|no backend switch"):
        ServingEngine(tparams, tcfg, device="cpu", start=False, **kw,
                      **ENGINE_KW)


@pytest.mark.parametrize("kw", [
    {"role": "decode"}, {"role": "prefill"}, {"watchdog_s": 0.0},
    {"watchdog_s": 1.0}, {"fault_injector": "injector"},
])
def test_ported_options_work(setup, kw):
    """The roles, the watchdog and fault injection are ported: each
    option builds an engine that does what it says on the prompts the
    JAX batcher's outputs were taken for."""
    from paddle_tpu_torch.serving import FaultInjector, RequestFailed
    tcfg, tparams, ref = setup
    prompts = _prompts()
    if kw.get("fault_injector") == "injector":
        kw = {"fault_injector": FaultInjector().fail_on_rid(0)}
    eng = ServingEngine(tparams, tcfg, device="cpu", start=False, **kw,
                        **ENGINE_KW)
    try:
        if "role" in kw:
            assert eng.role == kw["role"] and eng.health()["role"] == \
                kw["role"]
            req = eng.submit(prompts[1])
            eng.start()
            out = req.result(timeout=120)
            if kw["role"] == "prefill":
                # surrendered at the first committed token, KV attached
                assert req.finish_reason == "prefill_complete"
                assert out == ref[1][:len(out)] and len(out) < len(ref[1])
                assert req.kv_snapshot is not None
            else:
                assert out == ref[1]
        elif kw.get("watchdog_s") == 0.0:
            # a zero deadline trips at the first device call
            req = eng.submit(prompts[1])
            eng.start()
            with pytest.raises(RequestFailed):
                req.result(timeout=120)
            assert eng.health()["watchdog_trips"] == 1
            assert eng.health()["status"] == "UNHEALTHY"
        elif "watchdog_s" in kw:
            eng.start()
            assert eng.generate(prompts[1], timeout=120) == ref[1]
            assert eng.health()["watchdog_trips"] == 0
        else:
            # rid 0 is poisoned: only it fails, the other finishes
            r0, r1 = eng.submit(prompts[0]), eng.submit(prompts[1])
            eng.start()
            with pytest.raises(RequestFailed):
                r0.result(timeout=120)
            assert r1.result(timeout=120) == ref[1]
            assert eng.health()["quarantines"] >= 1
    finally:
        eng.shutdown(drain=False, timeout=10)


def test_off_values_accepted_and_kv_export_refused(setup):
    """Every option at its off value builds; unknown kwargs raise
    TypeError; KV transfer is ported, and refuses what it cannot serve:
    drain_export() on a parked engine exports nothing, and an object that
    is not a snapshot is refused with TypeError before anything is
    queued or counted."""
    tcfg, tparams, _ = setup
    eng = ServingEngine(tparams, tcfg, device="cpu", start=False,
                        prefix_cache=False, speculative=False, slo=False,
                        trace=False, kv_dtype="fp", role="both",
                        mesh=None, watchdog_s=None, fault_injector=None,
                        **ENGINE_KW)
    assert eng.drain_export() == []
    before = (eng.load(), eng.health(), eng._c_rejected.value,
              eng._c_submitted.value)
    with pytest.raises(TypeError, match="KVSnapshot"):
        eng.submit_import(object())
    assert eng._imports == [] and eng.load()["pending_imports"] == 0
    assert (eng.load(), eng.health(), eng._c_rejected.value,
            eng._c_submitted.value) == before
    for unknown in ({"no_such_option": 1}, {"attention_impl": "ref"}):
        with pytest.raises(TypeError):
            ServingEngine(tparams, tcfg, device="cpu", start=False,
                          **unknown, **ENGINE_KW)
    with pytest.raises(ValueError, match="role"):
        ServingEngine(tparams, tcfg, device="cpu", start=False,
                      role="router", **ENGINE_KW)
    assert eng.shutdown(timeout=10)


def test_no_cpu_fallback(setup):
    """Without device="cpu" the engine wants the card: on a machine with
    no CUDA it raises rather than serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tcfg, tparams, _ = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tparams, tcfg, start=False, **ENGINE_KW)
