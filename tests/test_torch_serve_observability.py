"""The port's serving observability against the JAX package, on the CPU:
`TraceSink` (with `to_chrome_trace`), `FlightRecorder`, `SloTracker`
(with `worst_verdict` and `rollup`), `StepProfiler` and the metrics
registry's `to_prometheus` driven by the same call sequences under one
fake clock must give the JAX classes' results; the batcher's trace
events and flight records on one schedule must be the JAX batcher's;
and `ServingEngine(params, cfg, device="cpu")` must take the JAX
engine's defaults (prefix cache, trace, SLOs on), accept each off
value, refuse what is still unported, and serve with health(), load(),
is_idle, recent_prompts(), capture_profile(), the flight dump and the
Prometheus export working.
"""
import inspect
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402
from paddle_tpu.serving import engine as jengine  # noqa: E402
from paddle_tpu.serving import metrics as jmetrics  # noqa: E402
from paddle_tpu.serving import profiling as jprofiling  # noqa: E402
from paddle_tpu.serving import slo as jslo  # noqa: E402
from paddle_tpu.serving import trace as jtrace  # noqa: E402

from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402
from paddle_tpu_torch.serving import RequestState, ServingEngine  # noqa: E402
from paddle_tpu_torch.serving import metrics as tmetrics  # noqa: E402
from paddle_tpu_torch.serving import profiling as tprofiling  # noqa: E402
from paddle_tpu_torch.serving import slo as tslo  # noqa: E402
from paddle_tpu_torch.serving import trace as ttrace  # noqa: E402

ENGINE_KW = dict(max_batch=2, block_size=4, max_total_len=40,
                 max_new_tokens=5, chunk=3, prefill_buckets=(8, 16))


class FakeClock:
    def __init__(self, t=100.0, step=0.25):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


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


# ----------------------------------------------------------- host modules
def _drive_sink(mod):
    sink = mod.TraceSink(max_requests=3, max_events=4, max_live=3,
                         clock=FakeClock())
    a = sink.start("a", prompt_len=5)
    sink.alias(0, a)
    sink.emit(0, "admitted", rid=0)
    sink.emit(a, "prefill_chunk", dur=0.5, slot=1, bucket=8)
    for i in range(4):                       # overflow: counted
        sink.emit(a, "decode_emit", n=i)
    sink.span("engine.step", dur=0.1, tokens=3)
    sink.span("device.decode", dur=0.05, lane="device")
    sink.emit(7, "prepared", slot=0)          # auto-opened rid timeline
    for _ in range(4):                        # displaces the oldest live
        sink.start()
    sink.finish(a, "finished", reason="length")
    sink.emit(a, "late")                      # on a finished timeline
    return sink


def test_trace_sink_matches_jax():
    j, t = _drive_sink(jtrace), _drive_sink(ttrace)
    assert t.timelines() == j.timelines()
    assert t.timeline(7) == j.timeline(7)
    assert (t.dropped_events, t.displaced_live) == \
        (j.dropped_events, j.displaced_live)
    assert t.dropped_events > 0 and t.displaced_live > 0
    assert t.to_chrome_trace() == j.to_chrome_trace()
    assert json.dumps(t.to_chrome_trace())


def test_flight_recorder_matches_jax():
    recs = []
    for mod in (jtrace, ttrace):
        fr = mod.FlightRecorder(cap=3, clock=FakeClock())
        for i, mode in enumerate(("prefill", "fused", "decode", "decode",
                                  "spec_draft")):
            fr.record(mode, rids=[i], compile_hit=i > 1)
        recs.append((fr.records(), fr.seq, len(fr), fr.cap))
    assert recs[0] == recs[1]
    assert recs[1][1] == 5 and recs[1][2] == 3


def _drive_slo(mod):
    clock = FakeClock(step=0.0)
    tr = mod.SloTracker({"ttft_s_p99": 0.5, "itl_ms_p99": 50.0,
                         "error_rate": 0.2, "goodput_tok_s": 10.0},
                        fast_window_s=2.0, slow_window_s=10.0,
                        eval_every_s=0.0, clock=clock)
    reports = []
    for step in range(30):
        clock.t += 0.3
        bad = 10 <= step < 16
        tr.record_ttft(0.9 if bad else 0.1)
        tr.record_itl(0.08 if bad else 0.01)
        tr.record_queue_wait(0.01)
        tr.record_tokens(4)
        tr.record_request(error=bad and step % 2 == 0)
        reports.append(tr.evaluate())
        reports.append(tr.pop_transitions())
    return reports, tr.breaches_total


def test_slo_tracker_matches_jax():
    (jr, jn), (tr, tn) = _drive_slo(jslo), _drive_slo(tslo)
    assert tr == jr and tn == jn and tn > 0
    verdicts = {r["verdict"] for r in tr[::2]}
    assert {"OK", "BREACH"} <= verdicts
    assert tslo.worst_verdict(["OK", "WARN"]) == "WARN"
    assert tslo.rollup([tr[20], None, tr[40]]) == \
        jslo.rollup([jr[20], None, jr[40]])
    with pytest.raises(ValueError, match="unknown SLO objective"):
        tslo.SloTracker({"nope": 1.0})


def _drive_profiler(mod):
    p = mod.StepProfiler(sample_every=3)
    fences = []
    for i in range(10):
        f = p.should_fence()
        fences.append(f)
        if f:
            p.record(mode="decode", bucket=8, units=0, impl="x",
                     weight_dtype="fp", kv_dtype="fp", device_s=0.01 * i,
                     host_s=0.001, detail={"rids": [i]})
    p.arm_capture(2)
    for i in range(3):
        if p.should_fence():
            p.record(mode="fused", bucket=16, units=1, impl="x",
                     weight_dtype="fp", kv_dtype="int8", device_s=0.02,
                     host_s=0.002, detail={"rids": [i]})
    p.arm_capture(5)
    cancelled = p.cancel_capture()
    return fences, p.report(), cancelled


def test_step_profiler_matches_jax():
    j, t = _drive_profiler(jprofiling), _drive_profiler(tprofiling)
    assert t == j
    assert t[1]["samples"] == 5 and t[2] == 5
    with pytest.raises(ValueError):
        tprofiling.StepProfiler(sample_every=-1)


def _drive_metrics(mod):
    m = mod.MetricsRegistry()
    m.counter("requests_submitted").inc(3)
    g = m.gauge("kv_blocks_in_use")
    g.set(2.0)
    g.add(1.5)
    h = m.histogram("ttft_s", buckets=mod.LATENCY_BUCKETS)
    for v in (0.002, 0.03, 0.3, 7.0, 20.0):
        h.observe(v)
    small = m.histogram("serving.step_s", cap=3)
    for v in range(6):
        small.observe(float(v))
    return m, [h.percentile(0.5), h.percentile(0.99, since=2),
               small.percentile(0.5), small.percentile(0.5, since=4),
               small.percentile(0.5, since=9)]


def test_prometheus_export_matches_jax():
    (jm, jp), (tm, tp) = _drive_metrics(jmetrics), _drive_metrics(tmetrics)
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert tp == jp
    assert tm.to_prometheus() == jm.to_prometheus()
    assert tm.to_prometheus("x_") == jm.to_prometheus("x_")
    text = tm.to_prometheus()
    assert 'paddle_tpu_ttft_s_hist_bucket{le="+Inf"} 5.0' in text
    assert "paddle_tpu_serving_step_s_count 6.0" in text
    # the timer observes its wall time and opens a profiler span
    with tm.timer("serving.step_s") as tmr:
        pass
    assert tmr.elapsed is not None
    assert tm.snapshot()["histograms"]["serving.step_s"]["count"] == 7
    with torch.profiler.profile() as prof:
        with tm.timer("admission"):
            torch.zeros(1) + 1
    assert "admission" in {e.key for e in prof.key_averages()}


# ----------------------------------------------------------------- batcher
def _strip(events):
    keep = ("bucket", "pad", "cold", "cached_tokens", "start", "end",
            "fused", "slot", "prompt_len", "cow", "blocks", "chunks",
            "generated")
    return [(e["kind"], {k: e["attrs"][k] for k in keep
                         if k in e["attrs"]}) for e in events]


def test_batcher_trace_and_flight_match_jax(models):
    """One schedule (a shared prefix, a chunked prompt landing
    mid-decode, a warm repeat) through both batchers with a TraceSink:
    the same events per request (prepared / prefill_chunk / retired with
    their bucket, padding, cached tokens, fused flag) and the same
    flight records (mode, units, bucket, compile-memo hit or miss)."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(max_batch=2, block_size=4, max_total_len=40, chunk=3,
              max_new_tokens=5, prefill_buckets=(8, 16), prefix_cache=True,
              flight_recorder_cap=256)
    p = _prompts(30, (9, 20, 9))
    p[2] = p[0]
    res = []
    for cb in (jpaged.ContinuousBatcher(
                   jparams, jcfg, attention_impl="xla",
                   trace=jtrace.TraceSink(clock=FakeClock()), **kw),
               tpaged.ContinuousBatcher(
                   tparams, tcfg, device="cpu",
                   trace=ttrace.TraceSink(clock=FakeClock()), **kw)):
        rids = [cb.submit(p[0])]
        cb.step()
        rids.append(cb.submit(p[1]))
        cb.step()
        cb.run()
        rids.append(cb.submit(p[2]))
        cb.run()
        events = {r: _strip(cb._trace.timeline(r)["events"]) for r in rids}
        flight = [{k: v for k, v in r.items() if k != "t"}
                  for r in cb.flight.records()]
        res.append((events, flight, [cb.outputs[r] for r in rids]))
    (je, jf, jo), (te, tf, to) = res
    assert to == jo
    assert te == je
    assert tf == jf
    assert any(r["mode"] == "fused" for r in tf)
    assert any(not r["compile_hit"] for r in tf)
    assert tf[-1]["compile_hit"]


def test_profiler_fences_sampled_ticks(models):
    """profile_sample_every=2 fences every second device-call tick:
    samples == ticks // 2, rows per shape, a device-lane span per fenced
    tick in the trace, and no memo entry added by the fence."""
    _, _, tcfg, tparams = models
    sink = ttrace.TraceSink()
    cb = tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                  profile_sample_every=2, trace=sink,
                                  **dict(ENGINE_KW, max_new_tokens=5))
    cb.warmup_prefill()
    c0 = cb.compile_count
    for q in _prompts(31, (5, 12, 7)):
        cb.submit(q)
    cb.run()
    rep = cb.profiler.report()
    assert rep["samples"] == rep["ticks"] // 2 > 0
    assert {r["mode"] for r in rep["shapes"]} <= {"prefill", "fused",
                                                   "decode"}
    assert all(r["device_sum_s"] >= 0 for r in rep["shapes"])
    lanes = [e for e in sink.to_chrome_trace()["traceEvents"]
             if e.get("name", "").startswith("device.")]
    assert len(lanes) == rep["samples"]
    assert cb.compile_count == c0


# ------------------------------------------------------------------ engine
_SHARED = ("prefix_cache", "trace", "slo", "warmup", "flight_recorder_cap",
           "flight_dump_path", "slo_objectives", "slo_opts",
           "profile_sample_every", "replica_id", "max_batch", "block_size",
           "max_total_len", "max_new_tokens", "chunk", "max_queue_depth",
           "fused_prefill", "fused_units", "max_prefill_bucket",
           "speculative", "spec_k", "mesh", "watchdog_s", "fault_injector",
           "role")


def test_engine_defaults_match_jax(models):
    """ServingEngine(params, cfg, device="cpu") takes the JAX engine's
    defaults — prefix caching, the trace and SLOs on — each off value is
    accepted, the unported options still raise NotImplementedError and
    fault tolerance's tuning kwargs are not taken at all; health() and
    load() have the JAX engine's keys."""
    jcfg, jparams, tcfg, tparams = models
    jsig = inspect.signature(jengine.ServingEngine.__init__).parameters
    eng = ServingEngine(tparams, tcfg, device="cpu", start=False,
                        **ENGINE_KW)
    tsig = inspect.signature(ServingEngine.__init__).parameters
    for name in _SHARED:
        if name in tsig:
            assert tsig[name].default == jsig[name].default, name
    assert eng.batcher._pcache is not None
    assert eng.trace is not None and eng._slo is not None
    assert eng.snapshot()["prefix_cache"]["enabled"] is True
    je = jengine.ServingEngine(jparams, jcfg, start=False,
                               attention_impl="xla", **ENGINE_KW)
    try:
        assert set(eng.health()) == set(je.health())
        assert set(eng.load()) == set(je.load())
        assert eng.health()["ready"] is False      # warmup() not run
        assert set(eng.health()["slo"]) == set(je.health()["slo"])
    finally:
        je.shutdown(timeout=10)
    off = ServingEngine(tparams, tcfg, device="cpu", start=False,
                        prefix_cache=False, trace=False, slo=False,
                        mesh=None, watchdog_s=None, fault_injector=None,
                        role="both", **ENGINE_KW)
    assert off.trace is None and off.batcher._pcache is None
    assert off.health()["slo"] is None
    assert off.snapshot()["prefix_cache"] == {"enabled": False}
    for kw in ({"mesh": object()}, {"watchdog_s": 1.0},
               {"fault_injector": object()}, {"role": "decode"}):
        with pytest.raises(NotImplementedError, match="later slice"):
            ServingEngine(tparams, tcfg, device="cpu", start=False, **kw,
                          **ENGINE_KW)
    for kw in ({"quarantine": True}, {"max_retries": 2},
               {"retry_backoff_s": 0.1}, {"health_window_s": 30.0},
               {"watchdog_compile_grace": 16.0}):
        with pytest.raises(TypeError, match="unexpected keyword"):
            ServingEngine(tparams, tcfg, device="cpu", start=False, **kw,
                          **ENGINE_KW)
    for e in (eng, off):
        assert e.shutdown(timeout=10)


def test_engine_serves_with_observability(models, tmp_path):
    """warmup() before start(), then overlapping requests (one repeated,
    so the prefix cache hits): health() ready and OK, compile_count flat
    from warmup() on, complete timelines, SLO gauges and latency
    histogram families in the Prometheus text, a capture window under
    traffic, the flight dump on demand."""
    _, _, tcfg, tparams = models
    eng = ServingEngine(tparams, tcfg, device="cpu", start=False,
                        profile_sample_every=2,
                        slo_objectives={"ttft_s_p99": 60.0,
                                        "itl_ms_p99": 60000.0,
                                        "error_rate": 0.5}, **ENGINE_KW)
    warmed = eng.warmup()
    assert warmed == eng.batcher.compile_count > 0
    eng.start()
    with pytest.raises(RuntimeError, match="before start"):
        eng.warmup()
    prompts = _prompts(32, (9, 17, 5))
    reqs = [eng.submit(q) for q in prompts]
    cap = {}
    t = threading.Thread(target=lambda: cap.update(
        eng.capture_profile(steps=1, timeout=60)))
    t.start()
    outs = [r.result(timeout=120) for r in reqs]
    again = eng.generate(prompts[0], timeout=120)
    t.join(timeout=60)
    assert eng.drain(timeout=30)
    assert again == outs[0]
    h = eng.health()
    assert h["status"] == "HEALTHY" and h["ready"]
    assert h["slo"]["verdict"] == "OK" and h["slo"]["breaches_total"] == 0
    assert h["quarantines"] == h["watchdog_trips"] == 0
    snap = eng.snapshot()
    assert snap["gauges"]["compile_count"] == warmed
    assert snap["prefix_cache"]["hits"] >= 1
    assert snap["gauges"]["prefix_cache_hit_tokens"] > 0
    assert snap["allocator"]["blocks_in_use"] == 0
    assert eng.is_idle and eng.load()["in_flight"] == 0
    assert eng.recent_prompts()[-1] == (prompts[0], 5)
    assert cap["capture"]["steps_captured"] >= 1
    text = eng.metrics.to_prometheus()
    for family in ("slo_burn_rate_ttft_s_p99", 'ttft_s_hist_bucket{le=',
                   "itl_s_hist_count", "prefix_cache_hit_rate",
                   "slo_breaches_total", "compile_count"):
        assert family in text, family
    kinds = [e["kind"] for e in eng.trace.timeline(reqs[1].trace_id)
             ["events"]]
    for k in ("enqueued", "admitted", "prepared", "prefill_chunk",
              "first_token", "decode_emit", "retired", "finished"):
        assert k in kinds, (k, kinds)
    path = tmp_path / "flight.json"
    dump = eng.dump_flight_recorder(str(path))
    assert json.loads(path.read_text())["records"] == dump["records"]
    assert dump["records"] and dump["error"] is None
    assert eng.shutdown(timeout=30)


def test_step_failure_dumps_the_flight_recorder(models, tmp_path):
    """A device step that raises: the flight dump (last record = the
    failing tick) lands on last_flight_dump(_json) and on
    flight_dump_path, every in-flight request fails with the error,
    health() reads DEGRADED and the pool drains; an unwritable dump path
    is counted, never masking the step error."""
    _, _, tcfg, tparams = models
    for path, ok in ((tmp_path / "dump.json", True),
                     (tmp_path / "missing" / "dump.json", False)):
        eng = ServingEngine(tparams, tcfg, device="cpu", start=False,
                            flight_dump_path=str(path), **ENGINE_KW)
        eng.warmup()

        def boom(**inputs):
            raise RuntimeError("planted step fault")

        for key, e in eng.batcher._chunk_cache.items():
            e.fn = boom
        eng.start()
        req = eng.submit(_prompts(33, (5,))[0])
        with pytest.raises(RuntimeError, match="planted"):
            req.result(timeout=60)
        assert req.state is RequestState.FAILED
        dump = eng.last_flight_dump
        assert dump["failing_record"]["mode"] == "decode"
        assert "planted" in dump["error"]
        assert json.loads(eng.last_flight_dump_json) == dump
        assert path.exists() is ok
        h = eng.health()
        assert h["status"] == "DEGRADED" and h["step_faults"] == 1
        assert h["flight_dump_errors"] == (0 if ok else 1)
        assert (eng.snapshot()["last_flight_dump_error"] is None) is ok
        assert eng.snapshot()["allocator"]["blocks_in_use"] == 0
        assert eng.shutdown(timeout=30)
