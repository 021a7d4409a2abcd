"""The port's fault-isolated serving against the JAX package's, on the CPU.

The same tiny f32 Llama (JAX weights carried across with
`params_from_numpy`), the same prompts and the same injector rules go
through the JAX `ServingEngine` and the port's. Both engines are built
with `start=False` and every request is submitted before `start()`, so
the admission order, the step sequence and with them the tick an
injected rule fires on are the same on both sides; retries back off for
0 s, so no wall clock enters the schedule. What must agree: the
convicted requests, every request's terminal state, finish reason,
tokens and retry count, and the fault counters of `health()`.

Port-only checks: the injector and the admission queue's requeue hold
the JAX units' semantics (and the same seed makes the same `fail_rate`
decisions in both packages); the two probes leave the pool, the slot
state and the prefix index bit-identical; the watchdog and its compile
grace run on a fake clock; the default retry predicate takes the
card's out-of-memory error as transient.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import serving as jserving  # noqa: E402
from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.serving import faults as jfaults  # noqa: E402

from paddle_tpu_torch import serving  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402
from paddle_tpu_torch.serving import (AdmissionQueue,  # noqa: E402
                                      FaultInjector, InjectedFault,
                                      RequestState, TraceSink)
from paddle_tpu_torch.serving.engine import _default_transient  # noqa: E402

_RNG = np.random.RandomState(11)
PROMPTS = [list(map(int, _RNG.randint(1, 200, L))) for L in (5, 7, 6, 9)]
BUDGETS = [8, 5, 7, 6]
ENGINE_KW = dict(max_batch=2, block_size=4, max_total_len=64,
                 max_new_tokens=16, chunk=2, prefill_buckets=(8,),
                 retry_backoff_s=0.0)
COUNTERS = ("step_faults", "quarantines", "requests_requeued",
            "requests_restored", "requests_retried", "requests_failed",
            "watchdog_trips")


@pytest.fixture(scope="module", autouse=True)
def _engine_threads_finish():
    """An engine thread a hang left inside its device call runs on after
    its test; let it (and the reaper waiting on it) finish before the
    module ends, so none is still inside torch at interpreter exit."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("paddle-tpu-torch-") and t.is_alive():
            t.join(timeout=30)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


# each scenario: (engine kwargs, a function arming an injector)
SCENARIOS = {
    # rid 0 (the first admission) poisoned from the 3rd device call on
    "poison": ({}, lambda inj: inj.fail_on_rid(0, after_step=2)),
    # fail-once-then-heal: no probe reproduces it, the suspects retry
    "transient": ({}, lambda inj: inj.fail_on_step(3, transient=True)),
    # allocator pressure: transient by construction
    "exhaust": ({}, lambda inj: inj.exhaust_on_step(2)),
    # three failing calls in a row burn a two-retry budget
    "exhausted": ({"max_retries": 2},
                  lambda inj: inj.fail_rate(1.0, times=3, transient=True)),
    # seeded background noise
    "fail_rate": ({"max_retries": 3},
                  lambda inj: inj.fail_rate(0.25, times=4)),
    # quarantine off: every in-flight request fails
    "no_quarantine": ({"quarantine": False},
                      lambda inj: inj.fail_on_step(3)),
    # a failed spec tick: survivors re-admit with speculation off
    "spec": ({"speculative": True, "spec_k": 2},
             lambda inj: inj.fail_on_step(4, transient=True)),
}


def _run(eng, inj):
    reqs = [eng.submit(p, max_new_tokens=mn)
            for p, mn in zip(PROMPTS, BUDGETS)]
    eng.start()
    assert eng.drain(timeout=300)
    h = eng.health()
    out = {
        "states": [r.state.name for r in reqs],
        "reasons": [r.finish_reason for r in reqs],
        "tokens": [list(r.tokens) for r in reqs],
        "retries": [r.retries for r in reqs],
        "spec_opt_out": [r.spec_opt_out for r in reqs],
        "counters": {k: h[k] for k in COUNTERS},
        "status": h["status"],
        "injector": {k: v for k, v in inj.stats().items()
                     if k != "attachments"},
        "blocks_in_use": eng.snapshot()["allocator"]["blocks_in_use"],
        "failing_mode": (eng.last_flight_dump or {}).get(
            "failing_record", {}).get("mode"),
    }
    assert eng.shutdown(timeout=60)
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    jcfg, jparams, _, _ = models
    runs = {}
    for name, (kw, arm) in SCENARIOS.items():
        inj = arm(jfaults.FaultInjector(seed=5))
        eng = jserving.ServingEngine(jparams, jcfg, start=False,
                                     fault_injector=inj, **ENGINE_KW, **kw)
        runs[name] = _run(eng, inj)
    return runs


def _port_engine(models, inj=None, **kw):
    _, _, tcfg, tparams = models
    return serving.ServingEngine(tparams, tcfg, device="cpu", start=False,
                                 fault_injector=inj, **{**ENGINE_KW, **kw})


# ---- the injector and the queue (no engine) -----------------------------
class TestFaultInjector:
    def test_fail_on_step_fires_once_at_exact_call(self):
        inj = FaultInjector().fail_on_step(2)
        inj.check("decode", [0])
        with pytest.raises(InjectedFault):
            inj.check("decode", [0])
        inj.check("decode", [0])
        assert inj.stats()["injected"] == {"error": 1}

    def test_fail_on_rid_matches_probes_but_step_rules_do_not(self):
        inj = FaultInjector().fail_on_rid(7).fail_on_step(1, times=5)
        with pytest.raises(InjectedFault):
            inj.check("probe", [7], probe=True)
        inj.check("probe", [3], probe=True)
        assert inj.stats()["calls"] == 0
        with pytest.raises(InjectedFault):
            inj.check("decode", [3])

    def test_after_step_delays_rid_poison(self):
        inj = FaultInjector().fail_on_rid(1, after_step=2)
        inj.check("decode", [1])
        inj.check("decode", [1])
        with pytest.raises(InjectedFault):
            inj.check("decode", [1])

    def test_exhaust_is_transient(self):
        inj = FaultInjector().exhaust_on_step(1)
        with pytest.raises(InjectedFault) as ei:
            inj.check("prefill", [0])
        assert ei.value.transient is True and ei.value.kind == "oom"
        assert "RESOURCE_EXHAUSTED" in str(ei.value)

    @pytest.mark.parametrize("seed", [3, 4, 11])
    def test_fail_rate_decisions_equal_jax(self, seed):
        """The same seed makes the same decisions in both packages."""
        def pattern(mod):
            inj = mod.FaultInjector(seed=seed).fail_rate(0.4, times=None)
            out = []
            for _ in range(48):
                try:
                    inj.check("decode", [0])
                    out.append(0)
                except mod.InjectedFault:
                    out.append(1)
            return out, inj.stats()

        from paddle_tpu_torch.serving import faults as tfaults
        port, jx = pattern(tfaults), pattern(jfaults)
        assert port == jx
        assert sum(port[0]) > 0

    def test_hang_sleeps_and_heal_disarms(self):
        inj = FaultInjector().hang_on_step(1, seconds=0.05)
        t0 = time.perf_counter()
        inj.check("decode", [0])
        assert time.perf_counter() - t0 >= 0.05
        inj.fail_on_rid(9).heal()
        inj.check("decode", [9])
        assert inj.stats()["armed_rules"] == 0

    def test_default_transient_takes_out_of_memory(self):
        assert _default_transient(InjectedFault("x", transient=True))
        assert not _default_transient(InjectedFault("x"))
        assert _default_transient(torch.cuda.OutOfMemoryError("CUDA oom"))
        assert not _default_transient(RuntimeError("illegal address"))


class TestAdmissionRequeue:
    def test_requeue_beats_every_priority_and_keeps_order(self):
        q = AdmissionQueue(max_depth=8, aging_interval_s=0)
        q.push("low", priority=5)
        q.push("high", priority=0)
        q.requeue(["v1", "v2"])
        assert [q.pop() for _ in range(4)] == ["v1", "v2", "high", "low"]

    def test_requeue_bypasses_max_depth(self):
        q = AdmissionQueue(max_depth=1)
        q.push("a")
        q.requeue(["v"])
        assert len(q) == 2 and q.peek() == "v" and q.pop() == "v"

    def test_later_requeue_batch_goes_in_front(self):
        q = AdmissionQueue(max_depth=8)
        q.requeue(["r1"])
        q.requeue(["r2a", "r2b"])
        assert [q.pop() for _ in range(3)] == ["r2a", "r2b", "r1"]


# ---- the quarantine against the JAX engine ------------------------------
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_quarantine_outcome_equals_jax(models, jax_runs, name):
    """Convicted requests, terminal states and reasons, survivors'
    greedy tokens, retries, the spec fallback and the fault counters are
    the JAX engine's under the same rules; the pool drains."""
    kw, arm = SCENARIOS[name]
    inj = arm(FaultInjector(seed=5))
    port = _run(_port_engine(models, inj, **kw), inj)
    ref = jax_runs[name]
    assert port == ref
    assert port["blocks_in_use"] == 0
    assert port["counters"]["step_faults"] >= 1


def test_scenarios_exercise_each_path(jax_runs):
    """The scenarios reach what they are named for (on the JAX side, so
    the parity test above holds the port to each path)."""
    r = jax_runs
    assert r["poison"]["states"].count("FAILED") == 1
    assert r["poison"]["reasons"][0] == "quarantine_culprit"
    assert r["poison"]["counters"]["requests_restored"] >= 1
    assert max(r["transient"]["retries"]) == 1
    assert "FAILED" not in r["transient"]["states"]
    assert r["exhaust"]["counters"]["requests_retried"] >= 1
    assert r["exhausted"]["reasons"][0] == "retries_exhausted"
    assert r["exhausted"]["retries"][0] == 2
    assert r["no_quarantine"]["counters"]["quarantines"] == 0
    assert "decode_step_raised" in r["no_quarantine"]["reasons"]
    assert r["spec"]["failing_mode"].startswith("spec")
    assert any(r["spec"]["spec_opt_out"])


def test_poisoned_rid_mid_stream_keeps_strict_prefix(models):
    """The JAX headline gate on the port: a poison armed at the culprit's
    first streamed token fails only it, mid-stream; innocents finish
    with the fault-free run's tokens, the warmed engine captures
    nothing, the pool drains and the innocents were restored in place."""
    base_eng = _port_engine(models)
    base_eng.warmup()
    base = _run(base_eng, FaultInjector())["tokens"]

    inj = FaultInjector(seed=0)
    eng = _port_engine(models, inj)
    eng.warmup()
    warm = eng.batcher.compile_count
    armed = threading.Event()

    def arm(tok):
        if not armed.is_set():
            armed.set()
            inj.fail_on_rid(culprit.request_id)

    culprit = serving.GenerationRequest(PROMPTS[1],
                                        max_new_tokens=BUDGETS[1],
                                        on_token=arm)
    reqs = [eng.submit(culprit) if i == 1 else eng.submit(p,
                                                          max_new_tokens=mn)
            for i, (p, mn) in enumerate(zip(PROMPTS, BUDGETS))]
    eng.start()
    assert eng.drain(timeout=300)
    assert culprit.state is RequestState.FAILED
    assert culprit.finish_reason == "quarantine_culprit"
    assert culprit.tokens and culprit.tokens == base[1][:len(culprit.tokens)]
    for i in (0, 2, 3):
        assert reqs[i].result(timeout=5) == base[i]
    assert eng.batcher.compile_count == warm
    assert eng.batcher.alloc.stats()["blocks_in_use"] == 0
    h = eng.health()
    assert h["status"] == "DEGRADED" and h["requests_restored"] >= 1
    tl = eng.trace.timeline(culprit.trace_id)
    assert tl["events"][-1]["kind"] == "failed"
    assert eng.shutdown(timeout=60)


def test_spec_fallback_stops_suffix_launches(models):
    """A failed spec tick's survivors re-admit with speculation off: with
    every request riding the failed tick, no spec tick (the path that
    reaches row 18's suffix option) runs after the fault, and the tokens
    are plain greedy's."""
    calls = []

    class SpecFault(FaultInjector):
        """Fails the first spec tick, transiently; records every call."""

        def check(self, mode, rids, probe=False):
            calls.append(mode)
            if mode.startswith("spec") and "fired" not in calls:
                calls.append("fired")
                raise InjectedFault("spec tick fault", transient=True)
            super().check(mode, rids, probe=probe)

    def run(inj, **kw):
        eng = _port_engine(models, inj, max_batch=4, **kw)
        reqs = [eng.submit(p, max_new_tokens=16) for p in PROMPTS]
        eng.start()
        assert eng.drain(timeout=120)
        out = [r.result(timeout=5) for r in reqs]
        assert eng.shutdown(timeout=30)
        return out, reqs

    plain, _ = run(FaultInjector())
    out, reqs = run(SpecFault(), speculative=True, spec_k=2)
    assert out == plain
    assert all(r.spec_opt_out and r.retries == 1 for r in reqs)
    hit = calls.index("fired")
    assert calls[hit - 1].startswith("spec")
    assert not any(m.startswith("spec") for m in calls[hit + 1:])


# ---- probes: nothing committed -------------------------------------------
def _pool_state(cb):
    c = cb.cache
    parts = [c.k.clone(), c.v.clone()]
    if c.k_scale is not None:
        parts += [c.k_scale.clone(), c.v_scale.clone()]
    return parts


def _slot_state(cb):
    c = cb.cache
    return ([c.table.clone(), c.lengths.clone(), cb.cur_tok.clone(),
             cb._dev_active.clone(), cb._dev_budget.clone()],
            (list(cb.active), list(cb.slot_req), list(cb.budget),
             [list(b) if b else b for b in cb.slot_blocks],
             {r: list(o) for r, o in cb.outputs.items()}))


def _index_state(cb):
    idx = cb._pcache
    return ({b: (n.key, sorted(c.block for c in n.children.values()))
             for b, n in idx._by_block.items()},
            {k: v for k, v in cb.alloc.stats().items()
             if k != "high_water_blocks"}, list(cb.queue))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_probes_commit_nothing(models, kv_dtype):
    """Both probe kinds leave every pool block (but the write sink), the
    slot state, the prefix index, the allocator and the batcher queue
    exactly as they were — the int8 pool's scales and codes included."""
    _, _, tcfg, tparams = models
    cb = tpaged.ContinuousBatcher(
        tparams, tcfg, max_batch=2, block_size=4, max_total_len=48,
        max_new_tokens=12, chunk=3, prefill_buckets=(8, 16),
        prefix_cache=True, kv_dtype=kv_dtype, num_blocks=40, device="cpu")
    ra = cb.submit(PROMPTS[3])
    cb.submit(PROMPTS[0])
    for _ in range(2):
        cb.step()
    queued = cb.submit(PROMPTS[3][:8] + [3, 1, 4])    # shares a block
    slot = cb.slot_req.index(ra)
    sink = cb.alloc.num_blocks

    def pool():
        return [t[:, :sink] for t in _pool_state(cb)]
    before = (pool(), _slot_state(cb), _index_state(cb))
    cb.probe_decode_slot(slot)
    cb.probe_queued(queued)
    after = (pool(), _slot_state(cb), _index_state(cb))
    assert _same(before[0], after[0])
    assert _same(before[1][0], after[1][0])
    assert before[1][1] == after[1][1]
    assert before[2] == after[2]
    # and the batcher serves on to the same tokens as an unprobed twin
    twin = tpaged.ContinuousBatcher(
        tparams, tcfg, max_batch=2, block_size=4, max_total_len=48,
        max_new_tokens=12, chunk=3, prefill_buckets=(8, 16),
        prefix_cache=True, kv_dtype=kv_dtype, num_blocks=40, device="cpu")
    for p in (PROMPTS[3], PROMPTS[0]):
        twin.submit(p)
    for _ in range(2):
        twin.step()
    twin.submit(PROMPTS[3][:8] + [3, 1, 4])
    assert cb.run() == twin.run()


def test_probe_replays_warmed_shapes(models):
    """A quarantine on a warmed engine captures nothing: the decode probe
    is the plain chunk, the queued probe a (1, bucket) ladder entry."""
    _, _, tcfg, tparams = models
    cb = tpaged.ContinuousBatcher(
        tparams, tcfg, max_batch=2, block_size=4, max_total_len=48,
        max_new_tokens=12, chunk=3, prefill_buckets=(8, 16),
        prefix_cache=True, device="cpu")
    cb.warmup_prefill()
    n = cb.compile_count
    ra = cb.submit(PROMPTS[2])
    cb.step()
    q = cb.submit(PROMPTS[1])
    cb.probe_decode_slot(cb.slot_req.index(ra))
    cb.probe_queued(q)
    assert cb.compile_count == n


# ---- the watchdog on a fake clock ----------------------------------------
class _Clock:
    def __init__(self):
        self.t = 1000.0
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            return self.t

    def advance(self, dt):
        with self.lock:
            self.t += dt


class _StallInjector(FaultInjector):
    """At the armed rid's next device call, move the fake clock by
    `jump` seconds and hold the call long enough for the watchdog to poll
    it several times — a hung step, on the engine's own clock."""

    def __init__(self, clock, jump, hold=0.5):
        super().__init__()
        self.clock, self.jump, self.hold = clock, jump, hold
        self.rid = None

    def check(self, mode, rids, probe=False):
        super().check(mode, rids, probe=probe)
        if self.rid is not None and self.rid in rids and not probe:
            self.rid = None
            self.clock.advance(self.jump)
            time.sleep(self.hold)


def _stall_engine(models, clock, inj, warm, **kw):
    eng = _port_engine(models, inj, max_batch=1, max_total_len=32,
                       max_new_tokens=8, fused_prefill=False,
                       clock=clock, **kw)
    if warm:
        eng.warmup()
    return eng


def _arm_stall(eng, inj):
    r = serving.GenerationRequest(PROMPTS[0])

    def arm(tok):
        if inj.rid is None and r.tokens and len(r.tokens) == 1:
            inj.rid = r.request_id
    r.on_token = arm
    eng.submit(r)
    eng.start()
    return r


def _wait_status(eng, status, seconds=30.0):
    deadline = time.monotonic() + seconds
    while eng.health()["status"] != status and time.monotonic() < deadline:
        time.sleep(0.01)
    return eng.health()


def test_hung_step_trips_watchdog_and_shutdown_returns(models):
    """A step stuck past the deadline trips the watchdog: health goes
    UNHEALTHY, the stranded request fails with the HungStepError, the
    flight dump names the hung decode tick, drain() and shutdown(drain=
    False) return at once and submit() is refused."""
    clock = _Clock()
    inj = _StallInjector(clock, jump=5.0, hold=2.0)
    eng = _stall_engine(models, clock, inj, warm=True, watchdog_s=2.0)
    r = _arm_stall(eng, inj)
    h = _wait_status(eng, "UNHEALTHY")
    assert h["watchdog_trips"] == 1
    assert r.state is RequestState.FAILED
    assert r.finish_reason == "watchdog_hung_step"
    with pytest.raises(serving.RequestFailed) as ei:
        r.result(timeout=5)
    assert "watchdog" in repr(ei.value.request.error)
    dump = eng.last_flight_dump
    assert dump["failing_record"]["mode"] == "decode"
    assert dump["failing_record"]["rids"] == [r.request_id]
    assert eng.drain(timeout=1.0)
    t0 = time.monotonic()
    eng.shutdown(drain=False)
    assert time.monotonic() - t0 < 2.5
    with pytest.raises(serving.EngineStopped):
        eng.submit(PROMPTS[1])


@pytest.mark.parametrize("warm,grace,trips", [
    (False, 16.0, 0),      # the compile grace covers an unwarmed step
    (False, 1.0, 1),       # ... and only the grace does
    (True, 16.0, 1),       # a warmed engine gets no grace
])
def test_watchdog_compile_grace(models, warm, grace, trips):
    clock = _Clock()
    inj = _StallInjector(clock, jump=5.0)
    eng = _stall_engine(models, clock, inj, warm=warm, watchdog_s=1.0,
                        watchdog_compile_grace=grace)
    r = _arm_stall(eng, inj)
    if trips:
        assert _wait_status(eng, "UNHEALTHY")["watchdog_trips"] == 1
        assert r.state is RequestState.FAILED
        eng.shutdown(drain=False)
    else:
        assert len(r.result(timeout=60)) == 8
        assert eng.health()["watchdog_trips"] == 0
        assert eng.shutdown(timeout=30)


def test_healthy_run_never_trips(models):
    eng = _port_engine(models, watchdog_s=30.0, max_batch=1,
                       max_total_len=32, max_new_tokens=4)
    eng.start()
    assert eng.generate(PROMPTS[0], timeout=120)
    h = eng.health()
    assert h["status"] == "HEALTHY" and h["watchdog_trips"] == 0
    assert eng.shutdown(timeout=30) is True


def test_fault_fuse_marks_engine_broken(models):
    """Eight consecutive failed steps fail the in-flight set and mark
    the engine broken (UNHEALTHY, not accepting): the path a sticky CUDA
    error takes, since every probe and step then raises."""
    inj = FaultInjector().fail_rate(1.0, times=None, transient=True)
    eng = _port_engine(models, inj, max_retries=100)
    reqs = [eng.submit(p, max_new_tokens=mn)
            for p, mn in zip(PROMPTS, BUDGETS)]
    eng.start()
    for r in reqs:
        r.wait(timeout=120)
    h = _wait_status(eng, "UNHEALTHY")
    assert h["broken"] == "fault_streak" and not h["ready"]
    assert not eng.load()["accepting"]
    assert all(r.state is RequestState.FAILED for r in reqs)
    eng.shutdown(drain=False)


# ---- satellites ----------------------------------------------------------
def test_chaos_with_cancel_and_deadline_races_leaks_nothing(models):
    inj = FaultInjector(seed=5).fail_rate(0.25, times=6, transient=True)
    eng = _port_engine(models, inj, max_retries=3, retry_backoff_s=0.01)
    eng.warmup()
    eng.start()
    reqs = []
    for i, (p, mn) in enumerate(zip(PROMPTS * 2, BUDGETS * 2)):
        kw = {"max_new_tokens": mn}
        if i % 4 == 3:
            kw["timeout_s"] = 0.05
        reqs.append(eng.submit(p, **kw))
    reqs[1].cancel()
    assert eng.drain(timeout=120)
    assert all(r.done for r in reqs)
    assert eng.batcher.alloc.stats()["blocks_in_use"] == 0
    assert not eng.batcher._pending and not eng.batcher.queue
    inj.heal()
    assert eng.generate(PROMPTS[0], timeout=120)
    assert eng.shutdown(timeout=30)


def test_flight_dump_write_failure_is_counted(models, tmp_path):
    inj = FaultInjector().fail_on_step(3)
    eng = _port_engine(models, inj, max_batch=1, max_total_len=32,
                       max_new_tokens=8, flight_dump_path=str(tmp_path))
    r = eng.submit(PROMPTS[0])
    eng.start()
    with pytest.raises(serving.RequestFailed):
        r.result(timeout=120)
    snap = eng.snapshot()
    assert snap["counters"]["flight_dump_errors"] == 1
    assert snap["last_flight_dump_error"] is not None
    assert eng.last_flight_dump_json is not None
    eng.shutdown(timeout=30)


def test_requeue_poisoned_cascade_is_traced(models):
    _, _, tcfg, tparams = models
    sink = TraceSink()
    cb = tpaged.ContinuousBatcher(
        tparams, tcfg, max_batch=4, block_size=4, max_total_len=64,
        max_new_tokens=8, chunk=3, prefix_cache=True, prefill_buckets=(4,),
        fused_prefill=True, trace=sink, device="cpu")
    rng = np.random.RandomState(3)
    long_p = list(map(int, rng.randint(1, 200, 20)))
    shared = list(map(int, rng.randint(1, 200, 8)))
    cb.submit(PROMPTS[0])
    cb.step()
    cb.submit(long_p)
    ra = cb.submit(shared + [3, 5])
    rb = cb.submit(shared + [7, 11])
    cb.step()
    assert cb.abort(ra) is True
    ev = next(e for e in sink.timeline(rb)["events"]
              if e["kind"] == "requeued")
    assert ev["attrs"]["reason"] == "poisoned_sibling"
    cb.run()
    assert cb.alloc.stats()["blocks_in_use"] == 0


def test_prometheus_exports_fault_counters(models):
    eng = _port_engine(models, max_batch=1, max_total_len=16,
                       max_new_tokens=2)
    text = eng.metrics.to_prometheus()
    for name in ("step_faults", "quarantines", "requests_requeued",
                 "requests_restored", "requests_retried", "watchdog_trips",
                 "flight_dump_errors", "kv_exports", "kv_imports",
                 "prefill_handoffs"):
        assert f"paddle_tpu_{name}_total 0.0" in text
    eng.shutdown(timeout=10)
