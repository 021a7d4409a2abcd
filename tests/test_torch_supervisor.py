"""The port's self-healing serving tier on the CPU:
`paddle_tpu_torch.serving.supervisor`, twins of tests/test_supervisor.py.

Backoff and breaker units, affinity invalidate-then-relearn, the seeded
hang → watchdog → respawn → readiness-gated rejoin cycle (new requests
served on the respawned slot with nothing captured after readiness), a
persistent re-hang driving the crash-loop breaker open, bounded shutdown
during an in-flight restart, and the operator reset. Tokens are held to
the JAX `ServingEngine`'s greedy output for the same prompts and weights.

The port captures nothing on the CPU, so a respawn here is fast; the
watchdog deadline (2 s) still sits far above a tiny model's CPU step
under a loaded machine and far below the injected hangs (6 s). The
deadline is wall time, and a full collection of the heap that earlier
test files left in the process pauses every thread: over a second at a
million objects, past 2 s on a loaded machine. So the module freezes
that heap (`_frozen_heap`), and its collections walk only its own
objects.
"""
import gc
import importlib.util
import pathlib
import random
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

from paddle_tpu_torch import serving  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.serving.faults import FaultInjector  # noqa: E402
from paddle_tpu_torch.serving.router import (  # noqa: E402
    Router, _AffinityIndex)
from paddle_tpu_torch.serving.supervisor import (  # noqa: E402
    ReplicaSupervisor, compute_backoff, _Slot,
    SLOT_SERVING, SLOT_RESTARTING, SLOT_FAILED)

REPO = pathlib.Path(__file__).resolve().parent.parent

_RNG = np.random.RandomState(11)
PROMPTS = [list(map(int, _RNG.randint(1, 200, n)))
           for n in (5, 7, 9, 6, 11, 4)]
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _engine_threads_finish():
    """An engine thread a hang left inside its device call runs on after
    its test; let it (and the reaper waiting on it) finish before the
    module ends, so none is still inside torch at interpreter exit."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("paddle-tpu-torch-") and t.is_alive():
            t.join(timeout=30)


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """Move every object alive before the module into the permanent
    generation, out of the collections a watchdog step would pay for."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()


_ROUTERS = []


@pytest.fixture(autouse=True)
def _routers_shut_down():
    """A test that fails before its own shutdown leaves its replicas
    serving; stop them, so they take no time from the tests after it."""
    yield
    while _ROUTERS:
        _ROUTERS.pop().shutdown(drain=False, timeout=10.0)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params


@pytest.fixture(scope="module")
def setup(jax_setup):
    """The port's (cfg, params): the JAX weights on the CPU."""
    _, jparams = jax_setup
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def baselines(jax_setup):
    """The JAX engine's greedy tokens (replica-invariant)."""
    cfg, params = jax_setup
    eng = jserving.ServingEngine(
        params, cfg, max_batch=2, block_size=4, max_total_len=48,
        max_new_tokens=MAX_NEW, chunk=3)
    out = [eng.generate(p, timeout=300) for p in PROMPTS]
    eng.shutdown()
    return out


def _router(setup, injs, **restart_opts):
    cfg, params = setup
    opts = {"backoff_s": 0.05, "poll_s": 0.02,
            "probe_timeout_s": 120.0}
    opts.update(restart_opts)
    r = Router(
        params, cfg, replicas=2, max_batch=2, block_size=4,
        max_total_len=48, max_new_tokens=MAX_NEW, chunk=3,
        max_queue_depth=32, max_prefill_bucket=16, watchdog_s=2.0,
        per_replica=[{"fault_injector": injs[0]},
                     {"fault_injector": injs[1]}],
        auto_restart=True, restart_opts=opts, start=False,
        device="cpu")
    _ROUTERS.append(r)
    return r


class TestUnits:
    def test_backoff_schedule(self):
        rng = random.Random(0)
        vals = [compute_backoff(a, base_s=0.25, max_s=8.0, jitter=0.0,
                                rng=rng) for a in range(1, 8)]
        # pure exponential with no jitter, capped at max_s
        assert vals == [0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 8.0]
        assert compute_backoff(0, base_s=1, max_s=8, jitter=0.0,
                               rng=rng) == 0.0
        # jitter scales into [1, 1+jitter) and is seed-deterministic
        a = [compute_backoff(3, base_s=0.25, max_s=8.0, jitter=0.5,
                             rng=random.Random(7)) for _ in range(2)]
        b = [compute_backoff(3, base_s=0.25, max_s=8.0, jitter=0.5,
                             rng=random.Random(7)) for _ in range(2)]
        assert a == b
        assert all(1.0 <= v / 1.0 < 1.5 for v in a)

    def test_breaker_window(self):
        class _FakeEng:
            replica_id = "r0"
        class _FakeRouter:
            engines = [_FakeEng()]
        t = [100.0]
        sup = ReplicaSupervisor(_FakeRouter(), breaker_threshold=3,
                                breaker_window_s=10.0,
                                clock=lambda: t[0])
        slot = _Slot(0)
        # two failures inside the window: breaker stays shut
        slot.failure_times.extend([100.0, 101.0])
        assert not sup._breaker_tripped(slot, consecutive=2)
        slot.failure_times.append(102.0)
        # third inside the window → open
        assert sup._breaker_tripped(slot, consecutive=3)
        # failures age out of the trailing window...
        t[0] = 111.5
        assert not sup._breaker_tripped(slot, consecutive=1)
        assert list(slot.failure_times) == [102.0]
        # ...but CONSECUTIVE failures in one cycle trip regardless of
        # window age — attempts slower than the window (a 120s probe
        # timeout vs a 60s window) must not crash-loop forever
        assert sup._breaker_tripped(slot, consecutive=3)

    def test_slot_info_shape(self):
        s = _Slot(0)
        info = s.info()
        assert info["state"] == SLOT_SERVING
        assert info["restarts"] == 0 and not info["circuit_open"]
        s.state = SLOT_RESTARTING
        assert s.info()["restarting"] is True
        s.state = SLOT_FAILED
        assert s.info()["state"] == "FAILED"

    def test_affinity_invalidate_and_relearn(self):
        idx = _AffinityIndex(block_size=2, cap=64)
        idx.observe([1, 2, 3, 4], replica=0)
        idx.observe([1, 2, 5, 6], replica=1)      # shared head re-points
        idx.observe([7, 8], replica=1)
        assert idx.match([1, 2]) == {1: 2}
        dropped = idx.invalidate(1)
        assert dropped >= 2
        # nothing points at the dead replica any more
        assert idx.match([7, 8]) == {}
        assert 1 not in idx.match([1, 2, 5, 6]).values() or \
            idx.match([1, 2, 5, 6]) == {}
        # the index re-learns from fresh routing observations
        idx.observe([7, 8], replica=1)
        assert idx.match([7, 8]) == {1: 2}

    def test_engine_ready_state(self, setup):
        cfg, params = setup
        eng = serving.ServingEngine(
            params, cfg, max_batch=1, block_size=4, max_total_len=32,
            max_new_tokens=4, chunk=2, max_prefill_bucket=8,
            start=False, device="cpu")
        assert eng.health()["ready"] is False      # not warmed, no loop
        eng.warmup()
        assert eng.health()["ready"] is False      # warm but parked
        eng.start()
        assert eng.health()["ready"] is True
        eng.shutdown()
        assert eng.health()["ready"] is False

    def test_auto_restart_rejects_prebuilt_engines(self):
        # without an engine_factory there is no rebuild recipe
        with pytest.raises(ValueError):
            Router(engines=[object()], auto_restart=True)

    def test_fuse_broken_requests_are_failover_eligible(self):
        """_mark_broken fails never-served queued/parked requests with
        fault_streak_engine_unhealthy — the default failover predicate
        must re-place them (the replica died, not the request), while
        ordinary step errors stay terminal."""
        from paddle_tpu.serving.router import _default_failover_on
        req = serving.GenerationRequest([1, 2, 3])
        err = RuntimeError("injected device error")
        assert _default_failover_on(req, err,
                                    "fault_streak_engine_unhealthy")
        assert _default_failover_on(req, err, "watchdog_hung_step")
        assert not _default_failover_on(req, err, "decode_step_raised")


def _stub_engine_cls():
    class _Stub:
        """Minimal router-shaped engine for factory plumbing units."""

        def __init__(self, rid):
            self.replica_id = rid
            self.trace = None

        def health(self):
            return {"status": "HEALTHY", "replica_id": self.replica_id}

        def load(self):
            return {"replica_id": self.replica_id, "queue_depth": 0,
                    "in_flight": 0, "parked_retries": 0,
                    "kv_utilization": 0.0, "accepting": True}

        def start(self):
            return self

        def shutdown(self, drain=True, timeout=None):
            return True

    return _Stub


class TestEngineFactory:
    def test_prebuilt_engines_accept_factory_for_auto_restart(self):
        """Prebuilt engines= + auto_restart raises
        without a rebuild recipe, but an engine_factory= IS one."""
        Stub = _stub_engine_cls()
        with pytest.raises(ValueError):
            Router(engines=[Stub("r0")], auto_restart=True)
        r = Router(engines=[Stub("r0")], auto_restart=True,
                   engine_factory=lambda i: Stub(f"r{i}"), start=False)
        assert r._supervisor is not None
        r.shutdown(drain=False)

    def test_factory_replica_id_enforced(self):
        """A factory engine with the wrong replica_id would corrupt
        per-slot metrics/trace attribution across the swap — rejected
        at build time."""
        Stub = _stub_engine_cls()
        r = Router(engines=[Stub("r0")],
                   engine_factory=lambda i: Stub("nope"), start=False)
        with pytest.raises(ValueError):
            r._build_replica(0)
        r.shutdown(drain=False)

    def test_factory_rejects_engine_kwargs(self):
        """engine kwargs / per_replica would be silently dropped by a
        factory build (the factory never reads them) — loud failure
        at construction instead."""
        Stub = _stub_engine_cls()
        with pytest.raises(ValueError):
            Router(engine_factory=lambda i: Stub(f"r{i}"), replicas=1,
                   max_batch=2, start=False)
        with pytest.raises(ValueError):
            Router(engines=[Stub("r0")],
                   engine_factory=lambda i: Stub(f"r{i}"),
                   per_replica=[{}], start=False)

    def test_factory_builds_initial_fleet(self):
        """engines=None + engine_factory builds the fleet through the
        factory (params/cfg not required)."""
        Stub = _stub_engine_cls()
        calls = []

        def fact(i):
            calls.append(i)
            return Stub(f"r{i}")

        r = Router(engine_factory=fact, replicas=2, start=False)
        assert calls == [0, 1]
        assert [e.replica_id for e in r.engines] == ["r0", "r1"]
        r.shutdown(drain=False)

    def test_prebuilt_respawn_through_factory(self, setup):
        """E2e: a prebuilt replica killed by the watchdog respawns
        THROUGH the factory, passes the readiness gate, rejoins and
        serves — the respawn that used to be impossible for
        engines=."""
        cfg, params = setup
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]
        factory_calls = []

        def build(i):
            return serving.ServingEngine(
                params, cfg, max_batch=2, block_size=4,
                max_total_len=48, max_new_tokens=MAX_NEW, chunk=3,
                max_queue_depth=32, max_prefill_bucket=16,
                watchdog_s=2.0, fault_injector=injs[i],
                replica_id=f"r{i}", start=False, device="cpu")

        def fact(i):
            factory_calls.append(i)
            return build(i)

        r = Router(engines=[build(0), build(1)], auto_restart=True,
                   engine_factory=fact,
                   restart_opts={"backoff_s": 0.05, "poll_s": 0.02,
                                 "probe_timeout_s": 120.0},
                   start=False)
        r.warmup()
        r.start()
        armed = threading.Event()
        ready = threading.Event()
        reqs = []

        def on_token(t):
            if not armed.is_set():
                armed.set()
                ready.wait(30)
                inj = injs[int(reqs[0].replica_id[1:])]
                c = inj.stats()["calls"]
                for k in range(1, 6):
                    inj.hang_on_step(c + k, 6.0)

        reqs.append(r.submit(PROMPTS[0], on_token=on_token))
        for p in PROMPTS[1:3]:
            reqs.append(r.submit(p))
        ready.set()
        outs = [q.result(300) for q in reqs]
        assert all(outs) and armed.is_set()
        for inj in injs:
            inj.heal()           # the respawn probe must run clean
        deadline = time.monotonic() + 240
        h = r.health()
        while time.monotonic() < deadline:
            h = r.health()
            if h["serving_replicas"] == 2 \
                    and h["replica_restarts"] >= 1:
                break
            time.sleep(0.05)
        assert h["replica_restarts"] >= 1, h
        assert h["serving_replicas"] == 2
        assert factory_calls, "respawn bypassed the engine_factory"
        dead = factory_calls[0]
        assert h["supervisor"][f"r{dead}"]["state"] == "SERVING"
        post = r.submit(list(PROMPTS[3]), max_new_tokens=2)
        assert post.result(300)
        assert r.shutdown()


class TestSelfHealingE2E:
    def test_hang_respawn_rejoin_and_serve(self, setup, baselines):
        """The acceptance bar: a watchdog-killed replica is respawned,
        passes the readiness gate, rejoins rotation and serves fresh
        requests with zero post-readiness recompiles — while every
        stream open during the outage fails over with the pre-failover
        stream a strict prefix, and affinity entries for the dead slot
        are invalidated then re-learned."""
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]
        r = _router(setup, injs)
        r.warmup()
        r.start()
        originals = {e.replica_id: e for e in r.engines}
        compiles0 = {e.replica_id: e.batcher.compile_count
                     for e in r.engines}
        armed = threading.Event()
        ready = threading.Event()
        reqs = []
        streamed = {i: [] for i in range(len(PROMPTS))}

        def cb(i):
            def on_token(t):
                streamed[i].append(t)
                if i == 0 and not armed.is_set():
                    armed.set()
                    ready.wait(30)
                    inj = injs[int(reqs[0].replica_id[1:])]
                    c = inj.stats()["calls"]
                    for k in range(1, 6):
                        inj.hang_on_step(c + k, 6.0)
            return on_token

        for i, p in enumerate(PROMPTS):
            reqs.append(r.submit(p, on_token=cb(i)))
        ready.set()
        outs = [q.result(300) for q in reqs]
        assert outs == baselines             # parity incl. the victims
        assert armed.is_set()
        # nothing re-emitted across the failover
        assert streamed[0] == baselines[0]
        h = r.health()
        assert h["failovers"] >= 1
        snap = r.snapshot()
        by_rid = {e["router_rid"]: e for e in snap["failover_log"]}
        kept = by_rid[reqs[0].request_id]["tokens_kept"]
        assert 0 < kept < len(baselines[0])     # strict prefix resumed
        dead_rid = by_rid[reqs[0].request_id]["from_replica"]
        # disarm leftover hang rules so the respawn probe runs clean
        for inj in injs:
            inj.heal()

        # ---- the self-healing half ----------------------------------
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            h = r.health()
            if h["serving_replicas"] == 2 and h["replica_restarts"] >= 1:
                break
            time.sleep(0.05)
        assert h["serving_replicas"] == 2, h
        assert h["replica_restarts"] >= 1
        assert h["circuit_open"] == 0 and h["failed_replicas"] == 0
        sup = h["supervisor"]
        assert sup[dead_rid]["state"] == "SERVING"
        assert sup[dead_rid]["restarts"] == 1
        respawn = next(e for e in r.engines if e.replica_id == dead_rid)
        respawn_idx = int(dead_rid[1:])
        # a NEW engine incarnation sits in the same slot, warmed, with
        # zero recompiles past its readiness gate
        assert respawn is not originals[dead_rid]
        assert respawn.health()["ready"] is True
        assert respawn.batcher.compile_count == \
            sup[dead_rid]["warm_compile_count"]
        # affinity hygiene: nothing points at the cold respawned slot
        assert all(n.replica != respawn_idx
                   for n in r._affinity._order.values())

        # post-restart: a concurrent burst of fresh short prompts (no
        # affinity pull) must land traffic on the respawned slot too
        post_rng = np.random.RandomState(99)
        post = [r.submit(list(map(int, post_rng.randint(1, 200, 3))),
                         max_new_tokens=4) for _ in range(4)]
        post_outs = [q.result(300) for q in post]
        assert all(post_outs)
        assert dead_rid in {q.replica_id for q in post}
        # survivors never recompiled either (vs their warmup baseline)
        for e in r.engines:
            if e is not respawn:
                assert e.batcher.compile_count == \
                    compiles0[e.replica_id]
        # affinity re-learns: a fresh 2-block prompt maps to whichever
        # replica served it (the respawned slot included)
        learn = list(map(int, post_rng.randint(1, 200, 8)))
        lr = r.submit(learn, max_new_tokens=2)
        lr.result(300)
        assert r._affinity.match(learn) == {int(lr.replica_id[1:]): 8}

        # observability: restarted event in the merged trace, counted
        # by trace_report's churn totals; counters in the exposition
        merged = r.to_chrome_trace()
        names = [e.get("name") for e in merged["traceEvents"]]
        assert "restarted" in names
        spec = importlib.util.spec_from_file_location(
            "trace_report", REPO / "tools" / "trace_report.py")
        tr = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tr)
        evs = [e for e in merged["traceEvents"] if e.get("ph") != "M"]
        evs.sort(key=lambda e: e.get("ts", 0.0))
        summary = tr.summarize(evs)
        assert summary["total"]["restart_events"] >= 1
        assert "restarts" in tr.render(summary)
        prom = r.to_prometheus()
        assert "paddle_tpu_replica_restarts_total" in prom
        assert r.shutdown()

    def test_persistent_hang_opens_breaker(self, setup):
        """An injector that re-hangs EVERY respawned incarnation (the
        on_attach chaos hook) must open the crash-loop circuit breaker
        within the attempt budget: the slot pins FAILED, health() and
        the Prometheus exposition surface it, and the survivor keeps
        serving."""
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]

        def rearm(inj, n, rid):
            # every RE-attach (a respawned incarnation wires the same
            # injector back in) poisons that incarnation's first
            # device calls — the readiness probe hangs, its watchdog
            # trips, the attempt fails
            if n > 1:
                c = inj.stats()["calls"]
                for k in range(1, 5):
                    inj.hang_on_step(c + k, 6.0)
        for inj in injs:
            inj.on_attach(rearm)
        r = _router(setup, injs, breaker_threshold=2,
                    breaker_window_s=300.0)
        r.warmup()
        r.start()
        armed = threading.Event()
        ready = threading.Event()
        holder = []

        def on_token(t):
            if not armed.is_set():
                armed.set()
                ready.wait(30)
                inj = injs[int(holder[0].replica_id[1:])]
                c = inj.stats()["calls"]
                for k in range(1, 6):
                    inj.hang_on_step(c + k, 6.0)

        holder.append(r.submit(PROMPTS[0], on_token=on_token))
        ready.set()
        # the victim fails over (or terminally fails if exhausted mid-
        # churn — breaker coverage is what this test gates)
        try:
            holder[0].result(300)
        except serving.RequestFailed:
            pass
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            h = r.health()
            if h["failed_replicas"] >= 1:
                break
            time.sleep(0.05)
        assert h["failed_replicas"] == 1, h
        assert h["circuit_open"] >= 1
        assert h["restart_failures"] >= 2          # the attempt budget
        assert h["replica_restarts"] == 0          # nothing rejoined
        sup = h["supervisor"]
        failed = [rid for rid, s in sup.items()
                  if s["state"] == "FAILED"]
        assert len(failed) == 1
        assert sup[failed[0]]["circuit_open"] is True
        assert sup[failed[0]]["last_error"] is not None
        # the pinned slot is out of rotation; the survivor serves on
        survivor_out = r.generate(PROMPTS[5], timeout=300)
        assert survivor_out
        assert h["serving_replicas"] == 1
        prom = r.to_prometheus()
        assert "paddle_tpu_circuit_open_total" in prom
        line = next(ln for ln in prom.splitlines()
                    if ln.startswith("paddle_tpu_circuit_open_total"))
        assert line.rstrip().endswith((" 1", " 1.0"))
        assert r.shutdown(drain=False)

    def test_shutdown_during_restart_joins_bounded(self, setup):
        """drain/shutdown while a restart is in flight (the supervisor
        parked in a long backoff after a failed attempt) interrupts
        the cycle and joins bounded — no leaked half-built replica
        keeps the process hostage."""
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]

        def rearm(inj, n, rid):
            if n > 1:
                c = inj.stats()["calls"]
                for k in range(1, 5):
                    inj.hang_on_step(c + k, 6.0)
        for inj in injs:
            inj.on_attach(rearm)
        # huge backoff: after the first failed respawn the supervisor
        # sits waiting — exactly the in-flight window shutdown must cut
        r = _router(setup, injs, backoff_s=60.0,
                    breaker_threshold=10)
        r.warmup()
        r.start()
        armed = threading.Event()
        ready = threading.Event()
        holder = []

        def on_token(t):
            if not armed.is_set():
                armed.set()
                ready.wait(30)
                inj = injs[int(holder[0].replica_id[1:])]
                c = inj.stats()["calls"]
                for k in range(1, 6):
                    inj.hang_on_step(c + k, 6.0)

        holder.append(r.submit(PROMPTS[0], on_token=on_token))
        ready.set()
        try:
            holder[0].result(300)
        except serving.RequestFailed:
            pass
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            h = r.health()
            if h["restart_failures"] >= 1 or h["restarting_replicas"]:
                break
            time.sleep(0.05)
        assert h["restart_failures"] >= 1 or h["restarting_replicas"]
        t0 = time.monotonic()
        r.shutdown(drain=False)
        # bounded: stop-event interrupts the backoff wait and the
        # probe's poll slices; teardown joins are capped
        assert time.monotonic() - t0 < 30.0
        assert r._supervisor._thread is not None
        assert not r._supervisor._thread.is_alive()


class TestBreakerReset:
    def test_reset_requires_failed_slot(self, setup):
        """reset_breaker on a SERVING slot is a no-op (False), unknown
        slots/ids raise LookupError, and a router without a supervisor
        raises RuntimeError."""
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]
        r = _router(setup, injs)
        r.warmup()
        r.start()
        out = r.reset_breaker(0)
        assert out == {"slot": 0, "replica": "r0", "reset": False,
                       "state": SLOT_SERVING}
        assert r.reset_breaker("r1")["reset"] is False
        with pytest.raises(LookupError):
            r.reset_breaker(7)
        with pytest.raises(LookupError):
            r.reset_breaker("r7")
        assert r.health()["breaker_resets"] == 0
        assert r.shutdown()
        cfg, params = setup
        plain = serving.Router(params, cfg, replicas=1, max_batch=1,
                               block_size=4, max_total_len=48,
                               max_new_tokens=2, start=False,
                               device="cpu")
        with pytest.raises(RuntimeError):
            plain.reset_breaker(0)
        plain.shutdown()

    def test_reset_revives_breaker_pinned_slot(self, setup):
        """The operator reset end to end: a persistent-hang chaos
        opens the breaker (slot FAILED), the operator heals the fault
        and calls reset_breaker — the slot re-enters the readiness-
        gated recovery cycle, rejoins rotation, and serves again; the
        breaker_resets counter and the breaker_reset trace event record
        the intervention."""
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]
        chaos = {"on": True}

        def rearm(inj, n, rid):
            if n > 1 and chaos["on"]:
                c = inj.stats()["calls"]
                for k in range(1, 5):
                    inj.hang_on_step(c + k, 6.0)
        for inj in injs:
            inj.on_attach(rearm)
        r = _router(setup, injs, breaker_threshold=2,
                    breaker_window_s=300.0)
        r.warmup()
        r.start()
        armed = threading.Event()
        ready = threading.Event()
        holder = []

        def on_token(t):
            if not armed.is_set():
                armed.set()
                ready.wait(30)
                inj = injs[int(holder[0].replica_id[1:])]
                c = inj.stats()["calls"]
                for k in range(1, 6):
                    inj.hang_on_step(c + k, 6.0)

        holder.append(r.submit(PROMPTS[0], on_token=on_token))
        ready.set()
        try:
            holder[0].result(300)
        except serving.RequestFailed:
            pass
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            h = r.health()
            if h["failed_replicas"] >= 1:
                break
            time.sleep(0.05)
        assert h["failed_replicas"] == 1, h
        failed_rid = next(rid for rid, s in h["supervisor"].items()
                          if s["state"] == "FAILED")
        # the operator fixes the underlying fault, then resets
        chaos["on"] = False
        for inj in injs:
            inj.heal()
        dead_eng = next(e for e in r.engines
                        if e.replica_id == failed_rid)
        out = r.reset_breaker(failed_rid)
        assert out["reset"] is True
        assert out["state"] == SLOT_RESTARTING
        # the breaker_reset event lands on the (still-pinned) dead
        # engine's sink at reset time — read it before the swap drops
        # that sink from the merged export
        dead_events = [e.get("name") for e in
                       dead_eng.trace.to_chrome_trace()["traceEvents"]]
        assert "breaker_reset" in dead_events
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            h = r.health()
            if h["serving_replicas"] == 2 and h["replica_restarts"] >= 1:
                break
            time.sleep(0.05)
        assert h["serving_replicas"] == 2, h
        assert h["failed_replicas"] == 0
        assert h["circuit_open"] >= 1          # history: it DID open
        assert h["breaker_resets"] == 1
        sup = h["supervisor"][failed_rid]
        assert sup["state"] == SLOT_SERVING
        assert sup["circuit_open"] is False
        # the revived slot serves: fresh no-affinity prompts spread by
        # occupancy, so a small burst must land on it
        outs = [r.submit(list(map(int, np.random.RandomState(50 + i)
                                  .randint(1, 200, 4))),
                         max_new_tokens=MAX_NEW) for i in range(4)]
        assert all(q.result(300) for q in outs)
        assert failed_rid in {q.replica_id for q in outs}
        prom = r.to_prometheus()
        assert "paddle_tpu_breaker_resets_total" in prom
        # the revival's provenance survives the swap on the FRESH
        # engine's `restarted` span in the merged artifact
        restarted = [e for e in r.to_chrome_trace()["traceEvents"]
                     if e.get("name") == "restarted"]
        assert any(e["args"].get("via_breaker_reset")
                   for e in restarted)
        assert r.shutdown(drain=False)


class TestProbeMirror:
    def test_respawn_probe_replays_live_shape(self, setup):
        """restart_opts={"probe_mirror": True}: the respawn gate
        replays the shape of the newest LIVE request served by the
        dead incarnation instead of the synthetic probe prompt — and
        falls back to the synthetic prompt when the dead engine never
        served anything."""
        cfg, params = setup
        r = Router(params, cfg, replicas=1, max_batch=2, block_size=4,
                   max_total_len=48, max_new_tokens=MAX_NEW, chunk=3,
                   max_queue_depth=32, max_prefill_bucket=16,
                   auto_restart=True, device="cpu",
                   restart_opts={"backoff_s": 0.05, "poll_s": 0.02,
                                 "probe_timeout_s": 120.0,
                                 "probe_mirror": True},
                   start=False)
        r.warmup()
        r.start()
        sup = r._supervisor
        assert sup._probe_mirror

        def planned_restart():
            dead = r.engines[0]
            assert sup.restart_slot(0)
            deadline = time.monotonic() + 300
            while sup.states()[0] != SLOT_SERVING \
                    or r.engines[0] is dead:
                assert time.monotonic() < deadline, "respawn stalled"
                time.sleep(0.02)
            return r.engines[0]

        # no live traffic yet: mirror capture finds nothing, the gate
        # falls back to the synthetic probe shape
        fresh = planned_restart()
        assert fresh.recent_prompts()[0] == ([1, 2, 3], 2)

        out = r.generate(PROMPTS[2], timeout=300)
        assert r.engines[0].recent_prompts()[-1] == (PROMPTS[2], MAX_NEW)
        # now the gate replays the live shape (newest entry — the dead
        # engine's own synthetic-probe generation is older)
        fresh = planned_restart()
        assert fresh.recent_prompts()[0] == (PROMPTS[2], MAX_NEW)
        # and the respawned sharded-or-not slot still serves correctly
        assert r.generate(PROMPTS[2], timeout=300) == out
        assert r.shutdown()


class TestTeardownMemory:
    def test_wedged_engine_freed_after_its_thread_returns(self, setup):
        """A watchdog trip leaves the engine thread inside its hung call:
        the teardown frees the batcher's pool and step graphs only once
        that thread has returned (a replay may still be running), and
        then without waiting for anyone to drop the engine."""
        from paddle_tpu_torch.serving.supervisor import \
            _collect_when_exited
        cfg, params = setup
        inj = FaultInjector()
        eng = serving.ServingEngine(
            params, cfg, max_batch=1, block_size=4, max_total_len=32,
            max_new_tokens=8, chunk=2, prefill_buckets=(8,),
            watchdog_s=0.5, fault_injector=inj, start=False, device="cpu")
        eng.warmup()
        inj.hang_on_step(1, 4.0)
        eng.start()
        r = eng.submit(PROMPTS[0])
        deadline = time.monotonic() + 30
        while eng.health()["status"] != "UNHEALTHY" \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert r.wait(timeout=5) and r.finish_reason == "watchdog_hung_step"
        eng.shutdown(drain=False, timeout=1.0)
        _collect_when_exited(eng)
        assert eng._thread.is_alive()
        assert eng.batcher.compile_count > 0      # still in the hung call
        deadline = time.monotonic() + 30
        while eng.batcher.compile_count and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not eng._thread.is_alive()
        assert eng.batcher.compile_count == 0
        assert eng.batcher.cache.k.numel() == 0
