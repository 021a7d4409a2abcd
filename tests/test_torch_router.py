"""The port's multi-replica tier on the CPU: `paddle_tpu_torch.serving`'s
Router, failover and HTTP frontend, twins of tests/test_router.py.

The routing-policy units run against stub replicas exactly as the JAX
package's do (the router is a host-side copy). The end-to-end cases
serve a tiny f32 Llama whose weights are the JAX package's (carried
across with `params_from_numpy`) and hold every routed, streamed,
failed-over and HTTP-served token to the JAX `ServingEngine`'s greedy
output for the same prompts. Replicas share one weight tree.

The failover cases' watchdog deadline (2 s) is wall time, and a full
collection of the heap that earlier test files left in the process
pauses every thread for over a second; the module freezes that heap
(`_frozen_heap`), so its collections walk only its own objects.
"""
import gc
import http.client
import importlib.util
import json
import pathlib
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
    Router, NoReplicaAvailable, default_policy, _AffinityIndex)

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


def _router(setup, *, replicas=2, per_replica=None, **kw):
    cfg, params = setup
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_total_len", 48)
    kw.setdefault("max_new_tokens", MAX_NEW)
    kw.setdefault("chunk", 3)
    kw.setdefault("max_queue_depth", 32)
    kw.setdefault("max_prefill_bucket", 16)     # small warmable ladder
    kw.setdefault("device", "cpu")
    return Router(params, cfg, replicas=replicas,
                  per_replica=per_replica, start=False, **kw)


class _StubEngine:
    """Policy-unit stand-in for a ServingEngine: canned health/load
    plus a submit() that records what the router sent it."""

    def __init__(self, replica_id, status="HEALTHY", queue_depth=0,
                 in_flight=0, util=0.0, accepting=True, full=False,
                 slo=None):
        self.replica_id = replica_id
        self.trace = None
        self._status = status
        self._slo = slo            # worst-of SLO verdict ("OK"/...)
        self._load = {"replica_id": replica_id, "queue_depth": queue_depth,
                      "in_flight": in_flight, "parked_retries": 0,
                      "kv_utilization": util, "accepting": accepting}
        self._full = full
        self.submitted = []

    def health(self):
        h = {"status": self._status, "replica_id": self.replica_id}
        if self._slo is not None:
            h["slo"] = {"verdict": self._slo}
        return h

    def load(self):
        return dict(self._load)

    def submit(self, req):
        if self._full:
            raise serving.QueueFullError("stub full")
        req.max_new_tokens = req.max_new_tokens or MAX_NEW
        self.submitted.append(req)
        return req

    def start(self):
        return self

    def cancel(self, req):
        pass

    def shutdown(self, drain=True, timeout=None):
        return True


class TestRoutingPolicy:
    def _route_once(self, router, prompt):
        req = router.submit(prompt)
        return req.replica_id

    def test_unhealthy_replica_excluded(self):
        stubs = [_StubEngine("r0", status="UNHEALTHY"),
                 _StubEngine("r1")]
        r = Router(engines=stubs, affinity_block_size=4, start=True)
        for _ in range(3):
            assert self._route_once(r, [1, 2, 3, 4]) == "r1"
        assert not stubs[0].submitted and len(stubs[1].submitted) == 3
        r.shutdown(drain=False)

    def test_occupancy_tie_break(self):
        stubs = [_StubEngine("r0", queue_depth=4, in_flight=2),
                 _StubEngine("r1", queue_depth=0, in_flight=0)]
        r = Router(engines=stubs, affinity_block_size=4, start=True)
        assert self._route_once(r, [9, 9, 9, 9]) == "r1"
        r.shutdown(drain=False)

    def test_degraded_penalized_but_still_serves(self):
        healthy_busy = _StubEngine("r0", queue_depth=3)
        degraded_idle = _StubEngine("r1", status="DEGRADED")
        r = Router(engines=[healthy_busy, degraded_idle],
                   affinity_block_size=4, start=True)
        # DEGRADED_PENALTY outweighs a small queue: traffic prefers the
        # busier healthy replica...
        assert self._route_once(r, [1, 1, 1, 1]) == "r0"
        r.shutdown(drain=False)
        # ...but a DEGRADED replica alone still serves
        r2 = Router(engines=[_StubEngine("r0", status="DEGRADED")],
                    affinity_block_size=4, start=True)
        assert self._route_once(r2, [1, 1, 1, 1]) == "r0"
        r2.shutdown(drain=False)

    def test_prefix_affinity_stickiness(self):
        # r1 is slightly busier; a shared full-block prefix routed
        # there first must keep pulling its siblings there anyway
        stubs = [_StubEngine("r0"),
                 _StubEngine("r1", in_flight=1)]
        r = Router(engines=stubs, affinity_block_size=4, start=True)
        shared = [7, 7, 7, 7, 1]
        first = self._route_once(r, shared)
        assert first == "r0"                 # idle replica wins cold
        # warm the OTHER replica's affinity by hand (as if r0 died and
        # the chain re-pointed) — siblings must follow the index
        r._affinity.observe(shared, 1)
        assert self._route_once(r, [7, 7, 7, 7, 2]) == "r1"
        # a different prefix is cold: occupancy decides again
        assert self._route_once(r, [8, 8, 8, 8, 1]) == "r0"
        r.shutdown(drain=False)

    def test_default_policy_scores(self):
        base = {"status": "HEALTHY", "queue_depth": 0, "in_flight": 0,
                "parked_retries": 0, "kv_utilization": 0.0,
                "affinity_blocks": 0, "affinity_tokens": 0}
        idle = default_policy(dict(base))
        busy = default_policy(dict(base, queue_depth=4))
        warm = default_policy(dict(base, affinity_blocks=2,
                                   affinity_tokens=8))
        degraded = default_policy(dict(base, status="DEGRADED",
                                       affinity_blocks=8,
                                       affinity_tokens=32))
        assert warm > idle > busy
        assert idle > degraded      # health outweighs full affinity cap

    def test_slo_breach_penalized_but_still_serves(self):
        """SLO-aware routing: a BREACHing replica
        loses to a busier OK one (the policy sheds load off the burn
        before supervision acts), but still serves when alone."""
        burning_idle = _StubEngine("r0", slo="BREACH")
        healthy_busy = _StubEngine("r1", queue_depth=4, in_flight=2,
                                   slo="OK")
        r = Router(engines=[burning_idle, healthy_busy],
                   affinity_block_size=4, start=True)
        # SLO_BREACH_PENALTY 10 > 6 requests * QUEUE_PENALTY 0.5
        assert self._route_once(r, [1, 2, 3, 4]) == "r1"
        r.shutdown(drain=False)
        alone = Router(engines=[_StubEngine("r0", slo="BREACH")],
                       affinity_block_size=4, start=True)
        assert self._route_once(alone, [1, 2, 3, 4]) == "r0"
        alone.shutdown(drain=False)

    def test_slo_warn_between_occupancy_and_degraded(self):
        """The penalty ladder: WARN > a small queue, BREACH > WARN,
        DEGRADED > BREACH — and a replica without SLO tracking scores
        as OK (no penalty)."""
        from paddle_tpu_torch.serving.router import (
            SLO_WARN_PENALTY, SLO_BREACH_PENALTY, DEGRADED_PENALTY,
            QUEUE_PENALTY)
        assert QUEUE_PENALTY * 4 < SLO_WARN_PENALTY \
            < SLO_BREACH_PENALTY < DEGRADED_PENALTY
        base = {"status": "HEALTHY", "queue_depth": 0, "in_flight": 0,
                "parked_retries": 0, "kv_utilization": 0.0,
                "affinity_blocks": 0, "affinity_tokens": 0}
        ok = default_policy(dict(base, slo_verdict="OK"))
        untracked = default_policy(dict(base))
        warn = default_policy(dict(base, slo_verdict="WARN"))
        breach = default_policy(dict(base, slo_verdict="BREACH"))
        degraded = default_policy(dict(base, status="DEGRADED",
                                       slo_verdict="OK"))
        busy = default_policy(dict(base, queue_depth=4))
        assert ok == untracked
        assert ok > busy > warn > breach > degraded

    def test_views_carry_slo_verdict(self):
        """_views feeds the policy the replica's worst-of verdict
        ("OK" when the stub reports no slo dict)."""
        stubs = [_StubEngine("r0", slo="WARN"), _StubEngine("r1")]
        r = Router(engines=stubs, affinity_block_size=4, start=False)
        views = {i: v for _, i, v in r._views([1, 2, 3, 4], ())}
        assert views[0]["slo_verdict"] == "WARN"
        assert views[1]["slo_verdict"] == "OK"
        r.shutdown(drain=False)

    def test_affinity_index_bound_and_repoint(self):
        idx = _AffinityIndex(block_size=2, cap=4)
        idx.observe([1, 2, 3, 4], replica=0)
        assert idx.match([1, 2, 3, 4]) == {0: 4}
        idx.observe([1, 2, 3, 4], replica=1)      # last writer wins
        assert idx.match([1, 2, 3, 4]) == {1: 4}
        for i in range(10, 20, 2):                # overflow the cap
            idx.observe([i, i + 1], replica=0)
        assert len(idx) <= 4
        assert idx.match([1, 2]) == {}            # oldest evicted


class TestRouterE2E:
    def test_two_replica_parity_mixed_lifecycle(self, setup, baselines):
        """2 replicas serve the full mixed workload (priorities, one
        cancel, one timeout) with tokens identical to the single-engine
        reference; both replicas saw traffic; pools drain clean."""
        r = _router(setup)
        r.warmup()
        r.start()
        served = [r.submit(p, priority=i % 3)
                  for i, p in enumerate(PROMPTS)]
        victim_cancel = r.submit(PROMPTS[0])
        r.cancel(victim_cancel)
        victim_timeout = r.submit(PROMPTS[1], timeout_s=0.0001)
        outs = [q.result(300) for q in served]
        assert outs == baselines
        with pytest.raises(serving.RequestCancelled):
            victim_cancel.result(60)
        with pytest.raises(serving.RequestTimedOut):
            victim_timeout.result(60)
        routed = {q.replica_id for q in served}
        assert routed == {"r0", "r1"}
        assert r.drain(30)
        for eng in r.engines:
            assert eng.batcher.alloc.stats()["blocks_in_use"] == 0
        h = r.health()
        assert h["status"] == "HEALTHY" and h["serving_replicas"] == 2
        # replicas share the weights: one tree, no per-replica copy
        w = [e.batcher.params["embed_tokens"].data_ptr() for e in r.engines]
        assert w[0] == w[1] == setup[1]["embed_tokens"].data_ptr()
        lw = [e.batcher.params["layers"]["q_proj"].data_ptr()
              for e in r.engines]
        assert lw[0] == lw[1]
        assert r.shutdown()

    def test_streaming_and_trace_routed_events(self, setup, baselines):
        r = _router(setup)
        r.start()
        got = list(r.stream(PROMPTS[2]))
        assert got == baselines[2]
        # the routed event landed on the serving replica's timeline
        merged = r.to_chrome_trace()
        routed = [e for e in merged["traceEvents"]
                  if e.get("name") == "routed"]
        assert routed and all(
            e["args"]["replica"] in ("r0", "r1") and
            e["args"]["trace_id"].split(":")[0] in ("r0", "r1")
            for e in routed)
        r.shutdown()

    def test_snapshot_and_prometheus_labels(self, setup):
        r = _router(setup)
        r.start()
        r.generate(PROMPTS[0], timeout=300)
        snap = r.snapshot()
        assert set(snap["replicas"]) == {"r0", "r1"}
        for rid, s in snap["replicas"].items():
            assert s["replica_id"] == rid
        prom = r.to_prometheus()
        assert 'replica="router"' in prom
        assert 'replica="r0"' in prom and 'replica="r1"' in prom
        # families stay grouped: each TYPE line appears exactly once
        types = [ln for ln in prom.splitlines()
                 if ln.startswith("# TYPE ")]
        assert len(types) == len(set(types))
        q = ('paddle_tpu_requests_completed_total'
             '{replica="r0"}')
        assert any(ln.startswith(q) for ln in prom.splitlines())
        r.shutdown()

    def test_backpressure_when_all_replicas_full(self, setup):
        """Every replica's admission queue rejecting surfaces as
        NoReplicaAvailable (the frontend's 429) — and the engines
        never see the overflow request."""
        r = _router(setup, max_queue_depth=1)
        # NOT started: requests pile into the admission queues
        fill = [r.submit(PROMPTS[0]) for _ in range(2)]
        with pytest.raises(NoReplicaAvailable):
            r.submit(PROMPTS[1])
        assert r.metrics.counter(
            "requests_rejected_all_replicas").value == 1
        r.start()
        assert [q.result(300) for q in fill]
        r.shutdown()


class TestRouterFailover:
    def test_failover_strict_prefix_and_parity(self, setup, baselines):
        """Hang replica r-victim mid-stream: the watchdog flips it
        UNHEALTHY, stranded requests re-admit on the survivor, every
        stream ends bit-identical to the single-engine reference with
        the pre-failover part a strict prefix (nothing re-emitted or
        lost), zero post-warmup recompiles."""
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]
        r = _router(setup, watchdog_s=2.0,
                    per_replica=[{"fault_injector": injs[0]},
                                 {"fault_injector": injs[1]}])
        r.warmup()
        r.start()
        compiles0 = [e.batcher.compile_count for e in r.engines]
        armed = threading.Event()
        ready = threading.Event()     # all submits landed (the engine-
        reqs = []                     # thread cb must not race the list)
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
        assert outs == baselines           # parity incl. the victims
        assert armed.is_set()
        h = r.health()
        assert h["failovers"] >= 1 and h["serving_replicas"] == 1
        snap = r.snapshot()
        by_rid = {e["router_rid"]: e for e in snap["failover_log"]}
        kept = by_rid[reqs[0].request_id]["tokens_kept"]
        assert 0 < kept < len(baselines[0])     # strict prefix resumed
        assert reqs[0].router_failovers == 1
        assert by_rid[reqs[0].request_id]["from_replica"] != \
            by_rid[reqs[0].request_id]["to_replica"]
        # nothing re-emitted: the client-side streams saw each token once
        assert streamed[0] == baselines[0]
        recompiles = sum(e.batcher.compile_count - c0
                         for e, c0 in zip(r.engines, compiles0))
        assert recompiles == 0
        # failover trace event landed on the new replica's timeline
        merged = r.to_chrome_trace()
        fo = [e for e in merged["traceEvents"]
              if e.get("name") == "failover"]
        assert fo and fo[0]["args"]["tokens_kept"] == kept
        r.shutdown(drain=False)

    def test_failover_disabled_fails_terminal(self, setup):
        injs = [FaultInjector(seed=0), FaultInjector(seed=1)]
        r = _router(setup, watchdog_s=2.0, failover=False,
                    per_replica=[{"fault_injector": injs[0]},
                                 {"fault_injector": injs[1]}])
        # warmed: the tight 0.3s deadline must not be stretched by the
        # unwarmed-engine compile grace (the injected hang is 1.5s)
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

        holder.append(r.submit(PROMPTS[4], on_token=on_token))
        ready.set()
        with pytest.raises(serving.RequestFailed):
            holder[0].result(300)
        assert r.health()["failovers"] == 0
        r.shutdown(drain=False)


@pytest.fixture(scope="module")
def frontend(setup):
    """Shared router + HTTP frontend on an ephemeral port."""
    r = _router(setup, max_queue_depth=32)
    r.start()
    fe = serving.HttpFrontend(r, port=0, shutdown_router=False)
    host, port = fe.start()
    yield host, port, r
    fe.shutdown()
    r.shutdown()


def _http(host, port, method, path, payload=None, timeout=300):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload)
        conn.request(method, path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class TestHttpFrontend:
    def test_generate_roundtrip(self, frontend, baselines):
        host, port, _ = frontend
        status, body = _http(host, port, "POST", "/v1/generate",
                             {"prompt": PROMPTS[0]})
        out = json.loads(body)
        assert status == 200
        assert out["tokens"] == baselines[0]
        assert out["state"] == "FINISHED"
        assert out["replica"] in ("r0", "r1")
        assert out["request_id"].startswith("req")

    def test_sse_round_trip_over_real_socket(self, frontend, baselines):
        """POST /v1/stream: routed event first, one data event per
        token in order, a terminal done event — parsed off the raw
        socket exactly as a browser's EventSource would."""
        host, port, _ = frontend
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.request("POST", "/v1/stream",
                     json.dumps({"prompt": PROMPTS[1]}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        events, cur = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                cur = line[7:]
            elif line.startswith("data: "):
                events.append((cur or "data", json.loads(line[6:])))
                cur = None
        conn.close()
        assert events[0][0] == "routed"
        assert events[0][1]["replica"] in ("r0", "r1")
        toks = [d["token"] for k, d in events if k == "data"]
        assert toks == baselines[1]
        kind, final = events[-1]
        assert kind == "done" and final["state"] == "FINISHED"
        assert final["tokens_generated"] == len(toks)

    def test_health_and_metrics_endpoints(self, frontend):
        host, port, _ = frontend
        status, body = _http(host, port, "GET", "/health")
        h = json.loads(body)
        assert status == 200
        assert h["status"] in ("HEALTHY", "DEGRADED")
        assert set(h["replicas"]) == {"r0", "r1"}
        status, body = _http(host, port, "GET", "/metrics")
        assert status == 200
        text = body.decode()
        assert 'replica="r0"' in text and 'replica="r1"' in text

    def test_bad_requests(self, frontend):
        host, port, _ = frontend
        for payload, want in [(None, 400), ({"prompt": []}, 400),
                              ({"prompt": "abc"}, 400),
                              ({"prompt": [1], "max_new_tokens": "x"},
                               400)]:
            status, _ = _http(host, port, "POST", "/v1/generate", payload)
            assert status == want
        assert _http(host, port, "GET", "/nope")[0] == 404
        assert _http(host, port, "GET", "/v1/generate")[0] == 405

    def test_backpressure_429(self, setup):
        """Both replicas' queues full → POST answers 429."""
        r = _router(setup, max_queue_depth=1)   # parked: never started
        fe = serving.HttpFrontend(r, port=0, shutdown_router=False)
        host, port = fe.start()
        fill = [r.submit(PROMPTS[0]) for _ in range(2)]
        status, body = _http(host, port, "POST", "/v1/generate",
                             {"prompt": PROMPTS[1]})
        assert status == 429, body
        r.start()
        [q.result(300) for q in fill]
        assert fe.shutdown(drain=True)   # router stays up (ours to stop)
        r.shutdown()

    def test_drain_shutdown_completes_inflight(self, setup, baselines):
        """shutdown(drain=True) finishes the in-flight SSE stream
        before the listener dies; a late request gets refused."""
        r = _router(setup)
        r.start()
        fe = serving.HttpFrontend(r, port=0, shutdown_router=True)
        host, port = fe.start()
        result = {}

        def consume():
            conn = http.client.HTTPConnection(host, port, timeout=300)
            conn.request("POST", "/v1/stream",
                         json.dumps({"prompt": PROMPTS[3]}))
            resp = conn.getresponse()
            toks = []
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.decode().rstrip("\n")
                if line.startswith("data: "):
                    d = json.loads(line[6:])
                    if "token" in d:
                        toks.append(d["token"])
                    elif "state" in d:
                        result["final"] = d
            result["tokens"] = toks
            conn.close()

        t = threading.Thread(target=consume)
        t.start()
        deadline = time.monotonic() + 30     # stream reached the router
        while r.metrics.gauge("router_inflight").value == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert fe.shutdown(drain=True, timeout=120)
        t.join(120)
        assert result["tokens"] == baselines[3]
        assert result["final"]["state"] == "FINISHED"
        with pytest.raises((ConnectionError, OSError)):
            _http(host, port, "POST", "/v1/generate",
                  {"prompt": PROMPTS[0]}, timeout=5)
        # router was drained and stopped by the frontend
        with pytest.raises(RuntimeError):
            r.submit(PROMPTS[0])


class TestTraceReportReplicas:
    def test_report_groups_by_replica_and_failovers(self, setup,
                                                    baselines, tmp_path):
        """The merged 2-replica artifact summarizes with a replica
        column, a per-replica request breakdown and failover churn."""
        spec = importlib.util.spec_from_file_location(
            "trace_report", REPO / "tools" / "trace_report.py")
        tr = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tr)
        r = _router(setup)
        r.start()
        outs = [r.generate(p, timeout=300) for p in PROMPTS[:4]]
        assert outs == baselines[:4]
        path = tmp_path / "router_trace.json"
        path.write_text(json.dumps(r.to_chrome_trace()))
        r.shutdown()
        summary = tr.summarize(tr.load_events(str(path)))
        t = summary["total"]
        assert set(t["replicas"]) <= {"r0", "r1"}
        assert sum(t["replicas"].values()) >= 4
        assert t["failover_events"] == 0
        for row in summary["requests"]:
            if row["terminal"] == "finished":
                assert row["replica"] in ("r0", "r1")
        txt = tr.render(summary)
        assert "replicas:" in txt and "failovers" in txt
