"""paddle_tpu_torch.serving.router — multi-replica routing over N
ServingEngines.

The port's copy of paddle_tpu/serving/router.py (host-side only, no
torch): one `Router` owns N `ServingEngine` replicas, each with its own
batcher, KV block pool and prefix cache, and picks a replica per request
by a pluggable policy scoring

  * **health** — `engine.health()`: UNHEALTHY replicas are excluded,
    DEGRADED ones are penalized but stay in rotation;
  * **occupancy** — `engine.load()`: queue depth, in-flight count and
    KV-pool utilization, so bursts spread instead of piling onto one
    pool;
  * **prefix affinity** — a router-level token-content prefix index over
    full KV blocks, so prefix siblings land on the replica already
    holding their blocks.

Cross-replica failover: every client request is a router-owned handle
the replica-side request streams into. When a replica flips UNHEALTHY
(the watchdog) its stranded requests FAIL with `HungStepError` and the
router re-admits each on another healthy replica with `prompt + tokens
already streamed` — or imports the KV snapshot a dying engine attached —
so the client's stream before the failover is a strict prefix of the
final one.

Self-healing: with `auto_restart=True` a `ReplicaSupervisor`
(`serving.supervisor`) tears an UNHEALTHY replica down and rebuilds it
in the same slot behind a readiness gate (`warmup()` plus a probe
generation), with exponential backoff and a crash-loop breaker.

Disaggregated serving: `disaggregated=True` admits on prefill-capable
replicas and, when a prefill-role replica finishes a request at
"prefill_complete", migrates its `KVSnapshot` to the decode-capable
replica the policy picks — imported with zero prefill chunks.

Replicas on one card share the weights: every engine is built from the
SAME `params` tree, so N replicas of an 8B model hold one copy of it
(each holds its own KV pool and graph memory pool).

Lock order: `Router._lock` → `ServingEngine._lock` →
`AdmissionQueue._lock` — no engine code path calls back into the router.

    router = Router(params, cfg, replicas=2, max_batch=4, ...)
    req = router.submit(prompt_ids)        # routed GenerationRequest
    for tok in req.stream(): ...
    router.health()                        # worst-of + per-replica
    router.to_prometheus()                 # replica="rN" labels
    router.shutdown()                      # graceful drain

`serving.frontend.HttpFrontend` serves this object over HTTP.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .engine import EngineStopped, HungStepError
from .metrics import MetricsRegistry
from .request import GenerationRequest, RequestState
from .scheduler import QueueFullError
from .slo import rollup as slo_rollup

__all__ = ["Router", "NoReplicaAvailable", "default_policy"]

# default_policy weights: one queued-or-running request costs
# QUEUE_PENALTY, full KV-pool utilization costs UTIL_PENALTY, each
# affinity-matched full block earns AFFINITY_BLOCK_SCORE (capped at
# AFFINITY_BLOCK_CAP so a long warm prefix cannot justify an unbounded
# queue), and a DEGRADED replica pays DEGRADED_PENALTY — larger than
# the affinity cap, so a healthy cold replica always outranks a
# degraded warm one. A replica whose SLO verdict is WARN/BREACH pays
# SLO_WARN_PENALTY/SLO_BREACH_PENALTY — sized BETWEEN the occupancy
# weights and DEGRADED_PENALTY, so the policy steers load away from a
# burning replica before supervision has to act, but a breaching
# replica still outranks a DEGRADED one (SLOs degrade, health
# decides) and still serves when it is the only one left.
QUEUE_PENALTY = 0.5
UTIL_PENALTY = 2.0
AFFINITY_BLOCK_SCORE = 1.0
AFFINITY_BLOCK_CAP = 8
DEGRADED_PENALTY = 16.0
SLO_WARN_PENALTY = 4.0
SLO_BREACH_PENALTY = 10.0

_HEALTH_ORDER = {"HEALTHY": 0, "DEGRADED": 1, "UNHEALTHY": 2}

# role capability sets for disaggregated placement: admission may land
# on any prefill-capable replica, a KV migration may land on any
# decode-capable one. "both" replicas qualify for either side, so a
# mixed fleet (dedicated prefill + general-purpose) still routes.
_PREFILL_ROLES = ("prefill", "both")
_DECODE_ROLES = ("decode", "both")


class NoReplicaAvailable(QueueFullError):
    """Every replica either refused admission (queue full), stopped
    accepting, or is UNHEALTHY — the router-level backpressure signal
    (`serving.frontend` maps it to HTTP 429). Subclasses
    `QueueFullError` so engine-style backpressure handling composes."""


def default_policy(view: Dict[str, Any]) -> float:
    """Score one replica for one request (higher = better). `view` is
    the merged `engine.load()` + `engine.health()["status"]` dict plus
    `affinity_blocks`/`affinity_tokens` from the router's prefix index
    and `slo_verdict` (the replica's worst-of SLO verdict, "OK" when
    SLO tracking is off; UNHEALTHY replicas never reach the policy —
    the router hard-excludes them first). The default trades occupancy
    against prefix warmth: an affinity block outweighs up to two
    queued requests, a DEGRADED state outweighs the whole affinity
    cap, and a WARN/BREACH SLO verdict sits between the two — the
    policy sheds load off a burning replica before it degrades, yet a
    breaching replica still beats a DEGRADED one and still serves
    alone. Replace with any callable of the same shape via
    `Router(policy=...)`."""
    score = 0.0
    if view["status"] == "DEGRADED":
        score -= DEGRADED_PENALTY
    verdict = view.get("slo_verdict") or "OK"
    if verdict == "BREACH":
        score -= SLO_BREACH_PENALTY
    elif verdict == "WARN":
        score -= SLO_WARN_PENALTY
    score -= QUEUE_PENALTY * (view["queue_depth"] + view["in_flight"]
                              + view["parked_retries"])
    score -= UTIL_PENALTY * view["kv_utilization"]
    score += AFFINITY_BLOCK_SCORE * min(view["affinity_blocks"],
                                        AFFINITY_BLOCK_CAP)
    return score


class _AffinityNode:
    """One full block of an observed prefix chain: `key` is the block's
    token tuple, `replica` the index of the replica last routed a
    request carrying this prefix (last-writer-wins, so failover
    re-points siblings at the surviving replica), `parent` the
    children-dict this node lives in (unlink without a root walk)."""

    __slots__ = ("key", "replica", "children", "parent", "uid")

    def __init__(self, key: Tuple[int, ...], replica: int,
                 parent: Dict, uid: int):
        self.key = key
        self.replica = replica
        self.parent = parent
        self.uid = uid
        self.children: Dict[Tuple[int, ...], "_AffinityNode"] = {}


class _AffinityIndex:
    """Router-level prefix→replica index: a bounded trie over FULL-block
    token contents (the prefix cache's keying — exact tuples, no hash
    aliasing) mapping each observed prefix block to the replica last
    routed a request carrying it. Unlike the per-replica `PrefixCacheIndex` this
    tracks no pool blocks and owns no refcounts — it only remembers
    *where* a prefix's KV is likely warm. FIFO-bounded at `cap` nodes:
    the oldest observation unlinks (descendants go unreachable and age
    out the same way, mirroring PrefixCacheIndex.evict's
    orphan-tolerant bookkeeping)."""

    def __init__(self, block_size: int, cap: int = 4096):
        self.bs = max(1, int(block_size))
        self.cap = max(1, int(cap))
        self._children: Dict[Tuple[int, ...], _AffinityNode] = {}
        self._order: "OrderedDict[int, _AffinityNode]" = OrderedDict()
        self._uid = 0

    def __len__(self) -> int:
        return len(self._order)

    def observe(self, tokens: Sequence[int], replica: int) -> None:
        """Record that `tokens`' full-block prefix chain was just routed
        to `replica` (creates missing nodes, re-points existing ones)."""
        children = self._children
        for i in range(len(tokens) // self.bs):
            key = tuple(tokens[i * self.bs:(i + 1) * self.bs])
            node = children.get(key)
            if node is None:
                node = _AffinityNode(key, int(replica), children, self._uid)
                children[key] = node
                self._order[self._uid] = node
                self._uid += 1
                while len(self._order) > self.cap:
                    _, old = self._order.popitem(last=False)
                    if old.parent.get(old.key) is old:
                        del old.parent[old.key]
            else:
                node.replica = int(replica)
            children = node.children

    def match(self, tokens: Sequence[int]) -> Dict[int, int]:
        """Matched-prefix tokens per replica: walk the longest recorded
        chain for `tokens` and credit each matched block's `block_size`
        tokens to the replica owning it (a chain re-pointed mid-way by
        failover credits both owners their share)."""
        out: Dict[int, int] = {}
        children = self._children
        for i in range(len(tokens) // self.bs):
            node = children.get(tuple(tokens[i * self.bs:(i + 1) * self.bs]))
            if node is None:
                break
            out[node.replica] = out.get(node.replica, 0) + self.bs
            children = node.children
        return out

    def invalidate(self, replica: int) -> int:
        """Drop every node pointing at `replica` — called when a slot's
        engine is respawned with an EMPTY KV pool: last-writer-wins
        re-pointing must not keep steering prefix siblings to a cold
        replica. Descendant nodes owned by other replicas may go
        unreachable and age out through the FIFO bound (the same
        orphan-tolerant bookkeeping eviction uses). Returns the number
        of nodes dropped; the index re-learns from routed traffic."""
        doomed = [uid for uid, node in self._order.items()
                  if node.replica == int(replica)]
        for uid in doomed:
            node = self._order.pop(uid)
            if node.parent.get(node.key) is node:
                del node.parent[node.key]
        return len(doomed)


class _Routed:
    """Router-side state of one in-flight request: the client-facing
    `outer` handle, the replica-side `inner` request currently serving
    it, the serving replica index, and the failover budget spent."""

    __slots__ = ("outer", "inner", "idx", "failovers", "user_on_token",
                 "total_new")

    def __init__(self, outer, inner, idx, user_on_token, total_new):
        self.outer = outer
        self.inner = inner
        self.idx = idx
        self.failovers = 0
        self.user_on_token = user_on_token
        self.total_new = total_new


def _default_failover_on(req: GenerationRequest,
                         error: Optional[BaseException],
                         reason: Optional[str]) -> bool:
    """The default failover predicate: re-admit on another replica only
    when the failure indicts the REPLICA, not the request — the
    hung-step watchdog's `HungStepError` terminals (stranded in-flight
    work and quarantine-requeued victims failed when the engine thread
    wedged), the fault-streak fuse's `fault_streak_engine_unhealthy`
    (queued/parked requests the broken replica never served — the
    replica died, not the request), and the restart pipeline's
    `drained_for_restart` / `respawn_failed` (the supervisor tore the
    replica down under the request, or could not resume its exported
    KV on the respawned engine — either way the replica ended it, and
    when a `kv_snapshot` rode down with the failure the failover
    re-places it warm). Convicted quarantine culprits, exhausted
    retries and on_token failures stay terminal: a request that
    poisons one replica would poison the next."""
    if reason in ("watchdog_hung_step", "watchdog_engine_unhealthy",
                  "fault_streak_engine_unhealthy",
                  "drained_for_restart", "respawn_failed"):
        return True
    return isinstance(error, HungStepError)


class Router:
    """N `ServingEngine` replicas behind one submit()/stream() surface.

    Construction: either pass `params, cfg` plus `replicas=N` and
    engine kwargs (each replica gets its own engine, `replica_id`
    "r0".."rN-1", `per_replica=[{...}, ...]` overrides individual
    replicas — e.g. a fault injector on one), or pass prebuilt
    `engines=[...]` (they must not be started yet). `warmup()`
    captures every replica's step shapes (before `start()`), `start()`
    launches the engine loops and the router's monitor thread.

    `submit()` routes by `policy` (default `default_policy`: health,
    occupancy, prefix affinity) and returns a router-owned
    `GenerationRequest` handle — `result()`, `stream()`, `cancel()`
    work exactly as on an engine-submitted request, across failovers.
    `failover=True` re-admits requests stranded on an UNHEALTHY
    replica onto a healthy one (resume from `prompt + tokens`; the
    predicate is pluggable via `failover_on`). Backpressure: when every
    replica refuses admission, `submit()` raises `NoReplicaAvailable`.

    `disaggregated=True` splits prefill from decode: admission routes to
    prefill-capable replicas
    (`role="prefill"`/"both"), and when a prefill-role replica finishes
    a request at "prefill_complete" the monitor migrates its exported
    `KVSnapshot` to the decode-capable replica the policy picks —
    imported there with zero prefill chunks, the client stream staying
    strictly append-only across the hop. A lost snapshot falls back to
    warm re-prefill on the decode side (the migrate→re-prefill ladder);
    the fleet must contain at least one prefill-capable and one
    decode-capable replica.

    `auto_restart=True` attaches a
    `serving.supervisor.ReplicaSupervisor`: an UNHEALTHY replica is
    torn down and respawned in its slot behind a readiness gate, with
    backoff + a crash-loop circuit breaker — knobs via
    `restart_opts={...}` (see `ReplicaSupervisor`). The rebuild recipe
    is the router's retained params/cfg/per-replica overrides for
    router-built replicas, or `engine_factory=` (a callable
    `i -> unstarted engine stamped replica_id=f"r{{i}}"`) — the hook
    that lets prebuilt `engines=` replicas respawn too. Requests
    stranded mid-restart ride the normal cross-replica failover.
    """

    def __init__(self, params=None, cfg=None, *, replicas: int = 2,
                 engines: Optional[Sequence] = None,
                 engine_factory: Optional[Callable[[int], Any]] = None,
                 policy: Optional[Callable[[Dict], float]] = None,
                 failover: bool = True,
                 max_failovers: Optional[int] = None,
                 failover_on: Optional[Callable] = None,
                 affinity_cap: int = 4096,
                 affinity_block_size: Optional[int] = None,
                 idle_poll_s: float = 0.01,
                 metrics: Optional[MetricsRegistry] = None,
                 start: bool = True,
                 per_replica: Optional[Sequence[Optional[Dict]]] = None,
                 disaggregated: bool = False,
                 auto_restart: bool = False,
                 restart_opts: Optional[Dict] = None,
                 clock: Callable[[], float] = time.monotonic,
                 **engine_kwargs):
        # retained rebuild recipe: the supervisor respawns a dead
        # replica IN ITS SLOT from exactly these (same replica_id, so
        # metrics/trace attribution stays stable across restarts)
        self._params, self._cfg = params, cfg
        self._engine_kwargs = dict(engine_kwargs)
        self._per_replica = (list(per_replica)
                             if per_replica is not None else None)
        # `engine_factory(i)` is a pluggable
        # rebuild recipe — an UNSTARTED engine for slot i (it must
        # stamp replica_id=f"r{i}"; _build_replica enforces it).
        # Prebuilt engines= replicas can respawn through it, and when
        # given it also builds the initial fleet (engines=None,
        # params/cfg not required).
        self._engine_factory = engine_factory
        if engine_factory is not None and (engine_kwargs
                                           or per_replica is not None):
            # the factory IS the whole recipe — kwargs/overrides would
            # be silently dropped (it never reads them), so a fleet
            # "configured" that way must fail loudly at construction
            raise ValueError(
                "engine kwargs / per_replica do not apply with "
                "engine_factory= — fold the configuration into the "
                "factory itself")
        if engines is None:
            if (params is None or cfg is None) \
                    and engine_factory is None:
                raise ValueError(
                    "Router needs prebuilt engines=, an "
                    "engine_factory=, or params+cfg to build "
                    "replicas from")
            if replicas < 1:
                raise ValueError("replicas must be >= 1")
            engines = [self._build_replica(i)
                       for i in range(int(replicas))]
        else:
            if engine_kwargs or per_replica is not None:
                raise ValueError(
                    "engine kwargs only apply when the Router builds "
                    "the replicas itself (engines= was given)")
            if auto_restart and engine_factory is None:
                raise ValueError(
                    "auto_restart needs a rebuild recipe — pass "
                    "params+cfg (+ engine kwargs) instead of prebuilt "
                    "engines=, or give the prebuilt replicas an "
                    "engine_factory= to respawn through")
        self.engines: List = list(engines)
        if not self.engines:
            raise ValueError("Router needs at least one replica")
        self._disaggregated = bool(disaggregated)
        if self._disaggregated:
            roles = [getattr(e, "role", "both") for e in self.engines]
            if not any(r in _PREFILL_ROLES for r in roles) \
                    or not any(r in _DECODE_ROLES for r in roles):
                raise ValueError(
                    "disaggregated=True needs at least one "
                    "prefill-capable and one decode-capable replica "
                    f"(roles: {roles})")
        self.policy = policy or default_policy
        self._failover_enabled = bool(failover)
        self._max_failovers = (len(self.engines) - 1
                               if max_failovers is None
                               else int(max_failovers))
        self._failover_on = failover_on or _default_failover_on
        bs = affinity_block_size
        if bs is None:
            batcher = getattr(self.engines[0], "batcher", None)
            bs = getattr(batcher, "bs", 16)
        self._affinity = _AffinityIndex(bs, cap=affinity_cap)
        self._clock = clock
        self._idle_poll_s = float(idle_poll_s)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._routed: Dict[str, _Routed] = {}       # router rid -> state
        self._rid_seq = 0
        self._accepting = True
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._failover_log: List[Dict] = []         # bounded forensics

        self.metrics = metrics or MetricsRegistry()
        m = self.metrics
        self._c_routed = m.counter("requests_routed")
        self._c_rejected = m.counter("requests_rejected_all_replicas")
        self._c_failovers = m.counter("failovers")
        self._c_failover_exhausted = m.counter("failovers_exhausted")
        self._c_monitor_errors = m.counter("router_monitor_errors")
        self._g_inflight = m.gauge("router_inflight")
        self._h_ttft = m.histogram("router_ttft_s")
        self._per_replica_routed = [
            m.counter(f"routed_{eng.replica_id}") for eng in self.engines]
        # self-healing surface: registered whether or not the
        # supervisor runs, so the Prometheus exposition is stable
        # (zeros mean "no restarts", absence would mean "old binary")
        self._c_restarts = m.counter("replica_restarts")
        self._c_restart_failures = m.counter("restart_failures")
        self._c_circuit_open = m.counter("circuit_open")
        # per-slot: restarts run concurrently (one supervisor thread
        # per slot), so a shared gauge would let one slot's recovery
        # zero out another slot's in-progress backoff
        self._g_restart_backoff = [
            m.gauge(f"restart_backoff_s_{eng.replica_id}")
            for eng in self.engines]
        # operator recovery surface: FAILED slots revived without a
        # process restart (POST /admin/reset_breaker)
        self._c_breaker_resets = m.counter("breaker_resets")
        # disaggregated / KV-transfer surface: `migrations` counts
        # every router-placed KVSnapshot import (prefill→decode
        # handoffs AND warm failovers), `migration_bytes` the KV
        # payload those moved; `handoff_s` times the prefill-complete
        # → decode-resumed gap (monitor-tick latency included — that
        # IS the handoff cost the client sees)
        self._c_migrations = m.counter("migrations")
        self._c_migration_bytes = m.counter("migration_bytes")
        self._h_handoff = m.histogram("handoff_s")
        self._migration_log: List[Dict] = []        # bounded forensics
        # fleet-wide SLO rollup: worst-of verdicts / max burn rates
        # exported with replica="router" next to the per-replica
        # series; the router's slo_breaches counter accumulates
        # per-ENGINE-INCARNATION deltas (keyed by engine identity —
        # a respawned replica's fresh tracker restarts at 0, and
        # diffing the GLOBAL sum would swallow real breaches until
        # the sum re-climbed past its old high-water mark)
        self._c_slo_breaches = m.counter("slo_breaches")
        self._slo_breach_marks: Dict[int, int] = {}
        self._supervisor = None
        if auto_restart:
            from .supervisor import ReplicaSupervisor   # lazy sibling
            self._supervisor = ReplicaSupervisor(
                self, clock=clock, **(restart_opts or {}))

        if start:
            self.start()

    def _build_replica(self, i: int):
        """Construct (never start) slot `i`'s engine from the retained
        params/cfg/engine kwargs + per-replica overrides — used for the
        initial build AND every supervisor respawn, so a respawned
        replica is configured exactly like the one it replaces
        (including its chaos injector, replica_id and metrics names).
        With an `engine_factory=` the factory IS the recipe (the
        prebuilt-engines respawn path); it must return an unstarted
        engine stamped replica_id=f"r{i}" — a mismatched id would
        corrupt per-replica metrics/trace attribution across the swap,
        so it raises here instead."""
        if self._engine_factory is not None:
            eng = self._engine_factory(i)
            if getattr(eng, "replica_id", None) != f"r{i}":
                raise ValueError(
                    f"engine_factory({i}) must stamp replica_id="
                    f"'r{i}', got {getattr(eng, 'replica_id', None)!r}"
                    f" — slot attribution would break across respawns")
            return eng
        from .engine import ServingEngine         # lazy: pulls nlp tree
        kw = dict(self._engine_kwargs)
        if self._per_replica is not None and self._per_replica[i]:
            kw.update(self._per_replica[i])
        kw.setdefault("replica_id", f"r{i}")
        kw["start"] = False
        return ServingEngine(self._params, self._cfg, **kw)

    # ---- lifecycle -------------------------------------------------------
    def warmup(self) -> int:
        """Capture every replica's prefill/decode step shapes (must run
        before `start()` — same rule as `ServingEngine.warmup`).
        Returns total shapes captured across replicas."""
        return sum(eng.warmup() for eng in self.engines)

    def start(self) -> "Router":
        """Start every replica's engine loop plus the router monitor
        thread (terminal fan-in, cancellation forwarding, failover)
        and, with `auto_restart=True`, the replica supervisor."""
        with self._work:
            if self._stop:
                raise RuntimeError("router already shut down")
            if self._thread is None:
                for eng in self.engines:
                    eng.start()
                self._thread = threading.Thread(
                    target=self._monitor_loop,
                    name="paddle-tpu-torch-router", daemon=True)
                self._thread.start()
        if self._supervisor is not None:
            self._supervisor.start()
        return self

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    @property
    def is_idle(self) -> bool:
        with self._lock:
            return not self._routed

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no routed request is in flight anywhere; False
        on timeout."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._work:
            while self._routed:
                rem = self._idle_poll_s if deadline is None else \
                    min(self._idle_poll_s, deadline - self._clock())
                if rem <= 0:
                    return False
                self._work.wait(rem)
        return True

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """Stop the router. drain=True completes in-flight work first
        (failover stays armed during the drain); drain=False cancels
        everything. Replica engines shut down after the router-level
        drain, so a request mid-failover is not cut off by its new
        replica stopping underneath it."""
        clean = True
        with self._work:
            self._accepting = False
            self._work.notify_all()
        # supervisor first: it must not swap engines (or sit in a
        # backoff wait holding a half-built replica) while the
        # shutdown below walks the slot list; stop() interrupts an
        # in-flight restart at its next bounded wait and tears down
        # any engine it built but never swapped in
        if self._supervisor is not None:
            if not self._supervisor.stop(timeout=timeout):
                clean = False
        if drain and self._thread is not None:
            clean = self.drain(timeout)
        with self._work:
            self._stop = True
            self._work.notify_all()
        for eng in self.engines:
            if not eng.shutdown(drain=drain, timeout=timeout):
                clean = False
        if self._thread is not None:
            self._thread.join(2.0)
            if self._thread.is_alive():
                clean = False
        with self._work:
            for ent in list(self._routed.values()):
                if not ent.outer.done:
                    ent.outer._finish(RequestState.CANCELLED,
                                      "router_shutdown",
                                      now=self._clock())
            self._routed.clear()
            self._g_inflight.set(0)
            self._work.notify_all()
        return clean

    # ---- submission ------------------------------------------------------
    def submit(self, prompt, *, priority: int = 0,
               max_new_tokens: Optional[int] = None,
               stop_token_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               on_token=None) -> GenerationRequest:
        """Route and queue one request; returns the router-owned handle
        immediately. Raises `NoReplicaAvailable` when every replica
        refuses admission (backpressure — the frontend's 429),
        ValueError when the request can never fit a replica's pool, and
        RuntimeError after shutdown began."""
        outer = GenerationRequest(prompt, priority=priority,
                                  max_new_tokens=max_new_tokens,
                                  stop_token_id=stop_token_id,
                                  timeout_s=timeout_s)
        with self._work:
            if self._stop or not self._accepting:
                raise RuntimeError("router is shutting down")
            now = self._clock()
            outer.request_id = f"req{self._rid_seq}"
            self._rid_seq += 1
            outer.replica_id = None       # set by _place on success
            outer.router_failovers = 0
            outer.submit_time = now
            if timeout_s is not None:
                outer.deadline = now + timeout_s
            # state stamps BEFORE the engine sees the request: the
            # bridge's first-token PREFILL→DECODING transition races
            # the placement otherwise (a failed placement discards the
            # handle, so the early stamp can't leak a live PREFILL)
            outer.state = RequestState.PREFILL
            inner, idx = self._place(
                outer, on_token, exclude=(), tokens_kept=0,
                roles=_PREFILL_ROLES if self._disaggregated else None)
            ent = _Routed(outer, inner, idx, on_token,
                          inner.max_new_tokens)
            outer.max_new_tokens = inner.max_new_tokens
            self._routed[outer.request_id] = ent
            self._g_inflight.set(len(self._routed))
            self._work.notify_all()
        return outer

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kw) -> List[int]:
        """Blocking one-shot through the router (cancel-on-timeout,
        like `ServingEngine.generate`)."""
        req = self.submit(prompt, **kw)
        try:
            return req.result(timeout)
        except TimeoutError:
            self.cancel(req)
            raise

    def stream(self, prompt, **kw):
        """Incremental one-shot: yields tokens as they stream (across
        failovers — the handle survives replica death)."""
        return self.submit(prompt, **kw).stream()

    def cancel(self, req: GenerationRequest) -> None:
        """Request cancellation; forwarded to the serving replica at
        the monitor's next tick (the handle's own `cancel()` reaches
        the same path)."""
        req.cancel()
        with self._work:
            self._work.notify_all()

    # ---- routing ---------------------------------------------------------
    def _views(self, eff: Sequence[int],
               exclude: Sequence[int],
               roles: Optional[Sequence[str]] = None,
               ) -> List[Tuple[float, int, Dict]]:
        """Policy-scored candidate replicas for a prompt, best first.
        UNHEALTHY / non-accepting / excluded replicas never appear;
        `roles` (disaggregated placement) restricts candidates to
        replicas whose `engine.role` is in the set."""
        aff = self._affinity.match(eff)
        out: List[Tuple[float, int, Dict]] = []
        sup = self._supervisor
        for i, eng in enumerate(self.engines):
            if i in exclude:
                continue
            if roles is not None \
                    and getattr(eng, "role", "both") not in roles:
                continue
            if sup is not None and not sup.slot_serving(i):
                # readiness gate: a RESTARTING slot (fresh engine still
                # warming / probing) or a breaker-pinned FAILED slot is
                # never offered to the policy
                continue
            h = eng.health()
            status = h["status"]
            if status == "UNHEALTHY":
                continue
            view = eng.load()
            if not view.get("accepting", True):
                continue
            view["status"] = status
            view["replica"] = i
            # SLO-aware routing: the replica's worst-of verdict rides
            # the policy view ("OK" when tracking is off or the engine
            # predates it) — evaluate() is cached per eval_every_s, so
            # this costs a dict read per candidate, not window math
            view["slo_verdict"] = (h.get("slo") or {}).get(
                "verdict", "OK")
            view["affinity_tokens"] = aff.get(i, 0)
            view["affinity_blocks"] = aff.get(i, 0) // self._affinity.bs
            out.append((float(self.policy(view)), i, view))
        # best score first; ties break toward the lower replica index
        out.sort(key=lambda t: (-t[0], t[1]))
        return out

    def _place(self, outer: GenerationRequest, user_on_token,
               exclude: Sequence[int],
               tokens_kept: int,
               roles: Optional[Sequence[str]] = None,
               snapshot=None) -> Tuple[GenerationRequest, int]:
        """Build the replica-side request for `outer`'s remaining work
        and submit it to the best-scoring replica that accepts
        (head-of-policy refusals fall through to the next candidate).
        With `snapshot` the placement imports the request's exported
        KV instead of enqueuing a prefill (`engine.submit_import`) —
        the inner request is pre-seeded with the already-streamed
        tokens, so the bridge only ever forwards NEW ones. Called
        under the router lock. Raises NoReplicaAvailable when nobody
        accepts."""
        eff = outer.prompt + outer.tokens
        remaining_new = (None if outer.max_new_tokens is None
                         else outer.max_new_tokens - len(outer.tokens))
        remaining_t = (None if outer.deadline is None
                       else max(0.001, outer.deadline - self._clock()))
        candidates = self._views(eff, exclude, roles=roles)
        last_err: Optional[BaseException] = None
        for score, i, view in candidates:
            eng = self.engines[i]
            if snapshot is not None:
                gen = snapshot.tokens[snapshot.prompt_len:]
                inner = GenerationRequest(
                    snapshot.tokens[:snapshot.prompt_len],
                    priority=outer.priority,
                    max_new_tokens=len(gen) + int(snapshot.budget),
                    stop_token_id=outer.stop_token_id,
                    timeout_s=remaining_t,
                    on_token=self._bridge(outer, user_on_token))
                # pre-seed the streamed suffix directly (not through
                # _deliver — these tokens already reached the client)
                inner.tokens = list(gen)
                try:
                    eng.submit_import(snapshot, inner)
                except (QueueFullError, EngineStopped, ValueError) as e:
                    # ValueError joins the fall-through set ONLY here:
                    # a fingerprint/pool mismatch indicts this replica
                    # for this snapshot (heterogeneous fleet), not the
                    # request — another candidate may still import it
                    last_err = e
                    continue
            else:
                inner = GenerationRequest(
                    eff, priority=outer.priority,
                    max_new_tokens=remaining_new,
                    stop_token_id=outer.stop_token_id,
                    timeout_s=remaining_t,
                    on_token=self._bridge(outer, user_on_token))
                try:
                    eng.submit(inner)
                except (QueueFullError, EngineStopped) as e:
                    # queue-full backpressure or a replica that stopped
                    # accepting between the view and the submit: fall
                    # through to the next candidate. Anything else — a
                    # ValueError for a request that can NEVER fit, or a
                    # genuine engine bug — propagates: rewriting it as
                    # backpressure would 429 a broken service
                    last_err = e
                    continue
            self._affinity.observe(eff, i)
            # the outer handle advertises its CURRENT serving replica
            # (updated on failover) — the frontend's SSE events and the
            # bench read it without reaching into router internals
            outer.replica_id = eng.replica_id
            self._c_routed.inc()
            self._per_replica_routed[i].inc()
            if eng.trace is not None and inner.trace_id is not None:
                eng.trace.emit(inner.trace_id, "routed",
                               replica=eng.replica_id,
                               score=round(score, 4),
                               router_rid=outer.request_id,
                               affinity_tokens=view["affinity_tokens"],
                               resumed_tokens=tokens_kept)
            return inner, i
        self._c_rejected.inc()
        raise NoReplicaAvailable(
            f"no replica accepted the request "
            f"({len(self.engines)} replicas, "
            f"{len(candidates)} eligible; last error: {last_err!r})")

    def _bridge(self, outer: GenerationRequest, user_on_token):
        """The replica→client token bridge: the inner request's
        on_token forwards each token into the outer handle's channel
        (append-only, so a failover's resume can never re-emit) and
        then the user callback. Runs on the serving replica's engine
        thread; a user-callback error fails the INNER request there —
        the engine's per-request boundary — and surfaces on the outer
        handle as a terminal FAILED, never a failover."""
        def fwd(tok: int) -> None:
            if outer.first_token_time is None:
                outer.first_token_time = self._clock()
                self._h_ttft.observe(
                    outer.first_token_time - outer.submit_time)
            outer._deliver(tok)
            if user_on_token is not None:
                user_on_token(tok)
        return fwd

    # ---- monitor thread --------------------------------------------------
    def _monitor_loop(self) -> None:
        while True:
            with self._work:
                if self._stop:
                    return
                self._sweep_locked()
                self._work.wait(self._idle_poll_s)

    def _sweep_locked(self) -> None:
        """One monitor tick: forward client cancellations to the
        serving replica, fan replica-side terminals into the outer
        handles, and fail over eligible failures to another replica.
        Per-entry exception boundary: a broken pluggable policy or
        failover predicate fails THAT request — it must never kill the
        monitor thread, which would wedge every handle forever."""
        done: List[str] = []
        for rid, ent in self._routed.items():
            try:
                if ent.outer.cancel_requested \
                        and not ent.inner.cancel_requested:
                    ent.inner.cancel()
                    self.engines[ent.idx].cancel(ent.inner)
                if ent.inner.done:
                    if self._handle_terminal(ent):
                        done.append(rid)
            # monitor boundary: the error is
            # attached to the request's handle and re-raised in its
            # result(); losing the monitor loop instead would silently
            # strand every in-flight and future request
            except Exception as e:
                self._c_monitor_errors.inc()
                if not ent.outer.done:
                    ent.outer._finish(RequestState.FAILED,
                                      "router_monitor_error", error=e,
                                      now=self._clock())
                done.append(rid)
        if done:
            for rid in done:
                del self._routed[rid]
            self._g_inflight.set(len(self._routed))
            self._work.notify_all()

    def _handle_terminal(self, ent: _Routed) -> bool:
        """Map one finished replica-side request onto its outer handle.
        Returns True when the outer is terminal (entry can drop), False
        when the request failed over and lives on elsewhere."""
        inner, outer = ent.inner, ent.outer
        now = self._clock()
        if self._disaggregated \
                and inner.state is RequestState.FINISHED \
                and inner.finish_reason == "prefill_complete" \
                and not outer.cancel_requested:
            # the disaggregated handoff: a prefill-role replica
            # finished its half and surrendered the KV — migrate to a
            # decode-capable replica (snapshot import, or warm
            # re-prefill when the export failed)
            if self._migrate(ent):
                return False
            outer._finish(RequestState.FAILED, "migration_failed",
                          error=inner.error, now=now)
            return True
        if inner.state is RequestState.FAILED and self._failover_enabled \
                and not outer.cancel_requested \
                and self._failover_on(inner, inner.error,
                                      inner.finish_reason):
            if ent.failovers < self._max_failovers:
                if self._failover(ent):
                    return False
            self._c_failover_exhausted.inc()
        outer._finish(inner.state, inner.finish_reason,
                      error=inner.error, now=now)
        return True

    def _migrate(self, ent: _Routed) -> bool:
        """Move `ent`'s prefill-complete request to a decode-capable
        replica: import the surrendered `KVSnapshot` when the prefill
        replica exported one (zero prefill chunks at the destination),
        else fall back to warm re-prefill from `prompt + tokens` — the
        migrate→re-prefill ladder. Returns False only when no decode
        replica accepts either form (the caller fails the outer)."""
        inner, outer = ent.inner, ent.outer
        from_idx = ent.idx
        from_id = self.engines[from_idx].replica_id
        t0 = (inner.finish_time if inner.finish_time is not None
              else self._clock())
        kept = len(outer.tokens)
        snap = getattr(inner, "kv_snapshot", None)
        inner2 = None
        idx = from_idx
        via = "kv_import"
        if snap is not None:
            try:
                inner2, idx = self._place(outer, ent.user_on_token,
                                          exclude=(from_idx,),
                                          tokens_kept=kept,
                                          roles=_DECODE_ROLES,
                                          snapshot=snap)
            except NoReplicaAvailable:
                inner2 = None
        if inner2 is None:
            via = "reprefill"
            try:
                inner2, idx = self._place(outer, ent.user_on_token,
                                          exclude=(from_idx,),
                                          tokens_kept=kept,
                                          roles=_DECODE_ROLES)
            except NoReplicaAvailable:
                return False
        inner.kv_snapshot = None          # drop the host payload
        ent.inner = inner2
        ent.idx = idx
        wall = max(0.0, self._clock() - t0)
        moved = snap.nbytes if (via == "kv_import") else 0
        blocks = snap.n_blocks if (via == "kv_import") else 0
        self._c_migrations.inc()
        if moved:
            self._c_migration_bytes.inc(moved)
        self._h_handoff.observe(wall)
        to_eng = self.engines[idx]
        entry = {"router_rid": outer.request_id,
                 "from_replica": from_id,
                 "to_replica": to_eng.replica_id,
                 "via": via, "bytes": moved, "blocks": blocks,
                 "tokens_kept": kept,
                 "handoff_s": round(wall, 6)}
        self._migration_log.append(entry)
        del self._migration_log[:-64]      # bounded forensics ring
        if to_eng.trace is not None:
            # span on the DESTINATION sink (it owns the request now);
            # dur is the client-visible prefill-complete→resumed gap
            to_eng.trace.span("migrated", dur=wall, **entry)
            if inner2.trace_id is not None:
                to_eng.trace.emit(inner2.trace_id, "migrated", **entry)
        return True

    def _failover(self, ent: _Routed) -> bool:
        """Re-admit `ent`'s request on a different healthy replica.
        When the dying replica attached an exported `kv_snapshot` to
        the failed inner (drain/teardown paths), the re-placement
        imports it — the survivor resumes decode with zero prefill
        chunks; otherwise it resumes from `prompt + tokens` (warm
        re-prefill). Either way nothing re-emits: the outer channel
        already holds every streamed token, and the resumed decode
        continues from exactly that suffix. Returns False when no
        replica accepts — the caller then finishes the outer with the
        original error."""
        outer = ent.outer
        from_idx = ent.idx
        from_id = self.engines[from_idx].replica_id
        kept = len(outer.tokens)
        roles = _DECODE_ROLES if self._disaggregated else None
        snap = getattr(ent.inner, "kv_snapshot", None)
        via = "reprefill"
        inner = None
        if snap is not None:
            try:
                inner, idx = self._place(outer, ent.user_on_token,
                                         exclude=(from_idx,),
                                         tokens_kept=kept,
                                         roles=roles, snapshot=snap)
                via = "kv_import"
            except NoReplicaAvailable:
                inner = None
        if inner is None:
            try:
                inner, idx = self._place(outer, ent.user_on_token,
                                         exclude=(from_idx,),
                                         tokens_kept=kept, roles=roles)
            except NoReplicaAvailable:
                return False
        ent.inner.kv_snapshot = None       # drop the host payload
        ent.inner = inner
        ent.idx = idx
        ent.failovers += 1
        outer.router_failovers = ent.failovers
        self._c_failovers.inc()
        if via == "kv_import":
            # a warm failover IS a migration: same primitive, same
            # accounting (the handoff histogram stays disagg-only —
            # failover latency is already visible in the failover log)
            self._c_migrations.inc()
            self._c_migration_bytes.inc(snap.nbytes)
        to_eng = self.engines[idx]
        entry = {"router_rid": outer.request_id,
                 "from_replica": from_id,
                 "to_replica": to_eng.replica_id,
                 "tokens_kept": kept, "via": via,
                 "failover_n": ent.failovers}
        self._failover_log.append(entry)
        del self._failover_log[:-64]       # bounded forensics ring
        if to_eng.trace is not None and inner.trace_id is not None:
            to_eng.trace.emit(inner.trace_id, "failover", **entry)
        return True

    # ---- operator recovery ----------------------------------------------
    def reset_breaker(self, slot) -> Dict:
        """Revive a breaker-pinned FAILED slot without a process
        restart: clears the slot's crash-loop
        history and re-enters the normal RESTARTING → readiness-gate →
        SERVING recovery cycle. `slot` is a replica index or id
        ("r1"). Returns ``{"slot", "replica", "reset", "state"}`` —
        `reset` False when the slot was not FAILED (nothing to do).
        Raises RuntimeError without a supervisor (auto_restart off)
        and LookupError for an unknown slot. Bumps the
        `breaker_resets` counter and emits a `breaker_reset` trace
        event on success; `POST /admin/reset_breaker` on the frontend
        calls exactly this."""
        if self._supervisor is None:
            raise RuntimeError(
                "reset_breaker needs auto_restart=True — without a "
                "supervisor there is no breaker to reset")
        if isinstance(slot, str):
            idx = next((i for i, e in enumerate(self.engines)
                        if e.replica_id == slot), None)
            if idx is None:
                raise LookupError(f"unknown replica {slot!r}")
        else:
            idx = int(slot)
            if not 0 <= idx < len(self.engines):
                raise LookupError(
                    f"slot {idx} out of range "
                    f"[0, {len(self.engines)})")
        ok = self._supervisor.reset_breaker(idx)
        if ok:
            self._c_breaker_resets.inc()
            eng = self.engines[idx]
            if eng.trace is not None:
                # on the dead engine's sink: it is what the slot still
                # exports until the respawn swaps a fresh sink in
                eng.trace.span("breaker_reset", dur=0.0,
                               replica=eng.replica_id)
        return {"slot": idx, "replica": self.engines[idx].replica_id,
                "reset": ok,
                "state": self._supervisor.states()[idx]}

    def capture_profile(self, steps: int = 8,
                        timeout: Optional[float] = 30.0) -> Dict:
        """Fleet-wide device-time capture: arm EVERY replica's capture
        window (so the fences overlap instead of serializing), then
        wait for each to close (bounded by one shared `timeout` — an
        idle replica's report comes back ``complete`` False). Returns
        ``{replica_id: StepProfiler.report()}``; the frontend's
        ``POST /debug/profile`` returns exactly this."""
        for eng in self.engines:
            eng.batcher.profiler.arm_capture(steps)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        out: Dict[str, Dict] = {}
        for eng in self.engines:
            prof = eng.batcher.profiler
            while prof.capture_active():
                if deadline is not None and time.monotonic() > deadline:
                    # disarm the idle replica's leftover window: it
                    # must not fence future ticks nobody waits for
                    prof.cancel_capture()
                    break
                time.sleep(0.005)
            out[eng.replica_id] = prof.report()
        return out

    # ---- observability ---------------------------------------------------
    def _slo_rollup(self, per: Optional[List[Dict]] = None) -> Dict:
        """Fleet SLO aggregation (serving.slo.rollup) + the router-side
        Prometheus mirror: worst-of verdicts and max burn rates land in
        replica="router" gauges, and the router's monotonic
        slo_breaches counter accumulates per-incarnation deltas —
        each engine object's breach total is high-water-marked by
        identity, so a supervisor respawn (fresh tracker at 0) neither
        decrements the fleet counter nor swallows the NEXT real
        breaches behind the old global sum."""
        engines = list(self.engines)
        if per is None:
            per = [eng.health() for eng in engines]
        agg = slo_rollup([h.get("slo") for h in per])
        for name, o in agg["objectives"].items():
            self.metrics.gauge(
                f"slo_burn_rate_{name}").set(o["burn_rate_fast"])
        with self._lock:      # concurrent health()/scrape callers
            marks: Dict[int, int] = {}
            new = 0
            for eng, h in zip(engines, per):
                total = (h.get("slo") or {}).get("breaches_total", 0)
                seen = self._slo_breach_marks.get(id(eng), 0)
                new += max(0, total - seen)
                marks[id(eng)] = max(total, seen)
            self._slo_breach_marks = marks    # dead incarnations drop
            if new > 0:
                self._c_slo_breaches.inc(new)
        return agg

    def health(self) -> Dict:
        """Aggregated health: `status` is the WORST replica state (the
        conservative operator view), `serving_replicas` counts replicas
        still able to serve (in rotation AND not UNHEALTHY), and
        `replicas` carries each replica's full `engine.health()`
        detail keyed by replica id. With `auto_restart=True` the
        self-healing surface rides along: per-slot `supervisor` detail
        (state SERVING/RESTARTING/FAILED, restart + failure counts,
        current backoff, circuit-breaker flag), `restarting_replicas`
        / `failed_replicas` counts and the lifetime restart counters —
        so `/health` distinguishes a slot that is coming back from one
        that is permanently lost."""
        sup = self._supervisor
        states = sup.states() if sup is not None else None
        per = [eng.health() for eng in self.engines]
        worst = max(per, key=lambda h: _HEALTH_ORDER[h["status"]])
        out = {
            "status": worst["status"],
            "replica_count": len(per),
            "serving_replicas": sum(
                1 for i, h in enumerate(per)
                if h["status"] != "UNHEALTHY"
                and (states is None or states[i] == "SERVING")),
            "failovers": self._c_failovers.value,
            "migrations": self._c_migrations.value,
            "migration_bytes": self._c_migration_bytes.value,
            "requests_routed": self._c_routed.value,
            "requests_rejected": self._c_rejected.value,
            "replica_restarts": self._c_restarts.value,
            "restart_failures": self._c_restart_failures.value,
            "circuit_open": self._c_circuit_open.value,
            "restarting_replicas": (0 if states is None else
                                    states.count("RESTARTING")),
            "failed_replicas": (0 if states is None else
                                states.count("FAILED")),
            # fleet SLO verdict: worst-of per objective, max burn —
            # detail the /health JSON carries WITHOUT flipping the 200
            # (SLOs degrade, supervision decides)
            "slo": self._slo_rollup(per),
            "breaker_resets": self._c_breaker_resets.value,
            "replicas": {h["replica_id"]: h for h in per},
        }
        if sup is not None:
            out["supervisor"] = sup.info()
        return out

    def snapshot(self) -> Dict:
        """Router metrics + failover log + affinity-index size, plus
        every replica's full `engine.snapshot()` keyed by replica id."""
        with self._lock:
            snap = {
                "router": self.metrics.snapshot(),
                "failover_log": [dict(e) for e in self._failover_log],
                "migration_log": [dict(e) for e in self._migration_log],
                "disaggregated": self._disaggregated,
                "affinity_indexed_blocks": len(self._affinity),
                "supervisor": (None if self._supervisor is None
                               else self._supervisor.info()),
                "replicas": {},
            }
        for eng in self.engines:
            snap["replicas"][eng.replica_id] = eng.snapshot()
        return snap

    def to_prometheus(self, prefix: str = "paddle_tpu_") -> str:
        """Every replica's `MetricsRegistry.to_prometheus()` plus the
        router's own registry, merged into ONE valid exposition: each
        sample gains a `replica="rN"` label (`replica="router"` for
        router-level metrics) and samples are re-grouped per family so
        a strict parser sees each family exactly once — including the
        native-histogram `<name>_hist` families whose `_bucket{le=...}`
        samples must stay under THEIR OWN TYPE line, not the sibling
        summary's. The SLO rollup gauges refresh first, so a scrape
        always reads the current fleet burn rates."""
        self._slo_rollup()
        chunks = [("router", self.metrics.to_prometheus(prefix))]
        chunks += [(eng.replica_id, eng.metrics.to_prometheus(prefix))
                   for eng in self.engines]
        families: "OrderedDict[str, List[str]]" = OrderedDict()
        for rid, text in chunks:
            family = None
            for line in text.splitlines():
                if not line:
                    continue
                if line.startswith("# TYPE "):
                    family = line
                    families.setdefault(family, [])
                    continue
                if line.startswith("#"):
                    continue
                name, _, value = line.rpartition(" ")
                if "{" in name:
                    name = name[:-1] + f',replica="{rid}"}}'
                else:
                    name = name + f'{{replica="{rid}"}}'
                families.setdefault(family or "# TYPE _orphan untyped",
                                    []).append(f"{name} {value}")
        lines: List[str] = []
        for family, samples in families.items():
            lines.append(family)
            lines.extend(samples)
        return "\n".join(lines) + "\n"

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Merged Chrome-trace across replicas: each replica's sink
        exports on its own pid (process name carries the replica id),
        timestamps are aligned onto one global origin, and every
        event's `trace_id` arg is prefixed `rN:` so per-request rows
        stay unique across replicas in `tools/trace_report.py`."""
        sinks = [(i, eng) for i, eng in enumerate(self.engines)
                 if eng.trace is not None]
        if not sinks:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        origin = min(eng.trace.origin for _, eng in sinks)
        events: List[Dict[str, Any]] = []
        for i, eng in sinks:
            shift_us = (eng.trace.origin - origin) * 1e6
            pid = i + 1
            for e in eng.trace.to_chrome_trace()["traceEvents"]:
                e = dict(e)
                e["pid"] = pid
                if e.get("ph") == "M":
                    if e.get("name") == "process_name":
                        e["args"] = {
                            "name": f"paddle_tpu_torch.serving {eng.replica_id}"}
                else:
                    e["ts"] = e.get("ts", 0.0) + shift_us
                args = e.get("args")
                if args and "trace_id" in args:
                    e["args"] = {
                        **args,
                        "trace_id": f"{eng.replica_id}:{args['trace_id']}"}
                events.append(e)
        return {"traceEvents": events, "displayTimeUnit": "ms"}
