"""paddle_tpu_torch.serving.supervisor — replica lifecycle state machine
for self-healing serving.

The port's copy of paddle_tpu/serving/supervisor.py (host-side only):
`ReplicaSupervisor` watches every Router slot and closes the
detect → kill → respawn → re-warm → rejoin loop. An UNHEALTHY replica
(watchdog trip, fault fuse) is drained of its exportable KV, torn down,
rebuilt in the SAME slot from the router's retained params and engine
kwargs, warmed (`warmup()`: every CUDA-graph shape captured) and held
off-rotation behind a readiness probe generation before it rejoins.
Failed attempts back off exponentially with jitter
(`compute_backoff`); a crash-loop circuit breaker pins a flapping slot
FAILED until `reset_breaker`.

On one card a respawn's warmup captures graphs while the surviving
replica replays its own: each batcher captures thread-locally and
replays only from its own engine thread. A torn-down engine keeps its
pool and graph memory until its thread has left the hung call AND the
cycle collector has run (its step graphs close over the batcher), so
the teardown runs `gc.collect()` once the old engine's thread has
exited — at once when it already has, else from a reaper thread that
waits for it.

States per slot: SERVING → RESTARTING → SERVING, or → FAILED when the
breaker opens.
"""
from __future__ import annotations

import gc
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .request import RequestState

__all__ = ["ReplicaSupervisor", "SLOT_SERVING", "SLOT_RESTARTING",
           "SLOT_FAILED", "compute_backoff"]

# Slot lifecycle states (strings on purpose: they travel through
# health() JSON to /health and the bench unchanged).
SLOT_SERVING = "SERVING"
"""Slot state: the replica is in rotation and the policy may pick it."""
SLOT_RESTARTING = "RESTARTING"
"""Slot state: the dead engine is being torn down / respawned / warmed
behind the readiness gate — out of rotation, recovery underway."""
SLOT_FAILED = "FAILED"
"""Slot state: the crash-loop circuit breaker opened — the slot is
pinned out of rotation until the process restarts (operator action)."""


def _collect_when_exited(eng, limit_s: float = 3600.0) -> None:
    """Free a torn-down engine's device memory once its thread has left
    its (possibly hung) device call: the batcher drops its captured
    graphs and its KV pool (`release_device_memory`), and the cycle
    collector runs — the step graphs close over the batcher. At once
    when the thread has exited, else from a daemon thread that waits for
    it (bounded by `limit_s`). The router may still hold the dead engine
    until the respawn swaps it out; its health and counters stay
    readable."""
    def release():
        b = getattr(eng, "batcher", None)
        if b is not None and hasattr(b, "release_device_memory"):
            b.release_device_memory()
        gc.collect()

    thread = getattr(eng, "_thread", None)
    if thread is None or not thread.is_alive():
        release()
        return

    def reap():
        thread.join(limit_s)
        if not thread.is_alive():
            release()
    threading.Thread(target=reap, name="paddle-tpu-torch-reaper",
                     daemon=True).start()


def compute_backoff(attempt: int, *, base_s: float, max_s: float,
                    jitter: float, rng: random.Random) -> float:
    """Exponential backoff with jitter for respawn attempt `attempt`
    (1-based): ``min(max_s, base_s * 2**(attempt-1))`` scaled by a
    uniform ``[1, 1+jitter)`` factor drawn from `rng` — seeded, so a
    chaos run replays the same schedule."""
    if attempt < 1:
        return 0.0
    # exponent clamped BEFORE exponentiation: a long-lived crash loop
    # must saturate at max_s, not OverflowError the restart thread
    raw = min(float(max_s),
              float(base_s) * (2.0 ** min(attempt - 1, 63)))
    return raw * (1.0 + float(jitter) * rng.random())


class _Slot:
    """One replica slot's lifecycle record (supervisor-thread owned;
    `state` is read lock-free by the router's routing path — a plain
    attribute store, atomic under the GIL)."""

    __slots__ = ("index", "state", "restarts", "restart_failures",
                 "failure_times", "backoff_s", "circuit_open",
                 "warm_compile_count", "last_error", "restarting_since",
                 "via_reset")

    def __init__(self, index: int):
        self.index = index
        self.state = SLOT_SERVING
        self.restarts = 0
        self.restart_failures = 0
        self.failure_times: deque = deque()
        self.backoff_s = 0.0
        self.circuit_open = False
        self.warm_compile_count: Optional[int] = None
        self.last_error: Optional[str] = None
        self.restarting_since: Optional[float] = None
        # this recovery cycle was initiated by an operator breaker
        # reset (stamped on the fresh engine's `restarted` span — the
        # dead engine's sink, where `breaker_reset` lands, is dropped
        # at swap, so provenance must ride the surviving sink)
        self.via_reset = False

    def info(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "restarts": self.restarts,
            "restart_failures": self.restart_failures,
            "circuit_open": self.circuit_open,
            "backoff_s": self.backoff_s,
            "warm_compile_count": self.warm_compile_count,
            "last_error": self.last_error,
            "restarting": self.state == SLOT_RESTARTING,
            "restarting_since": self.restarting_since,
        }


class ReplicaSupervisor:
    """Auto-restart supervisor over a `Router`'s replica slots.

    Constructed (and started) by `Router(auto_restart=True, ...)` —
    the router must have built its replicas itself (it retains the
    params/cfg/per-replica overrides a respawn rebuilds from). Knobs
    arrive via `Router(restart_opts={...})`:

      * ``poll_s`` — health-poll cadence (default 0.05);
      * ``backoff_s`` / ``backoff_max_s`` / ``jitter`` — the
        exponential-backoff schedule between failed respawn attempts
        (defaults 0.25 / 8.0 / 0.25; jitter is seeded — see `seed`);
      * ``breaker_threshold`` / ``breaker_window_s`` — the crash-loop
        circuit breaker: this many CONSECUTIVE failed respawns in one
        recovery cycle — or this many inside the trailing window
        across cycles (flap detection) — pins the slot FAILED
        (defaults 3 / 60.0);
      * ``probe_prompt`` / ``probe_new_tokens`` / ``probe_timeout_s``
        — the readiness probe: a synthetic generation the respawned
        engine must complete (after `warmup()`) before the slot
        rejoins rotation (defaults ``[1, 2, 3]`` / 2 / 120.0);
      * ``probe_mirror`` — shadow-traffic readiness: replay the shape
        of a recently-served LIVE request (prompt + budget, captured
        from the dead engine before teardown) instead of the synthetic
        probe prompt, so the gate exercises the compiled buckets real
        traffic actually hits; falls back to the synthetic prompt when
        the dead engine served nothing or cannot be read
        (default False);
      * ``teardown_timeout_s`` — bound on each dead-engine
        ``shutdown(drain=False)`` (default 2.0);
      * ``seed`` — jitter RNG seed (default 0).

    `info()` is the per-slot operator surface `Router.health()` and
    `snapshot()` embed; `slot_serving(i)` is the lock-free gate
    `Router._views` consults before offering slot `i` to the policy.
    """

    def __init__(self, router, *, poll_s: float = 0.05,
                 backoff_s: float = 0.25, backoff_max_s: float = 8.0,
                 jitter: float = 0.25, breaker_threshold: int = 3,
                 breaker_window_s: float = 60.0,
                 probe_prompt: Optional[Sequence[int]] = None,
                 probe_new_tokens: int = 2,
                 probe_timeout_s: float = 120.0,
                 probe_mirror: bool = False,
                 teardown_timeout_s: float = 2.0,
                 seed: int = 0, clock=time.monotonic):
        self._router = router
        self._poll_s = float(poll_s)
        self._backoff_base = float(backoff_s)
        self._backoff_max = float(backoff_max_s)
        self._jitter = float(jitter)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_window_s = float(breaker_window_s)
        self._probe_prompt = list(probe_prompt) if probe_prompt \
            else [1, 2, 3]
        self._probe_new = int(probe_new_tokens)
        self._probe_timeout_s = float(probe_timeout_s)
        self._probe_mirror = bool(probe_mirror)
        self._teardown_timeout_s = float(teardown_timeout_s)
        self._rng = random.Random(seed)
        # restart cycles run CONCURRENTLY (one thread per slot) and
        # share the jitter rng — serialize just the draw
        self._rng_lock = threading.Lock()
        self._clock = clock
        self._slots: List[_Slot] = [
            _Slot(i) for i in range(len(router.engines))]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._restart_threads: Dict[int, threading.Thread] = {}

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        """Launch the supervisor thread (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="paddle-tpu-torch-supervisor",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> bool:
        """Stop the supervisor; joins the poll thread AND every
        in-flight per-slot restart thread, bounded. An in-flight
        restart notices the stop flag at its next wait/poll, tears
        down any engine it built but never swapped in WITHOUT charging
        the slot a respawn failure (a clean shutdown must not pollute
        the crash-loop accounting), and exits — so shutdown during a
        restart joins bounded instead of leaking a replica."""
        self._stop.set()
        clean = True
        if self._thread is not None:
            self._thread.join(timeout)
            clean = not self._thread.is_alive()
        for t in list(self._restart_threads.values()):
            t.join(timeout)
            if t.is_alive():
                clean = False
        return clean

    # ---- router-facing views --------------------------------------------
    def slot_serving(self, i: int) -> bool:
        """True when slot `i` is in rotation (lock-free read — the
        routing path calls this per candidate per request)."""
        return self._slots[i].state == SLOT_SERVING

    def info(self) -> Dict[str, Dict[str, Any]]:
        """Per-slot lifecycle detail keyed by replica id — the
        operator surface embedded in `Router.health()`/`snapshot()`."""
        return {self._router.engines[s.index].replica_id: s.info()
                for s in self._slots}

    def states(self) -> List[str]:
        """Slot states by index (SERVING / RESTARTING / FAILED)."""
        return [s.state for s in self._slots]

    def reset_breaker(self, index: int) -> bool:
        """Operator override for a breaker-pinned slot: clear slot
        `index`'s crash-loop history (failure window, circuit flag,
        consecutive count) and re-enter the normal recovery cycle —
        RESTARTING, then the usual rebuild → warmup → probe readiness
        gate on a fresh per-slot thread, so a revived slot still
        cannot take traffic before proving it can serve (and a slot
        whose underlying fault persists trips the breaker again
        instead of flapping). Returns False when the slot is not
        FAILED (SERVING or mid-RESTARTING — nothing to reset);
        `Router.reset_breaker` / `POST /admin/reset_breaker` are the
        operator surfaces over this."""
        slot = self._slots[int(index)]
        with self._router._lock:
            if slot.state != SLOT_FAILED or self._stop.is_set():
                return False
            slot.state = SLOT_RESTARTING
            slot.circuit_open = False
            slot.failure_times.clear()
            slot.last_error = None
            slot.restarting_since = self._clock()
            slot.via_reset = True
        # the engine still in the slot is the dead incarnation the
        # breaker pinned — _restart_slot re-tears it down (idempotent)
        # before rebuilding, exactly like a detection-driven cycle
        dead = self._router.engines[slot.index]
        t = threading.Thread(
            target=self._restart_slot, args=(slot, dead),
            name=f"paddle-tpu-torch-restart-{slot.index}", daemon=True)
        self._restart_threads[slot.index] = t
        t.start()
        return True

    def restart_slot(self, index: int) -> bool:
        """Planned restart of a SERVING slot (rolling maintenance):
        flips it RESTARTING and runs the normal recovery cycle on a
        per-slot thread — but because the engine is still healthy, the
        drain-export step actually succeeds, so its in-flight requests
        resume WARM on the respawned engine (zero re-prefilled
        tokens). Returns False when the slot is not SERVING (already
        restarting, breaker-pinned — use `reset_breaker` — or the
        supervisor is stopping)."""
        slot = self._slots[int(index)]
        with self._router._lock:
            if slot.state != SLOT_SERVING or self._stop.is_set():
                return False
            slot.state = SLOT_RESTARTING
            slot.restarting_since = self._clock()
            slot.last_error = None
        eng = self._router.engines[slot.index]
        t = threading.Thread(
            target=self._restart_slot, args=(slot, eng),
            name=f"paddle-tpu-torch-restart-{slot.index}", daemon=True)
        self._restart_threads[slot.index] = t
        t.start()
        return True

    # ---- the supervisor threads -----------------------------------------
    def _loop(self) -> None:
        """The health-poll thread: detection only. Each detected death
        flips its slot RESTARTING (so detection can never double-fire)
        and hands the recovery cycle to a dedicated per-slot thread —
        one slot's long respawn ladder (teardown + warmup + probe +
        backoff, potentially minutes in a crash loop) must never block
        detection or recovery of the OTHER slots."""
        while not self._stop.wait(self._poll_s):
            for slot in self._slots:
                if self._stop.is_set():
                    return
                if slot.state != SLOT_SERVING:
                    continue
                eng = self._router.engines[slot.index]
                if eng.health()["status"] == "UNHEALTHY":
                    with self._router._lock:
                        slot.state = SLOT_RESTARTING
                        slot.restarting_since = self._clock()
                        slot.last_error = None
                    t = threading.Thread(
                        target=self._restart_slot, args=(slot, eng),
                        name=f"paddle-tpu-torch-restart-{slot.index}",
                        daemon=True)
                    self._restart_threads[slot.index] = t
                    t.start()

    def _restart_slot(self, slot: _Slot, dead) -> None:
        """One detect→kill→respawn→re-warm→rejoin cycle for `slot`
        (its own thread; the slot is already RESTARTING). Ends with
        the slot SERVING (fresh engine swapped in, affinity
        invalidated) or FAILED (breaker open), or mid-RESTARTING if
        the supervisor was stopped."""
        r = self._router
        t0 = self._clock()
        if dead.trace is not None:
            # forensics on the dead engine's sink: if the breaker ends
            # up pinning the slot FAILED this sink is what the merged
            # trace still exports
            dead.trace.span("restarting", dur=0.0,
                            replica=dead.replica_id)
        # drain-and-export BEFORE teardown: active requests surrender
        # their KV so the respawned slot resumes them without
        # re-prefill. A wedged engine thread cannot drain —
        # drain_export times out to [] and those requests ride the
        # normal cold failover instead.
        # shadow-traffic mirror: grab the newest live request shape
        # BEFORE teardown wipes the dead engine (best-effort — a
        # wedged engine, or one that served nothing, falls back to
        # the synthetic probe prompt)
        mirror: Optional[Tuple[List[int], int]] = None
        if self._probe_mirror:
            try:
                served = dead.recent_prompts()
                if served:
                    mirror = served[-1]
            # mirror capture is best-effort:
            # a dying engine that cannot report its traffic must still
            # be respawned; the synthetic probe covers the gate
            except Exception:
                mirror = None
        pairs: List[Tuple[Any, Any]] = []
        try:
            pairs = dead.drain_export(timeout=self._teardown_timeout_s)
        # export is best-effort: a dying
        # engine that cannot even drain must still be torn down and
        # respawned; its requests fail over cold
        except Exception:
            pairs = []
        self._teardown(dead)
        attempt = 0
        while not self._stop.is_set():
            fresh = None
            try:
                fresh = r._build_replica(slot.index)
                fresh.warmup()
                fresh.start()
                self._probe(fresh, mirror=mirror)
            # respawn attempt boundary: ANY
            # failure (constructor, warmup, probe, watchdog trip) is a
            # failed attempt feeding the backoff/breaker machinery —
            # letting it escape would kill the supervisor thread and
            # silently end self-healing for every slot
            except Exception as e:
                if fresh is not None:
                    self._teardown(fresh)
                if self._stop.is_set():
                    # a stop interrupted the attempt (probe bailed,
                    # warmup raced shutdown): clean shutdown is NOT a
                    # respawn failure — charging it would pollute the
                    # crash-loop accounting and could even pin the
                    # slot FAILED in the final scraped snapshot
                    self._fail_exported(pairs)
                    return
                slot.restart_failures += 1
                slot.failure_times.append(self._clock())
                slot.last_error = repr(e)
                r._c_restart_failures.inc()
                if self._breaker_tripped(slot, consecutive=attempt + 1):
                    with r._lock:
                        slot.state = SLOT_FAILED
                        slot.circuit_open = True
                        slot.backoff_s = 0.0
                    r._c_circuit_open.inc()
                    r._g_restart_backoff[slot.index].set(0.0)
                    self._fail_exported(pairs)
                    return
                attempt += 1
                with self._rng_lock:     # concurrent slots share rng
                    backoff = compute_backoff(
                        attempt, base_s=self._backoff_base,
                        max_s=self._backoff_max, jitter=self._jitter,
                        rng=self._rng)
                slot.backoff_s = backoff
                r._g_restart_backoff[slot.index].set(backoff)
                self._stop.wait(backoff)
                continue
            # readiness gate passed: rejoin rotation. The compile count
            # recorded here is the no-capture-after-warmup baseline for
            # the respawned engine.
            warm = fresh.batcher.compile_count
            with r._lock:
                r.engines[slot.index] = fresh
                invalidated = r._affinity.invalidate(slot.index)
                slot.state = SLOT_SERVING
                slot.restarts += 1
                slot.warm_compile_count = warm
                slot.backoff_s = 0.0
                slot.restarting_since = None
            r._c_restarts.inc()
            r._g_restart_backoff[slot.index].set(0.0)
            # warm resume: the drained requests re-enter decode on the
            # fresh engine via KV import — zero re-prefilled tokens
            # across the restart. Their router entries still point at
            # this slot index, so the bridge keeps streaming into the
            # same outer handles.
            resumed = 0
            for snap, req in pairs:
                if req.done or req.cancel_requested:
                    continue
                try:
                    fresh.submit_import(snap, req)
                    resumed += 1
                # per-request resume boundary:
                # one unresumable snapshot must not strand the rest;
                # the failed request rides failover with its KV attached
                except Exception as e:
                    req.kv_snapshot = snap
                    req._finish(RequestState.FAILED, "respawn_failed",
                                error=e, now=self._clock())
            if fresh.trace is not None:
                fresh.trace.span(
                    "restarted", dur=self._clock() - t0,
                    replica=fresh.replica_id, attempts=attempt + 1,
                    affinity_invalidated=invalidated,
                    resumed_from_snapshot=resumed,
                    via_breaker_reset=slot.via_reset)
            slot.via_reset = False
            return
        # stopped mid-restart: the slot stays RESTARTING; the dead
        # engine still in the slot was already torn down and
        # Router.shutdown re-tears it idempotently — but the drained
        # requests must not hang on a box nobody will resume
        self._fail_exported(pairs)

    def _probe(self, eng,
               mirror: Optional[Tuple[List[int], int]] = None) -> None:
        """The readiness probe: one generation through the full
        admission→prefill→decode→channel path — the `mirror` shape (a
        recently-served live prompt + budget, when ``probe_mirror``
        captured one) or the synthetic probe prompt. Polls in short
        slices so a supervisor stop interrupts it bounded; raises on
        timeout, stop, an empty generation, or a respawned engine that
        is not HEALTHY afterwards (its own watchdog tripping during
        the probe lands here — the persistent-hang shape)."""
        if mirror is not None:
            prompt, max_new = list(mirror[0]), int(mirror[1])
        else:
            prompt, max_new = self._probe_prompt, self._probe_new
        req = eng.submit(prompt, max_new_tokens=max_new)
        deadline = self._clock() + self._probe_timeout_s
        while True:
            if self._stop.is_set():
                eng.cancel(req)
                raise RuntimeError("supervisor stopped mid-probe")
            try:
                out = req.result(timeout=0.05)
                break
            except TimeoutError:
                if self._clock() > deadline:
                    eng.cancel(req)
                    raise RuntimeError(
                        f"readiness probe timed out after "
                        f"{self._probe_timeout_s}s")
        if not out:
            raise RuntimeError("readiness probe generated no tokens")
        h = eng.health()
        if h["status"] != "HEALTHY" or not h.get("ready", True):
            raise RuntimeError(
                f"respawned replica not ready after probe: "
                f"{h['status']}")

    def _teardown(self, eng) -> None:
        """Bounded, best-effort engine teardown: `shutdown(drain=False)`
        joins bounded even when the engine thread is wedged inside a
        device call (the watchdog's 1s-join path)."""
        try:
            eng.shutdown(drain=False, timeout=self._teardown_timeout_s)
        # teardown boundary: a dead replica failing to die cleanly must
        # not kill the supervisor (the engine thread is a daemon)
        except Exception:
            pass
        _collect_when_exited(eng)

    def _fail_exported(self, pairs: List[Tuple[Any, Any]]) -> None:
        """Fail every drained-but-never-resumed request with its
        snapshot ATTACHED: "respawn_failed" is in the router's default
        failover predicate, so each one re-places warm (KV import) on
        a surviving replica instead of hanging on a box this cycle
        will never service."""
        for snap, req in pairs:
            if req.done:
                continue
            req.kv_snapshot = snap
            req._finish(RequestState.FAILED, "respawn_failed",
                        now=self._clock())

    def _breaker_tripped(self, slot: _Slot, consecutive: int) -> bool:
        """Crash-loop circuit breaker: True when `breaker_threshold`
        CONSECUTIVE failures landed in the current recovery cycle
        (`consecutive` — immune to attempts that each outlast the
        window: a 120s probe timeout must not outrun a 60s window and
        crash-loop forever), or when that many failures landed inside
        the trailing `breaker_window_s` across cycles (flap detection:
        a slot that rejoins and promptly dies again)."""
        if consecutive >= self._breaker_threshold:
            return True
        now = self._clock()
        while slot.failure_times and \
                now - slot.failure_times[0] > self._breaker_window_s:
            slot.failure_times.popleft()
        return len(slot.failure_times) >= self._breaker_threshold
