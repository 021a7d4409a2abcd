"""paddle_tpu_torch.serving.trace — per-request trace timelines and the
step flight recorder.

The port's own copy of paddle_tpu/serving/trace.py (host-side only, no
torch); the exported Chrome trace has the same events and names.

The serving stack's forensic layer: five mechanisms interact on the hot
path (prefix-cache sharing, bucketed/chunked prefill, fused mixed-batch
steps, multi-unit piggyback, the ragged attention kernel) and aggregate
metrics can't answer *where one request's time went* or *what the
scheduler decided on the step that failed*. This module can, and it is
cheap enough to leave on in production:

  * `TraceSink` — lock-safe, bounded collector of typed per-request
    events (enqueued, admitted, prepared, prefill_chunk, first_token,
    decode_emit, retired, finished/cancelled/failed/timed_out). The
    engine creates one and threads it into the batcher; every emission
    is a host-side dict append — no device syncs, no recompiles (the
    compiled-shape memo keys never see the sink). Timelines read back
    as structured dicts and export as Chrome-trace / Perfetto JSON
    (`to_chrome_trace()`: pid = the engine process, tid = the batch
    slot a request occupied, plus lanes for queued requests and engine
    step spans).
  * `FlightRecorder` — a bounded ring of one record per batcher step
    tick (mode chosen, unit composition, bucket / group pad, free
    slots / blocks, compile-memo hit or miss), recorded *before* the
    device call so the tick that raises is the last record in the ring.
    The engine's step-level exception boundary dumps the ring plus
    allocator / queue state to JSON on failure.

Timestamps come from `time.perf_counter` — the same clock
`MetricsRegistry.timer` measures with — so serving timelines line up
with the `serving.step_s` histogram and, when a torch profiler capture
is running, with the timer's `record_function` spans on its timeline.

Dependency-free on purpose (no torch import, like `serving.cache`):
`nlp.paged` may construct a `FlightRecorder` without pulling the
serving engine, and `tools/trace_report.py` reads the exported JSON
with nothing but the standard library.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Union

__all__ = ["TraceSink", "FlightRecorder"]

# Chrome-trace lanes for events that are not anchored to a batch slot:
# requests still queued (no slot yet), the engine's per-step spans, and
# the DEVICE-wall spans a profiler capture window measures (kept on
# their own lane so host wall and device wall render side by side).
# Batch slots use tid = slot index (0..max_batch-1), far below these.
_DEVICE_TID = 9997
_QUEUE_TID = 9998
_STEPS_TID = 9999


class TraceSink:
    """Lock-safe, bounded, always-on-cheap collector of per-request
    trace timelines.

    One timeline per request: `start()` opens it (returning a string
    trace id the engine stamps on the request handle), `alias()` maps a
    batcher rid onto it so batcher-side emissions resolve to the same
    timeline, `emit()` appends typed events, and `finish()` appends the
    terminal event and moves the timeline onto a bounded ring of
    completed requests. Event kinds are free-form strings; the serving
    stack's vocabulary includes the fault-tolerance events `requeued`
    (a quarantine victim or rolled-back pending sibling going back to
    the queue front) and `retried` (a transient culprit parked for a
    backoff re-admission) next to the lifecycle kinds listed above. An int ref with no alias auto-opens a timeline
    keyed ``rid<n>`` so a standalone `ContinuousBatcher` can trace
    without an engine.

    Bounds: at most `max_events` events per timeline (overflow counted
    in `dropped_events`; the terminal event always lands), at most
    `max_requests` completed timelines retained, and at most
    `max_requests` LIVE timelines — when a producer that never calls
    `finish()` (a standalone batcher's auto-opened rid timelines)
    overflows that, the oldest live timeline is displaced onto the
    completed ring and its aliases drop, so memory stays bounded in
    every mode. Every emission is a host-side dict append under one
    lock — no device values may ever cross into an event.
    """

    def __init__(self, max_requests: int = 256, max_events: int = 512,
                 max_live: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self._lock = threading.Lock()
        self._clock = clock
        self.origin = clock()
        self._seq = 0
        self._max_events = max_events
        # the live bound exists to cap finish()-less producers; a
        # producer that DOES finish timelines (the engine) must size it
        # above its maximum concurrent request count, or a deep queued
        # burst would displace still-running requests (losing their
        # terminals and splitting them across phantom rid timelines)
        self._max_live = max(1, int(max_requests if max_live is None
                                    else max_live))
        self._live: Dict[str, Dict[str, Any]] = {}
        self._done: deque = deque(maxlen=max_requests)
        self._alias: Dict[int, str] = {}
        # non-request lanes: engine step spans (bounded like the rest)
        self._spans: deque = deque(maxlen=4 * max_requests)
        # loss accounting: NOTHING vanishes silently — per-timeline
        # overflow, emissions on vanished/finished timelines, and live
        # displacements each tick a counter
        self.dropped_events = 0
        self.displaced_live = 0

    # ---- emission (hot path: host-side appends only) --------------------
    def now(self) -> float:
        """The sink's clock (default `time.perf_counter` — the same
        timebase as `MetricsRegistry.timer`)."""
        return self._clock()

    def start(self, label: Optional[str] = None, **attrs) -> str:
        """Open a new timeline; returns its trace id (``t<n>``)."""
        with self._lock:
            tid = f"t{self._seq}"
            self._seq += 1
            self._live[tid] = {"trace_id": tid, "label": label,
                               "slot": None, "done": False, "events": []}
            if attrs:
                self._append_locked(self._live[tid], "start", None,
                                    self._clock(), attrs, forced=True)
            self._bound_live_locked()
            return tid

    def alias(self, rid: int, trace_id: str) -> None:
        """Map a batcher request id onto an open timeline, so
        batcher-side `emit(rid, ...)` calls resolve to it."""
        with self._lock:
            self._alias[int(rid)] = trace_id

    def emit(self, ref: Union[int, str], kind: str,
             dur: Optional[float] = None, **attrs) -> None:
        """Append one typed event to `ref`'s timeline. `ref` is a trace
        id, or a batcher rid (resolved through `alias`, auto-opening a
        ``rid<n>`` timeline when unaliased). `dur` (seconds) marks a
        span; attrs must be JSON-safe host values."""
        t = self._clock()
        with self._lock:
            tl = self._resolve_locked(ref)
            if tl is None or tl["done"]:
                # vanished (displaced) or already-terminal timeline:
                # the event is lost, but never silently
                self.dropped_events += 1
                return
            self._append_locked(tl, kind, dur, t, attrs)

    def finish(self, ref: Union[int, str], kind: str, **attrs) -> None:
        """Append the terminal event (always lands, bounds or not) and
        retire the timeline onto the completed ring. Idempotent: a
        second finish on the same timeline is a no-op."""
        t = self._clock()
        with self._lock:
            tl = self._resolve_locked(ref)
            if tl is None or tl["done"]:
                return
            self._append_locked(tl, kind, None, t, attrs, forced=True)
            tl["done"] = True
            self._live.pop(tl["trace_id"], None)
            self._done.append(tl)
            for rid in [r for r, k in self._alias.items()
                        if k == tl["trace_id"]]:
                del self._alias[rid]

    def span(self, name: str, dur: float, lane: str = "steps",
             **attrs) -> None:
        """Record one engine-level span (e.g. ``engine.step``) ending
        now and lasting `dur` seconds — the sink-side twin of a
        `MetricsRegistry.timer` observation. `lane` picks the Chrome
        lane: "steps" (default) or "device" (the device-wall spans a
        profiler capture window measures, rendered next to the host
        step spans so the two walls are visually comparable)."""
        t1 = self._clock()
        with self._lock:
            self._spans.append({"kind": name, "t": t1 - dur, "dur": dur,
                                "lane": lane, "attrs": dict(attrs)})

    # ---- internal -------------------------------------------------------
    def _resolve_locked(self, ref):
        if isinstance(ref, int):
            key = self._alias.get(ref)
            if key is None:
                key = f"rid{ref}"
                if key not in self._live and not any(
                        tl["trace_id"] == key for tl in self._done):
                    self._live[key] = {"trace_id": key, "label": None,
                                       "slot": None, "done": False,
                                       "events": []}
                    self._bound_live_locked()
            return self._live.get(key)
        return self._live.get(ref)

    def _bound_live_locked(self):
        """Keep the live set bounded even for producers that never
        finish() (standalone-batcher rid timelines): displace the
        oldest live timeline onto the completed ring and drop its
        aliases. Insertion order IS age — dicts preserve it."""
        while len(self._live) > self._max_live:
            key, tl = next(iter(self._live.items()))
            del self._live[key]
            self._done.append(tl)
            self.displaced_live += 1
            for rid in [r for r, k in self._alias.items() if k == key]:
                del self._alias[rid]

    def _append_locked(self, tl, kind, dur, t, attrs, forced=False):
        if not forced and len(tl["events"]) >= self._max_events:
            self.dropped_events += 1
            return
        ev: Dict[str, Any] = {"kind": kind, "t": t}
        if dur is not None:
            ev["dur"] = dur
        if attrs:
            ev["attrs"] = dict(attrs)
            slot = attrs.get("slot")
            if slot is not None:
                tl["slot"] = slot
        tl["events"].append(ev)

    # ---- read side ------------------------------------------------------
    def timeline(self, ref: Union[int, str]) -> Optional[Dict[str, Any]]:
        """One request's timeline as a structured dict (deep copy), or
        None when `ref` names no live or retained timeline."""
        with self._lock:
            if isinstance(ref, int):
                ref = self._alias.get(ref, f"rid{ref}")
            tl = self._live.get(ref)
            if tl is None:
                tl = next((d for d in self._done
                           if d["trace_id"] == ref), None)
            return None if tl is None else self._copy(tl)

    def timelines(self) -> List[Dict[str, Any]]:
        """Every retained timeline (completed ring first, then live),
        as structured dicts."""
        with self._lock:
            return [self._copy(tl) for tl in list(self._done)
                    + list(self._live.values())]

    @staticmethod
    def _copy(tl):
        out = dict(tl)
        out["events"] = [
            {**ev, "attrs": dict(ev["attrs"])} if "attrs" in ev
            else dict(ev) for ev in tl["events"]]
        return out

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Export every retained timeline as Chrome-trace / Perfetto
        JSON (the ``traceEvents`` array format): pid 1 is the engine,
        tid is the batch slot a request occupied at that point (queued
        events ride a ``queue`` lane, engine step spans a ``steps``
        lane). Events with a duration render as complete ("X") spans,
        the rest as thread-scoped instants ("i"); timestamps are
        microseconds from the sink's origin, monotonic by
        construction."""
        pid = 1
        with self._lock:
            tls = [self._copy(tl) for tl in list(self._done)
                   + list(self._live.values())]
            spans = [dict(s) for s in self._spans]
            origin = self.origin
        events: List[Dict[str, Any]] = []
        tids = set()

        def us(t):
            # clamped: a span whose start predates the sink's origin
            # (possible only for hand-fed durations) must not produce
            # a negative timestamp Perfetto rejects
            return max(0.0, (t - origin) * 1e6)

        for tl in tls:
            cur_tid = _QUEUE_TID
            for ev in tl["events"]:
                attrs = ev.get("attrs", {})
                slot = attrs.get("slot")
                if slot is not None:
                    cur_tid = int(slot)
                tids.add(cur_tid)
                out = {"name": ev["kind"], "pid": pid, "tid": cur_tid,
                       "args": {"trace_id": tl["trace_id"], **attrs}}
                if "dur" in ev:
                    # emission stamps the span's END (the event is
                    # recorded after the measured call returns) — the
                    # rendered span starts dur earlier, so it nests
                    # inside the engine.step span that contained it
                    out["ph"] = "X"
                    out["ts"] = us(ev["t"] - ev["dur"])
                    out["dur"] = ev["dur"] * 1e6
                else:
                    out["ph"] = "i"
                    out["ts"] = us(ev["t"])
                    out["s"] = "t"
                events.append(out)
        for s in spans:
            tid = (_DEVICE_TID if s.get("lane") == "device"
                   else _STEPS_TID)
            tids.add(tid)
            events.append({"name": s["kind"], "ph": "X", "pid": pid,
                           "tid": tid, "ts": us(s["t"]),
                           "dur": s["dur"] * 1e6,
                           "args": dict(s["attrs"])})
        events.sort(key=lambda e: e["ts"])
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": "paddle_tpu.serving engine"}}]
        for tid in sorted(tids):
            name = ("queue" if tid == _QUEUE_TID
                    else "engine steps" if tid == _STEPS_TID
                    else "device steps" if tid == _DEVICE_TID
                    else f"slot {tid}")
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


class FlightRecorder:
    """Bounded ring buffer of per-step scheduler records — the serving
    stack's black box.

    `ContinuousBatcher` appends one record per device-step tick
    *before* dispatching the call (mode chosen, unit composition,
    bucket / group pad, free slots / blocks, compile-memo hit or
    miss), so when a step raises, the failing tick is the last record
    in the ring. `ServingEngine.dump_flight_recorder()` (and the
    engine's step-failure boundary) serialize `records()` plus
    allocator / queue state to JSON. Records are plain JSON-safe
    dicts; appends are host-side only and lock-safe."""

    def __init__(self, cap: int = 64,
                 clock: Callable[[], float] = time.perf_counter):
        self._lock = threading.Lock()
        self._clock = clock
        self._ring: deque = deque(maxlen=max(1, int(cap)))
        self._seq = 0

    @property
    def cap(self) -> int:
        """Ring capacity: the last `cap` step records are retained."""
        with self._lock:
            return self._ring.maxlen

    @property
    def seq(self) -> int:
        """Records ever written (not just retained). The engine's
        quarantine compares this against the value it saw after the
        last successful step: an exception with an UNCHANGED seq came
        from before any tick was recorded (an admission-time failure),
        so the ring's last record would be a stale tick — no basis for
        convicting anyone."""
        with self._lock:
            return self._seq

    def record(self, mode: str, **fields) -> None:
        """Append one step record: `mode` is the scheduler's decision
        for the tick ("decode" | "fused" | "prefill"), `fields` carry
        the tick's composition and pool state (JSON-safe host values
        only)."""
        with self._lock:
            self._ring.append({"seq": self._seq, "t": self._clock(),
                               "mode": mode, **fields})
            self._seq += 1

    def records(self) -> List[Dict[str, Any]]:
        """The retained records, oldest first (copies — safe to
        serialize while the engine keeps stepping)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
