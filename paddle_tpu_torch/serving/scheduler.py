"""paddle_tpu_torch.serving.scheduler — admission control for the engine.

A bounded priority queue in front of the device batch: admission order
is priority-then-FIFO, a full queue REJECTS (backpressure to the client
instead of buffering until OOM), and waiting requests age so a stream of
high-priority arrivals cannot starve the tail.

Block-aware deferral reuses the ContinuousBatcher's defer-on-no-blocks
logic: `pop_many(k, fits=...)` hands out the best request only when its
KV-block need fits the pool right now, and otherwise defers the WHOLE queue
(head-of-line) — skipping ahead to smaller requests would starve big
ones forever, and the engine has already validated at submit time that
every queued request fits an empty pool, so deferral always resolves.

A `prefer` predicate breaks ties within an effective-priority level:
the engine passes its cached-prefix preference, so a request whose
prefix the cache holds right now is served before eviction recycles
those blocks.

Host-side only (no torch): the JAX package's `serving/scheduler.py`
without the quarantine requeue, which belongs to fault tolerance.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, NamedTuple, Optional

__all__ = ["AdmissionQueue", "QueueFullError"]


class QueueFullError(RuntimeError):
    """Queue at max_depth — the caller should retry later or shed load."""


class _Entry(NamedTuple):
    priority: int
    seq: int
    enq_time: float
    item: object


class AdmissionQueue:
    """Bounded priority queue: smaller priority first, FIFO within a
    priority, starvation-free aging.

    Aging: an entry's effective priority improves by one level per
    `aging_interval_s` waited, so a priority-9 request that has waited
    9 intervals competes with fresh priority-0 traffic. Ties (same
    effective priority) break by submission order."""

    def __init__(self, max_depth: int = 256,
                 aging_interval_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = max_depth
        self.aging_interval_s = float(aging_interval_s)
        self._clock = clock
        self._items: List[_Entry] = []
        self._seq = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def push(self, item, priority: int = 0) -> None:
        with self._lock:
            if len(self._items) >= self.max_depth:
                raise QueueFullError(
                    f"admission queue full ({self.max_depth} requests "
                    f"waiting) — rejecting instead of buffering")
            self._items.append(
                _Entry(int(priority), self._seq, self._clock(), item))
            self._seq += 1

    def _key(self, e: _Entry, now: float,
             prefer: Optional[Callable[[object], bool]] = None):
        aged = int((now - e.enq_time) / self.aging_interval_s) \
            if self.aging_interval_s > 0 else 0
        if prefer is None:
            return (e.priority - aged, e.seq)
        # preference is a TIE-BREAK within an effective-priority level:
        # it can reorder equals (cache-aware admission) but never jump
        # a lower-priority request over a higher one
        return (e.priority - aged, 0 if prefer(e.item) else 1, e.seq)

    def pop(self, fits: Optional[Callable[[object], bool]] = None,
            prefer: Optional[Callable[[object], bool]] = None):
        """Remove and return the best (aged-priority, FIFO) item, or
        None when empty. With `fits`, the best item is returned only
        when fits(item) is True; otherwise the queue DEFERS as a whole
        (returns None). With `prefer`, items for which prefer(item) is
        True win ties WITHIN an effective priority level; FIFO still
        breaks remaining ties."""
        got = self.pop_many(1, fits=fits, prefer=prefer)
        return got[0] if got else None

    def pop_many(self, k: int,
                 fits: Optional[Callable[[object], bool]] = None,
                 prefer: Optional[Callable[[object], bool]] = None
                 ) -> List[object]:
        """Pop up to `k` best items under ONE lock acquisition and one
        consistent clock reading — the engine's admission round takes a
        whole burst at once (the burst then prefills in one call
        batcher-side). Same semantics as `pop` applied repeatedly:
        head-of-line deferral (the best REMAINING item failing `fits`
        stops the round), `prefer` tie-breaks within an effective-
        priority level. `fits` is called once per accepted item, so
        callers may account resources (KV blocks) inside it."""
        out: List[object] = []
        with self._lock:
            now = self._clock()
            while len(out) < k and self._items:
                best = min(self._items,
                           key=lambda e: self._key(e, now, prefer))
                if fits is not None and not fits(best.item):
                    break
                self._items.remove(best)
                out.append(best.item)
        return out

    def reap(self, predicate: Callable[[object], bool]) -> List[object]:
        """Remove and return every item matching `predicate` (used for
        cancellation and deadline expiry of still-queued requests)."""
        with self._lock:
            hit = [e for e in self._items if predicate(e.item)]
            for e in hit:
                self._items.remove(e)
            return [e.item for e in hit]

    def clear(self) -> List[object]:
        with self._lock:
            items = [e.item for e in self._items]
            self._items.clear()
            return items
