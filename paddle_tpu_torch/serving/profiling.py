"""paddle_tpu_torch.serving.profiling — sampled device-time attribution
for the continuous batcher.

The port's own copy of paddle_tpu/serving/profiling.py (host-side only,
no torch). The batcher's fence differs: on the card a fenced tick
records CUDA events around the replay and synchronizes on the second
one; on the CPU the step has already run when the call returns.

Trace timelines attribute per-chunk time as HOST wall per call —
which, with asynchronous launches, measures how long the host took to
*issue* the work, not how long the device took to *do* it. A TTFT
regression could therefore be the ragged kernel or host-side
scheduling, and the timeline could not say which. This module closes
that gap two ways:

  * **Sampled steps** — every Nth step tick (``sample_every``, default
    64; 0 disables) the batcher fences the device call and records the
    measured device time per shape key ``(mode, bucket, units, impl,
    weight_dtype, kv_dtype)`` into bounded per-shape histograms. One
    fenced step in N costs ~1/N of a step of extra latency on the
    sampled tick and NOTHING on the other N-1 (the fence never runs in
    the unfenced path, and the step-shape memo keys never see the
    profiler).
  * **Capture windows** — ``arm_capture(steps=K)`` fences the next K
    ticks unconditionally and retains one record per fenced step
    (mode, composition, host vs device wall). The engine merges those
    spans (and per-chunk ``device_dur`` annotations) back into the
    TraceSink so ``to_chrome_trace()`` timelines carry device wall
    next to host wall, and ``ServingEngine.capture_profile()`` /
    ``POST /debug/profile`` return the report over HTTP.

Attribution convention: ``host_s`` is dispatch wall (the device call
returning control to the host — enqueue cost), ``device_s`` the time
the device took for the step (CUDA events around the replay on the
card; on the CPU the step's own wall, the two nearly coincide). The
*fields* are what make regressions attributable.

Dependency-free on purpose (stdlib only, like `serving.trace` and
`serving.slo`): the batcher owns the fence; this module only does
host-side counting, so the tests can reason about reports without a
device.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["StepProfiler"]

# bounds: distinct shape keys retained (beyond: counted, not stored)
# and raw device-wall samples kept per key for percentile math
_MAX_KEYS = 64
_MAX_SAMPLES_PER_KEY = 512


class _ShapeStats:
    """Bounded per-shape accumulator: exact count/sum, ring of recent
    device-wall samples for percentiles."""

    __slots__ = ("count", "device_sum_s", "host_sum_s", "ring")

    def __init__(self):
        self.count = 0
        self.device_sum_s = 0.0
        self.host_sum_s = 0.0
        self.ring: List[float] = []

    def add(self, device_s: float, host_s: float) -> None:
        if len(self.ring) < _MAX_SAMPLES_PER_KEY:
            self.ring.append(device_s)
        else:
            self.ring[self.count % _MAX_SAMPLES_PER_KEY] = device_s
        self.count += 1
        self.device_sum_s += device_s
        self.host_sum_s += host_s

    def summary(self) -> Dict[str, float]:
        s = sorted(self.ring)

        def pct(q):
            return s[min(len(s) - 1,
                         max(0, int(round(q * (len(s) - 1)))))]
        return {
            "count": self.count,
            "device_sum_s": self.device_sum_s,
            "host_sum_s": self.host_sum_s,
            "device_mean_s": self.device_sum_s / self.count,
            "device_p50_s": pct(0.50),
            "device_p99_s": pct(0.99),
        }


class StepProfiler:
    """Sampled device-time profiler for `ContinuousBatcher` step ticks.

    The batcher asks `should_fence()` once per device-call tick; True
    means "fence THIS call and report the measurement" — every
    `sample_every`th tick, plus every tick of an armed capture window.
    After fencing it calls `record(...)` with the measured walls and
    the tick's shape key; capture-window ticks additionally retain a
    per-step record for timeline merging. All host-side arithmetic
    under one lock; `arm_capture` is callable from any thread (the
    engine's `capture_profile` and the frontend's `/debug/profile`
    arm it while the engine thread steps).
    """

    def __init__(self, sample_every: int = 64):
        if int(sample_every) < 0:
            raise ValueError("sample_every must be >= 0 (0 disables)")
        self.sample_every = int(sample_every)
        self._lock = threading.Lock()
        self._tick = 0          # device-call ticks seen
        self.samples = 0        # fenced ticks measured
        self.dropped_keys = 0   # shapes past the retention bound
        self._shapes: Dict[Tuple, _ShapeStats] = {}
        # capture window: ticks remaining + retained per-step records
        self._capture_left = 0
        self._capture_steps: List[Dict[str, Any]] = []
        self._capture_total = 0
        self._capture_cancelled = False

    # ---- the per-tick gate (hot path: one int compare in the common
    #      unfenced case) -------------------------------------------------
    def should_fence(self) -> bool:
        """Advance the tick counter and decide whether the batcher
        fences THIS device call: every `sample_every`th tick, or any
        tick while a capture window is armed. The unfenced path costs
        one locked increment and compare — nothing touches the device."""
        with self._lock:
            self._tick += 1
            if self._capture_left > 0:
                return True
            return (self.sample_every > 0
                    and self._tick % self.sample_every == 0)

    def record(self, *, mode: str, bucket: int, units: int, impl: str,
               weight_dtype: str, kv_dtype: str, device_s: float,
               host_s: float, detail: Optional[Dict] = None) -> bool:
        """One fenced tick's measurement, attributed to its shape key.
        `detail` (rids/unit composition) is retained only for capture-
        window steps. Returns True when this record CLOSED an armed
        capture window (the waiter's wake-up signal)."""
        key = (mode, int(bucket), int(units), impl, weight_dtype,
               kv_dtype)
        with self._lock:
            self.samples += 1
            stats = self._shapes.get(key)
            if stats is None:
                if len(self._shapes) >= _MAX_KEYS:
                    self.dropped_keys += 1
                else:
                    stats = self._shapes[key] = _ShapeStats()
            if stats is not None:
                stats.add(float(device_s), float(host_s))
            if self._capture_left > 0:
                self._capture_left -= 1
                self._capture_steps.append({
                    "mode": mode, "bucket": int(bucket),
                    "units": int(units), "impl": impl,
                    "weight_dtype": weight_dtype, "kv_dtype": kv_dtype,
                    "device_s": float(device_s),
                    "host_s": float(host_s),
                    **(detail or {})})
                return self._capture_left == 0
            return False

    # ---- capture windows -------------------------------------------------
    def arm_capture(self, steps: int) -> None:
        """Fence the next `steps` ticks unconditionally and retain one
        record per fenced step. Re-arming extends an open window;
        records of a previous completed window are replaced."""
        if int(steps) < 1:
            raise ValueError("capture steps must be >= 1")
        with self._lock:
            if self._capture_left == 0:
                self._capture_steps = []
                self._capture_total = 0
            self._capture_left += int(steps)
            self._capture_total += int(steps)
            self._capture_cancelled = False

    def capture_active(self) -> bool:
        """True while an armed capture window still has ticks to fence."""
        with self._lock:
            return self._capture_left > 0

    def cancel_capture(self) -> int:
        """Disarm an open capture window (already-captured step
        records are kept; the report's `complete` stays False).
        Returns the number of fences cancelled. A waiter that gave up
        (`capture_profile` timeout) MUST call this — a leftover armed
        window would silently fence every future tick once traffic
        resumes, a latency tax nobody asked for."""
        with self._lock:
            left, self._capture_left = self._capture_left, 0
            if left:
                self._capture_cancelled = True
            return left

    def capture_report(self) -> Dict[str, Any]:
        """The last capture window: per-step records (mode,
        composition, host vs device wall) plus completion state —
        `complete` False means the window was still armed when read
        (an idle engine produces no ticks to fence)."""
        with self._lock:
            return {
                "steps_requested": self._capture_total,
                "steps_captured": len(self._capture_steps),
                "complete": (self._capture_total > 0
                             and self._capture_left == 0
                             and not self._capture_cancelled),
                "steps": [dict(s) for s in self._capture_steps],
            }

    # ---- reporting -------------------------------------------------------
    @staticmethod
    def key_fields(key: Tuple) -> Dict[str, Any]:
        """A shape key tuple as named fields (the report's row schema)."""
        mode, bucket, units, impl, wd, kd = key
        return {"mode": mode, "bucket": bucket, "units": units,
                "impl": impl, "weight_dtype": wd, "kv_dtype": kd}

    def report(self) -> Dict[str, Any]:
        """Everything measured so far: the sampling config, per-shape
        device-wall histograms (count / sums / p50 / p99 keyed by the
        (mode, bucket, units, impl, qkey) fields) and the last capture
        window. JSON-safe — `/debug/profile` returns exactly this."""
        with self._lock:
            shapes = [{**self.key_fields(k), **v.summary()}
                      for k, v in self._shapes.items()]
            ticks, samples = self._tick, self.samples
            dropped = self.dropped_keys
        shapes.sort(key=lambda r: -r["device_sum_s"])
        return {
            "sample_every": self.sample_every,
            "ticks": ticks,
            "samples": samples,
            "dropped_keys": dropped,
            "shapes": shapes,
            "capture": self.capture_report(),
        }
