"""paddle_tpu_torch.serving.metrics — lock-safe serving metrics.

Reference analog: PaddleNLP serving / FastDeploy expose Prometheus-style
counters (requests accepted/rejected, TTFT, inter-token latency, queue
depth, cache usage). Here the registry is in-process: counters, gauges
and histograms behind one lock, with a plain-dict `snapshot()` so tests,
benchmarks and an eventual HTTP frontend read one consistent view
without scraping.

Profiler integration: `MetricsRegistry.timer(name)` is a context
manager that both observes wall time into a histogram AND opens a
`torch.profiler.record_function` span of the same name, so engine
phases (admission, the step) land in a torch profiler trace next to
the device work they launch. `to_prometheus()` renders the registry in
the Prometheus text format. Host-side otherwise: torch is imported only
by the timer's span.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LATENCY_BUCKETS"]

# Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]* — everything else
# (the registry's dotted names like "serving.step_s") maps to "_"
_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


class Counter:
    """Monotonic counter (requests_admitted, tokens_generated, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue_depth, kv_blocks_in_use, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, v: float) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# Default cumulative-bucket ladder for latency histograms exported as
# native Prometheus histograms (seconds; +Inf is implicit) — wide
# enough for TTFT under capture-cliff conditions, fine enough for
# inter-token gaps.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Latency distribution (TTFT, queue wait, per-step decode time).

    Keeps a bounded ring of raw observations (default 2048): count/sum
    are exact over the histogram's lifetime, percentiles are over the
    most recent window — the steady-state view a serving dashboard
    wants, without unbounded memory on long-lived engines.

    `buckets` (optional, ascending upper bounds; +Inf implicit) adds
    EXACT lifetime cumulative bucket counts next to the ring
    (`buckets()`, and `summary()["buckets"]`)."""

    __slots__ = ("name", "_lock", "_ring", "_cap", "_count", "_sum",
                 "_min", "_max", "_bounds", "_bucket_counts")

    def __init__(self, name: str, lock: threading.RLock, cap: int = 2048,
                 buckets: Optional[List[float]] = None):
        self.name = name
        self._lock = lock
        self._ring: List[float] = []
        self._cap = cap
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._bounds: Optional[List[float]] = \
            None if buckets is None else sorted(float(b) for b in buckets)
        self._bucket_counts: Optional[List[int]] = \
            None if buckets is None else [0] * len(self._bounds)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if len(self._ring) < self._cap:
                self._ring.append(v)
            else:
                self._ring[self._count % self._cap] = v
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if self._bounds is not None:
                # per-bucket counts here; buckets() renders them
                # cumulative
                for i, b in enumerate(self._bounds):
                    if v <= b:
                        self._bucket_counts[i] += 1
                        break

    def buckets(self) -> Optional[List[Tuple[float, int]]]:
        """Lifetime-exact CUMULATIVE (le, count) pairs (the +Inf bucket
        is the lifetime count and is implicit), or None when this
        histogram was created without a bucket ladder."""
        with self._lock:
            if self._bounds is None:
                return None
            out, acc = [], 0
            for b, c in zip(self._bounds, self._bucket_counts):
                acc += c
                out.append((b, acc))
            return out

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        # nearest-rank on the sorted window
        idx = min(len(sorted_vals) - 1,
                  max(0, int(round(q * (len(sorted_vals) - 1)))))
        return sorted_vals[idx]

    def percentile(self, q: float, since: int = 0) -> Optional[float]:
        """Nearest-rank percentile (q in [0, 1]) over the recent
        observation window, or None before the first observation —
        benchmark emitters read arbitrary quantiles (itl_ms_p99 & co)
        without re-implementing the windowing. `since` drops the first
        `since` lifetime observations (as counted by summary()["count"])
        from the window first, so a bench can rank only the samples
        recorded inside its timed region (e.g. skip the warmup request's
        compile-tainted inter-token gaps); observations that already
        fell off the ring are skipped implicitly."""
        with self._lock:
            if not self._ring:
                return None
            vals = self._ring
            if since > 0:
                if self._count <= self._cap:
                    ordered = vals
                else:
                    start = self._count % self._cap
                    ordered = vals[start:] + vals[:start]
                vals = ordered[max(0, since - (self._count - len(ordered))):]
                if not vals:
                    return None
            return self._percentile(sorted(vals), q)

    def summary(self) -> Dict[str, float]:
        """Lifetime and windowed statistics, under EXPLICIT keys so a
        long-lived engine's dashboard can't misread them: `count` /
        `sum` / `mean` / `min` / `max` are exact over the histogram's
        LIFETIME, while the percentiles AND `window_count` /
        `window_min` / `window_max` describe only the most recent
        `cap` observations still in the ring. Before the ring wraps
        the two views coincide; after it wraps, lifetime min/max may
        lie far outside the window the percentiles rank — which is
        why the windowed extrema get their own keys instead of being
        silently mixed in."""
        with self._lock:
            if not self._count:
                return {"count": 0}
            vals = sorted(self._ring)
            out = {} if self._bounds is None else {"buckets": self.buckets()}
            return {**out,
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "window_count": len(vals),
                "window_min": vals[0],
                "window_max": vals[-1],
                "p50": self._percentile(vals, 0.50),
                "p90": self._percentile(vals, 0.90),
                "p95": self._percentile(vals, 0.95),
                "p99": self._percentile(vals, 0.99),
            }


class _Timer:
    """Wall-time span → histogram observation + profiler span. The
    measured interval stays readable on `.elapsed` after exit so derived
    metrics share the one measurement."""

    __slots__ = ("_hist", "_span", "_t0", "elapsed")

    def __init__(self, hist: Histogram, span):
        self._hist = hist
        self._span = span
        self._t0 = None
        self.elapsed: Optional[float] = None

    def __enter__(self):
        if self._span is not None:
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self._hist.observe(self.elapsed)
        return False


class MetricsRegistry:
    """Named counters/gauges/histograms behind one shared lock.

    `snapshot()` returns a plain nested dict (JSON-ready), taken
    atomically so cross-metric invariants (admitted == completed +
    failed + ... after a drain) hold in a single read."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name, self._lock)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name, self._lock)
            return self._gauges[name]

    def histogram(self, name: str, cap: int = 2048,
                  buckets: Optional[List[float]] = None) -> Histogram:
        """Get-or-create histogram `name`; `buckets` (first creation
        only) arms exact cumulative bucket counts."""
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, self._lock, cap,
                                                   buckets=buckets)
            return self._histograms[name]

    def timer(self, name: str, record_event: bool = True) -> _Timer:
        """Time a block into histogram `name` and (by default) into a
        `torch.profiler.record_function` span of the same name, so
        serving phases appear on a profiler timeline next to the device
        steps."""
        span = None
        if record_event:
            import torch
            span = torch.profiler.record_function(name)
        return _Timer(self.histogram(name), span)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }

    def to_prometheus(self, prefix: str = "paddle_tpu_") -> str:
        """Render every metric in the Prometheus text exposition
        format (version 0.0.4): an HTTP `/metrics` handler returns
        exactly this string with content type
        ``text/plain; version=0.0.4``.

        Counters render as ``<prefix><name>_total``, gauges as
        ``<prefix><name>``, histograms as Prometheus *summaries*
        (``{quantile="0.5|0.9|0.95|0.99"}`` over the recent window,
        plus lifetime ``_sum`` / ``_count``). Registry names are
        sanitized to the Prometheus charset (``serving.step_s`` →
        ``serving_step_s``). One atomic snapshot backs the whole
        rendering, so cross-metric invariants hold within a scrape.

        Histograms created with a bucket ladder ADDITIONALLY export a
        native histogram family ``<prefix><name>_hist`` — cumulative
        ``_bucket{le="..."}`` series (lifetime-exact counts, ``+Inf``
        included) plus ``_hist_sum`` / ``_hist_count`` — so an
        external Prometheus can compute its own burn rates instead of
        trusting the in-process windowed quantiles. The ``_hist``
        suffix keeps the summary and histogram as two distinct
        families, which a strict 0.0.4 parser requires."""
        with self._lock:
            # ONE lock acquisition (RLock — snapshot() re-enters) for
            # the summary snapshot AND the bucket counts: an observe()
            # landing between two separate reads would render a finite
            # le bucket above the +Inf count — a non-monotone
            # histogram Prometheus rejects into NaN quantiles
            snap = self.snapshot()
            hist_buckets = {}
            for n, h in self._histograms.items():
                cum = h.buckets()
                if cum is not None:
                    hist_buckets[n] = cum
        lines: List[str] = []

        def san(name: str) -> str:
            return _PROM_NAME_RE.sub("_", name)

        def num(v) -> str:
            return repr(float(v))

        for name, v in snap["counters"].items():
            # the _total suffix is part of the family name in the
            # 0.0.4 text format — a TYPE line for the bare name would
            # leave the actual samples typed "unknown"
            base = prefix + san(name) + "_total"
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base} {num(v)}")
        for name, v in snap["gauges"].items():
            base = prefix + san(name)
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {num(v)}")
        for name, s in snap["histograms"].items():
            base = prefix + san(name)
            lines.append(f"# TYPE {base} summary")
            for q, key in ((0.5, "p50"), (0.9, "p90"),
                           (0.95, "p95"), (0.99, "p99")):
                if key in s:
                    lines.append(f'{base}{{quantile="{q}"}} {num(s[key])}')
            lines.append(f"{base}_sum {num(s.get('sum', 0.0))}")
            lines.append(f"{base}_count {num(s.get('count', 0))}")
            cum = hist_buckets.get(name)
            if cum is not None:
                hb = base + "_hist"
                lines.append(f"# TYPE {hb} histogram")
                for le, count in cum:
                    lines.append(
                        f'{hb}_bucket{{le="{le}"}} {num(count)}')
                lines.append(f'{hb}_bucket{{le="+Inf"}} '
                             f'{num(s.get("count", 0))}')
                lines.append(f"{hb}_sum {num(s.get('sum', 0.0))}")
                lines.append(f"{hb}_count {num(s.get('count', 0))}")
        return "\n".join(lines) + "\n"
