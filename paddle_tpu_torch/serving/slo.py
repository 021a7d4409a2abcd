"""paddle_tpu_torch.serving.slo — in-process SLO engine for the serving
tier.

The port's own copy of paddle_tpu/serving/slo.py (host-side only, no
torch): the same objectives, windows, burn rates and verdicts.

The serving metrics measure everything, but without a tracker nothing
in-process *watches* the objectives: a TTFT regression or a goodput
collapse is visible only to whoever reads the dashboard. The
`SloTracker` closes that loop — declarative objectives, evaluated
continuously over dual rolling windows, producing burn rates and OK /
WARN / BREACH verdicts the engine exposes through `health()["slo"]`,
Prometheus (`slo_burn_rate_*` gauges, `slo_breaches_total` counters)
and TraceSink `slo_breach` events; `rollup` aggregates several
replicas' reports.

Objectives are `{name: target}` pairs drawn from a fixed vocabulary
(unknown names raise — a typo'd objective silently never firing is the
worst possible failure mode for an alerting primitive):

  * ``ttft_s_p99``       — ceiling on p99 time-to-first-token (s);
  * ``itl_ms_p99``       — ceiling on p99 inter-token latency (ms);
  * ``queue_wait_s_p99`` — ceiling on p99 admission queue wait (s);
  * ``error_rate``       — ceiling on failed+timed-out / terminal
    requests (cancellations are the client's choice, not an error);
  * ``goodput_tok_s``    — FLOOR on generated tokens per second of
    the window's ACTIVE span (first in-window sample → now, so
    pre-traffic idle never dilutes real throughput into a phantom
    burn; an entirely idle window is "no evidence", not a breach).

Dual rolling windows (Google SRE multi-window burn-rate alerting,
shrunk to in-process scale): a fast window (~5 s) that reacts to an
incident within seconds, and a slow window (~60 s) that keeps the
verdict honest about sustained degradation after the fast window
forgets. The **burn rate** is how hard an objective is being consumed:
``value / target`` for ceilings, ``target / value`` for floors — 1.0
exactly at the objective, 2.0 means twice as bad as promised.

Verdicts per objective, with breach→recover hysteresis so a burn rate
oscillating around 1.0 cannot flap alerts:

    OK ──(fast burn >= breach_burn)──▶ BREACH
    BREACH stays BREACH until fast burn <= recover_burn, then
    ▶ WARN while (fast burn >= warn_burn OR slow burn >= breach_burn)
    ▶ OK otherwise

SLOs degrade, supervision decides: a BREACH never flips `/health` off
200 by itself — the verdict is detail for operators and load
balancers, while supervision keeps deciding what gets restarted.

Fake-clock-testable and dependency-free (stdlib only, like
`serving.trace`): the tracker takes an injectable `clock`, samples are
timestamped host floats, and evaluation is pure window math — no torch,
no device values.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["SloTracker", "DEFAULT_OBJECTIVES", "OBJECTIVE_KINDS",
           "rollup", "worst_verdict"]

# Verdict severity order (worst last) — rollup() and the per-objective
# state machine both rank with this.
_VERDICT_ORDER = ("OK", "WARN", "BREACH")

# objective name -> (kind, sample stream) — the fixed vocabulary.
# "ceiling" objectives burn as value/target, "floor" ones as
# target/value; the stream names the sample series the value is
# computed from (see SloTracker.record_*).
OBJECTIVE_KINDS: Dict[str, Tuple[str, str]] = {
    "ttft_s_p99": ("ceiling", "ttft_s"),
    "itl_ms_p99": ("ceiling", "itl_s"),
    "queue_wait_s_p99": ("ceiling", "queue_wait_s"),
    "error_rate": ("ceiling", "requests"),
    "goodput_tok_s": ("floor", "tokens"),
}

# Generous catch-fire defaults: an unconfigured engine should page on
# "clearly broken", not on workload-specific tuning the operator never
# did. goodput_tok_s is absent on purpose — a throughput floor is
# meaningless without knowing the offered load.
DEFAULT_OBJECTIVES: Dict[str, float] = {
    "ttft_s_p99": 5.0,
    "itl_ms_p99": 500.0,
    "queue_wait_s_p99": 2.0,
    "error_rate": 0.05,
}


def worst_verdict(verdicts: Sequence[str]) -> str:
    """The most severe of a set of OK/WARN/BREACH verdicts (OK when
    the set is empty — no objective, nothing to breach)."""
    worst = "OK"
    for v in verdicts:
        if _VERDICT_ORDER.index(v) > _VERDICT_ORDER.index(worst):
            worst = v
    return worst


def _p99(vals: List[float]) -> float:
    """Nearest-rank p99 (matches Histogram._percentile's convention)."""
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, int(round(0.99 * (len(s) - 1)))))
    return s[idx]


class SloTracker:
    """Declarative SLO evaluation over dual rolling windows.

    Usage (the engine wires this automatically — `ServingEngine(
    slo_objectives={...})`):

        slo = SloTracker({"ttft_s_p99": 0.5, "goodput_tok_s": 100.0})
        slo.record_ttft(0.12); slo.record_tokens(8)
        ...
        report = slo.evaluate()     # cached, recomputed every
                                    # eval_every_s at most
        report["verdict"]           # "OK" | "WARN" | "BREACH"
        report["objectives"]["ttft_s_p99"]["burn_rate_fast"]

    `record_*` calls are hot-path cheap: one timestamped append to a
    bounded deque under the tracker lock. `evaluate()` prunes samples
    past the slow window and computes each objective's fast/slow value,
    burn rates and verdict (with hysteresis — see the module
    docstring); results are cached for `eval_every_s` so a router
    polling `health()` per routing decision never pays repeated window
    math. `pop_transitions()` drains the breach/recover edges since
    the last call — the engine turns them into TraceSink `slo_breach`
    events and counter bumps exactly once per transition.
    """

    def __init__(self, objectives: Optional[Dict[str, float]] = None,
                 *, fast_window_s: float = 5.0,
                 slow_window_s: float = 60.0,
                 warn_burn: float = 0.75, breach_burn: float = 1.0,
                 recover_burn: Optional[float] = None,
                 eval_every_s: float = 0.25, max_samples: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        objectives = dict(DEFAULT_OBJECTIVES if objectives is None
                          else objectives)
        for name, target in objectives.items():
            if name not in OBJECTIVE_KINDS:
                raise ValueError(
                    f"unknown SLO objective {name!r} — known: "
                    f"{sorted(OBJECTIVE_KINDS)}")
            if not (isinstance(target, (int, float)) and target > 0):
                raise ValueError(
                    f"objective {name!r} target must be a positive "
                    f"number, got {target!r}")
        self.objectives = objectives
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        if self.slow_window_s < self.fast_window_s:
            raise ValueError("slow_window_s must be >= fast_window_s")
        self.warn_burn = float(warn_burn)
        self.breach_burn = float(breach_burn)
        # hysteresis: once BREACH, stay until the fast burn drops to
        # recover_burn (default: the warn threshold) — a burn rate
        # oscillating around 1.0 must not flap breach events
        self.recover_burn = float(warn_burn if recover_burn is None
                                  else recover_burn)
        self._eval_every_s = float(eval_every_s)
        self._clock = clock
        self._lock = threading.Lock()
        # one bounded (t, value) ring per sample stream; pruned past
        # the slow window at evaluation time
        self._samples: Dict[str, deque] = {
            s: deque(maxlen=int(max_samples))
            for s in ("ttft_s", "itl_s", "queue_wait_s", "requests",
                      "tokens")}
        self._state: Dict[str, str] = {n: "OK" for n in objectives}
        self.breaches_total = 0
        self._transitions: List[Dict[str, Any]] = []
        self._cached: Optional[Dict[str, Any]] = None
        self._cached_at: Optional[float] = None

    # ---- recording (hot path: one bounded append under the lock) --------
    def _record(self, stream: str, value: float) -> None:
        with self._lock:
            self._samples[stream].append((self._clock(), float(value)))

    def record_ttft(self, seconds: float) -> None:
        """One request's time-to-first-token (seconds)."""
        self._record("ttft_s", seconds)

    def record_itl(self, seconds: float) -> None:
        """One inter-token gap (seconds — the itl_ms_p99 objective
        converts to ms at evaluation time)."""
        self._record("itl_s", seconds)

    def record_queue_wait(self, seconds: float) -> None:
        """One request's admission queue wait (seconds)."""
        self._record("queue_wait_s", seconds)

    def record_tokens(self, n: int) -> None:
        """Tokens generated by one dispatch (feeds the goodput floor)."""
        self._record("tokens", n)

    def record_request(self, error: bool) -> None:
        """One terminal request: error=True for FAILED / TIMED_OUT,
        False for FINISHED. Cancellations are not recorded — a client
        hanging up is not the server missing its objective."""
        self._record("requests", 1.0 if error else 0.0)

    # ---- evaluation ------------------------------------------------------
    def _window(self, stream: str,
                since: float) -> List[Tuple[float, float]]:
        return [(t, v) for t, v in self._samples[stream] if t >= since]

    def _value(self, name: str, window_s: float,
               now: float) -> Optional[float]:
        """One objective's observed value over the trailing `window_s`
        (None = no samples — evaluates as burn 0, verdict OK).

        The goodput floor measures rate over the window's ACTIVE span:
        tokens divided by (now - first in-window sample), not by the
        full window — a window straddling pre-traffic idle (engine
        warmup, a quiet period before a burst) must not dilute real
        throughput into a phantom burn. The span keeps growing while
        delivery stalls with samples still in the window (a genuine
        slowdown decays the rate), and an entirely idle window is None
        (no demand evidence — a floor cannot distinguish "no traffic"
        from "serving nothing"; pair it with the itl/ttft ceilings for
        stall detection)."""
        kind, stream = OBJECTIVE_KINDS[name]
        samples = self._window(stream, now - window_s)
        if not samples:
            return None
        vals = [v for _, v in samples]
        if name == "error_rate":
            return sum(vals) / len(vals)
        if name == "goodput_tok_s":
            span = max(now - samples[0][0], 1e-3)
            return sum(vals) / span
        p99 = _p99(vals)
        return p99 * 1000.0 if name == "itl_ms_p99" else p99

    def _burn(self, name: str, value: Optional[float]) -> float:
        if value is None:
            return 0.0
        target = self.objectives[name]
        kind, _ = OBJECTIVE_KINDS[name]
        if kind == "ceiling":
            return value / target
        # floor: burning means delivering LESS than promised
        return target / value if value > 0 else float("inf")

    def _verdict_locked(self, name: str, burn_fast: float,
                 burn_slow: float) -> str:
        prev = self._state[name]
        if burn_fast >= self.breach_burn:
            return "BREACH"
        if prev == "BREACH" and burn_fast > self.recover_burn:
            return "BREACH"            # hysteresis band: hold the alert
        if burn_fast >= self.warn_burn or burn_slow >= self.breach_burn:
            return "WARN"
        return "OK"

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.slow_window_s
        for ring in self._samples.values():
            while ring and ring[0][0] < horizon:
                ring.popleft()

    def evaluate(self, force: bool = False) -> Dict[str, Any]:
        """The tracker's verdict: per-objective fast/slow values, burn
        rates and OK/WARN/BREACH (worst-of under "verdict"), plus the
        lifetime breach counter. Cached for `eval_every_s` unless
        `force` — a router polling health() per routing decision pays
        one dict copy, not repeated window math."""
        with self._lock:
            now = self._clock()
            if (not force and self._cached is not None
                    and now - self._cached_at < self._eval_every_s):
                return self._cached
            self._prune_locked(now)
            objectives: Dict[str, Any] = {}
            for name, target in self.objectives.items():
                kind, _ = OBJECTIVE_KINDS[name]
                vf = self._value(name, self.fast_window_s, now)
                vs = self._value(name, self.slow_window_s, now)
                bf = self._burn(name, vf)
                bs = self._burn(name, vs)
                verdict = self._verdict_locked(name, bf, bs)
                prev = self._state[name]
                if verdict == "BREACH" and prev != "BREACH":
                    self.breaches_total += 1
                    self._transitions.append(
                        {"edge": "breach", "objective": name, "t": now,
                         "burn_rate_fast": round(bf, 4),
                         "value_fast": vf, "target": target})
                elif prev == "BREACH" and verdict != "BREACH":
                    self._transitions.append(
                        {"edge": "recovered", "objective": name,
                         "t": now, "burn_rate_fast": round(bf, 4),
                         "value_fast": vf, "target": target})
                self._state[name] = verdict
                objectives[name] = {
                    "target": target, "kind": kind, "verdict": verdict,
                    "value_fast": vf, "value_slow": vs,
                    "burn_rate_fast": round(bf, 4),
                    "burn_rate_slow": round(bs, 4),
                }
            self._cached = {
                "verdict": worst_verdict(
                    [o["verdict"] for o in objectives.values()]),
                "objectives": objectives,
                "breaches_total": self.breaches_total,
                "windows": {"fast_s": self.fast_window_s,
                            "slow_s": self.slow_window_s},
            }
            self._cached_at = now
            return self._cached

    def pop_transitions(self) -> List[Dict[str, Any]]:
        """Drain the breach/recover edges recorded since the last call
        — each edge is returned exactly once, so trace events and
        breach counters fire once per transition, not per poll."""
        with self._lock:
            out, self._transitions = self._transitions, []
            return out


def rollup(slo_dicts: Sequence[Optional[Dict[str, Any]]]
           ) -> Dict[str, Any]:
    """Fleet-wide aggregation of per-replica `SloTracker.evaluate()`
    dicts (the Router's view): worst-of verdict overall and per
    objective, max burn rates (the hottest replica defines the fleet's
    burn), summed lifetime breach counts. Replicas with SLO tracking
    off (None entries) are skipped; an empty fleet reports OK."""
    live = [d for d in slo_dicts if d]
    objectives: Dict[str, Any] = {}
    for d in live:
        for name, o in d.get("objectives", {}).items():
            cur = objectives.get(name)
            if cur is None:
                objectives[name] = dict(o)
                continue
            cur["verdict"] = worst_verdict([cur["verdict"],
                                            o["verdict"]])
            for k in ("burn_rate_fast", "burn_rate_slow"):
                cur[k] = max(cur[k], o[k])
    return {
        "verdict": worst_verdict(
            [d.get("verdict", "OK") for d in live]),
        "objectives": objectives,
        "breaches_total": sum(d.get("breaches_total", 0) for d in live),
        "replicas_reporting": len(live),
    }
