"""paddle_tpu_torch.serving.faults — deterministic fault injection for
the serving stack.

The port's own copy of paddle_tpu/serving/faults.py, rule for rule: a
`FaultInjector` plugs into the ContinuousBatcher's device-call boundary
(`ContinuousBatcher(fault_injector=...)` /
`ServingEngine(fault_injector=...)`) and decides, per device call,
whether to raise an `InjectedFault`, sleep (a hung step), or pass.
Every decision is deterministic given the rule set and the seed, so a
chaos run replays bit-identically — and the same rules armed on the JAX
package's injector make the same decisions.

The batcher calls `check(mode, rids)` once per REAL device-call tick
(mode "decode" | "fused" | "prefill" | "spec_draft" | "spec_verify",
rids = every request riding the call) and `check("probe", [rid],
probe=True)` for each quarantine re-execution probe. Probe calls do not
advance the step counter and only rid-scoped rules fire on them — so a
step-scoped fault injected once stays consumed during quarantine
(fail-once-then-heal finds no culprit and every suspect recovers), while
a rid-scoped fault reproduces under the probe and convicts exactly its
request.

Stdlib only: `nlp.paged` may hold an injector without pulling torch
state or the engine.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["FaultInjector", "InjectedFault"]


class InjectedFault(RuntimeError):
    """Raised by a FaultInjector rule at the device-call boundary.

    `transient` marks failures the engine's retry predicate should
    treat as retryable (the default predicate checks exactly this
    attribute, plus RESOURCE_EXHAUSTED-shaped messages); `kind` names
    the injected failure class ("error" | "oom")."""

    def __init__(self, message: str, *, transient: bool = False,
                 kind: str = "error"):
        super().__init__(message)
        self.transient = transient
        self.kind = kind


class _Rule:
    """One injection rule: match fields + action + remaining budget."""

    __slots__ = ("action", "step", "rid", "rate", "after_step", "times",
                 "seconds", "transient", "kind", "message", "fired")

    def __init__(self, action: str, *, step: Optional[int] = None,
                 rid: Optional[int] = None, rate: Optional[float] = None,
                 after_step: int = 0, times: Optional[int] = 1,
                 seconds: float = 0.0, transient: bool = False,
                 kind: str = "error", message: Optional[str] = None):
        self.action = action          # "fail" | "hang"
        self.step = step
        self.rid = rid
        self.rate = rate
        self.after_step = int(after_step)
        self.times = times            # None = unlimited
        self.seconds = float(seconds)
        self.transient = bool(transient)
        self.kind = kind
        self.message = message
        self.fired = 0

    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times

    def describe(self) -> str:
        tgt = (f"step {self.step}" if self.step is not None
               else f"rid {self.rid}" if self.rid is not None
               else f"rate {self.rate}")
        return f"{self.kind} on {tgt}"


class FaultInjector:
    """Seedable, deterministic chaos harness for the batcher's
    device-call boundary.

    Arm rules (each returns `self` for chaining), wire the injector
    into a batcher or engine, and every matching device call fails or
    hangs exactly as armed:

        inj = (FaultInjector(seed=0)
               .fail_on_step(3, transient=True)     # fail-once-then-heal
               .fail_on_rid(7))                      # poison request 7
        eng = ServingEngine(..., fault_injector=inj)

    Rules: `fail_on_step(n)` fails the n-th real device call (1-based);
    `fail_on_rid(rid)` fails every call carrying `rid` (probes
    included — the quarantine convicts it); `hang_on_step(n, seconds)`
    sleeps inside the call boundary (trips the engine watchdog);
    `exhaust_on_step(n)` raises a RESOURCE_EXHAUSTED-style transient
    (allocator-pressure shape); `fail_rate(p)` fails a seeded `p`
    fraction of real calls. `times` bounds how often a rule fires
    (None = unlimited, default 1 except `fail_on_rid`); `after_step`
    delays rid/rate rules until the step counter passes it (mid-stream
    poison). `heal()` disarms everything; `stats()` reports calls seen
    and injections delivered. Thread-safe: tests arm rules from
    consumer threads while the engine thread steps."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._rules: List[_Rule] = []
        self.calls = 0                 # real device-call ticks seen
        self.probes = 0
        self.attachments = 0           # batchers this injector armed
        self._on_attach = None
        self._injected: Dict[str, int] = {}

    # ---- respawn chaos hook ---------------------------------------------
    def on_attach(self, callback) -> "FaultInjector":
        """Register `callback(injector, attach_count, replica_id)` to
        run every time a batcher wires this injector in — once at
        first construction and AGAIN for every supervisor respawn (a
        respawned replica re-applies its per-replica overrides, so the
        same injector instance follows the slot; `replica_id` names
        the attaching batcher, so one injector shared across replicas
        can still tell incarnations apart). The hook is how a chaos
        test poisons EVERY incarnation of a replica (e.g. re-arm a
        hang on the respawned engine's first device calls to drive
        the crash-loop circuit breaker open) instead of only the
        first. Step counters persist across attachments."""
        with self._lock:
            self._on_attach = callback
        return self

    def attach(self, replica_id: str = "r0") -> None:
        """Called by `ContinuousBatcher` when the injector is wired
        into a (possibly respawned) batcher: bumps `attachments` and
        fires the `on_attach` hook outside the lock (the hook arms
        rules, which takes the lock itself)."""
        with self._lock:
            self.attachments += 1
            cb, n = self._on_attach, self.attachments
        if cb is not None:
            cb(self, n, str(replica_id))

    # ---- arming ---------------------------------------------------------
    def _arm(self, rule: _Rule) -> "FaultInjector":
        with self._lock:
            self._rules.append(rule)
        return self

    def fail_on_step(self, n: int, *, times: int = 1,
                     transient: bool = False,
                     message: Optional[str] = None) -> "FaultInjector":
        """Fail the n-th real device call (1-based), `times` times."""
        return self._arm(_Rule("fail", step=int(n), times=times,
                               transient=transient, message=message))

    def fail_on_rid(self, rid: int, *, times: Optional[int] = None,
                    after_step: int = 0, transient: bool = False,
                    message: Optional[str] = None) -> "FaultInjector":
        """Fail every device call (probes included) carrying `rid` —
        unlimited by default: the persistent poisoned-request shape the
        quarantine exists to isolate. `after_step` arms it only once
        the real step counter passes that tick (mid-stream poison)."""
        return self._arm(_Rule("fail", rid=int(rid), times=times,
                               after_step=after_step, transient=transient,
                               message=message))

    def hang_on_step(self, n: int, seconds: float, *,
                     times: int = 1) -> "FaultInjector":
        """Sleep `seconds` inside the n-th real device call boundary —
        the injected hung step the engine watchdog must catch."""
        return self._arm(_Rule("hang", step=int(n), seconds=seconds,
                               times=times, kind="hang"))

    def hang_on_rid(self, rid: int, seconds: float, *,
                    times: int = 1) -> "FaultInjector":
        """Sleep `seconds` inside the next `times` device calls
        carrying `rid` — a mid-stream hang targeted at one request
        (arm it from an on_token callback once the rid is known)."""
        return self._arm(_Rule("hang", rid=int(rid), seconds=seconds,
                               times=times, kind="hang"))

    def exhaust_on_step(self, n: int, *, times: int = 1
                        ) -> "FaultInjector":
        """RESOURCE_EXHAUSTED-style allocator pressure at the n-th real
        device call: transient by construction (pressure passes), so
        the engine's default retry predicate re-admits the victims."""
        return self._arm(_Rule(
            "fail", step=int(n), times=times, transient=True, kind="oom",
            message="RESOURCE_EXHAUSTED: injected allocator pressure"))

    def fail_rate(self, p: float, *, times: Optional[int] = None,
                  after_step: int = 0,
                  transient: bool = True) -> "FaultInjector":
        """Fail a seeded `p` fraction of real device calls — the
        background-noise chaos mode (deterministic per seed)."""
        return self._arm(_Rule("fail", rate=float(p), times=times,
                               after_step=after_step, transient=transient))

    def heal(self) -> "FaultInjector":
        """Disarm every rule (armed state clears; counters survive)."""
        with self._lock:
            self._rules.clear()
        return self

    # ---- the boundary ---------------------------------------------------
    def check(self, mode: str, rids: Sequence[int],
              probe: bool = False) -> None:
        """The batcher's device-call gate: evaluate every armed rule
        against this call; raise `InjectedFault` or sleep on a match.
        `probe=True` marks a quarantine re-execution probe — it never
        advances the step counter and only rid-scoped rules fire."""
        rid_set = set(int(r) for r in rids)
        with self._lock:
            if probe:
                self.probes += 1
            else:
                self.calls += 1
            n = self.calls
            hang_s = 0.0
            fail: Optional[_Rule] = None
            for rule in self._rules:
                if rule.exhausted():
                    continue
                if rule.action == "fail" and fail is not None:
                    # one failure per call: later fail rules keep their
                    # budget (and stats stay injections == faults
                    # delivered) instead of being silently consumed
                    continue
                if probe:
                    hit = rule.rid is not None and rule.rid in rid_set
                else:
                    if n <= rule.after_step:
                        continue
                    hit = ((rule.step is not None and rule.step == n)
                           or (rule.rid is not None and rule.rid in rid_set)
                           or (rule.rate is not None
                               and self._rng.random() < rule.rate))
                if not hit:
                    continue
                rule.fired += 1
                self._injected[rule.kind] = \
                    self._injected.get(rule.kind, 0) + 1
                if rule.action == "hang":
                    hang_s = max(hang_s, rule.seconds)
                elif fail is None:
                    fail = rule
        # sleep OUTSIDE the lock: a hung call must not also wedge every
        # concurrent arm()/stats() caller
        if hang_s > 0.0:
            time.sleep(hang_s)
        if fail is not None:
            msg = fail.message or (
                f"injected fault ({fail.describe()}) at {mode} call {n} "
                f"rids={sorted(rid_set)}")
            raise InjectedFault(msg, transient=fail.transient,
                                kind=fail.kind)

    def stats(self) -> Dict[str, Any]:
        """Calls seen and injections delivered, per fault kind."""
        with self._lock:
            return {"calls": self.calls, "probes": self.probes,
                    "attachments": self.attachments,
                    "injected": dict(self._injected),
                    "armed_rules": sum(1 for r in self._rules
                                       if not r.exhausted())}
