"""paddle_tpu_torch.serving.engine — thread-backed serving over the
paged-KV continuous batcher.

Port of paddle_tpu/serving/engine.py's serving core. One background
thread owns the batcher; everything else talks through locks/channels:

    submit()/generate()/stream()          consumer threads
        │  AdmissionQueue (priority + aging + backpressure,
        │                  cached-prefix preference)
        ▼
    engine thread loop:
        reap cancelled / expired (queued AND in-flight)
        admit while a batch slot AND the KV blocks fit   ── scheduler.py
        batcher.step()  — one device chunk              ── nlp/paged.py
        deliver tokens → request channels (+ on_token)   ── request.py
        update metrics / SLO / trace                     ── metrics.py

Robustness, as in the JAX engine. A request whose on_token callback
raises fails ONLY that request. A device-step failure dumps the flight
recorder (`last_flight_dump`, `last_flight_dump_json`,
`flight_dump_path`) and enters the quarantine: the flight recorder's
last record names the failing tick's mode and requests, each suspect is
re-executed alone (a decode slot through the warmed plain chunk, a
prefill record as a standalone (1, bucket) call), and only convicted
culprits fail. Innocents keep their KV (exported and re-imported in
place) or requeue at the front of the admission queue and resume from
`prompt + tokens`; victims of a failed `spec_*` tick re-admit with
speculation off. A culprit whose failure looks transient
(`retry_transient`: an `InjectedFault(transient=True)` or a
`torch.cuda.OutOfMemoryError` by default) gets `max_retries` backoff
re-admissions. Eight consecutive failed steps blow a fuse that marks the
engine broken. The watchdog (`watchdog_s`, with `watchdog_compile_grace`
until `warmup()` has run) fails the requests stranded by a hung device
call and flips `health()` to UNHEALTHY. `serving.faults.FaultInjector`
drives every one of these paths deterministically.

A CUDA error that poisons the context (an illegal address) makes every
later probe and step raise too: the fuse then marks the engine broken,
and only a new process recovers the card.

Roles: a "prefill" engine finishes each request at its first committed
token and hands its KV over as a snapshot on `req.kv_snapshot` (reason
"prefill_complete"); `submit_import()` adopts one, `drain_export()`
hands the in-flight set's KV out before a supervisor's teardown.
shutdown(drain=True) stops admissions, drains in-flight work, then
joins the thread.

The batcher's device work runs on the engine thread; the kernel
wrappers launch, and the step graphs replay, on that thread's current
CUDA stream. `warmup()` (or `warmup=True`) captures every reachable
step shape before `start()`, so no request pays a capture; without it
each shape is captured the first time it is met.

The JAX engine's defaults: prefix caching (`prefix_cache=True`), the
per-request TraceSink (`trace=True`) with the flight recorder, the SLO
tracker (`slo=True`, `slo_objectives`, `slo_opts`) and the sampled step
profiler (`profile_sample_every`, `capture_profile()`);
`to_prometheus()` on `metrics` renders the snapshot; `health()`,
`load()`, `is_idle` and `recent_prompts()` are the per-replica view.

Quantized serving (`weight_dtype`, `kv_dtype`) and self-speculative
decoding (`speculative`, `spec_k`, `draft_layers`, `spec_tree`,
`spec_draft_w8`) pass through to the batcher; `snapshot()` carries
their resolved config and accounting, and the `spec_*` gauges and the
`spec_accept_depth` histogram track acceptance.

Not ported yet, so accepted only at its off value (anything else
raises NotImplementedError naming the later slice): the tensor-parallel
mesh. `spec_attention_impl` is taken only as None: the port has no
backend switch, the device decides.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from .kvtransfer import KVSnapshot, check_compatible
from .metrics import LATENCY_BUCKETS, MetricsRegistry
from .request import GenerationRequest, RequestState
from .scheduler import AdmissionQueue, QueueFullError
from .slo import SloTracker
from .trace import TraceSink

__all__ = ["ServingEngine", "EngineStopped", "HungStepError"]

# kwarg: (its off value, the later slice that ports it)
_UNPORTED = {
    "mesh": (None, "multi-GPU serving"),
}

# recently completed request shapes kept for recent_prompts()
_RECENT_PROMPTS = 8
# livelock fuse: this many consecutive failed steps fail everything in
# flight and mark the engine broken
_MAX_FAULT_STREAK = 8


class EngineStopped(RuntimeError):
    """submit() after shutdown began."""


class HungStepError(RuntimeError):
    """A device step exceeded the watchdog deadline: the engine thread
    is presumed wedged inside a device call that will never return.
    Attached as the terminal error to every stranded request and kept
    on `last_flight_dump` — `health()` reports UNHEALTHY from the
    moment the watchdog trips."""


def _default_transient(error: BaseException) -> bool:
    """The default retry predicate: injected faults flagged transient
    (`serving.faults.InjectedFault(transient=True)`) and the card's
    out-of-memory error (`torch.cuda.OutOfMemoryError`, the port's
    counterpart of XLA's RESOURCE_EXHAUSTED: allocator pressure passes,
    a retry after backoff usually lands) are worth re-admitting;
    everything else is treated as deterministic and fails fast."""
    import torch
    return bool(getattr(error, "transient", False)) \
        or isinstance(error, torch.cuda.OutOfMemoryError)


class ServingEngine:
    """Async request-serving engine over a ContinuousBatcher.

    Usage:
        eng = ServingEngine(params, cfg, max_batch=4, block_size=16,
                            max_total_len=512, max_new_tokens=64)
        out = eng.generate(prompt_ids)                  # blocking
        for tok in eng.stream(prompt_ids): ...          # incremental
        req = eng.submit(prompt_ids, priority=1, timeout_s=30)
        ...; req.cancel(); eng.shutdown()

    Runs on the card (`device="cuda"`) unless the caller passes
    `device="cpu"`, where the kernels' plain versions run; `params` must
    live on that device (`nlp.llama.params_from_numpy` / `init_params`).
    `start=False` builds the engine with the loop parked — requests queue
    up until `start()`; `warmup()` between the two captures every step
    shape. Replicas built from one `params` tree share its tensors
    (`Router` hands the same tree to every engine). The batcher's step graphs close over the batcher, so a dropped
    engine's device memory (weights, pool, graph pool) is freed when the
    cycle collector runs: `gc.collect()` after `shutdown()` and `del`
    frees it at once.
    """

    def __init__(self, params, cfg, *, max_batch: int = 4,
                 block_size: int = 16, max_total_len: int = 256,
                 max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 num_blocks: Optional[int] = None, chunk: int = 8,
                 max_queue_depth: int = 64,
                 aging_interval_s: float = 2.0,
                 metrics: Optional[MetricsRegistry] = None,
                 start: bool = True, idle_poll_s: float = 0.05,
                 prefix_cache: bool = True,
                 prefill_buckets=None, max_prefill_bucket: int = 512,
                 fused_prefill: bool = True, fused_units: int = 1,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 speculative: bool = False, spec_k: int = 4,
                 draft_layers: Optional[int] = None, spec_tree=None,
                 spec_draft_w8: bool = False,
                 spec_attention_impl: Optional[str] = None,
                 warmup: bool = False,
                 trace: bool = True, flight_recorder_cap: int = 64,
                 flight_dump_path: Optional[str] = None,
                 quarantine: bool = True, max_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 retry_transient=None,
                 watchdog_s: Optional[float] = None,
                 watchdog_compile_grace: float = 16.0,
                 health_window_s: float = 30.0,
                 fault_injector=None,
                 slo: bool = True,
                 slo_objectives: Optional[Dict[str, float]] = None,
                 slo_opts: Optional[Dict] = None,
                 profile_sample_every: int = 64,
                 replica_id: str = "r0", role: str = "both",
                 device="cuda", clock=time.monotonic, **unported):
        if spec_attention_impl is not None:
            raise NotImplementedError(
                f"spec_attention_impl={spec_attention_impl!r}: the port has "
                f"no backend switch (the device decides: the kernels on "
                f"CUDA, their plain versions on the CPU); pass None")
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(
                    f"ServingEngine() got an unexpected keyword argument "
                    f"{name!r}")
            off, later = _UNPORTED[name]
            if value != off:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet ({later} is a "
                    f"later slice of the PyTorch port); pass {off!r}")
        self.replica_id = str(replica_id)
        # disaggregated serving: a "prefill" engine finishes every
        # request at its first committed token and surrenders its KV as
        # a snapshot on `req.kv_snapshot` (reason "prefill_complete") for
        # a decode replica to adopt via submit_import(); a "decode" engine
        # serves normally but is the adoption target a disaggregated
        # Router migrates to; "both" is the monolithic behavior. Every
        # role accepts plain submits (probes, standalone use)
        role = str(role)
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'both', "
                f"got {role!r}")
        self.role = role
        if role == "prefill":
            # the surrender happens at the first committed token: a spec
            # draft/verify sweep would never complete before it
            speculative = False
        # per-request timelines + the batcher's flight recorder; max_live
        # covers every request the engine can hold open at once (queued +
        # in flight), so the sink's bound never displaces a running one
        self.trace: Optional[TraceSink] = TraceSink(
            max_live=max_queue_depth + max_batch + 16) if trace else None
        self._flight_dump_path = flight_dump_path
        self.last_flight_dump: Optional[Dict] = None
        self.last_flight_dump_json: Optional[str] = None
        from ..nlp.paged import ContinuousBatcher
        self.batcher = ContinuousBatcher(
            params, cfg, max_batch=max_batch, block_size=block_size,
            max_total_len=max_total_len, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, num_blocks=num_blocks, chunk=chunk,
            prefix_cache=prefix_cache, prefill_buckets=prefill_buckets,
            max_prefill_bucket=max_prefill_bucket,
            fused_prefill=fused_prefill, fused_units=fused_units,
            weight_dtype=weight_dtype, kv_dtype=kv_dtype,
            speculative=speculative, spec_k=spec_k,
            draft_layers=draft_layers, spec_tree=spec_tree,
            spec_draft_w8=spec_draft_w8, trace=self.trace,
            flight_recorder_cap=flight_recorder_cap,
            profile_sample_every=profile_sample_every,
            fault_injector=fault_injector,
            replica_id=self.replica_id, device=device)
        self.attention_impl = self.batcher.attention_impl
        self.weight_dtype = self.batcher.weight_dtype
        self.kv_dtype = self.batcher.kv_dtype
        self.speculative = self.batcher.speculative
        self.metrics = metrics or MetricsRegistry()
        self._clock = clock
        self._idle_poll_s = idle_poll_s
        self.queue = AdmissionQueue(max_depth=max_queue_depth,
                                    aging_interval_s=aging_interval_s,
                                    clock=clock)
        self._running: Dict[int, GenerationRequest] = {}
        self._admit_seq = 0
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._accepting = True
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._alloc_stats = self.batcher.alloc.stats()
        self._prefix_stats = self.batcher.prefix_stats()
        self._recent_prompts: List[Tuple[List[int], int]] = []
        # fault tolerance: quarantine-by-probe on step failures,
        # transient-culprit retries with exponential backoff, the
        # hung-step watchdog and the health surface a router polls
        self._quarantine_on = bool(quarantine)
        self._max_retries = int(max_retries)
        self._retry_backoff_s = float(retry_backoff_s)
        self._retry_transient = retry_transient or _default_transient
        self._watchdog_s = watchdog_s
        # compile-vs-hang: until warmup() has run, a step may pay a lazy
        # CUDA-graph capture (~0.5 s a shape at 32 layers), so every
        # deadline is multiplied by this grace; a warmed engine gets none
        self._wd_grace = max(1.0, float(watchdog_compile_grace))
        self._health_window_s = float(health_window_s)
        self._parked: List[List] = []       # [ready_time, request]
        # pending KV-snapshot adoptions, (snapshot, request) in arrival
        # order — activated ahead of fresh admissions
        self._imports: List = []
        # drain-and-export rendezvous (supervisor teardown): the caller's
        # box the engine thread fills with (snapshot, request) pairs
        self._drain_export_box: Optional[List] = None
        self._wedged = False
        self._warmed = False                # warmup() ran
        # livelock fuse tripped: the engine declared itself UNHEALTHY
        # (reason string) and stopped serving
        self._broken: Optional[str] = None
        self._last_fault_t: Optional[float] = None
        self._fault_streak = 0              # consecutive failed steps
        self._flight_seq = self.batcher.flight.seq
        self._step_t0: Optional[float] = None   # the watchdog reads this
        self._wd_thread: Optional[threading.Thread] = None
        self._wd_stop = threading.Event()
        self._last_dump_error: Optional[str] = None

        m = self.metrics
        self._c_submitted = m.counter("requests_submitted")
        self._c_admitted = m.counter("requests_admitted")
        self._c_rejected = m.counter("requests_rejected")
        self._c_completed = m.counter("requests_completed")
        self._c_cancelled = m.counter("requests_cancelled")
        self._c_timed_out = m.counter("requests_timed_out")
        self._c_failed = m.counter("requests_failed")
        self._c_tokens = m.counter("tokens_generated")
        self._g_queue = m.gauge("queue_depth")
        self._g_running = m.gauge("requests_in_flight")
        self._g_blocks = m.gauge("kv_blocks_in_use")
        self._g_util = m.gauge("kv_block_utilization")
        # the request-latency histograms carry a cumulative bucket ladder
        # so to_prometheus() exports native histogram families
        self._h_ttft = m.histogram("ttft_s", buckets=LATENCY_BUCKETS)
        self._h_wait = m.histogram("queue_wait_s", buckets=LATENCY_BUCKETS)
        self._h_token = m.histogram("per_token_s")
        # inter-token latency per request: the gap between consecutive
        # step dispatches that delivered this request tokens — where
        # admission-during-decode stalls show up
        self._h_itl = m.histogram("itl_s", buckets=LATENCY_BUCKETS)
        self._last_emit: Dict[int, float] = {}    # rid -> last dispatch
        # prefix-cache surface (flat zeros when the cache is off)
        self._g_pc_hit_tokens = m.gauge("prefix_cache_hit_tokens")
        self._g_pc_hit_rate = m.gauge("prefix_cache_hit_rate")
        self._g_pc_evictions = m.gauge("prefix_cache_evictions")
        self._g_pc_cached = m.gauge("prefix_cache_cached_blocks")
        # captured step shapes: flat after warmup()
        self._g_prefill_compiles = m.gauge("prefill_compile_count")
        self._g_compiles = m.gauge("compile_count")
        self._g_prefill_pad = m.gauge("prefill_pad_tokens")
        self._g_fused_steps = m.gauge("fused_steps")
        self._g_fused_units = m.gauge("fused_unit_count")
        self._g_decode_stalls = m.gauge("decode_stall_steps")
        self._g_kv_cached_bytes = m.gauge("kv_cached_bytes")
        m.gauge("kv_pool_bytes").set(self.batcher.kv_pool_bytes())
        m.gauge("weight_bytes").set(self.batcher.weight_bytes())
        # speculative decoding: acceptance per verify sweep (zeros with
        # spec off), and the per-(sweep, slot) accepted path lengths
        self._g_spec_steps = m.gauge("spec_steps")
        self._g_spec_accept = m.gauge("spec_accept_rate")
        self._g_spec_tps = m.gauge("spec_tokens_per_step")
        self._g_spec_accepted = m.gauge("spec_accepted_tokens")
        self._h_spec_depth = m.histogram(
            "spec_accept_depth",
            buckets=[0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0])
        # fault-tolerance surface: the counters health() aggregates
        self._c_step_faults = m.counter("step_faults")
        self._c_quarantines = m.counter("quarantines")
        self._c_requeued = m.counter("requests_requeued")
        self._c_retried = m.counter("requests_retried")
        self._c_watchdog = m.counter("watchdog_trips")
        self._c_dump_errors = m.counter("flight_dump_errors")
        # KV-transfer surface: snapshots exported (prefill-role handoffs,
        # drain-and-export, failover attachment) and imported, plus
        # quarantine innocents restored slot-in-place
        self._c_kv_exports = m.counter("kv_exports")
        self._c_kv_imports = m.counter("kv_imports")
        self._c_restored = m.counter("requests_restored")
        self._c_handoffs = m.counter("prefill_handoffs")

        # SLO engine: declarative objectives over dual rolling windows,
        # fed from the observations the histograms record; a BREACH
        # never stops this engine
        self._slo: Optional[SloTracker] = None
        self._g_slo_burn: Dict[str, object] = {}
        self._c_slo_breaches = m.counter("slo_breaches")
        self._slo_breaches_seen = 0
        if slo:
            self._slo = SloTracker(slo_objectives, clock=clock,
                                   **(slo_opts or {}))
            for name in self._slo.objectives:
                self._g_slo_burn[name] = m.gauge(f"slo_burn_rate_{name}")

        if warmup:
            self.warmup()
        if start:
            self.start()

    # ---- public API ------------------------------------------------------
    def warmup(self) -> int:
        """Capture every step shape serving can reach (the prefill ladder
        x admission group sizes x cold/cached, the fused steps, the
        decode chunk, the speculative pair), so no request pays a
        capture. Only valid BEFORE start(): once the loop runs, the
        batcher belongs to the engine thread. Returns the number of
        shapes captured."""
        with self._work:
            if self._thread is not None:
                raise RuntimeError(
                    "warmup() must run before start() — the engine "
                    "thread owns the batcher once the loop is live")
            n = self.batcher.warmup_prefill()
            self._warmed = True
            self._update_gauges_locked()
            return n

    def start(self) -> "ServingEngine":
        with self._work:
            if self._stop:
                raise EngineStopped("engine already shut down")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="paddle-tpu-torch-serving",
                    daemon=True)
                self._thread.start()
            if self._watchdog_s is not None and self._wd_thread is None:
                self._wd_thread = threading.Thread(
                    target=self._watchdog_loop,
                    name="paddle-tpu-torch-watchdog", daemon=True)
                self._wd_thread.start()
        return self

    def submit(self, prompt, *, priority: int = 0,
               max_new_tokens: Optional[int] = None,
               stop_token_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               on_token=None) -> GenerationRequest:
        """Queue a request; returns immediately with its handle.
        Raises QueueFullError on backpressure, ValueError when the
        request can NEVER fit this engine's pool, EngineStopped after
        shutdown began."""
        if isinstance(prompt, GenerationRequest):
            req = prompt
            if (priority != 0 or max_new_tokens is not None
                    or stop_token_id is not None or timeout_s is not None
                    or on_token is not None):
                raise ValueError(
                    "pass decode kwargs either on the GenerationRequest "
                    "or to submit(), not both")
            if req.submit_time is not None or req.done:
                raise ValueError("GenerationRequest already submitted")
        else:
            req = GenerationRequest(prompt, priority=priority,
                                    max_new_tokens=max_new_tokens,
                                    stop_token_id=stop_token_id,
                                    timeout_s=timeout_s, on_token=on_token)
        b = self.batcher
        try:
            mn = b.validate(len(req.prompt), req.max_new_tokens)
        except ValueError:
            self._c_rejected.inc()
            raise
        if b.blocks_needed(len(req.prompt), mn) > b.alloc.num_blocks:
            self._c_rejected.inc()
            raise ValueError(
                f"request needs {b.blocks_needed(len(req.prompt), mn)} "
                f"KV blocks but the pool holds {b.alloc.num_blocks}")
        with self._work:
            if self._stop or not self._accepting:
                raise EngineStopped("engine is shutting down")
            try:
                self.queue.push(req, priority=req.priority)
            except QueueFullError:
                self._c_rejected.inc()
                raise
            now = self._clock()
            req.submit_time = now
            if req.timeout_s is not None:
                req.deadline = now + req.timeout_s
            req.max_new_tokens = mn      # resolved; admission reads it
            self._c_submitted.inc()
            self._g_queue.set(len(self.queue))
            if self.trace is not None:
                req.trace_id = self.trace.start()
                self.trace.emit(req.trace_id, "enqueued",
                                prompt_len=len(req.prompt),
                                priority=req.priority,
                                timeout_s=req.timeout_s)
            self._work.notify_all()
        return req

    def submit_import(self, snapshot: KVSnapshot,
                      req: Optional[GenerationRequest] = None
                      ) -> GenerationRequest:
        """Queue a portable KV snapshot for adoption: the engine thread
        activates it via `ContinuousBatcher.import_kv` — fresh blocks,
        the codes AND int8 scales written into the pool in place, prefix
        index registered — ahead of cold admissions, and decode resumes
        at `len(snapshot.tokens)` with ZERO prefill chunks.

        `req` is the handle to resume; its `tokens` must already hold
        exactly the snapshot's generated tokens. None builds a new
        handle whose `tokens` are pre-seeded — they appear in result(),
        only NEW tokens stream. Fail-fast like submit(): fingerprint
        mismatch, misaligned handle tokens and a chain the pool can
        NEVER hold raise ValueError here, and anything but a KVSnapshot
        TypeError. EngineStopped after shutdown began."""
        if not isinstance(snapshot, KVSnapshot):
            raise TypeError(f"submit_import takes a KVSnapshot, not "
                            f"{type(snapshot).__name__}")
        b = self.batcher
        problems = check_compatible(snapshot.fingerprint,
                                    b.kv_fingerprint())
        if problems:
            self._c_rejected.inc()
            raise ValueError("KV snapshot incompatible with this "
                             "engine: " + "; ".join(problems))
        if b.import_blocks_needed(snapshot) > b.alloc.num_blocks:
            self._c_rejected.inc()
            raise ValueError(
                f"snapshot needs {b.import_blocks_needed(snapshot)} KV "
                f"blocks but the pool holds {b.alloc.num_blocks}")
        gen = list(snapshot.tokens[snapshot.prompt_len:])
        if req is None:
            req = GenerationRequest(
                list(snapshot.tokens[:snapshot.prompt_len]),
                max_new_tokens=len(gen) + int(snapshot.budget),
                stop_token_id=(None if snapshot.stop_token_id < 0
                               else snapshot.stop_token_id))
            req.tokens = list(gen)
        elif len(req.tokens) != len(gen):
            self._c_rejected.inc()
            raise ValueError(
                f"handle carries {len(req.tokens)} streamed tokens but "
                f"the snapshot generated {len(gen)} — resume would "
                f"misalign the stream")
        with self._work:
            if self._stop or not self._accepting:
                raise EngineStopped("engine is shutting down")
            now = self._clock()
            if req.submit_time is None:
                req.submit_time = now
                if req.timeout_s is not None:
                    req.deadline = now + req.timeout_s
                self._c_submitted.inc()
            if self.trace is not None:
                if req.trace_id is None:
                    req.trace_id = self.trace.start()
                self.trace.emit(req.trace_id, "import_enqueued",
                                blocks=snapshot.n_blocks,
                                bytes=snapshot.nbytes,
                                resumed_tokens=len(gen),
                                src_replica=snapshot.src_replica)
            self._imports.append((snapshot, req))
            self._work.notify_all()
        return req

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kw) -> List[int]:
        """Blocking one-shot: submit + wait for the full output. On wait
        timeout the request is cancelled before TimeoutError
        propagates."""
        req = self.submit(prompt, **kw)
        try:
            return req.result(timeout)
        except TimeoutError:
            self.cancel(req)
            raise

    def stream(self, prompt, **kw) -> Iterator[int]:
        """Incremental one-shot: yields tokens as they are generated."""
        return self.submit(prompt, **kw).stream()

    def cancel(self, req: GenerationRequest) -> None:
        req.cancel()
        with self._work:
            self._work.notify_all()

    @property
    def is_idle(self) -> bool:
        """Nothing queued, parked, pending import or in flight."""
        with self._lock:
            return (not self._running and not len(self.queue)
                    and not self._parked and not self._imports)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until queue + parked retries + pending imports +
        in-flight are empty; False on timeout. Returns promptly after a
        watchdog trip (the stranded set is already failed)."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._work:
            while (self._running or len(self.queue) or self._parked
                   or self._imports):
                rem = self._idle_poll_s if deadline is None else \
                    min(self._idle_poll_s, deadline - self._clock())
                if rem <= 0:
                    return False
                self._work.wait(rem)
        return True

    def drain_export(self, timeout: float = 2.0) -> List:
        """Stop admissions and hand every in-flight request's KV out as
        (snapshot, request) pairs — the supervisor's pre-teardown move,
        so a respawned replica resumes them via submit_import() without
        re-prefill. The engine thread runs the export (it owns the
        batcher); this caller blocks until it does or `timeout` passes.

        Returned pairs keep their handles OPEN — the caller MUST either
        re-import them or fail them. Requests with nothing exportable and
        everything queued/parked fail here with reason
        "drained_for_restart", which the Router's failover re-places.
        Returns [] when the loop is not running / wedged / broken."""
        box: List = []
        with self._work:
            if (self._thread is None or self._wedged
                    or self._broken is not None or self._stop):
                return []
            self._accepting = False
            self._drain_export_box = box
            self._work.notify_all()
            deadline = self._clock() + timeout
            # the engine thread performs the whole drain under ONE lock
            # hold, so the box is either untouched or complete — on
            # timeout withdraw the order; the caller proceeds cold
            while self._drain_export_box is not None:
                rem = deadline - self._clock()
                if rem <= 0:
                    self._drain_export_box = None
                    return []
                self._work.wait(min(self._idle_poll_s, rem))
        return box

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """Stop the engine. drain=True completes queued and in-flight
        work first; drain=False cancels everything pending. Returns True
        for a clean stop; False when the drain or the thread join timed
        out (pending requests are then cancelled by the engine thread as
        it exits)."""
        clean = True
        deadline = None if timeout is None else self._clock() + timeout
        with self._work:
            self._accepting = False
            self._work.notify_all()
        if drain and self._thread is not None:
            clean = self.drain(timeout)
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._wd_stop.set()
        if self._wd_thread is not None:
            self._wd_thread.join(1.0)
        if self._thread is not None:
            budget = (None if deadline is None
                      else max(0.0, deadline - self._clock()))
            if self._wedged:
                # the engine thread is presumed wedged inside a device
                # call; every handle was already failed by the watchdog,
                # so a bounded join leaves the daemon thread behind
                budget = 1.0 if budget is None else min(budget, 1.0)
            self._thread.join(budget)
            if self._thread.is_alive():
                return False
        else:
            with self._work:
                self._cancel_pending_locked()
        return clean

    def _cancel_pending_locked(self) -> None:
        """Cancel everything queued + parked + pending imports + in
        flight (lock held)."""
        for _, req in self._parked:
            self._finish_locked(req, RequestState.CANCELLED,
                                "engine_shutdown")
        self._parked.clear()
        for _snap, req in self._imports:
            self._finish_locked(req, RequestState.CANCELLED,
                                "engine_shutdown")
        self._imports.clear()
        for req in self.queue.clear():
            self._finish_locked(req, RequestState.CANCELLED,
                                "engine_shutdown")
        for rid, req in list(self._running.items()):
            self.batcher.abort(rid)
            self.batcher.release(rid)
            self._finish_locked(req, RequestState.CANCELLED,
                                "engine_shutdown")
        self._running.clear()
        self._update_gauges_locked()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def snapshot(self) -> Dict:
        """Metrics snapshot with pool stats folded in (plain dict). Reads
        the engine thread's cached allocator view — never the live
        allocator, which only the engine thread may touch."""
        with self._lock:
            snap = self.metrics.snapshot()
            snap["replica_id"] = self.replica_id
            snap["allocator"] = dict(self._alloc_stats)
            snap["prefix_cache"] = dict(self._prefix_stats)
            snap["attention_impl"] = self.attention_impl
            snap["device"] = str(self.batcher.device)
            b = self.batcher
            snap["quantization"] = {
                "weight_dtype": self.weight_dtype,
                "kv_dtype": self.kv_dtype,
                "weight_bytes": b.weight_bytes(),
                "kv_pool_bytes": b.kv_pool_bytes(),
                "kv_block_bytes": b.kv_block_bytes(),
                "kv_bytes_per_token": b.kv_bytes_per_token(),
            }
            snap["speculative"] = b.spec_stats()
            snap["last_flight_dump_error"] = self._last_dump_error
            snap["health"] = self._health_locked()
        return snap

    def load(self) -> Dict:
        """Cheap per-replica routing view: admission-queue depth,
        in-flight count, KV block-pool occupancy (the engine thread's
        cached allocator stats) and whether submit() would accept."""
        with self._lock:
            stats = self._alloc_stats
            return {
                "replica_id": self.replica_id,
                "role": self.role,
                "queue_depth": len(self.queue),
                "in_flight": len(self._running),
                "parked_retries": len(self._parked),
                "pending_imports": len(self._imports),
                "kv_utilization": (stats["blocks_in_use"]
                                   / stats["capacity_blocks"]),
                "accepting": self._accepting and not self._stop
                and not self._wedged and self._broken is None,
            }

    def recent_prompts(self) -> List[Tuple[List[int], int]]:
        """Recently COMPLETED request shapes, oldest first: (prompt
        tokens, resolved max_new budget) per entry, bounded ring."""
        with self._lock:
            return [(list(p), mn) for p, mn in self._recent_prompts]

    def health(self) -> Dict:
        """Per-replica health, the signal a router polls: `status` is
        "HEALTHY" (no recent faults), "DEGRADED" (a step fault or
        quarantine inside the last `health_window_s` — the engine
        recovered and keeps serving) or "UNHEALTHY" (the watchdog
        tripped or the fault fuse blew: the engine no longer serves).
        `ready` reads whether warmup() has run and the loop is live. The
        counters cover the engine's lifetime."""
        with self._lock:
            return self._health_locked()

    def _health_locked(self) -> Dict:
        now = self._clock()
        if self._wedged or self._broken is not None:
            status = "UNHEALTHY"
        elif (self._last_fault_t is not None
              and now - self._last_fault_t <= self._health_window_s):
            status = "DEGRADED"
        else:
            status = "HEALTHY"
        return {
            "status": status,
            "replica_id": self.replica_id,
            "role": self.role,
            "mesh": None,
            "attention_impl": self.attention_impl,
            "spec_backend": self.attention_impl if self.speculative
            else None,
            "ready": (self._warmed and self._thread is not None
                      and not self._wedged and self._broken is None
                      and not self._stop),
            "broken": self._broken,
            "step_faults": self._c_step_faults.value,
            "quarantines": self._c_quarantines.value,
            "requests_requeued": self._c_requeued.value,
            "requests_restored": self._c_restored.value,
            "requests_retried": self._c_retried.value,
            "requests_failed": self._c_failed.value,
            "watchdog_trips": self._c_watchdog.value,
            "flight_dump_errors": self._c_dump_errors.value,
            "last_fault_age_s": (None if self._last_fault_t is None
                                 else now - self._last_fault_t),
            "parked_retries": len(self._parked),
            "slo": self._slo_eval(),
        }

    def _slo_eval(self) -> Optional[Dict]:
        """Evaluate the SLO tracker (cached per its eval_every_s), sync
        the burn-rate gauges and breach counter, and emit one slo_breach
        / slo_recovered trace span per verdict transition. Called with
        self._lock held."""
        if self._slo is None:
            return None
        report = self._slo.evaluate()
        for name, o in report["objectives"].items():
            self._g_slo_burn[name].set(o["burn_rate_fast"])
        new = report["breaches_total"] - self._slo_breaches_seen
        if new > 0:
            self._c_slo_breaches.inc(new)
            self._slo_breaches_seen = report["breaches_total"]
        for tr in self._slo.pop_transitions():
            if self.trace is not None:
                self.trace.span(
                    "slo_breach" if tr["edge"] == "breach"
                    else "slo_recovered", dur=0.0,
                    objective=tr["objective"],
                    burn_rate_fast=tr["burn_rate_fast"],
                    target=tr["target"], value_fast=tr["value_fast"],
                    window_s=self._slo.fast_window_s,
                    replica_id=self.replica_id)
        return report

    def capture_profile(self, steps: int = 8,
                        timeout: Optional[float] = 30.0) -> Dict:
        """On-demand device-time capture window: fence the next `steps`
        batcher ticks (every device call, not just sampled ones), block
        until the window closes (bounded by `timeout` — an idle engine
        produces no ticks, so the report then says
        ``capture.complete`` False), and return the profiler's report.
        Callable from any thread."""
        prof = self.batcher.profiler
        prof.arm_capture(steps)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while prof.capture_active():
            if deadline is not None and time.monotonic() > deadline:
                # a leftover window would fence every future tick
                prof.cancel_capture()
                break
            time.sleep(0.005)
        return prof.report()

    def dump_flight_recorder(self, path: Optional[str] = None) -> Dict:
        """On-demand forensic dump: the batcher's last-N step records
        plus allocator and queue state, as one JSON-safe dict — written
        to `path` when given. The same dump fires on a step failure
        (`last_flight_dump` / `last_flight_dump_json`). Callable from any
        thread; the pool/queue numbers are best-effort point-in-time
        reads."""
        dump = self._flight_dump()
        if path is not None:
            with open(path, "w") as f:
                json.dump(dump, f, indent=2)
        return dump

    def _flight_dump(self, error: Optional[BaseException] = None) -> Dict:
        b = self.batcher
        with self._lock:
            records = b.flight.records()
            return {
                "error": None if error is None else repr(error),
                "failing_record": records[-1] if records else None,
                "records": records,
                "allocator": dict(b.alloc.stats()),
                "queue_depth": len(self.queue),
                "running_rids": sorted(self._running),
                "pending_rids": [e[0].rid for e in b._pending],
                "active_slots": sum(b.active),
                "free_slots": b.free_slots(),
                "attention_impl": self.attention_impl,
                "replica_id": self.replica_id,
            }

    def _record_failure_dump(self, error: BaseException) -> None:
        """Step-failure boundary: snapshot the flight recorder + pool/
        queue state BEFORE the in-flight set is torn down, keep it on
        `last_flight_dump`/`last_flight_dump_json`, and best-effort write
        it to `flight_dump_path` (a failed write is counted and shown,
        never masks the step error)."""
        dump = self._flight_dump(error)
        self.last_flight_dump = dump
        self.last_flight_dump_json = json.dumps(dump)
        if self._flight_dump_path is not None:
            try:
                with open(self._flight_dump_path, "w") as f:
                    f.write(self.last_flight_dump_json)
            except OSError as we:
                self._c_dump_errors.inc()
                with self._lock:
                    self._last_dump_error = repr(we)

    # ---- engine thread ---------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._work:
                if self._wedged:
                    return    # the watchdog tore everything down already
                if self._broken is not None:
                    return    # the fault fuse declared the engine dead
                if self._stop:
                    # exit path owns the batcher: cancel whatever is
                    # left so no consumer stays blocked on its channel
                    self._cancel_pending_locked()
                    return
                if self._drain_export_box is not None:
                    # supervisor teardown: hand the in-flight set's KV
                    # out before anything else reshapes it
                    self._drain_export_locked()
                self._reap_queued_locked()
                self._reap_running_locked()
                self._release_parked_locked()
                self._process_imports_locked()
                self._admit_locked()
                self._update_gauges_locked()
                if (not self._running and not len(self.queue)
                        and not self._imports):
                    if self._parked:
                        # a backoff retry is the only pending work:
                        # sleep just until the earliest one is ready
                        delay = min(e[0] for e in self._parked) \
                            - self._clock()
                        if delay > 0:
                            self._work.wait(min(self._idle_poll_s, delay))
                        continue
                    if not self._accepting:
                        return            # graceful drain complete
                    self._work.notify_all()      # wake drain() waiters
                    self._work.wait()
                    continue
            # the device step runs OUTSIDE the lock: the batcher is only
            # touched from this thread, so submit()/cancel() stay
            # responsive during device work
            timer = self.metrics.timer("serving.step_s")
            self._step_t0 = self._clock()    # the watchdog arms on this
            try:
                with timer:
                    emitted, finished = self.batcher.step()
            except Exception as e:        # device-step boundary
                self._step_t0 = None
                if self._wedged:
                    continue  # the watchdog already failed the stranded set
                # forensics FIRST: the dump captures the queue/pool state
                # at failure, before recovery reshuffles the in-flight set
                self._record_failure_dump(e)
                self._fault_streak += 1
                ticked = self.batcher.flight.seq != self._flight_seq
                if (self._quarantine_on and ticked
                        and self._fault_streak <= _MAX_FAULT_STREAK):
                    self._quarantine(e)
                else:
                    # no tick recorded (an admission-time failure: no basis
                    # to convict) or the fuse blew: fail everything
                    self._fail_all_running(e)
                    if self._fault_streak > _MAX_FAULT_STREAK:
                        self._mark_broken("fault_streak", e)
                self._flight_seq = self.batcher.flight.seq
                continue
            self._step_t0 = None
            self._fault_streak = 0
            self._flight_seq = self.batcher.flight.seq
            if self._wedged:
                continue      # stranded set already failed; don't dispatch
            self._dispatch(emitted, finished, step_dt=timer.elapsed)

    def _reap_queued_locked(self) -> None:
        now = self._clock()
        for req in self.queue.reap(
                lambda r: r.cancel_requested or self._expired(r, now)):
            state = (RequestState.CANCELLED if req.cancel_requested
                     else RequestState.TIMED_OUT)
            self._finish_locked(req, state, "reaped_in_queue")
        # parked backoff retries honor cancellation/deadlines too
        dead = [e for e in self._parked
                if e[1].cancel_requested or self._expired(e[1], now)]
        if dead:
            self._parked = [e for e in self._parked if e not in dead]
            for _, req in dead:
                state = (RequestState.CANCELLED if req.cancel_requested
                         else RequestState.TIMED_OUT)
                self._finish_locked(req, state, "reaped_parked")

    def _reap_running_locked(self) -> None:
        now = self._clock()
        for rid, req in list(self._running.items()):
            if req.cancel_requested or self._expired(req, now):
                self.batcher.abort(rid)
                self.batcher.release(rid)
                del self._running[rid]
                state = (RequestState.CANCELLED if req.cancel_requested
                         else RequestState.TIMED_OUT)
                self._finish_locked(req, state, "reaped_in_flight")

    def _expired(self, req: GenerationRequest, now: float) -> bool:
        return req.deadline is not None and now > req.deadline

    @staticmethod
    def _effective(req: GenerationRequest) -> List[int]:
        """The prompt a (re-)admission actually prefills: the original
        prompt plus every token already streamed — a requeued victim
        resumes decode from where the failed step stopped."""
        return req.prompt + req.tokens if req.tokens else req.prompt

    def _admit_locked(self) -> None:
        b = self.batcher
        free_slots = b.free_slots()
        if free_slots <= 0:
            return
        # cache-aware ordering: at EQUAL effective priority, prefer the
        # request whose prefix is cached right now — serving it before
        # eviction recycles those blocks turns reclaimable KV into
        # skipped prefill (a trie walk, memoized per admission round)
        prefer = None
        if b.prefix_stats().get("enabled") is True:
            warm = {}

            def prefer(r):
                if id(r) not in warm:
                    warm[id(r)] = b.prefix_cached_tokens(
                        self._effective(r)) > 0
                return warm[id(r)]
        budget = {"blocks": b.alloc.free_blocks}

        def fits(r):   # max_new_tokens was resolved by submit()
            # cached-aware: a prompt whose prefix an in-flight request
            # already pins needs fewer blocks of its own. pop_many calls
            # fits once per ACCEPTED item, so the budget is debited here
            eff = self._effective(r)
            n = b.blocks_needed(len(eff), r.max_new_tokens - len(r.tokens),
                                tokens=eff)
            if n > budget["blocks"]:
                return False
            budget["blocks"] -= n
            return True

        # one lock acquisition and one consistent priority view for the
        # whole admission round; the burst lands in the batcher's queue
        # together, so same-bucket requests prefill in one call
        now = self._clock()
        for req in self.queue.pop_many(free_slots, fits=fits,
                                       prefer=prefer):
            if req.cancel_requested or self._expired(req, now):
                state = (RequestState.CANCELLED if req.cancel_requested
                         else RequestState.TIMED_OUT)
                self._finish_locked(req, state, "reaped_at_admission")
                continue
            # resume-aware: a quarantine/retry re-admission carries the
            # tokens already streamed as part of its prompt (warm through
            # the prefix cache) with the remaining budget; a request that
            # rode a failed spec tick re-admits with speculation off
            resumed = bool(req.tokens) or req.admit_time is not None
            rid = b.submit(self._effective(req),
                           stop_token_id=req.stop_token_id,
                           max_new_tokens=req.max_new_tokens
                           - len(req.tokens),
                           speculative=False if req.spec_opt_out else None)
            req.request_id = rid
            req.state = RequestState.PREFILL
            if self.trace is not None and req.trace_id is not None:
                # batcher-side emissions (prepared / prefill_chunk /
                # retired) resolve to this request's timeline via rid
                self.trace.alias(rid, req.trace_id)
                self.trace.emit(req.trace_id, "admitted", rid=rid,
                                resumed=resumed,
                                queue_wait_s=now - req.submit_time)
            if not resumed:
                # first admission only: queue wait measures the original
                # arrival, not recovery churn
                req.admit_time = now
                req.admitted_index = self._admit_seq
                self._admit_seq += 1
                self._h_wait.observe(now - req.submit_time)
                if self._slo is not None:
                    self._slo.record_queue_wait(now - req.submit_time)
                self._c_admitted.inc()
            self._running[rid] = req

    def _process_imports_locked(self) -> None:
        """Activate pending KV-snapshot adoptions (engine thread, lock
        held) BEFORE fresh admissions: an import resumes a request that
        already streamed tokens. Head-of-line in arrival order: when the
        head does not fit (slot/blocks) the whole line waits."""
        b = self.batcher
        now = self._clock()
        while self._imports:
            snap, req = self._imports[0]
            if req.cancel_requested or self._expired(req, now):
                self._imports.pop(0)
                state = (RequestState.CANCELLED if req.cancel_requested
                         else RequestState.TIMED_OUT)
                self._finish_locked(req, state, "reaped_pending_import")
                continue
            if (b.free_slots() <= 0
                    or b.import_blocks_needed(snap) > b.alloc.free_blocks):
                break
            self._imports.pop(0)
            on_rid = None
            if self.trace is not None and req.trace_id is not None:
                tid = req.trace_id
                # alias the rid the instant import_kv assigns it, so the
                # batcher's own "imported" emit lands on this timeline
                on_rid = lambda r: self.trace.alias(r, tid)  # noqa: E731
            try:
                rid = b.import_kv(snap, on_rid=on_rid)
            except Exception as e:    # per-request boundary
                self._finish_locked(req, RequestState.FAILED,
                                    "kv_import_failed", error=e)
                continue
            req.request_id = rid
            req.state = RequestState.DECODING
            if req.admit_time is None:
                req.admit_time = now
                req.admitted_index = self._admit_seq
                self._admit_seq += 1
                self._c_admitted.inc()
            self._c_kv_imports.inc()
            self._running[rid] = req

    def _drain_export_locked(self) -> None:
        """Engine-thread half of drain_export() (lock held): export every
        in-flight request's KV into the caller's box as a (snapshot,
        request) pair — the handle stays OPEN — and fail everything that
        cannot travel with "drained_for_restart" so the Router's failover
        re-places it. Runs under ONE lock hold."""
        box = self._drain_export_box
        b = self.batcher
        for rid, req in list(self._running.items()):
            snap = None
            if not req.cancel_requested:
                try:
                    snap = b.export_kv(rid)
                except Exception:     # this request re-prefills instead
                    snap = None
            b.abort(rid)
            b.release(rid)
            self._last_emit.pop(rid, None)
            if snap is not None:
                self._c_kv_exports.inc()
                box.append((snap, req))
            else:
                self._finish_locked(req, RequestState.FAILED,
                                    "drained_for_restart")
        self._running.clear()
        # pending adoptions already carry their snapshots
        for snap, req in self._imports:
            box.append((snap, req))
        self._imports.clear()
        for _, req in self._parked:
            self._finish_locked(req, RequestState.FAILED,
                                "drained_for_restart")
        self._parked.clear()
        for req in self.queue.clear():
            self._finish_locked(req, RequestState.FAILED,
                                "drained_for_restart")
        self._drain_export_box = None
        self._update_gauges_locked()
        self._work.notify_all()

    def _dispatch(self, emitted: Dict[int, List[int]],
                  finished: List[int],
                  step_dt: Optional[float] = None) -> None:
        now = self._clock()
        ntok = sum(len(t) for t in emitted.values())
        if step_dt is not None and ntok:
            self._h_token.observe(step_dt / ntok)
        if self._slo is not None and ntok:
            self._slo.record_tokens(ntok)   # goodput floor's numerator
        if self.trace is not None and step_dt is not None:
            # the sink-side twin of the serving.step_s timer span
            self.trace.span("engine.step", dur=step_dt, tokens=ntok)
        # prefill-role surrender: requests that produced their first
        # token(s) this step but did NOT finish hand their KV over
        handoffs: List[int] = []
        for rid, toks in emitted.items():
            # the token bridge runs lock-free on the engine thread so
            # submit()/cancel() stay responsive; rid-keyed dict ops are
            # GIL-atomic and a concurrent cancel only turns this get()
            # into a skip
            req = self._running.get(rid)
            if req is None:
                continue                  # aborted in between
            last = self._last_emit.get(rid)
            if last is not None:
                self._h_itl.observe(now - last)
                if self._slo is not None:
                    self._slo.record_itl(now - last)
            self._last_emit[rid] = now
            traced = self.trace is not None and req.trace_id is not None
            ndelivered = 0
            try:
                for t in toks:
                    if req.first_token_time is None:
                        req.first_token_time = now
                        self._h_ttft.observe(now - req.submit_time)
                        if self._slo is not None:
                            self._slo.record_ttft(now - req.submit_time)
                        if traced:
                            self.trace.emit(
                                req.trace_id, "first_token",
                                ttft_s=now - req.submit_time)
                    req._deliver(t)
                    ndelivered += 1
                    self._c_tokens.inc()
                    if req.on_token is not None:
                        req.on_token(t)
            except Exception as e:        # per-request boundary
                if traced and ndelivered:
                    self.trace.emit(req.trace_id, "decode_emit",
                                    n=ndelivered)
                self.batcher.abort(rid)
                self.batcher.release(rid)
                with self._work:
                    self._running.pop(rid, None)
                    self._finish_locked(req, RequestState.FAILED,
                                        "on_token_raised", error=e)
            else:
                if traced:
                    self.trace.emit(req.trace_id, "decode_emit",
                                    n=len(toks))
                if self.role == "prefill" and rid not in finished:
                    handoffs.append(rid)
        for rid in handoffs:
            self._surrender(rid)
        with self._work:
            for rid in finished:
                self.batcher.release(rid)    # tokens already delivered
                req = self._running.pop(rid, None)
                if req is None:
                    continue
                self._finish_locked(req, RequestState.FINISHED,
                                    self._finish_reason(req))
            self._update_gauges_locked()
            self._work.notify_all()

    def _surrender(self, rid: int) -> None:
        """Prefill-role handoff (engine thread): the request committed
        its first token(s). Export its KV, attach the snapshot to the
        handle and FINISH it with reason "prefill_complete"; a
        disaggregated Router migrates the snapshot to a decode replica
        and the client stream continues. When the export fails the
        snapshot stays None and the Router re-prefills warm from
        `prompt + tokens`."""
        with self._work:
            req = self._running.get(rid)
        if req is None:
            return
        snap = None
        try:
            snap = self.batcher.export_kv(rid)
        except Exception:             # this handoff re-prefills instead
            snap = None
        self.batcher.abort(rid)
        self.batcher.release(rid)
        with self._work:
            self._running.pop(rid, None)
            self._last_emit.pop(rid, None)
            req.kv_snapshot = snap
            self._c_handoffs.inc()
            if snap is not None:
                self._c_kv_exports.inc()
            if self.trace is not None and req.trace_id is not None:
                self.trace.emit(
                    req.trace_id, "prefill_complete",
                    exported=snap is not None,
                    bytes=0 if snap is None else snap.nbytes,
                    tokens_kept=len(req.tokens))
            self._finish_locked(req, RequestState.FINISHED,
                                "prefill_complete")

    def _finish_reason(self, req: GenerationRequest) -> str:
        last = req.tokens[-1] if req.tokens else None
        if req.stop_token_id is not None and last == req.stop_token_id:
            return "stop_token"
        if self.batcher.eos is not None and last == self.batcher.eos:
            return "eos"
        return "length"

    def _finish_locked(self, req: GenerationRequest, state: RequestState,
                       reason: str, error=None) -> None:
        counter = {
            RequestState.FINISHED: self._c_completed,
            RequestState.CANCELLED: self._c_cancelled,
            RequestState.TIMED_OUT: self._c_timed_out,
            RequestState.FAILED: self._c_failed,
        }[state]
        if not req.done:
            counter.inc()
            if state is RequestState.FINISHED:
                self._recent_prompts.append(
                    (list(req.prompt),
                     self.batcher.max_new if req.max_new_tokens is None
                     else req.max_new_tokens))
                del self._recent_prompts[:-_RECENT_PROMPTS]
            if self._slo is not None and state in (
                    RequestState.FINISHED, RequestState.FAILED,
                    RequestState.TIMED_OUT):
                # error_rate feed: FAILED/TIMED_OUT are server misses; a
                # cancellation is the client's choice, not recorded
                self._slo.record_request(
                    state is not RequestState.FINISHED)
            if self.trace is not None and req.trace_id is not None:
                self.trace.finish(
                    req.trace_id, state.name.lower(), reason=reason,
                    error=None if error is None else repr(error))
        self._last_emit.pop(req.request_id, None)
        req._finish(state, reason, error=error, now=self._clock())
        self._work.notify_all()

    # ---- fault tolerance -------------------------------------------------
    def _quarantine(self, error: BaseException) -> None:
        """Step-failure recovery (engine thread): convict by re-running
        the failing tick's suspects one at a time, FAIL (or park for a
        backoff retry) only the culprits, and recover every innocent —
        restored slot-in-place through export/import (the failed call
        committed nothing), or requeued at the front of the admission
        queue to resume from `prompt + tokens`.

        Suspects come from the flight recorder's last record: decode
        slot rids for a decode or spec tick, decode rids + unit rids for
        a fused tick, unit rids for a standalone prefill (the batcher
        already rolled those back onto its queue). A suspect whose solo
        probe raises is a culprit; when NO probe reproduces the failure
        every suspect is a transient culprit and is charged a retry, so
        recovery converges. A failed `spec_*` tick indicts the spec
        pipeline: every survivor re-admits with speculation off."""
        b = self.batcher
        records = b.flight.records()
        rec = records[-1] if records else {}
        mode = rec.get("mode")
        if mode == "fused":
            suspects = list(rec.get("decode_rids", [])) + \
                [r for u in rec.get("units", []) for r in u]
        else:       # "decode" | "prefill" | "spec_*" all carry rids
            suspects = list(rec.get("rids", []))
        spec_tick = str(mode or "").startswith("spec")
        with self._lock:
            self._c_step_faults.inc()
            self._c_quarantines.inc()
            self._last_fault_t = self._clock()
            suspects = [r for r in suspects if r in self._running]
        # probes run OUTSIDE the lock (device work) and UNDER the
        # watchdog: a probe can hang exactly like the step did
        culprits: Dict[int, BaseException] = {}
        for rid in suspects:
            slot = next((s for s in range(b.B)
                         if b.active[s] and b.slot_req[s] == rid), None)
            self._step_t0 = self._clock()
            try:
                if slot is not None:
                    b.probe_decode_slot(slot)
                else:
                    b.probe_queued(rid)
            except Exception as pe:   # a solo re-run raised: convicted
                culprits[rid] = pe
            finally:
                self._step_t0 = None
            if self._wedged:
                return        # a hung probe tripped the watchdog
        convicted = bool(culprits)
        if not convicted:
            culprits = {rid: error for rid in suspects}
        with self._work:
            order = sorted(self._running.items(),
                           key=lambda kv: kv[1].admitted_index or 0)
            victims: List[GenerationRequest] = []
            restorable: List = []        # (request, snapshot) innocents
            for rid, req in order:
                snap = None
                if rid not in culprits and not req.cancel_requested:
                    # slot-in-place recovery: the failed call committed
                    # nothing, so an innocent's slot state is intact —
                    # export its KV now and re-import it below
                    try:
                        snap = b.export_kv(rid)
                    except Exception:  # degrades to the requeue path
                        snap = None
                b.abort(rid)
                b.release(rid)
                self._last_emit.pop(rid, None)
                if spec_tick:
                    req.spec_opt_out = True
                if rid in culprits:
                    self._retry_or_fail_locked(req, culprits[rid],
                                               convicted)
                elif snap is not None:
                    restorable.append((req, snap))
                else:
                    victims.append(req)
            self._running.clear()
            for req, snap in restorable:
                try:
                    rid2 = b.import_kv(snap)
                except Exception:     # requeue instead: cold, not lost
                    victims.append(req)
                    continue
                req.request_id = rid2
                self._running[rid2] = req
                self._c_kv_exports.inc()
                self._c_kv_imports.inc()
                self._c_restored.inc()
                if self.trace is not None and req.trace_id is not None:
                    self.trace.alias(rid2, req.trace_id)
                    self.trace.emit(req.trace_id, "restored",
                                    reason="quarantine_victim", rid=rid2,
                                    tokens_kept=len(req.tokens),
                                    re_prefill=0, spec_fallback=spec_tick)
            for req in victims:
                self._c_requeued.inc()
                if self.trace is not None and req.trace_id is not None:
                    self.trace.emit(req.trace_id, "requeued",
                                    reason="quarantine_victim",
                                    tokens_kept=len(req.tokens),
                                    spec_fallback=spec_tick)
            self.queue.requeue(victims)
            self._update_gauges_locked()
            self._work.notify_all()

    def _retry_or_fail_locked(self, req: GenerationRequest,
                              error: BaseException,
                              convicted: bool) -> None:
        """A quarantined culprit's fate: transient-looking failures (per
        the `retry_transient` predicate) park for an exponential-backoff
        re-admission until `max_retries` is spent; everything else — and
        an exhausted budget — is terminal FAILED."""
        try:
            transient = bool(self._retry_transient(error))
        except Exception:             # a broken predicate fails fast
            transient = False
        if transient and req.retries < self._max_retries:
            req.retries += 1
            self._c_retried.inc()
            backoff = self._retry_backoff_s * (2.0 ** (req.retries - 1))
            if self.trace is not None and req.trace_id is not None:
                self.trace.emit(req.trace_id, "retried",
                                retries=req.retries, backoff_s=backoff,
                                convicted=convicted, error=repr(error))
            self._parked.append([self._clock() + backoff, req])
        else:
            reason = ("retries_exhausted" if transient
                      else "quarantine_culprit")
            self._finish_locked(req, RequestState.FAILED, reason,
                                error=error)

    def _release_parked_locked(self) -> None:
        """Move backoff-expired retries to the front of the admission
        queue (they held admission before; fresh traffic waits)."""
        if not self._parked:
            return
        now = self._clock()
        ready = [e[1] for e in self._parked if e[0] <= now]
        if ready:
            self._parked = [e for e in self._parked if e[0] > now]
            self.queue.requeue(ready)

    def _watchdog_loop(self) -> None:
        """Monitor thread: a device step still running past `watchdog_s`
        means the engine thread is wedged inside a call that may never
        return — dump forensics, flip health to UNHEALTHY and fail the
        stranded requests' HANDLES (the batcher belongs to the wedged
        thread). Until warmup() has run, the deadline is multiplied by
        the compile grace: any step may be paying a lazy capture."""
        poll = max(0.005, min(0.05, self._watchdog_s / 4.0))
        while not self._wd_stop.wait(poll):
            t0 = self._step_t0
            if t0 is None or self._wedged:
                continue
            deadline = self._watchdog_s
            if not self._warmed:
                deadline *= self._wd_grace
            stuck = self._clock() - t0
            if stuck > deadline:
                self._trip_watchdog(stuck)

    def _trip_watchdog(self, stuck_s: float) -> None:
        err = HungStepError(
            f"device step exceeded the {self._watchdog_s}s watchdog "
            f"deadline ({stuck_s:.3f}s and counting) — engine thread "
            f"presumed wedged; see last_flight_dump for the hung tick's "
            f"mode and unit composition")
        # forensics first: the flight ring's last record IS the hung
        # tick (recorded before its device call)
        self._record_failure_dump(err)
        with self._work:
            if self._wedged:
                return
            self._wedged = True
            self._accepting = False
            self._c_watchdog.inc()
            self._c_step_faults.inc()
            self._last_fault_t = self._clock()
            stranded = list(self._running.items())
            self._running.clear()
            parked = [e[1] for e in self._parked]
            self._parked.clear()
            queued = self.queue.clear()
            for _, req in stranded:
                self._finish_locked(req, RequestState.FAILED,
                                    "watchdog_hung_step", error=err)
            for req in parked + queued:
                self._finish_locked(req, RequestState.FAILED,
                                    "watchdog_engine_unhealthy", error=err)
            self._work.notify_all()

    def _mark_broken(self, reason: str, error: BaseException) -> None:
        """Fault-fuse verdict (engine thread): the engine declares itself
        UNHEALTHY without a wedged thread — in-flight requests were
        already failed by `_fail_all_running`; queued and parked ones
        fail here with `fault_streak_engine_unhealthy` (the Router
        re-places them, a supervisor respawns this replica)."""
        with self._work:
            if self._broken is not None:
                return
            self._broken = reason
            self._accepting = False
            parked = [e[1] for e in self._parked]
            self._parked.clear()
            for req in parked + self.queue.clear():
                self._finish_locked(req, RequestState.FAILED,
                                    "fault_streak_engine_unhealthy",
                                    error=error)
            self._update_gauges_locked()
            self._work.notify_all()

    def _fail_all_running(self, error: BaseException) -> None:
        """The conservative step-failure fallback (quarantine off, no
        tick recorded, or the fuse blew): every in-flight request fails
        with the step error attached. The failed call committed nothing,
        so each request's KV is still exportable — a snapshot rides the
        handle (`kv_snapshot`) so a Router failing it over imports it
        instead of re-prefilling."""
        with self._work:
            self._c_step_faults.inc()
            self._last_fault_t = self._clock()
            for rid, req in list(self._running.items()):
                try:
                    req.kv_snapshot = self.batcher.export_kv(rid)
                    self._c_kv_exports.inc()
                except Exception:     # this victim re-prefills instead
                    req.kv_snapshot = None
                self.batcher.abort(rid)
                self.batcher.release(rid)
                self._finish_locked(req, RequestState.FAILED,
                                    "decode_step_raised", error=error)
            self._running.clear()
            self._update_gauges_locked()

    def _update_gauges_locked(self) -> None:
        self._slo_eval()
        b = self.batcher
        stats = b.alloc.stats()
        self._alloc_stats = stats          # snapshot() reads this cache
        pc = b.prefix_stats()
        self._prefix_stats = pc
        self._g_queue.set(len(self.queue))
        self._g_running.set(len(self._running))
        self._g_blocks.set(stats["blocks_in_use"])
        self._g_util.set(stats["blocks_in_use"] / stats["capacity_blocks"])
        self._g_prefill_compiles.set(b.prefill_compile_count)
        self._g_compiles.set(b.compile_count)
        self._g_prefill_pad.set(b.prefill_pad_tokens)
        self._g_fused_steps.set(b.fused_steps)
        self._g_fused_units.set(b.fused_unit_count)
        self._g_decode_stalls.set(b.decode_stall_steps)
        self._g_kv_cached_bytes.set(b.kv_cached_bytes())
        sp = b.spec
        self._g_spec_steps.set(sp.steps)
        self._g_spec_accept.set(sp.accept_rate())
        self._g_spec_tps.set(sp.tokens_per_step())
        self._g_spec_accepted.set(sp.accepted)
        for d in sp.drain_depths():
            self._h_spec_depth.observe(float(d))
        if pc.get("enabled"):
            self._g_pc_hit_tokens.set(pc["hit_tokens"])
            self._g_pc_hit_rate.set(pc["hit_rate"])
            self._g_pc_evictions.set(pc["evictions"])
            self._g_pc_cached.set(pc["cached_blocks"])
