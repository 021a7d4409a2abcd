"""paddle_tpu_torch.serving.engine — thread-backed serving over the
paged-KV continuous batcher.

Port of paddle_tpu/serving/engine.py's serving core. One background
thread owns the batcher; everything else talks through locks/channels:

    submit()/generate()/stream()          consumer threads
        │  AdmissionQueue (priority + aging + backpressure)
        ▼
    engine thread loop:
        reap cancelled / expired (queued AND in-flight)
        admit while a batch slot AND the KV blocks fit   ── scheduler.py
        batcher.step()  — one device chunk              ── nlp/paged.py
        deliver tokens → request channels (+ on_token)   ── request.py
        update metrics                                   ── metrics.py

A request whose on_token callback raises fails ONLY that request. A
device-step failure fails every in-flight request with the error
attached (the JAX engine's conservative fallback; its quarantine is a
later slice). shutdown(drain=True) stops admissions, drains in-flight
work, then joins the thread.

The batcher's device work runs on the engine thread; the kernel
wrappers launch on that thread's current CUDA stream.

Quantized serving (`weight_dtype`, `kv_dtype`) and self-speculative
decoding (`speculative`, `spec_k`, `draft_layers`, `spec_tree`,
`spec_draft_w8`) pass through to the batcher; `snapshot()` carries
their resolved config and accounting, and the `spec_*` gauges and the
`spec_accept_depth` histogram track acceptance.

Not ported yet, so accepted only at their off value (anything else
raises NotImplementedError naming the later slice): prefix caching, the
tensor-parallel mesh, SLOs, tracing, the watchdog, fault injection
(with it, the quarantine's spec fallback) and disaggregated roles (KV
import/export). `spec_attention_impl` is taken only as None: the port
has no backend switch, the device decides.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

from .metrics import MetricsRegistry
from .request import GenerationRequest, RequestState
from .scheduler import AdmissionQueue, QueueFullError

__all__ = ["ServingEngine", "EngineStopped"]

# kwarg: (its off value, the later slice that ports it)
_UNPORTED = {
    "prefix_cache": (False, "prefix caching"),
    "mesh": (None, "multi-GPU serving"),
    "slo": (False, "SLO tracking"),
    "trace": (False, "serving traces"),
    "watchdog_s": (None, "fault tolerance"),
    "fault_injector": (None, "fault tolerance"),
    "role": ("both", "disaggregated serving"),
}


class EngineStopped(RuntimeError):
    """submit() after shutdown began."""


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
    up until `start()`.
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
                 prefill_buckets=None, max_prefill_bucket: int = 512,
                 fused_prefill: bool = True, fused_units: int = 1,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 speculative: bool = False, spec_k: int = 4,
                 draft_layers: Optional[int] = None, spec_tree=None,
                 spec_draft_w8: bool = False,
                 spec_attention_impl: Optional[str] = None, device="cuda",
                 clock=time.monotonic, **unported):
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
        from ..nlp.paged import ContinuousBatcher
        self.batcher = ContinuousBatcher(
            params, cfg, max_batch=max_batch, block_size=block_size,
            max_total_len=max_total_len, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, num_blocks=num_blocks, chunk=chunk,
            prefill_buckets=prefill_buckets,
            max_prefill_bucket=max_prefill_bucket,
            fused_prefill=fused_prefill, fused_units=fused_units,
            weight_dtype=weight_dtype, kv_dtype=kv_dtype,
            speculative=speculative, spec_k=spec_k,
            draft_layers=draft_layers, spec_tree=spec_tree,
            spec_draft_w8=spec_draft_w8, device=device)
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

        m = self.metrics
        self._c_submitted = m.counter("requests_submitted")
        self._c_admitted = m.counter("requests_admitted")
        self._c_rejected = m.counter("requests_rejected")
        self._c_completed = m.counter("requests_completed")
        self._c_cancelled = m.counter("requests_cancelled")
        self._c_timed_out = m.counter("requests_timed_out")
        self._c_failed = m.counter("requests_failed")
        self._c_tokens = m.counter("tokens_generated")
        self._c_step_faults = m.counter("step_faults")
        self._g_queue = m.gauge("queue_depth")
        self._g_running = m.gauge("requests_in_flight")
        self._g_blocks = m.gauge("kv_blocks_in_use")
        self._g_util = m.gauge("kv_block_utilization")
        self._h_ttft = m.histogram("ttft_s")
        self._h_wait = m.histogram("queue_wait_s")
        self._h_token = m.histogram("per_token_s")
        # inter-token latency per request: the gap between consecutive
        # step dispatches that delivered this request tokens — where
        # admission-during-decode stalls show up
        self._h_itl = m.histogram("itl_s")
        self._last_emit: Dict[int, float] = {}    # rid -> last dispatch
        self._g_prefill_pad = m.gauge("prefill_pad_tokens")
        self._g_fused_steps = m.gauge("fused_steps")
        self._g_fused_units = m.gauge("fused_unit_count")
        self._g_decode_stalls = m.gauge("decode_stall_steps")
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
        if start:
            self.start()

    # ---- public API ------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._work:
            if self._stop:
                raise EngineStopped("engine already shut down")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="paddle-tpu-torch-serving",
                    daemon=True)
                self._thread.start()
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
            self._work.notify_all()
        return req

    def submit_import(self, snapshot, req=None):
        raise NotImplementedError(
            "KV-snapshot import is not ported yet (disaggregated serving "
            "is a later slice of the PyTorch port)")

    def drain_export(self, timeout: float = 2.0):
        raise NotImplementedError(
            "KV-snapshot export is not ported yet (disaggregated serving "
            "is a later slice of the PyTorch port)")

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

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until queue + in-flight are empty; False on timeout."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._work:
            while self._running or len(self.queue):
                rem = self._idle_poll_s if deadline is None else \
                    min(self._idle_poll_s, deadline - self._clock())
                if rem <= 0:
                    return False
                self._work.wait(rem)
        return True

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
        if self._thread is not None:
            budget = (None if deadline is None
                      else max(0.0, deadline - self._clock()))
            self._thread.join(budget)
            if self._thread.is_alive():
                return False
        else:
            with self._work:
                self._cancel_pending_locked()
        return clean

    def _cancel_pending_locked(self) -> None:
        """Cancel everything queued + in flight (lock held)."""
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
            snap["allocator"] = dict(self._alloc_stats)
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
        return snap

    # ---- engine thread ---------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._work:
                if self._stop:
                    # exit path owns the batcher: cancel whatever is
                    # left so no consumer stays blocked on its channel
                    self._cancel_pending_locked()
                    return
                self._reap_queued_locked()
                self._reap_running_locked()
                self._admit_locked()
                self._update_gauges_locked()
                if not self._running and not len(self.queue):
                    if not self._accepting:
                        return            # graceful drain complete
                    self._work.notify_all()      # wake drain() waiters
                    self._work.wait()
                    continue
            # the device step runs OUTSIDE the lock: the batcher is only
            # touched from this thread, so submit()/cancel() stay
            # responsive during device work
            timer = self.metrics.timer("serving.step_s")
            try:
                with timer:
                    emitted, finished = self.batcher.step()
            except Exception as e:        # device-step boundary
                self._fail_all_running(e)
                continue
            self._dispatch(emitted, finished, step_dt=timer.elapsed)

    def _reap_queued_locked(self) -> None:
        now = self._clock()
        for req in self.queue.reap(
                lambda r: r.cancel_requested or self._expired(r, now)):
            state = (RequestState.CANCELLED if req.cancel_requested
                     else RequestState.TIMED_OUT)
            self._finish_locked(req, state, "reaped_in_queue")

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

    def _admit_locked(self) -> None:
        b = self.batcher
        free_slots = b.free_slots()
        if free_slots <= 0:
            return
        budget = {"blocks": b.alloc.free_blocks}

        def fits(r):   # max_new_tokens was resolved by submit()
            # pop_many calls fits once per ACCEPTED item, so the block
            # budget is debited right here
            n = b.blocks_needed(len(r.prompt), r.max_new_tokens)
            if n > budget["blocks"]:
                return False
            budget["blocks"] -= n
            return True

        # one lock acquisition and one consistent priority view for the
        # whole admission round; the burst lands in the batcher's queue
        # together, so same-bucket requests prefill in one call
        now = self._clock()
        for req in self.queue.pop_many(free_slots, fits=fits):
            if req.cancel_requested or self._expired(req, now):
                state = (RequestState.CANCELLED if req.cancel_requested
                         else RequestState.TIMED_OUT)
                self._finish_locked(req, state, "reaped_at_admission")
                continue
            rid = b.submit(req.prompt, stop_token_id=req.stop_token_id,
                           max_new_tokens=req.max_new_tokens)
            req.request_id = rid
            req.state = RequestState.PREFILL
            req.admit_time = now
            req.admitted_index = self._admit_seq
            self._admit_seq += 1
            self._h_wait.observe(now - req.submit_time)
            self._c_admitted.inc()
            self._running[rid] = req

    def _dispatch(self, emitted: Dict[int, List[int]],
                  finished: List[int],
                  step_dt: Optional[float] = None) -> None:
        now = self._clock()
        ntok = sum(len(t) for t in emitted.values())
        if step_dt is not None and ntok:
            self._h_token.observe(step_dt / ntok)
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
            self._last_emit[rid] = now
            try:
                for t in toks:
                    if req.first_token_time is None:
                        req.first_token_time = now
                        self._h_ttft.observe(now - req.submit_time)
                    req._deliver(t)
                    self._c_tokens.inc()
                    if req.on_token is not None:
                        req.on_token(t)
            except Exception as e:        # per-request boundary
                self.batcher.abort(rid)
                self.batcher.release(rid)
                with self._work:
                    self._running.pop(rid, None)
                    self._finish_locked(req, RequestState.FAILED,
                                        "on_token_raised", error=e)
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
        self._last_emit.pop(req.request_id, None)
        req._finish(state, reason, error=error, now=self._clock())
        self._work.notify_all()

    def _fail_all_running(self, error: BaseException) -> None:
        """A device step raised: every in-flight request fails with the
        step error attached and its blocks return to the pool."""
        with self._work:
            self._c_step_faults.inc()
            for rid, req in list(self._running.items()):
                self.batcher.abort(rid)
                self.batcher.release(rid)
                self._finish_locked(req, RequestState.FAILED,
                                    "decode_step_raised", error=error)
            self._running.clear()
            self._update_gauges_locked()

    def _update_gauges_locked(self) -> None:
        b = self.batcher
        stats = b.alloc.stats()
        self._alloc_stats = stats          # snapshot() reads this cache
        self._g_queue.set(len(self.queue))
        self._g_running.set(len(self._running))
        self._g_blocks.set(stats["blocks_in_use"])
        self._g_util.set(stats["blocks_in_use"] / stats["capacity_blocks"])
        self._g_prefill_pad.set(b.prefill_pad_tokens)
        self._g_fused_steps.set(b.fused_steps)
        self._g_fused_units.set(b.fused_unit_count)
        self._g_decode_stalls.set(b.decode_stall_steps)
        sp = b.spec
        self._g_spec_steps.set(sp.steps)
        self._g_spec_accept.set(sp.accept_rate())
        self._g_spec_tps.set(sp.tokens_per_step())
        self._g_spec_accepted.set(sp.accepted)
        for d in sp.drain_depths():
            self._h_spec_depth.observe(float(d))
