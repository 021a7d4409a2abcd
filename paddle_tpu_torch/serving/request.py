"""paddle_tpu_torch.serving.request — request lifecycle + per-request channel.

One `GenerationRequest` is the unit the engine schedules: it carries the
prompt and decode config in, and tokens out through a thread-safe
channel that supports both blocking (`result()`) and incremental
(`stream()`) consumption.

State machine (engine-thread writes, any thread reads):

    QUEUED -> PREFILL -> DECODING -> FINISHED
                 \\          |\\---> CANCELLED   (consumer called cancel())
                  \\         +----> TIMED_OUT   (deadline passed)
                   +-------------> FAILED      (this request's step or
                                                on_token callback raised)

QUEUED can jump straight to CANCELLED / TIMED_OUT / FAILED (reaped
before admission). Terminal states free the request's KV blocks back to
the pool and close the channel. One loop exists off the happy path:
the engine's quarantine may requeue an in-flight request after a step
failure, re-entering PREFILL from PREFILL or DECODING — the request
resumes from `prompt + tokens`, so the channel only ever sees each
token once.

Host-side only (no torch): the port's copy of the JAX package's
`serving/request.py`, the quarantine, speculative-fallback and
KV-transfer fields included.
"""
from __future__ import annotations

import enum
import queue
import threading
from typing import Callable, Iterator, List, Optional

__all__ = [
    "GenerationRequest", "RequestState", "TERMINAL_STATES",
    "RequestError", "RequestCancelled", "RequestFailed", "RequestTimedOut",
]


class RequestState(enum.Enum):
    """Lifecycle states of a GenerationRequest (see module docstring
    for the transition diagram)."""

    QUEUED = "QUEUED"
    PREFILL = "PREFILL"
    DECODING = "DECODING"
    FINISHED = "FINISHED"
    CANCELLED = "CANCELLED"
    FAILED = "FAILED"
    TIMED_OUT = "TIMED_OUT"


TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.CANCELLED,
    RequestState.FAILED, RequestState.TIMED_OUT,
})


class RequestError(RuntimeError):
    """A request ended in a non-FINISHED terminal state."""

    def __init__(self, request: "GenerationRequest", msg: str):
        super().__init__(msg)
        self.request = request


class RequestCancelled(RequestError):
    """result()/stream() on a request that was cancel()ed."""


class RequestTimedOut(RequestError):
    """result()/stream() on a request whose deadline expired."""


class RequestFailed(RequestError):
    """result()/stream() on a request whose decode step or on_token
    callback raised (the original error is on `.request.error`)."""


_SENTINEL = object()      # channel close marker


class GenerationRequest:
    """One generation request.

    Consumer-side API: `cancel()`, `result(timeout)`, `stream()`,
    `wait(timeout)`, `done`. Everything `_`-prefixed is engine-side and
    must only be called from the engine thread.

    `priority`: smaller = served sooner (FIFO among equals, with aging —
    see scheduler.AdmissionQueue). `max_new_tokens` None means "the
    engine's max" — ServingEngine.submit() resolves it in place.
    `timeout_s` is a wall-clock deadline from submission covering queue
    wait AND decode. `stop_token_id` finishes the request early when
    emitted (per-request — rides the ContinuousBatcher's per-slot stop
    support). `on_token` is called in the engine thread per generated
    token; if it raises, only THIS request fails (the engine's
    exception boundary).

    Fault tolerance: `retries` counts backoff re-admissions the
    engine's quarantine granted this request as a transient-failure
    culprit (victims of SOMEONE ELSE'S fault are requeued without
    consuming it). A re-admitted request resumes from
    `prompt + tokens` — already-streamed tokens are never re-emitted
    or lost — and `request_id` moves to the new batcher rid."""

    def __init__(self, prompt, *, priority: int = 0,
                 max_new_tokens: Optional[int] = None,
                 stop_token_id: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 on_token: Optional[Callable[[int], None]] = None):
        self.prompt: List[int] = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.priority = int(priority)
        self.max_new_tokens = (None if max_new_tokens is None
                               else int(max_new_tokens))
        self.stop_token_id = (None if stop_token_id is None
                              else int(stop_token_id))
        self.timeout_s = timeout_s
        self.on_token = on_token

        self.state = RequestState.QUEUED
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None

        # engine-stamped timeline (engine clock, typically time.monotonic)
        self.request_id: Optional[int] = None       # batcher rid once admitted
        self.submit_time: Optional[float] = None
        self.deadline: Optional[float] = None
        self.admit_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.admitted_index: Optional[int] = None   # global admission order
        self.retries = 0          # transient-culprit re-admissions used
        # quarantine's plain-decode fallback: set when this request rode
        # a FAILED speculative tick — its re-admissions opt out of the
        # spec pipeline
        self.spec_opt_out = False
        # portable KV attached at a handoff boundary
        # (serving.kvtransfer.KVSnapshot, or None): a prefill-role engine
        # surrenders the request's KV here at "prefill_complete" and a
        # failing engine attaches it on the way down — the Router imports
        # it at the destination instead of re-prefilling, falling back to
        # warm re-prefill when it is None
        self.kv_snapshot = None
        self.trace_id: Optional[str] = None         # serving.trace timeline

        self._cancel = threading.Event()
        self._done = threading.Event()
        self._chan: "queue.Queue" = queue.Queue()

    # ---- consumer side ---------------------------------------------------
    def cancel(self) -> None:
        """Request cancellation; the engine honors it at its next
        scheduling point (queued: before admission; decoding: between
        chunks, freeing the KV blocks)."""
        self._cancel.set()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until terminal; True if the request reached a terminal
        state within `timeout`."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until finished and return the generated tokens.
        Raises RequestCancelled / RequestTimedOut / RequestFailed when
        the request did not FINISH (partial tokens stay readable on
        `.tokens`); TimeoutError when `timeout` expires first."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request not finished within {timeout}s "
                f"(state={self.state.name})")
        if self.state is RequestState.FINISHED:
            return list(self.tokens)
        exc = {RequestState.CANCELLED: RequestCancelled,
               RequestState.TIMED_OUT: RequestTimedOut}.get(
                   self.state, RequestFailed)
        raise exc(self, f"request ended {self.state.name}"
                        f"{f': {self.error!r}' if self.error else ''}")

    def stream(self) -> Iterator[int]:
        """Yield tokens as the engine generates them (one live consumer
        at a time). Ends cleanly on FINISHED or CANCELLED; raises
        RequestTimedOut / RequestFailed so a consumer can't mistake a
        truncated stream for a complete one. Safe to call again after
        the request is terminal (yields nothing instead of blocking on
        the already-consumed close sentinel)."""
        while True:
            if self._done.is_set():
                # _finish enqueues the sentinel BEFORE setting done, so
                # once done a non-blocking drain sees every remaining
                # token — never block on a channel that may already be
                # fully consumed (repeat stream() call)
                try:
                    t = self._chan.get_nowait()
                except queue.Empty:
                    break
            else:
                t = self._chan.get()
            if t is _SENTINEL:
                break
            yield t
        if self.state is RequestState.TIMED_OUT:
            raise RequestTimedOut(self, "request timed out mid-stream")
        if self.state is RequestState.FAILED:
            raise RequestFailed(self, f"request failed: {self.error!r}")

    # ---- engine side -----------------------------------------------------
    def _deliver(self, tok: int) -> None:
        self.tokens.append(tok)
        if self.state is RequestState.PREFILL:
            self.state = RequestState.DECODING
        self._chan.put(tok)

    def _finish(self, state: RequestState, reason: Optional[str] = None,
                error: Optional[BaseException] = None,
                now: Optional[float] = None) -> None:
        if self.done:
            return
        self.state = state
        self.finish_reason = reason or state.name.lower()
        self.error = error
        self.finish_time = now
        self._chan.put(_SENTINEL)
        self._done.set()

    def __repr__(self) -> str:
        return (f"GenerationRequest(id={self.request_id}, "
                f"state={self.state.name}, prio={self.priority}, "
                f"prompt_len={len(self.prompt)}, "
                f"tokens={len(self.tokens)})")
