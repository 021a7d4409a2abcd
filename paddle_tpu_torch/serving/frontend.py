"""paddle_tpu_torch.serving.frontend — stdlib-only asyncio HTTP
frontend.

The port's own copy of paddle_tpu/serving/frontend.py (stdlib asyncio,
no torch): an `HttpFrontend` serves a `Router` or a single
`ServingEngine` over HTTP/1.1 on a background event-loop thread.

  * ``POST /v1/generate`` — body ``{"prompt": [ids], "max_new_tokens",
    "priority", "timeout_s", "stop_token_id"}`` → ``{"tokens": [...],
    "replica": ..., "finish_reason": ...}``;
  * ``POST /v1/stream`` — same body, Server-Sent Events: one
    ``data: {"token": t}`` event per token, then a final
    ``data: {"done": true, ...}`` event;
  * ``GET /health`` — the router's worst-of health (200 unless every
    replica is UNHEALTHY, then 503);
  * ``GET /metrics`` — Prometheus text with ``replica="rN"`` labels;
  * ``POST /admin/reset_breaker`` — revive a breaker-pinned slot;
  * ``POST /debug/profile`` — an on-demand device-time capture window.

Bind to ``127.0.0.1`` and port 0 for an ephemeral port (`.port` after
`start()`).
"""
from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional, Tuple

from .request import RequestState
from .scheduler import QueueFullError

__all__ = ["HttpFrontend"]

_MAX_BODY = 1 << 20          # 1 MiB request-body cap (413 past it)
_MAX_HEADER = 32 * 1024

_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 408: "Request Timeout",
                413: "Payload Too Large", 429: "Too Many Requests",
                499: "Client Closed Request", 500: "Internal Server Error",
                503: "Service Unavailable", 504: "Gateway Timeout"}

# terminal request state -> HTTP status for the one-shot endpoint
_STATE_HTTP = {RequestState.FINISHED: 200, RequestState.TIMED_OUT: 504,
               RequestState.CANCELLED: 499, RequestState.FAILED: 500}


def _headers(status: int, ctype: str, length: Optional[int] = None,
             extra: str = "", *, keep: bool = False,
             chunked: bool = False) -> bytes:
    text = _STATUS_TEXT.get(status, "")
    head = (f"HTTP/1.1 {status} {text}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Connection: {'keep-alive' if keep else 'close'}\r\n"
            f"{extra}")
    if chunked:
        head += "Transfer-Encoding: chunked\r\n"
    if length is not None:
        head += f"Content-Length: {length}\r\n"
    return (head + "\r\n").encode()


def _json_body(status: int, payload: Dict[str, Any],
               extra: str = "", keep: bool = False) -> bytes:
    body = json.dumps(payload).encode()
    return _headers(status, "application/json", len(body), extra,
                    keep=keep) + body


def _chunk(data: bytes) -> bytes:
    """One chunked-transfer frame (hex size line + payload + CRLF)."""
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


def _sse_event(data: Dict[str, Any], event: Optional[str] = None) -> bytes:
    head = f"event: {event}\n" if event else ""
    return (head + f"data: {json.dumps(data)}\n\n").encode()


class HttpFrontend:
    """Asyncio HTTP server over a `Router` (stdlib only).

    Runs its own event loop on a background thread, so the serving
    stack stays usable from synchronous code and tests:

        fe = HttpFrontend(router, host="127.0.0.1", port=0)
        host, port = fe.start()          # port=0 → ephemeral, returned
        ...                              # POST /v1/generate, /v1/stream
        fe.shutdown()                    # drain handlers, then router

    `poll_s` is the token-bridge tick: how often a streaming handler
    checks the handle for new tokens (the engine thread appends them;
    the handler only ever reads — no cross-thread wakeups needed, and
    the event loop never blocks on engine work). `shutdown_router=False`
    leaves the router running after the HTTP layer stops."""

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0,
                 *, poll_s: float = 0.005,
                 request_timeout_s: Optional[float] = 600.0,
                 shutdown_router: bool = True):
        self.router = router
        self._host = host
        self._port = port
        self._poll_s = float(poll_s)
        self._request_timeout_s = request_timeout_s
        self._shutdown_router = shutdown_router
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._draining = False
        self._active = 0                    # loop-thread only
        self._idle: Optional[asyncio.Event] = None
        self.address: Optional[Tuple[str, int]] = None

    # ---- lifecycle -------------------------------------------------------
    def start(self, timeout: float = 10.0) -> Tuple[str, int]:
        """Bind and serve on a background event-loop thread; returns
        the bound (host, port) — pass port=0 at construction for an
        ephemeral port."""
        if self._thread is not None:
            if not self._started.wait(timeout) or self.address is None:
                raise RuntimeError("frontend failed to start")
            return self.address
        self._thread = threading.Thread(target=self._run,
                                        name="paddle-tpu-http",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout) or self.address is None:
            raise RuntimeError("frontend failed to start")
        return self.address

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._idle = asyncio.Event()
        self._idle.set()

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self._host, self._port)
            self.address = self._server.sockets[0].getsockname()[:2]
        try:
            loop.run_until_complete(boot())
        # bind failures (port in use) must
        # release start()'s waiter instead of hanging it; the error
        # surfaces as the RuntimeError start() raises on no address
        except Exception:
            self.address = None
            self._started.set()
            return
        self._started.set()
        try:
            loop.run_forever()
        finally:
            loop.close()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> bool:
        """Graceful stop: refuse new requests (503), wait for in-flight
        handlers to finish their responses (bounded by `timeout`), stop
        the loop, then shut the router down (drain semantics forwarded)
        unless `shutdown_router=False`."""
        clean = True
        if self._loop is not None and self._thread is not None \
                and self._thread.is_alive():
            fut = asyncio.run_coroutine_threadsafe(
                self._shutdown_async(drain, timeout), self._loop)
            try:
                clean = fut.result(None if timeout is None
                                   else timeout + 5.0)
            # a loop torn down mid-shutdown
            # must not leak out of the caller; the router still stops
            except Exception:
                clean = False
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(5.0)
            if self._thread.is_alive():
                clean = False
        if self._shutdown_router:
            if not self.router.shutdown(drain=drain, timeout=timeout):
                clean = False
        return clean

    async def _shutdown_async(self, drain: bool,
                              timeout: Optional[float]) -> bool:
        self._draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if drain and self._active:
            try:
                await asyncio.wait_for(self._idle.wait(), timeout)
            except asyncio.TimeoutError:
                return False
        return True

    def __enter__(self) -> "HttpFrontend":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ---- request handling ------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            # HTTP/1.1 keep-alive: loop requests on this connection
            # until the client asks for close, disconnects, or framing
            # breaks (a parse error leaves the stream position
            # unknowable — reuse would misparse, so those close).
            # The in-flight counter covers only the dispatch of each
            # request, never the idle park between them: a drain must
            # not wait on a keep-alive connection nobody is using.
            while True:
                try:
                    method, path, body, ka = \
                        await self._read_request(reader)
                except _HttpError as e:
                    writer.write(_json_body(e.status,
                                            {"error": e.message}))
                    await writer.drain()
                    return
                self._active += 1
                self._idle.clear()
                try:
                    if self._draining:
                        writer.write(_json_body(
                            503, {"error": "frontend is draining"}))
                        await writer.drain()
                        return
                    elif path == "/health" and method == "GET":
                        await self._health(writer, ka)
                    elif path == "/metrics" and method == "GET":
                        await self._metrics(writer, ka)
                    elif path == "/v1/generate" and method == "POST":
                        await self._generate(writer, body, ka)
                    elif path == "/v1/stream" and method == "POST":
                        await self._stream_sse(writer, body, ka)
                    elif path == "/admin/reset_breaker" \
                            and method == "POST":
                        await self._reset_breaker(writer, body, ka)
                    elif path == "/debug/profile" and method == "POST":
                        await self._profile(writer, body, ka)
                    elif path in ("/health", "/metrics", "/v1/generate",
                                  "/v1/stream", "/admin/reset_breaker",
                                  "/debug/profile"):
                        writer.write(_json_body(
                            405,
                            {"error": f"{method} not allowed on {path}"},
                            keep=ka))
                    else:
                        writer.write(_json_body(
                            404, {"error": f"no route for {path}"},
                            keep=ka))
                    await writer.drain()
                finally:
                    self._active -= 1
                    if self._active == 0:
                        self._idle.set()
                if not ka or writer.transport is None \
                        or writer.transport.is_closing():
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                       # client went away mid-response
        # top-level handler boundary: an
        # unexpected error answers 500 on THIS connection instead of
        # killing the accept loop for every client
        except Exception as e:
            try:
                writer.write(_json_body(500, {"error": repr(e)}))
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        finally:
            try:
                writer.close()
            except RuntimeError:
                pass

    async def _read_request(self, reader) -> Tuple[str, str, bytes, bool]:
        """One request off the stream → (method, path, body,
        keep_alive). HTTP/1.1 defaults to keep-alive unless the client
        sends ``Connection: close``; HTTP/1.0 must opt in. The body is
        either Content-Length-framed or chunked-decoded."""
        try:
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), self._request_timeout_s)
        except asyncio.TimeoutError:
            raise _HttpError(408, "timed out reading request head")
        except asyncio.LimitOverrunError:
            raise _HttpError(413, "request head too large")
        if len(head) > _MAX_HEADER:
            raise _HttpError(413, "request head too large")
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) < 3:
            raise _HttpError(400, f"malformed request line: {lines[0]!r}")
        method, path = parts[0].upper(), parts[1].split("?", 1)[0]
        version = parts[-1].upper()
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        conn = headers.get("connection", "").lower()
        ka = (conn != "close" if version == "HTTP/1.1"
              else conn == "keep-alive")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            try:
                body = await self._read_chunked(reader)
            except asyncio.TimeoutError:
                raise _HttpError(408, "timed out reading chunked body")
            except asyncio.IncompleteReadError:
                raise _HttpError(400, "truncated chunked body")
            return method, path, body, ka
        length = 0
        if "content-length" in headers:
            try:
                length = int(headers["content-length"])
            except ValueError:
                raise _HttpError(400, "bad Content-Length")
        if length > _MAX_BODY:
            raise _HttpError(413, f"body over {_MAX_BODY} bytes")
        body = b""
        if length:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          self._request_timeout_s)
        return method, path, body, ka

    async def _read_chunked(self, reader) -> bytes:
        """Decode a chunked request body: hex-size-framed chunks up to
        the zero terminator (trailers skipped), with the same byte cap
        as fixed-length bodies."""
        body = b""
        while True:
            line = await asyncio.wait_for(reader.readline(),
                                          self._request_timeout_s)
            size_s = line.split(b";", 1)[0].strip()
            if not size_s:
                raise _HttpError(400, "missing chunk size")
            try:
                size = int(size_s, 16)
            except ValueError:
                raise _HttpError(400, f"bad chunk size: {size_s!r}")
            if size == 0:
                while True:          # optional trailers, then CRLF
                    t = await asyncio.wait_for(
                        reader.readline(), self._request_timeout_s)
                    if t in (b"\r\n", b"\n", b""):
                        return body
            if len(body) + size > _MAX_BODY:
                raise _HttpError(413, f"body over {_MAX_BODY} bytes")
            chunk = await asyncio.wait_for(
                reader.readexactly(size + 2), self._request_timeout_s)
            body += chunk[:-2]

    @staticmethod
    def _parse_submit(body: bytes) -> Dict[str, Any]:
        try:
            req = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            raise _HttpError(400, "body is not valid JSON")
        prompt = req.get("prompt")
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) for t in prompt):
            raise _HttpError(
                400, "prompt must be a non-empty list of token ids")
        kw: Dict[str, Any] = {"prompt": prompt}
        for key, cast in (("priority", int), ("max_new_tokens", int),
                          ("stop_token_id", int), ("timeout_s", float)):
            if req.get(key) is not None:
                try:
                    kw[key] = cast(req[key])
                except (TypeError, ValueError):
                    raise _HttpError(400, f"bad {key}: {req[key]!r}")
        return kw

    def _submit(self, kw: Dict[str, Any]):
        """Route one parsed request; maps backpressure/validation onto
        HTTP errors. Submission is a queue push behind short locks —
        safe to run on the event loop directly."""
        prompt = kw.pop("prompt")
        try:
            return self.router.submit(prompt, **kw)
        except QueueFullError as e:       # incl. NoReplicaAvailable
            raise _HttpError(429, str(e))
        except ValueError as e:
            raise _HttpError(400, str(e))
        except RuntimeError as e:         # router/engine shutting down
            raise _HttpError(503, str(e))

    async def _generate(self, writer, body: bytes,
                        ka: bool = False) -> None:
        try:
            # queue push behind short locks (see _submit)
            req = self._submit(self._parse_submit(body))
        except _HttpError as e:
            writer.write(_json_body(e.status, {"error": e.message},
                                    keep=ka))
            return
        while not req.done:
            if writer.transport is None or writer.transport.is_closing():
                # client gave up: don't keep burning a batch slot and
                # KV blocks generating tokens nobody will read
                req.cancel()
                return
            await asyncio.sleep(self._poll_s)
        status = _STATE_HTTP.get(req.state, 500)
        writer.write(_json_body(status, {
            "request_id": req.request_id,
            "replica": getattr(req, "replica_id", None),
            "state": req.state.name,
            "finish_reason": req.finish_reason,
            "tokens": list(req.tokens),
            "failovers": getattr(req, "router_failovers", 0),
            "error": None if req.error is None else repr(req.error),
        }, keep=ka))

    async def _stream_sse(self, writer, body: bytes,
                          ka: bool = False) -> None:
        try:
            # queue push behind short locks (see _submit)
            req = self._submit(self._parse_submit(body))
        except _HttpError as e:
            writer.write(_json_body(e.status, {"error": e.message},
                                    keep=ka))
            return
        # keep-alive SSE is chunked-framed so the stream has an
        # in-band terminator (the zero chunk) and the connection
        # survives; a close-requested stream is close-delimited
        frame = _chunk if ka else (lambda b: b)
        writer.write(_headers(200, "text/event-stream",
                              extra="Cache-Control: no-cache\r\n",
                              keep=ka, chunked=ka))
        writer.write(frame(_sse_event(
            {"request_id": req.request_id,
             "replica": getattr(req, "replica_id", None)},
            event="routed")))
        await writer.drain()
        # the bridge: `req.tokens` is append-only (engine-thread
        # writes, this task reads a snapshot length) — each tick ships
        # the new suffix, and the terminal check runs only after a
        # tick that shipped nothing new, so no token can be lost
        sent = 0
        try:
            while True:
                if writer.transport is None \
                        or writer.transport.is_closing():
                    req.cancel()        # client went away mid-stream
                    return
                n = len(req.tokens)
                if n > sent:
                    for t in req.tokens[sent:n]:
                        writer.write(frame(_sse_event({"token": int(t)})))
                    sent = n
                    await writer.drain()
                    continue
                if req.done:
                    break
                await asyncio.sleep(self._poll_s)
        except ConnectionError:
            # the write path saw the disconnect first: stop generating
            # for a reader that no longer exists, then let _handle's
            # connection boundary swallow the error
            req.cancel()
            raise
        writer.write(frame(_sse_event(
            {"request_id": req.request_id,
             "replica": getattr(req, "replica_id", None),
             "state": req.state.name,
             "finish_reason": req.finish_reason,
             "tokens_generated": len(req.tokens),
             "failovers": getattr(req, "router_failovers", 0),
             "error": None if req.error is None else repr(req.error)},
            event="error" if req.state in (RequestState.FAILED,
                                           RequestState.TIMED_OUT)
            else "done")))
        if ka:
            writer.write(b"0\r\n\r\n")   # chunked terminator

    async def _health(self, writer, ka: bool = False) -> None:
        # point-in-time snapshot under short locks
        h = self.router.health()
        serving = h.get("serving_replicas",
                        0 if h.get("status") == "UNHEALTHY" else 1)
        if serving:
            writer.write(_json_body(200, h, keep=ka))
            return
        # nobody serves right now — but RESTARTING and FAILED are
        # different outages: a slot behind the supervisor's readiness
        # gate is coming back (tell the load balancer to retry soon),
        # a breaker-pinned FAILED fleet is not. The JSON body carries
        # the per-slot supervisor detail either way.
        extra = ("Retry-After: 1\r\n"
                 if h.get("restarting_replicas", 0) else "")
        writer.write(_json_body(503, h, extra=extra, keep=ka))

    async def _metrics(self, writer, ka: bool = False) -> None:
        # rendering fans out across every replica's counters (and for a
        # Router, walks each slot's engine under its lock) — heavy
        # enough to stall concurrent token streams if it ran on the
        # event loop, so it renders on the default executor instead
        loop = asyncio.get_running_loop()
        text = await loop.run_in_executor(None,
                                          self.router.to_prometheus)
        body = text.encode()
        writer.write(_headers(200, "text/plain; version=0.0.4",
                              len(body), keep=ka) + body)

    async def _reset_breaker(self, writer, body: bytes,
                             ka: bool = False) -> None:
        """Operator recovery: revive a breaker-pinned FAILED slot —
        `Router.reset_breaker` behind JSON. The slot re-enters the
        readiness-gated recovery cycle; it does NOT serve until the
        probe passes."""
        try:
            req = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            writer.write(_json_body(400,
                                    {"error": "body is not valid JSON"}, keep=ka))
            return
        slot = req.get("replica") if req.get("replica") is not None \
            else req.get("slot")
        if slot is None:
            writer.write(_json_body(
                400, {"error": "pass \"slot\" (index) or \"replica\" "
                               "(id like \"r1\")"}, keep=ka))
            return
        reset = getattr(self.router, "reset_breaker", None)
        if reset is None:
            writer.write(_json_body(
                400, {"error": "backend has no reset_breaker "
                               "(bare engine, not a Router)"}, keep=ka))
            return
        try:
            # blocking-safe: state flips under short locks plus a
            # thread spawn — no engine rebuild happens on this call
            # short-lock state flip, no engine rebuild
            out = reset(slot)
        except LookupError as e:
            writer.write(_json_body(404, {"error": str(e)}, keep=ka))
            return
        except RuntimeError as e:        # no supervisor attached
            writer.write(_json_body(400, {"error": str(e)}, keep=ka))
            return
        status = 200 if out.get("reset") else 409
        payload = {"ok": bool(out.get("reset")), **out}
        if status == 409:
            payload["error"] = (
                f"slot {out.get('replica')} is {out.get('state')}, "
                f"not FAILED — nothing to reset")
        writer.write(_json_body(status, payload, keep=ka))

    async def _profile(self, writer, body: bytes,
                       ka: bool = False) -> None:
        """On-demand device-time capture: arm + await the capture
        window WITHOUT blocking the event loop (the wait runs on the
        default executor — token streaming keeps flowing while the
        fenced steps run)."""
        try:
            req = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            writer.write(_json_body(400,
                                    {"error": "body is not valid JSON"}, keep=ka))
            return
        try:
            steps = int(req.get("steps", 8))
            timeout_s = float(req.get("timeout_s", 30.0))
        except (TypeError, ValueError):
            writer.write(_json_body(
                400, {"error": "steps must be an int, timeout_s a "
                               "number"}, keep=ka))
            return
        # hard caps: a capture window fences EVERY device call it
        # covers and the wait pins an executor thread — an unbounded
        # request could tax the whole fleet's latency indefinitely
        if not 1 <= steps <= 1024 or not 0 < timeout_s <= 300:
            writer.write(_json_body(
                400, {"error": "steps must be in [1, 1024] and "
                               "timeout_s in (0, 300]"}, keep=ka))
            return
        cap = getattr(self.router, "capture_profile", None)
        if cap is None:
            writer.write(_json_body(
                400, {"error": "backend has no capture_profile"}, keep=ka))
            return
        loop = asyncio.get_running_loop()
        report = await loop.run_in_executor(
            None, lambda: cap(steps=steps, timeout=timeout_s))
        writer.write(_json_body(200, report, keep=ka))


class _HttpError(Exception):
    """Internal: an HTTP error response (status + message) raised by
    parsing/submission helpers and rendered by the handler."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message
