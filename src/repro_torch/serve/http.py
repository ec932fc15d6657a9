"""Asyncio HTTP serving front door over the continuous scheduler.

The port of ``repro.serve.http``, whole: ``FrontDoor`` turns the offline
``ContinuousScheduler`` into a network service without adding any
dependency: a hand-rolled HTTP/1.1 server on ``asyncio.start_server``
(stdlib only), one connection per request (``Connection: close``).  The
wire format is the reference's, so either package's client speaks to
either package's server.

Endpoints:

``POST /v1/generate``
    JSON body ``{"prompt": [int, ...], "max_new_tokens": int,
    "tenant"?: str, "priority"?: str, "stream"?: bool (default true),
    "ttft_deadline_s"?: float, "deadline_s"?: float}``.
    With ``stream`` (default) the response is Server-Sent Events:
    ``event: token`` frames carrying ``{"token": t, "index": i}`` with
    monotonically increasing ``id:`` lines, ``event: heartbeat`` keepalives
    every ``HttpConfig.heartbeat_s`` of silence, and a terminal
    ``event: done`` carrying ``finish_reason`` ("stop" | "length" |
    "cancelled" | "expired"), ``usage`` (prompt/completion token counts),
    and the full token list.  Without ``stream`` the response is one JSON
    document with the same terminal fields.  Errors: ``400`` malformed,
    ``429`` + ``Retry-After`` on backpressure (bounded admission queue) or
    a tenant over its rate limit, ``503`` while draining.
``GET /healthz``
    Liveness + queue depths.
``GET /v1/stats``
    Scheduler stats, per-tenant policy counters, the SLO controller's
    state when one is configured (per-class observed TTFT p50/p99,
    brownout level, shed + preemption counters per class), and (when
    tracing) the per-tenant priced tok/s + J/token report.

Threading model: the scheduler (its slot programs, CUDA graphs on the card,
and its host bookkeeping) runs in ONE dedicated worker thread
(:class:`SchedulerWorker`); the event loop never touches it directly, and
never touches the card: prompts stay host lists until the worker submits
them, and ``/healthz`` and ``/v1/stats`` read host counters only.  So a
graph the engine captures lazily on the worker (its first segment at a
shape) sees no other thread's CUDA call, which a capture would refuse.
The worker sets the engine's device as its current one and runs under
``torch.inference_mode`` (both are per thread), as the offline callers do.  Submissions cross over through a locked inbox drained
at segment boundaries (inbox order = admission order, which is what makes
the HTTP path reproduce the offline scheduler's arrival order);  tokens
cross back through a per-request ``asyncio.Queue`` mailbox fed with
``loop.call_soon_threadsafe`` from the scheduler's ``on_token`` callback
(same-thread FIFO ordering guarantees the mailbox preserves emission
order), and a terminal event is posted by the worker when the request's
handle goes terminal.

Client disconnects propagate to the scheduler: each streaming response
races its mailbox against a 1-byte read on the connection (EOF = the
client went away); on disconnect the handler calls ``Request.cancel()``,
which the scheduler honors at the next segment boundary — the slot and its
paged KV blocks return to the pool within one segment.

Backpressure is checked BEFORE admission: when inbox + scheduler queue
depth reaches ``HttpConfig.max_pending`` the request is rejected with
``429`` and a ``Retry-After`` derived from the worker's smoothed
per-request service time — nothing enters the scheduler.

Graceful drain (``FrontDoor.stop()``): stop accepting connections, answer
new generates ``503``, let the worker run the scheduler dry (in-flight
streams complete), then join the thread; past ``drain_timeout_s`` the
remaining requests are cancelled instead.

The module also ships the minimal asyncio client (``open_generate`` /
``read_sse_event`` / ``generate`` / ``http_get``) used by the tests, the
launcher's ``--smoke`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import json
import threading
import time

import torch

from repro_torch.serve.policy import Overloaded, RateLimited
from repro_torch.serve.request import Request, SubmitRequest
from repro_torch.utils.logging import get_logger

log = get_logger("serve.http")

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable",
}


@dataclasses.dataclass
class HttpConfig:
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral (FrontDoor.port reports the bound port)
    # admission bound: submissions waiting in the inbox + scheduler queue;
    # at or past this depth new generates get 429 + Retry-After
    max_pending: int = 64
    heartbeat_s: float = 10.0  # SSE keepalive cadence while no tokens flow
    retry_after_floor_s: float = 1.0  # minimum Retry-After hint
    drain_timeout_s: float = 30.0  # stop(): drain budget before cancelling
    max_body_bytes: int = 1 << 20
    idle_wait_s: float = 0.05  # worker poll while the scheduler is empty


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def _dumps(payload) -> bytes:
    return json.dumps(payload, default=_json_default).encode()


class SchedulerWorker:
    """Owns the scheduler on a dedicated thread: drains the submission
    inbox, runs segments while there is work, and posts per-request token
    and terminal events back into the event loop."""

    def __init__(self, sched, loop: asyncio.AbstractEventLoop,
                 idle_wait_s: float = 0.05):
        self.sched = sched
        self.loop = loop
        self.idle_wait_s = idle_wait_s
        self._inbox: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._watch: list[tuple[Request, asyncio.Queue]] = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sched-worker")
        self.error: BaseException | None = None
        # smoothed per-retired-request service time, for Retry-After hints
        self._req_s = 0.25
        # analytic drain predictor: roofline model time over the live queue
        # composition, scaled by a measured/model calibration EWMA.  None
        # for schedulers that don't expose one (the tests' stub) or until
        # the first finished request calibrates the scale; the EWMA formula
        # above is the fallback either way.
        try:
            self._predictor = sched.drain_predictor()
        except AttributeError:
            self._predictor = None
        self._drain_s: float | None = None
        self._drain_sig: tuple | None = None

    # -- event-loop side ---------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def pending(self) -> int:
        """Requests waiting for a slot: inbox + scheduler queue.  Reading
        the deque lengths cross-thread is safe (single atomic read each)."""
        return len(self._inbox) + len(self.sched.queue)

    def retry_after(self, pending: int, floor: float) -> float:
        """Backpressure hint.  Preferred source: the calibrated analytic
        drain prediction over the scheduler's current queue composition
        (queued + resident work through the roofline cost model, scaled by
        the measured/model EWMA).  Fallback before calibration: ``pending``
        requests through ``n_slots`` servers at the smoothed per-request
        service time."""
        if self._drain_s is not None:
            return round(max(floor, self._drain_s), 2)
        n = max(getattr(self.sched, "n_slots", 1), 1)
        return round(max(floor, pending * self._req_s / n), 2)

    def submit(self, sub: SubmitRequest,
               mailbox: asyncio.Queue | None) -> concurrent.futures.Future:
        """Thread-safe submission; the future resolves to the ``Request``
        handle (or the scheduler's ValueError/RateLimited)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self.error is not None:  # the worker died: nothing drains the inbox
                fut.set_exception(self.error)
                return fut
            self._inbox.append((sub, fut, mailbox))
        self._wake.set()
        return fut

    def wake(self) -> None:
        """Nudge the worker (e.g. after a cancellation while it idles)."""
        self._wake.set()

    def request_stop(self) -> None:
        """Ask the worker to exit once the scheduler runs dry."""
        self._stop.set()
        self._wake.set()

    def cancel_all(self) -> None:
        """Drain-timeout escape hatch: cancel everything still live."""
        for req, _q in list(self._watch):
            req.cancel()
        self._wake.set()

    # -- worker-thread side ------------------------------------------------

    def _post(self, mailbox: asyncio.Queue, item) -> None:
        self.loop.call_soon_threadsafe(mailbox.put_nowait, item)

    def _drain_inbox(self) -> None:
        while True:
            with self._lock:
                if not self._inbox:
                    return
                sub, fut, mailbox = self._inbox.popleft()
            try:
                req = self.sched.submit(sub)
            except BaseException as e:  # ValueError / RateLimited -> client
                fut.set_exception(e)
                continue
            fut.set_result(req)
            if mailbox is not None:
                self._watch.append((req, mailbox))

    def _pump_terminals(self) -> None:
        live = []
        for req, mailbox in self._watch:
            if req.terminal:
                if (self._predictor is not None and req.done
                        and req.latency is not None and req.tokens):
                    self._predictor.observe(req.prompt_len, len(req.tokens),
                                            req.latency)
                self._post(mailbox, ("done",))
            else:
                live.append((req, mailbox))
        self._watch = live

    def _update_drain(self) -> None:
        """Refresh the cached drain prediction when the scheduler's queue
        composition changed (signature = count + token sums, cheap to
        compare; the model evaluation behind it is the expensive part)."""
        if self._predictor is None or not self._predictor.calibrated:
            return
        comp = getattr(self.sched, "queue_composition", None)
        if comp is None:
            return
        plens, news = comp()
        sig = (len(plens), sum(plens), sum(news))
        if sig == self._drain_sig:
            return
        self._drain_sig = sig
        self._drain_s = self._predictor.drain_s(plens, news)

    def _run(self) -> None:
        device = getattr(getattr(self.sched, "engine", None), "device", None)
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)  # the current device is per thread
            with torch.inference_mode():
                self._loop()
        except BaseException as e:  # scheduler invariant failure: fail fast
            log.error("scheduler worker died: %r", e)
            for req, mailbox in self._watch:
                req.cancel()
                self._post(mailbox, ("error", repr(e)))
            self._watch = []
            with self._lock:
                self.error = e  # later submissions fail at once (``submit``)
                inbox, self._inbox = list(self._inbox), collections.deque()
            for _sub, fut, _mb in inbox:
                fut.set_exception(e)

    def _loop(self) -> None:
        while True:
            self._drain_inbox()
            if self.sched.has_work():
                t0 = time.perf_counter()
                r0 = self.sched.stats.get("retired", 0)
                self.sched.run_segment()
                retired = self.sched.stats.get("retired", 0) - r0
                if retired > 0:
                    per = (time.perf_counter() - t0) / retired
                    self._req_s = 0.8 * self._req_s + 0.2 * per
                self._pump_terminals()
                self._update_drain()
            elif self._stop.is_set():
                with self._lock:
                    if not self._inbox:
                        return
            else:
                self._wake.wait(self.idle_wait_s)
                self._wake.clear()


class FrontDoor:
    """The asyncio HTTP server bridging connections to the scheduler
    worker.  Duck-typed over the scheduler: anything exposing ``submit`` /
    ``run_segment`` / ``has_work`` / ``queue`` / ``stats`` works (the test
    suite drives it with a stub)."""

    def __init__(self, sched, cfg: HttpConfig | None = None):
        self.sched = sched
        self.cfg = cfg or HttpConfig()
        self.worker: SchedulerWorker | None = None
        self.draining = False
        self.port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._t0 = None  # serving wall-clock origin, for per-tenant tok/s
        self.stats = {
            "http_requests": 0,
            "accepted": 0,
            "rejected_backpressure": 0,
            "rejected_rate": 0,
            "rejected_shed": 0,
            "bad_requests": 0,
            "disconnects": 0,
            "completed": 0,
        }

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.worker = SchedulerWorker(self.sched, loop,
                                      idle_wait_s=self.cfg.idle_wait_s)
        self.worker.start()
        self._server = await asyncio.start_server(
            self._handle_conn, self.cfg.host, self.cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._t0 = time.perf_counter()
        log.info("front door listening on %s:%d", self.cfg.host, self.port)

    async def stop(self) -> None:
        """Graceful drain: stop accepting, let in-flight work finish, then
        join the worker (cancelling leftovers past the drain timeout)."""
        self.draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self.worker is None:
            return
        self.worker.request_stop()
        deadline = time.perf_counter() + self.cfg.drain_timeout_s
        while self.worker.is_alive() and time.perf_counter() < deadline:
            await asyncio.sleep(0.02)
        if self.worker.is_alive():
            log.warning("drain timed out after %.1fs — cancelling leftovers",
                        self.cfg.drain_timeout_s)
            self.worker.cancel_all()
            deadline = time.perf_counter() + 5.0
            while self.worker.is_alive() and time.perf_counter() < deadline:
                await asyncio.sleep(0.02)

    # ------------------------------------------------------------- plumbing

    def _respond(self, writer, status: int, body: bytes,
                 content_type: str = "application/json",
                 extra: dict | None = None) -> None:
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, '')}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        for k, v in (extra or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)

    async def _handle_conn(self, reader, writer) -> None:
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), 30.0)
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    asyncio.LimitOverrunError):
                return
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, path, _ = lines[0].split(" ", 2)
            except ValueError:
                self._respond(writer, 400, _dumps({"error": "bad request line"}))
                return
            headers = {}
            for line in lines[1:]:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            n_body = int(headers.get("content-length", "0") or 0)
            if n_body > self.cfg.max_body_bytes:
                self._respond(writer, 413, _dumps({"error": "body too large"}))
                return
            body = await reader.readexactly(n_body) if n_body else b""
            await self._route(reader, writer, method, path, body)
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass  # client went away mid-exchange
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _route(self, reader, writer, method: str, path: str,
                     body: bytes) -> None:
        self.stats["http_requests"] += 1
        if path == "/v1/generate":
            if method != "POST":
                self._respond(writer, 405, _dumps({"error": "POST only"}))
                return
            await self._generate(reader, writer, body)
        elif path == "/healthz" and method == "GET":
            queued = len(self.sched.queue)
            running = sum(r is not None for r in self.sched.slots)
            self._respond(writer, 200, _dumps({
                "status": "draining" if self.draining else "ok",
                "queued": queued, "running": running,
                "pending": self.worker.pending if self.worker else 0,
                "retired": self.sched.stats.get("retired", 0),
            }))
        elif path == "/v1/stats" and method == "GET":
            self._respond(writer, 200, _dumps(self._stats_payload()))
        else:
            self._respond(writer, 404, _dumps({"error": f"no route {path}"}))

    def _stats_payload(self) -> dict:
        out = {"front_door": dict(self.stats),
               "scheduler": dict(self.sched.stats)}
        policy = getattr(self.sched, "policy", None)
        if policy is not None:
            out["tenants"] = policy.snapshot()
            slo = policy.slo_snapshot()
            if slo is not None:
                slo["preemptions_by_class"] = dict(
                    self.sched.stats.get("preemptions_by_class", {}))
                out["slo"] = slo
        trace = getattr(self.sched, "trace", None)
        if trace is not None:
            from repro_torch.serve.trace import tenant_report, trace_energy

            wall = time.perf_counter() - self._t0
            energy = trace_energy(trace, weight_sparsity=0.75,
                                  act_sparsity=0.5, platforms=("SONIC",))
            out["tenant_pricing"] = tenant_report(trace, energy, wall_s=wall)
        return out

    # ------------------------------------------------------------- generate

    def _parse_generate(self, body: bytes) -> SubmitRequest:
        try:
            payload = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"invalid JSON body: {e}") from e
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        prompt = payload.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError("'prompt' must be a non-empty list of token ids")
        mnt = payload.get("max_new_tokens")
        if not isinstance(mnt, int):
            raise ValueError("'max_new_tokens' must be an integer")
        for key in ("tenant", "priority"):
            v = payload.get(key)
            if v is not None and not isinstance(v, str):
                raise ValueError(f"'{key}' must be a string")
        for key in ("ttft_deadline_s", "deadline_s"):
            v = payload.get(key)
            if v is not None and not isinstance(v, (int, float)):
                raise ValueError(f"'{key}' must be a number")
        sub = SubmitRequest(
            prompt=prompt, max_new_tokens=mnt,
            ttft_deadline_s=payload.get("ttft_deadline_s"),
            deadline_s=payload.get("deadline_s"),
            tenant=payload.get("tenant"), priority=payload.get("priority"),
        )
        sub.stream = bool(payload.get("stream", True))  # riding attribute
        return sub

    def _done_payload(self, req: Request) -> dict:
        return {
            "rid": req.rid,
            "finish_reason": req.finish_reason or req.state,
            "state": req.state,
            "tokens": list(req.tokens),
            "usage": {"prompt_tokens": req.prompt_len,
                      "completion_tokens": len(req.tokens)},
            "ttft_s": req.ttft,
            "latency_s": req.latency,
        }

    async def _generate(self, reader, writer, body: bytes) -> None:
        if self.draining or self.worker is None:
            self._respond(writer, 503, _dumps({"error": "draining"}))
            return
        try:
            sub = self._parse_generate(body)
        except ValueError as e:
            self.stats["bad_requests"] += 1
            self._respond(writer, 400, _dumps({"error": str(e)}))
            return
        # backpressure BEFORE admission: nothing of this request reaches
        # the scheduler when the bounded queue is full (the depth check and
        # the inbox append below run without an await between them, so
        # concurrent handlers cannot oversubscribe the bound)
        pending = self.worker.pending
        if pending >= self.cfg.max_pending:
            self.stats["rejected_backpressure"] += 1
            retry = self.worker.retry_after(pending,
                                            self.cfg.retry_after_floor_s)
            self._respond(writer, 429,
                          _dumps({"error": "overloaded",
                                  "retry_after_s": retry}),
                          extra={"Retry-After": str(max(1, round(retry)))})
            return
        mailbox: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        sub.on_token = lambda _req, tok: loop.call_soon_threadsafe(
            mailbox.put_nowait, ("token", tok))
        fut = self.worker.submit(sub, mailbox)
        try:
            req = await asyncio.wrap_future(fut)
        except RateLimited as e:
            # brownout sheds ride the RateLimited surface (Overloaded is a
            # subclass) but are counted apart and carry a Retry-After from
            # the worker's drain prediction when that beats the shed hint
            shed = isinstance(e, Overloaded)
            self.stats["rejected_shed" if shed else "rejected_rate"] += 1
            retry = e.retry_after_s
            if shed:
                retry = max(retry, self.worker.retry_after(
                    self.worker.pending, self.cfg.retry_after_floor_s))
            payload = {"error": str(e), "retry_after_s": retry}
            if shed:
                payload["brownout_level"] = e.level
            self._respond(writer, 429, _dumps(payload),
                          extra={"Retry-After": str(max(1, round(retry)))})
            return
        except ValueError as e:
            self.stats["bad_requests"] += 1
            self._respond(writer, 400, _dumps({"error": str(e)}))
            return
        self.stats["accepted"] += 1
        if sub.stream:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
        # race the mailbox against client disconnect: a well-behaved client
        # sends nothing after the request, so any read completion (EOF or
        # stray bytes) means it is gone and the slot should be reclaimed
        consume = asyncio.ensure_future(
            self._consume(req, mailbox, writer, sub.stream))
        monitor = asyncio.ensure_future(reader.read(1))
        done, _ = await asyncio.wait({consume, monitor},
                                     return_when=asyncio.FIRST_COMPLETED)
        if consume in done and consume.exception() is None:
            monitor.cancel()
            await asyncio.gather(monitor, return_exceptions=True)
            self.stats["completed"] += 1
            return
        # disconnect (monitor fired) or a failed write mid-stream: cancel
        # the request so the scheduler reclaims the slot + blocks at the
        # next segment boundary
        consume.cancel()
        await asyncio.gather(consume, monitor, return_exceptions=True)
        self.stats["disconnects"] += 1
        req.cancel()
        self.worker.wake()

    async def _consume(self, req: Request, mailbox: asyncio.Queue,
                       writer, stream: bool) -> None:
        """Forward mailbox events to the client until the terminal event.
        Streaming: SSE frames as they arrive.  Non-streaming: one JSON
        document at the end."""
        eid = 0
        while True:
            try:
                msg = await asyncio.wait_for(mailbox.get(),
                                             self.cfg.heartbeat_s)
            except asyncio.TimeoutError:
                if stream:
                    writer.write(b"event: heartbeat\ndata: {}\n\n")
                    await writer.drain()
                continue
            kind = msg[0]
            if kind == "token":
                if stream:
                    data = json.dumps({"token": msg[1], "index": eid})
                    writer.write(f"id: {eid}\nevent: token\n"
                                 f"data: {data}\n\n".encode())
                    await writer.drain()
                eid += 1
            elif kind == "done":
                payload = self._done_payload(req)
                if stream:
                    writer.write(f"id: {eid}\nevent: done\n".encode()
                                 + b"data: " + _dumps(payload) + b"\n\n")
                else:
                    self._respond(writer, 200, _dumps(payload))
                await writer.drain()
                return
            else:  # ("error", msg): the scheduler worker died
                if stream:
                    writer.write(f"id: {eid}\nevent: error\n".encode()
                                 + b"data: " + _dumps({"error": msg[1]})
                                 + b"\n\n")
                else:
                    self._respond(writer, 500, _dumps({"error": msg[1]}))
                await writer.drain()
                return


# --------------------------------------------------------------- client

async def _read_response_head(reader) -> tuple[int, dict]:
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ", 2)[1])
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return status, headers


async def read_sse_event(reader) -> dict | None:
    """One SSE event as ``{"id"?, "event", "data"}`` (data JSON-decoded
    when possible); ``None`` at end of stream."""
    fields: dict = {}
    while True:
        try:
            line = await reader.readline()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        if not line:  # EOF
            return fields or None
        line = line.rstrip(b"\r\n").decode()
        if not line:
            if fields:
                return fields
            continue  # leading blank
        if line.startswith(":"):
            continue  # comment/keepalive
        key, _, value = line.partition(":")
        value = value.removeprefix(" ")
        if key == "data":
            try:
                value = json.loads(value)
            except json.JSONDecodeError:
                pass
        elif key == "id":
            value = int(value)
        fields[key] = value


async def open_generate(host: str, port: int, payload: dict):
    """POST /v1/generate and read the response head; returns
    ``(reader, writer, status, headers)`` with the body left unread (SSE
    events via :func:`read_sse_event`, JSON via ``reader.readexactly``)."""
    reader, writer = await asyncio.open_connection(host, port)
    body = _dumps(payload)
    writer.write(
        (f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
         f"Content-Type: application/json\r\n"
         f"Content-Length: {len(body)}\r\n"
         f"Connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    status, headers = await _read_response_head(reader)
    return reader, writer, status, headers


async def generate(host: str, port: int, payload: dict) -> dict:
    """Full round-trip: returns ``{"status", "headers", "events", "body",
    "ttft_s"}`` — SSE events collected to the terminal one (``body`` is the
    done/error payload), plain JSON responses parsed into ``body``."""
    t0 = time.perf_counter()
    reader, writer, status, headers = await open_generate(host, port, payload)
    out = {"status": status, "headers": headers, "events": [], "body": None,
           "ttft_s": None}
    try:
        if headers.get("content-type", "").startswith("text/event-stream"):
            while True:
                ev = await read_sse_event(reader)
                if ev is None:
                    break
                out["events"].append(ev)
                if ev.get("event") == "token" and out["ttft_s"] is None:
                    out["ttft_s"] = time.perf_counter() - t0
                if ev.get("event") in ("done", "error"):
                    out["body"] = ev.get("data")
                    break
        else:
            n = int(headers.get("content-length", "0") or 0)
            raw = await reader.readexactly(n) if n else await reader.read()
            if raw:
                out["body"] = json.loads(raw)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
    return out


async def http_get(host: str, port: int, path: str) -> dict:
    """GET helper for /healthz and /v1/stats."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                 f"Connection: close\r\n\r\n".encode())
    await writer.drain()
    status, headers = await _read_response_head(reader)
    n = int(headers.get("content-length", "0") or 0)
    raw = await reader.readexactly(n) if n else await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionResetError, BrokenPipeError, OSError):
        pass
    return {"status": status, "headers": headers,
            "body": json.loads(raw) if raw else None}
