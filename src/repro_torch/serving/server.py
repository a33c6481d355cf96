"""Threaded HTTP/JSON front end over :class:`SimRankService` (stdlib only;
port of ``repro.serving.server``, the same routes, statuses and client).

The server is deliberately thin: sockets, routing, JSON framing, and the
HTTP translation of service outcomes (200 envelope, 400 protocol, 429
admission + ``Retry-After``, 503 shutdown, 504 deadline shed).  All
serving policy — micro-batch windows, admission bounds, tenant routing,
update serialization — lives in ``serving/service.py``; all wire schema
lives in ``serving/protocol.py``.

Routes::

    POST /query    body: protocol.parse_query_request schema
    POST /update   body: protocol.parse_update_request schema
    GET  /stats    service counters + per-tenant session stats
    GET  /healthz  liveness / backend / graph version

Tenancy rides the ``X-Tenant`` header (default tenant when absent); each
tenant gets its own session/PRNG/stats namespace over the one shared
graph (see ``SimRankService.session``).

Admission is fair per connection: a query is enqueued with the
connection's address, so connections turned away with 429 wait in line
for freed slots, first turned away first admitted
(``SimRankService.enqueue``), which the reference's server does not do;
a connection leaves the line when it closes.

Concurrency model: ``ThreadingHTTPServer`` gives every connection a
handler thread, but handler threads only parse, enqueue and wait — every
device dispatch happens on the service's collector thread (or a straggler
worker it starts), so N concurrent clients never launch concurrently and
their queries fuse into lane-batched steps.  ``request_queue_size`` is
raised well above the admission bound so a thundering herd meets the 429
path, not a TCP RST.

:class:`ServiceClient` is the matching stdlib client (keep-alive
``http.client`` with retry-on-429 honoring ``Retry-After``) used by the
load bench, the README quickstart and the tests.
"""
from __future__ import annotations

import http.client
import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serving.protocol import (
    ProtocolError,
    parse_query_request,
    parse_update_request,
)
from repro_torch.serving.service import (
    DEFAULT_TENANT,
    AdmissionError,
    ServiceClosed,
    SimRankService,
    validate_tenant,
)

MAX_BODY_BYTES = 64 * 1024 * 1024  # 413 past this, before reading it all


class SimRankHTTPServer(ThreadingHTTPServer):
    """One service behind a threading HTTP server.

    ``daemon_threads`` so a hung client never blocks shutdown;
    ``request_queue_size`` sized for a connect herd larger than
    ``max_inflight`` (backpressure is the service's 429, not a refused
    TCP connection).
    """

    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 1024

    def __init__(self, addr, service: SimRankService):
        self.service = service
        super().__init__(addr, _Handler)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: the bench reuses sockets
    server: SimRankHTTPServer

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # noqa: D102 — stderr spam off
        pass

    def finish(self) -> None:
        # the connection is closing: it leaves the admission line
        try:
            super().finish()
        finally:
            self.server.service.forget_client(self.client_address)

    def _send_json(self, status: int, payload: dict, headers=()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gave up (deadline'd out); nothing to salvage

    def _read_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            raise ProtocolError(
                f"body of {length} bytes exceeds the {MAX_BODY_BYTES} limit"
            )
        raw = self.rfile.read(length)
        try:
            return json.loads(raw) if raw else {}
        except json.JSONDecodeError as e:
            raise ProtocolError(f"body is not valid JSON: {e}") from None

    def _tenant(self) -> str:
        return validate_tenant(
            self.headers.get("X-Tenant", DEFAULT_TENANT)
        )

    # -- routes --------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        svc = self.server.service
        if self.path == "/healthz":
            self._send_json(200, svc.healthz())
        elif self.path == "/stats":
            self._send_json(200, svc.stats_snapshot())
        else:
            self._send_json(404, {"error": f"no such route: GET {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        svc = self.server.service
        try:
            if self.path == "/query":
                req = parse_query_request(self._read_json())
                status, payload = svc.serve_request(
                    req, self._tenant(), client=self.client_address
                )
                self._send_json(status, payload)
            elif self.path == "/update":
                inserts, deletes = parse_update_request(self._read_json())
                self._send_json(200, svc.apply_update(inserts, deletes))
            else:
                self._send_json(
                    404, {"error": f"no such route: POST {self.path}"}
                )
        except ProtocolError as e:
            self._send_json(400, {"error": str(e)})
        except AdmissionError as e:
            self._send_json(
                429,
                {"error": str(e), "retry_after_s": e.retry_after_s},
                headers=[("Retry-After", str(max(1, round(e.retry_after_s))))],
            )
        except ServiceClosed as e:
            self._send_json(503, {"error": str(e)})
        except Exception as e:  # a handler thread must never die silently
            svc.stats.errors_5xx += 1
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


def start_server(
    service: SimRankService,
    host: str = "127.0.0.1",
    port: int = 0,
) -> tuple[SimRankHTTPServer, threading.Thread]:
    """Bind and serve in a daemon thread; returns (server, thread).

    ``port=0`` picks a free port (read it back from
    ``server.server_address``).  Shut down with :func:`stop_server` —
    it closes the service (flushing in-flight requests) before the
    socket, so no accepted request is dropped on the floor.
    """
    server = SimRankHTTPServer((host, port), service)
    thread = threading.Thread(
        target=server.serve_forever, daemon=True,
        name="probesim-http",
    )
    thread.start()
    return server, thread


def stop_server(
    server: SimRankHTTPServer, thread: threading.Thread | None = None
) -> None:
    """Graceful shutdown: drain the service, then stop accepting."""
    server.service.close()
    server.shutdown()
    server.server_close()
    if thread is not None:
        thread.join(timeout=10.0)


class ServiceClient:
    """Keep-alive stdlib client for one server — the bench/test harness.

    One instance per client thread (``http.client`` connections are not
    thread-safe).  ``query()`` retries 429s honoring the service's
    ``retry_after_s`` hint up to ``max_retries`` times, then surfaces the
    429 — so closed-loop load generators exercise backpressure without
    hand-rolling backoff.
    """

    def __init__(
        self,
        host: str,
        port: int,
        tenant: str = DEFAULT_TENANT,
        timeout_s: float = 120.0,
        max_retries: int = 64,
    ):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self._conn: http.client.HTTPConnection | None = None

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s
            )
        return self._conn

    def _request(
        self, method: str, path: str, body: dict | None = None
    ) -> tuple[int, dict]:
        payload = None if body is None else json.dumps(body).encode()
        headers = {"X-Tenant": self.tenant}
        if payload is not None:
            headers["Content-Type"] = "application/json"
        for attempt in (0, 1):  # one transparent reconnect on a stale socket
            conn = self._connection()
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, (json.loads(data) if data else {})
            except (
                http.client.HTTPException, ConnectionError, OSError,
            ):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def query(self, **fields) -> dict:
        """POST /query; kwargs are the wire fields (node=, kind=, ...).

        Returns the response payload; raises ``RuntimeError`` on any
        terminal non-200 (after 429 retries are exhausted)."""
        for _ in range(self.max_retries + 1):
            status, payload = self._request("POST", "/query", fields)
            if status == 429:
                # jitter on top of the service's hint: a herd of clients
                # rejected together must not retry together
                hint = float(payload.get("retry_after_s", 0.05))
                time.sleep(max(hint, 0.02) * (0.75 + 0.5 * random.random()))
                continue
            if status != 200:
                raise RuntimeError(
                    f"POST /query -> {status}: {payload.get('error')}"
                )
            return payload
        raise RuntimeError(
            f"POST /query still 429 after {self.max_retries} retries"
        )

    def query_raw(self, **fields) -> tuple[int, dict]:
        """POST /query without retries: (status, payload) as-is."""
        return self._request("POST", "/query", fields)

    def update(self, inserts=None, deletes=None) -> dict:
        body = {}
        if inserts is not None:
            body["inserts"] = [[int(s), int(d)] for s, d in inserts]
        if deletes is not None:
            body["deletes"] = [[int(s), int(d)] for s, d in deletes]
        status, payload = self._request("POST", "/update", body)
        if status != 200:
            raise RuntimeError(
                f"POST /update -> {status}: {payload.get('error')}"
            )
        return payload

    def stats(self) -> dict:
        status, payload = self._request("GET", "/stats")
        if status != 200:
            raise RuntimeError(f"GET /stats -> {status}")
        return payload

    def healthz(self) -> dict:
        status, payload = self._request("GET", "/healthz")
        if status != 200:
            raise RuntimeError(f"GET /healthz -> {status}")
        return payload

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
