"""JSON-over-HTTP scaffolding shared by every serving endpoint.

Counterpart of ``deeplearning4j_tpu/serving/http.py``, copied: the module
has no framework in it. Stdlib-only (ThreadingHTTPServer): routes are
``{path: fn(body) -> payload}`` plus *dynamic* routes — ``(label,
match_fn, handler)`` triples for parameterized paths like
``/v1/<model>/predict`` — so the gateway can route per-model without
registering a handler per model. Handlers signal non-200 outcomes by
raising :class:`HttpError` (status code + optional response headers, e.g.
``Retry-After`` on 429 backpressure); any other exception is a 400 at the
serving boundary.

Every server also answers ``GET /metrics`` with the port's process-wide
Prometheus exposition (``monitoring.metrics_text()``), and — when
monitoring is enabled — records per-route request latency and an in-flight
gauge. Dynamic routes are observed under their *label* (``/v1/*/predict``),
not the raw path, so metric cardinality stays bounded no matter how many
models are registered.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.monitoring import flight


def _record_gateway_error(route: str, exc: BaseException) -> None:
    """Flight-record an UNHANDLED handler exception (HttpErrors are
    intentional outcomes, not incidents) — a dump-trigger kind."""
    rec = flight.recorder()
    if rec is not None:
        rec.record("gateway_error", severity="error", route=route,
                   error=f"{type(exc).__name__}: {exc}")


class HttpError(Exception):
    """A handler-raised HTTP outcome: status code, JSON error payload, and
    optional extra response headers (e.g. ``{"Retry-After": "1"}``)."""

    def __init__(self, code: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.code = int(code)
        self.message = message
        self.headers = dict(headers or {})


class StreamingResponse:
    """Marker return type for handlers that stream their response.

    ``lines`` is an iterable of JSON-able dicts, written as newline-
    delimited JSON (ndjson) with a flush per line — the client sees tokens
    as they are produced. Delimiting is connection-close (HTTP/1.0 style):
    no Content-Length, ``Connection: close`` — which stdlib http.client,
    curl, and every load balancer understand without chunked-encoding
    machinery.

    ``on_finish`` runs EXACTLY once when the stream ends for any reason —
    fully written, client disconnect, or handler error. It is where the
    gateway releases its in-flight slot and cancels an abandoned upstream
    generation, so graceful drain can count streams, not just one-shot
    requests.
    """

    def __init__(self, lines, on_finish: Optional[Callable[[], None]] = None,
                 content_type: str = "application/x-ndjson"):
        self._lines = lines
        self._on_finish = on_finish
        self.content_type = content_type
        self._finished = False

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if self._on_finish is not None:
            self._on_finish()

    def __iter__(self):
        try:
            for d in self._lines:
                yield (json.dumps(d) + "\n").encode()
        finally:
            self.finish()


class _HttpServerMixin:
    """Shared ephemeral-port resolution and shutdown for the HTTP servers."""

    _httpd = None
    _thread = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def _stop_httpd(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


# (label-for-metrics, path -> params-or-None, handler(params, body))
DynamicRoute = Tuple[str, Callable[[str], Optional[dict]],
                     Callable[[dict, dict], dict]]


def serve_json(host, port, post_routes, get_routes,
               dynamic_post: Optional[List[DynamicRoute]] = None,
               dynamic_get: Optional[List[DynamicRoute]] = None):
    """Start a threaded JSON HTTP server; returns (httpd, thread) — call
    httpd.shutdown()/server_close() to stop."""
    dynamic_post = dynamic_post or []
    dynamic_get = dynamic_get or []

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload, headers=None):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _stream_reply(self, resp: StreamingResponse):
            self.send_response(200)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.close_connection = True
            self.end_headers()
            try:
                for chunk in resp:
                    self.wfile.write(chunk)
                    self.wfile.flush()
            finally:
                # client aborts surface as write errors above; either way
                # the stream's on_finish must run (drain accounting/cancel)
                resp.finish()

        def _match(self, routes, dynamic):
            path = self.path.split("?")[0]
            fn = routes.get(path)
            if fn is not None:
                return path, fn
            for label, match, handler in dynamic:
                params = match(path)
                if params is not None:
                    # dynamic handlers get the request headers under
                    # "_headers" (case-insensitive Message mapping) — the
                    # tenancy layer reads X-Api-Key from here
                    return label, (lambda body, h=handler, p=params,
                                   hd=self.headers:
                                   h(dict(p, _headers=hd), body))
            return path, None

        def _route(self, routes, dynamic, body):
            label, fn = self._match(routes, dynamic)
            if fn is None:
                self._reply(404, {"error": "unknown endpoint"})
                return
            mon = monitoring.serving_monitor()
            if mon is None:
                try:
                    payload = fn(body)
                except HttpError as e:
                    self._reply(e.code, {"error": e.message}, e.headers)
                    return
                except Exception as e:  # noqa: BLE001 — serving boundary
                    _record_gateway_error(label, e)
                    self._reply(400, {"error": str(e)})
                    return
                if isinstance(payload, StreamingResponse):
                    self._stream_reply(payload)
                else:
                    self._reply(200, payload)
                return
            mon.in_flight.inc()
            t0 = time.perf_counter()
            code, headers = 200, None
            try:
                payload = fn(body)
            except HttpError as e:
                code, payload = e.code, {"error": e.message}
                headers = e.headers
            except Exception as e:  # noqa: BLE001 — serving boundary
                _record_gateway_error(label, e)
                code, payload = 400, {"error": str(e)}
            finally:
                mon.in_flight.dec()
            if isinstance(payload, StreamingResponse):
                # latency for a stream is time-to-last-token, observed after
                # the stream is fully written (or the client went away)
                self._stream_reply(payload)
                mon.request_seconds.labels(route=label, code=code).observe(
                    time.perf_counter() - t0)
                return
            mon.request_seconds.labels(route=label, code=code).observe(
                time.perf_counter() - t0)
            self._reply(code, payload, headers)

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except Exception as e:  # noqa: BLE001
                self._reply(400, {"error": str(e)})
                return
            self._route(post_routes, dynamic_post, body)

        def do_GET(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                # ?exemplars=1 upgrades the scrape to OpenMetrics with
                # exemplars on histogram buckets (trace-id backlinks); the
                # default scrape stays plain text format 0.0.4
                want_ex = parse_qs(query).get("exemplars", ["0"])[0].lower() \
                    not in ("", "0", "false", "off", "no")
                data = monitoring.metrics_text(exemplars=want_ex).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8" if want_ex
                    else "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._route(get_routes, dynamic_get, {})

        def handle_one_request(self):
            # a client that times out / resets mid-write is business as
            # usual at the serving boundary, not a stack trace
            try:
                super().handle_one_request()
            except (ConnectionResetError, BrokenPipeError):
                self.close_connection = True

        def log_message(self, *args):
            pass

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 resets connections
        # under bursty client fleets before admission control ever sees
        # them; backpressure must come from 429s, not TCP RSTs
        request_queue_size = 128
        daemon_threads = True

    httpd = Server((host, port), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


# the JAX package's pre-gateway name, kept so callers of either package
# find it
_serve_json = serve_json
