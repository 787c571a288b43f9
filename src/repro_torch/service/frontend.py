"""Stdlib HTTP/JSON front end over the async counting service (a copy of
the JAX package's ``service/frontend.py`` over the port's ``CountQuery``).

Zero-dependency (``http.server``) so the serving story ships with the
repo, not with a framework. Each request thread talks to the
:class:`~repro_torch.service.async_loop.AsyncCountingService` through its
thread-safe ``submit``/``wait``/``result`` API; the dispatcher thread
owns all device work.

Endpoints
---------
``POST /count``
    Body is a JSON :class:`~repro_torch.api.CountQuery` plus QoS/transport
    fields::

        {"graph": "g",
         "templates": ["u5", [[0,1],[1,2],[1,3]],
                       {"edges": [[0,1],[1,2]], "root": 0}],
         "rel_stderr": 0.1, "max_iters": 64, "seed": 0,
         "engine": "pgbsc", "plan": "optimized",
         "qos": {"class": "interactive", "tenant": "alice",
                 "weight": 2.0, "deadline_s": 5.0},
         "wait": true, "timeout_s": 60}

    Template entries may be registry names, raw edge lists, or
    ``{edges, root, name}`` dicts (everything ``TemplateSpec.of``
    accepts). One service request is submitted per template; they share
    dispatch groups/caches exactly like native requests. With
    ``wait=true`` (default) the response carries each template's result;
    with ``wait=false`` it returns request ids for later polling.
    Status 200 = all done, 202 = accepted (not waited / not finished),
    429 = every template was shed (``Retry-After`` hints backoff),
    207-style mixed outcomes report per-request status in the body.

``GET /result/<rid>``
    Status + result (or error / shed reason) for one request id.

``GET /metrics`` / ``GET /metrics.json`` / ``GET /healthz``
    Prometheus text exposition, the schema-v1 JSON metrics snapshot, and
    a liveness probe carrying queue depth, in-flight count, and the
    failure-containment state (degradation ladders, circuit breakers,
    dispatcher supervision) — a load balancer can see a degraded-but-
    alive process and route around a dead dispatcher.

Hardening
---------
Every handler error — including injected ``http.handler`` faults — is
contained to a structured 500 body ``{"error", "error_class",
"request_id"}``; the server thread pool survives. ``POST /count`` wait
times are clamped to the server's ``max_wait_s`` so no handler thread
can be parked forever by a client-supplied timeout.
"""

from __future__ import annotations

import itertools
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.api import CountQuery
from repro_torch.core.templates import TemplateSpec
from repro_torch.obs import metrics as _metrics
from repro_torch.resilience import faults as _faults
from repro_torch.service.async_loop import AsyncCountingService
from repro_torch.service.qos import QoS
from repro_torch.service.requests import CountRequest, RequestStatus

__all__ = ["make_server", "serve_forever"]

_MAX_BODY = 4 << 20          # 4 MiB request-body cap (edge-list templates)
_DEFAULT_TIMEOUT_S = 120.0
_MAX_WAIT_S = 300.0          # hard clamp on client-requested handler waits

_REQ_IDS = itertools.count(1)


def _parse_template(obj):
    """JSON template entry -> something ``TemplateSpec.of`` accepts."""
    if isinstance(obj, dict):
        return TemplateSpec(edges=tuple(tuple(e) for e in obj["edges"]),
                            root=int(obj.get("root", 0)),
                            name=obj.get("name"))
    if isinstance(obj, (list, tuple)):
        return [tuple(e) for e in obj]
    return obj                       # registry name string


def _parse_qos(obj) -> QoS:
    if not obj:
        return QoS()
    return QoS(klass=obj.get("class", obj.get("klass", "interactive")),
               tenant=str(obj.get("tenant", "default")),
               weight=float(obj.get("weight", 1.0)),
               deadline_s=(None if obj.get("deadline_s") is None
                           else float(obj["deadline_s"])))


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries .svc (set by make_server)
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):     # route through metrics, not stderr
        _metrics.counter("http_requests_total",
                         method=self.command or "?").inc()

    def _send_json(self, code: int, payload: dict,
                   extra_headers: dict | None = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   ctype: str = "text/plain; charset=utf-8") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @property
    def svc(self) -> AsyncCountingService:
        return self.server.svc

    def _send_error_500(self, exc: BaseException, req_id: str) -> None:
        """Structured 500: error class + per-request id, so a client (or
        the chaos driver) can attribute failures without scraping logs."""
        _metrics.counter("http_errors_total",
                         error_class=type(exc).__name__).inc()
        try:
            self._send_json(500, {
                "error": f"{type(exc).__name__}: {exc}",
                "error_class": type(exc).__name__,
                "request_id": req_id})
        except Exception:
            pass           # client hung up mid-error; nothing left to save

    # ------------------------------------------------------------ endpoints
    def do_GET(self):
        req_id = f"h{next(_REQ_IDS):06d}"
        try:
            _faults.inject("http.handler", context=f"GET {self.path}")
            if self.path == "/healthz":
                self._get_healthz()
            elif self.path == "/metrics":
                self._send_text(200, _metrics.to_prometheus(),
                                "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics.json":
                self._send_json(200, _metrics.snapshot())
            elif self.path.startswith("/result/"):
                self._get_result(self.path[len("/result/"):])
            else:
                self._send_json(404, {"error": f"no route {self.path!r}"})
        except Exception as exc:
            self._send_error_500(exc, req_id)

    def _get_healthz(self) -> None:
        st = self.svc.stats()
        res = self.svc.resilience_state()
        dispatcher = res.get("dispatcher", {})
        # alive=False once the supervisor gave up: flip ok so a load
        # balancer stops routing here, but keep serving results/metrics
        ok = dispatcher.get("alive", True)
        self._send_json(200 if ok else 503, {
            "ok": bool(ok), "queue_depth": st["queue_depth"],
            "requests": st["requests"], "groups": st["groups"],
            "resilience": res})

    def _get_result(self, rid: str) -> None:
        try:
            status = self.svc.status(rid)
        except KeyError:
            self._send_json(404, {"error": f"unknown request {rid!r}"})
            return
        out = {"id": rid, "status": status.value}
        if status is RequestStatus.DONE:
            out["result"] = self.svc.result(rid).to_dict()
            self._send_json(200, out)
        elif status is RequestStatus.SHED:
            out["reason"] = self.svc.shed_reason(rid)
            self._send_json(429, out, {"Retry-After": "1"})
        elif status is RequestStatus.FAILED:
            st = self.svc._requests[rid]
            out["error"] = st.error
            out["error_class"] = st.error_class
            self._send_json(500, out)
        else:
            self._send_json(202, out)

    def do_POST(self):
        req_id = f"h{next(_REQ_IDS):06d}"
        if self.path != "/count":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        try:
            _faults.inject("http.handler", context=f"POST {self.path}")
            n = int(self.headers.get("Content-Length", 0))
            if n > _MAX_BODY:
                self._send_json(413, {"error": "body too large"})
                return
            body = json.loads(self.rfile.read(n) or b"{}")
            self._post_count(body)
        except (ValueError, KeyError, TypeError) as exc:
            self._send_json(400, {"error": f"{type(exc).__name__}: {exc}",
                                  "error_class": type(exc).__name__,
                                  "request_id": req_id})
        except Exception as exc:
            self._send_error_500(exc, req_id)

    def _post_count(self, body: dict) -> None:
        graph = body.get("graph", "g")
        tpls = body.get("templates", body.get("template"))
        if tpls is None:
            raise ValueError("body needs 'templates' (or 'template')")
        if isinstance(tpls, str) or not isinstance(tpls, list) \
                or (tpls and isinstance(tpls[0], (int, float))):
            tpls = [tpls]
        # validate + coerce through the first-class query API: bad
        # templates/contracts fail here with a 400, before any submit
        query = CountQuery(
            templates=tuple(_parse_template(t) for t in tpls),
            rel_stderr=body.get("rel_stderr"),
            max_iters=body.get("max_iters"),
            min_iters=int(body.get("min_iters", 4)),
            seed=int(body.get("seed", 0)),
            engine=body.get("engine", "pgbsc"),
            plan=body.get("plan", "optimized"))
        query.validate()
        qos = _parse_qos(body.get("qos"))
        rids = [self.svc.submit(CountRequest(
            graph=graph, template=spec, engine=query.engine,
            plan=query.plan, rel_stderr=query.rel_stderr,
            max_iters=query.max_iters, min_iters=query.min_iters,
            seed=query.seed), qos=qos) for spec in query.templates]
        if body.get("wait", True):
            # clamp: a client cannot park a handler thread past the
            # server's budget — unfinished work polls via /result/<rid>
            wait_s = min(float(body.get("timeout_s", _DEFAULT_TIMEOUT_S)),
                         getattr(self.server, "max_wait_s", _MAX_WAIT_S))
            self.svc.wait(rids, wait_s)
        out, n_done, n_shed = [], 0, 0
        for rid in rids:
            status = self.svc.status(rid)
            ent = {"id": rid, "status": status.value}
            if status is RequestStatus.DONE:
                ent["result"] = self.svc.result(rid).to_dict()
                n_done += 1
            elif status is RequestStatus.SHED:
                ent["reason"] = self.svc.shed_reason(rid)
                n_shed += 1
            elif status is RequestStatus.FAILED:
                ent["error"] = self.svc._requests[rid].error
                ent["error_class"] = self.svc._requests[rid].error_class
            out.append(ent)
        if n_shed == len(rids):
            self._send_json(429, {"requests": out}, {"Retry-After": "1"})
        elif n_done == len(rids):
            self._send_json(200, {"requests": out})
        else:
            self._send_json(202, {"requests": out})


def make_server(svc: AsyncCountingService, host: str = "127.0.0.1",
                port: int = 8080,
                max_wait_s: float = _MAX_WAIT_S) -> ThreadingHTTPServer:
    """A ready-to-run threaded HTTP server bound to (host, port); the
    caller owns ``serve_forever``/``shutdown`` (and the service's
    ``start``/``close``). ``max_wait_s`` clamps client-requested
    ``POST /count`` waits (handler-thread containment)."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.svc = svc
    httpd.max_wait_s = float(max_wait_s)
    return httpd


def serve_forever(svc: AsyncCountingService, host: str = "127.0.0.1",
                  port: int = 8080,
                  max_wait_s: float = _MAX_WAIT_S) -> ThreadingHTTPServer:
    """Start the dispatcher + HTTP server on a daemon thread; returns the
    server (``.shutdown()`` to stop)."""
    svc.start()
    httpd = make_server(svc, host, port, max_wait_s=max_wait_s)
    t = threading.Thread(target=httpd.serve_forever,
                         name="pgbsc-http", daemon=True)
    t.start()
    return httpd
