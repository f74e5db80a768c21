"""Stdlib HTTP observability server: metrics exposition, health/readiness
probes, and request-level debug surfaces.

Endpoints (all GET; every server in the system mounts the same map via
`build_endpoints`, so `/metrics` on the metrics port and on the serving
front door behave identically):

- ``/metrics`` — Prometheus text exposition format 0.0.4 (with
  OpenMetrics exemplar suffixes on bucket lines that carry one);
- ``/metrics.json`` — the structured registry snapshot as JSON;
- ``/healthz`` — pure liveness (``ok`` while the process serves HTTP);
- ``/readyz`` — readiness: 200 when every registered check passes, 503
  with a JSON reason breakdown when not (see `ReadyState`);
- ``/debug/requests`` — recent flight-recorder ring, filterable by
  ``?outcome=&tenant=&min_ms=&limit=``;
- ``/debug/trace/<id>`` — one retained request trace, full stage
  breakdown;
- ``/debug/batches`` — recent coalesced-dispatch records;
- ``/debug/slo`` — the SLO monitor's live burn-rate report;
- ``/debug/profile?seconds=N`` — capture an on-demand ``torch.profiler``
  trace (CPU, and CUDA when a card is present) into the configured profile
  dir as a Chrome trace, ``ondemand-<unix time>.json``.

Endpoint protocol: ``fn(rest, query) -> (status, body_bytes, ctype)``
where ``rest`` is the path remainder after a prefix-mounted key (empty
for exact keys) and ``query`` is the parsed query string.  `dispatch`
routes a raw request path through an endpoint map (exact match first,
then longest registered ``.../`` prefix).

Bound to loopback by default; pass ``port=0`` to let the OS pick (the
chosen port is published on ``server.port`` after `start()`).
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs import metrics as _metrics

__all__ = [
    "MetricsServer",
    "ReadyState",
    "build_endpoints",
    "debug_endpoints",
    "dispatch",
    "registry_endpoints",
]


class ReadyState:
    """Named readiness conditions aggregated into one ``/readyz`` answer.

    Two kinds of condition:

    * `mark(name, ok, reason)` — a latched flag the owner flips (e.g. the
      launcher marks ``engine`` ready once recovery/replay completes);
    * `add_check(name, fn)` — evaluated live on every probe; ``fn`` returns
      ``(ok, reason)`` (a bare bool is accepted).  A check that raises
      reports not-ready with the exception as the reason.

    Calling the state returns ``(ready, {name: {"ok": bool, "reason":
    str}})``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._flags: dict = {}       # name -> (ok, reason)
        self._checks: dict = {}      # name -> fn

    def mark(self, name: str, ok: bool = True, reason: str = "") -> None:
        with self._lock:
            self._flags[str(name)] = (bool(ok), str(reason))

    def add_check(self, name: str, fn) -> None:
        with self._lock:
            self._checks[str(name)] = fn

    def __call__(self):
        with self._lock:
            flags = dict(self._flags)
            checks = dict(self._checks)
        detail = {}
        for name, (ok, reason) in flags.items():
            detail[name] = {"ok": ok, "reason": reason}
        for name, fn in checks.items():
            try:
                res = fn()
            except Exception as e:                     # noqa: BLE001
                res = (False, f"check raised: {e!r}")
            ok, reason = res if isinstance(res, tuple) else (bool(res), "")
            detail[name] = {"ok": bool(ok), "reason": str(reason)}
        ready = all(d["ok"] for d in detail.values())
        return ready, detail


def _json_body(status: int, doc) -> tuple:
    return status, json.dumps(doc).encode("utf-8"), "application/json"


def registry_endpoints(registry, ready=None) -> dict:
    """The standard observability GET endpoints as an endpoint map.

    ``ready`` is an optional callable (e.g. a `ReadyState`) returning
    ``(bool, detail)``; without one, ``/readyz`` reports ready with no
    checks — liveness stays on ``/healthz``, which never consults state.
    """
    def metrics(rest, query):
        return (200, registry.exposition().encode("utf-8"),
                "text/plain; version=0.0.4; charset=utf-8")

    def metrics_json(rest, query):
        return 200, registry.to_json().encode("utf-8"), "application/json"

    def healthz(rest, query):
        # pure liveness: if this handler runs, the process is alive.
        return 200, b"ok\n", "text/plain; charset=utf-8"

    def readyz(rest, query):
        if ready is None:
            return _json_body(200, {"ready": True, "checks": {}})
        ok, detail = ready()
        return _json_body(200 if ok else 503,
                          {"ready": ok, "checks": detail})

    return {"/metrics": metrics, "/": metrics,
            "/metrics.json": metrics_json,
            "/healthz": healthz, "/readyz": readyz}


def _requests_endpoint(recorder):
    def debug_requests(rest, query):
        try:
            limit = int(query.get("limit", 50))
            min_ms = query.get("min_ms")
            records = recorder.recent(
                outcome=query.get("outcome") or None,
                tenant=query.get("tenant") or None,
                min_ms=float(min_ms) if min_ms else None,
                limit=max(1, min(limit, 1000)))
        except ValueError as e:
            return _json_body(400, {"error": "bad_request",
                                    "detail": str(e)})
        return _json_body(200, {"requests": records,
                                "count": len(records),
                                "recorder": recorder.stats()})
    return debug_requests


def _trace_endpoint(recorder):
    def debug_trace(rest, query):
        trace_id = rest.strip("/")
        if not trace_id:
            return _json_body(400, {"error": "bad_request",
                                    "detail": "missing trace id"})
        rec = recorder.get(trace_id) or recorder.get_batch(trace_id)
        if rec is None:
            return _json_body(404, {
                "error": "not_found", "trace_id": trace_id,
                "detail": "not retained (dropped by sampling, evicted "
                          "from the ring, or never recorded)"})
        return _json_body(200, rec)
    return debug_trace


def _batches_endpoint(recorder):
    def debug_batches(rest, query):
        limit = max(1, min(int(query.get("limit", 50)), 1000))
        records = recorder.recent_batches(limit=limit)
        return _json_body(200, {"batches": records,
                                "count": len(records)})
    return debug_batches


def _slo_endpoint(slo):
    def debug_slo(rest, query):
        return _json_body(200, slo.report())
    return debug_slo


def _profile_endpoint(profile_dir):
    lock = threading.Lock()

    def debug_profile(rest, query):
        try:
            seconds = min(max(float(query.get("seconds", 1.0)), 0.05), 60.0)
        except ValueError:
            return _json_body(400, {"error": "bad_request",
                                    "detail": "seconds must be a number"})
        if not lock.acquire(blocking=False):
            return _json_body(409, {"error": "profile_in_progress"})
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(profile_dir, exist_ok=True)
            out = os.path.join(profile_dir,
                               f"ondemand-{int(time.time())}.json")
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(out)
        except Exception as e:                         # noqa: BLE001
            return _json_body(503, {"error": "profiler_unavailable",
                                    "detail": repr(e)})
        finally:
            lock.release()
        return _json_body(200, {"profile_dir": profile_dir,
                                "trace": out, "seconds": seconds})
    return debug_profile


def debug_endpoints(recorder=None, slo=None, profile_dir=None) -> dict:
    """The ``/debug/*`` surfaces for whichever components exist."""
    endpoints = {}
    if recorder is not None:
        endpoints["/debug/requests"] = _requests_endpoint(recorder)
        endpoints["/debug/trace/"] = _trace_endpoint(recorder)
        endpoints["/debug/batches"] = _batches_endpoint(recorder)
    if slo is not None:
        endpoints["/debug/slo"] = _slo_endpoint(slo)
    if profile_dir is not None:
        endpoints["/debug/profile"] = _profile_endpoint(profile_dir)
    return endpoints


def build_endpoints(registry, *, ready=None, recorder=None, slo=None,
                    profile_dir=None) -> dict:
    """Registry + debug endpoints in one map (what every server mounts)."""
    endpoints = registry_endpoints(registry, ready=ready)
    endpoints.update(debug_endpoints(recorder=recorder, slo=slo,
                                     profile_dir=profile_dir))
    return endpoints


def dispatch(endpoints: dict, raw_path: str):
    """Route one GET.  Returns ``(status, body, ctype)`` or None for 404.

    Exact path match wins; otherwise the longest registered key ending in
    ``/`` that prefixes the path handles it with ``rest`` set to the
    remainder (that is how ``/debug/trace/<id>`` works).
    """
    parsed = urllib.parse.urlsplit(raw_path)
    path = parsed.path
    query = {k: v[-1] for k, v in
             urllib.parse.parse_qs(parsed.query).items()}
    fn = endpoints.get(path)
    rest = ""
    if fn is None:
        for key in sorted(endpoints, key=len, reverse=True):
            if key.endswith("/") and len(key) > 1 and path.startswith(key):
                fn = endpoints[key]
                rest = path[len(key):]
                break
    if fn is None:
        return None
    try:
        return fn(rest, query)
    except Exception as e:                             # noqa: BLE001
        return _json_body(500, {"error": "internal", "detail": repr(e)})


class MetricsServer:
    """Daemon-thread HTTP server for the observability endpoint map.

    ``ready``/``recorder``/``slo``/``profile_dir`` mount the matching
    surfaces next to ``/metrics`` (see module docstring); all are
    optional — the default server exposes metrics + health only.
    """

    def __init__(self, registry=None, host: str = "127.0.0.1", port: int = 0,
                 *, ready=None, recorder=None, slo=None, profile_dir=None):
        self.registry = registry if registry is not None else _metrics.get_registry()
        self.host = host
        self.port = int(port)
        self.ready = ready
        self.recorder = recorder
        self.slo = slo
        self.profile_dir = profile_dir
        self._httpd = None
        self._thread = None

    def start(self) -> "MetricsServer":
        endpoints = build_endpoints(
            self.registry, ready=self.ready, recorder=self.recorder,
            slo=self.slo, profile_dir=self.profile_dir)

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                routed = dispatch(endpoints, self.path)
                if routed is None:
                    self.send_error(404)
                    return
                status, body, ctype = routed
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes shouldn't spam the serving process's stderr

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self):
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False
