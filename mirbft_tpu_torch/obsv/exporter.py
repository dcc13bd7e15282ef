"""Stdlib-only HTTP exposition for a running node.

A tiny ``http.server`` ThreadingHTTPServer on a daemon thread serving:

- ``GET /metrics``  — Prometheus text 0.0.4 rendered by the registry's
  catalog renderer (this module is the only place in the package where
  registry internals meet a socket).
- ``GET /status``   — JSON produced by a caller-supplied callable
  (``status.state_machine_status(...).to_json()`` on the runtime node).
- ``GET /healthz``  — liveness: 200 ``{"ok": true}`` while serving.
- ``GET /dump``     — flush the node's flight recorder to an on-disk
  segment and return its path (503 when no recorder is wired); the
  operator-triggered counterpart of the crash-path auto-dump.

Off by default: the runtime node only starts one when
``Config.metrics_port`` is set (0 binds an ephemeral port — the test
default).  ``close()`` is idempotent and wired into node stop and the
serializer's crash path, so a crash tears the socket down with the node.

Endpoint callables run on the server's request threads; they must be
thread-safe (the registry is; node.status() does a serializer
round-trip with a timeout).  A callable returning ``None`` maps to 503,
a raising callable to 500 — a scrape can never take the node down.
"""

from __future__ import annotations

import http.server
import json
import threading


class ObsvExporter:
    """Serve /metrics, /status and /healthz for one node."""

    def __init__(
        self,
        host="127.0.0.1",
        port=0,
        registry_fn=None,
        status_fn=None,
        node_id=None,
        dump_fn=None,
    ):
        self._registry_fn = registry_fn
        self._status_fn = status_fn
        self._node_id = node_id
        self._dump_fn = dump_fn
        self._closed = False
        # Reported by /healthz.  True by default (a node that serves is
        # live); a cluster worker flips it False before wiring
        # and True once the transport mesh is connected, so the
        # supervisor's readiness handshake is one HTTP poll.
        self.ready = True
        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            # Scrapes are frequent; stay silent on stderr.
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                try:
                    if self.path == "/metrics":
                        body, ctype, code = exporter._metrics()
                    elif self.path == "/status":
                        body, ctype, code = exporter._status()
                    elif self.path == "/healthz":
                        body, ctype, code = exporter._healthz()
                    elif self.path == "/dump":
                        body, ctype, code = exporter._dump()
                    else:
                        body, ctype, code = "not found\n", "text/plain", 404
                except Exception as exc:  # noqa: BLE001 — scrape must not kill the node
                    body, ctype, code = f"error: {exc}\n", "text/plain", 500
                payload = body.encode("utf-8")
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", f"{ctype}; charset=utf-8")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                except (BrokenPipeError, ConnectionResetError):
                    # The scraper hung up first (a supervisor's readiness
                    # poll past its 1 s timeout): no one is left to
                    # answer.  socketserver would print a traceback.
                    pass

        self._server = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"obsv-exporter-{self._server.server_address[1]}",
            daemon=True,
        )
        self._thread.start()

    @property
    def address(self):
        """``(host, port)`` actually bound (port resolved when 0)."""
        return self._server.server_address[:2]

    def _metrics(self):
        registry = self._registry_fn() if self._registry_fn else None
        if registry is None:
            return (
                "# mirbft: observability hooks disabled (hooks.enable() to scrape)\n",
                "text/plain; version=0.0.4",
                200,
            )
        return registry.prometheus_text(), "text/plain; version=0.0.4", 200

    def _status(self):
        status = self._status_fn() if self._status_fn else None
        if status is None:
            return (
                json.dumps({"error": "status unavailable"}),
                "application/json",
                503,
            )
        if not isinstance(status, str):
            status = json.dumps(status)
        return status, "application/json", 200

    def _dump(self):
        path = self._dump_fn() if self._dump_fn else None
        if path is None:
            return (
                json.dumps({"error": "no flight recorder wired"}),
                "application/json",
                503,
            )
        return json.dumps({"ok": True, "path": path}), "application/json", 200

    def _healthz(self):
        body = {"ok": True, "ready": bool(self.ready)}
        if self._node_id is not None:
            body["node_id"] = self._node_id
        return json.dumps(body), "application/json", 200

    def close(self, timeout=5.0):
        """Stop serving and join the server thread; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=timeout)
