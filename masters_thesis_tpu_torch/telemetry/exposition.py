"""Stdlib-only HTTP exposition: ``/metrics`` and ``/healthz``.

Counterpart of ``masters_thesis_tpu/telemetry/exposition.py`` without the
SLO plane (``/slo`` and the ``mtt_slo_*`` gauges wait for the port's SLO
engine). ``/metrics`` renders a :class:`~.registry.MetricsRegistry`
snapshot in the Prometheus text format, byte for byte as the JAX package
renders the same contents: counters and gauges as they are, histograms as
summaries with ``quantile`` labels plus ``_sum`` / ``_count``, the
registry's host/pid identity as labels. ``/healthz`` answers liveness JSON.

The listener thread starts in :meth:`ExpositionServer.start`, never in
``__init__``, and is joined with a bounded timeout in ``close``. Handlers
hold no lock of ours: they take the registry's snapshot (which copies under
its own short locks) and render on the handler thread.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_NAME_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def sanitize_metric_name(name: str, prefix: str = "mtt_") -> str:
    """Map a registry name (``serve/request_wall_s``) onto the Prometheus
    grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*`` with a stable ``mtt_`` prefix."""
    cleaned = "".join(c if c in _NAME_OK else "_" for c in name)
    if cleaned and cleaned[0].isdigit():
        cleaned = "_" + cleaned
    return prefix + cleaned


def escape_label_value(value) -> str:
    """Label-value escaping per the text format: backslash, quote, LF."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def escape_help(text: str) -> str:
    """HELP-line escaping: backslash and LF only (quotes are literal)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _labels(tags: dict, extra: dict | None = None) -> str:
    merged = dict(tags)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted(merged.items())
        if v is not None
    )
    return "{" + inner + "}"


def _num(value) -> str:
    if value is None:
        return "NaN"
    value = float(value)
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(value)


def render_prometheus(snapshot: dict) -> str:
    """The registry snapshot (``MetricsRegistry.snapshot()`` shape) as
    Prometheus text exposition format."""
    tags = snapshot.get("tags") or {}
    lines: list[str] = []
    for name, inst in sorted((snapshot.get("metrics") or {}).items()):
        kind = inst.get("type")
        pname = sanitize_metric_name(name)
        help_line = f"# HELP {pname} {escape_help(name)}"
        if kind == "counter":
            lines += [
                help_line,
                f"# TYPE {pname} counter",
                f"{pname}{_labels(tags)} {_num(inst.get('value'))}",
            ]
        elif kind == "gauge":
            lines += [
                help_line,
                f"# TYPE {pname} gauge",
                f"{pname}{_labels(tags)} {_num(inst.get('value'))}",
            ]
        elif kind == "histogram":
            lines += [help_line, f"# TYPE {pname} summary"]
            for q, key in (("0.5", "p50"), ("0.99", "p99")):
                lines.append(
                    f"{pname}{_labels(tags, {'quantile': q})} "
                    f"{_num(inst.get(key))}"
                )
            lines.append(
                f"{pname}_sum{_labels(tags)} {_num(inst.get('sum'))}"
            )
            lines.append(
                f"{pname}_count{_labels(tags)} "
                f"{_num(inst.get('count') or 0)}"
            )
    return "\n".join(lines) + "\n"


class ExpositionServer:
    """Owns one listener thread serving /metrics and /healthz."""

    def __init__(self, registry=None, bind_host: str = "127.0.0.1",
                 port: int = 0):
        self._registry = registry
        self._bind_host = bind_host
        self._requested_port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port: int | None = None

    def _get(self, path: str) -> tuple[int, str, str]:
        path = path.split("?", 1)[0]
        if path == "/metrics":
            snap = (
                self._registry.snapshot()
                if self._registry is not None
                else {"tags": {}, "metrics": {}}
            )
            return 200, "text/plain; version=0.0.4", render_prometheus(snap)
        if path == "/healthz":
            return 200, "application/json", json.dumps(
                {"ok": True, "ts": time.time(), "firing": []})
        return 404, "text/plain", f"no route {path!r}\n"

    def start(self) -> "ExpositionServer":
        if self._httpd is not None:
            return self
        owner = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 -- http.server API
                try:
                    status, ctype, body = owner._get(self.path)
                except Exception as exc:  # noqa: BLE001 -- a provider
                    # error must answer 500, not kill the worker thread
                    status, ctype, body = 500, "text/plain", f"{exc}\n"
                payload = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer(
            (self._bind_host, self._requested_port), _Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="exposition-http",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def url(self) -> str | None:
        if self.port is None:
            return None
        return f"http://{self._bind_host}:{self.port}"

    def close(self) -> None:
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=10.0)


def attach_exposition(telemetry, port: int = 0,
                      bind_host: str = "127.0.0.1") -> ExpositionServer:
    """Start an exposition server over a :class:`~.run.TelemetryRun`'s
    registry and record its URL in the event stream (``port=0`` binds a
    free port)."""
    server = ExpositionServer(registry=telemetry.registry,
                              bind_host=bind_host, port=port).start()
    telemetry.event("exposition_started", url=server.url, port=server.port,
                    bind_host=bind_host)
    return server
