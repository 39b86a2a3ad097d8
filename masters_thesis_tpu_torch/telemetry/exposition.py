"""Stdlib-only HTTP exposition: ``/metrics``, ``/healthz`` and ``/slo``.

Counterpart of ``masters_thesis_tpu/telemetry/exposition.py``, copied
whole. One ``ExpositionServer`` a process renders the run's live state:

- ``/metrics``: a :class:`~.registry.MetricsRegistry` snapshot in the
  Prometheus text format, byte for byte as the JAX package renders the
  same contents (counters and gauges as they are, histograms as summaries
  with ``quantile`` labels plus ``_sum`` / ``_count``, the registry's
  host/pid identity as labels), then the SLO engine's rules as
  ``mtt_slo_firing`` (1 while a rule fires) and ``mtt_slo_value`` gauges;
- ``/healthz``: liveness JSON with the list of firing alerts and, where the
  component reports one, its ``state``: ``device_lost`` (a server whose
  card failed its probe) answers 503 with ``ok: false``;
- ``/slo``: the :class:`~.slo.SLOEngine`'s whole published state.

The listener thread starts in :meth:`ExpositionServer.start`, never in
``__init__``, and is joined with a bounded timeout in ``close``. Handlers
hold no lock of ours: they take the providers' snapshots (each copies
under its own short lock) and render on the handler thread.
``start_telemetry_plane`` is the one call that trainers, servers and the
supervisor share to start an SLO engine and the server together.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

#: Component states that ``/healthz`` answers 503 for.
UNHEALTHY_STATES = ("device_lost",)

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


def render_prometheus(
    snapshot: dict, slo_state: dict | None = None
) -> str:
    """The registry snapshot (``MetricsRegistry.snapshot()`` shape) as
    Prometheus text exposition format, plus ``mtt_slo_firing`` gauges
    from an optional SLO state dict."""
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
    if slo_state:
        lines += [
            "# HELP mtt_slo_firing 1 while the named SLO rule is firing",
            "# TYPE mtt_slo_firing gauge",
        ]
        for rule, row in sorted((slo_state.get("rules") or {}).items()):
            lines.append(
                f"mtt_slo_firing{_labels(tags, {'rule': rule})} "
                f"{1 if row.get('firing') else 0}"
            )
            if row.get("value") is not None:
                lines.append(
                    f"mtt_slo_value{_labels(tags, {'rule': rule})} "
                    f"{_num(row.get('value'))}"
                )
    return "\n".join(lines) + "\n"


class ExpositionServer:
    """Owns one listener thread serving /metrics, /healthz, /slo."""

    def __init__(
        self,
        registry=None,
        slo=None,
        bind_host: str = "127.0.0.1",
        port: int = 0,
        health=None,
    ):
        self._registry = registry
        self._slo = slo
        #: A callable returning the component's state, or None.
        self._health = health
        self._bind_host = bind_host
        self._requested_port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port: int | None = None

    # ---------------------------------------------------------- handlers
    # Called on http.server worker threads; they must copy state through
    # the providers' own internal locks and render lock-free here.

    def _get(self, path: str) -> tuple[int, str, str]:
        path = path.split("?", 1)[0]
        if path == "/metrics":
            snap = (
                self._registry.snapshot()
                if self._registry is not None
                else {"tags": {}, "metrics": {}}
            )
            state = self._slo.state() if self._slo is not None else None
            return 200, "text/plain; version=0.0.4", render_prometheus(
                snap, state
            )
        if path == "/healthz":
            state = self._slo.state() if self._slo is not None else {}
            health = {"ok": True, "ts": time.time(),
                      "firing": state.get("firing") or []}
            if self._health is not None:
                health["state"] = self._health()
                health["ok"] = health["state"] not in UNHEALTHY_STATES
            return (200 if health["ok"] else 503), "application/json", \
                json.dumps(health)
        if path == "/slo":
            state = self._slo.state() if self._slo is not None else {}
            return 200, "application/json", json.dumps(state, default=str)
        return 404, "text/plain", f"no route {path!r}\n"

    # --------------------------------------------------------- lifecycle

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
            target=self._httpd.serve_forever,
            name="exposition-http",
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

    def __enter__(self) -> "ExpositionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def start_telemetry_plane(
    telemetry,
    metrics_port: int | None,
    rules=None,
    slo_interval_s: float = 2.0,
    root=None,
    health=None,
):
    """The one-call attach point components share: an SLO engine tailing
    the run dir's streams plus an exposition server over the run's
    registry (``health``: the component's state for ``/healthz``).
    Returns ``(server, engine)`` — both ``None`` when the
    component has no telemetry or no port was requested (``port=0``
    binds an ephemeral port; ``None`` disables the plane). ``root``
    points the SLO engine at a different stream tree than the run dir —
    supervisors watch their CHILDREN's streams while exposing their own
    registry."""
    if telemetry is None or metrics_port is None:
        return None, None
    from masters_thesis_tpu_torch.telemetry.slo import SLOEngine

    engine = SLOEngine(
        root or telemetry.run_dir, rules=rules, sink=telemetry.sink
    )
    engine.start(interval_s=slo_interval_s)
    server = attach_exposition(telemetry, port=metrics_port, slo=engine,
                               health=health)
    return server, engine


def stop_telemetry_plane(server, engine) -> None:
    """Tear down what :func:`start_telemetry_plane` built (idempotent)."""
    if server is not None:
        server.close()
    if engine is not None:
        engine.stop()


def attach_exposition(
    telemetry, port: int = 0, bind_host: str = "127.0.0.1", slo=None,
    health=None,
) -> ExpositionServer:
    """Start an exposition server over a :class:`~.run.TelemetryRun`'s
    registry (plus an optional SLO engine) and record the bound URL in
    the event stream so operators and the watch console can find it."""
    server = ExpositionServer(
        registry=telemetry.registry, slo=slo, bind_host=bind_host,
        port=port, health=health,
    ).start()
    telemetry.event(
        "exposition_started",
        url=server.url,
        port=server.port,
        bind_host=bind_host,
    )
    return server
