"""Threaded scrape endpoint (counterpart of ``torchmetrics_tpu/serve/sidecar.py``).

``diag/telemetry.py`` renders exposition text; this module serves it. A
:class:`MetricsSidecar` binds a ``ThreadingHTTPServer`` on a daemon thread (stdlib
only) and answers:

- ``GET /metrics``: ``export_prometheus()``, ``Content-Type: text/plain;
  version=0.0.4``;
- ``GET /telemetry``: one ``telemetry_snapshot()`` as a JSON line;
- ``GET /healthz``: readiness: ``200 ok`` when the warm-start handoff (if any)
  replayed every row and no *blocking* SLO (``diag/slo.py``) is in breach, else ``503``
  with a JSON body naming the reason (``warm-start-failed``, or ``slo-breach`` with the
  SLO and, for ``value-freshness``, the stalest owner);
- ``GET /slo``: one SLO evaluation pass, the per-spec rows;
- ``GET /state``: the versioned federation envelope of the ``state_target``
  metrics (``serve/federation.py``), built on the pause-free
  :func:`~torchmetrics_tpu_torch.serve.snapshot.take_snapshot`; ``503`` with a typed
  JSON reason until a consistent snapshot exists, never an empty ``200``;
- ``GET /telemetry.bin``: this pod's telemetry envelope (``serve/fleet.py``);
- ``GET /fleet/metrics`` and ``GET /fleet/slo``: the fleet surfaces of an attached
  ``fleet_target``, else ``503 {"reason": "no-fleet-target"}``.

Every scrape is timed into the ``serve_scrape_latency_seconds`` histogram family
(``diag/hist.py``) and the ``tm_tpu_serve_scrapes_total`` counters. Handlers run on
server threads, so the update loop never waits on a scraper.

The warm-replica handoff: ``MetricsSidecar(warm_target=...)`` runs
``engine/persist.warm_start`` in :meth:`MetricsSidecar.start`, before the socket binds.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import perf_counter
from typing import Any, Optional

from torchmetrics_tpu_torch.diag import hist as _hist
from torchmetrics_tpu_torch.diag import lineage as _lineage
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.serve import stats as _serve_stats

__all__ = ["MetricsSidecar", "PROMETHEUS_CONTENT_TYPE"]

#: text exposition format 0.0.4 — what a Prometheus server's Accept header
#: negotiates for the classic text format
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


def _scrape_flush() -> None:
    """Drain every scan queue before the scrape reads counters and gauges: every step
    enqueued before the scrape is folded into what it exports. With async drains, the
    drain rides the background worker and only this scrape thread waits on the join."""
    from torchmetrics_tpu_torch.engine.async_dispatch import _EXECUTOR
    from torchmetrics_tpu_torch.engine.scan import flush_all

    drained = flush_all("observation:scrape")
    if _EXECUTOR._thread is not None:
        _diag.record("serve.scrape.async", "sidecar", drained=drained)
    _lineage.observe_all("scrape")


class _ScrapeHandler(BaseHTTPRequestHandler):
    server_version = "tm-tpu-sidecar/1.0"

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        t0 = perf_counter()
        path = self.path.split("?", 1)[0]
        status = 200
        extra_headers: dict = {}
        try:
            if path == "/state":
                status, extra_headers, body, ctype = self._state_response()
            elif path in ("/metrics", "/"):
                from torchmetrics_tpu_torch.diag.telemetry import export_prometheus

                # drain-before-scrape (engine/scan.py): counters and gauges a
                # scraper sees must reflect every enqueued step — the flush is
                # recorded (scan.flush, reason=observation:scrape) so diag can
                # prove no stale-read path exists
                _scrape_flush()
                body = export_prometheus().encode()
                ctype = PROMETHEUS_CONTENT_TYPE
            elif path == "/telemetry":
                from torchmetrics_tpu_torch.diag.telemetry import telemetry_snapshot

                _scrape_flush()
                body = (json.dumps(telemetry_snapshot(), sort_keys=True, default=str) + "\n").encode()
                ctype = "application/json"
            elif path == "/healthz":
                status, body, ctype = self._healthz_response()
            elif path == "/slo":
                from torchmetrics_tpu_torch.diag.slo import evaluate_slos

                body = (json.dumps(evaluate_slos(), sort_keys=True) + "\n").encode()
                ctype = "application/json"
            elif path == "/telemetry.bin":
                from torchmetrics_tpu_torch.serve.fleet import pack_telemetry

                body, extra_headers = pack_telemetry()
                ctype = "application/octet-stream"
            elif path == "/fleet/metrics":
                status, body, ctype = self._fleet_response("metrics")
            elif path == "/fleet/slo":
                status, body, ctype = self._fleet_response("slo")
            else:
                self.send_error(404, "unknown scrape path")
                return
        except Exception as exc:  # noqa: BLE001 — a scrape failure must answer, not hang
            self.send_error(500, f"{type(exc).__name__}: {exc}")
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for name, value in extra_headers.items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)
        elapsed = perf_counter() - t0
        _serve_stats.note_scrape(elapsed)
        _hist.observe("sidecar", "serve", "scrape_us", round(elapsed * 1e6, 3))
        _diag.record("serve.scrape", "sidecar", path=path, status=status, bytes=len(body))

    def _state_response(self) -> tuple:
        """The versioned ``/state`` endpoint: one federation envelope.

        A pod that cannot yet answer CONSISTENTLY says so — ``503`` with a
        typed JSON reason (``no-state-target`` when the sidecar serves no
        metrics, ``snapshot-inconsistent`` when the update loop never
        quiesced within the retry budget) — never an empty ``200`` a naive
        aggregator would fold as a zero-valued pod.
        """
        from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

        target = getattr(self.server, "tm_state_target", None)
        if target is None:
            reason = json.dumps({"reason": "no-state-target"}) + "\n"
            return 503, {}, reason.encode(), "application/json"
        from torchmetrics_tpu_torch.serve.federation import pack_envelope

        try:
            body, headers = pack_envelope(target)
        except TorchMetricsUserError as exc:
            reason = json.dumps({"reason": "snapshot-inconsistent", "detail": str(exc)}) + "\n"
            return 503, {}, reason.encode(), "application/json"
        return 200, headers, body, "application/octet-stream"

    def _healthz_response(self) -> tuple:
        """Readiness over the warm handoff and the blocking SLOs: ``503`` with a JSON
        body naming the cause (``warm-start-failed``: the pod is up but cold; or
        ``slo-breach`` and the breaching ids), so an orchestrator drains traffic for the
        right reason. Liveness is the socket answering at all."""
        warm = getattr(self.server, "tm_warm_report", None)
        if warm and int(warm.get("failed", 0)) > 0:
            body = json.dumps({
                "status": "unready",
                "reason": "warm-start-failed",
                "failed": int(warm.get("failed", 0)),
                "replayed": int(warm.get("replayed", 0)),
            }, sort_keys=True) + "\n"
            return 503, body.encode(), "application/json"
        from torchmetrics_tpu_torch.diag.slo import blocking_breaches, evaluate_slos, slo_enabled

        if slo_enabled():
            evaluate_slos()
            breaching = blocking_breaches()
            if breaching:
                payload = {
                    "status": "unready",
                    "reason": "slo-breach",
                    "slo": breaching,
                }
                if "value-freshness" in breaching:
                    # name the owner serving stale values, not just the SLO id:
                    # an operator draining this pod needs to know WHICH metric's
                    # fold watermark fell behind and by how much
                    stale = _lineage.stalest_owner()
                    if stale is not None:
                        owner, behind, wall_us = stale
                        payload["stale_owner"] = owner
                        payload["staleness_steps"] = int(behind)
                        payload["staleness_seconds"] = round(wall_us * 1e-6, 6)
                body = json.dumps(payload, sort_keys=True) + "\n"
                return 503, body.encode(), "application/json"
        return 200, b"ok\n", "text/plain"

    def _fleet_response(self, view: str) -> tuple:
        """The fleet-side surfaces: merged exposition or fleet SLO rows.

        Mirrors the ``/state`` contract — no attached aggregator is a typed
        ``503 no-fleet-target`` refusal, never an empty fleet pretending to
        be a healthy one.
        """
        fleet = getattr(self.server, "tm_fleet_target", None)
        if fleet is None:
            reason = json.dumps({"reason": "no-fleet-target"}) + "\n"
            return 503, reason.encode(), "application/json"
        if view == "metrics":
            return 200, fleet.export_prometheus().encode(), PROMETHEUS_CONTENT_TYPE
        rows = fleet.evaluate_slos()
        return 200, (json.dumps(rows, sort_keys=True) + "\n").encode(), "application/json"

    def log_message(self, *_: Any) -> None:
        """Silence the default stderr access log (scrapes are periodic)."""


class MetricsSidecar:
    """Daemon-thread HTTP scrape endpoint over the telemetry exporters.

    Usage::

        with MetricsSidecar() as sidecar:      # port 0 = ephemeral
            print(sidecar.url)                 # http://127.0.0.1:PORT/metrics
            ... the loop keeps updating ...

    ``port`` defaults to ``TORCHMETRICS_TPU_SERVE_PORT`` (0: the OS picks; read back
    from :attr:`port` after :meth:`start`).

    Warm-replica handoff: a ``warm_target`` (a Metric or MetricCollection) runs
    ``engine/persist.warm_start`` in :meth:`start`, before the endpoint answers its
    first scrape: the manifest in ``persist_dir`` (else ``TORCHMETRICS_TPU_PERSIST``)
    replays every recorded signature, and a ``snapshot_dir`` restores the newest elastic
    snapshot, so a replacement pod serves restored states on built graphs. The report
    lands on :attr:`warm_report`; a replay that failed makes ``/healthz`` answer 503.
    """

    def __init__(
        self,
        port: Optional[int] = None,
        host: str = "127.0.0.1",
        warm_target: Any = None,
        persist_dir: Optional[str] = None,
        snapshot_dir: Optional[str] = None,
        state_target: Any = None,
        fleet_target: Any = None,
    ) -> None:
        self._requested_port = _serve_stats.default_port() if port is None else int(port)
        self.host = host
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._warm_target = warm_target
        self._persist_dir = persist_dir
        self._snapshot_dir = snapshot_dir
        self._state_target = state_target
        self._fleet_target = fleet_target
        self.warm_report: Optional[dict] = None

    @property
    def url(self) -> str:
        if self.port is None:
            raise RuntimeError("sidecar not started")
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsSidecar":
        if self._server is not None:
            raise RuntimeError("sidecar already started")
        if self._warm_target is not None:
            # the handoff before the socket binds: the first scrape already sees
            # restored states and built graphs
            from torchmetrics_tpu_torch.engine.persist import warm_start

            self.warm_report = warm_start(self._warm_target, directory=self._persist_dir, snapshot_dir=self._snapshot_dir)
        server = ThreadingHTTPServer((self.host, self._requested_port), _ScrapeHandler)
        server.daemon_threads = True
        # the /state, /healthz and /fleet/* handlers read these off the server object
        # (handler instances are per request; the server is the shared context): a
        # failed warm handoff flips readiness
        server.tm_state_target = self._state_target
        server.tm_fleet_target = self._fleet_target
        server.tm_warm_report = self.warm_report
        self._server = server
        self.port = server.server_address[1]
        self._thread = threading.Thread(target=server.serve_forever, name="tm-torch-sidecar", daemon=True)
        self._thread.start()
        _diag.record("serve.sidecar.start", "sidecar", port=self.port)
        return self

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None
        self.port = None

    def __enter__(self) -> "MetricsSidecar":
        return self.start()

    def __exit__(self, *_: Any) -> None:
        self.stop()
