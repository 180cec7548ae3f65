"""One wiring path for a run's telemetry: `init_run(phase=...)`
(counterpart of bert_pytorch_tpu/telemetry/run.py, the serve phase's part:
no StepWatch, CompileWatch or exporter).

    tel = init_run(phase="serve", log_prefix=os.path.join(out, "serve_log"))
    tel.log_header(**collect_provenance(device))
    tel.attach_slo(slo_engine)      # /healthz status from the SLO plane
    ...
    tel.close()

The handle owns the phase-labeled MetricsRegistry every producer
publishes through (`.registry`), the MetricLogger (`.logger`), and the
/healthz liveness snapshot (`healthz()`), whose top-level `status` is
always present: `ok`, or the SLO engine's ok|degraded|failing verdict
with a compact `slo` block once one is attached.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry
from bert_pytorch_tpu_torch.training.metrics import MetricLogger


class TelemetryRun:
    """The per-run telemetry handle. Construct via `init_run`."""

    def __init__(self, phase: str, logger: MetricLogger,
                 registry: MetricsRegistry):
        self.phase = phase
        self.logger = logger
        self.registry = registry
        self.slo = None
        self._closed = False
        self.started_unix = round(time.time(), 3)

    def log_header(self, **fields: Any) -> None:
        self.logger.log_header(**fields)

    def attach_slo(self, engine) -> None:
        """SLO plane on /healthz: the engine's verdict becomes the
        payload's `status`, with its `health_summary()` as `slo`."""
        self.slo = engine

    def healthz(self) -> Dict[str, Any]:
        """The run's part of /healthz: phase, uptime and `status`."""
        h: Dict[str, Any] = {
            "phase": self.phase, "started_unix": self.started_unix,
            "uptime_secs": round(time.time() - self.started_unix, 1)}
        if self.slo is not None:
            h["slo"] = self.slo.health_summary()
            h["status"] = h["slo"]["status"]
        else:
            h["status"] = "ok"
        return h

    def close(self) -> None:
        """Close the logger's sinks. Idempotent."""
        if not self._closed:
            self._closed = True
            self.logger.close()


def init_run(phase: str, log_prefix: Optional[str] = None,
             echo: Callable[[str], None] = print) -> TelemetryRun:
    """The run's telemetry in one call: a registry with the constant label
    `phase` and a MetricLogger over `log_prefix`'s sinks (none without
    it) that echoes through `echo`."""
    return TelemetryRun(
        phase, MetricLogger(log_prefix, echo=echo),
        MetricsRegistry(constant_labels={"phase": phase}))
