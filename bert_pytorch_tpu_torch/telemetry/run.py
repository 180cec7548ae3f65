"""One wiring path for a run's telemetry: `init_run(phase=...)`
(counterpart of bert_pytorch_tpu/telemetry/run.py, without the
CompileWatch, which is XLA's, and the multi-host fold).

    tel = init_run(phase="pretrain", log_prefix=os.path.join(out, "logfile"),
                   metrics_port=args.metrics_port)
    tel.log_header(**collect_provenance(device))
    sw = tel.make_stepwatch(flops_per_step=..., seqs_per_step=..., ...)
    tel.attach_checkpoints(manager)
    tel.attach_recorder(recorder)
    ...
    tel.log_train(step, step_loss=..., loss_nonfinite=..., ...)
    rec = sw.step_done();  tel.log_perf(step, rec) if rec else None
    ...
    tel.close()

The handle owns the phase-labeled MetricsRegistry every producer
publishes through (`.registry`), the MetricLogger (`.logger`), the
optional /metrics + /healthz exporter (`.server`, `metrics_port`; 0 binds
an ephemeral port) and the /healthz snapshot (`healthz()`): the last
step, the last perf interval, the last health-pack flags, the newest
non-finite step, checkpoint freshness and a top-level `status` that is
always present (`ok`, or the SLO engine's ok|degraded|failing verdict);
with a flight recorder attached, its window, ring bytes and last bundle;
with a streaming loader attached (`attach_stream`), its live cursor.

`log_train` / `log_perf` update the registry and /healthz, then fan out
through the logger. Every value they take is a host number the loop has
already read, so the exporter's threads never touch a CUDA tensor.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry
from bert_pytorch_tpu_torch.training.metrics import MetricLogger

# health-pack keys a train record may carry; those present drive the
# non-finite counters and the /healthz flags
HEALTH_FLAG_KEYS = ("loss_nonfinite", "grad_nonfinite",
                    "skipped_nonfinite", "grad_spike")

# perf-record fields with gauge families of their own (every other
# numeric field lands in bert_perf{field=...})
_PERF_GAUGES = {
    "step_time_ms": ("bert_step_time_ms",
                     "wall time per optimization step (ms)"),
    "seq_per_sec": ("bert_seq_per_sec", "sequences per second"),
    "tokens_per_sec": ("bert_tokens_per_sec",
                       "slot tokens per second (pad included)"),
    "mfu": ("bert_mfu", "model FLOPs utilization vs device peak"),
}


class TelemetryRun:
    """The per-run telemetry handle. Construct via `init_run`."""

    def __init__(self, phase: str, logger: MetricLogger,
                 registry: MetricsRegistry, server=None):
        self.phase = phase
        self.logger = logger
        self.registry = registry
        self.server = server
        self.ckpt_manager = None
        self.slo = None
        self.recorder = None
        self.stream_loader = None
        # telemetry/multihost.HostMetricsAggregator of a run over several
        # ranks: each perf record published, rank 0 folding the others'
        self.aggregator = None
        self._closed = False
        try:
            self.supervisor_restarts = int(
                os.environ.get("BERT_SUPERVISOR_RESTARTS", "0"))
        except ValueError:
            self.supervisor_restarts = 0
        self._health: Dict[str, Any] = {
            "phase": phase,
            "started_unix": round(time.time(), 3),
            "last_step": None,
            "last_perf_step": None,
            "last_perf": {},
            "last_health": {},
            "last_nonfinite_step": None,
            "nonfinite_flags": {},
        }
        # declared up front so /metrics shows the zeros from the first
        # scrape
        self._nonfinite_steps = registry.counter(
            "bert_nonfinite_steps_total",
            "steps flagged non-finite by the health pack")
        self._loss_nonfinite = registry.counter(
            "bert_loss_nonfinite_steps_total",
            "steps with a non-finite loss")
        self._grad_nonfinite = registry.counter(
            "bert_grad_nonfinite_steps_total",
            "steps with non-finite gradient elements")
        registry.counter("bert_train_steps_total",
                         "optimization steps completed")
        self._perf_g = {k: registry.gauge(name, help)
                        for k, (name, help) in _PERF_GAUGES.items()}
        self._perf_other = registry.gauge(
            "bert_perf", "other StepWatch interval fields",
            labels=("field",))
        if self.supervisor_restarts or "BERT_SUPERVISOR_RESTARTS" in \
                os.environ:
            registry.gauge(
                "bert_supervisor_restarts",
                "restart count of this process under tools/supervise.py"
            ).set(float(self.supervisor_restarts))
            self._health["supervisor_restarts"] = self.supervisor_restarts

    def log_header(self, **fields: Any) -> None:
        self.logger.log_header(**fields)

    def make_stepwatch(self, **kwargs):
        """The run's StepWatch, publishing into the registry; kwargs are
        StepWatch's."""
        from bert_pytorch_tpu_torch.telemetry.stepwatch import StepWatch

        kwargs.setdefault("registry", self.registry)
        return StepWatch(**kwargs)

    def attach_checkpoints(self, manager) -> None:
        """Checkpoint freshness on /healthz (`last_checkpoint_step`,
        `seconds_since_checkpoint`) from `manager.freshness()`."""
        self.ckpt_manager = manager

    def attach_recorder(self, recorder) -> None:
        """Cross-wire the flight recorder: its manifests gain the
        registry's snapshot at dump time and `metrics_tail_source`, the
        jsonl whose records the tail mirrors; /healthz gains its state."""
        self.recorder = recorder
        recorder.registry = self.registry
        if self.logger.jsonl_path:
            recorder.metrics_tail_source = self.logger.jsonl_path

    def attach_slo(self, engine) -> None:
        """SLO plane on /healthz: the engine's verdict becomes the
        payload's `status`, with its `health_summary()` as `slo`."""
        self.slo = engine

    def attach_stream(self, loader) -> None:
        """Streaming-plane runs (data/streaming.py): /healthz carries the
        loader's live cursor (epoch, source, record, batches) as
        `stream`."""
        self.stream_loader = loader

    def log_train(self, step: int, **vals: Any) -> None:
        """One per-step `train` record: the non-finite counters and the
        /healthz flags, then the logger."""
        step = int(step)
        self._health["last_step"] = step
        flags = {k: vals[k] for k in HEALTH_FLAG_KEYS
                 if isinstance(vals.get(k), (int, float))}
        if flags:
            self._health["last_health"] = flags
        loss_bad = flags.get("loss_nonfinite", 0) > 0
        grad_bad = flags.get("grad_nonfinite", 0) > 0
        if loss_bad or grad_bad:
            self._health["last_nonfinite_step"] = step
            self._health["nonfinite_flags"] = flags
            self._nonfinite_steps.inc()
            if loss_bad:
                self._loss_nonfinite.inc()
            if grad_bad:
                self._grad_nonfinite.inc()
        self.logger.log("train", step, **vals)

    def log_perf(self, step: int, record: Dict[str, Any]) -> None:
        """One StepWatch interval `perf` record: over several ranks this
        rank's numbers published and, on rank 0, the ranks' fold added to
        the record (with a straggler warning); then the gauges and
        /healthz, then the logger."""
        if self.aggregator is not None:
            record = dict(record)
            self.aggregator.publish(int(step), record)
            if self.aggregator.process_index == 0:
                agg, warning = self.aggregator.fold()
                record.update(agg)
                if warning:
                    self.logger.info("WARNING: " + warning)
        for k, g in self._perf_g.items():
            if isinstance(record.get(k), (int, float)):
                g.set(float(record[k]))
        for k, v in record.items():
            if k in self._perf_g or isinstance(v, bool) \
                    or not isinstance(v, (int, float)):
                continue
            self._perf_other.set(float(v), field=k)
        self._health["last_perf_step"] = int(step)
        self._health["last_perf"] = {
            k: record[k] for k in ("step_time_ms", "seq_per_sec", "mfu",
                                   "data_wait_ms")
            if isinstance(record.get(k), (int, float))}
        self.logger.log("perf", int(step), **record)

    def healthz(self) -> Dict[str, Any]:
        """The /healthz payload: a snapshot of the run's liveness."""
        h = dict(self._health)
        h["uptime_secs"] = round(time.time() - h["started_unix"], 1)
        h["status"] = "ok"
        if self.slo is not None:
            try:
                h["slo"] = self.slo.health_summary()
                h["status"] = h["slo"]["status"]
            except Exception:
                pass  # a probe must never take the run down
        if self.stream_loader is not None:
            try:
                cursor = dict(self.stream_loader.state_dict())
                cursor.pop("pending", None)     # bulky and not liveness
                h["stream"] = cursor
            except Exception:
                pass    # a probe must never take the run down
        if self.recorder is not None:
            try:
                h["flight_recorder"] = {
                    "window": self.recorder.window,
                    "ring_bytes": self.recorder.nbytes(),
                    "last_bundle": self.recorder.last_dump}
            except Exception:
                pass
        if self.ckpt_manager is not None:
            try:
                step, t = self.ckpt_manager.freshness()
                h["last_checkpoint_step"] = step
                h["seconds_since_checkpoint"] = (
                    round(time.time() - t, 1) if t is not None else None)
            except Exception:
                pass
        return h

    def close(self) -> None:
        """Close the exporter first (a scrape must not race the logger's
        teardown), then the logger's sinks. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for fn in ((self.server.close if self.server is not None
                    else None),
                   (self.aggregator.close if self.aggregator is not None
                    else None), self.logger.close):
            if fn is None:
                continue
            try:
                fn()
            except Exception:
                pass


def init_run(phase: str, log_prefix: Optional[str] = None,
             echo: Callable[[str], None] = print,
             metrics_port: Optional[int] = None,
             tensorboard: bool = False,
             multihost_dir: Optional[str] = None,
             process_index: int = 0, process_count: int = 1,
             straggler_z: float = 3.0) -> TelemetryRun:
    """The run's telemetry in one call: a registry with the constant label
    `phase`, a MetricLogger over `log_prefix`'s sinks (none without it;
    `tensorboard` adds the TensorBoard sink) that echoes through `echo`
    and publishes into the registry, and, with
    `metrics_port` (0: an ephemeral port, read `tel.server.port`), the
    /metrics + /healthz exporter. `multihost_dir` turns on the per-rank
    publish and rank 0's fold (telemetry/multihost.py) for rank
    `process_index` of `process_count`."""
    registry = MetricsRegistry(constant_labels={"phase": phase})
    tel = TelemetryRun(phase, MetricLogger(log_prefix, echo=echo,
                                           registry=registry,
                                           tensorboard=tensorboard),
                       registry)
    if multihost_dir:
        from bert_pytorch_tpu_torch.telemetry.multihost import \
            HostMetricsAggregator

        tel.aggregator = HostMetricsAggregator(
            multihost_dir, process_index=process_index,
            process_count=process_count, z_threshold=straggler_z)
    if metrics_port is not None:
        from bert_pytorch_tpu_torch.telemetry.exporter import MetricsServer

        tel.server = MetricsServer(registry, healthz_fn=tel.healthz,
                                   port=metrics_port)
        tel.logger.info(f"metrics: serving /metrics and /healthz on "
                        f"{tel.server.url} (phase={phase})")
    return tel
