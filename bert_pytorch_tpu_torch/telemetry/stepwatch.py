"""Host-side step, throughput and MFU accounting, and the price of a
device-hour (counterpart of bert_pytorch_tpu/telemetry/stepwatch.py).

StepWatch keeps per-interval accounting while a training loop runs: wall
time per optimization step, named host phases, seq/s and tokens/s, real
tokens/s, pad fraction and packing efficiency when the loop feeds each
batch's real-token count (`note_tokens`), MFU from the analytic BERT
FLOPs formula (`flops_per_seq`) against the card's peak, and the cost of a
token.

Step times on a card: the loop queues work ahead of the card, so the host
clock of an interval is only the card's time when the queue has drained.
`sync` (torch.cuda.synchronize for a CUDA run) is called once at each log
boundary, before the interval's clock is read, and never between.

The port runs on one card, so the record's device-seconds are the
interval's wall time. With a `registry`, `bert_train_steps_total` ticks
at every `step_done` and `bert_step_time_ms_hist` takes each interval's
step time. `phase_listener`, when set, hears every phase's entry and exit
(the hung-step watchdog's feed, resilience/watchdog.py). While a
torch.profiler runs, each phase is a `host/<name>` range in its trace
(`phase`). The one deliberate
difference in the record from the JAX module: the peak table holds
the NVIDIA cards' published dense tensor-core peaks, and there is no
default peak. An unknown device (the CPU included) reports `mfu` 0.0 and
`peak_flops` 0, the record's own branch for a run without a known peak.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, Optional

# (name fragment, bf16 dense FLOP/s, f32 FLOP/s without tensor cores),
# NVIDIA data sheets; the first fragment found in the device name wins, so
# the SXM part ("NVIDIA H100 80GB HBM3") falls through to the "H100" row.
PEAK_FLOPS = (
    ("H100 PCIe", 756e12, 51e12),
    ("H100 NVL", 835e12, 60e12),
    ("H200", 989e12, 67e12),
    ("H100", 989e12, 67e12),
)

DEFAULT_COST_PER_DEVICE_HOUR = 1.0


def resolve_cost_per_device_hour(value: Optional[float] = None) -> float:
    """An explicit value, else the BERT_COST_PER_DEVICE_HOUR environment
    variable, else 1.0 (normalized device-hours per 1k tokens: the
    serving scheduler and StepWatch price device-seconds at this rate per
    device-hour)."""
    if value is not None:
        return float(value)
    env = os.environ.get("BERT_COST_PER_DEVICE_HOUR", "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return DEFAULT_COST_PER_DEVICE_HOUR


def lookup_peak_flops(device_kind: str,
                      dtype: str = "bf16") -> Optional[float]:
    """The card's peak FLOP/s at the compute dtype ("bf16" or
    "f32"/"float32"), else None (the CPU, an unknown card)."""
    d = dtype.lower()
    if d in ("f32", "float32", "fp32"):
        col = 2
    elif d in ("bf16", "bfloat16"):
        col = 1
    else:
        raise ValueError(f"unknown compute dtype for peak lookup: {dtype!r}")
    for row in PEAK_FLOPS:
        if row[0].lower() in (device_kind or "").lower():
            return row[col]
    return None


def flops_per_seq(cfg, seq_len: int, vocab: int, n_pred: int) -> float:
    """Analytic forward + backward FLOPs of one sequence: 6 x params x
    positions for the dense matmuls plus 12 L E S^2 for the attention
    score and value products; the MLM transform and tied decoder run on
    the n_pred gathered positions only."""
    E, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    per_layer = 4 * E * E + 2 * E * F
    trunk = L * per_layer * seq_len
    head = (vocab * E + E * E) * n_pred
    return 6.0 * (trunk + head) + 12.0 * L * E * seq_len * seq_len


def _host_annotation(name: str):
    """`torch.profiler.record_function(f"host/{name}")` while a profiler
    is on, else a no-op context."""
    import torch

    if torch.autograd.profiler._is_profiler_enabled:  # noqa: SLF001
        return torch.profiler.record_function(f"host/{name}")
    return nullcontext()


class StepWatch:
    """Interval accounting for the host train loop.

        sw = StepWatch(flops_per_step=..., seqs_per_step=..., seq_len=...,
                       peak_flops=..., log_freq=10, sync=...)
        with sw.phase("dispatch"): metrics = step_fn(...)
        rec = sw.step_done()        # a dict every log_freq steps, else None

    `flops_per_step` is the whole optimization step's, flops_per_seq x
    the rows a step computes. `peak_flops=None` (unknown device) reports
    mfu 0.0 and peak_flops 0. `sync`, when given, is called at each log
    boundary (and `flush`) before the clock is read."""

    def __init__(self, flops_per_step: float, seqs_per_step: float,
                 seq_len: int, peak_flops: Optional[float],
                 log_freq: int = 10,
                 time_fn: Callable[[], float] = time.perf_counter,
                 sync: Optional[Callable[[], None]] = None,
                 registry=None):
        self.flops_per_step = float(flops_per_step)
        self.seqs_per_step = float(seqs_per_step)
        self.seq_len = int(seq_len)
        self.peak_flops = peak_flops
        self.cost_per_device_hour = resolve_cost_per_device_hour()
        self.log_freq = max(1, int(log_freq))
        self._time = time_fn
        self._sync = sync
        self._phases: Dict[str, float] = {}
        # fn(name, entering) on every phase entry and exit, or None
        self.phase_listener: Optional[Callable[[str, bool], None]] = None
        self._steps = 0
        self._interval_start = self._time()
        self._real_tokens = 0.0
        self._noted_tokens = False
        self._steps_total = self._step_hist = None
        if registry is not None:
            self._steps_total = registry.counter(
                "bert_train_steps_total", "optimization steps completed")
            self._step_hist = registry.histogram(
                "bert_step_time_ms_hist",
                "distribution of per-step wall time (ms), sampled per "
                "StepWatch interval")

    @contextmanager
    def phase(self, name: str):
        """Time a host phase of the interval. While a torch.profiler
        runs, the phase is also a `host/<name>` record_function range in
        its trace (the JAX loop's TraceAnnotation names), which
        telemetry/trace.py reads as host time; without a profiler no
        range is opened."""
        listener = self.phase_listener
        if listener is not None:
            listener(name, True)
        t0 = self._time()
        annotation = _host_annotation(name)
        try:
            with annotation:
                yield
        finally:
            self._phases[name] = (self._phases.get(name, 0.0)
                                  + self._time() - t0)
            if listener is not None:
                listener(name, False)

    @contextmanager
    def pause(self):
        """Leave a span that is not training (an eval) out of the
        interval's clock."""
        if self._sync is not None:
            self._sync()
        t0 = self._time()
        try:
            yield
        finally:
            self._interval_start += self._time() - t0

    def note_tokens(self, real_tokens: float) -> None:
        """Count a dispatched batch's real (non-pad) tokens; unlocks
        real_tokens_per_sec, pad_fraction and packing_efficiency."""
        self._real_tokens += float(real_tokens)
        self._noted_tokens = True

    def step_done(self, n: int = 1) -> Optional[Dict[str, float]]:
        """Count n optimization steps; at a log_freq boundary, return the
        interval record and reset."""
        self._steps += n
        if self._steps_total is not None:
            self._steps_total.inc(n)
        if self._steps < self.log_freq:
            return None
        return self._emit()

    def flush(self) -> Optional[Dict[str, float]]:
        """The partial interval's record (None without steps since the
        last boundary)."""
        if self._steps == 0:
            return None
        return self._emit()

    def _emit(self) -> Dict[str, float]:
        if self._sync is not None:
            with self.phase("metric_flush"):    # a wait for the card
                self._sync()
        now = self._time()
        wall = max(now - self._interval_start, 1e-9)
        steps = self._steps
        seqs_per_sec = self.seqs_per_step * steps / wall
        achieved = self.flops_per_step * steps / wall
        rec = {
            "steps": steps,
            "step_time_ms": round(wall / steps * 1e3, 3),
            "seq_per_sec": round(seqs_per_sec, 2),
            "tokens_per_sec": round(seqs_per_sec * self.seq_len, 1),
            "model_flops_per_sec": round(achieved, 1),
            "mfu": (round(achieved / self.peak_flops, 6)
                    if self.peak_flops else 0.0),
            "peak_flops": self.peak_flops or 0,
        }
        if self._noted_tokens:
            slot_tokens = self.seqs_per_step * steps * self.seq_len
            eff = self._real_tokens / max(slot_tokens, 1.0)
            rec["real_tokens_per_sec"] = round(self._real_tokens / wall, 1)
            rec["pad_fraction"] = round(max(0.0, 1.0 - eff), 6)
            rec["packing_efficiency"] = round(eff, 6)
        device_seconds = wall        # one card
        cost_tokens = (self._real_tokens if self._noted_tokens
                       else self.seqs_per_step * steps * self.seq_len)
        rec["device_seconds_per_step"] = round(device_seconds / steps, 6)
        cost = device_seconds / 3600.0 * self.cost_per_device_hour
        rec["cost_per_1k_tokens"] = (round(cost / (cost_tokens / 1000.0), 9)
                                     if cost_tokens > 0 else 0.0)
        if self._step_hist is not None:
            self._step_hist.observe(rec["step_time_ms"])
        for name, secs in sorted(self._phases.items()):
            rec[f"{name}_ms"] = round(secs / steps * 1e3, 3)
        self._phases = {}
        self._steps = 0
        self._interval_start = now
        self._real_tokens = 0.0
        return rec
