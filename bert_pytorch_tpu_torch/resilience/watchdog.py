"""Hung-step watchdog: a daemon thread that notices when the loop stops
(counterpart of bert_pytorch_tpu/resilience/watchdog.py).

A wedged card or a dead data source does not crash a training job; it
freezes it. The health pack cannot see that (no step completes) and no
exception unwinds. The watchdog is fed by StepWatch's phase transitions
(`StepWatch.phase_listener`), so it knows which host phase is live and
for how long; when a watched phase exceeds `timeout_s` it

- dumps every thread's stack (sys._current_frames) to stderr and to a
  `watchdog_stacks_*.txt` in the run's output directory,
- adds one to `bert_watchdog_stalls_total{kind=...}`,
- and, with `action="abort"`, hard-exits with a distinct code:
  EXIT_WATCHDOG_DEVICE_HANG (72) for a stalled dispatch, metric_flush,
  h2d or checkpoint, EXIT_WATCHDOG_INPUT_STARVED (73) for a stalled
  data_wait. With `action="warn"` it logs and dumps once a stall and
  re-arms on the next phase transition.

The card runs asynchronously: `dispatch` queues the step's kernels and
returns, and the wait for them sits in `metric_flush` (the `.item()` that
reads the step's metrics), so both count as device-side. With a flight
recorder (`recorder`), a trip also dumps a `watchdog_<kind>` bundle and
names it in the message.

`os._exit` is deliberate: the main thread is wedged inside a blocking
call, so raising into it is not available; the stacks are the orderly
part of this shutdown.
"""

from __future__ import annotations

import io
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from bert_pytorch_tpu_torch.resilience import (EXIT_WATCHDOG_DEVICE_HANG,
                                               EXIT_WATCHDOG_INPUT_STARVED)

INPUT_PHASES = frozenset({"data_wait"})
DEVICE_PHASES = frozenset({"dispatch", "metric_flush", "h2d",
                           "checkpoint"})
WATCHED_PHASES = INPUT_PHASES | DEVICE_PHASES


class HungStepWatchdog:
    """Daemon-thread stall detector fed by StepWatch phase transitions.

        wd = HungStepWatchdog(timeout_s=..., action="abort",
                              registry=tel.registry, out_dir=out)
        sw.phase_listener = wd.on_phase
        wd.start()
        ...
        wd.close()
    """

    def __init__(self, timeout_s: float, action: str = "abort",
                 registry=None, log: Callable[[str], None] = print,
                 out_dir: Optional[str] = None, recorder=None,
                 time_fn: Callable[[], float] = time.monotonic,
                 exit_fn: Callable[[int], None] = os._exit):
        if action not in ("abort", "warn"):
            raise ValueError(f"watchdog action {action!r}: want abort|warn")
        self.timeout_s = float(timeout_s)
        self.action = action
        self._log = log
        self.out_dir = out_dir
        self.recorder = recorder
        self._time = time_fn
        self._exit = exit_fn
        self._lock = threading.Lock()
        self._current: Optional[tuple] = None         # (phase, enter time)
        self._tripped_entry: Optional[tuple] = None   # warn-mode re-arm key
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stalls = 0
        self.last_stall: Optional[dict] = None
        self._stalls_total = None
        if registry is not None:
            self._stalls_total = registry.counter(
                "bert_watchdog_stalls_total",
                "hung-step watchdog trips (phase exceeded "
                "--watchdog_timeout)", labels=("kind",))

    def on_phase(self, name: str, entering: bool) -> None:
        """StepWatch.phase_listener hook."""
        if name not in WATCHED_PHASES:
            return
        with self._lock:
            self._current = (name, self._time()) if entering else None

    def start(self) -> "HungStepWatchdog":
        self._thread = threading.Thread(target=self._loop,
                                        name="hung-step-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        poll = max(0.05, min(1.0, self.timeout_s / 4.0))
        while not self._stop.wait(poll):
            with self._lock:
                current = self._current
            if current is None:
                continue
            name, t0 = current
            age = self._time() - t0
            if age < self.timeout_s or self._tripped_entry == current:
                continue
            self._tripped_entry = current
            self._trip(name, age)

    def _trip(self, phase: str, age: float) -> None:
        kind = ("input_starvation" if phase in INPUT_PHASES
                else "device_hang")
        code = (EXIT_WATCHDOG_INPUT_STARVED if kind == "input_starvation"
                else EXIT_WATCHDOG_DEVICE_HANG)
        self.stalls += 1
        self.last_stall = {"phase": phase, "kind": kind,
                           "age_s": round(age, 3)}
        if self._stalls_total is not None:
            self._stalls_total.inc(kind=kind)
        stacks_path = self._dump_stacks(phase, kind)
        bundle = None
        if self.recorder is not None:
            try:
                bundle = self.recorder.dump(f"watchdog_{kind}")
            except Exception:
                pass    # the alarm must not die on a full disk
        self._log(
            f"WATCHDOG: phase '{phase}' stalled for {age:.1f}s "
            f"(> --watchdog_timeout {self.timeout_s:g}s) — classified "
            f"{kind}"
            + (f"; thread stacks: {stacks_path}" if stacks_path else "")
            + (f"; flight-recorder bundle: {bundle}" if bundle else "")
            + (f"; aborting with exit code {code}"
               if self.action == "abort" else "; action=warn, training on"))
        if self.action == "abort":
            sys.stdout.flush()
            self._exit(code)

    def _dump_stacks(self, phase: str, kind: str) -> Optional[str]:
        """Every thread's stack, to stderr always and to a file in
        out_dir when it is set (the stderr copy survives a full disk)."""
        buf = io.StringIO()
        buf.write(f"hung-step watchdog: phase={phase} kind={kind} "
                  f"timeout={self.timeout_s:g}s\n")
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sorted(sys._current_frames().items()):
            buf.write(f"\n--- thread {names.get(ident, '?')} "
                      f"(ident {ident}) ---\n")
            buf.write("".join(traceback.format_stack(frame)))
        text = buf.getvalue()
        sys.stderr.write(text)
        sys.stderr.flush()
        if not self.out_dir:
            return None
        try:
            path = os.path.join(
                self.out_dir,
                f"watchdog_stacks_{int(time.time())}_{kind}.txt")
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
            return path
        except OSError:
            return None


def arm_watchdog(timeout_s: float, action: str, stepwatch,
                 registry=None, log: Callable[[str], None] = print,
                 out_dir: Optional[str] = None, recorder=None
                 ) -> Optional[HungStepWatchdog]:
    """Build, start and hook a watchdog into `stepwatch`; None (off) when
    timeout_s <= 0."""
    if timeout_s <= 0:
        return None
    wd = HungStepWatchdog(timeout_s=timeout_s, action=action,
                          registry=registry, log=log, out_dir=out_dir,
                          recorder=recorder).start()
    stepwatch.phase_listener = wd.on_phase
    log(f"watchdog: armed at {timeout_s:g}s per host phase, "
        f"action={action} (device hang -> exit "
        f"{EXIT_WATCHDOG_DEVICE_HANG}, input starvation -> exit "
        f"{EXIT_WATCHDOG_INPUT_STARVED})")
    return wd
