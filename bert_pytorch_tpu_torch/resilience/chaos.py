"""Chaos drills: deterministic fault injection for the survival kit
(counterpart of bert_pytorch_tpu/resilience/chaos.py, on the port's
checkpoint format: `state.pt`, `extra.json` and the integrity sidecar).

`--chaos <mode> --chaos_step N` injects one of four deaths at an exact
step:

- `sigkill_at_step`     SIGKILL self before step N: a preemption without
  notice. The supervisor restarts the run, which resumes bit-identically.
- `sigterm_at_step`     SIGTERM self before step N: the polite notice.
  The emergency checkpoint of step N-1 lands; no completed step is lost.
- `corrupt_newest_ckpt` at the first checkpoint at or after step N: flip
  bytes in the newest checkpoint's largest data file, then SIGKILL. The
  resume quarantines it (`<step>.corrupt`) and falls back.
- `stall_dispatch`      sleep `stall_secs` inside the dispatch phase of
  step N: the hung-step watchdog trips and classifies a device hang.

Chaos fires only in the first incarnation under the supervisor
(BERT_SUPERVISOR_RESTARTS unset or 0): the restarted run must sail past
the injection step, or every drill would be a crash loop.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from typing import Callable, Optional, Tuple

from bert_pytorch_tpu_torch.resilience.manifest import (MANIFEST_NAME,
                                                        all_steps_on_disk,
                                                        step_dir_path)

CHAOS_MODES = ("sigkill_at_step", "sigterm_at_step",
               "corrupt_newest_ckpt", "stall_dispatch")

# mid-file bytes XOR-flipped by corrupt_newest_checkpoint
_FLIP_BYTES = 64


def chaos_enabled_env() -> bool:
    """Chaos fires only in the first incarnation (or unsupervised)."""
    try:
        return int(os.environ.get("BERT_SUPERVISOR_RESTARTS", "0")) == 0
    except ValueError:
        return True


def corrupt_newest_checkpoint(ckpt_dir: str,
                              log: Callable[[str], None] = print
                              ) -> Tuple[int, str]:
    """Flip bytes in the middle of the newest committed checkpoint's
    largest data file (the sidecar is exempt: the drill corrupts data,
    verification catches it). Returns (step, path corrupted)."""
    steps = all_steps_on_disk(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    step = steps[-1]
    step_dir = step_dir_path(ckpt_dir, step)
    largest, size = None, -1
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            if name == MANIFEST_NAME:
                continue
            path = os.path.join(root, name)
            n = os.path.getsize(path)
            if n > size:
                largest, size = path, n
    if largest is None:
        raise FileNotFoundError(f"checkpoint step {step} holds no files")
    with open(largest, "r+b") as f:
        f.seek(max(0, size // 2 - _FLIP_BYTES // 2))
        chunk = f.read(min(_FLIP_BYTES, size))
        f.seek(max(0, size // 2 - _FLIP_BYTES // 2))
        f.write(bytes(b ^ 0xFF for b in chunk))
    log(f"CHAOS: corrupted checkpoint step {step} "
        f"({os.path.relpath(largest, step_dir)}, {size} bytes, "
        f"{len(chunk)} flipped mid-file)")
    return step, largest


class ChaosMonkey:
    """Per-run fault injector; the loop calls the three hooks. Inert when
    mode is None or in a supervised restart."""

    def __init__(self, mode: Optional[str], at_step: int,
                 stall_secs: float = 3.0,
                 log: Callable[[str], None] = print):
        if mode is not None and mode not in CHAOS_MODES:
            raise ValueError(f"chaos mode {mode!r}: want one of "
                             f"{CHAOS_MODES}")
        self.mode = mode if (mode and chaos_enabled_env()) else None
        if mode and self.mode is None:
            log(f"chaos: --chaos {mode} disarmed (supervised restart "
                f"#{os.environ.get('BERT_SUPERVISOR_RESTARTS')} — the "
                "drill fires only in the first incarnation)")
        self.at_step = int(at_step)
        self.stall_secs = float(stall_secs)
        self._log = log
        self._fired = False

    def before_dispatch(self, step: int) -> None:
        """Called with the global step about to run (>= and a one-shot
        latch: a drill that silently never fires reads as one that
        passed)."""
        if self._fired or self.mode not in ("sigkill_at_step",
                                            "sigterm_at_step") \
                or step < self.at_step:
            return
        self._fired = True
        sig = (signal.SIGKILL if self.mode == "sigkill_at_step"
               else signal.SIGTERM)
        self._log(f"CHAOS: raising {signal.Signals(sig).name} before "
                  f"step {step} ({self.mode})")
        sys.stderr.flush()
        sys.stdout.flush()
        os.kill(os.getpid(), sig)

    def stall(self, step: int) -> None:
        """Called inside the dispatch phase."""
        if self._fired or self.mode != "stall_dispatch" \
                or step < self.at_step:
            return
        self._fired = True
        self._log(f"CHAOS: stalling dispatch of step {step} for "
                  f"{self.stall_secs:g}s (watchdog should trip)")
        time.sleep(self.stall_secs)

    def after_checkpoint(self, directory: str, step: int) -> None:
        """Called right after a periodic checkpoint of `directory` was
        committed (the port's saves are synchronous)."""
        if self._fired or self.mode != "corrupt_newest_ckpt" \
                or step < self.at_step:
            return
        self._fired = True
        corrupt_newest_checkpoint(directory, log=self._log)
        self._log("CHAOS: raising SIGKILL after corrupting the newest "
                  "checkpoint (resume must quarantine + fall back)")
        sys.stderr.flush()
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
