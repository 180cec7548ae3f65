"""Preemption guard and the emergency checkpoint (counterpart of
bert_pytorch_tpu/resilience/preemption.py).

On SIGTERM (or SIGINT) `PreemptionGuard` notes the signal and lets the
handler installed before it run, or, with none, raises SystemExit(128 +
signal) itself, so the entry point unwinds through its except-path. There the entry point calls
`finetune_emergency_save`: one synchronous save of the last completed
step, with the checkpoint's integrity sidecar, so a preempted run loses
no completed step. The handler never saves: it only records and raises;
the save runs on the normal unwind path.

The port's train step updates the parameters and the optimizer moments in
place, so a step cut in half would leave a state that belongs to no step.
The loop therefore runs each step inside `guard.hold()`: a signal that
arrives there is noted at once and raised when the step (and the loop's
note of it) is whole.
"""

from __future__ import annotations

import contextlib
import signal
from typing import Any, Callable, Dict, Iterator, Optional

PREEMPTION_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionGuard:
    """Layered preemption-notice handler.

        guard = PreemptionGuard(log=log)
        guard.install()
        try:
            ...
            with guard.hold():
                step(...)
        except BaseException as exc:
            finetune_emergency_save(guard, exc, ...)
            raise
        finally:
            guard.close()
    """

    def __init__(self, log: Callable[[str], None] = print):
        self._log = log
        self.preempted_signal: Optional[int] = None
        self._old: Dict[int, Any] = {}
        self._held = False
        self._pending: Optional[tuple] = None

    def install(self) -> None:
        """Install the handler; the previous handlers are kept and chained
        to. A signal that cannot be handled here (not the main thread) is
        left as it was."""
        for sig in PREEMPTION_SIGNALS:
            try:
                self._old[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                pass

    def _on_signal(self, signum, frame):
        if self.preempted_signal is not None:
            # already unwinding toward the emergency checkpoint: a repeat
            # signal must not raise inside the save it exists to guarantee
            self._log(f"preemption: {signal.Signals(signum).name} "
                      "repeated — emergency checkpoint already in "
                      "progress, ignoring")
            return
        self.preempted_signal = signum
        if self._held:
            self._pending = (signum, frame)
            return
        self._raise(signum, frame)

    def _raise(self, signum, frame):
        old = self._old.get(signum)
        if callable(old):
            old(signum, frame)
        else:
            raise SystemExit(128 + signum)

    @contextlib.contextmanager
    def hold(self) -> Iterator[None]:
        """Within the block a signal is noted, and raised at its end."""
        self._held = True
        try:
            yield
        finally:
            self._held = False
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._raise(*pending)

    def close(self) -> None:
        """Restore the handlers as found. Idempotent."""
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old.clear()


def is_preemption_exit(exc: BaseException) -> bool:
    """True when `exc` is the SystemExit a preemption signal raises
    (128 + signal)."""
    return (isinstance(exc, SystemExit)
            and isinstance(exc.code, int)
            and exc.code in {128 + int(s) for s in PREEMPTION_SIGNALS})


def finetune_emergency_save(guard: PreemptionGuard, exc: BaseException,
                            survival: Dict[str, Any], ckpt_dir: str,
                            task: str, log: Callable[[str], None] = print
                            ) -> None:
    """The finetune loop's except-path: when the unwind is a preemption
    and a step has completed, save the last completed step's state
    (`survival`: {"state": TrainState, "step": int}) under `ckpt_dir`.
    Never raises: the original exception keeps propagating."""
    if not survival:
        return
    if guard.preempted_signal is None and not is_preemption_exit(exc):
        return
    from bert_pytorch_tpu_torch.training.checkpoint import CheckpointManager

    try:
        emergency_save(CheckpointManager(ckpt_dir, log=log),
                       survival["step"], survival["state"].state_dict(),
                       extra={"task": task, "emergency": True}, log=log)
    except Exception as e:
        log(f"WARNING: emergency checkpoint failed: {e}")


def emergency_save(manager, step: int, state: Dict[str, Any],
                   extra: Dict[str, Any],
                   log: Callable[[str], None] = print) -> bool:
    """Save the last completed step, committed with its integrity sidecar
    before the process exits. False when that step is on disk already
    (the signal landed on a boundary: nothing at risk)."""
    if manager.latest_step() == int(step):
        log(f"preemption: checkpoint for step {step} already on disk — "
            "zero completed steps at risk")
        return False
    # torch.save reads every tensor, so the in-flight step's kernels
    # finish before a byte is written
    manager.save(int(step), state, extra=extra)
    log(f"preemption: emergency checkpoint saved at step {step} "
        "(synchronous save — zero completed steps lost)")
    return True
