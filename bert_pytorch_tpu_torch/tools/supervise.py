"""Supervised restart loop for the port's pretraining (counterpart of
tools/supervise.py): keep a run alive across deaths.

    python -m bert_pytorch_tpu_torch.tools.supervise \\
        --ckpt_dir out/pretrain_ckpts \\
        -- --output_dir out --input_dir shards ... (run_pretraining flags)

runs `python -m bert_pytorch_tpu_torch.run_pretraining <flags>` and

- reruns it after a retryable death, with exponential backoff and jitter;
- does not retry the codes of NO_RETRY_EXIT_CODES: EXIT_NONFINITE_HALT
  (71, a restart replays the same blowup) and EXIT_WATCHDOG_DEVICE_HANG
  (72, a wedged card wants a drain); the code is passed up. Signals
  (128 + signal, negative return codes) and other codes are retried,
  EXIT_SLO_BREACH (76) included;
- detects a crash loop: each restart must move the newest checkpoint on
  disk (`--ckpt_dir`); after
  --crash_loop_tolerance deaths in a row without progress it exits
  EXIT_CRASH_LOOP (74);
- spends at most --max_restarts restarts, then exits EXIT_RESTART_BUDGET
  (75);
- hands the child BERT_SUPERVISOR_RESTARTS (the attempt's index: the
  chaos drills fire only in attempt 0, /healthz reports it);
- on SIGTERM or SIGINT forwards the signal to the child (its emergency
  checkpoint) and stops supervising with the child's code.

Standard library only below the port's resilience package.
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import subprocess
import sys
import threading

from bert_pytorch_tpu_torch.resilience import (EXIT_CRASH_LOOP,
                                               EXIT_RESTART_BUDGET,
                                               NO_RETRY_EXIT_CODES)
from bert_pytorch_tpu_torch.resilience.manifest import all_steps_on_disk

ENTRY = "bert_pytorch_tpu_torch.run_pretraining"


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", required=True, type=str,
                   help="checkpoint directory the run saves into "
                        "(<output_dir>/pretrain_ckpts): the crash-loop "
                        "detector's progress probe")
    p.add_argument("--max_restarts", type=int, default=16,
                   help="total restart budget before exit 75")
    p.add_argument("--crash_loop_tolerance", type=int, default=3,
                   help="consecutive deaths without checkpoint progress "
                        "before exit 74")
    p.add_argument("--backoff_base", type=float, default=2.0,
                   help="first retry delay in seconds; doubles per "
                        "consecutive failure without progress")
    p.add_argument("--backoff_max", type=float, default=120.0,
                   help="backoff ceiling in seconds")
    p.add_argument("--backoff_jitter", type=float, default=0.25,
                   help="uniform jitter fraction added to each delay")
    p.add_argument("--no_retry_codes", type=str,
                   default=",".join(str(c) for c in NO_RETRY_EXIT_CODES),
                   help="comma-separated exit codes never retried "
                        "(default: 71 non-finite halt, 72 watchdog device "
                        "hang)")
    p.add_argument("run_args", nargs=argparse.REMAINDER,
                   help="run_pretraining's flags, after `--`")
    args = p.parse_args(argv)
    rest = list(args.run_args)
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        p.error("no run_pretraining flags given (pass them after `--`)")
    args.run_args = rest
    return args


def _log(msg: str) -> None:
    print(f"supervise: {msg}", file=sys.stderr, flush=True)


def _latest_step(ckpt_dir: str):
    steps = all_steps_on_disk(ckpt_dir)
    return steps[-1] if steps else None


def supervise(cmd, ckpt_dir: str, max_restarts: int = 16,
              crash_loop_tolerance: int = 3, backoff_base: float = 2.0,
              backoff_max: float = 120.0, backoff_jitter: float = 0.25,
              no_retry_codes=NO_RETRY_EXIT_CODES,
              env=None, sleep=None, log=_log) -> int:
    """The restart loop over the command `cmd` (a list); returns the
    final exit code. `sleep` defaults to an interruptible wait, so an
    operator signal cuts a backoff short."""
    no_retry = {int(c) for c in no_retry_codes}
    restarts = no_progress = 0
    stopping = [None]            # the signal the supervisor received
    child_holder = [None]
    stop_event = threading.Event()
    if sleep is None:
        sleep = stop_event.wait

    def _on_signal(signum, frame):
        stopping[0] = signum
        stop_event.set()
        child = child_holder[0]
        if child is not None and child.poll() is None:
            log(f"forwarding {signal.Signals(signum).name} to child "
                f"pid {child.pid} (emergency checkpoint path)")
            try:
                child.send_signal(signum)
            except OSError:
                pass

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass

    last_rc = 0
    try:
        while True:
            if stopping[0] is not None:
                log(f"supervisor received "
                    f"{signal.Signals(stopping[0]).name} between attempts "
                    "— stopping supervision")
                if last_rc == 0:
                    return 0
                return last_rc if last_rc > 0 else 128 + (-last_rc)
            step_before = _latest_step(ckpt_dir)
            child_env = dict(os.environ if env is None else env)
            child_env["BERT_SUPERVISOR_RESTARTS"] = str(restarts)
            child_env["BERT_SUPERVISED"] = "1"
            log(f"attempt {restarts}: launching (checkpoint step on disk: "
                f"{step_before}): {' '.join(cmd)}")
            child = subprocess.Popen(cmd, env=child_env)
            child_holder[0] = child
            rc = child.wait()
            child_holder[0] = None
            last_rc = rc
            if rc == 0:
                log("run completed cleanly (exit 0) — supervision done")
                return 0
            name = _describe_exit(rc)
            if stopping[0] is not None:
                log(f"supervisor received "
                    f"{signal.Signals(stopping[0]).name}; child exited "
                    f"{name} — stopping supervision (operator stop)")
                return rc if rc > 0 else 128 + (-rc)
            if rc in no_retry:
                log(f"child exited {name} — in the no-retry set "
                    f"{sorted(no_retry)}; halting supervision (a restart "
                    "would replay the same failure)")
                return rc
            step_after = _latest_step(ckpt_dir)
            progressed = step_after is not None and (
                step_before is None or step_after > step_before)
            if progressed:
                no_progress = 0
            else:
                no_progress += 1
                if no_progress >= crash_loop_tolerance:
                    log(f"CRASH LOOP: {no_progress} consecutive deaths "
                        f"without checkpoint progress (stuck at step "
                        f"{step_after}) — exit {EXIT_CRASH_LOOP}")
                    return EXIT_CRASH_LOOP
            restarts += 1
            if restarts > max_restarts:
                log(f"restart budget exhausted ({max_restarts}) — exit "
                    f"{EXIT_RESTART_BUDGET}")
                return EXIT_RESTART_BUDGET
            # exponential in the no-progress streak: a death after real
            # progress restarts at the base delay
            delay = min(backoff_base * (2.0 ** no_progress), backoff_max)
            delay *= 1.0 + backoff_jitter * random.random()
            log(f"child exited {name}; restart {restarts}/{max_restarts} "
                f"in {delay:.1f}s (checkpoint progress: {step_before} -> "
                f"{step_after})")
            sleep(delay)
    finally:
        for sig, old in old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass


def _describe_exit(rc: int) -> str:
    if rc < 0:
        try:
            return f"{rc} (killed by {signal.Signals(-rc).name})"
        except ValueError:
            return str(rc)
    if rc > 128:
        try:
            return f"{rc} (128+{signal.Signals(rc - 128).name})"
        except ValueError:
            return str(rc)
    names = {71: "NONFINITE_HALT", 72: "WATCHDOG_DEVICE_HANG",
             73: "WATCHDOG_INPUT_STARVED", 76: "SLO_BREACH"}
    return f"{rc} ({names[rc]})" if rc in names else str(rc)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    codes = [int(c) for c in str(args.no_retry_codes).split(",")
             if str(c).strip()]
    return supervise(
        [sys.executable, "-m", ENTRY] + args.run_args, args.ckpt_dir,
        max_restarts=args.max_restarts,
        crash_loop_tolerance=args.crash_loop_tolerance,
        backoff_base=args.backoff_base, backoff_max=args.backoff_max,
        backoff_jitter=args.backoff_jitter, no_retry_codes=codes)


if __name__ == "__main__":
    sys.exit(main())
