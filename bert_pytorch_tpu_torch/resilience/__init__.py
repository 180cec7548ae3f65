"""The survival kit (counterpart of bert_pytorch_tpu/resilience/):
preemption-safe emergency checkpoints (preemption.py), checkpoint
integrity sidecars and quarantine (manifest.py), the hung-step watchdog
(watchdog.py), the chaos drills (chaos.py) and, outside the process,
tools/supervise.py, the restart loop. Standard library only, so the
supervisor runs without torch.

The exit-code contract below is the JAX package's, so a supervisor can
classify a death without parsing logs. Signals keep the shell convention
128 + signal (SIGTERM -> 143, SIGINT -> 130).

  retryable      : 128 + signal (preemption), any unlisted nonzero code
                   (a crash), EXIT_WATCHDOG_INPUT_STARVED (often a
                   transient data stall), EXIT_SLO_BREACH (a sustained
                   page-severity train SLO breach that a fresh process
                   usually clears)
  NOT retryable  : EXIT_NONFINITE_HALT (a restart replays the same
                   deterministic blowup), EXIT_WATCHDOG_DEVICE_HANG (a
                   wedged card wants a drain, not the same host again)
"""

from __future__ import annotations

EXIT_NONFINITE_HALT = 71          # --nonfinite_action=halt tripped
EXIT_WATCHDOG_DEVICE_HANG = 72    # dispatch/metric_flush/h2d/checkpoint
EXIT_WATCHDOG_INPUT_STARVED = 73  # data_wait stalled (input pipeline)
# the supervisor's own verdicts (tools/supervise.py)
EXIT_CRASH_LOOP = 74              # restarts without checkpoint progress
EXIT_RESTART_BUDGET = 75          # max restarts exhausted
EXIT_SLO_BREACH = 76              # --slo_action=halt: sustained page breach

# exit codes tools/supervise.py refuses to retry by default
NO_RETRY_EXIT_CODES = (EXIT_NONFINITE_HALT, EXIT_WATCHDOG_DEVICE_HANG)
