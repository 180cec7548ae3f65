#!/usr/bin/env python3
"""Where the server's host time goes under a fixed load, and what its host
settings move. One seeded random BERT-Large five-task server runs on the
card in this process; tools/serve_load.py's open loop sends the load from
a process of its own, one leg a setting, on the same server.

    python3 bert_pytorch_tpu_torch/tools/serve_host.py [--rates 100,140] \\
        [--duration 20] [--out chiprun_out/serve_host.json]

The settings a leg runs with: featurization in the server's worker
processes (run_server.FEATURIZE_WORKERS) or in the handler threads; the
interpreter's switch interval (5 ms, its default, or 0.5 ms); the
scheduler's batching window (2 ms, run_server's default, or 0); each
setting at each of `--rates` requests/s, the rates in turn. A leg
reports the replies' codes, p50 and p99, the trace ring's dominant span
for the slowest requests, the server process's CPU ms a request and that
of its scheduler threads (pack, forward, complete), its accept loop and
the rest (the handler threads, which exit with their connections, and
threads Python does not start: the CUDA driver's), and the batches the
scheduler ran with their mean segments. It needs a CUDA card. Prints one JSON line a leg, then
nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
# (name, featurization in workers, switch interval s, batching window ms)
LEGS = (("as built", True, 0.005, 2.0),
        ("handler threads", False, 0.005, 2.0),
        ("switch 0.5 ms", True, 0.0005, 2.0),
        ("window 0", True, 0.005, 0.0),
        ("switch 0.5 ms, window 0", True, 0.0005, 0.0),
        ("as built, again", True, 0.005, 2.0))


def thread_cpu_ms() -> dict:
    """CPU ms of each live thread of this process, by native id."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[int(tid)] = (int(fields[11]) + int(fields[12])) * 1e3 / tick
    return out


def run_leg(handle, featurizers, rate: float, duration: float, seed: int,
            name: str, workers: bool, switch_s: float, window_ms: float
            ) -> dict:
    for service in handle.frontend.services.values():
        service.featurize = featurizers[workers]
    sys.setswitchinterval(switch_s)
    handle.scheduler.batch_wait_s = window_ms / 1e3
    named = {t.native_id: t.name for t in threading.enumerate()}
    sched = handle.scheduler
    batches0 = sum(sched.batches.values())
    ok0 = sched.outcomes["ok"]
    cpu0, threads0 = time.process_time(), thread_cpu_ms()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "serve_load.py"), "--url",
         handle.url, "--rate", str(rate), "--duration", str(duration),
         "--seed", str(seed)], capture_output=True, text=True, timeout=900)
    cpu = (time.process_time() - cpu0) * 1e3
    threads1 = thread_cpu_ms()
    if proc.returncode != 0:
        raise RuntimeError(f"serve_load exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    fixed = json.loads(proc.stdout.strip().splitlines()[-1])["fixed"]
    by_group = {"scheduler": 0.0, "accept loop": 0.0}
    for tid, ms in threads1.items():
        group = {"serve-batcher": "scheduler", "serve-forward": "scheduler",
                 "serve-complete": "scheduler",
                 "serve-frontend": "accept loop"}.get(named.get(tid))
        if group:
            by_group[group] += ms - threads0.get(tid, 0.0)
    by_group["rest"] = cpu - sum(by_group.values())
    n = max(1, fixed["sent"])
    batches = sum(sched.batches.values()) - batches0
    return {"leg": name, "featurize_workers": workers,
            "switch_interval_s": switch_s, "batch_wait_ms": window_ms,
            "rate": rate, "duration_s": duration, "sent": fixed["sent"],
            "codes": fixed["codes"], "p50_ms": fixed["p50_ms"],
            "p99_ms": fixed["p99_ms"],
            "dominant_span": (fixed.get("slowest_traces") or {}).get(
                "dominant"),
            "cpu_ms_a_request": cpu / n,
            "cpu_ms_a_request_by_thread": {k: v / n
                                           for k, v in by_group.items()},
            "batches": batches,
            "segments_a_batch": ((sched.outcomes["ok"] - ok0) / batches
                                 if batches else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rates", default="100,140")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the legs here too")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("serve_host: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.serving.frontend import Featurizer
    from bert_pytorch_tpu_torch.tools.serve_load import write_checkpoints

    tmp = tempfile.mkdtemp(prefix="serve_host_")
    cfg = os.path.join(REPO, "configs", "bert_large_uncased_config.json")
    ckpts = write_checkpoints(tmp, cfg)
    vocab = chip_smoke.serve_vocab(os.path.join(tmp, "vocab.txt"))
    argv = ["--model_config_file", cfg, "--vocab_file", vocab, "--port",
            "0", "--host", "127.0.0.1", "--labels", *chip_smoke.CONLL_TAGS]
    for task, path in sorted(ckpts.items()):
        argv += ["--task_checkpoint", f"{task}={path}"]
    handle = run_server.serve(run_server.parse_arguments(argv),
                              log=lambda m: None)
    in_threads = Featurizer(handle.featurizer.tokenizer, workers=0)
    legs = []
    try:
        for rate in [float(r) for r in args.rates.split(",") if r]:
            for name, workers, switch_s, window_ms in LEGS:
                legs.append(run_leg(handle, {True: handle.featurizer,
                                             False: in_threads},
                                    rate, args.duration, args.seed, name,
                                    workers, switch_s, window_ms))
                print(json.dumps(legs[-1]), flush=True)
    finally:
        sys.setswitchinterval(0.005)
        handle.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(legs, f, indent=1)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
