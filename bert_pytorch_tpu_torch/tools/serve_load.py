#!/usr/bin/env python3
"""Open-loop load against the port's server: request latency at a fixed
offered rate, and the rate at which p99 passes a bound.

    # against a running server
    python3 bert_pytorch_tpu_torch/tools/serve_load.py --url http://H:P \\
        [--rate 100] [--duration 30] [--ramp 150,200,300] [--seed 0]
    # A/B of checkouts on one card: each checkout's run_server in turn
    # (parent, this, this, parent), on the same seeded random BERT-Large
    # checkpoints of the five tasks and the same requests
    python3 bert_pytorch_tpu_torch/tools/serve_load.py \\
        --checkouts .chip_scratch/parent,.,.,.chip_scratch/parent

Arrivals are Poisson at `--rate` from `--seed`, sent on time whatever the
replies (open loop, one thread a request in flight); every block of five
arrivals is the five routes in a seeded order, each with a body drawn
from chip_smoke.py's synthetic requests (`route_bodies`, `pack_bodies`
and the SQuAD questions over contexts of 30 to 380 words). A request's
latency runs from its scheduled arrival to its reply. `--ramp` runs the
rates given after the fixed one, each for `--ramp_duration` seconds, and
stops at the first whose p99 passes `--bound_ms`. The server's trace ring
(GET /v1/traces) says where its slowest requests waited, and `--vocab`
times each route's featurization on the client's host. The A/B mode starts
`python -m bert_pytorch_tpu_torch.run_server` from each checkout (its own
kernels, built there), waits for its port file, measures, stops it with
SIGTERM and prints one JSON line a run, then nvidia-smi's name and power
limit. It needs a CUDA card; the client mode needs none.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
ROUTES = ("choice", "classify", "embed", "ner", "squad")


def request_pool(np, seed: int = 0) -> Dict[str, List[dict]]:
    """Every route's synthetic request bodies, as chip_smoke.py makes them
    for its serve phase."""
    sys.path.insert(0, REPO)
    import chip_smoke

    rng = np.random.RandomState(seed)
    pool = {t: list(bs) for t, bs in chip_smoke.route_bodies(np).items()}
    for t, bs in chip_smoke.pack_bodies(np).items():
        pool.setdefault(t, []).extend(bs)
    pool["squad"] = [{"question": q, "context": chip_smoke._context(rng, n)}
                     for q, n in zip(chip_smoke.QUESTIONS,
                                     (30, 45, 80, 170, 380))] + pool["squad"]
    return pool


def _post(url: str, route: str, body: dict, timeout: float) -> int:
    req = urllib.request.Request(url + f"/v1/{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except Exception:
        return 0


def _percentile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))]


def open_loop(np, url: str, pool: Dict[str, List[dict]], rate: float,
              duration: float, seed: int = 0,
              timeout: float = 60.0) -> dict:
    """Poisson arrivals at `rate` for `duration` seconds, sent on time;
    latency percentiles of the 200 replies, ms."""
    rng = np.random.RandomState(seed)
    arrivals, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= duration:
            break
        arrivals.append(t)
    routes = []
    while len(routes) < len(arrivals):
        routes.extend(ROUTES[i] for i in rng.permutation(len(ROUTES)))
    plan = [(a, r, pool[r][rng.randint(len(pool[r]))])
            for a, r in zip(arrivals, routes)]
    results: List[tuple] = []
    lock = threading.Lock()

    def fire(t_sched, route, body):
        code = _post(url, route, body, timeout)
        done = time.perf_counter()
        with lock:
            results.append((route, code, (done - t_sched) * 1e3))

    threads = []
    t0 = time.perf_counter()
    for a, route, body in plan:
        wait = t0 + a - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=fire, args=(t0 + a, route, body),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout + 5)
    wall = time.perf_counter() - t0
    ok = [ms for _, code, ms in results if code == 200]
    codes: Dict[str, int] = {}
    for _, code, _ in results:
        codes[str(code)] = codes.get(str(code), 0) + 1
    by_route = {r: {"p50_ms": _percentile([ms for rr, c, ms in results
                                           if rr == r and c == 200], 50),
                    "p99_ms": _percentile([ms for rr, c, ms in results
                                           if rr == r and c == 200], 99)}
                for r in ROUTES}
    return {"rate": rate, "duration_s": duration, "sent": len(plan),
            "codes": codes, "ok": len(ok), "wall_s": wall,
            "p50_ms": _percentile(ok, 50), "p99_ms": _percentile(ok, 99),
            "by_route": by_route}


def attribution(url: str, n: int = 32) -> Optional[dict]:
    """Where the slowest requests the server's trace ring kept spent
    their time: each span's summed ms over the `n` slowest traces, and
    the dominant one; None when the server has no GET /v1/traces."""
    try:
        with urllib.request.urlopen(url + f"/v1/traces?n={n}",
                                    timeout=60) as r:
            doc = json.loads(r.read())
    except Exception:
        return None
    by_span: Dict[str, float] = {}
    totals = {}
    for e in doc["traceEvents"]:
        name = e["name"].split("/", 1)[-1]
        by_span[name] = by_span.get(name, 0.0) + e["dur"] / 1e3
        totals[e["args"]["trace_id"]] = e["args"]["total_ms"]
    return {"traces": len(totals),
            "total_ms": sorted(totals.values(), reverse=True)[:5],
            "span_ms_sum": by_span,
            "dominant": max(by_span, key=by_span.get) if by_span else None}


def featurize_ms(np, pool: Dict[str, List[dict]], vocab: str) -> dict:
    """Host ms a request of each route spends in featurization (WordPiece
    and the request's segments, as the services make them), one thread,
    mean over the route's requests: the services run it under one lock
    the five routes share."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)

    tokenizer = get_wordpiece_tokenizer(vocab)
    out = {}
    for route, bodies in pool.items():
        t0 = time.perf_counter()
        for body in bodies:
            chip_smoke._route_parts(route, body, tokenizer, 512)
        out[route] = (time.perf_counter() - t0) * 1e3 / len(bodies)
    return out


def load_run(np, url: str, rate: float, duration: float, ramp: List[float],
             ramp_duration: float, bound_ms: float, seed: int,
             vocab: Optional[str] = None) -> dict:
    """The fixed-rate run (and where its slowest requests spent their
    time, from the server's trace ring), then the ramp up to the first
    rate whose p99 passes `bound_ms` (or whose replies are not all 200)."""
    pool = request_pool(np)
    # one request a route first, so no first-use cost lands in a reading
    for route in ROUTES:
        _post(url, route, pool[route][0], 120.0)
    out = {"fixed": open_loop(np, url, pool, rate, duration, seed),
           "ramp": []}
    out["fixed"]["slowest_traces"] = attribution(url)
    if vocab:
        out["featurize_ms"] = featurize_ms(np, pool, vocab)
    out["p99_passes_bound_at"] = None
    for r in ramp:
        res = open_loop(np, url, pool, r, ramp_duration, seed + int(r))
        out["ramp"].append(res)
        if (res["p99_ms"] is None or res["p99_ms"] > bound_ms
                or res["ok"] < res["sent"]):
            out["p99_passes_bound_at"] = r
            break
    out["bound_ms"] = bound_ms
    return out


def write_checkpoints(out_dir: str, cfg_path: str, seed: int = 0) -> dict:
    """Seeded random checkpoints (.pt state_dicts) of the five tasks at the
    config's width, as chip_smoke.py's serve phase writes them."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import init_weights
    from bert_pytorch_tpu_torch.tasks import registry

    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    opts = dict(chip_smoke.SERVE_OPTS, labels=list(chip_smoke.CONLL_TAGS))
    paths = {}
    for task in registry.all_tasks():
        model = registry.get(task).build_serving_model(
            config, torch.bfloat16, opts, torch.device("cuda"))
        init_weights(model, torch.Generator(device="cuda").manual_seed(seed),
                     std=config.initializer_range)
        paths[task] = os.path.join(out_dir, f"{task}.pt")
        torch.save(model.state_dict(), paths[task])
        del model
    torch.cuda.empty_cache()
    return paths


def serve_checkout(checkout: str, argv: List[str], port_file: str,
                   log_path: str, start_timeout: float = 1500.0):
    """Start `checkout`'s run_server; returns (process, url) once its port
    file exists."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.run_server", *argv,
         "--port", "0", "--host", "127.0.0.1", "--port_file", port_file],
        cwd=os.path.abspath(checkout), env=env, stdout=log,
        stderr=subprocess.STDOUT)
    deadline = time.time() + start_timeout
    while not os.path.exists(port_file):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            raise RuntimeError(f"{checkout}: server did not start (see "
                               f"{log_path})")
        time.sleep(0.5)
    with open(port_file) as f:
        return proc, f"http://127.0.0.1:{f.read().strip()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--url", default=None)
    ap.add_argument("--checkouts", default=None,
                    help="comma-separated checkout directories, in order")
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--ramp", default="",
                    help="comma-separated rates after the fixed one")
    ap.add_argument("--ramp_duration", type=float, default=8.0)
    ap.add_argument("--bound_ms", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", default=None,
                    help="the server's vocab: also time the requests' "
                         "featurization on this host")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    import numpy as np

    ramp = [float(r) for r in args.ramp.split(",") if r.strip()]
    if args.url:
        res = load_run(np, args.url, args.rate, args.duration, ramp,
                       args.ramp_duration, args.bound_ms, args.seed,
                       args.vocab)
        print(json.dumps(res), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
    if not args.checkouts:
        ap.error("pass --url or --checkouts")
    import torch

    if not torch.cuda.is_available():
        print("serve_load: --checkouts needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    tmp = tempfile.mkdtemp(prefix="serve_load_")
    cfg = os.path.join(REPO, "configs", "bert_large_uncased_config.json")
    ckpts = write_checkpoints(tmp, cfg)
    vocab = chip_smoke.serve_vocab(os.path.join(tmp, "vocab.txt"))
    server_argv = ["--model_config_file", cfg, "--vocab_file", vocab,
                   "--labels", *chip_smoke.CONLL_TAGS]
    for task, path in sorted(ckpts.items()):
        server_argv += ["--task_checkpoint", f"{task}={path}"]
    runs = []
    for i, checkout in enumerate(args.checkouts.split(",")):
        port_file = os.path.join(tmp, f"port{i}")
        t0 = time.perf_counter()
        proc, url = serve_checkout(checkout, server_argv, port_file,
                                   os.path.join(tmp, f"server{i}.log"))
        start_s = time.perf_counter() - t0
        try:
            res = load_run(np, url, args.rate, args.duration, ramp,
                           args.ramp_duration, args.bound_ms, args.seed,
                           vocab)
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
        res.update(checkout=checkout, run=i, start_s=start_s)
        runs.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
