"""The rank processes of the port's data-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_zero1.py).

    python tests/torch_ranks.py JOB_JSON RANK

starts one rank of a gloo group over the CPU (a FileStore at the job's
`store`, so no port is taken), runs the job and writes what it saw to
`<out>/rank<RANK>.json` (and .npz). Jobs:

- "steps": for each arm of `arms` (the DataParallel switches), the
  port's BertForPreTraining from `params` (an .npz of port-named
  tensors), `n_steps` data-parallel steps of
  training/pretrain.build_pretrain_step over this rank's rows of each
  step's batch in `batches` (an .npz: "<step>/<field>" arrays of the
  global batch, (accum, rows, ...)), each step's dropout seeds from
  `seeds`; writes the losses, grad norms and learning rates, and rank 0
  the final one-card state_dict (params, mu, nu) to rank0_<arm>.npz;
- "main": run_pretraining.main(argv) for each argv of `runs` on this
  rank, recording the sample indices its sampler hands out; writes each
  run's history, saves and indices;
- "sigterm": run_pretraining.train under its exit-code contract
  (`exit_code_of`), touching `<out>/ready<RANK>` at its first batch; the
  test signals the processes and reads their exit codes.

Nothing here imports JAX: the children are the port alone.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _init(job, rank):
    from bert_pytorch_tpu_torch.parallel import dist

    torch.set_num_threads(1)
    dist.initialize("cpu", init_method=f"file://{job['store']}", rank=rank,
                    world_size=job["world"], timeout_s=job.get("timeout",
                                                               240))
    return dist


def _steps(job, rank):
    """Every arm of job["arms"] in turn, each from the same parameters
    and batches; rank 0 writes arm i's final state to rank0_<i>.npz."""
    return [_steps_arm(job, rank, i, arms)
            for i, arms in enumerate(job["arms"])]


def _steps_arm(job, rank, index, arms):
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    set_dropout_shard)
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.parallel.zero import DataParallel
    from bert_pytorch_tpu_torch.telemetry.health import HealthConfig
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    world = job["world"]
    model = BertForPreTraining(BertConfig.from_dict(job["config"]),
                               dtype=torch.float32)
    params = np.load(job["params"])
    model.load_state_dict({k: torch.from_numpy(params[k]) for k in params},
                          strict=True)
    set_dropout_shard(model, rank)
    dp = DataParallel(model, zero1=arms.get("zero1", False),
                      reduce_scatter=arms.get("zero1_rs", False),
                      gather_on_use=arms.get("zero1_overlap", False),
                      coalesce=arms.get("coalesce", False))
    sched = make_schedule("poly", job["lr"], job["total_steps"],
                          warmup=job["warmup"])
    tx = Lamb(sched, weight_decay=0.01, fused=arms.get("fused", "off"))
    state = make_train_state(model, tx, dp=dp)
    health = HealthConfig() if job.get("health") else None
    step = build_pretrain_step(
        model, tx, schedule=sched, accum_steps=job["accum"],
        max_predictions=job.get("max_predictions"), health=health,
        grad_dtype=torch.bfloat16 if arms.get("bf16") else None, dp=dp)
    batches = np.load(job["batches"])
    seeds = np.load(job["seeds"]) if job.get("seeds") else None
    out = {"loss": [], "grad_norm": [], "learning_rate": [],
           "param_norm": []}
    for i in range(job["n_steps"]):
        fields = sorted({k.split("/", 1)[1] for k in batches
                         if k.startswith(f"{i}/")})
        batch = {}
        for f in fields:
            a = batches[f"{i}/{f}"]           # (accum, world * rows, ...)
            rows = a.shape[1] // world
            batch[f] = torch.from_numpy(
                np.ascontiguousarray(a[:, rank * rows:(rank + 1) * rows]))
        s = None if seeds is None else torch.from_numpy(seeds[i])
        m = step(state, batch, s)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["learning_rate"].append(float(m["learning_rate"]))
        if "param_norm" in m:
            out["param_norm"].append(float(m["param_norm"]))
    sd = state.state_dict()
    if rank == 0:
        arrays = {f"params/{k}": v.detach().numpy()
                  for k, v in sd["params"].items()}
        for what in ("mu", "nu"):
            arrays.update({f"{what}/{k}": v.detach().numpy()
                           for k, v in sd["opt_state"][what].items()})
        np.savez(os.path.join(job["out"], f"rank0_{index}.npz"), **arrays)
    out["pieces"] = len(dp.pieces)
    out["describe"] = dp.describe()
    dp.close()
    return out


def _main(job, rank):
    """run_pretraining.main over each argv of job["runs"] in turn."""
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.data import sharded

    seen = []
    real = sharded.HostShardSampler.next_indices

    def record(self, n):
        got = real(self, n)
        if got is not None:
            seen.extend(int(i) for i in got)
        return got

    sharded.HostShardSampler.next_indices = record
    out = []
    for argv in job["runs"]:
        del seen[:]
        lines = []
        result = run_pretraining.main(argv, log=lines.append)
        out.append({
            "step": result.step, "resumed_from": result.resumed_from,
            "history": [{k: v for k, v in h.items()
                         if isinstance(v, (int, float))}
                        for h in result.history],
            "saves": [s["step"] for s in result.saves],
            "indices": list(seen), "log": lines,
            "parallel": result.parallel,
            "accum_steps": result.accum_steps})
    return out


def _sigterm(job, rank):
    from bert_pytorch_tpu_torch import run_pretraining

    ready = os.path.join(job["out"], f"ready{rank}")

    def tap(_batch):
        if not os.path.exists(ready):
            open(ready, "w").close()

    args = run_pretraining.parse_arguments(job["argv"])
    from bert_pytorch_tpu_torch.data.sharded import ShardIndex
    from pathlib import Path

    files = sorted(str(p) for p in Path(args.input_dir).rglob("*.hdf5"))
    code = run_pretraining.exit_code_of(
        lambda: run_pretraining.train(args, ShardIndex(files),
                                      batch_tap=tap))
    return {"code": code}


JOBS = {"steps": _steps, "main": _main, "sigterm": _sigterm}


def start(job, world, out, env=None):
    """Start `world` rank processes of `job` (a dict) writing under the
    directory `out`; returns the Popen handles."""
    import subprocess

    os.makedirs(out, exist_ok=True)
    job = dict(job, world=world, out=str(out),
               store=os.path.join(str(out), "store"))
    path = os.path.join(str(out), "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              path, str(r)], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def results(procs, out, timeout=300):
    """Wait for the rank processes; every rank's JSON result (raises
    with the failed ranks' output when one exits non-zero)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise AssertionError("rank processes failed: " + "\n".join(
            f"rank {r} exit {rc}:\n{log}" for r, rc, log in bad))
    out_ = []
    for r in range(len(procs)):
        with open(os.path.join(str(out), f"rank{r}.json")) as f:
            out_.append(json.load(f))
    return out_


def run(job, world, out, timeout=300):
    """start() then results()."""
    return results(start(job, world, out), out, timeout)


def main(argv):
    with open(argv[0]) as f:
        job = json.load(f)
    rank = int(argv[1])
    dist = _init(job, rank)
    try:
        out = JOBS[job["kind"]](job, rank)
    except SystemExit as e:
        out = {"exit": e.code}
        with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        raise
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    dist.barrier()
    dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
