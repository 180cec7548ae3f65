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
  the final one-card state_dict (params, mu, nu) to rank0_<arm>.npz; an
  arm's "mesh" (a --mesh string) places the ranks on that mesh: each
  builds its model part (convert.shard_state_dict), reads its data
  shard's rows and folds its dropout seeds by its coordinates, and
  "fsdp_overlap" and "remat" (a remat policy) switch those on;
- "main": run_pretraining.main(argv) for each argv of `runs` on this
  rank, recording the sample indices its sampler hands out; writes each
  run's history, saves, indices and the sha256 of its final one-card
  params (`state_dict()`, collective);
- "vocab": the MLM loss terms, their gradient and the accuracy of the
  logits and labels in `inputs` (an .npz) with the vocabulary split over
  a model axis of the world's ranks; writes the rank's gradient of its
  part to grad<RANK>.npy;
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

    from bert_pytorch_tpu_torch.models.convert import shard_state_dict
    from bert_pytorch_tpu_torch.parallel import dist, mesh as mesh_lib
    from bert_pytorch_tpu_torch.parallel.tensor import ModelShard

    dist.reset_stats()
    world = job["world"]
    config = BertConfig.from_dict(job["config"])
    if arms.get("remat"):
        config = config.replace(checkpoint_activations=True,
                                remat_policy=arms["remat"])
    params = np.load(job["params"])
    whole = {k: torch.from_numpy(params[k]) for k in params}
    axes = shard = None
    shards, shard_index = world, rank
    if arms.get("mesh"):
        mesh = mesh_lib.make_mesh(mesh_lib.parse_mesh_arg(arms["mesh"]),
                                  world)
        axes = dist.make_axes(mesh)
        if mesh.model > 1:
            shard = ModelShard(axes.coords["model"], mesh.model, axes.model)
        whole = shard_state_dict(whole, mesh, rank)
        shards, shard_index = (mesh_lib.data_shard_count(mesh),
                               mesh.data_shard_index(rank))
        flat = mesh.flat_shard_index(rank)
    else:
        flat = rank
    model = BertForPreTraining(config, dtype=torch.float32,
                               model_shard=shard)
    model.load_state_dict(whole, strict=True)
    set_dropout_shard(model, shard_index, flat)
    dp = DataParallel(model, zero1=arms.get("zero1", False),
                      reduce_scatter=arms.get("zero1_rs", False),
                      gather_on_use=arms.get("zero1_overlap", False),
                      coalesce=arms.get("coalesce", False), axes=axes,
                      fsdp_overlap=arms.get("fsdp_overlap", False))
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
            a = batches[f"{i}/{f}"]           # (accum, shards * rows, ...)
            rows = a.shape[1] // shards
            batch[f] = torch.from_numpy(
                np.ascontiguousarray(a[:, shard_index * rows:(shard_index + 1)
                                      * rows]))
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
    out["collectives"] = {a: dict(v) for a, v in dist.axis_stats().items()}
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
    import hashlib

    out = []
    for argv in job["runs"]:
        del seen[:]
        lines = []
        result = run_pretraining.main(argv, log=lines.append)
        sd = result.state.state_dict()
        digest = hashlib.sha256()
        for k in sorted(sd["params"]):
            digest.update(sd["params"][k].detach().contiguous().numpy()
                          .tobytes())
        out.append({
            "params_sha256": digest.hexdigest(),
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


def _vocab(job, rank):
    from bert_pytorch_tpu_torch.models import losses
    from bert_pytorch_tpu_torch.parallel import dist, mesh as mesh_lib
    from bert_pytorch_tpu_torch.parallel.tensor import ModelShard

    mesh = mesh_lib.make_mesh({"model": job["world"]}, job["world"])
    axes = dist.make_axes(mesh)
    shard = ModelShard(axes.coords["model"], mesh.model, axes.model)
    data = np.load(job["inputs"])
    logits = torch.from_numpy(data["logits"])
    labels = torch.from_numpy(data["labels"])
    width = logits.shape[-1] // mesh.model
    local = logits[..., shard.index * width:(shard.index + 1) * width]
    local = local.clone().requires_grad_()
    total, count = losses.vocab_parallel_terms(local, labels, shard)
    total.backward()
    correct, masked = losses.mlm_accuracy(local.detach(), labels, shard)
    np.save(os.path.join(job["out"], f"grad{rank}.npy"), local.grad.numpy())
    return {"total": float(total), "count": int(count),
            "correct": int(correct), "masked": int(masked)}


JOBS = {"steps": _steps, "main": _main, "sigterm": _sigterm,
        "vocab": _vocab}


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
