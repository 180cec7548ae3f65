"""Deterministic step replay from a flight-recorder bundle (counterpart of
the JAX package's tools/replay.py).

A pretraining run that hits a non-finite step (or dies, or trips the
watchdog) dumps a repro bundle (telemetry/flight_recorder.py): the last
steps' loader batches and int32 dropout seeds, the metric tail, and a
manifest of what the step was built from. This tool closes the loop:

    python -m bert_pytorch_tpu_torch.tools.replay --bundle <dir>
    python -m bert_pytorch_tpu_torch.tools.replay --bundle <dir> --bisect
    python -m bert_pytorch_tpu_torch.tools.replay --bundle <dir> --validate

Replay restores the newest checkpoint whose gap to the offending step the
bundle's records cover, re-runs those steps through the run's own step
builder (training/pretrain.build_pretrain_step, or build_kfac_pretrain_step
from the run block's `kfac` dict, with the run's optimizer, schedule,
accumulation, prediction budget, health action and fault injection) on
the recorded batches and seeds, and holds the recorded
DETERMINISTIC_KEYS to the replayed ones bit for bit: on the same kind of
device the step is the same computation. A --steps_per_loop run's chunk
replays step by step (the same computation, training/pretrain.
chain_steps), its last step's health flags folded over the chunk as the
run read them; `--step` may name a step inside a chunk, and a chunk the
ring evicted in part is refused. Across devices (a card's bundle
replayed on the CPU) expect agreement to float tolerance and the same
flags.

--bisect then runs the offending step's forward microbatch by microbatch
with the model's taps and names the first tensor to go non-finite in
execution order (embeddings -> layer_i/attention -> layer_i/mlp ->
pooler -> mlm_head -> nsp_head). With every forward scope finite but the
gradients flagged, the blowup is in the backward pass and the per-group
grad_nonfinite_* counts localize it.

Exit codes: 0 reproduced (or valid), 1 mismatch, 2 bundle or schema
error. Runs on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Tuple

import numpy as np

# metric keys that are pure functions of (restored state, recorded batch,
# recorded seeds) and must reproduce bit-identically. The EMA-carried
# signals are not: the health pack's carry is not checkpointed, so replay
# re-warms it from zero as a resume does.
DETERMINISTIC_KEYS = (
    "loss", "grad_norm", "param_norm", "mlm_accuracy", "learning_rate",
    "loss_nonfinite", "grad_nonfinite", "skipped_nonfinite", "mlm_dropped",
)


class ReplayError(RuntimeError):
    """Bundle unusable: schema, coverage, or checkpoint problems."""


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bundle", required=True, type=str,
                   help="repro bundle directory (manifest.json + "
                        "batches.npz)")
    p.add_argument("--step", type=int, default=None,
                   help="step to reproduce (default: the manifest's "
                        "trigger_step)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory (default: the manifest's; "
                        "pass it when the bundle moved machines)")
    p.add_argument("--bisect", action="store_true",
                   help="after reproducing, name the first non-finite "
                        "tensor of the step's forward")
    p.add_argument("--validate", action="store_true",
                   help="schema-check the manifest and the arrays, and "
                        "exit (no model, no checkpoint)")
    p.add_argument("--stacked_params", type=str, default="auto",
                   choices=["auto", "false"],
                   help="the encoder layout; the port's is the unstacked "
                        "one ('false'), which 'auto' takes")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _load_manifest(bundle: str) -> dict:
    with open(os.path.join(bundle, "manifest.json"), encoding="utf-8") as f:
        return json.load(f)


def _batch_for(npz, rec) -> Dict[str, np.ndarray]:
    return {k: npz[f"s{rec['step']:08d}__{k}"] for k in rec["fields"]}


def _seeds_for(npz, rec) -> np.ndarray:
    return npz[f"s{rec['step']:08d}__rng"]


def _values_equal(a: float, b: float) -> bool:
    if math.isnan(a) and math.isnan(b):
        return True     # both NaN: the non-finiteness reproduced
    return a == b


def ordered_taps(taps: dict) -> List[Tuple[str, object]]:
    """The model's taps (BertForPreTraining(return_taps=True)) as [(scope,
    tensor)] in forward execution order, the JAX bisect's scope names."""
    out = [("embeddings", taps["embeddings"])]
    for i, layer in enumerate(taps["layers"]):
        out.append((f"layer_{i}/attention", layer["attention_out"]))
        out.append((f"layer_{i}/mlp", layer["mlp_out"]))
    for name in ("pooler", "mlm_head", "nsp_head"):
        if taps.get(name) is not None:
            out.append((name, taps[name]))
    return out


def describe_stream(stream) -> None:
    """A streaming run's bundle (--stream_dir): the recorded batches are
    in the bundle, so the replay needs no corpus; name the records the
    window covers (global_seq numbers across the sorted sources) and the
    cursor, for re-pointing the plane at the same place."""
    if not isinstance(stream, dict):
        return
    windows = [w for w in stream.get("recent_batches") or []
               if isinstance(w, dict)]
    span = ""
    if windows:
        lo = min(w["record_lo"] for w in windows)
        hi = max(w["record_hi"] for w in windows)
        span = (f"; recorded batches cover global records {lo}..{hi} "
                "(global_seq numbering across all sources)")
    cursor = stream.get("cursor") or {}
    print(f"streaming-mode bundle: {len(stream.get('sources') or [])} "
          f"sources (hash {stream.get('sources_hash')}), cursor at epoch "
          f"{cursor.get('epoch')} source {cursor.get('source')} record "
          f"{cursor.get('record')} (global_seq {cursor.get('global_seq')})"
          f"{span}", file=sys.stderr)


def main(argv=None) -> dict:
    args = parse_arguments(argv)
    from bert_pytorch_tpu_torch.telemetry.flight_recorder import \
        validate_bundle

    bundle = args.bundle
    errors = validate_bundle(bundle)
    if args.validate:
        for e in errors:
            print(f"INVALID: {e}")
        if not errors:
            print(f"bundle {bundle}: manifest schema v-ok, arrays "
                  "cross-checked")
        return {"valid": not errors, "errors": errors}
    if errors:
        raise ReplayError("bundle failed schema validation: "
                          + "; ".join(errors))
    manifest = _load_manifest(bundle)
    run = manifest["run"]
    if run.get("zero1"):
        raise ReplayError("the bundle's run used ZeRO-1, which the port "
                          "does not run")
    ranks = 1
    for n in (run.get("mesh") or {}).values():
        ranks *= int(n)
    if ranks > 1:
        raise ReplayError(f"the bundle's run had {ranks} ranks (mesh "
                          f"{run['mesh']}): a rank's batch and state are "
                          "part of the step, which replay on one card "
                          "does not run")
    describe_stream(manifest.get("stream"))

    import torch

    from bert_pytorch_tpu_torch import resolve_device
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.telemetry.health import (
        HealthConfig, init_telemetry_state)
    from bert_pytorch_tpu_torch.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu_torch.telemetry.health import is_sticky_metric
    from bert_pytorch_tpu_torch.training.pretrain import (
        _sticky_max, build_kfac_pretrain_step, build_pretrain_step,
        compute_params, debug_forward, inject_nonfinite, init_kfac_state)
    from bert_pytorch_tpu_torch.training.state import make_train_state

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # as the run
    npz = np.load(os.path.join(bundle, "batches.npz"))
    records = {r["step"]: r for r in manifest["records"]}
    target = args.step if args.step is not None else manifest["trigger_step"]
    if target not in records:
        raise ReplayError(f"step {target} not in the bundle (recorded "
                          f"steps: {sorted(records)})")
    recorded = next((m for m in manifest["metrics_tail"]
                     if m.get("step") == target), None)
    ckpt_dir = args.checkpoint or manifest["checkpoint"]["dir"]
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        raise ReplayError(f"checkpoint dir {ckpt_dir!r} not found — pass "
                          "--checkpoint")
    manager = CheckpointManager(ckpt_dir)
    steps_avail = manager.all_steps()
    base = next((c for c in sorted(steps_avail, reverse=True)
                 if c < target
                 and all(s in records for s in range(c + 1, target + 1))),
                None)
    if base is None:
        raise ReplayError(
            f"no checkpoint covers step {target}: checkpoints "
            f"{steps_avail}, recorded steps {sorted(records)} — the "
            "recorder window did not reach back to a checkpoint (raise "
            "--recorder_window or checkpoint more often)")
    # --steps_per_loop: the replay starts at a dispatch's head, and the
    # target's chunk is whole in the ring
    if records[base + 1]["pos"] != 0:
        raise ReplayError(
            f"replay would start mid-dispatch at step {base + 1} "
            "(--steps_per_loop chunk partially evicted from the ring)")
    head = target - records[target]["pos"]
    if any(i not in records for i in range(head, target + 1)):
        raise ReplayError(
            f"steps {head}..{head + records[target]['n_steps'] - 1} form "
            "one --steps_per_loop dispatch; the ring evicted part of it")

    config = BertConfig.from_dict(manifest["model_config"])
    kcfg = run.get("kfac")
    config = config.replace(kfac_taps=bool(kcfg))
    compute_dtype = (torch.bfloat16 if run.get("dtype", "bfloat16")
                     == "bfloat16" else torch.float32)
    grad_dtype = (torch.bfloat16 if run["grad_dtype"] == "bfloat16"
                  else None)
    accum = int(run["accum_steps"])
    inject_step = run.get("inject_nonfinite_step")
    health = (HealthConfig(action=run["nonfinite_action"])
              if run["health_pack"] == "on" else None)
    with torch.device(device):
        model = BertForPreTraining(config, dtype=compute_dtype)
    schedule = make_schedule(run["lr_decay"], run["learning_rate"],
                             run["max_steps"],
                             warmup=run["warmup_proportion"],
                             offset=run["previous_phase_end_step"])
    tx = Lamb(schedule, weight_decay=0.01,
              fused=run.get("fused_optim", "off"))
    state = make_train_state(model, tx)
    if kcfg:
        from bert_pytorch_tpu_torch.optim.kfac import KFAC, KFACConfig

        kfac = KFAC(KFACConfig(
            inv_interval=kcfg["inv_interval"],
            factor_interval=kcfg["factor_interval"],
            stat_decay=kcfg["stat_decay"], damping=kcfg["damping"],
            kl_clip=kcfg["kl_clip"], skip_layers=tuple(kcfg["skip_layers"]),
            stats_dtype=(torch.bfloat16 if kcfg.get("stats_dtype") == "bf16"
                         else torch.float32),
            factor_sync_freq=kcfg.get("factor_sync_freq", 1)))
        init_kfac_state(model, kfac, state)
        step_fn = build_kfac_pretrain_step(
            model, tx, kfac, schedule=schedule, accum_steps=accum,
            max_predictions=run["max_pred_row"], grad_dtype=grad_dtype,
            health=health, nan_inject_step=inject_step)
    else:
        step_fn = build_pretrain_step(
            model, tx, schedule=schedule, accum_steps=accum,
            max_predictions=run["max_pred_row"], grad_dtype=grad_dtype,
            health=health, nan_inject_step=inject_step)
    if device.type == "cuda":
        from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

        load_kernels()

    def to_device(rec):
        return {k: torch.from_numpy(np.ascontiguousarray(v).reshape(
            accum, -1, *v.shape[1:])).to(device)
            for k, v in _batch_for(npz, rec).items()}

    sd, _extra, _ = manager.restore(step=base, map_location=device)
    state.load_state_dict(sd)
    del sd
    if health is not None:
        state.telemetry = init_telemetry_state(device)

    def seeds_of(step):
        return torch.from_numpy(np.asarray(_seeds_for(npz, records[step]),
                                           np.int32))

    # a --steps_per_loop chunk is its steps one by one (training/pretrain.
    # chain_steps: the same computation) with the health flags
    # max-accumulated from its head: what the run read at its last step
    chunk = None
    for s in range(base + 1, target):
        m = step_fn(state, to_device(records[s]), seeds_of(s))
        chunk = (m if records[s]["pos"] == 0 else
                 {k: _sticky_max(v, chunk[k]) if is_sticky_metric(k)
                  and k in chunk else v for k, v in m.items()})
    # the parameters entering the target step, for the bisect (the step
    # updates them in place)
    entering = ({k: v.detach().clone() for k, v in state.params.items()}
                if args.bisect else None)
    metrics = step_fn(state, to_device(records[target]), seeds_of(target))
    if records[target]["pos"] > 0:
        metrics = {k: _sticky_max(v, chunk[k]) if is_sticky_metric(k)
                   and k in chunk else v for k, v in metrics.items()}
    replayed = {k: (v.item() if torch.is_tensor(v) else float(v))
                for k, v in metrics.items()}
    result = {"step": target, "base_checkpoint": base,
              "replayed": replayed, "recorded": recorded, "match": None,
              "mismatches": []}
    if recorded is None:
        print(f"step {target}: no recorded metrics in the bundle tail (a "
              "crash before the readback) — replayed values reported, "
              "nothing to compare against", file=sys.stderr)
    else:
        keys = [k for k in DETERMINISTIC_KEYS if k in recorded] + \
            [k for k in sorted(recorded) if k.startswith("grad_nonfinite_")]
        for k in keys:
            if k not in replayed:
                result["mismatches"].append(
                    {"key": k, "recorded": recorded[k], "replayed": None})
            elif not _values_equal(float(recorded[k]), float(replayed[k])):
                result["mismatches"].append(
                    {"key": k, "recorded": float(recorded[k]),
                     "replayed": float(replayed[k])})
        result["match"] = not result["mismatches"]
        verdict = ("REPRODUCED bit-identically" if result["match"]
                   else "MISMATCH")
        print(f"step {target} (from checkpoint {base}): {verdict} "
              f"(loss={replayed.get('loss')}, loss_nonfinite="
              f"{replayed.get('loss_nonfinite')}, grad_nonfinite="
              f"{replayed.get('grad_nonfinite')})")
        for m in result["mismatches"]:
            print(f"  {m['key']}: recorded {m['recorded']} != replayed "
                  f"{m['replayed']}")

    if args.bisect:
        gparams = compute_params(entering, grad_dtype)
        del entering
        if inject_step == target:
            gparams = inject_nonfinite(gparams)
        batch = to_device(records[target])
        seeds = seeds_of(target)
        first_bad, scopes = None, []
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            loss_i, taps = debug_forward(model, gparams, micro, seeds[i],
                                         run["max_pred_row"])
            for name, t in ordered_taps(taps):
                finite = bool(torch.isfinite(t).all())
                if i == 0:
                    scopes.append({"scope": name, "finite": finite})
                if not finite and first_bad is None:
                    first_bad = {"scope": name, "microbatch": i}
            if first_bad is None and not math.isfinite(float(loss_i)):
                first_bad = {"scope": "loss", "microbatch": i}
            if first_bad is not None:
                break
        if first_bad is None and replayed.get("grad_nonfinite", 0) > 0:
            first_bad = {"scope": "backward", "microbatch": None,
                         "grad_groups": {
                             k: v for k, v in replayed.items()
                             if k.startswith("grad_nonfinite_") and v > 0}}
        result["bisect"] = {"first_nonfinite": first_bad, "scopes": scopes}
        if first_bad is None:
            print("bisect: every forward scope finite, no non-finite "
                  "gradients — nothing to blame at this step")
        else:
            mb = first_bad.get("microbatch")
            print(f"bisect: first non-finite tensor in scope "
                  f"'{first_bad['scope']}'"
                  + (f" (microbatch {mb})" if mb is not None else "")
                  + (f" — grad groups {first_bad['grad_groups']}"
                     if "grad_groups" in first_bad else ""))
    return result


def _cli(argv=None) -> int:
    try:
        result = main(argv)
    except ReplayError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    if result.get("valid") is False:
        return 2
    if result.get("match") is False:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
