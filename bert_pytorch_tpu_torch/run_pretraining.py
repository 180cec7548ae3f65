"""Pretraining entry point of the port: BERT pretraining on one card,
phase 1 (seq 128) or phase 2 (seq 512, attention through the flash
kernels), the sequence length taken from the shards.

    python -m bert_pytorch_tpu_torch.run_pretraining \\
        --config_file configs/bert_pretraining_phase{1,2}_config.json \\
        --input_dir <dir of .hdf5 shards> --output_dir <dir> \\
        [--fused_optim auto] [--device cuda|cpu] [--steps N]

Flags, defaults and precedence (CLI > JSON run config > defaults) are the
JAX entry point's (run_pretraining.py), trimmed to what the port
implements: a model initialised at random from --seed, dynamic masking of
sharded-HDF5 data, the gathered MLM head, gradient accumulation up to
--global_batch_size, bf16 compute with bf16 gradients over f32 masters,
LAMB with a warmup schedule (--fused_optim: "off" and "xla" tensor by
tensor, "auto"/"pallas" the fused multi-tensor kernels on the card), and
the non-finite health checks.

Checkpoints: every --num_steps_per_checkpoint steps and at the end of the
run into <output_dir>/pretrain_ckpts/<global step>/, the newest
--keep_checkpoints kept (--skip_checkpoint turns saving off). A run
auto-resumes from the newest checkpoint in its output_dir, which takes
precedence over --init_checkpoint <dir>[@step] (weights only, from a port
checkpoint directory). So phase 2 run in phase 1's output_dir continues
from phase 1's last step with its LAMB moments, and its schedule takes
the run config's previous_phase_end_step as its offset. Each step's
dropout seeds are a pure function of (--seed, global step), so a resumed
run draws the masks an uninterrupted run draws.

Each optimizer step logs one line (loss, grad_norm, lr, step ms, seq/s)
to stdout and one JSON record to <output_dir>/<log_prefix>.jsonl. Runs on
CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from bert_pytorch_tpu_torch import PRETRAIN_GAPS as _ROADMAP
from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

# The JAX entry point's flags (run_pretraining.py, parse_arguments) that
# this parser does not declare. A run config may still set them (the merge
# attaches every JSON key), so each one is refused unless its value leaves
# its feature off: key -> the values that do. (The CLI refuses undeclared
# flags itself.)
_REFUSED = {
    "steps_per_loop": (1,),
    "checkpoint_activations": (False,),
    "kfac": (False,),
    "mesh": ("",),
    "profile_steps": (None,),
    # the port's per-layer modules are the JAX "false" layout
    "stacked_params": ("auto", "false"),
    # one card: "auto" shards nothing
    "zero1": ("auto", "false"),
    "zero1_overlap": (False,),
    "zero1_rs": (False,),
    "fsdp_overlap": (False,),
    "mesh_config": ("auto",),
    "coalesce_reductions": ("off",),
    # batches move to the card in the step; no device-side prefetcher
    "h2d_prefetch": (0,),
    # the libtpu flag pack
    "overlap_flags": ("off",),
    # the port's dropout seeds come from numpy (dropout_seeds)
    "rng_impl": ("threefry2x32",),
    "packing": (False,),
    "flight_recorder": ("off",),
    "metrics_port": (None,),
    "inject_nonfinite_step": (None,),
    "stream_dir": (None,),
    "tensorboard": ("off",),
    # --device cpu is the port's
    "force_cpu": (False,),
    "watchdog_timeout": (0, 0.0),
    "chaos": (None,),
    "slo_config": (None,),
    "stream_inject": (None,),
}
# Flags that only tune a feature refused above (or, for log_freq, the
# metrics plane's StepWatch, which metrics_port stands for): accepted with
# any value, since their feature is off.
_TUNING = {
    "kfac_inv_interval": "kfac", "kfac_factor_interval": "kfac",
    "kfac_stat_decay": "kfac", "kfac_damping": "kfac",
    "kfac_kl_clip": "kfac", "kfac_stats_dtype": "kfac",
    "kfac_skip_layers": "kfac", "kfac_bucket_mb": "kfac",
    "kfac_factor_sync_freq": "kfac",
    "packing_max_segments": "packing", "packing_lookahead": "packing",
    "recorder_window": "flight_recorder",
    "log_freq": "metrics_port",
    "stream_vocab": "stream_dir", "stream_tokenizer": "stream_dir",
    "stream_seq_len": "stream_dir", "stream_workers": "stream_dir",
    "stream_queue_batches": "stream_dir",
    "watchdog_action": "watchdog_timeout",
    "chaos_step": "chaos", "chaos_stall_secs": "chaos",
    "slo_eval_interval_s": "slo_config", "slo_action": "slo_config",
    "slo_halt_after_s": "slo_config",
}


def parse_arguments(argv=None) -> argparse.Namespace:
    from bert_pytorch_tpu_torch.config import merge_args_with_config

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_file", default=None, type=str,
                   help="JSON run config overriding defaults")
    p.add_argument("--input_dir", default=None, type=str,
                   help="dir containing .hdf5 shards")
    p.add_argument("--output_dir", default=None, type=str,
                   help="dir for logs and checkpoints")
    p.add_argument("--model_config_file", default=None, type=str,
                   help="BERT model config JSON")
    p.add_argument("--masked_token_fraction", type=float, default=0.2)
    p.add_argument("--max_predictions_per_seq", type=int, default=80)
    p.add_argument("--init_checkpoint", type=str, default="",
                   help="<checkpoint dir>[@step]: seed the weights (only) "
                        "from a port checkpoint; an auto-resume from "
                        "output_dir takes precedence")
    p.add_argument("--num_steps_per_checkpoint", type=int, default=200)
    p.add_argument("--keep_checkpoints", type=int, default=3,
                   help="rolling window of checkpoints kept")
    p.add_argument("--skip_checkpoint", action="store_true",
                   help="save no checkpoint")
    p.add_argument("--log_prefix", type=str, default="logfile")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--learning_rate", default=5e-5, type=float)
    p.add_argument("--lr_decay", default="poly", type=str,
                   choices=["poly", "linear", "cosine", "constant"])
    p.add_argument("--warmup_proportion", default=0.01, type=float)
    p.add_argument("--global_batch_size", default=2 ** 16, type=int)
    p.add_argument("--local_batch_size", default=8, type=int,
                   help="microbatch size")
    p.add_argument("--max_steps", default=1000, type=int)
    p.add_argument("--steps", default=None, type=int,
                   help="steps to perform this session (default: to "
                        "max_steps)")
    p.add_argument("--previous_phase_end_step", default=0, type=int)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--grad_dtype", type=str, default="auto",
                   choices=["auto", "bfloat16", "float32"],
                   help="gradient dtype; auto follows --dtype (bf16 "
                        "gradients against f32 masters)")
    p.add_argument("--mask_token_index", type=int, default=None,
                   help="[MASK] id; default: looked up in vocab_file, "
                        "else 103")
    p.add_argument("--vocab_pad_multiple", type=int, default=128,
                   help="pad the vocab to a multiple of this")
    p.add_argument("--optimizer", type=str, default="lamb",
                   choices=["lamb"])
    p.add_argument("--fused_optim", type=str, default="off",
                   choices=["off", "auto", "xla", "pallas"],
                   help="LAMB's route: 'off' and 'xla' tensor by tensor; "
                        "'auto' and 'pallas' the fused multi-tensor kernels "
                        "on CUDA tensors. On the CPU every choice runs the "
                        "plain versions")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="host batches assembled ahead on a thread")
    p.add_argument("--health_pack", type=str, default="on",
                   choices=["on", "off"],
                   help="non-finite counts of the loss and the gradients")
    p.add_argument("--nonfinite_action", type=str, default="log",
                   choices=["log", "skip", "halt"],
                   help="on a non-finite step: 'log' warns and trains on, "
                        "'skip' drops the update, 'halt' stops the run")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = merge_args_with_config(p, argv)
    # a run config's value of a declared flag bypasses argparse's choices
    # (--optimizer bert_adam is a JAX choice the port lacks)
    for action in p._actions:  # noqa: SLF001
        value = getattr(args, action.dest, None)
        if action.choices is not None and value not in action.choices:
            raise NotImplementedError(
                f"{action.dest}={value!r} is not ported yet (choices "
                f"{list(action.choices)}; see {_ROADMAP})")
    return args


def find_mask_token_index(args, config) -> int:
    """--mask_token_index, else [MASK] (or <mask>) of the config's
    vocab_file when that file exists, else 103, the standard BERT id."""
    if args.mask_token_index is not None:
        return args.mask_token_index
    vocab_file = getattr(config, "vocab_file", None)
    if vocab_file and os.path.exists(vocab_file):
        from bert_pytorch_tpu_torch.data.tokenization import load_vocab

        vocab = load_vocab(vocab_file)
        if "[MASK]" in vocab:
            return vocab["[MASK]"]
        if "<mask>" in vocab:
            return vocab["<mask>"]
    return 103


class NonFiniteHalt(RuntimeError):
    """--nonfinite_action=halt tripped on a non-finite loss or gradient."""


@dataclasses.dataclass
class PretrainResult:
    """What a run did: its last global step, the train state it ends with,
    the step it resumed from (None: a fresh start) and the checkpoints it
    saved ({"step", "bytes", "seconds"} each)."""
    step: int
    train_time_s: float
    accum_steps: int
    seqs_per_step: int
    history: List[Dict]
    state: object = None
    resumed_from: Optional[int] = None
    restore_s: Optional[float] = None
    saves: List[Dict] = dataclasses.field(default_factory=list)


def _unsupported(args) -> None:
    """Refuse a key of `_REFUSED` whose value switches its feature on."""
    from bert_pytorch_tpu_torch import refuse

    refuse(args, _REFUSED, _ROADMAP)


def _config_echo(args) -> Dict:
    return {k: v for k, v in sorted(vars(args).items())
            if isinstance(v, (str, int, float, bool)) or v is None}


def main(argv=None, log: Callable[[str], None] = print) -> PretrainResult:
    args = parse_arguments(argv)
    if not args.input_dir or not args.output_dir:
        raise SystemExit("--input_dir and --output_dir are required")
    from bert_pytorch_tpu_torch.data.sharded import ShardIndex

    files = sorted(str(p) for p in Path(args.input_dir).rglob("*.hdf5"))
    if not files:
        raise SystemExit(f"no .hdf5 shards under {args.input_dir}")
    return train(args, ShardIndex(files), log)


def train(args: argparse.Namespace, index,
          log: Callable[[str], None] = print) -> PretrainResult:
    """The run behind `main`, over an already opened shard index (a
    `data.sharded.ShardIndex`, or an object with its interface that holds
    the same arrays in memory)."""
    if not args.output_dir:
        raise SystemExit("--output_dir is required")
    if not args.model_config_file:
        raise SystemExit("--model_config_file (or run config) required")
    _unsupported(args)

    from bert_pytorch_tpu_torch import resolve_device
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.telemetry.health import HealthConfig
    from bert_pytorch_tpu_torch.training.checkpoint import (
        CheckpointManager, load_init_params)
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    device = resolve_device(args.device)
    # the tied decoder's f32 logits need full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    health = (HealthConfig(action=args.nonfinite_action)
              if args.health_pack == "on" else None)
    if health is None and args.nonfinite_action != "log":
        raise SystemExit(f"--nonfinite_action={args.nonfinite_action} "
                         "requires --health_pack=on")

    # one card: the global batch is accum_steps microbatches
    micro = args.local_batch_size
    accum_steps = max(1, math.ceil(args.global_batch_size / micro))
    step_batch = accum_steps * micro

    config = BertConfig.from_json_file(args.model_config_file)
    config = config.replace(vocab_size=pad_vocab_size(
        config.vocab_size, args.vocab_pad_multiple))
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    grad_name = args.dtype if args.grad_dtype == "auto" else args.grad_dtype
    grad_dtype = torch.bfloat16 if grad_name == "bfloat16" else None

    mask_id = find_mask_token_index(args, config)
    loader = PretrainingDataLoader(
        index, HostShardSampler(len(index), seed=args.seed),
        batch_size=step_batch, mask_token_index=mask_id,
        max_pred_per_seq=args.max_predictions_per_seq,
        masked_lm_prob=args.masked_token_fraction,
        vocab_size=config.vocab_size, seed=args.seed,
        prefetch_batches=max(0, args.prefetch_batches))
    os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, args.log_prefix + ".jsonl")
    if not args.skip_checkpoint and args.num_steps_per_checkpoint < 1:
        raise SystemExit("--num_steps_per_checkpoint must be >= 1")
    manager = CheckpointManager(
        os.path.join(args.output_dir, "pretrain_ckpts"),
        max_to_keep=args.keep_checkpoints, log=log)
    try:
        if len(loader.sampler) < step_batch:
            raise SystemExit(f"the data holds fewer than one step's batch "
                             f"({step_batch} samples)")
        with torch.device(device):
            model = BertForPreTraining(config, dtype=compute_dtype)
        init_weights(model, torch.Generator(device=device).manual_seed(
            args.seed), std=config.initializer_range)
        schedule = make_schedule(args.lr_decay, args.learning_rate,
                                 args.max_steps,
                                 warmup=args.warmup_proportion,
                                 offset=args.previous_phase_end_step)
        tx = Lamb(schedule, weight_decay=0.01, fused=args.fused_optim)
        state = make_train_state(model, tx)
        step_fn = build_pretrain_step(
            model, tx, schedule=schedule, accum_steps=accum_steps,
            max_predictions=args.max_predictions_per_seq,
            grad_dtype=grad_dtype, health=health)
        log(f"device={device} accumulation_steps={accum_steps} "
            f"microbatch={micro} global_batch={step_batch} dtype={args.dtype} "
            f"grad_dtype={grad_name} vocab={config.vocab_size} "
            f"layers={config.num_hidden_layers} shards={len(index.files)} "
            f"samples={len(index)} [MASK]={mask_id} "
            f"fused_optim={args.fused_optim}")
        resumed_from = restore_s = None
        if manager.latest_step() is not None:
            t0 = time.perf_counter()
            sd, extra, resumed_from = manager.restore_with_fallback(
                map_location=device)
            state.load_state_dict(sd)
            del sd
            if "sampler" in extra:
                loader.load_state_dict(extra["sampler"])
            restore_s = time.perf_counter() - t0
            log(f"auto-resumed from step {resumed_from} "
                f"({restore_s:.1f} s)")
        elif args.init_checkpoint:
            load_init_params(args.init_checkpoint, state.params, log=log)
        n_sites = 1 + 3 * config.num_hidden_layers
        target = args.previous_phase_end_step + args.max_steps
        limit = min(target, state.step + args.steps
                    if args.steps is not None else target)
        history: List[Dict] = []
        saves: List[Dict] = []

        def save():
            rec = manager.save(state.step, state.state_dict(), extra={
                "sampler": loader.state_dict(),
                "epoch": loader.sampler.epoch,
                "config": _config_echo(args)})
            saves.append(dict(rec, step=state.step))
            log(f"checkpoint: step {state.step} saved ({rec['bytes'] / 1e9:.3f}"
                f" GB in {rec['seconds']:.1f} s)")

        train_start = time.perf_counter()
        with open(log_path, "a", encoding="utf-8") as log_file:
            # the loop pulls a batch only for a step it takes, so the
            # loader's cursor is the last batch trained on
            while state.step < limit:
                batch_np = next(loader, None)
                if batch_np is None:
                    loader.reset_epoch()
                    continue
                history.append(_one_step(
                    step_fn, state, batch_np, accum_steps, micro, device,
                    args.seed, n_sites, health, log, log_file))
                if (not args.skip_checkpoint
                        and state.step % args.num_steps_per_checkpoint == 0):
                    save()
        train_time = time.perf_counter() - train_start
        if history and not args.skip_checkpoint and (
                not saves or saves[-1]["step"] != state.step):
            save()
        if history:
            log(f"training_seq_per_sec = "
                f"{step_batch * len(history) / train_time:.2f} "
                f"({len(history)} steps in {train_time:.1f}s)")
        return PretrainResult(step=state.step, train_time_s=train_time,
                              accum_steps=accum_steps,
                              seqs_per_step=step_batch, history=history,
                              state=state, resumed_from=resumed_from,
                              restore_s=restore_s, saves=saves)
    finally:
        loader.close()


def _one_step(step_fn, state, batch_np, accum_steps, micro, device,
              seed, n_sites, health, log, log_file) -> Dict:
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v.reshape(accum_steps, micro,
                                           *v.shape[1:])).to(device)
             for k, v in batch_np.items()}
    seeds = dropout_seeds(seed, state.step + 1, accum_steps, n_sites)
    metrics = step_fn(state, batch, seeds)
    # reading the metrics waits for the card: the step time below is the
    # whole step, host and device
    rec = {k: (v.item() if torch.is_tensor(v) else v)
           for k, v in metrics.items()}
    dt = time.perf_counter() - t0
    rec.update(step=state.step, step_ms=dt * 1e3,
               seq_per_sec=accum_steps * micro / dt)
    log(f"step {state.step}: loss {rec['loss']:.4f} grad_norm "
        f"{rec['grad_norm']:.4f} lr {rec['learning_rate']:.4e} step_ms "
        f"{rec['step_ms']:.1f} seq/s {rec['seq_per_sec']:.1f} mlm_accuracy "
        f"{rec['mlm_accuracy']:.4f}")
    log_file.write(json.dumps(rec) + "\n")
    log_file.flush()
    if health is not None and (rec["loss_nonfinite"]
                               or rec["grad_nonfinite"]):
        log(f"WARNING: non-finite step {state.step}: "
            + json.dumps({k: v for k, v in rec.items()
                          if "nonfinite" in k}))
        if health.action == "halt":
            raise NonFiniteHalt(f"non-finite loss or gradients at step "
                                f"{state.step}")
    return rec


if __name__ == "__main__":
    main()
