"""Pretraining entry point of the port: BERT pretraining on one card,
phase 1 (seq 128) or phase 2 (seq 512, attention through the flash
kernels), the sequence length taken from the shards.

    python -m bert_pytorch_tpu_torch.run_pretraining \\
        --config_file configs/bert_pretraining_phase{1,2}_config.json \\
        --input_dir <dir of .hdf5 shards> --output_dir <dir> \\
        --skip_checkpoint [--device cuda|cpu] [--steps N]

Flags, defaults and precedence (CLI > JSON run config > defaults) are the
JAX entry point's (run_pretraining.py), trimmed to what this slice
implements: a model initialised at random from --seed, dynamic masking of
sharded-HDF5 data, the gathered MLM head, gradient accumulation up to
--global_batch_size, bf16 compute with bf16 gradients over f32 masters,
unfused LAMB with a warmup schedule, and the non-finite health checks.
Checkpointing is not ported yet: the run refuses to start without
--skip_checkpoint and refuses a run config that sets init_checkpoint,
so phase 2 starts from random weights at step 0 (where the run config's previous_phase_end_step
offset holds the schedule at the start of its warmup). Each optimizer
step logs one line (loss, grad_norm, lr, step ms, seq/s) to stdout and
one JSON record to <output_dir>/<log_prefix>.jsonl. Runs on CUDA unless
--device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

# ROADMAP item named when a run asks for something this slice lacks
_ROADMAP = "ROADMAP.md, queue A: what the pretraining slice left out"


def parse_arguments(argv=None) -> argparse.Namespace:
    from bert_pytorch_tpu_torch.config import merge_args_with_config

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_file", default=None, type=str,
                   help="JSON run config overriding defaults")
    p.add_argument("--input_dir", default=None, type=str,
                   help="dir containing .hdf5 shards")
    p.add_argument("--output_dir", default=None, type=str,
                   help="dir for logs")
    p.add_argument("--model_config_file", default=None, type=str,
                   help="BERT model config JSON")
    p.add_argument("--masked_token_fraction", type=float, default=0.2)
    p.add_argument("--max_predictions_per_seq", type=int, default=80)
    p.add_argument("--skip_checkpoint", action="store_true",
                   help="required: checkpointing is not ported yet")
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
    return merge_args_with_config(p, argv)


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
    step: int
    train_time_s: float
    accum_steps: int
    seqs_per_step: int
    history: List[Dict]


def _unsupported(args) -> None:
    """Refuse what the slice does not implement rather than ignore it."""
    if not args.skip_checkpoint:
        raise NotImplementedError(
            "checkpointing is not ported yet; pass --skip_checkpoint "
            f"(see {_ROADMAP}: checkpointing)")
    for key in ("kfac", "packing", "stream_dir", "init_checkpoint"):
        if getattr(args, key, None):
            raise NotImplementedError(
                f"{key} is not ported yet (see {_ROADMAP})")


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
    try:
        with torch.device(device):
            model = BertForPreTraining(config, dtype=compute_dtype)
        init_weights(model, torch.Generator(device=device).manual_seed(
            args.seed))
        schedule = make_schedule(args.lr_decay, args.learning_rate,
                                 args.max_steps,
                                 warmup=args.warmup_proportion,
                                 offset=args.previous_phase_end_step)
        tx = Lamb(schedule, weight_decay=0.01)
        state = make_train_state(model, tx)
        step_fn = build_pretrain_step(
            model, tx, schedule=schedule, accum_steps=accum_steps,
            max_predictions=args.max_predictions_per_seq,
            grad_dtype=grad_dtype, health=health)
        log(f"device={device} accumulation_steps={accum_steps} "
            f"microbatch={micro} global_batch={step_batch} dtype={args.dtype} "
            f"grad_dtype={grad_name} vocab={config.vocab_size} "
            f"layers={config.num_hidden_layers} shards={len(index.files)} "
            f"samples={len(index)} [MASK]={mask_id}")
        # one int32 seed per dropout site per microbatch, from --seed
        seed_gen = torch.Generator().manual_seed(args.seed + 1000)
        n_sites = 1 + 3 * config.num_hidden_layers
        target = args.previous_phase_end_step + args.max_steps
        limit = min(target, state.step + args.steps
                    if args.steps is not None else target)
        history: List[Dict] = []
        train_start = time.perf_counter()
        with open(log_path, "a", encoding="utf-8") as log_file:
            while state.step < limit:
                stepped = False
                for batch_np in loader:
                    if state.step >= limit:
                        break
                    stepped = True
                    history.append(_one_step(
                        step_fn, state, batch_np, accum_steps, micro,
                        device, seed_gen, n_sites, health, log, log_file))
                else:
                    if not stepped:
                        raise SystemExit(
                            f"the data holds fewer than one step's batch "
                            f"({step_batch} samples)")
                    loader.reset_epoch()
        train_time = time.perf_counter() - train_start
        if history:
            log(f"training_seq_per_sec = "
                f"{step_batch * len(history) / train_time:.2f} "
                f"({len(history)} steps in {train_time:.1f}s)")
        return PretrainResult(step=state.step, train_time_s=train_time,
                              accum_steps=accum_steps,
                              seqs_per_step=step_batch, history=history)
    finally:
        loader.close()


def _one_step(step_fn, state, batch_np, accum_steps, micro, device,
              seed_gen, n_sites, health, log, log_file) -> Dict:
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v.reshape(accum_steps, micro,
                                           *v.shape[1:])).to(device)
             for k, v in batch_np.items()}
    seeds = torch.randint(-2 ** 31, 2 ** 31, (accum_steps, n_sites),
                          dtype=torch.int32, generator=seed_gen)
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
