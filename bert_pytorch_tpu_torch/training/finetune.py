"""The finetune loop: one for every registered task (counterpart of
bert_pytorch_tpu/training/finetune.py).

A task contributes what is task-shaped (model head, loss, featurizer,
eval and predict) through the `TaskRun` its `TaskSpec.setup` returns; the
loop owns the rest:

- the weights: random from --seed (`init_weights`, the config's
  initializer_range), then --init_checkpoint through
  `load_pretrained_params`: a port checkpoint directory `<dir>[@step]`
  (pretraining's `<output_dir>/pretrain_ckpts`), a JAX-package (orbax)
  checkpoint directory, a reference torch save (`ckpt_*.pt`) or a Google
  TF release (`.zip`, extracted directory, `.ckpt` prefix); the `bert.*`
  names of BertForPreTraining are the task heads' too;
- the steps: shuffled fixed-shape batches (`plain_train_batches`, the
  rows JAX draws from the same seed), `build_pretrain_step` with the
  task's loss and its optimizer (f32 gradients), dropout seeds a pure
  function of (--seed, step) (`training.pretrain.dropout_seeds`);
- packed training (--packing, --packing_max_segments): the first-fit
  packer (data/packing.first_fit, multi-segment units for multiple
  choice) fills each (--batch_size, seq) step with several short
  examples, in arrival order, the ones that do not fit leading the next
  step (`packed_train_batches`); each task's `pack_labels` places its
  labels at the segments' offsets and its `packed_loss_builder` reduces
  per segment. `packed_epoch_step_counts` counts the same stream
  (`_packed_steps`, the one place the packing is decided) before
  training, so total_steps and the LR schedule count the packed steps.
  Each logged step carries its real and slot tokens and
  `packing_efficiency` (real / slot);
- length-bucketed eval batches (`bucketed_eval_batches`): each example
  rides the smallest bucket that holds it;
- the final state saved with `CheckpointManager` under
  `<output_dir>/ckpt/<step>/`, which `run_server --task_checkpoint
  <task>=<output_dir>/ckpt` serves;
- one record a logged step through the run's MetricLogger
  (telemetry/run.init_run: `<output_dir>/<log_prefix>.{txt,jsonl}` and
  `_metrics.csv`; its `log` is handed to the task's setup as `record`),
  and a `perf` record a StepWatch interval (telemetry/stepwatch.py:
  step time, seq/s, real tokens/s, pad fraction, MFU against the card's
  peak; the card is synchronised at the interval's end only);
  --perf_artifact merges the
  last interval into a FINETUNE json (`write_finetune_artifact`);
- preemption: SIGTERM or SIGINT unwinds the run through
  resilience/preemption.py's guard, which saves the last completed
  step's state under `<output_dir>/ckpt/` before the process exits
  (128 + the signal); each step runs inside `guard.hold()`, so the
  in-place update is never cut in half;
- parameters beyond the model's own (`TaskRun.extra_params`, a
  distillation run's projections) are trained and saved beside the
  model's;
- --metrics_port serves /metrics and /healthz while the run lives
  (the step counter, the StepWatch gauges), and --watchdog_timeout arms
  the hung-step watchdog on the StepWatch's phases (resilience/
  watchdog.py): the two waits for the card, the batch's copy (`h2d`)
  and the loss's readback (`metric_flush`), are watched phases.

The tasks without an entry point of their own (classify, choice, embed)
share the JAX base parser's CLI and recipe: `base_finetune_parser`,
`resolve_tokenizer`, `dataset_splits`, `finetune_optimizer` (linear
warmup, `finetune_adam`, the optimizer of every task), and their val /
test accuracy (`accuracy_evals`, `eval_closures`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bert_pytorch_tpu_torch import resolve_device
from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
from bert_pytorch_tpu_torch.data.packing import first_fit
from bert_pytorch_tpu_torch.models.bert import init_weights
from bert_pytorch_tpu_torch.resilience.preemption import (
    PreemptionGuard, finetune_emergency_save)
from bert_pytorch_tpu_torch.resilience.watchdog import arm_watchdog
from bert_pytorch_tpu_torch.telemetry.run import init_run
from bert_pytorch_tpu_torch.telemetry.stepwatch import (StepWatch,
                                                        flops_per_seq,
                                                        lookup_peak_flops)
from bert_pytorch_tpu_torch.training.checkpoint import (
    CheckpointManager, load_jax_checkpoint, load_params, orbax_steps,
    parse_init_checkpoint)
from bert_pytorch_tpu_torch.training.pretrain import (build_pretrain_step,
                                                      dropout_seeds)
from bert_pytorch_tpu_torch.training.state import make_train_state

# The JAX finetune flags every task's parser carries whose feature the
# port lacks: flag -> the values that leave it off (`refuse`), and the
# flags that only tune such a feature. Every common flag is served.
COMMON_REFUSED: Dict[str, Tuple] = {}
COMMON_TUNING: Dict[str, str] = {}


def eval_buckets(max_seq_len: int, floor: int = 32) -> Tuple[int, ...]:
    """Length buckets for eval batching: 32/64/128/... up to (and always
    including) max_seq_len."""
    out = []
    b = int(floor)
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(int(max_seq_len))
    return tuple(sorted(set(out)))


def epoch_steps(train: Optional[Dict[str, np.ndarray]], args,
                group_size: int = 1) -> Tuple[int, int]:
    """(steps_per_epoch, total_steps) of --epochs over --batch_size, the
    --max_steps cap applied where the parser has it. Under --packing the
    steps are the packed stream's (`packed_epoch_step_counts`), which the
    loop dispatches exactly."""
    if train is None:
        return 0, 0
    if getattr(args, "packing", False):
        counts = packed_epoch_step_counts(
            train, n_rows=args.batch_size, seq_len=args.max_seq_len,
            max_segments=args.packing_max_segments, seed=args.seed,
            epochs=args.epochs, group_size=group_size)
        steps_per_epoch = counts[0] if counts else 0
        total_steps = sum(counts)
    else:
        steps_per_epoch = max(1, -(-len(train["input_ids"])
                                   // args.batch_size))
        total_steps = steps_per_epoch * args.epochs
    max_steps = getattr(args, "max_steps", None)
    if max_steps and max_steps > 0:
        total_steps = min(total_steps, int(max_steps))
    return steps_per_epoch, total_steps


def stack_microbatches(batch: Dict[str, np.ndarray], accum_steps: int
                       ) -> Dict[str, np.ndarray]:
    """(B, ...) numpy batch -> (accum, B / accum, ...)."""
    out = {}
    for k, x in batch.items():
        x = np.asarray(x)
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"accum {accum_steps}")
        out[k] = x.reshape(accum_steps, x.shape[0] // accum_steps,
                           *x.shape[1:])
    return out


def plain_train_batches(arrays: Dict[str, np.ndarray], batch_per_step: int,
                        accum_steps: int, shuffle: bool, seed: int,
                        label_ignore: Optional[Dict[str, int]] = None):
    """Fixed-shape per-step batches in the order of
    RandomState(seed).permutation, the tail padded to full by repeating
    index 0 with its labels set to the ignore value (zero loss). Yields
    ((accum, micro, ...) stacked batch, real_token_count,
    real_example_count)."""
    n = len(arrays["input_ids"])
    order = (np.random.RandomState(seed).permutation(n) if shuffle
             else np.arange(n))
    for lo in range(0, n, batch_per_step):
        idx = order[lo:lo + batch_per_step]
        pad = batch_per_step - len(idx)
        full = (np.concatenate([idx, np.zeros(pad, np.int64)]) if pad
                else idx)
        batch = {k: np.asarray(v[full]).copy() for k, v in arrays.items()}
        if pad:
            for fld, ign in (label_ignore or {}).items():
                batch[fld][len(idx):] = ign
        real = int(np.asarray(arrays["attention_mask"][idx], np.int64).sum())
        yield stack_microbatches(batch, accum_steps), real, len(idx)


@dataclasses.dataclass(frozen=True)
class UnitPlacement:
    """Where one training unit landed in a packed batch. A unit is one
    example: `group_size` sub-rows (1, or C for multiple choice, whose C
    choices must be consecutive segments of one row so the loss can
    regroup (B, G) as (B, G / C, C))."""

    unit: int                 # index into the per-example arrays
    row: int                  # packed batch row
    seg0: int                 # first segment slot (0-based)
    offsets: Tuple[int, ...]  # each sub-row's token offset within the row
    lengths: Tuple[int, ...]  # each sub-row's real token count


def _unit_lengths(attention_mask: np.ndarray) -> np.ndarray:
    """(N, S) or (N, C, S) masks -> (N,) real tokens a unit."""
    mask = np.asarray(attention_mask, np.int64)
    return mask.sum(axis=tuple(range(1, mask.ndim)))


def segment_scalar_pack_labels(arrays: Dict[str, np.ndarray],
                               placements: Sequence[UnitPlacement],
                               n_rows: int, seq_len: int,
                               max_segments: int) -> Dict[str, np.ndarray]:
    """Per-segment scalar labels for the pooled heads: (n_rows, G), -1 an
    empty slot (the `pack_labels` of classify and embed)."""
    labels = np.full((n_rows, max_segments), -1, np.int32)
    for p in placements:
        labels[p.row, p.seg0] = arrays["labels"][p.unit]
    return {"labels": labels}


def pack_finetune_batch(arrays: Dict[str, np.ndarray],
                        unit_indices: Sequence[int], n_rows: int,
                        seq_len: int, max_segments: int,
                        group_size: int = 1
                        ) -> Tuple[Dict[str, np.ndarray],
                                   List[UnitPlacement]]:
    """First-fit `unit_indices` (in arrival order) into one (n_rows,
    seq_len) packed batch: input_ids, token_type_ids, attention_mask,
    segment_ids (1..n a row, 0 pad) and position_ids (reset a segment),
    and the placements a task's `pack_labels` reads. Units that do not
    fit are not placed (they stay pending with the caller)."""
    lengths = _unit_lengths(arrays["attention_mask"])
    bins = first_fit([lengths[i] for i in unit_indices], n_bins=n_rows,
                     capacity=seq_len, max_segments=max_segments,
                     segs_per_unit=group_size)
    return _fill_packed_batch(arrays, unit_indices, bins, n_rows, seq_len,
                              group_size)


def _fill_packed_batch(arrays: Dict[str, np.ndarray],
                       unit_indices: Sequence[int], bins, n_rows: int,
                       seq_len: int, group_size: int
                       ) -> Tuple[Dict[str, np.ndarray],
                                  List[UnitPlacement]]:
    """The packed batch of one first_fit layout (`bins` of indices into
    `unit_indices`) and its placements."""
    ids = arrays["input_ids"]
    types = arrays.get("token_type_ids")
    sub_lengths = np.asarray(arrays["attention_mask"], np.int64).sum(axis=-1)
    batch = {k: np.zeros((n_rows, seq_len), np.int32)
             for k in ("input_ids", "token_type_ids", "attention_mask",
                       "segment_ids", "position_ids")}
    placements: List[UnitPlacement] = []
    for row, members in enumerate(bins):
        cursor, seg = 0, 0
        for local in members:
            unit = int(unit_indices[local])
            offsets, lens = [], []
            for c in range(group_size):
                at = (unit,) if group_size == 1 else (unit, c)
                ln = int(sub_lengths[at])
                sl = slice(cursor, cursor + ln)
                batch["input_ids"][row, sl] = ids[at][:ln]
                if types is not None:
                    batch["token_type_ids"][row, sl] = types[at][:ln]
                batch["attention_mask"][row, sl] = 1
                batch["segment_ids"][row, sl] = seg + 1
                batch["position_ids"][row, sl] = np.arange(ln,
                                                           dtype=np.int32)
                offsets.append(cursor)
                lens.append(ln)
                cursor += ln
                seg += 1
            placements.append(UnitPlacement(
                unit=unit, row=row, seg0=seg - group_size,
                offsets=tuple(offsets), lengths=tuple(lens)))
    return batch, placements


def _packable_lengths(arrays: Dict[str, np.ndarray],
                      seq_len: int) -> np.ndarray:
    """(N,) real tokens a unit, each checked to fit one packed row."""
    lengths = _unit_lengths(arrays["attention_mask"])
    too_long = [int(i) for i in np.nonzero(lengths > seq_len)[0]]
    if too_long:
        raise ValueError(
            f"{len(too_long)} unit(s) exceed seq_len {seq_len} (e.g. unit "
            f"{too_long[0]}: {int(lengths[too_long[0]])} tokens) — a "
            "multi-choice group must fit one row to pack; raise "
            "--max_seq_len or disable --packing")
    return lengths


def _packed_steps(lengths: np.ndarray, order: Sequence[int], n_rows: int,
                  seq_len: int, max_segments: int, group_size: int):
    """The one packing decision of an epoch: first-fit the pending units
    in arrival order, a window of them at a time; units that do not fit a
    step stay pending and lead the next one. Yields each step's (window,
    first_fit bins of indices into the window)."""
    pending: List[int] = [int(i) for i in order]
    window = max(1, n_rows * max_segments * 2)
    while pending:
        head = pending[:window]
        bins = first_fit([lengths[i] for i in head], n_bins=n_rows,
                         capacity=seq_len, max_segments=max_segments,
                         segs_per_unit=group_size)
        placed = {head[local] for b in bins for local in b}
        if not placed:  # the head unit always fits an empty row
            raise RuntimeError("packer failed to place the head unit")
        pending = [i for i in pending if i not in placed]
        yield head, bins


def packed_epoch_step_counts(arrays: Dict[str, np.ndarray], n_rows: int,
                             seq_len: int, max_segments: int, seed: int,
                             epochs: float, group_size: int = 1
                             ) -> List[int]:
    """The steps `packed_train_batches` dispatches in each epoch (epoch
    e's order is a pure function of seed + e), counted over the same
    `_packed_steps` stream without building a batch: the run's
    total_steps, and so its LR schedule, count packed steps. A fractional
    last epoch counts round(fraction x its steps)."""
    n = len(arrays["input_ids"])
    if n == 0 or epochs <= 0:
        return []
    lengths = _packable_lengths(arrays, seq_len)
    full = int(epochs)
    frac = float(epochs) - full
    counts = [sum(1 for _ in _packed_steps(
        lengths, np.random.RandomState(seed + e).permutation(n), n_rows,
        seq_len, max_segments, group_size))
        for e in range(full + (1 if frac > 0 else 0))]
    if frac > 0:
        counts[-1] = max(1, int(round(frac * counts[-1])))
    return counts


def packed_train_batches(arrays: Dict[str, np.ndarray], n_rows: int,
                         seq_len: int, max_segments: int,
                         pack_labels: Callable, shuffle: bool, seed: int,
                         group_size: int = 1):
    """Packed steps: shuffle once, then fill each step of the
    `_packed_steps` stream. Yields ((1, n_rows, ...) stacked packed batch,
    real token count, placed example count)."""
    n = len(arrays["input_ids"])
    lengths = _packable_lengths(arrays, seq_len)
    order = (np.random.RandomState(seed).permutation(n) if shuffle
             else np.arange(n))
    for head, bins in _packed_steps(lengths, order, n_rows, seq_len,
                                    max_segments, group_size):
        batch, placements = _fill_packed_batch(arrays, head, bins, n_rows,
                                               seq_len, group_size)
        batch.update(pack_labels(arrays, placements, n_rows, seq_len,
                                 max_segments))
        real = int(sum(sum(p.lengths) for p in placements))
        yield ({k: v[None] for k, v in batch.items()}, real,
               len(placements))


def bucketed_eval_batches(arrays: Dict[str, np.ndarray], batch_size: int,
                          buckets: Sequence[int],
                          label_ignore: Optional[Dict[str, int]] = None):
    """Examples grouped by the smallest bucket that holds their real
    length, every sequence-shaped field trimmed to the bucket, tails
    padded to batch_size by repeating index 0 with ignored labels. Pad
    keys carry an exact-zero attention weight either way, so trimming
    changes the work, not the answers. Yields (np_batch, real_indices,
    bucket)."""
    mask = np.asarray(arrays["attention_mask"], np.int64)
    sub_len = mask.sum(axis=-1)
    max_len = sub_len.max(axis=-1) if sub_len.ndim > 1 else sub_len
    buckets = sorted(set(int(b) for b in buckets))
    by_bucket: Dict[int, List[int]] = {}
    for i, ln in enumerate(max_len):
        for b in buckets:
            if ln <= b:
                by_bucket.setdefault(b, []).append(i)
                break
        else:
            by_bucket.setdefault(buckets[-1], []).append(i)
    seq_fields = {k for k, v in arrays.items()
                  if np.asarray(v).ndim >= 2
                  and np.asarray(v).shape[-1] == mask.shape[-1]}
    for bucket in sorted(by_bucket):
        idx_all = by_bucket[bucket]
        for lo in range(0, len(idx_all), batch_size):
            idx = np.asarray(idx_all[lo:lo + batch_size])
            pad = batch_size - len(idx)
            full = (np.concatenate([idx, np.zeros(pad, np.int64)]) if pad
                    else idx)
            batch = {}
            for k, v in arrays.items():
                picked = np.asarray(v[full]).copy()
                if k in seq_fields:
                    picked = picked[..., :bucket].copy()
                batch[k] = picked
            if pad:
                for fld, ign in (label_ignore or {}).items():
                    batch[fld][len(idx):] = ign
            yield batch, idx, bucket


def base_finetune_parser(description: str):
    """The CLI of the tasks without an entry point of their own (classify,
    choice, embed): the JAX base parser's flags and defaults, and the
    common ones (`add_common_finetune_flags`)."""
    import argparse

    p = argparse.ArgumentParser(description=description)
    p.add_argument("--train_file", type=str, default=None)
    p.add_argument("--val_file", type=str, default=None)
    p.add_argument("--test_file", type=str, default=None)
    p.add_argument("--model_config_file", type=str, required=True)
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="a port checkpoint directory <dir>[@step] "
                        "(pretraining's <output_dir>/pretrain_ckpts)")
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--uppercase", action="store_true", default=None,
                   help="cased tokenization (default: the model config's "
                        "`lowercase`, as the server tokenizes)")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_seq_len", type=int, default=128)
    p.add_argument("--max_steps", type=int, default=-1,
                   help="cap on optimizer steps (benchmarking)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--log_prefix", type=str, default=None)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    add_common_finetune_flags(p)
    return p


def resolve_tokenizer(args, config):
    """The WordPiece tokenizer of a task run, cased as the server cases it
    (`uppercase=not config.lowercase`) unless --uppercase is given."""
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)

    vocab_file = args.vocab_file or config.vocab_file
    if not vocab_file:
        raise SystemExit("vocab_file required (CLI or model config)")
    upper = getattr(args, "uppercase", None)
    if upper is None:
        upper = not config.lowercase
    return get_wordpiece_tokenizer(vocab_file, uppercase=upper)


def dataset_splits(args, build) -> Dict[str, Dict[str, np.ndarray]]:
    """{split: build(path)} over the --train_file / --val_file /
    --test_file given."""
    return {split: build(path)
            for split, path in (("train", args.train_file),
                                ("val", args.val_file),
                                ("test", args.test_file)) if path}


def finetune_adam(schedule: Callable[[int], float],
                  max_grad_norm: Optional[float]):
    """The optimizer of every finetune recipe: FusedAdam without bias
    correction, weight decay 0.01 except biases and LayerNorms, the
    global-norm clip at `max_grad_norm` first (None or <= 0: off)."""
    from bert_pytorch_tpu_torch.optim.adam import FusedAdam

    return FusedAdam(schedule, weight_decay=0.01, bias_correction=False,
                     max_grad_norm=max_grad_norm)


def finetune_optimizer(args, total_steps: int):
    """(schedule, tx) of the base parser's recipe: linear warmup over
    --warmup_proportion of the steps and linear decay from --lr, and
    `finetune_adam` with the clip at --clip_grad."""
    from bert_pytorch_tpu_torch.optim.schedulers import (
        linear_warmup_schedule)

    sched = linear_warmup_schedule(args.lr, max(total_steps, 1),
                                   warmup=args.warmup_proportion)
    return sched, finetune_adam(sched, args.clip_grad)


def accuracy_evals(datasets: Dict[str, Dict[str, np.ndarray]],
                   batch_size: int, buckets: Sequence[int],
                   logits_fn: Callable, device) -> Dict[str, Callable]:
    """{split: run() -> accuracy} for the val and test splits present:
    `logits_fn(feats)` scores a length-bucketed batch of device tensors,
    argmaxed against the split's 'labels'."""
    from bert_pytorch_tpu_torch.data import glue

    def make(split):
        arrays = datasets[split]

        def run() -> float:
            outs, labels = [], []
            with torch.no_grad():
                for batch, idx, _bucket in bucketed_eval_batches(
                        arrays, batch_size, buckets,
                        label_ignore={"labels": -1}):
                    feats = {k: v for k, v in batch.items() if k != "labels"}
                    out = logits_fn(to_device(feats, device))
                    outs.append(out.float().cpu().numpy()[:len(idx)])
                    labels.append(arrays["labels"][idx])
            return glue.accuracy(np.concatenate(outs),
                                 np.concatenate(labels))

        return run

    return {s: make(s) for s in ("val", "test") if s in datasets}


def eval_closures(evals: Dict[str, Callable], record,
                  metric: str = "accuracy"
                  ) -> Tuple[Optional[Callable], Callable]:
    """(epoch_eval, finalize) over `accuracy_evals`' runners: epoch_eval
    records the val accuracy each epoch (None without a val split),
    finalize the test accuracy; both through `record` (the run's
    MetricLogger.log) under `metric`."""

    def epoch_eval(epoch: int) -> Dict[str, float]:
        acc = evals["val"]()
        record("val", epoch, epoch=epoch, **{metric: acc})
        return {"val_accuracy": acc}

    def finalize(results: Dict) -> Dict[str, float]:
        out = {}
        if "test" in evals:
            acc = evals["test"]()
            record("test", 0, **{metric: acc})
            out["test_accuracy"] = acc
        return out

    return (epoch_eval if "val" in evals else None), finalize


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


@dataclasses.dataclass
class TaskRun:
    """Everything task-shaped the loop needs, built by a
    TaskSpec.setup(args, config, device, log, record). `train_arrays=None`
    skips training (predict / eval-only runs). The model holds the weights
    the loop trains (its parameters are the train state's), so
    `epoch_eval(epoch)` and `finalize(results)` read them from it."""

    model: torch.nn.Module
    tx: Any
    schedule: Callable[[int], float]
    seq_len: int
    batch_size: int                       # examples per optimizer step
    accum_steps: int = 1
    total_steps: int = 0
    epochs: Optional[int] = None          # None: loop until total_steps
    train_arrays: Optional[Dict[str, np.ndarray]] = None
    loss_builder: Optional[Callable] = None
    packed_loss_builder: Optional[Callable] = None   # --packing batches
    pack_labels: Optional[Callable] = None
    group_size: int = 1                   # sub-rows a unit (choice: C)
    label_ignore: Dict[str, int] = dataclasses.field(default_factory=dict)
    log_every: int = 50
    # FLOPs a step computes per row (None: flops_per_seq of the loaded
    # config, forward and backward; a distillation adds its teacher's
    # forward to the student's)
    flops_per_row: Optional[float] = None
    init_checkpoint: Optional[str] = None
    epoch_eval: Optional[Callable[[int], Optional[Dict]]] = None
    finalize: Optional[Callable[[Dict], Optional[Dict]]] = None
    log_epoch_metrics: bool = False
    # parameters by name trained and saved beside the model's own
    extra_params: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)


def write_finetune_artifact(path: str, task: str,
                            record: Dict[str, Any]) -> None:
    """Merge one task's finetune perf summary into a FINETUNE_*.json
    artifact (several tasks accumulate into one file)."""
    doc: Dict[str, Any] = {"schema_version": 1, "kind": "finetune",
                           "tasks": {}}
    try:
        with open(path, encoding="utf-8") as f:
            prev = json.load(f)
        if isinstance(prev, dict) and isinstance(prev.get("tasks"), dict):
            doc = prev
    except (OSError, ValueError):
        pass
    doc["schema_version"] = 1
    doc["kind"] = "finetune"
    doc["time_unix"] = round(time.time(), 3)
    doc["tasks"][task] = record
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True, allow_nan=False)
        f.write("\n")


def _is_tf_source(path: str) -> bool:
    """Does `path` name an outside weight source (a Google TF release:
    registry name, URL, zip, extracted directory, bare ckpt prefix; or a
    reference torch save) rather than a checkpoint directory?"""
    from bert_pytorch_tpu_torch.models.pretrained import RELEASE_NAMES

    if path in RELEASE_NAMES or "://" in path or path.endswith(
            (".zip", ".ckpt", ".pt", ".pth", ".bin")):
        return True
    if os.path.isdir(path):
        for _root, _dirs, files in os.walk(path):
            if "bert_config.json" in files or any(
                    f.endswith(".ckpt.index") for f in files):
                return True
        return False
    return os.path.exists(path + ".index")


def load_pretrained_params(spec: str, params: Dict[str, torch.Tensor],
                           log: Callable[[str], None] = print) -> None:
    """Seed `params` (by name, in place) from --init_checkpoint `spec`:
    weights only, the step and the optimizer state stay fresh. The source
    is, in this order (the JAX package's `load_pretrained_params`):

    - a Google TF release or a reference torch save (`_is_tf_source`):
      `models/pretrained.from_pretrained`, its vocab re-padded to this
      model's padded size (embedding rows 0, MLM bias PADDED_VOCAB_BIAS);
      a registry name or a URL is refused (it needs the network);
    - a JAX-package (orbax) checkpoint directory `<dir>[@step]` (its
      steps hold `state/_METADATA`): `training/checkpoint.
      load_jax_checkpoint`, either encoder layout;
    - else a port checkpoint directory `<dir>[@step]`.

    Everything lands on the port's names through `params_from_flax`. A
    parameter that is not loaded (absent, or of another shape) keeps its
    fresh initialisation and is reported; raises when none matches."""
    from bert_pytorch_tpu_torch.models.convert import params_from_flax

    if _is_tf_source(spec):
        from bert_pytorch_tpu_torch.models.pretrained import (
            PADDED_VOCAB_BIAS, _pad_vocab, from_pretrained)

        _, flat = from_pretrained(spec, vocab_pad_multiple=1,
                                  next_sentence=True)
        vocab = params["bert.embeddings.word_embeddings.weight"].shape[0]
        emb = "bert/embeddings/word_embeddings/embedding"
        if flat[emb].shape[0] < vocab:
            flat[emb] = _pad_vocab(flat[emb], vocab, 0.0)
            if "cls_predictions/bias" in flat:
                flat["cls_predictions/bias"] = _pad_vocab(
                    flat["cls_predictions/bias"], vocab, PADDED_VOCAB_BIAS)
        src = params_from_flax(flat)
        step = ("torch-ckpt" if spec.endswith((".pt", ".pth", ".bin"))
                else "tf-release")
    elif orbax_steps(parse_init_checkpoint(spec)[0]):
        flat, step = load_jax_checkpoint(spec)
        src = params_from_flax(flat)
    else:
        src, step = load_params(spec, log=log)
    loaded, fresh = [], []
    with torch.no_grad():
        for k, p in params.items():
            cand = src.get(k)
            if cand is not None and tuple(cand.shape) == tuple(p.shape):
                p.copy_(cand)
                loaded.append(k)
            else:
                fresh.append(k if cand is None else
                             f"{k} (shape {tuple(cand.shape)} != "
                             f"{tuple(p.shape)})")
    log(f"init_checkpoint step {step}: loaded {len(loaded)} param leaves, "
        f"{len(fresh)} fresh-initialized")
    if fresh:
        log("WARNING: fresh-initialized (not found in checkpoint or shape "
            "mismatch): " + ", ".join(sorted(fresh)))
    if not loaded:
        raise ValueError(f"checkpoint {spec} (step {step}) shares no "
                         "same-shaped parameters with this model — wrong "
                         "checkpoint?")


def add_common_finetune_flags(p) -> None:
    """The JAX finetune parsers' common flags (packing, its segment cap,
    the perf artifact, the metrics exporter and the watchdog), with the
    JAX defaults; and --device, the port's own."""
    p.add_argument("--packing", action="store_true",
                   help="pack several short examples into each row "
                        "(first-fit, per-segment losses)")
    p.add_argument("--packing_max_segments", type=int, default=8,
                   help="examples a packed row holds at most (choice: "
                        "rounded to a multiple of --num_choices)")
    p.add_argument("--perf_artifact", type=str, default=None,
                   help="merge this task's last StepWatch interval into "
                        "this FINETUNE json (several tasks accumulate)")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve /metrics and /healthz on this port while "
                        "the run lives (0: an ephemeral port, logged)")
    p.add_argument("--watchdog_timeout", type=float, default=0.0,
                   help="hung-step watchdog: a host phase longer than this "
                        "many seconds dumps every thread's stack and acts "
                        "per --watchdog_action (0: off)")
    p.add_argument("--watchdog_action", type=str, default="abort",
                   choices=["abort", "warn"],
                   help="on a watchdog trip: 'abort' exits 72 (device) or "
                        "73 (input); 'warn' logs once a stall")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")


def run_task(spec, args, log: Callable[[str], None] = print,
             trace: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The finetune entry body for any registered TaskSpec: setup, train,
    checkpoint, eval. Returns the results (the JAX run_task's keys:
    e2e_train_time, training_sequences_per_second and the task's own).
    `trace`, when given, receives the run's internals for a caller that
    checks them: `history` (per step: loss, grad_norm, learning_rate),
    `state` (the final TrainState), `run` (the TaskRun), `device`."""
    if not getattr(args, "output_dir", None):
        raise SystemExit("--output_dir is required")
    device = resolve_device(getattr(args, "device", None))
    os.makedirs(args.output_dir, exist_ok=True)
    config = BertConfig.from_json_file(args.model_config_file)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    prefix = getattr(args, "log_prefix", None) or f"{spec.name}_log"
    tel = init_run(spec.name, log_prefix=os.path.join(args.output_dir, prefix),
                   echo=log, metrics_port=getattr(args, "metrics_port", None))
    record = tel.logger.log
    guard = PreemptionGuard(log=log)
    guard.install()
    watchdog = None
    # the last completed step's state, which a preemption saves
    survival: Dict[str, Any] = {}
    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    try:
        run: TaskRun = spec.setup(args, config, device, log, record)
        packing = bool(getattr(args, "packing", False))
        if packing and run.pack_labels is None:
            raise SystemExit(f"task '{spec.name}' does not support "
                             "--packing")
        if packing and run.accum_steps > 1:
            raise SystemExit(
                "--packing is incompatible with gradient accumulation "
                f"(accum_steps={run.accum_steps}): the packer owns the "
                "per-step example budget, so accumulation would silently "
                "change the effective batch and LR-schedule basis. Drop "
                "one of the two flags.")
        init_weights(run.model, torch.Generator(device=device).manual_seed(
            args.seed), std=config.initializer_range)
        state = make_train_state(run.model, run.tx, extra=run.extra_params)
        if run.init_checkpoint:
            load_pretrained_params(run.init_checkpoint, state.params,
                                   log=log)
        results: Dict[str, Any] = {}
        history: List[Dict[str, Any]] = []
        if trace is not None:
            trace.update(run=run, state=state, history=history,
                         device=device)
        if run.train_arrays is not None and run.total_steps > 0:
            sw = _stepwatch(args, run, config, device, packing, tel)
            watchdog = arm_watchdog(
                getattr(args, "watchdog_timeout", 0.0),
                getattr(args, "watchdog_action", "abort"), sw,
                registry=tel.registry, log=log, out_dir=args.output_dir)
            last_perf = _train(spec, args, run, state, config, device,
                               results, history, log, guard,
                               survival, sw, tel)
            CheckpointManager(ckpt_dir, log=log).save(
                state.step, state.state_dict(),
                extra={"task": spec.name,
                       "config": dataclasses.asdict(config)})
            artifact = getattr(args, "perf_artifact", None)
            if artifact and last_perf is not None:
                rec = {k: last_perf[k] for k in
                       ("real_tokens_per_sec", "pad_fraction",
                        "packing_efficiency", "seq_per_sec",
                        "step_time_ms", "mfu") if k in last_perf}
                rec["packing"] = bool(getattr(args, "packing", False))
                rec["steps"] = state.step
                write_finetune_artifact(artifact, spec.name, rec)
                log(f"finetune[{spec.name}]: perf artifact -> {artifact}")
        if run.finalize is not None:
            results.update(run.finalize(results) or {})
        numbers = {k: v for k, v in results.items()
                   if isinstance(v, (int, float))}
        if numbers:
            record("final", 0, **numbers)
        log(json.dumps(results, default=str))
        return results
    except BaseException as exc:
        # a preemption saves the last completed step before the unwind
        finetune_emergency_save(guard, exc, survival, ckpt_dir, spec.name,
                                log=log)
        raise
    finally:
        for closeable in (watchdog, guard, tel):
            if closeable is not None:
                closeable.close()


def _stepwatch(args, run, config, device, packing: bool,
               tel) -> StepWatch:
    """The run's StepWatch on JAX's basis: the rows a step computes (a
    packed step its batch rows; else batch x accum x group) times
    flops_per_seq of the loaded config at the run's sequence length, or
    `run.flops_per_row` where the run sets it (a distillation: JAX counts
    its teacher's forward and backward instead), against the card's peak
    at --dtype (none off a card)."""
    if packing:
        rows = run.batch_size
    else:
        rows = run.batch_size * run.accum_steps * run.group_size
    on_card = device.type == "cuda"
    peak = (lookup_peak_flops(torch.cuda.get_device_name(device),
                              dtype=getattr(args, "dtype", "bfloat16"))
            if on_card else None)
    return tel.make_stepwatch(
        flops_per_step=(run.flops_per_row or flops_per_seq(
            config, run.seq_len, config.vocab_size, 0)) * rows,
        seqs_per_step=rows, seq_len=run.seq_len, peak_flops=peak,
        log_freq=run.log_every,
        sync=(lambda: torch.cuda.synchronize(device)) if on_card else None)


def _train(spec, args, run, state, config, device, results,
           history, log, guard, survival, sw, tel
           ) -> Optional[Dict[str, Any]]:
    """The steps; returns the last StepWatch record."""
    accum = run.accum_steps
    packing = bool(getattr(args, "packing", False))
    last_perf = None
    step_fn = build_pretrain_step(
        run.model, run.tx, schedule=run.schedule, accum_steps=accum,
        loss_fn_builder=(run.packed_loss_builder if packing
                         else run.loss_builder))
    n_sites = run.model.n_dropout_sites
    # token slots a step computes: the packed (batch, seq) rows, or
    # batch x accum examples of group_size rows each
    slots = run.batch_size * run.seq_len * (
        1 if packing else accum * run.group_size)
    log(f"finetune[{spec.name}]: {run.total_steps} step(s), batch "
        f"{run.batch_size} x accum {accum}, seq {run.seq_len}, device "
        f"{device}, layers {config.num_hidden_layers}, packing "
        + (f"on (max_segments {args.packing_max_segments})" if packing
           else "off"))
    t0 = time.perf_counter()
    step = epoch = examples_done = 0
    metrics = None
    while step < run.total_steps:
        epoch_real = epoch_steps_done = 0
        if packing:
            batches = packed_train_batches(
                run.train_arrays, n_rows=run.batch_size,
                seq_len=run.seq_len, max_segments=args.packing_max_segments,
                pack_labels=run.pack_labels, shuffle=True,
                seed=args.seed + epoch, group_size=run.group_size)
        else:
            batches = plain_train_batches(
                run.train_arrays, run.batch_size * accum, accum,
                shuffle=True, seed=args.seed + epoch,
                label_ignore=run.label_ignore)
        for batch_np, real, n_examples in batches:
            if step >= run.total_steps:
                break
            with sw.phase("data_prep"):
                seeds = dropout_seeds(args.seed, step + 1, accum, n_sites)
                sw.note_tokens(real)
            with sw.phase("h2d"):    # a pageable copy waits for the card
                batch = to_device(batch_np, device)
            with guard.hold(), sw.phase("dispatch"):
                metrics = step_fn(state, batch, seeds)
                step += 1
                survival["state"], survival["step"] = state, state.step
            examples_done += n_examples
            epoch_real += real
            epoch_steps_done += 1
            metrics.update(examples=n_examples, real_tokens=real,
                           slot_tokens=slots,
                           packing_efficiency=real / slots)
            history.append(metrics)
            if not run.log_epoch_metrics and (
                    step % run.log_every == 0 or step == run.total_steps):
                with sw.phase("metric_flush"):   # reading waits for the card
                    tel.log_train(step, loss=float(metrics["loss"]),
                                  learning_rate=float(
                                      metrics["learning_rate"]),
                                  real_tokens=real, slot_tokens=slots,
                                  packing_efficiency=real / slots)
            perf = sw.step_done()
            if perf is not None:
                tel.log_perf(step, perf)
                last_perf = perf
        if run.log_epoch_metrics and metrics is not None:
            # the epoch's mean real tokens a step
            n = max(epoch_steps_done, 1)
            with sw.phase("metric_flush"):
                tel.log_train(step, epoch=epoch,
                              loss=float(metrics["loss"]),
                              learning_rate=float(metrics["learning_rate"]),
                              real_tokens=epoch_real / n, slot_tokens=slots,
                              packing_efficiency=epoch_real / (slots * n))
        if run.epoch_eval is not None and step > 0:
            with sw.pause():    # eval is no part of a step's time
                results.update(run.epoch_eval(epoch) or {})
        epoch += 1
        if run.epochs is not None and epoch >= run.epochs:
            break
    perf = sw.flush()   # the partial interval: a short run still gets one
    if perf is not None:
        tel.log_perf(step, perf)
        last_perf = perf
    for i, m in enumerate(history):   # reading a loss waits for the card
        history[i] = {k: (v.item() if torch.is_tensor(v) else v)
                      for k, v in m.items()}
    train_time = time.perf_counter() - t0
    results["e2e_train_time"] = train_time
    results["training_sequences_per_second"] = (
        examples_done / max(train_time, 1e-9))
    return last_perf
