"""Pretraining entry point of the port: BERT pretraining on one card or
over several ranks, phase 1 (seq 128) or phase 2 (seq 512, attention
through the flash kernels), the sequence length taken from the shards (or
--stream_seq_len).

    python -m bert_pytorch_tpu_torch.run_pretraining \\
        --config_file configs/bert_pretraining_phase{1,2}_config.json \\
        --input_dir <dir of .hdf5 shards> --output_dir <dir> \\
        [--fused_optim auto] [--device cuda|cpu] [--steps N]
    python -m bert_pytorch_tpu_torch.run_pretraining ... \\
        --stream_dir <dir of raw .txt> --stream_vocab <vocab> \\
        [--stream_tokenizer wordpiece|bpe] --output_dir <dir>

Flags, defaults and precedence (CLI > JSON run config > defaults) are the
JAX entry point's (run_pretraining.py), trimmed to what the port
implements: a model initialised at random from --seed, dynamic masking of
sharded-HDF5 data, the gathered MLM head, gradient accumulation up to
--global_batch_size, bf16 compute with bf16 gradients over f32 masters,
LAMB with a warmup schedule (--fused_optim: "off" and "xla" tensor by
tensor, "auto"/"pallas" the fused multi-tensor kernels on the card), and
the non-finite health checks. --stream_dir reads raw text instead of
shards, tokenized on the fly by a thread pool (data/streaming.py: the
same batches as the JAX package's loader, its cursor in every checkpoint,
a resume bit-identical, masks included; --stream_tokenizer bpe reads a
byte-level BPE vocab, its <mask> the mask id; --stream_inject drills the
plane's faults); the two planes' flags conflict at parse time. Batches
reach the card through data/sharded.DevicePrefetcher: at --h2d_prefetch N
(default 1) the next batch is pulled, pinned and copied on a side CUDA
stream while the card runs the step. --packing packs several short
examples into each row (data/packing.py: segment-masked attention,
positions reset per segment, NSP per segment; the gathered MLM head's
budget grows to a row's); --checkpoint_activations recomputes each
encoder layer in the backward pass under the model config's remat_policy
(nothing, dots, mlp_only). --kfac preconditions the gradients with K-FAC
before LAMB (optim/kfac.py; configs/bert_kfac_pretraining_phase1_config
.json). --steps_per_loop N runs N steps a host dispatch over a staged
(N, ...) chunk, reading the metrics once a chunk (the health flags
max-accumulated), bit-equal to N=1. --profile_steps lo,hi writes a
torch.profiler trace of those steps under <output_dir>/traces/ and logs
its summary (telemetry/trace.py; tools/trace_summary.py reads it again).

Several ranks (parallel/): `torchrun --nproc_per_node N -m
bert_pytorch_tpu_torch.run_pretraining --mesh data=N ...` runs rank r on
cuda:LOCAL_RANK (NCCL; --device cpu: gloo). --local_batch_size is a
rank's microbatch, as in the JAX entry point; each rank reads its part of
the data (HostShardSampler's split, masks at --seed + rank); the
gradients are summed over the ranks after the last microbatch. --zero1
(auto: on above one rank) shards LAMB's moments and update
(parallel/zero.py), with --zero1_rs (a reduce-scatter of the gradients)
and --zero1_overlap (the weights gathered where the forward uses them);
--coalesce_reductions buckets the norm reductions; --mesh_config auto
picks `production` (packing, ZeRO-1, gather-on-use) on cards. Rank 0
logs, writes the sinks and the one-card checkpoint format; each rank's
perf records land in <output_dir>/metrics_hosts/, folded into rank 0's.

Checkpoints: every --num_steps_per_checkpoint steps and at the end of the
run into <output_dir>/pretrain_ckpts/<global step>/, the newest
--keep_checkpoints kept (--skip_checkpoint turns saving off). A run
auto-resumes from the newest checkpoint in its output_dir, which takes
precedence over --init_checkpoint (weights only, through
training/finetune.load_pretrained_params: a port checkpoint directory
<dir>[@step], a JAX-package orbax directory, a reference ckpt_*.pt or a
Google TF release). So phase 2 run in phase 1's output_dir continues from
phase 1's last step with its LAMB moments, and its schedule takes the run
config's previous_phase_end_step as its offset. Each step's dropout seeds
are a pure function of (--seed, global step), so a resumed run draws the
masks an uninterrupted run draws.

Telemetry (telemetry/run.py, as the JAX entry point wires it): a header
record, then each optimizer step (or chunk) a `train` record (epoch, average_loss,
step_loss and the step's metrics, with the health pack's) and every
--log_freq steps a StepWatch `perf` record (step time, seq/s, MFU on the
card's peak, the host phases data_wait / data_prep / h2d / dispatch /
metric_flush / checkpoint; on a card the allocator's peak, in-use and
total bytes as hbm_peak_bytes, hbm_bytes_in_use, hbm_bytes_limit) in
<output_dir>/<log_prefix>.{txt,jsonl} and
<log_prefix>_metrics.csv, and (--tensorboard on, the default) as
TensorBoard scalars under <log_prefix>_tb; --metrics_port serves them as
/metrics with a /healthz (a streaming run's cursor on it). The flight
recorder (--flight_recorder, on by default) keeps the last
--recorder_window steps' batches and dropout seeds and dumps a
repro bundle under <output_dir>/repro_bundles on a non-finite step, a
watchdog trip or a crash; tools/replay.py reproduces and bisects it.
Survival (resilience/): each step runs inside the preemption guard, and
SIGTERM saves the last completed step (exit 143);
--watchdog_timeout arms the hung-step watchdog; --chaos drills the
deaths; --slo_config evaluates the train SLOs. `_cli` exits 71 on a
--nonfinite_action=halt trip and 76 on an --slo_action=halt breach.
Runs on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from bert_pytorch_tpu_torch import PRETRAIN_GAPS as _ROADMAP
from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

# The JAX entry point's flags (run_pretraining.py, parse_arguments) whose
# feature the port lacks. The parser declares each one with the JAX type
# and choices and the default that leaves its feature off, so a JAX command
# line parses; a value that switches its feature on, from the command line
# or a run config, is refused: key -> the values that leave it off.
_REFUSED = {
    # the port's per-layer modules are the JAX "false" layout
    "stacked_params": ("auto", "false"),
    # the libtpu flag pack
    "overlap_flags": ("off",),
    # the port's dropout seeds come from numpy (dropout_seeds)
    "rng_impl": ("threefry2x32",),
    "force_cpu": (False,),
}
_HINTS = {"force_cpu": "use `--device cpu`"}
# What the data axis left of multi-card training (PARALLEL_GAPS): the
# fsdp axis's gather-on-use. A --mesh with fsdp, model or seq above 1 and
# --kfac over several ranks are refused by `_unsupported` and `train`.
_REFUSED_PARALLEL = {"fsdp_overlap": (False,)}
# Flags that only tune a feature refused above: accepted with any value,
# since their feature is off. (--kfac_bucket_mb sizes K-FAC's coalesced
# factor reductions over several ranks, which `train` refuses; it is
# accepted at any value.)
_TUNING: Dict[str, str] = {}
# stream flags that only make sense with --stream_dir: given on the
# command line without it, they fail at parse time (JAX's list)
_STREAM_DEPENDENT_FLAGS = ("stream_vocab", "stream_tokenizer",
                           "stream_seq_len", "stream_workers",
                           "stream_queue_batches", "stream_inject")


def _declare_refused(p: argparse.ArgumentParser) -> None:
    """The JAX flags of `_REFUSED`, `_REFUSED_PARALLEL` and `_TUNING`,
    with JAX's types and choices; each default leaves its feature off."""
    p.add_argument("--kfac_bucket_mb", type=float, default=4.0)
    p.add_argument("--stacked_params", type=str, default="auto",
                   choices=["auto", "true", "false"])
    p.add_argument("--fsdp_overlap", action="store_true")
    p.add_argument("--overlap_flags", type=str, default="off",
                   choices=["on", "off"])
    p.add_argument("--rng_impl", type=str, default="threefry2x32",
                   choices=["rbg", "unsafe_rbg", "threefry2x32"])
    p.add_argument("--force_cpu", action="store_true")


def _declare_parallel(p: argparse.ArgumentParser) -> None:
    """The data axis's flags (parallel/): JAX's names, types, choices and
    defaults."""
    p.add_argument("--mesh", type=str, default="",
                   help="mesh axes, e.g. 'data=4' (empty: data = the rank "
                        "count); their product must equal the ranks. The "
                        "port implements the data axis: fsdp, model or seq "
                        "above 1 is refused")
    p.add_argument("--zero1", type=str, default="auto",
                   choices=["auto", "true", "false"],
                   help="ZeRO-1: each rank keeps LAMB's moments for its "
                        "1/N of the parameters and updates only that "
                        "slice, then the slices are all-gathered (auto: on "
                        "when the data axis is above 1)")
    p.add_argument("--zero1_overlap", action="store_true",
                   help="ZeRO-1's gather-on-use: the masters rest as "
                        "slices between steps; each unit's all-gather is "
                        "issued at the step's start and awaited where the "
                        "forward first uses it")
    p.add_argument("--zero1_rs", action="store_true",
                   help="ZeRO-1's gradients leave through a reduce-scatter "
                        "into each rank's slice instead of an all-reduce "
                        "and a slice (forces --zero1_overlap)")
    p.add_argument("--mesh_config", type=str, default="auto",
                   choices=["auto", "production", "base"],
                   help="production: packing, ZeRO-1 and --zero1_overlap "
                        "where the data axis is above 1; auto picks it on "
                        "cards for a mesh with a data axis above 1")
    p.add_argument("--coalesce_reductions", type=str, default="off",
                   choices=["on", "off"],
                   help="the norm reductions of a ZeRO-1 step in 4 MB "
                        "buckets (on) or one a tensor (off); the same bits "
                        "either way")


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
                   help="seed the weights (only) from a port checkpoint "
                        "<dir>[@step], a JAX orbax directory, a reference "
                        "ckpt_*.pt or a Google TF release; an auto-resume "
                        "from output_dir takes precedence")
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
    p.add_argument("--checkpoint_activations", action="store_true",
                   help="recompute each encoder layer in the backward pass "
                        "(the model config's remat_policy: nothing, dots "
                        "or mlp_only)")
    p.add_argument("--packing", action="store_true",
                   help="sequence packing: each row holds several short "
                        "examples (segment-masked attention, positions and "
                        "NSP per segment); resumes with the packer's "
                        "pending examples")
    p.add_argument("--packing_max_segments", type=int, default=8,
                   help="most examples packed into one row")
    p.add_argument("--packing_lookahead", type=int, default=4,
                   help="batches of examples the packer may look ahead "
                        "when filling rows")
    p.add_argument("--flight_recorder", type=str, default="on",
                   choices=["on", "off"],
                   help="ring of the last --recorder_window steps' batches, "
                        "dropout seeds and metric records; dumps a repro "
                        "bundle under <output_dir>/repro_bundles on a "
                        "non-finite step, a watchdog trip or a crash "
                        "(bert_pytorch_tpu_torch/tools/replay.py replays "
                        "it)")
    p.add_argument("--recorder_window", type=int, default=8,
                   help="steps the flight recorder holds (host memory: "
                        "window x batch bytes); a replay needs a "
                        "checkpoint at most this many steps back")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="host batches assembled ahead on a thread")
    p.add_argument("--h2d_prefetch", type=int, default=1,
                   help="batches staged on the card ahead of the step that "
                        "reads them (data/sharded.DevicePrefetcher): the "
                        "next batch is pulled and copied from pinned memory "
                        "on a side CUDA stream while the card runs this "
                        "step; 0 copies each batch synchronously before its "
                        "step")
    p.add_argument("--tensorboard", type=str, default="on",
                   choices=["on", "off"],
                   help="TensorBoard sink (<output_dir>/<log_prefix>_tb, "
                        "torch.utils.tensorboard); off without the "
                        "tensorboard package, which the log says")
    p.add_argument("--stream_dir", default=None, type=str,
                   help="stream mode: a directory (or glob) of raw .txt "
                        "corpus files (blank-line-separated documents) "
                        "tokenized on the fly by a thread pool "
                        "(data/streaming.py), instead of --input_dir's "
                        "shards; resumes bit-identically, masks included")
    p.add_argument("--stream_vocab", default=None, type=str,
                   help="the streaming tokenizer's vocab (default: the "
                        "model config's vocab_file)")
    p.add_argument("--stream_tokenizer", default="wordpiece", type=str,
                   choices=["wordpiece", "bpe"],
                   help="tokenizer family in stream mode (bpe: a .json "
                        "vocab with merges.txt beside it)")
    p.add_argument("--stream_seq_len", default=128, type=int,
                   help="example length in stream mode ([CLS] + "
                        "stream_seq_len - 2 tokens + [SEP])")
    p.add_argument("--stream_workers", default=2, type=int,
                   help="tokenize threads; consumed in submission order, "
                        "so the count changes pacing only")
    p.add_argument("--stream_queue_batches", default=4, type=int,
                   help="bound of the example queue, in batches "
                        "(bert_stream_queue_depth)")
    p.add_argument("--stream_inject", default=None, type=str,
                   choices=["slow_producer", "corrupt_record",
                            "worker_crash"],
                   help="streaming fault drill: slow_producer sleeps in "
                        "the workers (data_wait), corrupt_record drops "
                        "every 7th owned record "
                        "(bert_stream_records_dropped_total), worker_crash "
                        "kills a tokenize task once per 5th record (re-run "
                        "with its cursor intact)")
    p.add_argument("--steps_per_loop", type=int, default=1,
                   help="optimization steps a host dispatch: >1 stages that "
                        "many batches with a leading (N, ...) axis and runs "
                        "the N steps back to back, reading the metrics once "
                        "a chunk (the last step's, the health flags "
                        "max-accumulated over the chunk); each inner step "
                        "draws its own global step's dropout seeds, so the "
                        "run is bit-equal to N=1")
    p.add_argument("--profile_steps", type=str, default=None,
                   help="'lo,hi': a torch.profiler trace (CPU and CUDA) "
                        "from before step lo+1's dispatch to after step "
                        "hi's readback (with --steps_per_loop, the chunks "
                        "that hold those steps, whole), written under "
                        "<output_dir>/traces/ "
                        "(the host phases as host/<phase> ranges) and "
                        "summarized in the log "
                        "(bert_pytorch_tpu_torch.tools.trace_summary)")
    p.add_argument("--kfac", action="store_true", default=False,
                   help="K-FAC preconditioning before LAMB (optim/kfac.py: "
                        "the four Linears of every layer, the pooler and "
                        "the NSP head)")
    p.add_argument("--kfac_inv_interval", type=int, default=10,
                   help="steps between inversions of the factors")
    p.add_argument("--kfac_factor_interval", type=int, default=1,
                   help="steps between updates of the factors' EMA")
    p.add_argument("--kfac_stat_decay", type=float, default=0.95,
                   help="the factors' EMA decay")
    p.add_argument("--kfac_damping", type=float, default=0.003,
                   help="Tikhonov damping, factored between A and G")
    p.add_argument("--kfac_kl_clip", type=float, default=0.001,
                   help="kl_clip: the preconditioned step's scale bound")
    p.add_argument("--kfac_stats_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="dtype of a step's factor statistics (the EMA "
                        "stays f32)")
    p.add_argument("--kfac_skip_layers", nargs="+", type=str,
                   default=["cls_predictions", "embeddings"],
                   help="sites whose name holds one of these keep their "
                        "first-order gradients")
    p.add_argument("--kfac_factor_sync_freq", type=int, default=1,
                   help="update the factors only every N steps (N > 1)")
    p.add_argument("--log_freq", type=int, default=10,
                   help="optimization steps per StepWatch 'perf' record")
    p.add_argument("--health_pack", type=str, default="on",
                   choices=["on", "off"],
                   help="non-finite counts of the loss and the gradients, "
                        "the grad-norm EMA and spike z-score, the param "
                        "norm and its drift")
    p.add_argument("--nonfinite_action", type=str, default="log",
                   choices=["log", "skip", "halt"],
                   help="on a non-finite step: 'log' warns and trains on, "
                        "'skip' drops the update, 'halt' stops the run "
                        "(exit 71)")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve /metrics and /healthz on this port while "
                        "the run lives (0: an ephemeral port, logged)")
    p.add_argument("--inject_nonfinite_step", type=int, default=None,
                   help="fault drill: a NaN in layer 0's attention output "
                        "weight at exactly this global step")
    p.add_argument("--watchdog_timeout", type=float, default=0.0,
                   help="hung-step watchdog: a host phase longer than this "
                        "many seconds dumps every thread's stack and acts "
                        "per --watchdog_action (0: off)")
    p.add_argument("--watchdog_action", type=str, default="abort",
                   choices=["abort", "warn"],
                   help="on a watchdog trip: 'abort' exits 72 (device "
                        "side) or 73 (data_wait); 'warn' logs once a stall")
    p.add_argument("--chaos", type=str, default=None,
                   choices=["sigkill_at_step", "sigterm_at_step",
                            "corrupt_newest_ckpt", "stall_dispatch"],
                   help="fault drill at --chaos_step (resilience/chaos.py); "
                        "fires only in the first supervised incarnation")
    p.add_argument("--chaos_step", type=int, default=None,
                   help="global step the --chaos fault fires at")
    p.add_argument("--chaos_stall_secs", type=float, default=3.0,
                   help="stall length of --chaos stall_dispatch")
    p.add_argument("--slo_config", type=str, default=None,
                   help="SLO spec file (configs/slo.json): evaluate its "
                        "train specs (step time, checkpoint freshness, "
                        "non-finite rate) while the run lives")
    p.add_argument("--slo_eval_interval_s", type=float, default=5.0,
                   help="burn-rate engine evaluation period")
    p.add_argument("--slo_action", type=str, default="log",
                   choices=["log", "halt"],
                   help="on a sustained page-severity train SLO breach: "
                        "'log' goes on, 'halt' exits 76 (retryable)")
    p.add_argument("--slo_halt_after_s", type=float, default=60.0,
                   help="how long a page alert fires before --slo_action "
                        "halt stops the run")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    _declare_parallel(p)
    # the JAX flags whose features the port lacks (_REFUSED, _TUNING)
    _declare_refused(p)
    args = merge_args_with_config(p, argv)
    validate_stream_args(p, args, argv)
    # a run config's value of a declared flag bypasses argparse's choices
    # (--optimizer bert_adam is a JAX choice the port lacks)
    for action in p._actions:  # noqa: SLF001
        value = getattr(args, action.dest, None)
        if value is None and action.default is None:
            continue
        if action.choices is not None and value not in action.choices:
            raise NotImplementedError(
                f"{action.dest}={value!r} is not ported yet (choices "
                f"{list(action.choices)}; see {_ROADMAP})")
    if args.chaos and args.chaos_step is None:
        p.error("--chaos requires --chaos_step (the global step the fault "
                "fires at)")
    if args.profile_steps is not None:
        try:
            parse_profile_steps(args.profile_steps)
        except ValueError as e:
            p.error(str(e))
    return args


def parse_profile_steps(spec: str):
    """--profile_steps 'lo,hi' -> (lo, hi), 0 <= lo < hi; ValueError
    otherwise."""
    try:
        lo, hi = (int(x) for x in str(spec).split(","))
    except ValueError:
        raise ValueError(f"--profile_steps {spec!r}: want 'lo,hi' (two "
                         "step numbers)") from None
    if not 0 <= lo < hi:
        raise ValueError(f"--profile_steps {spec!r}: want 0 <= lo < hi")
    return lo, hi


def validate_stream_args(parser, args, argv=None) -> None:
    """The two data planes' flags conflict at parse time (JAX's
    validate_stream_args): --stream_dir with --input_dir, unless one of
    them comes from the command line and the other from the run config
    (the command line wins); and a stream flag given on the command line
    without --stream_dir. A run config may carry either plane's keys."""
    from bert_pytorch_tpu_torch.config import explicit_cli_keys

    explicit = None

    def cli(flag: str) -> bool:
        nonlocal explicit
        if explicit is None:
            explicit = explicit_cli_keys(parser, argv)
        return flag in explicit

    if args.stream_dir and args.input_dir:
        if cli("stream_dir") and not cli("input_dir"):
            args.input_dir = None
        elif cli("input_dir") and not cli("stream_dir"):
            args.stream_dir = None
        else:
            parser.error(
                "--stream_dir (streaming plane) and --input_dir (offline "
                "sharded-HDF5 plane) are mutually exclusive — pick one "
                "data plane per run")
    if not args.stream_dir:
        stray = [f for f in _STREAM_DEPENDENT_FLAGS if cli(f)]
        if stray:
            parser.error(
                "--" + " --".join(sorted(stray)) + " require --stream_dir "
                "(they configure the streaming plane; --input_dir reads "
                "offline shards and ignores them)")


def find_mask_token_index(args, config) -> int:
    """--mask_token_index, else [MASK] (or <mask>) of the vocab file when
    it exists, else 103, the standard BERT id. The vocab is
    --stream_vocab in stream mode (only there), else the config's
    vocab_file."""
    if args.mask_token_index is not None:
        return args.mask_token_index
    stream_vocab = (getattr(args, "stream_vocab", None)
                    if getattr(args, "stream_dir", None) else None)
    vocab_file = stream_vocab or getattr(config, "vocab_file", None)
    if vocab_file and os.path.exists(vocab_file):
        from bert_pytorch_tpu_torch.data.tokenization import load_vocab

        vocab = load_vocab(vocab_file)
        if "[MASK]" in vocab:
            return vocab["[MASK]"]
        if "<mask>" in vocab:
            return vocab["<mask>"]
    return 103


class NonFiniteHalt(RuntimeError):
    """--nonfinite_action=halt tripped on a non-finite loss or gradient.
    `_cli` exits EXIT_NONFINITE_HALT (71), which the supervisor does not
    retry."""


class SLOBreachHalt(RuntimeError):
    """--slo_action=halt: a page-severity train SLO fired for longer than
    --slo_halt_after_s. `_cli` exits EXIT_SLO_BREACH (76), retryable."""


@dataclasses.dataclass
class PretrainResult:
    """What a run did: its last global step, the train state it ends with,
    the step it resumed from (None: a fresh start), the checkpoints it
    saved ({"step", "bytes", "seconds"} each), its metrics registry's
    snapshot as the run ended and, with --profile_steps, the trace."""
    step: int
    train_time_s: float
    accum_steps: int
    seqs_per_step: int
    history: List[Dict]
    state: object = None
    resumed_from: Optional[int] = None
    restore_s: Optional[float] = None
    saves: List[Dict] = dataclasses.field(default_factory=list)
    metrics: Dict = dataclasses.field(default_factory=dict)
    # --profile_steps: {"trace_file", "steps", "summary"} of the trace
    profile: Optional[Dict] = None
    # the ranks, the mesh, the ZeRO-1 arms and layout, the collectives
    parallel: Optional[Dict] = None


def _unsupported(args) -> None:
    """Refuse a key of `_REFUSED` (or `_REFUSED_PARALLEL`) whose value
    switches its feature on, and a --mesh with an axis other than data
    above 1."""
    from bert_pytorch_tpu_torch import PARALLEL_GAPS, refuse
    from bert_pytorch_tpu_torch.parallel.mesh import parse_mesh_arg

    refuse(args, _REFUSED, _ROADMAP, hints=_HINTS)
    refuse(args, _REFUSED_PARALLEL, PARALLEL_GAPS)
    shape = parse_mesh_arg(getattr(args, "mesh", "")) or {}
    if any(n > 1 for a, n in shape.items() if a != "data"):
        raise NotImplementedError(
            f"mesh={args.mesh!r} is not ported yet (see {PARALLEL_GAPS}): "
            "the port implements the data axis alone")


def _config_echo(args) -> Dict:
    return {k: v for k, v in sorted(vars(args).items())
            if isinstance(v, (str, int, float, bool)) or v is None}


def main(argv=None, log: Callable[[str], None] = print) -> PretrainResult:
    args = parse_arguments(argv)
    if not (args.input_dir or args.stream_dir) or not args.output_dir:
        raise SystemExit("--input_dir (or --stream_dir) and --output_dir "
                         "are required")
    if args.stream_dir:
        return train(args, None, log)
    from bert_pytorch_tpu_torch.data.sharded import ShardIndex

    files = sorted(str(p) for p in Path(args.input_dir).rglob("*.hdf5"))
    if not files:
        raise SystemExit(f"no .hdf5 shards under {args.input_dir}")
    return train(args, ShardIndex(files), log)


def _stream_loader(args, config, batch_size: int, registry, log):
    """--stream_dir's loader (data/streaming.py) and its [MASK] id: this
    rank's records of the corpus's sorted .txt sources, tokenized by --stream_tokenizer over
    --stream_vocab (else the model config's vocab_file); the tokenizer's
    [MASK] / <mask> id unless --mask_token_index is given (a BPE .json
    vocab's <mask> is invisible to the line-based lookup)."""
    from bert_pytorch_tpu_torch.data.streaming import (
        StreamingPretrainingLoader, discover_sources, resolve_mask_id)
    from bert_pytorch_tpu_torch.data.tokenization import TOKENIZERS
    from bert_pytorch_tpu_torch.parallel import dist

    sources = discover_sources(args.stream_dir)
    if not sources:
        raise SystemExit(f"no .txt corpus under {args.stream_dir}")
    vocab_path = args.stream_vocab or getattr(config, "vocab_file", None)
    if not vocab_path or not os.path.exists(vocab_path):
        raise SystemExit("stream mode needs a tokenizer vocab: pass "
                         "--stream_vocab or set vocab_file in the model "
                         "config")
    tokenizer = TOKENIZERS[args.stream_tokenizer](vocab_path)
    mask_id = find_mask_token_index(args, config)
    tokenizer_mask = resolve_mask_id(tokenizer)
    if args.mask_token_index is None and tokenizer_mask is not None:
        mask_id = tokenizer_mask
    loader = StreamingPretrainingLoader(
        sources, tokenizer, batch_size=batch_size,
        seq_len=args.stream_seq_len, mask_token_index=mask_id,
        max_pred_per_seq=args.max_predictions_per_seq,
        masked_lm_prob=args.masked_token_fraction,
        vocab_size=config.vocab_size, seed=args.seed,
        world_size=dist.get_world_size(), rank=dist.get_rank(),
        num_workers=args.stream_workers,
        queue_batches=args.stream_queue_batches,
        prefetch_batches=max(0, args.prefetch_batches),
        packing=args.packing,
        packing_max_segments=args.packing_max_segments,
        packing_lookahead=args.packing_lookahead,
        registry=registry, inject=args.stream_inject)
    log(f"dataset: STREAMING {len(sources)} raw-text sources (hash "
        f"{loader.sources_hash}), {args.stream_workers} tokenize workers "
        f"({args.stream_tokenizer}), seq {args.stream_seq_len}, step batch "
        f"{batch_size}; [MASK]={mask_id}"
        + (f"; FAULT INJECTION: {args.stream_inject}"
           if args.stream_inject else ""))
    return loader, mask_id


def train(args: argparse.Namespace, index,
          log: Callable[[str], None] = print,
          batch_tap: Optional[Callable[[Dict], None]] = None
          ) -> PretrainResult:
    """The run behind `main`, over an already opened shard index (a
    `data.sharded.ShardIndex`, or an object with its interface that holds
    the same arrays in memory), or with --stream_dir over its corpus
    (`index` None). `batch_tap`, given, sees each host batch a step
    reads, in dispatch order (after the flight recorder's tap). Over
    several ranks (torchrun's environment, or a process group the caller
    made) this is one rank's part of the run."""
    if not args.output_dir:
        raise SystemExit("--output_dir is required")
    if not args.model_config_file:
        raise SystemExit("--model_config_file (or run config) required")
    _unsupported(args)

    from bert_pytorch_tpu_torch import resolve_device
    from bert_pytorch_tpu_torch.parallel import dist

    device = resolve_device(args.device)
    # torchrun's environment makes this rank's group (NCCL on cards, gloo
    # on the CPU); a group the caller made is kept and left open
    owned_group = not dist.is_initialized() and dist.initialize(args.device)
    try:
        return _train(args, index, log, batch_tap, device)
    finally:
        if owned_group:
            dist.shutdown()


def _train(args, index, log, batch_tap, device) -> "PretrainResult":
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights,
                                                    set_dropout_shard)
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.parallel import dist
    from bert_pytorch_tpu_torch.resilience.chaos import ChaosMonkey
    from bert_pytorch_tpu_torch.resilience.preemption import (
        PreemptionGuard, emergency_save, is_preemption_exit)
    from bert_pytorch_tpu_torch.resilience.watchdog import arm_watchdog
    from bert_pytorch_tpu_torch.telemetry.flight_recorder import (
        FlightRecorder, per_host_dir)
    from bert_pytorch_tpu_torch.telemetry.health import (
        HealthConfig, init_telemetry_state)
    from bert_pytorch_tpu_torch.telemetry.provenance import \
        collect_provenance
    from bert_pytorch_tpu_torch.telemetry.run import init_run
    from bert_pytorch_tpu_torch.telemetry.stepwatch import (
        flops_per_seq, lookup_peak_flops)
    from bert_pytorch_tpu_torch.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu_torch.training.finetune import \
        load_pretrained_params
    from bert_pytorch_tpu_torch.telemetry.memory import \
        device_memory_snapshot
    from bert_pytorch_tpu_torch.training.pretrain import (
        build_kfac_pretrain_step, build_pretrain_step, chain_steps,
        init_kfac_state)
    from bert_pytorch_tpu_torch.training.state import make_train_state

    import numpy as np

    par = _parallel_plan(args, device)
    world, rank = par.world, par.rank
    if rank:
        # rank 0 alone logs and writes the sinks and the checkpoints
        log = _quiet
    if device.type == "cuda":
        device = dist.local_device("cuda")
        torch.cuda.set_device(device)
    # the tied decoder's f32 logits need full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    health = (HealthConfig(action=args.nonfinite_action)
              if args.health_pack == "on" else None)
    if health is None and args.nonfinite_action != "log":
        raise SystemExit(f"--nonfinite_action={args.nonfinite_action} "
                         "requires --health_pack=on")

    try:
        profile_range = (parse_profile_steps(args.profile_steps)
                         if args.profile_steps is not None else None)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    n_loop = max(1, args.steps_per_loop)

    # the accumulation math of the JAX entry point: the global batch is
    # accum_steps microbatches of local_batch_size rows a data shard (a
    # rank); step_batch is this rank's rows a step
    micro = args.local_batch_size
    micro_global = micro * par.data_shards
    accum_steps = max(1, math.ceil(args.global_batch_size / micro_global))
    step_batch = accum_steps * micro
    global_step_batch = accum_steps * micro_global

    config = BertConfig.from_json_file(args.model_config_file)
    config = config.replace(
        vocab_size=pad_vocab_size(config.vocab_size,
                                  args.vocab_pad_multiple),
        checkpoint_activations=args.checkpoint_activations,
        kfac_taps=args.kfac)
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    grad_name = args.dtype if args.grad_dtype == "auto" else args.grad_dtype
    grad_dtype = torch.bfloat16 if grad_name == "bfloat16" else None

    os.makedirs(args.output_dir, exist_ok=True)
    if not args.skip_checkpoint and args.num_steps_per_checkpoint < 1:
        raise SystemExit("--num_steps_per_checkpoint must be >= 1")
    manager = CheckpointManager(
        os.path.join(args.output_dir, "pretrain_ckpts"),
        max_to_keep=args.keep_checkpoints, log=log)
    # one telemetry wiring path: the logger's sinks, the registry and the
    # /metrics + /healthz exporter; everything below is closed in the
    # finally, on the success and the exception paths
    main_rank = rank == 0
    tel = init_run("pretrain",
                   log_prefix=(os.path.join(args.output_dir, args.log_prefix)
                               if main_rank else None),
                   echo=log,
                   metrics_port=args.metrics_port if main_rank else None,
                   tensorboard=args.tensorboard == "on" and main_rank,
                   multihost_dir=(os.path.join(args.output_dir,
                                               "metrics_hosts")
                                  if world > 1 else None),
                   process_index=rank, process_count=world)
    if tel.logger.tensorboard_dir:
        log(f"tensorboard: scalars under {tel.logger.tensorboard_dir}")
    loader = guard = watchdog = slo_eval = recorder = profiler = dp = None
    # (step, loader state, epoch) of the last completed step, taken
    # inside the step's guard: the loader's live cursor may already cover
    # the next batch when a signal lands, and resuming from it would skip
    # that batch
    survival: Dict = {}
    try:
        prov = collect_provenance(device)
        tel.log_header(**prov)
        log(f"parallel: {world} rank(s), mesh={par.mesh.shape} "
            f"mesh_config={par.mesh_config} zero1={par.zero1} "
            f"zero1_overlap={par.zero1_overlap} zero1_rs={par.zero1_rs} "
            f"coalesce_reductions={'on' if par.coalesce else 'off'}"
            + (f" backend={dist.backend()}" if dist.is_initialized()
               else ""))
        for note in par.notes:
            log(note)
        if args.stream_dir:
            loader, mask_id = _stream_loader(args, config, step_batch,
                                             tel.registry, log)
            # /healthz carries the plane's live cursor
            tel.attach_stream(loader)
            seq_len = args.stream_seq_len
            data_desc = (f"stream_sources={len(loader.sources)} "
                         f"seq={seq_len}")
            # one batch peeked to prove the corpus fills a step, then the
            # stream rewound through its own initial state (batches the
            # assembly prefetch ran ahead are dropped, not replayed)
            try:
                next(loader)
            except StopIteration:
                raise SystemExit(f"the corpus under {args.stream_dir} "
                                 "holds fewer than one step's batch "
                                 f"({step_batch} examples)") from None
            loader.load_state_dict(loader.initial_state())
        else:
            mask_id = find_mask_token_index(args, config)
            # each rank reads its contiguous part of the index and
            # masks with seed + rank (the JAX entry point's split)
            loader = PretrainingDataLoader(
                index, HostShardSampler(len(index), world_size=world,
                                        rank=rank, seed=args.seed),
                batch_size=step_batch, mask_token_index=mask_id,
                max_pred_per_seq=args.max_predictions_per_seq,
                masked_lm_prob=args.masked_token_fraction,
                vocab_size=config.vocab_size, seed=args.seed + rank,
                prefetch_batches=max(0, args.prefetch_batches),
                packing=args.packing,
                packing_max_segments=args.packing_max_segments,
                packing_lookahead=args.packing_lookahead)
            if len(loader.sampler) < step_batch:
                raise SystemExit(f"the data holds fewer than one step's "
                                 f"batch ({step_batch} samples)")
            seq_len = index.seq_len()
            data_desc = f"shards={len(index.files)} samples={len(index)}"
        if device.type == "cuda":
            # build (or reuse) the kernels before the watchdog's phases
            # start: the first step's dispatch must not hold the build
            from bert_pytorch_tpu_torch.ops.kernels.build import \
                load_kernels

            load_kernels()
        with torch.device(device):
            model = BertForPreTraining(config, dtype=compute_dtype)
        init_weights(model, torch.Generator(device=device).manual_seed(
            args.seed), std=config.initializer_range)
        if world > 1:
            set_dropout_shard(model, rank)
        if world > 1 or par.zero1:
            from bert_pytorch_tpu_torch.parallel.zero import DataParallel

            dp = DataParallel(model, zero1=par.zero1,
                              reduce_scatter=par.zero1_rs,
                              gather_on_use=par.zero1_overlap,
                              coalesce=par.coalesce)
            log("parallel: " + ", ".join(
                f"{k}={v}" for k, v in dp.describe().items()))
            if par.zero1:
                tel.registry.gauge(
                    "bert_zero1_replicated_leaves",
                    "parameter tensors ZeRO-1 leaves whole on every rank "
                    "(the port's flat layout splits all of them)").set(
                        len(dp.replicated_leaves))
        schedule = make_schedule(args.lr_decay, args.learning_rate,
                                 args.max_steps,
                                 warmup=args.warmup_proportion,
                                 offset=args.previous_phase_end_step)
        tx = Lamb(schedule, weight_decay=0.01, fused=args.fused_optim)
        state = make_train_state(model, tx, dp=dp)
        max_pred_row = packed_prediction_budget(args, seq_len)
        kfac = None
        if args.kfac:
            kfac = _make_kfac(args)
            # the factors exist before any restore, which fills them
            init_kfac_state(model, kfac, state)
            step_fn = build_kfac_pretrain_step(
                model, tx, kfac, schedule=schedule, accum_steps=accum_steps,
                max_predictions=max_pred_row, grad_dtype=grad_dtype,
                health=health, nan_inject_step=args.inject_nonfinite_step)
        else:
            step_fn = build_pretrain_step(
                model, tx, schedule=schedule, accum_steps=accum_steps,
                max_predictions=max_pred_row,
                grad_dtype=grad_dtype, health=health,
                nan_inject_step=args.inject_nonfinite_step, dp=dp)
        log(f"device={device} accumulation_steps={accum_steps} "
            f"microbatch={micro} global_batch={global_step_batch} "
            f"rank_batch={step_batch} dtype={args.dtype} "
            f"grad_dtype={grad_name} vocab={config.vocab_size} "
            f"layers={config.num_hidden_layers} {data_desc} "
            f"[MASK]={mask_id} "
            f"fused_optim={args.fused_optim}"
            + (f"; packing on (<= {args.packing_max_segments} segments/row)"
               if args.packing else "")
            + (f"; checkpoint_activations on (remat_policy="
               f"{config.remat_policy})" if config.checkpoint_activations
               else ""))
        if args.packing:
            log(f"packing: gathered MLM head scores up to {max_pred_row} "
                f"positions/row (per-example cap "
                f"{args.max_predictions_per_seq})")
        if kfac is not None:
            from bert_pytorch_tpu_torch.optim.kfac import describe

            # stands in for the JAX loop's bucket-assignment line: one
            # card reduces nothing
            log(describe(state.precond_state, kfac.config,
                         skipped=[s for s in state.precond_state.factors
                                  if kfac.skipped(s)]))
        resumed_from = restore_s = None
        t0 = time.perf_counter()
        restored = _restore(manager, device, world, rank)
        if restored is not None:
            sd, extra, resumed_from = restored
            state.load_state_dict(sd)
            del sd, restored
            extra = _rank_cursor(extra, world, rank)
            if "sampler" in extra:
                saved_stream = (isinstance(extra["sampler"], dict)
                                and "stream" in extra["sampler"])
                if saved_stream != bool(args.stream_dir):
                    # the cursor indexes the other plane's data: the
                    # loader refuses it (and warns); the data restarts
                    log("WARNING: the checkpoint's data cursor is the "
                        + ("streaming" if saved_stream else "offline")
                        + " plane's and this run reads the "
                        + ("streaming" if args.stream_dir else "offline")
                        + " plane: not restored, the data starts from "
                        "the beginning")
                loader.load_state_dict(extra["sampler"])
            restore_s = time.perf_counter() - t0
            log(f"auto-resumed from step {resumed_from} "
                f"({restore_s:.1f} s)")
        elif args.init_checkpoint:
            load_pretrained_params(args.init_checkpoint, state.params,
                                   log=log)
        if health is not None:
            # attached after the restore and never saved: a checkpoint's
            # structure is the same with the pack on or off
            state.telemetry = init_telemetry_state(device)
        tel.attach_checkpoints(manager)

        peak = (lookup_peak_flops(torch.cuda.get_device_name(device),
                                  dtype=args.dtype)
                if device.type == "cuda" else None)
        step_flops = flops_per_seq(config, seq_len, config.vocab_size,
                                   args.max_predictions_per_seq) * step_batch
        sw = tel.make_stepwatch(
            flops_per_step=step_flops, seqs_per_step=step_batch,
            seq_len=seq_len, peak_flops=peak, log_freq=args.log_freq,
            sync=((lambda: torch.cuda.synchronize(device))
                  if device.type == "cuda" else None))
        log(f"telemetry: {step_flops / 1e9:.2f} GFLOP/step, peak "
            f"{(peak or 0) / 1e12:.0f} TFLOP/s, health_pack="
            f"{args.health_pack} nonfinite_action={args.nonfinite_action} "
            f"log_freq={args.log_freq}")

        n_sites = 1 + 3 * config.num_hidden_layers
        if args.flight_recorder == "on":
            # the ring holds two chunks: a flagged chunk is dumped after
            # the next dispatch's record at the latest (JAX's clamp)
            window = max(args.recorder_window, 2 * n_loop)
            if window > args.recorder_window:
                log(f"flight recorder: window raised {args.recorder_window}"
                    f" -> {window} (2x --steps_per_loop)")
            recorder = FlightRecorder(
                per_host_dir(os.path.join(args.output_dir, "repro_bundles")),
                window=window,
                run_info=_recorder_run_info(args, accum_steps, max_pred_row,
                                            grad_name, seq_len, n_loop, par),
                model_config=config.to_dict(),
                checkpoint_dir=manager.directory,
                provenance=prov,
                checkpoint_step_fn=manager.latest_step)
            tel.attach_recorder(recorder)
            if args.stream_dir:
                # the bundle's `stream`: the source list, the cursor and
                # the recent batches' record windows at dump time
                recorder.stream_info_fn = loader.stream_info
            recorder.install_crash_handlers()
            recorder.arm()
            log(f"flight recorder: on, window={recorder.window} steps, "
                f"bundles under {recorder.out_dir}")
        # the guard layers over the recorder's handlers: SIGTERM walks
        # guard -> recorder -> SystemExit(143), and the except-path below
        # dumps the bundle and the emergency checkpoint
        guard = PreemptionGuard(log=log, agree=(dist.agree_any if world > 1
                                                else None))
        guard.install()
        watchdog = arm_watchdog(args.watchdog_timeout, args.watchdog_action,
                                sw, registry=tel.registry, log=log,
                                out_dir=args.output_dir, recorder=recorder)
        chaos = None
        if args.chaos:
            chaos = ChaosMonkey(args.chaos, args.chaos_step,
                                stall_secs=args.chaos_stall_secs, log=log)
            if chaos.mode:
                log(f"CHAOS armed: {chaos.mode} at step {chaos.at_step}")
        slo_engine = None
        if args.slo_config:
            slo_engine, slo_eval = _train_slo(args, tel, manager, log)

        target = args.previous_phase_end_step + args.max_steps
        limit = min(target, state.step + args.steps
                    if args.steps is not None else target)
        history: List[Dict] = []
        saves: List[Dict] = []
        saved_steps: List[int] = []     # every rank's: the saves it joined
        comm_mark = dist.stats_total()
        loss_sum, loss_n = 0.0, 0
        warned_dropped = False

        # batches reach the card through the prefetcher (one an epoch):
        # its state_dict() is the loader's as of the batch the last step
        # read, and its tap hands the recorder batches in dispatch order
        taps = [t for t in (recorder.capture_batch if recorder is not None
                            else None, batch_tap) if t is not None]

        def tap(b):
            for t in taps:
                t(b)

        make_prefetcher = _prefetcher_factory(
            args, loader, sw, device, accum_steps, micro,
            tap if taps else None, log, n_loop)
        pf = make_prefetcher()

        def pull():
            """The next (host batch, device batch or None); a new epoch
            when one ends."""
            nonlocal pf
            while True:
                try:
                    return next(pf)
                except StopIteration:
                    loader.reset_epoch()
                    pf = make_prefetcher()

        def save():
            # every rank joins: under ZeRO-1 state_dict() gathers the
            # moments and the masters; rank 0 writes the one-card format
            sd = state.state_dict()
            extra = _cursor_extra(pf.state_dict(), world)
            saved_steps.append(state.step)
            if not main_rank:
                return
            rec = manager.save(state.step, sd, extra=dict(
                extra, epoch=loader.epoch, config=_config_echo(args)))
            saves.append(dict(rec, step=state.step))
            log(f"checkpoint: step {state.step} saved ({rec['bytes'] / 1e9:.3f}"
                f" GB in {rec['seconds']:.1f} s)")

        if profile_range is not None:
            profiler = _StepProfiler(profile_range, args.output_dir, device,
                                     log)
        train_start = time.perf_counter()
        # the loop pulls a batch only for a step it takes; with
        # --steps_per_loop N it takes N steps a dispatch while N are left,
        # then single steps (JAX's `remaining` rule)
        while state.step < limit:
            if slo_engine is not None and args.slo_action == "halt":
                _check_slo_halt(slo_engine, args, state.step)
            remaining = limit - state.step
            n = n_loop if remaining >= n_loop else 1
            pairs = [pull() for _ in range(n)]
            batch_np = pairs[-1][0]
            if chaos is not None:
                chaos.before_dispatch(state.step + 1)
            if profiler is not None:
                profiler.before_dispatch(state.step, n)
            t0 = time.perf_counter()
            with sw.phase("data_prep"):
                seeds = [dropout_seeds(args.seed, state.step + 1 + i,
                                       accum_steps, n_sites)
                         for i in range(n)]
                real_tokens = 0.0
                for b, _ in pairs:
                    real = b.get("segment_ids", b["attention_mask"])
                    real_tokens += float((real > 0).sum())
            if n_loop > 1:
                # the chunk staged with a leading (n, ...) axis, one copy
                with sw.phase("data_prep"):
                    chunk_np = {k: np.stack([b[k].reshape(
                        accum_steps, micro, *b[k].shape[1:])
                        for b, _ in pairs]) for k in batch_np}
                with sw.phase("h2d"):
                    batch = {k: torch.from_numpy(v).to(device)
                             for k, v in chunk_np.items()}
                del chunk_np
                seeds = torch.stack(seeds)
                run_step = chain_steps(step_fn, n)
            else:
                batch, seeds = pairs[0][1], seeds[0]
                run_step = step_fn
            del pairs
            # a signal inside the guard is raised when the step, its
            # record and the survival snapshot are whole
            with guard.hold():
                with sw.phase("dispatch"):
                    if chaos is not None:
                        chaos.stall(state.step + 1)
                    metrics = run_step(state, batch, seeds)
                del batch
                if recorder is not None:
                    recorder.record_dispatch(state.step - n + 1, n,
                                             seeds.numpy())
                survival.update(step=state.step, sampler=pf.state_dict(),
                                epoch=loader.epoch)
                # the next batch's pull, stacking and copy while the card
                # runs this step (before the readback below waits for it)
                pf.fill()
                # reading the metrics waits for the card: the step time
                # below is the whole step (or chunk), host and device
                with sw.phase("metric_flush"):
                    vals = {k: (v.item() if torch.is_tensor(v) else v)
                            for k, v in metrics.items()}
                if recorder is not None:
                    recorder.note_metrics(state.step, vals)
                dt = (time.perf_counter() - t0) / n
                examples = int((batch_np["next_sentence_labels"] >= 0).sum())
                rec = dict(vals, step=state.step, step_ms=dt * 1e3,
                           seq_per_sec=global_step_batch / dt,
                           examples=examples)
                history.append(rec)
                loss = vals.pop("loss")
                bad = (vals.get("loss_nonfinite", 0) > 0
                       or vals.get("grad_nonfinite", 0) > 0)
                if math.isfinite(loss) and not bad:
                    loss_sum += loss
                    loss_n += 1
                log(f"step {state.step}: loss {loss:.4f} grad_norm "
                    f"{rec['grad_norm']:.4f} lr {rec['learning_rate']:.4e} "
                    f"step_ms {rec['step_ms']:.1f} seq/s "
                    f"{rec['seq_per_sec']:.1f} mlm_accuracy "
                    f"{rec['mlm_accuracy']:.4f}"
                    + (f" examples {examples}" if args.packing else ""))
                warned_dropped = _warn_step(args, state.step, loss, vals,
                                            bad, warned_dropped, log)
                tel.log_train(state.step, epoch=loader.epoch,
                              average_loss=loss_sum / max(loss_n, 1),
                              step_loss=loss, **vals)
            if profiler is not None:
                profiler.after_readback(state.step)
            bundle = None
            if bad and recorder is not None:
                # every action dumps: a log or skip run wants the repro of
                # what the health pack flagged too
                bundle = recorder.dump("nonfinite", trigger_step=state.step)
                log(f"flight recorder: repro bundle for step {state.step} "
                    f"dumped to {bundle} (replay: python -m "
                    "bert_pytorch_tpu_torch.tools.replay --bundle "
                    f"{bundle} --bisect)")
            if bad and args.nonfinite_action == "halt":
                raise NonFiniteHalt(
                    f"non-finite loss/gradients at step {state.step} and "
                    "--nonfinite_action=halt; last checkpoint is the "
                    "restart point"
                    + (f"; repro bundle: {bundle}" if bundle else ""))
            # counted with its step: a crash flush's interval holds the
            # tokens of the steps it counts
            sw.note_tokens(real_tokens)
            perf = sw.step_done(n)
            if perf is not None:
                perf.update(device_memory_snapshot(device))
                if dp is not None:
                    comm_mark = _collective_fields(perf, comm_mark)
                tel.log_perf(state.step, perf)
            # a chunk checkpoints at the boundary JAX's rule picks: the
            # chunk that crossed a multiple of num_steps_per_checkpoint
            if (not args.skip_checkpoint
                    and state.step % args.num_steps_per_checkpoint
                    < (n_loop if remaining >= n_loop else 1)):
                with sw.phase("checkpoint"):
                    save()
                if chaos is not None and main_rank:
                    chaos.after_checkpoint(manager.directory, state.step)
        train_time = time.perf_counter() - train_start
        if history and not args.skip_checkpoint and (
                not saved_steps or saved_steps[-1] != state.step):
            save()
        # every rank returns once the last checkpoint is on disk
        dist.barrier()
        if history:
            log(f"training_seq_per_sec = "
                f"{step_batch * len(history) / train_time:.2f} "
                f"({len(history)} steps in {train_time:.1f}s)")
        if profiler is not None:
            profiler.stop()
        if recorder is not None:
            recorder.disarm()   # a clean exit: the atexit backstop stands down
        return PretrainResult(step=state.step, train_time_s=train_time,
                              accum_steps=accum_steps,
                              seqs_per_step=step_batch, history=history,
                              state=state, resumed_from=resumed_from,
                              restore_s=restore_s, saves=saves,
                              metrics=tel.registry.snapshot(),
                              parallel=dict(
                                  par.describe(),
                                  **(dp.describe() if dp is not None
                                     else {}),
                                  norm_reductions=(dp.reducer.summary()
                                                   if dp is not None
                                                   else None),
                                  collectives={k: dict(v) for k, v in
                                               dist.STATS.items()}),
                              profile=(profiler.result if profiler
                                       is not None else None))
    except BaseException as exc:
        # the partial StepWatch interval and the black box land before the
        # unwind (the bundle before the emergency save, which may fail)
        try:
            rec = sw.flush()
            if rec is not None:
                rec.update(device_memory_snapshot(device))
                tel.log_perf(survival.get("step", 0), rec)
        except Exception:
            pass
        # the trace of the steps taken so far lands too (a halt, SIGTERM
        # or crash inside the profiled window)
        if profiler is not None:
            try:
                profiler.stop()
            except Exception as e:
                log(f"WARNING: profiler: the trace was not written: {e}")
        if recorder is not None and recorder.last_dump is None:
            try:
                path = recorder.dump(type(exc).__name__.lower(),
                                     trigger_step=survival.get("step", 0))
                log(f"flight recorder: crash bundle dumped to {path}")
            except Exception:
                pass
        # preemption: one synchronous save of the last completed step
        # (never after a halt: the last checkpoint stays the restart point)
        preempted = ((guard is not None
                      and guard.preempted_signal is not None)
                     or is_preemption_exit(exc))
        if preempted and not args.skip_checkpoint:
            if not survival:
                log("preemption: no step completed this session — nothing "
                    "to emergency-checkpoint")
            else:
                try:
                    t0 = time.perf_counter()
                    # collective over several ranks: every rank left at
                    # the same step (the guard's vote) and joins the
                    # gather; rank 0 writes
                    sd = state.state_dict()
                    extra = _cursor_extra(survival["sampler"], world)
                    if main_rank and emergency_save(
                            manager, survival["step"], sd, extra=dict(
                                extra, epoch=survival["epoch"],
                                config=_config_echo(args)), log=log):
                        log(f"preemption: emergency save of step "
                            f"{survival['step']} took "
                            f"{time.perf_counter() - t0:.2f} s")
                except Exception as e:
                    log(f"WARNING: emergency checkpoint failed: {e} (the "
                        "last periodic checkpoint is the restart point)")
        raise
    finally:
        # the guard closes before the recorder: it restores the recorder's
        # handlers, which the recorder then restores to the original
        for closeable in (profiler, slo_eval, watchdog, guard, recorder, tel,
                          loader, dp):
            if closeable is not None:
                try:
                    closeable.close()
                except Exception:
                    pass


def _quiet(_msg: str) -> None:
    """The log of a rank other than 0."""


@dataclasses.dataclass
class _Parallel:
    """The resolved data axis of a run (`_parallel_plan`)."""
    world: int
    rank: int
    mesh: object
    data_shards: int
    mesh_config: str
    zero1: bool
    zero1_overlap: bool
    zero1_rs: bool
    coalesce: bool
    notes: List[str]

    def describe(self) -> Dict:
        return {"world": self.world, "mesh": self.mesh.shape,
                "mesh_config": self.mesh_config, "zero1": self.zero1,
                "zero1_overlap": self.zero1_overlap,
                "zero1_rs": self.zero1_rs, "coalesce": self.coalesce}


def _parallel_plan(args, device) -> _Parallel:
    """--mesh over the ranks, and --mesh_config, --zero1, --zero1_overlap,
    --zero1_rs and --coalesce_reductions resolved as the JAX entry point
    resolves them (run_pretraining.py:684-728): `production` (picked by
    `auto` on a card when the data axis is above 1) turns on packing,
    ZeRO-1 and its gather-on-use; --zero1 auto is on when the data axis is
    above 1; --zero1_overlap and --zero1_rs need ZeRO-1 and --zero1_rs a
    data-only mesh, and forces --zero1_overlap. --kfac over several ranks
    or with ZeRO-1 is refused (PARALLEL_GAPS). May set args.packing,
    args.zero1."""
    from bert_pytorch_tpu_torch import PARALLEL_GAPS
    from bert_pytorch_tpu_torch.parallel import dist, mesh as mesh_lib
    from bert_pytorch_tpu_torch.parallel.zero import rs_supported

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = mesh_lib.make_mesh(mesh_lib.parse_mesh_arg(args.mesh), world)
    notes: List[str] = []
    production = (args.mesh_config == "production"
                  or (args.mesh_config == "auto" and device.type != "cpu"
                      and mesh_lib.production_qualifies(mesh)))
    name = (mesh_lib.PRODUCTION_CONFIG if production
            else mesh_lib.mesh_config(mesh))
    if production:
        feats = mesh_lib.production_features(mesh)
        if feats["packing"] and not args.packing:
            args.packing = True
        if feats["zero1"] and args.zero1 == "auto":
            args.zero1 = "true"
        if feats["zero1_overlap"] and args.zero1 != "false":
            args.zero1_overlap = True
        notes.append("mesh_config=production: " + " ".join(
            f"{k}={'on' if v else 'off'}" for k, v in sorted(feats.items())))
    zero1 = (args.zero1 == "true"
             or (args.zero1 == "auto" and mesh.data > 1))
    overlap = bool(args.zero1_overlap) and zero1
    if args.zero1_overlap and not zero1:
        notes.append("WARNING: --zero1_overlap ignored (--zero1 is off or "
                     "the data axis is trivial)")
    rs = bool(args.zero1_rs) and zero1
    if args.zero1_rs and not zero1:
        notes.append("WARNING: --zero1_rs ignored (--zero1 is off or the "
                     "data axis is trivial)")
    if rs:
        if not rs_supported(mesh):
            raise SystemExit(
                "--zero1_rs needs a data-only mesh with a data axis above "
                f"1; got {mesh.shape} — drop the flag or reshape the mesh")
        if not overlap:
            overlap = True
            notes.append("--zero1_rs forces --zero1_overlap (the "
                         "scattered gradient lands in the slice the update "
                         "owns; the masters rest as slices)")
    if args.kfac and (world > 1 or zero1):
        raise NotImplementedError(
            f"--kfac over several ranks or with ZeRO-1 is not ported yet "
            f"(see {PARALLEL_GAPS}); run it on one card with --zero1 false")
    return _Parallel(world, rank, mesh, mesh_lib.data_shard_count(mesh),
                     name, zero1, overlap, rs,
                     args.coalesce_reductions == "on", notes)


def _restore(manager, device, world: int, rank: int):
    """(state_dict, extra, step) of the newest checkpoint that verifies,
    or None without one. Over several ranks rank 0 walks the steps (and
    quarantines a corrupt one) and the others load the step it chose."""
    from bert_pytorch_tpu_torch.parallel import dist

    if world == 1:
        if manager.latest_step() is None:
            return None
        return manager.restore_with_fallback(map_location=device)
    got = err = None
    if rank == 0:
        try:
            if manager.latest_step() is not None:
                got = manager.restore_with_fallback(map_location=device)
        except Exception as e:      # every rank raises it, not rank 0 alone
            err = f"{type(e).__name__}: {e}"
    step, err = dist.broadcast_object(
        (None if got is None else got[2], err))
    if err is not None:
        raise RuntimeError(f"checkpoint restore failed on rank 0: {err}")
    if step is None:
        return None
    return got if rank == 0 else manager.restore(step, map_location=device)


def _cursor_extra(cursor, world: int) -> Dict:
    """A checkpoint's data cursors: "sampler", rank 0's (the one-card
    format: without packing every rank's is the same, the ranks moving in
    lockstep), and over several ranks "sampler_ranks", every rank's in
    rank order (a packed loader's pending examples are its own).
    Collective over several ranks."""
    from bert_pytorch_tpu_torch.parallel import dist

    if world == 1:
        return {"sampler": cursor}
    ranks = dist.all_gather_object(cursor)
    return {"sampler": ranks[0], "sampler_ranks": ranks}


def _rank_cursor(extra: Dict, world: int, rank: int) -> Dict:
    """A restored checkpoint's extra with this rank's cursor as
    "sampler": its own from "sampler_ranks" when the checkpoint was made
    by as many ranks, else rank 0's (which the loader refuses, with a
    warning, when the world differs)."""
    ranks = extra.get("sampler_ranks")
    if ranks is not None and len(ranks) == world:
        return dict(extra, sampler=ranks[rank])
    return extra


def _collective_fields(perf: Dict, mark: Dict) -> Dict:
    """Add this interval's collectives to a perf record (a step's average
    of the bytes, the calls and the host milliseconds spent in them);
    returns the new mark."""
    from bert_pytorch_tpu_torch.parallel import dist

    now = dist.stats_total()
    steps = max(1, int(perf.get("steps", 1)))
    perf["collective_bytes_per_step"] = (now["bytes"] - mark["bytes"]) / steps
    perf["collective_calls_per_step"] = (now["calls"] - mark["calls"]) / steps
    perf["collective_host_ms_per_step"] = round(
        (now["host_s"] - mark["host_s"]) * 1e3 / steps, 3)
    return now


def _prefetcher_factory(args, loader, sw, device, accum_steps: int,
                        micro: int, tap, log, n_loop: int = 1):
    """() -> a DevicePrefetcher over `loader` for one epoch
    (--h2d_prefetch batches staged ahead). The upstream pull is timed as
    `data_wait` (an empty stream queue shows there, which the watchdog
    reads as input starvation) and the put as `h2d`. On a card at depth
    >= 1 the put is `cuda_put`: pinned memory, then a non-blocking copy
    on a side stream, which the step's stream waits on; at depth 0 and on
    the CPU it is the synchronous copy. With --steps_per_loop > 1 the
    loop copies whole chunks itself: the prefetcher yields host batches
    alone (device batch None), at depth 0, as JAX's loop does."""
    from bert_pytorch_tpu_torch.data.sharded import (DevicePrefetcher,
                                                     cuda_put)

    depth = max(0, args.h2d_prefetch)
    if n_loop > 1:
        if depth:
            log("h2d prefetch: off (--steps_per_loop>1 stages whole "
                "chunks; the per-chunk put already amortizes)")
        return lambda: DevicePrefetcher(
            _timed_pulls(loader, sw), lambda b: None, depth=0,
            state_fn=loader.state_dict, batch_tap=tap)
    if depth and device.type == "cuda":
        copy = cuda_put(torch, accum_steps, micro, device,
                        torch.cuda.Stream(device))
    else:
        def copy(batch_np):
            return {k: torch.from_numpy(v.reshape(
                accum_steps, micro, *v.shape[1:])).to(device)
                for k, v in batch_np.items()}
    log(f"h2d prefetch: depth {depth}"
        + (" (the next batch staged on a side stream while the card runs "
           "the step)" if depth and device.type == "cuda" else
           " (the next batch pulled while the step runs)" if depth else
           " (each batch copied before its step)"))

    def put(batch_np):
        with sw.phase("h2d"):
            return copy(batch_np)

    return lambda: DevicePrefetcher(_timed_pulls(loader, sw), put,
                                    depth=depth, state_fn=loader.state_dict,
                                    batch_tap=tap)


def _timed_pulls(loader, sw):
    """One epoch of `loader`'s batches, each pull timed as `data_wait`."""
    it = iter(loader)
    while True:
        with sw.phase("data_wait"):
            try:
                b = next(it)
            except StopIteration:
                return
        yield b


class _StepProfiler:
    """--profile_steps lo,hi: a torch.profiler trace (CPU, and CUDA on a
    card) started before the first dispatch that takes a step of lo + 1
    .. hi (JAX's `lo <= global_step < hi` for single steps; a
    --steps_per_loop chunk that holds one is traced whole) and stopped
    after the readback of step hi or beyond; the Chrome trace goes to
    <output_dir>/traces/steps<first>-<last>.pt.trace.json and its summary
    (telemetry/trace.py) to the log and `result`. `stop()` is safe on
    every exit path."""

    def __init__(self, profile_range, output_dir: str, device, log):
        self.lo, self.hi = profile_range
        self.dir = os.path.join(output_dir, "traces")
        self.device = device
        self.log = log
        self._prof = None
        self._first = None
        self._last = None
        self.result: Optional[Dict] = None

    def before_dispatch(self, step_done: int, n: int = 1) -> None:
        """Before the dispatch of steps step_done + 1 .. step_done + n."""
        if self._prof is None and self.result is None \
                and step_done < self.hi and step_done + n > self.lo:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._first = step_done + 1

    def after_readback(self, step_done: int) -> None:
        self._last = step_done
        if self._prof is not None and step_done >= self.hi:
            self.stop()

    def stop(self) -> None:
        """Stop a running trace, write it and log its summary."""
        if self._prof is None:
            return
        from bert_pytorch_tpu_torch.telemetry.trace import (headline,
                                                            summarize_trace)

        prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        last = self._last if self._last is not None else self._first
        path = os.path.join(self.dir,
                            f"steps{self._first}-{last}.pt.trace.json")
        prof.export_chrome_trace(path)
        steps = max(1, last - self._first + 1)
        summary = summarize_trace(path, steps=steps)
        self.result = {"trace_file": path, "steps": [self._first, last],
                       "summary": summary}
        self.log(f"profile: steps {self._first}..{last} traced to {path}: "
                 + headline(summary))

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


def packed_prediction_budget(args, seq_len: int) -> int:
    """The gathered MLM head's positions a row. Unpacked: the per-example
    --max_predictions_per_seq. Packed, a row pools its segments' masks:
    each example adds at most min(cap, floor(len x fraction)) + 1 (the
    masker's floor of one), so a row holds at most floor(S x fraction) +
    segments, and at most segments x cap (JAX: run_pretraining.py's
    max_pred_row); mlm_dropped reports any excess."""
    if not args.packing:
        return args.max_predictions_per_seq
    return min(seq_len,
               args.packing_max_segments * args.max_predictions_per_seq,
               int(seq_len * args.masked_token_fraction)
               + args.packing_max_segments)


def _make_kfac(args):
    """The K-FAC preconditioner of the run's --kfac_* flags."""
    from bert_pytorch_tpu_torch.optim.kfac import KFAC, KFACConfig

    return KFAC(KFACConfig(
        inv_interval=args.kfac_inv_interval,
        factor_interval=args.kfac_factor_interval,
        stat_decay=args.kfac_stat_decay, damping=args.kfac_damping,
        kl_clip=args.kfac_kl_clip,
        skip_layers=tuple(args.kfac_skip_layers),
        stats_dtype=(torch.bfloat16 if args.kfac_stats_dtype == "bf16"
                     else torch.float32),
        factor_sync_freq=args.kfac_factor_sync_freq))


def kfac_run_info(args) -> Optional[Dict]:
    """The run block's `kfac` dict (JAX's keys; one card reduces nothing,
    so no bucket bytes or assignment), None without --kfac."""
    if not args.kfac:
        return None
    return {"inv_interval": args.kfac_inv_interval,
            "factor_interval": args.kfac_factor_interval,
            "stat_decay": args.kfac_stat_decay,
            "damping": args.kfac_damping, "kl_clip": args.kfac_kl_clip,
            "skip_layers": list(args.kfac_skip_layers),
            "factor_bucket_bytes": None,
            "factor_sync_freq": args.kfac_factor_sync_freq,
            "bucket_assignment": None,
            "stats_dtype": args.kfac_stats_dtype}


def _recorder_run_info(args, accum_steps: int, max_pred_row: int,
                       grad_name: str, seq_len: int, n_loop: int = 1,
                       par: Optional[_Parallel] = None) -> Dict:
    """The bundle manifest's run block: what tools/replay.py rebuilds the
    step from. The JAX run block's keys: a record's "rng" holds the step's
    int32 dropout seeds, drawn from numpy's PCG64 of (seed + 1000, step)
    (`rng_impl`), the same on every rank; the mesh and the ZeRO-1 arms of
    the run (`par`)."""
    return {
        "accum_steps": accum_steps, "steps_per_loop": n_loop,
        "seed": args.seed, "kfac": kfac_run_info(args),
        "max_pred_row": max_pred_row, "grad_dtype": grad_name,
        "dtype": args.dtype, "optimizer": args.optimizer,
        "learning_rate": args.learning_rate, "lr_decay": args.lr_decay,
        "warmup_proportion": args.warmup_proportion,
        "max_steps": args.max_steps,
        "previous_phase_end_step": args.previous_phase_end_step,
        "rng_impl": "pcg64_int32_seeds",
        "health_pack": args.health_pack,
        "nonfinite_action": args.nonfinite_action,
        "zero1": bool(par and par.zero1),
        "zero1_overlap": bool(par and par.zero1_overlap),
        "zero1_rs": bool(par and par.zero1_rs),
        "fused_optim": args.fused_optim,
        "mesh": par.mesh.shape if par is not None else {"data": 1},
        "seq_len": seq_len, "local_batch_size": args.local_batch_size,
        "global_batch_size": args.global_batch_size,
        "packing": args.packing,
        "packing_max_segments": args.packing_max_segments,
        "inject_nonfinite_step": args.inject_nonfinite_step,
        "stream": bool(args.stream_dir),
    }


def _train_slo(args, tel, manager, log):
    """The train SLO plane (JAX: run_pretraining.py's slo block): the
    burn-rate engine over configs/slo.json's `train` specs, reading the
    registry the loop feeds, with checkpoint_age_s from the manager's
    freshness; its verdict on /healthz. Returns (engine, evaluator)."""
    from bert_pytorch_tpu_torch.telemetry.slo import (SLOEngine,
                                                      SLOEvaluator,
                                                      load_slo_config)

    cfg = load_slo_config(args.slo_config)
    specs = cfg.specs_for("train")
    engine = SLOEngine(specs, cfg.windows, tel.registry, phase="train",
                       log=log)

    def checkpoint_age_s():
        _, landed = manager.freshness()
        if landed is None:
            return None     # nothing saved or restored yet: no sample
        return max(0.0, time.time() - float(landed))

    engine.set_source("checkpoint_age_s", checkpoint_age_s)
    tel.attach_slo(engine)
    evaluator = SLOEvaluator(engine,
                             interval_s=args.slo_eval_interval_s).start()
    log(f"slo: {len(specs)} train spec(s) from {args.slo_config}, "
        f"action={args.slo_action}"
        + (f" (halt after {args.slo_halt_after_s:g}s of page-severity "
           "firing)" if args.slo_action == "halt" else ""))
    return engine, evaluator


def _check_slo_halt(engine, args, step: int) -> None:
    """Raise SLOBreachHalt once a page alert has fired for
    --slo_halt_after_s."""
    since = engine.page_firing_since()
    if since is not None and time.time() - since >= args.slo_halt_after_s:
        firing = sorted({a["slo"] for a in engine.alerts_view()["firing"]})
        raise SLOBreachHalt(
            f"train SLO breach: page alert(s) {firing} firing for "
            f"{time.time() - since:.0f}s (>= --slo_halt_after_s "
            f"{args.slo_halt_after_s:g}) at step {step} — exiting "
            "EXIT_SLO_BREACH(76) for the supervisor to restart")


def _warn_step(args, step: int, loss: float, vals: Dict, bad: bool,
               warned_dropped: bool, log) -> bool:
    """The JAX loop's warnings of one step: masked positions beyond
    --max_predictions_per_seq (once), a non-finite step, a grad-norm
    spike. Returns whether the dropped-positions warning was given."""
    if vals.get("mlm_dropped", 0) > 0 and not warned_dropped:
        warned_dropped = True
        log(f"WARNING: step {step}: {int(vals['mlm_dropped'])} masked "
            "positions beyond --max_predictions_per_seq lost supervision — "
            "the data pipeline and step config disagree (raise "
            "--max_predictions_per_seq or lower --masked_token_fraction)")
    if bad:
        groups = ", ".join(
            f"{k.removeprefix('grad_nonfinite_')}={int(v)}"
            for k, v in sorted(vals.items())
            if k.startswith("grad_nonfinite_") and v > 0)
        handled = {"log": "training on (--nonfinite_action=log)",
                   "skip": "update was skipped",
                   "halt": "halting"}[args.nonfinite_action]
        log(f"WARNING: step {step}: NON-FINITE loss/gradients (step_loss="
            f"{loss}, nonfinite grads: {groups or 'none'}) — {handled}")
    elif vals.get("grad_spike", 0) > 0:
        log(f"WARNING: step {step}: gradient-norm spike (z="
            f"{vals.get('grad_norm_z', 0):.1f}, norm="
            f"{vals.get('grad_norm', 0):.3g} vs EMA "
            f"{vals.get('grad_norm_ema', 0):.3g})")
    return warned_dropped


def exit_code_of(run: Callable[[], object]) -> int:
    """Run `run()` under the script's exit-code contract: a NonFiniteHalt
    exits EXIT_NONFINITE_HALT (71) with a one-line FATAL instead of a
    traceback (the supervisor does not retry it: a restart replays the
    same blowup), an SLOBreachHalt EXIT_SLO_BREACH (76, retryable);
    everything else propagates (a traceback for a bug, 128 + signal for
    a signal). 0 when `run` returns."""
    from bert_pytorch_tpu_torch.resilience import (EXIT_NONFINITE_HALT,
                                                   EXIT_SLO_BREACH)

    try:
        run()
    except NonFiniteHalt as e:
        print(f"FATAL: {e}", file=sys.stderr)
        return EXIT_NONFINITE_HALT
    except SLOBreachHalt as e:
        print(f"FATAL: {e}", file=sys.stderr)
        return EXIT_SLO_BREACH
    return 0


def _cli(argv=None) -> int:
    """Script entry: `main` under the exit-code contract."""
    return exit_code_of(lambda: main(argv))


if __name__ == "__main__":
    sys.exit(_cli())
