#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (bert_pytorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --out DIR       # also write the results to DIR

Phases, each of which must pass:

1. device   the card's name and power limit (nvidia-smi) and the versions;
2. build    the CUDA kernels, from this checkout's sources, timed, and the
            flash forward's, fused flash backward's and backward pair's
            registers, spills and shared memory as compiled (a spill in
            the forward or the pair fails); beside the build, nvcc
            compiles those three sources and layernorm.cu alone for
            ptxas's report: a wgmma serialization note (C75xx) fails, and
            so does a spill of the LayerNorm backward's row kernel or of
            the pair's kernels, whose registers it lists; and g++
            compiles the three native tokenizer libraries (WordPiece,
            byte-level BPE, the vocab trainer), each timed;
3. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, in f32 and bf16, at the shapes the serving and training
            paths give it (LayerNorm at (8 * bucket, 1024) for every
            bucket; flash attention at (8, 512, 16, 64) with a padding bias
            and packed segments, and at S = 1024; the LayerNorm backward
            and the fused residual-dropout-LayerNorm forward and backward
            at phase 1's (12288, 1024) and (1920, 1024), phase 2's
            (8192, 1024), NER's (4096, 1024), classify's and embed's
            (2048, 1024) and a tail of 1003 rows, rates 0 and 0.1, a
            negative and a positive seed, and the backward's generic
            kernel at widths 768 and 1022), with the tolerances below;
            the segment tile skip must fire as often as the layout
            predicts, pad rows must come out exactly zero, dropped
            positions must match the plain mask exactly and every backward
            must give the same bits twice;
4. timing   each kernel, its plain version and the PyTorch library call
            that computes the same function (timed here as a yardstick, used
            nowhere in the port), by CUDA events, L2 flushed before each
            launch, median of repeats, as the device's time alone (the
            call's host work done before the start event); and the least
            time the card could take (bytes over the memory rate or
            operations over the peak rate, whichever is larger); the
            LayerNorm backwards also at phase 2's rows, and by launch
            (row pass, column pass: torch.profiler); the flash backward
            pair also at (8, 1024) and (4, 2048) and in f32;
5. model_seq1024  BERT-Large's widths cut to 2 layers at 8 x 1024
            tokens, bf16: one microbatch's loss and gradients through the
            kernels (the flash backward by the dq and dk/dv pair, each
            launched once a layer, the fused backward never) against the
            plain versions;
6. serve    seeded random BERT-Large checkpoints (24 layers, full width)
            of the five registered tasks served by one
            bert_pytorch_tpu_torch.run_server.serve with the default
            buckets 64/128/256/512, 8 rows, 8 segments, packing on, bf16:
            SQuAD requests over HTTP, one of them in the 512 bucket, each
            answered 200 with a span of its context; the launch counts,
            zeroed just before, show every forward went through the
            kernels; one packed 512 batch of the engine is held against the
            same weights run with the plain versions; then /healthz lists
            the five tasks, POST /v1/{ner,classify,choice,embed} answer
            requests in every bucket, well formed, with exact launch
            counts, and each new service's 400 and 413 paths; per task,
            answers with packing on held against packing off, and one
            packed 512 forward's exact launches (49 LayerNorm forwards, 24
            flash forwards) and device time; the server runs one CUDA
            graph a (task, bucket), so those counts are each graph's
            capture times its replays, and `captures` must stay flat under
            all of the phase's traffic; every (task, bucket) replay is held
            bit-equal to the eager forward and each task's bf16 weight copy
            bit-equal to its f32-master model, with the resident weights
            and the 512 forward's host clock and device time (replay and
            eager); the short SQuAD requests are traced op by op packed and
            alone (the first op that differs, ROADMAP queue C item 2);
            /metrics carries the twelve bert_serve_* families and a reply's
            X-Trace-Id finds its spans in /v1/traces; a fixed offered load
            (bert_pytorch_tpu_torch/tools/serve_load.py in its own process:
            Poisson arrivals at 100 requests/s for 30 s, the five routes
            evenly, then a ramp to where p99 passes 1 s); a drain drill
            (503 + Retry-After, the admitted request answered); then a
            second server with --serve_dtype int8 on the same checkpoints:
            the decode gate on the five tasks, the resident weights, the
            512 forward, and corrupted scales refused;
7. train_order  ROADMAP queue C item 1: one phase-1 microbatch's loss,
            layer outputs and gradients (digests) in two fresh processes
            (`--grad_probe`) and in this one after the phases before it,
            compared leaf by leaf; a difference is recorded, not failed;
8. train    a seeded random BERT-Large (24 layers, full width, vocab 30528)
            trained for 3 phase-1 steps (the run config's microbatch of
            96 x 128, accumulation 2) by the entry point's trainer
            (run_pretraining.train, --fused_optim auto) over synthetic
            phase-1 shards held in memory, saving checkpoints (steps 2 and
            3) into a temporary directory; exact launch counts of the
            training kernels and the fused LAMB kernels, finite losses and
            gradient norms; the last checkpoint read back bit-equal; step
            3 traced by --profile_steps and summarized by the port's
            trace_summary (device total, host phases, idle share, top
            ops), its device total within 1% of the profiled step's
            (the same step built apart, read by the same reader); one optimizer step profiled, the
            step and one LAMB update timed on the kernels and on route
            off; one microbatch through the kernels held against the
            plain versions (f32 and bf16 loss and gradients);
9. train_phase2  the same for phase 2: 3 steps under the phase-2 run
            config (microbatch 16 x 512, 80 predictions, accumulation 2),
            where attention runs the flash forward with dropout and the
            fused flash backward (no launch of the split pair); it
            auto-resumes phase 1's last checkpoint
            (previous_phase_end_step set to 3 for it) and must continue
            from step 3 with phase 1's LAMB state;
10. train_kfac  K-FAC: configs/bert_kfac_pretraining_phase1_config.json
            at 24 layers and 2 x 96 x 128, --kfac_inv_interval 2, 3 steps
            through the trainer: exact launch counts, the factor and
            inverse bytes, hbm_* in every perf record; a step's parts
            (forward+backward, statistics, inversion, preconditioning,
            LAMB: host clock and device time); one K-FAC step on the
            kernels against the plain versions (loss, grad_norm, nu); at
            CUT_LAYERS one K-FAC step on the card against the port on the
            CPU (and layer 0's inversion of the same factors), G's bound
            read against the card's G from bf16 statistics, from other
            dropout masks and halved (the last two must exceed it), and
            a bundle's step 3 replayed bit-identically;
11. train_roberta  the RoBERTa recipe (no NSP, vocab 28996, linear
            decay) at 24 layers, 2 x 16 x 128, 2 steps: exact launch
            counts, finite losses, the 297 tensors LAMB updates, one
            microbatch through the kernels against the plain versions;
12. train_packed  packed pretraining, phase 1: 3 steps of the entry
            point's trainer with --packing (8 segments a row, lookahead
            4) over in-memory shards whose real lengths are uniform over
            16-128 tokens: exact launch counts, examples a step and the
            perf record's packing_efficiency; one optimizer step of the
            same data packed and unpacked (host clock, device time,
            examples/s); one packed microbatch through the kernels
            against the plain versions; at rate 0 the packed microbatch
            against its examples one a row;
13. train_packed_phase2  the same at phase 2 (16 x 512, lengths
            64-512), where the packed segments reach the flash forward's
            dropout arm and the fused backward: also one packed
            microbatch's flash launches and the tiles their segment test
            skipped, as the layout predicts;
14. train_dp  data-parallel pretraining (parallel/), BERT-Large width at
            CUT_LAYERS, phase 1: one rank under an NCCL group of one
            (ZeRO-1, so the NCCL wrappers run on the card) and two ranks
            sharing the card over gloo (chip_smoke.py --dp_child
            processes): the step-level 2-rank leg on the same global
            batch (2 x 96 x 128, dropout off, f32 gradients) against the
            1-rank leg within DP_TOL; 3 steps of the entry point at
            --mesh data=2 under --mesh_config auto (packing, ZeRO-1,
            gather-on-use), + --zero1_rs, + --coalesce_reductions on, and
            ZeRO-1 with the end-of-step gather, bit-equal to one another
            (losses, grad norms, the params' digest) with exact launches
            on each rank; the first arm's 2-rank checkpoint restored by
            one rank and kept for train_chunks and finetune_tasks;
15. train_chunks  --steps_per_loop on phase 2 (BERT-Large's width at
            CUT_LAYERS, 16 x 512, accumulation 2) from the chained
            pretraining checkpoint (train_dp's, its weights through
            --init_checkpoint, every parameter loaded): 4
            steps a run at N = 1 and N = 2, alternated (1, 2, 2, 1), each
            traced over its warm chunk by --profile_steps: losses,
            parameters and LAMB moments bit-equal across the runs, exact
            launch counts, hbm_* in every perf record; the host clock a
            traced step and the idle share (a gain reported only where the
            modes' ranges do not overlap); a run at --steps_per_loop 4
            --profile_steps 2,3, its chunk traced whole, bit-equal too;
            one microbatch through the kernels against the plain versions;
16. pipeline  the offline corpus pipeline and the native encoders:
            the three C++ libraries' build seconds (the build phase's, or
            built here when it did not run); stream_corpus's documents as wikiextractor files through
            format, shard, a WordPiece and a BPE vocabulary trained by the
            native and by the Python merge engine (equal), create_samples
            with the native and with the Python WordPiece (equal samples,
            sentences/s), WordPiece and BPE tokens/s (native at 1 thread
            and at min(cpu_count, 16), Python at 1: host rates); the
            samples' arrays through an in-memory ShardIndex into 2 phase-1
            steps of the trainer at CUT_LAYERS: exact launch counts,
            finite losses;
17. stream  the streaming data plane (--stream_dir) through the entry
            point's trainer at phase 1's 2 x 96 x 128 over a synthetic
            corpus tokenized on the fly by the native WordPiece: 3 steps at
            STREAM_LAYERS (12) layers with
            --h2d_prefetch 1 (exact launch counts; the batches the steps
            read bit-equal to the loader's alone on the host; data_wait's
            share, the pool's tokens/s, the queue depth, the idle share
            from a trace) and at 0 (losses and grad norms bit-equal; the
            trace shows depth 1's copies on a stream of their own), and at
            1 on the pure-Python WordPiece (losses bit-equal to the native
            leg's; the three planes' step time, dispatch, idle share, the
            pool's tokens/s and data_wait's share side by side); the
            offline plane's 4 steps at the defaults (--h2d_prefetch 1,
            --tensorboard on) against the parent's (0, off), in
            alternated pairs: losses bit-equal, the host phases, the step
            time and the idle share; at CUT_LAYERS and 2 x 32 x 128, packed:
            worker_crash bit-equal to the clean run, corrupt_record's drops
            counted, --stream_tokenizer bpe over a vocabulary learned from the
            corpus, and the TensorBoard sink's scalars;
18. remat   --checkpoint_activations at phase 2's packed 16 x 512, 24
            layers: 2 trainer steps under the model config's policy
            ("nothing"), exact launch counts (each layer's residual tails
            and flash forward twice); per policy (nothing, dots,
            mlp_only) one packed microbatch's loss and every gradient (12
            tensors a layer and 14 more) bit-equal to remat off, and one
            optimizer step's launches, peak memory and host and device
            time against remat off;
19. finetune_squad  SQuAD v1.1 finetuning by the entry point's run_task
            (bert_pytorch_tpu_torch.run_squad's body): BERT-Large seeded
            from phase 2's last checkpoint, 3 steps of 32 x 384 (flash
            forward with dropout and the fused backward in every layer),
            bf16, FusedAdam with the clip, on synthetic files; the
            checkpoint, predict over the eval buckets (the 384 bucket
            through the flash forward, the shorter through plain
            attention) and evaluate_v1; exact launch counts of the run;
            run_server serving the finetuned checkpoint; one step profiled
            and timed, the optimizer update timed; one microbatch through
            the kernels against the plain versions;
20. finetune_ner  CoNLL NER finetuning, 3 steps of 32 x 128 (plain
            attention, the LayerNorm kernels) on a synthetic CoNLL-2003
            file, val and test macro F1, the checkpoint, exact launch
            counts, one step profiled and timed;
21. finetune_tasks  classify, choice and embed finetuning, one after the
            other: BERT-Large's width at CUT_LAYERS from train_dp's
            pretraining checkpoint (--init_checkpoint; finetune_squad
            keeps the chain from phase 2's at 24 layers), 3 steps of
            16 x 128 (choice 16 x 4 x 128) at the JAX base parser's recipe
            on synthetic TSV / JSONL files, val and test accuracy, embed's
            embedding norms, exact launch counts, the checkpoint answered
            by the server and deleted, one step profiled and timed, and a
            classify and a choice microbatch through the kernels against
            the plain versions;
22. serve_slo  the SLO plane, the canary prober and the fault injector on
            the five-task server (seeded random BERT-Large checkpoints,
            buckets 128 and 512, bf16), with scripts/check_slo.sh's
            miniature windows: a clean leg of 12 s at 20 requests/s fires
            no alert and every task's probe stays healthy;
            corrupt_answers on squad flips squad alone (every request
            still 200); error_burst pages within one short window and
            resolves within one after it stops; latency_burst's alert
            carries trace ids that GET /v1/traces resolves; the serve log
            directory's three files (the header names the card); then
            the serve phase's fixed rate for 10 s with the SLO plane
            (configs/slo.json) and the prober on, and again with both
            off: p50 / p99, evaluate()'s host time a tick, the
            latency_p99 burn;
23. finetune_packed  packed finetuning of the five tasks at BERT-Large
            width, CUT_LAYERS (bf16, seeded random init, synthetic
            lengths): a packed
            batch against the same examples one to a row through the
            kernels, dropout off (a planted label shift must read 10x the
            loss limit); the packed microbatch, dropout on, against the
            plain versions; SQuAD's flash forward and fused backward,
            once a layer a packed microbatch, and the tiles their segment
            test skipped; 3 steps of run_finetune --task classify and of
            run_squad, packed and not, on the same files (examples/s, a
            step's device time, packing_efficiency, real and slot tokens,
            peak memory, exact launch counts);
24. distill  a BERT-Large-width classify teacher of 8 layers (3 steps
            through run_finetune, --perf_artifact: its FINETUNE json's mfu
            on the card's peak) and a SQuAD teacher (one step) distilled into
            student_6l_768 (6 layers, width 768, 12 heads) by
            run_distill: classify packed with both tap losses through
            768 -> 1024 projections, SQuAD at 32 x 384 unpacked; exact
            launch counts (the teacher forward only); the summary's keys,
            the teacher's weights bit-unchanged; one distillation
            microbatch through the kernels against the plain versions (a
            planted fault must read beyond the tolerance); precomputed
            teacher logits against the in-step teacher, bit for bit;
            packed against one a row; the student served with its own
            config and its checkpoint refused under the teacher's;
            --inject broken_student; a step's time split beside a plain
            finetune step of the student;
25. init_sources  --init_checkpoint from other sources at BERT-Large
            width, CUT_LAYERS: random weights from a seed written as the
            reference's ckpt_1.pt (its src/modeling.py names, `module.`
            prefixes, 30522 vocab rows); a fresh QA model seeded from it holds
            every bert.* parameter bit-equal to the source and the report
            names the QA head alone; run_squad (run_task) from it, 2
            steps of 32 x 384, exact launch counts, its first loss
            bit-equal to the same run seeded from a port checkpoint of
            the same weights, which runs with the hung-step watchdog
            armed (warn) and a spin kernel queued behind each step: the
            watchdog trips in both waits for the card (the next batch's
            copy, the loss's readback) as a device hang; a TF release
            and a JAX orbax directory raise the ImportError naming
            tensorflow / tensorstore, which the chip machine lacks;
26. survival  pretraining's survival and metrics planes, BERT-Large
            width at CUT_LAYERS, phase 1 (96 x 128, accumulation 2,
            health pack on) through the entry
            point's trainer over in-memory shards: a clean 4-step run
            with /metrics scraped mid-run and StepWatch perf records
            (mfu on the card's peak), exact launch counts; SIGTERM before
            step 3 in a process of its own (chip_smoke.py
            --pretrain_child, the entry point under `_cli`'s exit codes):
            exit 143, an emergency checkpoint of step 2 that verifies and
            the flight recorder's crash bundle, then a resume bit-equal
            to the clean run (losses and every parameter) whose state
            holds the checkpoint's keys with the pack off; a stalled
            dispatch under --watchdog_action warn (one device_hang trip
            on /metrics, a stacks file, a watchdog bundle) with a NaN step
            skipped (parameters unchanged); the recorder drill: a halt
            child (a checkpoint at step 1, a NaN at step 2) exits 71
            naming its bundle, which validates, and
            bert_pytorch_tpu_torch.tools.replay --bisect reproduces step
            2 bit-identically and names layer 0's attention; the
            emergency save's, the restore's and the health pack's times.

The kernels phase also holds the flash kernels of training at phase 2's
(16, 512, 16, 64): the forward's dropout arm, the dropout mask read out of
the forward and out of dv (of the pair and of the fused backward) and
compared exactly, and the fused backward and the split pair against their
plain version; and the split pair again at (8, 1024) and (4, 2048), the
lengths where bf16 takes it; and the same training checks at SQuAD's
(32, 384, 16, 64) with padding of 150-384-token windows (three key tiles
a work item), and the forward at predict's (8, 384) at rate 0. The timing
phase times them (the fused backward at rates 0.1 and 0, at phase 2's
and at SQuAD's shape) beside their plain versions and
scaled_dot_product_attention. The distilled student's shapes are held
and timed too: #1-#4 at width 768 ((2048, 768) and (12288, 768), bf16)
and the flash forward and fused backward at (32, 384, 12, 64).
The launches the kernels phase makes for its checks are reported apart
from the main paths' (`launches_in_checks`). It holds the fused LAMB stages
(#11, #12) against their plain versions bit for bit over BERT-Large's 302
parameter tensors and a list of odd sizes and misaligned views, and the
timing phase times them over the 302 tensors.

Phases 10, 13-16, 21, 23, 25 and 26, the stream phase's drills and
train_kfac's replay and card-vs-CPU step run at CUT_LAYERS (6) layers,
distill's teacher at 8 (deeper than its 6-layer student): their checks
hold at any depth, and their checkpoints (4 GB each at 24 layers)
dominate several.

It prints a `kernels` JSON line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Without a CUDA card it exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
# this process's start (a train_dp rank reports its start-up from it)
START = time.perf_counter()

BUCKETS = (64, 128, 256, 512)
BATCH_ROWS = 8
HIDDEN = 1024
HEADS, HEAD_DIM = 16, 64

# Tolerances, kernel against its plain version on the same inputs.
# LayerNorm f32: the two differ only in the order of the row sums.
# LayerNorm bf16: y is rounded to bf16 after f32 math, so the two may land
# one bf16 step apart (2^-8 relative; |y| < 8 here gives < 0.03).
# Flash f32: online softmax against one-shot softmax, f32 throughout.
# Flash bf16: the kernel rounds exp(s - running max) to bf16 before PV,
# the plain version exp(s - row max); outputs are bf16 (2^-8 relative).
LN_TOL = {"float32": 1e-5, "bfloat16": 3.2e-2}
# LayerNorm forward widths that take the generic kernel: BERT-Base's
# hidden size and an odd one (the by-element arm)
GENERIC_LN_COLS = (768, 1022)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4
# Whole BERT-Large forward with the kernels against the plain versions:
# in bf16, 24 layers of bf16-rounded differences on logits whose spread
# with random weights is ~0.15; in f32, 24 layers of f32 rounding-order
# differences.
MODEL_TOL = 0.1
MODEL_TOL_F32 = 1e-3
# Training kernels (#2-#4) at phase 1's (B * S, E) and (B * P, E) rows.
# Backward outputs are compared relative to their largest magnitude: dx
# and dres in f32 differ only in the order of the two row sums; in bf16
# both sides round the same f32 value, up to that order and the bf16 row
# kernel's multiply by 1 / (1 - rate) where the plain version divides, so
# they may land one bf16 step apart (2^-8 relative). dscale and dbias are
# f32 sums over up to 12288 rows in another order on either side.
TRAIN_ROWS = (96 * 128, 96 * 20)
# phase 2's (B * S, E) rows: the residual tails' and the timing phase's
# second shape for #2 and #4
PHASE2_LN_ROWS = 16 * 512
# NER finetuning's microbatch (B, S): its (B * S, E) rows take #1-#4
NER_TRAIN = (32, 128)
# the classify / embed microbatch (B, S) (the JAX base finetune parser's
# defaults) and choice's choices an example: choice's (B * C * S, E) rows
# are phase 2's 8192
TASK_TRAIN = (16, 128)
TASK_CHOICES = 4
# the rows the kernels phase holds #1-#4 at: both pretraining phases',
# NER finetuning's, classify's and embed's (SQuAD's 32 x 384 is phase 1's
# 12288, choice's phase 2's 8192) and a tail that fills no CTA of either
# backward kernel
TRAIN_CHECK_ROWS = TRAIN_ROWS + (PHASE2_LN_ROWS, NER_TRAIN[0] * NER_TRAIN[1],
                                 TASK_TRAIN[0] * TASK_TRAIN[1], 1003)
TRAIN_TOL = {"float32": {"dx": 1e-5, "sums": 1e-5},
             "bfloat16": {"dx": 2 ** -7, "sums": 1e-5}}
# Flash in training (#5/#6 dropout arm, #7-#10) at phase 2's microbatch
# (16, 512, 16, 64). Backward outputs are compared relative to their
# largest magnitude. f32: the kernels and the plain version sum s, dp and
# the dq/dk/dv products in another order. bf16: both sides round ds and
# p_drop to bf16 from f32 values that differ in their last bits, and round
# the outputs to bf16 (2^-8 relative); the fused backward (bf16 only)
# also multiplies by 1 / (1 - rate) where the plain version divides, and
# exponentiates log2-scaled scores with the card's ex2.
# Measured on the card (PERF.md): f32 3.0e-7, bf16 3.2e-3 (the pair and
# the fused backward alike); the tolerances leave 3.3x (f32) and 2.5x
# (bf16, 2^-7).
PHASE2_ATTN = (16, 512)
FLASH_BWD_TOL = {"float32": 1e-6, "bfloat16": 2 ** -7}
FLASH_SEEDS = (-1640531527, 12345)
# SQuAD finetuning's attention: the train microbatch (32, 384) (three
# 128-key tiles a work item) and predict's 384 bucket (8, 384), with
# padding biases of windows whose real lengths are 150-384; held at the
# tolerances above.
SQUAD_ATTN = (32, 384)
SQUAD_PREDICT_ATTN = (8, 384)
SQUAD_MIN_LEN = 150
# the rows the kernels phase holds #1 at first: the serve buckets'
# batches, SQuAD predict's 32 and 384 buckets' and SQuAD training's
# microbatch
# the distilled student (student_6l_768 of BERT-Large): width 768, 12
# heads; its LayerNorms at classify's (16 x 128) and SQuAD's (32 x 384)
# rows, its attention at SQuAD's (32, 384, 12, 64)
STUDENT_HIDDEN, STUDENT_HEADS = 768, 12
DISTILL_LN_ROWS = (16 * 128, 32 * 384)
LN_FWD_ROWS = tuple(sorted({BATCH_ROWS * b for b in BUCKETS + (32, 384)}
                           | {SQUAD_ATTN[0] * SQUAD_ATTN[1]}))


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# -- the card -----------------------------------------------------------------

# (memory bytes/s, bf16 dense tensor FLOP/s, f32 FLOP/s without tensor
# cores), NVIDIA data sheets; the first name fragment found in the card's
# name wins, so the SXM part ("H100 80GB HBM3") is the fall-through H100 row
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100", 3.35e12, 989e12, 67e12),
)


def card_peaks(name: str):
    for frag, bw, bf16, f32 in CARD_PEAKS:
        if frag in name:
            return {"card_row": frag, "bytes_per_s": bw,
                    "bf16_flops": bf16, "f32_flops": f32}
    raise PhaseError(f"no peak rates known for card {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- timing -------------------------------------------------------------------


class Timer:
    """CUDA-event time of one call, with the L2 cache (50 MB) flushed by a
    256 MB write before every launch: median of `reps` launches, ms.

    The events bracket the call as its caller sees it, host work
    included. `hide_host=True` queues a 20 ms spin on the card before the
    start event, so that the call's host work (a wrapper that builds
    tables) is done before the card reaches the start event and the time
    is the device's alone."""

    SPIN_CYCLES = 40_000_000          # ~20 ms at the H100's 1.98 GHz

    def __init__(self, torch, reps: int = 25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, hide_host: bool = False) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            if hide_host:
                torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# -- inputs -------------------------------------------------------------------


def packed_segments(np, rng, rows: int, seq: int):
    """(rows, seq) int32 segment ids as the serving packer lays them out:
    consecutive segments 1..n of 20-300 tokens, then a pad tail; one row
    is a single full-length segment."""
    seg = np.zeros((rows, seq), np.int32)
    for r in range(rows):
        if r == 0:
            seg[r, :] = 1
            continue
        cursor, n = 0, 0
        limit = seq - int(rng.randint(0, 64))
        while True:
            ln = int(rng.randint(20, 301))
            if cursor + ln > limit:
                break
            n += 1
            seg[r, cursor:cursor + ln] = n
            cursor += ln
    return seg


def expected_skips(np, seg, block_q: int, block_k: int, heads: int) -> int:
    """(q-tile, k-tile) pairs whose [min non-pad, max] segment ranges do
    not meet — the kernel's skip test, per head."""
    rows, seq = seg.shape
    total = 0
    for b in range(rows):
        def rng_of(lo, hi):
            s = seg[b, lo:hi]
            nz = s[s > 0]
            return (int(nz.min()) if nz.size else 1 << 30, int(s.max()))
        for q0 in range(0, seq, block_q):
            qmn, qmx = rng_of(q0, q0 + block_q)
            for k0 in range(0, seq, block_k):
                kmn, kmx = rng_of(k0, k0 + block_k)
                if not (qmx > 0 and kmx > 0 and qmx >= kmn and kmx >= qmn):
                    total += 1
    return total * heads


def allowed_pairs(np, seg) -> int:
    """(q, k) pairs the packed mask allows: sum of squared segment
    lengths."""
    total = 0
    for row in seg:
        ids, counts = np.unique(row[row > 0], return_counts=True)
        total += int((counts.astype(np.int64) ** 2).sum())
    return total


# -- phases -------------------------------------------------------------------


def phase_kernels(torch, np, results):
    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_ref, make_attention_bias)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels
    from bert_pytorch_tpu_torch.ops.layernorm import (layer_norm_fwd,
                                                      layer_norm_stats_ref)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ln_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        worst = 0.0
        for rows in LN_FWD_ROWS:
            x = (torch.randn(rows, HIDDEN, generator=gen, device="cuda")
                 * 2.0 + 0.5).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(HIDDEN, generator=gen,
                                            device="cuda")
            bias = 0.1 * torch.randn(HIDDEN, generator=gen, device="cuda")
            y, mean, rstd = layer_norm_fwd(x, scale, bias)
            yr, mr, rr = layer_norm_stats_ref(x, scale, bias)
            torch.cuda.synchronize()
            check(y.dtype == dtype and y.shape == x.shape,
                  f"layer_norm {name}: got {y.dtype} {tuple(y.shape)}")
            err = (y.float() - yr.float()).abs().max().item()
            stat_err = max((mean - mr).abs().max().item(),
                           ((rstd - rr).abs() / rr.abs()).max().item())
            log(f"kernels: layer_norm {name} ({rows}, {HIDDEN}) "
                f"max|y-ref| {err:.3g} (tol {LN_TOL[name]:g}), "
                f"stats {stat_err:.3g} (tol 1e-5)")
            check(err <= LN_TOL[name], f"layer_norm {name} at ({rows}, "
                  f"{HIDDEN}): max error {err} > {LN_TOL[name]}")
            check(stat_err <= 1e-5, f"layer_norm {name} mean/rstd error "
                  f"{stat_err} > 1e-5")
            worst = max(worst, err)
        ln_err[name] = worst
    results["layer_norm_fwd"] = {"max_abs_err": ln_err}
    check_generic_layer_norm(torch, results)

    rng = np.random.RandomState(0)
    fl_err = {}
    for batch, seq in ((BATCH_ROWS, 512), (4, 1024)):
        seg_np = packed_segments(np, rng, batch, seq)
        seg = torch.from_numpy(seg_np).cuda()
        bias = make_attention_bias((seg > 0).int())
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            qkv = torch.randn(batch, seq, 3, HEADS, HEAD_DIM, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            skipped = torch.zeros(1, dtype=torch.int32, device="cuda")
            out, lse = flash_attention(q, k, v, bias, seg, skipped=skipped)
            ref, lse_ref = flash_attention_ref(q, k, v, bias, seg)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lerr = (lse - lse_ref).abs().max().item()
            pad = seg == 0
            pad_max = out[pad].abs().max().item() if pad.any() else 0.0
            tile = load_kernels().flash_tiles(dtype == torch.bfloat16)[
                "flash_attention_fwd"]
            want_skips = expected_skips(np, seg_np, *tile, HEADS)
            got_skips = int(skipped.item())
            log(f"kernels: flash_attention {name} ({batch}, {seq}, {HEADS}, "
                f"{HEAD_DIM}) max|out-ref| {err:.3g} (tol "
                f"{FLASH_TOL[name]:g}), max|lse-ref| {lerr:.3g} (tol "
                f"{LSE_TOL:g}), pad rows max {pad_max}, tiles skipped "
                f"{got_skips} (layout predicts {want_skips})")
            check(out.shape == q.shape and out.dtype == dtype,
                  f"flash {name}: got {out.dtype} {tuple(out.shape)}")
            check(err <= FLASH_TOL[name], f"flash {name} S={seq}: max "
                  f"error {err} > {FLASH_TOL[name]}")
            check(lerr <= LSE_TOL, f"flash {name} S={seq}: lse error {lerr}")
            check(pad_max == 0.0, f"flash {name}: pad rows not zero "
                  f"({pad_max})")
            check(got_skips == want_skips and got_skips > 0,
                  f"flash {name}: {got_skips} tiles skipped, layout "
                  f"predicts {want_skips}")
            if seq == 512:
                fl_err[name] = err
    results["flash_attention_fwd"] = {"max_abs_err": fl_err}
    check_training_kernels(torch, np, results)
    check_flash_training_kernels(torch, np, results)
    check_flash_training_kernels(torch, np, results, SQUAD_ATTN,
                                 SQUAD_MIN_LEN, "finetune_squad")
    check_flash_training_kernels(torch, np, results, SQUAD_ATTN,
                                 SQUAD_MIN_LEN, "distill_squad",
                                 heads=STUDENT_HEADS)
    check_student_layer_norm(torch, results)
    check_squad_predict_flash(torch, np, results)
    check_pair_long(torch, np, results)
    check_lamb_kernels(torch, np, results)


def check_generic_layer_norm(torch, results):
    """The LayerNorm forward at widths other than 1024 (ln_fwd_kernel,
    which the dispatcher keeps for them; 1024 takes ln_fwd_row_kernel):
    BERT-Base's 768 (16-byte loads) and an odd 1022 (bf16 by the element),
    f32 and bf16, plain arm and residual arm at rates 0 and 0.1, against
    the plain versions at LN_TOL with stats within 1e-5; and the residual
    arm's dropped positions read back out of y exactly (residual 0, x in
    [1, 2), unit scale and zero bias: a dropped element's LN input is 0, a
    kept one's at least 1 / (1 - rate))."""
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES
    from bert_pytorch_tpu_torch.ops.layernorm import (
        add_dropout_layer_norm_fwd, add_dropout_layer_norm_stats_ref,
        hash_keep_mask, layer_norm_fwd, layer_norm_stats_ref)

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows, seed = BATCH_ROWS * 128, -1640531527
    before = (LAUNCHES["layer_norm_fwd"],
              LAUNCHES["add_dropout_layer_norm_fwd"])
    calls, worst = 0, {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for cols in GENERIC_LN_COLS:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = (randn(rows, cols) * 2.0 + 0.5).to(dtype)
            res = randn(rows, cols).to(dtype)
            scale = 1.0 + 0.1 * randn(cols)
            bias = 0.1 * randn(cols)
            cases = [("plain", layer_norm_fwd(x, scale, bias),
                      layer_norm_stats_ref(x, scale, bias))]
            for rate in (0.0, 0.1):
                cases.append((f"residual rate {rate}",
                              add_dropout_layer_norm_fwd(x, res, scale, bias,
                                                         seed, rate),
                              add_dropout_layer_norm_stats_ref(
                                  x, res, scale, bias, seed, rate)))
            # the mask probe
            xm = (1.0 + torch.rand(rows, cols, generator=gen,
                                   device="cuda")).to(dtype)
            one, zero = torch.ones(cols, device="cuda"), torch.zeros(
                cols, device="cuda")
            ym, mm, rm = add_dropout_layer_norm_fwd(
                xm, torch.zeros_like(xm), one, zero, seed, 0.1)
            calls += len(cases) + 1
            torch.cuda.synchronize()
            for what, (y, mean, rstd), (yr, mr, rr) in cases:
                err = (y.float() - yr.float()).abs().max().item()
                stat_err = max((mean - mr).abs().max().item(),
                               ((rstd - rr).abs() / rr.abs()).max().item())
                log(f"kernels: layer_norm {what} {name} ({rows}, {cols}) "
                    f"(ln_fwd_kernel) max|y-ref| {err:.3g} (tol "
                    f"{LN_TOL[name]:g}), stats {stat_err:.3g} (tol 1e-5)")
                check(y.dtype == dtype and y.shape == x.shape
                      and err <= LN_TOL[name] and stat_err <= 1e-5,
                      f"layer_norm {what} {name} at ({rows}, {cols}): "
                      f"{y.dtype} {tuple(y.shape)}, max error {err}, stats "
                      f"error {stat_err}")
                worst[name] = max(worst.get(name, 0.0), err)
            kept = (ym.float() / rm[:, None] + mm[:, None]).abs() > 0.5
            want = hash_keep_mask(seed, xm.shape, 0.1, xm.device)
            dropped = int((~want).sum().item())
            exact = torch.equal(kept, want)
            log(f"kernels: add_dropout_layer_norm {name} ({rows}, {cols}) "
                f"(ln_fwd_kernel): {dropped} dropped, positions read out of "
                f"y {'exact' if exact else 'DIFFER'}")
            check(exact and dropped > 0,
                  f"add_dropout_layer_norm {name} at ({rows}, {cols}): the "
                  "dropped positions in y do not match the plain mask")
    launched = (LAUNCHES["layer_norm_fwd"] - before[0]
                + LAUNCHES["add_dropout_layer_norm_fwd"] - before[1])
    log(f"kernels: ln_fwd_kernel (widths {GENERIC_LN_COLS}): {launched} "
        f"launches for {calls} wrapper calls")
    check(launched == calls, f"ln_fwd_kernel checks: {launched} launches "
          f"counted for {calls} calls")
    results["layer_norm_fwd_generic"] = {
        "widths": list(GENERIC_LN_COLS), "launches": launched,
        "max_abs_err": worst}


def check_student_layer_norm(torch, results):
    """#1-#4 at the distilled student's width, 768 (the generic
    ln_fwd_kernel / ln_bwd_kernel: the row kernels are 1024's), bf16 at
    DISTILL_LN_ROWS, the residual arms at rates 0 and 0.1 with both
    seeds: against the plain versions at LN_TOL / TRAIN_TOL, every
    backward twice with the same bits, dx zeros exactly where the plain
    mask drops; the worst errors under each kernel's `distill`."""
    from bert_pytorch_tpu_torch.ops.layernorm import (
        add_dropout_layer_norm_bwd, add_dropout_layer_norm_bwd_ref,
        add_dropout_layer_norm_fwd, add_dropout_layer_norm_stats_ref,
        hash_keep_mask, layer_norm_bwd, layer_norm_bwd_ref, layer_norm_fwd,
        layer_norm_stats_ref)

    gen = torch.Generator(device="cuda").manual_seed(13)
    e, name, bf = STUDENT_HIDDEN, "bfloat16", torch.bfloat16
    tol = TRAIN_TOL[name]
    worst = {}

    def note(kernel, err):
        worst[kernel] = max(worst.get(kernel, 0.0), err)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for rows in DISTILL_LN_ROWS:
        x = (randn(rows, e) * 2.0 + 0.5).to(bf)
        res = randn(rows, e).to(bf)
        g = randn(rows, e).to(bf)
        scale = 1.0 + 0.2 * randn(e)
        bias = 0.1 * randn(e)
        y, mean, rstd = layer_norm_fwd(x, scale, bias)
        yr, mr, rr = layer_norm_stats_ref(x, scale, bias)
        got = layer_norm_bwd(x, scale, mean, rstd, g)
        again = layer_norm_bwd(x, scale, mean, rstd, g)
        want = layer_norm_bwd_ref(x, scale, mean, rstd, g)
        torch.cuda.synchronize()
        yerr = (y.float() - yr.float()).abs().max().item()
        serr = max((mean - mr).abs().max().item(),
                   ((rstd - rr).abs() / rr).max().item())
        errs = [_rel(a, b) for a, b in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"kernels: student layer_norm {name} ({rows}, {e}) max|y-ref| "
            f"{yerr:.3g} (tol {LN_TOL[name]:g}), stats {serr:.3g}; "
            f"layer_norm_bwd rel err dx {errs[0]:.3g}, dscale {errs[1]:.3g},"
            f" dbias {errs[2]:.3g} (tol {tol['dx']:g} / {tol['sums']:g}); "
            f"rerun bit-identical: {same}")
        check(yerr <= LN_TOL[name] and serr <= 1e-5 and same
              and errs[0] <= tol["dx"] and max(errs[1:]) <= tol["sums"],
              f"student layer_norm ({rows}, {e}): y {yerr}, stats {serr}, "
              f"bwd {errs}, rerun identical {same}")
        note("layer_norm_fwd", yerr)
        note("layer_norm_bwd", (got[0].float() - want[0].float()).abs()
             .max().item())
        for rate in (0.0, 0.1):
            for seed in FLASH_SEEDS:
                y, mean, rstd = add_dropout_layer_norm_fwd(
                    x, res, scale, bias, seed, rate)
                yr, mr, rr = add_dropout_layer_norm_stats_ref(
                    x, res, scale, bias, seed, rate)
                got = add_dropout_layer_norm_bwd(x, res, scale, mr, rr, g,
                                                 seed, rate)
                again = add_dropout_layer_norm_bwd(x, res, scale, mr, rr, g,
                                                   seed, rate)
                want = add_dropout_layer_norm_bwd_ref(x, res, scale, mr, rr,
                                                      g, seed, rate)
                torch.cuda.synchronize()
                yerr = (y.float() - yr.float()).abs().max().item()
                serr = max((mean - mr).abs().max().item(),
                           ((rstd - rr).abs() / rr).max().item())
                errs = [_rel(a, b) for a, b in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                zeros = True
                if rate > 0.0:
                    keep = hash_keep_mask(seed, x.shape, rate, x.device)
                    zeros = torch.equal(got[0] == 0, ~keep)
                log(f"kernels: student add_dropout_layer_norm {name} "
                    f"({rows}, {e}) rate {rate} seed {seed}: fwd max|y-ref| "
                    f"{yerr:.3g}, stats {serr:.3g}; bwd rel err dx "
                    f"{errs[0]:.3g} dres {errs[1]:.3g} dscale {errs[2]:.3g} "
                    f"dbias {errs[3]:.3g}; dx zeros exact {zeros}; rerun "
                    f"bit-identical {same}")
                check(yerr <= LN_TOL[name] and serr <= 1e-5 and same
                      and zeros and max(errs[:2]) <= tol["dx"]
                      and max(errs[2:]) <= tol["sums"],
                      f"student add_dropout_layer_norm ({rows}, {e}) rate "
                      f"{rate} seed {seed}: y {yerr}, stats {serr}, bwd "
                      f"{errs}, zeros {zeros}, rerun identical {same}")
                note("add_dropout_layer_norm_fwd", yerr)
                note("add_dropout_layer_norm_bwd", max(
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(got[:2], want[:2])))
    for kernel, err in worst.items():
        results[kernel].setdefault("distill", {}).update(
            max_abs_err={name: err}, rows_checked=list(DISTILL_LN_ROWS),
            width=e)


def fused_backward_build(torch) -> dict:
    """The fused backward as compiled (cudaFuncGetAttributes): registers
    and local-memory (spill) bytes a thread, static shared memory, the
    dynamic shared memory of a launch at seq 512, and the longest sequence
    it takes, which must be the one ops/attention.py gates on."""
    from bert_pytorch_tpu_torch.ops.attention import FUSED_BWD_MAX_SEQ
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    seq = PHASE2_ATTN[1]
    info = dict(load_kernels().flash_bwd_fused_info(seq))
    log(f"build: flash_bwd_fused_bf16_kernel: registers a thread "
        f"{info['dropout_registers']} (dropout arm) / "
        f"{info['plain_registers']} (rate 0), spills (local bytes a "
        f"thread) {info['dropout_local_bytes']} / "
        f"{info['plain_local_bytes']}, static shared "
        f"{info['dropout_static_smem_bytes']} B, dynamic shared at seq "
        f"{seq} {info['dynamic_smem_bytes']} B (of 232448), longest seq "
        f"{info['max_seq']}, 256 threads a CTA, one CTA a (batch, head)")
    check(info["max_seq"] == FUSED_BWD_MAX_SEQ,
          f"the fused backward takes seq up to {info['max_seq']}, "
          f"ops/attention.py gates on {FUSED_BWD_MAX_SEQ}")
    return info


# the wgmma kernels and the LayerNorm kernels, compiled alone for ptxas's
# report beside the build
PTXAS_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
                 "flash_attention_split_bwd.cu", "layernorm.cu")
# kernels whose registers and spills the report lists; a spill fails
PTXAS_WATCH = ("ln_bwd_row_kernel", "flash_bwd_dq_bf16_kernel",
               "flash_bwd_dkv_bf16_kernel")


def ptxas_entries(out: str, watch) -> dict:
    """Registers and spill bytes of each kernel entry of ptxas's -v report
    whose (mangled) name holds one of `watch`, keyed by its name and
    template arguments as mangled ("ln_bwd_row_kernelILb1EE...")."""
    entries, name = {}, None
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            hit = [w for w in watch if w in mangled]
            name = (mangled[mangled.index(hit[0]):][:40] if hit else None)
            if name:
                entries[name] = {}
        elif name and "spill stores" in ln:
            words = ln.replace(",", "").split()
            entries[name]["spill_store_bytes"] = int(
                words[words.index("spill") - 2])
            entries[name]["spill_load_bytes"] = int(
                words[words.index("loads") - 3])
        elif name and "Used" in ln and "registers" in ln:
            words = ln.replace(",", "").split()
            entries[name]["registers"] = int(
                words[words.index("registers") - 1])
    return entries


def ptxas_start():
    """Start one nvcc for each wgmma kernel's source (-Xptxas -v, the
    build's target and optimisation), to run beside the extension's
    build; a source with no PyTorch header compiles in seconds."""
    from torch.utils.cpp_extension import CUDA_HOME

    from bert_pytorch_tpu_torch.ops.kernels.build import CSRC_DIR

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ptxas_")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    procs = {}
    for src in PTXAS_SOURCES:
        procs[src] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "--expt-relaxed-constexpr", "-c",
             os.path.join(CSRC_DIR, src), "-o", os.path.join(tmp, src + ".o"),
             "-I", CSRC_DIR, "-Xptxas", "-v"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return tmp, procs


def ptxas_check(tmp, procs) -> dict:
    """ptxas's report of each source started by ptxas_start: its spill
    lines, and a failure on any C75xx line (ptxas serializing the wgmma
    pipeline, a performance loss it reports as information only)."""
    import shutil

    report = {}
    try:
        for src, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"nvcc {src} failed:\n{out[-2000:]}")
            serial = [ln.strip() for ln in out.splitlines() if "C75" in ln]
            spills = sorted({ln.strip() for ln in out.splitlines()
                             if "spill" in ln})
            watched = ptxas_entries(out, PTXAS_WATCH)
            report[src] = {"serialized": serial, "spill_lines": spills,
                           "kernels": watched}
            log(f"build: ptxas {src}: {len(serial)} wgmma serialization "
                f"notes (C75xx); spill lines {spills}"
                + (f"; {watched}" if watched else ""))
            check(not serial, f"ptxas serializes the wgmma pipeline of "
                  f"{src}: {serial}")
            check(all(e.get("spill_store_bytes", 1) == 0
                      for e in watched.values()),
                  f"ptxas spills in {src}: {watched}")
        found = [n for r in report.values() for n in r["kernels"]]
        check(all(any(w in n for n in found) for w in PTXAS_WATCH),
              f"ptxas reported none of {PTXAS_WATCH}: {found}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def forward_build(torch) -> dict:
    """The bf16 flash forward as compiled (cudaFuncGetAttributes):
    registers and local-memory (spill) bytes a thread of each of its four
    arms, its dynamic shared memory and its (query rows, keys) tile, which
    must be the one flash_tiles reports for the skip counts. A spill
    fails the phase."""
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    ext = load_kernels()
    info = dict(ext.flash_fwd_info())
    arms = ("plain", "plain_packed", "dropout", "dropout_packed")
    log("build: flash_fwd_kernel: registers a thread "
        + ", ".join(f"{a} {info[a + '_registers']}" for a in arms)
        + "; spills (local bytes a thread) "
        + ", ".join(f"{a} {info[a + '_local_bytes']}" for a in arms)
        + f"; dynamic shared {info['dynamic_smem_bytes']} B (of 232448), "
        f"{info['plain_max_threads']} threads a CTA, tile "
        f"({info['tile_rows']}, {info['tile_keys']})")
    check(all(info[a + "_local_bytes"] == 0 for a in arms),
          "the flash forward spills to local memory")
    check(tuple(ext.flash_tiles(True)["flash_attention_fwd"])
          == (info["tile_rows"], info["tile_keys"]),
          "flash_tiles and the forward disagree on its tile")
    return info


def split_backward_build(torch) -> dict:
    """The bf16 backward pair as compiled (cudaFuncGetAttributes):
    registers and local-memory (spill) bytes a thread of each arm of its
    dq and dk/dv kernels, their dynamic shared memory, and the tiles
    flash_tiles reports for the skip counts. A spill fails the phase."""
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    ext = load_kernels()
    info = dict(ext.flash_split_bwd_info())
    tiles = ext.flash_tiles(True)
    arms = ("plain", "plain_packed", "dropout", "dropout_packed")
    for kern in ("dq", "dkv"):
        log(f"build: flash_bwd_{kern}_bf16_kernel: registers a thread "
            + ", ".join(f"{a} {info[f'{kern}_{a}_registers']}" for a in arms)
            + "; spills (local bytes a thread) "
            + ", ".join(f"{a} {info[f'{kern}_{a}_local_bytes']}"
                        for a in arms)
            + f"; dynamic shared {info[kern + '_dynamic_smem_bytes']} B (of "
            f"232448), {info[kern + '_plain_max_threads']} threads a CTA, "
            f"tile {tuple(tiles['flash_attention_bwd_' + kern])}")
        check(all(info[f"{kern}_{a}_local_bytes"] == 0 for a in arms),
              f"the flash backward's {kern} kernel spills to local memory")
    return dict(info, tiles={k: list(v) for k, v in tiles.items()})


def _rel(a, b) -> float:
    """max |a - b| over max |b|: the error of an output against the
    plain version's, relative to the output's scale."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def check_training_kernels(torch, np, results):
    """Kernels #1-#4 against their plain versions at the training paths'
    shapes ((B * S, E) and (B * P, E) of phase 1, (B * S, E) of phase 2
    and of NER, classify and embed finetuning) and a tail row count (the
    worst error at each under `max_abs_err_by_rows`), f32 and bf16, rates 0
    and 0.1, a negative and a positive seed; dropped positions compared
    exactly (dx is 0 exactly where the plain mask drops), and every
    backward run twice with bit-identical results. bf16 takes the
    backward's row kernel, f32 the generic one
    (check_generic_layer_norm_bwd holds it at other widths)."""
    from bert_pytorch_tpu_torch.ops.layernorm import (
        add_dropout_layer_norm_bwd, add_dropout_layer_norm_bwd_ref,
        add_dropout_layer_norm_fwd, add_dropout_layer_norm_stats_ref,
        hash_keep_mask, layer_norm_bwd, layer_norm_bwd_ref, layer_norm_fwd,
        layer_norm_stats_ref)

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"layer_norm_fwd": dict(
        results["layer_norm_fwd"]["max_abs_err"]),
             "layer_norm_bwd": {}, "add_dropout_layer_norm_fwd": {},
             "add_dropout_layer_norm_bwd": {}}

    by_rows = {kernel: {} for kernel in worst}

    def note(kernel, name, got, want, rows):
        """worst max |a - b| over the kernel's activation-shaped outputs,
        over every row count and at each"""
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        worst[kernel][name] = max(worst[kernel].get(name, 0.0), err)
        at = by_rows[kernel].setdefault(str(rows), {})
        at[name] = max(at.get(name, 0.0), err)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        for rows in TRAIN_CHECK_ROWS:
            x = (randn(rows, HIDDEN) * 2.0 + 0.5).to(dtype)
            res = randn(rows, HIDDEN).to(dtype)
            g = randn(rows, HIDDEN).to(dtype)
            scale = 1.0 + 0.2 * randn(HIDDEN)
            bias = 0.1 * randn(HIDDEN)

            # 1 at these rows too, then 2: the LayerNorm backward from the
            # kernel forward's statistics
            y, mean, rstd = layer_norm_fwd(x, scale, bias)
            yr, mr, rr = layer_norm_stats_ref(x, scale, bias)
            torch.cuda.synchronize()
            yerr = (y.float() - yr.float()).abs().max().item()
            serr = max((mean - mr).abs().max().item(),
                       ((rstd - rr).abs() / rr).max().item())
            check(yerr <= LN_TOL[name] and serr <= 1e-5,
                  f"layer_norm {name} ({rows}): y error {yerr}, stats {serr}")
            note("layer_norm_fwd", name, [y], [yr], rows)
            got = layer_norm_bwd(x, scale, mean, rstd, g)
            again = layer_norm_bwd(x, scale, mean, rstd, g)
            want = layer_norm_bwd_ref(x, scale, mean, rstd, g)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"layer_norm_bwd {name} ({rows}): two runs differ")
            errs = [_rel(a, b) for a, b in zip(got, want)]
            log(f"kernels: layer_norm {name} ({rows}, {HIDDEN}) max|y-ref| "
                f"{yerr:.3g} (tol {LN_TOL[name]:g}), stats {serr:.3g} (tol "
                f"1e-5); layer_norm_bwd rel err dx {errs[0]:.3g} (tol "
                f"{tol['dx']:g}), dscale {errs[1]:.3g}"
                f", dbias {errs[2]:.3g} (tol {tol['sums']:g}); rerun "
                "bit-identical")
            check(errs[0] <= tol["dx"] and max(errs[1:]) <= tol["sums"],
                  f"layer_norm_bwd {name} ({rows}): errors {errs}")
            note("layer_norm_bwd", name, got[:1], want[:1], rows)

            for rate in (0.0, 0.1):
                for seed in (-1640531527, 12345):
                    # 3: the fused forward
                    y, mean, rstd = add_dropout_layer_norm_fwd(
                        x, res, scale, bias, seed, rate)
                    yr, mr, rr = add_dropout_layer_norm_stats_ref(
                        x, res, scale, bias, seed, rate)
                    torch.cuda.synchronize()
                    yerr = (y.float() - yr.float()).abs().max().item()
                    serr = max((mean - mr).abs().max().item(),
                               ((rstd - rr).abs() / rr).max().item())
                    check(yerr <= LN_TOL[name] and serr <= 1e-5,
                          f"add_dropout_layer_norm_fwd {name} ({rows}) rate "
                          f"{rate} seed {seed}: y error {yerr}, stats {serr}")
                    note("add_dropout_layer_norm_fwd", name, [y], [yr],
                         rows)
                    # 4: the fused backward, from the plain statistics
                    got = add_dropout_layer_norm_bwd(x, res, scale, mr, rr,
                                                     g, seed, rate)
                    again = add_dropout_layer_norm_bwd(x, res, scale, mr, rr,
                                                       g, seed, rate)
                    want = add_dropout_layer_norm_bwd_ref(x, res, scale, mr,
                                                          rr, g, seed, rate)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"add_dropout_layer_norm_bwd {name} ({rows}): two "
                          "runs differ")
                    errs = [_rel(a, b) for a, b in zip(got, want)]
                    dropped = 0
                    if rate > 0.0:
                        keep = hash_keep_mask(seed, x.shape, rate, x.device)
                        dropped = int((~keep).sum().item())
                        check(torch.equal(got[0] == 0, ~keep),
                              f"add_dropout_layer_norm_bwd {name} ({rows}) "
                              f"seed {seed}: dx zeros do not match the mask")
                    log(f"kernels: add_dropout_layer_norm {name} ({rows}, "
                        f"{HIDDEN}) rate {rate} seed {seed}: fwd max|y-ref| "
                        f"{yerr:.3g} (tol {LN_TOL[name]:g}), stats "
                        f"{serr:.3g}; bwd rel err dx {errs[0]:.3g} dres "
                        f"{errs[1]:.3g} (tol {tol['dx']:g}) dscale "
                        f"{errs[2]:.3g} dbias {errs[3]:.3g} (tol "
                        f"{tol['sums']:g}); {dropped} dropped, zeros exact; "
                        "rerun bit-identical")
                    check(max(errs[:2]) <= tol["dx"]
                          and max(errs[2:]) <= tol["sums"],
                          f"add_dropout_layer_norm_bwd {name} ({rows}) rate "
                          f"{rate} seed {seed}: errors {errs}")
                    note("add_dropout_layer_norm_bwd", name, got[:2],
                         want[:2], rows)
    for kernel, errs in worst.items():
        results[kernel] = {"max_abs_err": errs,
                           "max_abs_err_by_rows": by_rows[kernel]}
    check_generic_layer_norm_bwd(torch, results)


def check_generic_layer_norm_bwd(torch, results):
    """The LayerNorm backward at widths other than 1024 (ln_bwd_kernel,
    which the dispatcher keeps for them, for f32 and for unaligned
    tensors): 768 (16-byte loads) and an odd 1022 (by the element), f32 and
    bf16, #2 and #4 at rates 0 and 0.1, against the plain versions at
    TRAIN_TOL; every call run twice with bit-identical results, dx zeros
    exactly where the plain mask drops, and one launch counted a call."""
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES
    from bert_pytorch_tpu_torch.ops.layernorm import (
        add_dropout_layer_norm_bwd, add_dropout_layer_norm_bwd_ref,
        add_dropout_layer_norm_stats_ref, hash_keep_mask, layer_norm_bwd,
        layer_norm_bwd_ref, layer_norm_stats_ref)

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, seed = 1003, FLASH_SEEDS[0]
    before = (LAUNCHES["layer_norm_bwd"],
              LAUNCHES["add_dropout_layer_norm_bwd"])
    calls, worst = 0, {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for cols in GENERIC_LN_COLS:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol = TRAIN_TOL[name]
            x = (randn(rows, cols) * 2.0 + 0.5).to(dtype)
            res = randn(rows, cols).to(dtype)
            g = randn(rows, cols).to(dtype)
            scale = 1.0 + 0.2 * randn(cols)
            bias = 0.1 * randn(cols)
            _, mean, rstd = layer_norm_stats_ref(x, scale, bias)
            cases = [("plain", None,
                      lambda: layer_norm_bwd(x, scale, mean, rstd, g),
                      layer_norm_bwd_ref(x, scale, mean, rstd, g))]
            for rate in (0.0, 0.1):
                _, mr, rr = add_dropout_layer_norm_stats_ref(
                    x, res, scale, bias, seed, rate)
                cases.append((
                    f"residual rate {rate}", rate,
                    lambda mr=mr, rr=rr, rate=rate:
                        add_dropout_layer_norm_bwd(x, res, scale, mr, rr, g,
                                                   seed, rate),
                    add_dropout_layer_norm_bwd_ref(x, res, scale, mr, rr, g,
                                                   seed, rate)))
            for what, rate, fn, want in cases:
                got, again = fn(), fn()
                calls += 2
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"ln_bwd_kernel {what} {name} ({rows}, {cols}): two "
                      "runs differ")
                errs = [_rel(a, b) for a, b in zip(got, want)]
                n_act = len(got) - 2   # dx (and dres), then dscale, dbias
                zeros = ""
                if rate:
                    keep = hash_keep_mask(seed, x.shape, rate, x.device)
                    check(torch.equal(got[0] == 0, ~keep),
                          f"ln_bwd_kernel {what} {name} ({rows}, {cols}): "
                          "dx zeros do not match the mask")
                    zeros = (f"; {int((~keep).sum().item())} dropped, "
                             "zeros exact")
                log(f"kernels: layer_norm_bwd {what} {name} ({rows}, {cols}) "
                    f"(ln_bwd_kernel) rel err "
                    + ", ".join(f"{e:.3g}" for e in errs)
                    + f" (tol {tol['dx']:g} / {tol['sums']:g}); rerun "
                    f"bit-identical{zeros}")
                check(max(errs[:n_act]) <= tol["dx"]
                      and max(errs[n_act:]) <= tol["sums"],
                      f"ln_bwd_kernel {what} {name} ({rows}, {cols}): "
                      f"errors {errs}")
                worst[name] = max(worst.get(name, 0.0), max(errs[:n_act]))
    launched = (LAUNCHES["layer_norm_bwd"] - before[0]
                + LAUNCHES["add_dropout_layer_norm_bwd"] - before[1])
    log(f"kernels: ln_bwd_kernel (widths {GENERIC_LN_COLS}): {launched} "
        f"launches for {calls} wrapper calls")
    check(launched == calls, f"ln_bwd_kernel checks: {launched} launches "
          f"counted for {calls} calls")
    results["layer_norm_bwd_generic"] = {
        "widths": list(GENERIC_LN_COLS), "launches": launched,
        "max_rel_err": worst}


def padding_bias(torch, np, rng, batch: int, seq: int, lo=None):
    """(B, 1, 1, S) f32 padding bias of rows with real lengths lo..S
    (default S/2..S)."""
    from bert_pytorch_tpu_torch.ops.attention import make_attention_bias

    mask = np.zeros((batch, seq), np.int32)
    lo = seq // 2 if lo is None else lo
    for r, ln in enumerate(rng.randint(lo, seq + 1, batch)):
        mask[r, :ln] = 1
    return make_attention_bias(torch.from_numpy(mask).cuda()).contiguous()


def check_flash_training_kernels(torch, np, results, shape=PHASE2_ATTN,
                                 lo=None, key="train_phase2", heads=HEADS):
    """The flash kernels of a training path at `shape` x (16, 64), f32
    and bf16 (phase 2's (16, 512); SQuAD's (32, 384), `key`
    "finetune_squad", with padding from `lo` tokens): the forward's
    dropout arm against its plain version (rate 0.1, two seeds; lse
    unchanged by the rate), probes that read the dropout mask out of the
    forward and out of dv exactly, and the backward pair (f32 and bf16)
    and the fused backward (bf16, the main path's) against
    flash_attention_bwd_ref at rates 0 and 0.1 and once with packed
    segments (pad-row dq exactly 0, skip counts as the layout predicts),
    every backward run twice with bit-identical results (backward_case).
    Phase 2's errors land in the kernels' results, another key's under
    that key. `heads`: 16 (BERT-Large), 12 for the distilled student."""
    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_ref, flash_keep_all,
        make_attention_bias)

    batch, seq = shape
    rate = 0.1
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.RandomState(4)
    bias = padding_bias(torch, np, rng, batch, seq, lo)
    seg_np = packed_segments(np, rng, batch, seq)
    seg = torch.from_numpy(seg_np).cuda()
    seg_bias = make_attention_bias((seg > 0).int()).contiguous()
    fwd_err, bwd_err, bwd_abs, probes = {}, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        qkv = torch.randn(batch, seq, 3, heads, HEAD_DIM, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(batch, seq, heads, HEAD_DIM, generator=gen,
                         device="cuda").to(dtype)
        _, lse0 = flash_attention(q, k, v, bias)
        # the forward's dropout arm
        for seed in FLASH_SEEDS:
            out, lse = flash_attention(q, k, v, bias, None, seed, rate)
            ref, lse_ref = flash_attention_ref(q, k, v, bias, None, seed,
                                               rate)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lerr = (lse - lse_ref).abs().max().item()
            log(f"kernels: flash_attention {name} ({batch}, {seq}, {heads}, "
                f"{HEAD_DIM}) rate {rate} seed {seed}: max|out-ref| "
                f"{err:.3g} (tol {FLASH_TOL[name]:g}), max|lse-ref| "
                f"{lerr:.3g} (tol {LSE_TOL:g}), lse equal to rate 0's: "
                f"{torch.equal(lse, lse0)}")
            check(err <= FLASH_TOL[name] and lerr <= LSE_TOL,
                  f"flash {name} rate {rate} seed {seed}: out error {err}, "
                  f"lse error {lerr}")
            check(torch.equal(lse, lse0), f"flash {name}: lse moved with "
                  "the dropout rate")
            fwd_err[name] = max(fwd_err.get(name, 0.0), err)

        # the backward pair: rates 0 and 0.1 over the padding bias, then
        # packed segments (pad rows' cotangent zero, as the model gives)
        for r, sd, sg, bs in backward_cases(bias, seg, seg_bias, rate):
            backward_case(torch, np, (q, k, v, do), bs, sg, sd, r, seg_np,
                          fwd_err, bwd_err, bwd_abs)

        # the mask, exactly: q = k = 0, the bias admitting the 64 keys
        # [w_b, w_b + 64) of batch row b, v[k, d] = (k mod 64 == d): out[b,
        # q, h, d] = keep / (64 (1 - rate)) at key w_b + d. And dv with dO
        # one-hot on the queries [qw, qw + 64): dv[b, k, h, d] = p_drop at
        # (qw + d, k), zero exactly where that pair is dropped.
        seed = FLASH_SEEDS[0]
        zeros = torch.zeros(batch, seq, heads, HEAD_DIM, device="cuda",
                            dtype=dtype)
        win = [(64 * b) % seq for b in range(batch)]
        allow = torch.zeros(batch, seq, device="cuda")
        for b, w in enumerate(win):
            allow[b, w:w + 64] = 1
        wbias = ((1.0 - allow) * -10000.0)[:, None, None, :].contiguous()
        pos = torch.arange(seq, device="cuda")
        onehot = (pos[:, None] % 64 == torch.arange(HEAD_DIM, device="cuda"))
        vp = onehot[None, :, None, :].expand(batch, seq, heads,
                                             HEAD_DIM).to(dtype).contiguous()
        out, lse = flash_attention(zeros, zeros, vp, wbias, None, seed, rate)
        qw = 128
        dop = torch.zeros_like(zeros)
        dop[:, qw:qw + 64] = onehot[:64, None, :].to(dtype)
        dq, delta = flash_attention_bwd_dq(zeros, zeros, vp, wbias, None,
                                           out, lse, dop, seed, rate)
        _, dv = flash_attention_bwd_dkv(zeros, zeros, vp, wbias, None, lse,
                                        delta, dop, seed, rate)
        dvs = {"pair": dv}
        if dtype == torch.bfloat16:
            dvs["fused"] = flash_attention_bwd(zeros, zeros, vp, wbias, None,
                                               out, lse, dop, seed, rate)[2]
        keep = flash_keep_all(seed, batch, heads, seq, rate, "cuda")
        fwd_ok = True
        dv_ok = {kern: True for kern in dvs}
        dropped = [0, 0]
        for b, w in enumerate(win):
            # (H, S, 64): out[b, q, h, d] read at key w + d
            got = out[b, :, :, :].permute(1, 0, 2) != 0
            want_keep = keep[b, :, :, w:w + 64]
            fwd_ok &= torch.equal(got, want_keep)
            # (H, 64 keys, 64 d): dv[b, w + j, h, d] at query qw + d
            want_dv = keep[b, :, qw:qw + 64, w:w + 64].transpose(1, 2)
            for kern, dv_ in dvs.items():
                got_dv = dv_[b, w:w + 64].permute(1, 0, 2) != 0
                dv_ok[kern] &= torch.equal(got_dv, want_dv)
            dropped[0] += int((~want_keep).sum().item())
            dropped[1] += int((~want_dv).sum().item())
        torch.cuda.synchronize()
        log(f"kernels: flash dropout mask probe {name} seed {seed}: forward "
            f"reads {dropped[0]} dropped of {batch * heads * seq * 64}, "
            f"equal to flash_keep_mask: {fwd_ok}; dv reads {dropped[1]} "
            f"dropped of {batch * heads * 64 * 64}, equal: {dv_ok}")
        check(fwd_ok and all(dv_ok.values()), f"flash {name}: the mask "
              f"read from the kernels differs from flash_keep_mask "
              f"(forward {fwd_ok}, dv {dv_ok})")
        probes[name] = {"forward_dropped": dropped[0],
                        "dv_dropped": dropped[1],
                        "dv_kernels": sorted(dvs)}
    results["flash_attention_fwd"][key] = {
        "max_abs_err": fwd_err, "mask_probes": probes,
        "shape": [batch, seq, heads, HEAD_DIM]}
    for kern in ("dq", "dkv", "fused"):
        name = "flash_attention_bwd" + ("" if kern == "fused" else "_" + kern)
        errs = {"max_abs_err": bwd_abs[kern], "max_rel_err": bwd_err[kern]}
        if key == "train_phase2":
            results[name] = errs
        else:
            results.setdefault(name, {})[key] = errs


def check_squad_predict_flash(torch, np, results):
    """The flash forward at SQuAD predict's 384 bucket (8, 384, 16, 64),
    rate 0, padding biases of windows 150-384 long, f32 and bf16: against
    its plain version, and twice with the same bits."""
    from bert_pytorch_tpu_torch.ops.attention import (flash_attention,
                                                      flash_attention_ref)

    batch, seq = SQUAD_PREDICT_ATTN
    gen = torch.Generator(device="cuda").manual_seed(9)
    bias = padding_bias(torch, np, np.random.RandomState(9), batch, seq,
                        SQUAD_MIN_LEN)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        qkv = torch.randn(batch, seq, 3, HEADS, HEAD_DIM, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, lse = flash_attention(q, k, v, bias)
        again, _ = flash_attention(q, k, v, bias)
        ref, lse_ref = flash_attention_ref(q, k, v, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        same = torch.equal(out, again)
        log(f"kernels: flash_attention {name} SQuAD predict ({batch}, {seq},"
            f" {HEADS}, {HEAD_DIM}) rate 0: max|out-ref| {err:.3g} (tol "
            f"{FLASH_TOL[name]:g}), max|lse-ref| {lerr:.3g} (tol "
            f"{LSE_TOL:g}), rerun bit-identical: {same}")
        check(err <= FLASH_TOL[name] and lerr <= LSE_TOL and same,
              f"flash {name} ({batch}, {seq}) rate 0: out error {err}, lse "
              f"error {lerr}, rerun identical {same}")
        errs[name] = err
    results["flash_attention_fwd"]["squad_predict"] = {
        "max_abs_err": errs, "shape": [batch, seq, HEADS, HEAD_DIM]}


def backward_cases(bias, seg, seg_bias, rate):
    """(rate, seed, segment ids, bias) of the backward checks: rate 0, the
    rate with both FLASH_SEEDS over the padding bias, and packed segments
    at the rate."""
    cases = [(r, sd, None, bias) for r in (0.0, rate)
             for sd in ((None,) if r == 0.0 else FLASH_SEEDS)]
    cases.append((rate, FLASH_SEEDS[0], seg, seg_bias))
    return cases


def backward_case(torch, np, tensors, bs, sg, sd, r, seg_np, fwd_err,
                  bwd_err, bwd_abs):
    """One backward case of the flash kernels: the forward at (bs, sg, sd,
    r) against its plain version, then the dq and dk/dv pair against
    flash_attention_bwd_ref within FLASH_BWD_TOL, run twice with
    bit-identical results, delta against its plain version, and with
    packed segments pad-row dq exactly 0 and each kernel's skip count (the
    forward's too) as its tiles predict; where the fused backward takes
    the shape (bf16, seq <= FUSED_BWD_MAX_SEQ) it gets the same checks
    (check_fused_backward).
    The worst errors land in fwd_err / bwd_err / bwd_abs by dtype."""
    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_ref, flash_attention_delta_ref,
        flash_attention_ref, fused_bwd_takes)
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    q, k, v, do = tensors
    dtype = q.dtype
    name = str(dtype).split(".")[-1]
    batch, seq = q.shape[:2]
    g = do if sg is None else do * (sg > 0).to(dtype)[:, :, None, None]
    fwd_skips = torch.zeros(1, dtype=torch.int32, device="cuda")
    out, lse = flash_attention(q, k, v, bs, sg, sd, r, skipped=fwd_skips)
    if sg is not None:
        # the forward's tile skip as its tiles predict, at this length
        tile = load_kernels().flash_tiles(dtype == torch.bfloat16)[
            "flash_attention_fwd"]
        want_fwd = expected_skips(np, seg_np, *tile, q.shape[2])
        check(int(fwd_skips.item()) == want_fwd and want_fwd > 0,
              f"flash forward {name} {tuple(q.shape)} packed rate {r}: "
              f"skipped {int(fwd_skips.item())}, layout predicts {want_fwd}")
    # every arm of the forward (rate 0 or not, packed or not) against its
    # plain version before it feeds the backward
    ref, lse_ref = flash_attention_ref(q, k, v, bs, sg, sd, r)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lerr = (lse - lse_ref).abs().max().item()
    pad_max = out[sg == 0].abs().max().item() if sg is not None else 0.0
    check(err <= FLASH_TOL[name] and lerr <= LSE_TOL and pad_max == 0.0,
          f"flash {name} {tuple(q.shape)} rate {r} seed {sd} packed "
          f"{sg is not None}: out error {err}, lse error {lerr}, pad rows "
          f"{pad_max}")
    fwd_err[name] = max(fwd_err.get(name, 0.0), err)
    del ref, lse_ref
    skips = [torch.zeros(1, dtype=torch.int32, device="cuda")
             for _ in range(2)]
    dq, delta = flash_attention_bwd_dq(q, k, v, bs, sg, out, lse, g, sd, r,
                                       skipped=skips[0])
    dk, dv = flash_attention_bwd_dkv(q, k, v, bs, sg, lse, delta, g, sd, r,
                                     skipped=skips[1])
    dq2, delta2 = flash_attention_bwd_dq(q, k, v, bs, sg, out, lse, g, sd, r)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, bs, sg, lse, delta2, g, sd, r)
    want = flash_attention_bwd_ref(q, k, v, bs, sg, out, lse, g, sd, r)
    delta_ref = flash_attention_delta_ref(out, g)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in
              ((dq, dq2), (dk, dk2), (dv, dv2), (delta, delta2))),
          f"flash backward {name} {tuple(q.shape)} rate {r}: two runs differ")
    errs = [_rel(a, b) for a, b in zip((dq, dk, dv), want)]
    derr = _rel(delta, delta_ref)
    what = ("packed segments" if sg is not None
            else f"padding bias, rate {r} seed {sd}")
    line = (f"kernels: flash backward {name} {tuple(q.shape)} {what}: rel "
            f"err dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (tol "
            f"{FLASH_BWD_TOL[name]:g}), delta {derr:.3g}; rerun "
            "bit-identical")
    if sg is not None:
        pad_dq = dq[sg == 0].abs().max().item()
        tiles = load_kernels().flash_tiles(dtype == torch.bfloat16)
        want_skips = [expected_skips(
            np, seg_np, *tiles[f"flash_attention_bwd_{kern}"], q.shape[2])
            for kern in ("dq", "dkv")]
        got_skips = [int(c.item()) for c in skips]
        line += (f"; pad-row dq max {pad_dq}; tiles skipped {got_skips} "
                 f"(layout predicts {want_skips}), the forward's "
                 f"{int(fwd_skips.item())}")
        check(pad_dq == 0.0, f"flash backward {name}: pad-row dq {pad_dq}")
        check(got_skips == want_skips and min(got_skips) > 0,
              f"flash backward {name} {tuple(q.shape)}: skipped "
              f"{got_skips}, layout predicts {want_skips}")
    log(line)
    check(max(errs) <= FLASH_BWD_TOL[name] and derr <= 1e-5,
          f"flash backward {name} {tuple(q.shape)} {what}: errors {errs}, "
          f"delta {derr}")
    abs_errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip((dq, dk, dv), want)]
    for kern, sl in (("dq", slice(0, 1)), ("dkv", slice(1, 3))):
        for acc, vals in ((bwd_err, errs), (bwd_abs, abs_errs)):
            acc.setdefault(kern, {})
            acc[kern][name] = max(acc[kern].get(name, 0.0), *vals[sl])
    if fused_bwd_takes(q):
        check_fused_backward(torch, np, (q, k, v, bs, sg, out, lse, g, sd,
                                         r), want, what, seg_np, bwd_err,
                             bwd_abs)


# The backward pair beyond phase 2's shape, at the same 8192 tokens: the
# lengths where the fused backward's gate sends bf16 to the pair.
PAIR_LONG_SHAPES = ((8, 1024), (4, 2048))


def check_pair_long(torch, np, results):
    """The dq and dk/dv pair at PAIR_LONG_SHAPES x 16 heads, f32 and bf16,
    through backward_case: rates 0 and 0.1 with both FLASH_SEEDS over a
    padding bias, and packed segments; per shape the worst errors land in
    results[dq or dkv]["long"]."""
    rate = 0.1
    gen = torch.Generator(device="cuda").manual_seed(6)
    rng = np.random.RandomState(6)
    from bert_pytorch_tpu_torch.ops.attention import make_attention_bias

    for batch, seq in PAIR_LONG_SHAPES:
        bias = padding_bias(torch, np, rng, batch, seq)
        seg_np = packed_segments(np, rng, batch, seq)
        seg = torch.from_numpy(seg_np).cuda()
        seg_bias = make_attention_bias((seg > 0).int()).contiguous()
        fwd_err, bwd_err, bwd_abs = {}, {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(batch, seq, 3, HEADS, HEAD_DIM, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.randn(batch, seq, HEADS, HEAD_DIM, generator=gen,
                             device="cuda").to(dtype)
            for r, sd, sg, bs in backward_cases(bias, seg, seg_bias, rate):
                backward_case(torch, np, (q, k, v, do), bs, sg, sd, r,
                              seg_np, fwd_err, bwd_err, bwd_abs)
            del qkv, q, k, v, do
        for kern in ("dq", "dkv"):
            results["flash_attention_bwd_" + kern].setdefault("long", {})[
                f"{batch}x{seq}"] = {"max_abs_err": bwd_abs[kern],
                                     "max_rel_err": bwd_err[kern]}


def check_fused_backward(torch, np, args, want, what, seg_np, bwd_err,
                         bwd_abs):
    """The fused dq/dk/dv kernel on one backward case of
    check_flash_training_kernels (bf16): against the plain version's
    `want` within FLASH_BWD_TOL, run twice with bit-identical results,
    and with packed segments pad-row dq exactly 0 and the skip count of
    its (64-query, 128-key) tiles as the layout predicts."""
    from bert_pytorch_tpu_torch.ops.attention import flash_attention_bwd
    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

    q, k, v, bs, sg, out, lse, g, sd, r = args
    skipped = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = flash_attention_bwd(q, k, v, bs, sg, out, lse, g, sd, r,
                              skipped=skipped)
    again = flash_attention_bwd(q, k, v, bs, sg, out, lse, g, sd, r)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"fused flash backward {what}: two runs differ")
    errs = [_rel(a, b) for a, b in zip(got, want)]
    line = (f"kernels: fused flash backward bfloat16 {tuple(q.shape)} "
            f"{what}: rel err dq {errs[0]:.3g} dk {errs[1]:.3g} dv "
            f"{errs[2]:.3g} (tol {FLASH_BWD_TOL['bfloat16']:g}); rerun "
            "bit-identical")
    if sg is not None:
        pad_dq = got[0][sg == 0].abs().max().item()
        tile = load_kernels().flash_tiles(True)["flash_attention_bwd"]
        want_skips = expected_skips(np, seg_np, *tile, q.shape[2])
        got_skips = int(skipped.item())
        line += (f"; pad-row dq max {pad_dq}; tiles {tuple(tile)} skipped "
                 f"{got_skips} (layout predicts {want_skips})")
        check(pad_dq == 0.0, f"fused flash backward: pad-row dq {pad_dq}")
        check(got_skips == want_skips and got_skips > 0,
              f"fused flash backward: skipped {got_skips}, layout predicts "
              f"{want_skips}")
    log(line)
    check(max(errs) <= FLASH_BWD_TOL["bfloat16"],
          f"fused flash backward {what}: errors {errs}")
    abs_errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
    for acc, vals in ((bwd_err, errs), (bwd_abs, abs_errs)):
        acc.setdefault("fused", {})
        acc["fused"]["bfloat16"] = max(acc["fused"].get("bfloat16", 0.0),
                                       *vals)


def bert_large_lamb_state(torch, gen, g_dtype):
    """LAMB's lists over BERT-Large's 302 parameter tensors (names and
    shapes from the pretraining model built on the meta device, vocab
    30528) on the card: gradients in `g_dtype`, f32 moments (nu >= 0),
    f32 parameters, and each tensor's weight decay."""
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining
    from bert_pytorch_tpu_torch.optim.lamb import default_weight_decay_mask

    config = BertConfig.from_json_file(os.path.join(
        HERE, "configs", "bert_large_uncased_config.json"))
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    with torch.device("meta"):
        shapes = [(k, p.shape) for k, p in
                  BertForPreTraining(config).named_parameters()]

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return {"names": [k for k, _ in shapes],
            "g": [randn(s, 0.01).to(g_dtype) for _, s in shapes],
            "mu": [randn(s, 1e-3) for _, s in shapes],
            "nu": [randn(s, 1e-3).square() for _, s in shapes],
            "p": [randn(s, 0.02) for _, s in shapes],
            "wd": [0.01 if default_weight_decay_mask(k) else 0.0
                   for k, _ in shapes]}


def bert_large_shard_lamb_state(torch, gen, g_dtype, rank: int = 1,
                                world: int = 2):
    """LAMB's lists over rank `rank`'s pieces of BERT-Large's parameters
    under ZeRO-1 over `world` ranks (parallel/zero.FlatLayout): views of
    one flat f32 parameter buffer and of the rank's shard buffers (bf16 or
    f32 gradients, f32 moments), tensors cut by a shard boundary among
    them, each piece with its tensor's weight decay."""
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining
    from bert_pytorch_tpu_torch.optim.lamb import default_weight_decay_mask
    from bert_pytorch_tpu_torch.parallel.zero import FlatLayout

    config = BertConfig.from_json_file(os.path.join(
        HERE, "configs", "bert_large_uncased_config.json"))
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    with torch.device("meta"):
        named = list(BertForPreTraining(config).named_parameters())
    layout = FlatLayout([k for k, _ in named], [p.shape for _, p in named],
                        world)
    pieces = layout.pieces(rank)
    n = layout.shard_total

    def randn(count, scale=1.0):
        return torch.randn(count, generator=gen, device="cuda") * scale

    flat_p = randn(layout.total, 0.02)
    g, mu, nu = randn(n, 0.01).to(g_dtype), randn(n, 1e-3), \
        randn(n, 1e-3).square()

    def at(buf, pc):
        return buf[pc.compact:pc.compact + pc.hi - pc.lo]

    cut = sum(1 for pc in pieces
              if pc.hi - pc.lo < layout.shape[pc.name].numel())
    return {"g": [at(g, pc) for pc in pieces],
            "mu": [at(mu, pc) for pc in pieces],
            "nu": [at(nu, pc) for pc in pieces],
            "p": [flat_p[pc.lo:pc.hi] for pc in pieces],
            "wd": [0.01 if default_weight_decay_mask(pc.name) else 0.0
                   for pc in pieces], "cut": cut}


def odd_lamb_state(torch, gen, g_dtype):
    """Lists the BERT-Large list lacks: sizes 1-3 and around the 4-element
    vectors and the kernels' chunk, and views that start off a 16-byte
    (f32) or 8-byte (bf16 gradient) boundary, which take the scalar path."""
    from bert_pytorch_tpu_torch.ops.fused_optim import CHUNK

    sizes = [1, 2, 3, 5, 7, 4095, 4097, CHUNK - 1, CHUNK + 1,
             3 * CHUNK + 6, 1000]
    out = {"g": [], "mu": [], "nu": [], "p": [], "wd": []}
    for i, n in enumerate(sizes):
        shift = i % 3                     # every third tensor aligned
        base = {k: torch.randn(n + shift, generator=gen, device="cuda")
                for k in ("g", "mu", "nu", "p")}
        out["g"].append((base["g"] * 0.01).to(g_dtype)[shift:])
        out["mu"].append((base["mu"] * 1e-3)[shift:])
        out["nu"].append((base["nu"] * 1e-3).square()[shift:])
        out["p"].append((base["p"] * 0.02)[shift:])
        out["wd"].append(0.01 if i % 2 else 0.0)
    return out


def check_lamb_kernels(torch, np, results):
    """Kernels #11 and #12 against their plain versions on the card, bit
    for bit: over BERT-Large's parameter list with bf16 gradients (the
    training path's), the same with f32 gradients, over the pieces rank 1
    of 2 updates under ZeRO-1 (views of flat buffers, tensors cut by its
    slice's boundaries) with bf16 gradients, and the odd list; stage
    1's mu, nu and u, stage 2's product and its fused apply to p; every
    kernel run twice with identical bits."""
    from bert_pytorch_tpu_torch.ops.fused_optim import (
        lamb_stage1, lamb_stage1_ref, lamb_stage2, lamb_stage2_ref)

    gen = torch.Generator(device="cuda").manual_seed(6)
    args = dict(denom=torch.full((), 1.37, device="cuda"),
                c1=float(np.float32(1.0) - np.float32(0.9) ** np.float32(3)),
                c2=float(np.float32(1.0) - np.float32(0.999) ** np.float32(3)),
                b1=0.9, b2=0.999, eps=1e-6)
    worst = {"lamb_stage1": {}, "lamb_stage2": {}}
    for what, make, g_dtype in (
            ("BERT-Large", bert_large_lamb_state, torch.bfloat16),
            ("BERT-Large", bert_large_lamb_state, torch.float32),
            ("BERT-Large's ZeRO-1 pieces of rank 1 of 2",
             bert_large_shard_lamb_state, torch.bfloat16),
            ("odd sizes and views", odd_lamb_state, torch.bfloat16),
            ("odd sizes and views", odd_lamb_state, torch.float32)):
        name = str(g_dtype).split(".")[-1]
        st = make(torch, gen, g_dtype)
        if "cut" in st:
            # a tensor cut by the rank's slice boundary appears as a piece
            check(st["cut"] > 0, f"{what}: no tensor is cut by a boundary")
            name = "shard_pieces"
        n_el = sum(x.numel() for x in st["g"])
        runs = []
        for fn in (lamb_stage1, lamb_stage1, lamb_stage1_ref):
            mu = [x.clone() for x in st["mu"]]
            nu = [x.clone() for x in st["nu"]]
            u = fn(st["g"], mu, nu, st["p"], st["wd"], **args)
            runs.append((mu, nu, u))
        torch.cuda.synchronize()
        same = [all(torch.equal(a, b) for a, b in zip(runs[0][j], runs[i][j]))
                for i in (1, 2) for j in range(3)]
        err = max((a - b).abs().max().item() for j in range(3)
                  for a, b in zip(runs[0][j], runs[2][j]))
        check(all(same[:3]), f"lamb_stage1 {what} {name}: two runs differ")
        check(all(same[3:]), f"lamb_stage1 {what} {name}: mu, nu, u differ "
              f"from the plain version (equal: {same[3:]}, max|diff| {err})")
        u = runs[2][2]
        del runs
        t = torch.randn(len(u), generator=gen, device="cuda") * 1e-3
        prods = [lamb_stage2(t, u), lamb_stage2(t, u), lamb_stage2_ref(t, u)]
        applied = []
        for fn in (lamb_stage2, lamb_stage2, lamb_stage2_ref):
            p = [x.clone() for x in st["p"]]
            fn(t, u, p)
            applied.append(p)
        torch.cuda.synchronize()
        ok2 = [all(torch.equal(a, b) for a, b in zip(r[0], r[i]))
               for r in (prods, applied) for i in (1, 2)]
        err2 = max((a - b).abs().max().item() for r in (prods, applied)
                   for a, b in zip(r[0], r[2]))
        check(all(ok2), f"lamb_stage2 {what} {name}: reruns / plain version "
              f"differ (equal: {ok2}, max|diff| {err2})")
        log(f"kernels: lamb_stage1 {what} ({len(u)} tensors, {n_el} "
            f"elements) {name} gradients: mu, nu, u bit-equal to the plain "
            f"version, rerun bit-identical; lamb_stage2 t * u and p += t * u "
            f"bit-equal, rerun bit-identical")
        for kern, e in (("lamb_stage1", err), ("lamb_stage2", err2)):
            worst[kern][name] = max(worst[kern].get(name, 0.0), e)
        del st, u, prods, applied
    for kern, errs in worst.items():
        results[kern] = {"max_abs_err": errs}


def phase_timing(torch, np, results, peaks):
    """Every row as the device's time alone (`hide_host`), kernel, plain
    version and library call alike."""
    import torch.nn.functional as F

    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_ref, make_attention_bias,
        make_segment_attention_bias)
    from bert_pytorch_tpu_torch.ops.layernorm import (layer_norm_fwd,
                                                      layer_norm_ref)

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bw = peaks["bytes_per_s"]

    # LayerNorm at the 512 bucket, bf16 (the serving dtype), f32 scale and
    # bias as the model keeps them; F.layer_norm on a CUDA bf16 x refuses
    # f32 ones (it wants one dtype), so the yardstick takes them in bf16
    rows = BATCH_ROWS * 512
    x = torch.randn(rows, HIDDEN, generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(HIDDEN, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(HIDDEN, generator=gen, device="cuda")
    scale16, bias16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    nbytes = 2 * rows * HIDDEN * 2 + 2 * HIDDEN * 4 + 2 * rows * 4
    nops = 8 * rows * HIDDEN
    bound = max(nbytes / bw, nops / peaks["f32_flops"]) * 1e3
    results["layer_norm_fwd"].update({
        "shape": [rows, HIDDEN], "dtype": "bfloat16",
        "library_dtypes": "bf16 x, bf16 scale and bias (kernel: f32 ones)",
        "ms": timer(lambda: layer_norm_fwd(x, scale, bias), hide_host=True),
        "plain_ms": timer(lambda: layer_norm_ref(x, scale, bias),
                          hide_host=True),
        "library_ms": timer(lambda: F.layer_norm(
            x, (HIDDEN,), scale16, bias16, 1e-12), hide_host=True),
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw >= nops / peaks["f32_flops"]
        else "operations",
        "bytes": nbytes, "operations": nops})

    # flash attention at the 512 bucket, bf16, packed
    batch, seq = BATCH_ROWS, 512
    seg_np = packed_segments(np, np.random.RandomState(1), batch, seq)
    seg = torch.from_numpy(seg_np).cuda()
    pad_bias = make_attention_bias((seg > 0).int())
    qkv = torch.randn(batch, seq, 3, HEADS, HEAD_DIM, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    mask = (pad_bias + make_segment_attention_bias(seg)).to(torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    elems = batch * seq * HEADS * HEAD_DIM
    nbytes = 4 * elems * 2 + batch * HEADS * seq * 4 + 2 * batch * seq * 4
    nops = 4 * HEAD_DIM * allowed_pairs(np, seg_np) * HEADS
    t_bytes, t_ops = nbytes / bw, nops / peaks["bf16_flops"]
    results["flash_attention_fwd"].update({
        "shape": [batch, seq, HEADS, HEAD_DIM], "dtype": "bfloat16",
        "ms": timer(lambda: flash_attention(q, k, v, pad_bias, seg),
                    hide_host=True),
        "plain_ms": timer(lambda: flash_attention_ref(q, k, v, pad_bias,
                                                      seg), hide_host=True),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), hide_host=True),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "operations": nops,
        "dense_operations": 4 * HEAD_DIM * batch * seq * seq * HEADS})
    time_training_kernels(torch, results, peaks, timer)
    time_flash_training_kernels(torch, np, results, peaks, timer)
    time_flash_training_kernels(torch, np, results, peaks, timer,
                                SQUAD_ATTN, SQUAD_MIN_LEN, "finetune_squad")
    time_flash_training_kernels(torch, np, results, peaks, timer,
                                SQUAD_ATTN, SQUAD_MIN_LEN, "distill_squad",
                                heads=STUDENT_HEADS)
    time_student_layer_norm(torch, results, peaks, timer)
    time_pair(torch, np, results, peaks, timer)
    time_lamb_kernels(torch, np, results, peaks, timer)
    for name in KERNEL_ROWS:
        r = results[name]
        lib = r["library_ms"]
        log(f"timing: {name} {r['shape']} {r['dtype']}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            + (f"{lib:.4f} ms" if lib is not None else "none")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def _row_col_keep_int64(torch, seed, rows, cols, rate, device):
    """row_col_keep emulated in int64 with a mask after every multiply:
    the other emulation the port could use, timed against its int32 one."""
    m = 0xFFFFFFFF
    r = torch.arange(rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    h = ((r[:, None] * 0x9E3779B1) & m) ^ ((c[None, :] * 0x85EBCA77) & m)
    h = h ^ (((seed & m) * 0xC2B2AE3D) & m)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & m
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & m
    return h > int(rate * float(2 ** 32))


def launch_split(torch, timer, fn, reps: int = 25) -> dict:
    """Mean device ms of each launch of a LayerNorm backward call, by
    kernel: its row pass (`row_ms`: a kernel named ln_bwd...) and its
    column pass (`column_ms`: column_sum_kernel), by torch.profiler over
    `reps` calls with the L2 flushed before each; each a mean over the
    launches the profiler recorded (`row_launches`, `column_launches`,
    which should be `reps`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = {"row": 0.0, "column": 0.0}
    count = {"row": 0, "column": 0}
    for ev in prof.key_averages():
        if "column_sum" in ev.key:
            kind = "column"
        elif "ln_bwd" in ev.key:
            kind = "row"
        else:
            continue
        total[kind] += _device_ms(ev)
        count[kind] += ev.count
    out = {}
    for kind in total:
        out[f"{kind}_ms"] = total[kind] / max(count[kind], 1)
        out[f"{kind}_launches"] = count[kind]
    return out


def time_training_kernels(torch, results, peaks, timer):
    """#2-#4 at phase 1's (B * S, E) = (12288, 1024) bf16, rate 0.1, and
    the backwards #2 and #4 also at phase 2's (8192, 1024) (`phase2`),
    each as the device's time alone, the backwards also by launch (row
    pass, column pass); bound = bytes moved (each input read once, each
    output written once) over the memory rate, or the f32 operations over
    the f32 peak. And the plain hash_dropout over the attention
    probabilities, whose mask the port emulates in int32 (timed beside the
    int64 emulation)."""
    from bert_pytorch_tpu_torch.ops.attention import hash_dropout
    from bert_pytorch_tpu_torch.ops.layernorm import (
        add_dropout_layer_norm_bwd, add_dropout_layer_norm_bwd_ref,
        add_dropout_layer_norm_fwd, add_dropout_layer_norm_stats_ref,
        hash_keep_mask, layer_norm_bwd, layer_norm_bwd_ref, layer_norm_fwd)

    gen = torch.Generator(device="cuda").manual_seed(3)
    e, seed, rate = HIDDEN, -1640531527, 0.1
    bf = torch.bfloat16
    scale = torch.ones(e, device="cuda")
    bias = torch.zeros(e, device="cuda")
    scale16 = scale.to(bf)
    vec = 2 * e * 4

    def row(rows, nbytes, nops, **kw):
        t_bytes = nbytes / peaks["bytes_per_s"]
        t_ops = nops / peaks["f32_flops"]
        return dict(kw, shape=[rows, e], dtype="bfloat16",
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, operations=nops)

    for rows in (TRAIN_ROWS[0], PHASE2_LN_ROWS):
        n = rows * e
        stats = 2 * rows * 4
        x = torch.randn(rows, e, generator=gen, device="cuda").to(bf)
        res = torch.randn(rows, e, generator=gen, device="cuda").to(bf)
        g = torch.randn(rows, e, generator=gen, device="cuda").to(bf)
        _, mean, rstd = layer_norm_fwd(x, scale, bias)
        ln = lambda: layer_norm_bwd(x, scale, mean, rstd, g)  # noqa: E731
        adln = lambda: add_dropout_layer_norm_bwd(  # noqa: E731
            x, res, scale, mean, rstd, g, seed, rate)
        times = {
            "layer_norm_bwd": row(
                rows, 3 * n * 2 + stats + e * 4 + vec, 11 * n,
                ms=timer(ln, hide_host=True),
                plain_ms=timer(lambda: layer_norm_bwd_ref(
                    x, scale, mean, rstd, g), hide_host=True),
                library_ms=timer(
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        g, x, [e], mean[:, None], rstd[:, None], scale16,
                        scale16, [True, True, True]), hide_host=True),
                **launch_split(torch, timer, ln)),
            "add_dropout_layer_norm_bwd": row(
                rows, 5 * n * 2 + e * 4 + stats + vec, 28 * n, rate=rate,
                ms=timer(adln, hide_host=True),
                plain_ms=timer(lambda: add_dropout_layer_norm_bwd_ref(
                    x, res, scale, mean, rstd, g, seed, rate),
                    hide_host=True),
                library_ms=None, **launch_split(torch, timer, adln))}
        if rows == TRAIN_ROWS[0]:
            for name, r in times.items():
                results[name].update(r)
            results["add_dropout_layer_norm_fwd"].update(row(
                rows, 3 * n * 2 + 2 * e * 4 + stats, 20 * n, rate=rate,
                ms=timer(lambda: add_dropout_layer_norm_fwd(
                    x, res, scale, bias, seed, rate), hide_host=True),
                plain_ms=timer(lambda: add_dropout_layer_norm_stats_ref(
                    x, res, scale, bias, seed, rate), hide_host=True),
                library_ms=None))
        else:
            for name, r in times.items():
                results[name]["phase2"] = r
    for name in ("layer_norm_bwd", "add_dropout_layer_norm_bwd"):
        for r in (results[name], results[name]["phase2"]):
            log(f"timing: {name} {r['shape']}: row pass {r['row_ms']:.4f} "
                f"ms, column pass {r['column_ms']:.4f} ms (profiler, mean "
                f"of {r['row_launches']} / {r['column_launches']} "
                f"launches); the wrapper {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms")

    # hash_dropout over phase 1's attention probabilities (96, 16, 128,
    # 128) bf16: 48 calls per microbatch (24 forward, 24 backward)
    shape = (96, 16, 128, 128)
    probs = torch.rand(*shape, generator=gen, device="cuda").to(bf)
    r_all = shape[0] * shape[1] * shape[2]
    m32 = hash_keep_mask(seed, shape, rate, probs.device).reshape(r_all, -1)
    m64 = _row_col_keep_int64(torch, seed, r_all, shape[3], rate,
                              probs.device)
    torch.cuda.synchronize()
    check(torch.equal(m32, m64), "int32 and int64 hash emulations differ")
    hd = {"shape": list(shape), "dtype": "bfloat16",
          "hash_dropout_ms": timer(lambda: hash_dropout(probs, seed, rate)),
          "mask_int32_ms": timer(lambda: hash_keep_mask(seed, shape, rate,
                                                        probs.device)),
          "mask_int64_ms": timer(lambda: _row_col_keep_int64(
              torch, seed, r_all, shape[3], rate, probs.device))}
    results["hash_dropout_plain"] = hd
    log(f"timing: plain hash_dropout {list(shape)} bf16 {hd['hash_dropout_ms']:.3f}"
        f" ms; its mask in int32 {hd['mask_int32_ms']:.3f} ms, in int64 "
        f"{hd['mask_int64_ms']:.3f} ms (identical masks)")


def time_student_layer_norm(torch, results, peaks, timer):
    """#1-#4 at the distilled student's SQuAD rows, (12288, 768) bf16,
    rate 0.1 for the residual arms, as the device's time alone beside
    the plain versions and, for #1 and #2, the library's LayerNorm
    (F.layer_norm with bf16 scale and bias, its backward); bounds as
    time_training_kernels' (bytes over the memory rate, or the f32
    operations over the f32 peak). Under each kernel's `distill`."""
    import torch.nn.functional as F

    from bert_pytorch_tpu_torch.ops.layernorm import (
        add_dropout_layer_norm_bwd, add_dropout_layer_norm_bwd_ref,
        add_dropout_layer_norm_fwd, add_dropout_layer_norm_stats_ref,
        layer_norm_bwd, layer_norm_bwd_ref, layer_norm_fwd, layer_norm_ref)

    gen = torch.Generator(device="cuda").manual_seed(14)
    e, rows, seed, rate = STUDENT_HIDDEN, DISTILL_LN_ROWS[-1], \
        FLASH_SEEDS[0], 0.1
    bf = torch.bfloat16
    n, stats, vec = rows * e, 2 * rows * 4, 2 * e * 4
    x = torch.randn(rows, e, generator=gen, device="cuda").to(bf)
    res = torch.randn(rows, e, generator=gen, device="cuda").to(bf)
    g = torch.randn(rows, e, generator=gen, device="cuda").to(bf)
    scale = 1.0 + 0.1 * torch.randn(e, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(e, generator=gen, device="cuda")
    scale16, bias16 = scale.to(bf), bias.to(bf)
    _, mean, rstd = layer_norm_fwd(x, scale, bias)

    def row(nbytes, nops, **kw):
        t_bytes = nbytes / peaks["bytes_per_s"]
        t_ops = nops / peaks["f32_flops"]
        return dict(kw, shape=[rows, e], dtype="bfloat16",
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, operations=nops)

    times = {
        "layer_norm_fwd": row(
            2 * n * 2 + vec + stats, 8 * n, rate=0.0,
            ms=timer(lambda: layer_norm_fwd(x, scale, bias), hide_host=True),
            plain_ms=timer(lambda: layer_norm_ref(x, scale, bias),
                           hide_host=True),
            library_ms=timer(lambda: F.layer_norm(x, (e,), scale16, bias16,
                                                  1e-12), hide_host=True)),
        "layer_norm_bwd": row(
            3 * n * 2 + stats + e * 4 + vec, 11 * n, rate=0.0,
            ms=timer(lambda: layer_norm_bwd(x, scale, mean, rstd, g),
                     hide_host=True),
            plain_ms=timer(lambda: layer_norm_bwd_ref(x, scale, mean, rstd,
                                                      g), hide_host=True),
            library_ms=timer(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    g, x, [e], mean[:, None], rstd[:, None], scale16,
                    scale16, [True, True, True]), hide_host=True)),
        "add_dropout_layer_norm_fwd": row(
            3 * n * 2 + 2 * e * 4 + stats, 20 * n, rate=rate,
            ms=timer(lambda: add_dropout_layer_norm_fwd(
                x, res, scale, bias, seed, rate), hide_host=True),
            plain_ms=timer(lambda: add_dropout_layer_norm_stats_ref(
                x, res, scale, bias, seed, rate), hide_host=True),
            library_ms=None),
        "add_dropout_layer_norm_bwd": row(
            5 * n * 2 + e * 4 + stats + vec, 28 * n, rate=rate,
            ms=timer(lambda: add_dropout_layer_norm_bwd(
                x, res, scale, mean, rstd, g, seed, rate), hide_host=True),
            plain_ms=timer(lambda: add_dropout_layer_norm_bwd_ref(
                x, res, scale, mean, rstd, g, seed, rate), hide_host=True),
            library_ms=None)}
    for name, r in times.items():
        results[name].setdefault("distill", {}).update(r)
        lib = r["library_ms"]
        log(f"timing: {name} student {r['shape']} bf16 rate {r['rate']}: "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            + (f"{lib:.4f} ms" if lib is not None else "none")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def time_flash_training_kernels(torch, np, results, peaks, timer,
                                shape=PHASE2_ATTN, lo=None,
                                key="train_phase2", heads=HEADS):
    """The flash kernels of a training path at `shape` x (16, 64) bf16
    with a padding bias (phase 2's (16, 512); SQuAD's (32, 384), `key`
    "finetune_squad", windows from `lo` tokens): the forward at rates 0.1
    and 0 (the hash's share), the fused backward at rates 0.1 and 0 and
    the pair as one backward at rate 0.1, and at phase 2's shape the dq
    and dk/dv kernels alone, each beside its plain version; the library
    yardstick is
    scaled_dot_product_attention (forward, and its backward) with the same
    float mask at rate 0, since its dropout is another function. Bounds
    count each input read once and each output written once, and the
    products the function needs: 2 (forward), 3 (dq), 4 (dk/dv) and 5 (the
    backward as one function) of 2 B H S^2 D flops."""
    import torch.nn.functional as F

    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_ref, flash_attention_ref)

    batch, seq = shape
    rate, seed = 0.1, FLASH_SEEDS[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    bias = padding_bias(torch, np, np.random.RandomState(5), batch, seq, lo)
    bf = torch.bfloat16
    qkv = torch.randn(batch, seq, 3, heads, HEAD_DIM, generator=gen,
                      device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(batch, seq, heads, HEAD_DIM, generator=gen,
                     device="cuda").to(bf)
    out, lse = flash_attention(q, k, v, bias, None, seed, rate)
    _, delta = flash_attention_bwd_dq(q, k, v, bias, None, out, lse, do,
                                      seed, rate)
    tensor = batch * seq * heads * HEAD_DIM * 2
    rows_f32 = batch * heads * seq * 4          # lse or delta
    bias_bytes = batch * seq * 4
    product = 2 * batch * heads * seq * seq * HEAD_DIM

    def row(nbytes, nops, **kw):
        t_bytes = nbytes / peaks["bytes_per_s"]
        t_ops = nops / peaks["bf16_flops"]
        return dict(kw, shape=[batch, seq, heads, HEAD_DIM],
                    dtype="bfloat16", rate=rate,
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, operations=nops)

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    mask = bias.to(bf)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    go = do.transpose(1, 2)
    sdpa_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), hide_host=True)
    # backward times are the device's alone (hide_host): autograd's host
    # work around SDPA's backward kernels is not theirs
    sdpa_bwd = timer(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), go,
                                                 retain_graph=True),
                     hide_host=True)
    fwd = results["flash_attention_fwd"].setdefault(key, {})
    fwd.update(row(
        4 * tensor + rows_f32 + bias_bytes, 2 * product,
        ms=timer(lambda: flash_attention(q, k, v, bias, None, seed, rate),
                 hide_host=True),
        plain_ms=timer(lambda: flash_attention_ref(q, k, v, bias, None,
                                                   seed, rate),
                       hide_host=True),
        library_ms=sdpa_fwd,
        # rate 0, the same inputs: the dropout hash's share is the
        # difference
        rate0_ms=timer(lambda: flash_attention(q, k, v, bias),
                       hide_host=True),
        rate0_plain_ms=timer(lambda: flash_attention_ref(q, k, v, bias),
                             hide_host=True)))
    if key == "train_phase2":
        time_split_kernels(torch, results, timer, row, (q, k, v, bias, out,
                                                        lse, delta, do),
                           seed, rate, product, tensor, rows_f32,
                           bias_bytes)

    def both():
        _, delta_ = flash_attention_bwd_dq(q, k, v, bias, None, out, lse,
                                           do, seed, rate)
        flash_attention_bwd_dkv(q, k, v, bias, None, lse, delta_, do, seed,
                                rate)

    # the backward as one function: the fused kernel at the main path's
    # rate 0.1 and at SDPA's rate 0 (out and lse of a rate-0 forward), the
    # pair at rate 0.1 beside it
    out0, lse0 = flash_attention(q, k, v, bias)
    whole = results.setdefault("flash_attention_bwd", {})
    if key != "train_phase2":
        whole = whole.setdefault(key, {})
    whole.update(row(
        8 * tensor + rows_f32 + bias_bytes, 5 * product,
        ms=timer(lambda: flash_attention_bwd(q, k, v, bias, None, out, lse,
                                             do, seed, rate), hide_host=True),
        plain_ms=timer(lambda: flash_attention_bwd_ref(
            q, k, v, bias, None, out, lse, do, seed, rate)),
        library_ms=sdpa_bwd,
        rate0_ms=timer(lambda: flash_attention_bwd(q, k, v, bias, None, out0,
                                                   lse0, do), hide_host=True),
        rate0_plain_ms=timer(lambda: flash_attention_bwd_ref(
            q, k, v, bias, None, out0, lse0, do)),
        pair_ms=timer(both, hide_host=True)))
    log(f"timing: flash_attention_fwd {key} {fwd['shape']} bf16: kernel "
        f"{fwd['ms']:.4f} ms at rate {rate}, {fwd['rate0_ms']:.4f} ms at "
        f"rate 0, plain {fwd['plain_ms']:.4f} ms, SDPA (rate 0) "
        f"{fwd['library_ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
        f"({fwd['bound_by']})")
    log(f"timing: flash backward as a whole {key} {whole['shape']} bf16: "
        f"fused "
        f"kernel {whole['ms']:.4f} ms at rate {rate}, {whole['rate0_ms']:.4f}"
        f" ms at rate 0; the dq + dk/dv pair {whole['pair_ms']:.4f} ms at "
        f"rate {rate}; plain {whole['plain_ms']:.4f} ms (rate {rate}), "
        f"{whole['rate0_plain_ms']:.4f} ms (rate 0); SDPA backward (rate 0) "
        f"{whole['library_ms']:.4f} ms; bound {whole['bound_ms']:.4f} ms "
        f"({whole['bound_by']})")


def time_split_kernels(torch, results, timer, row, tensors, seed, rate,
                       product, tensor, rows_f32, bias_bytes):
    """The dq and dk/dv kernels alone at phase 2's shape (row: the bound
    of time_flash_training_kernels)."""
    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dkv_ref,
        flash_attention_bwd_dq, flash_attention_bwd_dq_ref)

    q, k, v, bias, out, lse, delta, do = tensors
    results["flash_attention_bwd_dq"].update(row(
        6 * tensor + 2 * rows_f32 + bias_bytes, 3 * product,
        ms=timer(lambda: flash_attention_bwd_dq(q, k, v, bias, None, out,
                                                lse, do, seed, rate),
                 hide_host=True),
        plain_ms=timer(lambda: flash_attention_bwd_dq_ref(
            q, k, v, bias, None, lse, delta, do, seed, rate)),
        library_ms=None))
    results["flash_attention_bwd_dkv"].update(row(
        6 * tensor + 2 * rows_f32 + bias_bytes, 4 * product,
        ms=timer(lambda: flash_attention_bwd_dkv(q, k, v, bias, None, lse,
                                                 delta, do, seed, rate),
                 hide_host=True),
        plain_ms=timer(lambda: flash_attention_bwd_dkv_ref(
            q, k, v, bias, None, lse, delta, do, seed, rate)),
        library_ms=None))


def time_pair(torch, np, results, peaks, timer):
    """The dq and dk/dv pair (#9/#10) at PAIR_LONG_SHAPES bf16 with a
    padding bias, rate 0.1, each kernel beside its plain version and its
    bound (`seq1024`, `seq2048` in the kernel's results); at those shapes
    and at phase 2's, the pair as one backward at rates 0.1 and 0 beside
    SDPA's backward at rate 0 (same inputs, the bias as a float mask), and
    at phase 2's the fused kernel beside them (`pair_by_shape` in the
    fused backward's results); and the f32 pair at phase 2's shape
    (`float32`), bound by the f32 peak. Device time alone throughout."""
    import torch.nn.functional as F

    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_ref, flash_attention_bwd_dq,
        flash_attention_bwd_dq_ref, fused_bwd_takes)

    rate, seed = 0.1, FLASH_SEEDS[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    by_shape = results.setdefault("flash_attention_bwd", {}).setdefault(
        "pair_by_shape", {})
    for batch, seq in (PHASE2_ATTN,) + PAIR_LONG_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and seq != PHASE2_ATTN[1]:
                continue
            name = str(dtype).split(".")[-1]
            size = 2 if dtype == torch.bfloat16 else 4
            peak = peaks["bf16_flops" if size == 2 else "f32_flops"]
            bias = padding_bias(torch, np, np.random.RandomState(seq),
                                batch, seq)
            qkv = torch.randn(batch, seq, 3, HEADS, HEAD_DIM, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.randn(batch, seq, HEADS, HEAD_DIM, generator=gen,
                             device="cuda").to(dtype)
            out, lse = flash_attention(q, k, v, bias, None, seed, rate)
            _, delta = flash_attention_bwd_dq(q, k, v, bias, None, out, lse,
                                              do, seed, rate)
            tensor = batch * seq * HEADS * HEAD_DIM * size
            rows_f32 = batch * HEADS * seq * 4
            product = 2 * batch * HEADS * seq * seq * HEAD_DIM
            nbytes = 6 * tensor + 2 * rows_f32 + batch * seq * 4

            def row(nops, **kw):
                t_bytes = nbytes / peaks["bytes_per_s"]
                t_ops = nops / peak
                return dict(kw, shape=[batch, seq, HEADS, HEAD_DIM],
                            dtype=name, rate=rate,
                            bound_ms=max(t_bytes, t_ops) * 1e3,
                            bound_by=("bytes" if t_bytes >= t_ops
                                      else "operations"),
                            bytes=nbytes, operations=nops, library_ms=None)

            dq_row = row(
                3 * product,
                ms=timer(lambda: flash_attention_bwd_dq(
                    q, k, v, bias, None, out, lse, do, seed, rate),
                    hide_host=True),
                plain_ms=timer(lambda: flash_attention_bwd_dq_ref(
                    q, k, v, bias, None, lse, delta, do, seed, rate)))
            kv_row = row(
                4 * product,
                ms=timer(lambda: flash_attention_bwd_dkv(
                    q, k, v, bias, None, lse, delta, do, seed, rate),
                    hide_host=True),
                plain_ms=timer(lambda: flash_attention_bwd_dkv_ref(
                    q, k, v, bias, None, lse, delta, do, seed, rate)))
            tag = f"{batch}x{seq}"
            if dtype == torch.float32:
                results["flash_attention_bwd_dq"]["float32"] = dq_row
                results["flash_attention_bwd_dkv"]["float32"] = kv_row
                log(f"timing: f32 pair {dq_row['shape']} rate {rate}: dq "
                    f"{dq_row['ms']:.4f} ms (plain {dq_row['plain_ms']:.4f}, "
                    f"bound {dq_row['bound_ms']:.4f} {dq_row['bound_by']}), "
                    f"dk/dv {kv_row['ms']:.4f} ms (plain "
                    f"{kv_row['plain_ms']:.4f}, bound {kv_row['bound_ms']:.4f}"
                    f" {kv_row['bound_by']})")
                continue
            if seq != PHASE2_ATTN[1]:
                for kern, r in (("dq", dq_row), ("dkv", kv_row)):
                    long = results["flash_attention_bwd_" + kern].get(
                        "long", {}).get(tag, {})
                    r["max_abs_err"] = long.get("max_abs_err", {})
                    results["flash_attention_bwd_" + kern][f"seq{seq}"] = r

            def pair(out_, lse_, seed_=None, rate_=0.0):
                _, delta_ = flash_attention_bwd_dq(q, k, v, bias, None, out_,
                                                   lse_, do, seed_, rate_)
                flash_attention_bwd_dkv(q, k, v, bias, None, lse_, delta_,
                                        do, seed_, rate_)

            out0, lse0 = flash_attention(q, k, v, bias)
            qt, kt, vt = (x.detach().transpose(1, 2).contiguous()
                          .requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=bias.to(dtype))
            go = do.transpose(1, 2)
            whole = {
                "shape": [batch, seq, HEADS, HEAD_DIM],
                "dq_ms": dq_row["ms"], "dkv_ms": kv_row["ms"],
                "pair_ms": timer(lambda: pair(out, lse, seed, rate),
                                 hide_host=True),
                "pair_rate0_ms": timer(lambda: pair(out0, lse0),
                                       hide_host=True),
                "sdpa_bwd_rate0_ms": timer(
                    lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), go,
                                                retain_graph=True),
                    hide_host=True),
                "bound_ms": max((8 * tensor + rows_f32 + batch * seq * 4)
                                / peaks["bytes_per_s"],
                                5 * product / peak) * 1e3}
            if fused_bwd_takes(q):
                whole["fused_ms"] = timer(lambda: flash_attention_bwd(
                    q, k, v, bias, None, out, lse, do, seed, rate),
                    hide_host=True)
                whole["fused_rate0_ms"] = timer(lambda: flash_attention_bwd(
                    q, k, v, bias, None, out0, lse0, do), hide_host=True)
            by_shape[tag] = whole
            log(f"timing: pair {tag} bf16: dq {dq_row['ms']:.4f} ms (bound "
                f"{dq_row['bound_ms']:.4f} {dq_row['bound_by']}, plain "
                f"{dq_row['plain_ms']:.4f}), dk/dv {kv_row['ms']:.4f} ms "
                f"(bound {kv_row['bound_ms']:.4f} {kv_row['bound_by']}, plain "
                f"{kv_row['plain_ms']:.4f}); the pair {whole['pair_ms']:.4f} "
                f"ms at rate {rate}, {whole['pair_rate0_ms']:.4f} at rate 0; "
                f"SDPA backward (rate 0) {whole['sdpa_bwd_rate0_ms']:.4f} ms"
                + (f"; fused {whole['fused_ms']:.4f} / "
                   f"{whole['fused_rate0_ms']:.4f} ms" if "fused_ms" in whole
                   else "")
                + f"; the whole backward's bound {whole['bound_ms']:.4f} ms")
            del qkv, q, k, v, do, out, lse, out0, lse0, qt, kt, vt, sdpa_out

def time_lamb_kernels(torch, np, results, peaks, timer):
    """#11 and #12 over BERT-Large's 302 parameter tensors (336,232,258
    elements), bf16 gradients, each beside its plain version. Stage 1 has
    no one PyTorch call that computes it (library none); stage 2 with the
    apply is timed against torch._foreach_mul then torch._foreach_add_.
    Bounds: bytes of the tensors (each read once, each written once; the
    kernels' tables, under 0.4 MB, left out) over the memory rate, or the
    f32 operations over the f32 peak: stage 1 26 bytes and 15 operations
    an element, stage 2 with the apply 12 bytes and 2 operations."""
    from bert_pytorch_tpu_torch.ops.fused_optim import (
        lamb_stage1, lamb_stage1_ref, lamb_stage2, lamb_stage2_ref)

    gen = torch.Generator(device="cuda").manual_seed(8)
    st = bert_large_lamb_state(torch, gen, torch.bfloat16)
    n = sum(x.numel() for x in st["g"])
    args = dict(denom=torch.full((), 1.37, device="cuda"), c1=0.1, c2=1e-3,
                b1=0.9, b2=0.999, eps=1e-6)
    u = lamb_stage1_ref(st["g"], st["mu"], st["nu"], st["p"], st["wd"],
                        **args)
    t = torch.randn(len(u), generator=gen, device="cuda") * 1e-7
    t_host = t.tolist()

    def row(nbytes, nops, **kw):
        t_bytes = nbytes / peaks["bytes_per_s"]
        t_ops = nops / peaks["f32_flops"]
        return dict(kw, shape=[len(u), n], dtype="bfloat16 gradients",
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, operations=nops)

    def foreach_apply():
        torch._foreach_add_(st["p"], torch._foreach_mul(u, t_host))

    def stage1():
        lamb_stage1(st["g"], st["mu"], st["nu"], st["p"], st["wd"], **args)

    def stage2():
        lamb_stage2(t, u, st["p"])

    # ms: the kernel on the card; call_ms: the wrapper's whole call as the
    # step sees it, its host work (checks, tables, their copy) included
    results["lamb_stage1"].update(row(
        26 * n, 15 * n, ms=timer(stage1, hide_host=True),
        call_ms=timer(stage1),
        plain_ms=timer(lambda: lamb_stage1_ref(
            st["g"], st["mu"], st["nu"], st["p"], st["wd"], **args)),
        library_ms=None))
    results["lamb_stage2"].update(row(
        12 * n, 2 * n, ms=timer(stage2, hide_host=True),
        call_ms=timer(stage2),
        plain_ms=timer(lambda: lamb_stage2_ref(t, u, st["p"])),
        library_ms=timer(foreach_apply),
        product_only_ms=timer(lambda: lamb_stage2(t, u), hide_host=True),
        product_only_bound_ms=8 * n / peaks["bytes_per_s"] * 1e3))
    for name in ("lamb_stage1", "lamb_stage2"):
        r = results[name]
        log(f"timing: {name}: kernel on the card {r['ms']:.4f} ms, the "
            f"wrapper's call {r['call_ms']:.4f} ms (host work included)")
    del st, u


# -- serving ------------------------------------------------------------------

QUESTIONS = (
    "who sat on the mat ?", "where did the dog run ?",
    "what does the server pack ?", "when did the model answer ?",
    "which city hosts the long report ?")
_WORDS = ("the cat sat on a mat while dog ran in park and red blue green "
          "server packs rows of questions answers model was fast slow city "
          "report long river bridge north south east west morning evening "
          "people walked across old new market street train station").split()


def _context(rng, n_words: int) -> str:
    words = [_WORDS[i] for i in rng.randint(0, len(_WORDS), n_words)]
    return " ".join(" ".join(words[i:i + 12]) + " ."
                    for i in range(0, n_words, 12))


def serve_vocab(path: str) -> str:
    """The vocabulary of the serve and finetune phases' synthetic text
    (the words `_context` draws from, the questions) at `path`."""
    with open(path, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + sorted(set(" ".join(QUESTIONS + tuple(
                              _WORDS)).split() + ["."]))) + "\n")
    return path


BPE_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")


def bpe_files(texts, directory: str, n_merges: int = 200) -> str:
    """A byte-level BPE vocabulary learned from `texts`: the specials,
    the 256 byte symbols, then the `n_merges` most frequent adjacent pairs
    of the pre-tokenized words, merged greedily (ties by first sight).
    Writes vocab.json and merges.txt into `directory`; returns the
    vocab.json path (data/tokenization.get_bpe_tokenizer finds the merges
    beside it)."""
    import collections

    from bert_pytorch_tpu_torch.data.tokenization import (
        ByteLevelBPETokenizer, bytes_to_unicode)

    table = bytes_to_unicode()
    scanner = ByteLevelBPETokenizer({}, [])
    words = collections.Counter()
    for text in texts:
        text = text.lower()
        for chunk in scanner._pretokenize(" " + text):  # noqa: SLF001
            words[tuple(table[b] for b in chunk.encode("utf-8"))] += 1
    words = dict(words)
    vocab = list(BPE_SPECIALS) + [table[b] for b in range(256)]
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for word, n in words.items():
            for a, b in zip(word, word[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        best = max(pairs, key=pairs.get)
        merges.append(best)
        vocab.append(best[0] + best[1])
        merged = {}
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        words = merged
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "vocab.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(dict.fromkeys(vocab))}, f)
    with open(os.path.join(directory, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                             for a, b in merges))
    return path


def _post(url: str, body: dict, timeout: float = 300.0,
          route: str = "squad"):
    """(status, JSON reply) of POST /v1/<route>, an error status too."""
    req = urllib.request.Request(url + f"/v1/{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _profile_forward(torch, engine, batch, task="squad"):
    """Device time of one 512 forward by kernel class (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.forward(task, batch)
    classes = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if not us or getattr(ev, "device_type", None) is None:
            continue
        if str(ev.device_type).split(".")[-1] != "CUDA":
            continue
        name = ev.key
        if "ln_fwd" in name:  # ln_fwd_row_kernel, ln_fwd_kernel
            cls = "layer_norm_fwd (kernel)"
        elif "flash_fwd" in name:
            cls = "flash_attention_fwd (kernel)"
        elif any(t in name.lower() for t in ("gemm", "cutlass", "sm90_",
                                             "xmma", "cublas", "nvjet")):
            cls = "matmul (cuBLAS)"
        elif "elementwise_kernel" in name:
            cls = "elementwise (casts, adds, GELU)"
        else:
            cls = "other: " + name[:60]
        classes[cls] = classes.get(cls, 0.0) + us / 1e3
    return dict(sorted(classes.items(), key=lambda kv: -kv[1]))


def phase_serve(torch, np, summary, device="cuda",
                cfg_path=os.path.join(HERE, "configs",
                                      "bert_large_uncased_config.json")):
    """The serving run: one server for the five registered tasks. `device`
    and `cfg_path` exist so the phase can be rehearsed on the CPU at a tiny
    size; the script itself always runs BERT-Large on CUDA."""
    import shutil

    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.packing import first_fit
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.models.bert import (BertForQuestionAnswering,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.serving.batcher import (InferenceRequest,
                                                        pack_requests)
    from bert_pytorch_tpu_torch.tasks import predict, registry

    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    layers = config.num_hidden_layers
    rng = np.random.RandomState(0)
    # contexts of 42-96 tokens (64 / 128 buckets), 194 (256), 422 (512)
    contexts = [_context(rng, n) for n in (30, 45, 80, 170, 380)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    handle = None
    try:
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        # a seeded random BERT-Large checkpoint for each registered task,
        # read by the server and then deleted
        t0 = time.perf_counter()
        opts = dict(SERVE_OPTS, labels=list(CONLL_TAGS))
        ckpts = {}
        for task in registry.all_tasks():
            model = registry.get(task).build_serving_model(
                config, torch.bfloat16, opts, device)
            init_weights(model, torch.Generator(device=device).manual_seed(0),
                         std=config.initializer_range)
            ckpts[task] = os.path.join(tmp, f"{task}_large.pt")
            torch.save(model.state_dict(), ckpts[task])
            del model
        log(f"serve: seeded random BERT-Large checkpoints ({layers} layers) "
            f"of {sorted(ckpts)} written in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        argv = (["--model_config_file", cfg_path, "--vocab_file", vocab,
                 "--port", "0", "--host", "127.0.0.1", "--device", device,
                 "--labels", *CONLL_TAGS]
                + [a for task in sorted(ckpts)
                   for a in ("--task_checkpoint", f"{task}={ckpts[task]}")])
        handle = run_server.serve(run_server.parse_arguments(argv),
                                  log=lambda m: log("serve: " + m))
        engine = handle.engine
        summary["serve_start_s"] = time.perf_counter() - t0
        check(engine.tasks == registry.all_tasks(),
              f"served tasks {engine.tasks}")
        check(engine.buckets == BUCKETS and engine.batch_rows == BATCH_ROWS
              and engine.max_segments == 8, "server defaults changed")
        # one CUDA graph a (task, bucket) on the card; traffic adds none
        warm_captures = engine.captures
        check(warm_captures == len(engine.tasks) * len(engine.buckets)
              and engine.graphs_on == (torch.device(device).type == "cuda"),
              f"captures after warmup {warm_captures}")

        # the main path: launch counts zeroed just before, read just after
        for key in engine.forward_counts:
            engine.forward_counts[key] = 0
        reset_launches()
        t0 = time.perf_counter()
        bodies = [{"question": q, "context": c}
                  for q, c in zip(QUESTIONS, contexts)]
        replies = [None] * len(bodies)

        def ask(i):
            replies[i] = _post(handle.url, bodies[i])

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        forwards = dict(engine.forward_counts)
        summary.setdefault("launches", {})["serve"] = launches
        n_fwd = sum(forwards.values())
        n_512 = forwards[("squad", 512)]
        for i, (body, reply) in enumerate(zip(bodies, replies)):
            check(reply is not None, f"request {i}: no reply")
            code, out = reply
            log(f"serve: request {i} ({out.get('real_tokens')} tokens, "
                f"{out.get('latency_ms')} ms): {code} {out.get('answer')!r}")
            check(code == 200, f"request {i}: HTTP {code}")
            check(bool(out["answer"]) and out["answer"] in body["context"],
                  f"request {i}: answer {out['answer']!r} is not a span of "
                  "its context")
        log(f"serve: {len(bodies)} requests in {wall:.2f} s; forwards "
            f"{ {f'{t}/{b}': n for (t, b), n in forwards.items()} }; "
            f"launches {launches}")
        check(n_512 >= 1, "no request rode the 512 bucket")
        # a CPU rehearsal runs the plain versions: nothing to count there
        on_card = torch.device(device).type == "cuda"
        check(not on_card or launches["layer_norm_fwd"]
              >= (2 * layers + 1) * n_fwd,
              f"layer_norm_fwd launched {launches['layer_norm_fwd']} times "
              f"for {n_fwd} forwards (want >= {2 * layers + 1} each)")
        check(not on_card or launches["flash_attention_fwd"]
              >= layers * n_512,
              f"flash_attention_fwd launched "
              f"{launches['flash_attention_fwd']} times for {n_512} "
              f"512-bucket forwards (want >= {layers} each)")
        summary["serve"] = {
            "requests": len(bodies), "wall_s": wall,
            "latency_ms": [r[1]["latency_ms"] for r in replies],
            "real_tokens": [r[1]["real_tokens"] for r in replies],
            "forwards": {f"{t}/{b}": n for (t, b), n in forwards.items()},
            "launches": launches}

        # one packed 512 batch: kernels (the engine) against the plain
        # versions (the same weights in a plain=True model)
        tokenizer = get_wordpiece_tokenizer(vocab)
        id_lists = []
        for q, c in zip(QUESTIONS * 3, contexts * 3):
            ex = predict.make_squad_example("x", q, c)
            for feat in predict.qa_featurize(ex, tokenizer, 512, 128, 64):
                ln = predict.feature_length(feat)
                id_lists.append((feat.input_ids[:ln], feat.segment_ids[:ln]))
        reqs = [InferenceRequest("squad", np.asarray(ids, np.int32),
                                 np.asarray(types, np.int32))
                for ids, types in id_lists]
        batch, _ = pack_requests(
            reqs, first_fit([r.length for r in reqs], BATCH_ROWS, 512, 8),
            BATCH_ROWS, 512)
        segs = int(batch["segment_ids"].max(axis=1).sum())
        real = batch["attention_mask"] > 0
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        weights = handle.models["squad"].state_dict()

        def run(model):
            with torch.inference_mode():
                return [t.float().cpu().numpy() for t in model(**tb)]

        def build(dtype, plain):
            model = BertForQuestionAnswering(config, dtype=dtype, plain=plain)
            model.load_state_dict(weights)
            return model.to(device).eval()

        summary["serve"]["packed512"] = {"segments": segs}
        for dtype, tol in ((torch.bfloat16, MODEL_TOL),
                           (torch.float32, MODEL_TOL_F32)):
            name = str(dtype).split(".")[-1]
            if dtype == torch.bfloat16:
                got = list(engine.forward("squad", batch))  # the served path
            else:
                got = run(build(dtype, plain=False))
            want = run(build(dtype, plain=True))
            check(all(g.shape == (BATCH_ROWS, 512) and np.isfinite(g).all()
                      for g in got), f"{name} logits not finite (8, 512)")
            err = max(float(np.abs(g - w)[real].max())
                      for g, w in zip(got, want))
            spread = float(np.std(want[0][real]))
            log(f"serve: packed 512 batch ({segs} segments in {BATCH_ROWS} "
                f"rows), {name}: kernels vs plain versions max|logit diff| "
                f"{err:.4g} (tol {tol:g}; logit spread {spread:.3g})")
            check(err <= tol, f"{name} kernels vs plain model: {err} > {tol}")
            summary["serve"]["packed512"][name] = {"max_abs_err": err,
                                                   "logit_std": spread}

        # where the time goes at the 512 bucket: forward wall time and
        # device time by kernel class
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.forward("squad", batch)
            times.append((time.perf_counter() - t0) * 1e3)
        summary["serve"]["forward512_ms"] = statistics.median(times)
        summary["serve"]["forward512_device_ms"] = _profile_forward(
            torch, engine, batch)
        log(f"serve: 512-bucket forward {statistics.median(times):.2f} ms "
            f"(median of 5, host clock); device ms by class "
            f"{summary['serve']['forward512_device_ms']}")

        summary["serve"]["routes"] = serve_routes(
            torch, np, handle, config, tokenizer, batch, reqs, device)
        summary["launches"]["serve_routes"] = (
            summary["serve"]["routes"]["launches"])
        sv = summary["serve"]
        sv["graphs"] = serve_graph_checks(
            torch, np, handle, config, ckpts, batch,
            dict(opts, max_segments=engine.max_segments), device)
        sv["queue_c_item2"] = packed_span_diagnosis(
            torch, np, handle, sv["routes"].pop("squad_segments"), device)
        sv["planes"] = serve_planes(np, handle)
        sv["load"] = serve_load(np, handle, vocab,
                                torch.device(device).type == "cuda")
        check(engine.captures == warm_captures, f"captures moved under "
              f"traffic: {warm_captures} after warmup, {engine.captures} now")
        sv["captures"] = engine.captures
        sv["drain"] = drain_drill(np, handle)
        handle = None
        sv["int8"] = serve_int8(torch, np, argv, ckpts, batch, device)
    finally:
        if handle is not None:
            handle.close()
        shutil.rmtree(tmp, ignore_errors=True)


# The head widths of the seeded checkpoints: run_server's defaults (2
# classes, a 2-wide embedding probe; NER's labels are CONLL_TAGS).
SERVE_OPTS = {"class_names": ["negative", "positive"], "embed_labels": 2}
# Packed against one request a row, on the same engine (bf16): the (8,
# bucket) batches have the same shapes either way, so only the order in
# which attention sums a segment's keys among its row's masked ones
# moves, which can shift an output by an ulp of bf16. Every output of a
# task (logits, scores, embedding elements) is held within PACK_REL of
# the task's largest |output| (between one and two ulps of it). Measured
# on the card (PERF.md): 0 on the pooled heads and NER; SQuAD read 2^-7
# (one ulp at |logit| in [1, 2)) while its head was one cuBLAS GEMM at
# N = 2, and is now held at 0 (models/bert._row_linear). Each run
# also plants a demux fault (a request read at its row-mate's segment or
# offset), which must read above the limit: on the card 0.078 (embed) to
# 2.7 (NER).
PACK_REL = 2 ** -7


def route_bodies(np, seed: int = 1) -> dict:
    """Requests of the four routes beside squad, each route's in ascending
    length so each rides its natural bucket: NER word lists, classify
    pairs and choice requests (a question and 4 choices) of ~35, ~100,
    ~200 and ~440 pieces (64, 128, 256, 512), and one embed request of 8
    texts from 10 to 450 words."""
    rng = np.random.RandomState(seed)
    words = (30, 90, 200, 400)
    return {
        "ner": [{"tokens": _context(rng, n).split()} for n in words],
        "classify": [{"text": _context(rng, n // 2),
                      "text_pair": _context(rng, n // 2)} for n in words],
        "choice": [{"question": QUESTIONS[i],
                    "choices": [_context(rng, n - 10 + 3 * c)
                                for c in range(4)]}
                   for i, n in enumerate((30, 70, 160, 400))],
        "embed": [{"texts": [_context(rng, n) for n in
                             (10, 30, 50, 80, 120, 200, 300, 450)]}]}


def pack_bodies(np, seed: int = 2) -> dict:
    """Short requests of every task, several of which share a 64-token
    row when packed: NER word lists and classify pairs of 4 to 14 words,
    choice requests of 4 choices of 3 to 6 words, one embed request of 6
    short texts, and squad (question, context) pairs of 8 to 14 words."""
    rng = np.random.RandomState(seed)
    return {
        "ner": [{"tokens": _context(rng, n).split()}
                for n in (4, 6, 8, 10, 12, 14)],
        "classify": [{"text": _context(rng, n), "text_pair": _context(
            rng, n)} for n in (2, 3, 4, 5, 6, 7)],
        "choice": [{"question": QUESTIONS[i],
                    "choices": [_context(rng, 3 + c) for c in range(4)]}
                   for i in range(2)],
        "embed": [{"texts": [_context(rng, n)
                             for n in (3, 5, 7, 9, 11, 13)]}],
        "squad": [{"question": QUESTIONS[i], "context": _context(rng, n)}
                  for i, n in enumerate((8, 10, 12, 14))]}


def _route_parts(task: str, body: dict, tokenizer, max_bucket: int):
    """The (input ids, type ids) segments a service submits for `body`."""
    from bert_pytorch_tpu_torch.tasks import predict

    if task == "ner":
        ids, _ = predict.ner_encode_tokens(body["tokens"], tokenizer,
                                           max_bucket)
        return [(ids, [0] * len(ids))]
    if task == "classify":
        return [predict.encode_pair(tokenizer, body["text"],
                                    body["text_pair"], max_bucket)]
    if task == "choice":
        return [predict.encode_pair(tokenizer, body["question"], c,
                                    max_bucket) for c in body["choices"]]
    if task == "squad":
        return [predict.encode_pair(tokenizer, body["question"],
                                    body["context"], max_bucket)]
    return [predict.encode_pair(tokenizer, t, None, max_bucket)
            for t in body["texts"]]


def _post_oversized(url: str, route: str) -> int:
    """The status of a POST /v1/<route> whose Content-Length exceeds the
    frontend's body limit (1 MiB): sent as headers alone, so the reply
    is read before the server drops the connection."""
    import http.client
    import urllib.parse

    host = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(host.hostname, host.port, timeout=60)
    try:
        conn.putrequest("POST", f"/v1/{route}")
        conn.putheader("Content-Length", str((1 << 20) + 1))
        conn.endheaders()
        return conn.getresponse().status
    finally:
        conn.close()


def _check_reply(np, task: str, body: dict, code: int, out: dict,
                 hidden: int) -> None:
    """A 200 reply of `task` is well formed: NER one label a word from the
    tag set; classify a label of its class names and probabilities that
    sum to 1; choice an index among its choices and probabilities that sum
    to 1; embed one unit-norm embedding of the hidden width a text."""
    check(code == 200, f"{task}: HTTP {code} {out}")
    if task == "ner":
        check(len(out["labels"]) == len(body["tokens"])
              and set(out["labels"]) <= set(CONLL_TAGS),
              f"ner: {len(out['labels'])} labels for "
              f"{len(body['tokens'])} words")
    elif task == "classify":
        check(out["label"] in SERVE_OPTS["class_names"]
              and set(out["scores"]) == set(SERVE_OPTS["class_names"])
              and abs(sum(out["scores"].values()) - 1.0) <= 1e-5,
              f"classify: {out}")
    elif task == "choice":
        n = len(body["choices"])
        check(0 <= out["choice"] < n and len(out["scores"]) == n
              and abs(sum(out["scores"]) - 1.0) <= 1e-5, f"choice: {out}")
    else:
        emb = np.asarray(out["embeddings"], np.float64)
        norms = np.linalg.norm(emb, axis=-1)
        check(emb.shape == (len(body["texts"]), hidden)
              and out["dim"] == hidden
              and np.abs(norms - 1.0).max() <= 1e-4,
              f"embed: shape {emb.shape}, norms {norms}")


def _engine_answers(np, engine, task: str, reqs, max_segments: int):
    """Each request's outputs from the engine: first-fit into
    (BATCH_ROWS, bucket) batches, `max_segments` a row (1: packing off),
    run, demuxed as the scheduler demuxes. Also, for a request that
    shares its row, its outputs under a planted demux fault: read at the
    next row-mate's segment and offset (None for a request alone in its
    row)."""
    from bert_pytorch_tpu_torch.data.packing import first_fit
    from bert_pytorch_tpu_torch.serving.batcher import (Scheduler,
                                                        pack_requests)

    kind = engine.output_kind(task)
    out, shifted, pending = {}, {}, list(reqs)
    while pending:
        bucket = engine.select_bucket(pending[0].length)
        wave = [r for r in pending if r.length <= bucket]
        bins = first_fit([r.length for r in wave], engine.batch_rows,
                         bucket, max_segments)
        batch, placements = pack_requests(wave, bins, engine.batch_rows,
                                          bucket)
        result = engine.forward(task, batch)
        rows = {}
        for p in placements:
            rows.setdefault(p[1], []).append(p)
        for req, row, offset, seg in placements:
            out[id(req)] = Scheduler._demux(result, row, offset, req.length,
                                            seg, kind)
            mates = rows[row]
            i = [id(m[0]) for m in mates].index(id(req))
            _, _, m_offset, m_seg = mates[(i + 1) % len(mates)]
            shifted[id(req)] = (None if len(mates) < 2 else
                                Scheduler._demux(result, row, m_offset,
                                                 req.length, m_seg, kind))
        pending = [r for r in pending if id(r) not in out]
    return [out[id(r)] for r in reqs], [shifted[id(r)] for r in reqs]


def serve_routes(torch, np, handle, config, tokenizer, batch512, squad_reqs,
                 device):
    """The five-task server's other routes: /healthz lists the five tasks;
    ner, classify, choice and embed answer requests in every bucket
    (counts zeroed just before, read just after: every forward through
    the kernels), each reply well formed; each new service's 400 and 413
    paths (classify's 413 is the frontend's body limit: it truncates long
    texts); per task (squad's on `squad_reqs`), answers with packing on
    against packing off on the engine, and one packed 512 forward
    (`batch512`): its exact launch counts and its time."""
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.serving.batcher import InferenceRequest

    on_card = torch.device(device).type == "cuda"
    engine = handle.engine
    layers, hidden = config.num_hidden_layers, config.hidden_size
    with urllib.request.urlopen(handle.url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    check(sorted(health["tasks"]) == list(engine.tasks)
          and all({"head", "request_schema"} <= set(v)
                  for v in health["tasks"].values()),
          f"/healthz tasks {health.get('tasks')}")
    out = {"healthz_tasks": sorted(health["tasks"])}

    bodies = route_bodies(np)
    for key in engine.forward_counts:
        engine.forward_counts[key] = 0
    reset_launches()
    t0 = time.perf_counter()
    replies = {task: [_post(handle.url, b, route=task) for b in bs]
               for task, bs in bodies.items()}
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    forwards = dict(engine.forward_counts)
    for task, bs in bodies.items():
        for body, (code, reply) in zip(bs, replies[task]):
            _check_reply(np, task, body, code, reply, hidden)
        rode = {b: forwards[(task, b)] for b in engine.buckets}
        check(all(rode.values()), f"{task}: forwards by bucket {rode}: "
              "want every bucket")
    n_fwd = sum(forwards.values())
    n_512 = sum(n for (t, b), n in forwards.items() if b == engine.max_bucket)
    check(not on_card or (launches["layer_norm_fwd"] == (2 * layers + 1)
                          * n_fwd and launches["flash_attention_fwd"]
                          == layers * n_512),
          f"routes: launches {launches} for {n_fwd} forwards, {n_512} in "
          "the 512 bucket")
    log(f"serve: routes {sorted(bodies)}: {sum(map(len, bodies.values()))} "
        f"requests in {wall:.2f} s; forwards "
        f"{ {f'{t}/{b}': n for (t, b), n in forwards.items() if n} }; "
        f"launches {launches}")
    out.update(wall_s=wall, launches=launches, replies={
        t: [r for _, r in rs] for t, rs in replies.items()},
        forwards={f"{t}/{b}": n for (t, b), n in forwards.items()})

    # the 400 and 413 paths of each new service
    bad = {"ner": ({"tokens": []}, {"tokens": ["the"] * 600}),
           "classify": ({"text": " "}, None),
           "choice": ({"choices": ["the cat"]},
                      {"choices": ["the cat"] * 17}),
           "embed": ({"texts": []}, {"texts": ["the cat"] * 33})}
    codes = {t: [_post(handle.url, b, route=t)[0] if b is not None
                 else _post_oversized(handle.url, t) for b in pair]
             for t, pair in bad.items()}
    check(all(c == [400, 413] for c in codes.values()),
          f"error paths {codes}: want [400, 413] each")
    out["error_codes"] = codes

    # per task: packing on against packing off, on the engine, over the
    # route requests and short ones that share rows when packed
    out["packed_vs_padded"] = {}
    short = pack_bodies(np)
    segments = {task: [InferenceRequest(task, np.asarray(ids, np.int32),
                                        np.asarray(types, np.int32))
                       for b in bodies.get(task, []) + short[task]
                       for ids, types in _route_parts(
                           task, b, tokenizer, engine.max_bucket)]
                for task in short}
    segments["squad"] = list(squad_reqs) + segments["squad"]
    out["squad_segments"] = segments["squad"]

    def parts(x):
        return x if isinstance(x, tuple) else (x,)

    def max_diff(xs, ys):
        # over the common length: a token request read at a row-mate's
        # offset may run past the row's end
        pairs = [(np.atleast_1d(a), np.atleast_1d(b))
                 for x, y in zip(xs, ys) if x is not None
                 for a, b in zip(parts(x), parts(y))]
        return max(float(np.abs(a[:len(b)] - b[:len(a)]).max())
                   for a, b in pairs)

    for task, reqs in sorted(segments.items()):
        packed, shifted = _engine_answers(np, engine, task, reqs,
                                          engine.max_segments)
        alone, _ = _engine_answers(np, engine, task, reqs, 1)
        shared = sum(s is not None for s in shifted)
        err = max_diff(packed, alone)
        fault = max_diff(shifted, alone) if shared else 0.0
        tol = PACK_REL * max(float(np.abs(a).max()) for x in alone
                             for a in parts(x))
        log(f"serve: {task}: {len(reqs)} segments, {shared} sharing a row "
            f"when packed: packed vs one a row max |diff| {err:.4g} (tol "
            f"{tol:.4g}, 2^-7 of the largest |output|); a planted demux "
            f"fault (a row-mate's segment) reads {fault:.4g}")
        check(shared >= 2, f"{task}: only {shared} segments share a row "
              "when packed: the comparison would hold nothing")
        check(err <= tol, f"{task} packed vs one a row: {err} > {tol}")
        check(fault > tol, f"{task}: the planted demux fault reads "
              f"{fault}, inside {tol}")
        check(task != "squad" or err == 0.0, f"squad packed vs one a row: "
              f"{err}, want 0 (the QA head's row products)")
        out["packed_vs_padded"][task] = {
            "segments": len(reqs), "sharing_a_row": shared,
            "max_abs_err": err, "tol": tol,
            "planted_demux_fault_err": fault}

    # per task: one packed 512 forward (the squad phase's batch): exact
    # launches, host clock and device time by class
    out["forward512"] = {}
    want = dict({k: 0 for k in LAUNCHES}, layer_norm_fwd=2 * layers + 1,
                flash_attention_fwd=layers)
    for task in engine.tasks:
        reset_launches()
        engine.forward(task, batch512)
        got = dict(LAUNCHES)
        check(not on_card or got == want,
              f"{task} 512 forward launches {got}, want {want}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.forward(task, batch512)
            times.append((time.perf_counter() - t0) * 1e3)
        classes = (_profile_forward(torch, engine, batch512, task)
                   if on_card else {})
        out["forward512"][task] = {
            "launches": got, "host_ms": statistics.median(times),
            "device_ms": classes, "device_total_ms": sum(classes.values())}
        log(f"serve: {task} 512-bucket forward: launches {got}; "
            f"{statistics.median(times):.2f} ms (median of 5, host clock); "
            f"device {sum(classes.values()):.3f} ms by class {classes}")
    return out


# -- serving: the graphs, the weight copies, the planes -----------------------

# the rate and length of the fixed-load run, the ramp after it (each rate
# for LOAD_RAMP_S seconds, stopping where p99 passes LOAD_BOUND_MS; it
# starts above the fixed rate, which the fixed run has measured), and the
# client: bert_pytorch_tpu_torch/tools/serve_load.py in its own process
LOAD_RATE, LOAD_S = 100.0, 20.0
LOAD_RAMP = (120, 140, 160, 200, 240, 280)
LOAD_RAMP_S, LOAD_BOUND_MS = 4.0, 1000.0
# the int8 accuracy gate, run_server's default --int8_max_delta
INT8_MAX_DELTA = 0.1
SERVE_LOAD = os.path.join(HERE, "bert_pytorch_tpu_torch", "tools",
                          "serve_load.py")


def bucket_batch(np, rng, rows: int, bucket: int, vocab: int,
                 max_segments: int = 8):
    """A (rows, bucket) packed batch of random tokens: each row holds 1 to
    `max_segments` segments of random lengths and a pad tail."""
    from bert_pytorch_tpu_torch.serving.engine import zero_batch

    batch = zero_batch(rows, bucket)
    for row in range(rows):
        n = int(rng.randint(1, max_segments + 1))
        cursor = 0
        for seg in range(n):
            ln = int(rng.randint(2, max(3, bucket // n)))
            if cursor + ln > bucket:
                break
            sl = slice(cursor, cursor + ln)
            batch["input_ids"][row, sl] = rng.randint(5, vocab, ln)
            batch["token_type_ids"][row, sl] = np.arange(ln) >= ln // 2
            batch["attention_mask"][row, sl] = 1
            batch["segment_ids"][row, sl] = seg + 1
            batch["position_ids"][row, sl] = np.arange(ln)
            cursor += ln
    return batch


def _same(np, a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(a, b))


def _event_ms(torch, fn, reps: int) -> float:
    """Median device ms of fn() by CUDA events around each call."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _forward_times(torch, np, engine, model, spec, task, batch, on_card):
    """The 512 forward of `task`: host clock of engine.forward (the
    replay, the copies in and out), device ms of the replay alone and of
    the eager forward alone (CUDA events, median of 20)."""
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.forward(task, batch)
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"host_ms": statistics.median(times)}
    if on_card:
        graph = engine.graph(task, engine.max_bucket)
        out["replay_device_ms"] = _event_ms(torch, graph.replay, 20)
        tb = {k: torch.from_numpy(v).to(engine.device)
              for k, v in batch.items()}
        fwd = spec.forward_builder(model)
        with torch.inference_mode():
            out["eager_device_ms"] = _event_ms(torch, lambda: fwd(tb), 20)
    return out


def serve_graph_checks(torch, np, handle, config, ckpts, batch512, opts,
                       device):
    """The bf16 server's graphs and weights: every (task, bucket) replay
    bit-equal to the eager forward on a packed batch; each task's bf16
    copy bit-equal to its f32-master model (the checkpoint's f32 weights,
    cast at use) at the 512 bucket; the resident weights of both; the 512
    forward's host clock and device time (replay and eager)."""
    from bert_pytorch_tpu_torch.serving.quantize import resident_bytes
    from bert_pytorch_tpu_torch.tasks import registry

    on_card = torch.device(device).type == "cuda"
    engine = handle.engine
    rng = np.random.RandomState(5)
    mismatched = []
    for task in engine.tasks:
        for bucket in engine.buckets:
            b = bucket_batch(np, rng, engine.batch_rows, bucket,
                             config.vocab_size)
            if not _same(np, engine.forward(task, b),
                         engine.forward_eager(task, b)):
                mismatched.append(f"{task}/{bucket}")
    log(f"serve: graphs: {len(engine.tasks) * len(engine.buckets)} (task, "
        f"bucket) replays against the eager forward: "
        f"{'bit-equal' if not mismatched else 'DIFFER at ' + str(mismatched)}")
    check(not mismatched, f"graph replay differs from the eager forward at "
          f"{mismatched}")
    out = {"replay_vs_eager": "bit-equal", "resident_weight_bytes": {},
           "forward512": {}}
    master_differs = []
    for task in engine.tasks:
        spec = registry.get(task)
        master = spec.build_serving_model(config, torch.bfloat16, opts,
                                          device)
        master.load_state_dict(torch.load(ckpts[task], map_location=device,
                                          weights_only=True), strict=True)
        master.eval()
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch512.items()}
        with torch.inference_mode():
            want = spec.forward_builder(master)(tb)
        want = tuple(t.float().cpu().numpy() for t in
                     (want if isinstance(want, tuple) else (want,)))
        got = engine.forward_eager(task, batch512)
        if not _same(np, got if isinstance(got, tuple) else (got,), want):
            master_differs.append(task)
        out["resident_weight_bytes"][task] = {
            "bfloat16": resident_bytes(handle.models[task]),
            "float32": resident_bytes(master)}
        del master
        out["forward512"][task] = _forward_times(
            torch, np, engine, handle.models[task], spec, task, batch512,
            on_card)
    if on_card:
        torch.cuda.empty_cache()
    check(not master_differs, f"the bf16 copy differs from the f32-master "
          f"model at {master_differs}")
    out["bf16_copy_vs_f32_master"] = "bit-equal"
    log(f"serve: bf16 weight copy bit-equal to the f32-master model on "
        f"{list(engine.tasks)}; resident weights {out['resident_weight_bytes']}"
        f"; 512 forward {out['forward512']}")
    return out


def _trace_squad(torch, model, batch):
    """The SQuAD model's forward op by op on `batch` (eager, the served
    weights), every intermediate kept: the embeddings; per layer the QKV
    projection, attention (plain attention split into the f32 scores, the
    softmax and P.V; the flash route as the kernel's output), the output
    projection, the first LayerNorm, the MLP's two products, its
    activation and the second LayerNorm; the logits as one cuBLAS GEMM
    and as the model's row products."""
    from bert_pytorch_tpu_torch.models.bert import _linear, _row_linear
    from bert_pytorch_tpu_torch.ops.attention import (
        _scores, dot_product_attention, make_attention_bias,
        make_segment_attention_bias, takes_flash)

    bert = model.bert
    ops = {}
    with torch.inference_mode():
        seg = batch["segment_ids"]
        bias = make_attention_bias(batch["attention_mask"]).contiguous()
        x = bert.embeddings(batch["input_ids"], batch["token_type_ids"],
                            batch["position_ids"], bert.dtype)
        ops["embeddings"] = x
        for i, layer in enumerate(bert.encoder.layers):
            att = layer.attention
            b, s, _ = x.shape
            qkv = _linear(x, att.qkv)
            ops[f"{i}.qkv"] = qkv
            qkv = qkv.view(b, s, 3, att.n_heads, att.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if takes_flash(q, k):
                ctx = dot_product_attention(q, k, v, bias,
                                            seg.to(torch.int32).contiguous())
                ops[f"{i}.flash"] = ctx
            else:
                scores = (_scores(q, k) + bias.float()
                          + make_segment_attention_bias(seg))
                ops[f"{i}.scores"] = scores
                probs = torch.softmax(scores, dim=-1)
                ops[f"{i}.softmax"] = probs
                ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
                ops[f"{i}.pv"] = ctx
                ctx = ctx * (seg > 0).to(ctx.dtype)[:, :, None, None]
            attn = _linear(ctx.reshape(b, s, -1), att.output)
            ops[f"{i}.attn_out"] = attn
            x = layer.attention_layer_norm(attn, x)
            ops[f"{i}.ln1"] = x
            inter = _linear(x, layer.intermediate)
            ops[f"{i}.intermediate"] = inter
            inter = layer.act(inter)
            ops[f"{i}.act"] = inter
            mlp = _linear(inter, layer.mlp_output)
            ops[f"{i}.mlp_out"] = mlp
            x = layer.output_layer_norm(mlp, x)
            ops[f"{i}.ln2"] = x
        # the QA head as one cuBLAS GEMM at N = 2 (its former route), and
        # as the model computes it (row products: models/bert.py)
        ops["qa_gemm"] = _linear(x, model.qa_outputs).float()
        ops["qa_logits"] = _row_linear(x, model.qa_outputs).float()
    return ops


def packed_span_diagnosis(torch, np, handle, reqs, device):
    """ROADMAP queue C item 2: the SQuAD segments of the packed check
    (`reqs`), packed (8 a row) and one a row into the engine's batches as
    the check forms them, run op by op through the served SQuAD model;
    for each op, the largest difference over each request's own token
    span (its own keys for the scores and the softmax), by bucket. Names
    the first op that differs in each bucket."""
    from bert_pytorch_tpu_torch.data.packing import first_fit
    from bert_pytorch_tpu_torch.serving.batcher import pack_requests

    engine = handle.engine
    model = handle.models["squad"]
    spans = {"packed": {}, "alone": {}}
    for mode, segs in (("packed", engine.max_segments), ("alone", 1)):
        pending = list(reqs)
        while pending:
            bucket = engine.select_bucket(pending[0].length)
            wave = [r for r in pending if r.length <= bucket]
            bins = first_fit([r.length for r in wave], engine.batch_rows,
                             bucket, segs)
            batch, placements = pack_requests(wave, bins, engine.batch_rows,
                                              bucket)
            tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            ops = _trace_squad(torch, model, tb)
            rows = {}
            for _, row, _, _ in placements:
                rows[row] = rows.get(row, 0) + 1
            for r, row, off, _ in placements:
                n = r.length
                cut = {}
                for name, t in ops.items():
                    t = t[row]
                    cut[name] = (t[:, off:off + n, off:off + n]
                                 if name.endswith(("scores", "softmax"))
                                 else t[off:off + n]).float().cpu()
                spans[mode][id(r)] = (bucket, rows[row] > 1, cut)
            del ops
            placed = {id(p[0]) for p in placements}
            pending = [r for r in pending if id(r) not in placed]
    by_bucket = {}
    for r in reqs:
        bucket, shared, got = spans["packed"][id(r)]
        want = spans["alone"][id(r)][2]
        d = by_bucket.setdefault(str(bucket), {"segments": 0, "shared": 0,
                                               "ops": {}})
        d["segments"] += 1
        d["shared"] += int(shared)
        for name, t in got.items():
            diff = float((t - want[name]).abs().max())
            d["ops"][name] = max(d["ops"].get(name, 0.0), diff)
    for d in by_bucket.values():
        d["first_differing_op"] = next((k for k, v in d["ops"].items()
                                        if v > 0), None)
    log("serve: queue C item 2: SQuAD segments packed vs alone, by bucket: "
        + "; ".join(f"{b}: {d['segments']} segments ({d['shared']} sharing "
                    f"a row), first op that differs {d['first_differing_op']}"
                    f" ({d['ops'].get(d['first_differing_op'])}), the "
                    f"head as one GEMM {d['ops']['qa_gemm']:.4g}, as row "
                    f"products {d['ops']['qa_logits']:.4g}"
                    for b, d in sorted(by_bucket.items(),
                                       key=lambda kv: int(kv[0]))))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return by_bucket


_SERVE_FAMILIES = (
    "bert_serve_requests_total", "bert_serve_request_latency_ms",
    "bert_serve_queue_depth", "bert_serve_batches_total",
    "bert_serve_real_tokens_total", "bert_serve_slot_tokens_total",
    "bert_serve_batch_occupancy", "bert_serve_batch_segments",
    "bert_serve_device_seconds_total", "bert_serve_cost_per_1k_tokens",
    "bert_serve_cost_per_device_hour", "bert_serve_model_params")


def serve_planes(np, handle):
    """GET /metrics carries the twelve bert_serve_* families with the
    requests served so far; a POST's X-Trace-Id finds its spans, admit to
    respond, in GET /v1/traces (strict JSON)."""
    from bert_pytorch_tpu_torch.telemetry.registry import parse_prometheus

    with urllib.request.urlopen(handle.url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    fams = {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE bert_serve_")}
    series = parse_prometheus(text)
    ok = sum(v for k, v in series["bert_serve_requests_total"].items()
             if 'outcome="ok"' in k)
    real = sum(series["bert_serve_real_tokens_total"].values())
    slots = sum(series["bert_serve_slot_tokens_total"].values())
    check(fams == set(_SERVE_FAMILIES), f"/metrics families {sorted(fams)}")
    check(ok > 0 and 0 < real <= slots, f"/metrics: ok {ok}, real tokens "
          f"{real}, slots {slots}")
    req = urllib.request.Request(
        handle.url + "/v1/squad", data=json.dumps(
            {"question": QUESTIONS[0], "context": "the cat sat on a mat ."}
        ).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        header = r.headers["X-Trace-Id"]
    check(bool(header) and header.startswith("squad-"),
          f"X-Trace-Id {header!r}")

    def strict(token):
        raise ValueError(f"non-strict JSON token {token}")

    def traces(query):
        with urllib.request.urlopen(handle.url + "/v1/traces" + query,
                                    timeout=60) as r:
            return json.loads(r.read(), parse_constant=strict)

    # the ring keeps the slowest traces and every K-th: look one of those
    # up by its id
    slowest = traces("?n=1")
    trace_id = slowest["traceEvents"][0]["args"]["trace_id"]
    doc = traces("?id=" + trace_id)
    spans = [e["name"] for e in doc["traceEvents"]]
    want = ["req/" + s for s in ("admit", "queue_wait", "pack", "dispatch",
                                 "compute", "demux", "respond")]
    check(spans == want, f"/v1/traces?id={trace_id}: spans {spans}")
    compute = [e for e in doc["traceEvents"] if e["name"] == "req/compute"]
    log(f"serve: /metrics: {len(fams)} bert_serve_* families, {ok:g} ok "
        f"requests, {real:g} real of {slots:g} slot tokens; /v1/traces: "
        f"{trace_id} spans {spans}")
    return {"families": sorted(fams), "ok_requests": ok,
            "real_tokens": real, "slot_tokens": slots, "trace_id": trace_id,
            "spans": spans, "retained": slowest["metadata"],
            "compute_device_seconds": compute[0]["args"]["device_seconds"],
            "cost_per_1k_tokens": series.get(
                "bert_serve_cost_per_1k_tokens")}


def serve_load(np, handle, vocab, on_card):
    """The fixed offered load: tools/serve_load.py, in a process of its
    own, sends Poisson arrivals at LOAD_RATE for LOAD_S seconds, an even
    mix of the five routes over this script's synthetic requests, then
    the ramp. A CPU rehearsal sends 20 requests/s for 1 s, no ramp."""
    rate, secs = (LOAD_RATE, LOAD_S) if on_card else (20.0, 1.0)
    ramp = ",".join(str(r) for r in LOAD_RAMP) if on_card else ""
    busy0, t_load0 = handle.scheduler.stats()["busy_s"], time.perf_counter()
    proc = subprocess.run(
        [sys.executable, SERVE_LOAD, "--url", handle.url, "--rate",
         str(rate), "--duration", str(secs), "--ramp", ramp,
         "--ramp_duration", str(LOAD_RAMP_S), "--bound_ms",
         str(LOAD_BOUND_MS), "--vocab", vocab], capture_output=True,
        text=True, timeout=900)
    check(proc.returncode == 0, f"serve_load exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    # each scheduler thread's busy share over the whole load run (the
    # fixed leg and the ramp): the one nearest 1 holds the others back
    wall = time.perf_counter() - t_load0
    res["busy_share"] = {
        stage: round((s - busy0[stage]) / wall, 4)
        for stage, s in handle.scheduler.stats()["busy_s"].items()}
    fixed = res["fixed"]
    res["diagnosis"] = load_diagnosis(fixed, secs)
    if fixed["ok"] != fixed["sent"]:
        log(f"serve: fixed load diagnosis {json.dumps(res['diagnosis'])}; "
            f"the slowest traces' spans {fixed.get('slowest_traces')}; "
            f"scheduler busy shares {res['busy_share']}")
    check(not fixed["no_status"], f"fixed load: {len(fixed['no_status'])} "
          f"request(s) got no status: {fixed['no_status'][:5]}")
    check(fixed["ok"] == fixed["sent"] > 0, f"fixed load: {fixed['ok']} of "
          f"{fixed['sent']} answered 200 ({fixed['codes']})")
    log(f"serve: load {rate:g} req/s for {secs:g} s: {fixed['sent']} sent, "
        f"p50 {fixed['p50_ms']:.2f} ms, p99 {fixed['p99_ms']:.2f} ms (by "
        f"route {fixed['by_route']}; the slowest traces' spans "
        f"{fixed['slowest_traces']}; featurization ms a request, one "
        f"thread {res.get('featurize_ms')}); ramp "
        + ", ".join(f"{r['rate']:g}: p99 {r['p99_ms']}" for r in res["ramp"])
        + f"; p99 passes {LOAD_BOUND_MS:g} ms at "
        f"{res['p99_passes_bound_at']} req/s; scheduler busy shares over "
        f"the run {res['busy_share']}")
    return res


def load_diagnosis(fixed: dict, secs: float) -> dict:
    """What a fixed-load leg's sheds and unanswered requests say: each
    shed request's send time in the leg, the scheduler's queue depth a
    second over the leg, and where the sheds fall: "start" when they all
    fall in the leg's first tenth (something not yet warm), "spread"
    when they span more than a third of it (the host does not keep up
    with the rate), "burst" otherwise (a stall of the server)."""
    shed = fixed.get("shed_at_s") or []
    where = None
    if shed:
        span = shed[-1] - shed[0]
        where = ("start" if shed[-1] <= secs / 10 else
                 "spread" if span > secs / 3 else "burst")
    depth = [d for _, d in fixed.get("queue_depth") or [] if d is not None]
    return {"shed": len(shed), "shed_at_s": shed[:200], "where": where,
            "queue_depth": fixed.get("queue_depth"),
            "max_queue_depth": max(depth) if depth else None,
            "no_status": fixed.get("no_status")}


def drain_drill(np, handle):
    """The graceful drain: with a request in flight (the engine held 1 s
    by a host-side delay), admission stops: a new request gets 503 with
    Retry-After, /healthz reads draining, the admitted one gets 200, and
    the drain finishes within its deadline."""
    engine = handle.engine
    forward = engine.forward
    started = threading.Event()

    def held(task, batch):
        started.set()
        time.sleep(1.0)
        return forward(task, batch)

    engine.forward = held
    body = {"question": QUESTIONS[1], "context": "the dog ran in the park ."}
    got = {}
    th = threading.Thread(target=lambda: got.setdefault(
        "reply", _post(handle.url, body)))
    try:
        th.start()
        check(started.wait(60), "drain: the held request never reached the "
              "engine")
        handle.frontend.begin_drain()
        req = urllib.request.Request(
            handle.url + "/v1/squad", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            code, retry = 200, None
        except urllib.error.HTTPError as e:
            code, retry = e.code, e.headers.get("Retry-After")
        with urllib.request.urlopen(handle.url + "/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        th.join(120)
    finally:
        engine.forward = forward
    t0 = time.perf_counter()
    drained = handle.drain(30.0, log=lambda m: log("serve: " + m))
    drain_s = time.perf_counter() - t0
    check(code == 503 and retry == "5", f"drain: new request got {code} "
          f"(Retry-After {retry})")
    check(health["draining"] is True and health["inflight"] == 1,
          f"drain: /healthz draining {health.get('draining')}, inflight "
          f"{health.get('inflight')}")
    check(got.get("reply", (None,))[0] == 200, f"drain: the admitted "
          f"request got {got.get('reply', (None,))[0]}")
    check(drained, "drain: admitted requests still in flight at the "
          "deadline")
    log(f"serve: drain drill: new request 503 (Retry-After {retry}), "
        f"admitted one 200, drained in {drain_s:.3f} s")
    return {"new_request": code, "retry_after": retry,
            "admitted_request": 200, "drain_s": drain_s}


def serve_int8(torch, np, argv, ckpts, batch512, device):
    """A second server with --serve_dtype int8 on the same checkpoints:
    the decode gate passes on the five tasks at INT8_MAX_DELTA (rel_delta,
    argmax_agreement), the resident weights, each task's 512 forward
    (exact launches, host clock, device time); then corrupted scales
    (quantize.corrupt_scales) must make the server refuse to start."""
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.serving import quantize as quant_lib
    from bert_pytorch_tpu_torch.tasks import registry

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    handle = run_server.serve(
        run_server.parse_arguments(argv + ["--serve_dtype", "int8",
                                           "--int8_max_delta",
                                           str(INT8_MAX_DELTA)]),
        log=lambda m: log("serve: int8: " + m))
    out = {"start_s": time.perf_counter() - t0, "gate": INT8_MAX_DELTA}
    try:
        engine = handle.engine
        deltas = handle.int8_deltas
        check(sorted(deltas) == sorted(engine.tasks)
              and all(d["rel_delta"] <= INT8_MAX_DELTA
                      for d in deltas.values()), f"int8 gate: {deltas}")
        out["deltas"] = deltas
        out["resident_weight_bytes"] = {
            t: quant_lib.resident_bytes(m) for t, m in handle.models.items()}
        layers = handle.models["squad"].bert.config.num_hidden_layers
        want = dict({k: 0 for k in LAUNCHES}, layer_norm_fwd=2 * layers + 1,
                    flash_attention_fwd=layers)
        out["forward512"] = {}
        for task in engine.tasks:
            reset_launches()
            engine.forward(task, batch512)
            got = dict(LAUNCHES)
            check(not on_card or got == want,
                  f"int8 {task} 512 forward launches {got}, want {want}")
            out["forward512"][task] = dict(
                _forward_times(torch, np, engine, handle.models[task],
                               registry.get(task), task, batch512, on_card),
                launches=got)
        log(f"serve: int8: gate {INT8_MAX_DELTA}: " + ", ".join(
            f"{t} rel_delta {d['rel_delta']:.4g} argmax "
            f"{d['argmax_agreement']:.4g}" for t, d in sorted(deltas.items()))
            + f"; resident weights {out['resident_weight_bytes']}; 512 "
            f"forward {out['forward512']}")
    finally:
        handle.close()
    del handle
    # corrupted scales: the gate must refuse to serve
    real = quant_lib.quantize_tree

    def corrupted(*a, **kw):
        qstate, stats = real(*a, **kw)
        return quant_lib.corrupt_scales(qstate), stats

    squad_only = [a for i, a in enumerate(argv)
                  if not (a == "--task_checkpoint"
                          and not argv[i + 1].startswith("squad="))
                  and not (i and argv[i - 1] == "--task_checkpoint"
                           and not a.startswith("squad="))]
    quant_lib.quantize_tree = corrupted
    try:
        run_server.serve(run_server.parse_arguments(
            squad_only + ["--serve_dtype", "int8"]), log=lambda m: None)
        refused = None
    except SystemExit as e:
        refused = str(e)
    finally:
        quant_lib.quantize_tree = real
    check(refused is not None and "int8 accuracy gate" in refused,
          f"int8: corrupted scales were served ({refused!r})")
    out["corrupt_scales"] = refused
    log(f"serve: int8: corrupted scales refused: {refused}")
    if on_card:
        torch.cuda.empty_cache()
    return out


# -- training -----------------------------------------------------------------

PHASE1_CONFIG = os.path.join(HERE, "configs",
                             "bert_pretraining_phase1_config.json")
PHASE2_CONFIG = os.path.join(HERE, "configs",
                             "bert_pretraining_phase2_config.json")
TRAIN_STEPS = 3
# f32 kernels against plain versions on one microbatch (the contract's
# tolerances). bf16: both sides round every kernel output to bf16 from f32
# values that differ in their last f32 bits, so single elements land one
# bf16 step (2^-8 relative) apart; 24 layers carry those differences into
# every gradient.
# Measured on the card (PERF.md): loss 2.1e-5 relative, worst gradient
# 1.9e-2 relative L2 (the position embeddings, a sum over the batch of
# per-token gradients that mostly cancel); the tolerance leaves 2.5x.
TRAIN_MODEL_TOL = {"float32": {"loss": 1e-5, "grad": 2e-4},
                   "bfloat16": {"loss": 1e-3, "grad": 5e-2}}
# Phase 2 (16 x 512, flash attention in both directions), measured on the
# card (PERF.md): bf16 loss 2.1e-5 relative, worst gradient 2.2e-2
# relative L2 (again the position embeddings); the gradient tolerance
# leaves 2.5x. f32: the contract's tolerances, as in phase 1.
TRAIN2_MODEL_TOL = {"float32": {"loss": 1e-5, "grad": 2e-4},
                    "bfloat16": {"loss": 1e-3, "grad": 5.5e-2}}
# The two pretraining runs: the run config, its microbatch (the config's
# local_batch_size) and sequence, the global batch of the cut run
# (accumulation 2), the synthetic samples per shard (two shards), the rows
# of the f32 kernels-vs-plain check, and whether seq > 256 sends attention
# through the flash kernels.
TRAIN_RUNS = {
    "train": {"config": PHASE1_CONFIG, "micro": 96, "seq": 128,
              "global_batch": 192, "samples": 320, "f32_rows": 96,
              "flash": False, "tol": TRAIN_MODEL_TOL},
    "train_phase2": {"config": PHASE2_CONFIG, "micro": 16, "seq": 512,
                     "global_batch": 32, "samples": 64, "f32_rows": 16,
                     "flash": True, "tol": TRAIN2_MODEL_TOL},
}


def pretraining_arrays(np, n: int, seq: int, vocab: int, seed: int):
    """`n` synthetic pretraining samples in the shard schema (input_ids,
    special_token_positions, next_sentence_labels): [CLS] a [SEP] b [SEP]
    with both segments' lengths drawn at random, then padding."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, (n, seq)).astype(np.int32)
    specials = np.zeros((n, 3), np.int32)
    for i in range(n):
        last = int(rng.randint(seq // 2, seq))
        sep1 = int(rng.randint(8, last - 8))
        ids[i, 0], ids[i, sep1], ids[i, last] = 101, 102, 102
        ids[i, last + 1:] = 0
        specials[i] = (0, sep1, last)
    nsp = rng.randint(0, 2, n).astype(np.int8)
    return {"input_ids": ids, "special_token_positions": specials,
            "next_sentence_labels": nsp}


def array_index(shards):
    """A data.sharded.ShardIndex over shards held in memory (dicts of the
    shard schema's arrays): the chip machine has no h5py, so only the
    file read differs from the entry point's run."""
    from bert_pytorch_tpu_torch.data.sharded import ShardIndex

    class ArrayIndex(ShardIndex):
        def __init__(self):  # noqa: D107 (no files to open)
            self.files = [f"memory:{i}" for i in range(len(shards))]
            self.starts = [0]
            for sh in shards[:-1]:
                self.starts.append(self.starts[-1] + len(sh["input_ids"]))
            self.total = self.starts[-1] + len(shards[-1]["input_ids"])

        def load(self, fi):
            return dict(shards[fi])

        def seq_len(self):
            return int(shards[0]["input_ids"].shape[1])

    return ArrayIndex()


def _device_ms(ev, self_only=False) -> float:
    """Device time of a profiler event average, in ms."""
    key = "self_device_time_total" if self_only else "device_time_total"
    us = getattr(ev, key, None)
    if us is None:
        us = getattr(ev, key.replace("device", "cuda"), 0)
    return (us or 0) / 1e3


def _device_call_ms(torch, fn, reps: int = 3) -> dict:
    """Device ms of one fn() call, median of `reps`, by CUDA events around
    the call. A spin queued on the card ahead of the start event outlasts
    the call's host time (twice its host-clock ms between
    synchronizations, plus 20 ms), so the card starts the call's work
    once the host has queued all of it and the events hold device time
    alone: `host_hidden` says the start event was still pending when the
    host finished. A call of more launches than the card's queue holds
    (or one that synchronizes inside) cannot be hidden so; its device_ms
    is then the profiler's sum of its kernels (`by` names the method, and
    `events_ms` keeps the events' reading). Fails on a time of 0."""
    fn()
    torch.cuda.synchronize()
    host_ms = _host_ms(torch, fn)
    cycles = int((2 * host_ms + 20) * Timer.SPIN_CYCLES / 20)
    times, hidden = [], True
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        hidden = hidden and not start.query()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out = {"host_ms": host_ms, "events_ms": statistics.median(times),
           "host_hidden": hidden}
    out["by"] = "events" if hidden else "profiler"
    out["device_ms"] = (out["events_ms"] if hidden
                        else _device_total_ms(torch, fn))
    check(out["device_ms"] > 0, f"a call's device time read {out}")
    return out


def trace_summary_of(prof, steps=None, top_ops: int = 20) -> dict:
    """A finished torch.profiler run's Chrome trace read by the port's
    telemetry/trace.py, the one classifier of device time that
    --profile_steps and tools/trace_summary.py use too."""
    from bert_pytorch_tpu_torch.telemetry.trace import (load_trace_events,
                                                        summarize_events)

    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return summarize_events(load_trace_events(path), steps=steps,
                                top_ops=top_ops)
    finally:
        os.unlink(path)


def _checked_device_total(prof) -> float:
    """A finished profile's device total, read by telemetry/trace.py
    (kernels, copies and memsets merged per stream). The profiler's own
    per-event sum of the same profile must agree within 1%."""
    total = trace_summary_of(prof)["device_ms"]
    events = sum(_device_ms(ev) for ev in prof.key_averages()
                 if str(getattr(ev, "device_type", "")).split(".")[-1]
                 == "CUDA")
    check(abs(total - events) <= 0.01 * max(total, events),
          f"device time: the trace reads {total} ms, the profiler's events "
          f"{events} ms")
    return total


def _device_total_ms(torch, fn) -> float:
    """Device time of one fn() call: torch.profiler tracing the card
    alone (without the CPU's op events the same total, 118.95 against
    118.99 ms on a phase-2 step, in 2-3 s of profiling instead of 7:
    PERF.md), read by `_checked_device_total`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _checked_device_total(prof)


def _profile_step(torch, step_fn, state, batch, seeds):
    """One optimizer step under torch.profiler: device time by kernel
    class, by the PyTorch op that launched it (top 12), and the step's own
    host-clock ms between two synchronizations, profiler on; the fourth
    value is the same step's device total (`_checked_device_total` of
    this profile)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, batch, seeds)["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    classes, ops = {}, {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None:
            continue
        if str(ev.device_type).split(".")[-1] != "CUDA":
            if ev.key.startswith("aten::") and _device_ms(ev, True) > 0:
                ops[ev.key] = _device_ms(ev, True)
            continue
        us = _device_ms(ev) * 1e3
        if not us:
            continue
        name, low = ev.key, ev.key.lower()
        if "flash_fwd" in name:
            cls = "flash attention forward (#5/#6)"
        elif "flash_bwd_fused" in name:
            cls = "flash attention fused backward (#7/#8)"
        elif "flash_bwd_dq" in name:
            cls = "flash attention dq (#9)"
        elif "flash_bwd_dkv" in name:
            cls = "flash attention dk/dv (#10)"
        elif "column_sum_kernel" in name:
            cls = "layer norm backward column pass (#2, #4)"
        elif "ln_bwd" in name:  # ln_bwd_row_kernel, ln_bwd_kernel
            cls = "layer norm backward row pass (#2, #4)"
        elif "ln_fwd" in name:  # ln_fwd_row_kernel, ln_fwd_kernel
            cls = "layer norm forward kernels (#1, #3)"
        elif "lamb_stage" in name:
            cls = "fused LAMB kernels (#11, #12)"
        elif "multi_tensor" in low:
            cls = "torch._foreach_* (Adam's update, LAMB's trust norms)"
        elif any(t in low for t in ("gemm", "cutlass", "sm90_", "xmma",
                                    "cublas", "nvjet")):
            cls = "matmul (cuBLAS)"
        elif "softmax" in low:
            cls = "softmax (plain attention)"
        elif "reduce" in low or "norm" in low:
            cls = "reductions (norms, sums)"
        elif "elementwise" in low or "vectorized" in low:
            cls = "elementwise (casts, hash masks, dropout, GELU, LAMB)"
        else:
            cls = "other: " + name[:60]
        classes[cls] = classes.get(cls, 0.0) + us / 1e3
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])
    device_total = _checked_device_total(prof)
    return (dict(sorted(classes.items(), key=lambda kv: -kv[1])), top,
            wall_ms, device_total)


def _host_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock ms of fn() between two synchronizations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _loss_and_grads(torch, config, dtype, plain, weights, micro, seeds,
                    max_pred, device):
    """One microbatch's loss and f32 gradients through a fresh model
    holding `weights`: the kernels (plain=False) or the plain versions."""
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining

    with torch.device(device):
        model = BertForPreTraining(config, dtype=dtype, plain=plain)
    model.load_state_dict(weights)
    return _model_loss_and_grads(torch, model, micro, seeds, max_pred)


def _check_state_dicts_equal(torch, a, b, what):
    """Two TrainState.state_dict()s hold the same step, count and bits."""
    oa, ob = a["opt_state"], b["opt_state"]
    check(a["step"] == b["step"] and oa["count"] == ob["count"],
          f"{what}: step {a['step']} / {b['step']}, count {oa['count']} / "
          f"{ob['count']}")
    for name, x, y in (("params", a["params"], b["params"]),
                       ("mu", oa["mu"], ob["mu"]), ("nu", oa["nu"], ob["nu"])):
        bad = [k for k in y if k not in x or not torch.equal(x[k], y[k])]
        check(not bad and set(x) == set(y),
              f"{what}: {name} differ at {bad[:3]}")


# The seq-1024 model check: BERT-Large's widths (H 1024, A 16, I 4096) cut
# to 2 layers, the position table grown to 1024 on the in-memory config;
# one microbatch of 8 x 1024 in bf16 (160 predictions: the phase-2
# config's masked fraction of 1024 tokens) forward and backward through
# models/bert.py on the kernels and on the plain versions, at
# TRAIN2_MODEL_TOL. At seq 1024 every layer's flash backward takes the dq
# and dk/dv pair (#9/#10), never the fused kernel.
LONG_MODEL = {"layers": 2, "batch": 8, "seq": 1024, "max_pred": 160}


def phase_model_seq1024(torch, np, summary, device="cuda",
                        cfg_path=os.path.join(
                            HERE, "configs", "bert_large_uncased_config.json"),
                        batch=LONG_MODEL["batch"], seq=LONG_MODEL["seq"]):
    """One seq-`seq` microbatch through a LONG_MODEL["layers"]-layer model
    of `cfg_path`'s widths (LONG_MODEL): loss and gradients on the kernels
    (counts zeroed just before, read just after: the flash forward, dq and
    dk/dv once a layer, no fused backward) against the plain versions.
    `device`, `cfg_path`, `batch` and `seq` exist so the phase can be
    rehearsed on the CPU at a tiny size."""
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    layers, max_pred = LONG_MODEL["layers"], LONG_MODEL["max_pred"]
    on_card = torch.device(device).type == "cuda"
    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(
        vocab_size=pad_vocab_size(config.vocab_size, 8),
        num_hidden_layers=layers,
        max_position_embeddings=max(seq, config.max_position_embeddings))
    index = array_index([pretraining_arrays(np, 2 * batch, seq,
                                            config.vocab_size, 3)])
    loader = PretrainingDataLoader(
        index, HostShardSampler(len(index), seed=1), batch_size=batch,
        mask_token_index=103, max_pred_per_seq=max_pred, masked_lm_prob=0.15,
        vocab_size=config.vocab_size, seed=1)
    micro = {k: torch.from_numpy(v).to(device)
             for k, v in next(loader).items()}
    loader.close()
    with torch.device(device):
        model = BertForPreTraining(config, dtype=torch.bfloat16)
    init_weights(model, torch.Generator(device=device).manual_seed(2),
                 std=config.initializer_range)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    seeds = torch.randint(-2 ** 31, 2 ** 31, (1 + 3 * layers,),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(8))
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # the path: counts zeroed just before, read just after
    reset_launches()
    got = _loss_and_grads(torch, config, torch.bfloat16, False, weights,
                          micro, seeds, max_pred, device)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    want_ = _loss_and_grads(torch, config, torch.bfloat16, True, weights,
                            micro, seeds, max_pred, device)
    summary.setdefault("launches", {})["model_seq1024"] = launches
    # one microbatch: the embedding and MLM-transform LayerNorms, the two
    # residual tails of every layer, and every layer's attention by the
    # flash forward and the pair
    predicted = {"add_dropout_layer_norm_fwd": 2 * layers,
                 "add_dropout_layer_norm_bwd": 2 * layers,
                 "layer_norm_fwd": 2, "layer_norm_bwd": 2,
                 "flash_attention_fwd": layers, "flash_attention_bwd": 0,
                 "flash_attention_bwd_dq": layers,
                 "flash_attention_bwd_dkv": layers,
                 "lamb_stage1": 0, "lamb_stage2": 0}
    if on_card:
        check(launches == predicted, f"model_seq1024: launch counts "
              f"{launches}, want {predicted}")
    loss_rel = abs(got[0] - want_[0]) / abs(want_[0])
    worst, worst_name = 0.0, None
    for k, w in want_[1].items():
        rel = (torch.linalg.vector_norm(got[1][k] - w)
               / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, k
    tol = TRAIN2_MODEL_TOL["bfloat16"]
    log(f"model_seq1024: {layers} layers of hidden {config.hidden_size}, "
        f"{batch} x {seq} bf16, kernels vs plain: loss {got[0]:.6f} vs "
        f"{want_[0]:.6f} (rel {loss_rel:.3g}, tol {tol['loss']:g}); worst "
        f"gradient rel L2 {worst:.3g} at {worst_name} (tol {tol['grad']:g});"
        f" launches {launches}; peak memory {peak} GiB")
    check(np.isfinite(got[0]) and loss_rel <= tol["loss"],
          f"model_seq1024: loss kernels {got[0]} vs plain {want_[0]}")
    check(worst <= tol["grad"], f"model_seq1024: gradient {worst_name}: rel "
          f"L2 {worst} > {tol['grad']}")
    summary["model_seq1024"] = {
        "layers": layers, "batch": batch, "seq": seq, "loss": got[0],
        "plain_loss": want_[0], "loss_rel": loss_rel,
        "max_grad_rel_l2": worst, "worst_leaf": worst_name,
        "launches": launches, "launches_predicted": predicted,
        "peak_memory_gib": peak}

# ROADMAP queue C item 1: step 1's gradients of phase 1 in a fresh process
# and in this one after the phases before it (serve, by default)
def grad_probe(torch, np, device="cuda",
               cfg_path=os.path.join(HERE, "configs",
                                     "bert_large_uncased_config.json"),
               micro=96, seq=128, max_pred=20):
    """One phase-1 microbatch (seeded random BERT-Large, seeded data and
    dropout seeds) through the kernels: the loss, a digest of each
    layer's forward output, and a digest of each f32 gradient leaf."""
    import hashlib

    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.training.pretrain import (
        compute_params, pretrain_loss_and_grads)

    def digest(t):
        t = t.detach().contiguous()
        return hashlib.sha256(t.view(torch.uint8).cpu().numpy().tobytes()
                              ).hexdigest()[:16]

    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    index = array_index([pretraining_arrays(np, 2 * micro, seq,
                                            config.vocab_size, 3)])
    loader = PretrainingDataLoader(
        index, HostShardSampler(len(index), seed=1), batch_size=micro,
        mask_token_index=103, max_pred_per_seq=max_pred,
        masked_lm_prob=0.15, vocab_size=config.vocab_size, seed=1)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(loader).items()}
    loader.close()
    with torch.device(device):
        model = BertForPreTraining(config, dtype=torch.bfloat16)
    init_weights(model, torch.Generator(device=device).manual_seed(2),
                 std=config.initializer_range)
    seeds = torch.randint(-2 ** 31, 2 ** 31,
                          (1 + 3 * config.num_hidden_layers,),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(8))
    forward = {}
    hooks = [layer.register_forward_hook(
        lambda mod, args, out, i=i: forward.__setitem__(f"layer_{i}",
                                                         digest(out)))
        for i, layer in enumerate(model.bert.encoder.layers)]
    hooks.append(model.bert.embeddings.register_forward_hook(
        lambda mod, args, out: forward.__setitem__("embeddings",
                                                   digest(out))))
    gparams = compute_params(dict(model.named_parameters()), torch.bfloat16)
    loss, _, grads = pretrain_loss_and_grads(model, gparams, batch, seeds,
                                             max_pred)
    for h in hooks:
        h.remove()
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))
    out = {"loss": float(loss.item()), "grad_norm": float(norm.item()),
           "forward": forward,
           "grads": {k: digest(g.float()) for k, g in grads.items()},
           "order": [k for k, _ in model.named_parameters()]}
    del model, gparams, grads
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_train_order(torch, np, summary, device="cuda"):
    """ROADMAP queue C item 1: `grad_probe` in a fresh process and in
    this one after the phases that ran before it; compares the forward
    digests and the gradients leaf by leaf, and names the first forward
    output and the first gradient (in backward order: the heads, the last
    layer first, the embeddings last) that differ. A difference is
    recorded, not failed: it is the measurement."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("fresh_a", "fresh_b"):
            path = os.path.join(tmp, name + ".json")
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--grad_probe", path],
                                  capture_output=True, text=True,
                                  timeout=900)
            check(proc.returncode == 0, f"train_order: {name} exited "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            with open(path) as f:
                runs[name] = json.load(f)
    runs["after_" + "_".join(p for p in summary["phases"]
                             if p not in ("device", "build"))] = grad_probe(
        torch, np, device)
    repeats = embedding_backward_repeats(torch, np, device)
    names = list(runs)
    ref = runs[names[0]]
    backward = list(reversed(ref["order"]))
    out = {"runs": {n: {"loss": r["loss"], "grad_norm": r["grad_norm"]}
                    for n, r in runs.items()}}
    for n in names[1:]:
        r = runs[n]
        fwd = [k for k in ref["forward"] if r["forward"][k]
               != ref["forward"][k]]
        leaves = [k for k in backward if k in ref["grads"]
                  and r["grads"][k] != ref["grads"][k]]
        out[f"{n}_vs_{names[0]}"] = {
            "loss_equal": r["loss"] == ref["loss"],
            "forward_outputs_differ": fwd,
            "grad_leaves_differ": len(leaves),
            "first_grad_leaf_differs": leaves[0] if leaves else None,
            "grad_leaves": leaves[:8]}
    out["embedding_backward_repeats"] = repeats
    log("train_order: " + json.dumps(out))
    summary["train_order"] = out


def embedding_backward_repeats(torch, np, device, reps=5, tokens=96 * 128,
                               hidden=1024):
    """The two routes of an embedding row's gradient, each run `reps`
    times on the same seeded bf16 gradient of `tokens` positions: the
    embedding backward (aten.embedding_dense_backward) of a 2-row
    token-type table, of a 512-row position table and of the word table
    (back to back, and with freed memory refilled between calls), and the
    one-hot product (models/bert._select_rows) the token-type table
    takes; the number of distinct results of each (1: the same bits
    every time)."""
    import hashlib

    from bert_pytorch_tpu_torch.models.bert import _select_rows

    gen = torch.Generator(device=device).manual_seed(4)
    g = torch.randn(tokens, hidden, generator=gen, device=device
                    ).to(torch.bfloat16)
    rng = np.random.RandomState(4)
    ids = {"token_type (2 rows)": rng.randint(0, 2, tokens),
           "position (512 rows)": np.tile(np.arange(128), tokens // 128),
           "word (30528 rows)": rng.randint(0, 30528, tokens)}
    sizes = {"token_type (2 rows)": 2, "position (512 rows)": 512,
             "word (30528 rows)": 30528}

    def digest(t):
        return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()

    def poison(k):
        # fill freed memory with other bits before the next call, so a
        # result that reads memory it never wrote changes
        junk = torch.full((64 << 20,), float(k + 1), device=device)
        del junk

    out = {}
    for name, idx in ids.items():
        i = torch.from_numpy(idx).to(device)
        out["embedding_backward: " + name] = len({digest(
            torch.ops.aten.embedding_dense_backward(g, i, sizes[name], -1,
                                                    False))
            for _ in range(reps)})
        seen = set()
        for k in range(reps):
            poison(k)
            seen.add(digest(torch.ops.aten.embedding_dense_backward(
                g, i, sizes[name], -1, False)))
        out["embedding_backward, memory refilled between calls: "
            + name] = len(seen)
    i = torch.from_numpy(ids["token_type (2 rows)"]).to(device)
    table = torch.zeros(2, hidden, device=device, requires_grad=True)
    seen = set()
    for _ in range(reps):
        table.grad = None
        _select_rows(table, i, torch.bfloat16).backward(g)
        seen.add(digest(table.grad))
    out["one-hot product: token_type (2 rows)"] = len(seen)
    return out


def phase_train(torch, np, summary, device="cuda",
                cfg_path=os.path.join(HERE, "configs",
                                      "bert_large_uncased_config.json"),
                run="train", ckpt_dir=None):
    """One pretraining run of TRAIN_RUNS (`run`: "train" is phase 1,
    "train_phase2" phase 2): TRAIN_STEPS optimizer steps of a seeded
    random model at the run config's microbatch, accumulation 2, through
    the entry point's trainer under --fused_optim auto, saving checkpoints
    into `ckpt_dir` (every 2 steps and at the end, 2 kept); the launch
    counts; one optimizer step profiled, and the step and one LAMB update
    timed on the kernels and on route off; and one microbatch through the
    kernels against the plain versions. Phase 1 restores its last
    checkpoint and holds it against the state it saved; phase 2 runs in
    the same `ckpt_dir` with previous_phase_end_step set to phase 1's last
    step (a cut: the run config's is 7038), so it auto-resumes phase 1's
    state. `device` and `cfg_path` exist so the phase can be rehearsed on
    the CPU at a tiny size; the script itself runs BERT-Large on CUDA."""
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.telemetry.health import HealthConfig
    from bert_pytorch_tpu_torch.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu_torch.training.pretrain import (
        build_pretrain_step, compute_params, pretrain_loss_and_grads)
    from bert_pytorch_tpu_torch.training.state import make_train_state

    spec = TRAIN_RUNS[run]
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    start_step = 0
    if run == "train_phase2":
        prev = summary.get("train", {}).get("checkpoint")
        check(prev is not None and ckpt_dir is not None,
              "phase 2 resumes phase 1's checkpoint: run the train phase "
              "first, in the same checkpoint directory")
        start_step = prev["step"]
    try:
        args = run_pretraining.parse_arguments([
            "--config_file", spec["config"], "--model_config_file", cfg_path,
            "--input_dir", os.path.join(tmp, "data"),
            "--output_dir", ckpt_dir or os.path.join(tmp, "out"),
            "--global_batch_size", str(spec["global_batch"]),
            "--steps", str(TRAIN_STEPS), "--fused_optim", "auto",
            "--num_steps_per_checkpoint", "2", "--keep_checkpoints", "2",
            "--previous_phase_end_step", str(start_step),
            "--vocab_pad_multiple", "8", "--seed", "0", "--device", device,
            # phase 1's last (warm) step traced through --profile_steps
            *(["--profile_steps", f"{TRAIN_STEPS - 1},{TRAIN_STEPS}"]
              if run == "train" else [])])
        config = BertConfig.from_json_file(cfg_path)
        config = config.replace(vocab_size=pad_vocab_size(config.vocab_size,
                                                          8))
        layers, micro = config.num_hidden_layers, args.local_batch_size
        accum = spec["global_batch"] // micro
        seq = spec["seq"]
        t0 = time.perf_counter()
        shards = [pretraining_arrays(np, spec["samples"], seq,
                                     config.vocab_size, seed)
                  for seed in (0, 1)]
        index = array_index(shards)
        log(f"{run}: {len(index)} synthetic samples (seq {seq}) in "
            f"{len(shards)} in-memory shards, {time.perf_counter() - t0:.1f}"
            " s")

        ckpts = CheckpointManager(os.path.join(args.output_dir,
                                               "pretrain_ckpts"))
        before = ckpts.all_steps()
        # the main path: counts zeroed just before, read just after
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        result = run_pretraining.train(args, index,
                                       log=lambda m: log(f"{run}: {m}"))
        launches = dict(LAUNCHES)
        peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
                   if on_card else None)
        summary.setdefault("launches", {})[run] = launches
        losses = [r["loss"] for r in result.history]
        norms = [r["grad_norm"] for r in result.history]
        end_step = start_step + TRAIN_STEPS
        check(result.step == end_step and len(losses) == TRAIN_STEPS
              and result.state.opt_state.count == end_step,
              f"trainer ended at step {result.step} (LAMB count "
              f"{result.state.opt_state.count}) after {len(losses)} steps, "
              f"want {end_step} after {TRAIN_STEPS}")
        check(result.resumed_from == (start_step or None),
              f"resumed from {result.resumed_from}, want "
              f"{start_step or None}")
        saved = [s["step"] for s in result.saves]
        want_saved = [s for s in range(start_step + 1, end_step + 1)
                      if s % 2 == 0 or s == end_step]
        check(saved == want_saved, f"saved steps {saved}, want {want_saved}")
        kept = sorted({*before, *want_saved})[-2:]
        check(ckpts.all_steps() == kept, f"checkpoints on disk "
              f"{ckpts.all_steps()}, want the newest 2, {kept}")
        ckpt = {"step": end_step, "resumed_from": result.resumed_from,
                "restore_s": result.restore_s, "saves": result.saves,
                "gb": result.saves[-1]["bytes"] / 1e9}
        # the last checkpoint read back: the state the run ended with
        t0 = time.perf_counter()
        sd, extra, step = ckpts.restore(map_location=device)
        ckpt["reread_s"] = time.perf_counter() - t0
        _check_state_dicts_equal(torch, sd, result.state.state_dict(),
                                 f"{run}: checkpoint step {step} read back")
        del sd
        log(f"{run}: checkpoints: saved steps {saved} "
            f"({ckpt['gb']:.3f} GB each, save s "
            f"{[round(x['seconds'], 2) for x in result.saves]}); "
            + (f"resumed from step {result.resumed_from} in "
               f"{result.restore_s:.2f} s; " if result.resumed_from else "")
            + f"step {step} read back bit-equal in {ckpt['reread_s']:.2f} s "
            f"(sampler cursor {extra.get('sampler')})")
        check(result.accum_steps == accum == 2 and micro == spec["micro"],
              f"accumulation {result.accum_steps} x {micro}, want "
              f"2 x {spec['micro']}")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"non-finite losses {losses} or grad norms {norms}")
        # per microbatch: the two residual tails of every layer (#3/#4),
        # the embedding and MLM-transform LayerNorms (#1/#2), and at seq >
        # 256 every layer's attention (the flash forward and, bf16 at seq
        # 512, the fused backward; the dq and dk/dv pair never)
        micro_steps = accum * TRAIN_STEPS
        flash = layers * micro_steps if spec["flash"] else 0
        want = {"add_dropout_layer_norm_fwd": 2 * layers * micro_steps,
                "add_dropout_layer_norm_bwd": 2 * layers * micro_steps,
                "layer_norm_fwd": 2 * micro_steps,
                "layer_norm_bwd": 2 * micro_steps,
                "flash_attention_fwd": flash,
                "flash_attention_bwd": flash,
                "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0,
                "lamb_stage1": TRAIN_STEPS, "lamb_stage2": TRAIN_STEPS}
        if on_card:
            check(launches == want, f"launch counts {launches}, want {want}")
        step_ms = [r["step_ms"] for r in result.history]
        log(f"{run}: {TRAIN_STEPS} steps of {result.seqs_per_step} sequences"
            f" ({accum} x {micro} x {seq}): losses {losses}, grad norms "
            f"{norms}; learning rates "
            f"{[r['learning_rate'] for r in result.history]}; "
            f"step ms {step_ms}; seq/s "
            f"{[round(r['seq_per_sec'], 1) for r in result.history]}; peak "
            f"memory {peak_gb} GiB; launches {launches} (predicted "
            f"{want})")
        train = {"steps": len(result.history), "end_step": result.step,
                 "accum_steps": result.accum_steps,
                 "micro_batch": micro, "seq": seq, "losses": losses,
                 "grad_norms": norms, "launches_predicted": want,
                 "step_ms": step_ms,
                 "seq_per_sec": [r["seq_per_sec"] for r in result.history],
                 "peak_memory_gib": peak_gb, "launches": launches,
                 "checkpoint": ckpt}
        summary[run] = train
        if result.profile is not None:
            ps = result.profile["summary"]
            train["profile_steps"] = {
                "steps": result.profile["steps"],
                "device_ms": ps["device_ms"], "host_ms": ps["host_ms"],
                "idle_share": ps["idle_share"], "window_ms": ps["window_ms"],
                "device_busy_ms": ps["device_busy_ms"],
                "device_top_ops_ms": ps["device_top_ops_ms"]}
            log(f"{run}: --profile_steps {TRAIN_STEPS - 1},{TRAIN_STEPS}: "
                f"trace_summary of step(s) {result.profile['steps']}: device "
                f"{ps['device_ms']:.2f} ms, idle share {ps['idle_share']}, "
                f"host phases {ps['host_ms']}, top ops "
                f"{ps['device_top_ops_ms']}")
        del result

        # the same trainer's pieces, for a profile of one optimizer step
        # and the kernels-vs-plain check
        with torch.device(device):
            model = BertForPreTraining(config, dtype=torch.bfloat16)
        init_weights(model, torch.Generator(device=device).manual_seed(1),
                     std=config.initializer_range)
        weights = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
        loader = PretrainingDataLoader(
            index, HostShardSampler(len(index), seed=1),
            batch_size=accum * micro, mask_token_index=103,
            max_pred_per_seq=args.max_predictions_per_seq,
            masked_lm_prob=args.masked_token_fraction,
            vocab_size=config.vocab_size, seed=1)
        batch_np = next(loader)
        loader.close()
        batch = {k: torch.from_numpy(v.reshape(accum, micro, *v.shape[1:]))
                 .to(device) for k, v in batch_np.items()}
        gen = torch.Generator().manual_seed(7)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (accum, 1 + 3 * layers),
                              dtype=torch.int32, generator=gen)
        schedule = make_schedule("poly", args.learning_rate, args.max_steps,
                                 warmup=args.warmup_proportion)
        # LAMB on the kernels (the trainer's route) and on route off, over
        # one state
        txs = {"kernels": Lamb(schedule, fused="auto"),
               "off": Lamb(schedule, fused="off")}
        tx = txs["kernels"]
        state = make_train_state(model, tx)
        step_fns = {route: build_pretrain_step(
            model, t, schedule=schedule, accum_steps=accum,
            max_predictions=args.max_predictions_per_seq,
            grad_dtype=torch.bfloat16, health=HealthConfig())
            for route, t in txs.items()}
        step_fn = step_fns["kernels"]
        for fn in step_fns.values():
            fn(state, batch, seeds)["loss"].item()   # warm
        if on_card:
            # in turns, off / kernels / kernels / off: the host clock drifts
            order = ("off", "kernels", "kernels", "off")
            step_runs = {"off": [], "kernels": []}
            for route in order:
                step_runs[route].append(_host_ms(
                    torch, lambda: step_fns[route](state, batch, seeds)))
            step_ms = statistics.median(step_runs["kernels"])
            micro0 = {k: v[0] for k, v in batch.items()}
            gparams = compute_params(state.params, torch.bfloat16)
            holder = {}

            def fwd_bwd():
                holder["grads"] = pretrain_loss_and_grads(
                    model, gparams, micro0, seeds[0],
                    args.max_predictions_per_seq)[2]

            fb_ms = _host_ms(torch, fwd_bwd)
            lamb_runs = {"off": [], "kernels": []}
            for route in order:
                lamb_runs[route].append(_host_ms(torch, lambda: txs[
                    route].update(holder["grads"], state.opt_state,
                                  state.params)))
            lamb_ms = statistics.median(lamb_runs["kernels"])
            classes, top, prof_ms, device_total = _profile_step(
                torch, step_fn, state, batch, seeds)
            train["step_split"] = {"step_ms": step_ms,
                                   "forward_backward_ms": fb_ms,
                                   "lamb_ms": lamb_ms,
                                   "step_ms_by_route": step_runs,
                                   "lamb_ms_by_route": lamb_runs}
            # one stream: the card is idle for the rest of that same step
            idle = 1.0 - device_total / prof_ms
            check(idle >= 0.0, f"{run}: device time {device_total} ms "
                  f"exceeds the profiled step's {prof_ms} ms")
            if "profile_steps" in train:
                # the trainer's traced step against this step, both read
                # by telemetry/trace.py
                traced_ms = train["profile_steps"]["device_ms"]
                train["profile_steps"]["vs_profiled_step"] = (
                    traced_ms / device_total - 1.0)
                check(abs(traced_ms - device_total) <= 0.01 * device_total,
                      f"{run}: --profile_steps reads {traced_ms} ms of "
                      f"device time for a step, the profiled step "
                      f"{device_total} ms")
            train["profiled_step"] = {
                "step_ms": prof_ms, "device_ms": classes,
                "device_total_ms": device_total, "idle_share": idle,
                "device_ms_by_op": top}
            log(f"{run}: one optimizer step {step_ms:.1f} ms (host clock, "
                f"median of 3, fused LAMB): one microbatch forward+backward "
                f"{fb_ms:.1f} ms, one LAMB update {lamb_ms:.1f} ms; in turns "
                f"(off, kernels, kernels, off) step ms {step_runs}, LAMB ms "
                f"{lamb_runs}; "
                f"profiled step {prof_ms:.1f} ms (host clock, profiler on),"
                f" device {device_total:.1f} ms of it (idle share "
                f"{idle:.3f}), by class {classes}; by op (top 12) {top}")
            del holder, gparams
        del model, state, step_fn, step_fns, tx, txs

        # one microbatch: kernels against the plain versions
        train["kernels_vs_plain"] = {}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            rows = micro if dtype == torch.bfloat16 else spec["f32_rows"]
            one = {k: v[0, :rows] for k, v in batch.items()}
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            got = _loss_and_grads(torch, config, dtype, False, weights, one,
                                  seeds[0], args.max_predictions_per_seq,
                                  device)
            want_ = _loss_and_grads(torch, config, dtype, True, weights, one,
                                    seeds[0], args.max_predictions_per_seq,
                                    device)
            loss_rel = abs(got[0] - want_[0]) / abs(want_[0])
            worst, worst_name = 0.0, None
            for k, w in want_[1].items():
                rel = (torch.linalg.vector_norm(got[1][k] - w)
                       / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
                if rel > worst:
                    worst, worst_name = rel, k
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                    if on_card else None)
            tol = spec["tol"][name]
            log(f"{run}: one microbatch ({rows} x {seq}) {name}, kernels vs "
                f"plain: loss {got[0]:.6f} vs {want_[0]:.6f} (rel "
                f"{loss_rel:.3g}, tol {tol['loss']:g}); worst gradient rel "
                f"L2 {worst:.3g} at {worst_name} (tol {tol['grad']:g}); "
                f"peak memory {peak} GiB")
            check(np.isfinite(got[0]) and loss_rel <= tol["loss"],
                  f"{name} loss kernels {got[0]} vs plain {want_[0]}")
            check(worst <= tol["grad"], f"{name} gradient {worst_name}: rel "
                  f"L2 {worst} > {tol['grad']}")
            train["kernels_vs_plain"][name] = {
                "rows": rows, "loss": got[0], "plain_loss": want_[0],
                "loss_rel": loss_rel, "max_grad_rel_l2": worst,
                "worst_leaf": worst_name, "peak_memory_gib": peak}
            del got, want_
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- pretraining: K-FAC, --steps_per_loop chunks, the RoBERTa recipe ---------

KFAC_CONFIG = os.path.join(HERE, "configs",
                           "bert_kfac_pretraining_phase1_config.json")
# phase 1's shapes (2 x 96 x 128) at 24 layers, 3 steps, the inversions on
# steps 1 and 3
KFAC_RUN = {"micro": 96, "seq": 128, "global_batch": 192, "samples": 320,
            "steps": 3, "inv_interval": 2}
# At CUT_LAYERS: the replay's run (4 steps of 2 x 32 x 128; a NaN injected
# at step 4 halts it after the checkpoint of step 2, so the bundle holds
# steps 1-4 and step 3 replays from that checkpoint), and the card against
# the CPU on one microbatch of 2 x 128 with K-FAC's state at count 1 (no
# inversion: at 12 layers one costs the CPU ~7 TFLOP of f32; layer 0's
# four sites are inverted on both instead).
KFAC_REPLAY = {"micro": 32, "steps": 4, "samples": 160}
KFAC_CPU_ROWS = 2
# one K-FAC step's schedule step: lr above 0, so kl_clip's nu is exercised
KFAC_LR_STEP = 1000
# One K-FAC step (bf16) on the kernels against the plain versions: the
# train phase's bf16 loss tier; the preconditioned grad_norm and nu within
# its gradient tier, 5e-2 relative.
KFAC_MODEL_TOL = {"loss": 1e-3, "grad_norm": 5e-2, "nu": 5e-2}
# The card's K-FAC step (kernels) against the port's on the CPU (plain
# versions), both bf16: the loss 2e-3 and grad_norm and nu 5e-2 relative;
# an A factor within 2e-2 of its largest element (statistics of bf16
# activations that differ in their last bits); a G factor within 1e-1,
# set between two readings on the card (PERF.md §6): the largest sound
# one, 2.83e-2 at 12 layers (1.92e-2 at 6), and the smallest fault, 0.505
# for a G halved (0.931 for G from other dropout masks; G from bf16
# statistics, an allowed mode, read 2.01e-2); layer 0's bf16 inverses
# from the same factors within 2^-6 of the largest element (f32
# factorizations summed in another order, rounded to bf16).
KFAC_CPU_TOL = {"loss": 2e-3, "grad_norm": 5e-2, "nu": 5e-2,
                "A": 2e-2, "G": 1e-1, "inverses": 2 ** -6}


def _per_step_launches(layers: int, steps: int, flash: bool,
                       accum: int = 2) -> dict:
    """A pretraining run's exact launches: per microbatch two LayerNorms
    (#1/#2), two residual tails a layer (#3/#4), at seq > 256 every
    layer's flash forward and fused backward; per step one LAMB (#11/#12)."""
    micro_steps = accum * steps
    attn = layers * micro_steps if flash else 0
    return {"add_dropout_layer_norm_fwd": 2 * layers * micro_steps,
            "add_dropout_layer_norm_bwd": 2 * layers * micro_steps,
            "layer_norm_fwd": 2 * micro_steps,
            "layer_norm_bwd": 2 * micro_steps,
            "flash_attention_fwd": attn, "flash_attention_bwd": attn,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "lamb_stage1": steps, "lamb_stage2": steps}


def _check_hbm_fields(records, what: str, on_card: bool) -> None:
    """Every pretraining perf record carries the three memory fields on a
    card, none on the CPU."""
    keys = ("hbm_peak_bytes", "hbm_bytes_in_use", "hbm_bytes_limit")
    check(bool(records), f"{what}: no perf record")
    for r in records:
        have = [k for k in keys if k in r]
        check(have == (list(keys) if on_card else []),
              f"{what}: perf record at step {r.get('step')} carries "
              f"{have}")


def _rel_to_max(torch, got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _kfac_setup(torch, config, weights, device, plain=False, accum=1,
                max_pred=20, **kcfg):
    """A K-FAC train step over a model holding `weights` (the kernels, or
    the plain versions), LAMB (fused on the kernels' route) under the K-FAC
    run config's schedule: (model, kfac, state, step_fn, tx)."""
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining
    from bert_pytorch_tpu_torch.optim.kfac import KFAC, KFACConfig
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.training.pretrain import (
        build_kfac_pretrain_step, init_kfac_state)
    from bert_pytorch_tpu_torch.training.state import make_train_state

    with torch.device(device):
        model = BertForPreTraining(config.replace(kfac_taps=True),
                                   dtype=torch.bfloat16, plain=plain)
    model.load_state_dict(weights)
    schedule = make_schedule("poly", 6e-3, 7038, warmup=0.2843)
    tx = Lamb(schedule, weight_decay=0.01, fused="off" if plain else "auto")
    state = make_train_state(model, tx)
    kfac = KFAC(KFACConfig(**kcfg))
    init_kfac_state(model, kfac, state)
    step = build_kfac_pretrain_step(model, tx, kfac, schedule=schedule,
                                    accum_steps=accum,
                                    max_predictions=max_pred,
                                    grad_dtype=torch.bfloat16)
    return model, kfac, state, step, tx


def _kfac_one_step(torch, config, weights, device, plain, batch, seeds,
                   count=0, **kcfg):
    """One K-FAC step (accumulation 1) from `weights`, a fresh K-FAC state
    at `count` (0: the step inverts) and schedule step KFAC_LR_STEP:
    loss, preconditioned grad_norm, nu and the factors after it."""
    model, kfac, state, step, _ = _kfac_setup(torch, config, weights, device,
                                              plain=plain, **kcfg)
    state.step = KFAC_LR_STEP
    state.precond_state.count = count
    m = step(state, {k: v[None] for k, v in batch.items()}, seeds[None])
    out = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
           "nu": float(kfac.last_nu),
           "factors": {s: {k: t.float().cpu() for k, t in d.items()}
                       for s, d in state.precond_state.factors.items()}}
    del model, state, step
    return out, kfac


def _part_ms(torch, fn, reps: int = 2) -> dict:
    """Host clock (between synchronizations) and device time (CUDA events
    around the call: the device's time when the card, not the host, sets
    the pace, as for these large products and factorizations) of fn(),
    medians of `reps` after a warm call."""
    fn()
    host, dev = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return {"host_ms": statistics.median(host),
            "device_ms": statistics.median(dev)}


def _kfac_parts(torch, config, weights, device, batch, seeds):
    """The host clock and device time (`_part_ms`) of one K-FAC step's
    parts at the phase's shapes: a microbatch's forward+backward with the
    taps, its statistics, the inversion of every site, the
    preconditioning and the LAMB update."""
    from bert_pytorch_tpu_torch.models.bert import KFACTaps
    from bert_pytorch_tpu_torch.training.pretrain import (compute_params,
                                                          pretrain_loss_fn)

    model, kfac, state, _, tx = _kfac_setup(torch, config, weights, device)
    loss_fn = pretrain_loss_fn(model, 20)
    gparams = compute_params(state.params, torch.bfloat16)
    names = list(gparams)
    micro = {k: v[0] for k, v in batch.items()}
    held = {}

    def fwd_bwd():
        taps = KFACTaps()
        loss, _ = loss_fn(gparams, micro, seeds[0], taps)
        sites = list(taps.perts)
        out = torch.autograd.grad(loss, [gparams[k] for k in names]
                                  + [taps.perts[s] for s in sites])
        held.update(grads=dict(zip(names, out[:len(names)])),
                    acts=taps.acts,
                    perts=dict(zip(sites, out[len(names):])))

    def stats():
        held["stats"] = kfac.compute_stats(held["acts"], held["perts"])

    def invert():
        held["inverses"] = kfac._invert(held["factors"])

    def precondition():
        held["pre"] = kfac.precondition(held["inverses"], held["grads"],
                                        1e-3)

    def lamb():
        tx.update(held["pre"], state.opt_state, state.params)

    parts = {}
    parts["forward_backward"] = _part_ms(torch, fwd_bwd)
    parts["statistics"] = _part_ms(torch, stats)
    held["factors"] = kfac._update_factors(state.precond_state.factors,
                                           held["stats"])
    parts["inversion"] = _part_ms(torch, invert)
    parts["preconditioning"] = _part_ms(torch, precondition)
    parts["lamb"] = _part_ms(torch, lamb)
    del model, state, held, gparams
    return parts


def phase_train_kfac(torch, np, summary, device="cuda",
                     cfg_path=os.path.join(HERE, "configs",
                                           "bert_large_uncased_config.json"),
                     cut_cfg_path=None, run=KFAC_RUN, cpu_rows=KFAC_CPU_ROWS,
                     replay_run=KFAC_REPLAY):
    """K-FAC pretraining: configs/bert_kfac_pretraining_phase1_config.json
    through the entry point's trainer at 24 layers and phase 1's 2 x 96 x
    128, --kfac_inv_interval 2, 3 steps (inversions on steps 1 and 3):
    exact launches (the ph1 column a step), finite losses, the factor and
    inverse bytes, every perf record's hbm_* fields; the host clock and
    device time of a step's parts; one K-FAC step on the kernels against
    the plain versions (loss, the preconditioned grad_norm, kl_clip's nu).
    At CUT_LAYERS: one K-FAC step on the card against the port on the CPU
    from the same weights, batch and seeds (and layer 0's inversion of
    the same factors), and a run halted by a NaN at step 4 whose bundle's
    step 3 replays bit-identically (tools/replay.py, the K-FAC step
    rebuilt from the run block's `kfac` dict)."""
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)
    from bert_pytorch_tpu_torch.models.bert import init_weights
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.tools import replay

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kfac_")
    res = summary.setdefault("train_kfac", {})
    marks, mark = _marks()
    try:
        def kfac_args(cfg, out, micro, steps, *extra):
            return run_pretraining.parse_arguments([
                "--config_file", KFAC_CONFIG, "--model_config_file", cfg,
                "--input_dir", os.path.join(tmp, "data"),
                "--output_dir", out, "--local_batch_size", str(micro),
                "--global_batch_size", str(2 * micro), "--steps",
                str(steps), "--kfac_inv_interval", str(run["inv_interval"]),
                "--fused_optim", "auto", "--vocab_pad_multiple", "8",
                "--seed", "0", "--log_freq", "1", "--tensorboard", "off",
                "--device", device, *extra])

        config = BertConfig.from_json_file(cfg_path)
        config = config.replace(vocab_size=pad_vocab_size(config.vocab_size,
                                                          8))
        layers, micro, seq = (config.num_hidden_layers, run["micro"],
                              run["seq"])
        index = array_index([pretraining_arrays(
            np, run["samples"], seq, config.vocab_size, s) for s in (0, 1)])
        args = kfac_args(cfg_path, os.path.join(tmp, "out"), micro,
                         run["steps"], "--skip_checkpoint")
        lines = []

        def keep(m):
            lines.append(m)
            log(f"train_kfac: {m}")

        reset_launches()
        result = run_pretraining.train(args, index, log=keep)
        launches = dict(LAUNCHES)
        summary.setdefault("launches", {})["train_kfac"] = launches
        mark("run")
        want = _per_step_launches(layers, run["steps"], False)
        if on_card:
            check(launches == want, f"train_kfac: launches {launches}, "
                  f"want {want}")
        losses = [r["loss"] for r in result.history]
        norms = [r["grad_norm"] for r in result.history]
        check(len(losses) == run["steps"] and all(np.isfinite(losses))
              and all(np.isfinite(norms)), f"train_kfac: losses {losses}, "
              f"grad norms {norms}")
        pre = result.state.precond_state
        check(pre is not None and pre.count == run["steps"],
              "train_kfac: K-FAC state after the run: "
              f"{None if pre is None else pre.count}")
        factor_b, inverse_b = pre.nbytes()
        check(any(m.startswith(f"kfac: {len(pre.factors)} sites")
                  for m in lines), "train_kfac: no kfac log line")
        perf = _perf_records(args)
        _check_hbm_fields(perf, "train_kfac", on_card)
        res.update(losses=losses, grad_norms=norms, launches=launches,
                   launches_predicted=want,
                   step_ms=[r["step_ms"] for r in result.history],
                   sites=len(pre.factors), factor_bytes=factor_b,
                   inverse_bytes=inverse_b,
                   hbm=[{k: r[k] for k in r if k.startswith("hbm_")}
                        for r in perf])
        log(f"train_kfac: {run['steps']} K-FAC steps of {2 * micro} x {seq}"
            f" at {layers} layers: losses {losses}, grad norms {norms}, "
            f"step ms {res['step_ms']} (LAMB's train phase: "
            f"{summary.get('train', {}).get('step_ms')}); {len(pre.factors)}"
            f" sites, factors {factor_b / 1e9:.3f} GB, inverses "
            f"{inverse_b / 1e9:.3f} GB; launches {launches} (predicted "
            f"{want}); perf hbm {res['hbm']}")
        del result, pre

        # the same step's parts, and the kernels against the plain route
        with torch.device(device):
            from bert_pytorch_tpu_torch.models.bert import BertForPreTraining

            model = BertForPreTraining(config, dtype=torch.bfloat16)
        init_weights(model, torch.Generator(device=device).manual_seed(1),
                     std=config.initializer_range)
        weights = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
        del model
        loader = PretrainingDataLoader(
            index, HostShardSampler(len(index), seed=1),
            batch_size=micro, mask_token_index=103,
            max_pred_per_seq=args.max_predictions_per_seq,
            masked_lm_prob=args.masked_token_fraction,
            vocab_size=config.vocab_size, seed=1)
        batch_np = next(loader)
        loader.close()
        batch = {k: torch.from_numpy(v[None]).to(device)
                 for k, v in batch_np.items()}
        seeds = torch.randint(-2 ** 31, 2 ** 31, (1, 1 + 3 * layers),
                              dtype=torch.int32,
                              generator=torch.Generator().manual_seed(7))
        if on_card:
            parts = _kfac_parts(torch, config, weights, device, batch, seeds)
            res["parts"] = parts
            log("train_kfac: a step's parts, host ms / device ms: "
                + "; ".join(f"{k} {v['host_ms']:.1f} / {v['device_ms']:.1f}"
                            for k, v in parts.items()))
            mark("parts")
        one = {k: v[0] for k, v in batch.items()}
        got, _ = _kfac_one_step(torch, config, weights, device, False, one,
                                seeds[0], inv_interval=run["inv_interval"])
        plain, _ = _kfac_one_step(torch, config, weights, device, True, one,
                                  seeds[0], inv_interval=run["inv_interval"])
        rel = {k: abs(got[k] - plain[k]) / abs(plain[k])
               for k in ("loss", "grad_norm", "nu")}
        res["kernels_vs_plain"] = {"kernels": {k: got[k] for k in rel},
                                   "plain": {k: plain[k] for k in rel},
                                   "rel": rel, "tol": KFAC_MODEL_TOL}
        log(f"train_kfac: one K-FAC step ({micro} x {seq}, bf16), kernels "
            f"vs plain: {res['kernels_vs_plain']}")
        for k, tol in KFAC_MODEL_TOL.items():
            check(np.isfinite(got[k]) and rel[k] <= tol,
                  f"train_kfac: {k} kernels {got[k]} vs plain {plain[k]}")
        check(got["nu"] < 1.0, f"train_kfac: nu {got['nu']} (kl_clip not "
              "exercised)")
        del got, plain, weights, batch
        mark("kernels_vs_plain")

        if cut_cfg_path is not None:
            # the CPU's side of this check runs while the card replays
            finish = _kfac_card_vs_cpu(
                torch, np, cut_cfg_path, index, args, device, cpu_rows,
                run["inv_interval"])
            mark("card_vs_cpu_card")
            cut = BertConfig.from_json_file(cut_cfg_path)
            out = os.path.join(tmp, "replay")
            rargs = kfac_args(cut_cfg_path, out, replay_run["micro"],
                              replay_run["steps"],
                              "--num_steps_per_checkpoint", "2",
                              "--inject_nonfinite_step",
                              str(replay_run["steps"]),
                              "--nonfinite_action", "halt")
            rindex = array_index([pretraining_arrays(
                np, replay_run["samples"], seq,
                pad_vocab_size(cut.vocab_size, 8), s) for s in (2, 3)])
            try:
                run_pretraining.train(rargs, rindex,
                                      log=lambda m: log(f"train_kfac: {m}"))
                check(False, "train_kfac: the NaN did not halt the run")
            except run_pretraining.NonFiniteHalt:
                pass
            bundles = os.listdir(os.path.join(out, "repro_bundles"))
            check(len(bundles) == 1, f"train_kfac: bundles {bundles}")
            bundle = os.path.join(out, "repro_bundles", bundles[0])
            with open(os.path.join(bundle, "manifest.json")) as f:
                manifest = json.load(f)
            check(manifest["run"]["kfac"]["inv_interval"]
                  == run["inv_interval"], "train_kfac: the bundle's kfac "
                  f"block {manifest['run']['kfac']}")
            target = replay_run["steps"] - 1
            got = replay.main(["--bundle", bundle, "--step", str(target),
                               "--device", device])
            res["replay"] = {"step": target,
                             "base_checkpoint": got["base_checkpoint"],
                             "match": got["match"],
                             "mismatches": got["mismatches"]}
            log(f"train_kfac: replay of step {target} from the bundle "
                f"({cut.num_hidden_layers} layers): {res['replay']}")
            check(got["match"] is True, f"train_kfac: replay of step "
                  f"{target}: {got['mismatches']}")
            mark("replay")
            res["card_vs_cpu"] = finish()
            mark("card_vs_cpu_wait")
        res["seconds"] = marks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _kfac_card_vs_cpu(torch, np, cut_cfg_path, index, args, device,
                      rows: int, inv_interval: int):
    """One K-FAC step at CUT_LAYERS on the card (the kernels) and on the
    CPU (the plain versions) from the same weights, microbatch of `rows`
    and seeds, K-FAC's state at count 1 (no inversion); then layer 0's
    four sites inverted on both from the card's factors. The CPU's step
    runs on a thread of its own while the caller goes on with the card;
    returns finish() -> the comparison, which waits for it."""
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)

    config = BertConfig.from_json_file(cut_cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    model = BertForPreTraining(config, dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(2),
                 std=config.initializer_range)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    loader = PretrainingDataLoader(
        index, HostShardSampler(len(index), seed=2), batch_size=rows,
        mask_token_index=103, max_pred_per_seq=args.max_predictions_per_seq,
        masked_lm_prob=args.masked_token_fraction,
        vocab_size=config.vocab_size, seed=2)
    batch_np = next(loader)
    loader.close()
    seeds = torch.randint(-2 ** 31, 2 ** 31,
                          (1 + 3 * config.num_hidden_layers,),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(8))
    out = {}
    t0 = time.perf_counter()
    card, kfac = _kfac_one_step(
        torch, config, {k: v.to(device) for k, v in weights.items()},
        device, False, {k: torch.from_numpy(v).to(device)
                        for k, v in batch_np.items()}, seeds, count=1,
        inv_interval=inv_interval)
    layer0 = {s: d for s, d in card["factors"].items()
              if s.startswith("bert.encoder.layers.0.")}
    inv_card = kfac._invert({s: {k: t.to(device) for k, t in d.items()}
                             for s, d in layer0.items()})
    # G's bound read against what it must tell apart: the card's G from
    # bf16 statistics (an allowed mode), from other dropout masks (the
    # output gradients of another backward pass), and halved (the
    # microbatch average taken twice)
    other_seeds = torch.randint(-2 ** 31, 2 ** 31, seeds.shape,
                                dtype=torch.int32,
                                generator=torch.Generator().manual_seed(9))
    controls = {"halved": {s: d["G"] / 2
                           for s, d in card["factors"].items()}}
    for name, seeds_, kw in (
            ("stats_bf16", seeds, {"stats_dtype": torch.bfloat16}),
            ("other_dropout", other_seeds, {})):
        ctl, _ = _kfac_one_step(
            torch, config, {k: v.to(device) for k, v in weights.items()},
            device, False, {k: torch.from_numpy(v).to(device)
                            for k, v in batch_np.items()}, seeds_, count=1,
            inv_interval=inv_interval, **kw)
        controls[name] = {s: d["G"] for s, d in ctl["factors"].items()}
        del ctl
    out["card_s"] = time.perf_counter() - t0
    cpu_side = {}

    def on_cpu():
        try:
            t0 = time.perf_counter()
            cpu, cpu_kfac = _kfac_one_step(
                torch, config, weights, "cpu", True,
                {k: torch.from_numpy(v) for k, v in batch_np.items()},
                seeds, count=1, inv_interval=inv_interval)
            cpu_side.update(step=cpu, inv=cpu_kfac._invert(layer0),
                            seconds=time.perf_counter() - t0)
        except BaseException as e:  # re-raised by finish()
            cpu_side["error"] = e

    thread = threading.Thread(target=on_cpu, name="kfac-cpu-step",
                              daemon=True)
    thread.start()

    def finish() -> dict:
        thread.join()
        if "error" in cpu_side:
            raise cpu_side["error"]
        cpu, inv_cpu = cpu_side["step"], cpu_side["inv"]
        out["cpu_s"] = cpu_side["seconds"]
        rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k])
               for k in ("loss", "grad_norm", "nu")}
        worst_f = {k: max((_rel_to_max(torch, card["factors"][s][k],
                                       cpu["factors"][s][k]), s)
                          for s in cpu["factors"]) for k in ("A", "G")}
        worst_i = max((_rel_to_max(torch, inv_card[s][k], inv_cpu[s][k]),
                       s, k) for s in inv_cpu for k in ("A", "G"))
        g_controls = {name: max(_rel_to_max(torch, g[s],
                                            cpu["factors"][s]["G"])
                                for s in g)
                      for name, g in controls.items()}
        out.update(rows=rows, layers=config.num_hidden_layers,
                   card={k: card[k] for k in rel},
                   cpu={k: cpu[k] for k in rel}, rel=rel,
                   worst_factor={k: list(v) for k, v in worst_f.items()},
                   worst_layer0_inverse=list(worst_i),
                   g_controls=g_controls, tol=KFAC_CPU_TOL)
        log(f"train_kfac: one K-FAC step at {config.num_hidden_layers} "
            f"layers ({rows} x {batch_np['input_ids'].shape[1]}), the card "
            f"against the CPU: {out}")
        for k in ("loss", "grad_norm", "nu"):
            check(rel[k] <= KFAC_CPU_TOL[k], f"train_kfac: {k} card "
                  f"{card[k]} vs CPU {cpu[k]}")
        for k, (err, site) in worst_f.items():
            check(err <= KFAC_CPU_TOL[k], f"train_kfac: factor {site}/{k} "
                  f"card vs CPU {err}")
        check(worst_i[0] <= KFAC_CPU_TOL["inverses"], f"train_kfac: layer "
              f"0 inverse {worst_i[1]}/{worst_i[2]} card vs CPU "
              f"{worst_i[0]}")
        for name in ("other_dropout", "halved"):
            check(g_controls[name] > KFAC_CPU_TOL["G"], f"train_kfac: a G "
                  f"factor {name} reads {g_controls[name]} against the CPU's,"
                  f" inside G's bound {KFAC_CPU_TOL['G']}")
        return out

    return finish


# --steps_per_loop: phase 2's 24 layers at 16 x 512, 4 steps a run, runs
# at N = 1 and N = 2 alternated (1, 2, 2, 1), each traced over its warm
# chunk (steps 3-4) by --profile_steps; one microbatch of CHUNK_PLAIN_ROWS
# rows through the kernels against the plain versions.
CHUNK_STEPS = 4
CHUNK_N = 2
CHUNK_ORDER = (1, CHUNK_N, CHUNK_N, 1)
CHUNK_PLAIN_ROWS = 4
# then one run of a single chunk, --steps_per_loop 4 --profile_steps 2,3:
# a window inside the chunk traces the chunk whole
CHUNK_WIDE = (4, "2,3")


def phase_train_chunks(torch, np, summary, device="cuda",
                       cfg_path=os.path.join(HERE, "configs",
                                             "bert_large_uncased_config.json"),
                       micro=None, order=CHUNK_ORDER,
                       plain_rows=CHUNK_PLAIN_ROWS):
    """--steps_per_loop on phase 2: runs of CHUNK_STEPS steps of the
    entry point's trainer from the chained pretraining checkpoint (the
    one train_dp kept, at `cfg_path`'s depth: the script passes
    BERT-Large's width at CUT_LAYERS; its weights through
    --init_checkpoint, every parameter loaded), at N = 1 and N = 2 in
    CHUNK_ORDER. Every run's
    losses at the steps both log, its parameters and LAMB moments (what
    its checkpoint would hold) are bit-equal; the launches are the ph2
    column a step; every perf record carries the hbm_* fields. From the
    --profile_steps trace of the warm chunk: the host clock a step (the
    traced window over its steps) and the device's idle share; a gain is
    reported only where the two modes' ranges do not overlap. Last, one
    run at --steps_per_loop 4 --profile_steps 2,3 (CHUNK_WIDE): bit-equal
    to the others, its one chunk traced whole."""
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    spec = TRAIN_RUNS["train_phase2"]
    micro = micro or spec["micro"]
    on_card = torch.device(device).type == "cuda"
    prev = summary.get("train_dp", {}).get("checkpoint")
    check(prev is not None or not on_card, "train_chunks chains from "
          "train_dp's checkpoint: run train_dp first")
    init = [] if prev is None else [
        "--init_checkpoint", f"{prev['dir']}@{prev['step']}"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chunks_")
    res = summary.setdefault("train_chunks", {"init": init[1:]})
    marks, mark = _marks()
    try:
        config = BertConfig.from_json_file(cfg_path)
        config = config.replace(vocab_size=pad_vocab_size(config.vocab_size,
                                                          8))
        layers, seq = config.num_hidden_layers, spec["seq"]
        index = array_index([pretraining_arrays(
            np, CHUNK_STEPS * micro, seq, config.vocab_size, s)
            for s in (0, 1)])
        runs, first_sd = [], None
        windows = [f"{CHUNK_STEPS - 2},{CHUNK_STEPS}"] * len(order)
        for i, (n, window) in enumerate(zip(
                list(order) + [CHUNK_WIDE[0]], windows + [CHUNK_WIDE[1]])):
            args = run_pretraining.parse_arguments([
                "--config_file", spec["config"], "--model_config_file",
                cfg_path, "--input_dir", os.path.join(tmp, "data"),
                "--output_dir", os.path.join(tmp, f"run{i}"),
                "--local_batch_size", str(micro), "--global_batch_size",
                str(2 * micro), "--steps", str(CHUNK_STEPS),
                "--steps_per_loop", str(n), "--profile_steps", window,
                "--skip_checkpoint",
                "--fused_optim", "auto", "--vocab_pad_multiple", "8",
                "--seed", "0", "--log_freq", str(CHUNK_N),
                "--tensorboard", "off", "--device", device, *init])
            lines = []

            def note(m, i=i):
                lines.append(m)
                log(f"train_chunks[{i}]: {m}")

            reset_launches()
            result = run_pretraining.train(args, index, log=note)
            launches = dict(LAUNCHES)
            if prev is not None:
                loaded = [ln for ln in lines
                          if ln.startswith("init_checkpoint ")]
                check(loaded == [f"init_checkpoint step {prev['step']}: "
                                 f"loaded {len(result.state.params)} param "
                                 "leaves, 0 fresh-initialized"],
                      f"train_chunks[{i}] init checkpoint: {loaded}, want "
                      "every parameter")
            want = _per_step_launches(layers, CHUNK_STEPS, spec["flash"])
            if on_card:
                check(launches == want, f"train_chunks[{i}] N={n}: launches "
                      f"{launches}, want {want}")
            if n == CHUNK_N and "train_chunks" not in summary.get(
                    "launches", {}):
                summary.setdefault("launches", {})["train_chunks"] = launches
            _check_hbm_fields(_perf_records(args), f"train_chunks[{i}]",
                              on_card)
            prof = result.profile["summary"]
            traced = result.profile["steps"]
            n_traced = traced[1] - traced[0] + 1
            # what a checkpoint of the run would hold, against the first
            # run's, on the card
            sd = result.state.state_dict()
            if first_sd is None:
                first_sd = sd
            else:
                _check_state_dicts_equal(torch, sd, first_sd,
                                         f"train_chunks[{i}] N={n}")
            runs.append({
                "n": n, "losses": {r["step"]: r["loss"]
                                   for r in result.history},
                "traced_steps": traced,
                "host_ms_a_step": prof["window_ms"] / n_traced,
                "device_ms_a_step": prof["device_ms"] / n_traced,
                "idle_share": prof["idle_share"],
                "host_phases_ms": prof["host_ms"],
                "step_ms": [r["step_ms"] for r in result.history]})
            del result, sd
            log(f"train_chunks[{i}] N={n}: {runs[-1]}")
        del first_sd
        mark("runs")
        wide = runs.pop()
        check(wide["traced_steps"] == [1, CHUNK_WIDE[0]],
              f"train_chunks: --steps_per_loop {CHUNK_WIDE[0]} "
              f"--profile_steps {CHUNK_WIDE[1]} traced {wide['traced_steps']}")
        check(wide["losses"][CHUNK_STEPS] == runs[0]["losses"][CHUNK_STEPS],
              f"train_chunks: N={CHUNK_WIDE[0]} loss {wide['losses']}")
        res["wide"] = wide
        first = runs[0]
        for r in runs[1:]:
            common = sorted(set(first["losses"]) & set(r["losses"]))
            check(common and all(first["losses"][s] == r["losses"][s]
                                 for s in common),
                  f"train_chunks: N={r['n']} losses {r['losses']} vs N="
                  f"{first['n']} {first['losses']}")
        host = {n: [r["host_ms_a_step"] for r in runs if r["n"] == n]
                for n in sorted(set(order))}
        lo_n, hi_n = min(host), max(host)
        gain = None
        if max(host[hi_n]) < min(host[lo_n]):
            gain = 1.0 - statistics.mean(host[hi_n]) / statistics.mean(
                host[lo_n])
        res.update(runs=runs,
                   host_ms_a_step=host, gain=gain,
                   idle_share={n: [r["idle_share"] for r in runs
                                   if r["n"] == n] for n in host})
        log(f"train_chunks: N=1 vs N={CHUNK_N}, bit-equal; host ms a traced"
            f" step {host}; idle share {res['idle_share']}; gain "
            + (f"{gain:.3f}" if gain is not None else "none (the ranges "
               "overlap)"))

        # one microbatch through the kernels against the plain versions
        model = BertForPreTraining(config, dtype=torch.bfloat16)
        init_weights(model, torch.Generator().manual_seed(3),
                     std=config.initializer_range)
        weights = {k: v.detach().to(device) for k, v in
                   model.state_dict().items()}
        del model
        arrays = pretraining_arrays(np, plain_rows, seq, config.vocab_size, 5)
        res["kernels_vs_plain"] = _micro_kernels_vs_plain(
            torch, np, config, weights, arrays, device, "train_chunks",
            spec["tol"]["bfloat16"], 80)
        mark("kernels_vs_plain")
        res["seconds"] = marks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _micro_kernels_vs_plain(torch, np, config, weights, arrays, device,
                            what, tol, max_pred) -> dict:
    """One microbatch of the shard-schema `arrays` (masked as the loader
    masks them) through the kernels and the plain versions, bf16: loss and
    the worst gradient's relative L2, held to `tol`."""
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)

    rows = len(arrays["input_ids"])
    loader = PretrainingDataLoader(
        array_index([arrays]), HostShardSampler(rows, seed=4),
        batch_size=rows, mask_token_index=103, max_pred_per_seq=max_pred,
        masked_lm_prob=0.15, vocab_size=config.vocab_size, seed=4)
    micro = {k: torch.from_numpy(v).to(device)
             for k, v in next(loader).items()}
    loader.close()
    seeds = torch.randint(-2 ** 31, 2 ** 31,
                          (1 + 3 * config.num_hidden_layers,),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(9))
    got = _loss_and_grads(torch, config, torch.bfloat16, False, weights,
                          micro, seeds, max_pred, device)
    want = _loss_and_grads(torch, config, torch.bfloat16, True, weights,
                           micro, seeds, max_pred, device)
    loss_rel = abs(got[0] - want[0]) / abs(want[0])
    worst, worst_name = 0.0, None
    for k, w in want[1].items():
        rel = (torch.linalg.vector_norm(got[1][k] - w)
               / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, k
    out = {"rows": rows, "loss": got[0], "plain_loss": want[0],
           "loss_rel": loss_rel, "max_grad_rel_l2": worst,
           "worst_leaf": worst_name, "tol": tol}
    log(f"{what}: one microbatch ({rows} rows, bf16), kernels vs plain: "
        f"{out}")
    check(np.isfinite(got[0]) and loss_rel <= tol["loss"],
          f"{what}: loss kernels {got[0]} vs plain {want[0]}")
    check(worst <= tol["grad"], f"{what}: gradient {worst_name} rel L2 "
          f"{worst} > {tol['grad']}")
    return out


ROBERTA_CONFIG = os.path.join(HERE, "configs",
                              "roberta_pretraining_config.json")
ROBERTA_MODEL = os.path.join(HERE, "configs",
                             "roberta_large_cased_config.json")
# 24 layers at 2 x 16 x 128, 2 steps; LAMB's tensors without the pooler,
# the NSP head and the token-type table: 24 x 12 + 4 + 5
ROBERTA_RUN = {"micro": 16, "seq": 128, "steps": 2, "samples": 64}
ROBERTA_TENSORS = 297


def phase_train_roberta(torch, np, summary, device="cuda",
                        cfg_path=ROBERTA_MODEL, run=ROBERTA_RUN,
                        tensors=ROBERTA_TENSORS):
    """The RoBERTa recipe (configs/roberta_pretraining_config.json: no
    NSP, mask 0.15, 80 predictions, linear decay, vocab 28996) through the
    entry point's trainer at 24 layers, 2 x 16 x 128, 2 steps: exact
    launches, finite losses, the tensors LAMB updates (no pooler, NSP
    head or token-type table), [MASK] 103 (the config's vocab file is not
    in the repo), hbm_* in every perf record; one microbatch through the
    kernels against the plain versions."""
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_roberta_")
    res = summary.setdefault("train_roberta", {})
    try:
        config = BertConfig.from_json_file(cfg_path)
        check(config.next_sentence is False, "train_roberta: the recipe's "
              "model has next_sentence false")
        config = config.replace(vocab_size=pad_vocab_size(config.vocab_size,
                                                          8))
        layers, micro, seq = (config.num_hidden_layers, run["micro"],
                              run["seq"])
        index = array_index([pretraining_arrays(
            np, run["samples"], seq, config.vocab_size, s) for s in (0, 1)])
        args = run_pretraining.parse_arguments([
            "--config_file", ROBERTA_CONFIG, "--model_config_file", cfg_path,
            "--input_dir", os.path.join(tmp, "data"),
            "--output_dir", os.path.join(tmp, "out"),
            "--local_batch_size", str(micro), "--global_batch_size",
            str(2 * micro), "--steps", str(run["steps"]),
            "--skip_checkpoint", "--fused_optim", "auto",
            "--vocab_pad_multiple", "8", "--seed", "0", "--log_freq", "1",
            "--tensorboard", "off", "--device", device])
        check((args.masked_token_fraction, args.max_predictions_per_seq,
               args.lr_decay) == (0.15, 80, "linear"),
              f"train_roberta: the recipe's values {args}")
        lines = []

        def keep(m):
            lines.append(m)
            log(f"train_roberta: {m}")

        reset_launches()
        result = run_pretraining.train(args, index, log=keep)
        launches = dict(LAUNCHES)
        summary.setdefault("launches", {})["train_roberta"] = launches
        want = _per_step_launches(layers, run["steps"], False)
        if on_card:
            check(launches == want, f"train_roberta: launches {launches}, "
                  f"want {want}")
        losses = [r["loss"] for r in result.history]
        n_tensors = len(result.state.opt_state.mu)
        check(len(losses) == run["steps"] and all(np.isfinite(losses)),
              f"train_roberta: losses {losses}")
        check(n_tensors == tensors and not any(
            "pooler" in k or "seq_relationship" in k or "token_type" in k
            for k in result.state.params),
            f"train_roberta: LAMB over {n_tensors} tensors")
        check(any("[MASK]=103" in m for m in lines),
              "train_roberta: [MASK] id not 103")
        _check_hbm_fields(_perf_records(args), "train_roberta", on_card)
        res.update(losses=losses, launches=launches, lamb_tensors=n_tensors,
                   learning_rates=[r["learning_rate"]
                                   for r in result.history],
                   step_ms=[r["step_ms"] for r in result.history])
        log(f"train_roberta: {run['steps']} steps of {2 * micro} x {seq} at "
            f"{layers} layers: {res}")
        del result
        model = BertForPreTraining(config, dtype=torch.bfloat16)
        init_weights(model, torch.Generator().manual_seed(4),
                     std=config.initializer_range)
        weights = {k: v.detach().to(device) for k, v in
                   model.state_dict().items()}
        del model
        res["kernels_vs_plain"] = _micro_kernels_vs_plain(
            torch, np, config, weights,
            pretraining_arrays(np, micro, seq, config.vocab_size, 6),
            device, "train_roberta", TRAIN_MODEL_TOL["bfloat16"],
            args.max_predictions_per_seq)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- pretraining: sequence packing and activation checkpointing --------------

PACKED_STEPS = 3
# The packed pretraining runs: the run config, its microbatch and
# sequence, the length draw (each sample's real length, through its
# second [SEP], uniform over [lo, seq]), the synthetic samples a shard
# (two shards: the packer's lookahead of 4 batches and 3 steps' examples),
# and whether attention takes the flash kernels.
PACKED_RUNS = {
    "train_packed": {"config": PHASE1_CONFIG, "micro": 96, "seq": 128,
                     "lo": 16, "samples": 1200, "flash": False,
                     "tol": TRAIN_MODEL_TOL},
    "train_packed_phase2": {"config": PHASE2_CONFIG, "micro": 16,
                            "seq": 512, "lo": 64, "samples": 200,
                            "flash": True, "tol": TRAIN2_MODEL_TOL},
}
REMAT_POLICIES = ("nothing", "dots", "mlp_only")
REMAT_STEPS = 2


def varied_pretraining_arrays(np, n: int, seq: int, lo: int, vocab: int,
                              seed: int):
    """`n` synthetic pretraining samples in the shard schema whose real
    lengths (through the second [SEP]) are uniform over [lo, seq]: [CLS] a
    [SEP] b [SEP], the first [SEP] uniform over the positions that leave
    each segment a token, then padding; the loader masks them
    dynamically."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, (n, seq)).astype(np.int32)
    specials = np.zeros((n, 3), np.int32)
    for i in range(n):
        last = int(rng.randint(lo, seq + 1)) - 1
        sep1 = int(rng.randint(2, last - 1))
        ids[i, 0], ids[i, sep1], ids[i, last] = 101, 102, 102
        ids[i, last + 1:] = 0
        specials[i] = (0, sep1, last)
    nsp = rng.randint(0, 2, n).astype(np.int8)
    return {"input_ids": ids, "special_token_positions": specials,
            "next_sentence_labels": nsp}


def one_a_row(np, packed: dict) -> dict:
    """A packed pretraining batch's examples one a row at its sequence
    length: each segment's tokens, types and labels from position 0 (its
    packed positions restart at 0 too), its NSP label."""
    seg = packed["segment_ids"]
    parts = [(b, g, np.nonzero(seg[b] == g)[0])
             for b in range(seg.shape[0])
             for g in range(1, int(seg[b].max()) + 1)]
    n, s = len(parts), seg.shape[1]
    out = {"input_ids": np.zeros((n, s), np.int32),
           "token_type_ids": np.zeros((n, s), np.int32),
           "attention_mask": np.zeros((n, s), np.int32),
           "masked_lm_labels": np.full((n, s), -1, np.int32),
           "next_sentence_labels": np.zeros((n,), np.int32)}
    for i, (b, g, idx) in enumerate(parts):
        ln = len(idx)
        for k in ("input_ids", "token_type_ids", "attention_mask",
                  "masked_lm_labels"):
            out[k][i, :ln] = packed[k][b, idx]
        out["next_sentence_labels"][i] = packed["next_sentence_labels"][
            b, g - 1]
    return out


def _packed_args(run_pretraining, spec, cfg_path, out, device, steps,
                 *extra):
    return run_pretraining.parse_arguments([
        "--config_file", spec["config"], "--model_config_file", cfg_path,
        "--output_dir", out, "--local_batch_size", str(spec["micro"]),
        "--global_batch_size", str(2 * spec["micro"]),
        "--steps", str(steps), "--fused_optim", "auto",
        "--skip_checkpoint", "--packing", "--log_freq", str(steps),
        "--vocab_pad_multiple", "8", "--seed", "0", "--device", device,
        *extra])


def _pretrain_step_launches(layers: int, steps: int, flash: bool,
                            recompute: bool) -> dict:
    """The twelve kernels' launches of `steps` pretraining steps at
    accumulation 2: per microbatch the embedding and MLM-transform
    LayerNorms (#1/#2), each layer's two residual tails (#3/#4) and, at
    seq > 256, its flash forward and fused backward; a recomputing remat
    policy runs each layer's forward twice (#3 and the flash forward
    double); one fused LAMB update a step."""
    micro = 2 * steps
    fwd = 2 if recompute else 1
    return {"layer_norm_fwd": 2 * micro, "layer_norm_bwd": 2 * micro,
            "add_dropout_layer_norm_fwd": 2 * layers * micro * fwd,
            "add_dropout_layer_norm_bwd": 2 * layers * micro,
            "flash_attention_fwd": layers * micro * fwd if flash else 0,
            "flash_attention_bwd": layers * micro if flash else 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "lamb_stage1": steps, "lamb_stage2": steps}


def _first_batch(index, args, vocab: int, micro: int, packed: bool):
    """The first batch of a loader over `index` (seed 1), packed or not."""
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)

    loader = PretrainingDataLoader(
        index, HostShardSampler(len(index), seed=1), batch_size=2 * micro,
        mask_token_index=103, max_pred_per_seq=args.max_predictions_per_seq,
        masked_lm_prob=args.masked_token_fraction, vocab_size=vocab, seed=1,
        packing=packed, packing_max_segments=args.packing_max_segments,
        packing_lookahead=args.packing_lookahead)
    try:
        return next(loader)
    finally:
        loader.close()


def _to_steps(torch, batch_np, micro: int, device):
    return {k: torch.from_numpy(v.reshape(-1, micro, *v.shape[1:]))
            .to(device) for k, v in batch_np.items()}


def _model_loss_and_grads(torch, model, micro, seeds, max_pred):
    """One microbatch's loss and f32 gradients through `model` as it is
    (its compute copies at the model's dtype: bf16 gradients for a bf16
    model)."""
    from bert_pytorch_tpu_torch.training.pretrain import (
        compute_params, pretrain_loss_and_grads)

    grad_dtype = (torch.bfloat16 if model.bert.dtype == torch.bfloat16
                  else None)
    gparams = compute_params(dict(model.named_parameters()), grad_dtype)
    loss, _, grads = pretrain_loss_and_grads(model, gparams, micro, seeds,
                                             max_pred)
    return loss.item(), {k: g.float() for k, g in grads.items()}


# The NSP head's bias gradient is the mean over a microbatch's segments of
# softmax(logits) - onehot(label), two entries of opposite sign, from
# logits rounded to bf16; with balanced labels the mean nearly cancels, so
# its relative error is ill-conditioned (a packed phase-2 microbatch of 31
# segments read 6.0e-2 relative, 2.5 bf16 logit steps apart). It is held
# to one bf16 step of a logit near 1, absolute, instead (bf16 only).
NSP_BIAS = "cls_seq_relationship.bias"
NSP_BIAS_NOISE = 2 ** -7


def _step_times(torch, fn) -> dict:
    """Host clock (median of 2, between synchronizations) and device time
    (`_device_total_ms`) of one fn() call, with the profiler's seconds."""
    fn()
    host = _host_ms(torch, fn, reps=2)
    t0 = time.perf_counter()
    device = _device_total_ms(torch, fn)
    check(device > 0, f"a step's device time read {device}")
    return {"host_ms": host, "device_ms": device,
            "profiler_s": time.perf_counter() - t0}


def _marks():
    """A phase's seconds by part: `mark(name)` notes the time since the
    previous mark."""
    marks, t = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        marks[name] = round(now - t[0], 2)
        t[0] = now
    return marks, mark


def phase_train_packed(torch, np, summary, device="cuda",
                       cfg_path=os.path.join(HERE, "configs",
                                             "bert_large_uncased_config.json"),
                       run="train_packed", samples=None):
    """Packed pretraining (`run` of PACKED_RUNS: phase 1, or phase 2 with
    the flash kernels) at `cfg_path`'s width (BERT-Large, bf16), over
    in-memory shards of varied lengths (`varied_pretraining_arrays`):

    - the main path: PACKED_STEPS steps of the entry point's trainer with
      --packing (8 segments a row, lookahead 4; launch counts zeroed just
      before, read just after, exact); its examples a step and the perf
      record's packing_efficiency;
    - one packed microbatch, dropout on, through the kernels against the
      plain versions (the run's bf16 tolerance; the NSP bias at
      NSP_BIAS_NOISE), and at phase 2 its flash launches (one forward
      and one fused backward a layer) and the tiles their segment test
      skipped, as the layout predicts;
    - at rate 0 (no seeds), in f32, the packed microbatch against its
      examples one a row through the kernels, at the run's f32
      tolerances;
    - one optimizer step of the data's first batch, packed and unpacked,
      on one model and LAMB state: host clock and device time, examples
      a step and examples/s.

    `device`, `cfg_path` and `samples` exist so the phase can be
    rehearsed on the CPU at a tiny size."""
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.attention import counting_skips
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.telemetry.health import HealthConfig
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    spec = PACKED_RUNS[run]
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_packed_pretrain_")
    marks, mark = _marks()
    res = {"seconds": marks}
    summary[run] = res
    try:
        args = _packed_args(run_pretraining, spec, cfg_path,
                            os.path.join(tmp, "out"), device, PACKED_STEPS)
        config = BertConfig.from_json_file(cfg_path)
        config = config.replace(vocab_size=pad_vocab_size(config.vocab_size,
                                                          8))
        layers, micro, seq = (config.num_hidden_layers, spec["micro"],
                              spec["seq"])
        index = array_index([varied_pretraining_arrays(
            np, samples or spec["samples"], seq, spec["lo"],
            config.vocab_size, s) for s in (0, 1)])
        p_row = run_pretraining.packed_prediction_budget(args, seq)
        mark("data")

        # the main path: counts zeroed just before, read just after
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        result = run_pretraining.train(args, index,
                                       log=lambda m: log(f"{run}: {m}"))
        launches = dict(LAUNCHES)
        mark("trainer")
        summary.setdefault("launches", {})[run] = launches
        h = result.history
        losses = [r["loss"] for r in h]
        want = _pretrain_step_launches(layers, PACKED_STEPS, spec["flash"],
                                       False)
        check(result.step == PACKED_STEPS and len(h) == PACKED_STEPS
              and all(np.isfinite(losses)), f"{run}: {len(h)} steps, "
              f"losses {losses}")
        check(all(r["mlm_dropped"] == 0 for r in h),
              f"{run}: masked positions beyond the row budget {p_row}: "
              f"{[r['mlm_dropped'] for r in h]}")
        if on_card:
            check(launches == want, f"{run}: launch counts {launches}, "
                  f"want {want}")
        with open(os.path.join(args.output_dir,
                               args.log_prefix + ".jsonl")) as f:
            perf = [r for r in map(json.loads, f) if r["tag"] == "perf"]
        res.update(steps=len(h), micro_batch=micro, seq=seq,
                   lengths=[spec["lo"], seq], row_budget=p_row,
                   losses=losses, examples=[r["examples"] for r in h],
                   step_ms=[r["step_ms"] for r in h], launches=launches,
                   launches_predicted=want,
                   peak_memory_gib=(torch.cuda.max_memory_allocated()
                                    / 2 ** 30 if on_card else None),
                   perf={k: perf[-1].get(k) for k in (
                       "packing_efficiency", "pad_fraction",
                       "real_tokens_per_sec", "seq_per_sec",
                       "step_time_ms")} if perf else None)
        log(f"{run}: {PACKED_STEPS} packed steps of 2 x {micro} x {seq} "
            f"(lengths uniform over [{spec['lo']}, {seq}]): losses "
            f"{losses}, examples a step {res['examples']}, step ms "
            f"{res['step_ms']}, perf {res['perf']}; launches {launches} "
            f"(predicted {want})")
        del result

        with torch.device(device):
            model = BertForPreTraining(config, dtype=torch.bfloat16)
        init_weights(model, torch.Generator(device=device).manual_seed(1),
                     std=config.initializer_range)
        weights = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
        batches = {name: _first_batch(index, args, config.vocab_size, micro,
                                      name == "packed")
                   for name in ("unpacked", "packed")}
        seeds = torch.randint(-2 ** 31, 2 ** 31, (2, 1 + 3 * layers),
                              dtype=torch.int32,
                              generator=torch.Generator().manual_seed(7))
        one_np = {k: v[:micro] for k, v in batches["packed"].items()}
        one = {k: torch.from_numpy(v).to(device) for k, v in one_np.items()}
        mark("model_and_batches")

        # one packed microbatch, dropout on: the kernels (counting the
        # flash launches and skipped tiles) against the plain versions
        reset_launches()
        with counting_skips(device) as skips:
            got = _model_loss_and_grads(torch, model, one, seeds[0], p_row)
            skipped = {k: int(v.item()) for k, v in skips.items()}
        mb = {k: LAUNCHES[k] for k in skipped}
        plain = _loss_and_grads(torch, config, torch.bfloat16, True,
                                weights, one, seeds[0], p_row, device)
        tol = spec["tol"]["bfloat16"]
        loss_rel = abs(got[0] - plain[0]) / abs(plain[0])
        worst, worst_name = _grad_worst(torch, got[1], plain[1],
                                        (NSP_BIAS,))
        nsp = torch.linalg.vector_norm(got[1][NSP_BIAS]
                                       - plain[1][NSP_BIAS]).item()
        res["kernels_vs_plain"] = {
            "loss": got[0], "plain_loss": plain[0], "loss_rel": loss_rel,
            "max_grad_rel_l2": worst, "worst_leaf": worst_name,
            "nsp_bias_abs": nsp, "nsp_bias_norm": torch.linalg.vector_norm(
                plain[1][NSP_BIAS]).item()}
        log(f"{run}: one packed microbatch ({micro} x {seq}) bf16, kernels "
            f"vs plain: loss {got[0]:.6f} vs {plain[0]:.6f} (rel "
            f"{loss_rel:.3g}, tol {tol['loss']:g}); worst gradient rel L2 "
            f"{worst:.3g} at {worst_name} (tol {tol['grad']:g}); the NSP "
            f"bias {nsp:.3g} apart (norm "
            f"{res['kernels_vs_plain']['nsp_bias_norm']:.3g}, bound "
            f"{NSP_BIAS_NOISE:g})")
        check(np.isfinite(got[0]) and loss_rel <= tol["loss"],
              f"{run}: packed loss kernels {got[0]} vs plain {plain[0]}")
        check(worst <= tol["grad"], f"{run}: packed gradient {worst_name} "
              f"rel L2 {worst} > {tol['grad']}")
        check(nsp <= NSP_BIAS_NOISE, f"{run}: the NSP bias gradients "
              f"{nsp} apart")
        del got, plain
        if spec["flash"]:
            res["microbatch_flash"] = {"launches": mb,
                                       "tiles_skipped": skipped}
            if on_card:
                from bert_pytorch_tpu_torch.ops.kernels.build import \
                    load_kernels

                tiles = load_kernels().flash_tiles(True)
                predicted = {k: layers * expected_skips(
                    np, one_np["segment_ids"], *tiles[k],
                    config.num_attention_heads)
                    for k in ("flash_attention_fwd", "flash_attention_bwd")}
                res["microbatch_flash"]["tiles_predicted"] = predicted
                log(f"{run}: one packed microbatch: flash launches {mb}, "
                    f"tiles skipped {skipped} (layout predicts {predicted})")
                check(mb == {"flash_attention_fwd": layers,
                             "flash_attention_bwd": layers,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkv": 0},
                      f"{run}: packed microbatch flash launches {mb}")
                check(all(skipped[k] == n > 0 for k, n in predicted.items()),
                      f"{run}: tiles skipped {skipped}, predicted "
                      f"{predicted}")
        mark("kernels_vs_plain")

        # rate 0, f32: the packed microbatch against its examples one a
        # row (in bf16 the rows' other GEMM shapes and the bf16 gradient
        # sums move the bits by more than the packing does)
        single_np = one_a_row(np, one_np)
        single = {k: torch.from_numpy(v).to(device)
                  for k, v in single_np.items()}
        tol = spec["tol"]["float32"]
        with torch.device(device):
            model32 = BertForPreTraining(config, dtype=torch.float32)
        model32.load_state_dict(weights)
        lp, gp = _model_loss_and_grads(torch, model32, one, None, p_row)
        ls, gs = _model_loss_and_grads(torch, model32, single, None, p_row)
        del model32
        worst, worst_name = _grad_worst(torch, gp, gs, ())
        res["packed_vs_one_a_row"] = {
            "examples": len(single_np["input_ids"]), "rows": micro,
            "loss_packed": lp, "loss_single": ls,
            "loss_rel_diff": abs(lp - ls) / abs(ls),
            "max_grad_rel_l2": worst, "worst_leaf": worst_name}
        log(f"{run}: rate 0, {len(single_np['input_ids'])} examples in "
            f"{micro} packed rows against one a row: loss {lp!r} vs {ls!r} "
            f"(rel {abs(lp - ls) / abs(ls):.3g}, tol {tol['loss']:g}); "
            f"worst gradient rel L2 {worst:.3g} at {worst_name} (tol "
            f"{tol['grad']:g}), f32")
        check(abs(lp - ls) / abs(ls) <= tol["loss"],
              f"{run}: packed loss {lp!r} vs one a row {ls!r}")
        check(worst <= tol["grad"], f"{run}: packed vs one a row gradient "
              f"{worst_name} rel L2 {worst}")
        del gp, gs
        mark("packed_vs_one_a_row")

        # one step of the same data, packed and one a row (the step
        # updates the model's parameters: last)
        schedule = make_schedule("poly", args.learning_rate, args.max_steps,
                                 warmup=args.warmup_proportion)
        tx = Lamb(schedule, fused="auto")
        state = make_train_state(model, tx)
        step = {}
        for name, b in batches.items():
            fn = build_pretrain_step(
                model, tx, schedule=schedule, accum_steps=2,
                max_predictions=(p_row if name == "packed"
                                 else args.max_predictions_per_seq),
                grad_dtype=torch.bfloat16, health=HealthConfig())
            dev = _to_steps(torch, b, micro, device)
            row = {"examples": int((b["next_sentence_labels"] >= 0).sum()),
                   "packing_efficiency": float((b["attention_mask"] > 0)
                                               .mean())}
            if on_card:
                t = _step_times(
                    torch, lambda: fn(state, dev, seeds)["loss"].item())
                row.update(t, examples_per_s_host=row["examples"]
                           / t["host_ms"] * 1e3,
                           examples_per_s_device=row["examples"]
                           / t["device_ms"] * 1e3)
            else:
                fn(state, dev, seeds)
            step[name] = row
        res["step"] = step
        mark("step_timing")
        log(f"{run}: one optimizer step (2 x {micro} x {seq}), unpacked "
            f"vs packed: {step}; seconds by part {marks}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _set_remat(model, policy: str) -> None:
    """Switch a built pretraining model's activation checkpointing to
    `policy` ("off" or a remat policy) in place: the attributes its
    encoder and layers read at each forward (models/bert.py)."""
    encoder = model.bert.encoder
    encoder.remat_policy = None if policy == "off" else policy
    for layer in encoder.layers:
        layer.remat_mlp = policy == "mlp_only"


def phase_remat(torch, np, summary, device="cuda",
                cfg_path=os.path.join(HERE, "configs",
                                      "bert_large_uncased_config.json"),
                samples=None):
    """--checkpoint_activations at phase 2's packed 16 x 512 (BERT-Large,
    bf16):

    - the main path: REMAT_STEPS steps of the entry point's trainer with
      --packing --checkpoint_activations under the model config's policy
      ("nothing"): exact launch counts (each layer's residual tails and
      flash forward twice a microbatch);
    - per policy (off, nothing, dots, mlp_only), on one model switched
      between them (`_set_remat`): one packed microbatch's loss and all
      its gradients, dropout on, bit-equal to remat off; then one
      optimizer step's exact launches, its peak memory
      (torch.cuda.max_memory_allocated, and above the resident state)
      and its host clock and device time.

    `device`, `cfg_path` and `samples` exist so the phase can be
    rehearsed on the CPU at a tiny size."""
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.telemetry.health import HealthConfig
    from bert_pytorch_tpu_torch.training.pretrain import (
        build_pretrain_step, compute_params, pretrain_loss_and_grads)
    from bert_pytorch_tpu_torch.training.state import make_train_state

    spec = PACKED_RUNS["train_packed_phase2"]
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_remat_")
    marks, mark = _marks()
    res = {"policies": {}, "seconds": marks}
    summary["remat"] = res
    try:
        args = _packed_args(run_pretraining, spec, cfg_path,
                            os.path.join(tmp, "out"), device, REMAT_STEPS,
                            "--checkpoint_activations")
        config = BertConfig.from_json_file(cfg_path)
        config = config.replace(vocab_size=pad_vocab_size(config.vocab_size,
                                                          8))
        check(config.remat_policy == "nothing",
              f"remat: the model config's policy is {config.remat_policy}")
        layers, micro, seq = (config.num_hidden_layers, spec["micro"],
                              spec["seq"])
        index = array_index([varied_pretraining_arrays(
            np, samples or spec["samples"], seq, spec["lo"],
            config.vocab_size, s) for s in (0, 1)])
        p_row = run_pretraining.packed_prediction_budget(args, seq)

        reset_launches()
        result = run_pretraining.train(args, index,
                                       log=lambda m: log(f"remat: {m}"))
        launches = dict(LAUNCHES)
        summary.setdefault("launches", {})["remat"] = launches
        losses = [r["loss"] for r in result.history]
        want = _pretrain_step_launches(layers, REMAT_STEPS, True, True)
        check(len(losses) == REMAT_STEPS and all(np.isfinite(losses)),
              f"remat: trainer losses {losses}")
        if on_card:
            check(launches == want, f"remat: launch counts {launches}, "
                  f"want {want}")
        res.update(run_losses=losses, launches=launches,
                   launches_predicted=want)
        log(f"remat: {REMAT_STEPS} steps of the trainer with "
            f"--checkpoint_activations: losses {losses}, launches "
            f"{launches} (predicted {want})")
        del result
        mark("trainer")

        with torch.device(device):
            model = BertForPreTraining(config, dtype=torch.bfloat16)
        init_weights(model, torch.Generator(device=device).manual_seed(1),
                     std=config.initializer_range)
        batch = _to_steps(torch, _first_batch(index, args, config.vocab_size,
                                              micro, True), micro, device)
        micro0 = {k: v[0] for k, v in batch.items()}
        seeds = torch.randint(-2 ** 31, 2 ** 31, (2, 1 + 3 * layers),
                              dtype=torch.int32,
                              generator=torch.Generator().manual_seed(7))
        policies = ("off",) + REMAT_POLICIES
        ref = None
        for policy in policies:
            _set_remat(model, policy)
            gparams = compute_params(dict(model.named_parameters()),
                                     torch.bfloat16)
            loss, _, grads = pretrain_loss_and_grads(model, gparams, micro0,
                                                     seeds[0], p_row)
            del gparams
            row = res["policies"].setdefault(policy, {})
            if ref is None:
                ref = (loss, grads)
                want_n = len(dict(model.named_parameters()))
                check(len(grads) == want_n,
                      f"remat: {len(grads)} gradients, want {want_n}")
                continue
            differ = [k for k, g in ref[1].items()
                      if not torch.equal(grads[k], g)]
            row.update(loss_equal=bool(torch.equal(loss, ref[0])),
                       grads_compared=len(grads), grads_differ=differ)
            check(row["loss_equal"] and not differ
                  and set(grads) == set(ref[1]),
                  f"remat {policy}: loss {loss.item()!r} vs "
                  f"{ref[0].item()!r}; gradients differ at {differ[:5]}")
            del grads, loss
        del ref
        mark("bit_equality")

        # one optimizer step a policy (the step updates the parameters)
        schedule = make_schedule("poly", args.learning_rate, args.max_steps,
                                 warmup=args.warmup_proportion)
        tx = Lamb(schedule, fused="auto")
        state = make_train_state(model, tx)
        step_fn = build_pretrain_step(
            model, tx, schedule=schedule, accum_steps=2,
            max_predictions=p_row, grad_dtype=torch.bfloat16,
            health=HealthConfig())
        step_fn(state, batch, seeds)["loss"].item()      # warm
        for policy in policies:
            _set_remat(model, policy)
            row = res["policies"][policy]
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            reset_launches()
            step_fn(state, batch, seeds)["loss"].item()
            row["launches"] = dict(LAUNCHES)
            want_step = _pretrain_step_launches(
                layers, 1, True, policy in ("nothing", "dots"))
            if on_card:
                peak = torch.cuda.max_memory_allocated()
                row.update(peak_memory_gib=peak / 2 ** 30,
                           peak_above_resident_gib=(peak - resident)
                           / 2 ** 30)
                row.update(_step_times(
                    torch, lambda: step_fn(state, batch, seeds)[
                        "loss"].item()))
                check(row["launches"] == want_step,
                      f"remat {policy}: a step's launches "
                      f"{row['launches']}, want {want_step}")
            log(f"remat {policy}: {row}")
        mark("steps")
        log(f"remat: seconds by part {marks}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- finetuning ---------------------------------------------------------------

FINETUNE_STEPS = 3
# One SQuAD microbatch (32 x 384, flash in both directions) through the
# kernels against the plain versions, f32 and bf16 loss and gradients.
# f32: the contract's tolerances, as in the pretraining phases. bf16, as
# TRAIN2_MODEL_TOL: measured on the card (PERF.md, NVIDIA H100 80GB HBM3,
# 700 W) loss 8.9e-5 relative, worst gradient 2.05e-2 relative L2 (a
# layer's QKV bias); the gradient tolerance leaves 2.5x. Two leaves are
# left out of the relative check: their gradient is zero in exact
# arithmetic (the softmax over positions ignores a constant added to
# every position's logit, which qa_outputs.bias and, through the head,
# the last layer's output LayerNorm bias add), so both sides hold rounding
# noise there; each side's noise must stay under FINETUNE_NOISE of the
# largest leaf norm (measured 2.4e-4 in bf16, 1.6e-8 in f32; 2.5x).
FINETUNE_MODEL_TOL = {"float32": {"loss": 1e-5, "grad": 2e-4},
                      "bfloat16": {"loss": 1e-3, "grad": 5.2e-2}}
FINETUNE_NOISE = 6e-4
# The pooled heads' (classify, choice) microbatch: the loss averages 16
# examples' logits, not thousands of tokens', so the bf16 noise of each
# logit (24 layers apart; the serve phase reads 3e-2 on a packed 512
# batch) averages out less. Measured on the card (PERF.md, NVIDIA H100
# 80GB HBM3, 700 W): bf16 loss 1.15e-3 relative (classify from random
# weights, two calls) and 5.09e-4 (from phase 2's checkpoint, three
# calls), choice 5.4e-4 and 3.48e-4, over the token heads' 1e-3; the
# loss tolerance leaves 2.6x. Gradients as FINETUNE_MODEL_TOL (measured
# 1.6e-2 and 2.6e-2). Every run plants a fault, the head's dropout seed
# off by one, which the check must catch: its loss alone reads 3.6e-3 to
# 1.0e-2 (classify) and 1.3e-2 to 1.4e-2 (choice), so the gradients,
# which that fault moves directly, carry the check.
POOLED_MODEL_TOL = {"float32": FINETUNE_MODEL_TOL["float32"],
                    "bfloat16": {"loss": 3e-3, "grad": 5.2e-2}}
# choice's classifier.bias: its gradient is zero in exact arithmetic (the
# softmax across an example's choices ignores a shift of every score).
# Each of the n <= 64 score gradients g_i (summing to 0) is rounded once
# to the compute dtype (unit roundoff u: 2^-8 in bf16, 2^-24 in f32), and
# the f32 softmax and bias sums add at most n 2^-24 of sum |g_i|, which
# is at most 2 (sum_c |p_c - y_c| <= 2 an example, the mean over B): so
# |bias gradient| <= 2 (u + 64 * 2^-24), an absolute bound at any width.
CHOICE_BIAS_NOISE = {"bfloat16": 2 ** -7 + 2 ** -17, "float32": 2 ** -17}
CONLL_TAGS = ("O", "B-PER", "I-PER", "B-ORG", "I-ORG", "B-LOC", "I-LOC",
              "B-MISC", "I-MISC")


def squad_file(np, path: str, n: int, seed: int, lengths) -> str:
    """A synthetic SQuAD v1.1 file: `n` paragraphs of `_context` words
    (lengths drawn from `lengths`), one question each whose answer is a
    span of two words of its context."""
    rng = np.random.RandomState(seed)
    paras = []
    for i in range(n):
        text = _context(rng, int(rng.randint(*lengths)))
        words = text.split(" ")
        a0 = int(rng.randint(0, len(words) - 2))
        start = len(" ".join(words[:a0])) + (1 if a0 else 0)
        paras.append({"context": text, "qas": [{
            "id": f"q{i}", "question": QUESTIONS[i % len(QUESTIONS)],
            "answers": [{"text": " ".join(words[a0:a0 + 2]),
                         "answer_start": start}]}]})
    with open(path, "w") as f:
        json.dump({"version": "1.1", "data": [{"title": "synthetic",
                                               "paragraphs": paras}]}, f)
    return path


def _task_loss_and_grads(torch, make_model, loss_builder, dtype, plain,
                         weights, micro, seeds, device):
    """One microbatch's loss and f32 gradients through a fresh model
    (`make_model(dtype, plain)`) holding `weights`: the kernels
    (plain=False) or the plain versions."""
    from bert_pytorch_tpu_torch.training.pretrain import (compute_params,
                                                          loss_and_grads)

    with torch.device(device):
        model = make_model(dtype, plain)
    model.load_state_dict(weights)
    gparams = compute_params(dict(model.named_parameters()), None)
    loss, _, grads = loss_and_grads(loss_builder(model), gparams, micro,
                                    seeds)
    return loss.item(), {k: g.float() for k, g in grads.items()}


def _hold_microbatch(torch, np, what, make_model, loss_builder, weights,
                     batch_np, seeds, device, shift_invariant=(),
                     tols=FINETUNE_MODEL_TOL, noise_abs=None,
                     plant_head_seed=False):
    """One microbatch of a finished run through the kernels against the
    plain versions, bf16 (the whole microbatch) and f32 (a quarter of its
    rows), at `tols`: the loss relative, every gradient leaf by relative
    L2, except `shift_invariant` leaves (zero in exact arithmetic), whose
    noise on either side stays under FINETUNE_NOISE of the largest leaf
    norm, or, given `noise_abs` (by dtype), under that absolute norm.
    With `plant_head_seed`, the kernels' loss and gradients again with a
    planted fault, the head's dropout seed off by one (a mask stream out
    of step), which the check must tell apart from the plain versions:
    its loss or its worst gradient beyond `tols`.
    Returns the readings by dtype."""
    on_card = torch.device(device).type == "cuda"
    batch, seq = (batch_np["input_ids"].shape[i] for i in (1, -1))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        rows = batch if dtype == torch.bfloat16 else max(1, batch // 4)
        one = {k: torch.from_numpy(v[0, :rows]).to(device)
               for k, v in batch_np.items()}
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        got = _task_loss_and_grads(torch, make_model, loss_builder, dtype,
                                   False, weights, one, seeds, device)
        want = _task_loss_and_grads(torch, make_model, loss_builder, dtype,
                                    True, weights, one, seeds, device)
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if on_card else None)
        loss_rel = abs(got[0] - want[0]) / abs(want[0])
        largest = max(torch.linalg.vector_norm(w).item()
                      for w in want[1].values())
        worst, worst_name, noise = 0.0, None, {}
        noise_bound = (FINETUNE_NOISE if noise_abs is None
                       else noise_abs[name])
        for k, w in want[1].items():
            if k in shift_invariant:
                noise[k] = max(torch.linalg.vector_norm(g).item()
                               for g in (got[1][k], w)) / (
                                   largest if noise_abs is None else 1.0)
                continue
            rel = (torch.linalg.vector_norm(got[1][k] - w)
                   / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
            if rel > worst:
                worst, worst_name = rel, k
        tol = tols[name]
        log(f"{what}: one microbatch ({rows} x {seq}) {name}, kernels vs "
            f"plain: loss {got[0]:.6f} vs {want[0]:.6f} (rel {loss_rel:.3g}, "
            f"tol {tol['loss']:g}); worst gradient rel L2 {worst:.3g} at "
            f"{worst_name} (tol {tol['grad']:g}); the zero-in-exact-"
            f"arithmetic leaves' noise {noise} "
            + ("of the largest leaf" if noise_abs is None else "absolute")
            + f" (bound {noise_bound:g}); peak memory {peak} GiB")
        check(np.isfinite(got[0]) and loss_rel <= tol["loss"],
              f"{what} {name} loss kernels {got[0]} vs plain {want[0]}")
        check(worst <= tol["grad"], f"{what} {name} gradient {worst_name}: "
              f"rel L2 {worst} > {tol['grad']}")
        check(max(noise.values(), default=0.0) <= noise_bound,
              f"{what} {name}: zero-gradient leaves' noise {noise}")
        out[name] = {"rows": rows, "loss": got[0], "plain_loss": want[0],
                     "loss_rel": loss_rel, "max_grad_rel_l2": worst,
                     "worst_leaf": worst_name, "zero_leaf_noise": noise,
                     "peak_memory_gib": peak}
        if plant_head_seed:
            planted = seeds.clone()
            planted[-1] += 1
            bad = _task_loss_and_grads(torch, make_model, loss_builder,
                                       dtype, False, weights, one, planted,
                                       device)
            bad_rel = abs(bad[0] - want[0]) / abs(want[0])
            bad_worst = max(
                (torch.linalg.vector_norm(bad[1][k] - w)
                 / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
                for k, w in want[1].items() if k not in shift_invariant)
            log(f"{what}: {name} planted fault (head dropout seed + 1): "
                f"loss {bad[0]:.6f} vs plain {want[0]:.6f} (rel "
                f"{bad_rel:.3g}, tol {tol['loss']:g}); worst gradient rel "
                f"L2 {bad_worst:.3g} (tol {tol['grad']:g})")
            check(bad_rel > tol["loss"] or bad_worst > tol["grad"],
                  f"{what} {name}: the planted head seed fault reads loss "
                  f"{bad_rel}, gradient {bad_worst}: inside {tol}")
            out[name].update(planted_head_seed_loss_rel=bad_rel,
                             planted_head_seed_max_grad_rel_l2=bad_worst)
            del bad
        del got, want
    return out


def _finetune_step_numbers(torch, run, state, batch, seeds, on_card, what,
                           packed=False):
    """The step of a finished run_task again on its state (with the
    packed loss when `packed`): one step profiled (device ms by class,
    idle share), the host clock of a step (median of 3) and of one
    optimizer update."""
    from bert_pytorch_tpu_torch.optim.lamb import global_norm_f32
    from bert_pytorch_tpu_torch.training.pretrain import (
        build_pretrain_step, compute_params, loss_and_grads)

    builder = run.packed_loss_builder if packed else run.loss_builder
    step_fn = build_pretrain_step(run.model, run.tx, schedule=run.schedule,
                                  accum_steps=run.accum_steps,
                                  loss_fn_builder=builder)
    step_fn(state, batch, seeds)["loss"].item()   # warm
    out = {}
    if not on_card:
        return out
    out["step_ms"] = _host_ms(torch, lambda: step_fn(state, batch, seeds))
    gparams = compute_params(state.params, None)
    grads = loss_and_grads(builder(run.model), gparams,
                           {k: v[0] for k, v in batch.items()}, seeds[0])[2]
    # the update as the step pays for it: given the norm the step has
    norm = global_norm_f32(list(grads.values()))
    out["optimizer_ms"] = _host_ms(torch, lambda: run.tx.update(
        grads, state.opt_state, state.params, grad_norm=norm))
    del grads, gparams
    classes, top, prof_ms, device_total = _profile_step(
        torch, step_fn, state, batch, seeds)
    idle = 1.0 - device_total / prof_ms
    check(idle >= 0.0, f"{what}: device time {device_total} ms exceeds the "
          f"profiled step's {prof_ms} ms")
    out["profiled_step"] = {"step_ms": prof_ms, "device_ms": classes,
                            "device_total_ms": device_total,
                            "idle_share": idle, "device_ms_by_op": top}
    log(f"{what}: one optimizer step {out['step_ms']:.1f} ms (host clock, "
        f"median of 3), one optimizer update {out['optimizer_ms']:.2f} ms; "
        f"profiled step {prof_ms:.1f} ms (host clock, profiler on), device "
        f"{device_total:.1f} ms of it (idle share {idle:.3f}), by class "
        f"{classes}; by op (top 12) {top}")
    return out


def _eval_batches_by_bucket(arrays, batch_size, buckets):
    from bert_pytorch_tpu_torch.training.finetune import (
        bucketed_eval_batches)

    out = {}
    for _, _, bucket in bucketed_eval_batches(arrays, batch_size, buckets):
        out[bucket] = out.get(bucket, 0) + 1
    return out


def phase_finetune_squad(torch, np, summary, device="cuda",
                         cfg_path=os.path.join(
                             HERE, "configs",
                             "bert_large_uncased_config.json"),
                         ckpt_dir=None, batch=SQUAD_ATTN[0]):
    """SQuAD v1.1 finetuning of `cfg_path`'s model (BERT-Large, 24 layers,
    full width, vocab padded to 30528) by the entry point's run_task,
    seeded from train_phase2's last checkpoint (--init_checkpoint
    <ckpt_dir>/pretrain_ckpts@<step>): FINETUNE_STEPS steps of `batch` x
    384, bf16, dropout 0.1, then the checkpoint, predict over the eval
    buckets and evaluate_v1, on synthetic files; exact launch counts of the
    run (reset just before, read just after); the server answering from
    the finetuned checkpoint; the step profiled and timed; one microbatch
    through the kernels against the plain versions. `device`, `cfg_path`
    and `batch` exist so the phase can be rehearsed on the CPU at a tiny
    size."""
    import shutil

    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.models.bert import BertForQuestionAnswering
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.tasks import registry, squad
    from bert_pytorch_tpu_torch.tasks.squad_task import (_loss_builder,
                                                         parse_arguments)
    from bert_pytorch_tpu_torch.training.finetune import (
        eval_buckets, plain_train_batches, run_task, to_device)
    from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

    on_card = torch.device(device).type == "cuda"
    prev = summary.get("train_phase2", {}).get("checkpoint")
    check(prev is not None and ckpt_dir is not None,
          "finetune_squad starts from train_phase2's checkpoint: run the "
          "train phases first, in the same checkpoint directory")
    init = f"{os.path.join(ckpt_dir, 'pretrain_ckpts')}@{prev['step']}"
    seq = SQUAD_ATTN[1]
    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    layers = config.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_squad_")
    handle = None
    try:
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        # train: 4 steps' worth of single windows of 60-330 words; dev:
        # contexts from 20 to 420 words, so windows land in every bucket
        # and the longest slide
        train = squad_file(np, os.path.join(tmp, "train.json"),
                           (FINETUNE_STEPS + 1) * batch, 0, (60, 330))
        dev = squad_file(np, os.path.join(tmp, "dev.json"), 24, 1,
                         (20, 420))
        out = os.path.join(tmp, "out")
        args = parse_arguments([
            "--do_train", "--do_predict", "--do_eval", "--train_file",
            train, "--predict_file", dev, "--model_config_file", cfg_path,
            "--vocab_file", vocab, "--output_dir", out, "--init_checkpoint",
            init, "--max_seq_length", str(seq), "--train_batch_size",
            str(batch), "--max_steps", str(FINETUNE_STEPS), "--seed", "0",
            "--device", device])
        # what predict will run: the dev windows by bucket
        tokenizer = get_wordpiece_tokenizer(vocab)
        dev_arrays = squad.features_to_arrays(
            squad.convert_examples_to_features(
                squad.read_squad_examples(dev, False), tokenizer, seq,
                args.doc_stride, args.max_query_length), False)
        by_bucket = _eval_batches_by_bucket(
            dev_arrays, args.predict_batch_size, eval_buckets(seq))
        check(by_bucket.get(seq, 0) >= 1 and len(by_bucket) >= 3,
              f"dev windows by bucket {by_bucket}: want the {seq} bucket "
              "and shorter ones")
        lines, trace = [], {}

        def note(msg):
            lines.append(msg)
            log(f"finetune_squad: {msg}")

        # the main path: counts zeroed just before, read just after
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        results = run_task(registry.get("squad"), args, log=note,
                           trace=trace)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
                   if on_card else None)
        summary.setdefault("launches", {})["finetune_squad"] = launches
        history, state, run = trace["history"], trace["state"], trace["run"]
        losses = [h["loss"] for h in history]
        norms = [h["grad_norm"] for h in history]
        n_params = len(state.params)
        loaded = [ln for ln in lines if ln.startswith("init_checkpoint ")]
        check(loaded == [f"init_checkpoint step {prev['step']}: loaded "
                         f"{n_params - 2} param leaves, 2 fresh-initialized"],
              f"init checkpoint: {loaded}, want every parameter but "
              "qa_outputs' two from the pretraining checkpoint")
        check(len(history) == FINETUNE_STEPS and state.step == FINETUNE_STEPS
              and state.opt_state.count == FINETUNE_STEPS,
              f"{len(history)} steps, state step {state.step}")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"non-finite losses {losses} or grad norms {norms}")
        ckpt_steps = sorted(int(d) for d in os.listdir(
            os.path.join(out, "ckpt")) if d.isdigit())
        check(ckpt_steps == [FINETUNE_STEPS], f"checkpoints {ckpt_steps}")
        with open(os.path.join(out, "predictions.json")) as f:
            preds = json.load(f)
        check(len(preds) == 24 and {"exact_match", "f1"} <= set(results),
              f"{len(preds)} predictions, results {sorted(results)}")
        # per step: the embedding LN and 48 residual tails, forward and
        # backward, and every layer's attention by the flash forward and
        # the fused backward; per predict forward: 49 LayerNorms, and the
        # flash forward in each layer of a 384-bucket batch
        n_fwd = sum(by_bucket.values())
        want = {"layer_norm_fwd": FINETUNE_STEPS + (2 * layers + 1) * n_fwd,
                "layer_norm_bwd": FINETUNE_STEPS,
                "add_dropout_layer_norm_fwd": 2 * layers * FINETUNE_STEPS,
                "add_dropout_layer_norm_bwd": 2 * layers * FINETUNE_STEPS,
                "flash_attention_fwd": layers * FINETUNE_STEPS
                + layers * by_bucket[seq],
                "flash_attention_bwd": layers * FINETUNE_STEPS,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "lamb_stage1": 0, "lamb_stage2": 0}
        if on_card:
            check(launches == want, f"launch counts {launches}, want {want}")
        log(f"finetune_squad: {FINETUNE_STEPS} steps of {batch} x {seq} from "
            f"{init}: losses {losses}, grad norms {norms}, learning rates "
            f"{[h['learning_rate'] for h in history]}; results "
            f"{json.dumps(results)}; predict batches by bucket {by_bucket}; "
            f"run_task {wall:.1f} s; peak memory {peak_gb} GiB; launches "
            f"{launches} (predicted {want})")
        res = {"steps": len(history), "batch": batch, "seq": seq,
               "init_step": prev["step"], "losses": losses,
               "grad_norms": norms, "checkpoint_steps": ckpt_steps,
               "eval": {k: results[k] for k in ("exact_match", "f1")},
               "results": results, "predict_buckets":
               {str(b): n for b, n in by_bucket.items()},
               "run_task_s": wall, "peak_memory_gib": peak_gb,
               "launches": launches, "launches_predicted": want}
        summary["finetune_squad"] = res

        # the server answers from the finetuned checkpoint
        handle = run_server.serve(run_server.parse_arguments([
            "--model_config_file", cfg_path, "--vocab_file", vocab,
            "--task_checkpoint", f"squad={os.path.join(out, 'ckpt')}",
            "--port", "0", "--host", "127.0.0.1", "--device", device]),
            log=lambda m: log("finetune_squad: serve: " + m))
        body = {"question": QUESTIONS[0],
                "context": _context(np.random.RandomState(5), 60)}
        code, reply = _post(handle.url, body)
        check(code == 200 and bool(reply["answer"])
              and reply["answer"] in body["context"],
              f"served finetuned checkpoint: {code} {reply.get('answer')!r}")
        res["serve"] = {"code": code, "answer": reply["answer"]}
        log(f"finetune_squad: the server on {os.path.join(out, 'ckpt')} "
            f"answered {code} {reply['answer']!r}")
        handle.close()
        handle = None

        # the step again, profiled and timed, on the run's state
        batch_np, _, _ = next(plain_train_batches(
            run.train_arrays, batch, 1, True, 1, run.label_ignore))
        tb = to_device(batch_np, device)
        seeds = dropout_seeds(7, 1, 1, run.model.n_dropout_sites)
        res.update(_finetune_step_numbers(torch, run, state, tb, seeds,
                                          on_card, "finetune_squad"))
        if "step_ms" in res:
            res["train_examples_per_s"] = batch / res["step_ms"] * 1e3
        weights = {k: v.detach().clone()
                   for k, v in run.model.state_dict().items()}
        del run, state, trace, tb

        # one microbatch: kernels against the plain versions
        res["kernels_vs_plain"] = _hold_microbatch(
            torch, np, "finetune_squad",
            lambda dtype, plain: BertForQuestionAnswering(
                config, dtype=dtype, plain=plain),
            _loss_builder, weights, batch_np, seeds[0], device,
            shift_invariant=("qa_outputs.bias", f"bert.encoder.layers."
                             f"{layers - 1}.output_layer_norm.bias"))
    finally:
        if handle is not None:
            handle.close()
        shutil.rmtree(tmp, ignore_errors=True)


def conll_file(np, path: str, n: int, seed: int) -> str:
    """A synthetic CoNLL-2003 file of `n` sentences (10-110 words of the
    serve phase's vocabulary, so some exceed 128 pieces) with the
    CoNLL-2003 tag set: entities of 1-3 words, B- then I-."""
    rng = np.random.RandomState(seed)
    lines = ["-DOCSTART- -X- -X- O", ""]
    for _ in range(n):
        words = int(rng.randint(10, 110))
        i = 0
        while i < words:
            if rng.rand() < 0.25:
                kind = ("PER", "ORG", "LOC", "MISC")[rng.randint(4)]
                for j in range(int(rng.randint(1, 4))):
                    w = _WORDS[rng.randint(len(_WORDS))]
                    lines.append(f"{w} NNP B-NP {'BI'[j > 0]}-{kind}")
                    i += 1
            else:
                lines.append(f"{_WORDS[rng.randint(len(_WORDS))]} NN I-NP O")
                i += 1
        lines += [". . O O", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_finetune_ner(torch, np, summary, device="cuda",
                       cfg_path=os.path.join(HERE, "configs",
                                             "bert_large_uncased_config.json"),
                       batch=NER_TRAIN[0]):
    """CoNLL NER finetuning of `cfg_path`'s model (BERT-Large, random
    weights from the seed) by the entry point's run_task: one epoch of
    FINETUNE_STEPS steps of `batch` x 128 on a synthetic CoNLL-2003 file,
    bf16, then val and test macro F1 and the checkpoint; exact launch
    counts of the run (the LayerNorm kernels, no flash: seq 128 takes
    plain attention); the step profiled and timed. `device`, `cfg_path`
    and `batch` exist so the phase can be rehearsed on the CPU."""
    import shutil

    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data import ner
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.models.bert import BertForTokenClassification
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.tasks import registry
    from bert_pytorch_tpu_torch.tasks.ner_task import (_loss_builder,
                                                       parse_arguments)
    from bert_pytorch_tpu_torch.training.finetune import (
        eval_buckets, plain_train_batches, run_task, to_device)
    from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

    on_card = torch.device(device).type == "cuda"
    seq = NER_TRAIN[1]
    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    layers = config.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ner_")
    try:
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        files = {split: conll_file(np, os.path.join(tmp, f"{split}.txt"), n,
                                   seed)
                 for split, n, seed in (("train", FINETUNE_STEPS * batch, 0),
                                        ("val", batch, 1),
                                        ("test", batch, 2))}
        out = os.path.join(tmp, "out")
        args = parse_arguments([
            "--train_file", files["train"], "--val_file", files["val"],
            "--test_file", files["test"], "--labels", *CONLL_TAGS,
            "--model_config_file", cfg_path, "--vocab_file", vocab,
            "--epochs", "1", "--lr", "5e-5", "--batch_size", str(batch),
            "--max_seq_len", str(seq), "--output_dir", out, "--seed", "0",
            "--device", device])
        tokenizer = get_wordpiece_tokenizer(vocab)
        n_eval = sum(sum(_eval_batches_by_bucket(
            ner.NERDataset(files[s], tokenizer, CONLL_TAGS, seq).arrays(),
            batch, eval_buckets(seq)).values()) for s in ("val", "test"))
        trace = {}
        # the main path: counts zeroed just before, read just after
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        results = run_task(registry.get("ner"), args,
                           log=lambda m: log(f"finetune_ner: {m}"),
                           trace=trace)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
                   if on_card else None)
        summary.setdefault("launches", {})["finetune_ner"] = launches
        history, state, run = trace["history"], trace["state"], trace["run"]
        losses = [h["loss"] for h in history]
        check(len(history) == FINETUNE_STEPS
              and all(np.isfinite(losses))
              and all(np.isfinite(h["grad_norm"]) for h in history),
              f"{len(history)} steps, losses {losses}")
        check(all(0.0 <= results[k] <= 1.0 for k in ("val_f1", "test_f1")),
              f"macro F1 {results.get('val_f1')} / {results.get('test_f1')}")
        ckpt_steps = sorted(int(d) for d in os.listdir(
            os.path.join(out, "ckpt")) if d.isdigit())
        check(ckpt_steps == [FINETUNE_STEPS], f"checkpoints {ckpt_steps}")
        # per step the embedding LN and 48 residual tails, forward and
        # backward; per eval forward 49 LayerNorms; no flash at seq 128
        want = {"layer_norm_fwd": FINETUNE_STEPS + (2 * layers + 1) * n_eval,
                "layer_norm_bwd": FINETUNE_STEPS,
                "add_dropout_layer_norm_fwd": 2 * layers * FINETUNE_STEPS,
                "add_dropout_layer_norm_bwd": 2 * layers * FINETUNE_STEPS,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "lamb_stage1": 0, "lamb_stage2": 0}
        if on_card:
            check(launches == want, f"launch counts {launches}, want {want}")
        log(f"finetune_ner: {FINETUNE_STEPS} steps of {batch} x {seq}: "
            f"losses {losses}; val macro F1 {results['val_f1']:.4f}, test "
            f"{results['test_f1']:.4f}; {n_eval} eval forwards; run_task "
            f"{wall:.1f} s; peak memory {peak_gb} GiB; launches {launches} "
            f"(predicted {want})")
        res = {"steps": len(history), "batch": batch, "seq": seq,
               "losses": losses, "grad_norms": [h["grad_norm"]
                                                for h in history],
               "val_f1": results["val_f1"], "test_f1": results["test_f1"],
               "checkpoint_steps": ckpt_steps, "run_task_s": wall,
               "peak_memory_gib": peak_gb, "launches": launches,
               "launches_predicted": want}
        summary["finetune_ner"] = res
        batch_np, _, _ = next(plain_train_batches(
            run.train_arrays, batch, 1, True, 1, run.label_ignore))
        seeds = dropout_seeds(7, 1, 1, run.model.n_dropout_sites)
        res.update(_finetune_step_numbers(
            torch, run, state, to_device(batch_np, device), seeds, on_card,
            "finetune_ner"))
        if "step_ms" in res:
            res["train_examples_per_s"] = batch / res["step_ms"] * 1e3
        weights = {k: v.detach().clone()
                   for k, v in run.model.state_dict().items()}
        num_labels = run.model.num_labels
        del run, state, trace

        # one microbatch: kernels against the plain versions
        res["kernels_vs_plain"] = _hold_microbatch(
            torch, np, "finetune_ner",
            lambda dtype, plain: BertForTokenClassification(
                config, num_labels=num_labels, dtype=dtype, plain=plain),
            _loss_builder, weights, batch_np, seeds[0], device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- classify, choice and embed finetuning -------------------------------------

GLUE_LABELS = ("negative", "positive")
# the replies the phase's own server call checks, one a task
TASK_BODIES = {
    "classify": {"text": "the film was fast", "text_pair": "a slow report"},
    "choice": {"question": QUESTIONS[0],
               "choices": ["the cat", "a dog", "red mat", "old train"]},
    "embed": {"texts": ["the cat sat on a mat", "people walked across"]}}


def glue_file(np, path: str, task: str, n: int, seed: int) -> str:
    """A synthetic file of `task`'s format, `n` examples of the serve
    phase's words: classify TSV label<TAB>text_a<TAB>text_b (5-80 words
    each, so pairs land in every eval bucket up to 128 and some are
    truncated), embed TSV label<TAB>text (4-150 words), choice JSONL
    {"question", "choices", "label"} (TASK_CHOICES choices of 3-60 words,
    a question on three records in four)."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        label = GLUE_LABELS[rng.randint(2)]
        if task == "classify":
            rows.append("\t".join((label, _context(rng, rng.randint(5, 80)),
                                   _context(rng, rng.randint(5, 80)))))
        elif task == "embed":
            rows.append(f"{label}\t{_context(rng, rng.randint(4, 150))}")
        else:
            rec = {"choices": [_context(rng, rng.randint(3, 60))
                               for _ in range(TASK_CHOICES)],
                   "label": int(rng.randint(TASK_CHOICES))}
            if i % 4:
                rec["question"] = QUESTIONS[i % len(QUESTIONS)]
            rows.append(json.dumps(rec))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def phase_finetune_tasks(torch, np, summary, device="cuda",
                         cfg_path=os.path.join(
                             HERE, "configs",
                             "bert_large_uncased_config.json"),
                         batch=TASK_TRAIN[0]):
    """classify, choice and embed finetuning of `cfg_path`'s model (the
    script passes BERT-Large's width at CUT_LAYERS; vocab padded to 30528)
    by the entry point's run_task, one after the other: seeded from the
    pretraining checkpoint train_dp kept (at `cfg_path`'s depth) when
    that phase ran, else random weights from the seed, FINETUNE_STEPS
    steps of `batch` x 128 at the
    JAX base parser's recipe (lr 3e-5, 10% warmup, clip 1.0, bf16,
    dropout 0.1; choice at TASK_CHOICES choices, `batch` x 4 rows), on
    synthetic train, val and test files; val and test accuracy, embed's
    embedding norms, the checkpoint; exact launch counts of each run
    (reset just before, read just after); the checkpoint answered by its
    own server call, then deleted; the step profiled and timed; one
    classify and one choice microbatch through the kernels against the
    plain versions. `device`, `cfg_path` and `batch` exist so the phase
    can be rehearsed on the CPU at a tiny size."""
    import shutil

    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data import glue
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.models.bert import (
        BertForMultipleChoice, BertForSequenceClassification)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.tasks import choice, classify, registry
    from bert_pytorch_tpu_torch.training.finetune import (
        eval_buckets, plain_train_batches, run_task, to_device)
    from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

    on_card = torch.device(device).type == "cuda"
    seq = TASK_TRAIN[1]
    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    layers = config.num_hidden_layers
    prev = summary.get("train_dp", {}).get("checkpoint")
    pretrain = None if prev is None else prev["dir"]
    init = [] if pretrain is None else [
        "--init_checkpoint", f"{pretrain}@{prev['step']}"]
    per_step = {"layer_norm_fwd": 1, "layer_norm_bwd": 1,
                "add_dropout_layer_norm_fwd": 2 * layers,
                "add_dropout_layer_norm_bwd": 2 * layers}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tasks_")
    try:
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        tokenizer = get_wordpiece_tokenizer(vocab)
        for task in ("classify", "choice", "embed"):
            what = f"finetune_{task}"
            ext = "jsonl" if task == "choice" else "tsv"
            files = {split: glue_file(np, os.path.join(
                tmp, f"{task}_{split}.{ext}"), task, n, seed)
                for split, n, seed in (("train", FINETUNE_STEPS * batch, 0),
                                       ("val", batch, 1), ("test", batch, 2))}
            out = os.path.join(tmp, f"{task}_out")
            args = registry.get(task).parse_arguments(
                ["--train_file", files["train"], "--val_file", files["val"],
                 "--test_file", files["test"], "--model_config_file",
                 cfg_path, "--vocab_file", vocab, "--output_dir", out,
                 "--batch_size", str(batch), "--max_seq_len", str(seq),
                 "--epochs", "1", "--seed", "0", "--device", device]
                + init + (["--num_choices", str(TASK_CHOICES)]
                          if task == "choice" else []))
            # what eval will run: the val and test batches by bucket, and
            # embed's one batch of embeddings
            n_eval = sum(sum(_eval_batches_by_bucket(
                (glue.MultipleChoiceDataset(files[s], tokenizer,
                                            TASK_CHOICES, seq)
                 if task == "choice" else glue.PairClassificationDataset(
                     files[s], tokenizer, GLUE_LABELS, seq)).arrays(),
                batch, eval_buckets(seq)).values()) for s in ("val", "test"))
            if task == "embed":
                n_eval += 1
            lines, trace = [], {}

            def note(msg, what=what):
                lines.append(msg)
                log(f"{what}: {msg}")

            # the main path: counts zeroed just before, read just after
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            results = run_task(registry.get(task), args, log=note,
                               trace=trace)
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
                       if on_card else None)
            summary.setdefault("launches", {})[what] = launches
            history, state, run = (trace["history"], trace["state"],
                                   trace["run"])
            losses = [h["loss"] for h in history]
            norms = [h["grad_norm"] for h in history]
            if pretrain is not None:
                loaded = [ln for ln in lines
                          if ln.startswith("init_checkpoint ")]
                check(loaded == [f"init_checkpoint step {prev['step']}: "
                                 f"loaded {len(state.params) - 2} param "
                                 "leaves, 2 fresh-initialized"],
                      f"{what} init checkpoint: {loaded}, want every "
                      "parameter but the classifier's two")
            check(len(history) == FINETUNE_STEPS
                  and all(np.isfinite(losses)) and all(np.isfinite(norms)),
                  f"{what}: {len(history)} steps, losses {losses}, grad "
                  f"norms {norms}")
            check(all(0.0 <= results[k] <= 1.0
                      for k in ("val_accuracy", "test_accuracy")),
                  f"{what} accuracy {results}")
            if task == "embed":
                check(results["embedding_dim"] == config.hidden_size
                      and results["embedding_norm_err"] < 1e-3,
                      f"{what} embeddings {results}")
            ckpt_steps = sorted(int(d) for d in os.listdir(
                os.path.join(out, "ckpt")) if d.isdigit())
            check(ckpt_steps == [FINETUNE_STEPS], f"{what} checkpoints "
                  f"{ckpt_steps}")
            # per step the embedding LN and 48 residual tails, forward and
            # backward; per eval forward 49 LayerNorms; no flash at 128
            want = dict({k: 0 for k in LAUNCHES},
                        **{k: n * FINETUNE_STEPS for k, n in per_step.items()})
            want["layer_norm_fwd"] += (2 * layers + 1) * n_eval
            if on_card:
                check(launches == want, f"{what} launch counts {launches}, "
                      f"want {want}")
            rows = batch * (TASK_CHOICES if task == "choice" else 1)
            log(f"{what}: {FINETUNE_STEPS} steps of {batch} x {seq} ({rows} "
                f"rows) from {init or 'random weights'}: losses {losses}, "
                f"grad norms {norms}; results {json.dumps(results)}; "
                f"{n_eval} eval forwards; run_task {wall:.1f} s; peak memory "
                f"{peak_gb} GiB; launches {launches} (predicted {want})")
            res = {"steps": len(history), "batch": batch, "seq": seq,
                   "rows": rows, "init_step": None if prev is None
                   else prev["step"], "losses": losses, "grad_norms": norms,
                   "val_accuracy": results["val_accuracy"],
                   "test_accuracy": results["test_accuracy"],
                   "checkpoint_steps": ckpt_steps, "run_task_s": wall,
                   "peak_memory_gib": peak_gb, "launches": launches,
                   "launches_predicted": want, "launches_per_step": per_step,
                   "output_dir": out}
            if task == "embed":
                res.update({k: results[k] for k in ("embedding_dim",
                                                    "embedding_norm_err")})
            summary[what] = res

            # the checkpoint answered by its own server call, then deleted
            handle = run_server.serve(run_server.parse_arguments([
                "--model_config_file", cfg_path, "--vocab_file", vocab,
                "--task_checkpoint", f"{task}={os.path.join(out, 'ckpt')}",
                "--port", "0", "--host", "127.0.0.1", "--device", device]),
                log=lambda m, what=what: log(f"{what}: serve: {m}"))
            try:
                code, reply = _post(handle.url, TASK_BODIES[task],
                                    route=task)
            finally:
                handle.close()
            _check_reply(np, task, TASK_BODIES[task], code, reply,
                         config.hidden_size)
            res["serve"] = {"code": code, "reply": reply}
            shutil.rmtree(out)
            log(f"{what}: the server on its checkpoint answered {code}; "
                f"{out} deleted")

            # the step again, profiled and timed, on the run's state
            batch_np, _, _ = next(plain_train_batches(
                run.train_arrays, batch, 1, True, 1, run.label_ignore))
            seeds = dropout_seeds(7, 1, 1, run.model.n_dropout_sites)
            res.update(_finetune_step_numbers(
                torch, run, state, to_device(batch_np, device), seeds,
                on_card, what))
            if "step_ms" in res:
                res["train_examples_per_s"] = batch / res["step_ms"] * 1e3
            weights = {k: v.detach().clone()
                       for k, v in run.model.state_dict().items()}
            del run, state, trace, history

            # one microbatch: kernels against the plain versions
            if task == "classify":
                res["kernels_vs_plain"] = _hold_microbatch(
                    torch, np, what,
                    lambda dtype, plain: BertForSequenceClassification(
                        config, num_labels=len(GLUE_LABELS), dtype=dtype,
                        plain=plain),
                    classify._loss_builder, weights, batch_np, seeds[0],
                    device, tols=POOLED_MODEL_TOL, plant_head_seed=True)
            elif task == "choice":
                res["kernels_vs_plain"] = _hold_microbatch(
                    torch, np, what,
                    lambda dtype, plain: BertForMultipleChoice(
                        config, dtype=dtype, plain=plain),
                    choice.make_loss_builder(TASK_CHOICES), weights,
                    batch_np, seeds[0], device,
                    shift_invariant=("classifier.bias",),
                    tols=POOLED_MODEL_TOL, noise_abs=CHOICE_BIAS_NOISE,
                    plant_head_seed=True)
            del weights
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The SLO drill on the card (serve_slo): scripts/check_slo.sh's
# miniature windows and budget, so that a page fires and resolves within
# seconds; its latency spec's bound is 1000 ms (the load's p99 bound) and
# latency_burst holds each batch SLO_INJECT_LATENCY_MS, since the drill
# configuration's 10000 ms bound would outlast the admission timeout.
SLO_DRILL = {
    "windows": {"page": {"short_s": 3, "long_s": 12, "burn_rate": 2.0},
                "ticket": {"short_s": 6, "long_s": 24, "burn_rate": 1.5}},
    "serve": [{"name": "availability", "kind": "availability",
               "budget": 0.05, "min_events": 3},
              {"name": "latency_p99", "kind": "latency", "bound_ms": 1000,
               "budget": 0.05, "min_events": 3}]}
SLO_INJECT_LATENCY_MS = 1500.0
SLO_BUCKETS = "128,512"
# the clean leg: requests/s and seconds (the other legs send at these
# rates while they wait for their alert); 12 s covers the page's long
# window
SLO_CLEAN = (20.0, 12.0)
# the planes' cost: the serve phase's fixed rate, for 10 s a leg (1000
# requests each, ten above the p99), which keeps the whole script inside
# its time limit with the stream phase added
SLO_LOAD = (LOAD_RATE, 10.0)
# an alert must fire, and resolve, within one short window plus this
# (four evaluation ticks of 0.25 s and a probe interval of 0.5 s)
SLO_SLACK_S = 1.5


def slo_bodies(np, seed: int = 3) -> dict:
    """Requests of the five routes at mixed lengths: most of 3-100 pieces
    (the 128 bucket), one a route of 130-230 (the 512 bucket), so the
    clean leg's waves ride both buckets while the prober holds its
    pinned answers (a request rides its natural bucket whatever else is
    queued: serving/batcher.py)."""
    rng = np.random.RandomState(seed)
    return {
        "squad": [{"question": QUESTIONS[i % len(QUESTIONS)],
                   "context": _context(rng, n)} for i, n in
                  enumerate((12, 30, 50, 70, 200))],
        "ner": [{"tokens": _context(rng, n).split()}
                for n in (5, 20, 60, 150)],
        "classify": [{"text": _context(rng, n), "text_pair":
                      _context(rng, n // 2)} for n in (6, 20, 50, 100)],
        "choice": [{"question": QUESTIONS[i], "choices": [
            _context(rng, n + c) for c in range(4)]}
            for i, n in enumerate((3, 8, 15, 130))],
        "embed": [{"texts": [_context(rng, n) for n in (4, 20, 60)]},
                  {"text": _context(rng, 30)}, {"text": _context(rng, 180)}]}


class _Traffic:
    """Open-loop requests on a thread: one POST every 1 / `rate` seconds,
    the routes of `bodies` in turn, each on a thread of its own, until
    `stop()`; `replies` holds (route, status, seconds)."""

    def __init__(self, url: str, bodies: dict, rate: float):
        self.url, self.rate = url, float(rate)
        self.items = [(r, b) for r in sorted(bodies) for b in bodies[r]]
        self.replies, self._threads = [], []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _one(self, route, body):
        t0 = time.perf_counter()
        code, _ = _post(self.url, body, timeout=120, route=route)
        with self._lock:
            self.replies.append((route, code, time.perf_counter() - t0))

    def _run(self):
        i, t_next = 0, time.perf_counter()
        while not self._stop.is_set():
            route, body = self.items[i % len(self.items)]
            th = threading.Thread(target=self._one, args=(route, body),
                                  daemon=True)
            th.start()
            self._threads.append(th)
            i += 1
            t_next += 1.0 / self.rate
            self._stop.wait(max(0.0, t_next - time.perf_counter()))

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(30)
        for th in self._threads:
            th.join(180)
        return list(self.replies)


def _get_json(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def _wait_for(cond, timeout: float, what: str, poll: float = 0.05) -> float:
    """Seconds until `cond()` held; fails the phase after `timeout`."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return time.perf_counter() - t0
        time.sleep(poll)
    raise PhaseError(f"serve_slo: timed out after {timeout:g} s waiting for "
                     f"{what}")


def _firing(url: str, slo=None, severity=None) -> list:
    return [a for a in _get_json(url, "/v1/alerts")["firing"]
            if (slo is None or a["slo"] == slo)
            and (severity is None or a["severity"] == severity)]


def _probes(handle) -> dict:
    return {t: s["probes"]
            for t, s in handle.prober.status()["tasks"].items()}


def _two_more_probe_rounds(handle, timeout: float = 30.0) -> None:
    start = _probes(handle)
    _wait_for(lambda: all(n >= start[t] + 2
                          for t, n in _probes(handle).items()),
              timeout, "two more probe rounds")


def _eval_tick_ms(engine, reps: int = 200) -> dict:
    """Host time of one SLOEngine.evaluate() over the server's registry
    as it stands (the evaluator thread keeps ticking beside it)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.evaluate()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(times), "max_ms": max(times),
            "reps": reps}


def _serve_log(out_dir: str, on_card: bool, kind: str) -> dict:
    """--output_dir's three files, after the server closed: the text log,
    the jsonl whose first record is the provenance header naming the
    card, and the csv of the `serve` record."""
    files = {name: os.path.join(out_dir, f"serve_log{ext}") for name, ext in
             (("txt", ".txt"), ("jsonl", ".jsonl"),
              ("csv", "_metrics.csv"))}
    check(all(os.path.isfile(p) for p in files.values()),
          f"serve log files {sorted(os.listdir(out_dir))}")
    with open(files["jsonl"]) as f:
        records = [json.loads(line) for line in f]
    header = records[0]
    check(header["tag"] == "header" and (
        not on_card or (header["device_kind"] == kind
                        and kind in header["nvidia_smi"])),
          f"serve log header {header}")
    serve = [r for r in records if r["tag"] == "serve"]
    with open(files["csv"]) as f:
        csv_lines = f.read().splitlines()
    check(len(serve) == 1 and len(csv_lines) == 2
          and csv_lines[1].startswith("serve,"),
          f"serve log records {serve}, csv {csv_lines}")
    with open(files["txt"]) as f:
        text = f.read()
    check("SLO ALERT firing [page] availability" in text
          and "PROBE mismatch [squad]" in text,
          "serve_log.txt lacks the drill's alert and probe lines")
    named = {k: header.get(k) for k in ("git_sha", "torch_version",
                                        "cuda_version", "device_kind",
                                        "nvidia_smi")}
    log(f"serve_slo: serve log: {sorted(os.listdir(out_dir))}; header "
        f"{json.dumps(named)}; serve record {serve[0]}")
    return {"header": header, "serve_record": serve[0],
            "txt_lines": len(text.splitlines())}


def _load_run(url: str, rate: float, secs: float) -> dict:
    proc = subprocess.run(
        [sys.executable, SERVE_LOAD, "--url", url, "--rate", str(rate),
         "--duration", str(secs), "--ramp", "", "--bound_ms",
         str(LOAD_BOUND_MS)], capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"serve_load exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    fixed = json.loads(proc.stdout.strip().splitlines()[-1])["fixed"]
    fixed["diagnosis"] = load_diagnosis(fixed, secs)
    if fixed["ok"] != fixed["sent"]:
        log(f"serve_slo: load diagnosis {json.dumps(fixed['diagnosis'])}")
    check(not fixed["no_status"], f"load: {len(fixed['no_status'])} "
          f"request(s) got no status: {fixed['no_status'][:5]}")
    check(fixed["ok"] == fixed["sent"] > 0, f"load: {fixed['ok']} of "
          f"{fixed['sent']} answered 200 ({fixed['codes']})")
    return fixed


def serve_slo_bucket_drift(np, handle) -> dict:
    """A probe's answer must not depend on what else is queued: the squad
    probe alone, and queued behind a long request of its task (the
    scheduler runs the long one in a 512 wave and the probe in a 128
    wave of its own), canonicalized as the prober compares them, are
    equal."""
    from bert_pytorch_tpu_torch.serving.prober import (KNOWN_ANSWER_PAYLOADS,
                                                       canonicalize)

    probe = KNOWN_ANSWER_PAYLOADS["squad"]
    alone = canonicalize(_post(handle.url, probe, route="squad")[1])
    long_body = {"question": QUESTIONS[0],
                 "context": _context(np.random.RandomState(9), 380)}
    got = {}
    # a classify batch holds the scheduler while the long squad request
    # and then the probe queue up: the next wave is squad's, its head the
    # long request; the probe waits for a 128 wave
    engine = handle.engine
    forward = engine.forward
    gate, holding = threading.Event(), threading.Event()

    def held(task, batch):
        if task == "classify":
            holding.set()
            gate.wait(60)
        return forward(task, batch)

    def ask(key, body, route):
        got[key] = _post(handle.url, body, route=route)

    before = dict(engine.forward_counts)
    engine.forward = held
    ths = []
    try:
        for key, body, route in (
                ("hold", {"text": "the cat sat"}, "classify"),
                ("long", long_body, "squad"), ("probe", probe, "squad")):
            ths.append(threading.Thread(target=ask, args=(key, body,
                                                          route)))
            ths[-1].start()
            if key == "hold":
                check(holding.wait(60), "bucket drift: the holding batch "
                      "never reached the engine")
            time.sleep(0.3)
        gate.set()
        for th in ths:
            th.join(120)
    finally:
        gate.set()
        engine.forward = forward
    check(all(got[k][0] == 200 for k in ("hold", "long", "probe")),
          f"bucket drift replies {[got[k][0] for k in got]}")
    forwards = {f"{t}/{b}": n - before.get((t, b), 0)
                for (t, b), n in engine.forward_counts.items()
                if n != before.get((t, b), 0)}
    with_long = canonicalize(got["probe"][1])
    same = with_long == alone
    log(f"serve_slo: the squad probe alone and queued behind a 512-bucket "
        f"request: canonical answers {'equal' if same else 'differ'} "
        f"({alone.get('nbest', [])[:1]} vs "
        f"{with_long.get('nbest', [])[:1]}); forwards meanwhile {forwards}")
    # (the prober's own squad probes may add 128 waves meanwhile)
    check(same and forwards.get("squad/512") == 1
          and forwards.get("squad/128", 0) >= 1,
          "the squad probe's answer depends on the long request queued "
          f"before it: forwards {forwards}")
    return {"equal": same, "alone": alone, "behind_512": with_long,
            "forwards": forwards}


def phase_serve_slo(torch, np, summary, device="cuda",
                    cfg_path=os.path.join(HERE, "configs",
                                          "bert_large_uncased_config.json"),
                    clean=SLO_CLEAN, load=SLO_LOAD):
    """The SLO plane, the canary prober and the fault injector on the
    five-task server: seeded random checkpoints of `cfg_path`'s model
    (BERT-Large), buckets 128 and 512, bf16, the drill windows
    (SLO_DRILL), an evaluation every 0.25 s, a probe every 0.5 s, the
    injector dormant until `handle.injector.force()`. Legs: clean traffic
    (no alert, every task's probe healthy); corrupt_answers on squad (the
    prober flips squad alone, /healthz leaves ok, every request 200);
    error_burst (the availability page fires within a short window of the
    fault and resolves within one after it stops); latency_burst (the
    latency alert fires carrying trace ids that GET /v1/traces resolves).
    Then the serve log directory, and a second server under
    configs/slo.json: the fixed load (tools/serve_load.py) with the SLO
    plane and the prober on, then with both closed; p50 / p99 each,
    evaluate()'s host time a tick and the latency_p99 burn after the
    load. `device`, `cfg_path`, `clean` and `load` exist so the phase can
    be rehearsed on the CPU at a tiny size."""
    import shutil

    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import init_weights
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.tasks import registry

    on_card = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    short = SLO_DRILL["windows"]["page"]["short_s"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slo_")
    handle, res = None, {}
    summary["serve_slo"] = res
    path_launches = {}

    def add_launches():
        for k, v in LAUNCHES.items():
            path_launches[k] = path_launches.get(k, 0) + v

    try:
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        opts = dict(SERVE_OPTS, labels=list(CONLL_TAGS))
        argv = ["--model_config_file", cfg_path, "--vocab_file", vocab,
                "--port", "0", "--host", "127.0.0.1", "--device", device,
                "--buckets", SLO_BUCKETS, "--labels", *CONLL_TAGS]
        for task in registry.all_tasks():
            model = registry.get(task).build_serving_model(
                config, torch.bfloat16, opts, device)
            init_weights(model, torch.Generator(device=device).manual_seed(
                0), std=config.initializer_range)
            path = os.path.join(tmp, f"{task}.pt")
            torch.save(model.state_dict(), path)
            del model
            argv += ["--task_checkpoint", f"{task}={path}"]
        drill = os.path.join(tmp, "slo_drill.json")
        with open(drill, "w") as f:
            json.dump(SLO_DRILL, f)
        out_dir = os.path.join(tmp, "serve_out")
        t0 = time.perf_counter()
        handle = run_server.serve(run_server.parse_arguments(argv + [
            "--slo_config", drill, "--slo_eval_interval_s", "0.25",
            "--prober", "on", "--probe_interval_s", "0.5",
            "--slo_inject", "corrupt_answers", "--slo_inject_task", "squad",
            "--slo_inject_after_s", "1e9", "--slo_inject_latency_ms",
            str(SLO_INJECT_LATENCY_MS), "--output_dir", out_dir]),
            log=lambda m: log("serve_slo: " + m))
        res["start_s"] = time.perf_counter() - t0
        url, inj = handle.url, handle.injector
        check(handle.prober.wait_healthy(timeout=120),
              f"prober never healthy: {handle.prober.status()}")
        bodies = slo_bodies(np)

        # 1. clean: the main path, launch counts zeroed just before
        reset_launches()
        waves0 = dict(handle.engine.forward_counts)
        traffic = _Traffic(url, bodies, clean[0])
        time.sleep(clean[1])
        replies = traffic.stop()
        add_launches()
        view = _get_json(url, "/v1/alerts")
        st = handle.prober.status()
        codes = sorted({c for _, c, _ in replies})
        check(codes == [200], f"clean leg: status codes {codes}")
        check(view["firing"] == [] and view["resolved"] == []
              and view["status"] == "ok", f"clean leg alerts {view}")
        check(st["healthy"] and all(
            s["healthy"] and s["baseline_set"] and s["mismatches"] == 0
            for s in st["tasks"].values()), f"clean leg prober {st}")
        waves = {f"{t}/{b}": n - waves0.get((t, b), 0)
                 for (t, b), n in handle.engine.forward_counts.items()}
        check(all(waves.get(f"{t}/{b}", 0) > 0 for t in bodies
                  for b in (128, 512)),
              f"clean leg: every route rides both buckets: {waves}")
        lat = sorted(s for _, _, s in replies)
        res["clean"] = {
            "requests": len(replies), "rate": clean[0], "seconds": clean[1],
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "evaluations": view["evaluations"], "waves": waves,
            "probes": {t: s["probes"] for t, s in st["tasks"].items()}}
        log(f"serve_slo: clean leg: {res['clean']}; no alert, every probe "
            "healthy")

        # 2. corrupt_answers on squad: the prober alone sees it
        inj.set_mode("corrupt_answers")
        reset_launches()
        traffic = _Traffic(url, bodies, clean[0] / 2)
        inj.force(True)
        try:
            flip_s = _wait_for(lambda: handle.prober.status()[
                "unhealthy_tasks"] == ["squad"], 30, "squad unhealthy")
            _two_more_probe_rounds(handle)
            st = handle.prober.status()
            health = _get_json(url, "/healthz")
            firing = [a["slo"] for a in _firing(url)]
        finally:
            inj.force(False)
        replies = traffic.stop()
        add_launches()
        codes = sorted({c for _, c, _ in replies})
        check(st["unhealthy_tasks"] == ["squad"], f"corrupt leg: unhealthy "
              f"{st['unhealthy_tasks']}")
        check(health["status"] == "failing" and firing == ["probe_squad"],
              f"corrupt leg: /healthz {health['status']}, firing {firing}")
        check(codes == [200], f"corrupt leg: status codes {codes}")
        recover_s = _wait_for(lambda: handle.prober.status()["healthy"]
                              and not _firing(url), 30, "squad recovered")
        res["corrupt_answers"] = {
            "flip_s": flip_s, "recover_s": recover_s,
            "unhealthy": st["unhealthy_tasks"],
            "mismatches": {t: s["mismatches"]
                           for t, s in st["tasks"].items()},
            "healthz_status": health["status"], "firing": firing,
            "requests": len(replies), "codes": codes}
        log(f"serve_slo: corrupt_answers leg: {res['corrupt_answers']}")

        # 3. error_burst: the availability page fires and resolves
        inj.set_mode("error_burst")
        reset_launches()
        traffic = _Traffic(url, bodies, clean[0])
        inj.force(True)
        try:
            page_s = _wait_for(lambda: _firing(url, "availability", "page"),
                               short + 10, "the availability page")
        finally:
            inj.force(False)
        resolve_s = _wait_for(lambda: not _firing(url, "availability",
                                                  "page"), short + 10,
                              "the availability page resolved")
        replies = traffic.stop()
        add_launches()
        check(page_s <= short + SLO_SLACK_S and resolve_s <= short
              + SLO_SLACK_S, f"error_burst: paged after {page_s:.2f} s, "
              f"resolved {resolve_s:.2f} s after (short window {short} s)")
        _wait_for(lambda: handle.prober.status()["healthy"]
                  and not _firing(url), 60, "every alert resolved")
        res["error_burst"] = {
            "page_s": page_s, "resolve_s": resolve_s,
            "codes": {str(c): sum(1 for _, x, _ in replies if x == c)
                      for c in sorted({c for _, c, _ in replies})}}
        log(f"serve_slo: error_burst leg: {res['error_burst']}")

        # 4. latency_burst: the latency alert carries resolvable trace ids
        inj.set_mode("latency_burst")
        reset_launches()
        traffic = _Traffic(url, {"classify": bodies["classify"]}, 2.0)
        inj.force(True)
        try:
            fire_s = _wait_for(lambda: _firing(url, "latency_p99", "page"),
                               short + 20, "the latency alert")
            alert = _firing(url, "latency_p99", "page")[0]
        finally:
            inj.force(False)
        ids = alert.get("trace_ids") or []
        check(ids, f"latency alert without trace ids: {alert}")
        doc = _get_json(url, "/v1/traces?id=" + ",".join(ids))
        found = {e["args"]["trace_id"] for e in doc["traceEvents"]}
        check(set(ids) <= found, f"trace ids {ids} resolve to {found}")
        slowest = max((e["dur"] for e in doc["traceEvents"]
                       if e["name"] == "req/compute"), default=0.0) / 1e3
        resolve_s = _wait_for(lambda: not _firing(url, "latency_p99"),
                              60, "the latency alert resolved")
        replies = traffic.stop()
        add_launches()
        res["latency_burst"] = {
            "fire_s": fire_s, "resolve_s": resolve_s, "trace_ids": ids,
            "burn_short": alert.get("burn_short"),
            "slowest_compute_span_ms": slowest, "requests": len(replies)}
        log(f"serve_slo: latency_burst leg: {res['latency_burst']}")
        _wait_for(lambda: handle.prober.status()["healthy"]
                  and not _firing(url), 60, "every alert resolved")
        res["evaluate_tick_drill"] = _eval_tick_ms(handle.slo)
        res["bucket_drift"] = serve_slo_bucket_drift(np, handle)
        handle.close()
        handle = None
        res["serve_log"] = _serve_log(out_dir, on_card, kind)

        # the planes' cost under the fixed load, configs/slo.json
        handle = run_server.serve(run_server.parse_arguments(argv + [
            "--slo_config", os.path.join(HERE, "configs", "slo.json"),
            "--prober", "on"]), log=lambda m: log("serve_slo: load: " + m))
        check(handle.prober.wait_healthy(timeout=120),
              f"prober never healthy: {handle.prober.status()}")
        reset_launches()
        on = _load_run(handle.url, *load)
        add_launches()
        slo = _get_json(handle.url, "/v1/slo")
        lat = slo["slos"]["latency_p99"]
        st = handle.prober.status()
        tick = _eval_tick_ms(handle.slo)
        handle.prober.close()
        handle.evaluator.close()
        reset_launches()
        off = _load_run(handle.url, *load)
        add_launches()
        res["load"] = {
            "rate": load[0], "seconds": load[1],
            "planes_on": {k: on[k] for k in ("sent", "ok", "p50_ms",
                                             "p99_ms")},
            "planes_off": {k: off[k] for k in ("sent", "ok", "p50_ms",
                                               "p99_ms")},
            "evaluate_tick": tick, "latency_p99_after": {
                "burn": lat["burn"], "bad_frac": lat["bad_frac"],
                "events": lat["events"],
                "budget_remaining": lat["budget_remaining"]},
            "status_after": slo["status"],
            "prober_after": {t: {k: s[k] for k in ("probes", "mismatches",
                                                   "errors")}
                             for t, s in st["tasks"].items()}}
        log(f"serve_slo: fixed load {load[0]:g} req/s for {load[1]:g} s: "
            f"planes on p50 {on['p50_ms']:.2f} p99 {on['p99_ms']:.2f} ms, "
            f"off p50 {off['p50_ms']:.2f} p99 {off['p99_ms']:.2f} ms; "
            f"evaluate() {tick['median_ms']:.3f} ms a tick; latency_p99 "
            f"after the load {res['load']['latency_p99_after']}; status "
            f"{slo['status']}; prober {res['load']['prober_after']}")
        check(all(s["mismatches"] == 0 for s in st["tasks"].values()),
              "the prober reported a mismatch under the fixed load: "
              f"{res['load']['prober_after']}")
        summary.setdefault("launches", {})["serve_slo"] = path_launches
        check(not on_card or (path_launches["layer_norm_fwd"] > 0
                              and path_launches["flash_attention_fwd"] > 0),
              f"serve_slo launches {path_launches}")
    finally:
        if handle is not None:
            handle.close()
        shutil.rmtree(tmp, ignore_errors=True)


# finetune_packed: a task's (batch, seq, real tokens drawn from [lo, hi))
# for synthetic examples chosen for the check, not a corpus's lengths;
# choice's are each choice row's, 4 rows a unit, so a unit fits one
# packed row of 128
PACKED_TASKS = {"classify": (16, 128, (8, 65)), "choice": (16, 128, (8, 33)),
                "embed": (16, 128, (8, 65)), "ner": (32, 128, (8, 65)),
                "squad": (32, 384, (128, 385))}
PACKED_SEGMENTS = 8
# Packed against the same examples one to a row, dropout off, through the
# kernels (bf16): the loss's relative difference is held at
# PACKED_LOSS_LIMIT, and a planted fault (classify's labels shifted by one
# segment) must read at least 10x it; the gradients at the tasks' tiers.
# The loss is not exact on the card (on the CPU it is, for every task:
# tests/test_torch_finetune_packing.py): measured on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §6) 6.8e-6 (choice) to 8.5e-5 (classify)
# relative, the planted fault 6.8e-3; the limit leaves 2.35x over the
# largest reading, and the fault reads 34x it.
PACKED_LOSS_LIMIT = 2e-4


def choice_bias_noise(n: int) -> dict:
    """CHOICE_BIAS_NOISE's bound at n scores a microbatch: each score
    gradient rounded once to the compute dtype (unit roundoff u), the f32
    sums adding at most n 2^-24 of sum |g_i| <= 2."""
    return {"bfloat16": 2 * (2 ** -8 + n * 2 ** -24),
            "float32": 2 * (2 ** -24 + n * 2 ** -24)}


def packed_task_arrays(np, task: str, n: int, seq: int, lengths,
                       vocab: int, seed: int) -> dict:
    """`n` synthetic examples of `task` as its dataset's arrays: real
    tokens drawn from `lengths` (a row's, a choice row's for choice),
    token types 1 over the second half, the task's labels (SQuAD's
    span within the window)."""
    rng = np.random.RandomState(seed)
    group = TASK_CHOICES if task == "choice" else 1
    shape = (n, seq) if group == 1 else (n, group, seq)
    ids, types, mask = (np.zeros(shape, np.int32) for _ in range(3))
    lens = rng.randint(lengths[0], lengths[1], (n, group))
    for i in range(n):
        for c in range(group):
            ln = int(lens[i, c])
            at = (i,) if group == 1 else (i, c)
            ids[at][:ln] = rng.randint(5, vocab, ln)
            types[at][ln // 2:ln] = 1
            mask[at][:ln] = 1
    out = {"input_ids": ids, "token_type_ids": types, "attention_mask": mask}
    if task in ("classify", "embed"):
        out["labels"] = rng.randint(0, len(GLUE_LABELS), n).astype(np.int32)
    elif task == "choice":
        out["labels"] = rng.randint(0, group, n).astype(np.int32)
    elif task == "ner":
        del out["token_type_ids"]
        labels = np.full((n, seq), -100, np.int32)
        for i in range(n):
            ln = int(lens[i, 0])
            labels[i, 1:ln - 1] = rng.randint(1, len(CONLL_TAGS) + 1, ln - 2)
        out["labels"] = labels
    else:
        start = np.array([rng.randint(1, lens[i, 0] - 3) for i in range(n)],
                         np.int32)
        out["start_positions"] = start
        out["end_positions"] = (start + 2).astype(np.int32)
    return out


def _packed_task(task: str, config):
    """(make_model(dtype, plain), packed loss builder, pack_labels, group
    size, the leaves whose gradient is zero in exact arithmetic)."""
    from bert_pytorch_tpu_torch.models import bert
    from bert_pytorch_tpu_torch.tasks import (choice, classify, embed,
                                              ner_task, squad_task)

    g, last = PACKED_SEGMENTS, config.num_hidden_layers - 1
    return {
        "classify": (lambda dtype, plain: bert.BertForSequenceClassification(
            config, num_labels=len(GLUE_LABELS), max_segments=g, dtype=dtype,
            plain=plain), classify._loss_builder, classify.pack_labels, 1,
            ()),
        "choice": (lambda dtype, plain: bert.BertForMultipleChoice(
            config, max_segments=g, dtype=dtype, plain=plain),
            choice.make_loss_builder(TASK_CHOICES),
            choice.make_pack_labels(TASK_CHOICES), TASK_CHOICES,
            ("classifier.bias",)),
        "embed": (lambda dtype, plain: bert.BertForSentenceEmbedding(
            config, num_labels=len(GLUE_LABELS), max_segments=g,
            dtype=dtype, plain=plain), embed._loss_builder,
            embed.pack_labels, 1, ()),
        "ner": (lambda dtype, plain: bert.BertForTokenClassification(
            config, num_labels=len(CONLL_TAGS) + 1, dtype=dtype,
            plain=plain), ner_task._packed_loss_builder(g),
            ner_task.pack_labels, 1, ()),
        "squad": (lambda dtype, plain: bert.BertForQuestionAnswering(
            config, dtype=dtype, plain=plain),
            squad_task._packed_loss_builder(g), squad_task.pack_labels, 1,
            ("qa_outputs.bias",
             f"bert.encoder.layers.{last}.output_layer_norm.bias")),
    }[task]


def _pack_both_rows(arrays, n_rows: int, seq: int, pack_labels, group: int):
    """(packed batch, the same examples one to a row): every example that
    first-fits into one (n_rows, seq) batch, and those examples again in
    the packed batch's row-major order, one a row, with the same G."""
    from bert_pytorch_tpu_torch.training.finetune import pack_finetune_batch

    n = len(arrays["input_ids"])
    multi, placed = pack_finetune_batch(arrays, list(range(n)), n_rows, seq,
                                        PACKED_SEGMENTS, group_size=group)
    units = [p.unit for p in sorted(placed, key=lambda p: (p.row, p.seg0))]
    multi, placed = pack_finetune_batch(arrays, units, n_rows, seq,
                                        PACKED_SEGMENTS, group_size=group)
    check(len(placed) == len(units), "the packed batch lost examples")
    multi.update(pack_labels(arrays, placed, n_rows, seq, PACKED_SEGMENTS))
    single, sp = pack_finetune_batch(arrays, units, len(units), seq, group,
                                     group_size=group)
    single.update(pack_labels(arrays, sp, len(units), seq, PACKED_SEGMENTS))
    return multi, single


def _grad_worst(torch, got: dict, want: dict, skip) -> tuple:
    worst, name = 0.0, None
    for k, w in want.items():
        if k in skip:
            continue
        rel = (torch.linalg.vector_norm(got[k] - w)
               / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
        if rel > worst:
            worst, name = rel, k
    return worst, name


def phase_finetune_packed(torch, np, summary, device="cuda",
                          cfg_path=os.path.join(
                              HERE, "configs",
                              "bert_large_uncased_config.json"),
                          tasks=PACKED_TASKS, steps=FINETUNE_STEPS):
    """Packed finetuning of the five tasks at `cfg_path`'s width
    (BERT-Large, bf16), from a seeded random init, on synthetic examples
    (`packed_task_arrays`, lengths from PACKED_TASKS): per task, one
    packed batch against the same examples one to a row through the
    kernels, dropout off (loss at PACKED_LOSS_LIMIT, gradients at the
    task's tier; a planted fault, classify's labels shifted by one
    segment, must read 10x the limit); the packed microbatch, dropout on,
    through the kernels against the plain versions; for SQuAD the flash
    forward's and fused backward's launches a microbatch and the tiles
    their segment test skipped. Then `steps` steps of run_finetune --task
    classify and of run_squad, packed and not, on the same synthetic files
    (the main path: launch counts zeroed just before each run, read just
    after): examples/s, a step's host and device ms, packing_efficiency,
    real and slot tokens a step, peak memory. `device`, `cfg_path` and
    `tasks` exist so the phase can be rehearsed on the CPU at a tiny
    size."""
    import shutil

    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import init_weights
    from bert_pytorch_tpu_torch.ops.attention import counting_skips
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.tasks import registry
    from bert_pytorch_tpu_torch.training.finetune import (
        packed_train_batches, plain_train_batches, run_task, to_device)
    from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

    on_card = torch.device(device).type == "cuda"
    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    layers = config.num_hidden_layers
    res = {"tasks": {}}
    summary["finetune_packed"] = res
    pack_rows = {}
    for ti, (task, (batch, seq, lengths)) in enumerate(tasks.items()):
        what = f"finetune_packed {task}"
        make_model, builder, pack_labels, group, shift = _packed_task(
            task, config)
        arrays = packed_task_arrays(np, task, batch * PACKED_SEGMENTS, seq,
                                    lengths, config.vocab_size, 40 + ti)
        with torch.device(device):
            model = make_model(torch.bfloat16, False)
        init_weights(model, torch.Generator(device=device).manual_seed(ti),
                     std=config.initializer_range)
        weights = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
        n_sites = model.n_dropout_sites
        del model
        multi, single = _pack_both_rows(arrays, batch, seq, pack_labels,
                                        group)
        segs = int((multi["segment_ids"].max(axis=1)).sum())
        units = len(single["input_ids"])
        # packed against one to a row, dropout off, through the kernels
        lm, gm = _task_loss_and_grads(torch, make_model, builder,
                                      torch.bfloat16, False, weights,
                                      to_device(multi, device), None, device)
        ls, gs = _task_loss_and_grads(torch, make_model, builder,
                                      torch.bfloat16, False, weights,
                                      to_device(single, device), None, device)
        worst, worst_name = _grad_worst(torch, gm, gs, shift)
        del gm, gs
        tol = (POOLED_MODEL_TOL if task in ("classify", "choice", "embed")
               else FINETUNE_MODEL_TOL)["bfloat16"]
        row = {"batch": batch, "seq": seq, "units": units,
               "segments": segs, "packed_rows": batch, "single_rows": units,
               "packing_efficiency": float(
                   (multi["segment_ids"] > 0).mean()),
               "loss_packed": lm, "loss_single": ls,
               "loss_rel_diff": abs(lm - ls) / abs(ls),
               "max_grad_rel_l2": worst,
               "worst_leaf": worst_name, "grad_tol": tol["grad"]}
        log(f"{what}: {units} examples in {batch} packed rows of {seq} "
            f"({segs} segments, efficiency "
            f"{row['packing_efficiency']:.3f}) against {units} rows one "
            f"each, dropout off: loss {lm!r} vs {ls!r} (rel diff "
            f"{row['loss_rel_diff']:.3g}, limit {PACKED_LOSS_LIMIT:g}); worst "
            f"gradient rel L2 {worst:.3g} at {worst_name} (tol "
            f"{tol['grad']:g})")
        if task == "classify":
            bad = dict(multi, labels=np.roll(multi["labels"], 1, axis=1))
            lb, _ = _task_loss_and_grads(torch, make_model, builder,
                                         torch.bfloat16, False, weights,
                                         to_device(bad, device), None,
                                         device)
            row["planted_label_shift_loss_rel_diff"] = abs(lb - ls) / abs(ls)
            log(f"{what}: planted fault (labels shifted by one segment): "
                f"loss rel diff {abs(lb - ls) / abs(ls):.3g} (must be >= 10 "
                f"x {PACKED_LOSS_LIMIT:g})")
        pack_rows[task] = row
        res["tasks"][task] = row
        # the packed microbatch, dropout on: kernels against plain
        seeds = dropout_seeds(7, 1, 1, n_sites)
        row["kernels_vs_plain"] = _hold_microbatch(
            torch, np, what, make_model, builder, weights,
            {k: v[None] for k, v in multi.items()}, seeds[0], device,
            shift_invariant=shift,
            tols=(POOLED_MODEL_TOL if task in ("classify", "choice",
                                               "embed")
                  else FINETUNE_MODEL_TOL),
            noise_abs=(choice_bias_noise(batch * PACKED_SEGMENTS)
                       if task == "choice" else None))
        if task == "squad":
            # the flash kernels of one packed microbatch, dropout on
            reset_launches()
            with counting_skips(device) as skips:
                _task_loss_and_grads(torch, make_model, builder,
                                     torch.bfloat16, False, weights,
                                     to_device(multi, device), seeds[0],
                                     device)
                skipped = {k: int(v.item()) for k, v in skips.items()}
            launches = dict(LAUNCHES)
            row["microbatch_launches"] = {
                k: launches[k] for k in ("flash_attention_fwd",
                                         "flash_attention_bwd",
                                         "flash_attention_bwd_dq",
                                         "flash_attention_bwd_dkv")}
            row["tiles_skipped"] = skipped
            seg = multi["segment_ids"]
            row["tiles_skipped_predicted"] = {
                "flash_attention_fwd": expected_skips(
                    np, seg, 64, 128, config.num_attention_heads),
                "flash_attention_bwd": expected_skips(
                    np, seg, 64, 128, config.num_attention_heads)}
            log(f"{what}: one packed microbatch (dropout on): flash "
                f"launches {row['microbatch_launches']}; tiles skipped "
                f"{skipped} (layout predicts "
                f"{row['tiles_skipped_predicted']})")
        del weights
    # the checks, after every task's readings are in the log
    for task, row in pack_rows.items():
        check(row["loss_rel_diff"] <= PACKED_LOSS_LIMIT,
              f"finetune_packed {task}: packed loss {row['loss_packed']!r} "
              f"vs one a row {row['loss_single']!r}")
        check(row["max_grad_rel_l2"] <= row["grad_tol"],
              f"finetune_packed {task}: gradient {row['worst_leaf']} rel L2 "
              f"{row['max_grad_rel_l2']}")
    if "classify" in pack_rows:
        planted = pack_rows["classify"]["planted_label_shift_loss_rel_diff"]
        check(planted >= 10 * PACKED_LOSS_LIMIT,
              f"finetune_packed: the planted label shift reads {planted}")
    if "squad" in pack_rows and on_card:
        row = pack_rows["squad"]
        check(row["microbatch_launches"] == {
            "flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0},
            f"packed SQuAD microbatch launches {row['microbatch_launches']}")
        check(all(row["tiles_skipped"][k] == layers * n > 0 for k, n in
                  row["tiles_skipped_predicted"].items()),
              f"packed SQuAD tiles skipped {row['tiles_skipped']}, layout "
              f"predicts {row['tiles_skipped_predicted']} a layer")

    # the entry points: classify and SQuAD, packed against unpacked
    tmp = tempfile.mkdtemp(prefix="chip_smoke_packed_")
    try:
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        rng = np.random.RandomState(5)
        cls_train = os.path.join(tmp, "classify.tsv")
        with open(cls_train, "w") as f:
            for i in range(14 * tasks.get("classify", (16,))[0]):
                f.write(f"{GLUE_LABELS[i % 2]}\t"
                        f"{_context(rng, rng.randint(2, 31))}\t"
                        f"{_context(rng, rng.randint(3, 32))}\n")
        sq_batch, sq_seq = tasks.get("squad", (32, 384))[:2]
        sq_train = squad_file(np, os.path.join(tmp, "squad.json"),
                              6 * sq_batch, 6,
                              (sq_seq // 3 - 8, sq_seq - 14))
        runs = {}
        for task, packed in (("classify", False), ("classify", True),
                             ("squad", False), ("squad", True)):
            what = f"finetune_packed {task} run_task " + (
                "packed" if packed else "unpacked")
            out = os.path.join(tmp, f"{task}_{packed}")
            if task == "classify":
                argv = ["--train_file", cls_train, "--batch_size",
                        str(tasks["classify"][0]), "--max_seq_len",
                        str(tasks["classify"][1]), "--epochs", "1"]
            else:
                argv = ["--do_train", "--train_file", sq_train,
                        "--train_batch_size", str(sq_batch),
                        "--max_seq_length", str(sq_seq),
                        "--num_train_epochs", "1"]
            argv += ["--model_config_file", cfg_path, "--vocab_file", vocab,
                     "--output_dir", out, "--max_steps", str(steps),
                     "--seed", "0", "--device", device]
            argv += ["--packing"] if packed else []
            args = registry.get(task).parse_arguments(argv)
            trace = {}
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            results = run_task(registry.get(task), args,
                               log=lambda m, w=what: log(f"{w}: {m}"),
                               trace=trace)
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                    if on_card else None)
            by_path = summary.setdefault("launches", {})
            prev = by_path.get("finetune_packed", {})
            by_path["finetune_packed"] = {
                k: prev.get(k, 0) + v for k, v in launches.items()}
            history, run, state = (trace["history"], trace["run"],
                                   trace["state"])
            check(len(history) == steps and all(
                np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                for h in history), f"{what}: history {history}")
            per_step = {"layer_norm_fwd": 1, "layer_norm_bwd": 1,
                        "add_dropout_layer_norm_fwd": 2 * layers,
                        "add_dropout_layer_norm_bwd": 2 * layers}
            if task == "squad":
                per_step.update(flash_attention_fwd=layers,
                                flash_attention_bwd=layers)
            want = dict({k: 0 for k in LAUNCHES},
                        **{k: n * steps for k, n in per_step.items()})
            check(not on_card or launches == want,
                  f"{what}: launch counts {launches}, want {want}")
            shutil.rmtree(out)
            # the run's step again, on its state, timed and profiled
            if packed:
                batch_np, _, n_ex = next(packed_train_batches(
                    run.train_arrays, run.batch_size, run.seq_len,
                    PACKED_SEGMENTS, run.pack_labels, True, 1,
                    run.group_size))
            else:
                batch_np, _, n_ex = next(plain_train_batches(
                    run.train_arrays, run.batch_size, 1, True, 1,
                    run.label_ignore))
            seeds = dropout_seeds(7, 1, 1, run.model.n_dropout_sites)
            nums = _finetune_step_numbers(
                torch, run, state, to_device(batch_np, device), seeds,
                on_card, what, packed=packed)
            if "profiled_step" in nums:
                prof = nums.pop("profiled_step")
                nums.update(device_ms=prof["device_total_ms"],
                            idle_share=prof["idle_share"],
                            device_ms_by_class=prof["device_ms"])
            row = {"steps": len(history), "run_task_s": wall,
                   "examples": [h["examples"] for h in history],
                   "real_tokens": [h["real_tokens"] for h in history],
                   "slot_tokens": [h["slot_tokens"] for h in history],
                   "packing_efficiency": sum(
                       h["real_tokens"] for h in history) / sum(
                       h["slot_tokens"] for h in history),
                   "examples_per_s_run": results[
                       "training_sequences_per_second"],
                   "peak_memory_gib": peak, "launches": launches,
                   "losses": [h["loss"] for h in history], **nums}
            if "step_ms" in nums:
                row["examples_per_s_step"] = n_ex / nums["step_ms"] * 1e3
            runs[f"{task}_{'packed' if packed else 'unpacked'}"] = row
            log(f"{what}: {row['steps']} steps, examples a step "
                f"{row['examples']}, real / slot tokens "
                f"{row['real_tokens']} / {row['slot_tokens']} (efficiency "
                f"{row['packing_efficiency']:.3f}), "
                f"{row['examples_per_s_run']:.1f} examples/s over the run "
                f"({wall:.1f} s of run_task), peak memory {peak} GiB, "
                f"launches {launches}")
            del run, state, trace, history
        res["runs"] = runs
        for task in ("classify", "squad"):
            p, u = runs[f"{task}_packed"], runs[f"{task}_unpacked"]
            check(sum(p["examples"]) > sum(u["examples"])
                  and p["packing_efficiency"] > u["packing_efficiency"],
                  f"{task}: packed steps took {p['examples']} examples at "
                  f"efficiency {p['packing_efficiency']}, unpacked "
                  f"{u['examples']} at {u['packing_efficiency']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Distillation on the card (distill): BERT-Large teachers into
# student_6l_768. The kernels against the plain versions on one
# distillation microbatch are held at the pooled heads' tiers
# (POOLED_MODEL_TOL: the loss is a mix of per-example KD and CE terms and
# per-token tap terms) and must tell a planted fault (the student's head
# dropout seed off by one) apart; packed against one a row at
# PACKED_LOSS_LIMIT, a planted fault (positions not reset at each packed
# segment) at 10x it.
DISTILL_STUDENT = "student_6l_768"
DISTILL_STEPS = 3
DISTILL_SQUAD = (32, 384)
# the summary keys of the JAX package's run_distill.py (its `shared` and
# its own), beside the results of the task's finalize
DISTILL_SUMMARY_KEYS = (
    "kind", "task", "student", "teacher_checkpoint", "temperature",
    "alpha_kd", "alpha_ce", "alpha_hidden", "alpha_attn", "inject",
    "train_losses", "loss_first", "loss_last", "student_config",
    "student_layers", "student_hidden", "teacher_layers", "teacher_hidden",
    "layer_map", "projections")


def _distill_loss_and_grads(torch, makes, weights, proj, builder_kw, dtype,
                            plain, micro, seeds, device):
    """One distillation microbatch's loss and f32 gradients (the student's
    and the projections') through fresh student and teacher models
    (`makes`: (make_student, make_teacher), each (dtype, plain) -> model)
    holding `weights`: the kernels (plain=False) or the plain versions."""
    from bert_pytorch_tpu_torch.training.distill import (
        make_distill_loss_builder)
    from bert_pytorch_tpu_torch.training.pretrain import (compute_params,
                                                          loss_and_grads)

    with torch.device(device):
        student, teacher = (make(dtype, plain) for make in makes)
    student.load_state_dict(weights[0])
    teacher.load_state_dict(weights[1])
    teacher.requires_grad_(False).eval()
    params = dict(student.named_parameters())
    params.update(proj)
    gparams = compute_params(params, None)
    loss, _, grads = loss_and_grads(
        make_distill_loss_builder(teacher_model=teacher, **builder_kw)(
            student), gparams, micro, seeds)
    return loss.item(), {k: g.float() for k, g in grads.items()}


def _distill_kernels_vs_plain(torch, np, what, makes, weights, proj,
                              builder_kw, batch_np, seeds, device):
    """One distillation microbatch (packed, dropout on) through the kernels
    against the plain versions: bf16 (the whole microbatch) and f32 (a
    quarter of its rows) at POOLED_MODEL_TOL, the loss relative and every
    gradient leaf (the student's and the projections') by relative L2;
    and the kernels again with the student's head dropout seed off by
    one, which must read beyond the tolerance."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        rows = len(batch_np["input_ids"])
        rows = rows if dtype == torch.bfloat16 else max(1, rows // 4)
        micro = {k: torch.from_numpy(v[:rows]).to(device)
                 for k, v in batch_np.items()}
        got = _distill_loss_and_grads(torch, makes, weights, proj,
                                      builder_kw, dtype, False, micro, seeds,
                                      device)
        want = _distill_loss_and_grads(torch, makes, weights, proj,
                                       builder_kw, dtype, True, micro,
                                       seeds, device)
        planted = seeds.clone()
        planted[-1] += 1
        bad = _distill_loss_and_grads(torch, makes, weights, proj,
                                      builder_kw, dtype, False, micro,
                                      planted, device)
        tol = POOLED_MODEL_TOL[name]
        loss_rel = abs(got[0] - want[0]) / abs(want[0])
        worst, worst_name = _grad_worst(torch, got[1], want[1], ())
        proj_worst, _ = _grad_worst(
            torch, {k: v for k, v in got[1].items() if k in proj},
            {k: v for k, v in want[1].items() if k in proj}, ())
        bad_rel = abs(bad[0] - want[0]) / abs(want[0])
        bad_worst, _ = _grad_worst(torch, bad[1], want[1], ())
        log(f"{what}: one distillation microbatch ({rows} rows) {name}, "
            f"kernels vs plain: loss {got[0]:.6f} vs {want[0]:.6f} (rel "
            f"{loss_rel:.3g}, tol {tol['loss']:g}); worst gradient rel L2 "
            f"{worst:.3g} at {worst_name} (tol {tol['grad']:g}), the "
            f"projections' worst {proj_worst:.3g}; planted fault (head "
            f"dropout seed + 1): loss {bad_rel:.3g}, gradient "
            f"{bad_worst:.3g}")
        out[name] = {"rows": rows, "loss": got[0], "plain_loss": want[0],
                     "loss_rel": loss_rel, "max_grad_rel_l2": worst,
                     "worst_leaf": worst_name,
                     "projections_max_grad_rel_l2": proj_worst,
                     "planted_head_seed_loss_rel": bad_rel,
                     "planted_head_seed_max_grad_rel_l2": bad_worst}
        check(np.isfinite(got[0]) and loss_rel <= tol["loss"]
              and worst <= tol["grad"],
              f"{what} {name}: loss rel {loss_rel}, gradient {worst_name} "
              f"rel L2 {worst} (tol {tol})")
        check(bad_rel > tol["loss"] or bad_worst > tol["grad"],
              f"{what} {name}: the planted head seed fault reads loss "
              f"{bad_rel}, gradient {bad_worst}: inside {tol}")
        del got, want, bad
    return out


def phase_distill(torch, np, summary, device="cuda",
                  cfg_path=os.path.join(HERE, "configs",
                                        "bert_large_uncased_config.json"),
                  student=DISTILL_STUDENT, batch=TASK_TRAIN[0],
                  seq=TASK_TRAIN[1], squad=DISTILL_SQUAD,
                  steps=DISTILL_STEPS):
    """Distillation through the entry point (run_distill.main) on one card:
    `cfg_path`'s model (BERT-Large) as the teacher, `student`
    (student_6l_768: 6 layers, width 768, 12 heads) as the student.

    1. teachers: `steps` steps of run_finetune --task classify (`batch` x
       `seq`, --perf_artifact: the FINETUNE json's mfu in (0, 1) on the
       card's peak) and one of run_squad (`squad`), into checkpoints;
    2. classify distillation, packed, both tap losses (projections 768 ->
       1024 on every mapped layer): exact launch counts of the run (the
       teacher's forward only: no backward of its own), the summary's
       keys (JAX's), `projections` the six mapped layers, the teacher's
       parameters bit-unchanged and without .grad;
    3. one distillation microbatch through the kernels against the plain
       versions (loss, the student's and the projections' gradients);
    4. with no tap loss, student gradients from precomputed teacher logits
       bit-equal to the in-step teacher's;
    5. a packed batch against the same examples one a row (loss at
       PACKED_LOSS_LIMIT; a planted fault, positions not reset at each
       segment, at 10x it);
    6. SQuAD distillation at `squad`, unpacked: exact flash launches (24
       teacher forwards, 6 student forwards, 6 fused backwards a step);
    7. the student served by run_server with its own model_config.json:
       /healthz counts fewer parameters than the teacher's, one answer
       equals the student's eager forward; the student's checkpoint under
       the teacher's config raises the depth-mismatch message;
       --inject broken_student's accuracy_delta beside the clean run's;
    8. a distillation step's time split (teacher forward, student forward
       and backward, Adam; device time and host clock) beside a plain
       finetune step of the same student.

    `device`, `cfg_path`, `student`, `batch`, `seq`, `squad` exist so the
    phase can be rehearsed on the CPU at a tiny size."""
    import dataclasses
    import shutil

    from bert_pytorch_tpu_torch import run_distill, run_server
    from bert_pytorch_tpu_torch.config import (BertConfig, pad_vocab_size,
                                               student_config)
    from bert_pytorch_tpu_torch.data import glue
    from bert_pytorch_tpu_torch.data.packing import first_fit
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.models.bert import (
        BertForSequenceClassification)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.serving.batcher import (InferenceRequest,
                                                        Scheduler,
                                                        pack_requests)
    from bert_pytorch_tpu_torch.tasks import classify, predict, registry
    from bert_pytorch_tpu_torch.training import distill
    from bert_pytorch_tpu_torch.training.checkpoint import (
        load_params, strict_load_state)
    from bert_pytorch_tpu_torch.training.finetune import (
        eval_buckets, packed_train_batches, run_task, to_device)
    from bert_pytorch_tpu_torch.training.pretrain import (
        compute_params, dropout_seeds, loss_and_grads)
    from bert_pytorch_tpu_torch.training.state import make_train_state

    on_card = torch.device(device).type == "cuda"
    t_cfg = BertConfig.from_json_file(cfg_path)
    t_cfg = t_cfg.replace(vocab_size=pad_vocab_size(t_cfg.vocab_size, 8))
    s_cfg = student_config(student, t_cfg)
    lt, ls = t_cfg.num_hidden_layers, s_cfg.num_hidden_layers
    res = {"student": student, "teacher_layers": lt, "student_layers": ls,
           "student_hidden": s_cfg.hidden_size,
           "student_heads": s_cfg.num_attention_heads}
    summary["distill"] = res
    by_path = summary.setdefault("launches", {})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_distill_")
    try:
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        tokenizer = get_wordpiece_tokenizer(vocab)
        files = {split: glue_file(np, os.path.join(
            tmp, f"classify_{split}.tsv"), "classify", n, seed)
            for split, n, seed in (("train", 4 * steps * batch, 20),
                                   ("val", batch, 21), ("test", batch, 22))}
        common = ["--model_config_file", cfg_path, "--vocab_file", vocab,
                  "--seed", "0", "--device", device]
        cls_argv = ["--train_file", files["train"], "--val_file",
                    files["val"], "--test_file", files["test"],
                    "--batch_size", str(batch), "--max_seq_len", str(seq),
                    "--epochs", "1", "--max_steps", str(steps)] + common

        # 1. the teachers, through the finetune entry point
        t_out = os.path.join(tmp, "teacher_classify")
        artifact = os.path.join(tmp, "FINETUNE_distill.json")
        t0 = time.perf_counter()
        t_res = run_task(registry.get("classify"),
                         registry.get("classify").parse_arguments(
                             cls_argv + ["--output_dir", t_out,
                                         "--perf_artifact", artifact]),
                         log=lambda m: log(f"distill teacher: {m}"))
        with open(artifact) as f:
            perf = json.load(f)["tasks"]["classify"]
        log(f"distill: classify teacher {steps} steps in "
            f"{time.perf_counter() - t0:.1f} s, test accuracy "
            f"{t_res.get('test_accuracy')}; FINETUNE json {perf}")
        check(set(perf) >= {"real_tokens_per_sec", "pad_fraction",
                            "packing_efficiency", "seq_per_sec",
                            "step_time_ms", "mfu", "packing", "steps"},
              f"distill: FINETUNE json keys {sorted(perf)}")
        check(not on_card or 0.0 < perf["mfu"] < 1.0,
              f"distill: the FINETUNE json's mfu {perf['mfu']} on the card")
        res["teacher_perf_artifact"] = perf
        sq_batch, sq_seq = squad
        sq_train = squad_file(np, os.path.join(tmp, "squad.json"),
                              2 * sq_batch, 23,
                              (sq_seq // 3 - 8, sq_seq - 14))
        sq_out = os.path.join(tmp, "teacher_squad")
        sq_common = ["--do_train", "--train_file", sq_train,
                     "--train_batch_size", str(sq_batch),
                     "--max_seq_length", str(sq_seq)] + common
        run_task(registry.get("squad"), registry.get("squad").parse_arguments(
            sq_common + ["--output_dir", sq_out, "--max_steps", "1"]),
            log=lambda m: log(f"distill squad teacher: {m}"))
        t_ckpt = os.path.join(t_out, "ckpt")
        t_state = load_params(t_ckpt, log=lambda m: None)[0]
        t_weights = {k: v.clone() for k, v in t_state.items()}
        del t_state

        # 2. classify distillation, packed, both tap losses
        s_out = os.path.join(tmp, "student_classify")
        d_argv = ["--task", "classify", "--student", student,
                  "--teacher_checkpoint", t_ckpt, "--packing",
                  "--alpha_hidden", "1.0", "--alpha_attn", "1.0",
                  "--output_dir", s_out] + cls_argv
        arrays = {s: glue.PairClassificationDataset(
            files[s], tokenizer, GLUE_LABELS, seq).arrays()
            for s in ("val", "test")}
        n_val, n_test = (sum(_eval_batches_by_bucket(
            arrays[s], batch, eval_buckets(seq)).values())
            for s in ("val", "test"))
        trace = {}
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        d_sum = run_distill.main(d_argv, log=lambda m: log(f"distill: {m}"),
                                 trace=trace)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if on_card else None)
        by_path["distill"] = launches
        history, run, state = trace["history"], trace["run"], trace["state"]
        teacher = trace["teacher"]
        # a step: the student's embedding LayerNorm and 2L residual tails
        # forward and backward, the teacher's 2Lt + 1 LayerNorms forward
        # only (deterministic: the plain LayerNorm kernel at every site);
        # eval: the student's val and test batches, the teacher's test
        per_step = {"layer_norm_fwd": 1 + 2 * lt + 1, "layer_norm_bwd": 1,
                    "add_dropout_layer_norm_fwd": 2 * ls,
                    "add_dropout_layer_norm_bwd": 2 * ls}
        want = dict({k: 0 for k in LAUNCHES},
                    **{k: n * len(history) for k, n in per_step.items()})
        want["layer_norm_fwd"] += ((2 * ls + 1) * (n_val + n_test)
                                   + (2 * lt + 1) * n_test)
        projections = [f"layer_{i}" for i in range(ls)]
        changed = [k for k, v in teacher.state_dict().items()
                   if not torch.equal(v.cpu(), t_weights[k])]
        grads = [k for k, p in teacher.named_parameters()
                 if p.grad is not None]
        losses_ = [h["loss"] for h in history]
        log(f"distill: classify {len(history)} packed steps of {batch} x "
            f"{seq}: losses {losses_}; run_distill {wall:.1f} s, peak "
            f"memory {peak} GiB; launches {launches} (predicted {want}); "
            f"summary {json.dumps(d_sum)}")
        res["classify"] = {
            "steps": len(history), "losses": losses_, "wall_s": wall,
            "peak_memory_gib": peak, "launches": launches,
            "launches_predicted": want, "launches_per_step": per_step,
            "summary": d_sum, "teacher_params_changed": changed,
            "teacher_grads": grads,
            "packing_efficiency": [h["packing_efficiency"]
                                   for h in history]}
        check(len(history) == steps and all(np.isfinite(losses_)),
              f"distill: {len(history)} steps, losses {losses_}")
        check(not on_card or launches == want,
              f"distill: launch counts {launches}, want {want}")
        check(set(DISTILL_SUMMARY_KEYS) <= set(d_sum)
              and {"test_accuracy", "teacher_test_accuracy",
                   "accuracy_delta", "teacher_checkpoint_step"} <= set(d_sum),
              f"distill: summary keys {sorted(d_sum)}")
        check(d_sum["projections"] == projections
              and d_sum["layer_map"] == [list(p) for p in
                                         distill.default_layer_map(ls, lt)],
              f"distill: projections {d_sum['projections']}, layer map "
              f"{d_sum['layer_map']}")
        check(not changed and not grads, f"distill: the teacher's "
              f"parameters changed {changed[:4]} or hold a gradient "
              f"{grads[:4]}")
        with open(os.path.join(s_out, "model_config.json")) as f:
            check(json.load(f)["debug_taps"] is False,
                  "distill: the student's model_config.json has debug_taps")

        # 3. one distillation microbatch: kernels against plain
        batch_np, _, _ = next(packed_train_batches(
            run.train_arrays, batch, seq, PACKED_SEGMENTS, run.pack_labels,
            True, 1, run.group_size))
        batch_np = {k: v[0] for k, v in batch_np.items()}
        seeds = dropout_seeds(7, 1, 1, run.model.n_dropout_sites)[0]
        proj = {k: v.detach().clone() for k, v in state.params.items()
                if k.startswith(distill.PROJ_PREFIX)}
        s_weights = {k: v.detach().clone()
                     for k, v in run.model.state_dict().items()}
        dcfg = distill.DistillConfig(
            alpha_hidden=1.0, alpha_attn=1.0,
            layer_map=distill.default_layer_map(ls, lt),
            max_segments=PACKED_SEGMENTS)
        kw = dict(dcfg=dcfg, output_kind="segment", packed=True,
                  label_ignore={"labels": -1})

        def make(cfg):
            return lambda dtype, plain: BertForSequenceClassification(
                cfg, num_labels=len(GLUE_LABELS),
                max_segments=PACKED_SEGMENTS, dtype=dtype, plain=plain)

        makes = (make(s_cfg), make(t_cfg))
        weights = (s_weights, t_weights)
        res["kernels_vs_plain"] = _distill_kernels_vs_plain(
            torch, np, "distill", makes, weights, proj, kw, batch_np, seeds,
            device)

        # 4. precomputed teacher logits, no tap loss: the same gradients
        no_taps = dict(kw, dcfg=dataclasses.replace(
            dcfg, alpha_hidden=0.0, alpha_attn=0.0))
        micro = to_device(batch_np, device)
        in_step = _distill_loss_and_grads(
            torch, makes, weights, {}, no_taps, torch.bfloat16, False,
            micro, seeds, device)
        with torch.device(device):
            t_model = makes[1](torch.bfloat16, False)
        t_model.load_state_dict(t_weights)
        with torch.no_grad():
            t_logits = t_model(
                micro["input_ids"], token_type_ids=micro["token_type_ids"],
                attention_mask=micro["attention_mask"],
                position_ids=micro["position_ids"],
                segment_ids=micro["segment_ids"])
        del t_model
        pre = _distill_loss_and_grads(
            torch, makes, weights, {}, no_taps, torch.bfloat16, False,
            dict(micro, teacher_logits=t_logits), seeds, device)
        bit_equal = (in_step[0] == pre[0] and all(
            torch.equal(in_step[1][k], pre[1][k]) for k in in_step[1]))
        log(f"distill: no tap loss, precomputed teacher logits against the "
            f"in-step teacher: loss {pre[0]!r} vs {in_step[0]!r}, student "
            f"gradients bit-equal: {bit_equal}")
        check(bit_equal, "distill: gradients from precomputed teacher "
              "logits differ from the in-step teacher's")
        res["precomputed_teacher_bit_equal"] = bit_equal
        del in_step, pre

        # 5. packed against the same examples one a row, dropout off: the
        # loss at PACKED_LOSS_LIMIT, the gradients at the pooled tier. The
        # tap terms dominate the loss and move little with any one
        # example, so the planted fault (positions not reset at each
        # packed segment: every example after a row's first sees shifted
        # positions) must read 10x the loss limit or beyond the gradient
        # tier
        units = packed_task_arrays(np, "classify", batch * PACKED_SEGMENTS,
                                   seq, PACKED_TASKS["classify"][2],
                                   t_cfg.vocab_size, 24)
        multi, single = _pack_both_rows(units, batch, seq,
                                        classify.pack_labels, 1)
        bad = dict(multi, position_ids=np.ascontiguousarray(np.broadcast_to(
            np.arange(seq, dtype=np.int32), multi["position_ids"].shape)))
        lm, lsg, lb = (_distill_loss_and_grads(
            torch, makes, weights, proj, kw, torch.bfloat16, False,
            to_device(b, device), None, device) for b in (multi, single,
                                                          bad))
        rel = abs(lm[0] - lsg[0]) / abs(lsg[0])
        bad_rel = abs(lb[0] - lsg[0]) / abs(lsg[0])
        worst, worst_name = _grad_worst(torch, lm[1], lsg[1], ())
        bad_worst, _ = _grad_worst(torch, lb[1], lsg[1], ())
        grad_tol = POOLED_MODEL_TOL["bfloat16"]["grad"]
        log(f"distill: packed ({len(single['input_ids'])} examples in "
            f"{batch} rows) against one a row, dropout off: loss {lm[0]!r} "
            f"vs {lsg[0]!r} (rel {rel:.3g}, limit {PACKED_LOSS_LIMIT:g}); "
            f"worst gradient rel L2 {worst:.3g} at {worst_name} (tol "
            f"{grad_tol:g}); planted fault (positions not reset at each "
            f"segment): loss {bad_rel:.3g}, gradient {bad_worst:.3g}")
        res["packed_vs_single"] = {
            "loss_packed": lm[0], "loss_single": lsg[0],
            "loss_rel_diff": rel, "max_grad_rel_l2": worst,
            "worst_leaf": worst_name, "planted_loss_rel_diff": bad_rel,
            "planted_max_grad_rel_l2": bad_worst}
        del lm, lsg, lb
        check(rel <= PACKED_LOSS_LIMIT and worst <= grad_tol,
              f"distill: packed against one a row: loss rel {rel}, "
              f"gradient {worst_name} rel L2 {worst}")
        check(bad_rel >= 10 * PACKED_LOSS_LIMIT or bad_worst > grad_tol,
              f"distill: the planted position fault reads loss {bad_rel}, "
              f"gradient {bad_worst}")

        # 8. a distillation step's time, split, beside a plain finetune
        # step of the same student
        step_batch = {k: v[None] for k, v in micro.items()}
        step_seeds = dropout_seeds(7, 1, 1, run.model.n_dropout_sites)
        nums = _finetune_step_numbers(torch, run, state, step_batch,
                                      step_seeds, on_card, "distill",
                                      packed=True)
        plain_run = dataclasses.replace(
            run, packed_loss_builder=classify._loss_builder)
        plain_state = make_train_state(run.model, run.tx)
        plain_nums = _finetune_step_numbers(torch, plain_run, plain_state,
                                            step_batch, step_seeds,
                                            on_card,
                                            "distill: the student's plain "
                                            "finetune step", packed=True)
        if on_card:
            from bert_pytorch_tpu_torch.optim.lamb import global_norm_f32

            gparams = compute_params(state.params, None)
            loss_fn = run.packed_loss_builder(run.model)
            t_kwargs = distill._head_kwargs(micro, True, None)
            grads = loss_and_grads(loss_fn, gparams, micro, seeds)[2]
            norm = global_norm_f32(list(grads.values()))
            # Adam updates a copy of the parameters, its moments and the
            # gradients (the clip scales them in place): the run's state
            # takes no update from the timing
            a_params = {k: v.detach().clone()
                        for k, v in state.params.items()}
            a_opt = run.tx.init(a_params)
            a_grads = {k: v.clone() for k, v in grads.items()}

            def teacher_fwd():
                with torch.no_grad():
                    teacher(micro["input_ids"], return_taps=True, **t_kwargs)

            parts = {
                "teacher_forward": teacher_fwd,
                "loss_and_grads": lambda: loss_and_grads(loss_fn, gparams,
                                                         micro, seeds),
                "adam": lambda: run.tx.update(a_grads, a_opt, a_params,
                                              grad_norm=norm)}
            split = {k: _device_call_ms(torch, fn)
                     for k, fn in parts.items()}
            # the difference of two calls timed apart
            split["student_forward_backward"] = {
                k: split["loss_and_grads"][k] - split["teacher_forward"][k]
                for k in ("host_ms", "device_ms")}
            nums["split"] = split
            log(f"distill: a step's split (host clock median of 3 between "
                f"synchronizations; device time by CUDA events around one "
                f"call, median of 3, or where the host could not be hidden "
                f"the profiler's kernel sum; student_forward_backward is "
                f"loss_and_grads less teacher_forward): {split}; "
                f"the step {nums['step_ms']:.1f} ms host clock, device "
                f"{nums['profiled_step']['device_total_ms']:.1f} ms; the "
                f"student's plain finetune step {plain_nums['step_ms']:.1f} "
                f"ms host clock, device "
                f"{plain_nums['profiled_step']['device_total_ms']:.1f} ms")
            del gparams, grads, a_params, a_opt, a_grads
        res["step"] = nums
        res["plain_student_step"] = plain_nums
        del plain_state, plain_run

        # 7. the student served with its own config
        handle = run_server.serve(run_server.parse_arguments([
            "--model_config_file", os.path.join(s_out, "model_config.json"),
            "--vocab_file", vocab, "--task_checkpoint",
            f"classify={os.path.join(s_out, 'ckpt')}", "--port", "0",
            "--host", "127.0.0.1", "--device", device]),
            log=lambda m: log(f"distill: serve: {m}"))
        try:
            health = _get_json(handle.url, "/healthz")
            body = TASK_BODIES["classify"]
            code, reply = _post(handle.url, body, route="classify")
            engine = handle.engine
        finally:
            handle.close()
        _check_reply(np, "classify", body, code, reply, s_cfg.hidden_size)
        served = health["tasks"]["classify"]["model_params"]
        t_params = sum(int(v.numel()) for v in t_weights.values())
        ids, types = predict.encode_pair(tokenizer, body["text"],
                                         body["text_pair"],
                                         engine.max_bucket)
        req = InferenceRequest("classify", np.asarray(ids, np.int32),
                               np.asarray(types, np.int32))
        bucket = engine.select_bucket(req.length)
        eb, places = pack_requests([req], first_fit(
            [req.length], BATCH_ROWS, bucket, engine.max_segments),
            BATCH_ROWS, bucket)
        with torch.device(device):
            eager = make(s_cfg)(torch.bfloat16, False)
        s_state = run_server.load_task_params(os.path.join(s_out, "ckpt"),
                                              log=lambda m: None)
        strict_load_state(eager, s_state)
        with torch.inference_mode():
            out = predict.build_classify_forward(eager.eval())(
                to_device(eb, device)).float().cpu().numpy()
        _, row, offset, seg = places[0]
        want_reply = predict.classify_decode(
            Scheduler._demux(out, row, offset, req.length, seg, "segment"),
            SERVE_OPTS["class_names"])
        diff = max(abs(reply["scores"][k] - v)
                   for k, v in want_reply["scores"].items())
        log(f"distill: the student served ({served} parameters, the "
            f"teacher {t_params}): {code} {reply}; its eager forward "
            f"{want_reply} (max score diff {diff:.3g})")
        check(served < t_params, f"distill: served {served} parameters, "
              f"teacher {t_params}")
        check(reply["label"] == want_reply["label"] and diff <= 1e-5,
              f"distill: the served answer {reply} is not the eager "
              f"forward's {want_reply}")
        with torch.device("meta"):
            wrong = make(t_cfg)(torch.bfloat16, False)
        try:
            strict_load_state(wrong, s_state)
            mismatch = None
        except ValueError as e:
            mismatch = str(e)
        log(f"distill: the student's checkpoint under the teacher's "
            f"config: {mismatch[:200] if mismatch else 'NO ERROR'}")
        check(mismatch is not None
              and f"expects {lt} encoder layer(s)" in mismatch
              and f"carries {ls}" in mismatch and "--student" in mismatch
              and "model_config.json" in mismatch,
              f"distill: depth mismatch message {mismatch!r}")
        res["serve"] = {"code": code, "reply": reply, "eager": want_reply,
                        "max_score_diff": diff, "served_params": served,
                        "teacher_params": t_params,
                        "depth_mismatch": mismatch[:300]}
        del eager, wrong, s_state, run, state, trace, history, teacher

        # --inject broken_student on the same data and teacher
        broken = run_distill.main(
            d_argv[:d_argv.index("--output_dir")]
            + ["--output_dir", os.path.join(tmp, "student_broken"),
               "--inject", "broken_student"]
            + d_argv[d_argv.index("--output_dir") + 2:],
            log=lambda m: log(f"distill broken: {m}"))
        separated = broken["accuracy_delta"] > d_sum["accuracy_delta"]
        log(f"distill: accuracy_delta clean {d_sum['accuracy_delta']}, "
            f"--inject broken_student {broken['accuracy_delta']}: "
            + ("separated" if separated else
               "the synthetic data does not separate them (the CPU test "
               "tests/test_torch_distill.py carries the contrast)"))
        res["broken_student"] = {"accuracy_delta": broken["accuracy_delta"],
                                 "clean_accuracy_delta":
                                     d_sum["accuracy_delta"],
                                 "separated": separated}
        shutil.rmtree(os.path.join(tmp, "student_broken"))
        shutil.rmtree(t_out)

        # 6. SQuAD distillation at seq 384, unpacked
        sq_s_out = os.path.join(tmp, "student_squad")
        trace = {}
        reset_launches()
        t0 = time.perf_counter()
        sq_sum = run_distill.main(
            ["--task", "squad", "--student", student, "--teacher_checkpoint",
             os.path.join(sq_out, "ckpt"), "--alpha_hidden", "1.0",
             "--output_dir", sq_s_out, "--max_steps", str(steps)]
            + sq_common, log=lambda m: log(f"distill squad: {m}"),
            trace=trace)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        by_path["distill_squad"] = launches
        n = len(trace["history"])
        per_step = {"layer_norm_fwd": 1 + 2 * lt + 1, "layer_norm_bwd": 1,
                    "add_dropout_layer_norm_fwd": 2 * ls,
                    "add_dropout_layer_norm_bwd": 2 * ls,
                    "flash_attention_fwd": lt + ls,
                    "flash_attention_bwd": ls}
        want = dict({k: 0 for k in LAUNCHES},
                    **{k: c * n for k, c in per_step.items()})
        sq_losses = [h["loss"] for h in trace["history"]]
        log(f"distill squad: {n} steps of {sq_batch} x {sq_seq}: losses "
            f"{sq_losses}; run_distill {wall:.1f} s; launches {launches} "
            f"(predicted {want})")
        check(n == steps and all(np.isfinite(sq_losses)),
              f"distill squad: {n} steps, losses {sq_losses}")
        check(not on_card or launches == want,
              f"distill squad: launch counts {launches}, want {want}")
        res["squad"] = {"steps": n, "losses": sq_losses, "wall_s": wall,
                        "launches": launches, "launches_predicted": want,
                        "launches_per_step": per_step,
                        "projections": sq_sum["projections"]}
        del trace
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


KERNEL_ROWS = {
    "layer_norm_fwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/layernorm.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/layernorm.py:93"},
    "layer_norm_bwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/layernorm.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/layernorm.py:129"},
    "add_dropout_layer_norm_fwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/layernorm.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/layernorm.py:270"},
    "add_dropout_layer_norm_bwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/layernorm.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/layernorm.py:311"},
    # the bf16 forward (the main paths'); the f32 forward, which the
    # kernels phase checks, stays in flash_attention.cu
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/flash_attention.py:660",
        # the bh-layout forward (#6) is the same kernel: strided reads
        "also_replaces": ["bert_pytorch_tpu/ops/pallas/flash_attention.py:698"]},
    # the fused backward (#7/#8): the main path's, bf16 at seq <= 512
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/flash_attention.py:754",
        # the bh-layout fused backward (#8) is the same kernel: strided reads
        "also_replaces": ["bert_pytorch_tpu/ops/pallas/flash_attention.py:799"]},
    # the split pair (#9/#10), bf16: seq > 512, off the phases' paths;
    # launched by the seq-1024 model check (model_seq1024) and the kernels
    # phase's checks (the f32 pair stays in flash_attention.cu)
    "flash_attention_bwd_dq": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/"
                  "flash_attention_split_bwd.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/flash_attention.py:840"},
    "flash_attention_bwd_dkv": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/"
                  "flash_attention_split_bwd.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/flash_attention.py:871"},
    "lamb_stage1": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/fused_optim.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/fused_optim.py:130"},
    "lamb_stage2": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/fused_optim.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/fused_optim.py:150"},
}
# the numbers of one measurement that the kernels line carries, and those
# only some rows have (the fused backward at rate 0, the pair beside it)
_LINE_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "shape", "rate")
_EXTRA_KEYS = ("rate0_ms", "rate0_plain_ms", "pair_ms", "row_ms",
               "column_ms", "pair_by_shape", "max_abs_err_by_rows")
# the backward pair's other measurements: the longer sequences and f32
_PAIR_VARIANTS = ("seq1024", "seq2048", "float32")


# -- --init_checkpoint from other sources ------------------------------------

SOURCES_STEPS = 2
SOURCES_WATCHDOG_S = 2.0        # above any phase of a warm SQuAD step
SOURCES_STALL_S = 4.0           # the spin queued behind each step, at least
H100_MAX_CLOCK_HZ = 1.98e9      # the SM clock the spin counts, at most


def spinning_steps(torch, build_pretrain_step, secs: float):
    """`build_pretrain_step` whose steps each queue a spin kernel of at
    least `secs` seconds behind their own kernels, as a wedged card would
    hold them: the loop's next wait for the card stalls (the next batch's
    copy from pageable memory, or the loss's readback). The numbers are
    the real step's."""
    cycles = int(secs * H100_MAX_CLOCK_HZ)

    def build(*a, **kw):
        step_fn = build_pretrain_step(*a, **kw)

        def step(*args):
            metrics = step_fn(*args)
            torch.cuda._sleep(cycles)
            return metrics
        return step
    return build


def reference_state_dict(sd: dict, vocab: int) -> dict:
    """The port's BertForPreTraining state_dict in the reference's naming
    (src/modeling.py, what its ckpt_*.pt holds under 'model'): the fused
    QKV split into query / key / value, LayerNorm scale/bias as
    weight/bias, the vocab rows cut to the release's `vocab`, and the
    tied decoder weight stored beside the embedding as the reference
    stores it. Linear weights keep their (out, in) layout."""
    tail = {"attention.output.weight": "attention.output.dense.weight",
            "attention.output.bias": "attention.output.dense.bias",
            "attention_layer_norm.scale": "attention.output.LayerNorm.weight",
            "attention_layer_norm.bias": "attention.output.LayerNorm.bias",
            "intermediate.weight": "intermediate.dense.weight",
            "intermediate.bias": "intermediate.dense.bias",
            "mlp_output.weight": "output.dense.weight",
            "mlp_output.bias": "output.dense.bias",
            "output_layer_norm.scale": "output.LayerNorm.weight",
            "output_layer_norm.bias": "output.LayerNorm.bias"}
    heads = {"bert.embeddings.layer_norm.scale":
             "bert.embeddings.LayerNorm.weight",
             "bert.embeddings.layer_norm.bias":
             "bert.embeddings.LayerNorm.bias",
             "cls_predictions.transform.weight":
             "cls.predictions.transform.dense.weight",
             "cls_predictions.transform.bias":
             "cls.predictions.transform.dense.bias",
             "cls_predictions.layer_norm.scale":
             "cls.predictions.transform.LayerNorm.weight",
             "cls_predictions.layer_norm.bias":
             "cls.predictions.transform.LayerNorm.bias",
             "cls_seq_relationship.weight": "cls.seq_relationship.weight",
             "cls_seq_relationship.bias": "cls.seq_relationship.bias"}
    out = {}
    for k, v in sd.items():
        if k.startswith("bert.encoder.layers."):
            i, rest = k[len("bert.encoder.layers."):].split(".", 1)
            p = f"bert.encoder.layer.{i}."
            if rest.startswith("attention.qkv."):
                leaf = rest.rsplit(".", 1)[1]
                for n, part in zip(("query", "key", "value"),
                                   v.chunk(3, dim=0)):
                    out[f"{p}attention.self.{n}.{leaf}"] = part
            else:
                out[p + tail[rest]] = v
        elif k == "bert.embeddings.word_embeddings.weight":
            out[k] = v[:vocab]
            out["cls.predictions.decoder.weight"] = v[:vocab]
        elif k == "cls_predictions.bias":
            out["cls.predictions.bias"] = v[:vocab]
        else:
            out[heads.get(k, k)] = v
    return out


def _missing_package_error(spec: str, pkg: str, load) -> dict:
    """`load(spec)` where `pkg` cannot be imported: it must raise an
    ImportError naming `pkg` (no fresh-initialised fallback). Where the
    package is installed, the case is recorded and not run."""
    import importlib

    try:
        importlib.import_module(pkg)
        return {"package": pkg, "installed": True}
    except ImportError:
        pass
    try:
        load(spec)
    except ImportError as e:
        check(pkg in str(e), f"{spec}: ImportError {e} does not name {pkg}")
        return {"package": pkg, "installed": False, "error": str(e)}
    raise PhaseError(f"{spec}: read without {pkg} installed")


def phase_init_sources(torch, np, summary, device="cuda",
                       cfg_path=os.path.join(
                           HERE, "configs",
                           "bert_large_uncased_config.json"),
                       batch=SQUAD_ATTN[0]):
    """--init_checkpoint from another source, at `cfg_path`'s width
    (BERT-Large): random weights from a seed written as the reference's
    `ckpt_1.pt` ({'model': state_dict} in src/modeling.py naming, each
    name `module.`-prefixed, the release's 30522 vocab rows; the padded
    rows are zero in the source) and as a port checkpoint. A fresh QA
    model seeded from the .pt must hold every bert.* parameter bit-equal
    to the source, with the report naming the QA head alone fresh; then
    run_squad (run_task) trains SOURCES_STEPS steps of `batch` x 384 from
    the .pt (exact launch counts) and one step from the port checkpoint,
    and the two first losses must be bit-equal. A TF release and a JAX
    orbax directory must raise the ImportError naming tensorflow /
    tensorstore where those are not installed (the chip machine has
    neither). `device`, `cfg_path` and `batch` exist so the phase can be
    rehearsed on the CPU at a tiny size."""
    import shutil

    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    BertForQuestionAnswering,
                                                    init_weights)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.tasks import registry
    from bert_pytorch_tpu_torch.tasks.squad_task import parse_arguments
    from bert_pytorch_tpu_torch.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu_torch.training import finetune
    from bert_pytorch_tpu_torch.training.finetune import (
        load_pretrained_params, run_task)

    on_card = torch.device(device).type == "cuda"
    seq = SQUAD_ATTN[1]
    config = BertConfig.from_json_file(cfg_path)
    vocab = config.vocab_size
    config = config.replace(vocab_size=pad_vocab_size(vocab, 8))
    layers = config.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sources_")
    res = {}
    summary["init_sources"] = res
    try:
        with torch.device(device):
            src = BertForPreTraining(config.replace(next_sentence=True),
                                     dtype=torch.float32)
        init_weights(src, torch.Generator(device=device).manual_seed(3),
                     std=config.initializer_range)
        sd = {k: v.detach() for k, v in src.state_dict().items()}
        with torch.no_grad():
            sd["bert.embeddings.word_embeddings.weight"][vocab:] = 0
        t0 = time.perf_counter()
        ref_dir = os.path.join(tmp, "reference")
        os.makedirs(ref_dir)
        pt = os.path.join(ref_dir, "ckpt_1.pt")
        torch.save({"model": {f"module.{k}": v.cpu() for k, v in
                              reference_state_dict(sd, vocab).items()},
                    "optimizer": {}, "epoch": 1}, pt)
        shutil.copy(cfg_path, os.path.join(ref_dir, "bert_config.json"))
        res["write_pt_s"] = time.perf_counter() - t0
        res["pt_bytes"] = os.path.getsize(pt)
        t0 = time.perf_counter()
        port_dir = os.path.join(tmp, "port")
        CheckpointManager(port_dir).save(1, {"step": 1, "params": sd})
        res["write_port_s"] = time.perf_counter() - t0
        del src

        # the conversion: a fresh QA model from the .pt, bit for bit
        with torch.device(device):
            qa = BertForQuestionAnswering(config, dtype=torch.float32)
        params = {k: p.detach() for k, p in qa.named_parameters()}
        lines = []
        t0 = time.perf_counter()
        load_pretrained_params(pt, params, log=lines.append)
        res["load_s"] = time.perf_counter() - t0
        bert = [k for k in params if k.startswith("bert.")]
        differ = [k for k in bert if not torch.equal(params[k], sd[k])]
        check(len(bert) == len(params) - 2 and not differ,
              f"parameters not bit-equal to the source: {differ[:5]}")
        want_lines = [
            f"init_checkpoint step torch-ckpt: loaded {len(bert)} param "
            "leaves, 2 fresh-initialized",
            "WARNING: fresh-initialized (not found in checkpoint or shape "
            "mismatch): qa_outputs.bias, qa_outputs.weight"]
        check(lines == want_lines, f"report {lines}, want {want_lines}")
        res["bit_equal_params"] = len(bert)
        del qa, params, sd
        log(f"init_sources: {len(bert)} bert.* parameters from {pt} "
            f"({res['pt_bytes'] / 1e9:.3f} GB written in "
            f"{res['write_pt_s']:.1f} s) bit-equal to the source; read in "
            f"{res['load_s']:.1f} s; the report names the QA head alone")

        # run_squad from the .pt and from the port checkpoint
        vocab_file = serve_vocab(os.path.join(tmp, "vocab.txt"))
        train = squad_file(np, os.path.join(tmp, "train.json"),
                           (SOURCES_STEPS + 1) * batch, 0, (60, 330))

        def squad(init, steps, name, extra=(), lines=None):
            args = parse_arguments([
                "--do_train", "--train_file", train, "--model_config_file",
                cfg_path, "--vocab_file", vocab_file, "--output_dir",
                os.path.join(tmp, name), "--init_checkpoint", init,
                "--max_seq_length", str(seq), "--train_batch_size",
                str(batch), "--max_steps", str(steps), "--seed", "0",
                "--device", device, *extra])
            trace = {}
            reset_launches()

            def out(m):
                log(f"init_sources: {name}: {m}")
                if lines is not None:
                    lines.append(m)
            t0 = time.perf_counter()
            run_task(registry.get("squad"), args, log=out, trace=trace)
            wall = time.perf_counter() - t0
            return trace["history"], dict(LAUNCHES), wall

        hist, launches, wall = squad(pt, SOURCES_STEPS, "from_pt")
        summary.setdefault("launches", {})["init_sources"] = launches
        want = {"layer_norm_fwd": SOURCES_STEPS,
                "layer_norm_bwd": SOURCES_STEPS,
                "add_dropout_layer_norm_fwd": 2 * layers * SOURCES_STEPS,
                "add_dropout_layer_norm_bwd": 2 * layers * SOURCES_STEPS,
                "flash_attention_fwd": layers * SOURCES_STEPS,
                "flash_attention_bwd": layers * SOURCES_STEPS,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "lamb_stage1": 0, "lamb_stage2": 0}
        if on_card:
            check(launches == want, f"launch counts {launches}, want {want}")
        losses = [h["loss"] for h in hist]
        check(len(hist) == SOURCES_STEPS and all(np.isfinite(losses)),
              f"run_squad from the .pt: losses {losses}")
        # from the port checkpoint; on the card with the watchdog armed
        # and a spin behind each step, so that it trips in the second
        # batch's copy and in the last step's readback
        lines = []
        drill = (["--watchdog_timeout", str(SOURCES_WATCHDOG_S),
                  "--watchdog_action", "warn"] if on_card else [])
        real_build = finetune.build_pretrain_step
        if on_card:
            finetune.build_pretrain_step = spinning_steps(
                torch, real_build, SOURCES_STALL_S)
        try:
            hist_port, _, wall_port = squad(
                f"{port_dir}@1", SOURCES_STEPS if on_card else 1,
                "from_port", extra=drill, lines=lines)
        finally:
            finetune.build_pretrain_step = real_build
        check(hist_port[0]["loss"] == losses[0],
              f"first loss from the .pt {losses[0]!r} != from the port "
              f"checkpoint {hist_port[0]['loss']!r}")
        res.update(squad_steps=SOURCES_STEPS, batch=batch, seq=seq,
                   losses=losses, first_loss_from_port=hist_port[0]["loss"],
                   run_task_s=wall, run_task_port_s=wall_port,
                   launches=launches, launches_predicted=want)
        if on_card:
            trips = [ln for ln in lines if ln.startswith("WATCHDOG:")]
            phases = [ln.split("'")[1] for ln in trips]
            stacks = [f for f in os.listdir(os.path.join(tmp, "from_port"))
                      if f.startswith("watchdog_stacks_")
                      and f.endswith("_device_hang.txt")]
            check(phases == ["h2d", "metric_flush"] and len(stacks) >= 1
                  and all("device_hang" in ln for ln in trips),
                  f"finetune watchdog: trips {trips}, stacks {stacks}")
            res["finetune_watchdog"] = {
                "timeout_s": SOURCES_WATCHDOG_S,
                "spin_s_at_least": SOURCES_STALL_S, "phases": phases,
                "ages_s": [float(ln.split("stalled for ")[1].split("s")[0])
                           for ln in trips]}
        log(f"init_sources: run_squad from the .pt: losses {losses} "
            f"({wall:.1f} s), first loss bit-equal to the port "
            f"checkpoint's ({wall_port:.1f} s); launches {launches}; "
            f"finetune watchdog {res.get('finetune_watchdog')}")

        # a TF release and an orbax directory without their packages
        release = os.path.join(tmp, "release")
        os.makedirs(release)
        shutil.copy(cfg_path, os.path.join(release, "bert_config.json"))
        open(os.path.join(release, "bert_model.ckpt.index"), "w").close()
        orbax = os.path.join(tmp, "orbax", "1", "state")
        os.makedirs(orbax)
        with open(os.path.join(orbax, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": {}, "use_zarr3": False}, f)
        small = {"bert.embeddings.word_embeddings.weight":
                 torch.zeros(8, 4)}

        def load(spec):
            load_pretrained_params(spec, small, log=lambda m: None)

        res["missing_packages"] = [
            _missing_package_error(release, "tensorflow", load),
            _missing_package_error(os.path.dirname(os.path.dirname(orbax)),
                                   "tensorstore", load)]
        log(f"init_sources: without their packages: "
            f"{res['missing_packages']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- pretraining's streaming data plane -----------------------------------------

STREAM_STEPS = 3
OFFLINE_STEPS = 4               # the offline plane's alternated runs
STREAM_MICRO = 96               # phase 1's microbatch, accumulation 2
STREAM_DRILL_MICRO = 32         # the drills' and BPE's
STREAM_DOCS = 1500              # documents of 8-300 words: ~2500 examples
STREAM_BPE_MERGES = 400


def stream_corpus(np, directory: str, n_docs: int, seed: int = 0) -> str:
    """Two .txt files of blank-line-separated documents of `_WORDS`
    (each 8-300 words, a line of 12 words ending in " ."), from `seed`."""
    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    for f in range(2):
        docs = [_context(rng, int(rng.randint(8, 301))).replace(" . ",
                                                                " .\n")
                for _ in range(n_docs // 2)]
        with open(os.path.join(directory, f"part_{f}.txt"), "w") as fh:
            fh.write("\n\n".join(docs) + "\n")
    return directory


def _trace_streams(path: str) -> dict:
    """A torch.profiler chrome trace of the card: the host-to-device
    copies' bytes by stream, the kernels' streams, and the device's idle
    share over
    the run's last two steps (from the end of the first step's last
    kernel, fused LAMB's second stage, to the end of the last one's): 1 -
    the union of kernel and copy intervals over that window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, copies = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "kernel":
            kernels.append(ev)
        elif cat == "gpu_memcpy" and "HtoD" in ev.get("name", ""):
            copies.append(ev)
    ends = sorted(ev["ts"] + ev["dur"] for ev in kernels
                  if "lamb_stage2" in ev["name"])
    htod = {}
    for ev in copies:
        stream = str(ev["args"].get("stream"))
        htod[stream] = htod.get(stream, 0) + int(ev["args"].get("bytes", 0))
    out = {"htod_bytes_by_stream": htod,
           "kernel_streams": sorted({str(ev["args"].get("stream"))
                                     for ev in kernels}),
           "steps_seen": len(ends), "idle_share": None}
    if len(ends) >= 3:
        lo, hi = ends[-3], ends[-1]
        spans = sorted((max(lo, ev["ts"]), min(hi, ev["ts"] + ev["dur"]))
                       for ev in kernels + copies
                       if ev["ts"] < hi and ev["ts"] + ev["dur"] > lo)
        busy, cur = 0.0, lo
        for a, b in spans:
            a = max(a, cur)
            if b > a:
                busy += b - a
                cur = b
        out.update(window_ms=(hi - lo) / 1e3, busy_ms=busy / 1e3,
                   idle_share=1.0 - busy / (hi - lo))
    return out


def _stream_args(run_pretraining, cfg_path, corpus, vocab, out, device,
                 micro, steps, *extra):
    return run_pretraining.parse_arguments([
        "--config_file", PHASE1_CONFIG, "--model_config_file", cfg_path,
        "--stream_dir", corpus, "--stream_vocab", vocab,
        "--stream_seq_len", "128", "--output_dir", out,
        "--local_batch_size", str(micro),
        "--global_batch_size", str(2 * micro), "--steps", str(steps),
        "--fused_optim", "auto", "--vocab_pad_multiple", "8",
        "--seed", "0", "--log_freq", "1", "--device", device, *extra])


def _stream_train(torch, run_pretraining, args, trace=None):
    """run_pretraining.train(args) over the stream, with the batches the
    steps read (its `batch_tap`) and, given `trace`, a torch.profiler
    trace of the card written there. Returns (result, batches, perf
    records); `result.metrics` is the run's registry snapshot."""
    batches = []

    def tap(b):
        batches.append({k: v.copy() for k, v in b.items()})

    def run():
        return run_pretraining.train(args, None,
                                     log=lambda m: log(f"stream: {m}"),
                                     batch_tap=tap)

    if trace is None:
        result = run()
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result = run()
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
    return result, batches, _perf_records(args)


def _perf_records(args) -> list:
    with open(os.path.join(args.output_dir, args.log_prefix
                           + ".jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == "perf"]


def _host_stream(args, vocab_size: int, n: int, workers: int = 1,
                 **kw) -> tuple:
    """The first `n` batches of the run's stream from its loader alone on
    the host (`workers` tokenize threads, no assembly prefetch), and the
    tokens/s it tokenized at."""
    from bert_pytorch_tpu_torch.data.streaming import (
        StreamingPretrainingLoader, discover_sources, resolve_mask_id)
    from bert_pytorch_tpu_torch.data.tokenization import TOKENIZERS
    from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry

    tok = TOKENIZERS[args.stream_tokenizer](args.stream_vocab)
    reg = MetricsRegistry()
    loader = StreamingPretrainingLoader(
        discover_sources(args.stream_dir), tok,
        batch_size=2 * args.local_batch_size, seq_len=args.stream_seq_len,
        mask_token_index=resolve_mask_id(tok),
        max_pred_per_seq=args.max_predictions_per_seq,
        masked_lm_prob=args.masked_token_fraction, vocab_size=vocab_size,
        seed=args.seed, num_workers=workers, prefetch_batches=0,
        packing=args.packing, packing_max_segments=args.packing_max_segments,
        packing_lookahead=args.packing_lookahead, registry=reg, **kw)
    t0 = time.perf_counter()
    try:
        out = [next(loader) for _ in range(n)]
    finally:
        loader.close()
    secs = time.perf_counter() - t0
    tokens = reg.counter("bert_stream_tokens_total").value()
    return out, {"tokens": tokens, "seconds": secs,
                 "tokens_per_s": tokens / secs}, reg


def _same_batches(np, a, b) -> bool:
    return len(a) == len(b) and all(
        set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def _series(metrics: dict, name: str) -> list:
    """[(labels, value)] of `name` in a registry snapshot."""
    snap = metrics.get(name, {"series": []})
    return [(s["labels"], s["value"]) for s in snap["series"]]


def phase_stream(torch, np, summary, device="cuda",
                 cfg_path=os.path.join(HERE, "configs",
                                       "bert_large_uncased_config.json"),
                 cut_cfg_path=None, micro=STREAM_MICRO, docs=STREAM_DOCS,
                 bpe_merges=STREAM_BPE_MERGES):
    """Pretraining's streaming data plane (--stream_dir) through the entry
    point's trainer, phase 1 (`micro` x 128, accumulation 2), over a
    synthetic corpus of `docs` documents (`stream_corpus`) with
    serve_vocab's WordPiece vocabulary, tokenized by the native encoder
    (the factory's) unless said otherwise:

    1. the main path at `cfg_path` (the script passes BERT-Large's width
       at STREAM_LAYERS), STREAM_STEPS
       steps at --h2d_prefetch 1, packing off: exact launch counts
       (zeroed just before, read just after); the batches the steps read
       (the prefetcher's batch_tap) bit-equal to the loader's alone on the
       host (1 worker, no prefetch); data_wait's share of the step, the
       pool's tokens/s, the queue depth, the device's idle share;
    2. the same steps at --h2d_prefetch 0: losses and grad norms
       bit-equal; a torch.profiler trace of the card shows depth 1's
       host-to-device copies on a stream of their own; h2d ms, the host
       clock of a step and the idle share, both ways; the same steps at
       depth 1 on the pure-Python WordPiece (swapped in for the factory
       in this process: the pool's threads tokenize): losses, grad norms
       and batches equal to the native leg's, exact launch counts; then
       the offline plane (in-memory shards) for OFFLINE_STEPS steps at the
       defaults (--h2d_prefetch 1, --tensorboard on) and at the parent's
       behaviour (0, off), in the order on, off, off, on: losses
       bit-equal, the host phases, the step time and the idle share of
       each; the native, pure-Python and offline planes side by side (a
       warm step's host clock, its dispatch, the idle share, the pool's
       tokens/s, data_wait's share);
    3. at `cut_cfg_path` (CUT_LAYERS) and a microbatch of at most
       STREAM_DRILL_MICRO (as leg 4), packed: --stream_inject
       worker_crash bit-equal to the uninjected run (losses and batches);
       corrupt_record drops and counts records
       (bert_stream_records_dropped_total), its batches those of the same
       injected loader on the host;
    4. --stream_tokenizer bpe over a byte-level vocabulary learned from
       the corpus (`bpe_files`): 2 steps, the mask id <mask>'s;
    5. the TensorBoard sink (--tensorboard on, the default): whether the
       machine has the tensorboard package; with it, the event file holds
       the steps' scalars, without it the log says the sink is off.

    `device`, the configs, `micro` and `docs` exist so the phase can be
    rehearsed on the CPU at a tiny size."""
    import importlib.util
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data import tokenization
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    on_card = torch.device(device).type == "cuda"
    cut_cfg_path = cut_cfg_path or cfg_path
    python_made = []

    def python_wordpiece(vocab_file, uppercase=False):
        # the pure-Python encoder in the factory's place
        tok = tokenization.BertWordPieceTokenizer(vocab_file,
                                                  lowercase=not uppercase)
        python_made.append(type(tok).__name__)
        return tok

    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    marks, mark = _marks()
    res = {"seconds": marks}
    summary["stream"] = res
    try:
        corpus = stream_corpus(np, os.path.join(tmp, "corpus"), docs)
        vocab = serve_vocab(os.path.join(tmp, "vocab.txt"))
        config = BertConfig.from_json_file(cfg_path)
        layers = config.num_hidden_layers
        vocab_size = pad_vocab_size(config.vocab_size, 8)
        mark("corpus")

        # 1-2. the main path at depth 1, then depth 0, then depth 1 on
        # the pure-Python encoder
        runs = {}
        native_factory = tokenization.TOKENIZERS["wordpiece"]
        for key, depth in ((1, 1), (0, 0), ("python", 1)):
            out = os.path.join(tmp, f"d{key}")
            args = _stream_args(run_pretraining, cfg_path, corpus, vocab,
                                out, device, micro, STREAM_STEPS,
                                "--skip_checkpoint", "--h2d_prefetch",
                                str(depth))
            trace = os.path.join(tmp, f"trace{key}.json") if on_card \
                else None
            if key == "python":
                tokenization.TOKENIZERS["wordpiece"] = python_wordpiece
            reset_launches()
            t0 = time.perf_counter()
            try:
                result, batches, perf = _stream_train(
                    torch, run_pretraining, args, trace)
            finally:
                tokenization.TOKENIZERS["wordpiece"] = native_factory
            tel = result.metrics
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            h = result.history
            warm = perf[1:] or perf
            step_ms = sum(p["step_time_ms"] for p in warm)
            row = {
                "losses": [r["loss"] for r in h],
                "grad_norms": [r["grad_norm"] for r in h],
                "launches": launches, "run_s": wall,
                "step_time_ms": [p["step_time_ms"] for p in perf],
                "data_wait_ms": [p.get("data_wait_ms") for p in perf],
                "h2d_ms": [p.get("h2d_ms") for p in perf],
                "dispatch_ms": [p.get("dispatch_ms") for p in perf],
                "metric_flush_ms": [p.get("metric_flush_ms") for p in perf],
                "data_wait_share": sum(p.get("data_wait_ms", 0.0)
                                       for p in warm) / step_ms,
                "h2d_share": sum(p.get("h2d_ms", 0.0)
                                 for p in warm) / step_ms,
                "stream_tokens": _series(tel, "bert_stream_tokens_total"),
                "worker_tokens_per_sec": _series(
                    tel, "bert_stream_worker_tokens_per_sec"),
                "queue_depth": _series(tel, "bert_stream_queue_depth"),
                "examples": _series(tel, "bert_stream_examples_total")}
            if trace is not None:
                row["trace"] = _trace_streams(trace)
                os.remove(trace)
            runs[key] = (row, batches)
            res["python_encoder" if key == "python"
                else f"h2d_prefetch_{depth}"] = row
            check(len(h) == STREAM_STEPS
                  and all(np.isfinite(row["losses"])),
                  f"stream leg {key}: {len(h)} steps, losses "
                  f"{row['losses']}")
            log(f"stream: {'pure-Python' if key == 'python' else 'native'}"
                f" WordPiece, --h2d_prefetch {depth}, {layers} layers, "
                f"{STREAM_STEPS} steps of 2 x {micro} x 128: losses "
                f"{row['losses']}, step ms {row['step_time_ms']}, data_wait "
                f"ms {row['data_wait_ms']} (share {row['data_wait_share']:.3f}"
                f"), h2d ms {row['h2d_ms']}, launches {launches}, trace "
                f"{row.get('trace')}, pool {row['worker_tokens_per_sec']}, "
                f"queue {row['queue_depth']}")
            del result
            mark(f"leg_{key}")
        want = _pretrain_step_launches(layers, STREAM_STEPS, False, False)
        row1, batches1 = runs[1]
        row0, batches0 = runs[0]
        rowp, batchesp = runs["python"]
        check(python_made and row1["losses"] == rowp["losses"]
              and row1["grad_norms"] == rowp["grad_norms"]
              and _same_batches(np, batches1, batchesp),
              f"stream: the pure-Python encoder's leg ({python_made}) "
              f"losses {rowp['losses']} grad norms {rowp['grad_norms']} "
              f"against the native leg's {row1['losses']} "
              f"{row1['grad_norms']}")
        summary.setdefault("launches", {})["stream"] = row1["launches"]
        res["launches_predicted"] = want
        if on_card:
            check(row1["launches"] == want, f"stream: launch counts "
                  f"{row1['launches']}, want {want}")
            check(row0["launches"] == want, f"stream depth 0: launch "
                  f"counts {row0['launches']}, want {want}")
            check(rowp["launches"] == want, f"stream, pure-Python "
                  f"encoder: launch counts {rowp['launches']}, want "
                  f"{want}")
            # the batches' bytes (the steps' and the one staged past the
            # last) crossed on a stream that runs no kernel at depth 1
            t1 = row1["trace"]
            side = sum(b for st, b in t1["htod_bytes_by_stream"].items()
                       if st not in t1["kernel_streams"])
            step_bytes = sum(v.nbytes for v in batches1[0].values())
            res["side_stream_htod_bytes"] = side
            check(side >= STREAM_STEPS * step_bytes,
                  f"stream: depth 1 copied {side} bytes off the kernels' "
                  f"streams {t1['kernel_streams']} ({t1}); the batches "
                  f"hold {STREAM_STEPS} x {step_bytes}")
            check(row0["trace"]["htod_bytes_by_stream"].keys()
                  <= set(row0["trace"]["kernel_streams"]),
                  f"stream: depth 0 copied on a side stream: "
                  f"{row0['trace']}")
        check(row1["losses"] == row0["losses"]
              and row1["grad_norms"] == row0["grad_norms"],
              f"stream: depth 1 losses {row1['losses']} grad norms "
              f"{row1['grad_norms']} against depth 0's {row0['losses']} "
              f"{row0['grad_norms']}")
        # the offline plane (in-memory shards, no tokenize pool) at this
        # PR's defaults (--h2d_prefetch 1, --tensorboard on) and at the
        # parent's behaviour (--h2d_prefetch 0, --tensorboard off), in
        # alternated pairs (on, off, off, on): OFFLINE_STEPS steps each,
        # the host phases, the step time and the idle share from a trace
        index = array_index([pretraining_arrays(
            np, (OFFLINE_STEPS + 2) * micro, 128, vocab_size, seed)
            for seed in (0, 1)])
        offline = {"on": [], "off": []}
        for i, mode in enumerate(("on", "off", "off", "on")):
            out = os.path.join(tmp, f"offline{i}")
            args = run_pretraining.parse_arguments([
                "--config_file", PHASE1_CONFIG,
                "--model_config_file", cfg_path, "--output_dir", out,
                "--local_batch_size", str(micro),
                "--global_batch_size", str(2 * micro),
                "--steps", str(OFFLINE_STEPS), "--fused_optim", "auto",
                "--skip_checkpoint", "--vocab_pad_multiple", "8",
                "--seed", "0", "--log_freq", "1", "--device", device,
                "--h2d_prefetch", "1" if mode == "on" else "0",
                "--tensorboard", mode])
            trace = os.path.join(tmp, f"trace_offline{i}.json") \
                if on_card else None
            if on_card:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    result = run_pretraining.train(args, index,
                                                   log=lambda m: None)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(trace)
            else:
                result = run_pretraining.train(args, index,
                                               log=lambda m: None)
            perf = _perf_records(args)
            row = {k + "_ms": [p.get(k + "_ms") for p in perf]
                   for k in ("step_time", "data_wait", "h2d", "dispatch",
                             "metric_flush")}
            row["losses"] = [r["loss"] for r in result.history]
            if trace is not None:
                row["trace"] = _trace_streams(trace)
                os.remove(trace)
            offline[mode].append(row)
            del result
        rows = offline["on"] + offline["off"]
        check(all(r["losses"] == rows[0]["losses"]
                  and len(r["losses"]) == OFFLINE_STEPS for r in rows),
              f"stream: the offline runs' losses differ: "
              f"{[r['losses'] for r in rows]}")

        def pooled(mode, key):
            # the warm steps (all but each run's first) of both runs
            vals = [v for r in offline[mode] for v in r[key][1:]]
            return {"mean": sum(vals) / len(vals), "min": min(vals),
                    "max": max(vals)}

        res["offline"] = {
            "runs": offline, "order": ["on", "off", "off", "on"],
            "steps": OFFLINE_STEPS,
            "warm": {mode: {k: pooled(mode, k) for k in (
                "step_time_ms", "h2d_ms", "data_wait_ms", "dispatch_ms",
                "metric_flush_ms")} for mode in offline}}
        if on_card:
            for mode in offline:
                res["offline"]["warm"][mode]["idle_share"] = [
                    r["trace"]["idle_share"] for r in offline[mode]]
        log(f"stream: the offline plane, {OFFLINE_STEPS} steps a run, "
            f"defaults (h2d 1, tensorboard on) against the parent's (h2d "
            f"0, tensorboard off), alternated: {res['offline']['warm']}")

        def _mean(vals):
            vals = [v for v in vals if v is not None]
            return sum(vals) / len(vals) if vals else None

        def plane(row):
            return {"warm_step_ms": _mean(row["step_time_ms"][1:]),
                    "dispatch_ms": _mean(row["dispatch_ms"][1:]),
                    "idle_share": row.get("trace", {}).get("idle_share"),
                    "tokens_per_s": [v for _, v in
                                     row["worker_tokens_per_sec"]],
                    "data_wait_share": row["data_wait_share"]}

        on = offline["on"]
        warm_on = [v for r in on for v in r["step_time_ms"][1:]]
        res["planes"] = {
            "native": plane(row1), "python": plane(rowp),
            "offline": {
                "warm_step_ms": _mean(warm_on),
                "dispatch_ms": _mean([v for r in on
                                      for v in r["dispatch_ms"][1:]]),
                "idle_share": [r.get("trace", {}).get("idle_share")
                               for r in on],
                "tokens_per_s": None,
                "data_wait_share": sum(
                    v or 0.0 for r in on for v in r["data_wait_ms"][1:])
                / sum(warm_on)}}
        log(f"stream: planes side by side (warm steps, depth 1, the "
            f"defaults): {json.dumps(res['planes'])}")
        mark("offline")
        host, rate, _ = _host_stream(
            _stream_args(run_pretraining, cfg_path, corpus, vocab, tmp,
                         device, micro, STREAM_STEPS), vocab_size,
            STREAM_STEPS)
        res["host_loader"] = rate
        check(_same_batches(np, batches1, host) and _same_batches(
            np, batches0, host), "stream: the batches the steps read "
            "differ from the loader's alone on the host")
        log(f"stream: the {STREAM_STEPS} batches the steps read equal the "
            f"host loader's (1 worker, no prefetch: {rate})")
        mark("host_loader")

        # 3. packed at CUT_LAYERS, at a microbatch of at most
        # STREAM_DRILL_MICRO (the pool tokenizes ~1.7 examples a row plus
        # the packer's lookahead, and sets these runs' pace): the drills
        dmicro = min(micro, STREAM_DRILL_MICRO)
        def packed(name, steps, *extra):
            out = os.path.join(tmp, name)
            args = _stream_args(run_pretraining, cut_cfg_path, corpus,
                                vocab, out, device, dmicro, steps,
                                "--packing", *extra)
            result, batches, _ = _stream_train(torch, run_pretraining, args)
            return (args, [r["loss"] for r in result.history], batches,
                    result.metrics)

        pargs, clean, clean_b, _ = packed("clean", STREAM_STEPS,
                                          "--skip_checkpoint")
        _, crash, crash_b, crash_tel = packed(
            "crash", STREAM_STEPS, "--skip_checkpoint", "--stream_inject",
            "worker_crash")
        restarts = _series(crash_tel, "bert_stream_worker_restarts_total")
        check(crash == clean and _same_batches(np, crash_b, clean_b)
              and restarts and restarts[0][1] >= 1,
              f"stream: worker_crash losses {crash} vs {clean}, restarts "
              f"{restarts}")
        import warnings

        with warnings.catch_warnings():
            # one warning a dropped record: counted below instead
            warnings.simplefilter("ignore")
            _, corrupt, corrupt_b, corrupt_tel = packed(
                "corrupt", 2, "--skip_checkpoint", "--stream_inject",
                "corrupt_record")
            host_c, _, _ = _host_stream(pargs, vocab_size, 2,
                                        inject="corrupt_record")
        dropped = _series(corrupt_tel, "bert_stream_records_dropped_total")
        check(dropped and dropped[0][1] >= 1
              and _same_batches(np, corrupt_b, host_c)
              and np.isfinite(corrupt).all(),
              f"stream: corrupt_record dropped {dropped}, losses {corrupt}")
        res["packed"] = {"losses": clean, "worker_crash_losses": crash,
                         "worker_restarts": restarts,
                         "corrupt_losses": corrupt,
                         "records_dropped": dropped,
                         "segments_max": int(max(b["segment_ids"].max()
                                                 for b in clean_b))}
        log(f"stream: packed at {cut_cfg_path}: losses {clean}; "
            f"worker_crash {crash} (restarts {restarts}); corrupt_record "
            f"{corrupt} (dropped {dropped})")
        mark("drills")

        # 4-5. BPE, and the TensorBoard sink
        bpe = bpe_files([open(p).read() for p in sorted(
            os.path.join(corpus, n) for n in os.listdir(corpus))],
            os.path.join(tmp, "bpe"), n_merges=bpe_merges)
        bpe_vocab = json.load(open(bpe))
        with open(cut_cfg_path) as f:
            cfg = dict(json.load(f), vocab_size=len(bpe_vocab))
        bpe_cfg = os.path.join(tmp, "bpe_config.json")
        with open(bpe_cfg, "w") as f:
            json.dump(cfg, f)
        out = os.path.join(tmp, "bpe_run")
        lines = []
        args = _stream_args(run_pretraining, bpe_cfg, corpus, bpe, out,
                            device, dmicro, 2, "--skip_checkpoint",
                            "--stream_tokenizer", "bpe", "--tensorboard",
                            "on")
        result = run_pretraining.train(args, None, log=lines.append)
        losses = [r["loss"] for r in result.history]
        mask_line = [ln for ln in lines if ln.startswith("dataset:")]
        check(len(losses) == 2 and np.isfinite(losses).all()
              and f"[MASK]={bpe_vocab['<mask>']}" in mask_line[0],
              f"stream: BPE losses {losses}, {mask_line}")
        has_tb = importlib.util.find_spec("tensorboard") is not None
        tb = {"package": has_tb}
        if has_tb:
            from tensorboard.backend.event_processing.event_accumulator \
                import EventAccumulator

            acc = EventAccumulator(os.path.join(out, "phase1_log_tb"))
            acc.Reload()
            got = [(e.step, e.value) for e in acc.Scalars("train/step_loss")]
            tb["train_step_loss"] = got
            check([s for s, _ in got] == [1, 2] and np.allclose(
                [v for _, v in got], losses), f"stream: tensorboard {got}")
        else:
            tb["log"] = [ln for ln in lines if ln.startswith("tensorboard")]
            check(tb["log"] and "sink off" in tb["log"][0],
                  f"stream: no tensorboard and no line saying so: {lines}")
        res["bpe"] = {"vocab": len(bpe_vocab), "losses": losses,
                      "mask_id": bpe_vocab["<mask>"]}
        res["tensorboard"] = tb
        log(f"stream: BPE ({len(bpe_vocab)} tokens): losses {losses}; "
            f"tensorboard {tb}; seconds by part {marks}")
        mark("bpe_tensorboard")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the offline corpus pipeline and the native encoders ---------------------

PIPELINE_STEPS = 2
PIPELINE_SEQ = 128
PIPELINE_SHARD_BYTES = 300_000  # ~4 shards of the 1500-document corpus
PIPELINE_VOCAB = 30522          # BERT's; the trainers stop where merges do
PIPELINE_RATE_TEXTS = 6000      # the sentences the tokens/s are read over


def wiki_corpus(np, directory: str, n_docs: int, seed: int = 0) -> list:
    """`stream_corpus`'s documents as wikiextractor output (a <doc> block
    each, a title line, then its lines with their sentences capitalized
    and the period closed up, so the formatter's sentence split finds
    them): one file per stream_corpus file; returns their paths."""
    src = stream_corpus(np, os.path.join(directory, "stream"), n_docs, seed)
    paths = []
    for name in sorted(os.listdir(src)):
        with open(os.path.join(src, name)) as f:
            docs = [d for d in f.read().split("\n\n") if d.strip()]
        path = os.path.join(directory, f"wiki_{name}")
        with open(path, "w") as f:
            for i, doc in enumerate(docs):
                lines = [ln.replace(" .", ".").capitalize()
                         for ln in doc.splitlines() if ln.strip()]
                f.write(f'<doc id="{i}" title="Doc {i}">\nDoc {i}\n'
                        + "\n".join(lines) + "\n</doc>\n")
        paths.append(path)
    return paths


def native_build_start() -> dict:
    """The three native tokenizer libraries compiled anew from this
    checkout's sources, each on a thread of its own (the build phase runs
    them beside nvcc); `native_build_wait` gives each one's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from bert_pytorch_tpu_torch.native import build as native_build

    def one(target):
        t0 = time.perf_counter()
        native_build.build(target, force=True)
        return round(time.perf_counter() - t0, 3)

    pool = ThreadPoolExecutor(len(native_build.TARGETS))
    futures = {t: pool.submit(one, t) for t in native_build.TARGETS}
    pool.shutdown(wait=False)
    return futures


def native_build_wait(futures: dict) -> dict:
    return {t: f.result() for t, f in futures.items()}


def _rate(fn, reps: int = 1) -> tuple:
    """(fn()'s result, the least seconds of `reps` calls)."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
        best = secs if best is None else min(best, secs)
    return out, best


def phase_pipeline(torch, np, summary, device="cuda", cut_cfg_path=None,
                   micro=STREAM_MICRO, docs=STREAM_DOCS):
    """The offline corpus pipeline (bert_pytorch_tpu_torch.pipeline) and
    the native encoders (bert_pytorch_tpu_torch.native) on this machine's
    host, then the card:

    1. the three C++ libraries' seconds, built from this checkout's
       sources beside nvcc by the build phase (here, at once, where that
       phase did not run);
    2. `stream_corpus`'s `docs` documents as wikiextractor files,
       format -> shard -> count -> a WordPiece and a BPE vocabulary, each
       trained by the native merge engine and by the Python one: the two
       equal, the seconds of each;
    3. create_samples over each shard (max_seq_len 128, next_seq_prob
       0.5, short_seq_prob 0.1, seed + shard) with the native and with
       the Python WordPiece: the samples equal, the sentences/s of each;
    4. WordPiece and BPE tokens/s on the same sentences: native at 1
       thread and at min(cpu_count, 16), pure Python at 1 (host rates);
    5. the native samples' arrays (encode.sample_arrays) through an
       in-memory ShardIndex into run_pretraining.train: PIPELINE_STEPS
       phase-1 steps (`micro` x 128, accumulation 2) at `cut_cfg_path`
       (CUT_LAYERS), exact launch counts, finite losses.

    `device`, `micro` and `docs` exist so the phase can be rehearsed on
    the CPU at a tiny size."""
    import shutil

    from bert_pytorch_tpu_torch import native, run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.data.tokenization import (
        BertWordPieceTokenizer, ByteLevelBPETokenizer, get_bpe_tokenizer,
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.pipeline import encode, shard, vocab
    from bert_pytorch_tpu_torch.pipeline import format as fmt

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    marks, mark = _marks()
    res = {"seconds": marks}
    summary["pipeline"] = res
    try:
        # 1. the libraries, compiled anew (by the build phase, if it ran)
        where = "beside nvcc in the build phase"
        if "native_build_s" not in summary:
            where = "here, at once"
            summary["native_build_s"] = native_build_wait(
                native_build_start())
        res["build_s"] = summary["native_build_s"]
        mark("build")
        log(f"pipeline: native libraries built from the sources {where} "
            f"in {res['build_s']} s")

        # 2. format -> shard -> vocab
        raw = wiki_corpus(np, os.path.join(tmp, "raw"), docs)
        formatted = os.path.join(tmp, "formatted.txt")
        articles = fmt.format_wiki_files(raw, formatted)
        n_shards = shard.shard(formatted, os.path.join(
            tmp, "shards", "shard_{index}.txt"), PIPELINE_SHARD_BYTES)
        shards = [os.path.join(tmp, "shards", f"shard_{i}.txt")
                  for i in range(1, n_shards + 1)]
        counts = vocab.count_words(shards)
        mark("format_shard_count")
        trained = {}
        for engine in ("native", "python"):
            wp, wp_s = _rate(lambda: vocab.train_wordpiece(
                counts, PIPELINE_VOCAB, native=engine == "native"))
            bpe, bpe_s = _rate(lambda: vocab.train_bpe(
                counts, PIPELINE_VOCAB, native=engine == "native"))
            trained[engine] = (wp, bpe)
            res[f"vocab_{engine}_s"] = {"wordpiece": wp_s, "bpe": bpe_s}
        check(trained["native"] == trained["python"],
              "pipeline: the native and Python vocab trainers differ")
        wp_vocab, (bpe_vocab, bpe_merges) = trained["native"]
        vocab_txt = os.path.join(tmp, "vocab", "vocab.txt")
        vocab.save_wordpiece_vocab(wp_vocab, vocab_txt)
        vocab_json = os.path.join(tmp, "vocab", "bpe", "vocab.json")
        vocab.save_bpe(bpe_vocab, bpe_merges, vocab_json)
        res.update(articles=articles, shards=n_shards,
                   words=len(counts), wordpiece_vocab=len(wp_vocab),
                   bpe_vocab=len(bpe_vocab), bpe_merges=len(bpe_merges))
        log(f"pipeline: {articles} articles in {n_shards} shards, "
            f"{len(counts)} distinct words; WordPiece {len(wp_vocab)} "
            f"tokens, BPE {len(bpe_vocab)} ({len(bpe_merges)} merges), "
            f"equal by both engines; seconds native "
            f"{res['vocab_native_s']}, Python {res['vocab_python_s']}")
        mark("vocab")

        # 3. create_samples, native against Python
        nat = get_wordpiece_tokenizer(vocab_txt)
        check(isinstance(nat, native.NativeWordPieceTokenizer),
              f"pipeline: the factory gave {type(nat).__name__}")
        py = BertWordPieceTokenizer(vocab_txt)
        sentences = []
        for path in shards:
            with open(path) as f:
                sentences += [ln.strip() for ln in f if ln.strip()]
        samples = {}
        for name, tok in (("native", nat), ("python", py)):
            got, secs = _rate(lambda: [encode.create_samples(
                path, tok, PIPELINE_SEQ, 0.5, 0.1, seed=i)
                for i, path in enumerate(shards)])
            samples[name] = got
            res[f"samples_{name}"] = {
                "samples": sum(map(len, got)), "seconds": secs,
                "sentences_per_s": len(sentences) / secs}

        def fields(s):
            return (s.sequence, s.special_token_positions, s.is_random_next)

        check([[fields(s) for s in sh] for sh in samples["native"]]
              == [[fields(s) for s in sh] for sh in samples["python"]],
              "pipeline: create_samples differs native against Python")
        log(f"pipeline: create_samples over {len(sentences)} sentences, "
            f"equal: native {res['samples_native']}, Python "
            f"{res['samples_python']}")
        mark("samples")

        # 4. tokens/s on the same sentences (host rates)
        texts = sentences[:PIPELINE_RATE_TEXTS]
        threads = min(os.cpu_count() or 1, 16)
        bpe_nat = get_bpe_tokenizer(vocab_json)
        bpe_py = ByteLevelBPETokenizer(vocab_json, os.path.join(
            os.path.dirname(vocab_json), "merges.txt"), lowercase=True)
        rates = {}
        for name, n_tok, p_tok in (("wordpiece", nat, py),
                                   ("bpe", bpe_nat, bpe_py)):
            row = {}
            for label, t in (("native_1", 1), (f"native_{threads}",
                                               threads)):
                (lens, *_), secs = _rate(
                    lambda: n_tok.encode_batch_arrays(
                        texts, add_special_tokens=False, nthreads=t), 3)
                row[label] = float(lens.sum()) / secs
            ids, secs = _rate(lambda: [p_tok.encode_ids(
                s, add_special_tokens=False) for s in texts])
            row["python_1"] = sum(map(len, ids)) / secs
            check(sum(map(len, ids)) == int(lens.sum()),
                  f"pipeline: {name} tokens native {int(lens.sum())}, "
                  f"Python {sum(map(len, ids))}")
            rates[name] = row
        res["tokens_per_s"] = rates
        res["rate_texts"] = len(texts)
        log(f"pipeline: tokens/s on {len(texts)} sentences (host): "
            f"{rates}")
        mark("rates")

        # 5. the samples' arrays into the trainer, on the card
        arrays = [encode.sample_arrays(sh, nat, PIPELINE_SEQ)
                  for sh in samples["native"] if sh]
        index = array_index(arrays)
        layers = BertConfig.from_json_file(cut_cfg_path).num_hidden_layers
        args = run_pretraining.parse_arguments([
            "--config_file", PHASE1_CONFIG,
            "--model_config_file", cut_cfg_path,
            "--output_dir", os.path.join(tmp, "run"),
            "--local_batch_size", str(micro),
            "--global_batch_size", str(2 * micro),
            "--steps", str(PIPELINE_STEPS), "--fused_optim", "auto",
            "--skip_checkpoint", "--vocab_pad_multiple", "8",
            "--mask_token_index", str(nat.token_to_id("[MASK]")),
            "--seed", "0", "--log_freq", "1", "--device", device])
        reset_launches()
        result = run_pretraining.train(args, index, log=lambda m: None)
        launches = dict(LAUNCHES)
        losses = [r["loss"] for r in result.history]
        want = _pretrain_step_launches(layers, PIPELINE_STEPS, False, False)
        res.update(samples_in_memory=index.total, losses=losses,
                   launches=launches, launches_predicted=want,
                   step_time_ms=[p["step_time_ms"]
                                 for p in _perf_records(args)])
        summary.setdefault("launches", {})["pipeline"] = launches
        check(len(losses) == PIPELINE_STEPS
              and all(np.isfinite(losses)),
              f"pipeline: losses {losses}")
        if on_card:
            check(launches == want, f"pipeline: launch counts {launches}, "
                  f"want {want}")
        log(f"pipeline: {PIPELINE_STEPS} phase-1 steps of 2 x {micro} x "
            f"{PIPELINE_SEQ} at {layers} layers over {index.total} "
            f"samples in memory: losses {losses}, launches {launches}, "
            f"step ms {res['step_time_ms']}; seconds by part {marks}")
        mark("train")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- pretraining's survival and metrics planes -------------------------------

SURVIVAL_STEPS = 4
SURVIVAL_MICRO = 96             # phase 1's microbatch, accumulation 2
SURVIVAL_SAMPLES = 400          # a shard; two shards hold 4 steps of 192
SURVIVAL_WATCHDOG_S = 5.0       # above any phase of a normal step
SURVIVAL_STALL_S = 8.0


def survival_index(np, vocab: int, micro: int):
    """The in-memory phase-1 shards of the survival runs (seq 128): two,
    each a little over two steps of 2 x `micro`."""
    n = SURVIVAL_SAMPLES * micro // SURVIVAL_MICRO
    return array_index([pretraining_arrays(np, n, 128, vocab, seed)
                        for seed in (0, 1)])


def _survival_argv(cfg_path, out, device, micro, *extra):
    return ["--config_file", PHASE1_CONFIG, "--model_config_file", cfg_path,
            "--output_dir", out, "--local_batch_size", str(micro),
            "--global_batch_size", str(2 * micro),
            "--max_steps", str(SURVIVAL_STEPS), "--fused_optim", "auto",
            "--vocab_pad_multiple", "8", "--seed", "0", "--log_freq", "1",
            "--health_pack", "on", "--device", device, *extra]


# The data-parallel phase (train_dp, ROADMAP queue A item 7's data axis):
# BERT-Large's width at CUT_LAYERS, phase 1 at 2 ranks x 96 x 128, 3 steps.
# Two ranks share the one card over gloo (torch's gloo runs every
# collective the step needs on CUDA tensors; nothing is staged by the
# port); the 1-rank reference runs under an NCCL group of one. `samples`:
# the synthetic examples a shard (two shards), enough for 3 packed steps a
# rank; `micro`: a rank's rows.
DP_RUN = {"ranks": 2, "micro": 96, "seq": 128, "steps": 3,
          "samples": 640, "lr": 1e-3}
# The 2-rank step against the 1-rank step on the same global batch,
# dropout off, f32 gradients: the ranks run the bf16 forward on half the
# rows each (other product shapes, other roundings) and sum their f32
# gradients over the ranks, so the losses agree to ~1e-5 and the
# parameters, all tensors together, to a relative L2 of the same order
# (the CPU rehearsal at 2 layers: 9.95e-6 and 1.15e-5). A single tensor
# can read far more: Adam's first steps move an element by about lr
# whatever its gradient's size, so a zero-initialised bias whose gradient
# element is near 0 flips sign on a rounding (the rehearsal's worst
# tensor: 1.2e-2); the phase reports that tensor and bounds the whole.
# The grad norm reads each step's gradient at parameters the earlier
# steps already moved apart, so its disagreement grows with the step:
# 1.6e-5, 5.7e-5 and 1.8e-4 on the card (H100, CUT_LAYERS). A fault of the
# gradient's scale moves it by a half or more (a mean over the ranks in
# place of the sum halves it; counts not summed over the ranks double it),
# which LAMB's scale-free update would hide from the loss and the params.
DP_TOL = {"loss": 1e-4, "param": 1e-4, "grad_norm": 1e-3}


def _dp_index(np, run, config):
    """The phase's synthetic pretraining samples, two in-memory shards."""
    return array_index([pretraining_arrays(np, run["samples"], run["seq"],
                                           config.vocab_size, s)
                        for s in (0, 1)])


def _dp_batches(np, index, config, args_seed: int, rows: int, steps: int,
                max_pred: int):
    """`steps` global batches of `rows` rows drawn by the entry point's
    loader (masks included) at world 1: the step-level legs' data."""
    from bert_pytorch_tpu_torch.data.sharded import (HostShardSampler,
                                                     PretrainingDataLoader)

    loader = PretrainingDataLoader(
        index, HostShardSampler(len(index), seed=args_seed),
        batch_size=rows, mask_token_index=103, max_pred_per_seq=max_pred,
        masked_lm_prob=0.15, vocab_size=config.vocab_size, seed=args_seed,
        prefetch_batches=0)
    try:
        return [next(loader) for _ in range(steps)]
    finally:
        loader.close()


def _dp_step_leg(torch, np, config, batches, rank: int, world: int, device,
                 lr: float, mesh=None, seeds=None):
    """The step-level leg: a seeded random model, ZeRO-1 over `world`
    ranks (build_pretrain_step with a DataParallel), one microbatch a step
    of this rank's rows of each global batch, dropout off (no seeds), the
    bf16 forward with f32 gradients, LAMB on the kernels. `mesh` (a
    parallel/mesh.Mesh over the `world` ranks) places the ranks on it
    instead, without ZeRO-1: each builds its model part of the same
    seeded weights and takes its data shard's rows; `seeds` (one (1,
    sites) int32 tensor a step) turns dropout on. Returns (losses, grad
    norms, the one-card params; collective)."""
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights,
                                                    set_dropout_shard)
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.optim.schedulers import make_schedule
    from bert_pytorch_tpu_torch.parallel.zero import DataParallel
    from bert_pytorch_tpu_torch.telemetry.health import HealthConfig
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    with torch.device(device):
        model = BertForPreTraining(config, dtype=torch.bfloat16)
    init_weights(model, torch.Generator(device=device).manual_seed(0),
                 std=config.initializer_range)
    shards, index = world, rank
    if mesh is None:
        set_dropout_shard(model, rank)
        dp = DataParallel(model, zero1=True)
    else:
        from bert_pytorch_tpu_torch.models.convert import shard_state_dict
        from bert_pytorch_tpu_torch.parallel import dist
        from bert_pytorch_tpu_torch.parallel.tensor import ModelShard

        axes = dist.make_axes(mesh)
        whole = model.state_dict()
        with torch.device(device):
            model = BertForPreTraining(config, dtype=torch.bfloat16,
                                       model_shard=ModelShard(
                                           axes.coords["model"], mesh.model,
                                           axes.model))
        model.load_state_dict(shard_state_dict(whole, mesh, rank))
        del whole
        shards = mesh.data * mesh.fsdp
        index = mesh.data_shard_index(rank)
        set_dropout_shard(model, index, mesh.flat_shard_index(rank))
        dp = DataParallel(model, axes=axes)
    sched = make_schedule("poly", lr, 10, warmup=0.0)
    tx = Lamb(sched, weight_decay=0.01, fused="auto")
    state = make_train_state(model, tx, dp=dp)
    step = build_pretrain_step(model, tx, schedule=sched, accum_steps=1,
                               max_predictions=80, grad_dtype=None,
                               health=HealthConfig(), dp=dp)
    losses, norms = [], []
    for i, b in enumerate(batches):
        rows = len(b["input_ids"]) // shards
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            v[index * rows:(index + 1) * rows]))[None].to(device)
            for k, v in b.items()}
        m = step(state, batch, None if seeds is None else seeds[i])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = {k: v.detach().float().cpu()
              for k, v in state.state_dict()["params"].items()}
    dp.close()
    return losses, norms, params


def _dp_arms(run: dict, device: str):
    """The entry-point legs of the two ranks: (name, extra argv, saves).
    On a card --mesh_config auto picks production (packing, ZeRO-1,
    gather-on-use); the CPU rehearsal names production, which auto keeps
    off there."""
    auto = ["--mesh_config", "auto" if device == "cuda" else "production"]
    fsdp = ["--mesh", "fsdp=2", "--mesh_config", "base", "--packing"]
    return [("production", auto, True),
            ("production_rs", auto + ["--zero1_rs"], False),
            ("production_coalesced", auto + ["--coalesce_reductions", "on"],
             False),
            ("zero1_end_gather", ["--mesh_config", "base", "--zero1", "true",
                                  "--packing"], False),
            ("fsdp", fsdp, False),
            ("fsdp_overlap", fsdp + ["--fsdp_overlap"], False)]


def _dp_model_arm(run: dict):
    """The model-axis arm of the train_dp ranks: --mesh model=2 through
    the entry point (packing, one data shard of half a rank's `micro`
    rows: accumulation 1; the model group's f32 activation sums through
    gloo set its step, ~2.6 s at 96 rows on the card), which saves its
    checkpoint for the one-rank restore."""
    rows = str(max(1, run["micro"] // 2))
    return ("model2", ["--mesh", "model=2", "--mesh_config", "base",
                       "--packing", "--local_batch_size", rows,
                       "--global_batch_size", rows], True)


# train_dp's seq-512 leg at model=2: dropout on, so the flash
# kernels (#5, #7) run on BERT-Large's 16 / 2 = 8 local heads with the
# folded seed; one step of `rows` rows of 512 from a synthetic shard of
# `samples`, 80 predictions a row.
DP_SEQ512 = {"rows": 8, "samples": 32, "steps": 1}


def _dp_seq512_leg(torch, np, config, rank: int, world: int, device,
                   lr: float) -> dict:
    """(c): DP_SEQ512's step at model=2 with dropout on (the launches
    counted from 0 just before the step-level leg and read just after),
    then the flash forward (#5) and the fused backward (#7) at the leg's
    shape, (rows, 512, 8, 64) bf16, with this rank's folded seed, against
    their plain versions (on the card; the CPU runs the plain versions
    alone)."""
    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
        flash_attention_ref, flash_shard_seed)
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.parallel.mesh import Mesh
    from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

    leg = DP_SEQ512
    mesh = Mesh(model=world)
    index = array_index([pretraining_arrays(np, leg["samples"], 512,
                                            config.vocab_size, 5)])
    batches = _dp_batches(np, index, config, 0, leg["rows"], leg["steps"],
                          80)
    sites = 1 + 3 * config.num_hidden_layers
    seeds = [dropout_seeds(0, i + 1, 1, sites) for i in range(leg["steps"])]
    t0 = time.perf_counter()
    reset_launches()
    losses, norms, _ = _dp_step_leg(torch, np, config, batches, rank, world,
                                    device, lr, mesh=mesh, seeds=seeds)
    out = {"loss": losses, "grad_norm": norms, "launches": dict(LAUNCHES),
           "s": time.perf_counter() - t0}
    heads = config.num_attention_heads // mesh.model
    seed = flash_shard_seed(int(seeds[0][0, 1]),
                            mesh.flat_shard_index(rank))
    gen = torch.Generator(device=device).manual_seed(7 + rank)
    shape = (leg["rows"], 512, heads, config.head_dim)
    q, k, v, g = (torch.randn(shape, generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(4))
    out_k, lse_k = flash_attention(q, k, v, None, None, seed, 0.1)
    ref, lse_ref = flash_attention_ref(q, k, v, None, None, seed, 0.1)
    dk = flash_attention_bwd(q, k, v, None, None, out_k, lse_k, g, seed,
                             0.1)
    dref = flash_attention_bwd_ref(q, k, v, None, None, out_k, lse_k, g,
                                   seed, 0.1)
    out["kernels"] = {
        "shape": list(shape), "seed": seed,
        "fwd_max_abs_err": (out_k.float() - ref.float()).abs().max().item(),
        "lse_max_abs_err": (lse_k - lse_ref).abs().max().item(),
        "bwd_rel_err": max(_rel(a, b) for a, b in zip(dk, dref))}
    return out


def dp_child(argv) -> int:
    """`chip_smoke.py --dp_child JOB RANK`: one rank of the train_dp
    phase's two, both on the one card (LOCAL_RANK 0) in a gloo group
    (FileStore at the job's `store`): the step-level compare leg, then
    each entry-point arm through run_pretraining.train over the in-memory
    shards, the launches counted from 0 just before each arm and read
    just after; writes rank<RANK>.json (and rank 0 the compare leg's
    params) under the job's `out`."""
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    with open(argv[0]) as f:
        job = json.load(f)
    rank = int(argv[1])
    os.environ["LOCAL_RANK"] = "0"
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.parallel import dist

    device = job["device"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

        load_kernels()
    else:
        torch.set_num_threads(1)
    dist.initialize(device, backend="gloo",
                    init_method=f"file://{job['store']}", rank=rank,
                    world_size=job["world"])
    run = job["run"]
    out = {"rank": rank, "start_s": time.perf_counter() - START}
    config = BertConfig.from_json_file(job["cfg_path"])
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    index = _dp_index(np, run, config)
    t0 = time.perf_counter()
    batches = _dp_batches(np, index, config, 0, run["micro"] * job["world"],
                          run["steps"], 20)
    losses, norms, params = _dp_step_leg(
        torch, np, config, batches, rank, job["world"], device, run["lr"])
    out["compare"] = {"loss": losses, "grad_norm": norms,
                      "s": time.perf_counter() - t0,
                      "ready_s": t0 - START}
    if rank == 0:
        torch.save(params, os.path.join(job["out"], "compare_params.pt"))
    del params
    # (b) the same global batches at model=2 (one data shard: every rank
    # takes all the rows), dropout off
    from bert_pytorch_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    dist.reset_stats()
    reset_launches()
    losses, norms, params = _dp_step_leg(
        torch, np, config, batches, rank, job["world"], device, run["lr"],
        mesh=Mesh(model=job["world"]))
    out["model2_compare"] = {"loss": losses, "grad_norm": norms,
                             "launches": dict(LAUNCHES),
                             "collectives": dist.axis_stats(),
                             "s": time.perf_counter() - t0}
    if rank == 0:
        torch.save(params, os.path.join(job["out"], "model2_params.pt"))
    del params, batches
    out["arms"] = {}
    for name, argv_arm, saves in _dp_arms(run, device) + [_dp_model_arm(run)]:
        args = run_pretraining.parse_arguments(
            job["base_argv"] + ["--output_dir",
                                os.path.join(job["out"], name)]
            + argv_arm + ([] if saves else ["--skip_checkpoint"]))
        dist.reset_stats()
        reset_launches()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = run_pretraining.train(args, index, log=(
            (lambda m, n=name: log(f"train_dp[{n}]: {m}")) if rank == 0
            else (lambda m: None)))
        launches = dict(LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else None)
        sd = result.state.state_dict()      # collective under ZeRO-1
        digest = hashlib.sha256()
        for k in sorted(sd["params"]):
            digest.update(sd["params"][k].detach().contiguous().cpu()
                          .numpy().tobytes())
        out["arms"][name] = {
            "loss": [h["loss"] for h in result.history],
            "grad_norm": [h["grad_norm"] for h in result.history],
            "step_ms": [h["step_ms"] for h in result.history],
            "examples": [h["examples"] for h in result.history],
            "launches": launches, "params_sha256": digest.hexdigest(),
            "parallel": result.parallel, "saves": [s["step"] for s in
                                                   result.saves],
            "hbm_peak_bytes": peak,
            "collectives_by_axis": dist.axis_stats(),
            "s": time.perf_counter() - t0}
        del sd, result
    out["seq512"] = _dp_seq512_leg(torch, np, config, rank, job["world"],
                                   device, run["lr"])
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    dist.barrier()
    dist.shutdown()
    return 0


def phase_train_dp(torch, np, summary, device="cuda", cfg_path=None,
                   run=None, keep=None):
    """Data-parallel pretraining (parallel/): the 1-rank reference under
    an NCCL group of one (ZeRO-1, so the NCCL wrappers run on the card)
    and two ranks on the one card over gloo (`dp_child`): the step-level
    compare leg (the same global batch, dropout off, f32 gradients)
    against the reference within DP_TOL; the entry point's arms (--mesh data=2 with --mesh_config
    auto: packing, ZeRO-1, gather-on-use; + --zero1_rs; + coalesced norm
    reductions; ZeRO-1 with the end-of-step gather) bit-equal to one
    another (losses, grad norms, the params' digest), finite, their
    launches exact on each rank; the first arm's 2-rank checkpoint
    restored by one rank, then moved to `keep` when given (train_chunks
    and finetune_tasks start from it through --init_checkpoint). `device`,
    `cfg_path` and `run` exist for the CPU rehearsal; the script runs
    BERT-Large's width at CUT_LAYERS."""
    import hashlib
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.parallel import dist

    run = dict(DP_RUN, **(run or {}))
    on_card = torch.device(device).type == "cuda"
    world = run["ranks"]
    if on_card:
        # the ranks are processes of their own on this card: what the
        # earlier phases left in this process's cache goes back first
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    layers = config.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    res = {"ranks": world, "layers": layers, "micro": run["micro"],
           "seq": run["seq"], "steps": run["steps"]}
    try:
        base = ["--config_file", PHASE1_CONFIG, "--model_config_file",
                cfg_path, "--input_dir", os.path.join(tmp, "memory"),
                "--local_batch_size", str(run["micro"]),
                "--global_batch_size", str(run["micro"] * world),
                "--steps", str(run["steps"]), "--fused_optim", "auto",
                "--vocab_pad_multiple", "8", "--seed", "0",
                "--device", device, "--mesh", f"data={world}",
                "--num_steps_per_checkpoint", "1000", "--tensorboard", "off",
                "--log_freq", "1"]
        job = {"device": device, "world": world, "run": run,
               "cfg_path": cfg_path, "base_argv": base, "out": tmp,
               "store": os.path.join(tmp, "store")}
        job_path = os.path.join(tmp, "job.json")
        with open(job_path, "w") as f:
            json.dump(job, f)
        # the two ranks start first (their imports and the card's context
        # take seconds); the reference runs meanwhile
        env = dict(os.environ, PYTHONPATH=HERE)
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--dp_child", job_path, str(r)], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        try:
            t0 = time.perf_counter()
            index = _dp_index(np, run, config)
            batches = _dp_batches(np, index, config, 0, run["micro"] * world,
                                  run["steps"], 20)
            dist.initialize(device, backend="nccl" if on_card else "gloo",
                            init_method="file://" + os.path.join(
                                tmp, "reference_store"),
                            rank=0, world_size=1)
            try:
                check(dist.backend() == ("nccl" if on_card else "gloo"),
                      f"reference group backend {dist.backend()}")
                dist.reset_stats()
                ref_loss, ref_norm, ref_params = _dp_step_leg(
                    torch, np, config, batches, 0, 1, device, run["lr"])
                ref_stats = {k: dict(v) for k, v in dist.STATS.items()}
            finally:
                dist.shutdown()
            res["reference"] = {"loss": ref_loss, "grad_norm": ref_norm,
                                "collectives": ref_stats,
                                "s": round(time.perf_counter() - t0, 2)}
            check(ref_stats.get("reduce_scatter", {}).get("calls", 0) > 0
                  and ref_stats.get("all_gather", {}).get("calls", 0) > 0,
                  f"the reference ran no collective: {ref_stats}")
            logs = []
            for p in procs:
                logs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(procs, logs)):
            if p.returncode:
                log(f"train_dp: rank {r} output:\n{out[-6000:]}")
            check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                  + out[-1500:].replace("\n", " | "))
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        res["rank_timeline_s"] = [
            {"start": r["start_s"], "ready": r["compare"]["ready_s"],
             "compare": r["compare"]["s"],
             "arms": {n: a["s"] for n, a in r["arms"].items()}}
            for r in ranks]

        # the compare leg against the reference
        cmp_loss = ranks[0]["compare"]["loss"]
        for r in ranks[1:]:
            check(r["compare"]["loss"] == cmp_loss,
                  "the ranks' compare-leg losses differ")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cmp_loss,
                                                          ref_loss))
        cmp_norm = ranks[0]["compare"]["grad_norm"]
        norm_rel = max(abs(a - b) / abs(b) for a, b in zip(cmp_norm,
                                                          ref_norm))
        got = torch.load(os.path.join(tmp, "compare_params.pt"),
                         weights_only=True)
        param_rel = max(
            (float((got[k] - w).norm() / w.norm().clamp_min(1e-30)), k)
            for k, w in ref_params.items())
        sq = [(float((got[k] - w).square().sum()), float(w.square().sum()))
              for k, w in ref_params.items()]
        global_rel = (sum(a for a, _ in sq) / sum(b for _, b in sq)) ** 0.5
        torch.save(ref_params, os.path.join(tmp, "reference_params.pt"))
        del got, ref_params
        res["compare"] = {"loss": cmp_loss, "ref_loss": ref_loss,
                          "grad_norm": cmp_norm, "ref_grad_norm": ref_norm,
                          "loss_max_rel": loss_rel,
                          "grad_norm_max_rel": norm_rel,
                          "param_max_rel": param_rel[0],
                          "param_global_rel": global_rel,
                          "param_worst": param_rel[1], "tol": DP_TOL}
        log(f"train_dp: 2 ranks against 1 (same global batch, dropout off):"
            f" losses {cmp_loss} / {ref_loss} (max rel {loss_rel:.3g}), "
            f"grad norms {cmp_norm} / {ref_norm} (max rel {norm_rel:.3g}), "
            f"params max rel L2 {param_rel[0]:.3g} ({param_rel[1]}), all "
            f"together {global_rel:.3g}")
        check(all(np.isfinite(cmp_loss)) and loss_rel <= DP_TOL["loss"],
              f"2-rank loss {cmp_loss} against {ref_loss}: rel {loss_rel}")
        check(all(np.isfinite(cmp_norm)) and norm_rel <= DP_TOL["grad_norm"],
              f"2-rank grad norms {cmp_norm} against {ref_norm}: rel "
              f"{norm_rel}")
        check(global_rel <= DP_TOL["param"],
              f"2-rank params against 1-rank: rel L2 {global_rel} (worst "
              f"tensor {param_rel})")

        # (b) model=2 on the same global batches against the reference;
        # without seeds the residual tails are LayerNorms (#1/#2) alone
        want = _per_step_launches(layers, run["steps"], False, accum=1)
        want_off = dict(want, add_dropout_layer_norm_fwd=0,
                        add_dropout_layer_norm_bwd=0)
        for k in ("fwd", "bwd"):
            want_off[f"layer_norm_{k}"] += want[f"add_dropout_layer_norm_{k}"]
        m2 = [r["model2_compare"] for r in ranks]
        for r in m2[1:]:
            check(r["loss"] == m2[0]["loss"]
                  and r["grad_norm"] == m2[0]["grad_norm"],
                  "the model=2 ranks' compare-leg metrics differ")
        m2_loss = max(abs(a - b) / abs(b) for a, b in zip(m2[0]["loss"],
                                                          ref_loss))
        m2_norm = max(abs(a - b) / abs(b)
                      for a, b in zip(m2[0]["grad_norm"], ref_norm))
        got = torch.load(os.path.join(tmp, "model2_params.pt"),
                         weights_only=True)
        want_params = torch.load(os.path.join(tmp, "reference_params.pt"),
                                 weights_only=True)
        sq = [(float((got[k] - w).square().sum()), float(w.square().sum()))
              for k, w in want_params.items()]
        m2_rel = (sum(a for a, _ in sq) / sum(b for _, b in sq)) ** 0.5
        del got, want_params
        res["model2_compare"] = {
            "loss": m2[0]["loss"], "grad_norm": m2[0]["grad_norm"],
            "loss_max_rel": m2_loss, "grad_norm_max_rel": m2_norm,
            "param_global_rel": m2_rel, "s": m2[0]["s"],
            "collectives_by_axis": m2[0]["collectives"], "tol": DP_TOL}
        log(f"train_dp: model=2 against 1 rank (same global batch, dropout "
            f"off): losses {m2[0]['loss']} (max rel {m2_loss:.3g}), grad "
            f"norms max rel {m2_norm:.3g}, params all together "
            f"{m2_rel:.3g}; {m2[0]['s']:.1f} s")
        check(all(np.isfinite(m2[0]["loss"])) and m2_loss <= DP_TOL["loss"]
              and m2_norm <= DP_TOL["grad_norm"]
              and m2_rel <= DP_TOL["param"],
              f"model=2 against 1 rank: loss {m2_loss}, grad norm "
              f"{m2_norm}, params {m2_rel} (bounds {DP_TOL})")
        for r in m2:
            got_l = {k: r["launches"].get(k, 0) for k in want_off}
            check(got_l == want_off or not on_card,
                  f"model=2 compare leg: launches {got_l}, want {want_off}")
        summary.setdefault("launches", {})["train_dp_model2_compare"] = \
            dict(m2[0]["launches"])

        # the arms: bit-equal, finite, launches exact
        arms = [a[0] for a in _dp_arms(run, device)]
        want = _per_step_launches(layers, run["steps"], False, accum=1)
        first = ranks[0]["arms"][arms[0]]
        res["arms"] = {}
        for name in arms:
            for r in ranks:
                a = r["arms"][name]
                for key in ("loss", "grad_norm", "params_sha256"):
                    check(a[key] == first[key],
                          f"arm {name} rank {r['rank']}: {key} "
                          f"{a[key]} != {arms[0]}'s {first[key]}")
                got_l = {k: a["launches"].get(k, 0) for k in want}
                # the CPU rehearsal runs the plain versions: no launches
                check(got_l == want or not on_card,
                      f"arm {name} rank {r['rank']}: launches {got_l}, "
                      f"want {want}")
                check(all(np.isfinite(a["loss"])),
                      f"arm {name}: losses {a['loss']}")
            a0 = ranks[0]["arms"][name]
            par = a0["parallel"]
            res["arms"][name] = {
                "step_ms": [r["arms"][name]["step_ms"] for r in ranks],
                "examples": a0["examples"], "s": a0["s"],
                "mesh_config": par["mesh_config"], "zero1": par["zero1"],
                "zero1_overlap": par["zero1_overlap"],
                "zero1_rs": par["zero1_rs"], "coalesce": par["coalesce"],
                "collectives": par["collectives"],
                "norm_reductions": par["norm_reductions"],
                "replicated_leaves": par["replicated_leaves"]}
        prod = res["arms"][arms[0]]
        check(prod["mesh_config"] == "production" and prod["zero1"]
              and prod["zero1_overlap"],
              f"--mesh_config auto on the card resolved to {prod}")
        # the gradients leave the --zero1_rs arm by a reduce-scatter alone
        # and the coalesced arm (no --zero1_rs) by an all-reduce, the same
        # reduce-scatter and an all-gather of the reduced slices: equal
        # reduce-scatter bytes, and all-gather bytes that differ by exactly
        # those (the norm partials' bytes do not depend on the buckets)
        rs, co = (res["arms"][a]["collectives"] for a in arms[1:3])
        grad_bytes = rs.get("reduce_scatter", {}).get("bytes", 0)
        gathered = (co.get("all_gather", {}).get("bytes", 0)
                    - rs.get("all_gather", {}).get("bytes", 0))
        check(res["arms"][arms[1]]["zero1_rs"] and grad_bytes > 0
              and co.get("reduce_scatter", {}).get("bytes") == grad_bytes
              and gathered == grad_bytes,
              f"the --zero1_rs arm's collectives {rs} against the "
              f"all-reduce arm's {co}: the gradients' all-gather "
              f"({gathered} bytes) must be the reduce-scatter's "
              f"({grad_bytes}) and only the all-reduce arm's")
        res["loss"] = first["loss"]
        summary.setdefault("launches", {})["train_dp"] = dict(
            ranks[0]["arms"][arms[0]]["launches"])
        for name in ("fsdp", "fsdp_overlap"):
            summary["launches"][f"train_dp_{name}"] = dict(
                ranks[0]["arms"][name]["launches"])
        # each rank's memory: the f32 state it rests with and its peak
        res["memory"] = {
            name: {"resting_f32_bytes": [
                r["arms"][name]["parallel"]["resting_f32_bytes"]
                for r in ranks],
                "hbm_peak_bytes": [r["arms"][name]["hbm_peak_bytes"]
                                   for r in ranks],
                "collectives_by_axis": ranks[0]["arms"][name][
                    "collectives_by_axis"]}
            for name in arms + ["model2"]}
        log("train_dp: memory a rank (resting f32 / hbm peak, MB): " + "; "
            .join(f"{n} " + " ".join(
                f"{a / 2**20:.0f}/{(b or 0) / 2**20:.0f}" for a, b in zip(
                    v["resting_f32_bytes"], v["hbm_peak_bytes"]))
                for n, v in res["memory"].items()))
        fs, zg = (res["memory"][n]["resting_f32_bytes"][0]
                  for n in ("fsdp", "zero1_end_gather"))
        check(fs < zg, f"fsdp=2 rests {fs} f32 bytes, ZeRO-1 with whole "
              f"masters {zg}")

        # the model=2 arm: finite, launches exact, the ranks agree
        m2a = [r["arms"]["model2"] for r in ranks]
        for a in m2a:
            for key in ("loss", "grad_norm", "params_sha256"):
                check(a[key] == m2a[0][key],
                      f"model2 arm: the ranks' {key} differ")
            got_l = {k: a["launches"].get(k, 0) for k in want}
            check((got_l == want or not on_card)
                  and all(np.isfinite(a["loss"])),
                  f"model2 arm: launches {got_l} (want {want}), losses "
                  f"{a['loss']}")
        res["arms"]["model2"] = {
            "step_ms": [a["step_ms"] for a in m2a], "loss": m2a[0]["loss"],
            "s": m2a[0]["s"], "collectives_by_axis":
                m2a[0]["collectives_by_axis"]}
        summary["launches"]["train_dp_model2"] = dict(m2a[0]["launches"])

        # (c) model=2 at seq 512, dropout on: #5 and #7 on 8 local heads
        want512 = _per_step_launches(layers, DP_SEQ512["steps"], True,
                                     accum=1)
        s512 = [r["seq512"] for r in ranks]
        for r in s512:
            got_l = {k: r["launches"].get(k, 0) for k in want512}
            check(got_l == want512 or not on_card,
                  f"model=2 seq-512 leg: launches {got_l}, want {want512}")
            check(all(np.isfinite(r["loss"])) and r["loss"] == s512[0]["loss"],
                  f"model=2 seq-512 leg: losses {r['loss']}")
            kern = r["kernels"]
            check(kern["fwd_max_abs_err"] <= FLASH_TOL["bfloat16"]
                  and kern["lse_max_abs_err"] <= LSE_TOL
                  and kern["bwd_rel_err"] <= FLASH_BWD_TOL["bfloat16"],
                  f"model=2 flash kernels at {kern['shape']} seed "
                  f"{kern['seed']} against their plain versions: {kern}")
        res["seq512"] = {"loss": s512[0]["loss"], "s": s512[0]["s"],
                         "kernels": [r["kernels"] for r in s512]}
        summary["launches"]["train_dp_model2_seq512"] = dict(
            s512[0]["launches"])
        log(f"train_dp: model=2 at seq 512 (dropout on): loss "
            f"{s512[0]['loss']}, launches exact a rank ({want512}); #5/#7 at "
            f"{s512[0]['kernels']['shape']} with each rank's folded seed "
            "against their plain versions: " + "; ".join(
                f"seed {k['seed']} fwd {k['fwd_max_abs_err']:.3g} lse "
                f"{k['lse_max_abs_err']:.3g} bwd {k['bwd_rel_err']:.3g}"
                for k in res["seq512"]["kernels"]))
        log(f"train_dp: arms {arms} bit-equal on both ranks: losses "
            f"{first['loss']}, grad norms {first['grad_norm']}; launches "
            f"exact a rank ({want}); step ms (rank 0 / rank 1) "
            + "; ".join(f"{n} {v['step_ms']}" for n, v in
                        res["arms"].items()))

        # the first arm's 2-rank checkpoint restored by one rank
        check(ranks[0]["arms"][arms[0]]["saves"] == [run["steps"]],
              f"the 2-rank arm saved {ranks[0]['arms'][arms[0]]['saves']}")
        args = run_pretraining.parse_arguments(
            [a for a in base if a not in ("--mesh", f"data={world}")]
            + ["--output_dir", os.path.join(tmp, arms[0]), "--steps", "0"])
        t0 = time.perf_counter()
        one = run_pretraining.train(args, _dp_index(np, run, config),
                                    log=lambda m: None)
        res["restore_one_rank_s"] = round(time.perf_counter() - t0, 2)
        digest = hashlib.sha256()
        for k in sorted(one.state.params):
            digest.update(one.state.params[k].detach().contiguous().cpu()
                          .numpy().tobytes())
        check(one.resumed_from == run["steps"]
              and digest.hexdigest() == first["params_sha256"],
              f"one rank restored step {one.resumed_from} with params "
              f"{digest.hexdigest()[:12]}, want step {run['steps']} and "
              f"{first['params_sha256'][:12]}")
        log(f"train_dp: the 2-rank step-{run['steps']} checkpoint restored "
            f"by one rank, params bit-equal "
            f"({res['restore_one_rank_s']} s)")
        # the model=2 arm's checkpoint (the one-card layout) on one rank
        check(m2a[0]["saves"] == [run["steps"]],
              f"the model=2 arm saved {m2a[0]['saves']}")
        args = run_pretraining.parse_arguments(
            [a for a in base if a not in ("--mesh", f"data={world}")]
            + ["--output_dir", os.path.join(tmp, "model2"), "--steps", "0"])
        one = run_pretraining.train(args, _dp_index(np, run, config),
                                    log=lambda m: None)
        digest = hashlib.sha256()
        for k in sorted(one.state.params):
            digest.update(one.state.params[k].detach().contiguous().cpu()
                          .numpy().tobytes())
        check(one.resumed_from == run["steps"]
              and digest.hexdigest() == m2a[0]["params_sha256"],
              f"one rank restored the model=2 step {one.resumed_from} with "
              f"params {digest.hexdigest()[:12]}, want "
              f"{m2a[0]['params_sha256'][:12]}")
        del one
        log("train_dp: the model=2 checkpoint restored by one rank, params "
            "bit-equal")
        if keep is not None:
            shutil.move(os.path.join(tmp, arms[0], "pretrain_ckpts"), keep)
            res["checkpoint"] = {"dir": keep, "step": run["steps"]}
        summary["train_dp"] = res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def pretrain_child(argv) -> int:
    """`chip_smoke.py --pretrain_child -- <run_pretraining flags>`: the
    entry point's run in a process of its own, under its exit-code
    contract (`run_pretraining.exit_code_of`, which `_cli` is), over the
    survival phase's in-memory shards (the chip machine has no h5py, so
    only the file read differs from `python -m
    bert_pytorch_tpu_torch.run_pretraining`), or with --stream_dir over
    its corpus."""
    import numpy as np

    sys.path.insert(0, HERE)
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size

    args = run_pretraining.parse_arguments(argv)
    index = None        # --stream_dir reads its corpus
    if not args.stream_dir:
        vocab = pad_vocab_size(BertConfig.from_json_file(
            args.model_config_file).vocab_size, args.vocab_pad_multiple)
        index = survival_index(np, vocab, args.local_batch_size)
    return run_pretraining.exit_code_of(
        lambda: run_pretraining.train(args, index))


def _child(argv, timeout: float = 600.0):
    """(exit code, output) of a pretrain_child process."""
    r = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                        "--pretrain_child", "--", *argv], cwd=HERE,
                       capture_output=True, text=True, timeout=timeout)
    return r.returncode, r.stdout + r.stderr


def _params_digest(torch, params: dict) -> dict:
    import hashlib

    return {k: hashlib.sha256(v.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()
            for k, v in params.items()}


def _scrape(url: str) -> dict:
    from bert_pytorch_tpu_torch.telemetry.registry import parse_prometheus

    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return parse_prometheus(r.read().decode())


def _valid_bundles(root: str, want) -> list:
    """The bundle directories under `root`; each of `want` must be there
    and pass the port's validator (a failure names it and its errors)."""
    from bert_pytorch_tpu_torch.telemetry.flight_recorder import \
        validate_bundle

    names = sorted(os.listdir(root)) if os.path.isdir(root) else []
    for name in want:
        check(name in names, f"no bundle {name} under {root}: {names}")
        errors = validate_bundle(os.path.join(root, name))
        check(not errors, f"bundle {name}: {errors}")
    return names


def phase_survival(torch, np, summary, device="cuda",
                   cfg_path=os.path.join(HERE, "configs",
                                         "bert_large_uncased_config.json"),
                   watchdog_s=SURVIVAL_WATCHDOG_S,
                   stall_s=SURVIVAL_STALL_S, micro=SURVIVAL_MICRO):
    """Pretraining's survival and metrics planes at `cfg_path`'s width
    (BERT-Large), phase 1's 96 x 128 microbatch at accumulation 2, the
    health pack on, through the entry point's trainer over in-memory
    shards (runs that must die run in a process of their own,
    `pretrain_child`):

    - a clean SURVIVAL_STEPS-step run with --metrics_port 0 and
      --log_freq 1 (exact launch counts; /metrics scraped mid-run shows
      the bert_* families; each perf record's mfu in (0, 1) on the card's
      peak): its losses and final parameters are the reference;
    - --chaos sigterm_at_step at step 3 in a child: exit 143, an
      emergency checkpoint of step 2 that verifies and the flight
      recorder's crash bundle beside it; the resume (health pack off) to
      step 4 is bit-equal to the clean run (losses and every parameter);
      the checkpoint's keys are the pack-off state's;
    - --chaos stall_dispatch at step 3 under --watchdog_action warn, with
      --inject_nonfinite_step 2 --nonfinite_action skip: one device_hang
      trip, counted on /metrics, a stacks file and a watchdog_device_hang
      bundle; step 2 dropped (its non-finite bundle dumped), the
      parameters unchanged (its param_norm equal to step 1's, drift 0);
    - the recorder drill: --inject_nonfinite_step 2 --nonfinite_action
      halt in a child with a checkpoint at step 1: exit 71 naming its
      bundle, which validates; `python -m
      bert_pytorch_tpu_torch.tools.replay --bundle <it> --bisect` in a
      process of its own reproduces step 2 bit-identically and names
      layer 0's attention;
    - the health pack's host and device time on the clean run's state,
      and the emergency save's and the resume's seconds.

    `device`, `cfg_path`, the watchdog's seconds and `micro` exist so
    the phase can be rehearsed on the CPU at a tiny size."""
    import shutil

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from bert_pytorch_tpu_torch.telemetry.health import (HealthConfig,
                                                         health_update)
    from bert_pytorch_tpu_torch.training.checkpoint import (STATE_FILE,
                                                            CheckpointManager)

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_survival_")
    res = {}
    summary["survival"] = res
    try:
        args = run_pretraining.parse_arguments(
            _survival_argv(cfg_path, os.path.join(tmp, "clean"), device, micro,
                           "--skip_checkpoint", "--metrics_port", "0"))
        from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size

        config = BertConfig.from_json_file(cfg_path)
        vocab = pad_vocab_size(config.vocab_size, 8)
        layers = config.num_hidden_layers
        index = survival_index(np, vocab, micro)
        scraped = {}

        # the stall run's watchdog trips, by the step in flight
        trips = []

        def note(run):
            def out(msg):
                log(f"survival: {run}: {msg}")
                if run == "stall" and msg.startswith("step "):
                    scraped["last_step"] = int(msg.split()[1][:-1])
                if msg.startswith("WATCHDOG: phase"):
                    trips.append((scraped.get("last_step", 0) + 1, msg))
                if msg.startswith("metrics: serving /metrics"):
                    scraped["url"] = msg.split(" on ")[1].split(" ")[0]
                # the step's log line comes before its StepWatch count:
                # at step 3's, two steps are counted
                if msg.startswith("step 3:") and run != "resume":
                    scraped[run] = _scrape(scraped["url"])
            return out

        # the clean run: the main path, counts zeroed just before
        reset_launches()
        t0 = time.perf_counter()
        clean = run_pretraining.train(args, index, log=note("clean"))
        res["clean_s"] = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        summary.setdefault("launches", {})["survival"] = launches
        accum = 2
        # per microbatch the embedding and MLM-transform LayerNorms
        # (#1/#2) and every layer's two residual tails (#3/#4); per step
        # one fused LAMB update (#11/#12); the health pack launches none
        per_step = {"layer_norm_fwd": 2 * accum,
                    "layer_norm_bwd": 2 * accum,
                    "add_dropout_layer_norm_fwd": 2 * layers * accum,
                    "add_dropout_layer_norm_bwd": 2 * layers * accum,
                    "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                    "flash_attention_bwd_dq": 0,
                    "flash_attention_bwd_dkv": 0,
                    "lamb_stage1": 1, "lamb_stage2": 1}
        want = {k: v * SURVIVAL_STEPS for k, v in per_step.items()}
        if on_card:
            check(launches == want, f"launch counts {launches}, want {want}")
        losses = [h["loss"] for h in clean.history]
        check(len(losses) == SURVIVAL_STEPS and all(np.isfinite(losses)),
              f"clean run losses {losses}")
        fams = scraped.get("clean", {})
        check(fams.get("bert_train_steps_total", {}).get(
            '{phase="pretrain"}') == 2 and "bert_step_time_ms" in fams
            and "bert_nonfinite_steps_total" in fams,
            f"/metrics mid-run: {sorted(fams)}")
        with open(os.path.join(tmp, "clean",
                               args.log_prefix + ".jsonl")) as f:
            perf = [r for r in map(json.loads, f) if r["tag"] == "perf"]
        mfus = [r["mfu"] for r in perf]
        check(len(perf) == SURVIVAL_STEPS and (
            not on_card or all(0 < m < 1 for m in mfus)),
            f"perf records' mfu {mfus}")
        digest = _params_digest(torch, clean.state.params)
        # the health pack's cost a step, on the clean run's state
        state = clean.state
        hcfg = HealthConfig()
        gn = torch.ones((), device=device)
        bad = torch.zeros((), dtype=torch.bool, device=device)

        def pack():
            return health_update(hcfg, state.telemetry, gn, bad,
                                 state.params.values())

        host = []
        for _ in range(5):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            pack()
            host.append((time.perf_counter() - t0) * 1e3)
        res["health_pack"] = {"host_ms": statistics.median(host),
                              "tensors": len(state.params)}
        if on_card:
            res["health_pack"].update(_device_call_ms(torch, pack))
        del clean, state
        if on_card:
            torch.cuda.empty_cache()
        res.update(losses=losses, launches=launches,
                   launches_predicted=want, mfu=mfus,
                   metrics_families=sorted(f for f in fams
                                           if f.startswith("bert_")))
        log(f"survival: clean: {SURVIVAL_STEPS} steps, losses {losses}, "
            f"mfu {mfus}, {len(res['metrics_families'])} bert_* families "
            f"on /metrics mid-run, health pack {res['health_pack']}")

        # SIGTERM before step 3, in a process of its own
        out_s = os.path.join(tmp, "sigterm")
        t0 = time.perf_counter()
        rc, text = _child(_survival_argv(
            cfg_path, out_s, device, micro, "--chaos", "sigterm_at_step",
            "--chaos_step", "3"))
        res["sigterm_child_s"] = time.perf_counter() - t0
        check(rc == 143, f"sigterm child exited {rc}: {text[-3000:]}")
        took = [ln for ln in text.splitlines()
                if ln.startswith("preemption: emergency save of step 2")]
        check(len(took) == 1, f"no emergency save line: {text[-3000:]}")
        res["emergency_save_s"] = float(took[0].split(" took ")[1].split()[0])
        mgr = CheckpointManager(os.path.join(out_s, "pretrain_ckpts"))
        check(mgr.all_steps() == [2] and mgr.verify(2) == [],
              f"emergency checkpoint steps {mgr.all_steps()}")
        saved = torch.load(os.path.join(mgr.directory, "2", STATE_FILE),
                           map_location="cpu", weights_only=True, mmap=True)
        # the recorder's crash bundle beside the emergency save
        res["sigterm_bundles"] = _valid_bundles(os.path.join(
            out_s, "repro_bundles"), ["step00000002_systemexit"])
        check(res["sigterm_bundles"] == ["step00000002_systemexit"],
              f"SIGTERM child's bundles {res['sigterm_bundles']}")
        # the resume, health pack off, to step 4
        t0 = time.perf_counter()
        resumed = run_pretraining.train(run_pretraining.parse_arguments(
            _survival_argv(cfg_path, out_s, device, micro,
                           "--skip_checkpoint",
                           "--health_pack", "off")), index,
            log=note("resume"))
        res["resume_run_s"] = time.perf_counter() - t0
        res["restore_s"] = resumed.restore_s
        check(resumed.resumed_from == 2 and resumed.step == SURVIVAL_STEPS,
              f"resumed from {resumed.resumed_from} to {resumed.step}")
        got = [h["loss"] for h in resumed.history]
        check(got == losses[2:], f"resumed losses {got} != {losses[2:]}")
        differ = [k for k, v in _params_digest(torch, resumed.state.params)
                  .items() if digest[k] != v]
        check(not differ, f"resumed parameters differ: {differ[:5]}")
        off = resumed.state.state_dict()
        check(set(saved) == set(off) and set(saved["params"]) ==
              set(off["params"]) and set(saved["opt_state"]) ==
              set(off["opt_state"]), "checkpoint keys with the pack on and "
              "off differ")
        del resumed, off, saved
        shutil.rmtree(out_s, ignore_errors=True)
        if on_card:
            torch.cuda.empty_cache()
        log(f"survival: SIGTERM at step 3: exit 143, emergency save of step "
            f"2 in {res['emergency_save_s']:.2f} s, restore "
            f"{res['restore_s']:.1f} s, resumed steps 3-4 bit-equal to the "
            "clean run")

        # a stalled dispatch under warn, and a skipped non-finite step
        t0 = time.perf_counter()
        out_w = os.path.join(tmp, "stall")
        stall = run_pretraining.train(run_pretraining.parse_arguments(
            _survival_argv(
                cfg_path, out_w, device, micro, "--skip_checkpoint",
                "--max_steps", "3", "--metrics_port", "0",
                "--chaos", "stall_dispatch", "--chaos_step", "3",
                "--chaos_stall_secs", str(stall_s),
                "--watchdog_timeout", str(watchdog_s),
                "--watchdog_action", "warn", "--inject_nonfinite_step", "2",
                "--nonfinite_action", "skip")), index, log=note("stall"))
        res["stall_run_s"] = time.perf_counter() - t0
        stalls = scraped.get("stall", {}).get("bert_watchdog_stalls_total",
                                              {})
        # one trip, in step 3's dispatch (on the CPU a slow step may trip
        # too: every trip must then be on /metrics)
        check(any(step == 3 and "'dispatch'" in msg and "device_hang" in msg
                  for step, msg in trips) and (len(trips) == 1
                                               or not on_card)
              and stalls == {'{phase="pretrain",kind="device_hang"}':
                             float(len(trips))},
              f"watchdog trips {trips}, /metrics {stalls}")
        check(any(f.startswith("watchdog_stacks_")
                  for f in os.listdir(out_w)), "no watchdog stacks file")
        # the skipped step's bundle and the trip's (on the CPU a slow
        # step may trip before any step is recorded: an empty ring)
        want_b = ["step00000002_nonfinite",
                  "step00000002_watchdog_device_hang"]
        res["stall"] = {"bundles": _valid_bundles(os.path.join(
            out_w, "repro_bundles"), want_b)}
        check(res["stall"]["bundles"] == want_b or not on_card,
              f"stall run's bundles {res['stall']['bundles']}")
        h = stall.history
        check(h[1]["skipped_nonfinite"] == 1 and h[1]["loss_nonfinite"] == 1
              and h[1]["param_norm"] == h[0]["param_norm"]
              and h[1]["param_norm_drift"] == 0.0
              and h[2]["skipped_nonfinite"] == 0
              and np.isfinite(h[2]["loss"]),
              f"skip: {[{k: r[k] for k in ('loss', 'skipped_nonfinite', 'param_norm')} for r in h]}")
        res["stall"].update(watchdog_timeout_s=watchdog_s,
                            stall_s=stall_s, trips=len(trips),
                            stalls_on_metrics=stalls, skipped_step=2,
                            param_norm=[r["param_norm"] for r in h])
        del stall
        log(f"survival: stall_dispatch at step 3: one device_hang trip on "
            f"/metrics, stacks written; step 2's NaN skipped with the "
            f"parameters unchanged ({res['stall_run_s']:.1f} s)")

        # the recorder drill: a halt in a process of its own, with a
        # checkpoint at step 1; its bundle validates, replays step 2 and
        # bisects it in a process of its own
        t0 = time.perf_counter()
        rc, text = _child(_survival_argv(
            cfg_path, os.path.join(tmp, "halt"), device, micro,
            "--num_steps_per_checkpoint", "1",
            "--inject_nonfinite_step", "2", "--nonfinite_action", "halt"))
        res["halt_child_s"] = time.perf_counter() - t0
        check(rc == 71 and "FATAL: non-finite loss/gradients at step 2"
              in text and "; repro bundle: " in text,
              f"halt child exited {rc}: {text[-3000:]}")
        bundle = text.split("; repro bundle: ")[1].split()[0]
        res["halt_bundle"] = os.path.basename(bundle)
        check(_valid_bundles(os.path.dirname(bundle),
                             ["step00000002_nonfinite"])
              == ["step00000002_nonfinite"], f"halt bundle {bundle}")
        log(f"survival: --nonfinite_action halt: exit 71 "
            f"({res['halt_child_s']:.1f} s), bundle {bundle} validates")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "bert_pytorch_tpu_torch.tools.replay",
                            "--bundle", bundle, "--bisect", "--device",
                            device], cwd=HERE, capture_output=True,
                           text=True, timeout=600)
        res["replay_s"] = time.perf_counter() - t0
        out = r.stdout + r.stderr
        res["replay"] = [ln for ln in out.splitlines()
                         if ln.startswith(("step ", "bisect:"))]
        log(f"survival: replay --bisect: exit {r.returncode} "
            f"({res['replay_s']:.1f} s): {res['replay']}")
        check(r.returncode == 0 and "step 2 (from checkpoint 1): "
              "REPRODUCED bit-identically" in out
              and "bisect: first non-finite tensor in scope "
              "'layer_0/attention' (microbatch 0)" in out,
              f"replay exited {r.returncode}: {out[-3000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _line_numbers(r: dict) -> dict:
    out = {k: r.get(k) for k in _LINE_KEYS}
    out.update({k: r[k] for k in _EXTRA_KEYS if k in r})
    out["rate"] = out["rate"] or 0.0
    out["max_abs_err"] = r.get("max_abs_err", {}).get(
        r.get("dtype") or "bfloat16")
    return out


def kernels_line(results: dict, by_path: dict, in_checks: dict) -> list:
    """One row a kernel: its launches on each main path (counts zeroed
    just before the path and read just after), the launches the kernels
    phase made to hold it against its plain version (`launches_in_checks`,
    not part of `launches`), and its measured numbers. The flash forward
    runs at two shapes and rates (serving, rate 0; phase-2 training, rate
    0.1, its dropout arm): its row carries the training numbers, the arm of
    the slice that launches it most, and both under `variants`. The
    LayerNorm backwards carry phase 1's (12288, 1024), and both phases'
    under `variants`. The dq and dk/dv pair carry phase 2's (16, 512) in
    bf16, and under `variants` also (8, 1024), (4, 2048) and f32. The
    flash forward and the fused backward also carry SQuAD finetuning's
    (32, 384) under `variants` ("finetune_squad")."""
    line = []
    for name, row in KERNEL_ROWS.items():
        counts = {path: c[name] for path, c in by_path.items()}
        r = results.get(name, {})
        nums = _line_numbers(r)
        variants = {}
        if "train_phase2" in r:
            variants = {"serve": nums,
                        "train_phase2": _line_numbers(r["train_phase2"])}
            nums = variants["train_phase2"]
        elif "phase2" in r:
            variants = {"train": nums,
                        "train_phase2": _line_numbers(
                            dict(r["phase2"],
                                 max_abs_err=r.get("max_abs_err", {})))}
        elif any(v in r for v in _PAIR_VARIANTS):
            variants = {"train_phase2_shape": nums}
            variants.update({v: _line_numbers(
                dict(r[v], max_abs_err=r.get("max_abs_err", {})
                     if v == "float32" else r[v].get("max_abs_err", {})))
                for v in _PAIR_VARIANTS if v in r})
        # SQuAD finetuning's (32, 384): the flash forward and the fused
        # backward, timed beside the phase-2 numbers
        if "ms" in r.get("finetune_squad", {}):
            variants = variants or {"train_phase2": nums}
            variants["finetune_squad"] = _line_numbers(r["finetune_squad"])
        # the distilled student's shapes: the LayerNorms at width 768,
        # the flash kernels at 12 heads
        for key in ("distill", "distill_squad"):
            if "ms" in r.get(key, {}):
                variants = variants or {"main": nums}
                variants[key] = _line_numbers(r[key])
        line.append(dict(row, name=name, launches=sum(counts.values()),
                         launches_by_path=counts,
                         launches_in_checks=in_checks.get(name), **nums,
                         **({"variants": variants} if variants else {})))
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:2] == ["--pretrain_child", "--"]:
        return pretrain_child(argv[2:])
    if argv[:1] == ["--dp_child"]:
        return dp_child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="device,build,kernels,timing,model_seq1024,"
                            "serve,train_order,train,train_phase2,"
                            "train_kfac,train_roberta,train_packed,"
                            "train_packed_phase2,train_dp,train_chunks,"
                            "pipeline,"
                            "stream,remat,"
                            "finetune_squad,finetune_ner,finetune_tasks,"
                            "serve_slo,finetune_packed,distill,"
                            "init_sources,survival",
                    help="comma-separated subset, in order (development)")
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json")
    ap.add_argument("--grad_probe", default=None, metavar="PATH",
                    help="only run the train_order phase's gradient probe "
                         "and write its JSON to PATH")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import bert_pytorch_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.grad_probe:
        from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels

        load_kernels()
        with open(args.grad_probe, "w") as f:
            json.dump(grad_probe(torch, np), f)
        return 0
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    import importlib.util

    has_h5py = importlib.util.find_spec("h5py") is not None
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]} | "
        f"{torch.cuda.device_count()} card(s) | peaks {peaks} | h5py "
        f"{'present' if has_h5py else 'absent'}")
    results = {}
    summary = {"device": smi, "kind": kind, "peaks": peaks,
               "phases": {}, "kernels": results}
    ok = True
    # phase 1's checkpoints, which phase 2 resumes (~4 GB each at
    # BERT-Large, 2 kept), and train_dp's at CUT_LAYERS, which train_chunks
    # and finetune_tasks start from, removed when the script ends
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ok = run_phases(torch, np, phases, summary, results, peaks, ckpt_dir)
    finally:
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(summary, f, indent=1, default=str)
    if not ok:
        log("chip_smoke: FAILED: " + json.dumps(summary["phases"]))
        return 1
    try:
        line = kernels_line(results, summary.get("launches", {}),
                            summary.get("launches_in_checks", {}))
    except PhaseError as e:
        log(f"chip_smoke: FAILED: kernels line: {e}")
        return 1
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# finetune_packed, distill, init_sources, survival, the packed
# pretraining phases, the stream phase's drills and train_kfac's replay
# and card-vs-CPU step, whose checks hold at any depth, run BERT-Large's
# width at CUT_LAYERS layers (the checkpoints they write and read, 4 GB
# each at 24 layers, dominate several), so that the whole script stays
# inside its time limit on a slow host: every phase took 1157 s in one
# call and 971 s in another with the first four at 24 layers, and 1219.8
# s at 12 once the K-FAC, chunk and RoBERTa legs came (PERF.md).
CUT_LAYERS = 6
# the stream phase's planes at half BERT-Large's depth (they ran at 24
# before train_dp came, whose time this won back with the train_chunks
# and finetune_tasks cuts): its checks hold at any depth; its step times,
# idle shares and data_wait shares are not comparable with 24 layers
STREAM_LAYERS = 12
# distill's teacher: deeper than its 6-layer student, whose checkpoint
# must be refused under the teacher's config with the depth mismatch
DISTILL_TEACHER_LAYERS = 8


def cut_config(directory: str, layers: int = CUT_LAYERS) -> str:
    """BERT-Large's model config at `layers` layers, written into
    `directory`; returns its path."""
    with open(os.path.join(HERE, "configs",
                           "bert_large_uncased_config.json")) as f:
        cfg = json.load(f)
    cfg["num_hidden_layers"] = layers
    path = os.path.join(directory, f"bert_large_{layers}l_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_phases(torch, np, phases, summary, results, peaks, ckpt_dir) -> bool:
    """Run each phase in order, report each; False if any failed."""
    ok = True
    cut = {"cfg_path": cut_config(ckpt_dir)}
    for phase in phases:
        t0 = time.perf_counter()
        try:
            if phase == "device":
                pass
            elif phase == "build":
                from bert_pytorch_tpu_torch.ops.kernels.build import (
                    load_kernels)

                ptxas = ptxas_start()
                natives = native_build_start()
                try:
                    load_kernels()
                finally:
                    summary["ptxas"] = ptxas_check(*ptxas)
                summary["build_s"] = time.perf_counter() - t0
                summary["native_build_s"] = native_build_wait(natives)
                log(f"build: kernels built in {summary['build_s']:.1f} s; "
                    f"the native tokenizer libraries beside them in "
                    f"{summary['native_build_s']} s")
                summary["fused_bwd_build"] = fused_backward_build(torch)
                summary["fwd_build"] = forward_build(torch)
                summary["split_bwd_build"] = split_backward_build(torch)
            elif phase == "kernels":
                from bert_pytorch_tpu_torch.ops.kernels import (
                    LAUNCHES, reset_launches)

                reset_launches()
                phase_kernels(torch, np, results)
                summary["launches_in_checks"] = dict(LAUNCHES)
            elif phase == "timing":
                phase_timing(torch, np, results, peaks)
            elif phase == "model_seq1024":
                phase_model_seq1024(torch, np, summary)
            elif phase == "serve":
                phase_serve(torch, np, summary)
            elif phase == "train_order":
                phase_train_order(torch, np, summary)
            elif phase in TRAIN_RUNS:
                phase_train(torch, np, summary, run=phase, ckpt_dir=ckpt_dir)
            elif phase == "train_chunks":
                phase_train_chunks(torch, np, summary, **cut)
            elif phase == "train_kfac":
                phase_train_kfac(torch, np, summary,
                                 cut_cfg_path=cut["cfg_path"])
            elif phase == "train_roberta":
                phase_train_roberta(torch, np, summary)
            elif phase in PACKED_RUNS:
                phase_train_packed(torch, np, summary, run=phase, **cut)
            elif phase == "train_dp":
                phase_train_dp(torch, np, summary, keep=os.path.join(
                    ckpt_dir, "dp_pretrain_ckpts"), **cut)
            elif phase == "pipeline":
                phase_pipeline(torch, np, summary,
                               cut_cfg_path=cut["cfg_path"])
            elif phase == "stream":
                phase_stream(torch, np, summary,
                             cfg_path=cut_config(ckpt_dir, STREAM_LAYERS),
                             cut_cfg_path=cut["cfg_path"])
            elif phase == "remat":
                phase_remat(torch, np, summary)
            elif phase == "finetune_squad":
                phase_finetune_squad(torch, np, summary, ckpt_dir=ckpt_dir)
            elif phase == "finetune_ner":
                phase_finetune_ner(torch, np, summary)
            elif phase == "finetune_tasks":
                phase_finetune_tasks(torch, np, summary, **cut)
            elif phase == "serve_slo":
                phase_serve_slo(torch, np, summary)
            elif phase == "finetune_packed":
                phase_finetune_packed(torch, np, summary, **cut)
            elif phase == "distill":
                phase_distill(torch, np, summary, cfg_path=cut_config(
                    ckpt_dir, DISTILL_TEACHER_LAYERS))
            elif phase == "init_sources":
                phase_init_sources(torch, np, summary, **cut)
            elif phase == "survival":
                phase_survival(torch, np, summary, **cut)
            else:
                raise PhaseError(f"unknown phase {phase!r}")
            torch.cuda.synchronize()
            summary["phases"][phase] = "ok"
            summary.setdefault("phase_s", {})[phase] = round(
                time.perf_counter() - t0, 1)
        except Exception as e:  # report every phase, then fail the run
            import traceback

            traceback.print_exc()
            summary["phases"][phase] = f"FAILED: {type(e).__name__}: {e}"
            ok = False
        log(f"phase {phase}: {summary['phases'][phase]} "
            f"({time.perf_counter() - t0:.1f} s)")
    return ok


if __name__ == "__main__":
    sys.exit(main())
