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
            the pair's kernels, whose registers it lists;
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
            gradient norms; the last checkpoint read back bit-equal; one
            optimizer step profiled, the step and one LAMB update timed on
            the kernels and on route off; one microbatch through the
            kernels held against the plain versions (f32 and bf16 loss and
            gradients);
9. train_phase2  the same for phase 2: 3 steps under the phase-2 run
            config (microbatch 16 x 512, 80 predictions, accumulation 2),
            where attention runs the flash forward with dropout and the
            fused flash backward (no launch of the split pair); it
            auto-resumes phase 1's last checkpoint
            (previous_phase_end_step set to 3 for it) and must continue
            from step 3 with phase 1's LAMB state;
10. finetune_squad  SQuAD v1.1 finetuning by the entry point's run_task
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
11. finetune_ner  CoNLL NER finetuning, 3 steps of 32 x 128 (plain
            attention, the LayerNorm kernels) on a synthetic CoNLL-2003
            file, val and test macro F1, the checkpoint, exact launch
            counts, one step profiled and timed;
12. finetune_tasks  classify, choice and embed finetuning, one after the
            other: BERT-Large from phase 2's last checkpoint, 3 steps of
            16 x 128 (choice 16 x 4 x 128) at the JAX base parser's recipe
            on synthetic TSV / JSONL files, val and test accuracy, embed's
            embedding norms, exact launch counts, the checkpoint answered
            by the server and deleted, one step profiled and timed, and a
            classify and a choice microbatch through the kernels against
            the plain versions.

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
scaled_dot_product_attention.
The launches the kernels phase makes for its checks are reported apart
from the main paths' (`launches_in_checks`). It holds the fused LAMB stages
(#11, #12) against their plain versions bit for bit over BERT-Large's 302
parameter tensors and a list of odd sizes and misaligned views, and the
timing phase times them over the 302 tensors.

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
                                 lo=None, key="train_phase2"):
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
    that key."""
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
        qkv = torch.randn(batch, seq, 3, HEADS, HEAD_DIM, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(batch, seq, HEADS, HEAD_DIM, generator=gen,
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
            log(f"kernels: flash_attention {name} ({batch}, {seq}, {HEADS}, "
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
        zeros = torch.zeros(batch, seq, HEADS, HEAD_DIM, device="cuda",
                            dtype=dtype)
        win = [(64 * b) % seq for b in range(batch)]
        allow = torch.zeros(batch, seq, device="cuda")
        for b, w in enumerate(win):
            allow[b, w:w + 64] = 1
        wbias = ((1.0 - allow) * -10000.0)[:, None, None, :].contiguous()
        pos = torch.arange(seq, device="cuda")
        onehot = (pos[:, None] % 64 == torch.arange(HEAD_DIM, device="cuda"))
        vp = onehot[None, :, None, :].expand(batch, seq, HEADS,
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
        keep = flash_keep_all(seed, batch, HEADS, seq, rate, "cuda")
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
            f"reads {dropped[0]} dropped of {batch * HEADS * seq * 64}, "
            f"equal to flash_keep_mask: {fwd_ok}; dv reads {dropped[1]} "
            f"dropped of {batch * HEADS * 64 * 64}, equal: {dv_ok}")
        check(fwd_ok and all(dv_ok.values()), f"flash {name}: the mask "
              f"read from the kernels differs from flash_keep_mask "
              f"(forward {fwd_ok}, dv {dv_ok})")
        probes[name] = {"forward_dropped": dropped[0],
                        "dv_dropped": dropped[1],
                        "dv_kernels": sorted(dvs)}
    results["flash_attention_fwd"][key] = {
        "max_abs_err": fwd_err, "mask_probes": probes,
        "shape": [batch, seq, HEADS, HEAD_DIM]}
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
        want_skips = expected_skips(np, seg_np, *tile, HEADS)
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
    training path's), the same with f32 gradients, and the odd list; stage
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
            ("odd sizes and views", odd_lamb_state, torch.bfloat16),
            ("odd sizes and views", odd_lamb_state, torch.float32)):
        name = str(g_dtype).split(".")[-1]
        st = make(torch, gen, g_dtype)
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


def time_flash_training_kernels(torch, np, results, peaks, timer,
                                shape=PHASE2_ATTN, lo=None,
                                key="train_phase2"):
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
    qkv = torch.randn(batch, seq, 3, HEADS, HEAD_DIM, generator=gen,
                      device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(batch, seq, HEADS, HEAD_DIM, generator=gen,
                     device="cuda").to(bf)
    out, lse = flash_attention(q, k, v, bias, None, seed, rate)
    _, delta = flash_attention_bwd_dq(q, k, v, bias, None, out, lse, do,
                                      seed, rate)
    tensor = batch * seq * HEADS * HEAD_DIM * 2
    rows_f32 = batch * HEADS * seq * 4          # lse or delta
    bias_bytes = batch * seq * 4
    product = 2 * batch * HEADS * seq * seq * HEAD_DIM

    def row(nbytes, nops, **kw):
        t_bytes = nbytes / peaks["bytes_per_s"]
        t_ops = nops / peaks["bf16_flops"]
        return dict(kw, shape=[batch, seq, HEADS, HEAD_DIM],
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
# for LOAD_RAMP_S seconds, stopping where p99 passes LOAD_BOUND_MS), and the
# client: bert_pytorch_tpu_torch/tools/serve_load.py in its own process
LOAD_RATE, LOAD_S = 100.0, 30.0
LOAD_RAMP = (40, 60, 80, 100, 120, 140, 160, 200)
LOAD_RAMP_S, LOAD_BOUND_MS = 6.0, 1000.0
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
    proc = subprocess.run(
        [sys.executable, SERVE_LOAD, "--url", handle.url, "--rate",
         str(rate), "--duration", str(secs), "--ramp", ramp,
         "--ramp_duration", str(LOAD_RAMP_S), "--bound_ms",
         str(LOAD_BOUND_MS), "--vocab", vocab], capture_output=True,
        text=True, timeout=900)
    check(proc.returncode == 0, f"serve_load exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    fixed = res["fixed"]
    check(fixed["ok"] == fixed["sent"] > 0, f"fixed load: {fixed['ok']} of "
          f"{fixed['sent']} answered 200 ({fixed['codes']})")
    log(f"serve: load {rate:g} req/s for {secs:g} s: {fixed['sent']} sent, "
        f"p50 {fixed['p50_ms']:.2f} ms, p99 {fixed['p99_ms']:.2f} ms (by "
        f"route {fixed['by_route']}; the slowest traces' spans "
        f"{fixed['slowest_traces']}; featurization ms a request, one "
        f"thread {res.get('featurize_ms')}); ramp "
        + ", ".join(f"{r['rate']:g}: p99 {r['p99_ms']}" for r in res["ramp"])
        + f"; p99 passes {LOAD_BOUND_MS:g} ms at "
        f"{res['p99_passes_bound_at']} req/s")
    return res


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

    return ArrayIndex()


def _device_ms(ev, self_only=False) -> float:
    """Device time of a profiler event average, in ms."""
    key = "self_device_time_total" if self_only else "device_time_total"
    us = getattr(ev, key, None)
    if us is None:
        us = getattr(ev, key.replace("device", "cuda"), 0)
    return (us or 0) / 1e3


def _profile_step(torch, step_fn, state, batch, seeds):
    """One optimizer step under torch.profiler: device time by kernel
    class, by the PyTorch op that launched it (top 12), and the step's own
    host-clock ms between two synchronizations, profiler on."""
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
    return (dict(sorted(classes.items(), key=lambda kv: -kv[1])), top,
            wall_ms)


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
    from bert_pytorch_tpu_torch.training.pretrain import (
        compute_params, pretrain_loss_and_grads)

    with torch.device(device):
        model = BertForPreTraining(config, dtype=dtype, plain=plain)
    model.load_state_dict(weights)
    grad_dtype = torch.bfloat16 if dtype == torch.bfloat16 else None
    gparams = compute_params(dict(model.named_parameters()), grad_dtype)
    loss, _, grads = pretrain_loss_and_grads(model, gparams, micro, seeds,
                                             max_pred)
    return loss.item(), {k: g.float() for k, g in grads.items()}


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

# ROADMAP queue C item 1: step 1's gradients of phase 1 in two fresh
# processes and in this one after the phases before it (serve, by default)
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
    """ROADMAP queue C item 1: `grad_probe` in two fresh processes and in
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
            "--vocab_pad_multiple", "8", "--seed", "0", "--device", device])
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
            classes, top, prof_ms = _profile_step(torch, step_fn, state,
                                                  batch, seeds)
            train["step_split"] = {"step_ms": step_ms,
                                   "forward_backward_ms": fb_ms,
                                   "lamb_ms": lamb_ms,
                                   "step_ms_by_route": step_runs,
                                   "lamb_ms_by_route": lamb_runs}
            device_total = sum(classes.values())
            # one stream: the card is idle for the rest of that same step
            idle = 1.0 - device_total / prof_ms
            check(idle >= 0.0, f"{run}: device time {device_total} ms "
                  f"exceeds the profiled step's {prof_ms} ms")
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


def _finetune_step_numbers(torch, run, state, batch, seeds, on_card, what):
    """The step of a finished run_task again on its state: one step
    profiled (device ms by class, idle share), the host clock of a step
    (median of 3) and of one optimizer update."""
    from bert_pytorch_tpu_torch.optim.lamb import global_norm_f32
    from bert_pytorch_tpu_torch.training.pretrain import (
        build_pretrain_step, compute_params, loss_and_grads)

    step_fn = build_pretrain_step(run.model, run.tx, schedule=run.schedule,
                                  accum_steps=run.accum_steps,
                                  loss_fn_builder=run.loss_builder)
    step_fn(state, batch, seeds)["loss"].item()   # warm
    out = {}
    if not on_card:
        return out
    out["step_ms"] = _host_ms(torch, lambda: step_fn(state, batch, seeds))
    gparams = compute_params(state.params, None)
    grads = loss_and_grads(run.loss_builder(run.model), gparams,
                           {k: v[0] for k, v in batch.items()}, seeds[0])[2]
    # the update as the step pays for it: given the norm the step has
    norm = global_norm_f32(list(grads.values()))
    out["optimizer_ms"] = _host_ms(torch, lambda: run.tx.update(
        grads, state.opt_state, state.params, grad_norm=norm))
    del grads, gparams
    classes, top, prof_ms = _profile_step(torch, step_fn, state, batch, seeds)
    device_total = sum(classes.values())
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
        loaded = [ln for ln in lines if ln.startswith("init_checkpoint: "
                                                      "loaded")]
        check(loaded == [f"init_checkpoint: loaded {n_params - 2} parameters"
                         f" from {os.path.join(ckpt_dir, 'pretrain_ckpts')} "
                         f"step {prev['step']}"],
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
                         ckpt_dir=None, batch=TASK_TRAIN[0]):
    """classify, choice and embed finetuning of `cfg_path`'s model
    (BERT-Large, 24 layers, full width, vocab padded to 30528) by the
    entry point's run_task, one after the other: seeded from
    train_phase2's last checkpoint when that phase ran (else random
    weights from the seed), FINETUNE_STEPS steps of `batch` x 128 at the
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
    prev = summary.get("train_phase2", {}).get("checkpoint")
    pretrain = (None if prev is None or ckpt_dir is None
                else os.path.join(ckpt_dir, "pretrain_ckpts"))
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
                          if ln.startswith("init_checkpoint: loaded")]
                check(loaded == [f"init_checkpoint: loaded "
                                 f"{len(state.params) - 2} parameters from "
                                 f"{pretrain} step {prev['step']}"],
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
        line.append(dict(row, name=name, launches=sum(counts.values()),
                         launches_by_path=counts,
                         launches_in_checks=in_checks.get(name), **nums,
                         **({"variants": variants} if variants else {})))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="device,build,kernels,timing,model_seq1024,"
                            "serve,train_order,train,train_phase2,"
                            "finetune_squad,finetune_ner,finetune_tasks",
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
    # BERT-Large, 2 kept), removed when the script ends
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


def run_phases(torch, np, phases, summary, results, peaks, ckpt_dir) -> bool:
    """Run each phase in order, report each; False if any failed."""
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        try:
            if phase == "device":
                pass
            elif phase == "build":
                from bert_pytorch_tpu_torch.ops.kernels.build import (
                    load_kernels)

                ptxas = ptxas_start()
                try:
                    load_kernels()
                finally:
                    summary["ptxas"] = ptxas_check(*ptxas)
                summary["build_s"] = time.perf_counter() - t0
                log(f"build: kernels built in {summary['build_s']:.1f} s")
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
            elif phase == "finetune_squad":
                phase_finetune_squad(torch, np, summary, ckpt_dir=ckpt_dir)
            elif phase == "finetune_ner":
                phase_finetune_ner(torch, np, summary)
            elif phase == "finetune_tasks":
                phase_finetune_tasks(torch, np, summary, ckpt_dir=ckpt_dir)
            else:
                raise PhaseError(f"unknown phase {phase!r}")
            torch.cuda.synchronize()
            summary["phases"][phase] = "ok"
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
