#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (bert_pytorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --out DIR       # also write the results to DIR

Phases, each of which must pass:

1. device   the card's name and power limit (nvidia-smi) and the versions;
2. build    the CUDA kernels, from this checkout's sources, timed;
3. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, in f32 and bf16, at the shapes the serving path gives it
            (LayerNorm at (8 * bucket, 1024) for every bucket; flash
            attention at (8, 512, 16, 64) with a padding bias and packed
            segments, and at S = 1024), with the tolerances below; the
            segment tile skip must fire as often as the layout predicts and
            pad rows must come out exactly zero;
4. timing   each kernel, its plain version and the PyTorch library call
            that computes the same function (timed here as a yardstick, used
            nowhere in the port), by CUDA events, L2 flushed before each
            launch, median of repeats; and the least time the card could
            take (bytes over the memory rate or operations over the peak
            rate, whichever is larger);
5. serve    a seeded random BERT-Large QA checkpoint (24 layers, full
            width) served by bert_pytorch_tpu_torch.run_server.serve with
            the default buckets 64/128/256/512, 8 rows, 8 segments, packing
            on, bf16: SQuAD requests over HTTP, one of them in the 512
            bucket, each answered 200 with a span of its context; the launch
            counts, zeroed just before, show every forward went through the
            kernels; one packed 512 batch of the engine is held against the
            same weights run with the plain versions.

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
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4
# Whole BERT-Large forward with the kernels against the plain versions:
# in bf16, 24 layers of bf16-rounded differences on logits whose spread
# with random weights is ~0.15; in f32, 24 layers of f32 rounding-order
# differences.
MODEL_TOL = 0.1
MODEL_TOL_F32 = 1e-3


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
    256 MB write before every launch: median of `reps` launches, ms."""

    def __init__(self, torch, reps: int = 25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
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
        FLASH_TILES, flash_attention, flash_attention_ref,
        make_attention_bias)
    from bert_pytorch_tpu_torch.ops.layernorm import (layer_norm_fwd,
                                                      layer_norm_stats_ref)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ln_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        worst = 0.0
        for bucket in BUCKETS:
            rows = BATCH_ROWS * bucket
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
            want_skips = expected_skips(np, seg_np, *FLASH_TILES[dtype],
                                        HEADS)
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


def phase_timing(torch, np, results, peaks):
    import torch.nn.functional as F

    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_ref, make_attention_bias,
        make_segment_attention_bias)
    from bert_pytorch_tpu_torch.ops.layernorm import (layer_norm_fwd,
                                                      layer_norm_ref)

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bw = peaks["bytes_per_s"]

    # LayerNorm at the 512 bucket, bf16 (the serving dtype)
    rows = BATCH_ROWS * 512
    x = torch.randn(rows, HIDDEN, generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = torch.ones(HIDDEN, device="cuda")
    bias = torch.zeros(HIDDEN, device="cuda")
    scale16, bias16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    nbytes = 2 * rows * HIDDEN * 2 + 2 * HIDDEN * 4 + 2 * rows * 4
    nops = 8 * rows * HIDDEN
    bound = max(nbytes / bw, nops / peaks["f32_flops"]) * 1e3
    results["layer_norm_fwd"].update({
        "shape": [rows, HIDDEN], "dtype": "bfloat16",
        "ms": timer(lambda: layer_norm_fwd(x, scale, bias)),
        "plain_ms": timer(lambda: layer_norm_ref(x, scale, bias)),
        "library_ms": timer(lambda: F.layer_norm(x, (HIDDEN,), scale16,
                                                 bias16, 1e-12)),
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
        "ms": timer(lambda: flash_attention(q, k, v, pad_bias, seg)),
        "plain_ms": timer(lambda: flash_attention_ref(q, k, v, pad_bias,
                                                      seg)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "operations": nops,
        "dense_operations": 4 * HEAD_DIM * batch * seq * seq * HEADS})
    for name in ("layer_norm_fwd", "flash_attention_fwd"):
        r = results[name]
        log(f"timing: {name} {r['shape']} {r['dtype']}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")


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


def _post(url: str, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(url + "/v1/squad",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _profile_forward(torch, engine, batch):
    """Device time of one 512 forward by kernel class (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.forward("squad", batch)
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
        if "layer_norm_fwd_kernel" in name:
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
    """The serving run. `device` and `cfg_path` exist so the phase can be
    rehearsed on the CPU at a tiny size; the script itself always runs
    BERT-Large on CUDA."""
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
    from bert_pytorch_tpu_torch.tasks import predict

    config = BertConfig.from_json_file(cfg_path)
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    layers = config.num_hidden_layers
    rng = np.random.RandomState(0)
    # contexts of 42-96 tokens (64 / 128 buckets), 194 (256), 422 (512)
    contexts = [_context(rng, n) for n in (30, 45, 80, 170, 380)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    handle = None
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                              + sorted(set(" ".join(QUESTIONS + tuple(
                                  contexts)).split()))) + "\n")
        t0 = time.perf_counter()
        with torch.device(device):
            model = BertForQuestionAnswering(config)
        init_weights(model, torch.Generator(device=device).manual_seed(0))
        ckpt = os.path.join(tmp, "squad_large.pt")
        torch.save(model.state_dict(), ckpt)
        n_params = sum(p.numel() for p in model.parameters())
        del model
        log(f"serve: seeded random BERT-Large QA checkpoint ({n_params} "
            f"params, {layers} layers) written in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        args = run_server.parse_arguments([
            "--model_config_file", cfg_path, "--vocab_file", vocab,
            "--task_checkpoint", f"squad={ckpt}", "--port", "0",
            "--host", "127.0.0.1", "--device", device])
        handle = run_server.serve(args, log=lambda m: log("serve: " + m))
        engine = handle.engine
        summary["serve_start_s"] = time.perf_counter() - t0
        check(engine.buckets == BUCKETS and engine.batch_rows == BATCH_ROWS
              and engine.max_segments == 8, "server defaults changed")

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
        summary["launches"] = launches
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
    finally:
        if handle is not None:
            handle.close()
        shutil.rmtree(tmp, ignore_errors=True)


KERNEL_ROWS = {
    "layer_norm_fwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/layernorm.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/layernorm.py:93"},
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "bert_pytorch_tpu_torch/ops/kernels/csrc/"
                  "flash_attention.cu",
        "replaces": "bert_pytorch_tpu/ops/pallas/flash_attention.py:660"},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,timing,serve",
                    help="comma-separated subset, in order (development)")
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json")
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
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]} | "
        f"{torch.cuda.device_count()} card(s) | peaks {peaks}")
    results = {}
    summary = {"device": smi, "kind": kind, "peaks": peaks,
               "phases": {}, "kernels": results}
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        try:
            if phase == "device":
                pass
            elif phase == "build":
                from bert_pytorch_tpu_torch.ops.kernels.build import (
                    load_kernels)

                load_kernels()
                summary["build_s"] = time.perf_counter() - t0
                log(f"build: kernels built in {summary['build_s']:.1f} s")
            elif phase == "kernels":
                phase_kernels(torch, np, results)
            elif phase == "timing":
                phase_timing(torch, np, results, peaks)
            elif phase == "serve":
                phase_serve(torch, np, summary)
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

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(summary, f, indent=1, default=str)
    if not ok:
        log("chip_smoke: FAILED: " + json.dumps(summary["phases"]))
        return 1
    launches = summary.get("launches", {})
    line = []
    for name, row in KERNEL_ROWS.items():
        r = results.get(name, {})
        line.append(dict(row, name=name,
                         launches=launches.get(name),
                         max_abs_err=r.get("max_abs_err", {}).get("bfloat16"),
                         ms=r.get("ms"), plain_ms=r.get("plain_ms"),
                         bound_ms=r.get("bound_ms"),
                         bound_by=r.get("bound_by"),
                         library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
