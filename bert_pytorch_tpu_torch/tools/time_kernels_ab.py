#!/usr/bin/env python3
"""Time the LayerNorm and flash kernels of two checkouts on one card.

    python3 bert_pytorch_tpu_torch/tools/time_kernels_ab.py --parent DIR \
        [--out FILE]

DIR is another checkout of the repo, e.g. the parent commit unpacked by
`git archive` into a directory that .gitignore lists. The script runs one
process a turn, in the order parent, this, this, parent. Each process
imports the kernel wrappers of its own checkout, which build that
checkout's kernels from its sources at first use, and times them on the
same seeded inputs at chip_smoke.py's timing shapes with chip_smoke.Timer
(CUDA events, L2 flushed before each launch, median of 25 launches):

- `ms`: the device's time alone (`hide_host`), as chip_smoke.py times
  every row;
- `host_ms`: the call's host work included, as chip_smoke.py timed the
  forward rows before it hid the host work.

The kernels: the forwards (#1, #3, #5/#6) at chip_smoke.py's timing
shapes, the LayerNorm backwards (#2, and #4 at rate 0.1) at phase 1's
(12288, 1024) and phase 2's (8192, 1024) bf16 rows, and the flash
backward's dq and dk/dv pair (#9/#10, bf16, a padding bias, rate 0.1) at
(16, 512), (8, 1024) and (4, 2048) x 16 heads x 64. A backward is two
launches, the row pass and the column pass of its cross-row sums; each
backward row also carries the device time of each launch (`row_ms`,
`column_ms`: chip_smoke.launch_split, torch.profiler's mean over the
launches of 25 calls, L2 flushed before each, kernels told apart by name:
`column_sum` in it, or `ln_bwd` without it).

Each turn also times the library yardsticks (F.layer_norm, SDPA with the
same float mask, native_layer_norm_backward for #2) the same two ways.
The script prints one JSON line a turn and, last, one JSON object with each tree's mean of its two turns,
the card's name and power limit, and the integer-issue floor of the flash
forward's dropout arm: 7 32-bit integer operations a score (the hash
split into row and column terms: an xor, two multiplies, a shift and an
xor, the compare and the select) over the SMs' 64 INT32 lanes at the
card's highest SM clock.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# ops a score of the forward's dropout hash, split into row and column terms
HASH_OPS = 7


def _chip_smoke():
    """chip_smoke.py of this checkout (its Timer, shapes and inputs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(tree: str) -> dict:
    """One turn: the kernels of the checkout at `tree`."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import bert_pytorch_tpu_torch
    from bert_pytorch_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        make_attention_bias, make_segment_attention_bias)
    from bert_pytorch_tpu_torch.ops.layernorm import (
        add_dropout_layer_norm_bwd, add_dropout_layer_norm_fwd,
        layer_norm_bwd, layer_norm_fwd)

    pkg = os.path.dirname(os.path.abspath(bert_pytorch_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise RuntimeError(f"imported the port from {pkg}, not from {tree}")
    cs = _chip_smoke()
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    rows = {}

    def both(name, mine, lib=None, **shape):
        rows[name] = dict(shape, ms=timer(mine, hide_host=True),
                          host_ms=timer(mine))
        if lib is not None:
            rows[name].update(library_ms=timer(lib, hide_host=True),
                              library_host_ms=timer(lib))

    # 1: LayerNorm at the 512 bucket, f32 scale and bias (F.layer_norm
    # takes them in bf16, the dtype of x)
    n = cs.BATCH_ROWS * 512
    x = torch.randn(n, cs.HIDDEN, generator=gen, device="cuda").to(bf)
    scale = 1.0 + 0.1 * torch.randn(cs.HIDDEN, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(cs.HIDDEN, generator=gen, device="cuda")
    scale16, bias16 = scale.to(bf), bias.to(bf)
    both("layer_norm_fwd", lambda: layer_norm_fwd(x, scale, bias),
         lambda: F.layer_norm(x, (cs.HIDDEN,), scale16, bias16, 1e-12),
         shape=[n, cs.HIDDEN])

    # 3: the residual arm at phase 1's rows, rate 0.1
    n = cs.TRAIN_ROWS[0]
    x = torch.randn(n, cs.HIDDEN, generator=gen, device="cuda").to(bf)
    res = torch.randn(n, cs.HIDDEN, generator=gen, device="cuda").to(bf)
    ones, zeros = torch.ones(cs.HIDDEN, device="cuda"), torch.zeros(
        cs.HIDDEN, device="cuda")
    both("add_dropout_layer_norm_fwd", lambda: add_dropout_layer_norm_fwd(
        x, res, ones, zeros, cs.FLASH_SEEDS[0], 0.1), shape=[n, cs.HIDDEN],
        rate=0.1)

    # 2 and 4 (rate 0.1) at phase 1's and phase 2's rows, from the kernel
    # forward's statistics; native_layer_norm_backward takes scale in the
    # dtype of x
    scale = 1.0 + 0.2 * torch.randn(cs.HIDDEN, generator=gen, device="cuda")
    scale16 = scale.to(bf)
    for tag, n in (("", cs.TRAIN_ROWS[0]), ("_phase2", cs.PHASE2_LN_ROWS)):
        x = torch.randn(n, cs.HIDDEN, generator=gen, device="cuda").to(bf)
        res = torch.randn(n, cs.HIDDEN, generator=gen, device="cuda").to(bf)
        g = torch.randn(n, cs.HIDDEN, generator=gen, device="cuda").to(bf)
        _, mean, rstd = layer_norm_fwd(x, scale, zeros)
        ln = lambda: layer_norm_bwd(x, scale, mean, rstd, g)  # noqa: E731
        both("layer_norm_bwd" + tag, ln,
             lambda: torch.ops.aten.native_layer_norm_backward(
                 g, x, [cs.HIDDEN], mean[:, None], rstd[:, None], scale16,
                 scale16, [True, True, True]), shape=[n, cs.HIDDEN])
        rows["layer_norm_bwd" + tag].update(
            cs.launch_split(torch, timer, ln))
        adln = lambda: add_dropout_layer_norm_bwd(  # noqa: E731
            x, res, scale, mean, rstd, g, cs.FLASH_SEEDS[0], 0.1)
        both("add_dropout_layer_norm_bwd" + tag, adln, shape=[n, cs.HIDDEN],
             rate=0.1)
        rows["add_dropout_layer_norm_bwd" + tag].update(
            cs.launch_split(torch, timer, adln))

    # 5/6: the 512-bucket serving forward, packed, rate 0
    batch, seq = cs.BATCH_ROWS, 512
    seg = torch.from_numpy(cs.packed_segments(
        np, np.random.RandomState(1), batch, seq)).cuda()
    pad = make_attention_bias((seg > 0).int())
    qkv = torch.randn(batch, seq, 3, cs.HEADS, cs.HEAD_DIM, generator=gen,
                      device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    mask = (pad + make_segment_attention_bias(seg)).to(bf)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    both("flash_attention_fwd_serve", lambda: flash_attention(q, k, v, pad,
                                                              seg),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
         shape=[batch, seq, cs.HEADS, cs.HEAD_DIM], rate=0.0)

    # 5/6: phase 2's forward with a padding bias, rates 0.1 and 0 (SDPA at
    # rate 0: its dropout is another function)
    batch, seq = cs.PHASE2_ATTN
    pad = cs.padding_bias(torch, np, np.random.RandomState(5), batch, seq)
    qkv = torch.randn(batch, seq, 3, cs.HEADS, cs.HEAD_DIM, generator=gen,
                      device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = pad.to(bf)
    shape = [batch, seq, cs.HEADS, cs.HEAD_DIM]
    both("flash_attention_fwd_phase2", lambda: flash_attention(
        q, k, v, pad, None, cs.FLASH_SEEDS[0], 0.1), shape=shape, rate=0.1)
    both("flash_attention_fwd_phase2_rate0",
         lambda: flash_attention(q, k, v, pad),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
         shape=shape, rate=0.0)
    # 9/10: the dq and dk/dv pair, bf16 with a padding bias, rate 0.1, at
    # phase 2's shape and at seq 1024 and 2048 (the same 8192 tokens)
    for batch, seq in (cs.PHASE2_ATTN,) + cs.PAIR_LONG_SHAPES:
        pad = cs.padding_bias(torch, np, np.random.RandomState(seq), batch,
                              seq)
        qkv = torch.randn(batch, seq, 3, cs.HEADS, cs.HEAD_DIM,
                          generator=gen, device="cuda").to(bf)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(batch, seq, cs.HEADS, cs.HEAD_DIM, generator=gen,
                         device="cuda").to(bf)
        seed, shape = cs.FLASH_SEEDS[0], [batch, seq, cs.HEADS, cs.HEAD_DIM]
        out, lse = flash_attention(q, k, v, pad, None, seed, 0.1)
        _, delta = flash_attention_bwd_dq(q, k, v, pad, None, out, lse, do,
                                          seed, 0.1)
        both(f"flash_attention_bwd_dq_{batch}x{seq}",
             lambda: flash_attention_bwd_dq(q, k, v, pad, None, out, lse, do,
                                            seed, 0.1),
             shape=shape, rate=0.1)
        both(f"flash_attention_bwd_dkv_{batch}x{seq}",
             lambda: flash_attention_bwd_dkv(q, k, v, pad, None, lse, delta,
                                             do, seed, 0.1),
             shape=shape, rate=0.1)
        del qkv, q, k, v, do, out, lse, delta
    props = torch.cuda.get_device_properties(0)
    return {"tree": tree, "kind": props.name,
            "sms": props.multi_processor_count, "rows": rows}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _mean_rows(turns: list) -> dict:
    """Each tree's mean of its turns, the turns beside it."""
    out = {}
    for name, row in turns[0]["rows"].items():
        out[name] = dict(row)
        for key in row:
            if key.endswith("ms"):
                vals = [t["rows"][name][key] for t in turns]
                out[name][key] = sum(vals) / len(vals)
                out[name][key + "_turns"] = vals
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other checkout")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one turn
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if args.tree:
        print(json.dumps(time_tree(args.tree)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent DIR is required")
    order = [("parent", os.path.abspath(args.parent)), ("this", ROOT),
             ("this", ROOT), ("parent", os.path.abspath(args.parent))]
    turns = {"parent": [], "this": []}
    for tag, tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            stdout=subprocess.PIPE, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"time_kernels_ab: the {tag} turn ({tree}) exited "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(turn, turn=tag)), flush=True)
        turns[tag].append(turn)
    cs = _chip_smoke()
    sms = turns["this"][0]["sms"]
    mhz = float(_smi("clocks.max.sm").split()[0])
    batch, seq = cs.PHASE2_ATTN
    floor = (HASH_OPS * batch * cs.HEADS * seq * seq
             / (sms * 64 * mhz * 1e6) * 1e3)
    result = {"device": _smi("name,power.limit"),
              "max_sm_mhz": mhz, "sms": sms,
              "dropout_int_issue_floor_ms": floor,
              "parent": _mean_rows(turns["parent"]),
              "this": _mean_rows(turns["this"])}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
