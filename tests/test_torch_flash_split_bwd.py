"""The port's split flash-attention backward, the dq and dk/dv pair (the
CUDA kernels of ops/kernels/csrc/flash_attention_split_bwd.cu in bf16,
flash_attention.cu in f32), on the CPU at the lengths where bf16 takes
it (seq above the fused kernel's 512):

- the pair's plain versions against the split Pallas kernels they replace
  (`_dq_kernel` and `_dkv_kernel`, FLASH_BWD=split), run in interpret mode
  through the custom VJP of the Pallas flash attention, as
  tests/test_torch_flash_train.py runs them, at seq 640 and 1024, rates 0
  and 0.1, under a padding bias and with packed segments;
- FlashAttentionFn in bf16 at those lengths routes its backward to the
  pair (`fused_bwd_takes` false) and gives the plain version's gradients
  bit for bit, launching no kernel on the CPU;
- chip_smoke.py's `expected_skips` at the pair's tiles (dq: 64 queries by
  128 keys; dk/dv: 64 queries by 64 keys), which the card's skip counts
  are held to, equals a brute-force count of the segment-range rule over
  random packed segments, and no skipped tile pair holds a (query, key)
  pair the packed mask allows;
- chip_smoke.py's seq-1024 model check rehearsed at a tiny width, and its
  kernels line carrying the pair's longer shapes and f32 as variants.

The kernels themselves are held against the plain versions on the card by
chip_smoke.py. Shapes stay small: B 1-2, H 1-2, D 64. Tolerances (f32):
the flash tiers of tests/test_pallas.py, 2e-5 on the forward and 5e-4 on
dq, dk, dv (online against one-shot softmax, sums in another order); the
dropout masks exactly."""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from bert_pytorch_tpu_torch.ops import attention as tatt  # noqa: E402
from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_torch_flash_fwd import _brute_skips  # noqa: E402

# the module, not the function the package's __init__ re-exports
jfa = importlib.import_module("bert_pytorch_tpu.ops.pallas.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
# the pair's (query rows, keys) tiles: the grain of its segment skip
PAIR_TILES = {"dq": (64, 128), "dkv": (64, 64)}


def _jax_seed(n: int) -> int:
    """An int32 dropout seed as the JAX package draws one."""
    return int(jax.random.bits(jax.random.PRNGKey(n), (), jnp.uint32)
               .astype(jnp.int32))


def _inputs(s, segments, seed, b, h, d=64):
    """q, k, v, the padding bias, segment ids (or None) and a cotangent
    that is zero on pad (segment-0) rows, as no loss term reads them."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) * 0.5
               for _ in range(3))
    seg = np.zeros((b, s), np.int32)
    if segments:
        lengths = [([70, s // 2, s // 4], [s - 40])[row] for row in range(b)]
        for row, lens in enumerate(lengths):
            cursor = 0
            for i, ln in enumerate(lens):
                seg[row, cursor:cursor + ln] = i + 1
                cursor += ln
    else:
        seg[:, :s - 37] = 1
        seg[-1, :] = 1
    bias = ((1.0 - (seg > 0).astype(np.float32)) * -10000.0)[:, None, None, :]
    cot = rng.randn(b, s, h, d).astype(np.float32)
    if segments:
        cot[seg == 0] = 0.0
    return q, k, v, bias, (seg if segments else None), cot


def _t(a):
    return None if a is None else torch.from_numpy(a)


CASES = {"rate0": (0.0, False), "rate0.1": (0.1, False),
         "segments-rate0.1": (0.1, True)}
# (seq, batch, heads): longer than the fused gate's 512 (packed segments
# take two rows, one packed and one single-segment)
SHAPES = {"640": (640, 1, 1), "1024": (1024, 1, 1)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_pair_plain_versions_match_pallas_split_kernels(shape, case,
                                                        monkeypatch):
    monkeypatch.delenv("FLASH_LAYOUT", raising=False)
    monkeypatch.setenv("FLASH_BWD", "split")
    seq, b, h = SHAPES[shape]
    rate, segments = CASES[case]
    if segments:
        b = 2
    q, k, v, bias, seg, cot = _inputs(seq, segments, seed=seq + len(case),
                                      b=b, h=h)
    seed = _jax_seed(seq) if rate > 0 else None
    jseg = None if seg is None else jnp.array(seg)
    jseed = None if seed is None else jnp.int32(seed)

    def attend(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, jnp.array(bias), jseg, jseed,
                                   rate, True)

    want_out, vjp = jax.vjp(attend, jnp.array(q), jnp.array(k),
                            jnp.array(v))
    want = vjp(jnp.array(cot))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out, lse = tatt.flash_attention(tq, tk, tv, _t(bias), _t(seg), seed,
                                    rate)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=FWD_TOL, atol=FWD_TOL)
    reset_launches()
    dq, delta = tatt.flash_attention_bwd_dq(tq, tk, tv, _t(bias), _t(seg),
                                            out, lse, _t(cot), seed, rate)
    dk, dv = tatt.flash_attention_bwd_dkv(tq, tk, tv, _t(bias), _t(seg), lse,
                                          delta, _t(cot), seed, rate)
    # CPU tensors: the plain versions, no kernel
    assert LAUNCHES["flash_attention_bwd_dq"] == 0
    assert LAUNCHES["flash_attention_bwd_dkv"] == 0
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        assert g.shape == tq.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg="d" + name)
    if segments:
        pad = seg == 0
        assert pad.any()
        assert np.all(dq.numpy()[pad] == 0.0)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seq", [640, 1024])
def test_flash_fn_bf16_takes_the_pair_bit_equal_to_plain(seq, case):
    """bf16 beyond 512 positions: FlashAttentionFn's backward is the dq
    and dk/dv pair, on the CPU flash_attention_bwd_ref bit for bit."""
    rate, segments = CASES[case]
    q, k, v, bias, seg, cot = _inputs(seq, segments, seed=seq, b=2, h=1)
    seed = _jax_seed(seq + 1) if rate > 0 else None
    tq, tk, tv = (_t(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    assert tatt.takes_flash(tq, tk) and not tatt.fused_bwd_takes(tq)
    g = _t(cot).to(torch.bfloat16)
    reset_launches()
    out = tatt.FlashAttentionFn.apply(tq, tk, tv, _t(bias), _t(seg), seed,
                                      rate)
    out.backward(g)
    assert all(n == 0 for n in LAUNCHES.values())
    o, lse = tatt.flash_attention(tq.detach(), tk.detach(), tv.detach(),
                                  _t(bias), _t(seg), seed, rate)
    want = tatt.flash_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), _t(bias), _t(seg), o, lse, g,
        seed, rate)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, w, rtol=0, atol=0)


@pytest.mark.parametrize("kern", list(PAIR_TILES))
@pytest.mark.parametrize("batch,seq,seed", [(16, 512, 4), (8, 1024, 0),
                                            (4, 2048, 1)])
def test_expected_skips_at_the_pair_tiles(kern, batch, seq, seed):
    seg = chip_smoke.packed_segments(np, np.random.RandomState(seed), batch,
                                     seq)
    rows, keys = PAIR_TILES[kern]
    skipped, allowed_inside = _brute_skips(seg, rows, keys)
    assert skipped > 0 and allowed_inside == 0
    for heads in (1, 16):
        assert chip_smoke.expected_skips(np, seg, rows, keys, heads) == \
            skipped * heads


def test_chip_smoke_model_seq1024_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's seq-1024 model check at a tiny width on the CPU
    (seq 640, bf16: the pair's route; the plain versions on both sides),
    the config cut to LONG_MODEL's layers and its position table grown to
    the sequence."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(tp.CFG, num_hidden_layers=4)))
    summary = {}
    chip_smoke.phase_model_seq1024(torch, np, summary, device="cpu",
                                   cfg_path=str(cfg), batch=2, seq=640)
    res = summary["model_seq1024"]
    layers = chip_smoke.LONG_MODEL["layers"]
    assert res["layers"] == layers and res["seq"] == 640
    # the same forward; the backward in the pair's arithmetic (ds rounded
    # to bf16) against autograd through the plain forward
    assert np.isfinite(res["loss"]) and res["loss"] == res["plain_loss"]
    tol = chip_smoke.TRAIN2_MODEL_TOL["bfloat16"]["grad"]
    assert 0.0 < res["max_grad_rel_l2"] <= tol
    assert res["launches_predicted"]["flash_attention_bwd_dq"] == layers
    assert res["launches_predicted"]["flash_attention_bwd_dkv"] == layers
    assert res["launches_predicted"]["flash_attention_bwd"] == 0
    # the CPU runs the plain versions: no kernel launched on the path
    assert summary["launches"]["model_seq1024"] == {
        k: 0 for k in LAUNCHES}


def test_kernels_line_carries_the_pair_variants():
    """The pair's rows of chip_smoke.py's kernels line: phase 2's shape in
    bf16 on top, (8, 1024), (4, 2048) and f32 under `variants`, each with
    its own error; #9/#10 name the new source."""
    results = {}
    for kern in ("dq", "dkv"):
        base = {"ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
                "bound_by": "operations", "library_ms": None,
                "shape": [16, 512, 16, 64], "dtype": "bfloat16",
                "rate": 0.1}
        results["flash_attention_bwd_" + kern] = dict(
            base, max_abs_err={"bfloat16": 0.01, "float32": 1e-7},
            seq1024=dict(base, shape=[8, 1024, 16, 64], ms=3.0,
                         max_abs_err={"bfloat16": 0.02}),
            seq2048=dict(base, shape=[4, 2048, 16, 64], ms=5.0,
                         max_abs_err={"bfloat16": 0.03}),
            float32=dict(base, dtype="float32", ms=7.0))
    line = {r["name"]: r for r in chip_smoke.kernels_line(
        results, {"model_seq1024": {k: 2 for k in LAUNCHES}}, {})}
    for kern in ("dq", "dkv"):
        row = line["flash_attention_bwd_" + kern]
        assert row["source"].endswith("flash_attention_split_bwd.cu")
        assert row["launches"] == 2 and row["ms"] == 1.0
        assert row["max_abs_err"] == 0.01
        var = row["variants"]
        assert var["seq1024"]["ms"] == 3.0
        assert var["seq1024"]["max_abs_err"] == 0.02
        assert var["seq2048"]["max_abs_err"] == 0.03
        assert var["float32"]["ms"] == 7.0
        assert var["float32"]["max_abs_err"] == 1e-7
