"""The port's phase-2 slice against the JAX package's, on the CPU: the
flash kernels' dropout mask, the flash forward with dropout, its backward
at every Pallas backward site, the attention dispatcher's gate, one
pretraining step at seq 512 through the flash route, the entry point
under the phase-2 run config, and a CPU rehearsal of chip_smoke.py's
phase-2 train phase.

The JAX side runs its Pallas flash kernels in interpret mode (directly, or
through dot_product_attention with BPT_PALLAS_INTERPRET=1, which also
sends its LayerNorms to interpret mode); the port runs the kernels' plain
versions, its CPU route. Shapes stay small (B <= 2, H <= 2, D = 64,
S in {384, 512}).

Tolerances (f32): the dropout masks exactly; the forward and lse within
2e-5 and dq, dk, dv within 5e-4, the flash tiers of tests/test_pallas.py
(online against one-shot softmax, sums in another order); the whole step
within 1e-5 relative on the loss and 5e-4 on every gradient, the tiers of
tests/test_torch_pretrain.py."""

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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.ops.attention import _xla_attention  # noqa: E402
from bert_pytorch_tpu_torch.ops import attention as tatt  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402

# the module, not the function the package's __init__ re-exports
jfa = importlib.import_module("bert_pytorch_tpu.ops.pallas.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 2e-5
GRAD_TOL = 5e-4
SEED = -1640531527


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 2, -1, -1640531527])
def test_flash_keep_mask_bit_equal_to_pallas(seed):
    for bh in (0, 5, 1023):
        for q0, k0 in ((0, 0), (128, 384), (448, 64)):
            for rate in (0.1, 0.3):
                want = np.asarray(jfa._keep_mask(
                    jnp.int32(seed), bh, q0, k0, 64, 128, rate))
                got = tatt.flash_keep_mask(seed, bh, q0, k0, 64, 128, rate)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{bh} {q0} {k0}")
    # the whole-call mask is the per-(batch, head) masks stacked
    full = tatt.flash_keep_all(seed, 2, 3, 128, 0.1)
    np.testing.assert_array_equal(
        full[1, 2].numpy(),
        tatt.flash_keep_mask(seed, 5, 0, 0, 128, 128, 0.1).numpy())


def _inputs(s=512, segments=False, b=2, h=2, d=64, seed=0):
    """q, k, v, the padding bias, segment ids (or None) and a cotangent
    that is zero on pad (segment-0) rows, as no loss term reads them."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) * 0.5
               for _ in range(3))
    seg = np.zeros((b, s), np.int32)
    if segments:
        for row, lengths in enumerate(([40, 260, 180], [s - 12])):
            cursor = 0
            for i, ln in enumerate(lengths):
                seg[row, cursor:cursor + ln] = i + 1
                cursor += ln
    else:
        seg[:, :s - 17] = 1
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


@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_with_dropout_matches_pallas(case):
    rate, segments = CASES[case]
    q, k, v, bias, seg, _ = _inputs(segments=segments, seed=1)
    seed = SEED if rate > 0 else None
    out, res = jfa._flash_fwd(
        jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(bias),
        None if seg is None else jnp.array(seg),
        None if seed is None else jnp.int32(seed), rate, True)
    want_lse = np.asarray(res[5]).reshape(2, 2, 512)
    got, lse = tatt.flash_attention(_t(q), _t(k), _t(v), _t(bias), _t(seg),
                                    seed, rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=FWD_TOL,
                               atol=FWD_TOL)
    if rate > 0:
        # lse is the undropped softmax's: the same at rate 0
        lse0 = tatt.flash_attention(_t(q), _t(k), _t(v), _t(bias),
                                    _t(seg))[1]
        torch.testing.assert_close(lse, lse0, rtol=0, atol=0)


# the four Pallas backward sites: #7 the native fused kernel (the default
# at BERT-Large seq 512), #8 the (BH, S, D) fused kernel, #9/#10 the split
# dq and dk/dv kernels
SITES = {"7-native-fused": {}, "8-bh-fused": {"FLASH_LAYOUT": "bh"},
         "9-10-split": {"FLASH_BWD": "split"}}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("site", list(SITES))
def test_flash_grads_match_pallas_at_every_backward_site(site, case,
                                                          monkeypatch):
    for key in ("FLASH_LAYOUT", "FLASH_BWD"):
        monkeypatch.delenv(key, raising=False)
    for key, value in SITES[site].items():
        monkeypatch.setenv(key, value)
    rate, segments = CASES[case]
    q, k, v, bias, seg, cot = _inputs(segments=segments, seed=2)
    seed = SEED if rate > 0 else None

    def loss(q_, k_, v_):
        out = jfa.flash_attention(
            q_, k_, v_, jnp.array(bias),
            None if seg is None else jnp.array(seg),
            None if seed is None else jnp.int32(seed), rate, True)
        return jnp.sum(out * jnp.array(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.array(q), jnp.array(k),
                                             jnp.array(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tatt.FlashAttentionFn.apply(tq, tk, tv, _t(bias), _t(seg), seed,
                                      rate)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg="d" + name)
    if segments:
        pad = seg == 0
        assert pad.any()
        assert np.all(tq.grad.numpy()[pad] == 0.0)


def test_gate_keeps_seq320_on_the_hash_dropout_route():
    """seq 320 is above 256 but not a multiple of 128: the JAX package
    takes its XLA path there, whose dropout is hash_dropout (row_col_keep
    over a jax.random.bits seed), and so does the port."""
    q, k, v, bias, _, _ = _inputs(s=320, b=1, seed=3)
    rng = jax.random.PRNGKey(11)
    seed = int(jax.random.bits(rng, (), jnp.uint32).astype(jnp.int32))
    want = np.asarray(_xla_attention(jnp.array(q), jnp.array(k), jnp.array(v),
                                     jnp.array(bias), None, rng, 0.1, False))
    args = (_t(q), _t(k), _t(v), _t(bias))
    assert not tatt.takes_flash(args[0], args[1])
    got = tatt.dot_product_attention(*args, dropout_seed=seed,
                                     dropout_rate=0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    ref = tatt.attention_ref(*args, None, seed, 0.1)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_gate_sends_seq384_to_flash():
    """seq 384 passes the gate: the port's output is the flash route's
    (its mask, not row_col_keep's), equal to the Pallas kernel with that
    seed; q and k of different shapes stay on the plain route."""
    q, k, v, bias, _, _ = _inputs(s=384, b=1, seed=4)
    args = (_t(q), _t(k), _t(v), _t(bias))
    assert tatt.takes_flash(args[0], args[1])
    assert not tatt.takes_flash(args[0], args[1][:, :256])
    got = tatt.dot_product_attention(*args, dropout_seed=SEED,
                                     dropout_rate=0.1)
    want = np.asarray(jfa.flash_attention(
        jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(bias), None,
        jnp.int32(SEED), 0.1, True))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    hashed = tatt.attention_ref(*args, None, SEED, 0.1)
    assert not torch.allclose(got, hashed, atol=1e-3)


# -- the slice as a whole -----------------------------------------------------

S2 = 512


def _batch512(seed, rows=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, tp.V, (rows, S2)).astype(np.int32)
    labels = np.full((rows, S2), -1, np.int32)
    for r in range(rows):
        for p in rng.choice(np.arange(1, S2 - 40), 6 + r, replace=False):
            labels[r, p] = ids[r, p]
            ids[r, p] = 3
    mask = np.ones((rows, S2), np.int32)
    mask[0, S2 - 37:] = 0
    types = np.zeros((rows, S2), np.int32)
    types[:, S2 // 2:] = 1
    return {"input_ids": ids, "token_type_ids": types * mask,
            "attention_mask": mask, "masked_lm_labels": labels,
            "next_sentence_labels": rng.randint(0, 2, rows).astype(np.int32)}


def test_phase2_step_matches_jax(monkeypatch):
    """One pretraining step of a 2-layer, width-128 model at seq 512 with
    dropout 0.1: JAX takes its flash route (Pallas in interpret mode), the
    port its flash route (FlashAttentionFn over the plain versions), fed
    the seeds JAX drew. Loss and every gradient. The JAX step is jitted;
    its dropout entry points are wrapped by recorders that hand each seed
    out through an ordered debug callback, in the order the port takes
    them."""
    import bert_pytorch_tpu.models.bert as jax_bert
    import bert_pytorch_tpu.ops.attention as jax_attention
    from bert_pytorch_tpu.training import pretrain as jax_pretrain
    from bert_pytorch_tpu.training.state import unbox
    from bert_pytorch_tpu_torch.training.pretrain import (
        compute_params, pretrain_loss_and_grads)

    over = dict(max_position_embeddings=S2)
    model = tp._jax_model(**over)
    zeros = jnp.zeros((1, S2), jnp.int32)
    params = unbox(model.init(jax.random.PRNGKey(0), zeros, zeros,
                              zeros)["params"])
    seeds, routes = [], []

    def record(seed):
        jax.debug.callback(lambda s: seeds.append(int(s)), seed,
                           ordered=True)

    adln, hdrop = jax_bert.add_dropout_layer_norm, jax_attention.hash_dropout
    flash = jfa.flash_attention

    def rec_adln(x, residual, scale, bias, seed, *a, **k):
        record(seed)
        return adln(x, residual, scale, bias, seed, *a, **k)

    def rec_hdrop(x, seed, rate):
        record(seed)
        return hdrop(x, seed, rate)

    def rec_flash(q, k, v, bias=None, segment_ids=None, dropout_seed=None,
                  dropout_rate=0.0, interpret=False):
        record(dropout_seed)
        routes.append(interpret)
        return flash(q, k, v, bias, segment_ids, dropout_seed, dropout_rate,
                     interpret)

    monkeypatch.setenv("BPT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_bert, "add_dropout_layer_norm", rec_adln)
    monkeypatch.setattr(jax_attention, "hash_dropout", rec_hdrop)
    monkeypatch.setattr(jfa, "flash_attention", rec_flash)

    batch = _batch512(0)
    loss_fn = jax_pretrain._pretrain_loss_fn(model, tp.P)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.array(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    jax.effects_barrier()
    layers = tp.CFG["num_hidden_layers"]
    assert len(seeds) == 1 + 3 * layers
    assert routes == [True] * layers   # both layers took the flash route

    port = tp._port_model(tp._flat(params), **over)
    gparams = compute_params(dict(port.named_parameters()), None)
    t_loss, t_aux, t_grads = pretrain_loss_and_grads(
        port, gparams, tp._torch_batch(batch),
        torch.tensor(seeds, dtype=torch.int32), tp.P)
    np.testing.assert_allclose(t_loss.item(), float(loss),
                               rtol=tp.LOSS_RTOL)
    assert int(t_aux["mlm_total"]) == int(aux["mlm_total"])
    tp._assert_grads_close(t_grads, grads)


def _write_shards512(root, n=12):
    from tests.test_data import write_shard

    root.mkdir(exist_ok=True)
    for i in range(2):
        write_shard(str(root / f"part_{i}.hdf5"), n, seq=S2, seed=i)
    return root


def test_run_pretraining_phase2_main_on_cpu(tmp_path, monkeypatch):
    """The phase-2 run config through the entry point: 80 predictions per
    sequence reach the loader, the sequence length (512) comes from the
    shards, attention takes the flash route, and the schedule carries the
    7038-step offset (a fresh run sits at the start of its warmup, as the
    JAX entry point's does)."""
    from bert_pytorch_tpu.optim import schedulers as jax_schedulers
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.data import sharded

    loader_kw, routes = {}, []
    loader_cls, gate = sharded.PretrainingDataLoader, tatt.takes_flash

    class Loader(loader_cls):
        def __init__(self, *a, **kw):
            loader_kw.update(kw)
            super().__init__(*a, **kw)

    def rec_gate(q, k):
        routes.append((q.shape[1], gate(q, k)))
        return routes[-1][1]

    monkeypatch.setattr(sharded, "PretrainingDataLoader", Loader)
    monkeypatch.setattr(tatt, "takes_flash", rec_gate)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(tp.CFG, max_position_embeddings=S2)))
    data = _write_shards512(tmp_path / "data")
    out = tmp_path / "out"
    run_config = os.path.join(REPO, "configs",
                              "bert_pretraining_phase2_config.json")
    argv = ["--config_file", run_config,
            "--model_config_file", str(cfg), "--input_dir", str(data),
            "--output_dir", str(out), "--local_batch_size", "2",
            "--global_batch_size", "4", "--steps", "2", "--skip_checkpoint",
            "--device", "cpu"]
    lines = []
    result = run_pretraining.main(argv, log=lines.append)
    assert result.step == 2 and result.accum_steps == 2
    assert loader_kw["max_pred_per_seq"] == 80
    assert routes and all(r == (S2, True) for r in routes)
    jsched = jax_schedulers.make_schedule("poly", 4e-3, 1563, warmup=0.128,
                                          offset=7038)
    for i, rec in enumerate(result.history):
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        assert rec["loss_nonfinite"] == 0 and rec["grad_nonfinite"] == 0
        assert rec["learning_rate"] == pytest.approx(float(jsched(i)),
                                                     abs=1e-12)
    logged = [json.loads(ln) for ln in
              (out / "phase2_log.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in logged] == ["header", "train", "train"]
    # a run config that chains from a phase-1 checkpoint reads it (weights
    # only): a checkpoint directory that does not exist is an error
    chained = tmp_path / "phase2_from_checkpoint.json"
    with open(run_config) as f:
        chained.write_text(json.dumps(dict(json.load(f),
                                           init_checkpoint="phase1.ckpt")))
    argv[argv.index(run_config)] = str(chained)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_pretraining.main(argv, log=lines.append)


def test_chip_smoke_phase2_train_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's phase-2 train phase at a tiny width on the CPU (the
    plain versions), after its phase-1 phase: the run config, the
    in-memory seq-512 shards, the resume of phase 1's checkpoint, the
    entry point's run and the kernels-vs-plain comparison."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = tmp_path / "tiny_seq512.json"
    cfg.write_text(json.dumps(dict(tp.CFG, max_position_embeddings=S2)))
    summary = {}
    # phase 2 resumes phase 1's checkpoint, as in the script
    ckpt_dir = str(tmp_path / "ckpt")
    for run in ("train", "train_phase2"):
        chip_smoke.phase_train(torch, np, summary, device="cpu",
                               cfg_path=str(cfg), run=run,
                               ckpt_dir=ckpt_dir)
    train = summary["train_phase2"]
    assert train["checkpoint"]["resumed_from"] == 3
    assert train["end_step"] == 6
    assert train["steps"] == 3 and train["accum_steps"] == 2
    assert train["micro_batch"] == 16 and train["seq"] == 512
    assert all(np.isfinite(train["losses"]))
    layers = tp.CFG["num_hidden_layers"]
    # bf16 at seq 512: the fused backward, never the split pair
    assert train["launches_predicted"]["flash_attention_bwd"] == \
        layers * 2 * 3
    assert train["launches_predicted"]["flash_attention_bwd_dq"] == 0
    assert train["launches_predicted"]["flash_attention_bwd_dkv"] == 0
    # the CPU runs the plain versions on both sides of the comparison
    assert train["launches"] == {k: 0 for k in train["launches"]}
    tol = chip_smoke.TRAIN_RUNS["train_phase2"]["tol"]
    for name, res in train["kernels_vs_plain"].items():
        assert res["max_grad_rel_l2"] <= tol[name]["grad"]
