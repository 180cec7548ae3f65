"""Pretraining's sequence packing and --checkpoint_activations in the port
against the JAX package, on the CPU, at a tiny f32 width (2 layers,
E=128, 2 heads, I=256; seq 64 takes the eager attention route, seq 512
the flash route with JAX's Pallas kernels in interpret mode): the packed
loader, the packed step, packed against one example a row, and
activation checkpointing under the three remat policies.

Tolerances (f32, the tiers of tests/test_torch_pretrain.py and
tests/test_pallas.py): batches and masks exactly; a packed step's loss
within 1e-5 relative and every gradient within 5e-4 of JAX's, fed the
seeds JAX drew; packed against unpacked at rate 0 within 2e-5 (JAX's
tests/test_packing.py), other segments' outputs bit-identical; remat
against no remat bit-identical in the port, and within the gradient tier
of JAX's remat model."""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.data.sharded import (  # noqa: E402
    HostShardSampler as JaxSampler, PretrainingDataLoader as JaxLoader,
    ShardIndex as JaxShardIndex)
from bert_pytorch_tpu.training import pretrain as jax_pretrain  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.data import packing  # noqa: E402
from bert_pytorch_tpu_torch.data.sharded import (  # noqa: E402
    HostShardSampler, PretrainingDataLoader, ShardIndex)
from bert_pytorch_tpu_torch.telemetry.flight_recorder import \
    FlightRecorder  # noqa: E402
from bert_pytorch_tpu_torch.training.pretrain import (  # noqa: E402
    compute_params, pretrain_loss_and_grads)
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_data import write_shard  # noqa: E402

S = 64
G = 4
LOADER = dict(batch_size=4, mask_token_index=3, max_pred_per_seq=tp.P,
              masked_lm_prob=0.15, vocab_size=tp.V, seed=9, packing=True,
              packing_max_segments=G, packing_lookahead=2)
# the packed rows' prediction budget, as the entry point computes it
P_ROW = run_pretraining.packed_prediction_budget(argparse.Namespace(
    packing=True, packing_max_segments=G, max_predictions_per_seq=tp.P,
    masked_token_fraction=0.15), S)
PACK_ATOL = 2e-5
POLICIES = ("nothing", "dots", "mlp_only")


@pytest.fixture(scope="module")
def init_params():
    """The tiny JAX model's parameters (tests/test_torch_pretrain.py's
    CFG), initialised under jit."""
    from bert_pytorch_tpu.training.state import unbox

    s = jnp.zeros((1, tp.S), jnp.int32)
    return unbox(jax.jit(tp._jax_model().init)(jax.random.PRNGKey(0), s, s,
                                               s)["params"])


def _shards(root, seq=S, n=24):
    root.mkdir(exist_ok=True)
    for i in range(2):
        write_shard(str(root / f"part_{i}.hdf5"), n, seq=seq, seed=i,
                    varied=True)
    return sorted(str(p) for p in root.glob("*.hdf5"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _shards(tmp_path_factory.mktemp("packing_shards"))


def _port_loader(files, **over):
    return PretrainingDataLoader(ShardIndex(files),
                                 HostShardSampler(48, seed=9),
                                 **dict(LOADER, **over))


def _loaders(files, **over):
    """(JAX's packed loader, the port's) over the same shards."""
    jl = JaxLoader(JaxShardIndex(files), JaxSampler(48, seed=9),
                   **dict(LOADER, **over))
    return jl, _port_loader(files, **over)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def packed_batch(files):
    """The JAX packed loader's first batch (4 rows of seq 64)."""
    jl = JaxLoader(JaxShardIndex(files), JaxSampler(48, seed=9), **LOADER)
    try:
        return next(iter(jl))
    finally:
        jl.close()


def test_packing_helpers_match_jax():
    from bert_pytorch_tpu.data import packing as jax_packing

    ex = _examples((10, 14, 8, 30, 5))
    bins = packing.first_fit(packing.example_lengths(ex["attention_mask"]),
                             2, S, 3)
    assert bins == jax_packing.first_fit(
        jax_packing.example_lengths(ex["attention_mask"]), 2, S, 3)
    _assert_batches_equal(packing.pack_examples(ex, bins, S, 3),
                          jax_packing.pack_examples(ex, bins, S, 3))


def test_packed_loader_equals_jax_two_epochs(files):
    """Every field of every packed batch, two epochs (the masks refresh
    with the epoch), the port assembling two batches ahead."""
    jl, pl = _loaders(files, prefetch_batches=2)
    try:
        for _ in range(2):
            got, want = list(pl), list(jl)
            assert len(got) == len(want) >= 4
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)
            # rows really packed
            assert max(g["segment_ids"].max() for g in got) > 1
            pl.reset_epoch()
            jl.reset_epoch()
    finally:
        pl.close()
        jl.close()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_packed_resume_with_pending_equals_jax(files, prefetch):
    """The loader's state after two batches holds pending examples; a
    fresh loader of either package restored from it yields the batches
    the uninterrupted JAX loader yields next."""
    jl, pl = _loaders(files, prefetch_batches=prefetch)
    try:
        for _ in range(2):
            _assert_batches_equal(next(pl), next(jl))
        state = pl.state_dict()
        assert state == jl.state_dict() and state["pending"]
        want = [next(jl) for _ in range(3)]
        jl2, pl2 = _loaders(files)
        jl2.load_state_dict(state)
        pl2.load_state_dict(state)
        for w in want:
            _assert_batches_equal(next(pl2), w)
            _assert_batches_equal(next(jl2), w)
        jl2.close()
        pl2.close()
    finally:
        pl.close()
        jl.close()


def test_pending_dropped_with_a_refused_cursor(files):
    pl = _port_loader(files)
    next(pl)
    state = dict(pl.state_dict(), total_size=999)
    assert state["pending"]
    with pytest.warns(UserWarning, match="total_size changed"):
        pl.load_state_dict(state)
    assert pl.state_dict()["pending"] == []
    pl.close()


def test_ring_bound_under_prefetch_and_packing(files):
    """The recorder's ring holds at most its window (plus one staged
    batch) of the loader's batches with assembly running ahead."""
    rec = FlightRecorder("/nonexistent", window=2)
    pl = _port_loader(files, prefetch_batches=2)
    pl.batch_tap = rec.capture_batch
    try:
        per_batch = None
        for step in range(1, 6):
            batch = next(pl)
            if per_batch is None:
                per_batch = sum(v.nbytes for v in batch.values())
            rec.record_dispatch(step, 1, np.zeros((2, 7), np.int32))
            assert len(rec._records) <= 2
            assert rec.nbytes() <= 3 * per_batch
        assert rec._records[-1]["batch"]["segment_ids"].shape == (4, S)
    finally:
        pl.close()


def _port_packed_step(params, batch, seeds, max_pred, **over):
    model = tp._port_model(tp._flat(params), **over)
    gparams = compute_params(dict(model.named_parameters()), None)
    return pretrain_loss_and_grads(model, gparams, tp._torch_batch(batch),
                                   seeds, max_pred)


def _jax_packed_step(monkeypatch, model, params, batch, max_pred):
    """JAX's loss and gradients of one packed microbatch, jitted, with the
    dropout seeds its model draws handed out by ordered debug callbacks
    in the order the port takes them, and each attention call's route
    (True: the flash kernel, in interpret mode, with the segment ids)."""
    import importlib

    import bert_pytorch_tpu.models.bert as jax_bert
    import bert_pytorch_tpu.ops.attention as jax_attention

    jfa = importlib.import_module("bert_pytorch_tpu.ops.pallas.flash_attention")
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
        routes.append(segment_ids is not None and interpret)
        return flash(q, k, v, bias, segment_ids, dropout_seed, dropout_rate,
                     interpret)

    monkeypatch.setenv("BPT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_bert, "add_dropout_layer_norm", rec_adln)
    monkeypatch.setattr(jax_attention, "hash_dropout", rec_hdrop)
    monkeypatch.setattr(jfa, "flash_attention", rec_flash)
    loss_fn = jax_pretrain._pretrain_loss_fn(model, max_pred)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.array(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    jax.effects_barrier()
    assert len(seeds) == tp.N_SEEDS
    return loss, aux, grads, torch.tensor(seeds, dtype=torch.int32), routes


def test_packed_step_matches_jax_eager_route(init_params,
                                             packed_batch, monkeypatch):
    """One packed microbatch with dropout on, seq 64 (the eager attention
    route: the segment bias and row_col_keep): loss and every gradient
    against JAX's loss, the port fed the seeds JAX drew."""
    loss, aux, grads, seeds, routes = _jax_packed_step(
        monkeypatch, tp._jax_model(), init_params, packed_batch, P_ROW)
    assert routes == []
    t_loss, t_aux, t_grads = _port_packed_step(init_params, packed_batch,
                                               seeds, P_ROW)
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=tp.LOSS_RTOL)
    assert int(t_aux["mlm_total"]) == int(aux["mlm_total"])
    assert int(t_aux["mlm_dropped"]) == 0
    tp._assert_grads_close(t_grads, grads)


def test_packed_step_matches_jax_flash_route(tmp_path, monkeypatch):
    """The same at seq 512, the flash route: JAX's Pallas kernels in
    interpret mode, the port's FlashAttentionFn over the plain versions,
    both with the packed segment ids and dropout 0.1."""
    from bert_pytorch_tpu.training.state import unbox

    files512 = _shards(tmp_path / "s512", seq=512, n=4)
    jl = JaxLoader(JaxShardIndex(files512), JaxSampler(8, seed=9),
                   **dict(LOADER, batch_size=2))
    batch = next(iter(jl))
    jl.close()
    assert batch["segment_ids"].max() > 1
    over = dict(max_position_embeddings=512)
    model = tp._jax_model(**over)
    zeros = jnp.zeros((1, 512), jnp.int32)
    params = unbox(model.init(jax.random.PRNGKey(0), zeros, zeros,
                              zeros)["params"])
    max_pred = 80
    loss, aux, grads, seeds, routes = _jax_packed_step(
        monkeypatch, model, params, batch, max_pred)
    assert routes == [True] * tp.CFG["num_hidden_layers"]
    t_loss, t_aux, t_grads = _port_packed_step(params, batch, seeds,
                                               max_pred, **over)
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=tp.LOSS_RTOL)
    assert int(t_aux["mlm_total"]) == int(aux["mlm_total"])
    tp._assert_grads_close(t_grads, grads)


def _examples(lens, seed=0):
    """One example a row at seq S: [CLS] ... [SEP], two masked tokens
    each, token types 1 on the second half (JAX's tests/test_packing.py
    `_example_batch`)."""
    rng = np.random.RandomState(seed)
    n = len(lens)
    ids = np.zeros((n, S), np.int32)
    tok = np.zeros((n, S), np.int32)
    am = np.zeros((n, S), np.int32)
    lab = np.full((n, S), -1, np.int32)
    for i, ln in enumerate(lens):
        ids[i, :ln] = rng.randint(5, 64, ln)
        ids[i, 0], ids[i, ln - 1] = 1, 2
        tok[i, ln // 2:ln] = 1
        am[i, :ln] = 1
        mpos = rng.choice(np.arange(1, ln - 1), 2, replace=False)
        lab[i, mpos] = ids[i, mpos]
        ids[i, mpos] = 3
    return {"input_ids": ids, "token_type_ids": tok, "attention_mask": am,
            "masked_lm_labels": lab,
            "next_sentence_labels": rng.randint(0, 2, (n,)).astype(np.int32)}


def _rate0_model():
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)

    cfg = BertConfig.from_dict(dict(tp.CFG, hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0))
    model = BertForPreTraining(cfg, dtype=torch.float32)
    return init_weights(model, torch.Generator().manual_seed(0))


def _packed_equivalents(lens=(10, 14, 8)):
    ex = _examples(lens)
    bins = packing.first_fit(packing.example_lengths(ex["attention_mask"]),
                             1, S, G)
    assert bins == [list(range(len(lens)))]
    return ex, packing.pack_examples(ex, bins, S, G)


def _pretrain_loss(model, batch):
    from bert_pytorch_tpu_torch.models.losses import pretraining_loss

    t = tp._torch_batch(batch)
    kw = {k: t[k] for k in ("position_ids", "segment_ids", "nsp_positions")
          if k in t}
    with torch.no_grad():
        mlm, nsp = model(t["input_ids"], t["token_type_ids"],
                         t["attention_mask"], **kw)
        return pretraining_loss(mlm, t["masked_lm_labels"], nsp,
                                t["next_sentence_labels"]).item(), mlm, nsp


def test_packed_loss_equals_unpacked():
    """JAX's test_packed_loss_equals_unpacked in the port: one packed row
    of 3 examples (2 masked tokens each) gives the unpacked batch's
    MLM + NSP loss, which (equal mask counts) is also the mean of the
    per-example losses."""
    model = _rate0_model()
    ex, pk = _packed_equivalents()
    unpacked = _pretrain_loss(model, ex)[0]
    per_example = [_pretrain_loss(model, {k: v[i:i + 1]
                                          for k, v in ex.items()})[0]
                   for i in range(3)]
    packed, _, nsp = _pretrain_loss(model, pk)
    assert tuple(nsp.shape) == (1, G, 2)          # NSP per segment
    assert packed == pytest.approx(unpacked, abs=PACK_ATOL)
    assert packed == pytest.approx(np.mean(per_example), abs=PACK_ATOL)


def test_packed_model_no_cross_contamination_bit_identical():
    """Rewriting every token of segment 1 leaves segments 2 and 3's MLM
    logits and NSP logits bit-identical (the port's counterpart of JAX's
    test of that name)."""
    model = _rate0_model()
    _, pk = _packed_equivalents()
    seg = pk["segment_ids"][0]
    changed = dict(pk, input_ids=pk["input_ids"].copy())
    changed["input_ids"][0, seg == 1] = 7
    _, ml_a, nsp_a = _pretrain_loss(model, pk)
    _, ml_b, nsp_b = _pretrain_loss(model, changed)
    other = torch.from_numpy(seg > 1)
    assert torch.equal(ml_a[0, other], ml_b[0, other])
    assert not torch.allclose(ml_a[0, torch.from_numpy(seg == 1)],
                              ml_b[0, torch.from_numpy(seg == 1)])
    assert torch.equal(nsp_a[0, 1:3], nsp_b[0, 1:3])
    assert not torch.equal(nsp_a[0, 0], nsp_b[0, 0])


def _count_residual_tails(monkeypatch):
    """Count the fused residual-dropout-LayerNorm calls (kernel #3 on a
    card), the recompute's included."""
    import bert_pytorch_tpu_torch.models.bert as pbert

    calls = [0]
    real = pbert.add_dropout_layer_norm

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(pbert, "add_dropout_layer_norm", counting)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_bit_equal_to_no_remat(init_params, packed_batch,
                                     policy, monkeypatch):
    """A packed microbatch with dropout on: the loss and every gradient
    under checkpoint_activations are the bits of the run without it; the
    recompute re-runs each layer's two residual tails under "nothing" and
    "dots" and none of them under "mlp_only"."""
    calls = _count_residual_tails(monkeypatch)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (tp.N_SEEDS,),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(3))
    want = _port_packed_step(init_params, packed_batch, seeds, P_ROW)
    plain_calls, calls[0] = calls[0], 0
    got = _port_packed_step(init_params, packed_batch, seeds, P_ROW,
                            checkpoint_activations=True, remat_policy=policy)
    layers = tp.CFG["num_hidden_layers"]
    assert plain_calls == 2 * layers
    assert calls[0] == (2 if policy == "mlp_only" else 4) * layers
    assert torch.equal(got[0], want[0])
    assert set(got[2]) == set(want[2])
    for k, g in want[2].items():
        assert torch.equal(got[2][k], g), k


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_remat_model(init_params, packed_batch,
                                       policy):
    """The port's remat model against JAX's (nn.remat over the unstacked
    layers, the same policy) on a packed microbatch at rate 0: the loss
    and every gradient at the tiers."""
    over = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                checkpoint_activations=True, remat_policy=policy)
    loss_fn = jax_pretrain._pretrain_loss_fn(tp._jax_model(**over), P_ROW)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        init_params, {k: jnp.array(v) for k, v in packed_batch.items()},
        jax.random.PRNGKey(0))
    t_loss, _, t_grads = _port_packed_step(init_params, packed_batch, None,
                                           P_ROW, **over)
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=tp.LOSS_RTOL)
    tp._assert_grads_close(t_grads, grads)


def test_packing_and_recorder_flags_are_served():
    """The flags that left the refusal tables parse with the JAX
    parser's defaults and pass the refusal check."""
    args = run_pretraining.parse_arguments([
        "--packing", "--checkpoint_activations", "--recorder_window", "4"])
    run_pretraining._unsupported(args)
    assert (args.flight_recorder, args.packing_max_segments,
            args.packing_lookahead) == ("on", 8, 4)
    for key in ("packing", "checkpoint_activations", "flight_recorder"):
        assert key not in run_pretraining._REFUSED
    assert P_ROW == min(S, G * tp.P, int(S * 0.15) + G)
