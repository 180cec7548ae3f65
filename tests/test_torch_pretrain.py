"""The port's pretraining slice against the JAX package's, on the CPU, at
a tiny f32 width (2 layers, E=128, 2 heads, I=256, S=32, P=6): the data
loader, one step with dropout on, a 3-step LAMB trajectory, gradient
accumulation, the entry point, and a CPU rehearsal of chip_smoke.py's
train phase.

Dropout seeds are inputs in the port. The JAX model draws them from flax
rngs inside the step, so these tests record them: the JAX package's
`add_dropout_layer_norm` and `hash_dropout` are wrapped by recorders, and
the JAX model runs in its unstacked layout (stacked_params=False) without
jit, where the seeds are concrete. They arrive in the order the port
takes them: embeddings, then per layer attention probabilities, attention
tail, MLP tail.

Tolerances (f32): the loss within 1e-5 relative and gradients within 5e-4
(the flash-attention gradient tier of tests/test_pallas.py: the two
frameworks sum attention and LayerNorm reductions in another order);
parameters after 3 LAMB steps within 1e-4 relative L2 per tensor; the
loader's batches exactly."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)
from flax import traverse_util

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.config import BertConfig as JaxBertConfig  # noqa: E402
from bert_pytorch_tpu.data.sharded import (  # noqa: E402
    HostShardSampler as JaxSampler, PretrainingDataLoader as JaxLoader,
    ShardIndex as JaxShardIndex)
from bert_pytorch_tpu.models import BertForPreTraining as JaxPreTraining  # noqa: E402
from bert_pytorch_tpu.optim import lamb as jax_lamb  # noqa: E402
from bert_pytorch_tpu.optim import schedulers as jax_schedulers  # noqa: E402
from bert_pytorch_tpu.optim.lamb import \
    default_weight_decay_mask as jax_wd_mask  # noqa: E402
from bert_pytorch_tpu.training import pretrain as jax_pretrain  # noqa: E402
from bert_pytorch_tpu.training.state import TrainState as JaxState  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.data.sharded import (  # noqa: E402
    HostShardSampler, PretrainingDataLoader, ShardIndex)
from bert_pytorch_tpu_torch.models.bert import BertForPreTraining  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from bert_pytorch_tpu_torch.optim.lamb import Lamb  # noqa: E402
from bert_pytorch_tpu_torch.optim.schedulers import (  # noqa: E402
    make_schedule, poly_warmup_schedule)
from bert_pytorch_tpu_torch.training.pretrain import (  # noqa: E402
    build_pretrain_step, compute_params, gather_masked_labels,
    pretrain_loss_and_grads)
from bert_pytorch_tpu_torch.training.state import make_train_state  # noqa: E402
from tests.test_data import write_shard  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, P, V = 4, 32, 6, 128
CFG = dict(vocab_size=V, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=64, next_sentence=True,
           hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
N_SEEDS = 1 + 3 * CFG["num_hidden_layers"]
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4
PARAM_RTOL = 1e-4


def _jax_model(**over):
    cfg = JaxBertConfig(**dict(CFG, **over), dtype="float32",
                        stacked_params=False)
    return JaxPreTraining(cfg, dtype=jnp.float32)


def _port_model(flat, **over):
    model = BertForPreTraining(BertConfig.from_dict(dict(CFG, **over)),
                               dtype=torch.float32)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _batch(seed, rows=B):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, V, (rows, S)).astype(np.int32)
    labels = np.full((rows, S), -1, np.int32)
    for r in range(rows):
        for p in rng.choice(np.arange(1, S - 4), 4 + r % 3, replace=False):
            labels[r, p] = ids[r, p]
            ids[r, p] = 3
    mask = np.ones((rows, S), np.int32)
    mask[1, S - 6:] = 0
    types = np.zeros((rows, S), np.int32)
    types[:, S // 2:] = 1
    return {"input_ids": ids, "token_type_ids": types * mask,
            "attention_mask": mask, "masked_lm_labels": labels,
            "next_sentence_labels": rng.randint(0, 2, rows).astype(np.int32)}


@pytest.fixture(scope="module")
def init_params():
    model = _jax_model()
    s = jnp.zeros((1, S), jnp.int32)
    return unbox(model.init(jax.random.PRNGKey(0), s, s, s)["params"])


@pytest.fixture
def seed_recorder(monkeypatch):
    """Wrap the JAX package's two dropout entry points so every seed the
    JAX model draws lands in the returned list, in call order."""
    import bert_pytorch_tpu.models.bert as jax_bert
    import bert_pytorch_tpu.ops.attention as jax_attention

    seeds = []
    adln, hdrop = jax_bert.add_dropout_layer_norm, jax_attention.hash_dropout

    def rec_adln(x, residual, scale, bias, seed, *a, **k):
        seeds.append(int(seed))
        return adln(x, residual, scale, bias, seed, *a, **k)

    def rec_hdrop(x, seed, rate):
        seeds.append(int(seed))
        return hdrop(x, seed, rate)

    monkeypatch.setattr(jax_bert, "add_dropout_layer_norm", rec_adln)
    monkeypatch.setattr(jax_attention, "hash_dropout", rec_hdrop)
    return seeds


def _torch_batch(batch, accum=None):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    if accum is not None:
        out = {k: v.reshape(accum, -1, *v.shape[1:]) for k, v in out.items()}
    return out


def _assert_grads_close(port_grads, jax_grads):
    want = params_from_flax(_flat(jax_grads))
    assert set(port_grads) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(port_grads[k].numpy(), w.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_pretraining_params_convert_in_both_layouts(layout):
    """params_from_flax maps the pooler, cls_predictions/* and
    cls_seq_relationship/* in either encoder layout: the converted model
    loads strictly and its deterministic MLM (gathered) and NSP logits
    match JAX's."""
    cfg = JaxBertConfig(**CFG, dtype="float32",
                        stacked_params=layout == "stacked")
    jmodel = JaxPreTraining(cfg, dtype=jnp.float32)
    s = jnp.zeros((1, S), jnp.int32)
    params = unbox(jmodel.init(jax.random.PRNGKey(1), s, s, s)["params"])
    batch = _batch(1)
    positions, _ = jax_pretrain.gather_masked_labels(
        jnp.array(batch["masked_lm_labels"]), P)
    want = jmodel.apply({"params": params}, jnp.array(batch["input_ids"]),
                        jnp.array(batch["token_type_ids"]),
                        jnp.array(batch["attention_mask"]),
                        deterministic=True, masked_positions=positions)
    model = _port_model(_flat(params))
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in
                      ("input_ids", "token_type_ids", "attention_mask")),
                    masked_positions=torch.from_numpy(np.asarray(positions)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_gather_masked_labels_matches_jax():
    labels = _batch(3)["masked_lm_labels"]
    labels[0, :] = -1                     # a row with no masked token
    jpos, jlab = jax_pretrain.gather_masked_labels(jnp.array(labels), P)
    tpos, tlab = gather_masked_labels(torch.from_numpy(labels), P)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))


def test_one_step_with_dropout_matches_jax(init_params, seed_recorder):
    """Loss and every gradient of one microbatch with dropout on, the port
    fed the seeds the JAX model drew."""
    batch = _batch(0)
    loss_fn = jax_pretrain._pretrain_loss_fn(_jax_model(), P)
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        init_params, {k: jnp.array(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    assert len(seed_recorder) == N_SEEDS
    model = _port_model(_flat(init_params))
    gparams = compute_params(dict(model.named_parameters()), None)
    t_loss, t_aux, t_grads = pretrain_loss_and_grads(
        model, gparams, _torch_batch(batch),
        torch.tensor(seed_recorder, dtype=torch.int32), P)
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=LOSS_RTOL)
    assert int(t_aux["mlm_total"]) == int(aux["mlm_total"])
    _assert_grads_close(t_grads, grads)
    # the seeds matter: other seeds give another loss
    other = pretrain_loss_and_grads(
        model, gparams, _torch_batch(batch),
        torch.arange(N_SEEDS, dtype=torch.int32), P)[0]
    assert abs(other.item() - float(loss)) > 1e-4


def _jax_lamb(schedule):
    return jax_lamb(schedule, weight_decay=0.01,
                    weight_decay_mask=jax_wd_mask)


def _port_lamb(schedule):
    return Lamb(schedule, weight_decay=0.01)


def _assert_params_close(port_params, jax_params):
    want = params_from_flax(_flat(jax_params))
    for k, w in want.items():
        got = port_params[k]
        rel = (torch.linalg.vector_norm(got - w)
               / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
        assert rel <= PARAM_RTOL, (k, rel)


def test_three_step_trajectory_matches_jax(init_params, seed_recorder):
    """Three LAMB steps through JAX's un-jitted build_pretrain_step
    (accum 1, poly warmup: lr 0, base/2, then decaying), dropout on with
    the recorded seeds: losses and the final parameters."""
    jsched = jax_schedulers.poly_warmup_schedule(1e-2, total_steps=10,
                                                 warmup=0.2)
    tx = _jax_lamb(jsched)
    jstep = jax_pretrain.build_pretrain_step(_jax_model(), tx,
                                             schedule=jsched,
                                             max_predictions=P)
    state = JaxState(step=jnp.zeros([], jnp.int32), params=init_params,
                     opt_state=tx.init(init_params))
    model = _port_model(_flat(init_params))
    psched = poly_warmup_schedule(1e-2, total_steps=10, warmup=0.2)
    ptx = _port_lamb(psched)
    pstate = make_train_state(model, ptx)
    pstep = build_pretrain_step(model, ptx, schedule=psched,
                                max_predictions=P)
    for i in range(3):
        batch = _batch(10 + i)
        del seed_recorder[:]
        state, metrics = jstep(
            state, {k: jnp.array(v)[None] for k, v in batch.items()},
            jax.random.PRNGKey(100 + i))
        seeds = torch.tensor([seed_recorder], dtype=torch.int32)
        pm = pstep(pstate, _torch_batch(batch, accum=1), seeds)
        np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(pm["learning_rate"],
                                   float(metrics["learning_rate"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(metrics["grad_norm"]), rtol=1e-4)
    assert pstate.step == 3 and pstate.opt_state.count == 3
    _assert_params_close(pstate.params, state.params)


def test_accumulation_matches_jitted_jax_step(init_params):
    """Two microbatches accumulated, dropout 0, against the jitted JAX
    step: loss, grad norm and the updated parameters."""
    jsched = jax_schedulers.poly_warmup_schedule(1e-2, total_steps=10,
                                                 warmup=0.0)
    tx = _jax_lamb(jsched)
    no_dropout = dict(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    jstep = jax.jit(jax_pretrain.build_pretrain_step(
        _jax_model(**no_dropout), tx, schedule=jsched, accum_steps=2,
        max_predictions=P))
    state = JaxState(step=jnp.zeros([], jnp.int32), params=init_params,
                     opt_state=tx.init(init_params))
    batch = {k: np.concatenate([a, b]) for (k, a), b in
             zip(_batch(20).items(), _batch(21).values())}
    state, metrics = jstep(
        state, {k: jnp.array(v).reshape(2, B, *v.shape[1:])
                for k, v in batch.items()}, jax.random.PRNGKey(0))

    model = _port_model(_flat(init_params), **no_dropout)
    psched = poly_warmup_schedule(1e-2, total_steps=10, warmup=0.0)
    ptx = _port_lamb(psched)
    pstate = make_train_state(model, ptx)
    pstep = build_pretrain_step(model, ptx, schedule=psched, accum_steps=2,
                                max_predictions=P)
    pm = pstep(pstate, _torch_batch(batch, accum=2), None)
    np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(pm["grad_norm"].item(),
                               float(metrics["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(pm["mlm_accuracy"].item(),
                               float(metrics["mlm_accuracy"]))
    _assert_params_close(pstate.params, state.params)


@pytest.mark.parametrize("name", ["poly", "linear", "cosine", "constant"])
def test_schedules_match_jax(name):
    for offset in (0, 5):
        jsched = jax_schedulers.make_schedule(name, 3e-3, 40, warmup=0.1,
                                              offset=offset)
        psched = make_schedule(name, 3e-3, 40, warmup=0.1, offset=offset)
        for step in (0, 1, 3, 4, 5, 9, 17, 39, 40, 55):
            np.testing.assert_allclose(psched(step), float(jsched(step)),
                                       rtol=1e-6, atol=1e-12)


def test_lamb_matches_jax_on_random_tensors():
    """One LAMB update on hand-made leaves and bf16 gradients, including a
    zero-norm leaf (ratio 1) and a decay-masked bias."""
    rng = np.random.RandomState(7)
    params = {"w": rng.randn(8, 6).astype(np.float32),
              "layer_norm/scale": np.ones(6, np.float32),
              "b/bias": np.zeros(6, np.float32)}
    grads = {k: (rng.randn(*v.shape) * 3).astype(np.float32)
             for k, v in params.items()}
    tx = _jax_lamb(0.05)
    jp = {k: jnp.array(v) for k, v in params.items()}
    jg = {k: jnp.array(v).astype(jnp.bfloat16) for k, v in grads.items()}
    updates, _ = tx.update(jg, tx.init(jp), jp)
    want = {k: np.asarray(jp[k] + updates[k]) for k in jp}

    ptx = Lamb(0.05, weight_decay=0.01)
    names = {"w": "w", "layer_norm/scale": "layer_norm.scale",
             "b/bias": "b.bias"}
    pp = {names[k]: torch.from_numpy(v.copy()) for k, v in params.items()}
    pg = {names[k]: torch.from_numpy(np.array(
        jg[k].astype(jnp.float32))).to(torch.bfloat16) for k in grads}
    ptx.update(pg, ptx.init(pp), pp)
    for k, n in names.items():
        np.testing.assert_allclose(pp[n].numpy(), want[k], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("action", ["skip", "log"])
def test_nonfinite_step_counts_and_skip(action):
    """A NaN in one weight makes the loss and the bert gradients
    non-finite; under "skip" the step leaves the parameters and the LAMB
    state as they were, under "log" it applies the update."""
    from bert_pytorch_tpu_torch.models.bert import init_weights
    from bert_pytorch_tpu_torch.telemetry.health import HealthConfig

    model = BertForPreTraining(BertConfig.from_dict(CFG), dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.bert.encoder.layers[0].attention.output.weight[0, 0] = \
            float("nan")
    tx = Lamb(1e-2)
    state = make_train_state(model, tx)
    before = {k: v.clone() for k, v in state.params.items()}
    step = build_pretrain_step(model, tx, max_predictions=P,
                               health=HealthConfig(action))
    m = step(state, _torch_batch(_batch(0), accum=1), None)
    assert m["loss_nonfinite"].item() == 1
    assert m["grad_nonfinite_bert"].item() > 0
    assert m["grad_nonfinite"].item() == sum(
        m[k].item() for k in m if k.startswith("grad_nonfinite_"))
    assert state.step == 1
    name = "cls_predictions.transform.weight"
    if action == "skip":
        assert m["skipped_nonfinite"] == 1 and state.opt_state.count == 0
        for k, v in before.items():
            torch.testing.assert_close(state.params[k], v, rtol=0, atol=0,
                                       equal_nan=True)
    else:
        assert "skipped_nonfinite" not in m and state.opt_state.count == 1
        assert not torch.equal(state.params[name], before[name])


def _write_shards(root, n_files=2, n=24):
    root.mkdir(exist_ok=True)
    for i in range(n_files):
        write_shard(str(root / f"part_{i}.hdf5"), n, seq=S, seed=i)
    return root


def test_loader_batches_equal_jax(tmp_path):
    files = sorted(str(p) for p in _write_shards(tmp_path / "data")
                   .glob("*.hdf5"))
    kw = dict(batch_size=10, mask_token_index=3, max_pred_per_seq=P,
              masked_lm_prob=0.15, vocab_size=V, seed=9)
    jl = JaxLoader(JaxShardIndex(files), JaxSampler(48, seed=9), **kw)
    pl = PretrainingDataLoader(ShardIndex(files), HostShardSampler(48, seed=9),
                               prefetch_batches=2, **kw)
    try:
        for _ in range(2):             # two epochs: masks refresh
            got, want = list(pl), list(jl)
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            pl.reset_epoch()
            jl.reset_epoch()
    finally:
        pl.close()
        jl.close()


def _tiny_config(tmp_path):
    path = tmp_path / "tiny_config.json"
    path.write_text(json.dumps(CFG))
    return str(path)


def test_run_pretraining_main_on_cpu(tmp_path):
    from bert_pytorch_tpu_torch import run_pretraining

    data = _write_shards(tmp_path / "data")
    out = tmp_path / "out"
    argv = ["--config_file",
            os.path.join(REPO, "configs", "bert_pretraining_phase1_config.json"),
            "--model_config_file", _tiny_config(tmp_path),
            "--input_dir", str(data), "--output_dir", str(out),
            "--local_batch_size", "4", "--global_batch_size", "8",
            "--steps", "2", "--skip_checkpoint", "--device", "cpu"]
    lines = []
    result = run_pretraining.main(argv, log=lines.append)
    assert result.step == 2 and result.accum_steps == 2
    assert len(result.history) == 2
    for rec in result.history:
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        assert rec["loss_nonfinite"] == 0 and rec["grad_nonfinite"] == 0
    # phase 1's run config: lr 6e-3 with 28.43% of 7038 steps of warmup
    assert result.history[1]["learning_rate"] == pytest.approx(
        6e-3 / (0.2843 * 7038), rel=1e-5)
    assert sum("loss" in ln and "seq/s" in ln for ln in lines) == 2
    # the run config's log_prefix names the log: a header, then a train
    # record a step (a perf record every --log_freq steps)
    logged = [json.loads(ln) for ln in
              (out / "phase1_log.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in logged] == ["header", "train", "train"]
    # without --skip_checkpoint the run saves its last step (it used to
    # refuse to start before checkpointing was ported)
    again = run_pretraining.main(
        [a for a in argv if a != "--skip_checkpoint"], log=lines.append)
    assert again.step == 2 and again.resumed_from is None
    assert [s["step"] for s in again.saves] == [2]
    assert (out / "pretrain_ckpts" / "2" / "state.pt").is_file()


def test_run_pretraining_defaults_to_cuda(tmp_path, monkeypatch):
    from bert_pytorch_tpu_torch import run_pretraining

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _write_shards(tmp_path / "data", n_files=1)
    args = ["--model_config_file", _tiny_config(tmp_path), "--input_dir",
            str(data), "--output_dir", str(tmp_path / "out"),
            "--skip_checkpoint"]
    assert run_pretraining.parse_arguments(args).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pretraining.main(args, log=lambda m: None)


def test_chip_smoke_train_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's train phase at a tiny width on the CPU (the plain
    versions): the shards, the entry point's run and the kernels-vs-plain
    comparison all work before a card is asked for."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = tmp_path / "tiny_seq128.json"
    cfg.write_text(json.dumps(dict(CFG, max_position_embeddings=512)))
    summary = {}
    chip_smoke.phase_train(torch, np, summary, device="cpu",
                           cfg_path=str(cfg))
    train = summary["train"]
    assert train["steps"] == 3 and train["accum_steps"] == 2
    assert train["micro_batch"] == 96            # the run config's
    assert all(np.isfinite(train["losses"]))
    # the CPU runs the plain versions on both sides of the comparison
    assert train["launches"] == {k: 0 for k in train["launches"]}
    for name, res in train["kernels_vs_plain"].items():
        assert res["max_grad_rel_l2"] <= \
            chip_smoke.TRAIN_MODEL_TOL[name]["grad"]
