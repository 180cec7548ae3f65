"""The RoBERTa recipe (configs/roberta_pretraining_config.json over
configs/roberta_large_cased_config.json: no NSP, mask fraction 0.15, 80
predictions, linear decay, vocab 28996) in the port against the JAX
package, on the CPU at the tiny f32 width of tests/test_torch_pretrain.py
with next_sentence false: the model holds no pooler, no NSP head and no
token-type table, a pretraining step with dropout on (the seeds JAX drew)
gives JAX's loss, gradients and LAMB update, and the recipe's run config
parses to JAX's values and runs through the entry point.

Tolerances: the tiers of tests/test_torch_pretrain.py (loss 1e-5
relative, gradients 5e-4, parameters 1e-4 relative L2 per tensor)."""

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

from bert_pytorch_tpu.optim import schedulers as jax_schedulers  # noqa: E402
from bert_pytorch_tpu.training import pretrain as jax_pretrain  # noqa: E402
from bert_pytorch_tpu.training.state import TrainState as JaxState  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.optim.schedulers import (  # noqa: E402
    linear_warmup_schedule)
from bert_pytorch_tpu_torch.training.pretrain import (  # noqa: E402
    build_pretrain_step, compute_params, pretrain_loss_and_grads)
from bert_pytorch_tpu_torch.training.state import make_train_state  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_torch_pretrain import seed_recorder  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "roberta_pretraining_config.json")
NO_NSP = dict(next_sentence=False)


@pytest.fixture(scope="module")
def params():
    s = jnp.zeros((1, tp.S), jnp.int32)
    return unbox(jax.jit(tp._jax_model(**NO_NSP).init)(
        jax.random.PRNGKey(3), s, s, s)["params"])


def _no_nsp_batch(seed):
    batch = tp._batch(seed)
    batch.pop("next_sentence_labels")
    batch["token_type_ids"] = np.zeros_like(batch["token_type_ids"])
    return batch


def test_model_has_no_pooler_nsp_head_or_type_table(params):
    flat = tp._flat(params)
    assert not any(k.startswith(("bert/pooler", "cls_seq_relationship"))
                   or "token_type" in k for k in flat)
    model = tp._port_model(flat, **NO_NSP)
    names = dict(model.named_parameters())
    assert len(names) == len(flat)
    assert model.bert.pooler is None and model.cls_seq_relationship is None
    assert model.bert.embeddings.token_type_embeddings is None


def test_one_step_without_nsp_matches_jax(params, seed_recorder):
    """One microbatch's loss and gradients (no NSP term), then the LAMB
    update under the recipe's linear schedule, dropout on."""
    batch = _no_nsp_batch(7)
    loss_fn = jax_pretrain._pretrain_loss_fn(tp._jax_model(**NO_NSP), tp.P)
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, {k: jnp.array(v) for k, v in batch.items()},
        jax.random.PRNGKey(11))
    assert len(seed_recorder) == tp.N_SEEDS
    seeds = torch.tensor(seed_recorder, dtype=torch.int32)
    model = tp._port_model(tp._flat(params), **NO_NSP)
    gparams = compute_params(dict(model.named_parameters()), None)
    t_loss, _, t_grads = pretrain_loss_and_grads(
        model, gparams, tp._torch_batch(batch), seeds, tp.P)
    np.testing.assert_allclose(t_loss.item(), float(loss),
                               rtol=tp.LOSS_RTOL)
    tp._assert_grads_close(t_grads, grads)

    # the step: LAMB under a linear warmup-decay schedule
    jsched = jax_schedulers.linear_warmup_schedule(4e-3, total_steps=10,
                                                   warmup=0.06)
    tx = tp._jax_lamb(jsched)
    jstep = jax_pretrain.build_pretrain_step(tp._jax_model(**NO_NSP), tx,
                                             schedule=jsched,
                                             max_predictions=tp.P)
    del seed_recorder[:]
    jstate, jm = jstep(JaxState(step=jnp.zeros([], jnp.int32),
                                params=params, opt_state=tx.init(params)),
                       {k: jnp.array(v)[None] for k, v in batch.items()},
                       jax.random.PRNGKey(12))
    psched = linear_warmup_schedule(4e-3, total_steps=10, warmup=0.06)
    ptx = tp._port_lamb(psched)
    pstate = make_train_state(model, ptx)
    pm = build_pretrain_step(model, ptx, schedule=psched,
                             max_predictions=tp.P)(
        pstate, tp._torch_batch(batch, accum=1),
        torch.tensor([seed_recorder], dtype=torch.int32))
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                               rtol=tp.LOSS_RTOL)
    np.testing.assert_allclose(pm["learning_rate"],
                               float(jm["learning_rate"]), rtol=1e-6)
    tp._assert_params_close(pstate.params, jstate.params)


def test_recipe_config_parses_to_jax_values():
    """The run config's values through the port's parser and JAX's, and
    the [MASK] id: the config's vocab_file is absent here, so both
    entry points fall back to 103."""
    import run_pretraining as jax_entry
    from bert_pytorch_tpu.config import BertConfig as JaxBertConfig
    from bert_pytorch_tpu_torch.config import BertConfig

    port = run_pretraining.parse_arguments(["--config_file", RECIPE])
    jax_args = jax_entry.parse_arguments(["--config_file", RECIPE])
    for k in ("masked_token_fraction", "max_predictions_per_seq",
              "learning_rate", "lr_decay", "warmup_proportion",
              "global_batch_size", "local_batch_size", "max_steps",
              "kfac", "log_prefix", "model_config_file"):
        assert getattr(port, k) == getattr(jax_args, k), k
    assert (port.masked_token_fraction, port.max_predictions_per_seq,
            port.lr_decay, port.kfac) == (0.15, 80, "linear", False)
    cfg_path = os.path.join(REPO, port.model_config_file)
    config = BertConfig.from_json_file(cfg_path)
    assert config.next_sentence is False and config.vocab_size == 28996
    assert not os.path.exists(config.vocab_file or "")
    assert run_pretraining.find_mask_token_index(port, config) == 103
    jcfg = JaxBertConfig.from_json_file(cfg_path)
    assert jax_entry.find_mask_token_index(jax_args, jcfg) == 103
    run_pretraining._unsupported(port)


def test_recipe_runs_through_the_entry_point(tmp_path):
    """The recipe's run config with a tiny model of its shape (no NSP,
    vocab 28996 padded to 29056), 2 steps: finite losses, the linear
    schedule, LAMB over the model's tensors alone."""
    from tests.test_data import write_shard

    (tmp_path / "data").mkdir()
    for i in range(2):
        write_shard(str(tmp_path / "data" / f"part_{i}.hdf5"), 16, seq=32,
                    seed=i, nsp=False)
    with open(os.path.join(REPO, "configs",
                           "roberta_large_cased_config.json")) as f:
        cfg = json.load(f)
    cfg.update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=64)
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    lines = []
    res = run_pretraining.main([
        "--config_file", RECIPE, "--model_config_file",
        str(tmp_path / "tiny.json"), "--input_dir", str(tmp_path / "data"),
        "--output_dir", str(tmp_path / "out"), "--local_batch_size", "4",
        "--global_batch_size", "8", "--steps", "2", "--device", "cpu",
        "--tensorboard", "off", "--skip_checkpoint"], log=lines.append)
    assert res.step == 2 and all(np.isfinite(h["loss"])
                                 for h in res.history)
    assert res.history[0]["learning_rate"] == 0.0
    assert res.history[1]["learning_rate"] > 0
    state = res.state
    # 12 tensors a layer, 4 in the embeddings, 5 in the MLM head
    assert len(state.params) == len(state.opt_state.mu) == 2 * 12 + 9
    assert not any("pooler" in k or "seq_relationship" in k
                   or "token_type" in k for k in state.params)
    assert any("vocab=29056" in m and "[MASK]=103" in m for m in lines)
    assert (tmp_path / "out" / "roberta_log.jsonl").exists()
