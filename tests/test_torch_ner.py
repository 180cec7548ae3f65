"""The port's NER finetuning slice against the JAX package's, on the CPU,
at a tiny f32 width (2 layers, E=64, 4 heads of 16, I=128, seq 32-128,
where attention takes the plain route with hash dropout): CoNLL parsing
and encoding, macro F1 and the diagnostics, the token-classification
head and loss, one step with dropout on and a 3-step trajectory, the
entry points, and a CPU rehearsal of chip_smoke.py's finetune_ner phase.

The JAX head's dropout is flax nn.Dropout, a threefry Bernoulli mask the
port does not draw: the test records the mask flax drew (a wrapper of
jax.random.bernoulli, in the test only) and feeds it to the port's head
as `head_keep`, so the dropout-on step compares exactly; the encoder's
seeds come through test_torch_pretrain's seed recorder.

Tolerances (f32): encodings, the metric and integer outputs exactly; the
loss within 1e-6 on fixed logits; the step's loss within 1e-5 relative,
gradients within 5e-4 and parameters after 3 Adam steps within 1e-4
relative L2 per tensor (tests/test_torch_pretrain.py's tiers).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.config import BertConfig as JaxBertConfig  # noqa: E402
from bert_pytorch_tpu.data import ner as jner  # noqa: E402
from bert_pytorch_tpu.data import tokenization as jtok  # noqa: E402
from bert_pytorch_tpu.models import losses as jlosses  # noqa: E402
from bert_pytorch_tpu.optim.adam import fused_adam  # noqa: E402
from bert_pytorch_tpu.optim.lamb import \
    default_weight_decay_mask as jax_wd_mask  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.data import ner as tner  # noqa: E402
from bert_pytorch_tpu_torch.data import tokenization as ttok  # noqa: E402
from bert_pytorch_tpu_torch.models import losses as tlosses  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_torch_pretrain import seed_recorder  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["O", "B-PER", "I-PER", "B-ORG", "I-ORG", "B-LOC", "I-LOC",
          "B-MISC", "I-MISC"]
WORDS = ("john smith johns acme corp london paris said works at in the "
         "german british cup league met visited on monday").split()
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + [w for w in WORDS if w != "johns"] + ["##s", ".", ","])
S = 32
CFG = dict(vocab_size=len(VOCAB), hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=128, next_sentence=True,
           hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
N_LABELS = len(LABELS) + 1
LOSS_RTOL, GRAD_TOL, PARAM_RTOL = 1e-5, 5e-4, 1e-4


def write_conll(path, n_sentences, seed, max_words=40):
    """A synthetic CoNLL-2003 file: -DOCSTART- records, 4 columns, random
    words with the CoNLL-2003 tag set (B- then I- within an entity)."""
    rng = np.random.RandomState(seed)
    lines = ["-DOCSTART- -X- -X- O", ""]
    kinds = ["PER", "ORG", "LOC", "MISC"]
    for s in range(n_sentences):
        if s and s % 7 == 0:
            lines += ["-DOCSTART- -X- -X- O", ""]
        n, i = int(rng.randint(3, max_words)), 0
        while i < n:
            if rng.rand() < 0.3:
                kind = kinds[rng.randint(4)]
                for j in range(int(rng.randint(1, 3))):
                    w = WORDS[rng.randint(len(WORDS))].capitalize()
                    lines.append(f"{w} NNP B-NP {'BI'[j > 0]}-{kind}")
                    i += 1
            else:
                lines.append(f"{WORDS[rng.randint(len(WORDS))]} NN I-NP O")
                i += 1
        lines.append(". . O O")
        lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _tokenizers():
    vocab = {t: i for i, t in enumerate(VOCAB)}
    return (jtok.BertWordPieceTokenizer(vocab),
            ttok.get_wordpiece_tokenizer(vocab))


@pytest.mark.parametrize("max_seq_len", [S, 128])
def test_ner_encoding_equals_jax(tmp_path, max_seq_len):
    """parse_conll and NERDataset.arrays, truncation at 32 included."""
    path = write_conll(tmp_path / "train.txt", 20, seed=0)
    jtk, ttk = _tokenizers()
    js, ts = jner.parse_conll(path), tner.parse_conll(path)
    assert [(s.words, s.labels) for s in ts] == \
        [(s.words, s.labels) for s in js]
    ja = jner.NERDataset(path, jtk, LABELS, max_seq_len).arrays()
    ta = tner.NERDataset(path, ttk, LABELS, max_seq_len).arrays()
    assert set(ta) == set(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # word pieces carry their word's label; [CLS]/[SEP]/padding ignored
    assert (ta["labels"][:, 0] == tner.IGNORE_LABEL).all()
    if max_seq_len == S:
        assert (ta["attention_mask"].sum(1) == S).any()   # truncated rows


def test_macro_f1_and_diagnostics_equal_jax():
    """The port's numpy macro F1 and diagnostics against the JAX
    package's sklearn ones, with ignored positions and classes that are
    only predicted or only present."""
    rng = np.random.RandomState(1)
    for trial in range(6):
        logits = rng.randn(5, 24, N_LABELS).astype(np.float32)
        labels = rng.randint(1, N_LABELS - 2 * (trial % 2), (5, 24))
        labels[:, 0] = tner.IGNORE_LABEL
        labels[:, -3:] = tner.IGNORE_LABEL
        labels[1, 5:9] = 0
        labels = labels.astype(np.int32)
        assert tner.macro_f1(logits, labels) == jner.macro_f1(logits,
                                                              labels)
        for names in (None, LABELS):
            assert tner.classification_diagnostics(
                logits, labels, names) == jner.classification_diagnostics(
                    logits, labels, names)


def test_token_classification_loss_equals_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 16, N_LABELS).astype(np.float32)
    labels = rng.randint(1, N_LABELS, (3, 16)).astype(np.int32)
    labels[:, :2] = -100
    want = jlosses.token_classification_loss(jnp.array(logits),
                                             jnp.array(labels))
    got = tlosses.token_classification_loss(torch.from_numpy(logits),
                                            torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _jax_model():
    from bert_pytorch_tpu.models import BertForTokenClassification

    cfg = JaxBertConfig(**CFG, dtype="float32", stacked_params=False)
    return BertForTokenClassification(cfg, num_labels=N_LABELS,
                                      dtype=jnp.float32)


def _port_model(flat):
    from bert_pytorch_tpu_torch.models.bert import BertForTokenClassification

    model = BertForTokenClassification(BertConfig.from_dict(CFG),
                                       num_labels=N_LABELS,
                                       dtype=torch.float32)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model


@pytest.fixture(scope="module")
def ner_params():
    s = jnp.zeros((1, S), jnp.int32)
    return unbox(_jax_model().init(jax.random.PRNGKey(0), s, None,
                                   s)["params"])


def _batch(seed, rows=4):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, len(VOCAB), (rows, S)).astype(np.int32)
    mask = np.ones((rows, S), np.int32)
    mask[1, 20:] = 0
    labels = rng.randint(1, N_LABELS, (rows, S)).astype(np.int32)
    labels[:, 0] = -100
    labels[mask == 0] = -100
    return {"input_ids": ids * mask, "attention_mask": mask,
            "labels": labels}


def test_classifier_head_converts_and_matches_jax(ner_params):
    """params_from_flax maps the `classifier` head; the deterministic
    logits match JAX's."""
    batch = _batch(1)
    want = _jax_model().apply({"params": ner_params},
                              jnp.array(batch["input_ids"]), None,
                              jnp.array(batch["attention_mask"]),
                              deterministic=True)
    model = _port_model(tp._flat(ner_params))
    from bert_pytorch_tpu_torch.tasks.predict import build_ner_forward

    with torch.no_grad():
        got = build_ner_forward(model)(
            {k: torch.from_numpy(batch[k])
             for k in ("input_ids", "attention_mask")})
    assert got.dtype == torch.float32 and got.shape == (4, S, N_LABELS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture
def head_mask_recorder(monkeypatch):
    """Every mask flax's nn.Dropout draws (jax.random.bernoulli), in
    order."""
    masks = []
    real = jax.random.bernoulli

    def rec(key, p=0.5, shape=None, **kw):
        out = real(key, p, shape, **kw)
        masks.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", rec)
    return masks


def _jax_loss_builder(model):
    def loss_fn(params, batch, rng, deterministic=False):
        logits = model.apply(
            {"params": params}, batch["input_ids"], None,
            batch["attention_mask"], deterministic=deterministic,
            rngs=None if deterministic else {"dropout": rng})
        return jlosses.token_classification_loss(logits, batch["labels"]), {}
    return loss_fn


def _port_seeds(recorded):
    # the encoder's 1 + 3L seeds JAX drew, then the head's (unused: the
    # head takes flax's mask as head_keep)
    return torch.tensor(list(recorded) + [0], dtype=torch.int32)


def test_ner_step_with_dropout_matches_jax(ner_params, seed_recorder,
                                           head_mask_recorder):
    from bert_pytorch_tpu_torch.tasks.ner_task import _loss_builder
    from bert_pytorch_tpu_torch.training.pretrain import (compute_params,
                                                          loss_and_grads)

    batch = _batch(0)
    (loss, _), grads = jax.value_and_grad(
        _jax_loss_builder(_jax_model()), has_aux=True)(
        ner_params, {k: jnp.array(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    layers = CFG["num_hidden_layers"]
    assert len(seed_recorder) == 1 + 3 * layers
    (mask,) = head_mask_recorder
    assert mask.shape == (4, S, CFG["hidden_size"]) and not mask.all()
    model = _port_model(tp._flat(ner_params))
    gparams = compute_params(dict(model.named_parameters()), None)
    micro = dict(tp._torch_batch(batch), head_keep=torch.from_numpy(mask))
    t_loss, _, t_grads = loss_and_grads(_loss_builder(model), gparams, micro,
                                        _port_seeds(seed_recorder))
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=LOSS_RTOL)
    want = params_from_flax(tp._flat(grads))
    assert set(t_grads) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(t_grads[k].numpy(), w.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    # without the mask the head draws its own (hash) mask from its seed
    other = loss_and_grads(_loss_builder(model), gparams,
                           tp._torch_batch(batch),
                           _port_seeds(seed_recorder))[0]
    assert abs(other.item() - float(loss)) > 1e-5


def test_ner_three_step_trajectory_matches_jax(ner_params, seed_recorder,
                                               head_mask_recorder):
    """Three steps of JAX's build_pretrain_step(loss_fn_builder=...) with
    the NER recipe (clip 5.0, fused_adam without bias correction, the
    per-epoch decay lr / (1 + 0.05 epoch) over 2-step epochs) against
    the port's step with FusedAdam."""
    from bert_pytorch_tpu.training import pretrain as jax_pretrain
    from bert_pytorch_tpu.training.state import TrainState as JaxState
    from bert_pytorch_tpu_torch.optim.adam import FusedAdam
    from bert_pytorch_tpu_torch.tasks.ner_task import _loss_builder
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    def sched(step):
        return 1e-3 / (1.0 + 0.05 * (step // 2))

    jtx = optax.chain(optax.clip_by_global_norm(5.0),
                      fused_adam(sched, weight_decay=0.01,
                                 weight_decay_mask=jax_wd_mask))
    jstep = jax_pretrain.build_pretrain_step(
        _jax_model(), jtx, schedule=sched,
        loss_fn_builder=_jax_loss_builder)
    state = JaxState(step=jnp.zeros([], jnp.int32), params=ner_params,
                     opt_state=jtx.init(ner_params))
    model = _port_model(tp._flat(ner_params))
    ptx = FusedAdam(sched, weight_decay=0.01, max_grad_norm=5.0)
    pstate = make_train_state(model, ptx)
    pstep = build_pretrain_step(model, ptx, schedule=sched,
                                loss_fn_builder=_loss_builder)
    for i in range(3):
        batch = _batch(10 + i)
        del seed_recorder[:], head_mask_recorder[:]
        state, metrics = jstep(
            state, {k: jnp.array(v)[None] for k, v in batch.items()},
            jax.random.PRNGKey(100 + i))
        tb = dict(tp._torch_batch(batch, accum=1),
                  head_keep=torch.from_numpy(head_mask_recorder[0])[None])
        pm = pstep(pstate, tb, _port_seeds(seed_recorder)[None])
        np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(pm["learning_rate"],
                                   float(metrics["learning_rate"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(metrics["grad_norm"]), rtol=1e-4)
    assert pstate.step == 3 and pstate.opt_state.count == 3
    tp._assert_params_close(pstate.params, state.params)


def _files(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    cfg = dict(CFG, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               lowercase=True, tokenizer="wordpiece", vocab_file=str(vocab))
    cfg_path = tmp_path / "model_config.json"
    cfg_path.write_text(json.dumps(cfg))
    return (str(cfg_path),
            *(write_conll(tmp_path / f"{split}.txt", n, seed=seed)
              for split, n, seed in (("train", 6, 3), ("val", 3, 4),
                                     ("test", 3, 5))))


def _ner_argv(cfg, train, val, test, out):
    return ["--train_file", train, "--val_file", val, "--test_file", test,
            "--labels", *LABELS, "--model_config_file", cfg,
            "--epochs", "2", "--lr", "1e-3", "--batch_size", "4",
            "--max_seq_len", str(S), "--output_dir", str(out),
            "--dtype", "float32"]


def test_run_ner_main_on_cpu_writes_what_jax_writes(tmp_path):
    """run_ner --device cpu end to end (2 epochs, val F1 each epoch, test
    F1 and diagnostics, a checkpoint) beside the JAX entry point on the
    same files: the same result keys and output files."""
    import run_ner as jax_run_ner
    from bert_pytorch_tpu_torch import run_ner

    files = _files(tmp_path)
    want = jax_run_ner.main(_ner_argv(*files, tmp_path / "jax"))
    lines = []
    got = run_ner.main(_ner_argv(*files, tmp_path / "port")
                       + ["--device", "cpu"], log=lines.append)
    assert set(got) == set(want)
    assert 0.0 <= got["test_f1"] <= 1.0 and 0.0 <= got["val_f1"] <= 1.0
    assert set(got["test_diagnostics"]) == set(want["test_diagnostics"])
    port = set(os.listdir(tmp_path / "port"))
    assert port <= set(os.listdir(tmp_path / "jax"))
    assert {"ckpt", "ner_log.jsonl"} <= port
    assert os.listdir(tmp_path / "port" / "ckpt") == ["4"]   # 2 x 2 steps
    train = [json.loads(x) for x in (tmp_path / "port" / "ner_log.jsonl")
             .read_text().splitlines()]
    assert [r["epoch"] for r in train if r["tag"] == "train"] == [0, 1]
    assert sum("[val]" in ln for ln in lines) == 2


def test_run_finetune_task_ner(tmp_path):
    from bert_pytorch_tpu_torch import run_finetune

    files = _files(tmp_path)
    got = run_finetune.main(["--task", "ner"]
                            + _ner_argv(*files, tmp_path / "out")
                            + ["--device", "cpu"], log=lambda m: None)
    assert {"val_f1", "test_f1", "training_sequences_per_second"} <= set(got)


def test_chip_smoke_finetune_ner_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's finetune_ner phase at a tiny width on the CPU (the
    plain versions): synthetic CoNLL-2003 splits, 3 steps through
    run_task, val and test macro F1, a checkpoint."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(CFG, vocab_size=30522)))
    summary = {}
    chip_smoke.phase_finetune_ner(torch, np, summary, device="cpu",
                                  cfg_path=str(cfg), batch=4)
    res = summary["finetune_ner"]
    assert res["steps"] == 3 and res["checkpoint_steps"] == [3]
    assert all(np.isfinite(res["losses"]))
    assert 0.0 <= res["val_f1"] <= 1.0 and 0.0 <= res["test_f1"] <= 1.0
    assert res["launches"] == {k: 0 for k in res["launches"]}
    layers = CFG["num_hidden_layers"]
    assert res["launches_predicted"]["add_dropout_layer_norm_fwd"] == \
        2 * layers * 3
    assert res["launches_predicted"]["flash_attention_fwd"] == 0
    # the microbatch held against the plain versions (plain on both sides
    # here)
    assert set(res["kernels_vs_plain"]) == {"bfloat16", "float32"}
