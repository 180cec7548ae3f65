"""The port's SQuAD finetuning slice against the JAX package's, on the CPU,
at a tiny f32 width (2 layers, E=64, 4 heads of 16, I=128; the pooler
built, as BERT-Large's config builds it, and unused by the QA head):
featurization, batches and evaluation, FusedAdam with the global-norm
clip, one QA step with dropout on and a 3-step trajectory at seq 384
(where attention takes the flash route), the entry points, their
refusals, and a CPU rehearsal of chip_smoke.py's finetune_squad phase.

The JAX side runs its Pallas flash kernels in interpret mode
(BPT_PALLAS_INTERPRET=1) inside a jitted step, its dropout seeds handed
out through ordered debug callbacks (tests/test_torch_flash_train.py's
recorder); the port runs the kernels' plain versions.

Tolerances (f32): featurization, batches, evaluation and integer outputs
exactly; Adam and the clip on random tensors within 1e-6 relative (1e-7
absolute), the tiers of test_lamb_matches_jax_on_random_tensors; the
step's loss within 1e-5 relative and every gradient within 5e-4 (the
flash-attention gradient tier of tests/test_pallas.py); parameters after
3 Adam steps within 1e-4 relative L2 per tensor (tests/test_torch_pretrain.py).
"""

import argparse
import importlib
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.config import BertConfig as JaxBertConfig  # noqa: E402
from bert_pytorch_tpu.data import tokenization as jtok  # noqa: E402
from bert_pytorch_tpu.models import losses as jlosses  # noqa: E402
from bert_pytorch_tpu.optim.adam import fused_adam  # noqa: E402
from bert_pytorch_tpu.optim.lamb import \
    default_weight_decay_mask as jax_wd_mask  # noqa: E402
from bert_pytorch_tpu.tasks import squad as jsquad  # noqa: E402
from bert_pytorch_tpu.training import finetune as jft  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.data import tokenization as ttok  # noqa: E402
from bert_pytorch_tpu_torch.models import losses as tlosses  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import (  # noqa: E402
    params_from_flax)
from bert_pytorch_tpu_torch.optim.adam import FusedAdam  # noqa: E402
from bert_pytorch_tpu_torch.tasks import squad as tsquad  # noqa: E402
from bert_pytorch_tpu_torch.training import finetune as tft  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402

jfa = importlib.import_module("bert_pytorch_tpu.ops.pallas.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 384
WORDS = ("the cat sat on a mat while dog ran in park and red blue green "
         "server packs rows of city report river bridge north south east "
         "west morning people walked across old new market street").split()
QUESTIONS = ("who sat on the mat ?", "where did the dog run ?",
             "what packs rows ?")
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
         + ["who", "where", "did", "what", "does", ".", "?", "##s", "##ed"])
CFG = dict(vocab_size=len(VOCAB), hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=S, next_sentence=True,
           hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
LOSS_RTOL, GRAD_TOL, PARAM_RTOL = 1e-5, 5e-4, 1e-4
# Tensors whose QA gradient is zero in exact arithmetic: the softmax over
# positions does not change when one constant is added to every
# position's logit, which qa_outputs.bias does and, through the head, the
# last layer's output LayerNorm bias. Both frameworks leave rounding noise
# there (~1e-8 against gradients of ~1e-2), of either sign, which Adam
# without bias correction turns into steps of up to ~3.2 lr: those two are
# held to that bound on both sides, every other tensor to PARAM_RTOL.
SHIFT_INVARIANT = ("qa_outputs.bias",
                   f"bert.encoder.layers.{CFG['num_hidden_layers'] - 1}"
                   ".output_layer_norm.bias")


def write_squad(path, n_paragraphs, seed, v2=False, lengths=(30, 300)):
    """A synthetic SQuAD file: contexts of random words (some long enough
    to slide several windows), each with questions whose answer is a span
    of its context (v2: every third one impossible)."""
    rng = np.random.RandomState(seed)
    paras = []
    for p in range(n_paragraphs):
        toks = [WORDS[i] for i in rng.randint(0, len(WORDS),
                                              rng.randint(*lengths))]
        # a sentence ends every 10 words
        text = " ".join(w if (i + 1) % 10 else w + " ."
                        for i, w in enumerate(toks))
        words = text.split(" ")
        qas = []
        for q in range(2):
            qid = f"p{p}q{q}"
            if v2 and (2 * p + q) % 3 == 2:
                qas.append({"id": qid, "question": QUESTIONS[q],
                            "answers": [], "is_impossible": True})
                continue
            a0 = int(rng.randint(0, len(words) - 3))
            ans = " ".join(words[a0:a0 + 1 + q])
            start = len(" ".join(words[:a0])) + (1 if a0 else 0)
            qa = {"id": qid, "question": QUESTIONS[q + p % 2],
                  "answers": [{"text": ans, "answer_start": start}]}
            if v2:
                qa["is_impossible"] = False
            qas.append(qa)
        paras.append({"context": text, "qas": qas})
    path.write_text(json.dumps({"version": "2.0" if v2 else "1.1",
                                "data": [{"title": "t",
                                          "paragraphs": paras}]}))
    return str(path)


def _vocab_dict():
    return {t: i for i, t in enumerate(VOCAB)}


def _tokenizers():
    return (jtok.BertWordPieceTokenizer(_vocab_dict()),
            ttok.get_wordpiece_tokenizer(_vocab_dict()))


def _fields(obj):
    return dict(vars(obj))


@pytest.mark.parametrize("v2", [False, True])
def test_squad_training_features_equal_jax(tmp_path, v2):
    """Examples, training features (spans in and out of the window, v2's
    impossible -> [CLS] targets) and their arrays, exactly."""
    path = write_squad(tmp_path / "train.json", 8, seed=int(v2), v2=v2)
    jtk, ttk = _tokenizers()
    jex = jsquad.read_squad_examples(path, True, v2)
    tex = tsquad.read_squad_examples(path, True, v2)
    assert [_fields(e) for e in tex] == [_fields(e) for e in jex]
    assert any(e.is_impossible for e in tex) == v2
    for seq, stride in ((128, 32), (S, 128)):
        jf = jsquad.convert_examples_to_features(jex, jtk, seq, stride, 16,
                                                 True)
        tf = tsquad.convert_examples_to_features(tex, ttk, seq, stride, 16,
                                                 True)
        assert [_fields(f) for f in tf] == [_fields(f) for f in jf]
        if seq == 128:
            # windows slide and some answers fall outside their window
            assert max(f.doc_span_index for f in tf) > 0
            assert any(f.start_position == 0 and not f.is_impossible
                       for f in tf)
        ja, ta = (m.features_to_arrays(f, True) for m, f in
                  ((jsquad, jf), (tsquad, tf)))
        assert set(ja) == set(ta)
        for k in ja:
            assert ta[k].dtype == ja[k].dtype
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # the eval (is_training=False) arm too
    jev = jsquad.read_squad_examples(path, False, v2)
    tev = tsquad.read_squad_examples(path, False, v2)
    assert [_fields(e) for e in tev] == [_fields(e) for e in jev]


def test_cached_features_round_trip(tmp_path):
    path = write_squad(tmp_path / "train.json", 2, seed=3)
    _, ttk = _tokenizers()
    ex = tsquad.read_squad_examples(path, True)
    calls = []

    def build():
        calls.append(1)
        return tsquad.convert_examples_to_features(ex, ttk, 128, 32, 16,
                                                   True)

    cache = str(tmp_path / "feats.pkl")
    first = tsquad.cached_features(cache, build)
    again = tsquad.cached_features(cache, build)
    assert calls == [1]
    assert [_fields(f) for f in again] == [_fields(f) for f in first]


def _arrays(tmp_path, seq=128):
    path = write_squad(tmp_path / "train.json", 6, seed=5)
    _, ttk = _tokenizers()
    feats = tsquad.convert_examples_to_features(
        tsquad.read_squad_examples(path, True), ttk, seq, 32, 16, True)
    arrays = tsquad.features_to_arrays(feats, True)
    arrays.pop("unique_ids")
    return arrays


@pytest.mark.parametrize("accum", [1, 2])
def test_plain_train_batches_equal_jax(tmp_path, accum):
    arrays = _arrays(tmp_path)
    ignore = {"start_positions": -1, "end_positions": -1}
    for seed in (0, 43):
        jb = list(jft.plain_train_batches(arrays, 4, accum, True, seed,
                                          ignore))
        tb = list(tft.plain_train_batches(arrays, 4, accum, True, seed,
                                          ignore))
        assert len(tb) == len(jb) > 2
        for (tbatch, treal, tn), (jbatch, jreal, jn) in zip(tb, jb):
            assert (treal, tn) == (jreal, jn)
            assert set(tbatch) == set(jbatch)
            for k in jbatch:
                np.testing.assert_array_equal(tbatch[k], jbatch[k])
    # the last batch is padded with ignored labels
    assert (tb[-1][0]["start_positions"].reshape(-1)[tb[-1][2]:]
            == -1).all()


def test_bucketed_eval_batches_and_buckets_equal_jax(tmp_path):
    arrays = _arrays(tmp_path, seq=S)
    assert tft.eval_buckets(S) == jft.eval_buckets(S) == (32, 64, 128, 256,
                                                          384)
    assert tft.eval_buckets(128) == jft.eval_buckets(128)
    for ignore in (None, {"start_positions": -1}):
        jb = list(jft.bucketed_eval_batches(arrays, 3, jft.eval_buckets(S),
                                            ignore))
        tb = list(tft.bucketed_eval_batches(arrays, 3, tft.eval_buckets(S),
                                            ignore))
        assert len(tb) == len(jb)
        assert len({b for _, _, b in tb}) > 1
        for (tbatch, tidx, tbk), (jbatch, jidx, jbk) in zip(tb, jb):
            assert tbk == jbk
            np.testing.assert_array_equal(tidx, jidx)
            for k in jbatch:
                np.testing.assert_array_equal(tbatch[k], jbatch[k])
    args = types.SimpleNamespace(batch_size=4, epochs=3, max_steps=5,
                                 packing=False, seed=0)
    assert tft.epoch_steps(arrays, args) == jft.epoch_steps(arrays, args)


@pytest.mark.parametrize("v2", [False, True])
def test_evaluate_equals_jax(tmp_path, v2):
    path = write_squad(tmp_path / "dev.json", 5, seed=7, v2=v2)
    ex = tsquad.read_squad_examples(path, False, v2)
    golds = {}
    for para in json.loads(open(path).read())["data"][0]["paragraphs"]:
        for qa in para["qas"]:
            golds[qa["id"]] = [a["text"] for a in qa["answers"]]
    preds = {}
    for i, e in enumerate(ex):
        gold = golds[e.qas_id]
        if i % 5 == 4:
            continue                                   # missing
        if i % 5 == 0 or not gold:
            preds[e.qas_id] = gold[0] if gold else ""  # exact
        elif i % 5 == 1:
            preds[e.qas_id] = "the " + gold[0] + " mat"  # partial
        else:
            preds[e.qas_id] = "" if i % 5 == 2 else "north"
    for name in ("evaluate_v1", "evaluate_v2"):
        want = getattr(jsquad, name)(path, preds)
        got = getattr(tsquad, name)(path, preds)
        assert got == want, name


def test_qa_loss_equals_jax():
    rng = np.random.RandomState(0)
    start = rng.randn(4, 32).astype(np.float32) * 3
    end = rng.randn(4, 32).astype(np.float32) * 3
    sp = np.array([3, -1, 40, 31], np.int32)   # -1 and 40: out of window
    ep = np.array([5, 7, 2, 32], np.int32)
    want = jlosses.qa_loss(*(jnp.array(a) for a in (start, end, sp, ep)))
    got = tlosses.qa_loss(*(torch.from_numpy(a) for a in (start, end, sp,
                                                          ep)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# -- FusedAdam and the clip ---------------------------------------------------

_NAMES = {"w": "w", "layer_norm/scale": "layer_norm.scale",
          "b/bias": "b.bias", "classifier/bias": "classifier.bias",
          "bert/pooler/dense/kernel": "bert.pooler.dense.weight"}


@pytest.mark.parametrize("bias_correction", [False, True])
@pytest.mark.parametrize("clip", [None, 0.5, 1e3])
def test_fused_adam_and_clip_match_jax(clip, bias_correction):
    """Two updates of optax.chain(clip_by_global_norm, fused_adam) against
    FusedAdam on hand-made leaves: a decayed weight, a LayerNorm scale and
    two biases (no decay), and a weight with a zero gradient (the unused
    pooler: weight decay alone moves it). Clip 0.5 triggers, 1e3 not."""
    rng = np.random.RandomState(11)
    params = {"w": rng.randn(8, 6).astype(np.float32),
              "layer_norm/scale": np.ones(6, np.float32),
              "b/bias": rng.randn(6).astype(np.float32),
              "classifier/bias": np.zeros(3, np.float32),
              "bert/pooler/dense/kernel": rng.randn(6, 6).astype(np.float32)}
    sched = lambda step: 1e-3 * (step + 1)  # noqa: E731
    jtx = fused_adam(sched, weight_decay=0.01, weight_decay_mask=jax_wd_mask,
                     bias_correction=bias_correction)
    if clip is not None:
        jtx = optax.chain(optax.clip_by_global_norm(clip), jtx)
    ptx = FusedAdam(sched, weight_decay=0.01,
                    bias_correction=bias_correction, max_grad_norm=clip)
    jp = {k: jnp.array(v) for k, v in params.items()}
    js = jtx.init(jp)
    pp = {_NAMES[k]: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = ptx.init(pp)
    for it in range(2):
        grads = {k: (rng.randn(*v.shape) * 2).astype(np.float32)
                 for k, v in params.items()}
        grads["bert/pooler/dense/kernel"][:] = 0.0
        updates, js = jtx.update({k: jnp.array(v) for k, v in grads.items()},
                                 js, jp)
        jp = optax.apply_updates(jp, updates)
        ptx.update({_NAMES[k]: torch.from_numpy(v) for k, v in grads.items()},
                   ps, pp)
        for k, n in _NAMES.items():
            np.testing.assert_allclose(pp[n].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after {it + 1}")
    assert ps.count == 2
    pooler = pp["bert.pooler.dense.weight"].numpy()
    assert not np.array_equal(pooler, params["bert/pooler/dense/kernel"])
    assert np.all(ps.mu["bert.pooler.dense.weight"].numpy() == 0)


# -- one QA step and a trajectory at seq 384 (the flash route) ---------------


def _jax_qa_model():
    from bert_pytorch_tpu.models import BertForQuestionAnswering

    cfg = JaxBertConfig(**CFG, dtype="float32", stacked_params=False)
    return BertForQuestionAnswering(cfg, dtype=jnp.float32)


def _jax_qa_loss_builder(model):
    def loss_fn(params, batch, rng, deterministic=False):
        start, end = model.apply(
            {"params": params}, batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"], deterministic=deterministic,
            rngs=None if deterministic else {"dropout": rng})
        return jlosses.qa_loss(start, end, batch["start_positions"],
                               batch["end_positions"]), {}
    return loss_fn


def _port_qa_model(flat):
    from bert_pytorch_tpu_torch.models.bert import BertForQuestionAnswering

    model = BertForQuestionAnswering(BertConfig.from_dict(CFG),
                                     dtype=torch.float32)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model


def _qa_batch(seed, rows=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, len(VOCAB), (rows, S)).astype(np.int32)
    mask = np.ones((rows, S), np.int32)
    mask[0, 300:] = 0
    types = np.zeros((rows, S), np.int32)
    types[:, 20:] = 1
    return {"input_ids": ids * mask, "token_type_ids": types * mask,
            "attention_mask": mask,
            "start_positions": np.array([rng.randint(20, 300), -1][:rows],
                                        np.int32),
            "end_positions": np.array([rng.randint(300, 320), 390][:rows],
                                      np.int32)}


@pytest.fixture(scope="module")
def qa_params():
    s = jnp.zeros((1, S), jnp.int32)
    return unbox(_jax_qa_model().init(jax.random.PRNGKey(0), s, s,
                                      s)["params"])


@pytest.fixture
def flash_seed_recorder(monkeypatch):
    """JAX on its flash route (Pallas interpret mode) with its dropout
    entry points wrapped: each seed leaves a jitted program through an
    ordered debug callback, in the order the port takes them; `routes`
    records each flash call."""
    import bert_pytorch_tpu.models.bert as jax_bert
    import bert_pytorch_tpu.ops.attention as jax_attention

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
    return types.SimpleNamespace(seeds=seeds, routes=routes)


def test_qa_step_with_dropout_matches_jax(qa_params, flash_seed_recorder):
    """One QA microbatch at seq 384, dropout 0.1: loss and every gradient
    (the unused pooler's zeros included), the port fed the seeds JAX
    drew; both frameworks take their flash route."""
    from bert_pytorch_tpu_torch.ops import attention as tatt
    from bert_pytorch_tpu_torch.training.pretrain import (compute_params,
                                                          loss_and_grads)
    from bert_pytorch_tpu_torch.tasks.squad_task import _loss_builder

    rec = flash_seed_recorder
    batch = _qa_batch(0)
    loss_fn = _jax_qa_loss_builder(_jax_qa_model())
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        qa_params, {k: jnp.array(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    jax.effects_barrier()
    layers = CFG["num_hidden_layers"]
    assert len(rec.seeds) == 1 + 3 * layers
    assert rec.routes == [True] * layers
    model = _port_qa_model(tp._flat(qa_params))
    q = torch.zeros(1, S, 4, 16)
    assert tatt.takes_flash(q, q)
    gparams = compute_params(dict(model.named_parameters()), None)
    t_loss, _, t_grads = loss_and_grads(
        _loss_builder(model), gparams, tp._torch_batch(batch),
        torch.tensor(rec.seeds, dtype=torch.int32))
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=LOSS_RTOL)
    want = params_from_flax(tp._flat(grads))
    assert set(t_grads) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(t_grads[k].numpy(), w.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    assert not t_grads["bert.pooler.dense.weight"].any()
    total = max(float(w.norm()) for w in want.values())
    for k in SHIFT_INVARIANT:
        assert float(want[k].norm()) < 1e-5 * total
        assert float(t_grads[k].norm()) < 1e-5 * total


def test_qa_three_step_trajectory_matches_jax(qa_params, flash_seed_recorder):
    """Three steps of JAX's build_pretrain_step(loss_fn_builder=...) with
    its finetune recipe (finetune_optimizer: linear warmup, fused_adam
    without bias correction, clip 1.0), jitted, against the port's step
    with FusedAdam: loss, lr, grad norm per step, and the parameters."""
    from bert_pytorch_tpu.training import pretrain as jax_pretrain
    from bert_pytorch_tpu.training.state import TrainState as JaxState
    from bert_pytorch_tpu_torch.optim.schedulers import (
        linear_warmup_schedule)
    from bert_pytorch_tpu_torch.tasks.squad_task import _loss_builder
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    rec = flash_seed_recorder
    lr, total = 1e-3, 10
    jargs = types.SimpleNamespace(lr=lr, warmup_proportion=0.2,
                                  clip_grad=1.0)
    jsched, jtx = jft.finetune_optimizer(jargs, total)
    jstep = jax.jit(jax_pretrain.build_pretrain_step(
        _jax_qa_model(), jtx, schedule=jsched,
        loss_fn_builder=_jax_qa_loss_builder))
    state = JaxState(step=jnp.zeros([], jnp.int32), params=qa_params,
                     opt_state=jtx.init(qa_params))
    model = _port_qa_model(tp._flat(qa_params))
    psched = linear_warmup_schedule(lr, total, warmup=0.2)
    ptx = FusedAdam(psched, weight_decay=0.01, max_grad_norm=1.0)
    pstate = make_train_state(model, ptx)
    pstep = build_pretrain_step(model, ptx, schedule=psched,
                                loss_fn_builder=_loss_builder)
    for i in range(3):
        batch = _qa_batch(10 + i)
        del rec.seeds[:]
        state, metrics = jstep(
            state, {k: jnp.array(v)[None] for k, v in batch.items()},
            jax.random.PRNGKey(100 + i))
        jax.effects_barrier()
        pm = pstep(pstate, tp._torch_batch(batch, accum=1),
                   torch.tensor([rec.seeds], dtype=torch.int32))
        np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(pm["learning_rate"],
                                   float(metrics["learning_rate"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(metrics["grad_norm"]), rtol=1e-4)
    assert pstate.step == 3 and pstate.opt_state.count == 3
    want = params_from_flax(tp._flat(state.params))
    start = params_from_flax(tp._flat(qa_params))
    step_bound = 3.2 * sum(psched(i) for i in range(3))
    for k in SHIFT_INVARIANT:
        for p in (pstate.params[k], want[k]):
            assert float((p - start[k]).abs().max()) <= step_bound, k
    for k, w in want.items():
        if k in SHIFT_INVARIANT:
            continue
        rel = (torch.linalg.vector_norm(pstate.params[k] - w)
               / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
        assert rel <= PARAM_RTOL, (k, rel)


# -- the entry points ---------------------------------------------------------


def _files(tmp_path, seq=64):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    cfg = dict(CFG, max_position_embeddings=seq, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, lowercase=True,
               vocab_file=str(vocab))
    cfg_path = tmp_path / "model_config.json"
    cfg_path.write_text(json.dumps(cfg))
    train = write_squad(tmp_path / "train.json", 3, seed=2, lengths=(20, 60))
    return str(cfg_path), train


def _squad_argv(cfg, train, out, seq=64):
    return ["--do_train", "--do_predict", "--do_eval", "--train_file", train,
            "--predict_file", train, "--model_config_file", cfg,
            "--output_dir", str(out), "--max_seq_length", str(seq),
            "--doc_stride", "32", "--train_batch_size", "2",
            "--predict_batch_size", "2", "--num_train_epochs", "1",
            "--learning_rate", "1e-4", "--dtype", "float32"]


def test_run_squad_main_on_cpu_writes_what_jax_writes(tmp_path):
    """run_squad --device cpu end to end (train, checkpoint, predict over
    the eval buckets, evaluate) beside the JAX entry point on the same
    files: the same result keys and output files; the checkpoint serves."""
    import run_squad as jax_run_squad
    from bert_pytorch_tpu_torch import run_squad

    cfg, train = _files(tmp_path)
    want = jax_run_squad.main(_squad_argv(cfg, train, tmp_path / "jax"))
    lines = []
    got = run_squad.main(_squad_argv(cfg, train, tmp_path / "port")
                         + ["--device", "cpu"], log=lines.append)
    assert set(got) == set(want)
    assert got["training_sequences_per_second"] > 0
    assert 0.0 <= got["exact_match"] <= got["f1"] <= 100.0
    port = set(os.listdir(tmp_path / "port"))
    assert port <= set(os.listdir(tmp_path / "jax"))
    assert {"predictions.json", "nbest_predictions.json", "ckpt",
            "squad_log.jsonl", "train_feats_64_32.pkl"} <= port
    preds = json.loads((tmp_path / "port" / "predictions.json").read_text())
    assert set(preds) == set(json.loads(
        (tmp_path / "jax" / "predictions.json").read_text()))
    assert len(os.listdir(tmp_path / "port" / "ckpt")) == 1
    # the finetuned state serves: the QA model loads it strictly
    from bert_pytorch_tpu_torch.models.bert import BertForQuestionAnswering
    from bert_pytorch_tpu_torch.run_server import load_task_params

    served = BertForQuestionAnswering(BertConfig.from_json_file(cfg).replace(
        vocab_size=len(VOCAB) + (-len(VOCAB)) % 8))
    served.load_state_dict(load_task_params(
        str(tmp_path / "port" / "ckpt"), log=lines.append), strict=True)


def test_run_finetune_task_squad_and_cuda_default(tmp_path, monkeypatch):
    """`run_finetune --task squad` is the same run; without a card and
    without --device cpu every entry point raises."""
    from bert_pytorch_tpu_torch import run_finetune, run_ner, run_squad

    cfg, train = _files(tmp_path)
    argv = _squad_argv(cfg, train, tmp_path / "a")
    got = run_finetune.main(["--task", "squad"] + argv
                            + ["--device", "cpu"], log=lambda m: None)
    assert "f1" in got and (tmp_path / "a" / "ckpt").is_dir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_squad.parse_arguments(argv).device == "cuda"
    for main, av in ((run_squad.main, argv),
                     (lambda a, log: run_finetune.main(["--task=squad"] + a,
                                                       log=log), argv),
                     (run_ner.main, ["--train_file", train, "--labels", "O",
                                     "--model_config_file", cfg,
                                     "--output_dir", str(tmp_path / "n")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(av, log=lambda m: None)


def _jax_parser(parse_arguments, argv):
    """The argparse parser a JAX entry point builds, captured at its
    parse_args call."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        seen.append(self)
        return real(self, *a, **k)

    argparse.ArgumentParser.parse_args = capture
    try:
        parse_arguments(list(argv))
    finally:
        argparse.ArgumentParser.parse_args = real
    return {a.dest: a for a in seen[0]._actions
            if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("task", ["squad", "ner"])
def test_refused_tables_account_for_every_jax_flag(task):
    """Every flag of the JAX task parser is declared by the port's, with
    the JAX default; a flag whose feature the port lacks is in _REFUSED
    (off at the JAX default) or tunes one in _TUNING; the port adds only
    --device."""
    from bert_pytorch_tpu.tasks import ner_task as jner, squad_task as jsq
    from bert_pytorch_tpu_torch.tasks import ner_task, squad_task

    jmod, pmod, argv = {
        "squad": (jsq, squad_task, []),
        "ner": (jner, ner_task, ["--train_file", "t", "--labels", "O",
                                 "--model_config_file", "c"])}[task]
    jax_flags = _jax_parser(jmod.parse_arguments, argv)
    port_flags = {a.dest: a for a in pmod.build_parser()._actions
                  if not isinstance(a, argparse._HelpAction)}
    assert set(port_flags) - set(jax_flags) == {"device"}
    assert set(jax_flags) <= set(port_flags)
    refused, tuning = pmod._REFUSED, pmod._TUNING
    assert not set(refused) & set(tuning)
    assert set(tuning.values()) <= set(refused)
    for dest, flag in jax_flags.items():
        mine = port_flags[dest]
        assert mine.default == flag.default, dest
        assert mine.choices is None or set(mine.choices) <= set(
            flag.choices), dest
        if dest in refused:
            assert flag.default in refused[dest], dest


# --packing is served: tests/test_torch_finetune_packing.py; so are
# --perf_artifact, squad's --eval_script, --metrics_port and
# --watchdog_timeout
# (tests/test_torch_tasks.py::test_lifted_finetune_flag_is_served), and
# NER's --tokenizer bpe (tests/test_torch_bpe.py)
@pytest.mark.parametrize("task,flag", [("ner", ["--tokenizer", "bpe"])])
def test_switching_on_a_refused_flag_raises(task, flag):
    """The refusal machinery raises, naming ROADMAP queue A, on a value
    that switches on a refused feature; --tokenizer bpe, refused until
    the BPE tokenizer was ported, now parses."""
    from bert_pytorch_tpu_torch import FINETUNE_GAPS, refuse
    from bert_pytorch_tpu_torch.tasks import ner_task, squad_task

    base = {"squad": [], "ner": ["--train_file", "t", "--labels", "O",
                                 "--model_config_file", "c"]}[task]
    mod = {"squad": squad_task, "ner": ner_task}[task]
    mod.parse_arguments(base + ["--packing", "--packing_max_segments",
                                "4"])                      # served
    args = mod.parse_arguments(base + flag)                # served
    assert "tokenizer" not in mod._REFUSED
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A"):
        refuse(args, {"tokenizer": (None, "wordpiece")}, FINETUNE_GAPS)


@pytest.mark.parametrize("kind", ["name", "url"])
def test_init_checkpoint_from_another_source_is_refused(kind):
    """A registry name and a URL need the network: refused, naming the
    ROADMAP item (the local sources are read:
    test_init_checkpoint_from_another_source_is_read)."""
    spec = {"name": "bert-large-uncased",
            "url": "https://storage.googleapis.com/bert_models/x.zip"}[kind]
    params = {"bert.embeddings.word_embeddings.weight": torch.zeros(8, 4)}
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A"):
        tft.load_pretrained_params(spec, params, log=lambda m: None)


@pytest.mark.parametrize("kind", ["tf_release", "torch_save", "orbax"])
def test_init_checkpoint_from_another_source_is_read(tmp_path, kind):
    """A Google TF release, a reference ckpt_*.pt and a JAX-package orbax
    directory each seed a SQuAD model's encoder through
    load_pretrained_params: every encoder and embedding parameter equals
    the source's converted tree (tests/test_torch_pretrained.py holds the
    trees against JAX's), and the report names the fresh QA head."""
    from bert_pytorch_tpu_torch.models.bert import BertForQuestionAnswering
    from bert_pytorch_tpu_torch.models.convert import params_from_flax
    from tests import test_torch_pretrained as tpre

    spec, flat = tpre.make_source(tmp_path, kind)
    config = tpre.port_config()
    model = BertForQuestionAnswering(config, dtype=torch.float32)
    params = {k: p.detach() for k, p in model.named_parameters()}
    lines = []
    tft.load_pretrained_params(spec, params, log=lines.append)
    want = params_from_flax(flat)
    fresh = sorted(k for k in params if not k.startswith("bert."))
    assert fresh == ["qa_outputs.bias", "qa_outputs.weight"]
    for k, p in params.items():
        if k.startswith("bert.") and "pooler" not in k:
            assert torch.equal(p, want[k]), k
    step = {"tf_release": "tf-release", "torch_save": "torch-ckpt",
            "orbax": "3"}[kind]
    assert lines[0] == (f"init_checkpoint step {step}: loaded "
                        f"{len(params) - 2} param leaves, 2 "
                        "fresh-initialized")
    assert lines[1].endswith("qa_outputs.bias, qa_outputs.weight")


def test_chip_smoke_finetune_squad_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's finetune_squad phase at a tiny width on the CPU
    (the plain versions): a pretraining checkpoint seeds run_task, which
    trains 3 steps at seq 384, saves, predicts over the eval buckets and
    evaluates; the server answers from the finetuned checkpoint; the
    kernels-vs-plain comparison runs."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu_torch.training.state import make_train_state

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(CFG, vocab_size=30522)))
    config = BertConfig.from_json_file(str(cfg)).replace(vocab_size=30528)
    pre = BertForPreTraining(config, dtype=torch.float32)
    init_weights(pre, torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "pretrain_ckpts")).save(
        6, make_train_state(pre, Lamb(1e-3)).state_dict())
    summary = {"train_phase2": {"checkpoint": {"step": 6}}}
    chip_smoke.phase_finetune_squad(torch, np, summary, device="cpu",
                                    cfg_path=str(cfg),
                                    ckpt_dir=str(tmp_path), batch=4)
    res = summary["finetune_squad"]
    assert res["steps"] == 3 and res["init_step"] == 6
    assert all(np.isfinite(res["losses"] + res["grad_norms"]))
    assert res["checkpoint_steps"] == [3]
    assert {"exact_match", "f1"} <= set(res["eval"])
    assert res["predict_buckets"][str(S)] >= 1
    assert res["serve"]["code"] == 200
    assert res["launches"] == {k: 0 for k in res["launches"]}
    for name, r in res["kernels_vs_plain"].items():
        assert r["max_grad_rel_l2"] <= \
            chip_smoke.FINETUNE_MODEL_TOL[name]["grad"]
