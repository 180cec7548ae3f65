"""The port's classify, choice and embed tasks against the JAX package's,
on the CPU, at a tiny f32 width (2 layers, E=64, 4 heads of 16, I=128,
seq 32, plain attention with hash dropout): the losses under both rank
rules, the GLUE/SWAG datasets' arrays, the request featurizers and
decodes, the three heads plain and packed, one step with dropout on and
a 3-step trajectory, the entry points, the refusal tables and the
registry, and a CPU rehearsal of chip_smoke.py's finetune_tasks phase.

The classify and choice heads' dropout is flax nn.Dropout, a threefry
mask the port does not draw: the test records it (test_torch_ner's
`head_mask_recorder`) and feeds it to the port as `head_keep`; the
encoder's seeds come through test_torch_pretrain's `seed_recorder`.

Tolerances (f32, the flash/plain tier of tests/test_pallas.py): forward
outputs within 2e-5, gradients within 5e-4; the step's loss within 1e-5
relative and parameters after 3 Adam steps within 1e-4 relative L2 per
tensor (test_torch_pretrain's tiers); integer arrays, labels, masks and
decoded labels exactly. The choice head's `classifier.bias` gets a zero
gradient in exact arithmetic (the softmax across a question's choices
ignores a score shift), so both sides hold rounding noise there: it is
held to the Adam step bound, as test_torch_finetune's SHIFT_INVARIANT
leaves are.
"""

import argparse
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.config import BertConfig as JaxBertConfig  # noqa: E402
from bert_pytorch_tpu.data import glue as jglue  # noqa: E402
from bert_pytorch_tpu.data import tokenization as jtok  # noqa: E402
from bert_pytorch_tpu.models import bert as jbert  # noqa: E402
from bert_pytorch_tpu.models import losses as jlosses  # noqa: E402
from bert_pytorch_tpu.tasks import predict as jpredict  # noqa: E402
from bert_pytorch_tpu.training import finetune as jft  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.data import glue as tglue  # noqa: E402
from bert_pytorch_tpu_torch.data import tokenization as ttok  # noqa: E402
from bert_pytorch_tpu_torch.models import bert as tbert  # noqa: E402
from bert_pytorch_tpu_torch.models import losses as tlosses  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from bert_pytorch_tpu_torch.tasks import predict as tpredict  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_torch_finetune import _jax_parser  # noqa: E402
from tests.test_torch_ner import head_mask_recorder  # noqa: E402,F401
from tests.test_torch_pretrain import seed_recorder  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("the cat sat on a mat while dog ran in park and red blue green "
         "film was good bad great awful plot actors story slow fast "
         "which one is true answer").split()
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
         + ["##s", ".", ",", "?"])
S, C, G = 32, 4, 4
CFG = dict(vocab_size=len(VOCAB), hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=128, next_sentence=True,
           hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
LABELS = ["negative", "positive", "neutral"]
FWD_TOL, GRAD_TOL = 2e-5, 5e-4
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
TASKS = ("classify", "choice", "embed")
# zero in exact arithmetic: the choice softmax ignores a shift of every
# score (see the module docstring)
SHIFT_INVARIANT = {"choice": ("classifier.bias",)}


def _text(rng, lo, hi):
    return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS),
                                                  rng.randint(lo, hi)))


def write_pair_tsv(path, n, seed, pairs=True, labels=LABELS[:2],
                   lengths=(3, 40)):
    """`n` rows label<TAB>text_a[<TAB>text_b] of random words; some are
    long enough to be truncated at S."""
    rng = np.random.RandomState(seed)
    lines = ["# a comment line", ""]
    for i in range(n):
        cols = [labels[rng.randint(len(labels))], _text(rng, *lengths)]
        if pairs and i % 3:
            cols.append(_text(rng, *lengths))
        lines.append("\t".join(cols))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def write_choice_jsonl(path, n, seed, lengths=(2, 20)):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            rec = {"choices": [_text(rng, *lengths) for _ in range(C)],
                   "label": int(rng.randint(C))}
            if i % 4:
                rec["question"] = _text(rng, *lengths) + " ?"
            f.write(json.dumps(rec) + "\n\n")
    return str(path)


def _tokenizers():
    vocab = {t: i for i, t in enumerate(VOCAB)}
    return (jtok.BertWordPieceTokenizer(vocab),
            ttok.get_wordpiece_tokenizer(vocab))


# -- losses ---------------------------------------------------------------------


def _jt(*arrays):
    return ([jnp.array(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


@pytest.mark.parametrize("case", ["plain", "packed"])
def test_segment_classification_loss_equals_jax(case):
    rng = np.random.RandomState(0)
    shape = (5,) if case == "plain" else (3, G)
    logits = rng.randn(*shape, 3).astype(np.float32)
    labels = rng.randint(0, 3, shape).astype(np.int32)
    labels.reshape(-1)[[1, -1]] = -1                  # empty slots
    (jl, jy), (tl, ty) = _jt(logits, labels)
    want = float(jlosses.segment_classification_loss(jl, jy))
    got = tlosses.segment_classification_loss(tl, ty).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.classification_loss(tl, ty).item(),
        float(jlosses.classification_loss(jl, jy)), rtol=1e-6)
    # the ordered sum: the same terms in any shape give the same bits
    flat = tlosses.segment_classification_loss(tl.reshape(-1, 3),
                                               ty.reshape(-1))
    assert flat.item() == got


@pytest.mark.parametrize("rule,groups", [("plain", None), ("packed", 2),
                                         ("packed", C)])
def test_choice_loss_equals_jax_under_both_rank_rules(rule, groups):
    """(B, C) scores against (B,) labels, and packed (B, G) scores against
    (B, G / C) labels, also where G / C equals C (the rank decides)."""
    rng = np.random.RandomState(1)
    if rule == "plain":
        scores = rng.randn(6, C).astype(np.float32)
        labels = rng.randint(0, C, (6,)).astype(np.int32)
    else:
        scores = rng.randn(3, groups * C).astype(np.float32)
        labels = rng.randint(0, C, (3, groups)).astype(np.int32)
        labels[1, -1] = -1
    (js, jy), (ts, ty) = _jt(scores, labels)
    want = float(jlosses.choice_loss(js, jy, C))
    np.testing.assert_allclose(tlosses.choice_loss(ts, ty, C).item(), want,
                               rtol=1e-6)


def test_segment_onehot_and_positions_equal_jax():
    seg = np.array([[1, 1, 1, 2, 2, 3, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1],
                    [0] * 8, [2, 2, 1, 1, 1, 4, 4, 0]], np.int32)
    (js,), (ts,) = _jt(seg)
    np.testing.assert_array_equal(tlosses.segment_onehot(ts, G).numpy(),
                                  np.asarray(jlosses.segment_onehot(js, G)))
    got = tbert.positions_from_segment_ids(ts, G)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbert.positions_from_segment_ids(js, G)))


# -- data and the request helpers ---------------------------------------------


@pytest.mark.parametrize("pairs,seq", [(True, S), (False, S), (True, 128)])
def test_pair_classification_arrays_equal_jax(tmp_path, pairs, seq):
    path = write_pair_tsv(tmp_path / "train.tsv", 24, 0, pairs=pairs)
    jtk, ttk = _tokenizers()
    assert tglue.parse_pair_tsv(path) == jglue.parse_pair_tsv(path)
    want = jglue.PairClassificationDataset(path, jtk, LABELS, seq).arrays()
    got = tglue.PairClassificationDataset(path, ttk, LABELS, seq).arrays()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if seq == S:
        assert (got["attention_mask"].sum(-1) == S).any()   # truncated
    with pytest.raises(ValueError, match="not in --labels"):
        tglue.PairClassificationDataset(path, ttk, ["negative"], seq)


@pytest.mark.parametrize("seq", [S, 64])
def test_multiple_choice_arrays_equal_jax(tmp_path, seq):
    path = write_choice_jsonl(tmp_path / "train.jsonl", 12, 1)
    jtk, ttk = _tokenizers()
    want = jglue.MultipleChoiceDataset(path, jtk, C, seq).arrays()
    got = tglue.MultipleChoiceDataset(path, ttk, C, seq).arrays()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["input_ids"].shape == (12, C, seq)
    with pytest.raises(ValueError, match="want exactly 3 choices"):
        tglue.MultipleChoiceDataset(path, ttk, 3, seq)


def test_accuracy_equals_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(20, 3).astype(np.float32)
    labels = rng.randint(0, 3, 20).astype(np.int32)
    labels[-4:] = -1
    assert tglue.accuracy(logits, labels) == jglue.accuracy(logits, labels)
    assert tglue.accuracy(logits, np.full(20, -1)) == 0.0


@pytest.mark.parametrize("pair,max_pieces", [(None, 64), ("blue dog ran",
                                                          64),
                                             ("a " * 40, 16), (None, 8)])
def test_encode_pair_equals_jax(pair, max_pieces):
    jtk, ttk = _tokenizers()
    text = "the cats sat on a red mat , while the dogs ran"
    assert tpredict.encode_pair(ttk, text, pair, max_pieces) == \
        jpredict.encode_pair(jtk, text, pair, max_pieces)
    for fn, tk in ((tpredict.encode_pair, ttk), (jpredict.encode_pair, jtk)):
        with pytest.raises(ValueError):
            fn(tk, text, "x", 2)
        with pytest.raises(ValueError, match="empty text"):
            fn(tk, "   ", None, 16)


def test_ner_helpers_and_decodes_equal_jax():
    jtk, ttk = _tokenizers()
    words = ["The", "cats", "sat", "zebra", "on", "mats", "."]
    got = tpredict.ner_encode_tokens(words, ttk, max_pieces=64)
    assert got == jpredict.ner_encode_tokens(words, jtk, max_pieces=64)
    for fn, tk in ((tpredict.ner_encode_tokens, ttk),
                   (jpredict.ner_encode_tokens, jtk)):
        with pytest.raises(ValueError, match="largest bucket"):
            fn(words, tk, max_pieces=6)
    rng = np.random.RandomState(3)
    id_to_label = {1: "O", 2: "B-PER", 3: "I-PER"}
    logits = rng.randn(len(got[0]), 4).astype(np.float32)
    assert tpredict.ner_decode(logits, got[1], id_to_label, len(words)) == \
        jpredict.ner_decode(logits, got[1], id_to_label, len(words))
    for _ in range(4):
        logits = rng.randn(3).astype(np.float32) * 4
        assert tpredict.classify_decode(logits, ["a", "b"]) == \
            jpredict.classify_decode(logits, ["a", "b"])
        scores = list(rng.randn(5) * 3)
        assert tpredict.choice_decode(scores) == \
            jpredict.choice_decode(scores)


# -- the heads ------------------------------------------------------------------


def _jax_cfg(**over):
    return JaxBertConfig(**dict(CFG, **over), dtype="float32",
                         stacked_params=False)


def _jax_model(task):
    if task == "classify":
        return jbert.BertForSequenceClassification(
            _jax_cfg(), num_labels=len(LABELS), max_segments=G,
            dtype=jnp.float32)
    if task == "choice":
        return jbert.BertForMultipleChoice(_jax_cfg(), num_choices=C,
                                           max_segments=G, dtype=jnp.float32)
    return jbert.BertForSentenceEmbedding(_jax_cfg(), num_labels=len(LABELS),
                                          max_segments=G, dtype=jnp.float32)


def _port_model(task, flat):
    cfg = BertConfig.from_dict(CFG)
    if task == "classify":
        model = tbert.BertForSequenceClassification(
            cfg, num_labels=len(LABELS), max_segments=G, dtype=torch.float32)
    elif task == "choice":
        model = tbert.BertForMultipleChoice(cfg, max_segments=G,
                                            dtype=torch.float32)
    else:
        model = tbert.BertForSentenceEmbedding(
            cfg, num_labels=len(LABELS), max_segments=G, dtype=torch.float32)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model


@pytest.fixture(scope="module")
def task_params():
    out = {}
    for i, task in enumerate(TASKS):
        shape = (2, C, S) if task == "choice" else (2, S)
        s = jnp.zeros(shape, jnp.int32)
        out[task] = unbox(jax.jit(_jax_model(task).init)(
            jax.random.PRNGKey(i), s, s, s)["params"])
    return out


def _plain_rows(seed, rows, seq=S):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, len(VOCAB), (rows, seq)).astype(np.int32)
    mask = np.ones((rows, seq), np.int32)
    for r in range(rows):
        mask[r, rng.randint(seq // 3, seq + 1):] = 0
    types = np.zeros_like(ids)
    types[:, seq // 2:] = 1
    return {"input_ids": ids * mask, "token_type_ids": types * mask,
            "attention_mask": mask}


def _packed_rows(seed, rows=3):
    """Packed rows: 1-4 segments a row, positions reset per segment, the
    last row holding a pad tail."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((rows, S), np.int32)
    pos = np.zeros((rows, S), np.int32)
    for r in range(rows):
        cursor = 0
        for g in range(1 + r % G):
            ln = int(rng.randint(4, 9))
            seg[r, cursor:cursor + ln] = g + 1
            pos[r, cursor:cursor + ln] = np.arange(ln)
            cursor += ln
    ids = rng.randint(5, len(VOCAB), (rows, S)).astype(np.int32)
    mask = (seg > 0).astype(np.int32)
    return {"input_ids": ids * mask, "token_type_ids": np.zeros_like(ids),
            "attention_mask": mask, "position_ids": pos, "segment_ids": seg}


HEAD_CASES = [("classify", "plain"), ("classify", "packed"),
              ("choice", "3d"), ("choice", "plain"), ("choice", "packed"),
              ("embed", "plain"), ("embed", "packed")]


@pytest.mark.parametrize("task,case", HEAD_CASES)
def test_heads_convert_and_match_jax(task_params, task, case):
    """params_from_flax maps each head's tree (the pooler of classify and
    choice, embed's without one) and the deterministic outputs match:
    classify (B, C) / (B, G, C) logits, choice (B, C) / (B,) / (B, G)
    scores, embed (B, E) / (B, G, E) unit embeddings and probe logits."""
    params = task_params[task]
    if case == "3d":
        rows = _plain_rows(4, 3 * C)
        batch = {k: v.reshape(3, C, S) for k, v in rows.items()}
    elif case == "plain":
        batch = _plain_rows(4, 3)
    else:
        batch = _packed_rows(5)
    want = _jax_model(task).apply(
        {"params": params}, jnp.array(batch["input_ids"]),
        jnp.array(batch["token_type_ids"]),
        jnp.array(batch["attention_mask"]), deterministic=True,
        **{k: jnp.array(batch[k]) for k in ("position_ids", "segment_ids")
           if k in batch})
    model = _port_model(task, tp._flat(params))
    assert ("bert.pooler.dense.weight" in model.state_dict()) == (
        task != "embed")
    build = {"classify": tpredict.build_classify_forward,
             "choice": tpredict.build_choice_forward,
             "embed": lambda m: (lambda b: m(**b))}[task]
    with torch.no_grad():
        got = build(model)({k: torch.from_numpy(v) for k, v in batch.items()})
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_TOL,
                                   atol=FWD_TOL)
    if task == "embed":
        norms = np.linalg.norm(got[0].numpy(), axis=-1)
        real = (np.ones(norms.shape, bool) if case == "plain" else
                batch["segment_ids"].max(-1)[:, None] > np.arange(G)[None])
        np.testing.assert_allclose(norms[real], 1.0, rtol=1e-6)
        assert (norms[~real] == 0).all()


def test_embedding_packed_equals_one_per_row(task_params):
    """Within the port on the CPU, where it is exact: each packed
    segment's embedding equals the same text's alone in its own row, bit
    for bit (pad and other segments' tokens weigh exactly 0 in attention
    and in the mean)."""
    model = _port_model("embed", tp._flat(task_params["embed"]))
    packed = _packed_rows(6)
    fwd = tpredict.build_embed_forward(model)
    with torch.no_grad():
        emb = fwd({k: torch.from_numpy(v) for k, v in packed.items()})
        for r in range(packed["input_ids"].shape[0]):
            for g in range(int(packed["segment_ids"][r].max())):
                sl = packed["segment_ids"][r] == g + 1
                n = int(sl.sum())
                one = {k: np.zeros((1, S), np.int32) for k in packed}
                one["input_ids"][0, :n] = packed["input_ids"][r, sl]
                one["attention_mask"][0, :n] = 1
                one["segment_ids"][0, :n] = 1
                one["position_ids"][0, :n] = np.arange(n)
                alone = fwd({k: torch.from_numpy(v) for k, v in one.items()})
                assert torch.equal(emb[r, g], alone[0, 0]), (r, g)


def test_head_seeds_are_checked(task_params):
    model = _port_model("classify", tp._flat(task_params["classify"]))
    batch = {k: torch.from_numpy(v) for k, v in _plain_rows(7, 2).items()}
    with pytest.raises(ValueError, match=r"2 \+ 3L"):
        model(**batch, dropout_seeds=torch.zeros(7, dtype=torch.int32))
    out = model(**batch, dropout_seeds=torch.arange(8, dtype=torch.int32))
    assert out.shape == (2, len(LABELS))


# -- one step and a trajectory against JAX -----------------------------------


def _labels(task, seed, rows):
    rng = np.random.RandomState(seed)
    return rng.randint(0, C if task == "choice" else len(LABELS),
                       rows).astype(np.int32)


def _train_batch(task, seed, rows=3):
    if task == "choice":
        batch = {k: v.reshape(rows, C, S)
                 for k, v in _plain_rows(seed, rows * C).items()}
    else:
        batch = _plain_rows(seed, rows)
    batch["labels"] = _labels(task, seed, rows)
    return batch


def _jax_loss_builder(task):
    def builder(model):
        def loss_fn(params, batch, rng, deterministic=False):
            out = model.apply(
                {"params": params}, batch["input_ids"],
                batch["token_type_ids"], batch["attention_mask"],
                deterministic=deterministic,
                rngs=None if deterministic else {"dropout": rng})
            if task == "choice":
                return jlosses.choice_loss(out, batch["labels"], C), {}
            logits = out[1] if task == "embed" else out
            return jlosses.segment_classification_loss(
                logits, batch["labels"]), {}
        return loss_fn
    return builder


def _port_loss_builder(task):
    from bert_pytorch_tpu_torch.tasks import choice, classify, embed

    return {"classify": classify._loss_builder,
            "choice": choice.make_loss_builder(C),
            "embed": embed._loss_builder}[task]


def _port_seeds(task, recorded):
    # the encoder's 1 + 3L seeds JAX drew, then the head's (unused: the
    # head takes flax's mask as head_keep); embed has no head site
    return torch.tensor(list(recorded) + ([] if task == "embed" else [0]),
                        dtype=torch.int32)


@pytest.mark.parametrize("task", TASKS)
def test_step_with_dropout_matches_jax(task_params, seed_recorder,
                                       head_mask_recorder, task):
    from bert_pytorch_tpu_torch.training.pretrain import (compute_params,
                                                          loss_and_grads)

    params = task_params[task]
    batch = _train_batch(task, 0)
    (loss, _), grads = jax.value_and_grad(
        _jax_loss_builder(task)(_jax_model(task)), has_aux=True)(
        params, {k: jnp.array(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    assert len(seed_recorder) == 1 + 3 * CFG["num_hidden_layers"]
    micro = tp._torch_batch(batch)
    if task == "embed":
        assert not head_mask_recorder
    else:
        (mask,) = head_mask_recorder
        rows = 3 * C if task == "choice" else 3
        assert mask.shape == (rows, CFG["hidden_size"]) and not mask.all()
        micro["head_keep"] = torch.from_numpy(mask)
    model = _port_model(task, tp._flat(params))
    gparams = compute_params(dict(model.named_parameters()), None)
    t_loss, _, t_grads = loss_and_grads(_port_loss_builder(task)(model),
                                        gparams, micro,
                                        _port_seeds(task, seed_recorder))
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=LOSS_RTOL)
    want = params_from_flax(tp._flat(grads))
    assert set(t_grads) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(t_grads[k].numpy(), w.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    if task != "embed":    # the pooler trains (NER's and QA's never does)
        assert t_grads["bert.pooler.dense.weight"].abs().max() > 1e-4


@pytest.mark.parametrize("task", ["classify", "choice"])
def test_three_step_trajectory_matches_jax(task_params, seed_recorder,
                                           head_mask_recorder, task):
    """Three steps of JAX's build_pretrain_step with its finetune recipe
    (finetune_optimizer: linear warmup, fused_adam without bias
    correction, clip 1.0) against the port's step with the same recipe
    (training.finetune.finetune_optimizer), dropout on."""
    from bert_pytorch_tpu.training import pretrain as jax_pretrain
    from bert_pytorch_tpu.training.state import TrainState as JaxState
    from bert_pytorch_tpu_torch.training.finetune import finetune_optimizer
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    params = task_params[task]
    args = types.SimpleNamespace(lr=1e-3, warmup_proportion=0.2,
                                 clip_grad=1.0)
    jsched, jtx = jft.finetune_optimizer(args, 10)
    jstep = jax_pretrain.build_pretrain_step(
        _jax_model(task), jtx, schedule=jsched,
        loss_fn_builder=_jax_loss_builder(task))
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params,
                     opt_state=jtx.init(params))
    model = _port_model(task, tp._flat(params))
    psched, ptx = finetune_optimizer(args, 10)
    pstate = make_train_state(model, ptx)
    pstep = build_pretrain_step(model, ptx, schedule=psched,
                                loss_fn_builder=_port_loss_builder(task))
    for i in range(3):
        batch = _train_batch(task, 10 + i)
        del seed_recorder[:], head_mask_recorder[:]
        state, metrics = jstep(
            state, {k: jnp.array(v)[None] for k, v in batch.items()},
            jax.random.PRNGKey(100 + i))
        tb = dict(tp._torch_batch(batch, accum=1),
                  head_keep=torch.from_numpy(head_mask_recorder[0])[None])
        pm = pstep(pstate, tb, _port_seeds(task, seed_recorder)[None])
        np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(pm["learning_rate"],
                                   float(metrics["learning_rate"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(metrics["grad_norm"]), rtol=1e-4)
    assert pstate.step == 3 and pstate.opt_state.count == 3
    want = params_from_flax(tp._flat(state.params))
    start = params_from_flax(tp._flat(params))
    step_bound = 3.2 * sum(psched(i) for i in range(3))
    shift = SHIFT_INVARIANT.get(task, ())
    for k in shift:
        for p in (pstate.params[k], want[k]):
            assert float((p - start[k]).abs().max()) <= step_bound, k
    for k, w in want.items():
        if k in shift:
            continue
        rel = (torch.linalg.vector_norm(pstate.params[k] - w)
               / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
        assert rel <= PARAM_RTOL, (k, rel)


# -- the entry points, the refusal tables and the registry --------------------


def task_files(tmp_path, task, n_train=8, n_eval=4):
    """vocab, a tiny model config (dropout on) and train/val/test files of
    `task`'s format."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    cfg = tmp_path / "model_config.json"
    cfg.write_text(json.dumps(dict(CFG, vocab_file=str(vocab),
                                   lowercase=True)))
    files = {}
    for split, n, seed in (("train", n_train, 0), ("val", n_eval, 1),
                           ("test", n_eval, 2)):
        if task == "choice":
            files[split] = write_choice_jsonl(tmp_path / f"{split}.jsonl", n,
                                              seed)
        else:
            files[split] = write_pair_tsv(tmp_path / f"{split}.tsv", n, seed,
                                          pairs=task == "classify")
    return str(cfg), files


def _task_argv(task, cfg, files, out):
    argv = ["--model_config_file", cfg, "--train_file", files["train"],
            "--val_file", files["val"], "--test_file", files["test"],
            "--epochs", "2", "--batch_size", "4", "--max_seq_len", str(S),
            "--lr", "1e-3", "--output_dir", str(out), "--dtype", "float32"]
    return argv + (["--num_choices", str(C)] if task == "choice" else [])


@pytest.mark.parametrize("task", TASKS)
def test_run_finetune_task_on_cpu_then_serve_its_checkpoint(tmp_path, task):
    """`run_finetune --task <task> --device cpu` end to end (2 epochs of 2
    steps, val accuracy each epoch, test accuracy, embed's embedding
    check, the checkpoint, the jsonl log), then `run_server
    --task_checkpoint <task>=<out>/ckpt` answers from it."""
    import urllib.request

    from bert_pytorch_tpu_torch import run_finetune, run_server

    cfg, files = task_files(tmp_path, task)
    out = tmp_path / "out"
    got = run_finetune.main(["--task", task] + _task_argv(task, cfg, files,
                                                          out)
                            + ["--device", "cpu"], log=lambda m: None)
    keys = {"e2e_train_time", "training_sequences_per_second",
            "val_accuracy", "test_accuracy"}
    if task == "embed":
        keys |= {"embedding_dim", "embedding_norm_err"}
        assert got["embedding_dim"] == CFG["hidden_size"]
        assert got["embedding_norm_err"] < 1e-5
    assert set(got) == keys
    assert 0.0 <= got["val_accuracy"] <= 1.0
    assert 0.0 <= got["test_accuracy"] <= 1.0
    assert os.listdir(out / "ckpt") == ["4"]
    records = [json.loads(x) for x in (out / f"{task}_log.jsonl")
               .read_text().splitlines()]
    assert [r["epoch"] for r in records if r["tag"] == "val"] == [0, 1]
    metric = "probe_accuracy" if task == "embed" else "accuracy"
    assert [metric in r for r in records if r["tag"] == "test"] == [True]

    handle = run_server.serve(run_server.parse_arguments([
        "--model_config_file", cfg, "--task_checkpoint",
        f"{task}={out / 'ckpt'}", "--port", "0", "--host", "127.0.0.1",
        "--buckets", "32", "--serve_dtype", "float32", "--device", "cpu"]),
        log=lambda m: None)
    try:
        body = {"classify": {"text": "the film was good",
                             "text_pair": "great plot"},
                "choice": {"question": "which one ?",
                           "choices": ["red cat", "blue dog", "green"]},
                "embed": {"texts": ["the cat", "a dog ran in the park"]}}
        req = urllib.request.Request(handle.url + f"/v1/{task}",
                                     data=json.dumps(body[task]).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
    finally:
        handle.close()
    if task == "classify":
        assert reply["label"] in ("negative", "positive")
    elif task == "choice":
        assert reply["choice"] in (0, 1, 2) and len(reply["scores"]) == 3
    else:
        assert len(reply["embeddings"]) == 2 and reply["dim"] == 64


def test_cuda_default_raises_without_a_card(tmp_path, monkeypatch):
    from bert_pytorch_tpu_torch import run_finetune
    from bert_pytorch_tpu_torch.tasks import registry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for task in TASKS:
        cfg, files = task_files(tmp_path / task, task)
        argv = _task_argv(task, cfg, files, tmp_path / task / "out")
        assert registry.get(task).parse_arguments(argv).device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_finetune.main(["--task", task] + argv, log=lambda m: None)


@pytest.mark.parametrize("task", TASKS)
def test_refused_tables_account_for_every_jax_flag(task):
    """Every flag of the JAX task parser (base_finetune_parser and the
    task's own) is declared by the port's with the JAX default; a flag
    whose feature the port lacks is in _REFUSED (off at the JAX default)
    or tunes one in _TUNING; the port adds only --device."""
    import importlib

    jmod = importlib.import_module(f"bert_pytorch_tpu.tasks.{task}")
    pmod = importlib.import_module(f"bert_pytorch_tpu_torch.tasks.{task}")
    argv = ["--model_config_file", "c", "--output_dir", "o"]
    jax_flags = _jax_parser(jmod.parse_arguments, argv)
    port_flags = {a.dest: a for a in pmod.build_parser()._actions
                  if not isinstance(a, argparse._HelpAction)}
    assert set(port_flags) - set(jax_flags) == {"device"}
    assert set(jax_flags) <= set(port_flags)
    refused, tuning = pmod._REFUSED, pmod._TUNING
    assert not set(refused) & set(tuning)
    assert set(tuning.values()) <= set(refused)
    assert not {"metrics_port", "watchdog_timeout"} & set(refused)
    assert "perf_artifact" not in refused
    assert "packing" not in refused and "packing_max_segments" not in tuning
    for dest, flag in jax_flags.items():
        mine = port_flags[dest]
        assert mine.default == flag.default, dest
        assert mine.nargs == flag.nargs, dest
        if dest in refused:
            assert flag.default in refused[dest], dest


@pytest.mark.parametrize("task,flag,dest", [
    ("squad", ["--perf_artifact", "x.json"], "perf_artifact"),
    ("squad", ["--eval_script", "evaluate-v1.1.py"], "eval_script"),
    ("ner", ["--perf_artifact", "x.json"], "perf_artifact"),
    ("classify", ["--perf_artifact", "x.json"], "perf_artifact"),
    ("choice", ["--perf_artifact", "x.json"], "perf_artifact"),
    ("choice", ["--metrics_port", "9100"], "metrics_port"),
    ("classify", ["--metrics_port", "9100"], "metrics_port"),
    ("embed", ["--metrics_port", "9100"], "metrics_port"),
    ("embed", ["--watchdog_timeout", "30"], "watchdog_timeout"),
    ("choice", ["--watchdog_timeout", "30"], "watchdog_timeout"),
    ("classify", ["--watchdog_timeout", "30"], "watchdog_timeout"),
    ("ner", ["--metrics_port", "9100"], "metrics_port"),
    ("squad", ["--metrics_port", "9100"], "metrics_port"),
    ("squad", ["--watchdog_timeout", "30"], "watchdog_timeout"),
    ("ner", ["--watchdog_timeout", "30"], "watchdog_timeout")])
def test_lifted_finetune_flag_is_served(task, flag, dest):
    """The flags the finetuning slice refused and this port serves now:
    --perf_artifact (the FINETUNE json, tests/test_torch_finetune_survival),
    SQuAD's --eval_script, which JAX accepts and ignores (the eval runs
    in-process), and --metrics_port / --watchdog_timeout (the exporter
    and the watchdog, tests/test_torch_pretrain_survival.py)."""
    from bert_pytorch_tpu_torch.tasks import registry

    base = {"squad": [], "ner": ["--train_file", "t", "--labels", "O",
                                 "--model_config_file", "c"]}.get(
        task, ["--model_config_file", "c", "--output_dir", "o"])
    args = registry.get(task).parse_arguments(base + flag)
    got = getattr(args, dest)
    assert got == type(got)(flag[1])


def test_choice_setup_runs_reference_shaped_batches(tmp_path):
    """choice trains on (N, C, S) arrays, a step of --batch_size examples;
    without --packing, --packing_max_segments changes only the model's
    segment count (rounded down to a multiple of C, as JAX's setup
    rounds it), never the step count."""
    from bert_pytorch_tpu_torch.tasks import choice

    cfg, files = task_files(tmp_path, "choice")
    config = BertConfig.from_json_file(cfg)
    runs = []
    for given in (3, 8, 10):
        args = choice.parse_arguments(
            _task_argv("choice", cfg, files, tmp_path / "o")
            + ["--packing_max_segments", str(given)])
        runs.append(choice.setup(args, config, torch.device("cpu"),
                                 lambda m: None, lambda *a, **k: None))
    for run in runs:
        n, c, s = run.train_arrays["input_ids"].shape
        assert (c, s) == (C, run.seq_len) and run.batch_size == 4
        assert run.total_steps == runs[0].total_steps == 2 * -(-n // 4)
    assert [run.model.max_segments for run in runs] == [
        max(C, given // C * C) for given in (3, 8, 10)]


def test_registry_matches_jax():
    """The same five tasks, and for each the same head, output kind,
    metric and request schema as the JAX registry's."""
    from bert_pytorch_tpu.tasks import registry as jreg
    from bert_pytorch_tpu_torch.tasks import registry as treg

    assert treg.all_tasks() == jreg.all_tasks()
    assert [s.name for s in treg.specs()] == list(treg.all_tasks())
    for spec in treg.specs():
        want = jreg.get(spec.name)
        for field in ("title", "head", "output_kind", "metric",
                      "request_schema"):
            assert getattr(spec, field) == getattr(want, field), \
                (spec.name, field)
    with pytest.raises(KeyError, match="registered: choice, classify"):
        treg.get("glue")
    with pytest.raises(ValueError, match="output_kind"):
        treg.register(treg.TaskSpec(
            name="x", title="", head="", output_kind="pooled", metric="",
            request_schema={}, parse_arguments=None, setup=None,
            build_serving_model=None, forward_builder=None,
            make_service=None))


def test_chip_smoke_finetune_tasks_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's finetune_tasks phase at a tiny width on the CPU
    (the plain versions): synthetic TSV and JSONL splits, 3 steps of each
    task through run_task, val and test accuracy, embed's norms, the
    checkpoint served by its own server call, and the microbatches held
    against the plain versions."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(CFG, vocab_size=30522)))
    summary = {}
    chip_smoke.phase_finetune_tasks(torch, np, summary, device="cpu",
                                    cfg_path=str(cfg), batch=4)
    layers = CFG["num_hidden_layers"]
    for task in TASKS:
        res = summary[f"finetune_{task}"]
        assert res["steps"] == 3 and res["checkpoint_steps"] == [3]
        assert all(np.isfinite(res["losses"]))
        assert 0.0 <= res["val_accuracy"] <= 1.0
        assert 0.0 <= res["test_accuracy"] <= 1.0
        assert res["launches"] == {k: 0 for k in res["launches"]}
        assert res["launches_per_step"] == {
            "layer_norm_fwd": 1, "layer_norm_bwd": 1,
            "add_dropout_layer_norm_fwd": 2 * layers,
            "add_dropout_layer_norm_bwd": 2 * layers}
        assert res["serve"]["code"] == 200
        assert not os.path.exists(res["output_dir"])
    assert summary["finetune_embed"]["embedding_norm_err"] < 1e-3
    assert summary["finetune_choice"]["rows"] == 4 * C
    for task in ("classify", "choice"):
        assert set(summary[f"finetune_{task}"]["kernels_vs_plain"]) == {
            "bfloat16", "float32"}
