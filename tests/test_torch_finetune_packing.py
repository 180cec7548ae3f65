"""Packed finetuning of the port against the JAX package's, on the CPU, at
2 layers, width 32, seq 48, 4 segments a row.

- The batches equal JAX's exactly: `first_fit` with `segs_per_unit`,
  `pack_finetune_batch` (fields and placements), each task's
  `pack_labels`, `packed_epoch_step_counts` and `packed_train_batches`
  (every batch of two epochs), on the same numpy inputs.
- The two packed losses (`packed_token_loss`, `packed_qa_loss`) and their
  gradients against JAX's at the f32 tiers (1e-5, 2e-4).
- Per task (classify, choice, embed, ner, squad), flax-initialised
  parameters carried across by `params_from_flax`, dropout off: the
  port's packed loss and gradients against JAX's packed ones at 1e-5 /
  2e-4; within the port, the packed batch against the same examples one
  to a row (JAX's construction: the single batch follows the packed
  batch's row-major order, and keeps its G). The loss is held bit-equal;
  the gradients, whose weight sums run over rows of another shape, at
  the f32 gradient tier.
- Three packed classify steps against JAX's build_pretrain_step (loss and
  grad_norm per step).
- The entry points: `run_finetune --task {classify,choice,embed}`,
  `run_squad` and `run_ner` with --packing --device cpu, two steps each,
  with packing_efficiency and the real / slot tokens in their logs;
  `run_squad --packing --gradient_accumulation_steps 2` raises as JAX's
  run_task does; choice rounds --packing_max_segments to a multiple of C.
"""

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
from bert_pytorch_tpu.data import packing as jpacking  # noqa: E402
from bert_pytorch_tpu.models import bert as jbert  # noqa: E402
from bert_pytorch_tpu.models import losses as jlosses  # noqa: E402
from bert_pytorch_tpu.training import finetune as jft  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.data import packing as tpacking  # noqa: E402
from bert_pytorch_tpu_torch.models import bert as tbert  # noqa: E402
from bert_pytorch_tpu_torch.models import losses as tlosses  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from bert_pytorch_tpu_torch.training import finetune as tft  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402

S, G, C = 48, 4, 2
CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=64, next_sentence=True,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LOSS_RTOL, GRAD_TOL = 1e-5, 2e-4
TASKS = ("choice", "classify", "embed", "ner", "squad")
NER_IGNORE = -100


def _examples(n=5, seq=S, group=1, seed=0, lo=4, hi=14):
    """Varied-length examples: (n, [group,] seq) arrays with a real-token
    prefix a sub-row (JAX's test_finetune_packing fixture)."""
    rng = np.random.RandomState(seed)
    shape = (n, seq) if group == 1 else (n, group, seq)
    arrays = {k: np.zeros(shape, np.int32)
              for k in ("input_ids", "token_type_ids", "attention_mask")}
    lens = rng.randint(lo, hi, (n, group))
    for i in range(n):
        for c in range(group):
            ln = int(lens[i, c])
            at = (i,) if group == 1 else (i, c)
            arrays["input_ids"][at][:ln] = rng.randint(5, 64, ln)
            arrays["token_type_ids"][at][ln // 2:ln] = 1
            arrays["attention_mask"][at][:ln] = 1
    return arrays, lens


def _task_arrays(task, n=None, seed=0, lo=4, hi=14):
    """(arrays with the task's labels, group size): by default as many
    examples as two packed rows of G segments hold whole."""
    group = C if task == "choice" else 1
    n = n or (4 if task == "choice" else 5)
    arrays, lens = _examples(n, group=group, seed=seed, lo=lo, hi=hi)
    rng = np.random.RandomState(100 + seed)
    if task in ("classify", "embed"):
        arrays["labels"] = rng.randint(0, 2, n).astype(np.int32)
    elif task == "choice":
        arrays["labels"] = rng.randint(0, C, n).astype(np.int32)
    elif task == "ner":
        labels = np.full((n, S), NER_IGNORE, np.int32)
        for i in range(n):
            labels[i, 1:lens[i, 0] - 1] = rng.randint(1, 4, lens[i, 0] - 2)
        arrays["labels"] = labels
    else:
        start = np.array([rng.randint(1, lens[i, 0] - 1) for i in range(n)],
                         np.int32)
        arrays["start_positions"] = start
        arrays["end_positions"] = np.minimum(start + 2,
                                             lens[:, 0] - 1).astype(np.int32)
        arrays["end_positions"][0] = 10 * S        # outside the window
    return arrays, group


def _pack_labels(task, port=True):
    if port:
        from bert_pytorch_tpu_torch.tasks import (choice, classify, embed,
                                                  ner_task, squad_task)
    else:
        from bert_pytorch_tpu.tasks import (choice, classify, embed,
                                            ner_task, squad_task)
    return {"classify": classify.pack_labels, "embed": embed.pack_labels,
            "choice": choice.make_pack_labels(C),
            "ner": ner_task.pack_labels,
            "squad": squad_task.pack_labels}[task]


# -- the batches equal JAX's --------------------------------------------------


@pytest.mark.parametrize("segs_per_unit", [1, 2, 4])
def test_first_fit_units_equal_jax(segs_per_unit):
    rng = np.random.RandomState(segs_per_unit)
    for _ in range(20):
        lengths = rng.randint(1, 40, rng.randint(1, 30)).tolist()
        kw = dict(n_bins=int(rng.randint(1, 5)), capacity=48,
                  max_segments=int(rng.choice([4, 8])),
                  segs_per_unit=segs_per_unit)
        assert (tpacking.first_fit(lengths, **kw)
                == jpacking.first_fit(lengths, **kw))
    # a C-segment unit costs C of a row's slots (JAX's own example)
    assert tpacking.first_fit([10, 10, 10], n_bins=2, capacity=24,
                              max_segments=4, segs_per_unit=2) == [[0, 1],
                                                                   [2]]
    with pytest.raises(ValueError, match="capacity"):
        tpacking.first_fit([30], n_bins=1, capacity=24, max_segments=4)
    seg = np.array([[1, 1, 2, 0], [1, 0, 0, 0]])
    assert (tpacking.packing_efficiency(seg)
            == jpacking.packing_efficiency(seg) == 0.5)


@pytest.mark.parametrize("group", [1, C])
def test_pack_finetune_batch_equals_jax(group):
    arrays, _ = _examples(n=9, group=group, seed=5)
    units = [4, 0, 7, 2, 8, 1, 3, 6, 5]
    got, gp = tft.pack_finetune_batch(arrays, units, n_rows=3, seq_len=S,
                                      max_segments=4, group_size=group)
    want, wp = jft.pack_finetune_batch(arrays, units, n_rows=3, seq_len=S,
                                       max_segments=4, group_size=group)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype
    assert [(p.unit, p.row, p.seg0, p.offsets, p.lengths) for p in gp] == [
        (p.unit, p.row, p.seg0, p.offsets, p.lengths) for p in wp]
    np.testing.assert_array_equal(got["attention_mask"],
                                  (got["segment_ids"] > 0).astype(np.int32))


@pytest.mark.parametrize("task", TASKS)
def test_pack_labels_equal_jax(task):
    arrays, group = _task_arrays(task, n=8, seed=6)
    batch, placements = tft.pack_finetune_batch(
        arrays, list(range(8)), n_rows=3, seq_len=S, max_segments=G,
        group_size=group)
    got = _pack_labels(task)(arrays, placements, 3, S, G)
    want = _pack_labels(task, port=False)(arrays, placements, 3, S, G)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if task == "squad":       # the span outside its window is dropped
        assert (got["start_positions"] >= 0).sum() == len(placements)
        assert (got["end_positions"] >= 0).sum() == len(placements) - 1


@pytest.mark.parametrize("group,epochs", [(1, 2), (1, 2.5), (C, 3)])
def test_packed_epoch_step_counts_equal_jax(group, epochs):
    arrays, _ = _examples(n=40, group=group, seed=7, lo=3, hi=24)
    kw = dict(n_rows=3, seq_len=S, max_segments=4, seed=11, epochs=epochs,
              group_size=group)
    counts = tft.packed_epoch_step_counts(arrays, **kw)
    assert counts == jft.packed_epoch_step_counts(arrays, **kw)
    assert len(counts) == int(np.ceil(epochs)) and min(counts) >= 1
    args = types.SimpleNamespace(batch_size=3, max_seq_len=S, epochs=epochs,
                                 packing=True, packing_max_segments=4,
                                 seed=11, max_steps=-1)
    assert (tft.epoch_steps(arrays, args, group_size=group)
            == jft.epoch_steps(arrays, args, group_size=group)
            == (counts[0], sum(counts)))
    too_long, _ = _examples(n=2, group=group, seed=1, lo=40, hi=47)
    if group > 1:
        with pytest.raises(ValueError, match="exceed seq_len"):
            tft.packed_epoch_step_counts(too_long, **kw)


@pytest.mark.parametrize("task", ["choice", "ner"])
def test_packed_train_batches_equal_jax_over_two_epochs(task):
    """Every batch of two epochs, each epoch's order from seed + epoch,
    and the step counts equal to what the stream dispatches."""
    arrays, group = _task_arrays(task, n=30, seed=8, lo=3, hi=20)
    counts = tft.packed_epoch_step_counts(
        arrays, n_rows=2, seq_len=S, max_segments=G, seed=3, epochs=2,
        group_size=group)
    for epoch in range(2):
        kw = dict(n_rows=2, seq_len=S, max_segments=G, shuffle=True,
                  seed=3 + epoch, group_size=group)
        got = list(tft.packed_train_batches(
            arrays, pack_labels=_pack_labels(task), **kw))
        want = list(jft.packed_train_batches(
            arrays, pack_labels=_pack_labels(task, port=False), **kw))
        assert len(got) == len(want) == counts[epoch]
        placed = 0
        for (gb, greal, gn), (wb, wreal, wn) in zip(got, want):
            assert (greal, gn) == (wreal, wn)
            assert set(gb) == set(wb)
            for k in wb:
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
                assert gb[k].shape[:2] == (1, 2)
            placed += gn
        assert placed == 30


# -- the packed losses --------------------------------------------------------


def _packed_layout(seed, rows=3):
    rng = np.random.RandomState(seed)
    seg = np.zeros((rows, S), np.int32)
    for r in range(rows):
        cursor = 0
        for g in range(1 + (r + seed) % G):
            ln = int(rng.randint(4, 11))
            seg[r, cursor:cursor + ln] = g + 1
            cursor += ln
    return seg


@pytest.mark.parametrize("which", ["token", "qa"])
def test_packed_losses_and_gradients_equal_jax(which):
    rng = np.random.RandomState(9)
    seg = _packed_layout(9)
    if which == "token":
        logits = rng.randn(3, S, 5).astype(np.float32)
        labels = rng.randint(0, 5, (3, S)).astype(np.int32)
        labels[seg == 0] = NER_IGNORE
        labels[:, ::7] = NER_IGNORE

        def jfn(lg):
            return jlosses.packed_token_loss(lg, jnp.asarray(labels),
                                             jnp.asarray(seg), G)

        def tfn(lg):
            return tlosses.packed_token_loss(lg, torch.from_numpy(labels),
                                             torch.from_numpy(seg), G)
        inputs = (logits,)
    else:
        start = rng.randn(3, S).astype(np.float32)
        end = rng.randn(3, S).astype(np.float32)
        pos = np.full((2, 3, G), -1, np.int32)
        for r in range(3):
            for g in range(1, seg[r].max() + 1):
                where = np.nonzero(seg[r] == g)[0]
                pos[:, r, g - 1] = rng.choice(where, 2)
        pos[1, 0, 0] = -1                       # an answer out of window

        def jfn(s, e):
            return jlosses.packed_qa_loss(s, e, jnp.asarray(pos[0]),
                                          jnp.asarray(pos[1]),
                                          jnp.asarray(seg), G)

        def tfn(s, e):
            return tlosses.packed_qa_loss(s, e, torch.from_numpy(pos[0]),
                                          torch.from_numpy(pos[1]),
                                          torch.from_numpy(seg), G)
        inputs = (start, end)
    want, wgrads = jax.value_and_grad(jfn, argnums=tuple(
        range(len(inputs))))(*map(jnp.asarray, inputs))
    tin = [torch.from_numpy(x).requires_grad_() for x in inputs]
    got = tfn(*tin)
    tgrads = torch.autograd.grad(got, tin)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for g, w in zip(tgrads, wgrads):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# -- per task: packed against JAX, and packed against one a row ---------------


def _jax_cfg():
    return JaxBertConfig(**CFG, dtype="float32", stacked_params=False,
                         fused_ops=False, attention_impl="xla")


def _jax_model(task):
    cfg = _jax_cfg()
    return {
        "classify": lambda: jbert.BertForSequenceClassification(
            cfg, num_labels=2, max_segments=G, dtype=jnp.float32),
        "choice": lambda: jbert.BertForMultipleChoice(
            cfg, num_choices=C, max_segments=G, dtype=jnp.float32),
        "embed": lambda: jbert.BertForSentenceEmbedding(
            cfg, num_labels=2, max_segments=G, dtype=jnp.float32),
        "ner": lambda: jbert.BertForTokenClassification(
            cfg, num_labels=4, dtype=jnp.float32),
        "squad": lambda: jbert.BertForQuestionAnswering(
            cfg, dtype=jnp.float32)}[task]()


def _port_model(task, flat):
    cfg = BertConfig.from_dict(CFG)
    model = {
        "classify": lambda: tbert.BertForSequenceClassification(
            cfg, num_labels=2, max_segments=G, dtype=torch.float32),
        "choice": lambda: tbert.BertForMultipleChoice(
            cfg, max_segments=G, dtype=torch.float32),
        "embed": lambda: tbert.BertForSentenceEmbedding(
            cfg, num_labels=2, max_segments=G, dtype=torch.float32),
        "ner": lambda: tbert.BertForTokenClassification(
            cfg, num_labels=4, dtype=torch.float32),
        "squad": lambda: tbert.BertForQuestionAnswering(
            cfg, dtype=torch.float32)}[task]()
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model


@pytest.fixture(scope="module")
def task_params():
    out = {}
    for i, task in enumerate(TASKS):
        s = jnp.zeros((1, C, S) if task == "choice" else (1, S), jnp.int32)
        out[task] = unbox(jax.jit(_jax_model(task).init)(
            jax.random.PRNGKey(30 + i), s, s, s)["params"])
    return out


def _jax_packed_loss(task, model):
    def loss_fn(params, batch):
        # JAX's NER loss passes no token types (tasks/ner_task.py)
        out = model.apply(
            {"params": params}, batch["input_ids"],
            None if task == "ner" else batch["token_type_ids"],
            batch["attention_mask"], deterministic=True,
            position_ids=batch["position_ids"],
            segment_ids=batch["segment_ids"])
        if task == "classify":
            return jlosses.segment_classification_loss(out, batch["labels"])
        if task == "embed":
            return jlosses.segment_classification_loss(out[1],
                                                       batch["labels"])
        if task == "choice":
            return jlosses.choice_loss(out, batch["labels"], C)
        if task == "ner":
            return jlosses.packed_token_loss(out, batch["labels"],
                                             batch["segment_ids"], G,
                                             ignore_index=NER_IGNORE)
        return jlosses.packed_qa_loss(out[0], out[1],
                                      batch["start_positions"],
                                      batch["end_positions"],
                                      batch["segment_ids"], G)
    return loss_fn


def _port_packed_builder(task):
    from bert_pytorch_tpu_torch.tasks import (choice, classify, embed,
                                              ner_task, squad_task)

    return {"classify": classify._loss_builder, "embed": embed._loss_builder,
            "choice": choice.make_loss_builder(C),
            "ner": ner_task._packed_loss_builder(G),
            "squad": squad_task._packed_loss_builder(G)}[task]


def _port_loss_and_grads(task, model, batch):
    from bert_pytorch_tpu_torch.training.pretrain import (compute_params,
                                                          loss_and_grads)

    gparams = compute_params(dict(model.named_parameters()), None)
    loss, _, grads = loss_and_grads(_port_packed_builder(task)(model),
                                    gparams, tp._torch_batch(batch), None)
    return loss, grads


def _pack_both(task, arrays, group):
    """(packed batch, the same examples one to a row): the single batch's
    units follow the packed batch's row-major order and keep its G, so
    the ordered (B, G) sums see the same values in the same order."""
    n = len(arrays["input_ids"])
    labels = _pack_labels(task)
    multi, placements = tft.pack_finetune_batch(
        arrays, list(range(n)), n_rows=2, seq_len=S, max_segments=G,
        group_size=group)
    assert len(placements) == n, "the fixture must pack whole"
    assert max(p.seg0 for p in placements) > 0, "no row holds two units"
    multi.update(labels(arrays, placements, 2, S, G))
    order = [p.unit for p in sorted(placements,
                                    key=lambda p: (p.row, p.seg0))]
    single, sp = tft.pack_finetune_batch(arrays, order, n_rows=n, seq_len=S,
                                         max_segments=group,
                                         group_size=group)
    assert len(sp) == n and all(p.seg0 == 0 for p in sp)
    single.update(labels(arrays, sp, n, S, G))
    return multi, single


@pytest.mark.parametrize("task", TASKS)
def test_packed_loss_and_gradients_equal_jax(task_params, task):
    arrays, group = _task_arrays(task, seed=TASKS.index(task))
    multi, _ = _pack_both(task, arrays, group)
    params = task_params[task]
    want, wgrads = jax.value_and_grad(_jax_packed_loss(task,
                                                       _jax_model(task)))(
        params, {k: jnp.asarray(v) for k, v in multi.items()})
    loss, grads = _port_loss_and_grads(
        task, _port_model(task, tp._flat(params)), multi)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    wflat = params_from_flax(tp._flat(wgrads))
    assert set(grads) == set(wflat)
    for k, w in wflat.items():
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("task", TASKS)
def test_packed_equals_the_same_examples_one_to_a_row(task_params, task):
    arrays, group = _task_arrays(task, seed=10 + TASKS.index(task))
    multi, single = _pack_both(task, arrays, group)
    model = _port_model(task, tp._flat(task_params[task]))
    lm, gm = _port_loss_and_grads(task, model, multi)
    ls, gs = _port_loss_and_grads(task, model, single)
    assert lm.item() == ls.item(), (task, lm.item(), ls.item())
    for k in gm:
        np.testing.assert_allclose(gm[k].numpy(), gs[k].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_three_packed_classify_steps_match_jax(task_params):
    """Three steps of packed classify batches through JAX's
    build_pretrain_step (its finetune recipe, classify's packed loss)
    and the port's: loss, learning rate and grad_norm per step."""
    from bert_pytorch_tpu.tasks import classify as jclassify
    from bert_pytorch_tpu.training import pretrain as jax_pretrain
    from bert_pytorch_tpu.training.state import TrainState as JaxState
    from bert_pytorch_tpu_torch.tasks import classify
    from bert_pytorch_tpu_torch.training.pretrain import (build_pretrain_step,
                                                          dropout_seeds)
    from bert_pytorch_tpu_torch.training.state import make_train_state

    params = task_params["classify"]
    arrays, _ = _task_arrays("classify", n=24, seed=20)
    batches = list(tft.packed_train_batches(
        arrays, n_rows=2, seq_len=S, max_segments=G,
        pack_labels=classify.pack_labels, shuffle=True, seed=1))
    assert len(batches) >= 3
    args = types.SimpleNamespace(lr=1e-3, warmup_proportion=0.2,
                                 clip_grad=1.0)
    jsched, jtx = jft.finetune_optimizer(args, 10)
    model = _jax_model("classify")
    jstep = jax.jit(jax_pretrain.build_pretrain_step(
        model, jtx, schedule=jsched,
        loss_fn_builder=jclassify.packed_loss_builder))
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params,
                     opt_state=jtx.init(params))
    pmodel = _port_model("classify", tp._flat(params))
    psched, ptx = tft.finetune_optimizer(args, 10)
    pstate = make_train_state(pmodel, ptx)
    pstep = build_pretrain_step(pmodel, ptx, schedule=psched,
                                loss_fn_builder=classify._loss_builder)
    for i, (batch, _, _) in enumerate(batches[:3]):
        state, metrics = jstep(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                               jax.random.PRNGKey(i))
        pm = pstep(pstate, tp._torch_batch(batch),
                   dropout_seeds(0, i + 1, 1, pmodel.n_dropout_sites))
        np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(pm["learning_rate"],
                                   float(metrics["learning_rate"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(metrics["grad_norm"]),
                                   rtol=GRAD_TOL)
    assert pstate.step == 3


# -- the entry points ---------------------------------------------------------


def _train_records(path):
    return [r for r in map(json.loads, open(path).read().splitlines())
            if r["tag"] == "train"]


def _packable_task_files(tmp_path, task):
    """test_torch_tasks' files and argv; choice's with short texts and
    rows of 64, so that a 4-choice group fits one packed row."""
    from tests.test_torch_tasks import (_task_argv, task_files,
                                        write_choice_jsonl)

    cfg, files = task_files(tmp_path, task)
    extra = []
    if task == "choice":
        for split, seed in (("train", 0), ("val", 1), ("test", 2)):
            files[split] = write_choice_jsonl(
                tmp_path / f"short_{split}.jsonl", 8, seed, lengths=(1, 4))
        extra = ["--max_seq_len", "64"]
    return cfg, lambda out: _task_argv(task, cfg, files, out) + extra


@pytest.mark.parametrize("task", ["classify", "choice", "embed"])
def test_run_finetune_packed_two_steps(tmp_path, task):
    from bert_pytorch_tpu_torch import run_finetune

    _, argv = _packable_task_files(tmp_path, task)
    out = tmp_path / "out"
    got = run_finetune.main(
        ["--task", task] + argv(out)
        + ["--packing", "--max_steps", "2", "--device", "cpu"],
        log=lambda m: None)
    assert 0.0 <= got["test_accuracy"] <= 1.0
    assert os.listdir(out / "ckpt") == ["2"]
    records = _train_records(out / f"{task}_log.jsonl")
    assert records and records[-1]["step"] == 2
    for r in records:
        assert 0.0 < r["packing_efficiency"] <= 1.0
        assert r["packing_efficiency"] == r["real_tokens"] / r["slot_tokens"]
        # batch x seq rows, whatever the task
        assert r["slot_tokens"] == 4 * (64 if task == "choice" else 32)


def test_run_squad_and_run_ner_packed_two_steps(tmp_path):
    from bert_pytorch_tpu_torch import run_ner, run_squad
    from tests.test_torch_finetune import _files as squad_files
    from tests.test_torch_finetune import _squad_argv
    from tests.test_torch_ner import _files as ner_files
    from tests.test_torch_ner import _ner_argv

    (tmp_path / "squad").mkdir()
    cfg, train = squad_files(tmp_path / "squad")
    out = tmp_path / "squad" / "out"
    res = run_squad.main(_squad_argv(cfg, train, out)
                         + ["--packing", "--max_steps", "2", "--device",
                            "cpu"], log=lambda m: None)
    assert {"exact_match", "f1"} <= set(res)
    assert os.listdir(out / "ckpt") == ["2"]
    records = _train_records(out / "squad_log.jsonl")
    assert records[-1]["step"] == 2 and records[-1]["slot_tokens"] == 2 * 64
    assert 0.0 < records[-1]["packing_efficiency"] <= 1.0

    (tmp_path / "ner").mkdir()
    cfg, train, val, test = ner_files(tmp_path / "ner")
    out = tmp_path / "ner" / "out"
    res = run_ner.main(_ner_argv(cfg, train, val, test, out)
                       + ["--packing", "--epochs", "1", "--device", "cpu"],
                       log=lambda m: None)
    assert "test_f1" in res
    records = _train_records(out / "ner_log.jsonl")
    assert [(r["epoch"], r["step"]) for r in records] == [(0, 2)]
    assert os.listdir(out / "ckpt") == ["2"]
    assert records[-1]["slot_tokens"] == 4 * 32
    assert 0.0 < records[-1]["packing_efficiency"] <= 1.0


def test_packing_with_accumulation_raises_as_jax(tmp_path):
    from bert_pytorch_tpu_torch import run_squad
    from tests.test_torch_finetune import _files as squad_files
    from tests.test_torch_finetune import _squad_argv

    cfg, train = squad_files(tmp_path)
    with pytest.raises(SystemExit, match="incompatible with gradient "
                                         "accumulation"):
        run_squad.main(_squad_argv(cfg, train, tmp_path / "out")
                       + ["--packing", "--gradient_accumulation_steps", "2",
                          "--device", "cpu"], log=lambda m: None)


@pytest.mark.parametrize("given", [3, 8, 9])
def test_choice_rounds_packing_max_segments_to_whole_groups(tmp_path, given):
    """As JAX's choice setup: G rounds down to a multiple of C (at least
    one group), the model gathers that many segments, and a packed step
    count is the packed stream's."""
    from bert_pytorch_tpu_torch.tasks import choice
    from tests.test_torch_tasks import C as TC

    cfg, argv = _packable_task_files(tmp_path, "choice")
    args = choice.parse_arguments(
        argv(tmp_path / "o")
        + ["--packing", "--packing_max_segments", str(given)])
    run = choice.setup(args, BertConfig.from_json_file(cfg),
                       torch.device("cpu"), lambda m: None,
                       lambda *a, **k: None)
    want = max(TC, given // TC * TC)
    assert args.packing_max_segments == run.model.max_segments == want
    assert run.group_size == TC and run.pack_labels is not None
    assert run.total_steps == sum(tft.packed_epoch_step_counts(
        run.train_arrays, n_rows=4, seq_len=run.seq_len, max_segments=want,
        seed=args.seed, epochs=args.epochs, group_size=TC))
