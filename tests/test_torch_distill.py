"""Distillation of the port (training/distill.py, run_distill) against the
JAX package's, on the CPU, at a 2-layer width-32 teacher and its
student_1l_16 (width 16: the projections bridge the widths), seq 48.

- `student_config`, `default_layer_map` and `parse_layer_map` equal JAX's,
  errors included.
- The taps: names, count and shapes for every head; the outputs with the
  flag equal to those without; the values against JAX's `debug_taps`
  sows (through `layer_taps`) for both JAX encoder layouts.
- Each KD loss and `tap_match_loss` alone, packed and not, and their
  gradients, against JAX's at the f32 tiers (1e-5, 2e-4).
- The whole distillation loss and the gradients of the student and of the
  projections (JAX's carried across by `params_from_flax`) against JAX's
  make_distill_loss_builder: classify packed with both tap kinds, SQuAD
  unpacked.
- On the CPU, the packed loss bit-equal to the same examples one a row;
  precomputed teacher logits give bit-identical student gradients and
  the teacher no gradient.
- The depth-mismatch message of the strict restore, both directions.
- `run_distill --device cpu` end to end beside JAX's run_distill: the
  summary's keys, the student's model_config.json (debug_taps false),
  the student served by run_server --device cpu, the broken-student
  contrast on a learnable corpus.
- StepWatch against JAX's under one injected clock, lookup_peak_flops,
  and --perf_artifact's FINETUNE json against JAX's writer.
"""

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

from bert_pytorch_tpu import config as jconfig  # noqa: E402
from bert_pytorch_tpu.models import bert as jbert  # noqa: E402
from bert_pytorch_tpu.telemetry import stepwatch as jsw  # noqa: E402
from bert_pytorch_tpu.training import distill as jdistill  # noqa: E402
from bert_pytorch_tpu.training import finetune as jft  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch import config as tconfig  # noqa: E402
from bert_pytorch_tpu_torch.models import bert as tbert  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from bert_pytorch_tpu_torch.telemetry import stepwatch as tsw  # noqa: E402
from bert_pytorch_tpu_torch.training import distill as tdistill  # noqa: E402
from bert_pytorch_tpu_torch.training import finetune as tft  # noqa: E402
from bert_pytorch_tpu_torch.training.pretrain import (  # noqa: E402
    compute_params, loss_and_grads)
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_torch_finetune_packing import (  # noqa: E402
    CFG, G, S, _pack_both, _task_arrays)

LOSS_RTOL, GRAD_TOL, FWD_TOL = 1e-5, 2e-4, 1e-5
STUDENT = "student_1l_16"


def _jcfg(**kw):
    base = dict(CFG, dtype="float32", stacked_params=False, fused_ops=False,
                attention_impl="xla", debug_taps=True)
    base.update(kw)
    return jconfig.BertConfig(**base)


def _tcfg():
    return tconfig.BertConfig.from_dict(CFG)


# -- presets and layer maps ---------------------------------------------------


@pytest.mark.parametrize("preset", ["student_6l_768", "student_4l_512",
                                    "student_2l_100", "student_1l_16",
                                    "student_3l_1"])
def test_student_config_equals_jax(preset):
    large = dict(hidden_size=1024, num_hidden_layers=24,
                 num_attention_heads=16, intermediate_size=4096,
                 vocab_size=30528, hidden_dropout_prob=0.1)
    jt = jconfig.BertConfig(**large)
    tt = tconfig.BertConfig(**large)
    js, ts = jconfig.student_config(preset, jt), tconfig.student_config(
        preset, tt)
    for k in tconfig.BertConfig.__dataclass_fields__:
        if hasattr(js, k):
            assert getattr(ts, k) == getattr(js, k), k
    assert tconfig.is_student_preset(preset) and jconfig.is_student_preset(
        preset)
    if preset == "student_6l_768":
        assert (ts.num_hidden_layers, ts.hidden_size, ts.num_attention_heads,
                ts.intermediate_size) == (6, 768, 12, 3072)


@pytest.mark.parametrize("bad", ["student_768", "bert_base", "student_0l_64",
                                 ""])
def test_student_config_errors_equal_jax(bad):
    t = tconfig.BertConfig()
    with pytest.raises(ValueError) as want:
        jconfig.student_config(bad, jconfig.BertConfig())
    with pytest.raises(ValueError) as got:
        tconfig.student_config(bad, t)
    assert str(got.value) == str(want.value)
    assert tconfig.is_student_preset(bad) == jconfig.is_student_preset(bad)


@pytest.mark.parametrize("text,ls,lt", [
    (None, 6, 24), (None, 6, 12), ("", 2, 2), ("0:0,1:11", 2, 12),
    ("0:12", 2, 12), ("0-3", 2, 12), ("2:0", 2, 12), ("a:b", 1, 1)])
def test_layer_maps_equal_jax(text, ls, lt):
    try:
        want = jdistill.parse_layer_map(text, ls, lt)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tdistill.parse_layer_map(text, ls, lt)
        assert str(got.value) == str(e)
        return
    assert tdistill.parse_layer_map(text, ls, lt) == want
    assert tdistill.default_layer_map(ls, lt) == jdistill.default_layer_map(
        ls, lt)
    if (ls, lt) == (6, 24):
        assert [t for _, t in want] == [3, 7, 11, 15, 19, 23]
    with pytest.raises(ValueError):
        tdistill.default_layer_map(0, lt)


# -- taps ---------------------------------------------------------------------


def _port_head(task, cfg, dtype=torch.float32):
    return {
        "classify": lambda: tbert.BertForSequenceClassification(
            cfg, num_labels=2, max_segments=G, dtype=dtype),
        "choice": lambda: tbert.BertForMultipleChoice(
            cfg, max_segments=G, dtype=dtype),
        "embed": lambda: tbert.BertForSentenceEmbedding(
            cfg, num_labels=2, max_segments=G, dtype=dtype),
        "ner": lambda: tbert.BertForTokenClassification(
            cfg, num_labels=4, dtype=dtype),
        "squad": lambda: tbert.BertForQuestionAnswering(cfg, dtype=dtype),
    }[task]()


@pytest.mark.parametrize("task", ["classify", "choice", "embed", "ner",
                                  "squad"])
def test_taps_names_count_and_shapes_for_every_head(task):
    cfg = _tcfg()
    torch.manual_seed(0)
    model = _port_head(task, cfg)
    tbert.init_weights(model, torch.Generator().manual_seed(1))
    arrays, group = _task_arrays(task, n=3, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()
             if k in ("input_ids", "token_type_ids", "attention_mask")}
    with torch.no_grad():
        plain = model(**batch)
        out, taps = model(**batch, return_taps=True)
    flat = (lambda o: o if isinstance(o, tuple) else (o,))
    assert all(torch.equal(a, b) for a, b in zip(flat(plain), flat(out)))
    rows = 3 * group
    assert len(taps) == cfg.num_hidden_layers
    for layer in taps:
        assert set(layer) == {"attention_out", "mlp_out"}
        for v in layer.values():
            assert tuple(v.shape) == (rows, S, cfg.hidden_size)


@pytest.mark.parametrize("stacked", [True, False],
                         ids=["stacked", "unstacked"])
def test_taps_equal_jax_both_layouts(stacked):
    jcfg = _jcfg(stacked_params=stacked, next_sentence=True)
    jmodel = jbert.BertForSequenceClassification(jcfg, num_labels=2,
                                                 max_segments=G,
                                                 dtype=jnp.float32)
    arrays, _ = _task_arrays("classify", n=3, seed=2)
    ids, types, mask = (jnp.asarray(arrays[k]) for k in
                        ("input_ids", "token_type_ids", "attention_mask"))
    params = unbox(jmodel.init(jax.random.PRNGKey(3), ids, types,
                               mask)["params"])
    _, vs = jmodel.apply({"params": params}, ids, types, mask,
                         deterministic=True, mutable=["debug_taps"])
    want = jdistill.layer_taps(vs["debug_taps"], jcfg)
    model = _port_head("classify", _tcfg())
    model.load_state_dict(params_from_flax(tp._flat(params)), strict=True)
    with torch.no_grad():
        _, got = model(*(torch.from_numpy(arrays[k]) for k in
                         ("input_ids", "token_type_ids", "attention_mask")),
                       return_taps=True)
    assert len(got) == len(want) == CFG["num_hidden_layers"]
    for g, w in zip(got, want):
        for k in ("attention_out", "mlp_out"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=FWD_TOL, atol=FWD_TOL, err_msg=k)


# -- the losses alone ---------------------------------------------------------


def _layout(seed, rows=3):
    rng = np.random.RandomState(seed)
    seg = np.zeros((rows, S), np.int32)
    for r in range(rows):
        cursor = 0
        for g in range(1 + (r + seed) % G):
            ln = int(rng.randint(4, 11))
            seg[r, cursor:cursor + ln] = g + 1
            cursor += ln
    return seg


LOSS_CASES = ["segment", "segment_plain", "token_packed", "token_plain",
              "qa_packed", "qa_plain", "tap_packed", "tap_plain",
              "tap_proj_packed", "tap_proj_plain"]


def _loss_case(which):
    """(inputs, jax fn, port fn) over the same numpy inputs."""
    rng = np.random.RandomState(LOSS_CASES.index(which))
    seg = _layout(5)
    T = 2.0
    j, t = jdistill, tdistill
    J = lambda x: jnp.asarray(x)  # noqa: E731
    P = torch.from_numpy
    if which.startswith("segment"):
        shape = (3, G, 3) if which == "segment" else (5, 3)
        labels = rng.randint(0, 3, shape[:-1]).astype(np.int32)
        labels.reshape(-1)[::3] = -1
        ins = [rng.randn(*shape).astype(np.float32) * 2 for _ in range(2)]
        return (ins, lambda s, tt: j.kd_segment_loss(s, tt, J(labels), T),
                lambda s, tt: t.kd_segment_loss(s, tt, P(labels), T))
    if which.startswith("token"):
        labels = rng.randint(0, 5, (3, S)).astype(np.int32)
        labels[seg == 0] = -100
        labels[:, ::7] = -100
        ins = [rng.randn(3, S, 5).astype(np.float32) * 2 for _ in range(2)]
        if which == "token_packed":
            return (ins, lambda s, tt: j.kd_token_loss(
                s, tt, J(labels), J(seg), G, T),
                lambda s, tt: t.kd_token_loss(s, tt, P(labels), P(seg), G, T))
        return (ins, lambda s, tt: j.kd_plain_token_loss(s, tt, J(labels), T),
                lambda s, tt: t.kd_plain_token_loss(s, tt, P(labels), T))
    if which.startswith("qa"):
        ins = [rng.randn(3, S).astype(np.float32) * 2 for _ in range(4)]
        if which == "qa_packed":
            return (ins, lambda a, b, c, d: j.kd_qa_loss(a, b, c, d, J(seg),
                                                         G, T),
                    lambda a, b, c, d: t.kd_qa_loss(a, b, c, d, P(seg), G, T))
        return (ins, lambda a, b, c, d: j.kd_plain_qa_loss(a, b, c, d, T),
                lambda a, b, c, d: t.kd_plain_qa_loss(a, b, c, d, T))
    mask = (seg > 0).astype(np.int32)
    packed = which.endswith("packed")
    ins = [rng.randn(3, S, 16).astype(np.float32),
           rng.randn(3, S, 32 if "proj" in which else 16).astype(np.float32)]
    if "proj" in which:
        ins.append(rng.randn(16, 32).astype(np.float32) * 0.2)
    jseg, tseg = (J(seg), P(seg)) if packed else (None, None)

    def jfn(s, tt, *proj):
        return j.tap_match_loss(s, tt, {"kernel": proj[0]} if proj else None,
                                J(mask), jseg, G)

    def tfn(s, tt, *proj):
        return t.tap_match_loss(s, tt, proj[0] if proj else None, P(mask),
                                tseg, G)
    return ins, jfn, tfn


@pytest.mark.parametrize("which", LOSS_CASES)
def test_each_loss_and_its_gradients_equal_jax(which):
    """The loss and its gradients with respect to the student's side (the
    student's logits or tap, and the projection): the teacher's side is
    a constant of the step."""
    ins, jfn, tfn = _loss_case(which)
    student = ((0, 1) if which.startswith("qa") else
               (0, 2) if "proj" in which else (0,))
    want, wgrads = jax.value_and_grad(jfn, argnums=student)(
        *map(jnp.asarray, ins))
    tin = [torch.from_numpy(x).requires_grad_(i in student)
           for i, x in enumerate(ins)]
    got = tfn(*tin)
    tgrads = torch.autograd.grad(got, [tin[i] for i in student])
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert np.isfinite(got.item()) and got.item() > 0.0
    for g, w in zip(tgrads, wgrads):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# -- the whole distillation loss ---------------------------------------------


def _pair(task):
    """(jax teacher, jax student, their params with JAX's projections,
    port teacher, port student, port projections, dcfgs) for `task`."""
    jt_cfg = _jcfg()
    js_cfg = jconfig.student_config(STUDENT, jt_cfg)
    tt_cfg = _tcfg()
    ts_cfg = tconfig.student_config(STUDENT, tt_cfg)
    kw = dict(temperature=2.0, alpha_kd=1.0, alpha_ce=0.5, alpha_hidden=1.0,
              alpha_attn=0.5, layer_map=jdistill.default_layer_map(1, 2),
              max_segments=G)
    if task == "classify":
        jm = lambda c: jbert.BertForSequenceClassification(  # noqa: E731
            c, num_labels=2, max_segments=G, dtype=jnp.float32)
    else:
        jm = lambda c: jbert.BertForQuestionAnswering(  # noqa: E731
            c, dtype=jnp.float32)
    jteacher, jstudent = jm(jt_cfg), jm(js_cfg)
    x = jnp.zeros((1, S), jnp.int32)
    t_params = unbox(jteacher.init(jax.random.PRNGKey(0), x, x, x)["params"])
    s_params = dict(unbox(jstudent.init(jax.random.PRNGKey(1), x, x,
                                        x)["params"]))
    jdcfg = jdistill.DistillConfig(**kw)
    s_params["distill_proj"] = jdistill.init_projections(
        jax.random.PRNGKey(2), jdcfg, js_cfg, jt_cfg)
    pteacher, pstudent = (_port_head(task, tt_cfg),
                          _port_head(task, ts_cfg))
    pteacher.load_state_dict(params_from_flax(tp._flat(t_params)))
    sd = params_from_flax(tp._flat(s_params))
    proj = {k: v for k, v in sd.items() if k.startswith("distill_proj.")}
    pstudent.load_state_dict({k: v for k, v in sd.items() if k not in proj})
    assert sorted(proj) == sorted(
        f"distill_proj.layer_0.{k}.kernel" for k in ("attention_out",
                                                     "mlp_out"))
    assert all(tuple(v.shape) == (16, 32) for v in proj.values())
    return (jteacher, jstudent, t_params, s_params, pteacher, pstudent, proj,
            jdcfg, tdistill.DistillConfig(**kw))


def _port_distill(pteacher, pstudent, proj, dcfg, kind, packed, batch,
                  pre=None):
    builder = tdistill.make_distill_loss_builder(
        teacher_model=pteacher, dcfg=dcfg, output_kind=kind, packed=packed,
        label_ignore={"labels": -1})
    params = dict(pstudent.named_parameters())
    params.update(proj)
    micro = tp._torch_batch(batch)
    if pre is not None:
        micro.update(pre)
    loss, _, grads = loss_and_grads(builder(pstudent),
                                    compute_params(params, None), micro, None)
    return loss, grads


@pytest.mark.parametrize("task", ["classify", "squad"])
def test_distill_loss_and_gradients_equal_jax(task):
    (jteacher, jstudent, t_params, s_params, pteacher, pstudent, proj, jdcfg,
     tdcfg) = _pair(task)
    arrays, group = _task_arrays(task, seed=7)
    if task == "classify":
        batch, _ = _pack_both(task, arrays, group)
        kind, packed = "segment", True
    else:
        batch = {k: v for k, v in arrays.items()}
        kind, packed = "token", False
    jfn = jdistill.make_distill_loss_builder(
        teacher_model=jteacher, teacher_params=t_params, dcfg=jdcfg,
        output_kind=kind, packed=packed,
        label_ignore={"labels": -1})(jstudent)
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jfn(p, b, jax.random.PRNGKey(0), deterministic=True),
        has_aux=True))(s_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_distill(pteacher, pstudent, proj, tdcfg, kind,
                                packed, batch)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    wflat = params_from_flax(tp._flat(wgrads))
    assert set(grads) == set(wflat)
    assert any(k.startswith("distill_proj.") for k in grads)
    for k, w in wflat.items():
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_packed_distill_loss_bit_equal_to_one_a_row():
    """The full mix (KD + hard + both tap terms through the projections)
    on a multi-segment packed batch equals the same examples one a row,
    bit for bit, on the CPU."""
    _, _, _, _, pteacher, pstudent, proj, _, dcfg = _pair("classify")
    arrays, _ = _task_arrays("classify", seed=8)
    multi, single = _pack_both("classify", arrays, 1)
    lm, _ = _port_distill(pteacher, pstudent, proj, dcfg, "segment", True,
                          multi)
    ls, _ = _port_distill(pteacher, pstudent, proj, dcfg, "segment", True,
                          single)
    assert lm.item() == ls.item()
    assert np.isfinite(lm.item()) and lm.item() > 0.0


def test_precomputed_teacher_logits_and_the_teacher_gets_no_gradient():
    import dataclasses

    _, _, _, _, pteacher, pstudent, proj, _, dcfg = _pair("classify")
    dcfg = dataclasses.replace(dcfg, alpha_hidden=0.0, alpha_attn=0.0)
    arrays, _ = _task_arrays("classify", seed=9)
    multi, _ = _pack_both("classify", arrays, 1)
    before = {k: v.clone() for k, v in pteacher.state_dict().items()}
    _, g_in = _port_distill(pteacher, pstudent, {}, dcfg, "segment", True,
                            multi)
    b = tp._torch_batch(multi)
    with torch.no_grad():
        logits = pteacher(b["input_ids"], b["token_type_ids"],
                          b["attention_mask"], b["position_ids"],
                          b["segment_ids"])
    _, g_pre = _port_distill(pteacher, pstudent, {}, dcfg, "segment", True,
                             multi, pre={"teacher_logits": logits})
    assert set(g_in) == set(g_pre)
    assert all(torch.equal(g_in[k], g_pre[k]) for k in g_in)
    assert sum(float(g.abs().sum()) for g in g_in.values()) > 0.0
    assert all(p.grad is None for p in pteacher.parameters())
    assert all(torch.equal(v, before[k])
               for k, v in pteacher.state_dict().items())


def test_depth_mismatch_message_both_directions():
    from bert_pytorch_tpu_torch.training.checkpoint import (
        model_params_only, strict_load_state)

    cfg = _tcfg()
    deep = _port_head("classify", cfg)
    shallow = _port_head("classify", cfg.replace(num_hidden_layers=1))
    for model, state, want, have in ((deep, shallow.state_dict(), 2, 1),
                                     (shallow, deep.state_dict(), 1, 2)):
        with pytest.raises(ValueError) as e:
            strict_load_state(model, state)
        msg = str(e.value)
        assert f"expects {want} encoder layer(s)" in msg, msg
        assert f"carries {have}" in msg, msg
        assert "--student" in msg and "model_config.json" in msg, msg
    # the projections: the strict restore refuses them, and the read of a
    # checkpoint for a model (model_params_only) drops exactly them
    state = dict(deep.state_dict())
    state["distill_proj.layer_0.mlp_out.kernel"] = torch.zeros(32, 64)
    with pytest.raises(ValueError, match="distill_proj.layer_0"):
        strict_load_state(deep, state)
    assert set(model_params_only(state)) == set(deep.state_dict())
    strict_load_state(deep, model_params_only(state))


# -- the entry point ----------------------------------------------------------


def _marker_files(tmp_path, n_train=24, n_test=12):
    """A learnable corpus ("cat" positive, "dog" negative) in classify's
    TSV, a vocab and a tiny model config (dropout off)."""
    from tests.test_torch_tasks import VOCAB

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    cfg = tmp_path / "model_config.json"
    cfg.write_text(json.dumps(dict(
        CFG, vocab_size=len(VOCAB), vocab_file=str(vocab), lowercase=True,
        hidden_size=32, intermediate_size=64)))
    rng = np.random.RandomState(0)
    words = ["the", "sat", "on", "a", "mat", "red", "blue", "park"]

    def rows(n, seed):
        r = np.random.RandomState(seed)
        out = []
        for i in range(n):
            pos = i % 2 == 0
            text = " ".join(["cat" if pos else "dog"]
                            + list(r.choice(words, 4)))
            out.append(f"{'positive' if pos else 'negative'}\t{text}\t"
                       + " ".join(rng.choice(words, 3)))
        return "\n".join(out) + "\n"

    files = {}
    for split, n, seed in (("train", n_train, 1), ("val", n_test, 2),
                           ("test", n_test, 3)):
        files[split] = tmp_path / f"{split}.tsv"
        files[split].write_text(rows(n, seed))
    return str(cfg), {k: str(v) for k, v in files.items()}


def _cls_argv(cfg, files, out, epochs):
    return ["--model_config_file", cfg, "--train_file", files["train"],
            "--val_file", files["val"], "--test_file", files["test"],
            "--epochs", str(epochs), "--batch_size", "8", "--max_seq_len",
            "32", "--lr", "1e-3", "--output_dir", str(out), "--dtype",
            "float32", "--seed", "0"]


def test_run_distill_on_cpu_end_to_end(tmp_path):
    """A teacher by run_finetune, then run_distill --device cpu (packed,
    both tap losses): JAX's summary keys (its run_distill on the same
    files, its own teacher), the student's config, the student served,
    and --inject broken_student's larger accuracy delta."""
    import urllib.request

    import run_distill as jax_run_distill
    import run_finetune as jax_run_finetune
    from bert_pytorch_tpu_torch import run_distill, run_finetune, run_server

    cfg, files = _marker_files(tmp_path)
    distill_flags = ["--student", STUDENT, "--packing", "--alpha_hidden",
                     "1.0", "--alpha_attn", "1.0"]

    jax_run_finetune.main(["--task", "classify"] + _cls_argv(
        cfg, files, tmp_path / "jt", 1) + ["--max_steps", "1"])
    want = jax_run_distill.main(
        ["--task", "classify", "--teacher_checkpoint",
         str(tmp_path / "jt" / "ckpt")] + distill_flags
        + _cls_argv(cfg, files, tmp_path / "js", 1) + ["--max_steps", "1"])

    run_finetune.main(["--task", "classify"] + _cls_argv(
        cfg, files, tmp_path / "pt", 20) + ["--device", "cpu"],
        log=lambda m: None)
    argv = (["--task", "classify", "--teacher_checkpoint",
             str(tmp_path / "pt" / "ckpt")] + distill_flags
            + _cls_argv(cfg, files, tmp_path / "ps", 20)
            + ["--device", "cpu"])
    trace = {}
    got = run_distill.main(argv, log=lambda m: None, trace=trace)
    assert set(got) == set(want)
    assert got["projections"] == want["projections"] == ["layer_0"]
    assert got["layer_map"] == want["layer_map"] == [[0, 1]]
    assert got["loss_first"] > got["loss_last"]
    assert got["teacher_test_accuracy"] == 1.0
    assert all(p.grad is None for p in trace["teacher"].parameters())
    # the perf records' FLOPs a row: the student's forward and backward
    # and the teacher's forward (a third of its forward and backward)
    from bert_pytorch_tpu_torch.telemetry.stepwatch import flops_per_seq

    run = trace["run"]
    t_c, s_c = trace["teacher"].config, run.model.config
    assert s_c.num_hidden_layers < t_c.num_hidden_layers
    assert run.flops_per_row == pytest.approx(
        flops_per_seq(s_c, run.seq_len, s_c.vocab_size, 0)
        + flops_per_seq(t_c, run.seq_len, t_c.vocab_size, 0) / 3)
    s_cfg = json.loads((tmp_path / "ps" / "model_config.json").read_text())
    assert s_cfg["debug_taps"] is False and s_cfg["num_hidden_layers"] == 1
    assert s_cfg["hidden_size"] == 16

    broken = run_distill.main(
        argv[:argv.index("--output_dir")]
        + ["--output_dir", str(tmp_path / "pb"), "--inject",
           "broken_student"] + argv[argv.index("--output_dir") + 2:],
        log=lambda m: None)
    assert broken["accuracy_delta"] > got["accuracy_delta"]

    # the student serves with its own config; the teacher's config refuses
    # its checkpoint naming both depths
    handle = run_server.serve(run_server.parse_arguments([
        "--model_config_file", str(tmp_path / "ps" / "model_config.json"),
        "--task_checkpoint", f"classify={tmp_path / 'ps' / 'ckpt'}",
        "--port", "0", "--host", "127.0.0.1", "--device", "cpu",
        "--buckets", "32"]), log=lambda m: None)
    try:
        req = urllib.request.Request(
            handle.url + "/v1/classify",
            data=json.dumps({"text": "cat sat", "text_pair": "a mat"})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            assert json.loads(r.read())["label"] in ("negative", "positive")
        with urllib.request.urlopen(handle.url + "/healthz",
                                    timeout=60) as r:
            served = json.loads(r.read())["tasks"]["classify"]
    finally:
        handle.close()
    from bert_pytorch_tpu_torch.training.checkpoint import load_params

    teacher_n = sum(int(v.numel()) for v in load_params(
        str(tmp_path / "pt" / "ckpt"), log=lambda m: None)[0].values())
    assert 0 < served["model_params"] < teacher_n
    with pytest.raises(ValueError, match="expects 2 encoder layer"):
        run_server.serve(run_server.parse_arguments([
            "--model_config_file", cfg, "--task_checkpoint",
            f"classify={tmp_path / 'ps' / 'ckpt'}", "--port", "0",
            "--device", "cpu", "--buckets", "32"]), log=lambda m: None)


def test_run_distill_without_a_card_raises(tmp_path, monkeypatch):
    from bert_pytorch_tpu_torch import run_distill

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, files = _marker_files(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_distill.main(["--task", "classify", "--student", STUDENT,
                          "--teacher_checkpoint", str(tmp_path / "none")]
                         + _cls_argv(cfg, files, tmp_path / "o", 1),
                         log=lambda m: None)


# -- StepWatch and the FINETUNE json ------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.0375
        return self.t


def _drive(sw):
    out = []
    for step in range(7):
        with sw.phase("data_prep"):
            sw.note_tokens(100 + 7 * step)
        with sw.phase("dispatch"):
            pass
        rec = sw.step_done()
        if rec is not None:
            out.append(rec)
    with sw.pause():
        pass
    out.append(sw.flush())
    return out


@pytest.mark.parametrize("peak", [989e12, None])
def test_stepwatch_records_equal_jax(peak):
    cfg = _tcfg()
    flops = tsw.flops_per_seq(cfg, 128, cfg.vocab_size, 0) * 16
    assert flops == jsw.flops_per_seq(cfg, 128, cfg.vocab_size, 0) * 16
    kw = dict(flops_per_step=flops, seqs_per_step=16, seq_len=128,
              log_freq=3)
    got = _drive(tsw.StepWatch(peak_flops=peak, time_fn=_Clock(), **kw))
    # JAX's run_task falls back to its TPU DEFAULT_PEAK on an unknown
    # device; the port keeps no default: mfu 0.0 and peak_flops 0 there
    want = _drive(jsw.StepWatch(peak_flops=peak or jsw.DEFAULT_PEAK,
                                time_fn=_Clock(), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if peak is None and k in ("mfu", "peak_flops"):
                assert g[k] == 0 and w[k] > 0
            else:
                assert g[k] == w[k], k


def test_memory_fields_are_absent_off_the_card(tmp_path):
    """telemetry/memory.device_memory_snapshot is {} on the CPU, as JAX's
    hbm_snapshot is on a backend without memory stats, so a CPU
    pretraining run's perf records carry no hbm_* key (on a card every
    one carries hbm_peak_bytes, hbm_bytes_in_use and hbm_bytes_limit)."""
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.telemetry.memory import \
        device_memory_snapshot
    from tests.test_data import write_shard

    assert device_memory_snapshot("cpu") == {}
    assert device_memory_snapshot(torch.device("cpu")) == {}
    (tmp_path / "data").mkdir()
    write_shard(str(tmp_path / "data" / "part_0.hdf5"), 16, seq=32)
    (tmp_path / "tiny.json").write_text(json.dumps(dict(
        vocab_size=128, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, next_sentence=True)))
    run_pretraining.main([
        "--model_config_file", str(tmp_path / "tiny.json"),
        "--input_dir", str(tmp_path / "data"), "--output_dir",
        str(tmp_path / "out"), "--local_batch_size", "4",
        "--global_batch_size", "4", "--steps", "2", "--log_freq", "1",
        "--device", "cpu", "--tensorboard", "off", "--skip_checkpoint",
        "--vocab_pad_multiple", "8"], log=lambda m: None)
    with open(tmp_path / "out" / "logfile.jsonl") as f:
        perf = [r for r in map(json.loads, f) if r.get("tag") == "perf"]
    assert len(perf) == 2 and "step_time_ms" in perf[0]
    assert not any(k.startswith("hbm_") for r in perf for k in r)


def test_lookup_peak_flops_on_the_h100_names():
    f = tsw.lookup_peak_flops
    assert f("NVIDIA H100 80GB HBM3") == 989e12
    assert f("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert f("NVIDIA H100 PCIe", "bf16") == 756e12
    assert f("cpu") is None and f("TPU v4") is None
    with pytest.raises(ValueError, match="dtype"):
        f("NVIDIA H100 80GB HBM3", "int4")
    assert not hasattr(tsw, "DEFAULT_PEAK")


def test_perf_artifact_schema_and_merge_equal_jax(tmp_path):
    rec = {"real_tokens_per_sec": 10.5, "pad_fraction": 0.25,
           "packing_efficiency": 0.75, "seq_per_sec": 3.0,
           "step_time_ms": 12.5, "mfu": 0.0, "packing": True, "steps": 4}
    for writer, name in ((tft.write_finetune_artifact, "port.json"),
                         (jft.write_finetune_artifact, "jax.json")):
        writer(str(tmp_path / name), "classify", rec)
        writer(str(tmp_path / name), "ner", dict(rec, packing=False))
    got, want = (json.loads((tmp_path / n).read_text())
                 for n in ("port.json", "jax.json"))
    got.pop("time_unix")
    want.pop("time_unix")
    assert got == want and set(got["tasks"]) == {"classify", "ner"}


def test_run_finetune_perf_artifact_on_cpu(tmp_path):
    from bert_pytorch_tpu_torch import run_finetune

    cfg, files = _marker_files(tmp_path)
    out = tmp_path / "FINETUNE_x.json"
    lines = []
    run_finetune.main(["--task", "classify"] + _cls_argv(
        cfg, files, tmp_path / "o", 2) + ["--device", "cpu", "--packing",
                                          "--perf_artifact", str(out)],
        log=lines.append)
    doc = json.loads(out.read_text())
    rec = doc["tasks"]["classify"]
    assert doc["kind"] == "finetune" and doc["schema_version"] == 1
    assert set(rec) == {"real_tokens_per_sec", "pad_fraction",
                        "packing_efficiency", "seq_per_sec", "step_time_ms",
                        "mfu", "packing", "steps"}
    assert rec["packing"] is True and rec["mfu"] == 0.0
    assert 0.0 < rec["packing_efficiency"] <= 1.0
    perf = [json.loads(x) for x in (tmp_path / "o" / "classify_log.jsonl")
            .read_text().splitlines() if '"perf"' in x]
    assert perf and perf[-1]["peak_flops"] == 0


def test_chip_smoke_distill_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's distill phase at a tiny width on the CPU (the plain
    versions): teachers by run_task, classify distilled packed with both
    tap kinds and SQuAD at seq 384, the kernels-vs-plain, precomputed-
    logits and packed-vs-one-a-row checks, the student served."""
    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(
        vocab_size=30522, hidden_size=128, num_hidden_layers=4,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=512)))
    summary = {}
    chip_smoke.phase_distill(torch, np, summary, device="cpu",
                             cfg_path=str(cfg), student="student_2l_64",
                             batch=4, squad=(2, 384))
    res = summary["distill"]
    assert res["classify"]["steps"] == res["squad"]["steps"] == 3
    assert res["classify"]["summary"]["projections"] == ["layer_0",
                                                         "layer_1"]
    assert res["classify"]["launches_per_step"]["layer_norm_fwd"] == 10
    assert res["squad"]["launches_per_step"]["flash_attention_fwd"] == 6
    assert res["precomputed_teacher_bit_equal"]
    assert res["packed_vs_single"]["loss_rel_diff"] == 0.0
    assert res["serve"]["served_params"] < res["serve"]["teacher_params"]
    assert set(res["kernels_vs_plain"]) == {"bfloat16", "float32"}
