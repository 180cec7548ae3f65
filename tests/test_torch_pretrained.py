"""The port's --init_checkpoint sources against the JAX package's, on the
CPU at a tiny width (2 layers, E=32, 4 heads, vocab 100 padded to 104):
a Google TF release written through real TF, the reference's torch saves
(`ckpt_*.pt`: the pretraining save with `module.` prefixes, the finetune
save with the tied decoder weight, a bare state_dict), and JAX-package
orbax checkpoints in both encoder layouts, read through tensorstore.

Conversions are exact: every parameter the port reads equals the JAX
package's converted tree, carried through models/convert.params_from_flax
(the one name mapping), bit for bit. A forward of the loaded models is
held at the f32 forward tier of tests/test_torch_convert_model.py (1e-4).

`make_source` and `port_config` also serve
tests/test_torch_finetune.py::test_init_checkpoint_from_another_source_is_read.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)
from flax import traverse_util

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.models import BertForPreTraining as JaxPreTraining  # noqa: E402
from bert_pytorch_tpu.models import BertForQuestionAnswering as JaxQA  # noqa: E402
from bert_pytorch_tpu.models import pretrained as jpre  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.models import pretrained as ppre  # noqa: E402
from bert_pytorch_tpu_torch.models.bert import BertForPreTraining  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from bert_pytorch_tpu_torch.training import finetune as tft  # noqa: E402
from bert_pytorch_tpu_torch.training.checkpoint import (  # noqa: E402
    load_jax_checkpoint)
from tests.test_pretrained import (CFG as JCFG, E, F, H, L, MP, V,  # noqa: E402
                                   make_tf_vars, tf_vars_to_torch_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PADDED = 104                    # V padded to a multiple of 8
FWD_TOL = 1e-4
RELEASE_CFG = dict(vocab_size=V, hidden_size=E, num_hidden_layers=L,
                   num_attention_heads=H, intermediate_size=F,
                   max_position_embeddings=MP, type_vocab_size=2,
                   hidden_act="gelu", hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0, initializer_range=0.02)


def port_config(**over) -> BertConfig:
    return BertConfig.from_dict(dict(dict(RELEASE_CFG, vocab_size=PADDED),
                                     **over))


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _write_release(d, tf_vars):
    """bert_config.json + vocab.txt + bert_model.ckpt.* written through
    real TF, as tests/test_pretrained.py writes its release."""
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    os.makedirs(d, exist_ok=True)
    with tf.Graph().as_default():
        for name, arr in tf_vars.items():
            tf1.Variable(initial_value=arr, name=name)
        saver = tf1.train.Saver()
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, os.path.join(d, "bert_model.ckpt"),
                       write_meta_graph=False)
    with open(os.path.join(d, "bert_config.json"), "w") as f:
        json.dump(RELEASE_CFG, f)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + [f"tok{i}" for i in range(V - 5)]))
    return d


def _write_pt(d, state, kind="pretrain"):
    """A reference torch save of `state` (numpy by torch name): the
    pretraining format (module.-prefixed, with an optimizer entry), the
    finetune format ({'model': ...}, the tied decoder weight included) or
    a bare state_dict; bert_config.json beside it."""
    os.makedirs(d, exist_ok=True)
    sd = {k: torch.tensor(v) for k, v in state.items()}
    if kind == "pretrain":
        blob = {"model": {f"module.{k}": v for k, v in sd.items()},
                "optimizer": {"state": {}}, "epoch": 3}
    elif kind == "finetune":
        sd["cls.predictions.decoder.weight"] = sd[
            "bert.embeddings.word_embeddings.weight"]
        blob = {"model": sd}
    else:
        blob = sd
    path = os.path.join(d, "ckpt_8601.pt")
    torch.save(blob, path)
    with open(os.path.join(d, "bert_config.json"), "w") as f:
        json.dump(RELEASE_CFG, f)
    return path


def _write_orbax(d, stacked: bool, step: int = 3):
    """A JAX BertForPreTraining TrainState (params in `stacked` layout,
    one LayerNorm scale in bf16) saved by the JAX package's
    CheckpointManager; returns the flat params saved."""
    import optax

    from bert_pytorch_tpu.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu.training.state import TrainState

    cfg = JCFG.replace(vocab_size=PADDED, stacked_params=stacked)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = unbox(JaxPreTraining(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(7), ids, ids, jnp.ones((1, 8), jnp.int32))
        ["params"])
    ln = params["bert"]["embeddings"]["layer_norm"]
    ln["scale"] = ln["scale"].astype(jnp.bfloat16)
    tx = optax.adam(1e-3)
    state = TrainState(step=jnp.asarray(step, jnp.int32), params=params,
                       opt_state=tx.init(params))
    mgr = CheckpointManager(d)
    mgr.save(step, state, extra={"sampler": {"index": 0}})
    mgr.wait()
    mgr.close()
    return _flat(params)


def make_source(tmp_path, kind):
    """(--init_checkpoint spec, the flat flax tree JAX reads from it with
    the vocab padded to PADDED) of a tiny source of `kind`: tf_release,
    torch_save or orbax."""
    tf_vars = make_tf_vars()
    if kind == "orbax":
        flat = _write_orbax(str(tmp_path / "orbax"), stacked=True)
        return str(tmp_path / "orbax"), flat
    if kind == "tf_release":
        spec = _write_release(str(tmp_path / "release"), tf_vars)
    else:
        spec = _write_pt(str(tmp_path / "pt"),
                         tf_vars_to_torch_state(tf_vars))
    _, tree = jpre.from_pretrained(spec, vocab_pad_multiple=8)
    return spec, _flat(tree)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    return _write_release(str(tmp_path_factory.mktemp("release")),
                          make_tf_vars())


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("stacked", [True, False])
def test_tf_conversion_matches_jax_in_both_layouts(stacked):
    """convert_tf_to_flax: the flat tree equals the JAX converter's,
    leaf for leaf, in the layout asked for (vocab padded 100 -> 104)."""
    tf_vars = make_tf_vars()
    got = ppre.convert_tf_to_flax(tf_vars, port_config(next_sentence=True),
                                  stacked=stacked)
    want = _flat(jpre.convert_tf_to_flax(
        tf_vars, JCFG.replace(vocab_size=PADDED, stacked_params=stacked)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tf_release_matches_jax_and_runs_forward(release):
    """A release written through real TF: the port's parameters equal
    JAX's from_pretrained tree through params_from_flax exactly, padded
    rows and bias included, and the two models' forwards agree."""
    cfg, flat = ppre.from_pretrained(release, vocab_pad_multiple=8)
    jcfg, tree = jpre.from_pretrained(release, vocab_pad_multiple=8)
    assert cfg.vocab_size == jcfg.vocab_size == PADDED
    assert cfg.vocab_file == os.path.join(release, "vocab.txt")
    sd = params_from_flax(flat)
    _assert_same_state(sd, params_from_flax(_flat(tree)))
    emb = sd["bert.embeddings.word_embeddings.weight"]
    assert torch.equal(emb[V:], torch.zeros(PADDED - V, E))
    assert torch.equal(sd["cls_predictions.bias"][V:],
                       torch.full((PADDED - V,), ppre.PADDED_VOCAB_BIAS))

    model = BertForPreTraining(cfg, dtype=torch.float32)
    model.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, V, (2, 12)).astype(np.int32)
    types = rng.randint(0, 2, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    jmodel = JaxPreTraining(JCFG.replace(vocab_size=PADDED),
                            dtype=jnp.float32)
    jmlm, jnsp = jmodel.apply({"params": tree}, jnp.asarray(ids),
                              jnp.asarray(types), jnp.asarray(mask),
                              deterministic=True)
    with torch.no_grad():
        mlm, nsp = model(torch.from_numpy(ids).long(),
                         token_type_ids=torch.from_numpy(types).long(),
                         attention_mask=torch.from_numpy(mask).long())
    for a, b in ((mlm, jmlm), (nsp, jnsp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=FWD_TOL, rtol=FWD_TOL)
    # a padded row never wins
    assert int(mlm.argmax(-1).max()) < V


def test_release_zip_and_ckpt_prefix_read_the_same(release, tmp_path):
    """The .zip of a release (extracted into a temporary directory that
    is gone after the read) and its bare .ckpt prefix give the tree the
    directory gives."""
    import zipfile

    _, want = ppre.from_pretrained(release)
    z = tmp_path / "uncased_L-2_H-32.zip"
    with zipfile.ZipFile(z, "w") as zf:
        for name in os.listdir(release):
            zf.write(os.path.join(release, name), f"uncased/{name}")
    cfg, got = ppre.from_pretrained(str(z))
    assert cfg.vocab_file is None
    _, prefixed = ppre.from_pretrained(os.path.join(release,
                                                    "bert_model.ckpt"))
    for other in (got, prefixed):
        assert set(other) == set(want)
        for k in want:
            np.testing.assert_array_equal(other[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["pretrain", "finetune", "bare"])
def test_reference_pt_matches_jax(tmp_path, kind):
    """The reference's saves (the pretraining format with `module.` and
    an optimizer, the finetune format with the tied decoder weight, a
    bare state_dict): load_torch_checkpoint and convert_torch_to_flax
    equal JAX's exactly, and so does from_pretrained on the .pt."""
    path = _write_pt(str(tmp_path), tf_vars_to_torch_state(make_tf_vars()),
                     kind)
    got = ppre.load_torch_checkpoint(path)
    want = jpre.load_torch_checkpoint(path)
    assert set(got) == set(want) and not any(k.startswith("module.")
                                             for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    conv = ppre.convert_torch_to_flax(got, port_config(next_sentence=True,
                                                       vocab_size=V))
    jconv = _flat(jpre.convert_torch_to_flax(
        want, JCFG.replace(stacked_params=False)))
    assert set(conv) == set(jconv)
    for k in jconv:
        np.testing.assert_array_equal(conv[k], jconv[k], err_msg=k)
    _, flat = ppre.from_pretrained(path, vocab_pad_multiple=8)
    _, tree = jpre.from_pretrained(path, vocab_pad_multiple=8)
    _assert_same_state(params_from_flax(flat), params_from_flax(_flat(tree)))


@pytest.mark.parametrize("stacked", [True, False])
def test_orbax_checkpoint_matches_jax(tmp_path, stacked):
    """A JAX-package checkpoint (CheckpointManager, either layout) reads
    through tensorstore: every params leaf equals the tree JAX saved,
    bf16 leaves included, and the port's names follow through
    params_from_flax."""
    want = _write_orbax(str(tmp_path / "ck"), stacked)
    got, step = load_jax_checkpoint(str(tmp_path / "ck"))
    assert step == 3 and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["bert/embeddings/layer_norm/scale"].dtype.name == "bfloat16"
    _assert_same_state(params_from_flax(got), params_from_flax(want))
    with pytest.raises(FileNotFoundError, match="no orbax checkpoint step"):
        load_jax_checkpoint(str(tmp_path / "ck") + "@4")


def test_orbax_reader_leaves_jax_out(tmp_path):
    """The reader imports tensorstore, never jax: checked in a fresh
    interpreter."""
    _write_orbax(str(tmp_path / "ck"), stacked=True)
    code = ("import sys\n"
            "from bert_pytorch_tpu_torch.training.checkpoint import "
            "load_jax_checkpoint\n"
            f"flat, step = load_jax_checkpoint({str(tmp_path / 'ck')!r})\n"
            "assert step == 3 and flat\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'orbax', 'bert_pytorch_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _jax_qa_params(stacked=False):
    cfg = JCFG.replace(vocab_size=PADDED, next_sentence=False,
                       stacked_params=stacked)
    ids = jnp.zeros((2, 12), jnp.int32)
    return unbox(JaxQA(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), ids, ids, jnp.ones((2, 12), jnp.int32))
        ["params"])


@pytest.mark.parametrize("kind", ["tf_release", "torch_save", "orbax"])
def test_load_pretrained_params_reports_as_jax(tmp_path, kind):
    """load_pretrained_params into a QA model: the first report line is
    JAX's word for word, the fresh leaves are the same (the QA head), and
    the loaded values equal the tree JAX merged."""
    from bert_pytorch_tpu.training.finetune import \
        load_pretrained_params as jax_load
    from bert_pytorch_tpu_torch.models.bert import BertForQuestionAnswering

    spec, _ = make_source(tmp_path, kind)
    jlines, plines = [], []
    merged = jax_load(spec, _jax_qa_params(), log=jlines.append)
    model = BertForQuestionAnswering(port_config(), dtype=torch.float32)
    params = {k: p.detach() for k, p in model.named_parameters()}
    tft.load_pretrained_params(spec, params, log=plines.append)
    assert plines[0] == jlines[0]
    assert (plines[1].replace(".weight", ".kernel")
            == jlines[1].replace("/", "."))
    want = params_from_flax(_flat(merged))
    for k, p in params.items():
        if not k.startswith("qa_outputs"):
            assert torch.equal(p, want[k]), k


def test_port_checkpoint_at_a_step_and_the_no_match_error(tmp_path):
    """A port checkpoint directory `dir@step` reads that step; a source
    that shares no parameter raises JAX's error."""
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.training.checkpoint import CheckpointManager
    from bert_pytorch_tpu_torch.training.state import make_train_state

    model = BertForPreTraining(port_config(next_sentence=True),
                               dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for step in (2, 5):
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(step)
        mgr.save(step, make_train_state(model, Lamb(1e-3)).state_dict())
    fresh = BertForPreTraining(port_config(next_sentence=True),
                               dtype=torch.float32)
    params = {k: p.detach() for k, p in fresh.named_parameters()}
    lines = []
    tft.load_pretrained_params(str(tmp_path / "ck") + "@2", params,
                               log=lines.append)
    assert lines == [f"init_checkpoint step 2: loaded {len(params)} param "
                     "leaves, 0 fresh-initialized"]
    assert all(bool((p == 2).all()) for p in params.values())
    other = {"classifier.weight": torch.zeros(3, 3)}
    with pytest.raises(ValueError, match="shares no same-shaped parameters"):
        tft.load_pretrained_params(str(tmp_path / "ck"), other,
                                   log=lambda m: None)


@pytest.mark.parametrize("spec", [
    "bert-base-uncased",
    "https://storage.googleapis.com/bert_models/2018_10_18/x.zip"])
def test_a_source_that_needs_the_network_is_refused(spec):
    params = {"bert.embeddings.word_embeddings.weight": torch.zeros(8, 4)}
    with pytest.raises(NotImplementedError,
                       match="registry name or a URL"):
        tft.load_pretrained_params(spec, params, log=lambda m: None)


def test_chip_smoke_init_sources_phase_rehearses_on_cpu(tmp_path,
                                                        monkeypatch):
    """chip_smoke.py's init_sources phase at a tiny width on the CPU: the
    reference-named ckpt_1.pt (the port -> reference renaming) seeds
    every bert.* parameter bit for bit, run_squad from it and from a port
    checkpoint of the same weights start from the same loss, and, with
    tensorflow and tensorstore made unimportable, a TF release and an
    orbax directory raise the ImportError naming each."""
    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(RELEASE_CFG, vocab_size=30522,
                                   max_position_embeddings=512)))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    summary = {}
    chip_smoke.phase_init_sources(torch, np, summary, device="cpu",
                                  cfg_path=str(cfg), batch=4)
    res = summary["init_sources"]
    assert res["first_loss_from_port"] == res["losses"][0]
    assert res["bit_equal_params"] == 4 + 12 * L
    assert [m["package"] for m in res["missing_packages"]] == [
        "tensorflow", "tensorstore"]
    assert not any(m["installed"] for m in res["missing_packages"])
