"""The port's model axis (tensor parallelism over the heads, the MLP and
the vocabulary: bert_pytorch_tpu_torch/parallel/tensor.py, rules.py)
against the JAX package on the CPU: every dropout site's mask on rank
(d, f, m) equal to JAX's shard of its one-process mesh (the Pallas
kernels in interpret mode on the 8-device CPU mesh); the
vocabulary-split MLM loss, its gradient and the accuracy against JAX's,
an argmax tie across the split included; 2-rank model=2 and 4-rank
data=2,model=2 runs against JAX's one-process step (3 steps, dropout
on); remat "nothing" at model=2 bit-equal to no remat;
run_pretraining.main on 2 gloo ranks with --mesh model=2 (both ranks
read JAX's one-shard sample ids), its checkpoint in the one-card layout,
restored at 1 rank and at fsdp=2 with the parameters bit-equal;
convert.shard_state_dict against JAX's model shards of its leaves.

The ranks are processes of tests/torch_ranks.py joined by a FileStore
under tmp_path (no port is taken)."""

import hashlib
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_fsdp as tf  # noqa: E402
import test_torch_pretrain as tp  # noqa: E402
import torch_ranks  # noqa: E402
from bert_pytorch_tpu.parallel import mesh as jax_mesh  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import (  # noqa: E402
    params_from_flax, shard_state_dict)
from bert_pytorch_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 0.1


# -- dropout masks, shard by shard ---------------------------------------------


@pytest.mark.parametrize("spec", ["data=2,model=2", "fsdp=2,model=2"])
def test_dropout_masks_equal_jax_shards(spec, monkeypatch):
    """On rank (d, f, m) the port draws, at each pretraining dropout site,
    exactly JAX's shard of what its one-process mesh draws from the same
    site seed: the embeddings' global-view hash_dropout (the data shard's
    rows, the same on every model peer), plain attention's (the data
    shard's rows of the rank's heads: per (row, head) block starts), the
    fused residual-dropout-LayerNorm (JAX's sharded kernel: the seed plus
    (d F + f) x 0x3C6EF35F, no model term) and the flash kernel at its
    gate's smallest sequence, 384 (the seed XOR ((d F + f) M + m) x
    0x9E3779B9, read off JAX's sharded call, on the rank's heads)."""
    import bert_pytorch_tpu.ops.attention as jax_att
    import bert_pytorch_tpu.ops.layernorm as jax_ln
    from jax.sharding import NamedSharding, PartitionSpec as P

    jfa = importlib.import_module(
        "bert_pytorch_tpu.ops.pallas.flash_attention")

    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import (
        BertEmbeddings, ResidualDropoutLayerNorm)
    from bert_pytorch_tpu_torch.ops import attention as patt

    monkeypatch.setenv("BPT_PALLAS_INTERPRET", "1")
    shape = port_mesh.parse_mesh_arg(spec)
    n = 4
    mesh = jax_mesh.make_mesh(shape, jax.devices()[:n])
    pm = port_mesh.make_mesh(shape, n)
    shards = port_mesh.data_shard_count(pm)
    batch_axes = ("data", "fsdp")
    seed = -1234567891
    b, s, e, h = 2 * shards, 16, 128, 4
    bl, hl = b // shards, h // pm.model

    def rows(x, rank):
        ds = pm.data_shard_index(rank)
        return np.asarray(x)[ds * bl:(ds + 1) * bl]

    # the embeddings: global-view hash_dropout of (B, S, E)
    x = jax.device_put(jnp.ones((b, s, e), jnp.float32),
                       NamedSharding(mesh, P(batch_axes)))
    want = jax.jit(lambda t: jax_att.hash_dropout(t, seed, RATE))(x)
    emb = BertEmbeddings(BertConfig.from_dict(dict(tp.CFG, hidden_size=e)))
    with torch.no_grad():
        emb.layer_norm.scale.zero_()
        emb.layer_norm.bias.fill_(1.0)
    ids = torch.zeros((bl, s), dtype=torch.long)
    for rank in range(n):
        emb.dropout_shard = pm.data_shard_index(rank)
        with torch.no_grad():
            got = emb(ids, None, None, torch.float32, seed)
        np.testing.assert_array_equal(got.numpy() != 0, rows(want, rank) != 0)

    # plain attention (seq <= 256): global-view hash_dropout of (B,H,S,S),
    # batch over (data, fsdp), heads over model
    probs = jax.device_put(jnp.full((b, h, s, s), 1.0 / s, jnp.float32),
                           NamedSharding(mesh, P(batch_axes, "model")))
    want = jax.jit(lambda t: jax_att.hash_dropout(t, seed, RATE))(probs)
    q = torch.zeros((bl, s, hl, s))
    v = torch.eye(s)[None, :, None, :].expand(bl, s, hl, s)
    for rank in range(n):
        m = pm.coords(rank)["model"]
        got = patt.dot_product_attention(
            q, q, v, dropout_seed=seed, dropout_rate=RATE,
            dropout_shard=pm.data_shard_index(rank), head0=m * hl, heads=h)
        w = rows(want, rank)[:, m * hl:(m + 1) * hl]
        # out[b, q, h, k] is the dropped probability of key k
        np.testing.assert_array_equal(
            got.permute(0, 2, 1, 3).numpy() != 0, w != 0)

    # the fused residual-dropout-LayerNorm: JAX's sharded Pallas kernel
    sharding = NamedSharding(mesh, P(batch_axes))
    xs = jax.device_put(jnp.ones((b, s, e), jnp.float32), sharding)
    zs = jax.device_put(jnp.zeros((b, s, e), jnp.float32), sharding)
    out = jax_ln._adln_sharded(mesh, xs, zs, jnp.ones((e,)),
                               jnp.zeros((e,)), seed, RATE, 1e-12, True)
    assert out is not None
    tail = ResidualDropoutLayerNorm(e, RATE)
    for rank in range(n):
        tail.dropout_shard = pm.data_shard_index(rank)
        with torch.no_grad():
            got = tail(torch.ones((bl, s, e)), torch.zeros((bl, s, e)), seed)
        np.testing.assert_array_equal(got.numpy() > 0, rows(out, rank) > 0)

    # the flash kernels: the seed each shard's kernel gets, and its mask
    seen = {}
    real = jfa.flash_attention

    def record(q, k, v, bias=None, segment_ids=None, dropout_seed=None,
               dropout_rate=0.0, interpret=False):
        jax.debug.callback(
            lambda d, f, m, sd: seen.__setitem__((int(d), int(f), int(m)),
                                                 int(sd)),
            jax.lax.axis_index("data"), jax.lax.axis_index("fsdp"),
            jax.lax.axis_index("model"), dropout_seed)
        return real(q, k, v, bias, segment_ids, dropout_seed, dropout_rate,
                    interpret)

    monkeypatch.setattr(jfa, "flash_attention", record)
    sq, d = 256 + 128, 64
    qf = jnp.zeros((shards, sq, h, d), jnp.float32)
    jax_att._flash_sharded(mesh, qf, qf, qf, None, None, seed, RATE, True)
    assert len(seen) == n
    for rank in range(n):
        c = pm.coords(rank)
        got_seed = patt.flash_shard_seed(seed, pm.flat_shard_index(rank))
        assert seen[(c["data"], c["fsdp"], c["model"])] == got_seed
        want = np.stack([np.asarray(jfa._keep_mask(got_seed & 0xFFFFFFFF,
                                                   bh, 0, 0, sq, sq, RATE))
                         for bh in range(hl)])
        got = patt.flash_keep_all(got_seed, 1, hl, sq, RATE)[0]
        np.testing.assert_array_equal(got.numpy(), want)


# -- the vocabulary-split loss and accuracy ------------------------------------


def test_vocab_split_loss_and_accuracy_match_jax(tmp_path):
    """The MLM cross-entropy terms, their gradient and the accuracy with
    the vocabulary split over 2 model ranks against JAX's
    cross_entropy_terms, its gradient and mlm_accuracy on the whole
    logits; rows tie their maximum across the split (jnp.argmax takes the
    lowest index: the left rank's), one labelled with the left class, one
    with the right, one ignored."""
    from bert_pytorch_tpu.models import losses as jax_losses

    rng = np.random.RandomState(3)
    n, v = 12, 64
    logits = rng.randn(n, v).astype(np.float32) * 3
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[[2, 7]] = -1
    for r, lab in ((0, v // 2 - 1), (1, v // 2), (2, v // 2 - 1)):
        logits[r, v // 2 - 1] = logits[r, v // 2] = logits[r].max() + 1.0
        labels[r] = lab if r != 2 else -1
    labels[3] = int(np.argmax(logits[3]))
    np.savez(tmp_path / "inputs.npz", logits=logits, labels=labels)
    ranks = torch_ranks.run({"kind": "vocab",
                             "inputs": str(tmp_path / "inputs.npz")}, 2,
                            tmp_path / "ranks")

    def total(lg):
        return jax_losses.cross_entropy_terms(lg, jnp.asarray(labels))[0]

    want = float(total(jnp.asarray(logits)))
    grad = np.asarray(jax.grad(total)(jnp.asarray(logits)))
    correct, masked = jax_losses.mlm_accuracy(jnp.asarray(logits),
                                              jnp.asarray(labels))
    for r in ranks:
        np.testing.assert_allclose(r["total"], want, rtol=1e-6)
        assert r["count"] == int(masked) == n - 2
        assert (r["correct"], r["masked"]) == (int(correct), int(masked))
    assert int(correct) >= 2
    got = np.concatenate([np.load(tmp_path / "ranks" / f"grad{r}.npy")
                          for r in range(2)], axis=-1)
    np.testing.assert_allclose(got, grad, rtol=1e-5, atol=1e-7)


# -- runs against JAX's one-process mesh ----------------------------------------


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_model2")
    job, metrics, final = tf.jax_mesh_reference(root, {"model": 2}, 2)
    arms = [{"mesh": "model=2"}, {"mesh": "model=2", "remat": "nothing"}]
    ranks = torch_ranks.run(dict(job, arms=arms), 2, root / "ranks")
    return {"ranks": ranks, "metrics": metrics, "final": final,
            "root": root / "ranks"}


def test_two_ranks_model2_match_jax_model2_step(model2):
    """model=2 on 2 gloo ranks against JAX's one-process model=2 step:
    the losses within 1e-5 relative, the parameters together within 2e-5
    relative L2 at f32; the model group carried the activations."""
    tf.assert_against_jax(model2["ranks"], 0, model2["metrics"],
                          model2["final"], model2["root"])
    c = model2["ranks"][0][0]["collectives"]
    assert c["model"]["bytes"] > 0
    assert model2["ranks"][0][0]["describe"]["slice_ranks"] == 1


def test_remat_nothing_at_model2_bit_equal_to_no_remat(model2):
    """--checkpoint_activations with policy "nothing" at model=2: the
    recompute runs the forward's model-group all-reduces again, in the
    same order on both peers, and draws the same masks: loss, grad norm
    and every parameter bit-equal to the run without remat."""
    tf.assert_bit_equal(model2["root"], model2["ranks"], 0, 1)


@pytest.fixture(scope="module")
def data2_model2(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_data2_model2")
    job, metrics, final = tf.jax_mesh_reference(root, {"data": 2,
                                                       "model": 2}, 4)
    arms = [{"mesh": "data=2,model=2"},
            {"mesh": "data=2,model=2", "zero1": True,
             "zero1_overlap": True}]
    ranks = torch_ranks.run(dict(job, arms=arms), 4, root / "ranks")
    return {"ranks": ranks, "metrics": metrics, "final": final,
            "root": root / "ranks"}


@pytest.mark.parametrize("arm", [0, 1])
def test_four_ranks_data2_model2_match_jax(data2_model2, arm):
    """data=2,model=2 on 4 ranks, without ZeRO-1 and with it (over each
    model coordinate's data group), against JAX's data=2,model=2 step."""
    tf.assert_against_jax(data2_model2["ranks"], arm,
                          data2_model2["metrics"], data2_model2["final"],
                          data2_model2["root"])


# -- the entry point, its data and its checkpoints -------------------------------


def _argv(data, cfg, out, steps, *extra):
    return ["--config_file",
            os.path.join(REPO, "configs", "bert_pretraining_phase1_config.json"),
            "--model_config_file", str(cfg), "--input_dir", str(data),
            "--output_dir", str(out), "--local_batch_size", "2",
            "--global_batch_size", "4", "--steps", str(steps),
            "--num_steps_per_checkpoint", "2", "--device", "cpu",
            "--tensorboard", "off", "--flight_recorder", "off",
            "--learning_rate", "1e-2", *extra]


def _sha(params):
    digest = hashlib.sha256()
    for k in sorted(params):
        digest.update(params[k].detach().contiguous().numpy().tobytes())
    return digest.hexdigest()


def test_main_model2_reads_one_shard_and_its_checkpoint_moves(tmp_path):
    """run_pretraining.main on 2 gloo ranks with --mesh model=2: both
    ranks read the same sample ids, JAX's HostShardSampler at one shard,
    and log the same losses; rank 0's fold counts the shard's throughput
    once; the step-2 checkpoint holds the one-card
    layout; one rank restores it with the parameters bit-equal to the
    2-rank run's, and so do 2 ranks at fsdp=2."""
    from bert_pytorch_tpu.data.sharded import HostShardSampler as JaxSampler

    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining

    data = tp._write_shards(tmp_path / "data")
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(tp.CFG))
    out = tmp_path / "out"
    r0, r1 = torch_ranks.run(
        {"kind": "main", "runs": [_argv(data, cfg, out, 2, "--mesh",
                                        "model=2", "--log_freq", "1")]}, 2,
        tmp_path / "ranks")
    first = r0[0]
    assert first["step"] == 2 and first["saves"] == [2]
    assert first["parallel"]["mesh"]["model"] == 2
    drawn = first["indices"]
    assert drawn == r1[0]["indices"] and len(drawn) >= 8
    sampler = JaxSampler(48, world_size=1, rank=0, seed=42)
    assert drawn == [int(i) for _ in range(len(drawn) // 4)
                     for i in sampler.next_indices(4)]
    assert [h["loss"] for h in first["history"]] == \
        [h["loss"] for h in r1[0]["history"]]
    assert first["params_sha256"] == r1[0]["params_sha256"]
    # the fold counts the one data shard's throughput once
    perf = [json.loads(ln) for ln in
            (out / "phase1_log.jsonl").read_text().splitlines()]
    perf = [p for p in perf if p.get("tag") == "perf"
            and "seq_per_sec_global" in p]
    assert perf and all(p["data_shards_reporting"] == 1 for p in perf)
    assert any(p["seq_per_sec_global"] == p["seq_per_sec"] for p in perf)
    saved = torch.load(out / "pretrain_ckpts" / "2" / "state.pt",
                       weights_only=True)
    one = BertForPreTraining(BertConfig.from_dict(tp.CFG))
    assert {k: tuple(v.shape) for k, v in saved["params"].items()} == \
        {k: tuple(v.shape) for k, v in one.state_dict().items()}
    assert _sha(saved["params"]) == first["params_sha256"]
    # one rank restores the model=2 checkpoint
    got = run_pretraining.main(_argv(data, cfg, out, 0), log=lambda m: None)
    assert got.resumed_from == 2 and got.state.step == 2
    assert _sha(got.state.params) == first["params_sha256"]
    for what in ("mu", "nu"):
        for k, v in saved["opt_state"][what].items():
            assert torch.equal(getattr(got.state.opt_state, what)[k], v), k
    # 2 ranks at fsdp=2 restore it too
    f0, f1 = torch_ranks.run(
        {"kind": "main", "runs": [_argv(data, cfg, out, 0, "--mesh",
                                        "fsdp=2")]}, 2,
        tmp_path / "ranks_fsdp")
    assert f0[0]["resumed_from"] == 2 and f1[0]["resumed_from"] == 2
    assert f0[0]["params_sha256"] == f1[0]["params_sha256"] == \
        first["params_sha256"]


# -- weights carried across -----------------------------------------------------


def test_shard_state_dict_against_jax_model_shards():
    """JAX's params placed by its rules table on a model=2 mesh: each
    model coordinate's shard of every leaf, converted, is what
    shard_state_dict cuts out of the converted whole tree for that rank
    (the QKV kernel's heads of each of q, k, v; the attention output's
    and the MLP's rows and columns; the vocabulary rows)."""
    from jax.sharding import NamedSharding

    model = tp._jax_model()
    z = jnp.zeros((1, tp.S), jnp.int32)
    boxed = model.init(jax.random.PRNGKey(0), z, z, z)["params"]
    mesh = jax_mesh.make_mesh({"model": 2}, jax.devices()[:2])
    shardings = jax_mesh.param_shardings(mesh, boxed)
    from bert_pytorch_tpu.training.state import unbox

    params = unbox(boxed)
    placed = jax.tree.map(lambda p, sh: jax.device_put(p, sh), params,
                          shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    whole = params_from_flax(tp._flat(params))
    pm = port_mesh.make_mesh({"model": 2}, 2)
    flat = tp._flat(placed)
    split = 0
    for m in range(2):
        dev = mesh.devices[0, 0, m, 0]
        local = {}
        from flax import traverse_util

        for path, leaf in traverse_util.flatten_dict(placed, sep="/").items():
            shard = [sh for sh in leaf.addressable_shards
                     if sh.device == dev][0]
            local[path] = np.asarray(shard.data)
        want = params_from_flax(local)
        got = shard_state_dict(whole, pm, pm.rank_of({"model": m}))
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert torch.equal(got[k], w), k
            split += got[k].shape != whole[k].shape
    assert set(flat) and split >= 2 * (2 + 5 * tp.CFG["num_hidden_layers"])



def _port_name(path: str) -> str:
    """A flax leaf path of the unstacked pretraining tree -> the port's
    parameter name."""
    out = []
    for p in path.split("/"):
        if p.startswith("layer_") and p[6:].isdigit():
            out += ["layers", p[6:]]
        else:
            out.append("weight" if p in ("kernel", "embedding") else p)
    return ".".join(out)


def _port_spec(path: str, spec, ndim: int) -> tuple:
    """A flax leaf's PartitionSpec in the port's layout: entries None or
    tuples of axis names, a Linear's kernel transposed, the QKV kernel's
    (3, H, D) features and the output kernel's (H, D) inputs one
    dimension. `ndim`: the leaf's rank (a PartitionSpec drops trailing
    Nones)."""
    e = tuple(None if x is None else (x,) if isinstance(x, str) else
              tuple(x) for x in spec)
    e = e + (None,) * (ndim - len(e))

    def merged(entries):
        return tuple(a for x in entries if x for a in x) or None

    if path.endswith("qkv/kernel"):
        return (merged(e[1:]), e[0])
    if path.endswith("qkv/bias"):
        return (merged(e),)
    if path.endswith("attention/output/kernel"):
        return (e[2], merged(e[:2]))
    if path.endswith("/kernel"):
        return tuple(reversed(e))
    return e or (None,)


def test_rules_table_is_jax_in_the_ports_layout():
    """parallel/rules.spec of every pretraining parameter is JAX's rules
    table resolved on an fsdp=2,model=2 mesh, in the port's layout, and
    its strip_axis_spec (the use layout) JAX's strip_axis_spec."""
    from bert_pytorch_tpu.parallel import rules as jax_rules
    from flax import traverse_util

    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import BertForPreTraining
    from bert_pytorch_tpu_torch.parallel import rules

    model = tp._jax_model()
    z = jnp.zeros((1, tp.S), jnp.int32)
    boxed = model.init(jax.random.PRNGKey(0), z, z, z)["params"]
    mesh = jax_mesh.make_mesh({"fsdp": 2, "model": 2}, jax.devices()[:4])
    shardings = traverse_util.flatten_dict(
        jax_mesh.param_shardings(mesh, boxed), sep="/")
    names = {n for n, _ in BertForPreTraining(
        BertConfig.from_dict(tp.CFG)).named_parameters()}
    seen = set()
    for path, sh in shardings.items():
        name = _port_name(path)
        ndim = len(sh.spec)
        want = _port_spec(path, sh.spec, ndim)
        got = rules.spec(name, len(want))
        assert got == want, (name, got, want)
        assert rules.strip_axis_spec(got) == _port_spec(
            path, jax_rules.strip_axis_spec(sh.spec), ndim), name
        seen.add(name)
    assert seen == names
