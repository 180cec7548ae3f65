"""The port's data axis (bert_pytorch_tpu_torch/parallel/) against the
JAX package on the CPU: --mesh parsed and refused as JAX parses it, the
mesh_config resolution, every dropout site's mask on rank r equal to
shard r of JAX's data=N mask (the Pallas kernels in interpret mode on the
8-device CPU mesh), a 2-rank gloo run of the port against JAX's one-
process data=2 step (3 steps, accumulation 2, dropout on, ZeRO-1 off and
on), the per-rank metrics fold against JAX's HostMetricsAggregator, and
run_pretraining.main on 2 gloo ranks (its ranks' sample ids JAX's
HostShardSampler split; it saves and resumes).

The ranks are processes of tests/torch_ranks.py joined by a FileStore
under tmp_path (no port is taken)."""

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

import test_torch_pretrain as tp  # noqa: E402
import torch_ranks  # noqa: E402
from bert_pytorch_tpu.parallel import mesh as jax_mesh  # noqa: E402
from bert_pytorch_tpu.training.state import unbox  # noqa: E402
from bert_pytorch_tpu_torch import PARALLEL_GAPS  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from bert_pytorch_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 0.1


# -- --mesh and --mesh_config -------------------------------------------------


@pytest.mark.parametrize("spec,n", [("", 1), ("", 4), ("data=2", 2),
                                    ("data=8", 8), ("data=2,fsdp=1", 2),
                                    (" data = 4 , seq=1", 4), ("fsdp=1", 8),
                                    ("model=1,data=8", 8)])
def test_mesh_strings_parse_and_size_as_jax(spec, n):
    """parse_mesh_arg gives JAX's dict, and the mesh over n ranks has the
    shape JAX's make_mesh gives over n CPU devices."""
    import run_pretraining as jax_entry

    assert port_mesh.parse_mesh_arg(spec) == jax_entry.parse_mesh_arg(spec)
    shape = port_mesh.parse_mesh_arg(spec)
    jm = jax_mesh.make_mesh(shape, jax.devices()[:n])
    got = port_mesh.make_mesh(shape, n)
    assert got.shape == dict(jm.shape)
    assert port_mesh.data_shard_count(got) == jax_mesh.data_shard_count(jm)


@pytest.mark.parametrize("spec", ["data=3", "data=4,fsdp=1"])
def test_mesh_of_another_size_is_an_error_as_in_jax(spec):
    shape = port_mesh.parse_mesh_arg(spec)
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(shape)
    with pytest.raises(ValueError):
        port_mesh.make_mesh(shape, 8)


@pytest.mark.parametrize("argv", [["--mesh", "data=4,fsdp=2"],
                                  ["--mesh", "model=2"],
                                  ["--mesh", "data=2,seq=4"],
                                  ["--fsdp_overlap"]])
def test_parallel_refusals_hold_against_jax_parser(argv):
    """JAX's parser takes these command lines (and builds their mesh).
    The port builds the fsdp and model meshes JAX builds over 8 ranks and
    passes their command lines; --fsdp_overlap on one rank runs with
    JAX's WARNING note; the seq axis stays refused, naming
    PARALLEL_GAPS."""
    import run_pretraining as jax_entry

    jargs = jax_entry.parse_arguments(argv)
    args = run_pretraining.parse_arguments(argv)
    if "--mesh" in argv:
        shape = jax_entry.parse_mesh_arg(jargs.mesh)
        jm = jax_mesh.make_mesh(shape)
        if shape.get("seq", 1) > 1:
            with pytest.raises(NotImplementedError, match=PARALLEL_GAPS):
                port_mesh.make_mesh(port_mesh.parse_mesh_arg(jargs.mesh), 8)
            with pytest.raises(NotImplementedError,
                               match=f"mesh=.*{PARALLEL_GAPS}"):
                run_pretraining._unsupported(args)
            return
        got = port_mesh.make_mesh(port_mesh.parse_mesh_arg(jargs.mesh), 8)
        assert got.shape == dict(jm.shape)
        run_pretraining._unsupported(args)
        return
    run_pretraining._unsupported(args)
    par = run_pretraining._parallel_plan(args, torch.device("cpu"))
    assert not par.fsdp_overlap
    assert any("WARNING: --fsdp_overlap ignored" in n for n in par.notes)


def test_kfac_over_ranks_is_refused():
    args = run_pretraining.parse_arguments(["--kfac", "--zero1", "true"])
    with pytest.raises(NotImplementedError, match=PARALLEL_GAPS):
        run_pretraining._parallel_plan(args, torch.device("cpu"))


@pytest.mark.parametrize("data", [1, 2, 4])
def test_mesh_config_resolves_as_jax(data):
    """production's features, the mesh-config name and auto's choice
    against JAX's parallel/rules for the same mesh shape."""
    from bert_pytorch_tpu.parallel import rules as jax_rules

    jm = jax_mesh.make_mesh({"data": data}, jax.devices()[:data])
    pm = port_mesh.make_mesh({"data": data}, data)
    assert port_mesh.production_features(pm) == \
        jax_rules.production_features(jm)
    assert port_mesh.production_qualifies(pm) == \
        jax_rules.production_qualifies(jm)
    assert port_mesh.mesh_config(pm) == jax_rules.mesh_config(jm)
    # an explicit production config at world 1 on the CPU: packing on,
    # --zero1 auto stays off there (a data axis of 1)
    args = run_pretraining.parse_arguments(["--mesh_config", "production"])
    par = run_pretraining._parallel_plan(args, torch.device("cpu"))
    assert args.packing and not par.zero1
    assert par.mesh_config == "production"
    # auto on the CPU keeps the base config (JAX's forced-CPU rule)
    args = run_pretraining.parse_arguments([])
    par = run_pretraining._parallel_plan(args, torch.device("cpu"))
    assert not args.packing and par.mesh_config == "replicated"


# -- dropout masks, shard by shard ---------------------------------------------


def _shards(x, n):
    return np.split(np.asarray(x), n, axis=0)


@pytest.mark.parametrize("n", [2, 4])
def test_dropout_masks_equal_jax_shards(n, monkeypatch):
    """On rank r of n the port draws, at each pretraining dropout site,
    exactly shard r of what JAX's one-process data=n mesh draws from the
    same site seed: the embeddings' and plain attention's global-view
    hash_dropout (rows of the global batch), the fused
    residual-dropout-LayerNorm (JAX's sharded Pallas kernel in interpret
    mode: the seed plus r x 0x3C6EF35F) and the flash kernel (the seed
    XOR r x 0x9E3779B9, read off JAX's sharded call)."""
    import importlib

    import bert_pytorch_tpu.ops.attention as jax_att
    import bert_pytorch_tpu.ops.layernorm as jax_ln
    from jax.sharding import NamedSharding, PartitionSpec as P

    # the module (its package re-exports the function under this name)
    jfa = importlib.import_module(
        "bert_pytorch_tpu.ops.pallas.flash_attention")

    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import (
        BertEmbeddings, ResidualDropoutLayerNorm)
    from bert_pytorch_tpu_torch.ops import attention as patt

    monkeypatch.setenv("BPT_PALLAS_INTERPRET", "1")
    mesh = jax_mesh.make_mesh({"data": n}, jax.devices()[:n])
    rows_sharding = NamedSharding(mesh, P("data"))
    seed = -1234567891
    b, s, e, h = 2 * n, 16, 128, 2

    # the embeddings: global-view hash_dropout of (B, S, E)
    x = jax.device_put(jnp.ones((b, s, e), jnp.float32), rows_sharding)
    want = jax.jit(lambda t: jax_att.hash_dropout(t, seed, RATE))(x)
    cfg = BertConfig.from_dict(dict(tp.CFG, hidden_size=e))
    emb = BertEmbeddings(cfg)
    with torch.no_grad():
        emb.layer_norm.scale.zero_()
        emb.layer_norm.bias.fill_(1.0)
    ids = torch.zeros((b // n, s), dtype=torch.long)
    for r, w in enumerate(_shards(want, n)):
        emb.dropout_shard = r
        with torch.no_grad():
            got = emb(ids, None, None, torch.float32, seed)
        np.testing.assert_array_equal(got.numpy() != 0, w != 0)

    # plain attention (seq <= 256): global-view hash_dropout of (B,H,S,S)
    probs = jax.device_put(jnp.full((b, h, s, s), 1.0 / s, jnp.float32),
                           rows_sharding)
    want = jax.jit(lambda t: jax_att.hash_dropout(t, seed, RATE))(probs)
    q = torch.zeros((b // n, s, h, s))
    v = torch.eye(s)[None, :, None, :].expand(b // n, s, h, s)
    for r, w in enumerate(_shards(want, n)):
        got = patt.dot_product_attention(q, q, v, dropout_seed=seed,
                                         dropout_rate=RATE, dropout_shard=r)
        # out[b, q, h, k] is the dropped probability of key k
        np.testing.assert_array_equal(
            got.permute(0, 2, 1, 3).numpy() != 0, w != 0)

    # the fused residual-dropout-LayerNorm: JAX's sharded Pallas kernel
    xs = jax.device_put(jnp.ones((b, s, e), jnp.float32), rows_sharding)
    zs = jax.device_put(jnp.zeros((b, s, e), jnp.float32), rows_sharding)
    out = jax_ln._adln_sharded(mesh, xs, zs, jnp.ones((e,)), jnp.zeros((e,)),
                               seed, RATE, 1e-12, True)
    assert out is not None
    tail = ResidualDropoutLayerNorm(e, RATE)
    for r, w in enumerate(_shards(out, n)):
        tail.dropout_shard = r
        with torch.no_grad():
            got = tail(torch.ones((b // n, s, e)), torch.zeros((b // n, s, e)),
                       seed)
        # kept units come out above the row's mean, dropped ones below
        np.testing.assert_array_equal(got.numpy() > 0, w > 0)
        assert (got.numpy() > 0).any() and (got.numpy() < 0).any()

    # the flash kernels: the seed each shard's kernel gets, and its mask
    seen = {}
    real = jfa.flash_attention

    def record(q, k, v, bias=None, segment_ids=None, dropout_seed=None,
               dropout_rate=0.0, interpret=False):
        jax.debug.callback(lambda i, sd: seen.__setitem__(int(i), int(sd)),
                           jax.lax.axis_index("data"), dropout_seed)
        return real(q, k, v, bias, segment_ids, dropout_seed, dropout_rate,
                    interpret)

    monkeypatch.setattr(jfa, "flash_attention", record)
    sq, d, heads = 256 + 128, 64, 1
    qf = jax.device_put(jnp.zeros((n, sq, heads, d), jnp.float32),
                        rows_sharding)
    jax_att._flash_sharded(mesh, qf, qf, qf, None, None, seed, RATE, True)
    assert sorted(seen) == list(range(n))
    for r in range(n):
        assert seen[r] == patt.flash_shard_seed(seed, r)
        want = np.stack([np.asarray(jfa._keep_mask(seen[r] & 0xFFFFFFFF, bh,
                                                   0, 0, sq, sq, RATE))
                         for bh in range(heads)])
        got = patt.flash_keep_all(patt.flash_shard_seed(seed, r), 1, heads,
                                  sq, RATE)[0]
        np.testing.assert_array_equal(got.numpy(), want)


# -- two ranks against JAX's data=2 step ----------------------------------------

N_STEPS, ACCUM, WORLD = 3, 2, 2
ROWS = 4                      # a microbatch's global rows


def _record_seeds(model, params, rng):
    """The seeds JAX's model draws from `rng`, in the port's site order
    (an eager forward; they depend on the rng alone)."""
    import bert_pytorch_tpu.models.bert as jax_bert
    import bert_pytorch_tpu.ops.attention as jax_att

    seeds = []
    adln, hdrop = jax_bert.add_dropout_layer_norm, jax_att.hash_dropout

    def rec_adln(x, residual, scale, bias, seed, *a, **k):
        seeds.append(int(seed))
        return adln(x, residual, scale, bias, seed, *a, **k)

    def rec_hdrop(x, seed, rate):
        seeds.append(int(seed))
        return hdrop(x, seed, rate)

    jax_bert.add_dropout_layer_norm, jax_att.hash_dropout = rec_adln, \
        rec_hdrop
    try:
        z = jnp.zeros((1, tp.S), jnp.int32)
        model.apply({"params": params}, z, z, z + 1, deterministic=False,
                    rngs={"dropout": rng})
    finally:
        jax_bert.add_dropout_layer_norm, jax_att.hash_dropout = adln, hdrop
    return seeds


@pytest.fixture(scope="module")
def jax_data2(tmp_path_factory):
    """JAX's jitted data=2 step (Pallas in interpret mode, the model's
    sharded kernels on), 3 steps at accumulation 2 with dropout on, and
    the inputs written for the ranks: the initial params, the batches
    and the seeds JAX drew."""
    from bert_pytorch_tpu.optim import schedulers as jsched
    from bert_pytorch_tpu.training import pretrain as jpre
    from bert_pytorch_tpu.training.state import TrainState

    root = tmp_path_factory.mktemp("jax_data2")
    model = tp._jax_model()
    z = jnp.zeros((1, tp.S), jnp.int32)
    params = unbox(model.init(jax.random.PRNGKey(0), z, z, z)["params"])
    np.savez(root / "params.npz", **{
        k: v.numpy() for k, v in params_from_flax(tp._flat(params)).items()})
    seeds, batches = [], {}
    for i in range(N_STEPS):
        rngs = jax.random.split(jax.random.PRNGKey(100 + i), ACCUM)
        seeds.append([_record_seeds(model, params, r) for r in rngs])
        micro = [tp._batch(10 * i + j + 1, rows=ROWS) for j in range(ACCUM)]
        for k in micro[0]:
            batches[f"{i}/{k}"] = np.stack([m[k] for m in micro])
    np.save(root / "seeds.npy", np.asarray(seeds, np.int32))
    np.savez(root / "batches.npz", **batches)

    sched = jsched.poly_warmup_schedule(1e-2, total_steps=10, warmup=0.2)
    tx = tp._jax_lamb(sched)
    mesh = jax_mesh.make_mesh({"data": WORLD}, jax.devices()[:WORLD])
    old = os.environ.get("BPT_PALLAS_INTERPRET")
    os.environ["BPT_PALLAS_INTERPRET"] = "1"
    metrics = []
    try:
        with mesh, jax_mesh.logical_rules():
            step = jax.jit(jpre.build_pretrain_step(
                model, tx, schedule=sched, accum_steps=ACCUM,
                max_predictions=tp.P))
            state = TrainState(step=jnp.zeros([], jnp.int32), params=params,
                               opt_state=tx.init(params))
            for i in range(N_STEPS):
                batch = jax_mesh.host_to_device_batch(mesh, {
                    k.split("/", 1)[1]: v for k, v in batches.items()
                    if k.startswith(f"{i}/")}, stacked=True)
                state, m = step(state, batch, jax.random.PRNGKey(100 + i))
                metrics.append({k: float(m[k]) for k in
                                ("loss", "grad_norm", "learning_rate")})
    finally:
        if old is None:
            os.environ.pop("BPT_PALLAS_INTERPRET", None)
        else:
            os.environ["BPT_PALLAS_INTERPRET"] = old
    job = {"kind": "steps", "config": tp.CFG,
           "params": str(root / "params.npz"),
           "batches": str(root / "batches.npz"),
           "seeds": str(root / "seeds.npy"), "n_steps": N_STEPS,
           "accum": ACCUM, "lr": 1e-2, "total_steps": 10, "warmup": 0.2,
           "max_predictions": tp.P, "health": True,
           "arms": [{}, {"zero1": True}]}
    ranks = torch_ranks.run(job, WORLD, root / "ranks")
    return {"metrics": metrics, "final": params_from_flax(
        tp._flat(state.params)), "ranks": ranks, "root": root}


@pytest.mark.parametrize("arm,zero1", [(0, False), (1, True)])
def test_two_ranks_match_jax_data2_step(jax_data2, arm, zero1):
    """The 2-rank port (gloo, ZeRO-1 off and on) against JAX's data=2
    step: loss, grad_norm and lr every step, the final parameters, at
    test_torch_pretrain's tolerances; both ranks report the same
    metrics."""
    r0, r1 = (r[arm] for r in jax_data2["ranks"])
    assert r0["describe"]["zero1"] is zero1
    for i, want in enumerate(jax_data2["metrics"]):
        for r in (r0, r1):
            np.testing.assert_allclose(r["loss"][i], want["loss"],
                                       rtol=tp.LOSS_RTOL)
            np.testing.assert_allclose(r["grad_norm"][i], want["grad_norm"],
                                       rtol=1e-4)
            np.testing.assert_allclose(r["learning_rate"][i],
                                       want["learning_rate"], rtol=1e-6)
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    got = np.load(jax_data2["root"] / "ranks" / f"rank0_{arm}.npz")
    tp._assert_params_close({k[len("params/"):]: torch.from_numpy(got[k])
                             for k in got if k.startswith("params/")},
                            jax_data2["final"])


# -- the per-rank metrics fold --------------------------------------------------


def test_metrics_fold_equals_jax(tmp_path):
    """Three ranks publish the same records through the port's and JAX's
    HostMetricsAggregator: rank 0's folds, the straggler flag included,
    are equal, and the copy reads files written by the other."""
    from bert_pytorch_tpu.telemetry.multihost import \
        HostMetricsAggregator as JaxAgg

    from bert_pytorch_tpu_torch.telemetry.multihost import \
        HostMetricsAggregator as PortAgg

    recs = [{"step_time_ms": 100.0 + i, "data_wait_ms": 1.5 * i,
             "seq_per_sec": 10.0, "tag": "perf", "nan": float("nan")}
            for i in range(3)]
    recs.append({"step_time_ms": 400.0, "data_wait_ms": 0.5})
    folds = []
    for cls, sub in ((JaxAgg, "jax"), (PortAgg, "port")):
        aggs = [cls(str(tmp_path / sub), i, 4, z_threshold=1.5)
                for i in range(4)]
        for i, (a, rec) in enumerate(zip(aggs, recs)):
            a.publish(7 + (i == 3), rec)
        folds.append(aggs[0].fold())
        for a in aggs:
            a.close()
    assert folds[0] == folds[1]
    assert folds[1][0]["straggler_host"] == 3 and folds[1][1]
    assert PortAgg(str(tmp_path / "jax"), 0, 4,
                   z_threshold=1.5).fold() == folds[0]


# -- run_pretraining.main on two ranks ------------------------------------------


def test_main_on_two_gloo_ranks_splits_samples_as_jax(tmp_path):
    """run_pretraining.main with --mesh data=2 --device cpu on 2 gloo
    ranks: each rank's sample ids are JAX's HostShardSampler split
    (disjoint), both ranks log the same loss, rank 0 saves, and a rerun
    resumes the saved step on both ranks; the perf records carry the
    collectives and rank 0's fold."""
    from bert_pytorch_tpu.data.sharded import HostShardSampler as JaxSampler

    data = tp._write_shards(tmp_path / "data")
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(tp.CFG))
    out = tmp_path / "out"
    argv = ["--config_file",
            os.path.join(REPO, "configs",
                         "bert_pretraining_phase1_config.json"),
            "--model_config_file", str(cfg), "--input_dir", str(data),
            "--output_dir", str(out), "--local_batch_size", "2",
            "--global_batch_size", "8", "--steps", "2", "--mesh", "data=2",
            "--device", "cpu", "--tensorboard", "off", "--log_freq", "1"]
    r0, r1 = torch_ranks.run({"kind": "main", "runs": [argv, argv]}, 2,
                             tmp_path / "ranks")
    first, again = r0
    assert first["accum_steps"] == 2 and first["step"] == 2
    assert first["saves"] == [2] and r1[0]["saves"] == []
    for rank, runs in enumerate((r0, r1)):
        # the loader's assembly thread draws ahead of the steps: every
        # index drawn, in order, is JAX's sampler's for this rank
        drawn = runs[0]["indices"]
        assert len(drawn) >= 8 and len(drawn) % 4 == 0
        sampler = JaxSampler(48, world_size=2, rank=rank, seed=42)
        want = [int(i) for _ in range(len(drawn) // 4)
                for i in sampler.next_indices(4)]
        assert drawn == want
    assert not set(r0[0]["indices"]) & set(r1[0]["indices"])
    assert [h["loss"] for h in r0[0]["history"]] == \
        [h["loss"] for h in r1[0]["history"]]
    assert again["resumed_from"] == 2 and again["step"] == 4
    assert r1[1]["resumed_from"] == 2
    assert (out / "pretrain_ckpts" / "4" / "state.pt").is_file()
    perf = [json.loads(ln) for ln in
            (out / "phase1_log.jsonl").read_text().splitlines()]
    perf = [p for p in perf if p.get("tag") == "perf"]
    assert perf and all(p["collective_bytes_per_step"] > 0 for p in perf)
    assert any(p.get("hosts_reporting") == 2 for p in perf)
    assert (out / "metrics_hosts" / "host00001.jsonl").is_file()
