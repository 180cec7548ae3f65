"""The port's fsdp axis (bert_pytorch_tpu_torch/parallel/) against the JAX
package on the CPU: fsdp meshes parsed, sized and resolved as JAX's
parser, make_mesh and run_pretraining resolve them (production with
fsdp, --fsdp_overlap on a trivial axis, fsdp with ZeRO-1 forcing
--zero1_overlap, --zero1_rs off a data-only mesh); a 2-rank fsdp=2 run
against JAX's one-process fsdp=2 step (3 steps, accumulation 2, dropout
on; the Pallas kernels in interpret mode on the 8-device CPU mesh, so
the per-shard dropout folds apply), --fsdp_overlap off and on bit-equal,
fsdp=2 bit-equal to data=2 with ZeRO-1 and its gather-on-use; 4 ranks of
data=2,fsdp=2 with ZeRO-1 and without against JAX's data=2,fsdp=2; a
rank's resting f32 bytes about 1/F of one card's.

The ranks are processes of tests/torch_ranks.py joined by a FileStore
under tmp_path (no port is taken). `jax_mesh_reference` is shared with
tests/test_torch_model_parallel.py."""

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
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import params_from_flax  # noqa: E402
from bert_pytorch_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

N_STEPS, ACCUM = 3, 2
ROWS = 8                      # a microbatch's global rows
LOSS_RTOL = 1e-5              # the bounds of a 3-step run at f32
PARAM_GLOBAL_RTOL = 2e-5


# -- meshes and their resolution -----------------------------------------------


@pytest.mark.parametrize("spec,n", [("fsdp=2", 2), ("data=2,fsdp=2", 4),
                                    ("fsdp=4", 8), ("fsdp=2,model=2", 4),
                                    ("data=2,fsdp=2,model=2", 8),
                                    ("fsdp=2", 8)])
def test_fsdp_meshes_parse_size_and_order_as_jax(spec, n):
    """parse_mesh_arg gives JAX's dict; the mesh over n ranks has JAX's
    shape over n CPU devices; rank r sits where JAX's device r sits in
    its device array, and its data shard is JAX's batch-axis position."""
    import run_pretraining as jax_entry

    assert port_mesh.parse_mesh_arg(spec) == jax_entry.parse_mesh_arg(spec)
    shape = port_mesh.parse_mesh_arg(spec)
    jm = jax_mesh.make_mesh(shape, jax.devices()[:n])
    got = port_mesh.make_mesh(shape, n)
    assert got.shape == dict(jm.shape)
    assert port_mesh.data_shard_count(got) == jax_mesh.data_shard_count(jm)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    first = jax.devices()[0].id
    for idx in np.ndindex(ids.shape):
        rank = int(ids[idx]) - first
        assert tuple(got.coords(rank).values()) == idx
        assert got.rank_of(got.coords(rank)) == rank
        assert got.data_shard_index(rank) == idx[0] * got.fsdp + idx[1]


def _plan(argv, world, monkeypatch):
    """run_pretraining._parallel_plan of `argv` as rank 0 of `world`."""
    from bert_pytorch_tpu_torch.parallel import dist

    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    args = run_pretraining.parse_arguments(argv)
    return args, run_pretraining._parallel_plan(args, torch.device("cpu"))


@pytest.mark.parametrize("spec,n", [("fsdp=2", 2), ("data=2,fsdp=2", 4),
                                    ("fsdp=2,model=2", 4)])
def test_production_with_fsdp_resolves_as_jax(spec, n, monkeypatch):
    """production's features for an fsdp mesh are JAX's (fsdp_overlap on
    where fsdp > 1, ZeRO-1 where data > 1), and the entry point turns
    them on: --fsdp_overlap, and with ZeRO-1 its gather-on-use."""
    from bert_pytorch_tpu.parallel import rules as jax_rules

    jm = jax_mesh.make_mesh(port_mesh.parse_mesh_arg(spec),
                            jax.devices()[:n])
    pm = port_mesh.make_mesh(port_mesh.parse_mesh_arg(spec), n)
    assert port_mesh.production_features(pm) == \
        jax_rules.production_features(jm)
    assert port_mesh.production_qualifies(pm) == \
        jax_rules.production_qualifies(jm)
    assert port_mesh.mesh_config(pm) == jax_rules.mesh_config(jm)
    args, par = _plan(["--mesh", spec, "--mesh_config", "production"], n,
                      monkeypatch)
    assert par.mesh_config == "production" and args.packing
    assert par.fsdp_overlap
    assert par.zero1 == (pm.data > 1) and par.zero1_overlap == par.zero1


def test_fsdp_overlap_on_a_trivial_axis_is_a_note(monkeypatch):
    """--fsdp_overlap with fsdp 1: JAX's WARNING note, a normal run."""
    args, par = _plan(["--mesh", "data=2", "--fsdp_overlap"], 2,
                      monkeypatch)
    assert not par.fsdp_overlap
    assert any(n.startswith("WARNING: --fsdp_overlap ignored")
               for n in par.notes)


def test_fsdp_overlap_with_zero1_forces_zero1_overlap(monkeypatch):
    args, par = _plan(["--mesh", "data=2,fsdp=2", "--zero1", "true",
                       "--fsdp_overlap", "--mesh_config", "base"], 4,
                      monkeypatch)
    assert par.fsdp_overlap and par.zero1 and par.zero1_overlap
    assert any("forces --zero1_overlap" in n for n in par.notes)
    args, par = _plan(["--mesh", "data=2,fsdp=2", "--zero1", "true",
                       "--mesh_config", "base"], 4, monkeypatch)
    assert not par.fsdp_overlap and not par.zero1_overlap


@pytest.mark.parametrize("spec,n", [("fsdp=2", 2), ("data=2,fsdp=2", 4),
                                    ("data=2,model=2", 4)])
def test_zero1_rs_off_a_data_only_mesh_exits_as_jax(spec, n, monkeypatch):
    """--zero1_rs needs a data-only mesh (JAX's rs_supported): a SystemExit
    otherwise."""
    from bert_pytorch_tpu.parallel.zero import rs_supported as jax_rs

    from bert_pytorch_tpu_torch.parallel.zero import rs_supported

    jm = jax_mesh.make_mesh(port_mesh.parse_mesh_arg(spec),
                            jax.devices()[:n])
    pm = port_mesh.make_mesh(port_mesh.parse_mesh_arg(spec), n)
    assert rs_supported(pm) == jax_rs(jm) is False
    with pytest.raises(SystemExit, match="--zero1_rs needs a data-only mesh"):
        _plan(["--mesh", spec, "--zero1", "true", "--zero1_rs"], n,
              monkeypatch)


# -- runs against JAX's one-process mesh ----------------------------------------


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


def jax_mesh_reference(root, shape, n_devices):
    """JAX's jitted step on its one-process mesh `shape` over `n_devices`
    CPU devices (Pallas in interpret mode, the model's sharded kernels
    on): 3 steps at accumulation 2 with dropout on. Writes the ranks'
    inputs under `root` (the initial params, the batches, the seeds JAX
    drew) and returns (the job of those inputs, JAX's metrics, JAX's
    final params in the port's names)."""
    from bert_pytorch_tpu.optim import schedulers as jsched
    from bert_pytorch_tpu.training import pretrain as jpre
    from bert_pytorch_tpu.training.state import TrainState

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
    mesh = jax_mesh.make_mesh(shape, jax.devices()[:n_devices])
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
           "max_predictions": tp.P, "health": True}
    return job, metrics, params_from_flax(tp._flat(state.params))


def state_of(root, arm):
    """Rank 0's final one-card state of arm `arm` (params/, mu/, nu/)."""
    return dict(np.load(root / f"rank0_{arm}.npz"))


def assert_against_jax(ranks, arm, metrics, final, root):
    """Every rank's losses within LOSS_RTOL of JAX's and the same on every
    rank; grad norms and lr within test_torch_parallel's bounds; all the
    parameters together within PARAM_GLOBAL_RTOL relative L2."""
    for i, want in enumerate(metrics):
        for r in ranks:
            np.testing.assert_allclose(r[arm]["loss"][i], want["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(r[arm]["grad_norm"][i],
                                       want["grad_norm"], rtol=1e-4)
            np.testing.assert_allclose(r[arm]["learning_rate"][i],
                                       want["learning_rate"], rtol=1e-6)
    for r in ranks[1:]:
        assert r[arm]["loss"] == ranks[0][arm]["loss"]
        assert r[arm]["grad_norm"] == ranks[0][arm]["grad_norm"]
    got = state_of(root, arm)
    num = den = 0.0
    for k, w in final.items():
        g = got[f"params/{k}"].astype(np.float64)
        w = w.numpy().astype(np.float64)
        assert g.shape == w.shape, k
        num += float(np.square(g - w).sum())
        den += float(np.square(w).sum())
    assert (num / den) ** 0.5 <= PARAM_GLOBAL_RTOL, (num / den) ** 0.5


def assert_bit_equal(root, ranks, a, b):
    """Arms a and b: losses, grad norms and param norms of every rank, and
    rank 0's final params and moments, bit for bit."""
    for r in ranks:
        for k in ("loss", "grad_norm", "param_norm"):
            assert r[a][k] == r[b][k], (k, a, b)
    sa, sb = state_of(root, a), state_of(root, b)
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"{k} {a}/{b}")


FSDP2_ARMS = [{"mesh": "fsdp=2"}, {"mesh": "fsdp=2", "fsdp_overlap": True},
              {"mesh": "data=2", "zero1": True, "zero1_overlap": True}]


@pytest.fixture(scope="module")
def fsdp2(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_fsdp2")
    job, metrics, final = jax_mesh_reference(root, {"fsdp": 2}, 2)
    ranks = torch_ranks.run(dict(job, arms=FSDP2_ARMS), 2, root / "ranks")
    return {"ranks": ranks, "metrics": metrics, "final": final,
            "root": root / "ranks"}


def test_two_ranks_fsdp2_match_jax_fsdp2_step(fsdp2):
    """fsdp=2 on 2 gloo ranks against JAX's one-process fsdp=2 step: the
    losses within 1e-5 relative, the parameters together within 2e-5
    relative L2 at f32 (a dropout mask off shows as a loss off by far
    more: test_torch_model_parallel holds each mask exactly)."""
    assert_against_jax(fsdp2["ranks"], 0, fsdp2["metrics"], fsdp2["final"],
                       fsdp2["root"])
    d = fsdp2["ranks"][0][0]["describe"]
    assert d["rest_sliced"] and d["slice_ranks"] == 2 and not d["zero1"]
    # the gradients left by the fsdp group's reduce-scatter
    assert fsdp2["ranks"][0][0]["collectives"]["fsdp"]["bytes"] > 0


def test_fsdp_overlap_off_and_on_bit_equal(fsdp2):
    """--fsdp_overlap (each unit awaited where the forward reaches it)
    against the blocking gather: loss, grad norm and every parameter."""
    assert_bit_equal(fsdp2["root"], fsdp2["ranks"], 0, 1)
    assert fsdp2["ranks"][0][1]["describe"]["fsdp_overlap"]


def test_fsdp2_bit_equal_to_data2_zero1_gather_on_use(fsdp2):
    """fsdp=2 and data=2 with ZeRO-1 and --zero1_overlap draw the same
    masks (the same data-shard folds), sum the same counts, reduce-scatter
    the same gradients into the same pieces: any difference is a fault."""
    assert_bit_equal(fsdp2["root"], fsdp2["ranks"], 0, 2)


def test_resting_f32_bytes_are_about_one_fsdp_share(fsdp2):
    """A rank's f32 masters and moments under fsdp=2 are half of one
    card's (the flat units' padding aside)."""
    one_card = 12 * sum(int(np.prod(v.shape)) for v in
                        fsdp2["final"].values())
    got = fsdp2["ranks"][0][0]["describe"]["resting_f32_bytes"]
    assert abs(got / one_card - 0.5) <= 0.01, got / one_card


DF_ARMS = [{"mesh": "data=2,fsdp=2"},
           {"mesh": "data=2,fsdp=2", "zero1": True},
           {"mesh": "data=2,fsdp=2", "zero1": True, "zero1_overlap": True,
            "fsdp_overlap": True}]


@pytest.fixture(scope="module")
def data2_fsdp2(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_data2_fsdp2")
    job, metrics, final = jax_mesh_reference(root, {"data": 2, "fsdp": 2},
                                             4)
    ranks = torch_ranks.run(dict(job, arms=DF_ARMS), 4, root / "ranks")
    return {"ranks": ranks, "metrics": metrics, "final": final,
            "root": root / "ranks"}


@pytest.mark.parametrize("arm", [0, 1, 2])
def test_four_ranks_data2_fsdp2_match_jax(data2_fsdp2, arm):
    """data=2,fsdp=2 on 4 ranks, without ZeRO-1 (reduce-scatter over fsdp,
    then the sum over data), with it (the batch group's all-reduce and
    slice) and with both overlaps, against JAX's data=2,fsdp=2 step."""
    assert_against_jax(data2_fsdp2["ranks"], arm, data2_fsdp2["metrics"],
                       data2_fsdp2["final"], data2_fsdp2["root"])
    d = data2_fsdp2["ranks"][0][arm]["describe"]
    assert d["slice_ranks"] == (4 if arm else 2)
