"""Checkpoints of the port's pretraining entry point on the CPU, at the
tiny width of tests/test_torch_pretrain.py: resume after a save matches an
uninterrupted run bit for bit (LAMB routes "off", "xla" and "auto", and
across "off" and "auto"), the phase-1 -> phase-2 handoff,
corrupt-checkpoint quarantine (a missing sidecar included) and the
rolling window, --init_checkpoint, a resumed port run against JAX's
uninterrupted trajectory, and the dropout seeds as a pure function of
(seed, step).

Tolerances: resumes and the route cross-resume exactly (one process, the
CPU's deterministic kernels); against JAX the tiers of
test_three_step_trajectory_matches_jax (loss 1e-5 relative, parameters
1e-4 relative L2 per tensor)."""

import json
import os
import sys
import warnings

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
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.optim.lamb import Lamb  # noqa: E402
from bert_pytorch_tpu_torch.optim.schedulers import (  # noqa: E402
    make_schedule, poly_warmup_schedule)
from bert_pytorch_tpu_torch.resilience.manifest import (  # noqa: E402
    CorruptCheckpointError)
from bert_pytorch_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointManager)
from bert_pytorch_tpu_torch.training.pretrain import (  # noqa: E402
    build_pretrain_step)
from bert_pytorch_tpu_torch.training.state import make_train_state  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_data import write_shard  # noqa: E402

REPO = tp.REPO
PHASE1 = os.path.join(REPO, "configs", "bert_pretraining_phase1_config.json")
PHASE2 = os.path.join(REPO, "configs", "bert_pretraining_phase2_config.json")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Phase-1 shards (2 x 12 samples of seq 32: 3 steps of 8 an epoch,
    so 4 steps cross an epoch), phase-2 shards (one of 20 at seq 64) and
    the tiny model config."""
    root = tmp_path_factory.mktemp("ckpt")
    p1, p2 = root / "data1", root / "data2"
    p1.mkdir()
    p2.mkdir()
    for i in range(2):
        write_shard(str(p1 / f"part_{i}.hdf5"), 12, seq=tp.S, seed=i)
    write_shard(str(p2 / "part_0.hdf5"), 20, seq=64, seed=5)
    cfg = root / "tiny.json"
    cfg.write_text(json.dumps(tp.CFG))
    return {"data1": str(p1), "data2": str(p2), "cfg": str(cfg)}


def _run(files, out, *extra, phase=1):
    """run_pretraining.main at the tiny width: microbatch 4, global batch
    8 (accumulation 2), 4 steps, bf16 compute and gradients, dropout on."""
    if phase == 1:
        argv = ["--config_file", PHASE1, "--input_dir", files["data1"],
                "--max_steps", "4"]
    else:
        argv = ["--config_file", PHASE2, "--input_dir", files["data2"],
                "--max_predictions_per_seq", "10"]
    argv += ["--model_config_file", files["cfg"], "--output_dir", str(out),
             "--local_batch_size", "4", "--global_batch_size", "8",
             "--device", "cpu", *extra]
    return run_pretraining.main(argv, log=lambda m: None)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for what in ("params", "mu", "nu"):
        x = a.params if what == "params" else getattr(a.opt_state, what)
        y = b.params if what == "params" else getattr(b.opt_state, what)
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), (what, k)


def _logged(out, key="step_loss"):
    """`key` of every train record of the run's jsonl (the header and the
    perf records left out)."""
    with open(os.path.join(out, "phase1_log.jsonl")) as f:
        return [rec[key] for rec in map(json.loads, f)
                if rec["tag"] == "train"]


_UNINTERRUPTED = {}


def _uninterrupted(files, tmp_path_factory, route):
    """The 4-step run without a break (cached per route)."""
    if route not in _UNINTERRUPTED:
        out = tmp_path_factory.mktemp(f"whole_{route}")
        res = _run(files, out, "--fused_optim", route,
                   "--num_steps_per_checkpoint", "2")
        _UNINTERRUPTED[route] = (res, _logged(out))
    return _UNINTERRUPTED[route]


@pytest.mark.parametrize("route", ["off", "xla", "auto"])
def test_resume_after_save_is_bit_identical(files, tmp_path,
                                            tmp_path_factory, route):
    """(f) A run that stops after step 2 (its checkpoint) and is resumed by
    a new call ends where an uninterrupted 4-step run ends: parameters,
    mu, nu, step and count, and every logged loss and gradient norm."""
    whole, whole_log = _uninterrupted(files, tmp_path_factory, route)
    assert [s["step"] for s in whole.saves] == [2, 4]
    first = _run(files, tmp_path, "--fused_optim", route, "--steps", "2",
                 "--num_steps_per_checkpoint", "2")
    assert first.step == 2 and [s["step"] for s in first.saves] == [2]
    second = _run(files, tmp_path, "--fused_optim", route,
                  "--num_steps_per_checkpoint", "2")
    assert second.resumed_from == 2 and second.step == 4
    _assert_states_equal(second.state, whole.state)
    for key in ("loss", "grad_norm", "learning_rate"):
        assert ([r[key] for r in first.history + second.history]
                == [r[key] for r in whole.history]), key
    assert _logged(tmp_path) == whole_log


@pytest.mark.parametrize("routes", [("off", "auto"), ("auto", "off")])
def test_checkpoint_resumes_under_the_other_route(files, tmp_path,
                                                  tmp_path_factory, routes):
    """(g) A checkpoint written under one LAMB route (tensor by tensor, or
    the staged wrappers, which take their plain versions on the CPU)
    resumes under the other, and the run still ends with the
    uninterrupted run's bits."""
    whole, _ = _uninterrupted(files, tmp_path_factory, "off")
    _run(files, tmp_path, "--fused_optim", routes[0], "--steps", "2")
    second = _run(files, tmp_path, "--fused_optim", routes[1])
    assert second.resumed_from == 2
    _assert_states_equal(second.state, whole.state)


def test_phase2_resumes_phase1(files, tmp_path):
    """(h) Phase 1 saves at step 3; phase 2 (its run config, other shards)
    with previous_phase_end_step 3 in the same output_dir resumes at step
    3 with phase 1's weights and moments, warns that phase 1's sampler
    cursor does not fit its shards, and trains on with the schedule
    offset by 3."""
    one = _run(files, tmp_path, "--max_steps", "3", "--fused_optim", "xla")
    assert one.step == 3 and [s["step"] for s in one.saves] == [3]
    two_args = ("--previous_phase_end_step", "3", "--max_steps", "2",
                "--fused_optim", "auto")
    with pytest.warns(UserWarning, match="total_size changed"):
        restored = _run(files, tmp_path, *two_args, "--steps", "0",
                        phase=2)
    assert restored.resumed_from == 3 and not restored.history
    _assert_states_equal(restored.state, one.state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        two = _run(files, tmp_path, *two_args, phase=2)
    assert two.resumed_from == 3 and two.step == 5
    assert two.state.opt_state.count == 5
    sched = make_schedule("poly", 4e-3, 2, warmup=0.128, offset=3)
    assert [r["learning_rate"] for r in two.history] == [sched(3), sched(4)]
    assert sorted(os.listdir(tmp_path / "pretrain_ckpts")) == ["3", "5"]
    assert os.path.isfile(tmp_path / "phase2_log.jsonl")


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corrupt_newest_is_quarantined_and_window_keeps_three(files,
                                                              tmp_path):
    """(i) Saving every step keeps the newest 3; a flipped byte in the
    newest quarantines it and the run resumes from the one before; with
    every step corrupt the run raises."""
    run = _run(files, tmp_path, "--num_steps_per_checkpoint", "1")
    assert [s["step"] for s in run.saves] == [1, 2, 3, 4]
    ckpts = tmp_path / "pretrain_ckpts"
    assert CheckpointManager(str(ckpts)).all_steps() == [2, 3, 4]
    _flip_byte(ckpts / "4" / "state.pt")
    resumed = _run(files, tmp_path, "--num_steps_per_checkpoint", "1")
    assert resumed.resumed_from == 3 and resumed.step == 4
    assert os.path.isdir(ckpts / "4.corrupt")
    assert CheckpointManager(str(ckpts)).all_steps() == [2, 3, 4]
    for step in (2, 3, 4):
        _flip_byte(ckpts / str(step) / "extra.json")
    with pytest.raises(CorruptCheckpointError, match="every checkpoint"):
        _run(files, tmp_path)
    assert CheckpointManager(str(ckpts)).all_steps() == []


def test_step_without_sidecar_is_quarantined(tmp_path):
    """(i) Every save commits its sidecar with the step, so a committed
    step without one is treated as corrupt: quarantined, and the restore
    falls back to the step before it."""
    mgr = CheckpointManager(str(tmp_path), log=lambda m: None)
    for step in (1, 2):
        mgr.save(step, {"w": torch.full((3,), float(step))}, {"step": step})
    os.remove(tmp_path / "2" / "integrity.json")
    assert mgr.verify(2) == ["sidecar integrity.json missing"]
    state, extra, step = mgr.restore_with_fallback()
    assert step == 1 and extra == {"step": 1}
    assert torch.equal(state["w"], torch.full((3,), 1.0))
    assert mgr.all_steps() == [1] and os.path.isdir(tmp_path / "2.corrupt")


def test_init_checkpoint_seeds_weights_only(files, tmp_path):
    """(j) --init_checkpoint dir@step loads that step's parameters into a
    fresh run (step 0, zero moments), reports what it did not load, loses
    to an auto-resume, and raises on a checkpoint with no parameter of
    the model."""
    src = tmp_path / "src"
    run = _run(files, src, "--num_steps_per_checkpoint", "1",
               "--max_steps", "2")
    ckpts = src / "pretrain_ckpts"
    want, _, _ = CheckpointManager(str(ckpts)).restore(1)
    fresh = _run(files, tmp_path / "a", "--init_checkpoint",
                 f"{ckpts}@1", "--steps", "0")
    assert fresh.resumed_from is None and fresh.state.step == 0
    assert fresh.state.opt_state.count == 0
    for k, p in fresh.state.params.items():
        assert torch.equal(p, want["params"][k]), k
    for m in (fresh.state.opt_state.mu, fresh.state.opt_state.nu):
        assert all(not t.any() for t in m.values())
    # the output_dir's own checkpoint wins over --init_checkpoint
    resumed = _run(files, src, "--init_checkpoint", f"{ckpts}@1",
                   "--steps", "0")
    assert resumed.resumed_from == 2
    _assert_states_equal(resumed.state, run.state)
    # a checkpoint missing one parameter and reshaping another: both are
    # reported, the rest loads
    params = dict(want["params"])
    dropped = params.pop("cls_seq_relationship.bias")
    params["cls_seq_relationship.weight"] = torch.zeros(3, 3)
    part = CheckpointManager(str(tmp_path / "part"))
    part.save(7, {"params": params})
    lines = []
    run_pretraining.main(
        ["--config_file", PHASE1, "--input_dir", files["data1"],
         "--model_config_file", files["cfg"],
         "--output_dir", str(tmp_path / "b"), "--local_batch_size", "4",
         "--global_batch_size", "8", "--device", "cpu", "--steps", "0",
         "--init_checkpoint", str(tmp_path / "part")], log=lines.append)
    report = [ln for ln in lines if "fresh-initialized (" in ln]
    assert len(report) == 1 and "cls_seq_relationship.bias" in report[0]
    assert "cls_seq_relationship.weight (shape (3, 3)" in report[0]
    assert dropped.shape == (2,)
    alien = CheckpointManager(str(tmp_path / "alien"))
    alien.save(1, {"params": {"nothing.weight": torch.zeros(2)}})
    with pytest.raises(ValueError,
                       match="shares no same-shaped parameters"):
        _run(files, tmp_path / "c", "--init_checkpoint",
             f"{tmp_path / 'alien'}@1", "--steps", "0")


def test_resumed_port_matches_jax_trajectory(tmp_path, seed_recorder,
                                             init_params):
    """(k) The port checkpointed after step 1 and resumed into a new model
    and optimizer (fused route) follows JAX's uninterrupted 3-step
    trajectory: every loss and the final parameters."""
    jsched = jax_schedulers.poly_warmup_schedule(1e-2, total_steps=10,
                                                 warmup=0.2)
    tx = tp._jax_lamb(jsched)
    jstep = jax_pretrain.build_pretrain_step(tp._jax_model(), tx,
                                             schedule=jsched,
                                             max_predictions=tp.P)
    state = JaxState(step=jnp.zeros([], jnp.int32), params=init_params,
                     opt_state=tx.init(init_params))
    psched = poly_warmup_schedule(1e-2, total_steps=10, warmup=0.2)

    def port():
        model = tp._port_model(tp._flat(init_params))
        ptx = Lamb(psched, weight_decay=0.01, fused="auto")
        return (make_train_state(model, ptx),
                build_pretrain_step(model, ptx, schedule=psched,
                                    max_predictions=tp.P))

    pstate, pstep = port()
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    for i in range(3):
        batch = tp._batch(10 + i)
        del seed_recorder[:]
        state, metrics = jstep(
            state, {k: jnp.array(v)[None] for k, v in batch.items()},
            jax.random.PRNGKey(100 + i))
        seeds = torch.tensor([seed_recorder], dtype=torch.int32)
        pm = pstep(pstate, tp._torch_batch(batch, accum=1), seeds)
        np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                                   rtol=tp.LOSS_RTOL)
        if i == 0:
            mgr.save(pstate.step, pstate.state_dict())
            pstate, pstep = port()     # a new process would start here
            sd, _, step = mgr.restore()
            pstate.load_state_dict(sd)
            assert step == 1 and pstate.step == 1
    assert pstate.step == 3 and pstate.opt_state.count == 3
    tp._assert_params_close(pstate.params, state.params)


def test_dropout_seeds_are_a_function_of_seed_and_step():
    """(l) A step's seeds depend on (seed, step) alone: the same for the
    same pair whatever was drawn before, different for another step or
    seed, int32 of (accumulation, sites)."""
    seeds = run_pretraining.dropout_seeds
    a = seeds(42, 5, 2, 7)
    assert a.dtype == torch.int32 and a.shape == (2, 7)
    for other in (seeds(42, 1, 2, 7), seeds(42, 6, 2, 7),
                  seeds(43, 5, 2, 7), seeds(-42, 5, 2, 7)):
        assert not torch.equal(a, other)
    assert torch.equal(a, seeds(42, 5, 2, 7))
    assert torch.equal(seeds(-42, 3, 1, 4), seeds(-42, 3, 1, 4))


init_params = tp.init_params
seed_recorder = tp.seed_recorder
