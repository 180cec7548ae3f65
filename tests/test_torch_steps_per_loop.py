"""--steps_per_loop N in the port's pretraining loop, on the CPU at a tiny
width (2 layers, E=32): a run at N=3 is bit-equal to the same run at N=1
(parameters, LAMB moments, every logged loss), a flag raised by an inner
step survives to the chunk's one read (JAX's sticky metrics), the logged
and checkpointed steps are the ones JAX's loop rule gives, a run whose
last steps do not fill a chunk ends in single steps, and a bundle replays
a step inside a chunk.

JAX's chained steps draw their dropout keys by fold_in(rng, i) and so
differ from its own N=1 run; the port's inner steps take their own global
step's seeds, so no cross-framework equality is claimed for N > 1 and
these tests hold the port to itself."""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.telemetry.health import (  # noqa: E402
    STICKY_METRIC_KEYS, is_sticky_metric)
from bert_pytorch_tpu_torch.tools import replay  # noqa: E402
from bert_pytorch_tpu_torch.training.pretrain import chain_steps  # noqa: E402
from tests.test_data import write_shard  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=64, next_sentence=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunks")
    (root / "data").mkdir()
    for i in range(2):
        write_shard(str(root / "data" / f"part_{i}.hdf5"), 24, seq=32,
                    seed=i)
    (root / "tiny.json").write_text(json.dumps(CFG))
    return root


def _run(data, out, *extra, log=None):
    argv = ["--config_file", os.path.join(
                REPO, "configs", "bert_pretraining_phase1_config.json"),
            "--model_config_file", str(data / "tiny.json"),
            "--input_dir", str(data / "data"), "--output_dir", str(out),
            "--local_batch_size", "4", "--global_batch_size", "8",
            "--device", "cpu", "--tensorboard", "off",
            "--vocab_pad_multiple", "8", "--log_freq", "1", *extra]
    return run_pretraining.main(argv, log=log or (lambda m: None))


def _jsonl(out, tag):
    with open(os.path.join(out, "phase1_log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("tag") == tag]


def test_chunks_of_three_are_bit_equal_to_single_steps(data, tmp_path):
    one = _run(data, tmp_path / "n1", "--steps", "5")
    three = _run(data, tmp_path / "n3", "--steps", "5",
                 "--steps_per_loop", "3")
    assert one.step == three.step == 5
    a, b = one.state.state_dict(), three.state.state_dict()
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
        assert torch.equal(a["opt_state"]["mu"][k],
                           b["opt_state"]["mu"][k]), k
        assert torch.equal(a["opt_state"]["nu"][k],
                           b["opt_state"]["nu"][k]), k
    # each logged loss is the N=1 run's at that step
    by_step = {h["step"]: h for h in one.history}
    assert [h["step"] for h in three.history] == [3, 4, 5]
    for h in three.history:
        for k in ("loss", "grad_norm", "learning_rate", "mlm_accuracy"):
            assert h[k] == by_step[h["step"]][k], (h["step"], k)
    # a perf record a chunk, counting its steps
    perf = _jsonl(tmp_path / "n3", "perf")
    assert [r["steps"] for r in perf] == [3, 1, 1]


def test_an_inner_steps_flag_survives_the_chunk(data, tmp_path):
    """A NaN injected at step 2, under --nonfinite_action skip: the chunk
    of steps 1-3 reads step 3's metrics, finite, with step 2's skip and
    non-finite counts max-accumulated into them."""
    res = _run(data, tmp_path / "s", "--steps", "3", "--steps_per_loop",
               "3", "--inject_nonfinite_step", "2", "--nonfinite_action",
               "skip", "--skip_checkpoint")
    (rec,) = res.history
    assert rec["step"] == 3 and np.isfinite(rec["loss"])
    assert rec["skipped_nonfinite"] == 1 and rec["grad_nonfinite"] > 0
    assert rec["grad_nonfinite_bert"] > 0


def test_chain_steps_max_accumulates_the_sticky_keys():
    seq = [{"loss": torch.tensor(1.0), "grad_spike": torch.tensor(0),
            "skipped_nonfinite": 1, "grad_nonfinite_bert": torch.tensor(3)},
           {"loss": torch.tensor(2.0), "grad_spike": torch.tensor(1),
            "skipped_nonfinite": 0, "grad_nonfinite_bert": torch.tensor(0)},
           {"loss": torch.tensor(3.0), "grad_spike": torch.tensor(0),
            "skipped_nonfinite": 0, "grad_nonfinite_bert": torch.tensor(0)}]
    seen = []

    def step(state, batch, seeds):
        seen.append((int(batch["x"][0]), int(seeds[0])))
        return dict(seq[len(seen) - 1])

    m = chain_steps(step, 3)(None, {"x": torch.arange(3)[:, None]},
                             torch.arange(10, 13)[:, None])
    assert seen == [(0, 10), (1, 11), (2, 12)]
    assert float(m["loss"]) == 3.0
    assert int(m["grad_spike"]) == 1 and m["skipped_nonfinite"] == 1
    assert int(m["grad_nonfinite_bert"]) == 3
    assert set(STICKY_METRIC_KEYS) >= {"grad_spike", "skipped_nonfinite"}
    assert is_sticky_metric("grad_nonfinite_cls_predictions")
    assert not is_sticky_metric("loss")


def _jax_rule(limit, n, every):
    """JAX's loop (run_pretraining.py): a chunk of n while n steps are
    left, else single steps; a checkpoint after a dispatch when
    global_step % every < (n if remaining >= n else 1), and at the end."""
    step, logged, saved = 0, [], []
    while step < limit:
        remaining = limit - step
        k = n if remaining >= n else 1
        step += k
        logged.append(step)
        if step % every < (n if remaining >= n else 1):
            saved.append(step)
    if not saved or saved[-1] != step:
        saved.append(step)
    return logged, saved


def test_logged_and_checkpointed_steps_follow_jax_rule(data, tmp_path):
    """8 steps at N=3 with a checkpoint every 4: chunks end at 3 and 6
    (the second crosses 4: saved), then single steps 7 and 8 (the short
    last chunk; 8 saved)."""
    lines = []
    res = _run(data, tmp_path / "c", "--steps", "8", "--steps_per_loop",
               "3", "--num_steps_per_checkpoint", "4", "--keep_checkpoints",
               "5", log=lines.append)
    logged, saved = _jax_rule(8, 3, 4)
    assert (logged, saved) == ([3, 6, 7, 8], [6, 8])
    assert [h["step"] for h in res.history] == logged
    assert [s["step"] for s in res.saves] == saved
    assert [r["step"] for r in _jsonl(tmp_path / "c", "train")] == logged
    assert any("h2d prefetch: off" in m for m in lines)
    assert sorted(int(p) for p in os.listdir(
        tmp_path / "c" / "pretrain_ckpts") if p.isdigit()) == saved


def test_replay_reproduces_a_step_inside_a_chunk(data, tmp_path, capsys):
    """A NaN at step 5 halts the run after the chunk of steps 4-6 (N=3,
    checkpoints every 3); the bundle's run block says steps_per_loop 3,
    its records carry each step's own seeds; replay reproduces step 6
    (the chunk's read, the flags folded) bit-identically, reproduces
    inner step 5 (no recorded read to compare), and refuses a chunk
    whose head the ring lost."""
    out = tmp_path / "r"
    with pytest.raises(run_pretraining.NonFiniteHalt):
        _run(data, out, "--steps", "9", "--steps_per_loop", "3",
             "--num_steps_per_checkpoint", "3", "--inject_nonfinite_step",
             "5", "--nonfinite_action", "halt")
    (bundle,) = (out / "repro_bundles").iterdir()
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert manifest["run"]["steps_per_loop"] == 3
    assert manifest["trigger_step"] == 6
    recs = {r["step"]: r for r in manifest["records"]}
    assert [(recs[s]["pos"], recs[s]["n_steps"]) for s in (4, 5, 6)] == \
        [(0, 3), (1, 3), (2, 3)]
    npz = np.load(bundle / "batches.npz")
    assert npz["s00000005__rng"].shape == npz["s00000004__rng"].shape
    assert not np.array_equal(npz["s00000005__rng"], npz["s00000004__rng"])
    last = replay.main(["--bundle", str(bundle), "--device", "cpu"])
    assert last["match"] is True and last["base_checkpoint"] == 3
    assert last["replayed"]["loss_nonfinite"] > 0
    inner = replay.main(["--bundle", str(bundle), "--step", "5",
                         "--device", "cpu"])
    assert inner["recorded"] is None and inner["match"] is None
    assert inner["replayed"]["loss_nonfinite"] > 0
    # a chunk whose head the ring lost
    for r in manifest["records"]:
        if r["step"] == 4:
            r["pos"] = 1
    (bundle / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(replay.ReplayError, match="mid-dispatch"):
        replay.main(["--bundle", str(bundle), "--device", "cpu"])


def test_a_profile_window_inside_a_chunk_traces_the_chunk(data, tmp_path):
    """--steps_per_loop 4 --profile_steps 2,3: step 3 lies inside the
    first chunk (steps 1-4), which is traced whole, as JAX's window
    covers whole chunks; at N=1 the same window traces step 3 alone."""
    four = _run(data, tmp_path / "n4", "--steps", "4", "--steps_per_loop",
                "4", "--profile_steps", "2,3", "--skip_checkpoint")
    assert four.profile["steps"] == [1, 4]
    assert "dispatch" in four.profile["summary"]["host_ms"]
    one = _run(data, tmp_path / "n1", "--steps", "4", "--profile_steps",
               "2,3", "--skip_checkpoint")
    assert one.profile["steps"] == [3, 3]
    for k, v in one.state.params.items():
        assert torch.equal(v, four.state.params[k]), k

