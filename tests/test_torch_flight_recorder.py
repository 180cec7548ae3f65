"""The port's flight recorder and tools/replay.py, on the CPU, at a tiny
width (2 layers, E=64, seq 64, packed rows): one drill run shared by the
module (--inject_nonfinite_step 3 --nonfinite_action halt, a checkpoint
every step) leaves a bundle that the port's validator and the JAX
package's both accept; replay reproduces the recorded metrics bit for
bit (the trigger step and a finite step before it) and bisects the NaN to
layer 0's attention; a corrupt bundle exits 2. Then the watchdog's bundle
and the signal chain (preemption guard -> recorder -> SystemExit)."""

import json
import os
import shutil
import signal
import sys

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.telemetry.flight_recorder import (  # noqa: E402
    FlightRecorder, validate_bundle)
from bert_pytorch_tpu_torch.tools import replay  # noqa: E402
from tests.test_data import write_shard  # noqa: E402

CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=64, next_sentence=True)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The halt drill: steps 1 and 2 checkpointed, step 3 poisoned; returns
    (exit code, log lines, bundle directory, output directory)."""
    root = tmp_path_factory.mktemp("recorder_drill")
    (root / "data").mkdir()
    for i in range(2):
        write_shard(str(root / "data" / f"s{i}.hdf5"), 24, seq=64, seed=i,
                    varied=True)
    (root / "cfg.json").write_text(json.dumps(CFG))
    out = root / "out"
    argv = ["--model_config_file", str(root / "cfg.json"),
            "--input_dir", str(root / "data"), "--output_dir", str(out),
            "--local_batch_size", "4", "--global_batch_size", "8",
            "--max_steps", "5", "--max_predictions_per_seq", "6",
            "--packing", "--packing_max_segments", "4",
            "--num_steps_per_checkpoint", "1", "--recorder_window", "4",
            "--inject_nonfinite_step", "3", "--nonfinite_action", "halt",
            "--device", "cpu"]
    lines = []
    rc = run_pretraining.exit_code_of(
        lambda: run_pretraining.main(argv, log=lines.append))
    bundles = os.listdir(out / "repro_bundles")
    assert bundles == ["step00000003_nonfinite"], bundles
    return rc, lines, str(out / "repro_bundles" / bundles[0]), out


def test_drill_halts_and_names_its_bundle(drill, capsys):
    rc, lines, bundle, _ = drill
    assert rc == 71
    assert any(ln.startswith("flight recorder: repro bundle for step 3")
               and bundle in ln for ln in lines)
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["trigger_step"] == 3 and manifest["reason"] == "nonfinite"
    assert [r["step"] for r in manifest["records"]] == [1, 2, 3]
    assert manifest["checkpoint"]["latest_step"] == 2
    assert manifest["run"]["packing"] is True
    assert manifest["metrics_tail"][-1]["loss"] == "nan"
    assert "bert_nonfinite_steps_total" in manifest["registry"]
    assert manifest["metrics_tail_source"].endswith("logfile.jsonl")


def test_bundle_passes_both_validators(drill):
    from bert_pytorch_tpu.telemetry.flight_recorder import \
        validate_bundle as jax_validate

    bundle = drill[2]
    assert validate_bundle(bundle) == []
    assert jax_validate(bundle) == []
    assert replay._cli(["--bundle", bundle, "--validate"]) == 0


def test_replay_reproduces_and_bisects(drill, capsys):
    bundle = drill[2]
    result = replay.main(["--bundle", bundle, "--bisect", "--device", "cpu"])
    out = capsys.readouterr().out
    assert result["match"] is True and result["base_checkpoint"] == 2
    assert "REPRODUCED bit-identically" in out
    assert result["bisect"]["first_nonfinite"] == {
        "scope": "layer_0/attention", "microbatch": 0}
    assert "bisect: first non-finite tensor in scope 'layer_0/attention'" \
        in out
    assert result["replayed"]["loss_nonfinite"] == 1


def test_replay_reproduces_a_finite_step(drill):
    """Step 2 from checkpoint 1: every deterministic key, finite, equal."""
    result = replay.main(["--bundle", drill[2], "--step", "2",
                          "--device", "cpu"])
    assert result["match"] is True and result["base_checkpoint"] == 1
    assert np.isfinite(result["replayed"]["loss"])
    assert result["replayed"]["loss"] == result["recorded"]["loss"]


def _corrupt_manifest(bundle):
    path = os.path.join(bundle, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    del m["run"]["max_pred_row"]
    with open(path, "w") as f:
        json.dump(m, f)


def _corrupt_npz(bundle):
    path = os.path.join(bundle, "batches.npz")
    with np.load(path) as npz:
        kept = {k: npz[k] for k in npz.files if k != "s00000003__rng"}
    np.savez(path, **kept)


@pytest.mark.parametrize("corrupt", [_corrupt_manifest, _corrupt_npz])
def test_corrupt_bundle_exits_2(drill, tmp_path, corrupt, capsys):
    bundle = str(tmp_path / "bundle")
    shutil.copytree(drill[2], bundle)
    corrupt(bundle)
    assert validate_bundle(bundle)
    assert replay._cli(["--bundle", bundle, "--device", "cpu"]) == 2
    assert replay._cli(["--bundle", bundle, "--validate"]) == 2
    assert "bundle failed schema validation" in capsys.readouterr().err


def test_replay_without_a_covering_checkpoint_exits_2(drill, tmp_path,
                                                      capsys):
    (tmp_path / "ckpts").mkdir()
    assert replay._cli(["--bundle", drill[2], "--checkpoint",
                        str(tmp_path / "ckpts"), "--device", "cpu"]) == 2
    assert "no checkpoint covers step 3" in capsys.readouterr().err


def test_watchdog_trip_dumps_a_bundle(tmp_path):
    from bert_pytorch_tpu_torch.resilience.watchdog import HungStepWatchdog

    rec = FlightRecorder(str(tmp_path / "bundles"), window=2,
                         run_info={}, model_config=CFG)
    rec.capture_batch({"input_ids": np.ones((2, 8), np.int32)})
    rec.record_dispatch(1, 1, np.zeros((1, 7), np.int32))
    lines, codes = [], []
    wd = HungStepWatchdog(1.0, action="abort", log=lines.append,
                          recorder=rec, exit_fn=codes.append)
    wd._trip("dispatch", 1.5)
    assert codes == [72]
    bundle = str(tmp_path / "bundles" / "step00000001_watchdog_device_hang")
    assert os.path.isdir(bundle)
    assert f"flight-recorder bundle: {bundle}" in lines[0]


def test_sigterm_walks_guard_then_recorder(tmp_path):
    """The recorder's handlers installed first, the preemption guard over
    them: a SIGTERM inside the guard's hold is noted, then raised at its
    end by the recorder's handler as SystemExit(143); closing the guard
    and then the recorder restores the original handler."""
    from bert_pytorch_tpu_torch.resilience.preemption import PreemptionGuard

    original = signal.getsignal(signal.SIGTERM)
    rec = FlightRecorder(str(tmp_path / "bundles"))
    rec.install_crash_handlers()
    guard = PreemptionGuard(log=lambda m: None)
    guard.install()
    try:
        with pytest.raises(SystemExit) as exc:
            with guard.hold():
                os.kill(os.getpid(), signal.SIGTERM)
                noted = guard.preempted_signal
        assert noted == signal.SIGTERM and exc.value.code == 143
    finally:
        guard.close()
        rec.close()
    assert signal.getsignal(signal.SIGTERM) == original
