"""What the finetuning slice left out, in the port, against the JAX
package where it has a counterpart, on the CPU:

- the SIGTERM emergency save: a `run_finetune --device cpu` process gets
  SIGTERM after its first logged step, exits 143 and leaves the last
  completed step's checkpoint, whose integrity sidecar verifies and which
  `--init_checkpoint` reads; a failure that is no preemption saves
  nothing; the guard's hold defers a signal to the end of the step;
- NER's jsonl `val` and `test` records: JAX's tags, keys and steps;
- SQuAD's --eval_script: parsed and ignored, as JAX does;
- `bert_adam` against JAX's over a few steps.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bert_pytorch_tpu.optim import adam as jadam  # noqa: E402
from bert_pytorch_tpu_torch.optim import adam as tadam  # noqa: E402
from bert_pytorch_tpu_torch.optim.lamb import (  # noqa: E402
    default_weight_decay_mask)
from bert_pytorch_tpu_torch.resilience.preemption import (  # noqa: E402
    PreemptionGuard, finetune_emergency_save, is_preemption_exit)
from bert_pytorch_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointManager)
from tests.test_torch_tasks import _task_argv, task_files  # noqa: E402

PARAM_RTOL = 1e-4


def _jsonl(path):
    return [json.loads(x) for x in open(path, encoding="utf-8")
            .read().splitlines()]


def test_sigterm_saves_the_last_completed_step(tmp_path):
    cfg, files = task_files(tmp_path / "data", "classify", n_train=16)
    out = tmp_path / "out"
    argv = _task_argv("classify", cfg, files, out)
    argv[argv.index("--epochs") + 1] = "100000"
    proc = subprocess.Popen(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.run_finetune",
         "--task", "classify", "--device", "cpu"] + argv,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=REPO))
    log = out / "classify_log.jsonl"
    deadline = time.time() + 120
    try:
        while time.time() < deadline and proc.poll() is None:
            if log.exists() and any(r["tag"] == "train"
                                    for r in _jsonl(log)):
                break
            time.sleep(0.05)
        assert proc.poll() is None, proc.communicate()[0][-3000:]
        proc.send_signal(signal.SIGTERM)
        text = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 143, text[-3000:]
    assert "emergency checkpoint saved at step" in text, text[-3000:]
    mgr = CheckpointManager(str(out / "ckpt"))
    steps = mgr.all_steps()
    assert len(steps) == 1 and steps[0] >= 2
    assert mgr.verify(steps[0]) == []
    state, extra, _ = mgr.restore()
    assert extra == {"task": "classify", "emergency": True}
    assert state["step"] == steps[0] == state["opt_state"]["count"]
    # --init_checkpoint reads it: weights only, into a fresh run
    from bert_pytorch_tpu_torch import run_finetune

    lines = []
    run_finetune.main(["--task", "classify", "--device", "cpu",
                       "--init_checkpoint", str(out / "ckpt")]
                      + _task_argv("classify", cfg, files, tmp_path / "o2"),
                      log=lines.append)
    assert any(ln.startswith(f"init_checkpoint step {steps[0]}: loaded ")
               for ln in lines), lines


def test_a_failure_that_is_no_preemption_saves_nothing(tmp_path):
    import dataclasses

    from bert_pytorch_tpu_torch.tasks import registry
    from bert_pytorch_tpu_torch.training.finetune import run_task

    cfg, files = task_files(tmp_path / "data", "classify")
    spec = registry.get("classify")
    calls = []

    def setup(args, config, device, log, record):
        run = spec.setup(args, config, device, log, record)

        def builder(model):
            loss_fn = run.loss_builder(model)

            def failing(params, micro, seeds):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("planted failure")
                return loss_fn(params, micro, seeds)
            return failing
        return dataclasses.replace(run, loss_builder=builder)

    args = spec.parse_arguments(_task_argv("classify", cfg, files,
                                           tmp_path / "o")
                                + ["--device", "cpu"])
    with pytest.raises(RuntimeError, match="planted failure"):
        run_task(dataclasses.replace(spec, setup=setup), args,
                 log=lambda m: None)
    assert not os.path.exists(tmp_path / "o" / "ckpt")


def test_the_guard_defers_a_signal_to_the_end_of_the_step(tmp_path):
    from bert_pytorch_tpu_torch.training.state import TrainState

    guard = PreemptionGuard(log=lambda m: None)
    events = []
    with pytest.raises(SystemExit) as e:
        with guard.hold():
            guard._on_signal(signal.SIGTERM, None)
            events.append("the step finished")
    assert events == ["the step finished"]
    assert e.value.code == 143 and is_preemption_exit(e.value)
    # a repeat signal during the save is ignored
    guard._on_signal(signal.SIGTERM, None)
    state = TrainState(step=3, params={"w": torch.ones(2)},
                       opt_state=tadam.FusedAdam(1e-3).init(
                           {"w": torch.ones(2)}))
    state.opt_state.count = 3
    finetune_emergency_save(guard, e.value, {"state": state, "step": 3},
                            str(tmp_path / "ckpt"), "classify",
                            log=lambda m: None)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == [3] and mgr.verify(3) == []
    # nothing completed yet: nothing to save
    finetune_emergency_save(guard, e.value, {}, str(tmp_path / "none"),
                            "classify", log=lambda m: None)
    assert not os.path.exists(tmp_path / "none")
    assert not is_preemption_exit(RuntimeError("x"))
    assert not is_preemption_exit(SystemExit(1))


def test_ner_jsonl_val_and_test_records_equal_jax(tmp_path):
    """run_ner on the same files, JAX's and the port's: the val record at
    each epoch's last step and the test record at the last step, with
    JAX's keys."""
    import run_ner as jax_run_ner
    from bert_pytorch_tpu_torch import run_ner
    from tests.test_torch_ner import _files, _ner_argv

    files = _files(tmp_path)
    jax_run_ner.main(_ner_argv(*files, tmp_path / "jax"))
    run_ner.main(_ner_argv(*files, tmp_path / "port") + ["--device", "cpu"],
                 log=lambda m: None)

    def records(side):
        return [r for r in _jsonl(tmp_path / side / "ner_log.jsonl")
                if r["tag"] in ("val", "test")]

    got, want = records("port"), records("jax")
    assert [(r["tag"], r["step"], sorted(r)) for r in got] == [
        (r["tag"], r["step"], sorted(r)) for r in want]
    assert [r["tag"] for r in got] == ["val", "val", "test"]
    assert [r["epoch"] for r in got if r["tag"] == "val"] == [0, 1]
    for r in got:
        assert 0.0 <= r["macro_f1"] <= 1.0 and np.isfinite(r["loss"])


def test_squad_accepts_eval_script_and_ignores_it():
    from bert_pytorch_tpu.tasks import squad_task as jsquad
    from bert_pytorch_tpu_torch.tasks import squad_task

    args = squad_task.parse_arguments(["--eval_script", "evaluate-v1.1.py"])
    assert args.eval_script == "evaluate-v1.1.py"
    assert "eval_script" not in squad_task._REFUSED
    jargs = jsquad.parse_arguments(["--eval_script", "evaluate-v1.1.py"])
    assert jargs.eval_script == args.eval_script
    action = {a.dest: a for a in squad_task.build_parser()._actions}
    assert "unused" in action["eval_script"].help


@pytest.mark.parametrize("masked", [False, True])
def test_bert_adam_matches_jax(masked):
    rng = np.random.RandomState(3)
    shapes = {"bert.encoder.layers.0.intermediate.weight": (8, 6),
              "bert.encoder.layers.0.intermediate.bias": (8,),
              "bert.embeddings.layer_norm.scale": (6,),
              "classifier.weight": (2, 6)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def schedule(step):
        return 1e-2 / (1.0 + step)

    jmask = ((lambda p: {k: default_weight_decay_mask(k) for k in p})
             if masked else None)
    jtx = jadam.bert_adam(schedule, weight_decay_mask=jmask,
                          max_grad_norm=1.0)
    ttx = tadam.bert_adam(schedule, weight_decay_mask=(
        default_weight_decay_mask if masked else None), max_grad_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for step in range(4):
        grads = {k: (rng.randn(*s) * (3.0 if step == 1 else 0.1)).astype(
            np.float32) for k, s in shapes.items()}
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in
                                      grads.items()}, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        ttx.update({k: torch.from_numpy(v) for k, v in grads.items()},
                   tstate, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=PARAM_RTOL, atol=1e-7,
                                       err_msg=f"{k} step {step}")
    assert tstate.count == 4
