"""Pretraining's survival and metrics planes in the port, against the JAX
package where it has a counterpart, on the CPU at a tiny width (2 layers,
E=32, seq 32, accumulation 2):

- the health pack: `health_update` over a run of grad norms with a spike
  and a non-finite step against JAX's (each metric within 1e-6
  relative); the skip path leaves params, moments and the carry
  bit-unchanged; the NaN drill poisons what JAX's poisons;
- exit codes: `--nonfinite_action halt` exits 71 (a traceback and exit 1
  before this slice), the SIGTERM drill exits 143 with an emergency
  checkpoint that verifies and a resume bit-equal to an uninterrupted
  run, the chaos drills under the port's supervisor (a corrupt newest
  checkpoint is quarantined and the run falls back; a SIGKILLed run
  restarts and sails past the step), the watchdog's abort (72 for a
  device-side phase, 73 for data_wait) and warn;
- the metrics plane: MetricsServer's /metrics and /healthz, the
  pretraining jsonl's tags and keys against JAX's step metrics, a train
  SLO that pages and halts (76) on a planted step-time breach, and
  `run_finetune --metrics_port 0 --watchdog_timeout 30`.
"""

import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bert_pytorch_tpu.telemetry import health as jhealth  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.resilience.watchdog import (  # noqa: E402
    HungStepWatchdog)
from bert_pytorch_tpu_torch.telemetry import health as phealth  # noqa: E402
from bert_pytorch_tpu_torch.telemetry.registry import (  # noqa: E402
    MetricsRegistry, parse_prometheus)
from bert_pytorch_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointManager)
from tests.test_data import write_shard  # noqa: E402

HEALTH_RTOL = 1e-6
CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=64, next_sentence=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("survival")
    (d / "data").mkdir()
    write_shard(str(d / "data" / "s0.hdf5"), 48, seq=32, seed=0)
    write_shard(str(d / "data" / "s1.hdf5"), 48, seq=32, seed=1)
    (d / "cfg.json").write_text(json.dumps(CFG))
    return d


def _argv(data, out, *extra):
    return ["--model_config_file", str(data / "cfg.json"),
            "--input_dir", str(data / "data"), "--output_dir", str(out),
            "--local_batch_size", "4", "--global_batch_size", "8",
            "--max_steps", "4", "--max_predictions_per_seq", "6",
            "--log_freq", "1", "--device", "cpu", *extra]


def _entry(args, env=None, timeout=180):
    """`python -m bert_pytorch_tpu_torch.run_pretraining args` -> (rc,
    output)."""
    r = subprocess.run(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.run_pretraining",
         *args], cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))
    return r.returncode, r.stdout + r.stderr


def _records(out, tag="train"):
    with open(os.path.join(out, "logfile.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == tag]


def _final_params(out):
    mgr = CheckpointManager(os.path.join(out, "pretrain_ckpts"))
    return mgr.restore()[0]


@pytest.fixture(scope="module")
def clean(data, tmp_path_factory):
    """The uninterrupted 4-step run (in-process), its final checkpoint."""
    out = tmp_path_factory.mktemp("clean")
    run_pretraining.main(_argv(data, out), log=lambda m: None)
    return out


# -- the health pack ----------------------------------------------------------

def test_health_update_matches_jax():
    """A run of 16 steps: warmup, a steady stretch, a spike, a non-finite
    step and a recovery, with the parameters moving a little each step;
    every metric and the carry against JAX's within 1e-6 relative."""
    rng = np.random.RandomState(0)
    norms = list(1.0 + 0.05 * rng.randn(12)) + [40.0, np.nan, 1.02, 0.98]
    jcfg, pcfg = jhealth.HealthConfig(), phealth.HealthConfig()
    jt, pt = None, None
    params = [rng.randn(5, 3).astype(np.float32),
              rng.randn(7).astype(np.float32)]
    spikes = []
    for i, g in enumerate(norms):
        params = [p * np.float32(1 + 1e-3 * (i % 3)) for p in params]
        bad = not np.isfinite(g)
        jt, jm = jhealth.health_update(
            jcfg, jt, jnp.float32(g), jnp.asarray(bad),
            {"a": jnp.asarray(params[0]), "b": jnp.asarray(params[1])})
        pt, pm = phealth.health_update(
            pcfg, pt, torch.tensor(g, dtype=torch.float32),
            torch.tensor(bad), [torch.from_numpy(p) for p in params])
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k].item(), float(v),
                                       rtol=HEALTH_RTOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        for k in ("grad_norm_ema", "grad_norm_var", "param_norm_prev"):
            np.testing.assert_allclose(getattr(pt, k).item(),
                                       float(getattr(jt, k)),
                                       rtol=HEALTH_RTOL, err_msg=k)
        assert pt.count.item() == int(jt.count)
        spikes.append(pm["grad_spike"].item())
    assert spikes[12] == 1 and sum(spikes) == 1
    assert pt.count.item() == len(norms) - 1          # the NaN is not folded


def _tiny_port_step(health, inject=None):
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.models.bert import (BertForPreTraining,
                                                    init_weights)
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    model = BertForPreTraining(BertConfig.from_dict(CFG),
                               dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    tx = Lamb(1e-3)
    state = make_train_state(model, tx)
    if health is not None:
        state.telemetry = phealth.init_telemetry_state()
    step = build_pretrain_step(model, tx, schedule=lambda s: 1e-3,
                               max_predictions=6, health=health,
                               nan_inject_step=inject)
    return state, step


def _tiny_batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 128, (1, 4, 32))
    labels = np.full((1, 4, 32), -1)
    labels[..., 3:8] = ids[..., 3:8]
    return {"input_ids": torch.from_numpy(ids),
            "token_type_ids": torch.zeros(1, 4, 32, dtype=torch.long),
            "attention_mask": torch.ones(1, 4, 32, dtype=torch.long),
            "masked_lm_labels": torch.from_numpy(labels),
            "next_sentence_labels": torch.zeros(1, 4, dtype=torch.long)}


def test_skip_leaves_state_and_carry_bit_unchanged():
    """Under action skip a poisoned step (the NaN drill at step 2) leaves
    the parameters, the moments, the optimizer's count and the health
    carry as step 1 left them; step 3 trains on."""
    state, step = _tiny_port_step(phealth.HealthConfig(action="skip"),
                                  inject=2)
    m1 = step(state, _tiny_batch(1), None)
    assert m1["skipped_nonfinite"] == 0
    before = {k: v.clone() for k, v in state.state_dict()["params"].items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    carry = {k: v.clone() for k, v in vars(state.telemetry).items()}
    m2 = step(state, _tiny_batch(2), None)
    assert m2["skipped_nonfinite"] == 1 and m2["loss_nonfinite"].item() == 1
    assert state.step == 2 and state.opt_state.count == 1
    for k, v in before.items():
        assert torch.equal(state.params[k], v), k
    for k, v in mu.items():
        assert torch.equal(state.opt_state.mu[k], v), k
    for k, v in carry.items():
        assert torch.equal(getattr(state.telemetry, k), v), k
    assert m2["param_norm_drift"].item() == 0.0
    m3 = step(state, _tiny_batch(3), None)
    assert m3["skipped_nonfinite"] == 0 and state.opt_state.count == 2
    assert np.isfinite(m3["loss"].item())


def test_nan_drill_poisons_what_jax_poisons():
    """--inject_nonfinite_step's NaN at JAX's parameter: the per-group
    non-finite gradient counts of the poisoned step equal the JAX step's,
    and the step before it is clean."""
    from tests import test_torch_pretrain as tp

    from bert_pytorch_tpu.training import pretrain as jax_pretrain
    from bert_pytorch_tpu.training.state import TrainState as JaxState
    from bert_pytorch_tpu.training.state import unbox
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.training.pretrain import build_pretrain_step
    from bert_pytorch_tpu_torch.training.state import make_train_state

    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jmodel = tp._jax_model(**no_drop)
    batch = tp._batch(5)
    jb = {k: jnp.asarray(v)[None] for k, v in batch.items()}
    params = unbox(jmodel.init(jax.random.PRNGKey(0), jb["input_ids"][0],
                               jb["token_type_ids"][0],
                               jb["attention_mask"][0])["params"])
    tx = tp._jax_lamb(lambda s: 1e-3)
    jstep = jax.jit(jax_pretrain.build_pretrain_step(
        jmodel, tx, max_predictions=tp.P, nan_inject_step=1,
        health=jhealth.HealthConfig()))
    jstate = JaxState(step=jnp.zeros([], jnp.int32), params=params,
                      opt_state=tx.init(params),
                      telemetry=jhealth.init_telemetry_state())
    _, jm = jstep(jstate, jb, jax.random.PRNGKey(0))
    model = tp._port_model(tp._flat(params), **no_drop)
    ptx = Lamb(1e-3)
    pstate = make_train_state(model, ptx)
    pstep = build_pretrain_step(model, ptx, max_predictions=tp.P,
                                health=phealth.HealthConfig(),
                                nan_inject_step=1)
    pm = pstep(pstate, tp._torch_batch(batch, accum=1), None)
    groups = sorted(k for k in jm if k.startswith("grad_nonfinite"))
    assert groups == sorted(k for k in pm if k.startswith("grad_nonfinite"))
    for k in groups + ["loss_nonfinite"]:
        assert pm[k].item() == int(jm[k]), k
    assert pm["grad_nonfinite"].item() > 0


# -- exit codes, the SIGTERM drill, the supervisor -----------------------------

def test_nonfinite_halt_exits_71(data, tmp_path):
    """The fault this slice repairs: a tripped --nonfinite_action halt
    exits EXIT_NONFINITE_HALT (71), which the supervisor does not retry,
    with a one-line FATAL; no checkpoint is saved past the bad step."""
    rc, text = _entry(_argv(data, tmp_path, "--health_pack", "on",
                            "--nonfinite_action", "halt",
                            "--inject_nonfinite_step", "2"))
    assert rc == 71, text[-3000:]
    assert "FATAL: non-finite loss/gradients at step 2" in text
    assert "Traceback" not in text
    assert CheckpointManager(str(tmp_path / "pretrain_ckpts")).all_steps() \
        == []


def test_sigterm_saves_the_last_completed_step_and_resumes_bit_equal(
        data, clean, tmp_path):
    """--chaos sigterm_at_step 3: exit 143 after the emergency checkpoint
    of step 2 (sidecar verified, the sampler cursor of the last batch
    trained on); the resume (health pack off) ends bit-equal to the
    uninterrupted run: every logged loss and every saved tensor. The
    checkpoints with the pack on and off hold the same keys."""
    rc, text = _entry(_argv(data, tmp_path, "--chaos", "sigterm_at_step",
                            "--chaos_step", "3"))
    assert rc == 143, text[-3000:]
    assert "emergency checkpoint saved at step 2" in text
    mgr = CheckpointManager(str(tmp_path / "pretrain_ckpts"))
    assert mgr.all_steps() == [2] and mgr.verify(2) == []
    emergency, extra, _ = mgr.restore(2)
    whole, whole_extra, _ = CheckpointManager(
        str(clean / "pretrain_ckpts")).restore()
    assert set(emergency) == set(whole)
    assert set(emergency["params"]) == set(whole["params"])
    assert extra["sampler"]["index"] == 16        # two steps of 8 samples
    resumed = run_pretraining.main(_argv(data, tmp_path, "--health_pack",
                                         "off"), log=lambda m: None)
    assert resumed.resumed_from == 2 and resumed.step == 4
    final = _final_params(tmp_path)
    for part in ("params",):
        for k, v in whole[part].items():
            assert torch.equal(final[part][k], v), k
    for what in ("mu", "nu"):
        for k, v in whole["opt_state"][what].items():
            assert torch.equal(final["opt_state"][what][k], v), (what, k)
    assert ([r["step_loss"] for r in _records(tmp_path)]
            == [r["step_loss"] for r in _records(clean)])
    assert extra["sampler"] != whole_extra["sampler"]


def _supervise(data, out, *extra):
    from bert_pytorch_tpu_torch.tools.supervise import ENTRY, supervise

    lines = []
    rc = supervise([sys.executable, "-m", ENTRY, *_argv(data, out, *extra)],
                   str(out / "pretrain_ckpts"), backoff_base=0.0,
                   env=dict(os.environ, PYTHONPATH=REPO),
                   sleep=lambda s: None, log=lines.append)
    return rc, lines


def test_corrupt_newest_checkpoint_under_the_supervisor(data, clean,
                                                        tmp_path):
    """corrupt_newest_ckpt at step 2: the child flips bytes of step 2's
    state.pt and SIGKILLs itself; the restart quarantines step 2
    (`2.corrupt`), resumes step 1 and ends where the clean run ends."""
    rc, lines = _supervise(data, tmp_path, "--num_steps_per_checkpoint",
                           "1", "--chaos", "corrupt_newest_ckpt",
                           "--chaos_step", "2")
    assert rc == 0, lines
    assert any("killed by SIGKILL" in ln for ln in lines)
    assert os.path.isdir(tmp_path / "pretrain_ckpts" / "2.corrupt")
    assert ([r["step_loss"] for r in _records(tmp_path)][-3:]
            == [r["step_loss"] for r in _records(clean)][1:])


def test_sigkill_under_the_supervisor_sails_past_the_step(data, clean,
                                                          tmp_path):
    rc, lines = _supervise(data, tmp_path, "--num_steps_per_checkpoint",
                           "1", "--chaos", "sigkill_at_step",
                           "--chaos_step", "3")
    assert rc == 0, lines
    assert sum(ln.startswith("attempt ") for ln in lines) == 2
    assert ([r["step_loss"] for r in _records(tmp_path)]
            == [r["step_loss"] for r in _records(clean)])
    final = _final_params(tmp_path)
    for k, v in _final_params(clean)["params"].items():
        assert torch.equal(final["params"][k], v), k


def test_supervisor_does_not_retry_a_halt(data, tmp_path):
    rc, lines = _supervise(data, tmp_path, "--nonfinite_action", "halt",
                           "--inject_nonfinite_step", "1")
    assert rc == 71 and any("no-retry set" in ln for ln in lines)


# -- the watchdog ---------------------------------------------------------------

@pytest.mark.parametrize("phase,code", [("dispatch", 72),
                                        ("metric_flush", 72),
                                        ("data_wait", 73)])
def test_watchdog_classifies_the_stalled_phase(tmp_path, phase, code):
    """abort: the exit code by the phase (the card's queue waits in
    metric_flush's .item(), so it is device-side); the stacks file and
    the counter."""
    exits = []
    reg = MetricsRegistry(constant_labels={"phase": "pretrain"})
    wd = HungStepWatchdog(0.2, action="abort", registry=reg,
                          log=lambda m: None, out_dir=str(tmp_path),
                          exit_fn=exits.append).start()
    try:
        wd.on_phase(phase, True)
        deadline = __import__("time").time() + 10
        while not exits and __import__("time").time() < deadline:
            __import__("time").sleep(0.05)
    finally:
        wd.close()
    assert exits == [code]
    kind = "input_starvation" if code == 73 else "device_hang"
    assert wd.last_stall["kind"] == kind
    assert any(f.startswith("watchdog_stacks_") for f in os.listdir(tmp_path))
    series = parse_prometheus(reg.render_prometheus())
    assert series["bert_watchdog_stalls_total"][
        f'{{phase="pretrain",kind="{kind}"}}'] == 1


def test_watchdog_abort_and_warn_in_a_run(data, tmp_path):
    """--chaos stall_dispatch: with abort the process exits 72; with warn
    it logs one trip, writes the stacks and finishes."""
    stall = ["--skip_checkpoint", "--chaos", "stall_dispatch",
             "--chaos_step", "2", "--chaos_stall_secs", "3",
             "--watchdog_timeout", "1.5"]
    rc, text = _entry(_argv(data, tmp_path / "a", *stall))
    assert rc == 72, text[-3000:]
    assert "classified device_hang" in text
    lines = []
    res = run_pretraining.main(_argv(data, tmp_path / "w", *stall,
                                     "--watchdog_action", "warn"),
                               log=lines.append)
    assert res.step == 4
    # the stall trips once, between step 1's line and step 2's (a CPU
    # under load may trip on a slow step too; warn goes on either way)
    during = lines[next(i for i, ln in enumerate(lines)
                        if ln.startswith("step 1:")):
                   next(i for i, ln in enumerate(lines)
                        if ln.startswith("step 2:"))]
    assert sum(ln.startswith("WATCHDOG: phase 'dispatch'")
               for ln in during) == 1
    assert any(f.startswith("watchdog_stacks_")
               for f in os.listdir(tmp_path / "w"))


# -- the metrics plane -----------------------------------------------------------

def test_metrics_server_serves_metrics_and_healthz():
    from bert_pytorch_tpu_torch.telemetry.run import init_run

    tel = init_run("pretrain", echo=lambda m: None, metrics_port=0)
    try:
        sw = tel.make_stepwatch(flops_per_step=1e9, seqs_per_step=8,
                                seq_len=32, peak_flops=None, log_freq=1)
        tel.log_train(1, step_loss=1.0, loss_nonfinite=1, grad_nonfinite=0)
        tel.log_perf(1, sw.step_done())
        base = tel.server.url
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        series = parse_prometheus(text.decode())
        assert series["bert_train_steps_total"]['{phase="pretrain"}'] == 1
        assert series["bert_nonfinite_steps_total"][
            '{phase="pretrain"}'] == 1
        assert '{phase="pretrain"}' in series["bert_step_time_ms"]
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=10).read())
        assert health["status"] == "ok" and health["last_step"] == 1
        assert health["last_nonfinite_step"] == 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        tel.close()


def _jax_train_keys():
    """The keys JAX's loop logs in a train record: its step's metrics
    (the health pack on) less `loss`, plus epoch, average_loss and
    step_loss (run_pretraining.py's tel.log_train)."""
    from tests import test_torch_pretrain as tp

    from bert_pytorch_tpu.training import pretrain as jax_pretrain
    from bert_pytorch_tpu.training.state import TrainState as JaxState

    jmodel = tp._jax_model()
    batch = {k: jnp.asarray(v)[None] for k, v in tp._batch(5).items()}
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), batch["input_ids"][0],
        batch["token_type_ids"][0], batch["attention_mask"][0])["params"])
    tx = tp._jax_lamb(lambda s: 1e-3)
    step = jax_pretrain.build_pretrain_step(
        jmodel, tx, schedule=lambda s: 1e-3, accum_steps=1,
        max_predictions=tp.P, health=jhealth.HealthConfig())

    def run(p):
        state = JaxState(step=jnp.zeros([], jnp.int32), params=p,
                         opt_state=tx.init(p),
                         telemetry=jhealth.init_telemetry_state())
        return step(state, batch, jax.random.PRNGKey(0))[1]

    metrics = jax.eval_shape(run, params)
    return (set(metrics) - {"loss"}) | {"epoch", "average_loss",
                                        "step_loss"}


def test_pretraining_records_carry_jax_tags_and_keys(clean):
    """The jsonl: one header, a train record a step with exactly JAX's
    keys, and perf records with JAX's core keys and its host phases."""
    from bert_pytorch_tpu.telemetry.run import PERF_RECORD_CORE_KEYS

    with open(clean / "logfile.jsonl") as f:
        recs = [json.loads(x) for x in f]
    assert [r["tag"] for r in recs].count("header") == 1
    train = [r for r in recs if r["tag"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    want = _jax_train_keys() | {"tag", "step", "time"}
    for r in train:
        assert set(r) == want, set(r) ^ want
    perf = [r for r in recs if r["tag"] == "perf"]
    assert len(perf) == 4
    for r in perf:
        assert set(PERF_RECORD_CORE_KEYS) <= set(r)
        assert {"data_wait_ms", "h2d_ms", "dispatch_ms",
                "metric_flush_ms"} <= set(r)
    with open(clean / "logfile_metrics.csv") as f:
        header = f.readline().strip().split(",")
    assert {"tag", "step", "step_loss", "step_time_ms"} <= set(header)


def test_train_slo_pages_and_halts_on_a_step_time_breach(data, tmp_path):
    """configs/slo.json's step_time spec with a planted bound of 1 us and
    one-second windows: the page fires, /healthz fails, and --slo_action
    halt exits EXIT_SLO_BREACH (76)."""
    with open(os.path.join(REPO, "configs", "slo.json")) as f:
        cfg = json.load(f)
    spec = dict(next(s for s in cfg["train"] if s["name"] == "step_time"),
                bound=0.001)
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({
        "windows": {"page": {"short_s": 0.3, "long_s": 0.6,
                             "burn_rate": 14.4},
                    "ticket": {"short_s": 0.3, "long_s": 0.6,
                               "burn_rate": 6.0}},
        "train": [spec]}))
    lines = []
    argv = _argv(data, tmp_path, "--skip_checkpoint", "--max_steps",
                 "100000", "--slo_config", str(slo), "--slo_action", "halt",
                 "--slo_eval_interval_s", "0.05", "--slo_halt_after_s",
                 "0.2")
    rc = run_pretraining.exit_code_of(
        lambda: run_pretraining.main(argv, log=lines.append))
    assert rc == 76
    assert any("SLO" in ln and "step_time" in ln and "firing" in ln
               for ln in lines), lines[-20:]


def test_run_finetune_serves_metrics_and_arms_the_watchdog(tmp_path):
    """The two finetune flags this slice lifts: the run trains with the
    exporter up and the watchdog armed, and logs both."""
    from bert_pytorch_tpu_torch import run_finetune
    from tests.test_torch_tasks import _task_argv, task_files

    cfg, files = task_files(tmp_path / "data", "classify")
    lines = []
    got = run_finetune.main(
        ["--task", "classify", "--device", "cpu", "--metrics_port", "0",
         "--watchdog_timeout", "30"]
        + _task_argv("classify", cfg, files, tmp_path / "out"),
        log=lines.append)
    assert "test_accuracy" in got
    assert any(ln.startswith("metrics: serving /metrics") for ln in lines)
    assert any(ln.startswith("watchdog: armed at 30s") for ln in lines)


class _SlowLoss:
    """A step's loss whose readback stalls, as a wedged card stalls it."""

    def __init__(self, loss, secs):
        self.loss, self.secs = loss, secs

    def __float__(self):
        import time

        time.sleep(self.secs)
        return float(self.loss)


@pytest.mark.parametrize("phase", ["h2d", "metric_flush"])
def test_run_finetune_watchdog_trips_on_a_stalled_device_wait(
        tmp_path, monkeypatch, phase):
    """The finetune loop's two waits for the card are watched phases: a
    stall planted in the batch's copy or in the loss's readback trips the
    watchdog as a device hang (under warn the run goes on). A busy host
    may trip it in other phases too; the planted one must be among them."""
    import time

    from bert_pytorch_tpu_torch import run_finetune
    from bert_pytorch_tpu_torch.training import finetune
    from tests.test_torch_tasks import _task_argv, task_files

    stall_s = 3.0
    if phase == "h2d":
        calls = []
        real_to_device = finetune.to_device

        def to_device(batch, device):
            calls.append(1)
            if len(calls) == 1:           # the first training batch
                time.sleep(stall_s)
            return real_to_device(batch, device)

        monkeypatch.setattr(finetune, "to_device", to_device)
    else:
        real_build = finetune.build_pretrain_step

        def build(*a, **kw):
            step_fn = real_build(*a, **kw)

            def step(state, batch, seeds):
                metrics = step_fn(state, batch, seeds)
                metrics["loss"] = _SlowLoss(metrics["loss"], stall_s)
                return metrics
            return step

        monkeypatch.setattr(finetune, "build_pretrain_step", build)
    cfg, files = task_files(tmp_path / "data", "classify")
    out = tmp_path / "out"
    lines = []
    got = run_finetune.main(
        ["--task", "classify", "--device", "cpu", "--watchdog_timeout",
         "1", "--watchdog_action", "warn"]
        + _task_argv("classify", cfg, files, out), log=lines.append)
    assert "test_accuracy" in got
    trips = [ln for ln in lines if ln.startswith("WATCHDOG:")]
    assert any(f"phase '{phase}' stalled" in ln and "device_hang" in ln
               for ln in trips), lines
    assert list(out.glob("watchdog_stacks_*_device_hang.txt"))


def test_chip_smoke_survival_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's survival phase at a tiny width on the CPU: the
    clean run with /metrics scraped mid-run, the SIGTERM child and the
    bit-equal resume with its crash bundle, the stall under warn with the
    skipped NaN step and the watchdog's bundle, the recorder drill (the
    halt child's bundle replayed and bisected in a process of its own;
    the launch counts apply on the card only)."""
    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(CFG, vocab_size=30522,
                                   max_position_embeddings=128,
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)))
    summary = {}
    chip_smoke.phase_survival(torch, np, summary, device="cpu",
                              cfg_path=str(cfg), watchdog_s=2.0,
                              stall_s=3.5, micro=4)
    res = summary["survival"]
    assert len(res["losses"]) == chip_smoke.SURVIVAL_STEPS
    assert res["emergency_save_s"] >= 0 and res["restore_s"] >= 0
    assert res["stall"]["stalls_on_metrics"] == {
        '{phase="pretrain",kind="device_hang"}': res["stall"]["trips"]}
    assert res["launches"] == {k: 0 for k in res["launches"]}
    assert "bert_watchdog_stalls_total" not in res["metrics_families"]
    assert {"bert_train_steps_total", "bert_mfu",
            "bert_nonfinite_steps_total"} <= set(res["metrics_families"])
    assert res["sigterm_bundles"] == ["step00000002_systemexit"]
    assert "step00000002_watchdog_device_hang" in res["stall"]["bundles"]
    assert res["halt_bundle"] == "step00000002_nonfinite"
    assert res["replay"][0].startswith(
        "step 2 (from checkpoint 1): REPRODUCED bit-identically")
    assert res["replay"][1] == ("bisect: first non-finite tensor in scope "
                                "'layer_0/attention' (microbatch 0)")
