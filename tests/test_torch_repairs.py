"""Faults of the port's pretraining slice found against the JAX package,
each pinned on the CPU at a tiny width (2 layers, E=128):

- the entry point draws the initial weights with the model config's
  `initializer_range`, as the JAX model does (bert_pytorch_tpu/models/
  bert.py), and at 0.02 draws exactly what `init_weights(std=0.02)` draws;
- a legacy premasked shard, which the JAX loader reads, is refused rather
  than skipped (skipping it trains on a subset of the data);
- a run config that switches on a feature of the JAX entry point the port
  lacks is refused rather than ignored, while keys that only tune a
  feature that is off (and the checked-in run configs) are accepted; every
  flag of the JAX entry point is accounted for in the port's table, and
  the flags ported since (--steps_per_loop, --profile_steps, --kfac and its
  tuners, the data axis's --mesh, --zero1* and --coalesce_reductions)
  left it, a --mesh beyond the data axis and --fsdp_overlap refused
  naming ROADMAP queue A item 7;
- the serving frontend's listen backlog: a burst of connections while the
  accept loop stalls gets a status each (ROADMAP queue C item 9).
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.data.sharded import ShardIndex  # noqa: E402
from bert_pytorch_tpu_torch.models.bert import (  # noqa: E402
    BertForPreTraining, init_weights)
from tests.test_data import write_shard  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_CONFIGS = {phase: os.path.join(REPO, "configs",
                                   f"bert_pretraining_phase{phase}_config.json")
               for phase in (1, 2)}
S = 32
CFG = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=64, next_sentence=True)


def _shards(root, n_files=1, legacy=()):
    root.mkdir(exist_ok=True)
    for i in range(n_files):
        write_shard(str(root / f"part_{i}.hdf5"), 16, seq=S, seed=i,
                    legacy=i in legacy)
    return root


def _model_config(tmp_path, **over):
    path = tmp_path / "tiny_config.json"
    path.write_text(json.dumps(dict(CFG, **over)))
    return str(path)


def _initial_state(tmp_path, initializer_range):
    """The train state the entry point starts from (a run of 0 steps)."""
    argv = ["--model_config_file",
            _model_config(tmp_path, initializer_range=initializer_range),
            "--input_dir", str(_shards(tmp_path / "data")),
            "--output_dir", str(tmp_path / "out"), "--local_batch_size", "4",
            "--global_batch_size", "4", "--steps", "0", "--skip_checkpoint",
            "--device", "cpu"]
    result = run_pretraining.main(argv, log=lambda m: None)
    assert result.step == 0 and not result.history
    return result.state


def _drawn_weights(model):
    """Names of the Linear and Embedding weights init_weights draws."""
    return [f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, (torch.nn.Linear, torch.nn.Embedding))]


def test_initializer_range_sets_the_initial_std(tmp_path):
    state = _initial_state(tmp_path, 0.05)
    names = _drawn_weights(BertForPreTraining(BertConfig.from_dict(CFG)))
    assert names
    draws = torch.cat([state.params[n].flatten() for n in names])
    assert abs(draws.std().item() - 0.05) <= 0.05 * 0.05
    assert abs(draws.mean().item()) <= 0.05 * 0.05


def test_initializer_range_002_draws_the_default_weights(tmp_path):
    state = _initial_state(tmp_path, 0.02)
    model = BertForPreTraining(BertConfig.from_dict(CFG),
                               dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(42), std=0.02)
    want = dict(model.named_parameters())
    assert set(want) == set(state.params)
    for name, p in want.items():
        assert torch.equal(state.params[name], p.detach()), name


def test_legacy_premasked_shard_is_refused(tmp_path):
    files = sorted(str(p) for p in
                   _shards(tmp_path / "data", 2, legacy=(1,)).glob("*.hdf5"))
    with pytest.raises(NotImplementedError, match="legacy premasked.*ROADMAP"):
        ShardIndex(files)
    # the dynamic-masking shard alone still reads
    assert len(ShardIndex(files[:1])) == 16


def test_shard_missing_input_ids_is_still_skipped(tmp_path):
    import h5py

    good = _shards(tmp_path / "data")
    bad = str(good / "part_z.hdf5")
    with h5py.File(bad, "w") as f:
        f.create_dataset("special_token_positions",
                         data=np.zeros((4, 3), np.int32))
    with pytest.warns(UserWarning, match="skipping shard"):
        index = ShardIndex(sorted(str(p) for p in good.glob("*.hdf5")))
    assert index.files == [str(good / "part_0.hdf5")]


def _run_config(tmp_path, **over):
    with open(RUN_CONFIGS[1], encoding="utf-8") as f:
        config = json.load(f)
    config.update(over)
    path = tmp_path / "run_config.json"
    path.write_text(json.dumps(config))
    return str(path)


@pytest.mark.parametrize("key,value", [
    ("stacked_params", "true"), ("mesh", "fsdp=1,model=1,seq=2"),
    ("mesh", "model=2"), ("overlap_flags", "on"), ("mesh", "fsdp=2"),
    ("fsdp_overlap", True), ("force_cpu", True), ("rng_impl", "rbg"),
    ("rng_impl", "unsafe_rbg"), ("mesh", "data=1,seq=4"),
    ("optimizer", "bert_adam")])
def test_run_config_enabling_a_missing_feature_is_refused(tmp_path, key,
                                                          value):
    argv = ["--config_file", _run_config(tmp_path, **{key: value}),
            "--model_config_file", _model_config(tmp_path),
            "--input_dir", str(_shards(tmp_path / "data")),
            "--output_dir", str(tmp_path / "out"), "--skip_checkpoint",
            "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=f"{key}=.*ROADMAP"):
        run_pretraining.main(argv, log=lambda m: None)


@pytest.mark.parametrize("phase", [1, 2])
def test_checked_in_run_configs_are_accepted(phase):
    args = run_pretraining.parse_arguments(["--config_file",
                                            RUN_CONFIGS[phase]])
    # kfac_inv_interval and kfac_factor_interval tune K-FAC, which is off
    assert args.kfac is False and args.kfac_inv_interval == 10
    run_pretraining._unsupported(args)


def test_tuning_keys_of_an_off_feature_are_accepted(tmp_path):
    args = run_pretraining.parse_arguments([
        "--config_file", _run_config(tmp_path, kfac_damping=0.01,
                                     stream_workers=8, zero1="auto",
                                     tensorboard="off", log_freq=5)])
    run_pretraining._unsupported(args)


def _parser_of(module, config_module, argv=()):
    """The argparse parser `module.parse_arguments` builds, captured at its
    call of `config_module.merge_args_with_config`."""
    real = config_module.merge_args_with_config
    seen = []

    def capture(parser, *a, **kw):
        seen.append(parser)
        return real(parser, *a, **kw)

    config_module.merge_args_with_config = capture
    try:
        module.parse_arguments(list(argv))
    finally:
        config_module.merge_args_with_config = real
    (parser,) = seen
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_refused_table_accounts_for_every_jax_flag():
    import bert_pytorch_tpu.config as jax_config
    import bert_pytorch_tpu_torch.config as port_config
    import run_pretraining as jax_entry

    jax_flags = _parser_of(jax_entry, jax_config)
    port_flags = _parser_of(run_pretraining, port_config)
    refused, tuning = run_pretraining._REFUSED, run_pretraining._TUNING
    declared = set(port_flags) - {"device"}
    # the survival and metrics planes' flags are served
    assert {"metrics_port", "log_freq", "inject_nonfinite_step",
            "watchdog_timeout", "watchdog_action", "chaos", "chaos_step",
            "chaos_stall_secs", "slo_config", "slo_eval_interval_s",
            "slo_action", "slo_halt_after_s"} <= declared
    # and packing, the flight recorder and activation checkpointing's
    assert {"packing", "packing_max_segments", "packing_lookahead",
            "flight_recorder", "recorder_window",
            "checkpoint_activations"} <= declared
    # every JAX flag is declared, a refused one too (a JAX command line
    # parses); the port adds --device alone
    assert set(jax_flags) == declared
    # every _REFUSED / _TUNING key is declared, its default among its
    # off values, and tuning keys name a refused feature
    assert set(refused) | set(tuning) <= declared
    assert not set(refused) & set(tuning)
    assert set(tuning.values()) <= set(refused)
    for dest, off in refused.items():
        assert port_flags[dest].default in off, dest
    # the flags the slices ported left the tables, at JAX's defaults
    for dest in ("stream_dir", "stream_vocab", "stream_tokenizer",
                 "stream_seq_len", "stream_workers", "stream_queue_batches",
                 "stream_inject", "h2d_prefetch", "tensorboard",
                 "steps_per_loop", "profile_steps", "kfac",
                 "kfac_inv_interval", "kfac_factor_interval",
                 "kfac_stat_decay", "kfac_damping", "kfac_kl_clip",
                 "kfac_stats_dtype", "kfac_skip_layers",
                 "kfac_factor_sync_freq"):
        assert dest not in refused and dest not in tuning, dest
        assert port_flags[dest].default == jax_flags[dest].default, dest
    # a refused flag's feature is off at values the JAX flag takes
    for dest, off in refused.items():
        flag = jax_flags[dest]
        assert off and (flag.choices is None
                        or set(off) <= {*flag.choices, flag.default}), dest
    # a declared flag takes no choice the JAX flag lacks
    for dest in declared:
        mine, theirs = port_flags[dest].choices, jax_flags[dest].choices
        assert mine is None or set(mine) <= set(theirs), dest


@pytest.mark.parametrize("argv", [
    ["--tensorboard", "off"], ["--steps_per_loop", "1"],
    ["--kfac_damping", "0.001"], ["--kfac_skip_layers", "embeddings"],
    ["--zero1", "false", "--stacked_params", "false", "--mesh_config",
     "auto", "--overlap_flags", "off", "--rng_impl", "threefry2x32"]])
def test_jax_command_lines_at_off_values_parse(argv):
    """A JAX command line that names a flag of a missing feature at its
    off value parses and passes the refusal check."""
    args = run_pretraining.parse_arguments(argv)
    run_pretraining._unsupported(args)


@pytest.mark.parametrize("argv,key", [
    (["--mesh", "data=1,fsdp=2"], "mesh"),
    (["--fsdp_overlap"], "fsdp_overlap"),
    (["--mesh", "seq=2"], "mesh"),
    (["--overlap_flags", "on"], "overlap_flags"),
    (["--force_cpu"], "force_cpu")])
def test_jax_command_lines_at_on_values_are_refused(argv, key):
    args = run_pretraining.parse_arguments(argv)
    with pytest.raises(NotImplementedError,
                       match=f"{key}=.*ROADMAP.md, queue A") as e:
        run_pretraining._unsupported(args)
    if key == "force_cpu":
        assert "--device cpu" in str(e.value)


@pytest.mark.parametrize("outcome", ["ok", "shed"])
def test_a_burst_of_connections_each_gets_a_status(outcome):
    """The serving frontend's listen backlog (ROADMAP queue C item 9):
    with its accept loop stalled, as a busy host stalls it, a burst of 64
    connections is completed by the kernel instead of dropped (a dropped
    SYN leaves the client waiting out TCP's 1 s retransmission, or
    reset: no status at all); once the loop runs again every request is
    answered, 200 or, from a full admission queue, 503 with
    Retry-After."""
    import socket
    import threading

    from bert_pytorch_tpu_torch.serving.batcher import Overloaded
    from bert_pytorch_tpu_torch.serving.frontend import ServingFrontend
    from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry

    def service(body):
        if outcome == "shed":
            raise Overloaded("request queue full (128)")
        return {"echo": body["i"]}

    fe = ServingFrontend({"echo": service}, MetricsRegistry(),
                         host="127.0.0.1")
    try:
        fe._httpd.shutdown()        # the accept loop stalls
        conns = []
        for i in range(64):
            c = socket.create_connection(("127.0.0.1", fe.port),
                                         timeout=0.5)
            body = json.dumps({"i": i}).encode()
            c.sendall(b"POST /v1/echo HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      b"Connection: close\r\nContent-Length: "
                      + str(len(body)).encode() + b"\r\n\r\n" + body)
            conns.append(c)
        threading.Thread(target=fe._httpd.serve_forever,
                         daemon=True).start()
        statuses = []
        for c in conns:
            c.settimeout(30)
            reply = b""
            while b"\r\n\r\n" not in reply:
                chunk = c.recv(4096)
                if not chunk:
                    break
                reply += chunk
            statuses.append(reply.split(b" ", 2)[1].decode())
            if outcome == "shed":
                assert b"Retry-After: 1" in reply
            c.close()
    finally:
        fe.close()
    want = {"ok": "200", "shed": "503"}[outcome]
    assert statuses == [want] * 64


@pytest.mark.parametrize("argv", [
    ["--kfac_bucket_mb", "8"], ["--kfac", "--kfac_bucket_mb", "16"],
    ["--kfac", "--steps_per_loop", "4", "--profile_steps", "2,3"]])
def test_kfac_bucket_mb_is_still_accepted(argv):
    """--kfac_bucket_mb sizes K-FAC's coalesced factor reductions over
    several ranks, which stay refused (ROADMAP queue A item 7, at run
    time); the flag is accepted at any value with K-FAC on or off, and
    --kfac, --steps_per_loop and --profile_steps run."""
    assert "kfac_bucket_mb" not in run_pretraining._REFUSED
    assert "kfac_bucket_mb" not in run_pretraining._REFUSED_PARALLEL
    args = run_pretraining.parse_arguments(argv)
    run_pretraining._unsupported(args)


@pytest.mark.parametrize("spec", ["3", "4,2", "a,b", "-1,2"])
def test_profile_steps_wants_a_step_range(spec):
    with pytest.raises(SystemExit):
        run_pretraining.parse_arguments(["--profile_steps", spec])

