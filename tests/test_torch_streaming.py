"""The port's streaming data plane (bert_pytorch_tpu_torch/data/streaming.py)
against the JAX package's loader, on the CPU, over seeded corpora: the
batches bit for bit (unpacked and packed, 1 and 3 workers, assembly
prefetch 0 and 2, the epoch remask, a resume mid-stream with the packer's
pending cursors, world size 2, each --stream_inject drill), the refusal of
a changed source list, the CLI's plane validation against JAX's, the
TensorBoard sink's scalars against JAX's MetricLogger, and
run_pretraining --stream_dir end to end: a checkpoint and a bit-equal
resume, its first loss against the port's step on JAX's first streamed
batch, a streaming repro bundle that validates and replays."""

import json
import os
import shutil
import sys
import warnings

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.data import streaming as jstream  # noqa: E402
from bert_pytorch_tpu.data.tokenization import \
    BertWordPieceTokenizer as JaxWordPiece  # noqa: E402
from bert_pytorch_tpu.telemetry.registry import \
    MetricsRegistry as JaxRegistry  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.data import streaming as pstream  # noqa: E402
from bert_pytorch_tpu_torch.data.tokenization import \
    BertWordPieceTokenizer as PortWordPiece  # noqa: E402
from bert_pytorch_tpu_torch.telemetry.registry import \
    MetricsRegistry  # noqa: E402
from tests.test_streaming import (MASK_ID, SPECIALS, VOCAB,  # noqa: E402
                                  WORDS, write_corpus, write_vocab)

CFG = dict(vocab_size=len(SPECIALS + WORDS), hidden_size=32,
           num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=64, next_sentence=True)


def _loader(mod, tok, corpus, **kw):
    kw = dict(dict(batch_size=4, seq_len=16, mask_token_index=MASK_ID,
                   max_pred_per_seq=3, masked_lm_prob=0.15,
                   vocab_size=len(VOCAB), seed=7, packing_max_segments=4,
                   packing_lookahead=2), **kw)
    return mod.StreamingPretrainingLoader(
        mod.discover_sources(str(corpus)), tok(VOCAB), **kw)


def jax_loader(corpus, **kw):
    return _loader(jstream, JaxWordPiece, corpus, **kw)


def port_loader(corpus, **kw):
    return _loader(pstream, PortWordPiece, corpus, **kw)


def drain(loader, n=None):
    out = []
    while n is None or len(out) < n:
        try:
            out.append(next(loader))
        except StopIteration:
            break
    return out


def cursor(state):
    return {k: v for k, v in state.items() if k != "batches"}


def assert_batches_equal(want, got):
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("stream") / "c"),
                        n_docs=24)


@pytest.mark.parametrize("packing", [False, True])
@pytest.mark.parametrize("workers,prefetch", [(1, 0), (3, 2)])
def test_loader_equals_jax_two_epochs(corpus, packing, workers, prefetch):
    """Two epochs (the second remasked: its token stream equals the
    first's, its masks do not), batch for batch and bit for bit, with the
    state after each batch."""
    kw = dict(packing=packing, num_workers=workers, prefetch_batches=prefetch)
    j, p = jax_loader(corpus, **kw), port_loader(corpus, **kw)
    try:
        epochs = []
        for epoch in range(2):
            want, got = [], []
            for lo, out in ((j, want), (p, got)):
                while True:
                    try:
                        out.append((next(lo), lo.state_dict()))
                    except StopIteration:
                        break
            assert_batches_equal([b for b, _ in want], [b for b, _ in got])
            # under assembly prefetch a state's "batches" is read on the
            # assembly thread while the consumer counts (both loaders):
            # bookkeeping, not part of the cursor
            assert [cursor(s) for _, s in want] == [cursor(s) for _, s in got]
            info = [lo.stream_info() for lo in (j, p)]
            for i in info:
                i["cursor"] = cursor(i["cursor"])
            assert info[0] == info[1]
            epochs.append([b for b, _ in got])
            j.reset_epoch()
            p.reset_epoch()
        assert p.epoch == j.epoch == 2
        if packing:
            assert max(int(b["segment_ids"].max()) for b in epochs[0]) >= 2
        else:
            def orig(b):
                return np.where(b["masked_lm_labels"] != -1,
                                b["masked_lm_labels"], b["input_ids"])
            assert all((orig(a) == orig(b)).all()
                       for a, b in zip(*epochs))
            assert any((a["input_ids"] != b["input_ids"]).any()
                       for a, b in zip(*epochs))
    finally:
        j.close()
        p.close()


@pytest.mark.parametrize("packing", [False, True])
def test_resume_mid_stream_equals_jax(corpus, packing):
    """A state taken after 2 batches (prefetch 2 running ahead; packed: the
    pending cursors) resumes the port's stream on JAX's unbroken one."""
    kw = dict(packing=packing, prefetch_batches=2)
    j = jax_loader(corpus, **kw)
    full = drain(j)
    j.close()
    first = port_loader(corpus, **kw)
    drain(first, 2)
    state = first.state_dict()
    first.close()
    assert state["stream"] == 1
    if packing:
        assert state["pending"]
    resumed = port_loader(corpus, packing=packing)
    resumed.load_state_dict(json.loads(json.dumps(state)))
    assert_batches_equal(full[2:], drain(resumed))
    resumed.close()


def test_two_ranks_disjoint_and_equal_to_jax(corpus):
    seen = []
    for rank in (0, 1):
        j = jax_loader(corpus, world_size=2, rank=rank)
        p = port_loader(corpus, world_size=2, rank=rank)
        want, got = drain(j), drain(p)
        assert_batches_equal(want, got)
        seen.append({w["record_lo"] for w in p.recent_windows}
                    | {w["record_hi"] for w in p.recent_windows})
        assert all(s % 2 == rank for s in seen[-1])
        j.close()
        p.close()
    assert not seen[0] & seen[1]


@pytest.mark.parametrize("inject", jstream.INJECT_MODES)
def test_injected_stream_equals_jax(corpus, inject):
    """The stream that survives each drill equals JAX's: corrupt_record
    drops every 7th record and counts it, worker_crash re-runs a task with
    its cursor intact (the stream equals the uninjected one),
    slow_producer only slows it."""
    kw = dict(inject=inject, num_workers=2)
    jreg, preg = JaxRegistry(), MetricsRegistry()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jax_loader(corpus, registry=jreg, **kw)
        p = port_loader(corpus, registry=preg, **kw)
        want, got = drain(j), drain(p)
        j.close()
        p.close()
    assert_batches_equal(want, got)
    names = ("bert_stream_records_dropped_total",
             "bert_stream_worker_restarts_total",
             "bert_stream_records_total", "bert_stream_tokens_total")
    counts = {n: preg.counter(n).value() for n in names}
    assert counts == {n: jreg.counter(n).value() for n in names}
    assert (counts["bert_stream_records_dropped_total"] > 0) == (
        inject == "corrupt_record")
    assert (counts["bert_stream_worker_restarts_total"] > 0) == (
        inject == "worker_crash")
    if inject == "worker_crash":
        clean = port_loader(corpus)
        assert_batches_equal(drain(clean), got)
        clean.close()


def test_metrics_and_healthz_carry_the_stream(corpus):
    """The loader's bert_stream_* families on the run's registry, and the
    live cursor (without the pending examples) on /healthz."""
    from bert_pytorch_tpu_torch.telemetry.registry import parse_prometheus
    from bert_pytorch_tpu_torch.telemetry.run import init_run

    tel = init_run("pretrain", echo=lambda m: None)
    lo = port_loader(corpus, packing=True, registry=tel.registry)
    tel.attach_stream(lo)
    drain(lo, 2)
    health = tel.healthz()
    lo.close()
    tel.close()
    want = cursor(lo.state_dict())
    want.pop("pending")
    assert cursor(health["stream"]) == want and "pending" not in health[
        "stream"]
    parsed = parse_prometheus(tel.registry.render_prometheus())
    for name in ("bert_stream_tokens_total", "bert_stream_records_total",
                 "bert_stream_records_dropped_total",
                 "bert_stream_worker_restarts_total",
                 "bert_stream_examples_total", "bert_stream_queue_depth"):
        assert name in parsed, name
    assert list(parsed["bert_stream_tokens_total"].values())[0] > 0
    assert any(k.startswith("bert_stream_worker_tokens_per_sec")
               for k in parsed)


def test_changed_source_list_is_refused(corpus, tmp_path):
    lo = port_loader(corpus, packing=True)
    drain(lo, 1)
    state = lo.state_dict()
    lo.close()
    other = port_loader(write_corpus(str(tmp_path / "o"), n_docs=30, seed=9),
                        packing=True)
    with pytest.warns(UserWarning, match="source list changed"):
        other.load_state_dict(state)
    assert other._pending == [] and other._cursor == (0, 0, 0, 0)
    with pytest.warns(UserWarning, match="not a streaming-plane state"):
        other.load_state_dict({"epoch": 0, "index": 8, "total_size": 40})
    other.close()


def test_bpe_convention_tokens_frame_the_examples(corpus):
    """<s>/</s>/<mask> (the BPE convention) frame and mask the examples,
    as JAX's test_stream_bpe_convention_tokens_accepted has it."""
    class StubBPE:
        vocab = {t: i for i, t in enumerate(
            ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + WORDS)}

        def token_to_id(self, tok):
            return self.vocab.get(tok)

        def encode(self, text, add_special_tokens=True):
            enc = type("Enc", (), {})()
            enc.ids = [self.vocab.get(w, 1) for w in text.split()]
            return enc

    tok = StubBPE()
    assert pstream.resolve_mask_id(tok) == 4
    b = []
    for mod in (jstream, pstream):
        lo = mod.StreamingPretrainingLoader(
            mod.discover_sources(corpus), tok, batch_size=4, seq_len=16,
            mask_token_index=4, max_pred_per_seq=3, masked_lm_prob=0.15,
            vocab_size=len(tok.vocab), seed=7)
        b.append(next(lo))
        lo.close()
    assert_batches_equal([b[0]], [b[1]])
    assert (b[1]["input_ids"][:, 0] == tok.vocab["<s>"]).all()


# -- the command line -----------------------------------------------------------

def _cli_cases(tmp_path):
    """tests/test_streaming.py::test_stream_cli_validation's cases: argv
    lists, and run-config JSON written before the parse."""
    cfg = str(tmp_path / "run.json")
    vocab = write_vocab(tmp_path / "alt_vocab.txt")
    return [
        (None, ["--input_dir", "/x", "--stream_dir", "/y"]),
        (None, ["--input_dir", "/x", "--stream_workers", "8"]),
        (None, ["--input_dir", "/x", "--stream_workers", "2"]),
        (None, ["--stream_inject", "worker_crash"]),
        ({"stream_seq_len": 64, "stream_workers": 4},
         ["--config_file", cfg, "--input_dir", "/x"]),
        ({"stream_vocab": vocab}, ["--config_file", cfg, "--input_dir",
                                   "/x"]),
        ({"stream_vocab": vocab}, ["--config_file", cfg, "--stream_dir",
                                   "/y"]),
        ({"input_dir": "/from_config"}, ["--config_file", cfg,
                                         "--stream_dir", "/y"]),
        ({"stream_dir": "/from_config"}, ["--config_file", cfg,
                                          "--input_dir", "/x"]),
        (None, ["--stream_dir", "/y", "--stream_workers", "8",
                "--stream_seq_len", "64"]),
        (None, ["--input_dir", "/x"]),
    ], cfg


def test_stream_cli_validation_matches_jax(tmp_path):
    import run_pretraining as jax_entry

    class NoVocab:
        vocab_file = None

    keys = ("input_dir", "stream_dir", "stream_seq_len", "stream_workers",
            "stream_vocab", "stream_tokenizer", "stream_queue_batches",
            "stream_inject", "h2d_prefetch", "tensorboard")
    cases, cfg = _cli_cases(tmp_path)
    for config, argv in cases:
        if config is not None:
            with open(cfg, "w") as f:
                json.dump(config, f)
        outcome = []
        for mod in (jax_entry, run_pretraining):
            try:
                args = mod.parse_arguments(argv)
            except SystemExit as e:
                outcome.append(("exit", e.code))
                continue
            outcome.append(({k: getattr(args, k) for k in keys},
                            mod.find_mask_token_index(args, NoVocab())))
        assert outcome[0] == outcome[1], (argv, config, outcome)


# -- the TensorBoard sink ---------------------------------------------------------

def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_sink_scalars_match_jax(tmp_path):
    from bert_pytorch_tpu.training.metrics import MetricLogger as JaxLogger
    from bert_pytorch_tpu_torch.training.metrics import MetricLogger

    records = [("train", 1, {"step_loss": 7.25, "grad_norm": 1.5,
                             "loss_nonfinite": 0, "epoch": 0}),
               ("train", 2, {"step_loss": 6.75, "grad_norm": 1.25,
                             "skipped": True, "note": "text"}),
               ("perf", 2, {"step_time_ms": 412.5, "mfu": 0.31})]
    jl = JaxLogger(str(tmp_path / "jax" / "log"), tensorboard=True,
                   stream=open(os.devnull, "w"))
    pl = MetricLogger(str(tmp_path / "port" / "log"), echo=lambda m: None,
                      tensorboard=True)
    for tag, step, vals in records:
        jl.log(tag, step, **vals)
        pl.log(tag, step, **vals)
    jl.close()
    pl.close()
    want = _scalars(str(tmp_path / "jax" / "log_tb"))
    got = _scalars(str(tmp_path / "port" / "log_tb"))
    assert got == want and "train/step_loss" in got
    assert got["train/grad_norm"] == [(1, 1.5), (2, 1.25)]


def test_tensorboard_sink_off_without_the_package(tmp_path, monkeypatch):
    import builtins

    from bert_pytorch_tpu_torch.training.metrics import MetricLogger

    real = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name == "torch.utils.tensorboard":
            raise ImportError("No module named 'tensorboard'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    lines = []
    pl = MetricLogger(str(tmp_path / "log"), echo=lines.append,
                      tensorboard=True)
    pl.log("train", 1, step_loss=1.0)
    pl.close()
    assert lines[0] == ("tensorboard: sink off (No module named "
                        "'tensorboard')")
    assert not (tmp_path / "log_tb").exists()


# -- run_pretraining --stream_dir --------------------------------------------------

@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_run")
    corpus = write_corpus(str(root / "corpus"), n_docs=40)
    vocab = write_vocab(root / "vocab.txt")
    (root / "cfg.json").write_text(json.dumps(CFG))

    def argv(out, steps, *extra):
        return ["--model_config_file", str(root / "cfg.json"),
                "--stream_dir", corpus, "--stream_vocab", vocab,
                "--stream_seq_len", "32", "--output_dir", str(out),
                "--local_batch_size", "4", "--global_batch_size", "8",
                "--max_steps", "4", "--steps", str(steps),
                "--num_steps_per_checkpoint", "2", "--dtype", "float32",
                "--seed", "3", "--log_freq", "1", "--device", "cpu",
                *extra]
    return root, argv


def _losses(result):
    return [r["loss"] for r in result.history]


def test_stream_run_resumes_bit_equal(stream_run):
    root, argv = stream_run
    lines = []
    whole = run_pretraining.main(argv(root / "whole", 4), log=lines.append)
    assert any(ln.startswith("dataset: STREAMING 2 raw-text sources")
               for ln in lines)
    assert "h2d prefetch: depth 1 (the next batch pulled while the step " \
           "runs)" in lines
    assert any(ln.startswith("tensorboard: scalars under") for ln in lines)
    first = run_pretraining.main(argv(root / "split", 2), log=lambda m: None)
    again = run_pretraining.main(argv(root / "split", 2), log=lambda m: None)
    assert again.resumed_from == 2
    assert _losses(first) + _losses(again) == _losses(whole)
    tb = _scalars(str(root / "whole" / "logfile_tb"))
    assert [s for s, _ in tb["train/step_loss"]] == [1, 2, 3, 4]
    assert np.allclose([v for _, v in tb["train/step_loss"]],
                       _losses(whole))


def test_stream_run_first_loss_on_jax_batches(stream_run, monkeypatch):
    """The run's losses with JAX's loader in place of the port's: equal,
    so the port's step ran on batches bit-equal to JAX's stream."""
    root, argv = stream_run
    port = run_pretraining.main(argv(root / "p", 2, "--skip_checkpoint"),
                                log=lambda m: None)
    real = run_pretraining._stream_loader

    def jax_feed(args, config, batch_size, registry, log):
        loader, mask_id = real(args, config, batch_size, registry, log)
        loader.close()
        jax_tok = JaxWordPiece(args.stream_vocab)
        return jstream.StreamingPretrainingLoader(
            jstream.discover_sources(args.stream_dir), jax_tok,
            batch_size=batch_size, seq_len=args.stream_seq_len,
            mask_token_index=mask_id,
            max_pred_per_seq=args.max_predictions_per_seq,
            masked_lm_prob=args.masked_token_fraction,
            vocab_size=config.vocab_size, seed=args.seed,
            num_workers=args.stream_workers,
            prefetch_batches=args.prefetch_batches), mask_id

    monkeypatch.setattr(run_pretraining, "_stream_loader", jax_feed)
    jax_fed = run_pretraining.main(argv(root / "j", 2, "--skip_checkpoint"),
                                   log=lambda m: None)
    assert np.isfinite(_losses(port)).all()
    assert _losses(jax_fed) == _losses(port)


def test_offline_checkpoint_is_not_restored_into_a_stream(stream_run):
    """Auto-resume of the other plane's cursor: refused loudly, the data
    starts over, the weights are restored."""
    root, argv = stream_run
    out = root / "cross"
    run_pretraining.main(argv(out, 2), log=lambda m: None)
    from bert_pytorch_tpu_torch.training.checkpoint import \
        CheckpointManager

    manager = CheckpointManager(str(out / "pretrain_ckpts"))
    sd, extra, step = manager.restore_with_fallback()
    extra = dict(extra, sampler={"epoch": 0, "seed": 3, "world_size": 1,
                                 "total_size": 40, "index": 8})
    shutil.rmtree(out / "pretrain_ckpts")
    CheckpointManager(str(out / "pretrain_ckpts")).save(step, sd,
                                                        extra=extra)
    lines = []
    with pytest.warns(UserWarning, match="not a streaming-plane state"):
        got = run_pretraining.main(argv(out, 1), log=lines.append)
    assert got.resumed_from == 2
    assert any("data cursor is the offline plane's" in ln for ln in lines)


def test_stream_bundle_validates_and_replays(stream_run):
    from bert_pytorch_tpu.telemetry.flight_recorder import \
        validate_bundle as jax_validate
    from bert_pytorch_tpu_torch.telemetry.flight_recorder import \
        validate_bundle
    from bert_pytorch_tpu_torch.tools import replay

    root, argv = stream_run
    out = root / "drill"
    rc = run_pretraining.exit_code_of(lambda: run_pretraining.main(
        argv(out, 4, "--inject_nonfinite_step", "3", "--nonfinite_action",
             "halt") + ["--num_steps_per_checkpoint", "1"],
        log=lambda m: None))
    assert rc == 71
    (name,) = os.listdir(out / "repro_bundles")
    bundle = str(out / "repro_bundles" / name)
    assert validate_bundle(bundle) == [] and jax_validate(bundle) == []
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    stream = manifest["stream"]
    assert manifest["run"]["stream"] is True
    assert len(stream["sources"]) == 2 and stream["recent_batches"]
    assert stream["cursor"]["stream"] == 1
    result = replay.main(["--bundle", bundle, "--device", "cpu"])
    assert result["match"] is True
    assert result["replayed"]["loss_nonfinite"] == 1


def test_chip_smoke_stream_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's stream phase at a tiny width on the CPU (plain
    versions; the launch counts and the trace are checked on the card
    only): both depths, the host loader, the drills, BPE and the
    TensorBoard sink. (The phase's resume leg went to the chip budget: a
    streamed run's resume is held bit-equal here, by
    test_stream_run_resumes_bit_equal.)"""
    import torch

    import chip_smoke

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(CFG, vocab_size=128,
                                   max_position_embeddings=128)))
    summary = {}
    chip_smoke.phase_stream(torch, np, summary, device="cpu",
                            cfg_path=str(cfg), micro=4, docs=60,
                            bpe_merges=40)
    res = summary["stream"]
    assert res["h2d_prefetch_1"]["losses"] == res["h2d_prefetch_0"]["losses"]
    assert res["offline"]["order"] == ["on", "off", "off", "on"]
    assert [len(r["losses"]) for m in ("on", "off")
            for r in res["offline"]["runs"][m]] == [4] * 4
    assert "resume" not in res
    assert res["packed"]["records_dropped"][0][1] >= 1
    assert res["tensorboard"]["package"] is True
    assert summary["launches"]["stream"] == res["h2d_prefetch_1"][
        "launches"]
