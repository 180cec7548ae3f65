"""The port's DevicePrefetcher (bert_pytorch_tpu_torch/data/sharded.py,
run_pretraining's --h2d_prefetch) against the JAX package's class with an
identity put, at depths 0-2: the pairs yielded, the state_dict() lag and
the tap order, for a consumer that stages right after each next() (pulls
exactly when JAX's class does) and for the train loop's order (staging
after the step's dispatch); the watchdog reading a slow stream's wait as
data_wait (input starvation, never a device hang); and run_pretraining on
the CPU at --h2d_prefetch 0 and 1: the same losses bit for bit, and a
resume from a checkpoint saved with a batch staged ahead bit-equal to the
unbroken run."""

import json
import os
import sys

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.data.sharded import \
    DevicePrefetcher as JaxPrefetcher  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.data.sharded import DevicePrefetcher  # noqa: E402
from tests.test_data import write_shard  # noqa: E402


class Source:
    """An upstream loader: batch i is {"x": [i]}, its state the count of
    batches pulled; pulls are logged."""

    def __init__(self, n, log):
        self.n, self.i, self.log = n, 0, log

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        self.log.append(("pull", self.i - 1))
        return {"x": np.array([self.i - 1])}

    def state_dict(self):
        return {"pulled": self.i}


def run(cls, depth, n, stage):
    """Consume a prefetcher over Source(n): each yield's pair, state and
    the event log (pulls, taps, yields). `stage` None: JAX's class;
    "after_next" / "after_dispatch": the port's with fill() called right
    after next() or after a pretend dispatch."""
    log = []
    src = Source(n, log)
    pf = cls(src, lambda b: {"dev": b["x"] * 10}, depth=depth,
             state_fn=src.state_dict,
             batch_tap=lambda b: log.append(("tap", int(b["x"][0]))))
    out = [("state0", pf.state_dict())]
    while True:
        try:
            b, d = next(pf)
        except StopIteration:
            break
        if stage == "after_next":
            pf.fill()
        log.append(("yield", int(b["x"][0])))
        out.append((int(b["x"][0]), int(d["dev"][0]), pf.state_dict()))
        if stage == "after_dispatch":
            log.append(("dispatch", int(b["x"][0])))
            pf.fill()
    return out, log


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetcher_equals_jax(depth):
    want, jlog = run(JaxPrefetcher, depth, 5, None)
    for stage in ("after_next", "after_dispatch"):
        got, plog = run(DevicePrefetcher, depth, 5, stage)
        assert got == want, stage
        taps = [e for e in plog if e[0] == "tap"]
        assert taps == [e for e in jlog if e[0] == "tap"]
        assert [e for e in plog if e[0] == "yield"] == [
            ("yield", i) for i in range(5)]
    # staged right after next(), the port pulls when JAX's class does:
    # before yield i, batches up to i + depth have been pulled
    got, plog = run(DevicePrefetcher, depth, 5, "after_next")
    pulls = 0
    for event, i in plog:
        if event == "pull":
            pulls += 1
        elif event == "yield":
            assert pulls == min(5, i + depth + 1), (plog, i)
    # in the loop's order the first step's batch is pulled alone, and
    # batch i + depth only after step i's dispatch (the overlap the loop
    # is after)
    got, plog = run(DevicePrefetcher, depth, 5, "after_dispatch")
    if depth:
        assert plog.index(("pull", 1)) > plog.index(("dispatch", 0))
        for i in range(5 - depth):
            assert plog.index(("pull", i + depth)) > plog.index(
                ("dispatch", i))
    # the state lags to the last yielded batch, however far staging ran
    assert [s for *_, s in got[1:]] == [{"pulled": i + 1} for i in range(5)]


def test_slow_stream_wait_is_data_wait_not_a_device_hang(tmp_path):
    """--stream_inject slow_producer under the watchdog: the wait sits in
    the prefetcher's data_wait phase, which trips as input starvation."""
    from bert_pytorch_tpu_torch.resilience.watchdog import arm_watchdog
    from bert_pytorch_tpu_torch.telemetry.registry import MetricsRegistry
    from bert_pytorch_tpu_torch.telemetry.stepwatch import StepWatch
    from tests.test_torch_streaming import port_loader
    from tests.test_streaming import write_corpus

    loader = port_loader(write_corpus(str(tmp_path / "c"), n_docs=12),
                         inject="slow_producer", num_workers=1)
    sw = StepWatch(flops_per_step=1.0, seqs_per_step=4, seq_len=16,
                   peak_flops=None, log_freq=10 ** 6)
    reg = MetricsRegistry()
    wd = arm_watchdog(0.02, "warn", sw, registry=reg, log=lambda m: None,
                      out_dir=str(tmp_path))

    class Args:
        h2d_prefetch = 1

    import torch

    make = run_pretraining._prefetcher_factory(
        Args, loader, sw, torch.device("cpu"), 1, 4, None, lambda m: None)
    pf = make()
    try:
        for _ in range(2):
            next(pf)
            pf.fill()
    finally:
        wd.close()
        loader.close()
    assert wd.last_stall["phase"] == "data_wait"
    assert wd.last_stall["kind"] == "input_starvation"
    trips = reg.counter("bert_watchdog_stalls_total", labels=("kind",))
    assert trips.value(kind="input_starvation") >= 1
    assert trips.value(kind="device_hang") == 0


# -- run_pretraining at --h2d_prefetch 0 and 1 ---------------------------------------

CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=64, next_sentence=True)


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    root = tmp_path_factory.mktemp("h2d")
    (root / "data").mkdir()
    for i in range(2):
        write_shard(str(root / "data" / f"s{i}.hdf5"), 24, seq=32, seed=i)
    (root / "cfg.json").write_text(json.dumps(CFG))

    def argv(out, steps, *extra):
        return ["--model_config_file", str(root / "cfg.json"),
                "--input_dir", str(root / "data"), "--output_dir", str(out),
                "--local_batch_size", "4", "--global_batch_size", "8",
                "--max_steps", "8", "--steps", str(steps),
                "--num_steps_per_checkpoint", "4", "--dtype", "float32",
                "--tensorboard", "off", "--device", "cpu", *extra]
    return root, argv


def _losses(r):
    return [h["loss"] for h in r.history]


def test_depths_give_the_same_losses_and_resume(offline):
    """8 steps (an epoch boundary inside: 48 samples, 8 a step) at depth 0
    and 1 bit-equal; a depth-1 run stopped at step 4 and resumed (its
    checkpoint saved with step 5's batch staged) equals the unbroken
    run."""
    root, argv = offline
    lines = []
    d1 = run_pretraining.main(argv(root / "d1", 8, "--skip_checkpoint"),
                              log=lines.append)
    assert "h2d prefetch: depth 1 (the next batch pulled while the step " \
           "runs)" in lines
    d0 = run_pretraining.main(argv(root / "d0", 8, "--h2d_prefetch", "0",
                                   "--skip_checkpoint"), log=lambda m: None)
    assert _losses(d1) == _losses(d0) and len(_losses(d1)) == 8
    a = run_pretraining.main(argv(root / "r", 4), log=lambda m: None)
    b = run_pretraining.main(argv(root / "r", 4), log=lambda m: None)
    assert b.resumed_from == 4
    assert _losses(a) + _losses(b) == _losses(d1)


def test_train_batch_tap_sees_the_batches_the_steps_read(offline):
    """train(batch_tap=) sees each step's host batch once, in order (not
    the one staged past the last step), the same batches at depth 0 and
    1; the result carries the run's registry snapshot."""
    from bert_pytorch_tpu_torch.data.sharded import ShardIndex

    root, argv = offline
    files = sorted(str(p) for p in (root / "data").glob("*.hdf5"))
    taps = {}
    for depth in (0, 1):
        seen = []
        args = run_pretraining.parse_arguments(argv(
            root / f"tap{depth}", 3, "--skip_checkpoint", "--h2d_prefetch",
            str(depth)))
        result = run_pretraining.train(
            args, ShardIndex(files), log=lambda m: None,
            batch_tap=lambda b: seen.append({k: v.copy()
                                             for k, v in b.items()}))
        assert len(seen) == 3 and len(result.history) == 3
        assert all(len(b["input_ids"]) == 8 for b in seen)
        assert result.metrics["bert_train_steps_total"]["series"][0][
            "value"] == 3
        taps[depth] = seen
    assert all(np.array_equal(a[k], b[k])
               for a, b in zip(taps[0], taps[1]) for k in a)
