"""The port's ZeRO-1 (bert_pytorch_tpu_torch/parallel/zero.py) on gloo
ranks over the CPU: the flat layout's pieces, LAMB over pieces against
LAMB over whole tensors, ZeRO-1 on against off within the JAX package's
own bound (tests/test_zero1.py: rtol 2e-5, atol 1e-7), its arms
(--zero1_rs, --zero1_overlap, --coalesce_reductions on, bf16 compute
with the gathers cast first) bit-equal to one another at 2 and at 4
ranks, checkpoints across world sizes (2 -> 2 bit-equal to an
uninterrupted run, 2 -> 1 and 1 -> 2), and SIGTERM to both ranks ending
in one collective emergency save.

The ranks are processes of tests/torch_ranks.py joined by a FileStore
under tmp_path (no port is taken)."""

import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_pretrain as tp  # noqa: E402
import torch_ranks  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.config import BertConfig  # noqa: E402
from bert_pytorch_tpu_torch.models.bert import BertForPreTraining  # noqa: E402
from bert_pytorch_tpu_torch.parallel.zero import (ALIGN,  # noqa: E402
                                                  DataParallel, FlatLayout)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, ACCUM, N_STEPS = 8, 2, 3


def _model(seed=0):
    torch.manual_seed(seed)
    from bert_pytorch_tpu_torch.models.bert import init_weights

    model = BertForPreTraining(BertConfig.from_dict(tp.CFG),
                               dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_flat_layout_pieces_cover_every_element_once(world):
    """Every element of every tensor lies in exactly one rank's piece;
    every piece starts on ALIGN elements in the flat buffer and in the
    rank's shard buffer; units are the embeddings, each layer, the heads;
    nothing is left replicated."""
    named = list(_model().named_parameters())
    layout = FlatLayout([n for n, _ in named], [p.shape for _, p in named],
                        world)
    assert [u.name for u in layout.units] == [
        "embeddings", "layer_0", "layer_1", "heads"]
    assert layout.total == world * layout.shard_total
    seen = {n: np.zeros(p.numel(), np.int32) for n, p in named}
    for r in range(world):
        for piece in layout.pieces(r):
            assert piece.lo % ALIGN == 0 and piece.compact % ALIGN == 0
            assert piece.key == f"{piece.name}@{piece.start}"
            seen[piece.name][piece.start:piece.start + piece.hi
                             - piece.lo] += 1
    for n, count in seen.items():
        assert (count == 1).all(), n
    for u in layout.units:
        assert u.length % (world * ALIGN) == 0


def test_lamb_over_pieces_equals_whole_tensors_at_one_rank():
    """ZeRO-1 without a process group (one rank, a piece a tensor): three
    LAMB steps of the piece path against the whole-tensor path; the
    one-card state_dict of the pieces is the same format."""
    from bert_pytorch_tpu_torch.optim.lamb import Lamb
    from bert_pytorch_tpu_torch.training.state import make_train_state

    outs = []
    for zero1 in (False, True):
        model = _model(1)
        dp = DataParallel(model, zero1=True) if zero1 else None
        tx = Lamb(1e-2, weight_decay=0.01, fused="auto")
        state = make_train_state(model, tx, dp=dp)
        rng = torch.Generator().manual_seed(3)
        for _ in range(3):
            grads = {n: torch.randn(p.shape, generator=rng)
                     for n, p in state.params.items()}
            if zero1:
                flat, views = dp.carry(torch.float32)
                for n, g in grads.items():
                    views[n].copy_(g)
                tx.update(dp.reduce_grads(flat), state.opt_state,
                          dp.piece_views(dp.master), shards=dp)
            else:
                tx.update(grads, state.opt_state, state.params)
        outs.append(state.state_dict())
    plain, pieces = outs
    assert set(plain["params"]) == set(pieces["params"])
    for what in ("params",):
        for n, w in plain[what].items():
            np.testing.assert_allclose(pieces[what][n].numpy(), w.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    # the moments see the gradient norm, summed from per-tensor partials
    # on the piece path: the JAX package's ZeRO-1 bound for moments
    for what in ("mu", "nu"):
        for n, w in plain["opt_state"][what].items():
            np.testing.assert_allclose(
                pieces["opt_state"][what][n].numpy(), w.numpy(), rtol=2e-5,
                atol=1e-8, err_msg=n)
    assert pieces["opt_state"]["count"] == 3


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Initial params, 3 steps of (2, ROWS, ...) batches and seeds."""
    from bert_pytorch_tpu_torch.training.pretrain import dropout_seeds

    root = tmp_path_factory.mktemp("zero1_inputs")
    np.savez(root / "params.npz", **{k: v.detach().numpy() for k, v in
                                     _model(2).state_dict().items()})
    batches = {}
    for i in range(N_STEPS):
        micro = [tp._batch(20 * i + j, rows=ROWS) for j in range(ACCUM)]
        for k in micro[0]:
            batches[f"{i}/{k}"] = np.stack([m[k] for m in micro])
    np.savez(root / "batches.npz", **batches)
    np.save(root / "seeds.npy", np.stack([
        dropout_seeds(7, i + 1, ACCUM, tp.N_SEEDS).numpy()
        for i in range(N_STEPS)]))
    return root


def _job(inputs, arms):
    return {"kind": "steps", "config": tp.CFG,
            "params": str(inputs / "params.npz"),
            "batches": str(inputs / "batches.npz"),
            "seeds": str(inputs / "seeds.npy"), "n_steps": N_STEPS,
            "accum": ACCUM, "lr": 1e-2, "total_steps": 10, "warmup": 0.2,
            "max_predictions": tp.P, "health": True, "arms": arms}


def _state(root, arm):
    return dict(np.load(root / f"rank0_{arm}.npz"))


def _assert_bit_equal(root, ranks, a, b):
    for r in ranks:
        for k in ("loss", "grad_norm", "param_norm"):
            assert r[a][k] == r[b][k], (k, a, b)
    sa, sb = _state(root, a), _state(root, b)
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"{k} {a}/{b}")


ARMS = [{"zero1": True}, {"zero1": True, "zero1_rs": True,
                          "zero1_overlap": True},
        {"zero1": True, "zero1_overlap": True},
        {"zero1": True, "zero1_overlap": True, "coalesce": True},
        {"zero1": True, "coalesce": True}]


def test_zero1_arms_bit_equal_and_on_against_off_at_two_ranks(inputs,
                                                              tmp_path):
    """At 2 ranks, dropout on: the all-reduce-and-slice arm, --zero1_rs,
    --zero1_overlap and --coalesce_reductions on give the same bits
    (losses, grad and param norms, params, moments); bf16 compute with
    the gather of the cast slices (overlap) equals the end-of-step f32
    gather cast at the step's start; ZeRO-1 on against off within the
    JAX package's bound."""
    arms = ARMS + [{}, {"zero1": True, "bf16": True},
                   {"zero1": True, "zero1_overlap": True, "bf16": True}]
    ranks = torch_ranks.run(_job(inputs, arms), 2, tmp_path)
    for a in range(1, len(ARMS)):
        _assert_bit_equal(tmp_path, ranks, 0, a)
    _assert_bit_equal(tmp_path, ranks, len(ARMS) + 1, len(ARMS) + 2)
    off, on = len(ARMS), 0
    np.testing.assert_allclose(ranks[0][off]["loss"], ranks[0][on]["loss"],
                               rtol=1e-6)
    s_off, s_on = _state(tmp_path, off), _state(tmp_path, on)
    for k in s_off:
        bound = 1e-7 if k.startswith("params/") else 1e-8
        np.testing.assert_allclose(s_on[k], s_off[k], rtol=2e-5, atol=bound,
                                   err_msg=k)
    assert ranks[0][0]["describe"]["replicated_leaves"] == 0


def test_zero1_arms_bit_equal_at_four_ranks(inputs, tmp_path):
    """The arms at 4 ranks, where the order of a sum over ranks matters:
    all-reduce is reduce-scatter then all-gather, the norm partials are
    summed in rank order, so the arms still agree bit for bit."""
    arms = [ARMS[0], ARMS[1], ARMS[3]]
    ranks = torch_ranks.run(_job(inputs, arms), 4, tmp_path)
    for a in (1, 2):
        _assert_bit_equal(tmp_path, ranks, 0, a)


# -- checkpoints across world sizes ---------------------------------------------


def _argv(data, cfg, out, steps, *extra):
    return ["--config_file",
            os.path.join(REPO, "configs", "bert_pretraining_phase1_config.json"),
            "--model_config_file", str(cfg), "--input_dir", str(data),
            "--output_dir", str(out), "--local_batch_size", "2",
            "--global_batch_size", "8", "--steps", str(steps),
            "--num_steps_per_checkpoint", "2", "--device", "cpu",
            "--tensorboard", "off", "--flight_recorder", "off",
            "--learning_rate", "1e-2", *extra]


def _load(out, step):
    return torch.load(out / "pretrain_ckpts" / str(step) / "state.pt",
                      weights_only=True)


def test_checkpoints_move_across_world_sizes(tmp_path):
    """ZeRO-1 with gather-on-use, dropout on: a 2-rank run of 4 steps and
    one of 2 + 2 (resumed) write bit-equal step-4 checkpoints (the
    one-card format: masters and moments gathered); a 2-rank checkpoint
    restores on one card (params, moments, step as saved) and a one-card
    checkpoint resumes on 2 ranks."""
    data = tp._write_shards(tmp_path / "data", n=32)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(tp.CFG))
    dp = ["--mesh", "data=2", "--zero1", "true", "--zero1_overlap"]
    # one card first: 2 steps into d1, which 2 ranks then resume
    d1 = tmp_path / "one_card"
    one = run_pretraining.main(_argv(data, cfg, d1, 2), log=lambda m: None)
    assert one.saves[-1]["step"] == 2
    a, b = tmp_path / "whole", tmp_path / "split"
    runs = [_argv(data, cfg, a, 4, *dp), _argv(data, cfg, b, 2, *dp),
            _argv(data, cfg, b, 2, *dp), _argv(data, cfg, d1, 2, *dp)]
    r0, r1 = torch_ranks.run({"kind": "main", "runs": runs}, 2,
                             tmp_path / "ranks")
    assert [r["step"] for r in r0] == [4, 2, 4, 4]
    assert [r["resumed_from"] for r in r0] == [None, None, 2, 2]
    assert [r["resumed_from"] for r in r1] == [None, None, 2, 2]
    sa, sb = _load(a, 4), _load(b, 4)
    for group in ("params",):
        for k, v in sa[group].items():
            assert torch.equal(v, sb[group][k]), k
    for what in ("mu", "nu"):
        for k, v in sa["opt_state"][what].items():
            assert torch.equal(v, sb["opt_state"][what][k]), (what, k)
    assert sa["step"] == sb["step"] == 4
    # 2 -> 1: the 2-rank step-2 checkpoint on one card (--steps 0: the
    # state as restored)
    c = tmp_path / "to_one"
    (c / "pretrain_ckpts").mkdir(parents=True)
    os.rename(b / "pretrain_ckpts" / "2", c / "pretrain_ckpts" / "2")
    got = run_pretraining.main(_argv(data, cfg, c, 0), log=lambda m: None)
    assert got.resumed_from == 2 and got.state.step == 2
    want = _load(c, 2)
    for k, v in want["params"].items():
        assert torch.equal(got.state.params[k], v), k
    for what in ("mu", "nu"):
        for k, v in want["opt_state"][what].items():
            assert torch.equal(getattr(got.state.opt_state, what)[k], v), k


def test_sigterm_to_both_ranks_saves_once_collectively(tmp_path):
    """torchrun forwards SIGTERM to every rank: both ranks leave at the
    same step (the guard's vote), join the gather of the ZeRO-1 state,
    rank 0 writes the one emergency checkpoint, both exit 143."""
    data = tp._write_shards(tmp_path / "data", n=32)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(tp.CFG))
    out = tmp_path / "out"
    argv = _argv(data, cfg, out, 400, "--mesh", "data=2", "--zero1", "true",
                 "--num_steps_per_checkpoint", "100000")
    procs = torch_ranks.start({"kind": "sigterm", "argv": argv}, 2,
                              tmp_path / "ranks")
    try:
        deadline = time.time() + 120
        while not all((tmp_path / "ranks" / f"ready{r}").exists()
                      for r in range(2)):
            assert time.time() < deadline, "ranks never started"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.2)
        time.sleep(1.0)
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [143, 143], [p.stdout.read()[-2000:] for p in procs]
    steps = sorted(int(d.name) for d in (out / "pretrain_ckpts").iterdir())
    assert len(steps) == 1 and 0 < steps[0] < 400
    extra = json.loads((out / "pretrain_ckpts" / str(steps[0])
                        / "extra.json").read_text())
    assert len(extra["sampler_ranks"]) == 2
    assert _load(out, steps[0])["step"] == steps[0]


def test_chip_smoke_train_dp_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's train_dp phase at a tiny width on the CPU: the
    1-rank reference (gloo here, NCCL on the card), two rank processes
    (`--dp_child`), the compare leg and the model=2 leg within DP_TOL, the
    six data and fsdp entry-point arms bit-equal, the model=2 arm and its
    seq-512 leg, the 2-rank and the model=2 checkpoints restored by one
    rank and the first kept; then train_chunks chained from that
    checkpoint (--init_checkpoint, every parameter loaded)."""
    import numpy as np_

    import chip_smoke

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(tp.CFG, type_vocab_size=2,
                                   initializer_range=0.02,
                                   max_position_embeddings=512)))
    summary = {}
    chip_smoke.phase_train_dp(torch, np_, summary, device="cpu",
                              cfg_path=str(cfg),
                              run=dict(micro=4, samples=48, seq=64),
                              keep=str(tmp_path / "kept"))
    res = summary["train_dp"]
    assert res["compare"]["loss_max_rel"] <= chip_smoke.DP_TOL["loss"]
    assert res["compare"]["param_global_rel"] <= chip_smoke.DP_TOL["param"]
    assert (res["compare"]["grad_norm_max_rel"]
            <= chip_smoke.DP_TOL["grad_norm"])
    assert set(res["arms"]) == {"production", "production_rs",
                                "production_coalesced", "zero1_end_gather",
                                "fsdp", "fsdp_overlap", "model2"}
    # the model axis against the 1-rank reference, dropout off
    m2 = res["model2_compare"]
    assert m2["loss_max_rel"] <= chip_smoke.DP_TOL["loss"]
    assert m2["param_global_rel"] <= chip_smoke.DP_TOL["param"]
    assert m2["collectives_by_axis"]["model"]["bytes"] > 0
    assert len(res["seq512"]["kernels"]) == 2
    assert {"train_dp_fsdp", "train_dp_fsdp_overlap", "train_dp_model2",
            "train_dp_model2_compare",
            "train_dp_model2_seq512"} <= set(summary["launches"])
    mem = res["memory"]
    assert mem["fsdp"]["resting_f32_bytes"][0] < \
        mem["zero1_end_gather"]["resting_f32_bytes"][0]
    assert res["arms"]["production"]["mesh_config"] == "production"
    assert res["arms"]["production_rs"]["zero1_rs"]
    assert res["checkpoint"] == {"dir": str(tmp_path / "kept"), "step": 3}
    chip_smoke.phase_train_chunks(torch, np_, summary, device="cpu",
                                  cfg_path=str(cfg), micro=2, order=(1, 2),
                                  plain_rows=1)
    assert summary["train_chunks"]["init"] == [f"{tmp_path / 'kept'}@3"]
