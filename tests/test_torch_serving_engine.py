"""The port's serving engine and weights against the JAX package, on the
CPU, at 2 layers, E 64 and buckets (16, 32):

- the relu, swish and tanh activations against JAX's, alone and as the
  hidden_act of a 2-layer QA model, at the forward and gradient tiers of
  tests/test_pallas.py (1e-5 / 2e-4);
- the bf16 weight copy (models/bert.cast_for_serving) bit-equal to the
  f32-master model of every task;
- the engine's `captures` flat after warmup under traffic that mixes the
  buckets (the counterpart of the JAX engine's zero-recompile pin), and
  the launch counts a graph's capture records and each replay adds;
- int8 weights (serving/quantize.py): q8 and the scales equal to JAX's
  quantize_tree exactly, from both encoder layouts of the checkpoint; the
  int8 forward at f32 compute within the 2e-5 flash tier of JAX's
  `wrap_forward(forward, jnp.float32)`; `decode_delta` within 1e-5 of
  JAX's; `corrupt_scales` tripping the gate in both, and the port's
  `serve` refusing to start on it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)
from flax import traverse_util

from bert_pytorch_tpu.config import BertConfig as JaxBertConfig
from bert_pytorch_tpu.models import BertForQuestionAnswering as JaxQA
from bert_pytorch_tpu.models.pretrained import convert_tree_layout
from bert_pytorch_tpu.training.state import unbox
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models.bert import (BertForQuestionAnswering,
                                                cast_for_serving,
                                                init_weights)
from bert_pytorch_tpu_torch.models.convert import params_from_flax

CFG = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=64, next_sentence=True,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
BUCKETS = (16, 32)
FWD_TOL, GRAD_TOL = 1e-5, 2e-4      # tests/test_pallas.py's tiers
INT8_TOL = 2e-5                     # the flash f32 tier
DELTA_TOL = 1e-5


def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


def _jax_qa(stacked=True, dtype=jnp.float32, **over):
    cfg = JaxBertConfig(**dict(CFG, **over), stacked_params=stacked)
    model = JaxQA(cfg, dtype=dtype)
    s = jnp.zeros((1, 16), jnp.int32)
    params = unbox(model.init(jax.random.PRNGKey(0), s, s, s)["params"])
    return cfg, model, params


def _port_qa(flat, dtype=torch.float32, **over):
    model = BertForQuestionAnswering(BertConfig(**dict(CFG, **over)),
                                     dtype=dtype)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model.eval()


def _packed_batch(rows=2, bucket=32, seed=3):
    """(rows, bucket) packed rows: two or three segments and a pad tail."""
    from bert_pytorch_tpu_torch.serving.engine import zero_batch

    rng = np.random.RandomState(seed)
    batch = zero_batch(rows, bucket)
    for row, lengths in enumerate(([9, 12, 7], [20, 6])[:rows]):
        cursor = 0
        for i, ln in enumerate(lengths):
            sl = slice(cursor, cursor + ln)
            batch["input_ids"][row, sl] = rng.randint(5, CFG["vocab_size"],
                                                      ln)
            batch["token_type_ids"][row, sl] = np.arange(ln) >= ln // 2
            batch["attention_mask"][row, sl] = 1
            batch["segment_ids"][row, sl] = i + 1
            batch["position_ids"][row, sl] = np.arange(ln)
            cursor += ln
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v, np.int32))
            for k, v in batch.items()}


# -- the three activations (ROADMAP queue C item 3) ---------------------------

@pytest.mark.parametrize("act", ["relu", "swish", "tanh"])
def test_activation_matches_jax(act):
    from bert_pytorch_tpu.ops.activations import ACT2FN as JAX_ACT
    from bert_pytorch_tpu_torch.ops.activations import ACT2FN

    rng = np.random.RandomState(0)
    x = rng.uniform(-4, 4, (8, 37)).astype(np.float32)
    w = rng.standard_normal((8, 37)).astype(np.float32)
    want = np.asarray(JAX_ACT[act](jnp.asarray(x)))
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(JAX_ACT[act](v) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ACT2FN[act](xt)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=GRAD_TOL,
                               atol=GRAD_TOL)

    # a 2-layer model built with that hidden_act: logits and gradients
    from bert_pytorch_tpu.tasks.predict import build_qa_forward

    _, model, params = _jax_qa(hidden_act=act)
    batch = _packed_batch()
    wts = rng.standard_normal((2, 2, 32)).astype(np.float32)
    fwd = build_qa_forward(model)

    def loss(p):
        s, e = fwd(p, {k: jnp.asarray(v) for k, v in batch.items()})
        return jnp.sum(s * wts[0]) + jnp.sum(e * wts[1]), (s, e)

    (_, (s_j, e_j)), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    port = _port_qa(_flat(params), hidden_act=act)
    s_p, e_p = port(**_torch_batch(batch))
    (torch.sum(s_p * torch.from_numpy(wts[0]))
     + torch.sum(e_p * torch.from_numpy(wts[1]))).backward()
    for got, want in ((s_p, s_j), (e_p, e_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    want_grads = params_from_flax(_flat(g_j))
    for name, p in port.named_parameters():
        # the QA head leaves the pooler unused: no gradient, JAX's zeros
        got_g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        np.testing.assert_allclose(got_g, want_grads[name].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


# -- the bf16 weight copy -----------------------------------------------------

SERVE_OPTS = {"class_names": ["negative", "positive"], "embed_labels": 2,
              "max_segments": 8, "labels": ["O", "B-PER", "I-PER"]}


@pytest.mark.parametrize("task", ["choice", "classify", "embed", "ner",
                                  "squad"])
def test_bf16_copy_bit_equal_to_the_f32_master_model(task):
    from bert_pytorch_tpu_torch.tasks import registry

    spec = registry.get(task)
    cfg = BertConfig(**CFG)
    master = spec.build_serving_model(cfg, torch.bfloat16, SERVE_OPTS,
                                      torch.device("cpu"))
    init_weights(master, torch.Generator().manual_seed(7))
    copy = spec.build_serving_model(cfg, torch.bfloat16, SERVE_OPTS,
                                    torch.device("cpu"))
    copy.load_state_dict(master.state_dict(), strict=True)
    cast_for_serving(copy, torch.bfloat16)
    dtypes = {n: p.dtype for n, p in copy.named_parameters()}
    assert all(d == torch.bfloat16 for n, d in dtypes.items()
               if not ("layer_norm" in n and n.endswith(("scale", "bias"))))
    assert all(d == torch.float32 for n, d in dtypes.items()
               if "layer_norm" in n)
    batch = _torch_batch(_packed_batch())
    with torch.inference_mode():
        want = spec.forward_builder(master.eval())(batch)
        got = spec.forward_builder(copy.eval())(batch)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# -- captures flat after warmup -----------------------------------------------

def test_captures_flat_after_warmup_across_buckets():
    """The counterpart of the JAX engine's zero-recompile pin: `captures`
    (on the CPU, the forwards warmup built) does not move however the
    traffic mixes the buckets."""
    from bert_pytorch_tpu_torch.serving.batcher import Scheduler
    from bert_pytorch_tpu_torch.serving.engine import TorchServingEngine
    from bert_pytorch_tpu_torch.tasks import predict

    _, _, params = _jax_qa()
    model = _port_qa(_flat(params))
    engine = TorchServingEngine({"squad": predict.build_qa_forward(model)},
                                torch.device("cpu"), buckets=BUCKETS,
                                batch_rows=2, max_segments=2)
    assert not engine.graphs_on and engine.captures == 0
    assert engine.warmup() == 2
    warm = engine.captures
    assert warm == 2
    sch = Scheduler(engine, packing=True, batch_wait_ms=0.5).start()
    try:
        rng = np.random.RandomState(2)
        for _ in range(3):
            handles = [sch.submit("squad",
                                  rng.randint(5, 64, (ln,)).astype(np.int32))
                       for ln in (3, 16, 9, 32, 12, 7)]  # both buckets
            for h in handles:
                sch.result(h, timeout=60)
    finally:
        sch.close()
    assert engine.captures == warm
    assert all(engine.forward_counts[("squad", b)] >= 1 for b in BUCKETS)


def test_launch_recording_counts_capture_times_replays():
    from bert_pytorch_tpu_torch.ops import kernels

    kernels.reset_launches()
    kernels.count_launch("layer_norm_fwd")
    with kernels.recording_launches() as rec:
        for _ in range(3):
            kernels.count_launch("layer_norm_fwd")
        kernels.count_launch("flash_attention_fwd")
        with pytest.raises(RuntimeError, match="already"):
            with kernels.recording_launches():
                pass
    assert kernels.LAUNCHES["layer_norm_fwd"] == 1   # nothing launched
    for _ in range(4):
        kernels.replay_launches(rec)
    assert kernels.LAUNCHES["layer_norm_fwd"] == 1 + 3 * 4
    assert kernels.LAUNCHES["flash_attention_fwd"] == 4
    kernels.count_launch("layer_norm_fwd")           # recording closed
    assert kernels.LAUNCHES["layer_norm_fwd"] == 14
    kernels.reset_launches()


# -- int8 weights -------------------------------------------------------------

def _jax_quantized(flat_params_stacked):
    from bert_pytorch_tpu.serving import quantize as jq

    nested = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat_params_stacked.items()})
    return jq.quantize_tree(nested)


def _split_quantized(qtree):
    """A JAX quantized tree -> (flat q8 as f32 with passthrough leaves,
    flat dequantized f32 (q8 * scale), flat scales) by flax key."""
    flat = traverse_util.flatten_dict(qtree, sep="/")
    q8, deq, scales = {}, {}, {}
    for key, v in flat.items():
        base, _, last = key.rpartition("/")
        if last == "q8":
            scale = np.asarray(flat[base + "/scale"], np.float32)
            q8[base] = np.asarray(v).astype(np.float32)
            deq[base] = np.asarray(v).astype(np.float32) * scale
            scales[base] = scale
        elif not (last == "scale" and base + "/q8" in flat):
            q8[key] = deq[key] = np.asarray(v)
    return q8, deq, scales


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_quantize_tree_equals_jax(layout):
    """From either layout of the checkpoint, the port quantizes as the JAX
    server does after restoring it into its stacked serving layout."""
    from bert_pytorch_tpu_torch.serving import quantize as pq

    _, _, params = _jax_qa(stacked=layout == "stacked")
    served = convert_tree_layout(params, stacked=True)
    q8_j, deq_j, scales_j = _split_quantized(
        _jax_quantized(_flat(served))[0])
    qstate, stats = pq.quantize_tree(params_from_flax(_flat(params)),
                                     head_dim=16)
    want_q8 = params_from_flax(q8_j)
    want_deq = params_from_flax(deq_j)
    assert set(qstate) == set(want_q8)
    n_quantized = 0
    for key, leaf in qstate.items():
        if pq.is_quantized_leaf(leaf):
            n_quantized += 1
            assert leaf["q8"].dtype == torch.int8
            assert torch.equal(leaf["q8"].float(), want_q8[key]), key
            assert torch.equal(leaf["q8"].float() * leaf["scale"],
                               want_deq[key]), key
        else:
            assert torch.equal(leaf, want_q8[key]), key
    # every JAX q8 leaf is a quantized port tensor, the encoder's layer by
    # layer; biases of the head and the embedding LayerNorm stay float
    assert n_quantized == sum(
        2 if k.startswith("bert/encoder/") else 1 for k in scales_j)
    assert not pq.is_quantized_leaf(qstate["qa_outputs.bias"])
    assert pq.is_quantized_leaf(
        qstate["bert.encoder.layers.1.attention.qkv.bias"])
    assert stats["quantized_leaves"] == len(scales_j)
    # one D-scale of the stacked QKV kernel, shared by layers, q/k/v and
    # heads; one scale a column of the word embeddings
    d_scale = scales_j["bert/encoder/layers/layer/attention/qkv/kernel"]
    for layer in (0, 1):
        s = qstate[f"bert.encoder.layers.{layer}.attention.qkv.weight"][
            "scale"]
        np.testing.assert_array_equal(s.numpy().reshape(12, 16),
                                      np.broadcast_to(d_scale.reshape(1, 16),
                                                      (12, 16)))
    np.testing.assert_array_equal(
        qstate["bert.embeddings.word_embeddings.weight"]["scale"].numpy(),
        scales_j["bert/embeddings/word_embeddings/embedding"].reshape(1, -1))


@pytest.fixture(scope="module")
def int8_pair():
    """(JAX model and stacked params, its quantized tree, the port's
    quantized state) of one QA model."""
    from bert_pytorch_tpu_torch.serving import quantize as pq

    _, model, params = _jax_qa()
    qtree, _ = _jax_quantized(_flat(params))
    qstate, _ = pq.quantize_tree(params_from_flax(_flat(params)),
                                 head_dim=16)
    return model, params, qtree, qstate


def test_int8_forward_at_f32_matches_jax(int8_pair):
    from bert_pytorch_tpu.serving import quantize as jq
    from bert_pytorch_tpu.tasks.predict import build_qa_forward
    from bert_pytorch_tpu_torch.serving import quantize as pq

    model, _, qtree, qstate = int8_pair
    batch = pq.probe_batch(2, 32, CFG["vocab_size"])
    want = jq.wrap_forward(build_qa_forward(model), jnp.float32)(
        qtree, {k: jnp.asarray(v) for k, v in batch.items()})
    port = pq.apply_int8(
        BertForQuestionAnswering(BertConfig(**CFG), dtype=torch.float32),
        qstate, torch.float32)
    assert port.bert.encoder.layers[0].intermediate.parametrizations[
        "weight"].original.dtype == torch.int8
    with torch.inference_mode():
        got = port.eval()(**_torch_batch(batch))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=INT8_TOL,
                                   atol=INT8_TOL)


def _port_delta(qstate, dtype=torch.bfloat16):
    from bert_pytorch_tpu_torch.serving import quantize as pq
    from bert_pytorch_tpu_torch.tasks import predict

    _, _, params = _jax_qa()
    ref = _port_qa(_flat(params))
    qmodel = pq.apply_int8(
        BertForQuestionAnswering(BertConfig(**CFG), dtype=dtype), qstate,
        dtype)
    return pq.decode_delta(predict.build_qa_forward(ref),
                           predict.build_qa_forward(qmodel.eval()),
                           pq.probe_batch(2, 16, CFG["vocab_size"]))


def _jax_delta(qtree, dtype=jnp.bfloat16):
    from bert_pytorch_tpu.serving import quantize as jq
    from bert_pytorch_tpu.tasks.predict import build_qa_forward

    _, ref_model, params = _jax_qa()
    _, q_model, _ = _jax_qa(dtype=dtype)
    batch = {k: jnp.asarray(v) for k, v in
             jq.probe_batch(2, 16, CFG["vocab_size"]).items()}
    return jq.decode_delta(build_qa_forward(ref_model), params,
                           jq.wrap_forward(build_qa_forward(q_model), dtype),
                           qtree, batch)


def test_decode_delta_matches_jax(int8_pair):
    """The gate's number at f32 compute, where it measures the int8
    weights alone, within 1e-5 of JAX's. The server's gate computes in
    bf16, where the two frameworks round activations at different points
    (their rel_delta differ by ~2e-3 here); both stay well inside 0.1."""
    _, _, qtree, qstate = int8_pair
    want = _jax_delta(qtree, jnp.float32)
    got = _port_delta(qstate, torch.float32)
    assert 0 < want["rel_delta"] < 0.1
    assert abs(got["rel_delta"] - want["rel_delta"]) <= DELTA_TOL, (got,
                                                                   want)
    assert got["argmax_agreement"] == want["argmax_agreement"]
    assert _jax_delta(qtree)["rel_delta"] < 0.1
    assert _port_delta(qstate)["rel_delta"] < 0.1


def test_corrupt_scales_trips_the_gate(int8_pair, tmp_path, monkeypatch):
    from bert_pytorch_tpu.serving import quantize as jq
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.serving import quantize as pq

    _, params, qtree, qstate = int8_pair
    assert _jax_delta(jq.corrupt_scales(qtree))["rel_delta"] > 0.1
    assert _port_delta(pq.corrupt_scales(qstate))["rel_delta"] > 0.1

    # the port's server: the clean int8 weights pass at 0.1, corrupted
    # ones are refused before a request is admitted
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
                               + [f"w{i}" for i in range(60)]) + "\n")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CFG))
    np.savez(tmp_path / "squad.npz", **_flat(params))
    argv = ["--model_config_file", str(cfg), "--vocab_file", str(vocab),
            "--task_checkpoint", f"squad={tmp_path / 'squad.npz'}",
            "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
            "--buckets", "16,32", "--batch_rows", "2",
            "--serve_dtype", "int8"]
    handle = run_server.serve(run_server.parse_arguments(argv),
                              log=lambda m: None)
    try:
        delta = handle.int8_deltas["squad"]
        assert 0 < delta["rel_delta"] <= 0.1
        assert handle.engine.captures == 2
    finally:
        handle.close()
    real = pq.quantize_tree
    monkeypatch.setattr(pq, "quantize_tree", lambda *a, **k: (
        pq.corrupt_scales(real(*a, **k)[0]), real(*a, **k)[1]))
    with pytest.raises(SystemExit, match="int8 accuracy gate: task "
                                         "'squad'") as e:
        run_server.serve(run_server.parse_arguments(argv),
                         log=lambda m: None)
    assert e.value.code not in (0, None)
