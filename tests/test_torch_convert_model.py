"""The port's BertForQuestionAnswering against the JAX package's, through
the parameter bridge models/convert.params_from_flax: a 2-layer, H=128,
A=2 model initialised in JAX, in both encoder layouts (stacked
`encoder/layers/...` with a leading L axis, and unstacked
`encoder/layer_{i}/...`), its params flattened to numpy, converted and
loaded strictly. Start and end logits must agree on the same inputs,
plain padded rows and packed rows (position_ids / segment_ids), the packed
case at seq 320 so the port's flash route (its plain version on the CPU)
runs too.

Tolerances: f32 at 1e-4 — two layers of matmuls and reductions summed in
another order by the two frameworks. bf16 at 5e-2 absolute on logits of
spread ~0.3 — the frameworks round to bf16 at different points (matmul
outputs, GELU, residual adds), each worth up to 2^-8 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)
from flax import traverse_util

from bert_pytorch_tpu.config import BertConfig as JaxBertConfig
from bert_pytorch_tpu.models import BertForQuestionAnswering as JaxQA
from bert_pytorch_tpu.training.state import unbox
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models.bert import (BertForQuestionAnswering,
                                                init_weights)
from bert_pytorch_tpu_torch.models.convert import (load_serving_params,
                                                   params_from_flax,
                                                   unstack_layers)

CFG = dict(vocab_size=64, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=512, next_sentence=True,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=["stacked", "unstacked"])
def flax_params(request):
    cfg = JaxBertConfig(**CFG, stacked_params=request.param == "stacked")
    model = JaxQA(cfg, dtype=jnp.float32)
    s = jnp.zeros((1, 16), jnp.int32)
    params = unbox(model.init(jax.random.PRNGKey(0), s, s, s)["params"])
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    return cfg, params, flat


def _batch(kind):
    rng = np.random.RandomState(3)
    if kind == "plain":
        b, s = 2, 96
        ids = rng.randint(5, 64, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.int32)
        mask[1, 70:] = 0
        types = np.zeros((b, s), np.int32)
        types[:, 40:] = 1
        return {"input_ids": ids * mask, "token_type_ids": types * mask,
                "attention_mask": mask}
    b, s = 2, 320
    batch = {k: np.zeros((b, s), np.int32) for k in
             ("input_ids", "token_type_ids", "attention_mask",
              "position_ids", "segment_ids")}
    for row, lengths in enumerate(([100, 60, 120], [300])):
        cursor = 0
        for i, ln in enumerate(lengths):
            sl = slice(cursor, cursor + ln)
            batch["input_ids"][row, sl] = rng.randint(5, 64, ln)
            batch["token_type_ids"][row, sl] = (np.arange(ln) >= ln // 3)
            batch["attention_mask"][row, sl] = 1
            batch["segment_ids"][row, sl] = i + 1
            batch["position_ids"][row, sl] = np.arange(ln)
            cursor += ln
    return batch


def _port_model(flat, dtype):
    model = BertForQuestionAnswering(BertConfig.from_dict(CFG), dtype=dtype)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_qa_logits_match_jax(flax_params, kind, dtype):
    cfg, params, flat = flax_params
    jdt, tdt = DTYPES[dtype]
    batch = _batch(kind)
    extra = {k: jnp.array(batch[k]) for k in ("position_ids", "segment_ids")
             if k in batch}
    want = JaxQA(cfg, dtype=jdt).apply(
        {"params": params}, jnp.array(batch["input_ids"]),
        jnp.array(batch["token_type_ids"]),
        jnp.array(batch["attention_mask"]), deterministic=True, **extra)
    model = _port_model(flat, tdt)
    with torch.inference_mode():
        got = model(**{k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        real = batch["attention_mask"] > 0
        np.testing.assert_allclose(g.numpy()[real], np.asarray(w)[real],
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_layouts_convert_to_the_same_state_dict(flax_params):
    """Stacked leaves unstack into exactly the unstacked layout's keys,
    and every port parameter is covered with the right shape."""
    _, _, flat = flax_params
    sd = params_from_flax(flat)
    ref = BertForQuestionAnswering(BertConfig.from_dict(CFG)).state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    unstacked = unstack_layers(flat)
    assert not any(k.startswith("bert/encoder/layers/") for k in unstacked)
    np.testing.assert_array_equal(
        sd["bert.encoder.layers.1.attention.qkv.weight"].numpy(),
        unstacked["bert/encoder/layer_1/attention/qkv/kernel"]
        .reshape(128, -1).T)


def test_load_serving_params_npz_and_pt(flax_params, tmp_path):
    _, _, flat = flax_params
    npz = tmp_path / "qa.npz"
    np.savez(npz, **flat)
    from_npz = load_serving_params(str(npz))
    pt = tmp_path / "qa.pt"
    torch.save(from_npz, pt)
    from_pt = load_serving_params(str(pt))
    assert set(from_npz) == set(from_pt)
    for k in from_npz:
        assert torch.equal(from_npz[k], from_pt[k])
    with pytest.raises(ValueError):
        load_serving_params(str(tmp_path / "qa.bin"))


def test_init_weights_is_seeded():
    cfg = BertConfig.from_dict(CFG)
    a = init_weights(BertForQuestionAnswering(cfg),
                     torch.Generator().manual_seed(7))
    b = init_weights(BertForQuestionAnswering(cfg),
                     torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    ln = a.bert.encoder.layers[0].attention_layer_norm
    assert torch.all(ln.scale == 1) and torch.all(ln.bias == 0)
    assert abs(float(a.qa_outputs.weight.detach().std()) - 0.02) < 0.005
