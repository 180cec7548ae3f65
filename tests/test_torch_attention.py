"""The port's attention (bert_pytorch_tpu_torch.ops.attention) against the
JAX package's on the same numpy inputs: the Pallas flash kernel in
interpret mode, in both of its grid layouts (native (B, S, H, D) and the
transposing (BH, S, D) one, forced with FLASH_LAYOUT=bh), and the
deterministic XLA attention.

Tolerance: 2e-5 on outputs and lse, the tier tests/test_pallas.py holds
the Pallas kernel to against plain softmax attention (online against
one-shot softmax, f32 throughout). Pad (segment-0) rows must be exactly
zero on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

from bert_pytorch_tpu.ops.attention import _xla_attention
from bert_pytorch_tpu.ops.pallas.flash_attention import _flash_fwd
from bert_pytorch_tpu_torch.ops import attention as tatt

TOL = 2e-5


def _inputs(s, segments, b=2, h=2, d=64, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) * 0.5
               for _ in range(3))
    seg = np.zeros((b, s), np.int32)
    if segments:
        # packed rows: segments of uneven length, then a pad tail
        for row, lengths in enumerate(([40, 25, s // 2 - 10], [s - 30])):
            cursor = 0
            for i, ln in enumerate(lengths):
                seg[row, cursor:cursor + ln] = i + 1
                cursor += ln
    else:
        seg[:, :s - 17] = 1
    bias = ((1.0 - (seg > 0).astype(np.float32)) * -10000.0)[:, None, None, :]
    return q, k, v, bias, (seg if segments else None)


def _jax_flash(q, k, v, bias, seg):
    b, s, h, _ = q.shape
    out, res = _flash_fwd(jnp.array(q), jnp.array(k), jnp.array(v),
                          jnp.array(bias),
                          None if seg is None else jnp.array(seg),
                          None, 0.0, True)
    lse = np.asarray(res[5]).reshape(b, h, s)  # (B, H, S) or (BH, 1, S)
    return np.asarray(out), lse


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("layout", ["native", "bh"])
@pytest.mark.parametrize("segments", [False, True],
                         ids=["bias", "bias+segments"])
@pytest.mark.parametrize("s", [128, 256])
def test_flash_ref_matches_pallas(s, segments, layout, monkeypatch):
    monkeypatch.setenv("FLASH_LAYOUT", layout)
    q, k, v, bias, seg = _inputs(s, segments)
    want_out, want_lse = _jax_flash(q, k, v, bias, seg)
    out, lse = tatt.flash_attention(*_torch(q, k, v, bias, seg))
    ref_out, ref_lse = tatt.flash_attention_ref(*_torch(q, k, v, bias, seg))
    for got, got_lse in ((out, lse), (ref_out, ref_lse)):
        assert got.shape == q.shape and got_lse.shape == (2, 2, s)
        np.testing.assert_allclose(got.numpy(), want_out, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=TOL,
                                   atol=TOL)
    if segments:
        pad = seg == 0
        assert pad.any()
        assert np.all(out.numpy()[pad] == 0.0)
        assert np.all(want_out[pad] == 0.0)


@pytest.mark.parametrize("segments", [False, True],
                         ids=["bias", "bias+segments"])
@pytest.mark.parametrize("s", [128, 256])
def test_attention_matches_xla(s, segments):
    """attention_ref (and dot_product_attention, which takes it at seq <=
    256) against the deterministic _xla_attention; flash_attention_ref is
    the same function."""
    q, k, v, bias, seg = _inputs(s, segments, seed=1)
    want = np.asarray(_xla_attention(
        jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(bias),
        None if seg is None else jnp.array(seg), None, 0.0, True))
    args = _torch(q, k, v, bias, seg)
    for got in (tatt.attention_ref(*args),
                tatt.dot_product_attention(*args),
                tatt.flash_attention_ref(*args)[0]):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_dot_product_attention_takes_flash_above_256():
    """The "auto" rule: seq 512 goes through the flash wrapper (its plain
    version on the CPU), and agrees with the dense path."""
    q, k, v, bias, seg = _inputs(512, True, b=2, h=1)
    args = _torch(q, k, v, bias, seg)
    got = tatt.dot_product_attention(*args)
    np.testing.assert_allclose(got.numpy(),
                               tatt.flash_attention(*args)[0].numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(),
                               tatt.attention_ref(*args).numpy(),
                               rtol=TOL, atol=TOL)


def test_bf16_attention_keeps_dtype():
    q, k, v, bias, seg = _inputs(128, True, seed=2)
    args = [a.to(torch.bfloat16) for a in _torch(q, k, v)] + \
        _torch(bias, seg)
    out, lse = tatt.flash_attention(*args)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dense = tatt.attention_ref(*args)
    assert dense.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), dense.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_flash_dropout_requires_seed():
    """A rate above 0 without a seed is refused, as the Pallas kernel
    requires one (tests/test_torch_flash_train.py holds the dropout arm
    against the Pallas kernels)."""
    q, k, v, bias, _ = _inputs(128, False)
    with pytest.raises(ValueError, match="dropout_seed"):
        tatt.flash_attention(*_torch(q, k, v, bias), dropout_rate=0.1)


def test_masks_match_jax():
    from bert_pytorch_tpu.ops.attention import (
        make_attention_bias, make_segment_attention_bias)

    _, _, _, _, seg = _inputs(128, True)
    mask = (seg > 0).astype(np.int32)
    np.testing.assert_array_equal(
        tatt.make_attention_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(make_attention_bias(jnp.array(mask))))
    np.testing.assert_array_equal(
        tatt.make_segment_attention_bias(torch.from_numpy(seg)).numpy(),
        np.asarray(make_segment_attention_bias(jnp.array(seg))))
