"""The port's training ops against the JAX package's, on the same numpy
inputs: the counter-hash keep mask, the fused residual-dropout-LayerNorm
(forward and its four gradients) and the LayerNorm backward against the
Pallas kernels in interpret mode, and `hash_dropout` against JAX's
custom-VJP dropout. On the CPU the port's wrappers and autograd Functions
run the kernels' plain versions, which is what these tests hold.

Tolerances are the tiers tests/test_pallas.py holds the Pallas LayerNorm
to: forward 1e-5, gradients 2e-4 (f32; the two frameworks sum rows and
columns in another order). Masks, and hash_dropout (a select and one
division per element), are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

from bert_pytorch_tpu.ops.attention import hash_dropout as jax_hash_dropout
from bert_pytorch_tpu.ops.layernorm import _hash_keep_mask
from bert_pytorch_tpu.ops.layernorm import row_col_keep as jax_row_col_keep
from bert_pytorch_tpu.ops.pallas.layernorm import (
    add_dropout_layer_norm_pallas, layer_norm_pallas)
from bert_pytorch_tpu_torch.ops.attention import hash_dropout
from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bert_pytorch_tpu_torch.ops.layernorm import (
    add_dropout_layer_norm, add_dropout_layer_norm_bwd,
    add_dropout_layer_norm_fwd, add_dropout_layer_norm_ref, hash_keep_mask,
    layer_norm, layer_norm_bwd, layer_norm_fwd, layer_norm_ref, row_col_keep)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
SEEDS = (0, 7, -1, -1640531527, 2147483647, -2147483648)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ln_inputs(rows, cols, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, cols) * 2.0 + 0.5).astype(np.float32)
    res = rng.randn(rows, cols).astype(np.float32)
    scale = (1.0 + 0.2 * rng.randn(cols)).astype(np.float32)
    bias = (0.1 * rng.randn(cols)).astype(np.float32)
    g = rng.randn(rows, cols).astype(np.float32)
    return x, res, scale, bias, g


@pytest.mark.parametrize("row0", [0, 256, 98304])
@pytest.mark.parametrize("seed", SEEDS)
def test_row_col_keep_bit_equal_to_jax(seed, row0):
    for rate in (0.1, 0.5):
        want = np.asarray(jax_row_col_keep(jnp.int32(seed), row0, 260, 136,
                                           rate))
        got = row_col_keep(seed, row0, 260, 136, rate).numpy()
        np.testing.assert_array_equal(got, want)
    assert 0.85 < want.mean() < 0.95 or 0.45 < want.mean() < 0.55


@pytest.mark.parametrize("cols", [128, 1024])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_add_dropout_layer_norm_matches_pallas(rate, cols):
    """Forward within 1e-5 and dx, dres, dscale, dbias within 2e-4 of the
    Pallas kernel's custom VJP (interpret mode); 300 rows span two of its
    256-row blocks, so the mask's row counter crosses a block edge."""
    rows, seed = 300, -123456789
    x, res, scale, bias, g = _ln_inputs(rows, cols)
    jargs = [jnp.array(a) for a in (x, res, scale, bias)]
    want_y, vjp = jax.vjp(
        lambda a, r, s, b: add_dropout_layer_norm_pallas(
            a, r, s, b, jnp.int32(seed), rate, 1e-12, True), *jargs)
    want_grads = [np.asarray(v) for v in vjp(jnp.array(g))]

    tx, tres, ts, tb = (_t(a).requires_grad_() for a in (x, res, scale,
                                                          bias))
    y = add_dropout_layer_norm(tx, tres, ts, tb, seed, rate)
    y.backward(_t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for got, want in zip((tx.grad, tres.grad, ts.grad, tb.grad),
                         want_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    # dropped positions: dx is exactly 0 where the JAX mask drops, on
    # both sides, and the port's mask is JAX's bit for bit
    if rate > 0.0:
        keep = np.asarray(_hash_keep_mask(jnp.int32(seed), x.shape, rate))
        np.testing.assert_array_equal(
            hash_keep_mask(seed, x.shape, rate).numpy(), keep)
        np.testing.assert_array_equal(tx.grad.numpy() == 0, ~keep)
        np.testing.assert_array_equal(want_grads[0] == 0, ~keep)


def test_add_dropout_layer_norm_grads_match_autograd_of_plain():
    """The autograd Function (the kernels' plain forward and backward on
    the CPU) against autograd through the plain forward, in bf16 with bf16
    scale and bias (what a bf16-gradient step runs): same masks, and every
    gradient in its parameter's dtype."""
    x, res, scale, bias, g = _ln_inputs(96, 128, seed=2)
    bf = torch.bfloat16

    def grads(fn):
        leaves = [_t(a).to(bf).requires_grad_() for a in (x, res, scale,
                                                          bias)]
        fn(*leaves, 99, 0.1).backward(_t(g).to(bf))
        return [t.grad for t in leaves]

    got = grads(add_dropout_layer_norm)
    want = grads(add_dropout_layer_norm_ref)
    for a, b in zip(got, want):
        assert a.dtype == bf
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=5e-2)
    np.testing.assert_array_equal(got[0].float().numpy() == 0,
                                  want[0].float().numpy() == 0)


@pytest.mark.parametrize("cols", [128, 1024])
def test_layer_norm_backward_matches_pallas(cols):
    x, _, scale, bias, g = _ln_inputs(300, cols, seed=1)
    jargs = [jnp.array(a) for a in (x, scale, bias)]
    _, vjp = jax.vjp(lambda a, s, b: layer_norm_pallas(a, s, b, 1e-12, True),
                     *jargs)
    want = [np.asarray(v) for v in vjp(jnp.array(g))]
    tx, ts, tb = (_t(a).requires_grad_() for a in (x, scale, bias))
    layer_norm(tx, ts, tb).backward(_t(g))
    for got, w in zip((tx.grad, ts.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    # and against autograd through the plain forward
    tx2, ts2, tb2 = (_t(a).requires_grad_() for a in (x, scale, bias))
    layer_norm_ref(tx2, ts2, tb2).backward(_t(g))
    for a, b in ((tx.grad, tx2.grad), (ts.grad, ts2.grad),
                 (tb.grad, tb2.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [5, -77])
def test_hash_dropout_equals_jax(dtype, seed):
    """Forward and backward bit-equal to JAX's hash_dropout over a
    (B, H, S, S)-shaped probability tensor, f32 and bf16 (bf16 divides by
    1 - rate rounded to bf16)."""
    rng = np.random.RandomState(4)
    probs = rng.rand(2, 2, 32, 32).astype(np.float32)
    g = rng.randn(2, 2, 32, 32).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = jnp.array(probs).astype(jdt)
    want, vjp = jax.vjp(lambda p: jax_hash_dropout(p, jnp.int32(seed), 0.1),
                        jp)
    (want_g,) = vjp(jnp.array(g).astype(jdt))
    tp = _t(np.asarray(jp.astype(jnp.float32))).to(tdt).requires_grad_()
    out = hash_dropout(tp, seed, 0.1)
    out.backward(_t(np.asarray(jnp.array(g).astype(jdt).astype(
        jnp.float32))).to(tdt))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(tp.grad.float().numpy(),
                                  np.asarray(want_g.astype(jnp.float32)))


def test_wrappers_take_plain_versions_on_the_cpu():
    """On CPU tensors the four wrappers run the plain versions and count
    no launch."""
    reset_launches()
    x, res, scale, bias, g = (_t(a) for a in _ln_inputs(8, 64))
    y, mean, rstd = layer_norm_fwd(x, scale, bias)
    layer_norm_bwd(x, scale, mean, rstd, g)
    y, mean, rstd = add_dropout_layer_norm_fwd(x, res, scale, bias, 3, 0.1)
    dx, dres, dscale, dbias = add_dropout_layer_norm_bwd(
        x, res, scale, mean, rstd, g, 3, 0.1)
    assert dscale.dtype == dbias.dtype == torch.float32
    assert dx.shape == dres.shape == x.shape
    assert all(v == 0 for v in LAUNCHES.values())
