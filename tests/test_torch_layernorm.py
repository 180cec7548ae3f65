"""The port's LayerNorm (bert_pytorch_tpu_torch.ops.layernorm) against the
JAX package's: the Pallas kernel in interpret mode and the XLA path, on
the same numpy inputs. On the CPU the port's dispatcher and kernel
wrapper take the plain version, which is what these tests hold.

Tolerance: f32 at 1e-5, the tier tests/test_pallas.py holds the Pallas
kernel to against the XLA path (the two sum rows in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

from bert_pytorch_tpu.ops.layernorm import _layer_norm_xla
from bert_pytorch_tpu.ops.pallas.layernorm import layer_norm_pallas
from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bert_pytorch_tpu_torch.ops.layernorm import (layer_norm, layer_norm_fwd,
                                                  layer_norm_ref)


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    scale = rng.randn(shape[-1]).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(4, 300, 256), (2, 64, 1024), (16, 128)])
def test_layer_norm_matches_pallas_and_xla(shape):
    x, scale, bias = _inputs(shape)
    jx, js, jb = jnp.array(x), jnp.array(scale), jnp.array(bias)
    pallas = np.asarray(layer_norm_pallas(jx, js, jb, 1e-12, True))
    xla = np.asarray(_layer_norm_xla(jx, js, jb, 1e-12))
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    for got in (layer_norm_ref(tx, ts, tb).numpy(),
                layer_norm(tx, ts, tb).numpy(),
                layer_norm_fwd(tx, ts, tb)[0].numpy()):
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_layer_norm_stats_match_definition():
    """mean / rstd, which the kernel writes for the backward pass, are the
    f32 row statistics (rstd = 1 / sqrt(var + 1e-12))."""
    x, scale, bias = _inputs((8, 96))
    _, mean, rstd = layer_norm_fwd(torch.from_numpy(x),
                                   torch.from_numpy(scale),
                                   torch.from_numpy(bias))
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), x64.mean(-1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), 1.0 / np.sqrt(x64.var(-1)
                                                           + 1e-12),
                               rtol=1e-5)
    assert mean.dtype == rstd.dtype == torch.float32


def test_layer_norm_bf16_keeps_dtype_and_matches_xla():
    """bf16 in, bf16 out, f32 statistics: equal to the JAX XLA path on the
    same bf16 input within one bf16 step."""
    x, scale, bias = _inputs((4, 32, 256), seed=1)
    xb = jnp.array(x, jnp.bfloat16)
    want = np.asarray(_layer_norm_xla(xb, jnp.array(scale), jnp.array(bias),
                                      1e-12).astype(jnp.float32))
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    got = layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=2e-2)


def test_cpu_tensors_launch_no_kernel():
    """The launch count moves only where a kernel launched: a CPU tensor
    takes the plain version and counts nothing."""
    reset_launches()
    x, scale, bias = _inputs((4, 64))
    layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    assert LAUNCHES["layer_norm_fwd"] == 0
