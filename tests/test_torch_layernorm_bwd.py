"""The port's LayerNorm backwards (#2, and #4 the fused residual-dropout
one) against the Pallas kernels' custom VJPs in interpret mode, on the same
numpy inputs, in f32 and bf16, at rates 0 and 0.1 with a negative seed: at
a row count that fills no CTA of either Hopper backward kernel (300 rows:
the row kernel's CTAs take 8 rows at that count, the generic one's 32),
and at a phase-2-style (B, S, E) activation. On the CPU the wrappers run
the kernels' plain versions, which is what these tests hold. And source
guards: the CUDA backward uses no float atomics, and the port's LayerNorm
module calls no library LayerNorm and no torch.compile.

Tolerances are the tiers of tests/test_pallas.py: gradients 2e-4, masks
exact. In bf16 both sides compute one f32 value from the same bf16 inputs
(up to the order of the row sums) and round it to bf16, so dx and dres may
also land one bf16 step apart (2^-8 of the value) where that f32 value
sits at a rounding edge: their tolerance is 2e-4 plus 2^-8 relative.
dscale and dbias are f32 on both sides and take 2e-4."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

from bert_pytorch_tpu.ops.layernorm import _hash_keep_mask
from bert_pytorch_tpu.ops.pallas.layernorm import (
    add_dropout_layer_norm_pallas, layer_norm_pallas)
from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bert_pytorch_tpu_torch.ops.layernorm import (
    add_dropout_layer_norm_bwd, add_dropout_layer_norm_fwd, hash_keep_mask,
    layer_norm_bwd, layer_norm_fwd)

GRAD_TOL = 2e-4
BF16_STEP = 2.0 ** -8
SEED = -1640531527
# (300, E): rows that fill no CTA of either kernel; (2, 64, E): phase 2's
# (B, S, E) layout at a narrow width
SHAPES = [(300, 128), (2, 64, 256)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=3):
    rng = np.random.RandomState(seed)
    cols = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32)
    scale = (1.0 + 0.2 * rng.randn(cols)).astype(np.float32)
    bias = (0.1 * rng.randn(cols)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, res, scale, bias, g


def _cast(a, dtype):
    """(the array in JAX's dtype, the same values as a torch tensor)"""
    jdt, tdt = DTYPES[dtype]
    j = jnp.array(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    rtol = GRAD_TOL + (BF16_STEP if dtype == "bfloat16" else 0.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=GRAD_TOL,
                               err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_bwd_matches_pallas(dtype, shape):
    """#2: dx in x's dtype and f32 dscale, dbias against the Pallas
    `_bwd_kernel`'s VJP, from the port forward's f32 statistics."""
    x, _, scale, bias, g = _inputs(shape)
    jx, tx = _cast(x, dtype)
    jg, tg = _cast(g, dtype)
    _, vjp = jax.vjp(lambda a, s, b: layer_norm_pallas(a, s, b, 1e-12, True),
                     jx, jnp.array(scale), jnp.array(bias))
    want = vjp(jg)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    _, mean, rstd = layer_norm_fwd(tx, ts, tb)
    got = layer_norm_bwd(tx, ts, mean, rstd, tg)
    assert got[0].dtype == tx.dtype and got[0].shape == tx.shape
    assert got[1].dtype == got[2].dtype == torch.float32
    for what, a, b in zip(("dx", "dscale", "dbias"), got, want):
        _close(a, b, dtype if what == "dx" else "float32", what)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_dropout_layer_norm_bwd_matches_pallas(dtype, rate, shape):
    """#4: dx, dres in x's dtype and f32 dscale, dbias against the Pallas
    `_adln_bwd_kernel`'s VJP, the mask regenerated from a negative seed;
    dx is exactly 0 where JAX's mask drops, on both sides."""
    x, res, scale, bias, g = _inputs(shape)
    jx, tx = _cast(x, dtype)
    jr, tr = _cast(res, dtype)
    jg, tg = _cast(g, dtype)
    _, vjp = jax.vjp(
        lambda a, r, s, b: add_dropout_layer_norm_pallas(
            a, r, s, b, jnp.int32(SEED), rate, 1e-12, True),
        jx, jr, jnp.array(scale), jnp.array(bias))
    want = vjp(jg)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    _, mean, rstd = add_dropout_layer_norm_fwd(tx, tr, ts, tb, SEED, rate)
    got = add_dropout_layer_norm_bwd(tx, tr, ts, mean, rstd, tg, SEED, rate)
    assert got[0].dtype == got[1].dtype == tx.dtype
    assert got[2].dtype == got[3].dtype == torch.float32
    for what, a, b in zip(("dx", "dres", "dscale", "dbias"), got, want):
        _close(a, b, dtype if what in ("dx", "dres") else "float32", what)
    if rate > 0.0:
        keep = np.asarray(_hash_keep_mask(jnp.int32(SEED), x.shape, rate))
        np.testing.assert_array_equal(
            hash_keep_mask(SEED, x.shape, rate).numpy(), keep)
        np.testing.assert_array_equal(got[0].float().numpy() == 0, ~keep)
        np.testing.assert_array_equal(
            np.asarray(want[0].astype(jnp.float32)) == 0, ~keep)


def test_backward_wrappers_count_no_launch_on_the_cpu():
    """CPU tensors take the plain versions: no launch is counted."""
    reset_launches()
    x, res, scale, bias, g = (torch.from_numpy(a).to(torch.bfloat16)
                              for a in _inputs((40, 128)))
    _, mean, rstd = layer_norm_fwd(x, scale, bias)
    layer_norm_bwd(x, scale, mean, rstd, g)
    add_dropout_layer_norm_bwd(x, res, scale, mean, rstd, g, SEED, 0.1)
    assert all(v == 0 for v in LAUNCHES.values())


def _source(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return f.read()


def _code(text):
    """C++ or Python source without its comments and docstrings."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    text = re.sub(r'""".*?"""', "", text, flags=re.S)
    return re.sub(r"#[^\n]*", "", text)


def test_layernorm_cuda_uses_no_float_atomics():
    """The cross-row sums' order is fixed by the shape: no atomicAdd (float
    or any other) and no atomic reduction instruction in layernorm.cu."""
    code = _code(_source("bert_pytorch_tpu_torch", "ops", "kernels", "csrc",
                         "layernorm.cu"))
    assert "ln_bwd_row_kernel" in code and "column_sum_kernel" in code
    assert not re.search(r"\batomic\w*\s*\(|\bred\.|\batom\.", code)


def test_layernorm_module_calls_no_library_layer_norm():
    """No library LayerNorm (backward or forward) and no torch.compile on
    the port's LayerNorm path: the kernels or their plain versions only."""
    code = _code(_source("bert_pytorch_tpu_torch", "ops", "layernorm.py"))
    for name in ("native_layer_norm", "layer_norm_backward", "F.layer_norm",
                 "functional.layer_norm", "torch.layer_norm",
                 "nn.LayerNorm", "torch.compile"):
        assert name not in code, name


PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN12bert_kernels17ln_bwd_row_kernelILb1EEEvPKtS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12bert_kernels17ln_bwd_row_kernelILb1EEEvPKtS3_
    144 bytes stack frame, 468 bytes spill stores, 284 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 32768 bytes smem
ptxas info    : Compiling entry function '_ZN12bert_kernels17column_sum_kernelEPKfiiPfS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12bert_kernels17column_sum_kernelEPKfiiPfS3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 23 registers, used 1 barriers, 1024 bytes smem
"""


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_chip_smoke_reads_ptxas_registers_and_spills():
    """chip_smoke.py's build phase reads the row kernel's registers and
    spills out of ptxas's report (and fails the build on a spill)."""
    chip_smoke = _chip_smoke()

    got = chip_smoke.ptxas_entries(PTXAS_REPORT, ("ln_bwd_row_kernel",))
    assert list(got) == ["ln_bwd_row_kernelILb1EEEvPKtS3_"]
    assert got["ln_bwd_row_kernelILb1EEEvPKtS3_"] == {
        "spill_store_bytes": 468, "spill_load_bytes": 284, "registers": 255}
    both = chip_smoke.ptxas_entries(PTXAS_REPORT, ("ln_bwd_row", "column_sum"))
    assert both["column_sum_kernelEPKfiiPfS3_"]["registers"] == 23


def test_chip_smoke_kernels_line_carries_both_phases_of_the_backward():
    """The kernels line's LayerNorm-backward rows carry phase 1's numbers,
    both phases' under `variants`, and the row and column passes."""
    chip_smoke = _chip_smoke()

    results = {name: {"max_abs_err": {"bfloat16": 0.01}}
               for name in chip_smoke.KERNEL_ROWS}
    phase1 = dict(ms=0.05, plain_ms=1.0, bound_ms=0.03, bound_by="bytes",
                  library_ms=None, shape=[12288, 1024], rate=0.1,
                  row_ms=0.045, column_ms=0.003)
    results["add_dropout_layer_norm_bwd"].update(phase1)
    results["add_dropout_layer_norm_bwd"]["phase2"] = dict(
        phase1, ms=0.035, shape=[8192, 1024])
    line = {r["name"]: r for r in chip_smoke.kernels_line(results, {}, {})}
    row = line["add_dropout_layer_norm_bwd"]
    assert row["ms"] == 0.05 and row["shape"] == [12288, 1024]
    assert row["row_ms"] == 0.045 and row["column_ms"] == 0.003
    assert row["replaces"].endswith("layernorm.py:311")
    assert row["variants"]["train"]["ms"] == 0.05
    assert row["variants"]["train_phase2"]["ms"] == 0.035
    assert row["variants"]["train_phase2"]["max_abs_err"] == 0.01
