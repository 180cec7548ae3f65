"""The port's fused flash-attention backward (`flash_attention_bwd`, the
CUDA kernel of ops/kernels/csrc/flash_attention_bwd.cu) against the fused
Pallas backward kernels it replaces, on the CPU: `_dqkv_kernel_native`
(#7, the default layout at these shapes) and `_dqkv_kernel` (#8,
FLASH_LAYOUT=bh), run in interpret mode through the custom VJP of the
Pallas flash attention, as tests/test_torch_flash_train.py runs them. On
the CPU the wrapper runs its plain version, flash_attention_bwd_ref; the
kernel itself is held against that plain version on the card by
chip_smoke.py. Also pinned: the dtype-and-shape gate `fused_bwd_takes`
and FlashAttentionFn's backward on the CPU bit-equal to the plain
version.

Shapes stay small: B 2, H 2, D 64, S in {384, 512}. Tolerance (f32):
dq, dk, dv within 5e-4, the flash gradient tier of tests/test_pallas.py
(online against one-shot softmax, sums in another order)."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu_torch.ops import attention as tatt  # noqa: E402
from bert_pytorch_tpu_torch.ops.kernels import LAUNCHES, reset_launches  # noqa: E402

# the module, not the function the package's __init__ re-exports
jfa = importlib.import_module("bert_pytorch_tpu.ops.pallas.flash_attention")

GRAD_TOL = 5e-4


def _jax_seed(n: int) -> int:
    """An int32 dropout seed as the JAX package draws one."""
    return int(jax.random.bits(jax.random.PRNGKey(n), (), jnp.uint32)
               .astype(jnp.int32))


def _inputs(s, segments, seed, b=2, h=2, d=64):
    """q, k, v, the padding bias, segment ids (or None) and a cotangent
    that is zero on pad (segment-0) rows, as no loss term reads them."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) * 0.5
               for _ in range(3))
    seg = np.zeros((b, s), np.int32)
    if segments:
        for row, lengths in enumerate(([30, s // 2, s // 3], [s - 20])):
            cursor = 0
            for i, ln in enumerate(lengths):
                seg[row, cursor:cursor + ln] = i + 1
                cursor += ln
    else:
        seg[:, :s - 29] = 1
        seg[-1, :] = 1
    bias = ((1.0 - (seg > 0).astype(np.float32)) * -10000.0)[:, None, None, :]
    cot = rng.randn(b, s, h, d).astype(np.float32)
    if segments:
        cot[seg == 0] = 0.0
    return q, k, v, bias, (seg if segments else None), cot


def _t(a):
    return None if a is None else torch.from_numpy(a)


CASES = {"rate0": (0.0, False), "rate0.1": (0.1, False),
         "segments-rate0.1": (0.1, True)}
# the two fused Pallas backward sites
SITES = {"7-native-fused": {}, "8-bh-fused": {"FLASH_LAYOUT": "bh"}}


@pytest.mark.parametrize("seq", [384, 512])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("site", list(SITES))
def test_fused_backward_matches_pallas_fused_kernels(site, case, seq,
                                                     monkeypatch):
    for key in ("FLASH_LAYOUT", "FLASH_BWD"):
        monkeypatch.delenv(key, raising=False)
    for key, value in SITES[site].items():
        monkeypatch.setenv(key, value)
    rate, segments = CASES[case]
    q, k, v, bias, seg, cot = _inputs(seq, segments, seed=seq + len(case))
    seed = _jax_seed(seq) if rate > 0 else None
    # the site under test is the one the Pallas custom VJP takes here
    assert jfa._use_native(seq, 2, 64) == (site == "7-native-fused")

    def loss(q_, k_, v_):
        out = jfa.flash_attention(
            q_, k_, v_, jnp.array(bias),
            None if seg is None else jnp.array(seg),
            None if seed is None else jnp.int32(seed), rate, True)
        return jnp.sum(out * jnp.array(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.array(q), jnp.array(k),
                                             jnp.array(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out, lse = tatt.flash_attention(tq, tk, tv, _t(bias), _t(seg), seed,
                                    rate)
    reset_launches()
    got = tatt.flash_attention_bwd(tq, tk, tv, _t(bias), _t(seg), out, lse,
                                   _t(cot), seed, rate)
    assert LAUNCHES["flash_attention_bwd"] == 0  # a CPU tensor: no kernel
    for name, g, w in zip("qkv", got, want):
        assert g.shape == tq.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg="d" + name)
    if segments:
        pad = seg == 0
        assert pad.any()
        assert np.all(got[0].numpy()[pad] == 0.0)


@pytest.mark.parametrize("dtype,seq,d,fused", [
    (torch.bfloat16, 384, 64, True), (torch.bfloat16, 512, 64, True),
    (torch.float32, 384, 64, False), (torch.float32, 512, 64, False),
    (torch.bfloat16, 1024, 64, False), (torch.bfloat16, 640, 64, False),
    (torch.bfloat16, 448, 64, False), (torch.bfloat16, 512, 128, False)])
def test_fused_backward_gate(dtype, seq, d, fused):
    """bf16 at head dim 64 and seq a multiple of 128 up to
    FUSED_BWD_MAX_SEQ (512) takes the fused kernel; f32, longer or ragged
    sequences and other head dims take the dq and dk/dv pair."""
    q = torch.zeros(1, seq, 2, d, dtype=dtype)
    assert tatt.fused_bwd_takes(q) is fused


@pytest.mark.parametrize("case", list(CASES))
def test_flash_fn_backward_on_cpu_bit_equal_to_plain(case):
    """On the CPU FlashAttentionFn's backward is flash_attention_bwd_ref
    bit for bit, on the fused route (bf16) and on the pair's (f32)."""
    rate, segments = CASES[case]
    q, k, v, bias, seg, cot = _inputs(384, segments, seed=9)
    seed = _jax_seed(3) if rate > 0 else None
    for dtype in (torch.bfloat16, torch.float32):
        tq, tk, tv = (_t(a).to(dtype).requires_grad_() for a in (q, k, v))
        g = _t(cot).to(dtype)
        out = tatt.FlashAttentionFn.apply(tq, tk, tv, _t(bias), _t(seg),
                                          seed, rate)
        out.backward(g)
        o, lse = tatt.flash_attention(tq.detach(), tk.detach(), tv.detach(),
                                      _t(bias), _t(seg), seed, rate)
        want = tatt.flash_attention_bwd_ref(
            tq.detach(), tk.detach(), tv.detach(), _t(bias), _t(seg), o, lse,
            g, seed, rate)
        for got, w in zip((tq.grad, tk.grad, tv.grad), want):
            assert got.dtype == dtype
            torch.testing.assert_close(got, w, rtol=0, atol=0)
