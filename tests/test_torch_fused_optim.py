"""The port's fused LAMB (ops/fused_optim.py and the fused route of
optim/lamb.py) against the JAX package's, on the CPU.

The JAX side runs its Pallas stage kernels (ops/pallas/fused_optim.py) in
interpret mode, as tests/test_pallas.py does; the port runs the kernels'
plain versions, which is what its wrappers take for CPU tensors.

Tolerances: stage 1 within rtol 1e-6 / atol 5e-7 of the Pallas kernel (the
tier of tests/test_pallas.py: XLA may contract the kernel's multiply-adds
into FMAs, the port rounds every operation), stage 2 exactly (one
multiply); the 3-step LAMB trajectory within rtol 1e-6 / atol 1e-7, the
tier of test_lamb_matches_jax_on_random_tensors; the port's two routes
bit for bit."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.ops.pallas import fused_optim as jfo  # noqa: E402
from bert_pytorch_tpu.optim.lamb import (  # noqa: E402
    default_weight_decay_mask as jax_wd_mask, lamb as jax_lamb)
from bert_pytorch_tpu_torch.ops import fused_optim as tfo  # noqa: E402
from bert_pytorch_tpu_torch.ops.kernels import (LAUNCHES,  # noqa: E402
                                                reset_launches)
from bert_pytorch_tpu_torch.optim.lamb import Lamb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE1_RTOL, STAGE1_ATOL = 1e-6, 5e-7
LAMB_RTOL, LAMB_ATOL = 1e-6, 1e-7
SHAPES = [(3, 257), (5,), (64, 128)]
WDS = [0.01, 0.0, 0.01]
SCALARS = dict(c1=0.9, c2=0.99, b1=0.9, b2=0.999, eps=1e-6)


def _leaves(seed):
    """g, mu, nu, p as numpy f32 leaves of the stage tests' shapes."""
    rng = np.random.RandomState(seed)
    g = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    mu = [np.abs(rng.randn(*s)).astype(np.float32) for s in SHAPES]
    nu = [np.abs(rng.randn(*s)).astype(np.float32) for s in SHAPES]
    p = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    return g, mu, nu, p


def _t(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_stages_match_pallas_kernels(grad_dtype):
    """(a) lamb_stage1_ref / lamb_stage2_ref against the Pallas stage
    kernels on the leaves of tests/test_pallas.py, buckets of 64 KiB; the
    bf16 case gives the port bf16 gradients and JAX their upcast."""
    g, mu, nu, p = _leaves(7)
    tg = [x.to(getattr(torch, grad_dtype)) for x in _t(g)]
    g_f32 = [x.float().numpy() for x in tg]
    jmu, jnu, ju = jfo.lamb_stage1(
        [jnp.asarray(x) for x in g_f32], [jnp.asarray(x) for x in mu],
        [jnp.asarray(x) for x in nu], [jnp.asarray(x) for x in p], WDS,
        denom=1.37, impl="pallas", bucket_bytes=64 << 10, **SCALARS)
    tmu, tnu = _t(mu), _t(nu)
    tu = tfo.lamb_stage1_ref(tg, tmu, tnu, _t(p), WDS,
                             torch.tensor(1.37), **SCALARS)
    for got, want in ((tmu, jmu), (tnu, jnu), (tu, ju)):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=STAGE1_RTOL, atol=STAGE1_ATOL)
    # stage 2 from the same u: t is one scalar per tensor in the port, a
    # leaf-shaped broadcast of it in JAX
    t = np.array([-3e-3, 0.5, -1.25e-2], np.float32)
    u_np = [x.numpy() for x in tu]
    want = jfo.lamb_stage2(
        [jnp.full(x.shape, v, jnp.float32) for x, v in zip(u_np, t)],
        [jnp.asarray(x) for x in u_np], impl="pallas",
        bucket_bytes=64 << 10)
    got = tfo.lamb_stage2_ref(torch.from_numpy(t), tu)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the apply: p + t * u, the product rounded first
    tp = _t(p)
    tfo.lamb_stage2_ref(torch.from_numpy(t), tu, tp)
    for a, b, p0 in zip(tp, want, p):
        np.testing.assert_array_equal(a.numpy(), p0 + np.asarray(b))


def _lamb_leaves():
    rng = np.random.RandomState(7)
    params = {"w": rng.randn(8, 6).astype(np.float32),
              "layer_norm/scale": np.ones(6, np.float32),
              "b/bias": np.zeros(6, np.float32),
              "v": rng.randn(3, 257).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


_NAMES = {"w": "w", "layer_norm/scale": "layer_norm.scale",
          "b/bias": "b.bias", "v": "v"}


def test_fused_lamb_trajectory_matches_jax_pallas():
    """(b) Three LAMB updates on the port's fused route against JAX's
    lamb(fused=True, fused_impl="pallas"), bf16 gradients, a zero-norm
    leaf (ratio 1) and a decay-masked bias: parameters and moments after
    every step."""
    params, grads = _lamb_leaves()
    tx = jax_lamb(0.05, weight_decay=0.01, weight_decay_mask=jax_wd_mask,
                  fused=True, fused_impl="pallas")
    jp = {k: jnp.array(v) for k, v in params.items()}
    jst = tx.init(jp)
    ptx = Lamb(0.05, weight_decay=0.01, fused="auto")
    pp = {_NAMES[k]: torch.from_numpy(v.copy()) for k, v in params.items()}
    pst = ptx.init(pp)
    for step_grads in grads:
        jg = {k: jnp.array(v).astype(jnp.bfloat16)
              for k, v in step_grads.items()}
        updates, jst = tx.update(jg, jst, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        pg = {_NAMES[k]: torch.from_numpy(np.array(
            jg[k].astype(jnp.float32))).to(torch.bfloat16) for k in jg}
        ptx.update(pg, pst, pp)
        for k, n in _NAMES.items():
            for got, want in ((pp[n], jp[k]), (pst.mu[n], jst.mu[k]),
                              (pst.nu[n], jst.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=LAMB_RTOL, atol=LAMB_ATOL,
                                           err_msg=k)
    assert pst.count == 3


@pytest.mark.parametrize("fused", ["xla", "auto", "pallas"])
def test_fused_routes_bit_identical_to_off(fused):
    """(c) The fused route (its plain versions, as on the CPU every choice
    runs them) gives route "off"'s bits: params, mu and nu over 3 steps,
    bf16 gradients, the global norm passed in as the train step does on
    the last step."""
    from bert_pytorch_tpu_torch.optim.lamb import global_norm_f32

    params, grads = _lamb_leaves()
    out = {}
    for route in ("off", fused):
        tx = Lamb(lambda s: 0.01 * (s + 1), weight_decay=0.01, fused=route)
        pp = {_NAMES[k]: torch.from_numpy(v.copy())
              for k, v in params.items()}
        st = tx.init(pp)
        for i, step_grads in enumerate(grads):
            pg = {_NAMES[k]: torch.from_numpy(v).to(torch.bfloat16)
                  for k, v in step_grads.items()}
            norm = global_norm_f32(pg.values()) if i == 2 else None
            tx.update(pg, st, pp, grad_norm=norm)
        out[route] = (pp, st.mu, st.nu)
    for a, b in zip(out["off"], out[fused]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("chunk", [4096, tfo.CHUNK])
def test_chunk_table_covers_every_element_once(chunk):
    """(d) Sizes 1, 2, 4095, 4097, an empty tensor and one of several
    chunks: every element lies in exactly one chunk, chunks start on
    4-element boundaries and stay inside their tensor."""
    sizes = [1, 2, 4095, 4097, 0, 5 * chunk + 3]
    table = tfo.chunk_table(sizes, chunk).numpy()
    assert table.dtype == np.int64 and table.shape[1] == 2
    hits = [np.zeros(n, np.int64) for n in sizes]
    for t, start in table:
        assert 0 <= start < sizes[t] and start % 4 == 0
        hits[t][start:min(start + chunk, sizes[t])] += 1
    for n, h in zip(sizes, hits):
        assert (h == 1).all(), n
    assert len(table) == sum(-(-n // chunk) for n in sizes)
    assert torch.equal(tfo.chunk_table(sizes, chunk), torch.from_numpy(table))
    with pytest.raises(ValueError):
        tfo.chunk_table(sizes, 4098)


def test_wrappers_take_plain_versions_on_the_cpu():
    """(e) On CPU tensors the wrappers return the plain versions' values
    and count no launch."""
    g, mu, nu, p = _leaves(3)
    tg = [x.to(torch.bfloat16) for x in _t(g)]
    denom = torch.tensor(1.37)
    reset_launches()
    mu_w, nu_w = _t(mu), _t(nu)
    u_w = tfo.lamb_stage1(tg, mu_w, nu_w, _t(p), WDS, denom, **SCALARS)
    mu_r, nu_r = _t(mu), _t(nu)
    u_r = tfo.lamb_stage1_ref(tg, mu_r, nu_r, _t(p), WDS, denom, **SCALARS)
    t = torch.tensor([-1e-3, 2e-3, 3e-3])
    prod_w = tfo.lamb_stage2(t, u_w)
    p_w = _t(p)
    assert tfo.lamb_stage2(t, u_w, p_w) is None
    p_r = _t(p)
    tfo.lamb_stage2_ref(t, u_r, p_r)
    for got, want in ((mu_w, mu_r), (nu_w, nu_r), (u_w, u_r), (p_w, p_r),
                      (prod_w, tfo.lamb_stage2_ref(t, u_r))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert LAUNCHES["lamb_stage1"] == LAUNCHES["lamb_stage2"] == 0
    assert all(v == 0 for v in LAUNCHES.values())


def test_chip_smoke_rows_name_every_pallas_site():
    """chip_smoke.py's kernels line carries every `pl.pallas_call` site of
    the JAX package through its rows (`replaces` or `also_replaces`), each
    at the line where the call stands."""
    import re

    sys.path.insert(0, REPO)
    import chip_smoke

    pallas = os.path.join(REPO, "bert_pytorch_tpu", "ops", "pallas")
    sites = set()
    for name in sorted(os.listdir(pallas)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(pallas, name)) as f:
            for i, line in enumerate(f, 1):
                if re.search(r"\bpl\.pallas_call\(", line):
                    sites.add(f"bert_pytorch_tpu/ops/pallas/{name}:{i}")
    rows = set()
    for row in chip_smoke.KERNEL_ROWS.values():
        rows.add(row["replaces"])
        rows.update(row.get("also_replaces", []))
    assert len(sites) == 12 and rows == sites
