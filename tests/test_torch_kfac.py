"""K-FAC pretraining in the port against the JAX package's, on the CPU, at
the tiny f32 width of tests/test_torch_pretrain.py (2 layers, E=128, 2
heads, I=256, S=32, P=6), the JAX model unstacked (stacked_params=False)
and un-jitted where the dropout seeds it draws are recorded.

Tolerances (f32): statistics and factors within 1e-5 (relative to the
largest element of the matrix); inverses within 1e-4 likewise; the
preconditioned gradients within 1e-4 with f32 inverses, and with the
default bf16 inverses within the bound one bf16 ulp of each inverse
gives: |dP| <= 2^-7 (|A^-1| |[W^T; b]| |G^-1|) elementwise (an ulp of
2^-8 relative in either factor, both counted), plus the f32 tier; nu
within 1e-5 relative; a 3-step run's losses within 1e-5 relative and its
parameters within 1e-4 relative L2 per tensor (the tiers of
tests/test_torch_pretrain.py). In the port alone: remat, a resume and
a replay bit-equal."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.optim import kfac as jax_kfac  # noqa: E402
from bert_pytorch_tpu.optim import schedulers as jax_schedulers  # noqa: E402
from bert_pytorch_tpu.training import pretrain as jax_pretrain  # noqa: E402
from bert_pytorch_tpu.training.state import TrainState as JaxState  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.models.bert import KFACTaps  # noqa: E402
from bert_pytorch_tpu_torch.models.convert import (  # noqa: E402
    kfac_state_from_flax, params_from_flax)
from bert_pytorch_tpu_torch.optim import kfac as port_kfac  # noqa: E402
from bert_pytorch_tpu_torch.optim.schedulers import \
    poly_warmup_schedule  # noqa: E402
from bert_pytorch_tpu_torch.training.pretrain import (  # noqa: E402
    build_kfac_pretrain_step, compute_params, init_kfac_state,
    pretrain_loss_fn)
from bert_pytorch_tpu_torch.training.state import make_train_state  # noqa: E402
from tests import test_torch_pretrain as tp  # noqa: E402
from tests.test_torch_pretrain import init_params, seed_recorder  # noqa: E402,F401

STAT_TOL = 1e-5
INV_TOL = 1e-4
PRE_TOL = 1e-4
BF16_ULP = 2.0 ** -8
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _rel_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


def _jax_setup(kcfg=None, accum=1, **over):
    """JAX's K-FAC step (un-jitted) over the tiny model with kfac_taps,
    LAMB under a warmup schedule, and its initial state."""
    model = tp._jax_model(kfac_taps=True, **over)
    sched = jax_schedulers.poly_warmup_schedule(1e-2, total_steps=10,
                                                warmup=0.2)
    tx = tp._jax_lamb(sched)
    kfac = jax_kfac.KFAC(jax_kfac.KFACConfig(learning_rate=sched,
                                             **(kcfg or {})))
    return model, sched, tx, kfac


PACKED = ("position_ids", "segment_ids", "nsp_positions")


def _jax_state(model, tx, kfac, params, batch):
    """JAX's initial K-FAC state and the perturbation template of one
    microbatch shaped as `batch` (a packed one's NSP rows are (B, G))."""
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params,
                     opt_state=tx.init(params))
    s = jnp.asarray(batch["input_ids"])
    state, pert = jax_pretrain.init_kfac_state(model, kfac, state,
                                               (s, s * 0, s * 0 + 1))
    if "segment_ids" in batch:
        variables = jax.eval_shape(lambda r: model.init(
            r, s, s * 0, s * 0 + 1,
            **{k: jnp.asarray(batch[k]) for k in PACKED}),
            jax.random.PRNGKey(0))
        pert = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                            variables["perturbations"])
    return state, pert


def _port_setup(params, kcfg=None, accum=1, health=None,
                nan_inject_step=None, **over):
    model = tp._port_model(tp._flat(params), kfac_taps=True, **over)
    sched = poly_warmup_schedule(1e-2, total_steps=10, warmup=0.2)
    tx = tp._port_lamb(sched)
    state = make_train_state(model, tx)
    kfac = port_kfac.KFAC(port_kfac.KFACConfig(**(kcfg or {})))
    init_kfac_state(model, kfac, state)
    step = build_kfac_pretrain_step(model, tx, kfac, schedule=sched,
                                    accum_steps=accum, max_predictions=tp.P,
                                    health=health,
                                    nan_inject_step=nan_inject_step)
    return model, kfac, state, step


def _jax_kcfg(kcfg):
    """The port's KFACConfig keywords in the JAX config's types."""
    out = dict(kcfg or {})
    for k in ("inverse_dtype", "stats_dtype"):
        if k in out:
            out[k] = {torch.float32: jnp.float32,
                      torch.bfloat16: jnp.bfloat16}[out[k]]
    return out


def _factors(jstate):
    return kfac_state_from_flax(
        tp._flat(jstate.precond_state.factors),
        inverses=tp._flat(jstate.precond_state.inverses))


def _jax_micro_stats(model, kfac, params, batch, rng):
    """One microbatch's JAX statistics, as its K-FAC step computes them."""
    from flax import traverse_util

    s = jnp.asarray(batch["input_ids"])
    variables = model.init(jax.random.PRNGKey(0), s, s * 0, s * 0 + 1)
    perts = jax.tree.map(jnp.zeros_like, variables["perturbations"])

    def loss_fn(p, pe):
        labels = jnp.asarray(batch["masked_lm_labels"])
        pos, labels = jax_pretrain.gather_masked_labels(labels, tp.P)
        (mlm, nsp), mut = model.apply(
            {"params": p, "perturbations": pe}, s,
            jnp.asarray(batch["token_type_ids"]),
            jnp.asarray(batch["attention_mask"]), deterministic=False,
            masked_positions=pos, rngs={"dropout": rng},
            mutable=["kfac_in"])
        from bert_pytorch_tpu.models import losses
        loss = losses.pretraining_loss(
            mlm, labels, nsp, jnp.asarray(batch["next_sentence_labels"]))
        return loss, mut["kfac_in"]

    (loss, acts), (_, pgrads) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, perts)
    stats = kfac.compute_stats(acts, pgrads)
    return loss, traverse_util.flatten_dict(stats, sep="/")


def _port_micro_stats(model, kfac, params, batch, seeds):
    taps = KFACTaps()
    gparams = compute_params(dict(model.named_parameters()), None)
    loss, _ = pretrain_loss_fn(model, tp.P)(gparams, tp._torch_batch(batch),
                                            seeds, taps)
    sites = list(taps.perts)
    g = torch.autograd.grad(loss, [taps.perts[s] for s in sites])
    return loss, kfac.compute_stats(taps.acts, dict(zip(sites, g)))


def test_taps_sit_on_the_jax_sites(init_params):
    model = tp._port_model(tp._flat(init_params), kfac_taps=True)
    jmodel, _, tx, kfac = _jax_setup()
    jstate, _ = _jax_state(jmodel, tx, kfac, init_params, tp._batch(0))
    want = set(_factors(jstate).factors)
    assert set(model.kfac_sites) == want and len(want) == 4 * 2 + 2
    # the taps do not change the forward
    plain = tp._port_model(tp._flat(init_params))
    batch = {k: torch.from_numpy(v) for k, v in tp._batch(0).items()}
    with torch.no_grad():
        a = plain(batch["input_ids"], batch["token_type_ids"],
                  batch["attention_mask"])
        b = model(batch["input_ids"], batch["token_type_ids"],
                  batch["attention_mask"], kfac=KFACTaps())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="kfac_taps"):
        plain(batch["input_ids"], kfac=KFACTaps())


def test_statistics_match_jax_with_dropout(init_params, seed_recorder):
    """One microbatch with dropout on, the port fed the seeds JAX drew:
    every site's A and G."""
    jmodel, _, _, kfac = _jax_setup()
    batch = tp._batch(0)
    loss, jstats = _jax_micro_stats(jmodel, kfac, init_params, batch,
                                    jax.random.PRNGKey(5))
    assert len(seed_recorder) == tp.N_SEEDS
    model = tp._port_model(tp._flat(init_params), kfac_taps=True)
    pk = port_kfac.KFAC(port_kfac.KFACConfig())
    ploss, pstats = _port_micro_stats(
        model, pk, init_params, batch,
        torch.tensor(seed_recorder, dtype=torch.int32))
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=tp.LOSS_RTOL)
    want = kfac_state_from_flax(jstats).factors
    assert set(pstats) == set(want)
    for site, d in want.items():
        for k in ("A", "G"):
            _rel_close(pstats[site][k], d[k], STAT_TOL, (site, k))


@pytest.fixture(scope="module")
def one_step(init_params):
    """One K-FAC step on both sides (dropout off, f32 inverses, the
    inversion at count 0): the JAX state and metrics, the port's."""
    kcfg = {"inverse_dtype": torch.float32}
    jmodel, _, tx, kfac = _jax_setup(_jax_kcfg(kcfg), **NO_DROPOUT)
    batch = tp._batch(1)
    jstate, pert = _jax_state(jmodel, tx, kfac, init_params, batch)
    jstep = jax_pretrain.build_kfac_pretrain_step(
        jmodel, tx, kfac, pert, schedule=kfac.config.learning_rate,
        max_predictions=tp.P)
    jstate, jm = jstep(jstate, {k: jnp.array(v)[None]
                                for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    model, pk, pstate, pstep = _port_setup(init_params, kcfg, **NO_DROPOUT)
    pm = pstep(pstate, tp._torch_batch(batch, accum=1), None)
    return {"jstate": jstate, "jm": jm, "pstate": pstate, "pm": pm,
            "pk": pk, "jkfac": kfac, "init_params": init_params}


def test_factors_and_inverses_after_a_step_match_jax(one_step):
    want = _factors(one_step["jstate"])
    got = one_step["pstate"].precond_state
    assert got.count == int(one_step["jstate"].precond_state.count) == 1
    for site in want.factors:
        for k in ("A", "G"):
            _rel_close(got.factors[site][k], want.factors[site][k],
                       STAT_TOL, (site, k))
            _rel_close(got.inverses[site][k], want.inverses[site][k],
                       INV_TOL, (site, k))


def test_inverses_of_the_same_factors_match_jax(one_step):
    """Both inversions on JAX's factors, in f32."""
    jfactors = one_step["jstate"].precond_state.factors
    jinv = tp._flat(one_step["jkfac"]._invert(jfactors))
    want = kfac_state_from_flax(jinv).factors
    got = one_step["pk"]._invert(_factors(one_step["jstate"]).factors)
    for site, d in want.items():
        for k in ("A", "G"):
            _rel_close(got[site][k], d[k], INV_TOL, (site, k))


def _grads(params, seed):
    """Random f32 gradients by port name, shaped as `params` (flax)."""
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
            for k, v in params_from_flax(tp._flat(params)).items()}


def _jax_grads_like(jparams, port_grads):
    """The flax gradient tree whose port form is `port_grads`."""
    flat = tp._flat(jparams)
    out = {}
    for key, value in flat.items():
        # params_from_flax of a one-hot leaf names its port key
        probe = {key: np.zeros_like(value)}
        (pkey,) = params_from_flax(probe).keys()
        t = port_grads[pkey].numpy()
        if key.endswith("attention/qkv/kernel"):
            out[key] = t.T.reshape(value.shape)
        elif key.endswith("attention/output/kernel"):
            out[key] = t.T.reshape(value.shape)
        elif key.endswith("/kernel"):
            out[key] = t.T
        else:
            out[key] = t.reshape(value.shape)
    from flax import traverse_util
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in out.items()})


@pytest.mark.parametrize("inverse_dtype", ["float32", "bfloat16"])
def test_preconditioned_gradients_match_jax(one_step, inverse_dtype):
    """F^-1 g of the same gradients, each side from the same factors
    through its own inversion, kl_clip out of the way (nu = 1)."""
    jst = one_step["jstate"].precond_state
    tdt = getattr(torch, inverse_dtype)
    jcfg = jax_kfac.KFACConfig(kl_clip=1e30,
                               inverse_dtype=getattr(jnp, inverse_dtype))
    jk = jax_kfac.KFAC(jcfg)
    jinv = jk._invert(jst.factors)
    port_grads = _grads(one_step["init_params"], 3)
    jgrads = _jax_grads_like(one_step["init_params"], port_grads)
    jpre = jk.precondition(jax_kfac.KFACState(
        factors=jst.factors, inverses=jinv, count=jst.count), jgrads, 1e-3)
    want = params_from_flax(tp._flat(jpre))
    pk = port_kfac.KFAC(port_kfac.KFACConfig(kl_clip=1e30,
                                             inverse_dtype=tdt))
    pinv = pk._invert(_factors(one_step["jstate"]).factors)
    got = pk.precondition(pinv, port_grads, 1e-3)
    assert float(pk.last_nu) == 1.0
    for site, inv in pinv.items():
        for name in (f"{site}.weight", f"{site}.bias"):
            g, w = got[name].double(), want[name].double()
            tol = PRE_TOL * w.abs().max()
            if tdt == torch.bfloat16:
                aug = torch.cat([port_grads[f"{site}.weight"].double().T,
                                 port_grads[f"{site}.bias"].double()[None]])
                bound = (inv["A"].double().abs() @ aug.abs()
                         @ inv["G"].double().abs())
                bound = bound[:-1].T if name.endswith("weight") else bound[-1]
                tol = tol + 2 * BF16_ULP * bound
            assert bool(((g - w).abs() <= tol).all()), (
                name, float((g - w).abs().max()))
        # not the first-order gradients
        assert not torch.equal(got[f"{site}.weight"],
                               port_grads[f"{site}.weight"])
    for name in ("bert.embeddings.word_embeddings.weight",
                 "cls_predictions.transform.weight"):
        assert torch.equal(got[name], port_grads[name])


def test_kl_clip_nu_matches_jax(one_step):
    jst = one_step["jstate"].precond_state
    port_grads = _grads(one_step["init_params"], 4)
    jgrads = _jax_grads_like(one_step["init_params"], port_grads)
    lr = 5e-3
    outs = []
    for clip in (1e30, 1e-3):
        jk = jax_kfac.KFAC(jax_kfac.KFACConfig(kl_clip=clip,
                                               inverse_dtype=jnp.float32))
        outs.append(params_from_flax(tp._flat(jk.precondition(
            jax_kfac.KFACState(factors=jst.factors, inverses=jst.inverses,
                               count=jst.count), jgrads, lr))))
    name = "bert.encoder.layers.0.attention.qkv.weight"
    want_nu = float((outs[1][name].double().norm()
                     / outs[0][name].double().norm()))
    assert want_nu < 0.5
    pk = port_kfac.KFAC(port_kfac.KFACConfig(kl_clip=1e-3,
                                             inverse_dtype=torch.float32))
    pk.precondition(_factors(one_step["jstate"]).inverses, port_grads, lr)
    np.testing.assert_allclose(float(pk.last_nu), want_nu, rtol=1e-5)


def test_three_steps_match_jax(init_params, seed_recorder):
    """Three K-FAC steps, dropout on with the recorded seeds, the
    inversion every 2 steps (steps 1 and 3), bf16 inverses: losses, grad
    norms, the final parameters."""
    kcfg = {"inv_interval": 2}
    jmodel, sched, tx, kfac = _jax_setup(kcfg)
    jstate, pert = _jax_state(jmodel, tx, kfac, init_params, tp._batch(0))
    jstep = jax_pretrain.build_kfac_pretrain_step(
        jmodel, tx, kfac, pert, schedule=sched, max_predictions=tp.P)
    _, _, pstate, pstep = _port_setup(init_params, kcfg)
    for i in range(3):
        batch = tp._batch(30 + i)
        del seed_recorder[:]
        jstate, jm = jstep(jstate, {k: jnp.array(v)[None]
                                    for k, v in batch.items()},
                           jax.random.PRNGKey(200 + i))
        seeds = torch.tensor([seed_recorder], dtype=torch.int32)
        pm = pstep(pstate, tp._torch_batch(batch, accum=1), seeds)
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   rtol=tp.LOSS_RTOL)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert pstate.step == 3 and pstate.precond_state.count == 3
    tp._assert_params_close(pstate.params, jstate.params)


@pytest.mark.parametrize("case", ["stats_bf16", "sync_freq_2", "accum_2"])
def test_variants_match_jax(init_params, case):
    """Two steps with --kfac_stats_dtype bf16, with factor_sync_freq 2
    (the second step keeps the factors), and at accumulation 2 (the
    statistics summed and divided): the factors and the losses (bf16
    statistics: the factors within one bf16 ulp, 2^-8 relative)."""
    kcfg = {"stats_bf16": {"stats_dtype": torch.bfloat16},
            "sync_freq_2": {"factor_sync_freq": 2},
            "accum_2": {}}[case]
    accum = 2 if case == "accum_2" else 1
    jmodel, sched, tx, kfac = _jax_setup(
        {k: v for k, v in _jax_kcfg(kcfg).items()
         if k != "factor_sync_freq"}, **NO_DROPOUT)
    if case == "sync_freq_2":
        kfac = jax_kfac.KFAC(kfac.config, factor_sync_freq=2)
    jstate, pert = _jax_state(jmodel, tx, kfac, init_params, tp._batch(0))
    jstep = jax_pretrain.build_kfac_pretrain_step(
        jmodel, tx, kfac, pert, schedule=sched, accum_steps=accum,
        max_predictions=tp.P)
    _, _, pstate, pstep = _port_setup(init_params, kcfg, accum=accum,
                                      **NO_DROPOUT)
    seen = []
    for i in range(2):
        batch = {k: np.concatenate([tp._batch(40 + 2 * i)[k],
                                    tp._batch(41 + 2 * i)[k]])
                 for k in tp._batch(0)} if accum == 2 else tp._batch(40 + i)
        jstate, jm = jstep(jstate, {k: jnp.array(v).reshape(
            accum, -1, *v.shape[1:]) for k, v in batch.items()},
            jax.random.PRNGKey(0))
        pm = pstep(pstate, tp._torch_batch(batch, accum=accum), None)
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   rtol=tp.LOSS_RTOL)
        seen.append({s: {k: t.clone() for k, t in d.items()}
                     for s, d in pstate.precond_state.factors.items()})
    tol = BF16_ULP if case == "stats_bf16" else STAT_TOL
    want = _factors(jstate).factors
    for site, d in want.items():
        for k in ("A", "G"):
            _rel_close(pstate.precond_state.factors[site][k], d[k], tol,
                       (site, k))
    if case == "sync_freq_2":
        for site, d in seen[0].items():
            for k in d:
                assert torch.equal(d[k], seen[1][site][k])


def test_packed_batch_matches_jax(init_params):
    """A packed microbatch (segments, reset positions, NSP per segment):
    the statistics of every site, the NSP head's from (B, G) rows."""
    from bert_pytorch_tpu_torch.data.packing import pack_examples

    rng = np.random.RandomState(5)
    lengths = (9, 12, 7, 10, 6, 11)
    n = len(lengths)
    ids = rng.randint(5, tp.V, (n, tp.S)).astype(np.int32)
    mask = (np.arange(tp.S)[None] < np.array(lengths)[:, None])
    labels = np.full((n, tp.S), -1, np.int32)
    labels[:, 2], ids[:, 2] = ids[:, 2], 3
    examples = {"input_ids": ids * mask,
                "token_type_ids": np.zeros((n, tp.S), np.int32),
                "attention_mask": mask.astype(np.int32),
                "masked_lm_labels": labels,
                "next_sentence_labels": (np.arange(n) % 2).astype(np.int32)}
    batch = pack_examples(examples, [[0, 1, 2], [3, 4, 5]], tp.S, 3)
    jmodel, _, tx, kfac = _jax_setup(**NO_DROPOUT)
    jstate, pert = _jax_state(jmodel, tx, kfac, init_params, batch)
    jstep = jax_pretrain.build_kfac_pretrain_step(
        jmodel, tx, kfac, pert, schedule=kfac.config.learning_rate,
        max_predictions=tp.P)
    jstate, jm = jstep(jstate, {k: jnp.array(v)[None]
                                for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    _, _, pstate, pstep = _port_setup(init_params, **NO_DROPOUT)
    pm = pstep(pstate, tp._torch_batch(batch, accum=1), None)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                               rtol=tp.LOSS_RTOL)
    want = _factors(jstate).factors
    for site, d in want.items():
        for k in ("A", "G"):
            _rel_close(pstate.precond_state.factors[site][k], d[k],
                       STAT_TOL, (site, k))


@pytest.mark.parametrize("policy", ["nothing", "dots", "mlp_only"])
def test_remat_records_each_site_once(init_params, policy):
    """Under --checkpoint_activations the recompute records no site twice:
    one step's statistics, factors and parameters are the bits of the
    step without remat."""
    out = []
    for remat in (False, True):
        _, _, state, step = _port_setup(
            init_params, checkpoint_activations=remat, remat_policy=policy)
        seeds = torch.arange(tp.N_SEEDS, dtype=torch.int32)[None] * 7919
        m = step(state, tp._torch_batch(tp._batch(2), accum=1), seeds)
        out.append((m, state))
    (m0, s0), (m1, s1) = out
    assert m0["loss"].item() == m1["loss"].item()
    for site, d in s0.precond_state.factors.items():
        for k in d:
            assert torch.equal(d[k], s1.precond_state.factors[site][k]), site
    for k, p in s0.params.items():
        assert torch.equal(p, s1.params[k]), k


def test_skip_keeps_the_factors(init_params):
    """--nonfinite_action skip on a poisoned step (a NaN injected at step
    2): parameters, LAMB's state and K-FAC's factors and inverses are
    those of step 1."""
    from bert_pytorch_tpu_torch.telemetry.health import (
        HealthConfig, init_telemetry_state)

    _, _, state, step = _port_setup(
        init_params, {"inv_interval": 1}, health=HealthConfig("skip"),
        nan_inject_step=2, **NO_DROPOUT)
    state.telemetry = init_telemetry_state()
    step(state, tp._torch_batch(tp._batch(3), accum=1), None)
    before = {k: v.clone() for k, v in
              state.precond_state.state_dict()["factors"].items()}
    inv = {k: v.clone() for k, v in
           state.precond_state.state_dict()["inverses"].items()}
    params = {k: v.clone() for k, v in state.params.items()}
    m = step(state, tp._torch_batch(tp._batch(4), accum=1), None)
    assert m["skipped_nonfinite"] == 1
    after = state.precond_state.state_dict()
    for k, v in before.items():
        assert torch.equal(v, after["factors"][k]), k
    for k, v in inv.items():
        assert torch.equal(v, after["inverses"][k]), k
    for k, v in params.items():
        assert torch.equal(v, state.params[k]), k
    assert state.precond_state.count == 1 and state.step == 2


def _argv(tmp_path, out, *extra):
    return ["--config_file", os.path.join(tp.REPO, "configs",
                                          "bert_kfac_pretraining_phase1_config"
                                          ".json"),
            "--model_config_file", _model_config(tmp_path),
            "--input_dir", _shards(tmp_path), "--output_dir", str(out),
            "--local_batch_size", "4", "--global_batch_size", "8",
            "--device", "cpu", "--tensorboard", "off",
            "--vocab_pad_multiple", "8", "--kfac_inv_interval", "2",
            *extra]


def _model_config(tmp_path):
    path = tmp_path / "tiny.json"
    if not path.exists():
        path.write_text(json.dumps(dict(
            tp.CFG, hidden_size=32, intermediate_size=64,
            num_attention_heads=2)))
    return str(path)


def _shards(tmp_path):
    root = tmp_path / "data"
    if not root.exists():
        root.mkdir()
        from tests.test_data import write_shard

        for i in range(2):
            write_shard(str(root / f"part_{i}.hdf5"), 16, seq=tp.S, seed=i)
    return str(root)


def test_kfac_run_config_resumes_bit_equal(tmp_path):
    """configs/bert_kfac_pretraining_phase1_config.json on the CPU: 4
    steps straight, and 2 then a resume for 2 (a checkpoint every 2
    steps): the same parameters, LAMB moments and K-FAC state, bit for
    bit; the log names the sites and their bytes."""
    lines = []
    full = run_pretraining.main(
        _argv(tmp_path, tmp_path / "a", "--steps", "4"),
        log=lines.append)
    assert any(m.startswith("kfac: 10 sites") for m in lines)
    run_pretraining.main(_argv(tmp_path, tmp_path / "b", "--steps", "2",
                               "--num_steps_per_checkpoint", "2"),
                         log=lambda m: None)
    resumed = run_pretraining.main(
        _argv(tmp_path, tmp_path / "b", "--steps", "2",
              "--num_steps_per_checkpoint", "2"), log=lambda m: None)
    assert resumed.resumed_from == 2 and resumed.step == full.step == 4
    a, b = full.state.state_dict(), resumed.state.state_dict()
    assert a["precond_state"]["count"] == b["precond_state"]["count"] == 4
    for group in ("factors", "inverses"):
        for k, v in a["precond_state"][group].items():
            assert torch.equal(v, b["precond_state"][group][k]), k
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
        assert torch.equal(a["opt_state"]["mu"][k],
                           b["opt_state"]["mu"][k]), k
    assert [h["loss"] for h in full.history[2:]] == \
        [h["loss"] for h in resumed.history]


def test_kfac_bundle_replays_bit_identically(tmp_path, capsys):
    """A K-FAC run halted by a NaN at step 3 dumps a bundle whose run
    block carries JAX's `kfac` keys; replay rebuilds the K-FAC step from
    it and reproduces step 3 bit for bit."""
    from bert_pytorch_tpu_torch.tools import replay

    out = tmp_path / "r"
    with pytest.raises(run_pretraining.NonFiniteHalt):
        run_pretraining.main(_argv(
            tmp_path, out, "--steps", "4", "--num_steps_per_checkpoint",
            "1", "--inject_nonfinite_step", "3", "--nonfinite_action",
            "halt"), log=lambda m: None)
    (bundle,) = (out / "repro_bundles").iterdir()
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert set(manifest["run"]["kfac"]) == {
        "inv_interval", "factor_interval", "stat_decay", "damping",
        "kl_clip", "skip_layers", "factor_bucket_bytes", "factor_sync_freq",
        "bucket_assignment", "stats_dtype"}
    assert manifest["run"]["kfac"]["inv_interval"] == 2
    assert manifest["model_config"]["kfac_taps"] is True
    result = replay.main(["--bundle", str(bundle), "--device", "cpu"])
    assert result["match"] is True and result["base_checkpoint"] == 2
