"""The training step: forward, loss, gradients, accumulation, the
optimizer (counterpart of bert_pytorch_tpu/training/pretrain.py, one
device). One step serves pretraining (the default loss: MLM + NSP, LAMB)
and finetuning (`loss_fn_builder`, the task's loss; FusedAdam), as in the
JAX package.

Batch layout: every tensor arrives shaped (accum_steps, micro_batch, ...)
on the step's device, and `seeds` is an int32 host tensor of shape
(accum_steps, n_sites), one row of dropout seeds per microbatch (None: no
dropout; n_sites is the model's `n_dropout_sites`, 1 + 3L for the
encoder). The loss is the mean over microbatches. A parameter the loss
does not reach (the pooler under a task head) gets a zero gradient.

`grad_dtype` (bf16 under --grad_dtype auto with bf16 compute): the
forward and backward run against a copy of every float parameter cast to
that dtype, so the gradients are bf16 too; the accumulator stays in that
dtype up to 128 microbatches and is f32 beyond; LAMB upcasts them onto the
f32 masters. The copy is made with `torch.func.functional_call`, which
runs the model's own modules on the given tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from bert_pytorch_tpu_torch.models import losses
from bert_pytorch_tpu_torch.optim.lamb import global_norm_f32
from bert_pytorch_tpu_torch.telemetry.health import (HealthConfig,
                                                     health_signals,
                                                     health_update,
                                                     is_sticky_metric)
from bert_pytorch_tpu_torch.training.state import TrainState

Batch = Dict[str, torch.Tensor]
# loss_fn(params by name, microbatch, seeds or None) -> (loss, aux counts)
LossFn = Callable[[Dict[str, torch.Tensor], Batch, Optional[torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def dropout_seeds(seed: int, step: int, accum_steps: int, n_sites: int
                  ) -> torch.Tensor:
    """(accum_steps, n_sites) int32 dropout seeds of global step `step`
    (the step being taken, 1-based): a pure function of (seed, step), the
    port's counterpart of fold_in(PRNGKey(seed + 1000), step), so a
    resumed run draws the seeds an uninterrupted run draws."""
    rng = np.random.default_rng([(seed + 1000) % 2 ** 64, step])
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                         (accum_steps, n_sites),
                                         dtype=np.int32))


def gather_masked_labels(masked_lm_labels: torch.Tensor,
                         max_predictions: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) dense labels (-1 = unmasked) -> ((B, P) positions, (B, P)
    labels), the masked positions first in their original order (a stable
    argsort of the unmasked flag). Rows with fewer than P masked tokens
    fill the tail with positions whose label is -1, which the loss
    ignores."""
    unmasked = (masked_lm_labels == -1).to(torch.int32)
    positions = torch.argsort(unmasked, dim=-1, stable=True)
    positions = positions[:, :max_predictions]
    return positions, torch.gather(masked_lm_labels, 1, positions)


def compute_params(params: Dict[str, torch.Tensor],
                   grad_dtype: Optional[torch.dtype]
                   ) -> Dict[str, torch.Tensor]:
    """Leaves the forward and backward run against: each float parameter
    cast to `grad_dtype` (or itself, detached, when None), requiring
    grad."""
    out = {}
    for name, p in params.items():
        leaf = p.detach()
        if grad_dtype is not None and leaf.is_floating_point():
            leaf = leaf.to(grad_dtype)
        out[name] = leaf.requires_grad_()
    return out


# The parameter --inject_nonfinite_step poisons: the first encoder kernel
# in the JAX tree's sorted-path order, layer 0's attention output
# projection (its flax kernel's element [0, 0, 0] is this weight's [0, 0]).
NAN_INJECT_PARAM = "bert.encoder.layers.0.attention.output.weight"


def inject_nonfinite(gparams: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Fault-injection drill (--inject_nonfinite_step): the compute leaves
    with element [0, 0] of NAN_INJECT_PARAM set to NaN in a copy (the
    f32 master is untouched), so a real NaN runs attention -> loss ->
    gradients as a hardware or data blowup would (the JAX package's
    `inject_nonfinite`)."""
    out = dict(gparams)
    leaf = gparams[NAN_INJECT_PARAM].detach().clone()
    with torch.no_grad():
        leaf.view(-1)[0] = float("nan")
    out[NAN_INJECT_PARAM] = leaf.requires_grad_()
    return out


# The packed-batch fields (data/packing.py) the model takes when the
# loader emits them; an unpacked batch runs the model without them.
PACKED_FIELDS = ("position_ids", "segment_ids", "nsp_positions")


def _model_inputs(micro: Batch, positions: Optional[torch.Tensor],
                  seeds: Optional[torch.Tensor], kfac=None) -> Dict:
    """The pretraining model's keyword inputs of one microbatch (`kfac`:
    K-FAC's taps, models/bert.KFACTaps)."""
    kw = {"token_type_ids": micro.get("token_type_ids"),
          "attention_mask": micro.get("attention_mask"),
          "masked_positions": positions, "dropout_seeds": seeds}
    kw.update({k: micro[k] for k in PACKED_FIELDS if k in micro})
    if kfac is not None:
        kw["kfac"] = kfac
    return kw


def pretrain_loss_fn(model: nn.Module,
                     max_predictions: Optional[int] = None) -> LossFn:
    """The pretraining loss (MLM + NSP) of `model` as a LossFn, with the
    masked-token counts as aux. `max_predictions` turns on the gathered
    MLM head: logits for at most that many masked positions per row (a
    packed row's budget covers all of its segments). A packed microbatch
    scores NSP per segment: (B, G) labels, -1 for an empty slot. The
    returned loss_fn takes `kfac=` (K-FAC's taps) too."""

    def loss_fn(params, micro, seeds, kfac=None, counts=None):
        labels = micro["masked_lm_labels"]
        positions = None
        dropped = torch.zeros((), dtype=torch.int64, device=labels.device)
        if max_predictions is not None:
            dense_total = (labels != -1).sum()
            positions, labels = gather_masked_labels(labels, max_predictions)
            # rows with more than max_predictions masks lose the excess
            dropped = dense_total - (labels != -1).sum()
        mlm_logits, nsp_logits = functional_call(
            model, params, (micro["input_ids"],),
            _model_inputs(micro, positions, seeds, kfac))
        nsp_labels = micro.get("next_sentence_labels")
        if counts is None:
            loss = losses.pretraining_loss(mlm_logits, labels, nsp_logits,
                                           nsp_labels)
        else:
            loss = losses.pretraining_loss_over_ranks(
                mlm_logits, labels, nsp_logits, nsp_labels, counts)
        with torch.no_grad():
            correct, total = losses.mlm_accuracy(mlm_logits, labels)
        return loss, {"mlm_correct": correct, "mlm_total": total,
                      "mlm_dropped": dropped}

    return loss_fn


def microbatch_counts(batch: Batch, accum_steps: int,
                      max_predictions: Optional[int]) -> torch.Tensor:
    """(accum_steps, 2) int64: each microbatch's scored masked tokens (at
    most `max_predictions` a row when the gathered head is on) and its
    NSP labels, the denominators of its loss."""
    rows = []
    for i in range(accum_steps):
        labels = batch["masked_lm_labels"][i]
        if max_predictions is not None:
            labels = gather_masked_labels(labels, max_predictions)[1]
        nsp = batch.get("next_sentence_labels")
        rows.append(torch.stack([
            (labels != -1).sum(),
            (nsp[i] != -1).sum() if nsp is not None
            else torch.zeros((), dtype=torch.int64, device=labels.device)]))
    return torch.stack(rows).to(torch.int64)


def debug_forward(model: nn.Module, params: Dict[str, torch.Tensor],
                  micro: Batch, seeds: Optional[torch.Tensor],
                  max_predictions: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """tools/replay.py --bisect's probe: one microbatch's forward as the
    step's loss runs it (the same masked-position gather, packed fields
    and seeds) under no_grad, returning (loss, the model's taps)."""
    labels = micro["masked_lm_labels"]
    positions = None
    if max_predictions is not None:
        positions, labels = gather_masked_labels(labels, max_predictions)
    kw = dict(_model_inputs(micro, positions, seeds), return_taps=True)
    with torch.no_grad():
        (mlm_logits, nsp_logits), taps = functional_call(
            model, params, (micro["input_ids"],), kw)
        loss = losses.pretraining_loss(mlm_logits, labels, nsp_logits,
                                       micro.get("next_sentence_labels"))
    return loss, taps


def loss_and_grads(loss_fn: LossFn, gparams: Dict[str, torch.Tensor],
                   micro: Batch, seeds: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One microbatch: (loss, aux, grads by parameter name); a parameter
    the loss does not reach gets zeros."""
    loss, aux = loss_fn(gparams, micro, seeds)
    names = list(gparams)
    grads = torch.autograd.grad(loss, [gparams[k] for k in names],
                                allow_unused=True)
    grads = [torch.zeros_like(gparams[k]) if g is None else g
             for k, g in zip(names, grads)]
    return loss.detach(), aux, dict(zip(names, grads))


def pretrain_loss_and_grads(model: nn.Module,
                            gparams: Dict[str, torch.Tensor], micro: Batch,
                            seeds: Optional[torch.Tensor],
                            max_predictions: Optional[int] = None
                            ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One pretraining microbatch: (loss, aux counts, grads by name)."""
    return loss_and_grads(pretrain_loss_fn(model, max_predictions), gparams,
                          micro, seeds)


def build_pretrain_step(model: nn.Module, tx,
                        schedule: Optional[Callable[[int], float]] = None,
                        accum_steps: int = 1,
                        loss_fn_builder: Optional[
                            Callable[[nn.Module], LossFn]] = None,
                        max_predictions: Optional[int] = None,
                        grad_dtype: Optional[torch.dtype] = None,
                        health: Optional[HealthConfig] = None,
                        nan_inject_step: Optional[int] = None,
                        dp=None
                        ) -> Callable[[TrainState, Batch,
                                       Optional[torch.Tensor]], Dict]:
    """Returns train_step(state, batch, seeds) -> metrics, which updates
    `state` in place. `tx` is any optimizer with Lamb's interface (`Lamb`,
    `FusedAdam`); `loss_fn_builder(model)` gives the loss (default: the
    pretraining loss; `max_predictions` applies to that one only).
    Metrics: loss, grad_norm (before any clip), with the pretraining loss
    mlm_accuracy and mlm_dropped (tensors on the card), learning_rate
    (`schedule` at the step before the update) and, with `health`, the
    non-finite counts (plus skipped_nonfinite under action "skip") and
    the EMA pack of `health_update` (grad_norm_ema, grad_norm_z,
    grad_spike, param_norm, param_norm_drift), whose carry the step keeps
    on `state.telemetry`. `nan_inject_step`: at that global step (the
    step being taken, 1-based) layer 0's attention output weight carries
    a NaN in the forward (`inject_nonfinite`).

    `dp` (a parallel/zero.DataParallel) makes it this rank's part of a
    data-parallel step (`_dp_step`): `batch` holds the rank's rows of
    every microbatch, and the loss, the metrics and the update are the
    whole global batch's."""
    if dp is not None and loss_fn_builder is not None:
        from bert_pytorch_tpu_torch import PARALLEL_GAPS

        raise NotImplementedError("a data-parallel step of a task loss is "
                                  f"not ported yet (see {PARALLEL_GAPS})")
    loss_fn = (pretrain_loss_fn(model, max_predictions)
               if loss_fn_builder is None else loss_fn_builder(model))

    def train_step(state: TrainState, batch: Batch,
                   seeds: Optional[torch.Tensor]) -> Dict:
        if dp is not None:
            return _dp_step(dp, loss_fn, tx, schedule, health, state, batch,
                            seeds, accum_steps, max_predictions, grad_dtype,
                            nan_inject_step)
        gparams = compute_params(state.params, grad_dtype)
        if nan_inject_step is not None and state.step + 1 == nan_inject_step:
            gparams = inject_nonfinite(gparams)

        def micro(i):
            return loss_and_grads(
                loss_fn, gparams, {k: v[i] for k, v in batch.items()},
                None if seeds is None else seeds[i])

        loss, aux, grads = _accumulate(micro, accum_steps)

        return _apply_update(tx, schedule, health, state, loss, aux, grads)

    return train_step


def _accumulate(micro_fn: Callable[[int], Tuple], accum_steps: int,
                into: Optional[Dict[str, torch.Tensor]] = None):
    """Run `micro_fn(i)` -> (loss, aux, grads, *more) over the
    microbatches: the mean loss and gradients (the carry in the
    gradients' dtype up to 128 microbatches, f32 beyond), aux summed, and
    each of `more` (dicts of dicts of tensors: K-FAC's statistics) summed
    then divided by the count. `into`: the carry's tensors by name (the
    data-parallel step's views of its flat buffer, in the carry's dtype),
    which then receive the gradients in place and are returned."""
    if accum_steps == 1 and into is None:
        return micro_fn(0)
    deep = accum_steps > 128
    grads = loss = aux = more = None
    for i in range(accum_steps):
        l_i, a_i, g_i, *m_i = micro_fn(i)
        if grads is None:
            if into is None:
                grads = {k: g.float() if deep else g for k, g in g_i.items()}
            else:
                grads = into
                for k, g in g_i.items():
                    grads[k].copy_(g)
            loss, aux, more = l_i.float(), dict(a_i), m_i
        else:
            for k, g in g_i.items():
                grads[k] += g.to(grads[k].dtype)
            loss = loss + l_i
            aux = {k: aux[k] + a_i[k] for k in aux}
            more = [{site: {k: t + m[site][k] for k, t in d.items()}
                     for site, d in acc.items()}
                    for acc, m in zip(more, m_i)]
        del g_i
    if accum_steps == 1:
        return (loss, aux, grads, *more)
    if into is None:
        grads = {k: g / accum_steps for k, g in grads.items()}
    else:
        for g in grads.values():
            g.div_(accum_steps)
    more = [{site: {k: t / accum_steps for k, t in d.items()}
             for site, d in acc.items()} for acc in more]
    return (loss / accum_steps, aux, grads, *more)


def _dp_step(dp, loss_fn: LossFn, tx, schedule, health, state: TrainState,
             batch: Batch, seeds: Optional[torch.Tensor], accum_steps: int,
             max_predictions: Optional[int],
             grad_dtype: Optional[torch.dtype],
             nan_inject_step: Optional[int]) -> Dict:
    """This rank's part of a data-parallel step (parallel/zero.py): the
    compute leaves (under gather-on-use every unit's all-gather issued
    here and awaited where the forward reaches the unit), the microbatch
    counts summed over the ranks, the rank's loss and gradients against
    them accumulated (`_accumulate`) into the views of the flat carry, the
    gradients summed over the ranks a unit at a time, the loss and counts
    summed, then the update (`_apply_update` with `dp`)."""
    gparams = dp.compute_params(state.params, grad_dtype)
    if gparams is None:
        gparams = compute_params(state.params, grad_dtype)
    if nan_inject_step is not None and state.step + 1 == nan_inject_step:
        dp.wait_all()
        gparams = inject_nonfinite(gparams)
    counts = dp.global_counts(
        microbatch_counts(batch, accum_steps, max_predictions))

    def micro(i):
        return loss_and_grads(
            lambda p, m, s: loss_fn(p, m, s, counts=counts[i]), gparams,
            {k: v[i] for k, v in batch.items()},
            None if seeds is None else seeds[i])

    # the carry: views of the flat buffer the reductions run over
    flat, views = dp.carry(torch.float32 if accum_steps > 128 else
                           next(iter(gparams.values())).dtype)
    loss, aux, _ = _accumulate(micro, accum_steps, into=views)
    dp.wait_all()
    grads = dp.reduce_grads(flat)
    # the loss and the counts of every rank, in one small reduction
    keys = sorted(aux)
    summed = dp.global_counts(torch.stack(
        [loss.float()] + [aux[k].float() for k in keys]))
    loss = summed[0]
    aux = {k: summed[1 + j] for j, k in enumerate(keys)}
    aux["mlm_dropped"] = aux["mlm_dropped"].to(torch.int64)
    return _apply_update(tx, schedule, health, state, loss, aux, grads,
                         dp=dp)


def _apply_update(tx, schedule, health, state: TrainState, loss, aux,
                  grads, precond_state=None, dp=None) -> Dict:
    """The step's tail, shared by both builders: the global gradient
    norm, the health pack's signals (under "skip" a bad step leaves the
    parameters, the optimizer state and, given `precond_state`, K-FAC's
    state as they were), the update, the metrics, the step count."""
    zero1 = dp is not None and dp.zero1
    grad_norm = (dp.global_norm(list(grads.values())) if zero1
                 else global_norm_f32(grads.values()))
    metrics: Dict = {"loss": loss, "grad_norm": grad_norm}
    skip = False
    bad = None
    if health is not None:
        hmetrics, bad = health_signals(
            loss, grads, grad_norm,
            names=dp.layout.names if zero1 else None,
            reduce=dp.nonfinite_counts if zero1 else None)
        metrics.update(hmetrics)
        if health.action == "skip":
            skip = bool(bad)
            metrics["skipped_nonfinite"] = int(skip)
    own = dp.piece_views(dp.master) if zero1 else None
    if not skip:
        if zero1:
            tx.update(grads, state.opt_state, own, grad_norm=grad_norm,
                      shards=dp)
        else:
            tx.update(grads, state.opt_state, state.params,
                      grad_norm=grad_norm)
        if precond_state is not None:
            state.precond_state = precond_state
    if zero1 and not dp.gather_on_use:
        dp.gather_masters()
    if health is not None:
        state.telemetry, ema_metrics = health_update(
            health, state.telemetry, grad_norm, bad,
            state.params.values(),
            param_norm=dp.global_norm(list(own.values())) if zero1
            else None)
        metrics.update(ema_metrics)
    if "mlm_total" in aux:
        metrics["mlm_accuracy"] = (aux["mlm_correct"]
                                   / aux["mlm_total"].clamp_min(1))
        metrics["mlm_dropped"] = aux["mlm_dropped"]
    if schedule is not None:
        metrics["learning_rate"] = schedule(state.step)
    state.step += 1
    return metrics


def build_kfac_pretrain_step(model: nn.Module, tx, kfac,
                             schedule: Optional[Callable[[int], float]] = None,
                             accum_steps: int = 1,
                             max_predictions: Optional[int] = None,
                             grad_dtype: Optional[torch.dtype] = None,
                             health: Optional[HealthConfig] = None,
                             nan_inject_step: Optional[int] = None
                             ) -> Callable[[TrainState, Batch,
                                            Optional[torch.Tensor]], Dict]:
    """The K-FAC variant of `build_pretrain_step` (JAX's
    build_kfac_pretrain_step): `model` built with config.kfac_taps, `kfac`
    an optim/kfac.KFAC, `state.precond_state` its KFACState
    (`init_kfac_state`). Each microbatch's forward runs with K-FAC's taps,
    and one backward pass gives the parameters' gradients and the taps'
    output gradients, whose statistics are summed over the microbatches
    and divided by their count. Then, as the reference's step: the
    preconditioner (factor EMA, inversion on its interval, F^-1 g, kl_clip
    at `schedule(state.step)`), then `tx` (LAMB) on the preconditioned
    gradients; grad_norm is theirs. Under the health pack's "skip" a bad
    step keeps K-FAC's state too. Packed batches, `grad_dtype`,
    `nan_inject_step` and the metrics are build_pretrain_step's."""
    from bert_pytorch_tpu_torch.models.bert import KFACTaps

    loss_fn = pretrain_loss_fn(model, max_predictions)

    def train_step(state: TrainState, batch: Batch,
                   seeds: Optional[torch.Tensor]) -> Dict:
        gparams = compute_params(state.params, grad_dtype)
        if nan_inject_step is not None and state.step + 1 == nan_inject_step:
            gparams = inject_nonfinite(gparams)
        names = list(gparams)

        def micro(i):
            taps = KFACTaps()
            loss, aux = loss_fn(gparams, {k: v[i] for k, v in batch.items()},
                                None if seeds is None else seeds[i], taps)
            sites = list(taps.perts)
            out = torch.autograd.grad(
                loss, [gparams[k] for k in names]
                + [taps.perts[s] for s in sites], allow_unused=True)
            grads = {k: torch.zeros_like(gparams[k]) if g is None else g
                     for k, g in zip(names, out)}
            stats = kfac.compute_stats(
                taps.acts, dict(zip(sites, out[len(names):])))
            return loss.detach(), aux, grads, stats

        loss, aux, grads, stats = _accumulate(micro, accum_steps)
        lr = schedule(state.step) if schedule is not None else 1.0
        kstate, grads = kfac.step(state.precond_state, stats, grads, lr)
        return _apply_update(tx, schedule, health, state, loss, aux, grads,
                             precond_state=kstate)

    return train_step


def init_kfac_state(model: nn.Module, kfac, state: TrainState) -> None:
    """Attach a fresh KFACState (zero factors, identity inverses) for the
    sites of `model` (built with config.kfac_taps) to `state`, on its
    parameters' device, before any restore."""
    from bert_pytorch_tpu_torch.optim.kfac import site_shapes

    device = next(iter(state.params.values())).device
    state.precond_state = kfac.init(site_shapes(model), device)


def _sticky_max(a, b):
    if torch.is_tensor(a) or torch.is_tensor(b):
        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
    return max(a, b)


def chain_steps(step_fn: Callable, n_steps: int) -> Callable:
    """A --steps_per_loop chunk (JAX's chain_steps with per_step_batch):
    chained(state, batch, seeds) runs `step_fn` n_steps times, inner step
    i on batch[k][i] (a leading (n_steps, ...) axis) with seeds[i], the
    dropout seeds of its own global step, so a chunk computes what
    n_steps single steps compute, bit for bit. Nothing is read back to
    the host between its steps beyond what one step reads. Returns the
    last step's metrics, except the health flags (telemetry/health.
    is_sticky_metric), max-accumulated over the chunk so that a NaN or a
    spike in any inner step survives to the one read a chunk."""
    if n_steps == 1:
        return lambda state, batch, seeds: step_fn(
            state, {k: v[0] for k, v in batch.items()},
            None if seeds is None else seeds[0])

    def chained(state, batch, seeds):
        metrics = None
        for i in range(n_steps):
            m = step_fn(state, {k: v[i] for k, v in batch.items()},
                        None if seeds is None else seeds[i])
            if metrics is not None:
                for k in m:
                    if is_sticky_metric(k) and k in metrics:
                        m[k] = _sticky_max(m[k], metrics[k])
            metrics = m
        return metrics

    return chained
