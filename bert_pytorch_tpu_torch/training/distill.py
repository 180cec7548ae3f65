"""Teacher -> student distillation on the finetune loop (counterpart of
bert_pytorch_tpu/training/distill.py).

Any registered task becomes a distillation target: a student (the
`student_<L>l_<H>` preset of config.student_config, or a config file)
trains against a frozen teacher inside the same train step
(training/pretrain.build_pretrain_step through training/finetune.run_task),
so packing, StepWatch, the preemption guard and checkpoints are the
finetune loop's, and the student's checkpoint serves through run_server
as any task checkpoint does.

The loss, in the task's own shape:

- soft-target KD: the temperature-scaled KL(teacher || student) of the
  head's logits, times T^2: a segment's for pooled heads, a token's for
  token heads, a segment's own softmax window for packed QA spans;
- hard-label CE: the task's own loss on the gold labels;
- layer-matched tap losses: the mean squared error a real token between a
  student tap and the mapped teacher tap (`attention_out`, `mlp_out`:
  models/bert.py's taps), under the layer map, through a learned
  (H_student, H_teacher) projection when the widths differ. The
  projections (`distill_proj.layer_<i>.<kind>.kernel`) ride in the train
  state beside the student's parameters (TaskRun.extra_params), so the
  optimizer trains them and the checkpoint carries them; the server's
  restore drops exactly that prefix.

Every packed reduction goes through models/losses' `segment_onehot` and
`_ordered_sum`, so on the CPU a packed batch's loss equals the same
examples one a row bit for bit. The teacher is its own module, never in
the optimizer's tree: it runs under torch.no_grad(), deterministic (no
dropout seeds), so no kernel saves an activation for it and it launches
no backward. A batch that carries `teacher_logits` (or
`teacher_start_logits` / `teacher_end_logits`) skips the teacher forward
when no tap loss is on, with the same student gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from bert_pytorch_tpu_torch.models import losses
from bert_pytorch_tpu_torch.training.checkpoint import PROJ_PREFIX

# tap-loss weight -> the models/bert.py tap it matches on
TAP_KINDS = (("attention_out", "alpha_attn"), ("mlp_out", "alpha_hidden"))


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """The loss mix and the layer map of one distillation run."""

    temperature: float = 2.0
    alpha_kd: float = 1.0        # soft-target KL weight
    alpha_ce: float = 0.5        # hard-label task-loss weight
    alpha_hidden: float = 0.0    # layer-matched mlp_out MSE weight
    alpha_attn: float = 0.0      # layer-matched attention_out MSE weight
    layer_map: Tuple[Tuple[int, int], ...] = ()  # (student, teacher) pairs
    max_segments: int = 8

    @property
    def needs_taps(self) -> bool:
        return self.alpha_hidden > 0 or self.alpha_attn > 0


def default_layer_map(student_layers: int,
                      teacher_layers: int) -> Tuple[Tuple[int, int], ...]:
    """Evenly spaced: student layer i <- teacher layer (i + 1) Lt // Ls
    - 1, ending on the top one (a 6-layer student of BERT-Large: 3, 7,
    11, 15, 19, 23)."""
    if student_layers < 1 or teacher_layers < 1:
        raise ValueError("layer counts must be >= 1")
    return tuple((i, (i + 1) * teacher_layers // student_layers - 1)
                 for i in range(student_layers))


def parse_layer_map(text: Optional[str], student_layers: int,
                    teacher_layers: int) -> Tuple[Tuple[int, int], ...]:
    """'s:t,s:t,...' -> ((s, t), ...), checked against both depths;
    None or empty -> default_layer_map."""
    if not text:
        return default_layer_map(student_layers, teacher_layers)
    pairs = []
    for item in text.split(","):
        s, _, t = item.partition(":")
        try:
            si, ti = int(s), int(t)
        except ValueError:
            raise ValueError(f"bad layer-map entry {item!r}; want "
                             "'student:teacher' ints, e.g. '0:1,1:3'")
        if not (0 <= si < student_layers):
            raise ValueError(f"layer map student index {si} out of range "
                             f"[0, {student_layers})")
        if not (0 <= ti < teacher_layers):
            raise ValueError(f"layer map teacher index {ti} out of range "
                             f"[0, {teacher_layers})")
        pairs.append((si, ti))
    return tuple(pairs)


# -- KD losses ----------------------------------------------------------------


def _kl_terms(s_logits: torch.Tensor, t_logits: torch.Tensor,
              temperature: float) -> torch.Tensor:
    """A slot's KL(teacher_T || student_T) x T^2 in f32, reduced over the
    class axis only: a slot's value does not depend on the batch's
    shape."""
    t = float(temperature)
    s_logp = torch.log_softmax(s_logits.float() / t, dim=-1)
    t_logp = torch.log_softmax(t_logits.float() / t, dim=-1)
    p = torch.exp(t_logp)
    return (p * (t_logp - s_logp)).sum(-1) * (t * t)


def _valid_count(valid: torch.Tensor) -> torch.Tensor:
    return valid.sum().clamp_min(1)


def kd_segment_loss(s_logits: torch.Tensor, t_logits: torch.Tensor,
                    labels: torch.Tensor, temperature: float
                    ) -> torch.Tensor:
    """Pooled heads: (B, G, C) logits against (B, G) labels (-1 an empty
    slot), or (B, C) against (B,); empty slots add exactly 0 to the
    ordered sum."""
    kl = _kl_terms(s_logits, t_logits, temperature)
    valid = labels != -1
    kl = torch.where(valid, kl, torch.zeros_like(kl))
    return losses._ordered_sum(kl) / _valid_count(valid)


def kd_token_loss(s_logits: torch.Tensor, t_logits: torch.Tensor,
                  labels: torch.Tensor, segment_ids: torch.Tensor,
                  max_segments: int, temperature: float,
                  ignore_index: int = -100) -> torch.Tensor:
    """Token heads on packed rows, segment first as
    losses.packed_token_loss: the per-token KL contracted against the
    segment one-hot, then the ordered (B, G) sum."""
    kl = _kl_terms(s_logits, t_logits, temperature)
    valid = labels != ignore_index
    kl = torch.where(valid, kl, torch.zeros_like(kl))
    onehot = losses.segment_onehot(segment_ids, max_segments).float()
    seg_kl = torch.einsum("bgs,bs->bg", onehot, kl)
    return losses._ordered_sum(seg_kl) / _valid_count(valid)


def kd_plain_token_loss(s_logits: torch.Tensor, t_logits: torch.Tensor,
                        labels: torch.Tensor, temperature: float,
                        ignore_index: int = -100) -> torch.Tensor:
    """Unpacked token heads: the mean over supervised positions."""
    kl = _kl_terms(s_logits, t_logits, temperature)
    valid = labels != ignore_index
    kl = torch.where(valid, kl, torch.zeros_like(kl))
    return kl.sum() / _valid_count(valid)


def kd_qa_loss(s_start: torch.Tensor, s_end: torch.Tensor,
               t_start: torch.Tensor, t_end: torch.Tensor,
               segment_ids: torch.Tensor, max_segments: int,
               temperature: float) -> torch.Tensor:
    """Packed QA rows: each segment's softmax window covers its own
    positions only (-inf elsewhere, as losses.packed_qa_loss), the KL is
    masked back to the segment's positions, the (B, G) aggregate takes
    the ordered sum."""
    seg_mask = losses.segment_onehot(segment_ids, max_segments)  # (B, G, S)
    minus_inf = torch.tensor(float("-inf"), device=seg_mask.device)
    t = float(temperature)

    def one(s_logits, t_logits):
        s = s_logits.float()[:, None, :] / t
        tt = t_logits.float()[:, None, :] / t
        s_logp = torch.log_softmax(torch.where(seg_mask, s, minus_inf), -1)
        t_logp = torch.log_softmax(torch.where(seg_mask, tt, minus_inf), -1)
        p = torch.exp(t_logp)
        terms = p * (t_logp - s_logp)
        kl = torch.where(seg_mask, terms, torch.zeros_like(terms)).sum(-1)
        kl = kl * (t * t)                                        # (B, G)
        valid = seg_mask.any(-1)
        kl = torch.where(valid, kl, torch.zeros_like(kl))
        return losses._ordered_sum(kl) / _valid_count(valid)

    return (one(s_start, t_start) + one(s_end, t_end)) / 2.0


def kd_plain_qa_loss(s_start: torch.Tensor, s_end: torch.Tensor,
                     t_start: torch.Tensor, t_end: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """Unpacked QA: full-row softmax windows, the mean over the batch."""
    kl_s = _kl_terms(s_start, t_start, temperature)
    kl_e = _kl_terms(s_end, t_end, temperature)
    return (kl_s.mean() + kl_e.mean()) / 2.0


# -- tap losses ---------------------------------------------------------------


def tap_match_loss(s_tap: torch.Tensor, t_tap: torch.Tensor,
                   proj: Optional[torch.Tensor],
                   attention_mask: torch.Tensor,
                   segment_ids: Optional[torch.Tensor],
                   max_segments: int) -> torch.Tensor:
    """The squared error a token between a student tap (projected to the
    teacher's width by `proj`, (H_s, H_t), when given: before the
    masking) and the mapped teacher tap, over real tokens, normalized by
    (real tokens x teacher width); packed rows reduce segment first with
    the ordered sum."""
    s = s_tap.float()
    if proj is not None:
        s = s @ proj.float()
    err = ((s - t_tap.float()) ** 2).sum(-1)              # (B, S)
    mask = attention_mask > 0
    err = torch.where(mask, err, torch.zeros_like(err))
    denom = _valid_count(mask) * t_tap.shape[-1]
    if segment_ids is not None:
        onehot = losses.segment_onehot(segment_ids, max_segments).float()
        seg = torch.einsum("bgs,bs->bg", onehot, err)
        return losses._ordered_sum(seg) / denom
    return err.sum() / denom


def projection_name(student_layer: int, kind: str) -> str:
    return f"{PROJ_PREFIX}layer_{student_layer}.{kind}.kernel"


def init_projections(generator: torch.Generator, dcfg: DistillConfig,
                     student_cfg, teacher_cfg, device="cpu"
                     ) -> Dict[str, nn.Parameter]:
    """The projections by name: one (H_student, H_teacher) f32 kernel a
    mapped student layer and enabled tap kind, normal(0,
    teacher initializer_range) from `generator`. Empty when the widths
    match or no tap loss is on."""
    if (not dcfg.needs_taps
            or student_cfg.hidden_size == teacher_cfg.hidden_size):
        return {}
    shape = (student_cfg.hidden_size, teacher_cfg.hidden_size)
    out: Dict[str, nn.Parameter] = {}
    for si, _ti in dcfg.layer_map:
        for kind, alpha_name in TAP_KINDS:
            if getattr(dcfg, alpha_name) <= 0:
                continue
            kernel = torch.empty(shape, dtype=torch.float32, device=device)
            kernel.normal_(0.0, teacher_cfg.initializer_range,
                           generator=generator)
            out[projection_name(si, kind)] = nn.Parameter(kernel)
    return out


def projected_layers(names) -> List[str]:
    """['layer_<i>', ...] of the projection names, sorted."""
    return sorted({n[len(PROJ_PREFIX):].split(".")[0] for n in names
                   if n.startswith(PROJ_PREFIX)})


# -- the loss builder run_task's step calls -----------------------------------


def _head_kwargs(micro, packed: bool, seeds) -> Dict:
    kwargs = {"token_type_ids": micro.get("token_type_ids"),
              "attention_mask": micro["attention_mask"],
              "dropout_seeds": seeds}
    if packed:
        kwargs["position_ids"] = micro["position_ids"]
        kwargs["segment_ids"] = micro["segment_ids"]
    if "head_keep" in micro:
        kwargs["head_keep"] = micro["head_keep"]
    return kwargs


def _precomputed_teacher(micro):
    if "teacher_start_logits" in micro:
        return (micro["teacher_start_logits"], micro["teacher_end_logits"])
    return micro.get("teacher_logits")


def _head_losses(s_out, t_out, micro, dcfg: DistillConfig,
                 output_kind: str, packed: bool,
                 label_ignore: Dict[str, int]):
    """(kd, hard) in the head's shape: QA pairs, token heads, pooled
    segment heads (the multiple-choice regroup included)."""
    if output_kind == "segment" and isinstance(s_out, (tuple, list)):
        # the sentence-embedding head: (embeddings, probe logits); its
        # loss is the probe's
        s_out = s_out[1]
        if isinstance(t_out, (tuple, list)):
            t_out = t_out[1]
    if isinstance(s_out, (tuple, list)):
        sp, ep = micro["start_positions"], micro["end_positions"]
        if packed:
            kd = kd_qa_loss(s_out[0], s_out[1], t_out[0], t_out[1],
                            micro["segment_ids"], dcfg.max_segments,
                            dcfg.temperature)
            hard = losses.packed_qa_loss(s_out[0], s_out[1], sp, ep,
                                         micro["segment_ids"],
                                         dcfg.max_segments)
        else:
            kd = kd_plain_qa_loss(s_out[0], s_out[1], t_out[0], t_out[1],
                                  dcfg.temperature)
            hard = losses.qa_loss(s_out[0], s_out[1], sp, ep)
        return kd, hard

    labels = micro["labels"]
    if output_kind == "token":
        ignore = label_ignore.get("labels", -100)
        if packed:
            kd = kd_token_loss(s_out, t_out, labels, micro["segment_ids"],
                               dcfg.max_segments, dcfg.temperature, ignore)
            hard = losses.packed_token_loss(s_out, labels,
                                            micro["segment_ids"],
                                            dcfg.max_segments, ignore)
        else:
            kd = kd_plain_token_loss(s_out, t_out, labels,
                                     dcfg.temperature, ignore)
            hard = losses.token_classification_loss(s_out, labels, ignore)
        return kd, hard

    if s_out.dim() == labels.dim() and s_out.shape[-1] != labels.shape[-1]:
        # packed multiple choice: (B, G) scores against (B, G / C) labels
        n_choices = s_out.shape[-1] // labels.shape[-1]
        s_out = s_out.reshape(*s_out.shape[:-1], -1, n_choices)
        t_out = t_out.reshape(*t_out.shape[:-1], -1, n_choices)
    kd = kd_segment_loss(s_out, t_out, labels, dcfg.temperature)
    hard = losses.segment_classification_loss(s_out, labels)
    return kd, hard


def make_distill_loss_builder(*, teacher_model: nn.Module,
                              dcfg: DistillConfig, output_kind: str,
                              packed: bool,
                              label_ignore: Optional[Dict[str, int]] = None):
    """A loss builder for build_pretrain_step: builder(student) ->
    loss_fn(params, micro, seeds). The student runs through
    functional_call on its own parameters (`params` without the
    `distill_proj.` names, which are the projections); the teacher,
    holding its own weights, under torch.no_grad() without seeds, skipped
    when the microbatch carries its logits and no tap loss is on. The
    loss is alpha_kd KD + alpha_ce hard + the alpha-weighted tap terms."""
    ignore = dict(label_ignore or {})
    taps_on = dcfg.needs_taps

    def builder(student: nn.Module):
        from torch.func import functional_call

        def loss_fn(params, micro, seeds):
            proj = {k: v for k, v in params.items()
                    if k.startswith(PROJ_PREFIX)}
            s_params = {k: v for k, v in params.items() if k not in proj}
            kwargs = _head_kwargs(micro, packed, seeds)
            s_res = functional_call(student, s_params, (micro["input_ids"],),
                                    dict(kwargs, return_taps=taps_on))
            s_out, s_taps = s_res if taps_on else (s_res, None)

            pre = _precomputed_teacher(micro)
            if pre is not None and not taps_on:
                t_out, t_taps = pre, None
            else:
                t_kwargs = _head_kwargs(micro, packed, None)
                t_kwargs.pop("head_keep", None)
                with torch.no_grad():
                    t_res = teacher_model(micro["input_ids"],
                                          return_taps=taps_on, **t_kwargs)
                t_out, t_taps = t_res if taps_on else (t_res, None)

            kd, hard = _head_losses(s_out, t_out, micro, dcfg, output_kind,
                                    packed, ignore)
            total = torch.zeros((), dtype=torch.float32, device=kd.device)
            if dcfg.alpha_kd:
                total = total + dcfg.alpha_kd * kd
            if dcfg.alpha_ce:
                total = total + dcfg.alpha_ce * hard
            if taps_on:
                seg_ids = micro["segment_ids"] if packed else None
                for si, ti in dcfg.layer_map:
                    for kind, alpha_name in TAP_KINDS:
                        alpha = getattr(dcfg, alpha_name)
                        if alpha <= 0:
                            continue
                        total = total + alpha * tap_match_loss(
                            s_taps[si][kind], t_taps[ti][kind],
                            proj.get(projection_name(si, kind)),
                            micro["attention_mask"], seg_ids,
                            dcfg.max_segments)
            return total, {}

        return loss_fn

    return builder
