"""`choice` task: SWAG-style multiple choice (counterpart of
bert_pytorch_tpu/tasks/choice.py).

Head: BertForMultipleChoice (the pooled [CLS], dropout, a 1-wide
Linear). Data: JSONL ``{"question", "choices", "label"}`` with
--num_choices choices a record (data/glue.py). Training scores each
(B, C, S) batch as B * C rows and takes the CE across each example's C
scores, with the base finetune recipe; accuracy on val every epoch and
on test at the end. Packed training (--packing) places an example's C
choices as C consecutive segments of one row (one packing unit, so
--packing_max_segments is rounded down to a multiple of C), scores every
segment through the per-segment pooled gather and softmaxes within each
C-group (`make_pack_labels`: (B, G / C) labels). Serving: `POST
/v1/choice` with {"question", "choices"}, one packed segment a choice (2
to 16 of them), softmaxed on the host: the same head parameters and
math.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from bert_pytorch_tpu_torch.tasks import predict, registry
from bert_pytorch_tpu_torch.training.finetune import (COMMON_REFUSED,
                                                      COMMON_TUNING)

# The JAX base parser's flags whose feature the port lacks (see
# squad_task): none are left.
_REFUSED = dict(COMMON_REFUSED)
_TUNING = dict(COMMON_TUNING)


def build_parser():
    from bert_pytorch_tpu_torch.training.finetune import base_finetune_parser

    p = base_finetune_parser(__doc__.split("\n")[0])
    p.add_argument("--num_choices", type=int, default=4,
                   help="choices per example (fixed per file)")
    return p


def parse_arguments(argv=None):
    from bert_pytorch_tpu_torch import FINETUNE_GAPS, refuse

    args = build_parser().parse_args(argv)
    refuse(args, _REFUSED, FINETUNE_GAPS)
    return args


def build_serving_model(config, dtype, opts: Dict[str, Any], device):
    from bert_pytorch_tpu_torch.models.bert import BertForMultipleChoice

    with torch.device(device):
        return BertForMultipleChoice(
            config, max_segments=int(opts.get("max_segments", 8)),
            dtype=dtype)


def make_service(scheduler, featurize, opts: Dict[str, Any]):
    from bert_pytorch_tpu_torch.serving.frontend import ChoiceService

    return ChoiceService(scheduler, featurize)


def make_pack_labels(num_choices: int):
    """Per-group labels: (n_rows, G // C) chosen-choice indices, -1 for
    an empty group. A unit fills C consecutive segments, so its group is
    seg0 // C."""

    def pack_labels(arrays, placements, n_rows, seq_len, max_segments):
        labels = np.full((n_rows, max_segments // num_choices), -1,
                         np.int32)
        for p in placements:
            labels[p.row, p.seg0 // num_choices] = arrays["labels"][p.unit]
        return {"labels": labels}

    return pack_labels


def make_loss_builder(num_choices: int):
    """The choice loss over (B, C, S) microbatches, or packed (B, S) ones
    with `position_ids` and `segment_ids` ((B, G) scores regrouped by
    C); a microbatch may carry `head_keep` ((B * C, E), or (B, G, E)
    packed), the head's dropout mask given as an input."""

    def loss_builder(model):
        from torch.func import functional_call

        from bert_pytorch_tpu_torch.models import losses

        def loss_fn(params, micro, seeds):
            scores = functional_call(
                model, params, (micro["input_ids"],),
                {"token_type_ids": micro.get("token_type_ids"),
                 "attention_mask": micro["attention_mask"],
                 "position_ids": micro.get("position_ids"),
                 "segment_ids": micro.get("segment_ids"),
                 "dropout_seeds": seeds,
                 "head_keep": micro.get("head_keep")})
            return losses.choice_loss(scores, micro["labels"],
                                      num_choices), {}

        return loss_fn

    return loss_builder


def setup(args, config, device, log, record):
    from bert_pytorch_tpu_torch.data import glue
    from bert_pytorch_tpu_torch.models.bert import BertForMultipleChoice
    from bert_pytorch_tpu_torch.training.finetune import (
        TaskRun, accuracy_evals, dataset_splits, epoch_steps, eval_buckets,
        eval_closures, finetune_optimizer, resolve_tokenizer)

    c = int(args.num_choices)
    # packed groups need C consecutive segment slots: round G down to a
    # multiple of C (and at least one whole group)
    args.packing_max_segments = max(c, (args.packing_max_segments // c) * c)
    tokenizer = resolve_tokenizer(args, config)
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    with torch.device(device):
        model = BertForMultipleChoice(
            config, max_segments=args.packing_max_segments,
            dtype=compute_dtype)

    datasets = dataset_splits(args, lambda path: glue.MultipleChoiceDataset(
        path, tokenizer, c, max_seq_len=args.max_seq_len).arrays())
    train = datasets.get("train")
    steps_per_epoch, total_steps = epoch_steps(train, args, group_size=c)
    sched, tx = finetune_optimizer(args, total_steps)
    evals = accuracy_evals(datasets, args.batch_size,
                           eval_buckets(args.max_seq_len),
                           predict.build_choice_forward(model), device)
    epoch_eval, finalize = eval_closures(evals, record)

    return TaskRun(
        model=model, tx=tx, schedule=sched, seq_len=args.max_seq_len,
        batch_size=args.batch_size, total_steps=total_steps,
        epochs=args.epochs, train_arrays=train,
        loss_builder=make_loss_builder(c),
        packed_loss_builder=make_loss_builder(c),
        pack_labels=make_pack_labels(c), group_size=c,
        label_ignore={"labels": -1},
        log_every=max(1, steps_per_epoch),
        init_checkpoint=args.init_checkpoint, epoch_eval=epoch_eval,
        finalize=finalize)


registry.register(registry.TaskSpec(
    name="choice", title="SWAG-style multiple choice",
    head="BertForMultipleChoice", output_kind="segment", metric="accuracy",
    request_schema={"question": "str (optional premise)",
                    "choices": "list[str] (2..16 candidates)"},
    parse_arguments=parse_arguments, setup=setup,
    build_serving_model=build_serving_model,
    forward_builder=predict.build_choice_forward,
    make_service=make_service))
