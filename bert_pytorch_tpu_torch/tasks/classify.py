"""`classify` task: GLUE-style sequence (pair) classification
(counterpart of bert_pytorch_tpu/tasks/classify.py).

Head: BertForSequenceClassification (the pooled [CLS], dropout, a
Linear over --labels). Data: TSV ``label<TAB>text_a[<TAB>text_b]``
(data/glue.py). Training: the base finetune recipe (linear warmup and
decay from --lr, FusedAdam with the clip at --clip_grad), accuracy on
the val split every epoch and on the test split at the end. Packed
training (--packing) gathers every segment's [CLS] through the pooler:
(B, G, C) logits against (B, G) labels (`segment_scalar_pack_labels`).
Serving:
`POST /v1/classify` with {"text", "text_pair"}, one packed segment a
request, whose pooled logits come back as its label and softmax.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from bert_pytorch_tpu_torch.tasks import predict, registry
from bert_pytorch_tpu_torch.training.finetune import (
    COMMON_REFUSED, COMMON_TUNING, segment_scalar_pack_labels as pack_labels)

# The JAX base parser's flags whose feature the port lacks (see
# squad_task): none are left.
_REFUSED = dict(COMMON_REFUSED)
_TUNING = dict(COMMON_TUNING)


def build_parser():
    from bert_pytorch_tpu_torch.training.finetune import base_finetune_parser

    p = base_finetune_parser(__doc__.split("\n")[0])
    p.add_argument("--labels", type=str, nargs="+",
                   default=["negative", "positive"],
                   help="class names in label-id order")
    return p


def parse_arguments(argv=None):
    from bert_pytorch_tpu_torch import FINETUNE_GAPS, refuse

    args = build_parser().parse_args(argv)
    refuse(args, _REFUSED, FINETUNE_GAPS)
    return args


def build_serving_model(config, dtype, opts: Dict[str, Any], device):
    from bert_pytorch_tpu_torch.models.bert import (
        BertForSequenceClassification)

    with torch.device(device):
        return BertForSequenceClassification(
            config, num_labels=len(opts.get("class_names") or ["0", "1"]),
            max_segments=int(opts.get("max_segments", 8)), dtype=dtype)


def make_service(scheduler, featurize, opts: Dict[str, Any]):
    from bert_pytorch_tpu_torch.serving.frontend import ClassifyService

    return ClassifyService(scheduler, featurize,
                           class_names=list(opts.get("class_names")
                                            or ["0", "1"]))


def _loss_builder(model):
    """The classification loss; a microbatch may carry `head_keep`, the
    head's dropout mask given as an input, and a packed one
    `position_ids` and `segment_ids` (per-segment logits)."""
    from torch.func import functional_call

    from bert_pytorch_tpu_torch.models import losses

    def loss_fn(params, micro, seeds):
        logits = functional_call(
            model, params, (micro["input_ids"],),
            {"token_type_ids": micro.get("token_type_ids"),
             "attention_mask": micro["attention_mask"],
             "position_ids": micro.get("position_ids"),
             "segment_ids": micro.get("segment_ids"),
             "dropout_seeds": seeds, "head_keep": micro.get("head_keep")})
        return losses.segment_classification_loss(logits,
                                                  micro["labels"]), {}

    return loss_fn


def setup(args, config, device, log, record):
    from bert_pytorch_tpu_torch.data import glue
    from bert_pytorch_tpu_torch.models.bert import (
        BertForSequenceClassification)
    from bert_pytorch_tpu_torch.training.finetune import (
        TaskRun, accuracy_evals, dataset_splits, epoch_steps, eval_buckets,
        eval_closures, finetune_optimizer, resolve_tokenizer)

    tokenizer = resolve_tokenizer(args, config)
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    with torch.device(device):
        model = BertForSequenceClassification(
            config, num_labels=len(args.labels),
            max_segments=args.packing_max_segments, dtype=compute_dtype)

    datasets = dataset_splits(args, lambda path: glue.PairClassificationDataset(
        path, tokenizer, args.labels, max_seq_len=args.max_seq_len).arrays())
    train = datasets.get("train")
    steps_per_epoch, total_steps = epoch_steps(train, args)
    sched, tx = finetune_optimizer(args, total_steps)
    evals = accuracy_evals(datasets, args.batch_size,
                           eval_buckets(args.max_seq_len),
                           predict.build_classify_forward(model), device)
    epoch_eval, finalize = eval_closures(evals, record)

    return TaskRun(
        model=model, tx=tx, schedule=sched, seq_len=args.max_seq_len,
        batch_size=args.batch_size, total_steps=total_steps,
        epochs=args.epochs, train_arrays=train, loss_builder=_loss_builder,
        packed_loss_builder=_loss_builder, pack_labels=pack_labels,
        label_ignore={"labels": -1}, log_every=max(1, steps_per_epoch),
        init_checkpoint=args.init_checkpoint, epoch_eval=epoch_eval,
        finalize=finalize)


registry.register(registry.TaskSpec(
    name="classify", title="GLUE-style sequence (pair) classification",
    head="BertForSequenceClassification", output_kind="segment",
    metric="accuracy",
    request_schema={"text": "str (required)",
                    "text_pair": "str (optional second sentence)"},
    parse_arguments=parse_arguments, setup=setup,
    build_serving_model=build_serving_model,
    forward_builder=predict.build_classify_forward,
    make_service=make_service))
