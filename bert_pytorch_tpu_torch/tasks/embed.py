"""`embed` task: mean-pooled sentence embeddings for batch embedding and
retrieval (counterpart of bert_pytorch_tpu/tasks/embed.py).

Head: BertForSentenceEmbedding, the L2-normalised f32 mean of the
sequence output over each text's real tokens. Training finetunes the
encoder through a linear probe on that mean (classification CE over
proxy labels of TSV ``label<TAB>text`` rows, data/glue.py) with the base
finetune recipe; the probe's accuracy on val every epoch and on test at
the end, and the embeddings' dimension and worst distance from unit norm
on one eval batch. Packed training (--packing) means each segment's own
tokens, (B, G) labels (`segment_scalar_pack_labels`). Serving drops the
probe: `POST /v1/embed` with
{"text"} or {"texts"} (up to 32) returns one embedding a text, each text
one packed segment.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
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
                   help="probe class names in label-id order (the training "
                        "objective only; serving returns embeddings)")
    return p


def parse_arguments(argv=None):
    from bert_pytorch_tpu_torch import FINETUNE_GAPS, refuse

    args = build_parser().parse_args(argv)
    refuse(args, _REFUSED, FINETUNE_GAPS)
    return args


def build_serving_model(config, dtype, opts: Dict[str, Any], device):
    from bert_pytorch_tpu_torch.models.bert import BertForSentenceEmbedding

    with torch.device(device):
        return BertForSentenceEmbedding(
            config, num_labels=int(opts.get("embed_labels", 2)),
            max_segments=int(opts.get("max_segments", 8)), dtype=dtype)


def make_service(scheduler, featurize, opts: Dict[str, Any]):
    from bert_pytorch_tpu_torch.serving.frontend import EmbedService

    return EmbedService(scheduler, featurize)


def _loss_builder(model):
    """The probe's classification loss on the mean-pooled output (each
    segment's own mean when the microbatch is packed)."""
    from torch.func import functional_call

    from bert_pytorch_tpu_torch.models import losses

    def loss_fn(params, micro, seeds):
        _, logits = functional_call(
            model, params, (micro["input_ids"],),
            {"token_type_ids": micro.get("token_type_ids"),
             "attention_mask": micro["attention_mask"],
             "position_ids": micro.get("position_ids"),
             "segment_ids": micro.get("segment_ids"),
             "dropout_seeds": seeds})
        return losses.segment_classification_loss(logits,
                                                  micro["labels"]), {}

    return loss_fn


def setup(args, config, device, log, record):
    from bert_pytorch_tpu_torch.data import glue
    from bert_pytorch_tpu_torch.models.bert import BertForSentenceEmbedding
    from bert_pytorch_tpu_torch.training.finetune import (
        TaskRun, accuracy_evals, bucketed_eval_batches, dataset_splits,
        epoch_steps, eval_buckets, eval_closures, finetune_optimizer,
        resolve_tokenizer, to_device)

    tokenizer = resolve_tokenizer(args, config)
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    with torch.device(device):
        model = BertForSentenceEmbedding(
            config, num_labels=len(args.labels),
            max_segments=args.packing_max_segments, dtype=compute_dtype)

    datasets = dataset_splits(args, lambda path: glue.PairClassificationDataset(
        path, tokenizer, args.labels, max_seq_len=args.max_seq_len).arrays())
    train = datasets.get("train")
    steps_per_epoch, total_steps = epoch_steps(train, args)
    sched, tx = finetune_optimizer(args, total_steps)
    buckets = eval_buckets(args.max_seq_len)
    evals = accuracy_evals(datasets, args.batch_size, buckets,
                           lambda feats: model(**feats)[1], device)
    epoch_eval, base_finalize = eval_closures(evals, record,
                                              metric="probe_accuracy")

    def finalize(results):
        out = base_finalize(results)
        # the embeddings of one eval batch: their width and unit norms
        split = next((s for s in ("test", "val", "train") if s in datasets),
                     None)
        if split is not None:
            batch, idx, _ = next(bucketed_eval_batches(
                datasets[split], args.batch_size, buckets,
                label_ignore={"labels": -1}))
            feats = {k: v for k, v in batch.items() if k != "labels"}
            with torch.no_grad():
                emb = predict.build_embed_forward(model)(
                    to_device(feats, device)).float().cpu().numpy()
            emb = emb[:len(idx)]
            out["embedding_dim"] = int(emb.shape[-1])
            out["embedding_norm_err"] = float(
                np.abs(np.linalg.norm(emb, axis=-1) - 1.0).max())
        return out

    return TaskRun(
        model=model, tx=tx, schedule=sched, seq_len=args.max_seq_len,
        batch_size=args.batch_size, total_steps=total_steps,
        epochs=args.epochs, train_arrays=train, loss_builder=_loss_builder,
        packed_loss_builder=_loss_builder, pack_labels=pack_labels,
        label_ignore={"labels": -1}, log_every=max(1, steps_per_epoch),
        init_checkpoint=args.init_checkpoint, epoch_eval=epoch_eval,
        finalize=finalize)


registry.register(registry.TaskSpec(
    name="embed",
    title="mean-pooled sentence embeddings (batch-embed/retrieval)",
    head="BertForSentenceEmbedding", output_kind="segment",
    metric="probe_accuracy",
    request_schema={"text": "str (single text)",
                    "texts": "list[str] (batch embed, <=32)"},
    parse_arguments=parse_arguments, setup=setup,
    build_serving_model=build_serving_model,
    forward_builder=predict.build_embed_forward,
    make_service=make_service))
