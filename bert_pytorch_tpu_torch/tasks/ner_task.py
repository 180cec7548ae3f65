"""`ner` task: CoNLL named-entity recognition (counterpart of
bert_pytorch_tpu/tasks/ner_task.py).

The run_ner entry point's task-shaped half: the JAX CLI,
BertForTokenClassification with len(labels) + 1 classes, FusedAdam
without bias correction (weight decay 0.01 except biases and
LayerNorms), a per-epoch decay lr / (1 + 0.05 epoch), a global-norm clip
at --clip_grad (5.0), and the loss and macro F1 on the val split every
epoch and on the test split at the end, over length-bucketed batches.
The val and test loss and macro F1 go to the run's jsonl as JAX's `val`
(at the epoch's last step) and `test` (at the last step) records.
Packed training (--packing) places each example's token labels at its
segment's offset (IGNORE elsewhere) and reduces the loss segment first
(`losses.packed_token_loss`); its steps are the packed stream's. The
loop is training/finetune.run_task.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from bert_pytorch_tpu_torch.tasks import predict, registry
from bert_pytorch_tpu_torch.training.finetune import (COMMON_REFUSED,
                                                      COMMON_TUNING)

# The JAX flags the port declares but whose feature it lacks (see
# squad_task): the common ones.
_REFUSED = dict(COMMON_REFUSED)
_TUNING = dict(COMMON_TUNING)


def pack_labels(arrays, placements, n_rows, seq_len, max_segments):
    """Token labels at each segment's packing offset, IGNORE elsewhere."""
    from bert_pytorch_tpu_torch.data.ner import IGNORE_LABEL

    labels = np.full((n_rows, seq_len), IGNORE_LABEL, np.int32)
    for p in placements:
        ln, off = p.lengths[0], p.offsets[0]
        labels[p.row, off:off + ln] = arrays["labels"][p.unit, :ln]
    return {"labels": labels}


def build_parser():
    import argparse

    from bert_pytorch_tpu_torch.training.finetune import (
        add_common_finetune_flags)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--train_file", type=str, required=True)
    p.add_argument("--val_file", default=None, type=str)
    p.add_argument("--test_file", default=None, type=str)
    p.add_argument("--labels", type=str, nargs="+", required=True)
    p.add_argument("--model_config_file", type=str, required=True)
    p.add_argument("--model_checkpoint", type=str, default=None,
                   help="a port checkpoint directory <dir>[@step]")
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--uppercase", action="store_true", default=False)
    p.add_argument("--tokenizer", type=str, default=None,
                   choices=["wordpiece", "bpe"],
                   help="tokenizer family of the vocab (default: the "
                        "model config's `tokenizer`, else wordpiece); bpe "
                        "reads a .json vocab and the merges.txt beside it")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument("--clip_grad", type=float, default=5.0)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_seq_len", type=int, default=128)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", type=str, default="results/ner")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    add_common_finetune_flags(p)
    return p


def parse_arguments(argv=None):
    from bert_pytorch_tpu_torch import FINETUNE_GAPS, refuse

    args = build_parser().parse_args(argv)
    refuse(args, _REFUSED, FINETUNE_GAPS)
    return args


def _loss_builder(model):
    """The token-classification loss; a microbatch may carry `head_keep`,
    the head's dropout mask given as an input."""
    from torch.func import functional_call

    from bert_pytorch_tpu_torch.data.ner import IGNORE_LABEL
    from bert_pytorch_tpu_torch.models import losses

    def loss_fn(params, micro, seeds):
        logits = functional_call(
            model, params, (micro["input_ids"],),
            {"attention_mask": micro["attention_mask"],
             "dropout_seeds": seeds, "head_keep": micro.get("head_keep")})
        return losses.token_classification_loss(
            logits, micro["labels"], ignore_index=IGNORE_LABEL), {}

    return loss_fn


def _packed_loss_builder(max_segments: int):
    """The token loss of packed microbatches, reduced segment first."""

    def loss_builder(model):
        from torch.func import functional_call

        from bert_pytorch_tpu_torch.data.ner import IGNORE_LABEL
        from bert_pytorch_tpu_torch.models import losses

        def loss_fn(params, micro, seeds):
            logits = functional_call(
                model, params, (micro["input_ids"],),
                {"attention_mask": micro["attention_mask"],
                 "position_ids": micro["position_ids"],
                 "segment_ids": micro["segment_ids"],
                 "dropout_seeds": seeds,
                 "head_keep": micro.get("head_keep")})
            return losses.packed_token_loss(
                logits, micro["labels"], micro["segment_ids"], max_segments,
                ignore_index=IGNORE_LABEL), {}

        return loss_fn

    return loss_builder


def setup(args, config, device, log, record):
    from bert_pytorch_tpu_torch.data import ner
    from bert_pytorch_tpu_torch.data.tokenization import TOKENIZERS
    from bert_pytorch_tpu_torch.models.bert import BertForTokenClassification
    from bert_pytorch_tpu_torch.training.finetune import (
        TaskRun, bucketed_eval_batches, epoch_steps, eval_buckets,
        finetune_adam, to_device)

    vocab_file = args.vocab_file or config.vocab_file
    if not vocab_file:
        raise SystemExit("vocab_file required (CLI or model config)")
    # --tokenizer, else the model config's family (JAX ner_task's rule;
    # under a BPE vocab [CLS] and [SEP] take [UNK]'s id, as there)
    tokenizer = TOKENIZERS[args.tokenizer or config.tokenizer](
        vocab_file, uppercase=args.uppercase)
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    with torch.device(device):
        model = BertForTokenClassification(
            config, num_labels=len(args.labels) + 1, dtype=compute_dtype)

    datasets = {}
    for split, path in (("train", args.train_file), ("val", args.val_file),
                        ("test", args.test_file)):
        if path:
            datasets[split] = ner.NERDataset(
                path, tokenizer, args.labels,
                max_seq_len=args.max_seq_len).arrays()
    train_arrays = datasets["train"]
    steps_per_epoch, total_steps = epoch_steps(train_arrays, args)

    def schedule(step):
        # per-epoch decay, the reference's LambdaLR
        return args.lr / (1.0 + 0.05 * (step // steps_per_epoch))

    tx = finetune_adam(schedule, args.clip_grad)
    forward = predict.build_ner_forward(model)
    buckets = eval_buckets(args.max_seq_len)

    def run_eval(split):
        arrays = datasets[split]
        loss_sum, loss_w = 0.0, 0.0
        logits_, labels_ = [], []
        with torch.no_grad():
            for batch, idx, bucket in bucketed_eval_batches(
                    arrays, args.batch_size, buckets,
                    label_ignore={"labels": ner.IGNORE_LABEL}):
                feats = {k: v for k, v in batch.items() if k != "labels"}
                logits = forward(to_device(feats, device)).cpu().numpy()
                keep = len(idx)
                # the masked-mean CE on the host, from the logits
                lg = logits[:keep].astype(np.float32)
                lb = batch["labels"][:keep]
                valid = lb != ner.IGNORE_LABEL
                shifted = lg - lg.max(axis=-1, keepdims=True)
                logp = shifted - np.log(np.exp(shifted).sum(-1,
                                                            keepdims=True))
                nll = -np.take_along_axis(
                    logp, np.where(valid, lb, 0)[..., None], axis=-1)[..., 0]
                loss = float((nll * valid).sum() / max(int(valid.sum()), 1))
                loss_sum += loss * keep
                loss_w += keep
                # the trimmed logits back to the full length
                full = np.zeros((keep, arrays["input_ids"].shape[1],
                                 logits.shape[-1]), logits.dtype)
                full[:, :bucket] = logits[:keep]
                logits_.append(full)
                labels_.append(arrays["labels"][idx])
        all_logits = np.concatenate(logits_)
        all_labels = np.concatenate(labels_)
        return (loss_sum / max(loss_w, 1.0),
                ner.macro_f1(all_logits, all_labels),
                ner.classification_diagnostics(all_logits, all_labels,
                                               label_names=args.labels))

    def epoch_eval(epoch):
        vloss, vf1, vdiag = run_eval("val")
        # JAX's records: the val record at the epoch's last step
        record("val", (epoch + 1) * steps_per_epoch, epoch=epoch,
               loss=vloss, macro_f1=vf1)
        log("val diagnostics: " + json.dumps(vdiag))
        return {"val_f1": vf1}

    def finalize(results):
        out: Dict[str, Any] = {}
        if "test" in datasets:
            tloss, tf1, tdiag = run_eval("test")
            record("test", total_steps, loss=tloss, macro_f1=tf1)
            log("test diagnostics: " + json.dumps(tdiag))
            out["test_f1"] = tf1
            out["test_diagnostics"] = tdiag
        return out

    return TaskRun(
        model=model, tx=tx, schedule=schedule, seq_len=args.max_seq_len,
        batch_size=args.batch_size, total_steps=total_steps,
        epochs=args.epochs, train_arrays=train_arrays,
        loss_builder=_loss_builder,
        packed_loss_builder=_packed_loss_builder(args.packing_max_segments),
        pack_labels=pack_labels, label_ignore={"labels": -100},
        log_every=max(1, steps_per_epoch), log_epoch_metrics=True,
        init_checkpoint=args.model_checkpoint,
        epoch_eval=epoch_eval if "val" in datasets else None,
        finalize=finalize)


def build_serving_model(config, dtype, opts: Dict[str, Any], device):
    from bert_pytorch_tpu_torch.models.bert import BertForTokenClassification

    with torch.device(device):
        return BertForTokenClassification(
            config, num_labels=len(opts.get("labels") or []) + 1,
            dtype=dtype)


def make_service(scheduler, featurize, opts: Dict[str, Any]):
    from bert_pytorch_tpu_torch.serving.frontend import NerService

    # label ids start at 1: 0 is the padding class
    id_to_label = dict(enumerate(opts.get("labels") or [], start=1))
    return NerService(scheduler, featurize, id_to_label)


registry.register(registry.TaskSpec(
    name="ner", title="CoNLL named-entity recognition",
    head="BertForTokenClassification", output_kind="token",
    metric="macro_f1",
    request_schema={"tokens": "list[str] (pre-split words)",
                    "text": "str (whitespace-split alternative)"},
    parse_arguments=parse_arguments, setup=setup,
    build_serving_model=build_serving_model,
    forward_builder=predict.build_ner_forward,
    make_service=make_service))
