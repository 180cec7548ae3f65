"""`squad` task: SQuAD v1.1/v2.0 extractive question answering
(counterpart of bert_pytorch_tpu/tasks/squad_task.py).

The run_squad entry point's task-shaped half: the JAX CLI, featurize
(cached), train with the reference recipe (FusedAdam without bias
correction, weight decay 0.01 except biases and LayerNorms, a global-norm
clip at --max_grad_norm, linear warmup over --warmup_proportion),
predict over length-bucketed eval batches (each window in the smallest of
32/64/128/.../--max_seq_length that holds it: the 384 bucket through the
flash kernels, the shorter ones through plain attention), the n-best
answers and the v1.1 / v2.0 evaluation. Packed training (--packing)
shifts each window's span by its segment's packing offset (-1 when the
answer is outside the window) and softmaxes per segment
(`losses.packed_qa_loss`): a full-row softmax would mix denominators
across co-packed windows. The loop is training/finetune.run_task.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from bert_pytorch_tpu_torch.tasks import predict, registry
from bert_pytorch_tpu_torch.training.finetune import (COMMON_REFUSED,
                                                      COMMON_TUNING)

# The JAX flags the port declares but whose feature it lacks: flag -> the
# values that leave it off (refused otherwise, naming ROADMAP queue A),
# and the flags that only tune such a feature.
_REFUSED = dict(COMMON_REFUSED)
_TUNING = dict(COMMON_TUNING)


def pack_labels(arrays, placements, n_rows, seq_len, max_segments):
    """Per-segment absolute span positions: (n_rows, G) start / end, -1 for
    an empty slot and for an answer outside its window (qa_loss's
    convention)."""
    out = {k: np.full((n_rows, max_segments), -1, np.int32)
           for k in ("start_positions", "end_positions")}
    for p in placements:
        ln, off = p.lengths[0], p.offsets[0]
        for k in ("start_positions", "end_positions"):
            pos = int(arrays[k][p.unit])
            if 0 <= pos < ln:
                out[k][p.row, p.seg0] = pos + off
    return out


def build_parser():
    import argparse

    from bert_pytorch_tpu_torch.training.finetune import (
        add_common_finetune_flags)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_file", default=None, type=str)
    p.add_argument("--bert_model", default="bert-large-uncased", type=str,
                   help="kept for CLI parity; the model comes from "
                        "--model_config_file")
    p.add_argument("--output_dir", required=False, default=None, type=str)
    p.add_argument("--train_file", default=None, type=str)
    p.add_argument("--predict_file", default=None, type=str)
    p.add_argument("--init_checkpoint", default=None, type=str,
                   help="a port checkpoint directory <dir>[@step] "
                        "(pretraining's <output_dir>/pretrain_ckpts)")
    p.add_argument("--model_config_file", default=None, type=str)
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_predict", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_lower_case", action="store_true", default=True,
                   help="kept for CLI parity; the model config's lowercase "
                        "decides")
    p.add_argument("--max_seq_length", default=384, type=int)
    p.add_argument("--doc_stride", default=128, type=int)
    p.add_argument("--max_query_length", default=64, type=int)
    p.add_argument("--train_batch_size", default=32, type=int)
    p.add_argument("--predict_batch_size", default=8, type=int)
    p.add_argument("--learning_rate", default=3e-5, type=float)
    p.add_argument("--num_train_epochs", default=2.0, type=float)
    p.add_argument("--max_steps", default=-1.0, type=float,
                   help="cap on optimizer steps (benchmarking)")
    p.add_argument("--warmup_proportion", default=0.1, type=float)
    p.add_argument("--n_best_size", default=20, type=int)
    p.add_argument("--max_answer_length", default=30, type=int)
    p.add_argument("--verbose_logging", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--version_2_with_negative", action="store_true")
    p.add_argument("--null_score_diff_threshold", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--log_prefix", type=str, default="squad_log")
    p.add_argument("--eval_script", default=None, type=str,
                   help="unused (in-process eval); kept for CLI parity")
    add_common_finetune_flags(p)
    return p


def parse_arguments(argv=None):
    """CLI > JSON run config (--config_file) > defaults; a value that
    switches on a refused feature raises."""
    from bert_pytorch_tpu_torch import FINETUNE_GAPS, refuse
    from bert_pytorch_tpu_torch.config import merge_args_with_config

    args = merge_args_with_config(build_parser(), argv)
    refuse(args, _REFUSED, FINETUNE_GAPS)
    return args


def _loss_builder(model):
    from torch.func import functional_call

    from bert_pytorch_tpu_torch.models import losses

    def loss_fn(params, micro, seeds):
        start, end = functional_call(
            model, params, (micro["input_ids"],),
            {"token_type_ids": micro["token_type_ids"],
             "attention_mask": micro["attention_mask"],
             "dropout_seeds": seeds})
        return losses.qa_loss(start, end, micro["start_positions"],
                              micro["end_positions"]), {}

    return loss_fn


def _packed_loss_builder(max_segments: int):
    """The span loss of packed microbatches, a softmax per segment."""

    def loss_builder(model):
        from torch.func import functional_call

        from bert_pytorch_tpu_torch.models import losses

        def loss_fn(params, micro, seeds):
            start, end = functional_call(
                model, params, (micro["input_ids"],),
                {"token_type_ids": micro["token_type_ids"],
                 "attention_mask": micro["attention_mask"],
                 "position_ids": micro["position_ids"],
                 "segment_ids": micro["segment_ids"],
                 "dropout_seeds": seeds})
            return losses.packed_qa_loss(
                start, end, micro["start_positions"],
                micro["end_positions"], micro["segment_ids"],
                max_segments), {}

        return loss_fn

    return loss_builder


def setup(args, config, device, log, record):
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.models.bert import BertForQuestionAnswering
    from bert_pytorch_tpu_torch.optim.schedulers import (
        linear_warmup_schedule)
    from bert_pytorch_tpu_torch.tasks import squad
    from bert_pytorch_tpu_torch.training.finetune import (
        TaskRun, bucketed_eval_batches, eval_buckets, finetune_adam,
        to_device)

    vocab_file = args.vocab_file or config.vocab_file
    if not vocab_file:
        raise SystemExit("vocab_file required (CLI or model config)")
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    with torch.device(device):
        model = BertForQuestionAnswering(config, dtype=compute_dtype)
    tokenizer = get_wordpiece_tokenizer(vocab_file,
                                        uppercase=not config.lowercase)

    train_arrays = None
    total_steps = 0
    if args.do_train:
        examples = squad.read_squad_examples(
            args.train_file, is_training=True,
            version_2_with_negative=args.version_2_with_negative)
        cache = os.path.join(
            args.output_dir,
            f"train_feats_{args.max_seq_length}_{args.doc_stride}.pkl")
        feats = squad.cached_features(cache, lambda: (
            squad.convert_examples_to_features(
                examples, tokenizer, args.max_seq_length, args.doc_stride,
                args.max_query_length, is_training=True)))
        train_arrays = squad.features_to_arrays(feats, is_training=True)
        train_arrays.pop("unique_ids", None)
        if args.packing:
            # a packed step takes a data-dependent number of windows:
            # count the packed stream's steps over num_train_epochs
            from bert_pytorch_tpu_torch.training.finetune import (
                packed_epoch_step_counts)

            total_steps = sum(packed_epoch_step_counts(
                train_arrays, n_rows=args.train_batch_size,
                seq_len=args.max_seq_length,
                max_segments=args.packing_max_segments, seed=args.seed,
                epochs=args.num_train_epochs))
        else:
            # optimizer steps an epoch: each consumes batch x accum
            # examples
            examples_per_step = (args.train_batch_size
                                 * args.gradient_accumulation_steps)
            total_steps = int(len(feats) // examples_per_step
                              * args.num_train_epochs)
        if args.max_steps > 0:
            total_steps = min(total_steps, int(args.max_steps))

    sched = linear_warmup_schedule(args.learning_rate, max(total_steps, 1),
                                   warmup=args.warmup_proportion)
    tx = finetune_adam(sched, args.max_grad_norm)

    def finalize(results):
        out: Dict[str, Any] = {}
        if not args.do_predict:
            return out
        eval_examples = squad.read_squad_examples(
            args.predict_file, is_training=False,
            version_2_with_negative=args.version_2_with_negative)
        eval_feats = squad.convert_examples_to_features(
            eval_examples, tokenizer, args.max_seq_length, args.doc_stride,
            args.max_query_length, is_training=False)
        eval_arrays = squad.features_to_arrays(eval_feats, is_training=False)
        uids_all = eval_arrays.pop("unique_ids")
        forward = predict.build_qa_forward(model)
        raw_results = []
        t0 = time.perf_counter()
        with torch.no_grad():
            for batch, idx, _bucket in bucketed_eval_batches(
                    eval_arrays, args.predict_batch_size,
                    eval_buckets(args.max_seq_length)):
                start, end = forward(to_device(batch, device))
                raw_results.extend(predict.qa_raw_results(
                    uids_all[idx], start.cpu().numpy(), end.cpu().numpy(),
                    len(idx)))
        infer_time = time.perf_counter() - t0
        out["e2e_inference_time"] = infer_time
        out["inference_sequences_per_second"] = (
            len(eval_feats) / max(infer_time, 1e-9))

        answers, nbest = squad.get_answers(
            eval_examples, eval_feats, raw_results, squad.AnswerConfig(
                n_best_size=args.n_best_size,
                max_answer_length=args.max_answer_length,
                do_lower_case=config.lowercase,
                version_2_with_negative=args.version_2_with_negative,
                null_score_diff_threshold=args.null_score_diff_threshold,
                verbose_logging=args.verbose_logging))
        pred_file = os.path.join(args.output_dir, "predictions.json")
        with open(pred_file, "w", encoding="utf-8") as f:
            json.dump(answers, f, indent=2)
        with open(os.path.join(args.output_dir, "nbest_predictions.json"),
                  "w", encoding="utf-8") as f:
            json.dump(nbest, f, indent=2)
        if args.do_eval:
            eval_fn = (squad.evaluate_v2 if args.version_2_with_negative
                       else squad.evaluate_v1)
            out.update(eval_fn(args.predict_file, answers))
        log(f"predict: wrote {pred_file}")
        return out

    return TaskRun(
        model=model, tx=tx, schedule=sched, seq_len=args.max_seq_length,
        batch_size=args.train_batch_size,
        accum_steps=args.gradient_accumulation_steps,
        total_steps=total_steps, epochs=None, train_arrays=train_arrays,
        loss_builder=_loss_builder,
        packed_loss_builder=_packed_loss_builder(args.packing_max_segments),
        pack_labels=pack_labels,
        label_ignore={"start_positions": -1, "end_positions": -1},
        log_every=50, init_checkpoint=args.init_checkpoint,
        finalize=finalize)


def build_serving_model(config, dtype, opts: Dict[str, Any], device):
    from bert_pytorch_tpu_torch.models.bert import BertForQuestionAnswering

    with torch.device(device):
        return BertForQuestionAnswering(config, dtype=dtype)


def make_service(scheduler, featurize, opts: Dict[str, Any]):
    from bert_pytorch_tpu_torch.serving.frontend import SquadService
    from bert_pytorch_tpu_torch.tasks import squad

    return SquadService(
        scheduler, featurize,
        answer_cfg=opts.get("answer_cfg") or squad.AnswerConfig(),
        doc_stride=int(opts.get("doc_stride", 128)),
        max_query_length=int(opts.get("max_query_length", 64)))


registry.register(registry.TaskSpec(
    name="squad", title="SQuAD v1.1/v2.0 extractive question answering",
    head="BertForQuestionAnswering", output_kind="token", metric="f1",
    request_schema={"question": "str (required)",
                    "context": "str (required)"},
    parse_arguments=parse_arguments, setup=setup,
    build_serving_model=build_serving_model,
    forward_builder=predict.build_qa_forward, make_service=make_service))
