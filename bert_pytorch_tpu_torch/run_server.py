"""Inference server entry point of the port: task checkpoints -> HTTP.

    python -m bert_pytorch_tpu_torch.run_server \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --vocab_file vocab.txt --task_checkpoint squad=qa_params.pt \\
        --task_checkpoint ner=results/ner/ckpt --labels O B-PER ... \\
        --task_checkpoint classify=results/classify/ckpt --port 8000

Serves one `POST /v1/<task>` for each task named by `--task_checkpoint`
(any registered task: squad, ner, classify, choice, embed; their request
bodies are the registry's `request_schema`, listed on `GET /healthz`),
with the JAX server's defaults: buckets 64/128/256/512, 8 rows per batch,
up to 8 packed requests per row, bf16 compute over f32 parameters. Runs
on CUDA unless `--device cpu`. A checkpoint is a `.npz` of the flat flax
param tree, a `.pt` state_dict, or a finetune run's checkpoint directory
`<output_dir>/ckpt[@step]` (pretrain -> finetune -> serve), read by
models/convert.py or training/checkpoint.py. NER needs `--labels`;
`--class_names` and `--embed_labels` size the classify and embed heads
(`--num_choices` is accepted, as the JAX server takes it, and ignored). `--port 0` binds an ephemeral port; `--port_file` receives the
bound port once every bucket has run once.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Callable, Dict


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_config_file", required=True, type=str)
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--task_checkpoint", action="append", default=None,
                   metavar="TASK=FILE",
                   help="serve a registered task from a .npz (flat flax "
                        "tree), a .pt (state_dict) or a finetune checkpoint "
                        "directory <output_dir>/ckpt[@step]; repeatable")
    p.add_argument("--labels", type=str, nargs="+", default=None,
                   help="NER label names (ids start at 1, 0 is the "
                        "padding class); required to serve ner")
    p.add_argument("--class_names", type=str, nargs="+",
                   default=["negative", "positive"],
                   help="classify's class names in label-id order (sets "
                        "the served head's width)")
    p.add_argument("--num_choices", type=int, default=4,
                   help="accepted for the JAX server's CLI and ignored: "
                        "a /v1/choice request carries its own 2..16 "
                        "choices, and the head scores each alone")
    p.add_argument("--embed_labels", type=int, default=2,
                   help="embed's probe width (must match the checkpoint; "
                        "serving returns embeddings, not probe logits)")
    p.add_argument("--port", type=int, default=8000,
                   help="HTTP port (0 = ephemeral)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port_file", type=str, default=None,
                   help="write the bound port here once warm")
    p.add_argument("--buckets", type=str, default="64,128,256,512",
                   help="comma-separated sequence-length buckets")
    p.add_argument("--batch_rows", type=int, default=8,
                   help="rows per forward batch")
    p.add_argument("--max_segments", type=int, default=8,
                   help="max packed requests per row")
    p.add_argument("--packing", type=str, default="on", choices=["on", "off"],
                   help="pack several requests per row (segment-aware "
                        "attention); off = one request per row")
    p.add_argument("--serve_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="compute dtype; parameters stay f32")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--queue_size", type=int, default=128,
                   help="admission queue bound; a full queue sheds with 503")
    p.add_argument("--admission_timeout", type=float, default=10.0,
                   help="seconds a request may wait before 504")
    p.add_argument("--batch_wait_ms", type=float, default=2.0,
                   help="coalescing window before running a batch")
    p.add_argument("--doc_stride", type=int, default=128)
    p.add_argument("--max_query_length", type=int, default=64)
    p.add_argument("--n_best_size", type=int, default=20)
    p.add_argument("--max_answer_length", type=int, default=30)
    return p.parse_args(argv)


def task_checkpoints(args) -> Dict[str, str]:
    """{task: checkpoint} of --task_checkpoint; an unknown task raises
    with the registered names."""
    from bert_pytorch_tpu_torch.tasks import registry

    out = {}
    for entry in args.task_checkpoint or []:
        task, sep, path = entry.partition("=")
        if not sep or not task or not path:
            raise SystemExit(f"--task_checkpoint wants TASK=FILE, got "
                             f"{entry!r}")
        out[task] = path
    unknown = sorted(set(out) - set(registry.all_tasks()))
    if unknown:
        raise SystemExit(f"unknown task(s) {unknown}; registered: "
                         + ", ".join(registry.all_tasks()))
    if not out:
        raise SystemExit("nothing to serve: pass --task_checkpoint "
                         "TASK=FILE (tasks: "
                         + ", ".join(registry.all_tasks()) + ")")
    if "ner" in out and not args.labels:
        raise SystemExit("serving ner requires --labels")
    return out


class ServerHandle:
    """Everything `serve()` started, closable in one call (frontend first,
    so no request lands on a closing scheduler)."""

    def __init__(self, frontend, scheduler, engine, models):
        self.frontend = frontend
        self.scheduler = scheduler
        self.engine = engine
        self.models = models
        self.url = frontend.url
        self.port = frontend.port

    def close(self) -> None:
        self.frontend.close()
        self.scheduler.close()


def load_task_params(path: str, log: Callable[[str], None] = print):
    """A --task_checkpoint path -> the served model's state_dict: a
    finetune checkpoint directory `<dir>[@step]` through the training
    checkpoints, a .npz or .pt file through models/convert."""
    import os

    from bert_pytorch_tpu_torch.models.convert import load_serving_params
    from bert_pytorch_tpu_torch.training.checkpoint import (
        load_params, parse_init_checkpoint)

    if os.path.isdir(parse_init_checkpoint(path)[0]):
        return load_params(path, log=log)[0]
    return load_serving_params(path)


def serve(args, log: Callable[[str], None] = print) -> ServerHandle:
    """Build the stack and return a live ServerHandle: the port is open and
    every (task, bucket) has run once when this returns."""
    import torch

    from bert_pytorch_tpu_torch import resolve_device
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.serving.batcher import Scheduler
    from bert_pytorch_tpu_torch.serving.engine import TorchServingEngine
    from bert_pytorch_tpu_torch.serving.frontend import ServingFrontend
    from bert_pytorch_tpu_torch.tasks import registry, squad

    device = resolve_device(args.device)
    checkpoints = task_checkpoints(args)
    config = BertConfig.from_json_file(args.model_config_file)
    # checkpoints carry the table padded to a multiple of 8, as the
    # training entry points pad it
    config = config.replace(vocab_size=pad_vocab_size(config.vocab_size, 8))
    vocab_file = args.vocab_file or config.vocab_file
    if not vocab_file:
        raise SystemExit("vocab_file required (CLI or model config)")
    tokenizer = get_wordpiece_tokenizer(vocab_file,
                                        uppercase=not config.lowercase)
    dtype = (torch.float32 if args.serve_dtype == "float32"
             else torch.bfloat16)

    buckets = sorted({int(b) for b in args.buckets.split(",") if b.strip()})
    usable = [b for b in buckets if b <= config.max_position_embeddings]
    if usable != buckets:
        log(f"WARNING: dropping buckets beyond max_position_embeddings="
            f"{config.max_position_embeddings}: "
            f"{sorted(set(buckets) - set(usable))}")
    if not usable:
        raise SystemExit("no usable bucket <= max_position_embeddings")

    # the per-task options the registry's builders read; one tokenizer
    # serves every task, so every service shares one lock
    serve_opts = {
        "tok_lock": threading.Lock(),
        "labels": args.labels,
        "class_names": args.class_names,
        "embed_labels": args.embed_labels,
        "max_segments": args.max_segments,
        "doc_stride": args.doc_stride,
        "max_query_length": args.max_query_length,
        "answer_cfg": squad.AnswerConfig(
            n_best_size=args.n_best_size,
            max_answer_length=args.max_answer_length,
            do_lower_case=config.lowercase),
    }
    models, forwards, output_kinds, n_params = {}, {}, {}, {}
    for task, path in sorted(checkpoints.items()):
        spec = registry.get(task)
        model = spec.build_serving_model(config, dtype, serve_opts, device)
        # strict: a head or layer silently left at random init is an
        # outage, not a warning
        model.load_state_dict(load_task_params(path, log), strict=True)
        models[task] = model.eval()
        forwards[task] = spec.forward_builder(model)
        output_kinds[task] = spec.output_kind
        n_params[task] = sum(p.numel() for p in model.parameters())
        log(f"serving: {task} <- {path} ({spec.head}, {n_params[task]} "
            f"params, {config.num_hidden_layers} layers, {device}, "
            f"{args.serve_dtype})")

    engine = TorchServingEngine(forwards, device, buckets=usable,
                                batch_rows=args.batch_rows,
                                max_segments=args.max_segments,
                                output_kinds=output_kinds)
    n = engine.warmup(log=log)
    log(f"serving: {n} (task, bucket) forward(s) warm (buckets "
        f"{engine.buckets}, batch_rows {engine.batch_rows}, packing "
        f"{args.packing})")
    scheduler = Scheduler(engine, queue_size=args.queue_size,
                          admission_timeout_s=args.admission_timeout,
                          batch_wait_ms=args.batch_wait_ms,
                          packing=(args.packing == "on")).start()
    services = {task: registry.get(task).make_service(scheduler, tokenizer,
                                                      serve_opts)
                for task in sorted(checkpoints)}

    def healthz():
        return {"status": "ok", "device": str(device),
                "tasks": {t: {"checkpoint": checkpoints[t],
                              "head": registry.get(t).head,
                              "model_params": n_params[t],
                              "request_schema": dict(
                                  registry.get(t).request_schema)}
                          for t in sorted(services)},
                "buckets": list(engine.buckets),
                "packing": args.packing == "on",
                "serve_dtype": args.serve_dtype,
                "scheduler": scheduler.stats()}

    frontend = ServingFrontend(services, healthz_fn=healthz, port=args.port,
                               host=args.host)
    log(f"serving: listening on {frontend.url} ("
        + ", ".join(f"POST /v1/{t}" for t in sorted(services))
        + ", GET /healthz)")
    return ServerHandle(frontend, scheduler, engine, models)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    handle = serve(args)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(handle.port))
        os.replace(tmp, args.port_file)
    stop = threading.Event()
    old = {sig: signal.signal(sig, lambda signum, frame: stop.set())
           for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        stop.wait()
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        handle.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
