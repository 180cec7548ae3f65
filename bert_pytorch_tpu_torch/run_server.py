"""Inference server entry point of the port: task checkpoints -> HTTP.

    python -m bert_pytorch_tpu_torch.run_server \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --vocab_file vocab.txt --task_checkpoint squad=qa_params.pt \\
        --task_checkpoint ner=results/ner/ckpt --labels O B-PER ... \\
        --task_checkpoint classify=results/classify/ckpt --port 8000

Serves one `POST /v1/<task>` for each task named by `--task_checkpoint`
(any registered task: squad, ner, classify, choice, embed; their request
bodies are the registry's `request_schema`, listed on `GET /healthz`;
`--squad_checkpoint` / `--ner_checkpoint` are aliases), with the JAX
server's defaults: buckets 64/128/256/512, 8 rows per batch, up to 8
packed requests per row, bf16. Runs on CUDA unless `--device cpu`, one
CUDA graph per (task, bucket) (serving/engine.py). A checkpoint is a
`.npz` of the flat flax param tree, a `.pt` state_dict, or a finetune
run's checkpoint directory `<output_dir>/ckpt[@step]` (pretrain ->
finetune -> serve), read by models/convert.py or training/checkpoint.py.
NER needs `--labels`; `--class_names` and `--embed_labels` size the
classify and embed heads (`--num_choices` is accepted, as the JAX server
takes it, and ignored). `--port 0` binds an ephemeral port; `--port_file`
receives the bound port once every (task, bucket) is built.

`--serve_dtype`: bfloat16 holds a bf16 copy of every Linear weight and
embedding table, cast once at load (LayerNorm stays f32); float32 keeps
f32 weights; int8 quantizes the weights as the JAX server does
(serving/quantize.py: int8 in device memory, dequantized at use into bf16)
and refuses to serve a task whose decode against its f32 forward moves by
more than `--int8_max_delta`. GET /metrics (the `bert_serve_*` families),
GET /v1/traces and the X-Trace-Id header (`--request_tracing`, the
`--trace_ring_*` flags), the cost gauges (`--cost_per_device_hour`, else
the BERT_COST_PER_DEVICE_HOUR environment variable, else 1.0) and
/healthz share the port. SIGTERM or SIGINT drains: admission stops (503 +
Retry-After), admitted requests get `--drain_timeout` seconds to finish,
and the process exits 0.

The SLO plane (`--slo_config`, telemetry/slo.py): a burn-rate engine over
the scheduler's families, evaluated every `--slo_eval_interval_s`, served
as GET /v1/alerts and GET /v1/slo and folded into /healthz's `status`
(ok | degraded | failing). `--prober on` runs the canary prober
(serving/prober.py) against the bound port every `--probe_interval_s`;
its failing tasks page through the SLO engine and its block rides
/healthz. `--slo_inject {error_burst,latency_burst,corrupt_answers}`
installs the fault injector on the engine's forward after warmup (the
CUDA graphs are untouched), armed `--slo_inject_after_s` later or by
`handle.injector.force()`. `--output_dir` writes `serve_log.txt`,
`serve_log.jsonl` (a provenance header first: the commit, torch, CUDA,
the card and its power limit) and `serve_log_metrics.csv` (a `serve`
record of the scheduler's counts when the server closes). The JAX
server's flags for replicas, a serving mesh and `--force_cpu` are
accepted and refused by name unless they leave their feature off
(`_REFUSED`). On a card, featurization (tokenizing the requests) runs in
FEATURIZE_WORKERS processes of its own (serving/frontend.Featurizer).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Callable, Dict

# The JAX server's flags whose feature the port does not serve yet: key ->
# the values that leave it off. Each is refused unless it holds one of them.
_REFUSED = {
    "serve_replicas": (1,),
    "serve_mesh": (None, ""),
    "force_cpu": (False,),
}
# Flags that only tune a feature refused above: accepted with any value.
_TUNING: Dict[str, str] = {}
_HINTS = {"force_cpu": "pass --device cpu to serve on the CPU"}
# Featurization's worker processes on a card: tokenizing then runs off the
# interpreter lock that the scheduler, the HTTP threads and the decoders
# share. On the CPU the forward itself needs the cores, and it runs in the
# handler threads.
FEATURIZE_WORKERS = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_config_file", required=True, type=str)
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--task_checkpoint", action="append", default=None,
                   metavar="TASK=FILE",
                   help="serve a registered task from a .npz (flat flax "
                        "tree), a .pt (state_dict) or a finetune checkpoint "
                        "directory <output_dir>/ckpt[@step]; repeatable")
    p.add_argument("--squad_checkpoint", default=None, type=str,
                   help="alias of --task_checkpoint squad=FILE")
    p.add_argument("--ner_checkpoint", default=None, type=str,
                   help="alias of --task_checkpoint ner=FILE (requires "
                        "--labels)")
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
                   choices=["bfloat16", "float32", "int8"],
                   help="bfloat16: a bf16 copy of the weights cast once at "
                        "load; float32: f32 weights and compute; int8: "
                        "int8 weights (serving/quantize.py) dequantized at "
                        "use, bf16 compute, behind --int8_max_delta")
    p.add_argument("--int8_max_delta", type=float, default=0.1,
                   help="int8 accuracy gate: max relative decode delta vs "
                        "the f32 forward, per task")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--queue_size", type=int, default=128,
                   help="admission queue bound; a full queue sheds with 503")
    p.add_argument("--admission_timeout", type=float, default=10.0,
                   help="seconds a request may wait before 504")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="graceful drain on SIGTERM/SIGINT: admission stops "
                        "(503 + Retry-After), admitted requests get this "
                        "many seconds to finish, then exit 0")
    p.add_argument("--batch_wait_ms", type=float, default=2.0,
                   help="coalescing window before running a batch")
    p.add_argument("--request_tracing", type=str, default="on",
                   choices=["on", "off"],
                   help="per-request span timelines (X-Trace-Id header + "
                        "GET /v1/traces); host-side only")
    p.add_argument("--trace_ring_slowest", type=int, default=32,
                   help="trace ring: keep the N slowest traces per window")
    p.add_argument("--trace_ring_sample_every", type=int, default=16,
                   help="trace ring: also keep every K-th trace")
    p.add_argument("--trace_ring_window_s", type=float, default=60.0,
                   help="trace ring: window rotation period (seconds)")
    p.add_argument("--cost_per_device_hour", type=float, default=None,
                   help="price per device-hour of the cost gauges "
                        "(default: BERT_COST_PER_DEVICE_HOUR or 1.0)")
    p.add_argument("--doc_stride", type=int, default=128)
    p.add_argument("--max_query_length", type=int, default=64)
    p.add_argument("--n_best_size", type=int, default=20)
    p.add_argument("--max_answer_length", type=int, default=30)
    p.add_argument("--vocab_pad_multiple", type=int, default=8,
                   help="pad the vocab like the training entry points: "
                        "checkpoints carry the padded table")
    p.add_argument("--slo_config", type=str, default=None,
                   help="SLO specs (e.g. configs/slo.json): burn-rate "
                        "alerts on GET /v1/alerts and GET /v1/slo, and "
                        "/healthz status ok|degraded|failing")
    p.add_argument("--slo_eval_interval_s", type=float, default=1.0,
                   help="seconds between SLO evaluations")
    p.add_argument("--prober", type=str, default="off",
                   choices=["on", "off"],
                   help="canary prober: known-answer requests through "
                        "the live frontend, pinned and verified per task")
    p.add_argument("--probe_interval_s", type=float, default=5.0)
    p.add_argument("--probe_timeout_s", type=float, default=30.0)
    p.add_argument("--slo_inject", type=str, default=None,
                   choices=["error_burst", "latency_burst",
                            "corrupt_answers"],
                   help="chaos drill: a host-side fault on the engine's "
                        "forward, armed --slo_inject_after_s after warmup")
    p.add_argument("--slo_inject_after_s", type=float, default=2.0)
    p.add_argument("--slo_inject_task", type=str, default=None,
                   help="corrupt_answers' task (default: every task)")
    p.add_argument("--slo_inject_latency_ms", type=float, default=400.0)
    p.add_argument("--output_dir", type=str, default=None,
                   help="write serve_log.txt / .jsonl / _metrics.csv here")
    # the JAX server's flags of features not ported yet (_REFUSED)
    p.add_argument("--serve_replicas", type=int, default=1)
    p.add_argument("--serve_mesh", type=str, default=None)
    p.add_argument("--force_cpu", action="store_true")
    return p


def parse_arguments(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def refuse_unported(args) -> None:
    """Raise on a `_REFUSED` flag that switches its feature on."""
    from bert_pytorch_tpu_torch import SERVE_GAPS, refuse

    refuse(args, _REFUSED, SERVE_GAPS, hints=_HINTS)


def task_checkpoints(args) -> Dict[str, str]:
    """{task: checkpoint} of --task_checkpoint and the
    --squad_checkpoint / --ner_checkpoint aliases; an unknown task raises
    with the registered names."""
    from bert_pytorch_tpu_torch.tasks import registry

    out = {}
    for entry in args.task_checkpoint or []:
        task, sep, path = entry.partition("=")
        if not sep or not task or not path:
            raise SystemExit(f"--task_checkpoint wants TASK=FILE, got "
                             f"{entry!r}")
        out[task] = path
    if args.squad_checkpoint:
        out.setdefault("squad", args.squad_checkpoint)
    if args.ner_checkpoint:
        out.setdefault("ner", args.ner_checkpoint)
    unknown = sorted(set(out) - set(registry.all_tasks()))
    if unknown:
        raise SystemExit(f"unknown task(s) {unknown}; registered: "
                         + ", ".join(registry.all_tasks()))
    if not out:
        raise SystemExit("nothing to serve: pass --task_checkpoint "
                         "TASK=FILE (tasks: "
                         + ", ".join(registry.all_tasks()) + ") or the "
                         "--squad_checkpoint / --ner_checkpoint aliases")
    if "ner" in out and not args.labels:
        raise SystemExit("serving ner requires --labels")
    return out


class ServerHandle:
    """Everything `serve()` started, closable in one call: the prober
    first (its probes would otherwise fail against a closing port), then
    the frontend (no request lands on a closing scheduler), the SLO
    evaluator, the scheduler and the log."""

    def __init__(self, frontend, scheduler, engine, models, tel,
                 int8_deltas, slo=None, prober=None, evaluator=None,
                 injector=None, featurizer=None):
        self.frontend = frontend
        self.featurizer = featurizer
        self.scheduler = scheduler
        self.engine = engine
        self.models = models
        self.tel = tel
        self.registry = tel.registry
        self.int8_deltas = int8_deltas
        self.slo = slo
        self.prober = prober
        self.evaluator = evaluator
        self.injector = injector
        self.url = frontend.url
        self.port = frontend.port
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.prober is not None:
            self.prober.close()
        self.frontend.close()
        if self.featurizer is not None:
            self.featurizer.close()
        if self.evaluator is not None:
            self.evaluator.close()
        self.scheduler.close()
        stats = self.scheduler.stats()
        self.tel.logger.log(
            "serve", sum(stats["batches"].values()),
            **{f"requests_{k}": v for k, v in
               sorted(stats["outcomes"].items())},
            **{f"batches_{k}": v for k, v in sorted(stats["batches"].items())},
            captures=self.engine.captures)
        self.tel.close()

    def drain(self, timeout: float, log: Callable[[str], None] = print
              ) -> bool:
        """The graceful drain: close the prober, stop admission (503 +
        Retry-After), give the admitted requests `timeout` seconds to
        finish, close the rest. True when every admitted request finished
        in time."""
        if self.prober is not None:
            self.prober.close()
        self.frontend.begin_drain()
        log(f"drain: admission stopped (503 + Retry-After); waiting up to "
            f"{timeout:g}s for {self.frontend.inflight} in-flight "
            "request(s)")
        drained = self.frontend.wait_idle(timeout=timeout)
        drained = self.scheduler.wait_idle(timeout=timeout) and drained
        log("drain: complete, every admitted request finished" if drained
            else f"WARNING: drain deadline ({timeout:g}s) hit with "
                 f"{self.frontend.inflight} request(s) in flight; closing")
        self.close()
        return drained


def load_task_params(path: str, log: Callable[[str], None] = print):
    """A --task_checkpoint path -> the served model's state_dict: a
    finetune checkpoint directory `<dir>[@step]` through the training
    checkpoints, a .npz or .pt file through models/convert."""
    from bert_pytorch_tpu_torch.models.convert import load_serving_params
    from bert_pytorch_tpu_torch.training.checkpoint import (
        load_params, model_params_only, parse_init_checkpoint)

    if os.path.isdir(parse_init_checkpoint(path)[0]):
        # a distillation run's projections are training-only
        return model_params_only(load_params(path, log=log)[0])
    return load_serving_params(path)


def _stacked_layout(path: str) -> bool:
    """The encoder layout the JAX serving model restores into, which
    int8 groups its scales by: stacked unless the model config says
    `stacked_params: false`."""
    import json

    with open(path, "r", encoding="utf-8") as f:
        value = json.load(f).get("stacked_params", True)
    return str(value).lower() not in ("false", "0")


def serve(args, log: Callable[[str], None] = print) -> ServerHandle:
    """Build the stack and return a live ServerHandle: the port is open and
    every (task, bucket) is built (a CUDA graph on a card) when this
    returns."""
    import torch

    from bert_pytorch_tpu_torch import resolve_device
    from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.models.bert import cast_for_serving
    from bert_pytorch_tpu_torch.serving import quantize as quant_lib
    from bert_pytorch_tpu_torch.serving.batcher import Scheduler
    from bert_pytorch_tpu_torch.serving.engine import TorchServingEngine
    from bert_pytorch_tpu_torch.serving.frontend import (Featurizer,
                                                         ServingFrontend)
    from bert_pytorch_tpu_torch.serving.request_trace import TraceRing
    from bert_pytorch_tpu_torch.tasks import registry, squad
    from bert_pytorch_tpu_torch.telemetry.provenance import (
        collect_provenance)
    from bert_pytorch_tpu_torch.telemetry.run import init_run
    from bert_pytorch_tpu_torch.training.checkpoint import strict_load_state

    refuse_unported(args)
    device = resolve_device(args.device)
    checkpoints = task_checkpoints(args)
    slo_cfg = None
    if args.slo_config:
        from bert_pytorch_tpu_torch.telemetry.slo import load_slo_config

        slo_cfg = load_slo_config(args.slo_config)
    # the serve log (--output_dir) receives every line `log` gets
    tel = init_run("serve", log_prefix=(
        os.path.join(args.output_dir, "serve_log") if args.output_dir
        else None), echo=log)
    log = tel.logger.info
    tel.log_header(**collect_provenance(device))
    config = BertConfig.from_json_file(args.model_config_file)
    config = config.replace(vocab_size=pad_vocab_size(
        config.vocab_size, args.vocab_pad_multiple))
    vocab_file = args.vocab_file or config.vocab_file
    if not vocab_file:
        raise SystemExit("vocab_file required (CLI or model config)")
    tokenizer = get_wordpiece_tokenizer(vocab_file,
                                        uppercase=not config.lowercase)
    # int8 quantizes the weights only: activations compute in bf16
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

    # the per-task options the registry's builders read
    serve_opts = {
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
    metrics = tel.registry
    params_gauge = metrics.gauge(
        "bert_serve_model_params", "parameters served per task (model "
        "size)", labels=("task",))
    probe = None
    if args.serve_dtype == "int8":
        probe = quant_lib.probe_batch(
            min(2, args.batch_rows), usable[0], config.vocab_size,
            max_segments=min(2, args.max_segments))
        stacked = _stacked_layout(args.model_config_file)
    models, forwards, output_kinds, n_params = {}, {}, {}, {}
    resident, int8_deltas = {}, {}
    for task, path in sorted(checkpoints.items()):
        spec = registry.get(task)
        state = load_task_params(path, log)
        n_params[task] = sum(int(v.numel()) for v in state.values())
        params_gauge.set(n_params[task], task=task)
        if args.serve_dtype == "int8":
            # gate each task's decode against its f32 forward before a
            # request is admitted: a broken quantization is an outage
            ref = spec.build_serving_model(config, torch.float32,
                                           serve_opts, device)
            strict_load_state(ref, state)
            qstate, stats = quant_lib.quantize_tree(
                state, config.head_dim, stacked=stacked)
            model = quant_lib.apply_int8(
                spec.build_serving_model(config, dtype, serve_opts, device),
                qstate, dtype)
            delta = quant_lib.decode_delta(
                spec.forward_builder(ref.eval()),
                spec.forward_builder(model.eval()), probe, device)
            del ref
            int8_deltas[task] = delta
            log(f"int8[{task}]: {stats['quantized_leaves']} leaves "
                f"quantized ({stats['bytes_before'] / 1e6:.1f} -> "
                f"{stats['bytes_after'] / 1e6:.1f} MB), rel_delta "
                f"{delta['rel_delta']:.4f}, argmax_agreement "
                f"{delta['argmax_agreement']:.4f}")
            if delta["rel_delta"] > args.int8_max_delta:
                raise SystemExit(
                    f"int8 accuracy gate: task {task!r} rel decode delta "
                    f"{delta['rel_delta']:.4f} exceeds --int8_max_delta "
                    f"{args.int8_max_delta:g}; refusing to serve")
        else:
            model = spec.build_serving_model(config, dtype, serve_opts,
                                             device)
            # strict: a head or layer silently left at random init is an
            # outage, not a warning
            strict_load_state(model, state)
            cast_for_serving(model, dtype)
        del state
        models[task] = model.eval()
        forwards[task] = spec.forward_builder(model)
        output_kinds[task] = spec.output_kind
        resident[task] = quant_lib.resident_bytes(model)
        log(f"serving: {task} <- {path} ({spec.head}, {n_params[task]} "
            f"params, {config.num_hidden_layers} layers, {device}, "
            f"{args.serve_dtype}, {resident[task] / 1e6:.1f} MB resident)")

    engine = TorchServingEngine(forwards, device, buckets=usable,
                                batch_rows=args.batch_rows,
                                max_segments=args.max_segments,
                                output_kinds=output_kinds)
    n = engine.warmup(log=log)
    log(f"serving: {n} (task, bucket) forward(s) built, "
        f"{engine.captures} {'CUDA graphs' if engine.graphs_on else 'eager'}"
        f" (buckets {engine.buckets}, batch_rows {engine.batch_rows}, "
        f"packing {args.packing})")
    injector = None
    if args.slo_inject:
        # after warmup: the fault wraps the host-side forward, never a
        # captured graph
        from bert_pytorch_tpu_torch.telemetry.slo import FaultInjector

        injector = FaultInjector(args.slo_inject,
                                 after_s=args.slo_inject_after_s,
                                 task=args.slo_inject_task,
                                 latency_ms=args.slo_inject_latency_ms)
        injector.install(engine)
        log(f"slo_inject: {args.slo_inject} arms "
            f"{args.slo_inject_after_s:g}s after warmup"
            + (f" (task {args.slo_inject_task})" if args.slo_inject_task
               else ""))
    tracing = args.request_tracing == "on"
    scheduler = Scheduler(
        engine, queue_size=args.queue_size,
        admission_timeout_s=args.admission_timeout,
        batch_wait_ms=args.batch_wait_ms, packing=(args.packing == "on"),
        registry=metrics, tracing=tracing,
        trace_ring=(TraceRing(keep_slowest=args.trace_ring_slowest,
                              sample_every=args.trace_ring_sample_every,
                              window_s=args.trace_ring_window_s)
                    if tracing else None),
        cost_per_device_hour=args.cost_per_device_hour).start()
    featurizer = Featurizer(tokenizer, workers=(
        FEATURIZE_WORKERS if device.type == "cuda" else 0))
    log(f"featurize: {featurizer.workers} worker process(es)"
        if featurizer.workers else "featurize: in the handler threads")
    services = {task: registry.get(task).make_service(scheduler, featurizer,
                                                      serve_opts)
                for task in sorted(checkpoints)}

    slo_engine = None
    if slo_cfg is not None:
        from bert_pytorch_tpu_torch.telemetry.slo import SLOEngine

        slo_engine = SLOEngine(slo_cfg.specs_for("serve"), slo_cfg.windows,
                               metrics, phase="serve",
                               trace_ring=scheduler.trace_ring, log=log)
        tel.attach_slo(slo_engine)
        log(f"slo: {len(slo_cfg.specs_for('serve'))} serve spec(s) from "
            f"{args.slo_config}: GET /v1/alerts, GET /v1/slo; /healthz "
            "status is the burn-rate engine's verdict")
    # the prober needs the bound port, which exists once the frontend is
    # up: /healthz reads it through this holder
    prober_holder = {}

    def healthz():
        h = tel.healthz()
        if prober_holder.get("prober") is not None:
            h["prober"] = prober_holder["prober"].status()
        h.update({
            "device": str(device),
            "tasks": {t: {"checkpoint": checkpoints[t],
                          "head": registry.get(t).head,
                          "model_params": n_params[t],
                          "resident_weight_bytes": resident[t],
                          "request_schema": dict(
                              registry.get(t).request_schema)}
                      for t in sorted(services)},
            "buckets": list(engine.buckets),
            "packing": args.packing == "on",
            "serve_dtype": args.serve_dtype,
            "cuda_graphs": engine.graphs_on,
            "captures": engine.captures,
            "queue_depth": int(metrics.gauge(
                "bert_serve_queue_depth").value()),
            "int8_deltas": {t: {k: round(float(v), 6)
                                for k, v in d.items()}
                            for t, d in sorted(int8_deltas.items())},
            "request_tracing": (
                dict(scheduler.trace_ring.stats(),
                     cost_per_device_hour=scheduler.cost_per_device_hour)
                if scheduler.trace_ring is not None else None),
            "scheduler": scheduler.stats()})
        return h

    frontend = ServingFrontend(services, metrics, healthz_fn=healthz,
                               port=args.port, host=args.host,
                               trace_ring=scheduler.trace_ring,
                               slo_engine=slo_engine)
    prober = None
    if args.prober == "on":
        from bert_pytorch_tpu_torch.serving.prober import CanaryProber

        prober = CanaryProber(frontend.url, sorted(services), metrics, log,
                              interval_s=args.probe_interval_s,
                              timeout_s=args.probe_timeout_s).start()
        prober_holder["prober"] = prober
        if slo_engine is not None:
            slo_engine.add_alert_source(prober.alerts)
        log(f"prober: probing {{{','.join(sorted(services))}}} every "
            f"{args.probe_interval_s:g}s through {frontend.url}")
    evaluator = None
    if slo_engine is not None:
        from bert_pytorch_tpu_torch.telemetry.slo import SLOEvaluator

        evaluator = SLOEvaluator(
            slo_engine, interval_s=args.slo_eval_interval_s).start()
    log(f"serving: listening on {frontend.url} ("
        + ", ".join(f"POST /v1/{t}" for t in sorted(services))
        + ", GET /metrics, GET /healthz"
        + (", GET /v1/traces" if tracing else "")
        + (", GET /v1/alerts, GET /v1/slo" if slo_engine is not None
           else "") + ")")
    return ServerHandle(frontend, scheduler, engine, models, tel,
                        int8_deltas, slo=slo_engine, prober=prober,
                        evaluator=evaluator, injector=injector,
                        featurizer=featurizer)


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
        handle.drain(args.drain_timeout)
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        handle.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
