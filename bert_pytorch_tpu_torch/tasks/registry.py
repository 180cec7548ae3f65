"""Task registry: one declarative TaskSpec per scenario, every task
served (counterpart of bert_pytorch_tpu/tasks/registry.py).

A TaskSpec is data: the task's CLI parser and its `setup(args, config,
device, log, record) -> training.finetune.TaskRun` for the finetune loop
(`run_finetune --task <name>`, and the run_squad / run_ner aliases), and
what `run_server` needs to serve it on `POST /v1/<name>`: the model head,
the engine's forward, the HTTP service and the batcher's demux kind. The
port registers the JAX package's five tasks: squad, ner, classify,
choice and embed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Tuple

_REGISTRY: Dict[str, "TaskSpec"] = {}
_LOADED = False


@dataclass(frozen=True)
class TaskSpec:
    """One registered scenario.

    finetuning: `parse_arguments(argv) -> args` (the JAX entry point's
    flags), `setup(args, config, device, log, record) -> TaskRun`.

    serving: `build_serving_model(config, dtype, opts, device)` the head
    on `device` (`opts`: run_server's per-task options, such as labels,
    class_names, embed_labels, max_segments); `forward_builder(model)`
    the forward the engine runs per bucket (tasks/predict.py);
    `make_service(scheduler, featurize, opts)` the HTTP handler
    (featurize: the server's serving/frontend.Featurizer); `output_kind`
    the batcher's demux: "token" heads slice `[row, offset:offset+len]`,
    "segment" heads index `[row, segment]` of one pooled output a packed
    segment; `request_schema` the POST body (served on /healthz).

    bookkeeping: `head`, the models/bert.py class; `metric`, the
    headline eval metric."""

    name: str
    title: str
    head: str
    output_kind: str                     # "token" | "segment"
    metric: str
    request_schema: Mapping[str, str]
    parse_arguments: Callable[..., Any]
    setup: Callable[..., Any]
    build_serving_model: Callable[..., Any]
    forward_builder: Callable[[Any], Callable]
    make_service: Callable[..., Callable]


def register(spec: TaskSpec) -> TaskSpec:
    if spec.output_kind not in ("token", "segment"):
        raise ValueError(f"task '{spec.name}': output_kind "
                         f"{spec.output_kind!r} not in ('token', 'segment')")
    if spec.name in _REGISTRY:
        raise ValueError(f"task '{spec.name}' already registered")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    """Import the built-in task modules (each registers itself on
    import); marked loaded only after every import succeeded, so a failed
    import stays loud on every later call."""
    global _LOADED
    if _LOADED:
        return
    from bert_pytorch_tpu_torch.tasks import (choice, classify,  # noqa: F401
                                              embed, ner_task, squad_task)
    _LOADED = True


def get(name: str) -> TaskSpec:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown task {name!r}; registered: "
                       f"{', '.join(all_tasks())}") from None


def all_tasks() -> Tuple[str, ...]:
    """Sorted names of every registered task."""
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def specs() -> Tuple[TaskSpec, ...]:
    """Every registered TaskSpec, in `all_tasks()` order."""
    _ensure_loaded()
    return tuple(_REGISTRY[n] for n in all_tasks())
