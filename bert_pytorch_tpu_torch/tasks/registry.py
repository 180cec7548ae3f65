"""Task registry: one declarative TaskSpec per finetuning scenario
(counterpart of bert_pytorch_tpu/tasks/registry.py, trimmed to the
fields the port's finetune loop reads).

A TaskSpec is data: the task's CLI parser and its `setup(args, config,
device, log) -> training.finetune.TaskRun`. `run_finetune --task <name>`
(and the run_squad / run_ner aliases) look the task up here. The port
registers squad and ner; classify, choice and embed, and the serving
fields of the JAX TaskSpec, are ROADMAP queue A item 2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

_REGISTRY: Dict[str, "TaskSpec"] = {}
_LOADED = False


@dataclass(frozen=True)
class TaskSpec:
    """One registered scenario: `parse_arguments(argv) -> args` (the JAX
    entry point's flags), `setup(args, config, device, log) -> TaskRun`,
    and for `--list_tasks` its title, head (the models/bert.py class) and
    headline eval metric."""

    name: str
    title: str
    head: str
    metric: str
    parse_arguments: Callable[..., Any]
    setup: Callable[..., Any]


def register(spec: TaskSpec) -> TaskSpec:
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
    from bert_pytorch_tpu_torch.tasks import ner_task, squad_task  # noqa: F401
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
