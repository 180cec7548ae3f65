"""Finetune entry point of the port: one loop, the registered tasks.

    python -m bert_pytorch_tpu_torch.run_finetune --task squad \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --vocab_file vocab.txt --train_file train-v1.1.json \\
        --predict_file dev-v1.1.json --do_train --do_predict --do_eval \\
        --init_checkpoint <pretraining output_dir>/pretrain_ckpts \\
        --output_dir out [--device cpu]

    python -m bert_pytorch_tpu_torch.run_finetune --task classify \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --vocab_file vocab.txt --train_file train.tsv --val_file dev.tsv \\
        --labels negative positive --output_dir out

`--task` names a task of the registry (tasks/registry.py; `--list_tasks`
prints them: choice, classify, embed, ner, squad); the rest of the CLI
is the task's own parser: the JAX entry point's flags for squad and ner
(run_squad / run_ner are aliases of this entry point), the JAX base
finetune parser's for classify, choice and embed. The loop is
training/finetune.run_task; the final state lands in
<output_dir>/ckpt/<step>/, which run_server serves. Runs on CUDA unless
--device cpu.
"""

from __future__ import annotations

import sys
from typing import Callable


def main(argv=None, log: Callable[[str], None] = print) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)

    from bert_pytorch_tpu_torch.tasks import registry

    if "--list_tasks" in argv:
        for name in registry.all_tasks():
            spec = registry.get(name)
            log(f"{name}: {spec.title} [{spec.head}, metric {spec.metric}]")
        return {}
    task = None
    for i, tok in enumerate(argv):
        if tok == "--task":
            if i + 1 >= len(argv):
                raise SystemExit("--task needs a task name")
            task = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
            break
        if tok.startswith("--task="):
            task = tok[len("--task="):]
            argv = argv[:i] + argv[i + 1:]
            break
    if not task:
        raise SystemExit("--task <name> is required; registered tasks: "
                         + ", ".join(registry.all_tasks())
                         + " (--list_tasks for details)")
    try:
        spec = registry.get(task)
    except KeyError as e:
        raise SystemExit(str(e)) from None

    from bert_pytorch_tpu_torch.training.finetune import run_task

    return run_task(spec, spec.parse_arguments(argv), log=log)


if __name__ == "__main__":
    main()
