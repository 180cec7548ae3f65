"""CoNLL NER finetuning entry point of the port.

    python -m bert_pytorch_tpu_torch.run_ner --train_file train.txt \\
        --val_file val.txt --test_file test.txt --labels O B-PER I-PER ... \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --vocab_file vocab.txt --output_dir out [--device cpu]

An alias of `run_finetune --task ner` with the JAX entry point's CLI
(tasks/ner_task.py). Runs on CUDA unless --device cpu.
"""

from __future__ import annotations

from typing import Callable


def parse_arguments(argv=None):
    from bert_pytorch_tpu_torch.tasks.ner_task import parse_arguments

    return parse_arguments(argv)


def main(argv=None, log: Callable[[str], None] = print) -> dict:
    from bert_pytorch_tpu_torch.tasks import registry
    from bert_pytorch_tpu_torch.training.finetune import run_task

    return run_task(registry.get("ner"), parse_arguments(argv), log=log)


if __name__ == "__main__":
    main()
