"""PyTorch/CUDA port of bert_pytorch_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports torch, never jax, flax
or anything of bert_pytorch_tpu, and keeps its own copies of the modules it
needs. Module names mirror the JAX package's. Entry points run on CUDA
unless the caller passes device="cpu"; on a CUDA tensor every ported TPU
kernel runs as a hand-written Hopper kernel (ops/kernels), on a CPU tensor
as its plain PyTorch version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

# The ROADMAP items an option or a data format the port lacks names when
# it is refused: what the pretraining and the finetuning slices left out.
PRETRAIN_GAPS = "ROADMAP.md, queue A: what the pretraining slice left out"
FINETUNE_GAPS = "ROADMAP.md, queue A: what the finetuning slice left out"


def refuse(args, refused: Dict[str, Tuple], gaps: str) -> None:
    """Refuse what the port does not implement rather than ignore it:
    raise on a key of `refused` whose value in `args` switches its
    feature on (its tuple lists the values that leave it off), naming the
    ROADMAP item `gaps`."""
    for key, off in refused.items():
        if hasattr(args, key) and getattr(args, key) not in off:
            raise NotImplementedError(
                f"{key}={getattr(args, key)!r} is not ported yet (see "
                f"{gaps})")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` names the
    CPU. Raises when CUDA is asked for (or left as the default) and no
    card is visible: the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
