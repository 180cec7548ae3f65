"""Where each tensor of the pretraining model lives on the mesh (a trimmed
counterpart of bert_pytorch_tpu/parallel/rules.py).

JAX's rules table maps logical axes to mesh axes: the vocabulary over
(model, fsdp), the hidden dimension of the parameters over fsdp, the MLP
and the heads over model, everything small (LayerNorms, the position and
token-type tables, the pooler and the NSP head) replicated. `spec(name)`
gives, per parameter of the port's BertForPreTraining (PyTorch's layout:
a Linear's weight is (out, in)), the axes each dimension splits over in
that table: a tuple of one entry a dimension, each None or a tuple of
axis names. The model entries are what the port splits: `model_dim`
reads them and `shard` / `unshard` cut and join a tensor's model parts.
The fsdp entries are JAX's resting layout; the port rests fsdp in its
flat units instead (parallel/zero.py: each unit sliced over the fsdp
group, after the model split), so they are documentation here, and
`strip_axis_spec` gives the use layout JAX gathers to.

The fused QKV projection's output rows are (3, H, D): its model part is
heads [m * H / M, (m + 1) * H / M) of each of q, k and v, three strided
blocks.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch

# (pattern over the port's parameter name, spec); a name no pattern
# matches is whole on every rank (LayerNorms, the position and token-type
# tables, the pooler, the MLM transform, the NSP head)
_LAYER = r"bert\.encoder\.layers\.\d+\."
_TABLE: Tuple[Tuple[str, tuple], ...] = (
    (r"bert\.embeddings\.word_embeddings\.weight", (("model", "fsdp"), None)),
    (_LAYER + r"attention\.qkv\.weight", (("model",), ("fsdp",))),
    (_LAYER + r"attention\.qkv\.bias", (("model",),)),
    (_LAYER + r"attention\.output\.weight", (("fsdp",), ("model",))),
    (_LAYER + r"attention\.output\.bias", (("fsdp",),)),
    (_LAYER + r"intermediate\.weight", (("model",), ("fsdp",))),
    (_LAYER + r"intermediate\.bias", (("model",),)),
    (_LAYER + r"mlp_output\.weight", (("fsdp",), ("model",))),
    (_LAYER + r"mlp_output\.bias", (("fsdp",),)),
    (r"cls_predictions\.bias", (("model", "fsdp"),)),
)
_COMPILED = [(re.compile(p + r"$"), sp) for p, sp in _TABLE]


def spec(name: str, ndim: int = 1) -> tuple:
    """The table's axes of each dimension of parameter `name` (None:
    whole on every rank of the mesh; `ndim` entries of None for a
    tensor the table does not list)."""
    for pat, sp in _COMPILED:
        if pat.match(name):
            return sp
    return (None,) * ndim


def model_dim(name: str) -> Optional[int]:
    """The dimension of `name` the model axis splits, None when the
    tensor is whole on every model rank."""
    for d, axes in enumerate(spec(name)):
        if axes and "model" in axes:
            return d
    return None


def strip_axis_spec(base_spec: Optional[tuple], axis: str = "fsdp"
                    ) -> Optional[tuple]:
    """`base_spec` with every occurrence of `axis` removed: the use layout
    of a resting spec (JAX's strip_axis_spec; an entry split over `axis`
    with others keeps the others)."""
    if base_spec is None:
        return None
    return tuple(tuple(a for a in (entry or ()) if a != axis) or None
                 for entry in base_spec)


def _qkv(name: str) -> bool:
    return ".attention.qkv." in name


def _qkv_view(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(3, -1, *t.shape[1:])


def shard(name: str, t: torch.Tensor, index: int, model: int
          ) -> torch.Tensor:
    """Model part `index` of `model` of the whole tensor `t`, contiguous
    (`t` itself when it is whole on every model rank). A dimension the
    model axis does not divide raises ValueError."""
    d = model_dim(name)
    if d is None or model == 1:
        return t
    v = _qkv_view(t) if _qkv(name) else t
    dim = 1 if _qkv(name) else d
    if v.shape[dim] % model:
        raise ValueError(f"{name}: {v.shape[dim]} does not divide over the "
                         f"model axis of {model}")
    n = v.shape[dim] // model
    part = v.narrow(dim, index * n, n)
    return (part.reshape(-1, *t.shape[1:]) if _qkv(name) else part
            ).contiguous()


def unshard(name: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """The whole tensor from its model parts, in model order."""
    d = model_dim(name)
    if d is None or len(parts) == 1:
        return parts[0]
    if _qkv(name):
        return torch.cat([_qkv_view(p) for p in parts], dim=1).reshape(
            -1, *parts[0].shape[1:])
    return torch.cat(parts, dim=d)
