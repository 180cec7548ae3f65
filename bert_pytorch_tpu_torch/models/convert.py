"""Flax parameter trees -> the port's state_dicts, and serving checkpoints.

The JAX package's models keep their parameters in a flax tree; flattened
with "/" between keys it reads, for example,

    bert/embeddings/word_embeddings/embedding          (V, E)
    bert/encoder/layers/layer/attention/qkv/kernel     (L, E, 3, H, D)
    bert/encoder/layer_0/attention/qkv/kernel          (E, 3, H, D)
    bert/pooler/dense/kernel                           (E, E)
    qa_outputs/kernel                                  (E, 2)
    cls_predictions/transform/kernel                   (E, E)
    cls_predictions/bias                               (V,)
    cls_seq_relationship/kernel                        (E, 2)
    classifier/kernel                                  (E, num_labels)
                                                       or (E, 1)

in either encoder layout: stacked (`encoder/layers/layer/...`, one leaf per
weight with a leading L axis, the JAX default) or unstacked
(`encoder/layer_{i}/...`). `params_from_flax` takes such a flat dict of
numpy arrays, unstacks it with numpy where needed, and returns the
state_dict of the port's model (models/bert.py): Linear weights transposed
to PyTorch's (out, in), the QKV kernel's (3, H, D) features flattened in
that order. The sequence-classification and multiple-choice heads keep
the pooler (`bert/pooler/dense/*`) beside their `classifier`; the
sentence-embedding head has no pooler and a `classifier` probe. A
distillation run's `distill_proj/layer_<i>/<kind>/kernel` matrices (H_s,
H_t) ride beside the student's parameters as
`distill_proj.layer_<i>.<kind>.kernel`, untransposed. The map
is only transposes and reshapes, so it turns a flat JAX gradient tree
into the port's layout as well. `load_serving_params` reads a serving
checkpoint: a `.npz` of that flat tree, or a `.pt` state_dict.
`shard_state_dict` cuts a pretraining model's one-card state_dict into
one rank's model part on a mesh (parallel/rules.py).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_STACKED = "bert/encoder/layers/layer/"
_UNSTACKED = re.compile(r"^bert/encoder/layer_(\d+)/(.*)$")


def unstack_layers(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Stacked `encoder/layers/layer/X` leaves (leading L axis) ->
    `encoder/layer_{i}/X`; other keys pass through."""
    out: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        if key.startswith(_STACKED):
            rest = key[len(_STACKED):]
            for i in range(value.shape[0]):
                out[f"bert/encoder/layer_{i}/{rest}"] = value[i]
        else:
            out[key] = value
    return out


def _dense(kernel: np.ndarray) -> np.ndarray:
    """Flax kernel (in..., out...) with the input axes first -> PyTorch
    Linear weight (out, in)."""
    return np.ascontiguousarray(kernel.T)


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax params of any model of models/bert.py (the QA, token
    and sequence classification, multiple-choice, sentence-embedding and
    pretraining heads; either encoder layout) -> the port's state_dict of
    the same model, f32 tensors."""
    flat = unstack_layers({k: np.asarray(v) for k, v in flat.items()})
    sd: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        m = _UNSTACKED.match(key)
        if key.startswith("distill_proj/"):
            # distillation's student -> teacher projections, (H_s, H_t),
            # applied as s @ kernel: kept as they are (training/distill.py)
            sd[key.replace("/", ".")] = value
        elif m:
            i, rest = m.group(1), m.group(2)
            prefix = f"bert.encoder.layers.{i}."
            if rest == "attention/qkv/kernel":      # (E, 3, H, D)
                e = value.shape[0]
                sd[prefix + "attention.qkv.weight"] = _dense(
                    value.reshape(e, -1))
            elif rest == "attention/qkv/bias":      # (3, H, D)
                sd[prefix + "attention.qkv.bias"] = value.reshape(-1)
            elif rest == "attention/output/kernel":  # (H, D, E)
                sd[prefix + "attention.output.weight"] = _dense(
                    value.reshape(-1, value.shape[-1]))
            elif rest.endswith("/kernel"):
                sd[prefix + rest[:-len("/kernel")].replace("/", ".")
                   + ".weight"] = _dense(value)
            else:
                sd[prefix + rest.replace("/", ".")] = value
        elif key.endswith("/embedding"):
            sd[key[:-len("/embedding")].replace("/", ".") + ".weight"] = value
        elif key.endswith("/kernel"):
            sd[key[:-len("/kernel")].replace("/", ".") + ".weight"] = \
                _dense(value)
        else:
            sd[key.replace("/", ".")] = value
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def load_serving_params(path: str) -> Dict[str, torch.Tensor]:
    """A serving checkpoint -> the port's state_dict: `.npz` holds the
    flat flax tree (keys joined with "/"), `.pt` a PyTorch state_dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return params_from_flax({k: z[k] for k in z.files})
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in sd.items()}
    raise ValueError(f"unknown checkpoint format {path!r}: want a .npz of "
                     "the flat flax tree or a .pt state_dict")


def kfac_site_from_flax(path: str) -> str:
    """A JAX tap path (either encoder layout's leaf, the `_tap` suffix
    on) -> the port's K-FAC site, the tapped Linear's module name:
    bert/encoder/layer_3/attention/qkv_tap -> bert.encoder.layers.3.
    attention.qkv; cls_seq_relationship_tap -> cls_seq_relationship."""
    if path.endswith("_tap"):
        path = path[:-len("_tap")]
    m = _UNSTACKED.match(path + "/")
    if m:
        path = f"bert/encoder/layers/{m.group(1)}/{m.group(2)}"
    return path.rstrip("/").replace("/", ".")


def kfac_state_from_flax(flat: Dict[str, np.ndarray], count: int = 0,
                         inverses: Dict[str, np.ndarray] = None):
    """The JAX package's KFACState -> the port's (optim/kfac.KFACState):
    `flat` the factors flattened with "/" (`<tap path>/A`, `<tap path>/G`,
    stacked leaves unstacked), `inverses` the inverses the same way (None:
    identities, as a fresh state). The factor matrices need no transposes:
    a site's A indexes the Linear's input features and a trailing one,
    its G the output features in the order the port's weight rows take
    (the QKV's (3, H, D) flattened)."""
    from bert_pytorch_tpu_torch.optim.kfac import KFACState

    def tree(f):
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, value in unstack_layers(
                {k: np.asarray(v) for k, v in f.items()}).items():
            path, kind = key.rsplit("/", 1)
            out.setdefault(kfac_site_from_flax(path), {})[kind] = \
                torch.from_numpy(np.array(value, dtype=np.float32))
        return out

    factors = tree(flat)
    invs = (tree(inverses) if inverses is not None else
            {site: {k: torch.eye(t.shape[0]) for k, t in d.items()}
             for site, d in factors.items()})
    return KFACState(factors=factors, inverses=invs, count=int(count))


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh, rank: int
                     ) -> Dict[str, torch.Tensor]:
    """The model-local tensors of rank `rank` (mesh coordinates (d, f, m))
    from the one-card state_dict `sd` of a BertForPreTraining (what
    `params_from_flax` gives): model part m of M of every tensor the
    model axis splits (parallel/rules.py: the QKV heads, the attention
    output's input columns, the MLP, the word embeddings' and the MLM
    bias's vocabulary rows), every other tensor whole. The data and fsdp
    coordinates take the same tensors: fsdp slices the flat units of the
    model part (parallel/zero.py)."""
    from bert_pytorch_tpu_torch.parallel import rules

    m = mesh.coords(rank)["model"]
    return {k: rules.shard(k, v, m, mesh.model) for k, v in sd.items()}
