"""Pretrained-weight import: a Google TF BERT release and the reference's
torch checkpoints (`ckpt_*.pt`) -> the flat flax parameter tree
(counterpart of bert_pytorch_tpu/models/pretrained.py; pure numpy).

The converters produce the JAX package's tree, flattened with "/"
between keys (models/convert.py shows its names), so one mapping,
`models/convert.params_from_flax`, carries every source onto the port's
parameter names:

- the reference's torch names become TF's (`convert_torch_to_flax`):
  `encoder.layer.{i}` -> `encoder/layer_{i}`, Linear (out, in) -> kernel
  (in, out), LayerNorm weight/bias -> gamma/beta; the tied MLM decoder
  weight is dropped (the model ties it to the word embedding);
- TF's names become the flax tree (`convert_tf_to_flax`): the three
  (E, E) q/k/v kernels reshaped head-major to (E, H, Dh) and stacked on
  the fusion axis -> (E, 3, H, Dh); the attention output kernel (H, Dh,
  E); in either encoder layout (per-layer `layer_{i}` or scan-stacked
  `layers/layer` with a leading layer axis);
- the vocabulary is padded to the config's: embedding rows with 0, the
  MLM bias with PADDED_VOCAB_BIAS, so a padded token never wins.

Reading a TF checkpoint file imports tensorflow (and raises naming it
when it is missing); nothing else here needs more than numpy and torch.
A registry name or a URL needs the network and is refused.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np

from bert_pytorch_tpu_torch.config import BertConfig, pad_vocab_size

# the Google releases' registry names (the JAX package's
# PRETRAINED_ARCHIVE_MAP); each needs a download
RELEASE_NAMES = ("bert-base-uncased", "bert-large-uncased",
                 "bert-base-cased", "bert-large-cased")

PADDED_VOCAB_BIAS = -10000.0  # MLM bias of padded vocab rows

# TF optimizer slots and bookkeeping that are never model weights
_SKIP_SUFFIXES = ("adam_m", "adam_v", "global_step",
                  "AdamWeightDecayOptimizer", "AdamWeightDecayOptimizer_1")

# the ROADMAP item a source that needs the network names
NETWORK_GAPS = ("ROADMAP.md, queue A: --init_checkpoint from a registry "
                "name or a URL")

_ENCODER_LEAVES = (
    "attention/qkv/kernel", "attention/qkv/bias",
    "attention/output/kernel", "attention/output/bias",
    "attention_layer_norm/scale", "attention_layer_norm/bias",
    "intermediate/kernel", "intermediate/bias",
    "mlp_output/kernel", "mlp_output/bias",
    "output_layer_norm/scale", "output_layer_norm/bias")


def load_tf_weights(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint as numpy, optimizer slots
    skipped. Raises ImportError naming tensorflow when it is missing."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "reading a TF checkpoint needs the tensorflow package, which is "
            "not installed") from e
    reader = tf.train.load_checkpoint(ckpt_path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if any(name.split("/")[-1].startswith(s) or s in name
               for s in _SKIP_SUFFIXES):
            continue
        out[name] = np.asarray(reader.get_tensor(name))
    return out


def _pad_vocab(arr: np.ndarray, target: int, fill: float) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    if arr.shape[0] > target:
        raise ValueError(
            f"checkpoint vocab {arr.shape[0]} exceeds target {target}; "
            "pad the model config's vocab_size instead of shrinking weights")
    pad_shape = (target - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


def convert_tf_to_flax(tf_vars: Dict[str, np.ndarray], config: BertConfig,
                       stacked: bool = False) -> Dict[str, np.ndarray]:
    """Google-BERT TF variables -> the flat flax tree of BertForPreTraining
    ("/"-joined keys), per-layer or (`stacked`) scan-stacked encoder.
    config.vocab_size may exceed the checkpoint's (the rows are padded);
    the depth and the hidden geometry must match it. The pretraining
    heads and the pooler are taken where the checkpoint has them (a
    finetune save has none) and left out otherwise."""
    E, H, L = (config.hidden_size, config.num_attention_heads,
               config.num_hidden_layers)
    Dh, V = config.head_dim, config.vocab_size

    def get(name: str) -> np.ndarray:
        if name not in tf_vars:
            raise KeyError(
                f"TF checkpoint is missing variable '{name}' — not a "
                "Google-BERT checkpoint for this architecture?")
        return np.asarray(tf_vars[name], np.float32)

    out = {
        "bert/embeddings/word_embeddings/embedding": _pad_vocab(
            get("bert/embeddings/word_embeddings"), V, 0.0),
        "bert/embeddings/position_embeddings/embedding": get(
            "bert/embeddings/position_embeddings")[
                :config.max_position_embeddings],
        "bert/embeddings/layer_norm/scale": get(
            "bert/embeddings/LayerNorm/gamma"),
        "bert/embeddings/layer_norm/bias": get(
            "bert/embeddings/LayerNorm/beta"),
    }
    if config.next_sentence:
        out["bert/embeddings/token_type_embeddings/embedding"] = get(
            "bert/embeddings/token_type_embeddings")
    layers = []
    for i in range(L):
        p = f"bert/encoder/layer_{i}"
        layers.append({
            "attention/qkv/kernel": np.stack(
                [get(f"{p}/attention/self/{n}/kernel").reshape(E, H, Dh)
                 for n in ("query", "key", "value")], axis=1),
            "attention/qkv/bias": np.stack(
                [get(f"{p}/attention/self/{n}/bias").reshape(H, Dh)
                 for n in ("query", "key", "value")], axis=0),
            "attention/output/kernel": get(
                f"{p}/attention/output/dense/kernel").reshape(H, Dh, E),
            "attention/output/bias": get(f"{p}/attention/output/dense/bias"),
            "attention_layer_norm/scale": get(
                f"{p}/attention/output/LayerNorm/gamma"),
            "attention_layer_norm/bias": get(
                f"{p}/attention/output/LayerNorm/beta"),
            "intermediate/kernel": get(f"{p}/intermediate/dense/kernel"),
            "intermediate/bias": get(f"{p}/intermediate/dense/bias"),
            "mlp_output/kernel": get(f"{p}/output/dense/kernel"),
            "mlp_output/bias": get(f"{p}/output/dense/bias"),
            "output_layer_norm/scale": get(f"{p}/output/LayerNorm/gamma"),
            "output_layer_norm/bias": get(f"{p}/output/LayerNorm/beta"),
        })
    for leaf in _ENCODER_LEAVES:
        if stacked:
            out[f"bert/encoder/layers/layer/{leaf}"] = np.stack(
                [layer[leaf] for layer in layers], axis=0)
        else:
            for i, layer in enumerate(layers):
                out[f"bert/encoder/layer_{i}/{leaf}"] = layer[leaf]
    if config.next_sentence and "bert/pooler/dense/kernel" in tf_vars:
        out["bert/pooler/dense/kernel"] = get("bert/pooler/dense/kernel")
        out["bert/pooler/dense/bias"] = get("bert/pooler/dense/bias")
    if "cls/predictions/transform/dense/kernel" in tf_vars:
        t = "cls/predictions/transform"
        out.update({
            "cls_predictions/transform/kernel": get(f"{t}/dense/kernel"),
            "cls_predictions/transform/bias": get(f"{t}/dense/bias"),
            "cls_predictions/layer_norm/scale": get(f"{t}/LayerNorm/gamma"),
            "cls_predictions/layer_norm/bias": get(f"{t}/LayerNorm/beta"),
            "cls_predictions/bias": _pad_vocab(
                get("cls/predictions/output_bias"), V, PADDED_VOCAB_BIAS)})
    if config.next_sentence and \
            "cls/seq_relationship/output_weights" in tf_vars:
        # TF's output_weights are (2, E); the flax kernel is (E, 2)
        out["cls_seq_relationship/kernel"] = get(
            "cls/seq_relationship/output_weights").T
        out["cls_seq_relationship/bias"] = get(
            "cls/seq_relationship/output_bias")
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference torch checkpoint as numpy: the pretraining save
    `{'model': state_dict, 'optimizer': ..., ...}`, the finetune save
    `{'model': state_dict}` or a bare state_dict, read with
    weights_only=True; a DistributedDataParallel `module.` prefix is
    stripped. Only the model's entry is read."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("model", blob) if isinstance(blob, dict) else blob
    out = {}
    for name, tensor in state.items():
        if name.startswith("module."):
            name = name[len("module."):]
        out[name] = tensor.detach().to(torch.float32).numpy()
    return out


# torch module path -> TF variable, where the mechanical rules of
# convert_torch_to_flax do not apply
_TORCH_SPECIAL = {
    "cls.predictions.bias": "cls/predictions/output_bias",
    "cls.seq_relationship.weight": "cls/seq_relationship/output_weights",
    "cls.seq_relationship.bias": "cls/seq_relationship/output_bias",
}


def convert_torch_to_flax(state: Dict[str, np.ndarray],
                          config: BertConfig) -> Dict[str, np.ndarray]:
    """A reference torch state_dict (src/modeling.py names) -> the flat
    flax tree (per-layer encoder): each tensor renamed and laid out in
    TF's convention, then `convert_tf_to_flax`. The tied decoder weight
    is dropped."""
    tf_vars: Dict[str, np.ndarray] = {}
    for name, arr in state.items():
        if name.startswith("cls.predictions.decoder."):
            continue
        if name in _TORCH_SPECIAL:
            # seq_relationship.weight stays (2, E), TF's layout
            tf_vars[_TORCH_SPECIAL[name]] = arr
            continue
        parts = name.split(".")
        leaf: Optional[str] = parts[-1]
        mods: list = []
        for m in parts[:-1]:
            if m.isdigit():
                mods[-1] = f"{mods[-1]}_{m}"   # ModuleList layer.{i}
            else:
                mods.append(m)
        if mods and mods[-1].endswith("_embeddings"):
            leaf = None                         # TF names the table itself
        elif mods and mods[-1] == "LayerNorm":
            leaf = {"weight": "gamma", "bias": "beta"}[leaf]
        elif leaf == "weight":
            arr = arr.T                         # Linear (out, in) -> (in, out)
            leaf = "kernel"
        tf_vars["/".join(mods + ([leaf] if leaf else []))] = arr
    return convert_tf_to_flax(tf_vars, config)


def find_archive_files(directory: str) -> Tuple[str, str, Optional[str]]:
    """(bert_config.json, checkpoint prefix, vocab.txt or None) under an
    extracted Google archive (one nested directory deep allowed)."""
    for root, _dirs, files in os.walk(directory):
        if "bert_config.json" in files:
            cfg = os.path.join(root, "bert_config.json")
            index = [f for f in files if f.endswith(".ckpt.index")]
            if not index:
                raise FileNotFoundError(
                    f"{root} has bert_config.json but no *.ckpt.index")
            prefix = os.path.join(root, index[0][:-len(".index")])
            vocab = (os.path.join(root, "vocab.txt")
                     if "vocab.txt" in files else None)
            return cfg, prefix, vocab
    raise FileNotFoundError(f"no bert_config.json found under {directory}")


def _config_beside(path: str) -> str:
    d = os.path.dirname(path)
    for cand in ("bert_config.json", "config.json"):
        if os.path.exists(os.path.join(d, cand)):
            return os.path.join(d, cand)
    raise FileNotFoundError(
        f"no bert_config.json or config.json next to {path}; a torch "
        "checkpoint needs its model config in the same directory")


def from_pretrained(name_or_path: str, vocab_pad_multiple: int = 1,
                    next_sentence: bool = True
                    ) -> Tuple[BertConfig, Dict[str, np.ndarray]]:
    """(config, flat flax params) of a local source: a reference torch
    checkpoint (`.pt` / `.pth` / `.bin`, its bert_config.json or
    config.json beside it), a Google release `.zip` (extracted into a
    temporary directory that is removed after the read), an extracted
    release directory, or a bare `.ckpt` prefix (bert_config.json beside
    it); the config's vocab_file is the release's vocab.txt where one
    stays on disk. vocab_pad_multiple pads vocab_size and the vocab rows. A
    registry name or a URL raises NotImplementedError."""
    if "://" in name_or_path or name_or_path in RELEASE_NAMES:
        raise NotImplementedError(
            f"--init_checkpoint {name_or_path!r} is a registry name or a "
            f"URL, which needs the network (see {NETWORK_GAPS}); pass a "
            "local .pt, .zip, release directory or .ckpt prefix")
    if not (os.path.exists(name_or_path)
            or os.path.exists(name_or_path + ".index")):
        raise FileNotFoundError(f"no checkpoint found at {name_or_path}")

    def build(config_file, vocab_file):
        with open(config_file, encoding="utf-8") as f:
            config = BertConfig.from_dict(json.load(f)).replace(
                next_sentence=next_sentence, vocab_file=vocab_file)
        return config.replace(vocab_size=pad_vocab_size(
            config.vocab_size, vocab_pad_multiple))

    if os.path.isfile(name_or_path) and name_or_path.endswith(
            (".pt", ".pth", ".bin")):
        vocab = os.path.join(os.path.dirname(name_or_path), "vocab.txt")
        config = build(_config_beside(name_or_path),
                       vocab if os.path.exists(vocab) else None)
        return config, convert_torch_to_flax(
            load_torch_checkpoint(name_or_path), config)
    if os.path.isfile(name_or_path) and zipfile.is_zipfile(name_or_path):
        with tempfile.TemporaryDirectory() as tmp:
            with zipfile.ZipFile(name_or_path) as zf:
                zf.extractall(tmp)
            config, params = from_pretrained(tmp, vocab_pad_multiple,
                                             next_sentence)
        return config.replace(vocab_file=None), params
    if os.path.isdir(name_or_path):
        config_file, prefix, vocab_file = find_archive_files(name_or_path)
    else:                                   # a bare checkpoint prefix
        prefix = name_or_path
        config_file = os.path.join(os.path.dirname(prefix),
                                   "bert_config.json")
        vocab = os.path.join(os.path.dirname(prefix), "vocab.txt")
        vocab_file = vocab if os.path.exists(vocab) else None
    config = build(config_file, vocab_file)
    return config, convert_tf_to_flax(load_tf_weights(prefix), config)
