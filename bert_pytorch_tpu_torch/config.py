"""Model and run configuration (counterpart of bert_pytorch_tpu/config.py).

`BertConfig` keeps the fields of the JAX package's dataclass that the
port's slices read; `from_dict` ignores the others, so the repository's
model config JSONs load unchanged. `merge_args_with_config` is the JAX
package's three-level precedence for entry points: CLI > JSON run config >
argparse defaults.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import re
from typing import Any, Dict, Optional


REMAT_POLICIES = ("nothing", "dots", "mlp_only")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    # NSP on/off: when False the token-type embedding and pooler are absent
    next_sentence: bool = False
    model_name: Optional[str] = None
    vocab_file: Optional[str] = None
    lowercase: bool = True
    # the tokenizer family of vocab_file (data/tokenization.TOKENIZERS):
    # "wordpiece" or "bpe"; NER builds it unless --tokenizer names one
    tokenizer: str = "wordpiece"
    # Counter-hash dropout at every training dropout site: each residual
    # tail is one fused residual-dropout-LayerNorm (mask evaluated in the
    # kernel), and the embeddings and attention-probability sites
    # regenerate their hash masks in the backward pass. False (the JAX
    # package's nn.Dropout stream) is not ported: training raises.
    fused_dropout_ln: bool = True
    # Written into a model config for parity with the JAX package, where
    # it sows the per-layer taps; the port's task heads return the taps
    # when called with return_taps=True, whatever this says.
    debug_taps: bool = False
    # K-FAC's taps on the pretraining model's Linears (optim/kfac.py)
    kfac_taps: bool = False
    # Activation checkpointing of every encoder layer in training
    # (models/bert.BertEncoder): the layer's activations are recomputed in
    # the backward pass instead of kept, under `remat_policy`: "nothing"
    # keeps none of the layer's (recomputes it whole), "dots" keeps the
    # matmul outputs and recomputes the rest, "mlp_only" recomputes only
    # the (B, S, I) up-projection and its activation.
    checkpoint_activations: bool = False
    remat_policy: str = "nothing"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r}: want one "
                             f"of {REMAT_POLICIES}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BertConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json_file(cls, path: str) -> "BertConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def replace(self, **kw: Any) -> "BertConfig":
        return dataclasses.replace(self, **kw)

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be a multiple of "
                f"num_attention_heads ({self.num_attention_heads})")
        return self.hidden_size // self.num_attention_heads


# student presets: `student_<L>l_<H>` names a depth-L, width-H student of
# whatever teacher config it is derived from (training/distill.py), by
# rule, so any size is nameable: student_6l_768 is BERT-Base's width at
# half BERT-Large's depth.
_STUDENT_PRESET = re.compile(r"^student_(\d+)l_(\d+)$")


def is_student_preset(name: str) -> bool:
    return bool(_STUDENT_PRESET.match(name or ""))


def student_config(preset: str, teacher: BertConfig) -> BertConfig:
    """A student architecture derived from `teacher` by preset name:
    `student_<L>l_<H>` -> L layers, width H, intermediate 4H, H // 64
    heads lowered until they divide H. Every other field is the
    teacher's, so a student trains and serves through the teacher's
    code paths."""
    m = _STUDENT_PRESET.match(preset or "")
    if not m:
        raise ValueError(
            f"unknown student preset {preset!r}; expected student_<L>l_<H> "
            "(e.g. student_6l_768, student_4l_512)")
    layers, hidden = int(m.group(1)), int(m.group(2))
    if layers < 1 or hidden < 1:
        raise ValueError(f"student preset {preset!r}: depth and width "
                         "must be >= 1")
    heads = max(1, hidden // 64)
    while hidden % heads:
        heads -= 1
    return teacher.replace(num_hidden_layers=layers, hidden_size=hidden,
                           num_attention_heads=heads,
                           intermediate_size=4 * hidden)


def pad_vocab_size(vocab_size: int, multiple: int = 8) -> int:
    """Round the vocab up to a multiple, as every checkpoint's padded
    embedding table is."""
    return ((vocab_size + multiple - 1) // multiple) * multiple


def explicit_cli_keys(parser: argparse.ArgumentParser,
                      argv: Optional[list] = None) -> set:
    """Which destinations were given explicitly on the command line,
    found by re-parsing with every default suppressed."""
    suppressed = copy.deepcopy(parser)
    for action in suppressed._actions:  # noqa: SLF001
        action.default = argparse.SUPPRESS
    return set(vars(suppressed.parse_args(argv)))


def merge_args_with_config(parser: argparse.ArgumentParser,
                           argv: Optional[list] = None,
                           config_key: str = "config_file"
                           ) -> argparse.Namespace:
    """CLI > JSON run config > parser defaults: values of the JSON file
    named by `config_key` override defaults but never explicit CLI flags;
    keys the parser does not declare attach to the namespace."""
    args = parser.parse_args(argv)
    config_path = getattr(args, config_key, None)
    if not config_path:
        return args
    with open(config_path, "r", encoding="utf-8") as f:
        config = json.load(f)
    explicit = explicit_cli_keys(parser, argv)
    for key, value in config.items():
        if key not in explicit:
            setattr(args, key, value)
    return args
