"""Model configuration (counterpart of bert_pytorch_tpu/config.py).

`BertConfig` keeps the fields of the JAX package's dataclass that the
serving slice reads; `from_dict` ignores the others, so the repository's
model config JSONs load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    # NSP on/off: when False the token-type embedding and pooler are absent
    next_sentence: bool = False
    model_name: Optional[str] = None
    vocab_file: Optional[str] = None
    lowercase: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BertConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json_file(cls, path: str) -> "BertConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw: Any) -> "BertConfig":
        return dataclasses.replace(self, **kw)

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be a multiple of "
                f"num_attention_heads ({self.num_attention_heads})")
        return self.hidden_size // self.num_attention_heads


def pad_vocab_size(vocab_size: int, multiple: int = 8) -> int:
    """Round the vocab up to a multiple, as every checkpoint's padded
    embedding table is."""
    return ((vocab_size + multiple - 1) // multiple) * multiple
