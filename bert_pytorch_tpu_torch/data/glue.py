"""GLUE/SWAG-style finetune datasets: pair classification, multiple
choice, and labelled sentences for the embedding probe (counterpart of
bert_pytorch_tpu/data/glue.py).

- pair classification / embedding: TSV lines ``label<TAB>text_a`` or
  ``label<TAB>text_a<TAB>text_b``;
- multiple choice: JSONL objects ``{"question": str, "choices": [str],
  "label": int}``, a fixed choice count per file.

Featurization is `tasks.predict.encode_pair`, the function the serving
frontend featurizes live requests with, so training data and traffic
tokenize alike. The int32 arrays equal the JAX package's.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bert_pytorch_tpu_torch.tasks.predict import encode_pair


def _to_row(ids: List[int], types: List[int], max_seq_len: int
            ) -> Tuple[List[int], List[int], List[int]]:
    pad = max_seq_len - len(ids)
    mask = [1] * len(ids) + [0] * pad
    return ids + [0] * pad, types + [0] * pad, mask


def parse_pair_tsv(filename: str) -> List[Tuple[str, str, str]]:
    """-> [(label, text_a, text_b or '')]; blank and '#' lines skipped."""
    rows = []
    with open(filename, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip() or line.startswith("#"):
                continue
            cols = line.split("\t")
            if len(cols) < 2:
                raise ValueError(f"{filename}: want label<TAB>text_a"
                                 f"[<TAB>text_b], got {line!r}")
            rows.append((cols[0].strip(), cols[1],
                         cols[2] if len(cols) > 2 else ""))
    return rows


class PairClassificationDataset:
    """A TSV pair-classification corpus as fixed-length int32 arrays.
    `labels` fixes the label-name -> id order (ids from 0; -1 is the
    ignored label). Also the embedding task's probe corpus."""

    def __init__(self, filename: str, tokenizer, labels: Sequence[str],
                 max_seq_len: int = 128):
        self.rows = parse_pair_tsv(filename)
        self.label_to_id = {l: i for i, l in enumerate(labels)}
        self.id_to_label = {i: l for l, i in self.label_to_id.items()}
        self.tokenizer = tokenizer
        self.max_seq_len = int(max_seq_len)
        unknown = sorted({l for l, _, _ in self.rows}
                         - set(self.label_to_id))
        if unknown:
            raise ValueError(f"{filename}: labels {unknown} not in "
                             f"--labels {list(labels)}")

    def __len__(self) -> int:
        return len(self.rows)

    def arrays(self) -> Dict[str, np.ndarray]:
        ids_, types_, masks_, labels_ = [], [], [], []
        for label, a, b in self.rows:
            ids, types = encode_pair(self.tokenizer, a, b or None,
                                     max_pieces=self.max_seq_len)
            ids, types, mask = _to_row(ids, types, self.max_seq_len)
            ids_.append(ids)
            types_.append(types)
            masks_.append(mask)
            labels_.append(self.label_to_id[label])
        return {
            "input_ids": np.asarray(ids_, np.int32),
            "token_type_ids": np.asarray(types_, np.int32),
            "attention_mask": np.asarray(masks_, np.int32),
            "labels": np.asarray(labels_, np.int32),
        }


class MultipleChoiceDataset:
    """A JSONL multiple-choice corpus -> (N, C, S) arrays. Every record
    carries exactly `num_choices` choices; each choice encodes as the pair
    ([CLS] question [SEP] choice [SEP]), or the choice alone without a
    question."""

    def __init__(self, filename: str, tokenizer, num_choices: int,
                 max_seq_len: int = 128):
        self.records = []
        with open(filename, encoding="utf-8") as f:
            for ln, line in enumerate(f, start=1):
                if not line.strip():
                    continue
                rec = json.loads(line)
                choices = rec.get("choices")
                if not isinstance(choices, list) \
                        or len(choices) != num_choices:
                    raise ValueError(
                        f"{filename}:{ln}: want exactly {num_choices} "
                        f"choices, got {choices!r}")
                label = int(rec.get("label", -1))
                if not 0 <= label < num_choices:
                    raise ValueError(f"{filename}:{ln}: label {label} "
                                     f"outside [0, {num_choices})")
                self.records.append((rec.get("question", ""), choices,
                                     label))
        self.tokenizer = tokenizer
        self.num_choices = int(num_choices)
        self.max_seq_len = int(max_seq_len)

    def __len__(self) -> int:
        return len(self.records)

    def arrays(self) -> Dict[str, np.ndarray]:
        n, c_, s = len(self.records), self.num_choices, self.max_seq_len
        out = {
            "input_ids": np.zeros((n, c_, s), np.int32),
            "token_type_ids": np.zeros((n, c_, s), np.int32),
            "attention_mask": np.zeros((n, c_, s), np.int32),
            "labels": np.zeros((n,), np.int32),
        }
        for i, (question, choices, label) in enumerate(self.records):
            for c, choice in enumerate(choices):
                ids, types = encode_pair(self.tokenizer, question or choice,
                                         choice if question else None,
                                         max_pieces=s)
                ids, types, mask = _to_row(ids, types, s)
                out["input_ids"][i, c] = ids
                out["token_type_ids"][i, c] = types
                out["attention_mask"][i, c] = mask
            out["labels"][i] = label
        return out


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """argmax accuracy over rows with label >= 0 (padded eval tails carry
    -1)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    keep = labels >= 0
    if not keep.any():
        return 0.0
    return float((np.argmax(logits[keep], axis=-1)
                  == labels[keep]).mean())
