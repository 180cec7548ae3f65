"""CoNLL-format NER dataset: parse, per-word tokenize with label
propagation, fixed-length encode, and the macro-F1 metric (counterpart of
bert_pytorch_tpu/data/ner.py).

Sentences split on blank lines and -DOCSTART records; the token is column
0 and the label column 3; every word piece carries its word's label;
[CLS] and [SEP] frame the pieces; label ids start at 1 (0 is the padding
label); [CLS], [SEP] and padding carry IGNORE_LABEL, which the loss skips.
`macro_f1` and `classification_diagnostics` compute what the JAX package
asks of sklearn.metrics.f1_score (macro average over the labels present
in either labels or predictions; a class's F1 is 2 tp / (2 tp + fp + fn))
in numpy, so the port needs no sklearn.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

IGNORE_LABEL = -100


@dataclass
class NERSample:
    words: List[str]
    labels: List[str]

    def __post_init__(self):
        if len(self.words) != len(self.labels):
            raise ValueError("words/labels length mismatch")

    def encode(self, tokenizer, label_to_id: Dict[str, int],
               max_seq_len: int) -> Tuple[List[int], List[int], List[int]]:
        """-> (input_ids, label_ids, mask), each max_seq_len long."""
        pieces: List[str] = []
        piece_labels: List[str] = []
        for word, label in zip(self.words, self.labels):
            subs = tokenizer.encode(word, add_special_tokens=False).tokens
            pieces.extend(subs)
            piece_labels.extend([label] * len(subs))
        pieces = pieces[:max_seq_len - 2]
        piece_labels = piece_labels[:max_seq_len - 2]

        tokens = ["[CLS]"] + pieces + ["[SEP]"]
        labels = ([IGNORE_LABEL] + [label_to_id[lb] for lb in piece_labels]
                  + [IGNORE_LABEL])
        unk = tokenizer.token_to_id("[UNK]") or 0
        ids = [tokenizer.token_to_id(t) if tokenizer.token_to_id(t)
               is not None else unk for t in tokens]
        mask = [1] * len(ids)
        pad = max_seq_len - len(ids)
        return (ids + [0] * pad, labels + [IGNORE_LABEL] * pad,
                mask + [0] * pad)


def parse_conll(filename: str) -> List[NERSample]:
    samples: List[NERSample] = []
    words: List[str] = []
    labels: List[str] = []
    with open(filename, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip() or line.startswith("-DOCSTART"):
                if words:
                    samples.append(NERSample(words, labels))
                    words, labels = [], []
                continue
            cols = [c.strip() for c in re.split(r"[ \t]", line) if c.strip()]
            if len(cols) < 4:
                continue
            words.append(cols[0])
            labels.append(cols[3])
    if words:
        samples.append(NERSample(words, labels))
    return samples


class NERDataset:
    """An encoded CoNLL file as numpy arrays. Label ids: 0 padding,
    1..len(labels) the tags, IGNORE_LABEL skipped."""

    def __init__(self, filename: str, tokenizer, labels: Sequence[str],
                 max_seq_len: int = 128):
        self.samples = parse_conll(filename)
        self.label_to_id = {lb: i for i, lb in enumerate(labels, start=1)}
        self.id_to_label = {i: lb for lb, i in self.label_to_id.items()}
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len

    def __len__(self) -> int:
        return len(self.samples)

    def arrays(self) -> Dict[str, np.ndarray]:
        ids, labels, masks = [], [], []
        for s in self.samples:
            i, lb, m = s.encode(self.tokenizer, self.label_to_id,
                                self.max_seq_len)
            ids.append(i)
            labels.append(lb)
            masks.append(m)
        return {"input_ids": np.asarray(ids, np.int32),
                "labels": np.asarray(labels, np.int32),
                "attention_mask": np.asarray(masks, np.int32)}


def _scored(logits: np.ndarray, labels: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(predictions, labels) at the positions with label > 0."""
    preds = np.argmax(logits, axis=-1)
    keep = labels > 0
    return preds[keep], labels[keep]


def _per_class_f1(pred: np.ndarray, true: np.ndarray, classes
                  ) -> np.ndarray:
    """2 tp / (2 tp + fp + fn) per class in float64 (0 where a class is
    neither predicted nor present)."""
    out = []
    for c in classes:
        tp = float(np.sum((pred == c) & (true == c)))
        denom = float(np.sum(true == c)) + float(np.sum(pred == c))
        out.append(2.0 * tp / denom if denom else 0.0)
    return np.asarray(out, np.float64)


def macro_f1(logits: np.ndarray, labels: np.ndarray) -> float:
    """Macro F1 over the positions with label > 0, averaged over every
    class present in the labels or the predictions."""
    pred, true = _scored(logits, labels)
    classes = np.union1d(np.unique(true), np.unique(pred))
    return float(np.mean(_per_class_f1(pred, true, classes)))


def classification_diagnostics(logits: np.ndarray, labels: np.ndarray,
                               label_names=None) -> dict:
    """Per-class F1 and the prediction / label histograms over the scored
    positions: tells a collapse onto one class from a weak but spread
    classifier."""
    p, lab = _scored(logits, labels)
    classes = sorted(set(np.unique(lab)) | set(np.unique(p)))
    per_f1 = _per_class_f1(p, lab, classes)

    def name(c):
        return (label_names[c - 1]
                if label_names and 1 <= c <= len(label_names) else str(c))

    return {
        "per_class_f1": {name(c): round(float(f), 4)
                         for c, f in zip(classes, per_f1)},
        "pred_histogram": {name(c): int((p == c).sum()) for c in classes},
        "label_histogram": {name(c): int((lab == c).sum()) for c in classes},
        "n_scored": int((labels > 0).sum()),
    }
