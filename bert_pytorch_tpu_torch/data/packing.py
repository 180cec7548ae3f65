"""Sequence packing (counterpart of bert_pytorch_tpu/data/packing.py): the
greedy first-fit bin packer that the serving scheduler uses to put
several short requests into one fixed-length row, packed finetuning
(training/finetune.py) several short examples, and packed pretraining
(data/sharded.py, `packing=True`) several short pretraining examples.

Packed pretraining batch (`pack_examples`; models/bert.py and
training/pretrain.py consume it):

  input_ids        (B, S)  concatenated example tokens, 0-padded tail
  token_type_ids   (B, S)  each example's NSP A/B ids, concatenated
  attention_mask   (B, S)  1 on real tokens (== segment_ids > 0)
  segment_ids      (B, S)  packing segment 1..n per row, 0 = pad;
                           attention is restricted to q_seg == k_seg
  position_ids     (B, S)  positions reset per segment
  masked_lm_labels (B, S)  concatenated per-example labels, -1 = none
  next_sentence_labels (B, G) per-segment NSP labels, -1 = empty slot
  nsp_positions    (B, G)  row position of each segment's [CLS]; 0 for
                           an empty slot (its label is -1)

G (`max_segments`) bounds the segments a row, so the NSP arrays keep a
fixed shape.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def first_fit(lengths: Sequence[int], n_bins: int, capacity: int,
              max_segments: int, segs_per_unit: int = 1) -> List[List[int]]:
    """Place each example, in arrival order, into the first of `n_bins`
    bins with `capacity` token slots and `segs_per_unit` of its
    `max_segments` example slots free. Returns per-bin lists of example
    indices; examples that fit nowhere are absent (the caller keeps them
    for the next batch). Deterministic and order-preserving: no sorting.
    `segs_per_unit` > 1 places multi-segment units whole (a
    multiple-choice example's C choice rows stay in one bin)."""
    used = [0] * n_bins
    segs = [0] * n_bins
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for i, ln in enumerate(lengths):
        ln = int(ln)
        if ln > capacity:
            raise ValueError(f"example length {ln} exceeds row capacity "
                             f"{capacity}")
        for b in range(n_bins):
            if used[b] + ln <= capacity \
                    and segs[b] + segs_per_unit <= max_segments:
                used[b] += ln
                segs[b] += segs_per_unit
                bins[b].append(i)
                break
    return bins


def example_lengths(attention_mask: np.ndarray) -> np.ndarray:
    """(N, S) {0,1} mask -> (N,) real lengths; the real tokens of a shard
    row are a prefix (content, then the pad tail)."""
    return attention_mask.astype(np.int64).sum(axis=1)


def pack_examples(examples: Dict[str, np.ndarray], bins: List[List[int]],
                  seq_len: int, max_segments: int) -> Dict[str, np.ndarray]:
    """The packed batch of already-masked examples (input_ids,
    token_type_ids, attention_mask, masked_lm_labels, each (N, S), and
    next_sentence_labels (N,)) laid out by `bins`, each output row's
    example indices (`first_fit`'s result)."""
    ids = examples["input_ids"]
    toktype = examples["token_type_ids"]
    labels = examples["masked_lm_labels"]
    nsp = examples["next_sentence_labels"]
    lengths = example_lengths(examples["attention_mask"])
    rows = len(bins)
    out = {
        "input_ids": np.zeros((rows, seq_len), np.int32),
        "token_type_ids": np.zeros((rows, seq_len), np.int32),
        "attention_mask": np.zeros((rows, seq_len), np.int32),
        "segment_ids": np.zeros((rows, seq_len), np.int32),
        "position_ids": np.zeros((rows, seq_len), np.int32),
        "masked_lm_labels": np.full((rows, seq_len), -1, np.int32),
        "next_sentence_labels": np.full((rows, max_segments), -1, np.int32),
        "nsp_positions": np.zeros((rows, max_segments), np.int32),
    }
    for b, members in enumerate(bins):
        cursor = 0
        for g, ei in enumerate(members):
            ln = int(lengths[ei])
            sl = slice(cursor, cursor + ln)
            out["input_ids"][b, sl] = ids[ei, :ln]
            out["token_type_ids"][b, sl] = toktype[ei, :ln]
            out["attention_mask"][b, sl] = 1
            out["segment_ids"][b, sl] = g + 1
            out["position_ids"][b, sl] = np.arange(ln, dtype=np.int32)
            out["masked_lm_labels"][b, sl] = labels[ei, :ln]
            out["next_sentence_labels"][b, g] = nsp[ei]
            out["nsp_positions"][b, g] = cursor
            cursor += ln
    return out


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Real tokens / slot tokens of a packed (or plain-masked) batch."""
    seg = np.asarray(segment_ids)
    return float((seg > 0).mean()) if seg.size else 0.0
