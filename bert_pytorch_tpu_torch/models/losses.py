"""Pretraining and finetuning losses (counterpart of
bert_pytorch_tpu/models/losses.py).

Cross-entropies are f32 with the masked-mean semantics of
torch.nn.CrossEntropyLoss(ignore_index=...): the sum over valid positions
divided by their count, and 0.0 (not NaN) when no position is valid. The
pooled heads' losses (classification over one logit vector a segment,
multiple choice) reduce with a strict left-to-right sum, so a packed
batch and the same examples one a row give the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over positions where labels != ignore_index; logits
    (..., C), labels (...) int."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum().clamp_min(1)
    return nll.sum() / count


def pretraining_loss(mlm_logits: torch.Tensor,
                     masked_lm_labels: torch.Tensor,
                     nsp_logits: Optional[torch.Tensor] = None,
                     next_sentence_labels: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """MLM + NSP cross-entropies summed, ignore_index -1."""
    loss = cross_entropy(mlm_logits, masked_lm_labels, ignore_index=-1)
    if nsp_logits is not None and next_sentence_labels is not None:
        loss = loss + cross_entropy(nsp_logits, next_sentence_labels,
                                    ignore_index=-1)
    return loss


def qa_loss(start_logits: torch.Tensor, end_logits: torch.Tensor,
            start_positions: torch.Tensor, end_positions: torch.Tensor
            ) -> torch.Tensor:
    """(CE(start) + CE(end)) / 2 over (B, S) logits; an answer position
    outside [0, S) contributes no loss (a window that truncates the
    answer, or a padded row's -1)."""
    seq_len = start_logits.shape[-1]

    def in_window(pos):
        return torch.where((pos >= 0) & (pos < seq_len), pos,
                           torch.full_like(pos, -1))

    loss_s = cross_entropy(start_logits, in_window(start_positions))
    loss_e = cross_entropy(end_logits, in_window(end_positions))
    return (loss_s + loss_e) / 2.0


def token_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_index: int = -100) -> torch.Tensor:
    """Per-token CE over (B, S, C) logits; -100 ignores [CLS]/[SEP] and
    padding positions."""
    return cross_entropy(logits, labels, ignore_index=ignore_index)


def mlm_accuracy(mlm_logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, masked) counts of the masked-token predictions; argmax
    takes the first of tied maxima, as jnp.argmax does."""
    valid = labels != -1
    pred = torch.argmax(mlm_logits, dim=-1)
    correct = (pred == labels) & valid
    return correct.sum(), valid.sum()


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    return cross_entropy(logits, labels, ignore_index=-1)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x's elements strictly left to right in row-major flat
    order, starting from 0 (JAX's lax.scan over the flattened array): one
    add per element, so the partial sums, and the result's bits, depend
    only on the values in that order, never on x's shape. Used only on
    (B, G)-sized per-segment aggregates, where a loop of adds is cheap."""
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for v in x.reshape(-1).unbind():
        total = total + v
    return total


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-position f32 nll with ignored slots exactly 0, valid mask)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def segment_onehot(segment_ids: torch.Tensor, max_segments: int
                   ) -> torch.Tensor:
    """(B, S) packed segment ids (1..G, 0 = pad) -> (B, G, S) bool
    segment membership: the one mask the per-segment [CLS] gather and the
    sentence-embedding mean both build on."""
    want = torch.arange(1, max_segments + 1, dtype=segment_ids.dtype,
                        device=segment_ids.device)
    return segment_ids[:, None, :] == want[None, :, None]


def segment_classification_loss(logits: torch.Tensor, labels: torch.Tensor
                                ) -> torch.Tensor:
    """Classification CE over per-segment pooled logits ((B, G, C) against
    (B, G) labels, -1 an empty slot) or plain (B, C) against (B,): the
    nll summed by `_ordered_sum` over the valid count, so a packed batch
    and the same examples one per row give the same bits."""
    nll, valid = _nll(logits, labels, ignore_index=-1)
    return _ordered_sum(nll) / valid.sum().clamp_min(1)


def choice_loss(scores: torch.Tensor, labels: torch.Tensor,
                num_choices: int) -> torch.Tensor:
    """Multiple-choice CE. Labels of the same rank as `scores` mean the
    packed form: (B, G) scores, each example's C choices in C consecutive
    segments, against (B, G / C) labels (even where G / C equals C), so
    the scores regroup to (B, G / C, C); labels one rank below mean the
    choice axis is already last ((B, C) against (B,)). -1 labels an
    empty group."""
    if labels.dim() == scores.dim():
        scores = scores.reshape(*scores.shape[:-1], -1, num_choices)
    return segment_classification_loss(scores, labels)
