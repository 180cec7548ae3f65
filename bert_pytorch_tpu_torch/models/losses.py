"""Pretraining and finetuning losses (counterpart of
bert_pytorch_tpu/models/losses.py).

Cross-entropies are f32 with the masked-mean semantics of
torch.nn.CrossEntropyLoss(ignore_index=...): the sum over valid positions
divided by their count, and 0.0 (not NaN) when no position is valid.
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
