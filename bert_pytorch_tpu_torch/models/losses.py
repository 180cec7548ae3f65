"""Pretraining and finetuning losses (counterpart of
bert_pytorch_tpu/models/losses.py).

Cross-entropies are f32 with the masked-mean semantics of
torch.nn.CrossEntropyLoss(ignore_index=...): the sum over valid positions
divided by their count, and 0.0 (not NaN) when no position is valid. The
pooled heads' losses (classification over one logit vector a segment,
multiple choice) and the packed token and span losses reduce
segment first, then with a strict left-to-right sum over (B, G), so a
packed batch and the same examples one a row sum the same values in the
same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll sum, valid count): `cross_entropy` before its division, for a
    caller that divides by a count summed over ranks (the data-parallel
    step)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over positions where labels != ignore_index; logits
    (..., C), labels (...) int."""
    total, count = cross_entropy_terms(logits, labels, ignore_index)
    return total / count.clamp_min(1)


def pretraining_loss(mlm_logits: torch.Tensor,
                     masked_lm_labels: torch.Tensor,
                     nsp_logits: Optional[torch.Tensor] = None,
                     next_sentence_labels: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """MLM + NSP cross-entropies summed, ignore_index -1. Packed rows
    bring per-segment NSP terms, (B, G, 2) logits against (B, G) labels
    with -1 for an empty slot: the masked mean weights every real segment
    equally, so a packed batch's loss is its examples' one a row."""
    loss = cross_entropy(mlm_logits, masked_lm_labels, ignore_index=-1)
    if nsp_logits is not None and next_sentence_labels is not None:
        loss = loss + cross_entropy(nsp_logits, next_sentence_labels,
                                    ignore_index=-1)
    return loss


def pretraining_loss_over_ranks(mlm_logits: torch.Tensor,
                                masked_lm_labels: torch.Tensor,
                                nsp_logits: Optional[torch.Tensor],
                                next_sentence_labels: Optional[torch.Tensor],
                                counts: torch.Tensor) -> torch.Tensor:
    """This rank's share of the data-parallel microbatch's loss: its nll
    sums divided by the counts of every rank's microbatch (`counts`: the
    (masked tokens, NSP labels) summed over ranks), so the ranks' shares
    add up to `pretraining_loss` of the whole microbatch and their
    gradients sum to its gradient (the JAX package's --zero1_rs region
    divides its local sums by the psum'd counts the same way)."""
    total, _ = cross_entropy_terms(mlm_logits, masked_lm_labels)
    loss = total / counts[0].clamp_min(1)
    if nsp_logits is not None and next_sentence_labels is not None:
        total, _ = cross_entropy_terms(nsp_logits, next_sentence_labels)
        loss = loss + total / counts[1].clamp_min(1)
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
    (B, G)-sized per-segment aggregates.

    On the card it is one `sum` launch instead: the loop is a launch an
    element, forward and backward (~2 x 512 for a packed SQuAD loss),
    and the card's GEMMs already give packed and one-a-row rows other
    bits, so the order would keep no equality there."""
    if x.is_cuda:
        return x.sum()
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


def packed_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                      segment_ids: torch.Tensor, max_segments: int,
                      ignore_index: int = -100) -> torch.Tensor:
    """Per-token CE over packed rows, reduced segment first: the per-token
    nll contracted against the segment one-hot ((B, G, S) x (B, S) ->
    (B, G), whose other-segment terms are exact zeros), then
    `_ordered_sum` over (B, G), over the valid count."""
    nll, valid = _nll(logits, labels, ignore_index)
    onehot = segment_onehot(segment_ids, max_segments).to(torch.float32)
    seg_nll = torch.einsum("bgs,bs->bg", onehot, nll)
    return _ordered_sum(seg_nll) / valid.sum().clamp_min(1)


def packed_qa_loss(start_logits: torch.Tensor, end_logits: torch.Tensor,
                   start_positions: torch.Tensor, end_positions: torch.Tensor,
                   segment_ids: torch.Tensor, max_segments: int
                   ) -> torch.Tensor:
    """Per-segment span CE over packed rows: each segment's softmax runs
    over its own positions only (the others, and pad, masked to -inf:
    exp(-inf) is exactly 0), so co-packed examples never share a
    denominator. start/end_positions are (B, G) absolute row positions,
    -1 for an empty slot or an answer outside the window."""
    seg_mask = segment_onehot(segment_ids, max_segments)       # (B, G, S)
    minus_inf = torch.tensor(float("-inf"), device=seg_mask.device)

    def seg_ce(logits, positions):
        masked = torch.where(seg_mask, logits.float()[:, None, :], minus_inf)
        logp = torch.log_softmax(masked, dim=-1)
        valid = positions >= 0
        safe = torch.where(valid, positions,
                           torch.zeros_like(positions)).long()
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return _ordered_sum(nll) / valid.sum().clamp_min(1)

    return (seg_ce(start_logits, start_positions)
            + seg_ce(end_logits, end_positions)) / 2.0
