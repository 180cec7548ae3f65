"""Dynamic 80/10/10 masking and the derived features, batch-vectorized in
numpy (a copy of bert_pytorch_tpu/data/masking.py, trimmed to what the
pretraining loader uses).

- segment ids: 0 everywhere; 1 from the token after the first [SEP]
  through the second [SEP] when the sample has 3 special tokens (an NSP
  pair);
- input mask: 1 through the last special token, 0 on the padding tail;
- masking: choose min(max_pred, max(1, floor(n_maskable * prob)))
  positions among non-special, non-padding tokens, without replacement;
  label = original token there, -1 elsewhere; of the chosen positions 80%
  become [MASK], 10% a random token in [0, vocab_size - 1), 10% stay.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def segment_ids_from_specials(input_ids: np.ndarray,
                              special_positions: np.ndarray) -> np.ndarray:
    """(B, S) ids + (B, K) special-token positions -> (B, S) segment ids."""
    B, S = input_ids.shape
    seg = np.zeros((B, S), dtype=input_ids.dtype)
    if special_positions.shape[1] == 3:
        pos = np.arange(S)[None, :]
        start = special_positions[:, 1:2] + 1
        end = special_positions[:, 2:3] + 1
        seg = ((pos >= start) & (pos < end)).astype(input_ids.dtype)
    return seg


def input_mask_from_specials(input_ids: np.ndarray,
                             special_positions: np.ndarray) -> np.ndarray:
    """1 through the last special token, 0 on the padding tail."""
    pos = np.arange(input_ids.shape[1])[None, :]
    last = special_positions[:, -1][:, None]
    return (pos <= last).astype(input_ids.dtype)


def per_row_mask_draws(rngs: Sequence[np.random.Generator], seq_len: int,
                       vocab_size: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The three random fields `dynamic_mask_batch` consumes, one
    generator per row, drawn in the order (scores, action, random
    tokens)."""
    S = int(seq_len)
    scores = np.stack([r.random((S,)) for r in rngs])
    action = np.stack([r.random((S,)) for r in rngs])
    random_tokens = np.stack([r.integers(0, vocab_size - 1, (S,))
                              for r in rngs])
    return scores, action, random_tokens


def dynamic_mask_batch(input_ids: np.ndarray, special_positions: np.ndarray,
                       mask_token_index: int, max_pred_per_seq: int,
                       masked_lm_prob: float,
                       draws: Tuple[np.ndarray, np.ndarray, np.ndarray],
                       original_token_prob: float = 0.1,
                       random_token_prob: float = 0.1
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-batch 80/10/10 masking from pre-drawn (scores, action, random
    tokens). Returns (masked_ids, labels), labels -1 on unmasked
    positions. One uniform score per position, non-maskable positions
    pushed to +inf, and the first `mask_count` of each row's argsort chosen:
    a draw without replacement per row, in one numpy call."""
    B, S = input_ids.shape
    pos = np.arange(S)[None, :]

    maskable = pos < special_positions[:, -1][:, None]
    for k in range(special_positions.shape[1]):
        maskable &= pos != special_positions[:, k][:, None]

    n_maskable = maskable.sum(axis=1)
    mask_count = np.minimum(max_pred_per_seq,
                            np.maximum(1, (n_maskable * masked_lm_prob)
                                       .astype(np.int64)))

    scores, action, random_tokens = draws
    scores = np.array(scores, dtype=np.float64, copy=True)
    scores[~maskable] = np.inf
    order = np.argsort(scores, axis=1)
    rank_of_pos = np.empty_like(order)
    np.put_along_axis(rank_of_pos, order, pos.repeat(B, axis=0), axis=1)
    chosen = (rank_of_pos < mask_count[:, None]) & maskable

    labels = np.where(chosen, input_ids, -1).astype(np.int64)
    keep = action < original_token_prob
    randomize = (~keep) & (action < original_token_prob + random_token_prob)
    masked = input_ids.copy()
    masked[chosen & ~keep & ~randomize] = mask_token_index
    do_rand = chosen & randomize
    masked[do_rand] = random_tokens[do_rand]
    return masked, labels
