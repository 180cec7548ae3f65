"""Vocabulary training: WordPiece and byte-level BPE, in-framework
(counterpart of bert_pytorch_tpu/pipeline/vocab.py, the same vocabularies).

    python -m bert_pytorch_tpu_torch.pipeline.vocab -i DIR -o vocab.txt \
        [-s 30000] [--tokenizer wordpiece|bpe]

The reference delegated vocab training to the HF tokenizers Rust trainers
(utils/build_vocab.py:39-58) and then post-processed the result: special
tokens forced to the front, [PAD] forced to index 0 (:62-80). Here the
trainers are implemented directly (the standard algorithms):

- BPE: merge the most frequent adjacent symbol pair until vocab_size.
- WordPiece: same loop but pairs scored by the corpus-likelihood GAIN of
  the merge under a unigram model, freq(ab) * log(freq(ab) * N /
  (freq(a) * freq(b))) — the original WordPiece objective. The plain
  likelihood RATIO (HF trainer's score) is maximized by pairs of rare
  symbols, so on small/noisy corpora it spends the whole merge budget on
  one-off junk and never forms common words; the gain weights by pair
  frequency, which fixes that while keeping the WordPiece (non-BPE)
  character.

Both operate on word frequency tables from the Basic pre-tokenizer, so the
runtime tokenizers in data/tokenization.py consume the output unmodified.
The merge loop runs in C++ (bert_pytorch_tpu_torch.native, built at first
use; a failed build raises) unless a caller passes native=False for this
module's Python engine, the behavioural spec: both select the same merges.
"""

from __future__ import annotations

import argparse
import collections
import math
import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from bert_pytorch_tpu_torch.data.tokenization import (
    SPECIAL_TOKENS,
    BasicTokenizer,
    bytes_to_unicode,
)


def count_words(files: Iterable[str], lowercase: bool = True
                ) -> Dict[str, int]:
    basic = BasicTokenizer(do_lower_case=lowercase)
    counts: collections.Counter = collections.Counter()
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                counts.update(basic.tokenize(line))
    return dict(counts)


class _MergeEngine:
    """Incremental pair/single statistics over the working word list.

    A naive trainer rescans every word per merge — O(vocab_size x corpus),
    minutes per MB. Only words that actually contain the merged pair change,
    so this keeps a pair->word-index inverted index and updates counts by
    delta; selection order is bitwise-identical to the naive loop because
    every best-pair key ends with the pair itself as the tiebreak."""

    def __init__(self, word_counts: Iterable[Tuple[Tuple[str, ...], int]]):
        self.words: List[List] = []          # [symbols list, freq]
        self.pairs: collections.Counter = collections.Counter()
        self.singles: collections.Counter = collections.Counter()
        self.index: Dict[Tuple[str, str], set] = collections.defaultdict(set)
        for symbols, freq in word_counts:
            idx = len(self.words)
            self.words.append([list(symbols), freq])
            self._add(idx)

    def _add(self, idx: int) -> None:
        symbols, freq = self.words[idx]
        for s in symbols:
            self.singles[s] += freq
        for p in zip(symbols, symbols[1:]):
            self.pairs[p] += freq
            self.index[p].add(idx)

    def _remove(self, idx: int) -> None:
        symbols, freq = self.words[idx]
        for s in symbols:
            self.singles[s] -= freq
        for p in zip(symbols, symbols[1:]):
            self.pairs[p] -= freq
            if self.pairs[p] <= 0:
                del self.pairs[p]
                self.index.pop(p, None)
            else:
                self.index[p].discard(idx)

    def merge(self, pair: Tuple[str, str], merged_symbol: str) -> None:
        a, b = pair
        for idx in list(self.index.get(pair, ())):
            self._remove(idx)
            symbols = self.words[idx][0]
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if (i + 1 < len(symbols) and symbols[i] == a
                        and symbols[i + 1] == b):
                    merged.append(merged_symbol)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            self.words[idx][0] = merged
            self._add(idx)
        # self-overlapping merges (e.g. ('a','a') in 'aaa') can leave the
        # pair re-counted from the rebuilt words; drop any residue so the
        # merged pair is never selected twice
        self.pairs.pop(pair, None)
        self.index.pop(pair, None)


def train_wordpiece(word_counts: Dict[str, int], vocab_size: int,
                    special_tokens: Tuple[str, ...] = SPECIAL_TOKENS,
                    min_frequency: int = 1,
                    min_pair_frequency: int = 2,
                    score: str = "gain", native: bool = True) -> List[str]:
    """Greedy WordPiece training: start from characters ('##'-marked
    continuations), repeatedly merge the best-scoring pair until vocab_size.

    score="gain" (default): unigram-model corpus-likelihood gain
    freq(ab) * log(freq(ab) * N / (freq(a) * freq(b))) (see module
    docstring); min_pair_frequency additionally drops one-off pairs from
    candidacy. score="ratio": the HF-trainer likelihood ratio
    freq(ab) / (freq(a) * freq(b)) — for byte-exact reproduction of
    vocabularies built by the reference toolchain (utils/build_vocab.py:39);
    ratio runs on the pure-Python engine, as does native=False."""
    words: Dict[Tuple[str, ...], int] = {}
    for word, freq in word_counts.items():
        if freq < min_frequency or not word:
            continue
        symbols = tuple([word[0]] + ["##" + c for c in word[1:]])
        words[symbols] = words.get(symbols, 0) + freq

    vocab: List[str] = list(special_tokens)
    seen = set(vocab)
    for symbols in words:
        for s in symbols:
            if s not in seen:
                seen.add(s)
                vocab.append(s)

    if score not in ("gain", "ratio"):
        raise ValueError(f"unknown wordpiece score {score!r}")
    if score == "gain" and native:
        from bert_pytorch_tpu_torch.native import vocab_trainer_merge

        new_tokens, _ = vocab_trainer_merge(
            words.items(), vocab, vocab_size, wordpiece_mode=True,
            min_pair_frequency=min_pair_frequency)
        vocab.extend(new_tokens)
        return vocab[:vocab_size]

    engine = _MergeEngine(words.items())
    while len(vocab) < vocab_size:
        pairs, singles = engine.pairs, engine.singles

        def merged_name(p):
            a, b = p
            return a + (b[2:] if b.startswith("##") else b)

        candidates = [p for p, c in pairs.items()
                      if c >= min_pair_frequency]
        if not candidates:
            break
        total = sum(singles.values())

        def gain(p):
            c = pairs[p]
            if score == "ratio":
                return c / (singles[p[0]] * singles[p[1]])
            return c * (math.log(c) + math.log(total)
                        - math.log(singles[p[0]]) - math.log(singles[p[1]]))

        best = max(candidates,
                   key=lambda p: (gain(p), -len(merged_name(p)), p))
        new_symbol = merged_name(best)
        engine.merge(best, new_symbol)
        if new_symbol not in seen:
            seen.add(new_symbol)
            vocab.append(new_symbol)
    return vocab[:vocab_size]


def train_bpe(word_counts: Dict[str, int], vocab_size: int,
              special_tokens: Tuple[str, ...] = ("<pad>", "<unk>", "<s>",
                                                 "</s>", "<mask>"),
              min_frequency: int = 1, native: bool = True
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Byte-level BPE training: most-frequent-pair merges over the GPT-2
    byte alphabet (in C++ unless native=False). Returns (vocab dict
    token->id, ordered merges)."""
    byte_enc = bytes_to_unicode()
    words: Dict[Tuple[str, ...], int] = {}
    sp = byte_enc[ord(" ")]
    for word, freq in word_counts.items():
        if freq < min_frequency:
            continue
        mapped = sp + "".join(byte_enc[b] for b in word.encode("utf-8"))
        words[tuple(mapped)] = words.get(tuple(mapped), 0) + freq

    vocab: List[str] = list(special_tokens) + sorted(set(byte_enc.values()))
    merges: List[Tuple[str, str]] = []
    if native:
        from bert_pytorch_tpu_torch.native import vocab_trainer_merge

        new_tokens, merges = vocab_trainer_merge(
            words.items(), vocab, vocab_size, wordpiece_mode=False)
        vocab.extend(new_tokens)
        return {t: i for i, t in enumerate(vocab[:vocab_size])}, merges

    seen = set(vocab)
    engine = _MergeEngine(words.items())
    while len(vocab) < vocab_size:
        pairs = engine.pairs
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        new_symbol = best[0] + best[1]
        merges.append(best)
        engine.merge(best, new_symbol)
        if new_symbol not in seen:
            seen.add(new_symbol)
            vocab.append(new_symbol)
    return {t: i for i, t in enumerate(vocab[:vocab_size])}, merges


def save_wordpiece_vocab(vocab: List[str], output: str,
                         special_tokens: Tuple[str, ...] = SPECIAL_TOKENS,
                         pad_token: str = "[PAD]") -> None:
    """Specials to the front, pad forced to index 0 (reference :62-80)."""
    rest = [t for t in vocab if t not in special_tokens]
    front = [t for t in special_tokens if t != pad_token]
    ordered = [pad_token] + front + rest
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with open(output, "w", encoding="utf-8") as f:
        for t in ordered:
            f.write(t + "\n")


def save_bpe(vocab: Dict[str, int], merges: List[Tuple[str, str]],
             vocab_output: str, merges_output: Optional[str] = None) -> None:
    import json

    os.makedirs(os.path.dirname(os.path.abspath(vocab_output)), exist_ok=True)
    with open(vocab_output, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    merges_output = merges_output or os.path.join(
        os.path.dirname(vocab_output), "merges.txt")
    with open(merges_output, "w", encoding="utf-8") as f:
        f.write("#version: bert_pytorch_tpu\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


def main(argv=None):
    p = argparse.ArgumentParser(description="Vocabulary trainer")
    p.add_argument("-i", "--input", required=True,
                   help=".txt file or directory of .txt files")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-s", "--size", type=int, default=30000)
    p.add_argument("--tokenizer", default="wordpiece",
                   choices=["wordpiece", "bpe"])
    p.add_argument("--uppercase", action="store_true", default=False)
    p.add_argument("--special_tokens", nargs="+",
                   default=list(SPECIAL_TOKENS))
    p.add_argument("--pad_token", default="[PAD]")
    p.add_argument("--min_frequency", type=int, default=1)
    p.add_argument("--min_pair_frequency", type=int, default=2,
                   help="WordPiece only: pairs rarer than this are not merge "
                        "candidates (guards the likelihood-ratio score from "
                        "spending the whole budget on singleton junk)")
    p.add_argument("--wordpiece_score", default="gain",
                   choices=["gain", "ratio"],
                   help="'gain' (default, frequency-weighted likelihood "
                        "gain) or 'ratio' (HF-trainer likelihood ratio, for "
                        "byte-exact reference-vocab reproduction)")
    args = p.parse_args(argv)

    if os.path.isfile(args.input):
        files = [args.input]
    else:
        files = sorted(str(f) for f in Path(args.input).rglob("*.txt"))
    if not files:
        raise SystemExit(f"no input files under {args.input}")

    counts = count_words(files, lowercase=not args.uppercase)
    if args.tokenizer == "wordpiece":
        vocab = train_wordpiece(counts, args.size,
                                special_tokens=tuple(args.special_tokens),
                                min_frequency=args.min_frequency,
                                min_pair_frequency=args.min_pair_frequency,
                                score=args.wordpiece_score)
        save_wordpiece_vocab(vocab, args.output,
                             special_tokens=tuple(args.special_tokens),
                             pad_token=args.pad_token)
    else:
        # same special-token list for both trainers — the reference passed
        # args.special_tokens to the BPE trainer too (utils/build_vocab.py:
        # 45-57), which is what lets the encode pipeline's [CLS]/[SEP]
        # framing work on BPE vocabs
        vocab, merges = train_bpe(counts, args.size,
                                  special_tokens=tuple(args.special_tokens),
                                  min_frequency=args.min_frequency)
        save_bpe(vocab, merges, args.output)
    print(f"vocab written to {args.output}")


if __name__ == "__main__":
    main()
