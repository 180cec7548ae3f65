"""Corpus -> pretraining samples -> sharded gzip'd HDF5 (counterpart of
bert_pytorch_tpu/pipeline/encode.py: the same samples from the same seed).

    python -m bert_pytorch_tpu_torch.pipeline.encode --input_dir DIR \
        --output_dir OUT --vocab_file vocab.txt [--max_seq_len 128] \
        [--next_seq_prob 0.5] [--seed 0]

Semantics match the reference utils/encode_data.py: documents are blank-line
delimited, sentences accumulate into chunks near a target length (randomly
shortened with short_seq_prob, :81-86), NSP mode splits each chunk at a
random sentence boundary and replaces the second segment with a random other
document's tail with probability next_seq_prob (rewinding the cursor over
the displaced sentences, :107-131); samples are shuffled per file and
written with the schema {input_ids i4, special_token_positions i4,
next_sentence_labels i1} (:183-210). `sample_arrays` gives the same
arrays without a file (h5py is imported by write_hdf5 alone), for an
in-memory data.sharded.ShardIndex.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclass
class TrainingSample:
    """[CLS] a [SEP] (NSP: [CLS] a [SEP] b [SEP]); special_token_positions
    records where [CLS]/[SEP]s sit (reference TrainingSample :12-37)."""

    seq_tokens: List[str]
    next_seq_tokens: Optional[List[str]] = None
    is_random_next: bool = False
    sequence: List[str] = field(init=False)
    special_token_positions: List[int] = field(init=False)

    def __post_init__(self):
        self.sequence = ["[CLS]"] + list(self.seq_tokens)
        self.special_token_positions = [0]
        if self.next_seq_tokens is not None:
            self.special_token_positions.append(len(self.sequence))
            self.sequence.append("[SEP]")
            self.sequence.extend(self.next_seq_tokens)
        self.special_token_positions.append(len(self.sequence))
        self.sequence.append("[SEP]")


def read_documents(input_file: str, tokenizer) -> List[List[List[str]]]:
    """Blank-line-delimited documents of tokenized sentences
    (reference :48-62). Uses the tokenizer's batch path where it has one
    (the native encoders: bert_pytorch_tpu_torch.native) — this
    per-sentence encode is the offline pipeline's hot loop."""
    raw_docs: List[List[str]] = [[]]
    with open(input_file, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                raw_docs.append([])
                continue
            raw_docs[-1].append(line)

    if hasattr(tokenizer, "encode_batch"):
        flat = [line for d in raw_docs for line in d]
        encodings = tokenizer.encode_batch(flat, add_special_tokens=False)
        tokens_iter = iter(e.tokens for e in encodings)
    else:
        tokens_iter = iter(
            tokenizer.encode(line, add_special_tokens=False).tokens
            for d in raw_docs for line in d)

    documents: List[List[List[str]]] = []
    for d in raw_docs:
        doc: List[List[str]] = []
        for _line in d:
            tokens = next(tokens_iter)
            if tokens:
                doc.append(tokens)
        if doc:
            documents.append(doc)
    return documents


def _target_len(max_num_tokens: int, short_seq_prob: float,
                rng: random.Random) -> int:
    if rng.random() < short_seq_prob:
        return rng.randint(2, max_num_tokens)
    return max_num_tokens


def samples_from_document(doc_idx: int, documents, max_seq_len: int,
                          next_seq_prob: float, short_seq_prob: float,
                          rng: random.Random) -> List[TrainingSample]:
    """Chunking + NSP pairing (reference :65-167)."""
    nsp = next_seq_prob > 0
    max_num_tokens = max_seq_len - (3 if nsp else 2)
    target = _target_len(max_num_tokens, short_seq_prob, rng)

    document = documents[doc_idx]
    samples: List[TrainingSample] = []
    chunk: List[List[str]] = []
    chunk_len = 0
    i = 0
    while i < len(document):
        current = document[i][:target]
        if chunk and (i + 1 == len(document)
                      or chunk_len + len(current) >= target):
            if nsp:
                if len(documents) <= 1:
                    raise ValueError(
                        "NSP needs more than one document for random nexts")
                split = rng.randint(1, len(chunk) - 1) if len(chunk) >= 2 else 1
                seq = [t for s in chunk[:split] for t in s]
                if rng.random() < next_seq_prob:
                    # random next from another document; rewind the cursor
                    # over the sentences we displaced (reference :113-131)
                    is_random = True
                    other_idx = rng.randint(0, len(documents) - 1)
                    while other_idx == doc_idx:
                        other_idx = rng.randint(0, len(documents) - 1)
                    other = documents[other_idx]
                    start = rng.randint(0, len(other) - 1)
                    budget = target - len(seq)
                    nxt: List[str] = []
                    for sent in other[start:]:
                        nxt.extend(sent)
                        if len(nxt) >= budget:
                            nxt = nxt[:budget]
                            break
                    i -= len(chunk) - split
                else:
                    is_random = False
                    nxt = [t for s in chunk[split:] for t in s]
                samples.append(TrainingSample(seq, nxt, is_random))
            else:
                samples.append(TrainingSample(
                    [t for s in chunk for t in s]))
            target = _target_len(max_num_tokens, short_seq_prob, rng)
            chunk = []
            chunk_len = 0

        current = document[i][:target]
        chunk.append(current)
        chunk_len += len(current)
        i += 1
    return samples


def create_samples(input_file: str, tokenizer, max_seq_len: int,
                   next_seq_prob: float, short_seq_prob: float,
                   seed: Optional[int] = None) -> List[TrainingSample]:
    rng = random.Random(seed)
    documents = read_documents(input_file, tokenizer)
    samples: List[TrainingSample] = []
    for i in range(len(documents)):
        samples.extend(samples_from_document(
            i, documents, max_seq_len, next_seq_prob, short_seq_prob, rng))
    rng.shuffle(samples)
    return samples


def sample_arrays(samples: List[TrainingSample], tokenizer,
                  max_seq_len: int) -> Dict[str, np.ndarray]:
    """The shard schema's arrays of `samples` (reference :183-210):
    input_ids (n, max_seq_len) int32, zero-padded; special_token_positions
    (n, most specials a sample) int32, the last position repeated;
    next_sentence_labels (n,) int8."""
    n_specials = max((len(s.special_token_positions) for s in samples),
                     default=2)
    ids_rows, spec_rows, nsl_rows = [], [], []
    for s in samples:
        row = [tokenizer.token_to_id(t) for t in s.sequence]
        if None in row:
            raise ValueError(f"token missing from vocab in {s.sequence}")
        row += [0] * (max_seq_len - len(row))
        ids_rows.append(row)
        spec = list(s.special_token_positions)
        spec += [spec[-1]] * (n_specials - len(spec))
        spec_rows.append(spec)
        nsl_rows.append(1 if s.is_random_next else 0)
    return {"input_ids": np.asarray(ids_rows, np.int32),
            "special_token_positions": np.asarray(spec_rows, np.int32),
            "next_sentence_labels": np.asarray(nsl_rows, np.int8)}


def write_hdf5(output_file: str, samples: List[TrainingSample], tokenizer,
               max_seq_len: int) -> int:
    """Write the runtime-compatible shard (reference :183-210). Returns the
    sample count."""
    import h5py

    arrays = sample_arrays(samples, tokenizer, max_seq_len)
    with h5py.File(output_file, "w") as f:
        f.create_dataset("input_ids", data=arrays["input_ids"],
                         dtype="i4", compression="gzip")
        f.create_dataset("special_token_positions",
                         data=arrays["special_token_positions"], dtype="i4",
                         compression="gzip")
        f.create_dataset("next_sentence_labels",
                         data=arrays["next_sentence_labels"], dtype="i1",
                         compression="gzip")
    return len(samples)


def encode_file(input_file: str, output_file: str, tokenizer,
                max_seq_len: int, next_seq_prob: float, short_seq_prob: float,
                seed: Optional[int] = None) -> int:
    t0 = time.time()
    samples = create_samples(input_file, tokenizer, max_seq_len,
                             next_seq_prob, short_seq_prob, seed=seed)
    n = write_hdf5(output_file, samples, tokenizer, max_seq_len)
    print(f"[encoder] {output_file}: {n} samples ({time.time() - t0:.0f}s)")
    return n


def _encode_one(params):
    input_file, output_file, vocab_file, tokenizer_kind, uppercase, \
        max_seq_len, next_seq_prob, short_seq_prob, seed = params
    from bert_pytorch_tpu_torch.data.tokenization import TOKENIZERS

    tokenizer = TOKENIZERS[tokenizer_kind](vocab_file, uppercase=uppercase)
    return encode_file(input_file, output_file, tokenizer, max_seq_len,
                       next_seq_prob, short_seq_prob, seed=seed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True,
                   help=".txt file or directory of .txt shards")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--vocab_file", required=True)
    p.add_argument("--max_seq_len", default=512, type=int)
    p.add_argument("--short_seq_prob", default=0.1, type=float)
    p.add_argument("--next_seq_prob", default=0.0, type=float,
                   help="0 disables the NSP task (RoBERTa mode)")
    p.add_argument("--uppercase", action="store_true", default=False)
    p.add_argument("--tokenizer", default="wordpiece",
                   choices=["wordpiece", "bpe"])
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    if os.path.isfile(args.input_dir):
        inputs = [args.input_dir]
    else:
        inputs = sorted(str(f) for f in Path(args.input_dir).rglob("*.txt"))
    if not inputs:
        raise SystemExit(f"no input .txt under {args.input_dir}")

    # output naming mirrors the reference (:263-271)
    prefix = ("sequences_"
              + ("uppercase" if args.uppercase else "lowercase")
              + f"_max_seq_len_{args.max_seq_len}"
              + f"_next_seq_task_{str(args.next_seq_prob > 0).lower()}")
    out_dir = os.path.join(args.output_dir, prefix)
    os.makedirs(out_dir, exist_ok=True)

    params = [(ifile, os.path.join(out_dir, f"train_{i}.hdf5"),
               args.vocab_file, args.tokenizer, args.uppercase,
               args.max_seq_len, args.next_seq_prob, args.short_seq_prob,
               None if args.seed is None else args.seed + i)
              for i, ifile in enumerate(inputs)]
    t0 = time.time()
    with mp.get_context("spawn").Pool(processes=args.processes) as pool:
        counts = pool.map(_encode_one, params)
    print(f"[encoder] {sum(counts)} samples in {len(inputs)} shards "
          f"({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
