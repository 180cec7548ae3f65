"""Text resharding + subsampling utilities (counterpart of
bert_pytorch_tpu/pipeline/shard.py).

    python -m bert_pytorch_tpu_torch.pipeline.shard -i FILE -o OUT \
        [-b 100M] [--sample_sentences 10M --seed 0]

- `shard`: byte-size-bounded resharding that only cuts at article boundaries
  (blank lines) — reference utils/shard.py:6-27.
- `sample_and_shard`: random article subsampling down to a sentence budget,
  then sharding — reference utils/sample_and_shard.py:83-121.
- `parse_size`: '100M'-style size strings (reference shard.py:30-38).
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Iterator, List, Optional

_POSTFIX = {"K": 1_000, "M": 1_000_000, "B": 1_000_000_000}


def parse_size(value) -> int:
    if isinstance(value, (int, float)):
        return int(value)
    v = str(value).strip()
    if v.isdigit():
        return int(v)
    if len(v) > 1 and v[-1].upper() in _POSTFIX:
        return int(float(v[:-1]) * _POSTFIX[v[-1].upper()])
    raise ValueError(f"cannot parse size {value!r}")


def iter_articles(path: str) -> Iterator[List[str]]:
    """Yield articles (lists of sentence lines) from a formatted file."""
    article: List[str] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                article.append(line.rstrip("\n"))
            elif article:
                yield article
                article = []
    if article:
        yield article


def shard(input_file: str, output_format: str, bytes_per_shard: int,
          max_shards: Optional[int] = None) -> int:
    """Write shards of ~bytes_per_shard, cutting only between articles.
    Returns the shard count."""
    if "{index}" not in output_format:
        raise ValueError("output_format must contain '{index}'")
    out_dir = os.path.dirname(output_format)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    index = 1
    out = open(output_format.format(index=index), "w", encoding="utf-8")
    written = 0
    try:
        for article in iter_articles(input_file):
            if written > bytes_per_shard:
                out.close()
                index += 1
                if max_shards is not None and index > max_shards:
                    return index - 1
                out = open(output_format.format(index=index), "w",
                           encoding="utf-8")
                written = 0
            for line in article:
                written += out.write(line + "\n")
            written += out.write("\n")
    finally:
        out.close()
    return index


def sample_and_shard(input_files: List[str], output_format: str,
                     sentence_budget: int, bytes_per_shard: int,
                     seed: int = 0) -> int:
    """Randomly keep whole articles until ~sentence_budget sentences, then
    shard the sample. Articles are shuffled across all input files."""
    rng = random.Random(seed)
    articles: List[List[str]] = []
    for path in input_files:
        articles.extend(iter_articles(path))
    rng.shuffle(articles)

    kept: List[List[str]] = []
    total = 0
    for a in articles:
        if total >= sentence_budget:
            break
        kept.append(a)
        total += len(a)

    tmp = output_format.format(index=0) + ".sample"
    with open(tmp, "w", encoding="utf-8") as f:
        for a in kept:
            for line in a:
                f.write(line + "\n")
            f.write("\n")
    n = shard(tmp, output_format, bytes_per_shard)
    os.remove(tmp)
    print(f"[sample_and_shard] kept {len(kept)} articles "
          f"({total} sentences) in {n} shards")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-f", "--format", default="shard_{index}.txt")
    p.add_argument("-b", "--size", default="100M")
    p.add_argument("-n", "--max_shards", type=int, default=None)
    p.add_argument("--sample_sentences", default=None,
                   help="if set, subsample to this many sentences first "
                        "(accepts 10M-style values)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    fmt = os.path.join(args.output, args.format)
    size = parse_size(args.size)
    if args.sample_sentences:
        n = sample_and_shard([args.input], fmt,
                             parse_size(args.sample_sentences), size,
                             seed=args.seed)
    else:
        n = shard(args.input, fmt, size, args.max_shards)
    print(f"[shard] wrote {n} shards to {args.output}")


if __name__ == "__main__":
    main()
