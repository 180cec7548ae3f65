"""Raw corpora -> one-sentence-per-line shards with blank lines between
articles (the format the sharder and encoder consume; counterpart of
bert_pytorch_tpu/pipeline/format.py).

    python -m bert_pytorch_tpu_torch.pipeline.format --input_dir DIR \
        --output_dir OUT [--kind wiki|text] [--shards N]

Reference utils/format.py: nltk sent_tokenize over joined lines (:13-16),
round-robin input files across output shards, multiprocessing pool
(:28-124). WikiCorpusFormatter consumes wikiextractor output (<doc> blocks);
BooksCorpusFormatter treats each file as one article.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import re
from pathlib import Path
from typing import List


def split_sentences(lines: List[str]) -> List[str]:
    """nltk's sent_tokenize where nltk and its punkt data are installed,
    else a split at sentence-final punctuation before a capital."""
    text = " ".join(lines).replace("\n", " ")
    try:
        from nltk.tokenize import sent_tokenize

        return [s.strip() for s in sent_tokenize(text)]
    except (ImportError, LookupError):
        # regex fallback: split on sentence-final punctuation + space + upper
        parts = re.split(r"(?<=[.!?])\s+(?=[A-Z\"'(])", text)
        return [s.strip() for s in parts if s.strip()]


def _write_article(out, sentences: List[str]) -> None:
    if not sentences:
        return
    for s in sentences:
        out.write(s + "\n")
    out.write("\n")


def format_wiki_files(input_files: List[str], output_file: str) -> int:
    """wikiextractor output (<doc ...> text </doc>) -> formatted shard.
    Returns article count."""
    n = 0
    with open(output_file, "w", encoding="utf-8") as out:
        for path in input_files:
            with open(path, "r", encoding="utf-8") as f:
                article: List[str] = []
                in_doc = False
                for line in f:
                    if line.startswith("<doc"):
                        in_doc = True
                        article = []
                        continue
                    if line.startswith("</doc"):
                        in_doc = False
                        # first line is the title — drop it (not prose)
                        _write_article(out, split_sentences(article[1:]))
                        n += 1
                        continue
                    if in_doc and line.strip():
                        article.append(line)
    return n


def format_text_files(input_files: List[str], output_file: str) -> int:
    """Plain text, one article per file (BooksCorpus layout)."""
    n = 0
    with open(output_file, "w", encoding="utf-8") as out:
        for path in input_files:
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                _write_article(out, split_sentences(f.readlines()))
                n += 1
    return n


_FORMATTERS = {"wiki": format_wiki_files, "text": format_text_files}


def _run_one(params):
    kind, files, output_file = params
    n = _FORMATTERS[kind](files, output_file)
    print(f"[format] {output_file}: {n} articles")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--kind", default="wiki", choices=sorted(_FORMATTERS))
    p.add_argument("--shards", type=int, default=-1,
                   help="output shard count (default: one per input file)")
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--name", default="corpus")
    args = p.parse_args(argv)

    files = sorted(str(f) for f in Path(args.input_dir).rglob("*")
                   if f.is_file())
    if not files:
        raise SystemExit(f"no files under {args.input_dir}")
    shards = args.shards if args.shards > 0 else len(files)
    shards = min(shards, len(files))
    os.makedirs(args.output_dir, exist_ok=True)

    buckets: List[List[str]] = [[] for _ in range(shards)]
    for i, f in enumerate(files):
        buckets[i % shards].append(f)
    params = [
        (args.kind, bucket,
         os.path.join(args.output_dir,
                      f"{args.name}_one_sentence_per_line_{i}.txt"))
        for i, bucket in enumerate(buckets)]
    with mp.get_context("spawn").Pool(processes=args.processes) as pool:
        counts = pool.map(_run_one, params)
    print(f"[format] {sum(counts)} articles across {shards} shards")


if __name__ == "__main__":
    main()
