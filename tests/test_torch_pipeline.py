"""The port's offline corpus pipeline (bert_pytorch_tpu_torch/pipeline:
format, shard, encode) against the JAX package's bert_pytorch_tpu.pipeline
on the same seeded local text and seeds: the formatted and sharded files
byte for byte, the samples field for field (the port's native WordPiece
and its Python class against JAX's Python class), the HDF5 shards' arrays
(and the CLIs' outputs, whose pools are spawned); the port's
data/sharded.ShardIndex reading a JAX-written and a port-written shard as
equal batches, and one 2-layer, width-64 CPU pretraining step on the
port's shards."""

import json
import os
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.data import tokenization as jtok  # noqa: E402
from bert_pytorch_tpu.pipeline import encode as jencode  # noqa: E402
from bert_pytorch_tpu.pipeline import format as jformat  # noqa: E402
from bert_pytorch_tpu.pipeline import shard as jshard  # noqa: E402
from bert_pytorch_tpu_torch import native  # noqa: E402
from bert_pytorch_tpu_torch import run_pretraining  # noqa: E402
from bert_pytorch_tpu_torch.data import tokenization as ttok  # noqa: E402
from bert_pytorch_tpu_torch.data.sharded import (  # noqa: E402
    HostShardSampler, PretrainingDataLoader, ShardIndex)
from bert_pytorch_tpu_torch.pipeline import encode  # noqa: E402
from bert_pytorch_tpu_torch.pipeline import format as pformat  # noqa: E402
from bert_pytorch_tpu_torch.pipeline import shard  # noqa: E402
from bert_pytorch_tpu_torch.pipeline import vocab as pvocab  # noqa: E402

WORDS = ("the cat sat on a mat while dog ran in park and red blue green "
         "river bridge north south morning evening people walked across "
         "old new market street train station café naïve 東京 İstanbul "
         "running jumped unaffable").split()


def _sentence(rng) -> str:
    words = [rng.choice(WORDS) for _ in range(rng.randint(3, 14))]
    return " ".join(words).capitalize() + rng.choice([".", "!", "?"])


def raw_corpus(root: Path, seed: int = 0):
    """Two wikiextractor-style files (<doc> blocks, a title line) and two
    plain-text books, from `seed`."""
    rng = random.Random(seed)
    (root / "wiki").mkdir(parents=True)
    (root / "books").mkdir(parents=True)
    for f in range(2):
        docs = []
        for d in range(12):
            lines = [" ".join(_sentence(rng) for _ in range(rng.randint(1, 4)))
                     for _ in range(rng.randint(1, 6))]
            docs.append(f'<doc id="{f}{d}" title="T{d}">\nTitle {d}\n'
                        + "\n".join(lines) + "\n</doc>\n")
        (root / "wiki" / f"wiki_{f:02d}").write_text("".join(docs),
                                                     encoding="utf-8")
        (root / "books" / f"book_{f}.txt").write_text(
            "\n".join(_sentence(rng) for _ in range(40)), encoding="utf-8")
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The raw corpus, formatted (wiki) and sharded by the port, and a
    WordPiece vocabulary the port trained from the shards."""
    root = raw_corpus(tmp_path_factory.mktemp("pipeline"))
    wiki = sorted(str(p) for p in (root / "wiki").iterdir())
    pformat.format_wiki_files(wiki, str(root / "formatted.txt"))
    n = shard.shard(str(root / "formatted.txt"),
                    str(root / "shards" / "shard_{index}.txt"), 1500)
    shards = [str(root / "shards" / f"shard_{i}.txt")
              for i in range(1, n + 1)]
    counts = pvocab.count_words(shards)
    vocab = pvocab.train_wordpiece(counts, 200)
    pvocab.save_wordpiece_vocab(vocab, str(root / "vocab.txt"))
    return {"root": root, "wiki": wiki, "shards": shards,
            "vocab": str(root / "vocab.txt")}


def test_format_equals_jax_byte_for_byte(corpus, tmp_path):
    root = corpus["root"]
    jformat.format_wiki_files(corpus["wiki"], str(tmp_path / "jax.txt"))
    assert (tmp_path / "jax.txt").read_bytes() == \
        (root / "formatted.txt").read_bytes()
    books = sorted(str(p) for p in (root / "books").iterdir())
    assert pformat.format_text_files(books, str(tmp_path / "p.txt")) == \
        jformat.format_text_files(books, str(tmp_path / "j.txt")) == 2
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    text = (root / "formatted.txt").read_text(encoding="utf-8")
    assert text.count("\n\n") == 24          # one article a <doc>
    assert pformat.split_sentences(["A b. C d! e f? G"]) == \
        jformat.split_sentences(["A b. C d! e f? G"])


def test_format_cli_equals_jax(corpus, tmp_path):
    """The CLI (its pool spawned) writes what JAX's writes, shard for
    shard (round-robin input files)."""
    inp = str(corpus["root"] / "wiki")
    pformat.main(["--input_dir", inp, "--output_dir", str(tmp_path / "p"),
                  "--shards", "2", "--processes", "2"])
    jformat.main(["--input_dir", inp, "--output_dir", str(tmp_path / "j"),
                  "--shards", "2", "--processes", "2"])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names and len(names) == 2
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


def test_shard_equals_jax_byte_for_byte(corpus, tmp_path):
    src = str(corpus["root"] / "formatted.txt")
    for size, cap in ((1500, None), (800, 2), (10 ** 9, None)):
        p = shard.shard(src, str(tmp_path / f"p{size}" / "s_{index}.txt"),
                        size, cap)
        j = jshard.shard(src, str(tmp_path / f"j{size}" / "s_{index}.txt"),
                         size, cap)
        assert p == j
        for i in range(1, p + 1):
            assert (tmp_path / f"p{size}" / f"s_{i}.txt").read_bytes() == \
                (tmp_path / f"j{size}" / f"s_{i}.txt").read_bytes()
    assert len(corpus["shards"]) >= 2
    (tmp_path / "ps").mkdir()
    (tmp_path / "js").mkdir()       # as the CLI makes its output directory
    p = shard.sample_and_shard([src], str(tmp_path / "ps" / "s_{index}.txt"),
                               30, 600, seed=5)
    j = jshard.sample_and_shard([src], str(tmp_path / "js" / "s_{index}.txt"),
                                30, 600, seed=5)
    assert p == j
    for i in range(1, p + 1):
        assert (tmp_path / "ps" / f"s_{i}.txt").read_bytes() == \
            (tmp_path / "js" / f"s_{i}.txt").read_bytes()
    for v in ("100M", "2K", "1.5B", 7, "12"):
        assert shard.parse_size(v) == jshard.parse_size(v)


def _sample_fields(s):
    return (s.seq_tokens, s.next_seq_tokens, s.is_random_next, s.sequence,
            s.special_token_positions)


@pytest.mark.parametrize("nsp,short", [(0.5, 0.1), (0.0, 0.3)])
def test_create_samples_equal_jax(corpus, nsp, short):
    """Native and Python WordPiece give JAX's samples, field for field,
    per shard with JAX's seed + i."""
    nat = ttok.get_wordpiece_tokenizer(corpus["vocab"])
    assert isinstance(nat, native.NativeWordPieceTokenizer)
    py = ttok.BertWordPieceTokenizer(corpus["vocab"])
    jx = jtok.BertWordPieceTokenizer(corpus["vocab"])
    total = 0
    for i, path in enumerate(corpus["shards"]):
        want = jencode.create_samples(path, jx, 48, nsp, short, seed=3 + i)
        for tok in (nat, py):
            got = encode.create_samples(path, tok, 48, nsp, short,
                                        seed=3 + i)
            assert [_sample_fields(s) for s in got] == \
                [_sample_fields(s) for s in want]
        total += len(want)
        if nsp:
            assert any(s.is_random_next for s in want)
    assert total > 20


def _h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: (f[k][()], f[k].dtype.str, f[k].compression)
                for k in f}


def test_write_hdf5_and_sample_arrays_equal_jax(corpus, tmp_path):
    tok = ttok.get_wordpiece_tokenizer(corpus["vocab"])
    jx = jtok.BertWordPieceTokenizer(corpus["vocab"])
    path = corpus["shards"][0]
    samples = encode.create_samples(path, tok, 64, 0.5, 0.1, seed=1)
    n = encode.write_hdf5(str(tmp_path / "p.hdf5"), samples, tok, 64)
    jencode.write_hdf5(str(tmp_path / "j.hdf5"),
                       jencode.create_samples(path, jx, 64, 0.5, 0.1,
                                              seed=1), jx, 64)
    got, want = _h5(tmp_path / "p.hdf5"), _h5(tmp_path / "j.hdf5")
    assert set(got) == set(want) == {"input_ids", "special_token_positions",
                                     "next_sentence_labels"}
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
        assert got[k][1:] == want[k][1:] and got[k][2] == "gzip"
    assert (want["input_ids"][1], want["special_token_positions"][1],
            want["next_sentence_labels"][1]) == ("<i4", "<i4", "|i1")
    arrays = encode.sample_arrays(samples, tok, 64)
    assert n == len(arrays["input_ids"])
    for k, v in arrays.items():
        assert v.dtype.str == want[k][1]
        np.testing.assert_array_equal(v, want[k][0], err_msg=k)


@pytest.fixture(scope="module")
def cli_shards(corpus, tmp_path_factory):
    """The encode CLI of each package over the port's text shards, seed 11
    (a shard's seed is 11 + its index); the port's pool is spawned."""
    root = tmp_path_factory.mktemp("encoded")
    out = {}
    for name, mod in (("port", encode), ("jax", jencode)):
        mod.main(["--input_dir", str(Path(corpus["shards"][0]).parent),
                  "--output_dir", str(root / name), "--vocab_file",
                  corpus["vocab"], "--max_seq_len", "32",
                  "--next_seq_prob", "0.5", "--seed", "11",
                  "--processes", "2"])
        (sub,) = os.listdir(root / name)
        assert sub == "sequences_lowercase_max_seq_len_32_next_seq_task_true"
        out[name] = sorted(str(p) for p in (root / name / sub).iterdir())
    return out


def test_encode_cli_equals_jax(cli_shards):
    assert len(cli_shards["port"]) == len(cli_shards["jax"]) >= 2
    for p, j in zip(cli_shards["port"], cli_shards["jax"]):
        assert os.path.basename(p) == os.path.basename(j)
        got, want = _h5(p), _h5(j)
        for k in want:
            np.testing.assert_array_equal(got[k][0], want[k][0])
            assert got[k][1:] == want[k][1:]


def test_shard_index_reads_jax_and_port_shards_as_equal_batches(cli_shards):
    def batches(files):
        index = ShardIndex(files)
        loader = PretrainingDataLoader(
            index, HostShardSampler(index.total, seed=4), batch_size=8,
            mask_token_index=4, max_pred_per_seq=5, masked_lm_prob=0.15,
            vocab_size=200, seed=2)
        return [next(loader) for _ in range(3)]

    got, want = batches(cli_shards["port"]), batches(cli_shards["jax"])
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pretraining_step_on_the_ports_shards(corpus, cli_shards, tmp_path):
    """run_pretraining --input_dir over the CLI's shards: 2 layers, width
    64, one step, a finite loss; the [MASK] id read from the vocab."""
    cfg = dict(vocab_size=200, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=128,
               max_position_embeddings=64, next_sentence=True,
               vocab_file=corpus["vocab"])
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    lines = []
    result = run_pretraining.main([
        "--model_config_file", str(tmp_path / "cfg.json"),
        "--input_dir", str(Path(cli_shards["port"][0]).parent),
        "--output_dir", str(tmp_path / "out"), "--local_batch_size", "8",
        "--global_batch_size", "8", "--max_predictions_per_seq", "5",
        "--max_steps", "1", "--steps", "1", "--dtype", "float32",
        "--skip_checkpoint", "--seed", "0", "--log_freq", "1",
        "--device", "cpu"], log=lines.append)
    assert len(result.history) == 1
    assert np.isfinite(result.history[0]["loss"])


def test_chip_smoke_pipeline_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's pipeline phase at a tiny width on the CPU (the
    launch counts are checked on the card only): the builds, format ->
    shard -> vocab by both engines, the samples native against Python,
    the tokens/s, two trainer steps over the samples in memory."""
    import torch

    import chip_smoke

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(
        vocab_size=512, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=128, next_sentence=True)))
    summary = {}
    chip_smoke.phase_pipeline(torch, np, summary, device="cpu",
                              cut_cfg_path=str(cfg), micro=4, docs=60)
    res = summary["pipeline"]
    assert set(res["build_s"]) == {"wordpiece", "bpe", "vocab_trainer"}
    assert res["articles"] == 60 and res["shards"] >= 1
    assert res["samples_native"]["samples"] == \
        res["samples_python"]["samples"] > 16
    assert set(res["tokens_per_s"]) == {"wordpiece", "bpe"}
    assert len(res["losses"]) == chip_smoke.PIPELINE_STEPS
    assert summary["launches"]["pipeline"] == res["launches"]
