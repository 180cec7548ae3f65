"""The port's vocabulary trainer (bert_pytorch_tpu_torch/pipeline/vocab.py)
against the JAX package's bert_pytorch_tpu.pipeline.vocab on local
corpora: train_wordpiece (gain and ratio scores) and train_bpe with the
native merge engine and with the Python one equal JAX's under both of its
engines; the CLIs' files byte for byte; the saved vocab.txt and
vocab.json + merges.txt read back by the port's factories (the native
encoders), whose ids equal JAX's tokenizers'."""

import os
import random
import sys

import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.data import tokenization as jtok  # noqa: E402
from bert_pytorch_tpu.pipeline import vocab as jvocab  # noqa: E402
from bert_pytorch_tpu_torch import native  # noqa: E402
from bert_pytorch_tpu_torch.data import tokenization as ttok  # noqa: E402
from bert_pytorch_tpu_torch.pipeline import vocab as pvocab  # noqa: E402

TEXT = ("the quick brown fox jumps over the lazy dog "
        "aaa aaaa aaaaa banana bananas cafe caffe café caffè "
        "ThE THE the thee them theme schema schemas scheme "
        "日本語 токенизация naïve coöperate zzz zz z it's o'brien "
        "a b 1999 2024 3.14 ") * 7 + "rare1 rare2 rare3 onlyonce "


def _random_counts(seed, n_words=300):
    rng = random.Random(seed)
    out = {}
    for _ in range(n_words):
        w = "".join(rng.choice("abcdefghé日") for _ in range(rng.randrange(1, 9)))
        out[w] = out.get(w, 0) + rng.randrange(1, 50)
    out.update({"aaaa": 40, "aaaaaa": 7, "a": 99, "zz": 3})
    return out


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "corpus.txt"
    rng = random.Random(4)
    words = TEXT.split()
    path.write_text("\n".join(" ".join(rng.choice(words) for _ in range(12))
                              for _ in range(200)) + "\n" + TEXT + "\n",
                    encoding="utf-8")
    return str(path)


def _jax(monkeypatch, native_engine, fn, *args, **kw):
    """JAX's trainer on its native engine or, under BPT_NATIVE=0, its
    Python one."""
    monkeypatch.setenv("BPT_NATIVE", "1" if native_engine else "0")
    return fn(*args, **kw)


def _counts(corpus_file, lowercase=True):
    counts = pvocab.count_words([corpus_file], lowercase=lowercase)
    assert counts == jvocab.count_words([corpus_file], lowercase=lowercase)
    return counts


@pytest.mark.parametrize("lowercase", [True, False])
def test_train_wordpiece_equals_jax(corpus_file, monkeypatch, lowercase):
    counts = _counts(corpus_file, lowercase)
    want = _jax(monkeypatch, False, jvocab.train_wordpiece, counts, 240)
    assert _jax(monkeypatch, True, jvocab.train_wordpiece, counts, 240) \
        == want
    assert pvocab.train_wordpiece(counts, 240) == want
    assert pvocab.train_wordpiece(counts, 240, native=False) == want
    assert len(want) > 150        # merges ran until no pair was left
    ratio = _jax(monkeypatch, False, jvocab.train_wordpiece, counts, 200,
                 score="ratio")
    assert pvocab.train_wordpiece(counts, 200, score="ratio") == ratio


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_on_random_counts_equals_jax(monkeypatch, seed):
    counts = _random_counts(seed)
    for kw in ({"min_pair_frequency": 1}, {"min_frequency": 3}):
        want = _jax(monkeypatch, False, jvocab.train_wordpiece, counts, 150,
                    special_tokens=("[PAD]",), **kw)
        for engine in (True, False):
            assert pvocab.train_wordpiece(counts, 150,
                                          special_tokens=("[PAD]",),
                                          native=engine, **kw) == want
    want = _jax(monkeypatch, False, jvocab.train_bpe, counts, 400,
                special_tokens=("<unk>",))
    for engine in (True, False):
        assert pvocab.train_bpe(counts, 400, special_tokens=("<unk>",),
                                native=engine) == want


def test_train_bpe_equals_jax(corpus_file, monkeypatch):
    counts = _counts(corpus_file)
    want = _jax(monkeypatch, False, jvocab.train_bpe, counts, 330)
    assert _jax(monkeypatch, True, jvocab.train_bpe, counts, 330) == want
    for engine in (True, False):
        vocab, merges = pvocab.train_bpe(counts, 330, native=engine)
        assert (vocab, merges) == want
    assert len(want[0]) == 330 and len(want[1]) > 50


@pytest.mark.parametrize("kind", ["wordpiece", "bpe"])
def test_cli_files_equal_jax_and_read_back(corpus_file, tmp_path, kind):
    """Both CLIs write the same files; the port's factory reads them back
    as its native encoder, whose ids equal JAX's tokenizer's."""
    name = "vocab.txt" if kind == "wordpiece" else "vocab.json"
    argv = ["-i", corpus_file, "-s", "300", "--tokenizer", kind]
    pvocab.main(argv + ["-o", str(tmp_path / "p" / name)])
    jvocab.main(argv + ["-o", str(tmp_path / "j" / name)])
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == files
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    path = str(tmp_path / "p" / name)
    tok = ttok.TOKENIZERS[kind](path)
    if kind == "wordpiece":
        assert isinstance(tok, native.NativeWordPieceTokenizer)
        assert [ln for ln in open(path, encoding="utf-8")][:5] == \
            ["[PAD]\n", "[UNK]\n", "[CLS]\n", "[SEP]\n", "[MASK]\n"]
        ref = jtok.BertWordPieceTokenizer(path)
    else:
        assert isinstance(tok, native.NativeByteLevelBPETokenizer)
        ref = jtok.ByteLevelBPETokenizer(
            path, str(tmp_path / "p" / "merges.txt"), lowercase=True)
    unk = tok.token_to_id("[UNK]" if kind == "wordpiece" else "<unk>")
    lines = open(corpus_file, encoding="utf-8").read().splitlines()
    for line in lines[:50] + lines[-1:]:
        ids = tok.encode_ids(line)
        assert ids == ref.encode(line).ids
        assert kind == "bpe" or unk not in ids
