"""The port's native C++ tokenizers (bert_pytorch_tpu_torch/native): the
WordPiece encoder (uncased and cased) and the byte-level BPE encoder
against the port's Python classes and the JAX package's
data/tokenization classes on curated and seeded fuzz texts (CJK, accents,
controls, a BPE vocabulary with gaps in its ids), through encode,
encode_batch, encode_batch_arrays and encode_ids; the factories returning
them; a failed build raising with the compiler's error (no fallback);
a tokenizer pickled into a spawned process; the generated Unicode header
regenerated byte for byte; nothing built at import."""

import json
import multiprocessing as mp
import os
import pickle
import random
import subprocess
import sys

import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.data import tokenization as jtok  # noqa: E402
from bert_pytorch_tpu_torch import native  # noqa: E402
from bert_pytorch_tpu_torch.data import tokenization as ttok  # noqa: E402
from bert_pytorch_tpu_torch.native import build as nbuild  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VOCAB = {t: i for i, t in enumerate(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
     "the", "quick", "brown", "fox", "jump", "##ed", "##s", "over", "lazy",
     "dog", "un", "##aff", "##able", "run", "##ning", ",", ".", "!", "?",
     "h", "##e", "##l", "##o", "caf", "##e", "你", "好", "Caf", "The",
     "İ", "ß", "ǅ", "##ß"])}

CURATED = [
    "The quick brown fox jumped over the lazy dog.",
    "unaffable, running!  hello?",
    "Café CAFÉ café café",          # precomposed and combining accents
    "你好 world 東京",                     # CJK spacing
    "  weird\tspacing and​ stuff  ",  # nbsp, zero-width format
    "İstanbul İ ǅ ß ẞ",                   # one-to-many lowercasing
    "", "   ", "!!!", "\n\n",
    "x" * 250,                            # over max_input_chars_per_word
    "a\x00b � c\x07d\x1fe",          # NUL, U+FFFD, controls
    "ΟΔΟΣ ΟΔΟΣ. Σ'Σ abcΣ",
]

FUZZ_POOLS = (list(range(32, 127)),
              [0x00E9, 0x0130, 0x00DF, 0x4E2D, 0x6587, 0x0301, 0x05D0,
               0x0416, 0x1F600, 0x2014, 0xA0, 0x200B, 0x3000, 0xFFFD, 0x0,
               0x7, 0x1F, 0x85, 0x2028, 0x03A3, 0x01C5, 0xAC00, 0x0E01])


def fuzz_texts(seed: int, n: int, max_len: int = 60):
    rng = random.Random(seed)
    return ["".join(chr(rng.choice(rng.choice(FUZZ_POOLS)))
                    for _ in range(rng.randint(0, max_len)))
            for _ in range(n)]


def _fields(enc):
    return (enc.ids, enc.tokens, [tuple(o) for o in enc.offsets],
            enc.type_ids)


@pytest.fixture(scope="module", params=[True, False],
                ids=["uncased", "cased"])
def wordpiece(request):
    lower = request.param
    return (native.NativeWordPieceTokenizer(VOCAB, lowercase=lower),
            ttok.BertWordPieceTokenizer(VOCAB, lowercase=lower),
            jtok.BertWordPieceTokenizer(VOCAB, lowercase=lower))


def test_wordpiece_encode_equals_python_and_jax(wordpiece):
    nat, py, jx = wordpiece
    texts = CURATED + fuzz_texts(0, 300)
    for text in texts:
        want = _fields(jx.encode(text))
        assert _fields(py.encode(text)) == want, repr(text)
        assert _fields(nat.encode(text)) == want, repr(text)
        assert nat.encode_ids(text) == want[0]
        bare = jx.encode(text, add_special_tokens=False)
        assert _fields(nat.encode(text, add_special_tokens=False)) == \
            _fields(bare), repr(text)
        assert nat.encode_ids(text, add_special_tokens=False) == bare.ids
        assert py.encode_ids(text, add_special_tokens=False) == bare.ids


def test_wordpiece_pairs_and_batches_equal_jax(wordpiece):
    nat, _, jx = wordpiece
    texts = CURATED + fuzz_texts(1, 120)
    pairs = [t if i % 3 else None for i, t in
             enumerate(reversed(texts))]
    for a, b in zip(texts, pairs):
        assert _fields(nat.encode(a, pair=b)) == _fields(jx.encode(a, pair=b))
    for threads in (1, 4):
        got = nat.encode_batch(texts, pairs, nthreads=threads)
        assert [_fields(e) for e in got] == \
            [_fields(jx.encode(a, pair=b)) for a, b in zip(texts, pairs)]
        lens, ids, types, starts, ends = nat.encode_batch_arrays(
            texts, pairs, add_special_tokens=False, nthreads=threads)
        off = 0
        for a, b, n in zip(texts, pairs, lens.tolist()):
            want = jx.encode(a, pair=b, add_special_tokens=False)
            assert ids[off:off + n].tolist() == want.ids
            assert types[off:off + n].tolist() == want.type_ids
            assert list(zip(starts[off:off + n].tolist(),
                            ends[off:off + n].tolist())) == \
                [tuple(o) for o in want.offsets]
            off += n
        assert off == len(ids)
    assert nat.encode_batch([]) == []
    assert [len(a) for a in nat.encode_batch_arrays([])] == [0] * 5


def test_wordpiece_vocab_with_gaps_and_duplicates(tmp_path):
    """A vocab file with a duplicated line (load_vocab keeps the last id,
    the first is a gap) and a dict with a gap keep every id."""
    lines = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "dog", "the", "dog", "run"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    gapped = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "the": 9,
              "dog": 40}
    for vocab in (str(path), gapped):
        nat = native.NativeWordPieceTokenizer(vocab)
        jx = jtok.BertWordPieceTokenizer(vocab)
        for text in ("the dog ran", "run dog the cat", ""):
            assert _fields(nat.encode(text)) == _fields(jx.encode(text))
    assert native.NativeWordPieceTokenizer(str(path)).encode_ids("dog") == \
        [2, 6, 3]


def _tiny_bpe():
    byte_syms = list(jtok.bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e"), ("h", "e"), ("i", "n"),
              ("e", "r"), ("Ġ", "a"), ("r", "e"), ("o", "n"), ("Ġa", "n"),
              ("e", "n"), ("Ġ", "s"), ("a", "t"), ("o", "r"), ("Ġ", "w"),
              ("n", "d"), ("Ġan", "d"), ("o", "u"), ("in", "g"), ("1", "2"),
              ("12", "3"), ("z", "z")]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for s in byte_syms:
        vocab.setdefault(s, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["zz"] = 500      # a gap: the ids jump from ~280 to 500
    return vocab, merges


BPE_CURATED = CURATED + [
    "it's we're I'll you've don't I'm he'd 'quoted' O'Brien's",
    "numbers 123 and 456.789 fizz buzz", "'", "''", "tab\t\tnewline\n\ndone",
    "ümlaut Ångström 東京 العربية 😀 emoji",
]


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("prefix", [True, False])
def test_bpe_equals_python_and_jax(lowercase, prefix):
    vocab, merges = _tiny_bpe()
    kw = dict(lowercase=lowercase, add_prefix_space=prefix)
    nat = native.NativeByteLevelBPETokenizer(vocab, merges, **kw)
    py = ttok.ByteLevelBPETokenizer(vocab, merges, **kw)
    jx = jtok.ByteLevelBPETokenizer(vocab, merges, **kw)
    rng = random.Random(2)
    alphabet = ("abcdefghijklmnopqrstuvwxyz ABC   '\t\n.,!?0123456789"
                "éÉ你好İıΣ​�")
    texts = BPE_CURATED + ["".join(rng.choice(alphabet)
                                   for _ in range(rng.randrange(0, 80)))
                           for _ in range(300)]
    for text in texts:
        want = jx.encode(text)
        assert (py.encode(text).ids, py.encode(text).tokens) == \
            (want.ids, want.tokens), repr(text)
        got = nat.encode(text)
        assert (got.ids, got.tokens) == (want.ids, want.tokens), repr(text)
        assert nat.encode_ids(text) == want.ids
    assert 500 in nat.encode_ids("fizz buzz")
    batch = nat.encode_batch(texts, nthreads=4)
    assert [e.ids for e in batch] == [jx.encode(t).ids for t in texts]
    lens, ids = nat.encode_batch_arrays(texts, nthreads=4)
    assert ids.tolist() == [i for t in texts for i in jx.encode(t).ids]
    assert lens.tolist() == [len(jx.encode(t).ids) for t in texts]


def test_bpe_piece_missing_from_the_vocab_goes_through_python():
    vocab, merges = _tiny_bpe()
    vocab.pop("X")
    nat = native.NativeByteLevelBPETokenizer(vocab, merges)
    jx = jtok.ByteLevelBPETokenizer(vocab, merges)
    want = jx.encode("aXb")
    assert (nat.encode("aXb").ids, nat.encode("aXb").tokens) == \
        (want.ids, want.tokens)           # the raw 'X' piece, not '<unk>'
    assert nat.encode_ids("aXb") == want.ids
    assert [e.tokens for e in nat.encode_batch(["aXb", "ab"])] == \
        [want.tokens, jx.encode("ab").tokens]
    lens, ids = nat.encode_batch_arrays(["aXb", "ab"])
    assert ids[:lens[0]].tolist() == want.ids


def test_factories_return_the_native_encoders(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(sorted(VOCAB, key=VOCAB.get)) + "\n",
                    encoding="utf-8")
    tok = ttok.TOKENIZERS["wordpiece"](str(path))
    assert isinstance(tok, native.NativeWordPieceTokenizer)
    assert tok.basic.do_lower_case
    assert not ttok.get_wordpiece_tokenizer(
        str(path), uppercase=True).basic.do_lower_case
    vocab, merges = _tiny_bpe()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    bpe = ttok.TOKENIZERS["bpe"](str(tmp_path / "vocab.json"))
    assert isinstance(bpe, native.NativeByteLevelBPETokenizer)
    assert bpe.encode_ids("The Thing") == jtok.ByteLevelBPETokenizer(
        vocab, merges, lowercase=True).encode("The Thing").ids


FAKE_CXX = """#!/bin/sh
echo "wordpiece.cc:1:1: error: planted compiler failure" >&2
exit 1
"""


def test_failed_build_raises_with_the_compilers_error(tmp_path, monkeypatch):
    """A compiler that refuses the source: the build, the loader and the
    factory raise naming its error; nothing falls back to Python."""
    cxx = tmp_path / "fake-cxx"
    cxx.write_text(FAKE_CXX)
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(nbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(nbuild.NativeBuildError, match="planted compiler"):
        nbuild.build("wordpiece")
    with pytest.raises(nbuild.NativeBuildError, match="planted compiler"):
        ttok.get_wordpiece_tokenizer(VOCAB)
    vocab, merges = _tiny_bpe()
    with pytest.raises(nbuild.NativeBuildError, match="exit 1"):
        ttok.get_bpe_tokenizer(vocab, merges)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(nbuild.NativeBuildError, match="no-such-compiler"):
        nbuild.build("vocab_trainer")
    assert os.listdir(tmp_path / "build") == []   # no partial library


def test_build_is_keyed_by_the_sources_and_whole(tmp_path, monkeypatch):
    """A library is named by its sources' sha256; concurrent builds (four
    threads forcing a rebuild) leave one whole library that loads."""
    import threading

    monkeypatch.setattr(nbuild, "BUILD_DIR", str(tmp_path / "build"))
    path = nbuild.build("vocab_trainer")
    assert os.path.basename(path) == \
        f"_vocab_trainer.{nbuild.source_digest('vocab_trainer')[:16]}.so"
    errors = []

    def rebuild():
        try:
            nbuild.build("vocab_trainer", force=True)
        except Exception as e:  # noqa: BLE001 (collected, asserted below)
            errors.append(e)

    threads = [threading.Thread(target=rebuild) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert os.listdir(tmp_path / "build") == [os.path.basename(path)]
    import ctypes

    ctypes.CDLL(path).vt_free


def _encode_in_child(tok, texts):
    return [tok.encode_ids(t) for t in texts], [
        e.tokens for e in tok.encode_batch(texts)]


def test_pickled_tokenizers_encode_in_a_spawned_process():
    """The server's Featurizer hands its tokenizer to spawned workers:
    the native handle is dropped by pickling and reopened there."""
    wp = native.NativeWordPieceTokenizer(VOCAB)
    vocab, merges = _tiny_bpe()
    bpe = native.NativeByteLevelBPETokenizer(vocab, merges)
    texts = CURATED[:6]
    assert "_handle" not in pickle.loads(pickle.dumps(wp)).__getstate__()
    with mp.get_context("spawn").Pool(1) as pool:
        for tok in (wp, bpe):
            ids, tokens = pool.apply(_encode_in_child, (tok, texts))
            assert ids == [tok.encode_ids(t) for t in texts]
            assert tokens == [e.tokens for e in tok.encode_batch(texts)]


def test_unicode_tables_regenerate_byte_for_byte(tmp_path):
    from bert_pytorch_tpu_torch.native import gen_unicode_tables

    out = tmp_path / "unicode_tables.h"
    gen_unicode_tables.main(str(out))
    with open(nbuild.HEADER, "rb") as f:
        assert out.read_bytes() == f.read()


def test_importing_the_port_builds_nothing(tmp_path):
    """Importing native/, pipeline/ and the tokenization module compiles
    and loads no library (the build directory pointed elsewhere stays
    empty, no library is loaded)."""
    code = (
        "import bert_pytorch_tpu_torch.native.build as b, sys\n"
        f"b.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
        "import bert_pytorch_tpu_torch.native as n\n"
        "import bert_pytorch_tpu_torch.pipeline.encode, "
        "bert_pytorch_tpu_torch.pipeline.vocab, "
        "bert_pytorch_tpu_torch.pipeline.format, "
        "bert_pytorch_tpu_torch.pipeline.shard, "
        "bert_pytorch_tpu_torch.data.streaming\n"
        "assert n._libs == {}, n._libs\n"
        "import os; assert not os.path.exists(b.BUILD_DIR)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
