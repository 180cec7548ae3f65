"""The C++ tokenizers behind data/tokenization.py's factories (counterpart
of bert_pytorch_tpu/native, the same C ABI over ctypes).

- `NativeWordPieceTokenizer`: WordPiece whose encode paths run in C++,
  equal to `BertWordPieceTokenizer` in ids, tokens, offsets and type ids.
- `NativeByteLevelBPETokenizer`: byte-level BPE in C++, equal to
  `ByteLevelBPETokenizer` in ids (a text with a piece the vocabulary
  lacks goes through the Python class, which keeps the raw piece).
- `vocab_trainer_merge`: pipeline/vocab.py's greedy merge loop in C++,
  the same selection order.

Each library is built at first use from the sources beside this module
(native/build.py) and loaded once a process; a failed build or load
raises, it never falls back to Python. A ctypes call releases the
interpreter lock, so the streaming plane's tokenize threads encode while
the training loop dispatches. `encode_ids` is the single-text path that
builds no Encoding; the id -> token table is built once, at construction.
The tokenizers pickle (a server's spawned featurizers): the handle is
dropped and reopened in the receiving process.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Sequence

from bert_pytorch_tpu_torch.data.tokenization import (
    BertWordPieceTokenizer,
    ByteLevelBPETokenizer,
    Encoding,
)
from bert_pytorch_tpu_torch.native import build as _build

I32P = ctypes.POINTER(ctypes.c_int32)


def _configure_wp(lib) -> None:
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.wp_destroy.restype = None
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode_batch.restype = ctypes.c_int32
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(I32P), ctypes.POINTER(I32P), ctypes.POINTER(I32P),
        ctypes.POINTER(I32P), ctypes.POINTER(I32P),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [ctypes.c_void_p]


def _configure_bpe(lib) -> None:
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32]
    lib.bpe_destroy.restype = None
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.bpe_encode_batch.restype = ctypes.c_int32
    lib.bpe_encode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(I32P), ctypes.POINTER(I32P),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.bpe_free.restype = None
    lib.bpe_free.argtypes = [ctypes.c_void_p]


def _configure_vt(lib) -> None:
    lib.vt_train.restype = ctypes.c_int32
    lib.vt_train.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_long,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.vt_free.restype = None
    lib.vt_free.argtypes = [ctypes.c_void_p]


_CONFIGURE = {"wordpiece": _configure_wp, "bpe": _configure_bpe,
              "vocab_trainer": _configure_vt}
_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def load_library(target: str) -> ctypes.CDLL:
    """`target`'s library, built and loaded at first use; raises
    NativeBuildError (the compiler's stderr) or OSError (the loader's)."""
    lib = _libs.get(target)
    if lib is None:
        with _libs_lock:
            lib = _libs.get(target)
            if lib is None:
                lib = ctypes.CDLL(_build.build(target))
                _CONFIGURE[target](lib)
                _libs[target] = lib
    return lib


def _default_threads(nthreads: Optional[int]) -> int:
    return nthreads if nthreads is not None else min(os.cpu_count() or 1,
                                                     16)


def _c_texts(texts: Sequence[Optional[str]], empty=b""):
    """(char* array, int64 lengths, the encoded bytes to keep alive); an
    empty or missing text is `empty` (None: a NULL pointer, no pair)."""
    raw = [t.encode("utf-8") if t else empty for t in texts]
    arr = (ctypes.c_char_p * len(raw))(*raw)
    lens = (ctypes.c_int64 * len(raw))(*[len(b) if b else 0 for b in raw])
    return arr, lens, raw


class _NativeHandle:
    """A C-side tokenizer handle opened by `_open()`: pickling drops the
    library and the handle and the receiving process opens its own;
    the handle is destroyed (`_DESTROY`) with the object."""

    _DESTROY = ""

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lib", None)
        state.pop("_handle", None)
        return state

    def __setstate__(self, state) -> None:
        self.__dict__.update(state)
        self._open()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and getattr(self, "_lib", None) is not None:
            getattr(self._lib, self._DESTROY)(handle)
            self._handle = None


class NativeWordPieceTokenizer(_NativeHandle, BertWordPieceTokenizer):
    """BertWordPieceTokenizer whose encode, encode_batch,
    encode_batch_arrays and encode_ids run in C++ (threads across the texts
    of a batch); the vocabulary surface is the Python class's."""

    _DESTROY = "wp_destroy"

    def __init__(self, vocab, lowercase: bool = True, **kw):
        super().__init__(vocab, lowercase=lowercase, **kw)
        # id -> token, one line an id for the C side too: an id no token
        # holds (a gap, or a duplicated line's first id) gets "", which no
        # lookup asks for, so every token keeps its id
        self._tok_tab = [""] * (max(self.vocab.values(), default=-1) + 1)
        for tok, i in self.vocab.items():
            self._tok_tab[i] = tok
        self._open()

    def _open(self) -> None:
        self._lib = load_library("wordpiece")
        blob = "\n".join(self._tok_tab).encode("utf-8")
        self._handle = self._lib.wp_create(
            blob, 1 if self.basic.do_lower_case else 0)

    def _encode_raw(self, texts, pairs, add_special_tokens, nthreads):
        """The C call; returns the five malloc'd int32 arrays (lens, ids,
        type ids, starts, ends), each freed by the caller with wp_free."""
        n = len(texts)
        texts_c, text_lens, keep = _c_texts(texts)
        pairs_c, pair_lens, keep_p = (None, (ctypes.c_int64 * n)(), None) \
            if pairs is None else _c_texts(pairs, empty=None)
        out = [I32P() for _ in range(5)]
        total = ctypes.c_int64()
        rc = self._lib.wp_encode_batch(
            self._handle, texts_c, text_lens, pairs_c, pair_lens, n,
            1 if add_special_tokens else 0, _default_threads(nthreads),
            *[ctypes.byref(p) for p in out], ctypes.byref(total))
        del keep, keep_p
        if rc != 0:
            raise RuntimeError("wp_encode_batch failed")
        return out

    def _free(self, ptrs) -> None:
        for p in ptrs:
            self._lib.wp_free(p)

    def encode_ids(self, text: str, add_special_tokens: bool = True
                   ) -> List[int]:
        raw = self._encode_raw([text], None, add_special_tokens, 1)
        try:
            return raw[1][:raw[0][0]]
        finally:
            self._free(raw)

    def encode(self, text: str, pair: Optional[str] = None,
               add_special_tokens: bool = True) -> Encoding:
        return self.encode_batch([text], [pair] if pair else None,
                                 add_special_tokens=add_special_tokens,
                                 nthreads=1)[0]

    def encode_batch_arrays(self, texts: Sequence[str],
                            pairs: Optional[Sequence[Optional[str]]] = None,
                            add_special_tokens: bool = True,
                            nthreads: Optional[int] = None):
        """(lens, ids, type_ids, starts, ends) as numpy int32 arrays; the
        flat arrays split at np.cumsum(lens)."""
        import numpy as np

        n = len(texts)
        if n == 0:
            z = np.zeros((0,), np.int32)
            return z, z, z, z, z
        raw = self._encode_raw(texts, pairs, add_special_tokens, nthreads)
        try:
            lens = np.ctypeslib.as_array(raw[0], (n,)).copy()
            tot = int(lens.sum())
            return (lens, *[np.ctypeslib.as_array(p, (tot,)).copy()
                            for p in raw[1:]])
        finally:
            self._free(raw)

    def encode_batch(self, texts: Sequence[str],
                     pairs: Optional[Sequence[Optional[str]]] = None,
                     add_special_tokens: bool = True,
                     nthreads: Optional[int] = None) -> List[Encoding]:
        n = len(texts)
        if n == 0:
            return []
        raw = self._encode_raw(texts, pairs, add_special_tokens, nthreads)
        try:
            lens = raw[0][:n]
            tot = sum(lens)
            ids, types, starts, ends = (p[:tot] for p in raw[1:])
        finally:
            self._free(raw)
        tab, size, unk = self._tok_tab, len(self._tok_tab), self.unk_token
        out: List[Encoding] = []
        off = 0
        for ln in lens:
            sl = slice(off, off + ln)
            row = ids[sl]
            out.append(Encoding(
                ids=row,
                tokens=[tab[i] if 0 <= i < size else unk for i in row],
                offsets=list(zip(starts[sl], ends[sl])),
                type_ids=types[sl]))
            off += ln
        return out


class NativeByteLevelBPETokenizer(_NativeHandle, ByteLevelBPETokenizer):
    """ByteLevelBPETokenizer whose encode paths run in C++. A text whose
    encoding holds a piece the vocabulary lacks is encoded again by the
    Python class, so its tokens keep the raw piece as the spec's do."""

    _DESTROY = "bpe_destroy"

    def __init__(self, vocab, merges, lowercase: bool = False,
                 add_prefix_space: bool = True, unk_token: str = "<unk>"):
        super().__init__(vocab, merges, lowercase=lowercase,
                         add_prefix_space=add_prefix_space,
                         unk_token=unk_token)
        # below every real id, so an unknown piece shows even where
        # unk_token is itself in the vocabulary
        self._unk_sentinel = min(self.vocab.values(), default=0) - 1
        self._open()

    def _open(self) -> None:
        self._lib = load_library("bpe")
        # "id\ttoken" lines: a vocabulary with gaps in its ids keeps them
        vocab_blob = "\n".join(
            f"{i}\t{tok}" for tok, i in self.vocab.items()).encode("utf-8")
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        merges_blob = "\n".join(f"{a} {b}" for (a, b), _ in
                                merges).encode("utf-8")
        self._handle = self._lib.bpe_create(
            vocab_blob, merges_blob, 1 if self.lowercase else 0,
            1 if self.add_prefix_space else 0, self._unk_sentinel)

    def _encode_raw(self, texts, nthreads):
        """(lens, ids) as Python lists."""
        n = len(texts)
        texts_c, text_lens, keep = _c_texts(texts)
        lens, ids, total = I32P(), I32P(), ctypes.c_int64()
        rc = self._lib.bpe_encode_batch(
            self._handle, texts_c, text_lens, n, _default_threads(nthreads),
            ctypes.byref(lens), ctypes.byref(ids), ctypes.byref(total))
        del keep
        if rc != 0:
            raise RuntimeError("bpe_encode_batch failed")
        try:
            return lens[:n], ids[:total.value]
        finally:
            self._lib.bpe_free(lens)
            self._lib.bpe_free(ids)

    def _rows(self, texts, nthreads) -> List[Optional[List[int]]]:
        """Each text's ids, None where the Python class must encode it."""
        lens, ids = self._encode_raw(texts, nthreads)
        rows: List[Optional[List[int]]] = []
        off = 0
        for ln in lens:
            row = ids[off:off + ln]
            off += ln
            rows.append(None if self._unk_sentinel in row else row)
        return rows

    def encode_ids(self, text: str, add_special_tokens: bool = True
                   ) -> List[int]:
        row, = self._rows([text], 1)
        return row if row is not None else \
            ByteLevelBPETokenizer.encode(self, text).ids

    def encode(self, text: str, add_special_tokens: bool = True) -> Encoding:
        return self.encode_batch([text], nthreads=1)[0]

    def encode_batch_arrays(self, texts: Sequence[str],
                            add_special_tokens: bool = True,
                            nthreads: Optional[int] = None):
        """(lens, ids) as numpy int32 arrays; ids splits at
        np.cumsum(lens). Byte-level BPE adds no specials either way."""
        import numpy as np

        rows = [row if row is not None else
                ByteLevelBPETokenizer.encode(self, text).ids
                for text, row in zip(texts, self._rows(texts, nthreads))] \
            if texts else []
        lens = np.asarray([len(r) for r in rows], np.int32)
        ids = np.asarray([i for r in rows for i in r], np.int32)
        return lens, ids

    def encode_batch(self, texts: Sequence[str],
                     add_special_tokens: bool = True,
                     nthreads: Optional[int] = None) -> List[Encoding]:
        if not texts:
            return []
        out: List[Encoding] = []
        for text, row in zip(texts, self._rows(texts, nthreads)):
            if row is None:
                out.append(ByteLevelBPETokenizer.encode(self, text))
                continue
            out.append(Encoding(
                ids=row, tokens=[self.ids_to_tokens[i] for i in row],
                offsets=[(0, 0)] * len(row), type_ids=[0] * len(row)))
        return out


def vocab_trainer_merge(words, init_vocab, vocab_size: int,
                        wordpiece_mode: bool, min_pair_frequency: int = 1):
    """pipeline/vocab.py's greedy merge loop in C++.

    words: (symbols tuple, frequency) pairs, deduplicated, as the Python
    engine takes them; init_vocab: the initial vocabulary in order
    (specials, then the alphabet). Returns (the tokens to append, in
    selection order; the ordered merge pairs, for BPE)."""
    lib = load_library("vocab_trainer")
    words_tsv = "".join(
        f"{freq}\t{' '.join(symbols)}\n" for symbols, freq in words
    ).encode("utf-8")
    init_buf = "".join(t + "\n" for t in init_vocab).encode("utf-8")
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.vt_train(words_tsv, len(words_tsv), init_buf, len(init_buf),
                      vocab_size, 1 if wordpiece_mode else 0,
                      min_pair_frequency, ctypes.byref(out),
                      ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError("vt_train failed")
    try:
        text = ctypes.string_at(out.value, out_len.value).decode("utf-8")
    finally:
        lib.vt_free(out)
    new_tokens, merges = [], []
    # split on "\n" alone: str.splitlines() also splits at U+2028 / U+2029,
    # which the basic tokenizer lets through inside a token
    for line in text.split("\n"):
        if line.startswith("V\t"):
            new_tokens.append(line[2:])
        elif line.startswith("M\t"):
            a, _, b = line[2:].partition(" ")
            merges.append((a, b))
    return new_tokens, merges
