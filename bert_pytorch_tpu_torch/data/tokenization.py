"""WordPiece and byte-level BPE tokenization in pure Python (counterpart
of bert_pytorch_tpu/data/tokenization.py).

The canonical Google-BERT algorithms: BasicTokenizer (control-character
cleanup, CJK spacing, optional lowercase + NFD accent stripping,
punctuation splitting) and WordpieceTokenizer (greedy longest-match-first
over '##' continuations), with an end-to-end `BertWordPieceTokenizer` that
frames [CLS]/[SEP] and keeps character offsets; and RoBERTa's byte-level
BPE (`ByteLevelBPETokenizer`: GPT-2's byte-to-unicode table, its
pre-tokenizer scanned by hand because `re` lacks \\p{L}, ranked merges).
`TOKENIZERS` maps "wordpiece" and "bpe" to their factories, which return
the C++ encoders of bert_pytorch_tpu_torch.native (the same ids, built at
first use; a failed build raises). The classes here are their behavioural
spec: construct one directly for the pure-Python encoder.
"""

from __future__ import annotations

import collections
import json
import os
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def load_vocab(vocab_file: str) -> "collections.OrderedDict[str, int]":
    """One token per line -> token->id, line order (reference
    src/tokenization.py:18-30)."""
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.strip()] = i  # strip(), not rstrip('\n'): CRLF vocabs
    return vocab


def whitespace_tokenize(text: str) -> List[str]:
    return text.split()


# ---------------------------------------------------------------------------
# character classes (Unicode categories per the original BERT definition)
# ---------------------------------------------------------------------------

def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even where Unicode disagrees
    # (e.g. '$', '`') — standard BERT behavior.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Whitespace/punctuation/CJK pre-tokenizer with optional lowercasing
    (spec: reference src/tokenization.py:60-174)."""

    def __init__(self, do_lower_case: bool = True,
                 never_split: Sequence[str] = SPECIAL_TOKENS):
        self.do_lower_case = do_lower_case
        self.never_split = tuple(never_split)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in whitespace_tokenize(self._clean(text)):
            if token in self.never_split:
                out.append(token)
                continue
            if self.do_lower_case:
                token = self._strip_accents(token.lower())
            out.extend(self._split_punc(token))
        return [t for t in out if t]

    def _clean(self, text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                chars.append(f" {ch} ")
            elif _is_whitespace(ch):
                chars.append(" ")
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punc(token: str) -> List[str]:
        pieces: List[str] = []
        current = ""
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    pieces.append(current)
                    current = ""
                pieces.append(ch)
            else:
                current += ch
        if current:
            pieces.append(current)
        return pieces


class WordpieceTokenizer:
    """Greedy longest-match-first subword split (spec: reference
    src/tokenization.py:176-229)."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 200):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in whitespace_tokenize(text):
            if len(word) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            subs = self._split_word(word)
            out.extend(subs if subs is not None else [self.unk_token])
        return out

    def _split_word(self, word: str) -> Optional[List[str]]:
        subs: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                cand = word[start:end]
                if start > 0:
                    cand = "##" + cand
                if cand in self.vocab:
                    piece = cand
                    break
                end -= 1
            if piece is None:
                return None
            subs.append(piece)
            start = end
        return subs


@dataclass
class Encoding:
    """Minimal analogue of the HF tokenizers Encoding the reference consumed:
    ids, tokens, per-token char offsets into the *original* text, and
    type_ids for pairs."""

    ids: List[int] = field(default_factory=list)
    tokens: List[str] = field(default_factory=list)
    offsets: List[Tuple[int, int]] = field(default_factory=list)
    type_ids: List[int] = field(default_factory=list)


class BertWordPieceTokenizer:
    """End-to-end WordPiece encoder: basic-tokenize (tracking offsets) then
    wordpiece, with [CLS]/[SEP] framing — the in-framework replacement for
    tokenizers.BertWordPieceTokenizer (reference src/tokenization.py:42-49).
    """

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]"):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = dict(vocab)
        self.basic = BasicTokenizer(do_lower_case=lowercase)
        self.wordpiece = WordpieceTokenizer(self.vocab, unk_token=unk_token)
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token

    # -- HF-compatible surface ---------------------------------------------

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def encode(self, text: str, pair: Optional[str] = None,
               add_special_tokens: bool = True) -> Encoding:
        enc = Encoding()
        cls_id = self.vocab.get(self.cls_token)
        sep_id = self.vocab.get(self.sep_token)

        def add(token: str, tid: int, span: Tuple[int, int], type_id: int):
            enc.tokens.append(token)
            enc.ids.append(tid)
            enc.offsets.append(span)
            enc.type_ids.append(type_id)

        if add_special_tokens:
            add(self.cls_token, cls_id, (0, 0), 0)
        for seq_idx, seq in enumerate([text] + ([pair] if pair else [])):
            for word, span in self._words_with_offsets(seq):
                for wp in self.wordpiece.tokenize(word):
                    tid = self.vocab.get(wp, self.vocab.get(self.unk_token, 0))
                    add(wp, tid, span, seq_idx)
            if add_special_tokens:
                add(self.sep_token, sep_id, (0, 0), seq_idx)
        return enc

    def encode_ids(self, text: str, add_special_tokens: bool = True
                   ) -> List[int]:
        """`encode(text).ids` (the native encoder builds no Encoding)."""
        return self.encode(text, add_special_tokens=add_special_tokens).ids

    def _words_with_offsets(self, text: str) -> List[Tuple[str, Tuple[int, int]]]:
        """basic-tokenize while tracking each word's (start, end) char span in
        the original text. Offsets point at the pre-normalization word, which
        is what SQuAD answer realignment needs."""
        out = []
        n = len(text)
        i = 0
        while i < n:
            ch = text[i]
            if _is_whitespace(ch) or _is_control(ch) or ord(ch) in (0, 0xFFFD):
                i += 1
                continue
            if _is_punctuation(ch) or _is_cjk(ord(ch)):
                out.append((self._norm(ch), (i, i + 1)))
                i += 1
                continue
            j = i
            while j < n and not (_is_whitespace(text[j]) or _is_control(text[j])
                                 or _is_punctuation(text[j])
                                 or _is_cjk(ord(text[j]))):
                j += 1
            word = text[i:j]
            out.append((self._norm(word), (i, j)))
            i = j
        return [(w, s) for w, s in out if w]

    def _norm(self, word: str) -> str:
        if self.basic.do_lower_case:
            return BasicTokenizer._strip_accents(word.lower())
        return word


def get_wordpiece_tokenizer(vocab, uppercase: bool = False
                            ) -> BertWordPieceTokenizer:
    """The native WordPiece tokenizer from a vocab file or dict."""
    from bert_pytorch_tpu_torch.native import NativeWordPieceTokenizer

    return NativeWordPieceTokenizer(vocab, lowercase=not uppercase)


# ---------------------------------------------------------------------------
# byte-level BPE (the RoBERTa path)
# ---------------------------------------------------------------------------

def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's bijection of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPETokenizer:
    """Byte-level BPE encoder (tokenizers.ByteLevelBPETokenizer's
    output). `vocab`: token -> id, or a .json file of it; `merges`: the
    ranked merge pairs, or a merges.txt (one "a b" pair a line, '#' lines
    skipped). add_prefix_space matches the reference factory's default."""

    _CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

    def __init__(self, vocab, merges, lowercase: bool = False,
                 add_prefix_space: bool = True, unk_token: str = "<unk>"):
        if isinstance(vocab, str):
            with open(vocab, "r", encoding="utf-8") as f:
                vocab = json.load(f)
        self.vocab: Dict[str, int] = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        if isinstance(merges, str):
            with open(merges, "r", encoding="utf-8") as f:
                lines = [ln.rstrip("\n") for ln in f
                         if ln.strip() and not ln.startswith("#")]
            merges = [tuple(ln.split()) for ln in lines]
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.lowercase = lowercase
        self.add_prefix_space = add_prefix_space
        self.unk_token = unk_token
        self._cache: Dict[str, List[str]] = {}

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, idx: int) -> Optional[str]:
        return self.ids_to_tokens.get(idx)

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> List[str]:
        """Merge the lowest-ranked adjacent pair until none is ranked."""
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def _pretokenize(self, text: str) -> List[str]:
        """GPT-2's pre-tokenization: contractions, letter runs, number
        runs and runs of other characters, each with an optional single
        leading space, and whitespace runs."""
        out: List[str] = []
        i, n = 0, len(text)
        while i < n:
            if text[i] == "'":
                for c in self._CONTRACTIONS:
                    if text.startswith(c, i):
                        out.append(c)
                        i += len(c)
                        break
                else:
                    j = i + 1
                    while j < n and not (text[j].isspace()
                                         or text[j].isalpha()
                                         or text[j].isnumeric()):
                        j += 1
                    out.append(text[i:j])
                    i = j
                continue
            start = i
            lead_space = False
            if text[i] == " " and i + 1 < n and not text[i + 1].isspace():
                lead_space = True
                i += 1
            if i < n and text[i].isalpha():
                while i < n and text[i].isalpha():
                    i += 1
            elif i < n and text[i].isnumeric():
                while i < n and text[i].isnumeric():
                    i += 1
            elif i < n and text[i].isspace():
                while i < n and text[i].isspace():
                    i += 1
            else:
                while i < n and not (text[i].isspace() or text[i].isalpha()
                                     or text[i].isnumeric()
                                     or text[i] == "'"):
                    i += 1
                if i == start + (1 if lead_space else 0):
                    i += 1      # a lone character that matched no run
            out.append(text[start:i])
        return [c for c in out if c]

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> Encoding:
        """Pieces and ids of `text` (no specials are added either way;
        offsets are (0, 0))."""
        if self.lowercase:
            text = text.lower()
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        enc = Encoding()
        unk = self.vocab.get(self.unk_token, 0)
        for chunk in self._pretokenize(text):
            if chunk.isspace() and chunk != " ":
                chunk = " "
            mapped = "".join(self.byte_encoder[b]
                             for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = self.vocab.get(piece)
                enc.tokens.append(piece)
                enc.ids.append(unk if tid is None else tid)
                enc.offsets.append((0, 0))
                enc.type_ids.append(0)
        return enc

    def encode_ids(self, text: str, add_special_tokens: bool = True
                   ) -> List[int]:
        """`encode(text).ids` (the native encoder builds no Encoding)."""
        return self.encode(text).ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.ids_to_tokens.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder.get(ch, 32) for ch in text)
        return raw.decode("utf-8", errors="replace")


def get_bpe_tokenizer(vocab, merges=None, uppercase: bool = False
                      ) -> ByteLevelBPETokenizer:
    """The native byte-level BPE tokenizer; `vocab` may be a .json path,
    and then `merges` defaults to the merges.txt beside it."""
    from bert_pytorch_tpu_torch.native import NativeByteLevelBPETokenizer

    if merges is None and isinstance(vocab, str):
        merges = os.path.join(os.path.dirname(vocab), "merges.txt")
    return NativeByteLevelBPETokenizer(vocab, merges,
                                       lowercase=not uppercase)


TOKENIZERS = {
    "wordpiece": get_wordpiece_tokenizer,
    "bpe": get_bpe_tokenizer,
}
