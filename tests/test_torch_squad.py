"""The port's copies of the jax-free text modules against the JAX
package's originals: WordPiece tokenization, SQuAD sliding-window
featurization, n-best answer decoding, and first-fit packing must give
identical results on the same inputs."""

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

from bert_pytorch_tpu.data import packing as jpacking
from bert_pytorch_tpu.data import tokenization as jtok
from bert_pytorch_tpu.tasks import predict as jpredict
from bert_pytorch_tpu.tasks import squad as jsquad
from bert_pytorch_tpu_torch.data import packing as tpacking
from bert_pytorch_tpu_torch.data import tokenization as ttok
from bert_pytorch_tpu_torch.tasks import predict as tpredict
from bert_pytorch_tpu_torch.tasks import squad as tsquad

TEXTS = [
    ("Who wrote it?", "The Café  ran\tfast, and ÜBER-cats ran; Zoë wrote "
     "it in 1999 (twice)."),
    ("where is the park ?", " ".join(["the park is north of the river ."]
                                     * 40)),
    ("何？", "東京 is a city. naïve résumé — it's fine!"),
]


def _vocab():
    words = set()
    for q, c in TEXTS:
        for t in jtok.BasicTokenizer().tokenize(q + " " + c):
            words.add(t)
    pieces = sorted(words) + ["##s", "##e", "run", "wr", "##ote"]
    return {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                        "[MASK]"] + pieces)}


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_wordpiece_encoding_matches(i, lowercase):
    vocab = _vocab()
    q, c = TEXTS[i]
    a = ttok.BertWordPieceTokenizer(vocab, lowercase=lowercase).encode(c, q)
    b = jtok.BertWordPieceTokenizer(vocab, lowercase=lowercase).encode(c, q)
    assert (a.ids, a.tokens, a.offsets, a.type_ids) == \
        (b.ids, b.tokens, b.offsets, b.type_ids)
    assert ttok.BasicTokenizer(lowercase).tokenize(c) == \
        jtok.BasicTokenizer(lowercase).tokenize(c)


@pytest.mark.parametrize("max_len,stride", [(64, 16), (512, 128)])
@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_featurize_and_decode_match(i, max_len, stride):
    vocab = _vocab()
    q, c = TEXTS[i]
    tk_t = ttok.get_wordpiece_tokenizer(vocab)
    tk_j = jtok.BertWordPieceTokenizer(vocab)
    ex_t = tpredict.make_squad_example("q", q, c)
    ex_j = jpredict.make_squad_example("q", q, c)
    ft = tpredict.qa_featurize(ex_t, tk_t, max_len, stride, 64)
    fj = jpredict.qa_featurize(ex_j, tk_j, max_len, stride, 64)
    assert len(ft) == len(fj) >= 1
    for a, b in zip(ft, fj):
        for field in ("unique_id", "tokens", "token_to_orig_map",
                      "token_is_max_context", "input_ids", "input_mask",
                      "segment_ids"):
            assert getattr(a, field) == getattr(b, field), field
        assert tpredict.feature_length(a) == jpredict.feature_length(b)
    rng = np.random.RandomState(i)
    start = rng.randn(len(ft), max_len).astype(np.float32)
    end = rng.randn(len(ft), max_len).astype(np.float32)
    ids = [f.unique_id for f in ft]
    cfg_t = tsquad.AnswerConfig(n_best_size=5, max_answer_length=12)
    cfg_j = jsquad.AnswerConfig(n_best_size=5, max_answer_length=12)
    out_t = tpredict.qa_decode(ex_t, ft, tpredict.qa_raw_results(
        ids, start, end), cfg_t)
    out_j = jpredict.qa_decode(ex_j, fj, jpredict.qa_raw_results(
        ids, start, end), cfg_j)
    assert out_t == out_j


def test_first_fit_matches():
    rng = np.random.RandomState(0)
    for _ in range(20):
        lengths = rng.randint(1, 129, rng.randint(1, 40)).tolist()
        assert tpacking.first_fit(lengths, 8, 128, 4) == \
            jpacking.first_fit(lengths, 8, 128, 4)
    with pytest.raises(ValueError):
        tpacking.first_fit([129], 8, 128, 4)
