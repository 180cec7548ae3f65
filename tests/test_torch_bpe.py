"""The port's byte-level BPE tokenizer (bert_pytorch_tpu_torch/data/
tokenization.py) against the JAX package's pure-Python class, ids and
decode, on text with accents, digits, contractions and whitespace runs,
under the JAX tests' tiny vocabulary and under one learned from the text
(chip_smoke.bpe_files, the vocabulary chip_smoke's stream phase builds);
NER's features under --tokenizer bpe and under a model config that says
"tokenizer": "bpe", against JAX's; run_pretraining --stream_dir
--stream_tokenizer bpe on the CPU, its mask id taken from <mask>."""

import json
import os
import sys

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bert_pytorch_tpu.data import tokenization as jtok  # noqa: E402
from bert_pytorch_tpu_torch.data import tokenization as ttok  # noqa: E402
from tests.test_tokenization import _tiny_bpe  # noqa: E402

import chip_smoke  # noqa: E402

TEXTS = [
    "hello world",
    "Café naïve résumé — the émigré's CAFÉ!",
    "it's we'll they're I'd you've she'd 'quoted' don't",
    "in 2024 we paid $3.14 for 1,000,000 items (12%)",
    "spaces   between\twords\n\nand  lines   end  ",
    "  leading and trailing  ",
    "ümlaut Ångström ß 東京 العربية 😀 emoji",
    "a'b'c '' ''' 'x",
    "",
]


@pytest.fixture(scope="module")
def learned(tmp_path_factory):
    return chip_smoke.bpe_files(TEXTS * 3, str(tmp_path_factory.mktemp(
        "bpe")), n_merges=120)


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("prefix", [False, True])
def test_tiny_vocab_ids_and_decode_equal_jax(lowercase, prefix):
    vocab, merges = _tiny_bpe()
    j = jtok.ByteLevelBPETokenizer(vocab, merges, lowercase=lowercase,
                                   add_prefix_space=prefix)
    t = ttok.ByteLevelBPETokenizer(vocab, merges, lowercase=lowercase,
                                   add_prefix_space=prefix)
    for text in TEXTS:
        je, te = j.encode(text), t.encode(text)
        assert (te.ids, te.tokens) == (je.ids, je.tokens), text
        assert t.decode(te.ids) == j.decode(je.ids)
    assert t._pretokenize(TEXTS[2]) == j._pretokenize(TEXTS[2])


def test_learned_vocab_ids_and_decode_equal_jax(learned):
    """A vocab with real merges (read back from vocab.json + merges.txt by
    both factories' classes): every piece known, the text round-trips."""
    merges = os.path.join(os.path.dirname(learned), "merges.txt")
    j = jtok.ByteLevelBPETokenizer(learned, merges, lowercase=True)
    t = ttok.get_bpe_tokenizer(learned)
    assert isinstance(t, ttok.ByteLevelBPETokenizer)
    assert t.bpe_ranks == j.bpe_ranks and t.vocab == j.vocab
    unk = t.token_to_id("<unk>")
    merged = 0
    for text in TEXTS:
        je, te = j.encode(text), t.encode(text)
        assert te.ids == je.ids, text
        assert unk not in te.ids
        merged += sum(len(p) > 1 for p in te.tokens)
        assert t.decode(te.ids) == j.decode(je.ids)
    assert merged > 20
    # bytes round-trip (a whitespace run encodes as one space, as in JAX)
    assert t.decode(t.encode(TEXTS[1]).ids) == " " + TEXTS[1].lower()
    assert ttok.TOKENIZERS["bpe"] is ttok.get_bpe_tokenizer
    assert ttok.TOKENIZERS["wordpiece"] is ttok.get_wordpiece_tokenizer


# -- NER under BPE ------------------------------------------------------------------

@pytest.mark.parametrize("source", ["flag", "config"])
def test_ner_features_under_bpe_equal_jax(tmp_path, learned, source):
    """--tokenizer bpe, or "tokenizer": "bpe" in the model config: the
    port's NER setup tokenizes with the BPE vocab and its arrays equal
    JAX's NERDataset's."""
    import torch

    from bert_pytorch_tpu.data import ner as jner
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.tasks import ner_task
    from tests.test_torch_ner import LABELS, write_conll

    vocab = json.load(open(learned))
    cfg = dict(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=64, next_sentence=True,
               vocab_file=learned)
    if source == "config":
        cfg["tokenizer"] = "bpe"
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    train = write_conll(tmp_path / "train.txt", 5, seed=3)
    argv = ["--train_file", train, "--labels", *LABELS,
            "--model_config_file", str(cfg_path), "--max_seq_len", "48",
            "--output_dir", str(tmp_path / "out"), "--device", "cpu"]
    if source == "flag":
        argv += ["--tokenizer", "bpe"]
    args = ner_task.parse_arguments(argv)
    config = BertConfig.from_json_file(str(cfg_path))
    assert config.tokenizer == ("bpe" if source == "config" else "wordpiece")
    run = ner_task.setup(args, config, torch.device("cpu"),
                         lambda m: None, lambda *a, **k: None)
    jax_tok = jtok.ByteLevelBPETokenizer(
        learned, os.path.join(os.path.dirname(learned), "merges.txt"),
        lowercase=True)
    want = jner.NERDataset(train, jax_tok, LABELS, max_seq_len=48).arrays()
    assert set(run.train_arrays) == set(want)
    for k in want:
        np.testing.assert_array_equal(run.train_arrays[k], want[k],
                                      err_msg=k)
    # [CLS] and [SEP] are not in a BPE vocab, and neither is [UNK]: both
    # take id 0 (JAX's fallback, reproduced)
    ids = run.train_arrays["input_ids"]
    assert (ids[:, 0] == 0).all()


# -- stream mode under BPE -----------------------------------------------------------

def test_stream_run_under_bpe_takes_the_mask_id_from_the_tokenizer(
        tmp_path, learned):
    from bert_pytorch_tpu_torch import run_pretraining
    from tests.test_streaming import write_corpus

    vocab = json.load(open(learned))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, next_sentence=True)))
    corpus = write_corpus(str(tmp_path / "c"), n_docs=20)
    lines = []
    got = run_pretraining.main([
        "--model_config_file", str(cfg), "--stream_dir", corpus,
        "--stream_vocab", learned, "--stream_tokenizer", "bpe",
        "--stream_seq_len", "32", "--output_dir", str(tmp_path / "out"),
        "--local_batch_size", "4", "--global_batch_size", "8",
        "--steps", "2", "--skip_checkpoint", "--tensorboard", "off",
        "--dtype", "float32", "--device", "cpu"], log=lines.append)
    assert any(f"[MASK]={vocab['<mask>']}" in ln for ln in lines
               if ln.startswith("dataset: STREAMING"))
    assert len(got.history) == 2
    assert np.isfinite([r["loss"] for r in got.history]).all()
