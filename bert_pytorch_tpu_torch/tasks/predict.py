"""Task forwards + postprocess as pure functions (counterpart of
bert_pytorch_tpu/tasks/predict.py).

The `build_*_forward` builders are the deterministic model applications
the serving engine runs per bucket and the eval loops run per length
bucket, one for each registered task's head; the rest is host-side:
request featurization (SQuAD windows through tasks/squad, NER word
pieces, GLUE-style pairs through `encode_pair`, which data/glue.py
featurizes training data with too) and the decodes (the n-best answers
through squad.get_answers, NER's per-word labels, the classify and
choice softmaxes).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bert_pytorch_tpu_torch.tasks import squad

# the packed-batch fields the forward passes through when present
PACKED_FIELDS = ("position_ids", "segment_ids")


def build_qa_forward(model: torch.nn.Module) -> Callable:
    """fwd(batch) -> (start_logits, end_logits), each (B, S) f32. `batch`
    maps input_ids / token_type_ids / attention_mask (+ position_ids /
    segment_ids for packed rows) to (B, S) integer tensors on the model's
    device."""

    def forward(batch: Dict[str, torch.Tensor]):
        return model(batch["input_ids"], batch["token_type_ids"],
                     batch["attention_mask"],
                     **{k: batch[k] for k in PACKED_FIELDS if k in batch})

    return forward


def _packed_forward(model: torch.nn.Module) -> Callable:
    """fwd(batch) -> the model's deterministic outputs on input_ids /
    token_type_ids / attention_mask (+ the packed fields when present)."""

    def forward(batch: Dict[str, torch.Tensor]):
        return model(batch["input_ids"], batch.get("token_type_ids"),
                     batch.get("attention_mask"),
                     **{k: batch[k] for k in PACKED_FIELDS if k in batch})

    return forward


def build_ner_forward(model: torch.nn.Module) -> Callable:
    """fwd(batch) -> (B, S, num_labels) f32 logits, deterministic; the
    NER eval computes its loss and macro F1 from them, and /v1/ner
    slices each request's tokens."""
    return _packed_forward(model)


def build_classify_forward(model: torch.nn.Module) -> Callable:
    """fwd(batch) -> f32 classification logits, (B, num_labels), or
    (B, G, num_labels) for packed rows (one per segment): the classify
    eval's and the /v1/classify engine's forward."""
    return _packed_forward(model)


def build_choice_forward(model: torch.nn.Module) -> Callable:
    """fwd(batch) -> f32 choice scores: (B, G) for packed rows (serving
    sends one segment per choice and softmaxes on the host), (B,) for
    plain 2-D rows, (B, C) for a (B, C, S) eval batch."""
    return _packed_forward(model)


def build_embed_forward(model: torch.nn.Module) -> Callable:
    """fwd(batch) -> L2-normalised f32 embeddings, (B, E), or (B, G, E)
    for packed rows; the training probe's logits are dropped."""
    forward = _packed_forward(model)
    return lambda batch: forward(batch)[0]


def qa_raw_results(unique_ids: Sequence[int], start_logits: np.ndarray,
                   end_logits: np.ndarray,
                   n_real: Optional[int] = None) -> List[squad.RawResult]:
    """Batch logits -> per-feature RawResults; `n_real` drops tail-padding
    rows."""
    start = np.asarray(start_logits)
    end = np.asarray(end_logits)
    n = len(unique_ids) if n_real is None else int(n_real)
    return [squad.RawResult(unique_id=int(unique_ids[i]),
                            start_logits=start[i].tolist(),
                            end_logits=end[i].tolist())
            for i in range(n)]


def make_squad_example(qas_id: str, question: str,
                       context: str) -> squad.SquadExample:
    """One request -> a SquadExample, its context split as the dataset
    reader splits contexts."""
    doc_tokens, _ = squad.text_to_doc_tokens(context)
    if not doc_tokens:
        raise ValueError("empty context")
    return squad.SquadExample(qas_id=qas_id, question_text=question,
                              doc_tokens=doc_tokens)


def qa_featurize(example: squad.SquadExample, tokenizer, max_seq_length: int,
                 doc_stride: int, max_query_length: int
                 ) -> List[squad.InputFeatures]:
    """Sliding-window features of one example (a long context gives
    several windows, each its own forward, merged in qa_decode)."""
    return squad.convert_examples_to_features(
        [example], tokenizer, max_seq_length, doc_stride, max_query_length)


def feature_length(feat: squad.InputFeatures) -> int:
    """Real token count of a feature: the length the scheduler packs."""
    return int(sum(feat.input_mask))


def qa_decode(example: squad.SquadExample,
              features: List[squad.InputFeatures],
              raw_results: List[squad.RawResult],
              cfg: Optional[squad.AnswerConfig] = None,
              n_best: int = 5) -> Dict[str, Any]:
    """(example, its features, their RawResults) -> {'answer', 'nbest'}."""
    cfg = cfg or squad.AnswerConfig()
    answers, nbest = squad.get_answers([example], features, raw_results, cfg)
    return {"answer": answers.get(example.qas_id, ""),
            "nbest": nbest.get(example.qas_id, [])[:n_best]}


# -- NER, classify and choice: request featurization and decodes -------------


def ner_encode_tokens(tokens: Sequence[str], tokenizer, max_pieces: int
                      ) -> Tuple[List[int], List[int]]:
    """Pre-split words -> ([CLS] pieces [SEP] ids, piece -> word map), the
    pieces as data/ner.py expands words; `max_pieces` ([CLS] and [SEP]
    included) rejects an over-long request before it is queued."""
    pieces: List[str] = []
    piece_word: List[int] = []
    # the native encoder takes the request's words in one call (a call a
    # word costs it what the Python encoder's whole work on a short word
    # does); each word is still encoded on its own
    batch = getattr(tokenizer, "encode_batch", None)
    encodings = (batch(list(tokens), add_special_tokens=False, nthreads=1)
                 if batch is not None and tokens else
                 [tokenizer.encode(w, add_special_tokens=False)
                  for w in tokens])
    for wi, enc in enumerate(encodings):
        for sub in enc.tokens:
            pieces.append(sub)
            piece_word.append(wi)
    if len(pieces) > max_pieces - 2:
        raise ValueError(
            f"request tokenizes to {len(pieces)} pieces, exceeding the "
            f"largest bucket ({max_pieces} incl. [CLS]/[SEP])")
    unk = tokenizer.token_to_id("[UNK]") or 0
    ids = [tokenizer.token_to_id(t) if tokenizer.token_to_id(t) is not None
           else unk for t in ["[CLS]"] + pieces + ["[SEP]"]]
    return ids, piece_word


def encode_pair(tokenizer, text: str, text_pair: Optional[str] = None,
                max_pieces: int = 128) -> Tuple[List[int], List[int]]:
    """(text, optional pair) -> ([CLS] A [SEP] (B [SEP]) ids, type ids),
    truncated longest first into `max_pieces`: the GLUE-style encoding of
    the classify, choice and embed datasets and of their requests."""
    a = list(tokenizer.encode(text, add_special_tokens=False).tokens)
    b = (list(tokenizer.encode(text_pair, add_special_tokens=False).tokens)
         if text_pair else [])
    budget = max_pieces - (3 if b else 2)
    if budget < 1:
        raise ValueError(f"max_pieces {max_pieces} leaves no room for "
                         "content tokens")
    while len(a) + len(b) > budget:  # the reference's _truncate_seq_pair
        (a if len(a) >= len(b) else b).pop()
    if not a:
        raise ValueError("empty text after tokenization")
    tokens = ["[CLS]"] + a + ["[SEP]"]
    types = [0] * len(tokens)
    if b:
        tokens += b + ["[SEP]"]
        types += [1] * (len(b) + 1)
    unk = tokenizer.token_to_id("[UNK]") or 0
    ids = [tokenizer.token_to_id(t) if tokenizer.token_to_id(t) is not None
           else unk for t in tokens]
    return ids, types


def _softmax_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def classify_decode(logits: np.ndarray,
                    class_names: Sequence[str]) -> Dict[str, Any]:
    """(num_labels,) logits -> {'label': the argmax class, 'scores': the
    softmax by class name}."""
    probs = _softmax_np(np.asarray(logits).reshape(-1))
    idx = int(np.argmax(probs))
    names = [class_names[i] if i < len(class_names) else str(i)
             for i in range(len(probs))]
    return {"label": names[idx],
            "scores": {n: round(float(p), 6)
                       for n, p in zip(names, probs)}}


def choice_decode(scores: Sequence[float]) -> Dict[str, Any]:
    """One score a choice -> {'choice': the argmax, 'scores': the softmax
    across the choices}."""
    probs = _softmax_np(np.asarray(scores, np.float64))
    return {"choice": int(np.argmax(probs)),
            "scores": [round(float(p), 6) for p in probs]}


def ner_decode(logits: np.ndarray, piece_word: Sequence[int],
               id_to_label: Dict[int, str], n_words: int) -> List[str]:
    """(L, num_labels) logits of one request -> a label per word: piece i
    sits at position i + 1 (after [CLS]), each word takes its first
    piece's argmax, and class 0 (padding) decodes to 'O'."""
    preds = np.argmax(np.asarray(logits), axis=-1)
    out = ["O"] * n_words
    seen = set()
    for i, wi in enumerate(piece_word):
        if wi in seen:
            continue
        seen.add(wi)
        out[wi] = id_to_label.get(int(preds[i + 1]), "O")
    return out
