"""Task forwards + postprocess as pure functions (counterpart of
bert_pytorch_tpu/tasks/predict.py, the QA and NER parts).

`build_qa_forward` is the deterministic model application the serving
engine runs per bucket and SQuAD's eval runs per length bucket;
`build_ner_forward` the NER eval's; the rest is host-side: request
featurization through tasks/squad and the n-best decode through
squad.get_answers, the same code the eval path of the JAX package runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

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


def build_ner_forward(model: torch.nn.Module) -> Callable:
    """fwd(batch) -> (B, S, num_labels) f32 logits, deterministic; the
    NER eval computes its loss and macro F1 from them."""

    def forward(batch: Dict[str, torch.Tensor]):
        return model(batch["input_ids"], batch.get("token_type_ids"),
                     batch["attention_mask"],
                     **{k: batch[k] for k in PACKED_FIELDS if k in batch})

    return forward


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
