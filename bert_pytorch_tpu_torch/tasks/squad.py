"""SQuAD v1.1/v2.0: example reading, sliding-window featurization (with
training targets), n-best answer extraction with original-text
realignment, and the in-process v1.1 / v2.0 evaluation (counterpart of
bert_pytorch_tpu/tasks/squad.py: the canonical Google-BERT pipeline).
"""

from __future__ import annotations

import collections
import json
import math
import os
import pickle
import re
import string
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from bert_pytorch_tpu_torch.data.tokenization import BasicTokenizer


@dataclass
class SquadExample:
    qas_id: str
    question_text: str
    doc_tokens: List[str]
    orig_answer_text: Optional[str] = None
    start_position: Optional[int] = None
    end_position: Optional[int] = None
    is_impossible: bool = False


@dataclass
class InputFeatures:
    unique_id: int
    example_index: int
    doc_span_index: int
    tokens: List[str]
    token_to_orig_map: Dict[int, int]
    token_is_max_context: Dict[int, bool]
    input_ids: List[int]
    input_mask: List[int]
    segment_ids: List[int]
    start_position: Optional[int] = None
    end_position: Optional[int] = None
    is_impossible: bool = False


RawResult = collections.namedtuple(
    "RawResult", ["unique_id", "start_logits", "end_logits"])


def _is_squad_whitespace(c: str) -> bool:
    return c in (" ", "\t", "\r", "\n") or ord(c) == 0x202F


def text_to_doc_tokens(context: str) -> Tuple[List[str], List[int]]:
    """Whitespace-split a context into doc tokens plus the char->word map —
    the tokenization the JAX package applies to a dataset file's contexts,
    so a served request's context splits the same way."""
    doc_tokens: List[str] = []
    char_to_word: List[int] = []
    prev_ws = True
    for c in context:
        if _is_squad_whitespace(c):
            prev_ws = True
        else:
            if prev_ws:
                doc_tokens.append(c)
            else:
                doc_tokens[-1] += c
            prev_ws = False
        char_to_word.append(len(doc_tokens) - 1)
    return doc_tokens, char_to_word


def read_squad_examples(input_file: str, is_training: bool,
                        version_2_with_negative: bool = False
                        ) -> List[SquadExample]:
    """SQuAD JSON -> SquadExamples with the answer's word span. A
    training question needs exactly one answer (or, in v2, is_impossible:
    span -1, -1); one whose answer text cannot be recovered from the
    context's words is skipped."""
    with open(input_file, "r", encoding="utf-8") as f:
        data = json.load(f)["data"]

    examples: List[SquadExample] = []
    for entry in data:
        for paragraph in entry["paragraphs"]:
            doc_tokens, char_to_word = text_to_doc_tokens(
                paragraph["context"])
            for qa in paragraph["qas"]:
                start = end = None
                answer_text = None
                impossible = False
                if is_training:
                    if version_2_with_negative:
                        impossible = qa["is_impossible"]
                    if len(qa["answers"]) != 1 and not impossible:
                        raise ValueError(
                            "training questions need exactly 1 answer")
                    if impossible:
                        start, end, answer_text = -1, -1, ""
                    else:
                        ans = qa["answers"][0]
                        answer_text = ans["text"]
                        off = ans["answer_start"]
                        start = char_to_word[off]
                        end = char_to_word[off + len(answer_text) - 1]
                        recovered = " ".join(doc_tokens[start:end + 1])
                        cleaned = " ".join(answer_text.split())
                        if recovered.find(cleaned) == -1:
                            continue
                examples.append(SquadExample(
                    qas_id=qa["id"], question_text=qa["question"],
                    doc_tokens=doc_tokens, orig_answer_text=answer_text,
                    start_position=start, end_position=end,
                    is_impossible=impossible))
    return examples


def improve_answer_span(doc_tokens: List[str], start: int, end: int,
                        tokenizer, orig_answer_text: str
                        ) -> Tuple[int, int]:
    """The sub-span of [start, end] whose word pieces spell the tokenized
    answer exactly, else [start, end]."""
    tok_answer = " ".join(
        tokenizer.encode(orig_answer_text, add_special_tokens=False).tokens)
    for new_start in range(start, end + 1):
        for new_end in range(end, new_start - 1, -1):
            if " ".join(doc_tokens[new_start:new_end + 1]) == tok_answer:
                return new_start, new_end
    return start, end


def check_is_max_context(doc_spans, cur_index: int, position: int) -> bool:
    """True iff this span gives `position` its maximal min(left,right)
    context among all spans containing it (reference :386-420)."""
    best_score, best_index = None, None
    for idx, span in enumerate(doc_spans):
        end = span.start + span.length - 1
        if position < span.start or position > end:
            continue
        left = position - span.start
        right = end - position
        score = min(left, right) + 0.01 * span.length
        if best_score is None or score > best_score:
            best_score, best_index = score, idx
    return cur_index == best_index


_DocSpan = collections.namedtuple("DocSpan", ["start", "length"])


def convert_examples_to_features(
    examples: List[SquadExample], tokenizer, max_seq_length: int,
    doc_stride: int, max_query_length: int, is_training: bool = False,
) -> List[InputFeatures]:
    """Sliding-window featurization: [CLS] query [SEP] doc window [SEP],
    padded to max_seq_length, one feature per window. Training features
    carry the answer's token span in the window; a window without the
    answer, and every window of an impossible (v2) question, targets
    (0, 0), the [CLS] position."""
    features: List[InputFeatures] = []
    unique_id = 1_000_000_000

    unk_id = tokenizer.token_to_id("[UNK]") or 0

    for ex_idx, ex in enumerate(examples):
        query = tokenizer.encode(ex.question_text,
                                 add_special_tokens=False).tokens
        query = query[:max_query_length]

        tok_to_orig: List[int] = []
        orig_to_tok: List[int] = []
        all_doc_tokens: List[str] = []
        for i, word in enumerate(ex.doc_tokens):
            orig_to_tok.append(len(all_doc_tokens))
            for sub in tokenizer.encode(word,
                                        add_special_tokens=False).tokens:
                tok_to_orig.append(i)
                all_doc_tokens.append(sub)

        tok_start = tok_end = None
        if is_training and not ex.is_impossible:
            tok_start = orig_to_tok[ex.start_position]
            if ex.end_position < len(ex.doc_tokens) - 1:
                tok_end = orig_to_tok[ex.end_position + 1] - 1
            else:
                tok_end = len(all_doc_tokens) - 1
            tok_start, tok_end = improve_answer_span(
                all_doc_tokens, tok_start, tok_end, tokenizer,
                ex.orig_answer_text)

        max_doc = max_seq_length - len(query) - 3  # [CLS] q [SEP] d [SEP]
        spans: List[_DocSpan] = []
        offset = 0
        while offset < len(all_doc_tokens):
            length = min(len(all_doc_tokens) - offset, max_doc)
            spans.append(_DocSpan(offset, length))
            if offset + length == len(all_doc_tokens):
                break
            offset += min(length, doc_stride)

        for span_idx, span in enumerate(spans):
            tokens = ["[CLS]"] + query + ["[SEP]"]
            segment_ids = [0] * len(tokens)
            token_to_orig_map: Dict[int, int] = {}
            token_is_max_context: Dict[int, bool] = {}
            for i in range(span.length):
                pos = span.start + i
                token_to_orig_map[len(tokens)] = tok_to_orig[pos]
                token_is_max_context[len(tokens)] = check_is_max_context(
                    spans, span_idx, pos)
                tokens.append(all_doc_tokens[pos])
                segment_ids.append(1)
            tokens.append("[SEP]")
            segment_ids.append(1)

            ids = [tokenizer.token_to_id(t) if tokenizer.token_to_id(t)
                   is not None else unk_id for t in tokens]
            mask = [1] * len(ids)
            pad = max_seq_length - len(ids)
            ids += [0] * pad
            mask += [0] * pad
            segment_ids += [0] * pad

            start_pos = end_pos = None
            if is_training:
                start_pos = end_pos = 0
                if (not ex.is_impossible and tok_start >= span.start
                        and tok_end <= span.start + span.length - 1):
                    shift = len(query) + 2 - span.start
                    start_pos, end_pos = tok_start + shift, tok_end + shift

            features.append(InputFeatures(
                unique_id=unique_id, example_index=ex_idx,
                doc_span_index=span_idx, tokens=tokens,
                token_to_orig_map=token_to_orig_map,
                token_is_max_context=token_is_max_context,
                input_ids=ids, input_mask=mask, segment_ids=segment_ids,
                start_position=start_pos, end_position=end_pos,
                is_impossible=ex.is_impossible))
            unique_id += 1
    return features


def cached_features(cache_path: str, builder) -> List[InputFeatures]:
    """A pickle cache around featurization: read `cache_path` if it
    exists, else build and write it."""
    if os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    feats = builder()
    with open(cache_path, "wb") as f:
        pickle.dump(feats, f)
    return feats


def features_to_arrays(features: List[InputFeatures], is_training: bool
                       ) -> Dict[str, np.ndarray]:
    """Features -> int32 (N, S) arrays (input_ids, token_type_ids,
    attention_mask), int64 unique_ids and, training, int32 start/end
    positions."""
    out = {
        "input_ids": np.array([f.input_ids for f in features], np.int32),
        "token_type_ids": np.array([f.segment_ids for f in features],
                                   np.int32),
        "attention_mask": np.array([f.input_mask for f in features],
                                   np.int32),
        "unique_ids": np.array([f.unique_id for f in features], np.int64),
    }
    if is_training:
        out["start_positions"] = np.array(
            [f.start_position for f in features], np.int32)
        out["end_positions"] = np.array(
            [f.end_position for f in features], np.int32)
    return out


@dataclass
class AnswerConfig:
    n_best_size: int = 20
    max_answer_length: int = 30
    do_lower_case: bool = True
    version_2_with_negative: bool = False
    null_score_diff_threshold: float = 0.0
    verbose_logging: bool = False


_Prelim = collections.namedtuple(
    "Prelim", ["start_index", "end_index", "start_logit", "end_logit"])
_Pred = collections.namedtuple("Pred", ["text", "start_logit", "end_logit"])


def _best_indices(logits, n: int) -> List[int]:
    return [i for i, _ in sorted(enumerate(logits), key=lambda x: -x[1])[:n]]


def _valid_prelims(starts, ends, feat: InputFeatures, result,
                   cfg: AnswerConfig) -> List[_Prelim]:
    out = []
    for si in starts:
        for ei in ends:
            if si >= len(feat.tokens) or ei >= len(feat.tokens):
                continue
            if si not in feat.token_to_orig_map:
                continue
            if ei not in feat.token_to_orig_map:
                continue
            if not feat.token_is_max_context.get(si, False):
                continue
            if ei < si or ei - si + 1 > cfg.max_answer_length:
                continue
            out.append(_Prelim(si, ei, result.start_logits[si],
                               result.end_logits[ei]))
    return out


def _answer_text(ex: SquadExample, feat: InputFeatures, pred: _Prelim,
                 cfg: AnswerConfig) -> str:
    tok_text = " ".join(feat.tokens[pred.start_index:pred.end_index + 1])
    tok_text = tok_text.replace(" ##", "").replace("##", "")
    tok_text = " ".join(tok_text.split())
    lo = feat.token_to_orig_map[pred.start_index]
    hi = feat.token_to_orig_map[pred.end_index]
    orig_text = " ".join(ex.doc_tokens[lo:hi + 1])
    return get_final_text(tok_text, orig_text, cfg.do_lower_case,
                          cfg.verbose_logging)


def get_answers(examples: List[SquadExample], features: List[InputFeatures],
                results: List[RawResult], cfg: AnswerConfig
                ) -> Tuple[Dict[str, str], Dict[str, list]]:
    """n-best answers per question (reference get_answers :427-506).
    Returns (answers, nbest_answers)."""
    by_qid: Dict[str, List[_Pred]] = collections.defaultdict(list)
    null_vals: Dict[str, Tuple[float, float, float]] = collections.defaultdict(
        lambda: (float("inf"), 0.0, 0.0))

    results_by_id = {r.unique_id: r for r in results}
    for feat in sorted(features, key=lambda f: f.unique_id):
        result = results_by_id.get(feat.unique_id)
        if result is None:
            continue
        ex = examples[feat.example_index]
        starts = _best_indices(result.start_logits, cfg.n_best_size)
        ends = _best_indices(result.end_logits, cfg.n_best_size)
        prelims = sorted(_valid_prelims(starts, ends, feat, result, cfg),
                         key=lambda p: -(p.start_logit + p.end_logit))

        if cfg.version_2_with_negative:
            null_score = result.start_logits[0] + result.end_logits[0]
            if null_score < null_vals[ex.qas_id][0]:
                null_vals[ex.qas_id] = (null_score, result.start_logits[0],
                                        result.end_logits[0])

        seen: List[str] = []
        kept: List[_Pred] = []
        for p in prelims:
            if len(kept) == cfg.n_best_size:
                break
            if p.start_index > 0:
                text = _answer_text(ex, feat, p, cfg)
                if text in seen:
                    continue
            else:
                text = ""
            seen.append(text)
            kept.append(_Pred(text, p.start_logit, p.end_logit))
        by_qid[ex.qas_id] += kept

    if cfg.version_2_with_negative:
        for qid in by_qid:
            _, s0, e0 = null_vals[qid]
            by_qid[qid].append(_Pred("", s0, e0))

    answers: Dict[str, str] = {}
    nbest_answers: Dict[str, list] = collections.defaultdict(list)
    for qid, preds in by_qid.items():
        nbest = sorted(preds,
                       key=lambda p: -(p.start_logit + p.end_logit)
                       )[:cfg.n_best_size]
        if not nbest:
            nbest = [_Pred("empty", 0.0, 0.0)]
        scores = [p.start_logit + p.end_logit for p in nbest]
        probs = _softmax(scores)
        best_non_null = next((p for p in nbest if p.text), None)
        for p, prob in zip(nbest, probs):
            nbest_answers[qid].append({
                "text": p.text, "probability": prob,
                "start_logit": float(p.start_logit),
                "end_logit": float(p.end_logit)})
        if cfg.version_2_with_negative:
            if best_non_null is None:
                answers[qid] = ""
            else:
                diff = (null_vals[qid][0] - best_non_null.start_logit
                        - best_non_null.end_logit)
                answers[qid] = ("" if diff > cfg.null_score_diff_threshold
                                else best_non_null.text)
        else:
            answers[qid] = nbest[0].text
    return answers, nbest_answers


def _softmax(scores: List[float]) -> List[float]:
    if not scores:
        return []
    mx = max(scores)
    exps = [math.exp(s - mx) for s in scores]
    z = sum(exps)
    return [e / z for e in exps]


def get_final_text(pred_text: str, orig_text: str, do_lower_case: bool,
                   verbose: bool = False) -> str:
    """Project the normalized predicted span back onto the original document
    text via character alignment (reference :570-656)."""

    def strip_spaces(text):
        chars, mapping = [], collections.OrderedDict()
        for i, c in enumerate(text):
            if c == " ":
                continue
            mapping[len(chars)] = i
            chars.append(c)
        return "".join(chars), mapping

    basic = BasicTokenizer(do_lower_case=do_lower_case)
    tok_text = " ".join(basic.tokenize(orig_text))

    start = tok_text.find(pred_text)
    if start == -1:
        return orig_text
    end = start + len(pred_text) - 1

    orig_ns, orig_map = strip_spaces(orig_text)
    tok_ns, tok_map = strip_spaces(tok_text)
    if len(orig_ns) != len(tok_ns):
        return orig_text

    tok_s_to_ns = {v: k for k, v in tok_map.items()}

    def project(pos):
        ns = tok_s_to_ns.get(pos)
        if ns is None:
            return None
        return orig_map.get(ns)

    o_start, o_end = project(start), project(end)
    if o_start is None or o_end is None:
        return orig_text
    return orig_text[o_start:o_end + 1]


# -- evaluation (the official SQuAD v1.1 / v2.0 metric math, in-process) -----

def _normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(c for c in s if c not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _f1(pred: str, gold: str) -> float:
    pred_toks = _normalize_answer(pred).split()
    gold_toks = _normalize_answer(gold).split()
    common = collections.Counter(pred_toks) & collections.Counter(gold_toks)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred_toks)
    recall = overlap / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def evaluate_v1(dataset_file: str, predictions: Dict[str, str]
                ) -> Dict[str, float]:
    """exact_match / f1 (percent) over the dev set, the official v1.1
    math; a question without a prediction scores 0."""
    with open(dataset_file, "r", encoding="utf-8") as f:
        dataset = json.load(f)["data"]
    em_total = f1_total = count = 0.0
    for entry in dataset:
        for paragraph in entry["paragraphs"]:
            for qa in paragraph["qas"]:
                count += 1
                if qa["id"] not in predictions:
                    continue
                pred = predictions[qa["id"]]
                golds = [a["text"] for a in qa["answers"]] or [""]
                em_total += max(
                    float(_normalize_answer(pred) == _normalize_answer(g))
                    for g in golds)
                f1_total += max(_f1(pred, g) for g in golds)
    return {"exact_match": 100.0 * em_total / max(count, 1),
            "f1": 100.0 * f1_total / max(count, 1)}


def evaluate_v2(dataset_file: str, predictions: Dict[str, str]
                ) -> Dict[str, float]:
    """exact_match / f1 with no-answer handling (the official v2.0 math),
    plus HasAns_* / NoAns_* splits. A no-answer gold scores 1 iff the
    prediction is empty; a missing prediction scores 0 and is counted in
    `missing_predictions` (present only when nonzero)."""
    with open(dataset_file, "r", encoding="utf-8") as f:
        dataset = json.load(f)["data"]
    em = collections.defaultdict(float)
    f1 = collections.defaultdict(float)
    n = collections.Counter()
    for entry in dataset:
        for paragraph in entry["paragraphs"]:
            for qa in paragraph["qas"]:
                golds = [a["text"] for a in qa["answers"]
                         if _normalize_answer(a["text"])]
                kind = "HasAns" if golds else "NoAns"
                n["total"] += 1
                n[kind] += 1
                if not golds:
                    golds = [""]
                if qa["id"] not in predictions:
                    n["missing"] += 1
                    continue
                pred = predictions[qa["id"]]
                q_em = max(float(_normalize_answer(pred)
                                 == _normalize_answer(g)) for g in golds)
                q_f1 = max((q_em if not _normalize_answer(g)
                            or not _normalize_answer(pred)
                            else _f1(pred, g)) for g in golds)
                for d, v in ((em, q_em), (f1, q_f1)):
                    d["total"] += v
                    d[kind] += v
    out = {"exact_match": 100.0 * em["total"] / max(n["total"], 1),
           "f1": 100.0 * f1["total"] / max(n["total"], 1)}
    for kind in ("HasAns", "NoAns"):
        if n[kind]:
            out[f"{kind}_exact"] = 100.0 * em[kind] / n[kind]
            out[f"{kind}_f1"] = 100.0 * f1[kind] / n[kind]
    if n["missing"]:
        out["missing_predictions"] = float(n["missing"])
    return out
