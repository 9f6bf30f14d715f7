"""Machine reading comprehension predictor for the PyTorch port
(counterpart of easynlp_tpu/appzoo/machine_reading_comprehension/
predictor.py): starts and ends restricted to the context's tokens (token
type 1), the 20 best starts searched for the best start + end score with
the end at most max_answer_length - 1 tokens past the start, and the span's
tokens decoded into `predictions` and `best_answer`."""

import numpy as np

from easynlp_tpu_torch.appzoo.machine_reading_comprehension.data import (
    encode_pair,
)
from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer

TOP_STARTS = 20


def best_span(start_logits, end_logits, context, max_answer_length):
    """(start, end) maximising start + end logit over the TOP_STARTS best
    context starts and the ends from each start to start +
    max_answer_length - 1; (0, 0) when none scores above -1e30."""
    s_log = np.where(context, start_logits, -1e30)
    e_log = np.where(context, end_logits, -1e30)
    best, span = -1e30, (0, 0)
    for s in np.argsort(s_log)[-TOP_STARTS:]:
        for e in range(s, min(s + max_answer_length, len(e_log))):
            score = s_log[s] + e_log[e]
            if score > best:
                best, span = score, (s, e)
    return span


class MRCPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence="question",
                 second_sequence="context", sequence_length=384,
                 batch_size=8, max_answer_length=30, **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.question_col = first_sequence or "question"
        self.context_col = second_sequence or "context"
        self.sequence_length = sequence_length
        self.max_answer_length = max_answer_length
        self.model_predictor = PyModelPredictor(
            app,
            input_keys=[("input_ids", np.int32), ("attention_mask", np.int32),
                        ("token_type_ids", np.int32)],
            output_keys=["start_logits", "end_logits"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        tok = self.tokenizer
        max_len = self.sequence_length
        feats = {"input_ids": [], "attention_mask": [], "token_type_ids": []}
        all_ids = []
        for q, c in zip(in_data[self.question_col], in_data[self.context_col]):
            _, _, ids, types = encode_pair(tok, str(q), str(c), max_len)
            pad = max_len - len(ids)
            feats["input_ids"].append(ids + [tok.pad_token_id] * pad)
            feats["attention_mask"].append([1] * len(ids) + [0] * pad)
            feats["token_type_ids"].append(types + [0] * pad)
            all_ids.append(ids)
        out = dict(in_data)
        out.update({k: np.asarray(v, np.int32) for k, v in feats.items()})
        out["_raw_ids"] = all_ids
        return out

    def predict(self, in_data):
        raw = in_data.pop("_raw_ids")
        result = self.model_predictor.predict(in_data)
        result["_raw_ids"] = raw
        return result

    def postprocess(self, result):
        starts = np.asarray(result["start_logits"])
        ends = np.asarray(result["end_logits"])
        types = np.asarray(result["token_type_ids"])
        answers = []
        for i, ids in enumerate(result["_raw_ids"]):
            s, e = best_span(starts[i], ends[i], types[i] == 1,
                             self.max_answer_length)
            answers.append(self.tokenizer.decode(ids[s:e + 1]
                                                 if e < len(ids) else []))
        out = {k: v for k, v in result.items() if not k.startswith("_")}
        out["predictions"] = answers
        out["best_answer"] = answers
        return out
