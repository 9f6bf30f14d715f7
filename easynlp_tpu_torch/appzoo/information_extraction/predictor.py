"""Information extraction predictor for the PyTorch port (counterpart of
easynlp_tpu/appzoo/information_extraction/predictor.py): every span scored
above 0 as `start,end,type,text` (character offsets, the [CLS] shift
undone), joined by `;`, the type names from label_mapping.json."""

import json
import os

import numpy as np

from easynlp_tpu_torch.appzoo.information_extraction.data import encode_chars
from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
from easynlp_tpu_torch.utils.io_utils import io


class InformationExtractionPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence="content",
                 sequence_length=128, batch_size=16, **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.first_sequence = first_sequence or "content"
        self.sequence_length = sequence_length
        label_path = os.path.join(model_dir, "label_mapping.json")
        mapping = {}
        if io.exists(label_path):
            with io.open(label_path) as f:
                mapping = json.load(f)
        self.id_to_type = {int(v): k for k, v in mapping.items()}
        self.model_predictor = PyModelPredictor(
            app,
            input_keys=[("input_ids", np.int32), ("attention_mask", np.int32),
                        ("token_type_ids", np.int32)],
            output_keys=["span_scores"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        texts = [str(t) for t in in_data[self.first_sequence]]
        n, max_len = len(texts), self.sequence_length
        ids = np.full((n, max_len), self.tokenizer.pad_token_id, np.int32)
        mask = np.zeros((n, max_len), np.int32)
        for i, text in enumerate(texts):
            row = encode_chars(self.tokenizer, text, max_len)
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        out = dict(in_data)
        out.update(input_ids=ids, attention_mask=mask,
                   token_type_ids=np.zeros_like(ids), _texts=texts)
        return out

    def predict(self, in_data):
        texts = in_data.pop("_texts")
        result = self.model_predictor.predict(in_data)
        result["_texts"] = texts
        return result

    def postprocess(self, result):
        scores = np.asarray(result["span_scores"])
        outputs = []
        for i, text in enumerate(result["_texts"]):
            spans = []
            for t, s, e in zip(*np.nonzero(scores[i] > 0)):
                start, end = int(s) - 1, int(e) - 1  # undo the [CLS] shift
                if 0 <= start <= end < len(text):
                    spans.append("%d,%d,%s,%s" % (
                        start, end, self.id_to_type.get(int(t), str(t)),
                        text[start:end + 1]))
            outputs.append(";".join(spans))
        out = {k: v for k, v in result.items() if not k.startswith("_")}
        out["predictions"] = outputs
        return out
