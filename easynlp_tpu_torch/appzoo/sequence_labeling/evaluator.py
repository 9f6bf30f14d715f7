"""Sequence labeling evaluator for the PyTorch port (counterpart of
easynlp_tpu/appzoo/sequence_labeling/evaluator.py): at the labelled
positions (label id not -100) the predicted and gold ids become tags; the
metrics are entity-level precision, recall and F1 over BIO spans, primary
F1 first, and token accuracy."""

import numpy as np

from easynlp_tpu_torch.core.evaluator import Evaluator


def bio_spans(labels):
    """The set of (type, start, end) spans of a BIO tag sequence."""
    spans, start, etype = [], None, None
    for i, tag in enumerate(list(labels) + ["O"]):
        if tag.startswith("B-"):
            if start is not None:
                spans.append((etype, start, i))
            start, etype = i, tag[2:]
        elif tag.startswith("I-") and start is not None and tag[2:] == etype:
            continue
        else:
            if start is not None:
                spans.append((etype, start, i))
            start, etype = None, None
    return set(spans)


class SequenceLabelingEvaluator(Evaluator):
    def __init__(self, valid_dataset, **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)
        self.id_to_label = {v: k for k, v in
                            valid_dataset.label_mapping.items()}

    def evaluate(self, app):
        tp = fp = fn = correct = total = 0
        for batch in self.valid_loader:
            valid = batch.pop("_valid").astype(bool)
            out = self.forward(app, batch)
            preds = np.asarray(out["predictions"].cpu())[valid]
            golds = batch["label_ids"][valid]
            for p_row, g_row in zip(preds, golds):
                keep = g_row != -100
                p_tags = [self.id_to_label.get(int(p), "O")
                          for p in p_row[keep]]
                g_tags = [self.id_to_label.get(int(g), "O")
                          for g in g_row[keep]]
                correct += sum(p == g for p, g in zip(p_tags, g_tags))
                total += len(g_tags)
                p_spans, g_spans = bio_spans(p_tags), bio_spans(g_tags)
                tp += len(p_spans & g_spans)
                fp += len(p_spans - g_spans)
                fn += len(g_spans - p_spans)
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-8)
        return [("f1", f1), ("precision", precision), ("recall", recall),
                ("accuracy", correct / max(total, 1))]
