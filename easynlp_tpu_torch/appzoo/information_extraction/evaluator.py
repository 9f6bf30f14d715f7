"""Information extraction evaluator for the PyTorch port (counterpart of
easynlp_tpu/appzoo/information_extraction/evaluator.py): span-level
precision, recall and F1 of the spans scored above 0, over the real rows,
F1 first."""

import numpy as np

from easynlp_tpu_torch.core.evaluator import Evaluator


class InformationExtractionEvaluator(Evaluator):
    def __init__(self, valid_dataset, **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)

    def evaluate(self, app):
        tp = fp = fn = 0
        for batch in self.valid_loader:
            valid = batch.pop("_valid").astype(bool)
            out = self.forward(app, batch)
            pred = out["span_scores"].float().cpu().numpy()[valid] > 0
            gold = batch["span_labels"][valid] > 0
            tp += int((pred & gold).sum())
            fp += int((pred & ~gold).sum())
            fn += int((~pred & gold).sum())
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-8)
        return [("f1", f1), ("precision", precision), ("recall", recall)]
