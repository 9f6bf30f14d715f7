"""Machine reading comprehension evaluator for the PyTorch port
(counterpart of easynlp_tpu/appzoo/machine_reading_comprehension/
evaluator.py): the predicted span (each side's argmax) against the gold
span, by token-position F1 and exact match, averaged over the rows."""

import numpy as np

from easynlp_tpu_torch.core.evaluator import Evaluator


class MRCEvaluator(Evaluator):
    def __init__(self, valid_dataset, **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)

    def evaluate(self, app):
        exact = f1_sum = n = 0
        for batch in self.valid_loader:
            valid = batch.pop("_valid").astype(bool)
            out = self.forward(app, batch)
            sp = np.asarray(out["start_predictions"].cpu())[valid]
            ep = np.asarray(out["end_predictions"].cpu())[valid]
            sg = batch["start_positions"][valid]
            eg = batch["end_positions"][valid]
            for s, e, gs, ge in zip(sp, ep, sg, eg):
                pred = set(range(int(s), int(e) + 1)) if e >= s else set()
                gold = set(range(int(gs), int(ge) + 1))
                exact += int(s == gs and e == ge)
                inter = len(pred & gold)
                if inter:
                    prec, rec = inter / len(pred), inter / len(gold)
                    f1_sum += 2 * prec * rec / (prec + rec)
                n += 1
        return [("f1", f1_sum / max(n, 1)), ("exact_match", exact / max(n, 1))]
