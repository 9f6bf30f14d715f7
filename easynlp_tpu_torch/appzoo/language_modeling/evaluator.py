"""MLM evaluator for the PyTorch port (counterpart of
easynlp_tpu/appzoo/language_modeling/evaluator.py): accuracy over the
masked positions and perplexity, exp of their mean negative
log-likelihood, reported negated (`-ppl`) as the JAX package reports it so
that a larger score is better.

Each batch reduces its logits on the device, in f32 and by the JAX
evaluator's formula (max-subtracted logsumexp minus the gold logit), to
one NLL and one hit per masked position of the real rows; only those come
back to the host, where they are summed per batch as there.
"""

import numpy as np
import torch

from easynlp_tpu_torch.core.evaluator import Evaluator


class LanguageModelingEvaluator(Evaluator):
    def __init__(self, valid_dataset, **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)

    def evaluate(self, app):
        total_nll, total_correct, total_count = 0.0, 0, 0
        for batch in self.valid_loader:
            valid = batch.pop("_valid").astype(bool)
            labels = np.where(valid[:, None], batch["label_ids"], -100)
            keep = labels != -100
            if not keep.any():
                continue
            logits = self.forward(app, batch)["logits"]
            nll, hit = masked_nll(logits, torch.from_numpy(keep).to(
                logits.device), torch.from_numpy(labels).to(logits.device))
            total_nll += float(nll.cpu().numpy().sum())
            total_correct += int(hit.sum())
            total_count += int(keep.sum())
        ppl = float(np.exp(total_nll / max(total_count, 1)))
        acc = total_correct / max(total_count, 1)
        return [("accuracy", acc), ("perplexity", -ppl)]


def masked_nll(logits, keep, labels):
    """(f32 NLL, bool hit) at the positions where `keep` is set, in
    row-major order: logits [..., V], keep and labels [...]."""
    x = logits[keep].float()
    gold_ids = labels[keep].long()
    m = x.max(dim=-1, keepdim=True).values
    lse = (m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)))[:, 0]
    gold = torch.gather(x, -1, gold_ids[:, None])[:, 0]
    return lse - gold, x.argmax(dim=-1) == gold_ids
