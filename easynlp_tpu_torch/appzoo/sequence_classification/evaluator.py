"""Classification evaluator for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_classification/evaluator.py, with
the same metrics, names and order (primary metric first): accuracy, F1
(binary for two classes, else macro over the labels present), AUC and MCC
for two classes, and the opt-in precision/recall, classification report and
pearson/spearman. The JAX package computes them with scikit-learn; here they
are numpy (and scipy for ranks and correlations), written to give
scikit-learn's values: ties in AUC count one half, F1/precision/recall are 0
where undefined (zero_division=0).
"""

import time

import numpy as np

from easynlp_tpu_torch.core.evaluator import Evaluator
from easynlp_tpu_torch.utils.logger import logger


class SequenceClassificationEvaluator(Evaluator):
    def __init__(self, valid_dataset, multi_label=False, eval_metrics=None,
                 **kwargs):
        super().__init__(valid_dataset, **kwargs)
        if multi_label:
            raise NotImplementedError(
                "the multi-label evaluator is not ported yet (ROADMAP A5)")
        args = kwargs.get("args") or self.args
        raw = eval_metrics or getattr(args, "user_defined_parameters_dict",
                                      {}).get("eval_metrics")
        self.eval_metrics = raw.split(",") if isinstance(raw, str) else raw

    def evaluate(self, app):
        logits_all, labels_all = [], []
        t0 = time.perf_counter()
        for batch in self.valid_loader:
            keep = batch.pop("_valid").astype(bool)
            out = self.forward(app, batch)
            logits_all.append(out["logits"].float().cpu().numpy()[keep])
            labels_all.append(batch["label_ids"][keep])
        seconds = time.perf_counter() - t0
        logits = np.concatenate(logits_all)
        labels = np.concatenate(labels_all)
        logger.info("eval: %d samples in %.2fs (%.2f ms/sample)", len(labels),
                    seconds, 1000.0 * seconds / max(len(labels), 1))
        return single_label_metrics(logits, labels, self.eval_metrics)


def single_label_metrics(logits, labels, requested=None):
    """[(metric, score), ...] from [N, C] logits and [N] int labels."""
    requested = requested or []
    preds = logits.argmax(-1)
    n_classes = logits.shape[-1]
    if "pearson_and_spearman" in requested or n_classes == 1:
        from scipy.stats import pearsonr, spearmanr
        scores = logits[:, 0] if logits.ndim > 1 else logits
        pearson = float(pearsonr(scores, labels)[0])
        spearman = float(spearmanr(scores, labels)[0])
        return [("pearson_and_spearman", (pearson + spearman) / 2.0),
                ("pearson", pearson), ("spearman", spearman)]
    results = [("accuracy", float(np.mean(labels == preds)))]
    average = "binary" if n_classes == 2 else "macro"
    prf = precision_recall_f1(labels, preds, average)
    if prf is not None:
        results.append(("f1", prf[2]))
    if n_classes == 2 and len(set(labels.tolist())) == 2:
        results.append(("auc", roc_auc(labels, _softmax(logits)[:, 1])))
        results.append(("mcc", matthews_corrcoef(labels, preds)))
    if ("precision_recall" in requested
            or "classification_report" in requested) and prf is not None:
        results.append(("precision", prf[0]))
        results.append(("recall", prf[1]))
    if "classification_report" in requested:
        logger.info("\n%s", classification_report(labels, preds))
    return results


def _per_class(labels, preds, classes):
    """(tp, fp, fn, support) per class, as float arrays."""
    tp = np.array([np.sum((preds == c) & (labels == c)) for c in classes],
                  np.float64)
    fp = np.array([np.sum((preds == c) & (labels != c)) for c in classes],
                  np.float64)
    fn = np.array([np.sum((preds != c) & (labels == c)) for c in classes],
                  np.float64)
    return tp, fp, fn, tp + fn


def _ratio(num, den):
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)


def precision_recall_f1(labels, preds, average):
    """(precision, recall, f1) as scikit-learn gives them with
    zero_division=0: 'binary' scores label 1, 'macro' averages over the
    labels present in labels or preds. None where scikit-learn raises
    (average='binary' on labels other than {0, 1})."""
    present = np.union1d(labels, preds)
    if average == "binary":
        if len(present) > 2 or (len(present) == 2 and 1 not in present):
            return None
        classes = [1]
    else:
        classes = present.tolist()
    tp, fp, fn, _ = _per_class(labels, preds, classes)
    precision = _ratio(tp, tp + fp)
    recall = _ratio(tp, tp + fn)
    f1 = _ratio(2 * tp, 2 * tp + fp + fn)
    return (float(np.mean(precision)), float(np.mean(recall)),
            float(np.mean(f1)))


def roc_auc(labels, scores):
    """Area under the ROC curve of the larger label against the other, from
    average ranks (the Mann-Whitney U): a tie between a positive and a
    negative counts one half, as in scikit-learn's trapezoids."""
    from scipy.stats import rankdata
    positive = labels == np.max(labels)
    n_pos = int(positive.sum())
    n_neg = len(labels) - n_pos
    ranks = rankdata(scores)
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def matthews_corrcoef(labels, preds):
    """scikit-learn's multiclass MCC from the confusion matrix; 0 where a
    marginal is constant."""
    classes = np.union1d(labels, preds)
    index = {c: i for i, c in enumerate(classes.tolist())}
    cm = np.zeros((len(classes), len(classes)), np.float64)
    for t, p in zip(labels.tolist(), preds.tolist()):
        cm[index[t], index[p]] += 1
    t_sum, p_sum = cm.sum(axis=1), cm.sum(axis=0)
    n_correct, n = np.trace(cm), cm.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n * n - np.dot(p_sum, p_sum)
    cov_ytyt = n * n - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))


def classification_report(labels, preds):
    """Per-class precision, recall, F1 and support as a text table."""
    classes = np.union1d(labels, preds).tolist()
    tp, fp, fn, support = _per_class(labels, preds, classes)
    precision, recall = _ratio(tp, tp + fp), _ratio(tp, tp + fn)
    f1 = _ratio(2 * tp, 2 * tp + fp + fn)
    lines = ["%12s %9s %9s %9s %9s" % ("", "precision", "recall", "f1-score",
                                        "support")]
    for i, c in enumerate(classes):
        lines.append("%12s %9.4f %9.4f %9.4f %9d" % (
            c, precision[i], recall[i], f1[i], support[i]))
    lines.append("%12s %9s %9s %9.4f %9d" % ("accuracy", "", "",
                                             np.mean(labels == preds),
                                             len(labels)))
    return "\n".join(lines)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)
