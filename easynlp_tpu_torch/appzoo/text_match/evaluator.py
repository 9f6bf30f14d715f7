"""Text match evaluators for the PyTorch port (counterpart of
easynlp_tpu/appzoo/text_match/evaluator.py): the classification metrics on
the cross-encoder's logits, and on the two-tower module's [-sim, sim]
logits, so a pair counts as a match where its similarity is positive."""

from easynlp_tpu_torch.appzoo.sequence_classification.evaluator import (
    SequenceClassificationEvaluator,
)


class TextMatchEvaluator(SequenceClassificationEvaluator):
    pass


class TextMatchTwoTowerEvaluator(SequenceClassificationEvaluator):
    pass
