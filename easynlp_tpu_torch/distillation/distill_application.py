"""Vanilla knowledge distillation for the PyTorch port (counterpart of
easynlp_tpu/distillation/distill_application.py): the text_classify student
trained on alpha * CE(labels) + (1 - alpha) * T^2 * KL(teacher || student)
at temperature T, against the `teacher_logits` column of
DistillatoryClassificationDataset.

`configure(user_defined_parameters)` sets `temperature` and `alpha`, and
the api calls it. The JAX package never calls its `configure`, so its KD
runs at T = 1 and alpha = 0.5 whatever the parameters say (ROADMAP
reference fault 20); at those defaults the two agree.
"""

from easynlp_tpu_torch.appzoo.sequence_classification.model import (
    SequenceClassification,
)
from easynlp_tpu_torch.utils import losses


class DistillatorySequenceClassification(SequenceClassification):
    temperature = 1.0
    alpha = 0.5

    def configure(self, udp):
        self.temperature = float(udp.get("temperature", 1.0))
        self.alpha = float(udp.get("alpha", 0.5))
        return self

    def loss_fn(self, outputs, batch):
        return {"loss": losses.vanilla_kd_loss(
            outputs["logits"], batch["teacher_logits"], batch["label_ids"],
            temperature=self.temperature, alpha=self.alpha)}
