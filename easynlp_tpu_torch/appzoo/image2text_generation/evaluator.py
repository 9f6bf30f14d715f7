"""Image-to-text evaluator for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/image2text_generation/evaluator.py and
the LossEvaluator it shares with text2image and video2text
(easynlp_tpu/appzoo/text2image_generation/evaluator.py): the validation
loss, each batch's taken over its real rows and weighted by their count,
reported as `eval_loss` = -loss so that higher is better for the
Trainer's best checkpoint. (JAX's takes each padded batch whole:
ROADMAP reference fault 27.)
"""

import torch

from easynlp_tpu_torch.core.evaluator import Evaluator
from easynlp_tpu_torch.utils.logger import logger


class LossEvaluator(Evaluator):
    def __init__(self, valid_dataset, app_loss_fn=None, **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)
        self.metrics = ["loss"]

    def evaluate(self, app):
        total_loss, total_weight = 0.0, 0
        for batch in self.valid_loader:
            valid = batch.pop("_valid").astype(bool)
            # the real rows only: JAX's loss also takes the copies of row 0
            # that pad a last partial batch (ROADMAP reference fault 27)
            batch = {k: v[valid] for k, v in batch.items()}
            out = self.forward(app, batch)
            labels = {k: torch.as_tensor(batch[k],
                                         device=out["logits"].device)
                      for k in ("input_ids", "attention_mask")}
            loss = float(app.loss_fn(out, labels)["loss"])
            total_loss += loss * int(valid.sum())
            total_weight += int(valid.sum())
        eval_loss = total_loss / max(total_weight, 1)
        logger.info("Eval loss: %.6f", eval_loss)
        return [("eval_loss", -eval_loss)]


class ImageTextGenerationEvaluator(LossEvaluator):
    pass
