"""Text-to-image evaluator for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text2image_generation/evaluator.py: the
validation loss (LM over the image codes + the VQ losses) through the
LossEvaluator that image2text and video2text share, each batch's loss
over its real rows (ROADMAP reference fault 27), reported as
`eval_loss` = -loss.
"""

from easynlp_tpu_torch.appzoo.image2text_generation.evaluator import (
    LossEvaluator,
)


class TextImageGenerationEvaluator(LossEvaluator):
    pass
