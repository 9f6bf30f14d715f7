"""Video-to-text evaluator for the PyTorch port (counterpart of
easynlp_tpu/appzoo/video2text_generation/evaluator.py): the validation
loss."""

from easynlp_tpu_torch.appzoo.image2text_generation.evaluator import (
    LossEvaluator,
)


class FrameTextGenerationEvaluator(LossEvaluator):
    pass
