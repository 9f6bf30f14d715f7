"""Video-to-text predictor for the PyTorch port (counterpart of
easynlp_tpu/appzoo/video2text_generation/predictor.py): a frame list (or
frame directory) per row; its first frame_num frames are the prefix."""

from easynlp_tpu_torch.appzoo.image2text_generation.predictor import (
    ImageTextGenerationPredictor,
)


class FrameTextGenerationPredictor(ImageTextGenerationPredictor):
    frame_input = True
