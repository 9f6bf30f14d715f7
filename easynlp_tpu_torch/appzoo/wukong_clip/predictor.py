"""Wukong CLIP predictor for the PyTorch port (counterpart of
easynlp_tpu/appzoo/wukong_clip/predictor.py): the CLIP predictor."""

from easynlp_tpu_torch.appzoo.clip.predictor import CLIPPredictor


class WukongCLIPPredictor(CLIPPredictor):
    pass
