"""Wukong CLIP evaluator for the PyTorch port (counterpart of
easynlp_tpu/appzoo/wukong_clip/evaluator.py): the CLIP evaluator."""

from easynlp_tpu_torch.appzoo.clip.evaluator import CLIPEvaluator


class WukongCLIPEvaluator(CLIPEvaluator):
    pass
