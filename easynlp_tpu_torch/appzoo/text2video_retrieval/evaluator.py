"""Text-video retrieval evaluator for the PyTorch port (counterpart of
easynlp_tpu/appzoo/text2video_retrieval/evaluator.py): CLIP4ClipModule
gives `image_embeds` as an alias of `video_embeds`, so the CLIP
evaluator's recalls apply (t2i = text-to-video)."""

from easynlp_tpu_torch.appzoo.clip.evaluator import CLIPEvaluator


class Text2VideoRetrievalEvaluator(CLIPEvaluator):
    pass
