"""Wukong CLIP dataset for the PyTorch port (counterpart of
easynlp_tpu/appzoo/wukong_clip/data.py): the CLIP rows; only the
checkpoint dialect differs."""

from easynlp_tpu_torch.appzoo.clip.data import CLIPDataset


class WukongCLIPDataset(CLIPDataset):
    pass
