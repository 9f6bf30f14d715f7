"""Latent diffusion dataset for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/latent_diffusion/data.py: the CLIP
dataset's rows (text + base64 image, or webdataset shards), each image
resized (short side, bicubic), centre-cropped and scaled to [-1, 1] as
`pixel_values` [H, W, 3] f32. With user_defined_parameters
`controlnet_hint_column=<column>` each row's conditioning map (a base64
image in that column) comes out as `hint_values` in [0, 1], for
ControlNet training; without it the ControlNet app derives an edge map
from the image.
"""

import numpy as np

from easynlp_tpu_torch.appzoo.clip.data import CLIPDataset
from easynlp_tpu_torch.data.image_utils import (
    decode_base64_image,
    preprocess_image_pm1,
)


class LDMDataset(CLIPDataset):
    def __init__(self, *args, **kwargs):
        udp = kwargs.get("user_defined_parameters") or {}
        hint_col = kwargs.pop("hint_column", None) or \
            udp.get("controlnet_hint_column")
        super().__init__(*args, **kwargs)
        self._hint_col = hint_col or None
        if hint_col and self.schema is None:
            raise ValueError(
                "controlnet_hint_column needs schema'd TSV rows: pass "
                "--input_schema naming the hint column (webdataset tars "
                "carry no extra columns, so they cannot provide one)")

    def __getitem__(self, idx):
        out = {k: v[idx] for k, v in self.text_features.items()}
        out["pixel_values"] = preprocess_image_pm1(
            self._decode(idx), self.image_size).astype(np.float32)
        if self._hint_col is not None:
            b64 = str(self.parse_row(self.rows[idx]).get(self._hint_col, ""))
            hint = preprocess_image_pm1(decode_base64_image(b64),
                                        self.image_size)
            out["hint_values"] = (hint.astype(np.float32) + 1.0) / 2.0
        return out
