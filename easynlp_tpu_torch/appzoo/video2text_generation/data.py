"""Video-to-text (frame captioning) dataset for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/video2text_generation/data.py: rows
`frames<TAB>caption`, the frames a JSON list of base64 images or a frame
directory, of which the first frame_num (udp, default 3) go through the
CLIP transform into float32 [F, H, W, 3]; black frames pad a shorter
list. Captions as image2text_generation's.
"""

import numpy as np

from easynlp_tpu_torch.appzoo.image2text_generation.data import (
    ImageTextDataset,
)
from easynlp_tpu_torch.data.image_utils import (
    decode_frame_list,
    preprocess_image,
)


def frame_pixels(cell, frame_num, image_size):
    """float32 [frame_num, H, W, 3] of a frame-list cell."""
    frames, _ = decode_frame_list(str(cell), frame_num)
    return np.stack([preprocess_image(f, image_size)
                     for f in frames]).astype(np.float32)


class FrameTextDataset(ImageTextDataset):
    def __init__(self, *args, user_defined_parameters=None, **kwargs):
        udp = user_defined_parameters or {}
        self.frame_num = int(udp.get("frame_num", 3))
        super().__init__(*args, user_defined_parameters=udp, **kwargs)

    def decode_image(self, idx):
        return frame_pixels(self._image_b64(idx), self.frame_num,
                            self.image_size)
