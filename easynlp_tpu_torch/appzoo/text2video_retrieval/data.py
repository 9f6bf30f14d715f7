"""Text-video retrieval dataset (CLIP4Clip) for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text2video_retrieval/data.py: rows
`text<TAB>video`, the video cell a JSON list of base64 frames or a
directory of frame images; the first max_frames frames (udp max_frames,
else frame_num, default 12) go through the CLIP transform into float32
[F, H, W, 3], black frames pad the rest, and `video_masks` marks the real
ones. Captions are tokenised once.
"""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset
from easynlp_tpu_torch.data.image_utils import (
    decode_frame_list,
    preprocess_image,
)


def max_frames_of(udp):
    return int(udp.get("max_frames", udp.get("frame_num", 12)))


def video_pixels(cell, max_frames, image_size):
    """(float32 [F, H, W, 3] CLIP-normalised frames, int32 [F] mask)."""
    frames, n_real = decode_frame_list(str(cell), max_frames)
    pixels = np.stack([preprocess_image(f, image_size)
                       for f in frames]).astype(np.float32)
    mask = np.zeros((max_frames,), np.int32)
    mask[:n_real] = 1
    return pixels, mask


class Text2VideoRetrievalDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=32,
                 input_schema=None, first_sequence="text",
                 second_sequence="video", image_size=224,
                 user_defined_parameters=None, **kwargs):
        for k in ("label_name", "label_enumerate_values", "multi_label",
                  "is_training"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.text_col = first_sequence or "text"
        self.video_col = second_sequence or "video"
        self.image_size = int(udp.get("img_size", image_size))
        self.max_frames = max_frames_of(udp)
        texts = [str(self.parse_row(row).get(self.text_col, ""))
                 for row in self.rows]
        enc = self.tokenizer(texts, max_length=max_seq_length)
        self.text_features = {k: np.asarray(v, np.int32)
                              for k, v in enc.items()}

    def __getitem__(self, idx):
        pixels, mask = video_pixels(
            self.parse_row(self.rows[idx]).get(self.video_col, ""),
            self.max_frames, self.image_size)
        out = {k: v[idx] for k, v in self.text_features.items()}
        out["pixel_values"] = pixels
        out["video_masks"] = mask
        return out

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
