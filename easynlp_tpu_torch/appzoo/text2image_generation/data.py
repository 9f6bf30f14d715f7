"""Text-to-image (ARTIST) dataset for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text2image_generation/data.py: rows
`text<TAB>urlsafe-base64 image`; captions tokenised once to udp text_len
(default --sequence_length) tokens; each image, when its row is read,
resized (short side, bicubic) and centre-cropped (random-cropped in
training with udp random_crop) to udp size (default 256) and scaled to
[-1, 1] as `pixel_values` [H, W, 3] f32. Text ids feed the GPT unshifted:
ARTIST places the image codes after the text vocabulary.

`random_crop` is read as a flag ("true"/"1"/"yes"); the JAX dataset takes
bool() of the raw string, since its typed parameter registry lacks the
key, so `random_crop=false` on its command line turns random crops on
(ROADMAP reference fault 36).
"""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset
from easynlp_tpu_torch.data.image_utils import (
    decode_base64_image_urlsafe,
    preprocess_image_pm1,
)


def flag(value):
    """A udp switch as a bool: True, or a string "true"/"1"/"yes"."""
    return str(value).lower() in ("true", "1", "yes")


class TextImageDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=32,
                 input_schema=None, first_sequence="text",
                 second_sequence="imgbase64", user_defined_parameters=None,
                 is_training=False, **kwargs):
        for k in ("label_name", "label_enumerate_values", "multi_label",
                  "image_size", "image_cache", "image_cache_items"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer
        self.size = int(udp.get("size", 256))
        self.random_crop = flag(udp.get("random_crop", False)) and is_training
        self.text_len = int(udp.get("text_len", max_seq_length or 32))
        self.text_col = first_sequence or "text"
        self.image_col = second_sequence or "imgbase64"
        texts = [str(self.parse_row(row).get(self.text_col, ""))
                 for row in self.rows]
        enc = self.tokenizer(texts, max_length=self.text_len)
        self.input_ids = np.asarray(enc["input_ids"], np.int32)
        self.attention_mask = np.asarray(enc["attention_mask"], np.int32)
        self._rng = np.random.RandomState(0)

    def _image_b64(self, idx):
        return str(self.parse_row(self.rows[idx]).get(self.image_col, ""))

    def __getitem__(self, idx):
        img = preprocess_image_pm1(
            decode_base64_image_urlsafe(self._image_b64(idx)), self.size,
            random_crop=self.random_crop, rng=self._rng)
        return {"input_ids": self.input_ids[idx],
                "attention_mask": self.attention_mask[idx],
                "pixel_values": img.astype(np.float32)}

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
