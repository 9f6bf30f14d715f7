"""Image-to-text (captioning) dataset for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/image2text_generation/data.py: rows
`urlsafe-base64 image<TAB>caption` (first_sequence the image column);
each image goes through the CLIP transform into float32 [H, W, 3]
(udp img_size, default 224) when its row is read; captions are tokenised
once to udp text_len (default --sequence_length) tokens, [CLS] and [SEP]
serving as BOS and EOS.
"""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset
from easynlp_tpu_torch.data.image_utils import (
    decode_base64_image_urlsafe,
    preprocess_image,
)


class ImageTextDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=32,
                 input_schema=None, first_sequence="imgbase64",
                 second_sequence="text", user_defined_parameters=None,
                 image_size=224, **kwargs):
        for k in ("label_name", "label_enumerate_values", "multi_label",
                  "is_training"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer
        self.image_col = first_sequence or "imgbase64"
        self.text_col = second_sequence or "text"
        self.image_size = int(udp.get("img_size", image_size))
        self.text_len = int(udp.get("text_len", max_seq_length or 32))
        texts = [str(self.parse_row(row).get(self.text_col, ""))
                 for row in self.rows]
        enc = self.tokenizer(texts, max_length=self.text_len)
        self.input_ids = np.asarray(enc["input_ids"], np.int32)
        self.attention_mask = np.asarray(enc["attention_mask"], np.int32)

    def _image_b64(self, idx):
        return str(self.parse_row(self.rows[idx]).get(self.image_col, ""))

    def decode_image(self, idx):
        return preprocess_image(
            decode_base64_image_urlsafe(self._image_b64(idx)),
            self.image_size).astype(np.float32)

    def __getitem__(self, idx):
        return {"input_ids": self.input_ids[idx],
                "attention_mask": self.attention_mask[idx],
                "pixel_values": self.decode_image(idx)}

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
