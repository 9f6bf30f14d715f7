"""CLIP dataset for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/clip/data.py: TSV rows
`text<TAB>base64image`, or webdataset `.tar` shards (members grouped by
stem; a `.jpg`/`.jpeg`/`.png` image and a `.txt` caption or `.json`
{"caption": ...}; several comma-separated shards are split across ranks,
the samples of a single shard likewise). Captions are tokenised once;
each image is decoded, resized (short side, bicubic) and centre-cropped
when its row is read, and ships as raw uint8 [H, W, 3]: the ViT
normalises it on the device. `image_cache="ram"` keeps the resized uint8
of each row (at most `image_cache_items` of them) so later epochs skip
the decode (the api passes user_defined_parameters image_size,
image_cache and image_cache_items, as the JAX api does).
"""

import json
import os
import tarfile

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset
from easynlp_tpu_torch.data.image_utils import (
    decode_base64_image,
    decode_image_bytes,
    resize_center_crop,
)


def _load_tar_samples(data_file, process_index=0, num_processes=1):
    """(captions, image bytes) of the shards' samples, this rank's share."""
    shards = sorted(data_file.split(",")) if "," in data_file \
        else [data_file]
    if len(shards) > 1:  # whole shards across ranks, as the reference
        shards = shards[process_index::num_processes]
    texts, images = [], []
    for shard in shards:
        by_stem = {}
        with tarfile.open(shard) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                stem, ext = os.path.splitext(member.name)
                by_stem.setdefault(stem, {})[ext.lower()] = \
                    tf.extractfile(member).read()
        for stem in sorted(by_stem):
            entry = by_stem[stem]
            img = entry.get(".jpg") or entry.get(".jpeg") or \
                entry.get(".png")
            if img is None:
                continue
            if ".json" in entry:
                text = json.loads(entry[".json"]).get("caption", "")
            else:
                text = entry.get(".txt", b"").decode("utf-8",
                                                     errors="replace")
            texts.append(str(text).strip())
            images.append(img)
    if len(shards) <= 1 and num_processes > 1:
        texts = texts[process_index::num_processes]
        images = images[process_index::num_processes]
    return texts, images


class CLIPDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=32,
                 input_schema=None, first_sequence="text",
                 second_sequence="image", image_size=224,
                 image_cache=None, image_cache_items=None, **kwargs):
        for k in ("label_name", "label_enumerate_values", "multi_label"):
            kwargs.pop(k, None)
        self._img_cache = {} if image_cache in ("ram", True, "true") \
            else None
        self._img_cache_max = (int(image_cache_items)
                               if image_cache_items else None)
        self._image_bytes = None
        if str(data_file).endswith(".tar"):
            texts, self._image_bytes = _load_tar_samples(
                str(data_file), kwargs.get("process_index", 0) or 0,
                kwargs.get("num_processes", 1) or 1)
            self.rows = list(range(len(texts)))
            self.schema = None
            self.kwargs = kwargs
        else:
            super().__init__(data_file, input_schema=input_schema, **kwargs)
            texts = [str(self.parse_row(row).get(first_sequence or "text",
                                                 ""))
                     for row in self.rows]
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.text_col = first_sequence or "text"
        self.image_col = second_sequence or "image"
        self.image_size = image_size
        self.texts = texts
        enc = self.tokenizer(texts, max_length=max_seq_length)
        self.text_features = {k: np.asarray(v, np.int32)
                              for k, v in enc.items()}

    def _decode(self, idx):
        if self._image_bytes is not None:
            return decode_image_bytes(self._image_bytes[idx])
        return decode_base64_image(
            str(self.parse_row(self.rows[idx]).get(self.image_col, "")))

    def _decoded_u8(self, idx):
        if self._img_cache is not None:
            hit = self._img_cache.get(idx)
            if hit is not None:
                return hit
        u8 = resize_center_crop(self._decode(idx), self.image_size)
        if self._img_cache is not None and (
                self._img_cache_max is None
                or len(self._img_cache) < self._img_cache_max):
            self._img_cache[idx] = u8
        return u8

    def __getitem__(self, idx):
        out = {k: v[idx] for k, v in self.text_features.items()}
        out["pixel_values"] = self._decoded_u8(idx)
        return out

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
