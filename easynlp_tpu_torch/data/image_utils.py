"""Host-side image preprocessing for the CLIP-family apps of the PyTorch
port.

The port's own copy of easynlp_tpu/data/image_utils.py, through PIL as
there: base64 decode, a BICUBIC resize of the short side to image_size, a
centre crop, then (x / 255 - mean) / std with the CLIP constants in
float32, HWC. A string that fails to decode raises; it never becomes a
blank image. The diffusion apps' helpers scale pixels to [-1, 1]
(`preprocess_image_pm1`) and write [-1, 1] images as base64 PNG
(`encode_image_base64_png`), as the JAX package's do.
"""

import base64
import io as _io
import json
import os

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def decode_image_bytes(data):
    """Encoded image bytes (PNG, JPEG, ...) -> an RGB PIL image."""
    from PIL import Image
    return Image.open(_io.BytesIO(data)).convert("RGB")


def decode_base64_image(b64):
    """Standard base64 (url-safe where that fails) -> an RGB PIL image."""
    try:
        data = base64.b64decode(b64, validate=True)
    except ValueError:
        data = base64.urlsafe_b64decode(b64)
    return decode_image_bytes(data)


def decode_base64_image_urlsafe(b64):
    """Url-safe base64 (standard where that fails) -> an RGB PIL image,
    as the vision-generation apps read their rows."""
    try:
        data = base64.urlsafe_b64decode(b64)
    except ValueError:
        data = base64.b64decode(b64)
    return decode_image_bytes(data)


def resize_center_crop(img, image_size=224):
    """PIL image -> uint8 HWC [image_size, image_size, 3]: the short side
    resized to image_size (BICUBIC), then the centre crop. Datasets cache
    this uint8 and normalise per read."""
    from PIL import Image
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                     Image.BICUBIC)
    w, h = img.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    return np.asarray(img, np.uint8)


def normalize_clip_u8(u8, mean=CLIP_MEAN, std=CLIP_STD):
    """uint8 HWC -> CLIP-normalised float32 HWC."""
    return (u8.astype(np.float32) / 255.0 - mean) / std


def preprocess_image(img, image_size=224, mean=CLIP_MEAN, std=CLIP_STD):
    """PIL image -> normalised float32 HWC [image_size, image_size, 3]."""
    return normalize_clip_u8(resize_center_crop(img, image_size), mean, std)


def preprocess_base64_batch(b64_list, image_size=224, mean=None, std=None):
    """base64 images -> [N, image_size, image_size, 3] float32, with the
    given mean/std (a checkpoint's overrides) or the CLIP constants."""
    mean = CLIP_MEAN if mean is None else np.asarray(mean, np.float32)
    std = CLIP_STD if std is None else np.asarray(std, np.float32)
    return np.stack([preprocess_image(decode_base64_image(b), image_size,
                                      mean, std)
                     for b in b64_list])


def preprocess_image_pm1(img, image_size=256, random_crop=False, rng=None):
    """PIL image -> HWC float32 in [-1, 1]: the short side resized to
    image_size (BICUBIC), a centre crop (or, with random_crop, a crop at a
    position drawn from `rng`, a numpy RandomState), then / 127.5 - 1."""
    from PIL import Image
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                     Image.BICUBIC)
    w, h = img.size
    if random_crop and (w > image_size or h > image_size):
        rng = rng or np.random
        left = rng.randint(0, w - image_size + 1)
        top = rng.randint(0, h - image_size + 1)
    else:
        left = (w - image_size) // 2
        top = (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    return np.asarray(img, np.float32) / 127.5 - 1.0


def encode_image_base64_png(pixels_pm1):
    """HWC float array in [-1, 1] -> a base64 PNG string (uint8 after
    (x + 1) * 127.5, clipped)."""
    from PIL import Image
    arr = (np.asarray(pixels_pm1, np.float32) + 1.0) * 127.5
    arr = arr.clip(0, 255).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def decode_frame_list(value, max_frames, decode_fn=None):
    """A video cell: a JSON list of base64 frames (comma-separated where
    it is not JSON), or a directory of frame images. Returns (frames,
    n_real): the first max_frames frames as RGB PIL images, padded to
    max_frames with black frames of the first frame's size (8 x 8 where
    there is none), and the count of real frames."""
    from PIL import Image
    decode_fn = decode_fn or decode_base64_image_urlsafe
    value = str(value)
    frames = []
    if os.path.isdir(value):
        for name in sorted(os.listdir(value)):
            frames.append(Image.open(os.path.join(value, name))
                          .convert("RGB"))
    else:
        try:
            items = json.loads(value)
        except ValueError:
            items = value.split(",")
        for item in items:
            frames.append(decode_fn(item))
    frames = frames[:max_frames]
    n_real = len(frames)
    while len(frames) < max_frames:
        frames.append(Image.new("RGB", frames[0].size if frames else (8, 8),
                                (0, 0, 0)))
    return frames, n_real
