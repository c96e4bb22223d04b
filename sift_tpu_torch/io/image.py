"""Image decode/encode, host side (counterpart of `sift_tpu/io/image.py`).

Grayscale in [0, 255] as the reference reads it: RGB sources go to
luminance with the ITU-R BT.601 weights (0.299, 0.587, 0.114) on float64
(PIL's own `convert("L")` rounds to uint8), then cast. Arrays are (H, W)
row-major; `x` indexes width (axis 1), `y` height (axis 0). PIL is
imported inside the functions.
"""

from __future__ import annotations

import numpy as np

# BT.601 luminance weights.
_LUMA = np.array([0.299, 0.587, 0.114], np.float64)


def load_image_gray(path: str, dtype=np.float32,
                    allow_uint8: bool = False) -> np.ndarray:
    """Decode an image file to a grayscale (H, W) float array in [0, 255].

    `allow_uint8`: return 8-bit grayscale sources (PIL mode "L") as uint8
    instead of float; RGB sources still return float (the luma projection
    is fractional). 16-bit sources keep their native range.
    """
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I;16", "I"):
            return np.asarray(im, np.float64).astype(dtype)
        if im.mode == "L" and allow_uint8:
            return np.asarray(im)                   # (H, W) uint8
        if im.mode not in ("RGB", "L", "F"):
            im = im.convert("RGB")
        arr = np.asarray(im, np.float64)
    if arr.ndim == 3:
        arr = arr[..., :3] @ _LUMA
    return arr.astype(dtype)


def save_image_gray(path: str, img: np.ndarray) -> None:
    """Write a (H, W) float array in [0, 255] as an 8-bit grayscale file."""
    from PIL import Image

    arr = np.clip(np.asarray(img), 0.0, 255.0).astype(np.uint8)
    Image.fromarray(arr, mode="L").save(path)


def save_image_rgb(path: str, img: np.ndarray) -> None:
    """Write a (H, W, 3) uint8/float array as an RGB file."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0.0, 255.0).astype(np.uint8)
    Image.fromarray(arr, mode="RGB").save(path)
