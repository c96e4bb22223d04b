"""Match visualization, host side (counterpart of
`sift_tpu/io/viz.py::side_by_side_matches`). PIL is imported inside."""

from __future__ import annotations

from typing import Optional

import numpy as np


def side_by_side_matches(gray_a: np.ndarray, gray_b: np.ndarray,
                         pa: np.ndarray, pb: np.ndarray,
                         valid: Optional[np.ndarray] = None,
                         inliers: Optional[np.ndarray] = None,
                         max_lines: int = 200) -> np.ndarray:
    """The two frames side by side with lines between corresponding points
    (green = inlier, red = outlier/unknown).

    pa/pb: (N, 2) pixel coordinates in their respective frames.
    Returns an (H, Wa+Wb, 3) uint8 image.
    """
    from PIL import Image, ImageDraw

    ha, wa = gray_a.shape
    hb, wb = gray_b.shape
    h = max(ha, hb)
    canvas = np.zeros((h, wa + wb, 3), np.uint8)
    canvas[:ha, :wa] = np.clip(gray_a, 0, 255).astype(np.uint8)[..., None]
    canvas[:hb, wa:] = np.clip(gray_b, 0, 255).astype(np.uint8)[..., None]
    im = Image.fromarray(canvas)
    drw = ImageDraw.Draw(im)

    n = pa.shape[0]
    mask = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    for i in np.nonzero(mask)[0][:max_lines]:
        good = inliers is not None and bool(np.asarray(inliers)[i])
        color = (0, 220, 0) if good else (220, 40, 40)
        x1, y1 = float(pa[i, 0]), float(pa[i, 1])
        x2, y2 = float(pb[i, 0]) + wa, float(pb[i, 1])
        drw.line([(x1, y1), (x2, y2)], fill=color, width=1)
        drw.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=color)
        drw.ellipse([x2 - 2, y2 - 2, x2 + 2, y2 + 2], outline=color)
    return np.asarray(im)
