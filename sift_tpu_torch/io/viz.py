"""Host-side plots (counterpart of `sift_tpu/io/viz.py`): matches side by
side and a top-down trajectory. PIL and matplotlib are imported inside."""

from __future__ import annotations

from typing import Optional, Sequence

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


def plot_trajectory(est_xyz: np.ndarray,
                    gt_xyz: Optional[np.ndarray] = None,
                    path: Optional[str] = None,
                    title: str = "trajectory",
                    axes: Sequence[int] = (0, 2)):
    """Top-down (x-z by default) trajectory plot; returns the figure, or
    writes `path` and returns None (Agg backend, safe headless)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a0, a1 = axes
    fig, ax = plt.subplots(figsize=(6, 6))
    est = np.asarray(est_xyz)
    ax.plot(est[:, a0], est[:, a1], "-", color="#2060d0", lw=1.5,
            label="estimate")
    ax.plot(est[0, a0], est[0, a1], "o", color="#2060d0", ms=6)
    if gt_xyz is not None:
        gt = np.asarray(gt_xyz)
        ax.plot(gt[:, a0], gt[:, a1], "--", color="#777777", lw=1.2,
                label="ground truth")
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_xlabel("xyz"[a0])
    ax.set_ylabel("xyz"[a1])
    ax.set_title(title)
    ax.legend(loc="best", fontsize=9)
    ax.grid(alpha=0.3)
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
