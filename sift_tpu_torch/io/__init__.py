"""Host-side IO of the PyTorch port: image decode/encode, match and
trajectory plots (`io/viz.py`), dataset loaders (`io/datasets.py`),
trajectory export (`io/trajectory.py`), checkpoints (`io/checkpoint.py`)
and the native decoder binding (`io/native.py`)."""

from sift_tpu_torch.io.image import load_image_gray, save_image_gray, save_image_rgb

__all__ = ["load_image_gray", "save_image_gray", "save_image_rgb"]
