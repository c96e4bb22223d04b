"""Host-side IO of the PyTorch port: image decode/encode, match plots,
dataset loaders (`io/datasets.py`), trajectory export
(`io/trajectory.py`)."""

from sift_tpu_torch.io.image import load_image_gray, save_image_gray, save_image_rgb

__all__ = ["load_image_gray", "save_image_gray", "save_image_rgb"]
