"""VisualValidator: image comparison for golden-image testing.

The reference stubs this ("(future)", tests/common/test_utils.hpp:34-39);
here it is real — BASELINE.json's acceptance metric is per-spp RMSE vs
reference renders, and this is the tool that computes it.

The port's copy of vk_gltf_renderer_tpu/utils/visual_validator.py, with
images read by utils/image_io.py (every format it reads: PNG, JPEG, WebP,
BMP, GIF, TIFF, TGA, Netpbm) and goldens written by utils/png.py instead
of Pillow: data that no reader claims raises ValueError.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .image_io import read_image
from .png import write_png


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def load_image(path) -> np.ndarray:
    """An image file as RGB float32 in [0, 1]: gray repeated over three
    channels, alpha dropped (Pillow's convert("RGB"))."""
    img = read_image(Path(path).read_bytes())
    rgb = img[..., :3] if img.shape[-1] >= 3 else np.repeat(img[..., :1], 3, axis=-1)
    return rgb.astype(np.float32) / 255.0


def compare_screenshots(img_or_path_a, img_or_path_b, *, threshold: float = 1e-2) -> dict:
    """Compare two images (arrays in [0,1] or file paths). Returns
    {rmse, max_err, passed} with the BASELINE.json default threshold."""
    a = load_image(img_or_path_a) if isinstance(img_or_path_a, (str, Path)) else np.asarray(img_or_path_a)
    b = load_image(img_or_path_b) if isinstance(img_or_path_b, (str, Path)) else np.asarray(img_or_path_b)
    e = rmse(a, b)
    return {"rmse": e, "max_err": float(np.abs(a - b).max()), "passed": e <= threshold}


def check_or_create_golden(img: np.ndarray, golden_path, *, threshold: float = 1e-2, update: bool = False) -> dict:
    """Golden-image workflow: first run (or update=True) writes the golden;
    later runs compare against it."""
    golden_path = Path(golden_path)
    if update or not golden_path.exists():
        golden_path.parent.mkdir(parents=True, exist_ok=True)
        write_png(golden_path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        return {"rmse": 0.0, "max_err": 0.0, "passed": True, "created": True}
    res = compare_screenshots(img, golden_path, threshold=threshold)
    res["created"] = False
    return res
