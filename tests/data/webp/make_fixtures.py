"""Regenerate the WebP fixtures of this directory and digests.json.

The files are written by Pillow (12.1.0 with libwebp 1.6.0 when they were
made) from seeded smooth numpy images; digests.json holds, for each file,
the shape and the sha256 of Pillow's decode (Image.open(f).convert("RGBA")
as uint8 bytes). The port's WebP decoder (vk_gltf_renderer_tpu_torch/ops/
webp.py) is held to those digests where Pillow is absent (chip_smoke.py's
phase 21) and to Pillow itself in tests/test_torch_codecs.py.

Run from the repository root: python tests/data/webp/make_fixtures.py
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image, features

HERE = Path(__file__).resolve().parent


def smooth(w, h, seed, alpha=False):
    """A smooth seeded RGB(A) image: sums of low-frequency waves."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32) / max(w, h)
    chans = []
    for _ in range(4 if alpha else 3):
        fx, fy, ph = rng.uniform(1, 6), rng.uniform(1, 6), rng.uniform(0, 6.3)
        chans.append(127.5 + 120 * np.sin(2 * np.pi * (fx * x + fy * y * y) + ph))
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def palette(w, h, n, seed):
    """An n-colour image of diagonal bands, some colours translucent."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    pal[:, 3] = np.where(rng.random(n) < 0.25, rng.integers(0, 256, n), 255)
    idx = (np.add.outer(np.arange(h), np.arange(w)) // 7) % n
    return pal[idx]


def save(img, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "WEBP", **kw)
    return b.getvalue()


def fixtures() -> dict:
    frames = [Image.fromarray(smooth(256, 256, 40 + s, alpha=True)) for s in range(3)]
    return {
        "lossy_q80_512.webp": save(Image.fromarray(smooth(512, 512, 1)), quality=80),
        "lossy_q30_1024.webp": save(Image.fromarray(smooth(1024, 1024, 2)), quality=30),
        "lossy_alpha_256.webp": save(Image.fromarray(smooth(256, 256, 3, alpha=True)), quality=75),
        "lossless_512.webp": save(Image.fromarray(smooth(512, 512, 4)), lossless=True),
        "palette16_256.webp": save(Image.fromarray(palette(256, 256, 16, 5)), lossless=True),
        "animated_256.webp": save(frames[0], save_all=True, append_images=frames[1:], duration=40, quality=70),
    }


def main():
    digests = {"pillow": Image.__version__, "libwebp": features.version("webp"), "files": {}}
    for name, data in fixtures().items():
        (HERE / name).write_bytes(data)
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        digests["files"][name] = {"shape": list(rgba.shape), "sha256": hashlib.sha256(rgba.tobytes()).hexdigest()}
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
