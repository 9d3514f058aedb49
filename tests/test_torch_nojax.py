"""The port runs where there is no JAX: a subprocess blocks `import jax`,
imports every module of the port, builds the helmet stand-in with the
port's own writer and renders a frame on the CPU, then renders the terrain
grid under every traversal-kernel selection; and no source file of the
port imports jax."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import vk_gltf_renderer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin, write_large_glb, write_synthetic_hdr
with tempfile.TemporaryDirectory() as d:
    r = GltfRenderer(32, 24, spp=1, max_depth=3, device="cpu")
    r.create_scene(make_helmet_standin(d))
    r.create_hdr(write_synthetic_hdr(d + "/env.hdr", 32, 64))
    aux = r.on_render()
    img = r.image_linear()
    assert img.shape == (24, 32, 3) and np.isfinite(img).all() and img.mean() > 0.01
    assert float(aux["rays"]) > 0
    r.save_image(d + "/out.png")
    write_large_glb(d + "/terrain.glb", target_tris=8000, grid=2)
    images = []
    for primary, packet in (("v3", "v9"), ("v2", "v2"), ("v6", "v6"), ("lane", "lane_stream")):
        os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = primary, packet
        r = GltfRenderer(24, 16, spp=1, max_depth=2, device="cpu")
        r.create_scene(d + "/terrain.glb")
        r.on_render()
        images.append(r.image_linear())
    assert all(np.isfinite(i).all() and i.mean() > 0.01 for i in images)
    assert all(np.allclose(i, images[0], rtol=1e-3, atol=1e-3) for i in images)
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("NOJAX_OK")
"""


def test_port_renders_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = list((ROOT / "vk_gltf_renderer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
