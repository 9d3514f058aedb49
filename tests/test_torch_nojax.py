"""The port runs where there is neither JAX nor the JAX package: a
subprocess blocks `import jax` and `import vk_gltf_renderer_tpu`, imports
every module of the port, builds the helmet stand-in with the port's own
writer and renders a frame on the CPU, renders the terrain grid under
every traversal-kernel selection and under VKGR_TRAVERSAL=packet4 and
wavefront, runs a small megakernel render, and runs the headless CLI and
`benchmark run` on the CPU, each printing one BENCHMARK_JSON line; and no
source file of the port, chip_smoke.py or bvh4_tuning.py imports either,
or the reference's tools/."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["vk_gltf_renderer_tpu"] = None  # and so does the JAX package
import numpy as np
import torch
torch.set_num_threads(1)  # tiny tensors: a thread pool only adds contention beside other workers
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
    for primary, packet in (("v3", "v9"), ("v2", "v2"), ("v6", "v6"), ("lane", "lane_stream"),
                            ("v5", "v8"), ("v7", "v7")):
        os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = primary, packet
        r = GltfRenderer(24, 16, spp=1, max_depth=2, device="cpu")
        r.create_scene(d + "/terrain.glb")
        r.on_render()
        images.append(r.image_linear())
    os.environ.pop("VKGR_PRIMARY_KERNEL")
    os.environ.pop("VKGR_PACKET_KERNEL")
    for traversal in ("packet4", "wavefront"):
        os.environ["VKGR_TRAVERSAL"] = traversal
        r = GltfRenderer(24, 16, spp=1, max_depth=2, device="cpu")
        r.create_scene(d + "/terrain.glb")
        r.on_render()
        images.append(r.image_linear())
    os.environ.pop("VKGR_TRAVERSAL")
    assert all(np.isfinite(i).all() and i.mean() > 0.01 for i in images)
    assert all(np.allclose(i, images[0], rtol=1e-3, atol=1e-3) for i in images)
    from vk_gltf_renderer_tpu_torch.ops.megakernel import pack_rays, render_mega
    rng = np.random.default_rng(0)
    lo, hi = r.bvh.nodes_self[0, 0:3], r.bvh.nodes_self[0, 3:6]
    ro = lo + rng.random((300, 3)) * (hi - lo)
    rd = rng.normal(size=(300, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro_p, rd_p, seeds, n = pack_rays(ro, rd, rng.integers(0, 2**32, 300, dtype=np.uint64),
                                     device="cpu")
    out = render_mega(r.dev_bvh.nodes4_fi, r.dev_bvh.tris128, ro_p, rd_p, seeds, 3,
                      r.dev_bvh.root4_code)
    assert out.shape == (1, 2, 8, 128) and bool(torch.isfinite(out).all())
    assert bool((out[:, 0].reshape(-1)[:n] > 0).any())
    # the front ends: headless and `benchmark run` on the CPU
    import contextlib, io
    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch.benchmark.__main__ import main as benchmark_main
    os.environ["VKGR_SETTINGS"] = d + "/settings.json"
    scene, cfg = d + "/helmet.gltf", d + "/one.cfg"
    with open(cfg, "w") as f:
        f.write(f"--scenefile {scene} --size 24 16 --frames 2 --ptDepth 2\n")
    for main, argv in ((headless.main, ["--scenefile", scene, "--size", "32", "24", "--frames", "2",
                                        "--device", "cpu"]),
                       (benchmark_main, ["run", cfg, "--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        assert sum(ln.startswith("BENCHMARK_JSON {") for ln in buf.getvalue().splitlines()) == 1
blocked = ("jax", "vk_gltf_renderer_tpu")
assert not any(m.split(".")[0] in blocked for m, v in sys.modules.items() if v is not None)
print("NOJAX_OK")
"""


def test_port_renders_with_jax_blocked():
    # JAX_PLATFORMS stays set: it made the JAX package import jax, which the
    # port no longer reaches
    env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|vk_gltf_renderer_tpu|tools)\b(?!_torch)", re.M)
    files = list((ROOT / "vk_gltf_renderer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                         ROOT / "bvh4_tuning.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
    # the scan itself sees both kinds of import
    assert pattern.search("import jax.numpy as jnp") and pattern.search(
        "    from vk_gltf_renderer_tpu.models import Scene")
    assert not pattern.search("from vk_gltf_renderer_tpu_torch.models import Scene")
