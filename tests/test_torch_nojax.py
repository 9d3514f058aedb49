"""The port runs where there is neither JAX nor the JAX package: a
subprocess blocks `import jax`, `import vk_gltf_renderer_tpu` and `import
PIL`, imports
every module of the port, builds the helmet stand-in with the port's own
writer and renders a frame on the CPU, renders the terrain grid under
every traversal-kernel selection and under VKGR_TRAVERSAL=packet4 and
wavefront, runs a small megakernel render, renders
scenes.make_materials_standin (every material family, three punctual
lights), animates scenes.make_brainstem through the device refit, renders
scenes.make_foliage_standin (alpha) over the shadow-catcher plane, renders
guided frames upscaled 2x and denoises them, renders preview frames with the
wireframe and picks, runs the headless CLI and `benchmark run` on the
CPU, each printing one BENCHMARK_JSON line, edits and renders through
edit_cli and a scripted viewer (grid, gizmo, an edit verb), renders the
helmet with a JPEG, a KTX2 BasisLZ and a lossless and a lossy WebP base
colour (the port's own decoders), writes a JPEG and a WebP, renders the
helmet with BMP, TGA, TIFF, GIF, PPM, arithmetic-coded JPEG, PSD, SGI, PCX,
DCX, ICO, CUR, QOI, Sun raster, CCITT, LZMA and ThunderScan TIFF,
subsampled lossless JPEG, palette/Adam7 and 16-bit PNG, ZSTD, old-style
JPEG and CIELab TIFF, Lab PSD, BLP, FTEX, XBM, XPM, MSP, IM and lossless AVIF (the port's AV1 decoder)
base colours and writes a frame in every suffix
image_io writes, renders
seeded and batched frames on the SBVH, and renders a frame split over two shards
(parallel.render_mesh); and no
source file of the port, chip_smoke.py, bvh4_tuning.py or frame_ab.py imports any
of them (zstandard included), or the reference's tools/."""

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
sys.modules["PIL"] = None  # and Pillow, which the card's machine lacks
sys.modules["zstandard"] = None  # and zstandard (the port has its own Zstandard decoder)
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
    # textures without Pillow: JPEG and KTX2 BasisLZ base colours, a JPEG written, rows over two shards
    from vk_gltf_renderer_tpu_torch.ops.jpeg import decode_jpeg, encode_jpeg
    from vk_gltf_renderer_tpu_torch.parallel import render_mesh
    from vk_gltf_renderer_tpu_torch.scenes import helmet_with_texture, ktx2_etc1s, texture_image
    tex = texture_image(32, seed=1)
    from vk_gltf_renderer_tpu_torch.ops.webp import decode_webp, encode_webp
    for data, name in ((encode_jpeg(tex), "base.jpg"), (ktx2_etc1s(tex), "base.ktx2"),
                       (encode_webp(tex), "base.webp"),
                       (open(os.path.join("tests", "data", "webp", "lossy_alpha_256.webp"), "rb").read(),
                        "lossy.webp")):
        r = GltfRenderer(24, 16, spp=1, max_depth=2, device="cpu")
        r.create_scene(helmet_with_texture(d, data, name))
        assert r.dev_scene.tex_desc[0, 1:3].tolist() == ([256, 256] if name == "lossy.webp" else [32, 32])
        r.on_render()
        assert np.isfinite(r.image_linear()).all() and r.image_linear().mean() > 0.01
    r.save_image(d + "/out.jpg")
    with open(d + "/out.jpg", "rb") as f:
        assert decode_jpeg(f.read()).shape == (16, 24, 3)
    r.save_image(d + "/out.webp")
    with open(d + "/out.webp", "rb") as f:
        assert decode_webp(f.read()).shape == (16, 24, 4)
    # Pillow's other formats without Pillow: BMP, TGA, TIFF (LZW), GIF and PPM base colours from the
    # committed fixtures, and a frame written in each suffix and read back
    from vk_gltf_renderer_tpu_torch.utils.image_io import WRITABLE, read_image
    for name in ("bmp_rle8.bmp", "tga_rgb24_rle.tga", "tiff_tiles_lzw.tif", "gif_interlaced.gif",
                 "ppm_p6_maxval_1023.ppm", "jpeg_arith_progressive.jpg", "psd_cmyk_packbits.psd",
                 "sgi_rgba16_rle.sgi", "pcx_palette.pcx", "dcx_two_pages.dcx", "ico_bmp32_alpha.ico",
                 "cur_bmp24.cur", "qoi_hand_ops.qoi", "sun_rle_palette8_0x80.ras", "tiff_group3_2d.tif",
                 "tiff_libtiff_lzma.tif", "tiff_thunderscan.tif", "jpeg_lossless_1x2_scans.jpg",
                 "png_palette8_adam7.png", "png_rgb16.png", "tiff_zstd_rgba_level19.tif", "tiff_libtiff_old_jpeg.tif",
                 "tiff_libtiff_cielab.tif", "psd_lab_raw.psd", "blp2_dxt5.blp", "blp1_jpeg_alpha0.blp",
                 "ftex_dxt1.ftc", "xbm_pillow.xbm", "xpm_one_char.xpm", "msp_v2_rle.msp", "im_pillow_p.im",
                 "im_ycc.im", "im_bits12.im", "blp1_jpeg_ycck.blp", "iptc_raw_rgb_band2.iim", "pixar_rgb.pxr",
                 "spider_little_endian.spi", "fits_gzip_16.fits", "mcidas_i16_prefix.area", "gbr_v2_rgba.gbr",
                 "pcd_270.pcd", "flc_brun_ss2.flc", "xvthumb_332.xv", "imt_gray.imt", "icns_ic07_png.icns",
                 "avif_q100_rgba_420.avif"):
        with open(os.path.join("tests", "data", "images", name), "rb") as f:
            data = f.read()
        r = GltfRenderer(24, 16, spp=1, max_depth=2, device="cpu")
        r.create_scene(helmet_with_texture(d, data, name))
        assert r.dev_scene.tex_desc[0, 1:3].tolist() == list(read_image(data).shape[1::-1]), name
        r.on_render()
        assert np.isfinite(r.image_linear()).all() and r.image_linear().mean() > 0.01
    for suffix in WRITABLE:
        r.save_image(d + "/out" + suffix)
        with open(d + "/out" + suffix, "rb") as f:
            assert read_image(f.read()).shape[:2] == (16, 24), suffix
    accum = r.accum.clone()
    r.reset_frame()
    r.frame_idx -= 1
    render_mesh(r, ["cpu", "cpu"])
    assert torch.equal(r.accum, accum)
    # the spatial-split BVH, a seeded frame and a batched one
    os.environ.update(VKGR_BVH="sbvh", VKGR_PRIMARY_SEED="1", VKGR_SPP_BATCH="1")
    r = GltfRenderer(24, 16, spp=2, max_depth=2, device="cpu")
    r.create_scene(make_helmet_standin(d))
    r.on_render()
    r.on_render()
    assert r.bvh.builder == "sbvh" and r._config().primary_seed and np.isfinite(r.image_linear()).all()
    for k in ("VKGR_BVH", "VKGR_PRIMARY_SEED", "VKGR_SPP_BATCH"):
        del os.environ[k]
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
    # the material model and punctual lights: every material family under three lights
    from vk_gltf_renderer_tpu_torch.scenes import make_materials_standin
    r = GltfRenderer(24, 16, spp=1, max_depth=3, device="cpu")
    r.create_scene(make_materials_standin(d))
    assert r._config().has_lights and "volume_scatter" in r._config().features
    r.on_render()
    assert np.isfinite(r.image_linear()).all() and r.image_linear().mean() > 0.01
    # animation: skinning and the device refit, frame to frame
    from vk_gltf_renderer_tpu_torch.scenes import make_brainstem
    r = GltfRenderer(24, 16, spp=1, max_depth=2, device="cpu")
    r.create_scene(make_brainstem(d))
    r.animate = True
    boxes = []
    for _ in range(2):
        r.on_render()
        boxes.append(r.dev_bvh.nodes4_fi.clone())
    assert not torch.equal(boxes[0], boxes[1]) and np.isfinite(r.image_linear()).all()
    # alpha: the foliage stand-in, classified, culled and split, re-traced past rejected hits,
    # over the shadow-catcher plane
    from vk_gltf_renderer_tpu_torch.scenes import make_foliage_standin
    r = GltfRenderer(24, 16, spp=1, max_depth=3, device="cpu")
    r.use_infinite_plane, r.plane_height, r.plane_shadow_catcher = True, 0.5, True
    r.create_scene(make_foliage_standin(d, cards=32))
    assert r._config().alpha_any and r.bvh.attr_rnode.shape[0] > r.flat.tri_idx.shape[0]
    r.on_render()
    assert np.isfinite(r.image_linear()).all() and r.image_linear().mean() > 0.01
    # what a viewer shows: guided frames upscaled 2x, denoised, then preview frames of the helmet
    # under the HDR with the wireframe, and a pick
    r = GltfRenderer(16, 12, spp=1, max_depth=2, device="cpu")
    r.denoise_guides, r.upscale, r.selection = True, 2, {0}
    r.create_scene(d + "/helmet.gltf")
    for _ in range(2):
        aux = r.on_render()
    assert {"spec_albedo", "spec_hitdist", "first_pos_prev", "lum_moments"} <= set(aux)
    assert r.image_upscaled().shape == (24, 32, 3) and np.isfinite(r.image_upscaled()).all()
    den = r.image_denoised()
    assert den.shape == (12, 16, 3) and np.isfinite(den).all() and r.image_with_silhouette().shape == (12, 16, 3)
    r = GltfRenderer(24, 16, spp=1, max_depth=2, device="cpu", render_system=1)
    r.wireframe = True
    r.create_scene(d + "/helmet.gltf")
    r.create_hdr(d + "/env.hdr")
    for _ in range(2):
        r.on_render()
    assert np.isfinite(r.image_linear()).all() and r.image_linear().mean() > 0.01
    assert r.pick(12, 8) in (-1, 0, 1)
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
    # the editor and the viewer: an edit, a render and its undo through edit_cli, then a scripted
    # viewer with the grid, the gizmo and an edit verb
    from vk_gltf_renderer_tpu_torch import edit_cli, viewer
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert edit_cli.main([scene, "--device", "cpu", "-c", "translate 0 0 0.25 0",
                              "-c", f"render {d}/edit.png 24 16", "-c", "undo"]) == 0
        assert viewer.main(["--scenefile", scene, "--size", "16", "--maxDepth", "2", "--device", "cpu",
                            "--keys", "aw]Gg:translate 1 0 0.1 0;:undo;n", "--output", d + "/viewer.png"]) == 0
    assert f"rendered {d}/edit.png" in buf.getvalue() and "+grid +gizmo:translate" in buf.getvalue()
    from vk_gltf_renderer_tpu_torch.utils.png import read_png
    for png in ("edit.png", "viewer.png"):
        with open(f"{d}/{png}", "rb") as f:
            assert read_png(f.read()).mean() > 2
blocked = ("jax", "vk_gltf_renderer_tpu", "PIL", "zstandard")
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
    pattern = re.compile(r"^\s*(import|from)\s+(jax|vk_gltf_renderer_tpu|tools|PIL|zstandard)\b(?!_torch)", re.M)
    files = list((ROOT / "vk_gltf_renderer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                         ROOT / "bvh4_tuning.py",
                                                                         ROOT / "frame_ab.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
    # the image readers are among the files scanned
    assert {"psd.py", "sgi.py", "pcx.py", "ico.py", "qoi.py", "sun.py", "tiff.py", "jpeg.py", "image_io.py", "png.py",
            "zstd.py", "blp.py", "ftex.py", "xbm.py", "xpm.py", "msp.py", "im.py"} <= {p.name for p in files}
    # the scan itself sees both kinds of import
    assert pattern.search("import jax.numpy as jnp") and pattern.search(
        "    from vk_gltf_renderer_tpu.models import Scene") and pattern.search("        from PIL import Image")
    assert pattern.search("    import zstandard") and pattern.search("from zstandard import ZstdDecompressor")
    assert not pattern.search("from vk_gltf_renderer_tpu_torch.models import Scene")
