"""The port's front ends against the JAX package's, on the CPU: the headless
CLI (its BENCHMARK_JSON record and its PNG, with and without a material
variant), the parser's flags and defaults, the settings overlay, the
benchmark harness (`compare` and `run`), the bench entry, the unported
flags, material variants and the frame profiler's summary.

The PNGs agree at the 8-bit form of tests/test_torch_frame.py's
thresholds: >= 99% of pixels within 1 code value in every channel, and
each channel's mean within 0.5 code values."""

import csv
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from vk_gltf_renderer_tpu import headless as jheadless  # noqa: E402
from vk_gltf_renderer_tpu.benchmark import __main__ as jbenchmark  # noqa: E402
from vk_gltf_renderer_tpu.models import Scene as JScene  # noqa: E402
from vk_gltf_renderer_tpu.models import variants as jvariants  # noqa: E402
from vk_gltf_renderer_tpu.renderer import GltfRenderer as JaxRenderer  # noqa: E402
from vk_gltf_renderer_tpu.utils import profiler as jprofiler  # noqa: E402
from vk_gltf_renderer_tpu.utils import settings as jsettings  # noqa: E402
from vk_gltf_renderer_tpu_torch import bench_impl, headless  # noqa: E402
from vk_gltf_renderer_tpu_torch.benchmark import __main__ as benchmark  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import Scene  # noqa: E402
from vk_gltf_renderer_tpu_torch.models import variants  # noqa: E402
from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin, write_synthetic_hdr  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils import profiler, settings  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.png import read_png  # noqa: E402
from torch_test_helpers import one_torch_thread, share_native_builder  # noqa: E402, F401 (a fixture)

share_native_builder()

W, H, FRAMES, DEPTH = 48, 32, 3, 5


@pytest.fixture(autouse=True)
def _settings_file(tmp_path, monkeypatch):
    """Both packages read and write one settings file of the test's own."""
    monkeypatch.setenv("VKGR_SETTINGS", str(tmp_path / "settings.json"))


def _helmet(tmp_path):
    scene = make_helmet_standin(str(tmp_path))
    return scene, write_synthetic_hdr(tmp_path / "env.hdr", 64, 128)


def _with_variants(scene_path, applied=None):
    """The helmet stand-in with two KHR_materials_variants, as in
    tests/test_features.py: variant 0 keeps the sphere's material, variant
    1 maps it to a new green one. applied=i writes the scene with variant
    i's material already on the sphere, as a rebuild after the switch sees
    it."""
    path = Path(scene_path)
    g = json.loads(path.read_text())
    g["materials"].append({"name": "green", "pbrMetallicRoughness": {
        "baseColorFactor": [0.1, 0.8, 0.1, 1.0], "roughnessFactor": 0.5, "metallicFactor": 0.0}})
    g["extensions"] = {"KHR_materials_variants": {"variants": [{"name": "base"}, {"name": "green"}]}}
    g["extensionsUsed"] = ["KHR_materials_variants"]
    prim = g["meshes"][0]["primitives"][0]
    mappings = [prim["material"], len(g["materials"]) - 1]
    prim["extensions"] = {"KHR_materials_variants": {"mappings": [
        {"material": m, "variants": [i]} for i, m in enumerate(mappings)]}}
    name = "helmet_variants.gltf"
    if applied is not None:
        prim["material"] = mappings[applied]
        name = f"helmet_variant{applied}.gltf"
    out = path.with_name(name)
    out.write_text(json.dumps(g))
    return str(out)


def _run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("BENCHMARK_JSON ")]
    assert len(lines) == 1, out
    return out, json.loads(lines[0].split(" ", 1)[1])


@pytest.mark.parametrize("variant", [None, 1])
@pytest.mark.usefixtures("one_torch_thread")
def test_headless_matches_jax_headless(variant, tmp_path, capsys):
    """The record and the PNG of the port's headless run against the
    reference's on the same arguments. With --variant, the reference's
    switch refits on the device (sync_scene_changes -> _refit_device),
    whose jitted hit-row bake rounds one column (43, ~1.5e3) in the last
    ulp on 2,470 of the helmet's 9,218 rows, and at depth 5 paths part on
    ~2.5% of pixels; the port rebuilds on the host, as the reference does
    on load. So the PNG is held against the reference's render of the
    switched scene as loaded (the variant's material in the file), and
    the --variant run against the reference's --variant run by its
    record and its switch."""
    scene, hdr = _helmet(tmp_path)
    common = ["--hdrfile", hdr, "--envSystem", "1", "--size", str(W), str(H), "--frames", str(FRAMES),
              "--ptDepth", str(DEPTH)]
    argv = ["--headless", "--scenefile", scene] + common
    ref_png = ["--output", str(tmp_path / "ref.png")]
    if variant is not None:
        argv = ["--headless", "--scenefile", _with_variants(scene)] + common + ["--variant", str(variant)]
        ref_out, ref = _run(jheadless.main, argv, capsys)
        _run(jheadless.main, ["--headless", "--scenefile", _with_variants(scene, variant)]
                         + common + ref_png, capsys)
    else:
        ref_out, ref = _run(jheadless.main, argv + ref_png, capsys)
    out, rec = _run(headless.main, argv + ["--output", str(tmp_path / "port.png"), "--device", "cpu"],
                    capsys)
    assert rec.keys() == ref.keys()
    for k in ("frames", "spp", "triangles", "width", "height", "max_depth", "env", "renderer"):
        assert rec[k] == ref[k], k
    assert rec["frames"] == FRAMES - 1 and rec["triangles"] == 9218 and rec["Mrays_per_sec"] > 0
    if variant is not None:
        line = f"variant {variant}: switched 1 primitives"
        assert line in ref_out and line in out
    img_r = read_png((tmp_path / "ref.png").read_bytes()).astype(np.int32)
    img_p = read_png((tmp_path / "port.png").read_bytes()).astype(np.int32)
    assert img_p.shape == img_r.shape == (H, W, 3)
    assert img_p.mean() > 2, "black frame"
    close = (np.abs(img_p - img_r) <= 1).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(img_p.mean(axis=(0, 1)), img_r.mean(axis=(0, 1)), atol=0.5)


def test_variant_changes_the_headless_image(tmp_path, capsys):
    """--variant 1 renders the sphere in its variant's material: the image
    differs from variant 0's, which is the scene's own."""
    scene, hdr = _helmet(tmp_path)
    scene = _with_variants(scene)
    imgs = []
    for v in (0, 1):
        png = tmp_path / f"v{v}.png"
        _run(headless.main, ["--scenefile", scene, "--hdrfile", hdr, "--envSystem", "1", "--size", "24", "16",
                             "--frames", "1", "--ptDepth", "2", "--variant", str(v), "--output", str(png),
                             "--device", "cpu"], capsys)
        imgs.append(read_png(png.read_bytes()).astype(np.int32))
    assert np.abs(imgs[0] - imgs[1]).max() > 20


def test_variants_match_jax(tmp_path):
    """The port's models/variants.py switches the same primitives as the
    reference's, and GltfRenderer.variants / set_variant use it."""
    scene = _with_variants(_helmet(tmp_path)[0])
    jsc, tsc = JScene(), Scene()
    jsc.load(scene)
    tsc.load(scene)
    assert variants.parse_variants(tsc.model) == jvariants.parse_variants(jsc.model) == ["base", "green"]
    for index in (1, 1, 0, 7):
        assert variants.apply_variant(tsc, index) == jvariants.apply_variant(jsc, index)
        assert tsc.model.meshes == jsc.model.meshes
    r = GltfRenderer(16, 12, spp=1, max_depth=1, device="cpu")
    r.create_scene(scene)
    assert r.variants() == ["base", "green"]
    mat = r.dev_scene.rn_material.clone()
    r.total_samples = 5
    assert r.set_variant(1) == 1
    assert r.total_samples == 0 and not torch.equal(r.dev_scene.rn_material, mat)
    assert r.set_variant(1) == 0


def test_parser_defaults_match_jax():
    port = vars(headless.build_parser().parse_args([]))
    ref = vars(jheadless.build_parser().parse_args([]))
    assert set(ref) - set(port) == {"platform"} and set(port) - set(ref) == {"device"}
    assert {k: v for k, v in port.items() if k != "device"} == {k: v for k, v in ref.items() if k != "platform"}
    assert port["device"] == "cuda"


def _settings_scenario(st, build_parser, tmp_path):
    """tests/test_tools.py::test_settings_persistence_cli_override's scenario."""
    st.save_settings({"flags": {"ptDepth": 9, "tonemapper": "aces"}, "recent_files": ["/tmp/a.glb"]})
    argv = ["--scenefile", "x.glb", "--ptDepth", "3"]
    args = build_parser().parse_args(argv)
    st.apply_saved_settings(args, argv)
    st.remember(args, "/tmp/b.glb")
    data = json.loads((tmp_path / "settings.json").read_text())
    return (args.ptDepth, args.tonemapper, data["flags"]["ptDepth"], data["flags"]["tonemapper"],
            data["recent_files"], st.recent_files())


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_settings_overlay(package, tmp_path):
    st, parser = (jsettings, jheadless.build_parser) if package == "jax" else (settings, headless.build_parser)
    assert _settings_scenario(st, parser, tmp_path) == (3, "aces", 3, "aces", ["/tmp/b.glb", "/tmp/a.glb"],
                                                        ["/tmp/b.glb", "/tmp/a.glb"])


def test_settings_overlay_matches_jax_and_ignores_unported_saved_flags(tmp_path):
    ref = _settings_scenario(jsettings, jheadless.build_parser, tmp_path)
    (tmp_path / "settings.json").unlink()
    assert _settings_scenario(settings, headless.build_parser, tmp_path) == ref
    # a store the JAX app wrote with its rasterizer and infinite plane on
    jsettings.save_settings({"flags": {"renderSystem": 1, "infinitePlane": 1, "ptDepth": 4}})
    argv = ["--scenefile", "x.glb"]
    args = headless.build_parser().parse_args(argv)
    settings.apply_saved_settings(args, argv)
    headless.check_ported(args)  # never raises for a saved value
    assert (args.renderSystem, args.infinitePlane, args.ptDepth) == (0, 0, 4)
    settings.remember(args, None)
    saved = json.loads((tmp_path / "settings.json").read_text())["flags"]
    assert saved["renderSystem"] == 1 and saved["infinitePlane"] == 1  # left for the JAX app
    assert settings.settings_path() == tmp_path / "settings.json"


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["scene", "spp", "width", "ms_per_frame", "peak_bytes"])
        w.writeheader()
        for r in rows:
            w.writerow(r)


@pytest.mark.parametrize("new_row,rc", [
    ({"ms_per_frame": "103.0", "peak_bytes": "1000000"}, 0),  # within threshold
    ({"ms_per_frame": "120.0", "peak_bytes": "1000000"}, 1),  # time regression
    ({"ms_per_frame": "100.0", "peak_bytes": str(1000000 + 100 * 1024 * 1024)}, 1),  # memory
])
def test_compare_matches_jax(new_row, rc, tmp_path, capsys):
    """tests/test_tools.py::test_benchmark_compare_thresholds's three cases."""
    base = {"scene": "s.glb", "spp": "1", "width": "64"}
    old, new = tmp_path / "old.csv", tmp_path / "new.csv"
    _write_csv(old, [{**base, "ms_per_frame": "100.0", "peak_bytes": "1000000"}])
    _write_csv(new, [{**base, **new_row}])
    args = types.SimpleNamespace(old=str(old), new=str(new), threshold=5.0, mem_threshold_mb=64.0)
    outs = []
    for cmd in (jbenchmark.cmd_compare, benchmark.cmd_compare):
        assert cmd(args) == rc
        outs.append(capsys.readouterr())
    assert outs[0] == outs[1]


@pytest.mark.usefixtures("one_torch_thread")
def test_run_writes_the_reference_csv_fields(tmp_path, capsys):
    scene, hdr = _helmet(tmp_path)
    cfg = tmp_path / "seq.cfg"
    cfg.write_text(f"# two lines\n--scenefile {scene} --size 16 12 --frames 2 --ptDepth 2\n"
                   f"--scenefile {scene} --size 16 12 --frames 2 --ptDepth 2 --envSystem 1 --hdrfile {hdr}\n")
    out = tmp_path / "rows.csv"
    assert benchmark.main(["run", str(cfg), "--output", str(out), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert benchmark.CSV_FIELDS == jbenchmark.CSV_FIELDS
    with open(out, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    assert reader.fieldnames == jbenchmark.CSV_FIELDS
    assert [r["env"] for r in rows] == ["sky", "hdr"]
    assert all(r["frames"] == "1" and r["triangles"] == "9218" and r["peak_bytes"] == "0" for r in rows)


@pytest.mark.usefixtures("one_torch_thread")
def test_bench_measure_counts_the_jax_renderers_rays(tmp_path):
    scene, hdr = _helmet(tmp_path)
    res = bench_impl._measure(scene, 32, 24, 1, 3, 1, 2, hdr=hdr, device="cpu")
    ref = JaxRenderer(32, 24, spp=1, max_depth=3)
    ref.create_scene(scene)
    ref.create_hdr(hdr)
    rays = [float(ref.on_render()["rays"]) for _ in range(3)][1:]
    assert res["rays_per_frame"] == sum(rays) / 2
    assert res["frames"] == 2 and res["device"] == "cpu" and res["triangles"] == 9218
    assert res["ms_min"] <= res["ms_median"] <= res["ms_max"] and res["mrays"] > 0
    assert res["kernels"] == {"traversal": "packet", "primary": "v3", "packet": "v9"}


def test_bench_main_prints_one_json_line(tmp_path, monkeypatch, capsys):
    scene, _ = _helmet(tmp_path)
    for k, v in (("VKGR_BENCH_W", "24"), ("VKGR_BENCH_H", "16"), ("VKGR_BENCH_FRAMES", "1"),
                 ("VKGR_BENCH_SCENE2", scene), ("VKGR_BENCH_SCENE2_TIMEOUT", "240")):
        monkeypatch.setenv(k, v)
    for k in ("VKGR_BENCH_SCENE", "VKGR_BENCH_RESOURCES", "VKGR_BENCH_ONLY_SCENE"):
        monkeypatch.delenv(k, raising=False)
    assert bench_impl.main(["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metric"] == "Mrays_per_sec" and res["unit"] == "Mrays/s" and res["value"] > 0
    d = res["detail"]
    assert d["resolution"] == "24x16" and d["frames"] == 1 and d["device"] == "cpu" and "gpu" not in d
    assert d["hdr"] == "synthetic 256x512, seed 0" and Path(d["scene"]).name == "helmet.gltf"
    assert "error" not in d["scene2"] and d["scene2"]["scene"] == scene
    assert d["scene2"]["rays_per_frame"] > 0


@pytest.mark.parametrize("flag", [["--renderSystem", "1"], ["--wireframe", "1"], ["--upscale", "2"],
                                  ["--animate", "1"], ["--infinitePlane", "1"], ["--output", "out.jpg"]])
def test_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported|PNG only"):
        headless.main(["--scenefile", str(tmp_path / "absent.gltf"), "--device", "cpu"] + flag)


def test_profiler_summary_and_memory(tmp_path):
    # busy share: the union of kernel intervals inside the window
    kernels = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("a", 30.0, 5.0), ("c", 95.0, 10.0)]
    s = profiler.summarize_kernels(kernels, (0.0, 100.0), 2)
    assert s["busy_share"] == pytest.approx(0.25)  # [0, 15] + [30, 35] + [95, 100]
    assert s["kernel_ms_per_frame"] == pytest.approx(0.0175) and s["launches_per_frame"] == 2
    assert s["wall_ms_per_frame"] == pytest.approx(0.05)
    assert [k["name"] for k in s["top"]] == ["a", "b", "c"]
    assert s["top"][0] == {"name": "a", "ms_per_frame": pytest.approx(0.0075), "launches_per_frame": 1.0}
    table = profiler.format_table(s).splitlines()
    assert "2 frames" in table[0] and "busy share 0.2500" in table[0] and len(table) == 2 + 3

    assert profiler.device_memory_stats("cpu") == jprofiler.device_memory_stats() == {
        "bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    r = GltfRenderer(16, 12, spp=1, max_depth=1, device="cpu")
    r.create_scene(_helmet(tmp_path)[0])
    mem = profiler.scene_memory_breakdown(r)
    assert mem["bvh"] == r.dev_bvh.nodes4_fi.numel() * 4
    assert mem["framebuffers"] == 16 * 12 * 3 * 4
    assert mem["total_tracked"] == sum(v for k, v in mem.items() if k != "total_tracked")
    assert mem["geometry"] >= r.dev_bvh.tris128.numel() * 4 + r.dev_bvh.hit_attr.numel() * 4
    with pytest.raises(ValueError, match="measures the card"):
        profiler.profile_frames(r)

    # sections: the same statistics as the reference's
    ours, ref = profiler.Profiler(), jprofiler.Profiler()
    for p in (ours, ref):
        for ms in (1.0, 3.0, 2.0):
            p.sections["frame"].add(ms)
    assert ours.as_dict() == ref.as_dict() and ours.report() == ref.report()
    with ours.section("sync", sync=torch.zeros(2)):
        pass
    assert ours.sections["sync"].count == 1
