"""The reference's analytic radiometry oracles (tests/test_analytic.py)
through the port's renderer on the CPU: absolute closed-form values from
the glTF BRDF, light and volume specs, not agreement with the JAX package.

Cases, each with tests/test_analytic.py's scene, camera, spp, depth and
tolerance. The light, Fresnel and clearcoat cases render a quarter of its
frames, a cheaper realization of the same estimator (point light: error
2.1e-3 against the 1e-2 tolerance; the smooth plates are noise-free to
1e-7). The slab renders all of its 16 frames: its residual against the
two-term closed form is systematic (~0.0086, test_analytic.py), and a
4-frame realization measured 0.0122:
  point light on a Lambertian plane   L = rho/pi * I * cos / r^2
  directional light (rotated node)    L = rho/pi * E * cos(theta)
  on-axis spot light                  L = rho/pi * I / r^2
  Fresnel plate (unit furnace)        L = F0 = 0.04
  Beer-Lambert slab (unit furnace)    L = F0 + (1-F0)^2 exp(-sigma d) + ...
  clearcoat Fresnel (unit furnace)    L = Fc(0) = 0.04

Every case runs with one torch thread (torch_test_helpers.one_torch_thread):
its ~1,000-lane tensors make a thread pool beside other test workers cost
far more in synchronisation than it computes.
"""

import numpy as np
import pytest

from test_analytic import RHO, _lambert_material, _scene
from torch_test_helpers import one_torch_thread  # noqa: F401 (a fixture)
from vk_gltf_renderer_tpu_torch.models import Scene
from vk_gltf_renderer_tpu_torch.ops.sky import SkyParams
from vk_gltf_renderer_tpu_torch.renderer import CameraState, GltfRenderer


FRAMES_CUT = 4  # the cases but the slab render test_analytic.py's frame count / 4


def _render(path, *, sky, spp=8, frames=60, max_depth=2, cut=FRAMES_CUT):
    """test_analytic._render through the port: 33x33, the camera 3 units
    up the z axis, frames // cut frames, the center 5x5 pixels' mean."""
    r = GltfRenderer(width=33, height=33, spp=spp, max_depth=max_depth, device="cpu")
    sc = Scene()
    sc.load(path)
    r.scene = sc
    r.camera = CameraState(
        eye=np.array([0.0, 0.0, 3.0]), center=np.zeros(3),
        up=np.array([0.0, 1.0, 0.0]), yfov=np.radians(45.0),
        znear=0.05, zfar=100.0,
    )
    r.sky_params = sky
    r.rebuild_device_scene()
    for _ in range(frames // cut):
        r.on_render()
    img = r.image_linear()
    assert np.isfinite(img).all()
    return img[14:19, 14:19].mean(axis=(0, 1))


def _black_sky():
    z = np.zeros(3, np.float32)
    return SkyParams(sun_intensity=0.0, sky_zenith=z, sky_horizon=z, ground_color=z, sun_sample_weight=0.0)


def _unit_sky():
    o = np.ones(3, np.float32)
    return SkyParams(sun_intensity=0.0, sky_zenith=o, sky_horizon=o, ground_color=o, sun_sample_weight=0.0)


def _light_case(name, tmp_path):
    """(scene path, closed form) of the three light oracles."""
    if name == "point":
        lights = [{"type": "point", "intensity": 400.0, "color": [1, 1, 1]}]
        nodes = [{"translation": [0.0, 0.0, 20.0]}]
        want = RHO / np.pi
    elif name == "directional":
        th = np.radians(30.0)
        lights = [{"type": "directional", "intensity": 2.0, "color": [1, 1, 1]}]
        nodes = [{"rotation": [float(np.sin(th / 2)), 0.0, 0.0, float(np.cos(th / 2))]}]
        want = RHO / np.pi * 2.0 * np.cos(th)
    else:
        lights = [{"type": "spot", "intensity": 400.0, "color": [1, 1, 1],
                   "spot": {"innerConeAngle": 0.3, "outerConeAngle": 0.6}}]
        nodes = [{"translation": [0.0, 0.0, 20.0]}]
        want = RHO / np.pi
    return _scene(tmp_path, material=_lambert_material(), lights=lights, light_nodes=nodes), want


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", ["point", "directional", "spot"])
def test_analytic_light(name, tmp_path):
    path, want = _light_case(name, tmp_path)
    got = _render(path, sky=_black_sky())
    assert np.allclose(got, want, atol=1e-2), (got, want)


def test_analytic_fresnel_plate(tmp_path):
    mat = {"pbrMetallicRoughness": {"baseColorFactor": [0.0, 0.0, 0.0, 1.0],
                                    "metallicFactor": 0.0, "roughnessFactor": 0.0}}
    got = _render(_scene(tmp_path, material=mat), sky=_unit_sky(), spp=16, frames=32)
    assert np.allclose(got, 0.04, atol=8e-3), got


def test_analytic_beer_lambert_slab(tmp_path):
    d = 0.2
    mat = {
        "pbrMetallicRoughness": {"baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                                 "metallicFactor": 0.0, "roughnessFactor": 0.0},
        "extensions": {
            "KHR_materials_transmission": {"transmissionFactor": 1.0},
            "KHR_materials_volume": {"thicknessFactor": d, "attenuationDistance": d,
                                     "attenuationColor": [0.5, 0.5, 0.5]},
        },
    }
    path = _scene(tmp_path, material=mat, slab=([-3.0, -3.0, -d], [3.0, 3.0, 0.0]))
    got = _render(path, sky=_unit_sky(), spp=16, frames=16, max_depth=6, cut=1)
    f0 = 0.04
    want = f0 + (1 - f0) ** 2 * 0.5 + (1 - f0) ** 2 * f0**2 * 0.25
    assert np.allclose(got, want, atol=1e-2), (got, want)


def test_analytic_clearcoat_fresnel(tmp_path):
    mat = {
        "pbrMetallicRoughness": {"baseColorFactor": [0.0, 0.0, 0.0, 1.0],
                                 "metallicFactor": 0.0, "roughnessFactor": 1.0},
        "extensions": {
            "KHR_materials_specular": {"specularFactor": 0.0},
            "KHR_materials_clearcoat": {"clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.0},
        },
    }
    got = _render(_scene(tmp_path, material=mat), sky=_unit_sky(), spp=16, frames=32)
    assert np.allclose(got, 0.04, atol=8e-3), got
