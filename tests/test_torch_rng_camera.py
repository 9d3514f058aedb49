"""Port RNG and camera rays against the JAX package.

The RNG is integer arithmetic and must match bit for bit (seeds and the
floats drawn from them). Ray generation is float32 arithmetic in the same
order as the reference; 1e-6 absolute covers the last-ulp differences of
the two CPU backends on unit-length directions and origins of order 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_gltf_renderer_tpu.ops import camera as jcam
from vk_gltf_renderer_tpu.ops import rng as jrng
from vk_gltf_renderer_tpu.utils import mathutil as mu
from vk_gltf_renderer_tpu_torch.ops import camera as tcam
from vk_gltf_renderer_tpu_torch.ops import rng as trng


def _u32(rng, n):
    v = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    v[:4] = [0, 1, 2**31, 2**32 - 1]
    return v


def test_xxhash32_bit_exact():
    rng = np.random.default_rng(0)
    x, y, z = _u32(rng, 4096), _u32(rng, 4096), _u32(rng, 4096)
    ref = np.asarray(jrng.xxhash32(jnp.asarray(x.astype(np.uint32)), jnp.asarray(y.astype(np.uint32)),
                                   jnp.asarray(z.astype(np.uint32))))
    port = trng.xxhash32(torch.tensor(x.astype(np.int64)), torch.tensor(y.astype(np.int64)),
                         torch.tensor(z.astype(np.int64))).numpy()
    assert port.min() >= 0 and port.max() < 2**32
    assert np.array_equal(port.astype(np.uint32), ref)


def test_pixel_seeds_bit_exact():
    w, h, frame = 37, 11, 5
    px = np.tile(np.arange(w, dtype=np.uint32), h)
    py = np.repeat(np.arange(h, dtype=np.uint32), w)
    ref = np.asarray(jrng.xxhash32(jnp.asarray(px), jnp.asarray(py), jnp.uint32(frame)))
    port = trng.xxhash32(torch.tensor(px.astype(np.int64)), torch.tensor(py.astype(np.int64)), frame)
    assert np.array_equal(port.numpy().astype(np.uint32), ref)


@pytest.mark.parametrize("draw", ["rand", "rand2", "rand3"])
def test_rand_sequences_bit_exact(draw):
    seeds = _u32(np.random.default_rng(1), 2048)
    js = jnp.asarray(seeds.astype(np.uint32))
    ts = torch.tensor(seeds.astype(np.int64))
    for _ in range(6):
        ju, js = getattr(jrng, draw)(js)
        tu, ts = getattr(trng, draw)(ts)
        assert tu.dtype == torch.float32
        assert np.array_equal(tu.numpy(), np.asarray(ju))
        assert np.array_equal(ts.numpy().astype(np.uint32), np.asarray(js))


def test_sample_gaussian():
    """log/cos/sin: XLA's CPU versions are polynomial approximations whose
    code depends on the host's vector extensions, so a few ulps against
    torch's: 1e-5 on values of magnitude up to ~5."""
    u = np.random.default_rng(2).random((4096, 2), dtype=np.float32)
    ref = np.asarray(jrng.sample_gaussian(jnp.asarray(u)))
    port = trng.sample_gaussian(torch.tensor(u)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)


def test_sample_gaussian_floor_is_kept():
    """u = 0 hits the 1e-38 floor. 1e-38 is subnormal in float32 and XLA
    on the CPU flushes it to zero (log(0) = -inf, an infinite jitter the
    frame later sanitises to black); the port keeps the floor the
    reference's code states, so the jitter stays finite."""
    g = trng.sample_gaussian(torch.tensor([[0.0, 0.5]]))
    assert torch.isfinite(g).all()
    assert abs(float(g[0, 0]) + float(np.sqrt(-2.0 * np.log(1e-38)))) < 1e-4


def _camera(w, h):
    view = mu.look_at([1.5, 1.2, 3.0], [0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    proj = mu.perspective(np.radians(45.0), w / h, 0.01, 100.0)
    ortho = mu.orthographic(2.0, 1.5, 0.01, 100.0)
    inv = lambda m: np.linalg.inv(m.astype(np.float64)).astype(np.float32)  # noqa: E731
    return inv(view), inv(proj), inv(ortho)


@pytest.mark.parametrize("orthographic", [False, True])
def test_generate_rays(orthographic):
    w, h = 40, 30
    view_inv, proj_inv, ortho_inv = _camera(w, h)
    p_inv = ortho_inv if orthographic else proj_inv
    px = np.tile(np.arange(w), h)
    py = np.repeat(np.arange(h), w)
    pos = np.stack([px, py], -1).astype(np.float32)
    jit = np.random.default_rng(3).random((w * h, 2), dtype=np.float32)
    size = np.array([w, h], np.float32)
    ro_j, rd_j = jcam.generate_rays(jnp.asarray(pos), jnp.asarray(jit), jnp.asarray(size),
                                    jnp.asarray(p_inv), jnp.asarray(view_inv), orthographic=orthographic)
    ro_t, rd_t = tcam.generate_rays(torch.tensor(pos), torch.tensor(jit), torch.tensor(size),
                                    torch.tensor(p_inv), torch.tensor(view_inv), orthographic=orthographic)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-6)


def test_depth_of_field():
    w, h = 20, 10
    view_inv, proj_inv, _ = _camera(w, h)
    rng = np.random.default_rng(4)
    ro = rng.normal(size=(w * h, 3)).astype(np.float32)
    rd = rng.normal(size=(w * h, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    u1, u2 = rng.random(w * h, dtype=np.float32), rng.random(w * h, dtype=np.float32)
    oj, dj = jcam.apply_depth_of_field(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(view_inv), 3.0, 0.05,
                                       jnp.asarray(u1), jnp.asarray(u2))
    ot, dt = tcam.apply_depth_of_field(torch.tensor(ro), torch.tensor(rd), torch.tensor(view_inv), 3.0, 0.05,
                                       torch.tensor(u1), torch.tensor(u2))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    assert tcam.pixel_angle(0.8, 1080) == jcam.pixel_angle(0.8, 1080)
