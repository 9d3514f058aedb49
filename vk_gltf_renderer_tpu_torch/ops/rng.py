"""Deterministic per-pixel RNG: xxhash32 seeding + LCG sequence.

Bit-exact port of vk_gltf_renderer_tpu/ops/rng.py. torch has no full
uint32 arithmetic, so a uint32 value lives in an int64 tensor in
[0, 2**32): products are split so they never leave int64, and every value
is masked to 32 bits before it is shifted right (int64 '>>' is
arithmetic). The sequence depends only on (pixel, frame), like the
reference's.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_PRIME1 = 2246822519
_PRIME2 = 3266489917
_PRIME3 = 668265263
_PRIME4 = 374761393
_LCG_A = 1664525
_LCG_C = 1013904223
_INV_2_24 = 1.0 / 16777216.0


def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _mul32(a, b: int):
    """(a * b) mod 2**32 for a in [0, 2**32), b a uint32 constant, without
    int64 overflow: split a into 16-bit halves."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def xxhash32(x, y, z):
    """xxhash32 of a uint3; inputs are anything torch.as_tensor takes."""
    x, y, z = _u32(x), _u32(y), _u32(z)
    h = (z + _PRIME4 + _mul32(x, _PRIME2)) & _MASK
    h = _mul32(_rotl(h, 17), _PRIME3)
    h = (h + _mul32(y, _PRIME2)) & _MASK
    h = _mul32(_rotl(h, 17), _PRIME3)
    h = _mul32(h ^ (h >> 15), _PRIME1)
    h = _mul32(h ^ (h >> 13), _PRIME2)
    return h ^ (h >> 16)


def lcg(seed):
    return (_LCG_A * seed + _LCG_C) & _MASK  # _LCG_A * seed < 2**53: no overflow


def rand(seed):
    """One uniform float32 in [0,1) per lane; returns (u, new_seed)."""
    seed = lcg(seed)
    u = (seed >> 8).to(torch.float32) * _INV_2_24
    return u, seed


def rand2(seed):
    u1, seed = rand(seed)
    u2, seed = rand(seed)
    return torch.stack([u1, u2], dim=-1), seed


def rand3(seed):
    u1, seed = rand(seed)
    u2, seed = rand(seed)
    u3, seed = rand(seed)
    return torch.stack([u1, u2, u3], dim=-1), seed


def sample_gaussian(u):
    """Box-Muller pair from two uniforms (subpixel AA jitter)."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u[..., 0], min=1e-38)))
    theta = 2.0 * math.pi * u[..., 1]
    return r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
