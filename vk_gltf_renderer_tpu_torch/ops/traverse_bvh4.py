"""BVH4 traversal: the wrapper of csrc/traverse_bvh4.cu and the public
ray-batch entry point.

traverse_bvh4 takes CPU tensors to the plain torch version
(ops/traverse.traverse_bvh4_plain) and CUDA tensors to the kernel; it
never falls back from one to the other. intersect_rays_soa mirrors the
reference's intersect_rays_packet_soa (vk_gltf_renderer_tpu/ops/
pallas_traverse.py:1808), including its post-processing: lanes without a
hit get t = INFINITE and ids -1, and any-hit t becomes 0 or INFINITE.
"""

from __future__ import annotations

import torch

from ..cuda_lib import LaunchCounter, check_launch, library
from .traverse import INFINITE, traverse_bvh4_plain

COUNTER = LaunchCounter()
_overflow_cpu = 0
_overflow_dev: dict = {}  # torch.device -> [1] int32 stack-overflow counter


def stack_overflows() -> int:
    """Stack pushes dropped so far (CPU plain runs + every CUDA device).
    Reading a device counter synchronises with it."""
    return _overflow_cpu + sum(int(b.item()) for b in _overflow_dev.values())


def reset_stack_overflows() -> None:
    global _overflow_cpu
    _overflow_cpu = 0
    for b in _overflow_dev.values():
        b.zero_()


def _check(name, t, dtype, n=None, dev=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if n is not None and t.shape != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
    if dev is not None and t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def traverse_bvh4(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                  anyhit=False):
    """Raw traversal: (t, rnode, tri, u, v) for [N] f32 ray components.
    t is the best t (tmax where nothing hit, -1 after an any-hit)."""
    global _overflow_cpu
    if rox.device.type == "cpu":
        *out, dropped = traverse_bvh4_plain(nodes4_fi, tris128, root_code, rox, roy, roz,
                                            rdx, rdy, rdz, tmin, tmax, anyhit=anyhit)
        _overflow_cpu += dropped
        return tuple(out)
    if rox.device.type != "cuda":
        raise ValueError(f"traverse_bvh4: unsupported device {rox.device}")
    dev = rox.device
    n = rox.shape[0]
    if nodes4_fi.ndim != 2 or nodes4_fi.shape[1] != 32:
        raise ValueError(f"nodes4_fi: expected [M,32], got {tuple(nodes4_fi.shape)}")
    if tris128.ndim != 2 or tris128.shape[1] != 128:
        raise ValueError(f"tris128: expected [L,128], got {tuple(tris128.shape)}")
    if n >= 2**31:
        raise ValueError("traverse_bvh4: at most 2**31-1 rays per launch")
    _check("nodes4_fi", nodes4_fi, torch.float32, dev=dev)
    _check("tris128", tris128, torch.float32, dev=dev)
    comps = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    for name, c in zip(("rox", "roy", "roz", "rdx", "rdy", "rdz", "tmin", "tmax"), comps):
        _check(name, c, torch.float32, n, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    rnode = torch.empty(n, dtype=torch.int32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, rnode, tri, u, v
    if dev not in _overflow_dev:
        _overflow_dev[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = library().lib
    rc = lib.vkgr_traverse_bvh4(
        nodes4_fi.data_ptr(), tris128.data_ptr(), int(root_code),
        *(c.data_ptr() for c in comps), n, int(bool(anyhit)),
        t.data_ptr(), rnode.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        _overflow_dev[dev].data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc, "traverse_bvh4")
    COUNTER.launches += 1
    return t, rnode, tri, u, v


def intersect_rays_soa(bvh, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, anyhit=False):
    """Closest hit (or any hit) of a ray batch against the device BVH
    (convert.DeviceBvh). Returns dict(t, rnode, tri, u, v) of [N]."""
    t, rnode, tri, u, v = traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code,
                                        rox, roy, roz, rdx, rdy, rdz, tmin, tmax, anyhit=anyhit)
    valid = tri >= 0
    if anyhit:
        t = torch.where(valid, 0.0, INFINITE)
    else:
        t = torch.where(valid, t, INFINITE)
    return {
        "t": t,
        "rnode": torch.where(valid, rnode, -1),
        "tri": torch.where(valid, tri, -1),
        "u": u,
        "v": v,
    }
