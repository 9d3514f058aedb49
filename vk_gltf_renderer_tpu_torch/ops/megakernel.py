"""The bounce-loop megakernel (reference vk_gltf_renderer_tpu/ops/megakernel.py).

The reference's experiment runs a reduced but representative path in two
equivalent arms that differ only in where the bounce loop lives:

  render_mega       csrc/megakernel.cu: one launch of a persistent grid;
                    every bounce's BVH4 walk, shade and regeneration of a
                    path stay inside its lane, which takes the next path
                    when its own ends.
  render_wavefront  one traverse_bvh4 launch per bounce (csrc/traverse_bvh4.cu
                    on the card) with _shade_and_regen in torch between.

Reduced path, the same in both arms and in the same LCG streams: BVH4
closest hit; a miss adds SKY * throughput and kills the lane; a hit
multiplies throughput by ALBEDO; a living lane moves to its hit point and
takes a normalised cube direction from three LCG uniforms (details in
csrc/megakernel.cu). render_wavefront on CPU tensors, which takes the plain
traversal, is render_mega's plain version (render_mega_plain runs the same
on any device).

The public functions keep the reference's packed layout: ro, rd
[G,4,sub,128] f32 (ro ch 3 ignored, rd ch 3 = tmin), seeds [G,1,sub,128]
holding uint32 bit patterns in int32 (torch has no uint32 arithmetic), and
the result [G,2,sub,128] f32 = (radiance, last t). uint32 arithmetic runs in
int64 masked to 32 bits. The normalisation is 1 / sqrt(.) in both the
kernel and the plain version (the reference's lax.rsqrt may round the last
bit otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda_lib import LaunchCounter, OverflowCounter, check_launch, check_tensor, library
from .traverse import traverse_bvh4_plain
from .traverse_bvh4 import traverse_bvh4

ALBEDO = 0.7
SKY = 1.0
INF = 1e30  # a living lane's tmax (the reference's megakernel INF)
LANE = 128
SUB = 8  # rows of one (8,128) tile; sub = tiles * SUB

LCG_A = 1664525
LCG_C = 1013904223
INV_2_24 = 1.0 / 16777216.0

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped inside the megakernel (must stay 0)


def _rand(seed):
    """(uniform in [0,1) as f32, next seed) of int64 seeds < 2^32."""
    seed = (LCG_A * seed + LCG_C) & 0xFFFFFFFF
    return (seed >> 8).to(torch.float32) * INV_2_24, seed


def _cube_dir(seed):
    """Normalised cube sample from 3 uniforms (not uniform on the sphere;
    both arms use the same map)."""
    u1, seed = _rand(seed)
    u2, seed = _rand(seed)
    u3, seed = _rand(seed)
    dx = 2.0 * u1 - 1.0
    dy = 2.0 * u2 - 1.0
    dz = 2.0 * u3 - 1.0
    dz = dz + torch.where(dz >= 0.0, 0.05, -0.05)  # away from the zero vector
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv_len, dy * inv_len, dz * inv_len, seed


def _shade_and_regen(b, depth, alive, radiance, throughput, ro, rd, seed, t, tri):
    """One bounce of the reduced path (reference _shade_and_regen); ro, rd
    are 3-tuples of ray components."""
    hit = tri >= 0
    radiance = radiance + torch.where(alive & ~hit, SKY, 0.0) * throughput
    alive = alive & hit
    throughput = throughput * torch.where(alive, ALBEDO, 1.0)
    if b < depth - 1:
        ro = tuple(torch.where(alive, o + t * d, o) for o, d in zip(ro, rd))
        *nd, seed = _cube_dir(seed)
        rd = tuple(torch.where(alive, n, d) for n, d in zip(nd, rd))
    return alive, radiance, throughput, ro, rd, seed


def _wavefront(trace, ro, rd, seeds, depth, ended=None):
    """The bounce loop with one trace(8 ray components) call per bounce.
    ended: None, or a list that receives the number of paths that ended at
    each bounce (missed there, or lived through the last one)."""
    ro_c = tuple(ro[:, c].reshape(-1) for c in range(3))
    rd_c = tuple(rd[:, c].reshape(-1) for c in range(3))
    tmin = rd[:, 3].reshape(-1).contiguous()
    seed = seeds[:, 0].reshape(-1).long() & 0xFFFFFFFF
    n = tmin.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=ro.device)
    radiance = torch.zeros(n, device=ro.device)
    throughput = torch.ones(n, device=ro.device)
    t = torch.zeros(n, device=ro.device)
    for b in range(depth):
        tmax = torch.where(alive, INF, -1.0)
        t, _, tri, _, _ = trace(*(c.contiguous() for c in ro_c + rd_c), tmin, tmax)
        was_alive = alive
        alive, radiance, throughput, ro_c, rd_c, seed = _shade_and_regen(
            b, depth, alive, radiance, throughput, ro_c, rd_c, seed, t, tri)
        if ended is not None:
            ended.append(int((was_alive & ~alive).sum()) + (int(alive.sum()) if b == depth - 1 else 0))
    g, _, sub, lane = ro.shape
    return torch.stack([radiance, t]).reshape(2, g, sub, lane).transpose(0, 1).contiguous()


def render_wavefront(nodes4_fi, tris128, ro, rd, seeds, depth, root_code=0):
    """Wavefront arm: one traverse_bvh4 launch per bounce (its plain version
    for CPU tensors) and the shade/regeneration glue in torch. Same I/O as
    render_mega."""
    def trace(*rays):
        return traverse_bvh4(nodes4_fi, tris128, root_code, *rays)

    return _wavefront(trace, ro, rd, seeds, depth)


def render_mega_plain(nodes4_fi, tris128, ro, rd, seeds, depth, root_code=0, stats=None):
    """render_mega's plain version: the wavefront loop over the plain BVH4
    walk, on any device. stats: visit counts of every bounce's walk
    (ops/traverse.traverse_rows_plain) and "ended", the paths that ended at
    each bounce (the lanes of the padding included)."""
    def trace(*rays):
        *out, dropped = traverse_bvh4_plain(nodes4_fi, tris128, root_code, *rays, stats=stats)
        OVERFLOW.cpu += dropped
        return out

    ended = None if stats is None else stats.setdefault("ended", [])
    return _wavefront(trace, ro, rd, seeds, depth, ended)


def render_mega(nodes4_fi, tris128, ro, rd, seeds, depth, root_code=0):
    """Megakernel arm: the whole bounce loop in one launch of
    csrc/megakernel.cu for CUDA tensors; render_mega_plain for CPU ones.
    ro, rd [G,4,sub,128] f32, seeds [G,1,sub,128] int32 (uint32 bits).
    Returns [G,2,sub,128] f32: (radiance, last t). On the card the kernel's
    lanes take paths from a cursor in a one-word scratch buffer, which its
    entry zeroes on the stream."""
    if ro.device.type == "cpu":
        return render_mega_plain(nodes4_fi, tris128, ro, rd, seeds, depth, root_code)
    if ro.device.type != "cuda":
        raise ValueError(f"render_mega: unsupported device {ro.device}")
    dev = ro.device
    g, _, sub, lane = ro.shape
    per = sub * lane
    n = g * per
    if n >= 2**31:
        raise ValueError("render_mega: at most 2**31-1 rays per launch")
    check_tensor("nodes4_fi", nodes4_fi, torch.float32, (None, 32), dev)
    check_tensor("tris128", tris128, torch.float32, (None, 128), dev)
    check_tensor("ro", ro, torch.float32, (g, 4, sub, lane), dev)
    check_tensor("rd", rd, torch.float32, (g, 4, sub, lane), dev)
    check_tensor("seeds", seeds, torch.int32, (g, 1, sub, lane), dev)
    out = torch.empty((g, 2, sub, lane), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    cursor = torch.empty(1, dtype=torch.int32, device=dev)
    rc = library().lib.vkgr_render_mega(
        nodes4_fi.data_ptr(), tris128.data_ptr(), int(root_code), ro.data_ptr(), rd.data_ptr(),
        seeds.data_ptr(), n, per, int(depth), out.data_ptr(), OVERFLOW.buffer(dev).data_ptr(),
        cursor.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "render_mega")
    COUNTER.launches += 1
    return out


def pack_rays(ro_flat, rd_flat, seeds_flat, tiles=1, tmin=1e-3, device="cuda"):
    """[N,3] origins / directions and [N] uint32 seeds (numpy) -> the packed
    layout both arms take: (ro, rd [G,4,sub,128] f32, seeds [G,1,sub,128]
    int32, N). Padding lanes start at the origin along (1,1,1) with seed 0,
    as the reference pads."""
    ro_flat = np.asarray(ro_flat, np.float32)
    rd_flat = np.asarray(rd_flat, np.float32)
    seeds_flat = np.asarray(seeds_flat, np.uint32)
    n = ro_flat.shape[0]
    sub = tiles * SUB
    per = sub * LANE
    g = (n + per - 1) // per
    pad = g * per - n
    ro_flat = np.concatenate([ro_flat, np.zeros((pad, 3), np.float32)])
    rd_flat = np.concatenate([rd_flat, np.ones((pad, 3), np.float32)])
    seeds_flat = np.concatenate([seeds_flat, np.zeros(pad, np.uint32)])

    def chan(x3, extra):
        cols = np.concatenate([x3, np.full((g * per, 1), extra, np.float32)], axis=1)
        return torch.tensor(np.ascontiguousarray(cols.T.reshape(4, g, sub, LANE).transpose(1, 0, 2, 3)),
                            device=device)

    seeds = torch.tensor(seeds_flat.view(np.int32).reshape(g, 1, sub, LANE), device=device)
    return chan(ro_flat, INF), chan(rd_flat, tmin), seeds, n
