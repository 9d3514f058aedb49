"""BVH4 traversal: the wrapper of csrc/traverse_bvh4.cu (replacing the
reference's traverse_packets3 and traverse_packets9, kernel values v3, v9,
v9x4 and v9x8).

CPU rays take the plain torch version (ops/traverse.traverse_bvh4_plain),
CUDA rays the kernel; see ops/traverse_launch.py. The renderer reaches it
through ops/intersect.intersect_rays_soa.

On the card a launch is three steps on the current stream: the kernel's
entry zeroes the live count and the work cursor at the head of a scratch
buffer, compact_lanes writes the dead lanes' results and lists the live
lanes, and a persistent grid walks the list. The wrapper allocates the
scratch (scratch_words(n) int32, torch.empty); nothing is read back on
the host.
"""

from __future__ import annotations

import torch

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh4_plain
from .traverse_launch import run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)

SCRATCH_HEADER = 4  # live count, work cursor, pad: the list starts 16 bytes in


def scratch_words(n: int) -> int:
    """int32 words of the kernel's scratch for n lanes: the header, then
    the list of live lanes (at most n)."""
    return SCRATCH_HEADER + n


def _scratch(n, dev):
    return (torch.empty(scratch_words(n), dtype=torch.int32, device=dev),)


def traverse_bvh4(nodes4_fi, tris128, root_code, *rays, anyhit=False):
    """Raw traversal: (t, rnode, tri, u, v) for the 8 [N] f32 ray components
    (rox, roy, roz, rdx, rdy, rdz, tmin, tmax). t is the best t (tmax where
    nothing hit, -1 after an any-hit)."""
    return run_traversal(
        "traverse_bvh4", COUNTER, OVERFLOW,
        lambda: traverse_bvh4_plain(nodes4_fi, tris128, root_code, *rays, anyhit=anyhit),
        (("nodes4_fi", nodes4_fi, (None, 32)), ("tris128", tris128, (None, 128))),
        (root_code,), rays, anyhit, extra=_scratch)
