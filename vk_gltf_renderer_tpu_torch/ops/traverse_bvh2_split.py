"""Binary traversal over the split tables (v1): the wrapper of
csrc/traverse_bvh2_split.cu, replacing the reference's traverse_packets
(vk_gltf_renderer_tpu/ops/pallas_traverse.py, _traverse_body), reached
through ops/intersect.intersect_rays_packet(v2=False).

CPU rays take the plain torch version (ops/traverse.traverse_bvh2_split_plain),
CUDA rays the kernel; see ops/traverse_launch.run_traversal. On the card a
launch compacts the live lanes into a scratch list, which a persistent
grid walks (ops/traverse_launch.list_scratch).
"""

from __future__ import annotations

import torch

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_bvh2_split_plain
from .traverse_launch import list_scratch, run_traversal

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # stack pushes dropped (must stay 0)


def traverse_bvh2_split(nodes_f, nodes_i, tris, *rays, root_leaf=None):
    """Raw closest-hit traversal from binary node 0: (t, rnode, row, u, v)
    for the 8 [N] f32 ray components, as traverse_bvh4_split returns.
    root_leaf: whether node 0 is a leaf (DeviceBvh.bvh2_split_root_leaf,
    read on the host when the tables were uploaded), which the kernel's
    dead-lane rule needs; required for CUDA rays, unused by the plain
    version."""
    if tris.shape[0] >= 2**24:
        raise ValueError("traverse_bvh2_split: at most 2**24 rows of tris")
    if root_leaf is None and rays[0].device.type == "cuda":
        raise ValueError("traverse_bvh2_split: CUDA rays need root_leaf "
                         "(DeviceBvh.bvh2_split_root_leaf)")
    return run_traversal(
        "traverse_bvh2_split", COUNTER, OVERFLOW,
        lambda: traverse_bvh2_split_plain(nodes_f, nodes_i, tris, *rays),
        (("nodes_f", nodes_f, (None, 16)), ("nodes_i", nodes_i, (None, 8), torch.int32),
         ("tris", tris, (None, 16))),
        (int(bool(root_leaf)),), rays, None, extra=list_scratch)
