"""Stackless skip-pointer traversal: the lane page builder and the wrapper
of csrc/traverse_lanes.cu (replacing the reference's traverse_lanes and
traverse_lanes_stream, kernel values lane and lane_stream).

build_lane_tree is a jax-free copy of the reference's build_lane_tree
(vk_gltf_renderer_tpu/ops/lane_traverse.py:65), the pages and their refit
map geo_idx, and refit_lane_pages (:173) rebuilds the page values from
refitted boxes and triangles on the device. The tree is laid out in DFS order with skip
pointers, leaves expanded to one triangle per entry with precomputed
edges, 16 f32 fields per entry:

  internal: [lo.xyz, hi.xyz,  0, 0, 0,        miss, 0,      0, 0,     0,   0, 0]
  triangle: [v0.xyz, e1.xyz,  e2.xyz,         next, triRow, 1, rnode, tri, 0, 0]

with miss/next/triRow/rnode/tri exact f32 integers (< 2^24). Entries are
padded to whole 128-entry pages with never-taken internal entries and
stored page-major, field-major within a page: [P*16, 128], entry e's field
f at [(e >> 7) * 16 + f, e & 127]. The kernel and its plain version read
the entry-major copy lane_entries(pages) [P*128, 16] instead (one 64-byte
row per entry); convert.bvh_to_device makes it.

traverse_lanes takes CPU rays to the plain version
(ops/traverse.traverse_lanes_plain) and CUDA rays to the kernel; see
ops/traverse_launch.py (the kernel compacts the live lanes into
list_scratch).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda_lib import LaunchCounter, OverflowCounter
from .traverse import traverse_lanes_plain
from .traverse_launch import list_scratch, run_traversal

FIELDS = 16  # 14 used + 2 pad
PAGE = 128
_BIG = 3e37

COUNTER = LaunchCounter()
OVERFLOW = OverflowCounter()  # links that did not advance (must stay 0)


def build_lane_tree(nodes_i, nodes_self, tris16, wtri_rnode=None, wtri_tri=None):
    """DFS skip-pointer pages [P*16,128] f32 of the collapsed binary BVH,
    and their refit map geo_idx [P*16,128] i32.

    nodes_i: [N,8] i32 (left,right,first,count,parent,axis,...)
    nodes_self: [N,8] f32 (own lo.xyz, hi.xyz, pad) per node
    tris16: [T+pad,16] f32 (v0.xyz, v1.xyz, v2.xyz, pad) in BVH tri order
    wtri_rnode/wtri_tri: optional [T'] i32 per-tri-row (render-node,
    global-tri) ids, baked into triangle entries (fields 12/13) so hits
    resolve in-kernel; zeros when omitted.

    geo_idx maps each page element to the flattened geometry source
    concat(nodes_self[:, :6].ravel(), tri_geo.ravel()), tri_geo [T,9]
    being v0, e1, e2 of each tris16 row, and holds -1 on topology
    elements (refit_lane_pages)."""
    nodes_i = np.asarray(nodes_i)
    nodes_self = np.asarray(nodes_self, np.float32)
    tris16 = np.asarray(tris16, np.float32)
    left, right = nodes_i[:, 0].astype(np.int64), nodes_i[:, 1].astype(np.int64)
    first, count = nodes_i[:, 2].astype(np.int64), nodes_i[:, 3].astype(np.int64)
    is_leaf = count > 0

    # ---- subtree entry counts, bottom-up (children have larger ids is NOT
    # guaranteed; iterate until fixed point over unresolved internals)
    size = np.where(is_leaf, count, -1)
    pending = ~is_leaf
    while pending.any():
        sl = size[left[pending]]
        sr = size[right[pending]]
        ready = (sl >= 0) & (sr >= 0)
        idx = np.nonzero(pending)[0][ready]
        size[idx] = 1 + sl[ready] + sr[ready]
        pending[idx] = False

    total = int(size[0])
    # ---- entry start + skip per node, top-down (BFS)
    nn = nodes_i.shape[0]
    start = np.zeros(nn, np.int64)
    skip = np.zeros(nn, np.int64)
    start[0], skip[0] = 0, total
    order = [0]
    for n in order:
        if is_leaf[n]:
            continue
        l, r = left[n], right[n]
        start[l] = start[n] + 1
        start[r] = start[l] + size[l]
        skip[l] = start[r]
        skip[r] = skip[n]
        order.append(l)
        order.append(r)

    ent = np.zeros((total, FIELDS), np.float32)
    geo = np.full((total, FIELDS), -1, np.int64)

    # internal entries
    ints = np.asarray([n for n in order if not is_leaf[n]], np.int64)
    if ints.size:
        s = start[ints]
        ent[s, 0:6] = nodes_self[ints, 0:6]
        ent[s, 9] = skip[ints].astype(np.float32)
        # geometry source rows: nodes_self[n, 0:6] lives at n*6 .. n*6+5
        geo[s, 0:6] = ints[:, None] * 6 + np.arange(6)[None, :]

    # triangle entries (vectorized over all leaf runs)
    leaves = np.asarray([n for n in order if is_leaf[n]], np.int64)
    if leaves.size:
        c = count[leaves]
        reps = np.repeat(np.arange(leaves.size), c)  # leaf index per entry
        k = np.arange(reps.size) - np.repeat(np.cumsum(c) - c, c)  # 0..c-1
        rows = first[leaves][reps] + k  # tri row in tris16
        s = start[leaves][reps] + k  # entry index
        last = k == (c[reps] - 1)
        nxt = np.where(last, skip[leaves][reps], s + 1)
        v0 = tris16[rows, 0:3]
        e1 = tris16[rows, 3:6] - v0
        e2 = tris16[rows, 6:9] - v0
        ent[s, 0:3] = v0
        ent[s, 3:6] = e1
        ent[s, 6:9] = e2
        ent[s, 9] = nxt.astype(np.float32)
        ent[s, 10] = rows.astype(np.float32)
        ent[s, 11] = 1.0
        if wtri_rnode is not None:
            ent[s, 12] = np.asarray(wtri_rnode)[rows].astype(np.float32)
            ent[s, 13] = np.asarray(wtri_tri)[rows].astype(np.float32)
        geo[s, 0:9] = nn * 6 + rows[:, None] * 9 + np.arange(9)[None, :]

    # pad to whole pages with never-hit internal entries
    pad = (-total) % PAGE
    if pad:
        pe = np.zeros((pad, FIELDS), np.float32)
        pe[:, 0:3] = _BIG
        pe[:, 3:6] = -_BIG
        pe[:, 9] = total + pad
        ent = np.concatenate([ent, pe], axis=0)
        geo = np.concatenate([geo, np.full((pad, FIELDS), -1, np.int64)], axis=0)

    p = ent.shape[0] // PAGE
    pages = ent.reshape(p, PAGE, FIELDS).transpose(0, 2, 1).reshape(p * FIELDS, PAGE)
    geo_idx = geo.reshape(p, PAGE, FIELDS).transpose(0, 2, 1).reshape(p * FIELDS, PAGE)
    return np.ascontiguousarray(pages), geo_idx.astype(np.int32)


def refit_lane_pages(pages, geo_idx, nodes_self, tris16):
    """Page values rebuilt from refitted boxes and triangles (tensors;
    topology static): every element whose geo_idx is >= 0 takes its
    geometry source, the others keep their value. Elementwise in the
    layout, so the entry-major lane_entries refit with lane_entries(geo_idx)."""
    v0 = tris16[:, 0:3]
    tri_geo = torch.cat([v0, tris16[:, 3:6] - v0, tris16[:, 6:9] - v0], dim=1)
    src = torch.cat([nodes_self[:, 0:6].reshape(-1), tri_geo.reshape(-1)])
    gathered = src[geo_idx.clamp(min=0).long()]
    return torch.where(geo_idx >= 0, gathered, pages)


def lane_entries(pages) -> np.ndarray:
    """Page-major field-major pages [P*16,128] -> entry-major [P*128,16]
    (f32 pages, or the int32 geo_idx of the same layout)."""
    pages = np.asarray(pages)
    p = pages.shape[0] // FIELDS
    return np.ascontiguousarray(pages.reshape(p, FIELDS, PAGE).transpose(0, 2, 1).reshape(p * PAGE, FIELDS))


def traverse_lanes(entries, *rays, anyhit=False):
    """Raw walk over the entry-major lane entries [E,16]: (t, rnode, tri, u,
    v) for the 8 [N] f32 ray components. t is the best t (tmax where
    nothing hit; an any-hit keeps its t)."""
    return run_traversal(
        "traverse_lanes", COUNTER, OVERFLOW,
        lambda: traverse_lanes_plain(entries, *rays, anyhit=anyhit),
        (("lane_entries", entries, (None, FIELDS)),),
        (entries.shape[0],), rays, anyhit, extra=list_scratch)
