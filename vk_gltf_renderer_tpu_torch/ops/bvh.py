"""Two-level LBVH: build (host, vectorized numpy) and its refit.

jax-free copy of vk_gltf_renderer_tpu/ops/bvh.py. The reference registers
SceneBvh as a JAX pytree; here it is a plain dataclass. The Morton codes
and the Karras radix tree also carry bvh_flatten.build_world_bvh's LBVH
branch (VKGR_BVH=lbvh, and the fallback for scenes over 300,000 triangles
when the native builder is missing).

Contracts kept from the reference renderer:
  * one BLAS per unique RenderPrimitive; BLAS array index == renderPrimID.
  * TLAS leaves carry {instance transform, renderNode index}; invisible
    instances are masked (far-away degenerate boxes).

Build algorithm: Morton-code LBVH (Karras 2012, "Maximally Parallel
Construction of Binary Radix Trees"), vectorized over numpy with no
Python loop per node. One triangle per leaf; n-1 internal nodes. Node
layout is a flat SoA:

  lo/hi   [Nn,3] float32  AABB
  left    [Nn]   int32    child node id (internal) -- see `leaf` for leaves
  right   [Nn]   int32
  tri     [Nn]   int32    leaf: GLOBAL triangle id; internal: -1
  parent  [Nn]   int32    for bottom-up refit
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SceneBvh:
    """Flat two-level BVH arrays."""

    # concatenated BLAS nodes for all primitives
    lo: np.ndarray
    hi: np.ndarray
    left: np.ndarray
    right: np.ndarray
    tri: np.ndarray
    parent: np.ndarray
    prim_root: np.ndarray  # [P] root node id per renderPrimID
    # TLAS over instances
    tl_lo: np.ndarray
    tl_hi: np.ndarray
    tl_left: np.ndarray
    tl_right: np.ndarray
    tl_inst: np.ndarray  # leaf: render-node id; internal: -1
    tl_root: int


# --------------------------------------------------------------------- morton
def _expand_bits_10(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (for 30-bit 3D Morton codes)."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton3d(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip((centroids - lo) / ext * 1024.0, 0, 1023).astype(np.uint32)
    return (
        (_expand_bits_10(q[:, 0]) << np.uint64(2))
        | (_expand_bits_10(q[:, 1]) << np.uint64(1))
        | _expand_bits_10(q[:, 2])
    )


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint64 (exact, via 32-bit halves + float64 log2)."""
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def clz32(v):
        out = np.full(v.shape, 32, np.int32)
        nz = v != 0
        out[nz] = 31 - np.floor(np.log2(v[nz].astype(np.float64))).astype(np.int32)
        return out

    hz = clz32(hi)
    return np.where(hi != 0, hz, 32 + clz32(lo)).astype(np.int32)


def _build_radix_tree(keys: np.ndarray):
    """Karras radix tree over sorted unique 64-bit keys.

    Returns (left, right, is_leaf_left, is_leaf_right) for n-1 internal nodes:
    child values index leaves when the flag is set, else internal nodes.
    """
    n = keys.shape[0]
    if n == 1:
        return (np.zeros(0, np.int64),) * 4

    def delta(i, j):
        """Common-prefix length of keys[i], keys[j]; -1 out of range. Vectorized."""
        ok = (j >= 0) & (j < n)
        jj = np.clip(j, 0, n - 1)
        x = keys[i] ^ keys[jj]
        d = _clz64(x)
        return np.where(ok, d, -1)

    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    dmin = delta(i, i - d)

    # upper bound on range length by doubling
    lmax = np.full(n - 1, 2, np.int64)
    for _ in range(64):
        probe = delta(i, i + lmax * d) > dmin
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)

    # binary search exact length l
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while t.max() > 0:
        cond = (t > 0) & (delta(i, i + (l + t) * d) > dmin)
        l = np.where(cond, l + t, l)
        t //= 2
    j = i + l * d
    dnode = delta(i, j)

    # binary search split position
    s = np.zeros(n - 1, np.int64)
    t = (l + 1) // 2
    div = 2
    while True:
        cond = (t > 0) & (delta(i, i + (s + t) * d) > dnode)
        s = np.where(cond, s + t, s)
        if (t <= 1).all():
            break
        div *= 2
        t = (l + div - 1) // div
    gamma = i + s * d + np.minimum(d, 0)

    left = gamma
    right = gamma + 1
    leaf_left = np.minimum(i, j) == gamma
    leaf_right = np.maximum(i, j) == gamma + 1
    return left, right, leaf_left, leaf_right


def build_blas_forest(vtx_pos: np.ndarray, tri_idx: np.ndarray, prim_first_tri: np.ndarray, prim_tri_count: np.ndarray):
    """Build one LBVH per primitive; concatenate into global node arrays.

    Node ids are global; leaf `tri` values are GLOBAL triangle indices.
    Returns (lo, hi, left, right, tri, parent, prim_root).
    """
    v0 = vtx_pos[tri_idx[:, 0]]
    v1 = vtx_pos[tri_idx[:, 1]]
    v2 = vtx_pos[tri_idx[:, 2]]
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    cen = (tlo + thi) * 0.5

    all_lo, all_hi, all_left, all_right, all_tri, all_parent, roots = [], [], [], [], [], [], []
    node_base = 0
    for p in range(prim_first_tri.shape[0]):
        f, c = int(prim_first_tri[p]), int(prim_tri_count[p])
        ids = np.arange(f, f + c, dtype=np.int64)
        lo_p, hi_p, left, right, tri, parent = _build_single(
            tlo[ids], thi[ids], cen[ids], ids
        )
        all_lo.append(lo_p)
        all_hi.append(hi_p)
        all_left.append(np.where(left >= 0, left + node_base, left))
        all_right.append(np.where(right >= 0, right + node_base, right))
        all_tri.append(tri)
        all_parent.append(np.where(parent >= 0, parent + node_base, parent))
        roots.append(node_base)
        node_base += lo_p.shape[0]

    return (
        np.concatenate(all_lo).astype(np.float32),
        np.concatenate(all_hi).astype(np.float32),
        np.concatenate(all_left).astype(np.int32),
        np.concatenate(all_right).astype(np.int32),
        np.concatenate(all_tri).astype(np.int32),
        np.concatenate(all_parent).astype(np.int32),
        np.asarray(roots, np.int32),
    )


def _build_single(tlo, thi, cen, global_ids):
    """LBVH for one set of leaf AABBs. Layout: internal nodes [0, n-2],
    leaves [n-1, 2n-2] (leaf k -> node n-1+k). Root = node 0 (n>1)."""
    n = tlo.shape[0]
    if n == 1:
        lo = tlo.astype(np.float32)
        hi = thi.astype(np.float32)
        return lo, hi, np.array([-1], np.int64), np.array([-1], np.int64), np.array([global_ids[0]], np.int64), np.array([-1], np.int64)

    scene_lo = tlo.min(axis=0)
    scene_hi = thi.max(axis=0)
    codes = morton3d(cen, scene_lo, scene_hi)
    # unique keys: (morton << 32) | rank  — guarantees strict ordering
    order = np.argsort(codes, kind="stable")
    keys = (codes[order].astype(np.uint64) << np.uint64(32)) | np.arange(n, dtype=np.uint64)

    lc, rc, leaf_l, leaf_r = _build_radix_tree(keys)

    num_nodes = 2 * n - 1
    left = np.full(num_nodes, -1, np.int64)
    right = np.full(num_nodes, -1, np.int64)
    tri = np.full(num_nodes, -1, np.int64)
    parent = np.full(num_nodes, -1, np.int64)

    leaf_base = n - 1
    left[: n - 1] = np.where(leaf_l, leaf_base + lc, lc)
    right[: n - 1] = np.where(leaf_r, leaf_base + rc, rc)
    tri[leaf_base:] = global_ids[order]
    parent[left[: n - 1]] = np.arange(n - 1)
    parent[right[: n - 1]] = np.arange(n - 1)

    lo = np.zeros((num_nodes, 3), np.float32)
    hi = np.zeros((num_nodes, 3), np.float32)
    lo[leaf_base:] = tlo[order]
    hi[leaf_base:] = thi[order]
    _refit_internal(lo, hi, left, right, leaf_base)
    return lo, hi, left, right, tri, parent


def _refit_internal(lo, hi, left, right, leaf_base):
    """Bottom-up AABB passes: each sweep resolves nodes whose children are
    both ready (vectorized; #passes == tree depth)."""
    num_internal = leaf_base
    ready = np.zeros(lo.shape[0], bool)
    ready[leaf_base:] = True
    ids = np.arange(num_internal)
    pending = ~ready[:num_internal]
    while pending.any():
        can = pending & ready[left[:num_internal]] & ready[right[:num_internal]]
        if not can.any():
            raise RuntimeError("BVH refit deadlock (malformed tree)")
        sel = ids[can]
        lo[sel] = np.minimum(lo[left[sel]], lo[right[sel]])
        hi[sel] = np.maximum(hi[left[sel]], hi[right[sel]])
        ready[sel] = True
        pending[sel] = False


def build_tlas(blas_lo, blas_hi, prim_root, rn_o2w, rn_prim, rn_visible):
    """TLAS over instance world AABBs (reference
    cmdCreateBuildTopLevelAccelerationStructure gltf_scene_rtx.cpp:299).

    Invisible instances get degenerate far-away AABBs so rays can't hit them
    (the blasAddress=0 analog); leaves still exist so visibility toggles only
    need a TLAS refresh, not a rebuild.
    """
    n = rn_o2w.shape[0]
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)
    for i in range(n):
        root = prim_root[rn_prim[i]]
        blo, bhi = blas_lo[root], blas_hi[root]
        corners = np.array(
            [[blo[0] if (k >> 0) & 1 == 0 else bhi[0],
              blo[1] if (k >> 1) & 1 == 0 else bhi[1],
              blo[2] if (k >> 2) & 1 == 0 else bhi[2]] for k in range(8)],
            np.float64,
        )
        m = rn_o2w[i].astype(np.float64)
        wc = corners @ m[:3, :3].T + m[:3, 3]
        if rn_visible[i]:
            lo[i], hi[i] = wc.min(axis=0), wc.max(axis=0)
        else:
            lo[i] = hi[i] = np.float32(3.0e37)

    cen = (lo + hi) * 0.5
    ids = np.arange(n, dtype=np.int64)
    t_lo, t_hi, left, right, inst, _parent = _build_single(lo, hi, cen, ids)
    return t_lo, t_hi, left.astype(np.int32), right.astype(np.int32), inst.astype(np.int32), 0


def build_scene_bvh(flat) -> SceneBvh:
    """SceneFlat -> two-level BVH (reference buildAccelerationStructures
    renderer.cpp:1682)."""
    lo, hi, left, right, tri, parent, prim_root = build_blas_forest(
        np.asarray(flat.vtx_pos), np.asarray(flat.tri_idx), np.asarray(flat.prim_first_tri), np.asarray(flat.prim_tri_count)
    )
    tl_lo, tl_hi, tl_left, tl_right, tl_inst, tl_root = build_tlas(
        lo, hi, prim_root, np.asarray(flat.rn_o2w), np.asarray(flat.rn_prim), np.asarray(flat.rn_visible)
    )
    return SceneBvh(
        lo=lo, hi=hi, left=left, right=right, tri=tri, parent=parent, prim_root=prim_root,
        tl_lo=tl_lo, tl_hi=tl_hi, tl_left=tl_left, tl_right=tl_right, tl_inst=tl_inst, tl_root=tl_root,
    )
