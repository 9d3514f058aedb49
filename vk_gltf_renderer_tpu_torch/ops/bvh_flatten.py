"""World-space BVH tables for the traversal kernels (numpy host builder).

jax-free copy of the default path of vk_gltf_renderer_tpu/ops/bvh_flatten.py
build_world_bvh: instances baked into world triangles, binned SAH over them
(the native C++ builder of the port's native/, with the numpy oracle as
fallback), collapsed to BVH4, and emitted as the two tables the
default kernel reads:

  nodes4_fi [M,32] f32  4 child AABBs (cols 0:24, lo3 hi3 each), 4 child
                        codes (24:28: >= 0 BVH4 node id, < 0 leaf code
                        -(leafrow*16+count)-1, missing child 0 with the
                        always-miss point box lo=hi=+3e38) and 3 near-order
                        split axes (28:31)
  tris128   [L,128] f32 one row per leaf: 8 triangles x 16 floats
                        (v0 v1 v2, pad, render node id at col 9, global
                        tri id at col 10; padding slots are zero triangles
                        with ids -1)

plus the fused hit-state rows (ops/hitstate.bake_hit_attrs_np), the
binary tree they come from (nodes_i, nodes_f, nodes_self, tris, wtri_*)
and the split BVH4 tables (nodes4_i, nodes4_f), under the reference's
field names. The split tables and the binary tree are what the packet4
kernel, the v1 kernel and the wavefront walk read (split_stack_need gives
the two split walks' stacks). The tables of the other traversal kernels
are built from the tree only when a selected kernel reads them
(add_kernel_tables): they cost Python-loop seconds on a 1M-triangle scene.

  nodes_fi   [Nn,16] f32  binary rows (reference _packet2_tables): both
                          child boxes (0:12), child codes (12:14), the
                          split axis (14); root_code is the root's code
  nodes16_fi [M,128] f32  dense BVH16 rows (reference _packet6_tables):
                          16 child boxes (0:96), 16 codes (96:112), the 15
                          axes of the collapsed binary subtree (112:127)
  lane_pages [P*16,128] f32 skip-pointer DFS pages (ops/lane_traverse.py)
  nodes4_sc  [M,8] i32    the v7 sidecar of nodes4_fi (reference
                          _packet3_sidecar): the 4 child codes and 3 split
                          axes of every BVH4 row as int32

Every table carries the refit maps of the reference's WorldBvh, which
ops/animation.refit_world_bvh reads to refit the boxes on the device after
a transform, skin or morph edit: refit_levels (internal binary nodes,
deepest level first), map4 (the binary node of each BVH4 child slot),
tri8_src (the tris row of each tris128 slot), map16 (each BVH16 slot,
built with nodes16_fi) and lane_geo_idx (the geometry source of each
lane-page element, built with lane_pages), plus the emit-order rows the
hit-row bake reads (attr_rnode, attr_tri, attr_has_uv, attr_bary) and the
bake source of every tris row (wtri_src_tri, wtri_bary: the parent
triangle and the cell's barycentric corners of a virtual subtriangle row,
else the row's own triangle and identity barycentrics).

Alpha-tested scenes pass the opacity classes of ops/omm.py: transparent
triangles are culled and MIXED triangles with transparent cells are split
into their other cells (build_world_bvh's docstring).

VKGR_BVH picks the builder as in the reference: sah (default), lbvh,
the Morton radix tree of ops/bvh.py, which is also the fallback for
scenes over 300,000 triangles when the native builder is missing, or
sbvh, the spatial-split builder (_build_sbvh, Stich et al. 2009) for
scenes of at most 300,000 triangles and the native SAH above that, as in
the reference. SBVH duplicates triangle references: its tris rows (and
so tris128 slots, lane-page elements and wtri_*) repeat a triangle where
a split plane cut it, each copy holding the whole triangle, and
num_world_tris still counts triangles. WorldBvh.builder names the
builder that ran; emit2ref maps each hit row back to its tris row (the
primary-hit seeding of ops/pathtrace.py reads it).
tests/test_torch_host.py holds every field equal to the reference's.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from .bvh import _build_radix_tree, morton3d
from .hitstate import bake_hit_attrs_np, narrow_attr_ok
from .omm import ALPHA_MIXED, ALPHA_TRANSPARENT, subtri_corners

LEAF_SIZE = 8
_SAH_BINS = 16
_SAH_NUMPY_MAX_TRIS = 300_000  # the numpy oracle is a Python loop
_B4_EMPTY_LO = 3e38
_B4_EMPTY_HI = -3e38
# barycentric corners (u0 v0 u1 v1 u2 v2) of a row baked from its whole triangle
IDENT_BARY = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 1.0], np.float32)


@dataclass
class WorldBvh:
    nodes_i: np.ndarray  # [Nn,8] i32 binary tree: left, right, first, count, parent, axis
    nodes_f: np.ndarray  # [Nn,16] f32 binary nodes' child boxes
    nodes_self: np.ndarray  # [Nn,8] f32 binary nodes' own AABBs (row 0 = scene bounds)
    tris: np.ndarray  # [T+8,16] f32 world triangles in BVH order (v0 v1 v2, pad)
    wtri_rnode: np.ndarray  # [T+8] i32 render node per tris row
    wtri_tri: np.ndarray  # [T+8] i32 global tri id per tris row
    nodes4_fi: np.ndarray  # [M,32] f32 fused BVH4 rows
    tris128: np.ndarray  # [L,128] f32 leaf-aligned triangle blocks
    # the split BVH4 tables of the packet4 traversal (build_bvh4)
    nodes4_i: np.ndarray  # [M,8] i32 c0..c3 (leaf -(first*16+count)-1 into tris,
    #                       missing -1), axis0..2, pad
    nodes4_f: np.ndarray  # [M,32] f32 4 child AABBs (missing: inverted lo=+3e38, hi=-3e38)
    # fused hit-state rows: row = rn_attr_base[rnode] + tri
    hit_attr: np.ndarray  # [Ta,64] (or [Ta,32] narrow) f32
    rn_attr_base: np.ndarray  # [N] i32
    attr_alpha_class: np.ndarray  # [Ta] i8 ops/omm classes (all 1 = MIXED: unclassified)
    # refit maps (ops/animation.refit_world_bvh) and the hit-row bake's rows
    refit_levels: np.ndarray  # [L,K] i32 internal binary nodes, deepest level first (-1 pad)
    portal_roots: np.ndarray  # [P] i32 nodes of the treelet cut (their ids in nodes_i[:,6])
    map4: np.ndarray  # [M,4] i32 binary node of each BVH4 child slot (-1 missing)
    wtri8_rnode: np.ndarray  # [L*8] i32 render node of each tris128 slot (-1 pad)
    wtri8_tri: np.ndarray  # [L*8] i32 global tri of each tris128 slot (-1 pad)
    tri8_src: np.ndarray  # [L*8] i32 tris row of each tris128 slot (-1 pad)
    attr_rnode: np.ndarray  # [Ta] i32 emit-order render node
    attr_tri: np.ndarray  # [Ta] i32 emit-order bake source tri id
    attr_has_uv: np.ndarray  # [Ta] i32 texel-density gate
    attr_bary: np.ndarray  # [Ta,6] f32 corner barycentrics of each hit row in its source triangle
    wtri_src_tri: np.ndarray  # [T+8] i32 bake source tri of each tris row
    wtri_bary: np.ndarray  # [T+8,6] f32 corner barycentrics of each tris row in its source triangle
    emit2ref: np.ndarray  # [max(Ta,1)] i32 tris row of each hit row (-1: culled); _emit2ref
    num_world_tris: int  # world triangles; the tris rows number more under SBVH (duplicated references)
    builder: str = "sah"  # the builder that ran: sah, sah_numpy, sbvh, lbvh or single (one triangle)
    root4_code: int = 0
    # built on demand by add_kernel_tables (None until a kernel reads them)
    nodes_fi: np.ndarray | None = None  # [Nn,16] f32 binary rows
    root_code: int = 0  # code of the binary root (< 0 when it is a leaf)
    nodes16_fi: np.ndarray | None = None  # [M,128] f32 BVH16 rows
    map16: np.ndarray | None = None  # [M,16] i32 binary node of each BVH16 slot (-1 missing)
    lane_pages: np.ndarray | None = None  # [P*16,128] f32 skip-pointer pages
    lane_geo_idx: np.ndarray | None = None  # [P*16,128] i32 geometry source of each page element
    nodes4_sc: np.ndarray | None = None  # [M,8] i32 BVH4 codes + axes (v7)


def _build_sah(tlo, thi, cen):
    """Top-down binned SAH build, 16 bins per axis (reference
    ops/bvh_flatten.py:264). Returns (order, nodes_i, nodes_f, nodes_self):
    leaves of <= LEAF_SIZE tris over the reordered triangle array, left
    child = smaller centroid on nodes_i[:,5], parents in nodes_i[:,4]."""
    nt = tlo.shape[0]
    perm = np.arange(nt, dtype=np.int64)
    t_left, t_right, t_first, t_count, t_axis = [], [], [], [], []
    t_lo, t_hi = [], []

    def new_node():
        t_left.append(-1)
        t_right.append(-1)
        t_first.append(-1)
        t_count.append(0)
        t_axis.append(0)
        t_lo.append(None)
        t_hi.append(None)
        return len(t_left) - 1

    root = new_node()
    stack = [(root, 0, nt)]
    while stack:
        nid, s, e = stack.pop()
        ids = perm[s:e]
        n = e - s
        t_lo[nid] = tlo[ids].min(axis=0)
        t_hi[nid] = thi[ids].max(axis=0)
        if n <= LEAF_SIZE:
            t_first[nid] = s
            t_count[nid] = n
            continue
        c = cen[ids]
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        ext = chi - clo
        best_cost = np.inf
        best_axis = -1
        best_split = -1
        best_bins = None
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            b = np.minimum(
                ((c[:, axis] - clo[axis]) * (_SAH_BINS / ext[axis])).astype(np.int64),
                _SAH_BINS - 1,
            )
            cnt = np.bincount(b, minlength=_SAH_BINS)
            blo = np.full((_SAH_BINS, 3), np.inf)
            bhi = np.full((_SAH_BINS, 3), -np.inf)
            np.minimum.at(blo, b, tlo[ids])
            np.maximum.at(bhi, b, thi[ids])
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)

            def area(alo, ahi):
                d = np.maximum(ahi - alo, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            # split after bin k: left = bins [0,k], right = [k+1, NB)
            la = area(llo[:-1], lhi[:-1])
            ra = area(rlo[1:], rhi[1:])
            lc = lcnt[:-1]
            rc = n - lc
            cost = la * lc + ra * rc
            cost[(lc == 0) | (rc == 0)] = np.inf
            k = int(np.argmin(cost))
            if cost[k] < best_cost:
                best_cost = cost[k]
                best_axis = axis
                best_split = k
                best_bins = b
        if best_axis < 0:
            mid = s + n // 2  # all centroids equal: median split
        else:
            mask = best_bins <= best_split
            mid = s + int(mask.sum())
            perm[s:e] = np.concatenate([ids[mask], ids[~mask]])
            t_axis[nid] = best_axis
        if mid == s or mid == e:  # SAH refused; force median
            mid = s + n // 2
        l_id = new_node()
        r_id = new_node()
        t_left[nid] = l_id
        t_right[nid] = r_id
        stack.append((r_id, mid, e))
        stack.append((l_id, s, mid))

    nn = len(t_left)
    nodes_i = np.zeros((nn, 8), np.int32)
    nodes_f = np.zeros((nn, 16), np.float32)
    nodes_self = np.zeros((nn, 8), np.float32)
    parent = np.full(nn, -1, np.int32)
    for nid in range(nn):
        nodes_self[nid, 0:3] = t_lo[nid]
        nodes_self[nid, 3:6] = t_hi[nid]
        if t_count[nid] > 0:
            nodes_i[nid, 2] = t_first[nid]
            nodes_i[nid, 3] = t_count[nid]
            continue
        l_id, r_id, axis = t_left[nid], t_right[nid], t_axis[nid]
        cl = (t_lo[l_id][axis] + t_hi[l_id][axis]) * 0.5
        cr = (t_lo[r_id][axis] + t_hi[r_id][axis]) * 0.5
        if cr < cl:
            l_id, r_id = r_id, l_id
        nodes_i[nid, 0] = l_id
        nodes_i[nid, 1] = r_id
        nodes_i[nid, 5] = axis
        nodes_f[nid, 0:3] = t_lo[l_id]
        nodes_f[nid, 3:6] = t_hi[l_id]
        nodes_f[nid, 6:9] = t_lo[r_id]
        nodes_f[nid, 9:12] = t_hi[r_id]
        parent[l_id] = nid
        parent[r_id] = nid
    nodes_i[:, 4] = parent
    return perm, nodes_i, nodes_f, nodes_self


def _clip_tri_slab(tri, axis, lo, hi):
    """AABB of a triangle clipped to the slab lo <= x[axis] <= hi
    (Sutherland-Hodgman against the two planes). tri: [3,3] float64."""
    poly = [tri[0], tri[1], tri[2]]
    for plane_v, keep_ge in ((lo, True), (hi, False)):
        out = []
        for i in range(len(poly)):
            a = poly[i]
            b = poly[(i + 1) % len(poly)]
            da = a[axis] - plane_v
            db = b[axis] - plane_v
            ina = da >= 0 if keep_ge else da <= 0
            inb = db >= 0 if keep_ge else db <= 0
            if ina:
                out.append(a)
            if ina != inb:
                t = da / (da - db)
                out.append(a + (b - a) * t)
        poly = out
        if not poly:
            return None
    p = np.asarray(poly)
    return p.min(axis=0), p.max(axis=0)


def _build_sbvh(tlo, thi, cen, wv, alpha=1e-5, ref_budget=0.5):
    """Top-down SBVH (Stich et al. 2009): binned object SAH + spatial
    splits with triangle-clipped reference duplication.

    When the best object split's child boxes overlap by more than
    alpha * root_area, a spatial-split candidate is also evaluated: 16
    uniform bins along each axis, each reference entering every bin its
    clipped box straddles; straddling references are DUPLICATED into both
    children with their boxes re-clipped to the winning plane. Total
    duplicates are capped at ref_budget * num_tris, after which only
    object splits are taken. Same output contract as _build_sah except
    `order` is a REFERENCE -> triangle map that may repeat triangle ids
    (downstream tables simply carry duplicated tris128 rows; hits on
    either copy resolve to the same (rnode, tri)).

    The reference builds its BLAS inside the Vulkan driver
    (gltf_scene_rtx.cpp:173) where spatial splits are the vendor's call;
    here the build policy is in-repo. Gated to static scenes: refit
    conservatively re-expands clipped boxes (correct, just looser).
    """
    nt = tlo.shape[0]
    wv3 = np.asarray(wv, np.float64)[:, :9].reshape(nt, 3, 3)
    max_refs = nt + int(ref_budget * nt)
    # reference arrays (grow as refs split)
    rlo = [tlo[i].astype(np.float64) for i in range(nt)]
    rhi = [thi[i].astype(np.float64) for i in range(nt)]
    rtri = list(range(nt))

    root_d = thi.max(axis=0) - tlo.min(axis=0)
    root_area = float(root_d[0] * root_d[1] + root_d[1] * root_d[2] + root_d[2] * root_d[0])
    if root_area <= 0:
        return _build_sah(tlo, thi, cen)

    t_left, t_right, t_first, t_count, t_axis = [], [], [], [], []
    t_lo, t_hi = [], []

    def new_node():
        t_left.append(-1)
        t_right.append(-1)
        t_first.append(-1)
        t_count.append(0)
        t_axis.append(0)
        t_lo.append(None)
        t_hi.append(None)
        return len(t_left) - 1

    def area3(d):
        d = np.maximum(d, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    # node work items carry explicit ref-id lists (duplication makes the
    # in-place permutation of _build_sah unusable)
    root = new_node()
    stack = [(root, list(range(nt)))]
    leaves = []  # (nid, ref ids) — order assembled at the end

    while stack:
        nid, ids = stack.pop()
        n = len(ids)
        nlo = np.min([rlo[i] for i in ids], axis=0)
        nhi = np.max([rhi[i] for i in ids], axis=0)
        t_lo[nid] = nlo
        t_hi[nid] = nhi
        if n <= LEAF_SIZE:
            t_first[nid] = -2  # filled in the order pass
            t_count[nid] = n
            leaves.append((nid, ids))
            continue
        blo_r = np.asarray([rlo[i] for i in ids])
        bhi_r = np.asarray([rhi[i] for i in ids])
        c = (blo_r + bhi_r) * 0.5

        # ---- object split (binned SAH over reference boxes)
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        ext = chi - clo
        best = dict(cost=np.inf, axis=-1, kind="obj")
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            b = np.minimum(((c[:, axis] - clo[axis]) * (_SAH_BINS / ext[axis])).astype(np.int64),
                           _SAH_BINS - 1)
            cnt = np.bincount(b, minlength=_SAH_BINS)
            blo = np.full((_SAH_BINS, 3), np.inf)
            bhi = np.full((_SAH_BINS, 3), -np.inf)
            np.minimum.at(blo, b, blo_r)
            np.maximum.at(bhi, b, bhi_r)
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo_s = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi_s = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)

            def areas(alo, ahi):
                d = np.maximum(ahi - alo, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            la = areas(llo[:-1], lhi[:-1])
            ra = areas(rlo_s[1:], rhi_s[1:])
            lc = lcnt[:-1]
            rc = n - lc
            cost = la * lc + ra * rc
            cost[(lc == 0) | (rc == 0)] = np.inf
            k = int(np.argmin(cost))
            if cost[k] < best["cost"]:
                ov_lo = np.maximum(llo[k], rlo_s[k + 1])
                ov_hi = np.minimum(lhi[k], rhi_s[k + 1])
                best = dict(cost=float(cost[k]), axis=axis, kind="obj",
                            mask=b <= k, overlap=area3(ov_hi - ov_lo))

        # ---- spatial split candidate (only when object children overlap)
        if (best["axis"] >= 0 and best.get("overlap", 0.0) > alpha * root_area
                and len(rtri) < max_refs):
            for axis in range(3):
                w = nhi[axis] - nlo[axis]
                if w <= 1e-12:
                    continue
                inv_w = _SAH_BINS / w
                b0 = np.clip(((blo_r[:, axis] - nlo[axis]) * inv_w).astype(np.int64),
                             0, _SAH_BINS - 1)
                b1 = np.clip(((bhi_r[:, axis] - nlo[axis]) * inv_w).astype(np.int64),
                             0, _SAH_BINS - 1)
                enter = np.bincount(b0, minlength=_SAH_BINS)
                exit_ = np.bincount(b1, minlength=_SAH_BINS)
                # per-bin boxes from clipped fragments (AABB-clip estimate
                # for costing; the actual split re-clips the triangle)
                blo = np.full((_SAH_BINS, 3), np.inf)
                bhi = np.full((_SAH_BINS, 3), -np.inf)
                for j in range(n):
                    lo_j, hi_j = blo_r[j].copy(), bhi_r[j].copy()
                    for bb in range(int(b0[j]), int(b1[j]) + 1):
                        s0 = nlo[axis] + bb * w / _SAH_BINS
                        s1 = s0 + w / _SAH_BINS
                        fl = lo_j.copy()
                        fh = hi_j.copy()
                        fl[axis] = max(fl[axis], s0)
                        fh[axis] = min(fh[axis], s1)
                        blo[bb] = np.minimum(blo[bb], fl)
                        bhi[bb] = np.maximum(bhi[bb], fh)
                llo = np.minimum.accumulate(blo, axis=0)
                lhi = np.maximum.accumulate(bhi, axis=0)
                rlo_s = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
                rhi_s = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
                lc = np.cumsum(enter)[:-1]
                rc = n - np.cumsum(exit_)[:-1]

                def areas(alo, ahi):
                    d = np.maximum(ahi - alo, 0.0)
                    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

                la = areas(llo[:-1], lhi[:-1])
                ra = areas(rlo_s[1:], rhi_s[1:])
                cost = la * lc + ra * rc
                bad = (lc == 0) | (rc == 0)
                cost[bad] = np.inf
                k = int(np.argmin(cost))
                if cost[k] < best["cost"]:
                    best = dict(cost=float(cost[k]), axis=axis, kind="spatial",
                                plane=float(nlo[axis] + (k + 1) * w / _SAH_BINS))

        if best["axis"] < 0:
            mid = n // 2
            lids, rids = ids[:mid], ids[mid:]
        elif best["kind"] == "obj":
            mask = best["mask"]
            lids = [ids[j] for j in range(n) if mask[j]]
            rids = [ids[j] for j in range(n) if not mask[j]]
            t_axis[nid] = best["axis"]
        else:
            axis, plane = best["axis"], best["plane"]
            lids, rids = [], []
            for j in range(n):
                rid = ids[j]
                if rhi[rid][axis] <= plane:
                    lids.append(rid)
                elif rlo[rid][axis] >= plane:
                    rids.append(rid)
                else:
                    tri = wv3[rtri[rid]]
                    cl = _clip_tri_slab(tri, axis, rlo[rid][axis], plane)
                    cr = _clip_tri_slab(tri, axis, plane, rhi[rid][axis])
                    if cl is None or cr is None or len(rtri) >= max_refs:
                        # degenerate clip or budget exhausted: assign whole
                        (lids if (rlo[rid][axis] + rhi[rid][axis]) * 0.5 <= plane
                         else rids).append(rid)
                        continue
                    # left fragment reuses the ref id; right gets a new one
                    rlo[rid] = np.maximum(cl[0], rlo[rid])
                    rhi[rid] = np.minimum(cl[1], rhi[rid])
                    lids.append(rid)
                    rlo.append(np.maximum(cr[0], np.asarray(tlo[rtri[rid]], np.float64)))
                    rhi.append(np.minimum(cr[1], np.asarray(thi[rtri[rid]], np.float64)))
                    rtri.append(rtri[rid])
                    rids.append(len(rtri) - 1)
            t_axis[nid] = axis
            if not lids or not rids:  # numerical corner: fall back
                mid = n // 2
                lids, rids = ids[:mid], ids[mid:]
        l_id = new_node()
        r_id = new_node()
        t_left[nid] = l_id
        t_right[nid] = r_id
        stack.append((r_id, rids))
        stack.append((l_id, lids))

    # assemble reference order from leaves (leaf tris must be contiguous)
    order = np.empty(sum(len(ids) for _, ids in leaves), np.int64)
    pos = 0
    for nid, ids in leaves:
        t_first[nid] = pos
        order[pos : pos + len(ids)] = [rtri[i] for i in ids]
        pos += len(ids)

    nn = len(t_left)
    nodes_i = np.zeros((nn, 8), np.int32)
    nodes_f = np.zeros((nn, 16), np.float32)
    nodes_self = np.zeros((nn, 8), np.float32)
    parent = np.full(nn, -1, np.int32)
    for nid in range(nn):
        nodes_self[nid, 0:3] = t_lo[nid]
        nodes_self[nid, 3:6] = t_hi[nid]
        if t_count[nid] > 0:
            nodes_i[nid, 2] = t_first[nid]
            nodes_i[nid, 3] = t_count[nid]
            continue
        l_id, r_id, axis = t_left[nid], t_right[nid], t_axis[nid]
        cl = (t_lo[l_id][axis] + t_hi[l_id][axis]) * 0.5
        cr = (t_lo[r_id][axis] + t_hi[r_id][axis]) * 0.5
        if cr < cl:
            l_id, r_id = r_id, l_id
        nodes_i[nid, 0] = l_id
        nodes_i[nid, 1] = r_id
        nodes_i[nid, 5] = axis
        nodes_f[nid, 0:3] = t_lo[l_id]
        nodes_f[nid, 3:6] = t_hi[l_id]
        nodes_f[nid, 6:9] = t_lo[r_id]
        nodes_f[nid, 9:12] = t_hi[r_id]
        parent[l_id] = nid
        parent[r_id] = nid
    nodes_i[:, 4] = parent
    return order, nodes_i, nodes_f, nodes_self


def _emit2ref(rn_attr_base, wtri_rnode, wtri_tri, n_attr, nrefs):
    """emit-row -> reordered ref table (see WorldBvh.emit2ref)."""
    e2r = np.full(max(int(n_attr), 1), -1, np.int32)
    if nrefs > 0:
        rows = (np.asarray(rn_attr_base)[wtri_rnode[:nrefs]]
                + np.asarray(wtri_tri[:nrefs], np.int64))
        e2r[rows] = np.arange(nrefs, dtype=np.int32)
    return e2r


def _levels_and_portals(nodes_i):
    """BFS depths -> (refit_levels, portal_roots) (reference
    ops/bvh_flatten.py:216). Writes each portal's id into nodes_i[:, 6]
    (-1 elsewhere): the treelet cut, nodes at depth K or shallower leaves,
    K aiming at ~256 portals. refit_levels [L,K] lists the internal nodes
    level by level, deepest first, padded with -1."""
    nn = nodes_i.shape[0]
    depth = np.full(nn, -1, np.int64)
    depth[0] = 0
    bfs = [0]
    for nd in bfs:
        if nodes_i[nd, 3] == 0:  # internal
            for c in (nodes_i[nd, 0], nodes_i[nd, 1]):
                depth[c] = depth[nd] + 1
                bfs.append(int(c))

    target = 256
    K = max(1, int(np.ceil(np.log2(min(target, max(nn // 8, 2))))))
    portal_list = []
    for nd in bfs:
        d = depth[nd]
        if d == K or (d < K and nodes_i[nd, 3] > 0):
            portal_list.append(nd)
    nodes_i[:, 6] = -1
    for pid, nd in enumerate(portal_list):
        nodes_i[nd, 6] = pid
    portal_roots = np.asarray(portal_list, np.int32)

    internal_ids = np.nonzero(nodes_i[:, 3] == 0)[0]
    levels = []
    if internal_ids.size:
        for d in range(int(depth[internal_ids].max()), -1, -1):
            lv = internal_ids[depth[internal_ids] == d]
            if lv.size:
                levels.append(lv)
    if not levels:
        return np.full((1, 1), -1, np.int32), portal_roots
    kmax = max(len(lv) for lv in levels)
    refit_levels = np.full((len(levels), kmax), -1, np.int32)
    for idx, lv in enumerate(levels):
        refit_levels[idx, : len(lv)] = lv
    return refit_levels, portal_roots


def _tris128(nodes_i, tris16, wtri_rnode, wtri_tri):
    """Leaf-aligned triangle blocks (the tris128 half of the reference's
    _packet2_tables, ops/bvh_flatten.py:48): one [128] row per binary leaf,
    in leaf-id order, 8 slots of 16 floats with the ids at cols 9/10.
    Returns (tris128, wtri8_rnode, wtri8_tri, tri8_src): the last three
    give each of the L*8 slots its render node, global tri and tris row
    (-1 on padding); the refit regathers the blocks through tri8_src."""
    count = nodes_i[:, 3].astype(np.int64)
    first = nodes_i[:, 2].astype(np.int64)
    leaf_ids = np.nonzero(count > 0)[0]
    n_leaves = max(leaf_ids.size, 1)
    if leaf_ids.size >= 1 << 20:
        raise ValueError("leaf codes cap at 2^20 leaves (exact in f32)")
    tris128 = np.zeros((n_leaves, 8, 16), np.float32)
    tris128[:, :, 9:11] = -1.0
    w8r = np.full(n_leaves * 8, -1, np.int32)
    w8t = np.full(n_leaves * 8, -1, np.int32)
    t8s = np.full(n_leaves * 8, -1, np.int32)
    if leaf_ids.size:
        c = count[leaf_ids]
        reps = np.repeat(np.arange(leaf_ids.size), c)
        k = np.arange(reps.size) - np.repeat(np.cumsum(c) - c, c)
        rows = first[leaf_ids][reps] + k
        tris128[reps, k] = tris16[rows]
        tris128[reps, k, 9] = wtri_rnode[rows].astype(np.float32)
        tris128[reps, k, 10] = wtri_tri[rows].astype(np.float32)
        slot = reps * 8 + k
        w8r[slot] = wtri_rnode[rows]
        w8t[slot] = wtri_tri[rows]
        t8s[slot] = rows
    return tris128.reshape(n_leaves, 128), w8r, w8t, t8s


def _leaf_code(first, count):
    return -(int(first) * 16 + int(count)) - 1


def build_bvh4(nodes_i, nodes_self):
    """Collapse the binary tree into BVH4 (reference ops/bvh_flatten.py:1270).
    Returns (nodes4_i [M,8] i32: 4 child slots + 3 axes, nodes4_f [M,32]
    f32: 4 child boxes, missing children carrying inverted boxes, map4
    [M,4] i32: the binary node of each child slot, -1 where missing)."""
    n4_i, n4_f, m4 = [], [], []
    if nodes_i[0, 3] > 0:  # root is a leaf: one BVH4 node with 1 child
        n4_i.append([_leaf_code(nodes_i[0, 2], nodes_i[0, 3]), -1, -1, -1, 0, 0, 0, 0])
        f = np.full(32, 0.0, np.float32)
        f[0:3] = nodes_self[0, 0:3]
        f[3:6] = nodes_self[0, 3:6]
        for s in range(1, 4):
            f[6 * s : 6 * s + 3] = _B4_EMPTY_LO
            f[6 * s + 3 : 6 * s + 6] = _B4_EMPTY_HI
        n4_f.append(f)
        m4.append([0, -1, -1, -1])
        return np.asarray(n4_i, np.int32), np.stack(n4_f).astype(np.float32), np.asarray(m4, np.int32)

    id_of = {0: 0}
    work = deque([0])
    n4_i.append(None)
    n4_f.append(None)
    m4.append(None)
    while work:
        b = work.popleft()
        nid = id_of[b]
        l, r = int(nodes_i[b, 0]), int(nodes_i[b, 1])
        slots = []
        axes = [int(nodes_i[b, 5]), 0, 0]
        for side, c in ((1, l), (2, r)):
            if nodes_i[c, 3] > 0:  # leaf child occupies one slot, pad one
                slots.append(c)
                slots.append(None)
            else:
                axes[side] = int(nodes_i[c, 5])
                slots.append(int(nodes_i[c, 0]))
                slots.append(int(nodes_i[c, 1]))
        row_i = [0, 0, 0, 0, axes[0], axes[1], axes[2], 0]
        row_f = np.empty(32, np.float32)
        row_f[24:] = 0.0
        row_m = [-1, -1, -1, -1]
        for s, c in enumerate(slots):
            if c is None:
                row_i[s] = -1
                row_f[6 * s : 6 * s + 3] = _B4_EMPTY_LO
                row_f[6 * s + 3 : 6 * s + 6] = _B4_EMPTY_HI
                continue
            row_m[s] = c
            row_f[6 * s : 6 * s + 3] = nodes_self[c, 0:3]
            row_f[6 * s + 3 : 6 * s + 6] = nodes_self[c, 3:6]
            if nodes_i[c, 3] > 0:
                row_i[s] = _leaf_code(nodes_i[c, 2], nodes_i[c, 3])
            else:
                if c not in id_of:
                    id_of[c] = len(n4_i)
                    n4_i.append(None)
                    n4_f.append(None)
                    m4.append(None)
                    work.append(c)
                row_i[s] = id_of[c]
        n4_i[nid] = row_i
        n4_f[nid] = row_f
        m4[nid] = row_m
    return np.asarray(n4_i, np.int32), np.stack(n4_f).astype(np.float32), np.asarray(m4, np.int32)


def _nodes4_fi(nodes_i, nodes4_i, nodes4_f):
    """Fused BVH4 rows (reference _packet3_tables, ops/bvh_flatten.py:1208).
    Missing children get code 0 and the point box lo=hi=+3e38: the slab
    test (tnear = max of mins, tfar = min of maxes) would accept an
    inverted box, and traversal would then loop forever."""
    count = nodes_i[:, 3].astype(np.int64)
    leaf_ids = np.nonzero(count > 0)[0]
    # binary leaf 'first' -> tris128 row (leaf-id order, as _tris128)
    first2row = np.full(int(nodes_i[:, 2].max()) + 2, -1, np.int64)
    first2row[nodes_i[leaf_ids, 2].astype(np.int64)] = np.arange(leaf_ids.size)

    n4i = nodes4_i.astype(np.int64)
    fi = nodes4_f.astype(np.float32).copy()
    slots = n4i[:, 0:4]
    is_leafslot = slots < 0
    is_missing = slots == -1
    v1c = np.where(is_leafslot & ~is_missing, -slots - 1, 0)
    vfirst, vcnt = v1c // 16, v1c % 16
    v2c = -(first2row[vfirst] * 16 + vcnt) - 1
    code = np.where(is_missing, 0, np.where(is_leafslot, v2c, slots)).astype(np.float64)
    fi[:, 24:28] = code
    fi[:, 28:31] = n4i[:, 4:7]
    fi[:, 31] = 0.0
    for s in range(4):
        fi[is_missing[:, s], 6 * s : 6 * s + 6] = 3e38
    return fi


def build_world_bvh(flat, tri_class=None, subtri_cells=None, subtri_level=2) -> WorldBvh:
    """Bake instances to world space + a BVH4 over all world triangles
    (reference build_world_bvh): binned SAH by default, the spatial-split
    SBVH under VKGR_BVH=sbvh (at most 300,000 triangles, else the SAH), the
    Morton radix tree (LBVH) under VKGR_BVH=lbvh or when a scene of more
    than 300,000 triangles finds no native builder.

    tri_class: optional [sum of visible-node tri counts] int8 in emit order
    (ops/omm.classify_attr_alpha): rows classed ALPHA_TRANSPARENT are culled
    from the world triangles; the hit rows keep the full emit, so
    rn_attr_base addressing is unchanged, and attr_alpha_class carries the
    classes (all MIXED without tri_class). subtri_cells: optional [same
    rows, 4**subtri_level] int8 per-cell classes (ops/omm.classify_subtri):
    a MIXED triangle with some provably transparent cells is replaced by
    its other cells, emitted as virtual rows with tri ids f+c, f+c+1, ...
    past the primitive's span, each with its own hit row baked at the
    cell's parent-barycentric corners (attr_bary, wtri_bary) from its
    parent (attr_tri, wtri_src_tri). A scene with nothing left gets one
    degenerate far-away triangle."""
    import os

    vtx = np.asarray(flat.vtx_pos, np.float64)
    tri_idx = np.asarray(flat.tri_idx)
    rn_o2w = np.asarray(flat.rn_o2w, np.float64)
    rn_prim = np.asarray(flat.rn_prim)
    rn_visible = np.asarray(flat.rn_visible)
    pft = np.asarray(flat.prim_first_tri)
    ptc = np.asarray(flat.prim_tri_count)
    bvh_kind = os.environ.get("VKGR_BVH", "sah")

    sub_bary_tab = None
    if subtri_cells is not None and tri_class is not None:
        sub_bary_tab = subtri_corners(subtri_level).reshape(-1, 6)  # [m,6]

    v_chunks, rnode_chunks, tri_chunks = [], [], []
    wsrc_chunks, wbary_chunks = [], []
    attr_rnode_chunks, attr_tri_chunks = [], []
    attr_bary_chunks, attr_cls_chunks = [], []
    rn_attr_base = np.zeros(rn_o2w.shape[0], np.int32)
    attr_off = 0
    cls_off = 0  # row offset into tri_class / subtri_cells (the parents' emit order)
    for i in range(rn_o2w.shape[0]):
        if not rn_visible[i]:
            continue
        p = rn_prim[i]
        f, c = int(pft[p]), int(ptc[p])
        ids = np.arange(f, f + c)
        attr_rnode_chunks.append(np.full(c, i, np.int32))
        attr_tri_chunks.append(ids.astype(np.int32))
        attr_bary_chunks.append(np.tile(IDENT_BARY, (c, 1)))
        keep = np.ones(c, bool)
        split = np.zeros(c, bool)
        cells = None
        if tri_class is not None:
            cl = np.asarray(tri_class[cls_off:cls_off + c])
            keep = cl != ALPHA_TRANSPARENT
            attr_cls_chunks.append(cl.astype(np.int8))
            if sub_bary_tab is not None:
                cells = np.asarray(subtri_cells[cls_off:cls_off + c])
                any_trans = (cells == ALPHA_TRANSPARENT).any(axis=1)
                all_trans = (cells == ALPHA_TRANSPARENT).all(axis=1)
                split = (cl == ALPHA_MIXED) & any_trans & ~all_trans
                # finer cell bounds can prove a whole MIXED triangle transparent
                keep &= ~(split | ((cl == ALPHA_MIXED) & all_trans))
        else:
            attr_cls_chunks.append(np.ones(c, np.int8))  # unclassified: MIXED
        kept_ids = ids[keep]
        idx = tri_idx[kept_ids]
        m = rn_o2w[i]
        w0 = vtx[idx[:, 0]] @ m[:3, :3].T + m[:3, 3]
        w1 = vtx[idx[:, 1]] @ m[:3, :3].T + m[:3, 3]
        w2 = vtx[idx[:, 2]] @ m[:3, :3].T + m[:3, 3]
        v_chunks.append(np.concatenate([w0, w1, w2], axis=1).astype(np.float32))
        rnode_chunks.append(np.full(kept_ids.shape[0], i, np.int32))
        tri_chunks.append(kept_ids.astype(np.int32))
        wsrc_chunks.append(kept_ids.astype(np.int32))
        wbary_chunks.append(np.tile(IDENT_BARY, (kept_ids.shape[0], 1)))
        # this node's hit rows are emit rows [attr_off, attr_off + c) for tri ids [f, f + c),
        # then its virtual rows for ids f + c, f + c + 1, ...
        rn_attr_base[i] = attr_off - f
        n_virtual = 0
        if split.any():
            scls = cells[split]  # [k, m]
            kk, cell_ids = np.nonzero(scls != ALPHA_TRANSPARENT)
            par = ids[split][kk]  # parent tri id of each emitted cell [S]
            bary = sub_bary_tab[cell_ids]  # [S,6]
            pidx = tri_idx[par]
            pw0 = vtx[pidx[:, 0]] @ m[:3, :3].T + m[:3, 3]
            pw1 = vtx[pidx[:, 1]] @ m[:3, :3].T + m[:3, 3]
            pw2 = vtx[pidx[:, 2]] @ m[:3, :3].T + m[:3, 3]

            def comb(bu, bv):
                return pw0 * (1.0 - bu - bv)[:, None] + pw1 * bu[:, None] + pw2 * bv[:, None]

            s0 = comb(bary[:, 0], bary[:, 1])
            s1 = comb(bary[:, 2], bary[:, 3])
            s2 = comb(bary[:, 4], bary[:, 5])
            v_chunks.append(np.concatenate([s0, s1, s2], axis=1).astype(np.float32))
            n_virtual = par.shape[0]
            rnode_chunks.append(np.full(n_virtual, i, np.int32))
            tri_chunks.append((f + c + np.arange(n_virtual)).astype(np.int32))
            wsrc_chunks.append(par.astype(np.int32))
            wbary_chunks.append(bary.astype(np.float32))
            attr_rnode_chunks.append(np.full(n_virtual, i, np.int32))
            attr_tri_chunks.append(par.astype(np.int32))
            attr_bary_chunks.append(bary.astype(np.float32))
            attr_cls_chunks.append(scls[kk, cell_ids].astype(np.int8))
        attr_off += c + n_virtual
        cls_off += c

    attr_rnode = np.concatenate(attr_rnode_chunks) if attr_rnode_chunks else np.zeros(0, np.int32)
    attr_tri = np.concatenate(attr_tri_chunks) if attr_tri_chunks else np.zeros(0, np.int32)
    attr_bary = (np.concatenate(attr_bary_chunks).astype(np.float32) if attr_bary_chunks
                 else np.zeros((0, 6), np.float32))
    attr_alpha_class = np.concatenate(attr_cls_chunks) if attr_cls_chunks else np.zeros(0, np.int8)
    wv = np.concatenate(v_chunks) if v_chunks else np.zeros((0, 9), np.float32)
    wtri_rnode = np.concatenate(rnode_chunks) if rnode_chunks else np.zeros(0, np.int32)
    wtri_tri = np.concatenate(tri_chunks) if tri_chunks else np.zeros(0, np.int32)
    wtri_src_tri = np.concatenate(wsrc_chunks) if wsrc_chunks else np.zeros(0, np.int32)
    wtri_bary = (np.concatenate(wbary_chunks).astype(np.float32) if wbary_chunks
                 else np.zeros((0, 6), np.float32))
    if wv.shape[0] == 0:  # empty (or fully culled) scene: one degenerate far-away tri
        wv = np.full((1, 9), 3e37, np.float32)
        wtri_rnode = np.zeros(1, np.int32)
        wtri_tri = np.zeros(1, np.int32)
        wtri_src_tri = np.zeros(1, np.int32)
        wtri_bary = np.tile(IDENT_BARY, (1, 1))
    nt = wv.shape[0]

    hit_attr, attr_has_uv = bake_hit_attrs_np(flat, attr_rnode, attr_tri, attr_bary, narrow=narrow_attr_ok(flat))

    v0, v1, v2 = wv[:, 0:3], wv[:, 3:6], wv[:, 6:9]
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    cen = (tlo + thi) * 0.5

    built = None
    builder = "lbvh"
    if nt > LEAF_SIZE and bvh_kind in ("sah", "sbvh"):
        if bvh_kind == "sbvh" and nt <= _SAH_NUMPY_MAX_TRIS:
            built, builder = _build_sbvh(tlo, thi, cen, wv), "sbvh"
        else:
            from ..native import build_sah_native

            built, builder = build_sah_native(tlo, thi, cen, LEAF_SIZE), "sah"
            if built is None and nt <= _SAH_NUMPY_MAX_TRIS:
                built, builder = _build_sah(tlo, thi, cen), "sah_numpy"
    if nt == 1:
        builder = "single"
        order = np.zeros(1, np.int64)
        nodes_i = np.array([[0, 0, 0, 1, -1, 0, 0, 0]], np.int32)
        nodes_f = np.zeros((1, 16), np.float32)
        nodes_self = np.zeros((1, 8), np.float32)
        nodes_self[0, 0:3] = tlo[0]
        nodes_self[0, 3:6] = thi[0]
        refit_levels, portal_roots = np.full((1, 1), -1, np.int32), np.zeros(1, np.int32)
    elif built is not None:
        order, nodes_i, nodes_f, nodes_self = built
        # the native builder leaves a leaf's child slots and col 7 unwritten
        # (np.empty); zero them as the numpy oracle does
        nodes_i[nodes_i[:, 3] > 0, 0:2] = 0
        nodes_i[:, 7] = 0
        refit_levels, portal_roots = _levels_and_portals(nodes_i)
    else:
        order, nodes_i, nodes_f, nodes_self, refit_levels, portal_roots = _build_lbvh(tlo, thi, cen)
    wv = wv[order]
    wtri_rnode = wtri_rnode[order]
    wtri_tri = wtri_tri[order]
    wtri_src_tri = wtri_src_tri[order]
    wtri_bary = wtri_bary[order]
    nrefs = order.shape[0]  # == nt except under SBVH duplication
    tris16 = np.zeros((nrefs + LEAF_SIZE, 16), np.float32)
    tris16[:nrefs, :9] = wv
    wtri_rnode = np.concatenate([wtri_rnode, np.zeros(LEAF_SIZE, np.int32)])
    wtri_tri = np.concatenate([wtri_tri, np.zeros(LEAF_SIZE, np.int32)])
    wtri_src_tri = np.concatenate([wtri_src_tri, np.zeros(LEAF_SIZE, np.int32)])
    wtri_bary = np.concatenate([wtri_bary, np.tile(IDENT_BARY, (LEAF_SIZE, 1))])

    n4i, n4f, m4 = build_bvh4(nodes_i, nodes_self)
    tris128, w8r, w8t, t8s = _tris128(nodes_i, tris16, wtri_rnode, wtri_tri)
    return WorldBvh(
        nodes_i=nodes_i,
        nodes_f=nodes_f,
        nodes_self=nodes_self,
        tris=tris16,
        wtri_rnode=wtri_rnode,
        wtri_tri=wtri_tri,
        nodes4_fi=_nodes4_fi(nodes_i, n4i, n4f),
        nodes4_i=n4i,
        nodes4_f=n4f,
        tris128=tris128,
        hit_attr=hit_attr,
        rn_attr_base=rn_attr_base,
        attr_alpha_class=attr_alpha_class,
        refit_levels=refit_levels,
        portal_roots=portal_roots,
        map4=m4,
        wtri8_rnode=w8r,
        wtri8_tri=w8t,
        tri8_src=t8s,
        attr_rnode=attr_rnode,
        attr_tri=attr_tri,
        attr_has_uv=attr_has_uv,
        attr_bary=attr_bary,
        wtri_src_tri=wtri_src_tri,
        wtri_bary=wtri_bary,
        emit2ref=_emit2ref(rn_attr_base, wtri_rnode, wtri_tri, attr_rnode.shape[0], nrefs),
        num_world_tris=nt,
        builder=builder,
    )


def _build_lbvh(tlo, thi, cen):
    """The reference's radix-tree branch of build_world_bvh
    (ops/bvh_flatten.py:918-1110): Morton-sorted triangles, a Karras radix
    tree (the native builder's, else ops/bvh.py's), subtrees of at most
    LEAF_SIZE triangles collapsed into leaves, internal nodes numbered in
    BFS order and then the leaves. Returns (order, nodes_i, nodes_f,
    nodes_self, refit_levels, portal_roots)."""
    from ..native import build_radix_tree_native

    nt = tlo.shape[0]
    native = build_radix_tree_native(tlo, thi, cen)
    if native is not None:
        order, lc, rc, leaf_l, leaf_r = native
    else:
        codes = morton3d(cen, tlo.min(axis=0), thi.max(axis=0))
        order = np.argsort(codes, kind="stable")
        keys = (codes[order].astype(np.uint64) << np.uint64(32)) | np.arange(nt, dtype=np.uint64)
        lc, rc, leaf_l, leaf_r = _build_radix_tree(keys)
    tlo, thi = tlo[order], thi[order]

    # subtree leaf ranges: internal node i covers the sorted range [range_lo, range_hi]
    ni = nt - 1
    range_lo = np.full(ni, -1, np.int64)
    range_hi = np.full(ni, -1, np.int64)
    lo_l = np.where(leaf_l, lc, -1)
    hi_l = np.where(leaf_l, lc, -1)
    lo_r = np.where(leaf_r, rc, -1)
    hi_r = np.where(leaf_r, rc, -1)
    pend = np.ones(ni, bool)
    cl_i = np.clip(lc, 0, ni - 1)  # only valid where ~leaf_l
    cr_i = np.clip(rc, 0, ni - 1)
    while pend.any():
        need_l = ~leaf_l & (lo_l < 0)
        lo_l = np.where(need_l & (range_lo[cl_i] >= 0), range_lo[cl_i], lo_l)
        hi_l = np.where(need_l & (range_hi[cl_i] >= 0), range_hi[cl_i], hi_l)
        need_r = ~leaf_r & (lo_r < 0)
        lo_r = np.where(need_r & (range_lo[cr_i] >= 0), range_lo[cr_i], lo_r)
        hi_r = np.where(need_r & (range_hi[cr_i] >= 0), range_hi[cr_i], hi_r)
        ready = pend & (lo_l >= 0) & (lo_r >= 0)
        if not ready.any():
            raise RuntimeError("range propagation deadlock")
        range_lo[ready] = np.minimum(lo_l[ready], lo_r[ready])
        range_hi[ready] = np.maximum(hi_l[ready], hi_r[ready])
        pend &= ~ready
    counts = range_hi - range_lo + 1

    # collapse roots: subtrees of <= LEAF_SIZE tris whose parent has more
    kept_int = ~(counts <= LEAF_SIZE)
    if not kept_int.any():  # the whole tree is one leaf (nt <= LEAF_SIZE)
        nodes_i = np.array([[0, 0, 0, nt, -1, 0, 0, 0]], np.int32)
        nodes_self = np.zeros((1, 8), np.float32)
        nodes_self[0, 0:3] = tlo.min(axis=0)
        nodes_self[0, 3:6] = thi.max(axis=0)
        return (order, nodes_i, np.zeros((1, 16), np.float32), nodes_self,
                np.full((1, 1), -1, np.int32), np.zeros(1, np.int32))

    # kept internals in BFS order from the root, then the leaves as met
    order_nodes = [0]
    for i in order_nodes:
        for c, is_leaf_child in ((lc[i], leaf_l[i]), (rc[i], leaf_r[i])):
            if not is_leaf_child and kept_int[c]:
                order_nodes.append(int(c))
    id_of_int = {i: k for k, i in enumerate(order_nodes)}
    n_new = len(order_nodes)
    leaf_rows = []  # (first, count, lo, hi), numbered after the internals

    def range_box(f, c):
        return tlo[f : f + c].min(axis=0), thi[f : f + c].max(axis=0)

    def child_ref(c, is_leaf_child):
        """(new id, lo, hi) of child c of a kept internal node."""
        if is_leaf_child:
            first, count = int(c), 1
        elif kept_int[c]:
            return (id_of_int[c], *range_box(int(range_lo[c]), int(counts[c])))
        else:  # collapsed subtree -> leaf
            first, count = int(range_lo[c]), int(counts[c])
        lo, hi = range_box(first, count)
        leaf_rows.append((first, count, lo, hi))
        return n_new + len(leaf_rows) - 1, lo, hi

    child_info = [(child_ref(lc[i], bool(leaf_l[i])), child_ref(rc[i], bool(leaf_r[i])))
                  for i in order_nodes]
    nn = n_new + len(leaf_rows)
    nodes_i = np.zeros((nn, 8), np.int32)
    nodes_f = np.zeros((nn, 16), np.float32)
    nodes_self = np.zeros((nn, 8), np.float32)
    parent_new = np.full(nn, -1, np.int32)
    for nid, (i, ((l_id, l_lo, l_hi), (r_id, r_lo, r_hi))) in enumerate(zip(order_nodes, child_info)):
        # near-child contract: left = smaller centroid on the split axis
        cl = (l_lo + l_hi) * 0.5
        cr = (r_lo + r_hi) * 0.5
        axis = int(np.argmax(np.abs(cr - cl)))
        if cr[axis] < cl[axis]:
            l_id, r_id = r_id, l_id
            l_lo, l_hi, r_lo, r_hi = r_lo, r_hi, l_lo, l_hi
        nodes_i[nid, 0] = l_id
        nodes_i[nid, 1] = r_id
        nodes_i[nid, 5] = axis
        nodes_f[nid, 0:3] = l_lo
        nodes_f[nid, 3:6] = l_hi
        nodes_f[nid, 6:9] = r_lo
        nodes_f[nid, 9:12] = r_hi
        nodes_self[nid, 0:3], nodes_self[nid, 3:6] = range_box(int(range_lo[i]), int(counts[i]))
        parent_new[l_id] = nid
        parent_new[r_id] = nid
    for k, (first, count, lo, hi) in enumerate(leaf_rows):
        nodes_i[n_new + k, 2] = first
        nodes_i[n_new + k, 3] = count
        nodes_self[n_new + k, 0:3] = lo
        nodes_self[n_new + k, 3:6] = hi
    nodes_i[:, 4] = parent_new
    refit_levels, portal_roots = _levels_and_portals(nodes_i)
    return order, nodes_i, nodes_f, nodes_self, refit_levels, portal_roots


# ---------------------------------------------------------------- kernel tables
# The tables of the BVH2, BVH16 and lane kernels, built only on request.


def _packet2_nodes(nodes_i, nodes_f):
    """Fused binary rows (the nodes_fi / root_code half of the reference's
    _packet2_tables, ops/bvh_flatten.py:48).

      nodes_fi [Nn,16] f32: l_lo(3) l_hi(3) r_lo(3) r_hi(3) code_l code_r
                            axis pad.  code >= 0: internal child id;
                            code < 0: leaf, -(code+1) = leafrow*16 + count.
    Returns (nodes_fi, root_code)."""
    nodes_i = np.asarray(nodes_i)
    nn = nodes_i.shape[0]
    count = nodes_i[:, 3].astype(np.int64)
    is_leaf = count > 0
    leaf_ids = np.nonzero(is_leaf)[0]
    leafrow = np.full(nn, -1, np.int64)
    leafrow[leaf_ids] = np.arange(leaf_ids.size)
    if leaf_ids.size >= 1 << 20:
        raise ValueError("packet2 kernel caps at 2^20 leaves")

    code = np.where(is_leaf, -(leafrow * 16 + count) - 1, np.arange(nn)).astype(np.float64)
    nodes_fi = np.zeros((nn, 16), np.float32)
    nodes_fi[:, 0:12] = np.asarray(nodes_f)[:, 0:12]
    l = nodes_i[:, 0].astype(np.int64)
    r = nodes_i[:, 1].astype(np.int64)
    nodes_fi[:, 12] = code[l]
    nodes_fi[:, 13] = code[r]
    nodes_fi[:, 14] = nodes_i[:, 5]
    return nodes_fi, int(code[0])


def _axis_idx(depth, path):
    """Level-order index of a collapsed-subtree position into cols 112+."""
    return (1 << depth) - 1 + path


def _packet6_tables(nodes_i, nodes_self):
    """(nodes16_fi [M,128] f32, map16 [M,16] i32) from the binary tree
    (reference ops/bvh_flatten.py:1381); map16 names the binary node of
    each child slot (-1 missing), which the refit regathers boxes from.
    Root BVH16 node is id 0. Layout: cols 0:96 16 child boxes (lo3 hi3; missing = the +3e38
    point box), 96:112 16 child codes (as nodes_fi; missing 0), 112:127
    the 15 near-order axes of the collapsed binary subtree in level order
    (slot index = 4-bit root-to-leaf path, MSB = top split)."""
    nodes_i = np.asarray(nodes_i)
    nodes_self = np.asarray(nodes_self, np.float32)
    count = nodes_i[:, 3].astype(np.int64)
    leaf_ids = np.nonzero(count > 0)[0]
    first2row = np.full(int(nodes_i[:, 2].max()) + 2, -1, np.int64)
    first2row[nodes_i[leaf_ids, 2].astype(np.int64)] = np.arange(leaf_ids.size)

    def leaf_code(b):
        return -(int(first2row[nodes_i[b, 2]]) * 16 + int(nodes_i[b, 3])) - 1

    if nodes_i[0, 3] > 0:  # root is a leaf: single row, one child slot
        f = np.full(128, 0.0, np.float32)
        for s in range(16):
            f[6 * s : 6 * s + 6] = 3e38
        f[0:3] = nodes_self[0, 0:3]
        f[3:6] = nodes_self[0, 3:6]
        f[96] = leaf_code(0)
        m = np.full(16, -1, np.int32)
        m[0] = 0
        return f[None, :].copy(), m[None, :].copy()

    rows_f, rows_m = [None], [None]
    id_of = {0: 0}
    work = deque([0])
    while work:
        b = work.popleft()
        nid = id_of[b]
        f = np.zeros(128, np.float32)
        for s in range(16):
            f[6 * s : 6 * s + 6] = 3e38  # missing = point box
        m = np.full(16, -1, np.int32)
        # expand the binary subtree at b up to 4 levels
        stack = [(b, 0, 0)]  # (internal binary id, path, depth)
        while stack:
            nb, path, depth = stack.pop()
            f[112 + _axis_idx(depth, path)] = float(nodes_i[nb, 5])
            for side, child in ((0, int(nodes_i[nb, 0])), (1, int(nodes_i[nb, 1]))):
                cpath = path * 2 + side
                cdepth = depth + 1
                if nodes_i[child, 3] > 0 or cdepth == 4:  # terminal slot
                    slot = cpath << (4 - cdepth)
                    f[6 * slot : 6 * slot + 3] = nodes_self[child, 0:3]
                    f[6 * slot + 3 : 6 * slot + 6] = nodes_self[child, 3:6]
                    m[slot] = child
                    if nodes_i[child, 3] > 0:
                        f[96 + slot] = leaf_code(child)
                    else:
                        if child not in id_of:
                            id_of[child] = len(rows_f)
                            rows_f.append(None)
                            rows_m.append(None)
                            work.append(child)
                        f[96 + slot] = id_of[child]
                else:
                    stack.append((child, cpath, cdepth))
        rows_f[nid] = f
        rows_m[nid] = m
    return np.stack(rows_f).astype(np.float32), np.stack(rows_m).astype(np.int32)


def _packet3_sidecar(nodes4_fi):
    """int32 [M,8] sidecar of the BVH4 rows (reference ops/bvh_flatten.py:1248):
    cols 0:4 child codes, 4:7 near-order axes, 7 pad (codes are exact in
    f32: |code| < 2^24)."""
    sc = np.zeros((nodes4_fi.shape[0], 8), np.int32)
    sc[:, 0:7] = nodes4_fi[:, 24:31].astype(np.int32)
    return sc


# what add_kernel_tables accepts: the table families of ops/intersect.ROUTES
# and of the split traversals; the BVH4 walks other than v7 read only
# nodes4_fi + tris128, and the split families (packet4 "bvh4_split", v1
# "bvh2_split", "wavefront") and the primary-hit seeding ("primary_seed")
# read tables build_world_bvh always keeps
KERNEL_TABLES = ("bvh2", "bvh16", "lane", "bvh4", "bvh4_multipop", "bvh4_leafqueue",
                 "bvh4_sidecar", "bvh4_split", "bvh2_split", "wavefront", "primary_seed")


def add_kernel_tables(wb: WorldBvh, tables) -> WorldBvh:
    """Build the named kernel tables ("bvh2" -> nodes_fi + root_code,
    "bvh16" -> nodes16_fi + map16, "lane" -> lane_pages + lane_geo_idx,
    "bvh4_sidecar" -> nodes4_sc) into wb, skipping those already there; the
    other BVH4 families and the split ones need no table of their own.
    The tables take their boxes from wb's tree as built: after a refit on
    the device they are refitted there too (convert.refit_device_bvh).
    Returns wb."""
    unknown = set(tables) - set(KERNEL_TABLES)
    if unknown:
        raise ValueError(f"unknown kernel tables {sorted(unknown)}; known: {KERNEL_TABLES}")
    if "bvh2" in tables and wb.nodes_fi is None:
        wb.nodes_fi, wb.root_code = _packet2_nodes(wb.nodes_i, wb.nodes_f)
    if "bvh16" in tables and wb.nodes16_fi is None:
        wb.nodes16_fi, wb.map16 = _packet6_tables(wb.nodes_i, wb.nodes_self)
    if "bvh4_sidecar" in tables and wb.nodes4_sc is None:
        wb.nodes4_sc = _packet3_sidecar(wb.nodes4_fi)
    if "lane" in tables and wb.lane_pages is None:
        from .lane_traverse import build_lane_tree

        wb.lane_pages, wb.lane_geo_idx = build_lane_tree(wb.nodes_i, wb.nodes_self, wb.tris,
                                                         wtri_rnode=wb.wtri_rnode, wtri_tri=wb.wtri_tri)
    return wb


def stack_need(nodes, levels: int, root_code: int, internal_only: bool = False,
               descend: bool = False) -> int:
    """Deepest traversal stack a per-ray walk of a fused row table
    (nodes_fi: levels=1, nodes4_fi: 2, nodes16_fi: 4) can need: popping a
    node pushes all of its real children, so a node reached with p entries
    below it needs p + its child count, and its nearest child is reached
    with p + count - 1. Missing children carry the +3e38 point box.
    internal_only: the stack of the v8 walk, which holds internal codes
    only (leaf children go to its queue). descend: the BVH2 kernel's walk,
    which keeps the nearest child in a register instead of pushing it, so
    a node needs one entry less."""
    if root_code < 0:
        return 1
    arity = 1 << levels
    nodes = np.asarray(nodes)
    codes = nodes[:, 6 * arity : 7 * arity].astype(np.int64)
    real = nodes[:, 0 : 6 * arity : 6] < 1e38  # lo.x of every child slot
    if internal_only:
        real = real & (codes >= 0)
    return _push_walk_need(codes, real, real & (codes >= 0), root_code, descend)


def _push_walk_need(children, real, inner, root: int, descend: bool = False) -> int:
    """Deepest stack of a walk from row `root` that pushes every real
    child of a popped row (descend: but the nearest, which it walks next
    from a register): children/real/inner [R,A] give each row's child
    rows, which slots hold a child, and which of those are rows the walk
    expands further."""
    nreal = real.sum(axis=1)
    need = 1
    frontier = np.array([root], np.int64)
    below = np.zeros(1, np.int64)
    while frontier.size:
        k = nreal[frontier]
        need = max(need, int((below + k - descend).max()))
        inn = inner[frontier]
        below = np.repeat(below + k - 1, inn.sum(axis=1))
        frontier = children[frontier][inn]
    return need


def split_stack_need(wb: WorldBvh, levels: int) -> int:
    """Deepest stack of the split-table walks when every box is entered.

    levels=2, the packet4 walk (ops/traverse.traverse_bvh4_split_plain):
    nodes4_i rows from BVH4 row 0, pushing every child code but the
    missing ones (-1), which the walk skips. levels=1, the v1 walk
    (traverse_bvh2_split_plain with descend, csrc/traverse_bvh2_split.cu):
    binary node ids from node 0, pushing the far child of an internal node
    and walking the near one next from a register (stack_need's
    descend=True on the same tree); a root that is a leaf needs 1."""
    if levels == 2:
        codes = np.asarray(wb.nodes4_i)[:, 0:4].astype(np.int64)
        real = codes != -1
        return _push_walk_need(codes, real, real & (codes >= 0), 0)
    if levels != 1:
        raise ValueError(f"split tables exist for levels 1 and 2, not {levels}")
    nodes_i = np.asarray(wb.nodes_i)
    internal = nodes_i[:, 3] == 0
    if not internal[0]:
        return 1
    children = nodes_i[:, 0:2].astype(np.int64)
    real = np.repeat(internal[:, None], 2, axis=1)
    return _push_walk_need(children, real, real & internal[children], 0, descend=True)


def multipop_stack_need(nodes4_fi, root_code: int, multipop: int) -> int:
    """Deepest stack of the v5 walk (ops/traverse.traverse_rows_plain with
    multipop > 1) when every box is entered: each step pops up to
    `multipop` entries and pushes the real children of each internal one,
    in slot order, the last popped member's first and the first popped
    (the top of the stack) member's last, as the walk does. A walk that
    prunes pushes a subset, and in the trees the builder emits stays below
    this; the kernels still count any push dropped on a full stack."""
    if root_code < 0:
        return 1
    nodes = np.asarray(nodes4_fi)
    real = nodes[:, 0:24:6] < 1e38
    children = [row[ok].tolist() for row, ok in zip(nodes[:, 24:28].astype(np.int64), real)]
    stack, need = [int(root_code)], 1
    while stack:
        group = stack[-multipop:]
        del stack[-multipop:]
        for e in group:  # bottom first: the top member's children end on top
            if e >= 0:
                stack.extend(children[e])
        need = max(need, len(stack))
    return need
