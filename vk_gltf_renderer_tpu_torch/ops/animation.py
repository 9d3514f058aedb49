"""Device animation compute: skinning, morphing, world-matrix propagation,
the world-triangle rebake and the BVH refit, on torch tensors.

Port of vk_gltf_renderer_tpu/ops/animation.py (the reference renderer's
compute skinning and morphing, skinning.comp.slang / morph.comp.slang, its
level-order transform propagation, world_matrix_propagate.comp.slang, and
its BLAS update, updateBottomLevelAS). Plain torch, as the reference's is
plain jnp outside any Pallas kernel. The level loops of the propagation and
the refit run one step a level, as the reference's lax.scan does.

The refit is min/max and gathers only, so its outputs equal the
reference's bit for bit on the same triangles. Its level scatters pad with
a dummy row (index nn) and write each real node once a level: duplicate
indices of index_put_ (nondeterministic on CUDA) only ever hit the dummy.

CPU oracles of the deformations: models/animation.py (cpu_skin, cpu_morph).
"""

from __future__ import annotations

import numpy as np
import torch

from .bvh_flatten import LEAF_SIZE


def skin_vertices(positions, normals, joints0, weights0, joint_matrices):
    """4-influence linear-blend skinning (skinning.comp.slang:28-70).

    positions [V,3], normals [V,3], joints0 [V,4] int, weights0 [V,4],
    joint_matrices [J,4,4]. Returns (positions', normals'). The weighted
    matrix sum runs over the 4 influences in order (the reference's einsum
    leaves the order to XLA)."""
    w = weights0
    ws = w.sum(dim=1, keepdim=True)
    w = torch.where(ws > 0, w / torch.clamp(ws, min=1e-9), w)
    m = joint_matrices[joints0.long()]  # [V,4,4,4]
    skin_m = w[:, 0, None, None] * m[:, 0]
    for j in range(1, 4):
        skin_m = skin_m + w[:, j, None, None] * m[:, j]
    p1 = torch.cat([positions, positions.new_ones((positions.shape[0], 1))], dim=1)
    pos = (skin_m @ p1[:, :, None])[:, :3, 0]
    nrm = (skin_m[:, :3, :3] @ normals[:, :, None])[:, :, 0]
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=1, keepdim=True), min=1e-20)
    return pos, nrm


def morph_vertices(base, deltas, weights):
    """Weighted morph-target blend (morph.comp.slang:28-70): base [V,3],
    deltas [T,V,3], weights [T] -> base + sum_t weights[t] * deltas[t]."""
    return base + torch.einsum("t,tvc->vc", weights, deltas)


def propagate_world_matrices(locals_, parents_padded, levels_padded, level_mask):
    """Level-order world-matrix propagation (world_matrix_propagate.comp.slang:19-32).

    locals_ [N,4,4]; levels_padded [L,K] node ids (-1 pad); parents_padded
    [L,K] parent ids (-1 for roots); level_mask [L,K] bool (pack_levels).
    Returns world [N,4,4]: each level's nodes take parent world @ local.
    Padded lanes write a dummy row N (the reference writes node 0's old
    matrix back there, which races node 0's own write when the root level
    is padded)."""
    n = locals_.shape[0]
    eye = torch.eye(4, dtype=locals_.dtype, device=locals_.device)
    world = eye.expand(n + 1, 4, 4).clone()
    for nodes, parents, mask in zip(levels_padded.long(), parents_padded.long(), level_mask):
        safe_nodes = torch.where(mask, nodes, n)
        parent_world = torch.where((parents >= 0)[:, None, None], world[parents.clamp(min=0)], eye)
        new = parent_world @ locals_[nodes.clamp(min=0)]
        world = world.index_put((safe_nodes,), new)
    return world[:n]


def pack_levels(topo_levels: list, parents: np.ndarray):
    """Host-side: pad BFS levels to a rectangle for the propagation."""
    if not topo_levels:
        z = np.zeros((1, 1), np.int32)
        return z - 1, z - 1, np.zeros((1, 1), bool)
    k = max(len(lv) for lv in topo_levels)
    n_levels = len(topo_levels)
    nodes = np.full((n_levels, k), -1, np.int32)
    pars = np.full((n_levels, k), -1, np.int32)
    mask = np.zeros((n_levels, k), bool)
    for i, lev in enumerate(topo_levels):
        nodes[i, : len(lev)] = lev
        pars[i, : len(lev)] = parents[lev]
        mask[i, : len(lev)] = True
    return nodes, pars, mask


def _gather_boxes(lo, hi, src, missing):
    """[M, 6*S] child boxes regathered from the binary self boxes through
    the slot map src [M,S] (-1 missing); missing slots take `missing`
    ([M, 6*S] or a scalar)."""
    m, slots = src.shape
    safe = src.clamp(min=0).long()
    box = torch.cat([lo[safe], hi[safe]], dim=2).reshape(m, 6 * slots)  # [M,S,6] -> [M,6S]
    keep = (src >= 0).repeat_interleave(6, dim=1)
    return torch.where(keep, box, missing)


def refit_world_bvh(wb, new_tris):
    """Refit the node boxes after vertex or transform animation (the
    reference's BLAS update path, gltf_scene_rtx.cpp:551).

    wb: the topology and refit maps as tensors on one device, by the
    WorldBvh field names: nodes_i, nodes_self, refit_levels, map4,
    nodes4_fi, tri8_src, tris128, and for each further table family its
    table and map (nodes4_f; nodes_fi; nodes16_fi + map16; lane_pages +
    lane_geo_idx, page-major or entry-major alike), None where absent.
    new_tris [T+8,16] world triangles in BVH order.

    Returns (nodes_f, nodes_self, nodes4_f, tris, nodes_fi, tris128,
    lane_pages, nodes4_fi, nodes16_fi) as the reference does, None for an
    absent family; topology columns and missing slots keep their values."""
    from .lane_traverse import refit_lane_pages

    v0, v1, v2 = new_tris[:, 0:3], new_tris[:, 3:6], new_tris[:, 6:9]
    tlo = torch.minimum(torch.minimum(v0, v1), v2)
    thi = torch.maximum(torch.maximum(v0, v1), v2)

    ni = wb.nodes_i.long()
    nn = ni.shape[0]
    first, count = ni[:, 2], ni[:, 3]
    leaf_mask = count > 0

    # leaf self boxes: min/max over up to LEAF_SIZE rows
    leaf_lo = tlo.new_full((nn, 3), 3e37)
    leaf_hi = tlo.new_full((nn, 3), -3e37)
    for c in range(LEAF_SIZE):
        row = first + c
        valid = (leaf_mask & (c < count))[:, None]
        leaf_lo = torch.where(valid, torch.minimum(leaf_lo, tlo[row]), leaf_lo)
        leaf_hi = torch.where(valid, torch.maximum(leaf_hi, thi[row]), leaf_hi)

    old_self = wb.nodes_self
    zero = tlo.new_zeros((1, 3))
    lo = torch.cat([torch.where(leaf_mask[:, None], leaf_lo, old_self[:, 0:3]), zero])
    hi = torch.cat([torch.where(leaf_mask[:, None], leaf_hi, old_self[:, 3:6]), zero])

    left, right = ni[:, 0], ni[:, 1]
    for nodes in wb.refit_levels.long():
        safe = torch.where(nodes >= 0, nodes, nn)  # pad -> dummy row nn
        inner = safe.clamp(max=nn - 1)
        l, r = left[inner].clamp(min=0), right[inner].clamp(min=0)
        nlo = torch.minimum(lo[l], lo[r])
        nhi = torch.maximum(hi[l], hi[r])
        lo = lo.index_put((safe,), nlo)
        hi = hi.index_put((safe,), nhi)
    lo, hi = lo[:nn], hi[:nn]
    nodes_self = torch.cat([lo, hi, lo.new_zeros((nn, 2))], dim=1)
    lsafe, rsafe = left.clamp(min=0), right.clamp(min=0)
    nodes_f = torch.cat([lo[lsafe], hi[lsafe], lo[rsafe], hi[rsafe], lo.new_zeros((nn, 4))], dim=1)

    # BVH4: child boxes regathered through map4; missing slots keep their inverted boxes in
    # nodes4_f and the always-miss point box (+3e38, code 0) in nodes4_fi
    nodes4_f = None
    if wb.nodes4_f is not None:
        nodes4_f = torch.cat([_gather_boxes(lo, hi, wb.map4, wb.nodes4_f[:, 0:24]), wb.nodes4_f[:, 24:]], dim=1)
    nodes4_fi = torch.cat([_gather_boxes(lo, hi, wb.map4, 3e38), wb.nodes4_fi[:, 24:32]], dim=1)
    nodes_fi = None
    if wb.nodes_fi is not None:  # BVH2 rows: boxes 0:12, codes and axis 12:16
        nodes_fi = torch.cat([nodes_f[:, 0:12], wb.nodes_fi[:, 12:16]], dim=1)
    nodes16_fi = None
    if wb.nodes16_fi is not None:  # BVH16 rows: boxes 0:96 through map16, codes/axes 96:128
        nodes16_fi = torch.cat([_gather_boxes(lo, hi, wb.map16, 3e38), wb.nodes16_fi[:, 96:128]], dim=1)

    # leaf blocks regathered from the refit triangles; slots 9.. are the ids
    t8s = wb.tri8_src.long()
    n_rows = t8s.shape[0] // 8
    blk = new_tris[t8s.clamp(min=0), 0:16]
    blk = torch.where((t8s >= 0)[:, None], blk, 0.0)
    old128 = wb.tris128.reshape(n_rows * 8, 16)
    tris128 = torch.cat([blk[:, 0:9], old128[:, 9:16]], dim=1).reshape(n_rows, 128)

    lane_pages = None
    if wb.lane_pages is not None:
        lane_pages = refit_lane_pages(wb.lane_pages, wb.lane_geo_idx, nodes_self, new_tris)
    return nodes_f, nodes_self, nodes4_f, new_tris, nodes_fi, tris128, lane_pages, nodes4_fi, nodes16_fi


def bake_world_tris(vtx_pos, tri_idx, rn_o2w, wtri_rnode, wtri_tri, wtri_bary=None):
    """World-space triangle rows [T',16] (v0 v1 v2, pad) from the (possibly
    skinned or morphed) vertices and the (possibly moved) instance matrices
    rn_o2w [N,4,4]. wtri_tri: each row's bake source tri (WorldBvh.wtri_src_tri);
    wtri_bary [T',6] recombines its corners at barycentric corners
    (identity rows pass through)."""
    idx = tri_idx[wtri_tri.long()].long()  # [T',3]
    m = rn_o2w[wtri_rnode.long()]  # [T',4,4]

    def xf(p):
        return m[:, :3, 0] * p[:, 0:1] + m[:, :3, 1] * p[:, 1:2] + m[:, :3, 2] * p[:, 2:3] + m[:, :3, 3]

    p0, p1, p2 = vtx_pos[idx[:, 0]], vtx_pos[idx[:, 1]], vtx_pos[idx[:, 2]]
    if wtri_bary is not None:
        def comb(bu, bv):
            return p0 * (1.0 - bu - bv)[:, None] + p1 * bu[:, None] + p2 * bv[:, None]

        p0, p1, p2 = (comb(wtri_bary[:, 0], wtri_bary[:, 1]), comb(wtri_bary[:, 2], wtri_bary[:, 3]),
                      comb(wtri_bary[:, 4], wtri_bary[:, 5]))
    w0, w1, w2 = xf(p0), xf(p1), xf(p2)
    return torch.cat([w0, w1, w2, w0.new_zeros((w0.shape[0], 7))], dim=1).float()
