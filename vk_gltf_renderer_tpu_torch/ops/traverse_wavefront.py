"""Stackless wavefront BVH traversal (port of
vk_gltf_renderer_tpu/ops/traverse_wavefront.py, traverse_wavefront; its
intersect_rays_wavefront is ops/intersect.intersect_rays_wavefront),
reached through VKGR_TRAVERSAL=wavefront.

The reference is XLA code outside any Pallas kernel, so plain torch is its
port. One step advances every ray by one node of a come-from walk (Hapala
et al. 2011): per-ray state = (current binary node, came from PARENT,
SIBLING or CHILD). A ray coming from its parent or sibling tests the
node's own box (nodes_self), and on a leaf its triangles; near and far
children are by the ray's direction sign along the node's split axis. No
stack. The loop ends when every ray is DONE or after max_steps steps; a
ray still walking at the cap returns its best hit so far. DONE is
absorbing (a DONE ray tests nothing and keeps its node and state), so the
loop looks for "all done" only every CHECK_EVERY steps, which saves a
host sync per step and changes no result, and never runs past max_steps.

Any hit is not a mode of this walk: it returns the closest hit, as the
reference's does.
"""

from __future__ import annotations

import torch

from .traverse import LEAF_SLOTS, _inv, _moller_trumbore

FROM_PARENT = 0
FROM_SIBLING = 1
FROM_CHILD = 2
DONE = 3
MAX_STEPS = 16384  # the reference's cap
CHECK_EVERY = 32  # steps between host checks for "every ray is DONE"


def _aabb_hit(f, ro, inv_d, t_cur):
    rox, roy, roz = ro
    ix, iy, iz = inv_d
    t0x = (f[:, 0] - rox) * ix
    t1x = (f[:, 3] - rox) * ix
    t0y = (f[:, 1] - roy) * iy
    t1y = (f[:, 4] - roy) * iy
    t0z = (f[:, 2] - roz) * iz
    t1z = (f[:, 5] - roz) * iz
    tnear = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                          torch.clamp(torch.minimum(t0z, t1z), min=0.0))
    tfar = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                         torch.minimum(torch.maximum(t0z, t1z), t_cur))
    return tnear <= tfar


def traverse_wavefront(nodes_self, nodes_i, tris, ro, rd, tmin, tmax, max_steps=MAX_STEPS):
    """Closest hit of [N] rays (ro, rd [N,3] f32; tmin, tmax [N]) against
    the binary world BVH. Returns (t, wtri, u, v): wtri [N] i32 is the tris
    row of the hit, -1 on a miss; t is tmax where nothing was accepted."""
    n = ro.shape[0]
    dev = ro.device
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    inv_d = (_inv(rdx), _inv(rdy), _inv(rdz))
    dir_pos = torch.stack([rdx >= 0, rdy >= 0, rdz >= 0], dim=-1)  # True: left child is near
    nodes_i = nodes_i.long()

    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    st = torch.full((n,), FROM_PARENT, dtype=torch.int64, device=dev)
    t_best = tmax.clone()
    tri_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)

    def near_of(meta):
        pos = torch.gather(dir_pos, 1, meta[:, 5:6])[:, 0]
        return (torch.where(pos, meta[:, 0], meta[:, 1]),
                torch.where(pos, meta[:, 1], meta[:, 0]))

    def step(cur, st, t_best, tri_best, u_best, v_best):
        f = nodes_self[cur]
        meta = nodes_i[cur]
        count = meta[:, 3]
        leaf = count > 0
        parent = meta[:, 4]
        p_near, p_far = near_of(nodes_i[torch.clamp(parent, min=0)])
        c_near, _ = near_of(meta)
        testing = (st == FROM_PARENT) | (st == FROM_SIBLING)

        hit = _aabb_hit(f, (rox, roy, roz), inv_d, t_best) & testing
        do_tri = hit & leaf
        first = meta[:, 2]
        for c in range(LEAF_SLOTS):  # tris is padded by LEAF_SLOTS rows
            row = first + c
            tv = tris[row]
            ok, uu, vv, tt = _moller_trumbore(
                tv[:, 0], tv[:, 1], tv[:, 2], tv[:, 3] - tv[:, 0], tv[:, 4] - tv[:, 1],
                tv[:, 5] - tv[:, 2], tv[:, 6] - tv[:, 0], tv[:, 7] - tv[:, 1], tv[:, 8] - tv[:, 2],
                rox, roy, roz, rdx, rdy, rdz)
            thit = (ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > tmin)
                    & (tt < t_best) & do_tri & (c < count))
            t_best = torch.where(thit, tt, t_best)
            tri_best = torch.where(thit, row, tri_best)
            u_best = torch.where(thit, uu, u_best)
            v_best = torch.where(thit, vv, v_best)

        descend = hit & ~leaf
        finished_here = testing & (~hit | leaf)
        at_root = cur == 0
        adv_to_sibling = finished_here & (st == FROM_PARENT) & ~at_root
        adv_to_parent = finished_here & (st == FROM_SIBLING)
        adv_done = finished_here & (st == FROM_PARENT) & at_root
        from_child = st == FROM_CHILD
        fc_to_sibling = from_child & (cur == p_near)
        fc_to_parent = from_child & ~fc_to_sibling & ~at_root
        fc_done = from_child & at_root

        new_cur = torch.where(descend, c_near, cur)
        new_st = torch.where(descend, FROM_PARENT, st)
        to_sibling = adv_to_sibling | fc_to_sibling
        new_cur = torch.where(to_sibling, p_far, new_cur)
        new_st = torch.where(to_sibling, FROM_SIBLING, new_st)
        to_parent = adv_to_parent | fc_to_parent
        new_cur = torch.where(to_parent, parent, new_cur)
        new_st = torch.where(to_parent, FROM_CHILD, new_st)
        new_st = torch.where(adv_done | fc_done, DONE, new_st)
        keep = st == DONE
        return (torch.where(keep, cur, new_cur), torch.where(keep, st, new_st), t_best, tri_best,
                u_best, v_best)

    steps = 0
    state = (cur, st, t_best, tri_best, u_best, v_best)
    while steps < max_steps and bool((state[1] != DONE).any()):
        for _ in range(min(CHECK_EVERY, max_steps - steps)):
            state = step(*state)
        steps += min(CHECK_EVERY, max_steps - steps)
    _, _, t_best, tri_best, u_best, v_best = state
    return t_best, tri_best.to(torch.int32), u_best, v_best

