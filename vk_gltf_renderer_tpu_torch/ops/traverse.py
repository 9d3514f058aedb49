"""Small-vector helpers, the plain traversals and the brute-force oracle.

The plain traversals are the plain PyTorch versions of the traversal
kernels (csrc/traverse_bvh*.cu and csrc/traverse_lanes.cu, wrapped by
ops/traverse_bvh*.py and ops/lane_traverse.py). Each is vectorised over
rays: one loop iteration advances every ray that is still walking by one
step. They carry over exactly the arithmetic of the reference kernel
bodies (vk_gltf_renderer_tpu/ops/pallas_traverse.py _traverse_body,
_traverse4_body, _traverse2_body, _traverse3_core, _traverse5_body,
_traverse8_body, _traverse6_body and
ops/lane_traverse.py _make_step): the inv() clamp, the slab test with tnear
floored at 0 and tfar capped at t_best, the leaf decoding and
Moller-Trumbore with the 1e-12 determinant guard.

traverse_bvh{2,4,16}_plain walk the fused row tables of arity 2, 4 and 16
with a per-ray stack ([N, depth] tensor). They differ from the packet
kernels only in order (near-first by each ray's own direction signs, not a
packet vote), which changes nothing but equal-t ties. The BVH4 variants
follow their kernels' own schedules: traverse_bvh4_multipop_plain (v5,
several pops per step), traverse_bvh4_leafqueue_plain (v8, internal stack
plus leaf queue with its gate) and traverse_bvh4_sidecar_plain (v7, codes
and axes from nodes4_sc). The split walks read the tables the reference
keeps beside the fused ones and return the tris row of a hit, which the
caller resolves to (rnode, tri): traverse_bvh4_split_plain (packet4,
nodes4_f + nodes4_i) and traverse_bvh2_split_plain (v1, nodes_f +
nodes_i). traverse_lanes_plain walks the skip-pointer entries
(entry-major [E,16]) without a stack.

intersect_brute is the test oracle (reference ops/traverse.py:222).
"""

from __future__ import annotations

import torch

INFINITE = 1e32
STACK_DEPTH = 64  # BVH4 (csrc/traverse_bvh4.cu; also v7, and v8's internal stack)
STACK_DEPTH2 = 128  # BVH2 (csrc/traverse_bvh2.cu)
STACK_DEPTH16 = 256  # BVH16 (csrc/traverse_bvh16.cu)
STACK_DEPTH_MULTIPOP = 128  # v5 (csrc/traverse_bvh4_multipop.cu kStack)
MULTIPOP = 4  # entries the v5 walk pops per step
LANE_WINDOW = 1  # lane entries one load round of csrc/traverse_lanes.cu reads (its kWindow)
LANE_WINDOWS = (1, 2, 4, 8)  # windows whose load rounds traverse_lanes_plain counts
LEAF_QUEUE = 16  # v8's leaf queue (csrc/traverse_bvh4_leafqueue.cu)
LEAF_SLOTS = 8  # triangles per tris128 row (and per leaf of the split tables)
STACK_DEPTH_SPLIT4 = 64  # the packet4 walk (csrc/traverse_bvh4_split.cu)
STACK_DEPTH_SPLIT2 = 128  # the v1 walk (csrc/traverse_bvh2_split.cu)


def dot3(a, b):
    """f32 3-vector dot as explicit multiply-adds (never a matmul)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _inv(d):
    return torch.where(torch.abs(d) < 1e-20, torch.where(d >= 0, 1e30, -1e30), 1.0 / d)


def _slab(f, o, ro, inv_d, t_best):
    """Box at columns o:o+6 (lo3 hi3) of the fetched rows f [K,*] against
    the rays."""
    rox, roy, roz = ro
    ix, iy, iz = inv_d
    t0x = (f[:, o + 0] - rox) * ix
    t1x = (f[:, o + 3] - rox) * ix
    t0y = (f[:, o + 1] - roy) * iy
    t1y = (f[:, o + 4] - roy) * iy
    t0z = (f[:, o + 2] - roz) * iz
    t1z = (f[:, o + 5] - roz) * iz
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp(torch.minimum(t0z, t1z), min=0.0),
    )
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), t_best),
    )
    return tnear <= tfar


def _moller_trumbore(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy, dz):
    """(ok, u, v, t) of rays against triangles v0 + edges e1, e2
    (broadcasting); ok is the determinant guard."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) >= 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return ok, uu, vv, tt


def _visit_slots(flip, levels):
    """Child slot of every near-first visit position: [K, 2^levels] from
    flip [K, 2^levels - 1] (True where the right side of a split of the
    collapsed binary subtree, in level order, is nearer)."""
    k = flip.shape[0]
    pos = torch.arange(1 << levels, device=flip.device)
    path = torch.zeros((k, 1 << levels), dtype=torch.long, device=flip.device)
    for d in range(levels):
        bit = (pos >> (levels - 1 - d)) & 1
        fl = torch.gather(flip, 1, (1 << d) - 1 + path).long()
        path = path * 2 + (bit[None, :] ^ fl)
    return path


def _new_stats(stats, nodes, tris128):
    """Start (or, for a dict that has them, go on adding to) the visit
    counters of a plain walk (see traverse_rows_plain)."""
    if stats is None:
        return None
    for key in ("internal", "leaf", "tris"):
        stats.setdefault(key, 0)
    stats.setdefault("node_rows", torch.zeros(nodes.shape[0], dtype=torch.bool, device=nodes.device))
    stats.setdefault("leaf_rows", torch.zeros(tris128.shape[0], dtype=torch.bool, device=nodes.device))
    return stats


class _Walk:
    """Rays and best-hit state shared by the plain stack walks. split: the
    leaf codes index rows of the per-triangle table tris [T+8,16] (the
    split walks) instead of tris128 rows, and a hit records its tris row
    in `tri` (rn stays -1)."""

    def __init__(self, tris128, rays, anyhit, stats, split=False):
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax = rays
        self.tris128 = tris128
        self.split = split
        self.ro = (rox, roy, roz)
        self.rd = (rdx, rdy, rdz)
        self.tmin = tmin
        self.inv_d = (_inv(rdx), _inv(rdy), _inv(rdz))
        self.sgn = torch.stack([rdx >= 0, rdy >= 0, rdz >= 0], dim=1)  # [N,3]
        self.anyhit = anyhit
        self.stats = stats
        n, dev = rox.shape[0], rox.device
        self.t = tmax.clone()
        self.rn = torch.full((n,), -1.0, device=dev)
        self.tri = torch.full((n,), -1.0, device=dev)
        self.u = torch.zeros(n, device=dev)
        self.v = torch.zeros(n, device=dev)

    def result(self, dropped):
        return (self.t, self.rn.to(torch.int32), self.tri.to(torch.int32), self.u, self.v,
                int(dropped))

    def test_leaves(self, li, e):
        """Triangle tests of leaf codes e [K] for rays li [K], in slot order
        (strict '<': the first of equal t wins). Returns the rays whose any
        hit was accepted (empty for closest hit)."""
        code = -e - 1
        row = torch.div(code, 16, rounding_mode="floor")
        cnt = code - row * 16
        slot = torch.arange(LEAF_SLOTS, device=li.device)
        if self.split:  # slots are tris rows first .. first + 7 (the table is padded)
            rows = row[:, None] + slot[None, :]
            tv = self.tris128[rows]
        else:
            tv = self.tris128[row].reshape(-1, LEAF_SLOTS, 16)
        if self.stats is not None:
            self.stats["leaf"] += li.numel()
            self.stats["tris"] += int(cnt.sum())
            self.stats["leaf_rows"][rows[slot[None, :] < cnt[:, None]] if self.split else row] = True
        rox, roy, roz = (c[li, None] for c in self.ro)
        rdx, rdy, rdz = (c[li, None] for c in self.rd)
        v0x, v0y, v0z = tv[..., 0], tv[..., 1], tv[..., 2]
        ok, uu, vv, tt = _moller_trumbore(
            v0x, v0y, v0z, tv[..., 3] - v0x, tv[..., 4] - v0y, tv[..., 5] - v0z,
            tv[..., 6] - v0x, tv[..., 7] - v0y, tv[..., 8] - v0z, rox, roy, roz, rdx, rdy, rdz)
        ok = ok & (slot[None, :] < cnt[:, None])
        cand = ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > self.tmin[li, None])
        tb, rb, trb = self.t[li], self.rn[li], self.tri[li]
        ub, vb = self.u[li], self.v[li]
        for c in range(LEAF_SLOTS):
            hit = cand[:, c] & (tt[:, c] < tb)
            tb = torch.where(hit, -1.0 if self.anyhit else tt[:, c], tb)
            if self.split:
                trb = torch.where(hit, rows[:, c].to(torch.float32), trb)
            else:
                rb = torch.where(hit, tv[:, c, 9], rb)
                trb = torch.where(hit, tv[:, c, 10], trb)
            ub = torch.where(hit, uu[:, c], ub)
            vb = torch.where(hit, vv[:, c], vb)
        self.t[li], self.rn[li], self.tri[li] = tb, rb, trb
        self.u[li], self.v[li] = ub, vb
        return li[trb >= 0] if self.anyhit else li[:0]

    def expand(self, levels, nodes, ii, e, t_best, sidecar=None):
        """Slab tests of the children of internal rows e [K] for rays ii
        against t_best [K]. Returns (codes, enter) [K, arity] in push order
        (far first: the nearest child is pushed last and popped next).
        sidecar: the v7 walk's [M,8] int table, read for the child codes and
        split axes instead of the row's float columns."""
        arity = 1 << levels
        f = nodes[e]  # [K, 8*arity]
        if self.stats is not None:
            self.stats["internal"] += ii.numel()
            self.stats["node_rows"][e] = True
        ro = tuple(c[ii] for c in self.ro)
        inv_d = tuple(c[ii] for c in self.inv_d)
        hits = torch.stack([_slab(f, 6 * s, ro, inv_d, t_best) for s in range(arity)], dim=1)
        if sidecar is None:
            codes = f[:, 6 * arity : 7 * arity].long()
            axes = f[:, 7 * arity : 8 * arity - 1].long()
        else:
            sc = sidecar[e].long()
            codes, axes = sc[:, 0:4], sc[:, 4:7]
        flip = ~torch.gather(self.sgn[ii], 1, axes)  # the right side is nearer
        slots = _visit_slots(flip, levels).flip(1)
        return torch.gather(codes, 1, slots), torch.gather(hits, 1, slots)


def _push(stack, sp, rows, codes, enter, depth, descend=False):
    """Push codes [K,A] where enter, column by column, onto the per-ray
    stacks of rows [K]; returns the pushes dropped on a full stack.
    descend: the last entered column (the nearest child, popped next) is
    the walk's next node, held outside the stack, so it is never dropped
    (the stack holds one column more than depth for it)."""
    spi = sp[rows]
    dropped = 0
    nearest = torch.zeros_like(enter)
    if descend:
        later = torch.zeros_like(enter[:, 0])  # an entered column follows
        for p in reversed(range(codes.shape[1])):
            nearest[:, p] = enter[:, p] & ~later
            later = later | enter[:, p]
    for p in range(codes.shape[1]):
        full = enter[:, p] & (spi >= depth) & ~nearest[:, p]
        dropped += int(full.sum())
        push = enter[:, p] & ~full
        stack[rows[push], spi[push]] = codes[push, p]
        spi = spi + push.long()
    sp[rows] = spi
    return dropped


def _expand_push(w, levels, nodes, ii, e, t_best, sidecar, split, stack, sp, depth, descend=False):
    """Visit internal rows e [K] of rays ii against t_best [N] and push the
    entered children; returns the pushes dropped."""
    if not ii.numel():
        return 0
    codes, enter = w.expand(levels, nodes, ii, e, t_best[ii], sidecar)
    if split:
        enter = enter & (codes != -1)
    return _push(stack, sp, ii, codes, enter, depth, descend)


def traverse_rows_plain(levels, nodes, tris128, root_code, rox, roy, roz, rdx, rdy, rdz,
                        tmin, tmax, anyhit=False, stack_depth=64, multipop=1, sidecar=None,
                        stats=None, split=False, nearest_on_top=True, descend=False):
    """Plain per-ray traversal of a fused row table of arity 2^levels
    (layout in csrc/traverse_bvh.cuh: child boxes, child codes, split axes).

    All ray inputs are [N] f32. Returns (t, rnode, tri, u, v, overflow):
    t [N] f32 is the best t (tmax where nothing was accepted, -1 after an
    any-hit), rnode/tri [N] i32 (-1 = no hit), u/v [N] f32, and overflow
    the number of stack pushes dropped because a stack was full (0 unless
    a tree is deeper than stack_depth allows). Any-hit stops a ray at its
    first accepted hit. Rays with !(tmax >= 0) (negative or NaN) miss at
    an internal root and return (tmax, -1, -1, 0, 0) exactly, which
    csrc/traverse_bvh4.cu relies on to skip them; a leaf root tests its
    triangles, whose t must still lie in (tmin, tmax).

    multipop > 1 is the v5 schedule (csrc/traverse_bvh4_multipop.cu): each
    step pops a group of up to `multipop` entries (member 0 the top of the
    stack). Every internal member is tested against the t_best the group
    was popped with; the leaf members' triangles are tested in member
    order with t_best chained (so the first of equal t wins, as in one
    leaf); then the members' entered children are pushed, member k-1's
    first and member 0's last, each far first, so that the nearest child
    of the nearest member is popped next. nearest_on_top=False is the
    reference's order (traverse_packets5, and this kernel before it was
    redesigned): the members processed in pop order with t_best chained
    through the whole group, each internal member pushing its children as
    it is processed, which leaves the last member's on top. sidecar is the
    v7 walk (nodes4_sc).
    split is the packet4 walk (traverse_bvh4_split_plain): leaf codes index
    the tris table passed as tris128, and missing children (code -1) are
    not pushed. descend (single pop) is the BVH2 kernel's walk, which
    holds the nearest entered child in a register instead of pushing it:
    the same visits, and a stack of stack_depth entries drops only pushes
    of the other children (bvh_flatten.stack_need with descend=True).

    stats, a dict, receives the visit counts the card's bounds are made of:
    internal / leaf visits, triangles tested, and boolean masks of the
    node and leaf rows touched (node_rows, leaf_rows); a dict that already
    holds them goes on adding (several calls, one count)."""
    dev = rox.device
    n = rox.shape[0]
    w = _Walk(tris128, (rox, roy, roz, rdx, rdy, rdz, tmin, tmax), anyhit,
              _new_stats(stats, nodes, tris128), split)
    stack = torch.zeros((n, stack_depth + descend), dtype=torch.int64, device=dev)
    stack[:, 0] = int(root_code)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    overflow = 0

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        top = sp[act]
        k = torch.clamp(top, max=multipop)
        sp[act] = top - k
        group = []  # (rays, codes) of each pop position, top of stack first
        for j in range(multipop):
            has = k > j
            group.append((act[has], stack[act[has], top[has] - 1 - j]))
        ended = []
        chain = multipop == 1 or not nearest_on_top
        t_pop = None if chain else w.t.clone()
        for rays, e in group:
            leaf = e < 0
            if leaf.any():
                ended.append(w.test_leaves(rays[leaf], e[leaf]))
            if chain:
                overflow += _expand_push(w, levels, nodes, rays[~leaf], e[~leaf], w.t, sidecar,
                                         split, stack, sp, stack_depth, descend)
        if not chain:
            for rays, e in reversed(group):
                overflow += _expand_push(w, levels, nodes, rays[e >= 0], e[e >= 0], t_pop, sidecar,
                                         split, stack, sp, stack_depth)
        if anyhit and ended:
            sp[torch.cat(ended)] = 0
    return w.result(overflow)


def traverse_bvh2_plain(nodes_fi, tris128, root_code, *rays, anyhit=False, stats=None):
    """Plain BVH2 traversal over nodes_fi [N,16] (csrc/traverse_bvh2.cu,
    which descends into the nearer entered child)."""
    return traverse_rows_plain(1, nodes_fi, tris128, root_code, *rays, anyhit=anyhit,
                               stack_depth=STACK_DEPTH2, stats=stats, descend=True)


def traverse_bvh4_plain(nodes4_fi, tris128, root_code, *rays, anyhit=False, stats=None):
    """Plain BVH4 traversal over nodes4_fi [M,32] (csrc/traverse_bvh4.cu)."""
    return traverse_rows_plain(2, nodes4_fi, tris128, root_code, *rays, anyhit=anyhit,
                               stack_depth=STACK_DEPTH, stats=stats)


def traverse_bvh16_plain(nodes16_fi, tris128, root_code, *rays, anyhit=False, stats=None):
    """Plain BVH16 traversal over nodes16_fi [M,128] (csrc/traverse_bvh16.cu)."""
    return traverse_rows_plain(4, nodes16_fi, tris128, root_code, *rays, anyhit=anyhit,
                               stack_depth=STACK_DEPTH16, stats=stats)


def traverse_bvh4_multipop_plain(nodes4_fi, tris128, root_code, *rays, anyhit=False, stats=None,
                                 nearest_on_top=True):
    """Plain v5 walk: BVH4 popping MULTIPOP entries per step
    (csrc/traverse_bvh4_multipop.cu); nearest_on_top=False is the
    reference's order (see traverse_rows_plain)."""
    return traverse_rows_plain(2, nodes4_fi, tris128, root_code, *rays, anyhit=anyhit,
                               stack_depth=STACK_DEPTH_MULTIPOP, multipop=MULTIPOP, stats=stats,
                               nearest_on_top=nearest_on_top)


def traverse_bvh4_sidecar_plain(nodes4_fi, nodes4_sc, tris128, root_code, *rays, anyhit=False,
                                stats=None):
    """Plain v7 walk: BVH4 with child codes and split axes read from the
    nodes4_sc [M,8] int32 sidecar (csrc/traverse_bvh4_sidecar.cu)."""
    return traverse_rows_plain(2, nodes4_fi, tris128, root_code, *rays, anyhit=anyhit,
                               stack_depth=STACK_DEPTH, sidecar=nodes4_sc, stats=stats)


def traverse_bvh4_split_plain(nodes4_f, nodes4_i, tris, rox, roy, roz, rdx, rdy, rdz, tmin,
                              tmax, stats=None):
    """Plain packet4 walk (csrc/traverse_bvh4_split.cu; the reference's
    traverse_packets4): BVH4 from row 0 over the split tables, child boxes
    from nodes4_f [M,32] (cols 0:24), codes and split axes from nodes4_i
    [M,8] i32, leaf code -(first*16+count)-1 testing tris [T+8,16] rows
    first .. first+count-1. A missing child has code -1 and an inverted box
    that every live ray's slab test accepts; the reference pushes it and
    later pops an empty leaf, this walk does not push it (the same hits).
    Closest hit only. Returns (t, rnode, row, u, v, overflow): row [N] i32
    is the tris row of the hit (-1 = none), rnode is -1 (the caller
    resolves the row), t is tmax where nothing was accepted; stats as
    traverse_rows_plain (leaf_rows over tris rows)."""
    return traverse_rows_plain(2, nodes4_f, tris, 0, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                               stack_depth=STACK_DEPTH_SPLIT4, sidecar=nodes4_i, stats=stats,
                               split=True)


def traverse_bvh2_split_plain(nodes_f, nodes_i, tris, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                              stats=None, descend=True):
    """Plain v1 walk (csrc/traverse_bvh2_split.cu; the reference's
    traverse_packets): binary node ids from node 0 over the split tables.
    A pop reads nodes_i[node] (left, right, first, count, parent, axis):
    count > 0 tests tris rows first .. first+count-1; otherwise both child
    boxes of nodes_f[node] (cols 0:12) are tested and the far, then the
    near child (near: the left one where the ray's direction along `axis`
    is >= 0) is pushed if its box is entered. Closest hit only; returns
    what traverse_bvh4_split_plain returns. descend: the kernel's walk,
    which keeps the nearer entered child in a register instead of pushing
    it: the same visits, and a stack of STACK_DEPTH_SPLIT2 entries drops
    only pushes of the far child (bvh_flatten.split_stack_need counts this
    walk); descend=False is the walk of the kernel before its redesign,
    which pushed both. stats: internal / leaf visits, triangle tests,
    node_rows (internal nodes popped: their nodes_i and nodes_f rows are
    read), leaf_node_rows (leaf nodes popped: only their nodes_i row is
    read) and leaf_rows (tris rows tested)."""
    dev = rox.device
    n = rox.shape[0]
    w = _Walk(tris, (rox, roy, roz, rdx, rdy, rdz, tmin, tmax), False,
              _new_stats(stats, nodes_f, tris), split=True)
    if w.stats is not None:
        w.stats.setdefault("leaf_node_rows", torch.zeros(nodes_i.shape[0], dtype=torch.bool,
                                                         device=dev))
    depth = STACK_DEPTH_SPLIT2
    stack = torch.zeros((n, depth + descend), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    overflow = 0
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        e = stack[act, sp[act]]
        meta = nodes_i[e].long()
        leaf = meta[:, 3] > 0
        if w.stats is not None:
            w.stats["node_rows"][e[~leaf]] = True
            w.stats["leaf_node_rows"][e[leaf]] = True
        if leaf.any():
            w.test_leaves(act[leaf], -(meta[leaf, 2] * 16 + meta[leaf, 3]) - 1)
        ii, m = act[~leaf], meta[~leaf]
        if ii.numel():
            if w.stats is not None:
                w.stats["internal"] += ii.numel()
            f = nodes_f[e[~leaf]]
            ro = tuple(c[ii] for c in w.ro)
            inv_d = tuple(c[ii] for c in w.inv_d)
            hit_l = _slab(f, 0, ro, inv_d, w.t[ii])
            hit_r = _slab(f, 6, ro, inv_d, w.t[ii])
            l_near = torch.gather(w.sgn[ii], 1, m[:, 5:6])[:, 0]
            codes = torch.stack([torch.where(l_near, m[:, 1], m[:, 0]),
                                 torch.where(l_near, m[:, 0], m[:, 1])], dim=1)
            enter = torch.stack([torch.where(l_near, hit_r, hit_l),
                                 torch.where(l_near, hit_l, hit_r)], dim=1)
            overflow += _push(stack, sp, ii, codes, enter, depth, descend)
    return w.result(overflow)


def traverse_bvh4_leafqueue_plain(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz,
                                  tmin, tmax, anyhit=False, stats=None):
    """Plain v8 walk (csrc/traverse_bvh4_leafqueue.cu): the stack holds only
    internal codes and leaf children go to a per-ray queue of LEAF_QUEUE
    entries (last in, first out, as the reference's). Each step pops one
    internal code and one queued leaf; the internal visit's slab tests see
    t_best from before the step's leaf. A producer gate pauses internal pops
    while the queue holds more than LEAF_QUEUE - 4 entries (an internal
    visit adds at most 4), so the queue never overflows, and a ray ends only
    when both are empty. Returns what traverse_rows_plain returns; stats
    also counts the steps whose internal pop the gate paused ("gated")."""
    cap = LEAF_QUEUE
    if cap < 5:
        raise ValueError(f"a leaf queue of {cap} entries cannot take one internal visit")
    dev = rox.device
    n = rox.shape[0]
    w = _Walk(tris128, (rox, roy, roz, rdx, rdy, rdz, tmin, tmax), anyhit,
              _new_stats(stats, nodes4_fi, tris128))
    if w.stats is not None:
        w.stats.setdefault("gated", 0)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    queue = torch.zeros((n, cap), dtype=torch.int64, device=dev)
    root = int(root_code)
    sp = torch.full((n,), int(root >= 0), dtype=torch.int64, device=dev)
    lq = torch.full((n,), int(root < 0), dtype=torch.int64, device=dev)
    (stack if root >= 0 else queue)[:, 0] = root
    overflow = 0

    while True:
        act = torch.nonzero((sp > 0) | (lq > 0)).squeeze(1)
        if act.numel() == 0:
            break
        waiting = sp[act] > 0
        take_i = waiting & (lq[act] < cap - 4)
        if w.stats is not None:
            w.stats["gated"] += int((waiting & ~take_i).sum())
        ii = act[take_i]
        sp[ii] -= 1
        e = stack[ii, sp[ii]]
        li = act[lq[act] > 0]
        lq[li] -= 1
        le = queue[li, lq[li]]
        t_before = w.t[ii]  # the internal half sees t_best from before the leaf
        ended = w.test_leaves(li, le) if li.numel() else li
        if ii.numel():
            codes, enter = w.expand(2, nodes4_fi, ii, e, t_before)
            overflow += _push(stack, sp, ii, codes, enter & (codes >= 0), STACK_DEPTH)
            overflow += _push(queue, lq, ii, codes, enter & (codes < 0), cap)
        if anyhit and ended.numel():
            sp[ended] = 0
            lq[ended] = 0
    return w.result(overflow)


def traverse_lanes_plain(entries, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, anyhit=False,
                         stats=None):
    """Plain stackless skip-pointer walk over entry-major lane entries
    [E,16] (csrc/traverse_lanes.cu; fields in ops/lane_traverse.py).

    Returns (t, rnode, tri, u, v, bad) like traverse_rows_plain, except that
    an any-hit keeps its t (the reference's lane kernels do not poison it)
    and `bad` counts links that did not advance (0 on a well-formed table).
    Rays with tmax < 0 start at the end. A ray with a NaN tmax walks but
    can neither enter a box (its slab test caps tfar at NaN) nor accept a
    triangle (t < NaN is false), so it returns (tmax, -1, -1, 0, 0) like a
    negative one: every lane with !(tmax >= 0) does, which the kernel's
    compaction relies on to skip them.

    stats, a dict, receives the entry visits ("entries", of which
    "box_entries" internal and "tri_entries" triangle entries), a mask of
    the entries touched ("entry_rows"), the steps whose next entry is the
    one right after ("plus_one") and, for each window of W entries in
    LANE_WINDOWS, the kernel's dependent load rounds if it loads the
    aligned window of W entries that holds the current one and walks on
    from registers while the next entry lies in it ("rounds", W -> count;
    W = 1 counts every visit)."""
    dev = rox.device
    n = rox.shape[0]
    end = entries.shape[0]
    ix, iy, iz = _inv(rdx), _inv(rdy), _inv(rdz)
    t_best = tmax.clone()
    rn_best = torch.full((n,), -1.0, device=dev)
    tri_best = torch.full((n,), -1.0, device=dev)
    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    cur = torch.where(tmax < 0, end, 0).to(torch.int64)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    if stats is not None:
        for key in ("entries", "box_entries", "tri_entries", "plus_one"):
            stats.setdefault(key, 0)
        stats.setdefault("entry_rows", torch.zeros(end, dtype=torch.bool, device=dev))
        stats.setdefault("rounds", dict.fromkeys(LANE_WINDOWS, 0))
        window = {w: torch.full((n,), -1, dtype=torch.int64, device=dev) for w in LANE_WINDOWS}

    while True:
        act = torch.nonzero(cur < end).squeeze(1)
        if act.numel() == 0:
            break
        c = cur[act]
        f = entries[c]  # [K,16]
        tb = t_best[act]
        leaf = f[:, 11] > 0.5
        if stats is not None:
            stats["entries"] += act.numel()
            stats["tri_entries"] += int(leaf.sum())
            stats["box_entries"] += int((~leaf).sum())
            stats["entry_rows"][c] = True
            for w in LANE_WINDOWS:  # a new round where the entry left the last one's window
                stats["rounds"][w] += int((c // w != window[w][act]).sum())
                window[w][act] = c // w
        ro = (rox[act], roy[act], roz[act])
        bhit = _slab(f, 0, ro, (ix[act], iy[act], iz[act]), tb)
        ok, uu, vv, tt = _moller_trumbore(f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4], f[:, 5],
                                          f[:, 6], f[:, 7], f[:, 8], *ro,
                                          rdx[act], rdy[act], rdz[act])
        thit = (leaf & ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                & (tt > tmin[act]) & (tt < tb))
        t_best[act] = torch.where(thit, tt, tb)
        rn_best[act] = torch.where(thit, f[:, 12], rn_best[act])
        tri_best[act] = torch.where(thit, f[:, 13], tri_best[act])
        u_best[act] = torch.where(thit, uu, u_best[act])
        v_best[act] = torch.where(thit, vv, v_best[act])
        link = f[:, 9].long()
        nxt = torch.where(leaf, link, torch.where(bhit, c + 1, link))
        if anyhit:
            nxt = torch.where(thit, end, nxt)
        if stats is not None:
            stats["plus_one"] += int((nxt == c + 1).sum())
        stuck = nxt <= c
        bad += stuck.sum()
        cur[act] = torch.where(stuck, end, nxt)

    return (t_best, rn_best.to(torch.int32), tri_best.to(torch.int32), u_best, v_best, int(bad))


def _tri_intersect(v0, v1, v2, ro, rd, tmin, tmax):
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross3(rd, e2)
    det = dot3(e1, p)
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
    tvec = ro - v0
    u = dot3(tvec, p) * inv_det
    q = cross3(tvec, e1)
    v = dot3(rd, q) * inv_det
    t = dot3(e2, q) * inv_det
    hit = (torch.abs(det) >= 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    return hit, t, u, v


def intersect_brute(flat, ro, rd, tmin=0.0, chunk=64):
    """O(rays x tris x instances) closest hit in object space, for tests.

    flat: any object with the SceneFlat field names (numpy or tensors);
    ro/rd: [N,3] tensors, tested `chunk` rays at a time. Returns
    dict(t, rnode, tri, u, v)."""
    if ro.shape[0] > chunk:
        parts = [intersect_brute(flat, ro[i : i + chunk], rd[i : i + chunk], tmin, chunk)
                 for i in range(0, ro.shape[0], chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def tt(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=ro.device)

    vtx = tt(flat.vtx_pos)
    tri = tt(flat.tri_idx, torch.int64)
    w2o_all = tt(flat.rn_w2o)
    n = ro.shape[0]
    best_t = torch.full((n,), INFINITE, device=ro.device)
    best_rn = torch.full((n,), -1, dtype=torch.int32, device=ro.device)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=ro.device)
    best_u = torch.zeros(n, device=ro.device)
    best_v = torch.zeros(n, device=ro.device)
    v0, v1, v2 = vtx[tri[:, 0]][None], vtx[tri[:, 1]][None], vtx[tri[:, 2]][None]
    tids = torch.arange(tri.shape[0], device=ro.device)
    for i in range(w2o_all.shape[0]):
        w2o = w2o_all[i]
        o = w2o[:3, 0] * ro[:, 0:1] + w2o[:3, 1] * ro[:, 1:2] + w2o[:3, 2] * ro[:, 2:3] + w2o[:3, 3]
        d = w2o[:3, 0] * rd[:, 0:1] + w2o[:3, 1] * rd[:, 1:2] + w2o[:3, 2] * rd[:, 2:3]
        p = int(flat.rn_prim[i])
        first, count = int(flat.prim_first_tri[p]), int(flat.prim_tri_count[p])
        in_prim = (tids >= first) & (tids < first + count) & (int(flat.rn_visible[i]) > 0)
        hit, t, u, v = _tri_intersect(v0, v1, v2, o[:, None], d[:, None], tmin, INFINITE)
        t = torch.where(hit & in_prim[None], t, INFINITE)
        k = torch.argmin(t, dim=1)
        tk = t.gather(1, k[:, None])[:, 0]
        better = tk < best_t
        best_t = torch.where(better, tk, best_t)
        best_rn = torch.where(better, i, best_rn)
        best_tri = torch.where(better, k.to(torch.int32), best_tri)
        best_u = torch.where(better, u.gather(1, k[:, None])[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, k[:, None])[:, 0], best_v)
    return {"t": best_t, "rnode": best_rn, "tri": best_tri, "u": best_u, "v": best_v}
