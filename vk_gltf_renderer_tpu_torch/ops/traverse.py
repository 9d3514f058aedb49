"""Small-vector helpers, the plain BVH4 traversal and the brute-force oracle.

traverse_bvh4_plain is the plain PyTorch version of the traversal kernel
(csrc/traverse_bvh4.cu, wrapped by ops/traverse_bvh4.py): a per-ray stack
traversal over the fused BVH4 rows, vectorised over rays (stack tensor
[N, STACK_DEPTH], one loop iteration pops one entry of every ray whose
stack is non-empty). It carries over exactly the arithmetic of the
reference kernel body (vk_gltf_renderer_tpu/ops/pallas_traverse.py
_traverse3_core): the inv() clamp, the slab test with tnear floored at 0
and tfar capped at t_best, the leaf decoding and Moller-Trumbore with the
1e-12 determinant guard. It differs from the packet kernels only in order
(near-first by each ray's own direction signs, not a packet vote), which
changes nothing but equal-t ties.

intersect_brute is the test oracle (reference ops/traverse.py:222).
"""

from __future__ import annotations

import torch

INFINITE = 1e32
STACK_DEPTH = 64
LEAF_SLOTS = 8  # triangles per tris128 row


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
    """Child box `o` of the fetched rows f [K,32] against the rays."""
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


def traverse_bvh4_plain(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz,
                        tmin, tmax, anyhit=False):
    """Plain per-ray BVH4 traversal.

    All ray inputs are [N] f32. Returns (t, rnode, tri, u, v, overflow):
    t [N] f32 is the best t (tmax where nothing was accepted, -1 after an
    any-hit), rnode/tri [N] i32 (-1 = no hit), u/v [N] f32, and overflow
    the number of stack pushes dropped because a stack was full (0 unless
    a tree is deeper than STACK_DEPTH allows). Any-hit stops a ray at its
    first accepted hit. Rays with tmax < 0 miss at the root."""
    dev = rox.device
    n = rox.shape[0]
    ix, iy, iz = _inv(rdx), _inv(rdy), _inv(rdz)
    sgn = torch.stack([rdx >= 0, rdy >= 0, rdz >= 0], dim=1)  # [N,3]

    t_best = tmax.clone()
    rn_best = torch.full((n,), -1.0, device=dev)
    tri_best = torch.full((n,), -1.0, device=dev)
    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack[:, 0] = int(root_code)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    arange8 = torch.arange(LEAF_SLOTS, device=dev)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        e = stack[act, sp[act]]

        leaf = e < 0
        li = act[leaf]
        if li.numel():
            code = -e[leaf] - 1
            row = torch.div(code, 16, rounding_mode="floor")
            cnt = code - row * 16
            tv = tris128[row].reshape(-1, LEAF_SLOTS, 16)
            ox, oy, oz = rox[li, None], roy[li, None], roz[li, None]
            dx, dy, dz = rdx[li, None], rdy[li, None], rdz[li, None]
            v0x, v0y, v0z = tv[..., 0], tv[..., 1], tv[..., 2]
            e1x, e1y, e1z = tv[..., 3] - v0x, tv[..., 4] - v0y, tv[..., 5] - v0z
            e2x, e2y, e2z = tv[..., 6] - v0x, tv[..., 7] - v0y, tv[..., 8] - v0z
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok = (arange8[None, :] < cnt[:, None]) & (torch.abs(det) >= 1e-12)
            inv_det = 1.0 / torch.where(torch.abs(det) >= 1e-12, det, 1.0)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            uu = (tvx * px + tvy * py + tvz * pz) * inv_det
            qx = tvy * e1z - tvz * e1y
            qy = tvz * e1x - tvx * e1z
            qz = tvx * e1y - tvy * e1x
            vv = (dx * qx + dy * qy + dz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            cand = ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > tmin[li, None])
            tb, rb, trb = t_best[li], rn_best[li], tri_best[li]
            ub, vb = u_best[li], v_best[li]
            for c in range(LEAF_SLOTS):  # in slot order, strict '<': first wins ties
                hit = cand[:, c] & (tt[:, c] < tb)
                tb = torch.where(hit, -1.0 if anyhit else tt[:, c], tb)
                rb = torch.where(hit, tv[:, c, 9], rb)
                trb = torch.where(hit, tv[:, c, 10], trb)
                ub = torch.where(hit, uu[:, c], ub)
                vb = torch.where(hit, vv[:, c], vb)
            t_best[li], rn_best[li], tri_best[li] = tb, rb, trb
            u_best[li], v_best[li] = ub, vb
            if anyhit:
                sp[li[trb >= 0]] = 0

        ii = act[~leaf]
        if ii.numel():
            f = nodes4_fi[e[~leaf]]  # [K,32]
            ro = (rox[ii], roy[ii], roz[ii])
            inv_d = (ix[ii], iy[ii], iz[ii])
            tb = t_best[ii]
            a0, a1, a2, a3 = (_slab(f, o, ro, inv_d, tb) for o in (0, 6, 12, 18))
            c0, c1, c2, c3 = (f[:, 24 + j].long() for j in range(4))
            s = torch.gather(sgn[ii], 1, f[:, 28:31].long())  # sign of each near-order axis
            s0, s1, s2 = s[:, 0], s[:, 1], s[:, 2]
            ln_id, lf_id = torch.where(s1, c0, c1), torch.where(s1, c1, c0)
            ln_a, lf_a = torch.where(s1, a0, a1), torch.where(s1, a1, a0)
            rn_id, rf_id = torch.where(s2, c2, c3), torch.where(s2, c3, c2)
            rn_a, rf_a = torch.where(s2, a2, a3), torch.where(s2, a3, a2)
            pushes = (
                (torch.where(s0, rf_id, lf_id), torch.where(s0, rf_a, lf_a)),
                (torch.where(s0, rn_id, ln_id), torch.where(s0, rn_a, ln_a)),
                (torch.where(s0, lf_id, rf_id), torch.where(s0, lf_a, rf_a)),
                (torch.where(s0, ln_id, rn_id), torch.where(s0, ln_a, rn_a)),
            )
            spi = sp[ii]
            for pid, pa in pushes:  # far first: the nearest child is popped next
                full = pa & (spi >= STACK_DEPTH)
                overflow += full.sum()
                push = pa & ~full
                stack[ii[push], spi[push]] = pid[push]
                spi = spi + push.long()
            sp[ii] = spi

    return (t_best, rn_best.to(torch.int32), tri_best.to(torch.int32), u_best, v_best,
            int(overflow))


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
