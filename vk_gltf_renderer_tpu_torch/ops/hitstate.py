"""Hit-state reconstruction from the fused per-world-triangle rows.

Host half: bake_hit_attrs_np / narrow_attr_ok, numpy copies of the
reference's build-time bake (vk_gltf_renderer_tpu/ops/hitstate.py:202-330),
with the barycentric remap of subtriangle rows (attr_bary, the virtual rows
ops/bvh_flatten.build_world_bvh emits for split alpha-tested triangles).
bake_hit_attrs is the refit-time bake of the reference's _refit_device on
tensors (:333, jitted there), with the same remap.

Device half: get_hit_state_fused (reference :341) and safe_offset_ray
(:417) on torch tensors. One row gather per lane, then world-space math.

Row layout (HIT_ATTR_COLS = 64):
   0:9  n0,n1,n2 world corner normals     9:18 t0,t1,t2 world corner tangents
  18    tangent handedness                19:25 uv0 a,b,c     25:31 uv1 a,b,c
  31:43 color a,b,c                       43 texel density
  44:53 p0,p1,p2 world corner positions   53 sign(det(o2w))
Narrow rows (32, scenes without textures or vertex colors):
   0:18 as above, 18 handedness, 19:28 p0,p1,p2, 28 sign.
"""

from __future__ import annotations

import numpy as np
import torch

from .traverse import cross3, dot3

HIT_ATTR_COLS = 64
HIT_ATTR_COLS_NARROW = 32


def _bake_hit_attrs(vtx_packed, tri_idx, rn_packed, attr_rnode, attr_tri, attr_has_uv, attr_bary,
                    narrow=False):
    idx = tri_idx[attr_tri]  # [Ta,3]
    rn_row = rn_packed[attr_rnode]  # [Ta,32]
    o2w = rn_row[:, :16].reshape(-1, 4, 4)
    w2o = rn_row[:, 16:32].reshape(-1, 4, 4)
    va = vtx_packed[idx[:, 0]]
    vb = vtx_packed[idx[:, 1]]
    vc = vtx_packed[idx[:, 2]]
    # every per-corner attribute is linear over the triangle: a subtriangle row recombines
    # its parent's corners at its own barycentric corners; handedness keeps corner a's
    tanw = va[:, 9:10]

    def interp(bu, bv):
        w = (1.0 - bu - bv)[:, None]
        return va * w + vb * bu[:, None] + vc * bv[:, None]

    va2 = interp(attr_bary[:, 0], attr_bary[:, 1])
    vb2 = interp(attr_bary[:, 2], attr_bary[:, 3])
    vc2 = interp(attr_bary[:, 4], attr_bary[:, 5])
    va2[:, 9:10] = tanw
    vb2[:, 9:10] = tanw
    vc2[:, 9:10] = tanw
    va, vb, vc = va2, vb2, vc2

    def xf_point(p):
        return (o2w[:, :3, 0] * p[:, 0:1] + o2w[:, :3, 1] * p[:, 1:2]
                + o2w[:, :3, 2] * p[:, 2:3] + o2w[:, :3, 3])

    def xf_dir(d):
        return o2w[:, :3, 0] * d[:, 0:1] + o2w[:, :3, 1] * d[:, 1:2] + o2w[:, :3, 2] * d[:, 2:3]

    def xf_nrm(n):
        return w2o[:, 0, :3] * n[:, 0:1] + w2o[:, 1, :3] * n[:, 1:2] + w2o[:, 2, :3] * n[:, 2:3]

    p0, p1, p2 = xf_point(va[:, 0:3]), xf_point(vb[:, 0:3]), xf_point(vc[:, 0:3])
    n0, n1, n2 = xf_nrm(va[:, 3:6]), xf_nrm(vb[:, 3:6]), xf_nrm(vc[:, 3:6])
    t0, t1, t2 = xf_dir(va[:, 6:9]), xf_dir(vb[:, 6:9]), xf_dir(vc[:, 6:9])

    wc = np.cross(p1 - p0, p2 - p0)
    w_area = np.sqrt(np.maximum((wc * wc).sum(-1), 1e-20))
    duv1 = vb[:, 10:12] - va[:, 10:12]
    duv2 = vc[:, 10:12] - va[:, 10:12]
    uv_area = np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    texel_density = np.where(attr_has_uv > 0, np.sqrt(np.maximum(uv_area, 1e-20) / w_area),
                             np.zeros_like(w_area))
    m = o2w[:, :3, :3]
    det = (
        m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
        - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
        + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0])
    )
    geo_sign = np.where(det < 0, -1.0, 1.0)

    if narrow:
        cols = [n0, n1, n2, t0, t1, t2, va[:, 9:10], p0, p1, p2, geo_sign[:, None],
                np.zeros((va.shape[0], HIT_ATTR_COLS_NARROW - 29), va.dtype)]
    else:
        cols = [
            n0, n1, n2, t0, t1, t2, va[:, 9:10],
            va[:, 10:12], vb[:, 10:12], vc[:, 10:12],
            va[:, 12:14], vb[:, 12:14], vc[:, 12:14],
            va[:, 14:18], vb[:, 14:18], vc[:, 14:18],
            texel_density[:, None], p0, p1, p2, geo_sign[:, None],
            np.zeros((va.shape[0], HIT_ATTR_COLS - 54), va.dtype),
        ]
    return np.concatenate(cols, axis=1).astype(np.float32)


def narrow_attr_ok(flat) -> bool:
    """Narrow rows are image-identical iff the texture pool is the 1x1
    white fallback and every vertex color is 1 (reference :298)."""
    td = np.asarray(flat.tex_desc)
    untextured = td.shape[0] == 1 and int(td[0, 1]) == 1 and int(td[0, 2]) == 1
    colors_const = bool((np.asarray(flat.vtx_packed)[:, 14:18] == 1.0).all())
    return untextured and colors_const


def bake_hit_attrs_np(flat, attr_rnode, attr_tri, attr_bary, narrow=False):
    """Build-time bake. Returns (hit_attr [Ta,64|32] f32, has_uv [Ta] i32).
    attr_bary [Ta,6] (identity rows for whole triangles) as bake_hit_attrs."""
    has_uv = np.asarray(flat.prim_has_uv0)[np.asarray(flat.rn_prim)[attr_rnode]]
    out = _bake_hit_attrs(np.asarray(flat.vtx_packed, np.float32), np.asarray(flat.tri_idx),
                          np.asarray(flat.rn_packed, np.float32), attr_rnode, attr_tri, has_uv,
                          np.asarray(attr_bary, np.float32), narrow=narrow)
    return out, has_uv.astype(np.int32)


def _fma(a, b, c):
    """a * b + c rounded once to f32 (through f64, where a * b is exact)."""
    return (a.double() * b.double() + c.double()).float()


def bake_hit_attrs(vtx_packed, tri_idx, rn_packed, attr_rnode, attr_tri, attr_has_uv,
                   narrow=False, attr_bary=None):
    """Refit-time bake on tensors (reference bake_hit_attrs, jitted by its
    renderer's _refit_device): the rows of bake_hit_attrs_np from deformed
    vertices (vtx_packed [V,24]) and moved instances (rn_packed [N,32]).
    attr_bary [Ta,6] recombines each row's corners at its barycentric
    corners (identity rows pass through).

    The float order is that of XLA's CPU build of the reference's bake,
    which the build-time numpy bake does not share: the matrix-vector
    products, the cross product and its squared norm use fused
    multiply-adds (emulated through f64), and column 43 (texel density,
    sqrt(max(uv_area, 1e-20) / w_area) with w_area = sqrt(max(|e1 x e2|^2,
    1e-20))) divides by the square root as a product with its reciprocal
    square root. XLA's rsqrt is an approximation (not correctly rounded);
    this one is, so column 43 can still differ from the reference's in the
    last ulps (ROADMAP C)."""
    idx = tri_idx[attr_tri]  # [Ta,3]
    rn_row = rn_packed[attr_rnode]  # [Ta,32]
    o2w = rn_row[:, :16].reshape(-1, 4, 4)
    w2o = rn_row[:, 16:32].reshape(-1, 4, 4)
    va = vtx_packed[idx[:, 0]]
    vb = vtx_packed[idx[:, 1]]
    vc = vtx_packed[idx[:, 2]]
    if attr_bary is not None:
        tanw = va[:, 9:10]

        def interp(bu, bv):
            w = (1.0 - bu - bv)[:, None]
            return va * w + vb * bu[:, None] + vc * bv[:, None]

        va, vb, vc = (torch.cat([x[:, :9], tanw, x[:, 10:]], dim=1) for x in (
            interp(attr_bary[:, 0], attr_bary[:, 1]), interp(attr_bary[:, 2], attr_bary[:, 3]),
            interp(attr_bary[:, 4], attr_bary[:, 5])))

    def xf(m0, m1, m2, v):  # m0 v0 + m1 v1 + m2 v2 with the two adds fused, as XLA's CPU build fuses them
        return _fma(m2, v[:, 2:3], _fma(m1, v[:, 1:2], m0 * v[:, 0:1]))

    def xf_point(p):
        return xf(o2w[:, :3, 0], o2w[:, :3, 1], o2w[:, :3, 2], p) + o2w[:, :3, 3]

    def xf_dir(d):
        return xf(o2w[:, :3, 0], o2w[:, :3, 1], o2w[:, :3, 2], d)

    def xf_nrm(n):
        return xf(w2o[:, 0, :3], w2o[:, 1, :3], w2o[:, 2, :3], n)

    p0, p1, p2 = xf_point(va[:, 0:3]), xf_point(vb[:, 0:3]), xf_point(vc[:, 0:3])
    n0, n1, n2 = xf_nrm(va[:, 3:6]), xf_nrm(vb[:, 3:6]), xf_nrm(vc[:, 3:6])
    t0, t1, t2 = xf_dir(va[:, 6:9]), xf_dir(vb[:, 6:9]), xf_dir(vc[:, 6:9])

    e1, e2 = p1 - p0, p2 - p0
    wc = [_fma(e1[:, i], e2[:, j], -(e1[:, j] * e2[:, i])) for i, j in ((1, 2), (2, 0), (0, 1))]
    wsq = _fma(wc[2], wc[2], _fma(wc[1], wc[1], wc[0] * wc[0]))
    inv_w_area = (1.0 / torch.sqrt(torch.clamp(wsq, min=1e-20).double())).float()
    duv1 = vb[:, 10:12] - va[:, 10:12]
    duv2 = vc[:, 10:12] - va[:, 10:12]
    uv_area = torch.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    # square roots through f64, rounded once: torch's vectorised f32 sqrt on the CPU is not
    # always correctly rounded
    texel_density = torch.where(attr_has_uv > 0,
                                torch.sqrt((torch.clamp(uv_area, min=1e-20) * inv_w_area).double()).float(),
                                torch.zeros_like(uv_area))
    m = o2w[:, :3, :3]
    det = (
        m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
        - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
        + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0])
    )
    geo_sign = torch.where(det < 0, -1.0, 1.0).to(va.dtype)
    if narrow:
        cols = [n0, n1, n2, t0, t1, t2, va[:, 9:10], p0, p1, p2, geo_sign[:, None],
                va.new_zeros((va.shape[0], HIT_ATTR_COLS_NARROW - 29))]
    else:
        cols = [
            n0, n1, n2, t0, t1, t2, va[:, 9:10],
            va[:, 10:12], vb[:, 10:12], vc[:, 10:12],
            va[:, 12:14], vb[:, 12:14], vc[:, 12:14],
            va[:, 14:18], vb[:, 14:18], vc[:, 14:18],
            texel_density[:, None], p0, p1, p2, geo_sign[:, None],
            va.new_zeros((va.shape[0], HIT_ATTR_COLS - 54)),
        ]
    return torch.cat(cols, dim=1).float()


def _normalize(v):
    return v / torch.clamp(torch.sqrt(dot3(v, v)), min=1e-20)[..., None]


def get_hit_state_fused(hit_attr, rn_attr_base, hit, ray_dir):
    """Shading frame at hit points from the baked rows.

    hit: dict(t, rnode, tri, u, v) of [N] tensors; lanes with tri < 0 give
    values the caller masks. Returns dict(pos, nrm, geonrm, shadow_pos,
    tangent, bitangent, uv0, uv1, color, texel_density, front_face)."""
    tri = torch.clamp(hit["tri"], min=0).long()
    rnode = torch.clamp(hit["rnode"], min=0).long()
    row_id = torch.clamp(rn_attr_base[rnode].long() + tri, 0, hit_attr.shape[0] - 1)
    row = hit_attr[row_id]
    narrow = hit_attr.shape[-1] == HIT_ATTR_COLS_NARROW

    u = hit["u"][..., None]
    v = hit["v"][..., None]
    w = 1.0 - u - v

    n0, n1, n2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    t0, t1, t2 = row[..., 9:12], row[..., 12:15], row[..., 15:18]
    if narrow:
        p0, p1, p2 = row[..., 19:22], row[..., 22:25], row[..., 25:28]
        geo_sign = row[..., 28:29]
    else:
        p0, p1, p2 = row[..., 44:47], row[..., 47:50], row[..., 50:53]
        geo_sign = row[..., 53:54]

    pos = p0 * w + p1 * u + p2 * v
    geonrm = _normalize(cross3(p1 - p0, p2 - p0)) * geo_sign
    nrm = _normalize(n0 * w + n1 * u + n2 * v)

    front_face = dot3(geonrm, ray_dir) < 0.0
    side = torch.where(front_face, 1.0, -1.0)[..., None]

    # shadow-terminator offset (Hanika 2021) with unit corner normals
    n0h, n1h, n2h = _normalize(n0) * side, _normalize(n1) * side, _normalize(n2) * side
    du = torch.clamp(dot3(pos - p0, n0h), max=0.0)[..., None] * n0h
    dv = torch.clamp(dot3(pos - p1, n1h), max=0.0)[..., None] * n1h
    dw = torch.clamp(dot3(pos - p2, n2h), max=0.0)[..., None] * n2h
    shadow_pos = pos - (w * du + u * dv + v * dw)

    if narrow:
        uv0 = torch.zeros(row.shape[:-1] + (2,), dtype=row.dtype, device=row.device)
        uv1 = uv0
        color = torch.ones(row.shape[:-1] + (4,), dtype=row.dtype, device=row.device)
        texel_density = torch.zeros(row.shape[:-1], dtype=row.dtype, device=row.device)
    else:
        uv0 = row[..., 19:21] * w + row[..., 21:23] * u + row[..., 23:25] * v
        uv1 = row[..., 25:27] * w + row[..., 27:29] * u + row[..., 29:31] * v
        color = row[..., 31:35] * w + row[..., 35:39] * u + row[..., 39:43] * v
        texel_density = row[..., 43]

    tangent = _normalize(t0 * w + t1 * u + t2 * v)
    tangent = _normalize(tangent - nrm * dot3(nrm, tangent)[..., None])
    bitangent = cross3(nrm, tangent) * row[..., 18:19]

    geonrm = torch.where(front_face[..., None], geonrm, -geonrm)
    flip_sh = (dot3(geonrm, nrm) < 0.0)[..., None]
    nrm = torch.where(flip_sh, -nrm, nrm)
    tangent = torch.where(flip_sh, -tangent, tangent)
    bitangent = torch.where(flip_sh, -bitangent, bitangent)

    # low-tessellation internal-reflection guard
    r = ray_dir - 2.0 * dot3(ray_dir, nrm)[..., None] * nrm
    nrm = torch.where((dot3(r, geonrm) < 0.0)[..., None], geonrm, nrm)

    return {
        "pos": pos,
        "nrm": nrm,
        "geonrm": geonrm,
        "shadow_pos": shadow_pos,
        "tangent": tangent,
        "bitangent": bitangent,
        "uv0": uv0,
        "uv1": uv1,
        "color": color,
        "texel_density": texel_density,
        "front_face": front_face,
    }


def safe_offset_ray(pos, offset_dir):
    """Self-intersection offset, Wachter & Binder 2019: integer-ULP nudge
    scaled by magnitude (bitcasts, not value casts), float fallback near
    the origin."""
    int_scale = (256.0 * offset_dir).to(torch.int32)
    pi = pos.contiguous().view(torch.int32)
    moved = (pi + torch.where(pos < 0, -int_scale, int_scale)).view(torch.float32)
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    return torch.where(torch.abs(pos) < origin, pos + float_scale * offset_dir, moved)
