"""Opacity classification: a jax-free copy of vk_gltf_renderer_tpu/ops/omm.py
(the reference's SceneOmm role, gltf_scene_omm.{hpp,cpp}: per-triangle
opacity micromaps that let alpha-tested traversal skip any-hit work with
an identical image). tests/test_torch_host.py holds every function's
source equal to its original's and tests/test_torch_alpha.py their
outputs, bit for bit.

Re-cast as a build-time CONSERVATIVE per-triangle alpha classification:

  OPAQUE       the triangle's opacity (get_opacity semantics: baseColor
               alpha x mip-0 texture alpha x interpolated vertex alpha,
               MASK thresholded at cutoff) is >= 1 EVERYWHERE on the
               triangle -> a hit can never be rejected; the re-trace
               rounds skip it without evaluating opacity.
  TRANSPARENT  opacity is 0 everywhere -> the triangle can never occlude;
               it is culled from the world BVH at build (fewer tris,
               smaller tables, identical image: a 0-opacity hit always
               passes through).
  MIXED        everything else -> exact stochastic-alpha path as before.

Conservativeness: texture alpha bounds come from min/max mip pyramids over
the DILATED texel bbox of the triangle's transformed UV footprint (+-1
texel for bilinear support); vertex alpha bounds are the corner min/max
(barycentric interpolation is bounded by its corners); any UV footprint
wider than one wrap period falls back to the whole-texture bounds. A
triangle is only ever classified away from MIXED when the bound PROVES it,
so no hit that could occlude is lost. classify_subtri does the same per
cell of the level-2 subdivision (subtri_corners), which
ops/bvh_flatten.build_world_bvh splits MIXED triangles into. The image
equals the unclassified path's where every alpha decision is MASK (0 or 1)
and no ray meets more rejecting surfaces than the path tracer's
alpha_rounds: culled surfaces take no round, so classification shifts the
round (and the uniform) that decides a BLEND surface, and lets a ray reach
surfaces the unclassified path's rounds do not (ROADMAP.md C).
"""

from __future__ import annotations

import numpy as np

ALPHA_OPAQUE = 0
ALPHA_MIXED = 1
ALPHA_TRANSPARENT = 2


_CELLS = 16  # rect queries cover <= _CELLS+1 pyramid cells per axis


def _minmax_bounds(alpha, x0, x1, y0, y1):
    """Conservative (min, max) of alpha[y, x] over inclusive texel rects
    [x0,x1]x[y0,y1] (already folded into [0, size)). Vectorized over
    triangles via min/max pyramids (ceil-pooled, conservative): pick the
    level where the rect spans <= _CELLS cells and reduce over the up to
    (_CELLS+1)^2 covering cells. Cell alignment over-covers each edge by
    < 2^level texels (~1/_CELLS of the span) — conservative in the safe
    direction, tight enough to classify away from alpha boundaries."""
    h, w = alpha.shape
    mins, maxs = [alpha], [alpha]
    while mins[-1].shape[0] > 1 or mins[-1].shape[1] > 1:
        m = mins[-1]
        M = maxs[-1]
        ph = (m.shape[0] + 1) // 2 * 2
        pw = (m.shape[1] + 1) // 2 * 2
        mp = np.full((ph, pw), np.inf, np.float32)
        Mp = np.full((ph, pw), -np.inf, np.float32)
        mp[: m.shape[0], : m.shape[1]] = m
        Mp[: M.shape[0], : M.shape[1]] = M
        mins.append(np.minimum.reduce([mp[0::2, 0::2], mp[0::2, 1::2], mp[1::2, 0::2], mp[1::2, 1::2]]))
        maxs.append(np.maximum.reduce([Mp[0::2, 0::2], Mp[0::2, 1::2], Mp[1::2, 0::2], Mp[1::2, 1::2]]))

    n = x0.shape[0]
    span = np.maximum(x1 - x0, y1 - y0)
    lvl = np.clip(
        np.ceil(np.log2(np.maximum((span + 1 + _CELLS - 1) // _CELLS, 1))).astype(np.int64),
        0, len(mins) - 1,
    )
    lo = np.ones(n, np.float32)
    hi = np.zeros(n, np.float32)
    for k in range(len(mins)):
        sel = lvl == k
        if not sel.any():
            continue
        mk, Mk = mins[k], maxs[k]
        ch, cw = mk.shape
        cx0 = np.clip(x0[sel] >> k, 0, cw - 1)
        cx1 = np.clip(x1[sel] >> k, 0, cw - 1)
        cy0 = np.clip(y0[sel] >> k, 0, ch - 1)
        cy1 = np.clip(y1[sel] >> k, 0, ch - 1)
        l = np.ones(cx0.shape[0], np.float32)
        h_ = np.zeros(cx0.shape[0], np.float32)
        for dy in range(_CELLS + 1):
            cy = np.minimum(cy0 + dy, cy1)
            for dx in range(_CELLS + 1):
                cx = np.minimum(cx0 + dx, cx1)
                l = np.minimum(l, mk[cy, cx])
                h_ = np.maximum(h_, Mk[cy, cx])
        lo[sel] = l
        hi[sel] = h_
    return lo, hi


def _tex_alpha_bounds(flat, img_idx, u, v):
    """Conservative per-triangle (min, max) of the mip-0 texture alpha over
    transformed UV corners u, v [n, 3] for ONE image index. Wrap (REPEAT)
    handled by folding; footprints spanning >= 1 period use global bounds."""
    mip0 = np.asarray(flat.tex_desc)[np.asarray(flat.tex_mip_table)[img_idx, 0]]
    off, w, h = int(mip0[0]), int(mip0[1]), int(mip0[2])
    alpha = np.asarray(flat.tex_texels)[off : off + w * h, 3].reshape(h, w)

    u0 = u.min(axis=1)
    u1 = u.max(axis=1)
    v0 = v.min(axis=1)
    v1 = v.max(axis=1)
    wide = ((u1 - u0) >= 1.0) | ((v1 - v0) >= 1.0)

    # fold to [0,1): bbox start wraps; the end may cross the seam, which the
    # +-1-texel dilation plus modular indexing below handles for spans < 1
    fu0 = u0 - np.floor(u0)
    fv0 = v0 - np.floor(v0)
    fu1 = fu0 + (u1 - u0)
    fv1 = fv0 + (v1 - v0)
    # texel ranges matching _fetch_bilinear exactly: a sample at t touches
    # texels floor(t*size - 0.5) and floor(t*size - 0.5) + 1, wrapped
    x0 = np.floor(fu0 * w - 0.5).astype(np.int64)
    x1 = np.floor(fu1 * w - 0.5).astype(np.int64) + 1
    y0 = np.floor(fv0 * h - 0.5).astype(np.int64)
    y1 = np.floor(fv1 * h - 0.5).astype(np.int64) + 1
    wide |= (x1 - x0) >= w
    wide |= (y1 - y0) >= h

    glo, ghi = float(alpha.min()), float(alpha.max())
    n = u.shape[0]
    lo = np.full(n, glo, np.float32)
    hi = np.full(n, ghi, np.float32)
    nar = ~wide
    if nar.any():
        # a wrapped rect decomposes into <= 2 spans per axis; query each
        # combination and combine (conservative)
        def spans(a0, a1, size):
            a0m = a0 % size
            a1m = a1 % size
            crosses = a0m > a1m
            s1 = (a0m, np.where(crosses, size - 1, a1m))
            s2 = (np.zeros_like(a0m), a1m)  # only meaningful when crosses
            return s1, s2, crosses

        (xs1, xs2, xc) = spans(x0[nar], x1[nar], w)
        (ys1, ys2, yc) = spans(y0[nar], y1[nar], h)
        l = np.ones(nar.sum(), np.float32)
        h_ = np.zeros(nar.sum(), np.float32)
        for xa, xb, xm in ((xs1[0], xs1[1], None), (xs2[0], xs2[1], xc)):
            for ya, yb, ym in ((ys1[0], ys1[1], None), (ys2[0], ys2[1], yc)):
                li, hi_ = _minmax_bounds(alpha, xa, xb, ya, yb)
                m = np.ones(li.shape, bool)
                if xm is not None:
                    m &= xm
                if ym is not None:
                    m &= ym
                l = np.where(m, np.minimum(l, li), l)
                h_ = np.where(m, np.maximum(h_, hi_), h_)
        lo[nar] = l
        hi[nar] = h_
    return lo, hi


def subtri_corners(level: int = 2):
    """Barycentric corners of the 4**level regular subdivision cells.

    Returns [4**level, 3, 2] float32: per cell, the parent-(u,v) of its 3
    corners. Cell enumeration (s = 2**level): upright cell (a, b) has
    corners (a,b) (a+1,b) (a,b+1) all /s; inverted cell (a, b) has corners
    (a+1,b) (a+1,b+1) (a,b+1) /s — the same uniform subdivision
    VK_EXT_opacity_micromap indexes (gltf_scene_omm.cpp:1-391 builds per-
    micromap subdivision levels; the space-filling bird curve ordering is
    irrelevant here because cells are only addressed through this table)."""
    s = 1 << level
    cells = []
    for b in range(s):
        for a in range(s - b):
            cells.append(((a, b), (a + 1, b), (a, b + 1)))
            if a + b <= s - 2:
                cells.append(((a + 1, b), (a + 1, b + 1), (a, b + 1)))
    out = np.asarray(cells, np.float32) / float(s)
    assert out.shape[0] == s * s
    return out


def classify_subtri(flat, tri_class, level: int = 2):
    """Per-cell conservative opacity classes for MIXED rows.

    tri_class: the whole-triangle classes from classify_attr_alpha (same
    emit order). Returns [Ta, 4**level] int8 — rows that are not MIXED get
    every cell stamped with the whole-row class; MIXED rows get per-cell
    classes from the same conservative min/max-mip texture bounds + corner
    vertex-alpha bounds, evaluated over each cell's (linearly interpolated)
    UV footprint. A cell is only classified away from MIXED when the bound
    PROVES it (same argument as the whole-triangle pass), so consuming the
    cells can never change which hits are possible.

    Reference role: the subdivision-level micromap build of
    gltf_scene_omm.cpp (VkMicromapEXT triangles at subdivision level 2)."""
    from .flat import MAT_LAYOUT, _init_mat_layout

    _init_mat_layout()
    mp = np.asarray(flat.mat_packed)

    def mfield(name):
        off, w = MAT_LAYOUT[name]
        return mp[:, off] if w == 1 else mp[:, off : off + w]

    alpha_mode = mfield("alpha_mode").astype(np.int64)
    cutoff = mfield("alpha_cutoff")
    bc_a = mfield("base_color_factor")[:, 3]
    slot = mfield("base_color_texture").astype(np.int64)

    rn_mat = np.asarray(flat.rn_material)
    rn_prim = np.asarray(flat.rn_prim)
    pft = np.asarray(flat.prim_first_tri)
    ptc = np.asarray(flat.prim_tri_count)
    tri_idx = np.asarray(flat.tri_idx)
    uv0 = np.asarray(flat.vtx_uv0)
    uv1 = np.asarray(flat.vtx_uv1)
    vca = np.asarray(flat.vtx_color)[:, 3]

    ti_index = np.asarray(flat.ti_index)
    ti_texcoord = np.asarray(flat.ti_texcoord)
    ti_uvxform = np.asarray(flat.ti_uvxform)
    rn_visible = np.asarray(flat.rn_visible)

    bary = subtri_corners(level)  # [m,3,2]
    m_cells = bary.shape[0]
    w0 = 1.0 - bary[:, :, 0] - bary[:, :, 1]  # [m,3]
    w1 = bary[:, :, 0]
    w2 = bary[:, :, 1]

    chunks = []
    off = 0
    for i in range(rn_mat.shape[0]):
        if not rn_visible[i]:
            continue
        p = int(rn_prim[i])
        f, c = int(pft[p]), int(ptc[p])
        cls_tri = np.asarray(tri_class[off : off + c])
        off += c
        cells = np.repeat(cls_tri[:, None], m_cells, axis=1).astype(np.int8)
        mixed = cls_tri == ALPHA_MIXED
        mid = int(rn_mat[i])
        if mixed.any() and alpha_mode[mid] != 0:
            idx = tri_idx[f : f + c][mixed]  # [k,3]
            k = idx.shape[0]
            va = vca[idx]  # [k,3] corner vertex alpha
            # cell-corner values by barycentric interpolation (linear ->
            # corner min/max bounds the cell exactly)
            cva = (va[:, None, 0, None] * w0[None] + va[:, None, 1, None] * w1[None]
                   + va[:, None, 2, None] * w2[None])  # [k,m,3]
            va_lo = cva.min(axis=2).ravel()
            va_hi = cva.max(axis=2).ravel()
            s_ = int(slot[mid])
            if s_ > 0 and int(ti_index[s_]) >= 0:
                uv = uv1 if int(ti_texcoord[s_]) == 1 else uv0
                xf = ti_uvxform[s_]
                cu = uv[idx][:, :, 0]  # [k,3] parent corner u
                cv = uv[idx][:, :, 1]
                tu = xf[0, 0] * cu + xf[0, 1] * cv + xf[0, 2]
                tv = xf[1, 0] * cu + xf[1, 1] * cv + xf[1, 2]
                # cell-corner UVs, flattened to [k*m, 3] rect queries
                cu_c = (tu[:, None, 0, None] * w0[None] + tu[:, None, 1, None] * w1[None]
                        + tu[:, None, 2, None] * w2[None]).reshape(-1, 3)
                cv_c = (tv[:, None, 0, None] * w0[None] + tv[:, None, 1, None] * w1[None]
                        + tv[:, None, 2, None] * w2[None]).reshape(-1, 3)
                ta_lo, ta_hi = _tex_alpha_bounds(flat, int(ti_index[s_]), cu_c, cv_c)
            else:
                ta_lo = np.ones(k * m_cells, np.float32)
                ta_hi = np.ones(k * m_cells, np.float32)
            a_lo = (bc_a[mid] * ta_lo * va_lo).reshape(k, m_cells)
            a_hi = (bc_a[mid] * ta_hi * va_hi).reshape(k, m_cells)
            cc = np.full((k, m_cells), ALPHA_MIXED, np.int8)
            if alpha_mode[mid] == 1:
                cc[a_lo >= cutoff[mid]] = ALPHA_OPAQUE
                cc[a_hi < cutoff[mid]] = ALPHA_TRANSPARENT
            else:
                cc[a_lo >= 1.0] = ALPHA_OPAQUE
                cc[a_hi <= 0.0] = ALPHA_TRANSPARENT
            cells[mixed] = cc
        chunks.append(cells)
    if not chunks:
        return np.zeros((0, m_cells), np.int8)
    return np.concatenate(chunks)


def classify_attr_alpha(flat):
    """Per-(render node, triangle) conservative opacity class over the
    fused hit-attr emit order (row = rn_attr_base[rnode] + tri): int8 array
    [sum of per-node tri counts] with ALPHA_OPAQUE / MIXED / TRANSPARENT.

    Reference role: SceneOmm micromap build (gltf_scene_omm.cpp) — here the
    classification granularity is the whole triangle (micromap level 0)."""
    from .flat import MAT_LAYOUT, _init_mat_layout

    _init_mat_layout()
    mp = np.asarray(flat.mat_packed)

    def mfield(name):
        off, w = MAT_LAYOUT[name]
        return mp[:, off] if w == 1 else mp[:, off : off + w]

    alpha_mode = mfield("alpha_mode").astype(np.int64)  # 0 opaque 1 mask 2 blend
    cutoff = mfield("alpha_cutoff")
    bc_a = mfield("base_color_factor")[:, 3]
    slot = mfield("base_color_texture").astype(np.int64)

    rn_mat = np.asarray(flat.rn_material)
    rn_prim = np.asarray(flat.rn_prim)
    pft = np.asarray(flat.prim_first_tri)
    ptc = np.asarray(flat.prim_tri_count)
    tri_idx = np.asarray(flat.tri_idx)
    uv0 = np.asarray(flat.vtx_uv0)
    uv1 = np.asarray(flat.vtx_uv1)
    vca = np.asarray(flat.vtx_color)[:, 3]

    ti_index = np.asarray(flat.ti_index)
    ti_texcoord = np.asarray(flat.ti_texcoord)
    ti_uvxform = np.asarray(flat.ti_uvxform)

    rn_visible = np.asarray(flat.rn_visible)
    chunks = []
    for i in range(rn_mat.shape[0]):
        if not rn_visible[i]:  # mirrors the build_world_bvh emit loop
            continue
        p = int(rn_prim[i])
        f, c = int(pft[p]), int(ptc[p])
        mid = int(rn_mat[i])
        cls = np.full(c, ALPHA_MIXED, np.int8)
        if alpha_mode[mid] == 0:
            cls[:] = ALPHA_OPAQUE
            chunks.append(cls)
            continue
        idx = tri_idx[f : f + c]  # [c,3]
        va = vca[idx]  # [c,3] corner vertex alpha
        va_lo, va_hi = va.min(axis=1), va.max(axis=1)
        s = int(slot[mid])
        if s > 0 and int(ti_index[s]) >= 0:
            uv = uv1 if int(ti_texcoord[s]) == 1 else uv0
            xf = ti_uvxform[s]  # [2,3]
            cu = uv[idx][:, :, 0]
            cv = uv[idx][:, :, 1]
            tu = xf[0, 0] * cu + xf[0, 1] * cv + xf[0, 2]
            tv = xf[1, 0] * cu + xf[1, 1] * cv + xf[1, 2]
            ta_lo, ta_hi = _tex_alpha_bounds(flat, int(ti_index[s]), tu, tv)
        else:
            ta_lo = np.ones(c, np.float32)
            ta_hi = np.ones(c, np.float32)
        a_lo = bc_a[mid] * ta_lo * va_lo
        a_hi = bc_a[mid] * ta_hi * va_hi
        if alpha_mode[mid] == 1:  # MASK: thresholded at cutoff
            cls[a_lo >= cutoff[mid]] = ALPHA_OPAQUE
            cls[a_hi < cutoff[mid]] = ALPHA_TRANSPARENT
        else:  # BLEND
            cls[a_lo >= 1.0] = ALPHA_OPAQUE
            cls[a_hi <= 0.0] = ALPHA_TRANSPARENT
        chunks.append(cls)
    if not chunks:
        return np.zeros(0, np.int8)
    return np.concatenate(chunks)
