"""Primitive geometry extraction + tangent synthesis (host-side, numpy).

Replaces the decode half of the reference's SceneVk::createVertexBuffers
(gltf_scene_vk.cpp:741) and the tangent generator
(gltf_create_tangent.cpp: UV-gradient fast path; MikkTSpace parity is a
later milestone).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import accessors as acc
from .gltf import GltfModel


@dataclass
class PrimitiveData:
    """Decoded SoA geometry for one RenderPrimitive (float32/uint32)."""

    positions: np.ndarray  # [V,3] f32
    indices: np.ndarray  # [T,3] u32
    normals: np.ndarray | None = None  # [V,3] f32
    tangents: np.ndarray | None = None  # [V,4] f32 (w = handedness)
    uv0: np.ndarray | None = None  # [V,2] f32
    uv1: np.ndarray | None = None  # [V,2] f32
    color0: np.ndarray | None = None  # [V,4] f32
    joints0: np.ndarray | None = None  # [V,4] u16/int
    weights0: np.ndarray | None = None  # [V,4] f32
    morph_targets: list = field(default_factory=list)  # list of dicts attr->delta [V,3]


def extract_primitive(model: GltfModel, prim: dict) -> PrimitiveData:
    attrs = prim.get("attributes", {})
    positions = np.ascontiguousarray(acc.read_accessor(model, attrs["POSITION"]), np.float32)
    nv = positions.shape[0]
    if "indices" in prim:
        idx = acc.read_accessor(model, prim["indices"]).astype(np.uint32)
    else:
        idx = np.arange(nv, dtype=np.uint32)
    tri = idx.reshape(-1, 3)

    def opt(name, ncomp=None, dtype=np.float32):
        if name not in attrs:
            return None
        a = acc.read_accessor(model, attrs[name])
        a = np.asarray(a, dtype)
        if ncomp is not None and a.ndim == 2 and a.shape[1] != ncomp:
            if a.shape[1] < ncomp:  # COLOR_0 VEC3 -> VEC4 (alpha=1)
                pad = np.ones((a.shape[0], ncomp - a.shape[1]), dtype)
                a = np.concatenate([a, pad], axis=1)
            else:
                a = a[:, :ncomp]
        return np.ascontiguousarray(a)

    morphs = []
    for target in prim.get("targets", []):
        m = {}
        for k, ai in target.items():
            m[k] = np.asarray(acc.read_accessor(model, ai), np.float32)
        morphs.append(m)

    return PrimitiveData(
        positions=positions,
        indices=tri,
        normals=opt("NORMAL", 3),
        tangents=opt("TANGENT", 4),
        uv0=opt("TEXCOORD_0", 2),
        uv1=opt("TEXCOORD_1", 2),
        color0=opt("COLOR_0", 4),
        joints0=(acc.read_accessor(model, attrs["JOINTS_0"], dequantize=False).astype(np.int32) if "JOINTS_0" in attrs else None),
        weights0=opt("WEIGHTS_0", 4),
        morph_targets=morphs,
    )


def compute_face_normals(positions: np.ndarray, tri: np.ndarray) -> np.ndarray:
    e1 = positions[tri[:, 1]] - positions[tri[:, 0]]
    e2 = positions[tri[:, 2]] - positions[tri[:, 0]]
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def compute_smooth_normals(positions: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for primitives lacking NORMAL."""
    fn = np.cross(positions[tri[:, 1]] - positions[tri[:, 0]], positions[tri[:, 2]] - positions[tri[:, 0]])
    vn = np.zeros_like(positions)
    for k in range(3):
        np.add.at(vn, tri[:, k], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(ln, 1e-20)).astype(np.float32)


def generate_tangents_uv(positions, normals, uv0, tri) -> np.ndarray:
    """UV-gradient tangent synthesis (reference gltf_create_tangent.cpp fast
    path — Lengyel's method, accumulated per vertex then orthonormalized).

    MikkTSpace-exact parity (with vertex splitting) is a later milestone;
    this path matches the reference's behavior for the common case where a
    primitive has normals+UVs but no TANGENT attribute.
    """
    v0, v1, v2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    w0, w1, w2 = uv0[tri[:, 0]], uv0[tri[:, 1]], uv0[tri[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    du1, dv1 = w1[:, 0] - w0[:, 0], w1[:, 1] - w0[:, 1]
    du2, dv2 = w2[:, 0] - w0[:, 0], w2[:, 1] - w0[:, 1]
    det = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(det) < 1e-20, 0.0, 1.0 / np.where(det == 0, 1.0, det))
    tdir = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    bdir = (e2 * du1[:, None] - e1 * du2[:, None]) * r[:, None]

    tan = np.zeros_like(positions)
    bitan = np.zeros_like(positions)
    for k in range(3):
        np.add.at(tan, tri[:, k], tdir)
        np.add.at(bitan, tri[:, k], bdir)

    # Gram-Schmidt orthonormalize against the normal; fall back to any
    # perpendicular axis for degenerate UVs (reference makeFastTangent).
    n = normals
    t = tan - n * np.sum(n * tan, axis=1, keepdims=True)
    tl = np.linalg.norm(t, axis=1, keepdims=True)
    bad = (tl[:, 0] < 1e-8)
    fallback = _make_fast_tangent(n)
    t = np.where(bad[:, None], fallback, t / np.maximum(tl, 1e-20))
    handed = np.where(np.sum(np.cross(n, t) * bitan, axis=1) < 0.0, -1.0, 1.0)
    return np.concatenate([t, handed[:, None]], axis=1).astype(np.float32)


def _make_fast_tangent(n: np.ndarray) -> np.ndarray:
    """Branchless ONB tangent from a normal (Frisvad-style; reference
    nvshaders makeFastTangent semantics)."""
    sgn = np.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sgn + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = np.stack([1.0 + sgn * n[:, 0] * n[:, 0] * a, sgn * b, -sgn * n[:, 0]], axis=1)
    return t


def generate_tangents_mikk(positions, normals, uv0, tri):
    """MikkTSpace-contract tangent generation with vertex splitting.

    The reference recomputes tangents through the MikkTSpace library
    (gltf_create_tangent.cpp, recomputeTangents with vertex splitting).
    This implements the same observable contract rather than binding the
    library: per-face Lengyel tangents, corner-ANGLE weighting, averaging
    restricted to same-HANDEDNESS corner groups, and vertices used with
    both handednesses are SPLIT so each final vertex has one coherent
    tangent frame (mirrored-UV seams stop averaging to garbage).

    Returns (tan4 [V',4], tri' [T,3], dup_src [V'-V]) where dup_src maps
    each appended duplicate vertex to its source row (the caller copies
    the remaining attributes; positions/normals/uvs here are NOT copied).
    """
    v = positions
    nvert = v.shape[0]
    p0, p1, p2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    w0, w1, w2 = uv0[tri[:, 0]], uv0[tri[:, 1]], uv0[tri[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    du1, dv1 = w1[:, 0] - w0[:, 0], w1[:, 1] - w0[:, 1]
    du2, dv2 = w2[:, 0] - w0[:, 0], w2[:, 1] - w0[:, 1]
    det = du1 * dv2 - du2 * dv1
    good = np.abs(det) >= 1e-20
    r = np.where(good, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    tdir = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    bdir = (e2 * du1[:, None] - e1 * du2[:, None]) * r[:, None]
    face_sign = np.where(det < 0, -1, 1).astype(np.int8)  # UV mirrored?

    # corner angles (MikkTSpace weighting)
    def corner_angle(a, b, c):
        u = b - a
        w_ = c - a
        un = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-20)
        wn = w_ / np.maximum(np.linalg.norm(w_, axis=1, keepdims=True), 1e-20)
        return np.arccos(np.clip(np.sum(un * wn, axis=1), -1.0, 1.0))

    ang = np.stack(
        [corner_angle(p0, p1, p2), corner_angle(p1, p2, p0), corner_angle(p2, p0, p1)], axis=1
    )  # [T,3]

    # accumulate per (vertex, handedness-group)
    acc_t = np.zeros((nvert, 2, 3))
    acc_b = np.zeros((nvert, 2, 3))
    grp = (face_sign < 0).astype(np.int64)  # 0 = +1 group, 1 = -1 group
    for k in range(3):
        w_k = ang[:, k : k + 1]
        np.add.at(acc_t, (tri[:, k], grp), tdir * w_k)
        np.add.at(acc_b, (tri[:, k], grp), bdir * w_k)

    used = np.zeros((nvert, 2), bool)
    for k in range(3):
        used[tri[:, k], grp] = True
    both = used[:, 0] & used[:, 1]

    # split: group 0 keeps the original slot; group 1 gets a duplicate
    dup_src = np.nonzero(both)[0].astype(np.int64)
    new_of = np.full(nvert, -1, np.int64)
    new_of[dup_src] = nvert + np.arange(dup_src.size)
    nv2 = nvert + dup_src.size

    tri2 = tri.copy().astype(np.int64)
    for k in range(3):
        vids = tri2[:, k]
        moved = (grp == 1) & both[vids]
        tri2[:, k] = np.where(moved, new_of[vids], vids)

    # per final vertex: pick its group's accumulation (vertices used only in
    # group 1 and not split keep their original slot with group-1 data)
    g_of = np.zeros(nv2, np.int64)
    g_of[:nvert] = np.where(~used[:, 0] & used[:, 1], 1, 0)
    g_of[nvert:] = 1
    src = np.concatenate([np.arange(nvert), dup_src])
    t_acc = acc_t[src, g_of]
    b_acc = acc_b[src, g_of]
    n2 = normals[src]

    t = t_acc - n2 * np.sum(n2 * t_acc, axis=1, keepdims=True)
    tl = np.linalg.norm(t, axis=1, keepdims=True)
    bad = tl[:, 0] < 1e-8
    t = np.where(bad[:, None], _make_fast_tangent(n2), t / np.maximum(tl, 1e-20))
    handed = np.where(np.sum(np.cross(n2, t) * b_acc, axis=1) < 0.0, -1.0, 1.0)
    handed = np.where(bad, 1.0, handed)
    tan4 = np.concatenate([t, handed[:, None]], axis=1).astype(np.float32)
    return tan4, tri2.astype(np.int64), dup_src


def recompute_tangents_mikk(model, mesh_id: int, prim_id: int = 0) -> int:
    """Rewrite one primitive with MikkTSpace-contract tangents (splitting
    vertices at handedness seams) — the model-level recompute-tangents
    action. Returns the number of split (appended) vertices."""
    from . import accessors as acc

    prim = model.meshes[mesh_id]["primitives"][prim_id]
    pd = extract_primitive(model, prim)
    if pd.uv0 is None:
        raise ValueError("primitive has no TEXCOORD_0; tangents need UVs")
    nrm = pd.normals if pd.normals is not None else compute_smooth_normals(pd.positions, pd.indices)
    tan4, tri2, dup_src = generate_tangents_mikk(pd.positions, nrm, pd.uv0, pd.indices)

    def expand(a):
        return np.concatenate([a, a[dup_src]]) if dup_src.size else a

    attrs = {
        "POSITION": (expand(pd.positions), "VEC3"),
        "NORMAL": (expand(nrm.astype(np.float32)), "VEC3"),
        "TANGENT": (tan4, "VEC4"),
        "TEXCOORD_0": (expand(pd.uv0.astype(np.float32)), "VEC2"),
    }
    for name, arr in (
        ("TEXCOORD_1", pd.uv1), ("COLOR_0", pd.color0),
        ("JOINTS_0", pd.joints0), ("WEIGHTS_0", pd.weights0),
    ):
        if arr is not None:
            kind = {2: "VEC2", 3: "VEC3", 4: "VEC4"}[arr.shape[1]]
            attrs[name] = (expand(np.asarray(arr)), kind)

    for name, (arr, kind) in attrs.items():
        if name == "JOINTS_0":
            arr = arr.astype(np.uint16)
        else:
            arr = arr.astype(np.float32)
        prim["attributes"][name] = acc.append_accessor(model, arr, kind, target=34962)
    prim["indices"] = acc.append_accessor(
        model, tri2.astype(np.uint32).reshape(-1), "SCALAR", target=34963
    )
    return int(dup_src.size)
