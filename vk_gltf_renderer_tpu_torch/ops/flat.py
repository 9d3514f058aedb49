"""SceneFlat: the scene mirror as one dataclass of numpy arrays.

jax-free copy of vk_gltf_renderer_tpu/ops/flat.py (SceneFlat,
build_scene_flat, refresh_materials and helpers), without the pytree
registration. tests/test_torch_host.py holds every field equal to the
reference builder's. convert.scene_to_device moves the fields the
device path reads into torch.
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields

import numpy as np

from ..models import materials as mats
from ..models.geometry import (
    PrimitiveData,
    _make_fast_tangent,
    compute_smooth_normals,
    extract_primitive,
    generate_tangents_uv,
)

_LIGHT_TYPES = {"directional": 1, "spot": 2, "point": 3}


@dataclass
class SceneFlat:
    """Host scene arrays (float32/int32), field for field the reference's."""

    vtx_pos: np.ndarray  # [V,3]
    vtx_nrm: np.ndarray  # [V,3]
    vtx_tan: np.ndarray  # [V,4]
    vtx_uv0: np.ndarray  # [V,2]
    vtx_uv1: np.ndarray  # [V,2]
    vtx_color: np.ndarray  # [V,4]
    tri_idx: np.ndarray  # [T,3] global vertex indices
    prim_first_tri: np.ndarray  # [P]
    prim_tri_count: np.ndarray  # [P]
    prim_first_vtx: np.ndarray  # [P]
    prim_vtx_count: np.ndarray  # [P]
    prim_has_nrm: np.ndarray  # [P]
    prim_has_uv0: np.ndarray  # [P]
    prim_has_color: np.ndarray  # [P]
    rn_o2w: np.ndarray  # [N,4,4]
    rn_w2o: np.ndarray  # [N,4,4]
    rn_material: np.ndarray  # [N] (clamped >= 0)
    rn_prim: np.ndarray  # [N]
    rn_visible: np.ndarray  # [N]
    materials: dict  # field name -> [M, ...]
    vtx_packed: np.ndarray  # [V,24] pos3 nrm3 tan4 uv0_2 uv1_2 color4 pad
    mat_packed: np.ndarray  # [M,K] all material fields (MAT_LAYOUT)
    rn_packed: np.ndarray  # [N,32] o2w(16) + w2o(16)
    ti_index: np.ndarray  # [TI] image index (-1 none)
    ti_texcoord: np.ndarray  # [TI]
    ti_uvxform: np.ndarray  # [TI,2,3]
    light_type: np.ndarray  # [L]
    light_pos: np.ndarray  # [L,3]
    light_dir: np.ndarray  # [L,3]
    light_color: np.ndarray  # [L,3]
    light_intensity: np.ndarray  # [L]
    light_radius: np.ndarray  # [L]
    light_angular_or_invrange: np.ndarray  # [L]
    light_cone: np.ndarray  # [L,2]
    num_lights: int
    tex_quads: np.ndarray  # [K,16] quad-packed texel pool (ops/textures.py)
    tex_desc: np.ndarray  # [D,4] (offset, width, height, _)
    tex_mip_table: np.ndarray  # [ntex, max_mips] -> desc row
    tex_num_mips: np.ndarray  # [ntex]

    @property
    def tex_texels(self):
        """Plain [K,4] texel view (tap 0 of each quad row) for host-side
        consumers (ops/omm.py alpha maps)."""
        return self.tex_quads[..., :4]


# static layout of mat_packed rows: field -> (offset, width), from the
# ShadeMaterial dataclass; shared with ops/materials_eval.py
MAT_LAYOUT: dict = {}
MAT_ROW_WIDTH = 0


def _init_mat_layout():
    global MAT_ROW_WIDTH
    if MAT_LAYOUT:
        return
    off = 0
    probe = mats.ShadeMaterial()
    for f in dc_fields(mats.ShadeMaterial):
        w = int(np.asarray(getattr(probe, f.name)).size)
        MAT_LAYOUT[f.name] = (off, w)
        off += w
    MAT_ROW_WIDTH = off


def _materials_packed(mat_soa: dict, m: int) -> np.ndarray:
    _init_mat_layout()
    out = np.zeros((m, MAT_ROW_WIDTH), np.float32)
    for name, (off, w) in MAT_LAYOUT.items():
        out[:, off : off + w] = mat_soa[name].reshape(m, -1).astype(np.float32)
    return out


def _materials_soa(shade_materials: list) -> dict:
    out = {}
    for f in dc_fields(mats.ShadeMaterial):
        vals = [np.asarray(getattr(m, f.name)) for m in shade_materials]
        arr = np.stack(vals).astype(np.float32 if vals[0].dtype.kind == "f" else np.int32)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
        out[f.name] = arr
    return out


def build_scene_flat(scene, *, with_textures: bool = True) -> SceneFlat:
    """Scene (host) -> SceneFlat (reference ops/flat.py:169)."""
    model = scene.model

    pos_l, nrm_l, tan_l, uv0_l, uv1_l, col_l, tri_l = [], [], [], [], [], [], []
    pft, ptc, pfv, pvc, phn, phu, phc = [], [], [], [], [], [], []
    v_off = 0
    t_off = 0
    for rp in scene.render_primitives:
        pd: PrimitiveData = extract_primitive(model, rp.primitive(model))
        nv = pd.positions.shape[0]
        nt = pd.indices.shape[0]
        nrm = pd.normals if pd.normals is not None else compute_smooth_normals(pd.positions, pd.indices)
        if pd.tangents is not None:
            tan = pd.tangents.astype(np.float32)
        elif pd.uv0 is not None:
            tan = generate_tangents_uv(pd.positions, nrm, pd.uv0, pd.indices)
        else:
            t3 = _make_fast_tangent(nrm)
            tan = np.concatenate([t3, np.ones((nv, 1), np.float32)], axis=1).astype(np.float32)
        uv0 = pd.uv0 if pd.uv0 is not None else np.zeros((nv, 2), np.float32)
        uv1 = pd.uv1 if pd.uv1 is not None else uv0
        col = pd.color0 if pd.color0 is not None else np.ones((nv, 4), np.float32)

        pos_l.append(pd.positions)
        nrm_l.append(nrm.astype(np.float32))
        tan_l.append(tan)
        uv0_l.append(uv0.astype(np.float32))
        uv1_l.append(uv1.astype(np.float32))
        col_l.append(col.astype(np.float32))
        tri_l.append(pd.indices.astype(np.int64) + v_off)
        pft.append(t_off)
        ptc.append(nt)
        pfv.append(v_off)
        pvc.append(nv)
        phn.append(1 if pd.normals is not None else 0)
        phu.append(1 if pd.uv0 is not None else 0)
        phc.append(1 if pd.color0 is not None else 0)
        v_off += nv
        t_off += nt

    if v_off == 0:  # empty scene: one degenerate triangle keeps shapes valid
        pos_l = [np.zeros((3, 3), np.float32)]
        nrm_l = [np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))]
        tan_l = [np.tile(np.array([[1, 0, 0, 1]], np.float32), (3, 1))]
        uv0_l = uv1_l = [np.zeros((3, 2), np.float32)]
        col_l = [np.ones((3, 4), np.float32)]
        tri_l = [np.array([[0, 1, 2]], np.int64)]
        pft, ptc, pfv, pvc, phn, phu, phc = [0], [1], [0], [3], [0], [0], [0]

    rnodes = scene.render_nodes or []
    n = max(len(rnodes), 1)
    rn_o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rn_w2o = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rn_material = np.zeros(n, np.int32)
    rn_prim = np.zeros(n, np.int32)
    rn_visible = np.zeros(n, np.int32)
    for i, rn in enumerate(rnodes):
        rn_o2w[i] = rn.world_matrix
        rn_w2o[i] = np.linalg.inv(rn.world_matrix.astype(np.float64)).astype(np.float32)
        rn_material[i] = max(rn.material_id, 0)
        rn_prim[i] = rn.render_prim_id
        rn_visible[i] = 1 if rn.visible else 0

    rn_packed = np.concatenate([rn_o2w.reshape(n, 16), rn_w2o.reshape(n, 16)], axis=1).astype(np.float32)

    conv = mats.MaterialConverter(model)
    shade_mats = conv.convert_all()
    mat_soa = _materials_soa(shade_mats)
    mat_packed = _materials_packed(mat_soa, len(shade_mats))
    ti = conv.texture_infos
    ti_index = np.array([t.index for t in ti], np.int32)
    ti_texcoord = np.array([t.tex_coord for t in ti], np.int32)
    ti_uvxform = np.stack([t.uv_transform for t in ti]).astype(np.float32)

    lights = _build_lights(scene)

    if with_textures and model.images:
        from .textures import build_texture_pool

        tex = build_texture_pool(model, used_texinfos=ti)
    else:
        tex = _white_texture_pool()

    vtx_pos = np.concatenate(pos_l).astype(np.float32)
    vtx_nrm = np.concatenate(nrm_l).astype(np.float32)

    # skinning/morph deformation at build time (CPU oracle path of the
    # reference; the device animation path is not ported yet)
    from ..models.animation import compute_joint_matrices, cpu_morph, cpu_skin

    for rn in (scene.render_nodes or []):
        rp = scene.render_primitives[rn.render_prim_id]
        prim = rp.primitive(model)
        v0 = pfv[rn.render_prim_id]
        nv = pvc[rn.render_prim_id]
        node = model.nodes[rn.ref_node_id] if rn.ref_node_id >= 0 else {}
        weights = node.get("weights", model.meshes[node.get("mesh", 0)].get("weights") if "mesh" in node else None)
        pd = extract_primitive(model, prim)
        base_pos = pd.positions
        base_nrm = vtx_nrm[v0 : v0 + nv].copy()
        deformed = False
        if weights and pd.morph_targets:
            deltas = [t.get("POSITION") for t in pd.morph_targets]
            base_pos = cpu_morph(base_pos, deltas, np.asarray(weights, np.float32))
            ndeltas = [t.get("NORMAL") for t in pd.morph_targets]
            if any(d is not None for d in ndeltas):
                base_nrm = cpu_morph(base_nrm, ndeltas, np.asarray(weights, np.float32))
            deformed = True
        if rn.skin_id >= 0 and pd.joints0 is not None and pd.weights0 is not None:
            jm = compute_joint_matrices(scene, rn.skin_id, scene.world_matrices[rn.ref_node_id])
            base_pos, skinned_nrm = cpu_skin(base_pos, base_nrm, pd.joints0, pd.weights0, jm)
            if skinned_nrm is not None:
                base_nrm = skinned_nrm
            deformed = True
        if deformed:
            vtx_pos[v0 : v0 + nv] = base_pos.astype(np.float32)
            ln = np.linalg.norm(base_nrm, axis=1, keepdims=True)
            vtx_nrm[v0 : v0 + nv] = (base_nrm / np.maximum(ln, 1e-20)).astype(np.float32)

    vtx_tan = np.concatenate(tan_l).astype(np.float32)
    vtx_uv0 = np.concatenate(uv0_l).astype(np.float32)
    vtx_uv1 = np.concatenate(uv1_l).astype(np.float32)
    vtx_color = np.concatenate(col_l).astype(np.float32)
    vtx_packed = np.concatenate(
        [vtx_pos, vtx_nrm, vtx_tan, vtx_uv0, vtx_uv1, vtx_color,
         np.zeros((vtx_pos.shape[0], 6), np.float32)], axis=1
    )
    return SceneFlat(
        vtx_pos=vtx_pos,
        vtx_nrm=vtx_nrm,
        vtx_tan=vtx_tan,
        vtx_uv0=vtx_uv0,
        vtx_uv1=vtx_uv1,
        vtx_color=vtx_color,
        tri_idx=np.concatenate(tri_l).astype(np.int32),
        prim_first_tri=np.array(pft, np.int32),
        prim_tri_count=np.array(ptc, np.int32),
        prim_first_vtx=np.array(pfv, np.int32),
        prim_vtx_count=np.array(pvc, np.int32),
        prim_has_nrm=np.array(phn, np.int32),
        prim_has_uv0=np.array(phu, np.int32),
        prim_has_color=np.array(phc, np.int32),
        rn_o2w=rn_o2w,
        rn_w2o=rn_w2o,
        rn_material=rn_material,
        rn_prim=rn_prim,
        rn_visible=rn_visible,
        materials=mat_soa,
        mat_packed=mat_packed,
        vtx_packed=vtx_packed,
        rn_packed=rn_packed,
        ti_index=ti_index,
        ti_texcoord=ti_texcoord,
        ti_uvxform=ti_uvxform,
        num_lights=len(scene.render_lights),
        tex_quads=tex[0],
        tex_desc=tex[1],
        tex_mip_table=tex[2],
        tex_num_mips=tex[3],
        **lights,
    )


def _white_texture_pool():
    quads = np.ones((1, 16), np.float32)
    desc = np.array([[0, 1, 1, 0]], np.int32)
    mip_table = np.zeros((1, 1), np.int32)
    num_mips = np.ones(1, np.int32)
    return quads, desc, mip_table, num_mips


def _build_lights(scene) -> dict:
    """Punctual lights -> SoA (reference ops/flat.py:345), read by
    ops/lights.sample_one_light."""
    model = scene.model
    defs = model.gltf.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    rls = scene.render_lights
    n = max(len(rls), 1)
    out = dict(
        light_type=np.zeros(n, np.int32),
        light_pos=np.zeros((n, 3), np.float32),
        light_dir=np.tile(np.array([[0, -1, 0]], np.float32), (n, 1)),
        light_color=np.ones((n, 3), np.float32),
        light_intensity=np.zeros(n, np.float32),
        light_radius=np.zeros(n, np.float32),
        light_angular_or_invrange=np.zeros(n, np.float32),
        light_cone=np.tile(np.array([[0.0, 1.0]], np.float32), (n, 1)),
    )
    for i, rl in enumerate(rls):
        ld = defs[rl.light] if rl.light < len(defs) else {}
        ltype = _LIGHT_TYPES.get(ld.get("type", "directional"), 1)
        w = rl.world_matrix
        out["light_type"][i] = ltype
        out["light_pos"][i] = w[:3, 3]
        d = -w[:3, 2]
        out["light_dir"][i] = d / max(np.linalg.norm(d), 1e-9)
        out["light_color"][i] = np.asarray(ld.get("color", [1, 1, 1]), np.float32)
        out["light_intensity"][i] = ld.get("intensity", 1.0)
        rng = ld.get("range", 0.0)
        ext = ld.get("extensions", {}).get("KHR_lights_radius", {})
        out["light_radius"][i] = ext.get("radius", 0.0)
        if ltype == 1:
            out["light_angular_or_invrange"][i] = np.radians(0.53)  # sun-like default
        else:
            out["light_angular_or_invrange"][i] = 1.0 / rng if rng > 0 else 0.0
        if ltype == 2:
            spot = ld.get("spot", {})
            inner = spot.get("innerConeAngle", 0.0)
            outer = spot.get("outerConeAngle", np.pi / 4)
            ci, co = np.cos(inner), np.cos(outer)
            out["light_cone"][i] = [co, 1.0 / max(ci - co, 1e-4)]
    return out


def refresh_materials(flat: SceneFlat, scene) -> SceneFlat:
    """Material and light sync (reference ops/flat.py:388): re-pack only the
    material, texture-info and light arrays into a copy of flat. Geometry,
    BVH and the texture pool stay, unless the edit references a texture the
    pool (pruned to the textures in use) lacks."""
    import dataclasses

    model = scene.model
    conv = mats.MaterialConverter(model)
    shade_mats = conv.convert_all()
    mat_soa = _materials_soa(shade_mats)
    mat_packed = _materials_packed(mat_soa, len(shade_mats))
    ti = conv.texture_infos
    lights = _build_lights(scene)
    extra = {}
    old_refs = set(int(v) for v in np.asarray(flat.ti_index).tolist() if v >= 0)
    new_refs = set(int(t.index) for t in ti if t.index >= 0)
    if not new_refs <= old_refs:
        if model.images:
            from .textures import build_texture_pool

            tex = build_texture_pool(model, used_texinfos=ti)
        else:
            tex = _white_texture_pool()
        extra = dict(tex_quads=tex[0], tex_desc=tex[1], tex_mip_table=tex[2], tex_num_mips=tex[3])
    return dataclasses.replace(
        flat,
        materials=mat_soa,
        mat_packed=mat_packed,
        ti_index=np.array([t.index for t in ti], np.int32),
        ti_texcoord=np.array([t.tex_coord for t in ti], np.int32),
        ti_uvxform=np.stack([t.uv_transform for t in ti]).astype(np.float32),
        num_lights=len(scene.render_lights),
        **lights,
        **extra,
    )
