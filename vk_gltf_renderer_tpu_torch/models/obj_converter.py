"""OBJ -> in-memory glTF conversion (reference tinygltf_converter.{hpp,cpp}).

Supports v/vn/vt, f (triangulated by fanning), usemtl/mtllib with a basic
.mtl subset (Kd/Ks/Ns/d/map_Kd), object/group splits. Produces a GltfModel
ready for Scene.load_from_model / merge.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import accessors as acc
from .gltf import GltfModel


def _parse_mtl(path: Path) -> dict:
    mats = {}
    cur = None
    if not path.exists():
        return mats
    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        k = parts[0]
        if k == "newmtl":
            cur = {"name": parts[1]}
            mats[parts[1]] = cur
        elif cur is None:
            continue
        elif k == "Kd":
            cur["diffuse"] = [float(x) for x in parts[1:4]]
        elif k == "Ks":
            cur["specular"] = [float(x) for x in parts[1:4]]
        elif k == "Ke":
            cur["emissive"] = [float(x) for x in parts[1:4]]
        elif k == "Ns":
            cur["shininess"] = float(parts[1])
        elif k == "d":
            cur["alpha"] = float(parts[1])
        elif k == "map_Kd":
            cur["diffuse_map"] = parts[-1]
    return mats


def load_obj(path) -> GltfModel:
    """Parse an OBJ file into a GltfModel (one mesh primitive per material
    group)."""
    path = Path(path)
    positions, normals, uvs = [], [], []
    mtl_defs = {}
    # groups: material name -> list of (vi, ti, ni) triples
    groups: dict = {}
    current = "default"

    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        k = parts[0]
        if k == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif k == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif k == "vt":
            uvs.append([float(parts[1]), 1.0 - float(parts[2]) if len(parts) > 2 else 0.0])
        elif k == "mtllib":
            mtl_defs.update(_parse_mtl(path.parent / parts[1]))
        elif k == "usemtl":
            current = parts[1]
        elif k == "f":
            corners = []
            for vert in parts[1:]:
                toks = vert.split("/")
                vi = int(toks[0])
                ti = int(toks[1]) if len(toks) > 1 and toks[1] else 0
                ni = int(toks[2]) if len(toks) > 2 and toks[2] else 0
                corners.append((vi, ti, ni))
            tris = groups.setdefault(current, [])
            for i in range(1, len(corners) - 1):  # fan triangulation
                tris += [corners[0], corners[i], corners[i + 1]]

    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32) if normals else None
    uvs = np.asarray(uvs, np.float32) if uvs else None

    model = GltfModel(gltf={"asset": {"version": "2.0", "generator": "obj_converter"}, "scene": 0}, base_dir=path.parent)
    model.buffers = []
    g = model.gltf
    g["scenes"] = [{"nodes": []}]
    g["nodes"] = []
    g["meshes"] = []
    g["materials"] = []

    def resolve(i, n):
        return i - 1 if i > 0 else n + i  # OBJ negative indices

    for mat_name, corners in groups.items():
        # build a de-duplicated vertex stream for this group
        seen = {}
        vbuf_p, vbuf_n, vbuf_t, idx = [], [], [], []
        for vi, ti, ni in corners:
            key = (vi, ti, ni)
            j = seen.get(key)
            if j is None:
                j = len(vbuf_p)
                seen[key] = j
                vbuf_p.append(positions[resolve(vi, len(positions))])
                if normals is not None and ni:
                    vbuf_n.append(normals[resolve(ni, len(normals))])
                if uvs is not None and ti:
                    vbuf_t.append(uvs[resolve(ti, len(uvs))])
            idx.append(j)

        pa = acc.append_accessor(model, np.asarray(vbuf_p, np.float32), "VEC3", target=34962)
        attrs = {"POSITION": pa}
        if vbuf_n and len(vbuf_n) == len(vbuf_p):
            attrs["NORMAL"] = acc.append_accessor(model, np.asarray(vbuf_n, np.float32), "VEC3", target=34962)
        if vbuf_t and len(vbuf_t) == len(vbuf_p):
            attrs["TEXCOORD_0"] = acc.append_accessor(model, np.asarray(vbuf_t, np.float32), "VEC2", target=34962)
        ia = acc.append_accessor(model, np.asarray(idx, np.uint32), "SCALAR", target=34963)

        md = mtl_defs.get(mat_name, {})
        kd = md.get("diffuse", [0.8, 0.8, 0.8])
        shin = md.get("shininess", 0.0)
        rough = float(np.clip(np.sqrt(2.0 / (shin + 2.0)) if shin > 0 else 1.0, 0.04, 1.0))
        mat = {
            "name": mat_name,
            "pbrMetallicRoughness": {
                "baseColorFactor": [*kd, md.get("alpha", 1.0)],
                "metallicFactor": 0.0,
                "roughnessFactor": rough,
            },
        }
        if md.get("emissive"):
            mat["emissiveFactor"] = md["emissive"]
        if md.get("alpha", 1.0) < 1.0:
            mat["alphaMode"] = "BLEND"
        g["materials"].append(mat)

        g["meshes"].append({"name": mat_name, "primitives": [{"attributes": attrs, "indices": ia, "material": len(g["materials"]) - 1}]})
        g["nodes"].append({"name": mat_name, "mesh": len(g["meshes"]) - 1})
        g["scenes"][0]["nodes"].append(len(g["nodes"]) - 1)

    return model
