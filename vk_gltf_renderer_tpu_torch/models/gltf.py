"""glTF 2.0 container I/O: .gltf (JSON) and .glb (binary) load/save.

Rebuilds the capability the reference gets from tinygltf
(src/gltf_scene.cpp:298 Scene::load / :? Scene::save) as a small pure-Python
module. The in-memory representation is deliberately JSON-shaped: ``GltfModel``
holds the parsed glTF dict verbatim plus decoded binary buffers. All scene
mutation (editor, merger, animation pointer) operates on the dict, which keeps
the Model-primary invariant trivially true and round-trips unknown extensions
untouched (reference test_features_preserved.cpp behavior).
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path

GLB_MAGIC = 0x46546C67  # 'glTF'
CHUNK_JSON = 0x4E4F534A  # 'JSON'
CHUNK_BIN = 0x004E4942  # 'BIN\0'


@dataclass
class GltfModel:
    """A glTF asset: the JSON tree (authoritative) + binary buffer payloads.

    ``gltf`` is the raw parsed JSON dict — our tinygltf::Model. ``buffers[i]``
    is the decoded payload of ``gltf["buffers"][i]`` as a bytearray (mutable
    so editors can append vertex data).
    """

    gltf: dict = field(default_factory=dict)
    buffers: list = field(default_factory=list)  # list[bytearray]
    base_dir: Path | None = None  # for resolving external URIs (images)
    filename: Path | None = None

    # -- convenience accessors over the JSON tree ---------------------------
    def _arr(self, key: str) -> list:
        return self.gltf.setdefault(key, [])

    @property
    def nodes(self) -> list:
        return self._arr("nodes")

    @property
    def meshes(self) -> list:
        return self._arr("meshes")

    @property
    def materials(self) -> list:
        return self._arr("materials")

    @property
    def accessors(self) -> list:
        return self._arr("accessors")

    @property
    def buffer_views(self) -> list:
        return self._arr("bufferViews")

    @property
    def images(self) -> list:
        return self._arr("images")

    @property
    def textures(self) -> list:
        return self._arr("textures")

    @property
    def samplers(self) -> list:
        return self._arr("samplers")

    @property
    def skins(self) -> list:
        return self._arr("skins")

    @property
    def animations(self) -> list:
        return self._arr("animations")

    @property
    def cameras(self) -> list:
        return self._arr("cameras")

    @property
    def scenes(self) -> list:
        return self._arr("scenes")

    @property
    def default_scene(self) -> int:
        return self.gltf.get("scene", 0)

    def scene_roots(self, scene_index: int | None = None) -> list:
        scenes = self.gltf.get("scenes", [])
        if not scenes:
            # Spec allows sceneless files; treat all parentless nodes as roots.
            children = {c for n in self.nodes for c in n.get("children", [])}
            return [i for i in range(len(self.nodes)) if i not in children]
        idx = self.default_scene if scene_index is None else scene_index
        idx = min(idx, len(scenes) - 1)
        return list(scenes[idx].get("nodes", []))

    def used_extensions(self) -> set:
        return set(self.gltf.get("extensionsUsed", []))


def _decode_data_uri(uri: str) -> bytearray:
    header, b64 = uri.split(",", 1)
    assert header.startswith("data:"), f"unsupported uri {header!r}"
    return bytearray(base64.b64decode(b64))


def _load_buffer(buf: dict, base_dir: Path | None, bin_chunk: bytes | None) -> bytearray:
    uri = buf.get("uri")
    if uri is None:
        if bin_chunk is None:
            return bytearray(buf.get("byteLength", 0))
        return bytearray(bin_chunk[: buf["byteLength"]])
    if uri.startswith("data:"):
        return _decode_data_uri(uri)
    if base_dir is None:
        raise FileNotFoundError(f"external buffer {uri!r} with no base dir")
    from urllib.parse import unquote

    return bytearray((base_dir / unquote(uri)).read_bytes())


_UNSUPPORTED_COMPRESSION = ()


def _check_compression(gltf: dict, path) -> None:
    req = set(gltf.get("extensionsRequired", []))
    for ext in _UNSUPPORTED_COMPRESSION:
        if ext in req:
            raise NotImplementedError(
                f"{path}: requires {ext}; compressed-geometry decoding is not "
                "bundled yet (decompress the asset offline, e.g. gltf-transform)"
            )


def _decompress_draco(model: "GltfModel") -> None:
    """KHR_draco_mesh_compression primitives -> raw accessors in place
    (reference routes these through the official decoder via tinygltf +
    USE_DRACO, gltf_scene.cpp:248-249)."""
    used = set(model.gltf.get("extensionsUsed", [])) | set(model.gltf.get("extensionsRequired", []))
    if "KHR_draco_mesh_compression" not in used:
        return
    from .draco import decompress_model

    decompress_model(model)


def _decompress_meshopt(model: "GltfModel") -> None:
    """EXT_meshopt_compression buffer views -> raw bytes in place
    (reference decompressMeshoptExtension, gltf_scene.cpp:337/:372)."""
    used = set(model.gltf.get("extensionsUsed", [])) | set(model.gltf.get("extensionsRequired", []))
    if not used & {"EXT_meshopt_compression", "KHR_meshopt_compression"}:
        return
    from .meshopt import decompress_model

    decompress_model(model)


def load_model(path) -> GltfModel:
    """Load a .gltf or .glb file (reference Scene::load, gltf_scene.cpp:298)."""
    path = Path(path)
    data = path.read_bytes()
    if len(data) >= 4 and struct.unpack("<I", data[:4])[0] == GLB_MAGIC:
        model = _load_glb(data, path)
        _check_compression(model.gltf, path)
        _decompress_meshopt(model)
        _decompress_draco(model)
        return model
    gltf = json.loads(data.decode("utf-8"))
    _check_compression(gltf, path)
    model = GltfModel(gltf=gltf, base_dir=path.parent, filename=path)
    model.buffers = [_load_buffer(b, path.parent, None) for b in gltf.get("buffers", [])]
    _decompress_meshopt(model)
    _decompress_draco(model)
    return model


def load_model_from_json(gltf: dict, buffers=None, base_dir=None) -> GltfModel:
    """Build a model from an in-memory glTF dict (tests, procedural scenes)."""
    model = GltfModel(gltf=gltf, base_dir=base_dir)
    if buffers is not None:
        model.buffers = [bytearray(b) for b in buffers]
    else:
        model.buffers = [_load_buffer(b, base_dir, None) for b in gltf.get("buffers", [])]
    return model


def _load_glb(data: bytes, path: Path) -> GltfModel:
    magic, version, length = struct.unpack_from("<III", data, 0)
    assert magic == GLB_MAGIC
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    json_chunk = None
    bin_chunk = None
    while offset + 8 <= min(length, len(data)):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        payload = data[offset : offset + chunk_len]
        offset += chunk_len + (-chunk_len % 4 if chunk_type == CHUNK_JSON else 0)
        # chunks are 4-byte aligned; padding is included in chunk_len per spec,
        # but be lenient with writers that don't pad.
        offset += -offset % 4
        if chunk_type == CHUNK_JSON:
            json_chunk = payload
        elif chunk_type == CHUNK_BIN:
            bin_chunk = payload
    if json_chunk is None:
        raise ValueError("GLB missing JSON chunk")
    gltf = json.loads(json_chunk.decode("utf-8"))
    model = GltfModel(gltf=gltf, base_dir=path.parent, filename=path)
    model.buffers = [_load_buffer(b, path.parent, bin_chunk) for b in gltf.get("buffers", [])]
    return model


def save_model(model: GltfModel, path) -> None:
    """Save to .gltf (embedded data-URI buffers) or .glb by extension.

    Reference parity: Scene::save (gltf_scene.hpp:261-265). The .gltf path
    embeds buffers as data URIs to stay self-contained (the reference offers
    self-contained saves for external assets, docs/external_assets.md:55-60).
    """
    path = Path(path)
    if path.suffix.lower() == ".glb":
        _save_glb(model, path)
        return
    gltf = json.loads(json.dumps(model.gltf))  # deep copy; don't mutate source
    bufs = gltf.get("buffers", [])
    for i, b in enumerate(bufs):
        payload = bytes(model.buffers[i]) if i < len(model.buffers) else b""
        b["uri"] = "data:application/octet-stream;base64," + base64.b64encode(payload).decode()
        b["byteLength"] = len(payload)
    path.write_text(json.dumps(gltf, separators=(",", ":")))


def _save_glb(model: GltfModel, path: Path) -> None:
    gltf = json.loads(json.dumps(model.gltf))
    # GLB holds ONE binary chunk: concatenate all buffers, rebase bufferViews.
    blobs = [bytes(b) for b in model.buffers]
    offsets = []
    total = 0
    for b in blobs:
        offsets.append(total)
        total += len(b) + (-len(b) % 4)
    for bv in gltf.get("bufferViews", []):
        src = bv.get("buffer", 0)
        bv["buffer"] = 0
        bv["byteOffset"] = bv.get("byteOffset", 0) + (offsets[src] if src < len(offsets) else 0)
    merged = bytearray(total)
    for off, b in zip(offsets, blobs):
        merged[off : off + len(b)] = b
    gltf["buffers"] = [{"byteLength": len(merged)}] if merged else []
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    out = bytearray()
    bin_part = struct.pack("<II", len(merged), CHUNK_BIN) + bytes(merged) if merged else b""
    length = 12 + 8 + len(js) + len(bin_part)
    out += struct.pack("<III", GLB_MAGIC, 2, length)
    out += struct.pack("<II", len(js), CHUNK_JSON) + js
    out += bin_part
    path.write_bytes(bytes(out))
