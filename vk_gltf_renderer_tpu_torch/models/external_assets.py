"""glTF 2.1 external assets: resolve, merge/instance, track provenance.

Reference: Scene::resolveExternalAssets (gltf_scene.cpp:995) +
docs/external_assets.md. A node carrying an external-asset reference pulls
another glTF file into the Model at load: the FIRST reference to a file
merges it (full index rebase via the merger); REPEAT references instance
the already-merged subtree (geometry shared). Merged-in nodes are recorded
as read-only `ReferencedAsset` ranges so the editor can protect them and
save can re-externalize.

Accepted spellings (the 2.1 schema is a draft): the node extension
`KHR_external_assets: {uri: ...}` or `node.extras.externalAsset: uri`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class ReferencedAsset:
    """Provenance of one resolved reference (gltf_scene.hpp:72-82)."""

    instance_node_index: int = -1  # the node carrying the reference (editable)
    source_uri: str = ""
    subtree_nodes: list = field(default_factory=list)  # merged-in (read-only)


def _node_asset_uri(node: dict) -> str | None:
    ext = node.get("extensions", {}).get("KHR_external_assets")
    if isinstance(ext, dict) and "uri" in ext:
        return ext["uri"]
    extra = node.get("extras", {})
    if isinstance(extra, dict) and "externalAsset" in extra:
        return extra["externalAsset"]
    return None


def resolve_external_assets(scene) -> list:
    """Resolve all external references in scene.model. Returns the
    ReferencedAsset list (also stored on scene.referenced_assets)."""
    from .gltf import load_model
    from .merger import instance_subtree, merge_model

    model = scene.model
    base = model.base_dir or Path(".")
    resolved: list[ReferencedAsset] = []
    merged_roots: dict[str, list] = {}  # uri -> subtree roots in target

    for node_id, node in enumerate(list(model.nodes)):
        uri = _node_asset_uri(node)
        if not uri:
            continue
        src_path = (base / uri).resolve()
        ra = ReferencedAsset(instance_node_index=node_id, source_uri=str(src_path))
        if uri in merged_roots:
            # repeat reference: instance the node subtree (shared geometry)
            new_roots = instance_subtree(model, merged_roots[uri])
            # detach from the scene roots; parent under the instance node
            for sc in model.gltf.get("scenes", []):
                for r in new_roots:
                    if r in sc.get("nodes", []):
                        sc["nodes"].remove(r)
            node.setdefault("children", []).extend(new_roots)
            ra.subtree_nodes = _collect_subtree(model, new_roots)
        else:
            try:
                src = load_model(src_path)
            except FileNotFoundError:
                continue
            info = merge_model(model, src, attach_to_scene=False)
            roots = info["root_nodes"]
            merged_roots[uri] = roots
            node.setdefault("children", []).extend(roots)
            ra.subtree_nodes = _collect_subtree(model, roots)
        resolved.append(ra)

    scene.referenced_assets = resolved
    if resolved:
        scene.parse_scene()
    return resolved


def _collect_subtree(model, roots: list) -> list:
    out = []
    stack = list(roots)
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(model.nodes[n].get("children", []))
    return out


def is_read_only_node(scene, node_id: int) -> bool:
    """Editor guard: merged external-asset nodes are read-only (the
    instance node itself stays editable)."""
    for ra in getattr(scene, "referenced_assets", []):
        if node_id in ra.subtree_nodes:
            return True
    return False


def make_editable(scene, node_id: int) -> None:
    """'Make editable': drop read-only tracking for the subtree containing
    node_id (reference SceneEditor external-asset make-editable)."""
    scene.referenced_assets = [
        ra for ra in getattr(scene, "referenced_assets", []) if node_id not in ra.subtree_nodes
    ]
