"""Host-side Model-primary scene library (reference layer 1).

The glTF Model — a JSON dict plus binary buffers — is the single source of
truth, exactly like tinygltf::Model in the reference (gltf_scene.hpp:210).
Flat render arrays (RenderNode / RenderPrimitive) are derived, never edited.

The port's own copy of vk_gltf_renderer_tpu/models (the modules the port
reaches: glTF I/O and its Draco / meshopt decoders, Scene, geometry,
materials, the editor, animation, variants), so the port imports nothing
of the JAX package; tests/test_torch_host.py (tests/test_torch_frontends.py
for variants) holds each copy equal to its original.
"""

from .gltf import GltfModel, load_model, save_model
from .scene import Scene, DirtyFlags, RenderNode, RenderPrimitive
