"""vk_gltf_renderer_tpu_torch — the PyTorch/CUDA port of vk_gltf_renderer_tpu.

The JAX package beside this one is the reference: module names here mirror
it (``ops/flat.py``, ``ops/pathtrace.py``, ``renderer.py``, ...) so a reader
can find each counterpart. This package imports ``torch`` and never ``jax``;
the only code it shares with the reference is the framework-free host layer
(``vk_gltf_renderer_tpu.models``, ``.native`` and ``.utils.mathutil``).

Layers, from the entry point down:
  renderer.py     GltfRenderer: scene/HDR lifecycle, accumulation, output
  ops/pathtrace   one frame of samples: camera rays, bounce loop, NEE
  ops/*           hit state, materials, textures, sky/HDR, BSDF, tonemap
  ops/traverse_bvh4 + csrc/traverse_bvh4.cu   BVH4 traversal kernel
  ops/gather + csrc/gather.cu                 small-table gather kernel
  ops/flat, ops/bvh_flatten                   numpy host builders
  convert.py      host tables -> device tensors

Everything on the device is float32 with TF32 off (``device.py``).
"""

__version__ = "0.1.0"
