"""vk_gltf_renderer_tpu_torch — the PyTorch/CUDA port of vk_gltf_renderer_tpu.

The JAX package beside this one is the reference: module names here mirror
it (``ops/flat.py``, ``ops/pathtrace.py``, ``renderer.py``, ...) so a reader
can find each counterpart. This package imports ``torch`` and never ``jax``,
and nothing of the JAX package: the framework-free host layer it needs is
copied in (``models/``, ``native/``, ``utils/mathutil.py``), and
tests/test_torch_host.py holds each copy equal to its original.

Layers, from the entry point down:
  renderer.py     GltfRenderer: scene/HDR lifecycle, accumulation, output
  ops/pathtrace   one frame of samples: camera rays, bounce loop, NEE
  ops/preview     one preview frame (ops/ibl: its prefiltered lighting)
  ops/denoise, ops/temporal, ops/upscale, ops/postfx
                  what the viewer shows: SVGF, reprojection, TAAU, outline, pick
  ops/*           hit state, materials, textures, sky/HDR, BSDF, tonemap
  ops/intersect   the traversal-kernel switch (VKGR_*_KERNEL names)
  ops/traverse_* + csrc/traverse_*.cu         traversal kernels
  ops/gather + csrc/gather.cu                 small-table gather kernel
  ops/megakernel + csrc/megakernel.cu         bounce-loop megakernel
  ops/flat, ops/bvh_flatten, native/, models/ host scene and BVH builders
  convert.py      host tables -> device tensors

Everything on the device is float32 with TF32 off (``device.py``).
"""

__version__ = "0.1.0"
