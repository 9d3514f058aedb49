"""Rendering one frame across devices and processes (reference
vk_gltf_renderer_tpu/parallel): pixel rows split over the devices, the
device tables replicated on each, the ray counters summed.

  mesh.py       render_mesh(renderer, devices): the rows over a list of
                torch devices in one process.
  multihost.py  init_multihost, global_mesh, render_multihost: the rows over
                every device of every process of a torch.distributed group;
                `python -m vk_gltf_renderer_tpu_torch.parallel.multihost`
                runs one rank of a checked two-process render.

Every pixel's samples depend only on its seed, xxhash32(px, py, frame), so
a sharded frame equals the unsharded one bit for bit.
"""

from .mesh import render_mesh

__all__ = ["render_mesh"]
