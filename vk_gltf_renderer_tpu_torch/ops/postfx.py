"""Selection outline and ray picking: port of
vk_gltf_renderer_tpu/ops/postfx.py.

silhouette: a Sobel edge over the selection mask of the first-hit object
ids, composited onto the tonemapped image. pick_ray: one camera ray at a
pixel, traced through the renderer's traversal selection (on the card the
traversal kernel), returning the render node it hits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .camera import generate_rays


def silhouette(object_ids, selection_mask, image, color=(1.0, 0.6, 0.1)):
    """object_ids: [H,W] int (-1 = background, else render node id);
    selection_mask: [N] bool per render node; image: [H,W,3] tonemapped.
    Returns the image with the outline of the selected nodes in `color`."""
    # index -1 reads the appended False, as the reference's wrapped index does
    sel = torch.cat([selection_mask, torch.zeros(1, dtype=torch.bool, device=selection_mask.device)])
    idx = torch.clamp(object_ids, -1, sel.shape[0] - 2).long()
    s = sel[torch.where(idx < 0, idx + sel.shape[0], idx)].to(torch.float32)
    s = torch.where(object_ids >= 0, s, 0.0)

    p = F.pad(s[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[:-2, 1:-1] - p[:-2, 2:])
    edge = torch.sqrt(gx * gx + gy * gy) > 0.5
    c = torch.tensor(color, dtype=torch.float32, device=image.device)
    return torch.where(edge[..., None], c, image)


def pick_ray(renderer, px: int, py: int) -> int:
    """The render node id the camera ray through the centre of pixel
    (px, py) hits first, or -1."""
    from .pathtrace import trace_closest

    frame = renderer._frame_inputs()
    cfg = renderer._config()
    renderer._sync_kernel_tables(cfg)
    dev = renderer.device
    ro, rd = generate_rays(
        torch.tensor([[float(px), float(py)]], device=dev), torch.full((1, 2), 0.5, device=dev),
        torch.tensor([renderer.width, renderer.height], dtype=torch.float32, device=dev),
        frame["proj_inv"], frame["view_inv"])
    hit = trace_closest(renderer.dev_bvh, ro, rd, kernel=cfg.primary_kernel, traversal=cfg.traversal)
    return int(hit["rnode"][0])
