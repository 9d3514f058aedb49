"""Pixel-row parallelism over a list of devices in one process (reference
vk_gltf_renderer_tpu/parallel/mesh.py: make_sharded_render_fn, render_mesh).

The reference shards the pixel lanes over a jax Mesh with shard_map; here
the rows of the frame split evenly over a list of torch devices, each
device renders its rows through ops/pathtrace.render_frame_flat with the
frame's px / py, on its own copy of the device scene, BVH and environment
(the renderer's `replicas`, made once per distinct device with
DeviceScene.to / DeviceBvh.to and dropped when the tables change), and
the ray counters are summed: the reference's psum. A device named twice
renders two shards in turn. The accumulation and the per-pixel outputs
are concatenated in row order on the renderer's device.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..convert import replicate
from ..device import synchronize
from ..ops.pathtrace import render_frame_flat
from ..ops.sky import SkyEnv


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _tables_on(renderer, device):
    """(DeviceScene, DeviceBvh, env) of the renderer on device: its own on
    its own device, else the cached replica."""
    if device == _canonical(renderer.device):
        return renderer.dev_scene, renderer.dev_bvh, renderer._env()
    if device not in renderer.replicas:
        hdr = None
        if renderer.env_kind == "hdr" and renderer.hdr is not None:
            hdr = replicate(renderer.hdr, device)
        renderer.replicas[device] = (renderer.dev_scene.to(device), renderer.dev_bvh.to(device), hdr)
    scene, bvh, hdr = renderer.replicas[device]
    env = hdr if hdr is not None else SkyEnv.from_arrays(renderer.sky_params.as_arrays(), device)
    return scene, bvh, env


def row_shards(height: int, parts: int):
    """(first row, row count) of each of `parts` equal shards of the rows;
    raises ValueError unless they divide (reference mesh.py:102)."""
    if parts < 1 or height % parts:
        raise ValueError(f"{height} pixel rows must divide evenly over {parts} shards")
    rows = height // parts
    return [(i * rows, rows) for i in range(parts)]


def render_rows(renderer, cfg, frame, device, row0, rows):
    """Render rows [row0, row0 + rows) of the frame on device; returns
    (accum [rows*W,3], aux) there. frame is the renderer's _frame_inputs()."""
    w = cfg.width
    device = _canonical(device)
    scene, bvh, env = _tables_on(renderer, device)
    pix = slice(row0 * w, (row0 + rows) * w)
    sub = {k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in frame.items() if k != "accum"}
    sub["accum"] = frame["accum"][pix].to(device)
    sub["px"] = torch.arange(w, device=device).repeat(rows)
    sub["py"] = torch.arange(row0, row0 + rows, device=device).repeat_interleave(w)
    # the kernels launch on the current card: make it the shard's
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        return render_frame_flat(scene, bvh, env, sub, cfg)


def _gather_aux(auxes, device):
    """Per-pixel aux outputs concatenated in shard order on device; the ray
    counters summed (the reference's psum)."""
    out = {}
    for key in auxes[0]:
        vals = [a[key].to(device) for a in auxes]
        out[key] = torch.stack(vals).sum(0) if key == "rays" else torch.cat(vals)
    return out


def render_mesh(renderer, devices) -> dict:
    """One path-traced frame of the renderer's scene with its rows split
    evenly over `devices` (a list of torch devices or names; one may repeat).
    Advances total_samples and frame_idx as on_render does and returns the
    frame's aux. With renderer.adaptive set, the summed ray count and the
    frame's wall time retarget spp (AdaptiveSampler.update_global)."""
    renderer.sync_scene_changes()
    cfg = renderer._config()
    cfg.check_supported()
    renderer._sync_kernel_tables(cfg)
    frame = renderer._frame_inputs()
    devices = [_canonical(d) for d in devices]
    shards = row_shards(cfg.height, len(devices))
    home = renderer.device
    if renderer.adaptive is not None:
        for d in set(devices) | {home}:
            synchronize(d)
    t0 = time.perf_counter()
    results = [render_rows(renderer, cfg, frame, d, row0, rows) for d, (row0, rows) in zip(devices, shards)]
    renderer.accum = torch.cat([acc.to(home) for acc, _ in results])
    aux = _gather_aux([a for _, a in results], home)
    renderer.total_samples += cfg.spp
    renderer.frame_idx += 1
    renderer._last_aux = aux
    if renderer.adaptive is not None:
        rays = float(aux["rays"])  # the summed counter; reading it waits for every shard
        for d in set(devices):
            synchronize(d)
        renderer.adaptive.update_global(rays, (time.perf_counter() - t0) * 1000.0)
        renderer.spp = renderer.adaptive.spp
    return aux
