"""Kernel-boundary cost split: the front end of the reference's
tools/exp_boundary.py on the card.

At one ray population (N rays aimed through the scene's centre from
outside its bounds, seeded), packed with ops/megakernel.pack_rays, it
times with probes.device_ms:

  kernel       one bare traverse_bvh4 launch on the packed rays' components
  wf/bounce    render_wavefront (one traverse_bvh4 launch a bounce and the
               shade/regeneration glue in torch) over its depth, at depths 1, 2
  mega/bounce  render_mega (the whole bounce loop in one launch) over its
               depth, at depths 1, 2

and reports boundary = wf/bounce - kernel (what the bounce costs outside
the trace: the glue and the launches) and residency gain = kernel -
mega/bounce (what keeping the path in one launch saves a bounce).

    python -m vk_gltf_renderer_tpu_torch.probes.boundary [--scene helmet|terrain] [--n 2097152] [--iters 4]

The default scene is the helmet stand-in (the reference's default,
shader_ball.gltf, is not in the repository); terrain is the 1,059,968-
triangle grid of scenes.write_large_glb. Card only.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..ops import megakernel as mk
from ..ops.traverse_bvh4 import traverse_bvh4
from . import device_ms, require_cuda

N = 2_097_152  # the reference's default ray population
ITERS = 4
DEPTHS = (1, 2)


def probe_rays(bvh, n, seed=5):
    """n rays from outside the scene's bounds through its centre (the
    reference's ro = -3 d, rd = d on the unit-scale shader ball, scaled to
    the bounds), with uint32 seeds: numpy (ro [n,3], rd [n,3], seeds [n])."""
    lo, hi = bvh.scene_lo.cpu().numpy().astype(np.float64), bvh.scene_hi.cpu().numpy().astype(np.float64)
    centre, radius = (lo + hi) / 2, max(float(np.linalg.norm(hi - lo)) / 2, 1e-3)
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = (centre - 1.5 * radius * d).astype(np.float32)
    seeds = rng.randint(0, 2**31, size=n).astype(np.uint32)
    return ro, d, seeds


def measure(bvh, n=N, iters=ITERS, device="cuda"):
    """Times of the three arms on bvh (a DeviceBvh on device) in ms:
    {"kernel", "wf": {depth: ms}, "mega": {depth: ms}, "boundary": {depth},
    "residency_gain": {depth}} (per bounce where per bounce)."""
    ro, rd, seeds = probe_rays(bvh, n)
    ro_p, rd_p, seed_p, _ = mk.pack_rays(ro, rd, seeds, device=device)
    comps = [ro_p[:, c].reshape(-1).contiguous() for c in range(3)] + [
        rd_p[:, c].reshape(-1).contiguous() for c in range(3)]
    tmin = rd_p[:, 3].reshape(-1).contiguous()
    tmax = torch.full_like(tmin, mk.INF)
    tables = (bvh.nodes4_fi, bvh.tris128)
    kernel = device_ms(lambda: traverse_bvh4(*tables, bvh.root4_code, *comps, tmin, tmax), iters)
    out = {"n": n, "kernel": kernel, "wf": {}, "mega": {}, "boundary": {}, "residency_gain": {}}
    for depth in DEPTHS:
        wf = device_ms(lambda: mk.render_wavefront(*tables, ro_p, rd_p, seed_p, depth, bvh.root4_code), iters)
        mega = device_ms(lambda: mk.render_mega(*tables, ro_p, rd_p, seed_p, depth, bvh.root4_code), iters)
        out["wf"][depth], out["mega"][depth] = wf, mega
        out["boundary"][depth] = wf / depth - kernel
        out["residency_gain"][depth] = kernel - mega / depth
    return out


def report(label, res) -> str:
    lines = [f"[boundary] {label}, {res['n']} rays: bare traverse_bvh4 launch {res['kernel']:.3f} ms"]
    for depth in DEPTHS:
        lines.append(f"[boundary] {label} depth {depth}: wf/bounce {res['wf'][depth] / depth:.3f} ms, "
                     f"mega/bounce {res['mega'][depth] / depth:.3f} ms, boundary {res['boundary'][depth]:.3f} ms, "
                     f"residency gain {res['residency_gain'][depth]:.3f} ms")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("helmet", "terrain"), default="helmet")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    device = require_cuda("probe_boundary")
    from ..renderer import GltfRenderer
    from ..scenes import make_helmet_standin, write_large_glb

    with tempfile.TemporaryDirectory() as tmp:
        if args.scene == "helmet":
            path = make_helmet_standin(tmp)
        else:
            path = os.path.join(tmp, "terrain.glb")
            write_large_glb(path)
        r = GltfRenderer(width=8, height=8, spp=1, max_depth=1, device=device)
        r.create_scene(path)
    print(f"[boundary] {torch.cuda.get_device_name(0)}", flush=True)
    print(report(args.scene, measure(r.dev_bvh, args.n, args.iters, device)), flush=True)


if __name__ == "__main__":
    main()
