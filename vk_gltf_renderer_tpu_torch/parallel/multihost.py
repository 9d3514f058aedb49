"""Rendering one frame across processes on torch.distributed (reference
vk_gltf_renderer_tpu/parallel/multihost.py: init_multihost, global_mesh,
render_multihost).

Every process loads the same scene (the reference's replicated data
model). The frame's rows split evenly over every device of every rank, in
rank order; each rank renders its own shards (parallel/mesh.render_rows),
all_reduces the ray counter (the reference's psum) and, for the adaptive
sampler, takes rank 0's measured wall time by broadcast, so that every
rank lands on the same spp bucket. Nothing else crosses processes: the
caller gathers the shards it needs.

The caller names the backend, and nothing switches it: gloo for CPU
tensors and for several ranks on one card (NCCL refuses two ranks on one
device), nccl where each rank has its own card. The collectives run on
CPU tensors under gloo and on the rank's card under nccl.

    python -m vk_gltf_renderer_tpu_torch.parallel.multihost --rank R --world N \\
        --port P --scene X.gltf [--hdr S.hdr] [--size W H] [--depth D] \\
        [--backend gloo] [--device cuda]

runs one rank of a checked render: it renders the unsharded frame itself,
then the sharded one, requires its shards to equal the unsharded rows bit
for bit and the summed ray count to equal the unsharded one, renders
three adaptive frames and requires every rank's spp sequence to agree,
and prints one MULTIHOST_OK line (with its sharded frame's kernel
launches: 0 on the CPU, where the wrappers take their plain versions).
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import synchronize
from .mesh import _canonical, render_rows, row_shards

TIMEOUT_S = 120  # a rendezvous or collective that waits longer fails


def init_multihost(coordinator: str, num_processes: int, process_id: int, backend: str) -> None:
    """Join the process group (idempotent): coordinator "host:port" (or
    "tcp://host:port") of rank 0's rendezvous, the world size, this
    process's rank and the backend ("gloo" or "nccl")."""
    if dist.is_initialized():
        return
    url = coordinator if coordinator.startswith("tcp://") else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(local_devices) -> list:
    """Every rank's devices in rank order, [(rank, torch.device)]: the
    shards of render_multihost (the reference's 1-D mesh over every device
    of every process). local_devices: this rank's devices."""
    local = [str(_canonical(d)) for d in local_devices]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    return [(rank, torch.device(d)) for rank, devs in enumerate(gathered) for d in devs]


def render_multihost(renderer, mesh) -> tuple:
    """One frame of the renderer's scene over the global mesh (global_mesh):
    the rows split evenly over its shards, this rank rendering its own.
    Returns (aux, [(row_start, accum shard ndarray [rows*W,3]), ...]) for
    this rank's shards; aux["rays"] is the ray count of the whole frame.
    renderer.accum takes this rank's rows (the others' rows keep what they
    held); total_samples and frame_idx advance on every rank."""
    rank = dist.get_rank()
    renderer.sync_scene_changes()
    cfg = renderer._config()
    cfg.check_supported()
    renderer._sync_kernel_tables(cfg)
    frame = renderer._frame_inputs()
    shards = row_shards(cfg.height, len(mesh))
    mine = [(dev, row0, rows) for (r, dev), (row0, rows) in zip(mesh, shards) if r == rank]
    devices = {dev for dev, _, _ in mine} | {renderer.device}
    for d in devices:
        synchronize(d)
    t0 = time.perf_counter()
    results = [(row0, render_rows(renderer, cfg, frame, dev, row0, rows)) for dev, row0, rows in mine]
    coll = _collective_device()
    rays = torch.zeros((), dtype=torch.float64, device=coll)
    for _, (_, aux) in results:
        rays += aux["rays"].to(coll, torch.float64)
    dist.all_reduce(rays)
    for d in devices:
        synchronize(d)
    wall = torch.tensor((time.perf_counter() - t0) * 1000.0, dtype=torch.float64, device=coll)
    dist.broadcast(wall, src=0)  # rank 0's clock for every rank
    w = cfg.width
    accum = renderer.accum.clone()
    local = []
    for row0, (acc, _) in results:
        accum[row0 * w:row0 * w + acc.shape[0]] = acc.to(accum.device)
        local.append((row0, acc.cpu().numpy()))
    renderer.accum = accum
    renderer.total_samples += cfg.spp
    renderer.frame_idx += 1
    aux = dict(results[0][1][1]) if results else {}
    aux["rays"] = rays
    if renderer.adaptive is not None:
        renderer.adaptive.update_global(float(rays), float(wall))
        renderer.spp = renderer.adaptive.spp
    return aux, local


def _check(args) -> str:
    """One rank of the checked two-process render (module docstring)."""
    from ..ops import gather as tgather
    from ..ops import traverse_bvh4 as tb4
    from ..renderer import AdaptiveSampler, GltfRenderer

    device = args.device
    if args.backend == "nccl" and device == "cuda":  # a card of its own for each rank
        device = f"cuda:{args.rank % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(device))
    init_multihost(f"localhost:{args.port}", args.world, args.rank, args.backend)
    try:
        def make():
            r = GltfRenderer(args.size[0], args.size[1], spp=1, max_depth=args.depth, device=device)
            r.create_scene(args.scene)
            if args.hdr:
                r.create_hdr(args.hdr)
            return r

        ref = make()
        ref_aux = ref.on_render()
        want = ref.accum.cpu().numpy()
        r = make()
        mesh = global_mesh([r.device])
        before = (tb4.COUNTER.launches, tgather.COUNTER.launches)
        aux, local = render_multihost(r, mesh)
        launches = (tb4.COUNTER.launches - before[0], tgather.COUNTER.launches - before[1])
        w = args.size[0]
        for row0, shard in local:
            got, exp = shard, want[row0 * w:row0 * w + shard.shape[0]]
            if not np.array_equal(got, exp):
                raise AssertionError(f"rank {args.rank}: the shard at row {row0} differs from the unsharded "
                                     f"frame on {int((got != exp).any(1).sum())} pixels")
        if float(aux["rays"]) != float(ref_aux["rays"]):
            raise AssertionError(f"summed rays {float(aux['rays'])} != unsharded {float(ref_aux['rays'])}")
        ra = make()
        ra.adaptive = AdaptiveSampler(target_fps=10)
        spps = []
        for _ in range(3):
            render_multihost(ra, mesh)
            spps.append(ra.spp)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, spps)
        if any(s != every[0] for s in every):
            raise AssertionError(f"spp sequences diverged across ranks: {every}")
        return (f"MULTIHOST_OK rank={args.rank} world={args.world} backend={args.backend} "
                f"device={r.device} shards={len(local)} rows={[row0 for row0, _ in local]} "
                f"rays={float(aux['rays'])} traverse_bvh4={launches[0]} gather_channels={launches[1]} "
                f"spps={spps}")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of a checked multi-process render")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--scene", required=True)
    p.add_argument("--hdr", default=None)
    p.add_argument("--size", type=int, nargs=2, default=(32, 24))
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    print(_check(args), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
