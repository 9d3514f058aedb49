"""Visit probe: the wrapper of csrc/probe_visit.cu, the H100 counterpart of
the reference's TPU probe tools/exp_visit.py.

A packet of 8x128 rays (one block of 1024 threads) chases a chain of BVH4
rows ([R,32] f32, codes and axes in cols 24:31, the same codes in an int32
sidecar [R,8]): per visit four slab tests over every lane, a packet-wide
any() per child, the near-order permutation of the four codes by the
three axes, four pushes gated by the votes (sp capped at 200), next row
c0 % R. The output per grid step is e + sp, broadcast to its [1,8,128]
block, as the TPU probe writes it.

Variants (VARIANTS: name -> independent chains per packet): a reads codes
and axes from the float row, b from the sidecar (the v7 choice), c is b's
computation on the card (on the TPU it broadcast box floats as (1,1)
vector slices instead of extracting them, which has no counterpart here);
d, e and q interleave 2, 4 and 8 chains in one packet, each over its own
rows of lanes, with sidecar codes, visits/ways steps each, and output the
sum over chains.

    python -m vk_gltf_renderer_tpu_torch.probes.visit [--visits V] [--variants a,b,...]

prints, on the card, ms per launch, ns per visit and ns per dependent step
for each variant at the TPU probe's sizes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cuda_lib import LaunchCounter, check_launch, check_tensor, library
from . import device_ms, require_cuda

N = 512  # BVH4 rows of the TPU probe's table
VISITS = 4096  # visits per packet
GRID = 32  # packets
SUB, LANE = 8, 128
SP_CAP = 200
VARIANTS = {"a": 1, "b": 1, "c": 1, "d": 2, "e": 4, "q": 8}
COUNTER = LaunchCounter()


def make_tables(seed=0, rows=N):
    """(fi [rows,32] f32, sc [rows,8] i32) of the TPU probe (numpy): random
    boxes, chain pointer in child code 0, random codes and axes in 0..2."""
    rng = np.random.RandomState(seed)
    fi = rng.rand(rows, 32).astype(np.float32)
    nxt = rng.randint(0, rows, rows)
    fi[:, 24] = nxt
    fi[:, 25:28] = rng.randint(0, rows, (rows, 3))
    fi[:, 28:31] = rng.randint(0, 3, (rows, 3))
    sc = np.zeros((rows, 8), np.int32)
    sc[:, 0] = nxt
    sc[:, 1:4] = fi[:, 25:28].astype(np.int32)
    sc[:, 4:7] = fi[:, 28:31].astype(np.int32)
    return fi, sc


def make_rays(grid=GRID, seed=1):
    """Packets of ray origins [grid,4,SUB,LANE] f32 (numpy), the TPU
    probe's RandomState(1) rays; channels 0..2 are read."""
    return np.random.RandomState(seed).rand(grid, 4, SUB, LANE).astype(np.float32)


def _ways(variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {sorted(VARIANTS)}")
    return VARIANTS[variant]


def probe_visit_plain(fi, sc, ro, visits, variant, stats=None):
    """Plain version, every packet's chains advanced one visit per loop
    iteration. The stack's contents never reach the output, so it counts
    the pushes without storing them. stats, a dict, receives "rows": a
    mask of the table rows visited."""
    ways = _ways(variant)
    g, rows = ro.shape[0], fi.shape[0]
    lanes = ro[:, 0:3].reshape(g, 3, ways, -1)
    rox, roy, roz = lanes[:, 0], lanes[:, 1], lanes[:, 2]
    ix, iy, iz = rox * 0.5 + 1.0, roy * 0.5 + 1.0, roz * 0.5 + 1.0
    w = torch.arange(ways, device=ro.device)
    e = (w if ways > 1 else torch.zeros_like(w)).expand(g, ways).clone()
    sp = (w * (SP_CAP // ways)).expand(g, ways).clone()
    seen = None
    if stats is not None:
        seen = stats["rows"] = torch.zeros(rows, dtype=torch.bool, device=ro.device)
    for _ in range(visits // ways):
        f = fi[e]
        if seen is not None:
            seen[e] = True
        votes = []
        for s in range(4):
            def b(k, o=6 * s):
                return f[..., o + k, None]

            t0x = (b(0) - rox) * ix
            t1x = (b(3) - rox) * ix
            t0y = (b(1) - roy) * iy
            t1y = (b(4) - roy) * iy
            t0z = (b(2) - roz) * iz
            t1z = (b(5) - roz) * iz
            tnear = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                                  torch.clamp(torch.minimum(t0z, t1z), min=0.0))
            tfar = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                                 torch.clamp(torch.maximum(t0z, t1z), max=1e30))
            votes.append((tnear <= tfar).any(-1))
        c0 = f[..., 24].long() if variant == "a" else sc[e, 0].long()
        # pushes gated by the votes of children 1, 2, 3, 0 (the TPU probe's pairing)
        sp = torch.clamp(sp + sum(v.long() for v in votes), max=SP_CAP)
        e = c0 % rows
    val = e + sp if ways == 1 else (e.sum(1) + sp.sum(1))[:, None]
    return val.to(torch.float32).reshape(g, 1, 1, 1).expand(g, 1, SUB, LANE).contiguous()


def probe_visit(fi, sc, ro, visits, variant):
    """Output [grid,1,8,128] f32 of the probe over fi [R,32] f32, sc [R,8]
    i32 (codes in [0, 2**24)) and ro [grid,4,8,128] f32. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    ways = _ways(variant)
    if ro.device.type == "cpu":
        return probe_visit_plain(fi, sc, ro, visits, variant)
    if ro.device.type != "cuda":
        raise ValueError(f"probe_visit: unsupported device {ro.device}")
    dev = ro.device
    g = ro.shape[0]
    check_tensor("ro", ro, torch.float32, (None, 4, SUB, LANE), dev)
    check_tensor("fi", fi, torch.float32, (None, 32), dev)
    check_tensor("sc", sc, torch.int32, (fi.shape[0], 8), dev)
    out = torch.empty((g, 1, SUB, LANE), dtype=torch.float32, device=dev)
    if g == 0:
        return out
    rc = library().lib.vkgr_probe_visit(fi.data_ptr(), sc.data_ptr(), ro.data_ptr(), g, fi.shape[0],
                                        visits, ways, int(variant == "a"), out.data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "probe_visit")
    COUNTER.launches += 1
    return out


def measure(fi, sc, ro, visits, variant, reps=5):
    """(out, ms per launch, ns per visit, ns per dependent step) of the
    kernel on the card; a packet of `ways` chains takes visits/ways
    dependent steps of `ways` visits each."""
    out = probe_visit(fi, sc, ro, visits, variant)
    ms = device_ms(lambda: probe_visit(fi, sc, ro, visits, variant), reps)
    return out, ms, ms * 1e6 / visits, ms * 1e6 / (visits // VARIANTS[variant])


def run(device, visits=VISITS, grid=GRID, variants=tuple(VARIANTS), reps=5):
    """The probe on the card at the TPU probe's tables: one dict per
    variant with variant, inputs (fi, sc, ro), visits, out, ms, ns (per
    visit) and ns_step (per dependent step)."""
    fi, sc = (torch.tensor(a, device=device) for a in make_tables())
    ro = torch.tensor(make_rays(grid), device=device)
    runs = []
    for variant in variants:
        out, ms, ns, ns_step = measure(fi, sc, ro, visits, variant, reps)
        runs.append(dict(variant=variant, inputs=(fi, sc, ro), visits=visits, out=out, ms=ms, ns=ns,
                         ns_step=ns_step))
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--visits", type=int, default=VISITS)
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    device = require_cuda("probe_visit")
    print(f"[visit] {torch.cuda.get_device_name(0)}; {args.visits} visits x {args.grid} packets of "
          f"{SUB}x{LANE} lanes", flush=True)
    for r in run(device, args.visits, args.grid, args.variants.split(",")):
        equal = torch.equal(r["out"], probe_visit_plain(*r["inputs"], args.visits, r["variant"]))
        print(f"[visit] {r['variant']} ({VARIANTS[r['variant']]} chain(s)): {r['ms']:.3f} ms, "
              f"{r['ns']:.1f} ns per visit, {r['ns_step']:.1f} ns per dependent step, equal to "
              f"plain: {equal}", flush=True)


if __name__ == "__main__":
    main()
