"""Node-fetch probe: the wrapper of csrc/probe_nodefetch.cu, the H100
counterpart of the reference's TPU probe tools/exp_nodefetch.py.

Every lane chases a chain of 64-byte rows ([R,16] f32, next-row pointer in
column 15) for `visits` steps and accumulates (f[1] - rox) *
(f[0]+f[3]+f[6]+f[9]+f[12]+f[14]); all 32 lanes of a warp follow one
chain. At the TPU probe's sizes (tpu_inputs: its table, every chain from
row 0, GRID packets of 8x128 lanes) the output is the TPU probe's
[GRID,8,128] accumulator, flattened. The TPU variants a-d read the same
bytes as [R,16] or [R/8,128] and differ only in how Mosaic extracts the 16
floats, so here they are one computation: probe_nodefetch takes either
shape (variant_table) and returns the same array.

chain_inputs builds tables of any size whose rows form one random cycle,
one chain per warp from random rows: at the terrain's nodes4_fi size (11
MB, in the 50 MB L2) and past L2 they give the cost of a dependent row
fetch from L2 and from HBM. Run with 32 warps per block (the TPU layout,
where the SM's issue and load throughput shares the step) and with one
warp per block and SM (the chain's latency alone).

    python -m vk_gltf_renderer_tpu_torch.probes.nodefetch [--visits V] [--rows R ...]

prints, on the card, ms per launch and ns per dependent visit for each
variant at the TPU probe's sizes and for each table size given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cuda_lib import LaunchCounter, check_launch, check_tensor, library
from . import device_ms, require_cuda

N = 8192  # rows of the TPU probe's table
VISITS = 4096  # chain steps per lane
GRID = 64  # packets (blocks of SUB x LANE lanes)
SUB, LANE = 8, 128
WARP = 32
VARIANTS = ("a", "b", "c", "d")
ROW_BYTES = 64
TERRAIN_ROWS = 86_100 * 128 // ROW_BYTES  # the terrain's nodes4_fi bytes (11.0 MB)
PAST_L2_ROWS = 1 << 22  # 268 MB of rows, 5x the 50 MB L2
BLOCK = SUB * LANE  # threads per block in the TPU layout
COUNTER = LaunchCounter()


def tpu_table(rows=N, seed=0):
    """The TPU probe's table (numpy): RandomState(seed).rand(rows, 16) f32
    with column 15 replaced by a random next-row pointer."""
    rng = np.random.RandomState(seed)
    tab = rng.rand(rows, 16).astype(np.float32)
    tab[:, 15] = rng.randint(0, rows, rows)
    return tab


def variant_table(tab16, variant):
    """The table as TPU variant `variant` reads it: [R,16] for a, the same
    bytes as [R/8,128] for b, c and d."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    return tab16 if variant == "a" else tab16.reshape(-1, 8 * 16)


def tpu_rays(lanes=GRID * BLOCK, seed=1):
    """Per-lane ray origins x [lanes] f32 (numpy): channel 0 of
    RandomState(seed).rand(grid, 4, SUB, LANE) in packet order, the layout
    of the TPU probes (whose own bench passes zeros)."""
    grid = -(-lanes // BLOCK)
    ro = np.random.RandomState(seed).rand(grid, 4, SUB, LANE).astype(np.float32)
    return np.ascontiguousarray(ro[:, 0].reshape(-1)[:lanes])


def tpu_inputs(device, lanes=GRID * BLOCK):
    """(tab [N,16], start, rox) of the TPU probe: its table, every warp's
    chain from row 0."""
    tab = torch.tensor(tpu_table(), device=device)
    start = torch.zeros(lanes // WARP, dtype=torch.int32, device=device)
    return tab, start, torch.tensor(tpu_rays(lanes), device=device)


def chain_inputs(rows, device, lanes=GRID * BLOCK, seed=0):
    """(tab [rows,16], start, rox): random rows linked by column 15 into
    one random cycle through all of them, and one chain per warp of
    `lanes` from a random row, made on `device`."""
    if not 0 < rows < 2**24:
        raise ValueError("rows must be in (0, 2**24): column 15 holds row ids as float32")
    g = torch.Generator(device=device).manual_seed(seed)
    tab = torch.rand((rows, 16), generator=g, device=device)
    perm = torch.randperm(rows, generator=g, device=device)
    nxt = torch.empty(rows, dtype=torch.int64, device=device)
    nxt[perm] = perm.roll(-1)
    tab[:, 15] = nxt.to(torch.float32)
    start = torch.randint(0, rows, (lanes // WARP,), generator=g, device=device, dtype=torch.int32)
    return tab, start, torch.tensor(tpu_rays(lanes), device=device)


def probe_nodefetch_plain(tab, start, rox, visits, stats=None):
    """Plain version: every chain advanced one step per loop iteration.
    stats, a dict, receives "rows": a mask of the rows read."""
    t16 = tab.reshape(-1, 16)
    e = start.long()
    ro = rox.reshape(-1, WARP)
    acc = torch.zeros_like(ro)
    seen = None
    if stats is not None:
        seen = stats["rows"] = torch.zeros(t16.shape[0], dtype=torch.bool, device=tab.device)
    for _ in range(visits):
        f = t16[e]
        if seen is not None:
            seen[e] = True
        s = f[:, 0] + f[:, 3]
        s = s + f[:, 6]
        s = s + f[:, 9]
        s = s + f[:, 12]
        s = s + f[:, 14]
        acc = acc + (f[:, 1:2] - ro) * s[:, None]
        e = f[:, 15].long()
    return acc.reshape(-1)


def probe_nodefetch(tab, start, rox, visits, block=BLOCK):
    """Accumulators [n] f32 of n lanes (rox [n] f32, n a multiple of 32)
    chasing chains from start [n/32] i32 through tab ([R,16] f32, or the
    same bytes as [R/8,128]); column 15 must hold row ids < R. block:
    threads per block of the launch (a multiple of 32 up to 1024), which
    changes the schedule, not the result. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if block % WARP or not 0 < block <= BLOCK:
        raise ValueError(f"probe_nodefetch: block {block} is not a multiple of {WARP} up to {BLOCK}")
    if tab.device.type == "cpu":
        return probe_nodefetch_plain(tab, start, rox, visits)
    if tab.device.type != "cuda":
        raise ValueError(f"probe_nodefetch: unsupported device {tab.device}")
    dev = tab.device
    if tab.ndim != 2 or tab.shape[1] not in (16, 128):
        raise ValueError(f"tab: expected [R,16] or [R,128], got {tuple(tab.shape)}")
    check_tensor("tab", tab, torch.float32, None, dev)
    n = rox.shape[0]
    if n % WARP or n >= 2**31:
        raise ValueError(f"probe_nodefetch: {n} lanes is not a multiple of {WARP} below 2**31")
    check_tensor("rox", rox, torch.float32, (n,), dev)
    check_tensor("start", start, torch.int32, (n // WARP,), dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    rc = library().lib.vkgr_probe_nodefetch(tab.data_ptr(), start.data_ptr(), rox.data_ptr(), n,
                                            visits, block, out.data_ptr(),
                                            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "probe_nodefetch")
    COUNTER.launches += 1
    return out


def measure(tab, start, rox, visits, block=BLOCK, reps=5):
    """(out, ms per launch, ns per dependent visit) of the kernel on the
    card: every chain takes `visits` dependent steps side by side."""
    out = probe_nodefetch(tab, start, rox, visits, block)
    ms = device_ms(lambda: probe_nodefetch(tab, start, rox, visits, block), reps)
    return out, ms, ms * 1e6 / visits


def run(device, visits=VISITS, rows=(TERRAIN_ROWS, PAST_L2_ROWS), reps=5):
    """The probe on the card: every variant at the TPU probe's sizes, then
    a random-cycle table of each size in `rows`, each table (the TPU one
    included) also with one warp per block and SM. Returns one dict per
    run: label, inputs (tab, start, rox), visits, block, out, ms, ns (per
    dependent visit)."""
    runs = []

    def one(label, inputs, block):
        out, ms, ns = measure(*inputs, visits, block, reps)
        runs.append(dict(label=label, inputs=inputs, visits=visits, block=block, out=out, ms=ms,
                         ns=ns))

    tab, start, rox = tpu_inputs(device)
    for variant in VARIANTS:
        one(f"variant {variant}", (variant_table(tab, variant), start, rox), BLOCK)
    for r in rows:
        one(f"{r}-row cycle", chain_inputs(r, device), BLOCK)
    one_per_sm = WARP * torch.cuda.get_device_properties(device).multi_processor_count
    one("TPU table, 1 warp per SM", tpu_inputs(device, one_per_sm), WARP)
    for r in rows:
        one(f"{r}-row cycle, 1 warp per SM", chain_inputs(r, device, one_per_sm), WARP)
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--visits", type=int, default=VISITS)
    ap.add_argument("--rows", type=int, nargs="*", default=[TERRAIN_ROWS, PAST_L2_ROWS],
                    help="random-cycle table sizes (rows of 64 B) to run after the TPU sizes")
    args = ap.parse_args(argv)
    device = require_cuda("probe_nodefetch")
    print(f"[nodefetch] {torch.cuda.get_device_name(0)}; {args.visits} visits per lane", flush=True)
    for run_ in run(device, args.visits, args.rows):
        tab, start, rox = run_["inputs"]
        err = float((run_["out"] - probe_nodefetch_plain(*run_["inputs"], args.visits)).abs().max())
        print(f"[nodefetch] {run_['label']}: table {tuple(tab.shape)} "
              f"({tab.numel() * 4 / 1e6:.1f} MB), {start.numel()} chains in blocks of "
              f"{run_['block']} threads: {run_['ms']:.3f} ms, "
              f"{run_['ns']:.1f} ns per dependent visit, max |kernel - plain| {err:.3g}", flush=True)


if __name__ == "__main__":
    main()
