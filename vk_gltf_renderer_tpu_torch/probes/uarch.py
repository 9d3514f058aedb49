"""Micro-op probe: the wrapper of csrc/probe_uarch.cu, the H100 counterpart
of the reference's TPU probe tools/uarch_probe.py.

One (8,128) block (1024 threads, thread (s, l) holding element [s, l])
runs `iters` loop steps of one micro-op each (OPS, in the TPU probe's
order): the empty loop, one vector op, a dependent lane gather, 12 lane
gathers, a block-wide sum deciding the loop step, a uniform row load of a
[R,16] table, the same load with its next row chosen by the block's sum
(the traversal loop's dependent shape) and a row load of a [R,128] table.
The output is the accumulator [8,128] f32, plus the SM cycles the loop
took, read with clock64 by thread 0.

    python -m vk_gltf_renderer_tpu_torch.probes.uarch [--iters N]

prints, on the card, ms per launch, ns and SM cycles per step for each op.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cuda_lib import LaunchCounter, check_launch, check_tensor, library
from . import device_ms, require_cuda

N_ITER = 20000
SUB, LANE = 8, 128
ROWS = 4000  # the TPU probe's row modulus
OPS = ("empty", "vec1", "gather", "gather12", "reduce", "dynslice", "depchain", "dynslice128")
REPS = 5  # timed calls per op
COUNTER = LaunchCounter()


def inputs():
    """(tab [8,128], big [4096,16], big128 [4096,128]) f32 of the TPU probe
    (numpy): arange % 101."""
    tab = np.arange(SUB * LANE, dtype=np.float32).reshape(SUB, LANE) % np.float32(101)
    big = np.arange(4096 * 16, dtype=np.float32).reshape(4096, 16) % np.float32(101)
    big128 = np.arange(4096 * LANE, dtype=np.float32).reshape(4096, LANE) % np.float32(101)
    return tab, big, big128


def mkidx():
    """The gathers' first indices [8,128] i32: (l*37 + s) % 128."""
    s, l = np.indices((SUB, LANE), dtype=np.int32)
    return (l * 37 + s) % LANE


def table_of(op, big, big128):
    """The second input of `op`: big128 for dynslice128, else big."""
    _check_op(op)
    return big128 if op == "dynslice128" else big


def _check_op(op):
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; known: {OPS}")


def _check(op, a, b, iters):
    _check_op(op)
    check_tensor("a", a, torch.float32, (SUB, LANE))
    width = LANE if op == "dynslice128" else 16
    check_tensor("b", b, torch.float32, (None, width))
    if b.shape[0] < ROWS:
        raise ValueError(f"b: {b.shape[0]} rows, the ops index {ROWS}")
    if not 0 <= iters < 2**31:
        raise ValueError(f"iters {iters} must be a non-negative int32")


def probe_uarch_plain(op, a, b, iters=N_ITER, stats=None):
    """Plain version of `op`, one Python loop step per micro-op step;
    returns acc [8,128] f32. stats, a dict, receives "rows": the number of
    distinct rows of b the op read."""
    _check(op, a, b, iters)
    acc = a.clone()
    ix = torch.tensor(mkidx(), dtype=torch.int64, device=a.device)
    node = 0
    seen = set()
    if op == "vec1":
        for _ in range(iters):
            acc = acc * 1.000001 + 0.5
    elif op == "gather":
        for _ in range(iters):
            g = torch.gather(a, 1, ix)
            ix = (ix + g.to(torch.int64)) % LANE
            acc = acc + g
    elif op == "gather12":
        k12 = torch.arange(12, device=a.device)
        for _ in range(iters):
            # the 12 gathers in one; their sum is an integer <= 1200, exact in any order
            g = torch.gather(a, 1, ((ix[..., None] + k12) % LANE).reshape(SUB, -1))
            g = g.reshape(SUB, LANE, 12).sum(-1)
            ix = (ix + g.to(torch.int64)) % LANE
            acc = acc + g
    elif op == "reduce":
        i = 0
        while i < iters:
            i += 1 if bool(acc.sum() > -1.0) else 2
            acc = acc * 1.000001
    elif op in ("dynslice", "depchain"):
        col = b[:ROWS, 0]
        for _ in range(iters):
            seen.add(node)
            acc = acc + col[node]
            # integer-valued: below 2**24 any order is exact, above it every float32 is even
            step = int(acc.sum().to(torch.int32)) % 2 if op == "depchain" else 0
            node = (node + 1 + step) % ROWS
    elif op == "dynslice128":
        for _ in range(iters):
            seen.add(node)
            acc = acc + b[node]
            node = (node + 1) % ROWS
    if stats is not None:
        stats["rows"] = len(seen)
    return acc


def probe_uarch(op, a, b, iters=N_ITER):
    """(acc [8,128] f32, SM cycles of the loop or None) of micro-op `op`
    over a [8,128] f32 and b ([>=4000,16] f32, or [>=4000,128] for
    dynslice128). CPU tensors take the plain version (no cycles); CUDA
    tensors launch the kernel or raise."""
    _check(op, a, b, iters)
    if a.device.type == "cpu":
        return probe_uarch_plain(op, a, b, iters), None
    if a.device.type != "cuda":
        raise ValueError(f"probe_uarch: unsupported device {a.device}")
    check_tensor("b", b, torch.float32, None, a.device)
    out = torch.empty((SUB, LANE), dtype=torch.float32, device=a.device)
    cycles = torch.empty(1, dtype=torch.int64, device=a.device)
    rc = library().lib.vkgr_probe_uarch(a.data_ptr(), b.data_ptr(), OPS.index(op), iters, out.data_ptr(),
                                        cycles.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(rc, "probe_uarch")
    COUNTER.launches += 1
    return out, cycles


def run(device, iters=N_ITER):
    """The probe on the card at the TPU probe's inputs: one dict per op
    with op, inputs (a, b), iters, out, ms (mean of REPS calls), ns (per
    step), cycles (SM cycles per step, from clock64 in the first launch)."""
    tab, big, big128 = (torch.tensor(x, device=device) for x in inputs())
    runs = []
    for op in OPS:
        b = table_of(op, big, big128)
        out, cycles = probe_uarch(op, tab, b, iters)
        ms = device_ms(lambda: probe_uarch(op, tab, b, iters), REPS)
        runs.append(dict(op=op, inputs=(tab, b), iters=iters, out=out, ms=ms, ns=ms * 1e6 / iters,
                         cycles=int(cycles.item()) / iters))
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=N_ITER)
    args = ap.parse_args(argv)
    device = require_cuda("probe_uarch")
    print(f"[uarch] {torch.cuda.get_device_name(0)}; {args.iters} steps per op, one block of "
          f"{SUB}x{LANE} threads", flush=True)
    for r in run(device, args.iters):
        plain = probe_uarch_plain(r["op"], *(x.cpu() for x in r["inputs"]), args.iters)
        print(f"[uarch] {r['op']}: {r['ms']:.4f} ms, {r['ns']:.2f} ns and {r['cycles']:.1f} SM cycles "
              f"per step, equal to plain: {torch.equal(r['out'].cpu(), plain)}", flush=True)


if __name__ == "__main__":
    main()
