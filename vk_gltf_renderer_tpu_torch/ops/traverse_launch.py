"""The shared body of the traversal kernel wrappers (ops/traverse_bvh2*.py,
traverse_bvh4*.py, traverse_bvh16.py, lane_traverse.py).

run_traversal takes CPU rays to the kernel's plain torch version and CUDA
rays to the kernel; any other device raises, and nothing falls back from
one to the other. On the card it checks every table and ray component
(dtype, shape, device, contiguity, 16-byte alignment), allocates the five
outputs, launches on the current stream, raises if the launch failed, and
counts the launch.

The kernels with live-lane compaction (csrc/live_lanes.cuh: traverse_bvh4,
the lane walk, v5, traverse_bvh2, traverse_bvh16, v7, packet4, v8 and v1) also
take a scratch buffer, list_scratch(n, device), through run_traversal's
`extra`: the kernel's entry zeroes its live count
and work cursor on the stream, compact_lanes writes the dead lanes'
results and lists the live lanes, and a persistent grid walks the list;
nothing is read back on the host.
"""

from __future__ import annotations

import torch

from ..cuda_lib import check_launch, check_tensor, library

RAY_NAMES = ("rox", "roy", "roz", "rdx", "rdy", "rdz", "tmin", "tmax")
SCRATCH_HEADER = 4  # live count, work cursor, pad: the list starts 16 bytes in


def scratch_words(n: int) -> int:
    """int32 words of a compacting kernel's scratch for n lanes: the
    header, then the list of live lanes (at most n)."""
    return SCRATCH_HEADER + n


def list_scratch(n, dev):
    """run_traversal's `extra` for a compacting kernel: its scratch."""
    return (torch.empty(scratch_words(n), dtype=torch.int32, device=dev),)


def run_traversal(name, counter, overflow, plain, tables, scalars, rays, anyhit, extra=None):
    """(t, rnode, tri, u, v) of the [N] f32 ray components `rays`.

    plain: zero-argument call of the plain version, returning the five
    outputs and a dropped-work count (CPU rays). tables: (name, tensor,
    expected shape[, dtype, default float32]) of every table argument, in
    the C entry point's order; scalars: the int arguments
    between the tables and the rays of the C entry point vkgr_<name>;
    anyhit None: the entry point takes no any-hit flag (closest hit).
    extra: None, or a call (n, device) -> the tensors that the entry point
    takes as pointers after the overflow counter; they live until the
    launch has been issued."""
    rox = rays[0]
    if rox.device.type == "cpu":
        *out, dropped = plain()
        overflow.cpu += dropped
        return tuple(out)
    if rox.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rox.device}")
    dev = rox.device
    n = rox.shape[0]
    if n >= 2**31:
        raise ValueError(f"{name}: at most 2**31-1 rays per launch")
    for tname, t, shape, *dtype in tables:
        check_tensor(tname, t, dtype[0] if dtype else torch.float32, shape, dev)
    for rname, c in zip(RAY_NAMES, rays, strict=True):
        check_tensor(rname, c, torch.float32, (n,), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    rnode = torch.empty(n, dtype=torch.int32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, rnode, tri, u, v
    fn = getattr(library().lib, f"vkgr_{name}")
    flag = () if anyhit is None else (int(bool(anyhit)),)
    tail = () if extra is None else extra(n, dev)
    rc = fn(*(tab[1].data_ptr() for tab in tables), *(int(s) for s in scalars),
            *(c.data_ptr() for c in rays), n, *flag,
            t.data_ptr(), rnode.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            overflow.buffer(dev).data_ptr(),
            *(a.data_ptr() for a in tail),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, name)
    counter.launches += 1
    return t, rnode, tri, u, v

