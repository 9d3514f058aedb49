"""Build and load the port's CUDA kernels: nvcc -> one shared library with a
plain C interface, bound through ctypes; plus the checks and counters that
every kernel wrapper shares.

The library is built at first use from ``csrc/*.cu`` (which include
``csrc/*.cuh``) into ``build/kernels/`` at the repository root (listed in
.gitignore) and named by a hash of its sources and flags, so a fresh
checkout builds it and an edited source rebuilds it; the build's compiler
output (ptxas registers and spills) is kept beside it, so a library loaded
from that cache reports it too. Each .cu compiles to
its own object in a separate nvcc process, all started together, and one
nvcc call links them. Nothing here runs at import time: the CPU tests
import every module on a machine without nvcc.

Flags: sm_90a (Hopper), -O3, and -fmad=false so no multiply-add is
contracted and the kernels stay within an ulp or two of their plain torch
versions. No --use_fast_math.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
]
LINK_FLAGS = ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# (tables, root code, 8 ray components, n, anyhit, 5 outputs, overflow, stream)
_TRAVERSE = [_P, _P, _I] + [_P] * 8 + [_I, _I] + [_P] * 5 + [_P, _P]
_SIGNATURES = {
    # (... as _TRAVERSE up to the overflow counter, scratch, stream)
    "vkgr_traverse_bvh2": _TRAVERSE[:-1] + [_P, _P],
    "vkgr_traverse_bvh4": _TRAVERSE[:-1] + [_P, _P],
    "vkgr_traverse_bvh4_multipop": _TRAVERSE[:-1] + [_P, _P],
    "vkgr_traverse_bvh4_leafqueue": _TRAVERSE[:-1] + [_P, _P],
    # (nodes4_fi, nodes4_sc, tris128, root code, rays, ... as vkgr_traverse_bvh4)
    "vkgr_traverse_bvh4_sidecar": [_P] + _TRAVERSE[:-1] + [_P, _P],
    "vkgr_traverse_bvh16": _TRAVERSE[:-1] + [_P, _P],
    # (node table, meta table, tris, 8 ray components, n, 5 outputs, overflow, scratch, stream):
    # no root code (node 0) and no any-hit flag; v1 also takes root_leaf (node 0 is a leaf)
    # after the tables
    "vkgr_traverse_bvh4_split": [_P] * 3 + [_P] * 8 + [_I] + [_P] * 5 + [_P, _P, _P],
    "vkgr_traverse_bvh2_split": [_P] * 3 + [_I] + [_P] * 8 + [_I] + [_P] * 5 + [_P, _P, _P],
    # (nodes4_fi, tris128, root code, ro, rd, seeds, n, per packet, depth, out, overflow, path
    # cursor, stream)
    "vkgr_render_mega": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # (entries, n_entries, 8 ray components, n, anyhit, 5 outputs, bad links, scratch, stream)
    "vkgr_traverse_lanes": [_P, _I] + [_P] * 8 + [_I, _I] + [_P] * 5 + [_P, _P, _P],
    "vkgr_gather_channels": [_P, _P, _P, _I, _I, ctypes.c_int64, _P],
    # probes: (tab, start, rox, n, visits, threads per block, out, stream)
    "vkgr_probe_nodefetch": [_P, _P, _P, _I, _I, _I, _P, _P],
    # (fi, sc, ro, grid, rows, visits, ways, codes from the float row, out, stream)
    "vkgr_probe_visit": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # (tab, n_pages, fields, copy, dyn, double buffered, blocks, steps, out, stream)
    "vkgr_probe_stream_dma": [_P] + [_I] * 7 + [_P, _P],
    # (a, b, op, iters, out, cycles, stream)
    "vkgr_probe_uarch": [_P, _P, _I, _I, _P, _P, _P],
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: float, compiler_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.compiler_log = compiler_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _compile(nvcc: str, sources, tmpdir: Path):
    """nvcc -c for every source at once; returns (objects, log)."""
    procs = []
    for src in sources:
        obj = tmpdir / (src.stem + ".o")
        cmd = [nvcc, *COMPILE_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj), str(src)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate(timeout=600)
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    return [obj for _, obj, _ in procs], "\n".join(log)


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for s in sorted(_CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libvkgr_kernels_{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")  # the build's compiler output, kept beside the library
    log = log_path.read_text() if out.exists() and log_path.exists() else ""
    t0 = time.perf_counter()
    if not out.exists():
        nvcc = _nvcc()
        tmpdir = BUILD_DIR / f"objs.{os.getpid()}"
        tmpdir.mkdir(parents=True, exist_ok=True)
        objs, log = _compile(nvcc, sources, tmpdir)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, timeout=600)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        shutil.rmtree(tmpdir, ignore_errors=True)
    _loaded = KernelLibrary(out, time.perf_counter() - t0, log)
    return _loaded


class LaunchCounter:
    """Counts a wrapper's kernel launches (plain Python int)."""

    def __init__(self):
        self.launches = 0


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


class OverflowCounter:
    """A wrapper's count of dropped work (traversal stack pushes, lane
    links that do not advance): a plain int for CPU runs plus one int32
    device counter per CUDA device, which the kernels add to."""

    def __init__(self):
        self.cpu = 0
        self.dev: dict = {}  # torch.device -> [1] int32

    def buffer(self, dev) -> torch.Tensor:
        if dev not in self.dev:
            self.dev[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
        return self.dev[dev]

    def total(self) -> int:
        """Count so far; reading a device counter synchronises with it."""
        return self.cpu + sum(int(b.item()) for b in self.dev.values())

    def reset(self) -> None:
        self.cpu = 0
        for b in self.dev.values():
            b.zero_()


def check_tensor(name, t, dtype, shape=None, dev=None):
    """Raise unless t has the dtype (and shape, device) a kernel takes, is
    contiguous and 16-byte aligned. A None entry of shape matches any size."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and (t.ndim != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if dev is not None and t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
