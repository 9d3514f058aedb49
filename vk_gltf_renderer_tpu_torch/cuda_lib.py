"""Build and load the port's CUDA kernels: nvcc -> one shared library with a
plain C interface, bound through ctypes.

The library is built at first use from ``csrc/*.cu`` into ``build/kernels/``
at the repository root (listed in .gitignore) and named by a hash of its
sources and flags, so a fresh checkout builds it and an edited source
rebuilds it. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.

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

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vkgr_traverse_bvh4": [_P, _P, _I] + [_P] * 8 + [_I, _I] + [_P] * 6 + [_P],
    "vkgr_gather_channels": [_P, _P, _P, _I, _I, ctypes.c_int64, _P],
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


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libvkgr_kernels_{h.hexdigest()[:16]}.so"
    log = ""
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    _loaded = KernelLibrary(out, time.perf_counter() - t0, log)
    return _loaded


class LaunchCounter:
    """Counts a wrapper's kernel launches (plain Python int)."""

    def __init__(self):
        self.launches = 0


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
