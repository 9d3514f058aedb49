"""Native (C++) host code with build-on-first-use + ctypes bindings.

The port's own copy of vk_gltf_renderer_tpu/native (binned SAH and the
Morton radix tree over world triangles, bvh_builder.cpp), so the port
imports nothing of the JAX package, and the JPEG entropy coder of
ops/jpeg.py (jpeg_entropy.cpp). Each library is built by g++ at first use
into ``build/native/`` at the repository root (listed in .gitignore),
named by a hash of its source, and renamed into place once complete, so
that concurrent builders never load half a file. The BVH functions return
None when their library cannot be built; ops/bvh_flatten.py then takes its
numpy oracle, and refuses scenes too large for it rather than waiting on a
Python loop. The JPEG coder has no such oracle: jpeg_lib raises when its
build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "bvh_builder.cpp"
_JPEG_SRC = Path(__file__).parent / "jpeg_entropy.cpp"
_CACHE = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_lib = None
_lib_failed = False
_jpeg = None


def _compile(src_path: Path) -> Path:
    """Build src_path into build/native/<stem>_<hash>.so (once); raises
    subprocess.SubprocessError or OSError when g++ fails or is missing."""
    src = src_path.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    out = _CACHE / f"{src_path.stem}_{tag}.so"
    if out.exists():
        return out
    _CACHE.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
        str(src_path), "-o", str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)  # atomic: concurrent builders never load half a file
    return out


def _build_lib() -> Path | None:
    try:
        return _compile(_SRC)
    except (subprocess.SubprocessError, OSError) as e:
        print(f"[vkgr.native] build failed ({e}); using numpy fallback", file=sys.stderr)
        return None


def jpeg_lib():
    """The JPEG entropy coder (jpeg_entropy.cpp), built at first use.
    Raises RuntimeError when it cannot be built or loaded: there is no
    Python decoder to stand in for it, and a RuntimeError is not one of
    the decode errors that build_texture_pool turns into a white texel."""
    global _jpeg
    if _jpeg is not None:
        return _jpeg
    try:
        path = _compile(_JPEG_SRC)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {_JPEG_SRC.name} failed:\n{e.stderr.decode(errors='replace')}") from e
    except (subprocess.SubprocessError, OSError) as e:
        raise RuntimeError(f"building {_JPEG_SRC.name} failed: {e}") from e
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    try:  # a truncated cache entry or a missing symbol: OSError, AttributeError
        lib = ctypes.CDLL(str(path))
        lib.vkgr_jpeg_decode_scan.restype = ctypes.c_int
        lib.vkgr_jpeg_decode_scan.argtypes = [vp, i64, i32, vp, vp, i32, i32, vp, vp, vp, i32, i32, i32, i32,
                                              i32, i32]
        lib.vkgr_jpeg_encode_scan.restype = ctypes.c_int
        lib.vkgr_jpeg_encode_scan.argtypes = [vp, vp, i64, vp, vp, vp, vp, i32, i32, vp, i64, vp]
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"loading {path} failed: {e}") from e
    _jpeg = lib
    return _jpeg


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    path = _build_lib()
    if path is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.vkgr_build_radix_tree.restype = ctypes.c_int
    lib.vkgr_build_radix_tree.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vkgr_build_sah.restype = ctypes.c_int
    lib.vkgr_build_sah.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def build_sah_native(tlo: np.ndarray, thi: np.ndarray, cen: np.ndarray, leaf_size: int):
    """Binned-SAH build in C++ (parallel near the root).

    Returns (perm [n] i64, nodes_i [nn,8] i32, nodes_f [nn,16] f32,
    nodes_self [nn,8] f32) in the ops.bvh_flatten layout, or None if the
    native library is unavailable. Same contract as
    ops.bvh_flatten._build_sah (the numpy oracle)."""
    lib = get_lib()
    if lib is None:
        return None
    n = tlo.shape[0]
    tlo = np.ascontiguousarray(tlo, np.float32)
    thi = np.ascontiguousarray(thi, np.float32)
    cen = np.ascontiguousarray(cen, np.float32)
    perm = np.empty(n, np.int32)
    cap = 2 * n
    nodes_i = np.empty((cap, 8), np.int32)
    nodes_f = np.zeros((cap, 16), np.float32)
    nodes_self = np.empty((cap, 8), np.float32)
    out_nn = np.zeros(1, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.vkgr_build_sah(
        n, p(tlo, ctypes.c_float), p(thi, ctypes.c_float), p(cen, ctypes.c_float),
        leaf_size, p(perm, ctypes.c_int32), p(nodes_i, ctypes.c_int32),
        p(nodes_f, ctypes.c_float), p(nodes_self, ctypes.c_float),
        p(out_nn, ctypes.c_int64),
    )
    if rc != 0:
        return None
    nn = int(out_nn[0])
    return (
        perm.astype(np.int64),
        np.ascontiguousarray(nodes_i[:nn]),
        np.ascontiguousarray(nodes_f[:nn]),
        np.ascontiguousarray(nodes_self[:nn]),
    )


def build_radix_tree_native(tlo: np.ndarray, thi: np.ndarray, cen: np.ndarray):
    """Morton sort + Karras radix tree in C++ (multithreaded).

    Returns (order [n] i64, left, right, leaf_l, leaf_r) with the same
    semantics as ops.bvh._build_radix_tree over morton-sorted keys, or None
    if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = tlo.shape[0]
    tlo = np.ascontiguousarray(tlo, np.float32)
    thi = np.ascontiguousarray(thi, np.float32)
    cen = np.ascontiguousarray(cen, np.float32)
    order = np.empty(n, np.int32)
    ni = max(n - 1, 1)
    left = np.empty(ni, np.int32)
    right = np.empty(ni, np.int32)
    leaf_l = np.empty(ni, np.uint8)
    leaf_r = np.empty(ni, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.vkgr_build_radix_tree(
        n, p(tlo, ctypes.c_float), p(thi, ctypes.c_float), p(cen, ctypes.c_float),
        p(order, ctypes.c_int32), p(left, ctypes.c_int32), p(right, ctypes.c_int32),
        p(leaf_l, ctypes.c_uint8), p(leaf_r, ctypes.c_uint8),
    )
    if rc != 0:
        return None
    return (
        order.astype(np.int64),
        left.astype(np.int64),
        right.astype(np.int64),
        leaf_l.astype(bool),
        leaf_r.astype(bool),
    )
