"""Native (C++) host code with build-on-first-use + ctypes bindings.

The port's own copy of vk_gltf_renderer_tpu/native (binned SAH and the
Morton radix tree over world triangles, bvh_builder.cpp), so the port
imports nothing of the JAX package, the JPEG entropy coder of
ops/jpeg.py (jpeg_entropy.cpp), the WebP pixel codec of ops/webp.py
(webp_decode.cpp), the LZW, PackBits and RLE coders of the BMP, TGA,
GIF and TIFF readers, the GIF writer and the PNG unfilter
(image_coders.cpp), the Zstandard decoder of the TIFF reader
(zstd_decode.cpp), the JPEG 2000 codestream decoder of ops/jpeg2000.py
(j2k_decode.cpp), and the AV1 decoder of ops/avif.py (av1_decode.cpp). Each library is built by g++ at first use
into ``build/native/`` at the repository root (listed in .gitignore),
named by a hash of its source, and renamed into place once complete, so
that concurrent builders never load half a file. The BVH functions return
None when their library cannot be built; ops/bvh_flatten.py then takes its
numpy oracle, and refuses scenes too large for it rather than waiting on a
Python loop. The image coders have no such oracle: jpeg_lib, webp_lib,
image_lib, zstd_lib, j2k_lib and av1_lib raise when their build fails.
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
_WEBP_SRC = Path(__file__).parent / "webp_decode.cpp"
_IMAGE_SRC = Path(__file__).parent / "image_coders.cpp"
_ZSTD_SRC = Path(__file__).parent / "zstd_decode.cpp"
_J2K_SRC = Path(__file__).parent / "j2k_decode.cpp"
_AV1_SRC = Path(__file__).parent / "av1_decode.cpp"
_CACHE = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_lib = None
_lib_failed = False
_jpeg = None
_webp = None
_image = None
_zstd = None
_j2k = None
_av1 = None


def _compile(src_path: Path, defines: tuple = ()) -> Path:
    """Build src_path, with -D of each of `defines`, into
    build/native/<stem>_<hash>.so (once); raises subprocess.SubprocessError
    or OSError when g++ fails or is missing."""
    src = src_path.read_text()
    tag = hashlib.sha256((src + "".join(f"\n-D{d}" for d in defines)).encode()).hexdigest()[:16]
    out = _CACHE / f"{src_path.stem}_{tag}.so"
    if out.exists():
        return out
    _CACHE.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
        *(f"-D{d}" for d in defines), str(src_path), "-o", str(tmp),
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


def _load_coder(src: Path, signatures: dict, defines: tuple = ()):
    """Build src (with `defines`, as _compile) at first use and bind
    `signatures` (name -> argtypes, every function returning int). Raises RuntimeError when the library cannot be
    built or loaded: there is no Python decoder to stand in for it, and a
    RuntimeError is not one of the decode errors that build_texture_pool
    turns into a white texel."""
    try:
        path = _compile(src, defines)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {src.name} failed:\n{e.stderr.decode(errors='replace')}") from e
    except (subprocess.SubprocessError, OSError) as e:
        raise RuntimeError(f"building {src.name} failed: {e}") from e
    try:  # a truncated cache entry or a missing symbol: OSError, AttributeError
        lib = ctypes.CDLL(str(path))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"loading {path} failed: {e}") from e
    return lib


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def jpeg_lib():
    """The JPEG entropy coder (jpeg_entropy.cpp), built at first use
    (_load_coder: RuntimeError when it cannot be built or loaded)."""
    global _jpeg
    if _jpeg is None:
        _jpeg = _load_coder(_JPEG_SRC, {
            "vkgr_jpeg_decode_scan": [_VP, _I64, _I32, _VP, _VP, _I32, _I32, _VP, _VP, _VP, _I32, _I32, _I32,
                                      _I32, _I32, _I32],
            "vkgr_jpeg_decode_scan_arith": [_VP, _I64, _I32, _VP, _VP, _I32, _I32, _VP, _VP, _VP, _I32, _I32, _I32,
                                            _I32, _I32, _I32],
            "vkgr_jpeg_decode_lossless": [_VP, _I64, _I32, _VP, _VP, _I32, _I32, _VP, _VP, _VP, _I32, _I32, _I32,
                                          _I32],
            "vkgr_jpeg_encode_scan": [_VP, _VP, _I64, _VP, _VP, _VP, _VP, _I32, _I32, _VP, _I64, _VP]})
    return _jpeg


def webp_lib():
    """The WebP pixel codec (webp_decode.cpp), built at first use
    (_load_coder: RuntimeError when it cannot be built or loaded)."""
    global _webp
    if _webp is None:
        _webp = _load_coder(_WEBP_SRC, {
            "vkgr_vp8_decode": [_VP, _I64, _I32, _I32, _VP],
            "vkgr_vp8l_decode": [_VP, _I64, _I32, _I32, _I32, _VP],
            "vkgr_alpha_decode": [_VP, _I64, _I32, _I32, _VP],
            "vkgr_vp8l_encode": [_VP, _I32, _I32, _I32, _I32, _VP, _I64, _VP]})
    return _webp


def image_lib():
    """The LZW, PackBits, RLE, QOI, CCITT, bit and FLI coders and the PNG unfilter (image_coders.cpp), built at first
    use (_load_coder: RuntimeError when it cannot be built or loaded)."""
    global _image
    if _image is None:
        _image = _load_coder(_IMAGE_SRC, {
            "vkgr_tiff_lzw": [_VP, _I64, _VP, _I64],
            "vkgr_packbits": [_VP, _I64, _VP, _I64],
            "vkgr_gif_lzw_decode": [_VP, _I64, _I32, _VP, _I32, _I32, _I32],
            "vkgr_gif_lzw_encode": [_VP, _I64, _I32, _VP, _I64, _VP],
            "vkgr_bmp_rle": [_VP, _I64, _I64, _I32, _I32, _I32, _VP, _VP],
            "vkgr_tga_rle": [_VP, _I64, _I32, _I64, _I32, _VP],
            "vkgr_packbits_rows": [_VP, _I64, _I64, _I32, _VP],
            "vkgr_sgi_rle": [_VP, _I64, _I32, _I32, _I32, _I32, _VP],
            "vkgr_pcx_rle": [_VP, _I64, _I64, _I32, _VP],
            "vkgr_sun_rle": [_VP, _I64, _VP, _I64],
            "vkgr_qoi_decode": [_VP, _I64, _I64, _I32, _VP],
            "vkgr_ccitt": [_VP, _I64, _I32, _I32, _I32, _I32, _VP],
            "vkgr_thunderscan": [_VP, _I64, _I32, _I32, _VP],
            "vkgr_png_unfilter": [_VP, _I64, _I64, _I64, _I32, _VP],
            "vkgr_lab_to_rgb": [_VP, _I32, _VP, _I64, _VP],
            "vkgr_msp_rle": [_VP, _I64, _VP, _I32, _I32, _VP, _I64, _VP],
            "vkgr_bit_decode": [_VP, _I64, _I32, _I32, _I32, _VP],
            "vkgr_fli_frame": [_VP, _I64, _I32, _I32, _VP],
            "vkgr_icns_rle": [_VP, _I64, _I64, _VP]})
    return _image


def zstd_lib():
    """The Zstandard decoder (zstd_decode.cpp), built at first use
    (_load_coder: RuntimeError when it cannot be built or loaded)."""
    global _zstd
    if _zstd is None:
        _zstd = _load_coder(_ZSTD_SRC, {"vkgr_zstd_decode": [_VP, _I64, _VP, _I64, _VP]})
    return _zstd


def j2k_lib():
    """The JPEG 2000 codestream decoder (j2k_decode.cpp), built at first use
    (_load_coder: RuntimeError when it cannot be built or loaded)."""
    global _j2k
    if _j2k is None:
        _j2k = _load_coder(_J2K_SRC, {"vkgr_j2k_decode": [_VP, _I64, _VP, _I64, _VP]})
    return _j2k


def av1_lib():
    """The AV1 intra decoder (av1_decode.cpp), built
    at first use (_load_coder: RuntimeError when it cannot be built or
    loaded)."""
    global _av1
    if _av1 is None:
        _av1 = _load_coder(_AV1_SRC, {"vkgr_av1_info": [_VP, _I64, _VP],
                                      "vkgr_av1_decode": [_VP, _I64, _VP, _VP, _I64]})
    return _av1


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
