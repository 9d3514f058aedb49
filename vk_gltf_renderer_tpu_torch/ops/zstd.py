"""Zstandard decompression without the zstandard package: the port's own
frame decoder (native/zstd_decode.cpp, RFC 8878; no dictionaries), for
TIFF's compression 50000 (ops/tiff.py)."""

from __future__ import annotations

import numpy as np

ERRORS = {-1: "corrupt data", -2: "truncated data", -3: "more data than expected", -4: "an unsupported frame",
          -5: "a content checksum mismatch"}


def decompress(data: bytes, limit: int) -> bytes:
    """Every frame of data (skippable frames passed over), at most limit
    bytes; ValueError for corrupt, truncated or unsupported data or more
    than limit bytes."""
    from ..native import zstd_lib

    src = np.frombuffer(data, np.uint8)
    n = np.zeros(1, np.int64)
    if limit > 1 << 26:  # a loose limit: measure first rather than allocate all of it
        _check(zstd_lib().vkgr_zstd_decode(src.ctypes.data, len(src), None, limit, n.ctypes.data))
        limit = int(n[0])
    out = np.empty(max(limit, 1), np.uint8)
    _check(zstd_lib().vkgr_zstd_decode(src.ctypes.data, len(src), out.ctypes.data, limit, n.ctypes.data))
    return out[: int(n[0])].tobytes()


def _check(rc: int) -> None:
    if rc != 0:
        raise ValueError(f"zstd: {ERRORS.get(rc, 'corrupt data')} (rc {rc})")
