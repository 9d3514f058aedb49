"""glTF accessor decode/encode <-> numpy.

Covers the full accessor feature set the reference consumes through tinygltf:
all component types, `normalized` integers, interleaved bufferViews
(byteStride), sparse accessors, and accessors without a bufferView (zeros).
"""

from __future__ import annotations

import numpy as np

from .gltf import GltfModel

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


def component_dtype(component_type: int) -> np.dtype:
    return np.dtype(_COMPONENT_DTYPES[component_type])


def num_components(type_str: str) -> int:
    return _TYPE_COUNTS[type_str]


def _read_raw(model: GltfModel, bv_index: int, byte_offset: int, count: int, ncomp: int, dtype: np.dtype) -> np.ndarray:
    bv = model.buffer_views[bv_index]
    buf = model.buffers[bv.get("buffer", 0)]
    start = bv.get("byteOffset", 0) + byte_offset
    elem_size = dtype.itemsize * ncomp
    stride = bv.get("byteStride", 0) or elem_size
    mem = memoryview(buf)
    if stride == elem_size:
        out = np.frombuffer(mem, dtype=dtype, count=count * ncomp, offset=start)
        return out.reshape(count, ncomp)
    # Interleaved: strided view over raw bytes.
    raw = np.frombuffer(mem, dtype=np.uint8, count=stride * (count - 1) + elem_size, offset=start)
    strided = np.lib.stride_tricks.as_strided(raw, shape=(count, elem_size), strides=(stride, 1))
    return strided.copy().view(dtype).reshape(count, ncomp)


def read_accessor(model: GltfModel, accessor_index: int, *, dequantize: bool = True) -> np.ndarray:
    """Decode accessor -> numpy [count, ncomp] (SCALAR squeezed to [count]).

    ``dequantize``: normalized integer accessors are converted to float32 in
    [0,1] / [-1,1] per the glTF spec (matches what tinygltf+SceneVk feed the
    GPU as float attributes).
    """
    acc = model.accessors[accessor_index]
    count = acc["count"]
    ncomp = num_components(acc["type"])
    dtype = component_dtype(acc["componentType"])

    if "bufferView" in acc:
        # MAT2/MAT3 with small component types have per-column padding; none of
        # our targets use quantized matrices, so plain layout is assumed.
        arr = _read_raw(model, acc["bufferView"], acc.get("byteOffset", 0), count, ncomp, dtype)
    else:
        arr = np.zeros((count, ncomp), dtype=dtype)

    sparse = acc.get("sparse")
    if sparse:
        arr = arr.copy()
        n = sparse["count"]
        idx_info = sparse["indices"]
        idx_dtype = component_dtype(idx_info["componentType"])
        indices = _read_raw(model, idx_info["bufferView"], idx_info.get("byteOffset", 0), n, 1, idx_dtype).reshape(-1)
        val_info = sparse["values"]
        values = _read_raw(model, val_info["bufferView"], val_info.get("byteOffset", 0), n, ncomp, dtype)
        arr[indices.astype(np.int64)] = values

    if dequantize and acc.get("normalized") and arr.dtype != np.float32:
        info = np.iinfo(arr.dtype)
        if info.min < 0:  # signed: [-1, 1], clamp lowest value (spec)
            arr = np.maximum(arr.astype(np.float32) / info.max, -1.0)
        else:
            arr = arr.astype(np.float32) / info.max
    return arr.reshape(count) if acc["type"] == "SCALAR" else arr


def append_accessor(model: GltfModel, data: np.ndarray, type_str: str, *, target: int | None = None, normalized: bool = False) -> int:
    """Append numpy data as a new accessor+bufferView+buffer bytes; return index.

    Used by the editor / tangent generator / merger when they synthesize
    attributes (reference gltf_create_tangent.cpp appends TANGENT accessors).
    """
    data = np.ascontiguousarray(data)
    comp_type = {v: k for k, v in _COMPONENT_DTYPES.items()}[data.dtype.type]
    if not model.buffers:
        model.buffers.append(bytearray())
        model.gltf.setdefault("buffers", []).append({"byteLength": 0})
    buf = model.buffers[0]
    # 4-byte align
    pad = -len(buf) % 4
    offset = len(buf) + pad
    payload = b"\0" * pad + data.tobytes()
    try:
        buf.extend(payload)
    except BufferError:
        # live numpy views (np.frombuffer) block bytearray resize; move the
        # buffer to a fresh copy — old views keep the old object alive,
        # future reads re-derive from model.buffers[0]
        buf = bytearray(buf)
        buf.extend(payload)
        model.buffers[0] = buf
    model.gltf["buffers"][0]["byteLength"] = len(buf)
    bv = {"buffer": 0, "byteOffset": offset, "byteLength": data.nbytes}
    if target is not None:
        bv["target"] = target
    model.buffer_views.append(bv)
    count = data.shape[0] if data.ndim else 1
    acc = {
        "bufferView": len(model.buffer_views) - 1,
        "componentType": comp_type,
        "count": int(count),
        "type": type_str,
    }
    if normalized:
        acc["normalized"] = True
    flat = data.reshape(count, -1).astype(np.float64)
    if data.dtype == np.float32:
        acc["min"] = [float(v) for v in flat.min(axis=0)]
        acc["max"] = [float(v) for v in flat.max(axis=0)]
    model.accessors.append(acc)
    return len(model.accessors) - 1
