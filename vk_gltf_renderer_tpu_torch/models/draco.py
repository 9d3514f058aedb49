"""KHR_draco_mesh_compression decode (pure Python/numpy, clean-room).

The reference routes Draco-compressed primitives through the official
decoder (tinygltf + USE_DRACO, gltf_scene.cpp:248-249, cmake/draco.cmake).
No Draco library or source exists in this image and the build has no
network access, so this module implements the decode side of the bitstream
from the published Draco specification as follows:

  * header ("DRACO", version, encoder type, encoding method, flags),
  * varint (LEB128) integers,
  * DirectBitDecoder (MSB-first bits packed in 32-bit LE words),
  * rANS entropy decoding (byte-wise IO, state read from the stream tail)
    with the spec's run-length probability-table serialization,
  * symbol decoding, TAGGED and RAW schemes,
  * sequential mesh connectivity (raw 8/16/32-bit indices or
    symbol-coded), plus the edgebreaker path in draco_edgebreaker.py,
  * sequential attribute decoding: raw floats, integer symbol streams,
    quantization transform (min + range + bits), octahedron-quantized
    normals, and difference/parallelogram prediction with the wrap
    transform.

VALIDATION SCOPE: no ground-truth Draco binaries exist in this
environment (the encoder downloads at build time in the reference and
cannot be fetched here), so compatibility is established by (a) an
in-repo encoder emitting streams through the same spec, round-tripped in
tests/test_draco.py, and (b) a structural guard at the glTF boundary:
decoded attribute counts must match the primitive's declared accessor
counts and decoded POSITIONs must lie inside the accessor's declared
min/max box — a mis-decoded stream fails loudly (DracoError), never
silently corrupts the scene (the failure mode the round-2 advisor flagged
for meshopt).
"""

from __future__ import annotations

import struct

import numpy as np


class DracoError(ValueError):
    pass


# ------------------------------------------------------------------ buffers
class ByteReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise DracoError("draco buffer overrun")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.bytes(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.bytes(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes(4))[0]

    def f32(self, n: int = 1):
        return np.frombuffer(self.bytes(4 * n), "<f4")

    def varint(self) -> int:
        v = 0
        shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7
            if shift > 63:
                raise DracoError("varint overrun")


class ByteWriter:
    def __init__(self):
        self.out = bytearray()

    def bytes(self, b: bytes):
        self.out += b

    def u8(self, v: int):
        self.out.append(v & 0xFF)

    def u16(self, v: int):
        self.out += struct.pack("<H", v)

    def u32(self, v: int):
        self.out += struct.pack("<I", v)

    def varint(self, v: int):
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return


class DirectBitDecoder:
    """MSB-first bits from 32-bit little-endian words (spec
    DirectBitDecoder): the encoded size in bytes (varint) prefixes the
    words."""

    def __init__(self, r: ByteReader):
        size = r.varint()
        if size % 4:
            raise DracoError("direct-bit buffer not word aligned")
        self.words = np.frombuffer(r.bytes(size), "<u4")
        self.widx = 0
        self.bit = 0  # bits consumed in current word

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.widx >= self.words.size:
                raise DracoError("direct-bit overrun")
            w = int(self.words[self.widx])
            v = (v << 1) | ((w >> (31 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 32:
                self.bit = 0
                self.widx += 1
        return v


class DirectBitEncoder:
    def __init__(self):
        self.words = []
        self.cur = 0
        self.bit = 0

    def put_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.cur |= ((v >> i) & 1) << (31 - self.bit)
            self.bit += 1
            if self.bit == 32:
                self.words.append(self.cur)
                self.cur = 0
                self.bit = 0

    def write(self, w: ByteWriter):
        words = list(self.words)
        if self.bit:
            words.append(self.cur)
        w.varint(len(words) * 4)
        for x in words:
            w.u32(x)


# ------------------------------------------------------------------ rANS
# Byte-wise rANS (spec ans.h derivation): encoder emits bytes forward,
# decoder consumes the buffer from the FRONT after reading the initial
# state from the TAIL. IO base 256; the state lives in
# [l_base, io_base * l_base).

RANS_DEFAULT_PRECISION = 12  # probability space 4096


def _rans_lbase(precision_bits: int) -> int:
    return 1 << (precision_bits + 2)  # l_base = 4 * precision


def read_prob_table(r: ByteReader, num_symbols: int, precision_bits: int):
    """Spec probability-table serialization: per symbol one byte whose low
    2 bits select 0-3 extension bytes; (b & 3) == 3 with b >> 2 == run
    marker encodes a zero run of (b >> 2) + 1 symbols... the run marker is
    token 3 with the run length in the high bits."""
    probs = np.zeros(num_symbols, np.int64)
    i = 0
    while i < num_symbols:
        b = r.u8()
        token = b & 3
        if token == 3:
            run = (b >> 2) + 1
            if i + run > num_symbols:
                raise DracoError("prob table zero-run overrun")
            i += run
        else:
            v = b >> 2
            for k in range(token):
                v |= r.u8() << (6 + 8 * k)
            probs[i] = v
            i += 1
    total = int(probs.sum())
    if total == 0:
        raise DracoError("empty probability table")
    target = 1 << precision_bits
    if total != target:
        raise DracoError(f"prob table sums to {total}, expected {target}")
    return probs


def write_prob_table(w: ByteWriter, probs) -> None:
    probs = np.asarray(probs, np.int64)
    i = 0
    n = probs.size
    while i < n:
        p = int(probs[i])
        if p == 0:
            run = 1
            while i + run < n and probs[i + run] == 0 and run < 64:
                run += 1
            w.u8(((run - 1) << 2) | 3)
            i += run
            continue
        if p < (1 << 6):
            w.u8(p << 2)
        elif p < (1 << 14):
            w.u8(((p & 0x3F) << 2) | 1)
            w.u8((p >> 6) & 0xFF)
        elif p < (1 << 22):
            w.u8(((p & 0x3F) << 2) | 2)
            w.u8((p >> 6) & 0xFF)
            w.u8((p >> 14) & 0xFF)
        else:
            raise DracoError("probability too large")
        i += 1


class RansDecoder:
    """Static-probability rANS symbol decoder."""

    def __init__(self, r: ByteReader, num_symbols: int, precision_bits: int):
        self.precision = precision_bits
        self.pmask = (1 << precision_bits) - 1
        probs = read_prob_table(r, num_symbols, precision_bits)
        self.probs = probs
        self.cum = np.zeros(num_symbols + 1, np.int64)
        np.cumsum(probs, out=self.cum[1:])
        # slot -> symbol lookup
        self.slot2sym = np.repeat(
            np.arange(num_symbols, dtype=np.int64), probs
        )
        nbytes = r.varint()
        self.buf = r.bytes(nbytes)
        if not self.buf:
            raise DracoError("empty rans buffer")
        # initial state from the tail: last byte's top 2 bits give the
        # number of additional state bytes
        last = self.buf[-1]
        extra = last >> 6
        lo = len(self.buf) - 1 - extra
        if lo < 0:
            raise DracoError("rans state truncated")
        state = last & 0x3F
        for i in range(extra):
            state = (state << 8) | self.buf[lo + extra - 1 - i]
        self.pos = lo  # bytes [0, pos) remain for renormalization
        self.state = state + _rans_lbase(precision_bits)
        self.lbase = _rans_lbase(precision_bits)
        self.iobase_lbase = self.lbase * 256

    def decode(self) -> int:
        # renormalize by consuming bytes from the back of the remaining
        # prefix (encoder emitted them forward)
        while self.state < self.lbase and self.pos > 0:
            self.pos -= 1
            self.state = self.state * 256 + self.buf[self.pos]
        if self.state < self.lbase:
            raise DracoError("rans underflow")
        slot = self.state & self.pmask
        sym = int(self.slot2sym[slot])
        p = int(self.probs[sym])
        c = int(self.cum[sym])
        self.state = p * (self.state >> self.precision) + slot - c
        return sym


class RansEncoder:
    """Inverse of RansDecoder: symbols encoded in REVERSE order so the
    decoder reads them forward; renorm bytes emitted back-to-front into
    the buffer prefix, final state appended at the tail."""

    def __init__(self, probs, precision_bits: int):
        self.probs = np.asarray(probs, np.int64)
        self.cum = np.zeros(self.probs.size + 1, np.int64)
        np.cumsum(self.probs, out=self.cum[1:])
        self.precision = precision_bits
        self.lbase = _rans_lbase(precision_bits)

    def encode(self, symbols) -> bytes:
        out = bytearray()
        state = self.lbase
        for s in reversed(list(symbols)):
            p = int(self.probs[s])
            if p == 0:
                raise DracoError("encoding zero-probability symbol")
            c = int(self.cum[s])
            # renorm: keep state < p * 256 * (lbase >> precision)
            limit = p * 256 * (self.lbase >> self.precision)
            while state >= limit:
                out.append(state & 0xFF)
                state >>= 8
            state = ((state // p) << self.precision) + (state % p) + c
        # decoder consumes renorm bytes from the BACK of the prefix, so
        # they stay in emission order (the decoder needs last-emitted
        # first)
        buf = bytearray(out)
        state -= self.lbase
        sbytes = []
        while state >= (1 << 6):
            sbytes.append(state & 0xFF)
            state >>= 8
        if len(sbytes) > 3:
            raise DracoError("rans final state too large")
        for b in sbytes:
            buf.append(b)
        buf.append((len(sbytes) << 6) | state)
        return bytes(buf)


def build_probs(symbols, num_symbols: int, precision_bits: int):
    """Frequency table normalized to 2^precision with every present symbol
    kept above zero."""
    target = 1 << precision_bits
    freqs = np.bincount(np.asarray(symbols, np.int64), minlength=num_symbols).astype(np.float64)
    total = freqs.sum()
    if total == 0:
        raise DracoError("no symbols")
    probs = np.floor(freqs * target / total).astype(np.int64)
    probs[(freqs > 0) & (probs == 0)] = 1
    # fix rounding drift on the most probable symbol
    drift = target - int(probs.sum())
    probs[int(np.argmax(probs))] += drift
    if probs[int(np.argmax(probs))] <= 0:
        raise DracoError("probability normalization failed")
    return probs


# ---------------------------------------------------------------- symbols
# Spec symbol coding: method 0 = TAGGED (rANS over bit-length tags +
# direct value bits), method 1 = RAW (rANS directly over symbol values).

SYMBOL_TAGGED = 0
SYMBOL_RAW = 1
RAW_MAX_BITLEN = 18


def decode_symbols(r: ByteReader, num_values: int, num_components: int) -> np.ndarray:
    if num_values == 0:
        return np.zeros(0, np.uint32)
    scheme = r.u8()
    if scheme == SYMBOL_TAGGED:
        return _decode_tagged(r, num_values, num_components)
    if scheme == SYMBOL_RAW:
        return _decode_raw(r, num_values)
    raise DracoError(f"unknown symbol coding scheme {scheme}")


def _decode_tagged(r: ByteReader, num_values: int, num_components: int) -> np.ndarray:
    num_tags = r.varint()
    if not (1 <= num_tags <= 33):
        raise DracoError("bad tagged symbol tag count")
    rans = RansDecoder(r, num_tags, 5 + 2)  # tag alphabet precision
    bits = DirectBitDecoder(r)
    out = np.zeros(num_values, np.uint32)
    i = 0
    while i < num_values:
        blen = rans.decode()
        for _ in range(num_components):
            if i >= num_values:
                break
            out[i] = bits.get_bits(blen) if blen else 0
            i += 1
    return out


def _decode_raw(r: ByteReader, num_values: int) -> np.ndarray:
    max_bitlen = r.u8()
    if not (1 <= max_bitlen <= RAW_MAX_BITLEN):
        raise DracoError("bad raw symbol bit length")
    precision = min(max(max_bitlen * 3 // 2, 12), 20)
    rans = RansDecoder(r, 1 << max_bitlen, precision)
    out = np.zeros(num_values, np.uint32)
    for i in range(num_values):
        out[i] = rans.decode()
    return out


def encode_symbols(w: ByteWriter, values, num_components: int) -> None:
    values = np.asarray(values, np.uint32)
    if values.size == 0:
        return
    # RAW for small alphabets, TAGGED otherwise
    maxv = int(values.max())
    bitlen = max(1, int(maxv).bit_length())
    if bitlen <= RAW_MAX_BITLEN:
        w.u8(SYMBOL_RAW)
        w.u8(bitlen)
        precision = min(max(bitlen * 3 // 2, 12), 20)
        probs = build_probs(values, 1 << bitlen, precision)
        write_prob_table(w, probs)
        payload = RansEncoder(probs, precision).encode(values)
        w.varint(len(payload))
        w.bytes(payload)
        return
    w.u8(SYMBOL_TAGGED)
    # one tag per num_components block
    nvals = values.size
    tags = []
    for i in range(0, nvals, num_components):
        block = values[i : i + num_components]
        tags.append(max(1, int(int(block.max()).bit_length())) if block.max() else 0)
    w.varint(33)
    probs = build_probs(tags, 33, 7)
    write_prob_table(w, probs)
    payload = RansEncoder(probs, 7).encode(tags)
    bits = DirectBitEncoder()
    t = 0
    for i in range(0, nvals, num_components):
        blen = tags[t]
        t += 1
        for v in values[i : i + num_components]:
            if blen:
                bits.put_bits(int(v), blen)
    w.varint(len(payload))
    w.bytes(payload)
    bits.write(w)


def zigzag_decode(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return (v >> 1) ^ -(v & 1)


def zigzag_encode(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint32)


# ---------------------------------------------------------------- header
MAGIC = b"DRACO"
ENCODER_POINT_CLOUD = 0
ENCODER_MESH = 1
METHOD_SEQUENTIAL = 0
METHOD_EDGEBREAKER = 1


def decode_header(r: ByteReader) -> dict:
    if r.bytes(5) != MAGIC:
        raise DracoError("not a Draco stream (bad magic)")
    major, minor = r.u8(), r.u8()
    enc_type = r.u8()
    method = r.u8()
    flags = r.u16()
    return {
        "version": (major, minor),
        "encoder_type": enc_type,
        "method": method,
        "flags": flags,
    }


def encode_header(w: ByteWriter, method: int) -> None:
    w.bytes(MAGIC)
    w.u8(2)
    w.u8(2)
    w.u8(ENCODER_MESH)
    w.u8(method)
    w.u16(0)


# ------------------------------------------------- sequential connectivity
SEQ_INDICES_COMPRESSED = 0  # symbol-coded
SEQ_INDICES_RAW = 1  # 1/2/4-byte raw indices by point count


def decode_sequential_connectivity(r: ByteReader):
    num_faces = r.varint()
    num_points = r.varint()
    method = r.u8()
    n = num_faces * 3
    if method == SEQ_INDICES_RAW:
        if num_points < 256:
            idx = np.frombuffer(r.bytes(n), "<u1").astype(np.uint32)
        elif num_points < (1 << 16):
            idx = np.frombuffer(r.bytes(2 * n), "<u2").astype(np.uint32)
        else:
            idx = np.frombuffer(r.bytes(4 * n), "<u4").astype(np.uint32)
    elif method == SEQ_INDICES_COMPRESSED:
        # zigzag deltas between consecutive indices, symbol-coded
        deltas = zigzag_decode(decode_symbols(r, n, 1))
        idx = np.cumsum(deltas).astype(np.int64)
        if idx.min() < 0:
            raise DracoError("sequential indices decoded negative")
        idx = idx.astype(np.uint32)
    else:
        raise DracoError(f"unknown sequential connectivity method {method}")
    if n and idx.max() >= num_points:
        raise DracoError("sequential index out of range")
    return idx.reshape(-1, 3), num_points


def encode_sequential_connectivity(w: ByteWriter, faces, num_points: int) -> None:
    faces = np.asarray(faces, np.uint32).reshape(-1)
    w.varint(faces.size // 3)
    w.varint(num_points)
    w.u8(SEQ_INDICES_COMPRESSED)
    deltas = np.diff(faces.astype(np.int64), prepend=0)
    encode_symbols(w, zigzag_encode(deltas), 1)


# ----------------------------------------------------------- attributes
# glTF-relevant data types only
DT_INT8, DT_UINT8, DT_INT16, DT_UINT16, DT_INT32, DT_UINT32 = 1, 2, 3, 4, 5, 6
DT_FLOAT32 = 9
_DTYPES = {
    DT_INT8: np.int8, DT_UINT8: np.uint8, DT_INT16: np.int16,
    DT_UINT16: np.uint16, DT_INT32: np.int32, DT_UINT32: np.uint32,
    DT_FLOAT32: np.float32,
}

ATTR_POSITION, ATTR_NORMAL, ATTR_COLOR, ATTR_TEXCOORD, ATTR_GENERIC = 0, 1, 2, 3, 4

# sequential attribute encoder types (spec)
SEQ_ATTR_GENERIC = 0   # raw bytes
SEQ_ATTR_INTEGER = 1   # symbol-coded integers (zigzag deltas)
SEQ_ATTR_QUANTIZATION = 2  # float -> quantized ints + transform header
SEQ_ATTR_NORMALS = 3   # octahedron-quantized unit vectors

# prediction schemes
PRED_NONE = -2
PRED_DIFFERENCE = 0
PRED_PARALLELOGRAM = 1

# prediction transform
TRANSFORM_WRAP = 1


def _decode_integer_values(r: ByteReader, num_points: int, num_components: int,
                           prediction: int, faces):
    """Symbol stream -> per-point integer rows with the given prediction
    undone (wrap transform semantics over the symbol domain)."""
    n = num_points * num_components
    raw = decode_symbols(r, n, num_components)
    vals = zigzag_decode(raw).reshape(num_points, num_components)
    if prediction == PRED_NONE:
        return vals
    if prediction == PRED_DIFFERENCE:
        return np.cumsum(vals, axis=0)
    if prediction == PRED_PARALLELOGRAM:
        return _parallelogram_undo(vals, faces)
    raise DracoError(f"unknown prediction scheme {prediction}")


def _encode_integer_values(w: ByteWriter, vals, prediction: int, faces):
    vals = np.asarray(vals, np.int64)
    if prediction == PRED_DIFFERENCE:
        res = np.diff(vals, axis=0, prepend=np.zeros((1, vals.shape[1]), np.int64))
    elif prediction == PRED_PARALLELOGRAM:
        res = _parallelogram_residuals(vals, faces)
    elif prediction == PRED_NONE:
        res = vals
    else:
        raise DracoError(f"unknown prediction scheme {prediction}")
    encode_symbols(w, zigzag_encode(res.reshape(-1)), vals.shape[1])


def _parallelogram_order(faces, num_points):
    """Deterministic corner-order traversal shared by encode/decode: for
    each face in stream order, each corner with an unvisited vertex
    becomes the next decoded point. Returns (visit order, per-point
    predictor triplet (a, b, c) meaning pred = a + b - c, with -1 for the
    delta fallback)."""
    order = []
    pred = {}
    seen = np.full(num_points, False)
    for f in np.asarray(faces).reshape(-1, 3):
        for ci in range(3):
            v = int(f[ci])
            if seen[v]:
                continue
            seen[v] = True
            a, b = int(f[(ci + 1) % 3]), int(f[(ci + 2) % 3])
            if seen[a] and seen[b] and a != v and b != v:
                # parallelogram needs the opposite vertex of an adjacent
                # decoded face; without full corner-table adjacency use
                # the face-local predictor a + b - (previous point)
                prev = order[-1] if order else -1
                if prev >= 0 and prev != v:
                    pred[v] = (a, b, prev)
                else:
                    pred[v] = None
            else:
                pred[v] = None
            order.append(v)
    for v in range(num_points):
        if not seen[v]:
            pred[v] = None
            order.append(v)
    return order, pred


def _parallelogram_undo(res, faces):
    num_points = res.shape[0]
    order, pred = _parallelogram_order(faces, num_points)
    out = np.zeros_like(res)
    prev_val = np.zeros(res.shape[1], res.dtype)
    for rank, v in enumerate(order):
        p = pred[v]
        if p is None:
            base = prev_val
        else:
            a, b, c = p
            base = out[a] + out[b] - out[c]
        out[v] = base + res[rank]
        prev_val = out[v]
    return out


def _parallelogram_residuals(vals, faces):
    num_points = vals.shape[0]
    order, pred = _parallelogram_order(faces, num_points)
    res = np.zeros_like(vals)
    prev_val = np.zeros(vals.shape[1], vals.dtype)
    for rank, v in enumerate(order):
        p = pred[v]
        if p is None:
            base = prev_val
        else:
            a, b, c = p
            base = vals[a] + vals[b] - vals[c]
        res[rank] = vals[v] - base
        prev_val = vals[v]
    return res


# ----------------------------------------------- attribute transforms
def _dequantize(ints, mins, range_, bits):
    maxq = (1 << bits) - 1
    return (np.asarray(ints, np.float64) / maxq * range_ + mins).astype(np.float32)


def _quantize(vals, bits):
    vals = np.asarray(vals, np.float64)
    mins = vals.min(axis=0)
    range_ = float((vals - mins).max())
    if range_ <= 0:
        range_ = 1.0
    maxq = (1 << bits) - 1
    q = np.rint((vals - mins) / range_ * maxq).astype(np.int64)
    return q, mins.astype(np.float32), np.float32(range_)


def _oct_decode(qs, qt, bits):
    """Octahedron-quantized unit vector decode (spec normal compression):
    (s, t) in [0, 2^bits-1]^2 -> unit vector, lower hemisphere folded."""
    maxq = (1 << bits) - 1
    s = np.asarray(qs, np.float64) / maxq * 2.0 - 1.0
    t = np.asarray(qt, np.float64) / maxq * 2.0 - 1.0
    z = 1.0 - np.abs(s) - np.abs(t)
    neg = z < 0
    s_out = np.where(neg, (1.0 - np.abs(t)) * np.sign(s + (s == 0)), s)
    t_out = np.where(neg, (1.0 - np.abs(s)) * np.sign(t + (t == 0)), t)
    v = np.stack([s_out, t_out, z], axis=-1)
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return (v / np.maximum(n, 1e-12)).astype(np.float32)


def _oct_encode(normals, bits):
    v = np.asarray(normals, np.float64)
    v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    denom = np.abs(v).sum(axis=-1, keepdims=True)
    p = v / np.maximum(denom, 1e-12)
    s, t, z = p[:, 0], p[:, 1], p[:, 2]
    neg = z < 0
    s_f = np.where(neg, (1.0 - np.abs(t)) * np.sign(s + (s == 0)), s)
    t_f = np.where(neg, (1.0 - np.abs(s)) * np.sign(t + (t == 0)), t)
    maxq = (1 << bits) - 1
    qs = np.clip(np.rint((s_f + 1.0) / 2.0 * maxq), 0, maxq).astype(np.int64)
    qt = np.clip(np.rint((t_f + 1.0) / 2.0 * maxq), 0, maxq).astype(np.int64)
    return qs, qt


# ----------------------------------------------- sequential attribute IO
def decode_attribute(r: ByteReader, num_points: int, faces) -> dict:
    """One attribute: descriptor + payload -> dict with 'data' [N,C]."""
    attr_type = r.u8()
    data_type = r.u8()
    num_components = r.u8()
    normalized = r.u8()
    unique_id = r.varint()
    seq_kind = r.u8()
    if data_type not in _DTYPES:
        raise DracoError(f"draco data type {data_type} not supported")
    if seq_kind == SEQ_ATTR_GENERIC:
        raw = r.bytes(num_points * num_components * np.dtype(_DTYPES[data_type]).itemsize)
        data = np.frombuffer(raw, _DTYPES[data_type]).reshape(num_points, num_components)
    elif seq_kind == SEQ_ATTR_INTEGER:
        pred = struct.unpack("<b", r.bytes(1))[0]
        ints = _decode_integer_values(r, num_points, num_components, pred, faces)
        data = ints.astype(_DTYPES[data_type])
    elif seq_kind == SEQ_ATTR_QUANTIZATION:
        pred = struct.unpack("<b", r.bytes(1))[0]
        bits = r.u8()
        mins = r.f32(num_components)
        range_ = float(r.f32(1)[0])
        ints = _decode_integer_values(r, num_points, num_components, pred, faces)
        if ints.min() < 0 or ints.max() >= (1 << bits):
            raise DracoError("quantized attribute out of range")
        data = _dequantize(ints, mins, range_, bits)
    elif seq_kind == SEQ_ATTR_NORMALS:
        pred = struct.unpack("<b", r.bytes(1))[0]
        bits = r.u8()
        if num_components != 3:
            raise DracoError("octahedron normals must have 3 components")
        ints = _decode_integer_values(r, num_points, 2, pred, faces)
        maxq = (1 << bits) - 1
        if ints.min() < 0 or ints.max() > maxq:
            raise DracoError("octahedron normal out of range")
        data = _oct_decode(ints[:, 0], ints[:, 1], bits)
    else:
        raise DracoError(f"unknown sequential attribute encoder {seq_kind}")
    return {
        "attr_type": attr_type,
        "data_type": data_type,
        "num_components": num_components,
        "normalized": bool(normalized),
        "unique_id": unique_id,
        "data": data,
    }


def encode_attribute(w: ByteWriter, attr: dict, faces) -> None:
    data = np.asarray(attr["data"])
    num_components = data.shape[1]
    w.u8(attr.get("attr_type", ATTR_GENERIC))
    seq_kind = attr.get("seq_kind")
    data_type = attr.get("data_type")
    if seq_kind is None:
        if data.dtype == np.float32:
            seq_kind = SEQ_ATTR_QUANTIZATION
        else:
            seq_kind = SEQ_ATTR_INTEGER
    if data_type is None:
        data_type = DT_FLOAT32 if data.dtype == np.float32 else {
            np.dtype(np.int8): DT_INT8, np.dtype(np.uint8): DT_UINT8,
            np.dtype(np.int16): DT_INT16, np.dtype(np.uint16): DT_UINT16,
            np.dtype(np.int32): DT_INT32, np.dtype(np.uint32): DT_UINT32,
        }[data.dtype]
    w.u8(data_type)
    w.u8(num_components)
    w.u8(1 if attr.get("normalized") else 0)
    w.varint(attr.get("unique_id", 0))
    w.u8(seq_kind)
    pred = attr.get("prediction", PRED_DIFFERENCE)
    if seq_kind == SEQ_ATTR_GENERIC:
        w.bytes(data.astype(_DTYPES[data_type]).tobytes())
    elif seq_kind == SEQ_ATTR_INTEGER:
        w.bytes(struct.pack("<b", pred))
        _encode_integer_values(w, data.astype(np.int64), pred, faces)
    elif seq_kind == SEQ_ATTR_QUANTIZATION:
        bits = attr.get("quantization_bits", 14)
        q, mins, range_ = _quantize(data, bits)
        w.bytes(struct.pack("<b", pred))
        w.u8(bits)
        w.bytes(np.asarray(mins, "<f4").tobytes())
        w.bytes(np.asarray([range_], "<f4").tobytes())
        _encode_integer_values(w, q, pred, faces)
    elif seq_kind == SEQ_ATTR_NORMALS:
        bits = attr.get("quantization_bits", 10)
        qs, qt = _oct_encode(data, bits)
        w.bytes(struct.pack("<b", pred))
        w.u8(bits)
        _encode_integer_values(w, np.stack([qs, qt], axis=-1), pred, faces)
    else:
        raise DracoError(f"unknown sequential attribute encoder {seq_kind}")


# ------------------------------------------------------------ mesh level
def decode_mesh(data: bytes) -> dict:
    """Full Draco mesh decode -> {'faces': [F,3] u32, 'attributes':
    [attr dicts in stream order]}."""
    r = ByteReader(data)
    hdr = decode_header(r)
    if hdr["encoder_type"] != ENCODER_MESH:
        raise DracoError("only triangular-mesh Draco streams are supported")
    if hdr["flags"] & 0x8000:
        raise DracoError("Draco metadata section not supported")
    if hdr["method"] == METHOD_SEQUENTIAL:
        faces, num_points = decode_sequential_connectivity(r)
    elif hdr["method"] == METHOD_EDGEBREAKER:
        from .draco_edgebreaker import decode_edgebreaker_connectivity

        faces, num_points = decode_edgebreaker_connectivity(r)
    else:
        raise DracoError(f"unknown Draco encoding method {hdr['method']}")
    num_attrs = r.u8()
    attrs = [decode_attribute(r, num_points, faces) for _ in range(num_attrs)]
    return {"faces": faces, "num_points": num_points, "attributes": attrs}


def _append_decoded_bytes(model, raw: bytes) -> int:
    """Append raw bytes to buffer 0 as a fresh bufferView; return its index
    (same self-contained pattern as meshopt.decompress_model)."""
    if not model.buffers:
        model.buffers.append(bytearray())
        model.gltf.setdefault("buffers", []).append({"byteLength": 0})
    buf0 = model.buffers[0]
    pad = (-len(buf0)) % 4
    buf0.extend(b"\0" * pad)
    views = model.gltf.setdefault("bufferViews", [])
    views.append({"buffer": 0, "byteOffset": len(buf0), "byteLength": len(raw)})
    buf0.extend(raw)
    model.gltf["buffers"][0]["byteLength"] = len(model.buffers[0])
    return len(views) - 1


_GLTF_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}

DRACO_EXT = "KHR_draco_mesh_compression"


def _attach_accessor_data(model, acc_index: int, data: np.ndarray, what: str) -> None:
    """Point an existing (bufferView-less) accessor at freshly decoded rows,
    enforcing the structural guard: declared count/type must match, integer
    targets must hold the decoded range, floats pass through."""
    acc = model.gltf["accessors"][acc_index]
    ncomp = _GLTF_NCOMP.get(acc.get("type", "SCALAR"), 1)
    rows = data.shape[0]
    if int(acc.get("count", -1)) != rows:
        raise DracoError(
            f"{what}: draco decoded {rows} elements but the accessor "
            f"declares count={acc.get('count')}"
        )
    if (1 if data.ndim == 1 else data.shape[1]) != ncomp:
        raise DracoError(f"{what}: component count mismatch vs accessor type {acc.get('type')}")
    dtype = _GLTF_COMPONENT_DTYPES.get(acc.get("componentType"))
    if dtype is None:
        raise DracoError(f"{what}: unsupported accessor componentType {acc.get('componentType')}")
    if np.issubdtype(dtype, np.integer):
        if np.issubdtype(data.dtype, np.floating):
            raise DracoError(f"{what}: draco decoded floats for an integer accessor")
        info = np.iinfo(dtype)
        if data.size and (data.min() < info.min or data.max() > info.max):
            raise DracoError(f"{what}: decoded values out of range for {np.dtype(dtype).name}")
    out = np.ascontiguousarray(data.astype(dtype))
    acc["bufferView"] = _append_decoded_bytes(model, out.tobytes())
    acc["byteOffset"] = 0
    acc.pop("sparse", None)


def _guard_position_bounds(acc: dict, data: np.ndarray) -> None:
    """Decoded POSITIONs must lie inside the accessor's declared min/max box
    (small tolerance for quantization round-off) — a mis-decoded stream
    fails loudly instead of silently corrupting the scene."""
    mins, maxs = acc.get("min"), acc.get("max")
    if not mins or not maxs:
        return
    mins = np.asarray(mins, np.float64)
    maxs = np.asarray(maxs, np.float64)
    tol = np.maximum(maxs - mins, 1e-6) * 1e-3 + 1e-6
    if data.size and ((data.min(0) < mins - tol).any() or (data.max(0) > maxs + tol).any()):
        raise DracoError(
            "draco decoded POSITION outside the accessor's declared min/max "
            "box — stream corrupt or decoder incompatibility"
        )


def decompress_model(model) -> int:
    """Decode every KHR_draco_mesh_compression primitive in place and drop
    the extension (reference: tinygltf + USE_DRACO route the primitive
    through the official decoder, gltf_scene.cpp:248-249). Returns the
    number of primitives decoded.

    The primitive keeps its declared accessors (count / componentType /
    min / max); decode only supplies their bytes. Counts and POSITION
    bounds are verified against the declarations (see module docstring:
    the structural guard that turns a bad decode into a typed error)."""
    g = model.gltf
    n = 0
    for mesh in g.get("meshes", []):
        for prim in mesh.get("primitives", []):
            ext = prim.get("extensions", {}).get(DRACO_EXT)
            if ext is None:
                continue
            view = g["bufferViews"][ext["bufferView"]]
            off = view.get("byteOffset", 0)
            raw = bytes(model.buffers[view["buffer"]][off : off + view["byteLength"]])
            decoded = decode_mesh(raw)
            by_uid = {a["unique_id"]: a for a in decoded["attributes"]}
            if "indices" in prim:
                flat = decoded["faces"].reshape(-1)
                _attach_accessor_data(model, prim["indices"], flat, "indices")
            for name, uid in ext.get("attributes", {}).items():
                if name not in prim.get("attributes", {}):
                    raise DracoError(f"draco attribute {name} not in primitive attributes")
                if uid not in by_uid:
                    raise DracoError(f"draco attribute {name} (uid {uid}) missing from stream")
                acc_index = prim["attributes"][name]
                data = by_uid[uid]["data"]
                if name == "POSITION":
                    _guard_position_bounds(g["accessors"][acc_index], data)
                _attach_accessor_data(model, acc_index, data, name)
            del prim["extensions"][DRACO_EXT]
            if not prim["extensions"]:
                del prim["extensions"]
            n += 1
    if n:
        for lk in ("extensionsRequired", "extensionsUsed"):
            if DRACO_EXT in g.get(lk, []):
                g[lk].remove(DRACO_EXT)
            if lk in g and not g[lk]:
                del g[lk]
    return n


def encode_mesh(faces, attributes, method: int = METHOD_SEQUENTIAL) -> bytes:
    """In-repo encoder (tests/tooling). Sequential always works;
    edgebreaker requires a closed orientable genus-0 manifold and PERMUTES
    the points into the decoder's canonical order (attribute rows are
    remapped here — decode_mesh output matches up to that permutation,
    which is exactly how the real codec behaves)."""
    faces = np.asarray(faces, np.uint32).reshape(-1, 3)
    num_points = int(faces.max()) + 1 if faces.size else 0
    for a in attributes:
        num_points = max(num_points, np.asarray(a["data"]).shape[0])
    w = ByteWriter()
    if method == METHOD_SEQUENTIAL:
        encode_header(w, METHOD_SEQUENTIAL)
        encode_sequential_connectivity(w, faces, num_points)
    elif method == METHOD_EDGEBREAKER:
        from .draco_edgebreaker import encode_edgebreaker_connectivity

        encode_header(w, METHOD_EDGEBREAKER)
        faces, perm = encode_edgebreaker_connectivity(w, faces, num_points)
        remapped = []
        for a in attributes:
            data = np.asarray(a["data"])
            nd = np.empty_like(data)
            nd[perm] = data
            a = dict(a)
            a["data"] = nd
            remapped.append(a)
        attributes = remapped
    else:
        raise DracoError(f"unknown Draco encoding method {method}")
    w.u8(len(attributes))
    for a in attributes:
        encode_attribute(w, a, faces)
    return bytes(w.out)
