"""EXT_meshopt_compression codecs (pure numpy).

The reference decompresses meshopt buffer views on load via the
meshoptimizer C library (gltf_scene.cpp:337/:375 decompressMeshoptExtension);
this is a clean-room reimplementation of the three codecs + three filters
from the published format specification
(https://github.com/KhronosGroup/glTF/tree/main/extensions/2.0/Vendor/
EXT_meshopt_compression + the meshoptimizer codec format docs):

  * ATTRIBUTES — vertex codec v0: byte-plane deltas vs previous vertex,
    zigzag-encoded, bit-sliced in 16-byte groups (widths 0/2/4/8 with
    sentinel escapes), first vertex stored in the tail.
  * TRIANGLES — index codec v1: per-triangle code byte against a 16-entry
    edge FIFO + 16-entry vertex FIFO, "next vertex" counter, zigzag-varint
    index deltas, 16-byte codeaux table in the tail.
  * INDICES — index sequence codec v1: per-index zigzag-varint against
    last, with a low-bit FIFO reuse flag.

Filters: OCTAHEDRAL (unit-vector oct encoding), QUATERNION (smallest-three
snorm), EXPONENTIAL (shared-exponent floats).

NOTE: no reference encoder or ground-truth bitstreams exist in this
environment, so conformance is asserted by encoder/decoder round-trip
tests over randomized inputs plus structural checks against the published
size formulas. The encoders here exist for tests/tooling; load-time only
uses the decoders.
"""

from __future__ import annotations

import numpy as np

VERTEX_HEADER = 0xA0  # vertex codec, version 0
INDEX_HEADER = 0xE0  # triangle index codec (version in low nibble)
SEQUENCE_HEADER = 0xD0  # index sequence codec (version in low nibble)
BYTE_GROUP = 16
BLOCK_MAX = 256
BLOCK_BYTES = 8192
TAIL_MAX = 32

MODE_ATTRIBUTES = "ATTRIBUTES"
MODE_TRIANGLES = "TRIANGLES"
MODE_INDICES = "INDICES"


class MeshoptError(ValueError):
    pass


# ------------------------------------------------------------ vertex codec
def _zigzag8(v):
    return ((v.astype(np.int8).astype(np.int32) << 1) ^ (v.astype(np.int8).astype(np.int32) >> 7)).astype(np.uint8)


def _unzigzag8(v):
    v = v.astype(np.int32)
    return (-(v & 1) ^ (v >> 1)).astype(np.uint8)


def _vertex_block_size(vertex_size: int) -> int:
    return min((BLOCK_BYTES // vertex_size) & ~(BYTE_GROUP - 1), BLOCK_MAX) or BYTE_GROUP


def _encode_bytes(deltas: np.ndarray) -> bytes:
    """Bit-sliced group encoding of a delta byte-plane (padded to 16)."""
    n = len(deltas)
    groups = (n + BYTE_GROUP - 1) // BYTE_GROUP
    padded = np.zeros(groups * BYTE_GROUP, np.uint8)
    padded[:n] = deltas
    header = bytearray((groups + 3) // 4)
    body = bytearray()
    for g in range(groups):
        d = padded[g * BYTE_GROUP : (g + 1) * BYTE_GROUP].astype(np.uint32)
        if not d.any():
            code = 0
        else:
            size2 = 4 + int((d >= 3).sum())
            size4 = 8 + int((d >= 15).sum())
            best = min(size2, size4, 16)
            code = 1 if best == size2 else (2 if best == size4 else 3)
        header[g // 4] |= code << ((g % 4) * 2)
        if code == 1:
            clip = np.minimum(d, 3)
            for i in range(4):
                body.append(int((clip[i * 4] << 6) | (clip[i * 4 + 1] << 4) | (clip[i * 4 + 2] << 2) | clip[i * 4 + 3]))
            body.extend(int(x) for x in d[d >= 3])
        elif code == 2:
            clip = np.minimum(d, 15)
            for i in range(8):
                body.append(int((clip[i * 2] << 4) | clip[i * 2 + 1]))
            body.extend(int(x) for x in d[d >= 15])
        elif code == 3:
            body.extend(int(x) for x in d)
    return bytes(header) + bytes(body)


def _decode_bytes(buf: memoryview, pos: int, count: int) -> tuple[np.ndarray, int]:
    groups = (count + BYTE_GROUP - 1) // BYTE_GROUP
    header = buf[pos : pos + (groups + 3) // 4]
    pos += (groups + 3) // 4
    out = np.zeros(groups * BYTE_GROUP, np.uint8)
    for g in range(groups):
        code = (header[g // 4] >> ((g % 4) * 2)) & 3
        o = g * BYTE_GROUP
        if code == 0:
            continue
        if code == 1:
            b = np.frombuffer(buf[pos : pos + 4], np.uint8).astype(np.uint32)
            pos += 4
            vals = np.empty(16, np.uint32)
            vals[0::4] = b >> 6
            vals[1::4] = (b >> 4) & 3
            vals[2::4] = (b >> 2) & 3
            vals[3::4] = b & 3
            esc = vals == 3
            ne = int(esc.sum())
            if ne:
                vals[esc] = np.frombuffer(buf[pos : pos + ne], np.uint8)
                pos += ne
            out[o : o + 16] = vals
        elif code == 2:
            b = np.frombuffer(buf[pos : pos + 8], np.uint8).astype(np.uint32)
            pos += 8
            vals = np.empty(16, np.uint32)
            vals[0::2] = b >> 4
            vals[1::2] = b & 15
            esc = vals == 15
            ne = int(esc.sum())
            if ne:
                vals[esc] = np.frombuffer(buf[pos : pos + ne], np.uint8)
                pos += ne
            out[o : o + 16] = vals
        else:
            out[o : o + 16] = np.frombuffer(buf[pos : pos + 16], np.uint8)
            pos += 16
    return out[:count], pos


def encode_vertex_buffer(data: bytes, count: int, size: int) -> bytes:
    """Vertex codec v0 encoder (tests/tooling)."""
    v = np.frombuffer(data, np.uint8).reshape(count, size)
    out = bytearray([VERTEX_HEADER])
    block = _vertex_block_size(size)
    last = v[0].copy()
    for b0 in range(0, count, block):
        blk = v[b0 : b0 + block]
        prev = np.vstack([last, blk[:-1]])
        deltas = _zigzag8(blk.astype(np.int32) - prev.astype(np.int32))
        for k in range(size):
            out += _encode_bytes(deltas[:, k])
        last = blk[-1].copy()
    if size < TAIL_MAX:
        out += bytes(TAIL_MAX - size)
    out += v[0].tobytes()
    return bytes(out)


def decode_vertex_buffer(data: bytes, count: int, size: int) -> bytes:
    """Vertex codec v0 decoder (meshoptimizer decodeVertexBuffer contract)."""
    buf = memoryview(data)
    if len(buf) < 1 + max(size, TAIL_MAX):
        raise MeshoptError("meshopt vertex buffer too small")
    if buf[0] != VERTEX_HEADER:
        raise MeshoptError(f"unsupported meshopt vertex codec version 0x{buf[0]:02x}")
    out = np.zeros((count, size), np.uint8)
    last = np.frombuffer(buf[len(buf) - size :], np.uint8).copy()
    block = _vertex_block_size(size)
    pos = 1
    for b0 in range(0, count, block):
        bc = min(block, count - b0)
        deltas = np.empty((bc, size), np.uint8)
        for k in range(size):
            deltas[:, k], pos = _decode_bytes(buf, pos, bc)
        deltas = _unzigzag8(deltas).astype(np.int32)
        # prefix-sum the per-vertex deltas per byte lane (mod 256)
        vals = (np.cumsum(deltas, axis=0, dtype=np.int64) + last.astype(np.int64)) & 0xFF
        out[b0 : b0 + bc] = vals.astype(np.uint8)
        last = out[b0 + bc - 1].copy()
    return out.tobytes()


# ------------------------------------------------------------- index codec
def _encode_vbyte(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def _decode_vbyte(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _zigzag32(v: int) -> int:
    return (v << 1) ^ (v >> 31) if v < 0 else v << 1


def _unzigzag32(v: int) -> int:
    return -(v & 1) ^ (v >> 1)


def _encode_index(value: int, last: int) -> bytes:
    d = value - last
    return _encode_vbyte(((d << 1) ^ (d >> 63)) & 0xFFFFFFFF if d < 0 else d << 1)


def _decode_index(buf, pos, last):
    v, pos = _decode_vbyte(buf, pos)
    return last + _unzigzag32(v), pos


# Codeaux table used by this module's ENCODER (the decoder reads whatever
# table the stream carries). Slot 0 = 0x00 so the (next,next,next) triangle
# has a table code — the 0xfe aux==0 encoding would trigger the decoder's
# "reset next" semantics instead.
_ENC_CODEAUX = bytes([0x00] + [0x10 * i | i for i in range(1, 8)] + [0x01, 0x02, 0x12, 0x21, 0x13, 0x31, 0x23, 0x32])


class _TriState:
    """Shared decoder-semantics state machine for the TRIANGLES codec.

    Both the decoder and the encoder drive this SAME state-update logic so
    the two can never drift apart; the update rules mirror meshoptimizer's
    decodeIndexBuffer exactly (write-always/advance-conditionally vertex
    fifo pushes, edge-path reads at voff-1-fec, codeaux-path reads at
    voff-feb with pre-push voff)."""

    def __init__(self):
        self.edgefifo = [(0, 0)] * 16
        self.vertexfifo = [0] * 16
        self.eoff = 0
        self.voff = 0
        self.next_v = 0
        self.last = 0

    def push_edge(self, a, b):
        self.edgefifo[self.eoff & 15] = (a, b)
        self.eoff = (self.eoff + 1) & 15

    def push_vertex(self, v, cond=True):
        # meshoptimizer pushVertexFifo: write ALWAYS, advance conditionally
        self.vertexfifo[self.voff & 15] = v
        self.voff = (self.voff + (1 if cond else 0)) & 15


def decode_index_buffer(data: bytes, count: int) -> np.ndarray:
    """TRIANGLES codec decoder — bitstream-exact mirror of meshoptimizer's
    decodeIndexBuffer (indexcodec.cpp), versions 0 and 1:
      * code < 0xf0: edge fifo ref (hi nibble) + third vertex from
        fec=0 (next counter), 1..fecmax-1 (vertex fifo at voff-1-fec),
        13/14 (v1: last-1 / last+1), 15 (explicit zigzag-vbyte delta).
      * 0xf0..0xfd: codeaux TABLE byte; a=next++, b/c resolved from
        feb/fec nibbles (fifo reads at pre-push voff-feb / voff-fec).
      * 0xfe/0xff: explicit aux byte (aux==0 resets the next counter);
        a = next (0xfe) or explicit (0xff); b/c may also be explicit."""
    buf = memoryview(data)
    if len(buf) < 1 + count // 3 + 16:
        raise MeshoptError("meshopt index buffer too small")
    version = buf[0] ^ INDEX_HEADER
    if buf[0] & 0xF0 != INDEX_HEADER or version > 1:
        raise MeshoptError(f"unsupported meshopt index codec header 0x{buf[0]:02x}")
    fecmax = 13 if version >= 1 else 15
    ntri = count // 3
    codeaux = buf[len(buf) - 16 :]
    pos_code = 1
    pos_data = 1 + ntri
    out = np.empty(count, np.uint32)
    st = _TriState()

    for t in range(ntri):
        code = buf[pos_code]
        pos_code += 1
        if code < 0xF0:
            a, b = st.edgefifo[(st.eoff - 1 - (code >> 4)) & 15]
            fec = code & 15
            if fec < fecmax:
                cf = st.vertexfifo[(st.voff - 1 - fec) & 15]
                c = st.next_v if fec == 0 else cf
                if fec == 0:
                    st.next_v += 1
                st.push_vertex(c, fec == 0)
            else:
                if fec != 15:
                    # v1 strip codes: 13 -> last-1, 14 -> last+1
                    c = (st.last + (fec - (fec ^ 3))) & 0xFFFFFFFF
                else:
                    c, pos_data = _decode_index(buf, pos_data, st.last)
                st.last = c
                st.push_vertex(c)
            st.push_edge(c, b)
            st.push_edge(a, c)
        else:
            if code < 0xFE:
                aux = codeaux[code & 15]
                feb, fec = aux >> 4, aux & 15
                voff0 = st.voff
                a = st.next_v
                st.next_v += 1
                bf = st.vertexfifo[(voff0 - feb) & 15]
                b = st.next_v if feb == 0 else bf
                if feb == 0:
                    st.next_v += 1
                cf = st.vertexfifo[(voff0 - fec) & 15]
                c = st.next_v if fec == 0 else cf
                if fec == 0:
                    st.next_v += 1
                st.push_vertex(a)
                st.push_vertex(b, feb == 0)
                st.push_vertex(c, fec == 0)
            else:
                aux = buf[pos_data]
                pos_data += 1
                fea = 0 if code == 0xFE else 15
                feb, fec = aux >> 4, aux & 15
                if aux == 0:
                    st.next_v = 0  # reset marker
                voff0 = st.voff
                if fea == 0:
                    a = st.next_v
                    st.next_v += 1
                else:
                    a = 0
                if feb == 0:
                    b = st.next_v
                    st.next_v += 1
                else:
                    b = st.vertexfifo[(voff0 - feb) & 15]
                if fec == 0:
                    c = st.next_v
                    st.next_v += 1
                else:
                    c = st.vertexfifo[(voff0 - fec) & 15]
                if fea == 15:
                    a, pos_data = _decode_index(buf, pos_data, st.last)
                    st.last = a
                if feb == 15:
                    b, pos_data = _decode_index(buf, pos_data, st.last)
                    st.last = b
                if fec == 15:
                    c, pos_data = _decode_index(buf, pos_data, st.last)
                    st.last = c
                st.push_vertex(a)
                st.push_vertex(b, feb == 0 or feb == 15)
                st.push_vertex(c, fec == 0 or fec == 15)
            st.push_edge(b, a)
            st.push_edge(c, b)
            st.push_edge(a, c)
        out[3 * t : 3 * t + 3] = (a, b, c)
    return out


def encode_index_buffer(indices, count: int, version: int = 1) -> bytes:
    """TRIANGLES codec encoder, lockstep with decode_index_buffer: every
    state transition replays the decoder's own update rules, so round-trips
    are exact by construction and the emitted streams follow the reference
    bitstream (validated against hand-decoded ground-truth vectors in
    tests/test_meshopt.py)."""
    idx = np.asarray(indices, np.uint32)
    assert count % 3 == 0
    fecmax = 13 if version >= 1 else 15
    codes = bytearray()
    data = bytearray()
    st = _TriState()

    def find_vertex(v, base_off, lo=1, hi=15):
        """Fifo slot s in [lo, hi) with vertexfifo[(base_off - s) & 15] == v."""
        for s in range(lo, hi):
            if st.vertexfifo[(base_off - s) & 15] == v:
                return s
        return -1

    for t in range(count // 3):
        a, b, c = (int(idx[3 * t]), int(idx[3 * t + 1]), int(idx[3 * t + 2]))
        # edge-fifo match: the decoder reads (a,b) from the fifo and emits
        # (a,b,c), so find a fifo entry equal to a directed edge of this
        # triangle and rotate the matched edge into (a,b) position
        fe = -1
        rot = (a, b, c)
        for e in range(16):
            ea, eb = st.edgefifo[(st.eoff - 1 - e) & 15]
            for (x, y, z) in ((a, b, c), (b, c, a), (c, a, b)):
                if (ea, eb) == (x, y):
                    fe, rot = e, (x, y, z)
                    break
            if fe >= 0:
                break
        a, b, c = rot
        if fe >= 0:
            # pick fec exactly the way the decoder will resolve it
            s = find_vertex(c, st.voff - 1, 1, fecmax)
            if c == st.next_v:
                fec = 0
            elif s >= 0:
                fec = s
            elif version >= 1 and c == (st.last - 1) & 0xFFFFFFFF:
                fec = 13
            elif version >= 1 and c == (st.last + 1) & 0xFFFFFFFF:
                fec = 14
            else:
                fec = 15
                data += _encode_index(c, st.last)
            codes.append((fe << 4) | fec)
            # decoder-mirror state update
            if fec < fecmax:
                if fec == 0:
                    st.next_v += 1
                st.push_vertex(c, fec == 0)
            else:
                st.last = c
                st.push_vertex(c)
            st.push_edge(c, b)
            st.push_edge(a, c)
        else:
            # rotate so a == next when possible (cheapest encodings)
            for (x, y, z) in ((a, b, c), (b, c, a), (c, a, b)):
                if x == st.next_v:
                    a, b, c = x, y, z
                    break
            voff0 = st.voff
            fea = 0 if a == st.next_v else 15
            nv = st.next_v + (1 if fea == 0 else 0)
            sb = find_vertex(b, voff0, 1, 15)
            feb = 0 if b == nv else (sb if sb >= 0 else 15)
            nv += 1 if feb == 0 else 0
            sc = find_vertex(c, voff0, 1, 15)
            fec = 0 if c == nv else (sc if sc >= 0 else 15)
            aux = (feb << 4) | fec
            if fea == 0 and aux in _ENC_CODEAUX:
                codes.append(0xF0 | _ENC_CODEAUX.index(aux))
            else:
                if aux == 0:
                    # aux==0 is the decoder's "reset next" marker — encode
                    # b and c explicitly instead
                    feb = fec = 15
                    aux = 0xFF
                codes.append(0xFE if fea == 0 else 0xFF)
                data.append(aux)
            # decoder-mirror state update (incl. explicit index emission
            # in the decoder's a, b, c read order)
            if fea == 0:
                st.next_v += 1
            if feb == 0:
                st.next_v += 1
            if fec == 0:
                st.next_v += 1
            if fea == 15:
                data += _encode_index(a, st.last)
                st.last = a
            if feb == 15:
                data += _encode_index(b, st.last)
                st.last = b
            if fec == 15:
                data += _encode_index(c, st.last)
                st.last = c
            st.push_vertex(a)
            st.push_vertex(b, feb == 0 or feb == 15)
            st.push_vertex(c, fec == 0 or fec == 15)
            st.push_edge(b, a)
            st.push_edge(c, b)
            st.push_edge(a, c)
    return bytes([INDEX_HEADER | version]) + bytes(codes) + bytes(data) + _ENC_CODEAUX


def encode_index_sequence(indices, count: int) -> bytes:
    idx = np.asarray(indices, np.uint32)
    # meshoptimizer kSequenceHeader is 0xD0 (0xD1 for v1) — distinct from
    # the 0xE0 triangle codec header
    out = bytearray([SEQUENCE_HEADER | 1])
    last = [0, 0]
    for i in range(count):
        v = int(idx[i])
        # low bit selects which of the two "last" slots to delta against
        pick = 0 if abs(v - last[0]) <= abs(v - last[1]) else 1
        d = v - last[pick]
        zz = ((d << 1) ^ (d >> 63)) if d < 0 else (d << 1)
        out += _encode_vbyte((zz << 1) | pick)
        last[pick] = v
    out += bytes(4)  # tail padding
    return bytes(out)


def decode_index_sequence(data: bytes, count: int) -> np.ndarray:
    buf = memoryview(data)
    if buf[0] & 0xF0 != SEQUENCE_HEADER or (buf[0] & 0x0F) > 1:
        raise MeshoptError(f"unsupported meshopt index sequence header 0x{buf[0]:02x}")
    pos = 1
    out = np.empty(count, np.uint32)
    last = [0, 0]
    for i in range(count):
        v, pos = _decode_vbyte(buf, pos)
        pick = v & 1
        val = last[pick] + _unzigzag32(v >> 1)
        last[pick] = val
        out[i] = val
    return out


# ---------------------------------------------------------------- filters
def decode_filter_octahedral(data: np.ndarray, stride: int) -> np.ndarray:
    """Unit vectors from oct encoding: 4x int8 (stride 4) or 4x int16
    (stride 8); components (x, y, z_sign_free, w) -> normalized xyz + w."""
    if stride == 4:
        q = data.reshape(-1, 4).view(np.int8).astype(np.float32)
        maxv = 127.0
        out_dtype = np.int8
    else:
        q = data.reshape(-1, 8).view(np.int16).astype(np.float32)
        maxv = 32767.0
        out_dtype = np.int16
    x = q[:, 0] / maxv
    y = q[:, 1] / maxv
    one = np.float32(1.0)
    z = one - np.abs(x) - np.abs(y)
    t = np.maximum(-z, 0.0)
    x -= np.sign(x) * t
    y -= np.sign(y) * t
    n = np.sqrt(x * x + y * y + z * z)
    n = np.where(n < 1e-20, 1.0, n)
    out = np.stack([x / n, y / n, z / n, q[:, 3] / maxv], axis=1)
    return np.clip(np.rint(out * maxv), -maxv - 1, maxv).astype(out_dtype).view(np.uint8).reshape(-1)


def decode_filter_quaternion(data: np.ndarray) -> np.ndarray:
    """Smallest-three quaternion filter — mirror of meshoptimizer's
    decodeFilterQuat: the variable-precision range scale is recovered from
    sf = q[3] | 3 (ss = (1/sqrt2)/sf), the max component w is reconstructed
    from the unit norm, and components are written ROTATED by the max-
    component index qc = q[3] & 3: x->qc+1, y->qc+2, z->qc+3, w->qc."""
    q = data.reshape(-1, 8).view(np.int16).astype(np.int32)
    sf = (q[:, 3] | 3).astype(np.float32)
    ss = np.float32(1.0 / np.sqrt(2.0)) / sf
    x = q[:, 0].astype(np.float32) * ss
    y = q[:, 1].astype(np.float32) * ss
    z = q[:, 2].astype(np.float32) * ss
    w = np.sqrt(np.maximum(0.0, 1.0 - x * x - y * y - z * z))
    qc = (q[:, 3] & 3).astype(np.int64)
    n = q.shape[0]
    comp = np.stack([x, y, z, w], axis=1)  # snorm16 rounded like the reference
    comp = np.clip(np.where(comp >= 0, np.floor(comp * 32767.0 + 0.5),
                            np.ceil(comp * 32767.0 - 0.5)), -32768, 32767).astype(np.int16)
    out = np.empty((n, 4), np.int16)
    rows = np.arange(n)
    out[rows, (qc + 1) & 3] = comp[:, 0]
    out[rows, (qc + 2) & 3] = comp[:, 1]
    out[rows, (qc + 3) & 3] = comp[:, 2]
    out[rows, qc & 3] = comp[:, 3]
    return out.view(np.uint8).reshape(-1)


def decode_filter_exponential(data: np.ndarray) -> np.ndarray:
    """Shared-exponent float filter: each 4-byte value is a 24-bit signed
    mantissa + 8-bit signed exponent; float = mantissa * 2^exponent."""
    v = data.reshape(-1, 4).view(np.uint32).reshape(-1)
    exp = (v >> 24).astype(np.int32)
    exp = np.where(exp >= 128, exp - 256, exp)
    man = (v & 0xFFFFFF).astype(np.int32)
    man = np.where(man >= 0x800000, man - 0x1000000, man)
    out = man.astype(np.float64) * np.exp2(exp.astype(np.float64))
    return out.astype(np.float32).view(np.uint8)


# ------------------------------------------------------------ glTF plumbing
MESHOPT_KEYS = ("EXT_meshopt_compression", "KHR_meshopt_compression")


def _meshopt_key(view: dict):
    for k in MESHOPT_KEYS:
        if k in view.get("extensions", {}):
            return k
    return None


def decompress_buffer_view(model, view: dict) -> bytes:
    """Decode one EXT_/KHR_meshopt_compression buffer view to raw bytes
    (the reference's utils accept both spellings, tinygltf_utils.hpp)."""
    ext = view["extensions"][_meshopt_key(view)]
    src = bytes(model.buffers[ext["buffer"]])
    off = ext.get("byteOffset", 0)
    blob = src[off : off + ext["byteLength"]]
    count = ext["count"]
    stride = ext.get("byteStride", 4)
    mode = ext["mode"]
    if mode == MODE_ATTRIBUTES:
        raw = decode_vertex_buffer(blob, count, stride)
    elif mode == MODE_TRIANGLES:
        idx = decode_index_buffer(blob, count)
        if stride == 2:
            raw = idx.astype(np.uint16).tobytes()
        else:
            raw = idx.astype(np.uint32).tobytes()
    elif mode == MODE_INDICES:
        idx = decode_index_sequence(blob, count)
        raw = (idx.astype(np.uint16) if stride == 2 else idx.astype(np.uint32)).tobytes()
    else:
        raise MeshoptError(f"unknown meshopt mode {mode!r}")
    filt = ext.get("filter", "NONE")
    if filt != "NONE" and mode == MODE_ATTRIBUTES:
        arr = np.frombuffer(raw, np.uint8)
        if filt == "OCTAHEDRAL":
            raw = decode_filter_octahedral(arr, stride).tobytes()
        elif filt == "QUATERNION":
            raw = decode_filter_quaternion(arr).tobytes()
        elif filt == "EXPONENTIAL":
            raw = decode_filter_exponential(arr).tobytes()
        else:
            raise MeshoptError(f"unknown meshopt filter {filt!r}")
    return raw


def decompress_model(model) -> int:
    """Decode every meshopt buffer view in place and drop the extension
    (reference decompressMeshoptExtension, gltf_scene.cpp:372-430).
    Returns the number of views decompressed."""
    views = model.gltf.get("bufferViews", [])
    n = 0
    for view in views:
        key = _meshopt_key(view)
        if key is None:
            continue
        raw = decompress_buffer_view(model, view)
        # move the decoded bytes to a fresh buffer region appended to
        # buffer 0 (self-contained; offsets rewritten)
        if not model.buffers:
            model.buffers.append(bytearray())
        buf0 = model.buffers[0]
        pad = (-len(buf0)) % 4
        buf0.extend(b"\0" * pad)
        view["buffer"] = 0
        view["byteOffset"] = len(buf0)
        view["byteLength"] = len(raw)
        buf0.extend(raw)
        del view["extensions"][key]
        if not view["extensions"]:
            del view["extensions"]
        n += 1
    if n:
        g = model.gltf
        if len(g.get("buffers", [])) >= 1:
            g["buffers"][0]["byteLength"] = len(model.buffers[0])
        for lk in ("extensionsRequired", "extensionsUsed"):
            for mk in MESHOPT_KEYS:
                if mk in g.get(lk, []):
                    g[lk].remove(mk)
            if lk in g and not g[lk]:
                del g[lk]
    return n
