"""Fixtures and tables shared by the port's tests (tests/test_torch_*.py)."""

import os
import shutil
import struct

import numpy as np
import pytest
import torch


def share_native_builder():
    """Make the reference's native SAH builder load the port's copy of its
    library. Call it at import of every port test module that reaches the
    reference's build_world_bvh, build_scene_flat or native.

    The reference (vk_gltf_renderer_tpu/native) returns its cached .so as
    soon as the path exists, while g++ still writes it in place; on a cold
    cache a second test worker then loads a half-written file ("file too
    short"). The port's copy builds to a temporary name and renames it
    (vk_gltf_renderer_tpu_torch/native), and both libraries are named by
    the sha256 of the same bvh_builder.cpp text (held equal by
    tests/test_torch_host.py). So this builds the port's library and points
    the reference's cache directory at the port's build directory, where
    the reference finds a complete file and never starts g++. It also
    seeds the reference's own cache file by copy and rename, which narrows
    the window in which the reference's own tests race each other there.

    Not called when this module is imported: tests/test_torch_cuda.py
    imports it on the card's machine, which has no JAX, and the reference
    package imports jax whenever JAX_PLATFORMS is set."""
    from vk_gltf_renderer_tpu import native as jnative
    from vk_gltf_renderer_tpu_torch import native as tnative

    if tnative.get_lib() is None:
        return
    own = jnative._CACHE
    jnative._CACHE = tnative._CACHE
    path = jnative._build_lib()  # the port's file: found, not built
    seed = own / path.name
    if path != seed and not seed.exists():
        own.mkdir(parents=True, exist_ok=True)
        tmp = seed.with_suffix(f".{os.getpid()}.tmp")
        shutil.copyfile(path, tmp)
        os.replace(tmp, seed)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread while the test runs. The wavefront walk issues
    ~80 tiny torch ops per step; with several test workers each running a
    full thread pool on the same cores, those ops spend far longer
    synchronising threads than computing (a 6-worker run took ~50x the
    single-process time). The walk is elementwise, so its results do not
    depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deep_chain_bvh4(levels=24, stubs=False):
    """A degenerate BVH4 that no stack of 64 entries can walk: `levels`
    rows whose 4 child boxes are all [-1, 1]^3, child slot 0 the next row
    and slots 1-3 an empty leaf (code -1: tris128 row 0, no triangle),
    every split axis x. A ray from inside the box with dx >= 0 enters all
    four children of every row, pushes them far first and pops slot 0, so
    its stack grows by 3 a row: past 21 rows the pushes of row 21's slots
    2, 1 and 0 are dropped (3 a ray) and the walk ends in empty leaves.
    Returns (nodes4_fi [L,32] f32, nodes4_sc [L,8] i32, tris128 [1,128]
    f32) as numpy arrays, the root code being 0.

    stubs: slots 1-3 of every chain row are instead one more row (row L)
    whose four children are empty leaves. The v5 walk pops a chain row and
    three stubs a step and pushes 16 children, so its stack grows by 12 a
    row and overflows a 128-entry stack (the single-pop walks grow by 3 a
    row as before)."""
    fi = np.zeros((levels + stubs, 32), np.float32)
    fi[:, 0:24] = np.tile(np.float32([-1, -1, -1, 1, 1, 1]), 4)
    fi[:levels, 24] = np.append(np.arange(1, levels), -1)
    fi[:levels, 25:28] = levels if stubs else -1
    fi[levels:, 24:28] = -1
    sc = np.zeros((levels + stubs, 8), np.int32)
    sc[:, 0:4] = fi[:, 24:28]
    return fi, sc, np.zeros((1, 128), np.float32)


def deep_chain(levels, arity):
    """deep_chain_bvh4's chain for the BVH2 (arity 2, nodes_fi) and BVH16
    (arity 16, nodes16_fi) walks: `levels` rows whose child boxes are all
    [-1, 1]^3, child slot 0 the next row (an empty leaf in the last) and
    the other slots empty leaves (code -1), every split axis x. A ray from
    inside the box with dx >= 0 enters every child, so visit position p is
    slot p: it pushes the arity - 1 leaves and then the next row, pops that
    row (the BVH2 walk descends into it instead), and its stack grows by
    arity - 1 a row. Returns (nodes [L,8A] f32, tris128 [1,128] f32) as
    numpy arrays, the root code being 0.

    BVH2 (128 entries): rows 0-127 fit, and every row from row 128 on
    drops its far leaf, 1 push a live ray. BVH16 (256 entries): rows 0-16
    fit, and a chain of 18 rows or more drops 15 (row 17's children but
    the one that fills the stack)."""
    a = arity
    nodes = np.zeros((levels, 8 * a), np.float32)
    nodes[:, 0 : 6 * a] = np.tile(np.float32([-1, -1, -1, 1, 1, 1]), a)
    nodes[:, 6 * a : 7 * a] = -1
    nodes[:, 6 * a] = np.append(np.arange(1, levels), -1)
    return nodes, np.zeros((1, 128), np.float32)


def deep_chain_split(levels):
    """deep_chain's BVH2 chain as the v1 walk's split tables: internal nodes
    0 .. levels-1, both child boxes [-1, 1]^3, the left child the next node
    (the leaf for the last one), the right child the one leaf node
    `levels`, which holds tris row 0: a degenerate triangle (all zeros) that
    nothing hits; every split axis x. A ray from inside the box with dx >= 0
    enters both children of every node, the left one nearer: the v1 walk
    pushes the leaf and descends into the next node, so its stack grows by
    1 a node, and from node 128 on every live ray drops one push a node
    (the walk before, which pushed both children, lost the chain at node
    127 instead). Returns (nodes_f [L+1,16] f32, nodes_i [L+1,8] i32, tris
    [9,16] f32) as numpy arrays."""
    nodes_f = np.zeros((levels + 1, 16), np.float32)
    nodes_f[:levels, 0:12] = np.tile(np.float32([-1, -1, -1, 1, 1, 1]), 2)
    nodes_i = np.zeros((levels + 1, 8), np.int32)
    nodes_i[:levels, 0] = np.arange(1, levels + 1)
    nodes_i[:levels, 1] = levels
    nodes_i[levels, 3] = 1  # first 0, count 1
    nodes_i[:, 4] = np.append(-1, np.arange(levels))  # parents
    return nodes_f, nodes_i, np.zeros((9, 16), np.float32)


def deep_chain_rays(n, seed):
    """n rays from inside deep_chain_bvh4's box with dx >= 0, as the 8 [N]
    f32 numpy components (tmin 0, tmax 1e32)."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 0] = np.abs(rd[:, 0])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return [*(np.ascontiguousarray(a) for a in (*ro.T, *rd.T)), np.zeros(n, np.float32),
            np.full(n, 1e32, np.float32)]


# ------------------------------------------------------------ JPEG forms Pillow cannot write

# T.81 Table D.3 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), entry 113 the fixed 0.5 estimate
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0),
    (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0), (0x001a, 33, 10, 0),
    (0x000d, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0),
    (0x002c, 33, 9, 0), (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0),
    (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1),
    (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0), (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0), (0x34ee, 91, 85, 0),
    (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0),
    (0x56a8, 95, 96, 1), (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0),
    (0x4639, 107, 104, 0), (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0),
    (0x4b85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]


class QMEncoder:
    """The QM coder of T.81 Annex D as libjpeg's jcarith.c writes it (the
    statistics bins are bytearrays: bit 7 the MPS, bits 0-6 the state)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_stack(self, byte):
        """Output the pending zero bytes, then byte (stuffed)."""
        while self.zc:
            self._emit(0)
            self.zc -= 1
        self._emit(byte)
        if byte == 0xFF:
            self._emit(0)

    def encode(self, st, i, val):
        sv = st[i]
        qe, nlps, nmps, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_stack(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_stack(self.buffer)
                    if self.sc:
                        while self.zc:
                            self._emit(0)
                            self.zc -= 1
                        while self.sc:
                            self._emit(0xFF)
                            self._emit(0)
                            self.sc -= 1
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_stack(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_stack(self.buffer)
            if self.sc:
                while self.zc:
                    self._emit(0)
                    self.zc -= 1
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
        if self.c & 0x7FFF800:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        return bytes(self.out)


class _ArithScan:
    """One arithmetic-coded scan, as jcarith.c codes it (DAC bounds L, U
    and K per table index)."""

    def __init__(self, ncomp, dac_l, dac_u, dac_k, ss, se, ah, al, progressive):
        self.q = QMEncoder()
        self.dc_stats = [bytearray(64) for _ in range(4)]
        self.ac_stats = [bytearray(256) for _ in range(4)]
        self.fixed = bytearray([113])
        self.last = [0] * ncomp
        self.ctx = [0] * ncomp
        self.dac_l, self.dac_u, self.dac_k = dac_l, dac_u, dac_k
        self.ss, self.se, self.ah, self.al, self.progressive = ss, se, ah, al, progressive

    def _magnitude(self, st, base, v, k=None, tbl=None):
        """Figures F.8/F.9: v >= 1 in the bins from st[base] (the category
        chain from X1 = 20 for DC, 189/217 for AC)."""
        q = self.q
        m = 0
        v -= 1
        if v:
            q.encode(st, base, 1)
            m = 1
            v2 = v
            if k is None:  # DC
                base = 20
                while v2 >> 1:
                    v2 >>= 1
                    q.encode(st, base, 1)
                    m <<= 1
                    base += 1
            elif v2 >> 1:
                v2 >>= 1
                q.encode(st, base, 1)
                m <<= 1
                base = 189 if k <= self.dac_k[tbl] else 217
                while v2 >> 1:
                    v2 >>= 1
                    q.encode(st, base, 1)
                    m <<= 1
                    base += 1
        q.encode(st, base, 0)
        base += 14
        while m > 1:
            m >>= 1
            q.encode(st, base, 1 if m & v else 0)
        return m

    def dc(self, ci, tbl, value):
        q, st = self.q, self.dc_stats[tbl]
        s0 = self.ctx[ci]
        v = value - self.last[ci]
        if v == 0:
            q.encode(st, s0, 0)
            self.ctx[ci] = 0
            return
        self.last[ci] = value
        q.encode(st, s0, 1)
        if v > 0:
            q.encode(st, s0 + 1, 0)
            base, self.ctx[ci] = s0 + 2, 4
        else:
            v = -v
            q.encode(st, s0 + 1, 1)
            base, self.ctx[ci] = s0 + 3, 8
        # the category m of v - 1, for the context before the bits are coded
        m = 0 if v - 1 == 0 else 1 << ((v - 1).bit_length() - 1)
        self._magnitude(st, base, v)
        if m < (1 << self.dac_l[tbl]) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << self.dac_u[tbl]) >> 1:
            self.ctx[ci] += 8

    def ac_sequential(self, tbl, blk, zigzag):
        q, st = self.q, self.ac_stats[tbl]
        zz = blk[zigzag]
        ke = 63
        while ke and zz[ke] == 0:
            ke -= 1
        k = 0
        while k < ke:
            s = 3 * k
            q.encode(st, s, 0)
            k += 1
            while zz[k] == 0:
                q.encode(st, s + 1, 0)
                s += 3
                k += 1
            q.encode(st, s + 1, 1)
            v = int(zz[k])
            q.encode(self.fixed, 0, 0 if v > 0 else 1)
            self._magnitude(st, s + 2, abs(v), k, tbl)
        if k < 63:
            q.encode(st, 3 * k, 1)

    def ac_first(self, tbl, blk, zigzag):
        q, st, al = self.q, self.ac_stats[tbl], self.al
        zz = [int(v) for v in blk[zigzag]]

        def shifted(v):
            return v >> al if v >= 0 else -((-v) >> al)

        ke = self.se
        while ke > 0 and shifted(zz[ke]) == 0:
            ke -= 1
        k = self.ss
        while k <= ke:
            s = 3 * (k - 1)
            q.encode(st, s, 0)
            while True:
                v = shifted(zz[k])
                if v:
                    q.encode(st, s + 1, 1)
                    q.encode(self.fixed, 0, 0 if v > 0 else 1)
                    break
                q.encode(st, s + 1, 0)
                s += 3
                k += 1
            self._magnitude(st, s + 2, abs(v), k, tbl)
            k += 1
        if k <= self.se:
            q.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, blk, zigzag):
        q, st, al, ah = self.q, self.ac_stats[tbl], self.al, self.ah
        zz = [abs(int(v)) for v in blk[zigzag]]
        sign = [int(v) < 0 for v in blk[zigzag]]
        ke = self.se
        while ke > 0 and zz[ke] >> al == 0:
            ke -= 1
        kex = ke
        while kex > 0 and zz[kex] >> ah == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            s = 3 * (k - 1)
            if k > kex:
                q.encode(st, s, 0)
            while True:
                v = zz[k] >> al
                if v:
                    if v >> 1:
                        q.encode(st, s + 2, v & 1)
                    else:
                        q.encode(st, s + 1, 1)
                        q.encode(self.fixed, 0, 1 if sign[k] else 0)
                    break
                q.encode(st, s + 1, 0)
                s += 3
                k += 1
            k += 1
        if k <= self.se:
            q.encode(st, 3 * (k - 1), 1)


def jpeg_from_planes(planes, samp=None, quality=75, adobe=None, jfif=True, arith=False, progressive=False,
                     dac=None, restart=0, ids=None):
    """A DCT JPEG of 1, 3 or 4 full-size uint8 planes (stored as given: no
    colour conversion), baseline Huffman, or arithmetic-coded (SOF9, or
    SOF10 with progressive: DC first and refinement, then per component AC
    bands 1-5 and 6-63 at point transform 1 and their refinements). adobe:
    the Adobe APP14 transform byte, or None for no marker; dac: {(class,
    table): value} DAC entries; restart: the interval in MCUs."""
    from vk_gltf_renderer_tpu_torch.ops import jpeg as tj

    nc = len(planes)
    samp = samp or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    qlum, qchrom = tj.quality_tables(quality)
    qsel = [0] + [1] * (nc - 1)
    comp = tj.component_blocks([p.astype(np.int64) for p in planes], samp, [(qlum, qchrom)[q] for q in qsel])
    height, width = planes[0].shape
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    zigzag = tj.ZIGZAG
    dac = dac or {}
    dac_l, dac_u, dac_k = [0] * 4, [1] * 4, [5] * 4
    for (cls, tbl), val in dac.items():
        if cls == 0:
            dac_l[tbl], dac_u[tbl] = val & 15, val >> 4
        else:
            dac_k[tbl] = val

    def scan_units(indices):
        """(component, table index, block) in coding order, grouped in MCUs."""
        if len(indices) == 1:
            i = indices[0]
            h, v = samp[i]
            cw, ch = -(-width * h // hmax), -(-height * v // vmax)
            return [[(0, min(i, 1), comp[i][by, bx])] for by in range(-(-ch // 8)) for bx in range(-(-cw // 8))]
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = []
                for ci, i in enumerate(indices):
                    h, v = samp[i]
                    for y in range(v):
                        for x in range(h):
                            mcu.append((ci, min(i, 1), comp[i][my * v + y, mx * h + x]))
                units.append(mcu)
        return units

    def arith_scan(indices, ss, se, ah, al):
        out = []
        sc = None
        for n, mcu in enumerate(scan_units(indices)):
            if sc is None or (restart and n % restart == 0):
                if sc is not None:
                    out.append(sc.q.finish() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8]))
                sc = _ArithScan(len(indices), dac_l, dac_u, dac_k, ss, se, ah, al, progressive)
            for ci, tbl, blk in mcu:
                if not progressive:
                    sc.dc(ci, tbl, int(blk[0]))
                    sc.ac_sequential(tbl, blk, zigzag)
                elif ss == 0 and ah == 0:
                    sc.dc(ci, tbl, int(blk[0]) >> al)
                elif ss == 0:
                    sc.q.encode(sc.fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    sc.ac_first(tbl, blk, zigzag)
                else:
                    sc.ac_refine(tbl, blk, zigzag)
        out.append(sc.q.finish())
        return b"".join(out)

    def sos(indices, ss, se, ah, al):
        head = bytes([len(indices)]) + b"".join(bytes([ids[i], (min(i, 1) << 4) | min(i, 1)]) for i in indices)
        head += bytes([ss, se, (ah << 4) | al])
        if arith:
            data = arith_scan(indices, ss, se, ah, al)
        else:
            units = scan_units(indices)
            blocks = np.asarray([b for mcu in units for _, _, b in mcu], np.int16).reshape(-1, 64)
            owner = np.asarray([ci for mcu in units for ci, _, _ in mcu], np.int32)
            names = [("dc_lum", "ac_lum") if i == 0 else ("dc_chrom", "ac_chrom") for i in indices]
            if restart:
                raise ValueError("restart intervals are written for arithmetic scans only")
            data = tj._encode_scan(blocks, owner, names, ss, se)
        return tj._segment(0xDA, head) + data

    out = [b"\xff\xd8"]
    if jfif:
        out.append(tj._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        out.append(tj._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe])))
    for t, q in enumerate((qlum, qchrom)[: 1 if nc == 1 else 2]):
        out.append(tj._segment(0xDB, bytes([t]) + bytes(q[zigzag].astype(np.uint8))))
    marker = (0xCA if progressive else 0xC9) if arith else 0xC0
    sof = struct.pack(">BHHB", 8, height, width, nc) + b"".join(
        bytes([ids[i], (samp[i][0] << 4) | samp[i][1], qsel[i]]) for i in range(nc))
    out.append(tj._segment(marker, sof))
    if arith:
        if dac:
            out.append(tj._segment(0xCC, b"".join(bytes([(c << 4) | t, v]) for (c, t), v in sorted(dac.items()))))
    else:
        for th, names in enumerate((("dc_lum", "ac_lum"), ("dc_chrom", "ac_chrom"))[: 1 if nc == 1 else 2]):
            for cls, name in enumerate(names):
                bits, vals = tj.STD_HUFFMAN[name]
                out.append(tj._segment(0xC4, bytes([(cls << 4) | th]) + bits + vals))
    if restart:
        out.append(tj._segment(0xDD, struct.pack(">H", restart)))
    every = list(range(nc))
    if progressive:
        out.append(sos(every, 0, 0, 0, 1))
        out.append(sos(every, 0, 0, 1, 0))
        for i in every:
            out.append(sos([i], 1, 5, 0, 1))
            out.append(sos([i], 6, 63, 0, 1))
            out.append(sos([i], 1, 63, 1, 0))
    else:
        out.append(sos(every, 0, 63, 0, 0))
    out.append(b"\xff\xd9")
    return b"".join(out)


def jpeg_lossless(planes, predictor=1, pt=0, restart_rows=0, jfif=False, adobe=None, samp=None, interleaved=True,
                  size=None):
    """An 8-bit lossless JPEG (SOF3, Huffman with the Annex K DC luminance
    table) of 1, 3 or 4 uint8 planes: predictor 1-7, point transform pt,
    restart markers every restart_rows rows (1x1 sampling only).

    samp gives each component's (h, v) sampling factors (1x1 by default);
    then each plane is the component at its own size, ceil(W * h / hmax) x
    ceil(H * v / vmax), and size = (W, H) the image's (the first plane's
    size by default). interleaved=False writes one scan per component;
    interleaved scans code the dummy samples past a component's edge, in
    its last MCU column and row, as zero differences."""
    from vk_gltf_renderer_tpu_torch.ops import jpeg as tj

    nc = len(planes)
    samp = samp or [(1, 1)] * nc
    if restart_rows and any(s != (1, 1) for s in samp):
        raise ValueError("restart markers with 1x1 sampling only")
    hmax, vmax = max(s[0] for s in samp), max(s[1] for s in samp)
    w, h = size or planes[0].shape[::-1]
    code, size_ = tj._huff_codes(*tj.STD_HUFFMAN["dc_lum"])
    initial = 1 << (8 - pt - 1)

    def differences(q):
        """A component's differences in its own raster order (its first row,
        and the first row of each restart interval, predicted from the left)."""
        p = np.asarray(q, np.int64) >> pt
        ch, cw = p.shape
        d = np.empty_like(p)
        for y in range(ch):
            first = y == 0 or (restart_rows and y % restart_rows == 0)
            for x in range(cw):
                if first:
                    pred = initial if x == 0 else p[y, x - 1]
                elif x == 0:
                    pred = p[y - 1, x]
                else:
                    ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                v = int(p[y, x] - pred) % 65536
                d[y, x] = v - 65536 if v >= 32768 else v
        return d

    diffs = [differences(q) for q in planes]

    def put(bits, v):
        s = 0 if v == 0 else abs(v).bit_length()
        bits.append((int(code[s]), int(size_[s])))
        if s:
            bits.append((v if v > 0 else v + (1 << s) - 1, s))

    def flush(bits):
        acc = n = 0
        out = bytearray()
        for v, s in bits:
            acc = (acc << s) | (v & ((1 << s) - 1))
            n += s
            while n >= 8:
                b = (acc >> (n - 8)) & 255
                out += bytes([b, 0]) if b == 255 else bytes([b])
                n -= 8
        if n:
            b = ((acc << (8 - n)) | ((1 << (8 - n)) - 1)) & 255
            out += bytes([b, 0]) if b == 255 else bytes([b])
        bits.clear()
        return bytes(out)

    def scan_header(comps):
        return tj._segment(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps)
                           + bytes([predictor, 0, pt]))

    scans = []
    if interleaved:
        bits, segments = [], []
        mcux, mcuy = -(-w // hmax), -(-h // vmax)
        for my in range(mcuy):
            if restart_rows and my and my % restart_rows == 0:
                segments.append(flush(bits))
                segments.append(bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8]))
            for mx in range(mcux):
                for c, (hc, vc) in enumerate(samp):
                    d = diffs[c]
                    for yy in range(vc):
                        for xx in range(hc):
                            y, x = my * vc + yy, mx * hc + xx
                            put(bits, int(d[y, x]) if y < d.shape[0] and x < d.shape[1] else 0)
        segments.append(flush(bits))
        scans.append(scan_header(range(nc)) + b"".join(segments))
    else:
        for c in range(nc):
            bits = []
            for v in diffs[c].reshape(-1):
                put(bits, int(v))
            scans.append(scan_header([c]) + flush(bits))
    dc_bits, dc_vals = tj.STD_HUFFMAN["dc_lum"]
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(bytes([i + 1, (hc << 4) | vc, 0])
                                                      for i, (hc, vc) in enumerate(samp))
    out = [b"\xff\xd8"]
    if jfif:
        out.append(tj._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        out.append(tj._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe])))
    out += [tj._segment(0xC3, sof), tj._segment(0xC4, bytes([0]) + dc_bits + dc_vals)]
    if restart_rows:
        out.append(tj._segment(0xDD, struct.pack(">H", restart_rows * w)))
    out += [*scans, b"\xff\xd9"]
    return b"".join(out)


def cmyk_to_ycck(cmyk):
    """libjpeg's jccolor.c cmyk_ycck_convert: (255 - C, 255 - M, 255 - Y) to
    YCbCr, K as it is (uint8 [..., 4] -> 4 planes)."""
    from vk_gltf_renderer_tpu_torch.ops import jpeg as tj

    y, cb, cr = tj._rgb_to_ycc(255 - cmyk[..., :3].astype(np.int32))
    return [y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8), cmyk[..., 3]]
