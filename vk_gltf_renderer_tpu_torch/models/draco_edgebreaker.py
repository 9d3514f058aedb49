"""Draco edgebreaker connectivity (clean-room, spec-frame).

The Draco bitstream's edgebreaker path stores mesh connectivity as a
CLERS symbol stream (Rossignac's Edgebreaker) that the decoder rebuilds by
processing the symbols in reverse (Spirale Reversi construction,
Isenburg & Snoeyink). This module implements that algorithm pair:

  encoder: corner-table Edgebreaker over a single closed orientable
           genus-0 manifold component (Euler characteristic gate). C when
           the gate tip is unvisited (recurse right), R/L when one
           neighbour is closed (recurse the other), S when both are open
           (right subtree first), E when both are closed. Anything
           outside that topology class raises NotEdgebreakerEncodable and
           encode_mesh falls back to the sequential method — the same
           method choice a real encoder makes.
  decoder: Spirale Reversi over the reversed symbol stream. Each patch is
           a circular doubly-linked boundary with a gate half-edge (the
           region-side half-edge along the edge through which the forward
           traversal entered the patch's first face):
             E — new triangle patch (three new vertices);
             R — glue a triangle on the gate, gate START stays, one NEW
                 vertex appears on the entry side;
             L — mirror of R;
             C — glue a triangle consuming TWO boundary edges, closing
                 the middle vertex's star;
             S — pop the right patch, bridge it to the left patch across
                 the S face, identifying the shared tip via union-find.
           After all symbols one patch remains and its 3-vertex boundary
           is the traversal's seed face.

Symbol bit patterns: C = single 0 bit; R/L/E/S = 3 bits (100/101/110/111),
MSB-first in DirectBit words. Vertex ids on both sides are canonicalized
by first appearance over the decoded face list, so attribute order agrees
without transmitting a permutation (the encoder literally runs this
decoder on its own stream to derive the mapping, and hard-fails on any
role mismatch). Validation: round-trip over closed primitive meshes plus
the glTF-boundary structural guard (models/draco.py docstring).
"""

from __future__ import annotations

import numpy as np

from .draco import (
    ByteReader,
    ByteWriter,
    DirectBitDecoder,
    DirectBitEncoder,
    DracoError,
)

SYM_C, SYM_R, SYM_L, SYM_E, SYM_S = 0, 1, 2, 3, 4
_SYM_BITS = {SYM_C: (0, 1), SYM_R: (0b100, 3), SYM_L: (0b101, 3),
             SYM_E: (0b110, 3), SYM_S: (0b111, 3)}
_TWO_BITS = {0b00: SYM_R, 0b01: SYM_L, 0b10: SYM_E, 0b11: SYM_S}


class NotEdgebreakerEncodable(DracoError):
    """Mesh topology outside the closed-manifold genus-0 subset."""


def _next(c):
    return c - c % 3 + (c + 1) % 3


def _prev(c):
    return c - c % 3 + (c + 2) % 3


def _build_corner_table(faces, num_points):
    """V (corner -> vertex) and O (corner -> opposite corner).
    Raises NotEdgebreakerEncodable on boundary / non-manifold edges."""
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    nf = faces.shape[0]
    V = faces.reshape(-1).copy()
    O = np.full(nf * 3, -1, np.int64)
    edge_map = {}
    for f in range(nf):
        for i in range(3):
            c = 3 * f + i
            a = int(V[_next(c)])
            b = int(V[_prev(c)])
            if a == b or a == int(V[c]) or b == int(V[c]):
                raise NotEdgebreakerEncodable("degenerate triangle")
            if (b, a) in edge_map:
                oc = edge_map.pop((b, a))
                O[c] = oc
                O[oc] = c
            else:
                if (a, b) in edge_map:
                    raise NotEdgebreakerEncodable("non-manifold or unoriented edge")
                edge_map[(a, b)] = c
    if edge_map:
        raise NotEdgebreakerEncodable("boundary edges present")
    return V, O


# ---------------------------------------------------------------- decoder
class _Node:
    __slots__ = ("v", "nxt", "prv")

    def __init__(self, v):
        self.v = v
        self.nxt = None
        self.prv = None


def _link(a, b):
    a.nxt = b
    b.prv = a


class _UF:
    def __init__(self):
        self.parent = {}

    def make(self, x):
        self.parent[x] = x
        return x

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _reversi(symbols):
    """Spirale Reversi. Returns raw faces [(tip, u, w), ...] — face k is
    the one reconstructed at reverse step k (symbol index n-1-k), with the
    seed face appended last. Vertex ids are union-find roots; call
    _canonicalize to number them."""
    uf = _UF()
    counter = [0]

    def new_v():
        v = uf.make(counter[0])
        counter[0] += 1
        return v

    patches = []  # stack of gate nodes (gate edge = (gate, gate.nxt))
    faces = []

    for s in reversed(symbols):
        if s == SYM_E:
            t, u, w = new_v(), new_v(), new_v()
            nt, nu, nw = _Node(t), _Node(u), _Node(w)
            # face cycle t->u, u->w, w->t; region = this face, boundary
            # follows the face orientation; gate = half-edge along the
            # forward-entry edge {u, w}
            _link(nt, nu)
            _link(nu, nw)
            _link(nw, nt)
            patches.append(nu)  # edge (u -> w)
            faces.append((t, u, w))
        elif s == SYM_R:
            # subtree = LEFT branch (entered via {t, w}); gate = (t -> w).
            # u is NEW; boundary (t->w) becomes (t->u),(u->w); new gate =
            # (u -> w).
            if not patches:
                raise DracoError("edgebreaker R with no active patch")
            gt = patches.pop()
            gw = gt.nxt
            nu = _Node(new_v())
            _link(gt, nu)
            _link(nu, gw)
            patches.append(nu)
            faces.append((gt.v, nu.v, gw.v))
        elif s == SYM_L:
            # subtree = RIGHT branch (entered via {t, u}); gate = (u -> t).
            # w is NEW; boundary (u->t) becomes (u->w),(w->t); new gate =
            # (u -> w).
            if not patches:
                raise DracoError("edgebreaker L with no active patch")
            gu = patches.pop()
            gt = gu.nxt
            nw = _Node(new_v())
            _link(gu, nw)
            _link(nw, gt)
            patches.append(gu)
            faces.append((gt.v, gu.v, nw.v))
        elif s == SYM_C:
            # tip closes: boundary ... u -> t -> w ... with gate (u -> t);
            # consume (u->t),(t->w) into (u->w); new gate = (u -> w).
            if not patches:
                raise DracoError("edgebreaker C with no active patch")
            gu = patches.pop()
            gt = gu.nxt
            gw = gt.nxt
            if gw is gu:
                raise DracoError("edgebreaker C on a 2-vertex boundary")
            _link(gu, gw)
            patches.append(gu)
            faces.append((gt.v, gu.v, gw.v))
        elif s == SYM_S:
            # top = RIGHT subtree patch with gate (u -> t_r); below = LEFT
            # subtree patch with gate (t_l -> w). Identify t_r == t_l,
            # bridge boundaries across the S face, new gate = (u -> w).
            if len(patches) < 2:
                raise DracoError("edgebreaker S with fewer than two patches")
            gu = patches.pop()   # right patch gate (u -> t_r)
            gl = patches.pop()   # left patch gate (t_l -> w)
            rt = gu.nxt          # t_r node
            gw = gl.nxt          # w node
            uf.union(rt.v, gl.v)
            y = rt.nxt           # right boundary continues after t_r
            p = gl.prv           # left boundary before t_l
            _link(gu, gw)        # new boundary edge (u -> w)
            _link(p, rt)         # left chain flows into the surviving t
            # (rt -> y) link is unchanged
            patches.append(gu)
            faces.append((rt.v, gu.v, gw.v))
        else:
            raise DracoError(f"bad edgebreaker symbol {s}")

    if len(patches) != 1:
        raise DracoError("edgebreaker did not converge to one patch")
    g = patches[0]
    a = g.nxt
    b = a.nxt
    if b.nxt is not g:
        raise DracoError("final boundary is not a triangle")
    # remaining boundary cycle (g -> a -> b) is the seed face seen from
    # the region side; the seed's own orientation is the reverse, with
    # the tip being the vertex off the final gate edge (g, a)
    faces.append((b.v, a.v, g.v))
    roots = [tuple(uf.find(v) for v in f) for f in faces]
    return roots


def _canonicalize(faces):
    """First-appearance renumbering over the face list."""
    mapping = {}
    out = []
    for f in faces:
        row = []
        for v in f:
            if v not in mapping:
                mapping[v] = len(mapping)
            row.append(mapping[v])
        out.append(tuple(row))
    return out, len(mapping)


# ---------------------------------------------------------------- encoder
def encode_edgebreaker_connectivity(w: ByteWriter, faces, num_points):
    """Edgebreaker-compress `faces`. Writes the connectivity payload and
    returns (faces_canonical [F,3] u32, perm [num_points] i64) where
    perm[orig_point] = canonical id; the caller must permute attribute
    rows into canonical order before encoding them."""
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    nf = faces.shape[0]
    if nf == 0:
        raise NotEdgebreakerEncodable("empty mesh")
    used = np.unique(faces)
    if used.size != num_points or used.min() != 0 or used.max() != num_points - 1:
        raise NotEdgebreakerEncodable("unreferenced points")
    if num_points - (3 * nf) // 2 + nf != 2:
        raise NotEdgebreakerEncodable("Euler characteristic != 2 (holes/handles/components)")
    V, O = _build_corner_table(faces, num_points)

    visited_f = np.zeros(nf, bool)
    visited_v = np.zeros(num_points, bool)
    symbols = []
    enc_roles = []  # (tip, u, w) original ids per symbol

    seed_f = 0
    seed_c = 0
    visited_f[seed_f] = True
    for i in range(3):
        visited_v[V[3 * seed_f + i]] = True
    stack = [int(O[seed_c])]
    while stack:
        c = stack.pop()
        f = c // 3
        if visited_f[f]:
            raise NotEdgebreakerEncodable("revisited face (unexpected topology)")
        visited_f[f] = True
        t, u, wv = int(V[c]), int(V[_next(c)]), int(V[_prev(c)])
        right_c = int(O[_prev(c)])  # across edge {t, u}
        left_c = int(O[_next(c)])   # across edge {t, w}
        right_done = visited_f[right_c // 3]
        left_done = visited_f[left_c // 3]
        if not visited_v[t]:
            symbols.append(SYM_C)
            visited_v[t] = True
            stack.append(right_c)
        elif right_done and left_done:
            symbols.append(SYM_E)
        elif right_done:
            symbols.append(SYM_R)
            stack.append(left_c)
        elif left_done:
            symbols.append(SYM_L)
            stack.append(right_c)
        else:
            symbols.append(SYM_S)
            stack.append(left_c)   # left branch deferred
            stack.append(right_c)  # right branch first
        enc_roles.append((t, u, wv))
    if int(visited_f.sum()) != nf:
        raise NotEdgebreakerEncodable("traversal did not cover all faces")

    w.varint(nf)
    w.varint(num_points)
    w.varint(len(symbols))
    bits = DirectBitEncoder()
    for s in symbols:
        pat, n = _SYM_BITS[s]
        bits.put_bits(pat, n)
    bits.write(w)

    # derive the decoder's canonical numbering by decoding our own stream
    dec_faces, dec_points = _canonicalize(_reversi(symbols))
    if dec_points != num_points or len(dec_faces) != nf:
        raise DracoError("edgebreaker self-decode count mismatch")
    seed_roles = (int(V[seed_c]), int(V[_next(seed_c)]), int(V[_prev(seed_c)]))
    n = len(symbols)
    perm = np.full(num_points, -1, np.int64)
    for k in range(n + 1):
        orig = enc_roles[n - 1 - k] if k < n else seed_roles
        canon = dec_faces[k]
        for o, cn in zip(orig, canon):
            if perm[o] == -1:
                perm[o] = cn
            elif perm[o] != cn:
                raise DracoError("edgebreaker vertex correspondence broke")
    if (perm == -1).any():
        raise DracoError("edgebreaker correspondence incomplete")
    # return the faces exactly as the DECODER will produce them (canonical
    # ids, reversi face order) so prediction schemes that walk the face
    # list see identical context on both sides
    return np.asarray(dec_faces, np.uint32), perm


def decode_edgebreaker_connectivity(r: ByteReader):
    nf = r.varint()
    num_points = r.varint()
    nsym = r.varint()
    bits = DirectBitDecoder(r)
    symbols = []
    for _ in range(nsym):
        if bits.get_bits(1) == 0:
            symbols.append(SYM_C)
        else:
            symbols.append(_TWO_BITS[bits.get_bits(2)])
    faces, npts = _canonicalize(_reversi(symbols))
    if len(faces) != nf:
        raise DracoError("edgebreaker face count mismatch")
    if npts != num_points:
        raise DracoError("edgebreaker vertex count mismatch")
    return np.asarray(faces, np.uint32), num_points
