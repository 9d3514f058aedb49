// Per-ray traversal of the fused BVH row tables, shared by every traversal
// kernel, all ten on live_lanes.cuh: the whole-row BVH4 visits and leaf
// (visit and leaf: the BVH4 step below, which traverse_bvh4.cu and
// megakernel.cu walk, the v5 walk of traverse_bvh4_multipop.cu and the v8
// schedule of traverse_bvh4_leafqueue.cu, with prefetch_leaf; visit_sc and
// leaf: the walk of sidecar_walk.cuh behind traverse_bvh4_sidecar.cu (v7)
// and traverse_bvh4_split.cu (packet4)), the whole-row BVH2 visit of
// traverse_bvh2.cu (visit2, with leaf), the batched leaf<true> over the
// split tables' 64-byte tris rows of traverse_bvh2_split.cu (v1), and the
// ray/box and ray/triangle tests of traverse_bvh16.cu's group walk and
// traverse_lanes.cu. The generic one-ray-per-thread walk that the
// redesigns replaced (float2 box loads, then the codes, one triangle at a
// time in test_leaf) is no longer here: bvh4_tuning.GENERIC carries it for
// the "every element off" variants.
//
// Row layout of an arity-A table (A = 2^L children per node, 8*A floats
// per row; nodes_fi L=1, nodes4_fi L=2, nodes16_fi L=4):
//   cols 0 : 6A      A child boxes, lo.xyz hi.xyz each; a missing child is
//                    the point box lo = hi = +3e38, which the slab test
//                    below never accepts
//   cols 6A : 7A     A child codes: >= 0 row of an internal child,
//                    < 0 leaf code -(leafrow*16 + count) - 1 into tris128,
//                    missing child 0
//   cols 7A : 8A-1   the A-1 split axes of the collapsed binary subtree in
//                    level order (index (1 << depth) - 1 + path)
//   col  8A-1        pad
// nodes4_sc [M,8] i32 (v7): cols 0:4 the BVH4 row's child codes, 4:7 its
// split axes, as int32; the walk then reads only the boxes of the row.
// The split tables of packet4 have the same shapes: nodes4_f [M,32] (the
// boxes in cols 0:24; a missing child is the inverted box lo = +3e38,
// hi = -3e38 with code -1) and nodes4_i [M,8] i32, whose leaf codes
// -(first*16 + count) - 1 name rows first .. first+count-1 of
// tris [T+8,16], one triangle a 64-byte row.
// tris128 [L,128]: 8 triangles x 16 floats per leaf row (v0 v1 v2, pad,
// render node id at col 9, global triangle id at col 10).
//
// Near-first order is the reference's: per level of the collapsed
// subtree, the child on the side of the ray's direction sign along the
// stored axis is visited first (the binary builder puts the smaller
// centroid on the left). Children are pushed in the reverse of that order
// so the nearest is popped next. The Pallas kernels take the sign from a
// vote over a 1024-ray packet; here each ray uses its own, which changes
// nothing but the resolution of equal-t ties.
//
// Arithmetic carried over exactly from the Pallas bodies (and from the
// plain torch versions in ops/traverse.py): the inv() clamp, the slab test
// with tnear floored at 0 and tfar capped at t_best, Moller-Trumbore with
// the 1e-12 determinant guard and tt > tmin && tt < t_best, ids read from
// tris128 columns 9 and 10. min/max propagate NaN like torch.minimum/
// maximum. Built with -fmad=false, so no multiply-add is contracted.
//
// A push onto a full stack is dropped and counted in *overflow; a nonzero
// count is an error that the wrapper exposes, never a silent truncation.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vkgr {

constexpr int kLeafSlots = 8;
constexpr int kBlock = 128;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1e-20f ? (d >= 0.0f ? 1e30f : -1e30f) : 1.0f / d;
}

__device__ __forceinline__ bool axis_sign(int a, bool sx, bool sy, bool sz) {
  return a == 0 ? sx : (a == 1 ? sy : sz);
}

__device__ __forceinline__ bool axis_sign(float axis, bool sx, bool sy, bool sz) {
  return axis_sign(static_cast<int>(axis), sx, sy, sz);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
  bool sx, sy, sz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy, float dz,
                                        float tmin) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = inv_dir(dx);
  r.iy = inv_dir(dy);
  r.iz = inv_dir(dz);
  r.sx = dx >= 0.0f;
  r.sy = dy >= 0.0f;
  r.sz = dz >= 0.0f;
  r.tmin = tmin;
  return r;
}

__device__ __forceinline__ Ray load_ray(int i, const float* __restrict__ rox,
                                        const float* __restrict__ roy,
                                        const float* __restrict__ roz,
                                        const float* __restrict__ rdx,
                                        const float* __restrict__ rdy,
                                        const float* __restrict__ rdz,
                                        const float* __restrict__ tmin) {
  return make_ray(rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i], tmin[i]);
}

// Best hit so far. t is the best t (tmax while nothing is accepted, -1
// after an any-hit in the stack kernels); rn/tri stay f32 until stored.
struct Hit {
  float t, rn, tri, u, v;
};

// Slab test of the box lo = (x0, y0, z0), hi = (x1, y1, z1).
__device__ __forceinline__ bool slab(float x0, float y0, float z0, float x1, float y1, float z1,
                                     const Ray& r, float t_best) {
  const float t0x = (x0 - r.ox) * r.ix;
  const float t1x = (x1 - r.ox) * r.ix;
  const float t0y = (y0 - r.oy) * r.iy;
  const float t1y = (y1 - r.oy) * r.iy;
  const float t0z = (z0 - r.oz) * r.iz;
  const float t1z = (z1 - r.oz) * r.iz;
  const float tnear = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)), jmax(jmin(t0z, t1z), 0.0f));
  const float tfar = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)), jmin(jmax(t0z, t1z), t_best));
  return tnear <= tfar;
}

// Moller-Trumbore against the triangle v0 + edges e1, e2. Writes u, v, t;
// returns whether the hit is accepted (inside, tmin < t < t_best).
__device__ __forceinline__ bool triangle(float v0x, float v0y, float v0z, float e1x, float e1y,
                                         float e1z, float e2x, float e2y, float e2z, const Ray& r,
                                         float t_best, float& uu, float& vv, float& tt) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) >= 1e-12f;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > r.tmin && tt < t_best;
}

// Whole-row loads of the BVH4 tables (the BVH4 step below, the v5 walk of
// traverse_bvh4_multipop.cu, v8, and v7 and packet4 through visit_sc): a
// visit reads the row's 8 aligned float4s in one round (ld.global.nc.v4)
// and unpacks the 4 boxes, 4 codes and 3 axes from registers, instead of
// the generic walk's 12 float2 box loads followed, after the slab tests,
// by up to 7 scalar loads (or by 2 int4 loads of the int row); a leaf
// issues the loads of kTriBatch triangles before testing them, where the
// generic walk's test_leaf loaded and tested one triangle after the other.
// The arithmetic and order are the generic walk's.
constexpr int kTriBatch = 4;  // triangles whose loads a leaf issues together

// The children of one internal row in near-first order: c0 is the code
// of visit position 0 (the nearest), bit p of enter says whether the ray
// enters the child at position p.
struct Visit {
  int c0, c1, c2, c3;
  unsigned enter;
};

__device__ __forceinline__ int pick(int p, int c0, int c1, int c2, int c3) {
  return p == 0 ? c0 : (p == 1 ? c1 : (p == 2 ? c2 : c3));
}

// Child slot of visit position p of a BVH4 row, from the flip bits of its
// collapsed binary subtree (the generic walk's mapping).
__device__ __forceinline__ int slot_of(int p, unsigned flip) {
  const int hi = ((p >> 1) & 1) ^ static_cast<int>(flip & 1u);
  return hi * 2 + ((p & 1) ^ static_cast<int>((flip >> (1 + hi)) & 1u));
}

// The Visit of a BVH4 row from its slab-test bits (bit s: the ray enters
// the child in slot s), its flip bits and its codes by slot.
__device__ __forceinline__ Visit near_first(unsigned hitmask, unsigned flip, int s0, int s1, int s2,
                                            int s3) {
  Visit v;
  v.enter = 0;
  int c[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int s = slot_of(p, flip);
    c[p] = pick(s, s0, s1, s2, s3);
    v.enter |= ((hitmask >> s) & 1u) << p;
  }
  v.c0 = c[0];
  v.c1 = c[1];
  v.c2 = c[2];
  v.c3 = c[3];
  return v;
}

__device__ __forceinline__ Visit visit(const float* __restrict__ nodes, int e, const Ray& r,
                                       float t_best) {
  unsigned hitmask = 0, flip = 0;
  int s0 = 0, s1 = 0, s2 = 0, s3 = 0;  // codes by slot
  const float4* q = reinterpret_cast<const float4*>(nodes + static_cast<size_t>(e) * 32);
  const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2), q3 = __ldg(q + 3);
  const float4 q4 = __ldg(q + 4), q5 = __ldg(q + 5), q6 = __ldg(q + 6), q7 = __ldg(q + 7);
  // boxes at floats 0, 6, 12, 18 (lo.xyz hi.xyz), codes 24-27, axes 28-30
  if (slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, r, t_best)) hitmask |= 1u;
  if (slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, r, t_best)) hitmask |= 2u;
  if (slab(q3.x, q3.y, q3.z, q3.w, q4.x, q4.y, r, t_best)) hitmask |= 4u;
  if (slab(q4.z, q4.w, q5.x, q5.y, q5.z, q5.w, r, t_best)) hitmask |= 8u;
  s0 = static_cast<int>(q6.x);
  s1 = static_cast<int>(q6.y);
  s2 = static_cast<int>(q6.z);
  s3 = static_cast<int>(q6.w);
  if (!axis_sign(q7.x, r.sx, r.sy, r.sz)) flip |= 1u;
  if (!axis_sign(q7.y, r.sx, r.sy, r.sz)) flip |= 2u;
  if (!axis_sign(q7.z, r.sx, r.sy, r.sz)) flip |= 4u;
  return near_first(hitmask, flip, s0, s1, s2, s3);
}

// The same visit of a row whose codes and split axes are int32 rows of a
// second table (nodes4_sc for v7, nodes4_i for packet4): the 6 float4s of
// the row's boxes and the 2 int4s of its int row in one load round.
__device__ __forceinline__ Visit visit_sc(const float* __restrict__ nodes,
                                          const int* __restrict__ sidecar, int e, const Ray& r,
                                          float t_best) {
  unsigned hitmask = 0, flip = 0;
  const float4* box = reinterpret_cast<const float4*>(nodes + static_cast<size_t>(e) * 32);
  const int4* meta = reinterpret_cast<const int4*>(sidecar + static_cast<size_t>(e) * 8);
  const float4 b0 = __ldg(box), b1 = __ldg(box + 1), b2 = __ldg(box + 2);
  const float4 b3 = __ldg(box + 3), b4 = __ldg(box + 4), b5 = __ldg(box + 5);
  const int4 codes = __ldg(meta), axes = __ldg(meta + 1);
  if (slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, r, t_best)) hitmask |= 1u;
  if (slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, r, t_best)) hitmask |= 2u;
  if (slab(b3.x, b3.y, b3.z, b3.w, b4.x, b4.y, r, t_best)) hitmask |= 4u;
  if (slab(b4.z, b4.w, b5.x, b5.y, b5.z, b5.w, r, t_best)) hitmask |= 8u;
  if (!axis_sign(axes.x, r.sx, r.sy, r.sz)) flip |= 1u;
  if (!axis_sign(axes.y, r.sx, r.sy, r.sz)) flip |= 2u;
  if (!axis_sign(axes.z, r.sx, r.sy, r.sz)) flip |= 4u;
  return near_first(hitmask, flip, codes.x, codes.y, codes.z, codes.w);
}

// The triangles of leaf code e in slot order (strict '<': the first of
// equal t wins), kTriBatch triangles' loads issued before their tests.
// kSplit: the code is -(first*16 + count) - 1 into the per-triangle table
// tris [T+8,16] of the split walks (rows first .. first+count-1, the same
// 16-float layout as a tris128 slot without the ids; 64-byte rows, which
// need not start on a 128-byte line), and a hit records its tris row in
// h.tri; otherwise the code indexes tris128 rows and the hit takes the
// ids of the slot. Returns true when an any-hit ray was accepted.
template <bool kSplit = false>
__device__ __forceinline__ bool leaf(const float* __restrict__ tris, int e, const Ray& r,
                                     bool anyhit, Hit& h) {
  const int code = -e - 1;
  const int row = code / 16;
  const int cnt = min(code - row * 16, kLeafSlots);
  const float4* tr =
      reinterpret_cast<const float4*>(tris + static_cast<size_t>(row) * (kSplit ? 16 : 128));
  for (int c0 = 0; c0 < cnt; c0 += kTriBatch) {
    float4 a[kTriBatch], b[kTriBatch], d[kTriBatch];
#pragma unroll
    for (int k = 0; k < kTriBatch; ++k) {
      if (c0 + k < cnt) {
        a[k] = __ldg(tr + 4 * (c0 + k));
        b[k] = __ldg(tr + 4 * (c0 + k) + 1);
        d[k] = __ldg(tr + 4 * (c0 + k) + 2);
      }
    }
#pragma unroll
    for (int k = 0; k < kTriBatch; ++k) {
      if (c0 + k >= cnt) break;
      float uu, vv, tt;
      if (triangle(a[k].x, a[k].y, a[k].z, a[k].w - a[k].x, b[k].x - a[k].y, b[k].y - a[k].z,
                   b[k].z - a[k].x, b[k].w - a[k].y, d[k].x - a[k].z, r, h.t, uu, vv, tt)) {
        h.t = anyhit ? -1.0f : tt;
        if constexpr (kSplit) {
          h.tri = static_cast<float>(row + c0 + k);  // exact: the wrappers cap tris at 2^24 rows
        } else {
          h.rn = d[k].y;
          h.tri = d[k].z;
        }
        h.u = uu;
        h.v = vv;
        if (anyhit) return true;
      }
    }
  }
  return false;
}

// The children of one BVH2 row (nodes_fi: boxes 0:12, codes 12:14, split
// axis 14) in near-first order, from one load round of the row's four
// float4s: c0 is the code of visit position 0 (the nearer side along the
// split axis), bit p of enter says whether the ray enters the child at
// position p. The generic BVH2 walk's arithmetic and order (traverse_bvh2.cu).
struct Visit2 {
  int c0, c1;
  unsigned enter;
};

__device__ __forceinline__ Visit2 visit2(const float* __restrict__ nodes, int e, const Ray& r,
                                         float t_best) {
  const float4* row = reinterpret_cast<const float4*>(nodes + static_cast<size_t>(e) * 16);
  const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
  const bool h0 = slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, r, t_best);
  const bool h1 = slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, r, t_best);
  const int s0 = static_cast<int>(q3.x), s1 = static_cast<int>(q3.y);
  const bool flip = !axis_sign(q3.z, r.sx, r.sy, r.sz);  // the right child is nearer
  Visit2 v;
  v.c0 = flip ? s1 : s0;
  v.c1 = flip ? s0 : s1;
  v.enter = ((flip ? h1 : h0) ? 1u : 0u) | ((flip ? h0 : h1) ? 2u : 0u);
  return v;
}

// Hint that a row will be read soon: one prefetch per 128-byte line into
// L1, no register written, nothing waited on (the v8 schedule).
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Prefetch the lines of a leaf row that its triangle count will read
// (2 triangles of 64 bytes per line).
__device__ __forceinline__ void prefetch_leaf(const float* __restrict__ tris128, int e) {
  const int code = -e - 1;
  const int row = code / 16;
  const int cnt = code - row * 16;
  const float* base = tris128 + static_cast<size_t>(row) * 128;
  for (int l = 0; l < (cnt + 1) / 2; ++l) prefetch_l1(base + 32 * l);
}

// One step of the BVH4 walk of traverse_bvh4.cu and megakernel.cu: the
// leaf or internal row e, then the next e popped from a kStackCap-entry
// stack. A visit pushes every entered child far first, so that the nearest
// is popped next (the order and arithmetic of the generic walk before the
// redesigns, bvh4_tuning.GENERIC). Starts at e = root with sp = 0; returns
// true when the ray is done. Dropped pushes are added to `dropped`.
namespace bvh4 {

constexpr int kStackCap = 64;

__device__ __forceinline__ bool step(const float* __restrict__ nodes,
                                     const float* __restrict__ tris128, const Ray& r, bool anyhit,
                                     int* stack, int& e, int& sp, Hit& h, unsigned& dropped) {
  auto push = [&](int code) {
    if (sp < kStackCap) {
      stack[sp++] = code;
    } else {
      ++dropped;
    }
  };
  if (e < 0) {
    if (leaf(tris128, e, r, anyhit, h)) return true;
  } else {
    const Visit v = visit(nodes, e, r, h.t);
    // every entered child, far first, so that the nearest is popped next
    if (v.enter & 8u) push(v.c3);
    if (v.enter & 4u) push(v.c2);
    if (v.enter & 2u) push(v.c1);
    if (v.enter & 1u) push(v.c0);
  }
  if (sp == 0) return true;
  e = stack[--sp];
  return false;
}

}  // namespace bvh4

__device__ __forceinline__ void store_hit(int i, const Hit& h, float* __restrict__ out_t,
                                          int* __restrict__ out_rnode, int* __restrict__ out_tri,
                                          float* __restrict__ out_u, float* __restrict__ out_v) {
  out_t[i] = h.t;
  out_rnode[i] = static_cast<int>(h.rn);
  out_tri[i] = static_cast<int>(h.tri);
  out_u[i] = h.u;
  out_v[i] = h.v;
}

}  // namespace vkgr
