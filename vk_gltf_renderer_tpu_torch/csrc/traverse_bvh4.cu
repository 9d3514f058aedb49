// BVH4 closest-hit / any-hit traversal over nodes4_fi [M,32] + tris128, the
// renderer's default kernel (values v3, v9, v9x4, v9x8), redesigned for the
// H100: live-lane compaction, persistent warps, whole-row loads and
// any-hit as a template parameter.
//
// Replaces the TPU kernels traverse_packets3 (_traverse3_body/_traverse3_core)
// and traverse_packets9 (_traverse9_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. Those share one stack per
// 1024-ray packet and vote the near-first order per packet, because the
// TPU's scalar unit walks the tree and its vector unit tests 1024 rays at
// once. Here every thread walks its own ray with the walk of
// traverse_bvh.cuh: its own stack, near-first order from its own direction
// signs, the same slab and Moller-Trumbore arithmetic (-fmad=false), and an
// any-hit exit at the first accepted hit. Every output equals the v7 walk's
// (traverse_bvh4_sidecar.cu, the one-ray-per-thread design this replaces)
// bit for bit on every lane; against the packet kernels only equal-t ties
// may differ.
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - Dead lanes and divergence. The renderer traces every pixel's lane in
//    every launch and marks finished paths with tmax = -1 (or NaN), so
//    after the first bounce 0.001-7% of the lanes are live, and a
//    one-ray-per-thread grid runs almost every warp for a single ray.
//    compact_lanes writes a dead lane's result (tmax, -1, -1, 0, 0) with
//    coalesced stores and without reading its ray, and appends the live
//    lanes to a work list (a warp ballot, one atomic per block, so a
//    block's live lanes stay together and in lane order). A persistent
//    grid (occupancy x SMs) walks the list: each warp takes entries with
//    one atomicAdd of lane 0 and a shuffle and walks them until all are
//    done before it takes more (while-while). It takes 32 at a time while
//    the list is long and ceil(live / warps) when it is short, so that a
//    launch with a few hundred live lanes gives each warp a few rays
//    instead of packing them into one divergent warp. The live count stays
//    on the device.
//    Only a lane with !(tmax >= 0) is dead: the root's slab test caps tfar
//    at tmax < 0 <= tnear (or NaN) and enters nothing, which is the rule of
//    the plain version (ops/traverse.py). With a leaf root a triangle with
//    tmin < t < tmax < 0 could still be accepted, so there the lane must
//    also have !(tmin < tmax).
//  - Dependent row fetches. A visit reads the row's 8 aligned float4s in
//    one round (ld.global.nc.v4) and unpacks the 4 boxes, 4 codes and 3
//    axes from registers, instead of 12 float2 box loads followed, after
//    the slab tests, by up to 7 scalar loads; a leaf issues the loads of
//    kTriBatch triangles before testing them. This doubles the walk's
//    registers, which halves the warps an SM holds; a smaller batch or a
//    register cap measured slower.
//  - Stack traffic. The walk pushes every entered child far first and pops
//    the nearest, into a 64-entry stack in local memory (L1). Descending
//    straight into the nearest child (kept in a register) and a stack in
//    shared memory each measured a little slower. A push onto a full stack
//    is dropped and counted in *overflow, never silently.
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.

#include "traverse_bvh.cuh"

namespace vkgr {
namespace bvh4 {

constexpr int kStackCap = 64;
constexpr int kTriBatch = 4;  // triangles whose loads a leaf issues together
constexpr int kCompactBlock = 512;
constexpr int kWarps = kBlock / 32;
constexpr int kScratchHeader = 4;  // live count, work cursor, pad (the list starts 16 bytes in)
constexpr unsigned kFull = 0xffffffffu;

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
// collapsed binary subtree (expand_node's mapping in traverse_bvh.cuh).
__device__ __forceinline__ int slot_of(int p, unsigned flip) {
  const int hi = ((p >> 1) & 1) ^ static_cast<int>(flip & 1u);
  return hi * 2 + ((p & 1) ^ static_cast<int>((flip >> (1 + hi)) & 1u));
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

// The triangles of leaf code e in slot order, kTriBatch triangles' loads
// issued before their tests (test_leaf's arithmetic and acceptance).
// Returns true when an any-hit ray was accepted.
__device__ __forceinline__ bool leaf(const float* __restrict__ tris128, int e, const Ray& r,
                                     bool anyhit, Hit& h) {
  const int code = -e - 1;
  const int row = code / 16;
  const int cnt = min(code - row * 16, kLeafSlots);
  const float4* tr = reinterpret_cast<const float4*>(tris128 + static_cast<size_t>(row) * 128);
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
        h.rn = d[k].y;
        h.tri = d[k].z;
        h.u = uu;
        h.v = vv;
        if (anyhit) return true;
      }
    }
  }
  return false;
}

// One step of a ray's walk (the order and arithmetic of walk<2, ...> in
// traverse_bvh.cuh): the leaf or internal row e, then the next e popped
// from the stack. Starts at e = root with sp = 0; returns true when the
// ray is done. Dropped pushes are added to `dropped`.
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

// Dead lanes get their result; live lanes go to list[0 .. header[0]), a
// block's in lane order (one atomic per block).
__global__ void __launch_bounds__(kCompactBlock)
compact_lanes(const float* __restrict__ tmin, const float* __restrict__ tmax, int n, int root,
              float* __restrict__ out_t, int* __restrict__ out_rnode, int* __restrict__ out_tri,
              float* __restrict__ out_u, float* __restrict__ out_v, int* __restrict__ header,
              int* __restrict__ list) {
  __shared__ int warp_base[kCompactBlock / 32];
  __shared__ int block_base;
  const int i = blockIdx.x * kCompactBlock + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool live = false;
  if (i < n) {
    const float tm = tmax[i];
    live = tm >= 0.0f || (root < 0 && tmin[i] < tm);
    if (!live) {
      out_t[i] = tm;
      out_rnode[i] = -1;
      out_tri[i] = -1;
      out_u[i] = 0.0f;
      out_v[i] = 0.0f;
    }
  }
  const unsigned ballot = __ballot_sync(kFull, live);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kCompactBlock / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total ? atomicAdd(header, total) : 0;
  }
  __syncthreads();
  if (live) list[block_base + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = i;
}

// The persistent walk of the list: each warp takes up to `per` entries
// with one atomicAdd of lane 0 and a shuffle, walks them to their end and
// takes more until the list is done.
template <bool kAny>
__global__ void __launch_bounds__(kBlock)
walk_kernel(const float* __restrict__ nodes, const float* __restrict__ tris128, int root,
            const float* __restrict__ rox, const float* __restrict__ roy,
            const float* __restrict__ roz, const float* __restrict__ rdx,
            const float* __restrict__ rdy, const float* __restrict__ rdz,
            const float* __restrict__ tmin, const float* __restrict__ tmax,
            float* __restrict__ out_t, int* __restrict__ out_rnode, int* __restrict__ out_tri,
            float* __restrict__ out_u, float* __restrict__ out_v,
            unsigned int* __restrict__ overflow, int* __restrict__ header,
            const int* __restrict__ list) {
  const int count = header[0];  // final: compact_lanes ran before on this stream
  // 32 entries a fetch while the list is long, fewer when it is short
  const int warps = gridDim.x * kWarps;
  const int per = min(32, max(1, (count + warps - 1) / warps));
  const int lane = threadIdx.x & 31;
  int stack[kStackCap];
  unsigned dropped = 0;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(header + 1, per);
    base = __shfl_sync(kFull, base, 0);
    if (base >= count) break;  // warp-uniform: the list is done
    if (lane < per && base + lane < count) {
      const int i = list[base + lane];
      const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
      Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
      int e = root, sp = 0;
      while (!step(nodes, tris128, r, kAny, stack, e, sp, h, dropped)) {
      }
      store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
    }
  }
  if (dropped) atomicAdd(overflow, dropped);
}

// Blocks of the persistent grid: as many as fit on every SM at once (one
// query per instance and device), and no more than the lanes need.
template <bool kAny>
int persistent_grid(int n, int* grid) {
  static int per_device[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_kernel<kAny>, kBlock, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    per_device[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int need = (n + kBlock - 1) / kBlock;
  *grid = per_device[dev] < need ? per_device[dev] : need;
  return 0;
}

template <bool kAny>
int launch(const float* nodes, const float* tris128, int root, const float* rox, const float* roy,
           const float* roz, const float* rdx, const float* rdy, const float* rdz,
           const float* tmin, const float* tmax, int n, float* out_t, int* out_rnode,
           int* out_tri, float* out_u, float* out_v, unsigned int* overflow, int* scratch,
           cudaStream_t stream) {
  int* list = scratch + kScratchHeader;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_lanes<<<(n + kCompactBlock - 1) / kCompactBlock, kCompactBlock, 0, stream>>>(
      tmin, tmax, n, root, out_t, out_rnode, out_tri, out_u, out_v, scratch, list);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  const int rc = persistent_grid<kAny>(n, &grid);
  if (rc != 0) return rc;
  walk_kernel<kAny><<<grid, kBlock, 0, stream>>>(nodes, tris128, root, rox, roy, roz, rdx, rdy,
                                                 rdz, tmin, tmax, out_t, out_rnode, out_tri,
                                                 out_u, out_v, overflow, scratch, list);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bvh4
}  // namespace vkgr

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_bvh4(const float* nodes4_fi, const float* tris128, int root_code,
                                  const float* rox, const float* roy, const float* roz,
                                  const float* rdx, const float* rdy, const float* rdz,
                                  const float* tmin, const float* tmax, int n, int anyhit,
                                  float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                  float* out_v, unsigned int* overflow, int* scratch,
                                  void* stream) {
  using namespace vkgr::bvh4;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                        n, out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
  }
  return launch<false>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                       out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
}
