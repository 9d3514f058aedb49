// The reduced bounce loop in one kernel, redesigned for the H100: a
// persistent grid whose lanes each run one path at a time through all of
// its bounces (the BVH4 walk with whole-row loads, the hit / sky / albedo
// update and the regeneration of the next ray) and take the next path from
// a device cursor when theirs ends, so ray state never goes through device
// memory between bounces and no lane idles while paths remain.
//
// Replaces the TPU kernel render_mega (_mega_kernel) of
// vk_gltf_renderer_tpu/ops/megakernel.py. There one Pallas program holds a
// packet's rays in VMEM for all bounces and walks with the packet's shared
// stack; here each lane keeps its path in registers and walks with its own
// stack. The reduced path (identical in ops/megakernel.render_wavefront,
// the plain version):
//   - trace: closest hit, tmax 1e30 while the path lives;
//   - a miss adds SKY * throughput and kills the path, a hit multiplies
//     throughput by ALBEDO;
//   - before every bounce but the last, a living path moves to its hit
//     point and takes a new direction from three LCG uniforms: seed =
//     1664525 * seed + 1013904223 (mod 2^32), u = (seed >> 8) * 2^-24, the
//     cube sample 2u - 1 per axis with z pushed 0.05 away from 0, scaled
//     by 1 / sqrt(x^2 + y^2 + z^2).
// Output channel 1 is the last bounce's t, as in the reference: the hit t
// or 1e30 at the last bounce, -1 (the reference's tmax sentinel) for a path
// that died before it. A path ends when it misses or after its last bounce
// and writes its outputs then: from that bounce on the reference adds 0 to
// radiance, multiplies throughput by 1 and advances a seed nothing reads,
// so ending early changes no bit. Each output depends only on its own
// path's inputs, so the order in which lanes take paths changes nothing
// either. Built with -fmad=false and IEEE division and square root, so the
// arithmetic is the plain version's bit for bit, and the walk is
// traverse_bvh4.cu's (bvh4::step in traverse_bvh.cuh: the same order, so
// equal-t ties resolve as in the wavefront arm's traverse_bvh4 launches).
//
// What bounds it on the card: the walk's dependent row loads, as for
// traverse_bvh4. What each design element does about it (bvh4_tuning.py
// measures each one toggled; PERF.md keeps the numbers):
//  - Whole-row loads: visit and leaf of traverse_bvh.cuh.
//  - Paths of 1 to depth traces in one warp: on the terrain 92% of the
//    camera rays miss at bounce 0, so a warp that kept its 32 paths to
//    their end would run most bounces with a few lanes busy. Here a warp
//    refills by path after every bounce: the lanes whose path ended (a
//    ballot) take as many next paths with one atomicAdd of lane 0 on the
//    cursor. The grid is persistent (occupancy x SMs, live_lanes.cuh's
//    persistent_grid), so paths, not launches, fill the card.
// Every lane starts live, so there is no compaction pass.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace mega {

constexpr float kAlbedo = 0.7f;
constexpr float kSky = 1.0f;
constexpr float kFar = 1e30f;

__device__ __forceinline__ float lcg_uniform(unsigned int& seed) {
  seed = 1664525u * seed + 1013904223u;
  return static_cast<float>(static_cast<int>(seed >> 8)) * (1.0f / 16777216.0f);
}

// ro, rd: [G,4,per] (ch 3 of rd is tmin), seeds [G,1,per], out [G,2,per];
// cursor: the next path index (zeroed on the stream before the launch);
// depth >= 1.
__global__ void __launch_bounds__(kBlock)
render_mega_kernel(const float* __restrict__ nodes4_fi, const float* __restrict__ tris128,
                   int root_code, const float* __restrict__ ro, const float* __restrict__ rd,
                   const unsigned int* __restrict__ seeds, int n, int per, int depth,
                   float* __restrict__ out, unsigned int* __restrict__ overflow,
                   unsigned int* __restrict__ cursor) {
  int stack[bvh4::kStackCap];
  unsigned dropped = 0;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // the lane's path: index i (-1: none), at bounce b
  int i = -1, b = 0;
  size_t o2 = 0;  // its first output element
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, tmin = 0.0f;
  float radiance = 0.0f, throughput = 1.0f;
  unsigned int seed = 0;
  bool more = true;  // warp-uniform: the cursor may not have passed n yet
  while (true) {
    const unsigned idle = __ballot_sync(kFull, i < 0);
    if (more && idle != 0u) {  // refill: the idle lanes take the next paths
      const unsigned want = __popc(idle);
      unsigned base = 0;
      if (lane == 0) base = atomicAdd(cursor, want);
      base = __shfl_sync(kFull, base, 0);
      more = base + want < static_cast<unsigned>(n);
      const unsigned k = base + __popc(idle & below);
      if (i < 0 && k < static_cast<unsigned>(n)) {
        i = static_cast<int>(k);
        const int g = i / per;
        const int l = i - g * per;
        const size_t b4 = static_cast<size_t>(g) * 4 * per + l;
        ox = ro[b4];
        oy = ro[b4 + per];
        oz = ro[b4 + 2 * per];
        dx = rd[b4];
        dy = rd[b4 + per];
        dz = rd[b4 + 2 * per];
        tmin = rd[b4 + 3 * per];
        seed = seeds[static_cast<size_t>(g) * per + l];
        o2 = static_cast<size_t>(g) * 2 * per + l;
        radiance = 0.0f;
        throughput = 1.0f;
        b = 0;
      }
    }
    // warp-uniform; while paths remain, the refill left no lane idle
    if (!__any_sync(kFull, i >= 0)) break;
    if (i >= 0) {  // one bounce of the lane's path
      const Ray r = make_ray(ox, oy, oz, dx, dy, dz, tmin);
      Hit h{kFar, -1.0f, -1.0f, 0.0f, 0.0f};
      int e = root_code, sp = 0;
      while (!bvh4::step(nodes4_fi, tris128, r, false, stack, e, sp, h, dropped)) {
      }
      const bool last = b == depth - 1;
      if (!(h.tri >= 0.0f)) {  // a miss: sky, and the path ends
        out[o2] = radiance + kSky * throughput;
        out[o2 + per] = last ? h.t : -1.0f;
        i = -1;
      } else {
        throughput = throughput * kAlbedo;
        if (last) {
          out[o2] = radiance;
          out[o2 + per] = h.t;
          i = -1;
        } else {
          ox = ox + h.t * dx;
          oy = oy + h.t * dy;
          oz = oz + h.t * dz;
          const float u1 = lcg_uniform(seed);
          const float u2 = lcg_uniform(seed);
          const float u3 = lcg_uniform(seed);
          const float nx = 2.0f * u1 - 1.0f;
          const float ny = 2.0f * u2 - 1.0f;
          float nz = 2.0f * u3 - 1.0f;
          nz = nz + (nz >= 0.0f ? 0.05f : -0.05f);
          const float inv_len = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz);
          dx = nx * inv_len;
          dy = ny * inv_len;
          dz = nz * inv_len;
          ++b;
        }
      }
    }
  }
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace mega
}  // namespace vkgr

// scratch: one uint32, the path cursor, zeroed here on the stream. With no
// bounce (depth <= 0) every output is the reference's 0.
extern "C" int vkgr_render_mega(const float* nodes4_fi, const float* tris128, int root_code,
                                const float* ro, const float* rd, const unsigned int* seeds, int n,
                                int per, int depth, float* out, unsigned int* overflow,
                                unsigned int* scratch, void* stream) {
  using namespace vkgr::mega;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth <= 0) return static_cast<int>(cudaMemsetAsync(out, 0, 2 * sizeof(float) * n, s));
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_device[64];
  int grid = 0;
  const int rg = vkgr::persistent_grid(render_mega_kernel, per_device, n, &grid);
  if (rg != 0) return rg;
  render_mega_kernel<<<grid, vkgr::kBlock, 0, s>>>(nodes4_fi, tris128, root_code, ro, rd, seeds, n,
                                                   per, depth, out, overflow, scratch);
  return static_cast<int>(cudaGetLastError());
}
