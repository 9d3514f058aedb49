// The reduced bounce loop in one kernel, one ray per thread: every bounce's
// BVH4 walk, the hit / sky / albedo update and the regeneration of the next
// ray run without leaving the thread, so ray state never goes through
// device memory between bounces.
//
// Replaces the TPU kernel render_mega (_mega_kernel) of
// vk_gltf_renderer_tpu/ops/megakernel.py. There one Pallas program holds a
// packet's rays in VMEM for all bounces and walks with the packet's shared
// stack; here each thread keeps its ray in registers and walks with its own
// stack (the walk of traverse_bvh.cuh, arity 4), and a lane that died stops
// walking. The reduced path (identical in ops/megakernel.render_wavefront,
// the plain version):
//   - trace: closest hit, tmax 1e30 while the lane lives;
//   - a miss adds SKY * throughput and kills the lane, a hit multiplies
//     throughput by ALBEDO;
//   - before every bounce but the last, a living lane moves to its hit
//     point and takes a new direction from three LCG uniforms: seed =
//     1664525 * seed + 1013904223 (mod 2^32), u = (seed >> 8) * 2^-24, the
//     cube sample 2u - 1 per axis with z pushed 0.05 away from 0, scaled
//     by 1 / sqrt(x^2 + y^2 + z^2). Every lane advances its seed.
// Output channel 1 is the last bounce's t, as in the reference: the hit t
// or 1e30 for a living lane, -1 (the reference's tmax sentinel) for a lane
// that was already dead. Built with -fmad=false and IEEE division and
// square root, so the arithmetic is the plain version's bit for bit.
//
// What bounds it on the card: the walk's dependent row loads, as for
// traverse_bvh4; the loop removes the per-bounce launches and the device
// memory round trips of ray state, which is what the A/B against
// render_wavefront measures. Launched with one thread per ray and the
// dead lanes idle, so a warp pays for its longest path.

#include "traverse_bvh.cuh"

namespace vkgr {

constexpr float kAlbedo = 0.7f;
constexpr float kSky = 1.0f;
constexpr float kFar = 1e30f;

__device__ __forceinline__ float lcg_uniform(unsigned int& seed) {
  seed = 1664525u * seed + 1013904223u;
  return static_cast<float>(static_cast<int>(seed >> 8)) * (1.0f / 16777216.0f);
}

// ro, rd: [G,4,per] (ch 3 of rd is tmin), seeds [G,1,per], out [G,2,per].
__global__ void __launch_bounds__(kBlock)
render_mega_kernel(const float* __restrict__ nodes4_fi, const float* __restrict__ tris128,
                   int root_code, const float* __restrict__ ro, const float* __restrict__ rd,
                   const unsigned int* __restrict__ seeds, int n, int per, int depth,
                   float* __restrict__ out, unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = i / per;
  const int l = i - g * per;
  const size_t b4 = static_cast<size_t>(g) * 4 * per + l;
  float ox = ro[b4], oy = ro[b4 + per], oz = ro[b4 + 2 * per];
  float dx = rd[b4], dy = rd[b4 + per], dz = rd[b4 + 2 * per];
  const float tmin = rd[b4 + 3 * per];
  unsigned int seed = seeds[static_cast<size_t>(g) * per + l];
  bool alive = true;
  float radiance = 0.0f, throughput = 1.0f, t = 0.0f;
  unsigned int dropped = 0;

  for (int b = 0; b < depth; ++b) {
    bool hit = false;
    if (alive) {
      const Ray r = make_ray(ox, oy, oz, dx, dy, dz, tmin);
      const Hit h = walk<2, 64>(nodes4_fi, tris128, root_code, r, kFar, false, dropped);
      t = h.t;
      hit = h.tri >= 0.0f;
    } else {
      t = -1.0f;
    }
    radiance = radiance + ((alive && !hit) ? kSky : 0.0f) * throughput;
    alive = alive && hit;
    throughput = throughput * (alive ? kAlbedo : 1.0f);
    if (b < depth - 1) {
      if (alive) {
        ox = ox + t * dx;
        oy = oy + t * dy;
        oz = oz + t * dz;
      }
      const float u1 = lcg_uniform(seed);
      const float u2 = lcg_uniform(seed);
      const float u3 = lcg_uniform(seed);
      const float nx = 2.0f * u1 - 1.0f;
      const float ny = 2.0f * u2 - 1.0f;
      float nz = 2.0f * u3 - 1.0f;
      nz = nz + (nz >= 0.0f ? 0.05f : -0.05f);
      const float inv_len = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz);
      if (alive) {
        dx = nx * inv_len;
        dy = ny * inv_len;
        dz = nz * inv_len;
      }
    }
  }

  const size_t b2 = static_cast<size_t>(g) * 2 * per + l;
  out[b2] = radiance;
  out[b2 + per] = t;
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace vkgr

extern "C" int vkgr_render_mega(const float* nodes4_fi, const float* tris128, int root_code,
                                const float* ro, const float* rd, const unsigned int* seeds, int n,
                                int per, int depth, float* out, unsigned int* overflow,
                                void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  vkgr::render_mega_kernel<<<grid, vkgr::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes4_fi, tris128, root_code, ro, rd, seeds, n, per, depth, out, overflow);
  return static_cast<int>(cudaGetLastError());
}
