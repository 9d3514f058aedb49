// BVH4 closest-hit / any-hit traversal, one ray per thread.
//
// Replaces the TPU kernels traverse_packets3 (_traverse3_body/_traverse3_core)
// and traverse_packets9 (_traverse9_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. Those share one traversal
// stack per 1024-ray packet and vote the near-first order per packet,
// because the TPU's scalar unit walks the tree and its vector unit tests
// 1024 rays at once. Here every thread walks its own ray: its own stack,
// near-first order from its own direction signs, and an any-hit exit at
// the first accepted hit. Results equal the packet kernels' except for
// equal-t ties, which any traversal order may resolve differently.
//
// What bounds it on the card: dependent loads. Each visit of an internal
// node is one 128-byte row of nodes4_fi (4 child boxes, 4 child codes,
// 3 split axes) and each leaf one 512-byte row of tris128 (8 triangles
// with their render-node and triangle ids). The rays diverge, so a warp
// pays for its slowest ray and fetches many distinct rows per step. The
// design keeps the arithmetic per visit small (one row, four slab tests)
// and leaves the tables (a few MB at most for the scenes of this slice)
// in L2, read through the read-only path (__ldg, 16-byte loads). The
// stack lives in local memory (64 x int32 per thread, L1-resident).
// Shared-memory staging of the top levels, persistent threads and ray
// reordering are for later measurement-driven work.
//
// Arithmetic carried over exactly from _traverse3_core (and from the
// plain torch version in ops/traverse.py): the inv() clamp, the slab test
// with tnear floored at 0 and tfar capped at t_best (missing children are
// the point box lo = hi = +3e38 and must never test as hit), the leaf
// decoding code = -e-1, row = code/16, count = code%16, Moller-Trumbore
// with the 1e-12 determinant guard and tt > tmin && tt < t_best, and the
// ids read from tris128 columns 9 and 10. min/max propagate NaN like
// torch.minimum/maximum. Built with -fmad=false so no multiply-add is
// contracted: the results match the plain version to the last bit or two.
//
// A push onto a full stack is dropped and counted in *overflow, which the
// wrapper exposes; a nonzero count is an error, never a silent truncation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStackDepth = 64;  // = ops/traverse.py STACK_DEPTH
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

__device__ __forceinline__ bool axis_sign(float axis, bool sx, bool sy, bool sz) {
  const int a = static_cast<int>(axis);
  return a == 0 ? sx : (a == 1 ? sy : sz);
}

__device__ __forceinline__ bool slab(const float* b, float ox, float oy, float oz,
                                     float ix, float iy, float iz, float t_best) {
  const float t0x = (b[0] - ox) * ix;
  const float t1x = (b[3] - ox) * ix;
  const float t0y = (b[1] - oy) * iy;
  const float t1y = (b[4] - oy) * iy;
  const float t0z = (b[2] - oz) * iz;
  const float t1z = (b[5] - oz) * iz;
  const float tnear = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)), jmax(jmin(t0z, t1z), 0.0f));
  const float tfar = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)), jmin(jmax(t0z, t1z), t_best));
  return tnear <= tfar;
}

__global__ void __launch_bounds__(kBlock)
traverse_bvh4_kernel(const float* __restrict__ nodes4_fi, const float* __restrict__ tris128,
                     int root_code,
                     const float* __restrict__ rox, const float* __restrict__ roy,
                     const float* __restrict__ roz, const float* __restrict__ rdx,
                     const float* __restrict__ rdy, const float* __restrict__ rdz,
                     const float* __restrict__ tmin, const float* __restrict__ tmax,
                     int n, int anyhit,
                     float* __restrict__ out_t, int* __restrict__ out_rnode,
                     int* __restrict__ out_tri, float* __restrict__ out_u,
                     float* __restrict__ out_v, unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float ox = rox[i], oy = roy[i], oz = roz[i];
  const float dx = rdx[i], dy = rdy[i], dz = rdz[i];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const bool sx = dx >= 0.0f, sy = dy >= 0.0f, sz = dz >= 0.0f;
  const float t_min = tmin[i];

  float t_best = tmax[i];
  float rn_best = -1.0f, tri_best = -1.0f, u_best = 0.0f, v_best = 0.0f;
  unsigned int dropped = 0;

  int stack[kStackDepth];
  stack[0] = root_code;
  int sp = 1;

  while (sp > 0) {
    const int e = stack[--sp];
    if (e < 0) {
      const int code = -e - 1;
      const int row = code / 16;
      const int cnt = code - row * 16;
      const float4* tr = reinterpret_cast<const float4*>(tris128 + static_cast<size_t>(row) * 128);
      bool stop = false;
      for (int c = 0; c < kLeafSlots && c < cnt; ++c) {
        // slot layout: v0.xyz v1.xyz v2.xyz rnode tri pad5
        const float4 a = __ldg(tr + 4 * c);
        const float4 b = __ldg(tr + 4 * c + 1);
        const float4 d = __ldg(tr + 4 * c + 2);
        const float v0x = a.x, v0y = a.y, v0z = a.z;
        const float e1x = a.w - v0x, e1y = b.x - v0y, e1z = b.y - v0z;
        const float e2x = b.z - v0x, e2y = b.w - v0y, e2z = d.x - v0z;
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok = fabsf(det) >= 1e-12f;
        const float inv_det = 1.0f / (ok ? det : 1.0f);
        const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
        const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
        const float qx = tvy * e1z - tvz * e1y;
        const float qy = tvz * e1x - tvx * e1z;
        const float qz = tvx * e1y - tvy * e1x;
        const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        if (ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > t_min && tt < t_best) {
          t_best = anyhit ? -1.0f : tt;
          rn_best = d.y;
          tri_best = d.z;
          u_best = uu;
          v_best = vv;
          if (anyhit) {
            stop = true;
            break;
          }
        }
      }
      if (stop) break;
    } else {
      float f[32];
      const float4* rp = reinterpret_cast<const float4*>(nodes4_fi + static_cast<size_t>(e) * 32);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 q = __ldg(rp + k);
        f[4 * k] = q.x;
        f[4 * k + 1] = q.y;
        f[4 * k + 2] = q.z;
        f[4 * k + 3] = q.w;
      }
      const bool a0 = slab(f + 0, ox, oy, oz, ix, iy, iz, t_best);
      const bool a1 = slab(f + 6, ox, oy, oz, ix, iy, iz, t_best);
      const bool a2 = slab(f + 12, ox, oy, oz, ix, iy, iz, t_best);
      const bool a3 = slab(f + 18, ox, oy, oz, ix, iy, iz, t_best);
      const int c0 = static_cast<int>(f[24]), c1 = static_cast<int>(f[25]);
      const int c2 = static_cast<int>(f[26]), c3 = static_cast<int>(f[27]);
      const bool s0 = axis_sign(f[28], sx, sy, sz);  // left pair nearer
      const bool s1 = axis_sign(f[29], sx, sy, sz);  // slot 0 nearer in the left pair
      const bool s2 = axis_sign(f[30], sx, sy, sz);  // slot 2 nearer in the right pair

      const int ln_id = s1 ? c0 : c1, lf_id = s1 ? c1 : c0;
      const bool ln_a = s1 ? a0 : a1, lf_a = s1 ? a1 : a0;
      const int rn_id = s2 ? c2 : c3, rf_id = s2 ? c3 : c2;
      const bool rn_a = s2 ? a2 : a3, rf_a = s2 ? a3 : a2;

      // far first, so the nearest child is on top of the stack
      const int ids[4] = {s0 ? rf_id : lf_id, s0 ? rn_id : ln_id, s0 ? lf_id : rf_id,
                          s0 ? ln_id : rn_id};
      const bool hit[4] = {s0 ? rf_a : lf_a, s0 ? rn_a : ln_a, s0 ? lf_a : rf_a,
                           s0 ? ln_a : rn_a};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (hit[k]) {
          if (sp < kStackDepth) {
            stack[sp++] = ids[k];
          } else {
            ++dropped;
          }
        }
      }
    }
  }

  out_t[i] = t_best;
  out_rnode[i] = static_cast<int>(rn_best);
  out_tri[i] = static_cast<int>(tri_best);
  out_u[i] = u_best;
  out_v[i] = v_best;
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace

extern "C" int vkgr_traverse_bvh4(const float* nodes4_fi, const float* tris128, int root_code,
                                  const float* rox, const float* roy, const float* roz,
                                  const float* rdx, const float* rdy, const float* rdz,
                                  const float* tmin, const float* tmax, int n, int anyhit,
                                  float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                  float* out_v, unsigned int* overflow, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  traverse_bvh4_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit,
      out_t, out_rnode, out_tri, out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}
