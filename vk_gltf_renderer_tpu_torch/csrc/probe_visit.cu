// Visit probe: the cost of one BVH4 internal-node visit of a packet, and
// whether interleaving independent walks in one block hides it.
//
// Replaces the TPU probe tools/exp_visit.py (make_kernel, _visit, its
// pallas_call). A block of 1024 threads is one (8,128) packet of rays;
// each grid step g is one block, with ray origins ro[g,0:3,:,:]
// (inverse directions faked as o*0.5+1). A visit reads row e of the BVH4
// table fi [R,32] f32, runs the four child slab tests over every lane,
// votes any() per child over the packet, orders the four child codes by
// the three split axes (sign bits faked constant: axis > 0), pushes each
// code onto a shared-memory stack and advances the stack pointer where
// its vote (in the TPU probe's pairing) was true, caps it at 200, and
// moves to row c0 % R. The output is e + sp per grid step, broadcast over
// its 1024 lanes.
//
// Variants: a reads codes and axes from the float row (cols 24:31), b and
// c from the int32 sidecar sc [R,8] (c is b on the card: it differs from
// b only in how Mosaic broadcasts box floats). ways > 1 (TPU variants d,
// e, q: 2, 4, 8) splits the packet's rows into `ways` chains, chain w
// starting at row w with sp = w*(200/ways) and taking visits/ways steps;
// the output is the sum of every chain's e and sp.
//
// any() is a block vote of the four child bits in one barrier: a warp OR
// (__reduce_or_sync), one word per warp in shared memory (double-buffered
// so one __syncthreads per step suffices), then an OR over the chain's
// warps. The stack is written by one thread of each chain. A step is a
// dependent chain (row load, slab tests, vote and barrier, codes, next
// row), but every one of the block's 32 warps runs all of it, so what
// bounds a step on the card is the SM's issue and load throughput for
// those warps as much as the chain's latency (PERF.md §6); its bytes (160
// per visit, one row for every lane) are negligible. With ways chains the
// block's warps run `ways` such chains side by side between the same
// barriers, which is how the card interleaves walks.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr int kStack = 256;
constexpr int kSpCap = 200;

__device__ __forceinline__ unsigned slab(const float* __restrict__ f, int o, float rox, float roy,
                                         float roz, float ix, float iy, float iz, float t_best) {
  const float t0x = (__ldg(f + o + 0) - rox) * ix;
  const float t1x = (__ldg(f + o + 3) - rox) * ix;
  const float t0y = (__ldg(f + o + 1) - roy) * iy;
  const float t1y = (__ldg(f + o + 4) - roy) * iy;
  const float t0z = (__ldg(f + o + 2) - roz) * iz;
  const float t1z = (__ldg(f + o + 5) - roz) * iz;
  const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), 0.0f));
  const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), t_best));
  return tnear <= tfar ? 1u : 0u;
}

template <bool kCodesFromRow>
__global__ void __launch_bounds__(kBlock)
probe_visit_kernel(const float* __restrict__ fi, const int* __restrict__ sc,
                   const float* __restrict__ ro, int rows, int visits, int ways,
                   float* __restrict__ out) {
  __shared__ int stack[kStack];
  __shared__ unsigned votes[2][kWarps];
  __shared__ int totals[8];
  volatile int* vstack = stack;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* rg = ro + static_cast<size_t>(blockIdx.x) * 4 * kBlock;
  const float rox = rg[tid], roy = rg[kBlock + tid], roz = rg[2 * kBlock + tid];
  const float ix = rox * 0.5f + 1.0f, iy = roy * 0.5f + 1.0f, iz = roz * 0.5f + 1.0f;
  const float t_best = 1e30f;
  const int per = kBlock / ways;  // threads of one chain
  const int w = tid / per;
  const int wpc = per / 32;  // warps of one chain
  const bool leader = tid % per == 0;
  int e = ways == 1 ? 0 : w;
  int sp = ways == 1 ? 0 : w * (kSpCap / ways);
  const int steps = visits / ways;
  for (int k = 0; k < steps; ++k) {
    const float* f = fi + static_cast<size_t>(e) * 32;
    unsigned bits = 0;
    for (int s = 0; s < 4; ++s) bits |= slab(f, 6 * s, rox, roy, roz, ix, iy, iz, t_best) << s;
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) votes[k & 1][warp] = bits;
    __syncthreads();
    const unsigned any = __reduce_or_sync(0xffffffffu, votes[k & 1][w * wpc + lane % wpc]);
    int c0, c1, c2, c3, ax0, ax1, ax2;
    if constexpr (kCodesFromRow) {
      c0 = static_cast<int>(__ldg(f + 24));
      c1 = static_cast<int>(__ldg(f + 25));
      c2 = static_cast<int>(__ldg(f + 26));
      c3 = static_cast<int>(__ldg(f + 27));
      ax0 = static_cast<int>(__ldg(f + 28));
      ax1 = static_cast<int>(__ldg(f + 29));
      ax2 = static_cast<int>(__ldg(f + 30));
    } else {
      const int* r = sc + static_cast<size_t>(e) * 8;
      c0 = __ldg(r + 0);
      c1 = __ldg(r + 1);
      c2 = __ldg(r + 2);
      c3 = __ldg(r + 3);
      ax0 = __ldg(r + 4);
      ax1 = __ldg(r + 5);
      ax2 = __ldg(r + 6);
    }
    const bool s0 = ax0 > 0, s1 = ax1 > 0, s2 = ax2 > 0;
    const int ln = s1 ? c0 : c1, lf = s1 ? c1 : c0;
    const int rn = s2 ? c2 : c3, rf = s2 ? c3 : c2;
    const int order[4] = {s0 ? rf : lf, s0 ? rn : ln, s0 ? lf : rf, s0 ? ln : rn};
    const int act[4] = {static_cast<int>((any >> 1) & 1u), static_cast<int>((any >> 2) & 1u),
                        static_cast<int>((any >> 3) & 1u), static_cast<int>(any & 1u)};
    for (int q = 0; q < 4; ++q) {
      if (leader) vstack[sp] = order[q];
      sp += act[q];
    }
    sp = min(sp, kSpCap);
    e = ((c0 % rows) + rows) % rows;
  }
  float result = static_cast<float>(e + sp);
  if (ways > 1) {
    if (leader) totals[w] = e + sp;
    __syncthreads();
    int tot = 0;
    for (int q = 0; q < ways; ++q) tot += totals[q];
    result = static_cast<float>(tot);
  }
  out[static_cast<size_t>(blockIdx.x) * kBlock + tid] = result;
}

}  // namespace

// ro: [grid,4,8,128] f32 (channels 0..2 read); out: [grid,8,128] f32.
// ways in {1, 2, 4, 8}; codes_from_row: variant a.
extern "C" int vkgr_probe_visit(const float* fi, const int* sc, const float* ro, int grid, int rows,
                                int visits, int ways, int codes_from_row, float* out,
                                void* stream) {
  if (grid <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (codes_from_row) {
    probe_visit_kernel<true><<<grid, kBlock, 0, s>>>(fi, sc, ro, rows, visits, ways, out);
  } else {
    probe_visit_kernel<false><<<grid, kBlock, 0, s>>>(fi, sc, ro, rows, visits, ways, out);
  }
  return static_cast<int>(cudaGetLastError());
}
