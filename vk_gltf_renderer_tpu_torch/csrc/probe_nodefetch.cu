// Node-fetch probe: the cost of one dependent row fetch, one thread per
// lane chasing a chain of 64-byte rows.
//
// Replaces the TPU probe tools/exp_nodefetch.py (mk, its pallas_call). A
// table of [R,16] f32 rows holds a next-row pointer in column 15; each
// lane starts at the row its warp is given and, for `visits` steps, reads
// the row, adds (f[1] - rox) * (f[0]+f[3]+f[6]+f[9]+f[12]+f[14]) to its
// accumulator and moves to row f[15]. Blocks of 1024 threads stand for
// the TPU probe's (8,128) packets: out[g*1024 + l] is lane l of grid step
// g. The TPU variants a-d differ only in how Mosaic extracts 16 floats
// from a 128-lane row of the same bytes; here every variant is this one
// computation over the same bytes ([R/8,128] is [R,16] reshaped). `block`
// threads per block: 1024 is the TPU layout, 32 puts one warp (one chain)
// on each SM, where nothing but the chain's own latency is left.
//
// What bounds it on the card: with one warp per SM, the latency of each
// dependent load, one round trip through L1, L2 or HBM per step, since the
// next address is in the row just read; the bytes (64 per step, the same
// row for all 32 lanes of a warp) and the 8 FLOPs per lane and step are
// negligible. In the TPU layout, 32 warps per SM share its issue and load
// throughput, which for rows in L1 costs more than the latency (PERF.md
// §6). The design does nothing to hide either, which is what the probe
// measures: the row is four 16-byte loads issued together.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 1024;  // one (8,128) packet of the TPU probe

__global__ void __launch_bounds__(kMaxBlock)
probe_nodefetch_kernel(const float* __restrict__ tab, const int* __restrict__ start,
                       const float* __restrict__ rox, int n, int visits,
                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int e = start[i >> 5];  // the chain of this warp
  const float ro = rox[i];
  float acc = 0.0f;
  for (int k = 0; k < visits; ++k) {
    const float4* r = reinterpret_cast<const float4*>(tab + static_cast<size_t>(e) * 16);
    const float4 a = __ldg(r);      // f0 f1 f2 f3
    const float4 b = __ldg(r + 1);  // f4 f5 f6 f7
    const float4 c = __ldg(r + 2);  // f8 f9 f10 f11
    const float4 d = __ldg(r + 3);  // f12 f13 f14 f15
    float s = a.x + a.w;
    s = s + b.z;
    s = s + c.y;
    s = s + d.x;
    s = s + d.z;
    acc = acc + (a.y - ro) * s;
    e = static_cast<int>(d.w);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int vkgr_probe_nodefetch(const float* tab, const int* start, const float* rox, int n,
                                    int visits, int block, float* out, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + block - 1) / block;
  probe_nodefetch_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, start, rox, n, visits, out);
  return static_cast<int>(cudaGetLastError());
}
