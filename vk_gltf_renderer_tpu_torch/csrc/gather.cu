// Small-table multi-channel gather: out[c, i] = tab[c, idx[i]].
//
// Replaces gather_channels (_gather_kernel) of
// vk_gltf_renderer_tpu/ops/pallas_gather.py. On the TPU a generic gather
// cost about 34 ns per element, so that kernel kept the table in VMEM and
// swept it in 128-wide chunks with lane shuffles. The card gathers
// natively, so this kernel is one thread per output index, looping over
// the C channels.
//
// What bounds it on the card: memory traffic. Per index it reads 4 bytes
// of idx and writes 4*C bytes of out, both coalesced; the table reads
// (<= 4 channels x 8192 floats = 128 KB for the HDR sampling map) are
// random but stay in L1/L2, read through the read-only path (__ldg). The
// design keeps every thread's accesses to idx and out contiguous across
// the warp and does no other work.
//
// An index outside [0, T) yields NaN instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
gather_channels_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                       float* __restrict__ out, int channels, int t, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = idx[i];
  const bool ok = j >= 0 && j < t;
  for (int c = 0; c < channels; ++c) {
    out[c * n + i] = ok ? __ldg(tab + static_cast<int64_t>(c) * t + j) : __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" int vkgr_gather_channels(const float* tab, const int* idx, float* out, int channels,
                                    int t, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t grid = (n + kBlock - 1) / kBlock;
  gather_channels_kernel<<<static_cast<unsigned int>(grid), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(tab, idx, out, channels, t, n);
  return static_cast<int>(cudaGetLastError());
}
