// Micro-op probe: what one step of each of the traversal loop's building
// blocks costs an SM, in cycles and in ns.
//
// Replaces the TPU probe tools/uarch_probe.py (run, its pallas_call, and
// the eight kernels k_empty ... k_dynslice128). One block of 1024 threads
// is the TPU probe's (8,128) block: thread (s, l) = (tid / 128, tid % 128)
// holds element [s, l] of the accumulator acc, which starts as a[s, l]
// and is written to out after `iters` loop steps of one micro-op each:
//   empty        the loop alone (an empty asm hides the counter from the
//                compiler, and its final value, + 0, reaches the output);
//   vec1         acc = acc * 1.000001 + 0.5 (FMUL then FADD: -fmad=false);
//   gather       a lane gather along the row, a dependent chain: g =
//                a[s, ix]; ix = (ix + int(g)) % 128; acc += g. A row spans
//                4 warps, so a is staged in shared memory (4 KB);
//   gather12     12 independent gathers at (ix + k) % 128, summed from 0
//                in k order, then as gather;
//   reduce       a block-wide sum of acc (warp shuffles, one partial per
//                warp in alternating shared buffers, one barrier) decides
//                the counter's step, i += (r > -1) ? 1 : 2, and acc *=
//                1.000001;
//   dynslice     acc += b[node, 0] of a [R,16] table with a uniform row
//                index, node = (node + 1) % 4000: every thread loads the
//                same word (b is 256 KB, past shared memory). The index
//                does not depend on the loads, so the compiler may
//                unroll the loop and keep several loads in flight;
//   depchain     dynslice, then node = (node + 1 + int(sum(acc)) % 2) %
//                4000: load, add, block sum, barrier, next index, the
//                traversal loop's dependent shape;
//   dynslice128  acc[s, l] += b[node, l] of a [R,128] table.
// Thread 0 reads clock64() after a barrier before the loop and after one
// behind it: cycles per step next to the host's ns per step.
//
// What bounds it: the latency of each step's dependent chain (shared-load
// chain, barrier, load round trip), or the issue rate of the block's 32
// warps where the steps are independent; the bytes (the 4 KB of a and
// the table rows read) and the one or two float operations per element
// and step are far below the SM's rates. Nothing is done to hide it: the
// probe measures it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kSub = 8, kLane = 128;
constexpr int kRows = 4000;  // the TPU probe's node modulus
enum Op { kEmpty, kVec1, kGather, kGather12, kReduce, kDynslice, kDepchain, kDynslice128 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, equal in every thread (xor butterflies add the same
// pairs on every lane). red: 32 floats not written again before the next
// barrier; callers alternate two buffers.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(red[lane]);
}

template <int kOp>
__global__ void __launch_bounds__(kBlock)
probe_uarch_kernel(const float* __restrict__ a, const float* __restrict__ b, int iters,
                   float* __restrict__ out, long long* __restrict__ cycles) {
  __shared__ float a_s[kSub][kLane];
  __shared__ float red[2][32];
  const int tid = threadIdx.x;
  const int s = tid / kLane, l = tid % kLane;
  float acc = a[tid];
  a_s[s][l] = acc;
  int ix = (l * 37 + s) % kLane;
  int node = 0;
  int par = 0;
  __syncthreads();
  const long long t0 = clock64();
  int i = 0;
  while (i < iters) {
    if constexpr (kOp == kEmpty) {
      asm volatile("" : "+r"(i));
    } else if constexpr (kOp == kVec1) {
      acc = acc * 1.000001f;
      acc = acc + 0.5f;
    } else if constexpr (kOp == kGather) {
      const float g = a_s[s][ix];
      ix = (ix + static_cast<int>(g)) & (kLane - 1);  // ix + g >= 0: % 128
      acc = acc + g;
    } else if constexpr (kOp == kGather12) {
      float g = 0.0f;
#pragma unroll
      for (int k = 0; k < 12; ++k) g = g + a_s[s][(ix + k) & (kLane - 1)];
      ix = (ix + static_cast<int>(g)) & (kLane - 1);
      acc = acc + g;
    } else if constexpr (kOp == kReduce) {
      const float r = block_sum(acc, red[par]);
      par ^= 1;
      i += r > -1.0f ? 0 : 1;  // + 1 below
      acc = acc * 1.000001f;
    } else if constexpr (kOp == kDynslice) {
      acc = acc + __ldg(b + static_cast<size_t>(node) * 16);
      node = (node + 1) % kRows;
    } else if constexpr (kOp == kDepchain) {
      acc = acc + __ldg(b + static_cast<size_t>(node) * 16);
      const int r = static_cast<int>(block_sum(acc, red[par]));
      par ^= 1;
      node = (node + 1 + r % 2) % kRows;
    } else {
      acc = acc + __ldg(b + static_cast<size_t>(node) * kLane + l);
      node = (node + 1) % kRows;
    }
    ++i;
  }
  __syncthreads();
  const long long t1 = clock64();
  // the empty loop's counter reaches the output (+ 0.0f), or ptxas deletes the loop
  if constexpr (kOp == kEmpty) acc = acc + static_cast<float>(i - iters);
  out[tid] = acc;
  if (tid == 0) *cycles = t1 - t0;
}

template <int kOp>
cudaError_t launch(const float* a, const float* b, int iters, float* out, long long* cycles,
                   cudaStream_t s) {
  probe_uarch_kernel<kOp><<<1, kBlock, 0, s>>>(a, b, iters, out, cycles);
  return cudaGetLastError();
}

}  // namespace

// a: [8,128] f32; b: [>=4000,16] f32 (dynslice, depchain) or [>=4000,128]
// (dynslice128), unread by the other ops; op: the Op order above; out:
// [8,128] f32; cycles: [1] i64, SM cycles of the loop.
extern "C" int vkgr_probe_uarch(const float* a, const float* b, int op, int iters, float* out,
                                long long* cycles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (op) {
    case kEmpty: err = launch<kEmpty>(a, b, iters, out, cycles, s); break;
    case kVec1: err = launch<kVec1>(a, b, iters, out, cycles, s); break;
    case kGather: err = launch<kGather>(a, b, iters, out, cycles, s); break;
    case kGather12: err = launch<kGather12>(a, b, iters, out, cycles, s); break;
    case kReduce: err = launch<kReduce>(a, b, iters, out, cycles, s); break;
    case kDynslice: err = launch<kDynslice>(a, b, iters, out, cycles, s); break;
    case kDepchain: err = launch<kDepchain>(a, b, iters, out, cycles, s); break;
    case kDynslice128: err = launch<kDynslice128>(a, b, iters, out, cycles, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
