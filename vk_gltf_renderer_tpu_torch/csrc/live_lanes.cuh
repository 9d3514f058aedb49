// Live-lane compaction and the persistent walk of the listed lanes, shared
// by the eight kernels that take the renderer's launches: traverse_bvh4.cu
// (v3/v9), traverse_lanes.cu (the lane walk), traverse_bvh4_multipop.cu
// (v5), traverse_bvh2.cu (v2), traverse_bvh16.cu (v6),
// traverse_bvh4_leafqueue.cu (v8), and traverse_bvh4_sidecar.cu (v7) and
// traverse_bvh4_split.cu (packet4) through sidecar_walk.cuh; by
// traverse_bvh2_split.cu (v1), which only intersect_rays_packet(v2=False)
// launches; and megakernel.cu, whose every lane starts live, takes only its
// persistent grid: ten kernels in all.
//
// The renderer traces every pixel's lane in every launch and marks
// finished paths with tmax = -1, so after the first bounce 0.001-7% of the
// lanes are live, and a grid of one thread per lane runs almost every warp
// for a single ray. compact_lanes writes a dead lane's result (tmax, -1,
// -1, 0, 0) with coalesced stores and without reading its ray, and appends
// the live lanes to a work list (a warp ballot, one atomic per block, so a
// block's live lanes stay together and in lane order). A persistent grid
// (occupancy x SMs) walks the list: each warp takes entries with one
// atomicAdd of lane 0 and a shuffle and walks them until all are done
// before it takes more (while-while). It takes a warp's worth at a time
// while the list is long and ceil(live / warps) when it is short, so that
// a launch with a few hundred live lanes gives each warp a few rays
// instead of packing them into one divergent warp. The live count stays on
// the device.
//
// A lane is dead only where its walk returns (tmax, -1, -1, 0, 0) whatever
// its other inputs: !(tmax >= 0), and where the caller's root is a leaf
// (root < 0) also !(tmin < tmax); each kernel says why this holds for its
// walk.
//
// Scratch (the wrappers' scratch_words(n) int32): kScratchHeader words (the
// live count, the work cursor, pad: the list starts 16 bytes in), then the
// list of at most n live lanes.

#pragma once

#include <cuda_runtime.h>

#include "traverse_bvh.cuh"

namespace vkgr {

constexpr int kCompactBlock = 512;
constexpr int kScratchHeader = 4;
constexpr unsigned kFull = 0xffffffffu;

namespace {  // one copy per translation unit: a kernel's variant may edit it

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

// Zero the live count and the work cursor of scratch, then compact the
// lanes into its list, on `stream`.
int begin_list(const float* tmin, const float* tmax, int n, int root, float* out_t, int* out_rnode,
               int* out_tri, float* out_u, float* out_v, int* scratch, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_lanes<<<(n + kCompactBlock - 1) / kCompactBlock, kCompactBlock, 0, stream>>>(
      tmin, tmax, n, root, out_t, out_rnode, out_tri, out_u, out_v, scratch,
      scratch + kScratchHeader);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The persistent walk of the list by groups of kGroup threads, one listed
// lane a group: each warp takes up to per <= 32 / kGroup entries with one
// atomicAdd of lane 0 and a shuffle, and the threads of group s call
// body(list[base + s]) for s < per; then it takes more until the list is
// done. A group's threads call body together.
template <int kGroup, typename Body>
__device__ __forceinline__ void walk_list(int* __restrict__ header, const int* __restrict__ list,
                                          Body&& body) {
  static_assert(kGroup >= 1 && kGroup <= 32 && (32 % kGroup) == 0, "groups tile a warp");
  const int count = header[0];  // final: compact_lanes ran before on this stream
  // a warp's worth of entries a fetch while the list is long, fewer when it is short
  const int warps = gridDim.x * (blockDim.x / 32);
  const int per = min(32 / kGroup, max(1, (count + warps - 1) / warps));
  const int lane = threadIdx.x & 31;
  const int slot = lane / kGroup;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(header + 1, per);
    base = __shfl_sync(kFull, base, 0);
    if (base >= count) break;  // warp-uniform: the list is done
    if (slot < per && base + slot < count) body(list[base + slot]);
  }
}

// Blocks of kBlock threads of the persistent walk `kernel`: as many as fit
// on every SM at once (per_device caches one query per device; each
// caller keeps its own), and no more than `threads` need.
template <typename Kernel>
int persistent_grid(Kernel kernel, int* per_device, long long threads, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    per_device[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long need = (threads + kBlock - 1) / kBlock;
  *grid = per_device[dev] < need ? per_device[dev] : static_cast<int>(need);
  return 0;
}

}  // namespace vkgr
