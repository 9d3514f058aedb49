// Stream-copy probe: the cost of streaming [F,128] f32 pages from device
// memory through the card's copy constructs, one page after another.
//
// Replaces the TPU probe tools/exp_stream_dma.py (_build, its pallas_call
// in run). Each block is one stream of the TPU probe's single grid step:
// for `steps` steps it fetches page p(i) of the table (F rows of 128
// floats, F = 12 or 16) and adds it element-wise into its accumulator
// acc [F,128], which it writes to out[b]. The page order is either data
// dependent, p(i) = (base + |int(sum(acc))| + 7i) % n_pages (TPU variants
// A, B, F), or regular, p(i) = (base + 7i) % n_pages (C, D, E, G), with
// base = b * stride; block 0 of a one-block launch over the TPU probe's
// 64-page table is the TPU probe itself. D and G are double buffered:
// page i+1 is requested before page i is consumed.
//
// The copy construct, the probe's question on this card:
//   ld        direct 16-byte loads into registers through L2 (__ldcg), no
//             staging; double buffering is a register prefetch of the next
//             page;
//   cp_async  every thread copies its 16-byte chunks into a shared slot
//             with cp.async.cg, commit_group, wait_group (1 when double
//             buffered), then a block barrier;
//   tma       one thread arms an mbarrier with the page's bytes
//             (expect_tx) and issues one 1-D bulk copy of the whole page
//             (cp.async.bulk ... mbarrier::complete_tx::bytes, 6,144 or
//             8,192 B, no tensor map); the block waits on the barrier's
//             phase parity.
// A staged slot is read by the whole block, as a staged node would be, so
// both staged constructs wait for the copy with the whole block, and a
// slot is overwritten only after a block barrier has followed its last
// read (the write-after-read hazard the TPU's single DMA semaphore hid).
// In the data-dependent order the block-wide sum (warp shuffles, partials
// in alternating shared buffers, one barrier) is that barrier.
//
// What bounds it on the card: one stream per block is one page in flight
// (two when double buffered), so a step costs the latency of the copy
// (an L2 or HBM round trip plus the construct's own issue and completion
// cost), plus in the data-dependent order a block reduction; the bytes
// (F*512 per step) and the F*128 adds are far below the SM's rates. That
// latency per page is what the probe measures; the design adds nothing
// to hide it beyond the TPU probe's own double buffering.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // one float4 of each 512-float row group per thread
constexpr int kLd = 0, kCpAsync = 1, kTma = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed. A copy that never
// lands traps after ~2^26 polls (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One thread: arm `bar` with the page's bytes and start its bulk copy.
__device__ __forceinline__ void tma_page(float* slot, const float* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(slot)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread: its kC 16-byte chunks of the page into the slot, one group.
template <int kC>
__device__ __forceinline__ void cp_async_page(float* slot, const float* src, int t) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int q = (c * kThreads + t) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(slot + q)),
                 "l"(src + q)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block of every thread's v; red: kThreads/32 floats, not
// written again until a later barrier (callers alternate two buffers).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < kThreads / 32 ? red[lane] : 0.0f);
}

template <int kC>
__device__ __forceinline__ void add_chunks(float4 (&acc)[kC], const float4 (&v)[kC]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    acc[c].x = acc[c].x + v[c].x;
    acc[c].y = acc[c].y + v[c].y;
    acc[c].z = acc[c].z + v[c].z;
    acc[c].w = acc[c].w + v[c].w;
  }
}

template <int kC>
__device__ __forceinline__ void load_chunks(float4 (&v)[kC], const float* src, int t) {
#pragma unroll
  for (int c = 0; c < kC; ++c) v[c] = __ldcg(reinterpret_cast<const float4*>(src) + c * kThreads + t);
}

template <int kC>
__device__ __forceinline__ void read_slot(float4 (&v)[kC], const float* slot, int t) {
#pragma unroll
  for (int c = 0; c < kC; ++c) v[c] = reinterpret_cast<const float4*>(slot)[c * kThreads + t];
}

template <int kFields, int kCopy, bool kDyn, bool kDouble>
__global__ void __launch_bounds__(kThreads)
probe_stream_dma_kernel(const float* __restrict__ tab, long long n_pages, long long stride,
                        int steps, float* __restrict__ out) {
  constexpr int kPage = kFields * 128;  // floats
  constexpr int kC = kPage / 4 / kThreads;
  constexpr uint32_t kBytes = kPage * 4;
  static_assert(!(kDyn && kDouble), "the double-buffered variants use the regular order");
  __shared__ __align__(128) float slot[kDouble ? 2 : 1][kPage];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float red[2][kThreads / 32];
  const int t = threadIdx.x;
  const long long base = blockIdx.x * stride;
  float4 acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto page_src = [&](long long h, int i) {
    return tab + ((base + h + 7LL * i) % n_pages) * kPage;
  };
  if constexpr (kCopy == kTma) {
    if (t == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  uint32_t phase = 0u;  // bit k: the parity to wait for on bar[k]
  float4 v[kC];

  if constexpr (kDouble) {
    float4 nxt[kC];
    if constexpr (kCopy == kLd) load_chunks<kC>(v, page_src(0, 0), t);
    if constexpr (kCopy == kCpAsync) cp_async_page<kC>(slot[0], page_src(0, 0), t);
    if constexpr (kCopy == kTma) {
      if (t == 0) tma_page(slot[0], page_src(0, 0), kBytes, &bar[0]);
    }
    for (int i = 0; i < steps; ++i) {
      const int cur = i & 1;
      const bool more = i + 1 < steps;
      if constexpr (kCopy == kLd) {
        if (more) load_chunks<kC>(nxt, page_src(0, i + 1), t);
        add_chunks<kC>(acc, v);
        if (more) {
#pragma unroll
          for (int c = 0; c < kC; ++c) v[c] = nxt[c];
        }
      } else {
        // slot cur ^ 1 was last read in step i - 1, before that step's closing barrier
        if constexpr (kCopy == kCpAsync) {
          if (more) {
            cp_async_page<kC>(slot[cur ^ 1], page_src(0, i + 1), t);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
        } else {
          if (more && t == 0) tma_page(slot[cur ^ 1], page_src(0, i + 1), kBytes, &bar[cur ^ 1]);
          mbar_wait(&bar[cur], (phase >> cur) & 1u);
          phase ^= 1u << cur;
        }
        read_slot<kC>(v, slot[cur], t);
        add_chunks<kC>(acc, v);
        __syncthreads();
      }
    }
  } else {
    for (int i = 0; i < steps; ++i) {
      long long h = 0;
      if constexpr (kDyn) {
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < kC; ++c) part = part + ((acc[c].x + acc[c].y) + (acc[c].z + acc[c].w));
        // integer-valued below 2**24: exact in any order (the plain version sums in another)
        const int sum = static_cast<int>(block_sum(part, red[i & 1]));
        h = sum < 0 ? -static_cast<long long>(sum) : sum;
      }
      const float* src = page_src(h, i);
      if constexpr (kCopy == kLd) {
        load_chunks<kC>(v, src, t);
      } else {
        // write after read: every thread has left the slot (block_sum's barrier when kDyn)
        if constexpr (!kDyn) __syncthreads();
        if constexpr (kCopy == kCpAsync) {
          cp_async_page<kC>(slot[0], src, t);
          cp_async_wait<0>();
          __syncthreads();
        } else {
          if (t == 0) tma_page(slot[0], src, kBytes, &bar[0]);
          mbar_wait(&bar[0], phase & 1u);
          phase ^= 1u;
        }
        read_slot<kC>(v, slot[0], t);
      }
      add_chunks<kC>(acc, v);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.x) * kPage);
#pragma unroll
  for (int c = 0; c < kC; ++c) o[c * kThreads + t] = acc[c];
}

template <int kFields, int kCopy>
cudaError_t launch_order(const float* tab, long long n_pages, long long stride, int dyn, int dbl,
                         int blocks, int steps, float* out, cudaStream_t s) {
  if (dyn) {
    probe_stream_dma_kernel<kFields, kCopy, true, false>
        <<<blocks, kThreads, 0, s>>>(tab, n_pages, stride, steps, out);
  } else if (dbl) {
    probe_stream_dma_kernel<kFields, kCopy, false, true>
        <<<blocks, kThreads, 0, s>>>(tab, n_pages, stride, steps, out);
  } else {
    probe_stream_dma_kernel<kFields, kCopy, false, false>
        <<<blocks, kThreads, 0, s>>>(tab, n_pages, stride, steps, out);
  }
  return cudaGetLastError();
}

template <int kFields>
cudaError_t launch_fields(const float* tab, long long n_pages, long long stride, int copy, int dyn,
                          int dbl, int blocks, int steps, float* out, cudaStream_t s) {
  switch (copy) {
    case kLd:
      return launch_order<kFields, kLd>(tab, n_pages, stride, dyn, dbl, blocks, steps, out, s);
    case kCpAsync:
      return launch_order<kFields, kCpAsync>(tab, n_pages, stride, dyn, dbl, blocks, steps, out, s);
    case kTma:
      return launch_order<kFields, kTma>(tab, n_pages, stride, dyn, dbl, blocks, steps, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// tab: [n_pages*fields,128] f32, 16-byte aligned; fields in {12, 16};
// copy: 0 ld, 1 cp_async, 2 tma; dyn: data-dependent order (single
// buffered); dbl: double buffered (regular order); out: [blocks,fields,128].
// Stream b starts at page b * (n_pages / blocks).
extern "C" int vkgr_probe_stream_dma(const float* tab, int n_pages, int fields, int copy, int dyn,
                                     int dbl, int blocks, int steps, float* out, void* stream) {
  if (blocks <= 0 || n_pages <= 0) return 0;
  if (dyn && dbl) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stride = n_pages / blocks;
  cudaError_t err;
  if (fields == 12) {
    err = launch_fields<12>(tab, n_pages, stride, copy, dyn, dbl, blocks, steps, out, s);
  } else if (fields == 16) {
    err = launch_fields<16>(tab, n_pages, stride, copy, dyn, dbl, blocks, steps, out, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
