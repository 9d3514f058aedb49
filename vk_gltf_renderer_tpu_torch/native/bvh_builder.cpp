// Native BVH build core: Morton codes + radix sort + Karras 2012 radix tree.
//
// The runtime role nvvk::AccelerationStructureBuilder plays in the reference
// (BLAS/TLAS construction, gltf_scene_rtx.cpp) — here as a host-side C++
// library the Python layer calls through ctypes. The Python/numpy
// implementation (ops/bvh.py) remains the reference oracle and fallback;
// this exists because scene (re)builds sit on the interactive path (load,
// geometry edits) and million-triangle scenes want native speed + threads.
//
// Exported C ABI:
//   vkgr_build_radix_tree(n, tlo, thi, cen,          // [n,3] f32 each
//                         order,                      // out [n]   i32
//                         left, right, leaf_l, leaf_r)// out [n-1] i32/u8
// Children index leaves (sorted positions) when the flag is set, else
// internal nodes. Returns 0 on success.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline uint64_t expand_bits_10(uint64_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

inline uint64_t morton3d(float x, float y, float z) {
  auto q = [](float f) {
    float c = f * 1024.0f;
    if (c < 0) c = 0;
    if (c > 1023.0f) c = 1023.0f;
    return (uint64_t)c;
  };
  return (expand_bits_10(q(x)) << 2) | (expand_bits_10(q(y)) << 1) | expand_bits_10(q(z));
}

inline int clz64(uint64_t x) { return x ? __builtin_clzll(x) : 64; }

struct Tree {
  const uint64_t* keys;
  int64_t n;
  int delta(int64_t i, int64_t j) const {
    if (j < 0 || j >= n) return -1;
    return clz64(keys[i] ^ keys[j]);
  }
};

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  unsigned nt = (n < 4096) ? 1 : std::min<unsigned>(hw, 16);
  if (nt == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    int64_t a = t * chunk, b = std::min<int64_t>(n, a + chunk);
    if (a >= b) break;
    ts.emplace_back([&, a, b] { fn(a, b); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" int vkgr_build_radix_tree(
    int64_t n,
    const float* tlo, const float* thi, const float* cen,
    int32_t* order_out,
    int32_t* left, int32_t* right,
    uint8_t* leaf_l, uint8_t* leaf_r) {
  if (n <= 0) return 1;

  // scene bounds over centroids (for morton quantization)
  float lo[3] = {cen[0], cen[1], cen[2]};
  float hi[3] = {cen[0], cen[1], cen[2]};
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      float v = cen[i * 3 + k];
      if (v < lo[k]) lo[k] = v;
      if (v > hi[k]) hi[k] = v;
    }
  float ext[3];
  for (int k = 0; k < 3; ++k) {
    ext[k] = hi[k] - lo[k];
    if (ext[k] < 1e-12f) ext[k] = 1e-12f;
  }

  // morton keys (parallel)
  std::vector<std::pair<uint64_t, int32_t>> tagged(n);
  parallel_for(n, [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      float x = (cen[i * 3 + 0] - lo[0]) / ext[0];
      float y = (cen[i * 3 + 1] - lo[1]) / ext[1];
      float z = (cen[i * 3 + 2] - lo[2]) / ext[2];
      tagged[i] = {morton3d(x, y, z), (int32_t)i};
    }
  });
  std::sort(tagged.begin(), tagged.end());

  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    order_out[i] = tagged[i].second;
    keys[i] = (tagged[i].first << 32) | (uint64_t)i;  // unique keys
  }
  if (n == 1) return 0;

  Tree tr{keys.data(), n};

  // Karras: one pass per internal node, fully parallel
  parallel_for(n - 1, [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      int d = (tr.delta(i, i + 1) - tr.delta(i, i - 1)) >= 0 ? 1 : -1;
      int dmin = tr.delta(i, i - d);
      int64_t lmax = 2;
      while (tr.delta(i, i + lmax * d) > dmin) lmax <<= 1;
      int64_t l = 0;
      for (int64_t t = lmax >> 1; t >= 1; t >>= 1)
        if (tr.delta(i, i + (l + t) * d) > dmin) l += t;
      int64_t j = i + l * d;
      int dnode = tr.delta(i, j);
      int64_t s = 0;
      int64_t div = 2;
      for (int64_t t = (l + 1) / 2;; t = (l + div - 1) / div) {
        if (t > 0 && tr.delta(i, i + (s + t) * d) > dnode) s += t;
        if (t <= 1) break;
        div <<= 1;
      }
      int64_t gamma = i + s * d + std::min<int64_t>(d, 0);
      int64_t lo_ij = std::min(i, j), hi_ij = std::max(i, j);
      left[i] = (int32_t)gamma;
      right[i] = (int32_t)(gamma + 1);
      leaf_l[i] = lo_ij == gamma;
      leaf_r[i] = hi_ij == gamma + 1;
    }
  });
  return 0;
}

extern "C" const char* vkgr_version() { return "vkgr-native-bvh 1.0"; }

// ---------------------------------------------------------------------------
// Binned SAH top-down build (Wald 2007-style), producing the final flattened
// node arrays the Pallas packet kernel consumes (ops/bvh_flatten.py layout):
//   nodes_i [nn,8] i32: left,right,first,count,parent,axis,0,0
//   nodes_f [nn,16] f32: both child AABBs (internal nodes only)
//   nodes_self [nn,8] f32: own AABB
//   perm [n] i32: triangle order (leaf ranges contiguous)
// Same contract as ops/bvh_flatten._build_sah (the numpy oracle); near-child
// rule: LEFT child has the smaller centroid along the stored split axis.

namespace {

struct Box {
  float lo[3] = {3e38f, 3e38f, 3e38f};
  float hi[3] = {-3e38f, -3e38f, -3e38f};
  void grow(const float* l, const float* h) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], l[k]);
      hi[k] = std::max(hi[k], h[k]);
    }
  }
  void grow(const Box& b) { grow(b.lo, b.hi); }
  float half_area() const {
    float dx = std::max(hi[0] - lo[0], 0.0f);
    float dy = std::max(hi[1] - lo[1], 0.0f);
    float dz = std::max(hi[2] - lo[2], 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

constexpr int kSahBins = 16;

struct SahCtx {
  const float* tlo;
  const float* thi;
  const float* cen;
  int leaf_size;
  int32_t* perm;
  int32_t* nodes_i;   // [cap, 8]
  float* nodes_f;     // [cap, 16]
  float* nodes_self;  // [cap, 8]
  std::atomic<int64_t> nn{0};
  int64_t cap = 0;
  std::atomic<bool> overflow{false};
};

int64_t sah_alloc(SahCtx& c) {
  int64_t id = c.nn.fetch_add(1);
  if (id >= c.cap) {
    c.overflow.store(true);
    return c.cap - 1;  // scribble the last slot; caller aborts on overflow
  }
  return id;
}

// Builds the subtree over perm[s,e) into node `nid`; returns own box.
Box sah_build(SahCtx& c, int64_t nid, int64_t s, int64_t e, int depth) {
  int32_t* ni = c.nodes_i + nid * 8;
  float* ns = c.nodes_self + nid * 8;
  Box own;
  for (int64_t i = s; i < e; ++i) {
    int64_t t = c.perm[i];
    own.grow(c.tlo + 3 * t, c.thi + 3 * t);
  }
  int64_t n = e - s;
  for (int k = 0; k < 3; ++k) {
    ns[k] = own.lo[k];
    ns[3 + k] = own.hi[k];
  }
  if (n <= c.leaf_size) {
    ni[2] = (int32_t)s;
    ni[3] = (int32_t)n;
    ni[5] = 0;
    return own;
  }
  // centroid bounds
  float clo[3] = {3e38f, 3e38f, 3e38f}, chi[3] = {-3e38f, -3e38f, -3e38f};
  for (int64_t i = s; i < e; ++i) {
    const float* cc = c.cen + 3 * c.perm[i];
    for (int k = 0; k < 3; ++k) {
      clo[k] = std::min(clo[k], cc[k]);
      chi[k] = std::max(chi[k], cc[k]);
    }
  }
  int best_axis = -1, best_split = -1;
  float best_cost = 3e38f;
  for (int axis = 0; axis < 3; ++axis) {
    float ext = chi[axis] - clo[axis];
    if (ext <= 1e-12f) continue;
    float scale = kSahBins / ext;
    Box bbox[kSahBins];
    int64_t bcnt[kSahBins] = {0};
    for (int64_t i = s; i < e; ++i) {
      int64_t t = c.perm[i];
      int b = (int)((c.cen[3 * t + axis] - clo[axis]) * scale);
      if (b >= kSahBins) b = kSahBins - 1;
      bbox[b].grow(c.tlo + 3 * t, c.thi + 3 * t);
      bcnt[b]++;
    }
    Box right[kSahBins];
    right[kSahBins - 1] = bbox[kSahBins - 1];
    for (int b = kSahBins - 2; b >= 0; --b) {
      right[b] = right[b + 1];
      right[b].grow(bbox[b]);
    }
    Box left;
    int64_t lc = 0;
    for (int b = 0; b < kSahBins - 1; ++b) {
      left.grow(bbox[b]);
      lc += bcnt[b];
      int64_t rc = n - lc;
      if (lc == 0 || rc == 0) continue;
      float cost = left.half_area() * lc + right[b + 1].half_area() * rc;
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_split = b;
      }
    }
  }
  int64_t mid;
  int axis_out = 0;
  if (best_axis < 0) {
    mid = s + n / 2;  // degenerate centroids: median split
  } else {
    float scale = kSahBins / (chi[best_axis] - clo[best_axis]);
    int32_t* lo_p = c.perm + s;
    int32_t* hi_p = c.perm + e;
    lo_p = std::partition(lo_p, hi_p, [&](int32_t t) {
      int b = (int)((c.cen[3 * t + best_axis] - clo[best_axis]) * scale);
      if (b >= kSahBins) b = kSahBins - 1;
      return b <= best_split;
    });
    mid = lo_p - c.perm;
    axis_out = best_axis;
    if (mid == s || mid == e) mid = s + n / 2;  // SAH refused; force median
  }
  int64_t l_id = sah_alloc(c);
  int64_t r_id = sah_alloc(c);
  if (c.overflow.load()) return own;
  Box lb, rb;
  if (n > 32768 && depth < 4) {  // parallel subtree builds near the top
    std::thread tl([&] { lb = sah_build(c, l_id, s, mid, depth + 1); });
    rb = sah_build(c, r_id, mid, e, depth + 1);
    tl.join();
  } else {
    lb = sah_build(c, l_id, s, mid, depth + 1);
    rb = sah_build(c, r_id, mid, e, depth + 1);
  }
  // near-child rule: left = smaller centroid along split axis
  float cl = (lb.lo[axis_out] + lb.hi[axis_out]) * 0.5f;
  float cr = (rb.lo[axis_out] + rb.hi[axis_out]) * 0.5f;
  if (cr < cl) {
    std::swap(l_id, r_id);
    std::swap(lb, rb);
  }
  ni[0] = (int32_t)l_id;
  ni[1] = (int32_t)r_id;
  ni[2] = 0;
  ni[3] = 0;
  ni[5] = axis_out;
  float* nf = c.nodes_f + nid * 16;
  for (int k = 0; k < 3; ++k) {
    nf[k] = lb.lo[k];
    nf[3 + k] = lb.hi[k];
    nf[6 + k] = rb.lo[k];
    nf[9 + k] = rb.hi[k];
  }
  c.nodes_i[l_id * 8 + 4] = (int32_t)nid;
  c.nodes_i[r_id * 8 + 4] = (int32_t)nid;
  return own;
}

}  // namespace

extern "C" int vkgr_build_sah(int64_t n, const float* tlo, const float* thi,
                              const float* cen, int32_t leaf_size,
                              int32_t* perm, int32_t* nodes_i, float* nodes_f,
                              float* nodes_self, int64_t* out_nn) {
  if (n < 1) return 1;
  SahCtx c;
  c.tlo = tlo;
  c.thi = thi;
  c.cen = cen;
  c.leaf_size = leaf_size;
  c.perm = perm;
  c.nodes_i = nodes_i;
  c.nodes_f = nodes_f;
  c.nodes_self = nodes_self;
  c.cap = 2 * n;  // caller allocates [2n, ...]; true max is 2n-1
  for (int64_t i = 0; i < n; ++i) perm[i] = (int32_t)i;
  std::memset(nodes_i, 0, sizeof(int32_t) * 8 * c.cap);
  int64_t root = sah_alloc(c);
  c.nodes_i[root * 8 + 4] = -1;
  sah_build(c, root, 0, n, 0);
  if (c.overflow.load()) return 2;
  *out_nn = c.nn.load();
  return 0;
}
