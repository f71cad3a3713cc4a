// Multi-tensor SGD update for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/kernels/multi_sgd.py:
//   sgd_kernel      (:107-114, pallas_call at :138)
//     w' = w - lr_t * (c(g) + wd_t * w)
//   sgd_mom_kernel  (:116-126, pallas_call at :142)
//     m' = mu * m - lr_t * (c(g) + wd_t * w),  w' = w + m'
// with c(g) = g * rescale, then clipped to [-clip, clip] only when
// clip > 0; lr_t and wd_t per tensor.  fp32 in and out, arithmetic in
// fp32.  Each product and sum is rounded on its own (__fmul_rn /
// __fadd_rn / __fsub_rn: no FMA contraction), in the order written above,
// so the kernel gives the plain PyTorch version's bits.  A NaN gradient
// stays NaN through the clip.
//
// Bound.  One pass over memory: sgd reads w, g and writes w (12 bytes per
// element), sgd_mom reads w, g, m and writes w, m (20 bytes); 4 or 6
// flops per element, far below the card's 20 flops per byte, so bytes
// over 3.35 TB/s bound it.  ResNet-50's 25.56 M trainable elements make
// 511 MB per momentum step, 0.153 ms.
//
// Design.  The TPU kernel packs every tensor into one padded (rows, 128)
// buffer and unpacks it again (multi_sgd.py:148-170), which on this card
// would triple the traffic.  This is a multi-tensor apply instead: the
// launch's table of up to kMaxTensors (w, g, m, n, lr, wd) entries and the
// prefix sums of their tile counts travel by value in the kernel's
// parameter space (the counterpart of the TPU kernel's scalar prefetch of
// lr/wd into SMEM: a learning-rate schedule needs no rebuild and no
// host-to-device copy).  The groups the Trainer hands over (4 tensors of
// ResNet-50: 1,000 to 3.4 M elements) are mostly too small to fill 132
// SMs with fixed 8192-element blocks, so the caller plans each launch
// (kernels/multi_sgd.py, _launch_plans) and hands over its tile size
// (elements per work item), the prefix sums of each tensor's tiles
// (tiles never span two tensors) and the grid, at most kBlocksPerSm
// blocks per SM (what the registers let stay resident).  Each block walks
// the tiles grid-stride (b, b + grid, ...): persistent, no second wave.
// Bytes in flight come from register staging: each thread issues kUnroll
// 16-byte loads of every array before it computes, 2048 elements (24 KB
// with momentum) a block, three blocks an SM.  A tile whose pointers are
// not all 16-byte aligned takes a scalar path, as do the last 1-3
// elements of a tile whose length is not a multiple of 4.
//
// A group with more tensors than the table holds is split into several
// launches by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;             // float4 loads of each array in flight
constexpr int kBlocksPerSm = 3;       // BLOCKS_PER_SM of the caller's plan

struct Table {
  float* w[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  long long n[kMaxTensors];
  float lr[kMaxTensors];
  float wd[kMaxTensors];
  int tile_start[kMaxTensors + 1];   // prefix sums of ceil(n / tile)
  int count;
  int tile;
};

struct Scalars {
  float mu, rescale, clip;
};

template <bool kMom>
__device__ __forceinline__ void update(float& w, float g, float& m, float lr,
                                       float wd, const Scalars& s) {
  float c = __fmul_rn(g, s.rescale);
  if (s.clip > 0.0f) c = c < -s.clip ? -s.clip : (c > s.clip ? s.clip : c);
  const float step = __fmul_rn(lr, __fadd_rn(c, __fmul_rn(wd, w)));
  if (kMom) {
    m = __fsub_rn(__fmul_rn(s.mu, m), step);
    w = __fadd_rn(w, m);
  } else {
    w = __fsub_rn(w, step);
  }
}

template <bool kMom>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
multi_sgd_kernel(const __grid_constant__ Table tab, const Scalars s) {
  const int total = tab.tile_start[tab.count];
  const int tid = threadIdx.x;
  float dummy = 0.0f;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int lo = 0, hi = tab.count - 1;    // last t with tile_start[t] <= tile
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (tab.tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
    }
    const int t = lo;
    const long long begin =
        static_cast<long long>(tile - tab.tile_start[t]) * tab.tile;
    const long long end =
        begin + tab.tile < tab.n[t] ? begin + tab.tile : tab.n[t];
    float* __restrict__ w = tab.w[t];
    const float* __restrict__ g = tab.g[t];
    float* __restrict__ m = tab.m[t];
    const float lr = tab.lr[t], wd = tab.wd[t];
    const uintptr_t bits = reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(g) |
                           (kMom ? reinterpret_cast<uintptr_t>(m) : 0);
    long long i = begin;
    if ((bits & 15) == 0) {              // begin is a multiple of 4 too
      const int nvec = static_cast<int>((end - begin) / 4);
      float4* w4 = reinterpret_cast<float4*>(w + begin);
      const float4* g4 = reinterpret_cast<const float4*>(g + begin);
      float4* m4 = kMom ? reinterpret_cast<float4*>(m + begin) : nullptr;
      for (int v0 = 0; v0 < nvec; v0 += kThreads * kUnroll) {
        float4 wv[kUnroll], gv[kUnroll], mv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = v0 + u * kThreads + tid;
          if (v < nvec) {
            wv[u] = w4[v];
            gv[u] = g4[v];
            if (kMom) mv[u] = m4[v];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = v0 + u * kThreads + tid;
          if (v < nvec) {
            float4 mm = kMom ? mv[u] : make_float4(0.f, 0.f, 0.f, 0.f);
            update<kMom>(wv[u].x, gv[u].x, mm.x, lr, wd, s);
            update<kMom>(wv[u].y, gv[u].y, mm.y, lr, wd, s);
            update<kMom>(wv[u].z, gv[u].z, mm.z, lr, wd, s);
            update<kMom>(wv[u].w, gv[u].w, mm.w, lr, wd, s);
            w4[v] = wv[u];
            if (kMom) m4[v] = mm;
          }
        }
      }
      i = begin + static_cast<long long>(nvec) * 4;
    }
    for (i += tid; i < end; i += kThreads) {
      float wv = w[i];
      float& mv = kMom ? m[i] : dummy;
      update<kMom>(wv, g[i], mv, lr, wd, s);
      w[i] = wv;
    }
  }
}

}  // namespace

// One launch over `count` (1..kMaxTensors) tensors on `stream`.  w, g, m
// are arrays of device pointers (m ignored unless use_mom), n the element
// counts, lr and wd the per-tensor rates.  The launch plan is the
// caller's (kernels/multi_sgd.py, _launch_plans): `tile` elements per
// work item, `tile_start` the count + 1 prefix sums of each tensor's
// tiles, and `grid` blocks.  Returns 0, a cudaError_t, or -1 for a table
// the kernel cannot take: a count out of range, a grid below 1, a tile
// that is not a positive multiple of 4 (the 16-byte path needs every tile
// to start on one), or prefix sums that do not start at 0 or go down.
extern "C" int mxtpu_multi_sgd(int count, const uint64_t* w,
                               const uint64_t* g, const uint64_t* m,
                               const long long* n, const int* tile_start,
                               const float* lr, const float* wd, int use_mom,
                               float mu, float rescale, float clip, int tile,
                               int grid, void* stream) {
  if (count < 1 || count > kMaxTensors || grid < 1 || tile < 4 ||
      tile % 4 != 0 || tile_start[0] != 0)
    return -1;
  Table tab;
  for (int t = 0; t < count; ++t) {
    if (n[t] < 0 || tile_start[t + 1] < tile_start[t]) return -1;
    tab.w[t] = reinterpret_cast<float*>(w[t]);
    tab.g[t] = reinterpret_cast<const float*>(g[t]);
    tab.m[t] = use_mom ? reinterpret_cast<float*>(m[t]) : nullptr;
    tab.n[t] = n[t];
    tab.lr[t] = lr[t];
    tab.wd[t] = wd[t];
    tab.tile_start[t] = tile_start[t];
  }
  tab.tile_start[count] = tile_start[count];
  tab.count = count;
  tab.tile = tile;
  if (tile_start[count] == 0) return 0;
  const Scalars s{mu, rescale, clip};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_mom)
    multi_sgd_kernel<true><<<grid, kThreads, 0, st>>>(tab, s);
  else
    multi_sgd_kernel<false><<<grid, kThreads, 0, st>>>(tab, s);
  return static_cast<int>(cudaGetLastError());
}
