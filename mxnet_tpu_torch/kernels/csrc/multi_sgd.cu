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
// prefix sums of their chunk counts travel by value in the kernel's
// parameter space (the counterpart of the TPU kernel's scalar prefetch of
// lr/wd into SMEM: a learning-rate schedule needs no rebuild and no
// host-to-device copy).  Block b finds its (tensor, chunk) by a binary
// search over the prefix sums, then updates kChunk elements of that
// tensor: 16-byte vector loads and stores when all of the tensor's
// pointers are 16-byte aligned, a scalar tail after them, and scalar
// accesses throughout when they are not.  A group with more tensors than
// the table holds is split into several launches by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kThreads = 256;
constexpr int kChunk = 8192;   // elements per block: 8 float4 per thread

struct Table {
  float* w[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  long long n[kMaxTensors];
  float lr[kMaxTensors];
  float wd[kMaxTensors];
  int chunk_start[kMaxTensors + 1];   // prefix sums of ceil(n / kChunk)
  int count;
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
__global__ void __launch_bounds__(kThreads)
multi_sgd_kernel(const __grid_constant__ Table tab, const Scalars s) {
  const int b = blockIdx.x;
  int lo = 0, hi = tab.count - 1;      // last t with chunk_start[t] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  const long long begin = (long long)(b - tab.chunk_start[t]) * kChunk;
  const long long n = tab.n[t];
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  float* __restrict__ w = tab.w[t];
  const float* __restrict__ g = tab.g[t];
  float* __restrict__ m = tab.m[t];
  const float lr = tab.lr[t], wd = tab.wd[t];
  float dummy = 0.0f;

  long long i = begin;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(g) |
                         (kMom ? reinterpret_cast<uintptr_t>(m) : 0);
  if ((bits & 15) == 0) {                 // begin is a multiple of 4 too
    const long long nvec = (end - begin) / 4;
    float4* w4 = reinterpret_cast<float4*>(w + begin);
    const float4* g4 = reinterpret_cast<const float4*>(g + begin);
    float4* m4 = kMom ? reinterpret_cast<float4*>(m + begin) : nullptr;
    for (long long v = threadIdx.x; v < nvec; v += kThreads) {
      float4 wv = w4[v];
      const float4 gv = g4[v];
      float4 mv = kMom ? m4[v] : make_float4(0.f, 0.f, 0.f, 0.f);
      update<kMom>(wv.x, gv.x, mv.x, lr, wd, s);
      update<kMom>(wv.y, gv.y, mv.y, lr, wd, s);
      update<kMom>(wv.z, gv.z, mv.z, lr, wd, s);
      update<kMom>(wv.w, gv.w, mv.w, lr, wd, s);
      w4[v] = wv;
      if (kMom) m4[v] = mv;
    }
    i = begin + nvec * 4;
  }
  for (i += threadIdx.x; i < end; i += kThreads) {
    float wv = w[i];
    float& mv = kMom ? m[i] : dummy;
    update<kMom>(wv, g[i], mv, lr, wd, s);
    w[i] = wv;
  }
}

}  // namespace

// One launch over `count` (1..kMaxTensors) tensors on `stream`.  w, g, m
// are arrays of device pointers (m ignored unless use_mom), n the element
// counts, lr and wd the per-tensor rates.  Returns 0, a cudaError_t, or
// -1 for a count the table cannot hold.  The caller skips groups whose
// tensors are all empty (they launch nothing).
extern "C" int mxtpu_multi_sgd(int count, const uint64_t* w,
                               const uint64_t* g, const uint64_t* m,
                               const long long* n, const float* lr,
                               const float* wd, int use_mom, float mu,
                               float rescale, float clip, void* stream) {
  if (count < 1 || count > kMaxTensors) return -1;
  Table tab;
  int chunks = 0;
  for (int t = 0; t < count; ++t) {
    tab.w[t] = reinterpret_cast<float*>(w[t]);
    tab.g[t] = reinterpret_cast<const float*>(g[t]);
    tab.m[t] = use_mom ? reinterpret_cast<float*>(m[t]) : nullptr;
    tab.n[t] = n[t];
    tab.lr[t] = lr[t];
    tab.wd[t] = wd[t];
    tab.chunk_start[t] = chunks;
    chunks += static_cast<int>((n[t] + kChunk - 1) / kChunk);
  }
  tab.chunk_start[count] = chunks;
  tab.count = count;
  if (chunks == 0) return 0;
  const Scalars s{mu, rescale, clip};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_mom) {
    multi_sgd_kernel<true><<<chunks, kThreads, 0, st>>>(tab, s);
  } else {
    multi_sgd_kernel<false><<<chunks, kThreads, 0, st>>>(tab, s);
  }
  return static_cast<int>(cudaGetLastError());
}
