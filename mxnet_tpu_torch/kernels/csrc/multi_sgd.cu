// Multi-tensor SGD update for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/kernels/multi_sgd.py:
//   sgd_kernel      (:107-114, pallas_call at :138)
//     w' = w - lr_t * (c(g) + wd_t * w)
//   sgd_mom_kernel  (:116-126, pallas_call at :142)
//     m' = mu * m - lr_t * (c(g) + wd_t * w),  w' = w + m'
// with c(g) = g * rescale, then clipped to [-clip, clip] only when
// clip > 0; lr_t and wd_t per tensor.  Four modes:
//  - sgd, sgd_mom ("plain"): w, g and m share one storage type T (fp32,
//    bf16 or fp16), as in the TPU kernel, which works in the weights'
//    dtype.  The caller rounds lr, wd and mu to T and rescale and clip to
//    the gradient's T, as the JAX package does (multi_sgd.py:216-222);
//    the kernel computes in fp32 from the stored values, rounds c(g) to T
//    (the JAX package rescales the gradient in its own dtype before the
//    kernel), and rounds each result (m', then w' from the rounded m')
//    once, to nearest even.
//  - mp_sgd, mp_sgd_mom ("mixed", multi_mp_sgd_mom_update of
//    mxnet_tpu/ndarray/ops_optimizer.py:215-235, and mp_sgd_update):
//    g and w are bf16 or fp16, m and the master w32 fp32.  The update is
//    the fp32 one on the master from the fp32-cast gradient, and w gets
//    w32' rounded to T in the same pass: the JAX op runs the fp32 kernel
//    on the masters and then casts each master into its weight.
// Each fp32 product and sum is rounded on its own (__fmul_rn / __fadd_rn
// / __fsub_rn: no FMA contraction), in the order written above, so the
// kernel gives the plain PyTorch version's bits.  A NaN gradient stays
// NaN through the clip.
//
// Bound.  One pass over memory.  Bytes per element: sgd fp32 12 (read w,
// g; write w), sgd_mom fp32 20 (and m); bf16/fp16 6 and 10; mp_sgd 12
// (read g 2, w32 4; write w32 4, w 2), mp_sgd_mom 20 (and m 4 + 4).  4-6
// flops an element are far below the card's 20 flops per byte, so bytes
// over 3.35 TB/s bound it.  ResNet-50's 25.56 M trainable elements make
// 511 MB per fp32 or mixed momentum step (0.153 ms) and 256 MB in bf16
// (0.076 ms).
//
// Design.  The TPU kernel packs every tensor into one padded (rows, 128)
// buffer and unpacks it again (multi_sgd.py:148-170), which on this card
// would triple the traffic.  This is a multi-tensor apply instead: the
// launch's table of up to kMaxTensors (w, g, m, w32, n, lr, wd) entries
// and the prefix sums of their tile counts travel by value in the
// kernel's parameter space (the counterpart of the TPU kernel's scalar
// prefetch of lr/wd into SMEM: a learning-rate schedule needs no rebuild
// and no host-to-device copy).  The groups the Trainer hands over (4
// tensors of ResNet-50: 1,000 to 3.4 M elements) are mostly too small to
// fill 132 SMs with fixed 8192-element blocks, so the caller plans each
// launch (kernels/multi_sgd.py, _launch_plans) and hands over its tile
// size (elements per work item, planned in 16-byte vectors: 4 fp32 or 8
// bf16/fp16 elements), the prefix sums of each tensor's tiles (tiles
// never span two tensors) and the grid, at most kBlocksPerSm blocks per
// SM (what the registers let stay resident).  Each block walks the tiles
// grid-stride (b, b + grid, ...): persistent, no second wave.  Bytes in
// flight come from register staging: each thread issues its loads of
// kElemsInFlight elements of every array (kUnroll vectors: 4 of 4 fp32,
// or 2 of 8 bf16/fp16 elements; the mixed path's fp32 arrays take two
// 16-byte words a vector) before it computes; the staged words stay raw
// until the arithmetic.  A tile whose pointers are not all 16-byte
// aligned takes a scalar path, as do the last elements of a tile whose
// length is not a multiple of the vector.
//
// A group with more tensors than the table holds is split into several
// launches by the caller.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kThreads = 256;
constexpr int kElemsInFlight = 16;  // staged elements of each array a thread
constexpr int kBlocksPerSm = 3;     // BLOCKS_PER_SM of the caller's plan

enum Mode { kSgd = 0, kSgdMom = 1, kMpSgd = 2, kMpSgdMom = 3 };

struct Table {
  void* w[kMaxTensors];           // weights, storage T
  const void* g[kMaxTensors];     // gradients, T
  void* m[kMaxTensors];           // momenta: T (plain), fp32 (mixed)
  float* w32[kMaxTensors];        // fp32 masters (mixed)
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

// A storage type: its raw bits, and exact or round-to-nearest-even
// conversions to and from fp32.
template <typename T>
struct Type;

template <>
struct Type<float> {
  using Raw = uint32_t;
  static __device__ __forceinline__ float to_float(uint32_t b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ uint32_t from_float(float x) {
    return __float_as_uint(x);
  }
};

template <>
struct Type<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float to_float(uint32_t b) {
    return __uint_as_float(b << 16);
  }
  static __device__ __forceinline__ uint32_t from_float(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <>
struct Type<__half> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float to_float(uint32_t b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  static __device__ __forceinline__ uint32_t from_float(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Type<T>::to_float(Type<T>::from_float(x));
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Element j of the elements of storage S packed in a 16-byte word.
template <typename S>
__device__ __forceinline__ float elem(const uint4& u, int j) {
  if constexpr (sizeof(S) == 4) {
    return Type<S>::to_float(word(u, j));
  } else {
    const uint32_t w = word(u, j >> 1);
    return Type<S>::to_float((j & 1) ? (w >> 16) : (w & 0xffffu));
  }
}

// The 16 / sizeof(S) values x[0..] stored as S in one 16-byte word.
template <typename S>
__device__ __forceinline__ uint4 pack(const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(S) == 4)
      w[i] = Type<S>::from_float(x[i]);
    else
      w[i] = Type<S>::from_float(x[2 * i]) |
             (Type<S>::from_float(x[2 * i + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// kN elements of storage S from element i0 of `base` (16-byte aligned):
// kN * sizeof(S) / 16 words.
template <typename S, int kN>
struct Vec {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(S));
  static constexpr int kWords = kN / kPer;
  uint4 u[kWords];

  __device__ __forceinline__ void load(const void* base, long long i0) {
    const uint4* q = reinterpret_cast<const uint4*>(
        static_cast<const typename Type<S>::Raw*>(base) + i0);
#pragma unroll
    for (int k = 0; k < kWords; ++k) u[k] = q[k];
  }
  __device__ __forceinline__ float get(int j) const {
    return elem<S>(u[j / kPer], j % kPer);
  }
  static __device__ __forceinline__ void store(void* base, long long i0,
                                               const float (&x)[kN]) {
    uint4* q = reinterpret_cast<uint4*>(
        static_cast<typename Type<S>::Raw*>(base) + i0);
#pragma unroll
    for (int k = 0; k < kWords; ++k) q[k] = pack<S>(x + k * kPer);
  }
};

template <typename S>
__device__ __forceinline__ float load1(const void* base, long long i) {
  return Type<S>::to_float(
      static_cast<const typename Type<S>::Raw*>(base)[i]);
}

template <typename S>
__device__ __forceinline__ void store1(void* base, long long i, float x) {
  static_cast<typename Type<S>::Raw*>(base)[i] =
      static_cast<typename Type<S>::Raw>(Type<S>::from_float(x));
}

// One element.  Plain modes: w, m in T (read as fp32); mixed modes: w is
// the fp32 master, m fp32, and the caller stores round_to<T>(w) into the
// weight.
template <typename T, int kMode>
__device__ __forceinline__ void update(float& w, float g, float& m, float lr,
                                       float wd, const Scalars& s) {
  constexpr bool kMixed = kMode >= kMpSgd;
  float c = __fmul_rn(g, s.rescale);
  if (!kMixed) c = round_to<T>(c);
  if (s.clip > 0.0f) c = c < -s.clip ? -s.clip : (c > s.clip ? s.clip : c);
  const float step = __fmul_rn(lr, __fadd_rn(c, __fmul_rn(wd, w)));
  if (kMode == kSgdMom) {
    m = round_to<T>(__fsub_rn(__fmul_rn(s.mu, m), step));
    w = round_to<T>(__fadd_rn(w, m));
  } else if (kMode == kSgd) {
    w = round_to<T>(__fsub_rn(w, step));
  } else if (kMode == kMpSgdMom) {
    m = __fsub_rn(__fmul_rn(s.mu, m), step);
    w = __fadd_rn(w, m);
  } else {
    w = __fsub_rn(w, step);
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
multi_sgd_kernel(const __grid_constant__ Table tab, const Scalars s) {
  constexpr bool kMixed = kMode >= kMpSgd;
  constexpr bool kMom = kMode == kSgdMom || kMode == kMpSgdMom;
  using M = typename std::conditional<kMixed, float, T>::type;  // m, w32
  constexpr int kN = 16 / static_cast<int>(sizeof(T));   // vector elements
  constexpr int kUnroll = kElemsInFlight / kN;
  const int total = tab.tile_start[tab.count];
  const int tid = threadIdx.x;
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
    void* const w = tab.w[t];
    const void* const g = tab.g[t];
    void* const m = tab.m[t];
    float* const w32 = tab.w32[t];
    // the array the update reads as the weight: the master when mixed
    void* const src = kMixed ? static_cast<void*>(w32) : w;
    const float lr = tab.lr[t], wd = tab.wd[t];
    const uintptr_t bits = reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(g) |
                           (kMom ? reinterpret_cast<uintptr_t>(m) : 0) |
                           (kMixed ? reinterpret_cast<uintptr_t>(w32) : 0);
    long long i = begin;
    if ((bits & 15) == 0) {              // begin is a multiple of kN too
      const int nvec = static_cast<int>((end - begin) / kN);
      for (int v0 = 0; v0 < nvec; v0 += kThreads * kUnroll) {
        Vec<T, kN> gv[kUnroll];
        Vec<M, kN> wv[kUnroll], mv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = v0 + u * kThreads + tid;
          if (v < nvec) {
            const long long e = begin + static_cast<long long>(v) * kN;
            gv[u].load(g, e);
            wv[u].load(src, e);
            if (kMom) mv[u].load(m, e);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = v0 + u * kThreads + tid;
          if (v < nvec) {
            const long long e = begin + static_cast<long long>(v) * kN;
            float wo[kN], mo[kN];
#pragma unroll
            for (int j = 0; j < kN; ++j) {
              wo[j] = wv[u].get(j);
              mo[j] = kMom ? mv[u].get(j) : 0.f;
              update<T, kMode>(wo[j], gv[u].get(j), mo[j], lr, wd, s);
            }
            Vec<M, kN>::store(src, e, wo);
            if (kMom) Vec<M, kN>::store(m, e, mo);
            if (kMixed) Vec<T, kN>::store(w, e, wo);
          }
        }
      }
      i = begin + static_cast<long long>(nvec) * kN;
    }
    for (i += tid; i < end; i += kThreads) {
      float wo = load1<M>(src, i);
      float mo = kMom ? load1<M>(m, i) : 0.f;
      update<T, kMode>(wo, load1<T>(g, i), mo, lr, wd, s);
      store1<M>(src, i, wo);
      if (kMom) store1<M>(m, i, mo);
      if (kMixed) store1<T>(w, i, wo);
    }
  }
}

template <typename T, int kMode>
int launch(const Table& tab, const Scalars& s, int grid, cudaStream_t st) {
  multi_sgd_kernel<T, kMode><<<grid, kThreads, 0, st>>>(tab, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mode(int mode, const Table& tab, const Scalars& s, int grid,
                  cudaStream_t st) {
  switch (mode) {
    case kSgd: return launch<T, kSgd>(tab, s, grid, st);
    case kSgdMom: return launch<T, kSgdMom>(tab, s, grid, st);
    case kMpSgd:
      if constexpr (sizeof(T) == 2) return launch<T, kMpSgd>(tab, s, grid, st);
      return -1;
    case kMpSgdMom:
      if constexpr (sizeof(T) == 2)
        return launch<T, kMpSgdMom>(tab, s, grid, st);
      return -1;
    default: return -1;
  }
}

}  // namespace

// One launch over `count` (1..kMaxTensors) tensors on `stream`.  w, g, m,
// w32 are arrays of device pointers (m read only with momentum, w32 only
// in the mixed modes), n the element counts, lr and wd the per-tensor
// rates.  `dtype` is the storage of w and g (0 float32, 1 bfloat16, 2
// float16; and of m in the plain modes), `mode` 0 sgd, 1 sgd_mom, 2
// mp_sgd, 3 mp_sgd_mom (2 and 3 take bfloat16 or float16 only).  The
// launch plan is the caller's (kernels/multi_sgd.py, _launch_plans):
// `tile` elements per work item, `tile_start` the count + 1 prefix sums of
// each tensor's tiles, and `grid` blocks.  Returns 0, a cudaError_t, or -1
// for a table the kernel cannot take: a count out of range, a grid below
// 1, a tile that is not a positive multiple of the vector (4 fp32 or 8
// bf16/fp16 elements: the 16-byte path needs every tile to start on one),
// prefix sums that do not start at 0 or go down, or a dtype and mode it
// has no kernel for.
extern "C" int mxtpu_multi_sgd(int count, const uint64_t* w,
                               const uint64_t* g, const uint64_t* m,
                               const uint64_t* w32, const long long* n,
                               const int* tile_start, const float* lr,
                               const float* wd, int dtype, int mode,
                               float mu, float rescale, float clip, int tile,
                               int grid, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (count < 1 || count > kMaxTensors || grid < 1 || tile < vec ||
      tile % vec != 0 || tile_start[0] != 0 || dtype < 0 || dtype > 2 ||
      mode < kSgd || mode > kMpSgdMom || (mode >= kMpSgd && dtype == 0))
    return -1;
  const bool mom = mode == kSgdMom || mode == kMpSgdMom;
  Table tab;
  for (int t = 0; t < count; ++t) {
    if (n[t] < 0 || tile_start[t + 1] < tile_start[t]) return -1;
    tab.w[t] = reinterpret_cast<void*>(w[t]);
    tab.g[t] = reinterpret_cast<const void*>(g[t]);
    tab.m[t] = mom ? reinterpret_cast<void*>(m[t]) : nullptr;
    tab.w32[t] = mode >= kMpSgd ? reinterpret_cast<float*>(w32[t]) : nullptr;
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
  switch (dtype) {
    case 0: return dispatch_mode<float>(mode, tab, s, grid, st);
    case 1: return dispatch_mode<__nv_bfloat16>(mode, tab, s, grid, st);
    default: return dispatch_mode<__half>(mode, tab, s, grid, st);
  }
}
