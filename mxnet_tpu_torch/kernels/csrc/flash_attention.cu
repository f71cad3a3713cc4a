// Flash attention forward for Hopper (sm_90a), CUDA C++, on the tensor
// cores.
//
// Replaces the Pallas TPU kernel mxnet_tpu/kernels/flash_attention.py
// (_build_call, kernel body at :49-102).  Same function:
//   out[bh, i] = sum_j w_ij v[bh, j] / sum_j w_ij,  w_ij = exp(s_ij - max_j s)
//   s_ij = scale * (q[bh, i] . k[bh, j]), masked to -1e30 unless
//   float(j) < min(vl[bh], Lk)  and, if causal,  j <= i + (Lk - Lq).
// A row with no valid key ("dead") takes the key-length mask as weights;
// a row whose weights sum to 0 divides by 1 (so outputs 0).  The key loop
// stops at min(ceil(vl), Lk): later keys are masked for every row.
// Accumulation is fp32; the output has the input dtype (float32,
// bfloat16 or float16).  No (Lq, Lk) matrix reaches device memory.
//
// Bound.  FLOPs = 4 * sum_bh Lq * min(ceil(vl_bh), Lk) * D (QK^T and PV);
// bytes = q, the live K/V keys and out, each once.  At BERT-base shapes
// (D = 64) that is 64 flops per byte in fp32 and 128 in bf16 and fp16,
// below the tensor cores' 148 (TF32, 495 TFLOP/s) and 295 (bf16 and fp16,
// 989 TFLOP/s) per byte of HBM3 (3.35 TB/s): on the tensor cores the
// kernel is bound by bytes, and its work is to keep the MMAs fed while the
// next tile loads.
//
// Design (FlashAttention-2's forward).  One block of 4 warps per
// (64-query tile, bh), so B = 8, H = 12 gives 768 blocks at L = 512 and
// 192 at L = 128 for the 132 SMs; each warp owns 16 query rows.  K/V tiles
// (64 keys in bf16/fp16, 32 in fp32) come in through cp.async (16-byte LDGSTS,
// zero-filled past the last live key) into a ring of 2 shared-memory
// stages, so tile t+1's copy runs under tile t's MMAs.  Scores (16 x tile
// per warp) and the output (16 x D) live in MMA accumulator fragments;
// the running max and sum are kept per fragment row (each thread holds
// rows g and g+8 of its warp, g = lane / 4) and reduced over the 4 lanes
// of a quad with shuffles.  Masks and the dead-row rule are applied per
// fragment element from the fragment's own (row, key) coordinates; a tile
// whose keys are valid for every row (not causal, below vl) skips them.
// Softmax exponents are base 2 (scores scaled by scale * log2 e), by
// ex2.approx.
//
// Instructions.  Both products use mma.sync (HMMA), not wgmma:
//  - bf16 and fp16: m16n8k16 with fp32 accumulation, one template for
//    both 16-bit types; Q and K fed by ldmatrix, V by ldmatrix.trans (V
//    is row-major (key, d), the MMA's B wants d-major); P is rounded to
//    the input type for the PV product, as FlashAttention-2 does (fp16
//    keeps 3 more mantissa bits of P than bf16; P <= 1 cannot overflow).
//    Q arrives with tile 0 in stage 1's K slot and is held in registers.
//  - fp32: 3xTF32 on m16n8k8.  Each operand x splits into
//    hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi); the product is
//    lo*hi + hi*lo + hi*hi in fp32, which keeps fp32 accuracy.  The
//    rounding is done on the bits (split_tf32), as CUTLASS's fast 3xTF32
//    does: the PTX cvt costs ~10 instructions an operand on this card.
//    The scores' accumulator layout (columns 2t, 2t+1) is not the tf32 A
//    layout (columns t, t+4), so the PV product takes its 8 keys in the
//    permuted order (2t -> t, 2t+1 -> t+4) for P and V alike: no
//    shuffles.  Q keeps a shared-memory slot of its own and is read in
//    every tile (in registers it would spill at D = 128).
// wgmma does not fit this kernel's shapes well: it takes tf32 operands
// only K-major from shared memory (V would have to be staged transposed,
// and each tf32 operand twice, hi and lo), needs core-matrix or swizzled
// layouts that a padded row-major cp.async tile is not, and at L <= 512
// the kernel is bound by bytes, where mma.sync's rate is enough.
//
// Shared memory rows are padded (bf16/fp16: D + 8 elements, so the 8 rows
// of an ldmatrix fall in 8 different 4-bank groups; fp32: D + 4 floats, so
// the scalar fragment loads of a warp hit 32 different banks).  Per block
// at D = 64: bf16/fp16 36 KB (2 stages x (K + V)), fp32 51 KB (the same and
// Q), so 4 blocks (16 warps) fit an SM in all three.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- PTX primitives ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a * b, m16n8k16, bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, m16n8k16, fp16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_f16(float (&c)[4],
                                        const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, m16n8k8, tf32 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, MUFU.EX2 without exp2f's range handling; 2^-1e30 = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// ---- end of PTX primitives ---------------------------------------------

// x + half a tf32 ulp, as an MMA operand: the tensor cores ignore a tf32
// operand's low 13 bits, so the MMA sees cvt.rna.tf32(x) for finite x.
// (cvt.rna.tf32.f32 itself compiles to ~10 instructions on sm_90.)
__device__ __forceinline__ uint32_t rna_tf32_operand(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x = hi + lo with hi = cvt.rna.tf32(x) (its low 13 bits cleared here, so
// x - hi is exact) and lo passed on as rna_tf32_operand(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32_operand(x) & 0xffffe000u;
  lo = rna_tf32_operand(x - __uint_as_float(hi));
}

// 3xTF32: c += a * b with fp32 accuracy from split operands.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The MMA and the operand packing of one 16-bit input type T.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>)
    mma_f16(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The two products on one warp's 16 rows, per input type.  `lane` is the
// lane id, g = lane / 4 and t = lane % 4 the MMA's group and thread in
// group.  Shared-memory tiles are row-major with kStride elements a row.
template <typename T, int D>
struct Mma;

// bf16 and fp16 (T): the same tiles and fragments, T's MMA.
template <typename T, int D>
struct Mma16 {
  static constexpr int kStride = D + 8;
  static constexpr int kBK = 64;              // keys per tile
  static constexpr int kNT = kBK / 8;         // 8-key column tiles
  static constexpr bool kQInSmem = false;     // Q's slot is reused
  static_assert(kBK == kBQ, "Q is staged in a K slot");
  static constexpr int kMinBlocks = D <= 64 ? 4 : 1;   // blocks per SM
  using QFrag = uint32_t[D / 16][4];

  // Q rows [16 w, 16 w + 16) of the tile into A fragments, by ldmatrix.
  static __device__ __forceinline__ void load_q(QFrag& qa, const T* sq,
                                                int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qa[kk], sq + (lane & 15) * kStride + kk * 16 +
                              (lane >> 4) * 8);
  }

  // s[j] = Q K[8j : 8j + 8]^T for the tile's keys.
  static __device__ __forceinline__ void scores(float (&s)[kNT][4],
                                                const QFrag& qa,
                                                const T* sk, int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        // matrices: keys 16jp+{0..7, 0..7, 8..15, 8..15} x
        // dims 16kk+{0..7, 8..15, 0..7, 8..15}
        uint32_t b[4];
        ldmatrix_x4(b, sk + (jp * 16 + (lane & 7) + (lane >> 4) * 8) *
                               kStride + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16<T>(s[2 * jp], qa[kk], b[0], b[1]);
        mma16<T>(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }
  }

  // o += P V, P the tile's weights in score-fragment layout.
  static __device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                            const float (&p)[kNT][4],
                                            const T* sv, int lane) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack16<T>(p[2 * kk][0], p[2 * kk][1]),
                             pack16<T>(p[2 * kk][2], p[2 * kk][3]),
                             pack16<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack16<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        // matrices: keys 16kk+{0..7, 8..15, 0..7, 8..15} x
        // dims 16np+{0..7, 0..7, 8..15, 8..15}, transposed
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kStride +
                                 np * 16 + (lane >> 4) * 8);
        mma16<T>(o[2 * np], a, b[0], b[1]);
        mma16<T>(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
};

template <int D>
struct Mma<__nv_bfloat16, D> : Mma16<__nv_bfloat16, D> {};

template <int D>
struct Mma<__half, D> : Mma16<__half, D> {};

template <int D>
struct Mma<float, D> {
  using T = float;
  static constexpr int kStride = D + 4;
  static constexpr int kBK = 32;              // keys per tile
  static constexpr int kNT = kBK / 8;         // 8-key column tiles
  // Q stays in its own shared-memory slot and is read in every tile: in
  // registers its D / 2 floats per thread would spill at D = 128.
  static constexpr bool kQInSmem = true;
  static constexpr int kMinBlocks = 1;
  using QFrag = const float*;                 // the warp's 16 Q rows

  static __device__ __forceinline__ void load_q(QFrag& qa, const T* sq,
                                                int) {
    qa = sq;
  }

  static __device__ __forceinline__ void scores(float (&s)[kNT][4],
                                                const QFrag& qa,
                                                const T* sk, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* qr = qa + g * kStride + kk * 8 + t;
      const float a[4] = {qr[0], qr[8 * kStride], qr[4], qr[8 * kStride + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* r = sk + (j * 8 + g) * kStride + kk * 8 + t;
        mma_3xtf32(s[j], ah, al, r[0], r[4]);
      }
    }
  }

  static __device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                            const float (&p)[kNT][4],
                                            const T* sv, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      // k index t <-> key 8j + 2t, k index t + 4 <-> key 8j + 2t + 1
      const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float* r = sv + (j * 8 + 2 * t) * kStride + n * 8 + g;
        mma_3xtf32(o[n], ah, al, r[0], r[kStride]);
      }
    }
  }
};

// Copies rows [0, kRows) of a (rows, D) global tile at `src` into a padded
// shared tile; rows >= n_rows are zero-filled and not read.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int n_rows,
                                          int tid) {
  constexpr int kChunk = 16 / sizeof(T);          // elements per copy
  constexpr int kRowChunks = D / kChunk;
  constexpr int kStride = Mma<T, D>::kStride;
#pragma unroll
  for (int c = tid; c < kRows * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks, col = (c % kRowChunks) * kChunk;
    const bool in = r < n_rows;
    cp_async16(dst + r * kStride + col,
               src + static_cast<size_t>(in ? r : 0) * D + col, in);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Mma<T, D>::kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ vl,
                 T* __restrict__ out, int lq, int lk, int causal,
                 float scale) {
  using M = Mma<T, D>;
  constexpr int kStride = M::kStride;
  constexpr int kBK = M::kBK, kNT = M::kNT;
  constexpr int kTile = kBK * kStride;            // elements per K/V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // stage s: K at smem + 2 s kTile, V at smem + (2 s + 1) kTile; Q in
  // stage 1's K slot, or after the stages (kQInSmem)
  T* sq = smem + (M::kQInSmem ? 4 : 2) * kTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;

  const float vl_eff = fminf(vl[bh], static_cast<float>(lk));
  const int n_keys = vl_eff > 0.f
      ? min(lk, static_cast<int>(ceilf(vl_eff))) : 0;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  const float scale2 = scale * kLog2e;            // scores in log2 units

  const T* kbh = k + static_cast<size_t>(bh) * lk * D;
  const T* vbh = v + static_cast<size_t>(bh) * lk * D;

  // rows of this thread: r = 0 -> row0, r = 1 -> row0 + 8
  const int row0 = q0 + warp * 16 + g;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    typename M::QFrag qa;
    // Q, and tile 0 into stage 0
    load_tile<T, D, kBQ>(sq, q + (static_cast<size_t>(bh) * lq + q0) * D,
                         lq - q0, tid);
    load_tile<T, D, kBK>(smem, kbh, n_keys, tid);
    load_tile<T, D, kBK>(smem + kTile, vbh, n_keys, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    M::load_q(qa, sq + warp * 16 * kStride, lane);
    __syncthreads();          // bf16: Q read before its slot (stage 1) refills

    for (int it = 0; it < n_tiles; ++it) {
      const int kt = it * kBK;
      if (it + 1 < n_tiles) {
        T* nxt = smem + ((it + 1) & 1) * 2 * kTile;
        const size_t off = static_cast<size_t>(kt + kBK) * D;
        const int rows = n_keys - kt - kBK;
        load_tile<T, D, kBK>(nxt, kbh + off, rows, tid);
        load_tile<T, D, kBK>(nxt + kTile, vbh + off, rows, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();               // tile it has landed
      __syncthreads();
      const T* sk = smem + (it & 1) * 2 * kTile;

      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      M::scores(s, qa, sk, lane);

      // mask, tile max per row (element e: row r = e / 2, key 2t + e % 2);
      // a tile whose keys are all valid for every row needs no mask
      const bool full = !causal &&
                        static_cast<float>(kt + kBK - 1) < vl_eff;
      float mx[2] = {kNegInf, kNegInf};
      if (full) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= scale2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + j * 8 + 2 * t + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            const bool valid = static_cast<float>(key) < vl_eff &&
                               (!causal || key <= row + (lk - lq));
            s[j][e] = valid ? s[j][e] * scale2 : kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
      }
      float corr[2];
      bool dead[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        dead[r] = m_new <= kNegInf * 0.5f;
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = kt + j * 8 + 2 * t + (e & 1);
          s[j][e] = dead[r]
              ? (static_cast<float>(key) < vl_eff ? 1.f : 0.f)
              : fast_exp2(s[j][e] - m[r]);
          l[r] += s[j][e];
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      M::pv(o, s, sk + kTile, lane);
      __syncthreads();                  // stage consumed before refill
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + r * 8;
    if (row < lq) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      T* orow = out + (static_cast<size_t>(bh) * lq + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(orow + n * 8, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* vl, void* out, int bh, int lq, int lk,
                   int causal, float scale, cudaStream_t stream) {
  using M = Mma<T, D>;
  const size_t smem = (4 * M::kBK + (M::kQInSmem ? kBQ : 0)) * M::kStride *
                      sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((lq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), vl, static_cast<T*>(out), lq, lk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         const float* vl, void* out, int bh, int lq, int lk,
                         int d, int causal, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, vl, out, bh, lq, lk, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, vl, out, bh, lq, lk, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, vl, out, bh, lq, lk, causal, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, lq, d), k/v: (bh, lk, d), out: (bh, lq, d), all contiguous, of
// one dtype (0 = float32, 1 = bfloat16, 2 = float16) and 16-byte aligned;
// vl: (bh,) float32.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int mxtpu_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* vl,
                                         void* out, int bh, int lq, int lk,
                                         int d, int dtype, int causal,
                                         float scale, void* stream) {
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (bh > 65535) return cudaErrorInvalidValue;
  const float* vlf = static_cast<const float*>(vl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, vlf, out, bh, lq, lk, d, causal,
                               scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, vlf, out, bh, lq, lk, d,
                                       causal, scale, s);
  if (dtype == 2)
    return dispatch_dim<__half>(q, k, v, vlf, out, bh, lq, lk, d, causal,
                                scale, s);
  return cudaErrorInvalidValue;
}
