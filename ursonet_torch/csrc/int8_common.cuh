// Shared pieces of the int8 kernels (int8_gemm.cu, int8_conv.cu,
// int8_stem.cu, int8_block.cu): the s8 x s8 -> s32 tensor-core tile loop
// and the fused epilogues.
//
// Tiling. A block of 256 threads (8 warps) computes a BM x BN tile of
// the output; each warp a WM x WN sub-tile as (WM/16) x (WN/8)
// mma.sync.m16n8k32 s8 products with s32 accumulators in registers.
// K advances in steps of BK = 64 bytes through two shared-memory stages:
// while the warps multiply stage s, every thread already holds the next
// step's A and B chunks (16 bytes each) in registers and stores them
// into stage s^1 afterwards. Both operands sit in shared memory K-major
// (A: [BM][BK], B: [BN][BK]) with rows padded to 80 bytes, which makes
// the 32-bit fragment reads of a warp hit 32 distinct banks.
//
// Epilogue, per output element, with y = fma(f32(acc), alpha[n], beta[n])
// (one rounding):
//   s32       acc
//   f32       y
//   f32_relu  max(y, 0)
//   q8_relu   clip(rint(max(y, 0) * inv_s_out), 0, 127)
//   q8        clip(rint(y * inv_s_out), -127, 127)
//   join      clip(rint(max(y + f32(res) * res_scale, 0) * inv_s_out), 0, 127)
//             (the residual product and the sum each rounded)
//   join_s8   clip(rint(y * inv_s_out) + rint(f32(res) * res_scale), 0, 127)
//             (the JAX package's QUANT_S8_JOIN: both operands rounded onto
//             the output grid, the sum of two integers exact)
//   f32_sum   y, as f32 (the same as f32 in this mode)
// The joins' residual `res` is int8, f32 or bf16 (`res_type`): a
// requantized shortcut, or the float output of an unrequantized one (an
// artifact calibrated before the shortcut requant sites existed), which
// `join` adds with res_scale 1 and join_s8 rounds with res_scale
// 1 / s_out.
// This is the arithmetic XLA compiles the JAX package's Int8Ops into
// (measured on the CPU against the whole model): it contracts
// acc * alpha + beta into an FMA but adds the dequantized residual
// separately, and turns y / s_out with a constant s_out into
// y * f32(1 / s_out), so inv_s_out is that f32 reciprocal. The file is
// built with -fmad=false, so the one FMA is the explicit one. rintf
// rounds half to even, as jnp.round and torch.round.
//
// The bf16 mode (`Epilogue::bf16`, the JAX package's F16) is what XLA
// compiles Int8Ops(acc_dtype=bfloat16) into: each bf16 operation done in
// f32 and rounded to bf16 right after it, no FMA. With
// bf(v) = f32(bf16_rn(v)):
//   a = bf(f32(acc))       s32 -> f32 -> bf16, two roundings (a single
//                          __int2bfloat16_rn differs above 2^24)
//   s = bf(a * bf(alpha)) + bf(beta),  y = bf(s)
//   f32, f32_relu  y, max(y, 0), stored as bf16
//   q8_relu        clip(rint(max(y, 0) * inv_s_out), 0, 127)
//   q8             clip(rint(s * inv_s_out), -127, 127): the sum is not
//                  rounded (XLA drops the bf16 round trip of a value that
//                  is only widened again)
//   join           z = bf(y + bf(f32(res) * bf(res_scale))),
//                  clip(rint(max(z, 0) * inv_s_out), 0, 127)
//   join_s8        clip(rint(s * inv_s_out) + rint(f32(res) * res_scale),
//                  0, 127): s unrounded as in q8, res_scale not rounded
//                  (JAX multiplies the f32 residual by a Python float)
//   f32_sum        s, as f32: the shortcut that join_s8 takes as a float
//                  residual, whose bf16 rounding XLA drops as in q8
// Products of two bf16 values are exact in f32, so each bf() is the one
// rounding XLA makes there. No native bf16 arithmetic is used: a bf16
// add or FMA rounds once where XLA rounds twice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ursonet_int8 {

constexpr int kThreads = 256;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes

enum Mode { kS32 = 0, kF32 = 1, kF32Relu = 2, kQ8Relu = 3, kQ8 = 4,
            kJoin = 5, kJoinS8 = 6, kF32Sum = 7, kModes = 8 };

// The element type of a join's residual.
enum ResType { kResS8 = 0, kResF32 = 1, kResBf16 = 2, kResTypes = 3 };

__host__ __device__ constexpr bool is_join(int mode) {
  return mode == kJoin || mode == kJoinS8;
}

__host__ __device__ constexpr int res_type_bytes(int res_type) {
  return res_type == kResF32 ? 4 : res_type == kResBf16 ? 2 : 1;
}

struct Epilogue {
  int mode;
  const float* alpha;   // [N]
  const float* beta;    // [N]
  float inv_s_out;
  const void* res;      // [M, N] of res_type, the joins only
  int res_type;
  float res_scale;
  void* out;            // [M, N]: int32, float (bf16) or int8 by mode
  int bf16;             // 1: the bf16 accumulation mode
};

// f32(res[idx]), exact for each residual type.
__device__ __forceinline__ float load_res(const Epilogue& e, int64_t idx) {
  if (e.res_type == kResF32)
    return __ldg(static_cast<const float*>(e.res) + idx);
  if (e.res_type == kResBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(e.res)[idx]);
  return __int2float_rn(static_cast<const int8_t*>(e.res)[idx]);
}

template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int WARPS_M = BM / WM;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // each pass of 256 threads moves 64 rows x 64 bytes (16 bytes a thread)
  static constexpr int A_PASSES = BM / 64, B_PASSES = BN / 64;
  static_assert((BM / WM) * (BN / WN) == kThreads / 32, "8 warps a block");
  static_assert(BM % 64 == 0 && BN % 64 == 0, "whole load passes");
};

// Tile configurations, chosen per call by the Python wrapper.
using TileLarge = Tile<128, 128, 64, 32>;   // wide N
using TileNarrow = Tile<128, 64, 32, 32>;   // N <= 64
using TileSmall = Tile<64, 64, 32, 16>;     // few rows (the head denses)

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layout of m16n8k32 (PTX ISA): with g = lane / 4, t = lane % 4,
// A register 0 holds row g, k = 4t..4t+3; register 1 row g+8; registers
// 2, 3 the same rows at k + 16. B register 0 holds column g, k = 4t..4t+3;
// register 1 k + 16. Accumulator i holds row g (+8 for i >= 2), column
// 2t + (i & 1).
template <class T>
__device__ __forceinline__ void warp_mma(const int8_t* As, const int8_t* Bs,
                                         int wm0, int wn0, int lane,
                                         int (&acc)[T::MT][T::NT][4]) {
  const int g = lane >> 2, t4 = (lane & 3) * 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[T::MT][4], b[T::NT][2];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int8_t* p = As + (wm0 + i * 16 + g) * LDS + kk + t4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int8_t* q = Bs + (wn0 + j * 8 + g) * LDS + kk + t4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(q);
      b[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
    }
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
  }
}

// 16 bytes of row `row` of a K-major [rows, K] matrix, from column k on;
// zeros past the last row or column. `vec`: K % 16 == 0 and G 16-byte
// aligned, so a chunk is either wholly inside the row or wholly past it.
__device__ __forceinline__ int4 fetch_row_chunk(const int8_t* __restrict__ G,
                                                int rows, int K, int row,
                                                int k, bool vec) {
  if (row >= rows || k >= K) return make_int4(0, 0, 0, 0);
  const int8_t* src = G + static_cast<int64_t>(row) * K + k;
  if (vec) return __ldg(reinterpret_cast<const int4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (k + i < K) {
      w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + i)))
                   << (8 * (i & 3));
    }
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                   static_cast<int>(w[2]), static_cast<int>(w[3]));
}

__device__ __forceinline__ int8_t saturate_s8(float q, float lo) {
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(q, lo), 127.f)));
}

// f32(bf16_rn(v)): one rounding to bf16 (to nearest, ties to even),
// the value kept in f32.
__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf_round of two values by one packed conversion (cvt.rn.bf16x2.f32),
// each widened back by a shift or a mask of its half.
__device__ __forceinline__ void bf_round2(float& v0, float& v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const uint32_t p = *reinterpret_cast<const uint32_t*>(&h);
  v0 = __uint_as_float(p << 16);
  v1 = __uint_as_float(p & 0xffff0000u);
}

// Two values already rounded to bf16 as a bf16 pair, `lo` in the low
// half: their high halves, by one byte permute.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The bf16 mode's s = bf(bf(f32(acc)) * alpha) + beta, for alpha and
// beta already rounded to bf16; y = bf_round(s).
__device__ __forceinline__ float bf16_sum(int acc, float alpha, float beta) {
  return __fadd_rn(bf_round(__fmul_rn(bf_round(__int2float_rn(acc)), alpha)),
                   beta);
}

// bf16_sum of two accumulators, each rounding of the pair by one packed
// conversion.
__device__ __forceinline__ void bf16_sum2(int acc0, int acc1, float alpha0,
                                          float beta0, float alpha1,
                                          float beta1, float& s0, float& s1) {
  float a0 = __int2float_rn(acc0), a1 = __int2float_rn(acc1);
  bf_round2(a0, a1);
  a0 = __fmul_rn(a0, alpha0);
  a1 = __fmul_rn(a1, alpha1);
  bf_round2(a0, a1);
  s0 = __fadd_rn(a0, beta0);
  s1 = __fadd_rn(a1, beta1);
}

// The bf16 mode's q8_relu on one accumulator (alpha, beta unrounded).
__device__ __forceinline__ int8_t requant_relu_bf16(int acc, float alpha,
                                                    float beta,
                                                    float inv_s_out) {
  const float y = bf_round(bf16_sum(acc, bf_round(alpha), bf_round(beta)));
  return saturate_s8(rintf(__fmul_rn(fmaxf(y, 0.f), inv_s_out)), 0.f);
}

// The q8_relu epilogue on one accumulator.
__device__ __forceinline__ int8_t requant_relu(int acc, float alpha,
                                               float beta, float inv_s_out) {
  const float y = __fmaf_rn(__int2float_rn(acc), alpha, beta);
  return saturate_s8(rintf(__fmul_rn(fmaxf(y, 0.f), inv_s_out)), 0.f);
}

// The join epilogue on one accumulator and its residual f32(res).
__device__ __forceinline__ int8_t requant_join(int acc, float alpha,
                                               float beta, float res,
                                               float res_scale,
                                               float inv_s_out) {
  const float y = __fmaf_rn(__int2float_rn(acc), alpha, beta);
  const float r = __fmul_rn(res, res_scale);
  const float z = fmaxf(__fadd_rn(y, r), 0.f);
  return saturate_s8(rintf(__fmul_rn(z, inv_s_out)), 0.f);
}

// join_s8 on the sum s (y in the f32 mode) and the residual f32(res):
// two integers on the output grid, added exactly, clipped.
__device__ __forceinline__ int8_t join_s8_of(float s, float res,
                                             float res_scale,
                                             float inv_s_out) {
  return saturate_s8(__fadd_rn(rintf(__fmul_rn(s, inv_s_out)),
                               rintf(__fmul_rn(res, res_scale))),
                     0.f);
}

// The bf16 mode of epilogue_store (the modes but those of epilogue_extra;
// the join's residual is int8).
__device__ __forceinline__ void epilogue_store_bf16(const Epilogue& e,
                                                    int64_t idx, int n,
                                                    int acc) {
  const float s = bf16_sum(acc, bf_round(__ldg(e.alpha + n)),
                           bf_round(__ldg(e.beta + n)));
  const float y = bf_round(s);
  if (e.mode == kF32 || e.mode == kF32Relu) {
    // exact: y is a bf16 value
    static_cast<__nv_bfloat16*>(e.out)[idx] =
        __float2bfloat16_rn(e.mode == kF32 ? y : fmaxf(y, 0.f));
  } else if (e.mode == kQ8Relu) {
    static_cast<int8_t*>(e.out)[idx] =
        saturate_s8(rintf(__fmul_rn(fmaxf(y, 0.f), e.inv_s_out)), 0.f);
  } else if (e.mode == kQ8) {
    static_cast<int8_t*>(e.out)[idx] =
        saturate_s8(rintf(__fmul_rn(s, e.inv_s_out)), -127.f);
  } else {  // kJoin
    const int res = static_cast<const int8_t*>(e.res)[idx];
    const float r =
        bf_round(__fmul_rn(__int2float_rn(res), bf_round(e.res_scale)));
    const float z = fmaxf(bf_round(__fadd_rn(y, r)), 0.f);
    static_cast<int8_t*>(e.out)[idx] =
        saturate_s8(rintf(__fmul_rn(z, e.inv_s_out)), 0.f);
  }
}

// The epilogue of one accumulator in the modes that were there before
// epilogue_extra's; the join's residual is int8.
__device__ __forceinline__ void epilogue_store(const Epilogue& e,
                                               int64_t idx, int n, int acc) {
  if (e.mode == kS32) {
    static_cast<int32_t*>(e.out)[idx] = acc;
    return;
  }
  if (e.bf16) {
    epilogue_store_bf16(e, idx, n, acc);
    return;
  }
  const float y = __fmaf_rn(__int2float_rn(acc), __ldg(e.alpha + n),
                            __ldg(e.beta + n));
  if (e.mode == kF32) {
    static_cast<float*>(e.out)[idx] = y;
  } else if (e.mode == kF32Relu) {
    static_cast<float*>(e.out)[idx] = fmaxf(y, 0.f);
  } else if (e.mode == kQ8Relu) {
    static_cast<int8_t*>(e.out)[idx] =
        requant_relu(acc, __ldg(e.alpha + n), __ldg(e.beta + n), e.inv_s_out);
  } else if (e.mode == kQ8) {
    static_cast<int8_t*>(e.out)[idx] =
        saturate_s8(rintf(__fmul_rn(y, e.inv_s_out)), -127.f);
  } else {  // kJoin
    static_cast<int8_t*>(e.out)[idx] = requant_join(
        acc, __ldg(e.alpha + n), __ldg(e.beta + n),
        __int2float_rn(static_cast<const int8_t*>(e.res)[idx]), e.res_scale,
        e.inv_s_out);
  }
}

// The modes added beside them, in both accumulation modes: f32_sum,
// join_s8 (any residual type) and `join` over a float residual. Kernels
// take them in instantiations of their own (extra_mode), so that the
// per-element code of the others stays as it was.
__device__ __forceinline__ void epilogue_extra(const Epilogue& e,
                                               int64_t idx, int n, int acc) {
  const float alpha = __ldg(e.alpha + n), beta = __ldg(e.beta + n);
  float s, y;
  if (e.bf16) {
    s = bf16_sum(acc, bf_round(alpha), bf_round(beta));
    y = bf_round(s);
  } else {
    s = y = __fmaf_rn(__int2float_rn(acc), alpha, beta);
  }
  if (e.mode == kF32Sum) {
    static_cast<float*>(e.out)[idx] = s;
  } else if (e.mode == kJoinS8) {
    static_cast<int8_t*>(e.out)[idx] =
        join_s8_of(s, load_res(e, idx), e.res_scale, e.inv_s_out);
  } else if (e.bf16) {  // kJoin
    const float r =
        bf_round(__fmul_rn(load_res(e, idx), bf_round(e.res_scale)));
    const float z = fmaxf(bf_round(__fadd_rn(y, r)), 0.f);
    static_cast<int8_t*>(e.out)[idx] =
        saturate_s8(rintf(__fmul_rn(z, e.inv_s_out)), 0.f);
  } else {
    static_cast<int8_t*>(e.out)[idx] = requant_join(
        acc, alpha, beta, load_res(e, idx), e.res_scale, e.inv_s_out);
  }
}

__host__ __device__ constexpr bool extra_mode(int mode, int res_type) {
  return mode == kJoinS8 || mode == kF32Sum ||
         (mode == kJoin && res_type != kResS8);
}

template <class T, bool kExtra>
__device__ __forceinline__ void store_tile(const Epilogue& e, int M, int N,
                                           int m0, int n0, int wm0, int wn0,
                                           int lane,
                                           const int (&acc)[T::MT][T::NT][4]) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm0 + i * 16 + g + ((r & 2) ? 8 : 0);
        const int col = n0 + wn0 + j * 8 + t2 + (r & 1);
        if (row < M && col < N) {
          const int64_t idx = static_cast<int64_t>(row) * N + col;
          if (kExtra) {
            epilogue_extra(e, idx, col, acc[i][j][r]);
          } else {
            epilogue_store(e, idx, col, acc[i][j][r]);
          }
        }
      }
}

// The block's K loop over two shared-memory stages. `fetch_a(p, k)`
// returns the 16 A bytes of this thread's row in load pass p (row
// r0 + 64p of the block tile, r0 = tid / 4) from column k on; B is a
// K-major [N, K] matrix. Leaves the block's products in `acc`.
template <class T, class FetchA>
__device__ __forceinline__ void mainloop(const FetchA& fetch_a,
                                         const int8_t* __restrict__ Bt,
                                         int N, int K, int n0, bool vec_b,
                                         int8_t* As, int8_t* Bs,
                                         int (&acc)[T::MT][T::NT][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % T::WARPS_M) * T::WM;
  const int wn0 = (warp / T::WARPS_M) * T::WN;
  const int r0 = tid >> 2, kc = (tid & 3) * 16;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  int4 ra[T::A_PASSES], rb[T::B_PASSES];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < T::A_PASSES; ++p) ra[p] = fetch_a(p, k0 + kc);
#pragma unroll
    for (int p = 0; p < T::B_PASSES; ++p)
      rb[p] = fetch_row_chunk(Bt, N, K, n0 + r0 + 64 * p, k0 + kc, vec_b);
  };
  auto stash = [&](int stage) {
    int8_t* a = As + stage * (T::BM * LDS);
    int8_t* b = Bs + stage * (T::BN * LDS);
#pragma unroll
    for (int p = 0; p < T::A_PASSES; ++p)
      *reinterpret_cast<int4*>(a + (r0 + 64 * p) * LDS + kc) = ra[p];
#pragma unroll
    for (int p = 0; p < T::B_PASSES; ++p)
      *reinterpret_cast<int4*>(b + (r0 + 64 * p) * LDS + kc) = rb[p];
  };
  const int steps = (K + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) fetch((s + 1) * BK);
    warp_mma<T>(As + cur * (T::BM * LDS), Bs + cur * (T::BN * LDS), wm0, wn0,
                lane, acc);
    if (s + 1 < steps) stash(cur ^ 1);
    __syncthreads();
  }
}

// Writes the block's tile through the epilogue (epilogue_extra's modes
// under kExtra).
template <class T, bool kExtra>
__device__ __forceinline__ void finish(const Epilogue& e, int M, int N,
                                       int m0, int n0,
                                       const int (&acc)[T::MT][T::NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  store_tile<T, kExtra>(e, M, N, m0, n0, (warp % T::WARPS_M) * T::WM,
                        (warp / T::WARPS_M) * T::WN, lane, acc);
}

inline bool epilogue_ok(const Epilogue& e) {
  if (e.mode < 0 || e.mode >= kModes || e.out == nullptr) return false;
  if (e.mode != kS32 && (e.alpha == nullptr || e.beta == nullptr))
    return false;
  if (is_join(e.mode) && (e.res == nullptr || e.res_type < 0 ||
                          e.res_type >= kResTypes))
    return false;
  return true;
}

}  // namespace ursonet_int8
