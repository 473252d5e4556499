// Shared pieces of the int8 kernels (int8_gemm.cu, int8_conv.cu): the
// s8 x s8 -> s32 tensor-core tile loop and the fused epilogues.
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
// This is the arithmetic XLA compiles the JAX package's Int8Ops into
// (measured on the CPU against the whole model): it contracts
// acc * alpha + beta into an FMA but adds the dequantized residual
// separately, and turns y / s_out with a constant s_out into
// y * f32(1 / s_out), so inv_s_out is that f32 reciprocal. The file is
// built with -fmad=false, so the one FMA is the explicit one. rintf
// rounds half to even, as jnp.round and torch.round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ursonet_int8 {

constexpr int kThreads = 256;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes

enum Mode { kS32 = 0, kF32 = 1, kF32Relu = 2, kQ8Relu = 3, kQ8 = 4,
            kJoin = 5, kModes = 6 };

struct Epilogue {
  int mode;
  const float* alpha;   // [N]
  const float* beta;    // [N]
  float inv_s_out;
  const int8_t* res;    // [M, N], join only
  float res_scale;
  void* out;            // [M, N]: int32, float or int8 by mode
};

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

__device__ __forceinline__ void epilogue_store(const Epilogue& e,
                                               int64_t idx, int n, int acc) {
  if (e.mode == kS32) {
    static_cast<int32_t*>(e.out)[idx] = acc;
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
        saturate_s8(rintf(__fmul_rn(fmaxf(y, 0.f), e.inv_s_out)), 0.f);
  } else if (e.mode == kQ8) {
    static_cast<int8_t*>(e.out)[idx] =
        saturate_s8(rintf(__fmul_rn(y, e.inv_s_out)), -127.f);
  } else {  // kJoin
    const float r = __fmul_rn(__int2float_rn(static_cast<int>(e.res[idx])),
                              e.res_scale);
    const float z = fmaxf(__fadd_rn(y, r), 0.f);
    static_cast<int8_t*>(e.out)[idx] =
        saturate_s8(rintf(__fmul_rn(z, e.inv_s_out)), 0.f);
  }
}

template <class T>
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
          epilogue_store(e, static_cast<int64_t>(row) * N + col, col,
                         acc[i][j][r]);
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

// Writes the block's tile through the epilogue.
template <class T>
__device__ __forceinline__ void finish(const Epilogue& e, int M, int N,
                                       int m0, int n0,
                                       const int (&acc)[T::MT][T::NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  store_tile<T>(e, M, N, m0, n0, (warp % T::WARPS_M) * T::WM,
                (warp / T::WARPS_M) * T::WN, lane, acc);
}

inline bool epilogue_ok(const Epilogue& e) {
  if (e.mode < 0 || e.mode >= kModes || e.out == nullptr) return false;
  if (e.mode != kS32 && (e.alpha == nullptr || e.beta == nullptr))
    return false;
  if (e.mode == kJoin && e.res == nullptr) return false;
  return true;
}

}  // namespace ursonet_int8
