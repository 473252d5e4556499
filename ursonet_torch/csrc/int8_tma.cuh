// The TMA + wgmma route of gemm_s8 and conv_s8: one persistent,
// warp-specialized kernel with two producers (int8_gemm.cu: A by TMA;
// int8_conv.cu: A gathered from the NHWC input by cp.async).
//
// out[M, N] = epilogue(A[M, K] s8 @ Bt[N, K]^T s8), s32 accumulation.
//
// Blocks. One block per SM (or fewer), 384 threads: warpgroup 0 loads,
// warpgroups 1 and 2 multiply 64 rows each of a 128 x BN output tile
// (BN = 64, 128 or 256). A block walks the work items
// item = blockIdx.x, + gridDim.x, ...; item = tile * splits + split,
// tile = m_tile * n_tiles + n_tile, so the blocks running together share
// A row-tiles through L2.
//
// Pipeline. K advances in stages of 128 bytes: A [128 rows][128 B] and
// Bt [BN rows][128 B] in the 128-byte swizzle, in a ring of `stages`
// slots guarded by full / empty mbarriers. The ring runs across tiles,
// so the next tiles' loads fly while this tile's epilogue runs (with
// K = 64 a tile is a single stage). When all of Bt fits beside the ring
// (`resident`) it is loaded once per block and the ring carries A alone.
// Out-of-bounds rows and K bytes arrive as zeros (TMA fill, cp.async
// zero fill), so ragged M, N and K need no special case.
//
// Epilogue. Each consumer warpgroup applies the epilogue of
// int8_common.cuh (in the f32 or the bf16 mode, a template flag of the
// kernel: the two modes are separate instantiations) to its
// accumulators in registers and writes the
// results into its half of an output buffer in shared memory, in boxes
// of [64 rows][128 B] (64 B when BN = 64 int8) swizzled so the fragment
// stores hit distinct banks; one thread then issues TMA stores: whole
// 128-byte lines whatever the output type, clipped to M and N by the
// hardware. alpha and beta of the tile's columns are staged in shared
// memory once per n-tile. `bufs` output buffers rotate, so a tile's
// store overlaps the next tile's products. In the join modes (`join`,
// `join_s8`) the producer TMA-loads the residual tile beforehand
// (res_full / res_empty mbarriers): an int8 one into the output buffer,
// which the epilogue transforms in place, a float one (f32 or bf16) into
// a slot of its own beside each buffer, in boxes of [64 rows][128 B]
// like the output's, which the epilogue reads.
//
// Split K (`splits` > 1, for outputs of few rows): each item multiplies
// ksteps / splits stages and writes its s32 partial sums to `partial`;
// the last warpgroup to arrive at a tile half (one counter each,
// __threadfence) sums the partials in split order and applies the
// epilogue, so the bits are the same on every run.

#pragma once

#include "hopper.cuh"
#include "int8_common.cuh"

namespace ursonet_int8 {
namespace tma {

constexpr int kBM = 128;          // rows of a tile: 64 per consumer warpgroup
constexpr int kBK = 128;          // bytes of K in a stage: one swizzle row
constexpr int kThreadsTma = 384;
constexpr int kAStage = kBM * kBK;
constexpr int kMaxStages = 4, kMaxBufs = 3;
constexpr int kSmemLimit = 232448;   // 227 KB a block on sm_90

struct ConvGeom {
  int H, W, C, OH, OW, KH, KW, stride, pad_t, pad_l;
};

struct Params {
  int M, N, K;          // K in bytes of depth (conv: KH * KW * C)
  int n_tiles, items;   // items = m_tiles * n_tiles * splits
  int ksteps, splits;   // stages of K in all; splits divides ksteps
  int stages, bufs, resident;
  int mode, bf16, out_bytes;  // bf16: the accumulation mode
  int res_type;         // the joins: ResType of the residual
  int res_bytes;        // bytes of a float residual's element, else 0
  const float* alpha;
  const float* beta;
  float inv_s_out, res_scale;
  int32_t* partial;     // [splits, M, N], splits > 1 only
  int* counters;        // [tiles * 2] zeros, splits > 1 only
  const int8_t* X;      // conv only: the NHWC input
  ConvGeom g;
};

// Bytes of an output element: f32 and f32_relu write bf16 in the bf16
// mode, f32_sum f32 in both.
__host__ __device__ constexpr int out_bytes_of(int mode, int bf16) {
  return (mode == kS32 || mode == kF32Sum) ? 4
         : (mode == kF32 || mode == kF32Relu) ? (bf16 ? 2 : 4) : 1;
}

// Bytes of one box row of the output buffer.
__host__ __device__ constexpr int inner_bytes(int bn, int out_bytes) {
  return bn * out_bytes < 128 ? 64 : 128;
}

// Dynamic shared memory of a launch: alignment slack, ring, resident Bt,
// output buffers and the float residual's slots, alpha / beta of both
// warpgroups, barriers and flags.
inline long long smem_bytes(int bn, int out_bytes, int stages, int bufs,
                            int resident, int ksteps, int n_tiles,
                            int res_bytes) {
  const long long stage = kAStage + (resident ? 0 : bn * kBK);
  const long long bres =
      resident ? static_cast<long long>(ksteps) * n_tiles * bn * kBK : 0;
  return 1024 + stages * stage + bres +
         static_cast<long long>(bufs) * kBM * bn * (out_bytes + res_bytes) +
         16 * bn + 256;
}

// Layout of an output box in shared memory: byte `b` of row `r` lies at
// x ^ (((x >> 7) & (INNER == 128 ? 7 : 3)) << 4), x = r * INNER + b:
// rows of INNER bytes whose 16-byte chunks are XORed with the 128-byte
// line index, the 128-byte (INNER = 128) and 64-byte (INNER = 64)
// swizzles of the boxes' tensor maps (int8_cuda.out_box_offset mirrors
// it).

// float(v) of a byte's value, exact.
__device__ __forceinline__ float s8_to_float(uint32_t byte) {
  return __int2float_rn(static_cast<int8_t>(byte));
}

// Two s32 clipped to 0..255 (u8) or -128..127 (s8) and packed into the
// low 16 bits, `lo` in the lower byte.
__device__ __forceinline__ uint32_t pack_sat_u8(int lo, int hi) {
  uint32_t d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(hi), "r"(lo), "r"(0));
  return d;
}

__device__ __forceinline__ uint32_t pack_sat_s8(int lo, int hi) {
  uint32_t d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(hi), "r"(lo), "r"(0));
  return d;
}

// clip(rint(x), 0, 127) of two floats as two int8 in 16 bits. The
// conversion rounds half to even as rintf does, and rounding commutes
// with clipping to integer bounds, so the bits equal
// saturate_s8(rintf(x), 0) of int8_common.cuh.
__device__ __forceinline__ uint32_t requant_pair_relu(float x0, float x1) {
  return __vminu4(pack_sat_u8(__float2int_rn(x0), __float2int_rn(x1)),
                  0x7f7fu);
}

// clip(rint(x), -127, 127) likewise: saturate_s8(rintf(x), -127).
__device__ __forceinline__ uint32_t requant_pair(float x0, float x1) {
  return __vmaxs4(pack_sat_s8(__float2int_rn(x0), __float2int_rn(x1)),
                  0x81818181u);
}

// Applies the epilogue MODE to a warpgroup's accumulators and writes the
// results into its half of the output buffer (`join`, `join_s8`: over
// the int8 residual that waits there, or reading the float residual of
// type RT from its slot `rhalf`), in the bf16 mode when BF16. `ab2` holds
// (alpha, beta) per tile column (rounded to bf16 in the bf16 mode). Loads
// are batched ahead of the stores in groups of 4 column blocks: the
// stores may alias them for all the compiler knows.
//
// Where the pair (row r + 8h, columns 8j + q2, + 1) of this thread lies:
// the layout above at row r + 8h of box (8j + q2) * OB / INNER, with b
// the pair's byte in the box row. r % 8 (and (r / 2) % 4 for 64-byte rows)
// is the same for h = 0 and 1, and 8j * OB splits into a chunk part CJ
// and a low part LJ known at compile time, so the offset is
// r * INNER + ((x0 ^ CJ) + LJ) + constants, with x0 = the thread's own
// chunk bit XOR the row's swizzle, and its low bytes. The float
// residual's slot has the same layout with RB-byte elements.
template <int MODE, int BN, bool BF16, int RT = kResS8>
__device__ __forceinline__ void epilogue_to_smem(const Params& p,
                                                 const int (&acc)[BN / 2],
                                                 uint8_t* half,
                                                 const uint8_t* rhalf,
                                                 const float2* ab2, int warp,
                                                 int lane) {
  constexpr int OB = out_bytes_of(MODE, BF16);
  constexpr bool JOIN = is_join(MODE);
  constexpr bool RES_FLOAT = JOIN && RT != kResS8;
  constexpr int RB = res_type_bytes(RT);
  // join's residual product takes res_scale rounded to bf16 in the bf16
  // mode; join_s8's is an f32 product in both modes
  const float res_scale =
      (BF16 && MODE == kJoin) ? bf_round(p.res_scale) : p.res_scale;
  constexpr int INNER = inner_bytes(BN, OB);
  constexpr int RINNER = inner_bytes(BN, RB);
  constexpr int G = 4;
  constexpr int kRowH = 8 * INNER;    // from row r to row r + 8
  constexpr int kRRowH = 8 * RINNER;
  const int r = warp * 16 + (lane >> 2), q2 = (lane & 3) * 2;
  const int tb = q2 * OB, rtb = q2 * RB;
  const int rc = INNER == 128 ? (r & 7) : ((r >> 1) & 3);
  const int rrc = RINNER == 128 ? (r & 7) : ((r >> 1) & 3);
  const int x0 = (((tb >> 4) ^ rc) << 4) | (tb & 15);
  const int rx0 = (((rtb >> 4) ^ rrc) << 4) | (rtb & 15);
  uint8_t* row0 = half + r * INNER;
  const uint8_t* rrow0 = rhalf + r * RINNER;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += G) {
    float4 ab[G];
    uint32_t rr[G][2];
    float2 rf[G][2];
    uint8_t* dst[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int jb = 8 * (j0 + g) * OB;
      const int box = jb / INNER, cj = (jb % INNER) & ~15, lj = jb & 15;
      dst[g] = row0 + box * (64 * INNER) + ((x0 ^ cj) + lj);
      if (MODE != kS32)
        ab[g] = *reinterpret_cast<const float4*>(ab2 + 8 * (j0 + g) + q2);
      if (JOIN && !RES_FLOAT) {
        rr[g][0] = *reinterpret_cast<const uint16_t*>(dst[g]);
        rr[g][1] = *reinterpret_cast<const uint16_t*>(dst[g] + kRowH);
      }
      if (RES_FLOAT) {
        const int rjb = 8 * (j0 + g) * RB;
        const int rbox = rjb / RINNER, rcj = (rjb % RINNER) & ~15;
        const uint8_t* src =
            rrow0 + rbox * (64 * RINNER) + ((rx0 ^ rcj) + (rjb & 15));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (RT == kResF32) {
            rf[g][h] = *reinterpret_cast<const float2*>(src + h * kRRowH);
          } else {  // a bf16 pair, the first column in the low half
            const uint32_t v =
                *reinterpret_cast<const uint32_t*>(src + h * kRRowH);
            rf[g][h] = make_float2(__uint_as_float(v << 16),
                                   __uint_as_float(v & 0xffff0000u));
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // ab[g] = (alpha[col], beta[col], alpha[col + 1], beta[col + 1])
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a0 = acc[4 * (j0 + g) + 2 * h];
        const int a1 = acc[4 * (j0 + g) + 2 * h + 1];
        uint8_t* out = dst[g] + h * kRowH;
        if (MODE == kS32) {
          *reinterpret_cast<int2*>(out) = make_int2(a0, a1);
          continue;
        }
        // s: the sum before the bf16 mode's last rounding (q8, join_s8
        // and f32_sum use it)
        float s0, s1, y0, y1;
        if (BF16) {
          bf16_sum2(a0, a1, ab[g].x, ab[g].y, ab[g].z, ab[g].w, s0, s1);
          y0 = s0;
          y1 = s1;
          bf_round2(y0, y1);
        } else {
          s0 = y0 = __fmaf_rn(__int2float_rn(a0), ab[g].x, ab[g].y);
          s1 = y1 = __fmaf_rn(__int2float_rn(a1), ab[g].z, ab[g].w);
        }
        if (MODE == kF32Sum) {
          *reinterpret_cast<float2*>(out) = make_float2(s0, s1);
          continue;
        }
        if (MODE == kF32 || MODE == kF32Relu) {
          if (MODE == kF32Relu) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          if (BF16) {  // y0 and y1 are bf16 values: their high halves
            *reinterpret_cast<uint32_t*>(out) = bf16_pair(y0, y1);
          } else {
            *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
          }
          continue;
        }
        // f32(res) of the pair
        float v0 = 0.f, v1 = 0.f;
        if (RES_FLOAT) {
          v0 = rf[g][h].x;
          v1 = rf[g][h].y;
        } else if (JOIN) {
          v0 = s8_to_float(rr[g][h] & 0xffu);
          v1 = s8_to_float(rr[g][h] >> 8);
        }
        uint32_t o;
        if (MODE == kQ8) {
          o = requant_pair(__fmul_rn(s0, p.inv_s_out),
                           __fmul_rn(s1, p.inv_s_out));
        } else if (MODE == kJoinS8) {
          // two integers on the output grid, added exactly
          o = requant_pair_relu(
              __fadd_rn(rintf(__fmul_rn(s0, p.inv_s_out)),
                        rintf(__fmul_rn(v0, res_scale))),
              __fadd_rn(rintf(__fmul_rn(s1, p.inv_s_out)),
                        rintf(__fmul_rn(v1, res_scale))));
        } else {
          if (MODE == kJoin) {  // the residual product and the sum each rounded
            const float r0 = __fmul_rn(v0, res_scale);
            const float r1 = __fmul_rn(v1, res_scale);
            if (BF16) {
              float z0 = r0, z1 = r1;
              bf_round2(z0, z1);
              y0 = __fadd_rn(y0, z0);
              y1 = __fadd_rn(y1, z1);
              bf_round2(y0, y1);
            } else {
              y0 = __fadd_rn(y0, r0);
              y1 = __fadd_rn(y1, r1);
            }
          }
          o = requant_pair_relu(__fmul_rn(fmaxf(y0, 0.f), p.inv_s_out),
                                __fmul_rn(fmaxf(y1, 0.f), p.inv_s_out));
        }
        *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(o);
      }
    }
  }
}

// The join modes' epilogue on the residual type of this launch: a float
// residual (f32 beside 64-wide tiles, bf16 beside tiles up to 128 wide:
// what the host's plan allows) or an int8 one.
template <int MODE, int BN, bool BF16>
__device__ __forceinline__ void join_to_smem(const Params& p,
                                             const int (&acc)[BN / 2],
                                             uint8_t* half,
                                             const uint8_t* rhalf,
                                             const float2* ab2, int warp,
                                             int lane) {
  if constexpr (BN == 64) {
    if (p.res_type == kResF32) {
      epilogue_to_smem<MODE, BN, BF16, kResF32>(p, acc, half, rhalf, ab2,
                                                warp, lane);
      return;
    }
  }
  if constexpr (BN <= 128) {
    if (p.res_type == kResBf16) {
      epilogue_to_smem<MODE, BN, BF16, kResBf16>(p, acc, half, rhalf, ab2,
                                                 warp, lane);
      return;
    }
  }
  epilogue_to_smem<MODE, BN, BF16, kResS8>(p, acc, half, rhalf, ab2, warp,
                                           lane);
}

// kExtra: the instantiation of the modes extra_mode names (join_s8,
// f32_sum, and `join` over a float residual); the others compile without
// them, so their kernels keep the code, and the speed, they had without.
template <int BN, bool kConv, bool kBf16, bool kExtra>
__global__ void __launch_bounds__(kThreadsTma, 1)
tma_s8_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_out,
              const __grid_constant__ CUtensorMap map_res, const Params p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const int stage_bytes = kAStage + (p.resident ? 0 : BN * kBK);
  const int bres_bytes = p.resident ? p.ksteps * p.n_tiles * BN * kBK : 0;
  const int buf_bytes = kBM * BN * p.out_bytes;
  const int slot_bytes = kBM * BN * p.res_bytes;   // a float residual's
  uint8_t* ring = sm;
  uint8_t* bres = ring + p.stages * stage_bytes;
  uint8_t* bufs = bres + bres_bytes;
  uint8_t* slots = bufs + p.bufs * buf_bytes;
  float* ab_all = reinterpret_cast<float*>(slots + p.bufs * slot_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ab_all + 4 * BN);
  const uint32_t full = smem_u32(bars), empty = full + 8 * kMaxStages;
  const uint32_t res_full = empty + 8 * kMaxStages;
  const uint32_t res_empty = res_full + 8 * kMaxBufs;
  const uint32_t b_full = res_empty + 8 * kMaxBufs;
  volatile int* flags =
      reinterpret_cast<volatile int*>(bars + 2 * kMaxStages + 2 * kMaxBufs + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      // conv: 128 gather threads arrive beside the thread that loads Bt
      mbar_init(full + 8 * s, kConv ? 129 : 1);
      mbar_init(empty + 8 * s, 8);          // one per consumer warp
    }
    for (int b = 0; b < kMaxBufs; ++b) {
      mbar_init(res_full + 8 * b, 1);
      mbar_init(res_empty + 8 * b, 2);      // one per consumer warpgroup
    }
    mbar_init(b_full, 1);
    fence_barrier_init();
    fence_proxy_async();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int kps = p.ksteps / p.splits;
  constexpr int INNER1 = inner_bytes(BN, 1);

  // Registers: the block starts with 384 x 168; the producer warpgroup
  // gives up what the two consumer warpgroups take (40 + 2 x 232 =
  // 56 + 2 x 224 = 504 = 3 x 168: setmaxnreg.inc waits for registers of
  // the block's own pool).
  if (wg == 0) {
    // ===================== producer warpgroup =====================
    setmaxnreg_dec<kConv ? 56 : 40>();
    const int tid = threadIdx.x;
    if (!kConv && tid != 0) return;
    if (tid == 0 && p.resident) {
      mbar_arrive_expect_tx(b_full, bres_bytes);
      for (int ks = 0; ks < p.ksteps; ++ks)
        for (int nt = 0; nt < p.n_tiles; ++nt)
          tma_load_2d(smem_u32(bres) + (ks * p.n_tiles + nt) * (BN * kBK),
                      &map_b, b_full, ks * kBK, nt * BN);
    }
    // conv: this thread gathers 16-byte chunk `chunk` of rows
    // r0 + 16 i, i < 8, of every A stage
    const int chunk = tid & 7, r0 = tid >> 3;
    const uint32_t a_dst0 = r0 * kBK + ((chunk ^ (r0 & 7)) << 4);
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++it) {
      const int tile = item / p.splits, split = item - tile * p.splits;
      const int mt = tile / p.n_tiles, nt = tile - mt * p.n_tiles;
      const int m0 = mt * kBM, n0 = nt * BN;
      if (tid == 0 && (kExtra ? is_join(p.mode) : p.mode == kJoin)) {
        // an int8 residual into the output buffer, a float one into its
        // slot, in boxes of 64 rows of INNER1 (int8) or 128 bytes
        const int b = it % p.bufs;
        const bool flt = kExtra && p.res_bytes != 0;
        const int rb = flt ? p.res_bytes : 1;
        const int inner = flt ? 128 : INNER1;
        mbar_wait(res_empty + 8 * b, ((it / p.bufs) & 1) ^ 1);
        mbar_arrive_expect_tx(res_full + 8 * b, kBM * BN * rb);
        const uint32_t dst = flt ? smem_u32(slots) + b * slot_bytes
                                 : smem_u32(bufs) + b * buf_bytes;
        for (int c = 0; c < 2; ++c)
          for (int box = 0; box < BN * rb / inner; ++box)
            tma_load_2d(dst + c * (64 * BN * rb) + box * (64 * inner),
                        &map_res, res_full + 8 * b, n0 * rb + box * inner,
                        m0 + 64 * c);
      }
      // conv: per row, the offset of its top-left tap and the set of
      // taps that lie inside the image (bit ky * KW + kx); the rows of a
      // thread lie 16 apart, so one division per tile and steps after it
      int off[8];
      uint32_t taps[8];
      int cin = 0, tap = 0, ky = 0, kx = 0;
      if (kConv) {
        const int m = m0 + r0;
        int b = m / (p.g.OH * p.g.OW);
        const int rem = m - b * (p.g.OH * p.g.OW);
        int oy = rem / p.g.OW, ox = rem - oy * p.g.OW;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int iy0 = oy * p.g.stride - p.g.pad_t;
          const int ix0 = ox * p.g.stride - p.g.pad_l;
          off[i] = ((b * p.g.H + iy0) * p.g.W + ix0) * p.g.C;
          uint32_t vx = 0, t = 0;
          for (int x = 0; x < p.g.KW; ++x)
            if (static_cast<unsigned>(ix0 + x) < static_cast<unsigned>(p.g.W))
              vx |= 1u << x;
          for (int y = 0; y < p.g.KH; ++y)
            if (static_cast<unsigned>(iy0 + y) < static_cast<unsigned>(p.g.H))
              t |= vx << (y * p.g.KW);
          taps[i] = m + 16 * i < p.M ? t : 0u;
          ox += 16;
          while (ox >= p.g.OW) {
            ox -= p.g.OW;
            if (++oy == p.g.OH) {
              oy = 0;
              ++b;
            }
          }
        }
        // this thread's chunk of the first stage: K runs over (ky, kx, c)
        tap = (chunk * 16) / p.g.C;
        cin = chunk * 16 - tap * p.g.C;
        ky = tap / p.g.KW;
        kx = tap - ky * p.g.KW;
      }
      for (int ks = split * kps; ks < (split + 1) * kps; ++ks) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t a_dst = smem_u32(ring) + stage * stage_bytes;
        if (tid == 0) {
          if (kConv && p.resident) {
            mbar_arrive(full + 8 * stage);
          } else {
            mbar_arrive_expect_tx(full + 8 * stage,
                                  kConv ? BN * kBK : stage_bytes);
          }
          if (!kConv) tma_load_2d(a_dst, &map_a, full + 8 * stage, ks * kBK, m0);
          if (!p.resident)
            tma_load_2d(a_dst + kAStage, &map_b, full + 8 * stage, ks * kBK, n0);
        }
        if (kConv) {
          // C % 16 == 0: the 16-byte chunk lies inside one tap
          const int tap_off = (ky * p.g.W + kx) * p.g.C + cin;
          const uint32_t tap_bit =
              ks * kBK + chunk * 16 < p.K ? 1u << tap : 0u;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool ok = (taps[i] & tap_bit) != 0;
            const int8_t* src = p.X + (ok ? off[i] + tap_off : 0);
            cp_async_16_zfill(a_dst + a_dst0 + i * (16 * kBK), src,
                              ok ? 16u : 0u);
          }
          // the next stage lies 128 bytes of K on: step the tap
          cin += kBK;
          while (cin >= p.g.C) {
            cin -= p.g.C;
            ++tap;
            if (++kx == p.g.KW) {
              kx = 0;
              ++ky;
            }
          }
          cp_async_arrive_noinc(full + 8 * stage);
        }
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ===================== consumer warpgroups =====================
    setmaxnreg_inc<kConv ? 224 : 232>();
    const int c = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    float2* ab = reinterpret_cast<float2*>(ab_all) + c * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // The waits poll per thread: __syncwarp() after each brings the warp
    // back together for the .aligned instructions (wgmma, bar.sync).
    if (p.resident) mbar_wait(b_full, 0);
    __syncwarp();
    int stage = 0, it = 0, ab_n0 = -1;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int tile = item / p.splits, split = item - tile * p.splits;
      const int mt = tile / p.n_tiles, nt = tile - mt * p.n_tiles;
      const int m0 = mt * kBM, n0 = nt * BN;
      const int ks0 = split * kps;
      // One stage's wgmmas stay in flight while the next stage's are
      // issued; a stage is handed back once the group after it has been
      // committed and the wait lets at most that one remain.
      int prev = -1;
      for (int ks = ks0; ks < ks0 + kps; ++ks) {
        mbar_wait(full + 8 * stage, phase);
        __syncwarp();
        // conv: cp.async wrote A through the generic proxy and wgmma
        // reads it through the async proxy. The fence stands on the
        // reader's side: the PTX memory model orders two accesses through
        // different proxies when a proxy fence lies on the causality path
        // between them, here write -> the barrier's completion -> this
        // thread's wait -> fence -> wgmma. A writer-side fence needs the
        // producer to wait for its own copies (cp.async.wait_group) before
        // it arrives, a stage late: bit-identical and slower on every
        // served conv when it was tried.
        if (kConv) fence_proxy_async();
        const uint32_t st = smem_u32(ring) + stage * stage_bytes;
        const uint32_t a_addr = st + c * (64 * kBK);
        const uint32_t b_addr =
            p.resident ? smem_u32(bres) + (ks * p.n_tiles + nt) * (BN * kBK)
                       : st + kAStage;
        // all four k32 steps of the stage: bytes past K are zeros
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_s8<BN>(acc, wgmma_desc_sw128(a_addr + 32 * kk),
                       wgmma_desc_sw128(b_addr + 32 * kk),
                       (ks != ks0 || kk != 0) ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_registers(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      const int r = warp * 16 + (lane >> 2), q2 = (lane & 3) * 2;
      if (p.splits > 1) {
        // partial sums out; the last warpgroup at this tile half sums
        // them in split order
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 64 * c + r + 8 * h, col = n0 + 8 * j + q2;
            if (row < p.M && col < p.N) {
              *reinterpret_cast<int2*>(
                  p.partial +
                  (static_cast<int64_t>(split) * p.M + row) * p.N + col) =
                  make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          }
        __threadfence();
        named_barrier(1 + c, 128);
        if (tid == 0) {
          flags[c] = atomicAdd(p.counters + 2 * tile + c, 1) == p.splits - 1;
        }
        named_barrier(1 + c, 128);
        if (!flags[c]) continue;
        __threadfence();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        // every load is issued whether or not its element exists, so the
        // loads of a split fly together
        for (int s = 0; s < p.splits; ++s) {
          const int32_t* ps = p.partial + static_cast<int64_t>(s) * p.M * p.N;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m0 + 64 * c + r + 8 * h, col = n0 + 8 * j + q2;
              const bool in = row < p.M && col < p.N;
              const int2 v = __ldcg(reinterpret_cast<const int2*>(
                  in ? ps + static_cast<int64_t>(row) * p.N + col : ps));
              acc[4 * j + 2 * h] += in ? v.x : 0;
              acc[4 * j + 2 * h + 1] += in ? v.y : 0;
            }
        }
      }

      bool sync = false;
      if (p.mode != kS32 && n0 != ab_n0) {
        for (int i = tid; i < BN; i += 128) {
          const bool in = n0 + i < p.N;
          float a = in ? __ldg(p.alpha + n0 + i) : 0.f;
          float be = in ? __ldg(p.beta + n0 + i) : 0.f;
          if (kBf16) {
            a = bf_round(a);
            be = bf_round(be);
          }
          ab[i] = make_float2(a, be);
        }
        ab_n0 = n0;
        sync = true;
      }
      const int b = it % p.bufs;
      const bool join = kExtra ? is_join(p.mode) : p.mode == kJoin;
      if (join) {
        mbar_wait(res_full + 8 * b, (it / p.bufs) & 1);
        __syncwarp();
      } else {
        // the store that last read this buffer must have finished with it
        if (tid == 0) {
          if (p.bufs == 1) bulk_wait_read<0>();
          else if (p.bufs == 2) bulk_wait_read<1>();
          else bulk_wait_read<2>();
        }
        sync = true;
      }
      if (sync) named_barrier(1 + c, 128);
      uint8_t* half = bufs + b * buf_bytes + c * (64 * BN * p.out_bytes);
      const uint8_t* rhalf =
          slots + b * slot_bytes + c * (64 * BN * p.res_bytes);
      if constexpr (kExtra) {
        switch (p.mode) {
          case kF32Sum:
            if constexpr (BN <= 128)
              epilogue_to_smem<kF32Sum, BN, kBf16>(p, acc, half, rhalf, ab,
                                                   warp, lane);
            break;
          case kJoinS8:
            join_to_smem<kJoinS8, BN, kBf16>(p, acc, half, rhalf, ab, warp,
                                             lane);
            break;
          default:  // kJoin over a float residual
            join_to_smem<kJoin, BN, kBf16>(p, acc, half, rhalf, ab, warp,
                                           lane);
        }
      } else {
        switch (p.mode) {
          case kS32:
            if constexpr (BN <= 128)
              epilogue_to_smem<kS32, BN, kBf16>(p, acc, half, rhalf, ab,
                                                warp, lane);
            break;
          case kF32:
            if constexpr (BN <= 128)
              epilogue_to_smem<kF32, BN, kBf16>(p, acc, half, rhalf, ab,
                                                warp, lane);
            break;
          case kF32Relu:
            if constexpr (BN <= 128)
              epilogue_to_smem<kF32Relu, BN, kBf16>(p, acc, half, rhalf, ab,
                                                    warp, lane);
            break;
          case kQ8Relu:
            epilogue_to_smem<kQ8Relu, BN, kBf16>(p, acc, half, rhalf, ab,
                                                 warp, lane);
            break;
          case kQ8:
            epilogue_to_smem<kQ8, BN, kBf16>(p, acc, half, rhalf, ab, warp,
                                             lane);
            break;
          default:  // kJoin over an int8 residual
            epilogue_to_smem<kJoin, BN, kBf16>(p, acc, half, rhalf, ab, warp,
                                               lane);
        }
      }
      fence_proxy_async();
      named_barrier(1 + c, 128);
      if (tid == 0) {
        const int inner = inner_bytes(BN, p.out_bytes);
        if (m0 + 64 * c < p.M) {
          for (int box = 0; box * inner < BN * p.out_bytes; ++box) {
            const int c0 = n0 * p.out_bytes + box * inner;
            if (c0 < p.N * p.out_bytes)
              tma_store_2d(&map_out, smem_u32(half) + box * (64 * inner), c0,
                           m0 + 64 * c);
          }
        }
        bulk_commit();
        if (join) {
          // hand the buffers whose stores have read them back to the
          // producer: this one at once if it is the only one, else the
          // previous tile's
          if (p.bufs == 1) {
            bulk_wait_read<0>();
            mbar_arrive(res_empty + 8 * b);
          } else {
            bulk_wait_read<1>();
            if (it > 0) mbar_arrive(res_empty + 8 * ((it - 1) % p.bufs));
          }
        }
      }
      ++it;
    }
    if (tid == 0) bulk_wait_read<0>();
  }
}

// Launches the route. `a` is null for the conv (A is gathered from p.X).
template <int BN, bool kConv, bool kBf16, bool kExtra>
cudaError_t launch(const int8_t* a, const int8_t* bt, const void* res,
                   void* out, Params p, int grid, cudaStream_t stream) {
  const long long smem =
      smem_bytes(BN, p.out_bytes, p.stages, p.bufs, p.resident, p.ksteps,
                 p.n_tiles, p.res_bytes);
  // a float residual: f32 beside 64-wide tiles, bf16 beside tiles up to
  // 128 wide (join_to_smem instantiates no other)
  const bool res_ok =
      !is_join(p.mode) ||
      (p.res_type == kResS8 && p.res_bytes == 0) ||
      (p.res_type == kResF32 && p.res_bytes == 4 && BN == 64) ||
      (p.res_type == kResBf16 && p.res_bytes == 2 && BN <= 128);
  if (smem > kSmemLimit || p.stages < 1 || p.stages > kMaxStages ||
      p.bufs < 1 || p.bufs > kMaxBufs || p.splits < 1 ||
      p.ksteps % p.splits != 0 || grid < 1 || !res_ok ||
      (BN > 128 && p.out_bytes != 1) ||
      (p.splits > 1 && is_join(p.mode))) {
    return cudaErrorInvalidValue;
  }
  const int ob = p.out_bytes, inner = inner_bytes(BN, ob);
  CUtensorMap map_a, map_b, map_out, map_res;
  const uint64_t M = p.M, N = p.N, K = p.K;
  bool ok = hopper::make_byte_map(&map_b, bt, K, N, K, kBK, BN) &&
            hopper::make_byte_map(&map_out, out, N * ob, M, N * ob, inner, 64);
  ok = ok && (kConv ? hopper::make_byte_map(&map_a, bt, K, N, K, kBK, BN)
                    : hopper::make_byte_map(&map_a, a, K, M, K, kBK, kBM));
  const uint64_t rb = p.res_bytes ? p.res_bytes : 1;
  const int rinner = p.res_bytes ? 128 : inner_bytes(BN, 1);
  ok = ok && (is_join(p.mode)
                  ? hopper::make_byte_map(&map_res, res, N * rb, M, N * rb,
                                          rinner, 64)
                  : hopper::make_byte_map(&map_res, out, N * ob, M, N * ob,
                                          inner, 64));
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tma_s8_kernel<BN, kConv, kBf16, kExtra>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tma_s8_kernel<BN, kConv, kBf16, kExtra>
      <<<grid, kThreadsTma, smem, stream>>>(map_a, map_b, map_out, map_res,
                                            p);
  return cudaGetLastError();
}

template <bool kConv, bool kBf16, bool kExtra>
cudaError_t launch_bn_mode(int bn, const int8_t* a, const int8_t* bt,
                           const void* res, void* out, const Params& p,
                           int grid, cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch<64, kConv, kBf16, kExtra>(a, bt, res, out, p, grid,
                                              stream);
    case 128:
      return launch<128, kConv, kBf16, kExtra>(a, bt, res, out, p, grid,
                                               stream);
    case 256:
      return launch<256, kConv, kBf16, kExtra>(a, bt, res, out, p, grid,
                                               stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kConv>
cudaError_t launch_bn(int bn, const int8_t* a, const int8_t* bt,
                      const void* res, void* out, const Params& p, int grid,
                      cudaStream_t stream) {
  if (extra_mode(p.mode, p.res_type)) {
    return p.bf16 ? launch_bn_mode<kConv, true, true>(bn, a, bt, res, out, p,
                                                      grid, stream)
                  : launch_bn_mode<kConv, false, true>(bn, a, bt, res, out,
                                                       p, grid, stream);
  }
  return p.bf16 ? launch_bn_mode<kConv, true, false>(bn, a, bt, res, out, p,
                                                     grid, stream)
                : launch_bn_mode<kConv, false, false>(bn, a, bt, res, out, p,
                                                      grid, stream);
}

}  // namespace tma
}  // namespace ursonet_int8
