// Tensor-core rate loops for Hopper (sm_90a): acc += A @ B repeated
// `iters` times on operands staged once in shared memory, for s8 x s8 ->
// s32, bf16 x bf16 -> f32 and s4 x s4 -> s32. Bound through a plain C
// interface (ctypes; see ursonet_torch/probes/mma_rate.py).
//
// Replaces the Pallas TPU kernels of tools/probe_int8_mxu.py (`kernel`
// in mxu_probe) and tools/probe_int4_mxu.py (`kernel` in
// pallas_vmem_loop): whole operands in VMEM, a fori_loop that repeats
// one jnp.dot, int4 operands narrowed from int8 once in the prologue. A
// TPU core is one matrix unit fed from one VMEM; an H100 has 132 SMs
// with 227 KB of shared memory each, so the [M, N] output is cut into
// block tiles, each block stages the A rows and B columns of its tile
// (all of K) once, and a replica dimension (blockIdx.y) repeats the whole
// product so that every SM has work. Each replica writes its own
// [M, N] slice of `out`; the rate is replicas * 2*M*N*K * iters / time.
//
// Bound: nothing but the staging reads and one store touches device
// memory, so the loop is bound by the tensor cores' rate. This kernel
// runs mma.sync (m16n8k32 s8, m16n8k16 bf16, m16n8k64 s4) with
// fragments read from shared memory by 32-bit loads, which is short of
// the wgmma rate the data sheet quotes; what it reaches is the
// measurement. The loop cannot be hoisted: the mma is `asm volatile`
// with the accumulator as an in-out operand, and the K loop is not
// unrolled to its end, so the fragment loads stay inside the timed loop
// (the probe checks that the time is linear in `iters`).
//
// Layout. A [M, K] and Bt [N, K] (B's columns as rows) are K-major. In
// shared memory a row holds KB = K * bits / 8 bytes (s4: two values a
// byte, lower k in the low nibble, packed while staging) plus 16 bytes of
// padding, which spreads the fragment loads over all 32 banks. All three
// mma shapes cover 32 bytes of a row per step and place their registers
// alike: with g = lane / 4, t = lane % 4, A registers 0..3 hold rows g,
// g + 8, g, g + 8 at byte 4t, 4t, 4t + 16, 4t + 16 of the step, B
// registers 0, 1 hold column g at byte 4t and 4t + 16, accumulators 0..3
// rows g, g, g + 8, g + 8 and columns 2t, 2t + 1.
//
// The wgmma route (ursonet_mma_rate_wgmma, the default of the wrapper):
// the Hopper form of the same loop, for all three kinds. A block of WGS
// warpgroups (1 or 2) owns a (64 * WGS) x BN output tile; each warpgroup
// multiplies 64 rows of it with wgmma.m64nBNk32 s8 (s8, s4) or
// wgmma.m64nBNk16 bf16, both operands read by descriptors from shared
// memory. Operands are staged once per block into the layout the
// descriptor reads: K-major, 128-byte K-blocks (K * bytes a multiple of
// 128), 16-byte chunk c of row r at chunk c ^ (r % 8), blocks of `rows` x
// 128 bytes. s4 has no wgmma form: its values (the low nibble
// of each int8) are sign-extended to s8 while staging, so the s8 loop
// computes the same int32 sums bit for bit. Each iteration issues the
// K / k-step wgmmas of the whole depth as one commit group and waits only
// for the previous group, so one group is always queued behind the one
// the tensor cores run. The loop is not hoisted: every wgmma is
// `asm volatile` with the accumulators as in-out operands, and `iters` is
// a run-time count (the probe checks that the time is linear in it). All
// of K stays resident, so the tile shrinks as K grows
// (probes/mma_rate.py::tile_for).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ursonet_rate {
namespace {

constexpr int kThreads = 256;          // 8 warps: 2 along M, 4 along N
constexpr int kPad = 16;
constexpr int kSmemMax = 232448;       // 227 KB a block

enum Kind { kS8 = 0, kBf16 = 1, kS4 = 2 };

template <int KIND> struct Acc { using type = int; };
template <> struct Acc<kBf16> { using type = float; };

template <int KIND>
__device__ __forceinline__ void mma(typename Acc<KIND>::type (&c)[4],
                                    const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma<kS8>(int (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma<kBf16>(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma<kS4>(int (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage `rows` rows of a K-major matrix (gbytes bytes a row in device
// memory) into shared memory rows of stride ld. s4 packs 16 s8 values
// into 8 bytes on the way.
template <int KIND>
__device__ __forceinline__ void stage(const uint8_t* __restrict__ G,
                                      int rows, int gbytes, uint8_t* S,
                                      int ld) {
  const int chunks = gbytes / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int4 v = __ldg(reinterpret_cast<const int4*>(
        G + static_cast<int64_t>(r) * gbytes + c * 16));
    if (KIND == kS4) {
      const uint32_t w[4] = {static_cast<uint32_t>(v.x),
                             static_cast<uint32_t>(v.y),
                             static_cast<uint32_t>(v.z),
                             static_cast<uint32_t>(v.w)};
      uint32_t p[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h] = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t byte = (w[2 * h + (j >> 2)] >> (8 * (j & 3))) & 0xf;
          p[h] |= byte << (4 * j);
        }
      }
      *reinterpret_cast<uint2*>(S + r * ld + c * 8) = make_uint2(p[0], p[1]);
    } else {
      *reinterpret_cast<int4*>(S + r * ld + c * 16) = v;
    }
  }
}

template <int KIND, int MT, int NT>
__global__ void __launch_bounds__(kThreads)
mma_rate_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bt,
                int M, int N, int gbytes, int kb, int iters, void* out) {
  using acc_t = typename Acc<KIND>::type;
  constexpr int BM = 2 * MT * 16, BN = 4 * NT * 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ld = kb + kPad;
  uint8_t* As = smem;
  uint8_t* Bs = smem + BM * ld;
  const int tiles_n = N / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  stage<KIND>(A + static_cast<int64_t>(m0) * gbytes, BM, gbytes, As, ld);
  stage<KIND>(Bt + static_cast<int64_t>(n0) * gbytes, BN, gbytes, Bs, ld);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  const int wm0 = (warp & 1) * (MT * 16), wn0 = (warp >> 1) * (NT * 8);
  acc_t acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int it = 0; it < iters; ++it) {
#pragma unroll 2
    for (int kk = 0; kk < kb; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* p = As + (wm0 + i * 16 + g) * ld + kk + t4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* q = Bs + (wn0 + j * 8 + g) * ld + kk + t4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(q);
        b[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma<KIND>(acc[i][j], a[i], b[j]);
    }
  }

  acc_t* o = static_cast<acc_t*>(out) +
             static_cast<int64_t>(blockIdx.y) * M * N;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        const int col = n0 + wn0 + j * 8 + t2;
        acc_t* dst = o + static_cast<int64_t>(row) * N + col;
        dst[0] = acc[i][j][2 * h];
        dst[1] = acc[i][j][2 * h + 1];
      }
}

// bytes a row: in device memory and in shared memory
inline void row_bytes(int kind, int K, int* gbytes, int* kb) {
  *gbytes = kind == kBf16 ? 2 * K : K;
  *kb = kind == kS4 ? K / 2 : *gbytes;
}

// The largest block tile whose staged operands fit: 0 (128x128),
// 1 (64x128), 2 (32x64), or -1.
inline int pick_tile(int kb, int* bm, int* bn) {
  const int tiles[3][2] = {{128, 128}, {64, 128}, {32, 64}};
  for (int c = 0; c < 3; ++c) {
    if (static_cast<long long>(tiles[c][0] + tiles[c][1]) * (kb + kPad) <=
        kSmemMax) {
      *bm = tiles[c][0];
      *bn = tiles[c][1];
      return c;
    }
  }
  return -1;
}

template <int KIND, int MT, int NT>
cudaError_t launch(const uint8_t* A, const uint8_t* Bt, int M, int N,
                   int gbytes, int kb, int iters, int replicas, void* out,
                   cudaStream_t stream) {
  constexpr int BM = 2 * MT * 16, BN = 4 * NT * 8;
  const int smem = (BM + BN) * (kb + kPad);
  cudaError_t err = cudaFuncSetAttribute(
      mma_rate_kernel<KIND, MT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M / BM) * (N / BN), replicas);
  mma_rate_kernel<KIND, MT, NT><<<grid, kThreads, smem, stream>>>(
      A, Bt, M, N, gbytes, kb, iters, out);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(int cfg, const uint8_t* A, const uint8_t* Bt, int M,
                        int N, int gbytes, int kb, int iters, int replicas,
                        void* out, cudaStream_t s) {
  switch (cfg) {
    case 0: return launch<KIND, 4, 4>(A, Bt, M, N, gbytes, kb, iters,
                                      replicas, out, s);
    case 1: return launch<KIND, 2, 4>(A, Bt, M, N, gbytes, kb, iters,
                                      replicas, out, s);
    case 2: return launch<KIND, 1, 2>(A, Bt, M, N, gbytes, kb, iters,
                                      replicas, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// The block tile the kernel takes for `kind` and depth K: M and N must be
// multiples of it. Returns 0, or an error code when no tile fits.
int tile_for(int kind, int K, int* bm, int* bn) {
  if (kind < kS8 || kind > kS4 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int gbytes, kb;
  row_bytes(kind, K, &gbytes, &kb);
  if (gbytes % 16 || kb % 32 || pick_tile(kb, bm, bn) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// ---- the wgmma route -----------------------------------------------------

// Stage `rows` rows of a K-major matrix (gbytes bytes a row, one byte or
// half a bf16 value per byte of K) into 128-byte-swizzled K-blocks of
// rows x 128 bytes. s4: each byte's low nibble sign-extended to s8.
template <int KIND>
__device__ __forceinline__ void stage_sw128(const uint8_t* __restrict__ G,
                                            int rows, int gbytes, uint8_t* S,
                                            int nthreads) {
  const int chunks = gbytes / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += nthreads) {
    const int r = i / chunks, c = i - r * chunks;
    int4 v = __ldg(reinterpret_cast<const int4*>(
        G + static_cast<int64_t>(r) * gbytes + c * 16));
    if (KIND == kS4) {
      // nibble n -> (n ^ 8) - 8 per byte: 0..7 stay, 8..15 become -8..-1
      v.x = static_cast<int>(__vsub4((v.x & 0x0f0f0f0f) ^ 0x08080808u,
                                     0x08080808u));
      v.y = static_cast<int>(__vsub4((v.y & 0x0f0f0f0f) ^ 0x08080808u,
                                     0x08080808u));
      v.z = static_cast<int>(__vsub4((v.z & 0x0f0f0f0f) ^ 0x08080808u,
                                     0x08080808u));
      v.w = static_cast<int>(__vsub4((v.w & 0x0f0f0f0f) ^ 0x08080808u,
                                     0x08080808u));
    }
    *reinterpret_cast<int4*>(S + (c >> 3) * (rows * 128) + r * 128 +
                             (((c & 7) ^ (r & 7)) << 4)) = v;
  }
}

template <int KIND, int BN>
__device__ __forceinline__ void wgmma_step(
    typename Acc<KIND>::type (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (KIND == kBf16) {
    hopper::wgmma_bf16<BN>(d, da, db, 1);
  } else {
    hopper::wgmma_s8<BN>(d, da, db, 1);
  }
}

template <int KIND, int WGS, int BN>
__global__ void __launch_bounds__(WGS * 128, 1)
mma_rate_wgmma_kernel(const uint8_t* __restrict__ A,
                      const uint8_t* __restrict__ Bt, int M, int N, int kb,
                      int iters, void* out) {
  using namespace hopper;
  using acc_t = typename Acc<KIND>::type;
  constexpr int BM = 64 * WGS, kThreadsWg = 128 * WGS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int kblocks = (kb + 127) / 128;
  uint8_t* As = sm;
  uint8_t* Bs = sm + kblocks * (BM * 128);
  const int tiles_n = N / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  stage_sw128<KIND>(A + static_cast<int64_t>(m0) * kb, BM, kb, As,
                    kThreadsWg);
  stage_sw128<KIND>(Bt + static_cast<int64_t>(n0) * kb, BN, kb, Bs,
                    kThreadsWg);
  fence_proxy_async();   // generic-proxy stores, read by wgmma
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const uint32_t a_base = smem_u32(As) + wg * (64 * 128);
  const uint32_t b_base = smem_u32(Bs);
  acc_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  wgmma_fence();
  for (int it = 0; it < iters; ++it) {
    // K-block by K-block, four 32-byte steps each (k32 s8, k16 bf16);
    // a step count known only at run time (a partial block) made ptxas
    // serialize the wgmmas (C7520)
    for (int blk = 0; blk < kblocks; ++blk) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma_step<KIND, BN>(
            acc, wgmma_desc_sw128(a_base + blk * (BM * 128) + 32 * s),
            wgmma_desc_sw128(b_base + blk * (BN * 128) + 32 * s));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_registers(acc);

  acc_t* o = static_cast<acc_t*>(out) +
             static_cast<int64_t>(blockIdx.y) * M * N;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * h;
      const int col = n0 + 8 * j + t2;
      acc_t* dst = o + static_cast<int64_t>(row) * N + col;
      dst[0] = acc[4 * j + 2 * h];
      dst[1] = acc[4 * j + 2 * h + 1];
    }
}

// Dynamic shared memory of a wgmma launch: alignment slack and both
// operand tiles, K rounded up to whole 128-byte blocks.
inline long long wgmma_smem(int bm, int bn, int kb) {
  return 1024 + static_cast<long long>(kb) * (bm + bn);
}

template <int KIND, int WGS, int BN>
cudaError_t launch_wgmma(const uint8_t* A, const uint8_t* Bt, int M, int N,
                         int kb, int iters, int replicas, void* out,
                         cudaStream_t stream) {
  const int smem = static_cast<int>(wgmma_smem(64 * WGS, BN, kb));
  cudaError_t err = cudaFuncSetAttribute(
      mma_rate_wgmma_kernel<KIND, WGS, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M / (64 * WGS)) * (N / BN), replicas);
  mma_rate_wgmma_kernel<KIND, WGS, BN><<<grid, 128 * WGS, smem, stream>>>(
      A, Bt, M, N, kb, iters, out);
  return cudaGetLastError();
}

// The block tiles of the route, as probes/mma_rate.py::WGMMA_TILES lists
// them.
template <int KIND>
cudaError_t launch_wgmma_tile(int bm, int bn, const uint8_t* A,
                              const uint8_t* Bt, int M, int N, int kb,
                              int iters, int replicas, void* out,
                              cudaStream_t s) {
  if (bm == 128 && bn == 256)
    return launch_wgmma<KIND, 2, 256>(A, Bt, M, N, kb, iters, replicas, out, s);
  if (bm == 128 && bn == 128)
    return launch_wgmma<KIND, 2, 128>(A, Bt, M, N, kb, iters, replicas, out, s);
  if (bm == 128 && bn == 64)
    return launch_wgmma<KIND, 2, 64>(A, Bt, M, N, kb, iters, replicas, out, s);
  if (bm == 64 && bn == 64)
    return launch_wgmma<KIND, 1, 64>(A, Bt, M, N, kb, iters, replicas, out, s);
  if (bm == 64 && bn == 32)
    return launch_wgmma<KIND, 1, 32>(A, Bt, M, N, kb, iters, replicas, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ursonet_rate

extern "C" int ursonet_mma_rate(const void* a, const void* bt, int M, int N,
                                int K, int iters, int kind, int replicas,
                                void* out, int device, void* stream) {
  using namespace ursonet_rate;
  int bm, bn;
  int rc = tile_for(kind, K, &bm, &bn);
  if (rc != 0) return rc;
  if (a == nullptr || bt == nullptr || out == nullptr || M <= 0 || N <= 0 ||
      M % bm || N % bn || iters < 0 || replicas <= 0 || replicas > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int gbytes, kb;
  row_bytes(kind, K, &gbytes, &kb);
  const int cfg = pick_tile(kb, &bm, &bn);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* A = static_cast<const uint8_t*>(a);
  const uint8_t* Bt = static_cast<const uint8_t*>(bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kS8:
      err = launch_kind<kS8>(cfg, A, Bt, M, N, gbytes, kb, iters, replicas,
                             out, s);
      break;
    case kBf16:
      err = launch_kind<kBf16>(cfg, A, Bt, M, N, gbytes, kb, iters, replicas,
                               out, s);
      break;
    case kS4:
      err = launch_kind<kS4>(cfg, A, Bt, M, N, gbytes, kb, iters, replicas,
                             out, s);
      break;
    default:
      err = cudaErrorNotSupported;
  }
  return static_cast<int>(err);
}

extern "C" const char* ursonet_mma_rate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int ursonet_mma_rate_wgmma(const void* a, const void* bt, int M,
                                      int N, int K, int iters, int kind,
                                      int replicas, int bm, int bn, void* out,
                                      int device, void* stream) {
  using namespace ursonet_rate;
  if (kind < kS8 || kind > kS4 || K <= 0 || a == nullptr || bt == nullptr ||
      out == nullptr || M <= 0 || N <= 0 || bm <= 0 || bn <= 0 || M % bm ||
      N % bn || iters < 0 || replicas <= 0 || replicas > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // bytes of K a row, staged: s4 values take a byte each (sign-extended);
  // whole 128-byte K-blocks
  const int kb = kind == kBf16 ? 2 * K : K;
  if (kb % 128 || wgmma_smem(bm, bn, kb) > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* A = static_cast<const uint8_t*>(a);
  const uint8_t* Bt = static_cast<const uint8_t*>(bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kS8:
      err = launch_wgmma_tile<kS8>(bm, bn, A, Bt, M, N, kb, iters, replicas,
                                   out, s);
      break;
    case kBf16:
      err = launch_wgmma_tile<kBf16>(bm, bn, A, Bt, M, N, kb, iters,
                                     replicas, out, s);
      break;
    default:
      err = launch_wgmma_tile<kS4>(bm, bn, A, Bt, M, N, kb, iters, replicas,
                                   out, s);
  }
  return static_cast<int>(err);
}
