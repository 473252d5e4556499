// The int8 saved-activation kernels of TRAIN_ACT_Q8 for Hopper (sm_90a),
// bound through a plain C interface (ctypes; see
// ursonet_torch/ops/actq_cuda.py).
//
// They replace no Pallas kernel. The JAX package computes these steps in
// XLA (ursonet_tpu/models/actq.py: `_quantize_per_sample`, the g-quantize
// and the int8 x int8 -> int32 weight-gradient conv of `_q8w8_bwd`, the
// dequant of `_q8_bwd`). PyTorch has no CUDA int8 convolution, and the
// quantize written as plain operations costs several launches a conv on
// an eager step that the host already paces, so the port writes them:
//
//   quant_s8, three modes:
//     'x'        per sample n: amax = max|x[n]|, scale = max(amax, 1e-12)
//                / 127 (rounded to bf16 for a bf16 x, as JAX divides in
//                bf16), q = clip(rint(f32(x) / scale), +-127).
//     'g'        G = f32(g) * scale[n], sg = max(max|G|, 1e-30) / 127 over
//                the whole tensor, qg = clip(rint(G / sg), +-127), written
//                as the [Co, Kp] A operand of the weight-gradient product;
//                sg is also written `alpha_len` times, that product's
//                epilogue factor.
//     'dequant'  T(q) * T(scale[n]) in the compute type T.
//   wgrad_s8: dw[co, r] = sum_k qg[co, k] * P[r, k], P the int8 patch
//     matrix of the saved q (r = ci * KH * KW + dy * KW + dx), with the
//     epilogue f32(acc) * alpha[r] (JAX's f32(acc) * sg) or the int32 sums.
//
// Layouts. q and qg are private to ConvQ8 (saved for its backward), so
// their layout is chosen for the product, from the shapes, before any
// launch (`actq_cuda.wgrad_plan`):
//   q   rows of the conv's input, viewed as [N, C, Hk, Wk] (the input
//       itself, or for a 1x1 stride-1 unpadded conv its planes cut into
//       rows of Wk that suit the product), each row kept as KW copies of
//       `wph` bytes, one a kernel column dx: byte j of copy dx holds
//       column j * s + dx - pl (zero outside the row), the column that
//       output column j reads through tap dx. So a tap's patch row starts
//       at byte 0 of its copy: TMA takes a box only where its innermost
//       start coordinate is a multiple of 16 bytes (an unaligned start
//       is an illegal instruction on the card), and that dimension takes
//       no traversal stride either; stride and left padding would both
//       put it off 16. wph (>= Wo, a multiple of 16) keeps every row
//       addressable (global strides are multiples of 16). Stride 1: the
//       copies are planes, [N, C, KW, Hk, wph] (`cmaj`), so a stage's 128
//       bytes of K are consecutive bytes of one plane; larger strides:
//       [N, C, Hk, KW, wph] (row-major), one box a row. A 1x1 stride-1
//       unpadded view is the plain NCHW bytes (the dequant and the gather
//       route read q so too).
//   qgt [Co, Kp], output row oh of sample n at column n * Kps + oh * Wst
//       of the same view (zero where oh >= Ho or ow >= Wo, Kp = N * Kps):
//       stride 1, Wst = wph and Kps = Ho * wph rounded up to 128; larger
//       strides, Wst = Wop = 32, 64, 128 (or a multiple of 128), so a
//       128-byte stage of K is a whole number of output rows (Hb = 128 /
//       Wop) or of 128-byte pieces of one (Wseg = min(Wop, 128)), and Kps
//       = Hop * Wop, Hop rounding Ho up to a multiple of Hb. The zero
//       columns add nothing to the sums; they cost operations (rows of
//       40 -> 48 bytes, 20 -> 32 on the flagship's 3x3 convs).
//   Why not an NHWC view with the patches built in registers (register-A
//   wgmma, the stem's way): int8 wgmma takes B from shared memory K-major
//   only, and the product's B operand is the patch matrix whichever way
//   round it is set; building it in registers costs byte permutes on every
//   stage, while this layout costs one padded write of q in the quantize
//   that writes q anyway.
//
// Kernels and what bounds them.
//   quant_kernel ('x', and 'g' without a data-parallel group): one launch
//     a call, a grid of co-resident blocks (one a SM, checked against the
//     occupancy query before the launch), each with a chunk of rows.
//     A block reduces |x| over its rows (16-byte loads) in registers, the
//     warp and the block, and adds one atomicMax on the float's bits into
//     its sample's slot (non-negative floats order as their bits; a NaN's
//     bits order above +inf, so a NaN is kept). A grid-wide barrier
//     follows; then each block reads its rows again, quantizes them and
//     writes the output in 16-byte stores. The second read is served by
//     L2 where the call fits it (50 MB on the H100). Keeping the rows in
//     shared memory instead (one bulk copy a block, possible for calls
//     up to 132 x 200 KB) was measured no faster, and waves of whole
//     samples, a barrier each, slower than the second read (PERF.md). The
//     slots and the barrier counters live in a workspace that the last
//     block out leaves zero, so no fill launch precedes a call. Under a
//     data-parallel group, 'g' runs the same kernel twice: the reduction
//     alone, the all-reduce of the slot between, the quantize alone. The
//     quantize divides truly (__fdiv_rn, JAX's bits) and moves 16 bytes
//     a thread; what bounds it on the card is in PERF.md.
//   wgrad_tma_kernel: implicit GEMM, no patch matrix. Persistent blocks of
//     three warpgroups: one thread loads, by TMA into a ring of stages,
//     qgt's [128 rows][128 B] tile (128-byte swizzle) and the patch tile
//     of BN = 128 or 256 channels of one tap (the width and the split of K
//     from actq_cuda.wgrad_tiles' cost model): for stride 1 one 4-D box of
//     128 consecutive bytes of the tap's copy plane (its start shifted by
//     dy - pt rows, negative at the top: out-of-bounds bytes arrive as
//     zeros), for larger strides Hb 5-D boxes, one a output row, each
//     Wseg bytes in the swizzle of Wseg-byte rows (a box narrower than the
//     128-byte swizzle's rows does not land as 128-byte rows), so that B
//     tile is Hb regions of K-major [BN][Wseg] and each k32 step's
//     descriptor points into one of them. Two warpgroups multiply 64 rows
//     each with wgmma m64nBNk32 s8 and apply the epilogue in registers,
//     storing dw in its [Co, Ci, KH, KW] layout. Where the tiles cannot
//     fill the SMs, K is split over blocks: each writes its int32 partial
//     sums to a slot of its own (plain stores: an atomic add a sum cost
//     more than the product at these sizes), the last of a tile's parts
//     to arrive adds the slots in split order (integer sums, exact) and
//     rounds once. Bound: the operations (2 Co R N Ho Wo at the int8
//     rate); each 128-byte stage of K reads 128 x (128 + BN) bytes from
//     L2, which at 128 x 128 tiles asks more of L2 than it gives.
//   The gather route (`ursonet_actq_im2col` + gemm_s8), for shapes the TMA
//     route does not take (fewer than 64 input channels): P [R, Kp]
//     written to device memory. Bound: P's bytes (R times the input's
//     pixels at stride 1; 13.0 MB for config 2's C = 3 stem, 49 rows
//     a channel). im2col_kernel: one block a (channel, sample, band of
//     output rows). The band's input rows of q[n, ci] are contiguous
//     bytes: one cp.async.bulk brings them into shared memory (rows of
//     16-byte multiples; other widths read q directly), and a pass splits
//     them into `stride` phase planes with the padding written as zeros
//     (plane f holds padded columns f, f + s, ..), so each tap's run of a
//     P row over the band, band * Wo contiguous bytes, is read from one
//     plane row at unit stride: a thread's 16 output bytes are two
//     aligned 16-byte shared loads (a quarter-warp's 128 contiguous
//     bytes, no bank conflict) shifted into place, written as one
//     16-byte store. A chunk that crosses an output row, band or sample
//     (Wo not a multiple of 16) goes a byte at a time; the last band of
//     the last sample writes the zero tail to kp. The old kernel (PR 18)
//     assembled every byte with div/mod carries from q in L2: 0.148 of
//     its bound.
//   dequant_kernel: bound by bytes (1 read and 2 written an element in
//     bf16, 1 and 4 in f32). One launch a call over a 1-D grid of
//     persistent blocks (8 a SM, all resident; any N), one 16-element
//     chunk a thread a pass, taken as groups of 16 / sizeof(T) elements:
//     each group's q bytes in one evict-first load (read once) of 8 bytes
//     in bf16, 4 in f32, and its products in one 16-byte store, so a
//     warp's loads and stores are each contiguous. Loads are narrower
//     than 16 bytes because the stores set the pace: one 16-byte load of
//     a chunk's q feeds two 16-byte stores a thread in bf16, each warp
//     store then writing every other 16 bytes, and that form reached 0.53
//     of the bytes' time on the card against this one's 0.80 (PERF.md).
//     A chunk reads its scale once where it lies in one sample, each
//     element's own where it spans samples; an unaligned head and the
//     tail go one element a thread in the same launch. Bulk copies
//     (cp.async.bulk of q through a ring in shared memory, bulk stores of
//     the products) were measured 6% slower in bf16 over a step's calls
//     and 2% faster in f32 (PERF.md), so the kernel keeps one form.
//
// Rounding: rintf (round half to even, jnp.round's rule) and a true
// division by the scale (not a multiply by its reciprocal); nvcc runs
// with -fmad=false, so no multiply is contracted into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float absmax(float a, float b) {
  // max of two non-negative values that keeps a NaN (fmaxf drops it)
  return (b != b || b > a) ? b : a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = absmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// scale of mode 'x' from sample n's amax: max(amax, 1e-12) / 127, in bf16
// for a bf16 input (the clamp constant rounded to bf16 too).
template <class T>
__device__ __forceinline__ float x_scale(unsigned bits) {
  const float a = __uint_as_float(bits);
  if constexpr (sizeof(T) == 2) {
    const float c = round_bf16(1e-12f);
    return round_bf16(__fdiv_rn(a != a ? a : fmaxf(a, c), 127.0f));
  } else {
    return __fdiv_rn(a != a ? a : fmaxf(a, 1e-12f), 127.0f);
  }
}

__device__ __forceinline__ float g_scale(unsigned bits) {
  const float a = __uint_as_float(bits);
  return __fdiv_rn(a != a ? a : fmaxf(a, 1e-30f), 127.0f);
}

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// quantize(v, scale), or with MUL v times `scale` holding the reciprocal
// (timing only: not JAX's bits)
template <bool MUL>
__device__ __forceinline__ int8_t quantize_as(float v, float scale) {
  if constexpr (MUL) {
    const float r = rintf(__fmul_rn(v, scale));
    return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  } else {
    return quantize(v, scale);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// ===========================================================================
// quant_s8 'x' and 'g': one launch

namespace quant {

constexpr int kThreadsQ = 1024;
constexpr int kScales = 32;         // per-sample scales a block caches
constexpr int kModeX = 0, kModeG = 1;
constexpr int kReduce = 1, kQuant = 2, kBoth = 3;

struct Params {
  const void* x;          // rows [rows][w] of T
  const float* scale_in;  // 'g': the per-sample scale of the conv's input
  int8_t* q;              // 'x': rows of copies * wph bytes; 'g': qgt
  float* scale_out;       // 'x': scale [n]; 'g': alpha [alpha_len]
  unsigned* slots;        // amax bits ('x': one a sample; 'g': slot 0)
  unsigned* bar;          // [0] barrier arrivals, [1] blocks done
  int rows, w;            // input rows and their length
  int copies, wph;        // output row: byte v * wph + j = column j * s + v - pl
  int s, pl;
  int rps;                // input rows a sample ('g': co * hok)
  int n;                  // samples
  int mode, phase;        // kModeX / kModeG; kReduce, kQuant or kBoth
  int hok;               // rows a plane ('x' copy-major: Hk; 'g': Hok)
  long long kps, kp;     // 'g': input row (n, co, oh) -> qgt row co (kp
                          // bytes), column n * kps + oh * wph; zero past
                          // hok rows of each sample's kps
  int cmaj;               // 'x': copy v of row (nc, h) at ((nc * copies +
                          // v) * hok + h) * wph, else at row * copies * wph
  int alpha_len;
  int chunk_rows;         // block b's rows: [b * chunk_rows, + chunk_rows)
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid (co-resident by the launch's occupancy check)
// arrives; returns once `target` arrivals are counted. A wait that sees
// no progress for hopper::kStallClocks traps instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    if (ld_acquire(bar) < target) {
      const long long t0 = clock64();
      while (ld_acquire(bar) < target) {
        __nanosleep(100);
        if (clock64() - t0 > hopper::kStallClocks) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The block's max of `v` into *slot (atomicMax on the bits).
__device__ __forceinline__ void block_max_to(float v, unsigned* slot,
                                             float* part) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) part[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = warp_max(part[lane]);
    if (lane == 0) atomicMax(slot, __float_as_uint(v));
  }
  __syncthreads();
}

// 16 consecutive elements of a row as floats, from 16-byte aligned
// memory (shared or global).
template <class T>
__device__ __forceinline__ void load16(const T* src, float (&f)[16]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int k = 0; k < 16 / V; ++k) {
    alignas(16) T v[V];
    *reinterpret_cast<uint4*>(v) = reinterpret_cast<const uint4*>(src)[k];
#pragma unroll
    for (int j = 0; j < V; ++j) f[k * V + j] = to_f32(v[j]);
  }
}

// Rows [ra, rb): |x| (|f32(g) * scale[n]| for 'g') reduced per sample into
// the slots, from `src` (the chunk's rows), 16-byte loads where VEC.
template <class T, bool VEC>
__device__ void reduce_rows(const Params& p, int ra, int rb, const T* src,
                            float* part) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  const long long base = static_cast<long long>(ra) * p.w;
  for (int r = ra; r < rb;) {
    const int n = r / p.rps;
    const int re = min(rb, (n + 1) * p.rps);
    const float s = p.mode == kModeG ? __ldg(p.scale_in + n) : 1.0f;
    const long long e1 = static_cast<long long>(re) * p.w - base;
    float m = 0.0f;
#pragma unroll 4
    for (long long e = static_cast<long long>(r) * p.w - base +
                       threadIdx.x * V;
         e < e1; e += kThreadsQ * V) {
      alignas(16) T v[V];
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src + e);
      } else {
        v[0] = src[e];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(v[j]);
        m = absmax(m, p.mode == kModeG ? fabsf(f * s) : fabsf(f));
      }
    }
    block_max_to(m, p.slots + (p.mode == kModeX ? n : 0), part);
    r = re;
  }
}

// Rows [ra, rb) quantized into the output layout from `src` (their rows),
// 16 output bytes a thread
// (VEC) or one. CONTIG (one copy, stride 1, no left padding, rows of a
// multiple of 16 bytes): a unit's 16 columns are consecutive and 16-byte
// aligned, read as vectors. `sc` caches the scales of samples n0 .. n0 +
// cached - 1 ('x') or sg in sc[0] ('g'). MUL multiplies by the scale's
// reciprocal instead of dividing: not JAX's bits, for timing the division
// alone (`ursonet_actq_quant`'s `timing_mul`), never on the path.
template <class T, bool VEC, bool CONTIG, bool MUL>
__device__ void quant_rows(const Params& p, int ra, int rb, const T* src,
                           const float* sc, int n0, int cached) {
  const int P = p.copies * p.wph;
  const int U = VEC ? P / 16 : P;
  const int units = (rb - ra) * U;
  for (int u = threadIdx.x; u < units; u += kThreadsQ) {
    const int rl = u / U;
    const int b0 = (u - rl * U) * (VEC ? 16 : 1);
    const int r = ra + rl;
    const T* row = src + static_cast<long long>(rl) * p.w;
    const int n = r / p.rps;
    float scale, gs = 1.0f;
    long long out;
    const int cv = b0 / p.wph, j0 = b0 - cv * p.wph;
    if (p.mode == kModeX) {
      scale = n - n0 < cached ? sc[n - n0] : x_scale<T>(__ldcg(p.slots + n));
      if (p.cmaj) {
        const int nc = r / p.hok, h = r - nc * p.hok;
        out = ((static_cast<long long>(nc) * p.copies + cv) * p.hok + h) *
                  p.wph - b0 + j0;
      } else {
        out = static_cast<long long>(r) * P;
      }
    } else {
      scale = sc[0];
      gs = __ldg(p.scale_in + n);
      const int rem = r - n * p.rps, co = rem / p.hok, oh = rem - co * p.hok;
      out = co * p.kp + n * p.kps + static_cast<long long>(oh) * p.wph;
    }
    if constexpr (MUL) scale = __frcp_rn(scale);
    const int w0 = j0 * p.s + cv - p.pl;   // the column of byte b0
    if constexpr (VEC) {
      alignas(16) int8_t o[16];
      if (CONTIG && w0 + 16 <= p.w) {
        float f[16];
        load16<T>(row + w0, f);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          o[i] = quantize_as<MUL>(p.mode == kModeG ? f[i] * gs : f[i], scale);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int w = w0 + i * p.s;
          int8_t v = 0;
          if (w >= 0 && w < p.w) {
            const float f = to_f32(row[w]);
            v = quantize_as<MUL>(p.mode == kModeG ? f * gs : f, scale);
          }
          o[i] = v;
        }
      }
      *reinterpret_cast<uint4*>(p.q + out + b0) =
          *reinterpret_cast<const uint4*>(o);
    } else {
      int8_t v = 0;
      if (w0 >= 0 && w0 < p.w) {
        const float f = to_f32(row[w0]);
        v = quantize_as<MUL>(p.mode == kModeG ? f * gs : f, scale);
      }
      p.q[out + b0] = v;
    }
  }
  if (p.mode == kModeG) {
    // the zero tail of each sample's kps bytes (and of the qgt row after
    // the last sample), from the block that holds the plane's last row
    for (int r = ra + threadIdx.x; r < rb; r += kThreadsQ) {
      const int n = r / p.rps;
      const int rem = r - n * p.rps, co = rem / p.hok, oh = rem - co * p.hok;
      if (oh != p.hok - 1) continue;
      const long long row0 = co * p.kp;
      const long long z0 = n * p.kps + static_cast<long long>(p.hok) * p.wph;
      const long long z1 = n == p.n - 1 ? p.kp : (n + 1) * p.kps;
      for (long long b = z0; b < z1; ++b) p.q[row0 + b] = 0;
    }
  }
}

template <class T, bool VEC, bool CONTIG, bool MUL>
__global__ void __launch_bounds__(kThreadsQ, 1) quant_kernel(const Params p) {
  __shared__ float part[kThreadsQ / 32];
  __shared__ float sc[kScales];
  __shared__ int last;
  const int ra = min(p.rows, static_cast<int>(blockIdx.x) * p.chunk_rows);
  const int rb = min(p.rows, ra + p.chunk_rows);
  const T* src = static_cast<const T*>(p.x) + static_cast<long long>(ra) * p.w;
  if (p.phase & kReduce) reduce_rows<T, VEC>(p, ra, rb, src, part);
  if (p.phase == kBoth) grid_sync(p.bar, gridDim.x);
  if (p.phase & kQuant) {
    int n0 = 0, cached = 0;
    if (p.mode == kModeX) {
      if (rb > ra) {
        n0 = ra / p.rps;
        const int n1 = (rb - 1) / p.rps;
        cached = n1 - n0 < kScales ? n1 - n0 + 1 : 0;
        for (int i = threadIdx.x; i < cached; i += kThreadsQ)
          sc[i] = x_scale<T>(__ldcg(p.slots + n0 + i));
        // scale[n] from the block that holds sample n's first row
        for (int n = (ra + p.rps - 1) / p.rps + threadIdx.x; n <= n1;
             n += kThreadsQ)
          p.scale_out[n] = x_scale<T>(__ldcg(p.slots + n));
      }
    } else {
      if (threadIdx.x == 0) sc[0] = g_scale(__ldcg(p.slots));
      __syncthreads();
      if (blockIdx.x == 0)
        for (int i = threadIdx.x; i < p.alpha_len; i += kThreadsQ)
          p.scale_out[i] = sc[0];
    }
    __syncthreads();
    quant_rows<T, VEC, CONTIG, MUL>(p, ra, rb, src, sc, n0, cached);
  }
  // the last block out leaves the workspace zero for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.bar + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    if (p.phase & kQuant) {
      const int slots = p.mode == kModeX ? p.n : 1;
      for (int i = threadIdx.x; i < slots; i += kThreadsQ) p.slots[i] = 0;
    }
    if (threadIdx.x == 0) {
      p.bar[0] = 0;
      p.bar[1] = 0;
    }
  }
}

template <class T, bool VEC, bool CONTIG, bool MUL>
int launch(const Params& p, int grid, cudaStream_t st) {
  auto kernel = quant_kernel<T, VEC, CONTIG, MUL>;
  // the grid barrier needs every block resident at once
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreadsQ, 0)) != cudaSuccess)
    return static_cast<int>(err);
  if (grid > sms * per_sm)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  kernel<<<grid, kThreadsQ, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// vec: 0 one byte a thread, 1 16 bytes, 2 16 bytes from contiguous rows;
// the timing variant (mul) only with 16-byte rows (vec > 0).
template <class T>
int launch_t(const Params& p, int vec, int mul, int grid, cudaStream_t st) {
  if (vec == 2) {
    return mul ? launch<T, true, true, true>(p, grid, st)
               : launch<T, true, true, false>(p, grid, st);
  }
  if (vec == 1) {
    return mul ? launch<T, true, false, true>(p, grid, st)
               : launch<T, true, false, false>(p, grid, st);
  }
  return mul ? static_cast<int>(cudaErrorInvalidValue)
             : launch<T, false, false, false>(p, grid, st);
}

}  // namespace quant

// ===========================================================================
// wgrad_s8's TMA route: implicit GEMM

namespace wgrad {

constexpr int kBM = 128;     // rows of a tile (Co): 64 a consumer warpgroup
constexpr int kBK = 128;     // bytes of K a stage: one swizzle row
constexpr int kThreadsW = 384;
constexpr int kATile = kBM * kBK;

// A tile of BN columns (128 or 256 channels of one tap): the ring's depth
// and the dynamic shared memory of a launch.
template <int BN>
struct Shape {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kBTile = BN * kBK;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kSmem = 1024 + kStages * kStage + 256;
};

struct Params {
  int co, ci, taps, kw, r;   // r = ci * taps: a row of dw
  int s, pt;                 // stride, top padding
  int cmaj;                  // q copy-major (stride 1): stage ks is one
                             // box at byte (ks % spp) * 128 + (dy - pt) *
                             // wph of sample ks / spp's plane
  int spp, wph;
  int hb, segs, wseg, hop;   // row-major: stage ks covers output rows
                             // (ks / segs) * hb .. + hb - 1, columns
                             // (ks % segs) * wseg ..
  int cblocks, n_tiles, tiles, items, ksteps, kps, splits;
                             // split j: stages [j * kps, min((j+1) * kps, ksteps))
  const float* alpha;        // null: the int32 sums
  void* out;                 // dw [co, r]
  int* ws;                   // splits > 1: [splits][tiles][kBM][BN] partial sums
  int* counters;             // splits > 1: [tiles][2], zero in and out
};

struct Item {
  int tile, m0, c0, tap, k0, k1, dy, dx;
};

// item = split * tiles + tile: the blocks running together work on the
// same stretch of K, so they share qgt's and q's bytes through L2.
template <int BN>
__device__ __forceinline__ Item decode(const Params& p, int item) {
  Item it;
  const int split = item / p.tiles;
  it.tile = item - split * p.tiles;
  const int mt = it.tile / p.n_tiles, nt = it.tile - mt * p.n_tiles;
  it.tap = nt / p.cblocks;
  const int cb = nt - it.tap * p.cblocks;
  it.dy = it.tap / p.kw;
  it.dx = it.tap - it.dy * p.kw;
  it.m0 = mt * kBM;
  it.c0 = cb * BN;
  it.k0 = split * p.kps;
  it.k1 = min(it.k0 + p.kps, p.ksteps);
  return it;
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Matrix descriptor of a K-major operand tile whose rows are `wseg` bytes
// (128, 64 or 32) in the swizzle of that width, as TMA writes it: start
// address >> 4, leading byte offset 1 (unused), 8-row groups 8 * wseg
// bytes apart, layout type 1 (128-byte), 2 (64-byte) or 3 (32-byte).
__device__ __forceinline__ uint64_t desc_sw(uint32_t saddr, int wseg) {
  const uint64_t layout = wseg == 128 ? 1 : (wseg == 64 ? 2 : 3);
  return static_cast<uint64_t>((saddr & 0x3ffffu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * wseg) >> 4) << 32) | (layout << 62);
}

template <int BN>
__global__ void __launch_bounds__(kThreadsW, 1)
wgrad_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const Params p) {
  using namespace hopper;
  using S = Shape<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::kStages * S::kStage);
  const uint32_t full = smem_u32(bars), empty = full + 8 * S::kStages;
  volatile int* last = reinterpret_cast<volatile int*>(bars + 2 * S::kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ============================ loader ============================
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const Item it = decode<BN>(p, item);
      for (int ks = it.k0; ks < it.k1; ++ks) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t dst = smem_u32(sm) + stage * S::kStage;
        mbar_arrive_expect_tx(full + 8 * stage, S::kStage);
        tma_load_2d(dst, &map_a, full + 8 * stage, ks * kBK, it.m0);
        if (p.cmaj) {
          // 128 bytes of the tap's copy plane: rows of wph bytes, the
          // stage's first output row shifted by dy - pt rows
          const int n = ks / p.spp, koff = (ks - n * p.spp) * kBK;
          tma_load_4d(dst + kATile, &map_b, full + 8 * stage,
                      koff + (it.dy - p.pt) * p.wph, it.dx, it.c0, n);
        } else {
          const int rowg = ks / p.segs, seg = ks - rowg * p.segs;
          const int orow = rowg * p.hb;          // n * hop + oh of its top
          const int n = orow / p.hop, oh = orow - n * p.hop;
          // one box a output row: BN channels x wseg bytes, in the
          // swizzle of wseg-byte rows, region i of the B tile
          for (int i = 0; i < p.hb; ++i)
            tma_load_5d(dst + kATile + i * (BN * p.wseg), &map_b,
                        full + 8 * stage, seg * p.wseg, it.dx,
                        (oh + i) * p.s + it.dy - p.pt, it.c0, n);
        }
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ========================== consumers ===========================
  const int c = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  // k32 step kk of a stage: bytes 32 kk .. of K lie in region 32 kk / wseg
  // of the B tile, at byte 32 kk % wseg of its rows
  uint32_t boff[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    boff[kk] = (32 * kk / p.wseg) * (BN * p.wseg) + (32 * kk) % p.wseg;
  int acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const Item it = decode<BN>(p, item);
    int prev = -1;
    for (int ks = it.k0; ks < it.k1; ++ks) {
      mbar_wait(full + 8 * stage, phase);
      __syncwarp();
      const uint32_t a = smem_u32(sm) + stage * S::kStage + c * (64 * kBK);
      const uint32_t b = smem_u32(sm) + stage * S::kStage + kATile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_s8<BN>(acc, wgmma_desc_sw128(a + 32 * kk),
                     desc_sw(b + boff[kk], p.wseg),
                     (ks != it.k0 || kk != 0) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_registers(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // thread (warp, lane) holds rows rl, rl + 8 and columns 8j + q2, + 1
    const int rl = 64 * c + warp * 16 + (lane >> 2), q2 = (lane & 3) * 2;
    if (p.splits > 1) {
      // this part's sums into its own slot; the last part of the tile
      // half to arrive adds the slots in split order
      const long long tile_ints = static_cast<long long>(kBM) * BN;
      const int split = item / p.tiles;
      int* slot = p.ws + (static_cast<long long>(split) * p.tiles + it.tile) *
                             tile_ints;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          __stcg(reinterpret_cast<int2*>(slot + (rl + 8 * h) * BN + 8 * j +
                                         q2),
                 make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      __threadfence();
      named_barrier(1 + c, 128);
      if (tid == 0)
        last[c] = atomicAdd(p.counters + 2 * it.tile + c, 1) == p.splits - 1;
      named_barrier(1 + c, 128);
      if (!last[c]) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int sp = 0; sp < p.splits; ++sp) {
        const int* ps = p.ws + (static_cast<long long>(sp) * p.tiles +
                                it.tile) * tile_ints;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int2 v = __ldcg(reinterpret_cast<const int2*>(
                ps + (rl + 8 * h) * BN + 8 * j + q2));
            acc[4 * j + 2 * h] += v.x;
            acc[4 * j + 2 * h + 1] += v.y;
          }
      }
      if (tid == 0) p.counters[2 * it.tile + c] = 0;
    }
    // the epilogue, into dw's [co][ci][tap] layout
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = it.m0 + rl + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = it.c0 + 8 * j + q2 + e;
          if (row >= p.co || ci >= p.ci) continue;
          const int col = ci * p.taps + it.tap;
          const long long o = static_cast<long long>(row) * p.r + col;
          const int v = acc[4 * j + 2 * h + e];
          if (p.alpha != nullptr) {
            static_cast<float*>(p.out)[o] =
                __fmul_rn(__int2float_rn(v), __ldg(p.alpha + col));
          } else {
            static_cast<int*>(p.out)[o] = v;
          }
        }
      }
  }
}

// The box map over q. Row-major (stride > 1): dims (wph, kw copies, hk, c,
// n), box (wseg, 1, 1, bn, 1) in the swizzle of wseg-byte rows: it lands
// as bn rows of wseg bytes, the layout desc_sw reads. Copy-major (cmaj):
// dims (hk * wph, kw copies, c, n), box (128, 1, bn, 1), 128-byte swizzle.
bool make_patch_map(CUtensorMap* map, const void* q, int n, int c, int hk,
                    int copies, int wph, int wseg, int cmaj, int bn) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled_fn();
  if (fn == nullptr) return false;
  if (cmaj) {
    const uint64_t plane = static_cast<uint64_t>(hk) * wph;
    const cuuint64_t dims[4] = {plane, static_cast<cuuint64_t>(copies),
                                static_cast<cuuint64_t>(c),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[3] = {plane, plane * copies,
                                   plane * copies * c};
    const cuuint32_t box[4] = {kBK, 1, static_cast<cuuint32_t>(bn), 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(q),
              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const uint64_t row = static_cast<uint64_t>(copies) * wph;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(wph),
                              static_cast<cuuint64_t>(copies),
                              static_cast<cuuint64_t>(hk),
                              static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(wph), row, row * hk,
                                 row * hk * c};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(wseg), 1, 1,
                             static_cast<cuuint32_t>(bn), 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw = wseg == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : wseg == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(q), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
           const Params& p, int grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_tma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Shape<BN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_tma_kernel<BN><<<grid, kThreadsW, Shape<BN>::kSmem, st>>>(map_a,
                                                                 map_b, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgrad

// ===========================================================================
// quant_s8 'dequant'

namespace dq {

constexpr int kThreadsD = 256;
constexpr int kBlocksD = 8;        // blocks a SM (launch bounds: all resident)
constexpr int kUnrollD = 1;        // chunks (their q bytes) a thread a pass
constexpr int kChunk = 16;         // elements (q bytes) a chunk

struct Params {
  const int8_t* q;
  const float* scale;
  void* out;
  long long per, total;   // elements a sample, n * per
  long long head;         // elements before the first aligned chunk
  long long chunks;       // 16-element chunks from `head` on
  int narrow;             // total <= 2^32 - 1: 32-bit sample division
};

__device__ __forceinline__ long long sample_of(const Params& p, long long i) {
  return p.narrow ? static_cast<long long>(static_cast<unsigned>(i) /
                                           static_cast<unsigned>(p.per))
                  : i / p.per;
}

template <class T>
__device__ __forceinline__ float scale_of(const Params& p, long long n) {
  const float s = __ldg(p.scale + n);
  return sizeof(T) == 2 ? round_bf16(s) : s;
}

__device__ __forceinline__ float byte_f32(const uint32_t* w, int j) {
  return static_cast<float>(static_cast<int8_t>(w[j / 4] >> (8 * (j % 4))));
}

// The V elements from i0 (bytes of `w`, little-endian) as T(q) * T(scale):
// one scale where the group lies inside one sample, else each element's
// own sample (rare: a sample not a multiple of 16 elements long, or an
// unaligned head).
template <class T, int V>
__device__ __forceinline__ void products(const Params& p, long long i0,
                                         const uint32_t (&w)[V / 4],
                                         float (&f)[V]) {
  const long long n = sample_of(p, i0);
  if (i0 + V <= (n + 1) * p.per) {
    const float s = scale_of<T>(p, n);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = __fmul_rn(byte_f32(w, j), s);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      f[j] = __fmul_rn(byte_f32(w, j), scale_of<T>(p, sample_of(p, i0 + j)));
  }
}

// V products stored at `dst` (16-byte aligned) in 16-byte stores.
template <class T, int V>
__device__ __forceinline__ void store(T* dst, const float (&f)[V]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < V / 8; ++k) {
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(f[8 * k + 2 * j], f[8 * k + 2 * j + 1]);
        ow[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      reinterpret_cast<uint4*>(dst)[k] = o;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
  }
}

// The elements outside the chunks (an unaligned head, a tail shorter than
// a chunk; every element where q and out cannot both be aligned), one a
// thread over the whole grid.
template <class T>
__device__ __forceinline__ void scalar_part(const Params& p) {
  const long long tail0 = p.head + static_cast<long long>(kChunk) * p.chunks;
  const long long rest = p.head + (p.total - tail0);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < rest; k += stride) {
    const long long i = k < p.head ? k : tail0 + (k - p.head);
    const float r = __fmul_rn(static_cast<float>(p.q[i]),
                              scale_of<T>(p, sample_of(p, i)));
    if constexpr (sizeof(T) == 2) {
      static_cast<T*>(p.out)[i] = __float2bfloat16_rn(r);
    } else {
      static_cast<T*>(p.out)[i] = r;
    }
  }
}

// The path's kernel. Persistent blocks (kBlocksD a SM); pass k of block b
// covers chunks [(k * grid + b) * kThreadsD * kUnrollD, + kThreadsD *
// kUnrollD) as groups of G = 16 / sizeof(T) elements, thread t groups u *
// kThreadsD + t: G bytes of q loaded, one 16-byte store of products, so
// each warp's loads and stores are contiguous; all its loads (kUnrollD *
// 16 bytes) issued before the first product. q is loaded evict-first
// (read once).
template <class T>
__global__ void __launch_bounds__(kThreadsD, kBlocksD)
dequant_kernel(const Params p) {
  constexpr int G = 16 / static_cast<int>(sizeof(T));
  constexpr int U = kUnrollD * kChunk / G;
  using L = typename std::conditional<G == 8, uint2, unsigned>::type;
  constexpr long long kSpan = static_cast<long long>(kThreadsD) * U;
  const long long groups = p.chunks * (kChunk / G);
  const long long step = static_cast<long long>(gridDim.x) * kSpan;
  const L* q = reinterpret_cast<const L*>(p.q + p.head);
  T* out = static_cast<T*>(p.out) + p.head;
  for (long long g0 = static_cast<long long>(blockIdx.x) * kSpan +
                      threadIdx.x;
       g0 < groups; g0 += step) {
    L v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long g = g0 + u * kThreadsD;
      if (g < groups) v[u] = __ldcs(q + g);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long g = g0 + u * kThreadsD;
      if (g < groups) {
        uint32_t w[G / 4];
        if constexpr (G == 8) {
          w[0] = v[u].x;
          w[1] = v[u].y;
        } else {
          w[0] = v[u];
        }
        float f[G];
        products<T, G>(p, p.head + G * g, w, f);
        store<T, G>(out + G * g, f);
      }
    }
  }
  scalar_part<T>(p);
}

template <class T>
int launch(const Params& p, int grid, cudaStream_t st) {
  // the plan's grid: at most the blocks the card holds at once
  void (*kernel)(Params) = &dequant_kernel<T>;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreadsD, 0)) != cudaSuccess)
    return static_cast<int>(err);
  if (grid > sms * per_sm)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, kThreadsD, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dq

// ===========================================================================
// wgrad_s8's gather route

// The gather of wgrad_s8's gather route: P [C * KH * KW, kp] from q [N,
// C, H, W] (module note). One block a (channel ci, sample n, band of
// `band` output rows); im2col::Params holds the plan (actq_cuda.im2col_plan).
namespace im2col {

constexpr int kThreadsI = 256;

struct Params {
  const int8_t* q;
  int8_t* p;
  int n, c, h, w, kh, kw, stride, pt, pl, ho, wo, kp;
  int band, bands;   // output rows a block, bands a (channel, sample)
  int rows;          // staged input rows a band: (band - 1) * stride + kh
  int pw;            // bytes a phase plane row (a multiple of 16)
  int raw;           // bytes of the bulk-copy area (0: no bulk copy)
  int tab;           // entries of the chunk table: the most chunks a block
};

// Rounds `v` (8 words, 32 bytes from a 16-byte boundary) down by `o` =
// 0..15 bytes: the 16 bytes from byte o, without indexing registers.
__device__ __forceinline__ uint4 shift_bytes(uint32_t (&v)[8], int o) {
  if (o & 8) {
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = v[i + 2];
  }
  if (o & 4) {
#pragma unroll
    for (int i = 0; i < 5; ++i) v[i] = v[i + 1];
  }
  const int sh = 8 * (o & 3);
  return make_uint4(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh),
                    __funnelshift_r(v[3], v[4], sh));
}

// q's byte at (sample, channel, input row ih, column iw), 0 outside.
__device__ __forceinline__ int8_t q_at(const Params& p, int s, int ci,
                                       int ih, int iw) {
  if (ih < 0 || ih >= p.h || iw < 0 || iw >= p.w) return 0;
  return p.q[((static_cast<long long>(s) * p.c + ci) * p.h + ih) * p.w + iw];
}

// Shared memory: the bulk copy's rows (p.raw bytes), the phase planes
// (rows * stride rows of pw bytes), then two tables that keep integer
// divisions out of the store loop: each tap's offset into the planes,
// (dy * s + dx % s) * pw + dx / s, and each chunk's offset, (oh - oh0)
// * s * s * pw + ow, or -1 where the chunk is not one run of one output
// row of the band.
__global__ void __launch_bounds__(kThreadsI) im2col_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t sm_i[];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int band = blockIdx.x % p.bands;
  const int rest = blockIdx.x / p.bands;
  const int n = rest % p.n, ci = rest / p.n;
  const int s = p.stride, taps = p.kh * p.kw;
  const int oh0 = band * p.band, oh1 = min(oh0 + p.band, p.ho);
  const int ih0 = oh0 * s - p.pt;   // staged row 0
  const int rows = (oh1 - oh0 - 1) * s + p.kh;
  const int lo = max(ih0, 0), hi = min(ih0 + rows, p.h);
  uint8_t* planes = sm_i + p.raw;
  int* tap_off = reinterpret_cast<int*>(planes + p.rows * s * p.pw);
  int* chunk_off = tap_off + taps;
  const long long plane0 =
      (static_cast<long long>(n) * p.c + ci) * p.h * p.w;
  const bool bulk = p.raw > 0 && hi > lo;
  const uint32_t b = hopper::smem_u32(&bar);

  // 1. the band's input rows lo..hi-1, contiguous in q: one bulk copy
  // into shared memory where the plan allows it (16-byte aligned rows)
  if (bulk && tid == 0) {
    hopper::mbar_init(b, 1);
    hopper::fence_barrier_init();
    const uint32_t bytes = static_cast<uint32_t>((hi - lo) * p.w);
    hopper::mbar_arrive_expect_tx(b, bytes);
    hopper::bulk_load(hopper::smem_u32(sm_i),
                      p.q + plane0 + static_cast<long long>(lo) * p.w,
                      bytes, b);
  }
  // 2. while it lands, the tables. The block's run of a P row is
  // columns [k_lo, k_hi); it writes the 16-byte chunks that start in it
  // (a chunk that runs past k_hi takes its last bytes from the next band
  // or sample through q; the chunks past n * ho * wo are zeros, written
  // by the last band of the last sample)
  const int hw = p.ho * p.wo, kvalid = p.n * hw;
  const int k_lo = n * hw + oh0 * p.wo, k_hi = n * hw + oh1 * p.wo;
  const int m0 = (k_lo + 15) / 16;
  const bool last = n == p.n - 1 && oh1 == p.ho;
  const int chunks = (last ? p.kp / 16 : (k_hi + 15) / 16) - m0;
  for (int t = tid; t < taps; t += kThreadsI) {
    const int dy = t / p.kw, dx = t - dy * p.kw;
    tap_off[t] = (dy * s + dx % s) * p.pw + dx / s;
  }
  for (int c = tid; c < chunks; c += kThreadsI) {
    const int k = (m0 + c) * 16;
    const int rel = k - n * hw;
    const int oh = rel / p.wo, ow = rel - oh * p.wo;
    chunk_off[c] = k + 16 <= kvalid && oh < oh1 && ow + 16 <= p.wo
                       ? (oh - oh0) * s * s * p.pw + ow
                       : -1;
  }
  if (bulk) {
    __syncthreads();   // the barrier's init, before anyone waits on it
    hopper::mbar_wait(b, 0);
  }
  // 3. the phase planes: plane row (j * s + f) holds padded columns f,
  // f + s, f + 2s, .. (input column e * s + f - pl) of staged row j, zero
  // outside the image, so a tap's run of output columns is contiguous;
  // a warp a plane row
  const int pw4 = p.pw / 4, warp = tid >> 5, lane = tid & 31;
  for (int jf = warp; jf < rows * s; jf += kThreadsI / 32) {
    const int j = jf / s, f = jf - j * s;
    const int ih = ih0 + j;
    const bool row_in = ih >= 0 && ih < p.h;
    const uint8_t* from_raw = sm_i + (ih - lo) * p.w;
    const int8_t* from_q = p.q + plane0 + static_cast<long long>(ih) * p.w;
    uint32_t* dst = reinterpret_cast<uint32_t*>(planes + jf * p.pw);
    for (int e4 = lane; e4 < pw4; e4 += 32) {
      uint32_t v = 0;
      if (row_in) {
        int iw = e4 * 4 * s + f - p.pl;
#pragma unroll
        for (int k = 0; k < 4; ++k, iw += s) {
          if (iw >= 0 && iw < p.w) {
            const uint32_t byte = p.raw > 0 ? from_raw[iw]
                                            : static_cast<uint8_t>(from_q[iw]);
            v |= byte << (8 * k);
          }
        }
      }
      dst[e4] = v;
    }
  }
  __syncthreads();

  // 4. for each tap, the chunks: one 16-byte store each, assembled from
  // two aligned 16-byte shared loads where the chunk is one run of a
  // plane row, a byte at a time otherwise (across rows, bands or
  // samples), zeros past n * ho * wo. (tap, chunk) advance without a
  // division.
  int tap = tid / max(chunks, 1), c = tid - tap * max(chunks, 1);
  const int step_tap = kThreadsI / max(chunks, 1);
  const int step_c = kThreadsI - step_tap * max(chunks, 1);
  for (; chunks > 0 && tap < taps; tap += step_tap, c += step_c) {
    if (c >= chunks) {
      c -= chunks;
      ++tap;
      if (tap >= taps) break;
    }
    const int k = (m0 + c) * 16;
    const int run = chunk_off[c];
    uint4 out = make_uint4(0, 0, 0, 0);
    if (run >= 0) {
      const int off = run + tap_off[tap];
      const uint4* a = reinterpret_cast<const uint4*>(planes + (off & ~15));
      const uint4 u0 = a[0], u1 = a[1];
      uint32_t v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      out = shift_bytes(v, off & 15);
    } else if (k < kvalid) {
      const int dy = tap / p.kw, dx = tap - dy * p.kw;
      alignas(16) int8_t o[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kk = k + j;
        int8_t byte = 0;
        if (kk < kvalid) {
          const int sn = kk / hw, r2 = kk - sn * hw;
          const int oh2 = r2 / p.wo, ow2 = r2 - oh2 * p.wo;
          if (sn == n && oh2 >= oh0 && oh2 < oh1) {
            byte = static_cast<int8_t>(
                planes[(oh2 - oh0) * s * s * p.pw + ow2 + tap_off[tap]]);
          } else {
            byte = q_at(p, sn, ci, oh2 * s + dy - p.pt, ow2 * s + dx - p.pl);
          }
        }
        o[j] = byte;
      }
      out = *reinterpret_cast<const uint4*>(o);
    }
    *reinterpret_cast<uint4*>(
        p.p + (static_cast<long long>(ci) * taps + tap) * p.kp + k) = out;
  }
}

}  // namespace im2col

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take).

// quant_s8 'x' (mode 0) and 'g' (mode 1), phase 3 (one launch), or 1 / 2
// (the reduction alone, the quantize alone: 'g' under a data-parallel
// group, the all-reduce of slot 0 between). The schedule (vec, grid,
// chunk_rows) is actq_cuda.quant_plan's. timing_mul 1 multiplies by the
// scale's reciprocal instead of dividing (other bits than JAX's: the
// probe's timing of the division alone); the path passes 0.
extern "C" int ursonet_actq_quant(
    const void* x, int dtype, int mode, int phase, const float* scale_in,
    int8_t* q, float* scale_out, unsigned* slots, unsigned* bar, int rows,
    int w, int copies, int wph, int s, int pl, int rps, int n, int hok,
    long long kps, long long kp, int cmaj, int alpha_len, int vec,
    int timing_mul, int grid, int chunk_rows, void* stream) {
  const int esize = dtype == kDtypeF32 ? 4 : 2;
  const bool ok =
      (dtype == kDtypeF32 || dtype == kDtypeBf16) &&
      (mode == quant::kModeX || mode == quant::kModeG) && phase >= 1 &&
      phase <= 3 && rows > 0 && w > 0 && copies > 0 && wph > 0 && s > 0 &&
      pl >= 0 && rps > 0 && n > 0 &&
      static_cast<long long>(rps) * n == rows && grid > 0 &&
      chunk_rows > 0 && static_cast<long long>(grid) * chunk_rows >= rows &&
      (mode == quant::kModeX ? scale_out != nullptr
                             : (scale_in != nullptr && hok > 0 && !cmaj &&
                                kps >= static_cast<long long>(hok) * wph &&
                                rps % hok == 0 && alpha_len >= 0 &&
                                (alpha_len == 0 || scale_out != nullptr) &&
                                kp >= n * kps &&
                                copies == 1 && s == 1 && pl == 0)) &&
      (!cmaj || (mode == quant::kModeX && hok > 0 && rps % hok == 0)) &&
      (!timing_mul || vec) &&
      (vec != 2 || (copies == 1 && s == 1 && pl == 0 &&
                    (static_cast<long long>(w) * esize) % 16 == 0)) &&
      (!vec || (aligned16(x) && aligned16(q) && wph % 16 == 0 &&
                kp % 16 == 0 &&
                (static_cast<long long>(rps) * w) % (16 / esize) == 0 &&
                (static_cast<long long>(chunk_rows) * w) % (16 / esize) == 0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  quant::Params p;
  p.x = x;
  p.scale_in = scale_in;
  p.q = q;
  p.scale_out = scale_out;
  p.slots = slots;
  p.bar = bar;
  p.rows = rows;
  p.w = w;
  p.copies = copies;
  p.wph = wph;
  p.s = s;
  p.pl = pl;
  p.rps = rps;
  p.n = n;
  p.mode = mode;
  p.phase = phase;
  p.hok = hok > 0 ? hok : 1;
  p.kps = kps;
  p.cmaj = cmaj;
  p.kp = kp;
  p.alpha_len = alpha_len;
  p.chunk_rows = chunk_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kDtypeF32
             ? quant::launch_t<float>(p, vec, timing_mul, grid, st)
             : quant::launch_t<__nv_bfloat16>(p, vec, timing_mul, grid, st);
}

// quant_s8 'dequant': out[i] = T(q[i]) * T(scale[i / per]) for i < n *
// per, T f32 (dtype 0) or bf16 (1). The schedule (head, chunks, grid) is
// actq_cuda.dequant_plan's: `head` elements before the first chunk whose
// q and out are both 16-byte aligned, then `chunks` 16-element chunks,
// the rest one element a thread.
extern "C" int ursonet_actq_dequant(const int8_t* q, const float* scale,
                                    int n, long long per, void* out,
                                    int dtype, long long head,
                                    long long chunks, int grid,
                                    void* stream) {
  const int esize = dtype == kDtypeF32 ? 4 : 2;
  const long long total = static_cast<long long>(n) * per;
  const bool ok =
      (dtype == kDtypeF32 || dtype == kDtypeBf16) && n > 0 && per > 0 &&
      head >= 0 && chunks >= 0 && head + dq::kChunk * chunks <= total &&
      grid > 0 &&
      (chunks == 0 ||
       (aligned16(q + head) &&
        aligned16(static_cast<const char*>(out) + head * esize)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  dq::Params p;
  p.q = q;
  p.scale = scale;
  p.out = out;
  p.per = per;
  p.total = total;
  p.head = head;
  p.chunks = chunks;
  p.narrow = total <= 0xffffffffLL;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kDtypeF32
             ? dq::launch<float>(p, grid, st)
             : dq::launch<__nv_bfloat16>(p, grid, st);
}

// wgrad_s8's gather route: the plan (band, rows, pw, raw, tab, smem and
// the grid's bands) is actq_cuda.im2col_plan's; raw > 0 only where w %
// 16 == 0 and q is 16-byte aligned (the bulk copy's rows).
extern "C" int ursonet_actq_im2col(const int8_t* q, int n, int c, int h,
                                   int w, int kh, int kw, int stride, int pt,
                                   int pl, int ho, int wo, int kp, int band,
                                   int rows, int pw, int raw, int tab,
                                   int smem, int8_t* p, void* stream) {
  const int bands = band > 0 ? (ho + band - 1) / band : 0;
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || ho <= 0 || wo <= 0 || kp <= 0 || kp % 16 != 0 ||
      static_cast<long long>(n) * ho * wo > kp ||
      kp - static_cast<long long>(n) * ho * wo >= 16 || !aligned16(p) ||
      band <= 0 || rows != (band - 1) * stride + kh || pw <= 0 ||
      pw % 16 != 0 ||
      pw < ((wo - 1 + (kw - 1) / stride + 16) / 16 + 1) * 16 ||
      (raw != 0 && (raw < rows * w || w % 16 != 0 || !aligned16(q) ||
                    raw % 16 != 0)) ||
      tab < (band * wo + 15) / 16 + 1 ||
      smem != raw + rows * stride * pw + 4 * (kh * kw + tab) ||
      static_cast<long long>(c) * n * bands > 0x7fffffffLL ||
      static_cast<long long>(c) * kh * kw * kp > (1LL << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  im2col::Params a;
  a.q = q;
  a.p = p;
  a.n = n;
  a.c = c;
  a.h = h;
  a.w = w;
  a.kh = kh;
  a.kw = kw;
  a.stride = stride;
  a.pt = pt;
  a.pl = pl;
  a.ho = ho;
  a.wo = wo;
  a.kp = kp;
  a.band = band;
  a.bands = bands;
  a.rows = rows;
  a.pw = pw;
  a.raw = raw;
  a.tab = tab;
  cudaError_t err = cudaFuncSetAttribute(
      im2col::im2col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  im2col::im2col_kernel<<<c * n * bands, im2col::kThreadsI, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// wgrad_s8's TMA route. q in the layout [n][ci][hk][kw copies][wph]
// (row-major) or [n][ci][kw copies][hk][wph] (cmaj, stride 1); qgt
// [co][kp], kp = n * ksample, output row oh of sample n at n * ksample +
// oh * wst (row-major: wst = wop, ksample = hop * wop); the tile walk
// (splits, grid) is actq_cuda.wgrad_tiles'. out: f32 dw [co][ci * kh *
// kw] with alpha, else int32.
extern "C" int ursonet_actq_wgrad_tma(
    const int8_t* q, const int8_t* qgt, const float* alpha, void* out,
    int* ws, int* counters, int n, int ci, int hk, int copies, int wph,
    int co, int kh, int kw, int s, int pt, int cmaj, int wst,
    long long ksample, long long kp, int bn, int splits, int grid,
    void* stream) {
  using namespace wgrad;
  const int wop = wst;
  const int wseg = cmaj ? kBK : (wop < kBK ? wop : kBK);
  const int hb = kBK / (wseg > 0 ? wseg : 1);
  const long long hop = cmaj ? 0 : ksample / (wop > 0 ? wop : 1);
  const long long ksteps = kp / kBK;
  const long long kps = (ksteps + splits - 1) / (splits > 0 ? splits : 1);
  const int cblocks = (ci + bn - 1) / (bn > 0 ? bn : 1);
  const long long tiles =
      static_cast<long long>((co + kBM - 1) / kBM) * kh * kw * cblocks;
  const bool ok =
      n > 0 && ci > 0 && hk > 0 && co > 0 && kh > 0 && kw > 0 && s >= 1 &&
      copies == kw && wph > 0 && wph % 16 == 0 && ksample > 0 &&
      ksample % kBK == 0 && kp == n * ksample && ksteps < (1LL << 30) &&
      (cmaj ? (s == 1 && wst == wph)
            : ((wop == 32 || wop == 64 || (wop > 0 && wop % kBK == 0)) &&
               hop > 0 && hop % hb == 0 && hop * wop == ksample)) &&
      (bn == 128 || bn == 256) &&
      splits >= 1 && (splits - 1) * kps < ksteps && grid >= 1 &&
      tiles * splits < (1LL << 30) && aligned16(q) && aligned16(qgt) &&
      (splits == 1 || (ws != nullptr && counters != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!hopper::make_byte_map(&map_a, qgt, kp, co, kp, kBK, kBM) ||
      !make_patch_map(&map_b, q, n, ci, hk, copies, wph, wseg, cmaj, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.co = co;
  p.ci = ci;
  p.taps = kh * kw;
  p.kw = kw;
  p.r = ci * kh * kw;
  p.s = s;
  p.pt = pt;
  p.cmaj = cmaj;
  p.spp = static_cast<int>(ksample / kBK);
  p.wph = wph;
  p.hb = hb;
  p.segs = cmaj ? 1 : wop / wseg;
  p.wseg = wseg;
  p.hop = static_cast<int>(hop);
  p.cblocks = cblocks;
  p.n_tiles = kh * kw * cblocks;
  p.tiles = static_cast<int>(tiles);
  p.items = static_cast<int>(tiles * splits);
  p.ksteps = static_cast<int>(ksteps);
  p.kps = static_cast<int>(kps);
  p.splits = splits;
  p.alpha = alpha;
  p.out = out;
  p.ws = ws;
  p.counters = counters;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bn == 256 ? launch<256>(map_a, map_b, p, grid, st)
                   : launch<128>(map_a, map_b, p, grid, st);
}

extern "C" const char* ursonet_actq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
