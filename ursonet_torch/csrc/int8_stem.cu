// The fused int8 stem for Hopper (sm_90a): input quantize, the 4x4/1
// space-to-depth stem conv, ReLU + requantize and the 3x3/2 SAME max-pool
// in one kernel, bound through a plain C interface (ctypes; see
// ursonet_torch/ops/int8_cuda.py::stem_s8).
//
// Replaces the Pallas TPU kernel tools/probe_pallas_stem.py::_stem_kernel.
// That kernel could not subsample inside Mosaic, so a host pre-pass split
// the padded input into column-parity planes, the kernel built a
// [2*33*W/2, 192] patch matrix per 16-row band in VMEM for one MXU
// matmul, and the pool ran on rolls and leading-dimension reshapes. None
// of that is carried over: a thread block reads the taps it needs.
//
// Computes, for space-to-depth pixels x [B, H2, W2, 12] u8 and the s2d
// stem kernel Wt [64][4][4][12] s8 (output-channel-major):
//   q    = quantize(x)                          (per mode, below)
//   conv = sum over (ky, kx, c) q[r - 2 + ky, s - 2 + kx, c] * W[ky, kx, c, n]
//          (pads (2, 1), (2, 1), the padding filled per mode)
//   y    = clip(rint(max(fma(f32(conv), alpha[n], beta[n]), 0) * inv_s_out),
//               0, 127)                         (q8_relu of int8_common.cuh)
//   out  = 3x3/2 SAME max-pool of y             [B, ceil(H2/2), ceil(W2/2), 64]
// Input modes:
//   calibrated  q = clip(rint((f32(x) - mean[c]) * inv_s_in), -127, 127),
//               padding 0: the serving model's input quantize
//   shift128    q = x - 128, padding rint(mean[c]) - 128: the TPU probe's
// The pool's padding never wins: y >= 0 and every window holds a pixel of
// the image, so cells outside the image are written as 0.
//
// Bound. Per pooled pixel the kernel reads 4 * 12 input bytes, writes 64
// and does 4 * 2 * 192 * 64 operations: 878 operations a byte against the
// card's ~590, so the bound is the tensor cores' (0.130 ms at batch 128,
// 512x640), with the bytes' close behind (0.088 ms). The unfused route
// wrote the 64-wide conv output to device memory and read it back for the
// pool: 5.3 times the bytes. Design: one block owns 8 x 16 pooled pixels.
// It stages the 20 x 36 input pixels they need (quantized as they are
// stored) and the 12 KB of weights in shared memory, computes the 17 x 33
// conv outputs (the halo row and column are recomputed, 9.6% more
// products, nothing is exchanged between blocks) as m16n8k32 mma.sync
// tiles whose A fragments are read straight from the staged pixels: for
// one ky the 4 taps x 12 channels of a conv pixel are 48 contiguous
// bytes, so K = 192 is 4 runs of 48 bytes and no patch matrix exists.
// The requantized s8 conv tile goes to shared memory, the pool reads it
// four channels at a time (__vmaxs4) and writes 64 contiguous bytes a
// pooled pixel.

#include <math.h>

#include "int8_common.cuh"

namespace ursonet_int8 {
namespace {

constexpr int TPH = 8, TPW = 16;            // pooled pixels a block
constexpr int CR = 2 * TPH + 1, CW = 2 * TPW + 1;   // conv pixels a block
constexpr int CM = CR * CW;                 // 561 rows of the block's GEMM
constexpr int IR = CR + 3, IC = CW + 3;     // staged input pixels
constexpr int XROW = IC * 12;               // bytes a staged input row
constexpr int XWORDS = XROW / 4;            // 108
constexpr int KTOT = 192, N = 64;
constexpr int WROW = KTOT + 16;             // padded weight row: no conflicts
constexpr int QROW = N + 4;                 // padded conv-tile pixel stride
constexpr int PAIRS = (CM + 31) / 32;       // 18 units of 32 GEMM rows
constexpr int WARPS = 9;                    // 2 units each
constexpr int THREADS = WARPS * 32;
constexpr int XS_BYTES = IR * XROW;         // 8640
constexpr int WS_BYTES = N * WROW;          // 13312
constexpr int QS_BYTES = CM * QROW;         // 38148
constexpr int SMEM_BYTES = XS_BYTES + WS_BYTES + QS_BYTES;

enum InputMode { kCalibrated = 0, kShift128 = 1 };

struct StemArgs {
  const uint8_t* x;
  const int8_t* wt;
  int B, H2, W2, PH, PW, plo_y, plo_x, tiles_y, tiles_x, mode;
  float mean[12];
  int fill[12];
  float inv_s_in;
  const float* alpha;
  const float* beta;
  float inv_s_out;
  int8_t* out;
};

__device__ __forceinline__ int quantize_pixel(int v, float mean, float inv,
                                              int mode) {
  if (mode == kShift128) return v - 128;
  const float d = __fsub_rn(__int2float_rn(v), mean);
  return static_cast<int>(saturate_s8(rintf(__fmul_rn(d, inv)), -127.f));
}

__global__ void __launch_bounds__(THREADS) stem_s8_kernel(StemArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;
  int8_t* ws = smem + XS_BYTES;
  int8_t* qs = smem + XS_BYTES + WS_BYTES;
  __shared__ float s_mean[12];
  __shared__ int s_fill[12];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int blk = blockIdx.x;
  const int tx = blk % p.tiles_x;
  blk /= p.tiles_x;
  const int ty = blk % p.tiles_y;
  const int b = blk / p.tiles_y;
  const int py0 = ty * TPH, px0 = tx * TPW;
  const int cr0 = 2 * py0 - p.plo_y, cc0 = 2 * px0 - p.plo_x;
  const int ir0 = cr0 - 2, ic0 = cc0 - 2;

  if (tid < 12) {
    s_mean[tid] = p.mean[tid];
    s_fill[tid] = p.fill[tid];
  }
  // weights: 64 rows of 192 bytes = 12 int4 chunks each
  for (int i = tid; i < N * (KTOT / 16); i += THREADS) {
    const int n = i / (KTOT / 16), c = i - n * (KTOT / 16);
    *reinterpret_cast<int4*>(ws + n * WROW + c * 16) =
        __ldg(reinterpret_cast<const int4*>(p.wt + n * KTOT + c * 16));
  }
  __syncthreads();

  // input pixels, quantized as they are stored; one 32-bit word holds 4
  // channels of one pixel (12 channels = 3 words)
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(p.x);
  uint32_t* xs32 = reinterpret_cast<uint32_t*>(xs);
  for (int i = tid; i < IR * XWORDS; i += THREADS) {
    const int r = i / XWORDS, w = i - r * XWORDS;
    const int col = w / 3, part = w - col * 3;
    const int gr = ir0 + r, gc = ic0 + col, ch = part * 4;
    uint32_t packed = 0;
    if (gr >= 0 && gr < p.H2 && gc >= 0 && gc < p.W2) {
      const uint32_t v = __ldg(
          x32 + ((static_cast<int64_t>(b) * p.H2 + gr) * p.W2 + gc) * 3 + part);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = quantize_pixel((v >> (8 * j)) & 0xff, s_mean[ch + j],
                                     p.inv_s_in, p.mode);
        packed |= static_cast<uint32_t>(q & 0xff) << (8 * j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed |= static_cast<uint32_t>(s_fill[ch + j] & 0xff) << (8 * j);
    }
    xs32[i] = packed;
  }
  __syncthreads();

  // the block's GEMM: [CM, 192] x [192, 64], 32 rows a unit
  const int g = lane >> 2, t = lane & 3;
  for (int unit = warp; unit < PAIRS; unit += WARPS) {
    int acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
    const int8_t* arow[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(unit * 32 + i * 16 + g + 8 * h, CM - 1);
        const int cr = m / CW, cc = m - cr * CW;
        arow[i][h] = xs + cr * XROW + cc * 12;
      }
#pragma unroll
    for (int ks = 0; ks < KTOT / 32; ++ks) {
      // k = ky * 48 + (kx * 12 + c): 48 contiguous staged bytes per ky
      const int k0 = ks * 32 + 4 * t, k1 = k0 + 16;
      const int o0 = (k0 / 48) * XROW + k0 % 48;
      const int o1 = (k1 / 48) * XROW + k1 % 48;
      uint32_t a[2][4], bf[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = *reinterpret_cast<const uint32_t*>(arow[i][0] + o0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(arow[i][1] + o0);
        a[i][2] = *reinterpret_cast<const uint32_t*>(arow[i][0] + o1);
        a[i][3] = *reinterpret_cast<const uint32_t*>(arow[i][1] + o1);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* q = ws + (j * 8 + g) * WROW + k0;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(q);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], a[i], bf[j]);
    }
    // q8_relu into the shared conv tile; 0 outside the image
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = unit * 32 + i * 16 + g + 8 * h;
        if (m >= CM) continue;
        const int cr = m / CW, cc = m - cr * CW;
        const int gr = cr0 + cr, gc = cc0 + cc;
        const bool inside = gr >= 0 && gr < p.H2 && gc >= 0 && gc < p.W2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = j * 8 + 2 * t;
          int lo = 0, hi = 0;
          if (inside) {
            lo = requant_relu(acc[i][j][2 * h], __ldg(p.alpha + n),
                              __ldg(p.beta + n), p.inv_s_out);
            hi = requant_relu(acc[i][j][2 * h + 1], __ldg(p.alpha + n + 1),
                              __ldg(p.beta + n + 1), p.inv_s_out);
          }
          *reinterpret_cast<uint16_t*>(qs + m * QROW + n) =
              static_cast<uint16_t>((lo & 0xff) | ((hi & 0xff) << 8));
        }
      }
  }
  __syncthreads();

  // 3x3/2 max-pool of the conv tile, 4 channels a thread
  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  uint32_t* out32 = reinterpret_cast<uint32_t*>(p.out);
  for (int i = tid; i < TPH * TPW * (N / 4); i += THREADS) {
    const int wd = i & 15, pix = i >> 4;
    const int py = pix / TPW, px = pix - py * TPW;
    const int gy = py0 + py, gx = px0 + px;
    if (gy >= p.PH || gx >= p.PW) continue;
    uint32_t v = 0;   // y >= 0: 0 is the identity
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        v = __vmaxs4(v, qs32[((2 * py + dy) * CW + 2 * px + dx) * (QROW / 4)
                             + wd]);
    out32[((static_cast<int64_t>(b) * p.PH + gy) * p.PW + gx) * (N / 4) + wd] =
        v;
  }
}

}  // namespace
}  // namespace ursonet_int8

extern "C" int ursonet_stem_s8(const void* x, const void* wt, int B, int H2,
                               int W2, int mode, const float* mean12,
                               float inv_s_in, const void* alpha,
                               const void* beta, float inv_s_out, void* out,
                               int device, void* stream) {
  using namespace ursonet_int8;
  if (B <= 0 || H2 <= 0 || W2 <= 0 || x == nullptr || wt == nullptr ||
      mean12 == nullptr || alpha == nullptr || beta == nullptr ||
      out == nullptr || (mode != kCalibrated && mode != kShift128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StemArgs a;
  a.x = static_cast<const uint8_t*>(x);
  a.wt = static_cast<const int8_t*>(wt);
  a.B = B;
  a.H2 = H2;
  a.W2 = W2;
  a.PH = (H2 + 1) / 2;
  a.PW = (W2 + 1) / 2;
  // 3/2 SAME: even sizes pad (0, 1), odd sizes (1, 1)
  a.plo_y = H2 % 2;
  a.plo_x = W2 % 2;
  a.tiles_y = (a.PH + TPH - 1) / TPH;
  a.tiles_x = (a.PW + TPW - 1) / TPW;
  a.mode = mode;
  for (int c = 0; c < 12; ++c) {
    a.mean[c] = mean12[c];
    a.fill[c] = mode == kShift128
                    ? static_cast<int>(nearbyintf(mean12[c])) - 128 : 0;
  }
  a.inv_s_in = inv_s_in;
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.inv_s_out = inv_s_out;
  a.out = static_cast<int8_t*>(out);
  const long long blocks =
      static_cast<long long>(B) * a.tiles_y * a.tiles_x;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(stem_s8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_s8_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ursonet_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
