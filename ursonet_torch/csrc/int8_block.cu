// A whole int8 identity bottleneck block in one kernel for Hopper
// (sm_90a), bound through a plain C interface (ctypes; see
// ursonet_torch/probes/fused_block.py::block_s8).
//
// Replaces the Pallas TPU kernel tools/probe_fused_block.py::_fused_kernel
// (one image x one 16- or 32-row strip per grid step, DMA of the strip
// and its halo rows into VMEM, the 3x3 as nine dots whose partial sums
// are shifted by a column). Here a block of threads owns an 8 x 16 tile
// of output pixels and reads the taps it needs from shared memory.
//
// Computes, for x [B, H, W, 256] s8 and the weights w1 [256 -> 64],
// w2 [3x3, 64 -> 64], w3 [64 -> 256] (all output-channel-major, K
// contiguous) and the rows a1, b1, a2, b2, a3, b3, res of `ab`:
//   m1  = clip(rint(max(fma(x . w1, a1, b1), 0)), 0, 127)     1x1
//   m2  = clip(rint(max(fma(conv3x3_SAME(m1, w2), a2, b2), 0)), 0, 127)
//   out = clip(rint(max(fma(m2 . w3, a3, b3) + f32(x) * res, 0)), 0, 127)
// The rounding order is the serving kernels' (int8_common.cuh): one FMA
// for acc * a + b, the residual product rounded, then the sum rounded.
// The 3x3 pads m1 with zeros: m1 of a pixel outside the image is 0, not
// requant(b1), so the halo pixels outside the image are forced to 0.
//
// Bound. x is read once and out written once (2 * B*H*W*256 bytes); the
// three products do 2 * (256*64 + 9*64*64 + 64*256) = 139,264 operations
// a pixel against 512 bytes: 272 operations a byte, under the card's
// ~590, so the bound is the bytes' (0.40 ms at B = 128, 128 x 160). The
// unfused route writes and reads m1 and m2 and reads x twice: 1.5 times
// the bytes. Design: persistent blocks (one per SM, 146 KB of shared
// memory: the three weight matrices, staged once per block, the x tile
// with a one-pixel halo, m1 on tile + halo, m2 on the tile) walk over
// the tiles. Per tile: stage x (zeros outside the image); m1 for the 180
// halo pixels; m2 for the 128 tile pixels with the nine taps read from
// m1 in place (no patch matrix); the last product with the residual read
// from the x tile already there, the result written over it, and the
// tile stored with 16-byte rows. All products are m16n8k32 mma.sync on
// fragments read from padded shared-memory rows.

#include "int8_common.cuh"

namespace ursonet_int8 {
namespace {

constexpr int CIN = 256, CMID = 64;
constexpr int TH = 8, TW = 16, TP = TH * TW;        // tile pixels
constexpr int HH = TH + 2, HW = TW + 2, HP = HH * HW;   // with halo: 180
constexpr int XLD = CIN + 16, MLD = CMID + 16;
constexpr int W1LD = CIN + 16, W2LD = 9 * CMID + 16, W3LD = CMID + 16;
constexpr int OFF_M1 = HP * XLD;
constexpr int OFF_M2 = OFF_M1 + HP * MLD;
constexpr int OFF_W1 = OFF_M2 + TP * MLD;
constexpr int OFF_W2 = OFF_W1 + CMID * W1LD;
constexpr int OFF_W3 = OFF_W2 + CMID * W2LD;
constexpr int SMEM_BYTES = OFF_W3 + CIN * W3LD;     // 149,376
constexpr int THREADS = 256;

struct BlockArgs {
  const int8_t* x;
  const int8_t* w1;   // [64][256]
  const int8_t* w2;   // [64][9 * 64], k = (ky * 3 + kx) * 64 + c
  const int8_t* w3;   // [256][64]
  const float* ab;    // rows a1, b1, a2, b2, a3, b3, res; stride ldab
  int ldab, B, H, W, tiles_y, tiles_x;
  int8_t* out;
};

// rows [rows][kbytes] of device memory into padded shared-memory rows
__device__ __forceinline__ void stage_rows(const int8_t* __restrict__ G,
                                           int rows, int kbytes, int8_t* S,
                                           int ld) {
  const int chunks = kbytes / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    *reinterpret_cast<int4*>(S + r * ld + c * 16) =
        __ldg(reinterpret_cast<const int4*>(G + r * kbytes + c * 16));
  }
}

__device__ __forceinline__ void zero_acc(int (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
}

// One 32-byte K step of a 32 x 32 warp unit: arow[i][h] points at the K
// run of row i * 16 + g + 8 * h, brow at weight row n0 + g (stride ldb).
__device__ __forceinline__ void unit_step(const int8_t* (&arow)[2][2],
                                          int aoff, const int8_t* brow,
                                          int ldb, int boff,
                                          int (&acc)[2][4][4]) {
  uint32_t a[2][4], b[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[i][0] = *reinterpret_cast<const uint32_t*>(arow[i][0] + aoff);
    a[i][1] = *reinterpret_cast<const uint32_t*>(arow[i][1] + aoff);
    a[i][2] = *reinterpret_cast<const uint32_t*>(arow[i][0] + aoff + 16);
    a[i][3] = *reinterpret_cast<const uint32_t*>(arow[i][1] + aoff + 16);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int8_t* q = brow + j * 8 * ldb + boff;
    b[j][0] = *reinterpret_cast<const uint32_t*>(q);
    b[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
}

__global__ void __launch_bounds__(THREADS) block_s8_kernel(BlockArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;
  int8_t* m1 = smem + OFF_M1;
  int8_t* m2 = smem + OFF_M2;
  int8_t* w1s = smem + OFF_W1;
  int8_t* w2s = smem + OFF_W2;
  int8_t* w3s = smem + OFF_W3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, t4 = t * 4;
  const float* a1 = p.ab;
  const float* b1 = p.ab + p.ldab;
  const float* a2 = p.ab + 2 * p.ldab;
  const float* b2 = p.ab + 3 * p.ldab;
  const float* a3 = p.ab + 4 * p.ldab;
  const float* b3 = p.ab + 5 * p.ldab;
  const float* rs = p.ab + 6 * p.ldab;

  stage_rows(p.w1, CMID, CIN, w1s, W1LD);
  stage_rows(p.w2, CMID, 9 * CMID, w2s, W2LD);
  stage_rows(p.w3, CIN, CMID, w3s, W3LD);

  const int per_image = p.tiles_y * p.tiles_x;
  const int tiles = p.B * per_image;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_image;
    const int rem = tile - b * per_image;
    const int y0 = (rem / p.tiles_x) * TH, x0 = (rem % p.tiles_x) * TW;
    const int8_t* xb = p.x + static_cast<int64_t>(b) * p.H * p.W * CIN;

    // x tile with its halo, zeros outside the image
    for (int i = tid; i < HP * (CIN / 16); i += THREADS) {
      const int pix = i >> 4, c = i & 15;
      const int gy = y0 - 1 + pix / HW, gx = x0 - 1 + pix % HW;
      int4 v = make_int4(0, 0, 0, 0);
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        v = __ldg(reinterpret_cast<const int4*>(
            xb + (static_cast<int64_t>(gy) * p.W + gx) * CIN + c * 16));
      }
      *reinterpret_cast<int4*>(xs + pix * XLD + c * 16) = v;
    }
    __syncthreads();

    // m1 = requant(x . w1) on the 180 halo pixels: 6 x 2 units
    for (int u = warp; u < 12; u += THREADS / 32) {
      const int mu = u >> 1, n0 = (u & 1) * 32;
      int acc[2][4][4];
      zero_acc(acc);
      const int8_t* arow[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          arow[i][h] = xs + min(mu * 32 + i * 16 + g + 8 * h, HP - 1) * XLD
                       + t4;
      const int8_t* brow = w1s + (n0 + g) * W1LD + t4;
#pragma unroll
      for (int kk = 0; kk < CIN; kk += 32)
        unit_step(arow, kk, brow, W1LD, kk, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mu * 32 + i * 16 + g + 8 * h;
          if (m >= HP) continue;
          const int gy = y0 - 1 + m / HW, gx = x0 - 1 + m % HW;
          const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + j * 8 + 2 * t;
            int lo = 0, hi = 0;
            if (inside) {
              lo = requant_relu(acc[i][j][2 * h], __ldg(a1 + n),
                                __ldg(b1 + n), 1.f);
              hi = requant_relu(acc[i][j][2 * h + 1], __ldg(a1 + n + 1),
                                __ldg(b1 + n + 1), 1.f);
            }
            *reinterpret_cast<uint16_t*>(m1 + m * MLD + n) =
                static_cast<uint16_t>((lo & 0xff) | ((hi & 0xff) << 8));
          }
        }
    }
    __syncthreads();

    // m2 = requant(conv3x3(m1, w2)) on the 128 tile pixels: 4 x 2 units
    {
      const int mu = warp >> 1, n0 = (warp & 1) * 32;
      int acc[2][4][4];
      zero_acc(acc);
      const int8_t* arow[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = mu * 32 + i * 16 + g + 8 * h;
          arow[i][h] = m1 + ((px >> 4) * HW + (px & 15)) * MLD + t4;
        }
      const int8_t* brow = w2s + (n0 + g) * W2LD + t4;
#pragma unroll
      for (int kk = 0; kk < 9 * CMID; kk += 32) {
        const int tap = kk / CMID, ky = tap / 3, kx = tap - ky * 3;
        unit_step(arow, (ky * HW + kx) * MLD + kk % CMID, brow, W2LD, kk,
                  acc);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = mu * 32 + i * 16 + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + j * 8 + 2 * t;
            const int lo = requant_relu(acc[i][j][2 * h], __ldg(a2 + n),
                                        __ldg(b2 + n), 1.f);
            const int hi = requant_relu(acc[i][j][2 * h + 1],
                                        __ldg(a2 + n + 1), __ldg(b2 + n + 1),
                                        1.f);
            *reinterpret_cast<uint16_t*>(m2 + px * MLD + n) =
                static_cast<uint16_t>((lo & 0xff) | ((hi & 0xff) << 8));
          }
        }
    }
    __syncthreads();

    // out = requant(relu(m2 . w3 + x * res)), written over the x tile:
    // 4 x 8 units
    for (int u = warp; u < 32; u += THREADS / 32) {
      const int mu = u & 3, n0 = (u >> 2) * 32;
      int acc[2][4][4];
      zero_acc(acc);
      const int8_t* arow[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          arow[i][h] = m2 + (mu * 32 + i * 16 + g + 8 * h) * MLD + t4;
      const int8_t* brow = w3s + (n0 + g) * W3LD + t4;
#pragma unroll
      for (int kk = 0; kk < CMID; kk += 32)
        unit_step(arow, kk, brow, W3LD, kk, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = mu * 32 + i * 16 + g + 8 * h;
          int8_t* centre = xs + (((px >> 4) + 1) * HW + (px & 15) + 1) * XLD;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + j * 8 + 2 * t;
            const int lo = requant_join(
                acc[i][j][2 * h], __ldg(a3 + n), __ldg(b3 + n),
                static_cast<int>(centre[n]), __ldg(rs + n), 1.f);
            const int hi = requant_join(
                acc[i][j][2 * h + 1], __ldg(a3 + n + 1), __ldg(b3 + n + 1),
                static_cast<int>(centre[n + 1]), __ldg(rs + n + 1), 1.f);
            *reinterpret_cast<uint16_t*>(centre + n) =
                static_cast<uint16_t>((lo & 0xff) | ((hi & 0xff) << 8));
          }
        }
    }
    __syncthreads();

    // the tile out, 16 bytes a thread
    int8_t* ob = p.out + static_cast<int64_t>(b) * p.H * p.W * CIN;
    for (int i = tid; i < TP * (CIN / 16); i += THREADS) {
      const int px = i >> 4, c = i & 15;
      const int gy = y0 + (px >> 4), gx = x0 + (px & 15);
      if (gy < p.H && gx < p.W) {
        *reinterpret_cast<int4*>(
            ob + (static_cast<int64_t>(gy) * p.W + gx) * CIN + c * 16) =
            *reinterpret_cast<const int4*>(
                xs + (((px >> 4) + 1) * HW + (px & 15) + 1) * XLD + c * 16);
      }
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace ursonet_int8

extern "C" int ursonet_block_s8(const void* x, const void* w1, const void* w2,
                                const void* w3, const void* ab, int ldab,
                                int B, int H, int W, int cin, int cmid,
                                void* out, int device, void* stream) {
  using namespace ursonet_int8;
  if (x == nullptr || w1 == nullptr || w2 == nullptr || w3 == nullptr ||
      ab == nullptr || out == nullptr || B <= 0 || H <= 0 || W <= 0 ||
      cin != CIN || cmid != CMID || ldab < CIN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w1 = static_cast<const int8_t*>(w1);
  a.w2 = static_cast<const int8_t*>(w2);
  a.w3 = static_cast<const int8_t*>(w3);
  a.ab = static_cast<const float*>(ab);
  a.ldab = ldab;
  a.B = B;
  a.H = H;
  a.W = W;
  a.tiles_y = (H + TH - 1) / TH;
  a.tiles_x = (W + TW - 1) / TW;
  a.out = static_cast<int8_t*>(out);
  const long long tiles = static_cast<long long>(B) * a.tiles_y * a.tiles_x;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(block_s8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  block_s8_kernel<<<blocks, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ursonet_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
