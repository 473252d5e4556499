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
//               0, 127)                         (q8_relu of int8_common.cuh;
//          in the bf16 mode (`bf16`, F16) its bf16 form, requant_relu_bf16)
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
// pooled pixel. This is the 'ragged' route (any width): one block a tile,
// 20,480 blocks at the flagship shape, each staging the weights anew.
//
// The 'tma' route (stem_s8_tma_kernel; W2 % 4 == 0 and 16-byte aligned
// pointers, every served batch) computes the same bits with the Hopper
// machinery of hopper.cuh:
//   Blocks   persistent, one per SM, 384 threads (3 warpgroups), walking
//            the tiles tile = blockIdx.x, + gridDim.x, ... (same tiles
//            as above, neighbours on neighbouring SMs share their halo
//            through L2).
//   Weights  staged once per block as the wgmma B operand: 64 rows of
//            192 bytes in two 128-byte-swizzled K-blocks (the second
//            half-used: K = 192 is 1.5 swizzle rows, its k32 steps 4
//            and 5 read bytes 128..191 only); alpha and beta once, as
//            (alpha, beta) pairs.
//   Input    TMA loads of the 20 x 36 packed pixels a tile needs, viewed
//            as 32-bit words [B][H2][W2 * 3] (a row is 16-byte aligned
//            when W2 % 4 == 0), into a ring of 3 stages: thread 0 keeps
//            the next two tiles in flight while the block computes this
//            one. A box must start on a 16-byte boundary (a box at word
//            3 * ic0 faults otherwise), so it starts at the multiple of 4
//            words at or below it and is 120 words wide: the tile's 108
//            words lie `shift` = 0..3 words into each 480-byte staged
//            row. TMA fills out-of-bounds words with zeros; the quantize
//            overwrites every pixel outside the image with the mode's
//            fill value, so the zeros never count.
//   Quantize once per staged byte, in place, a pixel a thread, through
//            a 12 x 256 table of the mode's quantize built once per block
//            (exact: the table holds the function itself).
//   GEMM     the tile's 561 conv pixels, padded to 9 row-chunks of 64
//            (576 rows), 3 chunks a warpgroup: wgmma.m64n64k32 s8 with A
//            from registers (loaded from the staged pixels, one row of
//            the 4 x 4 window a fragment lane: the depth is permuted the
//            same way in A and B, see load_a) and B from the resident
//            weights. Two accumulator sets: a chunk's products run while
//            the warpgroup requantizes the previous chunk.
//   Cost     the halo (17 x 33 conv pixels for 16 x 32 owned) is 9.6%
//            more products, the padding to 576 rows another 2.7%: 12.5%
//            over the conv the output needs.
//   Epilogue q8_relu of each accumulator (one FMA, one multiply, a min
//            at 127 and a saturating conversion: the bits of
//            requant_relu; in the bf16 mode, a template flag of the
//            kernel, three roundings to bf16, a multiply and an add in
//            place of the FMA: requant_relu_bf16, with alpha and beta
//            rounded once as they are staged) into a conv tile in
//            shared memory that keeps
//            each value in a 16-bit lane, 0 outside the image; then the
//            3x3/2 pool, 8 channels a thread, as 3-way maxima of 16-bit
//            lanes (__vimax3_s16x2, one DPX instruction on Hopper, where
//            the byte-wise __vmaxs4 / __vminu4 cost eight each), 64
//            contiguous output bytes a pixel.
//   Stalls   every mbarrier wait is hopper::mbar_wait, which traps after
//            ~3 s instead of hanging the card.
//
// The 'nhwc' route (the same kernel, NHWC = true; H even, W % 16 == 0
// and 16-byte aligned pointers) takes the uint8 NHWC batch x [B, H, W, 3]
// itself, the `base` variant's input, and computes the same bits as the
// 'tma' route on space_to_depth2(x) (packed channel (dy * 2 + dx) * 3 + c
// of packed pixel (r, s) is raw pixel (2r + dy, 2s + dx), channel c):
// the 7x7/2 stem with pads (3, 3) is exactly the s2d stem with pads
// (2, 1) on the packed image (models/resnet.py::stem_kernel_to_s2d), so
// the whole `base` stem section (input quantize, conv, requant, pool) is
// one launch and nothing is packed in device memory.
//   Input    TMA boxes over x viewed as 32-bit words [B][H][W * 3 / 4]
//            (a raw row of W * 3 bytes is a multiple of 16 when W % 16 ==
//            0): a tile's 20 x 36 packed pixels are 2 * 20 raw rows of 72
//            raw pixels, 216 bytes from byte 6 * ic0 of each. The box
//            starts at the multiple of 16 bytes at or below it and is 240
//            bytes (60 words) x 40 rows: the tile's bytes lie `shift` = 0,
//            2, .., 14 bytes in. 40 x 240 = 9600 bytes, the packed box's
//            size; the same ring of 3 stages.
//   Quantize reads the raw stage (a packed pixel's 12 bytes are 6 of raw
//            row 2r and 6 of raw row 2r + 1, as 16-bit loads: the shift
//            is even) through the same table and writes the packed,
//            quantized tile into a buffer of its own in the layout load_a
//            reads (rows of 480 bytes, the pixel's bytes in packed channel
//            order); pixels outside the image take the mode's fill. The
//            stage is then free: its next TMA load is issued right after
//            the quantize, a GEMM earlier than on the 'tma' route.
//   The GEMM, the epilogue, the conv tile and the pool are the 'tma'
//   route's. Bound: the 7x7 conv's 2 * 147 * 64 operations a conv pixel
//   (0.0997 ms at batch 128, 512x640; the s2d form does 192 / 147 of them,
//   the rewrite's zeros) against 125.8 MB in and 167.8 MB out (0.0876 ms).

#include <math.h>

#include "hopper.cuh"
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
  int bf16;            // 1: the bf16 accumulation mode of the epilogue
  int8_t* out;
  int tiles;
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
            const int a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
            const float al0 = __ldg(p.alpha + n), al1 = __ldg(p.alpha + n + 1);
            const float be0 = __ldg(p.beta + n), be1 = __ldg(p.beta + n + 1);
            lo = p.bf16 ? requant_relu_bf16(a0, al0, be0, p.inv_s_out)
                        : requant_relu(a0, al0, be0, p.inv_s_out);
            hi = p.bf16 ? requant_relu_bf16(a1, al1, be1, p.inv_s_out)
                        : requant_relu(a1, al1, be1, p.inv_s_out);
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

// ---- the 'tma' route ----------------------------------------------------

namespace tma_stem {

constexpr int kWgs = 3, kThreads = 128 * kWgs;
constexpr int kChunks = (CM + 63) / 64;                 // 9 row-chunks of 64
static_assert(kChunks == 3 * kWgs, "three chunks a warpgroup");
constexpr int kStages = 3;
// 108 words + the shift; 120 words (24 mod 32 banks) rather than 112
// make the A-fragment loads of a warp hit 32 distinct banks (load_a)
constexpr int kBoxWords = 120;
constexpr int kXRow = kBoxWords * 4;           // bytes a staged row
constexpr int kBoxBytes = IR * kXRow;          // 9600
constexpr int kStageBytes = (kBoxBytes + 127) / 128 * 128;
constexpr int kWsBytes = 2 * N * 128;                    // two K-blocks
// the conv tile holds each value in a 16-bit lane (channels n, n + 1 in
// one word), pixels 144 bytes apart: the epilogue's 32-bit stores of a
// warp hit 32 distinct banks, and 8 lanes read a pixel's 128 bytes
constexpr int kQRow = 144;
constexpr int kQsBytes = CM * kQRow;
constexpr int kTabBytes = 12 * 256;
// the 'nhwc' route's box: 2 * IR raw rows of 240 bytes (60 words), the
// same bytes as the packed route's box
constexpr int kRawRow = 240;
constexpr int kRawRows = 2 * IR;
static_assert(kRawRow * kRawRows == kBoxBytes, "the boxes' bytes agree");
static_assert((IC * 6 + 14) <= kRawRow, "the shifted tile fits the box");
constexpr int kEndBytes = kWsBytes + kStages * kStageBytes + kQsBytes +
                          N * 8 + kTabBytes + kStages * 8;
// the 'nhwc' route's packed, quantized tile, after everything else
constexpr int kXqOff = (kEndBytes + 127) / 128 * 128;
template <bool NHWC>
constexpr int smem_bytes() {
  return 1024 + (NHWC ? kXqOff + kBoxBytes : kEndBytes);
}

// w0, shift: the box's first word (a multiple of 4) and how far the
// tile's first pixel lies into each staged row: 3 * ic0 - w0 words on
// the 'tma' route; on the 'nhwc' route 6 * ic0 - 4 * w0 bytes (raw row
// 2 * ir0 onward).
struct StemTile {
  int b, py0, px0, cr0, cc0, ir0, ic0;
  int w0, shift;
};

template <bool NHWC>
__device__ __forceinline__ StemTile tile_at(const StemArgs& p, int tile) {
  StemTile t;
  const int tx = tile % p.tiles_x;
  const int rest = tile / p.tiles_x;
  const int ty = rest % p.tiles_y;
  t.b = rest / p.tiles_y;
  t.py0 = ty * TPH;
  t.px0 = tx * TPW;
  t.cr0 = 2 * t.py0 - p.plo_y;
  t.cc0 = 2 * t.px0 - p.plo_x;
  t.ir0 = t.cr0 - 2;
  t.ic0 = t.cc0 - 2;
  // two's complement: the floor's remainder
  if (NHWC) {
    t.shift = (6 * t.ic0) & 15;
    t.w0 = (6 * t.ic0 - t.shift) / 4;
  } else {
    t.shift = (3 * t.ic0) & 3;
    t.w0 = 3 * t.ic0 - t.shift;
  }
  return t;
}

template <bool NHWC>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          const StemArgs& p, int tile,
                                          uint32_t dst, uint32_t bar) {
  const StemTile t = tile_at<NHWC>(p, tile);
  hopper::mbar_arrive_expect_tx(bar, kBoxBytes);
  hopper::tma_load_3d(dst, map, bar, t.w0, NHWC ? 2 * t.ir0 : t.ir0, t.b);
}

// One word of 4 pixel bytes through the quantize table of its 4
// channels (`tab`: the first one's 256 entries, the next 256 on).
__device__ __forceinline__ uint32_t quantize_word(uint32_t v,
                                                  const int8_t* tab) {
  return __byte_perm(
      __byte_perm(static_cast<uint8_t>(tab[v & 0xff]),
                  static_cast<uint8_t>(tab[256 + ((v >> 8) & 0xff)]), 0x0040),
      __byte_perm(static_cast<uint8_t>(tab[512 + ((v >> 16) & 0xff)]),
                  static_cast<uint8_t>(tab[768 + (v >> 24)]), 0x0040),
      0x5410);
}

// The GEMM's depth runs in a permuted order, the same for A and B (the
// sum does not care): logical index kappa = 32 ks + 16 hf + 4 t + e (k32
// step ks, half hf, fragment lane t = lane % 4, byte e) holds patch byte
// p = 48 t + 8 ks + 4 hf + e, p = (ky * 4 + kx) * 12 + c. So lane t's
// A fragments of a conv pixel are the 48 contiguous staged bytes of
// window row ky = t, words 2 ks + hf: its row of the 4 x 4 window, where
// the natural order would read 12 words 16 bytes apart across all four.
// With staged rows 120 words apart, the 32 lanes' words of one load lie
// in 32 distinct banks (3 g + 24 t mod 32 for 8 neighbouring pixels).
//
// The thread's A fragments of one 64-row chunk for all six k32 steps:
// row g (+8) of its warp's 16 rows; rows past the tile's 561 read the
// last one (their products are not stored). `xs`: the tile's first
// staged pixel (the stage plus its shift).
__device__ __forceinline__ void load_a(const uint8_t* xs, int chunk, int warp,
                                       int lane, uint32_t (&a)[6][4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* run[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = min(chunk * 64 + warp * 16 + g + 8 * h, CM - 1);
    const int cr = m / CW, cc = m - cr * CW;
    run[h] = reinterpret_cast<const uint32_t*>(xs + (cr + t) * kXRow +
                                               cc * 12);
  }
#pragma unroll
  for (int ks = 0; ks < KTOT / 32; ++ks) {
    a[ks][0] = run[0][2 * ks];
    a[ks][1] = run[1][2 * ks];
    a[ks][2] = run[0][2 * ks + 1];
    a[ks][3] = run[1][2 * ks + 1];
  }
}

// The six k32 wgmmas of one chunk as one commit group. The epilogue
// branches per row: __syncwarp() brings the warp back together for the
// .aligned wgmma instructions.
__device__ __forceinline__ void issue(int (&acc)[32],
                                      const uint32_t (&a)[6][4],
                                      uint32_t ws_addr) {
  __syncwarp();
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KTOT / 32; ++ks) {
    hopper::wgmma_m64n64k32_s8_rs(
        acc, a[ks],
        hopper::wgmma_desc_sw128(ws_addr + (ks >> 2) * (N * 128) +
                                 (ks & 3) * 32),
        ks != 0);
  }
  hopper::wgmma_commit();
}

// clip(rint(x), 0, 127) of two floats as two 16-bit lanes, `x0` low:
// the bits of requant_relu's saturate_s8(rintf(max(x, 0)), 0) for
// x = y * inv_s_out: clipping at 127 commutes with rounding, and the
// saturating pack maps every x <= 0 (max(y, 0) * inv_s_out = 0) to 0.
// One min and one conversion a value where __vminu4 and __vmaxs4 cost
// eight instructions each on this card.
__device__ __forceinline__ uint32_t requant_pair_relu16(float x0, float x1) {
  uint32_t d;
  asm("cvt.pack.sat.u16.s32 %0, %1, %2;\n"
      : "=r"(d)
      : "r"(__float2int_rn(fminf(x1, 127.f))),
        "r"(__float2int_rn(fminf(x0, 127.f))));
  return d;
}

// q8_relu of one chunk's accumulators into the conv tile (its bf16 form
// when BF16, with `ab` already rounded to bf16); 0 outside the image,
// nothing for the padding rows.
template <bool BF16>
__device__ __forceinline__ void epilogue(const StemArgs& p,
                                         const StemTile& tl,
                                         const int (&acc)[32], int chunk,
                                         int warp, int lane,
                                         const float2* ab, int8_t* qs) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  float4 abj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    abj[j] = *reinterpret_cast<const float4*>(ab + 8 * j + t2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = chunk * 64 + warp * 16 + g + 8 * h;
    if (m >= CM) continue;
    const int cr = m / CW, cc = m - cr * CW;
    const int gr = tl.cr0 + cr, gc = tl.cc0 + cc;
    const bool inside = gr >= 0 && gr < p.H2 && gc >= 0 && gc < p.W2;
    uint32_t* dst = reinterpret_cast<uint32_t*>(qs + m * kQRow) + t2 / 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t o = 0;
      if (inside) {
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        float y0, y1;
        if (BF16) {
          bf16_sum2(a0, a1, abj[j].x, abj[j].y, abj[j].z, abj[j].w, y0, y1);
          bf_round2(y0, y1);
        } else {
          y0 = __fmaf_rn(__int2float_rn(a0), abj[j].x, abj[j].y);
          y1 = __fmaf_rn(__int2float_rn(a1), abj[j].z, abj[j].w);
        }
        o = requant_pair_relu16(__fmul_rn(y0, p.inv_s_out),
                                __fmul_rn(y1, p.inv_s_out));
      }
      dst[4 * j] = o;
    }
  }
}

template <bool BF16, bool NHWC>
__global__ void __launch_bounds__(kThreads, 1)
stem_s8_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                   const StemArgs p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* ws = sm;
  uint8_t* ring = ws + kWsBytes;
  int8_t* qs = reinterpret_cast<int8_t*>(ring + kStages * kStageBytes);
  float2* ab = reinterpret_cast<float2*>(qs + kQsBytes);
  int8_t* qtab = reinterpret_cast<int8_t*>(ab + N);
  uint64_t* bars = reinterpret_cast<uint64_t*>(qtab + kTabBytes);
  uint8_t* xq = sm + kXqOff;   // the 'nhwc' route's packed tile
  const uint32_t full = smem_u32(bars);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    fence_barrier_init();
    for (int s = 0; s < kStages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < p.tiles)
        load_tile<NHWC>(&map_x, p, tile, smem_u32(ring) + s * kStageBytes,
                        full + 8 * s);
    }
  }
  // weights in the permuted depth order (load_a): 16-byte chunk c of
  // row n holds words c, 12 + c, 24 + c, 36 + c of the row; it lies at
  // K-block c / 8, chunk (c % 8) ^ (n % 8); the unused half of the second
  // block zeroed
  const uint32_t* wt32 = reinterpret_cast<const uint32_t*>(p.wt);
  for (int i = tid; i < N * 16; i += kThreads) {
    const int n = i >> 4, c = i & 15;
    int4 v = make_int4(0, 0, 0, 0);
    if (c < KTOT / 16) {
      const uint32_t* w = wt32 + n * (KTOT / 4) + c;
      v = make_int4(static_cast<int>(__ldg(w)), static_cast<int>(__ldg(w + 12)),
                    static_cast<int>(__ldg(w + 24)),
                    static_cast<int>(__ldg(w + 36)));
    }
    *reinterpret_cast<int4*>(ws + (c >> 3) * (N * 128) + n * 128 +
                             (((c & 7) ^ (n & 7)) << 4)) = v;
  }
  for (int i = tid; i < N; i += kThreads) {
    const float a = __ldg(p.alpha + i), b = __ldg(p.beta + i);
    ab[i] = BF16 ? make_float2(bf_round(a), bf_round(b)) : make_float2(a, b);
  }
  for (int i = tid; i < kTabBytes; i += kThreads) {
    const int c = i >> 8;
    qtab[i] = static_cast<int8_t>(
        quantize_pixel(i & 255, p.mean[c], p.inv_s_in, p.mode));
  }
  // the fill value of each word of a pixel (channels 4w..4w+3)
  uint32_t fillw[3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    fillw[w] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      fillw[w] |= static_cast<uint32_t>(p.fill[4 * w + j] & 0xff) << (8 * j);
  }
  fence_proxy_async();   // the weights are read by wgmma
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t ws_addr = smem_u32(ws);
  int acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0;
  uint32_t a[6][4];
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int slot = it % kStages;
    const StemTile tl = tile_at<NHWC>(p, tile);
    uint8_t* stage = ring + slot * kStageBytes;
    // the tile's first packed pixel, rows kXRow bytes apart
    uint8_t* xs = NHWC ? xq : stage + 4 * tl.shift;
    mbar_wait(full + 8 * slot, (it / kStages) & 1);

    // quantize, a pixel (3 words) a thread: in place on the 'tma' route;
    // on the 'nhwc' route from the raw stage into xq, the pixel's 6 bytes
    // of raw row 2r then its 6 of row 2r + 1. Every pixel outside the
    // image takes the fill.
    uint32_t* xs32 = reinterpret_cast<uint32_t*>(xs);
    const bool interior = tl.ir0 >= 0 && tl.ir0 + IR <= p.H2 &&
                          tl.ic0 >= 0 && tl.ic0 + IC <= p.W2;
    for (int i = tid; i < IR * IC; i += kThreads) {
      const int r = i / IC, col = i - r * IC;
      const int gr = tl.ir0 + r, gc = tl.ic0 + col;
      uint32_t* px = xs32 + r * kBoxWords + 3 * col;
      if (interior || (gr >= 0 && gr < p.H2 && gc >= 0 && gc < p.W2)) {
        uint32_t v[3];
        if (NHWC) {
          const uint16_t* top = reinterpret_cast<const uint16_t*>(
              stage + tl.shift + 2 * r * kRawRow + 6 * col);
          const uint16_t* bot = top + kRawRow / 2;
          v[0] = top[0] | (static_cast<uint32_t>(top[1]) << 16);
          v[1] = top[2] | (static_cast<uint32_t>(bot[0]) << 16);
          v[2] = bot[1] | (static_cast<uint32_t>(bot[2]) << 16);
        } else {
          v[0] = px[0];
          v[1] = px[1];
          v[2] = px[2];
        }
#pragma unroll
        for (int w = 0; w < 3; ++w)
          px[w] = quantize_word(v[w], qtab + w * 1024);
      } else {
        px[0] = fillw[0];
        px[1] = fillw[1];
        px[2] = fillw[2];
      }
    }
    if (NHWC) {
      // the raw stage is read: refill it now (the generic reads ordered
      // before the async proxy's writes)
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        const int next = tile + kStages * gridDim.x;
        if (next < p.tiles)
          load_tile<NHWC>(&map_x, p, next, smem_u32(stage), full + 8 * slot);
      }
    } else {
      __syncthreads();
    }

    // the tile's GEMM, chunks wg, wg + 3, wg + 6: one chunk's wgmmas run
    // while the previous chunk is requantized
    load_a(xs, wg, warp, lane, a);
    issue(acc0, a, ws_addr);
    wgmma_wait<0>();
    fence_registers(acc0);
    load_a(xs, wg + kWgs, warp, lane, a);
    issue(acc1, a, ws_addr);
    epilogue<BF16>(p, tl, acc0, wg, warp, lane, ab, qs);
    __syncwarp();
    wgmma_wait<0>();
    fence_registers(acc1);
    load_a(xs, wg + 2 * kWgs, warp, lane, a);
    issue(acc0, a, ws_addr);
    epilogue<BF16>(p, tl, acc1, wg + kWgs, warp, lane, ab, qs);
    __syncwarp();
    wgmma_wait<0>();
    fence_registers(acc0);
    epilogue<BF16>(p, tl, acc0, wg + 2 * kWgs, warp, lane, ab, qs);
    // the stage was written through the generic proxy; the next TMA load
    // into it writes through the async one ('tma' route)
    if (!NHWC) fence_proxy_async();
    __syncthreads();
    if (!NHWC && tid == 0) {
      const int next = tile + kStages * gridDim.x;
      if (next < p.tiles)
        load_tile<NHWC>(&map_x, p, next, smem_u32(stage), full + 8 * slot);
    }

    // 3x3/2 max-pool of the conv tile, 8 channels a thread: per row the
    // 3-way max of 16-bit lanes (__vimax3_s16x2, one instruction on this
    // card), then of the three rows
    for (int i = tid; i < TPH * TPW * 8; i += kThreads) {
      const int grp = i & 7, pix = i >> 3;
      const int py = pix / TPW, px = pix - py * TPW;
      const int gy = tl.py0 + py, gx = tl.px0 + px;
      if (gy >= p.PH || gx >= p.PW) continue;
      const uint8_t* cell =
          reinterpret_cast<const uint8_t*>(qs) +
          ((2 * py) * CW + 2 * px) * kQRow + grp * 16;
      uint4 r[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint8_t* row = cell + dy * (CW * kQRow);
        const uint4 u0 = *reinterpret_cast<const uint4*>(row);
        const uint4 u1 = *reinterpret_cast<const uint4*>(row + kQRow);
        const uint4 u2 = *reinterpret_cast<const uint4*>(row + 2 * kQRow);
        r[dy] = make_uint4(__vimax3_s16x2(u0.x, u1.x, u2.x),
                           __vimax3_s16x2(u0.y, u1.y, u2.y),
                           __vimax3_s16x2(u0.z, u1.z, u2.z),
                           __vimax3_s16x2(u0.w, u1.w, u2.w));
      }
      const uint32_t m0 = __vimax3_s16x2(r[0].x, r[1].x, r[2].x);
      const uint32_t m1 = __vimax3_s16x2(r[0].y, r[1].y, r[2].y);
      const uint32_t m2 = __vimax3_s16x2(r[0].z, r[1].z, r[2].z);
      const uint32_t m3 = __vimax3_s16x2(r[0].w, r[1].w, r[2].w);
      // the low byte of each 16-bit lane, in channel order
      *reinterpret_cast<uint2*>(
          p.out + ((static_cast<int64_t>(tl.b) * p.PH + gy) * p.PW + gx) * N +
          grp * 8) = make_uint2(__byte_perm(m0, m1, 0x6420),
                                __byte_perm(m2, m3, 0x6420));
    }
  }
}

// One launch of the persistent kernel: a block an SM (at most one a
// tile).
template <bool NHWC>
int launch(const CUtensorMap& map, const StemArgs& a, int device,
           cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = a.bf16 ? stem_s8_tma_kernel<true, NHWC>
                             : stem_s8_tma_kernel<false, NHWC>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<NHWC>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.tiles < sms ? a.tiles : sms;
  kernel<<<grid, kThreads, smem_bytes<NHWC>(), stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tma_stem

}  // namespace
}  // namespace ursonet_int8

namespace {

// The launch arguments both routes share; false if refused.
bool stem_args(const void* x, const void* wt, int B, int H2, int W2,
               int mode, const float* mean12, float inv_s_in,
               const void* alpha, const void* beta, float inv_s_out,
               int bf16, void* out, ursonet_int8::StemArgs* a) {
  using namespace ursonet_int8;
  if (B <= 0 || H2 <= 0 || W2 <= 0 || x == nullptr || wt == nullptr ||
      mean12 == nullptr || alpha == nullptr || beta == nullptr ||
      out == nullptr || (mode != kCalibrated && mode != kShift128)) {
    return false;
  }
  a->x = static_cast<const uint8_t*>(x);
  a->wt = static_cast<const int8_t*>(wt);
  a->B = B;
  a->H2 = H2;
  a->W2 = W2;
  a->PH = (H2 + 1) / 2;
  a->PW = (W2 + 1) / 2;
  // 3/2 SAME: even sizes pad (0, 1), odd sizes (1, 1)
  a->plo_y = H2 % 2;
  a->plo_x = W2 % 2;
  a->tiles_y = (a->PH + TPH - 1) / TPH;
  a->tiles_x = (a->PW + TPW - 1) / TPW;
  a->mode = mode;
  for (int c = 0; c < 12; ++c) {
    a->mean[c] = mean12[c];
    a->fill[c] = mode == kShift128
                     ? static_cast<int>(nearbyintf(mean12[c])) - 128 : 0;
  }
  a->inv_s_in = inv_s_in;
  a->alpha = static_cast<const float*>(alpha);
  a->beta = static_cast<const float*>(beta);
  a->inv_s_out = inv_s_out;
  a->bf16 = bf16 != 0 ? 1 : 0;
  a->out = static_cast<int8_t*>(out);
  const long long tiles = static_cast<long long>(B) * a->tiles_y * a->tiles_x;
  if (tiles > 0x7fffffffLL) return false;
  a->tiles = static_cast<int>(tiles);
  return true;
}

}  // namespace

extern "C" int ursonet_stem_s8(const void* x, const void* wt, int B, int H2,
                               int W2, int mode, const float* mean12,
                               float inv_s_in, const void* alpha,
                               const void* beta, float inv_s_out, int bf16,
                               void* out, int device, void* stream) {
  using namespace ursonet_int8;
  StemArgs a;
  if (!stem_args(x, wt, B, H2, W2, mode, mean12, inv_s_in, alpha, beta,
                 inv_s_out, bf16, out, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(stem_s8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_s8_kernel<<<static_cast<unsigned>(a.tiles), THREADS, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The 'tma' route: W2 % 4 == 0 and x 16-byte aligned (the tensor map's
// row pitch and base), wt and out 16-byte aligned.
extern "C" int ursonet_stem_s8_tma(const void* x, const void* wt, int B,
                                   int H2, int W2, int mode,
                                   const float* mean12, float inv_s_in,
                                   const void* alpha, const void* beta,
                                   float inv_s_out, int bf16, void* out,
                                   int device, void* stream) {
  using namespace ursonet_int8;
  StemArgs a;
  if (!stem_args(x, wt, B, H2, W2, mode, mean12, inv_s_in, alpha, beta,
                 inv_s_out, bf16, out, &a) ||
      W2 % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const uint64_t row = static_cast<uint64_t>(W2) * 12;
  if (!hopper::make_word_map_3d(&map, x, static_cast<uint64_t>(W2) * 3, H2,
                                B, row, row * H2, tma_stem::kBoxWords, IR)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tma_stem::launch<false>(map, a, device,
                                 static_cast<cudaStream_t>(stream));
}

// The 'nhwc' route: x the uint8 NHWC batch [B, H, W, 3], H even, W % 16
// == 0 (a raw row of W * 3 bytes is a multiple of 16), x, wt and out
// 16-byte aligned; wt the s2d stem kernel as on the other routes, mean12
// the pixel mean tiled over the four packed phases.
extern "C" int ursonet_stem_s8_nhwc(const void* x, const void* wt, int B,
                                    int H, int W, int mode,
                                    const float* mean12, float inv_s_in,
                                    const void* alpha, const void* beta,
                                    float inv_s_out, int bf16, void* out,
                                    int device, void* stream) {
  using namespace ursonet_int8;
  StemArgs a;
  if (H <= 0 || W <= 0 || H % 2 != 0 || W % 16 != 0 ||
      !stem_args(x, wt, B, H / 2, W / 2, mode, mean12, inv_s_in, alpha,
                 beta, inv_s_out, bf16, out, &a) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const uint64_t row = static_cast<uint64_t>(W) * 3;
  if (!hopper::make_word_map_3d(&map, x, row / 4, H, B, row, row * H,
                                tma_stem::kRawRow / 4, tma_stem::kRawRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tma_stem::launch<true>(map, a, device,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* ursonet_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
