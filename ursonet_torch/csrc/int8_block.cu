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
// the bytes.
//
// Design (block_s8_kernel), the Hopper machinery of hopper.cuh:
//   Blocks   persistent, one per SM, 384 threads: in warpgroup 0 one
//            thread issues the TMA loads and one (in another warp) the
//            TMA stores (setmaxnreg 40), warpgroups 1 and 2 compute
//            (setmaxnreg 232; 40 + 2 x 232 = 3 x 168, the block's own
//            pool). Tiles tile = blockIdx.x, + gridDim.x, ...
//            in raster order within an image, so the tiles running
//            together share their halo rows through L2.
//   x ring   2 stages. A stage holds the tile's 10 x 18 halo pixels as two
//            TMA boxes of 128 channels x 18 pixels x 10 rows of x viewed
//            as bytes [B][H][W][256]: each box lands as 180 rows of 128
//            bytes in the 128-byte swizzle, exactly a K-major wgmma A
//            tile, in a 192-row (3 x m64) slot; rows 180..191 are never
//            loaded and their products never stored. Out-of-bounds
//            pixels arrive as zeros (start coordinates -1 included); m1
//            there is forced to 0 anyway. full (the load's bytes),
//            joined (256 consumer arrivals) and empty (the store thread)
//            mbarriers; the next tile's x is in flight while this one
//            computes.
//   Weights  resident, staged once per block as wgmma B operands in the
//            K-major 128-byte swizzle: w1 2 K-blocks x 64 rows (16 KB),
//            w2 5 K-blocks x 64 rows (40 KB: K = 576 is 4.5 swizzle
//            rows, the last block half used: 4 KB of padding), w3 256
//            rows of 128 bytes with K = 64 in their first half (32 KB:
//            16 KB of padding, cheaper than a second descriptor layout
//            while everything fits) and K permuted (below). a, b and res
//            in shared memory as (a, b) pairs: no __ldg in any epilogue.
//   1x1 256->64 on the 180 halo pixels: shared-memory wgmma m64n32k32,
//            A straight from the stage, 3 M tiles x 8 k32 steps; the
//            warpgroups split N (32 channels each: equal work for any
//            M). q8_relu, 0 outside the image, into m1 [180][80 B]: an
//            80-byte pitch puts the 8 rows of an ldmatrix in 8 distinct
//            16-byte bank groups. m1 is double-buffered, so one named
//            barrier of the 256 consumer threads per tile (after m1 is
//            written) orders every reuse.
//   3x3 64->64: register-A wgmma m64n64k32, warpgroup i on output rows
//            4i..4i+3, warp w on row 4i + w: its 16 pixels' A rows for
//            tap (ky, kx) are the 16 consecutive m1 rows (4i + w + ky)
//            * 18 + kx + 0..15, one ldmatrix.x4 per k32 step (m1 rows of
//            80 bytes are no layout a shared-memory descriptor reads).
//            18 k32 steps, a tap's two issued as soon as its fragments
//            are loaded; q8_relu in registers.
//   1x1 64->256 with the join: register-A wgmma m64n128k32, two N
//            halves in flight, A = m2 straight from the 3x3's
//            accumulators: a thread holds columns 8j + 2t, +1 of its two
//            rows, and the A fragment wants bytes 4t..4t+3 (+16) of a k32
//            step, so depth index kappa = 32s + 16hf + 4t + e holds m2
//            channel 32s + 16hf + 8(e / 2) + 2t + e % 2; w3's K is
//            permuted the same way while it is staged (a sum does not
//            care about the order of K). The join reads the residual
//            from the centre pixels of the stage at their swizzled
//            address (chunk c ^ (row % 8)) and writes the result over
//            it, a group's loads ahead of its stores.
//   Epilogue every clip(rint(z), 0, 127) is a float min, max and an add
//            of 1.5 * 2^23 whose low byte is the result: FP32-pipe
//            instructions with the bits of the F2I it replaces (the
//            conversion unit gives 16 results a clock and SM).
//   Output   every consumer thread fences the proxies and arrives on the
//            stage's joined barrier; the store thread then sends each
//            output row out of the stage by TMA (one box of 16 pixels x
//            128 channels per row and half, starting at the row's first
//            centre pixel: the swizzle follows the shared-memory address,
//            so a 128-byte aligned start reads the chunks where the load
//            put them; columns clipped at the image edge), waits until
//            the stores have read the stage, and hands it back to the
//            load thread. No consumer instruction moves the output.
//   Cost     the halo: 180 rows of the first product for 128 pixels
//            (9.6% more products than an unfused block), and the padding
//            to 192 rows (2.2% more): 19.9 M operations a tile instead
//            of 17.8 M.
//   Shared   1 KB alignment slack + 96 KB ring + 88 KB weights + 28.1 KB
//   memory   m1 (two buffers) + 4 KB epilogue rows + 48 B of barriers =
//            217.2 KB of the 227 KB a block may have.
//   Stalls   every mbarrier wait is hopper::mbar_wait, which traps after
//            ~3 s instead of hanging the card.

#include "hopper.cuh"

namespace ursonet_int8 {
namespace {

constexpr int CIN = 256, CMID = 64;
constexpr int TH = 8, TW = 16;                      // tile pixels
constexpr int HH = TH + 2, HW = TW + 2, HP = HH * HW;   // with halo: 180

struct BlockArgs {
  const int8_t* x;
  const int8_t* w1;   // [64][256]
  const int8_t* w2;   // [64][9 * 64], k = (ky * 3 + kx) * 64 + c
  const int8_t* w3;   // [256][64]
  const float* ab;    // rows a1, b1, a2, b2, a3, b3, res; stride ldab
  int ldab, B, H, W, tiles_y, tiles_x, tiles;
  int8_t* out;
};

constexpr int kThreads = 384;                  // producer + 2 consumer WGs
constexpr int kStages = 2;
constexpr int kBoxBytes = HP * 128;            // 23,040: one 128-ch box
constexpr int kHalf = 192 * 128;               // its 3 x m64-row slot
constexpr int kStageBytes = 2 * kHalf;         // 49,152
constexpr int kKBlock = CMID * 128;            // a K-block of w1, w2
constexpr int kW1Bytes = (CIN / 128) * kKBlock;               // 16,384
constexpr int kW2Bytes = ((9 * CMID + 127) / 128) * kKBlock;  // 40,960
constexpr int kW3Bytes = CIN * 128;                           // 32,768
constexpr int kM1Ld = CMID + 16;               // 80-byte m1 rows
constexpr int kM1Bytes = HP * kM1Ld;           // 14,400
constexpr int kOffW1 = kStages * kStageBytes;
constexpr int kOffW2 = kOffW1 + kW1Bytes;
constexpr int kOffW3 = kOffW2 + kW2Bytes;
constexpr int kOffM1 = kOffW3 + kW3Bytes;
constexpr int kOffAb1 = kOffM1 + 2 * kM1Bytes;   // float2 (a1, b1) [64]
constexpr int kOffAb2 = kOffAb1 + CMID * 8;      // float2 (a2, b2) [64]
constexpr int kOffAb3 = kOffAb2 + CMID * 8;      // float2 (a3, b3) [256]
constexpr int kOffRes = kOffAb3 + CIN * 8;       // float res [256]
constexpr int kOffBar = kOffRes + CIN * 4;  // full[2], joined[2], empty[2]
constexpr int kSmemBytes = 1024 + kOffBar + 3 * kStages * 8;
static_assert(kSmemBytes <= 232448, "227 KB a block");
static_assert(kOffW1 % 1024 == 0 && kOffW2 % 1024 == 0 &&
              kOffW3 % 1024 == 0, "wgmma tiles on 1024 bytes");

struct TileAt {
  int b, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(const BlockArgs& p, int tile) {
  const int per_image = p.tiles_y * p.tiles_x;
  TileAt t;
  t.b = tile / per_image;
  const int rem = tile - t.b * per_image;
  const int ty = rem / p.tiles_x;
  t.y0 = ty * TH;
  t.x0 = (rem - ty * p.tiles_x) * TW;
  return t;
}

// The tile's halo pixels (rows y0 - 1 .., columns x0 - 1 ..) as two
// 128-channel boxes, both completing on `bar`.
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          const TileAt& t, uint32_t dst,
                                          uint32_t bar) {
  hopper::mbar_arrive_expect_tx(bar, 2 * kBoxBytes);
  hopper::tma_load_4d(dst, map, bar, 0, t.x0 - 1, t.y0 - 1, t.b);
  hopper::tma_load_4d(dst + kHalf, map, bar, 128, t.x0 - 1, t.y0 - 1, t.b);
}

// The rounding to an integer stays off the conversion unit (F2I and FRND
// give 16 results a clock and SM on sm_90; int -> float is I2FP, fast).
constexpr float kMagic = 12582912.f;   // 1.5 * 2^23: the ulp is 1

// clip(rint(z), 0, 127) in the low byte: the add rounds to the nearest
// integer, ties to even, as rintf (kMagic is even), and the integer is
// the low bits of the sum's mantissa; clipping commutes with rounding at
// integer bounds. The bits of requant_relu (saturate_s8(rintf(max(z, 0)),
// 0)) and of the join's clip for every finite z.
__device__ __forceinline__ uint32_t q8_bits(float z) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(z, 0.f), 127.f), kMagic));
}

// Two values' low bytes as 16 bits, `lo` first.
__device__ __forceinline__ uint16_t pack2(uint32_t lo, uint32_t hi) {
  return static_cast<uint16_t>(__byte_perm(lo, hi, 0x0040));
}

// The tile's output rows from the joined stage: per row and 128-channel
// half one TMA box of 16 pixels, read from the stage at the row's first
// centre pixel (a 128-byte aligned start: the 128-byte swizzle follows
// the shared-memory address, so the box reads chunk c of halo row hr at
// c ^ (hr % 8), where the load put it). The box clips the columns at the
// image edge; rows past it are not stored.
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const TileAt& t, int H,
                                           uint32_t stage) {
  for (int oy = 0; oy < TH && t.y0 + oy < H; ++oy)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      hopper::tma_store_4d(map, stage + hf * kHalf + ((oy + 1) * HW + 1) * 128,
                           128 * hf, t.x0, t.y0 + oy, t.b);
}

// requant_relu of two accumulators with ab = (a[n], b[n], a[n+1],
// b[n+1]) as 16 bits
__device__ __forceinline__ uint16_t q8_pair(int a0, int a1, float4 ab) {
  return pack2(q8_bits(__fmaf_rn(__int2float_rn(a0), ab.x, ab.y)),
               q8_bits(__fmaf_rn(__int2float_rn(a1), ab.z, ab.w)));
}

// m1 of one M tile (64 halo rows) for this warpgroup's 32 channels
// n0 .. n0 + 31; 0 outside the image, nothing for rows past the 180.
__device__ __forceinline__ void epilogue_m1(const BlockArgs& p,
                                            const TileAt& tl,
                                            const int (&acc)[16], int mt,
                                            int n0, int warp, int lane,
                                            const float2* ab1, uint8_t* m1) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  float4 ab[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ab[j] = *reinterpret_cast<const float4*>(ab1 + n0 + 8 * j + t2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 64 + warp * 16 + g + 8 * h;
    if (m >= HP) continue;
    const int hy = m / HW, hx = m - hy * HW;
    const int gy = tl.y0 - 1 + hy, gx = tl.x0 - 1 + hx;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    uint8_t* row = m1 + m * kM1Ld + n0 + t2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<uint16_t*>(row + 8 * j) =
          inside ? q8_pair(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], ab[j])
                 : static_cast<uint16_t>(0);
    }
  }
}

// The join of one N half (channels 128 nh ..) of this warp's 16 pixels
// (output row py): the residual from the stage's centre pixels, the
// result written over it. The loads of a group of 4 column blocks go
// ahead of its stores (the stores may alias them for all the compiler
// knows, so it would not hoist them).
__device__ __forceinline__ void epilogue_join(const int (&acc)[64], int nh,
                                              int py, int lane,
                                              uint8_t* stage,
                                              const float2* ab3,
                                              const float* res) {
  constexpr int G = 4;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  uint8_t* half = stage + nh * kHalf;
#pragma unroll
  for (int j0 = 0; j0 < 16; j0 += G) {
    float4 ab[G];
    float2 rs[G];
    uint16_t* px[G][2];
    uint32_t x[G][2];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int j = j0 + jj, n = nh * 128 + 8 * j + t2;
      ab[jj] = *reinterpret_cast<const float4*>(ab3 + n);
      rs[jj] = *reinterpret_cast<const float2*>(res + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hr = (py + 1) * HW + g + 8 * h + 1;
        px[jj][h] = reinterpret_cast<uint16_t*>(
            half + hr * 128 + (((j >> 1) ^ (hr & 7)) << 4) + 8 * (j & 1) +
            t2);
        x[jj][h] = *px[jj][h];
      }
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + jj;
        const float y0 = __fmaf_rn(__int2float_rn(acc[4 * j + 2 * h]),
                                   ab[jj].x, ab[jj].y);
        const float y1 = __fmaf_rn(
            __int2float_rn(acc[4 * j + 2 * h + 1]), ab[jj].z, ab[jj].w);
        const float r0 = __fmul_rn(
            __int2float_rn(static_cast<int8_t>(x[jj][h] & 0xffu)),
            rs[jj].x);
        const float r1 = __fmul_rn(
            __int2float_rn(static_cast<int8_t>(x[jj][h] >> 8)),
            rs[jj].y);
        *px[jj][h] = pack2(q8_bits(__fadd_rn(y0, r0)),
                           q8_bits(__fadd_rn(y1, r1)));
      }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
block_s8_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_out,
                    const BlockArgs p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* ring = sm;
  uint8_t* w1s = sm + kOffW1;
  uint8_t* w2s = sm + kOffW2;
  uint8_t* w3s = sm + kOffW3;
  uint8_t* m1s = sm + kOffM1;
  float2* ab1 = reinterpret_cast<float2*>(sm + kOffAb1);
  float2* ab2 = reinterpret_cast<float2*>(sm + kOffAb2);
  float2* ab3 = reinterpret_cast<float2*>(sm + kOffAb3);
  float* res = reinterpret_cast<float*>(sm + kOffRes);
  const uint32_t full = smem_u32(sm + kOffBar);
  const uint32_t joined = full + 8 * kStages;
  const uint32_t empty = joined + 8 * kStages;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(joined + 8 * s, 256);  // every consumer thread
      mbar_init(empty + 8 * s, 1);     // the store thread
    }
    fence_barrier_init();
  }
  // w1 [64][256] and w2 [64][576]: 16-byte chunk q of row n at K-block
  // q / 8, chunk (q % 8) ^ (n % 8); the unused half of w2's last block
  // zeroed
  for (int i = tid; i < CMID * 16; i += kThreads) {
    const int n = i >> 4, q = i & 15;
    *reinterpret_cast<int4*>(w1s + (q >> 3) * kKBlock + n * 128 +
                             (((q & 7) ^ (n & 7)) << 4)) =
        __ldg(reinterpret_cast<const int4*>(p.w1 + n * CIN + q * 16));
  }
  for (int i = tid; i < CMID * 40; i += kThreads) {
    const int n = i / 40, q = i - n * 40;
    int4 v = make_int4(0, 0, 0, 0);
    if (q < 36)
      v = __ldg(reinterpret_cast<const int4*>(p.w2 + n * 9 * CMID + q * 16));
    *reinterpret_cast<int4*>(w2s + (q >> 3) * kKBlock + n * 128 +
                             (((q & 7) ^ (n & 7)) << 4)) = v;
  }
  // w3 [256][64] with K permuted: chunk q < 4 of row n holds channels
  // 16q + (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15), so
  // depth index kappa = 32s + 16hf + 4t + e (chunk q = 2s + hf) is
  // channel 32s + 16hf + 8(e / 2) + 2t + e % 2; chunks 4..7 zeroed
  for (int i = tid; i < CIN * 8; i += kThreads) {
    const int n = i >> 3, q = i & 7;
    int4 v = make_int4(0, 0, 0, 0);
    if (q < 4) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          p.w3 + n * CMID + q * 16));
      v = make_int4(static_cast<int>(__byte_perm(u.x, u.z, 0x5410)),
                    static_cast<int>(__byte_perm(u.x, u.z, 0x7632)),
                    static_cast<int>(__byte_perm(u.y, u.w, 0x5410)),
                    static_cast<int>(__byte_perm(u.y, u.w, 0x7632)));
    }
    *reinterpret_cast<int4*>(w3s + n * 128 + ((q ^ (n & 7)) << 4)) = v;
  }
  for (int i = tid; i < CIN; i += kThreads) {
    if (i < CMID) {
      ab1[i] = make_float2(__ldg(p.ab + i), __ldg(p.ab + p.ldab + i));
      ab2[i] = make_float2(__ldg(p.ab + 2 * p.ldab + i),
                           __ldg(p.ab + 3 * p.ldab + i));
    }
    ab3[i] = make_float2(__ldg(p.ab + 4 * p.ldab + i),
                         __ldg(p.ab + 5 * p.ldab + i));
    res[i] = __ldg(p.ab + 6 * p.ldab + i);
  }
  fence_proxy_async();   // the weights are read by wgmma
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 0) {
    // ===================== producer ==================================
    setmaxnreg_dec<40>();
    int it = 0;
    if (tid == 0) {          // the load thread
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
        const int s = it & 1;
        mbar_wait(empty + 8 * s, ((it >> 1) & 1) ^ 1);
        load_tile(&map_x, tile_at(p, tile), smem_u32(ring) + s * kStageBytes,
                  full + 8 * s);
      }
    } else if (tid == 32) {  // the store thread
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
        const int s = it & 1;
        const TileAt tl = tile_at(p, tile);
        mbar_wait(joined + 8 * s, (it >> 1) & 1);
        store_tile(&map_out, tl, p.H, smem_u32(ring) + s * kStageBytes);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(empty + 8 * s);
      }
      bulk_wait<0>();
    }
    return;
  }

  // ===================== consumers ======================================
  setmaxnreg_inc<232>();
  const int c = wg - 1, ctid = tid & 127, warp = ctid >> 5, lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  const int py = 4 * c + warp;   // the output row of this warp's 16 pixels
  const uint32_t w1a = smem_u32(w1s), w2a = smem_u32(w2s);
  const uint32_t w3a = smem_u32(w3s);
  // ldmatrix: lane l gives row l % 8 + 8 ((l / 8) % 2) of the warp's 16
  // pixels, bytes 16 (l / 16) .. of the k32 step
  const uint32_t lm_lane =
      ((py * HW) + (lane & 7) + 8 * ((lane >> 3) & 1)) * kM1Ld +
      16 * (lane >> 4);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int s = it & 1;
    const TileAt tl = tile_at(p, tile);
    uint8_t* stage = ring + s * kStageBytes;
    const uint32_t sa = smem_u32(stage);
    uint8_t* m1 = m1s + (it & 1) * kM1Bytes;
    mbar_wait(full + 8 * s, (it >> 1) & 1);
    __syncwarp();

    // ---- m1 = q8_relu(x . w1) on the 192 halo rows, channels 32c ..
    {
      int acc[3][16];
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          wgmma_m64n32k32_s8(
              acc[mt],
              wgmma_desc_sw128(sa + (ks >> 2) * kHalf + mt * 8192 +
                               (ks & 3) * 32),
              wgmma_desc_sw128(w1a + (ks >> 2) * kKBlock + c * 4096 +
                               (ks & 3) * 32),
              ks != 0);
        }
        wgmma_commit();
      }
      wgmma_wait<2>();
      fence_registers(acc[0]);
      epilogue_m1(p, tl, acc[0], 0, 32 * c, warp, lane, ab1, m1);
      __syncwarp();
      wgmma_wait<1>();
      fence_registers(acc[1]);
      epilogue_m1(p, tl, acc[1], 1, 32 * c, warp, lane, ab1, m1);
      __syncwarp();
      wgmma_wait<0>();
      fence_registers(acc[2]);
      epilogue_m1(p, tl, acc[2], 2, 32 * c, warp, lane, ab1, m1);
    }
    __syncwarp();
    named_barrier(1, 256);   // m1 whole (both warpgroups' channels)

    // ---- m2 = q8_relu(conv3x3(m1, w2)) on this warpgroup's 64 pixels
    int acc2[32];
    {
      uint32_t a[18][4];
      const uint32_t lm = smem_u32(m1) + lm_lane;
      // a tap's two k32 steps go to the tensor cores as soon as they are
      // loaded, while the next tap's fragments load
#pragma unroll
      for (int ks = 0; ks < 18; ++ks) {
        const int tap = ks >> 1, ky = tap / 3, kx = tap - 3 * ky;
        ldmatrix_x4(a[ks], lm + (ky * HW + kx) * kM1Ld + (ks & 1) * 32);
        if (ks & 1) {
          wgmma_fence();
          wgmma_m64n64k32_s8_rs(
              acc2, a[ks - 1],
              wgmma_desc_sw128(w2a + ((ks - 1) >> 2) * kKBlock +
                               ((ks - 1) & 3) * 32), ks != 1);
          wgmma_m64n64k32_s8_rs(
              acc2, a[ks],
              wgmma_desc_sw128(w2a + (ks >> 2) * kKBlock + (ks & 3) * 32), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(acc2);
    }

    // ---- out = join(m2 . w3): m2 requantized into A fragments (the
    // permuted depth order), two N halves of 128 in flight
    {
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = 4 * ks + 2 * hf;
          const float4 ab0 =
              *reinterpret_cast<const float4*>(ab2 + 8 * j + t2);
          const float4 ab1_ =
              *reinterpret_cast<const float4*>(ab2 + 8 * (j + 1) + t2);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t lo =
                q8_pair(acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1], ab0);
            const uint32_t hi = q8_pair(acc2[4 * (j + 1) + 2 * h],
                                        acc2[4 * (j + 1) + 2 * h + 1], ab1_);
            a[ks][2 * hf + h] = lo | (hi << 16);
          }
        }
      int acc[2][64];
      wgmma_fence();
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          wgmma_m64n128k32_s8_rs(
              acc[nh], a[ks],
              wgmma_desc_sw128(w3a + nh * (128 * 128) + ks * 32), ks != 0);
        }
        wgmma_commit();
      }
      wgmma_wait<1>();
      fence_registers(acc[0]);
      epilogue_join(acc[0], 0, py, lane, stage, ab3, res);
      wgmma_wait<0>();
      fence_registers(acc[1]);
      epilogue_join(acc[1], 1, py, lane, stage, ab3, res);
    }
    // the stage was written through the generic proxy; the TMA stores
    // read it through the async one
    fence_proxy_async();
    mbar_arrive(joined + 8 * s);
  }
}

}  // namespace
}  // namespace ursonet_int8

namespace {

// The launch arguments; false if refused.
bool block_args(const void* x, const void* w1, const void* w2,
                const void* w3, const void* ab, int ldab, int B, int H,
                int W, int cin, int cmid, void* out,
                ursonet_int8::BlockArgs* a) {
  using namespace ursonet_int8;
  if (x == nullptr || w1 == nullptr || w2 == nullptr || w3 == nullptr ||
      ab == nullptr || out == nullptr || B <= 0 || H <= 0 || W <= 0 ||
      cin != CIN || cmid != CMID || ldab < CIN) {
    return false;
  }
  a->x = static_cast<const int8_t*>(x);
  a->w1 = static_cast<const int8_t*>(w1);
  a->w2 = static_cast<const int8_t*>(w2);
  a->w3 = static_cast<const int8_t*>(w3);
  a->ab = static_cast<const float*>(ab);
  a->ldab = ldab;
  a->B = B;
  a->H = H;
  a->W = W;
  a->tiles_y = (H + TH - 1) / TH;
  a->tiles_x = (W + TW - 1) / TW;
  a->out = static_cast<int8_t*>(out);
  const long long tiles = static_cast<long long>(B) * a->tiles_y * a->tiles_x;
  if (tiles > 0x7fffffffLL) return false;
  a->tiles = static_cast<int>(tiles);
  return true;
}

cudaError_t sm_count(int device, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// x, the weights and out 16-byte aligned (the tensor
// maps' bases, the weights' 16-byte loads).
extern "C" int ursonet_block_s8(const void* x, const void* w1,
                                const void* w2, const void* w3,
                                const void* ab, int ldab, int B, int H,
                                int W, int cin, int cmid, void* out,
                                int device, void* stream) {
  using namespace ursonet_int8;
  BlockArgs a;
  if (!block_args(x, w1, w2, w3, ab, ldab, B, H, W, cin, cmid, out, &a) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w1) % 16 ||
      reinterpret_cast<uintptr_t>(w2) % 16 ||
      reinterpret_cast<uintptr_t>(w3) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const uint64_t row = static_cast<uint64_t>(W) * CIN;
  if (!hopper::make_byte_map_4d_sw128(&map, x, CIN, W, H, B, CIN, row,
                                      row * H, HW, HH)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_out;
  if (!hopper::make_byte_map_4d_sw128(&map_out, out, CIN, W, H, B, CIN, row,
                                      row * H, TW, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(block_s8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.tiles < sms ? a.tiles : sms;
  block_s8_kernel<<<grid, kThreads,
                                   kSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      map, map_out, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ursonet_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
