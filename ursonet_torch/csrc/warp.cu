// Batched homography warp for Hopper (sm_90a), fused with the identity
// select and the mean-subtract mold of the on-device preprocess; bound
// through a plain C interface (ctypes; see ursonet_torch/ops/warp_cuda.py).
//
// Replaces the Pallas TPU kernel ursonet_tpu/ops/warp_pallas.py::_kernel
// (def :56, pallas_call :160). That kernel DMA'd each output tile's
// bounded source box into VMEM and recast the gather as one-hot MXU
// matmuls, because the TPU has no gather unit. Hopper gathers natively,
// from shared memory too, so the box is kept and the matmuls go.
//
// What it computes (cv2 WARP_INVERSE_MAP semantics, as warp_nearest_jax /
// warp_bilinear_jax in ursonet_tpu/ops/augment.py), for each output
// pixel of a contiguous f32 [B, C_out, H, W] tensor:
//   fused:   out[b,c,y,x] = (identity[b] ? src[b,s(c),y,x]
//                            : sample(src[b,s(c)], M_b·(x,y,1))) - mean[c]
//   unfused: out[b,c,y,x] = sample(src[b,c], M_b·(x,y,1))
// sample is nearest (round half to even) or bilinear, taps outside the
// image read 0. Sources: the raw u8 NHWC batch [B,H,W,3] with s(c) = c
// (the RGB train paths), a f32 plane [B,1,H,W] with s(c) = 0 (the gray
// plane sim2real hands over), or, unfused, f32 NCHW [B,C_in,H,W].
//
// Bound: bytes. The fused function reads its source once and writes
// 12 bytes a pixel: 15 bytes a pixel from u8 (157.3 MB, 0.047 ms at
// 3.35 TB/s for 32x3x512x640), 16 from the gray plane. Its arithmetic
// (~20 flops a pixel for the coordinate, ~11 a channel for bilinear) is
// far below the card's f32 balance. The chain it replaces (cast to f32
// NCHW, warp, torch.where, mold: four launches) moved ~1 GB for the same
// batch.
//
// Design for that bound:
//  * A block owns a 32x32 output tile. Its source box is the bounding box
//    of the images of the tile's four corners, one pixel of margin on
//    each side and one more for the bilinear x0 + 1 tap: a homography
//    maps the tile's edges to straight lines while its denominator keeps
//    one sign over the tile, which the corners decide (it is affine in x
//    and y). A tile whose denominators differ in sign, whose corners map
//    beyond 2^20 or to NaN, or whose box is wider or taller than kBox,
//    reads its taps from global memory (the global path, counted).
//  * The box comes in by TMA: a 3-D map over the u8 rows (batch
//    outermost, so a box never reads the next image) or a 4-D map over
//    the f32 planes. TMA zero-fills what lies outside the image. A box
//    row must start on a 16-byte address (an unaligned start is an
//    illegal instruction), so the box starts up to 15 bytes left of the
//    first pixel the tile needs: of a u8 box's 64 pixels 59 are usable,
//    of a f32 box's 61. Where
//    TMA cannot address the source (a row pitch that is not a multiple
//    of 16 bytes, a base not 16-byte aligned, more than kMaxPlanes
//    planes in the unfused mode) every tile takes the global path; a u8
//    RGB row of odd width is not 4-byte aligned either, so cp.async
//    would not serve it.
//  * Persistent blocks walk the tiles with a two-stage ring: thread 0
//    plans tile i + 1 and starts its box while the block samples tile i.
//  * Each tap's box coordinates are checked again before the shared
//    read: a tap that rounding put outside the box reads global memory.
//    The box changes only where a tap is loaded from; the validity
//    compares (which also reject NaN and huge coordinates) are those of
//    the plain version.
//  * A thread samples 4 neighbouring pixels of a row and writes each
//    channel as one 16-byte store, coalesced along x.
//  * An identity image copies its source at (x, y), selected by its
//    flag, not by its M. The mean is subtracted in the same rounding as
//    the plain chain's `images - mean`.
//
// Why not the first port's design: its direct gather (one thread a
// pixel, 4-byte __ldg taps) relied on the source rows staying in L2.
// Under the ±85° roll a warp's 32 pixels read along a tilted line, up to
// 32 sectors a request, and the cast, select and mold around it moved
// ~7x the bytes the function needs.
//
// Rounding: the coordinate arithmetic uses explicit round-to-nearest
// intrinsics (no FMA contraction; the file is also built with
// -fmad=false), in the order of the plain PyTorch version, so the source
// coordinates are bit-identical to ursonet_torch/ops/augment.py's
// _warp_coords and nearest-neighbour ties fall the same way.
//
// Host path: no cudaSetDevice (the wrapper launches on the tensor's
// device); the SM count, the occupancy and the shared-memory attribute
// are read once per device and instantiation, and the last tensor maps
// are cached by source pointer and shape.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;      // output tile side, pixels
constexpr int kPx = 4;         // pixels a thread along x (one 16-byte store)
constexpr int kBox = 64;       // source box side, pixels
constexpr int kMaxPlanes = 4;  // f32 planes a box holds
constexpr int kAlign = 16;     // TMA: a box row starts on a 16-byte address
constexpr int kStages = 2;
// Resident blocks an SM is built for (at most 85 registers a thread; the
// u8 bilinear instantiation spills 52 bytes), so that 24 warps hide the
// gathers' latency; faster than 2 blocks in both interpolations
// (PERF.md §6, row 1).
constexpr int kMinBlocks = 3;
constexpr float kCoordLimit = 1048576.f;  // 2^20: beyond, the global path

constexpr int kNearest = 0;
constexpr int kBilinear = 1;
constexpr int kSrcU8Rgb = 0;    // u8 [B,H,W,3]
constexpr int kSrcF32 = 1;      // f32 [B,C_in,H,W]

constexpr int kPlanBox = 0;     // taps from the box in shared memory
constexpr int kPlanGlobal = 1;  // taps from global memory (counted)
constexpr int kPlanEmpty = 2;   // the box misses the image: no tap is
                                // valid, nothing to load

static_assert(kTile * kTile == kThreads * kPx, "one pass covers a tile");

struct Args {
  const void* src;
  int epp;                   // row elements a pixel (u8: 3 bytes, f32: 1)
  int align;                 // row elements in kAlign bytes (u8 16, f32 4)
  const float* Ms;           // [B,3,3]
  const uint8_t* identity;   // [B] flags (fused), else nullptr
  float* out;                // [B,C_out,H,W]
  int* stats;                // [2]: tiles on the global path, tiles; or null
  float mean[3];
  int b, c_in, c_out, h, w;
  int gray;                  // every output channel samples plane 0
  int planes;                // planes a box holds (f32 source)
  int use_box;               // the tensor map addresses the source
  int fused;                 // identity select and mold
  int tiles_x, tiles_per_image, tiles;
  int stage_bytes;
};

// A tile's source box: its first row element `cx` (kAlign-aligned, the
// element coordinate TMA is given; cx / epp is the box's first pixel, up
// to kAlign bytes left of the first one the tile needs) and row `by0`.
struct Plan {
  int cx, by0, kind, b;
};

__device__ __forceinline__ void src_coord(const float (&m)[9], float xf,
                                          float yf, float& sx, float& sy,
                                          float& den) {
  // (m·x + m·y) + m, each step rounded, as the plain version computes it.
  den = __fadd_rn(__fadd_rn(__fmul_rn(m[6], xf), __fmul_rn(m[7], yf)), m[8]);
  sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], xf), __fmul_rn(m[1], yf)),
                           m[2]), den);
  sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], xf), __fmul_rn(m[4], yf)),
                           m[5]), den);
}

__device__ __forceinline__ void load_m(const Args& a, int b, float (&m)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = __ldg(a.Ms + 9 * b + i);
}

// The source box of one tile (thread 0). Mirrored in numpy by
// tests/test_torch_warp_tiles.py.
__device__ __forceinline__ Plan plan_tile(const Args& a, int tile) {
  Plan p;
  p.b = tile / a.tiles_per_image;
  const int r = tile - p.b * a.tiles_per_image;
  const int x0 = (r % a.tiles_x) * kTile;
  const int y0 = (r / a.tiles_x) * kTile;
  p.kind = a.use_box ? kPlanBox : kPlanGlobal;
  p.cx = x0 * a.epp;  // aligned: x0 is a multiple of kTile
  p.by0 = y0;
  if (!a.use_box || (a.fused && a.identity[p.b])) return p;
  float m[9];
  load_m(a, p.b, m);
  const float xs[2] = {static_cast<float>(x0),
                       static_cast<float>(min(x0 + kTile, a.w) - 1)};
  const float ys[2] = {static_cast<float>(y0),
                       static_cast<float>(min(y0 + kTile, a.h) - 1)};
  float lox = 0.f, hix = 0.f, loy = 0.f, hiy = 0.f;
  bool ok = true, pos = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float sx, sy, den;
    src_coord(m, xs[k & 1], ys[k >> 1], sx, sy, den);
    if (k == 0) pos = den > 0.f;
    // one strict sign at every corner; finite, bounded coordinates (the
    // compares are false for NaN)
    ok = ok && (pos ? den > 0.f : den < 0.f) && fabsf(sx) <= kCoordLimit &&
         fabsf(sy) <= kCoordLimit;
    lox = k == 0 ? sx : fminf(lox, sx);
    hix = k == 0 ? sx : fmaxf(hix, sx);
    loy = k == 0 ? sy : fminf(loy, sy);
    hiy = k == 0 ? sy : fmaxf(hiy, sy);
  }
  if (!ok) {
    p.kind = kPlanGlobal;
    return p;
  }
  const int bx0 = static_cast<int>(floorf(lox)) - 1;
  const int by0 = static_cast<int>(floorf(loy)) - 1;
  const int bx1 = static_cast<int>(floorf(hix)) + 2;
  const int by1 = static_cast<int>(floorf(hiy)) + 2;
  // the row elements of pixels bx0..bx1, from an aligned start (two's
  // complement: & floors negative starts too)
  const int cx = (bx0 * a.epp) & ~(a.align - 1);
  if ((bx1 + 1) * a.epp - cx > kBox * a.epp || by1 - by0 + 1 > kBox) {
    p.kind = kPlanGlobal;
    return p;
  }
  p.cx = cx;
  p.by0 = by0;
  if (bx1 < 0 || by1 < 0 || bx0 >= a.w || by0 >= a.h) p.kind = kPlanEmpty;
  return p;
}

template <int SRC>
__device__ __forceinline__ void load_box(const Args& a, const CUtensorMap* map,
                                         const Plan& p, uint32_t dst,
                                         uint32_t bar) {
  using namespace hopper;
  if (p.kind != kPlanBox) {
    mbar_arrive(bar);  // completes the phase: nothing to wait for
    return;
  }
  fence_proxy_async();  // the generic reads of this stage came before
  if (SRC == kSrcU8Rgb) {
    mbar_arrive_expect_tx(bar, kBox * kBox * 3);
    tma_load_3d(dst, map, bar, p.cx, p.by0, p.b);
  } else {
    mbar_arrive_expect_tx(bar, kBox * kBox * 4 * a.planes);
    tma_load_4d(dst, map, bar, p.cx, p.by0, 0, p.b);
  }
}

// Where a tap at (iy, ix), inside the image, is read: its element
// offset in the box (the plane's offset added per channel), or, when the
// tile reads global memory or rounding put the tap outside the box, -1.
template <int SRC>
__device__ __forceinline__ int box_offset(const Plan& p, int iy, int ix) {
  const int lx = SRC == kSrcU8Rgb ? 3 * ix - p.cx : ix - p.cx;
  const int ly = iy - p.by0;
  constexpr int kRow = SRC == kSrcU8Rgb ? 3 * kBox : kBox;
  return p.kind == kPlanBox &&
                 static_cast<unsigned>(lx) <= kRow - (SRC == kSrcU8Rgb ? 3 : 1) &&
                 static_cast<unsigned>(ly) < kBox
             ? ly * kRow + lx
             : -1;
}

// The tap's value in source plane `plane`: from the box at `off`, else
// from global memory.
template <int SRC>
__device__ __forceinline__ float tap(const Args& a, const uint8_t* box, int b,
                                     int off, int plane, int iy, int ix) {
  if (off >= 0) {
    if (SRC == kSrcU8Rgb) return static_cast<float>(box[off + plane]);
    return reinterpret_cast<const float*>(box)[off + plane * kBox * kBox];
  }
  if (SRC == kSrcU8Rgb) {
    const uint8_t* s = static_cast<const uint8_t*>(a.src);
    return static_cast<float>(
        __ldg(s + ((static_cast<size_t>(b) * a.h + iy) * a.w + ix) * 3 + plane));
  }
  const float* s = static_cast<const float*>(a.src);
  return __ldg(s + ((static_cast<size_t>(b) * a.c_in + plane) * a.h + iy) * a.w + ix);
}

constexpr int kMaxC = 3;  // output channels a pass

// Output pixel (y, xj) for channels c0 .. c0 + nc - 1 into o[k][j].
template <int SRC, int INTERP>
__device__ __forceinline__ void sample_pixel(
    const Args& a, const uint8_t* box, const Plan& p, bool ident,
    const float (&m)[9], int xj, int y, int c0, int nc, float wmax,
    float hmax, float (&o)[kMaxC][kPx], int j) {
  if (ident || INTERP == kNearest) {
    int ix = xj, iy = y;
    bool valid = true;
    if (!ident) {
      float sx, sy, den;
      src_coord(m, static_cast<float>(xj), static_cast<float>(y), sx, sy, den);
      const float rx = rintf(sx);  // half to even, as torch.round
      const float ry = rintf(sy);
      // validity after rounding; float compares also reject NaN and
      // values too large for an int
      valid = rx >= 0.f && rx <= wmax && ry >= 0.f && ry <= hmax;
      ix = valid ? static_cast<int>(rx) : 0;
      iy = valid ? static_cast<int>(ry) : 0;
    }
    const int off = box_offset<SRC>(p, iy, ix);
#pragma unroll
    for (int k = 0; k < kMaxC; ++k) {
      if (k < nc) {
        const int plane = a.gray ? 0 : c0 + k;
        o[k][j] = valid ? tap<SRC>(a, box, p.b, off, plane, iy, ix) : 0.f;
      }
    }
    return;
  }
  float sx, sy, den;
  src_coord(m, static_cast<float>(xj), static_cast<float>(y), sx, sy, den);
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f);
  const float fy = __fsub_rn(sy, y0f);
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const bool vx0 = x0f >= 0.f && x0f <= wmax;
  const bool vx1 = x0f >= -1.f && x0f <= wmax - 1.f;
  const bool vy0 = y0f >= 0.f && y0f <= hmax;
  const bool vy1 = y0f >= -1.f && y0f <= hmax - 1.f;
  const int ix0 = vx0 ? static_cast<int>(x0f) : 0;
  const int ix1 = vx1 ? static_cast<int>(x0f) + 1 : 0;
  const int iy0 = vy0 ? static_cast<int>(y0f) : 0;
  const int iy1 = vy1 ? static_cast<int>(y0f) + 1 : 0;
  const int o00 = box_offset<SRC>(p, iy0, ix0), o01 = box_offset<SRC>(p, iy0, ix1);
  const int o10 = box_offset<SRC>(p, iy1, ix0), o11 = box_offset<SRC>(p, iy1, ix1);
#pragma unroll
  for (int k = 0; k < kMaxC; ++k) {
    if (k < nc) {
      const int plane = a.gray ? 0 : c0 + k;
      const float v00 = vy0 && vx0 ? tap<SRC>(a, box, p.b, o00, plane, iy0, ix0) : 0.f;
      const float v01 = vy0 && vx1 ? tap<SRC>(a, box, p.b, o01, plane, iy0, ix1) : 0.f;
      const float v10 = vy1 && vx0 ? tap<SRC>(a, box, p.b, o10, plane, iy1, ix0) : 0.f;
      const float v11 = vy1 && vx1 ? tap<SRC>(a, box, p.b, o11, plane, iy1, ix1) : 0.f;
      // ((v00·gx·gy + v01·fx·gy) + v10·gx·fy) + v11·fx·fy, the plain
      // version's products and order
      float acc = __fmul_rn(__fmul_rn(v00, gx), gy);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, fx), gy));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, gx), fy));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, fx), fy));
      o[k][j] = acc;
    }
  }
}

template <int SRC, int INTERP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
warp_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * a.stage_bytes);
  Plan* plans = reinterpret_cast<Plan*>(bars + kStages);
  const uint32_t bar0 = smem_u32(bars);
  const int tid = threadIdx.x;
  int global_tiles = 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_barrier_init();
    if (static_cast<int>(blockIdx.x) < a.tiles) {
      plans[0] = plan_tile(a, blockIdx.x);
      load_box<SRC>(a, &map, plans[0], smem_u32(ring), bar0);
    }
  }
  __syncthreads();

  const int row = tid / (kTile / kPx);
  const int col = (tid % (kTile / kPx)) * kPx;
  const float wmax = static_cast<float>(a.w - 1);
  const float hmax = static_cast<float>(a.h - 1);
  const bool vec = (a.w % kPx) == 0;

  int i = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++i) {
    const int slot = i & 1;
    const int next = tile + gridDim.x;
    if (tid == 0 && next < a.tiles) {
      // the other stage was read in iteration i - 1, before the barrier
      // that ended it
      plans[slot ^ 1] = plan_tile(a, next);
      load_box<SRC>(a, &map, plans[slot ^ 1],
                    smem_u32(ring + (slot ^ 1) * a.stage_bytes),
                    bar0 + 8 * (slot ^ 1));
    }
    const Plan p = plans[slot];
    if (tid == 0 && p.kind == kPlanGlobal) ++global_tiles;
    const int r = tile - p.b * a.tiles_per_image;
    const int y = (r / a.tiles_x) * kTile + row;
    const int x = (r % a.tiles_x) * kTile + col;
    const bool ident = a.fused && a.identity[p.b];
    float m[9];
    load_m(a, p.b, m);
    mbar_wait(bar0 + 8 * slot, (i >> 1) & 1);
    const uint8_t* box = ring + slot * a.stage_bytes;

    if (y < a.h && x < a.w) {
      for (int c0 = 0; c0 < a.c_out; c0 += kMaxC) {
        const int nc = min(kMaxC, a.c_out - c0);
        float o[kMaxC][kPx];
#pragma unroll
        for (int j = 0; j < kPx; ++j) {
#pragma unroll
          for (int k = 0; k < kMaxC; ++k) o[k][j] = 0.f;
          if (x + j < a.w)
            sample_pixel<SRC, INTERP>(a, box, p, ident, m, x + j, y, c0, nc,
                                      wmax, hmax, o, j);
        }
#pragma unroll
        for (int k = 0; k < kMaxC; ++k) {
          if (k >= nc) break;
          const int c = c0 + k;
          float v[kPx];
#pragma unroll
          for (int j = 0; j < kPx; ++j)
            // fused: c_out = 3, one pass (c0 = 0, c = k)
            v[j] = a.fused ? __fsub_rn(o[k][j], a.mean[k]) : o[k][j];
          float* d = a.out + ((static_cast<size_t>(p.b) * a.c_out + c) * a.h + y) * a.w + x;
          if (vec && x + kPx <= a.w) {
            *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < kPx; ++j)
              if (x + j < a.w) d[j] = v[j];
          }
        }
      }
    }
    __syncthreads();  // the stage is read; thread 0 may refill it
  }
  if (tid == 0 && a.stats != nullptr) {
    atomicAdd(a.stats, global_tiles);
    atomicAdd(a.stats + 1, i);
  }
}

// ---- host -----------------------------------------------------------------

// Tensor maps by source pointer and shape: a map encodes only these, so
// a hit is the same map.
struct MapEntry {
  const void* src;
  int kind, b, c_in, h, w, planes;
  CUtensorMap map;
};
constexpr int kMapCache = 16;
MapEntry g_maps[kMapCache];
int g_maps_used = 0, g_maps_next = 0;
std::mutex g_mutex;

bool encode_map(CUtensorMap* map, const void* src, int kind, int b, int c_in,
                int h, int w, int planes) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled_fn();
  if (fn == nullptr) return false;
  if (kind == kSrcU8Rgb) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w) * 3,
                                static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[2] = {dims[0], dims[0] * h};
    const cuuint32_t box[3] = {kBox * 3, kBox, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(src),
              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(c_in),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = dims[0] * 4;
  const cuuint64_t strides[3] = {row, row * h, row * h * c_in};
  const cuuint32_t box[4] = {kBox, kBox, static_cast<cuuint32_t>(planes), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(src),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A cached or new map; false if the encoding is refused.
bool tensor_map(CUtensorMap* map, const void* src, int kind, int b, int c_in,
                int h, int w, int planes) {
  std::lock_guard<std::mutex> lock(g_mutex);
  for (int k = 0; k < g_maps_used; ++k) {
    const MapEntry& e = g_maps[k];
    if (e.src == src && e.kind == kind && e.b == b && e.c_in == c_in &&
        e.h == h && e.w == w && e.planes == planes) {
      *map = e.map;
      return true;
    }
  }
  if (!encode_map(map, src, kind, b, c_in, h, w, planes)) return false;
  MapEntry& e = g_maps[g_maps_next];
  e = MapEntry{src, kind, b, c_in, h, w, planes, *map};
  g_maps_next = (g_maps_next + 1) % kMapCache;
  if (g_maps_used < kMapCache) ++g_maps_used;
  return true;
}

// Per device and instantiation, set up once: the shared-memory limit
// (the most any call of the instantiation takes) and, per box size, the
// blocks a launch runs (SMs x resident blocks).
constexpr int kMaxDevices = 16;
constexpr int kKernels = 4;
bool g_attr[kMaxDevices][kKernels];
int g_grid[kMaxDevices][kKernels][kMaxPlanes + 1];

constexpr int smem_bytes(int stage_bytes) {
  return 1024 + kStages * stage_bytes + 8 * kStages +
         static_cast<int>(sizeof(Plan)) * kStages;
}

template <int SRC, int INTERP>
cudaError_t launch(const CUtensorMap& map, const Args& a, int device,
                   cudaStream_t stream) {
  const auto kernel = warp_kernel<SRC, INTERP>;
  const int k = SRC * 2 + INTERP;
  const int smem = smem_bytes(a.stage_bytes);
  const int slot = a.use_box ? (SRC == kSrcU8Rgb ? 1 : a.planes) : 0;
  int& blocks = g_grid[device][k][slot];
  if (blocks == 0) {
    std::lock_guard<std::mutex> lock(g_mutex);
    cudaError_t err;
    if (!g_attr[device][k]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes(SRC == kSrcU8Rgb ? kBox * kBox * 3
                                      : kBox * kBox * 4 * kMaxPlanes));
      if (err != cudaSuccess) return err;
      g_attr[device][k] = true;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = a.tiles < blocks ? a.tiles : blocks;
  kernel<<<grid, kThreads, smem, stream>>>(map, a);
  return cudaGetLastError();
}

}  // namespace

// src_kind 0: u8 [B,H,W,3] (c_in = 3); 1: f32 [B,C_in,H,W]. fused: the
// identity flags and the mean (c_out = 3) are read; gray: every output
// channel samples plane 0. stats: null, or two ints the launch adds its
// global-path tiles and its tiles to. Launches on the current device.
extern "C" int ursonet_warp(const void* src, int src_kind, const float* Ms,
                            const uint8_t* identity, const float* mean,
                            float* out, int* stats, int b, int c_in,
                            int c_out, int h, int w, int gray, int fused,
                            int interpolation, void* stream) {
  if (b <= 0 || c_in <= 0 || c_out <= 0 || h <= 0 || w <= 0 ||
      (src_kind != kSrcU8Rgb && src_kind != kSrcF32) ||
      (src_kind == kSrcU8Rgb && (c_in != 3 || gray)) ||
      (!gray && c_out > c_in) || (fused && (c_out != 3 || identity == nullptr ||
                                            mean == nullptr)) ||
      (interpolation != kNearest && interpolation != kBilinear)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);

  Args a;
  a.src = src;
  a.epp = src_kind == kSrcU8Rgb ? 3 : 1;
  a.align = src_kind == kSrcU8Rgb ? kAlign : kAlign / 4;
  a.Ms = Ms;
  a.identity = identity;
  a.out = out;
  a.stats = stats;
  for (int c = 0; c < 3; ++c) a.mean[c] = fused ? mean[c] : 0.f;
  a.b = b;
  a.c_in = c_in;
  a.c_out = c_out;
  a.h = h;
  a.w = w;
  a.gray = gray;
  a.fused = fused;
  a.planes = src_kind == kSrcU8Rgb ? 3 : (gray ? 1 : c_out);
  a.tiles_x = (w + kTile - 1) / kTile;
  a.tiles_per_image = a.tiles_x * ((h + kTile - 1) / kTile);
  const long long tiles = static_cast<long long>(a.tiles_per_image) * b;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  const size_t row_bytes = static_cast<size_t>(w) * (src_kind == kSrcU8Rgb ? 3 : 4);
  a.use_box = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
              (src_kind == kSrcU8Rgb || a.planes <= kMaxPlanes);
  a.stage_bytes = src_kind == kSrcU8Rgb ? kBox * kBox * 3
                                        : kBox * kBox * 4 * a.planes;
  CUtensorMap map;
  if (a.use_box) {
    if (!tensor_map(&map, src, src_kind, b, c_in, h, w, a.planes))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    a.stage_bytes = 16;  // no box: the ring is unused
    memset(&map, 0, sizeof(map));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_kind == kSrcU8Rgb) {
    err = interpolation == kNearest ? launch<kSrcU8Rgb, kNearest>(map, a, device, s)
                                    : launch<kSrcU8Rgb, kBilinear>(map, a, device, s);
  } else {
    err = interpolation == kNearest ? launch<kSrcF32, kNearest>(map, a, device, s)
                                    : launch<kSrcF32, kBilinear>(map, a, device, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* ursonet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
