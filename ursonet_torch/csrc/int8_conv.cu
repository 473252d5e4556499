// Implicit-GEMM int8 convolution with a fused epilogue for Hopper
// (sm_90a), bound through a plain C interface (ctypes; see
// ursonet_torch/ops/int8_cuda.py).
//
// Replaces the Pallas TPU kernel tools/probe_pallas_conv3.py::_conv_kernel
// (implicit-GEMM s8 3x3/1 conv with a fused ReLU + requant epilogue). That
// kernel DMA'd whole row bands of the padded input into VMEM and built a
// [rows*W, 9C] patch matrix there for one MXU matmul; it took stride 1,
// C % 128 == 0 and a pre-padded input only. Here the patch matrix is
// never built: each thread gathers its 16-byte A chunks straight from
// the NHWC input (zeros for taps in the padding), so any KH x KW, stride
// and explicit (top, bottom, left, right) pads work on an unpadded
// input. On the serving path it carries the sixteen 3x3/1 res*_branch2b
// convs and the 3x3/2 bottleneck conv with Flax-SAME pads (0, 1); the
// 7x7/2 stem (C = 3, K = 147: the ragged byte-wise gather) only for a
// float molded batch or a raw one the fused stem's 'nhwc' route
// (int8_stem.cu) does not take.
//
// Computes out[B, OH, OW, N] = epilogue(sum over (ky, kx, c) of
//   x[b, oy*s - pad_t + ky, ox*s - pad_l + kx, c] * w[n, ky, kx, c]),
// x NHWC s8, weights output-channel-major [N, KH, KW, C] s8 (OHWI, the
// HWIO kernel transposed once by the caller), s32 accumulation.
//
// Bound. A 3x3 conv with C = N does 2*9*C*N operations per output pixel
// and moves about 2*C bytes for it: 9*N operations a byte, 576 at C2
// (N = 64) to 4608 at C5 (N = 512), against the card's ~590 int8
// operations a byte. So C3..C5 and the bottleneck conv are bound by the
// tensor cores' rate, C2 sits at the ridge, and the stem (C = 3) is
// bound by its bytes. Two routes, chosen by the wrapper from the shapes
// before the launch:
//   ursonet_conv_s8_tma  (C % 16 == 0, N % 16 == 0, 16-byte aligned
//     pointers: every 3x3 conv of the served model) the persistent
//     TMA + wgmma kernel of int8_tma.cuh with a gathering producer: the
//     weights [N, KH*KW*C] are a K-major matrix loaded by TMA; the
//     patches are still never built: a producer warpgroup copies each
//     16-byte chunk of K (it lies inside one tap) from the NHWC input
//     with cp.async, zero-filled in the padding, to the swizzled address
//     the wgmma descriptor expects, arriving on the stage's mbarrier;
//     the (b, oy, ox) of a row is decomposed once per tile, the tap once
//     per stage and chunk.
//   ursonet_conv_s8      (any shape: the ragged route; on the serving
//     path only the C = 3 stem of the `base` variant where the fused
//     stem does not take the batch) the mma.sync tile loop of
//     int8_common.cuh with a register-staged gather, byte-wise when
//     C % 16 != 0.
// Later work: TMA im2col loads for the patches.

#include "int8_common.cuh"
#include "int8_tma.cuh"

namespace ursonet_int8 {
namespace {

struct Geom {
  int H, W, C, OH, OW, KH, KW, stride, pad_t, pad_l, Ktot;
};

template <class T, bool kExtra>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Wt,
               Geom g, int M, int N, int vec_x, int vec_w, int n_tiles,
               Epilogue ep) {
  __shared__ __align__(16) int8_t As[2 * T::BM * LDS];
  __shared__ __align__(16) int8_t Bs[2 * T::BN * LDS];
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * T::BN;
  const int m0 = static_cast<int>(blockIdx.x / n_tiles) * T::BM;
  const int r0 = threadIdx.x >> 2;

  // The output pixel of each of this thread's A rows, fixed for the
  // whole K loop: its image's base pointer and top-left input tap.
  const int8_t* base[T::A_PASSES];
  int iy0[T::A_PASSES], ix0[T::A_PASSES];
  bool valid[T::A_PASSES];
  const int ohw = g.OH * g.OW;
#pragma unroll
  for (int p = 0; p < T::A_PASSES; ++p) {
    const int m = m0 + r0 + 64 * p;
    valid[p] = m < M;
    const int b = valid[p] ? m / ohw : 0;
    const int rem = valid[p] ? m - b * ohw : 0;
    const int oy = rem / g.OW;
    const int ox = rem - oy * g.OW;
    base[p] = X + static_cast<int64_t>(b) * g.H * g.W * g.C;
    iy0[p] = oy * g.stride - g.pad_t;
    ix0[p] = ox * g.stride - g.pad_l;
  }

  auto fetch_a = [&](int p, int k) -> int4 {
    if (!valid[p] || k >= g.Ktot) return make_int4(0, 0, 0, 0);
    int tap = k / g.C;
    int c = k - tap * g.C;
    int ky = tap / g.KW;
    int kx = tap - ky * g.KW;
    if (vec_x) {  // C % 16 == 0: the chunk lies inside one tap
      const int iy = iy0[p] + ky, ix = ix0[p] + kx;
      if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W)
        return make_int4(0, 0, 0, 0);
      return __ldg(reinterpret_cast<const int4*>(
          base[p] + (static_cast<int64_t>(iy) * g.W + ix) * g.C + c));
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int iy = iy0[p] + ky, ix = ix0[p] + kx;
      if (k + i < g.Ktot && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
        const int8_t v = __ldg(
            base[p] + (static_cast<int64_t>(iy) * g.W + ix) * g.C + c);
        w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
                     << (8 * (i & 3));
      }
      if (++c == g.C) {
        c = 0;
        if (++kx == g.KW) {
          kx = 0;
          ++ky;
        }
      }
    }
    return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                     static_cast<int>(w[2]), static_cast<int>(w[3]));
  };
  int acc[T::MT][T::NT][4];
  mainloop<T>(fetch_a, Wt, N, g.Ktot, n0, vec_w != 0, As, Bs, acc);
  finish<T, kExtra>(ep, M, N, m0, n0, acc);
}

template <class T>
cudaError_t launch(const int8_t* X, const int8_t* Wt, const Geom& g, int M,
                   int N, int vec_x, int vec_w, const Epilogue& ep,
                   cudaStream_t stream) {
  const long long n_tiles = (N + T::BN - 1) / T::BN;
  const long long blocks = (M + T::BM - 1) / T::BM * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  // the modes of epilogue_extra in an instantiation of their own
  if (extra_mode(ep.mode, ep.res_type)) {
    conv_s8_kernel<T, true><<<nb, kThreads, 0, stream>>>(
        X, Wt, g, M, N, vec_x, vec_w, static_cast<int>(n_tiles), ep);
  } else {
    conv_s8_kernel<T, false><<<nb, kThreads, 0, stream>>>(
        X, Wt, g, M, N, vec_x, vec_w, static_cast<int>(n_tiles), ep);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ursonet_int8

extern "C" int ursonet_conv_s8(const void* X, const void* Wt, int B, int H,
                               int W, int C, int N, int KH, int KW,
                               int stride, int pad_t, int pad_b, int pad_l,
                               int pad_r, int vec_x, int vec_w, int mode,
                               int bf16, const void* alpha, const void* beta,
                               float inv_s_out, const void* res, int res_type,
                               float res_scale, void* out, int tile,
                               int device, void* stream) {
  using namespace ursonet_int8;
  const Epilogue ep{mode, static_cast<const float*>(alpha),
                    static_cast<const float*>(beta), inv_s_out,
                    res, res_type, res_scale, out, bf16 != 0 ? 1 : 0};
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || KH <= 0 ||
      KW <= 0 || stride <= 0 || pad_t < 0 || pad_b < 0 || pad_l < 0 ||
      pad_r < 0 || X == nullptr || Wt == nullptr || !epilogue_ok(ep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hp = H + pad_t + pad_b, wp = W + pad_l + pad_r;
  if (hp < KH || wp < KW) return static_cast<int>(cudaErrorInvalidValue);
  const long long ktot = static_cast<long long>(KH) * KW * C;
  const long long oh = (hp - KH) / stride + 1, ow = (wp - KW) / stride + 1;
  const long long m = B * oh * ow;
  if (ktot > 0x7fffffffLL || m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{H, W, C, static_cast<int>(oh), static_cast<int>(ow), KH, KW,
               stride, pad_t, pad_l, static_cast<int>(ktot)};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int8_t* x = static_cast<const int8_t*>(X);
  const int8_t* w = static_cast<const int8_t*>(Wt);
  const int M = static_cast<int>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: err = launch<TileLarge>(x, w, g, M, N, vec_x, vec_w, ep, s); break;
    case 1: err = launch<TileNarrow>(x, w, g, M, N, vec_x, vec_w, ep, s); break;
    case 2: err = launch<TileSmall>(x, w, g, M, N, vec_x, vec_w, ep, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int ursonet_conv_s8_tma(const void* X, const void* Wt, int B,
                                   int H, int W, int C, int N, int KH, int KW,
                                   int stride, int pad_t, int pad_b,
                                   int pad_l, int pad_r, int mode, int bf16,
                                   const void* alpha, const void* beta,
                                   float inv_s_out, const void* res,
                                   int res_type, float res_scale, void* out,
                                   int bn, int stages, int bufs, int resident,
                                   int grid, int device, void* stream) {
  using namespace ursonet_int8;
  const Epilogue ep{mode, static_cast<const float*>(alpha),
                    static_cast<const float*>(beta), inv_s_out,
                    res, res_type, res_scale, out, bf16 != 0 ? 1 : 0};
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || N <= 0 ||
      KH <= 0 || KW <= 0 || stride <= 0 || pad_t < 0 || pad_b < 0 ||
      pad_l < 0 || pad_r < 0 || X == nullptr || Wt == nullptr ||
      !epilogue_ok(ep) || bn <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hp = H + pad_t + pad_b, wp = W + pad_l + pad_r;
  if (hp < KH || wp < KW) return static_cast<int>(cudaErrorInvalidValue);
  const long long ktot = static_cast<long long>(KH) * KW * C;
  const long long oh = (hp - KH) / stride + 1, ow = (wp - KW) / stride + 1;
  const long long m = B * oh * ow;
  // the gather keeps a row's taps in 32 bits and its offsets in 32
  if (ktot > 0x7fffffffLL || m > 0x7fffffffLL || KH * KW > 32 ||
      static_cast<long long>(B) * hp * wp * C > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  tma::Params p{};
  p.M = static_cast<int>(m), p.N = N, p.K = static_cast<int>(ktot);
  p.n_tiles = (N + bn - 1) / bn;
  p.ksteps = (p.K + tma::kBK - 1) / tma::kBK;
  p.splits = 1;
  const long long items = (m + tma::kBM - 1) / tma::kBM * p.n_tiles;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  p.stages = stages, p.bufs = bufs, p.resident = resident;
  p.mode = mode, p.bf16 = ep.bf16;
  p.out_bytes = tma::out_bytes_of(mode, p.bf16);
  p.alpha = ep.alpha, p.beta = ep.beta;
  p.inv_s_out = inv_s_out, p.res_scale = res_scale;
  p.res_type = res_type;
  p.res_bytes =
      is_join(mode) && res_type != kResS8 ? res_type_bytes(res_type) : 0;
  p.X = static_cast<const int8_t*>(X);
  p.g = tma::ConvGeom{H, W, C, static_cast<int>(oh), static_cast<int>(ow), KH,
                      KW, stride, pad_t, pad_l};
  err = tma::launch_bn<true>(bn, nullptr, static_cast<const int8_t*>(Wt),
                             ep.res, out, p, grid,
                             static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* ursonet_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
