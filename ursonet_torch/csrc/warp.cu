// Batched homography warp for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ursonet_torch/ops/warp_cuda.py).
//
// Replaces the Pallas TPU kernel ursonet_tpu/ops/warp_pallas.py::_kernel.
// That kernel recast the per-pixel gather as one-hot MXU matmuls over
// source tiles DMA'd into VMEM, because the TPU has no gather unit. Hopper
// gathers natively, so this is a direct gather: one thread per output
// pixel of one image computes the source coordinate once and reads all
// channels' taps through the read-only cache (L1/L2).
//
// What it computes (cv2 WARP_INVERSE_MAP semantics, as warp_nearest_jax /
// warp_bilinear_jax in ursonet_tpu/ops/augment.py):
//   dst[b, c, y, x] = src[b, c](M_b · (x, y, 1)), taps outside the image 0,
//   nearest (round half to even) or bilinear sampling.
// src is a contiguous [B, C_in, H, W] f32 tensor; the first C_out
// channels are warped into a fresh contiguous [B, C_out, H, W] tensor
// (C_out = 1 for the grayscale wrapper, which broadcasts afterwards).
//
// Bound: memory. Each output pixel costs ~20 flops for the coordinate and
// ~8 per channel for bilinear, against 8 bytes per channel moved (one
// read, one write), far below the card's 20 flop/byte balance in f32.
// So the design keeps reads and writes coalesced along x, computes the
// coordinate once per pixel for all channels, and does no tiling: the
// gather's source rows are close together for the mild perspective of
// camera rotations and stay in L2.
//
// Rounding: the coordinate arithmetic uses explicit round-to-nearest
// intrinsics (no FMA contraction; the file is also built with
// -fmad=false), in the order of the plain PyTorch version, so the source
// coordinates are bit-identical to it and nearest-neighbour ties fall the
// same way.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNearest = 0;
constexpr int kBilinear = 1;

template <int INTERP>
__global__ void __launch_bounds__(kThreads)
warp_homography_kernel(const float* __restrict__ src,
                       const float* __restrict__ Ms,
                       float* __restrict__ dst,
                       int c_in, int c_out, int h, int w) {
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y;

  const float* M = Ms + 9 * b;
  const float m00 = __ldg(M + 0), m01 = __ldg(M + 1), m02 = __ldg(M + 2);
  const float m10 = __ldg(M + 3), m11 = __ldg(M + 4), m12 = __ldg(M + 5);
  const float m20 = __ldg(M + 6), m21 = __ldg(M + 7), m22 = __ldg(M + 8);

  const int y = p / w;
  const float xf = static_cast<float>(p - y * w);
  const float yf = static_cast<float>(y);
  // (m·x + m·y) + m, each step rounded, as the plain version computes it.
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(m20, xf), __fmul_rn(m21, yf)), m22);
  const float sx = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m00, xf), __fmul_rn(m01, yf)), m02), den);
  const float sy = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m10, xf), __fmul_rn(m11, yf)), m12), den);

  const float* s = src + static_cast<size_t>(b) * c_in * hw;
  float* d = dst + static_cast<size_t>(b) * c_out * hw + p;
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);

  if (INTERP == kNearest) {
    const float rx = rintf(sx);  // half to even, as torch.round / jnp.round
    const float ry = rintf(sy);
    // Validity after rounding; float compares also reject NaN and values
    // too large for an int.
    if (rx >= 0.f && rx <= wmax && ry >= 0.f && ry <= hmax) {
      const int off = static_cast<int>(ry) * w + static_cast<int>(rx);
      for (int c = 0; c < c_out; ++c) d[c * hw] = __ldg(s + c * hw + off);
    } else {
      for (int c = 0; c < c_out; ++c) d[c * hw] = 0.f;
    }
    return;
  }

  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0);
  const float fy = __fsub_rn(sy, y0);
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const bool vx0 = x0 >= 0.f && x0 <= wmax;
  const bool vx1 = x0 >= -1.f && x0 <= wmax - 1.f;
  const bool vy0 = y0 >= 0.f && y0 <= hmax;
  const bool vy1 = y0 >= -1.f && y0 <= hmax - 1.f;
  const int ix0 = vx0 ? static_cast<int>(x0) : 0;
  const int ix1 = vx1 ? static_cast<int>(x0) + 1 : 0;
  const int iy0 = vy0 ? static_cast<int>(y0) * w : 0;
  const int iy1 = vy1 ? (static_cast<int>(y0) + 1) * w : 0;
  for (int c = 0; c < c_out; ++c) {
    const float* sc = s + c * hw;
    const float v00 = (vy0 && vx0) ? __ldg(sc + iy0 + ix0) : 0.f;
    const float v01 = (vy0 && vx1) ? __ldg(sc + iy0 + ix1) : 0.f;
    const float v10 = (vy1 && vx0) ? __ldg(sc + iy1 + ix0) : 0.f;
    const float v11 = (vy1 && vx1) ? __ldg(sc + iy1 + ix1) : 0.f;
    // Same products and summation order as the plain version:
    // ((v00·gx·gy + v01·fx·gy) + v10·gx·fy) + v11·fx·fy.
    float acc = __fmul_rn(__fmul_rn(v00, gx), gy);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, fx), gy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, gx), fy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, fx), fy));
    d[c * hw] = acc;
  }
}

}  // namespace

extern "C" int ursonet_warp_homography(const float* src, const float* Ms,
                                       float* dst, int b, int c_in, int c_out,
                                       int h, int w, int interpolation,
                                       int device, void* stream) {
  if (b <= 0 || b > 65535 || c_in <= 0 || c_out <= 0 || c_out > c_in ||
      h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h * w + kThreads - 1) / kThreads, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (interpolation == kNearest) {
    warp_homography_kernel<kNearest><<<grid, kThreads, 0, s>>>(
        src, Ms, dst, c_in, c_out, h, w);
  } else if (interpolation == kBilinear) {
    warp_homography_kernel<kBilinear><<<grid, kThreads, 0, s>>>(
        src, Ms, dst, c_in, c_out, h, w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ursonet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
