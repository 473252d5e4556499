// int8 GEMM with a fused epilogue for Hopper (sm_90a), bound through a
// plain C interface (ctypes; see ursonet_torch/ops/int8_cuda.py).
//
// Replaces two Pallas TPU kernels:
//   tools/probe_pallas_int8_matmul.py::_matmul_kernel  tiled s8 x s8 -> s32
//     GEMM with an s32 accumulator (the `s32` epilogue is its function);
//   tools/probe_pallas_c2.py::matmul_requant_kernel    a 1x1 conv as an s8
//     matmul with a ReLU + requant epilogue (`q8_relu`, s_out = 1).
// On the serving path it carries every 1x1 conv of the int8 ResNet-50
// (res*_branch2a, res*_branch2c with the residual join, res*a_branch1)
// and the int8 head denses (10240->1024, 1024->13824).
//
// Computes out[M, N] = epilogue(A[M, K] s8 @ B[K, N] s8), with A
// row-major and B given K-major as Bt[N, K] (the weights' output-channel
// -major layout, prepared once by the caller).
//
// Bound. The 1x1 convs move M*(K+N) bytes for 2*M*N*K operations: with
// K, N of 64..2048 that is 32..1000 operations a byte, mostly below the
// card's ~590 int8 operations a byte, so most of them are bound by
// memory; the head denses at M = 128 are bound by reading their weights.
// So the design moves bytes first. Two routes, chosen by the wrapper from
// the shapes before the launch:
//   ursonet_gemm_s8_tma  (K % 16 == 0, N * out_bytes % 16 == 0, 16-byte
//     aligned pointers: every GEMM of the served model) the persistent
//     TMA + wgmma kernel of int8_tma.cuh: A and Bt by TMA into a ring of
//     128-byte-swizzled stages that runs across tiles, Bt resident in
//     shared memory when it fits, wgmma m64nNk32 from shared memory,
//     the epilogue staged through shared memory and written by TMA
//     stores, the residual of `join` TMA-loaded ahead, and a split over
//     K for the M = 128 denses.
//   ursonet_gemm_s8      (any shape: the ragged route) mma.sync s8 tiles
//     (128x128, 128x64 or 64x64 by shape), 16-byte global loads where
//     aligned, a two-stage shared-memory pipeline, the epilogue applied
//     in registers.
// In both the s32 accumulator never reaches device memory (but as split-K
// partial sums), and blocks running together share one A row-tile so
// that A is read from device memory about once.

#include "int8_common.cuh"
#include "int8_tma.cuh"

namespace ursonet_int8 {
namespace {

template <class T, bool kExtra>
__global__ void __launch_bounds__(kThreads)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
               int M, int N, int K, int vec_a, int vec_b, int n_tiles,
               Epilogue ep) {
  __shared__ __align__(16) int8_t As[2 * T::BM * LDS];
  __shared__ __align__(16) int8_t Bs[2 * T::BN * LDS];
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * T::BN;
  const int m0 = static_cast<int>(blockIdx.x / n_tiles) * T::BM;
  const int r0 = threadIdx.x >> 2;
  auto fetch_a = [&](int p, int k) {
    return fetch_row_chunk(A, M, K, m0 + r0 + 64 * p, k, vec_a != 0);
  };
  int acc[T::MT][T::NT][4];
  mainloop<T>(fetch_a, Bt, N, K, n0, vec_b != 0, As, Bs, acc);
  finish<T, kExtra>(ep, M, N, m0, n0, acc);
}

template <class T>
cudaError_t launch(const int8_t* A, const int8_t* Bt, int M, int N, int K,
                   int vec_a, int vec_b, const Epilogue& ep,
                   cudaStream_t stream) {
  const long long n_tiles = (N + T::BN - 1) / T::BN;
  const long long blocks = (M + T::BM - 1) / T::BM * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  // the modes of epilogue_extra in an instantiation of their own
  if (extra_mode(ep.mode, ep.res_type)) {
    gemm_s8_kernel<T, true><<<nb, kThreads, 0, stream>>>(
        A, Bt, M, N, K, vec_a, vec_b, static_cast<int>(n_tiles), ep);
  } else {
    gemm_s8_kernel<T, false><<<nb, kThreads, 0, stream>>>(
        A, Bt, M, N, K, vec_a, vec_b, static_cast<int>(n_tiles), ep);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ursonet_int8

extern "C" int ursonet_gemm_s8(const void* A, const void* Bt, int M, int N,
                               int K, int vec_a, int vec_b, int mode,
                               int bf16, const void* alpha, const void* beta,
                               float inv_s_out, const void* res, int res_type,
                               float res_scale, void* out, int tile,
                               int device, void* stream) {
  using namespace ursonet_int8;
  const Epilogue ep{mode, static_cast<const float*>(alpha),
                    static_cast<const float*>(beta), inv_s_out,
                    res, res_type, res_scale, out, bf16 != 0 ? 1 : 0};
  if (M <= 0 || N <= 0 || K <= 0 || A == nullptr || Bt == nullptr ||
      !epilogue_ok(ep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: err = launch<TileLarge>(a, b, M, N, K, vec_a, vec_b, ep, s); break;
    case 1: err = launch<TileNarrow>(a, b, M, N, K, vec_a, vec_b, ep, s); break;
    case 2: err = launch<TileSmall>(a, b, M, N, K, vec_a, vec_b, ep, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int ursonet_gemm_s8_tma(const void* A, const void* Bt, int M,
                                   int N, int K, int mode, int bf16,
                                   const void* alpha, const void* beta,
                                   float inv_s_out, const void* res,
                                   int res_type, float res_scale, void* out,
                                   int bn, int stages, int bufs,
                                   int resident, int splits, void* partial,
                                   void* counters, int grid, int device,
                                   void* stream) {
  using namespace ursonet_int8;
  const Epilogue ep{mode, static_cast<const float*>(alpha),
                    static_cast<const float*>(beta), inv_s_out,
                    res, res_type, res_scale, out, bf16 != 0 ? 1 : 0};
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || A == nullptr ||
      Bt == nullptr || !epilogue_ok(ep) || bn <= 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  tma::Params p{};
  p.M = M, p.N = N, p.K = K;
  p.n_tiles = (N + bn - 1) / bn;
  p.ksteps = (K + tma::kBK - 1) / tma::kBK;
  p.splits = splits;
  const long long items = static_cast<long long>((M + tma::kBM - 1) /
                                                 tma::kBM) * p.n_tiles * splits;
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
  p.partial = static_cast<int32_t*>(partial);
  p.counters = static_cast<int*>(counters);
  err = tma::launch_bn<false>(bn, static_cast<const int8_t*>(A),
                              static_cast<const int8_t*>(Bt), ep.res, out, p,
                              grid, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* ursonet_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
