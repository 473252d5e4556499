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
//   quant_s8, three modes over one reduction / elementwise scheme:
//     'x'        per sample n: amax = max|x[n]|, scale = max(amax, 1e-12)
//                / 127 (rounded to bf16 for a bf16 x, as JAX divides in
//                bf16), q = clip(rint(f32(x) / scale), +-127).
//     'g'        G = f32(g) * scale[n], sg = max(max|G|, 1e-30) / 127 over
//                the whole tensor, qg = clip(rint(G / sg), +-127), written
//                transposed as the [Co, Kp] A operand of the wgrad GEMM
//                (column k = n * Ho * Wo + p, zero for k >= N * Ho * Wo);
//                sg is also written `alpha_len` times, the GEMM
//                epilogue's alpha.
//     'dequant'  T(q) * T(scale[n]) in the compute type T.
//     The two reductions are a launch of their own each ('x': one slot a
//     sample; 'g': one slot), so that the caller can all-reduce the g
//     slot over the data-parallel ranks before the quantize launch.
//   wgrad_s8's gather: the int8 patch matrix P[ci * KH * KW + dy * KW +
//     dx, k] = q[n, ci, oh * s + dy - pt, ow * s + dx - pl] (0 outside),
//     k = n * Ho * Wo + oh * Wo + ow, rows padded with zeros to Kp (a
//     multiple of 16). The product dw[co, r] = sum_k qg[co, k] * P[r, k]
//     is gemm_s8's (int8_gemm.cu), with its f32 epilogue alpha = sg,
//     beta = 0: the rounding of JAX's f32(acc) * sg.
//
// Bound. All of them move bytes and do a few operations a byte: the
// reductions read the tensor once, the quantizes read it again and write
// a byte an element, the gather writes KH * KW / s^2 bytes a saved byte.
// So each thread moves 16 bytes where the layout allows (vector loads of
// 8 bf16 or 4 f32, 16-byte stores of the gather and the g-quantize), the
// reductions combine in registers, then through the warp, then through
// shared memory, and each block adds one atomicMax on the float's bits
// (non-negative floats order as their bit patterns).
//
// Rounding: rintf (round half to even, jnp.round's rule) and a true
// division by the scale (not a multiply by its reciprocal); nvcc runs
// with -fmad=false, so no multiply is contracted into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V consecutive elements of x starting at element i, as floats; `vec`
// loads them as one 16-byte (V * sizeof(T) == 16) or scalar loads.
template <class T, int V>
__device__ __forceinline__ void load(const T* x, long long i, float* out) {
  if constexpr (V == 1) {
    out[0] = to_f32(x[i]);
  } else {
    static_assert(V * sizeof(T) == 16, "16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(x + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(e[j]);
  }
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

// The block's max of `v` into *slot by atomicMax on the bits (v >= 0 or
// NaN: a NaN's bits order above +inf, so a NaN is kept as the max).
__device__ __forceinline__ void block_max_to(float v, unsigned* slot) {
  __shared__ float part[kThreads / 32];
  v = warp_max(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) part[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < kThreads / 32 ? part[lane] : 0.0f;
    v = warp_max(v);
    if (lane == 0) atomicMax(slot, __float_as_uint(v));
  }
}

// Reduction. grid (blocks per sample, N); sample n's `per` elements.
// per_sample: slot n, value |x|; else slot 0, value |f32(x) * scale[n]|.
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, const float* __restrict__ scale,
            long long per, unsigned* __restrict__ amax, int per_sample) {
  const int n = blockIdx.y;
  const T* xs = x + static_cast<long long>(n) * per;
  const float s = per_sample ? 1.0f : scale[n];
  float m = 0.0f;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * V;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * V;
       i < per; i += step) {
    float v[V];
    load<T, V>(xs, i, v);
#pragma unroll
    for (int j = 0; j < V; ++j)
      m = absmax(m, per_sample ? fabsf(v[j]) : fabsf(v[j] * s));
  }
  block_max_to(m, amax + (per_sample ? n : 0));
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

__device__ __forceinline__ int8_t quant(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// Mode 'x' quantize. grid (blocks per sample, N).
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
quant_x_kernel(const T* __restrict__ x, const unsigned* __restrict__ amax,
               long long per, int8_t* __restrict__ q,
               float* __restrict__ scale) {
  const int n = blockIdx.y;
  const float sc = x_scale<T>(amax[n]);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[n] = sc;
  const long long base = static_cast<long long>(n) * per;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * V;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * V;
       i < per; i += step) {
    float v[V];
    load<T, V>(x + base, i, v);
    if constexpr (V == 1) {
      q[base + i] = quant(v[0], sc);
    } else {
      alignas(8) int8_t o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = quant(v[j], sc);
      if constexpr (V == 8) {
        *reinterpret_cast<uint2*>(q + base + i) =
            *reinterpret_cast<const uint2*>(o);
      } else {
        *reinterpret_cast<uint32_t*>(q + base + i) =
            *reinterpret_cast<const uint32_t*>(o);
      }
    }
  }
}

// Mode 'g' quantize, written transposed: qgt[c, k] for k < kp, 16 bytes
// (columns k0 .. k0 + 15 of one row) a thread. g is [N, Co, HW].
template <class T>
__global__ void __launch_bounds__(kThreads)
quant_g_kernel(const T* __restrict__ g, const float* __restrict__ scale,
               const unsigned* __restrict__ amax, int n, int co, int hw,
               int kp, int8_t* __restrict__ qgt, float* __restrict__ alpha,
               int alpha_len) {
  const float a = __uint_as_float(*amax);
  const float sg = __fdiv_rn(a != a ? a : fmaxf(a, 1e-30f), 127.0f);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t < alpha_len) alpha[t] = sg;
  const long long chunks = static_cast<long long>(co) * (kp / 16);
  if (t >= chunks) return;
  const int c = static_cast<int>(t / (kp / 16));
  const int k0 = static_cast<int>(t % (kp / 16)) * 16;
  const int kvalid = n * hw;
  int s = k0 / hw, p = k0 % hw;
  alignas(16) int8_t o[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int8_t v = 0;
    if (k0 + j < kvalid) {
      const float G = to_f32(g[(static_cast<long long>(s) * co + c) * hw + p]) *
                      scale[s];
      v = quant(G, sg);
    }
    o[j] = v;
    if (++p == hw) {
      p = 0;
      ++s;
    }
  }
  *reinterpret_cast<uint4*>(qgt + static_cast<long long>(c) * kp + k0) =
      *reinterpret_cast<const uint4*>(o);
}

// Mode 'dequant': out = T(q) * T(scale[n]) in T. grid (blocks per
// sample, N), V elements a thread (V == 8 where per % 8 == 0).
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               long long per, T* __restrict__ out) {
  const int n = blockIdx.y;
  const long long base = static_cast<long long>(n) * per;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * V;
  float s = scale[n];
  if constexpr (sizeof(T) == 2) s = round_bf16(s);
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * V;
       i < per; i += step) {
    alignas(8) int8_t v[V];
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(v) =
          *reinterpret_cast<const uint2*>(q + base + i);
    } else {
      v[0] = q[base + i];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float r = static_cast<float>(v[j]) * s;
      if constexpr (sizeof(T) == 2) {
        out[base + i + j] = __float2bfloat16_rn(r);
      } else {
        out[base + i + j] = r;
      }
    }
  }
}

// The gather of wgrad_s8: P [C * KH * KW, kp] from q [N, C, H, W], 16
// bytes a thread.
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const int8_t* __restrict__ q, int n, int c, int h, int w,
              int kh, int kw, int stride, int pt, int pl, int ho, int wo,
              int kp, int8_t* __restrict__ p) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long rows = static_cast<long long>(c) * kh * kw;
  if (t >= rows * (kp / 16)) return;
  const int r = static_cast<int>(t / (kp / 16));
  const int k0 = static_cast<int>(t % (kp / 16)) * 16;
  const int ci = r / (kh * kw), tap = r % (kh * kw);
  const int dy = tap / kw, dx = tap % kw;
  const int hw = ho * wo, kvalid = n * hw;
  int s = k0 / hw, rem = k0 % hw;
  int oh = rem / wo, ow = rem % wo;
  alignas(16) int8_t o[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int8_t v = 0;
    if (k0 + j < kvalid) {
      const int ih = oh * stride + dy - pt, iw = ow * stride + dx - pl;
      if (ih >= 0 && ih < h && iw >= 0 && iw < w)
        v = q[((static_cast<long long>(s) * c + ci) * h + ih) * w + iw];
    }
    o[j] = v;
    if (++ow == wo) {
      ow = 0;
      if (++oh == ho) {
        oh = 0;
        ++s;
      }
    }
  }
  *reinterpret_cast<uint4*>(p + static_cast<long long>(r) * kp + k0) =
      *reinterpret_cast<const uint4*>(o);
}

// Blocks a sample for `per` elements at V a thread: four passes of the
// block's threads each, at most 4096 (the grid-stride loop takes the
// rest).
unsigned blocks_per_sample(long long per, int v) {
  const long long want = (per + static_cast<long long>(kThreads) * v * 4 - 1) /
                         (static_cast<long long>(kThreads) * v * 4);
  return static_cast<unsigned>(want < 1 ? 1 : (want > 4096 ? 4096 : want));
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <class T>
int launch_amax(const void* x, const float* scale, int n, long long per,
                unsigned* amax, int per_sample, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  if (per % V == 0 && aligned16(x)) {
    amax_kernel<T, V><<<dim3(blocks_per_sample(per, V), n), kThreads, 0,
                        st>>>(xt, scale, per, amax, per_sample);
  } else {
    amax_kernel<T, 1><<<dim3(blocks_per_sample(per, 1), n), kThreads, 0,
                        st>>>(xt, scale, per, amax, per_sample);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_quant_x(const void* x, const unsigned* amax, int n, long long per,
                   int8_t* q, float* scale, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  if (per % V == 0 && aligned16(x) && aligned16(q)) {
    quant_x_kernel<T, V><<<dim3(blocks_per_sample(per, V), n), kThreads, 0,
                           st>>>(xt, amax, per, q, scale);
  } else {
    quant_x_kernel<T, 1><<<dim3(blocks_per_sample(per, 1), n), kThreads, 0,
                           st>>>(xt, amax, per, q, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take).

extern "C" int ursonet_actq_amax(const void* x, int dtype, const float* scale,
                                 int n, long long per, unsigned* amax,
                                 int per_sample, void* stream) {
  if (n <= 0 || n > 65535 || per <= 0 || (!per_sample && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_amax<float>(x, scale, n, per, amax, per_sample, st);
  if (dtype == kDtypeBf16)
    return launch_amax<__nv_bfloat16>(x, scale, n, per, amax, per_sample, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ursonet_actq_quant_x(const void* x, int dtype,
                                    const unsigned* amax, int n,
                                    long long per, int8_t* q, float* scale,
                                    void* stream) {
  if (n <= 0 || n > 65535 || per <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_quant_x<float>(x, amax, n, per, q, scale, st);
  if (dtype == kDtypeBf16)
    return launch_quant_x<__nv_bfloat16>(x, amax, n, per, q, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ursonet_actq_quant_g(const void* g, int dtype,
                                    const float* scale, const unsigned* amax,
                                    int n, int co, int hw, int kp,
                                    int8_t* qgt, float* alpha, int alpha_len,
                                    void* stream) {
  if (n <= 0 || co <= 0 || hw <= 0 || kp <= 0 || kp % 16 != 0 ||
      static_cast<long long>(n) * hw > kp || alpha_len < 0 ||
      !aligned16(qgt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long chunks = static_cast<long long>(co) * (kp / 16);
  if (chunks < alpha_len) chunks = alpha_len;
  if (dtype == kDtypeF32) {
    quant_g_kernel<float><<<blocks_for(chunks), kThreads, 0, st>>>(
        static_cast<const float*>(g), scale, amax, n, co, hw, kp, qgt, alpha,
        alpha_len);
  } else if (dtype == kDtypeBf16) {
    quant_g_kernel<__nv_bfloat16><<<blocks_for(chunks), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), scale, amax, n, co, hw, kp, qgt,
        alpha, alpha_len);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ursonet_actq_dequant(const int8_t* q, const float* scale,
                                    int n, long long per, void* out,
                                    int dtype, void* stream) {
  if (n <= 0 || n > 65535 || per <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = per % 8 == 0 && aligned16(q) && aligned16(out);
  const unsigned bps = blocks_per_sample(per, vec ? 8 : 1);
  if (dtype == kDtypeF32) {
    float* o = static_cast<float*>(out);
    if (vec) {
      dequant_kernel<float, 8><<<dim3(bps, n), kThreads, 0, st>>>(q, scale,
                                                                  per, o);
    } else {
      dequant_kernel<float, 1><<<dim3(bps, n), kThreads, 0, st>>>(q, scale,
                                                                  per, o);
    }
  } else if (dtype == kDtypeBf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec) {
      dequant_kernel<__nv_bfloat16, 8><<<dim3(bps, n), kThreads, 0, st>>>(
          q, scale, per, o);
    } else {
      dequant_kernel<__nv_bfloat16, 1><<<dim3(bps, n), kThreads, 0, st>>>(
          q, scale, per, o);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ursonet_actq_im2col(const int8_t* q, int n, int c, int h,
                                   int w, int kh, int kw, int stride, int pt,
                                   int pl, int ho, int wo, int kp, int8_t* p,
                                   void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || ho <= 0 || wo <= 0 || kp <= 0 || kp % 16 != 0 ||
      static_cast<long long>(n) * ho * wo > kp || !aligned16(p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(c) * kh * kw * (kp / 16);
  im2col_kernel<<<blocks_for(chunks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      q, n, c, h, w, kh, kw, stride, pt, pl, ho, wo, kp, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ursonet_actq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
