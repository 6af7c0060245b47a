// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel in csrc/ has a plain C entry point (extern "C") that takes
// raw pointers, sizes, dtype codes and the caller's cudaStream_t as void*,
// launches, and returns cudaGetLastError(); paddle_tpu_torch/kernels/
// _build.py binds them with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

// dtype codes, shared with paddle_tpu_torch/kernels/_build.py DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kF16 = 3 };

// the (batch, seq, head) strides of a [batch, seq, heads, d] tensor, in
// elements
struct Strides {
  long long b, s, h;  // elements
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) {
  return __half2float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  // round to nearest even, as torch's .to(torch.bfloat16)
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  // round to nearest even; past the fp16 range inf, as torch's
  // .to(torch.float16)
  return __float2half_rn(v);
}

// Load N consecutive elements of T starting at p (aligned to N*sizeof(T)
// bytes, at most 16) as floats, in 16-, 8- or 4-byte transactions (an
// int8 element becomes its exact integer value).
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* __restrict__ p,
                                            float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[c * kPer + j] = to_float(v[j]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_float(v[j]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_float(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_float(p[j]);
  }
}

// Store N floats as consecutive elements of T at p (16-byte vectors when
// N*sizeof(T) is a multiple of 16).
template <typename T, int N>
__device__ __forceinline__ void store_floats(T* __restrict__ p,
                                             const float (&in)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      uint4 raw;
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = from_float<T>(in[c * kPer + j]);
      reinterpret_cast<uint4*>(p)[c] = raw;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = from_float<T>(in[j]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the whole block, returned to every thread. `scratch`
// holds at least 32 floats of shared memory; blockDim.x is a multiple of
// 32. Begins with a barrier so that scratch may be reused back to back.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : (kMax ? -INFINITY : 0.0f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace ptt
