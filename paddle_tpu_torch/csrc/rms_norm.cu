// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/rms_norm.py rms_norm_fused -> _rms_fwd
// (pl.pallas_call at :45, body _fwd_kernel at :34) and _rms_bwd
// (pl.pallas_call at :93, body _bwd_kernel at :68).
//   forward:  rstd = rsqrt(mean(x^2) + eps)
//             y = (x * rstd) * w, in fp32, cast once to x's type
//   backward: dx = rstd * g*w - x * rstd^3 * mean(g*w*x)  (fp32, one cast)
//             dw = sum over rows of g * (x * rstd)        (fp32)
// x, w, y, g and dx are fp32, bf16 or fp16 (one type a call); rstd and
// the dw partials stay fp32 in every type, and y, dx and dw are rounded
// once (an fp16 value past 65504 becomes inf, as a cast does).
// The weight is multiplied in fp32 before the single cast, as the TPU
// kernel does at rms_norm.py:38; the forward also writes the fp32 rstd
// (one per row) that the backward reads, as _fwd_kernel does at :39.
//
// What bounds it on the H100: bytes. The forward reads x once (twice from
// the SM's point of view: the second pass hits L1/L2) and writes y; the
// backward reads x and g and writes dx. A few flops per element, far
// below the ~295 flop/byte ridge. At decode (8 rows) the launch dominates.
//
// Design: one CTA per row in the forward; every thread moves 16-byte
// vectors (8 bf16 or fp16, or 4 fp32), so a warp touches 512 contiguous
// bytes per load. Sums are kept in fp32, reduced through warp shuffles and one
// shared 32-float scratch. The block has ceil(H / vector) threads (a
// multiple of 32, at most 1024), so for Llama widths each thread owns one
// vector.
//
// The TPU backward accumulates dw across its sequential grid in one
// resident block. Here CTAs run in parallel and in no order, so dw is
// reduced deterministically in two passes with no float atomics: every
// CTA of the first pass owns a fixed run of rows and writes its fp32
// column sums to partials[cta, :]; the second pass sums the partials of
// each column in CTA order and casts once to w's type. The split depends
// only on the row count, so the result repeats bit for bit.
#include "common.cuh"

namespace {

// vectors per thread the backward keeps dw partials for (in registers)
constexpr int kMaxVecPerThread = 2;

template <typename T>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    T* __restrict__ y,
                                    float* __restrict__ rstd_out, int hidden,
                                    float eps) {
  constexpr int V = 16 / (int)sizeof(T);
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * hidden;
  const T* xr = x + base;
  T* yr = y + base;

  float ss = 0.0f;
  for (int i = threadIdx.x * V; i < hidden; i += blockDim.x * V) {
    float v[V];
    ptt::load_floats<T, V>(xr + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss += v[j] * v[j];
  }
  ss = ptt::block_reduce<false>(ss, scratch);
  const float rstd = rsqrtf(ss / (float)hidden + eps);
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;

  for (int i = threadIdx.x * V; i < hidden; i += blockDim.x * V) {
    float v[V], wv[V], o[V];
    ptt::load_floats<T, V>(xr + i, v);
    ptt::load_floats<T, V>(w + i, wv);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = __fmul_rn(__fmul_rn(v[j], rstd), wv[j]);
    ptt::store_floats<T, V>(yr + i, o);
  }
}

// First backward pass: CTA c owns rows [c * rows_per_cta, ...). Each row
// gets its dx; the CTA's fp32 sums of g * (x * rstd) per column go to
// partials[c, :]. A row is read twice (the sum of g*w*x, then dx); the
// second read hits L1/L2. Only the dw sums live in registers across rows.
template <typename T>
__global__ void __launch_bounds__(1024)
    rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ g,
                        const float* __restrict__ rstd, T* __restrict__ dx,
                        float* __restrict__ partials, int rows, int hidden,
                        int rows_per_cta) {
  constexpr int V = 16 / (int)sizeof(T);
  __shared__ float scratch[32];
  const int row0 = blockIdx.x * rows_per_cta;
  const int row1 = min(rows, row0 + rows_per_cta);

  float acc[kMaxVecPerThread][V];
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.0f;

  for (int r = row0; r < row1; ++r) {
    const size_t base = (size_t)r * hidden;
    const float rs = rstd[r];
    float part = 0.0f;  // this thread's share of sum(g*w*x)
#pragma unroll
    for (int k = 0; k < kMaxVecPerThread; ++k) {
      const int i = (threadIdx.x + k * blockDim.x) * V;
      if (i < hidden) {
        float xv[V], gv[V], wv[V];
        ptt::load_floats<T, V>(x + base + i, xv);
        ptt::load_floats<T, V>(g + base + i, gv);
        ptt::load_floats<T, V>(w + i, wv);
#pragma unroll
        for (int j = 0; j < V; ++j)
          part += __fmul_rn(__fmul_rn(gv[j], wv[j]), xv[j]);
      }
    }
    const float m = ptt::block_reduce<false>(part, scratch) / (float)hidden;
    const float rs3 = __fmul_rn(__fmul_rn(rs, rs), rs);
#pragma unroll
    for (int k = 0; k < kMaxVecPerThread; ++k) {
      const int i = (threadIdx.x + k * blockDim.x) * V;
      if (i < hidden) {
        float xv[V], gv[V], wv[V], o[V];
        ptt::load_floats<T, V>(x + base + i, xv);
        ptt::load_floats<T, V>(g + base + i, gv);
        ptt::load_floats<T, V>(w + i, wv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gw = __fmul_rn(gv[j], wv[j]);
          o[j] = __fsub_rn(__fmul_rn(rs, gw),
                           __fmul_rn(__fmul_rn(xv[j], rs3), m));
          acc[k][j] += __fmul_rn(gv[j], __fmul_rn(xv[j], rs));
        }
        ptt::store_floats<T, V>(dx + base + i, o);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int i = (threadIdx.x + k * blockDim.x) * V;
    if (i < hidden)
      ptt::store_floats<float, V>(partials + (size_t)blockIdx.x * hidden + i,
                                  acc[k]);
  }
}

// Second backward pass: dw[col] = sum over CTAs, in CTA order.
template <typename W>
__global__ void rms_norm_dw_kernel(const float* __restrict__ partials,
                                   W* __restrict__ dw, int ctas, int hidden) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= hidden) return;
  float s = 0.0f;
  for (int c = 0; c < ctas; ++c) s += partials[(size_t)c * hidden + col];
  dw[col] = ptt::from_float<W>(s);
}

template <typename T>
int threads_for(int hidden) {
  constexpr int V = 16 / (int)sizeof(T);
  int threads = ((hidden / V + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* y, void* rstd,
                       int rows, int hidden, float eps, cudaStream_t stream) {
  rms_norm_fwd_kernel<T><<<rows, threads_for<T>(hidden), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<float*>(rstd), hidden, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* g,
                       const void* rstd, void* dx, void* dw, void* partials,
                       int rows, int hidden, int ctas, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const int threads = threads_for<T>(hidden);
  if (hidden > threads * V * kMaxVecPerThread) return cudaErrorInvalidValue;
  const int per = (rows + ctas - 1) / ctas;
  rms_norm_bwd_kernel<T><<<ctas, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(partials), rows, hidden, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_dw_kernel<T><<<(hidden + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<T*>(dw), ctas, hidden);
  return cudaGetLastError();
}

}  // namespace

// x, y: [rows, hidden] and w: [hidden], one dtype, contiguous, 16-byte
// aligned, hidden a multiple of the 16-byte vector width (the Python
// wrapper checks). rstd: null, or fp32 [rows] written by the kernel.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y,
                                void* rstd, int rows, int hidden, int dtype,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (dtype == ptt::kF32)
    return launch_fwd<float>(x, w, y, rstd, rows, hidden, eps, s);
  if (dtype == ptt::kBF16)
    return launch_fwd<__nv_bfloat16>(x, w, y, rstd, rows, hidden, eps, s);
  if (dtype == ptt::kF16)
    return launch_fwd<__half>(x, w, y, rstd, rows, hidden, eps, s);
  return cudaErrorInvalidValue;
}

// x, g, dx: [rows, hidden]; w, dw: [hidden]; all of one dtype, contiguous,
// 16-byte aligned. rstd: fp32 [rows] from the forward. partials: fp32
// scratch of [ctas, hidden], ctas in [1, rows] (the wrapper picks it).
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w, const void* g,
                                const void* rstd, void* dx, void* dw,
                                void* partials, int rows, int hidden,
                                int ctas, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || ctas < 1) return cudaErrorInvalidValue;
  if (dtype == ptt::kF32)
    return launch_bwd<float>(x, w, g, rstd, dx, dw, partials, rows, hidden,
                             ctas, s);
  if (dtype == ptt::kBF16)
    return launch_bwd<__nv_bfloat16>(x, w, g, rstd, dx, dw, partials, rows,
                                     hidden, ctas, s);
  if (dtype == ptt::kF16)
    return launch_bwd<__half>(x, w, g, rstd, dx, dw, partials, rows, hidden,
                              ctas, s);
  return cudaErrorInvalidValue;
}
