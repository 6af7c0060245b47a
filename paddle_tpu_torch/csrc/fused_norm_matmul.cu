// Fused RMSNorm + matmul for Hopper (sm_90a):
//   out[rows, N] = (rms_norm(x, w) rounded to x's dtype) @ wm[K, N],
//   fp32 sums, cast once to x's dtype (x and wm share one dtype).
//
// Replaces: paddle_tpu/kernels/fused_norm_matmul.py rms_norm_matmul
// (:111; pl.pallas_call at :55 over _fused_kernel :45 and _normed_rows
// :35): every row's rstd is taken over the whole hidden size in fp32,
// y = ((x * rstd) * w) is rounded to x's dtype before any product
// (_normed_rows :42), and the normalized tensor never goes to device
// memory. The backward is autograd through the plain version (the JAX
// _bwd is the VJP of _composed_2d), so there is no backward kernel.
//
// What bounds it on the H100: at the decode step (rows <= 16, the head
// [8, 4096] x [4096, 32000]) bytes, the weight read once; at prefill and
// in training (hundreds to thousands of rows) operations. Both kernels
// below run on the CUDA cores in fp32 (67 TFLOP/s, not the tensor cores'
// 989), so at prefill the operation rate keeps them far above their
// bf16 bound; tensor cores (mma/wgmma) are the redesign's work.
//
// Two kernels, chosen by the row count, as the W8A16 matmul does:
// - narrow (rows <= 16): a CTA owns 128 columns and one chunk of at most
//   kchunk K rows (split-K). Its prologue takes the rstd of every row
//   over the whole K (a warp per row, 16-byte vectors, from L2 after the
//   first CTA), then stages its chunk of y = round((x * rstd) * w) in
//   shared memory as fp32 [k][row]. Each lane owns 4 columns and keeps
//   two groups of kUnroll weight loads in flight (the next group's are
//   issued before the current group is used); the 8 warps take
//   interleaved K rows and are summed through shared memory in warp
//   order. With more than one chunk each chunk writes fp32 partials and
//   a second kernel sums them in chunk order and casts: no atomics, so a
//   result repeats bit for bit;
// - wide (rows > 16): a 128 x 128 output tile per CTA of 256 threads.
//   The prologue takes the rstd of the CTA's 128 rows over the whole K
//   (each CTA recomputes its row block's norm, as the TPU kernel does per
//   column block); then K in steps of 16, y and the weight staged in
//   shared memory as fp32 (double-buffered, the next step's global loads
//   held raw in registers during the current step's products), each
//   thread an 8 x 8 register tile of fp32 FMAs.
#include "common.cuh"

namespace {

// N raw elements of T, loaded as 16-byte vectors (N * sizeof(T) is a
// multiple of 16) and converted to fp32 only when used, so that the load
// latency hides behind other work
template <typename T, int N>
struct Raw {
  static constexpr int kVecs = N * (int)sizeof(T) / 16;
  uint4 v[kVecs];
  __device__ __forceinline__ void load(const T* __restrict__ p) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) v[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void to_floats(float (&out)[N]) const {
    const T* e = reinterpret_cast<const T*>(v);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = ptt::to_float(e[j]);
  }
};

// the 4 raw weights of a lane's columns: 8 bytes in bf16, 16 in fp32
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  uint4 v;
  __device__ __forceinline__ void load(const float* __restrict__ p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void to_floats(float (&out)[4]) const {
    out[0] = __uint_as_float(v.x), out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z), out[3] = __uint_as_float(v.w);
  }
};
template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ void to_floats(float (&out)[4]) const {
    // a bf16 is the high half of its fp32 value
    out[0] = __uint_as_float(v.x << 16), out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16), out[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

// _normed_rows' op order: (x * rstd) * w in fp32, rounded to x's dtype
template <typename TX>
__device__ __forceinline__ float normed(float x, float rstd, float w) {
  return ptt::to_float(ptt::from_float<TX>(__fmul_rn(__fmul_rn(x, rstd), w)));
}

// rsqrt(mean(x^2) + eps) of one row of K elements, by one warp (16-byte
// vectors; K is a multiple of the vector width), returned to every lane
template <typename TX>
__device__ __forceinline__ float row_rstd(const TX* __restrict__ xr, int K,
                                          float eps) {
  constexpr int V = 16 / (int)sizeof(TX);
  const int lane = threadIdx.x & 31;
  float ss = 0.0f;
  for (int i = lane * V; i < K; i += 32 * V) {
    float v[V];
    ptt::load_floats<TX, V>(xr + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
  }
  ss = ptt::warp_sum(ss);
  return rsqrtf(ss / (float)K + eps);
}

// ---------------------------------------------------------------- narrow
constexpr int kNarrowThreads = 256;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowCols = 128;  // 32 lanes x 4 columns
constexpr int kUnroll = 8;        // K rows whose loads a warp issues at once

template <typename TX, typename TW, int MAXR>
__global__ void __launch_bounds__(kNarrowThreads)
    norm_matmul_narrow_kernel(const TX* __restrict__ x,
                              const TW* __restrict__ w,
                              const TX* __restrict__ wm, TX* __restrict__ out,
                              float* __restrict__ partial, int rows, int K,
                              int N, int kchunk, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;                      // [kchunk][MAXR] fp32 y^T
  float* red = smem + kchunk * MAXR;     // [warps][4][kNarrowCols]
  float* rstd_s = red + kNarrowWarps * 4 * kNarrowCols;  // [MAXR]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = blockIdx.x * kNarrowCols + lane * 4;
  const int k0 = blockIdx.y * kchunk;
  const int kn = min(kchunk, K - k0);
  const bool col_ok = col < N;  // N % 4 == 0: a lane's 4 columns all in

  // this warp's K rows, kUnroll at a time: kb, kb + 8, ..., kb + 56
  const TX* wcol = wm + (size_t)k0 * N + (col_ok ? col : 0);
  auto load = [&](int kb, Raw4<TX>(&raw)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * kNarrowWarps;
      if (k < kn && col_ok)
        raw[u].load(wcol + (size_t)k * N);
      else
        raw[u].zero();
    }
  };
  constexpr int kStride = kNarrowWarps * kUnroll;
  // the first group's weight loads are in flight during the prologue
  Raw4<TX> cur[kUnroll], nxt[kUnroll];
  load(warp, cur);

  for (int r = warp; r < rows; r += kNarrowWarps) {
    const float rs = row_rstd<TX>(x + (size_t)r * K, K, eps);
    if (lane == 0) rstd_s[r] = rs;
  }
  __syncthreads();
  for (int i = tid; i < MAXR * kn; i += kNarrowThreads) {
    const int r = i / kn;
    const int k = i - r * kn;
    ys[k * MAXR + r] =
        r < rows ? normed<TX>(ptt::to_float(x[(size_t)r * K + k0 + k]),
                              rstd_s[r], ptt::to_float(w[k0 + k]))
                 : 0.0f;
  }
  __syncthreads();

  float acc[MAXR][4];
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  for (int kb = warp; kb < kn; kb += kStride) {
    // the next group's loads are issued before this group is used
    load(kb + kStride, nxt);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * kNarrowWarps;
      if (k >= kn) break;  // warp-uniform
      float wv[4];
      cur[u].to_floats(wv);
      const float4* yv = reinterpret_cast<const float4*>(ys + k * MAXR);
#pragma unroll
      for (int r4 = 0; r4 < MAXR / 4; ++r4) {
        const float4 yy = yv[r4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[4 * r4 + 0][j] = fmaf(yy.x, wv[j], acc[4 * r4 + 0][j]);
          acc[4 * r4 + 1][j] = fmaf(yy.y, wv[j], acc[4 * r4 + 1][j]);
          acc[4 * r4 + 2][j] = fmaf(yy.z, wv[j], acc[4 * r4 + 2][j]);
          acc[4 * r4 + 3][j] = fmaf(yy.w, wv[j], acc[4 * r4 + 3][j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }

  // sum the warps' partial rows in warp order, 4 rows at a time
  const bool direct = gridDim.y == 1;
  const int col0 = blockIdx.x * kNarrowCols;
#pragma unroll
  for (int r4 = 0; r4 < MAXR / 4; ++r4) {
    if (4 * r4 >= rows) break;  // block-uniform
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(red + (warp * 4 + i) * kNarrowCols +
                                 lane * 4) =
          make_float4(acc[4 * r4 + i][0], acc[4 * r4 + i][1],
                      acc[4 * r4 + i][2], acc[4 * r4 + i][3]);
    __syncthreads();
    for (int o = tid; o < 4 * kNarrowCols; o += kNarrowThreads) {
      const int i = o / kNarrowCols;
      const int c = o - i * kNarrowCols;
      const int r = 4 * r4 + i;
      if (r >= rows || col0 + c >= N) continue;
      float v = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kNarrowWarps; ++wp)
        v += red[(wp * 4 + i) * kNarrowCols + c];
      if (direct)
        out[(size_t)r * N + col0 + c] = ptt::from_float<TX>(v);
      else
        partial[((size_t)blockIdx.y * rows + r) * N + col0 + c] = v;
    }
  }
}

// out[i] = sum over chunks p (in order) of partial[p][i], cast to TX
template <typename TX>
__global__ void norm_matmul_split_sum_kernel(const float* __restrict__ partial,
                                             TX* __restrict__ out, int chunks,
                                             int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.0f;
  for (int p = 0; p < chunks; ++p) v += partial[(size_t)p * count + i];
  out[i] = ptt::from_float<TX>(v);
}

// ------------------------------------------------------------------ wide
constexpr int kTile = 128;
constexpr int kStep = 16;
constexpr int kWideThreads = 256;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kWideThreads)
    norm_matmul_wide_kernel(const TX* __restrict__ x,
                            const TW* __restrict__ w,
                            const TX* __restrict__ wm, TX* __restrict__ out,
                            int rows, int K, int N, float eps) {
  __shared__ __align__(16) float ys[2][kStep][kTile];  // y^T
  __shared__ __align__(16) float ws[2][kStep][kTile];  // wm
  __shared__ float rstd_s[kTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  // loaders: x row (tid % 128) at K offset (tid / 128) * 8; wm K row
  // tid / 16 at columns (tid % 16) * 8
  const int xr = tid & (kTile - 1);
  const int xk = (tid >> 7) * 8;
  const int wk = tid >> 4;
  const int wc = (tid & 15) * 8;
  const bool xrow_ok = row0 + xr < rows;
  const bool wcol_ok = col0 + wc < N;  // N % 8 == 0: all 8 in or out
  // compute: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and
  // 64 + tx*4 + j (two 4-wide halves keep the shared loads conflict-free)
  const int tx = tid & 15;
  const int ty = tid >> 4;

  Raw<TX, 8> xraw, wraw;
  Raw<TW, 8> nraw;  // the norm weight of the loader's 8 K rows
  auto load = [&](int k0) {
    const bool xk_ok = k0 + xk < K;  // K % 8 == 0: all 8 in or out
    if (xrow_ok && xk_ok)
      xraw.load(x + (size_t)(row0 + xr) * K + k0 + xk);
    else
      xraw.zero();
    if (xk_ok)
      nraw.load(w + k0 + xk);
    else
      nraw.zero();
    if (wcol_ok && k0 + wk < K)
      wraw.load(wm + (size_t)(k0 + wk) * N + col0 + wc);
    else
      wraw.zero();
  };
  auto store = [&](int buf) {
    float xv[8], nv[8], wv[8];
    xraw.to_floats(xv);
    nraw.to_floats(nv);
    wraw.to_floats(wv);
    const float rs = rstd_s[xr];
#pragma unroll
    for (int j = 0; j < 8; ++j) ys[buf][xk + j][xr] = normed<TX>(xv[j], rs, nv[j]);
    float4* dst = reinterpret_cast<float4*>(&ws[buf][wk][wc]);
    dst[0] = make_float4(wv[0], wv[1], wv[2], wv[3]);
    dst[1] = make_float4(wv[4], wv[5], wv[6], wv[7]);
  };

  // the first step's loads are in flight during the prologue
  load(0);
  for (int r = warp; r < kTile; r += kWideThreads / 32) {
    const float rs =
        row0 + r < rows ? row_rstd<TX>(x + (size_t)(row0 + r) * K, K, eps)
                        : 0.0f;
    if (lane == 0) rstd_s[r] = rs;
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int steps = (K + kStep - 1) / kStep;
  store(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) load((t + 1) * kStep);
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&ys[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&ys[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (c >= N) continue;  // N % 4 == 0: the 4 columns are all in
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      ptt::store_floats<TX, 4>(out + (size_t)r * N + c, v);
    }
  }
}

template <typename TX, typename TW, int MAXR>
cudaError_t launch_narrow(const void* x, const void* w, const void* wm,
                          void* out, void* partial, int rows, int K, int N,
                          int kchunk, float eps, cudaStream_t stream) {
  const int chunks = (K + kchunk - 1) / kchunk;
  const size_t smem =
      sizeof(float) * ((size_t)kchunk * MAXR +
                       (size_t)kNarrowWarps * 4 * kNarrowCols + MAXR);
  auto kernel = norm_matmul_narrow_kernel<TX, TW, MAXR>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (chunks > 1 && partial == nullptr) return cudaErrorInvalidValue;
  dim3 grid((N + kNarrowCols - 1) / kNarrowCols, chunks);
  kernel<<<grid, kNarrowThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TX*>(wm), static_cast<TX*>(out),
      static_cast<float*>(partial), rows, K, N, kchunk, eps);
  if (chunks > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int count = rows * N;
    norm_matmul_split_sum_kernel<TX><<<(count + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<TX*>(out), chunks,
        count);
  }
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const void* wm, void* out,
                   void* partial, int rows, int K, int N, int kchunk,
                   float eps, cudaStream_t stream) {
  if (rows <= 8)
    return launch_narrow<TX, TW, 8>(x, w, wm, out, partial, rows, K, N,
                                    kchunk, eps, stream);
  if (rows <= 16)
    return launch_narrow<TX, TW, 16>(x, w, wm, out, partial, rows, K, N,
                                     kchunk, eps, stream);
  dim3 grid((N + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  norm_matmul_wide_kernel<TX, TW><<<grid, kWideThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TX*>(wm), static_cast<TX*>(out), rows, K, N, eps);
  return cudaGetLastError();
}

}  // namespace

// x: [rows, K] and wm: [K, N] of x_dtype (fp32 or bf16); w: [K] of
// w_dtype (x_dtype or fp32); out: [rows, N] of x_dtype. All contiguous
// and 16-byte aligned; K and N multiples of 8 (the Python wrapper checks).
// With rows <= 16 and K > kchunk, `partial` is fp32 scratch of
// ceil(K / kchunk) * rows * N.
extern "C" int ptt_rms_norm_matmul(const void* x, const void* w,
                                   const void* wm, void* out, void* partial,
                                   int rows, int K, int N, int kchunk,
                                   int x_dtype, int w_dtype, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || N == 0) return cudaSuccess;
  if (kchunk < 8 || kchunk % 8) return cudaErrorInvalidValue;
  if (x_dtype == ptt::kBF16 && w_dtype == ptt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, wm, out, partial, rows,
                                                K, N, kchunk, eps, s);
  if (x_dtype == ptt::kBF16 && w_dtype == ptt::kF32)
    return launch<__nv_bfloat16, float>(x, w, wm, out, partial, rows, K, N,
                                        kchunk, eps, s);
  if (x_dtype == ptt::kF32 && w_dtype == ptt::kF32)
    return launch<float, float>(x, w, wm, out, partial, rows, K, N, kchunk,
                                eps, s);
  return cudaErrorInvalidValue;
}
