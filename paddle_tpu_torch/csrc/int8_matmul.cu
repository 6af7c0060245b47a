// Weight-only int8 matmul (W8A16) for Hopper (sm_90a):
//   out[rows, N] = x[rows, K] @ ((float(w_q[K, N]) * scale[N]) rounded to
//   x's dtype), fp32 sums, cast once to x's dtype.
//
// Replaces: paddle_tpu/kernels/int8_matmul.py int8_matmul (pl.pallas_call
// at :84) over _int8_kernel (:71): the int8 block is dequantized next to
// the product (_dequant's order, :63-68: int8 -> fp32 * scale -> x's
// dtype) and never exists as a wide weight in device memory.
//
// What bounds it on the H100: at the decode step (rows <= 16) bytes, the
// int8 weight read once (1 byte per weight instead of bf16's 2); at
// prefill (rows in the hundreds) operations. Both kernels below run on
// the CUDA cores in fp32 (67 TFLOP/s, not the tensor cores' 989), so at
// prefill the operation rate, and at 8 rows the instruction issue (8
// FMAs and the dequantization per weight byte), keep them above their
// bounds; tensor cores (mma/wgmma) are later work.
//
// Two kernels, chosen by the row count:
// - narrow (rows <= 16, the decode step): a CTA owns 128 columns and one
//   chunk of at most kchunk K rows (split-K, so that even N = 4096 gives
//   hundreds of CTAs). x's chunk is staged once in shared memory as fp32
//   [k][row]; each lane owns 4 columns, reads their 4 int8 codes of a K
//   row as one 32-bit load (a warp reads 128 contiguous bytes), keeps two
//   groups of kUnroll such loads going (the next group's are issued
//   before the current group is used, so load latency overlaps the
//   arithmetic), dequantizes in registers and accumulates all rows; the
//   8 warps take interleaved K rows and are summed through shared memory
//   in warp order. With more than one chunk each chunk writes fp32
//   partials and a second kernel sums them in chunk order and casts (no
//   atomics: results repeat bit for bit);
// - wide (rows > 16): a 128 x 128 output tile per CTA of 256 threads,
//   K in steps of 16, x and the dequantized weight staged in shared
//   memory as fp32 (double-buffered, the next step's global loads in
//   registers during the current step's products), each thread an 8 x 8
//   register tile of fp32 FMAs.
// Both dequantize each weight exactly once per CTA.
#include "common.cuh"

namespace {

// Four int8 codes packed in a 32-bit word -> their exact fp32 values, by
// the 2^23 trick: the code + 128 (as an unsigned byte) is placed in the
// low mantissa byte of 2^23, and 2^23 + 128 is subtracted (exact).
__device__ __forceinline__ void i8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + j)) -
           8388736.0f;
}

// _dequant: float(q) * scale, rounded to x's dtype, as fp32
template <typename TX>
__device__ __forceinline__ float dequant(float q, float s) {
  return ptt::to_float(ptt::from_float<TX>(q * s));
}

// ---------------------------------------------------------------- narrow
constexpr int kNarrowThreads = 256;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowCols = 128;  // 32 lanes x 4 columns
constexpr int kUnroll = 8;        // K rows whose loads a warp issues at once

template <typename TX, int MAXR>
__global__ void __launch_bounds__(kNarrowThreads)
    int8_matmul_narrow_kernel(const TX* __restrict__ x,
                              const int8_t* __restrict__ wq,
                              const float* __restrict__ scale,
                              TX* __restrict__ out,
                              float* __restrict__ partial, int rows, int K,
                              int N, int kchunk) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // [kchunk][MAXR] fp32 x^T
  float* red = smem + kchunk * MAXR;     // [warps][4][kNarrowCols]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = blockIdx.x * kNarrowCols + lane * 4;
  const int k0 = blockIdx.y * kchunk;
  const int kn = min(kchunk, K - k0);
  const bool col_ok = col < N;  // N % 4 == 0: a lane's 4 columns all in

  // this warp's K rows, kUnroll at a time: kb, kb + 8, ..., kb + 56
  const int8_t* wcol = wq + (size_t)k0 * N + (col_ok ? col : 0);
  auto load = [&](int kb, uint32_t(&raw)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * kNarrowWarps;
      raw[u] = (k < kn && col_ok)
                   ? __ldg(reinterpret_cast<const unsigned int*>(
                         wcol + (size_t)k * N))
                   : 0u;
    }
  };
  constexpr int kStride = kNarrowWarps * kUnroll;
  // the first group's weight loads are in flight while x is staged
  uint32_t cur[kUnroll], nxt[kUnroll];
  load(warp, cur);

  for (int i = tid; i < MAXR * kn; i += kNarrowThreads) {
    const int r = i / kn;
    const int k = i - r * kn;
    xs[k * MAXR + r] =
        r < rows ? ptt::to_float(x[(size_t)r * K + k0 + k]) : 0.0f;
  }
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (col_ok) {
    const float4 sv = *reinterpret_cast<const float4*>(scale + col);
    s[0] = sv.x, s[1] = sv.y, s[2] = sv.z, s[3] = sv.w;
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
      float w[4];
      i8x4_to_float(cur[u], w);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = dequant<TX>(w[j], s[j]);
      const float4* xv = reinterpret_cast<const float4*>(xs + k * MAXR);
#pragma unroll
      for (int r4 = 0; r4 < MAXR / 4; ++r4) {
        const float4 xx = xv[r4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[4 * r4 + 0][j] = fmaf(xx.x, w[j], acc[4 * r4 + 0][j]);
          acc[4 * r4 + 1][j] = fmaf(xx.y, w[j], acc[4 * r4 + 1][j]);
          acc[4 * r4 + 2][j] = fmaf(xx.z, w[j], acc[4 * r4 + 2][j]);
          acc[4 * r4 + 3][j] = fmaf(xx.w, w[j], acc[4 * r4 + 3][j]);
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
      for (int w = 0; w < kNarrowWarps; ++w)
        v += red[(w * 4 + i) * kNarrowCols + c];
      if (direct)
        out[(size_t)r * N + col0 + c] = ptt::from_float<TX>(v);
      else
        partial[((size_t)blockIdx.y * rows + r) * N + col0 + c] = v;
    }
  }
}

// out[i] = sum over chunks p (in order) of partial[p][i], cast to TX
template <typename TX>
__global__ void int8_matmul_split_sum_kernel(const float* __restrict__ partial,
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

template <typename TX>
__global__ void __launch_bounds__(kWideThreads)
    int8_matmul_wide_kernel(const TX* __restrict__ x,
                            const int8_t* __restrict__ wq,
                            const float* __restrict__ scale,
                            TX* __restrict__ out, int rows, int K, int N) {
  __shared__ __align__(16) float xs[2][kStep][kTile];  // x^T
  __shared__ __align__(16) float ws[2][kStep][kTile];  // dequantized w
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  // loaders: x row (tid % 128) at K offset (tid / 128) * 8; w K row
  // tid / 16 at columns (tid % 16) * 8
  const int xr = tid & (kTile - 1);
  const int xk = (tid >> 7) * 8;
  const int wk = tid >> 4;
  const int wc = (tid & 15) * 8;
  const bool xrow_ok = row0 + xr < rows;
  const bool wcol_ok = col0 + wc < N;  // N % 8 == 0: all 8 in or out
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = wcol_ok ? scale[col0 + wc + j] : 0.0f;
  // compute: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and
  // 64 + tx*4 + j (two 4-wide halves keep the shared loads conflict-free)
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float xreg[8];
  uint2 wreg;
  auto load = [&](int k0) {
    if (xrow_ok && k0 + xk < K) {
      ptt::load_floats<TX, 8>(x + (size_t)(row0 + xr) * K + k0 + xk, xreg);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xreg[j] = 0.0f;
    }
    wreg = (wcol_ok && k0 + wk < K)
               ? __ldg(reinterpret_cast<const uint2*>(
                     wq + (size_t)(k0 + wk) * N + col0 + wc))
               : make_uint2(0u, 0u);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[buf][xk + j][xr] = xreg[j];
    float w[8];
    i8x4_to_float(wreg.x, w);
    i8x4_to_float(wreg.y, w + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = dequant<TX>(w[j], sc[j]);
    float4* dst = reinterpret_cast<float4*>(&ws[buf][wk][wc]);
    dst[0] = make_float4(w[0], w[1], w[2], w[3]);
    dst[1] = make_float4(w[4], w[5], w[6], w[7]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int steps = (K + kStep - 1) / kStep;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) load((t + 1) * kStep);
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kk][64 + ty * 4]);
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

template <typename TX, int MAXR>
cudaError_t launch_narrow(const void* x, const void* wq, const void* scale,
                          void* out, void* partial, int rows, int K, int N,
                          int kchunk, cudaStream_t stream) {
  const int chunks = (K + kchunk - 1) / kchunk;
  const size_t smem = sizeof(float) * ((size_t)kchunk * MAXR +
                                       (size_t)kNarrowWarps * 4 * kNarrowCols);
  auto kernel = int8_matmul_narrow_kernel<TX, MAXR>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (chunks > 1 && partial == nullptr) return cudaErrorInvalidValue;
  dim3 grid((N + kNarrowCols - 1) / kNarrowCols, chunks);
  kernel<<<grid, kNarrowThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TX*>(out),
      static_cast<float*>(partial), rows, K, N, kchunk);
  if (chunks > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int count = rows * N;
    int8_matmul_split_sum_kernel<TX><<<(count + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<TX*>(out), chunks,
        count);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* out, void* partial, int rows, int K, int N,
                   int kchunk, cudaStream_t stream) {
  if (rows <= 8)
    return launch_narrow<TX, 8>(x, wq, scale, out, partial, rows, K, N,
                                kchunk, stream);
  if (rows <= 16)
    return launch_narrow<TX, 16>(x, wq, scale, out, partial, rows, K, N,
                                 kchunk, stream);
  dim3 grid((N + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  int8_matmul_wide_kernel<TX><<<grid, kWideThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TX*>(out), rows, K, N);
  return cudaGetLastError();
}

}  // namespace

// x: [rows, K] (x_dtype, fp32 or bf16); w_q: int8 [K, N]; scale: fp32
// [N]; out: [rows, N] (x_dtype). All contiguous and 16-byte aligned; K
// and N multiples of 8 (the Python wrapper checks). With rows <= 16 and
// K > kchunk, `partial` is fp32 scratch of ceil(K / kchunk) * rows * N.
extern "C" int ptt_int8_matmul(const void* x, const void* wq,
                               const void* scale, void* out, void* partial,
                               int rows, int K, int N, int kchunk,
                               int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || N == 0) return cudaSuccess;
  if (kchunk < 8 || kchunk % 8) return cudaErrorInvalidValue;
  if (x_dtype == ptt::kBF16)
    return launch<__nv_bfloat16>(x, wq, scale, out, partial, rows, K, N,
                                 kchunk, s);
  if (x_dtype == ptt::kF32)
    return launch<float>(x, wq, scale, out, partial, rows, K, N, kchunk, s);
  return cudaErrorInvalidValue;
}
