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
// What bounds it on the H100: at the decode step (the head [8, 4096] x
// [4096, 32000]) bytes, the weight read once (262 MB); at prefill and
// in training (hundreds to thousands of rows) operations (989 TFLOP/s
// for bf16 on the tensor cores; fp32 through six bf16 products a
// product, 989 / 6; 67 for fp32 on the CUDA cores).
//
// Three designs, chosen by x's dtype and, in fp32, the row count:
//
// bf16: the tensor-core design (namespace tc, below; hopper.cuh). A
// first kernel takes every row's rstd over the whole K into an fp32
// [rows] buffer (a warp per row), so that no CTA re-reads its rows' whole
// x before its first product. Then TMA brings the k-tiles of x and of wm
// (128-byte swizzled; wm's [K, N] tiles, N contiguous, land directly in
// the MN-major layout wgmma reads) into a ring of stages; the consumer
// warpgroups build y = (x * rstd) * w in fp32, rounded to bf16 where
// _normed_rows rounds, and multiply it with fp32 accumulators, the next
// y built while the products before it run. Two kernels of one
// template, as the W8A16 matmul's:
// - swap-AB (rows up to 256: the decode step and short prefills): out^T
//   = W^T y^T, the weight's 128 columns of a CTA fill wgmma's M side (64
//   per consumer warpgroup) and the rows its N side (8 to 256); K is
//   split into chunks so that the 250 column tiles of the Llama head
//   give about two CTAs per SM, and the fp32 partials are summed in
//   chunk order by a second kernel (no atomics: results repeat bit for
//   bit);
// - tiled (more rows, prefill): a CTA owns a 128 x 256 output tile (64
//   rows per consumer warpgroup, one wgmma m64n256k16 per k-step) over
//   all of K; the row tiles of one column tile are neighbours in the
//   grid, so they share its weight tiles through the L2.
// In both, each x tile is turned into the y tile in place in shared
// memory and fenced for the async proxy, and one tile's products stay in
// flight while the next tile is normalised. (Building y as wgmma's
// register A operand instead, k-step by k-step, which keeps the normed
// tile out of shared memory, measured slower on the tiled kernel: each
// k-step's register fence waits for the products before it.)
//
// fp32 from SPLIT_MIN_ROWS rows (kernels/fused_norm_matmul.py; the
// training head, under O1 too: the op is on neither AMP list): the split
// design (namespace sp, at the end): the tensor cores take fp32 only as
// TF32, so the normed rows and the weight are split by pre-passes into
// three bf16 parts each and every product is six bf16 products of parts
// (split.cuh), which keeps fp32's 24 bits.
//
// fp32 below that (where the weight read bounds the call and a split of
// the weight would write 1.5 times its bytes more), and on request
// (cuda_cores, to compare with): the CUDA-core design (the port's first
// kernels, below). Two kernels, chosen by the row count:
// - narrow (rows <= 16): a CTA owns 128 columns and one chunk of at most
//   kchunk K rows (split-K). Its prologue takes the rstd of every row
//   over the whole K (a warp per row, 16-byte vectors, from L2 after the
//   first CTA), then stages its chunk of y = (x * rstd) * w in shared
//   memory as fp32 [k][row]. Each lane owns 4 columns and keeps two
//   groups of kUnroll weight loads in flight (the next group's are
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
#include "hopper.cuh"
#include "split.cuh"

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

// rstd = rsqrt(mean(x^2) + eps) of every row, fp32 [rows]: a warp per row
// (the tensor-core design's first kernel)
template <typename TX>
__global__ void __launch_bounds__(256)
    norm_rstd_kernel(const TX* __restrict__ x, float* __restrict__ rstd,
                     int rows, int K, float eps) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= rows) return;
  const float rs = row_rstd<TX>(x + (size_t)r * K, K, eps);
  if ((threadIdx.x & 31) == 0) rstd[r] = rs;
}

// ================================================ bf16: tensor-core design
// (ptt::hopper: TMA, mbarriers, wgmma with fp32 accumulators). A CTA owns
// NT weight columns (128 swap-AB, 256 tiled); its producer warpgroup's
// first thread keeps the k-tiles of x (XR rows x 64) and of wm (64 K rows
// x NT columns, NT / 64 boxes) in flight through a ring of S stages
// (full/empty mbarrier pair per stage); the two consumer warpgroups
// build the normed y from each x tile in place in shared memory and run
// wgmma on it.
namespace tc {

using bf16 = __nv_bfloat16;
using namespace ptt::hopper;

constexpr int kKT = 64;    // K rows of a k-tile
constexpr int kThreads = 384;
constexpr int kConsumers = 256;

// weight columns of a CTA: the swap-AB kernel's wgmma M side (64 per
// consumer warpgroup), the tiled kernel's N side (one m64n256 product
// per warpgroup: a 128 x 256 tile moves a quarter fewer shared-memory
// bytes per product than 256 x 128, where the products and the
// normalisation together outrun shared memory's 128 bytes a clock)
template <bool kSwap>
__host__ __device__ constexpr int cols() {
  return kSwap ? 128 : 256;
}

// Shared memory: S stages of (x tile: XR rows x 64 bf16, 128-byte
// swizzled; the wm tile: NT / 64 boxes of 64 K rows x 64 columns), the
// barriers (full and empty per stage), and 1024 bytes to align the base.
template <int XR, int S, int NT>
struct Smem {
  static constexpr int kX = XR * 128;
  static constexpr int kW = kKT * NT * 2;
  static constexpr int kStage = kX + kW;  // a multiple of 1024
  static constexpr int kBars = S * kStage;
  static constexpr int kBytes = kBars + 16 * S + 1024;
};

// stages of each design: the swap-AB kernel (few rows) keeps more weight
// tiles in flight, and two of its CTAs share an SM up to 16 rows
template <bool kSwap, int XR>
__host__ __device__ constexpr int stages() {
  return kSwap && XR <= 16 ? 6 : 4;
}

// _normed_rows' op order on a bf16 pair (lo in the low half): (x * rstd)
// * w in fp32, rounded to bf16
__device__ __forceinline__ uint32_t normed_pair(uint32_t x, float rs,
                                                float w0, float w1) {
  // a bf16 is the high half of its fp32 value
  return pack_bf16(__fmul_rn(__fmul_rn(__uint_as_float(x << 16), rs), w0),
                   __fmul_rn(__fmul_rn(__uint_as_float(x & 0xffff0000u), rs),
                             w1));
}

// kSwap false (tiled, prefill; XR = 128): the CTA owns rows [row0, row0
// + 128) (64 per consumer warpgroup) and weight columns [n0, n0 + 256),
// over all of K: out = y W with wgmma m64n256k16, A = the y tile
// (K-major), B = the wm tile (MN-major). Grid (row tiles, column tiles).
// The producer warpgroup gives its registers to the consumers
// (setmaxnreg), whose accumulators take 128.
// kSwap true (swap-AB: decode, short prefills): the CTA owns weight
// columns [n0, n0 + 128) (64 per consumer warpgroup) and the K rows of
// one chunk, [kchunk * blockIdx.y, + kchunk): out^T = W^T y^T with wgmma
// m64nXRk16, A = the consumer's 64-column box of the wm tile (MN-major:
// the transpose flag), B = the y tile of XR rows (K-major). One chunk
// writes out directly; more write fp32 partials that a second kernel
// sums in chunk order.
template <bool kSwap, int XR, typename TW>
__global__ void __launch_bounds__(kThreads, kSwap && XR <= 16 ? 2 : 1)
    norm_matmul_tc_kernel(const __grid_constant__ CUtensorMap mx,
                          const __grid_constant__ CUtensorMap mw,
                          const TW* __restrict__ w,
                          const float* __restrict__ rstd,
                          bf16* __restrict__ out, float* __restrict__ partial,
                          int rows, int K, int N, int kchunk) {
  constexpr int S = stages<kSwap, XR>();
  constexpr int NT = cols<kSwap>();
  using L = Smem<XR, S, NT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full0 = base + L::kBars, empty0 = full0 + 8 * S;

  const int n0 = (kSwap ? blockIdx.x : blockIdx.y) * NT;
  const int row0 = kSwap ? 0 : blockIdx.x * XR;
  const int k_begin = kSwap ? blockIdx.y * kchunk : 0;
  const int k_end = kSwap ? min(K, k_begin + kchunk) : K;
  const int ntiles = (k_end - k_begin + kKT - 1) / kKT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread loads
    if constexpr (!kSwap) regs_release<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
        const uint32_t st = base + s * L::kStage;
        const uint32_t bar = full0 + 8 * s;
        const int k0 = k_begin + it * kKT;
        mbar_arrive_expect_tx(bar, L::kStage);
        tma_load_2d(st, &mx, bar, k0, row0);
#pragma unroll
        for (int j = 0; j < NT / 64; ++j)
          tma_load_2d(st + L::kX + j * kKT * 128, &mw, bar, n0 + 64 * j, k0);
      }
    }
    return;
  }
  if constexpr (!kSwap) regs_claim<232>();

  const int t = threadIdx.x, wg = warp / 4, tw = t % 128;
  // the accumulator (and register A) fragment of m64nW: thread tw holds
  // fragment rows (tw / 32) * 16 + (tw % 32) / 4 (entries 4j, 4j + 1)
  // and that + 8 (entries 4j + 2, 4j + 3), columns 8j + 2 (tw % 4) +
  // {0, 1}
  const int fr = (tw / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  // accumulators: swap-AB one m64nXR tile; tiled one m64n256 tile, rows
  // 64 wg of the CTA's rows
  constexpr int kAcc = kSwap ? XR / 2 : NT / 2;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;

  // Normalisation in shared memory, in place: thread t owns the 16-byte
  // chunk t % 8 of the x tile's rows t / 8 + 32 m; the swizzle puts the
  // tile columns 8 (t % 8 ^ (t / 8) % 8) .. + 7 there in every such row,
  // so a thread's 8 norm weights are the same for all its rows, and its
  // rows' rstd stay in registers.
  const int chunk = t % 8, r0 = t / 8;
  const int kcol = 8 * (chunk ^ (r0 % 8));
  constexpr int RM = XR >= 32 ? XR / 32 : 1;
  const bool norm_on = r0 < XR;
  float rs[RM];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = row0 + r0 + 32 * m;
    rs[m] = norm_on && r < rows ? rstd[r] : 0.0f;
  }
  // the tile's rows past `rows` and columns past K hold TMA's zeros
  auto normalize = [&](int it) {
    if (!norm_on) return;
    const int k = k_begin + it * kKT + kcol;
    float wv[8];
    if (k < K) {  // K % 8 == 0: the 8 columns are all in or all out
      ptt::load_floats<TW, 8>(w + k, wv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = 0.0f;
    }
    uint8_t* xt = gbase + (it % S) * L::kStage + chunk * 16;
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      uint4* p = reinterpret_cast<uint4*>(xt + (r0 + 32 * m) * 128);
      const uint4 raw = *p;
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = normed_pair(in[j], rs[m], wv[2 * j], wv[2 * j + 1]);
      *p = make_uint4(o[0], o[1], o[2], o[3]);
    }
  };

  // one tile's products stay in flight while the next tile is normalised
  // and its products issued: a stage is released once the products of
  // the tile after it have been issued and its own are done
  mbar_wait(full0, 0);
  normalize(0);
  fence_proxy_async();
  named_sync(1, kConsumers);
  wgmma_fence();
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % S;
    const uint32_t sX = base + s * L::kStage;
    const uint32_t sW = sX + L::kX;
    // the accumulators stay where the products in flight write them
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      if constexpr (kSwap)
        wgmma_ss_t<XR, 1, 0>(acc, desc_mn_major<kKT>(sW + wg * kKT * 128, kk),
                             desc_k_major<XR>(sX, 0, kk), 1);
      else
        wgmma_ss_t<NT, 0, 1>(acc, desc_k_major<XR>(sX, 64 * wg, kk),
                             desc_mn_major<kKT>(sW, kk), 1);
    }
    wgmma_commit();
    fence_regs(acc);
    if (it > 0) {  // the previous tile's products are done: free its stage
      wgmma_wait<1>();
      mbar_arrive(empty0 + 8 * ((it - 1) % S));
    }
    // the next tile is normalised while these products run
    if (it + 1 < ntiles) {
      mbar_wait(full0 + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
      normalize(it + 1);
      fence_proxy_async();
      named_sync(1, kConsumers);
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

  if constexpr (kSwap) {
    // fragment rows are weight columns, fragment columns x rows
    const bool direct = gridDim.y == 1;
#pragma unroll
    for (int j = 0; j < XR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 64 * wg + fr + (e >= 2 ? 8 : 0);
        const int r = 8 * j + cq + (e & 1);
        if (n >= N || r >= rows) continue;
        const float v = acc[4 * j + e];
        if (direct)
          out[(size_t)r * N + n] = __float2bfloat16_rn(v);
        else
          partial[((size_t)blockIdx.y * rows + r) * N + n] = v;
      }
  } else {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int n = n0 + 8 * j + cq;  // N % 8 == 0: the pair is all in
      if (n >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + 64 * wg + fr + 8 * half;
        if (r < rows)
          *reinterpret_cast<uint32_t*>(out + (size_t)r * N + n) =
              pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

template <bool kSwap, int XR, typename TW>
cudaError_t launch(const void* x, const void* w, const void* wm,
                   const float* rstd, void* out, void* partial, int rows,
                   int K, int N, int kchunk, cudaStream_t stream) {
  CUtensorMap mx, mw;
  cudaError_t err;
  if ((err = make_map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, rows,
                         (uint64_t)K * 2, 64, XR,
                         CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wm, N, K,
                         (uint64_t)N * 2, 64, kKT,
                         CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  constexpr int NT = cols<kSwap>();
  constexpr int smem = Smem<XR, stages<kSwap, XR>(), NT>::kBytes;
  auto kernel = norm_matmul_tc_kernel<kSwap, XR, TW>;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return err;
  const int col_tiles = (N + NT - 1) / NT;
  const int chunks = kSwap ? (K + kchunk - 1) / kchunk : 1;
  if (chunks > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const dim3 grid = kSwap ? dim3(col_tiles, chunks)
                          : dim3((rows + XR - 1) / XR, col_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      mx, mw, static_cast<const TW*>(w), rstd, static_cast<bf16*>(out),
      static_cast<float*>(partial), rows, K, N, kchunk);
  if (chunks == 1) return cudaGetLastError();
  if ((err = cudaGetLastError())) return err;
  const int count = rows * N;
  norm_matmul_split_sum_kernel<bf16><<<(count + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(out), chunks,
      count);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t dispatch(const void* x, const void* w, const void* wm,
                     const float* rstd, void* out, void* partial, int rows,
                     int K, int N, int kchunk, int swap_rows,
                     cudaStream_t s) {
  switch (swap_rows) {
    case 0:
      return launch<false, 128, TW>(x, w, wm, rstd, out, partial, rows, K, N,
                                    kchunk, s);
    case 8:
      return launch<true, 8, TW>(x, w, wm, rstd, out, partial, rows, K, N,
                                 kchunk, s);
    case 16:
      return launch<true, 16, TW>(x, w, wm, rstd, out, partial, rows, K, N,
                                  kchunk, s);
    case 32:
      return launch<true, 32, TW>(x, w, wm, rstd, out, partial, rows, K, N,
                                  kchunk, s);
    case 64:
      return launch<true, 64, TW>(x, w, wm, rstd, out, partial, rows, K, N,
                                  kchunk, s);
    case 128:
      return launch<true, 128, TW>(x, w, wm, rstd, out, partial, rows, K, N,
                                   kchunk, s);
    case 256:
      return launch<true, 256, TW>(x, w, wm, rstd, out, partial, rows, K, N,
                                   kchunk, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tc

// =============================== fp32: the split design (tensor cores)
// (split.cuh: three bf16 parts an fp32 value, six bf16 products a
// product, smallest first.) Three pre-passes, then one tensor-core kernel:
// - the rstd of every row over the whole K (norm_rstd_kernel<float>);
// - y = (x * rstd) * w in fp32 (_normed_rows' op order; its rounding to
//   x's dtype is a no-op in fp32), split into three parts and written
//   transposed, [3, K, R8] (R8: the rows rounded up to 8, padding rows
//   zero), so that a y tile is read like a weight tile (MN-major);
// - wm split into three parts, [3, K, N] (split3_kernel). The weights
//   change every training step, so this runs at every call: at the Llama
//   head 524 MB read and 786 MB written, about 0.4 ms of a kernel's 6.5
//   ms bound. Splitting from fp32 tiles inside the kernel instead would
//   read 4 bytes a weight where the parts are 6, but every CTA of a
//   column would split the same tile again (the 32 row tiles of the
//   Llama head), on the warpgroups whose issue slots the products need;
//   the pre-pass does it once.
// The kernel: a CTA owns a 128 x 256 output tile (64 rows per consumer
// warpgroup, one m64n256k16 accumulator of 128 registers a thread) over
// all of K, in k-tiles of 32 K rows: a stage is the three parts of the
// y tile (two 64-row boxes each) and of the wm tile (four 64-column
// boxes), 72 KB, both MN-major 128-byte swizzled (the transpose flag for
// both operands), three stages (216 KB). A k-tile of 64 would take 144 KB
// a stage, one stage in all; a 128 x 128 tile at k-tile 64 fits two
// stages but moves 75% more bytes from the L2 per product. Per k-tile
// and warpgroup the six terms, each over the tile's two k-steps of 16,
// are issued into the one accumulator, and one tile's products stay in
// flight while the next tile's are issued. One thread of a producer
// warpgroup issues the loads (it gives its registers to the two
// consumer warpgroups, setmaxnreg, as the bf16 tiled kernel's does: 232
// each). A CTA of the consumers alone, a consumer thread issuing each
// next tile once its stage is free (flash's split kernels, 255
// registers), serialized these products (ptxas C7518: that thread's
// wait sits between two product groups in flight). The row tiles of one
// column tile are neighbours in the grid and share its weight tiles
// through the L2. No atomics, one owner per output: results repeat bit
// for bit.
namespace sp {

using bf16 = __nv_bfloat16;
using namespace ptt::hopper;
using namespace ptt::split;

constexpr int kRows = 128;                     // output rows of a CTA
constexpr int kCols = 256;                     // output columns of a CTA
constexpr int kKT = 32;                        // K rows of a k-tile
constexpr int kStages = 3;
constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;     // + the producer's
constexpr int kBox = kKT * 128;                // 64 columns x kKT rows
constexpr int kA = 3 * (kRows / 64) * kBox;    // the y tile's parts
constexpr int kB = 3 * (kCols / 64) * kBox;    // the wm tile's parts
constexpr int kStage = kA + kB;                // 72 KB, a multiple of 1024
constexpr int kBars = kStages * kStage;
constexpr int kSmem = kBars + 16 * kStages + 1024;

// y = (x * rstd) * w, transposed and split: yt [3, K, R8]. A thread takes
// 8 rows of one column k (the threads of a warp neighbouring k, so each
// of its 8 row reads is one coalesced line); rows past `rows` are zero.
__global__ void norm_split3t_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ rstd,
                                    bf16* __restrict__ yt, int rows, int R8,
                                    int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(R8 / 8) * K) return;
  const int k = (int)(i % K), r0 = (int)(i / K) * 8;
  const float wk = w[k];
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = r0 + j;
    v[j] = r < rows ? __fmul_rn(__fmul_rn(x[(size_t)r * K + k], rstd[r]), wk)
                    : 0.0f;
  }
  store_parts8(yt + (size_t)k * R8 + r0, (long long)K * R8, v);
}

// out [rows, N] fp32 = y wm from the parts: my maps yt (R8, K, 3), mw the
// wm parts (N, K, 3); grid (row tiles, column tiles)
__global__ void __launch_bounds__(kThreads, 1)
    norm_matmul_split_kernel(const __grid_constant__ CUtensorMap my,
                             const __grid_constant__ CUtensorMap mw,
                             float* __restrict__ out, int rows, int K,
                             int N) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + kBars, empty0 = full0 + 8 * kStages;
  const int row0 = blockIdx.x * kRows, n0 = blockIdx.y * kCols;
  const int ntiles = (K + kKT - 1) / kKT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread loads
    regs_release<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      // k-tile `it` into stage it % kStages, once both consumer
      // warpgroups have released the stage's previous tile
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * s, (it / kStages - 1) & 1);
        const uint32_t st = base + s * kStage, bar = full0 + 8 * s;
        const int k0 = it * kKT;
        mbar_arrive_expect_tx(bar, kStage);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
          for (int j = 0; j < kRows / 64; ++j)
            tma_load_3d(st + (p * (kRows / 64) + j) * kBox, &my, bar,
                        row0 + 64 * j, k0, p);
#pragma unroll
          for (int j = 0; j < kCols / 64; ++j)
            tma_load_3d(st + kA + (p * (kCols / 64) + j) * kBox, &mw, bar,
                        n0 + 64 * j, k0, p);
        }
      }
    }
    return;
  }
  regs_claim<232>();

  const int wg = warp / 4, tw = threadIdx.x % 128;
  // the accumulator fragment of m64n256: thread tw holds rows (tw / 32) *
  // 16 + (tw % 32) / 4 (entries 4j, 4j + 1) and that + 8 (entries 4j +
  // 2, 4j + 3), columns 8j + 2 (tw % 4) + {0, 1}
  const int fr = (tw / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  float acc[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) acc[j] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    // this warpgroup's 64-row box of each y part, and the wm parts
    const uint32_t sA = base + s * kStage + wg * kBox;
    const uint32_t sB = base + s * kStage + kA;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int t = 0; t < 6; ++t)
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk)
        wgmma_ss_t<kCols, 1, 1>(
            acc,
            desc_mn_major<kKT>(sA + term_a(t) * (kRows / 64) * kBox, kk),
            desc_mn_major<kKT>(sB + term_b(t) * (kCols / 64) * kBox, kk), 1);
    wgmma_commit();
    fence_regs(acc);
    if (it > 0) {  // the previous tile's products are done: free its stage
      wgmma_wait<1>();
      mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int n = n0 + 8 * j + cq;  // N % 8 == 0: the pair is all in
    if (n >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 64 * wg + fr + 8 * half;
      if (r < rows)
        *reinterpret_cast<float2*>(out + (size_t)r * N + n) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// the two split pre-passes into `work` (yt, then the wm parts), then the
// kernel
cudaError_t launch(const float* x, const float* w, const float* rstd,
                   const float* wm, float* out, bf16* work, int rows, int K,
                   int N, cudaStream_t stream) {
  const int R8 = (rows + 7) / 8 * 8;
  bf16* yt = work;
  bf16* wp = work + 3LL * K * R8;
  const long long ny = (long long)(R8 / 8) * K;
  norm_split3t_kernel<<<(unsigned)((ny + 255) / 256), 256, 0, stream>>>(
      x, w, rstd, yt, rows, R8, K);
  cudaError_t err = cudaGetLastError();
  if (err) return err;
  const long long nw = (long long)K * (N / 8);
  split3_kernel<float><<<(unsigned)((nw + 255) / 256), 256, 0, stream>>>(
      wm, wp, ptt::Strides{(long long)K * N, N, N}, 1, K, 1, N, N);
  if ((err = cudaGetLastError())) return err;
  CUtensorMap my, mw;
  if ((err = make_parts_map(&my, yt, R8, K, 3, 64, kKT)) ||
      (err = make_parts_map(&mw, wp, N, K, 3, 64, kKT)))
    return err;
  if ((err = cudaFuncSetAttribute(norm_matmul_split_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmem)))
    return err;
  const dim3 grid((R8 + kRows - 1) / kRows, (N + kCols - 1) / kCols);
  norm_matmul_split_kernel<<<grid, kThreads, kSmem, stream>>>(my, mw, out,
                                                               rows, K, N);
  return cudaGetLastError();
}

}  // namespace sp

}  // namespace

// The CUDA-core design, fp32: x [rows, K], w [K] and wm [K, N] fp32,
// out fp32 [rows, N]. All contiguous and 16-byte aligned; K and N
// multiples of 8 (the Python wrapper checks). With rows <= 16 and K >
// kchunk, `partial` is fp32 scratch of ceil(K / kchunk) * rows * N.
extern "C" int ptt_rms_norm_matmul(const void* x, const void* w,
                                   const void* wm, void* out, void* partial,
                                   int rows, int K, int N, int kchunk,
                                   float eps, void* stream) {
  if (rows == 0 || N == 0) return cudaSuccess;
  if (kchunk < 8 || kchunk % 8) return cudaErrorInvalidValue;
  return launch<float, float>(x, w, wm, out, partial, rows, K, N, kchunk,
                              eps, static_cast<cudaStream_t>(stream));
}

// The tensor-core design, bf16: x [rows, K] and wm [K, N] bf16, w [K]
// of w_dtype (bf16 or fp32), out bf16 [rows, N]; rstd fp32 scratch of
// rows (the first kernel writes it). All contiguous and 16-byte aligned,
// K and N multiples of 8. swap_rows 0 runs the tiled kernel; 8, 16, 32,
// 64, 128 or 256 the swap-AB kernel with a tile of that many rows (>=
// rows), over K chunks of kchunk rows (a multiple of 64); with more than
// one chunk, `partial` is fp32 scratch of ceil(K / kchunk) * rows * N.
extern "C" int ptt_rms_norm_matmul_tc(const void* x, const void* w,
                                      const void* wm, void* out, void* rstd,
                                      void* partial, int rows, int K, int N,
                                      int kchunk, int swap_rows, int w_dtype,
                                      float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || N == 0) return cudaSuccess;
  if (K % 8 || N % 8 || kchunk < tc::kKT || kchunk % tc::kKT ||
      (swap_rows != 0 && rows > swap_rows) ||
      (w_dtype != ptt::kBF16 && w_dtype != ptt::kF32))
    return cudaErrorInvalidValue;
  norm_rstd_kernel<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(rstd), rows,
      K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* rs = static_cast<const float*>(rstd);
  if (w_dtype == ptt::kBF16)
    return tc::dispatch<__nv_bfloat16>(x, w, wm, rs, out, partial, rows, K,
                                       N, kchunk, swap_rows, s);
  return tc::dispatch<float>(x, w, wm, rs, out, partial, rows, K, N, kchunk,
                             swap_rows, s);
}

// The split design, fp32: x [rows, K], w [K] and wm [K, N] fp32, out fp32
// [rows, N]; rstd fp32 scratch of rows (the first kernel writes it);
// work bf16 scratch of 3 x K x (R8 + N) values, R8 = rows rounded up to 8
// (the parts of y and of wm). All contiguous and 16-byte aligned, K and N
// multiples of 8.
extern "C" int ptt_rms_norm_matmul_split(const void* x, const void* w,
                                         const void* wm, void* out,
                                         void* rstd, void* work, int rows,
                                         int K, int N, float eps,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || N == 0) return cudaSuccess;
  if (K % 8 || N % 8 || work == nullptr) return cudaErrorInvalidValue;
  norm_rstd_kernel<float><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(rstd), rows, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sp::launch(static_cast<const float*>(x),
                    static_cast<const float*>(w),
                    static_cast<const float*>(rstd),
                    static_cast<const float*>(wm), static_cast<float*>(out),
                    static_cast<__nv_bfloat16*>(work), rows, K, N, s);
}
