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
// prefill (rows in the hundreds) operations (989 TFLOP/s for bf16 on the
// tensor cores).
//
// Two designs, chosen by x's dtype:
//
// bf16 and fp16 (a decorate O2 net's quantized projections): the
// tensor-core design (namespace tc, below; hopper.cuh) on the element type
// E of x (bf16 or fp16 wgmma and tensor maps). TMA
// brings the k-tiles of x (128-byte swizzled) and of the int8 weight
// (unswizzled, through a map of its rows taken in pairs) into a ring of
// stages; the consumer warpgroups dequantize each int8 tile in shared
// memory, float(q) * scale -> E in _dequant's order, into the MN-major
// swizzled layout wgmma reads, and multiply with fp32 accumulators; the
// dequantization of the next tile overlaps the products of this one. Each
// weight is dequantized once per CTA. Two kernels of one template:
// - swap-AB (rows up to 256: the decode step and short prefills): out^T
//   = W^T x^T, the weight's 128 columns of a CTA fill wgmma's M side (64
//   per consumer warpgroup) and the x rows its N side (8 to 256); K is
//   split
//   into chunks so that even N = 4096 gives about two CTAs per SM, and
//   the fp32 partials are summed in chunk order by a second kernel (no
//   atomics: results repeat bit for bit);
// - tiled (more rows, prefill): a CTA owns a 256 x 128 output tile (128
//   rows per consumer warpgroup, two wgmma m64n128k16 per k-step) over
//   all of K; the row tiles of one column tile are neighbours in the
//   grid, so they share its weight tiles through the L2. 256 rows, not
//   128, halve the dequantization per product: alone it takes as long
//   as the products and only partly overlaps them.
//
// fp32: the CUDA-core design (below; the tensor cores
// take fp32 only as TF32, about three decimal digits). Two kernels,
// chosen by the row count:
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
// Both dequantize each weight exactly once per CTA; fp32 FMAs keep them
// far above their bounds (at 8 rows instruction issue, 8 FMAs and the
// dequantization per weight byte).
#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- narrow
constexpr int kNarrowThreads = 256;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowCols = 128;  // 32 lanes x 4 columns
constexpr int kUnroll = 8;        // K rows whose loads a warp issues at once

template <int MAXR>
__global__ void __launch_bounds__(kNarrowThreads)
    int8_matmul_narrow_kernel(const float* __restrict__ x,
                              const int8_t* __restrict__ wq,
                              const float* __restrict__ scale,
                              float* __restrict__ out,
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
        r < rows ? x[(size_t)r * K + k0 + k] : 0.0f;
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
      for (int j = 0; j < 4; ++j) w[j] *= s[j];
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
        out[(size_t)r * N + col0 + c] = v;
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

__global__ void __launch_bounds__(kWideThreads)
    int8_matmul_wide_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ wq,
                            const float* __restrict__ scale,
                            float* __restrict__ out, int rows, int K, int N) {
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
      ptt::load_floats<float, 8>(x + (size_t)(row0 + xr) * K + k0 + xk, xreg);
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
    for (int j = 0; j < 8; ++j) w[j] *= sc[j];
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
      ptt::store_floats<float, 4>(out + (size_t)r * N + c, v);
    }
  }
}

template <int MAXR>
cudaError_t launch_narrow(const float* x, const int8_t* wq,
                          const float* scale, float* out, float* partial,
                          int rows, int K, int N, int kchunk,
                          cudaStream_t stream) {
  const int chunks = (K + kchunk - 1) / kchunk;
  const size_t smem = sizeof(float) * ((size_t)kchunk * MAXR +
                                       (size_t)kNarrowWarps * 4 * kNarrowCols);
  auto kernel = int8_matmul_narrow_kernel<MAXR>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (chunks > 1 && partial == nullptr) return cudaErrorInvalidValue;
  dim3 grid((N + kNarrowCols - 1) / kNarrowCols, chunks);
  kernel<<<grid, kNarrowThreads, smem, stream>>>(x, wq, scale, out, partial,
                                                 rows, K, N, kchunk);
  if (chunks > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int count = rows * N;
    int8_matmul_split_sum_kernel<float><<<(count + 255) / 256, 256, 0,
                                          stream>>>(partial, out, chunks,
                                                    count);
  }
  return cudaGetLastError();
}

cudaError_t launch(const float* x, const int8_t* wq, const float* scale,
                   float* out, float* partial, int rows, int K, int N,
                   int kchunk, cudaStream_t stream) {
  if (rows <= 8)
    return launch_narrow<8>(x, wq, scale, out, partial, rows, K, N, kchunk,
                            stream);
  if (rows <= 16)
    return launch_narrow<16>(x, wq, scale, out, partial, rows, K, N, kchunk,
                             stream);
  dim3 grid((N + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  int8_matmul_wide_kernel<<<grid, kWideThreads, 0, stream>>>(x, wq, scale,
                                                             out, rows, K, N);
  return cudaGetLastError();
}


// ============================================ bf16: tensor-core design
// (ptt::hopper: TMA, mbarriers, wgmma with fp32 accumulators). A CTA owns
// kNT = 128 weight columns; its producer warpgroup's first thread keeps
// the k-tiles of x and of the int8 weight in flight through a ring of S
// stages (full/empty mbarrier pair per stage); the two consumer
// warpgroups dequantize each int8 tile in shared memory into a bf16 tile
// in the MN-major 128-byte-swizzled layout of hopper.cuh (two 64-column
// regions of kKT rows) and run wgmma on it, the products of tile it
// overlapping the dequantization of tile it + 1 (two bf16 tiles).
namespace tc {

using bf16 = __nv_bfloat16;
using namespace ptt::hopper;

constexpr int kKT = 64;    // K rows of a k-tile
constexpr int kNT = 128;   // weight columns of a CTA
constexpr int kThreads = 384;
constexpr int kConsumers = 256;
// The int8 weight is read through tensor maps of its rows taken in
// pairs, [K / 2, 2N] (row stride 2N bytes, a multiple of 16 for any N %
// 8 == 0, where [K, N] rows of N bytes need N % 16 == 0): a k-tile is two
// unswizzled boxes of kKT / 2 pair-rows, the even K rows (kNT bytes from
// column n0) and the odd ones (from column N + n0). A box must start on a
// 16-byte boundary, so when N % 16 == 8 the odd rows' box starts 8 bytes
// early and is 144 bytes wide (a second map; `wpad` = N % 16 is where
// the row's columns begin in it).
constexpr int kWHalf = kKT / 2 * kNT;       // bytes of the even rows' box
constexpr int kWOddMax = kKT / 2 * (kNT + 16);
constexpr int kWBytes = 9 * 1024;           // both boxes, 1024-aligned
static_assert(kWHalf + kWOddMax <= kWBytes, "int8 boxes overflow");
constexpr int kBBytes = kKT * kNT * 2;      // a dequantized bf16 tile

// Shared memory: S stages of (x tile: XR rows x 64 bf16, 128-byte
// swizzled; the two int8 boxes, kWBytes), two bf16 tiles, the barriers
// (full and empty per stage), and 1024 bytes to align the base.
template <int XR, int S>
struct Smem {
  static constexpr int kX = XR * 128;
  static constexpr int kStage = kX + kWBytes;  // a multiple of 1024
  static constexpr int kB = S * kStage;
  static constexpr int kBars = kB + 2 * kBBytes;
  static constexpr int kBytes = kBars + 16 * S + 1024;
};

// stages of each design: the swap-AB kernel (few x rows) keeps more weight
// tiles in flight, and two of its CTAs share an SM up to 16 rows
template <bool kSwap, int XR>
__host__ __device__ constexpr int stages() {
  return kSwap && XR <= 16 ? 6 : 4;
}

// The dequantization rule of the tile of E (_dequant: float(q) * scale,
// rounded to x's dtype, bf16 or fp16), 8 weights -> one 16-byte row chunk
template <typename E>
__device__ __forceinline__ uint4 dequant8(uint2 raw, const float (&s)[8]) {
  float f[8];
  i8x4_to_float(raw.x, f);
  i8x4_to_float(raw.y, f + 4);
  uint4 v;
  v.x = pack2<E>(__fmul_rn(f[0], s[0]), __fmul_rn(f[1], s[1]));
  v.y = pack2<E>(__fmul_rn(f[2], s[2]), __fmul_rn(f[3], s[3]));
  v.z = pack2<E>(__fmul_rn(f[4], s[4]), __fmul_rn(f[5], s[5]));
  v.w = pack2<E>(__fmul_rn(f[6], s[6]), __fmul_rn(f[7], s[7]));
  return v;
}

// kSwap false (tiled, prefill; XR = 256): the CTA owns x rows [row0,
// row0 + 256) (128 per consumer warpgroup, as two m64 halves) and weight
// columns [n0, n0 + 128), over all of K: out = x W with wgmma
// m64n128k16, A = the x tile (K-major), B = the dequantized tile
// (MN-major). Grid (row tiles, column tiles): the row tiles of one column
// tile run side by side and share its weight tiles through the L2. The
// producer warpgroup gives its registers to the consumers (setmaxnreg),
// whose two accumulators take 128.
// kSwap true (swap-AB: decode, short prefills): the CTA owns weight
// columns [n0, n0 +
// 128) (64 per consumer warpgroup) and the K rows of one chunk,
// [kchunk * blockIdx.y, + kchunk): out^T = W^T x^T with wgmma m64nXRk16,
// A = the consumer's 64-column region of the dequantized tile (MN-major:
// the transpose flag), B = the x tile of XR rows (K-major). One chunk
// writes out directly; more write fp32 partials that a second kernel
// sums in chunk order.
template <typename E, bool kSwap, int XR>
__global__ void __launch_bounds__(kThreads, kSwap && XR <= 16 ? 2 : 1)
    int8_matmul_tc_kernel(const __grid_constant__ CUtensorMap mx,
                          const __grid_constant__ CUtensorMap mw,
                          const __grid_constant__ CUtensorMap mwo,
                          const float* __restrict__ scale,
                          E* __restrict__ out, float* __restrict__ partial,
                          int rows, int K, int N, int kchunk) {
  constexpr int S = stages<kSwap, XR>();
  using L = Smem<XR, S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full0 = base + L::kBars, empty0 = full0 + 8 * S;

  const int n0 = (kSwap ? blockIdx.x : blockIdx.y) * kNT;
  const int row0 = kSwap ? 0 : blockIdx.x * XR;
  const int k_begin = kSwap ? blockIdx.y * kchunk : 0;
  const int k_end = kSwap ? min(K, k_begin + kchunk) : K;
  const int ntiles = (k_end - k_begin + kKT - 1) / kKT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpad = N % 16, odd_pitch = kNT + 2 * wpad;  // 128 or 144 bytes

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
        mbar_arrive_expect_tx(bar, L::kX + kWHalf + kKT / 2 * odd_pitch);
        tma_load_2d(st, &mx, bar, k0, row0);
        tma_load_2d(st + L::kX, &mw, bar, n0, k0 / 2);
        tma_load_2d(st + L::kX + kWHalf, &mwo, bar, N + n0 - wpad, k0 / 2);
      }
    }
    return;
  }
  if constexpr (!kSwap) regs_claim<232>();

  // the consumer warpgroups. Dequantization: thread t owns the 8 columns
  // n0 + 8 (t % 16) .. + 7 (their scales in registers; 0 past N, where
  // the pair-row boxes hold the next row's codes) of the K rows t / 16 +
  // 16 m of each tile.
  const int t = threadIdx.x, g = t % 16, kr = t / 16;
  float sc[8];
  {
    const int n = n0 + 8 * g;
    const float4 lo = n < N ? *reinterpret_cast<const float4*>(scale + n)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hi = n < N ? *reinterpret_cast<const float4*>(scale + n + 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[0] = lo.x, sc[1] = lo.y, sc[2] = lo.z, sc[3] = lo.w;
    sc[4] = hi.x, sc[5] = hi.y, sc[6] = hi.z, sc[7] = hi.w;
  }
  // row k's 16-byte chunk of this thread's columns in the bf16 tile:
  // region g / 8, chunk g % 8 XOR-swizzled by k % 8
  const int b_region = (g / 8) * (kKT * 128), chunk = g % 8;
  auto dequant = [&](int it) {
    const uint8_t* wq = gbase + (it % S) * L::kStage + L::kX;
    uint8_t* dst = gbase + L::kB + (it & 1) * kBBytes + b_region;
#pragma unroll
    for (int m = 0; m < kKT / 16; ++m) {
      const int k = kr + 16 * m;
      const uint8_t* row = k & 1 ? wq + kWHalf + (k >> 1) * odd_pitch + wpad
                                 : wq + (k >> 1) * kNT;
      const uint2 raw = *reinterpret_cast<const uint2*>(row + 8 * g);
      *reinterpret_cast<uint4*>(dst + k * 128 + ((chunk ^ (k & 7)) << 4)) =
          dequant8<E>(raw, sc);
    }
  };

  const int wg = warp / 4, tw = t % 128;
  // accumulators: swap-AB one m64nXR tile; tiled two m64n128 tiles, rows
  // 128 wg + 64 i of the CTA's x rows
  constexpr int MI = kSwap ? 1 : 2, kAcc = kSwap ? XR / 2 : kNT / 2;
  float acc[MI][kAcc];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.0f;

  mbar_wait(full0, 0);
  dequant(0);
  fence_proxy_async();
  named_sync(1, kConsumers);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % S;
    const uint32_t sX = base + s * L::kStage;
    const uint32_t sB = base + L::kB + (it & 1) * kBBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      if constexpr (kSwap) {
        wgmma_ss_t<XR, 1, 0, E>(acc[0],
                                desc_mn_major<kKT>(sB + wg * kKT * 128, kk),
                                desc_k_major<XR>(sX, 0, kk), 1);
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i)
          wgmma_ss_t<kNT, 0, 1, E>(acc[i],
                                   desc_k_major<XR>(sX, 128 * wg + 64 * i, kk),
                                   desc_mn_major<kKT>(sB, kk), 1);
      }
    }
    wgmma_commit();
    // the next tile is dequantized while these products run (its bf16
    // tile was last read by the products of it - 1, finished)
    if (it + 1 < ntiles) {
      mbar_wait(full0 + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
      dequant(it + 1);
    }
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_regs(acc[i]);
    mbar_arrive(empty0 + 8 * s);
    fence_proxy_async();
    named_sync(1, kConsumers);
  }

  // the accumulator fragment of m64nW: thread tw holds fragment rows
  // (tw / 32) * 16 + (tw % 32) / 4 (entries 4j, 4j + 1) and that + 8
  // (entries 4j + 2, 4j + 3), columns 8j + 2 (tw % 4) + {0, 1}
  const int fr = (tw / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
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
        const float v = acc[0][4 * j + e];
        if (direct)
          out[(size_t)r * N + n] = ptt::from_float<E>(v);
        else
          partial[((size_t)blockIdx.y * rows + r) * N + n] = v;
      }
  } else {
#pragma unroll
    for (int j = 0; j < kNT / 8; ++j) {
      const int n = n0 + 8 * j + cq;  // N % 8 == 0: the pair is all in
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + 128 * wg + 64 * i + fr + 8 * half;
          if (r < rows)
            *reinterpret_cast<uint32_t*>(out + (size_t)r * N + n) =
                pack2<E>(acc[i][4 * j + 2 * half],
                         acc[i][4 * j + 2 * half + 1]);
        }
    }
  }
}

template <typename E, bool kSwap, int XR>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* out, void* partial, int rows, int K, int N,
                   int kchunk, cudaStream_t stream) {
  CUtensorMap mx, mw, mwo;
  cudaError_t err;
  const uint32_t odd_box = kNT + (N % 16 ? 16 : 0);
  if ((err = make_map_2d(&mx, map_type<E>(), x, K, rows,
                         (uint64_t)K * 2, 64, XR,
                         CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq,
                         (uint64_t)N * 2, K / 2, (uint64_t)N * 2, kNT,
                         kKT / 2, CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      (err = make_map_2d(&mwo, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq,
                         (uint64_t)N * 2, K / 2, (uint64_t)N * 2, odd_box,
                         kKT / 2, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return err;
  constexpr int smem = Smem<XR, stages<kSwap, XR>()>::kBytes;
  auto kernel = int8_matmul_tc_kernel<E, kSwap, XR>;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return err;
  const int col_tiles = (N + kNT - 1) / kNT;
  const int chunks = kSwap ? (K + kchunk - 1) / kchunk : 1;
  if (chunks > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const dim3 grid = kSwap ? dim3(col_tiles, chunks)
                          : dim3((rows + XR - 1) / XR, col_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      mx, mw, mwo, static_cast<const float*>(scale), static_cast<E*>(out),
      static_cast<float*>(partial), rows, K, N, kchunk);
  if (chunks == 1) return cudaGetLastError();
  if ((err = cudaGetLastError())) return err;
  const int count = rows * N;
  int8_matmul_split_sum_kernel<E><<<(count + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<E*>(out), chunks,
      count);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The CUDA-core design, fp32 x: x [rows, K], w_q int8 [K, N], scale
// fp32 [N], out fp32 [rows, N]. All contiguous and 16-byte aligned; K and
// N multiples of 8 (the Python wrapper checks). With rows <= 16 and K >
// kchunk, `partial` is fp32 scratch of ceil(K / kchunk) * rows * N.
extern "C" int ptt_int8_matmul(const void* x, const void* wq,
                               const void* scale, void* out, void* partial,
                               int rows, int K, int N, int kchunk,
                               void* stream) {
  if (rows == 0 || N == 0) return cudaSuccess;
  if (kchunk < 8 || kchunk % 8) return cudaErrorInvalidValue;
  return launch(static_cast<const float*>(x), static_cast<const int8_t*>(wq),
                static_cast<const float*>(scale), static_cast<float*>(out),
                static_cast<float*>(partial), rows, K, N, kchunk,
                static_cast<cudaStream_t>(stream));
}

// The tensor-core design, bf16 or fp16 x (x_dtype): x [rows, K], w_q int8
// [K, N], scale fp32 [N], out [rows, N] of x's dtype (the weight is
// dequantized to it); all contiguous and 16-byte aligned, K and N
// multiples of 8. swap_rows 0 runs the tiled kernel; 8, 16, 32, 64, 128
// or 256 the swap-AB kernel with an x tile of that many rows (>= rows),
// over K chunks of kchunk rows (a multiple of 64); with more than one
// chunk, `partial` is fp32 scratch of ceil(K / kchunk) * rows * N.
template <typename E>
cudaError_t int8_matmul_tc(const void* x, const void* wq, const void* scale,
                           void* out, void* partial, int rows, int K, int N,
                           int kchunk, int swap_rows, cudaStream_t s) {
  switch (swap_rows) {
    case 0:
      return tc::launch<E, false, 256>(x, wq, scale, out, partial, rows, K,
                                       N, kchunk, s);
    case 8:
      return tc::launch<E, true, 8>(x, wq, scale, out, partial, rows, K, N,
                                    kchunk, s);
    case 16:
      return tc::launch<E, true, 16>(x, wq, scale, out, partial, rows, K, N,
                                     kchunk, s);
    case 32:
      return tc::launch<E, true, 32>(x, wq, scale, out, partial, rows, K, N,
                                     kchunk, s);
    case 64:
      return tc::launch<E, true, 64>(x, wq, scale, out, partial, rows, K, N,
                                     kchunk, s);
    case 128:
      return tc::launch<E, true, 128>(x, wq, scale, out, partial, rows, K, N,
                                      kchunk, s);
    case 256:
      return tc::launch<E, true, 256>(x, wq, scale, out, partial, rows, K, N,
                                      kchunk, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int ptt_int8_matmul_tc(const void* x, const void* wq,
                                  const void* scale, void* out,
                                  void* partial, int rows, int K, int N,
                                  int kchunk, int swap_rows, int x_dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || N == 0) return cudaSuccess;
  if (K % 8 || N % 8 || kchunk < tc::kKT || kchunk % tc::kKT)
    return cudaErrorInvalidValue;
  if (swap_rows != 0 && rows > swap_rows) return cudaErrorInvalidValue;
  if (x_dtype == ptt::kF16)
    return int8_matmul_tc<__half>(x, wq, scale, out, partial, rows, K, N,
                                  kchunk, swap_rows, s);
  if (x_dtype == ptt::kBF16)
    return int8_matmul_tc<__nv_bfloat16>(x, wq, scale, out, partial, rows, K,
                                         N, kchunk, swap_rows, s);
  return cudaErrorInvalidValue;
}
