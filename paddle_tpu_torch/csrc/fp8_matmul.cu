// fp8 GEMM and fp8 quantization for Hopper (sm_90a): the products and
// the casts of AMP O3 (paddle_tpu_torch/amp/fp8.py).
//
//   fp8_gemm:     out[M, N] = (A[M, K] . Bt[N, K]^T) * (sa * sb), fp32 sums,
//                 rounded once to out's dtype (fp32, bf16 or fp16); A and
//                 Bt are e4m3 or e5m2 codes, sa and sb fp32 scalars in
//                 device memory.
//   fp8_quantize: q = fp8(clip(float(x) / scale, +-fmax)), round to nearest
//                 even, optionally also (or only) transposed, and optionally
//                 amax(|x|) as a side output.
//
// Replaces: no Pallas kernel. The JAX package leaves both to XLA:
// paddle_tpu/amp/fp8.py _fp8_dot (:127-175: dot_general on fp8 operands
// with fp32 accumulation, :135-139, :145-149, :160-168) and _quantize
// (:117) with the amaxes of fp8_linear_value (:195-202) and of the
// backward's gradient (:157). torch.matmul takes no fp8, and fp8 on the
// tensor cores is the point of O3 on this card, so the product is a kernel
// of its own.
//
// The three operand forms of one linear site (x [M, K], w [K, N], the
// gradient g [M, N]): wgmma reads 8-bit operands only K-major, so every
// operand is passed with its contraction axis contiguous:
//   forward  out = qx . qw       A = qx [M, K],  Bt = qw^T [N, K]   e4m3.e4m3
//   dX       dx  = qg . qw^T     A = qg [M, N],  Bt = qw  [K, N]    e5m2.e4m3
//   dW       dw  = qx^T . qg     A = qx^T [K, M], Bt = qg^T [N, M]  e4m3.e5m2
// The quantize kernel writes the transposed copies (qw^T, qx^T, qg^T)
// from the same pass that writes the codes.
//
// What bounds it on the H100: the GEMM, operations (1979 TFLOP/s dense
// fp8 on the tensor cores): 2 M N K at the 7B shapes (K 4096 or 11008);
// the quantize, bytes (x read once, the codes written once or twice).
//
// The GEMM's design (simple and right first; ROADMAP.md queue B lists
// what would make it fast): a CTA owns a 128 x 128 output tile over all of
// K (no split-K, so a repeat is bit-equal). Its producer warpgroup's first
// thread keeps k-tiles of 128 (one 128-byte swizzled row per operand row,
// one TMA box per operand) in flight through a ring of 4 stages
// (full/empty mbarrier pairs); the two consumer warpgroups own 64 rows
// each and run wgmma m64n128k32 on the arrived tiles. The fp32
// accumulator of Hopper's fp8 wgmma keeps only about 14 bits of mantissa,
// so each k-tile's four products (128 of K) go into a partial accumulator
// that is added to the fp32 registers of the tile after the products
// complete. The epilogue multiplies by sa * sb (computed first, as JAX
// does) and rounds once. Edges: TMA zero-fills rows and columns past M, N
// and K; stores are masked. K (the contraction, the operands' row length)
// must be a multiple of 16 (TMA's 16-byte row stride; the wrapper pads
// with zero columns) and the operands 16-byte aligned.
#include <cuda_fp8.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt::hopper;

constexpr int kBM = 128;  // output rows of a CTA (64 a consumer warpgroup)
constexpr int kBN = 128;  // output columns of a CTA
constexpr int kBK = 128;  // K of a k-tile: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kThreads = 384;    // two consumer warpgroups, one producer
constexpr int kConsumers = 256;
constexpr int kTileBytes = kBM * kBK;  // one operand's k-tile (16 KB)
static_assert(kBM == kBN, "one tile size for both operands");
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kSmemBytes = kBarOffset + 16 * kStages + 1024;

template <typename TO>
__device__ __forceinline__ void store_pair(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__half>(__half* p, float a,
                                                   float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f16(a, b);
}

// FA, FB: the operands' formats (0 e4m3, 1 e5m2); TO: out's type.
template <int FA, int FB, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    fp8_gemm_kernel(const __grid_constant__ CUtensorMap ma,
                    const __grid_constant__ CUtensorMap mb,
                    const float* __restrict__ sa, const float* __restrict__ sb,
                    TO* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + kBarOffset, empty0 = full0 + 8 * kStages;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ntiles = (K + kBK - 1) / kBK;
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
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t st = base + s * kStageBytes, bar = full0 + 8 * s;
        mbar_arrive_expect_tx(bar, kStageBytes);
        tma_load_2d(st, &ma, bar, it * kBK, m0);
        tma_load_2d(st + kTileBytes, &mb, bar, it * kBK, n0);
      }
    }
    return;
  }
  regs_claim<232>();

  const int wg = warp / 4;
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t sA = base + s * kStageBytes, sB = sA + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_fp8_n128<FA, FB>(part, desc_k_major<kBM>(sA, 64 * wg, kk),
                             desc_k_major<kBN>(sB, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    mbar_arrive(empty0 + 8 * s);
    // the promotion: 128 of K summed by the tensor cores, then in fp32
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
  }

  // the accumulator fragment of m64n128: thread tw holds rows (tw / 32) *
  // 16 + lane / 4 (entries 4j, 4j + 1) and that + 8 (entries 4j + 2, 4j +
  // 3), columns 8j + 2 (lane % 4) + {0, 1}
  const float scale = __fmul_rn(sa[0], sb[0]);
  const int tw = threadIdx.x % 128;
  const int fr = (tw / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = n0 + 8 * j + cq;
    if (c >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + 64 * wg + fr + 8 * half;
      if (r >= M) continue;
      const float v0 = __fmul_rn(acc[4 * j + 2 * half], scale);
      const float v1 = __fmul_rn(acc[4 * j + 2 * half + 1], scale);
      TO* p = out + (size_t)r * N + c;
      if (pairs) {
        store_pair<TO>(p, v0, v1);  // c even, N even: c + 1 < N, aligned
      } else {
        p[0] = ptt::from_float<TO>(v0);
        if (c + 1 < N) p[1] = ptt::from_float<TO>(v1);
      }
    }
  }
}

template <int FA, int FB, typename TO>
cudaError_t launch_gemm(const void* a, const void* bt, const float* sa,
                        const float* sb, void* out, int M, int N, int K,
                        cudaStream_t stream) {
  CUtensorMap ma, mb;
  cudaError_t err;
  if ((err = make_map_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, K, M,
                         (uint64_t)K, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = make_map_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, bt, K, N,
                         (uint64_t)K, kBK, kBN, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  auto kernel = fp8_gemm_kernel<FA, FB, TO>;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes)))
    return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      ma, mb, sa, sb, static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

template <int FA, int FB>
cudaError_t gemm_by_out(const void* a, const void* bt, const float* sa,
                        const float* sb, void* out, int M, int N, int K,
                        int out_dtype, cudaStream_t stream) {
  switch (out_dtype) {
    case ptt::kF32:
      return launch_gemm<FA, FB, float>(a, bt, sa, sb, out, M, N, K, stream);
    case ptt::kBF16:
      return launch_gemm<FA, FB, __nv_bfloat16>(a, bt, sa, sb, out, M, N, K,
                                                stream);
    case ptt::kF16:
      return launch_gemm<FA, FB, __half>(a, bt, sa, sb, out, M, N, K, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- quantize
// A CTA owns a 64 x 64 tile of x (256 threads, 16 values each: 4 rows of
// 4 contiguous columns, so a warp reads 2 rows of 64 contiguous values).
// The codes go to q directly and through shared memory to q^T; |x|'s
// largest value goes to amax by one atomicMax a warp on its bits (a
// non-negative float orders as its unsigned bits; a NaN, |x| with its sign
// cleared, is above every finite value and infinity, so it wins, as
// torch's amax propagates it).
constexpr int kQT = 64;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// q = round-to-nearest-even fp8 of clip(v / scale, +-fmax): a true
// division (not a multiply by the reciprocal, which would move codes); a
// NaN stays NaN (the clip passes it, as torch.clamp does)
__device__ __forceinline__ uint8_t fp8_code(float v, float scale, bool e5m2) {
  float y = __fdiv_rn(v, scale);
  const float fmax = e5m2 ? 57344.0f : 448.0f;
  if (!(y != y)) y = fminf(fmaxf(y, -fmax), fmax);
  return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, e5m2 ? __NV_E5M2 : __NV_E4M3);
}

template <typename T>
__global__ void __launch_bounds__(256)
    fp8_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                        uint8_t* __restrict__ qt,
                        unsigned* __restrict__ amax,
                        const float* __restrict__ scale, int rows, int cols,
                        int e5m2) {
  __shared__ uint8_t tile[kQT][kQT + 4];
  const int r0 = blockIdx.y * kQT, c0 = blockIdx.x * kQT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool codes = q != nullptr || qt != nullptr;
  const float s = codes ? scale[0] : 1.0f;
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (r >= rows || c >= cols) continue;
      const size_t at = (size_t)r * cols + c;
      const float v = ptt::to_float(x[at]);
      m = nanmax(fabsf(v), m);
      if (!codes) continue;
      const uint8_t code = fp8_code(v, s, e5m2 != 0);
      if (q) q[at] = code;
      tile[ty + 16 * i][4 * tx + j] = code;
    }
  }
  if (qt) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty + 16 * i;  // a row of q^T is a column of x
      if (c >= cols) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 4 * tx + j;
        if (r < rows) qt[(size_t)c * rows + r] = tile[4 * tx + j][ty + 16 * i];
      }
    }
  }
  if (amax) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = nanmax(__shfl_xor_sync(0xffffffffu, m, o), m);
    if (threadIdx.x % 32 == 0) atomicMax(amax, __float_as_uint(m));
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* qt, void* amax,
                            const void* scale, int rows, int cols, int e5m2,
                            cudaStream_t stream) {
  const dim3 grid((cols + kQT - 1) / kQT, (rows + kQT - 1) / kQT);
  fp8_quantize_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(q),
      static_cast<uint8_t*>(qt), static_cast<unsigned*>(amax),
      static_cast<const float*>(scale), rows, cols, e5m2);
  return cudaGetLastError();
}

}  // namespace

// out [M, N] (out_dtype: fp32, bf16 or fp16) = (a [M, K] . bt [N, K]^T) *
// (sa * sb); a's and bt's formats fa, fb (0 e4m3, 1 e5m2); sa, sb fp32
// scalars on the device. K a multiple of 16 (K > 0), a and bt contiguous
// and 16-byte aligned.
extern "C" int ptt_fp8_gemm(const void* a, const void* bt, const void* sa,
                            const void* sb, void* out, int M, int N, int K,
                            int fa, int fb, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || K % 16) return cudaErrorInvalidValue;
  const float* pa = static_cast<const float*>(sa);
  const float* pb = static_cast<const float*>(sb);
  if (fa == 0 && fb == 0)
    return gemm_by_out<0, 0>(a, bt, pa, pb, out, M, N, K, out_dtype, s);
  if (fa == 1 && fb == 0)
    return gemm_by_out<1, 0>(a, bt, pa, pb, out, M, N, K, out_dtype, s);
  if (fa == 0 && fb == 1)
    return gemm_by_out<0, 1>(a, bt, pa, pb, out, M, N, K, out_dtype, s);
  return cudaErrorInvalidValue;  // e5m2 . e5m2 is no form of the step
}

// x [rows, cols] (x_dtype: fp32, bf16 or fp16) -> q [rows, cols] and/or
// qt [cols, rows] codes (e4m3, or e5m2 when e5m2 != 0) of x / *scale;
// amax (fp32, zeroed by the caller) takes max |x|. Any of q, qt, amax may
// be null; with both q and qt null only the amax is computed (scale may
// then be null).
extern "C" int ptt_fp8_quantize(const void* x, void* q, void* qt, void* amax,
                                const void* scale, int rows, int cols,
                                int x_dtype, int e5m2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || cols == 0) return cudaSuccess;
  if ((q != nullptr || qt != nullptr) && scale == nullptr)
    return cudaErrorInvalidValue;
  if ((rows + kQT - 1) / kQT > 65535) return cudaErrorInvalidValue;
  switch (x_dtype) {
    case ptt::kF32:
      return launch_quantize<float>(x, q, qt, amax, scale, rows, cols, e5m2,
                                    s);
    case ptt::kBF16:
      return launch_quantize<__nv_bfloat16>(x, q, qt, amax, scale, rows, cols,
                                            e5m2, s);
    case ptt::kF16:
      return launch_quantize<__half>(x, q, qt, amax, scale, rows, cols, e5m2,
                                     s);
  }
  return cudaErrorInvalidValue;
}
