// The three-part bf16 split of fp32 operands ("the split design"), shared
// by the kernels that reach fp32 precision on Hopper's bf16 tensor cores:
// flash attention's split kernels and the rope-on-load forward
// (flash_attention.cu), and the fp32 fused RMSNorm + matmul
// (fused_norm_matmul.cu).
//
// An fp32 value x is written as hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid); each difference is exact, so the three parts keep
// all 24 significant bits. A product a * b of two split operands is the
// six bf16 products of parts whose terms are larger than about 2^-22 of
// it (hi.lo, mid.mid, lo.hi, hi.mid, mid.hi, hi.hi), issued smallest first
// into fp32 accumulators; the three dropped terms (mid.lo, lo.mid, lo.lo)
// are below 2^-24 of the product. One part (NP = 1) is a bf16 operand
// taken as it is: only the last term, hi.hi. Two parts (NP = 2) are an
// fp16 value's hi = bf16(x) and lo = bf16(x - hi): fp16's 11 significant
// bits fit in the two parts' 8 + 8 and bf16's range holds fp16's, so hi +
// lo is x exactly, and the four terms of parts 0 and 1 (mid.mid, hi.mid,
// mid.hi, hi.hi in the order above: lo is the second part) give the
// product exactly.
#pragma once
#include "common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace split {

// the terms of a product, smallest first: (part of A, part of B)
__host__ __device__ constexpr int term_a(int t) {
  return t == 1 || t == 4 ? 1 : t == 2 ? 2 : 0;
}
__host__ __device__ constexpr int term_b(int t) {
  return t == 0 ? 2 : t == 1 || t == 3 ? 1 : 0;
}
// whether a product of NP-part operands takes term t (both its parts
// exist), and the first term it takes
template <int NP>
__host__ __device__ constexpr bool has_term(int t) {
  return term_a(t) < NP && term_b(t) < NP;
}
template <int NP>
__host__ __device__ constexpr int first_term() {
  return NP == 1 ? 5 : NP == 2 ? 1 : 0;
}

// the accumulator fragment of a score tile (to_a_operand's layout in
// flash_attention.cu) as NP register A operands: rounded to bf16 once
// (NP = 1, the stock kernel's astype), rounded to fp16 once (the same
// point for fp16 inputs) and written as its two exact bf16 parts (NP =
// 2), or split into hi, mid, lo (NP = 3)
template <int NP, int KSTEPS>
__device__ __forceinline__ void to_a_parts(const float* acc,
                                           uint32_t (&a)[NP][KSTEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = acc[8 * kk + 2 * i], y = acc[8 * kk + 2 * i + 1];
      if constexpr (NP == 2) {
        x = __half2float(__float2half_rn(x));
        y = __half2float(__float2half_rn(y));
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint32_t v = hopper::pack_bf16(x, y);
        a[p][kk][i] = v;
        x -= __uint_as_float(v << 16);  // a bf16 is its fp32's top half
        y -= __uint_as_float(v & 0xffff0000u);
      }
    }
}

// the NP bf16 parts (three by default) of 8 fp32 values into dst, dst +
// part, dst + 2 part (elements; 16-byte aligned): 16 bytes a part
template <int NP = 3>
__device__ __forceinline__ void store_parts8(__nv_bfloat16* dst,
                                             long long part, float (&v)[8]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = hopper::pack_bf16(v[2 * j], v[2 * j + 1]);
      v[2 * j] -= __uint_as_float(w[j] << 16);
      v[2 * j + 1] -= __uint_as_float(w[j] & 0xffff0000u);
    }
    *reinterpret_cast<uint4*>(dst + p * part) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The three bf16 parts of an fp32 (or bf16, fp16: T) [batch, seq, heads,
// d] tensor (read through its strides, d a multiple of 8) into the
// contiguous scratch [3, batch, seq, heads, D], columns d to D zero; NP =
// 2 writes the first two parts only, [2, batch, ...] (an fp16 tensor's
// exact two). A bf16 value becomes fp32 exactly and is its own hi part
// (mid and lo are zero). A thread splits 8 columns of a row. (A
// contiguous [K, N] matrix is batch 1, seq K, heads 1, d = D = N.)
// Static: every source that includes this header has its own copy.
template <typename T, int NP = 3>
static __global__ void split3_kernel(const T* __restrict__ x,
                                     __nv_bfloat16* __restrict__ out,
                                     Strides st, int batch, int seq,
                                     int heads, int d, int D) {
  const long long rows = (long long)batch * seq * heads;
  const int chunks = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * chunks) return;
  const long long row = i / chunks;  // (b * seq + s) * heads + h
  const int c = (int)(i % chunks) * 8;
  const int h = (int)(row % heads);
  const long long bs = row / heads;
  const int s = (int)(bs % seq), b = (int)(bs / seq);
  float v[8];
  if (c < d) {
    load_floats<T, 8>(x + b * st.b + s * st.s + h * st.h + c, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  }
  store_parts8<NP>(out + row * D + c, rows * D, v);
}

}  // namespace split
}  // namespace ptt
