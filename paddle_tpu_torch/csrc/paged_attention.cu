// Paged decode attention for Hopper (sm_90a), over float arenas and over
// int8 arenas with per-(slot, kv head) fp32 scales.
//
// Replaces: paddle_tpu/kernels/paged_attention.py paged_attention_fused
// (pl.pallas_call at :341), float flavour _paged_kernel (:238) and int8
// flavour _paged_kernel_quant (:253), both over _paged_body (:190). One
// decode token per row attends the cache slots [0, pos] (inclusive: the
// slot written this step) that its page-table row addresses in the
// [N, page_size, kvH, D] arena:
//   scores = (q . k) * scale in fp32, exact softmax (max, exp, sum) over
//   the assembled row, probabilities rounded to q's dtype, then the value
//   product in fp32, cast to q's dtype. GQA is kv-head-major: query head
//   h reads kv head h / (H / kvH).
// The int8 flavour (ptt_paged_attention_int8_fwd) reads int8 K/V rows
// and their fp32 scales ([N, page_size, kvH]) and dequantizes in
// registers as float(q) * scale, in fp32 and without rounding to q's
// dtype, as the TPU kernel's load epilogue does (:262-263); the rest of
// the body is the float flavour's.
//
// What bounds it on the H100: bytes. Every live K and V element is read
// once and costs 2 flops (bf16: 1 flop per byte), so the floor is the
// live K/V bytes, sum_b (pos_b + 1) * kvH * D * 2 * 2 (int8: (D + 4)
// bytes per slot and kv head, with the scale), over 3.35 TB/s. The
// design therefore aims at keeping many wide, coalesced loads in flight;
// the arithmetic is incidental.
//
// Design (exact softmax, no split across CTAs; TMA, wgmma and split-K
// over long rows are later work):
// - one CTA of 8 warps per (kv head, row); the kv head's G query heads
//   are loaded once into shared memory as fp32;
// - only the pages holding slots <= pos are read (the TPU kernel walks
//   every table column and masks; skipping the masked ones is the same
//   function with fewer bytes), so the garbage page 0 in a table's unused
//   tail is never touched;
// - a slot's K or V row (D values) is spread over the 32 lanes of a warp,
//   D/32 contiguous values per lane, so one warp load moves the whole row
//   (256 B for bf16 at D = 128, 128 B for int8, plus one broadcast 4-byte
//   scale load); at D = 16 the first 16 lanes hold one value each and the
//   others hold zeros and load nothing; warp w takes kUnroll consecutive slots at a time
//   (kUnroll * 8 slots apart) and issues all their loads before using
//   any, ~64 bytes in flight per lane;
// - phase 1: each slot's G dot products are reduced with shuffles into an
//   fp32 score row kept in shared memory ([G, P * page_size] floats);
// - phase 2: block-wide max and sum per query head, probabilities
//   written back rounded to q's dtype;
// - phase 3: each warp accumulates p * V over its slots in registers;
//   the 8 partial rows are summed through shared memory per head.
// A row whose score row does not fit in shared memory is refused by the
// Python wrapper.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
template <typename TKV>
constexpr bool kQuant = std::is_same<TKV, int8_t>::value;

// The arena slot of logical slot t: page trow[t >> shift], offset
// t & (page_size - 1).
__device__ __forceinline__ size_t arena_slot(const int* trow, int t,
                                             int shift) {
  return ((size_t)trow[t >> shift] << shift) +
         (size_t)(t & ((1 << shift) - 1));
}

// Issue the loads of this lane's E values of the K or V row of arena slot
// `slot` (as fp32; zeros on a lane past the row, `on` false) and, for an
// int8 arena, of its (slot, kv head) scale.
template <typename TKV, int E>
__device__ __forceinline__ void load_row(const TKV* __restrict__ pages,
                                         const float* __restrict__ scales,
                                         size_t slot, size_t slot_stride,
                                         size_t head_off, int kvh,
                                         int kv_heads, bool on,
                                         float (&out)[E], float& s) {
  if (on) {
    ptt::load_floats<TKV, E>(pages + slot * slot_stride + head_off, out);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = 0.0f;
  }
  if constexpr (kQuant<TKV>) s = scales[slot * (size_t)kv_heads + kvh];
}

// Dequantize a loaded int8 row in registers: float(q) * scale in fp32,
// not rounded to q's dtype (a float row passes through).
template <typename TKV, int E>
__device__ __forceinline__ void dequant_row(float (&row)[E], float s) {
  if constexpr (kQuant<TKV>) {
#pragma unroll
    for (int e = 0; e < E; ++e) row[e] *= s;
  }
}

// D = head_dim; E = D / 32 values per lane (one at D = 16, on the first
// 16 lanes); MAXG >= query heads per kv head. k_scale / v_scale are read
// only for an int8 arena (TKV = int8_t).
template <typename TQ, typename TKV, int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pages,
                           const float* __restrict__ k_scale,
                           const TKV* __restrict__ v_pages,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ table,
                           const int* __restrict__ pos, TQ* __restrict__ out,
                           int heads, int kv_heads, int page_size,
                           int table_width, float scale) {
  constexpr int E = D >= 32 ? D / 32 : 1;
  // slots whose loads a warp issues before using any: about 64 bytes in
  // flight per lane whatever the dtype and head_dim, from 4 to 32 slots
  constexpr int kPer = 64 / (E * (int)sizeof(TKV));
  constexpr int kUnroll = kPer < 4 ? 4 : kPer > 32 ? 32 : kPer;
  extern __shared__ float smem[];
  __shared__ float scratch[32];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = heads / kv_heads;
  const int s_cap = table_width * page_size;
  const int shift = __ffs(page_size) - 1;  // page_size is a power of two
  float* q_s = smem;                 // [G, D]
  float* red = q_s + G * D;          // [kWarps, D] partial value rows
  float* s_s = red + kWarps * D;     // [G, s_cap] scores, then probs
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = lane * E;  // this lane's first head-dim column
  const bool on = col < D;   // false only past a D = 16 row

  int n = pos[b] + 1;  // live slots [0, pos]
  n = n > s_cap ? s_cap : n;
  const int* trow = table + (size_t)b * table_width;
  const size_t slot_stride = (size_t)kv_heads * D;  // elements per slot
  const size_t head_off = (size_t)kvh * D + col;

  const TQ* qb = q + ((size_t)b * heads + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = ptt::to_float(qb[i]);
  __syncthreads();

  // phase 1: scores. Loads past the row's end re-read its last slot
  // (always valid), so every load is issued unconditionally.
  for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
    float kv[kUnroll][E];
    float ks[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = min(t0 + u, n - 1);
      load_row<TKV, E>(k_pages, k_scale, arena_slot(trow, t, shift),
                       slot_stride, head_off, kvh, kv_heads, on, kv[u],
                       ks[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t >= n) break;  // warp-uniform
      dequant_row<TKV, E>(kv[u], ks[u]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc += on ? q_s[g * D + col + e] * kv[u][e] : 0.0f;
          acc = ptt::warp_sum(acc);
          if (lane == 0) s_s[g * s_cap + t] = acc * scale;
        }
      }
    }
  }
  __syncthreads();

  // phase 2: exact softmax per query head, rounded to q's dtype
  for (int g = 0; g < G; ++g) {
    float* row = s_s + g * s_cap;
    float m = -INFINITY;
    for (int t = tid; t < n; t += kThreads) m = fmaxf(m, row[t]);
    m = ptt::block_reduce<true>(m, scratch);
    float sum = 0.0f;
    for (int t = tid; t < n; t += kThreads) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    sum = ptt::block_reduce<false>(sum, scratch);
    for (int t = tid; t < n; t += kThreads)
      row[t] = ptt::to_float(ptt::from_float<TQ>(row[t] / sum));
  }
  __syncthreads();

  // phase 3: value product, per-warp partial rows in registers
  float acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
    float vv[kUnroll][E];
    float vs[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = min(t0 + u, n - 1);
      load_row<TKV, E>(v_pages, v_scale, arena_slot(trow, t, shift),
                       slot_stride, head_off, kvh, kv_heads, on, vv[u],
                       vs[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t >= n) break;
      dequant_row<TKV, E>(vv[u], vs[u]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = s_s[g * s_cap + t];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += p * vv[u][e];
        }
      }
    }
  }
  TQ* ob = out + ((size_t)b * heads + (size_t)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (on) {
#pragma unroll
        for (int e = 0; e < E; ++e) red[warp * D + col + e] = acc[g][e];
      }
      __syncthreads();
      for (int d = tid; d < D; d += kThreads) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w * D + d];
        ob[(size_t)g * D + d] = ptt::from_float<TQ>(s);
      }
      __syncthreads();
    }
  }
}

template <typename TQ, typename TKV, int D, int MAXG>
cudaError_t launch_g(const void* q, const void* k_pages, const void* k_scale,
                     const void* v_pages, const void* v_scale,
                     const void* table, const void* pos, void* out,
                     int batch, int heads, int kv_heads, int page_size,
                     int table_width, float scale, cudaStream_t stream) {
  const int G = heads / kv_heads;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)kWarps * D +
                       (size_t)G * table_width * page_size);
  auto kernel = paged_attention_kernel<TQ, TKV, D, MAXG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const float*>(k_scale), static_cast<const TKV*>(v_pages),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<TQ*>(out), heads, kv_heads,
      page_size, table_width, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(const void* q, const void* k_pages, const void* k_scale,
                     const void* v_pages, const void* v_scale,
                     const void* table, const void* pos, void* out,
                     int batch, int heads, int kv_heads, int page_size,
                     int table_width, float scale, cudaStream_t stream) {
  const int G = heads / kv_heads;
#define PTT_LAUNCH_G(MG)                                                    \
  return launch_g<TQ, TKV, D, MG>(q, k_pages, k_scale, v_pages, v_scale,    \
                                  table, pos, out, batch, heads, kv_heads,  \
                                  page_size, table_width, scale, stream)
  // one instantiation for MHA and one guarded one for every GQA group
  // up to 8 (idle register slots cost less than the build of each size)
  if (G == 1) PTT_LAUNCH_G(1);
  if (G <= 8) PTT_LAUNCH_G(8);
#undef PTT_LAUNCH_G
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pages, const void* k_scale,
                   const void* v_pages, const void* v_scale,
                   const void* table, const void* pos, void* out, int batch,
                   int heads, int kv_heads, int head_dim, int page_size,
                   int table_width, float scale, cudaStream_t stream) {
#define PTT_LAUNCH_D(D)                                                     \
  return launch_d<TQ, TKV, D>(q, k_pages, k_scale, v_pages, v_scale, table, \
                              pos, out, batch, heads, kv_heads, page_size,  \
                              table_width, scale, stream)
  if (head_dim == 16) PTT_LAUNCH_D(16);
  if (head_dim == 32) PTT_LAUNCH_D(32);
  if (head_dim == 64) PTT_LAUNCH_D(64);
  if (head_dim == 128) PTT_LAUNCH_D(128);
  if (head_dim == 256) PTT_LAUNCH_D(256);
#undef PTT_LAUNCH_D
  return cudaErrorInvalidValue;
}

}  // namespace

// q/out: [batch, 1, heads, head_dim] (q_dtype); k_pages/v_pages:
// [N, page_size, kv_heads, head_dim] (kv_dtype); table: int32 [batch,
// table_width]; pos: int32 [batch]. All contiguous and 16-byte aligned;
// head_dim in {16, 32, 64, 128, 256}; heads a multiple of kv_heads with at most
// 8 query heads per kv head; q_dtype equal to kv_dtype, or fp32 q over a
// bf16 arena (the Python wrapper checks).
extern "C" int ptt_paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* pos, void* out, int batch, int heads,
    int kv_heads, int head_dim, int page_size, int table_width, int q_dtype,
    int kv_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0) return cudaSuccess;
#define PTT_DISPATCH(TQ, TKV)                                                \
  return launch<TQ, TKV>(q, k_pages, nullptr, v_pages, nullptr, table, pos,  \
                         out, batch, heads, kv_heads, head_dim, page_size,   \
                         table_width, scale, s)
  if (q_dtype == ptt::kBF16 && kv_dtype == ptt::kBF16)
    PTT_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == ptt::kF32 && kv_dtype == ptt::kF32) PTT_DISPATCH(float, float);
  if (q_dtype == ptt::kF32 && kv_dtype == ptt::kBF16)
    PTT_DISPATCH(float, __nv_bfloat16);
#undef PTT_DISPATCH
  return cudaErrorInvalidValue;
}

// The int8 arena flavour: k_q/v_q int8 [N, page_size, kv_heads,
// head_dim], k_scale/v_scale fp32 [N, page_size, kv_heads]; q fp32 or
// bf16. Otherwise as ptt_paged_attention_fwd.
extern "C" int ptt_paged_attention_int8_fwd(
    const void* q, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* table, const void* pos, void* out,
    int batch, int heads, int kv_heads, int head_dim, int page_size,
    int table_width, int q_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0) return cudaSuccess;
#define PTT_DISPATCH(TQ)                                                      \
  return launch<TQ, int8_t>(q, k_q, k_scale, v_q, v_scale, table, pos, out,  \
                            batch, heads, kv_heads, head_dim, page_size,     \
                            table_width, scale, s)
  if (q_dtype == ptt::kBF16) PTT_DISPATCH(__nv_bfloat16);
  if (q_dtype == ptt::kF32) PTT_DISPATCH(float);
#undef PTT_DISPATCH
  return cudaErrorInvalidValue;
}
