// Rotary position embedding (neox half-split) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/rope.py rope_fused -> _rope_apply
// (pl.pallas_call at :60, body _rope_kernel at :21), forward, and its
// backward _rope_bwd (:85-88: the same kernel over the incoming gradient
// with -sin, the inverse rotation).
//   o1 = x1 * cos - x2 * sin,  o2 = x2 * cos + x1 * sin   (fp32)
// with x1 = x[..., :D/2], x2 = x[..., D/2:], cast back to x's type
// (fp32, bf16 or fp16: each element is rounded once, from fp32). The
// backward entry point (ptt_rope_bwd) is the same kernel instantiated
// with the sign of sin flipped in registers: no negated table is built.
//
// What bounds it on the H100: bytes (6 flops per 2 elements in and out).
// At decode ([8, 1, 32, 128]) the launch dominates.
//
// Design: one thread per 16-byte vector of the first half of a head row
// (8 bf16 or fp16, or 4 fp32) and the matching vector of the second half, so a
// warp reads and writes contiguous 512-byte runs. q and k are rotated in
// ONE launch (the grid covers heads_q + heads_k heads per token). The
// table row is found in the kernel: position_ids (when given) index the
// shared [rows, D/2] table directly, so the per-row gather the TPU path
// materialises before the kernel (incubate fused_rotary_position_embedding)
// never touches device memory. Products and sums use the _rn intrinsics,
// which the compiler never contracts into FMAs, so the result rounds as
// the plain PyTorch version does. A position past the table yields NaN,
// as jnp.take's fill mode does.
#include "common.cuh"

namespace {

template <typename T, bool kInverse>
__global__ void rope_kernel(const T* __restrict__ q, T* __restrict__ q_out,
                                int heads_q, const T* __restrict__ k,
                                T* __restrict__ k_out, int heads_k,
                                const float* __restrict__ cos_tab,
                                const float* __restrict__ sin_tab,
                                const int* __restrict__ pos_ids, int batch,
                                int seq, int head_dim, int tab_batch,
                                int tab_rows) {
  constexpr int V = 16 / (int)sizeof(T);
  const int half = head_dim / 2;
  const int nvec = half / V;
  const int heads = heads_q + heads_k;
  const long long total = (long long)batch * seq * heads * nvec;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int jv = (int)(idx % nvec);
  long long t = idx / nvec;
  const int h = (int)(t % heads);
  const long long bs = t / heads;  // token index b * seq + s
  const int b = (int)(bs / seq);
  const int s = (int)(bs % seq);

  const T* src;
  T* dst;
  if (h < heads_q) {
    const size_t off = ((size_t)bs * heads_q + h) * head_dim;
    src = q + off;
    dst = q_out + off;
  } else {
    const size_t off = ((size_t)bs * heads_k + (h - heads_q)) * head_dim;
    src = k + off;
    dst = k_out + off;
  }
  const int row = pos_ids != nullptr ? pos_ids[bs] : s;
  const int j0 = jv * V;

  float x1[V], x2[V], c[V], sn[V], o1[V], o2[V];
  ptt::load_floats<T, V>(src + j0, x1);
  ptt::load_floats<T, V>(src + half + j0, x2);
  if (row < 0 || row >= tab_rows) {
#pragma unroll
    for (int j = 0; j < V; ++j) o1[j] = o2[j] = NAN;
  } else {
    const size_t tab =
        ((size_t)(tab_batch == 1 ? 0 : b) * tab_rows + row) * half + j0;
    ptt::load_floats<float, V>(cos_tab + tab, c);
    ptt::load_floats<float, V>(sin_tab + tab, sn);
    if constexpr (kInverse) {
#pragma unroll
      for (int j = 0; j < V; ++j) sn[j] = -sn[j];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o1[j] = __fsub_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x2[j], sn[j]));
      o2[j] = __fadd_rn(__fmul_rn(x2[j], c[j]), __fmul_rn(x1[j], sn[j]));
    }
  }
  ptt::store_floats<T, V>(dst + j0, o1);
  ptt::store_floats<T, V>(dst + half + j0, o2);
}

template <typename T, bool kInverse>
cudaError_t launch(const void* q, void* q_out, int heads_q, const void* k,
                   void* k_out, int heads_k, const void* cos_tab,
                   const void* sin_tab, const void* pos_ids, int batch,
                   int seq, int head_dim, int tab_batch, int tab_rows,
                   cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long total = (long long)batch * seq * (heads_q + heads_k) *
                          (head_dim / 2 / V);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  rope_kernel<T, kInverse><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(q_out), heads_q,
      static_cast<const T*>(k), static_cast<T*>(k_out), heads_k,
      static_cast<const float*>(cos_tab), static_cast<const float*>(sin_tab),
      static_cast<const int*>(pos_ids), batch, seq, head_dim, tab_batch,
      tab_rows);
  return cudaGetLastError();
}

template <bool kInverse>
int dispatch(const void* q, void* q_out, int heads_q, const void* k,
             void* k_out, int heads_k, const void* cos_tab,
             const void* sin_tab, const void* pos_ids, int batch, int seq,
             int head_dim, int tab_batch, int tab_rows, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32)
    return launch<float, kInverse>(q, q_out, heads_q, k, k_out, heads_k,
                                   cos_tab, sin_tab, pos_ids, batch, seq,
                                   head_dim, tab_batch, tab_rows, s);
  if (dtype == ptt::kBF16)
    return launch<__nv_bfloat16, kInverse>(
        q, q_out, heads_q, k, k_out, heads_k, cos_tab, sin_tab, pos_ids,
        batch, seq, head_dim, tab_batch, tab_rows, s);
  if (dtype == ptt::kF16)
    return launch<__half, kInverse>(
        q, q_out, heads_q, k, k_out, heads_k, cos_tab, sin_tab, pos_ids,
        batch, seq, head_dim, tab_batch, tab_rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q/q_out: [batch, seq, heads_q, head_dim]; k/k_out likewise with heads_k
// (k may be null with heads_k == 0); cos/sin: fp32 [tab_batch, tab_rows,
// head_dim / 2], tab_batch 1 or batch; pos_ids: null or int32 [batch, seq]
// rows into a shared (tab_batch == 1) table. All contiguous and 16-byte
// aligned, head_dim / 2 a multiple of the vector width (Python checks).
extern "C" int ptt_rope_fwd(const void* q, void* q_out, int heads_q,
                            const void* k, void* k_out, int heads_k,
                            const void* cos_tab, const void* sin_tab,
                            const void* pos_ids, int batch, int seq,
                            int head_dim, int tab_batch, int tab_rows,
                            int dtype, void* stream) {
  return dispatch<false>(q, q_out, heads_q, k, k_out, heads_k, cos_tab,
                         sin_tab, pos_ids, batch, seq, head_dim, tab_batch,
                         tab_rows, dtype, stream);
}

// The backward: the incoming gradients of q and k (same layout as above)
// rotated by -theta.
extern "C" int ptt_rope_bwd(const void* dq, void* dq_out, int heads_q,
                            const void* dk, void* dk_out, int heads_k,
                            const void* cos_tab, const void* sin_tab,
                            const void* pos_ids, int batch, int seq,
                            int head_dim, int tab_batch, int tab_rows,
                            int dtype, void* stream) {
  return dispatch<true>(dq, dq_out, heads_q, dk, dk_out, heads_k, cos_tab,
                        sin_tab, pos_ids, batch, seq, head_dim, tab_batch,
                        tab_rows, dtype, stream);
}
