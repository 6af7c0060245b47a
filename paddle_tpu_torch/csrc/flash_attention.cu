// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/flash_attention.py flash_attention_fwd
// (:230), which on a TPU runs jax's stock Pallas flash attention
// (_pallas_fa :34): its forward pl.pallas_call (jax/experimental/pallas/
// ops/tpu/flash_attention.py:758), its dK/dV backward (:1121) and its dQ
// backward (:1456).
//
// q, k, v, dO: [B, S, H, D] (the paddle layout), read through their batch,
// sequence and head strides with no transposed copies; equal head counts
// (the Llama path repeats kv heads first). O, dQ, dK, dV are written
// contiguous [B, S, H, D]; LSE and the backward's Delta are fp32 [B, H, Sq].
//   forward:  S = Q K^T * scale, causal mask aligned bottom-right
//             (column c visible to row r iff c <= r + Sk - Sq, the
//             composed path's tril(k = Sk - Sq)), online softmax in fp32,
//             O = softmax(S) V, LSE = logsumexp(S) per row.
//   backward: Delta = rowsum(dO * O)                        (row pass)
//             P = exp(S - LSE), dS = P * (dO V^T - Delta)
//             dV = P^T dO, dK = dS^T Q * scale               (dK/dV pass)
//             dQ = dS K * scale                              (dQ pass)
// Every product and sum is fp32; outputs are cast once to the input type.
// The probabilities are not rounded to the input type before the value
// product (the composed path rounds them in bf16).
//
// What bounds it on the H100: operations. At S = 2048, D = 128 the
// forward does ~4*S*D flops per 2*D*2 bytes of q/k/v/o per row, two
// orders above the ridge; the card's bound is the tensor cores (989
// TFLOP/s bf16). This first kernel runs on the CUDA cores instead (fp32
// FMAs, 67 TFLOP/s at most), so it is far from that bound. wgmma, TMA
// and warp specialisation are later work.
//
// Design. The TPU kernel walks k-blocks in a sequential grid and carries
// the softmax state in VMEM scratch. Here one CTA of 256 threads owns a
// 64-row q-block (forward, dQ) or a 64-row k-block (dK/dV) and loops over
// the other side's 64-row blocks itself, from the causal start to the
// causal end. Tiles are staged in shared memory as fp32 with a row stride
// of D + 1 (the +1 keeps column reads of a tile on distinct banks). Each
// thread owns a 4 x 4 patch of the 64 x 64 score tile (rows ty*4+i,
// columns tx+16j) and a 4 x D/16 patch of the output rows; a row's max
// and sum are reduced over the 16 lanes that share it with shuffles. The
// backward is split in two passes so that every output element has one
// owner: no float atomics, and the gradients repeat bit for bit. Shared
// memory at D = 128: forward 116 KB, dK/dV 166 KB, dQ 149 KB (of 227 KB);
// D = 256 does not fit and is refused.
//
// Rope-on-load forward (ptt_rope_attention_fwd). Replaces: paddle_tpu/
// kernels/fused_rope_attention.py rope_attention_fused (:167;
// pl.pallas_call at :111 over _fused_kernel :84, _rotate :58, _attn_rows
// :69). The same forward kernel, instantiated with kRope: it rotates each
// q tile once and each k tile as it is loaded (neox half split, by the
// fp32 half-dim tables' row of that tile row's position), so the rotated
// q and k never exist in device memory. A lane loads a row's vector at
// column c together with the one at c + D/2 and the tables' entries c..,
// rotates in fp32 in _rotate's op order and stores both halves to the
// fp32 tile: the rotated values are never rounded to the input type, as
// _fused_kernel keeps them in VMEM. Self-attention only (Sq == Sk, so the
// causal mask is c <= r); no LSE is written, since the backward is the
// plain version's VJP (the JAX custom_vjp's design). The TPU kernel's
// softmax is exact over the whole row; this one is online, the same
// function summed in another order. What bounds it is as for the
// forward: operations, far from the tensor cores here.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;     // rows of a q-block and of a k-block
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLP = kBlock + 1;

struct Strides {
  long long b, s, h;  // elements
};

// rows [row0, row0 + 64) of one head (base already at (b, h)) into a fp32
// tile with row stride D + 1; rows at or past `seq` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ tile,
                                          const T* __restrict__ base,
                                          long long s_stride, int row0,
                                          int seq) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = D / V;
  for (int idx = threadIdx.x; idx < kBlock * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * V;
    float vals[V];
    if (row0 + r < seq) {
      ptt::load_floats<T, V>(base + (long long)(row0 + r) * s_stride + c,
                             vals);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) tile[r * (D + 1) + c + j] = vals[j];
  }
}

// As load_tile, with every row rotated by its position's table row
// (neox: out[:D/2] = x1 cos - x2 sin, out[D/2:] = x2 cos + x1 sin, fp32, in
// _rotate's op order, no fused multiply-add); cos/sin are fp32 [S, D/2]
// with row stride tab_stride (elements)
template <typename T, int D>
__device__ __forceinline__ void load_tile_rope(
    float* __restrict__ tile, const T* __restrict__ base, long long s_stride,
    int row0, int seq, const float* __restrict__ cos,
    const float* __restrict__ sin, long long tab_stride) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int H2 = D / 2;
  constexpr int kVecPerHalf = H2 / V;
  for (int idx = threadIdx.x; idx < kBlock * kVecPerHalf; idx += kThreads) {
    const int r = idx / kVecPerHalf;
    const int c = (idx % kVecPerHalf) * V;
    float o1[V], o2[V];
    if (row0 + r < seq) {
      const T* xr = base + (long long)(row0 + r) * s_stride;
      float x1[V], x2[V], cv[V], sv[V];
      ptt::load_floats<T, V>(xr + c, x1);
      ptt::load_floats<T, V>(xr + H2 + c, x2);
      const long long t = (long long)(row0 + r) * tab_stride + c;
      ptt::load_floats<float, V>(cos + t, cv);
      ptt::load_floats<float, V>(sin + t, sv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o1[j] = __fsub_rn(__fmul_rn(x1[j], cv[j]), __fmul_rn(x2[j], sv[j]));
        o2[j] = __fadd_rn(__fmul_rn(x2[j], cv[j]), __fmul_rn(x1[j], sv[j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o1[j] = o2[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      tile[r * (D + 1) + c + j] = o1[j];
      tile[r * (D + 1) + H2 + c + j] = o2[j];
    }
  }
}

// 64 fp32 values of a [B, H, S] row vector (zero past `seq`)
__device__ __forceinline__ void load_row_vec(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             int row0, int seq) {
  if (threadIdx.x < kBlock) {
    const int r = row0 + threadIdx.x;
    dst[threadIdx.x] = r < seq ? src[r] : 0.0f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a[r][c] (+)= sum_d x[r][d] * y[c][d] over the thread's 4 x 4 patch,
// r = ty*4+i, c = tx+16j (x, y: fp32 tiles with row stride D + 1)
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ x,
                                         const float* __restrict__ y,
                                         float (&a)[4][4], int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = x[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = y[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
  }
}

__device__ __forceinline__ bool visible(int r, int c, int sq, int sk,
                                        int causal) {
  return r < sq && c < sk && (!causal || c <= r + (sk - sq));
}

// ----------------------------------------------------------------- forward
// kRope: q and k rotated on load by the tables (cos, sin, tab_stride;
// unused otherwise); lse may be null (not written)
template <typename T, int D, bool kRope>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, int heads, int sq, int sk, float scale,
                     int causal, const float* __restrict__ cos,
                     const float* __restrict__ sin, long long tab_stride) {
  constexpr int LD = D + 1;
  constexpr int NO = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlock * LD;
  float* sV = sK + kBlock * LD;
  float* sP = sV + kBlock * LD;

  const int q0 = blockIdx.x * kBlock;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  if constexpr (kRope)
    load_tile_rope<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, cos, sin,
                         tab_stride);
  else
    load_tile<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[i][n] = 0.0f;
  }
  // columns past the last row's causal limit are never visible
  const int k_end = causal ? min(sk, q0 + kBlock + (sk - sq)) : sk;

  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // the previous block's readers are done
    if constexpr (kRope)
      load_tile_rope<T, D>(sK, kbase, ks.s, k0, sk, cos, sin, tab_stride);
    else
      load_tile<T, D>(sK, kbase, ks.s, k0, sk);
    load_tile<T, D>(sV, vbase, vs.s, k0, sk);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    tile_dot<D>(sQ, sK, s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        // rows past sq are padding: any finite value will do
        const bool ok = c < sk && (!causal || c <= r + (sk - sq));
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // finite from the first block on: column 0 is visible to every row
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) acc[i][n] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * kLP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float vv[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) vv[n] = sV[c * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty * 4 + i) * kLP + c];
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    T* orow = o + (((long long)b * sq + r) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      orow[tx + 16 * n] = ptt::from_float<T>(acc[i][n] / l[i]);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * heads + h) * sq + r] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------- backward: Delta
// one warp per (b, row, h): Delta = sum_d dO * O in fp32
template <typename T, int D>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, Strides os,
                                       Strides dos, int batch, int heads,
                                       int sq) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * heads * sq) return;
  const int h = (int)(row % heads);
  const int r = (int)((row / heads) % sq);
  const int b = (int)(row / ((long long)heads * sq));
  const T* orow = o + b * os.b + (long long)r * os.s + h * os.h;
  const T* grow = dout + b * dos.b + (long long)r * dos.s + h * dos.h;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc += ptt::to_float(grow[d]) * ptt::to_float(orow[d]);
  acc = ptt::warp_sum(acc);
  if (lane == 0) delta[((long long)b * heads + h) * sq + r] = acc;
}

// ------------------------------------------------------- backward: dK, dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, Strides qs,
                          Strides ks, Strides vs, Strides dos, int heads,
                          int sq, int sk, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int NO = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBlock * LD;
  float* sQ = sV + kBlock * LD;
  float* sG = sQ + kBlock * LD;  // dO
  float* sP = sG + kBlock * LD;
  float* sS = sP + kBlock * kLP;  // dS
  float* sL = sS + kBlock * kLP;  // LSE of the q-block's rows
  float* sD = sL + kBlock;        // Delta of the q-block's rows

  const int k0 = blockIdx.x * kBlock;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long rowvec = ((long long)b * heads + h) * sq;

  load_tile<T, D>(sK, k + b * ks.b + h * ks.h, ks.s, k0, sk);
  load_tile<T, D>(sV, v + b * vs.b + h * vs.h, vs.s, k0, sk);
  const T* qbase = q + b * qs.b + h * qs.h;
  const T* gbase = dout + b * dos.b + h * dos.h;

  float adk[4][NO], adv[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NO; ++n) adk[i][n] = adv[i][n] = 0.0f;

  // the first row that sees column k0 is k0 - (sk - sq)
  int q_first = causal ? k0 - (sk - sq) : 0;
  q_first = q_first < 0 ? 0 : (q_first / kBlock) * kBlock;

  for (int q0 = q_first; q0 < sq; q0 += kBlock) {
    __syncthreads();
    load_tile<T, D>(sQ, qbase, qs.s, q0, sq);
    load_tile<T, D>(sG, gbase, dos.s, q0, sq);
    load_row_vec(sL, lse + rowvec, q0, sq);
    load_row_vec(sD, delta + rowvec, q0, sq);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    tile_dot<D>(sQ, sK, s, tx, ty);   // rows: q, columns: k
    tile_dot<D>(sG, sV, dp, tx, ty);  // dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j;
        const float p = visible(q0 + ri, k0 + cj, sq, sk, causal)
                            ? expf(s[i][j] * scale - sL[ri])
                            : 0.0f;
        sP[ri * kLP + cj] = p;
        sS[ri * kLP + cj] = p * (dp[i][j] - sD[ri]);
      }
    }
    __syncthreads();
    // this thread's k rows c = ty*4+i, columns tx+16n
#pragma unroll 2
    for (int r = 0; r < kBlock; ++r) {
      float gv[NO], qv[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        gv[n] = sG[r * LD + tx + 16 * n];
        qv[n] = sQ[r * LD + tx + 16 * n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[r * kLP + ty * 4 + i];
        const float ds = sS[r * kLP + ty * 4 + i];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          adv[i][n] = fmaf(p, gv[n], adv[i][n]);
          adk[i][n] = fmaf(ds, qv[n], adk[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= sk) continue;
    const long long off = (((long long)b * sk + c) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      dk[off + tx + 16 * n] = ptt::from_float<T>(adk[i][n] * scale);
      dv[off + tx + 16 * n] = ptt::from_float<T>(adv[i][n]);
    }
  }
}

// ------------------------------------------------------------ backward: dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        int heads, int sq, int sk, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int NO = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kBlock * LD;
  float* sK = sG + kBlock * LD;
  float* sV = sK + kBlock * LD;
  float* sS = sV + kBlock * LD;
  float* sL = sS + kBlock * kLP;
  float* sD = sL + kBlock;

  const int q0 = blockIdx.x * kBlock;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long rowvec = ((long long)b * heads + h) * sq;

  load_tile<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_tile<T, D>(sG, dout + b * dos.b + h * dos.h, dos.s, q0, sq);
  load_row_vec(sL, lse + rowvec, q0, sq);
  load_row_vec(sD, delta + rowvec, q0, sq);
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  float adq[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NO; ++n) adq[i][n] = 0.0f;
  const int k_end = causal ? min(sk, q0 + kBlock + (sk - sq)) : sk;

  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();
    load_tile<T, D>(sK, kbase, ks.s, k0, sk);
    load_tile<T, D>(sV, vbase, vs.s, k0, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    tile_dot<D>(sQ, sK, s, tx, ty);
    tile_dot<D>(sG, sV, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j;
        const float p = visible(q0 + ri, k0 + cj, sq, sk, causal)
                            ? expf(s[i][j] * scale - sL[ri])
                            : 0.0f;
        sS[ri * kLP + cj] = p * (dp[i][j] - sD[ri]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float kv[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) kv[n] = sK[c * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sS[(ty * 4 + i) * kLP + c];
#pragma unroll
        for (int n = 0; n < NO; ++n) adq[i][n] = fmaf(ds, kv[n], adq[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const long long off = (((long long)b * sq + r) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      dq[off + tx + 16 * n] = ptt::from_float<T>(adq[i][n] * scale);
  }
}

// ---------------------------------------------------------------- launches
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kBlock * (D + 1) + kBlock * kLP);
}
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + 2 * kBlock * kLP + 2 * kBlock);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * kLP + 2 * kBlock);
}

// dynamic shared memory above 48 KB has to be allowed per kernel
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  Strides qs, ks, vs;
  int batch, heads, sq, sk, causal;
  float scale;
  const void *cos, *sin;  // the rope tables (rope-on-load only)
  long long tab_stride;
};

template <typename T, int D, bool kRope>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  cudaError_t err =
      allow_smem(flash_fwd_kernel<T, D, kRope>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kBlock - 1) / kBlock, a.batch * a.heads);
  flash_fwd_kernel<T, D, kRope><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.qs, a.ks, a.vs, a.heads, a.sq, a.sk,
      a.scale, a.causal, static_cast<const float*>(a.cos),
      static_cast<const float*>(a.sin), a.tab_stride);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos;
  int batch, heads, sq, sk, causal;
  float scale;
};

template <typename T, int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.batch * a.heads * a.sq;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                  stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), a.os, a.dos, a.batch, a.heads, a.sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(flash_bwd_dkdv_kernel<T, D>, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid_k((a.sk + kBlock - 1) / kBlock, a.batch * a.heads);
  flash_bwd_dkdv_kernel<T, D><<<grid_k, kThreads, dkdv_smem<D>(), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks, a.vs, a.dos,
      a.heads, a.sq, a.sk, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(flash_bwd_dq_kernel<T, D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid_q((a.sq + kBlock - 1) / kBlock, a.batch * a.heads);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.heads, a.sq, a.sk,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <template <typename, int> class F, typename Args>
cudaError_t dispatch(const Args& a, int head_dim, int dtype,
                     cudaStream_t s) {
  if (dtype == ptt::kF32) {
    if (head_dim == 64) return F<float, 64>::run(a, s);
    if (head_dim == 128) return F<float, 128>::run(a, s);
  } else if (dtype == ptt::kBF16) {
    if (head_dim == 64) return F<__nv_bfloat16, 64>::run(a, s);
    if (head_dim == 128) return F<__nv_bfloat16, 128>::run(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
struct Fwd {
  static cudaError_t run(const FwdArgs& a, cudaStream_t s) {
    return launch_fwd<T, D, false>(a, s);
  }
};
template <typename T, int D>
struct RopeFwd {
  static cudaError_t run(const FwdArgs& a, cudaStream_t s) {
    return launch_fwd<T, D, true>(a, s);
  }
};
template <typename T, int D>
struct Bwd {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) {
    return launch_bwd<T, D>(a, s);
  }
};

}  // namespace

// q: [batch, sq, heads, head_dim], k and v: [batch, sk, heads, head_dim],
// each with its (batch, seq, head) strides in elements and a unit stride
// over head_dim; all strides multiples of the 16-byte vector width and the
// pointers 16-byte aligned. o: contiguous [batch, sq, heads, head_dim] of
// q's type; lse: fp32 [batch, heads, sq]. head_dim 64 or 128; sk >= sq
// when causal (the Python wrapper checks all of this).
extern "C" int ptt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int sq, int sk, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, int dtype, void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return cudaSuccess;
  FwdArgs a{q, k, v, o, lse, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
            {v_sb, v_ss, v_sh}, batch, heads, sq, sk, causal, scale,
            nullptr, nullptr, 0};
  return dispatch<Fwd>(a, head_dim, dtype, static_cast<cudaStream_t>(stream));
}

// Rope-on-load forward: q, k, v [batch, seq, heads, head_dim] with their
// strides as above (one sequence length); cos and sin fp32 [seq,
// head_dim / 2] with row stride tab_stride (a multiple of 4, 16-byte
// aligned); o contiguous [batch, seq, heads, head_dim] of q's type. No
// LSE. head_dim 64 or 128 (the Python wrapper checks all of this).
extern "C" int ptt_rope_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* cos,
    const void* sin, long long tab_stride, int batch, int heads, int seq,
    int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, float scale, int dtype,
    void* stream) {
  if (batch == 0 || heads == 0 || seq == 0) return cudaSuccess;
  FwdArgs a{q, k, v, o, nullptr, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
            {v_sb, v_ss, v_sh}, batch, heads, seq, seq, causal, scale,
            cos, sin, tab_stride};
  return dispatch<RopeFwd>(a, head_dim, dtype,
                           static_cast<cudaStream_t>(stream));
}

// The three backward passes in order (Delta, dK/dV, dQ). o and dout have
// q's shape, lse is the forward's; delta is fp32 scratch [batch, heads,
// sq]; dq, dk, dv are contiguous with the shapes of q, k, v.
extern "C" int ptt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int heads, int sq, int sk, int head_dim,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long g_sb, long long g_ss, long long g_sh, int causal, float scale,
    int dtype, void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return cudaSuccess;
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
            {o_sb, o_ss, o_sh}, {g_sb, g_ss, g_sh},
            batch, heads, sq, sk, causal, scale};
  return dispatch<Bwd>(a, head_dim, dtype, static_cast<cudaStream_t>(stream));
}
