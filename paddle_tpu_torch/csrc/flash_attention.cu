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
//             P = exp(S - LSE), dS = P * (dO V^T - Delta) * scale
//             dV = P^T dO, dK = dS^T Q                       (dK/dV pass)
//             dQ = dS K                                      (dQ pass)
// Scores, softmax and sums are fp32; outputs are cast once to the input
// type. P (before the value product and dV) and dS (before dK and dQ) are
// rounded to the input type, at the stock kernel's four points
// (p.astype(v.dtype) :471, p.T.astype :900, ds.T.astype :918,
// ds.astype(k.dtype) :1258; a no-op in fp32).
//
// What bounds it on the H100: operations. At S = 2048, D = 128 the
// forward does ~4*S*D flops per 2*D*2 bytes of q/k/v/o per row, two
// orders above the ridge; the card's bound is the tensor cores (989
// TFLOP/s bf16).
//
// Two designs, chosen by the inputs' dtype (ptt_flash_attention_fwd/_bwd):
//
// bf16: the tensor-core design (namespace tc, below; hopper.cuh). Every
// product is wgmma with fp32 accumulators; tiles arrive by TMA into
// 128-byte-swizzled shared memory, two stages in flight, issued by one
// warp of a producer warpgroup beside two consumer warpgroups (setmaxnreg
// moves the producer's registers to them); the softmax runs in registers
// on the accumulator fragment, and P / dS are rounded to bf16 in
// registers and fed back as wgmma's A operand (the rounding points
// above). Forward: a
// CTA owns 128 q rows and walks k/v blocks of 128. Backward: the Delta
// row pass, a dK/dV pass (a CTA owns 128 k rows and walks q blocks of 64)
// and a dQ pass (a CTA owns 128 q rows and walks k blocks of 64): two
// passes recompute S and dP (14 D flops per visible pair, not 10) so
// that every output element has one owner: no float atomics, and the
// gradients repeat bit for bit. Causal blocks wholly above the diagonal
// are skipped; only blocks that cross it or the ragged end are masked.
//
// fp32: the CUDA-core design (the port's first flash kernels, below).
// The tensor cores take fp32 only as TF32 (about three decimal digits),
// and the fp32 models are held to 1e-5 against the CPU, so fp32 runs on
// the CUDA cores (fp32 FMAs, 67 TFLOP/s at most). One CTA of 256 threads
// owns a 64-row q-block (forward, dQ) or a 64-row k-block (dK/dV) and
// loops over the other side's 64-row blocks itself, from the causal start
// to the causal end. Tiles are staged in shared memory as fp32 with a row
// stride of D + 1 (the +1 keeps column reads of a tile on distinct
// banks). Each thread owns a 4 x 4 patch of the 64 x 64 score tile (rows
// ty*4+i, columns tx+16j) and a 4 x D/16 patch of the output rows; a
// row's max and sum are reduced over the 16 lanes that share it with
// shuffles. The same two backward passes, no atomics. Shared memory at D
// = 128: forward 116 KB, dK/dV 166 KB, dQ 149 KB (of 227 KB); D = 256
// does not fit and is refused.
//
// Rope-on-load forward (ptt_rope_attention_fwd, fp32 and bf16). Replaces:
// paddle_tpu/kernels/fused_rope_attention.py rope_attention_fused (:167;
// pl.pallas_call at :111 over _fused_kernel :84, _rotate :58, _attn_rows
// :69). The CUDA-core forward, instantiated with kRope: it rotates each
// q tile once and each k tile as it is loaded (neox half split, by the
// fp32 half-dim tables' row of that tile row's position), so the rotated
// q and k never exist in device memory. A lane loads a row's vector at
// column c together with the one at c + D/2 and the tables' entries c..,
// rotates in fp32 in _rotate's op order and stores both halves to the
// fp32 tile: the rotated values are never rounded to the input type, as
// _fused_kernel keeps them in VMEM (so it stays on the CUDA cores in
// bf16 too). Self-attention only (Sq == Sk, so the causal mask is c <=
// r); no LSE is written, since the backward is the plain version's VJP
// (the JAX custom_vjp's design). The TPU kernel's softmax is exact over
// the whole row; this one is online, the same function summed in another
// order.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ============================================ fp32 (and rope): CUDA cores
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

// ================================================ bf16: tensor-core design
// (ptt::hopper: TMA into 128-byte-swizzled tiles, wgmma with fp32
// accumulators). A CTA has two consumer warpgroups, each owning 64 rows of
// the side it keeps (q rows in the forward and dQ passes, k rows in the
// dK/dV pass), and a producer warpgroup of which one warp keeps the
// other side's tiles in flight through a two-stage ring (full/empty
// mbarrier pair per stage).
// Every product of a bf16 tile is wgmma; the second product of each pass
// takes the rounded P or dS tile from registers as wgmma's A operand.
namespace tc {

using bf16 = __nv_bfloat16;
using namespace ptt::hopper;

constexpr int kConsumers = 2;                    // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kStages = 2;
// Registers: 384 threads get 168 each at launch (65,536 / 384, in steps
// of 8). The producer warpgroup gives back all but 24 and the consumers
// take 240 (24 x 128 + 240 x 256 = 64,512 = 168 x 384). The dK/dV pass
// holds two D/2 accumulators and two 32-entry score tiles: at D = 128
// it spills 448 bytes at 168 registers and still 312 at 240, and ptxas
// serialises its wgmma there (C7512).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// rows of a k/v block in the forward
constexpr int kFwdKeys = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bytes of a tile of `rows` x D bf16 values
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// A kernel's shared memory (bytes): the resident tiles, kStages stages,
// `extra` bytes of fp32 row vectors, then the mbarriers (resident, full x
// kStages, empty x kStages), and 1024 bytes to align the base.
struct Layout {
  int resident, stage, extra;
  __host__ __device__ constexpr int stage_at(int s) const {
    return resident + s * stage;
  }
  __host__ __device__ constexpr int extra_at() const {
    return stage_at(kStages);
  }
  __host__ __device__ constexpr int bars_at() const {
    return extra_at() + extra;
  }
  __host__ __device__ constexpr int bytes() const {
    return bars_at() + 8 * (1 + 2 * kStages) + 1024;
  }
};

// forward: Q (128 rows) resident, K and V blocks of kFwdKeys rows per
// stage
template <int D>
__host__ __device__ constexpr Layout fwd_layout() {
  return {tile_bytes<D>(128), 2 * tile_bytes<D>(kFwdKeys), 0};
}
// dK/dV: K and V (128 rows) resident, Q and dO blocks of 64 rows per
// stage, and each stage's LSE and Delta (64 fp32 each)
template <int D>
__host__ __device__ constexpr Layout dkdv_layout() {
  return {2 * tile_bytes<D>(128), 2 * tile_bytes<D>(64), kStages * 2 * 64 * 4};
}
// dQ: Q and dO (128 rows) resident, K and V blocks of 64 rows per stage
template <int D>
__host__ __device__ constexpr Layout dq_layout() {
  return {2 * tile_bytes<D>(128), 2 * tile_bytes<D>(64), 0};
}

struct Bars {
  uint32_t resident, full0, empty0;
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};

// aligned base of the dynamic shared memory, and the barriers initialised:
// the resident tiles' barrier takes one arrival and its transaction bytes,
// each full barrier `full_count` arrivals and its bytes, each empty
// barrier one arrival per consumer thread
__device__ __forceinline__ uint32_t setup(uint8_t* raw, const Layout& L,
                                          int full_count, Bars& bars) {
  const uint32_t base = (smem_addr(raw) + 1023u) & ~1023u;
  const uint32_t b = base + L.bars_at();
  bars = Bars{b, b + 8, b + 8 + 8 * kStages};
  if (threadIdx.x == 0) {
    mbar_init(bars.resident, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full(s), full_count);
      mbar_init(bars.empty(s), 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return base;
}

// the accumulator fragment of wgmma m64nN (fp32): thread t of the
// warpgroup holds, for each 8-column block j, rows (t / 32) * 16 + (t %
// 32) / 4 (entries 4j, 4j+1) and that + 8 (entries 4j+2, 4j+3), columns
// 8j + 2 (t % 4) + {0, 1}. Two neighbouring blocks are exactly the
// register A fragment of a k-step of 16: k-step kk of a score tile is
// entries [8 kk, 8 kk + 8) rounded to bf16 pairs (the stock kernel's
// p.astype / ds.astype).
template <int KSTEPS>
__device__ __forceinline__ void to_a_operand(const float* acc,
                                             uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// 2^x in fp32 (the softmax runs in the log2 domain): the MUFU
// approximation, within 2 ulp; results below 2^-126 flush to zero. The
// accurate exp2f's extra registers made ptxas serialise the forward's
// wgmma (C7512) at D = 128.
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// one output row of a thread's accumulator (entries 4j + half*2 + {0,1})
// to a contiguous bf16 [.., D] row, times `mul`
template <int D>
__device__ __forceinline__ void store_row(bf16* __restrict__ row,
                                          const float (&acc)[D / 2], int half,
                                          int cq, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(row + 8 * j + cq) =
        pack_bf16(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
}

// ----------------------------------------------------------------- forward
// A CTA owns 128 q rows (64 per consumer warpgroup, Q resident) and walks
// the k/v blocks of 128 rows from 0 to its causal end. Per block and
// warpgroup: S = Q K^T (wgmma m64n128k16, both operands K-major in
// shared memory), scale and mask in registers, online softmax in the
// log2 domain (a row's max and sum over the 4 lanes of a quad), P =
// exp2(S - m) rounded to bf16 in registers (unnormalised, tile by tile,
// as the stock kernel's p.astype(v.dtype)) and O += P V (wgmma
// m64nDk16, P from registers, V MN-major). l sums the unrounded p.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        bf16* __restrict__ o, float* __restrict__ lse,
                        int heads, int sq, int sk, float scale_log2,
                        int causal) {
  constexpr int kM = 128, kN = kFwdKeys;
  constexpr Layout L = fwd_layout<D>();
  extern __shared__ uint8_t smem_raw[];
  Bars bars;
  const uint32_t base = setup(smem_raw, L, 1, bars);
  const uint32_t sQ = base;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // longest rows first
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k_end = causal ? min(sk, q0 + kM + sk - sq) : sk;
  const int nblk = (k_end + kN - 1) / kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one warp loads
    regs_release<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_arrive_expect_tx(bars.resident, tile_bytes<D>(kM));
      tma_load_tile<kM, D>(sQ, &mq, bars.resident, h, q0, b);
      for (int it = 0; it < nblk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(bars.empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t sK = base + L.stage_at(s);
        mbar_arrive_expect_tx(bars.full(s), L.stage);
        tma_load_tile<kN, D>(sK, &mk, bars.full(s), h, it * kN, b);
        tma_load_tile<kN, D>(sK + tile_bytes<D>(kN), &mv, bars.full(s), h,
                             it * kN, b);
      }
    }
  } else {  // the consumer warpgroups
    regs_claim<kConsumerRegs>();

    const int wg = warp / 4, t = threadIdx.x % 128;
    const int wrow = q0 + 64 * wg;  // this warpgroup's first row
    const int ra = wrow + (t / 32) * 16 + lane / 4, rb = ra + 8;
    const int cq = 2 * (lane % 4);
    const bool live = wrow < sq;
    const int shift = sk - sq;  // row r sees column c iff c <= r + shift
    const int last_col =
        causal ? min(sk - 1, min(wrow + 63, sq - 1) + shift) : sk - 1;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float ma = -INFINITY, mb = -INFINITY, la = 0.0f, lb = 0.0f;

    mbar_wait(bars.resident, 0);
    for (int it = 0; it < nblk; ++it) {
      const int s = it % kStages;
      const int k0 = it * kN;
      const uint32_t sK = base + L.stage_at(s);
      const uint32_t sV = sK + tile_bytes<D>(kN);
      mbar_wait(bars.full(s), (it / kStages) & 1);
      // blocks wholly past this warpgroup's last visible column are skipped
      if (live && k0 <= last_col) {
        float sc[kN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kN>(sc, desc_k_major<kM>(sQ, 64 * wg, kk),
                        desc_k_major<kN>(sK, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        // only blocks that cross the last key or the diagonal are masked;
        // zero-filled rows past sk give scores of 0, so they are masked too
        const bool mask =
            k0 + kN > sk || (causal && k0 + kN - 1 > wrow + shift);
        float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float va = sc[4 * j + e] * scale_log2;
            float vb = sc[4 * j + 2 + e] * scale_log2;
            if (mask) {
              const int c = k0 + 8 * j + cq + e;
              if (c >= sk || (causal && c > ra + shift)) va = -INFINITY;
              if (c >= sk || (causal && c > rb + shift)) vb = -INFINITY;
            }
            sc[4 * j + e] = va;
            sc[4 * j + 2 + e] = vb;
            mxa = fmaxf(mxa, va);
            mxb = fmaxf(mxb, vb);
          }
        // finite from the first block on: column 0 is visible to every row
        const float na = fmaxf(ma, quad_max(mxa));
        const float nb = fmaxf(mb, quad_max(mxb));
        const float alpha_a = exp2_(ma - na), alpha_b = exp2_(mb - nb);
        ma = na;
        mb = nb;
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[4 * j + e] = exp2_(sc[4 * j + e] - na);
            sc[4 * j + 2 + e] = exp2_(sc[4 * j + 2 + e] - nb);
            sa += sc[4 * j + e];
            sb += sc[4 * j + 2 + e];
          }
        // per-thread partial sums; the quad's are added at the end
        la = la * alpha_a + sa;
        lb = lb * alpha_b + sb;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= alpha_a;
          acc[4 * j + 1] *= alpha_a;
          acc[4 * j + 2] *= alpha_b;
          acc[4 * j + 3] *= alpha_b;
        }
        uint32_t p[kN / 16][4];
        to_a_operand<kN / 16>(sc, p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs<D>(acc, p[kk], desc_mn_major<kN>(sV, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(p);
      }
      mbar_arrive(bars.empty(s));
    }

    if (!live) return;
    la = quad_sum(la);
    lb = quad_sum(lb);
    const long long rowvec = ((long long)b * heads + h) * sq;
    if (ra < sq) {
      store_row<D>(o + (((long long)b * sq + ra) * heads + h) * D, acc, 0, cq,
                   1.0f / la);
      if (cq == 0) lse[rowvec + ra] = ma * kLn2 + logf(la);
    }
    if (rb < sq) {
      store_row<D>(o + (((long long)b * sq + rb) * heads + h) * D, acc, 1, cq,
                   1.0f / lb);
      if (cq == 0) lse[rowvec + rb] = mb * kLn2 + logf(lb);
    }
  }
}

// ------------------------------------------------------ backward: dK, dV
// A CTA owns 128 k rows (64 per consumer warpgroup; K and V resident) and
// walks the q-blocks of 64 rows from the causal start. The producer warp
// also stages the block's LSE (in log2 units, +inf past sq so that P is
// 0 there) and Delta. Per block and warpgroup: S^T = K Q^T and dP^T = V
// dO^T (wgmma m64n64k16, K-major), P^T = exp2(S^T scale log2e - LSE) and
// dS^T = P^T (dP^T - Delta) scale in fp32 registers; then dV += bf16(P^T)
// dO and dK += bf16(dS^T) Q (wgmma m64nDk16, the rounded tiles from
// registers, dO and Q MN-major): the stock kernel's p.T.astype and
// ds.T.astype, with ds scaled first as it does.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mdo,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int heads, int sq, int sk, float scale,
                             float scale_log2, int causal) {
  constexpr int kN = 128, kM = 64;  // k rows per CTA, q rows per block
  constexpr Layout L = dkdv_layout<D>();
  extern __shared__ uint8_t smem_raw[];
  Bars bars;
  // each full barrier: the 32 producer lanes (the row vectors) + the TMA
  const uint32_t base = setup(smem_raw, L, 32, bars);
  const uint32_t sK = base, sV = base + tile_bytes<D>(kN);
  float* vecs = reinterpret_cast<float*>(
      smem_raw + (base - smem_addr(smem_raw)) + L.extra_at());

  const int k0 = blockIdx.x * kN;  // the first keys see the most rows
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int shift = sk - sq;
  int q_first = causal ? max(0, k0 - shift) : 0;
  q_first = (q_first / kM) * kM;
  const int nblk = (sq - q_first + kM - 1) / kM;
  const long long rowvec = ((long long)b * heads + h) * sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one warp loads
    regs_release<kProducerRegs>();
    if (warp != 4 * kConsumers) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.resident, 2 * tile_bytes<D>(kN));
      tma_load_tile<kN, D>(sK, &mk, bars.resident, h, k0, b);
      tma_load_tile<kN, D>(sV, &mv, bars.resident, h, k0, b);
    }
    for (int it = 0; it < nblk; ++it) {
      const int s = it % kStages;
      const int q0 = q_first + it * kM;
      if (it >= kStages) mbar_wait(bars.empty(s), ((it / kStages) & 1) ^ 1);
      float* sl = vecs + s * 2 * kM;
      for (int i = lane; i < kM; i += 32) {
        const int r = q0 + i;
        sl[i] = r < sq ? lse[rowvec + r] * kLog2e : INFINITY;
        sl[kM + i] = r < sq ? delta[rowvec + r] : 0.0f;
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t sQ = base + L.stage_at(s);
        mbar_arrive_expect_tx(bars.full(s), L.stage);
        tma_load_tile<kM, D>(sQ, &mq, bars.full(s), h, q0, b);
        tma_load_tile<kM, D>(sQ + tile_bytes<D>(kM), &mdo, bars.full(s), h,
                             q0, b);
      } else {
        mbar_arrive(bars.full(s));
      }
    }
  } else {  // the consumer warpgroups
    regs_claim<kConsumerRegs>();

    const int wg = warp / 4, t = threadIdx.x % 128;
    const int wkey = k0 + 64 * wg;  // this warpgroup's first key
    const int ca = wkey + (t / 32) * 16 + lane / 4, cb = ca + 8;
    const int cq = 2 * (lane % 4);
    const bool live = wkey < sk;
    // the first row that sees this warpgroup's first key
    const int q_lo = causal ? wkey - shift : 0;

    float adk[D / 2], adv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.0f;

    mbar_wait(bars.resident, 0);
    for (int it = 0; it < nblk; ++it) {
      const int s = it % kStages;
      const int q0 = q_first + it * kM;
      const uint32_t sQ = base + L.stage_at(s);
      const uint32_t sG = sQ + tile_bytes<D>(kM);
      const float* sl = vecs + s * 2 * kM;
      mbar_wait(bars.full(s), (it / kStages) & 1);
      if (live && q0 + kM - 1 >= q_lo) {
        float st[kM / 2], dpt[kM / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kM>(st, desc_k_major<kN>(sK, 64 * wg, kk),
                       desc_k_major<kM>(sQ, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kM>(dpt, desc_k_major<kN>(sV, 64 * wg, kk),
                       desc_k_major<kM>(sG, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);
        // masked: rows past sq, or rows above this warpgroup's last key
        const bool mask = q0 + kM > sq || (causal && q0 < wkey + 63 - shift);
#pragma unroll
        for (int j = 0; j < kM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rl = 8 * j + cq + e, r = q0 + rl;
            const float lr = sl[rl], dr = sl[kM + rl];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int i = 4 * j + 2 * half + e;
              const int c = half ? cb : ca;
              float p = exp2_(st[i] * scale_log2 - lr);
              if (mask && (r >= sq || (causal && c > r + shift))) p = 0.0f;
              st[i] = p;
              dpt[i] = p * (dpt[i] - dr) * scale;
            }
          }
        uint32_t pa[kM / 16][4], da[kM / 16][4];
        to_a_operand<kM / 16>(st, pa);
        to_a_operand<kM / 16>(dpt, da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kM / 16; ++kk)
          wgmma_rs<D>(adv, pa[kk], desc_mn_major<kM>(sG, kk));
#pragma unroll
        for (int kk = 0; kk < kM / 16; ++kk)
          wgmma_rs<D>(adk, da[kk], desc_mn_major<kM>(sQ, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(adv);
        fence_regs(adk);
        fence_regs(pa);
        fence_regs(da);
      }
      mbar_arrive(bars.empty(s));
    }

    if (!live) return;
    if (ca < sk) {
      const long long off = (((long long)b * sk + ca) * heads + h) * D;
      store_row<D>(dk + off, adk, 0, cq, 1.0f);
      store_row<D>(dv + off, adv, 0, cq, 1.0f);
    }
    if (cb < sk) {
      const long long off = (((long long)b * sk + cb) * heads + h) * D;
      store_row<D>(dk + off, adk, 1, cq, 1.0f);
      store_row<D>(dv + off, adv, 1, cq, 1.0f);
    }
  }
}

// ------------------------------------------------------------ backward: dQ
// A CTA owns 128 q rows (64 per consumer warpgroup; Q and dO resident)
// and walks the k/v blocks of 64 rows to its causal end. Per block and
// warpgroup: S = Q K^T and dP = dO V^T (wgmma m64n64k16), P and dS =
// P (dP - Delta) scale in fp32 registers, dQ += bf16(dS) K (wgmma
// m64nDk16, dS from registers, K MN-major: the stock ds.astype(k.dtype)).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mdo,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int heads, int sq, int sk,
                           float scale, float scale_log2, int causal) {
  constexpr int kM = 128, kN = 64;  // q rows per CTA, k rows per block
  constexpr Layout L = dq_layout<D>();
  extern __shared__ uint8_t smem_raw[];
  Bars bars;
  const uint32_t base = setup(smem_raw, L, 1, bars);
  const uint32_t sQ = base, sG = base + tile_bytes<D>(kM);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // longest rows first
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int shift = sk - sq;
  const int k_end = causal ? min(sk, q0 + kM + shift) : sk;
  const int nblk = (k_end + kN - 1) / kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one warp loads
    regs_release<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_arrive_expect_tx(bars.resident, 2 * tile_bytes<D>(kM));
      tma_load_tile<kM, D>(sQ, &mq, bars.resident, h, q0, b);
      tma_load_tile<kM, D>(sG, &mdo, bars.resident, h, q0, b);
      for (int it = 0; it < nblk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(bars.empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t sK = base + L.stage_at(s);
        mbar_arrive_expect_tx(bars.full(s), L.stage);
        tma_load_tile<kN, D>(sK, &mk, bars.full(s), h, it * kN, b);
        tma_load_tile<kN, D>(sK + tile_bytes<D>(kN), &mv, bars.full(s), h,
                             it * kN, b);
      }
    }
  } else {  // the consumer warpgroups
    regs_claim<kConsumerRegs>();

    const int wg = warp / 4, t = threadIdx.x % 128;
    const int wrow = q0 + 64 * wg;
    const int ra = wrow + (t / 32) * 16 + lane / 4, rb = ra + 8;
    const int cq = 2 * (lane % 4);
    const bool live = wrow < sq;
    const int last_col =
        causal ? min(sk - 1, min(wrow + 63, sq - 1) + shift) : sk - 1;
    const long long rowvec = ((long long)b * heads + h) * sq;
    // rows past sq: P is 0 (LSE +inf); they are not written
    const float la = ra < sq ? lse[rowvec + ra] * kLog2e : INFINITY;
    const float lb = rb < sq ? lse[rowvec + rb] * kLog2e : INFINITY;
    const float dea = ra < sq ? delta[rowvec + ra] : 0.0f;
    const float deb = rb < sq ? delta[rowvec + rb] : 0.0f;

    float adq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) adq[i] = 0.0f;

    mbar_wait(bars.resident, 0);
    for (int it = 0; it < nblk; ++it) {
      const int s = it % kStages;
      const int k0 = it * kN;
      const uint32_t sK = base + L.stage_at(s);
      const uint32_t sV = sK + tile_bytes<D>(kN);
      mbar_wait(bars.full(s), (it / kStages) & 1);
      if (live && k0 <= last_col) {
        float sc[kN / 2], dp[kN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, desc_k_major<kM>(sQ, 64 * wg, kk),
                       desc_k_major<kN>(sK, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, desc_k_major<kM>(sG, 64 * wg, kk),
                       desc_k_major<kN>(sV, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        const bool mask =
            k0 + kN > sk || (causal && k0 + kN - 1 > wrow + shift);
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + 8 * j + cq + e;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int i = 4 * j + 2 * half + e;
              const int r = half ? rb : ra;
              float p = exp2_(sc[i] * scale_log2 - (half ? lb : la));
              if (mask && (c >= sk || (causal && c > r + shift))) p = 0.0f;
              dp[i] = p * (dp[i] - (half ? deb : dea)) * scale;
            }
          }
        uint32_t dsa[kN / 16][4];
        to_a_operand<kN / 16>(dp, dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs<D>(adq, dsa[kk], desc_mn_major<kN>(sK, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(adq);
        fence_regs(dsa);
      }
      mbar_arrive(bars.empty(s));
    }

    if (!live) return;
    if (ra < sq)
      store_row<D>(dq + (((long long)b * sq + ra) * heads + h) * D, adq, 0, cq,
                   1.0f);
    if (rb < sq)
      store_row<D>(dq + (((long long)b * sq + rb) * heads + h) * D, adq, 1, cq,
                   1.0f);
  }
}

// ------------------------------------------------------------ launches
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// looked up at run time (cudaGetDriverEntryPoint), so the library links
// no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a bf16 [batch, seq, heads, D] tensor read through its
// strides (elements; multiples of 8, so 16-byte multiples in bytes, as
// TMA needs), as (D, heads, seq, batch) innermost first: boxes of 64
// columns x `box_rows` rows of one head, 128-byte swizzle, rows past seq
// zero-filled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                     int heads, int d, Strides st, int box_rows) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, a.q, a.batch, a.sq, a.heads, D, a.qs, 128)) ||
      (err = make_map(&mk, a.k, a.batch, a.sk, a.heads, D, a.ks, kFwdKeys)) ||
      (err = make_map(&mv, a.v, a.batch, a.sk, a.heads, D, a.vs, kFwdKeys)))
    return err;
  constexpr int smem = fwd_layout<D>().bytes();
  if ((err = allow_smem(flash_fwd_tc_kernel<D>, smem))) return err;
  dim3 grid((a.sq + 127) / 128, a.batch * a.heads);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(a.o), static_cast<float*>(a.lse),
      a.heads, a.sq, a.sk, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.batch * a.heads * a.sq;
  flash_bwd_delta_kernel<bf16, D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                    stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<float*>(a.delta), a.os, a.dos, a.batch, a.heads, a.sq);
  cudaError_t err = cudaGetLastError();
  if (err) return err;

  // dK/dV: q and dO in blocks of 64 rows, k and v resident (128 rows)
  CUtensorMap mq, mdo, mk, mv;
  if ((err = make_map(&mq, a.q, a.batch, a.sq, a.heads, D, a.qs, 64)) ||
      (err = make_map(&mdo, a.dout, a.batch, a.sq, a.heads, D, a.dos, 64)) ||
      (err = make_map(&mk, a.k, a.batch, a.sk, a.heads, D, a.ks, 128)) ||
      (err = make_map(&mv, a.v, a.batch, a.sk, a.heads, D, a.vs, 128)))
    return err;
  constexpr int smem_kv = dkdv_layout<D>().bytes();
  if ((err = allow_smem(flash_bwd_dkdv_tc_kernel<D>, smem_kv))) return err;
  dim3 grid_k((a.sk + 127) / 128, a.batch * a.heads);
  const float scale_log2 = a.scale * kLog2e;
  flash_bwd_dkdv_tc_kernel<D><<<grid_k, kThreads, smem_kv, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.heads, a.sq, a.sk, a.scale, scale_log2,
      a.causal);
  if ((err = cudaGetLastError())) return err;

  // dQ: q and dO resident (128 rows), k and v in blocks of 64 rows
  if ((err = make_map(&mq, a.q, a.batch, a.sq, a.heads, D, a.qs, 128)) ||
      (err = make_map(&mdo, a.dout, a.batch, a.sq, a.heads, D, a.dos, 128)) ||
      (err = make_map(&mk, a.k, a.batch, a.sk, a.heads, D, a.ks, 64)) ||
      (err = make_map(&mv, a.v, a.batch, a.sk, a.heads, D, a.vs, 64)))
    return err;
  constexpr int smem_q = dq_layout<D>().bytes();
  if ((err = allow_smem(flash_bwd_dq_tc_kernel<D>, smem_q))) return err;
  dim3 grid_q((a.sq + 127) / 128, a.batch * a.heads);
  flash_bwd_dq_tc_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.heads,
      a.sq, a.sk, a.scale, scale_log2, a.causal);
  return cudaGetLastError();
}

}  // namespace tc

template <typename Args>
using Launch = cudaError_t (*)(const Args&, cudaStream_t);

template <typename Args>
cudaError_t by_head_dim(int head_dim, Launch<Args> d64, Launch<Args> d128,
                        const Args& a, cudaStream_t s) {
  if (head_dim == 64) return d64(a, s);
  if (head_dim == 128) return d128(a, s);
  return cudaErrorInvalidValue;
}

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)  // tensor cores
    return by_head_dim<FwdArgs>(head_dim, tc::launch_fwd<64>,
                                tc::launch_fwd<128>, a, s);
  if (dtype == ptt::kF32)  // CUDA cores
    return by_head_dim<FwdArgs>(head_dim, launch_fwd<float, 64, false>,
                                launch_fwd<float, 128, false>, a, s);
  return cudaErrorInvalidValue;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    return by_head_dim<FwdArgs>(head_dim, launch_fwd<__nv_bfloat16, 64, true>,
                                launch_fwd<__nv_bfloat16, 128, true>, a, s);
  if (dtype == ptt::kF32)
    return by_head_dim<FwdArgs>(head_dim, launch_fwd<float, 64, true>,
                                launch_fwd<float, 128, true>, a, s);
  return cudaErrorInvalidValue;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)  // tensor cores
    return by_head_dim<BwdArgs>(head_dim, tc::launch_bwd<64>,
                                tc::launch_bwd<128>, a, s);
  if (dtype == ptt::kF32)  // CUDA cores
    return by_head_dim<BwdArgs>(head_dim, launch_bwd<float, 64>,
                                launch_bwd<float, 128>, a, s);
  return cudaErrorInvalidValue;
}
