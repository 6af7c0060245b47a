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
// Designs, chosen by the inputs' dtype and head dim
// (ptt_flash_attention_fwd/_bwd). Every head dim d that is a multiple of
// 16 up to 256 runs: a kernel is instantiated at a padded width D (64,
// 128 or 256 on the tensor cores; 16 and 32 too on the CUDA cores) and
// takes d as an argument; its tiles hold zeros in the columns from d to
// D (TMA zero-fills them, the split pre-pass and the CUDA-core loaders
// write them), which add nothing to the scores, and its stores skip
// those columns (d 16 to 48 run the D 64 kernels, 80 to 112 the D 128
// ones, 160 to 240 the D 256 ones). Any other head dim up to 256 is
// zero-padded by the Python wrapper to the next multiple of 16 (zero
// columns add exact zeros to every fp32 sum), and its outputs sliced
// back.
//
// bf16, forward at every d and backward up to d 128: the tensor-core
// design (namespace tc, below; hopper.cuh). Every product is wgmma with
// fp32 accumulators; tiles arrive by TMA into 128-byte-swizzled shared
// memory, two stages in flight, issued by one warp of a producer
// warpgroup beside two consumer warpgroups (setmaxnreg moves the
// producer's registers to them); the softmax runs in registers on the
// accumulator fragment, and P / dS are rounded to bf16 in registers and
// fed back as wgmma's A operand (the rounding points above). Forward: a
// CTA owns 128 q rows and walks k/v blocks of 128 (64 at D = 256, whose
// P V product runs as two m64n128 halves). Backward: the Delta row pass,
// a dK/dV pass (a CTA owns 128 k rows and walks q blocks of 64) and a dQ
// pass (a CTA owns 128 q rows and walks k blocks of 64): two passes
// recompute S and dP (14 D flops per visible pair, not 10) so that every
// output element has one owner: no float atomics, and the gradients
// repeat bit for bit. Causal blocks wholly above the diagonal are
// skipped; only blocks that cross it or the ragged end are masked.
//
// fp16 (the fp16 O1 and decorate O2 steps): the same tensor-core kernels
// instantiated on the element type E = __half (fp16 wgmma, fp16 tensor
// maps, P and dS packed with cvt.rn.f16x2.f32), forward at every d and
// backward up to d 128; an fp16 P, dS or O past 65504 becomes inf, as the
// stock kernel's astype does, so a loss scaler sees it. The fp16 backward
// above d 128 and the CUDA-core kernels in fp16 are refused (the split
// kernels read bf16 parts): ROADMAP.md queue B, fp16 item 3.
//
// fp32 at every d, and the bf16 backward above d 128: the split design
// (tc, "the split design" below). fp32 reaches the tensor cores through
// a three-part bf16 split of every operand, six bf16 products a product,
// which keeps fp32's 24 bits (a single TF32 product would keep about
// three decimal digits, and a two-part split about 16 bits, above the
// 1e-5 the fp32 models are held to); the bf16 backward at D 256 runs the
// same kernels with one part, where the two consumer warpgroups split D
// between them because one warpgroup's dK and dV accumulators for 64
// keys, 2 x 128 registers, would not fit beside its score tiles. The
// same three passes, the same single owners. fp32 at D 256 runs each
// kernel on a cluster of two CTAs, each holding the three parts of half
// of D and trading its partial score tiles with the other through
// distributed shared memory: a three-part tile of 64 rows at D 256 is 96
// KB, so the dK/dV pass's resident K and V alone would take 192 KB of the
// 227 KB a CTA has (the split design's section says why this plan).
//
// The CUDA-core design (the port's first flash kernels, below; fp32
// FMAs, 67 TFLOP/s at most) runs only on request (cuda_cores: the design
// the tensor-core kernels replaced, kept to compare with), at every width
// and in both dtypes (bf16 keeps P and dS in fp32 there, which moves an
// entry by less than probability_rounding_slack). One CTA of 256 threads
// owns a 64-row q-block (forward, dQ) or a 64-row k-block (dK/dV) and
// loops over the other side's 64-row blocks itself, from the causal start
// to the causal end. Tiles are staged in shared memory as fp32 with a row
// stride of D + 1 (the +1 keeps column reads of a tile on distinct
// banks). Each thread owns a 4 x 4 patch of the 64 x 64 score tile (rows
// ty*4+i, columns tx+16j) and a 4 x D/16 patch of the output rows; a
// row's max and sum are reduced over the 16 lanes that share it with
// shuffles. The same two backward passes, no atomics. At D = 256 the
// blocks have 32 rows (a thread a 2 x 2 patch): shared memory forward 101
// KB, dK/dV 137 KB, dQ 133 KB.
//
// Rope-on-load forward (ptt_rope_attention_fwd, fp32 and bf16). Replaces:
// paddle_tpu/kernels/fused_rope_attention.py rope_attention_fused (:167;
// pl.pallas_call at :111 over _fused_kernel :84, _rotate :58, _attn_rows
// :69). q and k are rotated in fp32 (neox half split, by the fp32
// half-dim tables' row of each row's position, in _rotate's op order), on
// load in the tensor-core and CUDA-core kernels, by a pre-pass into three
// parts in the split design; the rotated q and k and P keep fp32's value
// through both products (within split_product_slack in the tensor-core
// kernel), as _fused_kernel keeps them.
// Self-attention only (Sq == Sk, so the causal mask is c <= r); no LSE
// is written: the backward (fused_rope_attention.rope_attention_backward,
// the JAX custom_vjp's VJP of the composed function) recomputes it with
// the rope kernel and the split flash forward in fp32. The TPU kernel's
// softmax is exact over the whole row; these are online, the same
// function summed in another order. Column c pairs with c + d/2 of the
// head dim d the kernel is given (the wrapper pads each half of a head
// dim that is not a multiple of 16, so the pairing is the true one). Two
// designs, and the CUDA cores on request:
// - bf16 at d 64 to 128: the tensor-core kernel
//   (tc::rope_attention_fwd_tc_kernel, below): the rotated q and k and
//   P are split into bf16 hi and lo parts and multiplied in five bf16
//   products with fp32 accumulators (S = q_hi k_hi^T + q_hi k_lo^T +
//   q_lo k_hi^T, O = P_hi V + P_lo V), which keeps about 16 bits of each
//   fp32 value (fused_rope_attention.split_product_slack bounds the
//   rest); its bound is still the algorithm's 4 d flops a visible pair,
//   so it can reach at most 40% of it;
// - everything else (fp32 at every d, bf16 below 64 and above 128): the
//   split design. A pre-pass (tc::rope_split3_kernel) rotates q and k in
//   fp32 in _rotate's op order (a bf16 input cast to fp32 exactly) and
//   writes each rotated value as three bf16 parts (all 24 bits: nothing
//   is rounded, the JAX kernel's contract) into the workspace layout the
//   split flash forward reads; v goes through split3_kernel; then
//   flash_fwd_split_kernel runs as it is (at d above 128 on a cluster of
//   two CTAs), with no LSE stored, and writes O in the input type. The
//   rotated q and k do go to device memory, as parts (0.2 GB at B 2, S
//   2048, H 32, D 128): rotating inside the kernel instead would redo each
//   k tile's rotation in every q block's CTA (16 times at S 2048) on the
//   warpgroups whose issue slots the six products need, where the
//   pre-pass does it once;
// - on request (cuda_cores, to compare with): the CUDA-core forward,
//   instantiated with kRope: a lane loads a row's vector at column c
//   together with the one at c + d/2 and the tables' entries c..,
//   rotates in fp32 and stores both halves to the fp32 tile.
#include <utility>

#include "common.cuh"
#include "hopper.cuh"
#include "split.cuh"

namespace {

// ========================= CUDA cores (on request: the replaced design)
constexpr int kThreads = 256;  // 16 x 16 threads

// Rows of a q-block and of a k-block: 64, or 32 at D = 256 (four fp32
// tiles of 64 rows would not fit in shared memory). A thread owns an
// I x I patch of the score tile, I = rows / 16.
template <int D>
__host__ __device__ constexpr int block_rows() {
  return D > 128 ? 32 : 64;
}

using ptt::Strides;

// rows [row0, row0 + BR) of one head (base already at (b, h)) into a fp32
// tile of the template's width D with row stride D + 1; rows at or past
// `seq` and columns at or past the head dim d (<= D) are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ tile,
                                          const T* __restrict__ base,
                                          long long s_stride, int row0,
                                          int seq, int d) {
  constexpr int BR = block_rows<D>();
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = D / V;
  for (int idx = threadIdx.x; idx < BR * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * V;
    float vals[V];
    if (row0 + r < seq && c < d) {
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
// (neox: out[:d/2] = x1 cos - x2 sin, out[d/2:d] = x2 cos + x1 sin, fp32,
// in _rotate's op order, no fused multiply-add); cos/sin are fp32 [S,
// d/2] with row stride tab_stride (elements). Column c pairs with c + d/2
// at the TRUE head dim d, not the template's D (the TPU kernel's pairing);
// columns [d, D) are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile_rope(
    float* __restrict__ tile, const T* __restrict__ base, long long s_stride,
    int row0, int seq, const float* __restrict__ cos,
    const float* __restrict__ sin, long long tab_stride, int d) {
  constexpr int BR = block_rows<D>();
  constexpr int V = 16 / (int)sizeof(T);
  const int H2 = d / 2;
  const int kVecPerHalf = H2 / V;
  if (d < D) {
    constexpr int kVecPerRow = D / V;
    for (int idx = threadIdx.x; idx < BR * kVecPerRow; idx += kThreads) {
      const int c = (idx % kVecPerRow) * V;
      if (c >= d) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          tile[(idx / kVecPerRow) * (D + 1) + c + j] = 0.0f;
      }
    }
  }
  for (int idx = threadIdx.x; idx < BR * kVecPerHalf; idx += kThreads) {
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

// BR fp32 values of a [B, H, S] row vector (zero past `seq`)
template <int BR>
__device__ __forceinline__ void load_row_vec(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             int row0, int seq) {
  if (threadIdx.x < BR) {
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

// a[r][c] (+)= sum_d x[r][d] * y[c][d] over the thread's I x I patch,
// r = ty*I+i, c = tx+16j (x, y: fp32 tiles with row stride D + 1)
template <int D, int I = block_rows<D>() / 16>
__device__ __forceinline__ void tile_dot(const float* __restrict__ x,
                                         const float* __restrict__ y,
                                         float (&a)[I][I], int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float xv[I], yv[I];
#pragma unroll
    for (int i = 0; i < I; ++i) xv[i] = x[(ty * I + i) * LD + d];
#pragma unroll
    for (int j = 0; j < I; ++j) yv[j] = y[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < I; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
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
                     Strides vs, int heads, int sq, int sk, int d,
                     float scale, int causal, const float* __restrict__ cos,
                     const float* __restrict__ sin, long long tab_stride) {
  constexpr int LD = D + 1;
  constexpr int NO = D / 16;  // output columns per thread
  constexpr int BR = block_rows<D>(), I = BR / 16, LP = BR + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BR * LD;
  float* sV = sK + BR * LD;
  float* sP = sV + BR * LD;

  const int q0 = blockIdx.x * BR;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  if constexpr (kRope)
    load_tile_rope<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, cos, sin,
                         tab_stride, d);
  else
    load_tile<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, d);
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  float m[I], l[I], acc[I][NO];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[i][n] = 0.0f;
  }
  // columns past the last row's causal limit are never visible
  const int k_end = causal ? min(sk, q0 + BR + (sk - sq)) : sk;

  for (int k0 = 0; k0 < k_end; k0 += BR) {
    __syncthreads();  // the previous block's readers are done
    if constexpr (kRope)
      load_tile_rope<T, D>(sK, kbase, ks.s, k0, sk, cos, sin, tab_stride, d);
    else
      load_tile<T, D>(sK, kbase, ks.s, k0, sk, d);
    load_tile<T, D>(sV, vbase, vs.s, k0, sk, d);
    __syncthreads();
    float s[I][I];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < I; ++j) s[i][j] = 0.0f;
    tile_dot<D>(sQ, sK, s, tx, ty);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int r = q0 + ty * I + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < I; ++j) {
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
      for (int j = 0; j < I; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) acc[i][n] *= alpha;
#pragma unroll
      for (int j = 0; j < I; ++j) sP[(ty * I + i) * LP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float vv[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) vv[n] = sV[c * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const float p = sP[(ty * I + i) * LP + c];
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int r = q0 + ty * I + i;
    if (r >= sq) continue;
    T* orow = o + (((long long)b * sq + r) * heads + h) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (tx + 16 * n < d)
        orow[tx + 16 * n] = ptt::from_float<T>(acc[i][n] / l[i]);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * heads + h) * sq + r] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------- backward: Delta
// one warp per (b, row, h): Delta = sum over the d columns (d <= D) of
// dO * O in fp32
template <typename T, int D>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, Strides os,
                                       Strides dos, int batch, int heads,
                                       int sq, int d) {
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
  for (int c = lane; c < D; c += 32)
    if (c < d) acc += ptt::to_float(grow[c]) * ptt::to_float(orow[c]);
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
                          int sq, int sk, int d, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int NO = D / 16;
  constexpr int BR = block_rows<D>(), I = BR / 16, LP = BR + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BR * LD;
  float* sQ = sV + BR * LD;
  float* sG = sQ + BR * LD;  // dO
  float* sP = sG + BR * LD;
  float* sS = sP + BR * LP;  // dS
  float* sL = sS + BR * LP;  // LSE of the q-block's rows
  float* sD = sL + BR;        // Delta of the q-block's rows

  const int k0 = blockIdx.x * BR;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long rowvec = ((long long)b * heads + h) * sq;

  load_tile<T, D>(sK, k + b * ks.b + h * ks.h, ks.s, k0, sk, d);
  load_tile<T, D>(sV, v + b * vs.b + h * vs.h, vs.s, k0, sk, d);
  const T* qbase = q + b * qs.b + h * qs.h;
  const T* gbase = dout + b * dos.b + h * dos.h;

  float adk[I][NO], adv[I][NO];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int n = 0; n < NO; ++n) adk[i][n] = adv[i][n] = 0.0f;

  // the first row that sees column k0 is k0 - (sk - sq)
  int q_first = causal ? k0 - (sk - sq) : 0;
  q_first = q_first < 0 ? 0 : (q_first / BR) * BR;

  for (int q0 = q_first; q0 < sq; q0 += BR) {
    __syncthreads();
    load_tile<T, D>(sQ, qbase, qs.s, q0, sq, d);
    load_tile<T, D>(sG, gbase, dos.s, q0, sq, d);
    load_row_vec<BR>(sL, lse + rowvec, q0, sq);
    load_row_vec<BR>(sD, delta + rowvec, q0, sq);
    __syncthreads();
    float s[I][I], dp[I][I];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < I; ++j) s[i][j] = dp[i][j] = 0.0f;
    tile_dot<D>(sQ, sK, s, tx, ty);   // rows: q, columns: k
    tile_dot<D>(sG, sV, dp, tx, ty);  // dO V^T
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int ri = ty * I + i;
#pragma unroll
      for (int j = 0; j < I; ++j) {
        const int cj = tx + 16 * j;
        const float p = visible(q0 + ri, k0 + cj, sq, sk, causal)
                            ? expf(s[i][j] * scale - sL[ri])
                            : 0.0f;
        sP[ri * LP + cj] = p;
        sS[ri * LP + cj] = p * (dp[i][j] - sD[ri]);
      }
    }
    __syncthreads();
    // this thread's k rows c = ty*4+i, columns tx+16n
#pragma unroll 2
    for (int r = 0; r < BR; ++r) {
      float gv[NO], qv[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        gv[n] = sG[r * LD + tx + 16 * n];
        qv[n] = sQ[r * LD + tx + 16 * n];
      }
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const float p = sP[r * LP + ty * I + i];
        const float ds = sS[r * LP + ty * I + i];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          adv[i][n] = fmaf(p, gv[n], adv[i][n]);
          adk[i][n] = fmaf(ds, qv[n], adk[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int c = k0 + ty * I + i;
    if (c >= sk) continue;
    const long long off = (((long long)b * sk + c) * heads + h) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (tx + 16 * n >= d) continue;
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
                        int heads, int sq, int sk, int d, float scale,
                        int causal) {
  constexpr int LD = D + 1;
  constexpr int NO = D / 16;
  constexpr int BR = block_rows<D>(), I = BR / 16, LP = BR + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BR * LD;
  float* sK = sG + BR * LD;
  float* sV = sK + BR * LD;
  float* sS = sV + BR * LD;
  float* sL = sS + BR * LP;
  float* sD = sL + BR;

  const int q0 = blockIdx.x * BR;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long rowvec = ((long long)b * heads + h) * sq;

  load_tile<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, d);
  load_tile<T, D>(sG, dout + b * dos.b + h * dos.h, dos.s, q0, sq, d);
  load_row_vec<BR>(sL, lse + rowvec, q0, sq);
  load_row_vec<BR>(sD, delta + rowvec, q0, sq);
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  float adq[I][NO];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int n = 0; n < NO; ++n) adq[i][n] = 0.0f;
  const int k_end = causal ? min(sk, q0 + BR + (sk - sq)) : sk;

  for (int k0 = 0; k0 < k_end; k0 += BR) {
    __syncthreads();
    load_tile<T, D>(sK, kbase, ks.s, k0, sk, d);
    load_tile<T, D>(sV, vbase, vs.s, k0, sk, d);
    __syncthreads();
    float s[I][I], dp[I][I];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < I; ++j) s[i][j] = dp[i][j] = 0.0f;
    tile_dot<D>(sQ, sK, s, tx, ty);
    tile_dot<D>(sG, sV, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int ri = ty * I + i;
#pragma unroll
      for (int j = 0; j < I; ++j) {
        const int cj = tx + 16 * j;
        const float p = visible(q0 + ri, k0 + cj, sq, sk, causal)
                            ? expf(s[i][j] * scale - sL[ri])
                            : 0.0f;
        sS[ri * LP + cj] = p * (dp[i][j] - sD[ri]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float kv[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) kv[n] = sK[c * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const float ds = sS[(ty * I + i) * LP + c];
#pragma unroll
        for (int n = 0; n < NO; ++n) adq[i][n] = fmaf(ds, kv[n], adq[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int r = q0 + ty * I + i;
    if (r >= sq) continue;
    const long long off = (((long long)b * sq + r) * heads + h) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (tx + 16 * n < d)
        dq[off + tx + 16 * n] = ptt::from_float<T>(adq[i][n] * scale);
  }
}

// ---------------------------------------------------------------- launches
template <int D, int BR = block_rows<D>(), int LP = BR + 1>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * BR * (D + 1) + BR * LP);
}
template <int D, int BR = block_rows<D>(), int LP = BR + 1>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * BR * (D + 1) + 2 * BR * LP + 2 * BR);
}
template <int D, int BR = block_rows<D>(), int LP = BR + 1>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BR * (D + 1) + BR * LP + 2 * BR);
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
  int batch, heads, sq, sk, d, causal;  // d: the head dim (<= the template's)
  float scale;
  const void *cos, *sin;  // the rope tables (rope-on-load only)
  long long tab_stride;
};

template <typename T, int D, bool kRope>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  cudaError_t err =
      allow_smem(flash_fwd_kernel<T, D, kRope>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  constexpr int BR = block_rows<D>();
  dim3 grid((a.sq + BR - 1) / BR, a.batch * a.heads);
  flash_fwd_kernel<T, D, kRope><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.qs, a.ks, a.vs, a.heads, a.sq, a.sk, a.d,
      a.scale, a.causal, static_cast<const float*>(a.cos),
      static_cast<const float*>(a.sin), a.tab_stride);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos;
  int batch, heads, sq, sk, d, causal;  // d: the head dim
  float scale;
};

template <typename T, int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.batch * a.heads * a.sq;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                  stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), a.os, a.dos, a.batch, a.heads, a.sq,
      a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(flash_bwd_dkdv_kernel<T, D>, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  constexpr int BR = block_rows<D>();
  dim3 grid_k((a.sk + BR - 1) / BR, a.batch * a.heads);
  flash_bwd_dkdv_kernel<T, D><<<grid_k, kThreads, dkdv_smem<D>(), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks, a.vs, a.dos,
      a.heads, a.sq, a.sk, a.d, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(flash_bwd_dq_kernel<T, D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid_q((a.sq + BR - 1) / BR, a.batch * a.heads);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.heads, a.sq, a.sk,
      a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// ================================= tensor-core designs (bf16, and split)
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
using namespace ptt::split;  // term_a, term_b, first_term, to_a_parts,
                             // split3_kernel (split.cuh)

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
// rows of a k/v block in the forward: 128, or 64 at D = 256 (two stages
// of 128-row K and V tiles would not fit beside Q)
template <int D>
__host__ __device__ constexpr int fwd_keys() {
  return D > 128 ? 64 : 128;
}
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

// forward: Q (128 rows) resident, K and V blocks of fwd_keys rows per
// stage
template <int D>
__host__ __device__ constexpr Layout fwd_layout() {
  return {tile_bytes<D>(128), 2 * tile_bytes<D>(fwd_keys<D>()), 0};
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
// entries [8 kk, 8 kk + 8) rounded to bf16 (or fp16: E) pairs (the stock
// kernel's p.astype / ds.astype; an fp16 value past 65504 becomes inf).
template <int KSTEPS, typename E = bf16>
__device__ __forceinline__ void to_a_operand(const float* acc,
                                             uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<E>(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// O (+)= P V for k-step kk of a V tile of R rows (MN-major): D = 256
// runs as two m64n128 products over V's column halves, whose fragments
// laid end to end are the m64n256 fragment (entries 4j.. of 8-column
// block j)
template <int D, int R, typename E = bf16>
__device__ __forceinline__ void pv_step(float (&acc)[D / 2],
                                        const uint32_t (&p)[4], uint32_t sV,
                                        int kk) {
  if constexpr (D <= 128) {
    wgmma_rs<D, E>(acc, p, desc_mn_major<R>(sV, kk));
  } else {
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
      wgmma_rs<128, E>(*reinterpret_cast<float(*)[64]>(acc + 64 * h), p,
                    desc_mn_major<R>(sV + h * 2 * R * 128, kk));
  }
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

// one output row of a thread's accumulator of D columns (entries 4j +
// half*2 + {0,1}) to a contiguous bf16, fp16 or fp32 row, times `mul`; columns
// from d (a multiple of 8; the head dim, less the row's first column) on
// are not stored
template <int D, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ row,
                                          const float (&acc)[D / 2], int half,
                                          int cq, float mul, int d) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (8 * j >= d) continue;
    const float x = acc[4 * j + 2 * half] * mul;
    const float y = acc[4 * j + 2 * half + 1] * mul;
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<uint32_t*>(row + 8 * j + cq) = pack2<T>(x, y);
    else
      *reinterpret_cast<float2*>(row + 8 * j + cq) = make_float2(x, y);
  }
}

// One k block of the forward's online softmax on a thread's rows ra and
// rb of a score tile of kN columns from k0 (the accumulator layout:
// entries 4j + {0, 1} of row ra, 4j + {2, 3} of row rb, columns k0 + 8j +
// cq + {0, 1}): scores to the log2 domain, masked past sk and above the
// diagonal (column c visible to row r iff c <= r + shift) where `mask`,
// the running maxima ma, mb (finite from the first block on: column 0 is
// visible to every row), P = exp2(S - m) in place, the per-thread partial
// sums la, lb of the unrounded P (the quad's are added at the end), and
// the output accumulator rescaled.
template <int kN, int DA>
__device__ __forceinline__ void softmax_block(float (&sc)[kN / 2],
                                              float (&acc)[DA], float& ma,
                                              float& mb, float& la, float& lb,
                                              bool mask, int k0, int cq,
                                              int ra, int rb, int sk,
                                              int shift, int causal,
                                              float scale_log2) {
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
  la = la * alpha_a + sa;
  lb = lb * alpha_b + sb;
#pragma unroll
  for (int j = 0; j < DA / 4; ++j) {
    acc[4 * j] *= alpha_a;
    acc[4 * j + 1] *= alpha_a;
    acc[4 * j + 2] *= alpha_b;
    acc[4 * j + 3] *= alpha_b;
  }
}

// ----------------------------------------------------------------- forward
// A CTA owns 128 q rows (64 per consumer warpgroup, Q resident) and walks
// the k/v blocks of 128 rows from 0 to its causal end. Per block and
// warpgroup: S = Q K^T (wgmma m64n128k16, both operands K-major in
// shared memory), scale and mask in registers, online softmax in the
// log2 domain (a row's max and sum over the 4 lanes of a quad), P =
// exp2(S - m) rounded to bf16 (fp16: E) in registers (unnormalised, tile
// by tile, as the stock kernel's p.astype(v.dtype)) and O += P V (wgmma
// m64nDk16, P from registers, V MN-major). l sums the unrounded p.
template <typename E, int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        E* __restrict__ o, float* __restrict__ lse,
                        int heads, int sq, int sk, int d, float scale_log2,
                        int causal) {
  if (!kPad) d = D;  // a compile-time head dim where the width is exact
  constexpr int kM = 128, kN = fwd_keys<D>();
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
          wgmma_ss<kN, E>(sc, desc_k_major<kM>(sQ, 64 * wg, kk),
                        desc_k_major<kN>(sK, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        // only blocks that cross the last key or the diagonal are masked;
        // zero-filled rows past sk give scores of 0, so they are masked too
        const bool mask =
            k0 + kN > sk || (causal && k0 + kN - 1 > wrow + shift);
        softmax_block<kN>(sc, acc, ma, mb, la, lb, mask, k0, cq, ra, rb, sk,
                          shift, causal, scale_log2);
        uint32_t p[kN / 16][4];
        to_a_operand<kN / 16, E>(sc, p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          pv_step<D, kN, E>(acc, p[kk], sV, kk);
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
      store_row<D>(o + (((long long)b * sq + ra) * heads + h) * d, acc, 0, cq,
                   1.0f / la, d);
      if (cq == 0) lse[rowvec + ra] = ma * kLn2 + logf(la);
    }
    if (rb < sq) {
      store_row<D>(o + (((long long)b * sq + rb) * heads + h) * d, acc, 1, cq,
                   1.0f / lb, d);
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
template <typename E, int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mdo,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             E* __restrict__ dk, E* __restrict__ dv,
                             int heads, int sq, int sk, int d, float scale,
                             float scale_log2, int causal) {
  if (!kPad) d = D;
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
          wgmma_ss<kM, E>(st, desc_k_major<kN>(sK, 64 * wg, kk),
                       desc_k_major<kM>(sQ, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kM, E>(dpt, desc_k_major<kN>(sV, 64 * wg, kk),
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
        to_a_operand<kM / 16, E>(st, pa);
        to_a_operand<kM / 16, E>(dpt, da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kM / 16; ++kk)
          wgmma_rs<D, E>(adv, pa[kk], desc_mn_major<kM>(sG, kk));
#pragma unroll
        for (int kk = 0; kk < kM / 16; ++kk)
          wgmma_rs<D, E>(adk, da[kk], desc_mn_major<kM>(sQ, kk));
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
      const long long off = (((long long)b * sk + ca) * heads + h) * d;
      store_row<D>(dk + off, adk, 0, cq, 1.0f, d);
      store_row<D>(dv + off, adv, 0, cq, 1.0f, d);
    }
    if (cb < sk) {
      const long long off = (((long long)b * sk + cb) * heads + h) * d;
      store_row<D>(dk + off, adk, 1, cq, 1.0f, d);
      store_row<D>(dv + off, adv, 1, cq, 1.0f, d);
    }
  }
}

// ------------------------------------------------------------ backward: dQ
// A CTA owns 128 q rows (64 per consumer warpgroup; Q and dO resident)
// and walks the k/v blocks of 64 rows to its causal end. Per block and
// warpgroup: S = Q K^T and dP = dO V^T (wgmma m64n64k16), P and dS =
// P (dP - Delta) scale in fp32 registers, dQ += bf16(dS) K (wgmma
// m64nDk16, dS from registers, K MN-major: the stock ds.astype(k.dtype)).
template <typename E, int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mdo,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           E* __restrict__ dq, int heads, int sq, int sk,
                           int d, float scale, float scale_log2, int causal) {
  if (!kPad) d = D;
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
          wgmma_ss<kN, E>(sc, desc_k_major<kM>(sQ, 64 * wg, kk),
                       desc_k_major<kN>(sK, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kN, E>(dp, desc_k_major<kM>(sG, 64 * wg, kk),
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
        to_a_operand<kN / 16, E>(dp, dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs<D, E>(adq, dsa[kk], desc_mn_major<kN>(sK, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(adq);
        fence_regs(dsa);
      }
      mbar_arrive(bars.empty(s));
    }

    if (!live) return;
    if (ra < sq)
      store_row<D>(dq + (((long long)b * sq + ra) * heads + h) * d, adq, 0, cq,
                   1.0f, d);
    if (rb < sq)
      store_row<D>(dq + (((long long)b * sq + rb) * heads + h) * d, adq, 1, cq,
                   1.0f, d);
  }
}

// ------------------------------------------------- rope-on-load forward
// The JAX kernel rotates q and k in fp32 and keeps them, and P, in fp32
// through both products (fused_rope_attention.py:84-103). Here each fp32
// value x is split into hi = bf16(x) and lo = bf16(x - hi) (x - hi is
// exact in fp32), which keeps about 16 of its 24 significant bits, and
// every product runs on the tensor cores with fp32 accumulators:
//   S = q_hi k_lo^T + q_lo k_hi^T + q_hi k_hi^T   (q_lo k_lo^T dropped)
//   O += P_lo V + P_hi V                          (V is a bf16 input)
// Five bf16 products where plain flash has two; the error bound is
// fused_rope_attention.split_product_slack. Nothing is rounded to bf16
// as a value: the rotated q and k and P are only ever split.
//
// A CTA owns 128 q rows (64 per consumer warpgroup) and walks the k/v
// blocks of 128 rows from 0 to its causal end (self-attention: column c
// is visible to row r iff c <= r). The raw bf16 Q tile, and each stage's
// raw K and V tiles, arrive by TMA. The two consumer warpgroups rotate
// a raw tile together, 8 columns and their partners d/2 on a thread at a
// time, in _rotate's op order: the hi parts over the raw tile (in place;
// a K stage is refilled only after every consumer is done with it), the
// lo parts into a tile of their own. Q is rotated once; each K tile
// before its products, into the one k_lo tile: a barrier after the
// score products keeps the next rotation from overwriting k_lo while
// the other warpgroup still reads it. The online softmax is the
// tensor-core forward's; P_hi and P_lo are register A operands of the
// two P V products. Shared memory at D = 128: Q hi and lo 64 KB, two
// stages of K and V 128 KB, k_lo 32 KB (225 KB of 227).
template <int D>
__host__ __device__ constexpr Layout rope_layout() {
  return {2 * tile_bytes<D>(128), 2 * tile_bytes<D>(128), tile_bytes<D>(128)};
}

// byte offset of element (r, c) in a 128-byte-swizzled tile of R rows
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// hi = bf16(x), lo = bf16(x - hi) of two fp32 values, as bf16 pairs
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

// the accumulator fragment of a score tile (to_a_operand's layout) split
// into the register A operands P_hi and P_lo
template <int KSTEPS>
__device__ __forceinline__ void to_a_split(const float* acc,
                                           uint32_t (*hi)[4],
                                           uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split2(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1], hi[kk][i],
             lo[kk][i]);
}

// Rotate a raw bf16 tile of R rows (generic address `xt`, positions p0 ..)
// in place into its hi parts and write the lo parts into `lo` (same
// layout), by the 256 consumer threads (ct): item (row r, 8-column chunk
// c / 8 < d / 16) takes columns c .. c + 7 and their partners c + d/2 ..
// (neox: out[:d/2] = x1 cos - x2 sin, out[d/2:] = x2 cos + x1 sin, the
// tables' row of the position, fp32, no fused multiply-add). Rows past
// seq hold TMA's zeros and rotate to zero; columns past d are left as
// they are. (Holding two items' tables in registers, so that their L2
// round trips overlap, takes 32 more and spills at D 128.)
template <int R>
__device__ __forceinline__ void rope_tile(uint8_t* xt, uint8_t* lo, int p0,
                                          int seq, int d,
                                          const float* __restrict__ cos,
                                          const float* __restrict__ sin,
                                          long long tab, int ct) {
  const int h2 = d / 2, chunks = d / 16;
  for (int i = ct; i < R * chunks; i += 128 * kConsumers) {
    const int r = i / chunks, c = 8 * (i - r * chunks);
    const int pos = p0 + r;
    uint4* p1 = reinterpret_cast<uint4*>(xt + swz<R>(r, c));
    uint4* p2 = reinterpret_cast<uint4*>(xt + swz<R>(r, c + h2));
    const uint4 a = *p1, b = *p2;
    float cv[8], sv[8];
    if (pos < seq) {
      ptt::load_floats<float, 8>(cos + pos * tab + c, cv);
      ptt::load_floats<float, 8>(sin + pos * tab + c, sv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) cv[j] = sv[j] = 0.0f;
    }
    const uint32_t x1[4] = {a.x, a.y, a.z, a.w};
    const uint32_t x2[4] = {b.x, b.y, b.z, b.w};
    uint32_t hi1[4], lo1[4], hi2[4], lo2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a bf16 is the high half of its fp32 value
      const float a0 = __uint_as_float(x1[j] << 16);
      const float a1 = __uint_as_float(x1[j] & 0xffff0000u);
      const float b0 = __uint_as_float(x2[j] << 16);
      const float b1 = __uint_as_float(x2[j] & 0xffff0000u);
      const float c0 = cv[2 * j], c1 = cv[2 * j + 1];
      const float s0 = sv[2 * j], s1 = sv[2 * j + 1];
      split2(__fsub_rn(__fmul_rn(a0, c0), __fmul_rn(b0, s0)),
             __fsub_rn(__fmul_rn(a1, c1), __fmul_rn(b1, s1)), hi1[j], lo1[j]);
      split2(__fadd_rn(__fmul_rn(b0, c0), __fmul_rn(a0, s0)),
             __fadd_rn(__fmul_rn(b1, c1), __fmul_rn(a1, s1)), hi2[j], lo2[j]);
    }
    *p1 = make_uint4(hi1[0], hi1[1], hi1[2], hi1[3]);
    *p2 = make_uint4(hi2[0], hi2[1], hi2[2], hi2[3]);
    *reinterpret_cast<uint4*>(lo + swz<R>(r, c)) =
        make_uint4(lo1[0], lo1[1], lo1[2], lo1[3]);
    *reinterpret_cast<uint4*>(lo + swz<R>(r, c + h2)) =
        make_uint4(lo2[0], lo2[1], lo2[2], lo2[3]);
  }
}

template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    rope_attention_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv,
                                 bf16* __restrict__ o,
                                 const float* __restrict__ cos,
                                 const float* __restrict__ sin, long long tab,
                                 int heads, int seq, int d, float scale_log2,
                                 int causal) {
  if (!kPad) d = D;  // a compile-time head dim where the width is exact
  constexpr int kM = 128, kN = 128;
  constexpr Layout L = rope_layout<D>();
  extern __shared__ uint8_t smem_raw[];
  Bars bars;
  const uint32_t base = setup(smem_raw, L, 1, bars);
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t sQ = base, sQlo = base + tile_bytes<D>(kM);
  const uint32_t sKlo = base + L.extra_at();

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // longest rows first
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k_end = causal ? min(seq, q0 + kM) : seq;
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
    return;
  }
  regs_claim<kConsumerRegs>();

  const int wg = warp / 4, t = threadIdx.x % 128, ct = threadIdx.x;
  const int wrow = q0 + 64 * wg;  // this warpgroup's first row
  const int ra = wrow + (t / 32) * 16 + lane / 4, rb = ra + 8;
  const int cq = 2 * (lane % 4);
  const bool live = wrow < seq;
  const int last_col = causal ? min(seq - 1, wrow + 63) : seq - 1;
  uint8_t* const gQlo = gbase + tile_bytes<D>(kM);
  uint8_t* const gKlo = gbase + L.extra_at();

  // the lo tiles' columns past d: never written by a rotation, so they
  // are zeroed once (the raw tiles' columns past d are TMA's zeros)
  if (kPad) {
    constexpr int kChunks = kN * (D / 8);  // kM == kN
    for (int i = ct; i < 2 * kChunks; i += 128 * kConsumers) {
      const int r = (i % kChunks) / (D / 8), c = 8 * (i % (D / 8));
      if (c >= d)
        *reinterpret_cast<uint4*>((i < kChunks ? gQlo : gKlo) +
                                  swz<kN>(r, c)) = make_uint4(0, 0, 0, 0);
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float ma = -INFINITY, mb = -INFINITY, sum_a = 0.0f, sum_b = 0.0f;

  mbar_wait(bars.resident, 0);
  rope_tile<kM>(gbase, gQlo, q0, seq, d, cos, sin, tab, ct);
  mbar_wait(bars.full(0), 0);
  rope_tile<kN>(gbase + L.stage_at(0), gKlo, 0, seq, d, cos, sin, tab, ct);
  fence_proxy_async();
  named_sync(1, 128 * kConsumers);
  for (int it = 0; it < nblk; ++it) {
    const int s = it % kStages;
    const int k0 = it * kN;
    const uint32_t sK = base + L.stage_at(s);
    const uint32_t sV = sK + tile_bytes<D>(kN);
    // blocks wholly past this warpgroup's last visible column are skipped
    const bool work = live && k0 <= last_col;
    float sc[kN / 2];
    if (work) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kN>(sc, desc_k_major<kM>(sQ, 64 * wg, kk),
                     desc_k_major<kN>(sKlo, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kN>(sc, desc_k_major<kM>(sQlo, 64 * wg, kk),
                     desc_k_major<kN>(sK, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kN>(sc, desc_k_major<kM>(sQ, 64 * wg, kk),
                     desc_k_major<kN>(sK, 0, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
    }
    // both warpgroups are done with k_lo: the next rotation may write it
    named_sync(1, 128 * kConsumers);
    if (work) {
      // only blocks that cross the last key or the diagonal are masked;
      // zero-filled rows past seq give scores of 0, so they are masked too
      const bool mask = k0 + kN > seq || (causal && k0 + kN - 1 > wrow);
      // sums of the unsplit P
      softmax_block<kN>(sc, acc, ma, mb, sum_a, sum_b, mask, k0, cq, ra, rb,
                        seq, 0, causal, scale_log2);
      uint32_t ph[kN / 16][4], pl[kN / 16][4];
      to_a_split<kN / 16>(sc, ph, pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) pv_step<D, kN>(acc, pl[kk], sV, kk);
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) pv_step<D, kN>(acc, ph[kk], sV, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
    }
    mbar_arrive(bars.empty(s));
    // the next block's K, rotated by both warpgroups before its products
    if (it + 1 < nblk) {
      mbar_wait(bars.full((it + 1) % kStages), ((it + 1) / kStages) & 1);
      rope_tile<kN>(gbase + L.stage_at((it + 1) % kStages), gKlo, k0 + kN,
                    seq, d, cos, sin, tab, ct);
      fence_proxy_async();
      named_sync(1, 128 * kConsumers);
    }
  }

  if (!live) return;
  sum_a = quad_sum(sum_a);
  sum_b = quad_sum(sum_b);
  if (ra < seq)
    store_row<D>(o + (((long long)b * seq + ra) * heads + h) * d, acc, 0, cq,
                 1.0f / sum_a, d);
  if (rb < seq)
    store_row<D>(o + (((long long)b * seq + rb) * heads + h) * d, acc, 1, cq,
                 1.0f / sum_b, d);
}

// ------------------------------------------------------- the split design
// fp32 at every padded D (64, 128, 256), the bf16 rope-on-load forward
// outside padded D 64 to 128, and the bf16 backward at D 256. An operand
// here is NP bf16 tiles of the same rows, one after another: NP = 1 for a
// bf16 input; NP = 3 for an fp32 one, whose value x is hi + mid + lo with
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each
// difference exact in fp32: the three keep x's 24 significant bits). The
// parts are written by a pre-pass (split3_kernel) to a bf16 scratch [NP,
// batch, seq, heads, D] that TMA reads like any bf16 tensor, the part p
// of batch b at the map's batch p * batch + b. A product of two operands
// sums the terms (part i of A, part j of B) with i + j <= 2, each a
// wgmma product with fp32 accumulators over all its k-steps in turn:
// the six of a three-part split smallest first (hi·lo, mid·mid, lo·hi,
// hi·mid, mid·hi, hi·hi), or hi·hi alone for NP = 1. The three dropped
// terms (mid·lo, lo·mid, lo·lo) and the split's own residue come to about
// 2^-22 of |a||b| a product, the size of a few fp32 roundings, so the
// fp32 contract (1e-5 of max|plain|) holds; P and dS, fp32 in registers,
// are split the same way into register A operands (to_a_parts). Six
// products where a bf16 kernel has one: the bound of this design is
// those products on the tensor cores, 6 x 2 flops a multiply-add at 989
// TFLOP/s.
//
// Shared memory sets the tiles: a three-part tile of 64 rows at D 128 is
// 48 KB. So K and V (forward, dQ pass) or Q and dO (dK/dV pass) stream
// through two single-tile slots, each with its full/empty barrier pair,
// loaded in the order of their first use and released at their last:
//   forward: Q resident (128 rows, 96 KB at D 128), K and V tiles of 64
//     keys (48 KB each): 192 KB;
//   dK/dV: K and V resident (64 or 128 keys), dO and Q tiles of 64 rows
//     (with the block's LSE and Delta), and at split_d the two
//     exchanged fp32 score tiles (32 KB): 226 KB at fp32 D 128;
//   dQ: Q and dO resident (64 or 128 rows), V and K tiles of 64 keys,
//     the exchange: 225 KB at fp32 D 128.
// At three parts and D 256 those tiles take twice as much (a 64-row tile
// is 96 KB), and no tiling of one CTA fits them: K and V resident for the
// 64 keys of one wgmma take 192 KB alone. So there each kernel runs on a
// cluster of two CTAs (split_ctas), and CTA r holds the parts of columns
// [128 r, 128 r + 128) of every operand: the tiles, the loop and the
// shared memory of D 128 (230 KB with the exchange below). A score tile
// (S, dP, or their transposes) is a product over all of D, so each CTA
// forms its partial over its columns, sends it to the other CTA's
// exchange slot through distributed shared memory (cluster_send), and
// adds the one it receives (cluster_add): x0 + x1 in one, x1 + x0 in the
// other, the same fp32 sum, so both CTAs hold the same tile and run the
// same softmax. The products whose K axis is a key or a row (P V, P^T
// dO, dS^T Q, dS K) need no exchange: each CTA accumulates and stores its
// own columns. Each exchange costs two cluster barriers (stores visible;
// the slot read, before the next stores), the second one's wait deferred
// to the next exchange. The alternative plans cost more: the resident
// operands in fp32 (64 KB a tile) split into register parts at every
// k-step leave no room for the exchange beside 32-row streamed tiles in
// the dK/dV pass (240 KB), and 16-row tiles would make every wgmma N 16.
// The head dim stays a template parameter: a wider head (ROADMAP.md queue
// C item 1) is a larger cluster of the same CTAs.
// Registers set the split of the work (split_d): where the resident
// rows' accumulators of all of a CTA's columns would not fit beside the
// score tiles and the split P (fp32 D 128: dK and dV for 64 keys, 2 x 64,
// plus two 32-entry score tiles, plus 48 for P's three parts; bf16 D 256:
// 2 x 128), the two consumer warpgroups own the SAME 64 rows and each
// accumulates the columns of its half of the CTA's width; warpgroup 0
// computes S (or S^T) and warpgroup 1 dP (dP^T), and they trade the two
// fp32 tiles through shared memory, so each holds both, and the products
// stay those of one owner. Otherwise (fp32 D 64) each warpgroup owns 64
// rows of its own and all columns, as in the bf16 kernels.
//
// A CTA is the two consumer warpgroups alone, 256 threads, and a thread
// of warpgroup 0 issues the loads: each next tile once both warpgroups
// have released its slot (they run in step). So every thread may take
// 255 registers (two warps on each of the SM's four register files of
// 16,384), where the bf16 kernels' 384 threads get 168 (three warps a
// file, a 288-thread CTA too): ptxas allocates the consumers at the
// launch bound whatever setmaxnreg later moves, and at 168 registers it
// serialized the split kernels' wgmma (C7512) and spilled up to 408 bytes
// (the one-part D 256 dK/dV kernel).
constexpr int kSplitThreads = 128 * kConsumers;

// CTAs a kernel of padded width D runs on (a cluster along x), and the
// columns of D each holds
template <int D, int NP>
__host__ __device__ constexpr int split_ctas() {
  return NP == 3 && D > 128 ? 2 : 1;
}
template <int D, int NP>
__host__ __device__ constexpr int cta_cols() {
  return D / split_ctas<D, NP>();
}
// W below is a CTA's width, cta_cols
template <int W, int NP>
__host__ __device__ constexpr bool split_d() {
  return NP * W >= 256;
}
// rows of the resident side a CTA owns
template <int W, int NP>
__host__ __device__ constexpr int owned_rows() {
  return split_d<W, NP>() ? 64 : 128;
}
// columns of the CTA's width a consumer warpgroup accumulates
template <int W, int NP>
__host__ __device__ constexpr int owned_cols() {
  return split_d<W, NP>() ? W / 2 : W;
}

// the NP part tiles of R rows and W columns from col0 of one head (parts
// from the map's batches b, b + batch, ..) into the split operand at
// `tile`
template <int R, int W, int NP>
__device__ __forceinline__ void load_split(uint32_t tile,
                                           const CUtensorMap* map,
                                           uint32_t bar, int head, int row,
                                           int b, int batch, int col0) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
    tma_load_tile<R, W>(tile + p * tile_bytes<W>(R), map, bar, head, row,
                        b + p * batch, col0);
}

// acc = A B^T over the K axis W: A rows [row0, row0 + 64) of a split
// operand of RA rows, B a split operand of N rows, both K-major
// (wgmma m64nNk16, the terms in order)
template <int NP, int W, int RA, int N>
__device__ __forceinline__ void split_ss(float (&acc)[N / 2], uint32_t a,
                                         int row0, uint32_t b) {
#pragma unroll
  for (int t = first_term<NP>(); t < 6; ++t)
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      wgmma_ss<N>(acc,
                  desc_k_major<RA>(a + term_a(t) * tile_bytes<W>(RA), row0,
                                   kk),
                  desc_k_major<N>(b + term_b(t) * tile_bytes<W>(N), 0, kk),
                  t > first_term<NP>() || kk > 0);
}

// acc += A B: A the register parts of a 64 x R score tile (K axis R), B a
// split operand of R rows and W columns read MN-major, N of its columns
// from the 64-column region at byte offset `region` of each part tile
template <int NP, int W, int R, int N>
__device__ __forceinline__ void split_rs(float (&acc)[N / 2],
                                         const uint32_t (&a)[NP][R / 16][4],
                                         uint32_t b, uint32_t region) {
#pragma unroll
  for (int t = first_term<NP>(); t < 6; ++t)
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      wgmma_rs<N>(acc, a[term_a(t)][kk],
                  desc_mn_major<R>(b + term_b(t) * tile_bytes<W>(R) + region,
                                   kk));
}

// The exchange slot of warpgroup wg's thread t: 32 entries of a 64 x 64
// fp32 tile in xch + wg * 4096, entry i at (i / 4) * 512 + 4 t + i % 4
// (16 bytes a store, a warp's stores contiguous).
__device__ __forceinline__ float* slot_of(float* xch, int wg, int t) {
  return xch + wg * 4096 + 4 * t;
}
__device__ __forceinline__ void store_slot(float* slot, const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(slot + 512 * j) =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}
__device__ __forceinline__ void load_slot(float (&x)[32], const float* slot) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(slot + 512 * j);
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }
}

// A split_ctas 2 kernel's partial score tile x (this CTA's columns) into
// the same slot of the other CTA of the cluster. The kernel arrives at
// the cluster barrier once before its first exchange, and after the last
// read of each exchange's slots; so the wait here is for the other CTA to
// have read the slot's previous tile, and the arrive and wait after the
// stores make them visible there.
__device__ __forceinline__ void cluster_send(const float (&x)[32],
                                             float* slot) {
  const uint32_t remote = cluster_addr(smem_addr(slot), cluster_rank() ^ 1);
  cluster_wait();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_cluster(remote + 2048 * j,
               make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                           x[4 * j + 3]));
  cluster_arrive();
  cluster_wait();
}
// x += the other CTA's partial, from this thread's slot: the whole tile,
// the same in both CTAs (fp32 addition commutes)
__device__ __forceinline__ void cluster_add(float (&x)[32],
                                            const float* slot) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(slot + 512 * j);
    x[4 * j] += v.x;
    x[4 * j + 1] += v.y;
    x[4 * j + 2] += v.z;
    x[4 * j + 3] += v.w;
  }
}

// The two 64 x 64 score tiles of a backward block, x = A0 B0^T and y =
// A1 B1^T (S and dP, or S^T and dP^T; A from rows row0 of RA-row
// operands). At split_d warpgroup w computes product w alone (the same
// instructions on its own operands: wgmma in a branch is serialized), at
// split_ctas 2 completes it with the other CTA's partial, and the two
// warpgroups trade their tiles through their slots (one barrier; a
// later write waits for a slot that every consumer releases after these
// reads, and the other CTA's next stores wait for the cluster arrival
// after them). Otherwise each computes both.
template <int NP, int W, int RA, bool kSplit, int CL>
__device__ __forceinline__ void score_tiles(float (&x)[32], float (&y)[32],
                                            uint32_t a0, uint32_t b0,
                                            uint32_t a1, uint32_t b1,
                                            int row0, float* xch, int wg,
                                            int t) {
  wgmma_fence();
  if constexpr (kSplit) {
    float mine[32], other[32];
    split_ss<NP, W, RA, 64>(mine, wg ? a1 : a0, row0, wg ? b1 : b0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(mine);
    float* slot = slot_of(xch, wg, t);
    if constexpr (CL > 1) {
      cluster_send(mine, slot);
      cluster_add(mine, slot);
    }
    store_slot(slot, mine);
    named_sync(1, 128 * kConsumers);
    load_slot(other, slot_of(xch, 1 - wg, t));
    if constexpr (CL > 1) cluster_arrive();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = wg ? other[i] : mine[i];
      y[i] = wg ? mine[i] : other[i];
    }
  } else {
    split_ss<NP, W, RA, 64>(x, a0, row0, b0);
    split_ss<NP, W, RA, 64>(y, a1, row0, b1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);
    fence_regs(y);
  }
}

// ------------------------------------------------- split design: forward
// Three parts (fp32, or the rotated bf16 rope-on-load operands) at D 64,
// 128 and 256 (a cluster of two CTAs, each on 128 columns). A CTA owns
// 128 q rows (64 per consumer warpgroup, Q resident) and walks k/v blocks
// of 64 keys: slot 0 holds K, slot 1 V. Per block and warpgroup: S = Q
// K^T (six products m64n64k16; at split_ctas 2 over the CTA's columns,
// completed by the exchange, which every thread takes part in), the
// online softmax, P split into three register operands, O += P V (six
// products m64nWk16, V MN-major) over the CTA's columns. No value is
// rounded before O is stored in T. A null `lse` stores no LSE (the
// rope-on-load forward, whose backward recomputes it).
template <int D>
__host__ __device__ constexpr Layout fwd_split_layout() {
  constexpr int W = cta_cols<D, 3>();
  return {3 * tile_bytes<W>(128), 3 * tile_bytes<W>(64),
          split_ctas<D, 3>() > 1 ? 2 * 64 * 64 * 4 : 0};
}

template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_fwd_split_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           T* __restrict__ o, float* __restrict__ lse,
                           int batch, int heads, int sq, int sk, int d,
                           float scale_log2, int causal) {
  constexpr int NP = 3, kM = 128, kN = 64;
  constexpr int CL = split_ctas<D, NP>(), W = cta_cols<D, NP>();
  constexpr Layout L = fwd_split_layout<D>();
  extern __shared__ uint8_t smem_raw[];
  Bars bars;
  const uint32_t base = setup(smem_raw, L, 1, bars);
  const uint32_t sQ = base, sK = base + L.stage_at(0),
                 sV = base + L.stage_at(1);
  float* xch = reinterpret_cast<float*>(
      smem_raw + (base - smem_addr(smem_raw)) + L.extra_at());

  // longest rows first; the CTAs of a cluster share their rows
  const int q0 = (gridDim.x / CL - 1 - blockIdx.x / CL) * kM;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int colc = rank * W;  // this CTA's first column of D
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int shift = sk - sq;  // row r sees column c iff c <= r + shift
  const int k_end = causal ? min(sk, q0 + kM + shift) : sk;
  const int nblk = (k_end + kN - 1) / kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // thread 0 issues the loads: slot s's tile of block `it` once both
  // warpgroups have released the slot's previous tile
  const bool issuer = threadIdx.x == 0;
  auto load = [&](int s, int it) {
    if (it > 0) mbar_wait(bars.empty(s), (it - 1) & 1);
    mbar_arrive_expect_tx(bars.full(s), L.stage);
    load_split<kN, W, NP>(s ? sV : sK, s ? &mv : &mk, bars.full(s), h,
                          it * kN, b, batch, colc);
  };
  if (issuer) {
    mbar_arrive_expect_tx(bars.resident, L.resident);
    load_split<kM, W, NP>(sQ, &mq, bars.resident, h, q0, b, batch, colc);
    load(0, 0);
    load(1, 0);
  }

  const int wg = warp / 4, t = threadIdx.x % 128;
  const int wrow = q0 + 64 * wg;  // this warpgroup's first row
  const int ra = wrow + (t / 32) * 16 + lane / 4, rb = ra + 8;
  const int cq = 2 * (lane % 4);
  const bool live = wrow < sq;
  const int last_col =
      causal ? min(sk - 1, min(wrow + 63, sq - 1) + shift) : sk - 1;

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
  float ma = -INFINITY, mb = -INFINITY, la = 0.0f, lb = 0.0f;

  if constexpr (CL > 1) cluster_arrive();
  mbar_wait(bars.resident, 0);
  for (int it = 0; it < nblk; ++it) {
    const int k0 = it * kN;
    // blocks wholly past this warpgroup's last visible column are skipped
    const bool work = live && k0 <= last_col;
    float sc[kN / 2];
    uint32_t p[NP][kN / 16][4];
    mbar_wait(bars.full(0), it & 1);
    if (work) {
      wgmma_fence();
      split_ss<NP, W, kM, kN>(sc, sQ, 64 * wg, sK);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
    } else if constexpr (CL > 1) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sc[i] = 0.0f;
    }
    mbar_arrive(bars.empty(0));
    if (issuer && it + 1 < nblk) load(0, it + 1);
    if constexpr (CL > 1) {
      // the other CTA's warpgroup of the same rows skips the same blocks
      float* slot = slot_of(xch, wg, t);
      cluster_send(sc, slot);
      cluster_add(sc, slot);
      cluster_arrive();
    }
    if (work) {
      const bool mask =
          k0 + kN > sk || (causal && k0 + kN - 1 > wrow + shift);
      softmax_block<kN>(sc, acc, ma, mb, la, lb, mask, k0, cq, ra, rb, sk,
                        shift, causal, scale_log2);
      to_a_parts<NP, kN / 16>(sc, p);
    }
    mbar_wait(bars.full(1), it & 1);
    if (work) {
      wgmma_fence();
      split_rs<NP, W, kN, W>(acc, p, sV, 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p);
    }
    mbar_arrive(bars.empty(1));
    if (issuer && it + 1 < nblk) load(1, it + 1);
  }
  if constexpr (CL > 1) cluster_wait();

  if (!live) return;
  la = quad_sum(la);
  lb = quad_sum(lb);
  const long long rowvec = ((long long)b * heads + h) * sq;
  if (ra < sq) {
    store_row<W>(o + (((long long)b * sq + ra) * heads + h) * d + colc, acc,
                 0, cq, 1.0f / la, d - colc);
    if (cq == 0 && lse && rank == 0) lse[rowvec + ra] = ma * kLn2 + logf(la);
  }
  if (rb < sq) {
    store_row<W>(o + (((long long)b * sq + rb) * heads + h) * d + colc, acc,
                 1, cq, 1.0f / lb, d - colc);
    if (cq == 0 && lse && rank == 0) lse[rowvec + rb] = mb * kLn2 + logf(lb);
  }
}

// --------------------------------------------- split design: dK, dV pass
// A CTA owns owned_rows keys (K and V resident, its columns) and walks the
// q blocks of 64 rows from the causal start: slot 1 holds dO and the
// block's LSE (in log2 units, +inf past sq so that P is 0 there) and
// Delta, slot 0 Q. Per block: S^T = K Q^T and dP^T = V dO^T (m64n64k16;
// at split_d warpgroup 0 computes the first, warpgroup 1 the second, and
// they trade them, after the cluster's exchange at split_ctas 2:
// score_tiles), P^T and dS^T = P^T (dP^T - Delta) scale in fp32
// registers, then dV += P^T dO (slot 1 released) and dK += dS^T Q (slot 0
// released), each warpgroup over its columns (m64nCk16, the operands'
// parts from registers, dO and Q MN-major). NP = 1 rounds P^T and dS^T to
// bf16 (the stock kernel's p.T.astype, ds.T.astype).
template <int D, int NP>
__host__ __device__ constexpr Layout dkdv_split_layout() {
  constexpr int W = cta_cols<D, NP>();
  return {2 * NP * tile_bytes<W>(owned_rows<W, NP>()), NP * tile_bytes<W>(64),
          2 * 64 * 4 + (split_d<W, NP>() ? 2 * 64 * 64 * 4 : 0)};
}

template <typename T, int D, int NP>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mdo,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int batch, int heads, int sq, int sk, int d,
                                float scale, float scale_log2, int causal) {
  constexpr int CL = split_ctas<D, NP>(), W = cta_cols<D, NP>();
  constexpr bool kSplit = split_d<W, NP>();
  constexpr int kR = owned_rows<W, NP>(), kC = owned_cols<W, NP>(), kM = 64;
  constexpr Layout L = dkdv_split_layout<D, NP>();
  extern __shared__ uint8_t smem_raw[];
  Bars bars;
  // each full barrier: the 32 lanes of warp 0, which loads (+ the TMA)
  const uint32_t base = setup(smem_raw, L, 32, bars);
  const uint32_t sK = base, sV = base + NP * tile_bytes<W>(kR);
  const uint32_t sQ = base + L.stage_at(0), sG = base + L.stage_at(1);
  float* vecs = reinterpret_cast<float*>(
      smem_raw + (base - smem_addr(smem_raw)) + L.extra_at());
  float* xch = vecs + 2 * kM;

  // the first keys see the most rows; the CTAs of a cluster share keys
  const int k0 = blockIdx.x / CL * kR;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int colc = rank * W;  // this CTA's first column of D
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int shift = sk - sq;
  int q_first = causal ? max(0, k0 - shift) : 0;
  q_first = (q_first / kM) * kM;
  const int nblk = (sq - q_first + kM - 1) / kM;
  const long long rowvec = ((long long)b * heads + h) * sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // warp 0 issues the loads (lane 0) and writes each q block's row
  // vectors with slot 1's tile: slot s's tile of block `it` once both
  // warpgroups have released the slot's previous tile
  auto load = [&](int s, int it) {
    const int q0 = q_first + it * kM;
    if (it > 0) mbar_wait(bars.empty(s), (it - 1) & 1);
    if (s == 1) {
      for (int i = lane; i < kM; i += 32) {
        const int r = q0 + i;
        vecs[i] = r < sq ? lse[rowvec + r] * kLog2e : INFINITY;
        vecs[kM + i] = r < sq ? delta[rowvec + r] : 0.0f;
      }
      __syncwarp();
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.full(s), L.stage);
      load_split<kM, W, NP>(s ? sG : sQ, s ? &mdo : &mq, bars.full(s), h,
                            q0, b, batch, colc);
    } else {
      mbar_arrive(bars.full(s));
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bars.resident, L.resident);
      load_split<kR, W, NP>(sK, &mk, bars.resident, h, k0, b, batch, colc);
      load_split<kR, W, NP>(sV, &mv, bars.resident, h, k0, b, batch, colc);
    }
    load(1, 0);
    load(0, 0);
  }

  const int wg = warp / 4, t = threadIdx.x % 128;
  const int rk = kSplit ? 0 : 64 * wg;  // first resident row of this wg
  const int wkey = k0 + rk;             // this warpgroup's first key
  const int ca = wkey + (t / 32) * 16 + lane / 4, cb = ca + 8;
  const int cq = 2 * (lane % 4);
  const bool live = wkey < sk;
  const int q_lo = causal ? wkey - shift : 0;  // the first row to see wkey
  const int cw = kSplit ? wg * kC : 0;  // this wg's first column of the CTA's
  const int col0 = colc + cw;           // .. and of D
  const uint32_t region = cw / 64 * (kM * 128);

  float adk[kC / 2], adv[kC / 2];
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) adk[i] = adv[i] = 0.0f;

  if constexpr (CL > 1) cluster_arrive();
  mbar_wait(bars.resident, 0);
  for (int it = 0; it < nblk; ++it) {
    const int q0 = q_first + it * kM;
    // at split_d both warpgroups (and both CTAs of a cluster) own the same
    // keys: `work` agrees
    const bool work = live && q0 + kM - 1 >= q_lo;
    float st[kM / 2], dpt[kM / 2];
    mbar_wait(bars.full(1), it & 1);
    mbar_wait(bars.full(0), it & 1);
    if (work) {
      score_tiles<NP, W, kR, kSplit, CL>(st, dpt, sK, sQ, sV, sG, rk, xch,
                                         wg, t);
      // masked: rows past sq, or rows above this warpgroup's last key
      const bool mask = q0 + kM > sq || (causal && q0 < wkey + 63 - shift);
#pragma unroll
      for (int j = 0; j < kM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rl = 8 * j + cq + e, r = q0 + rl;
          const float lr = vecs[rl], dr = vecs[kM + rl];
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
      uint32_t pa[NP][kM / 16][4];
      to_a_parts<NP, kM / 16>(st, pa);
      wgmma_fence();
      split_rs<NP, W, kM, kC>(adv, pa, sG, region);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adv);
      fence_regs(pa);
    }
    mbar_arrive(bars.empty(1));
    if (warp == 0 && it + 1 < nblk) load(1, it + 1);
    if (work) {
      uint32_t da[NP][kM / 16][4];
      to_a_parts<NP, kM / 16>(dpt, da);
      wgmma_fence();
      split_rs<NP, W, kM, kC>(adk, da, sQ, region);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adk);
      fence_regs(da);
    }
    mbar_arrive(bars.empty(0));
    if (warp == 0 && it + 1 < nblk) load(0, it + 1);
  }
  if constexpr (CL > 1) cluster_wait();

  if (!live) return;
  if (ca < sk) {
    const long long off = (((long long)b * sk + ca) * heads + h) * d + col0;
    store_row<kC>(dk + off, adk, 0, cq, 1.0f, d - col0);
    store_row<kC>(dv + off, adv, 0, cq, 1.0f, d - col0);
  }
  if (cb < sk) {
    const long long off = (((long long)b * sk + cb) * heads + h) * d + col0;
    store_row<kC>(dk + off, adk, 1, cq, 1.0f, d - col0);
    store_row<kC>(dv + off, adv, 1, cq, 1.0f, d - col0);
  }
}

// ------------------------------------------------- split design: dQ pass
// A CTA owns owned_rows q rows (Q and dO resident, its columns) and walks
// the k/v blocks of 64 keys to its causal end: slot 1 holds V, slot 0 K.
// Per block: S = Q K^T and dP = dO V^T (slot 1 released; at split_d
// warpgroup 0 computes the first, warpgroup 1 the second, and they trade
// them, after the cluster's exchange at split_ctas 2: score_tiles), P and
// dS = P (dP - Delta) scale in fp32 registers, dQ += dS K over the
// warpgroup's columns (slot 0 released; K MN-major). NP = 1 rounds dS to
// bf16 (the stock ds.astype(k.dtype)).
template <int D, int NP>
__host__ __device__ constexpr Layout dq_split_layout() {
  constexpr int W = cta_cols<D, NP>();
  return {2 * NP * tile_bytes<W>(owned_rows<W, NP>()), NP * tile_bytes<W>(64),
          split_d<W, NP>() ? 2 * 64 * 64 * 4 : 0};
}

template <typename T, int D, int NP>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_bwd_dq_split_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mdo,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq, int batch, int heads,
                              int sq, int sk, int d, float scale,
                              float scale_log2, int causal) {
  constexpr int CL = split_ctas<D, NP>(), W = cta_cols<D, NP>();
  constexpr bool kSplit = split_d<W, NP>();
  constexpr int kR = owned_rows<W, NP>(), kC = owned_cols<W, NP>(), kN = 64;
  constexpr Layout L = dq_split_layout<D, NP>();
  extern __shared__ uint8_t smem_raw[];
  Bars bars;
  const uint32_t base = setup(smem_raw, L, 1, bars);
  const uint32_t sQ = base, sG = base + NP * tile_bytes<W>(kR);
  const uint32_t sK = base + L.stage_at(0), sV = base + L.stage_at(1);
  float* xch = reinterpret_cast<float*>(
      smem_raw + (base - smem_addr(smem_raw)) + L.extra_at());

  // longest rows first; the CTAs of a cluster share their rows
  const int q0 = (gridDim.x / CL - 1 - blockIdx.x / CL) * kR;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int colc = rank * W;  // this CTA's first column of D
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int shift = sk - sq;
  const int k_end = causal ? min(sk, q0 + kR + shift) : sk;
  const int nblk = (k_end + kN - 1) / kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // thread 0 issues the loads: slot s's tile of block `it` once both
  // warpgroups have released the slot's previous tile
  const bool issuer = threadIdx.x == 0;
  auto load = [&](int s, int it) {
    if (it > 0) mbar_wait(bars.empty(s), (it - 1) & 1);
    mbar_arrive_expect_tx(bars.full(s), L.stage);
    load_split<kN, W, NP>(s ? sV : sK, s ? &mv : &mk, bars.full(s), h,
                          it * kN, b, batch, colc);
  };
  if (issuer) {
    mbar_arrive_expect_tx(bars.resident, L.resident);
    load_split<kR, W, NP>(sQ, &mq, bars.resident, h, q0, b, batch, colc);
    load_split<kR, W, NP>(sG, &mdo, bars.resident, h, q0, b, batch, colc);
    load(1, 0);
    load(0, 0);
  }

  const int wg = warp / 4, t = threadIdx.x % 128;
  const int rq = kSplit ? 0 : 64 * wg;  // first resident row of this wg
  const int wrow = q0 + rq;
  const int ra = wrow + (t / 32) * 16 + lane / 4, rb = ra + 8;
  const int cq = 2 * (lane % 4);
  const bool live = wrow < sq;
  const int last_col =
      causal ? min(sk - 1, min(wrow + 63, sq - 1) + shift) : sk - 1;
  const int cw = kSplit ? wg * kC : 0;  // this wg's first column of the CTA's
  const int col0 = colc + cw;           // .. and of D
  const uint32_t region = cw / 64 * (kN * 128);
  const long long rowvec = ((long long)b * heads + h) * sq;
  // rows past sq: P is 0 (LSE +inf); they are not written
  const float la = ra < sq ? lse[rowvec + ra] * kLog2e : INFINITY;
  const float lb = rb < sq ? lse[rowvec + rb] * kLog2e : INFINITY;
  const float dea = ra < sq ? delta[rowvec + ra] : 0.0f;
  const float deb = rb < sq ? delta[rowvec + rb] : 0.0f;

  float adq[kC / 2];
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) adq[i] = 0.0f;

  if constexpr (CL > 1) cluster_arrive();
  mbar_wait(bars.resident, 0);
  for (int it = 0; it < nblk; ++it) {
    const int k0 = it * kN;
    // at split_d both warpgroups (and both CTAs of a cluster) own the same
    // rows: `work` agrees
    const bool work = live && k0 <= last_col;
    float sc[kN / 2], dp[kN / 2];
    mbar_wait(bars.full(1), it & 1);
    mbar_wait(bars.full(0), it & 1);
    if (work)
      score_tiles<NP, W, kR, kSplit, CL>(sc, dp, sQ, sK, sG, sV, rq, xch, wg,
                                         t);
    mbar_arrive(bars.empty(1));
    if (issuer && it + 1 < nblk) load(1, it + 1);
    if (work) {
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
      uint32_t dsa[NP][kN / 16][4];
      to_a_parts<NP, kN / 16>(dp, dsa);
      wgmma_fence();
      split_rs<NP, W, kN, kC>(adq, dsa, sK, region);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adq);
      fence_regs(dsa);
    }
    mbar_arrive(bars.empty(0));
    if (issuer && it + 1 < nblk) load(0, it + 1);
  }
  if constexpr (CL > 1) cluster_wait();

  if (!live) return;
  if (ra < sq)
    store_row<kC>(dq + (((long long)b * sq + ra) * heads + h) * d + col0, adq,
                  0, cq, 1.0f, d - col0);
  if (rb < sq)
    store_row<kC>(dq + (((long long)b * sq + rb) * heads + h) * d + col0, adq,
                  1, cq, 1.0f, d - col0);
}

// ------------------------------------------------------------ launches
// The tensor map of a bf16 (or `type`: fp16) [batch, seq, heads, d] tensor
// read through its
// strides (elements; multiples of 8, so 16-byte multiples in bytes, as
// TMA needs), as (d, heads, seq, batch) innermost first: boxes of 64
// columns x `box_rows` rows of one head, 128-byte swizzle, rows past seq
// and columns past the head dim d zero-filled. A kernel instantiated at a
// wider D (d 80 runs the D 128 kernel) so reads its tiles with zeros from
// d to D: they add nothing to q . k, and the P V columns they give are
// never stored.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                     int heads, int d, Strides st, int box_rows,
                     CUtensorMapDataType type =
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  return encode_map(map, type, 4, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename E, int D, bool kPad>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, a.q, a.batch, a.sq, a.heads, a.d, a.qs,
                      128, map_type<E>())) ||
      (err = make_map(&mk, a.k, a.batch, a.sk, a.heads, a.d, a.ks,
                      fwd_keys<D>(), map_type<E>())) ||
      (err = make_map(&mv, a.v, a.batch, a.sk, a.heads, a.d, a.vs,
                      fwd_keys<D>(), map_type<E>())))
    return err;
  constexpr int smem = fwd_layout<D>().bytes();
  if ((err = allow_smem(flash_fwd_tc_kernel<E, D, kPad>, smem))) return err;
  dim3 grid((a.sq + 127) / 128, a.batch * a.heads);
  flash_fwd_tc_kernel<E, D, kPad><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<E*>(a.o), static_cast<float*>(a.lse),
      a.heads, a.sq, a.sk, a.d, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename E, int D, bool kPad>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.batch * a.heads * a.sq;
  flash_bwd_delta_kernel<E, D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                     stream>>>(
      static_cast<const E*>(a.o), static_cast<const E*>(a.dout),
      static_cast<float*>(a.delta), a.os, a.dos, a.batch, a.heads, a.sq,
      a.d);
  cudaError_t err = cudaGetLastError();
  if (err) return err;

  // dK/dV: q and dO in blocks of 64 rows, k and v resident (128 rows)
  CUtensorMap mq, mdo, mk, mv;
  if ((err = make_map(&mq, a.q, a.batch, a.sq, a.heads, a.d, a.qs,
                      64, map_type<E>())) ||
      (err = make_map(&mdo, a.dout, a.batch, a.sq, a.heads, a.d, a.dos,
                      64, map_type<E>())) ||
      (err = make_map(&mk, a.k, a.batch, a.sk, a.heads, a.d, a.ks,
                      128, map_type<E>())) ||
      (err = make_map(&mv, a.v, a.batch, a.sk, a.heads, a.d, a.vs,
                      128, map_type<E>())))
    return err;
  constexpr int smem_kv = dkdv_layout<D>().bytes();
  if ((err = allow_smem(flash_bwd_dkdv_tc_kernel<E, D, kPad>, smem_kv)))
    return err;
  dim3 grid_k((a.sk + 127) / 128, a.batch * a.heads);
  const float scale_log2 = a.scale * kLog2e;
  flash_bwd_dkdv_tc_kernel<E, D, kPad><<<grid_k, kThreads, smem_kv, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<E*>(a.dk),
      static_cast<E*>(a.dv), a.heads, a.sq, a.sk, a.d, a.scale,
      scale_log2, a.causal);
  if ((err = cudaGetLastError())) return err;

  // dQ: q and dO resident (128 rows), k and v in blocks of 64 rows
  if ((err = make_map(&mq, a.q, a.batch, a.sq, a.heads, a.d, a.qs,
                      128, map_type<E>())) ||
      (err = make_map(&mdo, a.dout, a.batch, a.sq, a.heads, a.d, a.dos,
                      128, map_type<E>())) ||
      (err = make_map(&mk, a.k, a.batch, a.sk, a.heads, a.d, a.ks,
                      64, map_type<E>())) ||
      (err = make_map(&mv, a.v, a.batch, a.sk, a.heads, a.d, a.vs,
                      64, map_type<E>())))
    return err;
  constexpr int smem_q = dq_layout<D>().bytes();
  if ((err = allow_smem(flash_bwd_dq_tc_kernel<E, D, kPad>, smem_q)))
    return err;
  dim3 grid_q((a.sq + 127) / 128, a.batch * a.heads);
  flash_bwd_dq_tc_kernel<E, D, kPad><<<grid_q, kThreads, smem_q, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<E*>(a.dq), a.heads,
      a.sq, a.sk, a.d, a.scale, scale_log2, a.causal);
  return cudaGetLastError();
}

template <int D, bool kPad>
cudaError_t launch_rope_fwd(const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, a.q, a.batch, a.sq, a.heads, a.d, a.qs, 128)) ||
      (err = make_map(&mk, a.k, a.batch, a.sk, a.heads, a.d, a.ks, 128)) ||
      (err = make_map(&mv, a.v, a.batch, a.sk, a.heads, a.d, a.vs, 128)))
    return err;
  constexpr int smem = rope_layout<D>().bytes();
  if ((err = allow_smem(rope_attention_fwd_tc_kernel<D, kPad>, smem)))
    return err;
  dim3 grid((a.sq + 127) / 128, a.batch * a.heads);
  rope_attention_fwd_tc_kernel<D, kPad><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(a.o), static_cast<const float*>(a.cos),
      static_cast<const float*>(a.sin), a.tab_stride,
      a.heads, a.sq, a.d, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// An operand of a split-design kernel as its tensor map reads it: a bf16
// tensor as it is (NP = 1), or an fp32 (or bf16: T) one split by
// split3_kernel into the next 3 x batch x seq x heads x D values of the
// workspace `*work` (NP = 3), at the map's batch 3 x batch and head dim D.
struct Operand {
  const void* ptr;
  Strides st;
  int batch, d;
};

template <int D, int NP, typename T = float>
cudaError_t operand(Operand* op, const void* x, Strides st, int batch,
                    int seq, int heads, int d, bf16** work,
                    cudaStream_t stream) {
  if (NP == 1) {
    *op = {x, st, batch, d};
    return cudaSuccess;
  }
  bf16* out = *work;
  *work += 3LL * batch * seq * heads * D;
  const long long chunks = (long long)batch * seq * heads * (D / 8);
  split3_kernel<T><<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(x), out, st, batch, seq, heads, d, D);
  *op = {out, {(long long)seq * heads * D, (long long)heads * D, D},
         3 * batch, D};
  return cudaGetLastError();
}

cudaError_t make_map(CUtensorMap* map, const Operand& op, int seq, int heads,
                     int box_rows) {
  return make_map(map, op.ptr, op.batch, seq, heads, op.d, op.st, box_rows);
}

// A split-design kernel on `grid` (x a multiple of CL) with 256 threads
// and `smem` bytes, in clusters of CL CTAs along x
template <int CL, typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int smem,
                         cudaStream_t stream, Args&&... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err ? err : cudaGetLastError();
}

// The forward on split operands q, k, v (three parts each), O in T
template <typename T, int D>
cudaError_t fwd_split(const FwdArgs& a, const Operand& q, const Operand& k,
                      const Operand& v, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, q, a.sq, a.heads, 128)) ||
      (err = make_map(&mk, k, a.sk, a.heads, 64)) ||
      (err = make_map(&mv, v, a.sk, a.heads, 64)))
    return err;
  constexpr int CL = split_ctas<D, 3>();
  dim3 grid(CL * ((a.sq + 127) / 128), a.batch * a.heads);
  return launch_split<CL>(flash_fwd_split_kernel<T, D>,
                          grid, fwd_split_layout<D>().bytes(), stream, mq, mk,
                          mv, static_cast<T*>(a.o),
                          static_cast<float*>(a.lse), a.batch, a.heads, a.sq,
                          a.sk, a.d, a.scale * kLog2e, a.causal);
}

// fp32: the parts of q, k and v into the workspace, then the forward
template <int D>
cudaError_t launch_fwd_split(const FwdArgs& a, void* work,
                             cudaStream_t stream) {
  bf16* w = static_cast<bf16*>(work);
  Operand q, k, v;
  cudaError_t err;
  if ((err = operand<D, 3>(&q, a.q, a.qs, a.batch, a.sq, a.heads, a.d, &w,
                           stream)) ||
      (err = operand<D, 3>(&k, a.k, a.ks, a.batch, a.sk, a.heads, a.d, &w,
                           stream)) ||
      (err = operand<D, 3>(&v, a.v, a.vs, a.batch, a.sk, a.heads, a.d, &w,
                           stream)))
    return err;
  return fwd_split<float, D>(a, q, k, v, stream);
}

// The rotate-and-split pre-pass of the split rope-on-load forward: q or k,
// fp32 or bf16 (T) [batch, seq, heads, d] read through its strides (d a
// multiple of 16), every row rotated by its position's table row in fp32
// (a bf16 value is cast exactly) and written as three bf16 parts into the
// contiguous scratch [3, batch, seq, heads, D] (the layout operand<D, 3>
// builds), columns d to D zero. Neox: out[:d/2] = x1 cos - x2 sin,
// out[d/2:d] = x2 cos + x1 sin, column c paired with c + d/2 of the true
// d, fp32 in _rotate's op order with no fused multiply-add (the rope
// kernel's arithmetic), so the rotated value is the fp32 one and its
// three parts keep all of it. A thread rotates 8 columns of a row, all in
// one half (d / 2 is a multiple of 8).
template <typename T>
__global__ void rope_split3_kernel(const T* __restrict__ x,
                                   bf16* __restrict__ out, Strides st,
                                   const float* __restrict__ cos,
                                   const float* __restrict__ sin,
                                   long long tab, int batch, int seq,
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
  const int h2 = d / 2;
  float v[8];
  if (c < d) {
    const bool first = c < h2;
    const int c1 = first ? c : c - h2;  // the pair's first-half column
    const T* xr = x + b * st.b + s * st.s + h * st.h;
    float x1[8], x2[8], cv[8], sv[8];
    ptt::load_floats<T, 8>(xr + c1, x1);
    ptt::load_floats<T, 8>(xr + c1 + h2, x2);
    ptt::load_floats<float, 8>(cos + s * tab + c1, cv);
    ptt::load_floats<float, 8>(sin + s * tab + c1, sv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = first ? __fsub_rn(__fmul_rn(x1[j], cv[j]),
                               __fmul_rn(x2[j], sv[j]))
                   : __fadd_rn(__fmul_rn(x2[j], cv[j]),
                               __fmul_rn(x1[j], sv[j]));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  }
  store_parts8(out + row * D + c, rows * D, v);
}

// A rotated operand of the split rope-on-load forward (q or k, the seq of
// q): rope_split3_kernel into the next 3 x batch x seq x heads x D values
// of the workspace
template <typename T, int D>
cudaError_t rope_operand(Operand* op, const FwdArgs& a, const void* x,
                         Strides st, bf16** work, cudaStream_t stream) {
  bf16* out = *work;
  *work += 3LL * a.batch * a.sq * a.heads * D;
  const long long chunks = (long long)a.batch * a.sq * a.heads * (D / 8);
  rope_split3_kernel<T><<<(unsigned)((chunks + 255) / 256), 256, 0,
                          stream>>>(
      static_cast<const T*>(x), out, st, static_cast<const float*>(a.cos),
      static_cast<const float*>(a.sin), a.tab_stride, a.batch, a.sq,
      a.heads, a.d, D);
  *op = {out, {(long long)a.sq * a.heads * D, (long long)a.heads * D, D},
         3 * a.batch, D};
  return cudaGetLastError();
}

// split rope-on-load (fp32, or bf16 outside padded d 64 to 128): q and k
// rotated and split, v split, into the workspace (its layout is the flash
// forward's), then the split forward with no LSE, O in T
template <typename T, int D>
cudaError_t launch_rope_fwd_split(const FwdArgs& a, void* work,
                                  cudaStream_t stream) {
  bf16* w = static_cast<bf16*>(work);
  Operand q, k, v;
  cudaError_t err;
  if ((err = rope_operand<T, D>(&q, a, a.q, a.qs, &w, stream)) ||
      (err = rope_operand<T, D>(&k, a, a.k, a.ks, &w, stream)) ||
      (err = operand<D, 3, T>(&v, a.v, a.vs, a.batch, a.sk, a.heads, a.d,
                              &w, stream)))
    return err;
  return fwd_split<T, D>(a, q, k, v, stream);
}

// The Delta pass, the operands (fp32: split into the workspace), the dK/dV
// pass and the dQ pass
template <typename T, int D, int NP>
cudaError_t launch_bwd_split(const BwdArgs& a, void* work,
                             cudaStream_t stream) {
  const long long rows = (long long)a.batch * a.heads * a.sq;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                  stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), a.os, a.dos, a.batch, a.heads, a.sq,
      a.d);
  cudaError_t err = cudaGetLastError();
  if (err) return err;
  bf16* w = static_cast<bf16*>(work);
  Operand q, k, v, g;
  if ((err = operand<D, NP>(&q, a.q, a.qs, a.batch, a.sq, a.heads, a.d, &w,
                            stream)) ||
      (err = operand<D, NP>(&k, a.k, a.ks, a.batch, a.sk, a.heads, a.d, &w,
                            stream)) ||
      (err = operand<D, NP>(&v, a.v, a.vs, a.batch, a.sk, a.heads, a.d, &w,
                            stream)) ||
      (err = operand<D, NP>(&g, a.dout, a.dos, a.batch, a.sq, a.heads, a.d,
                            &w, stream)))
    return err;
  constexpr int CL = split_ctas<D, NP>();
  constexpr int kR = owned_rows<cta_cols<D, NP>(), NP>();
  const float scale_log2 = a.scale * kLog2e;

  // dK/dV: q and dO in blocks of 64 rows, k and v resident
  CUtensorMap mq, mdo, mk, mv;
  if ((err = make_map(&mq, q, a.sq, a.heads, 64)) ||
      (err = make_map(&mdo, g, a.sq, a.heads, 64)) ||
      (err = make_map(&mk, k, a.sk, a.heads, kR)) ||
      (err = make_map(&mv, v, a.sk, a.heads, kR)))
    return err;
  dim3 grid_k(CL * ((a.sk + kR - 1) / kR), a.batch * a.heads);
  if ((err = launch_split<CL>(
           flash_bwd_dkdv_split_kernel<T, D, NP>, grid_k,
           dkdv_split_layout<D, NP>().bytes(), stream, mq, mdo, mk, mv,
           static_cast<const float*>(a.lse),
           static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
           static_cast<T*>(a.dv), a.batch, a.heads, a.sq, a.sk, a.d, a.scale,
           scale_log2, a.causal)))
    return err;

  // dQ: q and dO resident, k and v in blocks of 64 rows
  if ((err = make_map(&mq, q, a.sq, a.heads, kR)) ||
      (err = make_map(&mdo, g, a.sq, a.heads, kR)) ||
      (err = make_map(&mk, k, a.sk, a.heads, 64)) ||
      (err = make_map(&mv, v, a.sk, a.heads, 64)))
    return err;
  dim3 grid_q(CL * ((a.sq + kR - 1) / kR), a.batch * a.heads);
  return launch_split<CL>(
      flash_bwd_dq_split_kernel<T, D, NP>, grid_q,
      dq_split_layout<D, NP>().bytes(), stream, mq, mdo, mk, mv,
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.batch, a.heads, a.sq, a.sk, a.d, a.scale,
      scale_log2, a.causal);
}

}  // namespace tc

// Head dims: any multiple of 16 up to 256. A kernel is instantiated at
// the next of 16, 32, 64, 128, 256 (its padded width D) and takes the
// true head dim d as an argument: loads zero the columns from d to D,
// stores skip them, and the rope-on-load loader pairs column c with c +
// d/2.
inline bool served(int d) { return d % 16 == 0 && d >= 16 && d <= 256; }
inline int padded(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// The CUDA-core kernels at every served head dim, both dtypes, flash and
// rope-on-load (run on request only: cuda_cores)
template <typename T, bool kRope>
cudaError_t cc_fwd(const FwdArgs& a, cudaStream_t s) {
  if (!served(a.d)) return cudaErrorInvalidValue;
  switch (padded(a.d)) {
    case 16: return launch_fwd<T, 16, kRope>(a, s);
    case 32: return launch_fwd<T, 32, kRope>(a, s);
    case 64: return launch_fwd<T, 64, kRope>(a, s);
    case 128: return launch_fwd<T, 128, kRope>(a, s);
    default: return launch_fwd<T, 256, kRope>(a, s);
  }
}

// The tensor-core forward of a 16-bit type E at the padded width of the
// head dim, at least one 128-byte span (a separate instantiation where the
// head dim fills the width)
template <typename E>
cudaError_t tc_fwd(const FwdArgs& a, cudaStream_t s) {
  if (a.d == 64) return tc::launch_fwd<E, 64, false>(a, s);
  if (a.d < 64) return tc::launch_fwd<E, 64, true>(a, s);
  if (a.d == 128) return tc::launch_fwd<E, 128, false>(a, s);
  if (a.d < 128) return tc::launch_fwd<E, 128, true>(a, s);
  if (a.d == 256) return tc::launch_fwd<E, 256, false>(a, s);
  return tc::launch_fwd<E, 256, true>(a, s);
}

// The tensor-core backward of a 16-bit type E, head dims up to 128
template <typename E>
cudaError_t tc_bwd(const BwdArgs& a, cudaStream_t s) {
  if (a.d == 64) return tc::launch_bwd<E, 64, false>(a, s);
  if (a.d < 64) return tc::launch_bwd<E, 64, true>(a, s);
  if (a.d == 128) return tc::launch_bwd<E, 128, false>(a, s);
  return tc::launch_bwd<E, 128, true>(a, s);
}

template <typename T>
cudaError_t cc_bwd(const BwdArgs& a, cudaStream_t s) {
  if (!served(a.d)) return cudaErrorInvalidValue;
  switch (padded(a.d)) {
    case 16: return launch_bwd<T, 16>(a, s);
    case 32: return launch_bwd<T, 32>(a, s);
    case 64: return launch_bwd<T, 64>(a, s);
    case 128: return launch_bwd<T, 128>(a, s);
    default: return launch_bwd<T, 256>(a, s);
  }
}

}  // namespace

// q: [batch, sq, heads, head_dim], k and v: [batch, sk, heads, head_dim],
// each with its (batch, seq, head) strides in elements and a unit stride
// over head_dim; all strides multiples of the 16-byte vector width and the
// pointers 16-byte aligned. o: contiguous [batch, sq, heads, head_dim] of
// q's type; lse: fp32 [batch, heads, sq]. head_dim a multiple of 16 up to
// 256; sk >= sq when causal (the Python wrapper checks all of this).
// work: the split design's bf16 scratch for fp32 inputs, 3 x (batch x sq
// + 2 x batch x sk) x heads x W values, W = 64 up to head_dim 64, 128 up
// to 128, else 256 (null for bf16). cuda_cores: run the CUDA-core kernels
// whatever the dtype and head dim (the design they replaced, kept for
// comparison).
extern "C" int ptt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int sq, int sk, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, int dtype, void* work, int cuda_cores,
    void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return cudaSuccess;
  if (!served(head_dim) || (dtype != ptt::kF32 && dtype != ptt::kBF16 &&
                            dtype != ptt::kF16))
    return cudaErrorInvalidValue;
  if (dtype == ptt::kF16 && cuda_cores) return cudaErrorInvalidValue;
  FwdArgs a{q, k, v, o, lse, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
            {v_sb, v_ss, v_sh}, batch, heads, sq, sk, head_dim, causal,
            scale, nullptr, nullptr, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == ptt::kF32;
  if (cuda_cores)
    return f32 ? cc_fwd<float, false>(a, s)
               : cc_fwd<__nv_bfloat16, false>(a, s);
  if (f32) {  // split products at width 64, 128 or 256 (the pre-pass pads)
    if (work == nullptr) return cudaErrorInvalidValue;
    return head_dim <= 64    ? tc::launch_fwd_split<64>(a, work, s)
           : head_dim <= 128 ? tc::launch_fwd_split<128>(a, work, s)
                             : tc::launch_fwd_split<256>(a, work, s);
  }
  // bf16 and fp16: tensor cores at the padded width, at least one 128-byte
  // span (a separate instantiation where the head dim fills the width)
  return dtype == ptt::kF16 ? tc_fwd<__half>(a, s)
                            : tc_fwd<__nv_bfloat16>(a, s);
}

// The split rope-on-load forward at the padded width of the head dim
template <typename T>
cudaError_t rope_fwd_split(const FwdArgs& a, void* work, cudaStream_t s) {
  if (work == nullptr) return cudaErrorInvalidValue;
  return a.d <= 64    ? tc::launch_rope_fwd_split<T, 64>(a, work, s)
         : a.d <= 128 ? tc::launch_rope_fwd_split<T, 128>(a, work, s)
                      : tc::launch_rope_fwd_split<T, 256>(a, work, s);
}

// Rope-on-load forward: q, k, v [batch, seq, heads, head_dim] with their
// strides as above (one sequence length); cos and sin fp32 [seq,
// head_dim / 2] with row stride tab_stride (a multiple of 4, 16-byte
// aligned); o contiguous [batch, seq, heads, head_dim] of q's type. No
// LSE. head_dim a multiple of 16 up to 256 (the Python wrapper checks all
// of this). work: the split design's bf16 scratch (fp32, and bf16 outside
// head_dim 64 to 128), as the flash forward's (3 x 3 x batch x seq x
// heads x W values, W = 64 up to head_dim 64, 128 up to 128, else 256;
// null otherwise). cuda_cores: run the CUDA-core kernel whatever the
// dtype and head dim (the design the tensor-core ones replaced, kept for
// comparison).
extern "C" int ptt_rope_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* cos,
    const void* sin, long long tab_stride, int batch, int heads, int seq,
    int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, float scale, int dtype,
    void* work, int cuda_cores, void* stream) {
  if (batch == 0 || heads == 0 || seq == 0) return cudaSuccess;
  if (!served(head_dim) || (dtype != ptt::kF32 && dtype != ptt::kBF16))
    return cudaErrorInvalidValue;
  FwdArgs a{q, k, v, o, nullptr, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
            {v_sb, v_ss, v_sh}, batch, heads, seq, seq, head_dim, causal,
            scale, cos, sin, tab_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == ptt::kF32;
  if (cuda_cores)
    return f32 ? cc_fwd<float, true>(a, s) : cc_fwd<__nv_bfloat16, true>(a, s);
  if (f32) return rope_fwd_split<float>(a, work, s);
  // bf16 at d 64 to 128: tensor cores, hi/lo products (d 80-112 padded);
  // the other head dims: rotated in fp32 and split, as fp32
  if (head_dim == 64) return tc::launch_rope_fwd<64, false>(a, s);
  if (head_dim == 128) return tc::launch_rope_fwd<128, false>(a, s);
  if (head_dim > 64 && head_dim < 128)
    return tc::launch_rope_fwd<128, true>(a, s);
  return rope_fwd_split<__nv_bfloat16>(a, work, s);
}

// The three backward passes in order (Delta, dK/dV, dQ). o and dout have
// q's shape, lse is the forward's; delta is fp32 scratch [batch, heads,
// sq]; dq, dk, dv are contiguous with the shapes of q, k, v. work: as in
// the forward, for q, k, v and dout: 3 x (2 x batch x sq + 2 x batch x
// sk) x heads x W values (fp32; null for bf16); cuda_cores as there.
extern "C" int ptt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int heads, int sq, int sk, int head_dim,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long g_sb, long long g_ss, long long g_sh, int causal, float scale,
    int dtype, void* work, int cuda_cores, void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return cudaSuccess;
  if (!served(head_dim) || (dtype != ptt::kF32 && dtype != ptt::kBF16 &&
                            dtype != ptt::kF16))
    return cudaErrorInvalidValue;
  // fp16: the tensor-core kernels up to 128 only (the split kernels read
  // bf16 parts)
  if (dtype == ptt::kF16 && (cuda_cores || head_dim > 128))
    return cudaErrorInvalidValue;
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
            {o_sb, o_ss, o_sh}, {g_sb, g_ss, g_sh},
            batch, heads, sq, sk, head_dim, causal, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == ptt::kF32;
  if (cuda_cores)
    return f32 ? cc_bwd<float>(a, s) : cc_bwd<__nv_bfloat16>(a, s);
  if (f32) {  // split products at width 64, 128 or 256
    if (work == nullptr) return cudaErrorInvalidValue;
    return head_dim <= 64    ? tc::launch_bwd_split<float, 64, 3>(a, work, s)
           : head_dim <= 128 ? tc::launch_bwd_split<float, 128, 3>(a, work, s)
                             : tc::launch_bwd_split<float, 256, 3>(a, work, s);
  }
  // bf16 and fp16: the tensor-core kernels up to 128 (padded, at least
  // 64); bf16 runs the split design's (one part) above
  if (dtype == ptt::kF16) return tc_bwd<__half>(a, s);
  if (head_dim <= 128) return tc_bwd<__nv_bfloat16>(a, s);
  return tc::launch_bwd_split<__nv_bfloat16, 256, 1>(a, work, s);
}
