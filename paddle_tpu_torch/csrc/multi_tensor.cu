// Multi-tensor optimizer kernels for Hopper (sm_90a): the sum of squares of
// a list of gradients, and the Adam/AdamW, SGD/Momentum and Lamb updates of
// a list of parameters, each in a few launches for the whole list.
//
// Replaces: no Pallas kernel. The JAX package's optimizer layer is plain
// jax that XLA fuses inside the one jitted train step
// (paddle_tpu/jit/trainer.py:394-500: unscale and finite check, the three
// clips, decay, the per-leaf updates) and paddle_tpu/kernels/fused_adam.py:21
// fused_adam_update (one jitted update over the whole pytree, the
// counterpart of the reference's fused_adam_kernel.cu). These four families
// are the port's counterpart of that fusion:
//   mt_sumsq     fp32 sum of squares of every tensor, and a count of
//                non-finite values (the scaler's finite check, the global
//                and per-tensor norm clips, clip_grad_norm_)
//   mt_adam      _adam_update (paddle_tpu/optimizer/optimizer.py:44-56)
//   mt_momentum  _sgd_update and _momentum_update (optimizer.py:28-40)
//   mt_lamb      _lamb_update (optimizer.py:60-72), in two passes
// Before its update each kernel applies, per element and in the JAX step's
// order, what the step does to a gradient (the "prologue"): the unscale
// g = G(g * inv) (trainer.py:407-410), the clip (global: G(g * coef);
// per tensor: G(g * s) with s from the tensor's norm in g's type,
// optimizer/clip.py:44-47; by value: clamp), then the decay (L2: G(g + wd*p);
// L1: G(g + coeff*sign(p)), _apply_l1 optimizer.py:228), where G(x) rounds
// to the gradient's type. Adam's coupled L2 is _adam_update's own fp32
// g32 + wd * p32.
//
// Bit for bit: the update arithmetic is written with __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and __fsqrt_rn, so nvcc contracts nothing into an
// FMA and every operation rounds once, as the plain PyTorch version's
// elementwise kernels do. The bias corrections 1 - beta^t come in as fp32
// scalars computed on the host with numpy, as the plain version computes
// them: powf on the device need not round like numpy or XLA.
//
// What bounds them on the H100: bytes. Adam reads p, g, m, v and writes p,
// m, v: 28 bytes an fp32 element for about 15 flops, far below the ridge.
// At Llama-2-7B widths with 8 layers (1.881B fp32 parameters) that is 52.7
// GB, 15.7 ms at 3.35 TB/s; the sum of squares reads 7.52 GB (2.25 ms).
// Lamb reads p, m and v twice (pass 2 recomputes r), 40 bytes an element.
//
// Design: the multi_tensor_apply pattern. The wrapper hands the C entry point
// host arrays of pointers and sizes; the entry point packs them into a table
// that every kernel takes BY VALUE as a __grid_constant__ kernel argument
// (pointers, sizes, a stats slot per tensor, the call position of its first
// tensor and the prefix sum of its chunks), batched into several launches when
// a list does not fit the 4 KB of kernel parameters (79 tensors a launch for
// Adam and Lamb, 95 for momentum, 159 for the sum of squares). Nothing is
// uploaded: no host-to-device copy, so a launch can be captured in a CUDA
// graph as it is. A CTA owns one chunk of kChunk elements of one tensor (it
// finds its tensor by a binary search over the prefix sums); each thread moves
// 8 elements a step, as 16-byte vectors when every pointer of the tensor is
// 16-byte aligned (two for fp32), then a scalar tail takes any numel and any
// storage offset. A zero-size tensor owns no chunk. Scalars that change from
// step to step are read from small fp32 device buffers: the inverse loss
// scale, the clip coefficient, the per-tensor sums and the skip flag (all
// written by mt_sumsq's finalize kernel but the scale). With the skip flag set
// (the scaler found a non-finite gradient) no update writes anything.
//
// Sums are deterministic: each CTA sums its chunk in a fixed order (each
// thread its elements in order, then warp shuffles and one shared pass),
// writes one partial per chunk to a workspace, a second kernel sums each
// tensor's partials in chunk order (mt_sumsq: into the tensor's slot, its
// position in the list; mt_lamb: into its position in the call), and
// mt_sumsq's finalize kernel (one CTA) sums the per-tensor sums in a fixed
// order into the total, the non-finite count, the global-norm clip coefficient
// min(1, clip_norm / max(sqrt(total), 1e-12)) (trainer.py:436-452) and the
// skip flag. The split depends only on the sizes, so a repeat is bit-equal.
#include <limits.h>

#include <vector>

#include "common.cuh"

namespace {

constexpr int kChunk = 16384;  // elements of one tensor a CTA owns
constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread moves a step
// bytes the tensor table may take of the 4 KB of kernel parameters; the
// rest holds the launch's scalars
constexpr int kTableBytes = 3840;

template <int D>
struct Table {
  static constexpr int kMax = (kTableBytes - 12) / (8 * D + 8 + 4 + 4);
  void* ptr[D][kMax];
  long long numel[kMax];
  int slot[kMax];       // the tensor's index in the GradStats arrays
  int chunk_end[kMax];  // chunks of tensors 0..i of this launch
  int count;
  int first;       // the call position of this launch's first tensor
  int chunk_base;  // workspace index of this launch's first chunk
};

enum Clip : int { kNoClip = 0, kGlobal = 1, kNorm = 2, kValue = 3 };
enum Decay : int { kNoDecay = 0, kL2 = 1, kL1 = 2 };

// What the update does to a gradient first (see the header).
struct Prologue {
  const float* inv;   // inverse loss scale, or null
  const float* coef;  // global-norm clip coefficient (kGlobal)
  const float* sq;    // per-tensor sums of squares by slot (kNorm)
  const float* skip;  // nonzero: write nothing; or null
  float clip_norm;    // ClipGradByNorm's threshold, in g's type
  float lo, hi;       // ClipGradByValue's bounds, in g's type
  float decay;        // the L2 or L1 coefficient
  int clip;
  int decay_kind;
};

struct AdamArgs {
  float lr, beta1, beta2, omb1, omb2, bc1, bc2, eps;
  float l2;     // coupled decay (Adam), in fp32 inside the update
  float decay;  // 1 - lr * wd (AdamW)
  int decoupled;
};

struct MomentumArgs {
  float lr, mu;
  int nesterov;
};

struct LambArgs {
  float lr, beta1, beta2, omb1, omb2, bc1, bc2, eps, wd;
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ptt::to_float(ptt::from_float<T>(x));
}

// the sign as (p > 0) - (p < 0): +-0 and NaN give 0, as the plain version
__device__ __forceinline__ float sign_of(float p) {
  return p > 0.f ? 1.f : (p < 0.f ? -1.f : 0.f);
}

template <int D>
__device__ __forceinline__ int find_tensor(const Table<D>& t, int blk) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_end[mid] > blk) hi = mid; else lo = mid + 1;
  }
  return lo;
}

struct Span {
  int tensor;
  long long start;
  int len;
};

template <int D>
__device__ __forceinline__ Span span_of(const Table<D>& t) {
  const int i = find_tensor(t, blockIdx.x);
  const int first = i ? t.chunk_end[i - 1] : 0;
  const long long start = (long long)(blockIdx.x - first) * kChunk;
  const long long rest = t.numel[i] - start;
  return {i, start, (int)(rest < kChunk ? rest : kChunk)};
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ bool skipped(const float* skip) {
  return skip != nullptr && *skip != 0.f;
}

// The prologue of one tensor, its per-tensor scale computed once a CTA.
template <typename G>
struct GradPrep {
  float inv, scale, lo, hi, decay;
  bool use_inv, use_scale, value;
  int decay_kind;

  __device__ __forceinline__ GradPrep(const Prologue& pr, int slot) {
    use_inv = pr.inv != nullptr;
    inv = use_inv ? *pr.inv : 1.f;
    use_scale = pr.clip == kGlobal || pr.clip == kNorm;
    value = pr.clip == kValue;
    scale = 1.f;
    if (pr.clip == kGlobal) {
      scale = *pr.coef;
    } else if (pr.clip == kNorm) {
      // clip.py:44-47 in g's type: n = sqrt(sum g^2),
      // s = n > clip_norm ? clip_norm / max(n, 1e-12) : 1
      const float n = round_to<G>(__fsqrt_rn(pr.sq[slot]));
      const float tiny = round_to<G>(1e-12f);
      if (n > pr.clip_norm)
        scale = round_to<G>(__fdiv_rn(pr.clip_norm, n < tiny ? tiny : n));
    }
    lo = pr.lo;
    hi = pr.hi;
    decay = pr.decay;
    decay_kind = pr.decay_kind;
  }

  __device__ __forceinline__ float operator()(float g, float p) const {
    if (use_inv) g = round_to<G>(__fmul_rn(g, inv));
    if (use_scale) g = round_to<G>(__fmul_rn(g, scale));
    else if (value) g = g < lo ? lo : (g > hi ? hi : g);  // NaN stays
    if (decay_kind == kL2)
      g = round_to<G>(__fadd_rn(g, __fmul_rn(decay, p)));
    else if (decay_kind == kL1)
      g = round_to<G>(__fadd_rn(g, __fmul_rn(decay, sign_of(p))));
    return g;
  }
};

// ------------------------------------------------------------ mt_sumsq
// partial[2 * chunk] = (sum of squares, non-finite count) of the chunk,
// each value first unscaled to G(g * inv) when inv is given
template <typename G>
__global__ void __launch_bounds__(kThreads)
    mt_sumsq_kernel(const __grid_constant__ Table<1> t,
                 const float* __restrict__ inv, float* __restrict__ partial) {
  __shared__ float scratch[32];
  const Span s = span_of(t);
  const G* g = static_cast<const G*>(t.ptr[0][s.tensor]) + s.start;
  const bool unscale = inv != nullptr;
  const float iv = unscale ? *inv : 1.f;
  float sum = 0.f, bad = 0.f;
  auto add = [&](float x) {
    if (unscale) x = round_to<G>(__fmul_rn(x, iv));
    bad += isfinite(x) ? 0.f : 1.f;
    sum = __fadd_rn(sum, __fmul_rn(x, x));
  };
  const int nvec = aligned16(g) ? s.len / kVec : 0;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[kVec];
    ptt::load_floats<G, kVec>(g + (size_t)i * kVec, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) add(v[j]);
  }
  for (int i = nvec * kVec + threadIdx.x; i < s.len; i += kThreads)
    add(ptt::to_float(g[i]));
  sum = ptt::block_reduce<false>(sum, scratch);
  bad = ptt::block_reduce<false>(bad, scratch);
  if (threadIdx.x == 0) {
    const size_t c = (size_t)t.chunk_base + blockIdx.x;
    partial[2 * c] = sum;
    partial[2 * c + 1] = bad;
  }
}

// CTA i sums tensor i's two chunk partials in chunk order into out[k] and
// out[total + k] (a tensor with no chunk gets zeros); k is the tensor's
// slot (kBySlot) or its position in the call
template <int D, bool kBySlot>
__global__ void __launch_bounds__(kThreads)
    mt_reduce_kernel(const __grid_constant__ Table<D> t,
                  const float* __restrict__ partial, float* __restrict__ out,
                  int total) {
  __shared__ float scratch[32];
  const int i = blockIdx.x;
  const int first = t.chunk_base + (i ? t.chunk_end[i - 1] : 0);
  const int end = t.chunk_base + t.chunk_end[i];
  float a = 0.f, b = 0.f;
  for (int c = first + threadIdx.x; c < end; c += kThreads) {
    a += partial[2 * (size_t)c];
    b += partial[2 * (size_t)c + 1];
  }
  a = ptt::block_reduce<false>(a, scratch);
  b = ptt::block_reduce<false>(b, scratch);
  if (threadIdx.x == 0) {
    const int k = kBySlot ? t.slot[i] : t.first + i;
    out[k] = a;
    out[total + k] = b;
  }
}

// stats = [total, non-finite count, clip coefficient, skip flag,
// sq[total_tensors], bad[total_tensors]]: one CTA sums the per-tensor
// values in a fixed order
__global__ void __launch_bounds__(1024)
    mt_finalize_kernel(float* __restrict__ stats, int total,
                          float clip_norm, int skip_nonfinite) {
  __shared__ float scratch[32];
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    a += stats[4 + i];
    b += stats[4 + total + i];
  }
  a = ptt::block_reduce<false>(a, scratch);
  b = ptt::block_reduce<false>(b, scratch);
  if (threadIdx.x == 0) {
    stats[0] = a;
    stats[1] = b;
    // trainer.py:447-452: min(1, clip_norm / max(sqrt(sq), 1e-12)); a NaN
    // goes through, as jnp.minimum and jnp.maximum let it
    const float n = __fsqrt_rn(a);
    const float c = __fdiv_rn(clip_norm, n < 1e-12f ? 1e-12f : n);
    stats[2] = clip_norm > 0.f ? (c > 1.f ? 1.f : c) : 1.f;
    stats[3] = skip_nonfinite && b != 0.f ? 1.f : 0.f;
  }
}

// ------------------------------------------------------------- mt_adam
__device__ __forceinline__ void adam_step(float& p, float g, float& m,
                                          float& v, const AdamArgs& a) {
  if (a.l2 != 0.f) g = __fadd_rn(g, __fmul_rn(a.l2, p));
  const float m2 = __fadd_rn(__fmul_rn(a.beta1, m), __fmul_rn(a.omb1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(a.beta2, v), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m2, a.bc1);
  const float vhat = __fdiv_rn(v2, a.bc2);
  const float step = __fdiv_rn(__fmul_rn(a.lr, mhat),
                               __fadd_rn(__fsqrt_rn(vhat), a.eps));
  if (a.decoupled) p = __fmul_rn(p, a.decay);
  p = __fsub_rn(p, step);
  m = m2;
  v = v2;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    mt_adam_kernel(const __grid_constant__ Table<4> t,
                const __grid_constant__ Prologue pr,
                const __grid_constant__ AdamArgs a) {
  if (skipped(pr.skip)) return;
  const Span s = span_of(t);
  P* p = static_cast<P*>(t.ptr[0][s.tensor]) + s.start;
  const G* g = static_cast<const G*>(t.ptr[1][s.tensor]) + s.start;
  float* m = static_cast<float*>(t.ptr[2][s.tensor]) + s.start;
  float* v = static_cast<float*>(t.ptr[3][s.tensor]) + s.start;
  const GradPrep<G> prep(pr, t.slot[s.tensor]);
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v);
  const int nvec = vec ? s.len / kVec : 0;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const size_t o = (size_t)i * kVec;
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    ptt::load_floats<P, kVec>(p + o, pv);
    ptt::load_floats<G, kVec>(g + o, gv);
    ptt::load_floats<float, kVec>(m + o, mv);
    ptt::load_floats<float, kVec>(v + o, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      adam_step(pv[j], prep(gv[j], pv[j]), mv[j], vv[j], a);
    ptt::store_floats<P, kVec>(p + o, pv);
    ptt::store_floats<float, kVec>(m + o, mv);
    ptt::store_floats<float, kVec>(v + o, vv);
  }
  for (int i = nvec * kVec + threadIdx.x; i < s.len; i += kThreads) {
    float pv = ptt::to_float(p[i]), mv = m[i], vv = v[i];
    adam_step(pv, prep(ptt::to_float(g[i]), pv), mv, vv, a);
    p[i] = ptt::from_float<P>(pv);
    m[i] = mv;
    v[i] = vv;
  }
}

// --------------------------------------------------------- mt_momentum
// no velocity: SGD, p - lr * g
__device__ __forceinline__ float momentum_step(float p, float g, bool has_vel,
                                               float& vel,
                                               const MomentumArgs& a) {
  float upd = g;
  if (has_vel) {
    const float v2 = __fadd_rn(__fmul_rn(a.mu, vel), g);
    upd = a.nesterov ? __fadd_rn(g, __fmul_rn(a.mu, v2)) : v2;
    vel = v2;
  }
  return __fsub_rn(p, __fmul_rn(a.lr, upd));
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    mt_momentum_kernel(const __grid_constant__ Table<3> t,
                    const __grid_constant__ Prologue pr,
                    const __grid_constant__ MomentumArgs a) {
  if (skipped(pr.skip)) return;
  const Span s = span_of(t);
  P* p = static_cast<P*>(t.ptr[0][s.tensor]) + s.start;
  const G* g = static_cast<const G*>(t.ptr[1][s.tensor]) + s.start;
  float* vel = static_cast<float*>(t.ptr[2][s.tensor]);
  const bool has_vel = vel != nullptr;
  if (has_vel) vel += s.start;
  const GradPrep<G> prep(pr, t.slot[s.tensor]);
  const bool vec = aligned16(p) && aligned16(g) && (!has_vel || aligned16(vel));
  const int nvec = vec ? s.len / kVec : 0;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const size_t o = (size_t)i * kVec;
    float pv[kVec], gv[kVec], vv[kVec] = {};
    ptt::load_floats<P, kVec>(p + o, pv);
    ptt::load_floats<G, kVec>(g + o, gv);
    if (has_vel) ptt::load_floats<float, kVec>(vel + o, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      pv[j] = momentum_step(pv[j], prep(gv[j], pv[j]), has_vel, vv[j], a);
    ptt::store_floats<P, kVec>(p + o, pv);
    if (has_vel) ptt::store_floats<float, kVec>(vel + o, vv);
  }
  for (int i = nvec * kVec + threadIdx.x; i < s.len; i += kThreads) {
    const float pv = ptt::to_float(p[i]);
    float vv = has_vel ? vel[i] : 0.f;
    p[i] = ptt::from_float<P>(
        momentum_step(pv, prep(ptt::to_float(g[i]), pv), has_vel, vv, a));
    if (has_vel) vel[i] = vv;
  }
}

// ------------------------------------------------------------- mt_lamb
// r = mhat / (sqrt(vhat) + eps) + wd * p (optimizer.py:67)
__device__ __forceinline__ float lamb_r(float p, float m2, float v2,
                                        const LambArgs& a) {
  const float mhat = __fdiv_rn(m2, a.bc1);
  const float vhat = __fdiv_rn(v2, a.bc2);
  return __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), a.eps)),
                   __fmul_rn(a.wd, p));
}

// pass 1: m, v updated in place; partial[2 * chunk] = (sum r^2, sum p^2)
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    mt_lamb_moments_kernel(const __grid_constant__ Table<4> t,
                        const __grid_constant__ Prologue pr,
                        const __grid_constant__ LambArgs a,
                        float* __restrict__ partial) {
  __shared__ float scratch[32];
  if (skipped(pr.skip)) return;
  const Span s = span_of(t);
  const P* p = static_cast<const P*>(t.ptr[0][s.tensor]) + s.start;
  const G* g = static_cast<const G*>(t.ptr[1][s.tensor]) + s.start;
  float* m = static_cast<float*>(t.ptr[2][s.tensor]) + s.start;
  float* v = static_cast<float*>(t.ptr[3][s.tensor]) + s.start;
  const GradPrep<G> prep(pr, t.slot[s.tensor]);
  float rs = 0.f, ws = 0.f;
  auto step = [&](float pv, float gv, float& mv, float& vv) {
    gv = prep(gv, pv);
    mv = __fadd_rn(__fmul_rn(a.beta1, mv), __fmul_rn(a.omb1, gv));
    vv = __fadd_rn(__fmul_rn(a.beta2, vv),
                   __fmul_rn(a.omb2, __fmul_rn(gv, gv)));
    const float r = lamb_r(pv, mv, vv, a);
    rs = __fadd_rn(rs, __fmul_rn(r, r));
    ws = __fadd_rn(ws, __fmul_rn(pv, pv));
  };
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v);
  const int nvec = vec ? s.len / kVec : 0;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const size_t o = (size_t)i * kVec;
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    ptt::load_floats<P, kVec>(p + o, pv);
    ptt::load_floats<G, kVec>(g + o, gv);
    ptt::load_floats<float, kVec>(m + o, mv);
    ptt::load_floats<float, kVec>(v + o, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) step(pv[j], gv[j], mv[j], vv[j]);
    ptt::store_floats<float, kVec>(m + o, mv);
    ptt::store_floats<float, kVec>(v + o, vv);
  }
  for (int i = nvec * kVec + threadIdx.x; i < s.len; i += kThreads) {
    float mv = m[i], vv = v[i];
    step(ptt::to_float(p[i]), ptt::to_float(g[i]), mv, vv);
    m[i] = mv;
    v[i] = vv;
  }
  rs = ptt::block_reduce<false>(rs, scratch);
  ws = ptt::block_reduce<false>(ws, scratch);
  if (threadIdx.x == 0) {
    const size_t c = (size_t)t.chunk_base + blockIdx.x;
    partial[2 * c] = rs;
    partial[2 * c + 1] = ws;
  }
}

// pass 2: r again from the new m, v (the same operations), then
// p - (lr * ratio) * r, ratio = |p| / |r| when both are above 0, else 1;
// sums = [r^2, p^2] by the tensor's position in the call
template <typename P>
__global__ void __launch_bounds__(kThreads)
    mt_lamb_apply_kernel(const __grid_constant__ Table<4> t,
                      const float* __restrict__ skip,
                      const __grid_constant__ LambArgs a,
                      const float* __restrict__ sums, int total) {
  if (skipped(skip)) return;
  const Span s = span_of(t);
  P* p = static_cast<P*>(t.ptr[0][s.tensor]) + s.start;
  const float* m = static_cast<const float*>(t.ptr[2][s.tensor]) + s.start;
  const float* v = static_cast<const float*>(t.ptr[3][s.tensor]) + s.start;
  const int k = t.first + s.tensor;
  const float w_norm = __fsqrt_rn(sums[total + k]);
  const float r_norm = __fsqrt_rn(sums[k]);
  const float ratio =
      w_norm > 0.f && r_norm > 0.f ? __fdiv_rn(w_norm, r_norm) : 1.f;
  const float lr_ratio = __fmul_rn(a.lr, ratio);
  const bool vec = aligned16(p) && aligned16(m) && aligned16(v);
  const int nvec = vec ? s.len / kVec : 0;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const size_t o = (size_t)i * kVec;
    float pv[kVec], mv[kVec], vv[kVec];
    ptt::load_floats<P, kVec>(p + o, pv);
    ptt::load_floats<float, kVec>(m + o, mv);
    ptt::load_floats<float, kVec>(v + o, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      pv[j] = __fsub_rn(pv[j],
                        __fmul_rn(lr_ratio, lamb_r(pv[j], mv[j], vv[j], a)));
    ptt::store_floats<P, kVec>(p + o, pv);
  }
  for (int i = nvec * kVec + threadIdx.x; i < s.len; i += kThreads) {
    const float pv = ptt::to_float(p[i]);
    p[i] = ptt::from_float<P>(
        __fsub_rn(pv, __fmul_rn(lr_ratio, lamb_r(pv, m[i], v[i], a))));
  }
}

// ---------------------------------------------------------------- host
template <typename P, typename G>
struct Types {
  using PT = P;
  using GT = G;
};

// f(Types<P, G>{}) for the dtype codes of the parameters and gradients
template <typename F>
int with_types(int p_dtype, int g_dtype, F&& f) {
  using bf16 = __nv_bfloat16;
  if (p_dtype == ptt::kF32 && g_dtype == ptt::kF32)
    return f(Types<float, float>{});
  if (p_dtype == ptt::kF32 && g_dtype == ptt::kBF16)
    return f(Types<float, bf16>{});
  if (p_dtype == ptt::kBF16 && g_dtype == ptt::kF32)
    return f(Types<bf16, float>{});
  if (p_dtype == ptt::kBF16 && g_dtype == ptt::kBF16)
    return f(Types<bf16, bf16>{});
  // fp16 (a net cast by amp.decorate, O2): fp16 parameters with fp16 or
  // fp32 gradients, or fp32 parameters with fp16 gradients
  if (p_dtype == ptt::kF16 && g_dtype == ptt::kF16)
    return f(Types<__half, __half>{});
  if (p_dtype == ptt::kF16 && g_dtype == ptt::kF32)
    return f(Types<__half, float>{});
  if (p_dtype == ptt::kF32 && g_dtype == ptt::kF16)
    return f(Types<float, __half>{});
  return cudaErrorInvalidValue;
}

int chunks_of(long long n) { return (int)((n + kChunk - 1) / kChunk); }

// Splits the list into tables of at most kMax tensors and calls
// launch(table, chunks) for each. Fails before any launch when the list
// needs more than workspace_chunks chunks (a negative workspace_chunks: no
// workspace is used). slots null: each tensor's slot is its position.
template <int D, typename F>
int for_each_table(void* const* ptrs, const long long* numel,
                   const int* slots, int count, long long workspace_chunks,
                   F&& launch) {
  long long need = 0;
  for (int i = 0; i < count; ++i) {
    if (numel[i] < 0) return cudaErrorInvalidValue;
    need += chunks_of(numel[i]);
  }
  if (need > INT_MAX || (workspace_chunks >= 0 && need > workspace_chunks))
    return cudaErrorInvalidValue;
  Table<D> t;
  t.count = 0;
  t.first = 0;
  t.chunk_base = 0;
  int chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (t.count == Table<D>::kMax) {
      if (int err = launch(t, chunks)) return err;
      t.chunk_base += chunks;
      chunks = 0;
      t.count = 0;
      t.first = i;
    }
    for (int d = 0; d < D; ++d) t.ptr[d][t.count] = ptrs[(size_t)i * D + d];
    t.numel[t.count] = numel[i];
    t.slot[t.count] = slots != nullptr ? slots[i] : i;
    chunks += chunks_of(numel[i]);
    t.chunk_end[t.count] = chunks;
    ++t.count;
  }
  if (t.count)
    if (int err = launch(t, chunks)) return err;
  return cudaSuccess;
}

// pro_ptrs: inv, coef, sq, skip (device, each may be null);
// pro_f: clip_norm, lo, hi, decay; pro_i: clip, decay kind
Prologue make_prologue(const void* const* pro_ptrs, const float* pro_f,
                       const int* pro_i) {
  Prologue pr;
  pr.inv = static_cast<const float*>(pro_ptrs[0]);
  pr.coef = static_cast<const float*>(pro_ptrs[1]);
  pr.sq = static_cast<const float*>(pro_ptrs[2]);
  pr.skip = static_cast<const float*>(pro_ptrs[3]);
  pr.clip_norm = pro_f[0];
  pr.lo = pro_f[1];
  pr.hi = pro_f[2];
  pr.decay = pro_f[3];
  pr.clip = pro_i[0];
  pr.decay_kind = pro_i[1];
  return pr;
}

bool prologue_ok(const Prologue& pr) {
  if (pr.clip == kGlobal && pr.coef == nullptr) return false;
  if (pr.clip == kNorm && pr.sq == nullptr) return false;
  return pr.clip >= kNoClip && pr.clip <= kValue &&
         pr.decay_kind >= kNoDecay && pr.decay_kind <= kL1;
}

static_assert(sizeof(Table<4>) + sizeof(Prologue) + sizeof(AdamArgs) <= 4096,
              "mt_adam_kernel's parameters exceed 4 KB");
static_assert(sizeof(Table<4>) + sizeof(Prologue) + sizeof(LambArgs) + 8 <=
                  4096,
              "mt_lamb_moments_kernel's parameters exceed 4 KB");
static_assert(sizeof(Table<3>) + sizeof(Prologue) + sizeof(MomentumArgs) <=
                  4096,
              "mt_momentum_kernel's parameters exceed 4 KB");
static_assert(sizeof(Table<1>) + 16 <= 4096,
              "mt_sumsq_kernel's parameters exceed 4 KB");

}  // namespace

// ptrs [count] gradients, fp32, bf16 or fp16 by dtypes[count] (one pass over
// each dtype's tensors; each writes its tensors' slots, their positions
// in the list); stats [4 + 2 * count] fp32 (see mt_finalize_kernel);
// partial [2 * workspace_chunks] fp32; inv (fp32 scalar) or null;
// clip_norm <= 0: coefficient 1; *launches: the kernels launched
extern "C" int ptt_mt_sumsq(void* const* ptrs, const long long* numel,
                            const int* dtypes, int count, const void* inv,
                            void* stats, void* partial,
                            long long workspace_chunks, float clip_norm,
                            int skip_nonfinite, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(stats);
  float* part = static_cast<float*>(partial);
  const float* iv = static_cast<const float*>(inv);
  for (int i = 0; i < count; ++i)
    if (dtypes[i] != ptt::kF32 && dtypes[i] != ptt::kBF16 &&
        dtypes[i] != ptt::kF16)
      return cudaErrorInvalidValue;
  int n = 0;
  std::vector<void*> ptr;
  std::vector<long long> num;
  std::vector<int> slot;
  for (const int code : {ptt::kF32, ptt::kBF16, ptt::kF16}) {
    ptr.clear();
    num.clear();
    slot.clear();
    for (int i = 0; i < count; ++i) {
      if (dtypes[i] != code) continue;
      ptr.push_back(ptrs[i]);
      num.push_back(numel[i]);
      slot.push_back(i);
    }
    if (slot.empty()) continue;
    int err = for_each_table<1>(
        ptr.data(), num.data(), slot.data(), (int)slot.size(),
        workspace_chunks, [&](const Table<1>& t, int chunks) -> int {
          if (chunks > 0) {
            if (code == ptt::kF32)
              mt_sumsq_kernel<float><<<chunks, kThreads, 0, st>>>(t, iv,
                                                                   part);
            else if (code == ptt::kBF16)
              mt_sumsq_kernel<__nv_bfloat16>
                  <<<chunks, kThreads, 0, st>>>(t, iv, part);
            else
              mt_sumsq_kernel<__half><<<chunks, kThreads, 0, st>>>(t, iv,
                                                                   part);
            ++n;
          }
          mt_reduce_kernel<1, true><<<t.count, kThreads, 0, st>>>(
              t, part, out + 4, count);
          ++n;
          return cudaGetLastError();
        });
    if (err) return err;
  }
  mt_finalize_kernel<<<1, 1024, 0, st>>>(out, count, clip_norm,
                                            skip_nonfinite);
  *launches = n + 1;
  return cudaGetLastError();
}

// ptrs [count][4]: p, g, m, v; hyper: lr, beta1, beta2, 1 - beta1,
// 1 - beta2, 1 - beta1^t, 1 - beta2^t, eps, coupled wd, 1 - lr * wd
extern "C" int ptt_mt_adam(void* const* ptrs, const long long* numel,
                           const int* slots, int count, int p_dtype,
                           int g_dtype, const void* const* pro_ptrs,
                           const float* pro_f, const int* pro_i,
                           const float* hyper, int decoupled, int* launches,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Prologue pr = make_prologue(pro_ptrs, pro_f, pro_i);
  if (!prologue_ok(pr)) return cudaErrorInvalidValue;
  *launches = 0;
  const AdamArgs a{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                   hyper[5], hyper[6], hyper[7], hyper[8], hyper[9],
                   decoupled};
  return with_types(p_dtype, g_dtype, [&](auto ty) -> int {
    using P = typename decltype(ty)::PT;
    using G = typename decltype(ty)::GT;
    return for_each_table<4>(
        ptrs, numel, slots, count, -1,
        [&](const Table<4>& t, int chunks) -> int {
          if (chunks == 0) return cudaSuccess;
          mt_adam_kernel<P, G><<<chunks, kThreads, 0, st>>>(t, pr, a);
          ++*launches;
          return cudaGetLastError();
        });
  });
}

// ptrs [count][3]: p, g, velocity (null pointers for SGD)
extern "C" int ptt_mt_momentum(void* const* ptrs, const long long* numel,
                               const int* slots, int count, int p_dtype,
                               int g_dtype, const void* const* pro_ptrs,
                               const float* pro_f, const int* pro_i,
                               float lr, float mu, int nesterov,
                               int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Prologue pr = make_prologue(pro_ptrs, pro_f, pro_i);
  if (!prologue_ok(pr)) return cudaErrorInvalidValue;
  *launches = 0;
  const MomentumArgs a{lr, mu, nesterov};
  return with_types(p_dtype, g_dtype, [&](auto ty) -> int {
    using P = typename decltype(ty)::PT;
    using G = typename decltype(ty)::GT;
    return for_each_table<3>(
        ptrs, numel, slots, count, -1,
        [&](const Table<3>& t, int chunks) -> int {
          if (chunks == 0) return cudaSuccess;
          mt_momentum_kernel<P, G><<<chunks, kThreads, 0, st>>>(t, pr, a);
          ++*launches;
          return cudaGetLastError();
        });
  });
}

// ptrs [count][4]: p, g, m, v; hyper: lr, beta1, beta2, 1 - beta1,
// 1 - beta2, 1 - beta1^t, 1 - beta2^t, eps, lamb weight decay; sums [2 *
// count] fp32 (r^2 of each tensor by its position in the call, then p^2;
// slots index only the prologue's per-tensor norms); partial [2 *
// workspace_chunks] fp32
extern "C" int ptt_mt_lamb(void* const* ptrs, const long long* numel,
                           const int* slots, int count, int p_dtype,
                           int g_dtype, const void* const* pro_ptrs,
                           const float* pro_f, const int* pro_i,
                           const float* hyper, void* sums, void* partial,
                           long long workspace_chunks, int* launches,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Prologue pr = make_prologue(pro_ptrs, pro_f, pro_i);
  if (!prologue_ok(pr)) return cudaErrorInvalidValue;
  *launches = 0;
  const LambArgs a{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                   hyper[5], hyper[6], hyper[7], hyper[8]};
  float* sm = static_cast<float*>(sums);
  float* part = static_cast<float*>(partial);
  return with_types(p_dtype, g_dtype, [&](auto ty) -> int {
    using P = typename decltype(ty)::PT;
    using G = typename decltype(ty)::GT;
    return for_each_table<4>(
        ptrs, numel, slots, count, workspace_chunks,
        [&](const Table<4>& t, int chunks) -> int {
          if (chunks == 0) return cudaSuccess;
          mt_lamb_moments_kernel<P, G>
              <<<chunks, kThreads, 0, st>>>(t, pr, a, part);
          mt_reduce_kernel<4, false><<<t.count, kThreads, 0, st>>>(
              t, part, sm, count);
          mt_lamb_apply_kernel<P>
              <<<chunks, kThreads, 0, st>>>(t, pr.skip, a, sm, count);
          *launches += 3;
          return cudaGetLastError();
        });
  });
}
