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
//   the whole row, the NORMALISED probabilities rounded to q's dtype,
//   then the value product in fp32, cast to q's dtype. GQA is
//   kv-head-major: query head h reads kv head h / (H / kvH).
// The int8 flavour (ptt_paged_attention_int8_fwd) reads int8 K/V rows
// and their fp32 scales ([N, page_size, kvH]) and dequantizes each value
// as float(q) * scale in fp32, never rounded to q's dtype, as the TPU
// kernel's load epilogue does (:262-263); the rest is the same body.
//
// What bounds it on the H100: bytes. Every live K and V element is read
// once and costs 2 flops per query head of its group (bf16 MHA: 1 flop
// per byte), so the floor is the live K/V bytes, sum_b (pos_b + 1) * kvH
// * D * 2 * 2 (int8: (D + 4) bytes per slot and kv head, with the
// scale), over 3.35 TB/s. The design keeps many bytes in flight on every
// SM and splits long rows over many CTAs.
//
// Design: two kernels a call, one body per kernel for both flavours.
// - Each row's live slots [0, n), n = min(pos + 1, P * page_size), are
//   cut into chunks of `chunk` slots (a whole number of pages; the
//   wrapper sizes it so one chunk's K or V rows fill about 32 KB of
//   shared memory, at most 256 slots and 2048 / G: fewer, larger chunks
//   beat more CTAs, since each chunk costs a CTA's fixed latency and a
//   partial row to sum). A CTA owns one (chunk, kv head, row); CTAs whose
//   chunk starts at or past n exit at once, so only the pages holding
//   slots <= pos are read, and the garbage page 0 is never touched.
// - A CTA brings its chunk's K (kernel 1) or V (kernel 2) rows of its kv
//   head into shared memory with cp.async, 16 bytes a copy and all of
//   the chunk in flight at once (an int8 arena's scales, 4 bytes each,
//   with 4-byte cp.async), one row per (D * size + pad) bytes: the pad
//   makes the row stride an odd number of 16-byte units, so eight lanes
//   reading eight rows at one column hit distinct banks. A row whose
//   bytes are not a multiple of 16 (int8 at a head dim of 8 mod 16, or
//   any head dim that is not a multiple of 16) is copied in 8- or 4-byte
//   cp.async pieces, or byte by byte where its bytes are odd, and its
//   staged row is zero-filled from the arena's head dim to the compute
//   width D (the next multiple of 16; the wrapper pads q to it and slices
//   the output back). cp.async rather
//   than TMA: a row of one kv head is contiguous and a warp's copies
//   coalesce, the 4-byte scales are below TMA's 16-byte box minimum
//   anyway, and no swizzle is needed for the readers.
// - The kv head's G query heads run in blocks of up to 16 against the
//   chunk already in shared memory, so K and V are read from device
//   memory once per kv head whatever G is, and G is unbounded.
// - Kernel 1 (scores): a thread takes one slot and up to HB query heads
//   (HB 1 for MHA, 4 otherwise), dequantizes each K value in fp32 and
//   sums q . k over D in fp32; the scaled scores go to a global fp32
//   scratch [B, H, P * page_size] (L2-resident) and to shared memory,
//   from which each warp takes a head's chunk max m_c and sum of exp(s -
//   m_c) (stats [B, H, chunks]).
// - Kernel 2 (values): each CTA combines its row's chunk statistics
//   into the row's m and l (a warp per head, lane k over chunks k, k +
//   32, ..., then a butterfly: the same fixed order in every CTA of the
//   row, so they agree bit for bit), takes p = round_to_q(exp(s - m) /
//   l) over its chunk (the TPU kernel's rounding point: the normalised
//   probability), and the fp32 partial P V of its chunk: a thread owns 8
//   value columns of HB heads over every SG-th slot, and the SG lanes of
//   a group are summed with a fixed butterfly. A row of one chunk writes
//   its output at once; otherwise the partials go to an fp32 scratch
//   [B, H, chunks, D] and the last CTA of (row, kv head) to arrive (an
//   arrival counter that it resets to 0 for the next call) sums them in
//   chunk order and writes q's dtype. No float atomics and no order that
//   depends on timing: a call repeats bit for bit.
// Any head dim up to 256 (a runtime argument), any G, any row length up
// to the scratch the wrapper allocates from the table.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadBlock = 16;  // query heads per pass over a chunk
template <typename TKV>
constexpr bool kQuant = std::is_same<TKV, int8_t>::value;

// bytes between two staged rows: D values, padded to an odd number of
// 16-byte units (conflict-free 16-byte reads of eight rows at a column)
__host__ __device__ inline int row_stride(int d, int elem) {
  const int b = d * elem;
  return (b / 16) % 2 ? b : b + 16;
}

__host__ __device__ inline int head_block(int g) {
  return g < kHeadBlock ? g : kHeadBlock;
}

// shared memory of kernel 1 (scores) and kernel 2 (values), bytes: the
// chunk's rows, their int8 scales, then per head block q [GB, D] and the
// scores [GB, chunk] (kernel 1), or (m, l) [GB, 2] and the probabilities
// [GB, chunk] (kernel 2)
__host__ __device__ inline int scores_smem(int chunk, int d, int elem,
                                           int g) {
  const int gb = head_block(g);
  return chunk * row_stride(d, elem) + 4 * chunk + 4 * gb * d +
         4 * gb * chunk;
}
__host__ __device__ inline int values_smem(int chunk, int d, int elem,
                                           int g) {
  const int gb = head_block(g);
  return chunk * row_stride(d, elem) + 4 * chunk + 8 * gb + 4 * gb * chunk;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The arena slot of logical slot t: page trow[t >> shift], offset
// t & (page_size - 1).
__device__ __forceinline__ size_t arena_slot(const int* trow, int t,
                                             int shift) {
  return ((size_t)trow[t >> shift] << shift) +
         (size_t)(t & ((1 << shift) - 1));
}

// Issue the copies of the chunk's `cn` rows (slots t0 ..) of kv head kvh
// into `tile` (rows `ld` bytes apart) and, for an int8 arena, of their
// scales into `sc`. A row holds dk values in the arena (its head dim)
// and d in the tile (the compute width, a multiple of 16): rows of a
// multiple of 16 bytes go in 16-byte copies, others in 8- or 4-byte
// copies or, where their bytes are odd, byte by byte, and the tile's
// columns from dk to d are zeroed. Completes at cp_async_wait_all (and
// the barrier after it).
template <typename TKV>
__device__ __forceinline__ void stage_rows(uint8_t* tile, float* sc,
                                           const TKV* __restrict__ pages,
                                           const float* __restrict__ scales,
                                           const int* trow, int t0, int cn,
                                           int shift, int kv_heads, int kvh,
                                           int d, int dk, int ld) {
  const int bytes = dk * (int)sizeof(TKV);  // of an arena row
  auto src_row = [&](int r) {
    const size_t slot = arena_slot(trow, t0 + r, shift);
    return reinterpret_cast<const uint8_t*>(
        pages + (slot * kv_heads + kvh) * (size_t)dk);
  };
  if (bytes % 16 == 0) {
    const int vecs = bytes / 16;
    for (int i = threadIdx.x; i < cn * vecs; i += kThreads) {
      const int r = i / vecs, v = i - r * vecs;
      cp_async16(tile + r * ld + 16 * v, src_row(r) + 16 * v);
    }
  } else if (bytes % 8 == 0) {
    const int units = bytes / 8;
    for (int i = threadIdx.x; i < cn * units; i += kThreads) {
      const int r = i / units, v = i - r * units;
      cp_async8(tile + r * ld + 8 * v, src_row(r) + 8 * v);
    }
  } else if (bytes % 4 == 0) {
    const int units = bytes / 4;
    for (int i = threadIdx.x; i < cn * units; i += kThreads) {
      const int r = i / units, v = i - r * units;
      cp_async4(tile + r * ld + 4 * v, src_row(r) + 4 * v);
    }
  } else {
    for (int i = threadIdx.x; i < cn * bytes; i += kThreads) {
      const int r = i / bytes, v = i - r * bytes;
      tile[r * ld + v] = src_row(r)[v];
    }
  }
  const int pad = d * (int)sizeof(TKV) - bytes;
  if (pad > 0) {
    for (int i = threadIdx.x; i < cn * pad; i += kThreads) {
      const int r = i / pad;
      tile[r * ld + bytes + (i - r * pad)] = 0;
    }
  }
  if constexpr (kQuant<TKV>) {
    for (int r = threadIdx.x; r < cn; r += kThreads)
      cp_async4(sc + r,
                scales + arena_slot(trow, t0 + r, shift) * kv_heads + kvh);
  }
}

// Eight values of a staged row from column c, as fp32 (an int8 value
// dequantized as float(q) * scale)
template <typename TKV>
__device__ __forceinline__ void row8(const uint8_t* row, int c, float s,
                                     float (&v)[8]) {
  ptt::load_floats<TKV, 8>(reinterpret_cast<const TKV*>(row) + c, v);
  if constexpr (kQuant<TKV>) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= s;
  }
}

// d: the compute width (a multiple of 16: q, out and the staged rows);
// dk: the arena's head dim (d - 15 .. d)
struct Geometry {
  int heads, kv_heads, d, dk, page_size, table_width, chunk, max_chunks;
};

// ------------------------------------------------------ kernel 1: scores
template <typename TQ, typename TKV, int HB>
__global__ void __launch_bounds__(kThreads)
    paged_scores_kernel(const TQ* __restrict__ q,
                        const TKV* __restrict__ k_pages,
                        const float* __restrict__ k_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos,
                        float* __restrict__ scores,
                        float2* __restrict__ stats, Geometry geo,
                        float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int d = geo.d, chunk = geo.chunk;
  const int s_virt = geo.table_width * geo.page_size;
  const int n = min(pos[b] + 1, s_virt);
  const int t0 = c * chunk;
  if (t0 >= n) return;
  const int cn = min(chunk, n - t0);
  const int G = geo.heads / geo.kv_heads;
  const int GB = head_block(G);
  const int ld = row_stride(d, (int)sizeof(TKV));
  uint8_t* tile = smem;                                  // [chunk, ld]
  float* sc = reinterpret_cast<float*>(tile + chunk * ld);  // [chunk]
  float* qs = sc + chunk;                                // [GB, D]
  float* ss = qs + GB * d;                               // [GB, chunk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_rows<TKV>(tile, sc, k_pages, k_scale,
                  table + (size_t)b * geo.table_width, t0, cn,
                  __ffs(geo.page_size) - 1, geo.kv_heads, kvh, d, geo.dk,
                  ld);
  // [B * H] row of this kv head's first query head
  const size_t head0 = (size_t)b * geo.heads + (size_t)kvh * G;

  for (int g0 = 0; g0 < G; g0 += GB) {
    const int gb = min(GB, G - g0);
    const TQ* qb = q + (head0 + g0) * d;
    for (int i = tid; i < gb * d; i += kThreads) qs[i] = ptt::to_float(qb[i]);
    if (g0 == 0) cp_async_wait_all();
    __syncthreads();

    // a thread: one slot (neighbouring threads, neighbouring slots) and
    // HB query heads
    const int hblocks = (gb + HB - 1) / HB;
    for (int i = tid; i < cn * hblocks; i += kThreads) {
      const int r = i % cn, g1 = (i / cn) * HB;
      const uint8_t* row = tile + r * ld;
      const float s_r = kQuant<TKV> ? sc[r] : 1.0f;
      float acc[HB];
#pragma unroll
      for (int j = 0; j < HB; ++j) acc[j] = 0.0f;
      for (int col = 0; col < d; col += 8) {
        float kv[8];
        row8<TKV>(row, col, s_r, kv);
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          if (g1 + j < gb) {
            const float* qr = qs + (g1 + j) * d + col;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[j] = fmaf(qr[e], kv[e], acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        if (g1 + j < gb) {
          const float s = acc[j] * scale;
          ss[(g1 + j) * chunk + r] = s;
          scores[(head0 + g0 + g1 + j) * s_virt + t0 + r] = s;
        }
      }
    }
    __syncthreads();

    // the chunk's max and sum of exp(s - max), a warp per head
    for (int g = warp; g < gb; g += kWarps) {
      const float* row = ss + g * chunk;
      float m = -INFINITY;
      for (int r = lane; r < cn; r += 32) m = fmaxf(m, row[r]);
      m = ptt::warp_max(m);
      float l = 0.0f;
      for (int r = lane; r < cn; r += 32) l += expf(row[r] - m);
      l = ptt::warp_sum(l);
      if (lane == 0)
        stats[(head0 + g0 + g) * geo.max_chunks + c] = make_float2(m, l);
    }
    __syncthreads();  // qs and ss are refilled by the next head block
  }
}

// ------------------------------------------------------ kernel 2: values
template <typename TQ, typename TKV, int HB>
__global__ void __launch_bounds__(kThreads)
    paged_values_kernel(const TKV* __restrict__ v_pages,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos,
                        const float* __restrict__ scores,
                        const float2* __restrict__ stats,
                        float* __restrict__ partials,
                        unsigned* __restrict__ counters, TQ* __restrict__ out,
                        Geometry geo) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int d = geo.d, chunk = geo.chunk;
  const int s_virt = geo.table_width * geo.page_size;
  const int n = min(pos[b] + 1, s_virt);
  const int t0 = c * chunk;
  if (t0 >= n) return;
  const int cn = min(chunk, n - t0);
  const int nch = (n + chunk - 1) / chunk;  // the row's live chunks
  const int G = geo.heads / geo.kv_heads;
  const int GB = head_block(G);
  const int ld = row_stride(d, (int)sizeof(TKV));
  uint8_t* tile = smem;                                  // [chunk, ld]
  float* sc = reinterpret_cast<float*>(tile + chunk * ld);  // [chunk]
  float* ml = sc + chunk;                                // [GB, 2]
  float* pr = ml + 2 * GB;                               // [GB, chunk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_rows<TKV>(tile, sc, v_pages, v_scale,
                  table + (size_t)b * geo.table_width, t0, cn,
                  __ffs(geo.page_size) - 1, geo.kv_heads, kvh, d, geo.dk,
                  ld);
  const size_t head0 = (size_t)b * geo.heads + (size_t)kvh * G;

  // the value product's work split: a thread owns 8 columns of HB heads
  // over every SG-th slot; SG lanes (a power of two, aligned in a warp)
  // share their (columns, heads) and are summed by a butterfly
  const int cgs = d / 8;
  for (int g0 = 0; g0 < G; g0 += GB) {
    const int gb = min(GB, G - g0);
    // the chunk's scores, in flight beside the statistics' loads
    for (int i = tid; i < gb * cn; i += kThreads) {
      const int g = i / cn, r = i - g * cn;
      pr[g * chunk + r] = scores[(head0 + g0 + g) * s_virt + t0 + r];
    }
    // the row's max and sum from its chunks' statistics, a warp per head:
    // lane k takes chunks k, k + 32, ... in order, then a butterfly (a
    // fixed order, the same in every CTA of the row)
    for (int g = warp; g < gb; g += kWarps) {
      const float2* st = stats + (head0 + g0 + g) * geo.max_chunks;
      float m = -INFINITY;
      for (int k = lane; k < nch; k += 32) m = fmaxf(m, st[k].x);
      m = ptt::warp_max(m);
      float l = 0.0f;
      for (int k = lane; k < nch; k += 32) l += st[k].y * expf(st[k].x - m);
      l = ptt::warp_sum(l);
      if (lane == 0) {
        ml[2 * g] = m;
        ml[2 * g + 1] = l;
      }
    }
    __syncthreads();
    // normalised probabilities, rounded to q's dtype (each thread
    // rewrites the scores it loaded)
    for (int i = tid; i < gb * cn; i += kThreads) {
      const int g = i / cn, r = i - g * cn;
      const float p = expf(pr[g * chunk + r] - ml[2 * g]) / ml[2 * g + 1];
      pr[g * chunk + r] = ptt::to_float(ptt::from_float<TQ>(p));
    }
    if (g0 == 0) cp_async_wait_all();
    __syncthreads();

    const int hblocks = (gb + HB - 1) / HB;
    const int base = cgs * hblocks;
    int sg_n = 32;
    while (sg_n > 1 && base * sg_n > kThreads) sg_n >>= 1;
    const bool on = tid < base * sg_n;
    const int sg = tid & (sg_n - 1), item = tid / sg_n;
    const int col = (item % cgs) * 8, g1 = (item / cgs) * HB;
    float acc[HB][8];
#pragma unroll
    for (int j = 0; j < HB; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = 0.0f;
    if (on) {
      for (int r = sg; r < cn; r += sg_n) {
        float vv[8];
        row8<TKV>(tile + r * ld, col, kQuant<TKV> ? sc[r] : 1.0f, vv);
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          if (g1 + j < gb) {
            const float p = pr[(g1 + j) * chunk + r];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
          }
        }
      }
    }
    // every lane of the warp takes part (a group is wholly on or off)
    for (int o = sg_n / 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < HB; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
    if (on && sg == 0) {
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        if (g1 + j < gb) {
          const size_t h = head0 + g0 + g1 + j;
          if (nch == 1)
            ptt::store_floats<TQ, 8>(out + h * d + col, acc[j]);
          else
            ptt::store_floats<float, 8>(
                partials + (h * geo.max_chunks + c) * d + col, acc[j]);
        }
      }
    }
    __syncthreads();  // ml and pr are refilled by the next head block
  }
  if (nch == 1) return;

  // the last CTA of (row, kv head) to arrive sums the partials in chunk
  // order (the classic fence-and-count pattern), and resets the counter
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + (size_t)b * geo.kv_heads + kvh;
  if (tid == 0) is_last = atomicAdd(counter, 1u) == (unsigned)(nch - 1);
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) *counter = 0u;
  __threadfence();
  const int d4 = d / 4;  // four columns a thread, in 16-byte loads
  for (int i = tid; i < G * d4; i += kThreads) {
    const int g = i / d4, c4 = i - g * d4;
    const float4* pp = reinterpret_cast<const float4*>(
                           partials + (head0 + g) * geo.max_chunks * d) +
                       c4;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int k = 0; k < nch; ++k) {
      const float4 v = __ldcg(pp + (size_t)k * d4);
      s[0] += v.x;
      s[1] += v.y;
      s[2] += v.z;
      s[3] += v.w;
    }
    ptt::store_floats<TQ, 4>(out + (head0 + g) * d + 4 * c4, s);
  }
}

struct Scratch {
  float* scores;     // [B, H, P * page_size]
  float2* stats;     // [B, H, max_chunks]
  float* partials;   // [B, H, max_chunks, D]
  unsigned* counters;  // [B, kvH], zero between calls
};

template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename TQ, typename TKV, int HB>
cudaError_t launch_hb(const void* q, const void* k_pages, const void* k_scale,
                      const void* v_pages, const void* v_scale,
                      const void* table, const void* pos, void* out,
                      const Scratch& ws, int batch, const Geometry& geo,
                      float scale, cudaStream_t stream) {
  const int G = geo.heads / geo.kv_heads;
  const int es = (int)sizeof(TKV);
  const int smem1 = scores_smem(geo.chunk, geo.d, es, G);
  const int smem2 = values_smem(geo.chunk, geo.d, es, G);
  auto k1 = paged_scores_kernel<TQ, TKV, HB>;
  auto k2 = paged_values_kernel<TQ, TKV, HB>;
  cudaError_t err;
  if ((err = allow_smem(k1, smem1)) || (err = allow_smem(k2, smem2)))
    return err;
  const dim3 grid(geo.max_chunks, geo.kv_heads, batch);
  k1<<<grid, kThreads, smem1, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const float*>(k_scale), static_cast<const int*>(table),
      static_cast<const int*>(pos), ws.scores, ws.stats, geo, scale);
  if ((err = cudaGetLastError())) return err;
  k2<<<grid, kThreads, smem2, stream>>>(
      static_cast<const TKV*>(v_pages), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(pos),
      ws.scores, ws.stats, ws.partials, ws.counters, static_cast<TQ*>(out),
      geo);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pages, const void* k_scale,
                   const void* v_pages, const void* v_scale,
                   const void* table, const void* pos, void* out,
                   const Scratch& ws, int batch, const Geometry& geo,
                   float scale, cudaStream_t stream) {
  if (geo.d % 16 || geo.d < 16 || geo.d > 256 || geo.dk < 1 ||
      geo.dk > geo.d || geo.d - geo.dk >= 16 || geo.chunk < 1 ||
      geo.heads % geo.kv_heads)
    return cudaErrorInvalidValue;
  // MHA keeps one head per thread; a group runs 4 heads per thread
  if (geo.heads == geo.kv_heads)
    return launch_hb<TQ, TKV, 1>(q, k_pages, k_scale, v_pages, v_scale,
                                 table, pos, out, ws, batch, geo, scale,
                                 stream);
  return launch_hb<TQ, TKV, 4>(q, k_pages, k_scale, v_pages, v_scale, table,
                               pos, out, ws, batch, geo, scale, stream);
}

}  // namespace

// q/out: [batch, 1, heads, head_dim] (q_dtype); k_pages/v_pages:
// [N, page_size, kv_heads, kv_dim] (kv_dtype), kv_dim the model's head
// dim and head_dim the next multiple of 16 (q zero-padded to it); table:
// int32 [batch,
// table_width]; pos: int32 [batch]; scores: fp32 [batch, heads,
// table_width * page_size]; stats: fp32 [batch, heads, max_chunks, 2];
// partials: fp32 [batch, heads, max_chunks, head_dim]; counters: uint32
// [batch, kv_heads], zero (the kernels leave them zero). All contiguous
// and 16-byte aligned; head_dim a multiple of 16 up to 256; heads a
// multiple of kv_heads; page_size a power of two; max_chunks * chunk >=
// table_width * page_size; q_dtype equal to kv_dtype, or fp32 q over a
// bf16 arena, or fp16 q over an fp32 or bf16 arena (the Python wrapper
// checks all of this).
extern "C" int ptt_paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* pos, void* out, void* scores, void* stats,
    void* partials, void* counters, int batch, int heads, int kv_heads,
    int head_dim, int kv_dim, int page_size, int table_width, int chunk,
    int max_chunks, int q_dtype, int kv_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0) return cudaSuccess;
  const Geometry geo{heads,     kv_heads,    head_dim, kv_dim,
                     page_size, table_width, chunk,    max_chunks};
  const Scratch ws{static_cast<float*>(scores), static_cast<float2*>(stats),
                   static_cast<float*>(partials),
                   static_cast<unsigned*>(counters)};
#define PTT_DISPATCH(TQ, TKV)                                               \
  return launch<TQ, TKV>(q, k_pages, nullptr, v_pages, nullptr, table, pos, \
                         out, ws, batch, geo, scale, s)
  if (q_dtype == ptt::kBF16 && kv_dtype == ptt::kBF16)
    PTT_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == ptt::kF32 && kv_dtype == ptt::kF32) PTT_DISPATCH(float, float);
  if (q_dtype == ptt::kF32 && kv_dtype == ptt::kBF16)
    PTT_DISPATCH(float, __nv_bfloat16);
  // an fp16 q (a decorate O2 net's) over the float arenas the engines
  // keep (JAX has no fp16 cache): P rounded to fp16, fp16 out
  if (q_dtype == ptt::kF16 && kv_dtype == ptt::kBF16)
    PTT_DISPATCH(__half, __nv_bfloat16);
  if (q_dtype == ptt::kF16 && kv_dtype == ptt::kF32)
    PTT_DISPATCH(__half, float);
#undef PTT_DISPATCH
  return cudaErrorInvalidValue;
}

// The int8 arena flavour: k_q/v_q int8 [N, page_size, kv_heads,
// kv_dim], k_scale/v_scale fp32 [N, page_size, kv_heads]; q fp32, bf16
// or fp16. Otherwise as ptt_paged_attention_fwd.
extern "C" int ptt_paged_attention_int8_fwd(
    const void* q, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* table, const void* pos, void* out,
    void* scores, void* stats, void* partials, void* counters, int batch,
    int heads, int kv_heads, int head_dim, int kv_dim, int page_size,
    int table_width, int chunk, int max_chunks, int q_dtype, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0) return cudaSuccess;
  const Geometry geo{heads,     kv_heads,    head_dim, kv_dim,
                     page_size, table_width, chunk,    max_chunks};
  const Scratch ws{static_cast<float*>(scores), static_cast<float2*>(stats),
                   static_cast<float*>(partials),
                   static_cast<unsigned*>(counters)};
#define PTT_DISPATCH(TQ)                                                     \
  return launch<TQ, int8_t>(q, k_q, k_scale, v_q, v_scale, table, pos, out, \
                            ws, batch, geo, scale, s)
  if (q_dtype == ptt::kBF16) PTT_DISPATCH(__nv_bfloat16);
  if (q_dtype == ptt::kF32) PTT_DISPATCH(float);
  if (q_dtype == ptt::kF16) PTT_DISPATCH(__half);
#undef PTT_DISPATCH
  return cudaErrorInvalidValue;
}
