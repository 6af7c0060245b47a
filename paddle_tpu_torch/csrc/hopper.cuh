// Hopper building blocks of the port's tensor-core kernels (sm_90a): TMA
// tile loads completing on mbarriers, and warpgroup matrix products
// (wgmma) with bf16 or fp16 operands (and the k32 form with e4m3 or e5m2
// operands) and fp32 accumulators, as inline
// PTX (PTX ISA 8.0; the patterns of the hopper-kernels notes: a tensor map per
// operand passed as a __grid_constant__ kernel parameter, full/empty
// mbarrier pairs per pipeline stage, wgmma.fence / commit_group /
// wait_group around each batch of products).
//
// Shared-memory tile layout used by every operand here: a tile of R rows
// by D bf16 columns is D / 64 regions of R x 128 bytes; region j holds
// columns [64 j, 64 j + 64) of every row, one row per 128 bytes, and the
// 16-byte chunks of row r are XOR-swizzled by r % 8 (the layout a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B writes, and wgmma's 128-byte
// swizzle reads). A 128-byte swizzle spans 64 bf16 values, so a row of
// D = 128 needs two regions (two TMA boxes). Tiles are 1024-byte aligned
// (the swizzle pattern repeats every 8 rows of 128 bytes).
#pragma once

#include <cuda.h>  // CUtensorMap (the type only; the encoder is taken
                   // through cudaGetDriverEntryPoint, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {
namespace hopper {

// Every product here takes its operands as one of the two 16-bit types,
// E = __nv_bfloat16 (the default) or __half: the wgmma wrappers, the
// register packing and the tensor maps take E; nothing else changes.
template <typename E>
__host__ __device__ constexpr bool is_f16() {
  return std::is_same<E, __half>::value;
}
template <typename E>
constexpr CUtensorMapDataType map_type() {
  return is_f16<E>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of transactions (TMA loads)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed. A healthy wait
// (a tile load, a block of products) ends within thousands of polls; a
// pipeline fault would spin forever, so after 2^24 polls the kernel traps
// and its launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// ------------------------------------------------------------------- TMA
// One box of a [batch, seq, heads, d] tensor mapped as (d, heads, seq,
// batch), innermost first: 64 columns from `col` of `box rows` rows from
// `row` (rows past seq are zero-filled; the kernels mask them), into the
// 128-byte-swizzled region at `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// a whole tile of R rows x D columns (D / 64 boxes) from column col0
// into the layout above
template <int R, int D>
__device__ __forceinline__ void tma_load_tile(uint32_t tile,
                                              const CUtensorMap* map,
                                              uint32_t bar, int head, int row,
                                              int batch, int col0 = 0) {
#pragma unroll
  for (int j = 0; j < D / 64; ++j)
    tma_load(tile + j * R * 128, map, bar, col0 + 64 * j, head, row, batch);
}

// One box of a 2-D tensor (inner coordinate c0, outer c1) into shared
// memory at `dst` (the map's swizzle decides the layout; elements past
// the tensor's edge are zero-filled); completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 3-D tensor (coordinates c0 innermost, c1, c2) into shared
// memory at `dst`, as tma_load_2d (the split design's parts: c2 is the
// part, so a box never reads past its part's edge)
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// Shared-memory writes of this thread made by ordinary stores become
// visible to the async proxy (wgmma reads its descriptors' operands
// there); each writer fences before the barrier the readers wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------ thread block clusters
// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address in the cluster's shared window of the variable at `addr`
// (this CTA's shared memory) in the CTA of rank `rank` (distributed
// shared memory).
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes to a cluster address (another CTA's shared memory)
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The cluster barrier in two halves: every thread of every CTA of the
// cluster arrives (releasing its shared-memory writes, remote ones
// included), then waits for the others (acquiring theirs). A thread
// alternates the two; all threads of a warp execute them together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A barrier among `count` threads (a multiple of 32) on hardware barrier
// `id` (1..15; __syncthreads uses 0).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle (layout type 1, bits
// 62-63); base offset 0 (tiles are 1024-byte aligned).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// A descriptor computed where it is used: without this the unrolled k
// loops' descriptors (one register pair per k-step and operand) are
// hoisted out of the block loop and crowd out the accumulators. A k-step
// adds its offset (16-byte units) to the start address field.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// K-major operand (a row's K values contiguous): rows from `row0` of a
// tile of R rows, the 16 columns of k-step kk. Eight-row groups are 1024
// bytes apart; within a 64-column region a k-step moves the start 32
// bytes (the swizzle is applied by the hardware on the address bits).
template <int R>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int row0,
                                                 int kk) {
  return opaque(make_desc(tile + row0 * 128, 16, 1024)) +
         (((kk >> 2) * (R * 128) + (kk & 3) * 32) >> 4);
}

// MN-major operand (the rows of the tile are the K axis, its columns the
// N axis): rows [16 kk, 16 kk + 16) of a tile of R rows. The leading
// byte offset steps between 64-column regions along N, the stride byte
// offset between 8-row groups along K.
template <int R>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return opaque(make_desc(tile, R * 128, 1024)) + ((kk * 16 * 128) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that the registers changed here: after a wait, the
// accumulators may be read only from this point on; an A operand's
// registers stay untouched until this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
template <int P, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[P][N][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(a[p]);
}

// Moves registers between warpgroups (all four warps of a warpgroup
// execute it): a producer warpgroup that only issues loads gives its
// registers back, the consumer warpgroups take them.
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// two fp32 values as one bf16 pair (round to nearest even; lo in the low
// half), the packing of wgmma's register A operand
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the same as an fp16 pair (cvt.rn.f16x2.f32: a value past the fp16
// range becomes inf, as a cast does)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two fp32 values as a pair of the 16-bit element type E
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<E>())
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// the two 16-bit values of E in a pair (lo in the low half) as fp32
template <typename E>
__device__ __forceinline__ void unpack2(uint32_t x, float& lo, float& hi) {
  if constexpr (is_f16<E>()) {
    lo = __half2float(__ushort_as_half((unsigned short)(x & 0xffffu)));
    hi = __half2float(__ushort_as_half((unsigned short)(x >> 16)));
  } else {  // a bf16 is the high half of its fp32 value
    lo = __uint_as_float(x << 16);
    hi = __uint_as_float(x & 0xffff0000u);
  }
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], A and B in shared memory
// (descriptors), fp32 accumulators; scale_d 0 overwrites D. TA / TB are
// wgmma's transpose flags: 0 for a K-major operand (a row's K values
// contiguous), 1 for an MN-major one (its M or N axis contiguous).
#define PTT_WGMMA_SS_T_N8(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3" \
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t_n8(float (&d)[4], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_SS_T_N8("f16");
  else
    PTT_WGMMA_SS_T_N8("bf16");
}
#undef PTT_WGMMA_SS_T_N8

#define PTT_WGMMA_SS_T_N16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7" \
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t_n16(float (&d)[8], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_SS_T_N16("f16");
  else
    PTT_WGMMA_SS_T_N16("bf16");
}
#undef PTT_WGMMA_SS_T_N16

#define PTT_WGMMA_SS_T_N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_SS_T_N32("f16");
  else
    PTT_WGMMA_SS_T_N32("bf16");
}
#undef PTT_WGMMA_SS_T_N32

#define PTT_WGMMA_SS_T_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_SS_T_N64("f16");
  else
    PTT_WGMMA_SS_T_N64("bf16");
}
#undef PTT_WGMMA_SS_T_N64

#define PTT_WGMMA_SS_T_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39," \
      "%40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55," \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_SS_T_N128("f16");
  else
    PTT_WGMMA_SS_T_N128("bf16");
}
#undef PTT_WGMMA_SS_T_N128

#define PTT_WGMMA_SS_T_N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39," \
      "%40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55," \
      "%56, %57, %58, %59, %60, %61, %62, %63," \
      "%64, %65, %66, %67, %68, %69, %70, %71," \
      "%72, %73, %74, %75, %76, %77, %78, %79," \
      "%80, %81, %82, %83, %84, %85, %86, %87," \
      "%88, %89, %90, %91, %92, %93, %94, %95," \
      "%96, %97, %98, %99, %100, %101, %102, %103," \
      "%104, %105, %106, %107, %108, %109, %110, %111," \
      "%112, %113, %114, %115, %116, %117, %118, %119," \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
template <int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t_n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_SS_T_N256("f16");
  else
    PTT_WGMMA_SS_T_N256("bf16");
}
#undef PTT_WGMMA_SS_T_N256

template <int N, int TA, int TB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 ||
                    N == 256,
                "wgmma_ss_t: N is 8, 16, 32, 64, 128 or 256");
  if constexpr (N == 8)
    wgmma_ss_t_n8<TA, TB, E>(d, da, db, scale_d);
  else if constexpr (N == 16)
    wgmma_ss_t_n16<TA, TB, E>(d, da, db, scale_d);
  else if constexpr (N == 32)
    wgmma_ss_t_n32<TA, TB, E>(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_t_n64<TA, TB, E>(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_ss_t_n128<TA, TB, E>(d, da, db, scale_d);
  else
    wgmma_ss_t_n256<TA, TB, E>(d, da, db, scale_d);
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A (E pairs) in registers (the
// accumulator fragment layout, four 32-bit pairs), B MN-major in shared
// memory (its N axis contiguous: the transpose flag)
#define PTT_WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
        "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_RS_N64("f16");
  else
    PTT_WGMMA_RS_N64("bf16");
}
#undef PTT_WGMMA_RS_N64

// D[64 x 128] += A[64 x 16] * B[16 x 128], A (E pairs) in registers (the
// accumulator fragment layout, four 32-bit pairs), B MN-major in shared
// memory (its N axis contiguous: the transpose flag)
#define PTT_WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39," \
      "%40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55," \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
        "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (is_f16<E>())
    PTT_WGMMA_RS_N128("f16");
  else
    PTT_WGMMA_RS_N128("bf16");
}
#undef PTT_WGMMA_RS_N128

// D[64 x 128] (+)= A[64 x 32] * B[32 x 128] with 8-bit float operands
// (FA, FB: 0 e4m3, 1 e5m2), both K-major in shared memory (8-bit wgmma
// has no transpose flag), fp32 accumulators; scale_d 0 overwrites D. A
// k-step is 32 bytes of a 128-byte swizzled row, as the 16-bit forms'.
#define PTT_WGMMA_FP8_N128(TA, TB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k32.f32." TA "." TB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39," \
      "%40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55," \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <int FA, int FB>
__device__ __forceinline__ void wgmma_fp8_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  static_assert((FA == 0 || FA == 1) && (FB == 0 || FB == 1),
                "wgmma_fp8_n128: 0 is e4m3, 1 is e5m2");
  if constexpr (FA == 0 && FB == 0)
    PTT_WGMMA_FP8_N128("e4m3", "e4m3");
  else if constexpr (FA == 1 && FB == 0)
    PTT_WGMMA_FP8_N128("e5m2", "e4m3");
  else if constexpr (FA == 0 && FB == 1)
    PTT_WGMMA_FP8_N128("e4m3", "e5m2");
  else
    PTT_WGMMA_FP8_N128("e5m2", "e5m2");
}
#undef PTT_WGMMA_FP8_N128

template <int N, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_ss_t<N, 0, 0, E>(d, da, db, scale_d);
}

template <int N, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64)
    wgmma_rs_n64<E>(d, a, db);
  else
    wgmma_rs_n128<E>(d, a, db);
}


// ------------------------------------------------------- tensor maps (host)
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// looked up at run time (cudaGetDriverEntryPoint), so the library links
// no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* fn) {
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

// The tensor map of a tensor of `rank` dimensions (innermost first:
// dims[0] elements contiguous; strides[i] is the byte stride of
// dimension i + 1, a multiple of 16), read in boxes of box[] elements,
// elements past the edge zero-filled.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type,
                              int rank, const void* ptr,
                              const cuuint64_t* dims,
                              const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map: `outer` rows of `inner` elements, `row_bytes` apart, boxes
// of box_inner x box_outer
inline cudaError_t make_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                               const void* ptr, uint64_t inner,
                               uint64_t outer, uint64_t row_bytes,
                               uint32_t box_inner, uint32_t box_outer,
                               CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return encode_map(map, type, 2, ptr, dims, strides, box, swizzle);
}

// The map of a split operand's bf16 parts: `parts` stacked contiguous
// matrices of `outer` rows of `inner` values, read in boxes of box_inner
// x box_outer values of one part, 128-byte swizzled (a box never reads
// past its part's edge: TMA zero-fills there)
inline cudaError_t make_parts_map(CUtensorMap* map, const void* ptr,
                                  uint64_t inner, uint64_t outer,
                                  uint64_t parts, uint32_t box_inner,
                                  uint32_t box_outer) {
  const cuuint64_t dims[3] = {inner, outer, parts};
  const cuuint64_t strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hopper
}  // namespace ptt
