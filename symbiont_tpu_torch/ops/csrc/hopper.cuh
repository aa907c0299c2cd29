// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attn_fwd.cu: B1; flash_attn_bwd.cu: B2, B3): mbarriers, TMA
// copies, warpgroup MMA (wgmma, bf16 and tf32) and its shared-memory
// descriptors for swizzled tiles; float32 products on the tensor cores as
// 3xTF32, with cp.async staging and the fragment loads from padded float32
// tiles (B1, B2 and B3 in f32); and the host side that encodes the tensor
// maps and opts a kernel into large dynamic shared memory.
//
// Each .cu file includes this header into its own translation unit; every
// name here has internal linkage, so the two objects link without clashes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached by entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStages = 2;  // ring depth of the streamed tiles

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A warp's 16 rows of a wgmma m64nN float32 accumulator (g = lane / 4,
// t = lane % 4; row r = 16 * warp + g): d[4j + 0..1] = (r, 8j + 2t..+1),
// d[4j + 2..3] = (r + 8, 8j + 2t..+1) -- the mma.sync m16n8 C layout per
// n8-tile j. The RS form's A fragment for k-step s (m64k16, 4 x bf16x2):
// a0 = (r, 16s + 2t..), a1 = (r + 8, 16s + 2t..), a2 = (r, 16s + 8 + 2t..),
// a3 = (r + 8, 16s + 8 + 2t..). So C n8-tiles 2s and 2s + 1, packed to
// bf16, are the A fragment of k-step s.
__device__ __forceinline__ void c_to_a(const float lo[4], const float hi[4],
                                       uint32_t a[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ------------------------------------------- mbarriers, TMA and wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Thread 0 initialises n barriers of one arrival each; every thread of
// the block then sees them initialised.
__device__ __forceinline__ void mbar_init_all(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_3d(const CUtensorMap* map, void* dst,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_1d(const CUtensorMap* map, void* dst,
                                       uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed wgmma group has retired.
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers at this point of the program, so the compiler
// moves no read or write of them across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1 = 128-byte, 2 = 64-byte).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)swizzle << 62);
}

// wgmma m64nNk16, bf16 x bf16 -> f32 in d (N / 2 floats a thread).
// ss: A and B from shared memory, both K-major. rs_t: A from registers,
// B MN-major (transposed). `acc` = 0 overwrites d, 1 accumulates.
template <int N>
struct Wgmma;

#define SYM_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, 0, 0;\n}\n"
        : SYM_D8(0), SYM_D8(8)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs_t(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : SYM_D8(0), SYM_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SYM_D8(0), SYM_D8(8), SYM_D8(16), SYM_D8(24)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs_t(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SYM_D8(0), SYM_D8(8), SYM_D8(16), SYM_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// wgmma m64n64k8, tf32 x tf32 -> f32: A from registers (the mma.sync
// m16n8k8 A layout for each warp's 16 rows), B K-major in shared memory.
struct WgmmaTf32 {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : SYM_D8(0), SYM_D8(8), SYM_D8(16), SYM_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

#undef SYM_D8

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------- float32 on the tensor cores

// 3xTF32: a float32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest with ties away (cvt.rna), and a
// product is taken as lo·hi + hi·lo + hi·hi on the TF32 tensor cores,
// accumulated in float32. Only the lo·lo term (under 2^-22 of |a|·|b|) is
// dropped, so the result stays near float32, where one TF32 product keeps
// 11 bits.
//
// The split is done on the integer view: adding half a tf32 ulp (bit 12)
// and clearing the 13 bits below the tf32 mantissa rounds the magnitude
// half away from zero, cvt.rna.tf32.f32 for every finite x below the
// largest tf32. lo is left unmasked: an MMA reads only the top 19 bits of
// a tf32 operand, so lo's bits plus half an ulp read as lo rounded the same
// way (CUTLASS's round_half_ulp_truncate). cvt.rna.tf32.f32 itself lowers
// on sm_90 to a longer compare-and-select sequence around NaN, and the
// split runs for every fragment element these kernels load.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) + 0x1000u;
}

// mma.sync m16n8k8, tf32 x tf32 -> f32, accumulating into c. Fragments
// (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g); C c0..c1 (g,
// 2t..2t + 1), c2..c3 (g + 8, 2t..2t + 1).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in 3xTF32, the small terms first (as CUTLASS's fast-f32 MMA).
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4], const uint32_t bh[2],
                                           const uint32_t bl[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// cp.async of 16 (4) bytes into shared memory; `valid` false zero-fills
// the destination and reads nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A float32 tile in shared memory: rows of D floats padded to LD = D + 4,
// so the row stride is 4 banks mod 32 and every fragment load below (A
// rows g / g + 8 at column t; B rows g at column t; B rows 2t / 2t + 1 at
// column g) touches 32 distinct banks.
template <int D>
struct F32Rows {
  static constexpr int LD = D + 4;
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
};

// Stage rows [row0, row0 + R) of a [S, D] float32 matrix into dst (stride
// LD) with 16-byte cp.async copies; rows at or past S are zero-filled.
// All 128 threads take part; the caller commits the group.
template <int D, int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int S) {
  constexpr int C = D / 4, LD = F32Rows<D>::LD;
  static_assert(R * C % 128 == 0, "whole passes of the block");
#pragma unroll
  for (int j = 0; j < R * C / 128; ++j) {
    const int i = j * 128 + threadIdx.x, r = i / C, c = i % C;
    const bool in = row0 + r < S;
    cp_async16(dst + r * LD + 4 * c, in ? src + (size_t)(row0 + r) * D + 4 * c : src, in);
  }
}

// The A fragment (row-major, m16k8) of a warp's 16 rows of `tile` at
// columns c0..c0 + 7, split into tf32 hi and lo.
template <int LD>
__device__ __forceinline__ void a_frag(const float* tile, int c0, uint32_t hi[4],
                                       uint32_t lo[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + g * LD + c0 + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * LD], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * LD + 4], hi[3], lo[3]);
}

// The same fragment from tiles already split: hi and lo as `split_flat`
// leaves them.
template <int LD>
__device__ __forceinline__ void a_frag_split(const uint32_t* hi_tile, const uint32_t* lo_tile,
                                             int c0, uint32_t hi[4], uint32_t lo[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int at = g * LD + c0 + t;
  hi[0] = hi_tile[at];
  hi[1] = hi_tile[at + 8 * LD];
  hi[2] = hi_tile[at + 4];
  hi[3] = hi_tile[at + 8 * LD + 4];
  lo[0] = lo_tile[at];
  lo[1] = lo_tile[at + 8 * LD];
  lo[2] = lo_tile[at + 4];
  lo[3] = lo_tile[at + 8 * LD + 4];
}

// A float32 tile of R rows x D as wgmma reads a K-major tf32 operand: D /
// 32 panels of 32 columns, each row-major (128 bytes a row) with the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), panels
// one after another from a 1024-byte boundary. Rows [row0, row0 + R) of a
// [S, D] matrix are staged there by 16-byte cp.async copies, rows at or
// past S zero-filled; all 128 threads take part.
template <int D, int R>
__device__ __forceinline__ void stage_rows_sw(float* dst, const float* src, int row0, int S) {
  constexpr int C = D / 4;
  static_assert(D % 32 == 0 && R * C % 128 == 0, "whole panels and passes");
#pragma unroll
  for (int j = 0; j < R * C / 128; ++j) {
    const int i = j * 128 + threadIdx.x, r = i / C, c = i % C;
    const bool in = row0 + r < S;
    cp_async16(dst + (c / 8) * R * 32 + r * 32 + ((c % 8) ^ (r & 7)) * 4,
               in ? src + (size_t)(row0 + r) * D + 4 * c : src, in);
  }
}

// K-major descriptor of k-step kk (8 tf32 columns, 32 bytes) of such a
// tile: the step moves the start 32 bytes into its panel's rows.
template <int R>
__device__ __forceinline__ uint64_t desc_k_tf32(const float* tile, int kk) {
  return smem_desc(tile + (kk / 4) * R * 32 + (kk % 4) * 8, 16, 1024, 1);
}

// Split n floats (n a multiple of 4, 16-byte aligned) into tf32 hi, in
// place, and lo, at the same offsets in lo_tile: elementwise, so in any
// layout. All 128 threads take part.
__device__ __forceinline__ void split_flat(float* tile, float* lo_tile, int n) {
  for (int at = 4 * threadIdx.x; at < n; at += 4 * 128) {
    float4 x = *reinterpret_cast<float4*>(tile + at);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(tile + at) = hi;
    *reinterpret_cast<uint4*>(lo_tile + at) = lo;
  }
}

// The B fragment (k8n8) whose n runs over 8 rows of `tile` and whose k
// runs over columns c0..c0 + 7 (a K-major operand read as stored).
template <int LD>
__device__ __forceinline__ void b_frag_k(const float* tile, int c0, uint32_t hi[2],
                                         uint32_t lo[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + g * LD + c0 + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// The B fragment whose k runs over 8 rows of `tile` and whose n over
// columns c0..c0 + 7 (an MN-major operand), in the k order of `c_frag`:
// k slot t is row 2t, slot t + 4 is row 2t + 1.
template <int LD>
__device__ __forceinline__ void b_frag_mn(const float* tile, int c0, uint32_t hi[2],
                                          uint32_t lo[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + 2 * t * LD + c0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[LD], hi[1], lo[1]);
}

// An m16n8 C tile (c0..c1 at columns 2t, 2t + 1) as the A fragment of one
// k8 step over those 8 columns, split: A's k slot t holds column 2t and
// slot t + 4 column 2t + 1, the order `b_frag_mn` reads the other operand
// in. A sum over k does not depend on the order, so no shuffle is needed.
__device__ __forceinline__ void c_frag(const float c[4], uint32_t hi[4], uint32_t lo[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// A bf16 tile of `rows` x D in shared memory, as TMA writes it: D / PW
// panels of PW columns, each panel row-major (PW * 2 bytes a row) with the
// swizzle of its row length, panels one after another. Tiles start on
// 1024-byte boundaries, where both swizzle patterns begin.
template <int D>
struct Panels {
  static constexpr int PW = D < 64 ? D : 64;                // columns per panel
  static constexpr int NP = D / PW;                          // panels
  static constexpr uint32_t ROW = PW * 2;                    // bytes a panel row
  static constexpr uint32_t SBO = 8 * ROW;                   // bytes between 8-row groups
  static constexpr uint32_t SWIZZLE = ROW == 128 ? 1u : 2u;  // descriptor code
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
};

// K-major operand: a tile of `rows` rows at k-step kk (columns 16kk..
// 16kk+15). Within a swizzled row the k-step moves the start address by 32
// bytes; the hardware applies the swizzle to the sum.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows, int kk) {
  using P = Panels<D>;
  const int p = kk * 16 / P::PW, c = kk * 16 % P::PW;
  return smem_desc(tile + p * rows * P::PW + c, 16, P::SBO, P::SWIZZLE);
}

// MN-major (transposed) B operand: tile rows 16s..16s+15 are its K extent
// and panel p's PW columns its N extent (8-row groups SBO apart; LBO is the
// step to the next PW-column chunk, the next panel).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows, int s,
                                            int p) {
  using P = Panels<D>;
  return smem_desc(tile + (p * rows + 16 * s) * P::PW, rows * P::ROW, P::SBO,
                   P::SWIZZLE);
}

// The dynamic shared memory, its start rounded up to 1024 bytes (the
// launch asks for 1 KB more than the layout needs).
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// ----------------------------------------------------------------- host

// Opt a kernel into more than 48 KB of dynamic shared memory. Called once
// per kernel instance (a function-local static at the call site), so no
// attribute call falls inside a CUDA-graph capture after the first launch.
template <typename... KArgs>
cudaError_t allow_smem(void (*kern)(KArgs...), size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Launch one warpgroup per block on the caller's stream →
// cudaGetLastError() (or the error of the shared-memory opt-in).
template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), cudaError_t attr, dim3 grid, size_t smem,
           cudaStream_t st, Args... args) {
  if (attr != cudaSuccess) return (int)attr;
  kern<<<grid, 128, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int NH, int Sq, int Sk) {
  // the tensor maps' coordinates (b * NH + h, and b * NH * S + row) are ints
  return B <= 0 || NH <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || NH > 65535 ||
         (long long)B * NH * (Sq > Sk ? Sq : Sk) > INT_MAX;
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// [B*NH, S, D] bf16, boxes of `rows` x one panel (PW columns), swizzled as
// Panels<D> says; rows past S inside a head are zero-filled.
bool map_rows(CUtensorMap* m, const void* ptr, int BH, int S, int D, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t pw = D < 64 ? D : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {pw, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n float32 values as one line, boxes of `len`; past n is zero-filled.
bool map_flat(CUtensorMap* m, const void* ptr, size_t n, int len) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // rank 1: not read
  const cuuint32_t box[1] = {(cuuint32_t)len};
  const cuuint32_t step[1] = {1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims,
             strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
