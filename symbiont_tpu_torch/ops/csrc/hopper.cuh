// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attn_fwd.cu: B1; flash_attn_bwd.cu: B2, B3): mbarriers, TMA
// copies, warpgroup MMA (wgmma) and its shared-memory descriptors for the
// swizzled tiles TMA writes, and the host side that encodes the tensor maps
// and opts a kernel into large dynamic shared memory.
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
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, uint32_t lbo,
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

#undef SYM_D8

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
