// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (symbiont_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel `_kernel`, launched by `_flash_call`, in
// symbiont_tpu/ops/flash_attention.py. Same function: for every (batch b,
// q head h, q row i)
//     s_j  = q_i . k_j * scale + bias[b, j]   (causal: s_j = -1e9 for j > i)
//     o_i  = sum_j softmax(s)_j v_j           in q's dtype
//     lse_i = log sum_j exp(s_j)              float32
// with GQA (q head h reads kv head h / (NH / NKV), K/V never repeated),
// float32 scores, running max/sum and accumulator, p rounded down to v's
// dtype before the PV product, and only finite masking constants (-1e30
// for the running max and for keys past Sk, -1e9 for masked keys), so a
// row whose keys are all masked comes out finite (uniform over its keys),
// as on the TPU.
//
// What bounds it on an H100: at the encoder's shapes (D = 64, S <= 512) the
// work is 4*S*D flops per 4*D bytes of q/k/v/o per row, about S flop/byte,
// below the card's ~295 flop/byte ridge for S < 295 and above it beyond:
// short buckets are bound by memory traffic, long ones by tensor-core
// throughput. The design keeps the S x S scores in registers (never in
// device memory), reads q once, each K/V tile once per 64 q rows, and
// writes o and lse once.
//
// Design. The TPU kernel's sequential fourth grid axis (kv blocks, with
// m/l/acc in VMEM scratch) becomes a loop inside one thread block:
//   * bf16: one block of 4 warps per (64-row q tile, q head, batch); each
//     warp owns 16 q rows. QK^T and PV run on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate). q stays in registers as
//     A fragments; each 64-key K tile is staged row-major in shared memory
//     and each V tile transposed, both padded so the fragment reads are
//     free of bank conflicts. The scores' accumulator layout is reused as
//     the A fragment of P, so p never leaves registers. Softmax runs in
//     base 2 (exp2f) with scale*log2(e) folded into the scores.
//   * f32: a scalar kernel (4 threads per q row, 32 rows, 16-key tiles) in
//     full float32 with expf, for exactness where the caller asked for f32;
//     the tensor cores would round f32 operands to TF32.
// Causal blocks skip every kv tile that lies wholly above the diagonal.
// The kernel stages tiles synchronously (no cp.async/TMA pipeline, no
// wgmma): a simple kernel that is right; making it fast is later work.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the return value is cudaGetLastError() after launch
// (or cudaErrorInvalidValue for a shape the kernel does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAccNeg = -1e30f;   // running-max init, keys past Sk
constexpr float kMaskNeg = -1e9f;   // causal-masked keys (natural-log units)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ----------------------------------------------------------------- bf16

constexpr int kBQ = 64;   // q rows per block (4 warps x 16)
constexpr int kBK = 64;   // keys per kv tile
constexpr int kPad = 8;   // bf16 elements of row padding in shared memory

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16x8 f32):         c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int NH, int NKV,
    int Sq, int Sk, float scale, int causal) {
  constexpr int KD = D / 16;   // k-steps of QK^T
  constexpr int NT = kBK / 8;  // n-tiles of S (8 keys each)
  constexpr int DT = D / 8;    // n-tiles of O (8 dims each)
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 Vt[D][kBK + kPad];
  __shared__ float Bs[kBK];    // bias * log2(e); kAccNeg past Sk

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qblk = blockIdx.x * kBQ;
  const int r0 = qblk + warp * 16 + g, r1 = r0 + 8;

  const __nv_bfloat16* qb = q + (size_t)(b * NH + h) * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)(b * NKV + kvh) * Sk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * NKV + kvh) * Sk * D;
  const float* bb = bias + (size_t)b * Sk;

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < Sq ? ld_u32(qb + (size_t)r0 * D + c) : 0u;
    qf[kk][1] = r1 < Sq ? ld_u32(qb + (size_t)r1 * D + c) : 0u;
    qf[kk][2] = r0 < Sq ? ld_u32(qb + (size_t)r0 * D + c + 8) : 0u;
    qf[kk][3] = r1 < Sq ? ld_u32(qb + (size_t)r1 * D + c + 8) : 0u;
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kAccNeg, kAccNeg};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  const float sl2 = scale * kLog2e;
  const float causal_neg = kMaskNeg * kLog2e;

  int n_kv = (Sk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (min(qblk + kBQ, Sq) - 1) / kBK + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed
    // 16-byte loads; consecutive threads take consecutive keys, so the
    // transposed V stores of a warp land on distinct banks
    for (int i = tid; i < kBK * (D / 8); i += 128) {
      const int r = i % kBK, c = (i / kBK) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k0 + r < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][r] = ve[j];
    }
    if (tid < kBK) Bs[tid] = k0 + tid < Sk ? bb[k0 + tid] * kLog2e : kAccNeg;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kp = &Ks[n * 8 + g][kk * 16 + 2 * t];
        mma_bf16_16816(s[n], qf[kk], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // scale, bias, causal mask; running max over the quad that shares a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        const int kpos = k0 + j;
        float x = s[n][e] * sl2 + Bs[j];
        if (causal && kpos > (e < 2 ? r0 : r1))
          x = kpos < Sk ? causal_neg : kAccNeg;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;  // the sum takes p in f32; PV takes it in bf16
        s[n][e] = p;
      }
    }

    // O += P V: the C layout of two adjacent S n-tiles is the A layout of P
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const __nv_bfloat16* vp = &Vt[n * 8 + g][j * 16 + 2 * t];
        mma_bf16_16816(acc[n], a, ld_u32(vp), ld_u32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* ob = o + (size_t)(b * NH + h) * Sq * D;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + c) =
          pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + c) =
          pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  if (t == 0) {
    float* lb = lse + (size_t)(b * NH + h) * Sq;
    if (r0 < Sq) lb[r0] = (m[0] + log2f(l[0])) * kLn2;
    if (r1 < Sq) lb[r1] = (m[1] + log2f(l[1])) * kLn2;
  }
}

// ------------------------------------------------------------------ f32

constexpr int kFQ = 32;  // q rows per block (4 threads per row)
constexpr int kFK = 16;  // keys per kv tile

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ o, float* __restrict__ lse, int NH, int NKV, int Sq,
    int Sk, float scale, int causal) {
  constexpr int DP = D / 4;  // output dims per thread
  __shared__ float Qs[kFQ][D + 1];
  __shared__ float Ks[kFK][D + 1];
  __shared__ float Vs[kFK][D];
  __shared__ float Ss[kFQ][kFK + 1];
  __shared__ float Bs[kFK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int qblk = blockIdx.x * kFQ;
  const int qpos = qblk + row;

  const float* qb = q + (size_t)(b * NH + h) * Sq * D;
  const float* kb = k + (size_t)(b * NKV + kvh) * Sk * D;
  const float* vb = v + (size_t)(b * NKV + kvh) * Sk * D;
  const float* bb = bias + (size_t)b * Sk;

  for (int i = tid; i < kFQ * D; i += 128) {
    const int r = i / D, c = i % D;
    Qs[r][c] = qblk + r < Sq ? qb[(size_t)(qblk + r) * D + c] : 0.f;
  }

  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  float m = kAccNeg, l = 0.f;

  int n_kv = (Sk + kFK - 1) / kFK;
  if (causal) n_kv = min(n_kv, (min(qblk + kFQ, Sq) - 1) / kFK + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kFK;
    __syncthreads();
    for (int i = tid; i < kFK * D; i += 128) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      Ks[r][c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      Vs[r][c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    if (tid < kFK) Bs[tid] = k0 + tid < Sk ? bb[k0 + tid] : kAccNeg;
    __syncthreads();

    // each of the row's 4 threads scores 4 of the tile's 16 keys
#pragma unroll
    for (int jj = 0; jj < kFK / 4; ++jj) {
      const int j = jj * 4 + part;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) x = fmaf(Qs[row][d], Ks[j][d], x);
      x = x * scale + Bs[j];
      const int kpos = k0 + j;
      if (causal && kpos > qpos) x = kpos < Sk ? kMaskNeg : kAccNeg;
      Ss[row][j] = x;
    }
    __syncwarp();  // a row's 4 threads share one warp

    float mx = m;
#pragma unroll
    for (int j = 0; j < kFK; ++j) mx = fmaxf(mx, Ss[row][j]);
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      const float p = expf(Ss[row][j] - m);
      l += p;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(p, Vs[j][part + 4 * i], acc[i]);
    }
  }

  if (qpos < Sq) {
    l = fmaxf(l, 1e-30f);
    float* orow = o + ((size_t)(b * NH + h) * Sq + qpos) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) orow[part + 4 * i] = acc[i] / l;
    if (part == 0) lse[(size_t)(b * NH + h) * Sq + qpos] = m + logf(l);
  }
}

}  // namespace

extern "C" int symbiont_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int NH, int NKV, int Sq, int Sk, int D, int is_bf16,
    int causal, float scale, void* stream) {
  if (B <= 0 || NH <= 0 || NKV <= 0 || Sq <= 0 || Sk <= 0 || NH % NKV != 0 ||
      B > 65535 || NH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((Sq + kBQ - 1) / kBQ, NH, B);
    auto qp = static_cast<const __nv_bfloat16*>(q);
    auto kp = static_cast<const __nv_bfloat16*>(k);
    auto vp = static_cast<const __nv_bfloat16*>(v);
    auto bp = static_cast<const float*>(bias);
    auto op = static_cast<__nv_bfloat16*>(o);
    auto lp = static_cast<float*>(lse);
    switch (D) {
      case 32:
        flash_fwd_bf16_kernel<32><<<grid, 128, 0, st>>>(qp, kp, vp, bp, op, lp, NH, NKV, Sq, Sk, scale, causal);
        break;
      case 64:
        flash_fwd_bf16_kernel<64><<<grid, 128, 0, st>>>(qp, kp, vp, bp, op, lp, NH, NKV, Sq, Sk, scale, causal);
        break;
      case 128:
        flash_fwd_bf16_kernel<128><<<grid, 128, 0, st>>>(qp, kp, vp, bp, op, lp, NH, NKV, Sq, Sk, scale, causal);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    const dim3 grid((Sq + kFQ - 1) / kFQ, NH, B);
    auto qp = static_cast<const float*>(q);
    auto kp = static_cast<const float*>(k);
    auto vp = static_cast<const float*>(v);
    auto bp = static_cast<const float*>(bias);
    auto op = static_cast<float*>(o);
    auto lp = static_cast<float*>(lse);
    switch (D) {
      case 32:
        flash_fwd_f32_kernel<32><<<grid, 128, 0, st>>>(qp, kp, vp, bp, op, lp, NH, NKV, Sq, Sk, scale, causal);
        break;
      case 64:
        flash_fwd_f32_kernel<64><<<grid, 128, 0, st>>>(qp, kp, vp, bp, op, lp, NH, NKV, Sq, Sk, scale, causal);
        break;
      case 128:
        flash_fwd_f32_kernel<128><<<grid, 128, 0, st>>>(qp, kp, vp, bp, op, lp, NH, NKV, Sq, Sk, scale, causal);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
