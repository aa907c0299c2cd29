// Flash-attention backward for Hopper (sm_90a): the dK/dV/dbias kernel and
// the dQ kernel, with a plain C interface loaded through ctypes
// (symbiont_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernels `_bwd_kv_kernel` and `_bwd_q_kernel`,
// launched by `_flash_bwd_fused`, in symbiont_tpu/ops/flash_attention.py
// (NH == NKV only: the JAX package sends GQA to a dense recompute). Same
// function: for every (batch b, head h), with p and dS rebuilt from the
// forward's log-sum-exp instead of a stored S x S matrix,
//     s_ij   = q_i . k_j * scale + bias[b, j]   (causal: -1e9 for j > i)
//     p_ij   = exp(s_ij - lse_i)
//     dv_j   = sum_i p_ij g_i                    (p in the inputs' dtype)
//     ds_ij  = p_ij (g_i . v_j - delta_i)         delta_i = g_i . o_i
//     dk_j   = scale * sum_i ds_ij q_i           (ds in the inputs' dtype)
//     dq_i   = scale * sum_j ds_ij k_j
//     dbias_h[b, h, j] = sum_i ds_ij             (float32, ds unrounded)
// s - lse is formed in natural-log units in the plain version's order
// (product, scale, bias, subtract), so a row whose keys are all masked
// (s and lse both near -1e9, where one float32 ulp is 64) gets p = 1 for
// every key, exactly as the JAX kernels and the plain version give it.
// delta is computed outside (a torch elementwise pass, as the JAX package
// does); the per-head dbias is summed over heads outside, with no atomics,
// so every sum is taken in a fixed order.
//
// What bounds it on an H100: B2 does 8*Sq*Sk*D flops and B3 6*Sq*Sk*D per
// (batch, head) against ~4-5 reads of [S, D] tiles, so both sit above the
// card's ~295 flop/byte ridge for S > ~150: the tensor-core rate bounds
// them at the encoder's long buckets, memory traffic at the short ones.
// The design keeps p and dS in registers (never in device memory), reads
// each K/V tile once per block and each Q/G tile once per 64 keys.
//
// Design (bf16, mma.sync m16n8k16, bf16 in, f32 accumulate):
//   * B2 `bwd_kv_bf16_kernel`: one block of 4 warps per (64-key tile, head,
//     batch); each warp owns 16 keys and loops over 32-row q tiles. It
//     computes the TRANSPOSED scores S^T = K Q^T and dP^T = V G^T, so p^T
//     and dS^T come out in the accumulator (C) layout, which is the A
//     layout of dV += p^T G and dK += dS^T Q: they never leave registers.
//     K and V are staged row-major in shared memory once; each q tile is
//     staged row-major (the B operand of S^T / dP^T) and transposed (the B
//     operand of dV / dK). The per-key dbias is the row sum of dS^T, kept
//     per thread and reduced across each lane quad at the end. Causal
//     blocks start at the first q tile that reaches the diagonal.
//   * B3 `bwd_q_bf16_kernel`: one block of 4 warps per (64-row q tile,
//     head, batch); each warp owns 16 q rows held as A fragments (q and g)
//     and loops over 32-key tiles: S = Q K^T, dP = G V^T with K and V
//     row-major as B, then dS in the C layout is the A operand of
//     dQ += dS K with K transposed in shared memory. Causal blocks stop at
//     the last kv tile that reaches the diagonal.
//   * f32: scalar FMA kernels (4 threads per key in B2, per q row in B3) in
//     full float32 with expf: the tensor cores would round f32 to TF32.
// Tiles are staged synchronously (no cp.async/TMA pipeline, no wgmma): a
// simple kernel that is right; making it fast is later work.
//
// The launches go on the caller's stream, do not synchronise and allocate
// nothing; each entry returns cudaGetLastError() after launch (or
// cudaErrorInvalidValue for a shape the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kMaskNeg = -1e9f;  // causal-masked keys (natural-log units)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 8;            // bf16 elements of row padding in shared memory

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

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// s = qk * scale + bias (or -1e9 where causal masks the key), then
// s - lse: rounded at the same points as the plain version.
__device__ __forceinline__ float s_minus_lse(float qk, float scale, float bias,
                                             bool masked, float lse) {
  const float s = masked ? kMaskNeg : __fadd_rn(__fmul_rn(qk, scale), bias);
  return __fsub_rn(s, lse);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16x8 f32):         c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// so the C tiles of columns 16j..16j+7 and 16j+8..16j+15 are, packed to
// bf16, the A fragment of k-step j.
__device__ __forceinline__ void c_to_a(const float lo[4], const float hi[4],
                                       uint32_t a[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A fragment of rows r..r+15, columns c..c+15 of a row-major tile (pitch P).
__device__ __forceinline__ void ld_a(const bf16* tile, int pitch, int r, int c,
                                     int g, int t, uint32_t a[4]) {
  const bf16* p = tile + (r + g) * pitch + c + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * pitch);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * pitch + 8);
}

// ------------------------------------------------------------ B2, bf16

constexpr int kKT = 64;  // keys per block (4 warps x 16)
constexpr int kQT = 32;  // q rows per inner tile

template <int D>
constexpr size_t kv_bf16_smem() {
  return sizeof(bf16) * (2 * kKT * (D + kPad) + 2 * kQT * (D + kPad) +
                         2 * D * (kQT + kPad)) +
         sizeof(float) * 2 * kQT;
}

template <int D>
__global__ void __launch_bounds__(128) bwd_kv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dbias, int NH, int Sq, int Sk,
    float scale, int causal) {
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int DT = D / 8;    // n-tiles of dK / dV
  constexpr int NT = kQT / 8;  // n-tiles of S^T (8 q rows each)
  constexpr int RP = D + kPad;
  constexpr int TP = kQT + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kKT][RP]
  bf16* Vs = Ks + kKT * RP;                  // [kKT][RP]
  bf16* Qs = Vs + kKT * RP;                  // [kQT][RP]
  bf16* Gs = Qs + kQT * RP;                  // [kQT][RP]
  bf16* Qt = Gs + kQT * RP;                  // [D][TP]
  bf16* Gt = Qt + D * TP;                    // [D][TP]
  float* Ls = reinterpret_cast<float*>(Gt + D * TP);  // [kQT]
  float* Ds = Ls + kQT;                               // [kQT]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kKT;
  const size_t bh = (size_t)b * NH + h;
  const bf16* qb = q + bh * Sq * D;
  const bf16* gb = g + bh * Sq * D;
  const bf16* kb = k + bh * Sk * D;
  const bf16* vb = v + bh * Sk * D;
  const float* lb = lse + bh * Sq;
  const float* db = delta + bh * Sq;

  for (int i = tid; i < kKT * (D / 8); i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
    if (k0 + r < Sk) {
      kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
      vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * RP + c) = kv4;
    *reinterpret_cast<uint4*>(Vs + r * RP + c) = vv4;
  }
  const int kr = warp * 16;  // this warp's first key row in the tile
  const int key0 = k0 + kr + gr, key1 = key0 + 8;
  const float bias0 = key0 < Sk ? bias[(size_t)b * Sk + key0] : 0.f;
  const float bias1 = key1 < Sk ? bias[(size_t)b * Sk + key1] : 0.f;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  float dbp[2] = {0.f, 0.f};

  const int n_qt = (Sq + kQT - 1) / kQT;
  // causal: q tiles wholly above the diagonal (every q row < k0) are skipped
  const int qt0 = causal ? min(k0 / kQT, n_qt) : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kQT;
    __syncthreads();  // K/V staged; the previous q tile consumed
    for (int i = tid; i < kQT * (D / 8); i += 128) {
      const int r = i % kQT, c = (i / kQT) * 8;
      uint4 qv4 = make_uint4(0u, 0u, 0u, 0u), gv4 = qv4;
      if (q0 + r < Sq) {
        qv4 = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c);
        gv4 = *reinterpret_cast<const uint4*>(gb + (size_t)(q0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Qs + r * RP + c) = qv4;
      *reinterpret_cast<uint4*>(Gs + r * RP + c) = gv4;
      const bf16* qe = reinterpret_cast<const bf16*>(&qv4);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Qt[(c + j) * TP + r] = qe[j];
        Gt[(c + j) * TP + r] = ge[j];
      }
    }
    if (tid < kQT) {
      const bool in = q0 + tid < Sq;
      Ls[tid] = in ? lb[q0 + tid] : 0.f;
      Ds[tid] = in ? db[q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V G^T for this warp's 16 keys x 32 q rows
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ld_a(Ks, RP, kr, kk * 16, gr, t, ka);
      ld_a(Vs, RP, kr, kk * 16, gr, t, va);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* qp = Qs + (n * 8 + gr) * RP + kk * 16 + 2 * t;
        const bf16* gp = Gs + (n * 8 + gr) * RP + kk * 16 + 2 * t;
        mma_bf16_16816(st[n], ka, ld_u32(qp), ld_u32(qp + 8));
        mma_bf16_16816(dpt[n], va, ld_u32(gp), ld_u32(gp + 8));
      }
    }

    // p^T and dS^T in place; the per-key dbias takes dS unrounded
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1);
        const int qi = q0 + qc;
        const int key = e < 2 ? key0 : key1;
        float p = 0.f;
        if (key < Sk && qi < Sq)
          p = exp2f(s_minus_lse(st[n][e], scale, e < 2 ? bias0 : bias1,
                                causal && key > qi, Ls[qc]) * kLog2e);
        const float ds = p * (dpt[n][e] - Ds[qc]);
        dbp[e >> 1] += ds;
        st[n][e] = p;
        dpt[n][e] = ds;
      }
    }

    // dV += p^T G, dK += dS^T Q (the C layout of S^T is the A layout)
#pragma unroll
    for (int j = 0; j < kQT / 16; ++j) {
      uint32_t pa[4], sa[4];
      c_to_a(st[2 * j], st[2 * j + 1], pa);
      c_to_a(dpt[2 * j], dpt[2 * j + 1], sa);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const bf16* gp = Gt + (n * 8 + gr) * TP + j * 16 + 2 * t;
        const bf16* qp = Qt + (n * 8 + gr) * TP + j * 16 + 2 * t;
        mma_bf16_16816(dva[n], pa, ld_u32(gp), ld_u32(gp + 8));
        mma_bf16_16816(dka[n], sa, ld_u32(qp), ld_u32(qp + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 1);
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 2);
  }
  bf16* dkb = dk + bh * Sk * D;
  bf16* dvb = dv + bh * Sk * D;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (key0 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key0 * D + c) =
          pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key0 * D + c) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (key1 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key1 * D + c) =
          pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key1 * D + c) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
  if (t == 0) {
    if (key0 < Sk) dbias[bh * Sk + key0] = dbp[0];
    if (key1 < Sk) dbias[bh * Sk + key1] = dbp[1];
  }
}

// ------------------------------------------------------------ B3, bf16

constexpr int kQB = 64;  // q rows per block (4 warps x 16)
constexpr int kKB = 32;  // keys per inner tile

template <int D>
constexpr size_t q_bf16_smem() {
  return sizeof(bf16) * (2 * kKB * (D + kPad) + D * (kKB + kPad)) +
         sizeof(float) * kKB;
}

template <int D>
__global__ void __launch_bounds__(128) bwd_q_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int NH, int Sq,
    int Sk, float scale, int causal) {
  constexpr int KD = D / 16;
  constexpr int DT = D / 8;
  constexpr int NT = kKB / 8;  // n-tiles of S (8 keys each)
  constexpr int RP = D + kPad;
  constexpr int TP = kKB + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kKB][RP]
  bf16* Vs = Ks + kKB * RP;                  // [kKB][RP]
  bf16* Kt = Vs + kKB * RP;                  // [D][TP]
  float* Bs = reinterpret_cast<float*>(Kt + D * TP);  // [kKB]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kQB;
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const size_t bh = (size_t)b * NH + h;
  const bf16* qb = q + bh * Sq * D;
  const bf16* gb = g + bh * Sq * D;
  const bf16* kb = k + bh * Sk * D;
  const bf16* vb = v + bh * Sk * D;
  const float* bb = bias + (size_t)b * Sk;

  uint32_t qf[KD][4], gf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < Sq ? ld_u32(qb + (size_t)r0 * D + c) : 0u;
    qf[kk][1] = r1 < Sq ? ld_u32(qb + (size_t)r1 * D + c) : 0u;
    qf[kk][2] = r0 < Sq ? ld_u32(qb + (size_t)r0 * D + c + 8) : 0u;
    qf[kk][3] = r1 < Sq ? ld_u32(qb + (size_t)r1 * D + c + 8) : 0u;
    gf[kk][0] = r0 < Sq ? ld_u32(gb + (size_t)r0 * D + c) : 0u;
    gf[kk][1] = r1 < Sq ? ld_u32(gb + (size_t)r1 * D + c) : 0u;
    gf[kk][2] = r0 < Sq ? ld_u32(gb + (size_t)r0 * D + c + 8) : 0u;
    gf[kk][3] = r1 < Sq ? ld_u32(gb + (size_t)r1 * D + c + 8) : 0u;
  }
  const float lse0 = r0 < Sq ? lse[bh * Sq + r0] : 0.f;
  const float lse1 = r1 < Sq ? lse[bh * Sq + r1] : 0.f;
  const float del0 = r0 < Sq ? delta[bh * Sq + r0] : 0.f;
  const float del1 = r1 < Sq ? delta[bh * Sq + r1] : 0.f;

  float dqa[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  int n_kv = (Sk + kKB - 1) / kKB;
  if (causal) n_kv = min(n_kv, (min(q0 + kQB, Sq) - 1) / kKB + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kKB;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKB * (D / 8); i += 128) {
      const int r = i % kKB, c = (i / kKB) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k0 + r < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * RP + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * RP + c) = vv4;
      const bf16* ke = reinterpret_cast<const bf16*>(&kv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) Kt[(c + j) * TP + r] = ke[j];
    }
    if (tid < kKB) Bs[tid] = k0 + tid < Sk ? bb[k0 + tid] : 0.f;
    __syncthreads();

    // S = Q K^T and dP = G V^T for this warp's 16 rows x 32 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* kp = Ks + (n * 8 + gr) * RP + kk * 16 + 2 * t;
        const bf16* vp = Vs + (n * 8 + gr) * RP + kk * 16 + 2 * t;
        mma_bf16_16816(s[n], qf[kk], ld_u32(kp), ld_u32(kp + 8));
        mma_bf16_16816(dp[n], gf[kk], ld_u32(vp), ld_u32(vp + 8));
      }
    }

    // dS in place of s
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        const int key = k0 + j;
        const int row = e < 2 ? r0 : r1;
        float p = 0.f;
        if (key < Sk && row < Sq)
          p = exp2f(s_minus_lse(s[n][e], scale, Bs[j], causal && key > row,
                                e < 2 ? lse0 : lse1) * kLog2e);
        s[n][e] = p * (dp[n][e] - (e < 2 ? del0 : del1));
      }
    }

    // dQ += dS K (the C layout of dS is the A layout; K^T in shared memory)
#pragma unroll
    for (int j = 0; j < kKB / 16; ++j) {
      uint32_t a[4];
      c_to_a(s[2 * j], s[2 * j + 1], a);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const bf16* kp = Kt + (n * 8 + gr) * TP + j * 16 + 2 * t;
        mma_bf16_16816(dqa[n], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }
  }

  bf16* dqb = dq + bh * Sq * D;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r0 * D + c) =
          pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r1 * D + c) =
          pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

// ------------------------------------------------------------- B2, f32

constexpr int kFK2 = 32;  // keys per block (4 threads per key)
constexpr int kFQ2 = 16;  // q rows per inner tile

template <int D>
constexpr size_t kv_f32_smem() {
  return sizeof(float) * (2 * kFK2 * (D + 1) + 2 * kFQ2 * (D + 1) +
                          2 * kFK2 * (kFQ2 + 1) + 2 * kFQ2);
}

template <int D>
__global__ void __launch_bounds__(128) bwd_kv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dbias, int NH, int Sq, int Sk,
    float scale, int causal) {
  constexpr int DP = D / 4;  // dims per thread
  constexpr int P1 = D + 1;
  constexpr int SP = kFQ2 + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [kFK2][P1]
  float* Vs = Ks + kFK2 * P1;                  // [kFK2][P1]
  float* Qs = Vs + kFK2 * P1;                  // [kFQ2][P1]
  float* Gs = Qs + kFQ2 * P1;                  // [kFQ2][P1]
  float* Ps = Gs + kFQ2 * P1;                  // [kFK2][SP]
  float* Ss = Ps + kFK2 * SP;                  // [kFK2][SP]
  float* Ls = Ss + kFK2 * SP;                  // [kFQ2]
  float* Ds = Ls + kFQ2;                       // [kFQ2]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int k0 = blockIdx.x * kFK2;
  const int key = k0 + row;
  const size_t bh = (size_t)b * NH + h;
  const float* qb = q + bh * Sq * D;
  const float* gb = g + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  for (int i = tid; i < kFK2 * D; i += 128) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < Sk;
    Ks[r * P1 + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
    Vs[r * P1 + c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
  }
  const float bias_k = key < Sk ? bias[(size_t)b * Sk + key] : 0.f;

  float dka[DP], dva[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) dka[i] = dva[i] = 0.f;
  float dbp = 0.f;

  const int n_qt = (Sq + kFQ2 - 1) / kFQ2;
  const int qt0 = causal ? min(k0 / kFQ2, n_qt) : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kFQ2;
    __syncthreads();
    for (int i = tid; i < kFQ2 * D; i += 128) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < Sq;
      Qs[r * P1 + c] = in ? qb[(size_t)(q0 + r) * D + c] : 0.f;
      Gs[r * P1 + c] = in ? gb[(size_t)(q0 + r) * D + c] : 0.f;
    }
    if (tid < kFQ2) {
      const bool in = q0 + tid < Sq;
      Ls[tid] = in ? lse[bh * Sq + q0 + tid] : 0.f;
      Ds[tid] = in ? delta[bh * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // each of the key's 4 threads scores 4 of the tile's 16 q rows
#pragma unroll
    for (int ii = 0; ii < kFQ2 / 4; ++ii) {
      const int i = ii * 4 + part;
      const int qi = q0 + i;
      float qk = 0.f, gv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        qk = fmaf(Ks[row * P1 + d], Qs[i * P1 + d], qk);
        gv = fmaf(Vs[row * P1 + d], Gs[i * P1 + d], gv);
      }
      float p = 0.f;
      if (key < Sk && qi < Sq)
        p = expf(s_minus_lse(qk, scale, bias_k, causal && key > qi, Ls[i]));
      const float ds = p * (gv - Ds[i]);
      dbp += ds;
      Ps[row * SP + i] = p;
      Ss[row * SP + i] = ds;
    }
    __syncwarp();  // a key's 4 threads share one warp

#pragma unroll 4
    for (int i = 0; i < kFQ2; ++i) {
      const float p = Ps[row * SP + i], ds = Ss[row * SP + i];
#pragma unroll
      for (int jj = 0; jj < DP; ++jj) {
        const int d = part + 4 * jj;
        dva[jj] = fmaf(p, Gs[i * P1 + d], dva[jj]);
        dka[jj] = fmaf(ds, Qs[i * P1 + d], dka[jj]);
      }
    }
  }

  dbp += __shfl_xor_sync(0xffffffffu, dbp, 1);
  dbp += __shfl_xor_sync(0xffffffffu, dbp, 2);
  if (key < Sk) {
    float* dkrow = dk + (bh * Sk + key) * D;
    float* dvrow = dv + (bh * Sk + key) * D;
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) {
      dkrow[part + 4 * jj] = dka[jj] * scale;
      dvrow[part + 4 * jj] = dva[jj];
    }
    if (part == 0) dbias[bh * Sk + key] = dbp;
  }
}

// ------------------------------------------------------------- B3, f32

constexpr int kFQ3 = 32;  // q rows per block (4 threads per row)
constexpr int kFK3 = 16;  // keys per inner tile

template <int D>
constexpr size_t q_f32_smem() {
  return sizeof(float) * (2 * kFQ3 * (D + 1) + 2 * kFK3 * (D + 1) +
                          kFQ3 * (kFK3 + 1) + kFK3);
}

template <int D>
__global__ void __launch_bounds__(128) bwd_q_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int NH, int Sq,
    int Sk, float scale, int causal) {
  constexpr int DP = D / 4;
  constexpr int P1 = D + 1;
  constexpr int SP = kFK3 + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kFQ3][P1]
  float* Gs = Qs + kFQ3 * P1;                  // [kFQ3][P1]
  float* Ks = Gs + kFQ3 * P1;                  // [kFK3][P1]
  float* Vs = Ks + kFK3 * P1;                  // [kFK3][P1]
  float* Ss = Vs + kFK3 * P1;                  // [kFQ3][SP]
  float* Bs = Ss + kFQ3 * SP;                  // [kFK3]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int q0 = blockIdx.x * kFQ3;
  const int qi = q0 + row;
  const size_t bh = (size_t)b * NH + h;
  const float* qb = q + bh * Sq * D;
  const float* gb = g + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const float* bb = bias + (size_t)b * Sk;

  for (int i = tid; i < kFQ3 * D; i += 128) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < Sq;
    Qs[r * P1 + c] = in ? qb[(size_t)(q0 + r) * D + c] : 0.f;
    Gs[r * P1 + c] = in ? gb[(size_t)(q0 + r) * D + c] : 0.f;
  }
  const float lse_r = qi < Sq ? lse[bh * Sq + qi] : 0.f;
  const float del_r = qi < Sq ? delta[bh * Sq + qi] : 0.f;

  float dqa[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) dqa[i] = 0.f;

  int n_kv = (Sk + kFK3 - 1) / kFK3;
  if (causal) n_kv = min(n_kv, (min(q0 + kFQ3, Sq) - 1) / kFK3 + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kFK3;
    __syncthreads();
    for (int i = tid; i < kFK3 * D; i += 128) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      Ks[r * P1 + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      Vs[r * P1 + c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    if (tid < kFK3) Bs[tid] = k0 + tid < Sk ? bb[k0 + tid] : 0.f;
    __syncthreads();

    // each of the row's 4 threads scores 4 of the tile's 16 keys
#pragma unroll
    for (int jj = 0; jj < kFK3 / 4; ++jj) {
      const int j = jj * 4 + part;
      const int key = k0 + j;
      float qk = 0.f, gv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        qk = fmaf(Qs[row * P1 + d], Ks[j * P1 + d], qk);
        gv = fmaf(Gs[row * P1 + d], Vs[j * P1 + d], gv);
      }
      float p = 0.f;
      if (key < Sk && qi < Sq)
        p = expf(s_minus_lse(qk, scale, Bs[j], causal && key > qi, lse_r));
      Ss[row * SP + j] = p * (gv - del_r);
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kFK3; ++j) {
      const float ds = Ss[row * SP + j];
#pragma unroll
      for (int ii = 0; ii < DP; ++ii)
        dqa[ii] = fmaf(ds, Ks[j * P1 + part + 4 * ii], dqa[ii]);
    }
  }

  if (qi < Sq) {
    float* dqrow = dq + (bh * Sq + qi) * D;
#pragma unroll
    for (int ii = 0; ii < DP; ++ii) dqrow[part + 4 * ii] = dqa[ii] * scale;
  }
}

// ----------------------------------------------------------------- launch

// Opt a kernel into more than 48 KB of dynamic shared memory. Called once
// per kernel instance (a function-local static at the call site), so no
// attribute call falls inside a CUDA-graph capture after the first launch.
template <typename... KArgs>
cudaError_t allow_smem(void (*kern)(KArgs...), size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), cudaError_t attr, dim3 grid, size_t smem,
           cudaStream_t st, Args... args) {
  if (attr != cudaSuccess) return (int)attr;
  kern<<<grid, 128, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int NH, int Sq, int Sk) {
  return B <= 0 || NH <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || NH > 65535;
}

template <int D>
int bwd_kv(const void* q, const void* k, const void* v, const void* bias,
           const void* g, const void* lse, const void* delta, void* dk,
           void* dv, void* dbias, int B, int NH, int Sq, int Sk, int is_bf16,
           int causal, float scale, cudaStream_t st) {
  auto bp = static_cast<const float*>(bias);
  auto lp = static_cast<const float*>(lse);
  auto dp = static_cast<const float*>(delta);
  auto dbp = static_cast<float*>(dbias);
  if (is_bf16) {
    static const cudaError_t attr = allow_smem(bwd_kv_bf16_kernel<D>, kv_bf16_smem<D>());
    return launch(bwd_kv_bf16_kernel<D>, attr, dim3((Sk + kKT - 1) / kKT, NH, B),
                  kv_bf16_smem<D>(), st, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v), bp,
                  static_cast<const bf16*>(g), lp, dp, static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv), dbp, NH, Sq, Sk, scale, causal);
  }
  static const cudaError_t attr = allow_smem(bwd_kv_f32_kernel<D>, kv_f32_smem<D>());
  return launch(bwd_kv_f32_kernel<D>, attr, dim3((Sk + kFK2 - 1) / kFK2, NH, B),
                kv_f32_smem<D>(), st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v), bp,
                static_cast<const float*>(g), lp, dp, static_cast<float*>(dk),
                static_cast<float*>(dv), dbp, NH, Sq, Sk, scale, causal);
}

template <int D>
int bwd_q(const void* q, const void* k, const void* v, const void* bias,
          const void* g, const void* lse, const void* delta, void* dq, int B,
          int NH, int Sq, int Sk, int is_bf16, int causal, float scale,
          cudaStream_t st) {
  auto bp = static_cast<const float*>(bias);
  auto lp = static_cast<const float*>(lse);
  auto dp = static_cast<const float*>(delta);
  if (is_bf16) {
    static const cudaError_t attr = allow_smem(bwd_q_bf16_kernel<D>, q_bf16_smem<D>());
    return launch(bwd_q_bf16_kernel<D>, attr, dim3((Sq + kQB - 1) / kQB, NH, B),
                  q_bf16_smem<D>(), st, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v), bp,
                  static_cast<const bf16*>(g), lp, dp, static_cast<bf16*>(dq),
                  NH, Sq, Sk, scale, causal);
  }
  static const cudaError_t attr = allow_smem(bwd_q_f32_kernel<D>, q_f32_smem<D>());
  return launch(bwd_q_f32_kernel<D>, attr, dim3((Sq + kFQ3 - 1) / kFQ3, NH, B),
                q_f32_smem<D>(), st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v), bp,
                static_cast<const float*>(g), lp, dp, static_cast<float*>(dq),
                NH, Sq, Sk, scale, causal);
}

}  // namespace

// B2: dk, dv [B, NH, Sk, D] in the inputs' dtype and the per-head dbias
// [B, NH, Sk] float32. q/g [B, NH, Sq, D], k/v [B, NH, Sk, D], bias [B, Sk]
// float32, lse/delta [B, NH, Sq] float32; all contiguous.
extern "C" int symbiont_flash_attn_bwd_kv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, const void* lse, const void* delta, void* dk, void* dv,
    void* dbias, int B, int NH, int Sq, int Sk, int D, int is_bf16, int causal,
    float scale, void* stream) {
  if (bad_shape(B, NH, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return bwd_kv<32>(q, k, v, bias, g, lse, delta, dk, dv, dbias, B, NH, Sq, Sk, is_bf16, causal, scale, st);
    case 64:
      return bwd_kv<64>(q, k, v, bias, g, lse, delta, dk, dv, dbias, B, NH, Sq, Sk, is_bf16, causal, scale, st);
    case 128:
      return bwd_kv<128>(q, k, v, bias, g, lse, delta, dk, dv, dbias, B, NH, Sq, Sk, is_bf16, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B3: dq [B, NH, Sq, D] in the inputs' dtype; the same inputs as B2.
extern "C" int symbiont_flash_attn_bwd_q(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, const void* lse, const void* delta, void* dq, int B, int NH,
    int Sq, int Sk, int D, int is_bf16, int causal, float scale, void* stream) {
  if (bad_shape(B, NH, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return bwd_q<32>(q, k, v, bias, g, lse, delta, dq, B, NH, Sq, Sk, is_bf16, causal, scale, st);
    case 64:
      return bwd_q<64>(q, k, v, bias, g, lse, delta, dq, B, NH, Sq, Sk, is_bf16, causal, scale, st);
    case 128:
      return bwd_q<128>(q, k, v, bias, g, lse, delta, dq, B, NH, Sq, Sk, is_bf16, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
