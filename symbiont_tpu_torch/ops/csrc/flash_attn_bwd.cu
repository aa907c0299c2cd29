// Flash-attention backward for Hopper (sm_90a): the dK/dV/dbias kernel and
// the dQ kernel, with a plain C interface loaded through ctypes
// (symbiont_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernels `_bwd_kv_kernel` (B2) and `_bwd_q_kernel`
// (B3), launched by `_flash_bwd_fused`, in symbiont_tpu/ops/flash_attention.py
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
// does); the per-head dbias is summed over heads outside. No atomics: two
// kernels, each owning its output tile, and every sum is taken in a fixed
// order, so a run repeats bit for bit.
//
// What bounds it on an H100: B2 does 8*Sq*Sk*D flops and B3 6*Sq*Sk*D per
// (batch, head) against ~4-5 reads of [S, D] tiles, so at the encoder's
// [32, 12, S, 64] bf16 shapes both are bound by bytes below S ~ 150 and by
// the tensor-core rate above it (S = 256 sits near the ridge, S = 512 is
// well above it). p and dS never reach device memory.
//
// Design of the bf16 kernels (wgmma on asynchronously staged tiles):
//   * Tensor cores through `wgmma.mma_async` m64nNk16 (bf16 in, float32
//     accumulate) for all four products of each kernel. A block is one
//     warpgroup (4 warps) and owns 64 keys in B2, 64 q rows in B3. (Two
//     warpgroups sharing each staged tile were slower on the H100: fewer
//     blocks fit an SM, and the pair waits on each other at every tile.)
//     - B2 computes the TRANSPOSED scores S^T = K Q^T and dP^T = V G^T with
//       both operands read from shared memory by descriptor (K-major, no
//       transpose). p^T and dS^T are formed in the accumulator registers;
//       then dV += P^T G and dK += dS^T Q take A from registers (the RS
//       form) and B = G or Q from the same row-major tile through the
//       descriptor's transpose flag (MN-major B, allowed for 16-bit types).
//     - B3 computes S = Q K^T and dP = G V^T (both from shared memory), then
//       dQ += dS K with dS from registers and K through the transpose flag.
//     A warp's slice of an m64 accumulator has the mma.sync m16n8 C layout
//     for its 16 rows, and the RS form's A fragment is the m16n8k16 A
//     layout, so `c_to_a` turns two C n8-tiles into one A k-step. No tile
//     is transposed in shared memory: there is no transposed copy at all.
//   * Staging by TMA (`cp.async.bulk.tensor`) into the swizzled layout the
//     descriptors name: 128-byte swizzle for panels of 64 bf16 columns (a
//     D = 128 tile is two panels), 64-byte swizzle for D = 32. The maps are
//     3-D over [B*NH, S, D], so the ragged edge in S is zero-filled inside
//     each head; lse, delta (B2) and the bias (B3) come through 1-D maps of
//     the same rows (a 1-D box starts on a 16-byte boundary: it begins at
//     the index rounded down to 4 and is 4 floats longer). One thread
//     issues each tile's copies against an mbarrier with its byte count
//     (expect_tx).
//   * A ring of kStages = 2 stages for the streamed tiles (q/g/lse/delta in
//     B2, k/v/bias in B3): while one tile's wgmmas run, the next tile's
//     copy is in flight; a stage is refilled once every warp is done with
//     it. The resident tile (K/V in B2, Q/G in B3) is copied once.
//   * The maps are encoded on the host inside the C entry through
//     cudaGetDriverEntryPoint (no -lcuda) and passed as __grid_constant__
//     parameters, which a CUDA-graph capture keeps by value.
//   * Registers, which set how many blocks share an SM: a B2 thread holds
//     dK and dV (D/2 + D/2 floats) and S^T, dP^T for a q tile of 32 rows
//     (16 + 16); B3 holds dQ (D/2) and S, dP for 64 keys (32 + 32). On the
//     H100 a 64-row q tile in B2 and two wgmma groups per product pair
//     (forming p while dP runs) both measured slower: each costs registers,
//     and a block fewer per SM hides less latency than the overlap gains.
//   * The elementwise step (p, dS, dbias) competes with the wgmmas for
//     issue slots, so a tile whose keys and rows are all real and that
//     causal does not cut takes a copy of it without the per-element
//     bounds and mask tests (on the encoder's shapes every tile does).
//   What this does about the four costs of a plain mma.sync design:
//   synchronous global loads with __syncthreads staging become TMA copies
//   in a 2-stage ring; scalar transposing stores of Q, G and K into shared
//   memory give way to the wgmma transpose flag; scalar 32-bit fragment
//   loads from shared memory give way to descriptors the tensor cores
//   read (register operands come straight from the accumulators); mma.sync
//   m16n8k16 on 32-row tiles becomes warpgroup wgmma on 64-row tiles.
//   Left for later: a producer warp with setmaxnreg, overlap of the
//   elementwise step with the tensor cores inside a block (two consumer
//   warpgroups in ping-pong), larger N tiles.
//   * f32: scalar FMA kernels (4 threads per key in B2, per q row in B3) in
//     full float32 with expf: the tensor cores would round f32 to TF32.
//     Synchronous staging; the train step computes in bf16.
//
// The launches go on the caller's stream, do not synchronise and allocate
// nothing; each entry returns cudaGetLastError() after launch (or
// cudaErrorInvalidValue for a shape the kernels do not take, or a tensor
// map the driver refuses, e.g. a base address that is not 16-byte aligned).

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kMaskNeg = -1e9f;  // causal-masked keys (natural-log units)
constexpr float kLog2e = 1.4426950408889634f;

// s = qk * scale + bias (or -1e9 where causal masks the key), then
// s - lse: rounded at the same points as the plain version.
__device__ __forceinline__ float s_minus_lse(float qk, float scale, float bias,
                                             bool masked, float lse) {
  const float s = masked ? kMaskNeg : __fadd_rn(__fmul_rn(qk, scale), bias);
  return __fsub_rn(s, lse);
}

// ------------------------------------------------------------ B2, bf16

template <int D>
struct KvBf16 {
  static constexpr int KEYS = 64;                       // keys per block
  static constexpr int BQ = 32;                         // q rows per streamed tile
  static constexpr uint32_t KV_BYTES = KEYS * D * 2;   // K or V
  static constexpr uint32_t QG_BYTES = BQ * D * 2;     // Q or G, one stage
  // lse / delta rows: a 1-D copy starts on a 16-byte boundary, so the box
  // begins at the row index rounded down to 4 and is 4 floats longer
  static constexpr int LD_LEN = BQ + 4;
  static constexpr uint32_t LD_BYTES = (LD_LEN * 4 + 127) / 128 * 128;  // slot
  static constexpr uint32_t STAGE_TX = 2 * QG_BYTES + 2 * LD_LEN * 4;
  static constexpr size_t SMEM = 2 * KV_BYTES + kStages * (2 * QG_BYTES + 2 * LD_BYTES) +
                                 8 * (kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(128) bwd_kv_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap td,
    const float* __restrict__ bias, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dbias, int NH, int Sq, int Sk, float scale, int causal) {
  using P = Panels<D>;
  using L = KvBf16<D>;
  constexpr int BQ = L::BQ, KEYS = L::KEYS;
  constexpr int KD = D / 16;   // k-steps of S^T / dP^T over the head dim
  constexpr int NS = BQ / 2;   // floats a thread of S^T / dP^T
  constexpr int NA = P::PW / 2;  // floats a thread of one panel of dK / dV
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_1k(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(base);                  // [KEYS][D]
  bf16* Vs = reinterpret_cast<bf16*>(base + L::KV_BYTES);    // [KEYS][D]
  unsigned char* ring = base + 2 * L::KV_BYTES;              // Q, G per stage
  unsigned char* rows = ring + kStages * 2 * L::QG_BYTES;    // lse, delta per stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + kStages * 2 * L::LD_BYTES);
  // bars[s]: stage s full; bars[kStages]: K/V resident

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, t = tid & 3;
  const int k0 = blockIdx.x * KEYS;
  const int bh = b * NH + h;
  const int n_qt = (Sq + BQ - 1) / BQ;
  // causal: q tiles wholly above the diagonal (every q row < k0) are skipped
  const int qt0 = causal ? min(k0 / BQ, n_qt) : 0;
  const int n_it = n_qt - qt0;

  auto q_tile = [&](int s) { return reinterpret_cast<bf16*>(ring + s * 2 * L::QG_BYTES); };
  auto g_tile = [&](int s) { return q_tile(s) + BQ * D; };
  auto lse_rows = [&](int s) { return reinterpret_cast<float*>(rows + s * 2 * L::LD_BYTES); };
  auto delta_rows = [&](int s) { return reinterpret_cast<float*>(rows + (2 * s + 1) * L::LD_BYTES); };
  auto load_q_tile = [&](int it) {  // one thread: q tile qt0 + it into its stage
    const int s = it % kStages, q0 = (qt0 + it) * BQ;
    mbar_expect_tx(&bars[s], L::STAGE_TX);
#pragma unroll
    for (int p = 0; p < P::NP; ++p) {
      tma_3d(&tq, q_tile(s) + p * BQ * P::PW, &bars[s], p * P::PW, q0, bh);
      tma_3d(&tg, g_tile(s) + p * BQ * P::PW, &bars[s], p * P::PW, q0, bh);
    }
    tma_1d(&tl, lse_rows(s), &bars[s], (bh * Sq + q0) & ~3);
    tma_1d(&td, delta_rows(s), &bars[s], (bh * Sq + q0) & ~3);
  };

  mbar_init_all(bars, kStages + 1);
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(&bars[kStages], 2 * L::KV_BYTES);
#pragma unroll
    for (int p = 0; p < P::NP; ++p) {
      tma_3d(&tk, Ks + p * KEYS * P::PW, &bars[kStages], p * P::PW, k0, bh);
      tma_3d(&tv, Vs + p * KEYS * P::PW, &bars[kStages], p * P::PW, k0, bh);
    }
    for (int it = 0; it < n_it && it < kStages; ++it) load_q_tile(it);
  }

  const int key0 = k0 + warp * 16 + gr, key1 = key0 + 8;
  const float bias0 = key0 < Sk ? bias[(size_t)b * Sk + key0] : 0.f;
  const float bias1 = key1 < Sk ? bias[(size_t)b * Sk + key1] : 0.f;

  float dka[P::NP][NA], dva[P::NP][NA], st[NS], dpt[NS];
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int i = 0; i < NA; ++i) dka[p][i] = dva[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;
  float dbp[2] = {0.f, 0.f};

  if (n_it > 0) mbar_wait(&bars[kStages], 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages, q0 = (qt0 + it) * BQ;
    mbar_wait(&bars[s], (it / kStages) & 1);
    const bf16* Qs = q_tile(s);
    const bf16* Gs = g_tile(s);

    // S^T = K Q^T and dP^T = V G^T: this block's 64 keys x BQ q rows
    fence_regs<NS>(st);
    fence_regs<NS>(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<BQ>::ss(st, desc_k<D>(Ks, KEYS, kk), desc_k<D>(Qs, BQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<BQ>::ss(dpt, desc_k<D>(Vs, KEYS, kk), desc_k<D>(Gs, BQ, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs<NS>(st);
    fence_regs<NS>(dpt);

    // p^T and dS^T in place; the per-key dbias takes dS unrounded. A tile
    // whose keys and q rows are all real and that causal does not cut
    // skips the per-element tests (`checked` false).
    const float* Lq = lse_rows(s) + ((bh * Sq + q0) & 3);
    const float* Dq = delta_rows(s) + ((bh * Sq + q0) & 3);
    auto p_ds = [&](auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          const int qi = q0 + qc;
          const int key = e < 2 ? key0 : key1;
          float p = 0.f;
          if (!kChecked || (key < Sk && qi < Sq))
            p = exp2f(s_minus_lse(st[4 * n + e], scale, e < 2 ? bias0 : bias1,
                                  kChecked && causal && key > qi, Lq[qc]) * kLog2e);
          const float ds = p * (dpt[4 * n + e] - Dq[qc]);
          dbp[e >> 1] += ds;
          st[4 * n + e] = p;
          dpt[4 * n + e] = ds;
        }
      }
    };
    if (!causal && k0 + KEYS <= Sk && q0 + BQ <= Sq)
      p_ds(std::false_type());
    else
      p_ds(std::true_type());

    // dV += p^T G, dK += dS^T Q: A from registers, B = G / Q transposed
#pragma unroll
    for (int p = 0; p < P::NP; ++p) {
      fence_regs<NA>(dva[p]);
      fence_regs<NA>(dka[p]);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t pa[4], sa[4];
      c_to_a(&st[8 * j], &st[8 * j + 4], pa);
      c_to_a(&dpt[8 * j], &dpt[8 * j + 4], sa);
#pragma unroll
      for (int p = 0; p < P::NP; ++p) {
        Wgmma<P::PW>::rs_t(dva[p], pa, desc_mn<D>(Gs, BQ, j, p), 1);
        Wgmma<P::PW>::rs_t(dka[p], sa, desc_mn<D>(Qs, BQ, j, p), 1);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < P::NP; ++p) {
      fence_regs<NA>(dva[p]);
      fence_regs<NA>(dka[p]);
    }
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && it + kStages < n_it) load_q_tile(it + kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 1);
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 2);
  }
  bf16* dkb = dk + (size_t)bh * Sk * D;
  bf16* dvb = dv + (size_t)bh * Sk * D;
#pragma unroll
  for (int p = 0; p < P::NP; ++p) {
#pragma unroll
    for (int n = 0; n < P::PW / 8; ++n) {
      const int c = p * P::PW + n * 8 + 2 * t;
      if (key0 < Sk) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)key0 * D + c) =
            pack_bf16(dka[p][4 * n] * scale, dka[p][4 * n + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + (size_t)key0 * D + c) =
            pack_bf16(dva[p][4 * n], dva[p][4 * n + 1]);
      }
      if (key1 < Sk) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)key1 * D + c) =
            pack_bf16(dka[p][4 * n + 2] * scale, dka[p][4 * n + 3] * scale);
        *reinterpret_cast<uint32_t*>(dvb + (size_t)key1 * D + c) =
            pack_bf16(dva[p][4 * n + 2], dva[p][4 * n + 3]);
      }
    }
  }
  if (t == 0) {
    if (key0 < Sk) dbias[(size_t)bh * Sk + key0] = dbp[0];
    if (key1 < Sk) dbias[(size_t)bh * Sk + key1] = dbp[1];
  }
}

// ------------------------------------------------------------ B3, bf16

template <int D>
struct QBf16 {
  static constexpr int ROWS = 64;                       // q rows per block
  static constexpr int BK = 64;                         // keys per streamed tile
  static constexpr uint32_t QG_BYTES = ROWS * D * 2;   // Q or G
  static constexpr uint32_t KV_BYTES = BK * D * 2;     // K or V, one stage
  // bias keys: a 1-D copy starts on a 16-byte boundary, so the box begins
  // at the key index rounded down to 4 and is 4 floats longer
  static constexpr int B_LEN = BK + 4;
  static constexpr uint32_t B_BYTES = (B_LEN * 4 + 127) / 128 * 128;  // slot
  static constexpr uint32_t STAGE_TX = 2 * KV_BYTES + B_LEN * 4;
  static constexpr size_t SMEM = 2 * QG_BYTES + kStages * (2 * KV_BYTES + B_BYTES) +
                                 8 * (kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(128) bwd_q_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int NH, int Sq, int Sk,
    float scale, int causal) {
  using P = Panels<D>;
  using L = QBf16<D>;
  constexpr int BK = L::BK, ROWS = L::ROWS;
  constexpr int KD = D / 16;
  constexpr int NS = BK / 2;     // floats a thread of S / dP
  constexpr int NA = P::PW / 2;  // floats a thread of one panel of dQ
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_1k(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);                  // [ROWS][D]
  bf16* Gs = reinterpret_cast<bf16*>(base + L::QG_BYTES);    // [ROWS][D]
  unsigned char* ring = base + 2 * L::QG_BYTES;              // K, V per stage
  unsigned char* keys = ring + kStages * 2 * L::KV_BYTES;    // bias per stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(keys + kStages * L::B_BYTES);
  // bars[s]: stage s full; bars[kStages]: Q/G resident

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, t = tid & 3;
  const int q0 = blockIdx.x * ROWS;
  const int bh = b * NH + h;
  int n_kv = (Sk + BK - 1) / BK;
  // causal: kv tiles wholly right of the diagonal (every key > the last row)
  if (causal) n_kv = min(n_kv, (min(q0 + ROWS, Sq) - 1) / BK + 1);

  auto k_tile = [&](int s) { return reinterpret_cast<bf16*>(ring + s * 2 * L::KV_BYTES); };
  auto v_tile = [&](int s) { return k_tile(s) + BK * D; };
  auto bias_keys = [&](int s) { return reinterpret_cast<float*>(keys + s * L::B_BYTES); };
  auto load_kv_tile = [&](int it) {  // one thread: kv tile it into its stage
    const int s = it % kStages, kt0 = it * BK;
    mbar_expect_tx(&bars[s], L::STAGE_TX);
#pragma unroll
    for (int p = 0; p < P::NP; ++p) {
      tma_3d(&tk, k_tile(s) + p * BK * P::PW, &bars[s], p * P::PW, kt0, bh);
      tma_3d(&tv, v_tile(s) + p * BK * P::PW, &bars[s], p * P::PW, kt0, bh);
    }
    tma_1d(&tb, bias_keys(s), &bars[s], (b * Sk + kt0) & ~3);
  };

  mbar_init_all(bars, kStages + 1);
  if (tid == 0) {
    mbar_expect_tx(&bars[kStages], 2 * L::QG_BYTES);
#pragma unroll
    for (int p = 0; p < P::NP; ++p) {
      tma_3d(&tq, Qs + p * ROWS * P::PW, &bars[kStages], p * P::PW, q0, bh);
      tma_3d(&tg, Gs + p * ROWS * P::PW, &bars[kStages], p * P::PW, q0, bh);
    }
    for (int it = 0; it < n_kv && it < kStages; ++it) load_kv_tile(it);
  }

  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const float lse0 = r0 < Sq ? lse[(size_t)bh * Sq + r0] : 0.f;
  const float lse1 = r1 < Sq ? lse[(size_t)bh * Sq + r1] : 0.f;
  const float del0 = r0 < Sq ? delta[(size_t)bh * Sq + r0] : 0.f;
  const float del1 = r1 < Sq ? delta[(size_t)bh * Sq + r1] : 0.f;

  float dqa[P::NP][NA], sc[NS], dp[NS];
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int i = 0; i < NA; ++i) dqa[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(&bars[kStages], 0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kStages, kt0 = it * BK;
    mbar_wait(&bars[s], (it / kStages) & 1);
    const bf16* Ks = k_tile(s);
    const bf16* Vs = v_tile(s);

    // S = Q K^T and dP = G V^T: this block's 64 q rows x BK keys
    fence_regs<NS>(sc);
    fence_regs<NS>(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<BK>::ss(sc, desc_k<D>(Qs, ROWS, kk), desc_k<D>(Ks, BK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<BK>::ss(dp, desc_k<D>(Gs, ROWS, kk), desc_k<D>(Vs, BK, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs<NS>(sc);
    fence_regs<NS>(dp);

    // dS in place of s; a tile of real keys and rows that causal does not
    // cut skips the per-element tests, as in B2
    const float* Bk = bias_keys(s) + ((b * Sk + kt0) & 3);
    auto ds = [&](auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * t + (e & 1);
          const int key = kt0 + j;
          const int row = e < 2 ? r0 : r1;
          float p = 0.f;
          if (!kChecked || (key < Sk && row < Sq))
            p = exp2f(s_minus_lse(sc[4 * n + e], scale, Bk[j], kChecked && causal && key > row,
                                  e < 2 ? lse0 : lse1) * kLog2e);
          sc[4 * n + e] = p * (dp[4 * n + e] - (e < 2 ? del0 : del1));
        }
      }
    };
    if (!causal && kt0 + BK <= Sk && q0 + ROWS <= Sq)
      ds(std::false_type());
    else
      ds(std::true_type());

    // dQ += dS K: A from registers, B = K transposed
#pragma unroll
    for (int p = 0; p < P::NP; ++p) fence_regs<NA>(dqa[p]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      c_to_a(&sc[8 * j], &sc[8 * j + 4], a);
#pragma unroll
      for (int p = 0; p < P::NP; ++p)
        Wgmma<P::PW>::rs_t(dqa[p], a, desc_mn<D>(Ks, BK, j, p), 1);
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < P::NP; ++p) fence_regs<NA>(dqa[p]);
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && it + kStages < n_kv) load_kv_tile(it + kStages);
  }

  bf16* dqb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int p = 0; p < P::NP; ++p) {
#pragma unroll
    for (int n = 0; n < P::PW / 8; ++n) {
      const int c = p * P::PW + n * 8 + 2 * t;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)r0 * D + c) =
            pack_bf16(dqa[p][4 * n] * scale, dqa[p][4 * n + 1] * scale);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)r1 * D + c) =
            pack_bf16(dqa[p][4 * n + 2] * scale, dqa[p][4 * n + 3] * scale);
    }
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

template <int D>
int kv_bf16(const void* q, const void* k, const void* v, const float* bias,
            const void* g, const float* lse, const float* delta, void* dk, void* dv,
            float* dbias, int B, int NH, int Sq, int Sk, int causal, float scale,
            cudaStream_t st) {
  using L = KvBf16<D>;
  const int BH = B * NH;
  CUtensorMap tq, tg, tk, tv, tl, td;
  if (!map_rows(&tq, q, BH, Sq, D, L::BQ) || !map_rows(&tg, g, BH, Sq, D, L::BQ) ||
      !map_rows(&tk, k, BH, Sk, D, L::KEYS) || !map_rows(&tv, v, BH, Sk, D, L::KEYS) ||
      !map_flat(&tl, lse, (size_t)BH * Sq, L::LD_LEN) ||
      !map_flat(&td, delta, (size_t)BH * Sq, L::LD_LEN))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(bwd_kv_bf16_kernel<D>, L::SMEM);
  return launch(bwd_kv_bf16_kernel<D>, attr, dim3((Sk + L::KEYS - 1) / L::KEYS, NH, B),
                L::SMEM, st, tq, tg, tk, tv, tl, td, bias, static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), dbias, NH, Sq, Sk, scale, causal);
}

template <int D>
int q_bf16(const void* q, const void* k, const void* v, const float* bias,
           const void* g, const float* lse, const float* delta, void* dq, int B,
           int NH, int Sq, int Sk, int causal, float scale, cudaStream_t st) {
  using L = QBf16<D>;
  const int BH = B * NH;
  CUtensorMap tq, tg, tk, tv, tb;
  if (!map_rows(&tq, q, BH, Sq, D, L::ROWS) || !map_rows(&tg, g, BH, Sq, D, L::ROWS) ||
      !map_rows(&tk, k, BH, Sk, D, L::BK) || !map_rows(&tv, v, BH, Sk, D, L::BK) ||
      !map_flat(&tb, bias, (size_t)B * Sk, L::B_LEN))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(bwd_q_bf16_kernel<D>, L::SMEM);
  return launch(bwd_q_bf16_kernel<D>, attr, dim3((Sq + L::ROWS - 1) / L::ROWS, NH, B),
                L::SMEM, st, tq, tg, tk, tv, tb, lse, delta, static_cast<bf16*>(dq), NH,
                Sq, Sk, scale, causal);
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
  if (is_bf16)
    return kv_bf16<D>(q, k, v, bp, g, lp, dp, dk, dv, dbp, B, NH, Sq, Sk, causal, scale, st);
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
  if (is_bf16)
    return q_bf16<D>(q, k, v, bp, g, lp, dp, dq, B, NH, Sq, Sk, causal, scale, st);
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
// float32, lse/delta [B, NH, Sq] float32; all contiguous, 16-byte aligned.
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
