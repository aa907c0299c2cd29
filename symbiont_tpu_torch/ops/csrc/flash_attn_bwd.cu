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
//
// Design of the f32 kernels (3xTF32 mma.sync on cp.async-staged tiles),
// which every float32 training step runs (the LM trainer's masters are
// float32). What bounds them on an H100: bytes below S ~ 300 (causal, D =
// 64; S ~ 150 without causal), above it the tensor cores' float32-accurate
// rate, 3xTF32 at 495 / 3 = 165 TFLOP/s. The scalar FFMA kernels they
// replace were held to the 67 TFLOP/s of float32 outside the tensor cores.
//   * Every product on the tensor cores in 3xTF32 (hopper.cuh): each f32
//     operand as tf32 hi + lo, the product as lo·hi + hi·lo + hi·hi,
//     accumulated in float32. One TF32 product keeps ~3 decimal digits,
//     which would miss the f32 bars (1e-4 abs + rel) and change the
//     trainer's numerics; 3xTF32 stays within them.
//   * mma.sync m16n8k8 .tf32, not wgmma: for 32-bit types wgmma reads
//     shared-memory operands K-major only and its tf32 register-A layout is
//     not the accumulator's, so the dV/dK/dQ products (whose B operand is
//     the staged tile read MN-major, and whose A is p / dS from the
//     accumulators) would need transposed hi and lo copies of every tile,
//     beyond what shared memory holds at D = 128. mma.sync loads fragments
//     with plain 32-bit shared loads in any layout, which is also the route
//     of PyTorch's memory-efficient SDPA for float32 (CUTLASS fast-f32).
//     wgmma with transposed copies is the way past it.
//   * The split happens in registers as each fragment is loaded from
//     shared memory, on the integer view (4 integer and float ops an
//     element); a split A fragment feeds the BQ/8 (BK/8) MMAs of its
//     k-step. Shared memory holds the raw float32, so a fragment element
//     costs one 32-bit load. hi and lo copies staged there once a tile
//     would spare the split of the B fragments, which each of a block's 4
//     warps repeats, for twice the shared-memory traffic and space and a
//     split pass a tile: not measured yet.
//   * A block is 4 warps; each warp owns 16 keys in B2, 16 q rows in B3
//     (the M side of its m16 tiles). B2 computes S^T = K Q^T and dP^T =
//     V G^T (A = the warp's K / V rows, B = the Q / G tile, both read as
//     stored), forms p^T and dS^T in the accumulators, then dV += P^T G and
//     dK += dS^T Q with A straight from those accumulators: a C tile's
//     columns 2t, 2t + 1 become the A fragment's k slots t, t + 4, and the
//     B operand is read in the same k order (rows 2t, 2t + 1), so no value
//     moves between lanes. B3 does the same with S = Q K^T, dP = G V^T and
//     dQ += dS K.
//   * Tiles are row-major with rows padded to D + 4 floats: the stride is 4
//     banks mod 32, so every fragment load, K-major or MN-major, hits 32
//     distinct banks.
//   * Staging by cp.async (16-byte copies; rows past S zero-filled) into a
//     ring of kStages = 2 for the streamed tiles (q/g/lse/delta in B2,
//     k/v/bias in B3): the next tile's copies are in flight while this
//     one's MMAs run. The resident tile (K/V, Q/G) is copied once.
//   * Tiles of 32 streamed rows (16 in B2 at D = 128): at 64 the
//     accumulators took most of a thread's registers, and the fewer blocks
//     an SM then holds hid less latency than the larger tiles saved.
//   * The elementwise step (p by expf, dS, dbias), as in the bf16 kernels,
//     takes a copy without bounds and mask tests on a tile whose rows and
//     keys are all real and wholly on or below the causal diagonal.
//   * Longest first: under causal, B2's key tile x walks the q tiles from
//     x on and B3's q tile the key tiles up to it, so block work differs
//     by up to S / 32 tiles. The tile index is the grid's slowest one (z;
//     head and batch in x and y), ordered so the longest blocks are
//     dispatched first and the last wave holds the shortest. With the
//     tile fastest (the bf16 kernels' order), the longest blocks of the
//     last heads run on alone at the end.
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

template <int D>
struct KvF32 {
  static constexpr int KEYS = 64;                // keys per block, 16 a warp
  static constexpr int BQ = D == 128 ? 16 : 32;  // q rows per streamed tile
  static constexpr int LD = F32Rows<D>::LD;
  static constexpr int STAGE = 2 * BQ * LD + 2 * BQ;  // floats: Q, G, lse, delta
  static constexpr size_t SMEM = sizeof(float) * (2 * KEYS * LD + kStages * STAGE);
};

template <int D>
__global__ void __launch_bounds__(128) bwd_kv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dbias, int NH, int Sq, int Sk,
    float scale, int causal) {
  using L = KvF32<D>;
  constexpr int KEYS = L::KEYS, BQ = L::BQ, LD = L::LD;
  constexpr int NQ = BQ / 8;  // n8 tiles of S^T / dP^T = k8 steps of dV / dK
  constexpr int ND = D / 8;   // k8 steps of S^T / dP^T = n8 tiles of dV / dK
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [KEYS][LD]
  float* Vs = Ks + KEYS * LD;                  // [KEYS][LD]
  float* ring = Vs + KEYS * LD;                // per stage: Q, G [BQ][LD], lse, delta [BQ]

  // the key tile is the grid's slowest index: tile 0, the longest walk
  // under causal, is dispatched first
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, t = tid & 3;
  const int k0 = kt * KEYS;
  const size_t bh = (size_t)b * NH + h;
  const float* qb = q + bh * Sq * D;
  const float* gb = g + bh * Sq * D;
  const int n_qt = (Sq + BQ - 1) / BQ;
  // causal: q tiles wholly above the diagonal (every q row < k0) are skipped
  const int qt0 = causal ? min(k0 / BQ, n_qt) : 0;
  const int n_it = n_qt - qt0;

  auto stage_q = [&](int it) {  // q tile qt0 + it into its stage, all threads
    float* st = ring + (it % kStages) * L::STAGE;
    const int q0 = (qt0 + it) * BQ;
    stage_rows<D, BQ>(st, qb, q0, Sq);
    stage_rows<D, BQ>(st + BQ * LD, gb, q0, Sq);
    if (tid < 2 * BQ) {  // lse then delta
      const float* src = (tid < BQ ? lse : delta) + bh * Sq;
      const int r = q0 + tid % BQ;
      cp_async4(st + 2 * BQ * LD + tid, r < Sq ? src + r : src, r < Sq);
    }
  };

  if (n_it > 0) {
    stage_rows<D, KEYS>(Ks, k + bh * Sk * D, k0, Sk);
    stage_rows<D, KEYS>(Vs, v + bh * Sk * D, k0, Sk);
    stage_q(0);
  }
  cp_async_commit();

  const int key0 = k0 + warp * 16 + gr, key1 = key0 + 8;
  const float bias0 = key0 < Sk ? bias[(size_t)b * Sk + key0] : 0.f;
  const float bias1 = key1 < Sk ? bias[(size_t)b * Sk + key1] : 0.f;
  const float* Kw = Ks + warp * 16 * LD;  // this warp's 16 keys
  const float* Vw = Vs + warp * 16 * LD;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  float dbp[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) stage_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just committed has landed
    __syncthreads();
    const float* Qs = ring + (it % kStages) * L::STAGE;
    const float* Gs = Qs + BQ * LD;
    const float* Lq = Gs + BQ * LD;
    const float* Dq = Lq + BQ;
    const int q0 = (qt0 + it) * BQ;

    // S^T = K Q^T and dP^T = V G^T: the warp's 16 keys x BQ q rows
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      a_frag<LD>(Kw, 8 * kk, kh, kl);
      a_frag<LD>(Vw, 8 * kk, vh, vl);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t bh2[2], bl2[2];
        b_frag_k<LD>(Qs + 8 * n * LD, 8 * kk, bh2, bl2);
        mma_3xtf32(st[n], kh, kl, bh2, bl2);
        b_frag_k<LD>(Gs + 8 * n * LD, 8 * kk, bh2, bl2);
        mma_3xtf32(dpt[n], vh, vl, bh2, bl2);
      }
    }

    // p^T and dS^T in place; the per-key dbias takes dS. A tile whose keys
    // and q rows are all real and wholly on or below the causal diagonal
    // skips the per-element tests (`checked` false).
    auto p_ds = [&](auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * n + 2 * t + (e & 1);
          const int qi = q0 + qc;
          const int key = e < 2 ? key0 : key1;
          float p = 0.f;
          if (!kChecked || (key < Sk && qi < Sq))
            p = expf(s_minus_lse(st[n][e], scale, e < 2 ? bias0 : bias1,
                                 kChecked && causal && key > qi, Lq[qc]));
          const float ds = p * (dpt[n][e] - Dq[qc]);
          dbp[e >> 1] += ds;
          st[n][e] = p;
          dpt[n][e] = ds;
        }
      }
    };
    if (k0 + KEYS <= Sk && q0 + BQ <= Sq && (!causal || k0 + KEYS - 1 <= q0))
      p_ds(std::false_type());
    else
      p_ds(std::true_type());

    // dV += P^T G, dK += dS^T Q: A from the registers just formed, B = G /
    // Q read MN-major in the same k order
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      c_frag(st[j], ph, pl);
      c_frag(dpt[j], sh, sl);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh2[2], bl2[2];
        b_frag_mn<LD>(Gs + 8 * j * LD, 8 * n, bh2, bl2);
        mma_3xtf32(dva[n], ph, pl, bh2, bl2);
        b_frag_mn<LD>(Qs + 8 * j * LD, 8 * n, bh2, bl2);
        mma_3xtf32(dka[n], sh, sl, bh2, bl2);
      }
    }
    __syncthreads();  // every warp is done with this stage: it may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 1);
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 2);
  }
  float* dkb = dk + bh * Sk * D;
  float* dvb = dv + bh * Sk * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = 8 * n + 2 * t;
    if (key0 < Sk) {
      *reinterpret_cast<float2*>(dkb + (size_t)key0 * D + c) =
          make_float2(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<float2*>(dvb + (size_t)key0 * D + c) = make_float2(dva[n][0], dva[n][1]);
    }
    if (key1 < Sk) {
      *reinterpret_cast<float2*>(dkb + (size_t)key1 * D + c) =
          make_float2(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<float2*>(dvb + (size_t)key1 * D + c) = make_float2(dva[n][2], dva[n][3]);
    }
  }
  if (t == 0) {
    if (key0 < Sk) dbias[bh * Sk + key0] = dbp[0];
    if (key1 < Sk) dbias[bh * Sk + key1] = dbp[1];
  }
}

// ------------------------------------------------------------- B3, f32

template <int D>
struct QF32 {
  static constexpr int ROWS = 64;                // q rows per block, 16 a warp
  static constexpr int BK = 32;                  // keys per streamed tile
  static constexpr int LD = F32Rows<D>::LD;
  static constexpr int STAGE = 2 * BK * LD + BK;  // floats: K, V, bias
  static constexpr size_t SMEM = sizeof(float) * (2 * ROWS * LD + kStages * STAGE);
};

template <int D>
__global__ void __launch_bounds__(128) bwd_q_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int NH, int Sq,
    int Sk, float scale, int causal) {
  using L = QF32<D>;
  constexpr int ROWS = L::ROWS, BK = L::BK, LD = L::LD;
  constexpr int NK = BK / 8;  // n8 tiles of S / dP = k8 steps of dQ
  constexpr int ND = D / 8;   // k8 steps of S / dP = n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [ROWS][LD]
  float* Gs = Qs + ROWS * LD;                  // [ROWS][LD]
  float* ring = Gs + ROWS * LD;                // per stage: K, V [BK][LD], bias [BK]

  // the q tile is the grid's slowest index, last tile first: the longest
  // walk under causal is dispatched first
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, t = tid & 3;
  const int q0 = qt * ROWS;
  const size_t bh = (size_t)b * NH + h;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const float* bb = bias + (size_t)b * Sk;
  int n_kv = (Sk + BK - 1) / BK;
  // causal: kv tiles wholly right of the diagonal (every key > the last row)
  if (causal) n_kv = min(n_kv, (min(q0 + ROWS, Sq) - 1) / BK + 1);

  auto stage_kv = [&](int it) {  // kv tile it into its stage, all threads
    float* st = ring + (it % kStages) * L::STAGE;
    const int kt0 = it * BK;
    stage_rows<D, BK>(st, kb, kt0, Sk);
    stage_rows<D, BK>(st + BK * LD, vb, kt0, Sk);
    if (tid < BK) {
      const int key = kt0 + tid;
      cp_async4(st + 2 * BK * LD + tid, key < Sk ? bb + key : bb, key < Sk);
    }
  };

  stage_rows<D, ROWS>(Qs, q + bh * Sq * D, q0, Sq);
  stage_rows<D, ROWS>(Gs, g + bh * Sq * D, q0, Sq);
  stage_kv(0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const float lse0 = r0 < Sq ? lse[bh * Sq + r0] : 0.f;
  const float lse1 = r1 < Sq ? lse[bh * Sq + r1] : 0.f;
  const float del0 = r0 < Sq ? delta[bh * Sq + r0] : 0.f;
  const float del1 = r1 < Sq ? delta[bh * Sq + r1] : 0.f;
  const float* Qw = Qs + warp * 16 * LD;  // this warp's 16 rows
  const float* Gw = Gs + warp * 16 * LD;

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) stage_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + (it % kStages) * L::STAGE;
    const float* Vs = Ks + BK * LD;
    const float* Bk = Vs + BK * LD;
    const int kt0 = it * BK;

    // S = Q K^T and dP = G V^T: the warp's 16 rows x BK keys
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t qh[4], ql[4], gh[4], gl[4];
      a_frag<LD>(Qw, 8 * kk, qh, ql);
      a_frag<LD>(Gw, 8 * kk, gh, gl);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bh2[2], bl2[2];
        b_frag_k<LD>(Ks + 8 * n * LD, 8 * kk, bh2, bl2);
        mma_3xtf32(sc[n], qh, ql, bh2, bl2);
        b_frag_k<LD>(Vs + 8 * n * LD, 8 * kk, bh2, bl2);
        mma_3xtf32(dp[n], gh, gl, bh2, bl2);
      }
    }

    // dS in place of s; a tile of real keys and rows wholly on or below the
    // causal diagonal skips the per-element tests, as in B2
    auto ds = [&](auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * t + (e & 1);
          const int key = kt0 + j;
          const int row = e < 2 ? r0 : r1;
          float p = 0.f;
          if (!kChecked || (key < Sk && row < Sq))
            p = expf(s_minus_lse(sc[n][e], scale, Bk[j], kChecked && causal && key > row,
                                 e < 2 ? lse0 : lse1));
          sc[n][e] = p * (dp[n][e] - (e < 2 ? del0 : del1));
        }
      }
    };
    if (kt0 + BK <= Sk && q0 + ROWS <= Sq && (!causal || kt0 + BK - 1 <= q0))
      ds(std::false_type());
    else
      ds(std::true_type());

    // dQ += dS K: A from the registers just formed, B = K read MN-major
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t sh[4], sl[4];
      c_frag(sc[j], sh, sl);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh2[2], bl2[2];
        b_frag_mn<LD>(Ks + 8 * j * LD, 8 * n, bh2, bl2);
        mma_3xtf32(dqa[n], sh, sl, bh2, bl2);
      }
    }
    __syncthreads();  // every warp is done with this stage: it may be refilled
  }
  cp_async_wait<0>();

  float* dqb = dq + bh * Sq * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(dqb + (size_t)r0 * D + c) =
          make_float2(dqa[n][0] * scale, dqa[n][1] * scale);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(dqb + (size_t)r1 * D + c) =
          make_float2(dqa[n][2] * scale, dqa[n][3] * scale);
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
  using L = KvF32<D>;
  static const cudaError_t attr = allow_smem(bwd_kv_f32_kernel<D>, L::SMEM);
  const int tiles = (Sk + L::KEYS - 1) / L::KEYS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;  // the grid's z limit
  return launch(bwd_kv_f32_kernel<D>, attr, dim3(NH, B, tiles),
                L::SMEM, st, static_cast<const float*>(q),
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
  using L = QF32<D>;
  static const cudaError_t attr = allow_smem(bwd_q_f32_kernel<D>, L::SMEM);
  const int tiles = (Sq + L::ROWS - 1) / L::ROWS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;  // the grid's z limit
  return launch(bwd_q_f32_kernel<D>, attr, dim3(NH, B, tiles),
                L::SMEM, st, static_cast<const float*>(q),
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
