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
// dtype before the PV product in bf16 (the running sum takes p unrounded;
// in f32 it is split, as every operand, for 3xTF32), and only
// finite masking constants (-1e30 for the running max and for keys past
// Sk, -1e9 for causal-masked keys), so a row whose keys are all masked
// comes out finite (uniform over its keys), as on the TPU.
//
// What bounds it on an H100: per (batch, head) it moves q, k, v and o once,
// 8*S*D bytes in bf16, and does 4*S*S*D flops, so S/2 flops a byte against
// the card's ~295 (989 TFLOP/s over 3.35 TB/s). At the encoder's shapes
// ([32, 12, S, 64], S = 32...512) every bucket is bound by bytes, S = 512
// just so (256 flops a byte). The S x S scores never reach device memory:
// q is read once, each K/V tile once per 64 q rows (from L2 after the
// first block of a head), o and lse written once.
//
// Design. The TPU kernel's sequential fourth grid axis (kv blocks, with
// m/l/acc in VMEM scratch) becomes a loop inside one thread block:
//   * bf16: one warpgroup (4 warps, 128 threads) per (64 q rows, q head,
//     batch). The Q tile is copied once by TMA; K/V tiles of 64 keys and
//     their bias keys stream through a ring of kStages = 2 stages by TMA
//     (3-D maps over [B*NH, Sq, D] and [B*NKV, Sk, D], so GQA indexes the
//     kv head and the ragged edge in S is zero-filled inside each head; the
//     bias through a 1-D map whose box starts at the key index rounded down
//     to 4 and is 4 floats longer, as a 1-D copy starts on a 16-byte
//     boundary). One thread issues each tile's copies against an mbarrier
//     with its byte count; a stage is refilled once every warp is done
//     with it. The maps are encoded on the host in the C entry and passed
//     as __grid_constant__ parameters, which a CUDA-graph capture keeps.
//     - S = Q K^T by wgmma m64n64k16 with both operands K-major in shared
//       memory (the swizzled panels Panels<D> names).
//     - The online softmax runs in the accumulator registers: a warp's
//       slice of the m64 accumulator has the mma.sync m16n8 C layout, so a
//       row's max and sum are reduced over its quad. Base 2, with
//       scale*log2(e) folded into the scores and one MUFU.EX2 a score
//       (`ex2`). A tile whose keys are all real and that causal does not
//       cut takes a copy of this step without the per-element bounds and
//       mask tests.
//     - O += P V by wgmma in the RS form: P from registers (`c_to_a` turns
//       two C n8-tiles into one A k-step) and V from its row-major tile
//       through the descriptor's transpose flag (MN-major B). At D = 128
//       O is two N = 64 panels. O is rescaled by the new max between the
//       tile's two products, after the previous PV wgmma has retired.
//     - The epilogue writes o (times 1 / the row sum) and lse once, from
//       registers.
//   * f32, which every float32 LM training step and float32 prefill runs:
//     every product on the tensor cores in 3xTF32 (hopper.cuh): each
//     float32 operand x as tf32 hi + lo, a product as lo·hi + hi·lo +
//     hi·hi accumulated in float32. One TF32 product keeps ~3 decimal
//     digits and would miss the float32 bars (1e-4 abs + rel); 3xTF32
//     keeps them. Bound: bytes at short S, above that (S ~ 300 causal at
//     D = 64) the 3xTF32 rate, 495 / 3 = 165 TFLOP/s. One warpgroup per
//     (64 q rows, q head, batch); each warp owns 16 rows.
//     - S = Q K^T by wgmma m64n64k8 .tf32, three a k-step, at D <= 64: Q
//       split once into registers (the RS form's A fragment, the mma.sync
//       m16n8k8 A layout); K staged by cp.async straight into the
//       128-byte-swizzled panels wgmma reads K-major, then split once a
//       tile by the block (hi in place, lo beside it, fence.proxy.async),
//       so no warp splits K's fragments again. At D = 128, where O alone
//       is 64 floats a thread, Q's hi and lo live in shared memory and S
//       takes mma.sync as O does.
//     - O += P V by mma.sync m16n8k8 .tf32. P goes straight from the S
//       accumulators into A: C tile columns 2t, 2t + 1 become A's k slots
//       t, t + 4, and V's rows are read in that key order, so no value
//       moves between lanes and V is not transposed. Its rows are padded
//       to D + 4 floats (32 distinct banks a fragment load), and each
//       fragment element is split as it is loaded. wgmma does not take
//       this product: for 32-bit types it reads B K-major only, so V
//       would need a transposed copy with its keys permuted within each 8
//       to match the accumulator's pairs.
//     - K, V and the bias keys stream through a ring of kStages = 2 by
//       16-byte cp.async, rows past Sk zero-filled (their keys -1e30);
//       Q is copied once.
//     - The online softmax in natural-log units, each exponent one
//       MUFU.EX2 of (x - m)·log2(e), and lse = m + log(l): a row whose
//       keys are all masked gets lse -1e9 exactly, the plain version's,
//       from which B2/B3 rebuild p = 1. A tile whose keys are all real
//       and wholly on or below the causal diagonal takes a copy of the
//       score step without the bounds and mask tests.
//     - The q tile is the grid's slowest index, last tile first, so the
//       longest causal blocks start first.
//     Measured on an H100 (700 W) with scripts/port_kernels_ab.py, causal
//     [8, 12, 1024, 64], S by mma.sync: the split in registers at each
//     fragment load 0.266 ms against 0.364 for a split pass a tile into
//     shared hi and lo copies (twice the fragment loads' shared-memory
//     bytes, and one block an SM); 64-row blocks 0.265 ms against 0.462
//     for 32-row ones, and 0.0088 against 0.0095 at S 64, where 32 rows
//     would fill 192 blocks for 132 SMs instead of 96 (a warp does the
//     same work either way, and each K/V tile is read twice as often).
//     Then S by wgmma: 0.240 ms against 0.266.
// Causal blocks skip every kv tile that lies wholly above the diagonal.
// What the bf16 kernel does about the four costs of the earlier mma.sync
// design: synchronous 16-byte loads with __syncthreads staging became TMA
// copies in a 2-stage ring; the transposed copy of V (one scalar shared
// store per element) gave way to the wgmma transpose flag; scalar 32-bit
// fragment loads from shared memory gave way to descriptors the tensor
// cores read (P comes straight from the accumulators); mma.sync m16n8k16
// per warp became warpgroup wgmma on 64-row tiles. The Hopper building
// blocks are in hopper.cuh, shared with the backward kernels.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the return value is cudaGetLastError() after launch
// (or cudaErrorInvalidValue for a shape the kernel does not take, or a
// tensor map the driver refuses, e.g. a base address that is not 16-byte
// aligned).

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kAccNeg = -1e30f;   // running-max init, keys past Sk
constexpr float kMaskNeg = -1e9f;   // causal-masked keys (natural-log units)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU.EX2 (flushing a subnormal result to 0): exp2f's
// subnormal range handling costs three more instructions per score.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ----------------------------------------------------------------- bf16

template <int D>
struct FwdBf16 {
  static constexpr int ROWS = 64;                      // q rows per block
  static constexpr int BK = 64;                        // keys per streamed tile
  static constexpr uint32_t Q_BYTES = ROWS * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;    // K or V, one stage
  // bias keys: a 1-D copy starts on a 16-byte boundary, so the box begins
  // at the key index rounded down to 4 and is 4 floats longer
  static constexpr int B_LEN = BK + 4;
  static constexpr uint32_t B_BYTES = (B_LEN * 4 + 127) / 128 * 128;  // slot
  static constexpr uint32_t STAGE_TX = 2 * KV_BYTES + B_LEN * 4;
  static constexpr size_t SMEM = Q_BYTES + kStages * (2 * KV_BYTES + B_BYTES) +
                                 8 * (kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
    bf16* __restrict__ o, float* __restrict__ lse, int NH, int NKV, int Sq, int Sk,
    float scale, int causal) {
  using P = Panels<D>;
  using L = FwdBf16<D>;
  constexpr int BK = L::BK, ROWS = L::ROWS;
  constexpr int KD = D / 16;     // k-steps of S over the head dim
  constexpr int NS = BK / 2;     // floats a thread of S
  constexpr int NA = P::PW / 2;  // floats a thread of one panel of O
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_1k(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);                // [ROWS][D]
  unsigned char* ring = base + L::Q_BYTES;                 // K, V per stage
  unsigned char* keys = ring + kStages * 2 * L::KV_BYTES;  // bias per stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(keys + kStages * L::B_BYTES);
  // bars[s]: stage s full; bars[kStages]: Q resident

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, t = tid & 3;
  const int q0 = blockIdx.x * ROWS;
  const int bh = b * NH + h;
  const int bkv = b * NKV + h / (NH / NKV);
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
      tma_3d(&tk, k_tile(s) + p * BK * P::PW, &bars[s], p * P::PW, kt0, bkv);
      tma_3d(&tv, v_tile(s) + p * BK * P::PW, &bars[s], p * P::PW, kt0, bkv);
    }
    tma_1d(&tb, bias_keys(s), &bars[s], (b * Sk + kt0) & ~3);
  };

  mbar_init_all(bars, kStages + 1);
  if (tid == 0) {
    mbar_expect_tx(&bars[kStages], L::Q_BYTES);
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
      tma_3d(&tq, Qs + p * ROWS * P::PW, &bars[kStages], p * P::PW, q0, bh);
    for (int it = 0; it < n_kv && it < kStages; ++it) load_kv_tile(it);
  }

  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  float oacc[P::NP][NA], sc[NS];
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int i = 0; i < NA; ++i) oacc[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  float m[2] = {kAccNeg, kAccNeg};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  const float sl2 = scale * kLog2e;
  const float causal_neg = kMaskNeg * kLog2e;

  mbar_wait(&bars[kStages], 0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kStages, kt0 = it * BK;
    mbar_wait(&bars[s], (it / kStages) & 1);
    const bf16* Ks = k_tile(s);
    const bf16* Vs = v_tile(s);

    // S = Q K^T: this block's 64 q rows x BK keys
    fence_regs<NS>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<BK>::ss(sc, desc_k<D>(Qs, ROWS, kk), desc_k<D>(Ks, BK, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs<NS>(sc);

    // scale, bias, masks (in base 2) and the running max over the quad that
    // shares a row; an interior tile skips the per-element tests
    const float* Bk = bias_keys(s) + ((b * Sk + kt0) & 3);
    float mx[2] = {m[0], m[1]};
    auto scores = [&](auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = n * 8 + 2 * t + c;
          const float bj = Bk[j] * kLog2e;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // rows r0, r1
            float x = sc[4 * n + 2 * hr + c] * sl2 + bj;
            if (kChecked) {
              const int key = kt0 + j;
              if (key >= Sk)
                x = kAccNeg;
              else if (causal && key > (hr ? r1 : r0))
                x = causal_neg;
            }
            sc[4 * n + 2 * hr + c] = x;
            mx[hr] = fmaxf(mx[hr], x);
          }
        }
      }
    };
    if (kt0 + BK <= Sk && (!causal || kt0 + BK - 1 <= q0))
      scores(std::false_type());
    else
      scores(std::true_type());

    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
    // the previous tile's PV wgmma has retired (waited below): rescale O
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int i = 0; i < NA; ++i) oacc[p][i] *= alpha[(i >> 1) & 1];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = ex2(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;  // the sum takes p in f32; PV takes it in bf16
      sc[i] = p;
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) c_to_a(&sc[8 * j], &sc[8 * j + 4], pa[j]);

    // O += P V: A from registers, B = V transposed
#pragma unroll
    for (int p = 0; p < P::NP; ++p) fence_regs<NA>(oacc[p]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int p = 0; p < P::NP; ++p)
        Wgmma<P::PW>::rs_t(oacc[p], pa[j], desc_mn<D>(Vs, BK, j, p), 1);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < P::NP; ++p) fence_regs<NA>(oacc[p]);
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && it + kStages < n_kv) load_kv_tile(it + kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  bf16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int p = 0; p < P::NP; ++p) {
#pragma unroll
    for (int n = 0; n < P::PW / 8; ++n) {
      const int c = p * P::PW + n * 8 + 2 * t;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + c) =
            pack_bf16(oacc[p][4 * n] * inv[0], oacc[p][4 * n + 1] * inv[0]);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + c) =
            pack_bf16(oacc[p][4 * n + 2] * inv[1], oacc[p][4 * n + 3] * inv[1]);
    }
  }
  if (t == 0) {
    float* lb = lse + (size_t)bh * Sq;
    if (r0 < Sq) lb[r0] = (m[0] + log2f(l[0])) * kLn2;
    if (r1 < Sq) lb[r1] = (m[1] + log2f(l[1])) * kLn2;
  }
}

// ------------------------------------------------------------------ f32

template <int D>
struct FwdF32 {
  static constexpr int ROWS = 64;                // q rows per block, 16 a warp
  static constexpr int BK = D == 128 ? 32 : 64;  // keys per streamed tile
  // D <= 64: Q split into registers, S = Q K^T by wgmma (its RS form);
  // D = 128: Q split into shared memory, S by mma.sync
  static constexpr bool QK_WGMMA = D <= 64;
  static constexpr int LD = F32Rows<D>::LD;
  // floats: a K tile (swizzled panels for wgmma, else padded rows) and its
  // lo copy, Q (or its hi and lo), a V tile, a tile's bias keys
  static constexpr int K_FLOATS = QK_WGMMA ? BK * D : BK * LD;
  static constexpr int KLO_FLOATS = QK_WGMMA ? BK * D : 0;
  static constexpr int Q_FLOATS = (QK_WGMMA ? 1 : 2) * ROWS * LD;
  static constexpr int V_FLOATS = BK * LD;
  static constexpr size_t SMEM =
      sizeof(float) * (kStages * (K_FLOATS + V_FLOATS + BK) + KLO_FLOATS + Q_FLOATS) + 1024;
  static_assert(!QK_WGMMA || BK == 64, "wgmma m64n64 tiles");
};

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ o, float* __restrict__ lse, int NH, int NKV, int Sq,
    int Sk, float scale, int causal) {
  using L = FwdF32<D>;
  constexpr int ROWS = L::ROWS, BK = L::BK, LD = L::LD;
  constexpr int NK = BK / 8;  // n8 tiles of S = k8 steps of O += P V
  constexpr int ND = D / 8;   // k8 steps of S = n8 tiles of O
  extern __shared__ unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_1k(smem_raw));
  float* k_lo = base + kStages * L::K_FLOATS;  // QK_WGMMA: this tile's K lo
  float* Qs = k_lo + L::KLO_FLOATS;           // [ROWS][LD]; at D = 128 then its lo
  float* v_ring = Qs + L::Q_FLOATS;           // V [BK][LD] per stage
  float* b_ring = v_ring + kStages * L::V_FLOATS;  // bias keys [BK] per stage

  // the q tile is the grid's slowest index, last tile first: the longest
  // walk under causal is dispatched first
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, t = tid & 3;
  const int q0 = qt * ROWS;
  const size_t bh = (size_t)b * NH + h;
  const size_t bkv = (size_t)b * NKV + h / (NH / NKV);
  const float* kb = k + bkv * Sk * D;
  const float* vb = v + bkv * Sk * D;
  const float* bb = bias + (size_t)b * Sk;
  int n_kv = (Sk + BK - 1) / BK;
  // causal: kv tiles wholly right of the diagonal (every key > the last row)
  if (causal) n_kv = min(n_kv, (min(q0 + ROWS, Sq) - 1) / BK + 1);

  auto stage_kv = [&](int it) {  // kv tile it into its stage, all threads
    const int st = it % kStages, kt0 = it * BK;
    if constexpr (L::QK_WGMMA)
      stage_rows_sw<D, BK>(base + st * L::K_FLOATS, kb, kt0, Sk);
    else
      stage_rows<D, BK>(base + st * L::K_FLOATS, kb, kt0, Sk);
    stage_rows<D, BK>(v_ring + st * L::V_FLOATS, vb, kt0, Sk);
    if (tid < BK) {
      const int key = kt0 + tid;
      cp_async4(b_ring + st * BK + tid, key < Sk ? bb + key : bb, key < Sk);
    }
  };

  stage_rows<D, ROWS>(Qs, q + bh * Sq * D, q0, Sq);
  cp_async_commit();
  stage_kv(0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; kv tile 0 may be in flight
  __syncthreads();

  // Q, split once: into registers at D <= 64; at D = 128 (where O alone is
  // 64 floats a thread) into hi (in place) and lo copies in shared memory
  const float* Qw = Qs + warp * 16 * LD;  // this warp's 16 rows
  uint32_t qh[L::QK_WGMMA ? ND : 1][4], ql[L::QK_WGMMA ? ND : 1][4];
  if constexpr (L::QK_WGMMA) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) a_frag<LD>(Qw, 8 * kk, qh[kk], ql[kk]);
  } else {
    split_flat(Qs, Qs + ROWS * LD, ROWS * LD);
    __syncthreads();
  }

  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float sc[NK][4];  // S, then P, of the current tile
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  float m[2] = {kAccNeg, kAccNeg};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) stage_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just committed has landed
    __syncthreads();
    const int st = it % kStages, kt0 = it * BK;
    float* Ks = base + st * L::K_FLOATS;
    const float* Vs = v_ring + st * L::V_FLOATS;
    const float* Bk = b_ring + st * BK;

    // S = Q K^T: the warp's 16 rows x BK keys, K K-major as stored
    if constexpr (L::QK_WGMMA) {
      // the tile split once (hi in place, lo beside it) for the warpgroup's
      // wgmmas, which read both from shared memory; Q from registers
      split_flat(Ks, k_lo, BK * D);
      fence_proxy_async();
      __syncthreads();
      float* sf = &sc[0][0];
      fence_regs<NK * 4>(sf);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        WgmmaTf32::rs(sf, ql[kk], desc_k_tf32<BK>(Ks, kk), kk > 0);
        WgmmaTf32::rs(sf, qh[kk], desc_k_tf32<BK>(k_lo, kk), 1);
        WgmmaTf32::rs(sf, qh[kk], desc_k_tf32<BK>(Ks, kk), 1);
      }
      wg_commit();
      wg_wait_all();
      fence_regs<NK * 4>(sf);
    } else {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        uint32_t ah[4], al[4];
        a_frag_split<LD>(reinterpret_cast<const uint32_t*>(Qw),
                         reinterpret_cast<const uint32_t*>(Qw + ROWS * LD), 8 * kk, ah, al);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          uint32_t bh2[2], bl2[2];
          b_frag_k<LD>(Ks + 8 * n * LD, 8 * kk, bh2, bl2);
          mma_3xtf32(sc[n], ah, al, bh2, bl2);
        }
      }
    }

    // s = qk * scale + bias in the plain version's order, masks, and the
    // running max over the quad that shares a row; a tile whose keys are
    // all real and wholly on or below the causal diagonal skips the tests
    float mx[2] = {m[0], m[1]};
    auto scores = [&](auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * t + (e & 1);
          float x = __fadd_rn(__fmul_rn(sc[n][e], scale), Bk[j]);
          if (kChecked) {
            const int key = kt0 + j;
            if (key >= Sk)
              x = kAccNeg;
            else if (causal && key > (e < 2 ? r0 : r1))
              x = kMaskNeg;
          }
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    };
    if (kt0 + BK <= Sk && (!causal || kt0 + BK - 1 <= q0))
      scores(std::false_type());
    else
      scores(std::true_type());

    // the online softmax in natural-log units; each exponent as one
    // MUFU.EX2 of (x - m) * log2(e)
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((sc[n][e] - m[e >> 1]) * kLog2e);
        l[e >> 1] += p;
        sc[n][e] = p;
      }

    // O += P V: A straight from the accumulators just formed (C tile j's
    // columns 2t, 2t + 1 as its k slots t, t + 4), V read MN-major in the
    // same key order
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t ph[4], pl[4];
      c_frag(sc[j], ph, pl);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh2[2], bl2[2];
        b_frag_mn<LD>(Vs + 8 * j * LD, 8 * n, bh2, bl2);
        mma_3xtf32(oacc[n], ph, pl, bh2, bl2);
      }
    }
    __syncthreads();  // every warp is done with this stage: it may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  float* ob = o + bh * Sq * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(ob + (size_t)r0 * D + c) =
          make_float2(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(ob + (size_t)r1 * D + c) =
          make_float2(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  if (t == 0) {  // lse = m + log(l), natural log, as the plain version
    float* lb = lse + bh * Sq;
    if (r0 < Sq) lb[r0] = __fadd_rn(m[0], logf(l[0]));
    if (r1 < Sq) lb[r1] = __fadd_rn(m[1], logf(l[1]));
  }
}

// ----------------------------------------------------------------- launch

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
             void* lse, int B, int NH, int NKV, int Sq, int Sk, int causal, float scale,
             cudaStream_t st) {
  using L = FwdBf16<D>;
  CUtensorMap tq, tk, tv, tb;
  if (!map_rows(&tq, q, B * NH, Sq, D, L::ROWS) || !map_rows(&tk, k, B * NKV, Sk, D, L::BK) ||
      !map_rows(&tv, v, B * NKV, Sk, D, L::BK) ||
      !map_flat(&tb, bias, (size_t)B * Sk, L::B_LEN))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(flash_fwd_bf16_kernel<D>, L::SMEM);
  return launch(flash_fwd_bf16_kernel<D>, attr, dim3((Sq + L::ROWS - 1) / L::ROWS, NH, B),
                L::SMEM, st, tq, tk, tv, tb, static_cast<bf16*>(o), static_cast<float*>(lse),
                NH, NKV, Sq, Sk, scale, causal);
}

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
            int B, int NH, int NKV, int Sq, int Sk, int causal, float scale, cudaStream_t st) {
  using L = FwdF32<D>;
  static const cudaError_t attr = allow_smem(flash_fwd_f32_kernel<D>, L::SMEM);
  const int tiles = (Sq + L::ROWS - 1) / L::ROWS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;  // the grid's z limit
  return launch(flash_fwd_f32_kernel<D>, attr, dim3(NH, B, tiles), L::SMEM, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(bias),
                static_cast<float*>(o), static_cast<float*>(lse), NH, NKV, Sq, Sk, scale, causal);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
        int B, int NH, int NKV, int Sq, int Sk, int is_bf16, int causal, float scale,
        cudaStream_t st) {
  if (is_bf16) return fwd_bf16<D>(q, k, v, bias, o, lse, B, NH, NKV, Sq, Sk, causal, scale, st);
  return fwd_f32<D>(q, k, v, bias, o, lse, B, NH, NKV, Sq, Sk, causal, scale, st);
}

}  // namespace

// o [B, NH, Sq, D] in the inputs' dtype and lse [B, NH, Sq] float32. q
// [B, NH, Sq, D], k/v [B, NKV, Sk, D] with NKV dividing NH, bias [B, Sk]
// float32; all contiguous, 16-byte aligned.
extern "C" int symbiont_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int NH, int NKV, int Sq, int Sk, int D, int is_bf16,
    int causal, float scale, void* stream) {
  if (bad_shape(B, NH, Sq, Sk) || NKV <= 0 || NH % NKV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return fwd<32>(q, k, v, bias, o, lse, B, NH, NKV, Sq, Sk, is_bf16, causal, scale, st);
    case 64:
      return fwd<64>(q, k, v, bias, o, lse, B, NH, NKV, Sq, Sk, is_bf16, causal, scale, st);
    case 128:
      return fwd<128>(q, k, v, bias, o, lse, B, NH, NKV, Sq, Sk, is_bf16, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
