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
// dtype before the PV product (the running sum takes p unrounded), and only
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
//   * f32: a scalar kernel (4 threads per q row, 32 rows, 16-key tiles) in
//     full float32 with expf, for exactness where the caller asked for f32;
//     the tensor cores would round f32 operands to TF32.
// Causal blocks skip every kv tile that lies wholly above the diagonal.
// What this does about the four costs of the earlier mma.sync design:
// synchronous 16-byte loads with __syncthreads staging became TMA copies
// in a 2-stage ring; the transposed copy of V (one scalar shared store per
// element) gave way to the wgmma transpose flag; scalar 32-bit fragment
// loads from shared memory gave way to descriptors the tensor cores read
// (P comes straight from the accumulators); mma.sync m16n8k16 per warp
// became warpgroup wgmma on 64-row tiles. The Hopper building blocks are
// in hopper.cuh, shared with the backward kernels.
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
int fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
        int B, int NH, int NKV, int Sq, int Sk, int is_bf16, int causal, float scale,
        cudaStream_t st) {
  if (is_bf16) return fwd_bf16<D>(q, k, v, bias, o, lse, B, NH, NKV, Sq, Sk, causal, scale, st);
  return launch(flash_fwd_f32_kernel<D>, cudaSuccess, dim3((Sq + kFQ - 1) / kFQ, NH, B), 0, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(bias),
                static_cast<float*>(o), static_cast<float*>(lse), NH, NKV, Sq, Sk, scale,
                causal);
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
