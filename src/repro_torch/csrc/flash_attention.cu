// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_attn_kernel
// launched by flash_attention_flat. Same function: online-softmax attention
// over flat heads, q (BHq, Sq, D), k/v (BHkv, Skv, D), query head b reading
// kv head b / kv_repeat; scale 1/sqrt(D), then optional softcap
// c*tanh(s/c), then causal and sliding-window masks at absolute query
// positions q_offset + i, masked scores the finite -1e30, l clamped at
// 1e-30, f32 accumulation and the output in the inputs' dtype (rounded to
// nearest even).
//
// What bounds it on this card: each visible (q, k) pair costs 4 D flops
// on the tensor cores (4096 a clock an SM in bf16) and one exp on the
// special-function unit (16 a clock an SM), so at D = 64 and 128 the exps
// alone take 1 and 1/2 times the tensor cores' time, and each query tile
// re-reads ~4 D bytes of K and V a key from L2. At the serving shapes the
// tensor-core bound is 0.11 to 0.56 ms a call and the HBM byte bound a
// fifth of it or less: compute-bound, with the softmax hidden under the
// products only as far as the consumers overlap the two.
//
// bf16, D >= 64 (every serving and training path), attn_ws_kernel: the
// warp-specialised design.
//   * A block takes BQ = 64 NC query rows of one head: a producer
//     warpgroup and NC consumer warpgroups of 64 rows each (NC = 3 at
//     D = 64, 2 above). setmaxnreg hands the registers over: 24 a thread
//     to the producer and 240 to each consumer (32 and 160 at NC = 3). At
//     D = 192 a consumer holds O (64 x 192 f32, 96 registers), S (56) and
//     P (28 as bf16 pairs).
//   * Producer: one thread issues TMA loads through 3-D tensor maps
//     (D, S, heads). Q (BQ x D) once; K and V tiles of KV keys (128; 112 at
//     D = 192, 80 at D = 256, so two stages fit 227 KB) into a ring of two
//     stages each, with full and empty mbarriers; K_t goes before V_t, as
//     the consumers need them. A 128-byte swizzled box is 64 columns wide,
//     so a row of D is D / 64 boxes: the atoms of the layout wgmma reads
//     (tc::Swz). Rows past Sq or Skv read zeros.
//   * Consumers: step i issues S_i = Q K_i^T (Q and K from shared memory)
//     and O += P_{i-1} V_{i-1} (P from registers, V N-major) as two wgmma
//     groups, waits for the first (wgmma.wait_group 1), frees K_i, runs the
//     softmax of S_i while P V runs, waits for it, frees V_{i-1}, rescales
//     O and packs P_i. The consumers take turns issuing (named barriers),
//     so one's softmax runs under the others' products.
//   * Epilogue: O / l as bf16 goes into the consumer's own Q rows (its last
//     S has landed) and out by a TMA store, which clips rows past Sq.
//   * Kept from the one-warpgroup design: tiles with no visible pair are
//     never loaded (the causal diagonal, the window start); masks run only
//     on tiles that cut the diagonal, the window edge or a ragged Skv; the
//     softmax runs in base 2 with the scale folded in (one FFMA and one
//     ex2 a score); softcap is c - 2c / (2^(2s/c log2 e) + 1) on the ex2
//     and rcp units (~1e-7 in tanh; tanh.approx's ~2^-11 times 50 would
//     show); O is rescaled only when a warp's running max moved; the
//     longest causal tiles go first (blockIdx.x reversed).
//
// bf16, D = 16 and 32, attn_bf16_kernel: one warpgroup of 128 threads a
// 64-row query tile loads its own Q, K and V with 16-byte cp.async into a
// two-stage ring, in the 64- or 32-byte swizzled layout, and waits for
// each wgmma; the same masks and softmax. Rows of 32 or 64 bytes are not
// whole 128-byte TMA atoms.
//
// float32 (the reduced models' exact-token checks, which TF32 would miss)
// keeps the CUDA-core design, attn_f32_kernel: 256 threads per 64-row
// query tile, f32 tiles in shared memory, 4 x 4 register micro-tiles of
// f32 FMAs.
//
// Ragged lengths: any Sq/Skv. Query rows past Sq are computed on zeros and
// not stored; keys past Skv get p = 0 exactly.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "mma.cuh"
#include "tma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA-core design
// ---------------------------------------------------------------------------

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per kv tile
constexpr int NT = 256;   // threads per block, a 16 x 16 grid (ty, tx)
constexpr int RQ = BQ / 16;   // query rows per thread: ty + 16 * i
constexpr int CK = BKV / 16;  // score columns per thread: tx + 16 * j

template <int D>
struct Layout {
  static constexpr int QS = D + 1;    // padded row stride of sQ (f32 words)
  static constexpr int KS = D + 1;    // ... of sK
  static constexpr int PS = BKV + 1;  // ... of sP
  static constexpr int bytes =
      (BQ * QS + BKV * KS + BKV * D + BQ * PS) * int(sizeof(float));
};

template <int D>
__global__ void __launch_bounds__(NT)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int Sq,
                int Skv, int kv_repeat, int causal, int window, float softcap,
                int q_offset, float scale) {
  using L = Layout<D>;
  constexpr int CD = D / 16;  // acc columns per thread: tx + 16 * c
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * L::QS;
  float* sV = sK + BKV * L::KS;
  float* sP = sV + BKV * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // causal tiles near the end do the most work: hand them out first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);

  const float* qg = q + ((size_t)bh * Sq + q0) * D;
  const float* kg = k + (size_t)(bh / kv_repeat) * Skv * D;
  const float* vg = v + (size_t)(bh / kv_repeat) * Skv * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sQ[r * L::QS + c] = r < nq ? (qg[(size_t)r * D + c]) : 0.f;
  }

  // kv tiles holding at least one visible (q, k) pair
  const int qlo = q_offset + q0;
  const int qhi = q_offset + q0 + nq - 1;
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(kv_end, qhi + 1);
  if (window > 0) kv_begin = max(0, qlo - window + 1);
  const int t_begin = kv_begin / BKV;
  const int t_end = kv_end > kv_begin ? (kv_end + BKV - 1) / BKV : t_begin;

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    const int nk = min(BKV, Skv - k0);
    __syncthreads();  // the previous tile's sK, sV, sP are no longer read
    for (int i = tid; i < BKV * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = r < nk;
      sK[r * L::KS + c] = in ? (kg[(size_t)(k0 + r) * D + c]) : 0.f;
      sV[r * D + c] = in ? (vg[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RQ], kb[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qa[i] = sQ[(ty + 16 * i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kb[j] = sK[(tx + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = qlo + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = tx + 16 * j < nk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp: lanes differ in tx only
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = tx + 16 * j < nk ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty + 16 * i) * L::PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // sP is complete

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pa[RQ], vb[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pa[i] = sP[(ty + 16 * i) * L::PS + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vb[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

  float* og = o + ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CD; ++c)
        og[(size_t)r * D + tx + 16 * c] = acc[i][c] / lc;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma, cp.async ring
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;  // K/V tiles in flight
constexpr int TNT = 128;   // threads per block: one warpgroup, 64 query rows

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int KV = 64;                    // keys per kv tile
  using S = tc::Swz<D>;
  static constexpr int q_bytes = 64 * D * 2;       // the Q tile
  static constexpr int kv_bytes = KV * D * 2;      // a K or a V tile
  static constexpr int bytes = q_bytes + STAGES * 2 * kv_bytes;
};

// S = Q K^T with Q and K from shared memory; O += P V with P from
// registers and V read N-major (transposed) from shared memory
template <int D>
__global__ void __launch_bounds__(TNT)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int Sq, int Skv,
                 int kv_repeat, int causal, int window, float softcap,
                 int q_offset, float scale) {
  using T = Tiles<D>;
  using S = typename T::S;
  constexpr int KV = T::KV;
  constexpr int NS = KV / 8, NO = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  unsigned char* sQ = smem_bf16;                       // [q_bytes]
  unsigned char* sK = sQ + T::q_bytes;                 // [STAGES][kv_bytes]
  unsigned char* sV = sK + STAGES * T::kv_bytes;       // [STAGES][kv_bytes]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // causal tiles near the end do the most work: hand them out first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * 64;
  const int nq = min(64, Sq - q0);
  const __nv_bfloat16* kg = k + (size_t)(bh / kv_repeat) * Skv * D;
  const __nv_bfloat16* vg = v + (size_t)(bh / kv_repeat) * Skv * D;

  const int qlo = q_offset + q0;
  const int qhi = q_offset + q0 + nq - 1;
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(kv_end, qhi + 1);
  if (window > 0) kv_begin = max(0, qlo - window + 1);
  const int t_begin = kv_begin / KV;
  const int t_end = kv_end > kv_begin ? (kv_end + KV - 1) / KV : t_begin;

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * KV;
    const int nk = min(KV, Skv - k0);
    tc::load_swz<D, D, KV, TNT>(sK + stage * T::kv_bytes, kg + (size_t)k0 * D,
                                D, nk);
    tc::load_swz<D, D, KV, TNT>(sV + stage * T::kv_bytes, vg + (size_t)k0 * D,
                                D, nk);
  };
  tc::load_swz<D, D, 64, TNT>(sQ, q + ((size_t)bh * Sq + q0) * D, D, nq);
  if (t_begin < t_end) load_kv(t_begin, 0);
  tc::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qpos0 = qlo + warp * 16 + g;
  // the scale folded into the base-2 constants
  const float k2 = softcap > 0.f ? 2.f * LOG2E * scale / softcap : 0.f;
  const float cl = softcap * LOG2E, cl2 = 2.f * cl, sl = scale * LOG2E;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % STAGES;
    if (t + 1 < t_end) {
      load_kv(t + 1, (t + 1 - t_begin) % STAGES);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();
    const unsigned char* sKt = sK + stage * T::kv_bytes;
    const unsigned char* sVt = sV + stage * T::kv_bytes;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss<KV, 0, 0>(s, S::template kmajor<64>(sQ, kk),
                             S::template kmajor<KV>(sKt, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();

    const int k0 = t * KV;
    const int nk = min(KV, Skv - k0);
    const bool whole = nk == KV && (!causal || k0 + KV - 1 <= qlo) &&
                       (window <= 0 || qhi - k0 < window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // base 2: exp(s - m) = 2^(x - m') with x = s log2(e); softcap
        // c tanh(s/c) log2(e) = cl - 2 cl / (2^(s k2) + 1), cl = c log2(e)
        float x = softcap > 0.f
                      ? cl - __fdividef(cl2, exp2f(s[n][e] * k2) + 1.f)
                      : s[n][e] * sl;
        if (!whole) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8, kpos = k0 + col;
          bool ok = col < nk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          x = ok ? x : NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        const float p = whole || col < nk ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = p;
        l[e >> 1] += p;
      }
    // the running max rarely moves after the first tiles: skip the
    // rescale of the 16 x D accumulator when it did not move in this warp
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    uint32_t pa[KV / 16][4];
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) {
      pa[kk][0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk)
      tc::wgmma_rs_t<D>(acc, pa[kk], S::template mnmajor<KV>(sVt, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    __syncthreads();  // this stage is read; the next load may refill it
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* og = o + ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row < nq) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * D + n * 8 +
                                           2 * t4) =
            __floats2bfloat162_rn(acc[n][2 * r] / l[r],
                                  acc[n][2 * r + 1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D >= 64: a TMA producer and two asynchronous wgmma consumers
// ---------------------------------------------------------------------------

template <int D>
struct WsTiles {
  static constexpr int NC = D == 64 ? 3 : 2;    // consumer warpgroups
  static constexpr int BQ = 64 * NC;            // query rows a tile
  static constexpr int THREADS = 128 * (NC + 1);
  // registers a thread after the hand-over (65,536 a block in all)
  static constexpr int PRODUCER_REGS = NC == 2 ? 24 : 32;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 160;
  static constexpr int KV = D == 192 ? 112 : D == 256 ? 80 : 128;
  // Q as S's register operand where the registers allow (Q 32, O 64,
  // S 64, P 32 a thread); shared memory then serves K and V only
  static constexpr bool Q_REGS = D == 128;
  static constexpr int STAGES = 2;
  static constexpr int q_bytes = BQ * D * 2;
  static constexpr int kv_bytes = KV * D * 2;  // a K or a V tile
  static constexpr int bar_off = q_bytes + 2 * STAGES * kv_bytes;
  // Q; full and empty barriers of each K and each V stage
  static constexpr int n_bars = 1 + 4 * STAGES;
  // 1024 bytes of slack: the tiles start on a 1024-byte boundary
  static constexpr int bytes = 1024 + bar_off + 8 * n_bars;
};

// One block a query tile (BQ rows of one head). Q, K and V arrive through
// 3-D tensor maps (D, S, heads) whose 128-byte swizzled boxes of 64
// columns are the atoms of tc::Swz<D>; rows past S read zeros. The
// consumers take turns issuing their wgmma (named barriers 1 .. NC), so
// one's softmax runs under the others' products.
template <int D>
__global__ void __launch_bounds__(WsTiles<D>::THREADS, 1)
attn_ws_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, int Sq, int Skv,
               int kv_repeat, int causal, int window, float softcap,
               int q_offset, float scale) {
  using T = WsTiles<D>;
  using S = tc::Swz<D>;
  constexpr int KV = T::KV, ST = T::STAGES, NC = T::NC, BQ = T::BQ;
  constexpr int NS = KV / 8, NO = D / 8, NA = D / 64;
  extern __shared__ unsigned char smem_ws[];
  unsigned char* sQ =
      smem_ws + ((1024 - (tc::smem_u32(smem_ws) & 1023)) & 1023);
  unsigned char* sK = sQ + T::q_bytes;        // [ST][kv_bytes]
  unsigned char* sV = sK + ST * T::kv_bytes;  // [ST][kv_bytes]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sQ + T::bar_off);
  uint64_t* full_k = full_q + 1;              // [ST] each
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;

  // causal tiles near the end do the most work: hand them out first
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, Sq - q0);
  const int n_cons = (nq + 63) / 64;  // a consumer with no rows exits
  // kv tiles holding a visible pair for some row of the tile
  const int qlo = q_offset + q0, qhi = qlo + nq - 1;
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(kv_end, qhi + 1);
  if (window > 0) kv_begin = max(0, qlo - window + 1);
  const int t_begin = kv_begin / KV;
  const int n_t = kv_end > kv_begin ? (kv_end + KV - 1) / KV - t_begin : 0;

  if (threadIdx.x == 0) {
    tc::mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      tc::mbar_init(full_k + s, 1);
      tc::mbar_init(full_v + s, 1);
      tc::mbar_init(empty_k + s, 4 * n_cons);  // lane 0 of each warp
      tc::mbar_init(empty_v + s, 4 * n_cons);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring's TMA loads in flight
    tc::setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tc::mbar_expect_tx(full_q, T::q_bytes);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tc::tma_load_3d(sQ + a * BQ * 128, &tq, full_q, a * 64, q0, bh);
      const int bkv = bh / kv_repeat;
      for (int i = 0; i < n_t; ++i) {
        const int s = i % ST;
        const uint32_t ph = (i / ST) & 1;
        const int k0 = (t_begin + i) * KV;
        tc::mbar_wait(empty_k + s, ph ^ 1);
        tc::mbar_expect_tx(full_k + s, T::kv_bytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tc::tma_load_3d(sK + s * T::kv_bytes + a * KV * 128, &tk,
                          full_k + s, a * 64, k0, bkv);
        tc::mbar_wait(empty_v + s, ph ^ 1);
        tc::mbar_expect_tx(full_v + s, T::kv_bytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tc::tma_load_3d(sV + s * T::kv_bytes + a * KV * 128, &tv,
                          full_v + s, a * 64, k0, bkv);
      }
    }
  } else {
    // consumer cw: query rows [64 cw, 64 cw + 64) of the tile
    tc::setmaxnreg_inc<T::CONSUMER_REGS>();
    const int cw = wg - 1;
    if (cw >= n_cons) return;
    const bool pp = n_cons == NC;  // take turns when all consumers run
    const int next = 1 + (cw + 1) % NC;  // the consumer that issues next
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int rlo = qlo + 64 * cw, rhi = rlo + 63;
    const int qpos0 = rlo + warp * 16 + g;
    const unsigned char* sQc = sQ + cw * 64 * 128;
    // the scale folded into the base-2 constants; mul takes a score to
    // log2 units (softcapped scores are in them already)
    const float k2 = softcap > 0.f ? 2.f * LOG2E * scale / softcap : 0.f;
    const float cl = softcap * LOG2E, cl2 = 2.f * cl;
    const float mul = softcap > 0.f ? 1.f : scale * LOG2E;

    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float s[NS][4];
    uint32_t pa[KV / 16][4];
    uint32_t qa[T::Q_REGS ? D / 16 : 1][4];

    // S = Q K^T into s (scale-d 0 at the first k-step): issued, not
    // waited for
    auto issue_s = [&](int stage) {
      tc::fence_regs(s);
      tc::fence_regs(acc);
      tc::wgmma_fence();
      const unsigned char* sKt = sK + stage * T::kv_bytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (T::Q_REGS)
          tc::wgmma_rs<KV>(s, qa[kk], S::template kmajor<KV>(sKt, kk),
                           kk > 0);
        else
          tc::wgmma_ss<KV, 0, 0>(s, S::template kmajor<BQ>(sQc, kk),
                                 S::template kmajor<KV>(sKt, kk), kk > 0);
      }
      tc::wgmma_commit();
    };
    // O += P V, P from registers: issued, not waited for
    auto issue_pv = [&](int stage) {
      const unsigned char* sVt = sV + stage * T::kv_bytes;
#pragma unroll
      for (int kk = 0; kk < KV / 16; ++kk)
        tc::wgmma_rs_t<D>(acc, pa[kk],
                          S::template mnmajor<KV>(sVt, kk));
      tc::wgmma_commit();
    };
    // the online softmax of kv tile t (its scores in s): s becomes p,
    // and alpha the factor that moves O from the old running max to
    // the new. Scores stay in the units of s (raw, or softcapped in log2
    // units), and m with them; 2^(s mul - m mul) is one FFMA and one ex2.
    auto softmax = [&](int t) {
      const int k0 = t * KV;
      const int nk = min(KV, Skv - k0);
      const bool whole = nk == KV && (!causal || k0 + KV - 1 <= rlo) &&
                         (window <= 0 || rhi - k0 < window);
      if (softcap > 0.f) {
        // c tanh(s/c) log2(e) = cl - 2 cl / (2^(s k2) + 1)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = cl - __fdividef(cl2, tc::ex2(s[n][e] * k2) + 1.f);
      }
      if (!whole) {
        // row r sees the tile's columns [lo, hi); keys past Skv get
        // -inf, so that they weigh exactly 0 even in a row with no
        // visible key so far, whose masked keys weigh 2^0 as in the
        // plain version
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qpos = qpos0 + 8 * r;
          hi[r] = causal ? qpos - k0 + 1 : KV;
          lo[r] = window > 0 ? qpos - window + 1 - k0 : 0;
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + 2 * t4 + (e & 1), r = e >> 1;
            s[n][e] = col >= nk ? -INFINITY
                      : col >= lo[r] && col < hi[r] ? s[n][e]
                                                    : NEG_INF;
          }
      }
      float mx[2] = {NEG_INF, NEG_INF}, mm[2];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = tc::ex2((m[r] - m_new) * mul);
        m[r] = m_new;
        mm[r] = m_new * mul;
        l[r] *= alpha[r];
      }
      if (whole) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = tc::ex2(fmaf(s[n][e], mul, -mm[e >> 1]));
      } else {
        // unfused: a masked score in a row with no visible key so far
        // gives 2^0 exactly, where an FMA's unrounded product would
        // leave 2^(~1e21)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] =
                tc::ex2(__fsub_rn(__fmul_rn(s[n][e], mul), mm[e >> 1]));
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += s[n][e];
    };
    // p rounded to bf16 as wgmma's register A operand
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < KV / 16; ++kk) {
        pa[kk][0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    };

    tc::mbar_wait(full_q, 0);
    if constexpr (T::Q_REGS) {
      // this warp's 16 rows, k-step kk: lanes 0-15 name rows 0-15 at
      // column 16 kk, lanes 16-31 the same rows at column 16 kk + 8
      const int row = 64 * cw + warp * 16 + lane % 16;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int chunk = (kk % 4) * 2 + lane / 16;
        tc::ldmatrix_x4(qa[kk], sQ + (kk / 4) * BQ * 128 + row * 128 +
                                    ((chunk ^ (row % 8)) * 16));
      }
    }
    if (n_t > 0) {
      if (pp && cw == NC - 1) tc::bar_arrive(1, 256);  // consumer 0 first
      tc::mbar_wait(full_k, 0);
      if (pp) tc::bar_sync(1 + cw, 256);
      issue_s(0);
      if (pp) tc::bar_arrive(next, 256);
      tc::wgmma_wait<0>();
      tc::fence_regs(s);
      if (lane == 0) tc::mbar_arrive(empty_k);
      softmax(t_begin);
      pack();
      // step i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} together and
      // runs the softmax of S_i while the second product is in flight
      for (int i = 1; i < n_t; ++i) {
        const int st = i % ST, sp = (i - 1) % ST;
        tc::mbar_wait(full_k + st, (i / ST) & 1);
        tc::mbar_wait(full_v + sp, ((i - 1) / ST) & 1);
        if (pp) tc::bar_sync(1 + cw, 256);
        issue_s(st);
        issue_pv(sp);
        if (pp) tc::bar_arrive(next, 256);
        tc::wgmma_wait<1>();
        tc::fence_regs(s);
        if (lane == 0) tc::mbar_arrive(empty_k + st);
        softmax(t_begin + i);
        tc::wgmma_wait<0>();
        tc::fence_regs(acc);
        tc::fence_regs(pa);
        if (lane == 0) tc::mbar_arrive(empty_v + sp);
        // O moves to the new running max once P_{i-1} V_{i-1} has landed
        // in it; skipped when the max did not move in this warp
        if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
          }
        }
        pack();
      }
      const int sp = (n_t - 1) % ST;
      tc::mbar_wait(full_v + sp, ((n_t - 1) / ST) & 1);
      if (pp) tc::bar_sync(1 + cw, 256);
      tc::fence_regs(acc);
      tc::wgmma_fence();
      issue_pv(sp);
      if (pp) tc::bar_arrive(next, 256);
      tc::wgmma_wait<0>();
      tc::fence_regs(acc);
      if (lane == 0) tc::mbar_arrive(empty_v + sp);
      if (pp && cw == 0) tc::bar_sync(1, 256);  // the last consumer's last
    }

    // O / l, rounded to bf16, into this consumer's Q rows (its last S has
    // landed) in the same swizzled atoms, then out by TMA; rows past Sq
    // are past the map's extent and not written
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    unsigned char* sO = sQ + cw * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(sO + (n / 8) * BQ * 128 + row * 128 +
                                     ((n % 8) ^ (row % 8)) * 16 + 4 * t4) =
            tc::pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
    tc::fence_proxy_async();
    tc::bar_sync(1 + NC + cw, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tc::tma_store_3d(&to, sO + a * BQ * 128, a * 64, q0 + 64 * cw, bh);
      tc::tma_store_wait();
    }
  }
}

int set_smem(const void* kern, int bytes) {
  return int(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

constexpr int ERR_TMA = -2;

// a bf16 (heads, rows, D) tensor as a 3-D map read in 128-byte swizzled
// boxes of 64 columns by `box_rows` rows of one head
bool tensor_map(CUtensorMap* map, const void* base, int D, int rows,
                int heads, int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2,
                                 cuuint64_t(rows) * cuuint64_t(D) * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  return tma::bf16_map(map, base, 3, dims, strides, box, 128);
}

template <int D>
int launch_ws(const void* q, const void* k, const void* v, void* o, int BH,
              int Sq, int Skv, int kv_repeat, int causal, int window,
              float softcap, int q_offset, float scale, cudaStream_t stream) {
  using T = WsTiles<D>;
  if (Skv == 0)  // no key: every output row is 0, as in the other kernels
    return int(cudaMemsetAsync(o, 0, size_t(BH) * Sq * D * 2, stream));
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, D, Sq, BH, T::BQ) ||
      !tensor_map(&tk, k, D, Skv, BH / kv_repeat, T::KV) ||
      !tensor_map(&tv, v, D, Skv, BH / kv_repeat, T::KV) ||
      !tensor_map(&to, o, D, Sq, BH, 64))
    return ERR_TMA;
  const void* kern = reinterpret_cast<const void*>(attn_ws_kernel<D>);
  if (int err = set_smem(kern, T::bytes)) return err;
  const dim3 grid((Sq + T::BQ - 1) / T::BQ, BH);
  attn_ws_kernel<D><<<grid, T::THREADS, T::bytes, stream>>>(
      tq, tk, tv, to, Sq, Skv, kv_repeat, causal, window, softcap, q_offset,
      scale);
  return int(cudaGetLastError());
}

// dynamic shared memory a block of the bf16 kernel at head dim D
template <int D>
constexpr int bf16_smem_bytes() {
  if constexpr (D >= 64)
    return WsTiles<D>::bytes;
  else
    return Tiles<D>::bytes;
}

// bf16 by D: the warp-specialised kernel where a row is whole 128-byte
// swizzle atoms (D >= 64), the one-warpgroup kernel below
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int BH, int Sq, int Skv, int kv_repeat, int causal, int window,
           float softcap, int q_offset, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int bytes = Layout<D>::bytes;
    if (int err = set_smem(reinterpret_cast<const void*>(attn_f32_kernel<D>),
                           bytes))
      return err;
    const dim3 grid((Sq + BQ - 1) / BQ, BH);
    attn_f32_kernel<D><<<grid, NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv,
        kv_repeat, causal, window, softcap, q_offset, scale);
  } else if constexpr (D >= 64) {
    return launch_ws<D>(q, k, v, o, BH, Sq, Skv, kv_repeat, causal, window,
                        softcap, q_offset, scale, stream);
  } else {
    constexpr int bytes = Tiles<D>::bytes;
    if (int err = set_smem(
            reinterpret_cast<const void*>(attn_bf16_kernel<D>), bytes))
      return err;
    const dim3 grid((Sq + 63) / 64, BH);
    attn_bf16_kernel<D><<<grid, TNT, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), Sq, Skv, kv_repeat, causal, window,
        softcap, q_offset, scale);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, -1
// for an unsupported head dim, or -2 if a TMA descriptor could not be made.
// dtype: 0 = float32, 1 = bfloat16.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int BH, int Sq, int Skv, int D,
                        int kv_repeat, int causal, int window, float softcap,
                        int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define FA_CASE(d)                                                         \
  case d:                                                                  \
    return launch<d>(dtype, q, k, v, o, BH, Sq, Skv, kv_repeat, causal,    \
                     window, softcap, q_offset, scale, s);
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(192)
    FA_CASE(256)
#undef FA_CASE
    default:
      return -1;
  }
}

// the bf16 kernel's dynamic shared memory a block at head dim D, or -1
int flash_attention_bf16_smem(int D) {
  switch (D) {
#define FA_CASE(d) \
  case d:          \
    return bf16_smem_bytes<d>();
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(192)
    FA_CASE(256)
#undef FA_CASE
    default:
      return -1;
  }
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "unsupported head dim (16, 32, 64, 128, 192 or 256)";
  if (code == ERR_TMA) return "cuTensorMapEncodeTiled refused a TMA map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
