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
// What bounds it on this card: at the serving shape (D = 256, Sq = Skv =
// 5120, causal) each visible (q, k) pair costs 4*D flops against ~D*2
// bytes of k/v that every query tile re-reads, so attention is
// compute-bound: the bf16 tensor-core bound is ~0.43 ms per gemma2-2b
// layer, the byte bound ~0.08 ms.
//
// bf16 (the serving path), attn_bf16_kernel:
//   * one warpgroup (4 warps, 16 query rows each) per (flat query head,
//     64-row query tile). Q, K and V stay bf16 in shared memory, in the
//     128-byte swizzled layout wgmma reads (64- or 32-byte rows for D = 32
//     or 16; mma.cuh), which 16-byte cp.async writes without bank
//     conflicts.
//   * S = Q K^T (Q and K from shared memory) and O += P V (P from
//     registers, V read N-major from the same tile layout, so nothing is
//     transposed by hand) run on the tensor cores as wgmma, bf16 in and
//     f32 accumulate. The online softmax (m, l) stays in registers, its
//     row max reduced over each quad of lanes with shuffles; P is rounded
//     to bf16 in registers and fed back as the A operand.
//   * K/V tiles arrive through a ring of two stages: the next tile loads
//     while this one computes.
//   * Tiles with no visible pair are never loaded (the causal diagonal, the
//     window start). Masks run only on tiles that cut the diagonal, the
//     window edge or a ragged Skv; wholly visible tiles skip them.
//   * The softmax runs in base 2 with the scale folded into its constants.
//     Softcap 50 multiplies tanh's error by 50, so c tanh(s / c) is
//     c - 2c / (exp(2s / c) + 1) with the ex2 and rcp units (~1e-7 in
//     tanh), not tanh.approx (~2^-11). The 16 x D accumulator is rescaled
//     only when a warp's running max moved.
//   * D = 256: O is 64 x 256 f32, 128 registers a thread; the kv tile is
//     32 keys there (64 below), so nothing spills and two blocks (96 KB of
//     shared memory each) fit an SM.
//   * D = 192 (MLA prefill: qk_nope 128 + qk_rope 64), the one width that
//     is not a power of two: a row is three 128-byte swizzle atoms, O is
//     64 x 192 f32 (96 registers a thread, one m64n192k16 wgmma a k-step
//     of P V), and the kv tile is 64 keys: 24 KB of Q plus two stages of
//     24 KB K and V tiles, 120 KB, one block an SM.
// float32 (the reduced models' exact-token checks, which TF32 would miss)
// keeps the CUDA-core design, attn_f32_kernel: 256 threads per 64-row
// query tile, f32 tiles in shared memory, 4 x 4 register micro-tiles of
// f32 FMAs.
//
// Ragged lengths: any Sq/Skv. Query rows past Sq are computed on zeros and
// not stored; keys past Skv get p = 0 exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma.cuh"

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
  static constexpr int KV = D >= 256 ? 32 : 64;   // keys per kv tile
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

int set_smem(const void* kern, int bytes) {
  return int(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

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

// Returns 0 on success, a cudaError_t code if the launch was refused, or
// -1 for an unsupported head dim. dtype: 0 = float32, 1 = bfloat16.
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

const char* flash_attention_error_string(int code) {
  if (code == -1) return "unsupported head dim (16, 32, 64, 128, 192 or 256)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
