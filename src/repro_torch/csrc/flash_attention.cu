// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_attn_kernel
// launched by flash_attention_flat. Same function: online-softmax attention
// over flat heads, q (BHq, Sq, D), k/v (BHkv, Skv, D), query head b reading
// kv head b / kv_repeat; scale 1/sqrt(D), then optional softcap
// c*tanh(s/c), then causal and sliding-window masks at absolute query
// positions q_offset + i, masked scores the finite -1e30, l clamped at
// 1e-30, f32 accumulation and the output in the inputs' dtype.
//
// What bounds it on this card: at the serving shape (D = 256, Sq = Skv =
// 5120, causal) each (q, k) pair costs 4*D flops against ~D*2 bytes of
// k/v that every query tile re-reads, so attention is compute-bound: the
// bf16 tensor-core bound is ~0.43 ms per gemma2-2b layer, the byte bound
// ~0.08 ms.
//
// What this design does about it (the simple, right-first version):
//   * one block of 256 threads per (flat query head, 64-row query tile);
//     a loop over 64-row kv tiles inside the block replaces the TPU grid's
//     sequential third axis, with running m, l and acc kept in registers;
//   * the kv-tile range is cut to the tiles that hold a visible (q, k)
//     pair (causal diagonal, window start), as the TPU kernel skips them;
//   * tiles are widened to f32 in shared memory (dynamic, up to ~209 KB at
//     D = 256) with rows padded by one word so the k reads are free of bank
//     conflicts; both products run as f32 FMAs on the CUDA cores, each
//     thread owning a 4 x 4 score micro-tile and a 4 x D/16 slice of acc.
// It therefore runs at the CUDA-core f32 rate, far below the tensor-core
// bound; wgmma, TMA loads and pipelining are the later, faster version.
//
// Ragged lengths: any Sq/Skv. Query rows past Sq are computed on zeros and
// not stored; keys past Skv get p = 0 exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per kv tile
constexpr int NT = 256;   // threads per block, a 16 x 16 grid (ty, tx)
constexpr int RQ = BQ / 16;   // query rows per thread: ty + 16 * i
constexpr int CK = BKV / 16;  // score columns per thread: tx + 16 * j
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

template <int D>
struct Layout {
  static constexpr int QS = D + 1;    // padded row stride of sQ (f32 words)
  static constexpr int KS = D + 1;    // ... of sK
  static constexpr int PS = BKV + 1;  // ... of sP
  static constexpr int bytes =
      (BQ * QS + BKV * KS + BKV * D + BQ * PS) * int(sizeof(float));
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                int kv_repeat, int causal, int window, float softcap,
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

  const T* qg = q + ((size_t)bh * Sq + q0) * D;
  const T* kg = k + (size_t)(bh / kv_repeat) * Skv * D;
  const T* vg = v + (size_t)(bh / kv_repeat) * Skv * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sQ[r * L::QS + c] = r < nq ? to_f32(qg[(size_t)r * D + c]) : 0.f;
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
      sK[r * L::KS + c] = in ? to_f32(kg[(size_t)(k0 + r) * D + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(vg[(size_t)(k0 + r) * D + c]) : 0.f;
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

  T* og = o + ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CD; ++c)
        store(&og[(size_t)r * D + tx + 16 * c], acc[i][c] / lc);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int kv_repeat, int causal, int window,
           float softcap, int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  attn_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, kv_repeat,
      causal, window, softcap, q_offset, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int BH, int Sq, int Skv, int kv_repeat, int causal, int window,
             float softcap, int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
#define FA_CASE(d)                                                        \
  case d:                                                                 \
    return launch<T, d>(q, k, v, o, BH, Sq, Skv, kv_repeat, causal,       \
                        window, softcap, q_offset, scale, stream);
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
#undef FA_CASE
    default:
      return -1;
  }
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
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, BH, Sq, Skv, kv_repeat, causal,
                           window, softcap, q_offset, scale, s);
  return dispatch<__nv_bfloat16>(D, q, k, v, o, BH, Sq, Skv, kv_repeat,
                                 causal, window, softcap, q_offset, scale, s);
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "unsupported head dim (16, 32, 64, 128 or 256)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
