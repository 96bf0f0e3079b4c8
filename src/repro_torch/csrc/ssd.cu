// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py::_ssd_kernel
// launched by ssd_flat. Same function, per flat head b (one (batch, head)
// pair) from a zero state, over chunks of Q rows (the wrapper picks Q with
// the reference's rule, so the chunk boundaries and hence every cum and
// decay are the same numbers):
//   cum   = inclusive cumsum of dt * A within the chunk          (f32)
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j    intra-chunk
//         + exp(cum_i) (C_i h)                                    inter-chunk
//   h    <- exp(cum_Q) h + sum_j (B_j exp(cum_Q - cum_j) dt_j)^T x_j
// x (BH, S, P), B and C (BH, S, N) in x's dtype (f32 or bf16), dt (BH, S)
// and A (BH,) in f32; y (BH, S, P) in x's dtype (rounded to nearest even),
// hT (BH, N, P) f32. Every product is taken on f32 values and summed in
// f32; a product of widened bf16 values is exact in f32, as on the TPU.
//
// What bounds it on this card: at the mamba2-2.7b prefill shape (BH = 320,
// S = 8192, Q = 256, N = 128, P = 64, bf16) the kernel must read x, the
// per-head B and C, dt and A and write y and hT, ~2.03 GB, i.e. ~0.61 ms at
// 3.35 TB/s; its ~344 GFLOP take ~0.35 ms at the bf16 tensor-core rate. So
// bytes bound it.
//
// What this design does (the simple, right-first version):
//   * The TPU kernel carries h (N, P) in VMEM scratch along the sequential
//     chunk axis of its grid. Hopper blocks run in no order, so one block
//     of 256 threads takes one flat head and loops over its chunks itself,
//     keeping h (128 x 64 f32 = 32 KB at the model's shape) in shared
//     memory, and writes hT after the last chunk. BH = 320 blocks fill the
//     132 SMs in about 2.4 waves (two blocks fit on an SM in bf16).
//   * A whole chunk does not fit as f32 tiles (C and B of 256 x 128 f32 are
//     128 KB each, the 256 x 256 score matrix 256 KB, of the 227 KB a block
//     may use). So the chunk is cut into 64-row query tiles; each streams
//     the 64-row key tiles at or below its diagonal. C, B and x tiles stay
//     in shared memory in x's dtype and are widened on read; only the
//     64 x 64 masked score tile is f32. The last query tile sees every key
//     tile of the chunk, and folds the state update into the same pass.
//   * Above the diagonal exp(cum_i - cum_j) is exp of a positive number and
//     overflows f32 to inf for large |A| dt; the reference removes it with
//     `where`. Here the entry is selected to 0 and exp is never evaluated
//     there (inf * 0 would be NaN).
//   * Rows of a ragged last tile (Q not a multiple of 64, e.g. Q = 200 or
//     Q = 1 for an odd S) are zero-filled in shared memory and never stored.
// Both products run as f32 FMAs on the CUDA cores; reading B and C once per
// group instead of per head, a chunk-parallel schedule and tensor cores are
// the later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TR = 64;        // rows of a query tile and of a key tile
constexpr int NT = 256;       // threads per block, a 16 x 16 grid (ty, tx)
constexpr int RT = TR / 16;   // tile rows (and score columns) per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E>
__device__ __forceinline__ E zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Shared memory of one block, in bytes from the start: the state, the
// masked score tile, the C, B and x tiles in x's dtype, then cum and dt of
// the chunk (Q floats each).
template <typename E, int N, int P>
struct Layout {
  static constexpr int NS = N + int(4 / sizeof(E));  // sC/sB row stride:
                                                     // one word of padding
  static constexpr int MS = TR + 1;                  // sM row stride
  static constexpr size_t h_off = 0;
  static constexpr size_t m_off = h_off + size_t(N) * P * sizeof(float);
  static constexpr size_t c_off = m_off + size_t(TR) * MS * sizeof(float);
  static constexpr size_t b_off = c_off + size_t(TR) * NS * sizeof(E);
  static constexpr size_t x_off = b_off + size_t(TR) * NS * sizeof(E);
  static constexpr size_t cum_off = x_off + size_t(TR) * P * sizeof(E);
  static size_t bytes(int Q) { return cum_off + 2 * size_t(Q) * sizeof(float); }
};

// rows [0, rows) of a (.., W) row-major source into a TR-row tile of row
// stride `stride`; the rows past `rows` are zero-filled
template <typename E, int W>
__device__ __forceinline__ void load_tile(E* dst, int stride,
                                          const E* __restrict__ src,
                                          int rows) {
  for (int e = threadIdx.x; e < TR * W; e += NT) {
    const int r = e / W, col = e % W;
    dst[r * stride + col] = r < rows ? src[size_t(r) * W + col] : zero<E>();
  }
}

template <typename E, int N, int P>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const E* __restrict__ Bm,
               const E* __restrict__ Cm, E* __restrict__ y,
               float* __restrict__ hT, int S, int Q) {
  using L = Layout<E, N, P>;
  constexpr int NA = N / 16;  // state rows per thread: ty + 16 * a
  constexpr int PB = P / 16;  // state / output columns per thread: tx + 16 * b
  extern __shared__ __align__(16) unsigned char smem[];
  float* sH = reinterpret_cast<float*>(smem + L::h_off);
  float* sM = reinterpret_cast<float*>(smem + L::m_off);
  E* sC = reinterpret_cast<E*>(smem + L::c_off);
  E* sB = reinterpret_cast<E*>(smem + L::b_off);
  E* sX = reinterpret_cast<E*>(smem + L::x_off);
  float* sCum = reinterpret_cast<float*>(smem + L::cum_off);
  float* sDt = sCum + Q;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t bh = blockIdx.x;
  const E* xb = x + bh * S * P;
  const E* Bb = Bm + bh * S * N;
  const E* Cb = Cm + bh * S * N;
  const float* dtb = dt + bh * S;
  E* yb = y + bh * S * P;
  const float a_h = A[bh];

  for (int e = tid; e < N * P; e += NT) sH[e] = 0.f;

  const int n_chunks = S / Q;
  const int n_tiles = (Q + TR - 1) / TR;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t s0 = size_t(c) * Q;
    __syncthreads();  // the previous chunk is done with sH, sCum, sDt
    for (int i = tid; i < Q; i += NT) sDt[i] = dtb[s0 + i];
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += sDt[i] * a_h;
        sCum[i] = run;
      }
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int i0 = qt * TR;
      const bool last = qt == n_tiles - 1;
      load_tile<E, N>(sC, L::NS, Cb + (s0 + i0) * N, min(TR, Q - i0));
      __syncthreads();

      // inter-chunk: acc = exp(cum_i) * (C_i h)
      float acc[RT][PB];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int b = 0; b < PB; ++b) acc[r][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RT], hv[PB];
#pragma unroll
        for (int r = 0; r < RT; ++r) cv[r] = to_f32(sC[(ty + 16 * r) * L::NS + n]);
#pragma unroll
        for (int b = 0; b < PB; ++b) hv[b] = sH[n * P + tx + 16 * b];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int b = 0; b < PB; ++b) acc[r][b] += cv[r] * hv[b];
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + ty + 16 * r;
        const float g = i < Q ? expf(sCum[i]) : 0.f;
#pragma unroll
        for (int b = 0; b < PB; ++b) acc[r][b] *= g;
      }

      // the last query tile also carries the state to the next chunk:
      // hacc = exp(cum_Q) h + sum over the chunk's key rows (below)
      float hacc[NA][PB];
      if (last) {
        const float g = expf(cum_last);
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int b = 0; b < PB; ++b)
            hacc[a][b] = g * sH[(ty + 16 * a) * P + tx + 16 * b];
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * TR;
        const int nk = min(TR, Q - j0);
        __syncthreads();  // readers of the previous sB, sX, sM (and sH) done
        load_tile<E, N>(sB, L::NS, Bb + (s0 + j0) * N, nk);
        load_tile<E, P>(sX, P, xb + (s0 + j0) * P, nk);
        __syncthreads();

        // intra-chunk scores, masked by selection and weighted: sM
        float s[RT][RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int k = 0; k < RT; ++k) s[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RT], bv[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            cv[r] = to_f32(sC[(ty + 16 * r) * L::NS + n]);
            bv[r] = to_f32(sB[(tx + 16 * r) * L::NS + n]);
          }
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int k = 0; k < RT; ++k) s[r][k] += cv[r] * bv[k];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const int j = j0 + tx + 16 * k;
            sM[(ty + 16 * r) * L::MS + tx + 16 * k] =
                (i < Q && j <= i)
                    ? s[r][k] * expf(sCum[i] - sCum[j]) * sDt[j]
                    : 0.f;
          }
        }
        __syncthreads();

        // acc += M x
        for (int j = 0; j < nk; ++j) {
          float mv[RT], xv[PB];
#pragma unroll
          for (int r = 0; r < RT; ++r) mv[r] = sM[(ty + 16 * r) * L::MS + j];
#pragma unroll
          for (int b = 0; b < PB; ++b) xv[b] = to_f32(sX[j * P + tx + 16 * b]);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int b = 0; b < PB; ++b) acc[r][b] += mv[r] * xv[b];
        }

        // state update: hacc += (B exp(cum_Q - cum) dt)^T x over this tile
        if (last) {
          for (int j = 0; j < nk; ++j) {
            const float w = expf(cum_last - sCum[j0 + j]) * sDt[j0 + j];
            float bv[NA], xv[PB];
#pragma unroll
            for (int a = 0; a < NA; ++a)
              bv[a] = to_f32(sB[j * L::NS + ty + 16 * a]) * w;
#pragma unroll
            for (int b = 0; b < PB; ++b) xv[b] = to_f32(sX[j * P + tx + 16 * b]);
#pragma unroll
            for (int a = 0; a < NA; ++a)
#pragma unroll
              for (int b = 0; b < PB; ++b) hacc[a][b] += bv[a] * xv[b];
          }
        }
      }

#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < Q) {
#pragma unroll
          for (int b = 0; b < PB; ++b)
            store(&yb[(s0 + i) * P + tx + 16 * b], acc[r][b]);
        }
      }
      // every thread read sH (inter-chunk term) before the first key
      // tile's barrier, so the owners may overwrite it now
      if (last) {
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int b = 0; b < PB; ++b)
            sH[(ty + 16 * a) * P + tx + 16 * b] = hacc[a][b];
      }
    }
  }
  __syncthreads();
  float* hb = hT + bh * N * P;
  for (int e = tid; e < N * P; e += NT) hb[e] = sH[e];
}

template <typename E, int N, int P>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* hT, int BH, int S, int Q,
           cudaStream_t stream) {
  const size_t smem = Layout<E, N, P>::bytes(Q);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > size_t(limit)) return -2;
  auto kern = ssd_fwd_kernel<E, N, P>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<BH, NT, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const E*>(Bm),
      static_cast<const E*>(Cm), static_cast<E*>(y), static_cast<float*>(hT),
      S, Q);
  return int(cudaGetLastError());
}

template <typename E, int N>
int dispatch_p(int P, const void* x, const void* dt, const void* A,
               const void* Bm, const void* Cm, void* y, void* hT, int BH,
               int S, int Q, cudaStream_t stream) {
  switch (P) {
    case 16: return launch<E, N, 16>(x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    case 32: return launch<E, N, 32>(x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    case 64: return launch<E, N, 64>(x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    case 128: return launch<E, N, 128>(x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    default: return -1;
  }
}

template <typename E>
int dispatch(int N, int P, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, void* y, void* hT, int BH, int S,
             int Q, cudaStream_t stream) {
  switch (N) {
    case 16: return dispatch_p<E, 16>(P, x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    case 32: return dispatch_p<E, 32>(P, x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    case 64: return dispatch_p<E, 64>(P, x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    case 128: return dispatch_p<E, 128>(P, x, dt, A, Bm, Cm, y, hT, BH, S, Q, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, -1
// for an unsupported N or P, or -2 when a chunk of Q rows needs more shared
// memory than a block may have. dtype: 0 = float32, 1 = bfloat16. S must
// be a multiple of Q.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, void* y, void* hT, int dtype, int BH, int S,
            int Q, int N, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(N, P, x, dt, A, Bm, Cm, y, hT, BH, S, Q, s);
  return dispatch<__nv_bfloat16>(N, P, x, dt, A, Bm, Cm, y, hT, BH, S, Q, s);
}

const char* ssd_error_string(int code) {
  if (code == -1) return "unsupported N or P (16, 32, 64 or 128)";
  if (code == -2) return "chunk too long for the block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
