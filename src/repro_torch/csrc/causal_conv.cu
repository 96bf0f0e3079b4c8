// The Mamba-2 mixer's causal depthwise conv with its SiLU, forward and
// backward, for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no TPU kernel: the JAX package computes this stage in plain jnp
// (src/repro/models/mamba2.py: ``causal_conv``, then the SiLU), as the port
// did in eager PyTorch until this kernel (a cat, a pad, K tap products
// summed tap by tap, the bias, the SiLU: a pass over the rows each). Per
// channel c of a sequence x (S, C), with taps w (K, C) and bias b (C,)
// rounded to x's dtype as the plain path rounds them, and x[t] = 0 for
// t < 0 (each sequence of a batch starts from zeros):
//   p[t] = b + sum_k w[k] x[t - (K - 1) + k],   y[t] = p[t] sigmoid(p[t])
// and from dy, with g[t] = dy[t] silu'(p[t]) (g[t] = 0 for t >= S):
//   dx[t] = sum_k w[k] g[t + (K - 1) - k],
//   dw[k] = sum over the rows of g[t] x[t - (K - 1) + k],  db = sum of g.
// All arithmetic in f32, one rounding at each output (the plain bf16 path
// rounds after each tap product, each add, the bias and the SiLU).
// kernels/causal_conv/ref.py holds the plain expression and this backward
// in closed form.
//
// What bounds it on this card: bytes. The forward reads x and writes y (4
// bytes an element in bf16), the backward reads x and dy and writes dx (6
// bytes); 2 K + ~10 flops an element are far below the ~295 flop a byte
// where the tensor cores would bind. At mamba2-2.7b's training shape
// (16,384 rows of 5,376) that is 0.352 GB, 0.105 ms at 3.35 TB/s, forward
// and 0.528 GB, 0.158 ms, backward.
//
// Design, so that each byte crosses device memory once and enough of them
// are in flight:
//   - A tile is 64 rows of one sequence at 128 bytes of their channels (64
//     bf16 or 32 f32), with a halo of K - 1 rows (zeros before the
//     sequence) that the tile before it also reads: L2 serves it. x is read
//     in place at its batch and row strides (the mixer hands over a column
//     slice of in_proj's output); y, dy and dx are contiguous (B, S, C).
//   - One wave of resident blocks: each block walks a contiguous range of
//     the tiles down the rows at its channels, copying the next tile into
//     shared memory (cp.async, 16 bytes a copy, no registers held) while
//     it computes the current one.
//   - Each thread walks one channel down a run of the tile's rows from
//     shared memory, keeping the last K - 1 rows (and, backward, their g)
//     in registers, and writes its outputs to shared memory, which the
//     block stores to device memory in 16-byte chunks.
//   - A width, base or stride that 16-byte accesses cannot read takes the
//     same kernels with element-wise copies between device and shared
//     memory (the scalar path).
//   - The backward recomputes the K - 1 values of g past its run that its
//     last rows of dx read, so no g is shared between threads. It sums dw
//     and db in registers over the block's tiles, then over its threads in
//     a fixed order, and writes one row of f32 partials a block;
//     causal_conv_reduce_kernel sums the rows in a fixed order. No atomics:
//     a repeated call gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// Launch shapes: the fastest of those timed on the H100 at mamba2-2.7b's
// training and prefill rows (PERF.md, row CC). Five forward blocks an SM
// spread the wave unevenly over the SMs and ran 12 % slower; three
// backward blocks 25 % slower.
constexpr int TILE_BYTES = 128;  // bytes of a row's channels a tile holds
constexpr int FWD_ROWS = 64;     // rows a tile
constexpr int BWD_ROWS = 64;
constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 128;
constexpr int FWD_MINB = 4;  // forward blocks an SM holds
constexpr int BWD_MINB = 4;  // backward blocks an SM holds (the caller's grid)
constexpr int MAX_K = 4;
constexpr int RED_COLS = 32;   // columns a reduce block sums
constexpr int RED_SLICES = 8;  // slices of the rows it sums them over

enum Err { ERR_SHAPE = 1001, ERR_DTYPE = 1002 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 1 / (1 + e^-p) by the fast reciprocal (2 ulp); 0 where e^-p overflows
__device__ __forceinline__ float sigmoid(float p) {
  return __fdividef(1.f, 1.f + __expf(-p));
}

struct Args {
  const void* x;       // (B, S, C) at strides (sb, ss, 1)
  long long sb, ss;    // in elements
  const float *w, *b;  // (K, C), (C,) float32, contiguous
  const void* dy;      // backward: (B, S, C) contiguous
  void* y;             // forward: y; backward: dx; (B, S, C) contiguous
  float* part;         // backward: (gridDim.y, (K + 1) C) partials
  int B, S, C;
};

// The tile geometry for T and N threads a block: channels a tile, values
// a 16-byte chunk, chunks a tile row, runs of rows side by side (threads a
// channel).
template <typename T, int N>
struct Tile {
  static constexpr int TC = TILE_BYTES / sizeof(T);
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int CPR = TC / VE;
  static constexpr int NSEG = N / TC;
};

// One 16-byte chunk from device into shared memory, in flight until
// wait_copies; zeros where `valid` is false (then nothing is read).
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N groups of copies are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [t1, t1 + ROWS) of a sequence (rows at stride rs) at channels
// [c0, c0 + TC) into dst (shared memory, rows of TC): zeros outside rows
// [0, S) and channels [0, C). 16-byte copies in flight where VEC, else
// element by element.
template <typename T, bool VEC, int ROWS, int N>
__device__ __forceinline__ void load_tile(T* dst, const T* base,
                                          long long rs, int t1, int S,
                                          int c0, int C) {
  using G = Tile<T, N>;
  for (int i = threadIdx.x; i < ROWS * G::CPR; i += N) {
    const int r = i / G::CPR, cc = i % G::CPR * G::VE;
    const int t = t1 + r, c = c0 + cc;
    const bool row = t >= 0 && t < S;
    if constexpr (VEC) {
      const bool ok = row && c < C;
      copy_async(dst + r * G::TC + cc, ok ? base + t * rs + c : base, ok);
    } else {
#pragma unroll
      for (int e = 0; e < G::VE; ++e)
        dst[r * G::TC + cc + e] =
            row && c + e < C ? base[t * rs + c + e] : from_f<T>(0.f);
    }
  }
}

// src (shared memory, rows of TC) into rows [t1, t1 + ROWS) at channels
// [c0, c0 + TC), those in rows [0, S) and channels [0, C).
template <typename T, bool VEC, int ROWS, int N>
__device__ __forceinline__ void store_tile(T* base, long long rs, int t1,
                                           int S, int c0, int C,
                                           const T* src) {
  using G = Tile<T, N>;
  for (int i = threadIdx.x; i < ROWS * G::CPR; i += N) {
    const int r = i / G::CPR, cc = i % G::CPR * G::VE;
    const int t = t1 + r, c = c0 + cc;
    if (t >= S) continue;
    if constexpr (VEC) {
      if (c < C)
        *reinterpret_cast<uint4*>(base + t * rs + c) =
            *reinterpret_cast<const uint4*>(src + r * G::TC + cc);
    } else {
#pragma unroll
      for (int e = 0; e < G::VE; ++e)
        if (c + e < C) base[t * rs + c + e] = src[r * G::TC + cc + e];
    }
  }
}

// This block's tiles of the n tiles down the rows: a contiguous range, so
// that the halo rows of a tile are those the block read last.
__device__ __forceinline__ void tile_range(int n, int& i0, int& i1) {
  i0 = (long long)blockIdx.y * n / gridDim.y;
  i1 = (long long)(blockIdx.y + 1) * n / gridDim.y;
}

// Channel c's taps and bias, rounded to T as the plain path rounds them.
template <typename T, int K>
__device__ __forceinline__ void taps(const Args& a, int c, float (&w)[K],
                                     float& bias) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    w[k] = to_f<T>(from_f<T>(__ldg(a.w + (long long)k * a.C + c)));
  bias = to_f<T>(from_f<T>(__ldg(a.b + c)));
}

// p = b + sum_k w[k] win[k], win[k] the row (K - 1) - k above the last
template <int K>
__device__ __forceinline__ float pre(const float (&w)[K], float bias,
                                     const float (&win)[K]) {
  float p = bias;
#pragma unroll
  for (int k = 0; k < K; ++k) p = fmaf(w[k], win[k], p);
  return p;
}

template <int K>
__device__ __forceinline__ void shift(float (&win)[K]) {
#pragma unroll
  for (int k = 0; k + 1 < K; ++k) win[k] = win[k + 1];
}

// Each block walks its range of tiles (B ntile of them down the rows, at
// the block's channels), the next tile's copies in flight while it computes
// the current one.
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MINB)
    causal_conv_fwd_kernel(Args a, int ntile) {
  using G = Tile<T, FWD_THREADS>;
  constexpr int TC = G::TC;
  constexpr int LPT = FWD_ROWS / G::NSEG;  // rows a thread computes
  constexpr int XR = FWD_ROWS + K - 1;     // rows of x a tile reads
  __shared__ __align__(16) T xs[2][XR * TC];
  __shared__ __align__(16) T ys[FWD_ROWS * TC];
  const int c0 = blockIdx.x * TC;
  // channel ch of rows [r0, r0 + LPT); a channel past C computes what no
  // store writes
  const int ch = threadIdx.x % TC, r0 = threadIdx.x / TC * LPT;
  float w[K], bias;
  taps<T>(a, min(c0 + ch, a.C - 1), w, bias);
  int i0, i1;
  tile_range(a.B * ntile, i0, i1);
  auto fetch = [&](int i, T* dst) {
    load_tile<T, VEC, XR, FWD_THREADS>(
        dst, static_cast<const T*>(a.x) + i / ntile * a.sb, a.ss,
        i % ntile * FWD_ROWS - (K - 1), a.S, c0, a.C);
  };
  if (i0 < i1) fetch(i0, xs[0]);
  commit_copies();
  for (int i = i0; i < i1; ++i) {
    const T* cur = xs[(i - i0) & 1];
    if (i + 1 < i1) fetch(i + 1, xs[(i - i0 + 1) & 1]);
    commit_copies();
    wait_copies<1>();
    __syncthreads();
    float win[K];
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) win[k] = to_f(cur[(r0 + k) * TC + ch]);
#pragma unroll 8
    for (int l = 0; l < LPT; ++l) {
      win[K - 1] = to_f(cur[(r0 + l + K - 1) * TC + ch]);
      const float p = pre(w, bias, win);
      ys[(r0 + l) * TC + ch] = from_f<T>(p * sigmoid(p));
      shift(win);
    }
    __syncthreads();
    store_tile<T, VEC, FWD_ROWS, FWD_THREADS>(
        static_cast<T*>(a.y) + (long long)(i / ntile) * a.S * a.C, a.C,
        i % ntile * FWD_ROWS, a.S, c0, a.C, ys);
  }
}

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MINB)
    causal_conv_bwd_kernel(Args a, int ntile) {
  using G = Tile<T, BWD_THREADS>;
  constexpr int TC = G::TC;
  constexpr int LPT = BWD_ROWS / G::NSEG;
  constexpr int XR = BWD_ROWS + 2 * (K - 1);  // rows of x a tile reads
  constexpr int DR = BWD_ROWS + K - 1;        // rows of dy
  __shared__ __align__(16) T xs[2][XR * TC];
  __shared__ __align__(16) T ds[2][DR * TC];
  __shared__ __align__(16) T os[BWD_ROWS * TC];
  const int c0 = blockIdx.x * TC;
  const int ch = threadIdx.x % TC, seg = threadIdx.x / TC, r0 = seg * LPT;
  float w[K], bias, dw[K], db = 0.f;
  taps<T>(a, min(c0 + ch, a.C - 1), w, bias);
#pragma unroll
  for (int k = 0; k < K; ++k) dw[k] = 0.f;
  int i0, i1;
  tile_range(a.B * ntile, i0, i1);
  auto fetch = [&](int i, int buf) {
    const int bb = i / ntile, t0 = i % ntile * BWD_ROWS;
    load_tile<T, VEC, XR, BWD_THREADS>(
        xs[buf], static_cast<const T*>(a.x) + bb * a.sb, a.ss, t0 - (K - 1),
        a.S, c0, a.C);
    load_tile<T, VEC, DR, BWD_THREADS>(
        ds[buf], static_cast<const T*>(a.dy) + (long long)bb * a.S * a.C,
        a.C, t0, a.S, c0, a.C);
  };
  if (i0 < i1) fetch(i0, 0);
  commit_copies();
  for (int i = i0; i < i1; ++i) {
    const int buf = (i - i0) & 1;
    if (i + 1 < i1) fetch(i + 1, buf ^ 1);
    commit_copies();
    wait_copies<1>();
    __syncthreads();
    // g over the tile rows [r0, r0 + LPT + K - 1) (zero past S: dy's rows
    // there read as zeros), dx over [r0, r0 + LPT); xs row r holds tile row
    // r - (K - 1)
    const T *xc = xs[buf], *dc = ds[buf];
    float xw[K], gw[K];
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) {
      xw[k] = to_f(xc[(r0 + k) * TC + ch]);
      gw[k] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < LPT + K - 1; ++j) {
      xw[K - 1] = to_f(xc[(r0 + j + K - 1) * TC + ch]);
      const float p = pre(w, bias, xw), s = sigmoid(p);
      const float g =
          to_f(dc[(r0 + j) * TC + ch]) * s * (1.f + p * (1.f - s));
      gw[K - 1] = g;
      if (j < LPT) {
        db += g;
#pragma unroll
        for (int k = 0; k < K; ++k) dw[k] = fmaf(g, xw[k], dw[k]);
      }
      if (j >= K - 1) {
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) d = fmaf(w[k], gw[K - 1 - k], d);
        os[(r0 + j - (K - 1)) * TC + ch] = from_f<T>(d);
      }
      shift(xw);
      shift(gw);
    }
    __syncthreads();
    store_tile<T, VEC, BWD_ROWS, BWD_THREADS>(
        static_cast<T*>(a.y) + (long long)(i / ntile) * a.S * a.C, a.C,
        i % ntile * BWD_ROWS, a.S, c0, a.C, os);
  }
  // the block's partials: each of the K + 1 sums over its runs in order,
  // one row of (K + 1) C f32 (dw by tap, then db); every copy has landed
  // and every thread has left the x tiles
  float* red = reinterpret_cast<float*>(xs);  // NSEG (K + 1) TC floats
  static_assert(G::NSEG * (K + 1) * TC * sizeof(float) <= sizeof(xs),
                "the partials fit in the x tiles");
#pragma unroll
  for (int q = 0; q <= K; ++q)
    red[(seg * (K + 1) + q) * TC + ch] = q < K ? dw[q] : db;
  __syncthreads();
  if (seg == 0 && c0 + ch < a.C) {
    float* row = a.part + (long long)blockIdx.y * (K + 1) * a.C;
#pragma unroll
    for (int q = 0; q <= K; ++q) {
      float s = 0.f;
      for (int sg = 0; sg < G::NSEG; ++sg)
        s += red[(sg * (K + 1) + q) * TC + ch];
      row[(long long)q * a.C + c0 + ch] = s;
    }
  }
}

// out[c] = sum over b < nrow of part[b][c], for c < ncol, in a fixed order:
// slice j of a block sums b = j, j + RED_SLICES, ...; then the slices in
// order.
__global__ void causal_conv_reduce_kernel(const float* part, int nrow,
                                          int ncol, float* out) {
  __shared__ float sh[RED_SLICES][RED_COLS];
  const int c = blockIdx.x * RED_COLS + threadIdx.x;
  float t = 0.f;
  if (c < ncol)
    for (int b = threadIdx.y; b < nrow; b += RED_SLICES)
      t += part[(long long)b * ncol + c];
  sh[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncol) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < RED_SLICES; ++j) s += sh[j][threadIdx.x];
    out[c] = s;
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether 16-byte accesses read and write every operand: every base, and
// x's strides, 16-byte aligned, C a whole number of chunks.
template <typename T>
bool vector_path(const Args& a, const void* extra) {
  const long long es = sizeof(T);
  return a.C % (16 / sizeof(T)) == 0 && aligned(a.x) && aligned(a.y) &&
         (extra == nullptr || aligned(extra)) && (a.ss * es) % 16 == 0 &&
         (a.B == 1 || (a.sb * es) % 16 == 0);
}

int cdiv(int n, int d) { return (n + d - 1) / d; }

// Ask for the largest shared-memory carveout, so that the blocks the tiles
// allow share an SM; true once done.
template <typename F>
bool carve(F* kernel) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared) == cudaSuccess;
}

// The current device's SMs (0 where it cannot be read).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T, int K>
int fwd_k(const Args& a, cudaStream_t s) {
  static const bool carved = carve(causal_conv_fwd_kernel<T, K, true>) &&
                             carve(causal_conv_fwd_kernel<T, K, false>);
  static const int sms = sm_count();
  if (!carved || sms == 0) return int(cudaGetLastError());
  // one wave of resident blocks, each walking a range of the tiles
  const int across = cdiv(a.C, TILE_BYTES / sizeof(T));
  const int ntile = cdiv(a.S, FWD_ROWS);
  const int down = std::max(1, std::min(a.B * ntile, sms * FWD_MINB / across));
  const dim3 grid(across, down);
  if (vector_path<T>(a, nullptr))
    causal_conv_fwd_kernel<T, K, true><<<grid, FWD_THREADS, 0, s>>>(a,
                                                                  ntile);
  else
    causal_conv_fwd_kernel<T, K, false><<<grid, FWD_THREADS, 0, s>>>(a,
                                                                   ntile);
  return int(cudaGetLastError());
}

template <typename T, int K>
int bwd_k(const Args& a, int nrow, float* red, cudaStream_t s) {
  static const bool carved = carve(causal_conv_bwd_kernel<T, K, true>) &&
                             carve(causal_conv_bwd_kernel<T, K, false>);
  if (!carved) return int(cudaGetLastError());
  const dim3 grid(cdiv(a.C, TILE_BYTES / sizeof(T)), nrow);
  const int ntile = cdiv(a.S, BWD_ROWS);
  if (vector_path<T>(a, a.dy))
    causal_conv_bwd_kernel<T, K, true><<<grid, BWD_THREADS, 0, s>>>(a,
                                                                   ntile);
  else
    causal_conv_bwd_kernel<T, K, false><<<grid, BWD_THREADS, 0, s>>>(a,
                                                                    ntile);
  if (cudaError_t err = cudaGetLastError()) return int(err);
  const int ncol = (K + 1) * a.C;
  causal_conv_reduce_kernel<<<cdiv(ncol, RED_COLS),
                              dim3(RED_COLS, RED_SLICES), 0, s>>>(
      a.part, nrow, ncol, red);
  return int(cudaGetLastError());
}

template <typename T>
int fwd(const Args& a, int K, cudaStream_t s) {
  switch (K) {
    case 1: return fwd_k<T, 1>(a, s);
    case 2: return fwd_k<T, 2>(a, s);
    case 3: return fwd_k<T, 3>(a, s);
    case 4: return fwd_k<T, 4>(a, s);
    default: return ERR_SHAPE;
  }
}

template <typename T>
int bwd(const Args& a, int K, int nrow, float* red, cudaStream_t s) {
  switch (K) {
    case 1: return bwd_k<T, 1>(a, nrow, red, s);
    case 2: return bwd_k<T, 2>(a, nrow, red, s);
    case 3: return bwd_k<T, 3>(a, nrow, red, s);
    case 4: return bwd_k<T, 4>(a, nrow, red, s);
    default: return ERR_SHAPE;
  }
}

bool shape_ok(int B, int S, int C, int K) {
  const int rows = std::min(FWD_ROWS, BWD_ROWS);
  return B > 0 && S > 0 && (long long)B * cdiv(S, rows) < (1LL << 31) &&
         C > 0 && K >= 1 && K <= MAX_K;
}

}  // namespace

extern "C" {

// The geometry the caller sizes the backward's partials by: 0, rows a
// backward tile; 1, bytes of a row's channels a tile; 2, backward blocks
// an SM holds.
int causal_conv_geometry(int which) {
  return which == 0 ? BWD_ROWS : which == 1 ? TILE_BYTES : BWD_MINB;
}

// The forward: x (B, S, C) of the dtype (0 float32, 1 bfloat16) at batch
// and row strides sb, ss (elements; last stride 1), taps w (K, C) and bias
// b (C,) float32, contiguous. Out: y (B, S, C) contiguous, in x's dtype.
int causal_conv_fwd(const void* x, long long sb, long long ss, const void* w,
                    const void* b, void* y, int B, int S, int C, int K,
                    int dtype, void* stream) {
  if (!shape_ok(B, S, C, K)) return ERR_SHAPE;
  const Args a{x, sb, ss, static_cast<const float*>(w),
               static_cast<const float*>(b), nullptr, y, nullptr, B, S, C};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(a, K, s);
  if (dtype == 1) return fwd<bf16>(a, K, s);
  return ERR_DTYPE;
}

// The backward: the forward's inputs and dy (B, S, C) contiguous. Out: dx
// (B, S, C) contiguous in x's dtype; ``red`` ((K + 1) C,) float32: dw by
// tap, then db. ``part`` is scratch of nrow (K + 1) C float32: one row of
// partials for each of the nrow blocks down the rows (each walks about
// B ceil(S / rows a tile) / nrow tiles).
int causal_conv_bwd(const void* x, long long sb, long long ss, const void* w,
                    const void* b, const void* dy, void* dx, void* part,
                    void* red, int B, int S, int C, int K, int nrow,
                    int dtype, void* stream) {
  if (!shape_ok(B, S, C, K) || nrow < 1 || nrow > 65535) return ERR_SHAPE;
  const Args a{x, sb, ss, static_cast<const float*>(w),
               static_cast<const float*>(b), dy, dx,
               static_cast<float*>(part), B, S, C};
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<float*>(red);
  if (dtype == 0) return bwd<float>(a, K, nrow, r, s);
  if (dtype == 1) return bwd<bf16>(a, K, nrow, r, s);
  return ERR_DTYPE;
}

const char* causal_conv_error_string(int code) {
  if (code == ERR_SHAPE)
    return "unsupported shape: at most 4 taps, 2^31 tiles of rows and "
           "65,535 rows of partials";
  if (code == ERR_DTYPE) return "unsupported dtype: float32 or bfloat16";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
