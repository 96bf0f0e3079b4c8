// The Mamba-2 mixer's gated output stage, forward and backward, for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces no TPU kernel: the JAX package computes this stage in plain jnp
// (src/repro/models/mamba2.py: the D skip, then the gated RMSNorm), as the
// port did in eager PyTorch until this kernel. Per row of width W = H P (a
// token; H heads of P channels), with D rounded to the row's dtype as the
// plain path rounds it:
//   u = y + D[h] x,  g = u silu(z),  r = rsqrt(mean(g^2) + eps),
//   out = g r scale                      (r is written out, f32 a row)
// and from dout, with n = g r, dn = dout scale, m = mean(n dn):
//   dg = r (dn - n m),  dy = dg silu(z),  dx = D dy,  dz = dg u silu'(z),
//   dD[h] = sum over the rows and the head's P columns of dy x,
//   dscale = sum over the rows of dout n.
// All arithmetic in f32, one rounding at each output (the plain bf16 path
// rounds after the skip, after the gate and at the output).
// kernels/gated_norm/ref.py holds the plain expression and this backward in
// closed form.
//
// What bounds it on this card: bytes. The forward reads y, x and z and
// writes out (8 bytes an element in bf16), the backward reads y, x, z and
// dout and writes dy, dx and dz (14 bytes); a few dozen flops an element are
// far below the ~295 flop a byte where the tensor cores would bind, and
// below what the FP32 pipes do in the time of the bytes. At mamba2-2.7b's
// training shape (16,384 rows of 5,120) that is 0.67 GB, 0.200 ms at 3.35
// TB/s, forward and 1.17 GB, 0.350 ms, backward.
//
// Design, so that each byte crosses device memory once:
//   - A block takes a row at a time; each thread holds fixed 16-byte column
//     chunks of it (8 bf16 or 4 f32) in registers. y, x, z and dout are read
//     with one 16-byte load a chunk straight from the model's views (a row
//     stride and a unit last stride: x and z are column slices of the conv's
//     and in_proj's outputs), so nothing is copied or packed first.
//   - A row's one reduction (sum g^2, or sum n dn) is a warp shuffle tree
//     and a sum over the warps in a fixed order; the second pass over the
//     row runs from registers and writes each output once.
//   - Blocks walk rows with a grid stride (8 rows a forward block, 64 a
//     backward block), so a thread reads its heads' D once a block; the
//     scale comes again each row through the read-only cache, which keeps
//     the registers for more blocks an SM.
//   - The backward sums dscale and dD in registers over the rows its block
//     walks and writes them as one row of f32 partials a block (W + H);
//     gated_norm_reduce_kernel sums the partials over the blocks in a fixed
//     order. No atomics: a repeated call gives the same bits.
//   - Threads a row follow W: 32 ceil(chunks / (32 NV)) for NV chunks a
//     thread, the forward's NV the least that keeps a row within 320
//     threads (5,120 bf16: 320 threads of 2 chunks; 8,192: 256 of 4), the
//     backward's at least 2 (its four operands stay in registers between
//     its two passes) and within 512 threads. Measured (H100): the forward
//     at 8,192 was 13-16 % slower at 512 threads of 2, and at 5,120 8 %
//     slower at 160 threads of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_THREADS = 512;
constexpr int FWD_THREADS = 320;  // the forward's most threads a row
constexpr int BWD_NV = 2;         // the backward's least chunks a thread
constexpr int FWD_ROWS = 8;       // rows a forward block walks
constexpr int MAX_NV = 8;
constexpr int RED_COLS = 32;    // columns a reduce block sums
constexpr int RED_SLICES = 8;   // slices of the blocks it sums them over

enum Err { ERR_SHAPE = 1001, ERR_DTYPE = 1002 };

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int VEC = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float (&v)[VEC]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static Raw pack(const float (&v)[VEC]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float round(float a) { return a; }
};

template <>
struct Io<bf16> {
  static constexpr int VEC = 8;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float (&v)[VEC]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the upper half of an f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static Raw pack(const float (&v)[VEC]) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                      pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
  __device__ static float round(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
};

template <typename T>
__device__ __forceinline__ typename Io<T>::Raw load(const void* base,
                                                    long long stride, int r,
                                                    int col) {
  const T* p = static_cast<const T*>(base) + (long long)r * stride + col;
  return *reinterpret_cast<const typename Io<T>::Raw*>(p);
}

template <typename T>
__device__ __forceinline__ void store(void* base, int W, int r, int col,
                                      const typename Io<T>::Raw& v) {
  T* p = static_cast<T*>(base) + (long long)r * W + col;
  *reinterpret_cast<typename Io<T>::Raw*>(p) = v;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + __expf(-z));
}

// The block's sum of v, the same bits in every thread: a shuffle tree in
// each warp, then the warps' sums in order. ``sh`` holds 32 floats.
__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) t += sh[i];
  __syncthreads();  // sh is taken again by the next row
  return t;
}

struct FwdArgs {
  const void *y, *x, *z;
  long long sy, sx, sz;  // row strides, in elements
  const float *D, *scale;
  void* out;    // (rows, W), contiguous
  float* rstd;  // (rows,)
  int rows, W, P;
  float eps;
};

struct BwdArgs {
  const void *y, *x, *z, *dout;
  long long sy, sx, sz, sd;
  const float *D, *scale, *rstd;
  void *dy, *dx, *dz;  // (rows, W), contiguous
  float* part;         // (gridDim.x, W + H): dscale's, then dD's partials
  int rows, W, P;
};

// The columns a thread holds: chunk c = threadIdx.x + k blockDim.x and its
// head's D (rounded to T). A chunk's scale is read again each row through
// the read-only cache: kept in registers it cost the backward its second
// block an SM (0.63 against 0.44 ms at mamba2-2.7b's training shape).
template <typename T, int NV>
struct Cols {
  static constexpr int V = Io<T>::VEC;
  const float* scale;
  float d[NV];
  bool on[NV];

  __device__ Cols(const float* scale_, const float* D, int W, int P)
      : scale(scale_) {
    const int C = W / V;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      on[k] = c < C;
      d[k] = on[k] ? Io<T>::round(D[c * V / P]) : 0.f;
    }
  }

  // chunk k's scale (16-byte aligned: the wrapper's contiguous f32 copy)
  __device__ void scales(int k, float (&s)[V]) const {
    const float4* p = reinterpret_cast<const float4*>(
        scale + (threadIdx.x + k * blockDim.x) * V);
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 q = __ldg(p + j);
      s[4 * j] = q.x;
      s[4 * j + 1] = q.y;
      s[4 * j + 2] = q.z;
      s[4 * j + 3] = q.w;
    }
  }
};

template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
    gated_norm_fwd_kernel(FwdArgs a) {
  using IO = Io<T>;
  constexpr int V = IO::VEC;
  __shared__ float sh[32];
  const Cols<T, NV> cols(a.scale, a.D, a.W, a.P);
  for (int r = blockIdx.x; r < a.rows; r += gridDim.x) {
    typename IO::Raw ry[NV], rx[NV], rz[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!cols.on[k]) continue;
      const int col = (threadIdx.x + k * blockDim.x) * V;
      ry[k] = load<T>(a.y, a.sy, r, col);
      rx[k] = load<T>(a.x, a.sx, r, col);
      rz[k] = load<T>(a.z, a.sz, r, col);
    }
    float g[NV][V];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float yv[V], xv[V], zv[V];
      IO::unpack(ry[k], yv);
      IO::unpack(rx[k], xv);
      IO::unpack(rz[k], zv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float u = fmaf(cols.d[k], xv[i], yv[i]);
        g[k][i] = cols.on[k] ? u * (zv[i] * sigmoid(zv[i])) : 0.f;
        ss = fmaf(g[k][i], g[k][i], ss);
      }
    }
    const float rs = rsqrtf(block_sum(ss, sh) / a.W + a.eps);
    if (threadIdx.x == 0) a.rstd[r] = rs;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!cols.on[k]) continue;
      float o[V], sc[V];
      cols.scales(k, sc);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = g[k][i] * rs * sc[i];
      store<T>(a.out, a.W, r, (threadIdx.x + k * blockDim.x) * V,
               IO::pack(o));
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
    gated_norm_bwd_kernel(BwdArgs a) {
  using IO = Io<T>;
  constexpr int V = IO::VEC;
  __shared__ float sh[32];
  const Cols<T, NV> cols(a.scale, a.D, a.W, a.P);
  float acc_s[NV][V], acc_d[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    acc_d[k] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) acc_s[k][i] = 0.f;
  }
  for (int r = blockIdx.x; r < a.rows; r += gridDim.x) {
    typename IO::Raw ry[NV], rx[NV], rz[NV], rd[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!cols.on[k]) continue;
      const int col = (threadIdx.x + k * blockDim.x) * V;
      ry[k] = load<T>(a.y, a.sy, r, col);
      rx[k] = load<T>(a.x, a.sx, r, col);
      rz[k] = load<T>(a.z, a.sz, r, col);
      rd[k] = load<T>(a.dout, a.sd, r, col);
    }
    const float rs = a.rstd[r];
    // pass 1: sum n dn over the row; dscale's terms
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!cols.on[k]) continue;
      float yv[V], xv[V], zv[V], dv[V], sc[V];
      IO::unpack(ry[k], yv);
      IO::unpack(rx[k], xv);
      IO::unpack(rz[k], zv);
      IO::unpack(rd[k], dv);
      cols.scales(k, sc);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float u = fmaf(cols.d[k], xv[i], yv[i]);
        const float n = u * (zv[i] * sigmoid(zv[i])) * rs;
        part = fmaf(n, dv[i] * sc[i], part);
        acc_s[k][i] = fmaf(dv[i], n, acc_s[k][i]);
      }
    }
    const float m = block_sum(part, sh) / a.W;
    // pass 2: the gradients
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!cols.on[k]) continue;
      float yv[V], xv[V], zv[V], dv[V], sc[V], gy[V], gx[V], gz[V];
      IO::unpack(ry[k], yv);
      IO::unpack(rx[k], xv);
      IO::unpack(rz[k], zv);
      IO::unpack(rd[k], dv);
      cols.scales(k, sc);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float u = fmaf(cols.d[k], xv[i], yv[i]);
        const float sg = sigmoid(zv[i]);
        const float s = zv[i] * sg;
        const float n = u * s * rs;
        const float dg = rs * (dv[i] * sc[i] - n * m);
        gy[i] = dg * s;
        gx[i] = cols.d[k] * gy[i];
        gz[i] = dg * u * sg * (1.f + zv[i] * (1.f - sg));
        acc_d[k] = fmaf(gy[i], xv[i], acc_d[k]);
      }
      const int col = (threadIdx.x + k * blockDim.x) * V;
      store<T>(a.dy, a.W, r, col, IO::pack(gy));
      store<T>(a.dx, a.W, r, col, IO::pack(gx));
      store<T>(a.dz, a.W, r, col, IO::pack(gz));
    }
  }
  // this block's partials: dscale by column, then dD by head (the chunks
  // of a head summed in order through shared memory)
  const int H = a.W / a.P, per_head = a.P / V;
  float* row = a.part + (long long)blockIdx.x * (a.W + H);
  __shared__ float chunk_d[MAX_THREADS * NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!cols.on[k]) continue;
    const int c = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int i = 0; i < V; ++i) row[c * V + i] = acc_s[k][i];
    chunk_d[c] = acc_d[k];
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float t = 0.f;
    for (int j = 0; j < per_head; ++j) t += chunk_d[h * per_head + j];
    row[a.W + h] = t;
  }
}

// out[c] = sum over b < nblk of part[b][c], for c < ncol, in a fixed order:
// slice j of a block sums b = j, j + RED_SLICES, ...; then the slices in
// order.
__global__ void gated_norm_reduce_kernel(const float* part, int nblk,
                                         int ncol, float* out) {
  __shared__ float sh[RED_SLICES][RED_COLS];
  const int c = blockIdx.x * RED_COLS + threadIdx.x;
  float t = 0.f;
  if (c < ncol)
    for (int b = threadIdx.y; b < nblk; b += RED_SLICES)
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

// Chunks a thread for a row of C chunks: at least ``base``, doubled while
// the row would need more than ``threads`` threads; 0 if not even MAX_NV
// does.
int chunks_a_thread(int C, int base, int threads) {
  int nv = base;
  while (nv <= MAX_NV && (C + nv - 1) / nv > threads) nv *= 2;
  return nv <= MAX_NV ? nv : 0;
}

int threads_for(int C, int nv) {
  const int t = (C + nv - 1) / nv;
  return (t + 31) / 32 * 32;
}

template <typename T>
int check(int W, int P) {
  constexpr int V = Io<T>::VEC;
  if (W <= 0 || P <= 0 || W % P || P % 8) return ERR_SHAPE;
  return W % V ? ERR_SHAPE : 0;
}

template <typename T>
int fwd(const FwdArgs& a, cudaStream_t s) {
  if (int e = check<T>(a.W, a.P)) return e;
  const int C = a.W / Io<T>::VEC,
            nv = chunks_a_thread(C, 1, FWD_THREADS);
  const int grid = (a.rows + FWD_ROWS - 1) / FWD_ROWS;
  const int tpb = threads_for(C, nv);
  switch (nv) {
    case 1: gated_norm_fwd_kernel<T, 1><<<grid, tpb, 0, s>>>(a); break;
    case 2: gated_norm_fwd_kernel<T, 2><<<grid, tpb, 0, s>>>(a); break;
    case 4: gated_norm_fwd_kernel<T, 4><<<grid, tpb, 0, s>>>(a); break;
    case 8: gated_norm_fwd_kernel<T, 8><<<grid, tpb, 0, s>>>(a); break;
    default: return ERR_SHAPE;
  }
  return int(cudaGetLastError());
}

template <typename T>
int bwd(const BwdArgs& a, int nblk, float* red, cudaStream_t s) {
  if (int e = check<T>(a.W, a.P)) return e;
  const int C = a.W / Io<T>::VEC,
            nv = chunks_a_thread(C, BWD_NV, MAX_THREADS);
  const int tpb = threads_for(C, nv);
  switch (nv) {
    case 2: gated_norm_bwd_kernel<T, 2><<<nblk, tpb, 0, s>>>(a); break;
    case 4: gated_norm_bwd_kernel<T, 4><<<nblk, tpb, 0, s>>>(a); break;
    case 8: gated_norm_bwd_kernel<T, 8><<<nblk, tpb, 0, s>>>(a); break;
    default: return ERR_SHAPE;
  }
  if (cudaError_t err = cudaGetLastError()) return int(err);
  const int ncol = a.W + a.W / a.P;
  gated_norm_reduce_kernel<<<(ncol + RED_COLS - 1) / RED_COLS,
                             dim3(RED_COLS, RED_SLICES), 0, s>>>(
      a.part, nblk, ncol, red);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward over ``rows`` rows of width W (heads of P): y, x, z of the
// dtype (0 float32, 1 bfloat16) at row strides sy, sx, sz (elements; last
// stride 1, rows 16-byte aligned), D (W / P,) and scale (W,) float32. Out:
// out (rows, W) contiguous, rstd (rows,) float32.
int gated_norm_fwd(const void* y, const void* x, const void* z, long long sy,
                   long long sx, long long sz, const void* D,
                   const void* scale, void* out, void* rstd, int rows, int W,
                   int P, float eps, int dtype, void* stream) {
  const FwdArgs a{y, x, z, sy, sx, sz, static_cast<const float*>(D),
                  static_cast<const float*>(scale), out,
                  static_cast<float*>(rstd), rows, W, P, eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(a, s);
  if (dtype == 1) return fwd<bf16>(a, s);
  return ERR_DTYPE;
}

// The backward: the forward's inputs, its rstd and dout (row stride sd).
// Out: dy, dx, dz (rows, W) contiguous in the dtype; ``red`` (W + W / P,)
// float32: dscale, then dD. ``part`` is scratch of nblk (W + W / P) float32,
// one row of partials for each of the nblk blocks.
int gated_norm_bwd(const void* y, const void* x, const void* z,
                   const void* dout, long long sy, long long sx, long long sz,
                   long long sd, const void* D, const void* scale,
                   const void* rstd, void* dy, void* dx, void* dz, void* part,
                   void* red, int rows, int W, int P, int nblk, int dtype,
                   void* stream) {
  const BwdArgs a{y, x, z, dout, sy, sx, sz, sd,
                  static_cast<const float*>(D),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(rstd), dy, dx, dz,
                  static_cast<float*>(part), rows, W, P};
  auto s = static_cast<cudaStream_t>(stream);
  if (nblk <= 0) return ERR_SHAPE;
  if (dtype == 0) return bwd<float>(a, nblk, static_cast<float*>(red), s);
  if (dtype == 1) return bwd<bf16>(a, nblk, static_cast<float*>(red), s);
  return ERR_DTYPE;
}

const char* gated_norm_error_string(int code) {
  if (code == ERR_SHAPE)
    return "unsupported shape: W must be a multiple of P and P of 8, and a "
           "row at most 2,560 16-byte chunks";
  if (code == ERR_DTYPE) return "unsupported dtype: float32 or bfloat16";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
