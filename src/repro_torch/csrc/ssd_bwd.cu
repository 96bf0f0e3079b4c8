// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces no TPU kernel: the reference's backward is plain jnp (the
// custom_vjp of src/repro/kernels/ssd/ops.py recomputes through
// models/mamba2.py::ssd_chunked), as the port's was until this kernel.
// It is the gradient of csrc/ssd.cu's function, bf16 only, per head from a
// zero state over chunks of Qc rows:
//   cum_i = inclusive cumsum of dt A in the chunk, cl its last value,
//   L_ij  = exp(cum_i - cum_j) for j <= i (0 above, never evaluated there),
//   S_ij  = C_i . B_j, dM_ij = gy_i . x_j, M = S L dt_j, dS = dM L dt_j,
//   w_j   = exp(cl - cum_j) dt_j, e_i = exp(cum_i), T = exp(cl),
//   h_k   the state entering chunk k (h_{k+1} = T h_k + sum_j w_j B_j x_j^T),
//   Dh_k  the gradient of the state leaving it (Dh_last = ghT or 0,
//         Dh_{k-1} = T_k Dh_k + sum_i e_i C_i gy_i^T);
//   dx_j  = sum_i M_ij gy_i + w_j Dh_k^T B_j
//   dB_j  = sum_i dS_ij C_i + w_j Dh_k x_j           (summed over a group)
//   dC_i  = sum_j dS_ij B_j + e_i h_k gy_i           (summed over a group)
//   dcum  = rows of dM M - columns of dM M (both without the diagonal,
//           whose two shares cancel) + e_i C_i . h_k gy_i
//           - w_j dw_j (dw_j = x_j . Dh_k^T B_j), at the last row also
//           sum_j w_j dw_j + T <Dh_k, h_k>;
//   ddt_j = sum_i dM_ij S_ij L_ij + exp(cl - cum_j) dw_j + A da_j and
//   dA = sum dt da, da the reverse cumsum of dcum in the chunk.
// The chunk is the forward's Q from 64 rows up; below 64 rows as many
// whole chunks as fill 64 rows run together with the cumsum running on
// across them (the forward kernel does the same with its items), which
// changes only the rounding. kernels/ssd/ref.py::ssd_bwd_ref is this
// decomposition in plain PyTorch.
//
// Layout: the model's. x and gy (Bsz, S, H, P) and dt (Bsz, S, H) at any
// strides (P contiguous), B and C per group (Bsz, S, G, N) at any strides
// (N contiguous), head h reading group h / hpg; ghT (Bsz, H, N, P) f32 or
// null. Out: dx (Bsz, S, H, P) bf16, ddt (Bsz, S, H) f32, dA (H,) f32, dB
// and dC (Bsz, S, G, N) bf16, all contiguous.
//
// What bounds it on this card: at mamba2-2.7b's training shape (x (4,
// 4096, 80, 64), one group of N = 128, Q = 256) the gradient reads x, gy,
// B, C, dt and ghT and writes dx, ddt, dB and dC once: ~0.53 GB, 0.158 ms
// at 3.35 TB/s, against ~130 GFLOP of the forward's products taken twice
// (0.13 ms at 989 TFLOP/s): bytes. The work this design does is larger.
// Its tensor work per (batch, head, chunk) is the scores C B^T and dM = gy
// x^T over the 10 visible 64 x 64 tile pairs twice (by key rows and by
// query rows), M gy, dS C and dS B with M and dS as bf16 hi + lo, the chunk
// terms through h and Dh as hi + lo, and the chunk states: ~0.65 TFLOP,
// 0.65 ms at the bf16 peak. Its scratch (~0.86 GB: the chunk states in f32
// and as bf16 hi + lo planes, the slices' partial dB and dC) is written and
// read again, each state plane by the four blocks of its chunk, and x and gy
// are read three times: ~3 GB, ~0.9 ms. Measured (H100, PERF.md): 2.6 ms,
// of which the key and query kernels take two thirds; each warpgroup there
// runs a serial chain of wgmma, wait, the elementwise masking and splits,
// wgmma, wait, and two blocks an SM overlap each other's chains.
//
// Design. Six kernels a call, each a grid of independent blocks:
//   1. ssd_bwd_state_kernel, a block of two warpgroups per (batch, head,
//      chunk): the chunk's cumsum (a run of rows a thread, the runs'
//      totals scanned) into scratch, then U^T = (w x)^T B and V^T = (e
//      gy)^T C on wgmma, (w x) and (e gy) read by ldmatrix.trans from
//      64-row tiles, scaled and split hi + lo in registers.
//   2. ssd_bwd_scan_kernel, blocks of a part of a (batch, head)'s P x N
//      state (four at the shape above, 8 elements a thread, so that enough
//      loads are in flight): h_k forward and Dh_k in reverse chunk order,
//      carried in f32 registers and written as bf16 hi + lo planes, with T_k
//      <Dh_k, h_k> reduced in a fixed order.
//   3. ssd_bwd_key_kernel, one warpgroup per (64 key rows of a chunk,
//      batch, slice of up to 8 heads of one group), tiles with the most
//      pairs first: for each head, dx_j and the key rows' scalars over the
//      chunk's later query tiles, streamed through two stages of cp.async;
//      dB_j summed over the slice's heads in registers.
//   4. ssd_bwd_query_kernel, the same by query rows: dC_i and the query
//      rows' scalars over the earlier key tiles.
//   5. ssd_bwd_dt_kernel, a block per head: the reverse cumsums, ddt, and
//      dA summed over batches and chunks in a fixed order.
//   6. ssd_bwd_reduce_kernel: dB and dC, the slices of a group summed in
//      order, rounded to bf16.
//   Every product runs on wgmma with bf16 x, gy, B and C as they are and
//   each f32 operand (M, dS, w x, e gy, h, Dh) as bf16 hi + lo; sums,
//   cumsums and exps in f32. Nothing is summed by atomics, so a repeated
//   call gives the same bits. No (Bsz, H, Q, Q) tile leaves shared memory
//   or registers: the scratch (allocated by the wrapper, ``bwd.py``'s
//   ``scratch_numel``) is the chunk states, Bsz H nc P N f32 twice and as
//   many bytes of bf16 planes twice, the slices' partial dB and dC, Bsz S
//   (H / heads a slice) N f32 each, the cumsum and three per-row arrays,
//   Bsz H S f32 each, and per-tile and per-chunk scalars. Scores by key rows
//   and by query rows are computed twice instead of exchanged: each pass
//   keeps one accumulator set in registers (at most 255 a thread, one
//   warpgroup a block, two blocks an SM), and neither needs a reduction
//   across rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TR = 64;    // rows of a tile
constexpr int KT = 128;   // threads of the key and query kernels
constexpr int NTS = 256;  // threads of the other kernels

struct Params {
  const bf16 *x, *Bm, *Cm, *gy;
  const float *dt, *A, *ghT;
  bf16 *dx, *dB, *dC;
  float *ddt, *dA;
  float* hs;    // (BH, nc, P, N): U^T
  float* ds;    // (BH, nc, P, N): V^T
  bf16* hq;     // (BH, nc, 2, P, N): h_k^T as bf16 hi and lo planes
  bf16* dq;     // (BH, nc, 2, P, N): Dh_k^T as bf16 hi and lo planes
  float* cum;   // (BH, S)
  float* rows;  // (3, BH, S): ddt's direct terms, dcum by key rows, by
                // query rows
  float* dcl;   // (BH, nc, nt): sum_j w_j dw_j over a key tile
  float* dT;    // (BH, nc, ns): T_k <Dh_k, h_k> over a scan block's part
  float *pB, *pC;  // (Bsz, S, nsl, N): a slice's dB and dC
  long long xs_b, xs_s, xs_h, dts_b, dts_s, dts_h, bs_b, bs_s, bs_g, cs_b,
      cs_s, cs_g, gs_b, gs_s, gs_h;
  int Bsz, S, H, G, hpg, N, Qc, nc, nt, hs_n, nsl, ns;
};

__host__ __device__ constexpr int up1k(int x) { return (x + 1023) & ~1023; }

__device__ __forceinline__ int chunk_rows(const Params& p, int k) {
  return min(p.Qc, p.S - k * p.Qc);
}

// byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r in a
// swizzled R x WP tile (tc::Swz<WP>)
template <int WP, int R>
__device__ __forceinline__ int chunk_off(int r, int c) {
  using S = tc::Swz<WP>;
  const int off = r * S::RB + (c % (S::RB / 16)) * 16;
  return (c / (S::RB / 16)) * R * S::RB +
         (off ^ (((off >> 7) & S::MASK) << 4));
}

// p, as a value the compiler cannot see through: wgmma descriptors are
// computed where they are used instead of held across the loop
__device__ __forceinline__ const unsigned char* opaque(
    const unsigned char* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024 - (tc::smem_u32(p) & 1023)) & 1023);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[c][e] = 0.f;
}

// A 64 x W accumulator's rows (g and g + 8 of the warp's 16) dotted with
// the same entries of a swizzled 64-row bf16 tile: each thread's columns,
// then the quad that shares a row (every lane of it gets the same bits)
template <int W>
__device__ __forceinline__ float2 rowdot(const float (&d)[W / 8][4],
                                         const unsigned char* t) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * ((threadIdx.x / 32) % 4) + lane / 4, t4 = lane % 4;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int c = 0; c < W / 8; ++c) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        t + chunk_off<W, TR>(r, c) + 4 * t4));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        t + chunk_off<W, TR>(r + 8, c) + 4 * t4));
    s0 = fmaf(d[c][0], a.x, s0);
    s0 = fmaf(d[c][1], a.y, s0);
    s1 = fmaf(d[c][2], b.x, s1);
    s1 = fmaf(d[c][3], b.y, s1);
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  return make_float2(s0, s1);
}

// a 64 x 64 f32 accumulator as the register A operand of 4 k-steps, hi + lo
__device__ __forceinline__ void split_frags(const float (&s)[8][4],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    tc::split_bf16(s[2 * kk][0], s[2 * kk][1], hi[kk][0], lo[kk][0]);
    tc::split_bf16(s[2 * kk][2], s[2 * kk][3], hi[kk][1], lo[kk][1]);
    tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// a state's bf16 hi and lo planes (P x N each, from the scan) into two
// swizzled P x N tiles, by cp.async (the key and query kernels' threads)
template <int N, int P>
__device__ __forceinline__ void load_state(const bf16* src, unsigned char* hi,
                                           unsigned char* lo) {
  tc::load_swz<N, N, P, KT>(hi, src, N, P);
  tc::load_swz<N, N, P, KT>(lo, src + P * N, N, P);
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------

// Shared memory of the state kernel, from a 1024-byte aligned start: two
// stages of [x][B][gy][C] 64-row tiles, then per stage the vectors w and e,
// then cl (and room to 16 bytes), then the cumsum's warp totals
template <int N, int P>
struct StateL {
  static constexpr int tN = up1k(TR * N * 2), tP = up1k(TR * P * 2);
  // each warpgroup's pair of tiles: x and B, then gy and C
  static constexpr int x_off = 0, g_off = tP + tN, stage = 2 * (tP + tN);
  static constexpr int v_off = 2 * stage;
  static constexpr int bytes = 1024 + v_off + (4 * TR + 4 + NTS / 32) * 4;
};

template <int N, int P>
__global__ void __launch_bounds__(NTS, 1)
    ssd_bwd_state_kernel(const Params p) {
  using L = StateL<N, P>;
  using SN = tc::Swz<N>;
  constexpr int MB = P > 64 ? 2 : 1;  // 64-row blocks of the state's P rows
  extern __shared__ unsigned char smem_state[];
  unsigned char* sm = align1k(smem_state);
  float* V = reinterpret_cast<float*>(sm + L::v_off);  // w, e a stage; cl
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32, gr = lane / 4, t4 = lane % 4;
  const int k = blockIdx.x % p.nc, bh = blockIdx.x / p.nc;
  const int b = bh / p.H, h = bh - b * p.H, g = h / p.hpg;
  const int len = chunk_rows(p, k), c0 = k * p.Qc, nti = (len + TR - 1) / TR;
  float* cum = p.cum + size_t(bh) * p.S + c0;
  const float* dtb = p.dt + b * p.dts_b + h * p.dts_h + c0 * p.dts_s;

  // the chunk's inclusive cumsum of dt A: each thread sums a run of rows
  // in order (one row at Q = 256), then the runs' totals are scanned, in
  // each warp and then over the warps in order
  {
    float* red = V + 4 * TR + 4;
    const float a_h = p.A[h];
    const int per = (len + NTS - 1) / NTS, lo = min(len, tid * per),
              hi = min(len, lo + per);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) run += dtb[i * p.dts_s] * a_h;
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) red[tid / 32] = incl;
    __syncthreads();
    float before = 0.f;
    for (int w = 0; w < tid / 32; ++w) before += red[w];
    float ex = __shfl_up_sync(0xffffffffu, incl, 1);
    run = before + (lane == 0 ? 0.f : ex);
    for (int i = lo; i < hi; ++i) {
      run += dtb[i * p.dts_s] * a_h;
      cum[i] = run;
    }
    if (lo < hi && hi == len) V[4 * TR] = run;
  }
  __syncthreads();
  const float cl = V[4 * TR];
  // a tile's cum and dt, read by threads < 64 one tile ahead of their use
  float c_nx = 0.f, d_nx = 0.f;
  auto fetch = [&](int tt) {
    const int i = TR * tt + tid;
    c_nx = i < len ? cum[i] : cl;
    d_nx = i < len ? dtb[i * p.dts_s] : 0.f;
  };

  // warpgroup 0: U^T = (w x)^T B; warpgroup 1: V^T = (e gy)^T C
  const bf16* src_p = wg == 0 ? p.x + b * p.xs_b + h * p.xs_h
                              : p.gy + b * p.gs_b + h * p.gs_h;
  const long long ld_p = wg == 0 ? p.xs_s : p.gs_s;
  const bf16* src_n = wg == 0 ? p.Bm + b * p.bs_b + g * p.bs_g
                              : p.Cm + b * p.cs_b + g * p.cs_g;
  const long long ld_n = wg == 0 ? p.bs_s : p.cs_s;
  // each warpgroup loads its own two tiles of a stage
  auto load = [&](int st, int tt) {
    unsigned char* s = sm + st * L::stage + (wg == 0 ? L::x_off : L::g_off);
    const int r = c0 + TR * tt, n = min(TR, len - TR * tt);
    tc::load_swz<P, P, TR, 128>(s, src_p + r * ld_p, ld_p, n);
    tc::load_swz<N, N, TR, 128>(s + L::tP, src_n + r * ld_n, ld_n, n);
  };
  for (int rb = 0; rb < MB; ++rb) {
    float acc[N / 8][4];
    zero(acc);
    const int prow = 64 * rb + 16 * warp;  // this warp's 16 state rows
    if (tid < TR) fetch(0);
    load(0, 0);
    tc::cp_async_commit();
    for (int tt = 0; tt < nti; ++tt) {
      const int st = tt & 1;
      if (tt > 0) __syncthreads();  // the other stage is read
      if (tt + 1 < nti) load(st ^ 1, tt + 1);
      tc::cp_async_commit();
      if (tid < TR) {
        const bool in = TR * tt + tid < len;
        V[st * 2 * TR + tid] = in ? __expf(cl - c_nx) * d_nx : 0.f;
        V[st * 2 * TR + TR + tid] = in ? __expf(c_nx) : 0.f;
        if (tt + 1 < nti) fetch(tt + 1);
      }
      tc::cp_async_wait<1>();
      tc::fence_proxy_async();
      __syncthreads();
      const unsigned char* sA =
          sm + st * L::stage + (wg == 0 ? L::x_off : L::g_off);
      const unsigned char* sK = sA + L::tP;
      const float* wv = V + st * 2 * TR + wg * TR;
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int m = lane / 8;
        const int j = 16 * kk + (m >> 1) * 8 + lane % 8;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (prow < P)
          tc::ldmatrix_x4_trans(
              v, sA + chunk_off<P, TR>(j, (prow + (m & 1) * 8) / 8));
        const float2 w0 = *reinterpret_cast<const float2*>(wv + 16 * kk +
                                                           2 * t4);
        const float2 w8 = *reinterpret_cast<const float2*>(wv + 16 * kk +
                                                           2 * t4 + 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&v[q]));
          const float2 ww = q >> 1 ? w8 : w0;
          tc::split_bf16(f.x * ww.x, f.y * ww.y, fh[kk][q], fl[kk][q]);
        }
      }
      tc::fence_regs(acc);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = SN::template mnmajor<TR>(opaque(sK), kk);
        tc::wgmma_rs_t<N>(acc, fh[kk], bd);
        tc::wgmma_rs_t<N>(acc, fl[kk], bd);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(acc);
      tc::fence_regs(fh);
      tc::fence_regs(fl);
    }
    float* out = (wg == 0 ? p.hs : p.ds) + (size_t(bh) * p.nc + k) * P * N;
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pr = prow + gr + 8 * r;
        if (pr < P)
          *reinterpret_cast<float2*>(out + pr * N + 8 * c + 2 * t4) =
              make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
      }
    __syncthreads();  // before the next row block's loads
  }
}

// ---------------------------------------------------------------------------
// 2. the scans over chunks
// ---------------------------------------------------------------------------

// T_k <Dh_k, h_k>'s sum over the block, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // the last call's readers are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NTS / 32; ++w) s += red[w];
  return s;
}

// v as bf16 hi at dst and lo at dst + plane (tc::split_bf16's rounding)
__device__ __forceinline__ void store_split(bf16* dst, int plane, float v) {
  const bf16 hi = __float2bfloat16_rn(v);
  dst[0] = hi;
  dst[plane] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// A (P, N) plane split among scan blocks, 8 elements a thread where it
// has 2048 or more (the server's 8192: four blocks a head), so that enough
// loads are in flight to stream the states at the card's bandwidth
template <int N, int P>
struct Scan {
  static constexpr int PN = P * N;
  static constexpr int EPT = PN >= NTS * 8 ? 8 : PN / NTS;
  static constexpr int SPLIT = PN / (NTS * EPT);
};

template <int N, int P>
__global__ void __launch_bounds__(NTS) ssd_bwd_scan_kernel(const Params p) {
  using C = Scan<N, P>;
  constexpr int PN = C::PN, EPT = C::EPT;
  __shared__ float red[NTS / 32];
  const int bh = blockIdx.x / C::SPLIT, part = blockIdx.x % C::SPLIT;
  const int e0 = part * NTS * EPT + threadIdx.x;  // elements e0 + NTS q
  const float* U = p.hs + size_t(bh) * p.nc * PN + e0;
  const float* V = p.ds + size_t(bh) * p.nc * PN + e0;
  bf16* Hq = p.hq + size_t(bh) * p.nc * 2 * PN + e0;
  bf16* Dq = p.dq + size_t(bh) * p.nc * 2 * PN + e0;
  const float* cum = p.cum + size_t(bh) * p.S;
  float s[EPT];
  // h_k forward, as bf16 hi + lo planes (the query kernel's operand; each
  // chunk's loads issued together, before its stores)
#pragma unroll
  for (int q = 0; q < EPT; ++q) s[q] = 0.f;
  for (int k = 0; k < p.nc; ++k) {
    const float T = expf(cum[k * p.Qc + chunk_rows(p, k) - 1]);
    float u[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) u[q] = U[size_t(k) * PN + NTS * q];
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      store_split(Hq + size_t(k) * 2 * PN + NTS * q, PN, s[q]);
      s[q] = fmaf(T, s[q], u[q]);
    }
  }
  // Dh_k in reverse, as bf16 hi + lo planes, and T_k <Dh_k, h_k> with h_k
  // read back as hi + lo; ghT is (N, P) a head
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = e0 + NTS * q;
    s[q] = p.ghT != nullptr ? p.ghT[size_t(bh) * PN + (e % N) * P + e / N]
                            : 0.f;
  }
  for (int k = p.nc - 1; k >= 0; --k) {
    const float T = expf(cum[k * p.Qc + chunk_rows(p, k) - 1]);
    float v[EPT], h[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const bf16* hk = Hq + size_t(k) * 2 * PN + NTS * q;
      v[q] = V[size_t(k) * PN + NTS * q];
      h[q] = __bfloat162float(hk[0]) + __bfloat162float(hk[PN]);
    }
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      store_split(Dq + size_t(k) * 2 * PN + NTS * q, PN, s[q]);
      dot = fmaf(s[q], h[q], dot);
      s[q] = fmaf(T, s[q], v[q]);
    }
    const float tot = block_sum(dot, red);
    if (threadIdx.x == 0)
      p.dT[(size_t(bh) * p.nc + k) * C::SPLIT + part] = T * tot;
  }
}

// ---------------------------------------------------------------------------
// 3, 4. the chunk terms by key rows and by query rows
// ---------------------------------------------------------------------------

// Shared memory of the key and query kernels, from a 1024-byte aligned
// start: the block's fixed N-wide and P-wide 64-row tiles (key: B_j, x_j;
// query: C_i, gy_i), the state's hi and lo (P x N), two stages of the
// streamed N- and P-wide tiles, then the vectors (the fixed rows' four,
// two a stage) and the reduction's four floats
template <int N, int P>
struct TermL {
  static constexpr int tN = up1k(TR * N * 2), tP = up1k(TR * P * 2),
                       tH = up1k(P * N * 2);
  static constexpr int fn = 0, fp = tN, hh = tN + tP, hl = hh + tH,
                       st = hl + tH, stage = tN + tP;
  static constexpr int v_off = st + 2 * stage;
  static constexpr int bytes = 1024 + v_off + (8 * TR + 4) * 4;
};

// which block: a 64-row tile t of chunk k, batch b, head slice sl; tiles
// with more pairs go first (rank 0: the key kernel's first tile, the
// query kernel's last)
struct Item {
  int t, k, b, sl;
};
__device__ __forceinline__ Item item_of(const Params& p, bool key) {
  int i = blockIdx.x;
  const int per = p.nc * p.Bsz * p.nsl;
  Item it;
  const int rank = i / per;
  i -= rank * per;
  it.t = key ? rank : p.nt - 1 - rank;
  it.k = i % p.nc;
  i /= p.nc;
  it.b = i % p.Bsz;
  it.sl = i / p.Bsz;
  return it;
}

template <int N, int P>
__global__ void __launch_bounds__(KT, 1) ssd_bwd_key_kernel(const Params p) {
  using L = TermL<N, P>;
  using SN = tc::Swz<N>;
  using SP = tc::Swz<P>;
  extern __shared__ unsigned char smem_key[];
  unsigned char* sm = align1k(smem_key);
  const unsigned char* sB = sm + L::fn;
  unsigned char* sX = sm + L::fp;
  unsigned char* sHh = sm + L::hh;
  unsigned char* sHl = sm + L::hl;
  float* V = reinterpret_cast<float*>(sm + L::v_off);
  float *kc = V, *kd = V + TR, *kw = V + 2 * TR, *kf = V + 3 * TR;
  float* red = V + 8 * TR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32,
            t4 = lane % 4;
  const int rw = 16 * warp + lane / 4;  // this thread's rows: rw, rw + 8

  const Item it = item_of(p, true);
  const int len = chunk_rows(p, it.k), nti = (len + TR - 1) / TR;
  if (it.t >= nti) return;
  const int c0 = it.k * p.Qc, j0 = c0 + TR * it.t;
  const int R = min(TR, len - TR * it.t);
  const int b = it.b, h0 = it.sl * p.hs_n, g = h0 / p.hpg;

  tc::load_swz<N, N, TR, KT>(sm + L::fn,
                             p.Bm + b * p.bs_b + j0 * p.bs_s + g * p.bs_g,
                             p.bs_s, R);
  const bf16* Cb = p.Cm + b * p.cs_b + g * p.cs_g;
  float accB[N / 8][4];  // dB_j over the slice's heads
  zero(accB);

  for (int hh = 0; hh < p.hs_n; ++hh) {
    const int h = h0 + hh, bh = b * p.H + h;
    const float* cum = p.cum + size_t(bh) * p.S;
    const bf16* Gb = p.gy + b * p.gs_b + h * p.gs_h;
    // the query tile it of the chunk into stage st
    auto load = [&](int st, int qt) {
      unsigned char* s = sm + L::st + st * L::stage;
      const int r = c0 + TR * qt, n = min(TR, len - TR * qt);
      tc::load_swz<N, N, TR, KT>(s, Cb + r * p.cs_s, p.cs_s, n);
      tc::load_swz<P, P, TR, KT>(s + L::tN, Gb + r * p.gs_s, p.gs_s, n);
    };
    __syncthreads();  // the last head is done with sX, the state, the stages
    tc::load_swz<P, P, TR, KT>(
        sX, p.x + b * p.xs_b + j0 * p.xs_s + h * p.xs_h, p.xs_s, R);
    load(0, it.t);
    load_state<N, P>(p.dq + (size_t(bh) * p.nc + it.k) * 2 * P * N, sHh,
                     sHl);
    tc::cp_async_commit();
    const float cl = cum[c0 + len - 1];
    // rows past the chunk: cum +inf (query rows -inf), so that every
    // decay that reaches them is exp(-inf) = 0 and none is inf * 0
    if (tid < TR) {
      const bool in = tid < R;
      const float c = in ? cum[j0 + tid] : CUDART_INF_F;
      const float d =
          in ? p.dt[b * p.dts_b + (j0 + tid) * p.dts_s + h * p.dts_h] : 0.f;
      const float f = __expf(cl - c);
      kc[tid] = c;
      kd[tid] = d;
      kw[tid] = f * d;
      kf[tid] = f;
    }
    // a query tile's cum, read by threads < 64 one tile ahead of its use
    float c_nx = 0.f;
    auto fetch = [&](int qt) {
      const int i = TR * qt + tid;
      c_nx = i < len ? cum[c0 + i] : -CUDART_INF_F;
    };
    if (tid < TR) fetch(it.t);
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();

    // ---- through Dh: dx_j = w_j (B_j Dh), dw_j = x_j . B_j Dh, and this
    // head's w_j (x_j Dh^T) onto dB_j
    float dx[P / 8][4];
    float tmp[N / 8][4];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t a = SN::template kmajor<TR>(opaque(sB), kk);
      tc::wgmma_ss<P, 0, 0>(dx, a, SN::template kmajor<P>(opaque(sHh), kk),
                            kk > 0);
      tc::wgmma_ss<P, 0, 0>(dx, a, SN::template kmajor<P>(opaque(sHl), kk));
    }
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      const uint64_t a = SP::template kmajor<TR>(opaque(sX), kk);
      tc::wgmma_ss<N, 0, 1>(tmp, a, SN::template mnmajor<P>(opaque(sHh), kk),
                            kk > 0);
      tc::wgmma_ss<N, 0, 1>(tmp, a,
                            SN::template mnmajor<P>(opaque(sHl), kk));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dx);
    tc::fence_regs(tmp);
    const float2 dw = rowdot<P>(dx, sX);
    const float w0 = kw[rw], w1 = kw[rw + 8];
#pragma unroll
    for (int c = 0; c < P / 8; ++c) {
      dx[c][0] *= w0;
      dx[c][1] *= w0;
      dx[c][2] *= w1;
      dx[c][3] *= w1;
    }
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      accB[c][0] = fmaf(w0, tmp[c][0], accB[c][0]);
      accB[c][1] = fmaf(w0, tmp[c][1], accB[c][1]);
      accB[c][2] = fmaf(w1, tmp[c][2], accB[c][2]);
      accB[c][3] = fmaf(w1, tmp[c][3], accB[c][3]);
    }

    // ---- the query tiles from this one on: dx_j += M^T gy, dB_j += dS^T C
    // and the row sums of dM S L
    const float cj0 = kc[rw], cj1 = kc[rw + 8];
    const float dj0 = kd[rw], dj1 = kd[rw + 8];
    // rs: sum_i dM S L (ddt's term); rg: sum_{i > j} dM S L dt_j (dcum's):
    // the diagonal's dM S L dt enters dcum_j twice with opposite signs, so
    // both this kernel and the query kernel leave it out, and no rounding
    // of it survives the reverse cumsum
    float rs0 = 0.f, rs1 = 0.f, rg0 = 0.f, rg1 = 0.f;
    for (int qt = it.t, n = 0; qt < nti; ++qt, ++n) {
      const int st = n & 1;
      if (n > 0) __syncthreads();  // the other stage is read
      if (qt + 1 < nti) load(st ^ 1, qt + 1);
      tc::cp_async_commit();
      float* qc = V + 4 * TR + st * 2 * TR;
      if (tid < TR) {
        qc[tid] = c_nx;
        if (qt + 1 < nti) fetch(qt + 1);
      }
      tc::cp_async_wait<1>();
      tc::fence_proxy_async();
      __syncthreads();
      const unsigned char* sC = sm + L::st + st * L::stage;
      const unsigned char* sG = sC + L::tN;
      float s[8][4], m[8][4];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        tc::wgmma_ss<64, 0, 0>(s, SN::template kmajor<TR>(opaque(sB), kk),
                               SN::template kmajor<TR>(opaque(sC), kk),
                               kk > 0);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        tc::wgmma_ss<64, 0, 0>(m, SP::template kmajor<TR>(opaque(sX), kk),
                               SP::template kmajor<TR>(opaque(sG), kk),
                               kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(s);
      tc::fence_regs(m);
      // rows j (this thread's rw, rw + 8), columns i: visible where i >= j,
      // L selected to 0 elsewhere without evaluating exp
      const bool diag = qt == it.t;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * t4;
        const float2 ci = *reinterpret_cast<const float2*>(qc + col);
        const float l0 = !diag || col >= rw ? __expf(ci.x - cj0) : 0.f;
        const float l1 = !diag || col + 1 >= rw ? __expf(ci.y - cj0) : 0.f;
        const float l2 = !diag || col >= rw + 8 ? __expf(ci.x - cj1) : 0.f;
        const float l3 =
            !diag || col + 1 >= rw + 8 ? __expf(ci.y - cj1) : 0.f;
        const float sl0 = s[c][0] * l0, sl1 = s[c][1] * l1,
                    sl2 = s[c][2] * l2, sl3 = s[c][3] * l3;
        const float r0 = m[c][0] * sl0, r1 = m[c][1] * sl1,
                    r2 = m[c][2] * sl2, r3 = m[c][3] * sl3;
        rs0 += r0 + r1;
        rs1 += r2 + r3;
        rg0 = fmaf(!diag || col > rw ? r0 : 0.f, dj0, rg0);
        rg0 = fmaf(!diag || col + 1 > rw ? r1 : 0.f, dj0, rg0);
        rg1 = fmaf(!diag || col > rw + 8 ? r2 : 0.f, dj1, rg1);
        rg1 = fmaf(!diag || col + 1 > rw + 8 ? r3 : 0.f, dj1, rg1);
        s[c][0] = sl0 * dj0;
        s[c][1] = sl1 * dj0;
        s[c][2] = sl2 * dj1;
        s[c][3] = sl3 * dj1;
        m[c][0] = m[c][0] * l0 * dj0;
        m[c][1] = m[c][1] * l1 * dj0;
        m[c][2] = m[c][2] * l2 * dj1;
        m[c][3] = m[c][3] * l3 * dj1;
      }
      uint32_t fh[4][4], fl[4][4], gh[4][4], gl[4][4];
      split_frags(s, fh, fl);
      split_frags(m, gh, gl);
      tc::fence_regs(dx);
      tc::fence_regs(accB);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t gd = SP::template mnmajor<TR>(opaque(sG), kk);
        tc::wgmma_rs_t<P>(dx, fh[kk], gd);
        tc::wgmma_rs_t<P>(dx, fl[kk], gd);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t cd = SN::template mnmajor<TR>(opaque(sC), kk);
        tc::wgmma_rs_t<N>(accB, gh[kk], cd);
        tc::wgmma_rs_t<N>(accB, gl[kk], cd);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dx);
      tc::fence_regs(accB);
      tc::fence_regs(fh);
      tc::fence_regs(fl);
      tc::fence_regs(gh);
      tc::fence_regs(gl);
    }

    // ---- this head's outputs: dx_j, the key rows' scalars, the tile's
    // sum_j w_j dw_j
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
      rg0 += __shfl_xor_sync(0xffffffffu, rg0, off);
      rg1 += __shfl_xor_sync(0xffffffffu, rg1, off);
    }
    const float wd0 = w0 * dw.x, wd1 = w1 * dw.y;
    if (t4 == 0) {
      const size_t BHS = size_t(p.Bsz) * p.H * p.S;
      float* r_ddt = p.rows + size_t(bh) * p.S + j0;
      float* r_cum = r_ddt + BHS;
      if (rw < R) {
        r_ddt[rw] = fmaf(kf[rw], dw.x, rs0);
        r_cum[rw] = -(rg0 + wd0);
      }
      if (rw + 8 < R) {
        r_ddt[rw + 8] = fmaf(kf[rw + 8], dw.y, rs1);
        r_cum[rw + 8] = -(rg1 + wd1);
      }
    }
    float v = t4 == 0 ? wd0 + wd1 : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp] = v;
    bf16* dxo = p.dx + ((size_t(b) * p.S + j0) * p.H + h) * P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rw + 8 * r;
      if (row < R) {
#pragma unroll
        for (int c = 0; c < P / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(dxo + size_t(row) * p.H * P +
                                             8 * c + 2 * t4) =
              __floats2bfloat162_rn(dx[c][2 * r], dx[c][2 * r + 1]);
      }
    }
    __syncthreads();
    if (tid == 0)
      p.dcl[(size_t(bh) * p.nc + it.k) * p.nt + it.t] =
          red[0] + red[1] + red[2] + red[3];
  }

  float* out = p.pB + ((size_t(b) * p.S + j0) * p.nsl + it.sl) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw + 8 * r;
    if (row < R) {
#pragma unroll
      for (int c = 0; c < N / 8; ++c)
        *reinterpret_cast<float2*>(out + size_t(row) * p.nsl * N + 8 * c +
                                   2 * t4) =
            make_float2(accB[c][2 * r], accB[c][2 * r + 1]);
    }
  }
}

template <int N, int P>
__global__ void __launch_bounds__(KT, 1)
    ssd_bwd_query_kernel(const Params p) {
  using L = TermL<N, P>;
  using SN = tc::Swz<N>;
  using SP = tc::Swz<P>;
  extern __shared__ unsigned char smem_query[];
  unsigned char* sm = align1k(smem_query);
  const unsigned char* sC = sm + L::fn;
  unsigned char* sG = sm + L::fp;
  unsigned char* sHh = sm + L::hh;
  unsigned char* sHl = sm + L::hl;
  float* V = reinterpret_cast<float*>(sm + L::v_off);
  float *kc = V, *ke = V + TR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32,
            t4 = lane % 4;
  const int rw = 16 * warp + lane / 4;  // this thread's rows: rw, rw + 8

  const Item it = item_of(p, false);
  const int len = chunk_rows(p, it.k), nti = (len + TR - 1) / TR;
  if (it.t >= nti) return;
  const int c0 = it.k * p.Qc, i0 = c0 + TR * it.t;
  const int R = min(TR, len - TR * it.t);
  const int b = it.b, h0 = it.sl * p.hs_n, g = h0 / p.hpg;

  tc::load_swz<N, N, TR, KT>(sm + L::fn,
                             p.Cm + b * p.cs_b + i0 * p.cs_s + g * p.cs_g,
                             p.cs_s, R);
  const bf16* Bb = p.Bm + b * p.bs_b + g * p.bs_g;
  float accC[N / 8][4];  // dC_i over the slice's heads
  zero(accC);

  for (int hh = 0; hh < p.hs_n; ++hh) {
    const int h = h0 + hh, bh = b * p.H + h;
    const float* cum = p.cum + size_t(bh) * p.S;
    const bf16* Xb = p.x + b * p.xs_b + h * p.xs_h;
    const float* dtb = p.dt + b * p.dts_b + h * p.dts_h;
    // the key tile kt of the chunk into stage st
    auto load = [&](int st, int kt) {
      unsigned char* s = sm + L::st + st * L::stage;
      const int r = c0 + TR * kt, n = min(TR, len - TR * kt);
      tc::load_swz<N, N, TR, KT>(s, Bb + r * p.bs_s, p.bs_s, n);
      tc::load_swz<P, P, TR, KT>(s + L::tN, Xb + r * p.xs_s, p.xs_s, n);
    };
    __syncthreads();  // the last head is done with sG, the state, the stages
    tc::load_swz<P, P, TR, KT>(
        sG, p.gy + b * p.gs_b + i0 * p.gs_s + h * p.gs_h, p.gs_s, R);
    load(0, 0);
    load_state<N, P>(p.hq + (size_t(bh) * p.nc + it.k) * 2 * P * N, sHh,
                     sHl);
    tc::cp_async_commit();
    if (tid < TR) {
      const bool in = tid < R;
      const float c = in ? cum[i0 + tid] : -CUDART_INF_F;
      kc[tid] = c;
      ke[tid] = in ? __expf(c) : 0.f;
    }
    // a key tile's cum and dt, read by threads < 64 one tile ahead
    float c_nx = 0.f, d_nx = 0.f;
    auto fetch = [&](int kt) {
      const int j = TR * kt + tid;
      c_nx = j < len ? cum[c0 + j] : CUDART_INF_F;
      d_nx = j < len ? dtb[(c0 + j) * p.dts_s] : 0.f;
    };
    if (tid < TR) fetch(0);
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();

    // ---- through h: e_i (gy_i h^T) onto dC_i, and e_i C_i . (h gy_i)
    float tmp[N / 8][4];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      const uint64_t a = SP::template kmajor<TR>(opaque(sG), kk);
      tc::wgmma_ss<N, 0, 1>(tmp, a, SN::template mnmajor<P>(opaque(sHh), kk),
                            kk > 0);
      tc::wgmma_ss<N, 0, 1>(tmp, a,
                            SN::template mnmajor<P>(opaque(sHl), kk));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(tmp);
    const float2 yo = rowdot<N>(tmp, sC);
    const float e0 = ke[rw], e1 = ke[rw + 8];
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      accC[c][0] = fmaf(e0, tmp[c][0], accC[c][0]);
      accC[c][1] = fmaf(e0, tmp[c][1], accC[c][1]);
      accC[c][2] = fmaf(e1, tmp[c][2], accC[c][2]);
      accC[c][3] = fmaf(e1, tmp[c][3], accC[c][3]);
    }

    // ---- the key tiles up to this one: dC_i += dS B and the row sums of
    // dM S L dt_j below the diagonal
    const float ci0 = kc[rw], ci1 = kc[rw + 8];
    float rs0 = 0.f, rs1 = 0.f;
    for (int kt = 0; kt <= it.t; ++kt) {
      const int st = kt & 1;
      if (kt > 0) __syncthreads();  // the other stage is read
      if (kt + 1 <= it.t) load(st ^ 1, kt + 1);
      tc::cp_async_commit();
      float* qc = V + 4 * TR + st * 2 * TR;
      float* qd = qc + TR;
      if (tid < TR) {
        qc[tid] = c_nx;
        qd[tid] = d_nx;
        if (kt + 1 <= it.t) fetch(kt + 1);
      }
      tc::cp_async_wait<1>();
      tc::fence_proxy_async();
      __syncthreads();
      const unsigned char* sB = sm + L::st + st * L::stage;
      const unsigned char* sX = sB + L::tN;
      float s[8][4], m[8][4];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        tc::wgmma_ss<64, 0, 0>(s, SN::template kmajor<TR>(opaque(sC), kk),
                               SN::template kmajor<TR>(opaque(sB), kk),
                               kk > 0);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        tc::wgmma_ss<64, 0, 0>(m, SP::template kmajor<TR>(opaque(sG), kk),
                               SP::template kmajor<TR>(opaque(sX), kk),
                               kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(s);
      tc::fence_regs(m);
      // rows i, columns j: visible where j <= i
      const bool diag = kt == it.t;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * t4;
        const float2 cj = *reinterpret_cast<const float2*>(qc + col);
        const float2 dj = *reinterpret_cast<const float2*>(qd + col);
        const float l0 = !diag || col <= rw ? __expf(ci0 - cj.x) : 0.f;
        const float l1 = !diag || col + 1 <= rw ? __expf(ci0 - cj.y) : 0.f;
        const float l2 = !diag || col <= rw + 8 ? __expf(ci1 - cj.x) : 0.f;
        const float l3 =
            !diag || col + 1 <= rw + 8 ? __expf(ci1 - cj.y) : 0.f;
        // strictly below the diagonal (j < i), as the key kernel sums it
        rs0 = fmaf(!diag || col < rw ? m[c][0] * (s[c][0] * l0) : 0.f, dj.x,
                   rs0);
        rs0 = fmaf(!diag || col + 1 < rw ? m[c][1] * (s[c][1] * l1) : 0.f,
                   dj.y, rs0);
        rs1 = fmaf(!diag || col < rw + 8 ? m[c][2] * (s[c][2] * l2) : 0.f,
                   dj.x, rs1);
        rs1 = fmaf(!diag || col + 1 < rw + 8 ? m[c][3] * (s[c][3] * l3) : 0.f,
                   dj.y, rs1);
        m[c][0] = m[c][0] * l0 * dj.x;
        m[c][1] = m[c][1] * l1 * dj.y;
        m[c][2] = m[c][2] * l2 * dj.x;
        m[c][3] = m[c][3] * l3 * dj.y;
      }
      uint32_t fh[4][4], fl[4][4];
      split_frags(m, fh, fl);
      tc::fence_regs(accC);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = SN::template mnmajor<TR>(opaque(sB), kk);
        tc::wgmma_rs_t<N>(accC, fh[kk], bd);
        tc::wgmma_rs_t<N>(accC, fl[kk], bd);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(accC);
      tc::fence_regs(fh);
      tc::fence_regs(fl);
    }

    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    if (t4 == 0) {
      float* r_cum = p.rows + 2 * size_t(p.Bsz) * p.H * p.S +
                     size_t(bh) * p.S + i0;
      if (rw < R) r_cum[rw] = fmaf(e0, yo.x, rs0);
      if (rw + 8 < R) r_cum[rw + 8] = fmaf(e1, yo.y, rs1);
    }
  }

  float* out = p.pC + ((size_t(b) * p.S + i0) * p.nsl + it.sl) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw + 8 * r;
    if (row < R) {
#pragma unroll
      for (int c = 0; c < N / 8; ++c)
        *reinterpret_cast<float2*>(out + size_t(row) * p.nsl * N + 8 * c +
                                   2 * t4) =
            make_float2(accC[c][2 * r], accC[c][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 5. ddt and dA; 6. dB and dC
// ---------------------------------------------------------------------------

// A block per head, a warp per (batch, chunk) in turn: da = the reverse
// cumsum of dcum in the chunk (each lane a run of rows, the lanes' sums
// scanned), ddt = the direct terms + A da, dA = sum dt da in a fixed order
__global__ void __launch_bounds__(NTS) ssd_bwd_dt_kernel(const Params p) {
  __shared__ float part[NTS / 32];
  const int h = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float a_h = p.A[h];
  const size_t BHS = size_t(p.Bsz) * p.H * p.S;
  float acc = 0.f;
  for (int q = warp; q < p.Bsz * p.nc; q += NTS / 32) {
    const int b = q / p.nc, k = q - b * p.nc, bh = b * p.H + h;
    const int len = chunk_rows(p, k), c0 = k * p.Qc;
    const int nti = (len + TR - 1) / TR;
    float tail = 0.f;
    for (int q = 0; q < p.ns; ++q)
      tail += p.dT[(size_t(bh) * p.nc + k) * p.ns + q];
    for (int t = 0; t < nti; ++t)
      tail += p.dcl[(size_t(bh) * p.nc + k) * p.nt + t];
    const float* r_ddt = p.rows + size_t(bh) * p.S + c0;
    const float* r_key = r_ddt + BHS;
    const float* r_qry = r_key + BHS;
    const int per = (len + 31) / 32, lo = min(len, lane * per),
              hi = min(len, lo + per);
    auto dcum = [&](int i) {
      return r_key[i] + r_qry[i] + (i == len - 1 ? tail : 0.f);
    };
    float run = 0.f;
    for (int i = lo; i < hi; ++i) run += dcum(i);
    float suf = run;  // the runs of this lane and the later ones
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += v;
    }
    float after = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) after = 0.f;
    float s = 0.f;
    for (int i = hi - 1; i >= lo; --i) {
      after += dcum(i);
      const long long row = c0 + i;
      p.ddt[(size_t(b) * p.S + row) * p.H + h] = fmaf(a_h, after, r_ddt[i]);
      s = fmaf(p.dt[b * p.dts_b + row * p.dts_s + h * p.dts_h], after, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    acc += s;
  }
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NTS / 32; ++w) s += part[w];
    p.dA[h] = s;
  }
}

// dB (blockIdx.y 0) and dC (1): each group's slices summed in order
__global__ void __launch_bounds__(NTS) ssd_bwd_reduce_kernel(
    const Params p) {
  const float* src = blockIdx.y ? p.pC : p.pB;
  bf16* dst = blockIdx.y ? p.dC : p.dB;
  const int spg = p.nsl / p.G;
  const size_t pairs = size_t(p.Bsz) * p.S * p.G * p.N / 2;
  for (size_t e = size_t(blockIdx.x) * NTS + threadIdx.x; e < pairs;
       e += size_t(gridDim.x) * NTS) {
    const size_t i = 2 * e;
    const int n = int(i % p.N);
    const size_t r = i / p.N;  // (b, s) * G + g
    const int g = int(r % p.G);
    const float* s = src + ((r / p.G) * p.nsl + size_t(g) * spg) * p.N + n;
    float2 v = *reinterpret_cast<const float2*>(s);
    for (int q = 1; q < spg; ++q) {
      const float2 u = *reinterpret_cast<const float2*>(s + size_t(q) * p.N);
      v.x += u.x;
      v.y += u.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + i) =
        __floats2bfloat162_rn(v.x, v.y);
  }
}

constexpr int ERR_SHAPE = -1, ERR_SMEM = -2, ERR_GRID = -3;

// the dynamic shared memory a block needs, and the SM's whole carveout for
// shared memory, so that two blocks of the key and query kernels fit
int set_smem(const void* kern, int bytes, int limit) {
  if (bytes > limit) return ERR_SMEM;
  if (cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return int(err);
  return int(cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
}

template <int N, int P>
int launch(Params p, cudaStream_t s) {
  p.ns = Scan<N, P>::SPLIT;
  int dev = 0, limit = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return int(err);
  if (cudaError_t err = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return int(err);
  const long long BH = (long long)p.Bsz * p.H;
  const long long terms = (long long)p.nt * p.nc * p.Bsz * p.nsl;
  if (BH * p.nc >= 0x7fffffffLL || BH * p.ns >= 0x7fffffffLL ||
      terms >= 0x7fffffffLL)
    return ERR_GRID;

  auto state = ssd_bwd_state_kernel<N, P>;
  if (int err = set_smem(reinterpret_cast<const void*>(state),
                         StateL<N, P>::bytes, limit))
    return err;
  state<<<int(BH * p.nc), NTS, StateL<N, P>::bytes, s>>>(p);
  if (cudaError_t err = cudaGetLastError()) return int(err);

  ssd_bwd_scan_kernel<N, P><<<int(BH * p.ns), NTS, 0, s>>>(p);
  if (cudaError_t err = cudaGetLastError()) return int(err);

  auto key = ssd_bwd_key_kernel<N, P>;
  auto query = ssd_bwd_query_kernel<N, P>;
  constexpr int tb = TermL<N, P>::bytes;
  if (int err = set_smem(reinterpret_cast<const void*>(key), tb, limit))
    return err;
  if (int err = set_smem(reinterpret_cast<const void*>(query), tb, limit))
    return err;
  key<<<int(terms), KT, tb, s>>>(p);
  if (cudaError_t err = cudaGetLastError()) return int(err);
  query<<<int(terms), KT, tb, s>>>(p);
  if (cudaError_t err = cudaGetLastError()) return int(err);

  ssd_bwd_dt_kernel<<<p.H, NTS, 0, s>>>(p);
  if (cudaError_t err = cudaGetLastError()) return int(err);

  const long long pairs = (long long)p.Bsz * p.S * p.G * N / 2;
  const int blocks = int(std::min<long long>((pairs + NTS - 1) / NTS, 4096));
  ssd_bwd_reduce_kernel<<<dim3(std::max(blocks, 1), 2), NTS, 0, s>>>(p);
  return int(cudaGetLastError());
}

template <int N>
int dispatch_p(int P, const Params& p, cudaStream_t s) {
  switch (P) {
    case 16: return launch<N, 16>(p, s);
    case 32: return launch<N, 32>(p, s);
    case 64: return launch<N, 64>(p, s);
    case 128: return launch<N, 128>(p, s);
    default: return ERR_SHAPE;
  }
}

}  // namespace

extern "C" {

// One SSD backward, bf16. In: x, dt, A, Bm, Cm, gy, ghT (or null). Out:
// dx, ddt, dA, dB, dC (contiguous). Scratch, 16-byte aligned, in the order
// and sizes of the wrapper's ``bwd.scratch_numel``: f32 hs and ds (Bsz H nc
// P N each), bf16 hq and dq (Bsz H nc 2 P N each), f32 pB and pC (Bsz S (H
// / heads_per_slice) N each), cum (Bsz H S), rows (3 Bsz H S), dcl (Bsz H
// nc nt) and dT (Bsz H nc max(1, P N / 2048)); nc = ceil(S / Qc), nt =
// ceil(Qc / 64). strides[15], in elements: x (b, s, h), dt (b, s, h), Bm (b, s,
// g), Cm (b, s, g), gy (b, s, h). heads_per_slice divides H / G. Returns 0
// on success, a cudaError_t code if a launch was refused, -1 for an
// unsupported N or P, -2 when a block needs more shared memory than it
// may have, -3 when there are too many blocks for the grid.
int ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, const void* gy, const void* ghT, void* dx,
            void* ddt, void* dA, void* dB, void* dC, void* hs, void* ds,
            void* hq, void* dq, void* pB, void* pC, void* cum, void* rows,
            void* dcl, void* dT,
            int Bsz, int S, int H, int G, int Qc, int heads_per_slice, int N,
            int P, const long long* strides, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.Bm = static_cast<const bf16*>(Bm);
  p.Cm = static_cast<const bf16*>(Cm);
  p.gy = static_cast<const bf16*>(gy);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.ghT = static_cast<const float*>(ghT);
  p.dx = static_cast<bf16*>(dx);
  p.dB = static_cast<bf16*>(dB);
  p.dC = static_cast<bf16*>(dC);
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.hs = static_cast<float*>(hs);
  p.ds = static_cast<float*>(ds);
  p.hq = static_cast<bf16*>(hq);
  p.dq = static_cast<bf16*>(dq);
  p.cum = static_cast<float*>(cum);
  p.rows = static_cast<float*>(rows);
  p.dcl = static_cast<float*>(dcl);
  p.dT = static_cast<float*>(dT);
  p.pB = static_cast<float*>(pB);
  p.pC = static_cast<float*>(pC);
  long long* dst[15] = {&p.xs_b, &p.xs_s, &p.xs_h, &p.dts_b, &p.dts_s,
                        &p.dts_h, &p.bs_b, &p.bs_s, &p.bs_g, &p.cs_b,
                        &p.cs_s, &p.cs_g, &p.gs_b, &p.gs_s, &p.gs_h};
  for (int i = 0; i < 15; ++i) *dst[i] = strides[i];
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || Qc <= 0 ||
      heads_per_slice <= 0 || (H / G) % heads_per_slice)
    return ERR_SHAPE;
  p.Bsz = Bsz;
  p.S = S;
  p.H = H;
  p.G = G;
  p.hpg = H / G;
  p.N = N;
  p.Qc = Qc;
  p.nc = (S + Qc - 1) / Qc;
  p.nt = (Qc + TR - 1) / TR;
  p.hs_n = heads_per_slice;
  p.nsl = H / heads_per_slice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return dispatch_p<16>(P, p, s);
    case 32: return dispatch_p<32>(P, p, s);
    case 64: return dispatch_p<64>(P, p, s);
    case 128: return dispatch_p<128>(P, p, s);
    default: return ERR_SHAPE;
  }
}

const char* ssd_bwd_error_string(int code) {
  if (code == ERR_SHAPE) return "unsupported shape: N or P not in (16, 32, "
                                "64, 128), or a slice that does not divide "
                                "a group's heads";
  if (code == ERR_SMEM) return "a block needs more shared memory than the "
                               "card allows";
  if (code == ERR_GRID) return "too many blocks for the grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
