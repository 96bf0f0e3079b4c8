// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py::_ssd_kernel
// launched by ssd_flat. Same function, per head from a zero state, over
// chunks of Q rows (the wrapper picks Q with the reference's rule, so the
// chunk boundaries and hence every cum and decay are the same numbers):
//   cum   = inclusive cumsum of dt * A within the chunk          (f32)
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j    intra-chunk
//         + exp(cum_i) (C_i h)                                    inter-chunk
//   h    <- exp(cum_Q) h + sum_j (B_j exp(cum_Q - cum_j) dt_j)^T x_j
// Layout: the model's. x and y (Bsz, S, H, P) and dt (Bsz, S, H) at any
// strides (P contiguous), B and C per GROUP (Bsz, S, G, N) at any strides
// (N contiguous), head h reading group h / heads_per_group (the
// reference's _broadcast_groups, and K1's kv_repeat). A (H,) f32, hT
// (Bsz, H, N, P) f32. The flat per-head interface is the case Bsz = 1,
// one head per group. x, B, C and y are f32 or bf16; y is rounded to
// nearest even.
//
// What bounds it on this card: at the mamba2-2.7b prefill (Bsz = 4,
// S = 8192, H = 80, P = 64, one group of N = 128, Q = 256, bf16) the
// function reads x (335 MB), B and C once per group (17 MB) and dt, and
// writes y (335 MB) and hT: ~0.71 GB, 0.21 ms at 3.35 TB/s, against
// ~130 GFLOP (0.13 ms on the bf16 tensor cores). Bytes bound it. (The
// flat per-head interface reads B and C per head: 2.03 GB, 0.61 ms.)
//
// bf16 (the serving path): three kernels in one call, chunk-parallel.
//   (a) ssd_state_kernel, one warpgroup per (batch, head, chunk): the
//       cumsum of dt * A as a warp scan (written to a scratch row, so the
//       three kernels use the same numbers) and the chunk's own state
//       sum_j B_j^T (w_j x_j), w_j = exp(cum_Q - cum_j) dt_j, kept as its
//       transpose (w x)^T B, into scratch.
//   (b) ssd_pass_kernel: per (head, 4 state elements), the short serial
//       scan over the chunks, h_in(c+1) = exp(cum_Q(c)) h_in(c) + state(c),
//       with the loads of 8 chunks in flight at once; it writes each h_in
//       as bf16 hi + lo for (c), and hT.
//   The three run over windows of at most `win` chunks, one window after
//   another, so that the scratch (cum, chunk states, h_in) holds one
//   window, whatever S / Q is (Q = 1 for an odd S): the wrapper sizes the
//   window to a fixed budget. (b) carries h from one window to the next
//   through hT, in f32. The grids put the chunk, head and query-tile
//   indices on x, whose limit is 2^31 - 1, and the batch on y.
//   (c) ssd_out_kernel, one warpgroup per (batch, head, chunk, 64-row
//       query tile): y = exp(cum) (C h_in) first, then
//       + (C B^T . decay . dt) x over the key tiles at or below the
//       diagonal.
//   At the serving shape that is 10,240 + 40,960 blocks, in all windows,
//   where the earlier design had 320. Blocks of one (batch, chunk) run side by side (the
//   query tile is the fastest grid axis, then the head), so a group's B
//   and C tiles and a head's h_in come from device memory about once and
//   from L2 after that; nothing is broadcast to heads in memory.
//   Every product (C B^T, M x, C h, (w x)^T B) runs on the tensor cores as
//   wgmma (bf16 in, f32 accumulate) on 128-, 64- or 32-byte swizzled
//   shared-memory tiles (mma.cuh) that 16-byte cp.async fills through a
//   ring of two stages; M stays in registers as wgmma's A operand, and x,
//   B and h are read K-, M- or N-major as each product needs, so nothing
//   is transposed by hand.
//   Numerics: the reference keeps M = C B^T . decay . dt and h in f32 and
//   widens only x, B and C. A bf16 M or h would keep 8 bits. So M, h and
//   w x are each split into bf16 hi + lo (hi = bf16(v), lo = bf16(v - hi),
//   ~16 bits) and run as two products against the exact bf16 operand.
//   Above the diagonal exp(cum_i - cum_j) is exp of a positive number and
//   overflows for large |A| dt; the entry is selected to 0 there and exp
//   is never evaluated (inf * 0 would be NaN). Rows past Q of a ragged
//   tile (Q = 100, Q = 1) are zero-filled and never stored.
//   Scratch (allocated by the wrapper, one window's worth): cum, the chunk
//   states (f32) and h_in (bf16 hi + lo), ~1 GB of traffic at the serving
//   shape beyond the function's own bytes.
// float32 (the reduced models' exact-token checks, which TF32 would miss)
// keeps the CUDA-core design, ssd_f32_kernel: one block of 256 threads per
// head walks its chunks in order with h in shared memory, 64-row query
// tiles over streamed key tiles, f32 FMAs, the state update folded into
// the last query tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Strides in elements; x/y/dt are indexed (b, s, h), B/C (b, s, g).
struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* hT;
  // bf16 path, one window of at most `win` chunks
  float* cum;     // (Bsz * H, win * Q)
  float* states;  // (Bsz * H, win, P, N): chunk states^T
  bf16* hin;      // (Bsz * H, win, 2, P, N): h_in^T as bf16 hi, lo
  // nc: chunks of this call (f32) or of this window (bf16), the first
  // being chunk c0 of the sequence
  int H, hpg, Q, nc, c0, win;
  long long xs_b, xs_s, xs_h, dts_b, dts_s, dts_h, bs_b, bs_s, bs_g, cs_b,
      cs_s, cs_g, ys_b, ys_s, ys_h;
};

// ---------------------------------------------------------------------------
// float32: CUDA-core design
// ---------------------------------------------------------------------------

constexpr int TR = 64;        // rows of a query tile and of a key tile
constexpr int NT = 256;       // threads per block, a 16 x 16 grid (ty, tx)
constexpr int RT = TR / 16;   // tile rows (and score columns) per thread

// Shared memory of one block, in bytes from the start: the state, the
// masked score tile, the C, B and x tiles, then cum and dt of the chunk
// (Q floats each).
template <int N, int P>
struct Layout {
  static constexpr int NS = N + 1;   // sC/sB row stride: one word of padding
  static constexpr int MS = TR + 1;  // sM row stride
  static constexpr size_t h_off = 0;
  static constexpr size_t m_off = h_off + size_t(N) * P * sizeof(float);
  static constexpr size_t c_off = m_off + size_t(TR) * MS * sizeof(float);
  static constexpr size_t b_off = c_off + size_t(TR) * NS * sizeof(float);
  static constexpr size_t x_off = b_off + size_t(TR) * NS * sizeof(float);
  static constexpr size_t cum_off = x_off + size_t(TR) * P * sizeof(float);
  static size_t bytes(int Q) { return cum_off + 2 * size_t(Q) * sizeof(float); }
};

// rows [0, rows) of a source with row stride `ld` (W elements a row) into
// a TR-row tile of row stride `stride`; the rows past `rows` are zero
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          long long ld, int rows) {
  for (int e = threadIdx.x; e < TR * W; e += NT) {
    const int r = e / W, col = e % W;
    dst[r * stride + col] = r < rows ? src[r * ld + col] : 0.f;
  }
}

template <int N, int P>
__global__ void __launch_bounds__(NT) ssd_f32_kernel(const Args a) {
  using L = Layout<N, P>;
  constexpr int NA = N / 16;  // state rows per thread: ty + 16 * a
  constexpr int PB = P / 16;  // state / output columns per thread: tx + 16 * b
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* sH = reinterpret_cast<float*>(smem_f32 + L::h_off);
  float* sM = reinterpret_cast<float*>(smem_f32 + L::m_off);
  float* sC = reinterpret_cast<float*>(smem_f32 + L::c_off);
  float* sB = reinterpret_cast<float*>(smem_f32 + L::b_off);
  float* sX = reinterpret_cast<float*>(smem_f32 + L::x_off);
  float* sCum = reinterpret_cast<float*>(smem_f32 + L::cum_off);
  const int Q = a.Q;
  float* sDt = sCum + Q;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y, g = h / a.hpg;
  const float* xb = static_cast<const float*>(a.x) + b * a.xs_b + h * a.xs_h;
  const float* Bb = static_cast<const float*>(a.Bm) + b * a.bs_b + g * a.bs_g;
  const float* Cb = static_cast<const float*>(a.Cm) + b * a.cs_b + g * a.cs_g;
  const float* dtb = a.dt + b * a.dts_b + h * a.dts_h;
  float* yb = static_cast<float*>(a.y) + b * a.ys_b + h * a.ys_h;
  const float a_h = a.A[h];

  for (int e = tid; e < N * P; e += NT) sH[e] = 0.f;

  const int n_tiles = (Q + TR - 1) / TR;
  for (int c = 0; c < a.nc; ++c) {
    const long long s0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with sH, sCum, sDt
    for (int i = tid; i < Q; i += NT) sDt[i] = dtb[(s0 + i) * a.dts_s];
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
      load_tile<N>(sC, L::NS, Cb + (s0 + i0) * a.cs_s, a.cs_s,
                   min(TR, Q - i0));
      __syncthreads();

      // inter-chunk: acc = exp(cum_i) * (C_i h)
      float acc[RT][PB];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int bb = 0; bb < PB; ++bb) acc[r][bb] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RT], hv[PB];
#pragma unroll
        for (int r = 0; r < RT; ++r) cv[r] = sC[(ty + 16 * r) * L::NS + n];
#pragma unroll
        for (int bb = 0; bb < PB; ++bb) hv[bb] = sH[n * P + tx + 16 * bb];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int bb = 0; bb < PB; ++bb) acc[r][bb] += cv[r] * hv[bb];
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + ty + 16 * r;
        const float gi = i < Q ? expf(sCum[i]) : 0.f;
#pragma unroll
        for (int bb = 0; bb < PB; ++bb) acc[r][bb] *= gi;
      }

      // the last query tile also carries the state to the next chunk:
      // hacc = exp(cum_Q) h + sum over the chunk's key rows (below)
      float hacc[NA][PB];
      if (last) {
        const float gl = expf(cum_last);
#pragma unroll
        for (int aa = 0; aa < NA; ++aa)
#pragma unroll
          for (int bb = 0; bb < PB; ++bb)
            hacc[aa][bb] = gl * sH[(ty + 16 * aa) * P + tx + 16 * bb];
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * TR;
        const int nk = min(TR, Q - j0);
        __syncthreads();  // readers of the previous sB, sX, sM (and sH) done
        load_tile<N>(sB, L::NS, Bb + (s0 + j0) * a.bs_s, a.bs_s, nk);
        load_tile<P>(sX, P, xb + (s0 + j0) * a.xs_s, a.xs_s, nk);
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
            cv[r] = sC[(ty + 16 * r) * L::NS + n];
            bv[r] = sB[(tx + 16 * r) * L::NS + n];
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
          for (int bb = 0; bb < PB; ++bb) xv[bb] = sX[j * P + tx + 16 * bb];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int bb = 0; bb < PB; ++bb) acc[r][bb] += mv[r] * xv[bb];
        }

        // state update: hacc += (B exp(cum_Q - cum) dt)^T x over this tile
        if (last) {
          for (int j = 0; j < nk; ++j) {
            const float w = expf(cum_last - sCum[j0 + j]) * sDt[j0 + j];
            float bv[NA], xv[PB];
#pragma unroll
            for (int aa = 0; aa < NA; ++aa)
              bv[aa] = sB[j * L::NS + ty + 16 * aa] * w;
#pragma unroll
            for (int bb = 0; bb < PB; ++bb) xv[bb] = sX[j * P + tx + 16 * bb];
#pragma unroll
            for (int aa = 0; aa < NA; ++aa)
#pragma unroll
              for (int bb = 0; bb < PB; ++bb) hacc[aa][bb] += bv[aa] * xv[bb];
          }
        }
      }

#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < Q) {
#pragma unroll
          for (int bb = 0; bb < PB; ++bb)
            yb[(s0 + i) * a.ys_s + tx + 16 * bb] = acc[r][bb];
        }
      }
      // every thread read sH (inter-chunk term) before the first key
      // tile's barrier, so the owners may overwrite it now
      if (last) {
#pragma unroll
        for (int aa = 0; aa < NA; ++aa)
#pragma unroll
          for (int bb = 0; bb < PB; ++bb)
            sH[(ty + 16 * aa) * P + tx + 16 * bb] = hacc[aa][bb];
      }
    }
  }
  __syncthreads();
  float* hb = a.hT + ((size_t)b * a.H + h) * N * P;
  for (int e = tid; e < N * P; e += NT) hb[e] = sH[e];
}

// ---------------------------------------------------------------------------
// bf16: chunk-parallel, tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int KT = 64;    // rows of a query or key tile
constexpr int TNT = 128;  // threads per block: one warpgroup

// Shared memory of (a) and (c), in bytes. Every bf16 tile is swizzled for
// wgmma (mma.cuh, tc::Swz); x and w x are padded to PP >= 64 columns so
// that their wgmma M or N is whole warpgroup rows. (a): [stage 0][stage 1]
// [w x hi][w x lo][cum][dt], a stage being a B tile (KT x N) and an x tile
// (KT x PP). (c): [C tile (KT x N)][stage 0][stage 1][cum][dt], the h_in^T
// hi and lo tiles (PP x N each) in stage 1's place (and beyond) until the
// inter-chunk term is done.
template <int N, int P>
struct Tiles {
  static constexpr int PP = P < 64 ? 64 : P;
  using SN = tc::Swz<N>;
  using SP = tc::Swz<PP>;
  static constexpr size_t b_tile = size_t(KT) * N * sizeof(bf16);
  static constexpr size_t x_tile = size_t(KT) * PP * sizeof(bf16);
  static constexpr size_t stage = b_tile + x_tile;
  static constexpr size_t h_tile = size_t(PP) * N * sizeof(bf16);
  static size_t state_bytes(int Q) {
    return 2 * stage + 2 * x_tile + 2 * size_t(Q) * sizeof(float);
  }
  static constexpr size_t ring = stage + (stage > 2 * h_tile ? stage
                                                              : 2 * h_tile);
  static size_t out_bytes(int Q) {
    return b_tile + ring + 2 * size_t(Q) * sizeof(float);
  }
};

// byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r in a
// swizzled R x WP tile
template <int WP, int R>
__device__ __forceinline__ int chunk_off(int r, int c) {
  using S = tc::Swz<WP>;
  const int off = r * S::RB + (c % (S::RB / 16)) * 16;
  return (c / (S::RB / 16)) * R * S::RB + (off ^ (((off >> 7) & S::MASK) << 4));
}

template <int N, int P>
__device__ __forceinline__ void load_key_tile(const Args& a,
                                              unsigned char* stage,
                                              const bf16* Bb, const bf16* xb,
                                              long long j0, int rows) {
  using T = Tiles<N, P>;
  tc::load_swz<N, N, KT, TNT>(stage, Bb + j0 * a.bs_s, a.bs_s, rows);
  tc::load_swz<P, T::PP, KT, TNT>(stage + T::b_tile, xb + j0 * a.xs_s,
                                  a.xs_s, rows);
}

// (a) per (batch, head, chunk): cum, and the chunk's state, kept as its
// transpose state^T (P x N) = (w x)^T B: one warpgroup, PP / 64 wgmma row
// blocks, A = (w x)^T and B = B read M- and N-major from the key tiles
template <int N, int P>
__global__ void __launch_bounds__(TNT)
ssd_state_kernel(const Args a) {
  using T = Tiles<N, P>;
  using SN = typename T::SN;
  using SP = typename T::SP;
  constexpr int PP = T::PP, MB = PP / 64;
  extern __shared__ __align__(1024) unsigned char smem_state[];
  unsigned char* sStage = smem_state;
  unsigned char* sWh = smem_state + 2 * T::stage;
  unsigned char* sWl = sWh + T::x_tile;
  float* sCum = reinterpret_cast<float*>(sWl + T::x_tile);
  const int Q = a.Q;
  float* sDt = sCum + Q;

  const int c = blockIdx.x % a.nc, h = blockIdx.x / a.nc, b = blockIdx.y;
  const int g = h / a.hpg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const long long s0 = (long long)(a.c0 + c) * Q;
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.xs_b + h * a.xs_h +
                   s0 * a.xs_s;
  const bf16* Bb = static_cast<const bf16*>(a.Bm) + b * a.bs_b +
                   g * a.bs_g + s0 * a.bs_s;
  const float* dtb = a.dt + b * a.dts_b + h * a.dts_h + s0 * a.dts_s;
  const size_t bh = (size_t)b * a.H + h;

  const int nkt = (Q + KT - 1) / KT;
  load_key_tile<N, P>(a, sStage, Bb, xb, 0, min(KT, Q));
  tc::cp_async_commit();

  for (int i = threadIdx.x; i < Q; i += TNT) sDt[i] = dtb[i * a.dts_s];
  __syncthreads();
  if (warp == 0) {
    // inclusive cumsum of dt * A: each lane sums a run of rows in order,
    // then the lanes' totals are scanned with shuffles
    const float a_h = a.A[h];
    const int per = (Q + 31) / 32;
    const int lo = min(Q, lane * per), hi = min(Q, lo + per);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) run += sDt[i] * a_h;
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    run = incl - run;  // the rows before this lane's run
    for (int i = lo; i < hi; ++i) {
      run += sDt[i] * a_h;
      sCum[i] = run;
    }
  }
  __syncthreads();
  float* cum = a.cum + (bh * a.win + c) * Q;
  for (int i = threadIdx.x; i < Q; i += TNT) cum[i] = sCum[i];
  const float cum_last = sCum[Q - 1];

  float acc[MB][N / 8][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const unsigned char* sB = sStage + (kt % 2) * T::stage;
    const unsigned char* sX = sB + T::b_tile;
    if (kt + 1 < nkt) {
      const int j1 = (kt + 1) * KT;
      load_key_tile<N, P>(a, sStage + ((kt + 1) % 2) * T::stage, Bb, xb, j1,
                          min(KT, Q - j1));
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    // w x, w_j = exp(cum_Q - cum_j) dt_j (0 past Q), split hi + lo, 8
    // columns at a time in the x tile's own swizzled layout
    for (int e = threadIdx.x; e < KT * PP / 8; e += TNT) {
      const int r = e / (PP / 8), col = e % (PP / 8);
      const int j = kt * KT + r;
      const float w = j < Q ? __expf(cum_last - sCum[j]) * sDt[j] : 0.f;
      const int off = chunk_off<PP, KT>(r, col);
      const uint4 xv = *reinterpret_cast<const uint4*>(sX + off);
      const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[q]));
        tc::split_bf16(w * f.x, w * f.y, hi[q], lo[q]);
      }
      *reinterpret_cast<uint4*>(sWh + off) = make_uint4(hi[0], hi[1], hi[2],
                                                        hi[3]);
      *reinterpret_cast<uint4*>(sWl + off) = make_uint4(lo[0], lo[1], lo[2],
                                                        lo[3]);
    }
    tc::fence_proxy_async();
    __syncthreads();

    // state^T[p][n] += sum_j (w x)[j][p] B[j][n]
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const uint64_t bd = SN::template mnmajor<KT>(sB, kk);
        tc::wgmma_ss<N, 1, 1>(acc[m], SP::template mnmajor<KT>(sWh, kk, 64 * m),
                              bd);
        tc::wgmma_ss<N, 1, 1>(acc[m], SP::template mnmajor<KT>(sWl, kk, 64 * m),
                              bd);
      }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    __syncthreads();  // this stage and the w tiles are read
  }

  float* out = a.states + (bh * a.win + c) * N * P;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * m + warp * 16 + gr + 8 * r;  // p
      if (row < P) {
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
          *reinterpret_cast<float2*>(out + row * N + n * 8 + 2 * t4) =
              make_float2(acc[m][n][2 * r], acc[m][n][2 * r + 1]);
      }
    }
}

// (b) per (head, 4 state elements): the serial scan over the window's
// chunks, from the chunk states to each chunk's incoming state h_in,
// written as bf16 hi + lo for (c) (both as transposes, P x N). It starts
// from the state the previous window left in hT (zero for the first) and
// leaves its own there. The loads of PASS_C chunks are issued together, so
// the scan waits on memory once per PASS_C chunks and not once per chunk.
constexpr int PASS_NT = 256;
constexpr int PASS_C = 8;

__global__ void __launch_bounds__(PASS_NT)
ssd_pass_kernel(const Args a, int N_, int NP_) {
  const int e = 4 * (blockIdx.y * PASS_NT + threadIdx.x);
  if (e >= NP_) return;
  const size_t bh = blockIdx.x;
  const float* cum = a.cum + bh * a.win * a.Q + (a.Q - 1);
  const float* st = a.states + bh * a.win * NP_ + e;
  bf16* hin = a.hin + bh * a.win * 2 * NP_ + e;
  // the chunk states are state^T (P x N); hT is (N x P)
  const int P_ = NP_ / N_;
  float* hT = a.hT + bh * NP_;
  float hs[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.c0 > 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) hs[q] = hT[((e + q) % N_) * P_ + (e + q) / N_];
  }
  float4 hv = make_float4(hs[0], hs[1], hs[2], hs[3]);
  for (int k0 = 0; k0 < a.nc; k0 += PASS_C) {
    float4 sv[PASS_C];
    float dec[PASS_C];
#pragma unroll
    for (int j = 0; j < PASS_C; ++j)
      if (k0 + j < a.nc) {
        sv[j] = *reinterpret_cast<const float4*>(st + (size_t)(k0 + j) * NP_);
        dec[j] = cum[(size_t)(k0 + j) * a.Q];
      }
#pragma unroll
    for (int j = 0; j < PASS_C; ++j)
      if (k0 + j < a.nc) {
        uint32_t hi0, lo0, hi1, lo1;
        tc::split_bf16(hv.x, hv.y, hi0, lo0);
        tc::split_bf16(hv.z, hv.w, hi1, lo1);
        bf16* hp = hin + (size_t)(k0 + j) * 2 * NP_;
        *reinterpret_cast<uint2*>(hp) = make_uint2(hi0, hi1);
        *reinterpret_cast<uint2*>(hp + NP_) = make_uint2(lo0, lo1);
        const float gc = expf(dec[j]);
        hv = make_float4(gc * hv.x + sv[j].x, gc * hv.y + sv[j].y,
                         gc * hv.z + sv[j].z, gc * hv.w + sv[j].w);
      }
  }
  hs[0] = hv.x, hs[1] = hv.y, hs[2] = hv.z, hs[3] = hv.w;
#pragma unroll
  for (int q = 0; q < 4; ++q) hT[((e + q) % N_) * P_ + (e + q) / N_] = hs[q];
}

// (c) per (batch, head, chunk, query tile): y, one warpgroup of 64 rows
template <int N, int P>
__global__ void __launch_bounds__(TNT, 3)
ssd_out_kernel(const Args a) {
  using T = Tiles<N, P>;
  using SN = typename T::SN;
  using SP = typename T::SP;
  constexpr int PP = T::PP;
  constexpr int NO = PP / 8;  // output n-tiles
  extern __shared__ __align__(1024) unsigned char smem_out[];
  unsigned char* sC = smem_out;
  unsigned char* sStage = smem_out + T::b_tile;
  float* sCum = reinterpret_cast<float*>(sStage + T::ring);
  const int Q = a.Q;
  float* sDt = sCum + Q;

  const int nqt = (Q + KT - 1) / KT;
  const int qt = blockIdx.x % nqt, h = blockIdx.x / nqt % a.H;
  const int c = blockIdx.x / nqt / a.H, b = blockIdx.y;
  const int g = h / a.hpg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const int i0 = qt * KT, nq = min(KT, Q - i0);
  const long long s0 = (long long)(a.c0 + c) * Q;
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.xs_b + h * a.xs_h +
                   s0 * a.xs_s;
  const bf16* Bb = static_cast<const bf16*>(a.Bm) + b * a.bs_b +
                   g * a.bs_g + s0 * a.bs_s;
  const bf16* Cb = static_cast<const bf16*>(a.Cm) + b * a.cs_b +
                   g * a.cs_g + (s0 + i0) * a.cs_s;
  const float* dtb = a.dt + b * a.dts_b + h * a.dts_h + s0 * a.dts_s;
  const size_t bh = (size_t)b * a.H + h;

  // the C tile, key tile 0 and (after the first chunk) h_in^T hi and lo
  unsigned char* sHh = sStage + T::stage;
  unsigned char* sHl = sHh + T::h_tile;
  const bool carry = a.c0 + c > 0;
  tc::load_swz<N, N, KT, TNT>(sC, Cb, a.cs_s, nq);
  load_key_tile<N, P>(a, sStage, Bb, xb, 0, min(KT, Q));
  if (carry) {
    const bf16* hin = a.hin + (bh * a.win + c) * 2 * P * N;
    tc::load_swz<N, N, PP, TNT>(sHh, hin, N, P);
    tc::load_swz<N, N, PP, TNT>(sHl, hin + P * N, N, P);
  }
  tc::cp_async_commit();
  const float* cum = a.cum + (bh * a.win + c) * Q;
  for (int i = threadIdx.x; i < i0 + nq; i += TNT) {
    sCum[i] = cum[i];
    sDt[i] = dtb[i * a.dts_s];
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int row0 = i0 + warp * 16 + gr;  // rows row0 and row0 + 8

  // inter-chunk first: y = exp(cum_i) (C h_in); the first chunk's h_in is 0
  if (carry) {
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t cd = SN::template kmajor<KT>(sC, kk);
      tc::wgmma_ss<PP, 0, 0>(acc, cd, SN::template kmajor<PP>(sHh, kk));
      tc::wgmma_ss<PP, 0, 0>(acc, cd, SN::template kmajor<PP>(sHl, kk));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      const float gi = i < Q ? __expf(sCum[i]) : 0.f;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= gi;
        acc[n][2 * r + 1] *= gi;
      }
    }
    __syncthreads();  // the h tiles are read: stage 1 may be loaded
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const unsigned char* sB = sStage + (kt % 2) * T::stage;
    const unsigned char* sX = sB + T::b_tile;
    if (kt < qt) {
      const int j1 = (kt + 1) * KT;
      load_key_tile<N, P>(a, sStage + ((kt + 1) % 2) * T::stage, Bb, xb, j1,
                          min(KT, Q - j1));
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();

    // scores C B^T of the 64 rows and the tile's 64 keys
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      tc::wgmma_ss<KT, 0, 0>(s, SN::template kmajor<KT>(sC, kk),
                             SN::template kmajor<KT>(sB, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();

    // M = scores . exp(cum_i - cum_j) . dt_j, selected to 0 above the
    // diagonal (only the diagonal tile has such entries) and past Q
    const int j0 = kt * KT;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + 8 * (e >> 1);
        const int j = j0 + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = (i < Q && (kt < qt || j <= i))
                      ? s[n][e] * __expf(sCum[i] - sCum[j]) * sDt[j]
                      : 0.f;
      }

    // y += M x, M as hi + lo A fragments straight from the registers
    uint32_t ah[KT / 16][4], al[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      tc::split_bf16(s[2 * kk][0], s[2 * kk][1], ah[kk][0], al[kk][0]);
      tc::split_bf16(s[2 * kk][2], s[2 * kk][3], ah[kk][1], al[kk][1]);
      tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[kk][2],
                     al[kk][2]);
      tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[kk][3],
                     al[kk][3]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t xd = SP::template mnmajor<KT>(sX, kk);
      tc::wgmma_rs_t<PP>(acc, ah[kk], xd);
      tc::wgmma_rs_t<PP>(acc, al[kk], xd);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    __syncthreads();  // this stage is read; the next load may refill it
  }

  bf16* yb = static_cast<bf16*>(a.y) + b * a.ys_b + h * a.ys_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i < Q) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (n * 8 < P)
          *reinterpret_cast<__nv_bfloat162*>(yb + (s0 + i) * a.ys_s + n * 8 +
                                             2 * t4) =
              __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

int smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return int(err);
}

int set_smem(const void* kern, size_t bytes) {
  return int(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

template <int N, int P>
int launch(int dtype, Args a, int Bsz, cudaStream_t stream) {
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  const int nqt = (a.Q + KT - 1) / KT;
  if (Bsz > 65535 || (long long)nqt * a.H * a.win > 0x7fffffffLL) return -3;
  if (dtype == 0) {
    const size_t smem = Layout<N, P>::bytes(a.Q);
    if (smem > size_t(limit)) return -2;
    auto kern = ssd_f32_kernel<N, P>;
    if (int err = set_smem(reinterpret_cast<const void*>(kern), smem))
      return err;
    kern<<<dim3(a.H, Bsz), NT, smem, stream>>>(a);
    return int(cudaGetLastError());
  }
  using T = Tiles<N, P>;
  const size_t smem_a = T::state_bytes(a.Q), smem_c = T::out_bytes(a.Q);
  if (smem_a > size_t(limit) || smem_c > size_t(limit)) return -2;
  auto ka = ssd_state_kernel<N, P>;
  auto kc = ssd_out_kernel<N, P>;
  if (int err = set_smem(reinterpret_cast<const void*>(ka), smem_a))
    return err;
  if (int err = set_smem(reinterpret_cast<const void*>(kc), smem_c))
    return err;
  const int nc = a.nc;
  for (a.c0 = 0; a.c0 < nc; a.c0 += a.win) {
    a.nc = min(a.win, nc - a.c0);
    ka<<<dim3(a.nc * a.H, Bsz), TNT, smem_a, stream>>>(a);
    if (cudaError_t err = cudaGetLastError()) return int(err);
    ssd_pass_kernel<<<dim3(Bsz * a.H, (N * P / 4 + PASS_NT - 1) / PASS_NT),
                      PASS_NT, 0, stream>>>(a, N, N * P);
    if (cudaError_t err = cudaGetLastError()) return int(err);
    kc<<<dim3(nqt * a.H * a.nc, Bsz), TNT, smem_c, stream>>>(a);
    if (cudaError_t err = cudaGetLastError()) return int(err);
  }
  return 0;
}

template <int N>
int dispatch_p(int P, int dtype, const Args& a, int Bsz, cudaStream_t s) {
  switch (P) {
    case 16: return launch<N, 16>(dtype, a, Bsz, s);
    case 32: return launch<N, 32>(dtype, a, Bsz, s);
    case 64: return launch<N, 64>(dtype, a, Bsz, s);
    case 128: return launch<N, 128>(dtype, a, Bsz, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// One SSD forward: x, dt, A, Bm, Cm in; y and hT out; cum, states and hin
// are scratch for the bf16 path, one window of `window` chunks (cum
// (Bsz * H, window * Q) and states (Bsz * H, window, P, N) f32, hin
// (Bsz * H, window, 2, P, N) bf16; unused by the f32 path). strides[15],
// in elements: x (b, s, h), dt (b, s, h), Bm (b, s, g), Cm (b, s, g), y
// (b, s, h). dtype: 0 = float32, 1 = bfloat16. S must be a multiple of Q.
// Returns 0 on success, a cudaError_t code if a launch was refused, -1 for
// an unsupported N or P, -2 when a chunk of Q rows needs more shared
// memory than a block may have, -3 when a grid would be too large.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, void* y, void* hT, void* cum, void* states,
            void* hin, int dtype, int Bsz, int S, int H, int heads_per_group,
            int Q, int window, int N, int P, const long long* strides,
            void* stream) {
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.y = y;
  a.hT = static_cast<float*>(hT);
  a.cum = static_cast<float*>(cum);
  a.states = static_cast<float*>(states);
  a.hin = static_cast<bf16*>(hin);
  a.H = H;
  a.hpg = heads_per_group;
  a.Q = Q;
  a.nc = S / Q;
  a.c0 = 0;
  a.win = window < 1 ? 1 : window;
  long long* dst[15] = {&a.xs_b, &a.xs_s, &a.xs_h, &a.dts_b, &a.dts_s,
                        &a.dts_h, &a.bs_b, &a.bs_s, &a.bs_g, &a.cs_b,
                        &a.cs_s, &a.cs_g, &a.ys_b, &a.ys_s, &a.ys_h};
  for (int i = 0; i < 15; ++i) *dst[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return dispatch_p<16>(P, dtype, a, Bsz, s);
    case 32: return dispatch_p<32>(P, dtype, a, Bsz, s);
    case 64: return dispatch_p<64>(P, dtype, a, Bsz, s);
    case 128: return dispatch_p<128>(P, dtype, a, Bsz, s);
    default: return -1;
  }
}

const char* ssd_error_string(int code) {
  if (code == -1) return "unsupported N or P (16, 32, 64 or 128)";
  if (code == -2) return "chunk too long for the block's shared memory";
  if (code == -3) return "grid too large (batch above 65535 or too many "
                         "blocks in a window)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
