// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py::_ssd_kernel
// launched by ssd_flat. Same function, per head from a zero state, over
// chunks of Q rows (the wrapper picks Q with the reference's rule):
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
// writes y (335 MB) and hT: ~0.71 GB, 0.21 ms at 3.35 TB/s. The tensor
// work a chunked kernel does is larger than the function's ~130 GFLOP:
// per (batch, head, 256-row chunk) C B^T over the 10 visible 64 x 64 tile
// pairs (10.5 MFLOP), M x, C h and (w x)^T B with M, h and w x each as bf16
// hi + lo (10.5, 8.4 and 8.4 MFLOP), ~386 GFLOP in all, 0.39 ms at the
// 989 TFLOP/s bf16 peak. The hi + lo split keeps M, h and w x at ~16 bits,
// as the reference's f32 does; so the tensor work, not the bytes, is the
// floor. (This kernel's items of 128 rows see 6 pairs per 256 rows, not
// 10: ~301 GFLOP, 0.30 ms. The flat per-head interface reads B and C per
// head: 2.03 GB, 0.61 ms.)
//
// bf16 (the serving path): ssd_chain_kernel, one chained pass.
//   * Work items. An item is a run of at most 128 rows of one (batch,
//     head): part of a chunk (Q = 256: two items a chunk), one or more
//     whole chunks (Q <= 128; many for short chunks, Q = 1 for an odd S).
//     cum is always chunk-local, the reference's chunk rule: an item that
//     is part of a chunk scans the whole chunk, in the same order, and
//     keeps its rows and the sum before them (cum_base); where an item
//     holds several whole chunks cum runs on across them, which changes
//     only the rounding. Blocks are persistent, one per SM, and take items
//     from a ticket counter in device memory in item-major order, so that
//     the item before (b, i, h) in its head always holds a smaller ticket.
//   * The chain. An item computes its own state (w x)^T B and, in the
//     other consumer, the intra-chunk output of its second query tile
//     first; then it waits (ld.acquire) for the flag of the item before
//     it, reads that item's state h_in (f32, from L2), publishes
//     h_out = exp(cum_last - cum_base) h_in + state (st.release of its own
//     flag) and only then adds the inter-chunk term exp(cum - cum_base)
//     C h_in. The carried state lives in two f32 slots per (batch, head),
//     used in turn: an item reads slot (i - 1) mod 2 before it publishes
//     slot i mod 2, and the last writes hT. A block waits only on a
//     smaller ticket, held by a block that is running and waits on nothing
//     later, so the pass cannot deadlock, whatever the occupancy. Scratch
//     is the slots, the flags and the ticket, O(Bsz H N P) whatever S is;
//     a small ssd_reset_kernel zeroes the flags and the ticket on the
//     stream first. Every spin is bounded and traps, so a fault fails the
//     next synchronize instead of hanging the card.
//   * Warp specialisation, 288 threads. A producer warp takes the tickets,
//     computes the item's cumsum (a warp scan) and the decay vectors it
//     needs, and issues TMA loads through 4-D tensor maps over the model
//     layout (x (P, H, S, Bsz), B and C (N, G, S, Bsz), the two middle dims
//     in stride order) into the layout wgmma reads (tc::Swz: a 128-byte
//     swizzled box is 64 columns, so an N = 128 row is two boxes; N = 16
//     rows take the 32-byte swizzle). An item's C, B and x (two 64-row
//     tiles each) sit in one of two stages (one at N = P = 128), each tile
//     behind its own full and empty mbarrier, so the next item's tiles
//     load while this one is computed. Two consumer warpgroups take one
//     query tile each: consumer 1 the state and the chain step, then tile
//     0; consumer 0 tile 1's pairs, then, once h_in is ready, its
//     inter-chunk term (at P = 128 each takes half the state's rows and
//     one tile). 288 threads leave 168 registers a thread, which the
//     consumers fit without a hand-over: setmaxnreg did not raise ptxas's
//     budget past 168, and a second score buffer or a second held output
//     tile spilled (ptxas then serialised every wgmma of the kernel).
//   * Consumers. C B^T (C and B from shared memory) for the next key tile
//     is issued with this one's M x; M goes straight from registers into
//     M x as bf16 hi + lo A fragments. Off the diagonal the decay is
//     exp(cum_i - cum_i0) exp(cum_i0 - cum_j) dt_j, both factors <= 1 and
//     computed once per item by the producer; on the diagonal tile it is
//     exp(cum_i - cum_j) dt_j, selected to 0 above the diagonal without
//     evaluating exp (inf * 0 would be NaN). (w x)^T is the register A
//     operand of the state product, read from the x tile by ldmatrix.trans
//     and split hi + lo; B is read N-major. C h_in reads h_in^T as bf16 hi
//     + lo from shared memory, split there by the consumer that loaded it.
//     Rows past an item's end are zero-filled by TMA or masked, and never
//     stored.
//   * What holds it back (see PERF.md): each consumer's work is a serial
//     chain of wgmma, wait, scale, split; with two warpgroups an SM issues
//     well under one instruction a clock, and neither the loads nor the
//     chain's waits are a large share.
//
// float32 (the reduced models' exact-token checks, which TF32 would miss)
// keeps the CUDA-core design, ssd_f32_kernel: one block of 256 threads per
// head walks its chunks in order with h in shared memory, 64-row query
// tiles over streamed key tiles, f32 FMAs, the state update folded into
// the last query tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The float32 kernel's arguments. Strides in elements; x/y/dt are indexed
// (b, s, h), B/C (b, s, g).
struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* hT;
  int H, hpg, Q, nc;
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
// bf16: one chained pass, a TMA producer and two wgmma consumers
// ---------------------------------------------------------------------------

constexpr int NTH = 288;            // two consumer warpgroups, a producer warp
constexpr int IR = 128;             // rows of an item, at most
constexpr int NQT = IR / 64;        // its 64-row tiles
constexpr int BAR_H = 1;            // named barriers: h_in ready (256),
constexpr int BAR_OWN = 2;          // and one per consumer (128): 2, 3
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on the H100

// Shared memory of a block, in bytes from a 1024-byte aligned start: NST
// stages of an item's tiles, each [C (IR x N)][B (IR x N)][x (IR x P)]
// swizzled (tc::Swz); h_in^T as bf16 hi and lo (P x N each); two buffers
// of the item's vectors; the mbarriers.
template <int N, int P>
struct Chain {
  using SN = tc::Swz<N>;
  using SP = tc::Swz<P>;
  static constexpr int MB = P > 64 ? 2 : 1;   // 64-row blocks of h^T
  static constexpr int AN = N * 2 / SN::RB;   // boxes a row of B, C
  static constexpr int AP = P * 2 / SP::RB;   // ... of x
  static constexpr int b_off = IR * N * 2;
  static constexpr int x_off = 2 * IR * N * 2;
  static constexpr int stage = x_off + IR * P * 2;
  static constexpr int k_bytes = 64 * (N + P) * 2;  // a key tile: B and x
  static constexpr int c_bytes = 64 * N * 2;        // a C tile
  static constexpr int h_tile = P * N * 2;
  // the vectors of an item, f32 a row: cum (G), dt, w = exp(G_last - G) dt,
  // e = exp(G - G_base), a = exp(G - G_i0) (i0 the row's query tile
  // start), then bd = exp(G_64 - G_j) dt_j for the key rows j of tile 0;
  // then exp(G_last - G_base) and the ticket
  static constexpr int V_GL = 5 * IR + 64, V_T = V_GL + 1;
  static constexpr int vec = (V_T + 4) / 4 * 4 * 4;  // bytes, 16-aligned
  static constexpr int fixed = 2 * h_tile + 2 * vec;
  static constexpr int NST =
      1024 + 2 * stage + fixed + 8 * (8 * NQT + 5) <= SMEM_LIMIT ? 2 : 1;
  static constexpr int h_off = NST * stage;
  static constexpr int v_off = h_off + 2 * h_tile;
  static constexpr int bar_off = v_off + 2 * vec;
  static constexpr int bytes = 1024 + bar_off + 8 * (4 * NQT * NST + 5);
  // barriers: per stage full_k, empty_k, full_c, empty_c (NQT each), then
  // full_g, empty_g (one per vector buffer), empty_h
  static constexpr int FULL_K = 0, EMPTY_K = NQT, FULL_C = 2 * NQT,
                       EMPTY_C = 3 * NQT;
  static constexpr int FULL_G = 4 * NQT * NST, EMPTY_G = FULL_G + 2,
                       EMPTY_H = FULL_G + 4;
};

struct ChainParams {
  const float* dt;
  const float* A;
  bf16* y;
  float* hT;
  float* slots;       // (Bsz * H, 2, P, N): the carried state, transposed
  int* flags;         // Bsz * H flags, then the ticket counter
  long long dts_b, dts_s, dts_h, ys_b, ys_s, ys_h;
  int S, H, hpg, BH, Q;
  int L;              // rows of an item (see item_rows)
  int ipc;            // items a chunk, where an item is a part of one
  int ni;             // items of a head
  int total;          // items in all, ni * BH
  int x_hf, bc_hf;    // 1: the map's dim 1 is the head (group), 0: the row
};

// byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r in a
// swizzled R x WP tile
template <int WP, int R>
__device__ __forceinline__ int chunk_off(int r, int c) {
  using S = tc::Swz<WP>;
  const int off = r * S::RB + (c % (S::RB / 16)) * 16;
  return (c / (S::RB / 16)) * R * S::RB + (off ^ (((off >> 7) & S::MASK) << 4));
}

// p, as a value the compiler cannot see through: a wgmma descriptor derived
// from it is computed where it is used, not once for all the products that
// read the same tile and then held (or spilled) in between
__device__ __forceinline__ const unsigned char* opaque(
    const unsigned char* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// 64 rows from `row` of a (col, head, row, batch) map
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col, int head,
                                          int row, int batch, int head_first) {
  if (head_first)
    tc::tma_load_4d(dst, map, bar, col, head, row, batch);
  else
    tc::tma_load_4d(dst, map, bar, col, row, head, batch);
}

// the rows [r0, r0 + R) of a head's item ii: items of whole chunks (L a
// multiple of Q), or of parts of one chunk (L < Q), the last of a chunk
// or of the sequence short
__device__ __forceinline__ void item_rows(const ChainParams& p, int ii,
                                          int& r0, int& R) {
  if (p.L < p.Q) {
    const int k = ii % p.ipc;
    r0 = (ii / p.ipc) * p.Q + k * p.L;
    R = min(p.L, p.Q - k * p.L);
  } else {
    r0 = ii * p.L;
    R = min(p.L, p.S - r0);
  }
}

// until the flag reaches `target` (acquire); traps after 2^26 polls
__device__ __forceinline__ void wait_flag(const int* f, int target) {
  for (uint32_t n = 0;; ++n) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(f)
                 : "memory");
    if (v >= target) return;
    if (n >= (1u << 26)) __trap();
    __nanosleep(64);
  }
}
// the flag, released: the state the warpgroup wrote before a barrier
// with this thread is visible before it
__device__ __forceinline__ void publish(int* f, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(f), "r"(v)
               : "memory");
}

// The producer warp: tickets, the item's vectors, TMA loads.
template <int N, int P>
__device__ __forceinline__ void produce(unsigned char* sm,
                                        const CUtensorMap* tx,
                                        const CUtensorMap* tB,
                                        const CUtensorMap* tC,
                                        const ChainParams& p) {
  using T = Chain<N, P>;
  constexpr int RB_N = T::SN::RB, RB_P = T::SP::RB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + T::bar_off);
  const int lane = threadIdx.x % 32;
  unsigned* ticket = reinterpret_cast<unsigned*>(p.flags + p.BH);
  for (int n = 0;; ++n) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(ticket, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    const int gb = n & 1;
    float* V = reinterpret_cast<float*>(sm + T::v_off + gb * T::vec);
    tc::mbar_wait_or_trap(bars + T::EMPTY_G + gb, ((n >> 1) & 1) ^ 1);
    if (t >= unsigned(p.total)) {
      if (lane == 0) reinterpret_cast<int*>(V)[T::V_T] = -1;
      __syncwarp();
      tc::mbar_arrive(bars + T::FULL_G + gb);
      return;
    }
    const int ii = int(t) / p.BH, bh = int(t) - ii * p.BH;
    const int b = bh / p.H, h = bh - b * p.H, g = h / p.hpg;
    int r0, R;
    item_rows(p, ii, r0, R);
    float *G = V, *DT = V + IR, *W = V + 2 * IR, *E = V + 3 * IR,
          *AI = V + 4 * IR, *BD = V + 5 * IR;

    // the chunk-local inclusive cumsum of dt * A, the reference's chunk
    // rule: over the item's rows, or, where the item is a part of a chunk,
    // over the whole chunk, of which the item keeps its rows and the sum
    // before them (base). Each lane sums a run of rows in order, then the
    // lanes' totals are scanned.
    const float a_h = p.A[h];
    const int s0 = p.L < p.Q ? r0 - r0 % p.Q : r0;  // the scan's first row
    const int span = p.L < p.Q ? p.Q : R, o = r0 - s0;
    const float* dtb = p.dt + b * p.dts_b + h * p.dts_h + s0 * p.dts_s;
    const int per = (span + 31) / 32;
    const int lo = min(span, lane * per), hi = min(span, lo + per);
    float run = 0.f;
    for (int k = lo; k < hi; ++k) run += dtb[k * p.dts_s] * a_h;
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    run = incl - run;  // the rows before this lane's run
    float before = 0.f;
    for (int k = lo; k < hi; ++k) {
      const float d = dtb[k * p.dts_s];
      run += d * a_h;
      if (k == o - 1) before = run;
      if (k >= o && k < o + R) {
        G[k - o] = run;
        DT[k - o] = d;
      }
    }
    const float base =
        o > 0 ? __shfl_sync(0xffffffffu, before, (o - 1) / per) : 0.f;
    __syncwarp();
    const float gl = G[R - 1];
    for (int i = R + lane; i < IR; i += 32) {  // rows past the item
      G[i] = gl;
      DT[i] = 0.f;
    }
    __syncwarp();
    for (int i = lane; i < IR; i += 32) {
      const float gi = G[i];
      W[i] = __expf(gl - gi) * DT[i];
      E[i] = __expf(gi - base);
      AI[i] = __expf(gi - G[i & ~63]);
    }
    for (int j = lane; j < 64; j += 32) BD[j] = __expf(G[64] - G[j]) * DT[j];
    if (lane == 0) {
      V[T::V_GL] = expf(gl - base);
      reinterpret_cast<int*>(V)[T::V_T] = int(t);
    }
    __syncwarp();
    tc::mbar_arrive(bars + T::FULL_G + gb);

    // the key tiles (B and x) then the C tiles, each as its buffer frees up
    if (lane == 0) {
      const int st = n % T::NST;
      const uint32_t ph = ((n / T::NST) & 1) ^ 1;
      unsigned char* sC = sm + st * T::stage;
      unsigned char* sB = sC + T::b_off;
      unsigned char* sX = sC + T::x_off;
      uint64_t* sb = bars + st * 4 * NQT;
#pragma unroll
      for (int kt = 0; kt < NQT; ++kt) {
        tc::mbar_wait_or_trap(sb + T::EMPTY_K + kt, ph);
        tc::mbar_expect_tx(sb + T::FULL_K + kt, T::k_bytes);
#pragma unroll
        for (int a = 0; a < T::AN; ++a)
          load_rows(sB + a * IR * RB_N + kt * 64 * RB_N, tB,
                    sb + T::FULL_K + kt, a * RB_N / 2, g, r0 + 64 * kt, b,
                    p.bc_hf);
#pragma unroll
        for (int a = 0; a < T::AP; ++a)
          load_rows(sX + a * IR * RB_P + kt * 64 * RB_P, tx,
                    sb + T::FULL_K + kt, a * RB_P / 2, h, r0 + 64 * kt, b,
                    p.x_hf);
      }
#pragma unroll
      for (int q = 0; q < NQT; ++q) {
        tc::mbar_wait_or_trap(sb + T::EMPTY_C + q, ph);
        tc::mbar_expect_tx(sb + T::FULL_C + q, T::c_bytes);
#pragma unroll
        for (int a = 0; a < T::AN; ++a)
          load_rows(sC + a * IR * RB_N + q * 64 * RB_N, tC,
                    sb + T::FULL_C + q, a * RB_N / 2, g, r0 + 64 * q, b,
                    p.bc_hf);
      }
    }
    __syncwarp();
  }
}

template <int V>
using IC = std::integral_constant<int, V>;

// Consumer CW (0 or 1). Each consumer computes one query tile of the item,
// Q_T: its pairs with key tiles 0 .. Q_T, and the inter-chunk term. With
// one 64-row block of state rows (P <= 64) consumer 0 holds none: it runs
// tile 1's pairs while consumer 1 computes the state and the chain step,
// then adds tile 1's inter-chunk term once h_in is ready; consumer 1 then
// runs tile 0. With two blocks (P = 128) consumer q holds rows 64 q ..
// 64 q + 63 of the state and runs tile q.
template <int N, int P, int CW>
__device__ __forceinline__ void consume(unsigned char* sm,
                                        const ChainParams& p) {
  using T = Chain<N, P>;
  using SN = typename T::SN;
  using SP = typename T::SP;
  constexpr int RB_N = SN::RB, RB_P = SP::RB;
  constexpr bool OWNER = CW == 1 || T::MB == 2;  // holds state rows
  constexpr int Q_T = T::MB == 2 ? CW : 1 - CW;  // its query tile
  constexpr int M0 = T::MB == 2 ? 64 * CW : 0;   // its first state row
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + T::bar_off);
  unsigned char* sHh = sm + T::h_off;
  unsigned char* sHl = sHh + T::h_tile;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int i0 = Q_T * 64 + warp * 16 + gr;  // this thread's rows: i0, + 8

  float y[P / 8][4];
  float s[8][4];
  uint32_t fh[4][4], fl[4][4];

  for (int n = 0;; ++n) {
    const int gb = n & 1;
    const float* V =
        reinterpret_cast<const float*>(sm + T::v_off + gb * T::vec);
    tc::mbar_wait_or_trap(bars + T::FULL_G + gb, (n >> 1) & 1);
    const int t = reinterpret_cast<const int*>(V)[T::V_T];
    if (t < 0) return;
    const int st = n % T::NST;
    const uint32_t ph = (n / T::NST) & 1;
    uint64_t* sb = bars + st * 4 * NQT;
    const unsigned char* sC = sm + st * T::stage;
    const unsigned char* sB = sC + T::b_off;
    const unsigned char* sX = sC + T::x_off;
    const int ii = t / p.BH, bh = t - ii * p.BH;
    const int b = bh / p.H, h = bh - b * p.H;
    int r0, R;
    item_rows(p, ii, r0, R);
    const float *sG = V, *sDt = V + IR, *sW = V + 2 * IR, *sE = V + 3 * IR,
                *sAi = V + 4 * IR, *sBD = V + 5 * IR;

    // ---- intra-chunk: y += (C B^T . decay . dt) x over the key tiles
    // 0 .. Q_T. The next key tile's scores are issued with this one's M x;
    // a key tile is released after the M x that read it.
    auto issue_s = [&](int kt) {
      tc::mbar_wait_or_trap(sb + T::FULL_C + Q_T, ph);
      tc::mbar_wait_or_trap(sb + T::FULL_K + kt, ph);
      const unsigned char* c = opaque(sC) + Q_T * 64 * RB_N;
      const unsigned char* bk = opaque(sB) + kt * 64 * RB_N;
      tc::fence_regs(s);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        tc::wgmma_ss<64, 0, 0>(s, SN::template kmajor<IR>(c, kk),
                               SN::template kmajor<IR>(bk, kk), kk > 0);
      tc::wgmma_commit();
    };
    // M = scores . decay . dt in place: off the diagonal a_i bd_j (both
    // <= 1), on it exp(cum_i - cum_j) dt_j for j <= i and 0 above,
    // selected without evaluating exp there (inf * 0 would be NaN)
    auto scale = [&](int kt) {
      if (kt < Q_T) {
        const float a0 = sAi[i0], a1 = sAi[i0 + 8];
        const float* bd = sBD + 2 * t4;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c == 4) asm volatile("" ::: "memory");  // half the loads live
          const float2 v = *reinterpret_cast<const float2*>(bd + 8 * c);
          s[c][0] *= a0 * v.x;
          s[c][1] *= a0 * v.y;
          s[c][2] *= a1 * v.x;
          s[c][3] *= a1 * v.y;
        }
      } else {
        const float g0 = sG[i0], g1 = sG[i0 + 8];
        const int d0 = warp * 16 + gr - 2 * t4;  // i - j at c = 0, e = 0
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c == 4) asm volatile("" ::: "memory");  // half the loads live
          const int j = kt * 64 + c * 8 + 2 * t4;
          const float2 gj = *reinterpret_cast<const float2*>(sG + j);
          const float2 dj = *reinterpret_cast<const float2*>(sDt + j);
          const int d = d0 - 8 * c;  // i - j for row i0 and column j
          s[c][0] = d >= 0 ? s[c][0] * __expf(g0 - gj.x) * dj.x : 0.f;
          s[c][1] = d >= 1 ? s[c][1] * __expf(g0 - gj.y) * dj.y : 0.f;
          s[c][2] = d >= -8 ? s[c][2] * __expf(g1 - gj.x) * dj.x : 0.f;
          s[c][3] = d >= -7 ? s[c][3] * __expf(g1 - gj.y) * dj.y : 0.f;
        }
      }
    };
    auto run_pairs = [&]() {
      issue_s(0);
#pragma unroll
      for (int kt = 0; kt <= Q_T; ++kt) {
        tc::wgmma_wait<0>();  // this tile's scores, the last M x
        tc::fence_regs(s);
        tc::fence_regs(y);
        tc::fence_regs(fh);
        tc::fence_regs(fl);
        if (kt > 0 && lane == 0) tc::mbar_arrive(sb + T::EMPTY_K + kt - 1);
        scale(kt);
        // M as hi + lo A fragments straight from the registers
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tc::split_bf16(s[2 * kk][0], s[2 * kk][1], fh[kk][0], fl[kk][0]);
          tc::split_bf16(s[2 * kk][2], s[2 * kk][3], fh[kk][1], fl[kk][1]);
          tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], fh[kk][2],
                         fl[kk][2]);
          tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], fh[kk][3],
                         fl[kk][3]);
        }
        if (kt < Q_T) issue_s(kt + 1);
        // y += M x; y holds 0 (consumer 0) or the inter-chunk term
        if (!OWNER && kt == 0) {
#pragma unroll
          for (int c = 0; c < P / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[c][e] = 0.f;
        }
        const unsigned char* xk = opaque(sX) + kt * 64 * RB_P;
        tc::fence_regs(y);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t xd = SP::template mnmajor<IR>(xk, kk);
          tc::wgmma_rs_t<P>(y, fh[kk], xd);
          tc::wgmma_rs_t<P>(y, fl[kk], xd);
        }
        tc::wgmma_commit();
      }
      tc::wgmma_wait<0>();
      tc::fence_regs(y);
      tc::fence_regs(fh);
      tc::fence_regs(fl);
      if (lane == 0) tc::mbar_arrive(sb + T::EMPTY_K + Q_T);
    };
    // ---- inter-chunk: d = C h_in from the h_in^T hi + lo tiles (0 for a
    // head's first item, whose h_in is 0)
    auto inter = [&](float(&d)[P / 8][4]) {
      tc::mbar_wait_or_trap(sb + T::FULL_C + Q_T, ph);
      const unsigned char* c = opaque(sC) + Q_T * 64 * RB_N;
      tc::fence_regs(d);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t cd = SN::template kmajor<IR>(c, kk);
        tc::wgmma_ss<P, 0, 0>(d, cd, SN::template kmajor<P>(sHh, kk),
                              kk > 0);
        tc::wgmma_ss<P, 0, 0>(d, cd, SN::template kmajor<P>(sHl, kk));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(d);
    };
    // y (plus exp(cum_i - cum_base) d where WITH_D) rounded and stored;
    // rows from R on belong to the next item or lie past S. The C tile is
    // released.
    auto store = [&](auto WITH_D, const float(&d)[P / 8][4]) {
      constexpr bool with_d = decltype(WITH_D)::value;
      if (lane == 0) tc::mbar_arrive(sb + T::EMPTY_C + Q_T);
      bf16* yb = p.y + b * p.ys_b + h * p.ys_h + r0 * p.ys_s;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        if (i < R) {
          const float ei = with_d ? sE[i] : 0.f;
#pragma unroll
          for (int c = 0; c < P / 8; ++c) {
            float v0 = y[c][2 * r], v1 = y[c][2 * r + 1];
            if (with_d) {
              v0 = fmaf(ei, d[c][2 * r], v0);
              v1 = fmaf(ei, d[c][2 * r + 1], v1);
            }
            *reinterpret_cast<__nv_bfloat162*>(yb + i * p.ys_s + 8 * c +
                                               2 * t4) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    };

    if constexpr (!OWNER) {
      run_pairs();               // while consumer 1 computes h_in
      tc::bar_sync(BAR_H, 256);  // h_in^T hi + lo are in shared memory
      float d[P / 8][4];
#pragma unroll
      for (int c = 0; c < P / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[c][e] = 0.f;
      inter(d);
      store(IC<1>{}, d);
    } else {
      // ---- the item's own state^T (rows M0 ..) = (w x)^T B, (w x)^T as
      // hi + lo register fragments read from the x tile by ldmatrix.trans
      float acc[N / 8][4];
#pragma unroll
      for (int c = 0; c < N / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
      const int prow = M0 + 16 * warp;  // this warp's 16 state rows
#pragma unroll
      for (int kt = 0; kt < NQT; ++kt) {
        tc::mbar_wait_or_trap(sb + T::FULL_K + kt, ph);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int m = lane / 8;
          const int j = kt * 64 + 16 * kk + (m >> 1) * 8 + lane % 8;
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          if (prow < P)
            tc::ldmatrix_x4_trans(v, sX + chunk_off<P, IR>(
                                         j, (prow + (m & 1) * 8) / 8));
          const float* w = sW + kt * 64 + 16 * kk + 2 * t4;
          const float2 w0 = *reinterpret_cast<const float2*>(w);
          const float2 w8 = *reinterpret_cast<const float2*>(w + 8);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&v[q]));
            const float2 ww = q >> 1 ? w8 : w0;
            tc::split_bf16(f.x * ww.x, f.y * ww.y, fh[kk][q], fl[kk][q]);
          }
        }
        const unsigned char* bk = opaque(sB) + kt * 64 * RB_N;
        tc::fence_regs(acc);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bd = SN::template mnmajor<IR>(bk, kk);
          tc::wgmma_rs_t<N>(acc, fh[kk], bd);
          tc::wgmma_rs_t<N>(acc, fl[kk], bd);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(acc);
        tc::fence_regs(fh);
        tc::fence_regs(fl);
      }
      if (lane == 0) {  // the key tiles past its own query tile are read
#pragma unroll
        for (int kt = Q_T + 1; kt < NQT; ++kt)
          tc::mbar_arrive(sb + T::EMPTY_K + kt);
      }

      // ---- the chain: h_in from the item before (ld.acquire of its flag),
      // h_out = exp(cum_last - cum_base) h_in + state published, h_in
      // kept as bf16 hi + lo for the inter-chunk term
      const bool last = ii == p.ni - 1;
      if (ii > 0) {
        if (leader) wait_flag(p.flags + bh, ii);
        tc::bar_sync(BAR_OWN + CW, 128);
      }
      // the previous item's inter-chunk products are done with the tiles
      tc::mbar_wait_or_trap(bars + T::EMPTY_H, (n & 1) ^ 1);
      // h_in read HG column tiles at a time (from L2: the slot, not a
      // stale L1 line), split into the hi + lo tiles and folded into
      // acc = h_out, in f32 as the reference carries it
      constexpr int HG = N / 8 < 4 ? N / 8 : 4;
      const float* in = p.slots + (size_t(bh) * 2 + ((ii - 1) & 1)) * P * N;
      const float decay = V[T::V_GL];
#pragma unroll
      for (int c0 = 0; c0 < N / 8; c0 += HG) {
        float hv[HG][4];
#pragma unroll
        for (int c = 0; c < HG; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int pr = prow + gr + 8 * r;
            const float2 v =
                ii > 0 && pr < P
                    ? __ldcg(reinterpret_cast<const float2*>(
                          in + pr * N + 8 * (c0 + c) + 2 * t4))
                    : make_float2(0.f, 0.f);
            hv[c][2 * r] = v.x;
            hv[c][2 * r + 1] = v.y;
          }
#pragma unroll
        for (int c = 0; c < HG; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int pr = prow + gr + 8 * r;
            if (pr < P) {
              uint32_t hi, lo;
              tc::split_bf16(hv[c][2 * r], hv[c][2 * r + 1], hi, lo);
              const int off = chunk_off<N, P>(pr, c0 + c) + 4 * t4;
              *reinterpret_cast<uint32_t*>(sHh + off) = hi;
              *reinterpret_cast<uint32_t*>(sHl + off) = lo;
            }
            acc[c0 + c][2 * r] =
                fmaf(decay, hv[c][2 * r], acc[c0 + c][2 * r]);
            acc[c0 + c][2 * r + 1] =
                fmaf(decay, hv[c][2 * r + 1], acc[c0 + c][2 * r + 1]);
          }
        asm volatile("" ::: "memory");  // one group's loads at a time
      }
      // fenced before the state's stores are issued, which it would wait for
      tc::fence_proxy_async();
      float* out = p.slots + (size_t(bh) * 2 + (ii & 1)) * P * N;
      float* hT = p.hT + size_t(bh) * N * P;
#pragma unroll
      for (int c = 0; c < N / 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pr = prow + gr + 8 * r, col = 8 * c + 2 * t4;
          if (pr < P) {
            if (last) {
              hT[col * P + pr] = acc[c][2 * r];
              hT[(col + 1) * P + pr] = acc[c][2 * r + 1];
            } else {
              *reinterpret_cast<float2*>(out + pr * N + col) =
                  make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
            }
          }
        }
      if constexpr (T::MB == 1) {
        tc::bar_sync(BAR_OWN + CW, 128);
        if (leader && !last) publish(p.flags + bh, ii + 1);
        tc::bar_arrive(BAR_H, 256);
      } else {
        tc::bar_sync(BAR_H, 256);
        if (CW == 0 && leader && !last) publish(p.flags + bh, ii + 1);
      }

      // ---- its tile: exp(cum_i - cum_base) (C_i h_in) first, into y; the
      // pairs then accumulate onto it
      inter(y);
      const float e0 = sE[i0], e1 = sE[i0 + 8];
#pragma unroll
      for (int c = 0; c < P / 8; ++c) {
        y[c][0] *= e0;
        y[c][1] *= e0;
        y[c][2] *= e1;
        y[c][3] *= e1;
      }
      run_pairs();
      store(IC<0>{}, y);
    }

    if (lane == 0) {
      tc::mbar_arrive(bars + T::EMPTY_H);
      tc::mbar_arrive(bars + T::EMPTY_G + gb);
    }
  }
}

template <int N, int P>
__global__ void __launch_bounds__(NTH, 1)
ssd_chain_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tB,
                 const __grid_constant__ CUtensorMap tC,
                 const ChainParams p) {
  using T = Chain<N, P>;
  extern __shared__ unsigned char smem_chain[];
  unsigned char* sm =
      smem_chain + ((1024 - (tc::smem_u32(smem_chain) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + T::bar_off);
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::NST; ++s)
      for (int q = 0; q < NQT; ++q) {
        uint64_t* sb = bars + s * 4 * NQT;
        // empties: lane 0 of each warp that reads the tile; both
        // consumers read every key tile, one consumer each C tile
        tc::mbar_init(sb + T::FULL_K + q, 1);
        tc::mbar_init(sb + T::EMPTY_K + q, 8);
        tc::mbar_init(sb + T::FULL_C + q, 1);
        tc::mbar_init(sb + T::EMPTY_C + q, 4);
      }
    for (int v = 0; v < 2; ++v) {
      tc::mbar_init(bars + T::FULL_G + v, 32);  // the producer warp
      tc::mbar_init(bars + T::EMPTY_G + v, 8);
    }
    tc::mbar_init(bars + T::EMPTY_H, 8);
    tc::mbar_fence_init();
  }
  __syncthreads();

  // 288 threads leave each 168 registers (three warps share an SM
  // quarter's register file): enough for one output tile, the scores and
  // the fragments a consumer holds, so no hand-over is needed
  if (threadIdx.x >= 256)
    produce<N, P>(sm, &tx, &tB, &tC, p);
  else if (threadIdx.x < 128)
    consume<N, P, 0>(sm, p);
  else
    consume<N, P, 1>(sm, p);
}

// the flags and the ticket counter of a call, zeroed on its stream
__global__ void ssd_reset_kernel(int* flags, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) flags[i] = 0;
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

constexpr int ERR_SHAPE = -1, ERR_SMEM = -2, ERR_GRID = -3, ERR_TMA = -4;

// The bf16 call's inputs, as the C entry point has them
struct Call {
  const void *x, *Bm, *Cm;
  const float *dt, *A;
  void* y;
  float* hT;
  float* slots;
  int* flags;
  int Bsz, S, H, hpg, Q;
  const long long* st;  // x (b, s, h), dt, Bm, Cm, y, in elements
};

// a model-layout bf16 tensor (Bsz, S, heads, W) as a 4-D map read in boxes
// of 64 rows of one head, its two middle dims in stride order; returns
// whether the head dim came first (or -1 if the driver refused the map)
template <int W>
int model_map(CUtensorMap* map, const void* base, int Bsz, int S, int heads,
              long long sb, long long ss, long long sh) {
  const int rb = tc::Swz<W>::RB;
  const bool hf = sh <= ss;
  const cuuint64_t dims[4] = {cuuint64_t(W), cuuint64_t(hf ? heads : S),
                              cuuint64_t(hf ? S : heads), cuuint64_t(Bsz)};
  const cuuint64_t strides[3] = {cuuint64_t(2 * (hf ? sh : ss)),
                                 cuuint64_t(2 * (hf ? ss : sh)),
                                 cuuint64_t(2 * sb)};
  const cuuint32_t box[4] = {cuuint32_t(rb / 2), hf ? 1u : 64u,
                             hf ? 64u : 1u, 1u};
  return tma::bf16_map(map, base, 4, dims, strides, box, rb) ? int(hf) : -1;
}

template <int N, int P>
int launch_chain(const Call& c, cudaStream_t stream) {
  using T = Chain<N, P>;
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  if (T::bytes > limit) return ERR_SMEM;
  const long long* st = c.st;
  // items of whole chunks, or of parts of one chunk (see item_rows)
  const int L = c.Q <= IR ? c.Q * (IR / c.Q) : IR;
  const int ipc = (c.Q + L - 1) / L;
  const int BH = c.Bsz * c.H;
  const int ni = L < c.Q ? c.S / c.Q * ipc : (c.S + L - 1) / L;
  if ((long long)ni * BH >= 0x7fffffffLL) return ERR_GRID;
  CUtensorMap tx, tB, tC;
  const int x_hf = model_map<P>(&tx, c.x, c.Bsz, c.S, c.H, st[0], st[1],
                                st[2]);
  const int b_hf = model_map<N>(&tB, c.Bm, c.Bsz, c.S, c.H / c.hpg, st[6],
                                st[7], st[8]);
  const int c_hf = model_map<N>(&tC, c.Cm, c.Bsz, c.S, c.H / c.hpg, st[9],
                                st[10], st[11]);
  if (x_hf < 0 || b_hf < 0 || c_hf < 0 || b_hf != c_hf) return ERR_TMA;
  ChainParams p;
  p.dt = c.dt;
  p.A = c.A;
  p.y = static_cast<bf16*>(c.y);
  p.hT = c.hT;
  p.slots = c.slots;
  p.flags = c.flags;
  p.dts_b = st[3], p.dts_s = st[4], p.dts_h = st[5];
  p.ys_b = st[12], p.ys_s = st[13], p.ys_h = st[14];
  p.S = c.S, p.H = c.H, p.hpg = c.hpg, p.BH = BH;
  p.Q = c.Q, p.L = L, p.ipc = ipc, p.ni = ni, p.total = ni * BH;
  p.x_hf = x_hf, p.bc_hf = b_hf;
  int dev = 0, sms = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return int(err);
  if (cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return int(err);
  auto kern = ssd_chain_kernel<N, P>;
  if (int err = set_smem(reinterpret_cast<const void*>(kern), T::bytes))
    return err;
  ssd_reset_kernel<<<1, 256, 0, stream>>>(c.flags, BH + 1);
  if (cudaError_t err = cudaGetLastError()) return int(err);
  kern<<<std::min(p.total, sms), NTH, T::bytes, stream>>>(tx, tB, tC, p);
  return int(cudaGetLastError());
}

template <int N, int P>
int launch(int dtype, const Call& c, cudaStream_t stream) {
  if (dtype == 1) return launch_chain<N, P>(c, stream);
  int limit = 0;
  if (int err = smem_limit(&limit)) return err;
  if (c.Bsz > 65535) return ERR_GRID;
  Args a;
  a.x = c.x;
  a.dt = c.dt;
  a.A = c.A;
  a.Bm = c.Bm;
  a.Cm = c.Cm;
  a.y = c.y;
  a.hT = c.hT;
  a.H = c.H;
  a.hpg = c.hpg;
  a.Q = c.Q;
  a.nc = c.S / c.Q;
  long long* dst[15] = {&a.xs_b, &a.xs_s, &a.xs_h, &a.dts_b, &a.dts_s,
                        &a.dts_h, &a.bs_b, &a.bs_s, &a.bs_g, &a.cs_b,
                        &a.cs_s, &a.cs_g, &a.ys_b, &a.ys_s, &a.ys_h};
  for (int i = 0; i < 15; ++i) *dst[i] = c.st[i];
  const size_t smem = Layout<N, P>::bytes(a.Q);
  if (smem > size_t(limit)) return ERR_SMEM;
  auto kern = ssd_f32_kernel<N, P>;
  if (int err = set_smem(reinterpret_cast<const void*>(kern), smem))
    return err;
  kern<<<dim3(a.H, c.Bsz), NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int N>
int dispatch_p(int P, int dtype, const Call& c, cudaStream_t s) {
  switch (P) {
    case 16: return launch<N, 16>(dtype, c, s);
    case 32: return launch<N, 32>(dtype, c, s);
    case 64: return launch<N, 64>(dtype, c, s);
    case 128: return launch<N, 128>(dtype, c, s);
    default: return ERR_SHAPE;
  }
}

}  // namespace

extern "C" {

// One SSD forward: x, dt, A, Bm, Cm in; y and hT out. The bf16 path's
// scratch: slots (Bsz * H, 2, P, N) f32, and flags, Bsz * H + 1 int32 (the
// chain's flags and the ticket counter; zeroed here on the stream); the
// f32 path uses neither. strides[15], in elements: x (b, s, h), dt (b, s,
// h), Bm (b, s, g), Cm (b, s, g), y (b, s, h). dtype: 0 = float32,
// 1 = bfloat16. S must be a multiple of Q. Returns 0 on success, a
// cudaError_t code if a launch was refused, -1 for an unsupported N or P,
// -2 when a block needs more shared memory than it may have, -3 when there
// are too many items (or batches, in f32) for the grid, -4 when the driver
// refused a TMA map.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, void* y, void* hT, void* slots, void* flags,
            int dtype, int Bsz, int S, int H, int heads_per_group, int Q,
            int N, int P, const long long* strides, void* stream) {
  Call c;
  c.x = x;
  c.Bm = Bm;
  c.Cm = Cm;
  c.dt = static_cast<const float*>(dt);
  c.A = static_cast<const float*>(A);
  c.y = y;
  c.hT = static_cast<float*>(hT);
  c.slots = static_cast<float*>(slots);
  c.flags = static_cast<int*>(flags);
  c.Bsz = Bsz;
  c.S = S;
  c.H = H;
  c.hpg = heads_per_group;
  c.Q = Q;
  c.st = strides;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return dispatch_p<16>(P, dtype, c, s);
    case 32: return dispatch_p<32>(P, dtype, c, s);
    case 64: return dispatch_p<64>(P, dtype, c, s);
    case 128: return dispatch_p<128>(P, dtype, c, s);
    default: return ERR_SHAPE;
  }
}

// the bf16 kernel's dynamic shared memory a block at (N, P), or -1
int ssd_bf16_smem(int N, int P) {
  switch (N * 1000 + P) {
#define SSD_CASE(n, p) \
  case n * 1000 + p:   \
    return Chain<n, p>::bytes;
    SSD_CASE(16, 16) SSD_CASE(16, 32) SSD_CASE(16, 64) SSD_CASE(16, 128)
    SSD_CASE(32, 16) SSD_CASE(32, 32) SSD_CASE(32, 64) SSD_CASE(32, 128)
    SSD_CASE(64, 16) SSD_CASE(64, 32) SSD_CASE(64, 64) SSD_CASE(64, 128)
    SSD_CASE(128, 16) SSD_CASE(128, 32) SSD_CASE(128, 64) SSD_CASE(128, 128)
#undef SSD_CASE
    default:
      return -1;
  }
}

const char* ssd_error_string(int code) {
  if (code == ERR_SHAPE) return "unsupported N or P (16, 32, 64 or 128)";
  if (code == ERR_SMEM) return "a block needs more shared memory than the "
                               "card allows";
  if (code == ERR_GRID) return "too many items (or, in float32, batches) "
                               "for the grid";
  if (code == ERR_TMA) return "cuTensorMapEncodeTiled refused a TMA map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
