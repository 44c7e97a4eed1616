// One whole BCPNN hidden-layer training batch in one launch (Alg. 1 L8-16),
// f32 arithmetic, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bcpnn_phase.py:bcpnn_phase_fused.
// Given x (B, F), the cached weights w (F, H) and bias b (H,), the mask
// (F, H) (may be null) and the old traces c_i (F,), c_j (H,), C_ij (F, H):
//   s     = (x @ (w * mask) + b) * gain
//   a_j   = softmax of s within each hypercolumn of n_mcu units
//   then the update of bcpnn_update.cu on (x, a_j), rounding epilogue and
//   bf16 state included: the same update tile, bcpnn_tile.cuh.
// Outputs: a_j (B, H), c_i', c_j', C_ij', w' (F, H), bias' (H,).
//
// Bound at the MNIST hidden layer (B=128, F=1568, H=3000): 2 x 2BFH =
// 2.41 GFLOP of f32 FMA is ~0.036 ms at 67 TFLOP/s, against ~96 MB of
// bytes with f32 state (~75 MB bf16), ~0.029 / 0.022 ms at 3.35 TB/s: the
// kernel is bound by operations.
//
// The softmax needs a whole hypercolumn's row of s, so a unit of work owns
// whole hypercolumns: a group of G = max(1, TN / n_mcu) hypercolumns (one
// at the MNIST width, 100 units), a thread-block cluster of CL <= 8 CTAs
// that split F into slices of FS rows (G, CL and FS come from
// kernels/bcpnn_phase.py:plan).  208 threads, 16 x 13, two CTAs an SM, so
// the 30 clusters of 8 at the MNIST width run in one wave:
//   1. forward: each CTA accumulates its F slice's partial s for a chunk of
//      batch rows and the group's columns into shared memory (S), as
//      masked_matmul.cu does: x staged row-major, w and the mask k-major,
//      16-byte cp.async, double-buffered, each thread masking the w
//      elements it copied, an 8x8 register tile read as 16-byte vectors;
//   2. softmax: after a cluster barrier, CTA r takes its share of the
//      chunk's rows: every thread sums runs of four partials over the
//      cluster through distributed shared memory in rank order (all the
//      ranks' 16-byte loads in flight; deterministic), adds the bias and
//      applies the gain into its own rows of S; then one warp per (row,
//      hypercolumn) takes the softmax (shuffle reductions) and writes a_j to
//      global memory;
//   3. no broadcast: after a second cluster barrier every CTA stages the
//      group's a_j from L2 (16-byte cp.async.cg) as the update's second
//      operand, so S is not needed past the softmax;
//   4. update: each CTA walks its F slice x the group's columns in tiles of
//      64 x TN rows and columns (4x8 a thread; a last tile of at most 16
//      rows, 1x8) through bcpnn_tile.cuh: x and a_j through a ring of
//      16-byte cp.async stages, the register product over the batch, the
//      vectorised epilogue (16-byte C_ij, mask, C_ij' and w; 8-byte bf16
//      traces).  The batch sums behind c_i' and c_j' are taken from the
//      staged stages inside the first tiles' product loops, by every thread:
//      there is no phase of idle threads.
// The lockstep of the phases is broken in the update: a tile's
// accumulators wait in a stash in shared memory, and its epilogue runs
// during the next tile's product, one run of four elements per thread and
// stage (the loads issued before the stage's FMAs, the rest after them), so
// only the last, 16-row tile's epilogue runs alone.  A shared-memory copy
// of the update tile's mask (cp.async.bulk on an mbarrier), a register
// preload of C_ij and the mask, finishing each run one stage later and
// 128-row update tiles were each no faster or slower in exploratory runs on
// the card: a thread holds at most 128 registers (two CTAs of 7 warps an
// SM), and each of them spilled more or cost occupancy.
// Tiles fit the hypercolumn group: TN = 104 columns pad a 100-unit group's
// columns by 1.04x.  At MNIST width, F = 1568 over CL = 8 gives FS = 208
// (13 stages of 16; the last rank takes 112 rows): the forward pads its
// FMAs at the busiest rank by 1.04 x 208/196 = 1.10x, and so does the
// update, whose 64 + 64 + 64 + 16 rows cover 208 exactly.
// No atomics: every output element is written once.  The CTAs of group 0
// write c_i'; rank 0 of each group writes c_j' and the bias.  Ragged H, F
// and B are handled by bounds checks, with no padding copies.  All products
// are IEEE f32 FMA (no TF32).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "bcpnn_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bcpnn_tile;

constexpr int TX = 13;               // threads across a tile
constexpr int TY = 16;               // threads down a tile
constexpr int RN = 8;                // columns of a register micro-tile
constexpr int THREADS = TX * TY;     // 208
constexpr int TN = TX * RN;          // 104 columns of a tile: the group's
constexpr int RMF = 8;               // the forward's micro-tile rows: RMF x RN
constexpr int TMF = TY * RMF;        // batch rows of a forward tile
constexpr int BK = 16;               // depth of a forward stage (F rows)
constexpr int AP = BK + 4;           // row length of the row-major x stage
constexpr int FSTAGE = TMF * AP + 2 * BK * TN;  // floats of a forward stage: x, w, mask
constexpr int NSF = 2;               // forward stages (double-buffered)
constexpr int RMU = 4;               // the update's micro-tile rows: RMU x RN,
constexpr int TMU = TY * RMU;        // 64-row tiles (and a last one of <= 16 rows)
constexpr int BKU = 16;              // depth of an update stage (batch rows)
constexpr int NSU = 3;               // update stages
constexpr int USTAGE = BKU * (TMU + TN);       // floats of an update stage: x, a_j

constexpr int FULL_WARPS = THREADS / 32;  // the softmax's warps (the 7th is half)
constexpr unsigned FULL = 0xffffffffu;

// The profiling variant's clock: thread 0 of each CTA reads %globaltimer at
// every phase boundary, after a barrier, and accumulates the ns spent in
// each phase; the main path instantiates it with ON = false (no code).
enum Phase { FORWARD, SOFTMAX, SUMS, PRODUCT, EPILOGUE, NPHASE };  // bcpnn_phase.py:PHASES
template <bool ON>
struct PhaseClock {
  unsigned long long t0 = 0, last = 0, acc[NPHASE] = {};
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start() {
    if constexpr (ON) { __syncthreads(); t0 = last = now(); }
  }
  __device__ void lap(int phase) {
    if constexpr (ON) {
      __syncthreads();
      const unsigned long long t = now();
      acc[phase] += t - last;
      last = t;
    }
  }
  // Row blockIdx.x of out: start and end stamps, then the ns of each phase.
  __device__ void write(unsigned long long* out) const {
    if constexpr (ON) {
      if (threadIdx.x != 0) return;
      unsigned long long* row = out + static_cast<size_t>(blockIdx.x) * (NPHASE + 2);
      row[0] = t0;
      row[1] = last;
#pragma unroll
      for (int p = 0; p < NPHASE; ++p) row[2 + p] = acc[p];
    }
  }
};

struct Args {
  const float* x;
  const float* w;
  const float* b;
  const float* mask;
  const void* ci;
  const void* cj;
  const void* cij;
  float* aj;
  void* ci_out;
  void* cj_out;
  void* cij_out;
  float* w_out;
  float* bias_out;
  int B, F, n_hcu, n_mcu, G, CL, FS;
  int BC;      // rows of S: the batch rounded up to 16, or a chunk
  int SWP;     // row length of S: the group's columns rounded up to TN
  int REGION;  // floats of the region that the forward's ring and S, then the
               // update's ring, take in turn
  float k_b, gain;
  Update u;
  unsigned long long* prof;
};

// Floats of shared memory after the region: log c_j' (SWP), log c_i' (TMU)
// and the column sums (TMU + TN).
__host__ __device__ constexpr int tail_floats(int swp) { return swp + 2 * TMU + TN; }

// Two CTAs of 7 warps an SM: at most 128 registers a thread (a sub-partition
// holds 16K registers and 4 of the 14 warps).
template <bool MASK, bool VX, bool VN, bool PROFILE>
__global__ void __launch_bounds__(THREADS, 2) bcpnn_phase_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  PhaseClock<PROFILE> clk;
  clk.start();
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = a.CL;
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = static_cast<int>(blockIdx.x) / CL;
  const int B = a.B, F = a.F, n_mcu = a.n_mcu, BC = a.BC, SWP = a.SWP;
  const int H = a.n_hcu * n_mcu;
  const int h0 = group * a.G * n_mcu;                 // first column of the group
  const int g_hcus = min(a.G, a.n_hcu - group * a.G);  // the last group may be ragged
  const int HT = g_hcus * n_mcu;
  const int f_lo = min(F, rank * a.FS);
  const int f_hi = min(F, f_lo + a.FS);

  float* fring = smem;                                // NSF x FSTAGE
  float* S = smem + NSF * FSTAGE;                     // BC x SWP: partial s, then s
  float* ring = smem;                                 // then NSU x USTAGE
  float* log_cj = smem + a.REGION;                    // SWP
  float* log_ci = log_cj + SWP;                       // TMU
  float* sums = log_ci + TMU;                         // TMU + TN
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int b0 = 0; b0 < B; b0 += BC) {
    const int nrows = min(BC, B - b0);

    // 1. Partial support of this CTA's F slice for the chunk's rows.
    for (int r0 = 0; r0 < nrows; r0 += TMF) {
      for (int c0 = 0; c0 < HT; c0 += TN) {
        // Stage t of the slice into buffer buf: x (the chunk's rows x BK of
        // F, row-major), w and mask (BK of F x the group's columns).
        auto fetch = [&](int t, int buf) {
          float* As = fring + buf * FSTAGE;
          float* Bs = As + TMF * AP;
          float* Ms = Bs + BK * TN;
          const int k0 = f_lo + t * BK;
          constexpr int VXN = VX ? 4 : 1, VNN = VN ? 4 : 1;
#pragma unroll
          for (int u = 0; u < cdiv(TMF * BK / VXN, THREADS); ++u) {
            const int e = tid + u * THREADS;
            if (e < TMF * BK / VXN) {
              const int m = e / (BK / VXN), k = (e % (BK / VXN)) * VXN;
              const bool ok = r0 + m < nrows && k0 + k < f_hi;  // F % 4 == 0 with VX
              copy_async<4 * VXN>(
                  As + m * AP + k,
                  a.x + (ok ? static_cast<size_t>(b0 + r0 + m) * F + k0 + k : 0), ok);
            }
          }
#pragma unroll
          for (int u = 0; u < cdiv(BK * TN / VNN, THREADS); ++u) {
            const int e = tid + u * THREADS;
            if (e < BK * TN / VNN) {
              const int k = e / (TN / VNN), n = (e % (TN / VNN)) * VNN;
              const bool ok = k0 + k < f_hi && c0 + n < HT;  // HT % 4 == 0 with VN
              const size_t idx = ok ? static_cast<size_t>(k0 + k) * H + h0 + c0 + n : 0;
              copy_async<4 * VNN>(Bs + k * TN + n, a.w + idx, ok);
              if constexpr (MASK) copy_async<4 * VNN>(Ms + k * TN + n, a.mask + idx, ok);
            }
          }
        };
        // w * mask on the elements this thread copied into buffer buf.
        auto apply_mask = [&](int buf) {
          float* Bs = fring + buf * FSTAGE + TMF * AP;
          const float* Ms = Bs + BK * TN;
          constexpr int VNN = VN ? 4 : 1;
#pragma unroll
          for (int u = 0; u < cdiv(BK * TN / VNN, THREADS); ++u) {
            const int e = (tid + u * THREADS) * VNN;
            if (e < BK * TN) {
              if constexpr (VN) {
                float4 v = *reinterpret_cast<float4*>(Bs + e);
                const float4 m = *reinterpret_cast<const float4*>(Ms + e);
                v.x *= m.x; v.y *= m.y; v.z *= m.z; v.w *= m.w;
                *reinterpret_cast<float4*>(Bs + e) = v;
              } else {
                Bs[e] *= Ms[e];
              }
            }
          }
        };

        float acc[RMF][RN];
#pragma unroll
        for (int i = 0; i < RMF; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
        const int nk = cdiv(f_hi - f_lo, BK);
        __syncthreads();  // the ring is free (a previous tile may still read it)
        // The ring: NSF - 1 stages in flight ahead of the one multiplied.
#pragma unroll
        for (int st = 0; st < NSF - 1; ++st) {
          if (st < nk) fetch(st, st);
          __pipeline_commit();
        }
        for (int kt = 0; kt < nk; ++kt) {
          const int buf = kt % NSF;
          __pipeline_wait_prior(NSF - 2);
          if constexpr (MASK) apply_mask(buf);
          __syncthreads();  // stage kt is visible; buffer (kt - 1) % NSF is free
          if (kt + NSF - 1 < nk) fetch(kt + NSF - 1, (kt + NSF - 1) % NSF);
          __pipeline_commit();
          const float* As = fring + buf * FSTAGE;
          const float* Bs = As + TMF * AP;
#pragma unroll
          for (int k4 = 0; k4 < BK; k4 += 4) {
#pragma unroll
            for (int g = 0; g < RMF / 4; ++g) {  // x rows ty + TY * i, four at a time
              float4 av[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                av[i] = *reinterpret_cast<const float4*>(As + (ty + TY * (4 * g + i)) * AP + k4);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                float bv[RN];
#pragma unroll
                for (int h = 0; h < RN / 4; ++h) lds<4>(bv + 4 * h, Bs + (k4 + q) * TN + (h * TX + tx) * 4);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
                  for (int j = 0; j < RN; ++j) acc[4 * g + i][j] = fmaf(ai, bv[j], acc[4 * g + i][j]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RMF; ++i) {
          const int lr = r0 + ty + TY * i;
          if (lr >= nrows) continue;
#pragma unroll
          for (int h = 0; h < RN / 4; ++h)
            *reinterpret_cast<float4*>(S + static_cast<size_t>(lr) * SWP + c0 + (h * TX + tx) * 4) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      }
    }
    clk.lap(FORWARD);
    cluster.sync();  // every partial of the chunk is in place

    // 2. This CTA's rows: the partials summed over the cluster in rank
    //    order (every thread, all the ranks' loads in flight), the bias and
    //    the gain, into its own rows of S, which only it reads; then the
    //    softmax per hypercolumn (one warp per (row, hypercolumn), shuffle
    //    reductions) and a_j to global memory.
    const int per = cdiv(nrows, CL);
    const int row_lo = min(nrows, rank * per);
    const int row_hi = min(nrows, row_lo + per);
    {
      constexpr int V = VN ? 4 : 1;
      const int runs = HT / V;  // HT % 4 == 0 with VN
      for (int e = tid; e < (row_hi - row_lo) * runs; e += THREADS) {
        const size_t off = static_cast<size_t>(row_lo + e / runs) * SWP + (e % runs) * V;
        float sv[V], v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) sv[k] = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < CL) {
            lds<V>(v, cluster.map_shared_rank(S, q) + off);
#pragma unroll
            for (int k = 0; k < V; ++k) sv[k] += v[k];
          }
        }
        lds<V>(v, a.b + h0 + (e % runs) * V);
#pragma unroll
        for (int k = 0; k < V; ++k) S[off + k] = (sv[k] + v[k]) * a.gain;
      }
    }
    __syncthreads();
    const int tasks = (row_hi - row_lo) * g_hcus;
    for (int t = warp; warp < FULL_WARPS && t < tasks; t += FULL_WARPS) {
      const int lr = row_lo + t / g_hcus;
      const int col0 = (t % g_hcus) * n_mcu;
      float* row = S + static_cast<size_t>(lr) * SWP + col0;
      float m = __int_as_float(0xff800000);  // -inf
      for (int i = lane; i < n_mcu; i += 32) m = fmaxf(m, row[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      float z = 0.f;
      for (int i = lane; i < n_mcu; i += 32) {
        const float e = expf(row[i] - m);
        row[i] = e;
        z += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(FULL, z, o);
      float* out = a.aj + static_cast<size_t>(b0 + lr) * H + h0 + col0;
      for (int i = lane; i < n_mcu; i += 32) out[i] = row[i] / z;
    }
    __threadfence();
    cluster.sync();  // a_j of the chunk is final in global memory; S is free
    clk.lap(SOFTMAX);
  }

  // 4. C_ij' and w' over this CTA's F slice x the group's columns, in tiles
  //    of TY * R rows (R = RMU, then 1 for a last tile of at most 16 rows) by
  //    TN columns; c_i' for a tile's rows with its first column tile, c_j'
  //    (and the bias) with the first row tile.  A tile's epilogue runs
  //    during the next tile's product: its accumulators wait in a stash, and
  //    in each stage every thread issues the loads of C_ij and the mask for
  //    one run of four elements before its FMAs and finishes the run after
  //    them, so the epilogue's bytes stream while the FMA units work.  Only
  //    the last tile's epilogue runs alone.  The forward's ring
  //    and S are free now: the update's ring and the stash take them.
  float* stash = ring + NSU * USTAGE;                 // TMU x TN
  const int nk = cdiv(B, BKU);
  int prev_f0 = 0, prev_c0 = 0, prev_rows = 0;        // the stashed tile (rows 0: none)
  const int rows = f_hi - f_lo;
  const int n64 = rows > TY ? cdiv(rows - TY, TMU) : 0;      // 64-row tiles,
  const int n_rt = n64 + (rows - TMU * n64 > 0 ? 1 : 0);     // then <= 16 rows
  const int n_ct = cdiv(HT, TN);

  // One run of the stashed tile: four columns of one row, run e of
  // (prev_rows x TN / 4); false when it lies outside the slice or the group.
  auto run_at = [&](int e, int& lr, int& col) {
    lr = e / (TN / 4);
    col = prev_c0 + (e % (TN / 4)) * 4;
    return e < prev_rows * (TN / 4) && prev_f0 + lr < f_hi && col < HT;
  };
  auto finish_run = [&](int lr, int col, const float (&c)[4], const float (&m)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(stash + lr * TN + col - prev_c0);
    const float s4[4] = {v.x, v.y, v.z, v.w};
    finish4<VN, MASK>(a.u, c, m, s4, log_ci[lr], log_cj + col, a.cij_out, a.w_out,
                      static_cast<size_t>(prev_f0 + lr) * H + h0 + col, min(4, HT - col));
  };

  auto update_tile = [&](auto r_tag, int fr0, int c0, bool last) {
    constexpr int R = decltype(r_tag)::value;
    constexpr int TR = TY * R;                // F rows of the tile
    constexpr int STG = BKU * (TR + TN);      // floats of a stage: x, a_j
    const bool need_ci = c0 == 0, need_cj = fr0 == f_lo;
    // The stashed tile's runs: J a thread, run j in stage j (its loads before
    // the stage's FMAs, the rest after them), the rest after the loop.
    const int J = cdiv(prev_rows * (TN / 4), THREADS);
    struct Run {
      float c[4], m[4];
      int lr, col;
      bool ok;
    };
    auto load_run = [&](Run& r, int j) {
      r.ok = j < J && run_at(j * THREADS + tid, r.lr, r.col);
      if (r.ok) {
        const size_t idx = static_cast<size_t>(prev_f0 + r.lr) * H + h0 + r.col;
        load4<VN>(r.c, a.cij, idx, a.u.in_bf16, min(4, HT - r.col));
        if constexpr (MASK) load4<VN>(r.m, a.mask, idx, 0, min(4, HT - r.col));
      }
    };
    // Stage t (batch rows t * BKU..) into buffer buf: x (batch x the tile's
    // F rows) and a_j (batch x columns), which the softmax's CTAs wrote to
    // global memory: 16-byte cp.async.cg reads it from L2.
    auto fetch = [&](int t, int buf) {
      float* As = ring + buf * STG;
      float* Bs = As + BKU * TR;
      const int b0 = t * BKU;
      constexpr int VXN = VX ? 4 : 1;
#pragma unroll
      for (int u = 0; u < cdiv(BKU * TR / VXN, THREADS); ++u) {
        const int e = tid + u * THREADS;
        if (e < BKU * TR / VXN) {
          const int k = e / (TR / VXN), m = (e % (TR / VXN)) * VXN;
          const bool ok = b0 + k < B && fr0 + m < f_hi;
          copy_async<4 * VXN>(As + k * TR + m,
                              a.x + (ok ? static_cast<size_t>(b0 + k) * F + fr0 + m : 0), ok);
        }
      }
      if constexpr (VN) {
#pragma unroll
        for (int u = 0; u < cdiv(BKU * TN / 4, THREADS); ++u) {
          const int e = tid + u * THREADS;
          if (e < BKU * TN / 4) {
            const int k = e / (TN / 4), n = (e % (TN / 4)) * 4;
            const bool ok = b0 + k < B && c0 + n < HT;
            copy_async<16>(Bs + k * TN + n,
                           a.aj + (ok ? static_cast<size_t>(b0 + k) * H + h0 + c0 + n : 0), ok);
          }
        }
      } else {  // a 4-byte cp.async would go through L1: read around it
        for (int e = tid; e < BKU * TN; e += THREADS) {
          const int k = e / TN, n = e % TN;
          const bool ok = b0 + k < B && c0 + n < HT;
          Bs[e] = ok ? __ldcg(a.aj + static_cast<size_t>(b0 + k) * H + h0 + c0 + n) : 0.f;
        }
      }
    };

    float acc[R][RN];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    float cs[2] = {0.f, 0.f};  // column tid and tid + THREADS of [x tile | a_j tile]
#pragma unroll
    for (int st = 0; st < NSU - 1; ++st) {
      if (st < nk) fetch(st, st);
      __pipeline_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int buf = kt % NSU;
      __pipeline_wait_prior(NSU - 2);
      __syncthreads();  // stage kt is visible; buffer (kt - 1) % NSU is free
      if (kt + NSU - 1 < nk) fetch(kt + NSU - 1, (kt + NSU - 1) % NSU);
      __pipeline_commit();
      Run run;
      load_run(run, kt);
      const float* As = ring + buf * STG;
      const float* Bs = As + BKU * TR;
      if (need_ci || need_cj) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = tid + q * THREADS;
          if (c < TR ? need_ci : (c < TR + TN && need_cj)) {
            const float* col = c < TR ? As + c : Bs + (c - TR);
            const int ld = c < TR ? TR : TN;
#pragma unroll
            for (int kk = 0; kk < BKU; ++kk) cs[q] += col[kk * ld];
          }
        }
      }
      product_stage<R, RN, TY, TX, BKU>(As, TR, Bs, TN, acc, tx, ty);
      if (run.ok) finish_run(run.lr, run.col, run.c, run.m);
    }
    __pipeline_wait_prior(0);
    // Runs of the stashed tile that the stages did not take (a short batch).
    for (int j = nk; j < J; ++j) {
      Run r;
      load_run(r, j);
      if (r.ok) finish_run(r.lr, r.col, r.c, r.m);
    }
    clk.lap(PRODUCT);

    // The stashed tile is finished, so log c_i' may change now.
    if (need_ci || need_cj) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (tid + q * THREADS < TR + TN) sums[tid + q * THREADS] = cs[q];
    }
    __syncthreads();
    if (need_ci || need_cj) {
      for (int c = tid; c < TR + TN; c += THREADS) {
        if (c < TR) {
          const int f = fr0 + c;
          if (!need_ci || f >= f_hi) continue;
          const float v = trace(a.u, load_state(a.ci, f, a.u.in_bf16), sums[c]);
          log_ci[c] = logf(fmaxf(v, EPS));
          if (group == 0) store_state(a.ci_out, f, v, a.u.out_bf16);
        } else {
          const int col = c0 + c - TR;
          if (!need_cj || col >= HT) continue;
          const float v = trace(a.u, load_state(a.cj, h0 + col, a.u.in_bf16), sums[c]);
          const float lc = logf(fmaxf(v, EPS));
          log_cj[col] = lc;
          if (rank == 0) {
            store_state(a.cj_out, h0 + col, v, a.u.out_bf16);
            a.bias_out[h0 + col] = a.k_b * lc;
          }
        }
      }
      __syncthreads();
    }
    clk.lap(SUMS);

    if (!last) {  // into the stash, for the next tile's stages
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int h = 0; h < RN / 4; ++h)
          *reinterpret_cast<float4*>(stash + micro<R, TY>(ty, i) * TN + (h * TX + tx) * 4) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      prev_f0 = fr0;
      prev_c0 = c0;
      prev_rows = TR;
    } else {  // the last tile: its epilogue now, from registers
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int lr = micro<R, TY>(ty, i);
        const int gf = fr0 + lr;
        if (gf >= f_hi) continue;
#pragma unroll
        for (int h = 0; h < RN / 4; ++h) {
          const int col = c0 + (h * TX + tx) * 4;
          if (col >= HT) continue;
          const float s4[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
          epilogue4<VN, MASK>(a.u, a.cij, a.mask, a.cij_out, a.w_out,
                              static_cast<size_t>(gf) * H + h0 + col, min(4, HT - col), s4,
                              log_ci[lr], log_cj + col);
        }
      }
    }
    clk.lap(EPILOGUE);
  };
  for (int rt = 0; rt < n_rt; ++rt) {
    for (int ct = 0; ct < n_ct; ++ct) {
      const bool last = rt == n_rt - 1 && ct == n_ct - 1;
      if (rt < n64) {
        update_tile(std::integral_constant<int, RMU>{}, f_lo + rt * TMU, ct * TN, last);
      } else {
        update_tile(std::integral_constant<int, 1>{}, f_lo + rt * TMU, ct * TN, last);
      }
    }
  }
  clk.write(a.prof);
}

template <bool MASK, bool VX, bool VN, bool PROFILE>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = bcpnn_phase_kernel<MASK, VX, VN, PROFILE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(a.n_hcu, a.G) * a.CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const Args&, size_t, cudaStream_t);

// Variant I: bit 2 = mask, bit 1 = 16-byte x rows, bit 0 = 16-byte group
// rows (w, mask, b, a_j, C_ij, C_ij', w'; n_mcu % 4 == 0).
template <bool PROFILE, int... I>
int dispatch(const Args& a, size_t smem, int variant, cudaStream_t stream,
             std::integer_sequence<int, I...>) {
  static constexpr Launcher table[] = {launch<(I & 4) != 0, (I & 2) != 0, (I & 1) != 0, PROFILE>...};
  return table[variant](a, smem, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// Checks the plan (G, CL, FS) and sizes S: the whole batch (rounded up to
// 16 rows) when it fits in the card's shared memory, else the most rows
// that fit, in chunks.  Returns cudaErrorInvalidValue for a plan that
// leaves an F slice empty or does not cover F, or when 16 rows of S, the
// rings and the logs do not fit.
template <bool PROFILE>
int run(Args a, cudaStream_t stream) {
  if (a.B <= 0 || a.F <= 0 || a.n_hcu <= 0 || a.n_mcu <= 0 || a.G < 1 || a.G > a.n_hcu ||
      a.CL < 1 || a.CL > 8 || a.FS <= 0 || a.FS % BK != 0)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(a.CL) * a.FS < a.F ||
      (a.CL > 1 && static_cast<long long>(a.CL - 1) * a.FS >= a.F))
    return cudaErrorInvalidValue;
  a.SWP = cdiv(a.G * a.n_mcu, TN) * TN;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long room = optin / static_cast<long long>(sizeof(float)) - tail_floats(a.SWP);
  const long long fit = (room - NSF * FSTAGE) / a.SWP / 16 * 16;
  if (fit < 16 || room < NSU * USTAGE + TMU * TN) return cudaErrorInvalidValue;
  a.BC = static_cast<int>(std::min(static_cast<long long>(cdiv(a.B, 16) * 16), fit));
  a.REGION = std::max(NSF * FSTAGE + a.BC * a.SWP, NSU * USTAGE + TMU * TN);
  const size_t smem = static_cast<size_t>(a.REGION + tail_floats(a.SWP)) * sizeof(float);
  const bool vx = a.F % 4 == 0 && aligned16(a.x);
  const bool vn = a.n_mcu % 4 == 0 && aligned16(a.w) && aligned16(a.b) && aligned16(a.aj) &&
                  aligned16(a.cij) && aligned16(a.cij_out) && aligned16(a.w_out) &&
                  (a.mask == nullptr || aligned16(a.mask));
  const int variant = (a.mask != nullptr ? 4 : 0) | (vx ? 2 : 0) | (vn ? 1 : 0);
  return dispatch<PROFILE>(a, smem, variant, stream, std::make_integer_sequence<int, 8>{});
}

}  // namespace

// g hypercolumns a group, cl CTAs a cluster splitting F into slices of fs
// rows (a multiple of 16): kernels/bcpnn_phase.py:plan.
extern "C" int bcpnn_phase_f32(const float* x, const float* w, const float* b,
                               const float* mask, const void* ci, const void* cj,
                               const void* cij, float* aj, void* ci_out, void* cj_out,
                               void* cij_out, float* w_out, float* bias_out, int B, int F,
                               int n_hcu, int n_mcu, float lam, float one_m, float k_b,
                               float gain, int state_mantissa, int state_in_bf16,
                               int state_out_bf16, int g, int cl, int fs, cudaStream_t stream) {
  const Update u{lam, one_m, 1.0f / static_cast<float>(B), state_mantissa, state_in_bf16,
                 state_out_bf16};
  return run<false>(Args{x, w, b, mask, ci, cj, cij, aj, ci_out, cj_out, cij_out, w_out,
                         bias_out, B, F, n_hcu, n_mcu, g, cl, fs, 0, 0, 0, k_b, gain, u, nullptr},
                    stream);
}

// The profiling variant: the same work, with a barrier and a %globaltimer
// read at every phase boundary; row c of prof (CTAs x (2 + NPHASE))
// receives CTA c's start and end stamps and the ns of each phase.  The main
// path never calls it.
extern "C" int bcpnn_phase_f32_profile(const float* x, const float* w, const float* b,
                                       const float* mask, const void* ci, const void* cj,
                                       const void* cij, float* aj, void* ci_out,
                                       void* cj_out, void* cij_out, float* w_out,
                                       float* bias_out, int B, int F, int n_hcu, int n_mcu,
                                       float lam, float one_m, float k_b, float gain,
                                       int state_mantissa, int state_in_bf16,
                                       int state_out_bf16, int g, int cl, int fs,
                                       unsigned long long* prof, cudaStream_t stream) {
  const Update u{lam, one_m, 1.0f / static_cast<float>(B), state_mantissa, state_in_bf16,
                 state_out_bf16};
  return run<true>(Args{x, w, b, mask, ci, cj, cij, aj, ci_out, cj_out, cij_out, w_out,
                        bias_out, B, F, n_hcu, n_mcu, g, cl, fs, 0, 0, 0, k_b, gain, u, prof},
                   stream);
}
