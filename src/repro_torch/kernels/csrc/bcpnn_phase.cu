// One whole BCPNN hidden-layer training batch in one launch (Alg. 1 L8-16),
// f32 arithmetic, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bcpnn_phase.py:bcpnn_phase_fused.
// Given x (B, F), the cached weights w (F, H) and bias b (H,), the mask
// (F, H) (may be null) and the old traces c_i (F,), c_j (H,), C_ij (F, H):
//   s     = (x @ (w * mask) + b) * gain
//   a_j   = softmax of s within each hypercolumn of n_mcu units
//   then the update of bcpnn_update.cu on (x, a_j), rounding epilogue and
//   bf16 state included (rne_round.cuh).
// Outputs: a_j (B, H), c_i', c_j', C_ij', w' (F, H), bias' (H,).
//
// The softmax needs a whole hypercolumn's row of s, so a unit of work owns
// whole hypercolumns: a group of G = max(1, 128 / n_mcu) hypercolumns
// (one at the MNIST width, 100 units).  One group alone would give 30 CTAs
// on 132 SMs, so each group is a thread-block cluster of CL <= 8 CTAs that
// split F (cooperative_groups::this_cluster()):
//   1. each CTA accumulates its F slice's partial s for a chunk of batch
//      rows and all the group's columns in shared memory (BC x SW floats);
//   2. after a cluster barrier, CTA r takes its share of the chunk's rows,
//      sums the CL partials through distributed shared memory in rank order
//      (deterministic), adds the bias, applies the gain and the softmax
//      (one warp per (row, hypercolumn), shuffle reductions), and writes
//      a_j to global memory and to its own shared rows;
//   3. when the whole batch fits (BC >= B, as at B = 128), each CTA copies
//      the other ranks' a_j rows into its own shared memory and the update
//      reads a_j there; otherwise the chunks loop and the update re-reads
//      a_j from global memory, where it is an output anyway;
//   4. each CTA runs the update over its own F slice x the group's columns:
//      the SIMT product a_i^T a_j over the batch, then the epilogue reads
//      C_ij and the mask once and writes C_ij' and w' once.
// Both products work on 64x128 output tiles, 4x8 per thread in registers
// (read from 16-deep shared-memory stages with 16-byte loads).  The stages
// are double-buffered and filled with cp.async, so a stage's global loads
// are all in flight while the previous stage is multiplied;
// __launch_bounds__ keeps two CTAs on an SM, so the 30 clusters of 8 at the
// MNIST width run in one wave, and one CTA's loads overlap the other's
// products.  The batch sums behind c_i' and c_j' run before the update.
// No atomics: every output element is written once.  The CTAs of group 0
// write c_i'; the CTAs of F slice 0 (rank 0) write c_j' and the bias.
// Ragged H, F and B are handled by bounds checks, with no padding copies.
// All products are f32 FMA (no TF32).
//
// Bound at the MNIST hidden layer (B=128, F=1568, H=3000): 2 x 2BFH =
// 2.41 GFLOP of f32 FMA is ~0.036 ms at 67 TFLOP/s, against ~96 MB of
// bytes with f32 state (~75 MB bf16), ~0.029 / 0.022 ms at 3.35 TB/s: the
// kernel is bound by operations.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <algorithm>

#include "rne_round.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RM = 4;                  // register micro-tile: RM x RN per thread,
constexpr int RN = 8;                  // as RM/4 x RN/4 blocks of 4x4
constexpr int TYM = 16;                // threads down a tile
constexpr int TXN = 16;                // threads across a tile
constexpr int TM = TYM * RM;           // tile rows: batch rows (1.) / F rows (4.)
constexpr int TN = TXN * RN;           // tile columns: the group's columns
constexpr int BK = 16;                 // depth per shared-memory stage
constexpr int APAD = TM + 4;           // row length of the A stage (bank spread)
constexpr int STAGE = BK * APAD + 2 * BK * TN;  // floats of one stage: A, B, mask
constexpr int NSTAGE = 2;              // double-buffered
constexpr int SEA = TM * BK / THREADS;  // staged A elements per thread
constexpr int SEB = TN * BK / THREADS;  // staged B elements per thread
constexpr float EPS = 1e-8f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(TYM * TXN == THREADS, "one thread per micro-tile");
static_assert(RM % 4 == 0 && RN % 4 == 0 && APAD % 4 == 0, "16-byte shared loads");

// Row (column) of a thread's i-th micro-tile row (column): blocks of 4
// consecutive rows, 4 * TYM apart, so each block is one 16-byte load.
__device__ __forceinline__ int tile_row(int ty, int i) { return (i / 4) * 4 * TYM + ty * 4 + i % 4; }
__device__ __forceinline__ int tile_col(int tx, int j) { return (j / 4) * 4 * TXN + tx * 4 + j % 4; }

// a_j from shared memory (the whole batch is resident) or from global
// memory, where other CTAs of the cluster wrote it: read around L1 there.
__device__ __forceinline__ float load_aj(const float* p, size_t i, bool in_shared) {
  return in_shared ? p[i] : __ldcg(p + i);
}

// An asynchronous 4-byte copy from global to shared memory (cp.async), or
// a zero when the element lies outside the array (src is then any valid
// address and nothing is read).  The copies of a stage all fly at once.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  __pipeline_memcpy_async(dst, src, sizeof(float), valid ? 0 : sizeof(float));
}

// One BK-deep stage of acc += A^T B with A staged as As[k][m], B as Bs[k][n].
__device__ __forceinline__ void multiply_stage(const float* As, const float* Bs,
                                               float (&acc)[RM][RN], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float av[RM], bv[RN];
    const float4* a4 = reinterpret_cast<const float4*>(As + kk * APAD);
    const float4* b4 = reinterpret_cast<const float4*>(Bs + kk * TN);
#pragma unroll
    for (int h = 0; h < RM / 4; ++h) {
      const float4 v = a4[h * TYM + ty];
      av[4 * h] = v.x; av[4 * h + 1] = v.y; av[4 * h + 2] = v.z; av[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < RN / 4; ++h) {
      const float4 v = b4[h * TXN + tx];
      bv[4 * h] = v.x; bv[4 * h + 1] = v.y; bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
bcpnn_phase_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ mask,
                   const void* __restrict__ ci, const void* __restrict__ cj,
                   const void* __restrict__ cij, float* __restrict__ aj,
                   void* __restrict__ ci_out, void* __restrict__ cj_out,
                   void* __restrict__ cij_out, float* __restrict__ w_out,
                   float* __restrict__ bias_out, int B, int F, int n_hcu, int n_mcu,
                   int G, int BC, float lam, float one_m, float k_b, float gain,
                   int state_mantissa, int state_in_bf16, int state_out_bf16) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / CL;
  const int H = n_hcu * n_mcu;
  const int SW = G * n_mcu;                       // row stride of S
  const int h0 = group * SW;                      // first column of the group
  const int g_hcus = min(G, n_hcu - group * G);   // the last group may be ragged
  const int HT = g_hcus * n_mcu;
  const int FS = (F + CL - 1) / CL;
  const int f_lo = min(F, rank * FS);
  const int f_hi = min(F, f_lo + FS);

  float* S = smem;                                // BC x SW: partial s, then a_j
  float* stages = S + (static_cast<size_t>(BC) * SW + 3) / 4 * 4;  // NSTAGE x STAGE, aligned
  float* log_cj = stages + NSTAGE * STAGE;        // SW
  float* log_ci = log_cj + SW;                    // FS
  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool resident = BC >= B;
  const float batch = static_cast<float>(B);

  for (int b0 = 0; b0 < B; b0 += BC) {
    const int nrows = min(BC, B - b0);

    // 1. Partial support of this CTA's F slice for the chunk's rows.
    for (int r0 = 0; r0 < nrows; r0 += TM) {
      for (int c0 = 0; c0 < HT; c0 += TN) {
        float acc[RM][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
        // Stage k0's slice into buffer buf: A = x (the chunk's rows x F),
        // B = w and M = mask (F x the group's columns).
        auto fetch = [&](int k0, int buf) {
          float* A = stages + buf * STAGE;
          float* Bt = A + BK * APAD;
          float* Mt = Bt + BK * TN;
#pragma unroll
          for (int u = 0; u < SEA; ++u) {  // consecutive threads walk along F
            const int e = tid + u * THREADS;
            const int m = e / BK, k = e % BK;
            const int lr = r0 + m, gk = k0 + k;
            const bool ok = lr < nrows && gk < f_hi;
            copy_async(A + k * APAD + m, x + (ok ? static_cast<size_t>(b0 + lr) * F + gk : 0), ok);
          }
#pragma unroll
          for (int u = 0; u < SEB; ++u) {
            const int e = tid + u * THREADS;
            const int k = e / TN, n = e % TN;
            const int gk = k0 + k, lc = c0 + n;
            const bool ok = gk < f_hi && lc < HT;
            const size_t idx = ok ? static_cast<size_t>(gk) * H + h0 + lc : 0;
            copy_async(Bt + e, w + idx, ok);
            if (mask != nullptr) copy_async(Mt + e, mask + idx, ok);
          }
          __pipeline_commit();
        };
        const int nk = (f_hi - f_lo + BK - 1) / BK;
        if (nk > 0) fetch(f_lo, 0);
        for (int kt = 0; kt < nk; ++kt) {
          const int buf = kt % NSTAGE;
          if (kt + 1 < nk) {
            fetch(f_lo + (kt + 1) * BK, (kt + 1) % NSTAGE);
            __pipeline_wait_prior(1);
          } else {
            __pipeline_wait_prior(0);
          }
          float* A = stages + buf * STAGE;
          float* Bt = A + BK * APAD;
          if (mask != nullptr) {  // each thread masks the elements it copied
            const float* Mt = Bt + BK * TN;
#pragma unroll
            for (int u = 0; u < SEB; ++u) Bt[tid + u * THREADS] *= Mt[tid + u * THREADS];
          }
          __syncthreads();
          multiply_stage(A, Bt, acc, tx, ty);
          __syncthreads();  // the buffer is free for the stage after next
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int lr = r0 + tile_row(ty, i);
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int lc = c0 + tile_col(tx, j);
            if (lr < nrows && lc < HT) S[static_cast<size_t>(lr) * SW + lc] = acc[i][j];
          }
        }
      }
    }
    cluster.sync();  // every partial of the chunk is in place

    // 2. This CTA's rows: sum the partials in rank order, bias, gain,
    //    softmax per hypercolumn.  Row lr of S is read remotely only by its
    //    owner, so the owner may overwrite it with s and then a_j.
    const int per = (nrows + CL - 1) / CL;
    const int row_lo = min(nrows, rank * per);
    const int row_hi = min(nrows, row_lo + per);
    const int tasks = (row_hi - row_lo) * g_hcus;
    for (int t = warp; t < tasks; t += WARPS) {
      const int lr = row_lo + t / g_hcus;
      const int col0 = (t % g_hcus) * n_mcu;
      const size_t off = static_cast<size_t>(lr) * SW + col0;
      float* row = S + off;
      float m = __int_as_float(0xff800000);  // -inf
      for (int i = lane; i < n_mcu; i += 32) {
        float s = 0.f;
        for (int q = 0; q < CL; ++q) s += cluster.map_shared_rank(S, q)[off + i];
        s = (s + b[h0 + col0 + i]) * gain;
        row[i] = s;
        m = fmaxf(m, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      float z = 0.f;
      for (int i = lane; i < n_mcu; i += 32) z += expf(row[i] - m);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(FULL, z, o);
      float* out = aj + static_cast<size_t>(b0 + lr) * H + h0 + col0;
      for (int i = lane; i < n_mcu; i += 32) {
        const float a = expf(row[i] - m) / z;
        row[i] = a;
        out[i] = a;
      }
    }
    __threadfence();
    cluster.sync();  // a_j of the chunk is final, in S and in global memory
  }

  // 3. The whole batch's a_j for the group's columns into every CTA.
  if (resident) {
    const int per = (B + CL - 1) / CL;
    for (int q = 0; q < CL; ++q) {
      if (q == rank) continue;
      const int lo = min(B, q * per);
      const int hi = min(B, lo + per);
      const float* src = cluster.map_shared_rank(S, q);
      for (int e = tid; e < (hi - lo) * HT; e += THREADS) {
        const size_t idx = static_cast<size_t>(lo + e / HT) * SW + e % HT;
        S[idx] = src[idx];
      }
    }
    cluster.sync();  // no CTA reads another's shared memory after this
  }
  const float* ajp = resident ? S : aj + h0;
  const size_t aj_stride = resident ? SW : H;

  // 4a. c_j' (and the bias) for the group's columns, c_i' for this CTA's F
  //     slice: batch sums, one column per thread, loads unrolled in flight.
  for (int c = tid; c < HT; c += THREADS) {
    float sum = 0.f;
#pragma unroll 8
    for (int r = 0; r < B; ++r) sum += load_aj(ajp, r * aj_stride + c, resident);
    const float v = rne_round(
        one_m * load_state(cj, h0 + c, state_in_bf16) + lam * (sum / batch), state_mantissa);
    const float lc = logf(fmaxf(v, EPS));
    log_cj[c] = lc;
    if (rank == 0) {
      store_state(cj_out, h0 + c, v, state_out_bf16);
      bias_out[h0 + c] = k_b * lc;
    }
  }
  for (int f = f_lo + tid; f < f_hi; f += THREADS) {
    float sum = 0.f;
#pragma unroll 8
    for (int r = 0; r < B; ++r) sum += x[static_cast<size_t>(r) * F + f];
    const float v = rne_round(
        one_m * load_state(ci, f, state_in_bf16) + lam * (sum / batch), state_mantissa);
    if (group == 0) store_state(ci_out, f, v, state_out_bf16);
    log_ci[f - f_lo] = logf(fmaxf(v, EPS));
  }
  __syncthreads();

  // 4b. C_ij' and w' over this CTA's F slice x the group's columns.
  for (int fr0 = f_lo; fr0 < f_hi; fr0 += TM) {
    for (int c0 = 0; c0 < HT; c0 += TN) {
      float acc[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
      // Stage batch rows r0.. into buffer buf: A = x (batch x this CTA's F
      // rows), B = a_j (batch x the group's columns), copied from shared
      // memory when resident, else fetched asynchronously from global.
      auto fetch = [&](int r0, int buf) {
        float* A = stages + buf * STAGE;
        float* Bt = A + BK * APAD;
#pragma unroll
        for (int u = 0; u < SEA; ++u) {
          const int e = tid + u * THREADS;
          const int k = e / TM, m = e % TM;
          const int gb = r0 + k, gf = fr0 + m;
          const bool ok = gb < B && gf < f_hi;
          copy_async(A + k * APAD + m, x + (ok ? static_cast<size_t>(gb) * F + gf : 0), ok);
        }
#pragma unroll
        for (int u = 0; u < SEB; ++u) {
          const int e = tid + u * THREADS;
          const int k = e / TN, n = e % TN;
          const int gb = r0 + k, lc = c0 + n;
          const bool ok = gb < B && lc < HT;
          if (resident) {
            Bt[e] = ok ? S[static_cast<size_t>(gb) * SW + lc] : 0.f;
          } else {
            copy_async(Bt + e, aj + h0 + (ok ? static_cast<size_t>(gb) * H + lc : 0), ok);
          }
        }
        __pipeline_commit();
      };
      const int nk = (B + BK - 1) / BK;
      fetch(0, 0);
      for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
          fetch((kt + 1) * BK, (kt + 1) % NSTAGE);
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();
        const float* A = stages + (kt % NSTAGE) * STAGE;
        multiply_stage(A, A + BK * APAD, acc, tx, ty);
        __syncthreads();  // the buffer is free for the stage after next
      }
#pragma unroll 1
      for (int i = 0; i < RM; ++i) {
        const int gf = fr0 + tile_row(ty, i);
        if (gf >= f_hi) continue;
        const float lci = log_ci[gf - f_lo];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int lc = c0 + tile_col(tx, j);
          if (lc >= HT) continue;
          const size_t idx = static_cast<size_t>(gf) * H + h0 + lc;
          const float v = rne_round(
              one_m * load_state(cij, idx, state_in_bf16) + lam * (acc[i][j] / batch),
              state_mantissa);
          store_state(cij_out, idx, v, state_out_bf16);
          float wv = logf(fmaxf(v, EPS)) - lci - log_cj[lc];
          if (mask != nullptr) wv *= mask[idx];
          w_out[idx] = wv;
        }
      }
    }
  }
}

}  // namespace

// Returns cudaErrorInvalidValue when one row of a hypercolumn group, the
// staging buffers and the F slice's logs do not fit in shared memory, else
// the launch's error.
extern "C" int bcpnn_phase_f32(const float* x, const float* w, const float* b,
                               const float* mask, const void* ci, const void* cj,
                               const void* cij, float* aj, void* ci_out, void* cj_out,
                               void* cij_out, float* w_out, float* bias_out, int B, int F,
                               int n_hcu, int n_mcu, float lam, float one_m, float k_b,
                               float gain, int state_mantissa, int state_in_bf16,
                               int state_out_bf16, cudaStream_t stream) {
  if (B <= 0 || F <= 0 || n_hcu <= 0 || n_mcu <= 0) return cudaErrorInvalidValue;
  const int G = std::min(n_hcu, std::max(1, 128 / n_mcu));
  const int SW = G * n_mcu;
  const int n_groups = (n_hcu + G - 1) / G;
  int CL = 8;  // split F while each rank keeps at least half a tile of rows
  while (CL > 1 && (F + CL - 1) / CL < TM / 2) CL /= 2;

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int FS = (F + CL - 1) / CL;
  // S (rounded up to 16 bytes), the staging buffers, log c_j', log c_i'.
  const size_t fixed = static_cast<size_t>(3 + NSTAGE * STAGE + SW + FS) * sizeof(float);
  const size_t row = static_cast<size_t>(SW) * sizeof(float);
  if (fixed + row > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const int BC = static_cast<int>(
      std::min(static_cast<size_t>(B), (static_cast<size_t>(optin) - fixed) / row));
  const size_t smem = fixed + static_cast<size_t>(BC) * row;
  err = cudaFuncSetAttribute(bcpnn_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_groups * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bcpnn_phase_kernel, x, w, b, mask, ci, cj, cij, aj, ci_out,
                           cj_out, cij_out, w_out, bias_out, B, F, n_hcu, n_mcu, G, BC, lam,
                           one_m, k_b, gain, state_mantissa, state_in_bf16, state_out_bf16);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
