// BCPNN marginal + weight update (Alg. 1 L11-16), f32 arithmetic, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bcpnn_update.py:bcpnn_update_fused.
// Given a_i (B, F), a_j (B, H) and the old traces c_i (F,), c_j (H,),
// C_ij (F, H):
//   c_i'  = (1-lam) c_i  + lam mean_b a_i
//   c_j'  = (1-lam) c_j  + lam mean_b a_j
//   C_ij' = (1-lam) C_ij + lam (a_i^T a_j) / B
//   with state_mantissa m > 0, each trace is then RNE-rounded to m bits
//   (the quantized state tier, rne_round.cuh)
//   w     = [log C_ij' - log c_i' - log c_j'] * mask,  bias = k_b log c_j'
// every log taken of max(., EPS), of the rounded traces when rounding.
// The traces are read in their storage dtype (state_in_bf16) and written
// in theirs (state_out_bf16): bf16 only when m <= 7, where the rounded
// values are exact, so no separate cast pass over C_ij is needed.
//
// The datapath mode (datapath_mantissa d > 0; the template argument DP) is the
// whole reduced-precision learning cycle of the paper's Fig. 3 in this one
// launch, repro/precision/policy.py:quantized_learning_cycle followed by
// :state_quantized_cycle, with q = RNE rounding to d mantissa bits:
//   a_i, a_j rounded once where they are staged (each thread rounds the
//   elements it copied, after its cp.async group lands, before the
//   stage's __syncthreads), so the product and the column sums see q(a);
//   m = q(sum / B) for m_i, m_j and m_ij (after the cluster's rank-order
//   sum, never a partial), each trace q(one_m c + lam m) then the state
//   tier's rounding, w = q(log C_ij' - log c_i' - log c_j') * mask and
//   bias = q(k_b log c_j').  No rounded copy of a_i, a_j or of any stage
//   reaches device memory.  The f32 and state-tier instantiations (DP_OFF)
//   are the code of the f32 kernel.
//
// What bounds it on an H100 (67 TFLOP/s f32 FMA, 3.35 TB/s):
//   - hidden (B=128, F=1568, H=3000, f32 traces, mask): 1.2 GFLOP against
//     ~78 MB (C_ij and the mask in, C_ij' and w out): bytes, 0.023 ms;
//   - readout (B=128, F=3000, H=10): 7.7 MFLOP against 1.9 MB, most of it
//     a_i: bytes, 0.0006 ms; 47 tiles of 64 F rows alone would leave most
//     of the 132 SMs idle.
// The design (the tile itself, product and epilogue, is bcpnn_tile.cuh):
//   - one CTA per (F tile, H tile) loops over the batch, which is the
//     contraction axis: a_i and a_j arrive through a ring of NSTAGE stages
//     of BK batch rows, filled with 16-byte cp.async (4-byte where F or H
//     breaks the alignment), one __syncthreads per stage; each thread keeps
//     an RM x RN micro-tile of a_i^T a_j in registers, read from shared
//     memory as 16-byte vectors;
//   - the column sums behind c_i' and c_j' are taken from the staged
//     stages in the same loop, by every thread (no phase of idle threads);
//     since a CTA sees the whole batch (or its cluster does) for its own
//     columns, the means need no pass across CTAs and no atomics;
//   - the epilogue makes 16-byte loads of C_ij (8-byte for bf16 traces) and
//     of the mask and 16-byte stores of C_ij' and w;
//   - wide (H > 16): 64 x 64 tiles, 4x8 a thread, 128 threads, 26 KB of
//     shared memory: five CTAs an SM, so while some CTAs multiply, others
//     stream their epilogues.  A bulk copy of the tile's C_ij and mask into
//     shared memory during the product (cp.async.bulk on an mbarrier), a
//     register preload of them, and 128 x 64 tiles were each slower in
//     exploratory runs on the card: each cost CTAs an SM;
//   - narrow (H <= 16): 64 x 16 tiles, 2x4 a thread, the batch split over
//     a thread-block cluster of CL <= 8 CTAs: each CTA takes BS batch rows,
//     writes its partial tile and column sums to its shared memory, and
//     after a cluster barrier CTA r sums row share r over the cluster in
//     rank order through distributed shared memory (deterministic, no
//     atomics) and finishes it.  At the readout, 47 F tiles x CL 4 = 188
//     CTAs;
//   - the tile configuration, CL and BS come from a pure function on the
//     host (kernels/bcpnn_update.py:plan) and are passed in.
// Every output element is written once: c_i' by the CTAs of the first H
// tile, c_j' and the bias by rank 0 of the CTAs of the first F tile.  mask
// may be null.  All products are IEEE f32 FMA.
//
// The reduced-means mode (bcpnn_update_means_f32, its own kernel) is the
// update of the paper's MPI backend (Sec. 3): each rank takes the batch
// means of its sub-batch, one all-reduce averages them, and every rank then
// runs the same EWMA.  The means m_i (F), m_j (H) and m_ij (F, H) arrive
// already reduced, so the product and the column sums above are gone:
//   c_i' = (1-lam) c_i + lam m_i,  c_j' = (1-lam) c_j + lam m_j,
//   C_ij' = (1-lam) C_ij + lam m_ij,  w and bias as above,
// through the same trace() and epilogue4 with the mean in place of the
// batch sum (inv_b = 1, so sum * inv_b is the mean exactly).  f32 traces,
// no state tier and no datapath (the trainer refuses both in this mode).
// It is elementwise and bound by bytes: at the MNIST hidden layer it reads
// m_ij, C_ij and the mask and writes C_ij' and w, 20 bytes an element, 94 MB
// (0.028 ms at 3.35 TB/s).  One CTA of 256 threads takes TR rows of one
// column tile of TH <= 1024 columns (both from the host's plan,
// kernels/bcpnn_update.py:means_plan): it takes log c_j' of its columns and
// log c_i' of its rows into shared memory once, then each thread finishes
// runs of four consecutive elements with 16-byte accesses (4-byte where H
// or a base breaks the alignment).  c_i' is written by the CTAs of the first
// column tile, c_j' and the bias by those of the first row tile.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cstdint>
#include <type_traits>
#include <utility>

#include "bcpnn_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bcpnn_tile;

template <int TF_, int TH_, int RM_, int RN_, int BK_, int NSTAGE_, int MINB_>
struct Tile {
  static constexpr int TF = TF_, TH = TH_, RM = RM_, RN = RN_, BK = BK_;
  static constexpr int NSTAGE = NSTAGE_, MINB = MINB_;
  static constexpr int TY = TF / RM;           // threads down the tile (F)
  static constexpr int TX = TH / RN;           // threads across the tile (H)
  static constexpr int THREADS = TX * TY;
  static constexpr int STAGE = BK * (TF + TH);  // floats of one stage: a_i, a_j
  static constexpr int PS = TH + 4;            // row length of the partial tile
  static constexpr int RING = NSTAGE * STAGE > TF * PS ? NSTAGE * STAGE : TF * PS;
  static constexpr int NCOL = cdiv(TF + TH, THREADS);  // summed columns per thread
  static_assert(TF % RM == 0 && TH % RN == 0 && TH % 4 == 0 && vw<RN>() == 4, "tile shape");
};

// Wide: 64 x 64 tiles, 4x8 a thread, 128 threads, at least 4 CTAs an SM
// (26 KB of shared memory each; at most 128 registers a thread).  Narrow,
// for H <= 16: 64 x 16 tiles, 2x4 a thread, 128 threads.
using Wide = Tile<64, 64, 4, 8, 16, 3, 4>;
using Narrow = Tile<64, 16, 2, 4, 16, 3, 4>;

struct Args {
  const float* ai;
  const float* aj;
  const void* ci;
  const void* cj;
  const void* cij;
  const float* mask;
  void* ci_out;
  void* cj_out;
  void* cij_out;
  float* w_out;
  float* bias_out;
  int B, F, H, CL, BS;
  float k_b;
  Update u;
};

// Floats of shared memory: the ring (later the partial tile), the column
// sums and the logs.
template <class T>
__host__ __device__ constexpr int smem_floats() { return T::RING + 2 * (T::TF + T::TH); }

template <class T, bool MASK, bool VA, bool VH, int DP>
__global__ void __launch_bounds__(T::THREADS, T::MINB) bcpnn_update_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TF = T::TF, TH = T::TH, RM = T::RM, RN = T::RN, BK = T::BK;
  constexpr int TX = T::TX, TY = T::TY, THREADS = T::THREADS, NSTAGE = T::NSTAGE;
  constexpr int STAGE = T::STAGE, PS = T::PS;
  const int B = a.B, F = a.F, H = a.H, CL = a.CL;
  const int rank = static_cast<int>(blockIdx.x) % CL;
  const int tile = static_cast<int>(blockIdx.x) / CL;
  const int tiles_h = cdiv(H, TH);
  const int f0 = (tile / tiles_h) * TF;  // neighbouring CTAs: neighbouring columns
  const int h0 = (tile % tiles_h) * TH;
  const int b_lo = min(B, rank * a.BS);
  const int b_hi = min(B, b_lo + a.BS);
  const int nk = cdiv(b_hi - b_lo, BK);
  const int per = cdiv(TF, CL);  // the rows of the tile this CTA finishes
  const int r_lo = min(TF, rank * per);
  const int r_hi = min(TF, min(r_lo + per, F - f0));
  const int cols = min(TH, H - h0);

  float* ring = smem;                    // RING: the stages, then the partial tile
  float* sums = ring + T::RING;          // TF + TH: column sums of a_i, then a_j
  float* log_ci = sums + TF + TH;        // TF
  float* log_cj = log_ci + TF;           // TH

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // Stage t of this CTA's batch rows into ring buffer buf.
  auto fetch = [&](int t, int buf) {
    float* As = ring + buf * STAGE;
    float* Bs = As + BK * TF;
    const int b0 = b_lo + t * BK;
    constexpr int VA_N = VA ? 4 : 1, VH_N = VH ? 4 : 1;
#pragma unroll
    for (int u = 0; u < cdiv(BK * TF / VA_N, THREADS); ++u) {
      const int e = tid + u * THREADS;
      if (e < BK * TF / VA_N) {
        const int k = e / (TF / VA_N), c = (e % (TF / VA_N)) * VA_N;
        const bool ok = b0 + k < b_hi && f0 + c < F;  // F % 4 == 0 with VA: all 4 or none
        copy_async<4 * VA_N>(As + k * TF + c,
                             a.ai + (ok ? static_cast<size_t>(b0 + k) * F + f0 + c : 0), ok);
      }
    }
#pragma unroll
    for (int u = 0; u < cdiv(BK * TH / VH_N, THREADS); ++u) {
      const int e = tid + u * THREADS;
      if (e < BK * TH / VH_N) {
        const int k = e / (TH / VH_N), c = (e % (TH / VH_N)) * VH_N;
        const bool ok = b0 + k < b_hi && h0 + c < H;
        copy_async<4 * VH_N>(Bs + k * TH + c,
                             a.aj + (ok ? static_cast<size_t>(b0 + k) * H + h0 + c : 0), ok);
      }
    }
  };

  // The datapath's q(a_i), q(a_j) on the elements this thread copied into
  // buffer buf (the same indices as fetch, 16-byte accesses where fetch
  // made them; zero fill rounds to zero).
  auto round_stage = [&](int buf) {
    float* As = ring + buf * STAGE;
    float* Bs = As + BK * TF;
    const int dm = a.u.dp_mantissa;
    auto round_run = [dm](float* p, auto vec) {
      if constexpr (decltype(vec)::value) {
        float4 v = *reinterpret_cast<float4*>(p);
        v.x = rne_round(v.x, dm); v.y = rne_round(v.y, dm);
        v.z = rne_round(v.z, dm); v.w = rne_round(v.w, dm);
        *reinterpret_cast<float4*>(p) = v;
      } else {
        *p = rne_round(*p, dm);
      }
    };
    constexpr int VA_N = VA ? 4 : 1, VH_N = VH ? 4 : 1;
#pragma unroll
    for (int u = 0; u < cdiv(BK * TF / VA_N, THREADS); ++u) {
      const int e = tid + u * THREADS;
      if (e < BK * TF / VA_N)
        round_run(As + (e / (TF / VA_N)) * TF + (e % (TF / VA_N)) * VA_N,
                  std::integral_constant<bool, VA>{});
    }
#pragma unroll
    for (int u = 0; u < cdiv(BK * TH / VH_N, THREADS); ++u) {
      const int e = tid + u * THREADS;
      if (e < BK * TH / VH_N)
        round_run(Bs + (e / (TH / VH_N)) * TH + (e % (TH / VH_N)) * VH_N,
                  std::integral_constant<bool, VH>{});
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  float cs[T::NCOL];  // column c = tid + q * THREADS of [a_i tile | a_j tile]
#pragma unroll
  for (int q = 0; q < T::NCOL; ++q) cs[q] = 0.f;

  // The ring: NSTAGE - 1 stages in flight ahead of the one multiplied; every
  // iteration commits one group (empty past the end).
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) fetch(s, s);
    __pipeline_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % NSTAGE;
    __pipeline_wait_prior(NSTAGE - 2);
    if constexpr (DP != DP_OFF) round_stage(buf);
    __syncthreads();  // stage kt is visible; buffer (kt - 1) % NSTAGE is free
    if (kt + NSTAGE - 1 < nk) fetch(kt + NSTAGE - 1, (kt + NSTAGE - 1) % NSTAGE);
    __pipeline_commit();
    const float* As = ring + buf * STAGE;
    const float* Bs = As + BK * TF;
#pragma unroll
    for (int q = 0; q < T::NCOL; ++q) {
      const int c = tid + q * THREADS;
      if (c < TF + TH) {
        const float* col = c < TF ? As + c : Bs + (c - TF);
        const int ld = c < TF ? TF : TH;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) cs[q] += col[kk * ld];
      }
    }
    product_stage<RM, RN, TY, TX, BK>(As, TF, Bs, TH, acc, tx, ty);
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is free

#pragma unroll
  for (int q = 0; q < T::NCOL; ++q)
    if (tid + q * THREADS < TF + TH) sums[tid + q * THREADS] = cs[q];
  cg::cluster_group cluster = cg::this_cluster();
  if (CL > 1) {  // the partial tile into this CTA's shared memory
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int h = 0; h < RN / 4; ++h)
        *reinterpret_cast<float4*>(ring + micro<RM, TY>(ty, i) * PS + (h * TX + tx) * 4) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    cluster.sync();  // every partial tile and column sum is in place
  } else {
    __syncthreads();
  }

  // c_i' for this CTA's rows of the tile, c_j' (and the bias) for its
  // columns, the sums taken over the cluster in rank order.
  for (int c = tid; c < TF + TH; c += THREADS) {
    const bool row = c < TF;
    if (row ? (c < r_lo || c >= r_hi) : c - TF >= cols) continue;
    float s = 0.f;
    for (int q = 0; q < CL; ++q) s += CL > 1 ? cluster.map_shared_rank(sums, q)[c] : sums[c];
    if (row) {
      const float v = trace<DP>(a.u, load_state(a.ci, f0 + c, a.u.in_bf16), s);
      log_ci[c] = logf(fmaxf(v, EPS));
      if (h0 == 0) store_state(a.ci_out, f0 + c, v, a.u.out_bf16);
    } else {
      const int gh = h0 + c - TF;
      const float v = trace<DP>(a.u, load_state(a.cj, gh, a.u.in_bf16), s);
      const float lc = logf(fmaxf(v, EPS));
      log_cj[c - TF] = lc;
      if (f0 == 0 && rank == 0) {
        store_state(a.cj_out, gh, v, a.u.out_bf16);
        a.bias_out[gh] = DP != DP_OFF ? rne_round(a.k_b * lc, a.u.dp_mantissa) : a.k_b * lc;
      }
    }
  }
  __syncthreads();

  if (CL == 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int lr = micro<RM, TY>(ty, i);
      if (lr >= r_hi) continue;
#pragma unroll
      for (int h = 0; h < RN / 4; ++h) {
        const int lc = (h * TX + tx) * 4;
        if (lc >= cols) continue;
        const float s4[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
        epilogue4<VH, MASK, DP>(a.u, a.cij, a.mask, a.cij_out, a.w_out,
                                static_cast<size_t>(f0 + lr) * H + h0 + lc, min(4, cols - lc),
                                s4, log_ci[lr], log_cj + lc);
      }
    }
    return;
  }
  // Split batch: row share `rank` of the tile, summed over the cluster.
  for (int e = tid; e < (r_hi - r_lo) * (TH / 4); e += THREADS) {
    const int lr = r_lo + e / (TH / 4);
    const int lc = (e % (TH / 4)) * 4;
    if (lc >= cols) continue;
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < CL; ++q) {  // rank order: the same sum on every run
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(ring, q) + lr * PS + lc);
      s4[0] += v.x; s4[1] += v.y; s4[2] += v.z; s4[3] += v.w;
    }
    epilogue4<VH, MASK, DP>(a.u, a.cij, a.mask, a.cij_out, a.w_out,
                            static_cast<size_t>(f0 + lr) * H + h0 + lc, min(4, cols - lc), s4,
                            log_ci[lr], log_cj + lc);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <class T, bool MASK, bool VA, bool VH, int DP>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<T>() * sizeof(float);
  auto kernel = bcpnn_update_kernel<T, MASK, VA, VH, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(a.F, T::TF) * cdiv(a.H, T::TH);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.CL);
  cfg.blockDim = dim3(T::THREADS);
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

using Launcher = int (*)(const Args&, cudaStream_t);

// Variant I: I / 8 = the mode (DP_OFF, DP_POW2, DP_DIV), bit 2 = mask, bit
// 1 = 16-byte a_i rows, bit 0 = 16-byte H rows (a_j, C_ij, mask, C_ij', w).
template <class T, int... I>
int dispatch(const Args& a, int variant, cudaStream_t stream, std::integer_sequence<int, I...>) {
  static constexpr Launcher table[] = {
      launch<T, (I & 4) != 0, (I & 2) != 0, (I & 1) != 0, I / 8>...};
  return table[variant](a, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// --- the reduced-means mode ---

constexpr int MEANS_THREADS = 256;
constexpr int MEANS_MAX_TH = 1024;  // columns of a tile
constexpr int MEANS_MAX_TR = 1024;  // rows of a tile

struct MeansArgs {
  const float* mi;
  const float* mj;
  const float* mij;
  const float* ci;
  const float* cj;
  const float* cij;
  const float* mask;
  float* ci_out;
  float* cj_out;
  float* cij_out;
  float* w_out;
  float* bias_out;
  int F, H, TH, TR;
  float k_b;
  Update u;
};

template <bool MASK, bool VEC>
__global__ void __launch_bounds__(MEANS_THREADS) bcpnn_means_kernel(MeansArgs a) {
  __shared__ float log_ci[MEANS_MAX_TR];
  __shared__ __align__(16) float log_cj[MEANS_MAX_TH];
  const int F = a.F, H = a.H, TH = a.TH, TR = a.TR;
  const int tiles_h = cdiv(H, TH);
  const int f0 = (static_cast<int>(blockIdx.x) / tiles_h) * TR;
  const int h0 = (static_cast<int>(blockIdx.x) % tiles_h) * TH;
  const int rows = min(TR, F - f0);
  const int cols = min(TH, H - h0);
  const int tid = threadIdx.x;

  for (int c = tid; c < cols; c += MEANS_THREADS) {
    const int gh = h0 + c;
    const float v = trace(a.u, a.cj[gh], a.mj[gh]);
    const float lc = logf(fmaxf(v, EPS));
    log_cj[c] = lc;
    if (f0 == 0) {
      a.cj_out[gh] = v;
      a.bias_out[gh] = a.k_b * lc;
    }
  }
  for (int r = tid; r < rows; r += MEANS_THREADS) {
    const int gf = f0 + r;
    const float v = trace(a.u, a.ci[gf], a.mi[gf]);
    log_ci[r] = logf(fmaxf(v, EPS));
    if (h0 == 0) a.ci_out[gf] = v;
  }
  __syncthreads();

  const int runs = cdiv(cols, 4);
  for (int e = tid; e < rows * runs; e += MEANS_THREADS) {
    const int r = e / runs;
    const int lc = (e % runs) * 4;
    const int n = min(4, cols - lc);
    const size_t idx = static_cast<size_t>(f0 + r) * H + h0 + lc;
    float m[4];
    load4<VEC>(m, a.mij, idx, 0, n);
    epilogue4<VEC, MASK>(a.u, a.cij, a.mask, a.cij_out, a.w_out, idx, n, m, log_ci[r],
                         log_cj + lc);
  }
}

template <bool MASK, bool VEC>
int launch_means(const MeansArgs& a, cudaStream_t stream) {
  const int tiles = cdiv(a.F, a.TR) * cdiv(a.H, a.TH);
  bcpnn_means_kernel<MASK, VEC><<<tiles, MEANS_THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// config: 0 wide (64 x 64 tiles), 1 narrow (64 x 16, H <= 16); cl: CTAs of
// the cluster that split the batch, bs batch rows each (a multiple of 16);
// datapath_mantissa: 0 for the f32 and state-tier update, 1..23 for the
// datapath mode.  Returns cudaErrorInvalidValue for a plan that leaves a
// slice empty or does not cover the batch, else the launch's error.
extern "C" int bcpnn_update_f32(const float* ai, const float* aj, const void* ci,
                                const void* cj, const void* cij, const float* mask,
                                void* ci_out, void* cj_out, void* cij_out,
                                float* w_out, float* bias_out, int B, int F, int H,
                                float lam, float one_m, float k_b, int state_mantissa,
                                int state_in_bf16, int state_out_bf16, int datapath_mantissa,
                                int config, int cl, int bs, cudaStream_t stream) {
  if (B <= 0 || F <= 0 || H <= 0 || cl < 1 || cl > 8 || bs <= 0 || bs % 16 != 0 ||
      datapath_mantissa < 0 || datapath_mantissa > 23)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(cl) * bs < B || (cl > 1 && static_cast<long long>(cl - 1) * bs >= B))
    return cudaErrorInvalidValue;
  const Update u{lam, one_m, 1.0f / static_cast<float>(B), state_mantissa, state_in_bf16,
                 state_out_bf16, datapath_mantissa, static_cast<float>(B)};
  const Args a{ai, aj, ci, cj, cij, mask, ci_out, cj_out, cij_out, w_out, bias_out,
               B, F, H, cl, bs, k_b, u};
  const bool va = F % 4 == 0 && aligned16(ai);
  const bool vh = H % 4 == 0 && aligned16(aj) && aligned16(cij) && aligned16(cij_out) &&
                  aligned16(w_out) && (mask == nullptr || aligned16(mask));
  const int mode = datapath_mantissa == 0 ? DP_OFF : (B & (B - 1)) == 0 ? DP_POW2 : DP_DIV;
  const int variant = 8 * mode + (mask != nullptr ? 4 : 0) + (va ? 2 : 0) + (vh ? 1 : 0);
  const auto all = std::make_integer_sequence<int, 24>{};
  switch (config) {
    case 0: return dispatch<Wide>(a, variant, stream, all);
    case 1: return dispatch<Narrow>(a, variant, stream, all);
    default: return cudaErrorInvalidValue;
  }
}

// The reduced-means mode: mi (F), mj (H), mij (F, H) are the batch means,
// already all-reduced; ci, cj, cij the old f32 traces; mask may be null.
// th: columns of a tile (a multiple of 4, at most 1024; the last tile may
// be narrower), tr: rows of a tile (at most 1024).  Returns
// cudaErrorInvalidValue for a bad shape or tile, else the launch's error.
extern "C" int bcpnn_update_means_f32(const float* mi, const float* mj, const float* mij,
                                      const float* ci, const float* cj, const float* cij,
                                      const float* mask, float* ci_out, float* cj_out,
                                      float* cij_out, float* w_out, float* bias_out, int F,
                                      int H, float lam, float one_m, float k_b, int th, int tr,
                                      cudaStream_t stream) {
  if (F <= 0 || H <= 0 || th <= 0 || th % 4 != 0 || th > MEANS_MAX_TH || tr <= 0 ||
      tr > MEANS_MAX_TR)
    return cudaErrorInvalidValue;
  // inv_b = 1: trace() takes the mean where the batch kernel takes the sum.
  const Update u{lam, one_m, 1.0f, 0, 0, 0, 0, 1.0f};
  const MeansArgs a{mi, mj, mij, ci, cj, cij, mask, ci_out, cj_out, cij_out, w_out, bias_out,
                    F, H, th, tr, k_b, u};
  const bool vec = H % 4 == 0 && aligned16(mij) && aligned16(cij) && aligned16(cij_out) &&
                   aligned16(w_out) && (mask == nullptr || aligned16(mask));
  if (mask != nullptr) return vec ? launch_means<true, true>(a, stream) : launch_means<true, false>(a, stream);
  return vec ? launch_means<false, true>(a, stream) : launch_means<false, false>(a, stream);
}
