// s = x @ (w * mask) + b in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/masked_matmul.py:masked_matmul.
//
// What bounds each shape of the main path (Listing 1 at MNIST width), at
// the H100's published 67 TFLOP/s of f32 FMA and 3.35 TB/s:
//   - hidden, M=128 (a training batch or a projection chunk), K=1568,
//     N=3000: 1.2 GFLOP against ~38 MB -> bound by operations, 0.018 ms.
//     One row of 47 tiles of 128x64 on 132 SMs: the card fills only if K
//     is split.
//   - hidden, M=1024 (predict's projection chunk): 9.6 GFLOP, bound by
//     operations, 0.144 ms; 376 tiles fill the card without a split.
//   - readout, M=1024, K=3000, N=10: 12.3 MB of x for 61 MFLOP, bound by
//     bytes; N=10 gives one column of tiles, so only a split of K brings
//     enough SMs to stream x.
// The products stay in IEEE f32 FMA (no TF32: the f32 reference would be
// ~1e-3 away), so the tensor cores are not used.  The design:
//   - block tiles of BM x BN with a TM x TN register micro-tile per thread
//     (8x8 on the wide tile), read from shared memory as 16-byte vectors:
//     x is staged row-major (BK + 4 floats a row, so the rows a warp reads
//     sit in different banks) and read 4 k at a time, w is staged k-major
//     and read 4 columns at a time;
//   - a ring of NSTAGE stages filled with 16-byte cp.async (4-byte where a
//     row stride or base is not 16-byte aligned, e.g. K=17 or N=10), so
//     the next stages' loads fly while the current one is multiplied; one
//     __syncthreads per stage;
//   - the mask never reaches device memory as w * mask: each thread
//     multiplies the w elements it copied by the mask elements it copied,
//     in the staged tile, before the stage is published;
//   - split K: a thread-block cluster of CL <= 8 CTAs shares one output
//     tile, each CTA takes one slice of K (a multiple of BK), writes its
//     partial tile to its own shared memory, and after a cluster barrier
//     CTA r sums row share r of the tile over the CL partials in rank
//     order through distributed shared memory, adds the bias and stores
//     it: deterministic, no atomics, no workspace;
//   - two tile configurations (wide 128x64, narrow 64x16 for N <= 16),
//     with CL and the K slice chosen by a pure function on the host
//     (kernels/masked_matmul.py:plan) and passed in.
// mask == nullptr and bias == nullptr are compile-time variants, as are the
// 16-byte paths of x and of w/mask/out.  Ragged M, N and K are zero-filled
// on load (cp.async with a source size of 0) and skipped on store.
//
// The rounding mode (round_mantissa d > 0; the template flag ROUND) is the
// support stage of the reduced datapath (paper Fig. 3,
// repro/precision/policy.py:quantized_forward), with q = RNE rounding of
// the f32 mantissa to d bits (rne_round.cuh):
//   s = q(q(q(x) @ q(w * mask) + q(b)) * gain)
// The operands are rounded once per staged element: each thread rounds the
// x and w elements it copied after its cp.async group lands and before the
// stage's __syncthreads, with the mask multiply (q(w) * mask equals
// q(w * mask) bit for bit for a 0/1 mask).  The bias, the sum and the gain
// are rounded in store4, which a split-K cluster reaches only with the
// rank-order sum of the partial tiles, never with a partial.  No rounded
// copy of an operand reaches device memory, so the mode moves the bytes of
// the f32 product.  The f32 instantiations (ROUND false) are the code of
// the f32 kernel.
//
// The gathered variant (the GatherArgs overload of masked_matmul_kernel)
// is the product through a receptive-field mask given per hypercolumn: x
// (M, K = P * pre_mcu) @ w (K, N = Hh * post_mcu), where hidden HCU h reads
// only the input HCUs of its kept list (hcu_mask[:, h] != 0, ascending;
// built on the device by build_kept_lists, once per mask).  At the STL-10
// width (K = 55,296, N = 3,000, 1,024 of 27,648 input HCUs kept) the mask
// keeps 3.7% of K, so the dense kernel multiplies 96% zeros and streams the
// whole F x H w and mask; the kept pairs are 1.57 GFLOP against ~57 MB at
// M = 128 (bound by operations, 0.023 ms) and 12.6 GFLOP at M = 1,024
// (0.188 ms).  The design:
//   - an output tile is BM rows x BN columns of one hidden HCU (BN = 160
//     covers STL-10's 150 minicolumns, so x is gathered once a row block);
//     its columns start at the HCU's first column rounded down to a
//     multiple of 4, so every w row and output row is read and written in
//     16-byte pieces even where h * post_mcu is only 8-byte aligned, and
//     columns outside the HCU are computed but not stored;
//   - a stage is BK kept input units: x's columns gathered from the kept
//     list (8-byte copies of the two-unit complementary code, 4-byte
//     otherwise), w's BK kept rows x BN columns contiguous, through the
//     same cp.async ring and register micro-tile as the dense tiles; no
//     mask is read, since a kept row's mask is 1;
//   - each thread reads its next stage's list entries one stage ahead, so
//     the list's latency hides behind a stage of multiply-adds;
//   - the kept list is split over a thread-block cluster, each CTA taking
//     an even share of the HCU's stages in rank order, and the partial
//     tiles are summed in rank order through distributed shared memory, as
//     the dense tiles' split K is: deterministic, no atomics.  Unequal
//     counts and a count of 0 (the bias alone) need nothing more.
// The launch plan (gathered or dense, and the cluster size) comes from
// kernels/masked_matmul.py:plan.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cstdint>
#include <utility>

#include "rne_round.cuh"

namespace cg = cooperative_groups;

namespace {

template <int BM_, int BN_, int BK_, int TM_, int TN_, int NSTAGE_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int NSTAGE = NSTAGE_, MINB = MINB_;
  static constexpr int TY = BM / TM;        // threads down the tile
  static constexpr int TX = BN / TN;        // threads across the tile
  static constexpr int THREADS = TX * TY;
  static constexpr int AP = BK + 4;         // row length of the staged x tile
  static constexpr int PS = BN + 4;         // row length of the partial tile
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % 4 == 0 && BK % 4 == 0, "tile shape");
  static_assert((BM * BK / 4) % THREADS == 0 && (BK * BN / 4) % THREADS == 0, "staging");
};

// The configurations, by the index the host passes (masked_matmul.py:CONFIGS).
// Wide: 128 threads, 3 CTAs an SM (162 KB of shared memory with the mask
// stages; the 170 registers a thread may then hold keep the 8x8 tile and
// its fragments out of local memory).  Narrow, for N <= 16: 128 threads.
using Wide = Tile<128, 64, 16, 8, 8, 3, 3>;
using Narrow = Tile<64, 16, 32, 2, 4, 4, 4>;
// The gathered variant's tile: 64 rows x 160 columns of one hidden HCU,
// 160 threads, 4 stages (60 KB of shared memory), 3 CTAs an SM.
struct Gathered {
  static constexpr int BM = 64, BN = 160, BK = 16, TM = 8, TN = 8, NSTAGE = 4, MINB = 3;
  static constexpr int TY = BM / TM, TX = BN / TN, THREADS = TX * TY;
  static constexpr int AP = BK + 4, PS = BN + 4;
};

template <class T, bool MASK>
__host__ __device__ constexpr int stage_floats() { return T::BM * T::AP + (MASK ? 2 : 1) * T::BK * T::BN; }

template <class T, bool MASK>
__host__ __device__ constexpr int smem_floats() {
  const int ring = T::NSTAGE * stage_floats<T, MASK>();
  const int partial = T::BM * T::PS;
  return ring > partial ? ring : partial;
}

// Column of a thread's j-th micro-tile column: blocks of 4 consecutive
// columns, 4 * TX apart, so each block is one 16-byte access.
template <class T>
__device__ __forceinline__ int tile_col(int tx, int j) { return (j / 4) * 4 * T::TX + tx * 4 + j % 4; }

// Asynchronous copy of `bytes` (4 or 16) from global to shared memory, or
// zeros when the source lies outside the array (nothing is then read; src
// is any valid address).
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  __pipeline_memcpy_async(dst, src, BYTES, valid ? 0 : BYTES);
}

struct Args {
  const float* x;
  const float* w;
  const float* mask;
  const float* bias;
  float* out;
  int M, K, N, CL, KS;
  int round_m;  // the rounding mode's mantissa (read only with ROUND) ...
  float gain;   // ... and the gain it applies to the rounded support
};

template <class T, bool VA, bool VN, bool MASK, bool BIAS, bool ROUND>
__global__ void __launch_bounds__(T::THREADS, T::MINB) masked_matmul_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM, TN = T::TN;
  constexpr int TX = T::TX, TY = T::TY, THREADS = T::THREADS, AP = T::AP;
  constexpr int NSTAGE = T::NSTAGE, STAGE = stage_floats<T, MASK>();
  const float* __restrict__ x = a.x;
  const float* __restrict__ w = a.w;
  const float* __restrict__ mask = a.mask;
  const int M = a.M, K = a.K, N = a.N, CL = a.CL;

  const int rank = static_cast<int>(blockIdx.x) % CL;
  const int tile = static_cast<int>(blockIdx.x) / CL;
  const int tiles_m = (M + BM - 1) / BM;
  const int m0 = (tile % tiles_m) * BM;  // neighbouring tiles share a w panel
  const int n0 = (tile / tiles_m) * BN;
  const int k_lo = min(K, rank * a.KS);
  const int k_hi = min(K, k_lo + a.KS);
  const int nk = (k_hi - k_lo + BK - 1) / BK;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // Stage t of this CTA's K slice into ring buffer buf.
  auto fetch = [&](int t, int buf) {
    float* As = smem + buf * STAGE;
    float* Bs = As + BM * AP;
    float* Ms = Bs + BK * BN;
    const int k0 = k_lo + t * BK;
    if constexpr (VA) {
#pragma unroll
      for (int u = 0; u < BM * BK / 4 / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int m = e / (BK / 4), k = (e % (BK / 4)) * 4;
        const bool ok = m0 + m < M && k0 + k < k_hi;  // K % 4 == 0: all 4 or none
        copy_async<16>(As + m * AP + k, x + (ok ? static_cast<size_t>(m0 + m) * K + k0 + k : 0), ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < BM * BK / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int m = e / BK, k = e % BK;
        const bool ok = m0 + m < M && k0 + k < k_hi;
        copy_async<4>(As + m * AP + k, x + (ok ? static_cast<size_t>(m0 + m) * K + k0 + k : 0), ok);
      }
    }
    if constexpr (VN) {
#pragma unroll
      for (int u = 0; u < BK * BN / 4 / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int k = e / (BN / 4), n = (e % (BN / 4)) * 4;
        const bool ok = k0 + k < k_hi && n0 + n < N;  // N % 4 == 0: all 4 or none
        const size_t idx = ok ? static_cast<size_t>(k0 + k) * N + n0 + n : 0;
        copy_async<16>(Bs + k * BN + n, w + idx, ok);
        if constexpr (MASK) copy_async<16>(Ms + k * BN + n, mask + idx, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < BK * BN / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int k = e / BN, n = e % BN;
        const bool ok = k0 + k < k_hi && n0 + n < N;
        const size_t idx = ok ? static_cast<size_t>(k0 + k) * N + n0 + n : 0;
        copy_async<4>(Bs + e, w + idx, ok);
        if constexpr (MASK) copy_async<4>(Ms + e, mask + idx, ok);
      }
    }
  };

  // w * mask on the elements this thread copied into buffer buf.
  auto apply_mask = [&](int buf) {
    float* Bs = smem + buf * STAGE + BM * AP;
    const float* Ms = Bs + BK * BN;
    if constexpr (VN) {
#pragma unroll
      for (int u = 0; u < BK * BN / 4 / THREADS; ++u) {
        const int e = 4 * (tid + u * THREADS);
        float4 b = *reinterpret_cast<float4*>(Bs + e);
        const float4 m = *reinterpret_cast<const float4*>(Ms + e);
        b.x *= m.x; b.y *= m.y; b.z *= m.z; b.w *= m.w;
        *reinterpret_cast<float4*>(Bs + e) = b;
      }
    } else {
#pragma unroll
      for (int u = 0; u < BK * BN / THREADS; ++u) Bs[tid + u * THREADS] *= Ms[tid + u * THREADS];
    }
  };

  // The rounding mode's q(x) and q(w) (times the mask) on the elements this
  // thread copied into buffer buf: the indices of fetch.
  auto round_stage = [&](int buf) {
    float* As = smem + buf * STAGE;
    float* Bs = As + BM * AP;
    const float* Ms = Bs + BK * BN;
    const int d = a.round_m;
    if constexpr (VA) {
#pragma unroll
      for (int u = 0; u < BM * BK / 4 / THREADS; ++u) {
        const int e = tid + u * THREADS;
        float4* p = reinterpret_cast<float4*>(As + (e / (BK / 4)) * AP + (e % (BK / 4)) * 4);
        float4 v = *p;
        v.x = rne_round(v.x, d); v.y = rne_round(v.y, d); v.z = rne_round(v.z, d); v.w = rne_round(v.w, d);
        *p = v;
      }
    } else {
#pragma unroll
      for (int u = 0; u < BM * BK / THREADS; ++u) {
        const int e = tid + u * THREADS;
        float* p = As + (e / BK) * AP + e % BK;
        *p = rne_round(*p, d);
      }
    }
    if constexpr (VN) {
#pragma unroll
      for (int u = 0; u < BK * BN / 4 / THREADS; ++u) {
        const int e = 4 * (tid + u * THREADS);
        float4 b = *reinterpret_cast<float4*>(Bs + e);
        b.x = rne_round(b.x, d); b.y = rne_round(b.y, d); b.z = rne_round(b.z, d); b.w = rne_round(b.w, d);
        if constexpr (MASK) {
          const float4 m = *reinterpret_cast<const float4*>(Ms + e);
          b.x *= m.x; b.y *= m.y; b.z *= m.z; b.w *= m.w;
        }
        *reinterpret_cast<float4*>(Bs + e) = b;
      }
    } else {
#pragma unroll
      for (int u = 0; u < BK * BN / THREADS; ++u) {
        const int e = tid + u * THREADS;
        float b = rne_round(Bs[e], d);
        if constexpr (MASK) b *= Ms[e];
        Bs[e] = b;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The ring: NSTAGE - 1 stages in flight ahead of the one multiplied.
  // Every iteration commits one group (empty past the end), so waiting
  // until NSTAGE - 2 groups are pending means stage kt has landed.
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) fetch(s, s);
    __pipeline_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % NSTAGE;
    __pipeline_wait_prior(NSTAGE - 2);
    if constexpr (ROUND) {
      round_stage(buf);
    } else if constexpr (MASK) {
      apply_mask(buf);
    }
    __syncthreads();  // stage kt is visible; buffer (kt - 1) % NSTAGE is free
    if (kt + NSTAGE - 1 < nk) fetch(kt + NSTAGE - 1, (kt + NSTAGE - 1) % NSTAGE);
    __pipeline_commit();

    const float* As = smem + buf * STAGE;
    const float* Bs = As + BM * AP;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(As + (ty + TY * i) * AP + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(Bs + (k4 + q) * BN + h * 4 * TX + tx * 4);
          bv[4 * h] = v.x; bv[4 * h + 1] = v.y; bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }

  // The bias as the support adds it: q(b) in the rounding mode.
  auto qb = [&](float b) {
    if constexpr (ROUND) {
      return rne_round(b, a.round_m);
    } else {
      return b;
    }
  };

  // Store 4 consecutive columns of row gm starting at gn (bias added; in
  // the rounding mode v = q(q(v + q(b)) * gain)).
  auto store4 = [&](int gm, int gn, float4 v) {
    if (gm >= M || gn >= N) return;
    float* dst = a.out + static_cast<size_t>(gm) * N + gn;
    if constexpr (BIAS) {
      if constexpr (VN) {
        const float4 b = *reinterpret_cast<const float4*>(a.bias + gn);
        v.x += qb(b.x); v.y += qb(b.y); v.z += qb(b.z); v.w += qb(b.w);
      } else {
        v.x += qb(a.bias[gn]);
        if (gn + 1 < N) v.y += qb(a.bias[gn + 1]);
        if (gn + 2 < N) v.z += qb(a.bias[gn + 2]);
        if (gn + 3 < N) v.w += qb(a.bias[gn + 3]);
      }
    }
    if constexpr (ROUND) {
      const int d = a.round_m;
      v.x = rne_round(rne_round(v.x, d) * a.gain, d);
      v.y = rne_round(rne_round(v.y, d) * a.gain, d);
      v.z = rne_round(rne_round(v.z, d) * a.gain, d);
      v.w = rne_round(rne_round(v.w, d) * a.gain, d);
    }
    if constexpr (VN) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (gn + 1 < N) dst[1] = v.y;
      if (gn + 2 < N) dst[2] = v.z;
      if (gn + 3 < N) dst[3] = v.w;
    }
  };

  if (CL == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        store4(m0 + ty + TY * i, n0 + tile_col<T>(tx, 4 * h),
               make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
    return;
  }

  // Split K: the partial tile into this CTA's shared memory (the ring is
  // drained and free), then row share `rank` summed over the cluster.
  __pipeline_wait_prior(0);
  __syncthreads();
  constexpr int PS = T::PS;
  float* P = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      *reinterpret_cast<float4*>(P + (ty + TY * i) * PS + tile_col<T>(tx, 4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial of the tile is in place
  const int per = (BM + CL - 1) / CL;
  const int r_lo = min(BM, rank * per);
  const int r_hi = min(BM, r_lo + per);
  for (int e = tid; e < (r_hi - r_lo) * (BN / 4); e += THREADS) {
    const int r = r_lo + e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < CL; ++q) {  // rank order: the same sum on every run
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(P, q) + r * PS + c);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    store4(m0 + r, n0 + c, s);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The gathered variant's multiply and epilogue.  They are the dense
// kernel's loop and split-K sum; the dense kernel keeps its own copy,
// since compiled through these helpers its wide tile ran 5-8% slower on an
// H100 (the same code, other register allocation).
//
// acc += the staged x tile (BM x BK, rows AP apart) times the staged w tile
// (BK x BN, k-major) on this thread's TM x TN register micro-tile: rows
// ty + TY * i, columns tile_col(tx, j).
template <class T>
__device__ __forceinline__ void multiply_stage(const float* As, const float* Bs,
                                               float (&acc)[T::TM][T::TN], int tx, int ty) {
  constexpr int BK = T::BK, BN = T::BN, TM = T::TM, TN = T::TN, TX = T::TX, TY = T::TY;
  constexpr int AP = T::AP;
#pragma unroll
  for (int k4 = 0; k4 < BK; k4 += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(As + (ty + TY * i) * AP + k4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float bv[TN];
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + (k4 + q) * BN + h * 4 * TX + tx * 4);
        bv[4 * h] = v.x; bv[4 * h + 1] = v.y; bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
      }
    }
  }
}

// The tile's sum to the output through store4(r, c, v), r a row and c the
// first of 4 columns of the tile: straight from the registers when one CTA
// covers the contraction (CL == 1); else each CTA's partial tile into its
// own shared memory (the ring is drained and free), then row share `rank`
// of the tile summed over the cluster in rank order through distributed
// shared memory: deterministic, no atomics, no workspace.
template <class T, class Store>
__device__ __forceinline__ void finish(float (&acc)[T::TM][T::TN], float* smem, int CL, int rank,
                                       int tid, int tx, int ty, Store store4) {
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, TY = T::TY, PS = T::PS;
  if (CL == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        store4(ty + TY * i, tile_col<T>(tx, 4 * h),
               make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
    return;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  float* P = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      *reinterpret_cast<float4*>(P + (ty + TY * i) * PS + tile_col<T>(tx, 4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial of the tile is in place
  const int per = (BM + CL - 1) / CL;
  const int r_lo = min(BM, rank * per);
  const int r_hi = min(BM, r_lo + per);
  for (int e = tid; e < (r_hi - r_lo) * (BN / 4); e += T::THREADS) {
    const int r = r_lo + e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < CL; ++q) {  // rank order: the same sum on every run
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(P, q) + r * PS + c);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    store4(r, c, s);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

struct GatherArgs {
  const float* x;
  const float* w;
  const int* kept;    // (n_post_hcu, n_pre_hcu): each hidden HCU's kept input HCUs, ascending
  const int* counts;  // (n_post_hcu,): how many of its entries are kept
  const float* bias;
  float* out;
  int M, K, N, CL;
  int n_pre_hcu, pre_mcu, n_post_hcu, post_mcu;
  int tiles_c;  // column tiles of a hidden HCU
};

// The gathered variant: hidden HCU h's output columns from its kept input
// units alone (the note at the head of this file).  VN: 16-byte w and
// output (N % 4 == 0, aligned bases); PAIR: two-unit input HCUs copied as
// one 8-byte piece of x.
template <class T, bool VN, bool BIAS, bool PAIR>
__global__ void __launch_bounds__(T::THREADS, T::MINB) masked_matmul_kernel(GatherArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM, TN = T::TN, TY = T::TY;
  constexpr int THREADS = T::THREADS, AP = T::AP, NSTAGE = T::NSTAGE;
  constexpr int STAGE = stage_floats<T, false>();
  constexpr int XSLOT = PAIR ? BK / 2 : BK;  // x copies in one row of a stage
  constexpr int XROWS = THREADS / XSLOT;     // rows one pass of the CTA's x copies covers
  constexpr int WQ = BN / 4;                 // 4-column pieces of a staged w row
  constexpr int WROWS = THREADS / WQ;        // w rows one pass covers
  constexpr int WPASS = BK / WROWS;
  static_assert(THREADS % XSLOT == 0 && THREADS % WQ == 0 && BK % WROWS == 0 && BK % 2 == 0,
                "gathered staging");
  const float* __restrict__ x = a.x;
  const float* __restrict__ w = a.w;
  const int M = a.M, K = a.K, N = a.N, CL = a.CL;

  // Tiles in the order column tile, hidden HCU, row block: the HCUs of one
  // row block run side by side and share its x in L2.
  const int rank = static_cast<int>(blockIdx.x) % CL;
  int tile = static_cast<int>(blockIdx.x) / CL;
  const int jc = tile % a.tiles_c;
  tile /= a.tiles_c;
  const int hh = tile % a.n_post_hcu;
  const int m0 = (tile / a.n_post_hcu) * BM;
  const int lo = hh * a.post_mcu, hi = lo + a.post_mcu;  // the HCU's columns
  const int n0 = (VN ? lo & ~3 : lo) + jc * BN;
  if (n0 >= hi) return;  // nothing of the HCU here: the cluster shares the tile and leaves whole

  const int* __restrict__ kept = a.kept + static_cast<size_t>(hh) * a.n_pre_hcu;
  const int units = __ldg(a.counts + hh) * a.pre_mcu;  // kept input units of the HCU
  const int stages = (units + BK - 1) / BK;
  const int t_lo = stages * rank / CL;  // this rank's share of the stages
  const int nk = stages * (rank + 1) / CL - t_lo;
  const int u_lo = t_lo * BK;
  const int u_hi = min(units, u_lo + nk * BK);

  // Threads down the tile fastest: a warp reads 4 column groups of the
  // staged w tile and 8 rows of x, one shared-memory wavefront each.
  const int tid = threadIdx.x;
  const int ty = tid % TY;
  const int tx = tid / TY;

  // The column of x and row of w of kept unit u of this HCU; -1 past the slice.
  auto row_of = [&](int u) -> int {
    if (u >= u_hi) return -1;
    if constexpr (PAIR) {
      return 2 * __ldg(kept + (u >> 1)) + (u & 1);
    } else {
      const int q = u / a.pre_mcu;
      return __ldg(kept + q) * a.pre_mcu + (u - q * a.pre_mcu);
    }
  };
  const int xu = (tid % XSLOT) * (PAIR ? 2 : 1);  // this thread's unit in every x copy
  const int wu = tid / WQ;                        // its first w row of a stage
  const int wn = (tid % WQ) * 4;                  // and the 4 columns it copies
  int xr, wr[WPASS];  // the rows of those units in the next stage to fetch
  auto rows_of_stage = [&](int t) {
    const int u0 = u_lo + t * BK;
    xr = row_of(u0 + xu);
#pragma unroll
    for (int j = 0; j < WPASS; ++j) wr[j] = row_of(u0 + wu + j * WROWS);
  };

  // The stage whose rows xr, wr hold into ring buffer buf; zeros past the
  // slice, the rows and the columns.
  auto fetch = [&](int buf) {
    float* As = smem + buf * STAGE;
    float* Bs = As + BM * AP;
    for (int m = tid / XSLOT; m < BM; m += XROWS) {
      const bool ok = xr >= 0 && m0 + m < M;
      const float* src = x + (ok ? static_cast<size_t>(m0 + m) * K + xr : 0);
      if constexpr (PAIR) {
        copy_async<8>(As + m * AP + xu, src, ok);
      } else {
        copy_async<4>(As + m * AP + xu, src, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < WPASS; ++j) {
      const int r = wr[j];
      float* dst = Bs + (wu + j * WROWS) * BN + wn;
      if constexpr (VN) {
        const bool ok = r >= 0 && n0 + wn < N;  // N % 4 == 0: all 4 or none
        copy_async<16>(dst, w + (ok ? static_cast<size_t>(r) * N + n0 + wn : 0), ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = r >= 0 && n0 + wn + q < N;
          copy_async<4>(dst + q, w + (ok ? static_cast<size_t>(r) * N + n0 + wn + q : 0), ok);
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The ring as in the dense kernel; each fetch then reads the list entries
  // of the stage after it.
  rows_of_stage(0);
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) {
      fetch(s);
      rows_of_stage(s + 1);
    }
    __pipeline_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % NSTAGE;
    __pipeline_wait_prior(NSTAGE - 2);
    __syncthreads();  // stage kt is visible; buffer (kt - 1) % NSTAGE is free
    if (kt + NSTAGE - 1 < nk) {
      fetch((kt + NSTAGE - 1) % NSTAGE);
      rows_of_stage(kt + NSTAGE);
    }
    __pipeline_commit();
    multiply_stage<T>(smem + buf * STAGE, smem + buf * STAGE + BM * AP, acc, tx, ty);
  }

  // Store 4 consecutive columns of tile row r from tile column c, bias
  // added, keeping only the columns of this HCU.
  auto store4 = [&](int r, int c, float4 v) {
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= hi) return;
    float* dst = a.out + static_cast<size_t>(gm) * N;
    float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if constexpr (BIAS) vals[q] += (gn + q >= lo && gn + q < hi) ? __ldg(a.bias + gn + q) : 0.f;
    if (VN && gn >= lo && gn + 4 <= hi) {
      *reinterpret_cast<float4*>(dst + gn) = make_float4(vals[0], vals[1], vals[2], vals[3]);
      return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (gn + q >= lo && gn + q < hi) dst[gn + q] = vals[q];
  };

  finish<T>(acc, smem, CL, rank, tid, tx, ty, store4);
}

// The gathered variant's kept lists, one CTA a hidden HCU h: the input HCUs
// i with mask[i, h] != 0 (mask: n_pre_hcu x n_post_hcu, row-major) in
// ascending order, compacted a block of i at a time (warp ballots, then the
// warps' counts in order), and their count.
__global__ void __launch_bounds__(256) build_kept_lists(const float* __restrict__ mask, int n_pre,
                                                        int n_post, int* __restrict__ kept,
                                                        int* __restrict__ counts) {
  __shared__ int warp_kept[8];
  const int h = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int* out = kept + static_cast<size_t>(h) * n_pre;
  int base = 0;
  for (int i0 = 0; i0 < n_pre; i0 += 256) {
    const int i = i0 + static_cast<int>(threadIdx.x);
    const bool on = i < n_pre && mask[static_cast<size_t>(i) * n_post + h] != 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      before += v < warp ? warp_kept[v] : 0;
      total += warp_kept[v];
    }
    if (on) out[base + before] = i;
    base += total;
    __syncthreads();  // warp_kept is written again in the next block
  }
  if (threadIdx.x == 0) counts[h] = base;
}

// Launch `kernel` over `ctas` CTAs of `threads` threads in clusters of `cl`
// CTAs, with `smem` bytes of dynamic shared memory (set on every call: above
// 48 KB it needs the attribute).
template <class A>
int launch_clusters(void (*kernel)(A), const A& a, int ctas, int threads, size_t smem, int cl,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool VA, bool VN, bool MASK, bool BIAS, bool ROUND>
int launch(const Args& a, cudaStream_t stream) {
  const int tiles = ((a.M + T::BM - 1) / T::BM) * ((a.N + T::BN - 1) / T::BN);
  return launch_clusters<Args>(masked_matmul_kernel<T, VA, VN, MASK, BIAS, ROUND>, a, tiles * a.CL,
                               T::THREADS, smem_floats<T, MASK>() * sizeof(float), a.CL, stream);
}

using Launcher = int (*)(const Args&, cudaStream_t);

// Variant I: bit 4 = the rounding mode, bit 3 = 16-byte x, bit 2 = 16-byte
// w/mask/out, bit 1 = mask, bit 0 = bias.
template <class T, int I>
int launch_variant(const Args& a, cudaStream_t stream) {
  return launch<T, (I & 8) != 0, (I & 4) != 0, (I & 2) != 0, (I & 1) != 0, (I & 16) != 0>(a, stream);
}

template <class T, int... I>
int dispatch(const Args& a, int variant, cudaStream_t stream, std::integer_sequence<int, I...>) {
  static constexpr Launcher table[] = {launch_variant<T, I>...};
  return table[variant](a, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// config: 0 wide (128x64 tiles), 1 narrow (64x16, N <= 16); cl: CTAs of
// the cluster that split K, each over ks elements of it (a multiple of the
// configuration's BK, so a multiple of 4); round_mantissa: 0 for the f32
// product, 1..23 for the rounding mode, whose support is multiplied by gain.
// Returns cudaErrorInvalidValue for a plan that leaves a slice empty or
// does not cover K, else the launch's error.
extern "C" int masked_matmul_f32(const float* x, const float* w, const float* mask,
                                 const float* bias, float* out, int M, int K, int N,
                                 int config, int cl, int ks, int round_mantissa, float gain,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || cl < 1 || cl > 8 || ks <= 0 || ks % 4 != 0 ||
      round_mantissa < 0 || round_mantissa > 23)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(cl) * ks < K || (cl > 1 && static_cast<long long>(cl - 1) * ks >= K))
    return cudaErrorInvalidValue;
  const Args a{x, w, mask, bias, out, M, K, N, cl, ks, round_mantissa, gain};
  const bool va = K % 4 == 0 && aligned16(x);
  const bool vn = N % 4 == 0 && aligned16(w) && aligned16(out) &&
                  (mask == nullptr || aligned16(mask)) && (bias == nullptr || aligned16(bias));
  const int variant = (round_mantissa > 0 ? 16 : 0) | (va ? 8 : 0) | (vn ? 4 : 0) |
                      (mask != nullptr ? 2 : 0) | (bias != nullptr ? 1 : 0);
  const auto all = std::make_integer_sequence<int, 32>{};
  switch (config) {
    case 0: return dispatch<Wide>(a, variant, stream, all);
    case 1: return dispatch<Narrow>(a, variant, stream, all);
    default: return cudaErrorInvalidValue;
  }
}

// The gathered variant's kept lists from the (n_pre_hcu, n_post_hcu) f32
// HCU mask: kept (n_post_hcu, n_pre_hcu) int32, each row's first counts[h]
// entries the kept input HCUs in ascending order, the rest left as they are.
extern "C" int masked_matmul_kept_lists(const float* hcu_mask, int n_pre_hcu, int n_post_hcu,
                                        int* kept, int* counts, cudaStream_t stream) {
  if (n_pre_hcu <= 0 || n_post_hcu <= 0) return cudaErrorInvalidValue;
  build_kept_lists<<<n_post_hcu, 256, 0, stream>>>(hcu_mask, n_pre_hcu, n_post_hcu, kept, counts);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int I>
int launch_gathered(const GatherArgs& a, int ctas, cudaStream_t stream) {
  using T = Gathered;
  return launch_clusters<GatherArgs>(
      masked_matmul_kernel<T, (I & 4) != 0, (I & 1) != 0, (I & 2) != 0>, a, ctas * a.CL,
      T::THREADS, smem_floats<T, false>() * sizeof(float), a.CL, stream);
}

bool aligned8(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 8 == 0; }

}  // namespace

// The gathered product: x (M, n_pre_hcu * pre_mcu) @ w (.., n_post_hcu *
// post_mcu) through the HCU mask whose kept lists masked_matmul_kept_lists
// made, + bias, into out; the kept list of each hidden HCU split over
// clusters of cl CTAs.
extern "C" int masked_matmul_gathered_f32(const float* x, const float* w, const int* kept,
                                          const int* counts, const float* bias, float* out, int M,
                                          int n_pre_hcu, int pre_mcu, int n_post_hcu,
                                          int post_mcu, int cl, cudaStream_t stream) {
  if (M <= 0 || n_pre_hcu <= 0 || pre_mcu <= 0 || n_post_hcu <= 0 || post_mcu <= 0 || cl < 1 ||
      cl > 8)
    return cudaErrorInvalidValue;
  const long long K = static_cast<long long>(n_pre_hcu) * pre_mcu;
  const long long N = static_cast<long long>(n_post_hcu) * post_mcu;
  if (K > INT_MAX || N > INT_MAX) return cudaErrorInvalidValue;
  const bool vn = N % 4 == 0 && aligned16(w) && aligned16(out);
  const bool pair = pre_mcu == 2 && aligned8(x);
  const int tiles_c = (post_mcu + (vn ? 3 : 0) + Gathered::BN - 1) / Gathered::BN;
  const long long ctas = static_cast<long long>((M + Gathered::BM - 1) / Gathered::BM) *
                         n_post_hcu * tiles_c;
  if (ctas * cl > INT_MAX) return cudaErrorInvalidValue;
  const GatherArgs a{x, w, kept, counts, bias, out, M, static_cast<int>(K), static_cast<int>(N),
                     cl, n_pre_hcu, pre_mcu, n_post_hcu, post_mcu, tiles_c};
  const int variant = (vn ? 4 : 0) | (pair ? 2 : 0) | (bias != nullptr ? 1 : 0);
  static constexpr int (*table[])(const GatherArgs&, int, cudaStream_t) = {
      launch_gathered<0>, launch_gathered<1>, launch_gathered<2>, launch_gathered<3>,
      launch_gathered<4>, launch_gathered<5>, launch_gathered<6>, launch_gathered<7>};
  return table[variant](a, static_cast<int>(ctas), stream);
}
