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

template <class T, bool VA, bool VN, bool MASK, bool BIAS, bool ROUND>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<T, MASK>() * sizeof(float);
  auto kernel = masked_matmul_kernel<T, VA, VN, MASK, BIAS, ROUND>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = ((a.M + T::BM - 1) / T::BM) * ((a.N + T::BN - 1) / T::BN);
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
