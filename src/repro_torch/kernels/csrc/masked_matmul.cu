// s = x @ (w * mask) + b in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/masked_matmul.py:masked_matmul.
// A tiled SIMT GEMM: each 256-thread block owns a 64x64 tile of s and each
// thread a 4x4 register micro-tile, strided by 16 rows and 16 columns so
// that a warp's loads and stores cover consecutive addresses.  The block
// loops over K in tiles of 16, staging x and (w * mask) in shared memory;
// the mask is multiplied in while the w tile is staged, so the masked matrix
// never reaches device memory.  The bias is added in the epilogue.  Ragged
// edges (H = 3000, the readout's H = 10) are zero-filled on load and
// skipped on store.  Arithmetic is plain f32 FMA, to hold parity with the
// f32 reference.
//
// mask and b may be null (no mask / no bias).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // rows of s per block
constexpr int BN = 64;   // columns of s per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int TX = BN / TN;                     // 16 threads across columns
constexpr int TY = BM / TM;                     // 16 threads across rows

__global__ void __launch_bounds__(THREADS)
masked_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mask, const float* __restrict__ bias,
                     float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.f;
      if (gk < K && gn < N) {
        const size_t idx = (size_t)gk * N + gn;
        v = w[idx];
        if (mask != nullptr) v *= mask[idx];
      }
      ws[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + TY * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j] + (bias != nullptr ? bias[gn] : 0.f);
    }
  }
}

}  // namespace

extern "C" int masked_matmul_f32(const float* x, const float* w, const float* mask,
                                 const float* bias, float* out, int M, int K, int N,
                                 cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  masked_matmul_kernel<<<grid, THREADS, 0, stream>>>(x, w, mask, bias, out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
