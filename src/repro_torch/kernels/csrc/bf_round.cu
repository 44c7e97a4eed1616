// Elementwise RNE rounding of the f32 mantissa to m bits, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bf_round.py:bf_round.  The TPU
// kernel tiles a padded (rows, 128) view; here a grid-stride loop walks the
// flat array with 16-byte (float4) loads and stores while both pointers are
// 16-byte aligned, and scalar loads for the tail (or the whole array when
// a pointer is not aligned).  No padding copy.  One read and one write of
// each element and a handful of integer operations: the kernel is bound by
// bytes (37.6 MB at the MNIST hidden layer's C_ij, 0.0112 ms at 3.35 TB/s).
// So it keeps bytes in flight: the grid is one full wave (as many blocks as
// the SMs hold at once: 2048 threads an SM; fewer only when the array needs
// fewer), and each thread issues two 16-byte loads, a grid's stride apart,
// before it stores either.  Every byte is touched once, so the loads and stores carry the
// streaming cache hint (__ldcs / __stcs: evict first).  The rounding itself
// is rne_round from rne_round.cuh, which the rounding modes of
// masked_matmul.cu, hcu_softmax.cu and bcpnn_update.cu and the state tier's
// epilogues of bcpnn_update.cu and bcpnn_phase.cu share.  The reduced
// datapath rounds inside those kernels; this one serves the state tier's
// rounding of the initial traces (quantize_marginals) and PrecisionPolicy.q.

#include <cstdint>

#include "rne_round.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;  // a Hopper SM's thread limit

__device__ __forceinline__ float4 round4(float4 v, int m) {
  v.x = rne_round(v.x, m);
  v.y = rne_round(v.y, m);
  v.z = rne_round(v.z, m);
  v.w = rne_round(v.w, m);
  return v;
}

__global__ void __launch_bounds__(THREADS)
bf_round_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                long long n_vec, int mantissa_bits) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n_vec; i += 2 * stride) {
    const long long j = i + stride;
    const float4 a = __ldcs(xv + i);
    const float4 b = j < n_vec ? __ldcs(xv + j) : a;
    __stcs(ov + i, round4(a, mantissa_bits));
    if (j < n_vec) __stcs(ov + j, round4(b, mantissa_bits));
  }
  for (long long i = 4 * n_vec + tid; i < n; i += stride) {
    __stcs(out + i, rne_round(__ldcs(x + i), mantissa_bits));
  }
}

}  // namespace

extern "C" int bf_round_f32(const float* x, float* out, long long n, int mantissa_bits,
                            int sm_count, cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long n_vec = aligned ? n / 4 : 0;
  // Threads that have work: two float4 each, or one scalar of the tail.
  const long long work = (n_vec + 1) / 2 + (n - 4 * n_vec);
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long wave = static_cast<long long>(BLOCKS_PER_SM) * (sm_count > 0 ? sm_count : 132);
  if (blocks > wave) blocks = wave;
  bf_round_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(x, out, n, n_vec,
                                                                        mantissa_bits);
  return static_cast<int>(cudaGetLastError());
}
