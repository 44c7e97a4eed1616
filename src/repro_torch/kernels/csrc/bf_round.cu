// Elementwise RNE rounding of the f32 mantissa to m bits, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bf_round.py:bf_round.  The TPU
// kernel tiles a padded (rows, 128) view; here a grid-stride loop walks the
// flat array with 16-byte (float4) loads and stores while both pointers are
// 16-byte aligned, and scalar loads for the tail (or the whole array when
// a pointer is not aligned).  No padding copy.  One read and one write of
// each element and a handful of integer operations: the kernel is bound by
// bytes.  The rounding itself is rne_round from rne_round.cuh, shared with
// the epilogues of bcpnn_update.cu and bcpnn_phase.cu.

#include <cstdint>

#include "rne_round.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bf_round_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                long long n_vec, int mantissa_bits) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n_vec; i += stride) {
    float4 v = xv[i];
    v.x = rne_round(v.x, mantissa_bits);
    v.y = rne_round(v.y, mantissa_bits);
    v.z = rne_round(v.z, mantissa_bits);
    v.w = rne_round(v.w, mantissa_bits);
    ov[i] = v;
  }
  for (long long i = 4 * n_vec + tid; i < n; i += stride) {
    out[i] = rne_round(x[i], mantissa_bits);
  }
}

}  // namespace

extern "C" int bf_round_f32(const float* x, float* out, long long n, int mantissa_bits,
                            int sm_count, cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long n_vec = aligned ? n / 4 : 0;
  const long long work = n_vec + (n - 4 * n_vec);
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = 8LL * (sm_count > 0 ? sm_count : 132);  // a few waves, then stride
  if (blocks > cap) blocks = cap;
  bf_round_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(x, out, n, n_vec,
                                                                        mantissa_bits);
  return static_cast<int>(cudaGetLastError());
}
