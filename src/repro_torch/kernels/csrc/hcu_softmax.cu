// Softmax within each hypercolumn, f32, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hcu_softmax.py:hcu_softmax.  s is
// (rows, n_hcu * n_mcu) row-major; one warp owns one (row, HCU), the n_mcu
// contiguous values at s + group * n_mcu.  The kernel reads s once and
// writes the output once, with a few operations per element: it is bound
// by bytes (24.6 MB at 1024 rows of 30x100, 0.0073 ms at 3.35 TB/s), and
// at 128 rows (3 MB) by the latency of one trip to device memory.  So each
// value is read once, into registers: lane l takes the values l, l + 32,
// l + 64 and l + 96, each load of the warp 128 contiguous bytes (a lane
// taking one 16-byte vector of the paper's 100 MCUs was slower on the
// H100 at both row counts).  Shuffles give the warp's max, expf runs once
// per element and its results stay in registers, shuffles give the sum,
// and each lane multiplies its values by the sum's IEEE reciprocal and
// writes them once.  Lanes past n_mcu hold -inf and 0, so no padding is
// needed.  A hypercolumn of more than 128 units (more than the 4 registers
// a lane holds) takes a loop of the same pattern over chunks of 128: a max
// pass, a sum pass and a write pass, which read the hypercolumn again from
// the caches.  expf, not __expf: the plain version's tolerance is 1e-5 /
// 1e-6.
//
// The rounding mode (round_mantissa d > 0; the template flag ROUND) is the
// softmax stage of the reduced datapath (paper Fig. 3,
// repro/precision/policy.py:quantized_forward): each output is RNE-rounded
// to d mantissa bits (rne_round.cuh) at its one store, in registers, so the
// mode moves the bytes of the f32 softmax.  The f32 instantiation (ROUND
// false) is the code of the f32 kernel.

#include <cuda_runtime.h>

#include "rne_round.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;  // values a warp holds in registers, 4 a lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Lane `lane`'s values lane + 32 r of the chunk at src (n values, n <=
// CHUNK); missing values are -inf.
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, int n, int lane,
                                           float (&v)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = lane + 32 * r;
    v[r] = i < n ? __ldg(src + i) : __int_as_float(0xff800000);
  }
}

__device__ __forceinline__ float max4(const float (&v)[4]) {
  return fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
}

// The value stored: q(v) in the rounding mode.
template <bool ROUND>
__device__ __forceinline__ float stored(float v, int d) {
  if constexpr (ROUND) {
    return rne_round(v, d);
  } else {
    return v;
  }
}

template <bool ROUND>
__global__ void __launch_bounds__(THREADS)
hcu_softmax_kernel(const float* __restrict__ s, float* __restrict__ out,
                   long long n_groups, int n_mcu, int round_m) {
  const long long group = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (group >= n_groups) return;  // the whole warp leaves together
  const float* src = s + group * n_mcu;
  float* dst = out + group * n_mcu;
  float v[4];

  if (n_mcu <= CHUNK) {  // the whole hypercolumn in registers
    load_chunk(src, n_mcu, lane, v);
    const float m = warp_max(max4(v));
    float z = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[r] = lane + 32 * r < n_mcu ? expf(v[r] - m) : 0.f;
      z += v[r];
    }
    const float inv = 1.f / warp_sum(z);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (lane + 32 * r < n_mcu) dst[lane + 32 * r] = stored<ROUND>(v[r] * inv, round_m);
    return;
  }

  float m = __int_as_float(0xff800000);
  for (int c = 0; c < n_mcu; c += CHUNK) {
    load_chunk(src + c, min(CHUNK, n_mcu - c), lane, v);
    m = fmaxf(m, max4(v));
  }
  m = warp_max(m);
  float z = 0.f;
  for (int c = 0; c < n_mcu; c += CHUNK) {
    const int n = min(CHUNK, n_mcu - c);
    load_chunk(src + c, n, lane, v);
#pragma unroll
    for (int r = 0; r < 4; ++r) z += lane + 32 * r < n ? expf(v[r] - m) : 0.f;
  }
  const float inv = 1.f / warp_sum(z);
  for (int c = 0; c < n_mcu; c += CHUNK) {
    const int n = min(CHUNK, n_mcu - c);
    load_chunk(src + c, n, lane, v);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (lane + 32 * r < n)
        dst[c + lane + 32 * r] = stored<ROUND>(expf(v[r] - m) * inv, round_m);
  }
}

}  // namespace

// round_mantissa: 0 for the f32 softmax, 1..23 for the rounding mode.
extern "C" int hcu_softmax_f32(const float* s, float* out, int rows, int n_hcu,
                               int n_mcu, int round_mantissa, cudaStream_t stream) {
  if (round_mantissa < 0 || round_mantissa > 23) return cudaErrorInvalidValue;
  const long long n_groups = (long long)rows * n_hcu;
  if (n_groups <= 0 || n_mcu <= 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((n_groups + WARPS - 1) / WARPS);
  if (round_mantissa > 0) {
    hcu_softmax_kernel<true><<<blocks, THREADS, 0, stream>>>(s, out, n_groups, n_mcu,
                                                             round_mantissa);
  } else {
    hcu_softmax_kernel<false><<<blocks, THREADS, 0, stream>>>(s, out, n_groups, n_mcu, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
