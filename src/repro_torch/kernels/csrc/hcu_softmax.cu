// Softmax within each hypercolumn, f32, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hcu_softmax.py:hcu_softmax.  This is
// the paper's own CUDA design: one warp per (row, HCU).  s is (rows,
// n_hcu * n_mcu) row-major, so warp w owns the n_mcu contiguous values at
// s + w * n_mcu.  Each lane strides over the MCUs; __shfl_xor_sync gives
// the warp's max and sum, then each lane writes exp(s - max) / sum.  Lanes
// past n_mcu contribute -inf and 0, so no padding is needed.  The kernel
// reads s and writes the output about once each (three passes over one
// HCU hit L1): it is bound by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
hcu_softmax_kernel(const float* __restrict__ s, float* __restrict__ out,
                   long long n_groups, int n_mcu) {
  const long long group = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (group >= n_groups) return;  // the whole warp leaves together
  const float* src = s + group * n_mcu;
  float* dst = out + group * n_mcu;

  float m = __int_as_float(0xff800000);  // -inf
  for (int i = lane; i < n_mcu; i += 32) m = fmaxf(m, src[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));

  float z = 0.f;
  for (int i = lane; i < n_mcu; i += 32) z += expf(src[i] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(FULL, z, off);

  for (int i = lane; i < n_mcu; i += 32) dst[i] = expf(src[i] - m) / z;
}

}  // namespace

extern "C" int hcu_softmax_f32(const float* s, float* out, int rows, int n_hcu,
                               int n_mcu, cudaStream_t stream) {
  const long long n_groups = (long long)rows * n_hcu;
  const unsigned blocks = static_cast<unsigned>((n_groups + WARPS - 1) / WARPS);
  hcu_softmax_kernel<<<blocks, THREADS, 0, stream>>>(s, out, n_groups, n_mcu);
  return static_cast<int>(cudaGetLastError());
}
