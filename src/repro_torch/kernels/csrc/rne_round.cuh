// The reduced-precision rounding on Hopper: RNE mantissa rounding, and the
// storage of the quantized state tier's traces in f32 or bf16.
//
// rne_round is the counterpart of repro/kernels/bf_round.py:rne_round, which
// the reference shares between its bf_round, bcpnn_update and bcpnn_phase
// kernels so that every reduced-precision path rounds identically.  Here
// the same holds, and every rounding of the port is this function:
// bf_round.cu; the state tier's epilogue of bcpnn_update.cu and
// bcpnn_phase.cu (through bcpnn_tile.cuh); and the reduced datapath's
// stages, rounded inside the kernels that make them (the rounding modes of
// masked_matmul.cu and hcu_softmax.cu, the datapath mode of
// bcpnn_update.cu).
//
// Rounding to m mantissa bits: add (1 << (shift-1)) - 1 plus the LSB of the
// kept mantissa to the bit pattern, then clear the low shift = 23 - m bits.
// A carry may run into the exponent (correct RNE at binade edges); a finite
// value past the largest of the format becomes inf; non-finite values pass
// through.  mantissa_bits <= 0 or >= 23 means "no rounding".

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float rne_round(float x, int mantissa_bits) {
  if (mantissa_bits <= 0 || mantissa_bits >= 23) return x;
  const int shift = 23 - mantissa_bits;
  const unsigned u = __float_as_uint(x);
  const unsigned bias = (1u << (shift - 1)) - 1u;
  const unsigned lsb = (u >> shift) & 1u;
  const unsigned keep = ~((1u << shift) - 1u);
  const float out = __uint_as_float((u + bias + lsb) & keep);
  return isfinite(x) ? out : x;
}

// A trace element stored as f32 (bf16 == 0) or bf16 (bf16 != 0).  The flag
// is uniform across a launch, so the branch never diverges.
__device__ __forceinline__ float load_state(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Stores are exact for bf16 when the value was rounded to <= 7 mantissa
// bits first, which the wrappers guarantee.
__device__ __forceinline__ void store_state(void* p, size_t i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}
