// The BCPNN update tile on Hopper (sm_90a): the register product over the
// batch and the epilogue of Alg. 1 L11-16, shared by bcpnn_update.cu and
// bcpnn_phase.cu, so both kernels run the same update code.
//
// A tile of C_ij (F rows x H columns) is an outer-product sum over the
// batch: C[f][h] = sum_b a_i[b][f] a_j[b][h].  Both operands are staged
// k-major (one batch row per shared-memory row, as a_i and a_j lie in
// device memory), and each thread owns an RM x RN register micro-tile whose
// rows and columns come in blocks of up to 4 consecutive positions, so a
// block is one 16-byte shared-memory load (product_stage).
//
// The epilogue (epilogue4) finishes four consecutive elements of one row:
//   C_ij' = rne(one_m C_ij + lam (C / B)),   w = [log C_ij' - log c_i' - log c_j'] * mask
// (every log of max(., EPS); rne is the state tier's rounding, rne_round.cuh).
// The datapath modes (template argument DP, bcpnn_update.cu only) round
// every stage to the datapath format as well, with q = rne to dp_mantissa
// bits (repro/precision/policy.py:quantized_learning_cycle):
//   C_ij' = rne(q(one_m C_ij + lam q(C / B))),   w = q(log C_ij' - log c_i' - log c_j') * mask
// the EWMA's products and sum each rounded to f32 on their own (no FMA), as
// the reference's elementwise ops are.  The mean is the IEEE quotient by B:
// a product with 1/B, the same value, when B is a power of two (DP_POW2),
// else a division (DP_DIV).  They are two instantiations because the
// division's code in the epilogue, taken or not, slowed the MNIST hidden
// update on an H100 from 0.092 to 0.111 ms.
// With VEC it makes one 16-byte load of C_ij (8-byte for bf16 traces) and of
// the mask and one 16-byte store of C_ij' (8-byte for bf16) and of w; without
// it, 4-byte accesses for rows whose stride or base is not 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rne_round.cuh"

namespace bcpnn_tile {

constexpr float EPS = 1e-8f;

// The scalars of one update.
struct Update {
  float lam, one_m, inv_b;  // EWMA weight, 1 - lam, 1 / B
  int mantissa;             // rounding of the new traces (0: none)
  int in_bf16, out_bf16;    // storage of the old and of the new traces
  int dp_mantissa;          // the datapath format (read only in a datapath mode) ...
  float batch;              // ... and B, which DP_DIV's means divide by
};

// The update's modes: f32 (with the state tier's rounding, if any), and the
// datapath's, for a batch of a power of two and for any other batch.
constexpr int DP_OFF = 0, DP_POW2 = 1, DP_DIV = 2;

// A new trace from its old value and its batch sum.
template <int DP = DP_OFF>
__device__ __forceinline__ float trace(const Update& u, float old, float sum) {
  if constexpr (DP != DP_OFF) {
    float mean;
    if constexpr (DP == DP_POW2) {
      mean = __fmul_rn(sum, u.inv_b);
    } else {
      mean = __fdiv_rn(sum, u.batch);
    }
    const float m = rne_round(mean, u.dp_mantissa);
    const float c = __fadd_rn(__fmul_rn(u.one_m, old), __fmul_rn(u.lam, m));
    return rne_round(rne_round(c, u.dp_mantissa), u.mantissa);
  } else {
    return rne_round(u.one_m * old + u.lam * (sum * u.inv_b), u.mantissa);
  }
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Width of a micro-tile block: R values per thread in blocks of min(R, 4).
template <int R>
__host__ __device__ constexpr int vw() { return R < 4 ? R : 4; }

// Tile position of a thread's i-th micro-tile row (column): blocks of vw
// consecutive positions, T * vw apart, thread t at offset t * vw in each.
template <int R, int T>
__device__ __forceinline__ int micro(int t, int i) {
  constexpr int V = vw<R>();
  return (i / V) * V * T + t * V + i % V;
}

// V consecutive floats of shared memory (V = 1, 2 or 4, aligned to 4V bytes).
template <int V>
__device__ __forceinline__ void lds(float* d, const float* s) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = s[0];
  }
}

// acc[i][j] += sum over BK rows kk of A[kk][row i] * B[kk][column j], A and
// B k-major in shared memory with row strides lda and ldb; rows
// micro<RM, TY>(ty, i), columns micro<RN, TX>(tx, j).  IEEE f32 FMA.
template <int RM, int RN, int TY, int TX, int BK>
__device__ __forceinline__ void product_stage(const float* A, int lda, const float* B, int ldb,
                                              float (&acc)[RM][RN], int tx, int ty) {
  constexpr int VM = vw<RM>(), VN = vw<RN>();
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[RM], b[RN];
#pragma unroll
    for (int h = 0; h < RM / VM; ++h) lds<VM>(a + h * VM, A + kk * lda + (h * TY + ty) * VM);
#pragma unroll
    for (int h = 0; h < RN / VN; ++h) lds<VN>(b + h * VN, B + kk * ldb + (h * TX + tx) * VN);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Asynchronous copy of BYTES (4 or 16) from global to shared memory, or
// zeros when the source lies outside the array (nothing is then read; src
// is any valid address).
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  __pipeline_memcpy_async(dst, src, BYTES, valid ? 0 : BYTES);
}

// --- four elements of a row: loads, stores, the epilogue ---

// v[q] = element i + q of p (f32, or bf16 when bf16 != 0) for q < n.
template <bool VEC>
__device__ __forceinline__ void load4(float (&v)[4], const void* p, size_t i, int bf16, int n) {
  if constexpr (VEC) {
    if (bf16) {
      const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
      v[0] = __uint_as_float(r.x << 16); v[1] = __uint_as_float(r.x & 0xffff0000u);
      v[2] = __uint_as_float(r.y << 16); v[3] = __uint_as_float(r.y & 0xffff0000u);
    } else {
      const float4 r = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
      v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n ? load_state(p, i + q, bf16) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(void* p, size_t i, const float (&v)[4], int bf16, int n) {
  if constexpr (VEC) {
    if (bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n) store_state(p, i + q, v[q], bf16);
  }
}

// C_ij' and w for the n (<= 4) consecutive elements at index idx of one
// row (idx = gf * H + gh), from their old traces c and mask m (ignored
// without MASK), the batch sums of a_i^T a_j, lci = log c_i'[gf] and lcj =
// log c_j' of the four columns.  A kernel may load c and m early (load4), so
// that the loads fly while it does other work, and finish the run later.
template <bool VEC, bool MASK, int DP = DP_OFF>
__device__ __forceinline__ void finish4(const Update& u, const float (&c)[4], const float (&m)[4],
                                        const float (&sum)[4], float lci, const float* lcj,
                                        void* cij_out, float* w_out, size_t idx, int n) {
  float cn[4], w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cn[q] = trace<DP>(u, c[q], sum[q]);
    w[q] = logf(fmaxf(cn[q], EPS)) - lci - lcj[q];
    if constexpr (DP != DP_OFF) w[q] = rne_round(w[q], u.dp_mantissa);
    if constexpr (MASK) w[q] *= m[q];
  }
  store4<VEC>(cij_out, idx, cn, u.out_bf16, n);
  store4<VEC>(w_out, idx, w, 0, n);
}

// The whole epilogue of the n elements at idx: C_ij and the mask loaded
// from device memory, then finish4.
template <bool VEC, bool MASK, int DP = DP_OFF>
__device__ __forceinline__ void epilogue4(const Update& u, const void* cij, const float* mask,
                                          void* cij_out, float* w_out, size_t idx, int n,
                                          const float (&sum)[4], float lci, const float* lcj) {
  float c[4], m[4];
  load4<VEC>(c, cij, idx, u.in_bf16, n);
  if constexpr (MASK) load4<VEC>(m, mask, idx, 0, n);
  finish4<VEC, MASK, DP>(u, c, m, sum, lci, lcj, cij_out, w_out, idx, n);
}

}  // namespace bcpnn_tile
