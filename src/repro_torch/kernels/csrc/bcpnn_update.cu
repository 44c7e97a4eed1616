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
// The TPU kernel carries its sums across sequential grid steps.  Here one
// 256-thread block owns a 64 (F) x 64 (H) tile and loops over the whole
// batch in chunks of 16 rows: each chunk stages a_i[b, F tile] and
// a_j[b, H tile] in shared memory, every thread accumulates its 4x4 slice of
// a_i^T a_j in registers, and 128 threads sum the staged columns.  Since the
// block sees the whole batch for its own columns, it has mean(a_i) for its
// F slice and mean(a_j) for its H slice with no cross-block reduction and no
// atomics: the result is deterministic.  The epilogue reads C_ij and the
// mask once and writes C_ij' and w once.  Blocks of the first H tile write
// c_i'; blocks of the first F tile write c_j' and the bias.
//
// At the MNIST hidden layer (B=128, F=1568, H=3000) the kernel must move
// about 78 MB (C_ij and mask in, C_ij' and w out) against 1.2 GFLOP of
// outer product: it is bound by bytes on this card.  mask may be null.

#include "rne_round.cuh"

namespace {

constexpr int TF = 64;   // F columns per block
constexpr int TH = 64;   // H columns per block
constexpr int BB = 16;   // batch rows per shared-memory stage
constexpr int RF = 4;    // F rows per thread
constexpr int RH = 4;    // H columns per thread
constexpr int THREADS = (TF / RF) * (TH / RH);  // 256
constexpr int TX = TH / RH;                     // 16 threads across H
constexpr int TY = TF / RF;                     // 16 threads across F
constexpr float EPS = 1e-8f;

__global__ void __launch_bounds__(THREADS)
bcpnn_update_kernel(const float* __restrict__ ai, const float* __restrict__ aj,
                    const void* __restrict__ ci, const void* __restrict__ cj,
                    const void* __restrict__ cij, const float* __restrict__ mask,
                    void* __restrict__ ci_out, void* __restrict__ cj_out,
                    void* __restrict__ cij_out, float* __restrict__ w_out,
                    float* __restrict__ bias_out, int B, int F, int H,
                    float lam, float one_m, float k_b, int state_mantissa,
                    int state_in_bf16, int state_out_bf16) {
  __shared__ float ais[BB][TF];
  __shared__ float ajs[BB][TH];
  __shared__ float log_ci[TF];
  __shared__ float log_cj[TH];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int f0 = blockIdx.y * TF;
  const int h0 = blockIdx.x * TH;

  float acc[RF][RH];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < RH; ++j) acc[i][j] = 0.f;
  float col = 0.f;  // thread t < TF sums a_i column f0+t; TF <= t < TF+TH a_j column

  for (int b0 = 0; b0 < B; b0 += BB) {
#pragma unroll
    for (int e = tid; e < BB * TF; e += THREADS) {
      const int r = e / TF, c = e % TF;
      const int gb = b0 + r, gf = f0 + c;
      ais[r][c] = (gb < B && gf < F) ? ai[(size_t)gb * F + gf] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BB * TH; e += THREADS) {
      const int r = e / TH, c = e % TH;
      const int gb = b0 + r, gh = h0 + c;
      ajs[r][c] = (gb < B && gh < H) ? aj[(size_t)gb * H + gh] : 0.f;
    }
    __syncthreads();
    if (tid < TF) {
#pragma unroll
      for (int r = 0; r < BB; ++r) col += ais[r][tid];
    } else if (tid < TF + TH) {
#pragma unroll
      for (int r = 0; r < BB; ++r) col += ajs[r][tid - TF];
    }
#pragma unroll
    for (int kk = 0; kk < BB; ++kk) {
      float a[RF], b[RH];
#pragma unroll
      for (int i = 0; i < RF; ++i) a[i] = ais[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < RH; ++j) b[j] = ajs[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RF; ++i)
#pragma unroll
        for (int j = 0; j < RH; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float batch = static_cast<float>(B);
  if (tid < TF) {
    const int gf = f0 + tid;
    if (gf < F) {
      const float c = rne_round(one_m * load_state(ci, gf, state_in_bf16) + lam * (col / batch),
                                state_mantissa);
      if (blockIdx.x == 0) store_state(ci_out, gf, c, state_out_bf16);
      log_ci[tid] = logf(fmaxf(c, EPS));
    }
  } else if (tid < TF + TH) {
    const int jh = tid - TF;
    const int gh = h0 + jh;
    if (gh < H) {
      const float c = rne_round(one_m * load_state(cj, gh, state_in_bf16) + lam * (col / batch),
                                state_mantissa);
      const float lc = logf(fmaxf(c, EPS));
      log_cj[jh] = lc;
      if (blockIdx.y == 0) {
        store_state(cj_out, gh, c, state_out_bf16);
        bias_out[gh] = k_b * lc;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int fi = ty + TY * i;
    const int gf = f0 + fi;
    if (gf >= F) continue;
#pragma unroll
    for (int j = 0; j < RH; ++j) {
      const int hj = tx + TX * j;
      const int gh = h0 + hj;
      if (gh >= H) continue;
      const size_t idx = (size_t)gf * H + gh;
      const float c = rne_round(
          one_m * load_state(cij, idx, state_in_bf16) + lam * (acc[i][j] / batch),
          state_mantissa);
      store_state(cij_out, idx, c, state_out_bf16);
      float wv = logf(fmaxf(c, EPS)) - log_ci[fi] - log_cj[hj];
      if (mask != nullptr) wv *= mask[idx];
      w_out[idx] = wv;
    }
  }
}

}  // namespace

extern "C" int bcpnn_update_f32(const float* ai, const float* aj, const void* ci,
                                const void* cj, const void* cij, const float* mask,
                                void* ci_out, void* cj_out, void* cij_out,
                                float* w_out, float* bias_out, int B, int F, int H,
                                float lam, float one_m, float k_b, int state_mantissa,
                                int state_in_bf16, int state_out_bf16, cudaStream_t stream) {
  const dim3 grid((H + TH - 1) / TH, (F + TF - 1) / TF);
  bcpnn_update_kernel<<<grid, THREADS, 0, stream>>>(
      ai, aj, ci, cj, cij, mask, ci_out, cj_out, cij_out, w_out, bias_out, B, F, H,
      lam, one_m, k_b, state_mantissa, state_in_bf16, state_out_bf16);
  return static_cast<int>(cudaGetLastError());
}
