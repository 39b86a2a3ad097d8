// The layer pair's backward sweep, lstm_pair_bwd_kernel, and its launch
// (pair_bwd), over a storage type T: float, instantiated with its replica
// axis in lstm_bwd.cu, and bf16 (trainer.precision=bf16-mixed), solo only,
// in lstm_bwd_bf16.cu, so that the two build side by side. Its design is
// lstm_bwd.cu's (the top of that file).

#pragma once

#include <type_traits>

#include "lstm_sweep.cuh"

namespace {

// ------------------------------------------------ the pair's backward sweep

// Serial part of the pair backward. Replaces the sweep of _pair_bwd_kernel
// (masters_thesis_tpu/ops/lstm_kernel.py). Iteration k runs layer 1 at
// t1 = T-k (k > 0) and layer 2 at t2 = T-1-k (k < T): layer 1 consumes the
// seam cotangent dh1_in that layer 2 made at t1 in iteration k-1, and t2 =
// t1-1, so h1[t2] is both layer 1's h[t1-1] and layer 2's input. The step
// that is not run (layer 1 at k = 0, layer 2 at k = T) is computed on zeros
// and discarded: uniform control flow.
// A block of 256 threads owns ROWS rows. Lane u + 8 q of warp w serves unit
// (or, in the transposed products, k) j = 8 w + u and quarter q of the
// contraction; after the quarter sums it owns rows q, q + 4 of unit j: their
// cell step, dh, dc and the seam cotangent stay in its registers. Warps with
// 8 w >= p only take part in the barriers.
// Shared memory (p = sweep_pad(H), kq = p / 4): w1_s, wi2_s, w2_s
// [p][p + 1] float4; hp1_s (h1[t2]), hp2_s (h2[t2-1]) and, with HAS_MASK,
// hm_s ((m ⊙ h1)[t2]) [ROWS][p + 16] floats; dp1_s, dp2_s [ROWS][p + 4]
// float4.
// The replica axis: block (tile, r) runs replica r on the r-th of R stacked
// operands (planes (R, T, B, H) and (R, T, B, 4H), weights (R, H, 4H), b2
// (R, 4H)), as lstm_pair_fwd_kernel does; STACKED compiles the offsets in,
// and a solo launch takes the instance without them.
// T is the storage type of the cotangent, the stashes, x1, the mask, the
// weights and dx1: float, or bf16 (the JAX kernel's bf16 compute dtype).
// With bf16 every operand is converted to f32 where it is loaded (the
// weights once, into shared memory), so the gates are recomputed from the
// rounded stashes as the TPU kernel recomputes them; the sweep's state and
// products stay f32. dx1 (the gradient the bf16 input projection takes) is
// rounded, and layer 1's d_pre is also written in f32 into dpre1 for the
// weight-gradient pass, whose sums the TPU kernel takes over f32 d_pre;
// dpre2 is f32 for either type. With float, dx1 is layer 1's d_pre and
// dpre1 is not written.
template <int ROWS, bool HAS_MASK, bool STACKED, typename T>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_pair_bwd_kernel(const T* __restrict__ dh2s, const T* __restrict__ x1,
                     const T* __restrict__ mask, const T* __restrict__ h1s,
                     const T* __restrict__ c1s, const T* __restrict__ h2s,
                     const T* __restrict__ c2s, const T* __restrict__ w1,
                     const T* __restrict__ wi2, const T* __restrict__ b2,
                     const T* __restrict__ w2, T* __restrict__ dx1,
                     float* __restrict__ dpre1, float* __restrict__ dpre2,
                     int n_t, int n_rows, int hidden) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  if constexpr (STACKED) {
    const size_t rep = blockIdx.y;
    const size_t plane = static_cast<size_t>(n_t) * n_rows * hidden;
    const size_t weight = static_cast<size_t>(hidden) * 4 * hidden;
    dh2s += rep * plane;
    x1 += rep * 4 * plane;
    if constexpr (HAS_MASK) mask += rep * plane;
    h1s += rep * plane;
    c1s += rep * plane;
    h2s += rep * plane;
    c2s += rep * plane;
    w1 += rep * weight;
    wi2 += rep * weight;
    w2 += rep * weight;
    b2 += rep * 4 * hidden;
    dx1 += rep * 4 * plane;
    if constexpr (!kF32) dpre1 += rep * 4 * plane;
    dpre2 += rep * 4 * plane;
  }
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  const int h_row = p + 16;
  const int dp_row = p + 4;
  float4* w1_s = smem;
  float4* wi2_s = w1_s + p * (p + 1);
  float4* w2_s = wi2_s + p * (p + 1);
  float* hp1_s = reinterpret_cast<float*>(w2_s + p * (p + 1));
  float* hp2_s = hp1_s + ROWS * h_row;
  float* hm_s = HAS_MASK ? hp2_s + ROWS * h_row : hp1_s;
  float4* dp1_s =
      reinterpret_cast<float4*>(hp2_s + (HAS_MASK ? 2 : 1) * ROWS * h_row);
  float4* dp2_s = dp1_s + ROWS * dp_row;
  stage_weight_padded(w1, w1_s, hidden, p);
  stage_weight_padded(wi2, wi2_s, hidden, p);
  stage_weight_padded(w2, w2_s, hidden, p);
  const int q = (threadIdx.x & 31) >> 3;
  const int j = (threadIdx.x >> 5) * 8 + (threadIdx.x & 7);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp
  const int tile0 = blockIdx.x * ROWS;
  const int hc = h_col(j, kq);
  const int dpc = dp_col(j, kq);
  const float* const h_in[3] = {hp1_s, hm_s, hp2_s};
  const float4* const w_in[3] = {w1_s, wi2_s, w2_s};
  const float4* const dp_in[3] = {dp1_s, dp2_s, dp2_s};
  const float4* const w_tr[3] = {w1_s, w2_s, wi2_s};

  float b2v[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b2v[g] = j < hidden ? load_f32(b2 + g * hidden + j) : 0.0f;
  float dh1_rec[NR], dc1[NR], dh2_rec[NR], dc2[NR], dh1_in[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    dh1_rec[i] = dc1[i] = dh2_rec[i] = dc2[i] = dh1_in[i] = 0.0f;
  }
  // h1[t2], h2[t2-1] and mask[t2] of the next iteration, loaded one
  // iteration ahead.
  float h1n[NR], h2n[NR], mn[NR];
  load_owned<ROWS>(h1s, n_t - 1, n_t, n_rows, hidden, tile0, q, j, h1n);
  load_owned<ROWS>(h2s, n_t - 2, n_t, n_rows, hidden, tile0, q, j, h2n);
  if constexpr (HAS_MASK) {
    load_owned<ROWS>(mask, n_t - 1, n_t, n_rows, hidden, tile0, q, j, mn);
  }
  __syncthreads();  // the weights are staged

  for (int k = 0; k <= n_t; ++k) {
    const int t1 = n_t - k;
    const int t2 = t1 - 1;
    const bool run1 = k > 0;
    const bool run2 = k < n_t;
    float mv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int lrow = q + 4 * i;
      mv[i] = HAS_MASK ? mn[i] : 1.0f;
      if (active && lrow < ROWS) {
        hp1_s[lrow * h_row + hc] = h1n[i];
        hp2_s[lrow * h_row + hc] = h2n[i];
        if constexpr (HAS_MASK) hm_s[lrow * h_row + hc] = h1n[i] * mn[i];
      }
    }
    load_owned<ROWS>(h1s, t2 - 1, n_t, n_rows, hidden, tile0, q, j, h1n);
    load_owned<ROWS>(h2s, t2 - 2, n_t, n_rows, hidden, tile0, q, j, h2n);
    if constexpr (HAS_MASK) {
      load_owned<ROWS>(mask, t2 - 1, n_t, n_rows, hidden, tile0, q, j, mn);
    }
    float x1v[4][NR], c1v[NR], c1p[NR], c2v[NR], c2p[NR], dh2v[NR];
    load_owned_x<ROWS>(x1, t1, n_t, n_rows, hidden, tile0, q, j, x1v);
    load_owned<ROWS>(c1s, t1, n_t, n_rows, hidden, tile0, q, j, c1v);
    load_owned<ROWS>(c1s, t1 - 1, n_t, n_rows, hidden, tile0, q, j, c1p);
    load_owned<ROWS>(c2s, t2, n_t, n_rows, hidden, tile0, q, j, c2v);
    load_owned<ROWS>(c2s, t2 - 1, n_t, n_rows, hidden, tile0, q, j, c2p);
    load_owned<ROWS>(dh2s, t2, n_t, n_rows, hidden, tile0, q, j, dh2v);
    __syncthreads();  // the h planes hold this iteration's rows

    if (active) {
      // Gates: layer 1 x1[t1] + h1[t1-1] @ w1; layer 2 b2 + (hm @ wi2 +
      // h2[t2-1] @ w2), the two products summed in one accumulator.
      float acc[ROWS][8];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[r][n] = 0.0f;
      quarter_gate_products<ROWS, 3, 2>(h_in, w_in, kq, h_row, q, j, acc);
      float sums[NR][8];
      quarter_sum<ROWS, 8>(acc, q, sums);
      float gates1[4][NR], gates2[4][NR], dh1[NR], dh2[NR], d1[4][NR], d2[4][NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          gates1[g][i] = x1v[g][i] + sums[i][g];
          gates2[g][i] = b2v[g] + sums[i][4 + g];
        }
        dh1[i] = dh1_in[i] + dh1_rec[i];
        dh2[i] = dh2v[i] + dh2_rec[i];
      }
      float dc1n[NR], dc2n[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        dc1n[i] = dc1[i];
        dc2n[i] = dc2[i];
      }
      cell_backward(gates1, c1v, c1p, dh1, dc1n, d1);
      cell_backward(gates2, c2v, c2p, dh2, dc2n, d2);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int lrow = q + 4 * i;
        const int row = tile0 + lrow;
        if (run1) dc1[i] = dc1n[i];
        if (run2) dc2[i] = dc2n[i];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (!run1) d1[g][i] = 0.0f;
          if (!run2) d2[g][i] = 0.0f;
        }
        if (lrow < ROWS) {
          if (row < n_rows && j < hidden) {
            const size_t at = static_cast<size_t>(row) * 4 * hidden + j;
            const size_t plane = static_cast<size_t>(n_rows) * 4 * hidden;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (run1) store_as(dx1 + t1 * plane + at + g * hidden, d1[g][i]);
              if constexpr (!kF32) {
                if (run1) dpre1[t1 * plane + at + g * hidden] = d1[g][i];
              }
              if (run2) dpre2[t2 * plane + at + g * hidden] = d2[g][i];
            }
          }
          dp1_s[lrow * dp_row + dpc] = make_float4(d1[0][i], d1[1][i], d1[2][i], d1[3][i]);
          dp2_s[lrow * dp_row + dpc] = make_float4(d2[0][i], d2[1][i], d2[2][i], d2[3][i]);
        }
      }
    }
    __syncthreads();  // dp1_s, dp2_s hold this iteration's d_pre rows

    if (active) {
      // dh1[t1-1] from layer 1's own recurrence, dh2[t2-1] from layer 2's,
      // and the seam cotangent into h1[t2], masked as in the TPU kernel.
      float tr[ROWS][3];
      quarter_transposed_products<ROWS, 3>(dp_in, w_tr, kq, dp_row, q, j, tr);
      float sums[NR][3];
      quarter_sum<ROWS, 3>(tr, q, sums);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        dh1_rec[i] = sums[i][0];
        dh2_rec[i] = sums[i][1];
        dh1_in[i] = HAS_MASK ? mv[i] * sums[i][2] : sums[i][2];
      }
    }
  }
}

// The sweep's dynamic shared memory: three padded weights, two or three h
// planes and two d_pre planes (lstm_pair_bwd_kernel). 224,768 bytes at
// H = 64, 8 rows, masked.
size_t sweep_smem(int hidden, int rows, bool masked) {
  const size_t p = sweep_pad(hidden);
  return 3 * p * (p + 1) * sizeof(float4) +
         (masked ? 3 : 2) * rows * (p + 16) * sizeof(float) +
         2 * rows * (p + 4) * sizeof(float4);
}

// The pair sweep's entry. The f32 sweep has a replica axis (STACKED
// instances); the bf16 sweep runs solo launches only (R = 1).
template <typename T>
int pair_bwd(const T* dh2s, const T* x1, const T* mask, const T* h1s,
             const T* c1s, const T* h2s, const T* c2s, const T* w1_t,
             const T* wi2_t, const T* b2, const T* w2_t, T* dx1, float* dpre1,
             float* dpre2, int n_t, int n_rows, int hidden, int replicas,
             int tile, int device, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  if (bad_shape(n_t, n_rows, hidden) || replicas < 1 ||
      (!kF32 && (replicas != 1 || dpre1 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    auto kernel = mask != nullptr ? lstm_pair_bwd_kernel<kRows, true, false, T>
                                  : lstm_pair_bwd_kernel<kRows, false, false, T>;
    if constexpr (kF32) {
      if (replicas > 1) {
        kernel = mask != nullptr ? lstm_pair_bwd_kernel<kRows, true, true, T>
                                 : lstm_pair_bwd_kernel<kRows, false, true, T>;
      }
    }
    return launch_sweep(kernel, n_rows, kRows, replicas,
                        sweep_smem(hidden, kRows, mask != nullptr), stream, dh2s,
                        x1, mask, h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t, dx1,
                        dpre1, dpre2, n_t, n_rows, hidden);
  }, replicas, tile));
}

}  // namespace
