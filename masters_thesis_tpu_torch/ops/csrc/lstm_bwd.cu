// Backward LSTM recurrences for Hopper (sm_90a), with a plain C interface.
//
// Each TPU backward kernel in masters_thesis_tpu/ops/lstm_kernel.py does two
// things in one program: the serial sweep back through time, and the weight
// gradients, summed in VMEM accumulators as the sweep goes. Here they are
// two kernels:
//
//   lstm_pair_bwd_kernel  the serial part of _pair_bwd_kernel: the reverse
//                         sweep of the two-layer wavefront, layer 1 one step
//                         behind layer 2, recomputing both layers' gates and
//                         layer 2's input projection from the forward's
//                         stashes. Writes the pre-activation gradients of
//                         both layers, d_pre1 (= dx1, the gradient of x1_proj)
//                         and d_pre2, and accumulates no weight gradient;
//   lstm_bwd_kernel       the serial part of _bwd_kernel, one layer: writes
//                         d_pre (= dx);
//   lstm_wgrad_kernel     the weight gradients both TPU kernels accumulate,
//   + lstm_wgrad_sum_kernel  as a second pass: dW = sum over the T*B rows of
//                         a[row]ᵀ d_pre[row], where a is h[t-1] (zero at t=0)
//                         or (m ⊙ h1)[t], and db2 = sum of d_pre2 rows.
//                         One launch also takes the L-deep stack's 2L - 1
//                         weight gradients (lstm_stack.cu writes the d_pre
//                         planes they reduce).
//
// Why the split. The pair's serial sweep needs its three (64, 256) f32
// weights in shared memory for both the forward products and the transposed
// ones (d_pre @ wᵀ): 192 KiB of a block's 227 KB. Its three weight-gradient
// accumulators would be another 192 KiB, and registers cannot hold them
// (768 floats a thread at 256 threads); blocks also run in no order, so a
// sum across row tiles needs a second pass or atomics. The reduction is a
// product with a long contraction (T*B rows) that needs nothing of the
// serial chain, so it runs after it, over the d_pre planes the sweep wrote.
//
// The pair's sweep: what bounds it. T+1 dependent steps of six (rows, H) x
// (H, 4H) products (both layers' gates, layer 2's input projection and three
// transposed products d_pre @ wᵀ), f32 on the CUDA cores, every operand in
// shared memory. The SM serves one shared-memory wavefront (128 B) a clock,
// so what a step reads there sets its time. The first design gave each row
// group of a block its own thread per unit (2 groups x 64 units, 1 row a
// thread at 100 rows): each group read every staged weight once a product,
// and the transposed products, skewed to keep the weight reads free of bank
// conflicts, made each d_pre read a full 4-wavefront load. About 9,400
// wavefronts an SM and step, 76-86% of the 6.27 us a step measured at 100
// rows on an H100 (4 warps an SM, one a scheduler, so load latency showed).
//
// What the design does about it. One block of 256 threads (8 warps) a row
// tile of 1, 2, 4 or 8 rows, the fewest that keep the grid in one wave. Lane
// u + 8 q of warp w serves unit j = 8 w + u and quarter q of the contraction
// for all the tile's rows, which it keeps in registers, so each staged weight
// float4 is read by exactly one lane a product and step: 2 x 3 x 64 x 64
// float4 = 3,072 wavefronts a block and step at H = 64, plus about 200-400
// operand reads, whatever the rows. The quarters are summed with warp
// shuffles (a reduce-scatter from 4 rows on: lane q keeps rows q, q + 4).
// The weights are staged with a row stride of p + 1 float4 (p = H padded to
// 16, zeros beyond H), so the 8 lanes of a quarter-warp fall on distinct bank
// slots walking j (gate products) or k (transposed products), and all lanes
// walk in the same order: each h or d_pre operand read is shared by the 8
// lanes of a quarter-warp, its 4 quarters on distinct slots through the
// padding of the operand planes. At 8 rows the FMAs take over (6,144
// clocks of FMAs a step). dh, dc and the seam cotangent stay in the
// registers of the lane that owns the row; the next step's h loads are in
// flight during this one.
//
// The single sweep and the pass: what bounds them. The single sweep is the
// forward's chain run backwards: T dependent steps of two (rows, H) x (H, 4H)
// products, f32 on the CUDA cores; latency of the step chain, not bandwidth,
// limits it, as in the forward. The reduction does 2*H*4H FLOPs per row for
// each weight over (T*B, H) and (T*B, 4H) planes read once per tile: at T=60,
// 800 rows, H=64 that is 4.7 GFLOP over ~40 MB for the pair, bound by f32
// arithmetic.
//
// What the design does about it. The single sweep keeps the forward's
// layout: a block owns a tile of rows and walks the whole sweep; the
// weights are staged once in shared memory as a float4 of the four gates per
// (k, j); thread (group, j) owns unit j of its rows. The forward products
// read the h rows from shared memory as in the forward. The transposed
// product out[row][k] = sum_j dot(d_pre[row][j], w_s[k][j]) reads the same
// staged weights: thread k walks j from a skew of k, so that the float4
// reads of a warp fall in distinct shared-memory banks. dh, dc stay in
// registers; the d_pre rows go through shared memory. The
// reduction is a tiled f32 product (64 x 64 output tile a block, 4 x 4
// outputs a thread, 16-row chunks staged in shared memory) split over row
// ranges to fill the card, and a second kernel sums the splits in a fixed
// order: no atomics, so a run repeats bit for bit. Accurate expf/tanhf.

#include <algorithm>

#include "lstm_common.cuh"

namespace {

// ------------------------------------------------ the pair's backward sweep

constexpr int kSweepThreads = 256;  // 8 warps: 8 units x 4 quarters a warp
constexpr int kSweepMaxRows = 8;    // the largest row tile

// The contraction padded to 4 quarters of a multiple of 4 (zero weights and
// zero operands beyond H), so that every lane reads its quarter 4 at a time.
__host__ __device__ __forceinline__ int sweep_pad(int hidden) {
  return (hidden + 15) & ~15;
}

// w (H, 4H) row-major in device memory -> w_s[k * (p + 1) + j] = the four
// gate weights of unit j at k, for k, j < p = sweep_pad(H), zero beyond H.
// The row stride p + 1 (odd) puts the 8 lanes of a quarter-warp on 8
// distinct bank slots whether they walk j (gate products) or k (transposed
// products) with the other index fixed.
__device__ void stage_weight_padded(const float* __restrict__ w, float4* w_s,
                                    int hidden, int p) {
  const int four_h = 4 * hidden;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < p * p; idx += blockDim.x) {
    const int k = idx / p;
    const int j = idx - k * p;
    const float* src = w + k * four_h + j;
    w_s[k * (p + 1) + j] =
        k < hidden && j < hidden
            ? make_float4(__ldg(src), __ldg(src + hidden),
                          __ldg(src + 2 * hidden), __ldg(src + 3 * hidden))
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Where unit k sits in a row of an h plane (floats): quarter k / kq starts at
// (k / kq) * (kq + 4), so the 4 quarters' float4 reads of a warp fall on
// distinct bank slots.
__device__ __forceinline__ int h_col(int k, int kq) { return k + (k / kq) * 4; }

// Where unit j sits in a row of a d_pre plane (float4): quarter j / kq starts
// at (j / kq) * (kq + 1), for the same reason.
__device__ __forceinline__ int dp_col(int j, int kq) { return j + j / kq; }

// v[r] = plane[t][tile0 + q + 4 i][j] for the rows i a lane owns (q + 4 i <
// ROWS), zero outside the plane, past the tile or for j >= H.
template <int ROWS>
__device__ __forceinline__ void load_owned(const float* __restrict__ plane,
                                           int t, int n_t, int n_rows,
                                           int hidden, int tile0, int q, int j,
                                           float (&v)[(ROWS + 3) / 4]) {
  const bool in = t >= 0 && t < n_t && j < hidden;
#pragma unroll
  for (int i = 0; i < (ROWS + 3) / 4; ++i) {
    const int lrow = q + 4 * i;
    const int row = tile0 + lrow;
    v[i] = in && lrow < ROWS && row < n_rows
               ? __ldg(plane + (static_cast<size_t>(t) * n_rows + row) * hidden + j)
               : 0.0f;
  }
}

// xv[g][i] = x[t][tile0 + q + 4 i][g * H + j], as load_owned.
template <int ROWS>
__device__ __forceinline__ void load_owned_x(const float* __restrict__ x, int t,
                                             int n_t, int n_rows, int hidden,
                                             int tile0, int q, int j,
                                             float (&xv)[4][(ROWS + 3) / 4]) {
  const bool in = t >= 0 && t < n_t && j < hidden;
  const int four_h = 4 * hidden;
#pragma unroll
  for (int i = 0; i < (ROWS + 3) / 4; ++i) {
    const int lrow = q + 4 * i;
    const int row = tile0 + lrow;
    const bool ok = in && lrow < ROWS && row < n_rows;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      xv[g][i] = ok ? __ldg(x + (static_cast<size_t>(t) * n_rows + row) * four_h +
                            g * hidden + j)
                    : 0.0f;
    }
  }
}

// Sums v over the 4 quarter lanes of a unit (lane bits 3 and 4); afterwards
// lane q holds in out[i] the sum for row q + 4 i. From 4 rows on a
// reduce-scatter (each lane sends the half it does not keep, twice); for 1
// or 2 rows a butterfly, and lane q < ROWS keeps row q. The whole warp calls.
template <int ROWS, int N>
__device__ __forceinline__ void quarter_sum(float (&v)[ROWS][N], int q,
                                            float (&out)[(ROWS + 3) / 4][N]) {
  constexpr unsigned kAll = 0xffffffffu;
  if constexpr (ROWS >= 4) {
    const bool b1 = q & 2;
#pragma unroll
    for (int a = 0; a < ROWS; a += 4)
#pragma unroll
      for (int r = a; r < a + 2; ++r)
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float send = b1 ? v[r][n] : v[r + 2][n];
          const float keep = b1 ? v[r + 2][n] : v[r][n];
          v[r][n] = keep + __shfl_xor_sync(kAll, send, 16);
        }
    const bool b0 = q & 1;
#pragma unroll
    for (int a = 0; a < ROWS; a += 4)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float send = b0 ? v[a][n] : v[a + 1][n];
        const float keep = b0 ? v[a + 1][n] : v[a][n];
        out[a / 4][n] = keep + __shfl_xor_sync(kAll, send, 8);
      }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float s = v[r][n];
        s += __shfl_xor_sync(kAll, s, 8);
        s += __shfl_xor_sync(kAll, s, 16);
        v[r][n] = s;
      }
#pragma unroll
    for (int n = 0; n < N; ++n) out[0][n] = q == 1 ? v[ROWS - 1][n] : v[0][n];
  }
}

// This lane's share of L gate products h @ w for unit j: acc[r][4 o + g] +=
// sum over k in quarter q of h_s[l][r][k] * w_s[l][k][j].g, product l adding
// into output o = min(l, O - 1). Each staged weight float4 is read by one
// lane of the block; the 8 lanes of a quarter-warp read 8 consecutive j.
template <int ROWS, int L, int O>
__device__ __forceinline__ void quarter_gate_products(
    const float* const (&h_s)[L], const float4* const (&w_s)[L], int kq,
    int h_row, int q, int j, float (&acc)[ROWS][4 * O]) {
  const int stride = 4 * kq + 1;
  const int h0 = q * (kq + 4);
#pragma unroll 4
  for (int m = 0; m < kq; m += 4) {
    const int k0 = q * kq + m;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      constexpr int kLast = O - 1;
      const int o = l < kLast ? l : kLast;
      float4 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = w_s[l][(k0 + e) * stride + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 h4 =
            *reinterpret_cast<const float4*>(h_s[l] + r * h_row + h0 + m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = lane(h4, e);
          acc[r][4 * o + 0] = fmaf(h, w[e].x, acc[r][4 * o + 0]);
          acc[r][4 * o + 1] = fmaf(h, w[e].y, acc[r][4 * o + 1]);
          acc[r][4 * o + 2] = fmaf(h, w[e].z, acc[r][4 * o + 2]);
          acc[r][4 * o + 3] = fmaf(h, w[e].w, acc[r][4 * o + 3]);
        }
      }
    }
  }
}

// This lane's share of L transposed products d_pre @ wᵀ for unit k:
// out[r][l] = sum over j in quarter q, g of dp_s[l][r][j].g * w_s[l][k][j].g.
// Each staged weight float4 is read by one lane; the 8 lanes of a
// quarter-warp read 8 rows k (p + 1 apart) and share one d_pre read.
template <int ROWS, int L>
__device__ __forceinline__ void quarter_transposed_products(
    const float4* const (&dp_s)[L], const float4* const (&w_s)[L], int kq,
    int dp_row, int q, int k, float (&out)[ROWS][L]) {
  const int stride = 4 * kq + 1;
  const int d0 = q * (kq + 1);
  const int w0 = k * stride + q * kq;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int l = 0; l < L; ++l) out[r][l] = 0.0f;
#pragma unroll 8
  for (int m = 0; m < kq; ++m) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 w = w_s[l][w0 + m];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 d = dp_s[l][r * dp_row + d0 + m];
        float s = out[r][l];
        s = fmaf(d.x, w.x, s);
        s = fmaf(d.y, w.y, s);
        s = fmaf(d.z, w.z, s);
        s = fmaf(d.w, w.w, s);
        out[r][l] = s;
      }
    }
  }
}

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
template <int ROWS, bool HAS_MASK>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_pair_bwd_kernel(const float* __restrict__ dh2s, const float* __restrict__ x1,
                     const float* __restrict__ mask, const float* __restrict__ h1s,
                     const float* __restrict__ c1s, const float* __restrict__ h2s,
                     const float* __restrict__ c2s, const float* __restrict__ w1,
                     const float* __restrict__ wi2, const float* __restrict__ b2,
                     const float* __restrict__ w2, float* __restrict__ dx1,
                     float* __restrict__ dpre2, int n_t, int n_rows, int hidden) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
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
  for (int g = 0; g < 4; ++g) b2v[g] = j < hidden ? __ldg(b2 + g * hidden + j) : 0.0f;
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
              if (run1) dx1[t1 * plane + at + g * hidden] = d1[g][i];
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

// ------------------------------------------------ the single-layer sweep

// Serial part of the single-layer backward. Replaces the sweep of
// _bwd_kernel (masters_thesis_tpu/ops/lstm_kernel.py): t = T-1 .. 0, gates
// recomputed from x[t] + h[t-1] @ w, d_pre written into dx[t].
// Shared memory: w_s [padded(H)][H] float4, hp_s [rows][padded(H)],
// dp_s [rows][H] float4.
template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ x,
                const float* __restrict__ hs, const float* __restrict__ cs,
                const float* __restrict__ w, float* __restrict__ dx, int n_t,
                int n_rows, int hidden) {
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  float4* w_s = smem;
  float4* hp_s4 = w_s + kp * hidden;
  float4* dp_s = hp_s4 + rows * kp / 4;
  float* hp_s = reinterpret_cast<float*>(hp_s4);
  stage_weight(w, w_s, hidden);
  for (int idx = threadIdx.x; idx < rows * kp; idx += blockDim.x) {
    hp_s[idx] = 0.0f;
  }
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = blockIdx.x * rows + lrow0;
  const float4* const h_in[1] = {hp_s4};
  const float4* const w_in[1] = {w_s};
  const float4* const dp_in[1] = {dp_s};

  float dh_rec[RPT], dc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dh_rec[r] = dc[r] = 0.0f;
  __syncthreads();

  for (int t = n_t - 1; t >= 0; --t) {
    float hv[RPT];
    load_h(hs, t - 1, n_t, n_rows, hidden, row0, j, hv);
#pragma unroll
    for (int r = 0; r < RPT; ++r) hp_s[(lrow0 + r) * kp + j] = hv[r];
    float acc[1][4][RPT], cv[RPT], cp[RPT], dhv[RPT];
    load_x(x, t, n_t, n_rows, hidden, row0, j, acc[0]);
    load_h(cs, t, n_t, n_rows, hidden, row0, j, cv);
    load_h(cs, t - 1, n_t, n_rows, hidden, row0, j, cp);
    load_h(dhs, t, n_t, n_rows, hidden, row0, j, dhv);
    __syncthreads();  // hp_s holds h[t-1]

    gate_products<RPT, 1>(h_in, w_in, lrow0, hidden, j, acc);
    float dh[RPT], d[4][RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) dh[r] = dhv[r] + dh_rec[r];
    cell_backward(acc[0], cv, cp, dh, dc, d);
    store_d_pre(d, true, dx, t, n_rows, hidden, row0, lrow0, j, dp_s);
    __syncthreads();  // dp_s holds this step's d_pre rows

    float tr[1][RPT];
    transposed_products<RPT, 1>(dp_in, w_in, lrow0, hidden, j, tr);
#pragma unroll
    for (int r = 0; r < RPT; ++r) dh_rec[r] = tr[0][r];
  }
}

// ------------------------------------------------------ weight gradients

// Jobs of one launch: at most the L-deep stack's 2L - 1 (L = 8).
constexpr int kMaxJobs = 15;
constexpr int kTile = 64;            // output tile: kTile x kTile
constexpr int kChunk = 16;           // rows staged in shared memory at once
constexpr int kWgradThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kSumThreads = 256;

// One weight gradient out[k][n] = sum_rows a[row][k] * dpre[row][n] over the
// T*B rows (row = t * B + b), a[row] = src[row - shift * B] (zero before the
// first step) times mask[row] when mask is set. bias_out, when set, also
// receives sum_rows dpre[row][n].
struct WgradJob {
  const float* src;
  const float* mask;
  const float* dpre;
  float* out;
  float* bias_out;
  int shift;
};

struct WgradJobs {
  WgradJob job[kMaxJobs];
};

// Partial sums of each (job, split): part[job * splits + split] is an
// (H + 1, 4H) plane, rows < H the weight gradient over the split's rows and
// row H the bias sum. grid: (4H tiles, H tiles, jobs * splits).
__global__ void __launch_bounds__(kWgradThreads)
lstm_wgrad_kernel(WgradJobs jobs, float* __restrict__ part, int splits,
                  int n_t, int n_rows, int hidden) {
  const WgradJob jb = jobs.job[blockIdx.z / splits];
  const int split = blockIdx.z % splits;
  const int four_h = 4 * hidden;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int total = n_t * n_rows;
  const int per = (total + splits - 1) / splits;
  const int begin = split * per;
  const int end = min(total, begin + per);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool bias = jb.bias_out != nullptr && blockIdx.y == 0 && ty == 0;
  __shared__ __align__(16) float a_s[kChunk][kTile];
  __shared__ __align__(16) float d_s[kChunk][kTile];

  float acc[4][4], bacc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bacc[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  }
  for (int chunk = begin; chunk < end; chunk += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kWgradThreads) {
      const int rr = e / kTile;
      const int cc = e - rr * kTile;
      const int row = chunk + rr;
      const int m = m0 + cc;
      const int n = n0 + cc;
      float a = 0.0f, d = 0.0f;
      if (row < end) {
        const int src_row = row - jb.shift * n_rows;
        if (m < hidden && src_row >= 0) {
          a = __ldg(jb.src + static_cast<size_t>(src_row) * hidden + m);
          if (jb.mask != nullptr) {
            a *= __ldg(jb.mask + static_cast<size_t>(row) * hidden + m);
          }
        }
        if (n < four_h) d = __ldg(jb.dpre + static_cast<size_t>(row) * four_h + n);
      }
      a_s[rr][cc] = a;
      d_s[rr][cc] = d;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&d_s[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], dv[q], acc[i][q]);
      if (bias) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bacc[q] += dv[q];
      }
    }
    __syncthreads();
  }
  float* p = part + static_cast<size_t>(blockIdx.z) * (hidden + 1) * four_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (m < hidden && n < four_h) p[m * four_h + n] = acc[i][q];
    }
  }
  if (bias) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n < four_h) p[hidden * four_h + n] = bacc[q];
    }
  }
}

// out = sum over splits s = 0, 1, ... of the partial planes, in that order.
// grid: ((H + 1) * 4H / kSumThreads, jobs).
__global__ void __launch_bounds__(kSumThreads)
lstm_wgrad_sum_kernel(WgradJobs jobs, const float* __restrict__ part,
                      int splits, int hidden) {
  const WgradJob jb = jobs.job[blockIdx.y];
  const int four_h = 4 * hidden;
  const int idx = blockIdx.x * kSumThreads + threadIdx.x;
  const bool is_bias = idx >= hidden * four_h;
  if (idx >= (hidden + 1) * four_h || (is_bias && jb.bias_out == nullptr)) return;
  const size_t plane = static_cast<size_t>(hidden + 1) * four_h;
  const float* p = part + blockIdx.y * splits * plane + idx;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += p[sp * plane];
  if (is_bias) {
    jb.bias_out[idx - hidden * four_h] = s;
  } else {
    jb.out[idx] = s;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Rows a block of the pair's sweep: the smallest of 1, 2, 4, 8 whose grid
// fits one wave of SMs. A block reads its staged weights once a product and
// step whatever its rows, so the tile only sets how many SMs work.
cudaError_t sweep_rows(int n_rows, int device, int* rows) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *rows = kSweepMaxRows;
  for (int r = 1; r < kSweepMaxRows; r *= 2) {
    if (ceil_div(n_rows, r) <= sms) {
      *rows = r;
      break;
    }
  }
  return cudaSuccess;
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

}  // namespace

extern "C" {

int lstm_bwd_max_hidden() { return kMaxHidden; }

// Every entry point takes the CUDA device index of its pointers and stream:
// this library links its own CUDA runtime, whose current device is set here.

// dx1 = d_pre1 and dpre2 (T, B, 4H) from dh2s (T, B, H), x1 (T, B, 4H), the
// optional mask and the stashes h1s, c1s, h2s, c2s (T, B, H), the weights
// w1_t, wi2_t, w2_t (H, 4H) and b2 (4H).
int lstm_pair_bwd(const float* dh2s, const float* x1, const float* mask,
                  const float* h1s, const float* c1s, const float* h2s,
                  const float* c2s, const float* w1_t, const float* wi2_t,
                  const float* b2, const float* w2_t, float* dx1, float* dpre2,
                  int n_t, int n_rows, int hidden, int device,
                  cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int rows = 0;
  if (err == cudaSuccess) err = sweep_rows(n_rows, device, &rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto run = [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    const auto kernel = mask != nullptr ? lstm_pair_bwd_kernel<kRows, true>
                                        : lstm_pair_bwd_kernel<kRows, false>;
    const size_t smem = sweep_smem(hidden, kRows, mask != nullptr);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<ceil_div(n_rows, kRows), kSweepThreads, smem, stream>>>(
        dh2s, x1, mask, h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t, dx1, dpre2,
        n_t, n_rows, hidden);
    return cudaGetLastError();
  };
  switch (rows) {
    case 1:
      return static_cast<int>(run(std::integral_constant<int, 1>{}));
    case 2:
      return static_cast<int>(run(std::integral_constant<int, 2>{}));
    case 4:
      return static_cast<int>(run(std::integral_constant<int, 4>{}));
    default:
      return static_cast<int>(run(std::integral_constant<int, kSweepMaxRows>{}));
  }
}

// dx = d_pre (T, B, 4H) from dhs, hs, cs (T, B, H), x (T, B, 4H), w_t (H, 4H).
int lstm_bwd(const float* dhs, const float* x, const float* hs, const float* cs,
             const float* w_t, float* dx, int n_t, int n_rows, int hidden,
             int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_rpt(n_rows, device, [&](auto rpt_c) {
    constexpr int kRpt = decltype(rpt_c)::value;
    return launch(lstm_bwd_kernel<kRpt>, n_rows, hidden, kRpt,
                  smem_bytes(hidden, kRpt, 1, 1, 1), stream, dhs, x, hs, cs,
                  w_t, dx, n_t, n_rows, hidden);
  }));
}

// Splits of the row range for n_jobs weight gradients: enough blocks for
// about two a streaming multiprocessor, each split at least 256 rows. The
// caller allocates n_jobs * splits * (H + 1) * 4H floats of partial sums.
int lstm_wgrad_splits(int n_jobs, int n_t, int n_rows, int hidden, int device,
                      int* splits) {
  if (bad_shape(n_t, n_rows, hidden) || n_jobs < 1 || n_jobs > kMaxJobs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = n_jobs * ceil_div(4 * hidden, kTile) * ceil_div(hidden, kTile);
  int s = ceil_div(2 * sms, tiles);
  s = std::min(s, ceil_div(n_t * n_rows, 256));
  *splits = std::max(1, std::min(s, 64));
  return 0;
}

// Job i: out[i] (H, 4H) = sum over rows of a_i[row]ᵀ dpre[i][row], with
// a_i[row] = src[i][row - shift[i] * B] (zero for row < shift[i] * B) times
// mask[i][row] when mask[i] is set; bias_out[i] (4H), when set, gets the
// row sum of dpre[i]. part holds n_jobs * splits * (H + 1) * 4H floats.
int lstm_wgrad(int n_jobs, const float* const* src, const float* const* mask,
               const float* const* dpre, float* const* out,
               float* const* bias_out, const int* shift, float* part,
               int splits, int n_t, int n_rows, int hidden, int device,
               cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden) || n_jobs < 1 || n_jobs > kMaxJobs ||
      splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgradJobs jobs{};
  for (int i = 0; i < n_jobs; ++i) {
    jobs.job[i] = WgradJob{src[i], mask[i], dpre[i], out[i], bias_out[i], shift[i]};
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int four_h = 4 * hidden;
  const dim3 grid(ceil_div(four_h, kTile), ceil_div(hidden, kTile), n_jobs * splits);
  lstm_wgrad_kernel<<<grid, kWgradThreads, 0, stream>>>(jobs, part, splits, n_t,
                                                        n_rows, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 sum_grid(ceil_div((hidden + 1) * four_h, kSumThreads), n_jobs);
  lstm_wgrad_sum_kernel<<<sum_grid, kSumThreads, 0, stream>>>(jobs, part, splits,
                                                               hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
