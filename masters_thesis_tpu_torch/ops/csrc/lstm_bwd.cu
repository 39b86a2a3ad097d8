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
//                         or (m ⊙ h1)[t], and db2 = sum of d_pre2 rows; the
//                         second kernel sums the row splits in a fixed order.
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
// The single sweep: what bounds it. The forward's chain run backwards: T
// dependent steps of two (rows, H) x (H, 4H) products (the recomputed gates
// and the transposed product d_pre @ wᵀ), f32 on the CUDA cores, every
// operand in shared memory. The first design gave each of two row groups a
// thread per unit (128 threads, 1 row a thread at 100 rows): both groups read
// every staged weight, the skewed transposed product made each d_pre read 4
// wavefronts, and a step had two barriers with the gate product between
// them. About 3,140 wavefronts a block and step at H = 64 (512 clocks of
// FMAs a scheduler), 55-62% of the 2.89 us a step measured at 100 rows on an
// H100, with one warp a scheduler to hide the rest.
//
// What the design does about it. The pair's block (lstm_sweep.cuh): 256
// threads a tile of 1-8 rows, each staged weight float4 read by one lane a
// product and step: 1,024 weight wavefronts a block and step plus about
// 160 x rows of operand reads (1,184 at 1 row, 2,304 at 8), and 256 clocks
// of FMAs a scheduler at 1 row, 2,048 at 8. The gates of step s depend only
// on stashes (x[s], h[s-1]), not on the sweep, so only d_pre[s+1] @ wᵀ ->
// dh -> step s's cell is serial: the iteration that consumes d_pre[s+1]
// runs that transposed product and step s's gate product in one pass over
// the weight, sums their quarters in one quarter_sum, and has one barrier.
// lstm_tb_bwd_kernel (lstm_tb.cu) runs the same step on the same tile, so
// the two kernels' dx is bit-equal.
//
// The pass: what bounds it. The reduction does 2*H*4H FLOPs per row for
// each weight over (T*B, H) and (T*B, 4H) planes read once: at T=60, 800
// rows, H=64 that is 4.7 GFLOP over ~134 MB for the pair, bound by f32
// arithmetic (0.070 ms at an H100's 67 TFLOP/s without tensor cores; TF32
// would change the numerics).
//
// What the design does about it. A block of 256 threads owns one job's whole
// (64, 256) output, 8 x 8 outputs a thread (4 FMAs a float read from shared
// memory), over a range of rows (a split). Its operands arrive through a ring
// of 4 stages of 16 rows, copied with 16-byte cp.async (source size 0 where a
// row is past the end or before the first step, or a column past H or 4H:
// zeros, and no branch), 3 stages in flight while one is multiplied, one
// barrier a stage; the mask multiplies a where it is read, and a row's
// operands are loaded during the row before. The splits make one wave of one
// block an SM (about 150 registers a thread); each writes its (H + 1, 4H)
// partial plane and a second kernel sums the planes in split order: no
// atomics, so a run repeats bit for bit. Measured on an H100
// (ops/profile_wgrad.py, and copies of the kernel with a part removed): the
// products alone run at about half the FFMA rate, the staging adds a sixth,
// the sum 5-7 us; two blocks an SM (128 registers: spills), 128-thread blocks
// (2 or 3 an SM), 8 x 16 outputs a thread and two jobs on one d_pre in one
// block were each slower, 32-row stages no faster. Accurate expf/tanhf.

#include <algorithm>
#include <cstdint>

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
template <int ROWS, bool HAS_MASK, bool STACKED>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_pair_bwd_kernel(const float* __restrict__ dh2s, const float* __restrict__ x1,
                     const float* __restrict__ mask, const float* __restrict__ h1s,
                     const float* __restrict__ c1s, const float* __restrict__ h2s,
                     const float* __restrict__ c2s, const float* __restrict__ w1,
                     const float* __restrict__ wi2, const float* __restrict__ b2,
                     const float* __restrict__ w2, float* __restrict__ dx1,
                     float* __restrict__ dpre2, int n_t, int n_rows, int hidden) {
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
// recomputed from x[t] + h[t-1] @ w, d_pre written into dx[t]. Iteration s
// runs single_sweep_step (lstm_sweep.cuh): d_pre[s+1] @ wᵀ and step s's
// gates in one pass, then step s's cell; d_pre[T] is a zero plane. One
// barrier an iteration. Each lane's operands of the next iteration (x, c,
// dh and the h rows it stages) are loaded from device memory one iteration
// ahead. The replica axis, as in the pair's sweep: block (tile, r) runs
// replica r of R stacked ones (dhs, hs, cs (R, T, B, H), x and dx
// (R, T, B, 4H), w (R, H, 4H)); STACKED compiles the offsets in, and a solo
// launch takes the instance without them. Shared memory: w_s [p][p + 1]
// float4, then the planes of single_planes.
template <int ROWS, bool STACKED>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ x,
                const float* __restrict__ hs, const float* __restrict__ cs,
                const float* __restrict__ w, float* __restrict__ dx, int n_t,
                int n_rows, int hidden) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  if constexpr (STACKED) {
    const size_t rep = blockIdx.y;
    const size_t plane = static_cast<size_t>(n_t) * n_rows * hidden;
    dhs += rep * plane;
    x += rep * 4 * plane;
    hs += rep * plane;
    cs += rep * plane;
    w += rep * hidden * 4 * hidden;
    dx += rep * 4 * plane;
  }
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  float4* w_s = smem;
  const SinglePlanes pl = single_planes(w_s + p * (p + 1), p, ROWS);
  stage_weight_padded(w, w_s, hidden, p);
  for (int idx = threadIdx.x; idx < 2 * pl.dp_size; idx += blockDim.x) {
    pl.dp[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // d_pre[T] is zero
  }
  const int q = (threadIdx.x & 31) >> 3;
  const int j = (threadIdx.x >> 5) * 8 + (threadIdx.x & 7);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp
  const int tile0 = blockIdx.x * ROWS;

  // h[T-2] into its plane; step T-1's operands.
  float hv[NR], xn[4][NR], cn[NR], cpn[NR], dhn[NR], hn[NR], dc[NR];
  load_owned<ROWS>(hs, n_t - 2, n_t, n_rows, hidden, tile0, q, j, hv);
  if (active) stage_h<ROWS>(hv, pl.h_of(n_t - 2), kq, q, j);
  load_owned_x<ROWS>(x, n_t - 1, n_t, n_rows, hidden, tile0, q, j, xn);
  load_owned<ROWS>(cs, n_t - 1, n_t, n_rows, hidden, tile0, q, j, cn);
  load_owned<ROWS>(cs, n_t - 2, n_t, n_rows, hidden, tile0, q, j, cpn);
  load_owned<ROWS>(dhs, n_t - 1, n_t, n_rows, hidden, tile0, q, j, dhn);
  load_owned<ROWS>(hs, n_t - 3, n_t, n_rows, hidden, tile0, q, j, hn);
#pragma unroll
  for (int i = 0; i < NR; ++i) dc[i] = 0.0f;
  __syncthreads();  // the weight and h[T-2] are staged, d_pre[T] is zero

  for (int s = n_t - 1; s >= 0; --s) {
    float xv[4][NR], cv[NR], cpv[NR], dhv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g][i] = xn[g][i];
      cv[i] = cn[i];
      cpv[i] = cpn[i];
      dhv[i] = dhn[i];
      hv[i] = hn[i];  // h[s-2]
    }
    load_owned_x<ROWS>(x, s - 1, n_t, n_rows, hidden, tile0, q, j, xn);
    load_owned<ROWS>(cs, s - 1, n_t, n_rows, hidden, tile0, q, j, cn);
    load_owned<ROWS>(cs, s - 2, n_t, n_rows, hidden, tile0, q, j, cpn);
    load_owned<ROWS>(dhs, s - 1, n_t, n_rows, hidden, tile0, q, j, dhn);
    load_owned<ROWS>(hs, s - 3, n_t, n_rows, hidden, tile0, q, j, hn);
    if (active) {
      float d[4][NR];
      single_sweep_step<ROWS>(pl.h_of(s - 1), pl.d_pre(s + 1), w_s, kq, q, j,
                              xv, cv, cpv, dhv, dc, d);
      single_sweep_store<ROWS>(d, hv, dx, s, n_rows, hidden, tile0, q, j, kq,
                               pl.d_pre(s), pl.h_of(s - 2));
    }
    __syncthreads();  // d_pre[s] and h[s-2] are in their planes
  }
}

// ------------------------------------------------------ weight gradients

// Jobs of one launch: at most the L-deep stack's 2L - 1 (L = 8).
constexpr int kMaxJobs = 15;
// A block owns one job's whole (64, 256) output (H and 4H padded): thread
// (ty, tx) = (warp, lane) the 8 rows ty*4 + i and 32 + ty*4 + i (i < 4) and
// the 8 columns tx*4 + e and 128 + tx*4 + e (e < 4).
constexpr int kWgradThreads = 256;
constexpr int kWgradRows = 16;               // rows a stage of the ring
constexpr int kWgradStages = 4;              // the ring: 3 stages in flight
// A stage: a and the mask [kWgradRows][64], d_pre [kWgradRows][256] floats.
constexpr int kWgradStageFloats = kWgradRows * 384;
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

// A copy of W = 4 or 1 floats from device memory into shared memory at
// `dst`, or W zeros where `ok` is false (src is then any valid address):
// cp.async's source size 0 fills the destination with zeros, so rows past
// the end, before the first step and columns past H or 4H need no branch.
template <int W>
__device__ __forceinline__ void copy_or_zero(uint32_t dst, const float* src, bool ok) {
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queues one stage of the ring: rows row0 .. row0 + kWgradRows - 1 of the
// job's a [kWgradRows][64], its mask in the same layout (MASK) and d_pre
// [kWgradRows][256] into st. W floats a copy: 4 where H is a multiple of 4
// and every operand 16-byte aligned, else 1.
template <int W, bool MASK>
__device__ __forceinline__ void wgrad_stage(float* st, const WgradJob& jb, int row0,
                                            int end, int n_rows, int hidden) {
  const uint32_t a_s = static_cast<uint32_t>(__cvta_generic_to_shared(st));
  const uint32_t m_s = a_s + 4 * kWgradRows * 64;
  const uint32_t d_s = m_s + 4 * kWgradRows * 64;
#pragma unroll
  for (int idx = threadIdx.x; idx < kWgradRows * 64 / W; idx += kWgradThreads) {
    const int r = idx / (64 / W);
    const int m = (idx - r * (64 / W)) * W;
    const int row = row0 + r;
    const int src_row = row - jb.shift * n_rows;
    const bool ok = row < end && src_row >= 0 && m < hidden;
    copy_or_zero<W>(a_s + 4 * (r * 64 + m),
                    ok ? jb.src + static_cast<size_t>(src_row) * hidden + m : jb.src, ok);
    if constexpr (MASK) {
      const bool in = row < end && m < hidden;
      copy_or_zero<W>(m_s + 4 * (r * 64 + m),
                      in ? jb.mask + static_cast<size_t>(row) * hidden + m : jb.mask, in);
    }
  }
  const int four_h = 4 * hidden;
#pragma unroll
  for (int idx = threadIdx.x; idx < kWgradRows * 256 / W; idx += kWgradThreads) {
    const int r = idx / (256 / W);
    const int n = (idx - r * (256 / W)) * W;
    const int row = row0 + r;
    const bool ok = row < end && n < four_h;
    copy_or_zero<W>(d_s + 4 * (r * 256 + n),
                    ok ? jb.dpre + static_cast<size_t>(row) * four_h + n : jb.dpre, ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// acc[i][e] += sum over the stage's rows of a[row][m_i] * d[row][n_e] for
// thread (ty, tx): m_i = ty*4 + i and 32 + ty*4 + i - 4, n_e = tx*4 + e and
// 128 + tx*4 + e - 4. A warp (one ty) reads each a float4 as a broadcast and
// 32 consecutive d float4: 64 FMAs a thread for 16 floats read from shared
// memory. Row k + 1's operands are loaded before row k's FMAs. (A warp over
// 8 ty x 4 tx, which reads 4 wavefronts a row instead of 10, measured
// slower on an H100.)
template <bool MASK>
__device__ __forceinline__ void wgrad_products(const float* st, int ty, int tx,
                                               float (&acc)[8][8]) {
  const float* a_s = st + ty * 4;
  const float* m_s = a_s + kWgradRows * 64;
  const float* d_s = st + 2 * kWgradRows * 64 + tx * 4;
  float4 a[2] = {ld4(a_s), ld4(a_s + 32)}, d[2] = {ld4(d_s), ld4(d_s + 128)}, m[2];
  if constexpr (MASK) {
    m[0] = ld4(m_s);
    m[1] = ld4(m_s + 32);
  }
#pragma unroll
  for (int k = 0; k < kWgradRows; ++k) {
    const int kn = k + 1 < kWgradRows ? k + 1 : k;  // the last row loads itself
    const float4 na[2] = {ld4(a_s + kn * 64), ld4(a_s + kn * 64 + 32)};
    const float4 nd[2] = {ld4(d_s + kn * 256), ld4(d_s + kn * 256 + 128)};
    float4 nm[2];
    if constexpr (MASK) {
      nm[0] = ld4(m_s + kn * 64);
      nm[1] = ld4(m_s + kn * 64 + 32);
      a[0] = mul4(a[0], m[0]);
      a[1] = mul4(a[1], m[1]);
    }
    const float av[8] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w};
    const float dv[8] = {d[0].x, d[0].y, d[0].z, d[0].w, d[1].x, d[1].y, d[1].z, d[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], dv[e], acc[i][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h] = na[h];
      d[h] = nd[h];
      if constexpr (MASK) m[h] = nm[h];
    }
  }
}

// The bias sums: thread (ty, tx) adds its 8 columns of the stage's rows ty
// and ty + 8: 8 partial sums a column, one row in 8 each.
__device__ __forceinline__ void wgrad_bias(const float* st, int ty, int tx,
                                           float (&bacc)[8]) {
  const float* d_s = st + 2 * kWgradRows * 64 + tx * 4;
#pragma unroll
  for (int row = ty; row < kWgradRows; row += 8) {
    const float4 d0 = ld4(d_s + row * 256), d1 = ld4(d_s + row * 256 + 128);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) bacc[e] += dv[e];
  }
}

// One block: the job's whole (64, 256) output over the rows of its split,
// its partial sums into the plane part[job * splits + split] ((H + 1, 4H):
// rows < H the weight gradient, row H the bias sum). The stages go round a
// ring of kWgradStages: the copies of stage c + 3 are queued while stage c
// is multiplied, and one barrier a stage both publishes stage c and frees
// the slot stage c - 1 held.
template <int W, bool MASK>
__device__ __forceinline__ void wgrad_tile(float* ring, const WgradJob& jb, int job,
                                           float* __restrict__ part, int split,
                                           int splits, int per, int n_t, int n_rows,
                                           int hidden) {
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int total = n_t * n_rows;
  const int begin = min(total, split * per);
  const int end = min(total, begin + per);
  const int n_chunks = (end - begin + kWgradRows - 1) / kWgradRows;
  const bool bias = jb.bias_out != nullptr;
  float acc[8][8], bacc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bacc[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][e] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kWgradStages - 1; ++c) {
    if (c < n_chunks) {
      wgrad_stage<W, MASK>(ring + c * kWgradStageFloats, jb, begin + c * kWgradRows,
                           end, n_rows, hidden);
    }
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kWgradStages - 2>();  // this thread's copies of stage c
    __syncthreads();  // everyone's; and stage c - 1 is multiplied
    const int next = c + kWgradStages - 1;
    if (next < n_chunks) {
      wgrad_stage<W, MASK>(ring + (next % kWgradStages) * kWgradStageFloats, jb,
                           begin + next * kWgradRows, end, n_rows, hidden);
    }
    cp_async_commit();  // empty groups too, so the count above holds
    const float* st = ring + (c % kWgradStages) * kWgradStageFloats;
    wgrad_products<MASK>(st, ty, tx, acc);
    if (bias) wgrad_bias(st, ty, tx, bacc);
  }

  const int four_h = 4 * hidden;
  const size_t plane = static_cast<size_t>(hidden + 1) * four_h;
  float* p = part + (static_cast<size_t>(job) * splits + split) * plane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i / 4) * 32 + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = h * 128 + tx * 4;
      if (m < hidden && n < four_h) {
        *reinterpret_cast<float4*>(p + m * four_h + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      }
    }
  }
  if (bias) {  // the same for the whole block
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: the bias partials of each ty
#pragma unroll
    for (int e = 0; e < 8; ++e) ring[ty * 256 + (e / 4) * 128 + tx * 4 + e % 4] = bacc[e];
    __syncthreads();
    for (int n = threadIdx.x; n < four_h; n += kWgradThreads) {
      float s = 0.0f;
      for (int t = 0; t < 8; ++t) s += ring[t * 256 + n];
      p[hidden * four_h + n] = s;
    }
  }
}

// A job of replica r: the job's operands offset to the r-th of R stacked
// ones (src and mask (R, T, B, H), d_pre (R, T, B, 4H), out (R, H, 4H),
// bias_out (R, 4H)).
__device__ __forceinline__ WgradJob replica_job(const WgradJob& jb, size_t rep,
                                                int n_t, int n_rows, int hidden) {
  const size_t plane = static_cast<size_t>(n_t) * n_rows * hidden;
  const size_t weight = static_cast<size_t>(hidden) * 4 * hidden;
  WgradJob r = jb;
  r.src += rep * plane;
  if (r.mask != nullptr) r.mask += rep * plane;
  r.dpre += rep * 4 * plane;
  r.out += rep * weight;
  if (r.bias_out != nullptr) r.bias_out += rep * 4 * hidden;
  return r;
}

// One block's share of the pass for job ``jb`` (its partial plane in
// ``part``), by the job's mask.
template <int W>
__device__ __forceinline__ void wgrad_block(float* ring, const WgradJob& jb, int job,
                                            float* __restrict__ part, int split,
                                            int splits, int per, int n_t, int n_rows,
                                            int hidden) {
  if (jb.mask != nullptr) {
    wgrad_tile<W, true>(ring, jb, job, part, split, splits, per, n_t, n_rows, hidden);
  } else {
    wgrad_tile<W, false>(ring, jb, job, part, split, splits, per, n_t, n_rows, hidden);
  }
}

// The pass: block (job, split, replica), blockIdx.x = job * splits + split,
// blockIdx.y = replica. The partial planes are replica-major: replica r's
// jobs own planes r * n_jobs * splits onwards. The splits are the solo
// pass's (lstm_wgrad_splits of the job count, not of R x jobs), so each
// replica's sums are taken in the order of its solo pass. STACKED compiles
// the replica offsets in; a solo pass reads its jobs as before the axis.
template <bool VEC, bool STACKED>
__global__ void __launch_bounds__(kWgradThreads, 1)
lstm_wgrad_kernel(const __grid_constant__ WgradJobs jobs, float* __restrict__ part,
                  int n_jobs, int splits, int per, int n_t, int n_rows, int hidden) {
  extern __shared__ float4 wgrad_smem[];
  float* ring = reinterpret_cast<float*>(wgrad_smem);
  constexpr int W = VEC ? 4 : 1;
  const int job = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  if constexpr (STACKED) {
    const WgradJob jb = replica_job(jobs.job[job], blockIdx.y, n_t, n_rows, hidden);
    part += static_cast<size_t>(blockIdx.y) * n_jobs * splits * (hidden + 1) * 4 * hidden;
    wgrad_block<W>(ring, jb, job, part, split, splits, per, n_t, n_rows, hidden);
  } else {
    wgrad_block<W>(ring, jobs.job[job], job, part, split, splits, per, n_t, n_rows,
                   hidden);
  }
}

// out = sum over splits s = 0, 1, ... of the partial planes of job jb (plane
// index ``plane_job``), in that order, 4 columns a thread.
__device__ __forceinline__ void wgrad_sum(const WgradJob& jb, const float* __restrict__ part,
                                          size_t plane_job, int splits, int hidden) {
  const int four_h = 4 * hidden;
  const int idx = 4 * (blockIdx.x * kSumThreads + threadIdx.x);
  const bool is_bias = idx >= hidden * four_h;
  if (idx >= (hidden + 1) * four_h || (is_bias && jb.bias_out == nullptr)) return;
  const size_t plane = static_cast<size_t>(hidden + 1) * four_h;
  const float* p = part + plane_job * splits * plane + idx;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) {
    const float4 v = ld4(p + sp * plane);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  float* out = is_bias ? jb.bias_out + (idx - hidden * four_h) : jb.out + idx;
  *reinterpret_cast<float4*>(out) = s;
}

// grid: ((H + 1) * 4H / 4 / kSumThreads, replicas x jobs), blockIdx.y =
// replica * n_jobs + job: the partial planes' order.
template <bool STACKED>
__global__ void __launch_bounds__(kSumThreads)
lstm_wgrad_sum_kernel(const __grid_constant__ WgradJobs jobs,
                      const float* __restrict__ part, int n_jobs, int splits,
                      int n_t, int n_rows, int hidden) {
  if constexpr (STACKED) {
    const WgradJob jb = replica_job(jobs.job[blockIdx.y % n_jobs],
                                    blockIdx.y / n_jobs, n_t, n_rows, hidden);
    wgrad_sum(jb, part, blockIdx.y, splits, hidden);
  } else {
    wgrad_sum(jobs.job[blockIdx.y], part, blockIdx.y, splits, hidden);
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

}  // namespace

extern "C" {

int lstm_bwd_max_hidden() { return kMaxHidden; }

// Every entry point takes the CUDA device index of its pointers and stream:
// this library links its own CUDA runtime, whose current device is set here.

// dx1 = d_pre1 and dpre2 (R, T, B, 4H) from dh2s (R, T, B, H), x1
// (R, T, B, 4H), the optional mask and the stashes h1s, c1s, h2s, c2s
// (R, T, B, H), the weights w1_t, wi2_t, w2_t (R, H, 4H) and b2 (R, 4H): R
// replicas in one launch (R = 1: one pair). tile as in lstm_pair_fwd.
int lstm_pair_bwd(const float* dh2s, const float* x1, const float* mask,
                  const float* h1s, const float* c1s, const float* h2s,
                  const float* c2s, const float* w1_t, const float* wi2_t,
                  const float* b2, const float* w2_t, float* dx1, float* dpre2,
                  int n_t, int n_rows, int hidden, int replicas, int tile,
                  int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden) || replicas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    const auto kernel =
        mask != nullptr
            ? (replicas > 1 ? lstm_pair_bwd_kernel<kRows, true, true>
                            : lstm_pair_bwd_kernel<kRows, true, false>)
            : (replicas > 1 ? lstm_pair_bwd_kernel<kRows, false, true>
                            : lstm_pair_bwd_kernel<kRows, false, false>);
    return launch_sweep(kernel, n_rows, kRows, replicas,
                        sweep_smem(hidden, kRows, mask != nullptr), stream, dh2s,
                        x1, mask, h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t, dx1,
                        dpre2, n_t, n_rows, hidden);
  }, replicas, tile));
}

// dx = d_pre (R, T, B, 4H) from dhs, hs, cs (R, T, B, H), x (R, T, B, 4H),
// w_t (R, H, 4H): R replicas in one launch (R = 1: one layer). tile as in
// lstm_fwd.
int lstm_bwd(const float* dhs, const float* x, const float* hs, const float* cs,
             const float* w_t, float* dx, int n_t, int n_rows, int hidden,
             int replicas, int tile, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden) || replicas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    const auto kernel = replicas > 1 ? lstm_bwd_kernel<kRows, true>
                                     : lstm_bwd_kernel<kRows, false>;
    return launch_sweep(kernel, n_rows, kRows, replicas,
                        single_sweep_smem(hidden, kRows), stream, dhs, x, hs,
                        cs, w_t, dx, n_t, n_rows, hidden);
  }, replicas, tile));
}

// Splits of the row range for n_jobs weight gradients: one wave of one
// block an SM (n_jobs * splits blocks), no split left empty. The caller
// allocates n_jobs * splits * (H + 1) * 4H floats of partial sums.
int lstm_wgrad_splits(int n_jobs, int n_t, int n_rows, int hidden, int device,
                      int* splits) {
  if (bad_shape(n_t, n_rows, hidden) || n_jobs < 1 || n_jobs > kMaxJobs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = ceil_div(n_t * n_rows, kWgradRows);
  *splits = ceil_div(chunks, ceil_div(chunks, std::max(1, sms / n_jobs)));
  return 0;
}

// Job i: out[i] (H, 4H) = sum over rows of a_i[row]ᵀ dpre[i][row], with
// a_i[row] = src[i][row - shift[i] * B] (zero for row < shift[i] * B) times
// mask[i][row] when mask[i] is set; bias_out[i] (4H), when set, gets the
// row sum of dpre[i]. With R replicas every operand is R stacked ones
// (src, mask (R, T, B, H), dpre (R, T, B, 4H), out (R, H, 4H), bias_out
// (R, 4H)) and each replica's jobs run as one solo pass would (the same
// splits). part holds R * n_jobs * splits * (H + 1) * 4H floats.
int lstm_wgrad(int n_jobs, const float* const* src, const float* const* mask,
               const float* const* dpre, float* const* out,
               float* const* bias_out, const int* shift, float* part,
               int splits, int n_t, int n_rows, int hidden, int replicas,
               int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden) || n_jobs < 1 || n_jobs > kMaxJobs ||
      splits < 1 || replicas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  WgradJobs jobs{};
  bool vec = hidden % 4 == 0;
  for (int i = 0; i < n_jobs; ++i) {
    jobs.job[i] = WgradJob{src[i], mask[i], dpre[i], out[i], bias_out[i], shift[i]};
    // The sum writes 4 floats at a time into every output.
    if (!aligned(out[i]) || (bias_out[i] != nullptr && !aligned(bias_out[i]))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    vec = vec && aligned(src[i]) && aligned(dpre[i]) &&
          (mask[i] == nullptr || aligned(mask[i]));
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = ceil_div(ceil_div(n_t * n_rows, kWgradRows), splits) * kWgradRows;
  const size_t smem = kWgradStages * kWgradStageFloats * sizeof(float);
  const bool stacked = replicas > 1;
  const auto kernel = vec ? (stacked ? lstm_wgrad_kernel<true, true>
                                     : lstm_wgrad_kernel<true, false>)
                          : (stacked ? lstm_wgrad_kernel<false, true>
                                     : lstm_wgrad_kernel<false, false>);
  err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_jobs * splits, replicas), kWgradThreads, smem, stream>>>(
      jobs, part, n_jobs, splits, per, n_t, n_rows, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 sum_grid(ceil_div((hidden + 1) * hidden, kSumThreads), replicas * n_jobs);
  const auto sum = stacked ? lstm_wgrad_sum_kernel<true> : lstm_wgrad_sum_kernel<false>;
  sum<<<sum_grid, kSumThreads, 0, stream>>>(jobs, part, n_jobs, splits, n_t, n_rows,
                                           hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
