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
// each weight over (T*B, H) and (T*B, 4H) planes read once per tile: at
// T=60, 800 rows, H=64 that is 4.7 GFLOP over ~40 MB for the pair, bound by
// f32 arithmetic. It is a tiled f32 product (64 x 64 output tile a block,
// 4 x 4 outputs a thread, 16-row chunks staged in shared memory) split over
// row ranges to fill the card, and a second kernel sums the splits in a
// fixed order: no atomics, so a run repeats bit for bit. Accurate
// expf/tanhf.

#include <algorithm>

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
// recomputed from x[t] + h[t-1] @ w, d_pre written into dx[t]. Iteration s
// runs single_sweep_step (lstm_sweep.cuh): d_pre[s+1] @ wᵀ and step s's
// gates in one pass, then step s's cell; d_pre[T] is a zero plane. One
// barrier an iteration. Each lane's operands of the next iteration (x, c,
// dh and the h rows it stages) are loaded from device memory one iteration
// ahead. Shared memory: w_s [p][p + 1] float4, then the planes of
// single_planes.
template <int ROWS>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ x,
                const float* __restrict__ hs, const float* __restrict__ cs,
                const float* __restrict__ w, float* __restrict__ dx, int n_t,
                int n_rows, int hidden) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
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
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    const auto kernel = mask != nullptr ? lstm_pair_bwd_kernel<kRows, true>
                                        : lstm_pair_bwd_kernel<kRows, false>;
    return launch_sweep(kernel, n_rows, kRows,
                        sweep_smem(hidden, kRows, mask != nullptr), stream, dh2s,
                        x1, mask, h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t, dx1,
                        dpre2, n_t, n_rows, hidden);
  }));
}

// dx = d_pre (T, B, 4H) from dhs, hs, cs (T, B, H), x (T, B, 4H), w_t (H, 4H).
int lstm_bwd(const float* dhs, const float* x, const float* hs, const float* cs,
             const float* w_t, float* dx, int n_t, int n_rows, int hidden,
             int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    return launch_sweep(lstm_bwd_kernel<kRows>, n_rows, kRows,
                        single_sweep_smem(hidden, kRows), stream, dhs, x, hs,
                        cs, w_t, dx, n_t, n_rows, hidden);
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
