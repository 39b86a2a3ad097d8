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
// What bounds them. The serial kernels are the forward's chain run
// backwards: T+1 (pair) or T dependent steps of six (pair) or two (single)
// (rows, H) x (H, 4H) products, f32 on the CUDA cores; latency of the step
// chain, not bandwidth, limits them, as in the forward. The reduction does
// 2*H*4H FLOPs per row for each weight over (T*B, H) and (T*B, 4H) planes
// read once per tile: at T=60, 800 rows, H=64 that is 4.7 GFLOP over ~40 MB
// for the pair, bound by f32 arithmetic.
//
// What the design does about it. The serial kernels keep the forward's
// layout: a block owns a tile of rows and walks the whole sweep; the
// weights are staged once in shared memory as a float4 of the four gates per
// (k, j); thread (group, j) owns unit j of its rows. The forward products
// read the h rows from shared memory as in the forward. The transposed
// product out[row][k] = sum_j dot(d_pre[row][j], w_s[k][j]) reads the same
// staged weights: thread k walks j from a skew of k, so that the float4
// reads of a warp fall in distinct shared-memory banks. dh, dc and the seam
// cotangent stay in registers; the d_pre rows go through shared memory. The
// reduction is a tiled f32 product (64 x 64 output tile a block, 4 x 4
// outputs a thread, 16-row chunks staged in shared memory) split over row
// ranges to fill the card, and a second kernel sums the splits in a fixed
// order: no atomics, so a run repeats bit for bit. Accurate expf/tanhf.

#include <algorithm>

#include "lstm_common.cuh"

namespace {

// Serial part of the pair backward. Replaces the sweep of _pair_bwd_kernel
// (masters_thesis_tpu/ops/lstm_kernel.py). Iteration k runs layer 1 at
// t1 = T-k (k > 0) and layer 2 at t2 = T-1-k (k < T): layer 1 consumes the
// seam cotangent dh1_in that layer 2 made at t1 in iteration k-1, and t2 =
// t1-1, so h1[t2] is both layer 1's h[t1-1] and layer 2's input. The step
// that is not run (layer 1 at k = 0, layer 2 at k = T) is computed on zeros
// and discarded: uniform control flow.
// Shared memory: w1_s, wi2_s, w2_s [padded(H)][H] float4; hp1_s (h1[t2]),
// hp2_s (h2[t2-1]) and, with HAS_MASK, hm_s ((m ⊙ h1)[t2]) [rows][padded(H)];
// dp1_s, dp2_s [rows][H] float4.
template <int RPT, bool HAS_MASK>
__global__ void __launch_bounds__(kMaxThreads)
lstm_pair_bwd_kernel(const float* __restrict__ dh2s, const float* __restrict__ x1,
                     const float* __restrict__ mask, const float* __restrict__ h1s,
                     const float* __restrict__ c1s, const float* __restrict__ h2s,
                     const float* __restrict__ c2s, const float* __restrict__ w1,
                     const float* __restrict__ wi2, const float* __restrict__ b2,
                     const float* __restrict__ w2, float* __restrict__ dx1,
                     float* __restrict__ dpre2, int n_t, int n_rows, int hidden) {
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  float4* w1_s = smem;
  float4* wi2_s = w1_s + kp * hidden;
  float4* w2_s = wi2_s + kp * hidden;
  float4* hp1_s4 = w2_s + kp * hidden;
  float4* hp2_s4 = hp1_s4 + rows * kp / 4;
  float4* hm_s4 = hp2_s4 + rows * kp / 4;
  float4* dp1_s = hm_s4 + (HAS_MASK ? rows * kp / 4 : 0);
  float4* dp2_s = dp1_s + rows * hidden;
  float* hp1_s = reinterpret_cast<float*>(hp1_s4);
  float* hp2_s = reinterpret_cast<float*>(hp2_s4);
  float* hm_s = reinterpret_cast<float*>(hm_s4);
  stage_weight(w1, w1_s, hidden);
  stage_weight(wi2, wi2_s, hidden);
  stage_weight(w2, w2_s, hidden);
  for (int idx = threadIdx.x; idx < (HAS_MASK ? 3 : 2) * rows * kp;
       idx += blockDim.x) {
    hp1_s[idx] = 0.0f;  // the padded k columns stay zero
  }
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = blockIdx.x * rows + lrow0;
  const float4* const h_in[3] = {hp1_s4, HAS_MASK ? hm_s4 : hp1_s4, hp2_s4};
  const float4* const w_in[3] = {w1_s, wi2_s, w2_s};
  const float4* const dp_in[3] = {dp1_s, dp2_s, dp2_s};
  const float4* const w_tr[3] = {w1_s, w2_s, wi2_s};

  float b2v[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b2v[g] = __ldg(b2 + g * hidden + j);
  float dh1_rec[RPT], dc1[RPT], dh2_rec[RPT], dc2[RPT], dh1_in[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    dh1_rec[r] = dc1[r] = dh2_rec[r] = dc2[r] = dh1_in[r] = 0.0f;
  }
  __syncthreads();

  for (int k = 0; k <= n_t; ++k) {
    const int t1 = n_t - k;
    const int t2 = t1 - 1;
    const bool run1 = k > 0;
    const bool run2 = k < n_t;
    float h1v[RPT], h2v[RPT], mv[RPT];
    load_h(h1s, t2, n_t, n_rows, hidden, row0, j, h1v);
    load_h(h2s, t2 - 1, n_t, n_rows, hidden, row0, j, h2v);
    if constexpr (HAS_MASK) {
      load_h(mask, t2, n_t, n_rows, hidden, row0, j, mv);
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r) mv[r] = 1.0f;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      hp1_s[(lrow0 + r) * kp + j] = h1v[r];
      hp2_s[(lrow0 + r) * kp + j] = h2v[r];
      if constexpr (HAS_MASK) hm_s[(lrow0 + r) * kp + j] = h1v[r] * mv[r];
    }
    float x1v[4][RPT], c1v[RPT], c1p[RPT], c2v[RPT], c2p[RPT], dh2v[RPT];
    load_x(x1, t1, n_t, n_rows, hidden, row0, j, x1v);
    load_h(c1s, t1, n_t, n_rows, hidden, row0, j, c1v);
    load_h(c1s, t1 - 1, n_t, n_rows, hidden, row0, j, c1p);
    load_h(c2s, t2, n_t, n_rows, hidden, row0, j, c2v);
    load_h(c2s, t2 - 1, n_t, n_rows, hidden, row0, j, c2p);
    load_h(dh2s, t2, n_t, n_rows, hidden, row0, j, dh2v);
    __syncthreads();  // the h planes hold this iteration's rows

    // Gates: layer 1 x1[t1] + h1[t1-1] @ w1; layer 2 (b2 + hm @ wi2) +
    // h2[t2-1] @ w2, summed in that order as the plain version does.
    float acc[3][4][RPT];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[0][g][r] = x1v[g][r];
        acc[1][g][r] = b2v[g];
        acc[2][g][r] = 0.0f;
      }
    gate_products<RPT, 3>(h_in, w_in, lrow0, hidden, j, acc);
    float gates2[4][RPT], dh1[RPT], dh2[RPT], d1[4][RPT], d2[4][RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) gates2[g][r] = acc[1][g][r] + acc[2][g][r];
      dh1[r] = dh1_in[r] + dh1_rec[r];
      dh2[r] = dh2v[r] + dh2_rec[r];
    }
    float dc1n[RPT], dc2n[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      dc1n[r] = dc1[r];
      dc2n[r] = dc2[r];
    }
    cell_backward(acc[0], c1v, c1p, dh1, dc1n, d1);
    cell_backward(gates2, c2v, c2p, dh2, dc2n, d2);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (run1) dc1[r] = dc1n[r];
      if (run2) dc2[r] = dc2n[r];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (!run1) d1[g][r] = 0.0f;
        if (!run2) d2[g][r] = 0.0f;
      }
    }
    store_d_pre(d1, run1, dx1, t1, n_rows, hidden, row0, lrow0, j, dp1_s);
    store_d_pre(d2, run2, dpre2, t2, n_rows, hidden, row0, lrow0, j, dp2_s);
    __syncthreads();  // dp1_s, dp2_s hold this iteration's d_pre rows

    // dh1[t1-1] from layer 1's own recurrence, dh2[t2-1] from layer 2's, and
    // the seam cotangent into h1[t2], masked as in the TPU kernel.
    float tr[3][RPT];
    transposed_products<RPT, 3>(dp_in, w_tr, lrow0, hidden, j, tr);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      dh1_rec[r] = tr[0][r];
      dh2_rec[r] = tr[1][r];
      dh1_in[r] = HAS_MASK ? mv[r] * tr[2][r] : tr[2][r];
    }
  }
}

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
  return static_cast<int>(with_rpt(n_rows, device, [&](auto rpt_c) {
    constexpr int kRpt = decltype(rpt_c)::value;
    if (mask != nullptr) {
      return launch(lstm_pair_bwd_kernel<kRpt, true>, n_rows, hidden, kRpt,
                    smem_bytes(hidden, kRpt, 3, 3, 2), stream, dh2s, x1, mask,
                    h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t, dx1, dpre2, n_t,
                    n_rows, hidden);
    }
    return launch(lstm_pair_bwd_kernel<kRpt, false>, n_rows, hidden, kRpt,
                  smem_bytes(hidden, kRpt, 3, 2, 2), stream, dh2s, x1, mask,
                  h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t, dx1, dpre2, n_t,
                  n_rows, hidden);
  }));
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
