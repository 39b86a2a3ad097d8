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
// The pair's sweep (lstm_pair_bwd.cuh) and the pass (lstm_wgrad.cuh) are
// templates over the storage type of their planes: this file builds their
// f32 instances (and their replica axis), lstm_bwd_bf16.cu their bf16 ones.
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

#include "lstm_pair_bwd.cuh"
#include "lstm_wgrad.cuh"

namespace {

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
  return pair_bwd(dh2s, x1, mask, h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t,
                  dx1, nullptr, dpre2, n_t, n_rows, hidden, replicas, tile,
                  device, stream);
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
  return wgrad(n_jobs, src, mask, dpre, out, bias_out, shift, part, splits,
               n_t, n_rows, hidden, replicas, device, stream);
}

}  // extern "C"
