// Forward LSTM recurrences for Hopper (sm_90a), with a plain C interface.
//
// Two kernels, each the CUDA counterpart of a Pallas TPU kernel in
// masters_thesis_tpu/ops/lstm_kernel.py:
//
//   lstm_pair_fwd_kernel  replaces _pair_fwd_kernel, the two-layer wavefront.
//                         Templated on <has_mask, write_stash>: the maskless,
//                         stash-free instance serves model=small; training
//                         runs the masked one (a pre-scaled dropout plane
//                         applied to h1 at the seam) that also writes the
//                         h1s/c1s/c2s stashes the backward recomputes from;
//   lstm_fwd_kernel       replaces _fwd_kernel, the single-layer recurrence
//                         (odd layer counts); its optional cs output is the
//                         single-layer backward's stash.
//
// Layout and helpers: lstm_fwd_step.cuh and lstm_sweep.cuh. The pair's
// kernel is a template over its storage type in lstm_pair_fwd.cuh: this
// file builds its f32 instances (and their replica axis), lstm_fwd_bf16.cu
// its bf16 ones.
//
// What bounds them on this card. Each time step is a chain of small
// (rows, H) @ (H, 4H) products whose next step needs this step's h, so the
// work is a serial loop of T (or T+1) dependent steps; rows are independent.
// At the serving shape (T=60, 800 rows, H=64) the pair does ~4.7 GFLOP of f32
// products over ~61 MB of input and output, so f32 arithmetic (no TF32, to
// keep the JAX package's f32 numerics) bounds it, and the step chain bounds
// its latency: every operand of a step sits in shared memory, which serves
// one 128-byte wavefront a clock, so what a step reads there sets its time.
//
// What the design does about it. A block owns a tile of rows and runs the
// whole time loop itself, so no state crosses blocks. Its weights are staged
// once into shared memory, re-laid so that one 16-byte load gives a thread
// the four gate weights (i, f, g, o) of its hidden unit j at one k.
//
// The pair runs the forward step of lstm_fwd_step.cuh: 256 threads a tile of
// 1, 2, 4 or 8 rows (the fewest that keep the grid in one wave of SMs), lane
// u + 8 q of warp w serving unit j = 8 w + u and quarter q of the
// contraction for all the tile's rows. Layer 1's product and layer 2's two
// (its seam input and its recurrence) all read h planes that the previous
// iteration wrote, so they share one pass and one barrier; the planes are
// double buffered, so that barrier is the step's only one. wi2 and w2 are
// staged, each float4 read by one lane a product and step; w1 sits in the
// lanes' registers (64 floats a lane) below 8 rows and is staged at 8 rows,
// where the accumulators need the registers: 1,024 or 1,536 weight
// wavefronts a block and step at H = 64 whatever the rows, where the first
// design (two row groups of 64 threads, each reading every weight, two
// barriers a step, the seam product a serial phase of its own) read 3,072.
// Three padded (64, 256) f32 weights are 199,680 bytes, the two buffers of
// three 8-row planes 15,360, within a block's 227 KB.
//
// The single layer runs the time-blocked forward's step (lstm_tb.cu) on the
// same tile, so its h and c are bit-equal to that kernel's: the weight in
// the lanes' registers, so a step reads no weight from shared memory, h
// double buffered, one barrier a step, the next step's x loaded into
// registers during this one. Its first design gave each of two row groups
// of 64 threads every staged weight float4 (1,024 wavefronts a block and
// step at H = 64) and two barriers a step, on tiles of 2, 4 or 8 rows, and
// summed in another order than the time-blocked forward. The ragged last
// tile is masked here (no padding of B to a multiple of 8 as on the TPU).
// Accurate expf/tanhf, no fast math.

#include "lstm_pair_fwd.cuh"

namespace {

// Single layer. Replaces _fwd_kernel (masters_thesis_tpu/ops/lstm_kernel.py).
// cs may be null (the forward-only caller does not keep c). Step t is
// lstm_tb_fwd_kernel's (lstm_tb.cu) on the same tile (sweep_rows): gates
// x[t] + h[t-1] @ w, the weight in the lanes' registers
// (load_quarter_weight), h read from the plane buffer t & 1 and written
// into the other, c in registers, one barrier a step, the sums taken in the
// same order, so h and c are bit-equal to that kernel's. Only x differs: a
// lane reads its rows' x[t+1] from device memory into registers during step
// t (FwdLane::load_x, clamped, branch-free), where the time-blocked kernel
// copies chunks of x into shared memory. Warps with 8 w >= p only take part
// in the barriers. The replica axis, as in the pair's forward: block
// (tile, r) runs replica r of R stacked ones, x (R, T, B, 4H), w (R, H, 4H),
// hs and cs (R, T, B, H); STACKED compiles the offsets in, and a solo launch
// takes the instance without them. Shared memory: two buffers of one h
// plane [ROWS][p + 16] floats.
template <int ROWS, bool STACKED>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ hs, float* __restrict__ cs,
                int n_t, int n_rows, int hidden) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  if constexpr (STACKED) {
    const size_t rep = blockIdx.y;
    const size_t plane = static_cast<size_t>(n_t) * n_rows * hidden;
    x += rep * 4 * plane;
    w += rep * hidden * 4 * hidden;
    hs += rep * plane;
    if (cs != nullptr) cs += rep * plane;
  }
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  const FwdPlanes pl = fwd_planes(smem, p, ROWS, 1);
  pl.zero();
  const FwdLane<ROWS> ln(n_rows, hidden, kq, blockIdx.x * ROWS);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp
  float wr[kMaxHidden / 4][4];
  load_quarter_weight(w, hidden, kq, ln.q, ln.j, wr);

  float c[NR], xn[4][NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) c[i] = 0.0f;
  ln.load_x(x, 0, n_t, n_rows, hidden, xn);
  __syncthreads();  // both h buffers are zero

  for (int t = 0; t < n_t; ++t) {
    float add[1][4][NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) add[0][g][i] = xn[g][i];
    ln.load_x(x, t + 1, n_t, n_rows, hidden, xn);
    if (active) {
      float acc[ROWS][4], gates[1][4][NR], h[NR];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      register_gate_product<ROWS>(pl.at(t, 0), wr, kq, ln.q, acc);
      quarter_gates<ROWS, 1>(acc, ln.q, add, gates);
      cell_update(gates[0], c, h);
      ln.stage(h, pl.at(t + 1, 0), kq);
      ln.store(h, hs, t, n_rows, hidden);
      if (cs != nullptr) ln.store(c, cs, t, n_rows, hidden);
    }
    __syncthreads();  // the next buffer holds h[t] for every row of the tile
  }
}

}  // namespace

extern "C" {

int lstm_max_hidden() { return kMaxHidden; }

const char* lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry point takes the CUDA device index of its pointers and stream:
// this library links its own CUDA runtime, whose current device is set here.

// hs (R, T, B, H) and optional cs (R, T, B, H) from x (R, T, B, 4H), w_t
// (R, H, 4H): R replicas in one launch (R = 1: one layer). tile 0 takes the
// row tile from all R replicas' rows within the solo tile's summation class
// (sweep_rows, the pair's rule); 1, 2, 4 or 8 names it.
int lstm_fwd(const float* x, const float* w_t, float* hs, float* cs, int n_t,
             int n_rows, int hidden, int replicas, int tile, int device,
             cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden) || replicas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    const auto kernel = replicas > 1 ? lstm_fwd_kernel<kRows, true>
                                     : lstm_fwd_kernel<kRows, false>;
    return launch_sweep(kernel, n_rows, kRows, replicas,
                        fwd_planes_bytes(hidden, kRows, 1), stream, x, w_t, hs,
                        cs, n_t, n_rows, hidden);
  }, replicas, tile));
}

// h2s (R, T, B, H) from x1 (R, T, B, 4H), the optional mask (R, T, B, H),
// w1_t, wi2_t, w2_t (R, H, 4H) and b2 (R, 4H): R replicas in one launch
// (R = 1: one pair). h1s, c1s, c2s (R, T, B, H) are all null (no stash) or
// all set. tile 0 takes the row tile from all R replicas' rows within the
// solo tile's summation class (sweep_rows); 1, 2, 4 or 8 names it.
int lstm_pair_fwd(const float* x1, const float* mask, const float* w1_t,
                  const float* wi2_t, const float* b2, const float* w2_t,
                  float* h2s, float* h1s, float* c1s, float* c2s, int n_t,
                  int n_rows, int hidden, int replicas, int tile, int device,
                  cudaStream_t stream) {
  return pair_fwd(x1, mask, w1_t, wi2_t, b2, w2_t, h2s, h1s, c1s, c2s, n_t,
                  n_rows, hidden, replicas, tile, device, stream);
}

// The row tile a pair or single-layer launch (forward or sweep) of R
// replicas of n_rows rows takes (tile 0): what chip_smoke.py and the tests
// report beside the times.
int lstm_sweep_tile(int n_rows, int replicas, int device, int* rows) {
  if (n_rows < 1 || replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sweep_rows(n_rows, device, rows, replicas));
}

}  // extern "C"
