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
// Layout and helpers: lstm_fwd_step.cuh and lstm_sweep.cuh.
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

#include "lstm_fwd_step.cuh"

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
// in the barriers. Shared memory: two buffers of one h plane [ROWS][p + 16]
// floats.
template <int ROWS>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ hs, float* __restrict__ cs,
                int n_t, int n_rows, int hidden) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
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

// Weights a pair block stages in shared memory: wi2 and w2, and w1 as well
// at 8 rows, where a lane's 64 accumulators leave no room for w1 in
// registers (ptxas spills); below 8 rows w1 sits in registers
// (load_quarter_weight). The sums are taken in the same order either way.
__host__ __device__ constexpr int pair_staged_weights(int rows) {
  return rows == kSweepMaxRows ? 3 : 2;
}

// Two-layer wavefront. Replaces _pair_fwd_kernel
// (masters_thesis_tpu/ops/lstm_kernel.py).
// Iteration s runs layer 1 at step s and layer 2 at step s-1, the TPU
// kernel's order. Layer 1's gates are x1[s] + h1[s-1] @ w1, layer 2's
// b2 + hm[s-1] @ wi2 + h2[s-2] @ w2 (hm = m ⊙ h1 with HAS_MASK, else h1):
// all three products read planes the previous iteration wrote, so they run
// in one pass of the forward step (lstm_fwd_step.cuh), wi2's and w2's
// products adding into layer 2's sums. The step that is not run (layer 2 at
// s = 0, layer 1 at s = n_t) is computed and discarded: uniform control
// flow; h2[-1] is written as zero. HAS_MASK: mask (T, B, H) multiplies h1
// at the seam only (h1s and the layer-1 recurrence keep the unmasked h1).
// STASH: h1s, c1s, c2s are written. Each lane's x1 (and mask) of the next
// iteration is loaded during this one (FwdLane: clamped, branch-free
// reads). Warps with 8 w >= p only take part in the barriers.
// Shared memory (p = sweep_pad(H)): w1_s (8 rows only), wi2_s, w2_s
// [p][p + 1] float4, then two buffers of the h1, h2 (and, with HAS_MASK, hm)
// planes [ROWS][p + 16] floats.
template <int ROWS, bool HAS_MASK, bool STASH>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_pair_fwd_kernel(const float* __restrict__ x1, const float* __restrict__ mask,
                     const float* __restrict__ w1, const float* __restrict__ wi2,
                     const float* __restrict__ b2, const float* __restrict__ w2,
                     float* __restrict__ h2s, float* __restrict__ h1s,
                     float* __restrict__ c1s, float* __restrict__ c2s,
                     int n_t, int n_rows, int hidden) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  constexpr bool kStaged = pair_staged_weights(ROWS) == 3;  // w1 too
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  float4* w1_s = smem;  // with kStaged only
  float4* wi2_s = w1_s + (kStaged ? p * (p + 1) : 0);
  float4* w2_s = wi2_s + p * (p + 1);
  const FwdPlanes pl = fwd_planes(w2_s + p * (p + 1), p, ROWS, HAS_MASK ? 3 : 2);
  if constexpr (kStaged) stage_weight_padded(w1, w1_s, hidden, p);
  stage_weight_padded(wi2, wi2_s, hidden, p);
  stage_weight_padded(w2, w2_s, hidden, p);
  pl.zero();
  const FwdLane<ROWS> ln(n_rows, hidden, kq, blockIdx.x * ROWS);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp
  float wr1[kStaged ? 1 : kMaxHidden / 4][4];
  if constexpr (!kStaged) load_quarter_weight(w1, hidden, kq, ln.q, ln.j, wr1);

  float b2v[4], c1[NR], c2[NR], xn[4][NR], mn[NR];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    b2v[g] = ln.j < hidden ? __ldg(b2 + g * hidden + ln.j) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    c1[i] = 0.0f;
    c2[i] = 0.0f;
    mn[i] = 1.0f;
  }
  ln.load_x(x1, 0, n_t, n_rows, hidden, xn);
  if constexpr (HAS_MASK) ln.load_h(mask, 0, n_t, n_rows, hidden, mn);
  __syncthreads();  // the weights are staged, the first buffer is zero

  for (int s = 0; s <= n_t; ++s) {
    const bool run1 = s < n_t;  // layer 1 at step s
    const bool run2 = s > 0;    // layer 2 at step s-1
    float add[2][4][NR], m[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      m[i] = mn[i];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        add[0][g][i] = xn[g][i];
        add[1][g][i] = b2v[g];
      }
    }
    ln.load_x(x1, s + 1, n_t, n_rows, hidden, xn);
    if constexpr (HAS_MASK) ln.load_h(mask, s + 1, n_t, n_rows, hidden, mn);
    if (active) {
      const float* h1_s = pl.at(s, 0);
      const float* hm_s = HAS_MASK ? pl.at(s, 2) : h1_s;
      float acc[ROWS][8];
      if constexpr (kStaged) {
        const float* const h_in[3] = {h1_s, hm_s, pl.at(s, 1)};
        const float4* const w_in[3] = {w1_s, wi2_s, w2_s};
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[r][n] = 0.0f;
        quarter_gate_products<ROWS, 3, 2>(h_in, w_in, kq, 4 * kq + 16, ln.q, ln.j, acc);
      } else {
        const float* const h_in[2] = {hm_s, pl.at(s, 1)};
        const float4* const w_in[2] = {wi2_s, w2_s};
        float acc1[ROWS][4], acc2[ROWS][4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc1[r][g] = acc2[r][g] = 0.0f;
        register_gate_product<ROWS>(h1_s, wr1, kq, ln.q, acc1);
        quarter_gate_products<ROWS, 2, 1>(h_in, w_in, kq, 4 * kq + 16, ln.q, ln.j, acc2);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[r][g] = acc1[r][g];
            acc[r][4 + g] = acc2[r][g];
          }
      }
      float gates[2][4][NR], h1[NR], h2[NR], c1n[NR], c2n[NR], hm[NR];
      quarter_gates<ROWS, 2>(acc, ln.q, add, gates);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        c1n[i] = c1[i];
        c2n[i] = c2[i];
      }
      cell_update(gates[0], c1n, h1);
      cell_update(gates[1], c2n, h2);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (run1) c1[i] = c1n[i];
        if (run2) {
          c2[i] = c2n[i];
        } else {
          h2[i] = 0.0f;  // h2[-1], which layer 2 reads at s = 1
        }
        hm[i] = h1[i] * m[i];
      }
      ln.stage(h1, pl.at(s + 1, 0), kq);
      ln.stage(h2, pl.at(s + 1, 1), kq);
      if constexpr (HAS_MASK) ln.stage(hm, pl.at(s + 1, 2), kq);
      if (run1 && STASH) {
        ln.store(h1, h1s, s, n_rows, hidden);
        ln.store(c1, c1s, s, n_rows, hidden);
      }
      if (run2) {
        ln.store(h2, h2s, s - 1, n_rows, hidden);
        if constexpr (STASH) ln.store(c2, c2s, s - 1, n_rows, hidden);
      }
    }
    __syncthreads();  // the next buffer holds h1[s], h2[s-1] (and hm[s])
  }
}

template <bool HAS_MASK, bool STASH>
cudaError_t launch_pair(const float* x1, const float* mask, const float* w1,
                        const float* wi2, const float* b2, const float* w2,
                        float* h2s, float* h1s, float* c1s, float* c2s,
                        int n_t, int n_rows, int hidden, int device,
                        cudaStream_t stream) {
  return with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    const size_t smem = pair_staged_weights(kRows) * padded_weight_bytes(hidden) +
                        fwd_planes_bytes(hidden, kRows, HAS_MASK ? 3 : 2);
    return launch_sweep(lstm_pair_fwd_kernel<kRows, HAS_MASK, STASH>, n_rows,
                        kRows, smem, stream, x1, mask, w1, wi2, b2, w2, h2s,
                        h1s, c1s, c2s, n_t, n_rows, hidden);
  });
}

}  // namespace

extern "C" {

int lstm_max_hidden() { return kMaxHidden; }

const char* lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry point takes the CUDA device index of its pointers and stream:
// this library links its own CUDA runtime, whose current device is set here.

// hs (T, B, H) and optional cs (T, B, H) from x (T, B, 4H), w_t (H, 4H).
int lstm_fwd(const float* x, const float* w_t, float* hs, float* cs, int n_t,
             int n_rows, int hidden, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    return launch_sweep(lstm_fwd_kernel<kRows>, n_rows, kRows,
                        fwd_planes_bytes(hidden, kRows, 1), stream, x, w_t, hs,
                        cs, n_t, n_rows, hidden);
  }));
}

// h2s (T, B, H) from x1 (T, B, 4H), the optional mask (T, B, H), w1_t, wi2_t,
// w2_t (H, 4H) and b2 (4H). h1s, c1s, c2s (T, B, H) are all null (no stash)
// or all set.
int lstm_pair_fwd(const float* x1, const float* mask, const float* w1_t,
                  const float* wi2_t, const float* b2, const float* w2_t,
                  float* h2s, float* h1s, float* c1s, float* c2s, int n_t,
                  int n_rows, int hidden, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  const bool stash = h1s != nullptr;
  if (stash != (c1s != nullptr) || stash != (c2s != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (mask != nullptr) {
    err = stash ? launch_pair<true, true>(x1, mask, w1_t, wi2_t, b2, w2_t, h2s,
                                          h1s, c1s, c2s, n_t, n_rows, hidden,
                                          device, stream)
                : launch_pair<true, false>(x1, mask, w1_t, wi2_t, b2, w2_t, h2s,
                                           h1s, c1s, c2s, n_t, n_rows, hidden,
                                           device, stream);
  } else {
    err = stash ? launch_pair<false, true>(x1, mask, w1_t, wi2_t, b2, w2_t, h2s,
                                           h1s, c1s, c2s, n_t, n_rows, hidden,
                                           device, stream)
                : launch_pair<false, false>(x1, mask, w1_t, wi2_t, b2, w2_t, h2s,
                                            h1s, c1s, c2s, n_t, n_rows, hidden,
                                            device, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
