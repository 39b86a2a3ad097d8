// The layer pair's forward kernel, lstm_pair_fwd_kernel, and its launch
// (pair_fwd), over a storage type T: float, instantiated with its replica
// axis in lstm_fwd.cu, and bf16 (trainer.precision=bf16-mixed), solo only,
// in lstm_fwd_bf16.cu, so that the two build side by side. Its design is
// lstm_fwd.cu's (the top of that file).

#pragma once

#include "lstm_fwd_step.cuh"

namespace {

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
// The replica axis (the counterpart of vmap over the TPU kernel): block
// (tile, r) runs replica r, whose operands are the r-th of R stacked ones,
// x1 (R, T, B, 4H), mask and the planes (R, T, B, H), the weights
// (R, H, 4H) and b2 (R, 4H); it reads and writes only its own slices, and
// runs the same instructions on them as a solo launch. STACKED compiles
// the offsets in; a solo launch (R = 1) takes the instance without them,
// so its code is the kernel's before the axis (the offsets kept 14
// pointers in registers and cost up to 6% at 800 rows on an H100).
// Shared memory (p = sweep_pad(H)): w1_s (8 rows only), wi2_s, w2_s
// [p][p + 1] float4, then two buffers of the h1, h2 (and, with HAS_MASK, hm)
// planes [ROWS][p + 16] floats.
// T is the storage type of every operand and output: float, or bf16 (the
// JAX kernel's bf16 compute dtype). With bf16 each operand is converted to
// f32 where it is loaded (the weights once, into shared memory or
// registers), h and c are carried in f32, the seam is formed from the f32
// h1, and only the stores to h2s and the stashes round: the TPU kernel's
// f32 scratch and rounded stores.
template <int ROWS, bool HAS_MASK, bool STASH, bool STACKED, typename T>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_pair_fwd_kernel(const T* __restrict__ x1, const T* __restrict__ mask,
                     const T* __restrict__ w1, const T* __restrict__ wi2,
                     const T* __restrict__ b2, const T* __restrict__ w2,
                     T* __restrict__ h2s, T* __restrict__ h1s,
                     T* __restrict__ c1s, T* __restrict__ c2s,
                     int n_t, int n_rows, int hidden) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  constexpr bool kStaged = pair_staged_weights(ROWS) == 3;  // w1 too
  if constexpr (STACKED) {
    const size_t rep = blockIdx.y;
    const size_t plane = static_cast<size_t>(n_t) * n_rows * hidden;
    const size_t weight = static_cast<size_t>(hidden) * 4 * hidden;
    x1 += rep * 4 * plane;
    if constexpr (HAS_MASK) mask += rep * plane;
    w1 += rep * weight;
    wi2 += rep * weight;
    w2 += rep * weight;
    b2 += rep * 4 * hidden;
    h2s += rep * plane;
    if constexpr (STASH) {
      h1s += rep * plane;
      c1s += rep * plane;
      c2s += rep * plane;
    }
  }
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
    b2v[g] = ln.j < hidden ? load_f32(b2 + g * hidden + ln.j) : 0.0f;
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

// The f32 pair has a replica axis (STACKED instances); the bf16 pair runs
// solo launches only (R = 1), the instances without the offsets.
template <typename T, bool HAS_MASK, bool STASH>
cudaError_t launch_pair(const T* x1, const T* mask, const T* w1, const T* wi2,
                        const T* b2, const T* w2, T* h2s, T* h1s, T* c1s,
                        T* c2s, int n_t, int n_rows, int hidden, int replicas,
                        int tile, int device, cudaStream_t stream) {
  return with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    const size_t smem = pair_staged_weights(kRows) * padded_weight_bytes(hidden) +
                        fwd_planes_bytes(hidden, kRows, HAS_MASK ? 3 : 2);
    auto kernel = lstm_pair_fwd_kernel<kRows, HAS_MASK, STASH, false, T>;
    if constexpr (std::is_same_v<T, float>) {
      if (replicas > 1) kernel = lstm_pair_fwd_kernel<kRows, HAS_MASK, STASH, true, T>;
    }
    return launch_sweep(kernel, n_rows, kRows, replicas, smem, stream, x1, mask,
                        w1, wi2, b2, w2, h2s, h1s, c1s, c2s, n_t, n_rows, hidden);
  }, replicas, tile);
}

// The pair forward's entry: the instance for the mask and the stash.
template <typename T>
int pair_fwd(const T* x1, const T* mask, const T* w1_t, const T* wi2_t,
             const T* b2, const T* w2_t, T* h2s, T* h1s, T* c1s, T* c2s,
             int n_t, int n_rows, int hidden, int replicas, int tile,
             int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden) || replicas < 1 ||
      (!std::is_same_v<T, float> && replicas != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool stash = h1s != nullptr;
  if (stash != (c1s != nullptr) || stash != (c2s != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = [&](auto has_mask, auto write_stash) {
    return launch_pair<T, decltype(has_mask)::value, decltype(write_stash)::value>(
        x1, mask, w1_t, wi2_t, b2, w2_t, h2s, h1s, c1s, c2s, n_t, n_rows,
        hidden, replicas, tile, device, stream);
  };
  using yes = std::true_type;
  using no = std::false_type;
  cudaError_t err;
  if (mask != nullptr) {
    err = stash ? launch(yes{}, yes{}) : launch(yes{}, no{});
  } else {
    err = stash ? launch(no{}, yes{}) : launch(no{}, no{});
  }
  return static_cast<int>(err);
}

}  // namespace
