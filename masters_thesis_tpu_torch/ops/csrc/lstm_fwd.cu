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
// Layout and helpers: lstm_common.cuh.
//
// What bounds them on this card. Each time step is a chain of small
// (rows, H) @ (H, 4H) products whose next step needs this step's h, so the
// work is a serial loop of T (or T+1) dependent steps; rows are independent.
// At the serving shape (T=60, 800 rows, H=64) the pair does ~4.7 GFLOP of f32
// products over ~61 MB of input and output, so f32 arithmetic (no TF32, to
// keep the JAX package's f32 numerics) bounds it, and the step chain bounds
// its latency.
//
// What the design does about it. A block owns a tile of rows and runs the
// whole time loop itself, so no state crosses blocks. Its weights are staged
// once into shared memory — three (64, 256) f32 weights are 192 KiB, which a
// block's 227 KB holds beside the state — re-laid so that one 16-byte load
// gives a thread the four gate weights (i, f, g, o) of its hidden unit j at
// one k. Thread (group, j) owns hidden unit j of kRowsPerThread rows: the
// gate math needs no exchange between threads, and each weight load feeds
// kRowsPerThread rows. h lives in shared memory (every thread of a row reads
// all of it), c and the layer-2 seam in registers, and the next step's
// x_proj (and mask) is loaded into registers while this step computes. The
// row tile (kGroups * kRowsPerThread rows) is the smallest of 2, 4 and 8
// rows that keeps the grid within one wave of the card's SMs: small batches
// spread over more SMs, large ones reuse each weight load over more rows.
// The ragged last tile is masked here (no padding of B to a multiple of 8 as
// on the TPU). Accurate expf/tanhf, no fast math.

#include "lstm_common.cuh"

namespace {

// Single layer. Replaces _fwd_kernel (masters_thesis_tpu/ops/lstm_kernel.py).
// cs may be null (the forward-only caller does not keep c).
// Shared memory: w_s [padded(H)][H] float4, then h_s [rows][padded(H)].
template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ hs, float* __restrict__ cs,
                int n_t, int n_rows, int hidden) {
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  float4* w_s = smem;
  float4* h_s4 = w_s + kp * hidden;
  float* h_s = reinterpret_cast<float*>(h_s4);
  stage_weight(w, w_s, hidden);
  for (int idx = threadIdx.x; idx < kGroups * RPT * kp; idx += blockDim.x) {
    h_s[idx] = 0.0f;
  }
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = blockIdx.x * kGroups * RPT + lrow0;
  const float4* const h_in[1] = {h_s4};
  const float4* const w_in[1] = {w_s};

  float c[RPT], x_next[4][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = 0.0f;
  load_x(x, 0, n_t, n_rows, hidden, row0, j, x_next);
  __syncthreads();

  for (int t = 0; t < n_t; ++t) {
    float acc[1][4][RPT];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[0][g][r] = x_next[g][r];
    load_x(x, t + 1, n_t, n_rows, hidden, row0, j, x_next);
    gate_products<RPT, 1>(h_in, w_in, lrow0, hidden, j, acc);
    float h[RPT];
    cell_update(acc[0], c, h);
    __syncthreads();  // every thread has finished reading h_s for step t
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      h_s[(lrow0 + r) * kp + j] = h[r];
      const int row = row0 + r;
      if (row < n_rows) {
        const size_t out = (static_cast<size_t>(t) * n_rows + row) * hidden + j;
        hs[out] = h[r];
        if (cs != nullptr) cs[out] = c[r];
      }
    }
    __syncthreads();  // h_s holds step t for every row of the tile
  }
}

// Two-layer wavefront. Replaces _pair_fwd_kernel
// (masters_thesis_tpu/ops/lstm_kernel.py).
// Iteration s runs layer 2 at step s-1 (reading the seam made from h1[s-1])
// and layer 1 at step s, then makes the seam b2 + (m ⊙ h1)[s] @ wi2 for the
// next iteration — the same order as the TPU kernel, so layer 2 reads the
// seam before layer 1 replaces it. Both layers' products share one loop.
// HAS_MASK: mask (T, B, H) multiplies h1 at the seam only (h1s and the
// layer-1 recurrence keep the unmasked h1). STASH: h1s, c1s, c2s are written.
// Shared memory: w1_s, w2_s, wi2_s [padded(H)][H] float4 each, then
// h1_s, h2_s (and hm_s, the masked h1, with HAS_MASK) [rows][padded(H)].
template <int RPT, bool HAS_MASK, bool STASH>
__global__ void __launch_bounds__(kMaxThreads)
lstm_pair_fwd_kernel(const float* __restrict__ x1, const float* __restrict__ mask,
                     const float* __restrict__ w1, const float* __restrict__ wi2,
                     const float* __restrict__ b2, const float* __restrict__ w2,
                     float* __restrict__ h2s, float* __restrict__ h1s,
                     float* __restrict__ c1s, float* __restrict__ c2s,
                     int n_t, int n_rows, int hidden) {
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  float4* w1_s = smem;
  float4* w2_s = w1_s + kp * hidden;
  float4* wi2_s = w2_s + kp * hidden;
  float4* h1_s4 = wi2_s + kp * hidden;
  float4* h2_s4 = h1_s4 + rows * kp / 4;
  float4* hm_s4 = h2_s4 + rows * kp / 4;  // used with HAS_MASK only
  float* h1_s = reinterpret_cast<float*>(h1_s4);
  float* h2_s = reinterpret_cast<float*>(h2_s4);
  float* hm_s = reinterpret_cast<float*>(hm_s4);
  stage_weight(w1, w1_s, hidden);
  stage_weight(w2, w2_s, hidden);
  stage_weight(wi2, wi2_s, hidden);
  for (int idx = threadIdx.x; idx < (HAS_MASK ? 3 : 2) * rows * kp;
       idx += blockDim.x) {
    h1_s[idx] = 0.0f;  // h1_s, h2_s (and hm_s)
  }
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = blockIdx.x * rows + lrow0;
  const float4* const h_both[2] = {h1_s4, h2_s4};
  const float4* const w_both[2] = {w1_s, w2_s};
  const float4* const h_seam[1] = {HAS_MASK ? hm_s4 : h1_s4};
  const float4* const w_seam[1] = {wi2_s};

  float c1[RPT], c2[RPT], seam[1][4][RPT], x_next[4][RPT], m_next[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    c1[r] = 0.0f;
    c2[r] = 0.0f;
    m_next[r] = 1.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) seam[0][g][r] = 0.0f;
  }
  load_x(x1, 0, n_t, n_rows, hidden, row0, j, x_next);
  if constexpr (HAS_MASK) load_h(mask, 0, n_t, n_rows, hidden, row0, j, m_next);
  __syncthreads();

  for (int s = 0; s <= n_t; ++s) {
    const bool run1 = s < n_t;  // layer 1 at step s
    const bool run2 = s > 0;    // layer 2 at step s-1
    float acc[2][4][RPT], m[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      m[r] = m_next[r];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[0][g][r] = x_next[g][r];
        acc[1][g][r] = seam[0][g][r];
      }
    }
    load_x(x1, s + 1, n_t, n_rows, hidden, row0, j, x_next);
    if constexpr (HAS_MASK) {
      load_h(mask, s + 1, n_t, n_rows, hidden, row0, j, m_next);
    }
    // The step that is not run this iteration (layer 2 at s=0, layer 1 at
    // s=n_t) is computed on zeros and discarded: uniform control flow.
    gate_products<RPT, 2>(h_both, w_both, lrow0, hidden, j, acc);
    float h1[RPT], h2[RPT], c1n[RPT], c2n[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      c1n[r] = c1[r];
      c2n[r] = c2[r];
    }
    cell_update(acc[0], c1n, h1);
    cell_update(acc[1], c2n, h2);
    __syncthreads();  // every thread has finished reading h1_s and h2_s
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r;
      if (run1) {
        c1[r] = c1n[r];
        h1_s[(lrow0 + r) * kp + j] = h1[r];
        if constexpr (HAS_MASK) hm_s[(lrow0 + r) * kp + j] = h1[r] * m[r];
        if constexpr (STASH) {
          if (row < n_rows) {
            const size_t out = (static_cast<size_t>(s) * n_rows + row) * hidden + j;
            h1s[out] = h1[r];
            c1s[out] = c1[r];
          }
        }
      }
      if (run2) {
        c2[r] = c2n[r];
        h2_s[(lrow0 + r) * kp + j] = h2[r];
        if (row < n_rows) {
          const size_t out = (static_cast<size_t>(s - 1) * n_rows + row) * hidden + j;
          h2s[out] = h2[r];
          if constexpr (STASH) c2s[out] = c2[r];
        }
      }
    }
    __syncthreads();  // h1_s (hm_s) holds h1[s] for every row of the tile
    if (run1) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float bias = __ldg(b2 + g * hidden + j);
#pragma unroll
        for (int r = 0; r < RPT; ++r) seam[0][g][r] = bias;
      }
      gate_products<RPT, 1>(h_seam, w_seam, lrow0, hidden, j, seam);
    }
  }
}

template <bool HAS_MASK, bool STASH>
cudaError_t launch_pair(const float* x1, const float* mask, const float* w1,
                        const float* wi2, const float* b2, const float* w2,
                        float* h2s, float* h1s, float* c1s, float* c2s,
                        int n_t, int n_rows, int hidden, int device,
                        cudaStream_t stream) {
  return with_rpt(n_rows, device, [&](auto rpt_c) {
    constexpr int kRpt = decltype(rpt_c)::value;
    const size_t smem = smem_bytes(hidden, kRpt, 3, HAS_MASK ? 3 : 2);
    return launch(lstm_pair_fwd_kernel<kRpt, HAS_MASK, STASH>, n_rows, hidden,
                  kRpt, smem, stream, x1, mask, w1, wi2, b2, w2, h2s, h1s, c1s,
                  c2s, n_t, n_rows, hidden);
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
  return static_cast<int>(with_rpt(n_rows, device, [&](auto rpt_c) {
    constexpr int kRpt = decltype(rpt_c)::value;
    return launch(lstm_fwd_kernel<kRpt>, n_rows, hidden, kRpt,
                  smem_bytes(hidden, kRpt, 1, 1), stream, x, w_t, hs, cs, n_t,
                  n_rows, hidden);
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
