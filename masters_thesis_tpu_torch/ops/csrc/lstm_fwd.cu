// Forward LSTM recurrences for Hopper (sm_90a), with a plain C interface.
//
// Two kernels, each the CUDA counterpart of a Pallas TPU kernel in
// masters_thesis_tpu/ops/lstm_kernel.py:
//
//   lstm_pair_fwd_kernel  replaces _pair_fwd_kernel (maskless variant), the
//                         two-layer wavefront that serves model=small;
//   lstm_fwd_kernel       replaces _fwd_kernel, the single-layer recurrence
//                         (odd layer counts).
//
// Layout is the JAX functions' own: time-major x_proj (T, B, 4H) holding the
// input projection plus both biases, gate order i, f, g, o, and transposed
// weights w_t (H, 4H) so that gates = x_proj[t] + h @ w_t. Everything is f32.
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
// x_proj is loaded into registers while this step computes. The row tile
// (kGroups * kRowsPerThread rows) is the smallest of 2, 4 and 8 rows that
// keeps the grid within one wave of the card's SMs: small batches spread over
// more SMs, large ones reuse each weight load over more rows. The ragged
// last tile is masked here (no padding of B to a multiple of 8 as on the
// TPU). Accurate expf/tanhf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 64;
constexpr int kGroups = 2;  // row groups a block; blockDim = kGroups * H
constexpr int kMaxThreads = kGroups * kMaxHidden;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// k padded to a multiple of 4 (zero weights and zero h beyond H), so h rows
// are read 4 k at a time.
__host__ __device__ __forceinline__ int padded(int hidden) {
  return (hidden + 3) & ~3;
}

// w (H, 4H) row-major in device memory -> w_s[k * H + j] = the four gate
// weights of unit j at k, for k < padded(H). Runs once per block; the loop
// is unrolled so that many loads are in flight at once.
__device__ void stage_weight(const float* __restrict__ w, float4* w_s,
                             int hidden) {
  const int four_h = 4 * hidden;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < padded(hidden) * hidden; idx += blockDim.x) {
    const int k = idx / hidden;
    const int j = idx - k * hidden;
    const float* src = w + k * four_h + j;
    w_s[idx] = k < hidden
                   ? make_float4(__ldg(src), __ldg(src + hidden),
                                 __ldg(src + 2 * hidden), __ldg(src + 3 * hidden))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// xv[g][r] = x[t][row0 + r][g*H + j], zero past the last step or row.
template <int RPT>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int t,
                                       int n_t, int n_rows, int hidden,
                                       int row0, int j, float (&xv)[4][RPT]) {
  const int four_h = 4 * hidden;
  const float* xt = x + static_cast<size_t>(t < n_t ? t : 0) * n_rows * four_h;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r;
    const bool in = t < n_t && row < n_rows;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      xv[g][r] = in ? __ldg(xt + static_cast<size_t>(row) * four_h + g * hidden + j)
                    : 0.0f;
    }
  }
}

// acc[l][g][r] += sum_k h_s[l][row r][k] * w_s[l][k][j].g for L layers at
// once (independent products share the loop for more parallel work).
template <int RPT, int L>
__device__ __forceinline__ void gate_products(const float4* const (&h_s)[L],
                                              const float4* const (&w_s)[L],
                                              int lrow0, int hidden, int j,
                                              float (&acc)[L][4][RPT]) {
  const int kq = padded(hidden) / 4;
  for (int kk = 0; kk < kq; ++kk) {
    float4 h4[L][RPT];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int r = 0; r < RPT; ++r) h4[l][r] = h_s[l][(lrow0 + r) * kq + kk];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float4 w = w_s[l][(kk * 4 + q) * hidden + j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float h = lane(h4[l][r], q);
          acc[l][0][r] = fmaf(h, w.x, acc[l][0][r]);
          acc[l][1][r] = fmaf(h, w.y, acc[l][1][r]);
          acc[l][2][r] = fmaf(h, w.z, acc[l][2][r]);
          acc[l][3][r] = fmaf(h, w.w, acc[l][3][r]);
        }
      }
    }
  }
}

// One LSTM cell step per row from its gate pre-activations; c updated in place.
template <int RPT>
__device__ __forceinline__ void cell_update(const float (&acc)[4][RPT],
                                            float (&c)[RPT], float (&h)[RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float i = sigmoid(acc[0][r]);
    const float f = sigmoid(acc[1][r]);
    const float g = tanhf(acc[2][r]);
    const float o = sigmoid(acc[3][r]);
    c[r] = f * c[r] + i * g;
    h[r] = o * tanhf(c[r]);
  }
}

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

// Two-layer wavefront, maskless. Replaces _pair_fwd_kernel
// (masters_thesis_tpu/ops/lstm_kernel.py) for deterministic calls.
// Iteration s runs layer 2 at step s-1 (reading the seam made from h1[s-1])
// and layer 1 at step s, then makes the seam b2 + h1[s] @ wi2 for the next
// iteration — the same order as the TPU kernel, so layer 2 reads the seam
// before layer 1 replaces it. Both layers' products share one loop.
// Shared memory: w1_s, w2_s, wi2_s [padded(H)][H] float4 each, then
// h1_s and h2_s [rows][padded(H)].
template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
lstm_pair_fwd_kernel(const float* __restrict__ x1, const float* __restrict__ w1,
                     const float* __restrict__ wi2, const float* __restrict__ b2,
                     const float* __restrict__ w2, float* __restrict__ h2s,
                     int n_t, int n_rows, int hidden) {
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  float4* w1_s = smem;
  float4* w2_s = w1_s + kp * hidden;
  float4* wi2_s = w2_s + kp * hidden;
  float4* h1_s4 = wi2_s + kp * hidden;
  float4* h2_s4 = h1_s4 + rows * kp / 4;
  float* h1_s = reinterpret_cast<float*>(h1_s4);
  float* h2_s = reinterpret_cast<float*>(h2_s4);
  stage_weight(w1, w1_s, hidden);
  stage_weight(w2, w2_s, hidden);
  stage_weight(wi2, wi2_s, hidden);
  for (int idx = threadIdx.x; idx < 2 * rows * kp; idx += blockDim.x) {
    h1_s[idx] = 0.0f;  // h1_s and h2_s
  }
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = blockIdx.x * rows + lrow0;
  const float4* const h_both[2] = {h1_s4, h2_s4};
  const float4* const w_both[2] = {w1_s, w2_s};
  const float4* const h_seam[1] = {h1_s4};
  const float4* const w_seam[1] = {wi2_s};

  float c1[RPT], c2[RPT], seam[1][4][RPT], x_next[4][RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    c1[r] = 0.0f;
    c2[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) seam[0][g][r] = 0.0f;
  }
  load_x(x1, 0, n_t, n_rows, hidden, row0, j, x_next);
  __syncthreads();

  for (int s = 0; s <= n_t; ++s) {
    const bool run1 = s < n_t;  // layer 1 at step s
    const bool run2 = s > 0;    // layer 2 at step s-1
    float acc[2][4][RPT];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[0][g][r] = x_next[g][r];
        acc[1][g][r] = seam[0][g][r];
      }
    load_x(x1, s + 1, n_t, n_rows, hidden, row0, j, x_next);
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
      if (run1) {
        c1[r] = c1n[r];
        h1_s[(lrow0 + r) * kp + j] = h1[r];
      }
      if (run2) {
        c2[r] = c2n[r];
        h2_s[(lrow0 + r) * kp + j] = h2[r];
        const int row = row0 + r;
        if (row < n_rows) {
          h2s[(static_cast<size_t>(s - 1) * n_rows + row) * hidden + j] = h2[r];
        }
      }
    }
    __syncthreads();  // h1_s holds h1[s] for every row of the tile
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

bool bad_shape(int n_t, int n_rows, int hidden) {
  return n_t < 1 || n_rows < 1 || hidden < 1 || hidden > kMaxHidden;
}

// Rows a thread: the smallest of 1, 2, 4 whose grid fits one wave of SMs.
cudaError_t rows_per_thread(int n_rows, int device, int* rpt) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *rpt = 4;
  for (int r = 1; r < 4; r *= 2) {
    if ((n_rows + kGroups * r - 1) / (kGroups * r) <= sms) {
      *rpt = r;
      break;
    }
  }
  return cudaSuccess;
}

// Dynamic shared memory: n_weights staged weights, n_state h planes.
size_t smem_bytes(int hidden, int rpt, int n_weights, int n_state) {
  const size_t kp = padded(hidden);
  return (n_weights * kp * hidden * 4 + n_state * kGroups * rpt * kp) * sizeof(float);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int n_rows, int hidden, int rpt, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = kGroups * rpt;
  kernel<<<(n_rows + rows - 1) / rows, kGroups * hidden, smem, stream>>>(args...);
  return cudaGetLastError();
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
  cudaError_t err = cudaSetDevice(device);
  int rpt = 0;
  if (err == cudaSuccess) err = rows_per_thread(n_rows, device, &rpt);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(hidden, rpt, 1, 1);
  switch (rpt) {
    case 1:
      err = launch(lstm_fwd_kernel<1>, n_rows, hidden, rpt, smem, stream,
                   x, w_t, hs, cs, n_t, n_rows, hidden);
      break;
    case 2:
      err = launch(lstm_fwd_kernel<2>, n_rows, hidden, rpt, smem, stream,
                   x, w_t, hs, cs, n_t, n_rows, hidden);
      break;
    default:
      err = launch(lstm_fwd_kernel<4>, n_rows, hidden, rpt, smem, stream,
                   x, w_t, hs, cs, n_t, n_rows, hidden);
  }
  return static_cast<int>(err);
}

// h2s (T, B, H) from x1 (T, B, 4H), w1_t, wi2_t, w2_t (H, 4H) and b2 (4H).
int lstm_pair_fwd(const float* x1, const float* w1_t, const float* wi2_t,
                  const float* b2, const float* w2_t, float* h2s, int n_t,
                  int n_rows, int hidden, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int rpt = 0;
  if (err == cudaSuccess) err = rows_per_thread(n_rows, device, &rpt);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(hidden, rpt, 3, 2);
  switch (rpt) {
    case 1:
      err = launch(lstm_pair_fwd_kernel<1>, n_rows, hidden, rpt, smem, stream,
                   x1, w1_t, wi2_t, b2, w2_t, h2s, n_t, n_rows, hidden);
      break;
    case 2:
      err = launch(lstm_pair_fwd_kernel<2>, n_rows, hidden, rpt, smem, stream,
                   x1, w1_t, wi2_t, b2, w2_t, h2s, n_t, n_rows, hidden);
      break;
    default:
      err = launch(lstm_pair_fwd_kernel<4>, n_rows, hidden, rpt, smem, stream,
                   x1, w1_t, wi2_t, b2, w2_t, h2s, n_t, n_rows, hidden);
  }
  return static_cast<int>(err);
}

}  // extern "C"
