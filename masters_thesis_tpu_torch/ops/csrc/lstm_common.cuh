// Helpers shared by the forward (lstm_fwd.cu), backward (lstm_bwd.cu) and
// stack (lstm_stack.cu) LSTM kernels: the staged weight layout, the gate
// products over h rows held in shared memory, the cell's backward, the
// transposed products, the row-tile choice and the launch with dynamic
// shared memory. Each .cu file compiles into its own library, so everything
// here has internal linkage.
//
// Layout is the JAX functions' own: time-major planes (T, B, ·), gate order
// i, f, g, o, and transposed weights w_t (H, 4H) so that
// gates = x_proj[t] + h @ w_t. Everything is f32.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

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

// xv[g][r] = x[t][row0 + r][g*H + j], zero past the last step, before the
// first or past the last row.
template <int RPT>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int t,
                                       int n_t, int n_rows, int hidden,
                                       int row0, int j, float (&xv)[4][RPT]) {
  const int four_h = 4 * hidden;
  const bool t_in = t >= 0 && t < n_t;
  const float* xt = x + static_cast<size_t>(t_in ? t : 0) * n_rows * four_h;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r;
    const bool in = t_in && row < n_rows;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      xv[g][r] = in ? __ldg(xt + static_cast<size_t>(row) * four_h + g * hidden + j)
                    : 0.0f;
    }
  }
}

// v[r] = p[t][row0 + r][j] for a (T, B, H) plane, zero outside it.
template <int RPT>
__device__ __forceinline__ void load_h(const float* __restrict__ p, int t,
                                       int n_t, int n_rows, int hidden,
                                       int row0, int j, float (&v)[RPT]) {
  const bool t_in = t >= 0 && t < n_t;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r;
    v[r] = t_in && row < n_rows
               ? __ldg(p + (static_cast<size_t>(t) * n_rows + row) * hidden + j)
               : 0.0f;
  }
}

// acc[l][g][r] += sum_k h_s[l][row r][k] * w_s[l][k][j].g for L products at
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

// Pre-activation gradients (gate order i, f, g, o) of one cell step from its
// gate pre-activations, c[t], c[t-1], the incoming dh and the dc carried
// from step t+1; the carry becomes dc * f for step t-1. The formulas of the
// TPU kernels' body, term for term.
template <int RPT>
__device__ __forceinline__ void cell_backward(const float (&gates)[4][RPT],
                                              const float (&c)[RPT],
                                              const float (&c_prev)[RPT],
                                              const float (&dh)[RPT],
                                              float (&dc_carry)[RPT],
                                              float (&d_pre)[4][RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float i = sigmoid(gates[0][r]);
    const float f = sigmoid(gates[1][r]);
    const float g = tanhf(gates[2][r]);
    const float o = sigmoid(gates[3][r]);
    const float tanh_c = tanhf(c[r]);
    const float d_o = dh[r] * tanh_c;
    const float dc = dh[r] * o * (1.0f - tanh_c * tanh_c) + dc_carry[r];
    const float di = dc * g;
    const float dg = dc * i;
    const float df = dc * c_prev[r];
    dc_carry[r] = dc * f;
    d_pre[0][r] = di * i * (1.0f - i);
    d_pre[1][r] = df * f * (1.0f - f);
    d_pre[2][r] = dg * (1.0f - g * g);
    d_pre[3][r] = d_o * o * (1.0f - o);
  }
}

// out[l][r] = sum_{j', g} dp_s[l][row r][j'].g * w_s[l][j * H + j'].g for L
// products: the cotangent of h (unit j of the thread) through
// gates = h @ w_t. Thread j starts at j' = j and wraps, so that across a warp
// the float4 reads of w_s[j * H + j'] are H + 1 float4 apart: distinct banks.
template <int RPT, int L>
__device__ __forceinline__ void transposed_products(
    const float4* const (&dp_s)[L], const float4* const (&w_s)[L], int lrow0,
    int hidden, int j, float (&out)[L][RPT]) {
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int r = 0; r < RPT; ++r) out[l][r] = 0.0f;
  int jp = j;
  for (int n = 0; n < hidden; ++n) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 w = w_s[l][j * hidden + jp];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 d = dp_s[l][(lrow0 + r) * hidden + jp];
        float s = out[l][r];
        s = fmaf(d.x, w.x, s);
        s = fmaf(d.y, w.y, s);
        s = fmaf(d.z, w.z, s);
        s = fmaf(d.w, w.w, s);
        out[l][r] = s;
      }
    }
    jp = jp + 1 == hidden ? 0 : jp + 1;
  }
}

// d_pre rows of this thread into device memory (when on) and shared memory.
template <int RPT>
__device__ __forceinline__ void store_d_pre(const float (&d)[4][RPT], bool on,
                                            float* __restrict__ plane, int t,
                                            int n_rows, int hidden, int row0,
                                            int lrow0, int j, float4* dp_s) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r;
    if (on && row < n_rows) {
      float* out = plane + (static_cast<size_t>(t) * n_rows + row) * 4 * hidden + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) out[g * hidden] = d[g][r];
    }
    dp_s[(lrow0 + r) * hidden + j] = make_float4(d[0][r], d[1][r], d[2][r], d[3][r]);
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

// Dynamic shared memory: n_weights staged weights, n_state h planes of
// (rows, padded(H)) floats, n_vec4 planes of (rows, H) float4.
size_t smem_bytes(int hidden, int rpt, int n_weights, int n_state,
                  int n_vec4 = 0) {
  const size_t kp = padded(hidden);
  const size_t rows = kGroups * rpt;
  return (n_weights * kp * hidden * 4 + n_state * rows * kp +
          n_vec4 * rows * hidden * 4) * sizeof(float);
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

// Sets the device, picks the rows a thread and calls
// f(std::integral_constant<int, RPT>{}) so that f can name the kernel
// instance for that RPT.
template <typename F>
cudaError_t with_rpt(int n_rows, int device, F f) {
  int rpt = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = rows_per_thread(n_rows, device, &rpt);
  if (err != cudaSuccess) return err;
  switch (rpt) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    default:
      return f(std::integral_constant<int, 4>{});
  }
}

}  // namespace
