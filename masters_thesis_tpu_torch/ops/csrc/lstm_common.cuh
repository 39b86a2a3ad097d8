// Helpers shared by every LSTM kernel of the port: the cell's forward and
// backward, the shape check, and the first design's staged weight layout,
// loads and gate products over h rows held in shared memory, which the
// stack's forward (lstm_stack.cu) still runs. Each .cu file compiles into
// its own library, so everything here has internal linkage.
//
// Layout is the JAX functions' own: time-major planes (T, B, ·), gate order
// i, f, g, o, and transposed weights w_t (H, 4H) so that
// gates = x_proj[t] + h @ w_t. Everything is f32.

#pragma once

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

// One row's pre-activation gradients (gate order i, f, g, o) from its gate
// activations i, f, g, o, tanh(c[t]), c[t-1], the incoming dh and the dc
// carried from step t+1; the carry becomes dc * f for step t-1.
__device__ __forceinline__ float4 cell_grads(float i, float f, float g, float o,
                                             float tanh_c, float c_prev, float dh,
                                             float& dc_carry) {
  const float d_o = dh * tanh_c;
  const float dc = dh * o * (1.0f - tanh_c * tanh_c) + dc_carry;
  const float di = dc * g;
  const float dg = dc * i;
  const float df = dc * c_prev;
  dc_carry = dc * f;
  return make_float4(di * i * (1.0f - i), df * f * (1.0f - f), dg * (1.0f - g * g),
                     d_o * o * (1.0f - o));
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
    const float4 d = cell_grads(sigmoid(gates[0][r]), sigmoid(gates[1][r]),
                                tanhf(gates[2][r]), sigmoid(gates[3][r]),
                                tanhf(c[r]), c_prev[r], dh[r], dc_carry[r]);
    d_pre[0][r] = d.x;
    d_pre[1][r] = d.y;
    d_pre[2][r] = d.z;
    d_pre[3][r] = d.w;
  }
}

bool bad_shape(int n_t, int n_rows, int hidden) {
  return n_t < 1 || n_rows < 1 || hidden < 1 || hidden > kMaxHidden;
}

// Dynamic shared memory: n_weights staged weights and n_state h planes of
// (rows, padded(H)) floats.
size_t smem_bytes(int hidden, int rpt, int n_weights, int n_state) {
  const size_t kp = padded(hidden);
  const size_t rows = kGroups * rpt;
  return (n_weights * kp * hidden * 4 + n_state * rows * kp) * sizeof(float);
}

}  // namespace
