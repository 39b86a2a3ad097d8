// Helpers shared by every LSTM kernel of the port: the cell's forward and
// backward and the shape check. Each .cu file compiles into its own
// library, so everything here has internal linkage.
//
// Layout is the JAX functions' own: time-major planes (T, B, ·), gate order
// i, f, g, o, and transposed weights w_t (H, 4H) so that
// gates = x_proj[t] + h @ w_t. The arithmetic is f32. The pair's kernels
// also take bf16 planes and weights (the JAX kernels' bf16 compute dtype):
// every load converts to f32 (load_f32), every store of a plane rounds to
// nearest even (store_as), and the carried state stays f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 64;

// One element of a plane or weight in f32, through the read-only cache.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// v into *p in the plane's storage type (bf16: rounded to nearest even).
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
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

}  // namespace
