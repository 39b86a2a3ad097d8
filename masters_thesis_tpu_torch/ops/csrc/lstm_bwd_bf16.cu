// The layer pair's backward in bf16 (trainer.precision=bf16-mixed), for
// Hopper (sm_90a), with a plain C interface: the bf16 instances of the
// pair's sweep (lstm_pair_bwd_kernel, lstm_pair_bwd.cuh) and of the
// weight-gradient pass (lstm_wgrad.cuh), the CUDA counterparts of
// _pair_bwd_kernel in masters_thesis_tpu/ops/lstm_kernel.py at its bf16
// compute dtype. A library of its own, so that nvcc builds it beside
// lstm_bwd.cu's f32 instances.
//
// What bounds them is lstm_bwd.cu's f32 kernels': the sweep's serial chain
// of T + 1 steps of six products from shared memory, and the pass's f32
// FMAs. The sweep converts the bf16 stashes to f32 where it loads them, so
// the gates are recomputed from the rounded stashes as the TPU kernel
// recomputes them; it writes layer 1's d_pre twice, rounded (dx1, the bf16
// projection's gradient) and in f32 (the pass's operand), and layer 2's in
// f32. The pass reads the bf16 h stashes and mask (8-byte cp.async copies
// of four values into its ring, or one value a thread where H is not a
// multiple of 4) beside the f32 d_pre, sums in f32 and rounds each weight
// gradient once: the TPU kernel's f32 accumulators. Summing over the
// rounded dx1 instead misses the TPU kernel by about 0.35% of the largest
// entry.

#include "lstm_pair_bwd.cuh"
#include "lstm_wgrad.cuh"

extern "C" {

// lstm_pair_bwd with every operand and dx1 in bf16 (T, B, ·): dx1 is layer
// 1's d_pre rounded; dpre1 and dpre2 (T, B, 4H) are both layers' d_pre in
// f32, the weight-gradient pass's operands. One replica (replicas must be
// 1).
int lstm_pair_bwd_bf16(const __nv_bfloat16* dh2s, const __nv_bfloat16* x1,
                       const __nv_bfloat16* mask, const __nv_bfloat16* h1s,
                       const __nv_bfloat16* c1s, const __nv_bfloat16* h2s,
                       const __nv_bfloat16* c2s, const __nv_bfloat16* w1_t,
                       const __nv_bfloat16* wi2_t, const __nv_bfloat16* b2,
                       const __nv_bfloat16* w2_t, __nv_bfloat16* dx1,
                       float* dpre1, float* dpre2, int n_t, int n_rows,
                       int hidden, int replicas, int tile, int device,
                       cudaStream_t stream) {
  return pair_bwd(dh2s, x1, mask, h1s, c1s, h2s, c2s, w1_t, wi2_t, b2, w2_t,
                  dx1, dpre1, dpre2, n_t, n_rows, hidden, replicas, tile,
                  device, stream);
}

// lstm_wgrad with src, mask, out and bias_out in bf16 and dpre in f32: the
// sums in f32, each output rounded once. One replica (replicas must be 1).
int lstm_wgrad_bf16(int n_jobs, const __nv_bfloat16* const* src,
                    const __nv_bfloat16* const* mask, const float* const* dpre,
                    __nv_bfloat16* const* out, __nv_bfloat16* const* bias_out,
                    const int* shift, float* part, int splits, int n_t,
                    int n_rows, int hidden, int replicas, int device,
                    cudaStream_t stream) {
  return wgrad(n_jobs, src, mask, dpre, out, bias_out, shift, part, splits,
               n_t, n_rows, hidden, replicas, device, stream);
}

}  // extern "C"
