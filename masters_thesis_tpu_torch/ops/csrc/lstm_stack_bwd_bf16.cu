// The L-deep stack's backward sweep in bf16 (trainer.precision=bf16-mixed),
// for Hopper (sm_90a), with a plain C interface: the bf16 instances of
// lstm_stack_bwd_kernel (lstm_stack.cuh), the serial part of
// _stack_bwd_kernel in masters_thesis_tpu/ops/lstm_kernel.py at its bf16
// compute dtype. A library of its own, so that nvcc builds it beside
// lstm_stack_bwd.cu's f32 instances. The 2L - 1 weight gradients are one
// launch of lstm_wgrad_bf16 (lstm_bwd_bf16.cu) over the f32 d_pre planes
// this sweep writes.
//
// What bounds it is the f32 sweep's: the serial chain of T + 2 (L - 1)
// iterations of 4L - 2 products from shared memory. The sweep converts the
// bf16 stashes to f32 where it loads them (a step ahead, clamped), so the
// gates and each seam projection are recomputed from the rounded stashes
// as the TPU kernel recomputes them; the carried dc, dh, the seam
// cotangents and the products stay f32. It writes every layer's d_pre in
// f32 (the pass's operand: the TPU kernel sums its weight gradients over
// f32 d_pre and rounds each once) and layer 0's also rounded, into dx1,
// the gradient of the bf16 projection. No replica axis: R must be 1.

#include "lstm_stack.cuh"

extern "C" {

// lstm_stack_bwd (lstm_stack_bwd.cu) with every operand in bf16: dx1
// (T, B, 4H) bf16, d_pre[l] (T, B, 4H) f32 for every layer.
int lstm_stack_bwd_bf16(const __nv_bfloat16* dh_top, const __nv_bfloat16* x1,
                        const __nv_bfloat16* const* mask,
                        const __nv_bfloat16* const* hs,
                        const __nv_bfloat16* const* cs,
                        const __nv_bfloat16* const* w_hh,
                        const __nv_bfloat16* const* w_in,
                        const __nv_bfloat16* const* bias, __nv_bfloat16* dx1,
                        float* const* d_pre, int n_layers, int n_t, int n_rows,
                        int hidden, int replicas, int tile, int device,
                        cudaStream_t stream) {
  return stack_bwd(dh_top, x1, mask, hs, cs, w_hh, w_in, bias, dx1, d_pre,
                   n_layers, n_t, n_rows, hidden, replicas, tile, device,
                   stream);
}

// The row tile of a bf16 backward launch, as lstm_stack_bwd_row_tile.
int lstm_stack_bwd_row_tile_bf16(int n_layers, int n_rows, int hidden,
                                 int masked, int replicas, int device,
                                 int* rows) {
  return stack_bwd_row_tile<__nv_bfloat16>(n_layers, n_rows, hidden, masked,
                                           replicas, device, rows);
}

}  // extern "C"
