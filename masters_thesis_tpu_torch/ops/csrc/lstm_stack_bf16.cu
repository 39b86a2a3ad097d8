// The L-deep stack's forward in bf16 (trainer.precision=bf16-mixed), for
// Hopper (sm_90a), with a plain C interface: the bf16 instances of
// lstm_stack_fwd_kernel (lstm_stack.cuh), the CUDA counterpart of
// _stack_fwd_kernel in masters_thesis_tpu/ops/lstm_kernel.py at its bf16
// compute dtype. A library of its own, so that nvcc builds it beside
// lstm_stack.cu's f32 instances.
//
// What bounds it is the f32 stack's: the serial chain of T + L - 1
// iterations of 2L - 1 (rows, H) @ (H, 4H) f32 products. bf16 halves the
// planes' bytes, not an iteration's work: the weights are converted to f32
// once, where they are staged (shared memory at 4 and 8 rows) or put in
// the lanes' registers (1 and 2 rows), x1 and the masks where each lane
// loads them a step ahead, and the step is the f32 kernel's. h and c are
// carried in f32, the seam each layer pushes to the next is its f32 h
// times the mask (not the rounded stash), and the h and c stores round to
// nearest even: the TPU kernel's f32 scratch and rounded stores.
// Tensor-core bf16 products would round h before the product, which the
// TPU kernel does not. No replica axis: R must be 1.

#include "lstm_stack.cuh"

extern "C" {

// lstm_stack_fwd (lstm_stack.cu) with every operand and output in bf16.
int lstm_stack_fwd_bf16(const __nv_bfloat16* x1, const __nv_bfloat16* const* mask,
                        const __nv_bfloat16* const* w_hh,
                        const __nv_bfloat16* const* w_in,
                        const __nv_bfloat16* const* bias,
                        __nv_bfloat16* const* hs, __nv_bfloat16* const* cs,
                        int n_layers, int n_t, int n_rows, int hidden,
                        int replicas, int tile, int device,
                        cudaStream_t stream) {
  return stack_fwd(x1, mask, w_hh, w_in, bias, hs, cs, n_layers, n_t, n_rows,
                   hidden, replicas, tile, device, stream);
}

// The row tile of a bf16 forward launch, as lstm_stack_row_tile.
int lstm_stack_row_tile_bf16(int n_layers, int n_rows, int hidden, int masked,
                             int stash, int replicas, int device, int* rows) {
  return stack_row_tile<__nv_bfloat16>(n_layers, n_rows, hidden, masked, stash,
                                       replicas, device, rows);
}

}  // extern "C"
