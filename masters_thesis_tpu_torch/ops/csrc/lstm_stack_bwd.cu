// The L-deep stack's backward sweep (lstm_stack_bwd_kernel,
// lstm_stack.cuh) with a plain C interface, f32; its forward is
// lstm_stack.cu. The entry points take the device index and pointer arrays
// as there.

#include "lstm_stack.cuh"

extern "C" {

#ifdef LSTM_STACK_STAMPS
int lstm_stack_stamps(int cta, long long* host) {
  return static_cast<int>(copy_stamps(cta, host));
}
#endif

// d_pre[l] (R, T, B, 4H) for every layer (d_pre[0] = dx1) from dh_top
// (R, T, B, H), x1, the optional seam masks, the stashes hs, cs and the
// weights.
int lstm_stack_bwd(const float* dh_top, const float* x1, const float* const* mask,
                   const float* const* hs, const float* const* cs,
                   const float* const* w_hh, const float* const* w_in,
                   const float* const* bias, float* const* d_pre, int n_layers,
                   int n_t, int n_rows, int hidden, int replicas, int tile,
                   int device, cudaStream_t stream) {
  return stack_bwd<float>(dh_top, x1, mask, hs, cs, w_hh, w_in, bias, nullptr,
                          d_pre, n_layers, n_t, n_rows, hidden, replicas, tile,
                          device, stream);
}

// *rows = the row tile a backward launch of n_layers layers on R replicas
// of n_rows rows takes, with or without the mask.
int lstm_stack_bwd_row_tile(int n_layers, int n_rows, int hidden, int masked,
                            int replicas, int device, int* rows) {
  return stack_bwd_row_tile<float>(n_layers, n_rows, hidden, masked, replicas,
                                   device, rows);
}

}  // extern "C"
