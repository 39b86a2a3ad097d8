// The L-deep stack's forward (lstm_stack_fwd_kernel, lstm_stack.cuh) with
// a plain C interface, f32; its backward is lstm_stack_bwd.cu, and the
// bf16 instances are lstm_stack_bf16.cu and lstm_stack_bwd_bf16.cu.

#include "lstm_stack.cuh"

extern "C" {

#ifdef LSTM_STACK_STAMPS
int lstm_stack_stamps(int cta, long long* host) {
  return static_cast<int>(copy_stamps(cta, host));
}
#endif

int lstm_stack_max_layers() { return kMaxLayers; }

int lstm_stack_max_hidden() { return kMaxHidden; }

// Every entry point takes the CUDA device index of its pointers and stream:
// this library links its own CUDA runtime, whose current device is set here.
// Pointer arrays hold n_layers entries (w_hh, hs, cs) or n_layers - 1 (w_in,
// bias, mask: seam i between layers i and i + 1).

// With R replicas every operand is R stacked ones (the pointers in the
// arrays stay one a layer or seam; the kernel offsets them), replica r's
// outputs its solo launch's. tile 0 takes the row tile from all R
// replicas' rows within the solo tile's summation class (with_stack_tile);
// 1, 2, 4 or 8 names it.

// The top layer's h (R, T, B, H) into hs[n_layers - 1] from x1 (R, T, B, 4H),
// the weights and, when mask is non-null, the seam masks (R, T, B, H). With
// cs[0] non-null (the stash), every hs[l] and cs[l] is written.
int lstm_stack_fwd(const float* x1, const float* const* mask,
                   const float* const* w_hh, const float* const* w_in,
                   const float* const* bias, float* const* hs, float* const* cs,
                   int n_layers, int n_t, int n_rows, int hidden, int replicas,
                   int tile, int device, cudaStream_t stream) {
  return stack_fwd(x1, mask, w_hh, w_in, bias, hs, cs, n_layers, n_t, n_rows,
                   hidden, replicas, tile, device, stream);
}

// *rows = the row tile a forward launch of n_layers layers on R replicas of
// n_rows rows takes, with or without the mask and the stash.
int lstm_stack_row_tile(int n_layers, int n_rows, int hidden, int masked,
                        int stash, int replicas, int device, int* rows) {
  return stack_row_tile<float>(n_layers, n_rows, hidden, masked, stash,
                               replicas, device, rows);
}

}  // extern "C"
