// The L-deep stack's backward sweep (lstm_stack_bwd_kernel,
// lstm_stack.cuh) with a plain C interface; its forward is lstm_stack.cu.
// The entry points take the device index and pointer arrays as there.

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
  if (bad_stack(n_layers, n_t, n_rows, hidden, replicas)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StackBwdArgs a{};
  a.dh_top = dh_top;
  a.x1 = x1;
  a.n_layers = n_layers;
  a.n_t = n_t;
  a.n_rows = n_rows;
  a.hidden = hidden;
  a.replicas = replicas;
  const bool has_mask = mask != nullptr;
  for (int l = 0; l < n_layers; ++l) {
    a.hs[l] = hs[l];
    a.cs[l] = cs[l];
    a.w_hh[l] = w_hh[l];
    a.d_pre[l] = d_pre[l];
    if (l + 1 < n_layers) {
      a.w_in[l] = w_in[l];
      a.bias[l] = bias[l];
      a.mask[l] = has_mask ? mask[l] : nullptr;
    }
  }
  const auto launch = [&](auto at) { return launch_tile<decltype(at)>(a, stream); };
  return static_cast<int>(has_mask ? with_bwd_tile<true>(a, device, tile, launch)
                                   : with_bwd_tile<false>(a, device, tile, launch));
}

// *rows = the row tile a backward launch of n_layers layers on R replicas
// of n_rows rows takes, with or without the mask.
int lstm_stack_bwd_row_tile(int n_layers, int n_rows, int hidden, int masked,
                            int replicas, int device, int* rows) {
  if (bad_stack(n_layers, 1, n_rows, hidden, replicas)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto tile = [&](auto at) {
    *rows = decltype(at)::kRows;
    return cudaSuccess;
  };
  StackBwdArgs a{};
  a.n_layers = n_layers;
  a.n_rows = n_rows;
  a.hidden = hidden;
  a.replicas = replicas;
  return static_cast<int>(masked ? with_bwd_tile<true>(a, device, 0, tile)
                                 : with_bwd_tile<false>(a, device, 0, tile));
}

}  // extern "C"
