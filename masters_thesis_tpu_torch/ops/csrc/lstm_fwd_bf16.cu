// The layer pair's forward in bf16 (trainer.precision=bf16-mixed), for
// Hopper (sm_90a), with a plain C interface: the bf16 instances of
// lstm_pair_fwd_kernel (lstm_pair_fwd.cuh), the CUDA counterpart of
// _pair_fwd_kernel in masters_thesis_tpu/ops/lstm_kernel.py at its bf16
// compute dtype. A library of its own, so that nvcc builds it beside
// lstm_fwd.cu's f32 instances.
//
// What bounds it is lstm_fwd.cu's f32 pair's: the serial chain of T + 1
// steps of three (rows, H) @ (H, 4H) f32 products from shared memory.
// bf16 halves the planes' bytes, not the step's work: the weights are
// converted to f32 once, where they are staged (shared memory or the
// lanes' registers), x1 and the mask where each lane loads them, and the
// step is the f32 kernel's. h and c are carried in f32 (the seam from the
// f32 h1), and the h2s, h1s, c1s, c2s stores round to nearest even: the
// TPU kernel's f32 scratch and rounded stores. Tensor-core bf16 products
// would round h before the product, which the TPU kernel does not.

#include "lstm_pair_fwd.cuh"

extern "C" {

// lstm_pair_fwd with every operand and output in bf16 (f32 arithmetic
// inside, rounded stores); one replica (replicas must be 1).
int lstm_pair_fwd_bf16(const __nv_bfloat16* x1, const __nv_bfloat16* mask,
                       const __nv_bfloat16* w1_t, const __nv_bfloat16* wi2_t,
                       const __nv_bfloat16* b2, const __nv_bfloat16* w2_t,
                       __nv_bfloat16* h2s, __nv_bfloat16* h1s,
                       __nv_bfloat16* c1s, __nv_bfloat16* c2s, int n_t,
                       int n_rows, int hidden, int replicas, int tile,
                       int device, cudaStream_t stream) {
  return pair_fwd(x1, mask, w1_t, wi2_t, b2, w2_t, h2s, h1s, c1s, c2s, n_t,
                  n_rows, hidden, replicas, tile, device, stream);
}

}  // extern "C"
