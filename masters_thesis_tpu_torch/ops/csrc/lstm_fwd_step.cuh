// The 256-thread forward step: helpers shared by the pair's forward
// (lstm_pair_fwd_kernel, lstm_fwd.cu), both single-layer forwards
// (lstm_fwd_kernel, lstm_fwd.cu; lstm_tb_fwd_kernel, lstm_tb.cu) and the
// stack's forward (lstm_stack_fwd_kernel, lstm_stack.cu), on the block and
// lane layout of the backward sweeps (lstm_sweep.cuh); the stack's
// backward sweep (lstm_stack.cu) takes its lanes, planes and register
// weight too.
//
// A block of 256 threads (8 warps) owns a tile of 1, 2, 4 or 8 rows
// (sweep_rows). Lane u + 8 q of warp w serves unit j = 8 w + u and quarter
// q of the contraction for all the tile's rows. A weight is either staged
// in shared memory (stage_weight_padded), where each float4 is read by one
// lane a product and step (quarter_gate_products), or, where the registers
// allow, held in the registers of the lanes that multiply it: lane (j, q)
// needs only the 16 x 4 floats of its quarter and unit (load_quarter_weight,
// register_gate_product), so that product reads no weight at all. The
// quarters are summed with warp shuffles (quarter_gates), after which the
// lane owns rows q and q + 4 of unit j: their cell update, c in registers,
// and their h written into the next step's plane. A step reads only what
// the step before it wrote, so the h planes are double buffered by the
// parity of the step: step s reads buffer s & 1 and writes buffer
// (s + 1) & 1, and one barrier a step both publishes the new h and frees
// the old buffer for step s + 1's writes. What a lane reads and writes
// (FwdLane) is worked out once and clamped so that no read needs a branch:
// with branches between them, the loads of a step were issued one after
// another (an H100's SASS showed it), and integer divisions and 64-bit
// address sums filled the step.

#pragma once

#include "lstm_sweep.cuh"

namespace {

// Bytes of one weight staged by stage_weight_padded: [p][p + 1] float4.
size_t padded_weight_bytes(int hidden) {
  const size_t p = sweep_pad(hidden);
  return p * (p + 1) * sizeof(float4);
}

// N h planes [ROWS][p + 16] floats (h_col's padding) in each of two
// buffers, by the parity of the step.
struct FwdPlanes {
  float* base;
  int size;  // floats a plane
  int n;     // planes a buffer

  __device__ float* at(int step, int i) const {
    return base + ((step & 1) * n + i) * size;
  }
  __device__ float* end() const { return base + 2 * n * size; }
  // Both buffers to zero: the h of the step before the first, and no NaN
  // left by an earlier kernel in padding that a product multiplies by 0.
  __device__ void zero() const {
    for (int idx = threadIdx.x; idx < 2 * n * size; idx += blockDim.x) base[idx] = 0.0f;
  }
};

__device__ __forceinline__ FwdPlanes fwd_planes(float4* after_weights, int p,
                                                int rows, int n) {
  return {reinterpret_cast<float*>(after_weights), rows * (p + 16), n};
}

size_t fwd_planes_bytes(int hidden, int rows, int n) {
  return 2 * static_cast<size_t>(n) * rows * (sweep_pad(hidden) + 16) * sizeof(float);
}

// Quarter q of one weight in the registers of lane (j, q): wr[m][g] =
// w[q kq + m][g H + j] for m < kq, zero beyond H. Read once from device
// memory, so that the products with it read no weight from shared memory.
__device__ __forceinline__ void load_quarter_weight(const float* __restrict__ w,
                                                    int hidden, int kq, int q, int j,
                                                    float (&wr)[kMaxHidden / 4][4]) {
#pragma unroll
  for (int m = 0; m < kMaxHidden / 4; ++m) {
    const int k = q * kq + m;
    const bool in = m < kq && k < hidden && j < hidden;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      wr[m][g] = in ? __ldg(w + k * 4 * hidden + g * hidden + j) : 0.0f;
    }
  }
}

// acc[r][g] += sum over k in quarter q of h_s[r][k] * w[k][g H + j], the
// weight's quarter in this lane's registers (load_quarter_weight); the
// terms in the order of quarter_gate_products. Past the quarter (m >= kq,
// H < 61) a lane reads the quarter's first float4 again, which the zero
// weights there cancel (acc + 0 is acc): no branch, so every h load of the
// product is in flight at once.
template <int ROWS>
__device__ __forceinline__ void register_gate_product(
    const float* h_s, const float (&wr)[kMaxHidden / 4][4], int kq, int q,
    float (&acc)[ROWS][4]) {
  const float* hq = h_s + q * (kq + 4);
#pragma unroll
  for (int m = 0; m < kMaxHidden / 4; m += 4) {
    const int at = m < kq ? m : 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 h4 = *reinterpret_cast<const float4*>(hq + r * (4 * kq + 16) + at);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = lane(h4, e);
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(h, wr[m + e][g], acc[r][g]);
      }
    }
  }
}

// gates[o][g][i] = add[o][g][i] + output o's gate g for row q + 4 i and unit
// j, from this lane's partial sums acc[r][4 o + g]: the quarters summed
// (quarter_sum). The whole warp calls.
template <int ROWS, int O>
__device__ __forceinline__ void quarter_gates(float (&acc)[ROWS][4 * O], int q,
                                              const float (&add)[O][4][(ROWS + 3) / 4],
                                              float (&gates)[O][4][(ROWS + 3) / 4]) {
  constexpr int NR = (ROWS + 3) / 4;
  float sums[NR][4 * O];
  quarter_sum<ROWS, 4 * O>(acc, q, sums);
#pragma unroll
  for (int o = 0; o < O; ++o)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int i = 0; i < NR; ++i) gates[o][g][i] = add[o][g][i] + sums[i][4 * o + g];
}

// What lane (j, q) of a forward step reads and writes, worked out once. Its
// reads are clamped into the tile, the planes and the units below H, so
// that none needs a branch: where the lane owns no row (q + 4 i >= ROWS, a
// row past the last) it reads a real one and its result is discarded, and a
// padding unit j >= H reads unit H - 1, whose h the zero weights beyond H
// cancel in every product.
template <int ROWS>
struct FwdLane {
  static constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  int q, j;
  int hc;       // unit j's column in an h plane row (h_col)
  int col;      // j clamped below H
  int lrow[NR]; // tile row q + 4 i, clamped into the tile
  int row[NR];  // its row in the (T, B, ·) planes, clamped below B
  int out[NR];  // row * H + j where the lane writes row q + 4 i, or -1

  __device__ FwdLane(int n_rows, int hidden, int kq, int tile0) {
    q = (threadIdx.x & 31) >> 3;
    j = (threadIdx.x >> 5) * 8 + (threadIdx.x & 7);
    hc = h_col(j, kq);
    col = min(j, hidden - 1);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = q + 4 * i;
      lrow[i] = min(r, ROWS - 1);
      row[i] = min(tile0 + lrow[i], n_rows - 1);
      out[i] = r < ROWS && tile0 + r < n_rows && j < hidden
                   ? (tile0 + r) * hidden + j : -1;
    }
  }

  // xv[g][i] = x[t][row i][g H + col], t clamped into 0 .. n_t - 1.
  __device__ void load_x(const float* __restrict__ x, int t, int n_t, int n_rows,
                         int hidden, float (&xv)[4][NR]) const {
    const float* xt = x + static_cast<size_t>(min(max(t, 0), n_t - 1)) * n_rows * 4 * hidden;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float* xr = xt + static_cast<size_t>(row[i]) * 4 * hidden + col;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g][i] = __ldg(xr + g * hidden);
    }
  }

  // v[i] = plane[t][row i][col] for a (T, B, H) plane, t clamped into
  // 0 .. n_t - 1.
  __device__ void load_h(const float* __restrict__ plane, int t, int n_t,
                         int n_rows, int hidden, float (&v)[NR]) const {
    const float* pt = plane + static_cast<size_t>(min(max(t, 0), n_t - 1)) * n_rows * hidden;
#pragma unroll
    for (int i = 0; i < NR; ++i) v[i] = __ldg(pt + row[i] * hidden + col);
  }

  // v[i] into the h plane h_s, for the rows of the tile the lane owns.
  __device__ void stage(const float (&v)[NR], float* h_s, int kq) const {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (q + 4 * i < ROWS) h_s[(q + 4 * i) * (4 * kq + 16) + hc] = v[i];
    }
  }

  // v[i] into plane[t] (T, B, H), where the lane writes.
  __device__ void store(const float (&v)[NR], float* __restrict__ plane, int t,
                        int n_rows, int hidden) const {
    float* pt = plane + static_cast<size_t>(t) * n_rows * hidden;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (out[i] >= 0) pt[out[i]] = v[i];
    }
  }
};

}  // namespace
