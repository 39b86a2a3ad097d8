// Time-blocked LSTM recurrence for Hopper (sm_90a), forward and backward,
// with a plain C interface.
//
// Two kernels, each the CUDA counterpart of a Pallas TPU kernel in
// masters_thesis_tpu/ops/lstm_kernel.py, the reference's long-lookback path
// (it takes them where the resident single-layer program outgrows its VMEM
// budget: from T = 89 at 100 rows, T = 92 at 200 to 6,400 rows, H=64):
//
//   lstm_tb_fwd_kernel  replaces _tb_fwd_kernel: one layer's h (and
//                       optionally c) over T, h and c carried from one time
//                       chunk to the next;
//   lstm_tb_bwd_kernel  replaces _tb_bwd_kernel: the reverse sweep over the
//                       time chunks, gates recomputed from h[t-1] and c[t-1],
//                       d_pre (= dx) written as its own plane, and the
//                       recurrent weight gradient dw += h[t-1]ᵀ d_pre
//                       accumulated inside the sweep, one (H, 4H) partial
//                       per row tile (the caller sums the partials in a
//                       fixed order, as the JAX wrapper sums its own).
//
// What changes from the TPU. There the grid (row tiles x time chunks) runs
// in order, so h and c (and dh, dc, dw) ride in VMEM scratch from one grid
// step to the next while VMEM holds one chunk of the (T, rows, ...) planes.
// Here blocks run in no order, so a block owns a tile of rows and walks the
// time chunks itself, in a loop. The chunk's planes (x, and for the backward
// dh and the h and c stashes) are copied into shared memory with cp.async,
// double buffered: the next chunk's copy is in flight while this one
// computes, the counterpart of the BlockSpec pipeline. The backward needs
// h[t0-1] and c[t0-1] for a chunk's first step t0: the TPU kernel reads them
// from per-chunk boundary slivers only because a BlockSpec cannot read across
// blocks; here the chunk's copy simply starts earlier in the stash (c one
// step, h two: an iteration also stages the h of the step after it).
//
// What bounds them on this card. Each step is a (rows, H) @ (H, 4H) product
// (and, backward, its transpose and the rank-rows dw update) whose next step
// needs this step's h or dh: a chain of T dependent steps; rows are
// independent. At T=252, 100 rows, H=64 the forward does 826 MFLOP of f32
// products over 39 MB (x in; h, c out): 12.3 us by f32 arithmetic (no TF32,
// to keep the JAX package's f32 numerics), 11.6 us by bytes; the backward
// three products a step, 37 us by arithmetic. The step chain's latency and
// each step's shared-memory reads, not either roofline term, limit both.
// The backward's first design ran the resident sweep's old step (two row
// groups each reading every weight, two barriers a step) plus a 64 KiB dw
// in shared memory that each thread read and wrote every step: about 4,450
// wavefronts a block and step at H = 64, against the 4.01 us a step
// measured at 100 rows on an H100.
//
// What the design does about it. The forward runs the pair forward's step
// (lstm_fwd_step.cuh) with one product: 256 threads a tile of 1-8 rows
// (sweep_rows, the backward's tile), the weight in the registers of the
// lanes that multiply it (lane (j, q) holds the 16 x 4 floats of its
// quarter and unit), so a step reads no weight from shared memory (the
// first design's two row groups each read every staged weight: 1,024
// wavefronts a block and step at H = 64); the quarters summed with
// shuffles, h double buffered in shared memory so that a step has one
// barrier, c in the registers of the lane that owns the row. The resident
// lstm_fwd_kernel (lstm_fwd.cu) runs the same step on the same tile, so
// their h and c are bit-equal (chip_smoke.py fails if they are not).
// The x chunk's rows are padded to 4H + 8 floats, so that a warp's reads of
// its rows' x fall on distinct banks.
//
// The backward runs lstm_bwd_kernel's step (single_sweep_step,
// lstm_sweep.cuh) on the same tile, so its dx is bit-equal to that kernel's:
// 256 threads, each weight float4 read by one lane a product and step, and
// the gates of step s, which depend on stashes only, in the same pass and
// behind the same one barrier as d_pre[s+1] @ wᵀ. dw lives in registers:
// lane (j, q) owns dw[k][g H + j] for the 16 k of its quarter (64 floats)
// and adds the tile's rows of h[s]ᵀ d_pre[s+1] in the iteration that
// consumes d_pre[s+1], 5 wavefronts a row and warp (1,224 wavefronts a
// block and step at 1 row, 2,624 at 8; 384 and 3,072 clocks of FMAs a
// scheduler). Each lane writes only its own entries: no dw in shared
// memory, no barrier for it, no atomics, and a run repeats bit for bit. The
// chunked copy takes every load of the step chain off device memory. The
// chunk length is the longest (at most kMaxChunk steps) whose two buffers
// fit the block's shared memory beside the planes (and the backward's
// weight): at H=64 16 steps at 100 rows, forward and backward; at 800 rows
// (8-row tiles) 13 forward and 4 backward. The ragged last chunk and the
// ragged last row tile are masked, not padded: rows past the last stay zero
// in shared memory, so their d_pre is zero and adds nothing to dw. Accurate
// expf/tanhf, no fast math.

#include <cstdint>

#include "lstm_fwd_step.cuh"

namespace {

constexpr int kMaxChunk = 16;  // time steps a chunk, at most

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Queues the copy of n floats from device memory to shared memory, spread
// over the block's threads: 16 bytes a copy where both ends are 16-byte
// aligned and n is a multiple of 4 (always at H=64), else 4 bytes.
__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ src,
                                           int n) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) |
        static_cast<uintptr_t>(__cvta_generic_to_shared(dst))) & 15) == 0 &&
      (n & 3) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  }
}

// Zeroes rows valid..rows-1 of each of `slots` [rows][width] slots.
__device__ __forceinline__ void zero_tail_rows(float* p, int slots, int rows,
                                               int valid, int width) {
  const int tail = (rows - valid) * width;
  for (int idx = threadIdx.x; idx < slots * tail; idx += blockDim.x) {
    const int s = idx / tail;
    p[(s * rows + valid) * width + (idx - s * tail)] = 0.0f;
  }
}

// Zeroes rows 0..valid-1 of one [rows][width] slot (a step before the first).
__device__ __forceinline__ void zero_rows(float* p, int valid, int width) {
  for (int idx = threadIdx.x; idx < valid * width; idx += blockDim.x) p[idx] = 0.0f;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// The backward's chunk buffer, in floats: x [tc][rows][4H], dh [tc][rows][H],
// h [tc][rows][H] (h[t0 - 2] .. h[t0 + tc - 3]: the h[s-2] that the
// iteration of step s stages), c [tc + 1][rows][H] (c[t0 - 1] ..
// c[t0 + tc - 1]), rounded up to whole float4s.
__host__ __device__ __forceinline__ int bwd_buffer_floats(int hidden, int rows,
                                                          int tc) {
  return round4(tc * rows * 5 * hidden + (2 * tc + 1) * rows * hidden);
}

// Where dh, h and c start in a backward chunk buffer, in floats.
struct BwdSections {
  int dh, h, c;
};

__device__ __forceinline__ BwdSections bwd_sections(int hidden, int rows, int tc) {
  const int dh = tc * rows * 4 * hidden;
  return {dh, dh + tc * rows * hidden, dh + 2 * tc * rows * hidden};
}

// Floats a row of the forward's x chunk: 4H and 8 of padding, so that the
// 4 quarters of a warp, reading rows q (and q + 4) at 8 consecutive units,
// fall on distinct banks.
__host__ __device__ __forceinline__ int x_row(int hidden) { return 4 * hidden + 8; }

// x[t0 .. t0 + len) of the tile's valid rows into dst [len][ROWS][x_row],
// as one cp.async group, a warp a row: 16 bytes a copy where x and dst are
// 16-byte aligned (rows are 16 H bytes apart in x, 16 H + 32 in dst), else
// 4.
template <int ROWS>
__device__ __forceinline__ void stage_fwd_chunk(float* dst, const float* __restrict__ x,
                                                int t0, int len, int n_rows,
                                                int hidden, int tile0, int valid) {
  const int four_h = 4 * hidden;
  const int xr = x_row(hidden);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(x) |
        static_cast<uintptr_t>(__cvta_generic_to_shared(dst))) & 15) == 0;
  const int width = vec ? hidden : four_h;  // copies a row
  const float* src = x + (static_cast<size_t>(t0) * n_rows + tile0) * four_h;
  for (int kr = threadIdx.x >> 5; kr < len * ROWS; kr += blockDim.x >> 5) {
    const int k = kr / ROWS;
    const int r = kr - k * ROWS;
    if (r >= valid) continue;
    const float* from = src + (static_cast<size_t>(k) * n_rows + r) * four_h;
    float* to = dst + kr * xr;
    for (int e = threadIdx.x & 31; e < width; e += 32) {
      if (vec) {
        cp_async16(to + 4 * e, from + 4 * e);
      } else {
        cp_async4(to + e, from + e);
      }
    }
  }
  cp_async_commit();
}

// The planes of steps t0 .. t0 + len - 1 into the backward chunk buffer
// `base`, as one cp.async group: x and dh at t, h at t0 - 2 .. t0 + len - 3
// and c at t0 - 1 .. t0 + len - 1, read from the stash (zero before the
// first step).
__device__ __forceinline__ void stage_bwd_chunk(
    float* base, BwdSections at, const float* __restrict__ x,
    const float* __restrict__ dhs, const float* __restrict__ hs,
    const float* __restrict__ cs, int t0, int len, int n_rows, int rows,
    int hidden, int tile0, int valid) {
  const int four_h = 4 * hidden;
  const size_t tile_h = static_cast<size_t>(tile0) * hidden;
  for (int k = 0; k < len; ++k) {
    const size_t step = static_cast<size_t>(t0 + k) * n_rows;
    copy_async(base + k * rows * four_h, x + (step + tile0) * four_h,
               valid * four_h);
    copy_async(base + at.dh + k * rows * hidden, dhs + step * hidden + tile_h,
               valid * hidden);
  }
  for (int i = 0; i <= len; ++i) {
    const int steps[2] = {t0 - 1 + i, t0 - 2 + i};  // c, h
    float* const slots[2] = {base + at.c + i * rows * hidden,
                             base + at.h + i * rows * hidden};
    const float* const planes[2] = {cs, hs};
    for (int e = 0; e < 2; ++e) {
      if (e == 1 && i == len) break;  // no step reads h[t0 + len - 2]
      if (steps[e] < 0) {
        zero_rows(slots[e], valid, hidden);
      } else {
        copy_async(slots[e],
                   planes[e] + static_cast<size_t>(steps[e]) * n_rows * hidden + tile_h,
                   valid * hidden);
      }
    }
  }
  cp_async_commit();
}

// Two buffers of one h plane and two x chunk buffers: 34,432 bytes at
// H=64, 1 row, tc = 16; 224,768 at 8 rows, tc = 13.
size_t fwd_smem_bytes(int hidden, int rows, int tc) {
  return fwd_planes_bytes(hidden, rows, 1) +
         2 * static_cast<size_t>(tc) * rows * x_row(hidden) * sizeof(float);
}

// The weight and planes of the single-layer sweep, and two chunk buffers:
// 210,432 bytes at H=64, 8 rows, tc = 4.
size_t bwd_smem_bytes(int hidden, int rows, int tc) {
  return single_sweep_smem(hidden, rows) +
         2 * static_cast<size_t>(bwd_buffer_floats(hidden, rows, tc)) * sizeof(float);
}

// Forward. Replaces _tb_fwd_kernel (masters_thesis_tpu/ops/lstm_kernel.py).
// cs may be null (the forward-only caller does not keep c). Each step t is
// the forward step of lstm_fwd_step.cuh with one product, gates x[t] +
// h[t-1] @ w, its weight in registers: lane (j, q) holds the 16 x 4 floats
// of w it multiplies (load_quarter_weight), so a step reads only h, from
// the plane buffer t & 1, and x, from the chunk buffer, and writes h[t]
// into the other plane buffer; one barrier a step and one a chunk. Warps
// with 8 w >= p only take part in the barriers and the copies.
// Shared memory: two buffers of one h plane [ROWS][p + 16] floats, then
// two x chunk buffers [tc][ROWS][x_row].
template <int ROWS>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_tb_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ hs, float* __restrict__ cs, int n_t,
                   int n_rows, int hidden, int tc) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  const int xr = x_row(hidden);
  const FwdPlanes pl = fwd_planes(smem, p, ROWS, 1);
  float* x_s = pl.end();
  const int buf = tc * ROWS * xr;
  const int tile0 = blockIdx.x * ROWS;
  const int valid = min(ROWS, n_rows - tile0);
  const int n_chunks = (n_t + tc - 1) / tc;

  stage_fwd_chunk<ROWS>(x_s, x, 0, min(tc, n_t), n_rows, hidden, tile0, valid);
  pl.zero();
  zero_tail_rows(x_s, 2 * tc, ROWS, valid, xr);  // no copy writes them
  const FwdLane<ROWS> ln(n_rows, hidden, kq, tile0);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp
  float wr[kMaxHidden / 4][4];
  load_quarter_weight(w, hidden, kq, ln.q, ln.j, wr);

  float c[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) c[i] = 0.0f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * tc;
    const int len = min(tc, n_t - t0);
    const float* xb = x_s + (chunk & 1) * buf;
    cp_async_wait_all();
    // This chunk's x is in shared memory, and every thread is done with the
    // other buffer (last read in the previous chunk): refill it.
    __syncthreads();
    if (chunk + 1 < n_chunks) {
      stage_fwd_chunk<ROWS>(x_s + ((chunk + 1) & 1) * buf, x, t0 + tc,
                            min(tc, n_t - t0 - tc), n_rows, hidden, tile0, valid);
    }
    for (int k = 0; k < len; ++k) {
      const int t = t0 + k;
      if (active) {
        float acc[ROWS][4], add[1][4][NR], gates[1][4][NR], h[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float* xv = xb + (k * ROWS + ln.lrow[i]) * xr + ln.col;
#pragma unroll
          for (int g = 0; g < 4; ++g) add[0][g][i] = xv[g * hidden];
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
        register_gate_product<ROWS>(pl.at(t, 0), wr, kq, ln.q, acc);
        quarter_gates<ROWS, 1>(acc, ln.q, add, gates);
        cell_update(gates[0], c, h);
        ln.stage(h, pl.at(t + 1, 0), kq);
        ln.store(h, hs, t, n_rows, hidden);
        if (cs != nullptr) ln.store(c, cs, t, n_rows, hidden);
      }
      __syncthreads();  // the next buffer holds h[t] for every row of the tile
    }
  }
}

// This lane's entries of the tile's dw: dw[m][g] is dw[q kq + m][g H + j],
// the k of quarter q and the gates of unit j. dw += h[s]ᵀ d_pre[s+1] over the
// tile's rows, in the order 0 .. ROWS - 1; h_s holds h[s], dp_s d_pre[s+1].
template <int ROWS>
__device__ __forceinline__ void add_dw(const float* __restrict__ h_s,
                                       const float4* __restrict__ dp_s, int kq,
                                       int q, int j, float (&dw)[kMaxHidden / 4][4]) {
  const int h0 = q * (kq + 4);
  const int dpc = dp_col(j, kq);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float4 d = dp_s[r * (4 * kq + 4) + dpc];
#pragma unroll
    for (int m = 0; m < kMaxHidden / 4; m += 4) {
      if (m >= kq) break;
      const float4 h4 =
          *reinterpret_cast<const float4*>(h_s + r * (4 * kq + 16) + h0 + m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = lane(h4, e);
        dw[m + e][0] = fmaf(h, d.x, dw[m + e][0]);
        dw[m + e][1] = fmaf(h, d.y, dw[m + e][1]);
        dw[m + e][2] = fmaf(h, d.z, dw[m + e][2]);
        dw[m + e][3] = fmaf(h, d.w, dw[m + e][3]);
      }
    }
  }
}

// v[i] = slot k of a [tc][ROWS][H] section for row q + 4 i and unit j, zero
// past the tile or for j >= H.
template <int ROWS>
__device__ __forceinline__ void owned_from(const float* section, int k,
                                           int hidden, int q, int j,
                                           float (&v)[(ROWS + 3) / 4]) {
#pragma unroll
  for (int i = 0; i < (ROWS + 3) / 4; ++i) {
    const int lrow = q + 4 * i;
    v[i] = lrow < ROWS && j < hidden ? section[(k * ROWS + lrow) * hidden + j] : 0.0f;
  }
}

// Backward. Replaces _tb_bwd_kernel (masters_thesis_tpu/ops/lstm_kernel.py):
// chunks in reverse, t = T-1 .. 0 within each, gates recomputed from
// x[t] + h[t-1] @ w, d_pre written into dx[t], dw += h[t-1]ᵀ d_pre[t] over
// the tile's rows; the tile's dw goes to dw_part[blockIdx.x] (H, 4H).
// Iteration s is lstm_bwd_kernel's (lstm_bwd.cu), the same single_sweep_step
// on the same tile (sweep_rows), so dx is bit-equal to it; its operands
// come from the chunk buffer instead of device memory, and after the step
// each lane adds d_pre[s+1]'s rows into its 64 dw entries, kept in
// registers: no shared dw, no barrier for it, no atomics. (Placed after the
// step, the update's FMAs fill the step's serial tail: 4-5% faster at 100
// rows than before it, on an H100.)
// Shared memory: w_s [p][p + 1] float4, the planes of single_planes, then
// two chunk buffers (bwd_buffer_floats).
template <int ROWS>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_tb_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ x,
                   const float* __restrict__ hs, const float* __restrict__ cs,
                   const float* __restrict__ w, float* __restrict__ dx,
                   float* __restrict__ dw_part, int n_t, int n_rows, int hidden,
                   int tc) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  const int four_h = 4 * hidden;
  float4* w_s = smem;
  const SinglePlanes pl = single_planes(w_s + p * (p + 1), p, ROWS);
  float* stage_s = pl.h + 3 * pl.h_size;
  const int buf = bwd_buffer_floats(hidden, ROWS, tc);
  const BwdSections at = bwd_sections(hidden, ROWS, tc);
  const int tile0 = blockIdx.x * ROWS;
  const int valid = min(ROWS, n_rows - tile0);
  const int n_chunks = (n_t + tc - 1) / tc;
  const int last0 = (n_chunks - 1) * tc;

  stage_bwd_chunk(stage_s + ((n_chunks - 1) & 1) * buf, at, x, dhs, hs, cs,
                  last0, n_t - last0, n_rows, ROWS, hidden, tile0, valid);
  stage_weight_padded(w, w_s, hidden, p);
  for (int idx = threadIdx.x; idx < 2 * pl.dp_size; idx += blockDim.x) {
    pl.dp[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // d_pre[T] is zero
  }
  // The plane of h[T-1], which the first dw update reads (times the zero
  // d_pre[T]) before any step writes it: zero, not what an earlier kernel
  // left in shared memory (0 x NaN is NaN).
  float* const h_last = pl.h_of(n_t - 1);
  for (int idx = threadIdx.x; idx < pl.h_size; idx += blockDim.x) h_last[idx] = 0.0f;
  for (int b = 0; b < 2; ++b) {  // no copy writes the rows past the last
    float* base = stage_s + b * buf;
    zero_tail_rows(base, tc, ROWS, valid, four_h);
    zero_tail_rows(base + at.dh, 3 * tc + 1, ROWS, valid, hidden);
  }
  const int q = (threadIdx.x & 31) >> 3;
  const int j = (threadIdx.x >> 5) * 8 + (threadIdx.x & 7);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp

  // h[T-2] into its plane.
  float hv[NR], dc[NR];
  load_owned<ROWS>(hs, n_t - 2, n_t, n_rows, hidden, tile0, q, j, hv);
  if (active) stage_h<ROWS>(hv, pl.h_of(n_t - 2), kq, q, j);
  float dw[kMaxHidden / 4][4];
#pragma unroll
  for (int m = 0; m < kMaxHidden / 4; ++m)
#pragma unroll
    for (int g = 0; g < 4; ++g) dw[m][g] = 0.0f;
#pragma unroll
  for (int i = 0; i < NR; ++i) dc[i] = 0.0f;

  for (int chunk = n_chunks - 1; chunk >= 0; --chunk) {
    const int t0 = chunk * tc;
    const int len = min(tc, n_t - t0);
    const float* base = stage_s + (chunk & 1) * buf;
    cp_async_wait_all();
    // This chunk's planes are in shared memory, and every thread is done
    // with the other buffer (last read in the chunk after this one).
    __syncthreads();
    if (chunk > 0) {
      stage_bwd_chunk(stage_s + ((chunk - 1) & 1) * buf, at, x, dhs, hs, cs,
                      t0 - tc, tc, n_rows, ROWS, hidden, tile0, valid);
    }
    for (int k = len - 1; k >= 0; --k) {
      const int s = t0 + k;
      float xv[4][NR], cv[NR], cpv[NR], dhv[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int lrow = q + 4 * i;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          xv[g][i] = lrow < ROWS && j < hidden
                         ? base[(k * ROWS + lrow) * four_h + g * hidden + j]
                         : 0.0f;
        }
      }
      owned_from<ROWS>(base + at.dh, k, hidden, q, j, dhv);
      owned_from<ROWS>(base + at.c, k + 1, hidden, q, j, cv);
      owned_from<ROWS>(base + at.c, k, hidden, q, j, cpv);
      owned_from<ROWS>(base + at.h, k, hidden, q, j, hv);  // h[s-2]
      if (active) {
        float d[4][NR];
        single_sweep_step<ROWS>(pl.h_of(s - 1), pl.d_pre(s + 1), w_s, kq, q, j,
                                xv, cv, cpv, dhv, dc, d);
        // Unconditional: d_pre[T] and the plane of h[T-1] are zeroed
        // above, so the first iteration adds 0.
        add_dw<ROWS>(pl.h_of(s), pl.d_pre(s + 1), kq, q, j, dw);
        single_sweep_store<ROWS>(d, hv, dx, s, n_rows, hidden, tile0, q, j, kq,
                                 pl.d_pre(s), pl.h_of(s - 2));
      }
      __syncthreads();  // d_pre[s] and h[s-2] are in their planes
    }
  }
  if (!active || j >= hidden) return;
  float* out = dw_part + static_cast<size_t>(blockIdx.x) * hidden * four_h + j;
#pragma unroll
  for (int m = 0; m < kMaxHidden / 4; ++m) {
    const int kk = q * kq + m;
    if (m < kq && kk < hidden) {
#pragma unroll
      for (int g = 0; g < 4; ++g) out[kk * four_h + g * hidden] = dw[m][g];
    }
  }
}

// The longest chunk, at most kMaxChunk steps and n_t, whose shared memory
// (smem(tc)) fits the block's opt-in limit.
template <typename Smem>
cudaError_t time_chunk(int n_t, int device, Smem smem, int* tc) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int c = n_t < kMaxChunk ? n_t : kMaxChunk;
  while (c > 1 && smem(c) > static_cast<size_t>(limit)) --c;
  if (smem(c) > static_cast<size_t>(limit)) return cudaErrorInvalidConfiguration;
  *tc = c;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int lstm_tb_max_hidden() { return kMaxHidden; }

// Every entry point takes the CUDA device index of its pointers and stream:
// this library links its own CUDA runtime, whose current device is set here.

// Row tiles of n_rows rows: the number of dw partials lstm_tb_bwd writes.
int lstm_tb_row_tiles(int n_rows, int device, int* tiles) {
  if (n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = sweep_rows(n_rows, device, &rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tiles = ceil_div(n_rows, rows);
  return 0;
}

// The time chunk the forward (backward = 0) or the backward would take.
int lstm_tb_time_chunk(int n_t, int n_rows, int hidden, int backward, int device,
                       int* tc) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0;  // the row tile, the same forward and backward
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = sweep_rows(n_rows, device, &rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(time_chunk(n_t, device, [&](int c) {
    return backward ? bwd_smem_bytes(hidden, rows, c) : fwd_smem_bytes(hidden, rows, c);
  }, tc));
}

// hs (T, B, H) and optional cs (T, B, H) from x (T, B, 4H), w_t (H, 4H).
int lstm_tb_fwd(const float* x, const float* w_t, float* hs, float* cs, int n_t,
                int n_rows, int hidden, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    int tc = 0;
    const cudaError_t err = time_chunk(n_t, device, [&](int c) {
      return fwd_smem_bytes(hidden, kRows, c);
    }, &tc);
    if (err != cudaSuccess) return err;
    return launch_sweep(lstm_tb_fwd_kernel<kRows>, n_rows, kRows,
                        fwd_smem_bytes(hidden, kRows, tc), stream, x, w_t, hs,
                        cs, n_t, n_rows, hidden, tc);
  }));
}

// dx = d_pre (T, B, 4H) and dw_part (tiles, H, 4H), one recurrent weight
// gradient partial per row tile (lstm_tb_row_tiles), from dhs, hs, cs
// (T, B, H), x (T, B, 4H) and w_t (H, 4H).
int lstm_tb_bwd(const float* dhs, const float* x, const float* hs, const float* cs,
                const float* w_t, float* dx, float* dw_part, int n_t, int n_rows,
                int hidden, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_sweep_rows(n_rows, device, [&](auto rows_c) {
    constexpr int kRows = decltype(rows_c)::value;
    int tc = 0;
    const cudaError_t err = time_chunk(n_t, device, [&](int c) {
      return bwd_smem_bytes(hidden, kRows, c);
    }, &tc);
    if (err != cudaSuccess) return err;
    return launch_sweep(lstm_tb_bwd_kernel<kRows>, n_rows, kRows,
                        bwd_smem_bytes(hidden, kRows, tc), stream, dhs, x, hs,
                        cs, w_t, dx, dw_part, n_t, n_rows, hidden, tc);
  }));
}

}  // extern "C"
