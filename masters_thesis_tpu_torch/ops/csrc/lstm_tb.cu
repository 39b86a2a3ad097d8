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
// blocks; here the chunk's copy simply starts one step earlier in the stash.
//
// What bounds them on this card. Each step is a (rows, H) @ (H, 4H) product
// (and, backward, its transpose and the rank-rows dw update) whose next step
// needs this step's h or dh: a chain of T dependent steps; rows are
// independent. At T=252, 100 rows, H=64 the forward does 826 MFLOP of f32
// products over 39 MB (x in; h, c out): 12.3 us by f32 arithmetic (no TF32,
// to keep the JAX package's f32 numerics), 11.6 us by bytes; the backward
// three products a step, 37 us by arithmetic. The step chain's latency, not
// either roofline term, limits both.
//
// What the design does about it. The per-step arithmetic is the resident
// kernels' own (lstm_fwd.cu, lstm_bwd.cu, through lstm_common.cuh): the
// weight staged once in shared memory as one float4 of the four gates per
// (k, j), thread (group, j) owning hidden unit j of its rows, h (and d_pre)
// through shared memory, c, dh and dc in registers, the row tile (2, 4 or 8
// rows) the smallest that keeps the grid in one wave. So the forward's h and
// c and the backward's dx are bit-equal to those kernels'; the chunked copy
// takes every load of the step chain off device memory. The backward keeps
// the tile's dw (64 KiB at H=64) in shared memory: thread (group, j) owns
// the four gates of unit j for half of the k rows, so the update needs no
// exchange and no atomics, and a run repeats bit for bit. The chunk length
// is the longest (at most kMaxChunk steps) whose two buffers fit the block's
// shared memory beside the weight (and dw): at H=64, 8-row tiles, 10 steps
// forward and 2 backward; at 2-row tiles 16 and 13. The ragged last chunk
// and the ragged last row tile are masked, not padded: rows past the last
// stay zero in shared memory, so their d_pre is zero and adds nothing to dw.
// Accurate expf/tanhf, no fast math.

#include <cstdint>

#include "lstm_common.cuh"

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
// h [tc][rows][H] (h[t-1] of the chunk's steps), c [tc + 1][rows][H]
// (c[t0 - 1] .. c[t0 + tc - 1]), rounded up to whole float4s.
__host__ __device__ __forceinline__ int bwd_buffer_floats(int hidden, int rows,
                                                          int tc) {
  return round4(tc * rows * 6 * hidden + (tc + 1) * rows * hidden);
}

// Where dh, h and c start in a backward chunk buffer, in floats.
struct BwdSections {
  int dh, h, c;
};

__device__ __forceinline__ BwdSections bwd_sections(int hidden, int rows, int tc) {
  const int dh = tc * rows * 4 * hidden;
  return {dh, dh + tc * rows * hidden, dh + 2 * tc * rows * hidden};
}

// x[t0 .. t0 + len) of the tile's rows into dst [len][rows][4H], as one
// cp.async group; a step's rows are contiguous in x.
__device__ __forceinline__ void stage_fwd_chunk(float* dst, const float* __restrict__ x,
                                                int t0, int len, int n_rows,
                                                int rows, int four_h, int tile0,
                                                int valid) {
  for (int k = 0; k < len; ++k) {
    copy_async(dst + k * rows * four_h,
               x + (static_cast<size_t>(t0 + k) * n_rows + tile0) * four_h,
               valid * four_h);
  }
  cp_async_commit();
}

// The planes of steps t0 .. t0 + len - 1 into the backward chunk buffer
// `base`, as one cp.async group: x and dh at t, h at t - 1 and c at
// t0 - 1 .. t0 + len - 1, read from the stash (zero before the first step).
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
    const int t = t0 - 1 + i;
    float* c_slot = base + at.c + i * rows * hidden;
    float* h_slot = base + at.h + i * rows * hidden;  // a slot for i < len
    if (t < 0) {
      zero_rows(c_slot, valid, hidden);
      zero_rows(h_slot, valid, hidden);
      continue;
    }
    const size_t from = static_cast<size_t>(t) * n_rows * hidden + tile_h;
    copy_async(c_slot, cs + from, valid * hidden);
    if (i < len) copy_async(h_slot, hs + from, valid * hidden);
  }
  cp_async_commit();
}

size_t fwd_smem_bytes(int hidden, int rpt, int tc) {
  const size_t kp = padded(hidden);
  const size_t rows = kGroups * rpt;
  return (kp * hidden * 4 + rows * kp + 2 * tc * rows * 4 * hidden) * sizeof(float);
}

size_t bwd_smem_bytes(int hidden, int rpt, int tc) {
  const size_t kp = padded(hidden);
  const size_t rows = kGroups * rpt;
  return (kp * hidden * 4 + static_cast<size_t>(hidden) * hidden * 4 +
          rows * hidden * 4 + 2 * rows * kp +
          2 * static_cast<size_t>(bwd_buffer_floats(hidden, rows, tc))) *
         sizeof(float);
}

// Forward. Replaces _tb_fwd_kernel (masters_thesis_tpu/ops/lstm_kernel.py).
// cs may be null (the forward-only caller does not keep c).
// Shared memory: w_s [padded(H)][H] float4, h_s [rows][padded(H)], then two
// x buffers [tc][rows][4H].
template <int RPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_tb_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ hs, float* __restrict__ cs, int n_t,
                   int n_rows, int hidden, int tc) {
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  const int four_h = 4 * hidden;
  float4* w_s = smem;
  float4* h_s4 = w_s + kp * hidden;
  float* h_s = reinterpret_cast<float*>(h_s4);
  float* x_s = h_s + rows * kp;
  const int buf = tc * rows * four_h;
  const int tile0 = blockIdx.x * rows;
  const int valid = min(rows, n_rows - tile0);
  const int n_chunks = (n_t + tc - 1) / tc;

  stage_fwd_chunk(x_s, x, 0, min(tc, n_t), n_rows, rows, four_h, tile0, valid);
  stage_weight(w, w_s, hidden);
  for (int idx = threadIdx.x; idx < rows * kp; idx += blockDim.x) h_s[idx] = 0.0f;
  zero_tail_rows(x_s, 2 * tc, rows, valid, four_h);  // no copy writes them
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = tile0 + lrow0;
  const float4* const h_in[1] = {h_s4};
  const float4* const w_in[1] = {w_s};

  float c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = 0.0f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * tc;
    const int len = min(tc, n_t - t0);
    const float* xb = x_s + (chunk & 1) * buf;
    cp_async_wait_all();
    // This chunk's x is in shared memory, and every thread is done with the
    // other buffer (last read in the previous chunk): refill it.
    __syncthreads();
    if (chunk + 1 < n_chunks) {
      stage_fwd_chunk(x_s + ((chunk + 1) & 1) * buf, x, t0 + tc,
                      min(tc, n_t - t0 - tc), n_rows, rows, four_h, tile0, valid);
    }
    for (int k = 0; k < len; ++k) {
      const int t = t0 + k;
      float acc[1][4][RPT];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[0][g][r] = xb[(k * rows + lrow0 + r) * four_h + g * hidden + j];
        }
      gate_products<RPT, 1>(h_in, w_in, lrow0, hidden, j, acc);
      float h[RPT];
      cell_update(acc[0], c, h);
      __syncthreads();  // every thread has finished reading h_s for step t
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        h_s[(lrow0 + r) * kp + j] = h[r];
        const int row = row0 + r;
        if (row < n_rows) {
          const size_t out = (static_cast<size_t>(t) * n_rows + row) * hidden + j;
          hs[out] = h[r];
          if (cs != nullptr) cs[out] = c[r];
        }
      }
      __syncthreads();  // h_s holds step t for every row of the tile
    }
  }
}

// Backward. Replaces _tb_bwd_kernel (masters_thesis_tpu/ops/lstm_kernel.py):
// chunks in reverse, t = T-1 .. 0 within each, gates recomputed from
// x[t] + h[t-1] @ w, d_pre written into dx[t], dw += h[t-1]ᵀ d_pre[t] over
// the tile's rows; the tile's dw goes to dw_part[blockIdx.x] (H, 4H).
// Shared memory: w_s [padded(H)][H] float4; dw_s [H][H] float4 (the gates of
// unit j at k); dp_s [rows][H] float4; hp_s two [rows][padded(H)] (h[t-1],
// by the parity of t: the dw update still reads step t's while step t-1
// writes its own); then two chunk buffers (bwd_buffer_floats).
template <int RPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_tb_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ x,
                   const float* __restrict__ hs, const float* __restrict__ cs,
                   const float* __restrict__ w, float* __restrict__ dx,
                   float* __restrict__ dw_part, int n_t, int n_rows, int hidden,
                   int tc) {
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  const int four_h = 4 * hidden;
  float4* w_s = smem;
  float4* dw_s = w_s + kp * hidden;
  float4* dp_s = dw_s + hidden * hidden;
  float* hp_s = reinterpret_cast<float*>(dp_s + rows * hidden);
  float* stage_s = hp_s + 2 * rows * kp;
  const int buf = bwd_buffer_floats(hidden, rows, tc);
  const BwdSections at = bwd_sections(hidden, rows, tc);
  const int tile0 = blockIdx.x * rows;
  const int valid = min(rows, n_rows - tile0);
  const int n_chunks = (n_t + tc - 1) / tc;
  const int last0 = (n_chunks - 1) * tc;

  stage_bwd_chunk(stage_s + ((n_chunks - 1) & 1) * buf, at, x, dhs, hs, cs,
                  last0, n_t - last0, n_rows, rows, hidden, tile0, valid);
  stage_weight(w, w_s, hidden);
  for (int idx = threadIdx.x; idx < hidden * hidden; idx += blockDim.x) {
    dw_s[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int idx = threadIdx.x; idx < 2 * rows * kp; idx += blockDim.x) {
    hp_s[idx] = 0.0f;  // the padded k columns stay zero
  }
  for (int b = 0; b < 2; ++b) {  // no copy writes the rows past the last
    float* base = stage_s + b * buf;
    zero_tail_rows(base, tc, rows, valid, four_h);
    zero_tail_rows(base + at.dh, 3 * tc + 1, rows, valid, hidden);
  }
  const int j = threadIdx.x % hidden;
  const int group = threadIdx.x / hidden;
  const int lrow0 = group * RPT;
  const int row0 = tile0 + lrow0;
  // This thread's rows k of dw (the four gates of unit j at each).
  const int k_half = (hidden + kGroups - 1) / kGroups;
  const int k_begin = group * k_half;
  const int k_end = min(hidden, k_begin + k_half);
  const float4* const w_in[1] = {w_s};
  const float4* const dp_in[1] = {dp_s};

  float dh_rec[RPT], dc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dh_rec[r] = dc[r] = 0.0f;

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
                      t0 - tc, tc, n_rows, rows, hidden, tile0, valid);
    }
    for (int k = len - 1; k >= 0; --k) {
      const int t = t0 + k;
      float* hp = hp_s + (t & 1) * rows * kp;
      float acc[1][4][RPT], cv[RPT], cp[RPT], dhv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int e = (k * rows + lrow0 + r) * hidden + j;
        hp[(lrow0 + r) * kp + j] = base[at.h + e];
        cp[r] = base[at.c + e];
        cv[r] = base[at.c + rows * hidden + e];
        dhv[r] = base[at.dh + e];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[0][g][r] = base[(k * rows + lrow0 + r) * four_h + g * hidden + j];
        }
      }
      __syncthreads();  // hp holds h[t-1]
      const float4* const h_in[1] = {reinterpret_cast<const float4*>(hp)};
      gate_products<RPT, 1>(h_in, w_in, lrow0, hidden, j, acc);
      float dh[RPT], d[4][RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) dh[r] = dhv[r] + dh_rec[r];
      cell_backward(acc[0], cv, cp, dh, dc, d);
      store_d_pre(d, true, dx, t, n_rows, hidden, row0, lrow0, j, dp_s);
      __syncthreads();  // dp_s holds this step's d_pre rows

      float tr[1][RPT];
      transposed_products<RPT, 1>(dp_in, w_in, lrow0, hidden, j, tr);
#pragma unroll
      for (int r = 0; r < RPT; ++r) dh_rec[r] = tr[0][r];
      // dw[k][g*H + j] += sum over the tile's rows of h[t-1][k] d_pre[t][g*H + j],
      // at most four rows a pass (their d_pre in registers, no spills).
      constexpr int kDwRows = kGroups * RPT < 4 ? kGroups * RPT : 4;
#pragma unroll 1
      for (int r0 = 0; r0 < kGroups * RPT; r0 += kDwRows) {
        float4 dpv[kDwRows];
#pragma unroll
        for (int rr = 0; rr < kDwRows; ++rr) dpv[rr] = dp_s[(r0 + rr) * hidden + j];
        for (int kk = k_begin; kk < k_end; ++kk) {
          float4 s = dw_s[kk * hidden + j];
#pragma unroll
          for (int rr = 0; rr < kDwRows; ++rr) {
            const float hk = hp[(r0 + rr) * kp + kk];
            s.x = fmaf(hk, dpv[rr].x, s.x);
            s.y = fmaf(hk, dpv[rr].y, s.y);
            s.z = fmaf(hk, dpv[rr].z, s.z);
            s.w = fmaf(hk, dpv[rr].w, s.w);
          }
          dw_s[kk * hidden + j] = s;
        }
      }
    }
  }
  // Each thread wrote only its own dw_s entries: no barrier needed.
  float* out = dw_part + static_cast<size_t>(blockIdx.x) * hidden * four_h;
  for (int kk = k_begin; kk < k_end; ++kk) {
    const float4 s = dw_s[kk * hidden + j];
    float* o = out + kk * four_h + j;
    o[0] = s.x;
    o[hidden] = s.y;
    o[2 * hidden] = s.z;
    o[3 * hidden] = s.w;
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
  int rpt = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = rows_per_thread(n_rows, device, &rpt);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tiles = (n_rows + kGroups * rpt - 1) / (kGroups * rpt);
  return 0;
}

// The time chunk the forward (backward = 0) or the backward would take.
int lstm_tb_time_chunk(int n_t, int n_rows, int hidden, int backward, int device,
                       int* tc) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  int rpt = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = rows_per_thread(n_rows, device, &rpt);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(time_chunk(n_t, device, [&](int c) {
    return backward ? bwd_smem_bytes(hidden, rpt, c) : fwd_smem_bytes(hidden, rpt, c);
  }, tc));
}

// hs (T, B, H) and optional cs (T, B, H) from x (T, B, 4H), w_t (H, 4H).
int lstm_tb_fwd(const float* x, const float* w_t, float* hs, float* cs, int n_t,
                int n_rows, int hidden, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_rpt(n_rows, device, [&](auto rpt_c) {
    constexpr int kRpt = decltype(rpt_c)::value;
    int tc = 0;
    const cudaError_t err = time_chunk(n_t, device, [&](int c) {
      return fwd_smem_bytes(hidden, kRpt, c);
    }, &tc);
    if (err != cudaSuccess) return err;
    return launch(lstm_tb_fwd_kernel<kRpt>, n_rows, hidden, kRpt,
                  fwd_smem_bytes(hidden, kRpt, tc), stream, x, w_t, hs, cs, n_t,
                  n_rows, hidden, tc);
  }));
}

// dx = d_pre (T, B, 4H) and dw_part (tiles, H, 4H), one recurrent weight
// gradient partial per row tile (lstm_tb_row_tiles), from dhs, hs, cs
// (T, B, H), x (T, B, 4H) and w_t (H, 4H).
int lstm_tb_bwd(const float* dhs, const float* x, const float* hs, const float* cs,
                const float* w_t, float* dx, float* dw_part, int n_t, int n_rows,
                int hidden, int device, cudaStream_t stream) {
  if (bad_shape(n_t, n_rows, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_rpt(n_rows, device, [&](auto rpt_c) {
    constexpr int kRpt = decltype(rpt_c)::value;
    int tc = 0;
    const cudaError_t err = time_chunk(n_t, device, [&](int c) {
      return bwd_smem_bytes(hidden, kRpt, c);
    }, &tc);
    if (err != cudaSuccess) return err;
    return launch(lstm_tb_bwd_kernel<kRpt>, n_rows, hidden, kRpt,
                  bwd_smem_bytes(hidden, kRpt, tc), stream, dhs, x, hs, cs, w_t,
                  dx, dw_part, n_t, n_rows, hidden, tc);
  }));
}

}  // extern "C"
