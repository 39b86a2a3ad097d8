// The 256-thread backward sweeps: helpers shared by the pair's sweep
// (lstm_pair_bwd_kernel, lstm_bwd.cu) and the two single-layer sweeps
// (lstm_bwd_kernel, lstm_bwd.cu; lstm_tb_bwd_kernel, lstm_tb.cu), and the
// one step both single-layer sweeps run, so that their dx is bit-equal.
//
// A block of 256 threads (8 warps) owns a tile of 1, 2, 4 or 8 rows
// (sweep_rows). Lane u + 8 q of warp w serves unit (or, in a transposed
// product, k) j = 8 w + u and quarter q of the contraction for all the
// tile's rows, so each staged weight float4 is read by one lane a product
// and step; warp shuffles sum the quarters, after which the lane owns rows
// q, q + 4 of unit j. Operand planes pad between the quarters (h_col,
// dp_col) so that a warp's 4 quarters read distinct bank slots.

#pragma once

#include <mutex>
#include <type_traits>
#include <vector>

#include "lstm_common.cuh"

namespace {

constexpr int kSweepThreads = 256;  // 8 warps: 8 units x 4 quarters a warp
constexpr int kSweepMaxRows = 8;    // the largest row tile

// The contraction padded to 4 quarters of a multiple of 4 (zero weights and
// zero operands beyond H), so that every lane reads its quarter 4 at a time.
__host__ __device__ __forceinline__ int sweep_pad(int hidden) {
  return (hidden + 15) & ~15;
}

// w (H, 4H) row-major in device memory -> w_s[k * (p + 1) + j] = the four
// gate weights of unit j at k, for k, j < p = sweep_pad(H), zero beyond H.
// The row stride p + 1 (odd) puts the 8 lanes of a quarter-warp on 8
// distinct bank slots whether they walk j (gate products) or k (transposed
// products) with the other index fixed. A bf16 weight is staged in f32.
template <typename T>
__device__ void stage_weight_padded(const T* __restrict__ w, float4* w_s,
                                    int hidden, int p) {
  const int four_h = 4 * hidden;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < p * p; idx += blockDim.x) {
    const int k = idx / p;
    const int j = idx - k * p;
    const T* src = w + k * four_h + j;
    w_s[k * (p + 1) + j] =
        k < hidden && j < hidden
            ? make_float4(load_f32(src), load_f32(src + hidden),
                          load_f32(src + 2 * hidden), load_f32(src + 3 * hidden))
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Where unit k sits in a row of an h plane (floats): quarter k / kq starts at
// (k / kq) * (kq + 4), so the 4 quarters' float4 reads of a warp fall on
// distinct bank slots.
__device__ __forceinline__ int h_col(int k, int kq) { return k + (k / kq) * 4; }

// Where unit j sits in a row of a d_pre plane (float4): quarter j / kq starts
// at (j / kq) * (kq + 1), for the same reason.
__device__ __forceinline__ int dp_col(int j, int kq) { return j + j / kq; }

// v[r] = plane[t][tile0 + q + 4 i][j] for the rows i a lane owns (q + 4 i <
// ROWS), zero outside the plane, past the tile or for j >= H; in f32
// whatever the plane's type.
template <int ROWS, typename T>
__device__ __forceinline__ void load_owned(const T* __restrict__ plane,
                                           int t, int n_t, int n_rows,
                                           int hidden, int tile0, int q, int j,
                                           float (&v)[(ROWS + 3) / 4]) {
  const bool in = t >= 0 && t < n_t && j < hidden;
#pragma unroll
  for (int i = 0; i < (ROWS + 3) / 4; ++i) {
    const int lrow = q + 4 * i;
    const int row = tile0 + lrow;
    v[i] = in && lrow < ROWS && row < n_rows
               ? load_f32(plane + (static_cast<size_t>(t) * n_rows + row) * hidden + j)
               : 0.0f;
  }
}

// xv[g][i] = x[t][tile0 + q + 4 i][g * H + j], as load_owned.
template <int ROWS, typename T>
__device__ __forceinline__ void load_owned_x(const T* __restrict__ x, int t,
                                             int n_t, int n_rows, int hidden,
                                             int tile0, int q, int j,
                                             float (&xv)[4][(ROWS + 3) / 4]) {
  const bool in = t >= 0 && t < n_t && j < hidden;
  const int four_h = 4 * hidden;
#pragma unroll
  for (int i = 0; i < (ROWS + 3) / 4; ++i) {
    const int lrow = q + 4 * i;
    const int row = tile0 + lrow;
    const bool ok = in && lrow < ROWS && row < n_rows;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      xv[g][i] = ok ? load_f32(x + (static_cast<size_t>(t) * n_rows + row) * four_h +
                               g * hidden + j)
                    : 0.0f;
    }
  }
}

// Sums v over the 4 quarter lanes of a unit (lane bits 3 and 4); afterwards
// lane q holds in out[i] the sum for row q + 4 i. From 4 rows on a
// reduce-scatter (each lane sends the half it does not keep, twice); for 1
// or 2 rows a butterfly, and lane q < ROWS keeps row q. The whole warp calls.
template <int ROWS, int N>
__device__ __forceinline__ void quarter_sum(float (&v)[ROWS][N], int q,
                                            float (&out)[(ROWS + 3) / 4][N]) {
  constexpr unsigned kAll = 0xffffffffu;
  if constexpr (ROWS >= 4) {
    const bool b1 = q & 2;
#pragma unroll
    for (int a = 0; a < ROWS; a += 4)
#pragma unroll
      for (int r = a; r < a + 2; ++r)
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float send = b1 ? v[r][n] : v[r + 2][n];
          const float keep = b1 ? v[r + 2][n] : v[r][n];
          v[r][n] = keep + __shfl_xor_sync(kAll, send, 16);
        }
    const bool b0 = q & 1;
#pragma unroll
    for (int a = 0; a < ROWS; a += 4)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float send = b0 ? v[a][n] : v[a + 1][n];
        const float keep = b0 ? v[a + 1][n] : v[a][n];
        out[a / 4][n] = keep + __shfl_xor_sync(kAll, send, 8);
      }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float s = v[r][n];
        s += __shfl_xor_sync(kAll, s, 8);
        s += __shfl_xor_sync(kAll, s, 16);
        v[r][n] = s;
      }
#pragma unroll
    for (int n = 0; n < N; ++n) out[0][n] = q == 1 ? v[ROWS - 1][n] : v[0][n];
  }
}

// This lane's share of L gate products h @ w for unit j: acc[r][4 o + g] +=
// sum over k in quarter q of h_s[l][r][k] * w_s[l][k][j].g, product l adding
// into output o = min(l, O - 1). Each staged weight float4 is read by one
// lane of the block; the 8 lanes of a quarter-warp read 8 consecutive j.
template <int ROWS, int L, int O>
__device__ __forceinline__ void quarter_gate_products(
    const float* const (&h_s)[L], const float4* const (&w_s)[L], int kq,
    int h_row, int q, int j, float (&acc)[ROWS][4 * O]) {
  const int stride = 4 * kq + 1;
  const int h0 = q * (kq + 4);
#pragma unroll 4
  for (int m = 0; m < kq; m += 4) {
    const int k0 = q * kq + m;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      constexpr int kLast = O - 1;
      const int o = l < kLast ? l : kLast;
      float4 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = w_s[l][(k0 + e) * stride + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 h4 =
            *reinterpret_cast<const float4*>(h_s[l] + r * h_row + h0 + m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = lane(h4, e);
          acc[r][4 * o + 0] = fmaf(h, w[e].x, acc[r][4 * o + 0]);
          acc[r][4 * o + 1] = fmaf(h, w[e].y, acc[r][4 * o + 1]);
          acc[r][4 * o + 2] = fmaf(h, w[e].z, acc[r][4 * o + 2]);
          acc[r][4 * o + 3] = fmaf(h, w[e].w, acc[r][4 * o + 3]);
        }
      }
    }
  }
}

// This lane's share of L transposed products d_pre @ wᵀ for unit k:
// out[r][l] = sum over j in quarter q, g of dp_s[l][r][j].g * w_s[l][k][j].g.
// Each staged weight float4 is read by one lane; the 8 lanes of a
// quarter-warp read 8 rows k (p + 1 apart) and share one d_pre read.
template <int ROWS, int L>
__device__ __forceinline__ void quarter_transposed_products(
    const float4* const (&dp_s)[L], const float4* const (&w_s)[L], int kq,
    int dp_row, int q, int k, float (&out)[ROWS][L]) {
  const int stride = 4 * kq + 1;
  const int d0 = q * (kq + 1);
  const int w0 = k * stride + q * kq;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int l = 0; l < L; ++l) out[r][l] = 0.0f;
#pragma unroll 8
  for (int m = 0; m < kq; ++m) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 w = w_s[l][w0 + m];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 d = dp_s[l][r * dp_row + d0 + m];
        float s = out[r][l];
        s = fmaf(d.x, w.x, s);
        s = fmaf(d.y, w.y, s);
        s = fmaf(d.z, w.z, s);
        s = fmaf(d.w, w.w, s);
        out[r][l] = s;
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Rows a block of the 256-thread sweeps: the smallest of 1, 2, 4, 8 whose grid
// fits one wave of SMs. A block reads its staged weights once a product and
// step whatever its rows, so the tile only sets how many SMs work.
//
// A replica-axis launch (grid.y = replicas) must give each replica the bits
// of its solo launch, and a row's bits are the same only at 1 and 2 rows:
// below 4 rows quarter_sum adds a unit's quarters by a butterfly, (q0 + q1)
// + (q2 + q3), and the sweeps split their transposed products into a chain
// a gate; from 4 rows the reduce-scatter adds (q0 + q2) + (q1 + q3); and
// the card tests found 4 and 8 rows apart as well (the pair's kernels, and
// the single layer's forward, whose code is the same at both). So R replicas
// whose solo tile is 1 or 2 rows take the smaller of 1 and 2 whose grid of
// R x row tiles fits one wave, else 2; a solo tile of 4 or 8 rows stays:
// R = 8 replicas of 100 rows (solo: 1-row tiles) take 2-row tiles, 400
// blocks, about three waves, where 8-row tiles would be one of 104.
constexpr int kButterflyMaxRows = 2;

cudaError_t sweep_rows(int n_rows, int device, int* rows, int replicas = 1) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const auto fits = [&](int r, int copies) {
    return static_cast<long long>(copies) * ceil_div(n_rows, r) <= sms;
  };
  *rows = kSweepMaxRows;
  for (int r = 1; r < kSweepMaxRows; r *= 2) {
    if (fits(r, 1)) {
      *rows = r;
      break;
    }
  }
  if (replicas > 1 && *rows <= kButterflyMaxRows) {
    *rows = fits(1, replicas) ? 1 : kButterflyMaxRows;
  }
  return cudaSuccess;
}

// The tile a launch takes: `tile` when the caller names one (1, 2, 4 or 8:
// the tests that hold a row's output against every tile), else sweep_rows.
cudaError_t pick_sweep_rows(int n_rows, int replicas, int tile, int device,
                            int* rows) {
  if (tile == 0) return sweep_rows(n_rows, device, rows, replicas);
  if (tile != 1 && tile != 2 && tile != 4 && tile != kSweepMaxRows) {
    return cudaErrorInvalidValue;
  }
  *rows = tile;
  return cudaSuccess;
}

// Sets the device, picks the sweep's row tile (pick_sweep_rows) and calls
// f(std::integral_constant<int, ROWS>{}) so that f can name the kernel
// instance for that tile.
template <typename F>
cudaError_t with_sweep_rows(int n_rows, int device, F f, int replicas = 1,
                            int tile = 0) {
  int rows = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = pick_sweep_rows(n_rows, replicas, tile, device, &rows);
  if (err != cudaSuccess) return err;
  switch (rows) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    default:
      return f(std::integral_constant<int, kSweepMaxRows>{});
  }
}

// Raises kernel's dynamic shared memory limit on the current device to smem.
// The limit each (kernel, device) was given is kept, and a launch that needs
// no more makes no runtime call here: a launch at a shape already run is the
// launch alone, which is what a CUDA graph captures.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t smem) {
  struct Limit {
    const void* kernel;
    int device;
    size_t smem;
  };
  static std::mutex mutex;
  static std::vector<Limit> limits;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mutex);
  Limit* known = nullptr;
  for (Limit& l : limits) {
    if (l.kernel == key && l.device == device) known = &l;
  }
  if (known != nullptr && known->smem >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (known != nullptr) {
    known->smem = smem;
  } else {
    limits.push_back(Limit{key, device, smem});
  }
  return cudaSuccess;
}

// Launches one block of kSweepThreads a row tile of each replica: grid
// (row tiles, replicas). A kernel with a replica axis offsets every operand
// by blockIdx.y times the replica's stride; the solo wrappers launch one
// replica, so a solo call is the replica-axis kernel at R = 1.
template <typename Kernel, typename... Args>
cudaError_t launch_sweep(Kernel kernel, int n_rows, int rows, int replicas,
                         size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(n_rows, rows), replicas);
  kernel<<<grid, kSweepThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ------------------------------------------------ the single-layer step

// A single-layer sweep's planes in shared memory, after its padded weight
// [p][p + 1] float4: two d_pre planes [ROWS][p + 4] float4, by the parity of
// the step, then three h planes [ROWS][p + 16] floats, h[a] in plane a mod 3
// (an iteration reads h[s] and h[s-1] and writes h[s-2]).
struct SinglePlanes {
  float4* dp;
  float* h;
  int dp_size, h_size;

  __device__ float4* d_pre(int step) const { return dp + (step & 1) * dp_size; }
  __device__ float* h_of(int step) const {  // step >= -3
    return h + ((step + 3) % 3) * h_size;
  }
};

__device__ __forceinline__ SinglePlanes single_planes(float4* after_weight,
                                                      int p, int rows) {
  SinglePlanes pl;
  pl.dp = after_weight;
  pl.dp_size = rows * (p + 4);
  pl.h = reinterpret_cast<float*>(pl.dp + 2 * pl.dp_size);
  pl.h_size = rows * (p + 16);
  return pl;
}

// Bytes of the padded weight and the planes (66,560 + 2,176 + 960 at
// H = 64 and 1 row; 66,560 + 17,408 + 7,680 at 8 rows).
size_t single_sweep_smem(int hidden, int rows) {
  const size_t p = sweep_pad(hidden);
  return p * (p + 1) * sizeof(float4) + 2 * rows * (p + 4) * sizeof(float4) +
         3 * rows * (p + 16) * sizeof(float);
}

// One iteration of the single-layer sweep for lane (j, q), which produces
// step s's d_pre. Two products in one pass over the staged weight: the
// gates of step s, x[s] + h[s-1] @ w (h_s holds h[s-1], a stash), and
// dh_rec[s] = d_pre[s+1] @ wᵀ (dp_s holds d_pre[s+1], made by the previous
// iteration). Only the second is on the serial chain; the first depends on
// stashes alone, so it shares the pass, the quarter sums (4 gates + 1
// cotangent in one quarter_sum) and the barrier instead of adding its own.
// Below 4 rows the transposed product keeps one partial sum a gate (4
// chains of kq FMAs instead of one of 4 kq), since a lane has too few rows
// for the chains to overlap. Then step s's cell backward: d[g][i] =
// d_pre[s] of row q + 4 i, dc carried to step s-1. The whole warp calls.
template <int ROWS>
__device__ __forceinline__ void single_sweep_step(
    const float* __restrict__ h_s, const float4* __restrict__ dp_s,
    const float4* __restrict__ w_s, int kq, int q, int j,
    const float (&xv)[4][(ROWS + 3) / 4], const float (&cv)[(ROWS + 3) / 4],
    const float (&cp)[(ROWS + 3) / 4], const float (&dhv)[(ROWS + 3) / 4],
    float (&dc)[(ROWS + 3) / 4], float (&d)[4][(ROWS + 3) / 4]) {
  constexpr int NR = (ROWS + 3) / 4;
  constexpr bool kSplit = ROWS < 4;
  const int stride = 4 * kq + 1;
  const int h_row = 4 * kq + 16;
  const int dp_row = 4 * kq + 4;
  const int h0 = q * (kq + 4);
  const int d0 = q * (kq + 1);
  const float4* w_tr = w_s + j * stride + q * kq;
  float acc[ROWS][5];
  float4 part[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int n = 0; n < 5; ++n) acc[r][n] = 0.0f;
    part[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll 4
  for (int m = 0; m < kq; m += 4) {
    const int k0 = q * kq + m;
    float4 wg[4], wt[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wg[e] = w_s[(k0 + e) * stride + j];
      wt[e] = w_tr[m + e];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 h4 = *reinterpret_cast<const float4*>(h_s + r * h_row + h0 + m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = lane(h4, e);
        acc[r][0] = fmaf(h, wg[e].x, acc[r][0]);
        acc[r][1] = fmaf(h, wg[e].y, acc[r][1]);
        acc[r][2] = fmaf(h, wg[e].z, acc[r][2]);
        acc[r][3] = fmaf(h, wg[e].w, acc[r][3]);
        const float4 dd = dp_s[r * dp_row + d0 + m + e];
        if constexpr (kSplit) {
          part[r].x = fmaf(dd.x, wt[e].x, part[r].x);
          part[r].y = fmaf(dd.y, wt[e].y, part[r].y);
          part[r].z = fmaf(dd.z, wt[e].z, part[r].z);
          part[r].w = fmaf(dd.w, wt[e].w, part[r].w);
        } else {
          float s = acc[r][4];
          s = fmaf(dd.x, wt[e].x, s);
          s = fmaf(dd.y, wt[e].y, s);
          s = fmaf(dd.z, wt[e].z, s);
          s = fmaf(dd.w, wt[e].w, s);
          acc[r][4] = s;
        }
      }
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      acc[r][4] = (part[r].x + part[r].y) + (part[r].z + part[r].w);
    }
  }
  float sums[NR][5];
  quarter_sum<ROWS, 5>(acc, q, sums);
  float gates[4][NR], dh[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int g = 0; g < 4; ++g) gates[g][i] = xv[g][i] + sums[i][g];
    dh[i] = dhv[i] + sums[i][4];
  }
  cell_backward(gates, cv, cp, dh, dc, d);
}

// v[i], the h of row q + 4 i and unit j, into the h plane h_s.
template <int ROWS>
__device__ __forceinline__ void stage_h(const float (&v)[(ROWS + 3) / 4],
                                        float* h_s, int kq, int q, int j) {
  const int hc = h_col(j, kq);
#pragma unroll
  for (int i = 0; i < (ROWS + 3) / 4; ++i) {
    if (q + 4 * i < ROWS) h_s[(q + 4 * i) * (4 * kq + 16) + hc] = v[i];
  }
}

// Step s's d_pre rows of lane (j, q) into dx[s] (T, B, 4H) and the d_pre
// plane dp_s; v = h[s-2] of the same rows into the h plane h_s.
template <int ROWS>
__device__ __forceinline__ void single_sweep_store(
    const float (&d)[4][(ROWS + 3) / 4], const float (&v)[(ROWS + 3) / 4],
    float* __restrict__ dx, int s, int n_rows, int hidden, int tile0, int q,
    int j, int kq, float4* dp_s, float* h_s) {
  const int dpc = dp_col(j, kq);
#pragma unroll
  for (int i = 0; i < (ROWS + 3) / 4; ++i) {
    const int lrow = q + 4 * i;
    if (lrow >= ROWS) continue;
    const int row = tile0 + lrow;
    if (row < n_rows && j < hidden) {
      float* out = dx + (static_cast<size_t>(s) * n_rows + row) * 4 * hidden + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) out[g * hidden] = d[g][i];
    }
    dp_s[lrow * (4 * kq + 4) + dpc] = make_float4(d[0][i], d[1][i], d[2][i], d[3][i]);
  }
  stage_h<ROWS>(v, h_s, kq, q, j);
}

}  // namespace
