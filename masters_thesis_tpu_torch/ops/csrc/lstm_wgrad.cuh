// The weight-gradient pass, lstm_wgrad_kernel + lstm_wgrad_sum_kernel, and
// its launch (wgrad), over the type T of its stashes, mask and outputs:
// float, with the replica axis, in lstm_bwd.cu, and bf16, solo, in
// lstm_bwd_bf16.cu (d_pre is f32 for both). Its design is lstm_bwd.cu's
// (the top of that file).

#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "lstm_sweep.cuh"

namespace {

// ------------------------------------------------------ weight gradients

// Jobs of one launch: at most the L-deep stack's 2L - 1 (L = 8).
constexpr int kMaxJobs = 15;
// A block owns one job's whole (64, 256) output (H and 4H padded): thread
// (ty, tx) = (warp, lane) the 8 rows ty*4 + i and 32 + ty*4 + i (i < 4) and
// the 8 columns tx*4 + e and 128 + tx*4 + e (e < 4).
constexpr int kWgradThreads = 256;
constexpr int kWgradRows = 16;               // rows a stage of the ring
constexpr int kWgradStages = 4;              // the ring: 3 stages in flight
// A stage: a and the mask [kWgradRows][64], d_pre [kWgradRows][256] floats.
constexpr int kWgradStageFloats = kWgradRows * 384;
constexpr int kSumThreads = 256;

// One weight gradient out[k][n] = sum_rows a[row][k] * dpre[row][n] over the
// T*B rows (row = t * B + b), a[row] = src[row - shift * B] (zero before the
// first step) times mask[row] when mask is set. bias_out, when set, also
// receives sum_rows dpre[row][n]. T is the type of src, mask, out and
// bias_out: float, or bf16 (the pair's bf16 stashes and mask; the sums are
// taken in f32 and out rounded once, at the end, as the TPU kernel rounds
// its f32 accumulators). d_pre is f32 for either.
template <typename T>
struct WgradJob {
  const T* src;
  const T* mask;
  const float* dpre;
  T* out;
  T* bias_out;
  int shift;
};

template <typename T>
struct WgradJobs {
  WgradJob<T> job[kMaxJobs];
};

// A copy of W = 4 or 1 floats from device memory into shared memory at
// `dst`, or W zeros where `ok` is false (src is then any valid address):
// cp.async's source size 0 fills the destination with zeros, so rows past
// the end, before the first step and columns past H or 4H need no branch.
template <int W>
__device__ __forceinline__ void copy_or_zero(uint32_t dst, const float* src, bool ok) {
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W bf16 values from device memory into shared memory at `dst`, or zeros
// where `ok` is false: 4 values (8 bytes) through cp.async, whose smallest
// copy is 4 bytes, so one value is loaded and stored by the thread.
template <int W>
__device__ __forceinline__ void copy_or_zero(uint32_t dst, const __nv_bfloat16* src,
                                             bool ok) {
  if constexpr (W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 8 : 0)
                 : "memory");
  } else {
    const unsigned short v = ok ? __bfloat16_as_ushort(__ldg(src)) : 0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

// Queues one stage of the ring: rows row0 .. row0 + kWgradRows - 1 of the
// job's a [kWgradRows][64], its mask in the same layout (MASK) and d_pre
// [kWgradRows][256] into st. W values a copy: 4 where H is a multiple of 4
// and every operand aligned to 4 values, else 1. a and the mask are held
// in their type T (bf16: the first half of their f32 regions).
template <int W, bool MASK, typename T>
__device__ __forceinline__ void wgrad_stage(float* st, const WgradJob<T>& jb, int row0,
                                            int end, int n_rows, int hidden) {
  constexpr int kSize = sizeof(T);
  const uint32_t a_s = static_cast<uint32_t>(__cvta_generic_to_shared(st));
  const uint32_t m_s = a_s + 4 * kWgradRows * 64;
  const uint32_t d_s = m_s + 4 * kWgradRows * 64;
#pragma unroll
  for (int idx = threadIdx.x; idx < kWgradRows * 64 / W; idx += kWgradThreads) {
    const int r = idx / (64 / W);
    const int m = (idx - r * (64 / W)) * W;
    const int row = row0 + r;
    const int src_row = row - jb.shift * n_rows;
    const bool ok = row < end && src_row >= 0 && m < hidden;
    copy_or_zero<W>(a_s + kSize * (r * 64 + m),
                    ok ? jb.src + static_cast<size_t>(src_row) * hidden + m : jb.src, ok);
    if constexpr (MASK) {
      const bool in = row < end && m < hidden;
      copy_or_zero<W>(m_s + kSize * (r * 64 + m),
                      in ? jb.mask + static_cast<size_t>(row) * hidden + m : jb.mask, in);
    }
  }
  const int four_h = 4 * hidden;
#pragma unroll
  for (int idx = threadIdx.x; idx < kWgradRows * 256 / W; idx += kWgradThreads) {
    const int r = idx / (256 / W);
    const int n = (idx - r * (256 / W)) * W;
    const int row = row0 + r;
    const bool ok = row < end && n < four_h;
    copy_or_zero<W>(d_s + 4 * (r * 256 + n),
                    ok ? jb.dpre + static_cast<size_t>(row) * four_h + n : jb.dpre, ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 values (8 bytes) of shared memory in f32.
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// acc[i][e] += sum over the stage's rows of a[row][m_i] * d[row][n_e] for
// thread (ty, tx): m_i = ty*4 + i and 32 + ty*4 + i - 4, n_e = tx*4 + e and
// 128 + tx*4 + e - 4. A warp (one ty) reads each a float4 as a broadcast and
// 32 consecutive d float4: 64 FMAs a thread for 16 floats read from shared
// memory. Row k + 1's operands are loaded before row k's FMAs. (A warp over
// 8 ty x 4 tx, which reads 4 wavefronts a row instead of 10, measured
// slower on an H100.)
template <bool MASK, typename T>
__device__ __forceinline__ void wgrad_products(const float* st, int ty, int tx,
                                               float (&acc)[8][8]) {
  const T* a_s = reinterpret_cast<const T*>(st) + ty * 4;
  const T* m_s = reinterpret_cast<const T*>(st + kWgradRows * 64) + ty * 4;
  const float* d_s = st + 2 * kWgradRows * 64 + tx * 4;
  float4 a[2] = {ld4(a_s), ld4(a_s + 32)}, d[2] = {ld4(d_s), ld4(d_s + 128)}, m[2];
  if constexpr (MASK) {
    m[0] = ld4(m_s);
    m[1] = ld4(m_s + 32);
  }
#pragma unroll
  for (int k = 0; k < kWgradRows; ++k) {
    const int kn = k + 1 < kWgradRows ? k + 1 : k;  // the last row loads itself
    const float4 na[2] = {ld4(a_s + kn * 64), ld4(a_s + kn * 64 + 32)};
    const float4 nd[2] = {ld4(d_s + kn * 256), ld4(d_s + kn * 256 + 128)};
    float4 nm[2];
    if constexpr (MASK) {
      nm[0] = ld4(m_s + kn * 64);
      nm[1] = ld4(m_s + kn * 64 + 32);
      a[0] = mul4(a[0], m[0]);
      a[1] = mul4(a[1], m[1]);
    }
    const float av[8] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w};
    const float dv[8] = {d[0].x, d[0].y, d[0].z, d[0].w, d[1].x, d[1].y, d[1].z, d[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], dv[e], acc[i][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h] = na[h];
      d[h] = nd[h];
      if constexpr (MASK) m[h] = nm[h];
    }
  }
}

// The bias sums: thread (ty, tx) adds its 8 columns of the stage's rows ty
// and ty + 8: 8 partial sums a column, one row in 8 each.
__device__ __forceinline__ void wgrad_bias(const float* st, int ty, int tx,
                                           float (&bacc)[8]) {
  const float* d_s = st + 2 * kWgradRows * 64 + tx * 4;
#pragma unroll
  for (int row = ty; row < kWgradRows; row += 8) {
    const float4 d0 = ld4(d_s + row * 256), d1 = ld4(d_s + row * 256 + 128);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) bacc[e] += dv[e];
  }
}

// One block: the job's whole (64, 256) output over the rows of its split,
// its partial sums into the plane part[job * splits + split] ((H + 1, 4H):
// rows < H the weight gradient, row H the bias sum). The stages go round a
// ring of kWgradStages: the copies of stage c + 3 are queued while stage c
// is multiplied, and one barrier a stage both publishes stage c and frees
// the slot stage c - 1 held.
template <int W, bool MASK, typename T>
__device__ __forceinline__ void wgrad_tile(float* ring, const WgradJob<T>& jb, int job,
                                           float* __restrict__ part, int split,
                                           int splits, int per, int n_t, int n_rows,
                                           int hidden) {
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int total = n_t * n_rows;
  const int begin = min(total, split * per);
  const int end = min(total, begin + per);
  const int n_chunks = (end - begin + kWgradRows - 1) / kWgradRows;
  const bool bias = jb.bias_out != nullptr;
  float acc[8][8], bacc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bacc[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][e] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kWgradStages - 1; ++c) {
    if (c < n_chunks) {
      wgrad_stage<W, MASK>(ring + c * kWgradStageFloats, jb, begin + c * kWgradRows,
                           end, n_rows, hidden);
    }
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kWgradStages - 2>();  // this thread's copies of stage c
    __syncthreads();  // everyone's; and stage c - 1 is multiplied
    const int next = c + kWgradStages - 1;
    if (next < n_chunks) {
      wgrad_stage<W, MASK>(ring + (next % kWgradStages) * kWgradStageFloats, jb,
                           begin + next * kWgradRows, end, n_rows, hidden);
    }
    cp_async_commit();  // empty groups too, so the count above holds
    const float* st = ring + (c % kWgradStages) * kWgradStageFloats;
    wgrad_products<MASK, T>(st, ty, tx, acc);
    if (bias) wgrad_bias(st, ty, tx, bacc);
  }

  const int four_h = 4 * hidden;
  const size_t plane = static_cast<size_t>(hidden + 1) * four_h;
  float* p = part + (static_cast<size_t>(job) * splits + split) * plane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i / 4) * 32 + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = h * 128 + tx * 4;
      if (m < hidden && n < four_h) {
        *reinterpret_cast<float4*>(p + m * four_h + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      }
    }
  }
  if (bias) {  // the same for the whole block
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: the bias partials of each ty
#pragma unroll
    for (int e = 0; e < 8; ++e) ring[ty * 256 + (e / 4) * 128 + tx * 4 + e % 4] = bacc[e];
    __syncthreads();
    for (int n = threadIdx.x; n < four_h; n += kWgradThreads) {
      float s = 0.0f;
      for (int t = 0; t < 8; ++t) s += ring[t * 256 + n];
      p[hidden * four_h + n] = s;
    }
  }
}

// A job of replica r: the job's operands offset to the r-th of R stacked
// ones (src and mask (R, T, B, H), d_pre (R, T, B, 4H), out (R, H, 4H),
// bias_out (R, 4H)).
template <typename T>
__device__ __forceinline__ WgradJob<T> replica_job(const WgradJob<T>& jb, size_t rep,
                                                   int n_t, int n_rows, int hidden) {
  const size_t plane = static_cast<size_t>(n_t) * n_rows * hidden;
  const size_t weight = static_cast<size_t>(hidden) * 4 * hidden;
  WgradJob<T> r = jb;
  r.src += rep * plane;
  if (r.mask != nullptr) r.mask += rep * plane;
  r.dpre += rep * 4 * plane;
  r.out += rep * weight;
  if (r.bias_out != nullptr) r.bias_out += rep * 4 * hidden;
  return r;
}

// One block's share of the pass for job ``jb`` (its partial plane in
// ``part``), by the job's mask.
template <int W, typename T>
__device__ __forceinline__ void wgrad_block(float* ring, const WgradJob<T>& jb, int job,
                                            float* __restrict__ part, int split,
                                            int splits, int per, int n_t, int n_rows,
                                            int hidden) {
  if (jb.mask != nullptr) {
    wgrad_tile<W, true>(ring, jb, job, part, split, splits, per, n_t, n_rows, hidden);
  } else {
    wgrad_tile<W, false>(ring, jb, job, part, split, splits, per, n_t, n_rows, hidden);
  }
}

// The pass: block (job, split, replica), blockIdx.x = job * splits + split,
// blockIdx.y = replica. The partial planes are replica-major: replica r's
// jobs own planes r * n_jobs * splits onwards. The splits are the solo
// pass's (lstm_wgrad_splits of the job count, not of R x jobs), so each
// replica's sums are taken in the order of its solo pass. STACKED compiles
// the replica offsets in; a solo pass reads its jobs as before the axis.
template <bool VEC, bool STACKED, typename T>
__global__ void __launch_bounds__(kWgradThreads, 1)
lstm_wgrad_kernel(const __grid_constant__ WgradJobs<T> jobs, float* __restrict__ part,
                  int n_jobs, int splits, int per, int n_t, int n_rows, int hidden) {
  extern __shared__ float4 wgrad_smem[];
  float* ring = reinterpret_cast<float*>(wgrad_smem);
  constexpr int W = VEC ? 4 : 1;
  const int job = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  if constexpr (STACKED) {
    const WgradJob<T> jb = replica_job(jobs.job[job], blockIdx.y, n_t, n_rows, hidden);
    part += static_cast<size_t>(blockIdx.y) * n_jobs * splits * (hidden + 1) * 4 * hidden;
    wgrad_block<W>(ring, jb, job, part, split, splits, per, n_t, n_rows, hidden);
  } else {
    wgrad_block<W>(ring, jobs.job[job], job, part, split, splits, per, n_t, n_rows,
                   hidden);
  }
}

// Four sums into out: float4, or four values rounded to bf16 (8 bytes).
__device__ __forceinline__ void store4(float* out, const float4& s) {
  *reinterpret_cast<float4*>(out) = s;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, const float4& s) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(out) = u;
}

// out = sum over splits s = 0, 1, ... of the partial planes of job jb (plane
// index ``plane_job``), in that order, 4 columns a thread.
template <typename T>
__device__ __forceinline__ void wgrad_sum(const WgradJob<T>& jb, const float* __restrict__ part,
                                          size_t plane_job, int splits, int hidden) {
  const int four_h = 4 * hidden;
  const int idx = 4 * (blockIdx.x * kSumThreads + threadIdx.x);
  const bool is_bias = idx >= hidden * four_h;
  if (idx >= (hidden + 1) * four_h || (is_bias && jb.bias_out == nullptr)) return;
  const size_t plane = static_cast<size_t>(hidden + 1) * four_h;
  const float* p = part + plane_job * splits * plane + idx;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) {
    const float4 v = ld4(p + sp * plane);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  T* out = is_bias ? jb.bias_out + (idx - hidden * four_h) : jb.out + idx;
  store4(out, s);
}

// grid: ((H + 1) * 4H / 4 / kSumThreads, replicas x jobs), blockIdx.y =
// replica * n_jobs + job: the partial planes' order.
template <bool STACKED, typename T>
__global__ void __launch_bounds__(kSumThreads)
lstm_wgrad_sum_kernel(const __grid_constant__ WgradJobs<T> jobs,
                      const float* __restrict__ part, int n_jobs, int splits,
                      int n_t, int n_rows, int hidden) {
  if constexpr (STACKED) {
    const WgradJob<T> jb = replica_job(jobs.job[blockIdx.y % n_jobs],
                                    blockIdx.y / n_jobs, n_t, n_rows, hidden);
    wgrad_sum(jb, part, blockIdx.y, splits, hidden);
  } else {
    wgrad_sum(jobs.job[blockIdx.y], part, blockIdx.y, splits, hidden);
  }
}

// The pass's entry for jobs whose src, mask and outputs are of type T.
template <typename T>
int wgrad(int n_jobs, const T* const* src, const T* const* mask,
          const float* const* dpre, T* const* out, T* const* bias_out,
          const int* shift, float* part, int splits, int n_t, int n_rows,
          int hidden, int replicas, int device, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  if (bad_shape(n_t, n_rows, hidden) || n_jobs < 1 || n_jobs > kMaxJobs ||
      splits < 1 || replicas < 1 || (!kF32 && replicas != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
  };
  constexpr int kVec = 4 * sizeof(T);  // the bytes of a 4-value copy
  WgradJobs<T> jobs{};
  bool vec = hidden % 4 == 0;
  for (int i = 0; i < n_jobs; ++i) {
    jobs.job[i] = WgradJob<T>{src[i], mask[i], dpre[i], out[i], bias_out[i], shift[i]};
    // The sum writes 4 values at a time into every output.
    if (!aligned(out[i], kVec) ||
        (bias_out[i] != nullptr && !aligned(bias_out[i], kVec))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    vec = vec && aligned(src[i], kVec) && aligned(dpre[i], 16) &&
          (mask[i] == nullptr || aligned(mask[i], kVec));
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = ceil_div(ceil_div(n_t * n_rows, kWgradRows), splits) * kWgradRows;
  const size_t smem = kWgradStages * kWgradStageFloats * sizeof(float);
  const bool stacked = kF32 && replicas > 1;
  auto kernel = vec ? lstm_wgrad_kernel<true, false, T> : lstm_wgrad_kernel<false, false, T>;
  auto sum = lstm_wgrad_sum_kernel<false, T>;
  if constexpr (kF32) {
    if (stacked) {
      kernel = vec ? lstm_wgrad_kernel<true, true, T> : lstm_wgrad_kernel<false, true, T>;
      sum = lstm_wgrad_sum_kernel<true, T>;
    }
  }
  err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_jobs * splits, replicas), kWgradThreads, smem, stream>>>(
      jobs, part, n_jobs, splits, per, n_t, n_rows, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 sum_grid(ceil_div((hidden + 1) * hidden, kSumThreads), replicas * n_jobs);
  sum<<<sum_grid, kSumThreads, 0, stream>>>(jobs, part, n_jobs, splits, n_t, n_rows,
                                           hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
