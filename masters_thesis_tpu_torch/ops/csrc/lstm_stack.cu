// The L-deep LSTM wavefront for Hopper (sm_90a), forward and backward, with a
// plain C interface. Counterparts of two Pallas TPU kernels in
// masters_thesis_tpu/ops/lstm_kernel.py:
//
//   lstm_stack_fwd_kernel  replaces _stack_fwd_kernel: L stacked layers in one
//                          launch, layer l at step t = s - l of iteration s.
//                          Templated on <has_mask, write_stash>: the maskless,
//                          stash-free instance serves model=medium and
//                          model=large; training runs the masked one (L - 1
//                          pre-scaled dropout planes, plane l multiplying layer
//                          l's h where it enters layer l + 1) that also writes
//                          every layer's h and c, the stashes the backward
//                          recomputes from;
//   lstm_stack_bwd_kernel  the serial part of _stack_bwd_kernel: the reverse
//                          wavefront, the top layer leading and layer l lagging
//                          L - 1 - l steps, recomputing each layer's gates and
//                          seam projection from the stashes. It writes each
//                          layer's pre-activation gradient d_pre_l (layer 0's
//                          is dx1, the gradient of x1_proj) and accumulates no
//                          weight gradient: one launch of lstm_wgrad
//                          (lstm_bwd.cu) reduces the 2L - 1 of them from those
//                          planes, as it does for the pair.
//
// What bounds them on this card. As in the pair: a chain of T + L - 1
// dependent iterations of small (rows, H) @ (H, 4H) f32 products (2L - 1 a
// step forward, 4L - 2 backward), so the step chain's latency, not bandwidth,
// limits them; at 25 rows (one window of the 25 Fama-French portfolios) the
// work is far below the card's f32 peak.
//
// What the design does about it. The TPU kernel keeps all 2L - 1 weights in
// one program's VMEM; here a 4-deep stack's seven (64, 256) f32 weights are
// 448 KiB against a block's 227 KB. So the stack runs as a thread block
// cluster of L CTAs per row tile, CTA l owning layer l: it stages its own
// w_hh[l] and, for l >= 1, the seam weight w_in[l-1] (128 KiB at H = 64) in
// its shared memory in lstm_fwd.cu's float4-per-(k, j) layout, and the
// wavefront's step chain stays T + L - 1 long. Layers hand h forward (and the
// seam cotangent backward) through distributed shared memory: CTA l reads the
// neighbour's (rows, H) buffer of the previous iteration, double-buffered by
// iteration parity, so one cluster barrier per iteration orders every
// exchange. Every CTA arrives at every barrier, idle or not (the first and
// last L - 1 iterations leave some layers idle). The row tile (2, 4 or 8
// rows) is the smallest whose clusters all fit on the card at once
// (cudaOccupancyMaxActiveClusters); a launch whose cluster cannot be placed
// at all is refused. Thread (group, j) owns hidden unit j of its rows, as in
// the pair kernels. Accurate expf/tanhf, no fast math.

#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Depths taken: the pair kernel is the 2-deep wavefront, and 8 CTAs is the
// portable cluster size.
constexpr int kMinLayers = 3;
constexpr int kMaxLayers = 8;

// Pointers of one launch. Seam i joins layer i to layer i + 1 (i < L - 1):
// w_in[i] (H, 4H), bias[i] (4H) and, when masked, mask[i] (T, B, H).
struct StackFwdArgs {
  const float* x1;  // (T, B, 4H) layer 0's input projections, biases included
  const float* mask[kMaxLayers];
  const float* w_hh[kMaxLayers];
  const float* w_in[kMaxLayers];
  const float* bias[kMaxLayers];
  float* hs[kMaxLayers];  // (T, B, H): all L with the stash, else the top only
  float* cs[kMaxLayers];  // (T, B, H): with the stash only
  int n_layers, n_t, n_rows, hidden;
};

struct StackBwdArgs {
  const float* dh_top;  // (T, B, H) cotangent of the top layer's h
  const float* x1;
  const float* mask[kMaxLayers];
  const float* hs[kMaxLayers];
  const float* cs[kMaxLayers];
  const float* w_hh[kMaxLayers];
  const float* w_in[kMaxLayers];
  const float* bias[kMaxLayers];
  float* d_pre[kMaxLayers];  // (T, B, 4H) per layer; d_pre[0] is dx1
  int n_layers, n_t, n_rows, hidden;
};

// Forward. Iteration s, CTA l (layer l) at t = s - l: copies the layer
// below's h[t] (its buffer of iteration s - 1), times the seam mask, into
// hm_s; gates = (bias + hm @ w_in) + h[t-1] @ w_hh for l >= 1, x1[t] +
// h[t-1] @ w_hh for layer 0; writes h[t] into its buffer of parity s & 1.
// Shared memory: whh_s, win_s [padded(H)][H] float4; hbuf 2 x [rows][padded(H)]
// (this layer's h by iteration parity); hm_s [rows][padded(H)].
template <int RPT, bool HAS_MASK, bool STASH>
__global__ void __launch_bounds__(kMaxThreads)
lstm_stack_fwd_kernel(const StackFwdArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int layer = static_cast<int>(cluster.block_rank());
  const int n_layers = a.n_layers, n_t = a.n_t, n_rows = a.n_rows;
  const int hidden = a.hidden;
  const bool seam = layer > 0;
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  float4* whh_s = smem;
  float4* win_s = whh_s + kp * hidden;
  float* hbuf = reinterpret_cast<float*>(win_s + kp * hidden);
  float* hm_s = hbuf + 2 * rows * kp;
  stage_weight(a.w_hh[layer], whh_s, hidden);
  if (seam) stage_weight(a.w_in[layer - 1], win_s, hidden);
  for (int idx = threadIdx.x; idx < 3 * rows * kp; idx += blockDim.x) {
    hbuf[idx] = 0.0f;  // both h buffers and hm_s; the padded k stay zero
  }
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = (blockIdx.x / n_layers) * rows + lrow0;
  const float* mask = HAS_MASK && seam ? a.mask[layer - 1] : nullptr;
  float* hs = STASH || layer == n_layers - 1 ? a.hs[layer] : nullptr;
  float* cs = STASH ? a.cs[layer] : nullptr;
  const float* below = seam ? cluster.map_shared_rank(hbuf, layer - 1) : nullptr;
  float bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (seam) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = __ldg(a.bias[layer - 1] + g * hidden + j);
  }

  float c[RPT], x_next[4][RPT], m_next[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    c[r] = 0.0f;
    m_next[r] = 1.0f;
  }
  if (!seam) load_x(a.x1, 0, n_t, n_rows, hidden, row0, j, x_next);
  if (HAS_MASK && seam) load_h(mask, 0, n_t, n_rows, hidden, row0, j, m_next);
  cluster.sync();  // every CTA's buffers are zero before any remote read

  for (int s = 0; s < n_t + n_layers - 1; ++s) {
    const int t = s - layer;
    if (t >= 0 && t < n_t) {  // the same for every thread of the CTA
      const float4* h_prev = reinterpret_cast<const float4*>(
          hbuf + ((s + 1) & 1) * rows * kp);
      float* h_out = hbuf + (s & 1) * rows * kp;
      float acc[2][4][RPT], h[RPT];
      if (seam) {
        const float* src = below + ((s + 1) & 1) * rows * kp;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int at = (lrow0 + r) * kp + j;
          hm_s[at] = HAS_MASK ? src[at] * m_next[r] : src[at];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[0][g][r] = bias[g];
            acc[1][g][r] = 0.0f;
          }
        }
        if constexpr (HAS_MASK) load_h(mask, t + 1, n_t, n_rows, hidden, row0, j, m_next);
        __syncthreads();  // hm_s holds the seam input of every row
        const float4* const h_in[2] = {reinterpret_cast<const float4*>(hm_s), h_prev};
        const float4* const w_in[2] = {win_s, whh_s};
        gate_products<RPT, 2>(h_in, w_in, lrow0, hidden, j, acc);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[0][g][r] += acc[1][g][r];
      } else {
        float acc0[1][4][RPT];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc0[0][g][r] = x_next[g][r];
        load_x(a.x1, t + 1, n_t, n_rows, hidden, row0, j, x_next);
        const float4* const h_in[1] = {h_prev};
        const float4* const w_in[1] = {whh_s};
        gate_products<RPT, 1>(h_in, w_in, lrow0, hidden, j, acc0);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[0][g][r] = acc0[0][g][r];
      }
      cell_update(acc[0], c, h);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        h_out[(lrow0 + r) * kp + j] = h[r];
        const int row = row0 + r;
        if (row < n_rows) {
          const size_t out = (static_cast<size_t>(t) * n_rows + row) * hidden + j;
          if (hs != nullptr) hs[out] = h[r];
          if constexpr (STASH) cs[out] = c[r];
        }
      }
    }
    // h[t] of every layer is in its buffer; every read of the buffers of
    // parity (s + 1) & 1 is done, so iteration s + 1 may overwrite them.
    cluster.sync();
  }
}

// Backward. Iteration k, CTA l at t = T - 1 - k + (L - 1 - l): recomputes
// layer l's gates at t from the stashes (h[t-1], c[t], c[t-1] and, for
// l >= 1, the seam input (m ⊙ h_{l-1})[t]); dh = the incoming cotangent (dh_top
// for the top layer, else the seam cotangent CTA l + 1 made at t in
// iteration k - 1) + the recurrent dh carried from t + 1; writes d_pre_l[t];
// carries dh_rec = d_pre @ w_hhᵀ and, for l >= 1, puts (d_pre @ w_inᵀ) ⊙ m
// into its buffer of parity k & 1 for CTA l - 1.
// Shared memory: whh_s, win_s [padded(H)][H] float4; dp_s [rows][H] float4;
// hp_s, hm_s [rows][padded(H)]; dbuf 2 x [rows][H].
template <int RPT, bool HAS_MASK>
__global__ void __launch_bounds__(kMaxThreads)
lstm_stack_bwd_kernel(const StackBwdArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int layer = static_cast<int>(cluster.block_rank());
  const int n_layers = a.n_layers, n_t = a.n_t, n_rows = a.n_rows;
  const int hidden = a.hidden;
  const bool seam = layer > 0;
  const bool top = layer == n_layers - 1;
  const int lag = n_layers - 1 - layer;
  extern __shared__ float4 smem[];
  const int kp = padded(hidden);
  const int rows = kGroups * RPT;
  float4* whh_s = smem;
  float4* win_s = whh_s + kp * hidden;
  float4* dp_s = win_s + kp * hidden;
  float* hp_s = reinterpret_cast<float*>(dp_s + rows * hidden);
  float* hm_s = hp_s + rows * kp;
  float* dbuf = hm_s + rows * kp;
  stage_weight(a.w_hh[layer], whh_s, hidden);
  if (seam) stage_weight(a.w_in[layer - 1], win_s, hidden);
  for (int idx = threadIdx.x; idx < 2 * rows * kp + 2 * rows * hidden;
       idx += blockDim.x) {
    hp_s[idx] = 0.0f;  // hp_s, hm_s (the padded k stay zero) and dbuf
  }
  const int j = threadIdx.x % hidden;
  const int lrow0 = (threadIdx.x / hidden) * RPT;
  const int row0 = (blockIdx.x / n_layers) * rows + lrow0;
  const float* hs = a.hs[layer];
  const float* cs = a.cs[layer];
  const float* h_below = seam ? a.hs[layer - 1] : nullptr;
  const float* mask = HAS_MASK && seam ? a.mask[layer - 1] : nullptr;
  float* d_pre = a.d_pre[layer];
  const float* above = top ? nullptr : cluster.map_shared_rank(dbuf, layer + 1);
  float bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (seam) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = __ldg(a.bias[layer - 1] + g * hidden + j);
  }
  const float4* const hp4 = reinterpret_cast<const float4*>(hp_s);
  const float4* const hm4 = reinterpret_cast<const float4*>(hm_s);

  float dh_rec[RPT], dc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dh_rec[r] = dc[r] = 0.0f;
  cluster.sync();  // every CTA's buffers are zero before any remote read

  for (int k = 0; k < n_t + n_layers - 1; ++k) {
    const int t = n_t - 1 - k + lag;
    if (t >= 0 && t < n_t) {  // the same for every thread of the CTA
      float hv[RPT], mv[RPT], dh_in[RPT], cv[RPT], cp[RPT];
      load_h(hs, t - 1, n_t, n_rows, hidden, row0, j, hv);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        hp_s[(lrow0 + r) * kp + j] = hv[r];
        mv[r] = 1.0f;
      }
      if (seam) {
        float hb[RPT];
        load_h(h_below, t, n_t, n_rows, hidden, row0, j, hb);
        if constexpr (HAS_MASK) load_h(mask, t, n_t, n_rows, hidden, row0, j, mv);
#pragma unroll
        for (int r = 0; r < RPT; ++r) hm_s[(lrow0 + r) * kp + j] = hb[r] * mv[r];
      }
      if (top) {
        load_h(a.dh_top, t, n_t, n_rows, hidden, row0, j, dh_in);
      } else {
        const float* src = above + ((k + 1) & 1) * rows * hidden;
#pragma unroll
        for (int r = 0; r < RPT; ++r) dh_in[r] = src[(lrow0 + r) * hidden + j];
      }
      load_h(cs, t, n_t, n_rows, hidden, row0, j, cv);
      load_h(cs, t - 1, n_t, n_rows, hidden, row0, j, cp);
      float acc[2][4][RPT];
      if (!seam) load_x(a.x1, t, n_t, n_rows, hidden, row0, j, acc[0]);
      __syncthreads();  // hp_s and hm_s hold this iteration's rows

      if (seam) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            acc[0][g][r] = bias[g];
            acc[1][g][r] = 0.0f;
          }
        const float4* const h_in[2] = {hm4, hp4};
        const float4* const w_in[2] = {win_s, whh_s};
        gate_products<RPT, 2>(h_in, w_in, lrow0, hidden, j, acc);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[0][g][r] += acc[1][g][r];
      } else {
        float acc0[1][4][RPT];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc0[0][g][r] = acc[0][g][r];
        const float4* const h_in[1] = {hp4};
        const float4* const w_in[1] = {whh_s};
        gate_products<RPT, 1>(h_in, w_in, lrow0, hidden, j, acc0);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[0][g][r] = acc0[0][g][r];
      }
      float dh[RPT], d[4][RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) dh[r] = dh_in[r] + dh_rec[r];
      cell_backward(acc[0], cv, cp, dh, dc, d);
      store_d_pre(d, true, d_pre, t, n_rows, hidden, row0, lrow0, j, dp_s);
      __syncthreads();  // dp_s holds this step's d_pre rows

      if (seam) {
        const float4* const dp_in[2] = {dp_s, dp_s};
        const float4* const w_tr[2] = {whh_s, win_s};
        float tr[2][RPT];
        transposed_products<RPT, 2>(dp_in, w_tr, lrow0, hidden, j, tr);
        float* out = dbuf + (k & 1) * rows * hidden;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          dh_rec[r] = tr[0][r];
          out[(lrow0 + r) * hidden + j] = tr[1][r] * mv[r];
        }
      } else {
        const float4* const dp_in[1] = {dp_s};
        const float4* const w_tr[1] = {whh_s};
        float tr[1][RPT];
        transposed_products<RPT, 1>(dp_in, w_tr, lrow0, hidden, j, tr);
#pragma unroll
        for (int r = 0; r < RPT; ++r) dh_rec[r] = tr[0][r];
      }
    }
    // Every seam cotangent of iteration k is in its buffer; every read of
    // the buffers of parity (k + 1) & 1 is done.
    cluster.sync();
  }
}

size_t fwd_smem(int hidden, int rpt) { return smem_bytes(hidden, rpt, 2, 3); }

size_t bwd_smem(int hidden, int rpt) {
  return smem_bytes(hidden, rpt, 2, 2, 1) + 2 * kGroups * rpt * hidden * sizeof(float);
}

// How many clusters of one launch shape the card holds at once. The runtime
// is asked once per (kernel, device, depth, H), with the kernel's shared
// memory limit raised to its need at the largest H, and the answer kept:
// asking costs host time that would otherwise come with every launch.
struct ClusterFit {
  const void* kernel;
  int device, n_layers, hidden, clusters;
};

template <typename Args>
cudaError_t cluster_capacity(void (*kernel)(Args), size_t max_smem,
                             const cudaLaunchConfig_t& config, int device,
                             int n_layers, int hidden, int* clusters) {
  static std::mutex mutex;
  static std::vector<ClusterFit> fits;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mutex);
  for (const ClusterFit& f : fits) {
    if (f.kernel == key && f.device == device && f.n_layers == n_layers &&
        f.hidden == hidden) {
      *clusters = f.clusters;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(max_smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  fits.push_back(ClusterFit{key, device, n_layers, hidden, *clusters});
  return cudaSuccess;
}

// Launches kernel on clusters of n_layers CTAs, one cluster per row tile of
// kGroups * RPT rows. Unless last, declines (*launched = false) when the
// tiles are more clusters than the card holds at once, so that the caller
// tries the next larger tile. Refuses a cluster the card cannot place.
template <int RPT, typename Args, typename Smem>
cudaError_t launch_clusters(void (*kernel)(Args), const Args& args, Smem smem,
                            bool last, bool* launched, int device,
                            cudaStream_t stream) {
  *launched = false;
  const int rows = kGroups * RPT;
  const int tiles = (args.n_rows + rows - 1) / rows;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(args.n_layers);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * args.n_layers));
  config.blockDim = dim3(static_cast<unsigned>(kGroups * args.hidden));
  config.dynamicSmemBytes = smem(args.hidden, RPT);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cluster_capacity(kernel, smem(kMaxHidden, RPT), config, device,
                                     args.n_layers, args.hidden, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if (!last && tiles > clusters) return cudaSuccess;
  *launched = true;
  err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The smallest row tile (2, 4, then 8 rows) whose clusters all fit at once.
template <template <int> class Kernel, typename Args, typename Smem>
cudaError_t launch_stack(const Args& args, Smem smem, int device,
                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  bool launched = false;
  err = launch_clusters<1>(Kernel<1>::get(), args, smem, false, &launched,
                           device, stream);
  if (err != cudaSuccess || launched) return err;
  err = launch_clusters<2>(Kernel<2>::get(), args, smem, false, &launched,
                           device, stream);
  if (err != cudaSuccess || launched) return err;
  return launch_clusters<4>(Kernel<4>::get(), args, smem, true, &launched,
                            device, stream);
}

template <bool HAS_MASK, bool STASH>
struct Fwd {
  template <int RPT>
  struct At {
    static auto get() { return lstm_stack_fwd_kernel<RPT, HAS_MASK, STASH>; }
  };
};

template <bool HAS_MASK>
struct Bwd {
  template <int RPT>
  struct At {
    static auto get() { return lstm_stack_bwd_kernel<RPT, HAS_MASK>; }
  };
};

bool bad_stack(int n_layers, int n_t, int n_rows, int hidden) {
  return bad_shape(n_t, n_rows, hidden) || n_layers < kMinLayers ||
         n_layers > kMaxLayers;
}

}  // namespace

extern "C" {

int lstm_stack_max_layers() { return kMaxLayers; }

int lstm_stack_max_hidden() { return kMaxHidden; }

// Every entry point takes the CUDA device index of its pointers and stream:
// this library links its own CUDA runtime, whose current device is set here.
// Pointer arrays hold n_layers entries (w_hh, hs, cs, d_pre) or n_layers - 1
// (w_in, bias, mask: seam i between layers i and i + 1).

// The top layer's h (T, B, H) into hs[n_layers - 1] from x1 (T, B, 4H), the
// weights and, when mask is non-null, the seam masks (T, B, H). With cs[0]
// non-null (the stash), every hs[l] and cs[l] is written.
int lstm_stack_fwd(const float* x1, const float* const* mask,
                   const float* const* w_hh, const float* const* w_in,
                   const float* const* bias, float* const* hs, float* const* cs,
                   int n_layers, int n_t, int n_rows, int hidden, int device,
                   cudaStream_t stream) {
  if (bad_stack(n_layers, n_t, n_rows, hidden)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StackFwdArgs a{};
  a.x1 = x1;
  a.n_layers = n_layers;
  a.n_t = n_t;
  a.n_rows = n_rows;
  a.hidden = hidden;
  const bool has_mask = mask != nullptr;
  const bool stash = cs[0] != nullptr;
  for (int l = 0; l < n_layers; ++l) {
    a.w_hh[l] = w_hh[l];
    a.hs[l] = hs[l];
    a.cs[l] = cs[l];
    if (l + 1 < n_layers) {
      a.w_in[l] = w_in[l];
      a.bias[l] = bias[l];
      a.mask[l] = has_mask ? mask[l] : nullptr;
    }
  }
  cudaError_t err;
  if (has_mask) {
    err = stash ? launch_stack<Fwd<true, true>::At>(a, fwd_smem, device, stream)
                : launch_stack<Fwd<true, false>::At>(a, fwd_smem, device, stream);
  } else {
    err = stash ? launch_stack<Fwd<false, true>::At>(a, fwd_smem, device, stream)
                : launch_stack<Fwd<false, false>::At>(a, fwd_smem, device, stream);
  }
  return static_cast<int>(err);
}

// d_pre[l] (T, B, 4H) for every layer (d_pre[0] = dx1) from dh_top (T, B, H),
// x1, the optional seam masks, the stashes hs, cs and the weights.
int lstm_stack_bwd(const float* dh_top, const float* x1, const float* const* mask,
                   const float* const* hs, const float* const* cs,
                   const float* const* w_hh, const float* const* w_in,
                   const float* const* bias, float* const* d_pre, int n_layers,
                   int n_t, int n_rows, int hidden, int device,
                   cudaStream_t stream) {
  if (bad_stack(n_layers, n_t, n_rows, hidden)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StackBwdArgs a{};
  a.dh_top = dh_top;
  a.x1 = x1;
  a.n_layers = n_layers;
  a.n_t = n_t;
  a.n_rows = n_rows;
  a.hidden = hidden;
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
  return static_cast<int>(
      has_mask ? launch_stack<Bwd<true>::At>(a, bwd_smem, device, stream)
               : launch_stack<Bwd<false>::At>(a, bwd_smem, device, stream));
}

}  // extern "C"
