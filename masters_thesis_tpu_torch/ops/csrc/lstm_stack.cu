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
//                          wavefront, the top layer leading, recomputing each
//                          layer's gates and seam projection from the stashes.
//                          It writes each layer's pre-activation gradient
//                          d_pre_l (layer 0's is dx1, the gradient of
//                          x1_proj) and accumulates no weight gradient: one
//                          launch of lstm_wgrad (lstm_bwd.cu) reduces the
//                          2L - 1 of them from those planes, as it does for
//                          the pair.
//
// What bounds them on this card. As in the pair: a chain of dependent
// iterations of small (rows, H) @ (H, 4H) f32 products (2L - 1 a step
// forward, 4L - 2 backward), so the chain's latency, not bandwidth, limits
// them; at 25 rows (one window of the 25 Fama-French portfolios) the work is
// far below the card's f32 peak. Every operand of a product sits in shared
// memory, which serves one 128-byte wavefront a clock, so what an iteration
// reads there, and what it waits for, sets its time.
//
// What the design does about it. The TPU kernel keeps all 2L - 1 weights in
// one program's VMEM; here a 4-deep stack's seven (64, 256) f32 weights are
// 448 KiB against a block's 227 KB. So the stack runs as a thread block
// cluster of L CTAs a row tile, CTA l owning layer l: it stages (or holds
// in registers) its own w_hh[l] and, for l >= 1, the seam weight w_in[l-1],
// and layers hand h forward (and the seam cotangent backward) through
// distributed shared memory, pushed by the producer with st.async onto the
// consumer's mbarrier, with one relaxed cluster barrier an iteration. Every
// CTA arrives at every barrier, idle or not (the first and last iterations
// leave some layers idle). Both directions run 256 threads a CTA on tiles
// of 1, 2, 4 or 8 rows, the smallest whose clusters all fit on the card at
// once (cudaOccupancyMaxActiveClusters: 1 row for L = 4 at 25 rows, 2 for
// L = 7 and 8, 8 at 200 rows); a launch whose cluster cannot be placed at
// all is refused.
//
// The forward runs the forward step of lstm_fwd_step.cuh, as the pair's
// forward does: lane u + 8 q of warp w serves unit j = 8 w + u and quarter
// q of the contraction for all the tile's rows. w_hh[l] and w_in[l-1] sit
// in the lanes' registers at 1 and 2 rows, where the accumulators leave
// room for them and reading them from shared memory would cost about a
// quarter of an iteration; at 4 and 8 rows the accumulators need those
// registers, so the weights are staged, each staged float4 read by one
// lane a product and step. Both products and the addend (x1 or the bias)
// run in one pass and one quarter_gates, h double buffered, one CTA
// barrier a step. CTA l pushes m_l ⊙ h_l[t] into CTA l + 1's
// double-buffered inbox as soon as its cell is done, the consumer waits on
// the inbox's mbarrier before its pass (no remote pull, no release fence),
// x1 and the mask are loaded a step ahead, and the h and c stores are
// issued after the arrive. The lag is one step (T + L - 1 iterations):
// nothing stands between the producer's cell and the consumer's product.
// An iteration on an H100 at 25 rows, L = 4 (clock64, thread 0 of layer 1;
// ops/profile_stack_sweep.py): 1,765 cycles, of which the pass 456, the
// quarter sums and the cell 550, the x1 and mask loads 173, the push 160,
// the stores and the CTA barrier 140, the inbox wait 121.
//
// The backward runs on the 256-thread sweep block of lstm_sweep.cuh (tiles
// of 1, 2, 4 or 8 rows: 1 for L = 4 at 25 rows, 8 at 200): lane u + 8 q of
// warp w serves unit (or, transposed, k) j = 8 w + u and quarter q of the
// contraction for all the tile's rows. Its first design gave each of two row
// groups of 64 threads every staged weight float4, in the gate products and
// again in the transposed ones: a seam layer's CTA read about 4,096 weight
// wavefronts an iteration at H = 64, loaded its stashes from device memory
// at the top of each iteration behind a barrier, ran its gate products on
// the chain before the cell, waited at three barriers (two in the CTA, one
// in the cluster) and pulled the cotangent from the layer above with a
// remote load: 5.2 us an iteration at 25 rows on an H100, against cuDNN's
// 4.0. Now each staged weight float4 (stage_weight_padded) is read by one
// lane a product and step, 2,048 wavefronts an iteration for a seam layer;
// at tiles of 1 or 2 rows w_hh's gate product reads its weight from the
// lanes' registers instead (load_quarter_weight), 1,536. The gates of step
// s depend on stashes alone (x1[s] or b + (m ⊙ h_{l-1})[s] @ w_in, plus
// h_l[s-1] @ w_hh), so, as in the single sweep (single_sweep_step), they
// run in the same pass as the transposed products of the d_pre that the
// previous iteration made, with one quarter_sum for all six sums. The
// stashes of step s - 1 are loaded during step s (clamped, branch-free
// reads, zeroed where used) and staged at its end.
//
// The exchange (both directions). The seam value is pushed: the producing
// CTA stores it
// into the consumer's inbox (st.async), each store counting its bytes on
// the consumer's mbarrier, which the consumer waits on before it reads.
// One cluster barrier an iteration, relaxed, keeps the CTAs within an
// iteration of each other, so that a double-buffered inbox is never
// overwritten before it is read; a CTA barrier publishes the CTA's own
// planes (d_pre, h), also double buffered. A release on the cluster barrier
// would order the pushes by itself, but it waits for every earlier write
// to land: 700-1,000 cycles an iteration on an H100, a fifth of it.
// Measured on an H100 at 25 rows (clock64, cycles an iteration, thread 0
// of layer 1; ops/profile_stack_sweep.py): 5,450 for the first version of
// this design (one cluster barrier with release, every weight staged),
// 3,979 now: the pass 2,506, the cell 436, the exchange 275, the stash
// loads 230, the stores and the CTA barrier 274.
//
// The backward's schedule: layer l lags layer l + 1 by two steps, not one.
// Layer l + 1 makes d_pre_{l+1}[t] in one iteration; its pass of the next
// iteration makes (d_pre_{l+1}[t] @ w_inᵀ) ⊙ m[t], the cotangent layer l needs
// at step t, and layer l consumes it in the iteration after that. A one-step
// lag would put that transposed product on the chain between the cell of layer
// l + 1 and that of layer l, behind a second barrier an iteration. The price is
// T + 2 (L - 1) iterations instead of T + L - 1 (66 against 63 at L = 4, T =
// 60), and seam layers run one more pass, at t = -1, for the cotangent of the
// step 0 below them. Accurate expf/tanhf, no fast math.

#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>
#include <vector>

#include "lstm_fwd_step.cuh"

namespace cg = cooperative_groups;

namespace {

#ifdef LSTM_STACK_STAMPS
// Profiling builds only (ops/profile_stack_sweep.py): thread 0 of CTA
// stamp_cta records clock64 at eight points of each backward iteration.
constexpr int kStampIters = 512;
__device__ long long stamps[kStampIters][8];
__device__ int stamp_cta = -1;
#define STAMP(n) \
  if (stamp_on && k < kStampIters) stamps[k][n] = clock64();
#else
#define STAMP(n)
#endif

// Depths taken: the pair kernel is the 2-deep wavefront, and 8 CTAs is the
// portable cluster size.
constexpr int kMinLayers = 3;
constexpr int kMaxLayers = 8;

// The forward holds both its weights in the registers of the lanes that
// multiply them at tiles of 1 and 2 rows, and stages them at 4 and 8, where
// the accumulators need those registers.
__host__ __device__ constexpr bool stack_fwd_in_registers(int rows) { return rows <= 2; }

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

// v[i] = 0 where keep is false. A value of a step before the first is
// loaded from a clamped step (FwdLane) and zeroed here, where it is used:
// a select right behind its load would wait for the load.
template <int N>
__device__ __forceinline__ void zero_unless(bool keep, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = keep ? v[i] : 0.0f;
}

// The halves of a cluster barrier: arrive and wait. Every thread of every
// CTA calls both, alternately. The relaxed arrive orders no memory: it only
// keeps the CTAs within one iteration of each other (a release here waits
// for every earlier write to land, 700-1,000 cycles an iteration on an
// H100); what crosses CTAs is ordered by the inbox's mbarriers.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// This phase of the barrier completes once `bytes` have landed on it.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete; acquires what the
// stores that completed it wrote.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// v into another CTA's shared memory (addr, from cluster_addr), its 4 bytes
// counted on that CTA's mbarrier `bar` when they land.
__device__ __forceinline__ void store_remote(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// p += d * w, lane by lane.
__device__ __forceinline__ void fma4(float4& p, const float4& d, const float4& w) {
  p.x = fmaf(d.x, w.x, p.x);
  p.y = fmaf(d.y, w.y, p.y);
  p.z = fmaf(d.z, w.z, p.z);
  p.w = fmaf(d.w, w.w, p.w);
}

// s + d . w, one term after another.
__device__ __forceinline__ float dot4(float s, const float4& d, const float4& w) {
  s = fmaf(d.x, w.x, s);
  s = fmaf(d.y, w.y, s);
  s = fmaf(d.z, w.z, s);
  return fmaf(d.w, w.w, s);
}

// cell_update for a tile of one row, whose four gates every quarter lane of
// the unit holds after the quarter sums: lane q takes gate q's activation,
// and the shuffles gather them, so a lane has two transcendentals on the
// chain instead of five. The same functions and formula as cell_update.
// The whole warp calls.
__device__ __forceinline__ void one_row_cell(const float (&gates)[4][1], int q,
                                             float& c, float& h) {
  constexpr unsigned kAll = 0xffffffffu;
  const float pre = q == 0 ? gates[0][0]
                           : (q == 1 ? gates[1][0] : (q == 2 ? gates[2][0] : gates[3][0]));
  const float sg = sigmoid(pre);
  const float th = tanhf(pre);
  const float act = q == 2 ? th : sg;  // no branch: both in flight at once
  const int unit = threadIdx.x & 7;
  const float i = __shfl_sync(kAll, act, unit);
  const float f = __shfl_sync(kAll, act, unit | 8);
  const float g = __shfl_sync(kAll, act, unit | 16);
  const float o = __shfl_sync(kAll, act, unit | 24);
  c = f * c + i * g;
  h = o * tanhf(c);
}

// Forward. Iteration k, CTA l runs layer l at step t = k - l on the forward
// step of lstm_fwd_step.cuh: gates = x1[t] + h_l[t-1] @ w_hh (layer 0) or
// bias + hm[t] @ w_in + h_l[t-1] @ w_hh (hm = m ⊙ h_{l-1}, which CTA l - 1
// pushed into this CTA's inbox in iteration k - 1), both products in one
// pass and one quarter_gates, then the cell. It stages h_l[t] into its own
// plane for step t + 1 and, after the cluster barrier's wait, pushes
// m_l[t] ⊙ h_l[t] (h_l[t] maskless) into CTA l + 1's inbox with st.async,
// each store counted on CTA l + 1's mbarrier; then it arrives at the
// cluster barrier (relaxed: its own inbox reads are done) and writes h and
// c into device memory. Every CTA but the top pushes at every iteration
// (zeros where its layer does not run), so every inbox phase completes.
// x1 (layer 0) and the mask plane are loaded a step ahead (FwdLane:
// clamped, branch-free). At tiles of 1 and 2 rows both weights sit in the
// registers of the lanes that multiply them (load_quarter_weight: 128
// floats a lane), so a step reads no weight from shared memory; at 4 and 8
// rows, where the accumulators need those registers, both are staged
// (stage_weight_padded), each float4 read by one lane a product and step.
// A tile of one row runs its cell over the quarter lanes (one_row_cell).
// Warps with 8 w >= p only take part in the barriers.
// Shared memory (p = sweep_pad(H)): at 4 or 8 rows win_s, whh_s [p][p + 1]
// float4; two buffers of the own h plane and the inbox [ROWS][p + 16]
// floats; the inbox buffers' two mbarriers.
template <int ROWS, bool HAS_MASK, bool STASH>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_stack_fwd_kernel(const StackFwdArgs a) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  constexpr bool kRegs = stack_fwd_in_registers(ROWS);  // else staged
  cg::cluster_group cluster = cg::this_cluster();
  const int layer = static_cast<int>(cluster.block_rank());
  const int n_layers = a.n_layers, n_t = a.n_t, n_rows = a.n_rows;
  const int hidden = a.hidden;
  const bool seam = layer > 0;
  const bool top = layer == n_layers - 1;
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  float4* win_s = smem;  // win_s, whh_s: !kRegs only
  float4* whh_s = win_s + (kRegs ? 0 : p * (p + 1));
  const FwdPlanes pl = fwd_planes(whh_s + (kRegs ? 0 : p * (p + 1)), p, ROWS, 2);
  // One mbarrier an inbox buffer: its phase completes when the layer below
  // has pushed that iteration's ROWS x p values into it.
  const uint32_t full = smem_addr(pl.end());
  if constexpr (!kRegs) {
    if (seam) stage_weight_padded(a.w_in[layer - 1], win_s, hidden, p);
    stage_weight_padded(a.w_hh[layer], whh_s, hidden, p);
  }
  // Both buffers of the own plane (h[-1] = 0) and of the inbox to zero:
  // no NaN an earlier kernel left reaches a product through padding.
  pl.zero();
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int tile0 = (blockIdx.x / n_layers) * ROWS;
  const FwdLane<ROWS> ln(n_rows, hidden, kq, tile0);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp
  float wr[kRegs ? kMaxHidden / 4 : 1][4], wi[kRegs ? kMaxHidden / 4 : 1][4];
  if constexpr (kRegs) {
    load_quarter_weight(a.w_hh[layer], hidden, kq, ln.q, ln.j, wr);
    if (seam) load_quarter_weight(a.w_in[layer - 1], hidden, kq, ln.q, ln.j, wi);
  }
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bias[g] = seam ? __ldg(a.bias[layer - 1] + g * hidden + ln.col) : 0.0f;
  }
  // m_l, the seam mask on this layer's h where it enters layer l + 1.
  const float* mask = HAS_MASK && !top ? a.mask[layer] : nullptr;
  float* hs = STASH || top ? a.hs[layer] : nullptr;
  float* cs = STASH ? a.cs[layer] : nullptr;
  // Where this CTA pushes: plane 1 (the inbox) of CTA l + 1 and its mbarriers.
  const int to = top ? layer : layer + 1;
  const uint32_t push = cluster_addr(smem_addr(pl.base), to);
  const uint32_t push_full = cluster_addr(full, to);
  const int push_bytes = ROWS * p * static_cast<int>(sizeof(float));

  float c[NR], xn[4][NR], mn[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    c[i] = 0.0f;
    mn[i] = 1.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) xn[g][i] = 0.0f;
  }
  if (!seam) ln.load_x(a.x1, 0, n_t, n_rows, hidden, xn);
  if constexpr (HAS_MASK) {
    if (mask != nullptr) ln.load_h(mask, -layer, n_t, n_rows, hidden, mn);
  }
  __syncthreads();  // the weights are staged, the planes zero
  // Every CTA's planes and mbarriers are ready before any CTA pushes.
  cluster_arrive_release();
#ifdef LSTM_STACK_STAMPS
  const bool stamp_on = blockIdx.x == stamp_cta && threadIdx.x == 0;
#endif

  const int n_iter = n_t + n_layers - 1;
  for (int k = 0; k < n_iter; ++k) {
    const int t = k - layer;
    const bool run = t >= 0 && t < n_t;  // the same for the whole CTA
    STAMP(0)
    // Iteration k's push from the layer below lands in buffer (k + 1) & 1:
    // its phase k >> 1.
    if (seam && threadIdx.x == 0) mbar_expect(full + 8 * ((k + 1) & 1), push_bytes);
    float add[1][4][NR], m[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      m[i] = mn[i];
#pragma unroll
      for (int g = 0; g < 4; ++g) add[0][g][i] = seam ? bias[g] : xn[g][i];
    }
    if (!seam) ln.load_x(a.x1, t + 1, n_t, n_rows, hidden, xn);
    if constexpr (HAS_MASK) {
      if (mask != nullptr) ln.load_h(mask, t + 1, n_t, n_rows, hidden, mn);
    }
    STAMP(1)
    // hm[t], pushed in iteration k - 1, has landed in buffer k & 1.
    if (seam && k > 0) mbar_wait(full + 8 * (k & 1), ((k - 1) >> 1) & 1);
    STAMP(2)
    float h[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) h[i] = 0.0f;
    if (run && active) {
      float acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      const float* own = pl.at(k, 0);
      const float* inbox = pl.at(k, 1);
      if constexpr (!kRegs) {
        if (seam) {
          const float* const h_in[2] = {inbox, own};
          const float4* const w_in[2] = {win_s, whh_s};
          quarter_gate_products<ROWS, 2, 1>(h_in, w_in, kq, 4 * kq + 16, ln.q, ln.j, acc);
        } else {
          const float* const h_in[1] = {own};
          const float4* const w_in[1] = {whh_s};
          quarter_gate_products<ROWS, 1, 1>(h_in, w_in, kq, 4 * kq + 16, ln.q, ln.j, acc);
        }
      } else {
        register_gate_product<ROWS>(own, wr, kq, ln.q, acc);
        if (seam) register_gate_product<ROWS>(inbox, wi, kq, ln.q, acc);
      }
      STAMP(3)
      float gates[1][4][NR];
      quarter_gates<ROWS, 1>(acc, ln.q, add, gates);
      if constexpr (ROWS == 1) {
        one_row_cell(gates[0], ln.q, c[0], h[0]);
      } else {
        cell_update(gates[0], c, h);
      }
      ln.stage(h, pl.at(k + 1, 0), kq);
    }
    STAMP(4)
    // Every CTA is done reading the inbox buffer this iteration pushes into
    // (it read it in iteration k - 1).
    cluster_wait();
    if (!top && active) {
      const uint32_t at = push + 4 * (((k + 1) & 1) * 2 + 1) * pl.size;
      const uint32_t bar = push_full + 8 * ((k + 1) & 1);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (ln.q + 4 * i < ROWS) {
          store_remote(at + 4 * ((ln.q + 4 * i) * (4 * kq + 16) + ln.hc),
                       run ? h[i] * m[i] : 0.0f, bar);
        }
      }
    }
    STAMP(5)
    // Done with this iteration's inbox buffer: its values are used.
    cluster_arrive_relaxed();
    STAMP(6)
    if (run && active) {
      if (hs != nullptr) ln.store(h, hs, t, n_rows, hidden);
      if constexpr (STASH) ln.store(c, cs, t, n_rows, hidden);
    }
    // The own plane holds h[t] for step t + 1, and every read of the
    // buffers the next iteration writes is done.
    __syncthreads();
    STAMP(7)
  }
  // The last push has landed: no CTA writes into this one any more.
  if (seam) mbar_wait(full + 8 * (n_iter & 1), ((n_iter - 1) >> 1) & 1);
  cluster_wait();
}

// The four products of a seam layer's iteration in one pass over its two
// staged weights, lane (j, q)'s share: the gates of step s, hm[s] @ w_in +
// h[s-1] @ w_hh (hm_s and hp_s hold those stashes, staged by the previous
// iteration), into acc[r][0..3]; and the two transposed products of
// d_pre[s+1] (dp_s, made by the previous iteration), the recurrent dh
// d_pre[s+1] @ w_hhᵀ into acc[r][4] and the seam cotangent d_pre[s+1] @
// w_inᵀ into acc[r][5], for unit k = j. Then the quarters are summed in one
// quarter_sum: sums[i][n] for row q + 4 i. Each staged weight float4 is
// read by one lane a product and step; each h float4 and each d_pre float4
// serves both of its products. Below 4 rows each transposed product keeps
// one partial sum a gate (4 chains of kq FMAs instead of one of 4 kq), as
// single_sweep_step does. The whole warp calls.
template <int ROWS, int WR>
__device__ __forceinline__ void stack_sweep_pass(
    const float* __restrict__ hm_s, const float* __restrict__ hp_s,
    const float4* __restrict__ dp_s, const float4* __restrict__ win_s,
    const float4* __restrict__ whh_s, const float (&wr)[WR][4], int kq, int q,
    int j, float (&sums)[(ROWS + 3) / 4][6]) {
  constexpr bool kSplit = ROWS < 4;
  constexpr bool kReg = WR == kMaxHidden / 4;  // w_hh's gate quarter in wr
  const int stride = 4 * kq + 1;
  const int h_row = 4 * kq + 16;
  const int dp_row = 4 * kq + 4;
  const int h0 = q * (kq + 4);
  const int d0 = q * (kq + 1);
  const float4* hh_tr = whh_s + j * stride + q * kq;
  const float4* in_tr = win_s + j * stride + q * kq;
  float acc[ROWS][6];
  float4 part[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int n = 0; n < 6; ++n) acc[r][n] = 0.0f;
    part[r][0] = part[r][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // At 8 rows the accumulators leave no registers for a second step in
  // flight (ptxas spilled): unrolled twice below that.
  constexpr int kUnroll = ROWS >= 8 ? 1 : 2;
#pragma unroll kUnroll
  for (int m = 0; m < kq; m += 4) {
    const int k0 = q * kq + m;
    float4 wi[4], wh[4], ti[4], th[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wi[e] = win_s[(k0 + e) * stride + j];
      if constexpr (!kReg) wh[e] = whh_s[(k0 + e) * stride + j];
      ti[e] = in_tr[m + e];
      th[e] = hh_tr[m + e];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 hm4 = *reinterpret_cast<const float4*>(hm_s + r * h_row + h0 + m);
      float4 hp4;
      if constexpr (!kReg) hp4 = *reinterpret_cast<const float4*>(hp_s + r * h_row + h0 + m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hm = lane(hm4, e);
        acc[r][0] = fmaf(hm, wi[e].x, acc[r][0]);
        acc[r][1] = fmaf(hm, wi[e].y, acc[r][1]);
        acc[r][2] = fmaf(hm, wi[e].z, acc[r][2]);
        acc[r][3] = fmaf(hm, wi[e].w, acc[r][3]);
        if constexpr (!kReg) {
          const float hp = lane(hp4, e);
          acc[r][0] = fmaf(hp, wh[e].x, acc[r][0]);
          acc[r][1] = fmaf(hp, wh[e].y, acc[r][1]);
          acc[r][2] = fmaf(hp, wh[e].z, acc[r][2]);
          acc[r][3] = fmaf(hp, wh[e].w, acc[r][3]);
        }
        const float4 dd = dp_s[r * dp_row + d0 + m + e];
        if constexpr (kSplit) {
          fma4(part[r][0], dd, th[e]);
          fma4(part[r][1], dd, ti[e]);
        } else {
          acc[r][4] = dot4(acc[r][4], dd, th[e]);
          acc[r][5] = dot4(acc[r][5], dd, ti[e]);
        }
      }
    }
  }
  if constexpr (kReg) {
    // h[s-1] @ w_hh from the registers, as register_gate_product: past the
    // quarter (H < 61) a lane reads its first float4 again, which the zero
    // weights there cancel, so no branch sits between the loads.
#pragma unroll
    for (int m = 0; m < WR; m += 4) {
      const int at = m < kq ? m : 0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hp_s + r * h_row + h0 + at);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = lane(h4, e);
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(h, wr[m + e][g], acc[r][g]);
        }
      }
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        acc[r][4 + n] = (part[r][n].x + part[r][n].y) + (part[r][n].z + part[r][n].w);
      }
  }
  quarter_sum<ROWS, 6>(acc, q, sums);
}

// Backward: the reverse wavefront, one cluster barrier an iteration.
// Iteration k, CTA l runs layer l at step s = T - 1 - k + 2 (L - 1 - l):
// the top layer leads and each layer lags the one above it by two steps
// (why two: the header). In one pass (stack_sweep_pass) it forms step s's
// gates from the stashes and the transposed products of d_pre[s+1], which
// the previous iteration left in its d_pre plane. After the cluster
// barrier's wait it pushes (d_pre[s+1] @ w_inᵀ) ⊙ m[s+1], the cotangent of
// layer l - 1's h at step s + 1, into CTA l - 1's inbox, waits for its own
// inbox (what CTA l + 1 pushed in iteration k - 1) and runs step s's cell
// backward, with dh = that cotangent (dh_top[s] for the top layer) +
// d_pre[s+1] @ w_hhᵀ. It writes d_pre_l[s] into its d_pre plane, arrives
// at the cluster barrier, then writes d_pre_l[s] into device memory and
// stages the h planes of step s - 1 before the CTA barrier. Seam layers run
// t = -1 as well, for the pass that makes the cotangent of layer l - 1's
// step 0; layer 0 stops at 0. Every seam CTA pushes at every iteration
// (zeros where its layer is idle), so every inbox phase completes. Layer 0
// runs the seam layers' code on a zero w_in and a zero hm plane (x1 its
// addend instead of the bias): its extra products add exact zeros and take
// no time of the chain, which waits for the seam layers at every barrier.
// Every lane loads its rows' operands of step s - 1 (h[s-2], h_{l-1}[s-1],
// m[s-1], c[s-2], x1[s-1], dh_top[s-1]) at the top of the iteration and
// stages or keeps them at its end; c[s-1] is already in registers. Warps
// with 8 w >= p only take part in the barriers.
// Shared memory (p = sweep_pad(H)): whh_s, win_s [p][p + 1] float4; two
// d_pre planes [ROWS][p + 4] float4; two buffers of the hp and hm planes
// [ROWS][p + 16] floats; two inboxes [ROWS][p + 8] floats and their two
// mbarriers.
template <int ROWS, bool HAS_MASK>
__global__ void __launch_bounds__(kSweepThreads, 1)
lstm_stack_bwd_kernel(const StackBwdArgs a) {
  constexpr int NR = (ROWS + 3) / 4;  // rows a lane owns
  cg::cluster_group cluster = cg::this_cluster();
  const int layer = static_cast<int>(cluster.block_rank());
  const int n_layers = a.n_layers, n_t = a.n_t, n_rows = a.n_rows;
  const int hidden = a.hidden;
  const bool seam = layer > 0;
  const bool top = layer == n_layers - 1;
  const int lag = 2 * (n_layers - 1 - layer);  // even: the first step's parity is 0
  const int t_last = seam ? -1 : 0;
  extern __shared__ float4 smem[];
  const int p = sweep_pad(hidden);
  const int kq = p / 4;
  const int dp_size = ROWS * (p + 4);  // float4
  const int in_row = p + 8;            // floats
  const int in_size = ROWS * in_row;
  float4* whh_s = smem;
  float4* win_s = whh_s + p * (p + 1);
  float4* dp = win_s + p * (p + 1);
  const FwdPlanes pl = fwd_planes(dp + 2 * dp_size, p, ROWS, 2);  // hp, hm
  float* inbox = pl.end();
  // One mbarrier an inbox buffer: its phase completes when the layer above
  // has pushed that iteration's ROWS x p cotangents into it.
  const uint32_t full = smem_addr(inbox + 2 * in_size);
  stage_weight_padded(a.w_hh[layer], whh_s, hidden, p);
  if (seam) {
    stage_weight_padded(a.w_in[layer - 1], win_s, hidden, p);
  } else {
    for (int idx = threadIdx.x; idx < p * (p + 1); idx += blockDim.x) {
      win_s[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  // Every plane and inbox to zero (d_pre[T] is zero, and no NaN an earlier
  // kernel left in shared memory reaches a product).
  for (int idx = threadIdx.x; idx < 2 * dp_size; idx += blockDim.x) {
    dp[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  pl.zero();
  for (int idx = threadIdx.x; idx < 2 * in_size; idx += blockDim.x) inbox[idx] = 0.0f;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int tile0 = (blockIdx.x / n_layers) * ROWS;
  const FwdLane<ROWS> ln(n_rows, hidden, kq, tile0);
  const bool active = (threadIdx.x >> 5) * 8 < p;  // the same for a warp
  const float* hs = a.hs[layer];
  const float* cs = a.cs[layer];
  const float* h_below = a.hs[seam ? layer - 1 : layer];  // layer 0: unused
  const float* mask = HAS_MASK ? a.mask[seam ? layer - 1 : 0] : nullptr;
  float* d_pre = a.d_pre[layer];
  // Where this CTA pushes: CTA l - 1's inbox and its mbarriers.
  const uint32_t push = cluster_addr(smem_addr(inbox), seam ? layer - 1 : layer);
  const uint32_t push_full = cluster_addr(full, seam ? layer - 1 : layer);
  const int push_bytes = ROWS * p * static_cast<int>(sizeof(float));
  const int dpc = dp_col(ln.j, kq);
  int dout[NR];  // row * 4H + j where the lane writes d_pre of row q + 4 i, or -1
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    dout[i] = ln.out[i] < 0 ? -1 : (tile0 + ln.q + 4 * i) * 4 * hidden + ln.j;
  }
  // Up to 2 rows a lane has the registers for w_hh's gate quarter (64
  // floats): that product then reads no weight from shared memory.
  constexpr int kWr = ROWS <= 2 ? kMaxHidden / 4 : 1;
  float wr[kWr][4];
  if constexpr (kWr > 1) load_quarter_weight(a.w_hh[layer], hidden, kq, ln.q, ln.j, wr);
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bias[g] = seam ? __ldg(a.bias[layer - 1] + g * hidden + ln.col) : 0.0f;
  }

  // Step T-1's operands, and its h planes in buffer 0.
  float cv[NR], cp[NR], xv[4][NR], dhv[NR], m_push[NR], m_cur[NR], dc[NR];
  {
    float hv[NR], hb[NR];
    ln.load_h(cs, n_t - 1, n_t, n_rows, hidden, cv);
    ln.load_h(cs, n_t - 2, n_t, n_rows, hidden, cp);
    ln.load_x(a.x1, n_t - 1, n_t, n_rows, hidden, xv);
    ln.load_h(a.dh_top, n_t - 1, n_t, n_rows, hidden, dhv);
    ln.load_h(hs, n_t - 2, n_t, n_rows, hidden, hv);
    ln.load_h(h_below, n_t - 1, n_t, n_rows, hidden, hb);
#pragma unroll
    for (int i = 0; i < NR; ++i) m_cur[i] = 1.0f;
    if constexpr (HAS_MASK) ln.load_h(mask, n_t - 1, n_t, n_rows, hidden, m_cur);
    zero_unless(n_t >= 2, cp);
    zero_unless(n_t >= 2, hv);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      m_push[i] = 0.0f;  // the cotangent of step T, which nothing reads
      dc[i] = 0.0f;
      hb[i] = seam ? hb[i] * m_cur[i] : 0.0f;
    }
    __syncthreads();  // the zeroing is done before the first rows land
    if (active) {
      ln.stage(hv, pl.at(0, 0), kq);
      ln.stage(hb, pl.at(0, 1), kq);
    }
    __syncthreads();  // the first planes are in place
  }
  // Every CTA's inbox and mbarriers are ready before any CTA pushes.
  cluster_arrive_release();
#ifdef LSTM_STACK_STAMPS
  const bool stamp_on = blockIdx.x == stamp_cta && threadIdx.x == 0;
#endif

  const int n_iter = n_t + 2 * (n_layers - 1);
  for (int k = 0; k < n_iter; ++k) {
    const int s = n_t - 1 - k + lag;
    const bool run = s >= t_last && s < n_t;  // the same for the whole CTA
    STAMP(0)
    // Iteration k's push lands in buffer k & 1: its phase k >> 1.
    if (!top && threadIdx.x == 0) mbar_expect(full + 8 * (k & 1), push_bytes);
    // Step s-1's operands, in flight during this iteration.
    float hn[NR], hbn[NR], mn[NR], cpn[NR], xn[4][NR], dhn[NR], sums[NR][6];
    if (run) {
      ln.load_h(hs, s - 2, n_t, n_rows, hidden, hn);
      ln.load_h(h_below, s - 1, n_t, n_rows, hidden, hbn);
#pragma unroll
      for (int i = 0; i < NR; ++i) mn[i] = 1.0f;
      if constexpr (HAS_MASK) ln.load_h(mask, s - 1, n_t, n_rows, hidden, mn);
      ln.load_h(cs, s - 2, n_t, n_rows, hidden, cpn);
      ln.load_x(a.x1, s - 1, n_t, n_rows, hidden, xn);
      ln.load_h(a.dh_top, s - 1, n_t, n_rows, hidden, dhn);
      STAMP(1)
      if (active) {
        stack_sweep_pass<ROWS>(pl.at(k, 1), pl.at(k, 0), dp + ((k + 1) & 1) * dp_size,
                               win_s, whh_s, wr, kq, ln.q, ln.j, sums);
      }
    }
    STAMP(2)
    // Every CTA is done reading the inbox buffer this iteration pushes into.
    cluster_wait();
    // Every seam CTA pushes at every iteration (zeros where its layer does
    // not run), so that each inbox phase gets its bytes.
    if (seam && active) {
      const uint32_t to = push + 4 * (k & 1) * in_size;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (ln.q + 4 * i < ROWS) {
          store_remote(to + 4 * ((ln.q + 4 * i) * in_row + ln.j),
                       run ? sums[i][5] * m_push[i] : 0.0f, push_full + 8 * (k & 1));
        }
      }
    }
    // The cotangents pushed in iteration k - 1 have landed.
    if (!top && k > 0) mbar_wait(full + 8 * ((k - 1) & 1), ((k - 1) >> 1) & 1);
    STAMP(3)
    float d[4][NR];
    if (run && active) {
      const float* in = inbox + ((k + 1) & 1) * in_size;
      float gates[4][NR], dh[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          gates[g][i] = (seam ? bias[g] : xv[g][i]) + sums[i][g];
        }
        const float from_above = in[ln.lrow[i] * in_row + ln.j];
        dh[i] = (top ? dhv[i] : from_above) + sums[i][4];
      }
      if constexpr (ROWS == 1) {
        // One row: after the quarter sums all four quarter lanes hold it, so
        // lane q takes gate q's activation (and tanh(c)) and the shuffles
        // gather them: two transcendentals a lane on the chain, not five.
        const int q = ln.q;
        const float pre = q == 0 ? gates[0][0]
                                 : (q == 1 ? gates[1][0] : (q == 2 ? gates[2][0] : gates[3][0]));
        const float sg = sigmoid(pre);
        const float th = tanhf(q == 2 ? pre : cv[0]);
        const int unit = threadIdx.x & 7;
        constexpr unsigned kAll = 0xffffffffu;
        const float4 g4 = cell_grads(
            __shfl_sync(kAll, sg, unit), __shfl_sync(kAll, sg, unit | 8),
            __shfl_sync(kAll, th, unit | 16), __shfl_sync(kAll, sg, unit | 24),
            __shfl_sync(kAll, th, unit), cp[0], dh[0], dc[0]);
        d[0][0] = g4.x;
        d[1][0] = g4.y;
        d[2][0] = g4.z;
        d[3][0] = g4.w;
      } else {
        cell_backward(gates, cv, cp, dh, dc, d);
      }
      STAMP(4)
      float4* dp_out = dp + (k & 1) * dp_size;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (ln.q + 4 * i < ROWS) {
          dp_out[(ln.q + 4 * i) * (p + 4) + dpc] =
              make_float4(d[0][i], d[1][i], d[2][i], d[3][i]);
        }
      }
    }
    STAMP(5)
    // Done with this iteration's inbox buffer: its inbox values are in
    // registers and used, so no load of it is still in flight.
    cluster_arrive_relaxed();
    STAMP(6)
    if (run) {
      if (active) {
        float* plane = d_pre + static_cast<size_t>(max(s, 0)) * n_rows * 4 * hidden;
        float hm[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (s >= 0 && dout[i] >= 0) {
#pragma unroll
            for (int g = 0; g < 4; ++g) plane[dout[i] + g * hidden] = d[g][i];
          }
          hm[i] = seam ? hbn[i] * mn[i] : 0.0f;
        }
        zero_unless(s >= 2, hn);
        ln.stage(hn, pl.at(k + 1, 0), kq);
        ln.stage(hm, pl.at(k + 1, 1), kq);
      }
      zero_unless(s >= 2, cpn);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        cv[i] = cp[i];
        cp[i] = cpn[i];
        dhv[i] = dhn[i];
        m_push[i] = m_cur[i];
        m_cur[i] = mn[i];
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[g][i] = xn[g][i];
      }
    }
    // This iteration's d_pre rows and h planes are in place for the next
    // pass, and every read of the buffers that pass overwrites is done.
    __syncthreads();
    STAMP(7)
  }
  // The last push has landed: no CTA writes into this one any more.
  if (!top) mbar_wait(full + 8 * ((n_iter - 1) & 1), ((n_iter - 1) >> 1) & 1);
  cluster_wait();
}

// The forward's staged weights (at 4 or 8 rows), two buffers of the own h
// plane and the inbox, and two mbarriers: 1,280 + 16 bytes at H = 64 and 1
// row; 133,120 + 10,240 + 16 at 8 rows.
size_t fwd_smem(int hidden, int rows) {
  return (stack_fwd_in_registers(rows) ? 0 : 2) * padded_weight_bytes(hidden) +
         fwd_planes_bytes(hidden, rows, 2) + 2 * sizeof(uint64_t);
}

// The two padded weights, two d_pre planes, two buffers of two h planes and
// two inboxes: 133,120 + 2,176 + 1,280 + 576 bytes at H = 64 and 1 row;
// 133,120 + 17,408 + 10,240 + 4,608 at 8 rows.
size_t bwd_smem(int hidden, int rows) {
  const size_t p = sweep_pad(hidden);
  return 2 * padded_weight_bytes(hidden) + 2 * rows * (p + 4) * sizeof(float4) +
         fwd_planes_bytes(hidden, rows, 2) + 2 * rows * (p + 8) * sizeof(float) +
         2 * sizeof(uint64_t);
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

// A kernel instance and its launch shape (Fwd, Bwd; kSweepThreads a CTA):
// At::get() the kernel, At::kRows the rows of its tile and At::smem(H) its
// dynamic shared memory.
template <bool HAS_MASK, bool STASH>
struct Fwd {
  template <int ROWS>
  struct At {
    static constexpr int kRows = ROWS;
    static auto get() { return lstm_stack_fwd_kernel<ROWS, HAS_MASK, STASH>; }
    static size_t smem(int hidden) { return fwd_smem(hidden, ROWS); }
  };
};

template <bool HAS_MASK>
struct Bwd {
  template <int ROWS>
  struct At {
    static constexpr int kRows = ROWS;
    static auto get() { return lstm_stack_bwd_kernel<ROWS, HAS_MASK>; }
    static size_t smem(int hidden) { return bwd_smem(hidden, ROWS); }
  };
};

// The launch of At on clusters of n_layers CTAs, one cluster a row tile.
template <typename At, typename Args>
cudaLaunchConfig_t cluster_config(const Args& args, cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(args.n_layers);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(
      ceil_div(args.n_rows, At::kRows) * args.n_layers));
  config.blockDim = dim3(kSweepThreads);
  config.dynamicSmemBytes = At::smem(args.hidden);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// Sets the device and calls f(At<N>{}) for the first tile N of Ns whose
// clusters all fit on the card at once, or the last N when none does.
// Refuses a cluster the card cannot place at all.
template <template <int> class At, int N, int... Ns, typename Args, typename F>
cudaError_t with_stack_tile(const Args& args, int device, F f) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config<At<N>>(args, &attr, nullptr);
  int clusters = 0;
  err = cluster_capacity(At<N>::get(), At<N>::smem(kMaxHidden), config, device,
                         args.n_layers, args.hidden, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if constexpr (sizeof...(Ns) > 0) {
    if (ceil_div(args.n_rows, At<N>::kRows) > clusters) {
      return with_stack_tile<At, Ns...>(args, device, f);
    }
  }
  return f(At<N>{});
}

template <typename At, typename Args>
cudaError_t launch_tile(const Args& args, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config<At>(args, &attr, stream);
  const cudaError_t err = cudaLaunchKernelEx(&config, At::get(), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Both directions take tiles of 1, 2, 4 or 8 rows.
template <bool HAS_MASK, bool STASH, typename F>
cudaError_t with_fwd_tile(const StackFwdArgs& args, int device, F f) {
  return with_stack_tile<Fwd<HAS_MASK, STASH>::template At, 1, 2, 4, 8>(args, device, f);
}

template <bool HAS_MASK, typename F>
cudaError_t with_bwd_tile(const StackBwdArgs& args, int device, F f) {
  return with_stack_tile<Bwd<HAS_MASK>::template At, 1, 2, 4, 8>(args, device, f);
}

bool bad_stack(int n_layers, int n_t, int n_rows, int hidden) {
  return bad_shape(n_t, n_rows, hidden) || n_layers < kMinLayers ||
         n_layers > kMaxLayers;
}

}  // namespace

extern "C" {

#ifdef LSTM_STACK_STAMPS
// Copies the stamps of the launches since the last call into host
// (kStampIters x 8), zeroes them and makes CTA `cta` the one stamped from
// now on.
int lstm_stack_stamps(int cta, long long* host) {
  void* at = nullptr;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, stamps, sizeof(stamps));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, stamps);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(stamps));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(stamp_cta, &cta, sizeof(int));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
#endif

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
  const auto launch = [&](auto at) { return launch_tile<decltype(at)>(a, stream); };
  cudaError_t err;
  if (has_mask) {
    err = stash ? with_fwd_tile<true, true>(a, device, launch)
                : with_fwd_tile<true, false>(a, device, launch);
  } else {
    err = stash ? with_fwd_tile<false, true>(a, device, launch)
                : with_fwd_tile<false, false>(a, device, launch);
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
  const auto launch = [&](auto at) { return launch_tile<decltype(at)>(a, stream); };
  return static_cast<int>(has_mask ? with_bwd_tile<true>(a, device, launch)
                                   : with_bwd_tile<false>(a, device, launch));
}

// *rows = the row tile a launch of n_layers layers on n_rows rows takes: the
// forward's (backward = 0; with or without the mask and the stash) or the
// backward's (with or without the mask).
int lstm_stack_row_tile(int n_layers, int n_rows, int hidden, int backward,
                        int masked, int stash, int device, int* rows) {
  if (bad_stack(n_layers, 1, n_rows, hidden)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto tile = [&](auto at) {
    *rows = decltype(at)::kRows;
    return cudaSuccess;
  };
  cudaError_t err;
  if (backward) {
    StackBwdArgs a{};
    a.n_layers = n_layers;
    a.n_rows = n_rows;
    a.hidden = hidden;
    err = masked ? with_bwd_tile<true>(a, device, tile)
                 : with_bwd_tile<false>(a, device, tile);
  } else {
    StackFwdArgs a{};
    a.n_layers = n_layers;
    a.n_rows = n_rows;
    a.hidden = hidden;
    if (masked) {
      err = stash ? with_fwd_tile<true, true>(a, device, tile)
                  : with_fwd_tile<true, false>(a, device, tile);
    } else {
      err = stash ? with_fwd_tile<false, true>(a, device, tile)
                  : with_fwd_tile<false, false>(a, device, tile);
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
