// Host-side window engine: the data module's window build in C++.
//
// One pass over the raw return series makes what the python engine of
// data/pipeline.py assembles in four steps (ops/windows.py:
// lookback_target_split, add_quadratic_features, ols_features over the
// scalar market series): the windows, their polynomial features and the
// per-window OLS labels, on several threads, into numpy buffers that the
// caller allocated.
//
// Numerics: every reduction (the OLS sums, means, variances) accumulates in
// double and rounds once to float32 on store, so the labels agree with the
// float32 python engine to its rounding; x and y are copies and products,
// equal bit for bit.
//
// A plain C interface, loaded with ctypes (native/engine.py). The code is
// the JAX package's masters_thesis_tpu/native/window_engine.cpp, kept here
// so that the port builds its own.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#define MT_EXPORT __attribute__((visibility("default")))

extern "C" {

// Number of complete (lookback+target) windows a series of n_samples admits.
// Returns -1 for invalid parameters.
MT_EXPORT long long mt_num_windows(long long n_samples, long long total_window,
                         long long stride) {
  if (total_window <= 0 || stride <= 0 || n_samples < total_window) return -1;
  return (n_samples - total_window) / stride + 1;
}

// Build the full windowed dataset in one pass.
//
// Inputs (row-major, float32):
//   stocks: (K, T)   per-stock return series
//   market: (T)      market return series
// Parameters:
//   L  = lookback_window, Tt = target_window, stride, prediction (1: target
//   follows the lookback; 0: target is the trailing Tt steps of the
//   lookback), interaction_only (1: 3 features, 0: 5), n_threads (<=0: auto).
// Outputs (caller-allocated, row-major float32):
//   x:       (n_win, K, L, F)   features [r_s, r_m, r_s*r_m (, r_s^2, r_m^2)]
//   y:       (n_win, K, Tt, 2)  raw [r_stock, r_market] target channels
//   alphas:  (n_win, K)         per-window target OLS intercepts
//   betas:   (n_win, K)         per-window target OLS slopes
//   factor:  (n_win, 2)         (mean, var ddof=1) of the target market
//   inv_psi: (n_win, K)         1 / var(ddof=1) of the OLS residuals
// Returns 0 on success, nonzero on invalid parameters.
MT_EXPORT int mt_build_dataset(const float* stocks, const float* market, long long K,
                     long long T, long long L, long long Tt, long long stride,
                     int prediction, int interaction_only, int n_threads,
                     float* x, float* y, float* alphas, float* betas,
                     float* factor, float* inv_psi) {
  const long long total = prediction ? (L + Tt) : L;
  const long long n_win = mt_num_windows(T, total, stride);
  if (n_win < 1 || K < 1 || Tt < 2) return 1;
  if (!prediction && Tt > L) return 2;
  const long long F = interaction_only ? 3 : 5;
  const long long t_off = prediction ? L : (L - Tt);

  long long hw = static_cast<long long>(std::thread::hardware_concurrency());
  if (hw < 1) hw = 1;
  long long workers = n_threads > 0 ? n_threads : hw;
  if (workers > n_win) workers = n_win;

  auto worker = [&](long long w_begin, long long w_end) {
    for (long long w = w_begin; w < w_end; ++w) {
      const long long s = w * stride;
      // ---- lookback features: one contiguous write per (stock, step).
      for (long long k = 0; k < K; ++k) {
        const float* sk = stocks + k * T + s;
        const float* mk = market + s;
        float* xw = x + ((w * K + k) * L) * F;
        for (long long t = 0; t < L; ++t) {
          const float rs = sk[t];
          const float rm = mk[t];
          float* row = xw + t * F;
          row[0] = rs;
          row[1] = rm;
          row[2] = rs * rm;
          if (!interaction_only) {
            row[3] = rs * rs;
            row[4] = rm * rm;
          }
        }
      }
      // ---- market moments over the target window (double accumulation).
      const float* mt = market + s + t_off;
      double sx = 0.0, sxx = 0.0;
      for (long long t = 0; t < Tt; ++t) {
        const double v = mt[t];
        sx += v;
        sxx += v * v;
      }
      const double n = static_cast<double>(Tt);
      const double mean_m = sx / n;
      // Unbiased variance (matches torch.var default, ddof=1).
      const double var_m = (sxx - n * mean_m * mean_m) / (n - 1.0);
      factor[w * 2 + 0] = static_cast<float>(mean_m);
      factor[w * 2 + 1] = static_cast<float>(var_m);

      const double denom = n * sxx - sx * sx;  // n^2 * population var
      // ---- per-stock target channels + OLS fit + residual variance.
      for (long long k = 0; k < K; ++k) {
        const float* st = stocks + k * T + s + t_off;
        float* yw = y + ((w * K + k) * Tt) * 2;
        double sy = 0.0, sxy = 0.0;
        for (long long t = 0; t < Tt; ++t) {
          const double ys = st[t];
          yw[t * 2 + 0] = st[t];
          yw[t * 2 + 1] = mt[t];
          sy += ys;
          sxy += ys * static_cast<double>(mt[t]);
        }
        double beta, alpha;
        if (denom != 0.0) {
          beta = (n * sxy - sx * sy) / denom;
          alpha = (sy - beta * sx) / n;
        } else {
          // Degenerate (constant c) regressor: the gram matrix is singular
          // and the Python path's pinv returns the MIN-NORM least-squares
          // solution alpha = ybar/(1+c^2), beta = c*ybar/(1+c^2) — match it.
          const double c = mean_m;
          const double ybar = sy / n;
          alpha = ybar / (1.0 + c * c);
          beta = c * alpha;
        }
        double rss = 0.0, rsum = 0.0;
        for (long long t = 0; t < Tt; ++t) {
          const double r =
              static_cast<double>(st[t]) - (alpha + beta * mt[t]);
          rsum += r;
          rss += r * r;
        }
        // var(residuals, ddof=1) about the residual mean (alpha absorbs it
        // up to rounding, but match the Python path exactly).
        const double rmean = rsum / n;
        const double psi = (rss - n * rmean * rmean) / (n - 1.0);
        alphas[w * K + k] = static_cast<float>(alpha);
        betas[w * K + k] = static_cast<float>(beta);
        inv_psi[w * K + k] = static_cast<float>(1.0 / psi);
      }
    }
  };

  if (workers <= 1) {
    worker(0, n_win);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  const long long chunk = (n_win + workers - 1) / workers;
  for (long long i = 0; i < workers; ++i) {
    const long long b = i * chunk;
    const long long e = std::min(n_win, b + chunk);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
