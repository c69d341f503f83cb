// mbdf_demand: the auction's modified bandwidth demand d_n(p_m) on a whole
// (N, M) price grid, one launch per book of truthful bids.
//
// Replaces the Pallas TPU kernel _mbdf_kernel / mbdf_demand in
// src/repro/kernels/market_clear.py.  Per (row n, price p_m): bisect f on
// [0, F_CEIL / max t^C] for `iters` trips, going right while
// q(f) - p > 0 with q(f) = [(1 - a) + a / (1 + f)] * 1 / max(sum_k
// alpha / max(1 - t^C f, TINY)^2, TINY); opt out (f = 0) at p >= p_max
// (1 / sum alpha on active rows, 0 on inactive ones); emit
// sum_k alpha f / max(1 - t^C f, TINY).
//
// Bound on this card: operations (about 6 float32 operations per valid
// (row, client, trip, price); the row is read once for all M prices and M
// demands are written).  The trips are dependent, so in practice their
// latency (a divide per register and a warp butterfly per price) sets the
// time.
// Design: one warp per row with the row in registers (rows.cuh load_row),
// read from memory once for all M price columns, as the TPU kernel's
// constant index map intends.  Up to kPrices bisections run interleaved in
// one pass over the trips, so a warp has kPrices independent divide chains
// and butterflies in flight per trip; a grid of more than kPrices prices
// takes further passes over the same registers.  The butterfly leaves the
// same sum in every lane, so every branch is uniform across the warp.
// `alpha_fair` (as 1 - a and a) and `iters` are launch arguments (the TPU
// kernel compiles them in).

#include "rows.cuh"

namespace repro {

constexpr int kPrices = 8;  // bisections interleaved per pass

template <int R>
__global__ void __launch_bounds__(kBlock)
mbdf_demand_kernel(const float* __restrict__ alpha,
                   const float* __restrict__ tcomp,
                   const float* __restrict__ prices, float* __restrict__ out,
                   int n, int k, int m, float one_minus_a, float a_fair,
                   int iters) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // uniform across the warp

  float a[R], tc[R], asum, tcmax;
  load_row<R>(alpha, tcomp, row, k, lane, a, tc, asum, tcmax);
  const bool active = asum > 0.f;
  const float f_hi = active ? kFCeil / fmaxf(tcmax, kTiny) : 0.f;
  const float p_max = active ? 1.f / fmaxf(asum, kTiny) : 0.f;
  const float* prow = prices + (size_t)row * m;
  float* orow = out + (size_t)row * m;

  for (int m0 = 0; m0 < m; m0 += kPrices) {
    const int mc = min(kPrices, m - m0);
    float p[kPrices], lo[kPrices], hi[kPrices];
#pragma unroll
    for (int j = 0; j < kPrices; ++j) {
      p[j] = j < mc ? prow[m0 + j] : 0.f;
      lo[j] = 0.f;
      hi[j] = f_hi;
    }
    for (int it = 0; it < iters; ++it) {
      float s[kPrices];
#pragma unroll
      for (int j = 0; j < kPrices; ++j) {
        s[j] = 0.f;
        if (j < mc) {
          const float f = 0.5f * (lo[j] + hi[j]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float one_m = fmaxf(1.f - tc[r] * f, kTiny);
            s[j] += a[r] / (one_m * one_m);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPrices; ++j) {
        if (j < mc) {  // uniform: mc is the same in every lane
          const float f = 0.5f * (lo[j] + hi[j]);
          const float q = (one_minus_a + a_fair / (1.f + f)) *
                          (1.f / fmaxf(warp_sum(s[j]), kTiny));
          if (q - p[j] > 0.f) lo[j] = f; else hi[j] = f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPrices; ++j) {
      if (j < mc) {
        float f = 0.5f * (lo[j] + hi[j]);
        if (p[j] >= p_max) f = 0.f;
        float b = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float one_m = fmaxf(1.f - tc[r] * f, kTiny);
          b += a[r] * f / one_m;
        }
        b = warp_sum(b);
        if (lane == 0) orow[m0 + j] = b;
      }
    }
  }
}

template <int R>
cudaError_t launch(const float* alpha, const float* tcomp, const float* prices,
                   float* out, int n, int k, int m, float one_minus_a,
                   float a_fair, int iters, cudaStream_t stream) {
  const int grid = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  mbdf_demand_kernel<R><<<grid, kBlock, 0, stream>>>(
      alpha, tcomp, prices, out, n, k, m, one_minus_a, a_fair, iters);
  return cudaGetLastError();
}

}  // namespace repro

// C entry, loaded with ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int mbdf_demand_launch(const float* alpha, const float* tcomp,
                                  const float* prices, float* out, int n,
                                  int k, int m, float one_minus_a,
                                  float a_fair, int iters, void* stream) {
  using namespace repro;
  auto s = static_cast<cudaStream_t>(stream);
  if (m < 1) return cudaErrorInvalidValue;
  switch (regs_per_lane(k)) {
    case 1: return launch<1>(alpha, tcomp, prices, out, n, k, m, one_minus_a, a_fair, iters, s);
    case 2: return launch<2>(alpha, tcomp, prices, out, n, k, m, one_minus_a, a_fair, iters, s);
    case 4: return launch<4>(alpha, tcomp, prices, out, n, k, m, one_minus_a, a_fair, iters, s);
    case 8: return launch<8>(alpha, tcomp, prices, out, n, k, m, one_minus_a, a_fair, iters, s);
    case 16: return launch<16>(alpha, tcomp, prices, out, n, k, m, one_minus_a, a_fair, iters, s);
    case 32: return launch<32>(alpha, tcomp, prices, out, n, k, m, one_minus_a, a_fair, iters, s);
    default: return cudaErrorInvalidValue;
  }
}
