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
// instruction count and latency (divides and a butterfly per step) set the
// time.
// Design (from the parts measured in PERF.md): a lane group of L
// lanes (rows.cuh) owns one (row, price) pair, R clients a lane, so a warp
// bisects 32 / L pairs at once with a log2 L butterfly, and one
// instruction does the per-pair scalar work (midpoint, the two divides of
// q, compare, select) of 32 / L pairs.  Pairs are numbered row-major, so
// the M groups of one row sit side by side and read it once from device
// memory, the rest from cache.  Every divide goes through div0, which
// keeps the padded clients' 0 / d and a_fair / (1 + f) at alpha_fair = 0
// off the IEEE divide's slow path, and a warp with no active row skips the
// bisection (its demands are exactly 0).  `alpha_fair` (as 1 - a and a) and
// `iters` are launch arguments (the TPU kernel compiles them in).

#include "rows.cuh"

namespace repro {

template <int L, int R>
__global__ void __launch_bounds__(kBlock)
mbdf_demand_kernel(const float* __restrict__ alpha,
                   const float* __restrict__ tcomp,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ prices, float* __restrict__ out,
                   int n, int k, int m, float one_minus_a, float a_fair,
                   int iters) {
  constexpr int G = kWarp / L;                    // pairs per warp
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;
  const long long pair =
      ((long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) * G +
      lane / L;
  const bool live = pair < (long long)n * m;
  const int row = live ? (int)(pair / m) : 0;

  float a[R], tc[R], asum, tcmax;
  unsigned valid;
  load_group_row<L, R>(alpha, tcomp, mask, row, live, k, sub, a, tc, valid,
                       asum, tcmax);
  const bool active = asum > 0.f;
  if (!__any_sync(0xffffffffu, active)) {         // uniform across the warp
    if (live && sub == 0) out[pair] = 0.f;
    return;
  }
  const float f_hi = active ? kFCeil / fmaxf(tcmax, kTiny) : 0.f;
  const float p_max = active ? 1.f / fmaxf(asum, kTiny) : 0.f;
  const float p = live ? prices[pair] : 0.f;

  float lo = 0.f, hi = f_hi;
  for (int it = 0; it < iters; ++it) {
    const float f = 0.5f * (lo + hi);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float one_m = fmaxf(1.f - tc[r] * f, kTiny);
      s += div0(a[r], one_m * one_m);
    }
    const float q = (one_minus_a + div0(a_fair, 1.f + f)) *
                    (1.f / fmaxf(group_sum<L>(s), kTiny));
    if (q - p > 0.f) lo = f; else hi = f;
  }
  float f = 0.5f * (lo + hi);
  if (p >= p_max) f = 0.f;
  float b = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float one_m = fmaxf(1.f - tc[r] * f, kTiny);
    b += div0(a[r] * f, one_m);
  }
  b = group_sum<L>(b);
  if (live && sub == 0) out[pair] = b;
}

}  // namespace repro

// C entry, loaded with ctypes; the lane group comes from K (rows.cuh
// lane_group).  Returns cudaGetLastError() after the launch.
extern "C" int mbdf_demand_launch(const float* alpha, const float* tcomp,
                                  const unsigned char* mask,
                                  const float* prices, float* out, int n,
                                  int k, int m, float one_minus_a,
                                  float a_fair, int iters, void* stream) {
  using namespace repro;
  auto s = static_cast<cudaStream_t>(stream);
  int lanes = 0, regs = 0;
  if (m < 1 || n < 1 || !lane_group(k, lanes, regs))
    return cudaErrorInvalidValue;
  const long long warps = ((long long)n * m + kWarp / lanes - 1) /
                          (kWarp / lanes);
  const long long grid = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
#define REPRO_CASE(L, R)                                                    \
  if (lanes == L && regs == R) {                                            \
    mbdf_demand_kernel<L, R><<<(unsigned)grid, kBlock, 0, s>>>(             \
        alpha, tcomp, mask, prices, out, n, k, m, one_minus_a, a_fair,      \
        iters);                                                             \
    return cudaGetLastError();                                              \
  }
  REPRO_LANE_GROUPS(REPRO_CASE)
#undef REPRO_CASE
  return cudaErrorInvalidValue;
}
