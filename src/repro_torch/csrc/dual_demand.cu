// dual_demand: per-service demand and its closed-form slope at a dual price,
// one launch per safeguarded-Newton trip of warm cooperative DISBA.
//
// Replaces the Pallas TPU kernel _dual_demand_kernel / dual_demand (body
// demand_slope_tile) in src/repro/kernels/dual_demand.py.  Per row at price
// lam: the Eq. 14 price -> frequency bisection, the opt-out at
// lam >= 1/sum alpha, demand sum alpha f / (1 - t^C f) and the Lemma 1 slope.
//
// Bound on this card: by the roofline count, bytes (each row reads 2K
// floats and K mask bytes and writes 2 floats; the bisection runs `iters`
// trips of about 5 float32 operations per client).  Neither binds.  At the
// main path's shape (10 rows of 45 clients: 24 trips in every Newton
// step, 48 in the final demand) the time is the chain of dependent
// trips, each a divide and a butterfly, on a card whose schedulers are
// nearly all idle; at the market shapes it is the issue rate of the
// trips' instructions.
// Design: the row body is demand_slope_group (rows.cuh), the function the
// market_clear kernel runs, as both TPU kernels share demand_slope_tile:
// lane groups from lane_group(K), every divide with div0's bits, a warp
// with no active row skipping its trips, and the exact speculative
// bisection of bisect_alloc.cu (its trips on div_fast) for launches that
// leave the card idle (depth picked at launch by rows.cuh's plan, B1's
// rule; the same bits at either depth).  lam is read through a
// stride (0: one price for all rows, 1: one per row), so a scalar price
// already on the card needs no broadcast copy.

#include "rows.cuh"

namespace repro {

template <int L, int R, bool kSpec>
__global__ void __launch_bounds__(kBlock)
dual_demand_kernel(const float* __restrict__ alpha,
                   const float* __restrict__ tcomp,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ lam, int lam_stride,
                   float* __restrict__ b_out, float* __restrict__ slope_out,
                   int n, int k, int iters) {
  constexpr int G = kSpec ? 1 : kWarp / L;        // rows per warp
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;
  const int warp = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (warp * G >= n) return;                      // uniform across the warp
  const int row = warp * G + (kSpec ? 0 : lane / L);
  const bool live = row < n;

  float a[R], tc[R], asum, tcmax;
  unsigned valid;
  load_group_row<L, R>(alpha, tcomp, mask, row, live, k, sub, a, tc, valid,
                       asum, tcmax);
  const float price = lam[(size_t)(live ? row : 0) * lam_stride];
  const float2 bs =
      demand_slope_group<L, R, kSpec>(a, tc, asum, tcmax, price, iters);
  if (live && (kSpec ? lane : sub) == 0) {
    b_out[row] = bs.x;
    slope_out[row] = bs.y;
  }
}

// Speculation (`spec`, from plan) only where groups have 8 lanes.
template <int L, int R>
cudaError_t launch(bool spec, const float* alpha, const float* tcomp,
                   const unsigned char* mask, const float* lam,
                   int lam_stride, float* b, float* slope, int n, int k,
                   int iters, cudaStream_t stream) {
  int threads, blocks;
  grid_of(n, L, spec, threads, blocks);
  auto kernel = dual_demand_kernel<L, R, false>;
  if constexpr (L == 8)
    if (spec) kernel = dual_demand_kernel<L, R, true>;
  kernel<<<blocks, threads, 0, stream>>>(alpha, tcomp, mask, lam,
                                         lam_stride, b, slope, n, k, iters);
  return cudaGetLastError();
}

}  // namespace repro

// C entry, loaded with ctypes; `depth` 0 lets the launch pick it on a card
// of `sms` SMs (plan).  Returns cudaGetLastError() after the launch.
extern "C" int dual_demand_launch(const float* alpha, const float* tcomp,
                                  const unsigned char* mask, const float* lam,
                                  int lam_stride, float* b, float* slope,
                                  int n, int k, int iters,
                                  int depth, int sms, void* stream) {
  using namespace repro;
  auto s = static_cast<cudaStream_t>(stream);
  int lanes = 0, regs = 0;
  const int j = plan(n, k, depth, sms);
  if (j < 0 || !lane_group(k, lanes, regs)) return cudaErrorInvalidValue;
#define REPRO_CASE(L, R)                                                    \
  if (lanes == L && regs == R)                                              \
    return launch<L, R>(j == 2, alpha, tcomp, mask, lam, lam_stride, b,    \
                        slope, n, k, iters, s);
  REPRO_LANE_GROUPS(REPRO_CASE)
#undef REPRO_CASE
  return cudaErrorInvalidValue;
}
