// dual_demand: per-service demand and its closed-form slope at a dual price,
// one launch per safeguarded-Newton trip of warm cooperative DISBA.
//
// Replaces the Pallas TPU kernel _dual_demand_kernel / dual_demand (body
// demand_slope_tile) in src/repro/kernels/dual_demand.py.  Per row at price
// lam: the Eq. 14 price -> frequency bisection, the opt-out at
// lam >= 1/sum alpha, demand sum alpha f / (1 - t^C f) and the Lemma 1 slope.
//
// Bound on this card: by the roofline count, bytes (each row reads 2K
// floats and writes 2; the bisection runs `iters` trips of about 5 float32
// operations per client).  In practice the dependent trips, a divide and a
// warp butterfly each, set the time.
// Design: one warp per row with the row in registers for every trip
// (rows.cuh); the row body demand_slope_row is the same __device__ function
// the market_clear kernel calls, as both TPU kernels share demand_slope_tile.
// lam is read through a stride (0: one price for all rows, 1: one per row),
// so a scalar price already on the card needs no broadcast copy.

#include "rows.cuh"

namespace repro {

template <int R>
__global__ void __launch_bounds__(kBlock)
dual_demand_kernel(const float* __restrict__ alpha,
                   const float* __restrict__ tcomp,
                   const float* __restrict__ lam, int lam_stride,
                   float* __restrict__ b_out, float* __restrict__ slope_out,
                   int n, int k, int iters) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // uniform across the warp

  float a[R], tc[R], asum, tcmax;
  load_row<R>(alpha, tcomp, row, k, lane, a, tc, asum, tcmax);
  const float2 bs = demand_slope_row<R>(a, tc, asum, tcmax,
                                        lam[(size_t)row * lam_stride], iters);
  if (lane == 0) {
    b_out[row] = bs.x;
    slope_out[row] = bs.y;
  }
}

template <int R>
cudaError_t launch(const float* alpha, const float* tcomp, const float* lam,
                   int lam_stride, float* b, float* slope, int n, int k,
                   int iters, cudaStream_t stream) {
  const int grid = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  dual_demand_kernel<R><<<grid, kBlock, 0, stream>>>(
      alpha, tcomp, lam, lam_stride, b, slope, n, k, iters);
  return cudaGetLastError();
}

}  // namespace repro

// C entry, loaded with ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int dual_demand_launch(const float* alpha, const float* tcomp,
                                  const float* lam, int lam_stride, float* b,
                                  float* slope, int n, int k, int iters,
                                  void* stream) {
  using namespace repro;
  auto s = static_cast<cudaStream_t>(stream);
  switch (regs_per_lane(k)) {
    case 1: return launch<1>(alpha, tcomp, lam, lam_stride, b, slope, n, k, iters, s);
    case 2: return launch<2>(alpha, tcomp, lam, lam_stride, b, slope, n, k, iters, s);
    case 4: return launch<4>(alpha, tcomp, lam, lam_stride, b, slope, n, k, iters, s);
    case 8: return launch<8>(alpha, tcomp, lam, lam_stride, b, slope, n, k, iters, s);
    case 16: return launch<16>(alpha, tcomp, lam, lam_stride, b, slope, n, k, iters, s);
    case 32: return launch<32>(alpha, tcomp, lam, lam_stride, b, slope, n, k, iters, s);
    default: return cudaErrorInvalidValue;
  }
}
