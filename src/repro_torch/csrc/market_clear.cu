// market_clear: the whole safeguarded-Newton market clear in ONE launch.
//
// Replaces the Pallas TPU kernel _market_clear_kernel / market_clear (with
// _freq_tile) in src/repro/kernels/market_clear.py.  One launch runs: the
// bracket top max_n p_max, the warm or cold seed, `iters` Newton trips each
// reducing sum demand and sum slope over every row (bracket fold, Newton
// step, midpoint fallback), the final demand at `inner_iters`, the
// projection onto sum b = B, and the Eq. 7 frequency of every row.
//
// Bound on this card: by the roofline count, operations (the service
// tensors are 2NK floats, read once; every trip runs `newton_inner_iters`
// bisection steps of about 5 float32 operations per (row, client)).  In
// practice the grid-wide reduction on every trip, which the TPU kernel got
// for free from its sequential grid, and the dependent bisection trips
// (a divide and a warp butterfly each) set the time.
// Design: a cooperative launch (grid no larger than the co-resident block
// count, rows strided over all warps).  Each trip every block writes one
// (demand, slope) partial to a double-buffered global scratch and the grid
// synchronizes once; then warp 0 of every block sums all partials in the
// same fixed order and shares the total through shared memory, and every
// thread applies the identical dual update, so lam is bitwise the same in
// every block and from run to run with no broadcast across blocks.  Blocks
// are 512 threads and only one warp per block reads the partials: in a
// first version with 256-thread blocks every warp read them, all warps of
// the card hitting the same few L2 lines after every barrier, and the
// kernel took about 1.5 times as long (PERF.md).  Double buffering makes one
// grid barrier per trip enough: a block can only overwrite a buffer after
// every block passed the next barrier, i.e. after every block has read it.

#include <cooperative_groups.h>

#include "rows.cuh"

namespace cg = cooperative_groups;

namespace repro {

constexpr int kClearBlock = 512;                  // 16 warps, one row each
constexpr int kClearWarps = kClearBlock / kWarp;

// Block-level fold of a warp-uniform pair into this block's slot of `part`.
__device__ __forceinline__ void block_partial(float x, float y, bool use_max,
                                              float* part, float* red) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (lane == 0) {
    red[warp] = x;
    red[kClearWarps + warp] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sx = red[0], sy = red[kClearWarps];
    for (int w = 1; w < kClearWarps; ++w) {
      sx = use_max ? fmaxf(sx, red[w]) : sx + red[w];
      sy += red[kClearWarps + w];
    }
    part[2 * blockIdx.x] = sx;
    part[2 * blockIdx.x + 1] = sy;
  }
  __syncthreads();  // `red` is reused by the next phase
}

// Fixed-order fold of every block's partial by warp 0, shared with the
// block through `bcast`.  __ldcg reads through L2: the partials were written
// by other SMs.  The next write to `bcast` comes after the next
// block_partial's __syncthreads, so every thread has read it by then.
__device__ __forceinline__ float2 grid_total(const float* part, bool use_max,
                                             float* bcast) {
  if (threadIdx.x < kWarp) {
    float sx = 0.f, sy = 0.f;
#pragma unroll 4
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kWarp) {
      const float x = __ldcg(part + 2 * i);
      sx = use_max ? fmaxf(sx, x) : sx + x;
      sy += __ldcg(part + 2 * i + 1);
    }
    sx = use_max ? warp_max(sx) : warp_sum(sx);
    sy = warp_sum(sy);
    if (threadIdx.x == 0) {
      bcast[0] = sx;
      bcast[1] = sy;
    }
  }
  __syncthreads();
  return make_float2(bcast[0], bcast[1]);
}

template <int R>
__global__ void __launch_bounds__(kClearBlock)
market_clear_kernel(const float* __restrict__ alpha,
                    const float* __restrict__ tcomp, float b_total,
                    const float* __restrict__ lam_prev_p,
                    float* __restrict__ b_out, float* __restrict__ f_out,
                    float* __restrict__ lam_out, float* __restrict__ scratch,
                    int n, int k, int iters, int inner_iters,
                    int newton_inner_iters) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[2 * kClearWarps];
  __shared__ float bcast[2];
  const int lane = threadIdx.x % kWarp;
  const int first_row = blockIdx.x * kClearWarps + threadIdx.x / kWarp;
  const int row_stride = gridDim.x * kClearWarps;
  int phase = 0;
  auto buffer = [&]() { return scratch + (phase & 1) * 2 * gridDim.x; };

  float a[R], tc[R], asum, tcmax;

  // --- bracket top: lam_hi0 = max_n p_max --------------------------------
  float pm = 0.f;
  for (int row = first_row; row < n; row += row_stride) {
    load_row<R>(alpha, tcomp, row, k, lane, a, tc, asum, tcmax);
    pm = fmaxf(pm, asum > 0.f ? 1.f / fmaxf(asum, kTiny) : 0.f);
  }
  block_partial(pm, 0.f, true, buffer(), red);
  grid.sync();
  const float lam_hi0 = grid_total(buffer(), true, bcast).x;
  ++phase;

  // --- warm seed (identical to solve_lambda_newton_warm) -----------------
  const float lam_prev = *lam_prev_p;
  const bool warm_ok = lam_prev > 0.f && lam_prev < lam_hi0;
  float lam = warm_ok ? lam_prev : 0.5f * lam_hi0;
  float lo = 0.f, hi = lam_hi0;

  // --- the fixed-trip safeguarded-Newton loop ----------------------------
  for (int it = 0; it < iters; ++it) {
    float d = 0.f, s = 0.f;
    for (int row = first_row; row < n; row += row_stride) {
      load_row<R>(alpha, tcomp, row, k, lane, a, tc, asum, tcmax);
      const float2 bs =
          demand_slope_row<R>(a, tc, asum, tcmax, lam, newton_inner_iters);
      d += bs.x;
      s += bs.y;
    }
    block_partial(d, s, false, buffer(), red);
    grid.sync();
    const float2 tot = grid_total(buffer(), false, bcast);
    ++phase;
    const float resid = tot.x - b_total;
    if (resid > 0.f) lo = lam; else hi = lam;  // demand too high: raise price
    const float step = resid / (fabsf(tot.y) > kTiny ? tot.y : -kTiny);
    const float lam_newton = lam - step;
    // Non-strict bounds: a converged iterate reproduces itself.
    const bool in_bracket = lam_newton >= lo && lam_newton <= hi;
    lam = in_bracket ? lam_newton : 0.5f * (lo + hi);
  }

  // --- final demand at the full inner trip count + aggregate -------------
  float total = 0.f;
  for (int row = first_row; row < n; row += row_stride) {
    load_row<R>(alpha, tcomp, row, k, lane, a, tc, asum, tcmax);
    const float b =
        demand_slope_row<R>(a, tc, asum, tcmax, lam, inner_iters).x;
    if (lane == 0) b_out[row] = b;
    total += b;
  }
  block_partial(total, 0.f, false, buffer(), red);
  grid.sync();
  const float total_b = grid_total(buffer(), false, bcast).x;
  const float scale = b_total / fmaxf(total_b, kTiny);

  // --- project onto sum b = B, then Eq. 7 round time -> f ----------------
  for (int row = first_row; row < n; row += row_stride) {
    load_row<R>(alpha, tcomp, row, k, lane, a, tc, asum, tcmax);
    const float b = __ldcg(b_out + row) * scale;
    const float f = freq_row<R>(a, tc, asum, tcmax, b, inner_iters);
    if (lane == 0) {
      b_out[row] = b;
      f_out[row] = f;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *lam_out = lam;
}

template <int R>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&market_clear_kernel<R>);
}

const void* kernel_for(int k) {
  switch (regs_per_lane(k)) {
    case 1: return kernel_ptr<1>();
    case 2: return kernel_ptr<2>();
    case 4: return kernel_ptr<4>();
    case 8: return kernel_ptr<8>();
    case 16: return kernel_ptr<16>();
    case 32: return kernel_ptr<32>();
    default: return nullptr;
  }
}

}  // namespace repro

// Largest co-resident grid for K clients on the current device (<= 0 on
// error): the most blocks a cooperative launch may use.
extern "C" int market_clear_max_grid(int k) {
  const void* fn = repro::kernel_for(k);
  if (fn == nullptr) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -2;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -3;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fn, repro::kClearBlock, 0) != cudaSuccess)
    return -4;
  return per_sm * sms;
}

// C entry, loaded with ctypes.  `max_grid` is market_clear_max_grid(k) on
// this device, queried once by the caller, and `scratch` holds 4 * max_grid
// floats.  Returns the launch's CUDA error code.
extern "C" int market_clear_launch(const float* alpha, const float* tcomp,
                                   float b_total, const float* lam_prev,
                                   float* b, float* f, float* lam,
                                   float* scratch, int n, int k, int iters,
                                   int inner_iters, int newton_inner_iters,
                                   int max_grid, void* stream) {
  using namespace repro;
  const void* fn = kernel_for(k);
  if (fn == nullptr || max_grid <= 0 || n < 1) return cudaErrorInvalidValue;
  int grid = (n + kClearWarps - 1) / kClearWarps;
  if (grid > max_grid) grid = max_grid;
  void* args[] = {&alpha, &tcomp, &b_total, &lam_prev, &b, &f, &lam, &scratch,
                  &n, &k, &iters, &inner_iters, &newton_inner_iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kClearBlock), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
