// bisect_alloc: batched intra-service allocation (Eq. 7) on Hopper.
//
// Replaces the Pallas TPU kernel _bisect_kernel / bisect_alloc in
// src/repro/kernels/bisect_alloc.py.  Per service row: 48 bisection trips
// on u = t - max_k t^C solving sum_k alpha_k / (u + gap_k) = b, then
// t* = max t^C + u (1/TINY where b <= 0) and the water-filling split
// alpha_k / (u + gap_k) renormalized to sum to b.
//
// Bound on this card: by the roofline count (each input read once, about 5
// float32 operations per valid (row, client, trip)), bytes, narrowly: the
// row reads 2K floats and writes K + 1, against 48 trips of K divisions and
// adds.  In practice neither binds: the 48 trips are dependent, each a
// divide and a 5-step warp butterfly, so latency sets the time.
// Design: one warp per row, each lane keeps its clients' alpha and gap in
// registers for all trips (rows.cuh), so the trips touch no memory and the
// only per-trip communication is one warp butterfly.  The TPU's (8, 128)
// tiling and padding are not carried over: the kernel masks K's ragged edge
// itself and N needs no padding.

#include "rows.cuh"

namespace repro {

template <int R>
__global__ void __launch_bounds__(kBlock)
bisect_alloc_kernel(const float* __restrict__ alpha,
                    const float* __restrict__ tcomp,
                    const float* __restrict__ b, float* __restrict__ tstar,
                    float* __restrict__ balloc, int n, int k, int iters) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // uniform across the warp

  float a[R], gap[R], asum, tcmax;
  load_row<R>(alpha, tcomp, row, k, lane, a, gap, asum, tcmax);
#pragma unroll
  for (int r = 0; r < R; ++r) gap[r] = a[r] > 0.f ? tcmax - gap[r] : 0.f;

  const float bn = b[row];
  float lo = 0.f, hi = asum / fmaxf(bn, kTiny);
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      s += a[r] > 0.f ? a[r] / fmaxf(mid + gap[r], kTiny) : 0.f;
    if (warp_sum(s) - bn > 0.f) lo = mid; else hi = mid;
  }
  const float u = 0.5f * (lo + hi);

  float raw[R], total = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    raw[r] = a[r] > 0.f ? a[r] / fmaxf(u + gap[r], kTiny) : 0.f;
    total += raw[r];
  }
  const float scale = bn / fmaxf(warp_sum(total), kTiny);
  float* out = balloc + (size_t)row * k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = lane + kWarp * r;
    if (idx < k) out[idx] = raw[r] * scale;
  }
  if (lane == 0) tstar[row] = bn > 0.f ? tcmax + u : kInvTiny;
}

template <int R>
cudaError_t launch(const float* alpha, const float* tcomp, const float* b,
                   float* tstar, float* balloc, int n, int k, int iters,
                   cudaStream_t stream) {
  const int grid = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  bisect_alloc_kernel<R><<<grid, kBlock, 0, stream>>>(alpha, tcomp, b, tstar,
                                                      balloc, n, k, iters);
  return cudaGetLastError();
}

}  // namespace repro

// C entry, loaded with ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int bisect_alloc_launch(const float* alpha, const float* tcomp,
                                   const float* b, float* tstar, float* balloc,
                                   int n, int k, int iters, void* stream) {
  using namespace repro;
  auto s = static_cast<cudaStream_t>(stream);
  switch (regs_per_lane(k)) {
    case 1: return launch<1>(alpha, tcomp, b, tstar, balloc, n, k, iters, s);
    case 2: return launch<2>(alpha, tcomp, b, tstar, balloc, n, k, iters, s);
    case 4: return launch<4>(alpha, tcomp, b, tstar, balloc, n, k, iters, s);
    case 8: return launch<8>(alpha, tcomp, b, tstar, balloc, n, k, iters, s);
    case 16: return launch<16>(alpha, tcomp, b, tstar, balloc, n, k, iters, s);
    case 32: return launch<32>(alpha, tcomp, b, tstar, balloc, n, k, iters, s);
    default: return cudaErrorInvalidValue;
  }
}
