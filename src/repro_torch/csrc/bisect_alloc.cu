// bisect_alloc: batched intra-service allocation (Eq. 7) on Hopper.
//
// Replaces the Pallas TPU kernel _bisect_kernel / bisect_alloc in
// src/repro/kernels/bisect_alloc.py.  Per service row: 48 bisection trips
// on u = t - max_k t^C solving sum_k alpha_k / (u + gap_k) = b, then
// t* = max t^C + u (1/TINY where b <= 0) and the water-filling split
// alpha_k / (u + gap_k) renormalized to sum to b.  The row's clients are
// the slots the service set's mask marks, as in core/intra.py (the TPU
// kernel takes alpha > 0 as a client's mark, which drops a client with
// no transmission load from max t^C).
//
// Bound on this card: by the roofline count (each input read once, about 5
// float32 operations per valid (row, client, trip)), bytes: the row reads
// 2K floats and K mask bytes and writes K + 1 floats.  Neither binds.  At
// the main path's shape (10 rows of 45 clients) the time is a chain of 48
// dependent trips, each a divide and a butterfly, on a card whose
// schedulers are nearly all idle; at the market shapes (8192 rows) it is
// the issue rate of the trips' instructions.
// Design (rows.cuh, from the parts measured in PERF.md):
// - Lane groups: a group of L lanes holds a row in registers (R clients a
//   lane, lane_group(K)), so the trips touch no memory, a warp solves
//   32 / L rows, and one instruction does the scalar work of 32 / L rows.
// - Zero lanes: every divide has div0's bits, so the padded clients' and
//   inactive rows' 0 / d stay off the IEEE divide's slow path, and a warp
//   whose rows are inactive or have b = 0 skips its trips (their t* and
//   split do not depend on u).
// - Speculation for launches that leave the card idle: depth 2 gives a
//   row a warp whose four groups evaluate the next two trips' three
//   midpoints at once, so the chain is half as long and the bits are
//   those of depth 1; those trips divide with div_fast, which lets a
//   lane's divides overlap.  The depth is picked at launch from N, K and
//   the SM count (plan).
// The TPU's (8, 128) tiling and padding are not carried over: the kernel
// masks K's ragged edge itself and N needs no padding.

#include "rows.cuh"

namespace repro {

template <int L, int R, bool kSpec>
__global__ void __launch_bounds__(kBlock)
bisect_alloc_kernel(const float* __restrict__ alpha,
                    const float* __restrict__ tcomp,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ b, float* __restrict__ tstar,
                    float* __restrict__ balloc, int n, int k, int iters) {
  constexpr int G = kSpec ? 1 : kWarp / L;        // rows per warp
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;
  const int warp = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (warp * G >= n) return;                      // uniform across the warp
  const int row = warp * G + (kSpec ? 0 : lane / L);
  const bool live = row < n;

  float a[R], gap[R], asum, tcmax;
  unsigned valid;
  load_group_row<L, R>(alpha, tcomp, mask, row, live, k, sub, a, gap, valid,
                       asum, tcmax);
#pragma unroll
  for (int r = 0; r < R; ++r)
    gap[r] = (valid >> r) & 1u ? tcmax - gap[r] : 0.f;
  const float bn = live ? b[row] : 0.f;
  const float t = bisect_group<L, R, kSpec>(a, gap, asum, tcmax, bn, iters);
  if (live && (!kSpec || lane < L)) {             // one group writes a row
    float* out = balloc + (size_t)row * k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = sub + L * r;
      if (idx < k) out[idx] = a[r];
    }
    if (sub == 0) tstar[row] = t;
  }
}

// Speculation (`spec`, from plan) only where groups have 8 lanes.
template <int L, int R>
cudaError_t launch(bool spec, const float* alpha, const float* tcomp,
                   const unsigned char* mask, const float* b, float* tstar,
                   float* balloc, int n, int k, int iters,
                   cudaStream_t stream) {
  int threads, blocks;
  grid_of(n, L, spec, threads, blocks);
  auto kernel = bisect_alloc_kernel<L, R, false>;
  if constexpr (L == 8)
    if (spec) kernel = bisect_alloc_kernel<L, R, true>;
  kernel<<<blocks, threads, 0, stream>>>(alpha, tcomp, mask, b, tstar,
                                         balloc, n, k, iters);
  return cudaGetLastError();
}

}  // namespace repro

// The depth a launch of n rows of k clients takes on a card of `sms` SMs
// (`depth` 0: picked), -1 where it would be refused (rows.cuh plan).
extern "C" int bisect_alloc_plan(int n, int k, int depth, int sms) {
  return repro::plan(n, k, depth, sms);
}

// C entry, loaded with ctypes; `depth` 0 lets the launch pick it on a card
// of `sms` SMs (plan).  Returns cudaGetLastError() after the launch.
extern "C" int bisect_alloc_launch(const float* alpha, const float* tcomp,
                                   const unsigned char* mask, const float* b,
                                   float* tstar, float* balloc, int n, int k,
                                   int iters, int depth, int sms,
                                   void* stream) {
  using namespace repro;
  auto s = static_cast<cudaStream_t>(stream);
  int lanes = 0, regs = 0;
  const int j = plan(n, k, depth, sms);
  if (j < 0 || !lane_group(k, lanes, regs)) return cudaErrorInvalidValue;
#define REPRO_CASE(L, R)                                                    \
  if (lanes == L && regs == R)                                              \
    return launch<L, R>(j == 2, alpha, tcomp, mask, b, tstar, balloc, n, k, \
                        iters, s);
  REPRO_LANE_GROUPS(REPRO_CASE)
#undef REPRO_CASE
  return cudaErrorInvalidValue;
}
