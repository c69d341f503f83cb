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
// tensors are 2NK floats and NK mask bytes, read once; every trip runs
// `newton_inner_iters` bisection steps of about 5 float32 operations per
// (row, client)).  In practice the dependent bisection steps (divides
// and a butterfly each) and the grid-wide reduction on every trip, which
// the TPU kernel got for free from its sequential grid, set the time.
//
// Design (from the parts measured in PERF.md):
// - Lane groups (rows.cuh): L lanes own a row, R clients a lane, so a warp
//   bisects 32 / L rows at once with a log2 L butterfly.
// - Zero lanes: every divide goes through div0, which keeps the padded
//   clients' and inactive rows' 0 / d off the IEEE divide's slow path (it
//   cost a third of the first version's time), and a warp with no active row skips
//   its bisections.
// - Cross-block reduction by mailboxes: a cooperative launch (every block
//   co-resident, at most one block per SM).  Each reduction, every block
//   folds its warps in order and posts its (x, y) partial to its slot,
//   then a release store of the reduction's tag; warp 0 of every block
//   polls every slot's tag with acquire loads and folds the partials in
//   block order, so lam is bitwise the same in every block and from run
//   to run, with no grid barrier and no broadcast.  Tags grow from launch
//   to launch (the wrapper hands each launch its first tag), so a slot
//   never shows a stale match.  Slots are double-buffered by the
//   reduction's parity: a block writes reduction r + 2 to the slot of r
//   only after it read every block's r + 1 partial, which each block
//   posts only after it read every r partial; so no slot is overwritten
//   before every block has read it, and one buffer pair is enough.

#include "rows.cuh"

namespace repro {

constexpr int kClearBlock = 512;                  // 16 warps
constexpr int kClearWarps = kClearBlock / kWarp;
constexpr int kSlots = 8;        // mailbox slots a lane polls: grid <= 256

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The grid-wide fold of one warp-uniform pair (x summed or maxed, y
// summed): warps in order within the block, then blocks in order through
// the mailboxes; returns the same bits in every thread of every block.
// Reduction `tag` uses the buffer of its parity since `first_tag` (cap
// slots of `part` and `tags` each).
__device__ __forceinline__ float2 grid_fold(float x, float y, bool use_max,
                                            float2* part, unsigned* tags,
                                            int cap, unsigned first_tag,
                                            unsigned tag, float2* red,
                                            float2* bcast) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int buf = (tag - first_tag) & 1;
  part += buf * cap;
  tags += buf * cap;
  if (lane == 0) red[warp] = make_float2(x, y);
  __syncthreads();
  if (warp == 0) {
    const float2 v = lane < kClearWarps ? red[lane] : make_float2(0.f, 0.f);
    const float bx = use_max ? group_max<kWarp>(v.x) : group_sum<kWarp>(v.x);
    const float by = group_sum<kWarp>(v.y);
    if (lane == 0) {
      part[blockIdx.x] = make_float2(bx, by);
      store_release(tags + blockIdx.x, tag);
    }
    // Lane l waits for slots l, l + 32, ...: one pass polls them all
    // (independent loads, one round trip), until every tag is there.
    bool seen[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      seen[j] = lane + kWarp * j >= (int)gridDim.x;
    bool all;
    do {
      unsigned got[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        got[j] = seen[j] ? tag : load_acquire(tags + lane + kWarp * j);
      all = true;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        seen[j] = got[j] == tag;
        all = all && seen[j];
      }
    } while (!all);
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (lane + kWarp * j < (int)gridDim.x) {
        const float2 p = __ldcg(part + lane + kWarp * j);
        sx = use_max ? fmaxf(sx, p.x) : sx + p.x;
        sy += p.y;
      }
    }
    __syncwarp();
    sx = use_max ? group_max<kWarp>(sx) : group_sum<kWarp>(sx);
    sy = group_sum<kWarp>(sy);
    if (lane == 0) *bcast = make_float2(sx, sy);
  }
  // The next write to `red` and `bcast` comes after the next fold's first
  // barrier, which every thread reaches only after reading these.
  __syncthreads();
  return *bcast;
}

template <int L, int R>
__global__ void __launch_bounds__(kClearBlock)
market_clear_kernel(const float* __restrict__ alpha,
                    const float* __restrict__ tcomp,
                    const unsigned char* __restrict__ mask, float b_total,
                    const float* __restrict__ lam_prev_p,
                    float* __restrict__ b_out, float* __restrict__ f_out,
                    float* __restrict__ lam_out, float2* part,
                    unsigned* tags, int cap, unsigned first_tag, int n, int k,
                    int iters, int inner_iters, int newton_inner_iters) {
  constexpr int G = kWarp / L;                    // rows per warp
  __shared__ float2 red[kClearWarps];
  __shared__ float2 bcast;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;
  // Warps are numbered block-minor, so the rows spread over every block.
  const int wid = (threadIdx.x / kWarp) * gridDim.x + blockIdx.x;
  const int first = wid * G;                      // the warp's first row
  const int stride = gridDim.x * kClearWarps * G;
  const int grp = lane / L;
  unsigned tag = first_tag;  // of the next reduction

  float a[R], tc[R], asum, tcmax;
  unsigned valid;

  // --- bracket top: lam_hi0 = max_n p_max --------------------------------
  float pm = 0.f;
  for (int base = first; base < n; base += stride) {
    const int row = base + grp;
    load_group_row<L, R>(alpha, tcomp, mask, row, row < n, k, sub, a, tc,
                         valid, asum, tcmax);
    pm = fmaxf(pm, asum > 0.f ? 1.f / fmaxf(asum, kTiny) : 0.f);
  }
  const float lam_hi0 = grid_fold(groups_max<L>(pm), 0.f, true, part, tags,
                                  cap, first_tag, tag++, red, &bcast).x;

  // --- warm seed (identical to solve_lambda_newton_warm) -----------------
  const float lam_prev = *lam_prev_p;
  const bool warm_ok = lam_prev > 0.f && lam_prev < lam_hi0;
  float lam = warm_ok ? lam_prev : 0.5f * lam_hi0;
  float lo = 0.f, hi = lam_hi0;

  // --- the fixed-trip safeguarded-Newton loop ----------------------------
  for (int it = 0; it < iters; ++it) {
    float d = 0.f, s = 0.f;
    for (int base = first; base < n; base += stride) {
      const int row = base + grp;
      load_group_row<L, R>(alpha, tcomp, mask, row, row < n, k, sub, a, tc,
                           valid, asum, tcmax);
      const float2 bs = demand_slope_group<L, R>(a, tc, asum, tcmax, lam,
                                                 newton_inner_iters);
      d += bs.x;
      s += bs.y;
    }
    const float2 tot =
        grid_fold(groups_sum<L>(d), groups_sum<L>(s), false, part, tags, cap,
                  first_tag, tag++, red, &bcast);
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
  for (int base = first; base < n; base += stride) {
    const int row = base + grp;
    load_group_row<L, R>(alpha, tcomp, mask, row, row < n, k, sub, a, tc,
                         valid, asum, tcmax);
    const float b =
        demand_slope_group<L, R>(a, tc, asum, tcmax, lam, inner_iters).x;
    if (sub == 0 && row < n) b_out[row] = b;
    total += b;
  }
  const float total_b = grid_fold(groups_sum<L>(total), 0.f, false, part, tags,
                                 cap, first_tag, tag++, red, &bcast).x;
  const float scale = b_total / fmaxf(total_b, kTiny);

  // --- project onto sum b = B, then Eq. 7 round time -> f ----------------
  // Each row's b was written above by lane 0 of the group that reads it
  // here, before the fold's block barrier.
  for (int base = first; base < n; base += stride) {
    const int row = base + grp;
    load_group_row<L, R>(alpha, tcomp, mask, row, row < n, k, sub, a, tc,
                         valid, asum, tcmax);
    const float b = row < n ? b_out[row] * scale : 0.f;
    const float f = freq_group<L, R>(a, tc, valid, asum, tcmax, b,
                                     inner_iters);
    if (sub == 0 && row < n) {
      b_out[row] = b;
      f_out[row] = f;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *lam_out = lam;
}

// The (L, R) kernel for K clients (lane_group), or nullptr.
const void* kernel_for(int k, int& lanes, int& regs) {
  if (!lane_group(k, lanes, regs)) return nullptr;
#define REPRO_CASE(L, R) \
  if (lanes == L && regs == R) \
    return reinterpret_cast<const void*>(&market_clear_kernel<L, R>);
  REPRO_LANE_GROUPS(REPRO_CASE)
#undef REPRO_CASE
  return nullptr;
}

}  // namespace repro

// Largest co-resident grid of the kernel for K clients on the current
// device (<= 0 on error): the most blocks a cooperative launch may use;
// `lanes` and `regs` get its lane group, which the grid's sizing needs.
extern "C" int market_clear_max_grid(int k, int* lanes, int* regs) {
  const void* fn = repro::kernel_for(k, *lanes, *regs);
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

// C entry, loaded with ctypes.  `grid` <= market_clear_max_grid(k) and <=
// `cap`; `part` holds 2 cap float2 and `tags` 2 cap unsigned, zeroed once
// when allocated; the launch uses the tags first_tag .. first_tag + iters
// + 2, which must exceed every tag an earlier launch left in them.
// Returns the launch's CUDA error code.
extern "C" int market_clear_launch(const float* alpha, const float* tcomp,
                                   const unsigned char* mask, float b_total,
                                   const float* lam_prev,
                                   float* b, float* f, float* lam,
                                   void* part, unsigned* tags, int cap,
                                   unsigned first_tag, int n, int k,
                                   int iters, int inner_iters,
                                   int newton_inner_iters, int grid,
                                   void* stream) {
  using namespace repro;
  int lanes = 0, regs = 0;
  const void* fn = kernel_for(k, lanes, regs);
  if (fn == nullptr || grid < 1 || grid > cap || grid > kSlots * kWarp ||
      n < 1)
    return cudaErrorInvalidValue;
  float2* part2 = static_cast<float2*>(part);
  void* args[] = {&alpha, &tcomp, &mask, &b_total, &lam_prev, &b, &f, &lam,
                  &part2, &tags, &cap, &first_tag, &n, &k, &iters,
                  &inner_iters, &newton_inner_iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kClearBlock), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
