// flash_attention_bwd: the backward of flash_attention (B5).
//
// Replaces no TPU kernel: the Pallas kernel _flash_kernel in
// src/repro/kernels/flash_attention.py has no VJP, and the JAX model
// differentiates its plain chunked attention instead.  The port's forward
// launches B5 on the card, so its gradient needs a kernel of its own.
//
// Forward (as csrc/flash_attention.cu): for a row i (a position and a query
// head) and a key j that the mask keeps (j <= i under the causal mask, i - j
// < window for window > 0, j < Skv), x_ij = q_i . k_j / sqrt(D), soft-capped
// to c tanh(x / c) when c > 0; p_i = softmax_j(x_ij); o_i = sum_j p_ij v_j.
// The forward also writes L_i = log sum_j exp(x_ij), float32 (B, Hq, Sq),
// in natural-log units in both of its kernels.  Backward, from dO and L:
//   Delta_i = sum_d dO_id o_id
//   P_ij = exp(x_ij - L_i),  dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - Delta_i) (1 - (x_ij / c)^2 under the soft cap) / sqrt(D)
//   dq_i = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
//
// Bound on this card: operations.  The backward needs 10 D operations per
// live (query, key) pair (S, dP, dq, dk, dv, 2 D each); at gemma3-1b's
// train shape (2 x 4/1 x 2048 x 256) that is 32-43 GFLOP against ~25 MB of
// q, k, v, o, dO and the gradients.
//
// bfloat16: three kernels, on wgmma fed by TMA.  The pair does 14 D a live
// pair (S and dP in both kernels), all on the tensor cores; L comes from
// the forward (taken to log2 units here: P = exp2(x log2 e - L log2 e)).
// - flash_attention_bwd_delta_kernel: Delta, a warp a row (bytes-bound,
//   ~8 MB at the train shape), float32 scratch (B, Hq, Sq).
// - flash_attention_bwd_dkdv_wgmma_kernel: one block per (batch, KV head,
//   tile of 64 keys), K and V loaded once by TMA.  It walks the G heads
//   and, for each, the 64-position tiles of that head that see its keys,
//   in a fixed order (no atomics: the same bits on every run); Q and dO
//   tiles come by TMA through a ring of stages (2 at D = 256, 3 at 128, 4
//   below) guarded by full and empty mbarriers, fed by one producer warp,
//   which also stages the tile's L and Delta.  The two consumer warpgroups
//   split the work: the first computes S^T = K Q^T (keys as wgmma's M),
//   P^T from it, and dV += P^T dO, with P^T straight from the accumulator
//   as the register A operand and dO through the descriptor's transpose
//   bit; the second computes dP^T = V dO^T, takes P f (f = d x / d dot)
//   from the first through 16 KB of shared memory (two named barriers),
//   forms dS^T and accumulates dK += dS^T Q the same way.  So each
//   warpgroup holds one 64 x D float32 accumulator (128 registers a thread
//   at D = 256) and does 4 D a pair; no transpose by hand.  Where there are
//   fewer than two key tiles an SM (the train shape: 2 x 32 tiles for 132
//   SMs), each tile's list is split over n_split blocks (up to 8; the
//   wrapper's dkdv_splits), which write float32 parts of dK and dV, and
//   flash_attention_bwd_dkdv_sum_kernel sums them in split order.
// - flash_attention_bwd_dq_wgmma_kernel: one block per (batch, KV head,
//   128 rows), rows numbered position-major over the G heads as in the
//   forward, Q and dO staged once per consumer warpgroup (64 rows each), K
//   and V tiles by TMA through a ring as the forward (32 keys at D = 256,
//   so Q, dO and two stages fit in 192 KB; 64 below).  S = Q K^T and dP =
//   dO V^T run as two wgmma groups, then P f and dS, which goes in
//   registers as the A operand of dQ += dS K, K through the transpose
//   bit.  (Issuing the next tile's products behind this tile's dQ, or dK
//   and dV, in either kernel ran slower on the card: a stage stays held
//   until the next tile has come.)
// Masks run only on the tiles that straddle the diagonal, the window's
// edge, Sq or Skv.  float32 accumulators; each gradient is rounded once to
// bf16; P and dS enter the tensor cores as bf16, as the forward's P does.
//
// float32 (full float32 arithmetic on the FMA units, no TF32): kernel 1
// (flash_attention_bwd_dq_kernel), one block per (batch, KV head, tile of
// 64 rows), reads L, writes Delta for kernel 2, and sweeps the live key
// tiles once, forming P, dP and dS and accumulating dq in registers;
// kernel 2 (flash_attention_bwd_dkdv_kernel), one block per (batch, KV
// head, tile of 32 keys), walks the row tiles (all G heads) that see its
// keys, recomputes P and dS from L and Delta, and accumulates dk and dv in
// registers, the G heads' sum taken in the block.  Shared memory: Q, dO
// (64 rows) and K, V (32 keys), rows padded by 4 floats for the float4
// reads, plus the 64 x 33 P and dS tiles: ~204 KB (kernel 1) and ~212 KB
// (kernel 2) at D = 256, one block of 256 threads per SM.  Tiles come in
// a row a warp (its position and head computed once), a lane every 32nd
// dim.
//
// Layouts: q, o, dO and dq are (B, Hq, Sq, D), k, v, dk and dv (B, Hkv, Skv,
// D), each read or written through its own (batch, head, position) strides
// with the head dim contiguous; bf16 rows 16-byte aligned with no stride-0
// dim (the TMA maps and the 16-byte loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // wgmma, descriptors, bf16 packing
#include "tma.cuh"     // Strides, mbarriers, TMA loads, tensor maps

namespace repro_bwd {

using repro::Strides;

constexpr int kRows = 64;     // rows (position, query head) a tile
constexpr int kKeys = 32;     // keys a tile
constexpr int kThreads = 256;
constexpr int kPS = kKeys + 1;  // padded row of the P and dS tiles

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B, Hq, Sq), contiguous, from the forward
  void *dq, *dk, *dv;
  float* delta;      // (B, Hq, Sq), contiguous scratch
  int hkv, g, s_len, kv_len;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale, cap_pre, cap;  // cap_pre = scale / cap (0 without the cap)
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

__device__ __forceinline__ bool live(int pos, int key, const Args& a) {
  return key < a.kv_len && (!a.causal || key <= pos) &&
         (a.window <= 0 || pos - key < a.window);
}

// The logit of a raw dot q . k and the factor d logit / d dot.
__device__ __forceinline__ float logit(float dot, const Args& a,
                                       float* factor) {
  if (a.cap > 0.f) {
    const float t = tanhf(dot * a.cap_pre);
    *factor = a.scale * (1.f - t * t);
    return a.cap * t;
  }
  *factor = a.scale;
  return dot * a.scale;
}

// ---------------------------------------------------------------------------
// float32: FMA units.
// ---------------------------------------------------------------------------

// Rows [r0, r0 + kRows) of a (position, head)-row tensor into dst (padded),
// zeros past n_rows.  base is offset to the batch.  A warp takes a row at
// a time (its position and head computed once), a lane every 32nd dim.
template <int D>
__device__ void load_rows(float* dst, const float* base, Strides st, int hi,
                          int g, int r0, int n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int row = r0 + r;
    float* out = dst + r * (D + 4);
    if (row < n_rows) {
      const float* src = base + (hi * g + row % g) * st.h + (row / g) * st.s;
#pragma unroll
      for (int d = lane; d < D; d += 32) out[d] = src[d];
    } else {
#pragma unroll
      for (int d = lane; d < D; d += 32) out[d] = 0.f;
    }
  }
}

// Keys [k0, k0 + kKeys) of a key tensor into dst (padded), zeros past
// kv_len.  base is offset to the batch and the KV head.  As load_rows.
template <int D>
__device__ void load_keys(float* dst, const float* base, long long st_s,
                          int k0, int kv_len) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < kKeys; j += kThreads / 32) {
    const int key = k0 + j;
    float* out = dst + j * (D + 4);
    if (key < kv_len) {
      const float* src = base + key * st_s;
#pragma unroll
      for (int d = lane; d < D; d += 32) out[d] = src[d];
    } else {
#pragma unroll
      for (int d = lane; d < D; d += 32) out[d] = 0.f;
    }
  }
}

// out[i][j] = a[rg*4 + i] . b[cg + 16 j] over D, from padded tiles.
template <int D>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int rg, int cg, float out[4][2]) {
  constexpr int kPad = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i][0] = out[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(rg * 4 + i) * kPad + d]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&b[(cg + 16 * j) * kPad + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = out[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        out[i][j] = s;
      }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t(2 * kRows + 2 * kKeys) * (D + 4) +
                          size_t(kRows) * kPS + 2 * kRows);
}
template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (size_t(2 * kRows + 2 * kKeys) * (D + 4) +
                          2 * size_t(kRows) * kPS + 2 * kRows);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(Args a) {
  constexpr int kPad = D + 4;
  constexpr int kDims = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kRows * kPad;
  float* k_s = do_s + kRows * kPad;
  float* v_s = k_s + kKeys * kPad;
  float* ds_s = v_s + kKeys * kPad;
  float* row_l = ds_s + kRows * kPS;
  float* row_d = row_l + kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bi = blockIdx.y / a.hkv, hi = blockIdx.y % a.hkv;
  const int g = a.g, n_rows = a.s_len * g;
  const int r0 = blockIdx.x * kRows;
  const float* q = static_cast<const float*>(a.q) + bi * a.qs.b;
  const float* dout = static_cast<const float*>(a.dout) + bi * a.dos.b;
  const float* o = static_cast<const float*>(a.o) + bi * a.os.b;
  const float* k = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const long long stat0 = (long long)bi * a.hkv * g * a.s_len;

  load_rows<D>(q_s, q, a.qs, hi, g, r0, n_rows);
  load_rows<D>(do_s, dout, a.dos, hi, g, r0, n_rows);
  if (tid < kRows) {  // L from the forward
    const int row = r0 + tid;
    row_l[tid] = row < n_rows
                     ? a.lse[stat0 + (long long)(hi * g + row % g) * a.s_len +
                             row / g]
                     : 0.f;
  }
  __syncthreads();

  // Delta: warp w takes rows w*8 .. w*8+7, a lane per D/32 dims.
  for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
    const int r = warp * (kRows / (kThreads / 32)) + rr, row = r0 + r;
    float part = 0.f;
    if (row < n_rows) {
      const int pos = row / g, head = hi * g + row % g;
      const float* orow = o + head * a.os.h + pos * a.os.s;
      for (int d = lane; d < D; d += 32)
        part = fmaf(do_s[r * kPad + d], orow[d], part);
    }
    part = warp_sum(part);
    if (lane == 0) {
      row_d[r] = part;
      if (row < n_rows) {
        const int pos = row / g, head = hi * g + row % g;
        a.delta[stat0 + (long long)head * a.s_len + pos] = part;
      }
    }
  }

  const int p_lo = r0 / g;
  const int p_hi = (min(r0 + kRows, n_rows) - 1) / g;
  const int k_begin = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
  const int k_end = a.causal ? min(a.kv_len, p_hi + 1) : a.kv_len;
  const int k_first = (k_begin / kKeys) * kKeys;
  const int rg = tid / 16, cg = tid % 16;

  // One sweep: dS, and dq = dS K.
  float acc[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  for (int k0 = k_first; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the last tile's readers are done; Delta is written
    load_keys<D>(k_s, k, a.ks.s, k0, a.kv_len);
    load_keys<D>(v_s, v, a.vs.s, k0, a.kv_len);
    __syncthreads();
    float dot[4][2], dp[4][2];
    tile_dots<D>(q_s, k_s, rg, cg, dot);
    tile_dots<D>(do_s, v_s, rg, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, pos = (r0 + r) / g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float f, ds = 0.f;
        if (live(pos, k0 + cg + 16 * j, a)) {
          const float p = expf(logit(dot[i][j], a, &f) - row_l[r]);
          ds = p * (dp[i][j] - row_d[r]) * f;
        }
        ds_s[r * kPS + cg + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_s[(rg * 4 + i) * kPS + j];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const float kx = k_s[j * kPad + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kx, acc[i][c]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq) + bi * a.dqs.b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg * 4 + i;
    if (row >= n_rows) continue;
    const int pos = row / g, head = hi * g + row % g;
    float* drow = dq + head * a.dqs.h + pos * a.dqs.s;
#pragma unroll
    for (int c = 0; c < kDims; ++c) drow[cg + 16 * c] = acc[i][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(Args a) {
  constexpr int kPad = D + 4;
  constexpr int kDims = D / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kKeys * kPad;
  float* q_s = v_s + kKeys * kPad;
  float* do_s = q_s + kRows * kPad;
  float* p_s = do_s + kRows * kPad;
  float* ds_s = p_s + kRows * kPS;
  float* row_l = ds_s + kRows * kPS;
  float* row_d = row_l + kRows;

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / a.hkv, hi = blockIdx.y % a.hkv;
  const int g = a.g, n_rows = a.s_len * g;
  const int k0 = blockIdx.x * kKeys;
  const float* q = static_cast<const float*>(a.q) + bi * a.qs.b;
  const float* dout = static_cast<const float*>(a.dout) + bi * a.dos.b;
  const float* k = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const long long stat0 = (long long)bi * a.hkv * g * a.s_len;

  load_keys<D>(k_s, k, a.ks.s, k0, a.kv_len);
  load_keys<D>(v_s, v, a.vs.s, k0, a.kv_len);

  // The positions that see a key of this tile.
  const int k_last = min(k0 + kKeys, a.kv_len) - 1;
  const int p_lo = a.causal ? k0 : 0;
  const int p_hi = a.window > 0 ? min(a.s_len - 1, k_last + a.window - 1)
                                : a.s_len - 1;
  const int rg = tid / 16, cg = tid % 16;  // scores: 4 rows, keys cg, cg+16
  const int kg = tid / 16;                 // sums: keys 2 kg, 2 kg + 1
  float dk[2][kDims], dv[2][kDims];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int c = 0; c < kDims; ++c) dk[kk][c] = dv[kk][c] = 0.f;

  for (int r0 = p_lo * g; r0 < (p_hi + 1) * g; r0 += kRows) {
    __syncthreads();  // the last tile's readers are done
    load_rows<D>(q_s, q, a.qs, hi, g, r0, n_rows);
    load_rows<D>(do_s, dout, a.dos, hi, g, r0, n_rows);
    if (tid < kRows) {
      const int row = r0 + tid;
      float lse = 0.f, delta = 0.f;
      if (row < n_rows) {
        const long long at = stat0 + (long long)(hi * g + row % g) * a.s_len +
                             row / g;
        lse = a.lse[at];
        delta = a.delta[at];
      }
      row_l[tid] = lse;
      row_d[tid] = delta;
    }
    __syncthreads();
    float dot[4][2], dp[4][2];
    tile_dots<D>(q_s, k_s, rg, cg, dot);
    tile_dots<D>(do_s, v_s, rg, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, row = r0 + r, pos = row / g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float f, p = 0.f, ds = 0.f;
        if (row < n_rows && live(pos, k0 + cg + 16 * j, a)) {
          p = expf(logit(dot[i][j], a, &f) - row_l[r]);
          ds = p * (dp[i][j] - row_d[r]) * f;
        }
        p_s[r * kPS + cg + 16 * j] = p;
        ds_s[r * kPS + cg + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kRows; ++i) {
      float p[2], ds[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        p[kk] = p_s[i * kPS + 2 * kg + kk];
        ds[kk] = ds_s[i * kPS + 2 * kg + kk];
      }
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const float dox = do_s[i * kPad + cg + 16 * c];
        const float qx = q_s[i * kPad + cg + 16 * c];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          dv[kk][c] = fmaf(p[kk], dox, dv[kk][c]);
          dk[kk][c] = fmaf(ds[kk], qx, dk[kk][c]);
        }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk) + bi * a.dks.b + hi * a.dks.h;
  float* dvb = static_cast<float*>(a.dv) + bi * a.dvs.b + hi * a.dvs.h;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int key = k0 + 2 * kg + kk;
    if (key >= a.kv_len) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      dkb[key * a.dks.s + cg + 16 * c] = dk[kk][c];
      dvb[key * a.dvs.s + cg + 16 * c] = dv[kk][c];
    }
  }
}

template <int D>
int launch_f32(const Args& a, int b, cudaStream_t stream) {
  const size_t smem1 = dq_smem_bytes<D>(), smem2 = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((a.s_len * a.g + kRows - 1) / kRows, b * a.hkv);
  flash_attention_bwd_dq_kernel<D><<<grid1, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((a.kv_len + kKeys - 1) / kKeys, b * a.hkv);
  flash_attention_bwd_dkdv_kernel<D><<<grid2, kThreads, smem2, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: Delta, then dk and dv, then dq, on wgmma fed by TMA.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using repro::k_step;
using repro::kmajor_desc;
using repro::mnmajor_desc;
using repro::smem_u32;
using repro::TmaOrder;

constexpr int kWgThreads = 384;   // a producer warpgroup and two consumers
constexpr int kTile = 64;         // wgmma's M: a warpgroup's rows or keys
constexpr float kLog2e = 1.4426950408889634f;

// Tiles at head dim D, each stored as TMA writes it (tma.cuh RowTile).
template <int D>
struct Geo {
  static constexpr int kSwizzle = repro::RowTile<D>::kBytes;  // a smem row
  static constexpr int kN = D >= 64 ? 64 : 32;  // N of one wgmma along D
  static constexpr int kTileBytes = kTile * D * 2;
  // dq kernel: Q and dO of two warpgroups, then stages of (K, V).
  static constexpr int kDqKeys = D == 256 ? 32 : 64;
  static constexpr int kDqStages = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr int kDqKVBytes = kDqKeys * D * 2;
  static constexpr size_t kDqSmem = 1024 + 4 * size_t(kTileBytes) +
                                    2 * size_t(kDqStages) * kDqKVBytes +
                                    8 * 3 * kDqStages;
  // dk/dv kernel: K, V, stages of (Q, dO), P f, stages of (L, Delta).
  static constexpr int kKvStages = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr size_t kKvSmem =
      1024 + 2 * size_t(kTileBytes) + 2 * size_t(kKvStages) * kTileBytes +
      4 * kTile * kTile + 4 * 2 * kTile * kKvStages + 8 * (1 + 2 * kKvStages);
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// S (+)= A B^T over D, both K-major: N = 64 or 32 columns.
template <int D, int N>
__device__ __forceinline__ void dot_tiles(float (&s)[N / 2], uint32_t a_addr,
                                          int a_rows, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = kmajor_desc<D>(a_addr + k_step<D>(kk, a_rows));
    const uint64_t db = kmajor_desc<D>(b_addr + k_step<D>(kk, N));
    if constexpr (N == 64)
      repro::wgmma_ss_n64(s, da, db, kk > 0);
    else
      repro::wgmma_ss_n32(s, da, db, kk > 0);
  }
}

// acc += A B, A (64 x K) in registers as K / 16 fragments, B the tile of
// K rows x D at b_addr, read through the transpose bit.
template <int D, int K>
__device__ __forceinline__ void acc_tiles(float (&acc)[D / Geo<D>::kN]
                                                      [Geo<D>::kN / 2],
                                          const uint32_t (&a)[K / 16][4],
                                          uint32_t b_addr) {
  using W = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < D / W::kN; ++c) {
      const uint64_t db = mnmajor_desc<D>(
          b_addr + c * K * W::kSwizzle + kk * 16 * W::kSwizzle, K);
      if constexpr (W::kN == 64)
        repro::wgmma_rs_n64(acc[c], a[kk], db);
      else
        repro::wgmma_rs_n32(acc[c], a[kk], db);
    }
}

// Delta_i = sum_d dO_id o_id, a warp a row; rows (batch, head, position)
// flat, written to delta contiguous.
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_kernel(const bf16* __restrict__ o,
                                 const bf16* __restrict__ dout,
                                 float* __restrict__ delta, int hq, int s_len,
                                 int d, long long n_rows, Strides os,
                                 Strides dos) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // a whole warp
  const int pos = (int)(row % s_len);
  const long long bh = row / s_len;
  const int bi = (int)(bh / hq), h = (int)(bh % hq);
  const bf16* orow = o + bi * os.b + h * os.h + pos * os.s;
  const bf16* drow = dout + bi * dos.b + h * dos.h + pos * dos.s;
  float sum = 0.f;
  for (int c = lane; c < d / 8; c += 32) {
    const uint4 x = *reinterpret_cast<const uint4*>(orow + c * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(drow + c * 8);
    const __nv_bfloat162* px = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* py = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(px[e]);
      const float2 fy = __bfloat1622float2(py[e]);
      sum = fmaf(fx.x, fy.x, sum);
      sum = fmaf(fx.y, fy.y, sum);
    }
  }
  sum = warp_sum(sum);
  if (lane == 0) delta[row] = sum;
}

// The soft-capped logit in log2 units of a raw dot and f = d x / d dot
// (natural units).
__device__ __forceinline__ float logit2(float dot, float scale_log2,
                                        float scale, float cap_pre,
                                        float cap_post, float* f) {
  if (cap_post > 0.f) {
    const float t = tanhf(dot * cap_pre);
    *f = scale * (1.f - t * t);
    return cap_post * t;
  }
  *f = scale;
  return dot * scale_log2;
}

// Block i takes (batch x KV head) i % bh, key tile i / bh / n_split and
// part i / bh % n_split of that tile's (head, position tile) list: under
// the causal mask the first key tiles see the most positions, so the
// heaviest blocks launch first.  With n_split > 1 each block writes its
// float32 dV, dK to part[(split, dv / dk, bh, key, D)], summed in split
// order by flash_attention_bwd_dkdv_sum_kernel.  Threads 0-31 load;
// 128-255 form S^T, P^T and dV; 256-383 dP^T, dS^T and dK.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dkdv_wgmma_kernel(
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
    int n_split, const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, TmaOrder qo, TmaOrder doo,
    TmaOrder ko, TmaOrder vo, int hkv, int bh, int g, int s_len, int kv_len,
    Strides dks, Strides dvs, int causal, int window, float scale_log2,
    float scale, float cap_pre, float cap_post) {
  using W = Geo<D>;
  constexpr int kStages = W::kKvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + W::kTileBytes;
  uint8_t* qdo_s = smem + 2 * W::kTileBytes;  // stage s: Q, then dO
  float* pf_s = reinterpret_cast<float*>(qdo_s + 2 * kStages * W::kTileBytes);
  float* stat_s = pf_s + kTile * kTile;  // stage s: L log2 e, then Delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stat_s + 2 * kTile * kStages);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bhi = blockIdx.x % bh, job = blockIdx.x / bh;
  const int kt = job / n_split, split = job % n_split;
  const int bi = bhi / hkv, hi = bhi % hkv;
  const int k0 = kt * kTile;
  // The position tiles of each head that see a key of this tile.
  const int k_last = min(k0 + kTile, kv_len) - 1;
  const int p_lo = causal ? k0 : 0;
  const int p_hi = window > 0 ? min(s_len - 1, k_last + window - 1)
                              : s_len - 1;
  const int pt_lo = p_lo / kTile;
  const int n_pt = p_hi >= p_lo ? p_hi / kTile - pt_lo + 1 : 0;
  const int it_lo = (int)((long long)g * n_pt * split / n_split);
  const int it_hi = (int)((long long)g * n_pt * (split + 1) / n_split);
  const int n_it = it_hi - it_lo;  // this block's part of the list

  if (threadIdx.x == 0) {
    repro::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 32);       // the producer warp's lanes
      repro::mbar_init(&empty[s], 2 * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // --- producer: K and V once, then the ring of (Q, dO, L, Delta) -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        repro::mbar_expect_tx(kv_full, 2 * W::kTileBytes);
        repro::tma_load_rows<D>(k_s, &k_map, ko, kv_full, k0, hi, bi, kTile);
        repro::tma_load_rows<D>(v_s, &v_map, vo, kv_full, k0, hi, bi, kTile);
      }
      for (int it = 0; it < n_it; ++it) {
        const int stage = it % kStages;
        const int head = hi * g + (it_lo + it) / n_pt;
        const int p0 = (pt_lo + (it_lo + it) % n_pt) * kTile;
        repro::mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        float* st = stat_s + stage * 2 * kTile;
        const long long at = ((long long)bi * hkv * g + head) * s_len;
        for (int j = lane; j < kTile; j += 32) {
          const int pos = p0 + j;
          st[j] = pos < s_len ? lse[at + pos] * kLog2e : 0.f;
          st[kTile + j] = pos < s_len ? delta[at + pos] : 0.f;
        }
        if (lane == 0) {
          uint8_t* q_t = qdo_s + stage * 2 * W::kTileBytes;
          repro::mbar_expect_tx(&full[stage], 2 * W::kTileBytes);
          repro::tma_load_rows<D>(q_t, &q_map, qo, &full[stage], p0, head, bi,
                                  kTile);
          repro::tma_load_rows<D>(q_t + W::kTileBytes, &do_map, doo,
                                  &full[stage], p0, head, bi, kTile);
        } else {
          repro::mbar_arrive(&full[stage]);
        }
      }
    }
  } else {
    // --- consumers: role 0 S^T, P^T, dV; role 1 dP^T, dS^T, dK ------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int role = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int grp = lane / 4, tig = lane % 4;  // fragment coordinates
    const int key_a = k0 + warp * 16 + grp, key_b = key_a + 8;
    const uint32_t a_addr = smem_u32(role == 0 ? k_s : v_s);
    constexpr int kAccBlocks = D / W::kN, kAccRegs = W::kN / 2;
    float acc[kAccBlocks][kAccRegs];
#pragma unroll
    for (int c = 0; c < kAccBlocks; ++c)
#pragma unroll
      for (int i = 0; i < kAccRegs; ++i) acc[c][i] = 0.f;

    repro::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int stage = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int p0 = (pt_lo + (it_lo + it) % n_pt) * kTile;
      const uint32_t q_addr = smem_u32(qdo_s + stage * 2 * W::kTileBytes);
      const uint32_t do_addr = q_addr + W::kTileBytes;
      const float* st = stat_s + stage * 2 * kTile;
      const bool edge = k0 + kTile > kv_len || p0 + kTile > s_len ||
                        (causal && k0 + kTile - 1 > p0) ||
                        (window > 0 && p0 + kTile - 1 - k0 >= window);

      // x = S^T (role 0) or dP^T (role 1): 64 keys x 64 positions.
      // x[4j + e]: position p0 + 8j + 2 tig + (e & 1), key a for e < 2.
      float x[32];
      repro::mbar_wait(&full[stage], parity);
      repro::wgmma_fence();
      dot_tiles<D, 64>(x, a_addr, kTile, role == 0 ? q_addr : do_addr);
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(x);

      if (role == 0) {
        if (it > 0)  // role 1 has read the last P f
          asm volatile("bar.sync 2, 256;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int pos = p0 + 8 * (i / 4) + 2 * tig + (i & 1);
          const int key = (i & 2) ? key_b : key_a;
          float f;
          const float x2 =
              logit2(x[i], scale_log2, scale, cap_pre, cap_post, &f);
          const bool on = !edge || (key < kv_len && pos < s_len &&
                                    (!causal || key <= pos) &&
                                    (window <= 0 || pos - key < window));
          const float p = on ? exp2f(x2 - st[pos - p0]) : 0.f;
          pf_s[i * 128 + tw] = p * f;
          x[i] = p;
        }
        asm volatile("bar.arrive 1, 256;\n" ::: "memory");
      } else {
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int pos = p0 + 8 * (i / 4) + 2 * tig + (i & 1);
          x[i] = pf_s[i * 128 + tw] * (x[i] - st[kTile + pos - p0]);
        }
        if (it + 1 < n_it) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
      }

      // P^T or dS^T as the register A operand, 16 positions per step.
      uint32_t fa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          fa[kk][h] = repro::pack_bf16(x[8 * kk + 2 * h],
                                       x[8 * kk + 2 * h + 1]);

      // dV += P^T dO (role 0), dK += dS^T Q (role 1).
      repro::wgmma_fence();
      acc_tiles<D, kTile>(acc, fa, role == 0 ? do_addr : q_addr);
      repro::wgmma_commit();
      repro::wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kAccBlocks; ++c) repro::fence_regs(acc[c]);
      repro::fence_regs(fa);
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(&empty[stage]);
    }

    // acc[c][4j + e]: dim c kN + 8j + 2 tig + (e & 1), key a for e < 2.
    bf16* out = role == 0 ? dv + bi * dvs.b + hi * dvs.h
                          : dk + bi * dks.b + hi * dks.h;
    const long long out_s = role == 0 ? dvs.s : dks.s;
    float* out_f = part + ((long long)(split * 2 + role) * bh + bhi) *
                              kv_len * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? key_b : key_a;
      if (key >= kv_len) continue;
      bf16* row = out + key * out_s + tig * 2;
      float* row_f = out_f + (long long)key * D + tig * 2;
#pragma unroll
      for (int c = 0; c < kAccBlocks; ++c)
#pragma unroll
        for (int j = 0; j < kAccRegs / 4; ++j) {
          const float lo = acc[c][4 * j + 2 * half];
          const float hi_ = acc[c][4 * j + 2 * half + 1];
          if (n_split > 1)
            *reinterpret_cast<float2*>(row_f + c * W::kN + 8 * j) =
                make_float2(lo, hi_);
          else
            *reinterpret_cast<__nv_bfloat162*>(row + c * W::kN + 8 * j) =
                __floats2bfloat162_rn(lo, hi_);
        }
    }
  }
}

// dV and dK from the n_split float32 parts, summed in split order and
// rounded once to bf16: a thread per 2 dims of a (dv / dk, bh, key) row.
__global__ void __launch_bounds__(256)
flash_attention_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int n_split,
                                    int hkv, int bh, int kv_len, int d,
                                    Strides dks, Strides dvs) {
  const long long pair = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long per_role = (long long)bh * kv_len * d / 2;
  if (pair >= 2 * per_role) return;
  const int role = (int)(pair / per_role);
  const long long at = pair % per_role * 2;  // (bh, key, dim) flat
  const int dim = (int)(at % d);
  const int key = (int)(at / d % kv_len);
  const int bhi = (int)(at / d / kv_len);
  float2 sum = make_float2(0.f, 0.f);
  for (int sp = 0; sp < n_split; ++sp) {
    const float2 x = *reinterpret_cast<const float2*>(
        part + (long long)(sp * 2 + role) * bh * kv_len * d + at);
    sum.x += x.x;
    sum.y += x.y;
  }
  const Strides st = role == 0 ? dvs : dks;
  bf16* out = (role == 0 ? dv : dk) + (bhi / hkv) * st.b +
              (bhi % hkv) * st.h + key * st.s + dim;
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(sum.x,
                                                                  sum.y);
}

// Q and dO rows [row0, row0 + 64) of one warpgroup, 16 bytes a load, into
// the swizzled K-major layout TMA gives the key tiles; zeros past n_rows.
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* q_s, uint8_t* do_s,
                                           const bf16* q, Strides qs,
                                           const bf16* dout, Strides dos,
                                           int hi, int g, int row0,
                                           int n_rows, int tw) {
  using W = Geo<D>;
  constexpr int kChunks = D / 8;                // 16-byte chunks a row
  constexpr int kRowChunks = W::kSwizzle / 16;  // chunks a smem row
  for (int idx = tw; idx < kTile * kChunks; idx += 128) {
    const int r = idx / kChunks, c = idx % kChunks, row = row0 + r;
    uint4 x = make_uint4(0, 0, 0, 0), y = make_uint4(0, 0, 0, 0);
    if (row < n_rows) {
      const int pos = row / g, head = hi * g + row % g;
      x = *reinterpret_cast<const uint4*>(q + head * qs.h + pos * qs.s +
                                          c * 8);
      y = *reinterpret_cast<const uint4*>(dout + head * dos.h +
                                          pos * dos.s + c * 8);
    }
    const int swz = ((r * W::kSwizzle) >> 7) & (kRowChunks - 1);
    const int at = (c / kRowChunks) * kTile * W::kSwizzle + r * W::kSwizzle +
                   ((c % kRowChunks) ^ swz) * 16;
    *reinterpret_cast<uint4*>(q_s + at) = x;
    *reinterpret_cast<uint4*>(do_s + at) = y;
  }
}

// Block i takes (batch x KV head) i % bh and row tile n_tiles - 1 - i / bh,
// the heaviest tiles first.  Threads 0-127 load (one thread); 128-255 and
// 256-383 each own 64 of the block's 128 rows.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, TmaOrder ko, TmaOrder vo,
    int hkv, int bh, int n_tiles, int g, int s_len, int kv_len, Strides qs,
    Strides dos, Strides dqs, int causal, int window, float scale_log2,
    float scale, float cap_pre, float cap_post) {
  using W = Geo<D>;
  constexpr int kKeys = W::kDqKeys, kStages = W::kDqStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* kv_s = smem + 4 * W::kTileBytes;  // Q 0, Q 1, dO 0, dO 1 first
  uint64_t* full_k = reinterpret_cast<uint64_t*>(
      kv_s + 2 * kStages * W::kDqKVBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int bhi = blockIdx.x % bh;
  const int tile = n_tiles - 1 - blockIdx.x / bh;
  const int bi = bhi / hkv, hi = bhi % hkv;
  const int n_rows = s_len * g;
  const int r0 = tile * 2 * kTile;
  const int p_lo = r0 / g;
  const int p_hi = (min(r0 + 2 * kTile, n_rows) - 1) / g;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_end = causal ? min(kv_len, p_hi + 1) : kv_len;
  const int t_begin = k_begin / kKeys;
  const int t_end = (k_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full_k[s], 1);
      repro::mbar_init(&full_v[s], 1);
      repro::mbar_init(&empty[s], 2 * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // --- producer: one thread keeps the ring of K/V tiles full ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int stage = it % kStages;
        repro::mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        uint8_t* k_t = kv_s + stage * 2 * W::kDqKVBytes;
        repro::mbar_expect_tx(&full_k[stage], W::kDqKVBytes);
        repro::tma_load_rows<D>(k_t, &k_map, ko, &full_k[stage], t * kKeys,
                                hi, bi, kKeys);
        repro::mbar_expect_tx(&full_v[stage], W::kDqKVBytes);
        repro::tma_load_rows<D>(k_t + W::kDqKVBytes, &v_map, vo,
                                &full_v[stage], t * kKeys, hi, bi, kKeys);
      }
    }
  } else {
    // --- consumers: 64 rows per warpgroup --------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int grp = lane / 4, tig = lane % 4;  // fragment coordinates
    const int wrow0 = r0 + wg * kTile;
    uint8_t* q_s = smem + wg * W::kTileBytes;
    uint8_t* do_s = smem + (2 + wg) * W::kTileBytes;
    stage_rows<D>(q_s, do_s, q + bi * qs.b, qs, dout + bi * dos.b, dos, hi,
                  g, wrow0, n_rows, tw);
    // The generic-proxy stores must be visible to wgmma (async proxy).
    repro::fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    const int row_a = wrow0 + warp * 16 + grp, row_b = row_a + 8;
    const int pos_a = row_a / g, pos_b = row_b / g;
    const int wpos_lo = wrow0 / g, wpos_hi = (wrow0 + kTile - 1) / g;
    const long long st0 = ((long long)bi * hkv + hi) * g;
    float l2_a = 0.f, l2_b = 0.f, d_a = 0.f, d_b = 0.f;
    if (row_a < n_rows) {
      const long long at = (st0 + row_a % g) * s_len + pos_a;
      l2_a = lse[at] * kLog2e;
      d_a = delta[at];
    }
    if (row_b < n_rows) {
      const long long at = (st0 + row_b % g) * s_len + pos_b;
      l2_b = lse[at] * kLog2e;
      d_b = delta[at];
    }
    const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
    constexpr int kAccBlocks = D / W::kN, kAccRegs = W::kN / 2;
    float acc[kAccBlocks][kAccRegs];
#pragma unroll
    for (int c = 0; c < kAccBlocks; ++c)
#pragma unroll
      for (int i = 0; i < kAccRegs; ++i) acc[c][i] = 0.f;

    for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
      const int stage = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const uint32_t k_addr = smem_u32(kv_s + stage * 2 * W::kDqKVBytes);
      const uint32_t v_addr = k_addr + W::kDqKVBytes;

      // S = Q K^T and dP = dO V^T, two groups: rows x kKeys, float32.
      // s[4j + e]: key 8j + 2 tig + (e & 1), row a for e < 2.
      float s[kKeys / 2], dp[kKeys / 2];
      repro::mbar_wait(&full_k[stage], parity);
      repro::wgmma_fence();
      dot_tiles<D, kKeys>(s, q_addr, kTile, k_addr);
      repro::wgmma_commit();
      repro::mbar_wait(&full_v[stage], parity);
      dot_tiles<D, kKeys>(dp, do_addr, kTile, v_addr);
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(s);
      repro::fence_regs(dp);

      // P f; the masks only on the tiles that straddle the diagonal, the
      // window's edge or Skv.
      const int k0 = t * kKeys;
      const bool edge = (causal && k0 + kKeys - 1 > wpos_lo) ||
                        (window > 0 && k0 <= wpos_hi - window) ||
                        k0 + kKeys > kv_len;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
        const int pos = (i & 2) ? pos_b : pos_a;
        float f;
        const float x2 = logit2(s[i], scale_log2, scale, cap_pre, cap_post,
                                &f);
        const bool on = !edge || (key < kv_len && (!causal || key <= pos) &&
                                  (window <= 0 || pos - key < window));
        s[i] = on ? exp2f(x2 - ((i & 2) ? l2_b : l2_a)) * f : 0.f;
      }

      // dS as the register A operand, 16 keys per step.
      uint32_t da[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = 8 * kk + 2 * h;
          const float dl = (h & 1) ? d_b : d_a;
          da[kk][h] = repro::pack_bf16(s[e] * (dp[e] - dl),
                                       s[e + 1] * (dp[e + 1] - dl));
        }

      // dQ += dS K, K through the transpose bit.
      repro::wgmma_fence();
      acc_tiles<D, kKeys>(acc, da, k_addr);
      repro::wgmma_commit();
      repro::wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kAccBlocks; ++c) repro::fence_regs(acc[c]);
      repro::fence_regs(da);
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(&empty[stage]);
    }

    // acc[c][4j + e]: dim c kN + 8j + 2 tig + (e & 1), row a for e < 2.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      if (row >= n_rows) continue;
      bf16* drow = dq + bi * dqs.b + (hi * g + row % g) * dqs.h +
                   (row / g) * dqs.s + tig * 2;
#pragma unroll
      for (int c = 0; c < kAccBlocks; ++c)
#pragma unroll
        for (int j = 0; j < kAccRegs / 4; ++j)
          *reinterpret_cast<__nv_bfloat162*>(drow + c * W::kN + 8 * j) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * half],
                                    acc[c][4 * j + 2 * half + 1]);
    }
  }
}

template <int D>
int launch_bf16(const Args& a, int b, float* part, int n_split,
                cudaStream_t stream) {
  using W = Geo<D>;
  const int hq = a.hkv * a.g, bh = b * a.hkv;
  const long long n_rows = (long long)b * hq * a.s_len;
  flash_attention_bwd_delta_kernel<<<(unsigned)((n_rows + 7) / 8), 256, 0,
                                     stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      a.delta, hq, a.s_len, D, n_rows, a.os, a.dos);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  CUtensorMap q_map, do_map, k_map, v_map, kd_map, vd_map;
  TmaOrder qo, doo, ko, vo, kdo, vdo;
  int err = 0;
  if ((err = repro::encode_rows<D>(&q_map, &qo, a.q, b, hq, a.s_len, a.qs,
                                   kTile)) ||
      (err = repro::encode_rows<D>(&do_map, &doo, a.dout, b, hq, a.s_len,
                                   a.dos, kTile)) ||
      (err = repro::encode_rows<D>(&k_map, &ko, a.k, b, a.hkv, a.kv_len,
                                   a.ks, kTile)) ||
      (err = repro::encode_rows<D>(&v_map, &vo, a.v, b, a.hkv, a.kv_len,
                                   a.vs, kTile)) ||
      (err = repro::encode_rows<D>(&kd_map, &kdo, a.k, b, a.hkv, a.kv_len,
                                   a.ks, W::kDqKeys)) ||
      (err = repro::encode_rows<D>(&vd_map, &vdo, a.v, b, a.hkv, a.kv_len,
                                   a.vs, W::kDqKeys)))
    return err;

  const float scale_log2 = a.scale * kLog2e, cap_post = a.cap * kLog2e;
  cerr = cudaFuncSetAttribute(flash_attention_bwd_dkdv_wgmma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)W::kKvSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_ktiles = (a.kv_len + kTile - 1) / kTile;
  flash_attention_bwd_dkdv_wgmma_kernel<D><<<n_ktiles * n_split * bh,
                                             kWgThreads, W::kKvSmem,
                                             stream>>>(
      a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      part, n_split, q_map, do_map, k_map, v_map, qo, doo, ko, vo, a.hkv, bh,
      a.g, a.s_len, a.kv_len, a.dks, a.dvs, a.causal, a.window, scale_log2,
      a.scale, a.cap_pre, cap_post);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  if (n_split > 1) {
    const long long pairs = (long long)bh * a.kv_len * D;  // 2 roles / 2
    flash_attention_bwd_dkdv_sum_kernel<<<(unsigned)((pairs + 255) / 256),
                                          256, 0, stream>>>(
        part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_split,
        a.hkv, bh, a.kv_len, D, a.dks, a.dvs);
    cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return (int)cerr;
  }

  cerr = cudaFuncSetAttribute(flash_attention_bwd_dq_wgmma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)W::kDqSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_tiles = (a.s_len * a.g + 2 * kTile - 1) / (2 * kTile);
  flash_attention_bwd_dq_wgmma_kernel<D><<<n_tiles * bh, kWgThreads,
                                           W::kDqSmem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), kd_map, vd_map, kdo, vdo, a.hkv, bh,
      n_tiles, a.g, a.s_len, a.kv_len, a.qs, a.dos, a.dqs, a.causal, a.window,
      scale_log2, a.scale, a.cap_pre, cap_post);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int launch_d(int d, const Args& a, int b, float* part, int n_split,
             cudaStream_t stream) {
  switch (d) {
#define REPRO_CASE(DIM)                                         \
  case DIM:                                                     \
    return kBf16 ? launch_bf16<DIM>(a, b, part, n_split, stream) \
                 : launch_f32<DIM>(a, b, stream);
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(128)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_bwd

// dtype: 0 = float32, 1 = bfloat16.  lse is the forward's log-sum-exp
// (float32, contiguous (B, Hq, Sq), natural log); delta is float32 scratch
// of the same shape.  bf16 only: the dk/dv kernel splits each key tile's
// (head, position tile) list n_split ways (1 to 8) and, above 1, sums
// the float32 parts from part (n_split x 2 x B Hkv x Skv x D scratch).
// Strides are in elements, (batch, head, position) for
// each of q, k, v, o, dO, dq, dk and dv, in that order; the head dim is
// contiguous.  scale is 1 / sqrt(D) rounded to float32; softcap > 0 caps
// the scaled logits (0: off).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int dtype, int b, int hkv, int g, int s_len, int kv_len,
    int d, const long long* strides, int causal, int window, float scale,
    float softcap, float* part, int n_split, void* stream) {
  using repro::Strides;
  repro_bwd::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = delta;
  a.hkv = hkv;
  a.g = g;
  a.s_len = s_len;
  a.kv_len = kv_len;
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.cap = softcap;
  a.cap_pre = softcap > 0.f ? scale / softcap : 0.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return repro_bwd::launch_d<false>(d, a, b, part, 1, st);
  if (dtype == 1)
    return repro_bwd::launch_d<true>(d, a, b, part, n_split, st);
  return (int)cudaErrorInvalidValue;
}
