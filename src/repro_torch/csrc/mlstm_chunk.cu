// mlstm_chunk: the chunkwise-parallel mLSTM (xLSTM's matrix memory) over a
// whole sequence, with its recurrent state in and out.
//
// Replaces the Pallas TPU kernel _mlstm_kernel / mlstm_chunk in
// src/repro/kernels/mlstm_chunk.py and computes what its oracle
// src/repro/models/ssm.py::mlstm_chunkwise computes, per (batch, head):
// from the state (C (Dh, Dh), n (Dh), m) at the start, every chunk of L
// positions gives
//   y_t = (g_t q_t C + sum_{j<=t} w_tj v_j) / max(|g_t q_t.n + sum_j w_tj|,
//                                               exp(-m_t)),
//   w_tj = (q_t . k_j) exp(b_t - b_j + i_j - m_t),   g_t = exp(b_t + m - m_t),
// with q divided by sqrt(Dh), b the in-chunk prefix sum of log sigmoid(f),
// m_t the running maximum of the log decays (clamped at -1e30), and then
// moves the state to the chunk's end:
//   C' = exp(b_L + m - m') C + sum_j exp(b_L - b_j + i_j - m') k_j v_j^T,
// likewise n', with m' = max(b_L + m, max_j (b_L - b_j + i_j)).  All
// arithmetic is float32; y is written in the inputs' type.  The TPU kernel
// keeps the state in scratch and drops it; this one writes it out, so the
// prefill of a serving cache runs here.  Any S >= 1: the last chunk's
// ragged edge is masked out of the row maxima, m', C' and n'.
//
// Layouts: q, k, v (B, H, S, Dh) and y, read and written through their
// (batch, head, position) strides with the head dim contiguous; the gates
// (B, H, S) through all three strides; the state C (B, H, Dh, Dh), n
// (B, H, Dh), m (B, H), float32 and contiguous (null: the zero state).
//
// Bound on this card: operations.  Per (position, head) about
// 4 Dh (Dh + L) operations (q C, the C update, and the L x L block of
// scores and weights) against 4 x 2 Dh bytes read and written: at Dh =
// 1024 over a thousand operations per byte, far above the card's ~295
// bf16 operations per byte.  Only wgmma reaches the bf16 rate, so the
// bfloat16 path is two tensor-core kernels; float32 keeps its FMA kernel.
//
// bfloat16: two launches, the chunkwise split of Tiled Flash Linear
// Attention (Beck et al., 2025), chunks of L = 256 (the JAX model's):
// - mlstm_states_kernel: the state at every chunk's start.  Grid (64-row
//   d-tiles x e-tiles of 64 NE columns, NE = 4 where 256 divides Dh, B x
//   H); one warpgroup keeps its 64 x 64 NE tile of C as float32 wgmma
//   accumulators (128 registers at NE = 4) across all chunks
//   (C's elements depend only on themselves and the gates, so tiles share
//   nothing).  Per chunk: the gate scalars (b by a warp scan, b_L, m',
//   scale_old, kvw_j); the tile stored as bf16 to a scratch state per
//   chunk (B, H, n_chunks, Dh, Dh); then C <- scale_old C + (kvw o K)^T V
//   by wgmma, K^T o kvw built in registers as the A fragment (ldmatrix
//   .trans, scaled, bf16), V the MN-major B operand, both streamed in
//   tiles of 64 keys by cp.async into a two-stage ring of
//   128-byte-swizzled tiles.  The blocks of e-tile 0 carry n (float32,
//   from the unrounded K) and write it per chunk, the one of d-tile 0 also
//   m.  The final float32 (C, n, m) come from the accumulators, not from
//   the bf16 scratch.  What bounds it is each block's chain per tile of
//   64 keys (wait for the tile, gates at a chunk's start, fragments,
//   wgmma, barrier), ~3 us even for a block alone on the card: on the card
//   more stages, fewer registers for more blocks per SM, two warpgroups
//   sharing each V tile (half the L2 traffic), or loading a chunk's gates
//   a chunk early moved it by 5% at most.
// - mlstm_outputs_kernel: y.  Grid (64-row query tiles x e-groups, B x H):
//   S = Q K^T over Dh by wgmma for the chunk's keys up to the tile's end
//   only (causal), q . n_c beside it on the FMA units; W = S o exp(b_t -
//   b_j + i_j - m_t) / sqrt(Dh), n_intra = sum_j W, W packed to bf16 A
//   fragments (no more than 64 registers).  Then per pass of 64 NE
//   columns: Y = Q C_c from the scratch state (C_c MN-major), the rows
//   scaled by g_t / sqrt(Dh), Y += W V, y = Y / max(|g_t q.n_c / sqrt(Dh)
//   + n_intra|, exp(-m_t)).  A block runs up to 4 passes, so S is computed
//   once per 4 passes.  Each d-block of Q with its K or C block, and each
//   V tile, is one job of a two-stage cp.async ring.
// The roundings this adds to the bf16 inputs: kvw o K, C_c and W to bf16
// (about 2^-9 relative each); every sum is float32.  Scratch: 2 Dh^2 bytes
// per chunk and (batch, head), 256 MB at 4 x 4 heads of 2048 x 1024.
//
// float32 (the parity path), a first, simple kernel on the FMA units:
// - The state does not fit in a block: C is 4 MB per (batch, head) at Dh =
//   1024.  It is split by value columns: y[:, e] and C[:, e] need only
//   v[:, e].  A grid of (Dh / 32, B x H) blocks; each block keeps its
//   Dh x 32 slice of C (128 KB at Dh = 1024) and all of n in shared
//   memory, and loops over the chunks of its sequence in order (the TPU
//   grid's sequential chunk axis).  Blocks share nothing.
// - Each block recomputes what contracts over the whole head dim: the L x L
//   scores q k^T, q . n, the gates' prefix sums and maxima, and n and m.
//   That about doubles the arithmetic, needs no reduction across blocks,
//   and every block of a (batch, head) gets bit-identical n and m.
// - Per chunk (L = 64): the gate quantities first (they depend on the
//   gates and m only), then one pass over the head dim in tiles of 64:
//   q and k tiles to shared memory (the next tile's loads wait in
//   registers meanwhile, so their latency hides behind this tile's
//   arithmetic); per thread a 4 x 4 register tile of scores and, from the
//   same q registers, a 4 x 2 tile of q C over C's old rows; a row of
//   q . n; then the tile's rows of C (4 x 2 per thread) and n move to the
//   chunk's end.  Then the weights w go to shared memory, y = (g q C +
//   w v) / denom is written, and the next chunk starts.  256 threads, one
//   block per SM at Dh = 1024 (~205 KB of shared memory).  The inner loops
//   are bound by shared-memory traffic more than by the FMA units.
// Built without fast-math: expf, log1pf and the divisions are IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // wgmma, descriptors, cp.async, bf16 packing

namespace repro {

constexpr int kL = 64;             // chunk length
constexpr int kE = 32;             // value columns per block
constexpr int kDt = 64;            // head-dim tile of the contraction pass
constexpr int kTs = kDt + 4;       // row stride of the q/k tiles (floats)
constexpr int kWs = kL + 1;        // row stride of the weight tile
constexpr int kThreads = 256;
constexpr int kLoads = kL * kDt / kThreads;  // q (and k) values per thread
constexpr int kCr = kDt / 16;      // C rows a thread moves per d-tile
constexpr float kNegInf = -1e30f;  // the stabilizer's clamp

// Element strides: (batch, head, position) of q, k, v, i, f and y.
struct Strides {
  long long q[3], k[3], v[3], i[3], f[3], y[3];
};

// Shared floats a block needs at head dim dh.
__host__ __device__ constexpr int smem_floats(int dh) {
  return dh * kE + dh + 2 * kL * kTs + 2 * kL * kE + kL * kWs + 7 * kL;
}

__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, float* __restrict__ y,
                   const float* __restrict__ c0, const float* __restrict__ n0,
                   const float* __restrict__ m0, float* __restrict__ c1,
                   float* __restrict__ n1, float* __restrict__ m1, int h,
                   int s_len, int dh, Strides st, float sqrt_dh) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                 // [dh][kE]: this block's columns of C
  float* ns = Cs + dh * kE;         // [dh]
  float* qs = ns + dh;              // [kL][kTs]: q / sqrt(dh), one d-tile
  float* ks = qs + kL * kTs;        // [kL][kTs]
  float* vs = ks + kL * kTs;        // [kL][kE]: v[:, e0 + e]
  float* vws = vs + kL * kE;        // [kL][kE]: kv_w[j] v[j, e0 + e]
  float* Ws = vws + kL * kE;        // [kL][kWs]: w_tj
  float* logf = Ws + kL * kWs;      // [kL] log sigmoid(f)
  float* bcum = logf + kL;          // [kL] prefix sums b_t
  float* igs = bcum + kL;           // [kL] i_t
  float* mt = igs + kL;             // [kL] m_t
  float* gin = mt + kL;             // [kL] g_t
  float* kvw = gin + kL;            // [kL] exp(b_L - b_j + i_j - m')
  float* nsum = kvw + kL;           // [kL] g_t q_t . n + sum_j w_tj

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kE;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const float* qb = q + bi * st.q[0] + hi * st.q[1];
  const float* kb = k + bi * st.k[0] + hi * st.k[1];
  const float* vb = v + bi * st.v[0] + hi * st.v[1] + e0;
  const float* ib = ig + bi * st.i[0] + hi * st.i[1];
  const float* fb = fg + bi * st.f[0] + hi * st.f[1];
  float* yb = y + bi * st.y[0] + hi * st.y[1] + e0;
  const long long cbase = (long long)bh * dh * dh + e0;

  for (int idx = tid; idx < dh * kE; idx += kThreads) {
    const int d = idx / kE, e = idx % kE;
    Cs[idx] = c0 ? c0[cbase + (long long)d * dh + e] : 0.f;
  }
  for (int d = tid; d < dh; d += kThreads)
    ns[d] = n0 ? n0[(long long)bh * dh + d] : 0.f;
  float m_prev = m0 ? m0[bh] : kNegInf;

  // Thread roles.  Scores: rows ty + 16 r, columns tx + 16 c; y: rows
  // ty + 16 r, columns 2 tx and 2 tx + 1.  C update: d-tile rows cr ..
  // cr + kCr - 1, columns ce and ce + 1.
  const int ty = tid >> 4, tx = tid & 15;
  const int cr = ty * kCr, ce = 2 * tx;

  const int n_chunks = (s_len + kL - 1) / kL;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kL;
    const int len = min(kL, s_len - t0);
    __syncthreads();  // the previous chunk's readers are done

    // --- the chunk's gates and v slice ---------------------------------
    if (tid < kL) {
      float lf = 0.f, iv = 0.f;
      if (tid < len) {
        const float f = fb[(long long)(t0 + tid) * st.f[2]];
        lf = fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
        iv = ib[(long long)(t0 + tid) * st.i[2]];
      }
      logf[tid] = lf;
      igs[tid] = iv;
    }
    for (int idx = tid; idx < kL * kE; idx += kThreads) {
      const int j = idx / kE, e = idx % kE;
      vs[idx] = j < len ? vb[(long long)(t0 + j) * st.v[2] + e] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int j = 0; j < kL; ++j) {
        acc += logf[j];
        bcum[j] = acc;
      }
    }
    __syncthreads();
    const float b_last = bcum[len - 1];
    float mx = -INFINITY;
    for (int j = 0; j < len; ++j) mx = fmaxf(mx, (b_last - bcum[j]) + igs[j]);
    const float m_new = fmaxf(b_last + m_prev, mx);
    const float scale_old = expf((b_last + m_prev) - m_new);
    if (tid < kL) {
      const int t = tid;
      float m_t = 0.f, g = 0.f, w = 0.f;
      if (t < len) {
        float mi = -INFINITY;
        for (int j = 0; j <= t; ++j) mi = fmaxf(mi, (bcum[t] - bcum[j]) + igs[j]);
        const float m_inter = bcum[t] + m_prev;
        m_t = fmaxf(fmaxf(m_inter, mi), kNegInf);
        g = expf(m_inter - m_t);
        w = expf(((b_last - bcum[t]) + igs[t]) - m_new);
      }
      mt[t] = m_t;
      gin[t] = g;
      kvw[t] = w;
    }
    __syncthreads();
    for (int idx = tid; idx < kL * kE; idx += kThreads)
      vws[idx] = kvw[idx / kE] * vs[idx];

    // --- one pass over the head dim --------------------------------------
    float sacc[4][4], yacc[4][2], qacc = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[r][c] = 0.f;
      yacc[r][0] = yacc[r][1] = 0.f;
    }
    // The next d-tile's q and k wait in registers while this one computes.
    float qpre[kLoads], kpre[kLoads];
    auto fetch = [&](int d0) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = tid + u * kThreads, j = idx / kDt, d = idx % kDt;
        const bool live = j < len;
        qpre[u] = live ? qb[(long long)(t0 + j) * st.q[2] + d0 + d] : 0.f;
        kpre[u] = live ? kb[(long long)(t0 + j) * st.k[2] + d0 + d] : 0.f;
      }
    };
    fetch(0);
    for (int d0 = 0; d0 < dh; d0 += kDt) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = tid + u * kThreads, j = idx / kDt, d = idx % kDt;
        qs[j * kTs + d] = qpre[u] / sqrt_dh;
        ks[j * kTs + d] = kpre[u];
      }
      __syncthreads();
      if (d0 + kDt < dh) fetch(d0 + kDt);
      // scores (rows ty + 16 r, columns tx + 16 c) and q C (rows ty + 16 r,
      // columns 2 tx, 2 tx + 1) from the same q registers
#pragma unroll
      for (int d = 0; d < kDt; d += 4) {
        float4 qa[4], ka[4];
        float2 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qa[r] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * r) * kTs + d]);
          ka[r] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * r) * kTs + d]);
          cv[r] = *reinterpret_cast<const float2*>(&Cs[(d0 + d + r) * kE + 2 * tx]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sacc[r][c] = fmaf(qa[r].x, ka[c].x, sacc[r][c]);
            sacc[r][c] = fmaf(qa[r].y, ka[c].y, sacc[r][c]);
            sacc[r][c] = fmaf(qa[r].z, ka[c].z, sacc[r][c]);
            sacc[r][c] = fmaf(qa[r].w, ka[c].w, sacc[r][c]);
          }
          yacc[r][0] = fmaf(qa[r].x, cv[0].x, yacc[r][0]);
          yacc[r][1] = fmaf(qa[r].x, cv[0].y, yacc[r][1]);
          yacc[r][0] = fmaf(qa[r].y, cv[1].x, yacc[r][0]);
          yacc[r][1] = fmaf(qa[r].y, cv[1].y, yacc[r][1]);
          yacc[r][0] = fmaf(qa[r].z, cv[2].x, yacc[r][0]);
          yacc[r][1] = fmaf(qa[r].z, cv[2].y, yacc[r][1]);
          yacc[r][0] = fmaf(qa[r].w, cv[3].x, yacc[r][0]);
          yacc[r][1] = fmaf(qa[r].w, cv[3].y, yacc[r][1]);
        }
      }
      if (tid < kL) {  // q_t . n, 16 bytes a thread, no bank conflicts
#pragma unroll
        for (int d = 0; d < kDt; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[tid * kTs + d]);
          const float4 nv = *reinterpret_cast<const float4*>(&ns[d0 + d]);
          qacc = fmaf(qv.x, nv.x, qacc);
          qacc = fmaf(qv.y, nv.y, qacc);
          qacc = fmaf(qv.z, nv.z, qacc);
          qacc = fmaf(qv.w, nv.w, qacc);
        }
      }
      __syncthreads();  // the old rows of C and n are read
      // C rows cr .. cr + kCr - 1, columns ce, ce + 1 to the chunk's end
      float cacc[kCr][2];
#pragma unroll
      for (int u = 0; u < kCr; ++u) cacc[u][0] = cacc[u][1] = 0.f;
      for (int j = 0; j < kL; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(&vws[j * kE + ce]);
        float kk[kCr];
        if constexpr (kCr == 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(&ks[j * kTs + cr]);
          kk[0] = k4.x; kk[1] = k4.y; kk[2] = k4.z; kk[3] = k4.w;
        } else {
          const float2 k2 = *reinterpret_cast<const float2*>(&ks[j * kTs + cr]);
          kk[0] = k2.x; kk[1] = k2.y;
        }
#pragma unroll
        for (int u = 0; u < kCr; ++u) {
          cacc[u][0] = fmaf(kk[u], w.x, cacc[u][0]);
          cacc[u][1] = fmaf(kk[u], w.y, cacc[u][1]);
        }
      }
#pragma unroll
      for (int u = 0; u < kCr; ++u) {
        float* c = &Cs[(d0 + cr + u) * kE + ce];
        c[0] = scale_old * c[0] + cacc[u][0];
        c[1] = scale_old * c[1] + cacc[u][1];
      }
      if (tid < kDt) {
        float nacc = 0.f;
        for (int j = 0; j < kL; ++j) nacc = fmaf(kvw[j], ks[j * kTs + tid], nacc);
        ns[d0 + tid] = scale_old * ns[d0 + tid] + nacc;
      }
      __syncthreads();  // the tiles are free for the next d-tile
    }

    // --- weights, then y ---------------------------------------------------
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        float w = 0.f;
        if (j <= t && t < len)
          w = sacc[r][c] * expf(((bcum[t] - bcum[j]) + igs[j]) - mt[t]);
        Ws[t * kWs + j] = w;
      }
    }
    __syncthreads();
    float yi[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) yi[r][0] = yi[r][1] = 0.f;
    for (int j = 0; j < kL; ++j) {
      const float2 vv = *reinterpret_cast<const float2*>(&vs[j * kE + 2 * tx]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = Ws[(ty + 16 * r) * kWs + j];
        yi[r][0] = fmaf(w, vv.x, yi[r][0]);
        yi[r][1] = fmaf(w, vv.y, yi[r][1]);
      }
    }
    if (tid < kL) {
      float acc = 0.f;
      for (int j = 0; j < kL; ++j) acc += Ws[tid * kWs + j];
      nsum[tid] = qacc * gin[tid] + acc;  // n_inter + n_intra
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
      if (t < len) {
        const float g = gin[t];
        const float den = fmaxf(fabsf(nsum[t]), expf(-mt[t]));
        float* out = yb + (long long)(t0 + t) * st.y[2] + 2 * tx;
        out[0] = (yacc[r][0] * g + yi[r][0]) / den;
        out[1] = (yacc[r][1] * g + yi[r][1]) / den;
      }
    }
    m_prev = m_new;
  }

  __syncthreads();
  for (int idx = tid; idx < dh * kE; idx += kThreads) {
    const int d = idx / kE, e = idx % kE;
    c1[cbase + (long long)d * dh + e] = Cs[idx];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < dh; d += kThreads) n1[(long long)bh * dh + d] = ns[d];
    if (tid == 0) m1[bh] = m_prev;
  }
}

int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* y, const float* c0, const float* n0,
           const float* m0, float* c1, float* n1, float* m1, int b, int h,
           int s, int dh, const Strides& st, float sqrt_dh,
           cudaStream_t stream) {
  const int bytes = smem_floats(dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunk_kernel<<<dim3(dh / kE, b * h), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<float*>(y), c0, n0, m0, c1,
      n1, m1, h, s, dh, st, sqrt_dh);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16 inputs: the states kernel and the outputs kernel (tensor cores).
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 256;            // positions per chunk
constexpr int kT = 64;                 // keys per tile, rows and dims per block
constexpr int kTilesPerChunk = kChunk / kT;
constexpr int kWgThreads = 128;        // one warpgroup
constexpr int kTileBytes = kT * 128;   // one [64][64] bf16 tile
constexpr int kStatesStages = 2;       // the states kernel's ring

// Element strides: (batch, head, position).
struct Rows {
  long long b, h, s;
};

__device__ __forceinline__ float warp_scan_sum(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  return x;
}
__device__ __forceinline__ float warp_scan_max(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x = fmaxf(x, y);
  }
  return x;
}

// The gates of the chunk at t0 (len live positions), for the positions
// 2 tid and 2 tid + 1 of the chunk that thread tid holds: b, the in-chunk
// prefix sums of log sigmoid(f) (a warp scan, then the warps' totals), and
// i; past len log sigmoid(f) and i count as 0.  red: 4 floats.
__device__ __forceinline__ void chunk_gates(const bf16* ib, const bf16* fb,
                                            long long is, long long fs,
                                            int t0, int len, float* red,
                                            float (&b)[2], float (&iv)[2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float lf[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int p = 2 * tid + u;
    lf[u] = iv[u] = 0.f;
    if (p < len) {
      const float f = __bfloat162float(fb[(long long)(t0 + p) * fs]);
      lf[u] = fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
      iv[u] = __bfloat162float(ib[(long long)(t0 + p) * is]);
    }
  }
  const float pair = lf[0] + lf[1];
  const float incl = warp_scan_sum(pair, lane);
  float excl = __shfl_up_sync(~0u, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += red[w];
  __syncthreads();  // red is free again
  b[0] = (off + excl) + lf[0];
  b[1] = (off + excl) + pair;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  return x;
}

// Inclusive prefix maxima over the chunk of a[u] at positions 2 tid + u.
__device__ __forceinline__ void block_prefix_max(const float (&a)[2],
                                                 float* red, float (&pm)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float pair = fmaxf(a[0], a[1]);
  const float incl = warp_scan_max(pair, lane);
  float excl = __shfl_up_sync(~0u, incl, 1);
  if (lane == 0) excl = -INFINITY;
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float off = -INFINITY;
  for (int w = 0; w < warp; ++w) off = fmaxf(off, red[w]);
  __syncthreads();
  const float before = fmaxf(off, excl);
  pm[0] = fmaxf(before, a[0]);
  pm[1] = fmaxf(before, pair);
}

// The state at every chunk's start.  Block (dt + n_dt et, bh) owns rows
// d0 = 64 dt .. d0 + 63 and columns e0 = 64 NE et .. of C for (batch,
// head) bh; threads: warp w holds rows 16 w + grp and + 8 of the tile.
template <int NE>
__global__ void __launch_bounds__(kWgThreads)
mlstm_states_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ ig, const bf16* __restrict__ fg,
                    const float* __restrict__ c0, const float* __restrict__ n0,
                    const float* __restrict__ m0, bf16* __restrict__ cs,
                    float* __restrict__ ns, float* __restrict__ ms,
                    float* __restrict__ c1, float* __restrict__ n1,
                    float* __restrict__ m1, int h, int s_len, int dh,
                    Rows ks, Rows vs, Rows is, Rows fs) {
  constexpr int kStage = kTileBytes * (1 + NE);  // K tile, NE V blocks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* kvw_s = reinterpret_cast<float*>(smem + kStatesStages * kStage);
  float* b_s = kvw_s + kChunk;                                 // [kChunk]
  float* red = b_s + kChunk;                                   // [4]
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ra = warp * 16 + grp, rb = ra + 8;
  const int n_dt = dh / kT;
  const int dt = blockIdx.x % n_dt, et = blockIdx.x / n_dt;
  const int d0 = dt * kT, e0 = et * kT * NE;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int n_tiles = (s_len + kT - 1) / kT;
  const bool n_owner = et == 0 && tid < kT;  // carries n[d0 + tid]
  const bf16* kb = k + bi * ks.b + hi * ks.h + d0;
  const bf16* vb = v + bi * vs.b + hi * vs.h + e0;
  const bf16* ib = ig + bi * is.b + hi * is.h;
  const bf16* fb = fg + bi * fs.b + hi * fs.h;

  // Key tile t (K[:, d0..], then V[:, e0..] in NE column blocks) into
  // stage t % kStatesStages; one commit group per tile, empty past the
  // last.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const uint32_t st = base + (t % kStatesStages) * kStage;
      for (int idx = tid; idx < kT * 8 * (1 + NE); idx += kWgThreads) {
        const int blk = idx / (kT * 8), r = (idx >> 3) % kT, c = idx & 7;
        const long long key = (long long)t * kT + r;
        const bool live = key < s_len;
        const bf16* src = blk == 0 ? kb + key * ks.s + c * 8
                                   : vb + key * vs.s + (blk - 1) * kT + c * 8;
        cp_async16(st + blk * kTileBytes + sw128(r, c), live ? src : kb, live);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStatesStages; ++t) issue(t);

  float acc[NE][32];
#pragma unroll
  for (int cb = 0; cb < NE; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 xa = make_float2(0.f, 0.f), xb = xa;
      if (c0) {
        const float* row = c0 + ((long long)bh * dh + d0) * dh + e0 +
                           cb * kT + 8 * j + 2 * tig;
        xa = *reinterpret_cast<const float2*>(row + (long long)ra * dh);
        xb = *reinterpret_cast<const float2*>(row + (long long)rb * dh);
      }
      acc[cb][4 * j] = xa.x;
      acc[cb][4 * j + 1] = xa.y;
      acc[cb][4 * j + 2] = xb.x;
      acc[cb][4 * j + 3] = xb.y;
    }
  float n_d = (n_owner && n0) ? n0[(long long)bh * dh + d0 + tid] : 0.f;
  float m_prev = m0 ? m0[bh] : kNegInf;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, len = min(kChunk, s_len - t0);
    // --- the chunk's gate scalars --------------------------------------
    float b[2], iv[2];
    chunk_gates(ib, fb, is.s, fs.s, t0, len, red, b, iv);
    b_s[2 * tid] = b[0];
    b_s[2 * tid + 1] = b[1];
    __syncthreads();
    const float b_last = b_s[len - 1];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (2 * tid + u < len) mx = fmaxf(mx, (b_last - b[u]) + iv[u]);
    mx = block_max(mx, red);
    const float m_new = fmaxf(b_last + m_prev, mx);
    const float scale_old = expf((b_last + m_prev) - m_new);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = 2 * tid + u;
      kvw_s[p] = p < len ? expf(((b_last - b[u]) + iv[u]) - m_new) : 0.f;
    }

    // --- the state at the chunk's start, for the outputs kernel ----------
    bf16* cdst = cs + (((long long)bh * n_chunks + c) * dh + d0) * dh + e0;
#pragma unroll
    for (int cb = 0; cb < NE; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * kT + 8 * j + 2 * tig;
        *reinterpret_cast<__nv_bfloat162*>(cdst + (long long)ra * dh + col) =
            __floats2bfloat162_rn(acc[cb][4 * j], acc[cb][4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(cdst + (long long)rb * dh + col) =
            __floats2bfloat162_rn(acc[cb][4 * j + 2], acc[cb][4 * j + 3]);
      }
    if (n_owner) ns[((long long)bh * n_chunks + c) * dh + d0 + tid] = n_d;
    if (et == 0 && dt == 0 && tid == 0)
      ms[(long long)bh * n_chunks + c] = m_prev;
#pragma unroll
    for (int cb = 0; cb < NE; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= scale_old;
    n_d *= scale_old;
    __syncthreads();  // kvw_s is written

    // --- C += (kvw o K)^T V over the chunk's key tiles ------------------
    const int t_end = min(n_tiles, (c + 1) * kTilesPerChunk);
    for (int t = c * kTilesPerChunk; t < t_end; ++t) {
      cp_async_wait<kStatesStages - 1>();
      fence_proxy_async();
      __syncthreads();
      const int stage = t % kStatesStages;
      const uint8_t* kt = smem + stage * kStage;
      const uint32_t vt = base + stage * kStage + kTileBytes;
      const float* kv = kvw_s + (t % kTilesPerChunk) * kT;
      // A = (kvw o K)^T: rows d (ra, rb), columns the tile's keys.  K is
      // [key][d] in shared memory, so ldmatrix.trans hands each thread
      // its (d, key pair) elements; then each pair is scaled by its kvw.
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int mat = lane >> 3;
        ldmatrix_x4_trans(a[kk], base + stage * kStage +
                                     sw128(16 * kk + (mat >> 1) * 8 + (lane & 7),
                                           2 * warp + (mat & 1)));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 16 * kk + 2 * tig + (r >> 1) * 8;
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a[kk][r]));
          a[kk][r] = pack_bf16(x.x * kv[j], x.y * kv[j + 1]);
        }
      }
      if (n_owner) {  // four partial sums: no chain of 64 dependent FMAs
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int j = 0; j < kT; ++j)
          part[j & 3] = fmaf(kv[j],
                             __bfloat162float(*reinterpret_cast<const bf16*>(
                                 kt + sw128(j, tid >> 3) + ((tid & 7) << 1))),
                             part[j & 3]);
        n_d += (part[0] + part[1]) + (part[2] + part[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cb = 0; cb < NE; ++cb)
          wgmma_rs_n64(acc[cb], a[kk],
                       mnmajor_sw128(vt + cb * kTileBytes + kk * 2048));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int cb = 0; cb < NE; ++cb) fence_regs(acc[cb]);
      fence_regs(a);
      __syncthreads();  // the stage is read
      issue(t + kStatesStages);
    }
    m_prev = m_new;
  }

  // --- the final state, float32, from the accumulators ------------------
  float* cdst = c1 + ((long long)bh * dh + d0) * dh + e0;
#pragma unroll
  for (int cb = 0; cb < NE; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb * kT + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(cdst + (long long)ra * dh + col) =
          make_float2(acc[cb][4 * j], acc[cb][4 * j + 1]);
      *reinterpret_cast<float2*>(cdst + (long long)rb * dh + col) =
          make_float2(acc[cb][4 * j + 2], acc[cb][4 * j + 3]);
    }
  if (n_owner) n1[(long long)bh * dh + d0 + tid] = n_d;
  if (et == 0 && dt == 0 && tid == 0) m1[bh] = m_prev;
  cp_async_wait<0>();
}

// y.  Block (rt + n_rt eg, bh) owns query rows p0 = 64 rt .. p0 + 63 of
// (batch, head) bh and `passes` passes of 64 NE columns from e-group eg;
// warp w holds rows 16 w + grp and + 8.
template <int NE>
__global__ void __launch_bounds__(kWgThreads)
mlstm_outputs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ ig,
                     const bf16* __restrict__ fg, const bf16* __restrict__ cs,
                     const float* __restrict__ ns,
                     const float* __restrict__ ms, bf16* __restrict__ y,
                     int h, int s_len, int dh, int passes, Rows qs, Rows ks,
                     Rows vs, Rows is, Rows fs, Rows ys, float inv_sqrt) {
  constexpr int kStage = kTileBytes * (1 + kTilesPerChunk);  // Q + 4 K tiles
  constexpr int kCols = kT * NE;                             // per pass
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* b_s = reinterpret_cast<float*>(smem + 2 * kStage);  // [kChunk]
  float* i_s = b_s + kChunk;                                 // [kChunk]
  float* mt_s = i_s + kChunk;                                // [kChunk]
  float* g_s = mt_s + kChunk;                                // [kChunk]
  float* qn_s = g_s + kChunk;                                // [kT]
  float* red = qn_s + kT;                                    // [4]
  float* n_s = red + 4;                                      // [dh]
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ra = warp * 16 + grp, rb = ra + 8;
  const int n_rt = (s_len + kT - 1) / kT;
  const int rt = blockIdx.x % n_rt, eg = blockIdx.x / n_rt;
  const int p0 = rt * kT, c = p0 / kChunk, t0 = c * kChunk, r0 = p0 - t0;
  const int nkb = r0 / kT + 1;        // live key tiles of the chunk
  const int len = min(kChunk, s_len - t0);
  const int n_chunks = (s_len + kChunk - 1) / kChunk, nd = dh / kT;
  const int e_first = eg * passes * kCols;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const bf16* qb = q + bi * qs.b + hi * qs.h;
  const bf16* kb = k + bi * ks.b + hi * ks.h;
  const bf16* vb = v + bi * vs.b + hi * vs.h;
  const bf16* ib = ig + bi * is.b + hi * is.h;
  const bf16* fb = fg + bi * fs.b + hi * fs.h;
  bf16* yb = y + bi * ys.b + hi * ys.h;
  const bf16* cc_ = cs + ((long long)bh * n_chunks + c) * dh * dh;
  const float* nc = ns + ((long long)bh * n_chunks + c) * dh;
  const float m_c = ms[(long long)bh * n_chunks + c];

  // The jobs, in order: nd of (Q d-block, the chunk's K d-blocks); then per
  // pass nd of (Q d-block, C_c rows of the d-block) and nkb V tiles.  Job j
  // goes to stage j & 1, one commit group each (empty past the last).
  const int per_pass = nd + nkb, n_jobs = nd + passes * per_pass;
  auto load_q = [&](uint32_t st, int col) {
    for (int idx = tid; idx < kT * 8; idx += kWgThreads) {
      const int r = idx >> 3, cc = idx & 7;
      const long long pos = p0 + r;
      const bool live = pos < s_len;
      cp_async16(st + sw128(r, cc), live ? qb + pos * qs.s + col + cc * 8 : qb,
                 live);
    }
  };
  auto issue = [&](int j) {
    if (j < n_jobs) {
      const uint32_t st = base + (j & 1) * kStage;
      const int pj = j - nd, pass = pj / per_pass, step = pj % per_pass;
      const int e = e_first + pass * kCols;
      if (j < nd) {
        const int col = j * kT;
        load_q(st, col);
        for (int idx = tid; idx < nkb * kT * 8; idx += kWgThreads) {
          const int r = idx >> 3, cc = idx & 7;
          const bool live = r < len;
          const bf16* src = kb + (long long)(t0 + r) * ks.s + col + cc * 8;
          cp_async16(st + (1 + r / kT) * kTileBytes + sw128(r % kT, cc),
                     live ? src : kb, live);
        }
      } else if (step < nd) {
        const int col = step * kT;
        load_q(st, col);
        for (int idx = tid; idx < NE * kT * 8; idx += kWgThreads) {
          const int blk = idx / (kT * 8), r = (idx >> 3) % kT, cc = idx & 7;
          const bf16* src =
              cc_ + (long long)(col + r) * dh + e + blk * kT + cc * 8;
          cp_async16(st + (1 + blk) * kTileBytes + sw128(r, cc), src, true);
        }
      } else {
        const int key0 = (step - nd) * kT;
        for (int idx = tid; idx < NE * kT * 8; idx += kWgThreads) {
          const int blk = idx / (kT * 8), r = (idx >> 3) % kT, cc = idx & 7;
          const bool live = key0 + r < len;
          const bf16* src = vb + (long long)(t0 + key0 + r) * vs.s + e +
                            blk * kT + cc * 8;
          cp_async16(st + blk * kTileBytes + sw128(r, cc), live ? src : vb,
                     live);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // --- n_c and the chunk's gates: b, i, m_t and g_t per position ---------
  for (int d = tid; d < dh; d += kWgThreads) n_s[d] = nc[d];
  {
    float b[2], iv[2], a[2], pm[2];
    chunk_gates(ib, fb, is.s, fs.s, t0, len, red, b, iv);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      a[u] = 2 * tid + u < len ? iv[u] - b[u] : -INFINITY;
    block_prefix_max(a, red, pm);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = 2 * tid + u;
      const float m_t = fmaxf(fmaxf(b[u] + m_c, b[u] + pm[u]), kNegInf);
      b_s[p] = b[u];
      i_s[p] = iv[u];
      mt_s[p] = m_t;
      g_s[p] = expf((b[u] + m_c) - m_t);
    }
  }

  // --- S = Q K^T over the head dim; q . n_c beside it -------------------
  float sacc[kTilesPerChunk][32];
#pragma unroll
  for (int kb4 = 0; kb4 < kTilesPerChunk; ++kb4)
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[kb4][i] = 0.f;
  float qn = 0.f;
  int job = 0;
  for (int dblk = 0; dblk < nd; ++dblk, ++job) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t st = base + (job & 1) * kStage;
    {  // row tid / 2, columns 32 (tid & 1) .. + 31 of this d-block
      const uint8_t* qt = smem + (job & 1) * kStage;
      const int row = tid >> 1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int chunk = (tid & 1) * 4 + u;
        const uint4 x = *reinterpret_cast<const uint4*>(qt + sw128(row, chunk));
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const float* nv = n_s + dblk * kT + chunk * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(xp[e]);
          qn = fmaf(f.x, nv[2 * e], qn);
          qn = fmaf(f.y, nv[2 * e + 1], qn);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int kb4 = 0; kb4 < kTilesPerChunk; ++kb4)
        if (kb4 < nkb)
          wgmma_ss_n64<0>(sacc[kb4], kmajor_sw128(st + kk * 32),
                          kmajor_sw128(st + (1 + kb4) * kTileBytes + kk * 32),
                          1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int kb4 = 0; kb4 < kTilesPerChunk; ++kb4) fence_regs(sacc[kb4]);
    __syncthreads();  // the stage is read
    issue(job + 2);
  }

  // --- W = S o decay / sqrt(Dh), causal; n_intra; W as bf16 A fragments --
  qn += __shfl_xor_sync(~0u, qn, 1);
  if ((tid & 1) == 0) qn_s[tid >> 1] = qn;
  const int ta = r0 + ra, tb = r0 + rb;  // chunk positions of my two rows
  const float bta = b_s[ta], btb = b_s[tb];
  const float mta = mt_s[ta], mtb = mt_s[tb];
  float ni_a = 0.f, ni_b = 0.f;
  uint32_t wa[4 * kTilesPerChunk][4];
#pragma unroll
  for (int kb4 = 0; kb4 < kTilesPerChunk; ++kb4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) wa[4 * kb4 + kk][r] = 0u;
    if (kb4 < nkb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = kb4 * kT + 8 * (i >> 2) + 2 * tig + (i & 1);
        const bool row_b = i & 2;
        float w = 0.f;
        if (j <= (row_b ? tb : ta))
          w = sacc[kb4][i] *
              expf(((row_b ? btb : bta) - b_s[j]) + i_s[j] -
                   (row_b ? mtb : mta)) * inv_sqrt;
        sacc[kb4][i] = w;
        if (row_b) ni_b += w; else ni_a += w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wa[4 * kb4 + kk][0] = pack_bf16(sacc[kb4][8 * kk], sacc[kb4][8 * kk + 1]);
        wa[4 * kb4 + kk][1] = pack_bf16(sacc[kb4][8 * kk + 2], sacc[kb4][8 * kk + 3]);
        wa[4 * kb4 + kk][2] = pack_bf16(sacc[kb4][8 * kk + 4], sacc[kb4][8 * kk + 5]);
        wa[4 * kb4 + kk][3] = pack_bf16(sacc[kb4][8 * kk + 6], sacc[kb4][8 * kk + 7]);
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {  // the 4 threads of a row
    ni_a += __shfl_xor_sync(~0u, ni_a, o);
    ni_b += __shfl_xor_sync(~0u, ni_b, o);
  }
  __syncthreads();  // qn_s is written
  const float coef_a = g_s[ta] * inv_sqrt, coef_b = g_s[tb] * inv_sqrt;
  const float den_a = fmaxf(fabsf(coef_a * qn_s[ra] + ni_a), expf(-mta));
  const float den_b = fmaxf(fabsf(coef_b * qn_s[rb] + ni_b), expf(-mtb));

  // --- per pass: Y = Q C_c, Y *= g / sqrt(Dh), Y += W V, y = Y / den ------
  for (int pass = 0; pass < passes; ++pass) {
    const int e = e_first + pass * kCols;
    float yacc[NE][32];
#pragma unroll
    for (int cb = 0; cb < NE; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[cb][i] = 0.f;
    for (int dblk = 0; dblk < nd; ++dblk, ++job) {
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
      const uint32_t st = base + (job & 1) * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cb = 0; cb < NE; ++cb)
          wgmma_ss_n64<1>(yacc[cb], kmajor_sw128(st + kk * 32),
                          mnmajor_sw128(st + (1 + cb) * kTileBytes + kk * 2048),
                          1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int cb = 0; cb < NE; ++cb) fence_regs(yacc[cb]);
      __syncthreads();
      issue(job + 2);
    }
#pragma unroll
    for (int cb = 0; cb < NE; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[cb][i] *= (i & 2) ? coef_b : coef_a;
#pragma unroll
    for (int kb4 = 0; kb4 < kTilesPerChunk; ++kb4) {
      if (kb4 < nkb) {
        cp_async_wait<1>();
        fence_proxy_async();
        __syncthreads();
        const uint32_t st = base + (job & 1) * kStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int cb = 0; cb < NE; ++cb)
            wgmma_rs_n64(yacc[cb], wa[4 * kb4 + kk],
                         mnmajor_sw128(st + cb * kTileBytes + kk * 2048));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int cb = 0; cb < NE; ++cb) fence_regs(yacc[cb]);
        fence_regs(wa);
        __syncthreads();
        issue(job + 2);
        ++job;
      }
    }
    // yacc[cb][4 j + x]: column e + 64 cb + 8 j + 2 tig + (x & 1), row a
    // for x < 2, row b otherwise.
#pragma unroll
    for (int cb = 0; cb < NE; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = e + cb * kT + 8 * j + 2 * tig;
        if (p0 + ra < s_len)
          *reinterpret_cast<__nv_bfloat162*>(
              yb + (long long)(p0 + ra) * ys.s + col) =
              __floats2bfloat162_rn(yacc[cb][4 * j] / den_a,
                                    yacc[cb][4 * j + 1] / den_a);
        if (p0 + rb < s_len)
          *reinterpret_cast<__nv_bfloat162*>(
              yb + (long long)(p0 + rb) * ys.s + col) =
              __floats2bfloat162_rn(yacc[cb][4 * j + 2] / den_b,
                                    yacc[cb][4 * j + 3] / den_b);
      }
  }
  cp_async_wait<0>();
}

template <int NE>
size_t states_smem() {
  return 1024 + kStatesStages * size_t(kTileBytes) * (1 + NE) +
         sizeof(float) * (2 * kChunk + 4);
}
inline size_t outputs_smem(int dh) {
  return 1024 + 2 * size_t(kTileBytes) * (1 + kTilesPerChunk) +
         sizeof(float) * (4 * kChunk + kT + 4 + dh);
}

template <int NE>
int launch_states(const void* k, const void* v, const void* ig,
                  const void* fg, const float* c0, const float* n0,
                  const float* m0, void* cs, float* ns, float* ms, float* c1,
                  float* n1, float* m1, int b, int h, int s, int dh, Rows ks,
                  Rows vs, Rows is, Rows fs, cudaStream_t stream) {
  const size_t smem = states_smem<NE>();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_states_kernel<NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dh / kT) * (dh / (kT * NE)), b * h);
  mlstm_states_kernel<NE><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(ig), static_cast<const bf16*>(fg), c0, n0, m0,
      static_cast<bf16*>(cs), ns, ms, c1, n1, m1, h, s, dh, ks, vs, is, fs);
  return (int)cudaGetLastError();
}

template <int NE>
int launch_outputs(const void* q, const void* k, const void* v,
                   const void* ig, const void* fg, const void* cs,
                   const float* ns, const float* ms, void* y, int b, int h,
                   int s, int dh, Rows qs, Rows ks, Rows vs, Rows is, Rows fs,
                   Rows ys, float inv_sqrt, cudaStream_t stream) {
  // Up to 4 passes of 64 NE columns per block: S once for all of them.
  const int n_et = dh / (kT * NE);
  const int passes = n_et % 4 == 0 ? 4 : n_et % 2 == 0 ? 2 : 1;
  const size_t smem = outputs_smem(dh);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_outputs_kernel<NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((s + kT - 1) / kT) * (n_et / passes), b * h);
  mlstm_outputs_kernel<NE><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(ig),
      static_cast<const bf16*>(fg), static_cast<const bf16*>(cs), ns, ms,
      static_cast<bf16*>(y), h, s, dh, passes, qs, ks, vs, is, fs, ys,
      inv_sqrt);
  return (int)cudaGetLastError();
}

inline bool bad_shape(int b, int h, int s, int dh) {
  return dh % kT || dh < kT || dh > 1024 || s < 1 || b < 1 || h < 1;
}

}  // namespace tc

}  // namespace repro

// float32 q, k, v, both gates and y.  dh is a multiple of kDt (64) up to
// 1024; s >= 1.  Strides in elements, (batch, head,
// position) of q, k, v, i, f and y; the head dim is contiguous.  c0, n0,
// m0 may all be null (the zero state, m = -1e30); c1, n1 and m1 must not
// alias them (every block reads n0 and m0 at its start; one writes n1, m1).
extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, void* y, const void* c0, const void* n0, const void* m0,
    void* c1, void* n1, void* m1, int b, int h, int s, int dh,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long i_sb, long long i_sh, long long i_ss,
    long long f_sb, long long f_sh, long long f_ss, long long y_sb,
    long long y_sh, long long y_ss, float sqrt_dh, void* stream) {
  if (dh % repro::kDt || dh < repro::kDt || dh > 1024 || s < 1 || b < 1 ||
      h < 1)
    return (int)cudaErrorInvalidValue;
  const repro::Strides st = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                             {v_sb, v_sh, v_ss}, {i_sb, i_sh, i_ss},
                             {f_sb, f_sh, f_ss}, {y_sb, y_sh, y_ss}};
  const float* cs = static_cast<const float*>(c0);
  const float* ns = static_cast<const float*>(n0);
  const float* ms = static_cast<const float*>(m0);
  float* co = static_cast<float*>(c1);
  float* no = static_cast<float*>(n1);
  float* mo = static_cast<float*>(m1);
  return repro::launch(q, k, v, ig, fg, y, cs, ns, ms, co, no, mo, b, h, s,
                       dh, st, sqrt_dh, static_cast<cudaStream_t>(stream));
}

// bfloat16 k, v and gates, strides in elements ((batch, head, position);
// the head dim contiguous, rows 16-byte aligned).  c0, n0, m0: the float32
// state in, or all null (zero); cs (B, H, n_chunks, dh, dh) bf16, ns
// (B, H, n_chunks, dh) and ms (B, H, n_chunks) float32: the state at every
// chunk's start (chunks of 256); c1, n1, m1 the final float32 state, not
// aliasing c0, n0, m0.
extern "C" int mlstm_states_launch(
    const void* k, const void* v, const void* ig, const void* fg,
    const void* c0, const void* n0, const void* m0, void* cs, void* ns,
    void* ms, void* c1, void* n1, void* m1, int b, int h, int s, int dh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long i_sb, long long i_sh,
    long long i_ss, long long f_sb, long long f_sh, long long f_ss,
    void* stream) {
  using repro::tc::Rows;
  if (repro::tc::bad_shape(b, h, s, dh)) return (int)cudaErrorInvalidValue;
  const Rows ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss}, is{i_sb, i_sh, i_ss},
      fs{f_sb, f_sh, f_ss};
  // e-tiles as wide as divide Dh, up to 4 blocks of 64 columns
  using namespace repro::tc;
  const int blocks = dh / kT;
  auto launch = blocks % 4 == 0   ? launch_states<4>
                : blocks % 2 == 0 ? launch_states<2>
                                  : launch_states<1>;
  return launch(k, v, ig, fg, static_cast<const float*>(c0),
                static_cast<const float*>(n0), static_cast<const float*>(m0),
                cs, static_cast<float*>(ns), static_cast<float*>(ms),
                static_cast<float*>(c1), static_cast<float*>(n1),
                static_cast<float*>(m1), b, h, s, dh, ks, vs, is, fs,
                static_cast<cudaStream_t>(stream));
}

// bfloat16 q, k, v, gates and y (strides as above), and the chunk states
// mlstm_states_launch wrote; inv_sqrt = 1 / sqrt(dh) in float32.
extern "C" int mlstm_outputs_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* cs, const void* ns, const void* ms, void* y,
    int b, int h, int s, int dh, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long i_sb,
    long long i_sh, long long i_ss, long long f_sb, long long f_sh,
    long long f_ss, long long y_sb, long long y_sh, long long y_ss,
    float inv_sqrt, void* stream) {
  using repro::tc::Rows;
  if (repro::tc::bad_shape(b, h, s, dh)) return (int)cudaErrorInvalidValue;
  const Rows qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      is{i_sb, i_sh, i_ss}, fs{f_sb, f_sh, f_ss}, ys{y_sb, y_sh, y_ss};
  auto launch = (dh / repro::tc::kT) % 2 ? repro::tc::launch_outputs<1>
                                         : repro::tc::launch_outputs<2>;
  return launch(q, k, v, ig, fg, cs, static_cast<const float*>(ns),
                static_cast<const float*>(ms), y, b, h, s, dh, qs, ks, vs, is,
                fs, ys, inv_sqrt, static_cast<cudaStream_t>(stream));
}
