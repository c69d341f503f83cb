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
// 4 Dh (Dh + L) float32 operations (q C, the C update, and the L x L block
// of scores and weights) against 4 x 2 Dh bytes read and written: at Dh =
// 1024 over a thousand operations per byte.
//
// Design (a first, simple kernel: float32 FMA, no tensor cores):
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
//   are bound by shared-memory traffic more than by the FMA units; tensor
//   cores for the bf16 scores, and scores computed once per (batch, head)
//   instead of once per block, are the next steps.
// Built without fast-math: expf, log1pf and the divisions are IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides: (batch, head, position) of q, k, v, i, f and y.
struct Strides {
  long long q[3], k[3], v[3], i[3], f[3], y[3];
};

// Shared floats a block needs at head dim dh.
__host__ __device__ constexpr int smem_floats(int dh) {
  return dh * kE + dh + 2 * kL * kTs + 2 * kL * kE + kL * kWs + 7 * kL;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ ig,
                   const T* __restrict__ fg, T* __restrict__ y,
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
  const T* qb = q + bi * st.q[0] + hi * st.q[1];
  const T* kb = k + bi * st.k[0] + hi * st.k[1];
  const T* vb = v + bi * st.v[0] + hi * st.v[1] + e0;
  const T* ib = ig + bi * st.i[0] + hi * st.i[1];
  const T* fb = fg + bi * st.f[0] + hi * st.f[1];
  T* yb = y + bi * st.y[0] + hi * st.y[1] + e0;
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
        const float f = to_float(fb[(long long)(t0 + tid) * st.f[2]]);
        lf = fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
        iv = to_float(ib[(long long)(t0 + tid) * st.i[2]]);
      }
      logf[tid] = lf;
      igs[tid] = iv;
    }
    for (int idx = tid; idx < kL * kE; idx += kThreads) {
      const int j = idx / kE, e = idx % kE;
      vs[idx] = j < len ? to_float(vb[(long long)(t0 + j) * st.v[2] + e]) : 0.f;
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
    T qpre[kLoads], kpre[kLoads];
    auto fetch = [&](int d0) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = tid + u * kThreads, j = idx / kDt, d = idx % kDt;
        const bool live = j < len;
        qpre[u] = live ? qb[(long long)(t0 + j) * st.q[2] + d0 + d]
                       : from_float<T>(0.f);
        kpre[u] = live ? kb[(long long)(t0 + j) * st.k[2] + d0 + d]
                       : from_float<T>(0.f);
      }
    };
    fetch(0);
    for (int d0 = 0; d0 < dh; d0 += kDt) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = tid + u * kThreads, j = idx / kDt, d = idx % kDt;
        qs[j * kTs + d] = to_float(qpre[u]) / sqrt_dh;
        ks[j * kTs + d] = to_float(kpre[u]);
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
        T* out = yb + (long long)(t0 + t) * st.y[2] + 2 * tx;
        out[0] = from_float<T>((yacc[r][0] * g + yi[r][0]) / den);
        out[1] = from_float<T>((yacc[r][1] * g + yi[r][1]) / den);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* y, const float* c0, const float* n0,
           const float* m0, float* c1, float* n1, float* m1, int b, int h,
           int s, int dh, const Strides& st, float sqrt_dh,
           cudaStream_t stream) {
  const int bytes = smem_floats(dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunk_kernel<T><<<dim3(dh / kE, b * h), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ig),
      static_cast<const T*>(fg), static_cast<T*>(y), c0, n0, m0, c1, n1, m1,
      h, s, dh, st, sqrt_dh);
  return (int)cudaGetLastError();
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, both gates and y).  dh is a
// multiple of kDt (64) up to 1024; s >= 1.  Strides in elements, (batch, head,
// position) of q, k, v, i, f and y; the head dim is contiguous.  c0, n0,
// m0 may all be null (the zero state, m = -1e30); c1, n1 and m1 must not
// alias them (every block reads n0 and m0 at its start; one writes n1, m1).
extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, void* y, const void* c0, const void* n0, const void* m0,
    void* c1, void* n1, void* m1, int dtype, int b, int h, int s, int dh,
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
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch<float>(q, k, v, ig, fg, y, cs, ns, ms, co, no, mo, b,
                                h, s, dh, st, sqrt_dh, str);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(q, k, v, ig, fg, y, cs, ns, ms, co,
                                        no, mo, b, h, s, dh, st, sqrt_dh, str);
  return (int)cudaErrorInvalidValue;
}
