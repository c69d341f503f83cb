// mlstm_chunk_bwd: the backward of the chunkwise mLSTM (mlstm_chunk.cu),
// y's gradient dy -> the gradients of q, k, v and both gates.
//
// The Pallas TPU kernel _mlstm_kernel (src/repro/kernels/mlstm_chunk.py)
// has no backward: the JAX model differentiates its plain chunkwise form
// (src/repro/models/ssm.py::mlstm_chunkwise).  The port's forward runs B7,
// so these kernels are its gradient.
//
// Per chunk of L = 256 positions (q~ = q / sqrt(Dh); C_c, n_c, m_c the
// state at the chunk's start, written by the forward; every stabilizer
// held constant, since y and C exp(m) do not depend on them):
//   b_t the in-chunk sums of log sigmoid(f), m_t the forward's row
//   maximum, g_t = exp(b_t + m_c - m_t), E_tj = exp(b_t - b_j + i_j - m_t)
//   (j <= t), W = (q~ k^T) o E, den_t = exp(ell_t - m_t) from the
//   forward's ell_t = m_t + log(den_t), so = exp(b_L + m_c - m'), kvw_j =
//   exp(b_L - b_j + i_j - m'), m' the next chunk's m;
//   dY_t = dy_t / den_t, dN_t = -sgn_t (dy_t . y_t) / den_t (sgn_t the
//   sign of N_t where |N_t| > exp(-m_t), else 0);
//   dW = dY v^T + dN, G = dW o W, dS = dW o E;
//   dq_t = [g_t (C_c dY_t + dN_t n_c) + sum_j dS_tj k_j] / sqrt(Dh);
//   dk_j = sum_t dS_tj q~_t + kvw_j (dC v_j + dn);
//   dv_j = sum_t W_tj dY_t + kvw_j dC^T k_j;
//   di_j = sum_t G_tj + Q_j, db_t = sum_j G_tj - sum_t' G_t't + R_t - Q_t
//   (+ sum_j Q_j + P at the chunk's last position), with R_t = g_t q~_t .
//   (C_c dY_t + dN_t n_c), Q_j = kvw_j k_j . (dC v_j + dn), P = so
//   (<dC, C_c> + <dn, n_c>); d log f_u = sum_{t >= u} db_t, df = d log f
//   sigmoid(-f);
//   (dC, dn) at the chunk's start = so (dC, dn) at its end + sum_t g_t
//   q~_t (dY_t, dN_t).
// Four launches (FMA units, float32 arithmetic, inputs float32 or bf16):
// - mlstm_bwd_scores_kernel, per (chunk, pair of 64-position tiles t >= j):
//   the gate scalars (every block of a chunk recomputes them, a block
//   scan), dy . y for its query rows, S = q~ k^T and dy v^T over the head
//   dim, then W, dS and G into (B, H, n_chunks, L, L) float32 scratch; the
//   diagonal blocks write the per-position scalars (b, i, m, g, 1 / den,
//   dN, kvw) the other kernels read, block (0, 0) so.
// - mlstm_bwd_states_kernel, the gradient of the state at every chunk's
//   end, chunks in reverse: dC's (d, e) tile needs only q~[:, d] and
//   dY[:, e], so blocks of 64 x 64 tiles share nothing (n rides with the
//   first e-tile); each also writes its tile's share of <dC, C_c>.
// - mlstm_bwd_grads_kernel, per (64-position tile, 64-column slice, role):
//   dq, dk or dv; a dense product over the head dim (dY C_c^T, v dC^T,
//   k dC), then the chunk's L x L part (dS k, dS^T q~, W^T dY); the dq and
//   dk roles also write their slice's share of R and Q.
// - mlstm_bwd_gates_kernel, per chunk: G's row and column sums, R, Q, P,
//   the reverse cumsum, di and df in the gates' type.
//
// Bound on this card: operations, about 8 Dh (Dh + 160) a (position,
// head) at L = 256 (C dY, dC v, dC^T k, the state's q~ dY^T: 2 Dh^2 each;
// S, dy v^T, dS k, dS^T q~, W^T dY over the causal half: 2 Dh L / 2
// each), against ~10 Dh bytes a position in and out.  This first version
// runs it on the FMA units in 64 x 64 register tiles (4 x 4 a thread) fed
// from shared memory; wgmma is later work.  Scratch at 2 x 4 heads of
// 2048 x 1024: dC 256 MB, W, dS, G 48 MB.  No atomics: the same inputs
// give the same bits.
// Built without fast-math: expf, log1pf and the divisions are IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace mbwd {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 256;           // positions per chunk (the forward's)
constexpr int kT = 64;                // position and head-dim tile
constexpr int kTiles = kChunk / kT;   // position tiles per chunk
constexpr int kPairs = kTiles * (kTiles + 1) / 2;
constexpr int kK = 32;                // contraction step
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;     // the stabilizer's clamp
// per-position scalars, (kAux, B, H, S) float32
enum { kB = 0, kI, kM, kG, kInvDen, kDN, kKvw, kAux };

struct Rows {
  long long b, h, s;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Block-wide (256 threads) inclusive prefix sum and maximum in thread
// order, and sums; red: 8 floats.
__device__ __forceinline__ float block_scan_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += red[w];
  __syncthreads();
  return off + x;
}
__device__ __forceinline__ float block_scan_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x = fmaxf(x, y);
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  float off = -INFINITY;
  for (int w = 0; w < warp; ++w) off = fmaxf(off, red[w]);
  __syncthreads();
  return fmaxf(off, x);
}
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Position tile pair p of a chunk, t-tile ti >= j-tile tj.
__device__ __forceinline__ void tile_pair(int p, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  tj = p - ti * (ti + 1) / 2;
}

// ---------------------------------------------------------------------------
// Scores: grid (n_chunks * kPairs, B * H).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ ig,
                        const T* __restrict__ fg, const T* __restrict__ y,
                        const T* __restrict__ dy, const float* __restrict__ ms,
                        const float* __restrict__ m_last,
                        const float* __restrict__ stats,
                        float* __restrict__ aux, float* __restrict__ so,
                        float* __restrict__ wm, float* __restrict__ dsm,
                        float* __restrict__ gm, int h, int s_len, int dh,
                        Rows qs, Rows ks, Rows vs, Rows is, Rows fs, Rows ys,
                        Rows dys, float inv_sqrt) {
  __shared__ float b_s[kChunk], i_s[kChunk], m_s[kChunk], red[8];
  __shared__ float inv_den_s[kT], dn_s[kT];
  __shared__ float qt[kT][kK + 1], kt[kT][kK + 1], dyt[kT][kK + 1],
      vt[kT][kK + 1];

  const int tid = threadIdx.x;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int c = blockIdx.x / kPairs, pair = blockIdx.x % kPairs;
  int ti, tj;
  tile_pair(pair, ti, tj);
  const int t0 = c * kChunk, len = min(kChunk, s_len - t0);
  if (ti * kT >= len) return;  // the whole block, before any barrier
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const long long S = s_len;
  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;
  const T* yb = y + bi * ys.b + hi * ys.h;
  const T* dyb = dy + bi * dys.b + hi * dys.h;
  const T* ib = ig + bi * is.b + hi * is.h;
  const T* fb = fg + bi * fs.b + hi * fs.h;
  const float m_c = ms[(long long)bh * n_chunks + c];
  const float m_next = c + 1 < n_chunks
                           ? ms[(long long)bh * n_chunks + c + 1]
                           : m_last[bh];

  // --- the chunk's gate scalars, thread p = position t0 + p -------------
  {
    const int p = tid;
    float lf = 0.f, iv = 0.f;
    if (p < len) {
      const float f = ld(fb + (long long)(t0 + p) * fs.s);
      lf = fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
      iv = ld(ib + (long long)(t0 + p) * is.s);
    }
    const float b = block_scan_sum(lf, red);
    const float pm = block_scan_max(p < len ? iv - b : -INFINITY, red);
    const float m_t = fmaxf(fmaxf(b + m_c, b + pm), kNegInf);
    b_s[p] = b;
    i_s[p] = iv;
    m_s[p] = m_t;
    __syncthreads();
    const float b_last = b_s[len - 1];
    if (ti == tj && p / kT == ti && p < len) {
      float* a = aux + (long long)bh * S + t0 + p;
      const long long f_ = (long long)gridDim.y * S;  // one field
      a[kB * f_] = b;
      a[kI * f_] = iv;
      a[kM * f_] = m_t;
      a[kG * f_] = expf((b + m_c) - m_t);
      a[kKvw * f_] = expf(((b_last - b) + iv) - m_next);
    }
    if (pair == 0 && p == 0)
      so[(long long)bh * n_chunks + c] = expf((b_last + m_c) - m_next);
  }

  // --- dy . y, 1 / den and dN for the tile's query rows (a warp a row) ----
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < kT; r += kThreads / 32) {
      const int t = ti * kT + r;
      float acc = 0.f;
      if (t < len) {
        const T* yr = yb + (long long)(t0 + t) * ys.s;
        const T* dr = dyb + (long long)(t0 + t) * dys.s;
        for (int e = lane; e < dh; e += 32) acc = fmaf(ld(dr + e), ld(yr + e), acc);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
      if (lane == 0) {
        float inv_den = 0.f, dn = 0.f;
        if (t < len) {
          const long long at = (long long)bh * 2 * S + t0 + t;
          inv_den = expf(m_s[t] - stats[at]);
          dn = -stats[at + S] * acc * inv_den;
          if (ti == tj) {
            const long long f_ = (long long)gridDim.y * S;
            float* a = aux + (long long)bh * S + t0 + t;
            a[kInvDen * f_] = inv_den;
            a[kDN * f_] = dn;
          }
        }
        inv_den_s[r] = inv_den;
        dn_s[r] = dn;
      }
    }
  }

  // --- S = q k^T and dP = dy v^T over the head dim ---------------------
  const int ty = tid >> 4, tx = tid & 15;  // rows ty + 16 r, cols tx + 16 c
  float sacc[4][4], pacc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) sacc[r][cc] = pacc[r][cc] = 0.f;
  for (int x0 = 0; x0 < dh; x0 += kK) {
    __syncthreads();  // the previous step's tiles are read
    for (int idx = tid; idx < kT * kK; idx += kThreads) {
      const int r = idx / kK, xx = idx % kK;
      const bool qlive = ti * kT + r < len, klive = tj * kT + r < len;
      const long long tq = t0 + ti * kT + r, tk = t0 + tj * kT + r;
      qt[r][xx] = qlive ? ld(qb + tq * qs.s + x0 + xx) : 0.f;
      dyt[r][xx] = qlive ? ld(dyb + tq * dys.s + x0 + xx) : 0.f;
      kt[r][xx] = klive ? ld(kb + tk * ks.s + x0 + xx) : 0.f;
      vt[r][xx] = klive ? ld(vb + tk * vs.s + x0 + xx) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int xx = 0; xx < kK; ++xx) {
      float a[4], bk[4], d[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = qt[ty + 16 * r][xx];
        d[r] = dyt[ty + 16 * r][xx];
        bk[r] = kt[tx + 16 * r][xx];
        vv[r] = vt[tx + 16 * r][xx];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          sacc[r][cc] = fmaf(a[r], bk[cc], sacc[r][cc]);
          pacc[r][cc] = fmaf(d[r], vv[cc], pacc[r][cc]);
        }
    }
  }

  // --- W, dS, G ---------------------------------------------------------
  const long long mbase = ((long long)bh * n_chunks + c) * kChunk;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rr = ty + 16 * r, t = ti * kT + rr;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = tj * kT + tx + 16 * cc;
      float w = 0.f, ds = 0.f, g = 0.f;
      if (j <= t && t < len) {
        const float e = expf(((b_s[t] - b_s[j]) + i_s[j]) - m_s[t]);
        w = sacc[r][cc] * inv_sqrt * e;
        const float dw = pacc[r][cc] * inv_den_s[rr] + dn_s[rr];
        ds = dw * e;
        g = dw * w;
      }
      const long long at = (mbase + t) * kChunk + j;
      wm[at] = w;
      dsm[at] = ds;
      gm[at] = g;
    }
  }
}

// ---------------------------------------------------------------------------
// Reverse states: grid ((Dh / 64)^2, B * H); block dt + n_dt et owns rows
// d0 = 64 dt .. and columns e0 = 64 et .. of dC.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_states_kernel(const T* __restrict__ q, const T* __restrict__ dy,
                        const float* __restrict__ aux,
                        const float* __restrict__ so, const T* __restrict__ cs,
                        const float* __restrict__ ns, float* __restrict__ dcs,
                        float* __restrict__ dns, float* __restrict__ p_part,
                        int h, int s_len, int dh, Rows qs, Rows dys,
                        float inv_sqrt) {
  __shared__ float qg[kT][kT + 1];   // g_t q~_t[d0 + dd], rows positions
  __shared__ float dyy[kT][kT + 1];  // dy_t[e0 + ee] / den_t
  __shared__ float dn_pos[kT], red[8];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_dt = dh / kT;
  const int dt = blockIdx.x % n_dt, et = blockIdx.x / n_dt;
  const int d0 = dt * kT, e0 = et * kT;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const long long S = s_len, field = (long long)gridDim.y * S;
  const T* qb = q + bi * qs.b + hi * qs.h + d0;
  const T* dyb = dy + bi * dys.b + hi * dys.h + e0;
  const float* ab = aux + (long long)bh * S;
  const bool n_owner = et == 0 && tid < kT;  // carries dn[d0 + tid]

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
  float dn_d = 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    // --- dC, dn at chunk c's end, and the tile's share of P ------------
    const long long base = ((long long)bh * n_chunks + c) * dh;
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const long long at = (base + d0 + ty + 16 * r) * dh + e0 + tx + 16 * cc;
        dcs[at] = acc[r][cc];
        part = fmaf(acc[r][cc], ld(cs + at), part);
      }
    if (n_owner) {
      dns[base + d0 + tid] = dn_d;
      part = fmaf(dn_d, ns[base + d0 + tid], part);
    }
    part = block_sum(part, red);
    if (tid == 0)
      p_part[((long long)bh * n_chunks + c) * n_dt * n_dt + blockIdx.x] = part;
    if (c == 0) break;

    // --- back across chunk c --------------------------------------------
    const float sc = so[(long long)bh * n_chunks + c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] *= sc;
    dn_d *= sc;
    const int t0 = c * kChunk, len = min(kChunk, s_len - t0);
    for (int p0 = 0; p0 < len; p0 += kT) {
      __syncthreads();  // the previous tile is read
      for (int idx = tid; idx < kT * kT; idx += kThreads) {
        const int p = idx / kT, x = idx % kT;
        const long long t = t0 + p0 + p;
        const bool live = p0 + p < len;
        qg[p][x] = live ? ld(qb + t * qs.s + x) * inv_sqrt * ab[kG * field + t]
                        : 0.f;
        dyy[p][x] = live ? ld(dyb + t * dys.s + x) * ab[kInvDen * field + t]
                         : 0.f;
      }
      if (tid < kT)
        dn_pos[tid] = p0 + tid < len ? ab[kDN * field + t0 + p0 + tid] : 0.f;
      __syncthreads();
#pragma unroll 8
      for (int p = 0; p < kT; ++p) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = qg[p][ty + 16 * r];
          b[r] = dyy[p][tx + 16 * r];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
      }
      if (n_owner)
        for (int p = 0; p < kT; ++p) dn_d = fmaf(qg[p][tid], dn_pos[p], dn_d);
    }
  }
}

// ---------------------------------------------------------------------------
// Gradients: grid (ceil(S / 64) * (Dh / 64), B * H, 3); role z = 0 dq,
// 1 dk, 2 dv, for the 64 positions of tile pt and the 64 columns of slice.
// ---------------------------------------------------------------------------
template <typename T, int kRole>
__device__ __forceinline__ void grads_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dy, const float* __restrict__ aux,
    const float* __restrict__ wm, const float* __restrict__ dsm,
    const T* __restrict__ cs, const float* __restrict__ ns,
    const float* __restrict__ dcs, const float* __restrict__ dns,
    T* __restrict__ out, float* __restrict__ part, int h, int s_len, int dh,
    Rows qs, Rows ks, Rows vs, Rows dys, float inv_sqrt,
    float (*at_)[kK + 1], float (*mt_)[kT + 1]) {
  // at_: A (positions x contraction), mt_: M (contraction x columns)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_dt = dh / kT;
  const int pt = blockIdx.x / n_dt, slice = blockIdx.x % n_dt;
  const int col0 = slice * kT;
  const int c = pt / kTiles, lt = pt % kTiles;
  const int t0 = c * kChunk, len = min(kChunk, s_len - t0);
  const int p0 = t0 + lt * kT;  // the tile's first position
  const int n_live = (len + kT - 1) / kT;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const long long S = s_len, field = (long long)gridDim.y * S;
  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;
  const T* dyb = dy + bi * dys.b + hi * dys.h;
  const float* ab = aux + (long long)bh * S;
  const long long mat = ((long long)bh * n_chunks + c) * dh * dh;
  const long long vec = ((long long)bh * n_chunks + c) * dh;

  // --- the dense product over the head dim -----------------------------
  // dq: dy C_c^T (x = e), dk: v dC^T (x = e), dv: k dC (x = d).
  const T* arow = kRole == 0 ? dyb : kRole == 1 ? vb : kb;
  const long long astr = kRole == 0 ? dys.s : kRole == 1 ? vs.s : ks.s;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
  for (int x0 = 0; x0 < dh; x0 += kK) {
    __syncthreads();
    for (int idx = tid; idx < kT * kK; idx += kThreads) {
      const int r = idx / kK, xx = idx % kK;
      at_[r][xx] = p0 + r < s_len ? ld(arow + (long long)(p0 + r) * astr + x0 + xx)
                                  : 0.f;
      if (kRole == 2) {  // M[x][col] = dC[x][col]
        const int xr = idx / kT, cc = idx % kT;
        mt_[xr][cc] = dcs[mat + (long long)(x0 + xr) * dh + col0 + cc];
      } else {           // M[x][col] = C_c[col][x] or dC[col][x]
        const int cc = idx / kK;
        const long long at = mat + (long long)(col0 + cc) * dh + x0 + xx;
        mt_[xx][cc] = kRole == 0 ? ld(cs + at) : dcs[at];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int xx = 0; xx < kK; ++xx) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = at_[ty + 16 * r][xx];
        b[r] = mt_[xx][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
    }
  }

  // --- the dense terms, and the slice's share of R (dq) or Q (dk) --------
  float dense[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long t = p0 + ty + 16 * r;
    const bool live = t < s_len;
    float rowpart = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = col0 + tx + 16 * cc;
      float x = 0.f;
      if (live) {
        if (kRole == 0) {
          const float dn = ab[kDN * field + t];
          const float d = acc[r][cc] * ab[kInvDen * field + t] + dn * ns[vec + col];
          rowpart = fmaf(ld(qb + t * qs.s + col) * inv_sqrt, d, rowpart);
          x = ab[kG * field + t] * d;
        } else if (kRole == 1) {
          const float d = acc[r][cc] + dns[vec + col];
          rowpart = fmaf(ld(kb + t * ks.s + col), d, rowpart);
          x = ab[kKvw * field + t] * d;
        } else {
          x = ab[kKvw * field + t] * acc[r][cc];
        }
      }
      dense[r][cc] = x;
    }
    if (kRole != 2) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rowpart += __shfl_xor_sync(~0u, rowpart, o);
      if (tx == 0 && live) part[(bh * S + t) * n_dt + slice] = rowpart;
    }
  }

  // --- the chunk's L x L part -------------------------------------------
  // dq: dS k over key tiles 0 .. lt; dk: dS^T q~, dv: W^T dY over query
  // tiles lt .. n_live - 1.
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
  const float* zm = (kRole == 2 ? wm : dsm) +
                    ((long long)bh * n_chunks + c) * kChunk * kChunk;
  const int u_first = kRole == 0 ? 0 : lt, u_end = kRole == 0 ? lt + 1 : n_live;
  for (int u = u_first; u < u_end; ++u) {
    for (int x0 = 0; x0 < kT; x0 += kK) {
      __syncthreads();
      for (int idx = tid; idx < kT * kK; idx += kThreads) {
        if (kRole == 0) {  // Z[r][x] = dS[lt 64 + r][u 64 + x0 + x]
          const int r = idx / kK, xx = idx % kK;
          at_[r][xx] = zm[(long long)(lt * kT + r) * kChunk + u * kT + x0 + xx];
        } else {           // Z[r][x] = dS or W[u 64 + x0 + x][lt 64 + r]
          const int xx = idx / kT, r = idx % kT;
          at_[r][xx] = zm[(long long)(u * kT + x0 + xx) * kChunk + lt * kT + r];
        }
        const int xr = idx / kT, cc = idx % kT;
        const long long t = t0 + u * kT + x0 + xr;
        float x = 0.f;
        if (t < s_len) {
          if (kRole == 0) x = ld(kb + t * ks.s + col0 + cc);
          else if (kRole == 1) x = ld(qb + t * qs.s + col0 + cc) * inv_sqrt;
          else x = ld(dyb + t * dys.s + col0 + cc) * ab[kInvDen * field + t];
        }
        mt_[xr][cc] = x;
      }
      __syncthreads();
#pragma unroll 8
      for (int xx = 0; xx < kK; ++xx) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = at_[ty + 16 * r][xx];
          b[r] = mt_[xx][tx + 16 * r];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long t = p0 + ty + 16 * r;
    if (t >= s_len) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float x = dense[r][cc] + acc[r][cc];
      st(out + (bh * S + t) * dh + col0 + tx + 16 * cc,
         kRole == 0 ? x * inv_sqrt : x);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_grads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dy,
                       const float* __restrict__ aux,
                       const float* __restrict__ wm,
                       const float* __restrict__ dsm, const T* __restrict__ cs,
                       const float* __restrict__ ns,
                       const float* __restrict__ dcs,
                       const float* __restrict__ dns, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ r_part, float* __restrict__ q_part,
                       int h, int s_len, int dh, Rows qs, Rows ks, Rows vs,
                       Rows dys, float inv_sqrt) {
  __shared__ float at_[kT][kK + 1], mt_[kK][kT + 1];
  if (blockIdx.z == 0)
    grads_block<T, 0>(q, k, v, dy, aux, wm, dsm, cs, ns, dcs, dns, dq, r_part,
                      h, s_len, dh, qs, ks, vs, dys, inv_sqrt, at_, mt_);
  else if (blockIdx.z == 1)
    grads_block<T, 1>(q, k, v, dy, aux, wm, dsm, cs, ns, dcs, dns, dk, q_part,
                      h, s_len, dh, qs, ks, vs, dys, inv_sqrt, at_, mt_);
  else
    grads_block<T, 2>(q, k, v, dy, aux, wm, dsm, cs, ns, dcs, dns, dv,
                      nullptr, h, s_len, dh, qs, ks, vs, dys, inv_sqrt, at_,
                      mt_);
}

// ---------------------------------------------------------------------------
// Gates: grid (n_chunks, B * H), thread p = position t0 + p.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_gates_kernel(const T* __restrict__ fg, const float* __restrict__ aux,
                       const float* __restrict__ so,
                       const float* __restrict__ gm,
                       const float* __restrict__ r_part,
                       const float* __restrict__ q_part,
                       const float* __restrict__ p_part, T* __restrict__ di,
                       T* __restrict__ df, int h, int s_len, int dh, Rows fs) {
  __shared__ float rowg[kChunk], db_s[kChunk], red[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int n_chunks = (s_len + kChunk - 1) / kChunk, n_dt = dh / kT;
  const int t0 = c * kChunk, len = min(kChunk, s_len - t0);
  const long long S = s_len, field = (long long)gridDim.y * S;
  const float* g = gm + ((long long)bh * n_chunks + c) * kChunk * kChunk;
  const float* ab = aux + (long long)bh * S;

  // sum_j G_pj over j <= p: a warp a row
  for (int p = warp; p < len; p += kThreads / 32) {
    float acc = 0.f;
    for (int j = lane; j <= p; j += 32) acc += g[(long long)p * kChunk + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
    if (lane == 0) rowg[p] = acc;
  }
  float pp = 0.f;
  const int n_tiles = n_dt * n_dt;
  const float* pb = p_part + ((long long)bh * n_chunks + c) * n_tiles;
  for (int i = tid; i < n_tiles; i += kThreads) pp += pb[i];
  const float big_p = so[(long long)bh * n_chunks + c] * block_sum(pp, red);

  const int p = tid;
  const bool live = p < len;
  const long long t = t0 + p;
  float col = 0.f, big_r = 0.f, big_q = 0.f;
  if (live) {
    for (int u = p; u < len; ++u) col += g[(long long)u * kChunk + p];
    float rs = 0.f, qsum = 0.f;
    for (int i = 0; i < n_dt; ++i) {
      rs += r_part[(bh * S + t) * n_dt + i];
      qsum += q_part[(bh * S + t) * n_dt + i];
    }
    big_r = ab[kG * field + t] * rs;
    big_q = ab[kKvw * field + t] * qsum;
  }
  const float sum_q = block_sum(big_q, red);  // also orders rowg's writes
  float db = live ? ((rowg[p] - col) + big_r) - big_q : 0.f;
  if (p == len - 1) db += sum_q + big_p;
  if (live) st(di + bh * S + t, col + big_q);

  // d log f_u = sum_{t >= u} db_t: a scan in reversed order
  db_s[p] = db;
  __syncthreads();
  const int u = kChunk - 1 - p;
  const float dlogf = block_scan_sum(db_s[u], red);
  if (u < len) {
    const float f = ld(fg + bi * fs.b + hi * fs.h + (long long)(t0 + u) * fs.s);
    st(df + bh * S + t0 + u, dlogf / (1.f + expf(f)));
  }
}

template <typename T>
int launch_scores(const void* q, const void* k, const void* v,
                  const void* ig, const void* fg, const void* y,
                  const void* dy, const float* ms, const float* m_last,
                  const float* stats, float* aux, float* so, float* wm,
                  float* dsm, float* gm, int b, int h, int s, int dh,
                  const Rows* r, float inv_sqrt, cudaStream_t stream) {
  const int n_chunks = (s + kChunk - 1) / kChunk;
  mlstm_bwd_scores_kernel<T><<<dim3(n_chunks * kPairs, b * h), kThreads, 0,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ig),
      static_cast<const T*>(fg), static_cast<const T*>(y),
      static_cast<const T*>(dy), ms, m_last, stats, aux, so, wm, dsm, gm, h,
      s, dh, r[0], r[1], r[2], r[3], r[4], r[5], r[6], inv_sqrt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_states(const void* q, const void* dy, const float* aux,
                  const float* so, const void* cs, const float* ns,
                  float* dcs, float* dns, float* p_part, int b, int h, int s,
                  int dh, Rows qs, Rows dys, float inv_sqrt,
                  cudaStream_t stream) {
  const int n_dt = dh / kT;
  mlstm_bwd_states_kernel<T><<<dim3(n_dt * n_dt, b * h), kThreads, 0,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(dy), aux, so,
      static_cast<const T*>(cs), ns, dcs, dns, p_part, h, s, dh, qs, dys,
      inv_sqrt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grads(const void* q, const void* k, const void* v, const void* dy,
                 const float* aux, const float* wm, const float* dsm,
                 const void* cs, const float* ns, const float* dcs,
                 const float* dns, void* dq, void* dk, void* dv,
                 float* r_part, float* q_part, int b, int h, int s, int dh,
                 const Rows* r, float inv_sqrt, cudaStream_t stream) {
  const dim3 grid(((s + kT - 1) / kT) * (dh / kT), b * h, 3);
  mlstm_bwd_grads_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dy), aux, wm, dsm,
      static_cast<const T*>(cs), ns, dcs, dns, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), r_part, q_part, h, s, dh,
      r[0], r[1], r[2], r[3], inv_sqrt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gates(const void* fg, const float* aux, const float* so,
                 const float* gm, const float* r_part, const float* q_part,
                 const float* p_part, void* di, void* df, int b, int h, int s,
                 int dh, Rows fs, cudaStream_t stream) {
  const int n_chunks = (s + kChunk - 1) / kChunk;
  mlstm_bwd_gates_kernel<T><<<dim3(n_chunks, b * h), kThreads, 0, stream>>>(
      static_cast<const T*>(fg), aux, so, gm, r_part, q_part, p_part,
      static_cast<T*>(di), static_cast<T*>(df), h, s, dh, fs);
  return (int)cudaGetLastError();
}

inline bool bad_shape(int dtype, int b, int h, int s, int dh) {
  return (dtype != 0 && dtype != 1) || dh % kT || dh < kT || dh > 1024 ||
         s < 1 || b < 1 || h < 1;
}

}  // namespace mbwd
}  // namespace repro

using repro::mbwd::Rows;

// dtype 0: float32 q, k, v, gates, y, dy, chunk states C_c and outputs;
// 1: bfloat16.  Strides in elements, (batch, head, position), the head dim
// contiguous.  Every float32 buffer and every output is contiguous:
// ms (B, H, n_chunks), m_last (B, H), stats (B, H, 2, S) (ell, sgn), aux
// (7, B, H, S), so (B, H, n_chunks), wm, dsm, gm (B, H, n_chunks, 256,
// 256), cs (B, H, n_chunks, Dh, Dh), ns, dns (B, H, n_chunks, Dh), dcs
// (B, H, n_chunks, Dh, Dh), p_part (B, H, n_chunks, (Dh / 64)^2), r_part,
// q_part (B, H, S, Dh / 64), dq, dk, dv (B, H, S, Dh), di, df (B, H, S).
extern "C" int mlstm_bwd_scores_launch(
    int dtype, const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* y, const void* dy, const void* ms,
    const void* m_last, const void* stats, void* aux, void* so, void* wm,
    void* dsm, void* gm, int b, int h, int s, int dh, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long i_sb, long long i_sh, long long i_ss, long long f_sb,
    long long f_sh, long long f_ss, long long y_sb, long long y_sh,
    long long y_ss, long long dy_sb, long long dy_sh, long long dy_ss,
    float inv_sqrt, void* stream) {
  using namespace repro::mbwd;
  if (bad_shape(dtype, b, h, s, dh)) return (int)cudaErrorInvalidValue;
  const Rows r[7] = {{q_sb, q_sh, q_ss},    {k_sb, k_sh, k_ss},
                     {v_sb, v_sh, v_ss},    {i_sb, i_sh, i_ss},
                     {f_sb, f_sh, f_ss},    {y_sb, y_sh, y_ss},
                     {dy_sb, dy_sh, dy_ss}};
  auto launch = dtype ? launch_scores<bf16> : launch_scores<float>;
  return launch(q, k, v, ig, fg, y, dy, static_cast<const float*>(ms),
                static_cast<const float*>(m_last),
                static_cast<const float*>(stats), static_cast<float*>(aux),
                static_cast<float*>(so), static_cast<float*>(wm),
                static_cast<float*>(dsm), static_cast<float*>(gm), b, h, s, dh,
                r, inv_sqrt, static_cast<cudaStream_t>(stream));
}

extern "C" int mlstm_bwd_states_launch(
    int dtype, const void* q, const void* dy, const void* aux,
    const void* so, const void* cs, const void* ns, void* dcs, void* dns,
    void* p_part, int b, int h, int s, int dh, long long q_sb, long long q_sh,
    long long q_ss, long long dy_sb, long long dy_sh, long long dy_ss,
    float inv_sqrt, void* stream) {
  using namespace repro::mbwd;
  if (bad_shape(dtype, b, h, s, dh)) return (int)cudaErrorInvalidValue;
  auto launch = dtype ? launch_states<bf16> : launch_states<float>;
  return launch(q, dy, static_cast<const float*>(aux),
                static_cast<const float*>(so), cs,
                static_cast<const float*>(ns), static_cast<float*>(dcs),
                static_cast<float*>(dns), static_cast<float*>(p_part), b, h, s,
                dh, Rows{q_sb, q_sh, q_ss}, Rows{dy_sb, dy_sh, dy_ss},
                inv_sqrt, static_cast<cudaStream_t>(stream));
}

extern "C" int mlstm_bwd_grads_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dy,
    const void* aux, const void* wm, const void* dsm, const void* cs,
    const void* ns, const void* dcs, const void* dns, void* dq, void* dk,
    void* dv, void* r_part, void* q_part, int b, int h, int s, int dh,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long dy_sb, long long dy_sh, long long dy_ss,
    float inv_sqrt, void* stream) {
  using namespace repro::mbwd;
  if (bad_shape(dtype, b, h, s, dh)) return (int)cudaErrorInvalidValue;
  const Rows r[4] = {{q_sb, q_sh, q_ss},
                     {k_sb, k_sh, k_ss},
                     {v_sb, v_sh, v_ss},
                     {dy_sb, dy_sh, dy_ss}};
  auto launch = dtype ? launch_grads<bf16> : launch_grads<float>;
  return launch(q, k, v, dy, static_cast<const float*>(aux),
                static_cast<const float*>(wm), static_cast<const float*>(dsm),
                cs, static_cast<const float*>(ns),
                static_cast<const float*>(dcs), static_cast<const float*>(dns),
                dq, dk, dv, static_cast<float*>(r_part),
                static_cast<float*>(q_part), b, h, s, dh, r, inv_sqrt,
                static_cast<cudaStream_t>(stream));
}

extern "C" int mlstm_bwd_gates_launch(
    int dtype, const void* fg, const void* aux, const void* so,
    const void* gm, const void* r_part, const void* q_part,
    const void* p_part, void* di, void* df, int b, int h, int s, int dh,
    long long f_sb, long long f_sh, long long f_ss, void* stream) {
  using namespace repro::mbwd;
  if (bad_shape(dtype, b, h, s, dh)) return (int)cudaErrorInvalidValue;
  auto launch = dtype ? launch_gates<bf16> : launch_gates<float>;
  return launch(fg, static_cast<const float*>(aux),
                static_cast<const float*>(so), static_cast<const float*>(gm),
                static_cast<const float*>(r_part),
                static_cast<const float*>(q_part),
                static_cast<const float*>(p_part), di, df, b, h, s, dh,
                Rows{f_sb, f_sh, f_ss}, static_cast<cudaStream_t>(stream));
}
