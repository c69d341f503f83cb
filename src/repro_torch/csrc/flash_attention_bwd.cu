// flash_attention_bwd: the backward of flash_attention (B5), two kernels.
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
// Backward, from dO:
//   L_i = log sum_j exp(x_ij)            (recomputed: B5's forward, tuned for
//                                          serving, keeps no statistics)
//   Delta_i = sum_d dO_id o_id
//   P_ij = exp(x_ij - L_i),  dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - Delta_i) (1 - (x_ij / c)^2 under the soft cap) / sqrt(D)
//   dq_i = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
//
// Kernel 1 (flash_attention_bwd_dq_kernel), one block per (batch, KV head,
// tile of 64 rows), rows numbered position-major over the G query heads of
// the KV head as in the forward: a first sweep over the live key tiles gives
// each row's max and sum (L), the block writes L and Delta for kernel 2, and
// a second sweep forms P, dP and dS and accumulates dq in registers.
//
// Kernel 2 (flash_attention_bwd_dkdv_kernel), one block per (batch, KV head,
// tile of 32 keys): it walks the row tiles (all G heads) that see its keys,
// recomputes P and dS from L and Delta, and accumulates dk and dv in
// registers.  The G heads' sum is taken in the block, so no atomics: the
// result is the same bits on every run.
//
// Layouts: q, o, dO and dq are (B, Hq, Sq, D), k, v, dk and dv (B, Hkv, Skv,
// D), each read or written through its own (batch, head, position) strides
// with the head dim contiguous.  bfloat16 inputs are widened to float32 in
// shared memory; every product and sum is float32 on the FMA units (no
// tensor cores yet), the results rounded once to the input dtype.
//
// Bound on this card: operations.  The backward needs 10 D operations per
// live (query, key) pair (S, dP, dq, dk, dv), these kernels do 16 D (the
// first sweep and kernel 2's recompute of S and dP) at float32 FMA rates.
// Shared memory: Q, dO (64 rows) and K, V (32 keys), rows padded by 4 floats
// for the float4 reads, plus the 64 x 33 P and dS tiles: ~204 KB (kernel 1)
// and ~212 KB (kernel 2) at D = 256, one block of 256 threads per SM.
// Tiles come in a row a warp (its position and head computed once), a
// lane every 32nd dim: with a division per element and a loop over the
// flat tile instead, both kernels took 1.5-1.9x as long.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_bwd {

constexpr int kRows = 64;     // rows (position, query head) a tile
constexpr int kKeys = 32;     // keys a tile
constexpr int kThreads = 256;
constexpr int kPS = kKeys + 1;  // padded row of the P and dS tiles
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

struct Strides {
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // (B, Hq, Sq), contiguous
  int hkv, g, s_len, kv_len;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale, cap_pre, cap;  // cap_pre = scale / cap (0 without the cap)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}
// Over the 16 lanes that share a group of rows (lanes 0-15 or 16-31).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
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

// Rows [r0, r0 + kRows) of a (position, head)-row tensor into dst (padded),
// zeros past n_rows.  base is offset to the batch.  A warp takes a row at
// a time (its position and head computed once), a lane every 32nd dim.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* base, Strides st, int hi, int g,
                          int r0, int n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int row = r0 + r;
    float* out = dst + r * (D + 4);
    if (row < n_rows) {
      const T* src = base + (hi * g + row % g) * st.h + (row / g) * st.s;
#pragma unroll
      for (int d = lane; d < D; d += 32) out[d] = to_f(src[d]);
    } else {
#pragma unroll
      for (int d = lane; d < D; d += 32) out[d] = 0.f;
    }
  }
}

// Keys [k0, k0 + kKeys) of a key tensor into dst (padded), zeros past
// kv_len.  base is offset to the batch and the KV head.  As load_rows.
template <typename T, int D>
__device__ void load_keys(float* dst, const T* base, long long st_s, int k0,
                          int kv_len) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < kKeys; j += kThreads / 32) {
    const int key = k0 + j;
    float* out = dst + j * (D + 4);
    if (key < kv_len) {
      const T* src = base + key * st_s;
#pragma unroll
      for (int d = lane; d < D; d += 32) out[d] = to_f(src[d]);
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

template <typename T, int D>
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
  const T* q = static_cast<const T*>(a.q) + bi * a.qs.b;
  const T* dout = static_cast<const T*>(a.dout) + bi * a.dos.b;
  const T* o = static_cast<const T*>(a.o) + bi * a.os.b;
  const T* k = static_cast<const T*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const long long stat0 = (long long)bi * a.hkv * g * a.s_len;

  load_rows<T, D>(q_s, q, a.qs, hi, g, r0, n_rows);
  load_rows<T, D>(do_s, dout, a.dos, hi, g, r0, n_rows);
  __syncthreads();

  // Delta: warp w takes rows w*8 .. w*8+7, a lane per D/32 dims.
  for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
    const int r = warp * (kRows / (kThreads / 32)) + rr, row = r0 + r;
    float part = 0.f;
    if (row < n_rows) {
      const int pos = row / g, head = hi * g + row % g;
      const T* orow = o + head * a.os.h + pos * a.os.s;
      for (int d = lane; d < D; d += 32)
        part = fmaf(do_s[r * kPad + d], to_f(orow[d]), part);
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

  // Sweep 1: each row's max and sum, kept alike by its 16 lanes.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = k_first; k0 < k_end; k0 += kKeys) {
    __syncthreads();
    load_keys<T, D>(k_s, k, a.ks.s, k0, a.kv_len);
    __syncthreads();
    float dot[4][2];
    tile_dots<D>(q_s, k_s, rg, cg, dot);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = (r0 + rg * 4 + i) / g;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float f;
        x[j] = live(pos, k0 + cg + 16 * j, a) ? logit(dot[i][j], a, &f)
                                                : kNegInf;
      }
      const float m_new = fmaxf(m[i], half_max(fmaxf(x[0], x[1])));
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        p += x[j] == kNegInf ? 0.f : expf(x[j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_sum(p);
      m[i] = m_new;
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, row = r0 + r;
      const float lse = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      row_l[r] = lse;
      if (row < n_rows) {
        const int pos = row / g, head = hi * g + row % g;
        a.lse[stat0 + (long long)head * a.s_len + pos] = lse;
      }
    }
  }

  // Sweep 2: dS, and dq = dS K.
  float acc[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  for (int k0 = k_first; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the last tile's readers are done; L is written
    load_keys<T, D>(k_s, k, a.ks.s, k0, a.kv_len);
    load_keys<T, D>(v_s, v, a.vs.s, k0, a.kv_len);
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

  T* dq = static_cast<T*>(a.dq) + bi * a.dqs.b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg * 4 + i;
    if (row >= n_rows) continue;
    const int pos = row / g, head = hi * g + row % g;
    T* drow = dq + head * a.dqs.h + pos * a.dqs.s;
#pragma unroll
    for (int c = 0; c < kDims; ++c) drow[cg + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D>
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
  const T* q = static_cast<const T*>(a.q) + bi * a.qs.b;
  const T* dout = static_cast<const T*>(a.dout) + bi * a.dos.b;
  const T* k = static_cast<const T*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const long long stat0 = (long long)bi * a.hkv * g * a.s_len;

  load_keys<T, D>(k_s, k, a.ks.s, k0, a.kv_len);
  load_keys<T, D>(v_s, v, a.vs.s, k0, a.kv_len);

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
    load_rows<T, D>(q_s, q, a.qs, hi, g, r0, n_rows);
    load_rows<T, D>(do_s, dout, a.dos, hi, g, r0, n_rows);
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

  T* dkb = static_cast<T*>(a.dk) + bi * a.dks.b + hi * a.dks.h;
  T* dvb = static_cast<T*>(a.dv) + bi * a.dvs.b + hi * a.dvs.h;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int key = k0 + 2 * kg + kk;
    if (key >= a.kv_len) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      dkb[key * a.dks.s + cg + 16 * c] = from_f<T>(dk[kk][c]);
      dvb[key * a.dvs.s + cg + 16 * c] = from_f<T>(dv[kk][c]);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem1 = dq_smem_bytes<D>(), smem2 = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((a.s_len * a.g + kRows - 1) / kRows, b * a.hkv);
  flash_attention_bwd_dq_kernel<T, D><<<grid1, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((a.kv_len + kKeys - 1) / kKeys, b * a.hkv);
  flash_attention_bwd_dkdv_kernel<T, D><<<grid2, kThreads, smem2, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const Args& a, int b, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(a, b, stream);
    case 64:
      return launch<T, 64>(a, b, stream);
    case 128:
      return launch<T, 128>(a, b, stream);
    case 256:
      return launch<T, 256>(a, b, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_bwd

// dtype: 0 = float32, 1 = bfloat16.  lse and delta are float32 scratch of
// B Hq Sq entries each (contiguous (B, Hq, Sq)), written by the first kernel
// and read by the second.  Strides are in elements, (batch, head, position)
// for each of q, k, v, o, dO, dq, dk and dv, in that order; the head dim is
// contiguous.  scale is 1 / sqrt(D) rounded to float32; softcap > 0 caps
// the scaled logits (0: off).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int dtype, int b, int hkv, int g, int s_len, int kv_len, int d,
    const long long* strides, int causal, int window, float scale,
    float softcap, void* stream) {
  using repro_bwd::Strides;
  repro_bwd::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = lse;
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
  if (dtype == 0) return repro_bwd::launch_d<float>(d, a, b, st);
  if (dtype == 1) return repro_bwd::launch_d<__nv_bfloat16>(d, a, b, st);
  return (int)cudaErrorInvalidValue;
}
