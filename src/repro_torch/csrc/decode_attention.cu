// decode_attention: flash-decoding of one query token per sequence against
// a KV cache, masked by the filled length valid_len.
//
// Replaces the Pallas TPU kernel _decode_kernel / decode_attention in
// src/repro/kernels/decode_attention.py.  out[b, h] = sum_{j < valid_len}
// p_j v[b, j, h/G] with p = softmax_j(q[b, h] . k[b, j, h/G] / sqrt(D)); G =
// Hq / Hkv query heads share one KV head.  No window: a caller with a
// sliding window hands in the window's slice of the cache.
//
// Layouts: q (B, Hq, D), k and v (B, S, Hkv, D) (the cache's own layout),
// out (B, Hq, D), each read through its strides with the head dim
// contiguous, so a slice of the cache along S is passed without a copy.
// valid_len is a host int (the serving loop knows the cache length), so
// the grid covers exactly the filled keys and no block reads past them.
//
// Bound on this card: bytes.  Each live K and V row is read once, 2 x
// valid_len x Hkv x D elements per sequence (8.5 MB at gemma3-1b's decode,
// B = 4, valid_len 2079, bf16: ~2.5 us at 3.35 TB/s), against 4 D
// operations per (query head, key).
//
// Design: split the cache over many blocks, then combine.
// - decode_split_kernel: one block of 4 warps per (chunk of 64 keys, batch
//   x KV head), so a 2079-key cache at B = 4 fills 132 blocks.  A warp
//   takes 16 consecutive keys, 4 at a time: it loads the 4 K and V rows
//   first (lane l holds dims l + 32 i, every load coalesced), then computes
//   the G scores of each key with a butterfly and folds them into its own
//   online softmax (m, l, acc per query head, acc in registers).  The G
//   query heads of the KV head share every K/V row read.  The 4 warps
//   merge through shared memory and the block writes one partial (m, l,
//   acc) per query head.
// - decode_combine_kernel: one block per (batch x KV head, query head)
//   merges the partials of all chunks and writes acc / l once, in the
//   input's type.
// - The partials are float32 scratch allocated by the wrapper, (G D + 2 G)
//   floats per chunk: about 6% of the K/V bytes at the shapes above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kChunk = 64;   // keys per block
constexpr int kWarps = 4;
constexpr int kUnroll = 4;   // keys a warp loads before it computes
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Partials of (batch x KV head) bh, chunk c, query head gi, at index
// e = (bh * n_chunks + c) * G + gi: m at part[e], l at part[n + e], acc at
// part[2 n + e * D], with n = bh_count * n_chunks * G.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part, int hkv,
                    int valid_len, int n_chunks, long long q_sb,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, float scale) {
  constexpr int kDl = D / 32;  // dims per lane
  __shared__ float red_m[kWarps][G], red_l[kWarps][G];
  __shared__ float red_acc[kWarps][G][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / hkv, hi = bh % hkv;
  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;

  float qr[G][kDl], acc[G][kDl], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const T* qrow = q + bi * q_sb + (hi * G + gi) * q_sh;
#pragma unroll
    for (int i = 0; i < kDl; ++i) {
      qr[gi][i] = to_float(qrow[lane + 32 * i]);
      acc[gi][i] = 0.f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  const int key0 = c * kChunk + warp * (kChunk / kWarps);
  const int key_end = min(key0 + kChunk / kWarps, valid_len);
  for (int j0 = key0; j0 < key_end; j0 += kUnroll) {
    float kr[kUnroll][kDl], vr[kUnroll][kDl];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = j0 + u < key_end;  // uniform across the warp
#pragma unroll
      for (int i = 0; i < kDl; ++i) {
        kr[u][i] = live ? to_float(kb[(j0 + u) * k_ss + lane + 32 * i]) : 0.f;
        vr[u][i] = live ? to_float(vb[(j0 + u) * v_ss + lane + 32 * i]) : 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float s[kUnroll];
      float s_max = m[gi];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part_dot = 0.f;
#pragma unroll
        for (int i = 0; i < kDl; ++i) part_dot = fmaf(qr[gi][i], kr[u][i], part_dot);
        s[u] = j0 + u < key_end ? warp_sum(part_dot) * scale : kNegInf;
        s_max = fmaxf(s_max, s[u]);
      }
      const float a = expf(m[gi] - s_max);
      float p_sum = 0.f;
#pragma unroll
      for (int i = 0; i < kDl; ++i) acc[gi][i] *= a;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = s[u] == kNegInf ? 0.f : expf(s[u] - s_max);
        p_sum += p;
#pragma unroll
        for (int i = 0; i < kDl; ++i) acc[gi][i] = fmaf(p, vr[u][i], acc[gi][i]);
      }
      l[gi] = l[gi] * a + p_sum;
      m[gi] = s_max;
    }
  }

  // Merge the warps' states; warps without keys carry m = kNegInf, l = 0.
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      red_m[warp][gi] = m[gi];
      red_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < kDl; ++i) red_acc[warp][gi][lane + 32 * i] = acc[gi][i];
  }
  __syncthreads();
  const int n = gridDim.y * n_chunks * G;
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int gi = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][gi]);
    float sum_l = 0.f, sum_acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = red_l[w][gi] > 0.f ? expf(red_m[w][gi] - mx) : 0.f;
      sum_l += red_l[w][gi] * a;
      sum_acc += red_acc[w][gi][d] * a;
    }
    const int e = (bh * n_chunks + c) * G + gi;
    if (d == 0) {
      part[e] = mx;
      part[n + e] = sum_l;
    }
    part[2 * n + (long long)e * D + d] = sum_acc;
  }
}

template <typename T, int D, int G>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int hkv,
                                      int n_chunks, long long o_sb,
                                      long long o_sh) {
  const int bh = blockIdx.x, gi = blockIdx.y, d = threadIdx.x;
  const int bi = bh / hkv, hi = bh % hkv;
  const int n = gridDim.x * n_chunks * G;
  const int e0 = bh * n_chunks * G + gi;
  float mx = kNegInf;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, part[e0 + c * G]);
  float sum_l = 0.f, sum_acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int e = e0 + c * G;
    const float a = expf(part[e] - mx);
    sum_l += part[n + e] * a;
    sum_acc += part[2 * n + (long long)e * D + d] * a;
  }
  out[bi * o_sb + (hi * G + gi) * o_sh + d] =
      from_float<T>(sum_acc / fmaxf(sum_l, 1e-30f));
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, int b, int hkv, int valid_len, const long long* st,
           float scale, cudaStream_t stream) {
  const int n_chunks = (valid_len + kChunk - 1) / kChunk;
  decode_split_kernel<T, D, G><<<dim3(n_chunks, b * hkv), kWarps * 32, 0,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part, hkv, valid_len, n_chunks, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D, G><<<dim3(b * hkv, G), D, 0, stream>>>(
      part, static_cast<T*>(out), hkv, n_chunks, st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(int g, const void* q, const void* k, const void* v, void* out,
             float* part, int b, int hkv, int valid_len, const long long* st,
             float scale, cudaStream_t stream) {
  switch (g) {
    case 1: return launch<T, D, 1>(q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    case 2: return launch<T, D, 2>(q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    case 4: return launch<T, D, 4>(q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    case 8: return launch<T, D, 8>(q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dg(int d, int g, const void* q, const void* k, const void* v,
              void* out, float* part, int b, int hkv, int valid_len,
              const long long* st, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_g<T, 32>(g, q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    case 64: return launch_g<T, 64>(g, q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    case 128: return launch_g<T, 128>(g, q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    case 256: return launch_g<T, 256>(g, q, k, v, out, part, b, hkv, valid_len, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro

// The number of float32 scratch values a call needs: (D + 2) per (batch x
// KV head, chunk of keys, query head).
extern "C" long long decode_attention_scratch(int b, int hkv, int g, int d,
                                              int valid_len) {
  const long long n_chunks = (valid_len + repro::kChunk - 1) / repro::kChunk;
  return (long long)b * hkv * n_chunks * g * (d + 2);
}

// dtype: 0 = float32, 1 = bfloat16; scale is 1 / sqrt(D) rounded to
// float32.  Strides in elements: q (batch, head), k and v (batch, position,
// head), out (batch, head); the head dim is contiguous.  1 <= valid_len.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* scratch,
    int dtype, int b, int hkv, int g, int d, int valid_len, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_sh, float scale, void* stream) {
  const long long st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_sh};
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_dg<float>(d, g, q, k, v, out, part, b, hkv,
                                   valid_len, st, scale, s);
  if (dtype == 1)
    return repro::launch_dg<__nv_bfloat16>(d, g, q, k, v, out, part, b, hkv,
                                           valid_len, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
