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
// contiguous and rows 16-byte aligned, so a slice of the cache along S is
// passed without a copy.  valid_len is a host int (the serving loop knows
// the cache length), so the grid covers exactly the filled keys.
//
// Bound on this card: bytes.  Each live K and V row is read once, 2 x
// valid_len x Hkv x D elements per sequence (8.5 MB at gemma3-1b's decode,
// B = 4, valid_len 2079, bf16: ~2.5 us at 3.35 TB/s), against 4 D
// operations per (query head, key).  So the design keeps as many bytes in
// flight as the card holds and spends one launch:
// - Splits sized to the card.  The wrapper picks n_splits per (batch, KV
//   head) so the grid gives at least 2 blocks per SM with at least 16 keys
//   a split (66 splits of 31-32 keys at the decode shape, B x Hkv = 4);
//   split i takes keys [i L / n, (i + 1) L / n).
// - Every K/V row of a block is issued before any arithmetic on it: 16-byte
//   cp.async copies into shared memory (up to 64 KB a round), all K rows
//   first, so the scores and the softmax run while V still arrives.
// - Scores: L lanes share a row, each holding E = max(16 / sizeof(T),
//   min(D, 64 / G)) of its dims (16-byte chunks L apart) and the G query
//   heads' matching q in registers, so a (key, head) dot reduces over
//   log2(L) shuffles (4 at D = 256, G = 4, not 5) and 32 / L rows share
//   each shuffle.
//   Scores go to shared memory in log2 units (scale log2(e) folded in);
//   one warp per head takes the round's max and exp2f.
// - P V: each thread owns G D / 128 consecutive (head, dim) outputs and
//   sweeps the round's rows of V in shared memory; no merge across warps.
// - Combine in the same launch: each block writes its float32 partial (m,
//   l, acc per query head); after a block barrier one thread fences and
//   takes a ticket on the (batch, KV head)'s int32 counter.  One block
//   reading all the partials is one SM ingesting n_splits G D floats (270
//   KB at the decode shape), slower on the card than SDPA's whole call, so
//   the merge is spread: the blocks that draw the last 8 tickets each
//   merge 1/8 of the G D outputs over every split (m, l and the acc
//   partials in flight together) and write them in the input's type.  The
//   last of them knows every partial is published; the other 7 wait on
//   the counter until it is.  That cannot deadlock: they wait only for
//   blocks that have not drawn a ticket yet, which never wait before they
//   draw one, and the grid (about 2 blocks per SM) is far below what the
//   card holds resident.  A second counter counts the mergers past their
//   wait; the last resets both to 0 for the next call.  Below 8 splits the
//   last block merges alone.  The counters are the wrapper's, zeroed once per
//   device: calls must run on one stream at a time, as serve makes them.
// - The partials are float32 scratch allocated by the wrapper per call,
//   (G D + 2 G) floats per split: about 6% of the K/V bytes above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 128;
constexpr int kRoundBytes = 64 * 1024;   // K + V rows staged per round
constexpr int kMaxRows = 128;            // rows per round at most
constexpr int kMaxSplits = 256;          // splits per (batch, KV head)
constexpr int kMergers = 8;              // blocks that merge the partials
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

// N elements of type T as floats: N / kVec 16-byte chunks, chunk j at p +
// j * stride elements (16-byte aligned), or N scalars from p when N is
// not a whole number of chunks.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, int stride,
                                            float (&x)[N]) {
  constexpr int kVec = 16 / sizeof(T);
  if constexpr (N % kVec == 0) {
#pragma unroll
    for (int c = 0; c < N / kVec; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + c * stride);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[c * kVec + i] = to_float(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_float(p[i]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}

template <typename T, int D, int G>
struct DecodeShape {
  static constexpr int kVec = 16 / sizeof(T);          // elements a chunk
  static constexpr int kE =                            // elements a lane
      (64 / G < kVec) ? kVec : (64 / G > D ? D : 64 / G);
  static constexpr int kLanes = D / kE;                // lanes a row
  static constexpr int kSlots = kThreads / kLanes;     // rows in parallel
  static constexpr int kRowBytes = D * sizeof(T);
  static constexpr int kRows = kRoundBytes / (2 * kRowBytes) > kMaxRows
                                   ? kMaxRows
                                   : kRoundBytes / (2 * kRowBytes);
  static constexpr int kOut = (G * D + kThreads - 1) / kThreads;  // per thread
};

// Merge the flat (head, dim) outputs [f_lo, f_lo + per) of (batch x KV
// head) bh over its n_splits partials (layout above) and write them: thread
// t takes f_lo + t + 128 k for k < R (coalesced), the first kBatch splits'
// acc loads in flight beside m and l.
template <typename T, int D, int G, int R>
__device__ __forceinline__ void merge_slice(
    const float* __restrict__ part, T* __restrict__ out, float* w_s,
    float* lw_s, float* l_s, int n_splits, int bh, int n_all, int f_lo,
    int per, long long o_base, long long o_sh) {
  constexpr int kBatch = 96 / R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long nd = (long long)n_all * D;
  const int e0 = bh * n_splits * G;
  const float* acc_part = part + (long long)e0 * D + f_lo + tid;
  float x[kBatch][R];
  auto load_batch = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int k = 0; k < R; ++k)
        x[j][k] = c0 + j < n_splits && tid + kThreads * k < per
                      ? __ldcg(acc_part + (long long)(c0 + j) * G * D +
                               kThreads * k)
                      : 0.f;
  };
  load_batch(0);

  // Weights 2^(m_c - max m) per (split, head) for the slice's heads.
  const int g_lo = f_lo / D, g_hi = (f_lo + per - 1) / D;
  for (int gi = g_lo + warp; gi <= g_hi; gi += kThreads / 32) {
    float mx = kNegInf;
    for (int c = lane; c < n_splits; c += 32) {
      const float m = __ldcg(&part[nd + e0 + c * G + gi]);
      w_s[c * G + gi] = m;
      lw_s[c * G + gi] = __ldcg(&part[nd + n_all + e0 + c * G + gi]);
      mx = fmaxf(mx, m);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    float sum = 0.f;
    for (int c = lane; c < n_splits; c += 32) {
      const float w = exp2f(w_s[c * G + gi] - mx);
      w_s[c * G + gi] = w;
      sum = fmaf(w, lw_s[c * G + gi], sum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    if (lane == 0) l_s[gi] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();

  float merged[R];
#pragma unroll
  for (int k = 0; k < R; ++k) merged[k] = 0.f;
  for (int c0 = 0; c0 < n_splits; c0 += kBatch) {
    if (c0 > 0) load_batch(c0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int gi = (f_lo + tid + kThreads * k) / D;
        const float w = c0 + j < n_splits ? w_s[(c0 + j) * G + gi] : 0.f;
        merged[k] = fmaf(w, x[j][k], merged[k]);
      }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int f = f_lo + tid + kThreads * k;
    if (tid + kThreads * k < per)
      out[o_base + (f / D) * o_sh + f % D] =
          from_float<T>(merged[k] / l_s[f / D]);
  }
}

// Partials of (batch x KV head) bh, split c, query head gi, at index
// e = (bh * n_splits + c) * G + gi: acc at part[e D], m at part[n D + e], l
// at part[n D + n + e], with n = bh_count * n_splits * G (acc first, so its
// rows stay 16-byte aligned).  m is in log2 units.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ counters,
                        int hkv, int valid_len, int n_splits, long long q_sb,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, long long o_sb, long long o_sh,
                        float scale_log2) {
  using S = DecodeShape<T, D, G>;
  constexpr int kE = S::kE, kLanes = S::kLanes, kOut = S::kOut;
  extern __shared__ uint4 kv_raw[];   // this round's K rows, then V rows
  __shared__ float p_s[kMaxRows][G];
  __shared__ float m_run[G], l_run[G], alpha[G];
  __shared__ float w_s[kMaxSplits * G], lw_s[kMaxSplits * G];
  __shared__ int piece_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / hkv, hi = bh % hkv;
  const int key_lo = (int)((long long)split * valid_len / n_splits);
  const int key_hi = (int)((long long)(split + 1) * valid_len / n_splits);
  const int rows_cap = min(S::kRows, key_hi - key_lo);
  T* k_s = reinterpret_cast<T*>(kv_raw);
  T* v_s = k_s + rows_cap * D;
  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;

  // This thread's slot (a row every kSlots) and its kE dims of a row:
  // 16-byte chunks part_lane, part_lane + kLanes, ... (a warp's loads of a
  // row are contiguous), and the same dims of q for every head.
  constexpr int kVec = S::kVec, kStride = kLanes * kVec;
  const int slot = tid / kLanes, part_lane = tid % kLanes;
  float qr[G][kE];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    load_floats<T, kE>(q + bi * q_sb + (hi * G + gi) * q_sh +
                           part_lane * kVec, kStride, qr[gi]);
  // The outputs this thread accumulates: flat (head, dim) f0 .. f0 + kOut.
  const int f0 = tid * kOut;
  const int g_out = f0 / D, d_out = f0 % D;
  const bool owns = f0 < G * D;
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  if (tid < G) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }

  for (int r0 = key_lo; r0 < key_hi; r0 += rows_cap) {
    const int n = min(rows_cap, key_hi - r0);
    constexpr int kChunks = S::kRowBytes / 16;
    __syncthreads();   // the previous round's readers are done
    for (int idx = tid; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(k_s + r * D + c * kVec, kb + (r0 + r) * k_ss + c * kVec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int idx = tid; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(v_s + r * D + c * kVec, vb + (r0 + r) * v_ss + c * kVec);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" :::
                     "memory");
    __syncthreads();   // K is in

    // Scores of this slot's rows, reduced over the kLanes lanes of a row.
    // The trips are uniform across a warp (the shuffles need every lane).
    for (int rs = 0; rs < n; rs += S::kSlots) {
      const int r = rs + slot;
      float kr[kE];
      if (r < n) {
        load_floats<T, kE>(k_s + r * D + part_lane * kVec, kStride, kr);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) kr[e] = 0.f;
      }
      float dot[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) x = fmaf(qr[gi][e], kr[e], x);
        dot[gi] = x;
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          dot[gi] += __shfl_xor_sync(~0u, dot[gi], o);
      if (r < n && part_lane == 0)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) p_s[r][gi] = dot[gi] * scale_log2;
    }
    __syncthreads();

    // Online softmax over the round, one warp per head.
    for (int gi = warp; gi < G; gi += kThreads / 32) {
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, p_s[r][gi]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
      const float m_new = fmaxf(m_run[gi], mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = exp2f(p_s[r][gi] - m_new);
        p_s[r][gi] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
      if (lane == 0) {
        const float a = exp2f(m_run[gi] - m_new);
        alpha[gi] = a;
        l_run[gi] = l_run[gi] * a + sum;
        m_run[gi] = m_new;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // the probabilities are in p_s and V is in

    // acc = acc alpha + P V for this thread's (head, dims).
    if (owns) {
      const float a = alpha[g_out];
#pragma unroll
      for (int i = 0; i < kOut; ++i) acc[i] *= a;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        float vr[kOut];
        load_floats<T, kOut>(v_s + r * D + d_out, kVec, vr);
        const float p = p_s[r][g_out];
#pragma unroll
        for (int i = 0; i < kOut; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
    }
  }

  // This block's partial, then a ticket.
  const int n_all = gridDim.y * n_splits * G;
  const long long nd = (long long)n_all * D;
  const int e_blk = (bh * n_splits + split) * G;
  if (tid < G) {
    part[nd + e_blk + tid] = m_run[tid];
    part[nd + n_all + e_blk + tid] = l_run[tid];
  }
  if (owns) {
    float* dst = part + (long long)(e_blk + g_out) * D + d_out;
    if constexpr (kOut % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kOut; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kOut; ++i) dst[i] = acc[i];
    }
  }
  const int mergers = n_splits >= kMergers ? kMergers : 1;
  __syncthreads();
  if (tid == 0) {
    __threadfence();   // the block's partial, published by the barrier
    const int ticket = atomicAdd(&counters[bh], 1);
    int piece = ticket - (n_splits - mergers);
    if (piece >= 0) {
      if (ticket != n_splits - 1) {   // wait for the last partial
        int seen;
        do {
          asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
                       : "=r"(seen)
                       : "l"(&counters[bh])
                       : "memory");
        } while (seen < n_splits);
      }
      __threadfence();
      if (atomicAdd(&counters[gridDim.y + bh], 1) == mergers - 1) {
        counters[bh] = 0;   // all mergers are past their wait
        counters[gridDim.y + bh] = 0;
      }
    }
    piece_s = piece;
  }
  __syncthreads();
  const int piece = piece_s;
  if (piece < 0) return;

  const int per = G * D / mergers;
  if (mergers == kMergers)
    merge_slice<T, D, G, (G * D / kMergers + kThreads - 1) / kThreads>(
        part, out, w_s, lw_s, l_run, n_splits, bh, n_all, piece * per, per,
        bi * o_sb + hi * G * o_sh, o_sh);
  else
    merge_slice<T, D, G, (G * D + kThreads - 1) / kThreads>(
        part, out, w_s, lw_s, l_run, n_splits, bh, n_all, 0, per,
        bi * o_sb + hi * G * o_sh, o_sh);
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, int* counters, int b, int hkv, int valid_len,
           int n_splits, const long long* st, float scale,
           cudaStream_t stream) {
  using S = DecodeShape<T, D, G>;
  if (n_splits < 1 || n_splits > kMaxSplits || n_splits > valid_len)
    return (int)cudaErrorInvalidValue;
  const int per_split = (valid_len + n_splits - 1) / n_splits;
  const int rows = per_split < S::kRows ? per_split : S::kRows;
  const size_t smem = size_t(2) * rows * S::kRowBytes;
  auto kernel = decode_attention_kernel<T, D, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_splits, b * hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part, counters, hkv,
      valid_len, n_splits, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(int g, const void* q, const void* k, const void* v, void* out,
             float* part, int* counters, int b, int hkv, int valid_len,
             int n_splits, const long long* st, float scale,
             cudaStream_t stream) {
  switch (g) {
#define REPRO_CASE(G)                                                      \
  case G:                                                                  \
    return launch<T, D, G>(q, k, v, out, part, counters, b, hkv,           \
                           valid_len, n_splits, st, scale, stream);
    REPRO_CASE(1)
    REPRO_CASE(2)
    REPRO_CASE(4)
    REPRO_CASE(8)
#undef REPRO_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dg(int d, int g, const void* q, const void* k, const void* v,
              void* out, float* part, int* counters, int b, int hkv,
              int valid_len, int n_splits, const long long* st, float scale,
              cudaStream_t stream) {
  switch (d) {
#define REPRO_CASE(D)                                                      \
  case D:                                                                  \
    return launch_g<T, D>(g, q, k, v, out, part, counters, b, hkv,         \
                          valid_len, n_splits, st, scale, stream);
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(128)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16; scale is 1 / sqrt(D) rounded to
// float32.  Strides in elements: q (batch, head), k and v (batch, position,
// head), out (batch, head); the head dim is contiguous, rows 16-byte
// aligned.  1 <= n_splits <= min(valid_len, 256); scratch holds
// b hkv n_splits g (d + 2) floats; counters 2 b hkv int32 zeros, left
// zero.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* scratch,
    void* counters, int dtype, int b, int hkv, int g, int d, int valid_len,
    int n_splits, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, float scale,
    void* stream) {
  const long long st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_sh};
  float* part = static_cast<float*>(scratch);
  int* count = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_dg<float>(d, g, q, k, v, out, part, count, b, hkv,
                                   valid_len, n_splits, st, scale, s);
  if (dtype == 1)
    return repro::launch_dg<__nv_bfloat16>(d, g, q, k, v, out, part, count,
                                           b, hkv, valid_len, n_splits, st,
                                           scale, s);
  return (int)cudaErrorInvalidValue;
}
