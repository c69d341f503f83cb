// flash_attention: causal / sliding-window grouped-query attention over a
// whole sequence (prefill), online softmax in float32.
//
// Replaces the Pallas TPU kernel _flash_kernel / flash_attention in
// src/repro/kernels/flash_attention.py.  out[b, h, i] = sum_j p_ij v[b, h/G, j]
// with p_i = softmax_j(q_i . k_j / sqrt(D)) over the keys j the mask keeps:
// j <= i (causal) and i - j < window (window > 0); G = Hq / Hkv query heads
// share one KV head.
//
// Layouts: q and out are (B, Hq, S, D), k and v (B, Hkv, S, D), as the JAX
// kernel takes them, but each is read through its own (batch, head,
// position) strides with the head dim contiguous, so the model hands in
// transposed views of its (B, S, H, D) projections without a copy.
//
// Bound on this card: operations.  At gemma3-1b's prefill (B = 4, Hq = 4,
// Hkv = 1, S = 2048, D = 256) the live (query, key) pairs need 4 D
// operations each, about 26 GFLOP (window 1024) or 34 GFLOP (global),
// against ~42 MB of q, k, v and out: far above the card's ~295 operations
// per byte, so bf16 tensor-core operations bound it (about 26 and 35 us
// at 989 TFLOP/s).
//
// Design (wgmma and TMA are later work):
// - One block per (batch x KV head, tile of 64 query rows).  A row is a
//   (position, query head) pair, numbered position-major (r = s G + g), so
//   a tile holds 64 / G consecutive positions of all G heads of the KV head
//   and each K/V tile is staged once for the G heads, as the TPU kernel
//   does.  The tile has 64 rows whatever G is.
// - The block walks only the KV tiles that the causal and window masks
//   leave live for its positions (the TPU kernel's `live` test), staging K
//   and V in shared memory; keys past S are zero-filled and masked, so S
//   needs no divisibility.  The output is written once, acc / l, in the
//   input's type.
// - bfloat16 inputs (the serve path) run on the tensor cores with
//   mma.sync m16n8k16 (bf16 x bf16 -> float32): 4 warps of 16 query rows,
//   KV tiles of 64 keys.  Q, K and V^T stay in shared memory as bf16 (rows
//   padded by 8 elements, so the fragments' 32-bit reads hit distinct
//   banks): ~102 KB at D = 256, two blocks per SM.  Scores, the online
//   softmax (m, l per row, reduced over the 4 lanes that share a row) and
//   the output accumulator (D / 8 fragments of 4 floats, 128 registers at
//   D = 256) live in registers; P goes from the score accumulator straight
//   into the A operand of P V, rounded to bf16 as the tensor cores take
//   it.  The wrapper requires 16-byte aligned rows (pointers and strides).
// - float32 inputs keep float32 arithmetic (no TF32) on the FMA units:
//   256 threads, each owning 4 rows x D/16 output dims (64 float32
//   registers at D = 256), KV tiles of 32 keys, Q, K, V and the 64 x 33
//   score tile in shared memory (~139 KB at D = 256, one block per SM;
//   rows of Q and K padded by 4 floats for the float4 reads), the online
//   softmax of a row one warp (a lane per key).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

constexpr int kRowsPerTile = 64;
constexpr int kKeysPerTile = 32;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (size_t(kRowsPerTile) * (D + 4) + size_t(kKeysPerTile) * (D + 4) +
          size_t(kKeysPerTile) * D + size_t(kRowsPerTile) * (kKeysPerTile + 1) +
          3 * kRowsPerTile);
}

// float32 inputs: FMA arithmetic.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int hkv, int g, int s_len, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int window,
                       float scale) {
  constexpr int kPad = D + 4;             // padded row of Q and K
  constexpr int kDims = D / 16;           // output dims per thread
  constexpr int kPStride = kKeysPerTile + 1;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kRowsPerTile * kPad;
  float* v_s = k_s + kKeysPerTile * kPad;
  float* p_s = v_s + kKeysPerTile * D;
  float* row_m = p_s + kRowsPerTile * kPStride;
  float* row_l = row_m + kRowsPerTile;
  float* row_a = row_l + kRowsPerTile;

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / hkv, hi = blockIdx.y % hkv;
  const int n_rows = s_len * g;
  const int r0 = blockIdx.x * kRowsPerTile;
  const float* qb = q + bi * qs.b;
  const float* kb = k + bi * ks.b + hi * ks.h;
  const float* vb = v + bi * vs.b + hi * vs.h;

  for (int idx = tid; idx < kRowsPerTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, row = r0 + r;
    float x = 0.f;
    if (row < n_rows) {
      const int pos = row / g, head = hi * g + row % g;
      x = qb[head * qs.h + pos * qs.s + d];
    }
    q_s[r * kPad + d] = x;
  }
  if (tid < kRowsPerTile) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // The live key range of this tile's positions [p_lo, p_hi].
  const int p_lo = r0 / g;
  const int p_hi = (min(r0 + kRowsPerTile, n_rows) - 1) / g;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_end = causal ? min(s_len, p_hi + 1) : s_len;

  const int rg = tid / 16, cg = tid % 16;  // 4 rows rg*4.., keys/dims by cg
  const int warp = tid / 32, lane = tid % 32;
  float acc[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;

  for (int k0 = (k_begin / kKeysPerTile) * kKeysPerTile; k0 < k_end;
       k0 += kKeysPerTile) {
    __syncthreads();  // the previous tile's readers are done; Q is staged
    for (int idx = tid; idx < kKeysPerTile * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < s_len) {
        kx = kb[key * ks.s + d];
        vx = vb[key * vs.s + d];
      }
      k_s[j * kPad + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    // Scores of rows rg*4 + i against keys cg and cg + 16.
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(rg * 4 + i) * kPad + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&k_s[(cg + 16 * j) * kPad + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = sc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          s = fmaf(qv[i].w, kv[j].w, s);
          sc[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = (r0 + rg * 4 + i) / g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + cg + 16 * j;
        const bool live = key < s_len && (!causal || key <= pos) &&
                          (window <= 0 || pos - key < window);
        p_s[(rg * 4 + i) * kPStride + cg + 16 * j] =
            live ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: warp w updates rows w*8 .. w*8+7, a lane per key.
    for (int rr = 0; rr < kRowsPerTile / (kThreads / 32); ++rr) {
      const int r = warp * (kRowsPerTile / (kThreads / 32)) + rr;
      const float s = p_s[r * kPStride + lane];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = s == kNegInf ? 0.f : expf(s - m_new);
      const float p_sum = warp_sum(p);
      p_s[r * kPStride + lane] = p;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        row_a[r] = a;
        row_l[r] = row_l[r] * a + p_sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * a + P V for rows rg*4 + i, dims cg + 16 c.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[rg * 4 + i];
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < kKeysPerTile; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(rg * 4 + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const float vx = v_s[j * D + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg * 4 + i;
    if (row >= n_rows) continue;
    const int pos = row / g, head = hi * g + row % g;
    const float l = fmaxf(row_l[rg * 4 + i], 1e-30f);
    float* orow = out + bi * os.b + head * os.h + pos * os.s;
#pragma unroll
    for (int c = 0; c < kDims; ++c) orow[cg + 16 * c] = acc[i][c] / l;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: the same tiles on the tensor cores (mma.sync m16n8k16,
// bf16 x bf16 -> float32).
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;              // 16 query rows per warp
constexpr int kMmaKeys = 64;              // keys per KV tile

template <int D>
constexpr size_t flash_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (size_t(kRowsPerTile) * (D + 8) + size_t(kMmaKeys) * (D + 8) +
          size_t(D) * (kMmaKeys + 8));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int hkv, int g,
                           int s_len, Strides qs, Strides ks, Strides vs,
                           Strides os, int causal, int window, float scale) {
  constexpr int kQP = D + 8, kKP = D + 8, kVP = kMmaKeys + 8;  // padded rows
  constexpr int kChunks = D / 8;          // 16-byte chunks of a row
  constexpr int kThreadsM = kMmaWarps * 32;
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* k_s = q_s + kRowsPerTile * kQP;
  __nv_bfloat16* vt_s = k_s + kMmaKeys * kKP;   // V transposed: [dim][key]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;     // mma fragment coordinates
  const int bi = blockIdx.y / hkv, hi = blockIdx.y % hkv;
  const int n_rows = s_len * g;
  const int r0 = blockIdx.x * kRowsPerTile;
  const __nv_bfloat16* qb = q + bi * qs.b;
  const __nv_bfloat16* kb = k + bi * ks.b + hi * ks.h;
  const __nv_bfloat16* vb = v + bi * vs.b + hi * vs.h;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  for (int idx = tid; idx < kRowsPerTile * kChunks; idx += kThreadsM) {
    const int r = idx / kChunks, c = idx % kChunks, row = r0 + r;
    uint4 x = zero4;
    if (row < n_rows) {
      const int pos = row / g, head = hi * g + row % g;
      x = *reinterpret_cast<const uint4*>(qb + head * qs.h + pos * qs.s +
                                          c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * kQP + c * 8) = x;
  }

  const int p_lo = r0 / g;
  const int p_hi = (min(r0 + kRowsPerTile, n_rows) - 1) / g;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_end = causal ? min(s_len, p_hi + 1) : s_len;

  // This thread's two rows of the warp's 16: grp and grp + 8.
  const int row_a = r0 + warp * 16 + grp, row_b = row_a + 8;
  const int pos_a = row_a / g, pos_b = row_b / g;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const __nv_bfloat16* qa = q_s + (warp * 16 + grp) * kQP + tig * 2;

  for (int k0 = (k_begin / kMmaKeys) * kMmaKeys; k0 < k_end;
       k0 += kMmaKeys) {
    __syncthreads();  // the previous tile's readers are done; Q is staged
    for (int idx = tid; idx < kMmaKeys * kChunks; idx += kThreadsM) {
      const int j = idx / kChunks, c = idx % kChunks, key = k0 + j;
      const uint4 x = key < s_len
          ? *reinterpret_cast<const uint4*>(kb + key * ks.s + c * 8) : zero4;
      *reinterpret_cast<uint4*>(k_s + j * kKP + c * 8) = x;
    }
    // V goes in transposed; consecutive threads take consecutive keys, so
    // the 2-byte stores of a warp land in distinct banks.
    for (int idx = tid; idx < kMmaKeys * kChunks; idx += kThreadsM) {
      const int j = idx % kMmaKeys, c = idx / kMmaKeys, key = k0 + j;
      uint4 x = key < s_len
          ? *reinterpret_cast<const uint4*>(vb + key * vs.s + c * 8) : zero4;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int t = 0; t < 8; ++t) vt_s[(c * 8 + t) * kVP + j] = e[t];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp.
    float sc[kMmaKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a0 = ld_pair(qa + kk * 16);
      const uint32_t a1 = ld_pair(qa + 8 * kQP + kk * 16);
      const uint32_t a2 = ld_pair(qa + kk * 16 + 8);
      const uint32_t a3 = ld_pair(qa + 8 * kQP + kk * 16 + 8);
#pragma unroll
      for (int n = 0; n < kMmaKeys / 8; ++n) {
        const __nv_bfloat16* kp = k_s + (n * 8 + grp) * kKP + kk * 16 + tig * 2;
        mma_bf16(sc[n], a0, a1, a2, a3, ld_pair(kp), ld_pair(kp + 8));
      }
    }

    // Mask, scale and the online softmax of rows a and b.
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + tig * 2 + (e & 1);
        const int pos = e < 2 ? pos_a : pos_b;
        const bool live = key < s_len && (!causal || key <= pos) &&
                          (window <= 0 || pos - key < window);
        sc[n][e] = live ? sc[n][e] * scale : kNegInf;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int lanes = 1; lanes < 4; lanes <<= 1) {  // the 4 threads of a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, lanes));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, lanes));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mref = e < 2 ? mn_a : mn_b;
        sc[n][e] = sc[n][e] == kNegInf ? 0.f : expf(sc[n][e] - mref);
      }
      sum_a += sc[n][0] + sc[n][1];
      sum_b += sc[n][2] + sc[n][3];
    }
    l_a = l_a * al_a + sum_a;   // this thread's columns; summed at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V: P's accumulator layout is the A operand's, in bf16.
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = vt_s + (n * 8 + grp) * kVP + kk * 16 + tig * 2;
        mma_bf16(o[n], a0, a1, a2, a3, ld_pair(vp), ld_pair(vp + 8));
      }
    }
  }

#pragma unroll
  for (int lanes = 1; lanes < 4; lanes <<= 1) {
    l_a += __shfl_xor_sync(~0u, l_a, lanes);
    l_b += __shfl_xor_sync(~0u, l_b, lanes);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  if (row_a < n_rows) {
    __nv_bfloat16* orow = out + bi * os.b + (hi * g + row_a % g) * os.h +
                          pos_a * os.s + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][0] / l_a, o[n][1] / l_a);
  }
  if (row_b < n_rows) {
    __nv_bfloat16* orow = out + bi * os.b + (hi * g + row_b % g) * os.h +
                          pos_b * os.s + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2] / l_b, o[n][3] / l_b);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hkv, int g, int s_len, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  const dim3 grid((s_len * g + kRowsPerTile - 1) / kRowsPerTile, b * hkv);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = flash_mma_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_attention_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_mma_kernel<D><<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), hkv, g, s_len, qs, ks,
        vs, os, causal, window, scale);
  } else {
    const size_t smem = flash_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), hkv, g, s_len, qs, ks,
        vs, os, causal, window, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int b, int hkv, int g, int s_len, Strides qs, Strides ks,
             Strides vs, Strides os, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (d) {
#define REPRO_CASE(DIM)                                                    \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, out, b, hkv, g, s_len, qs, ks, vs, os,  \
                          causal, window, scale, stream);
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
// float32.  Strides are in elements, (batch, head, position) for each of q,
// k, v and out; the head dim is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int b,
    int hkv, int g, int s_len, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  using repro::Strides;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_d<float>(d, q, k, v, out, b, hkv, g, s_len, qs, ks,
                                  vs, os, causal, window, scale, st);
  if (dtype == 1)
    return repro::launch_d<__nv_bfloat16>(d, q, k, v, out, b, hkv, g, s_len,
                                          qs, ks, vs, os, causal, window,
                                          scale, st);
  return (int)cudaErrorInvalidValue;
}
