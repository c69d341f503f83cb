// flash_attention: causal / sliding-window grouped-query attention over a
// whole sequence (prefill), online softmax in float32.
//
// Replaces the Pallas TPU kernel _flash_kernel / flash_attention in
// src/repro/kernels/flash_attention.py.  out[b, h, i] = sum_j p_ij v[b, h/G, j]
// with p_i = softmax_j(q_i . k_j / sqrt(D)) over the keys j the mask keeps:
// j <= i (causal) and i - j < window (window > 0); G = Hq / Hkv query heads
// share one KV head.  The keys have a length of their own, Skv (the JAX
// kernel's kv_len): an encoder-decoder's cross-attention (non-causal)
// attends Sq target positions to Skv source positions.  With a soft cap c
// > 0 a logit x = q . k / sqrt(D) becomes c tanh(x / c) before the mask.
//
// Layouts: q and out are (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), as the
// JAX kernel takes them, but each is read through its own (batch, head,
// position) strides with the head dim contiguous, so the model hands in
// transposed views of its (B, S, H, D) projections without a copy.
//
// Beside out, both kernels write each row's log-sum-exp L = log sum_j
// exp(x_ij) of its masked, soft-capped logits to lse, float32 (B, Hq, Sq)
// contiguous, in natural-log units (the bf16 kernel keeps its max in log2
// units and stores ln 2 (m + log2 l)): the backward (flash_attention_bwd.cu)
// forms P from it instead of sweeping the keys a second time.  4 bytes a
// row, against 4 D bytes of q and out each.
//
// Bound on this card: operations.  At gemma3-1b's prefill (B = 4, Hq = 4,
// Hkv = 1, S = 2048, D = 256) the live (query, key) pairs need 4 D
// operations each, about 26 GFLOP (window 1024) or 34 GFLOP (global),
// against ~42 MB of q, k, v and out: far above the card's ~295 operations
// per byte, so bf16 tensor-core operations bound it (about 26 and 35 us
// at 989 TFLOP/s).  Only wgmma reaches that rate, so the bf16 kernel is
// built around it:
// - Rows.  A row is a (position, query head) pair, numbered position-major
//   (r = s G + g), so a tile holds consecutive positions of all G heads of
//   one KV head and each K/V tile is loaded once for the G heads.  A block
//   owns 128 rows of one (batch, KV head) and walks only the KV tiles of 64
//   keys that the causal and window masks leave live for them.
// - Warp specialisation.  A block is three warpgroups: one thread of the
//   first issues the TMA loads and the warpgroup gives its registers up
//   (setmaxnreg 40); the other two own 64 rows each and take 232 registers
//   a thread, room for the float32 O accumulator (128 registers at D = 256)
//   beside the scores.
// - K and V by TMA (cp.async.bulk.tensor) into 128-byte-swizzled shared
//   memory (64-byte at D = 32), in a ring of stages (2 at D = 256, 4
//   below) guarded by full and empty mbarriers, so the next tiles are in
//   flight while the tensor cores work on this one.  The tensor maps are
//   encoded per call on the host over the strided views (no copy; the
//   driver's encoder comes through cudaGetDriverEntryPoint, so nothing
//   links against libcuda), with the (batch, head, position) dims ordered
//   by stride.  Keys past Skv come in as TMA's zero fill and are masked.
// - Q is staged once per block with 16-byte loads, written in the same
//   swizzled layout (a tile's G heads form one TMA box only when G divides
//   64).
// - S = Q K^T by wgmma m64n64k16 with both operands in shared memory and
//   float32 accumulators; P stays in registers, rounded to bf16, and is the
//   register A operand of O += P V (wgmma m64nNk16, N = 64 or 32), V read
//   from shared memory through the descriptor's transpose bit: no
//   transpose by hand.
// - Online softmax in registers with exp2f, scale log2(e) folded into the
//   scale; the causal, window and ragged masks run only on the tiles that
//   straddle the diagonal, the window's edge or Skv.  The soft cap (off at
//   c = 0, a branch uniform over the launch) is one tanhf per score.  The
//   -1e30 sentinel, the max(l, 1e-30) clamp and IEEE division are kept (no
//   fast-math).
// - The heaviest query tiles (the last under the causal mask) launch
//   first, so the causal tail overlaps the light tiles.
// ~198 KB of shared memory at D = 256 (Q 2 x 32 KB, two stages of K + V at
// 64 KB): one block of 384 threads per SM.  The wrapper requires 16-byte
// aligned rows (pointers and strides), which TMA needs as well.
//
// float32 inputs keep float32 arithmetic (no TF32) on the FMA units: 256
// threads, each owning 4 rows x D/16 output dims (64 float32 registers at
// D = 256), KV tiles of 32 keys, Q, K, V and the 64 x 33 score tile in
// shared memory (~139 KB at D = 256, one block per SM; rows of Q and K
// padded by 4 floats for the float4 reads), the online softmax of a row
// one warp (a lane per key).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // wgmma, descriptors, bf16 packing
#include "tma.cuh"     // Strides, mbarriers, TMA loads, tensor maps

namespace repro {

constexpr int kRowsPerTile = 64;
constexpr int kKeysPerTile = 32;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

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
                       float* __restrict__ lse, int hkv, int g, int s_len,
                       int kv_len, Strides qs,
                       Strides ks, Strides vs, Strides os, int causal,
                       int window, float scale, float cap_pre,
                       float cap_post) {
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
  const int k_end = causal ? min(kv_len, p_hi + 1) : kv_len;

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
      if (key < kv_len) {
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
        const bool live = key < kv_len && (!causal || key <= pos) &&
                          (window <= 0 || pos - key < window);
        const float x = cap_post > 0.f ? cap_post * tanhf(sc[i][j] * cap_pre)
                                       : sc[i][j] * scale;
        p_s[(rg * 4 + i) * kPStride + cg + 16 * j] = live ? x : kNegInf;
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

  if (tid < kRowsPerTile && r0 + tid < n_rows) {
    const int row = r0 + tid, head = hi * g + row % g;
    const float l = row_l[tid];
    lse[((long long)bi * hkv * g + head) * s_len + row / g] =
        l > 0.f ? row_m[tid] + logf(l) : 0.f;
  }
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
// bfloat16 inputs: warp-specialised wgmma fed by TMA.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                   // query rows per consumer
constexpr int kConsumers = 2;                 // consumer warpgroups per block
constexpr int kBlockRows = kWgRows * kConsumers;
constexpr int kTileKeys = 64;                 // keys per K/V tile
constexpr int kWgmmaThreads = (1 + kConsumers) * 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the bf16 kernel at head dim D: Q per consumer, then the
// stages of (K, V), then the mbarriers; every tile 1024-byte aligned (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).
template <int D>
struct WgTile {
  static constexpr int kSwizzle = RowTile<D>::kBytes;   // bytes of a smem row
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kQBytes = kWgRows * D * 2;
  static constexpr int kKVBytes = kTileKeys * D * 2;    // one K or V tile
  static constexpr int kPvN = D >= 64 ? 64 : 32;        // N of one P V wgmma
  static constexpr size_t kSmem = 1024 + size_t(kConsumers) * kQBytes +
                                  size_t(2 * kStages) * kKVBytes + 64 * 3;
};

// Block i takes (batch x KV head) i % bh and query tile n_tiles - 1 - i / bh,
// the heaviest tiles first.  Threads 0-127 load; 128-255 and 256-383 each
// own 64 of the block's 128 rows.
template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             TmaOrder ko, TmaOrder vo, int hkv, int bh,
                             int n_tiles, int g, int s_len, int kv_len,
                             Strides qs, Strides os, int causal, int window,
                             float scale_log2, float cap_pre,
                             float cap_post) {
  using W = WgTile<D>;
  constexpr int kStages = W::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kv_s = smem + kConsumers * W::kQBytes;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(
      kv_s + 2 * kStages * W::kKVBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int bhi = blockIdx.x % bh;
  const int tile = n_tiles - 1 - blockIdx.x / bh;
  const int bi = bhi / hkv, hi = bhi % hkv;
  const int n_rows = s_len * g;
  const int r0 = tile * kBlockRows;
  const int p_lo = r0 / g;
  const int p_hi = (min(r0 + kBlockRows, n_rows) - 1) / g;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_end = causal ? min(kv_len, p_hi + 1) : kv_len;
  const int t_begin = k_begin / kTileKeys;
  const int t_end = (k_end + kTileKeys - 1) / kTileKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumers * 4);   // one arrival per warp
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
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        uint8_t* k_s = kv_s + stage * 2 * W::kKVBytes;
        uint8_t* v_s = k_s + W::kKVBytes;
        const int key = t * kTileKeys;
        mbar_expect_tx(&full_k[stage], W::kKVBytes);
        tma_load_rows<D>(k_s, &k_map, ko, &full_k[stage], key, hi, bi,
                         kTileKeys);
        mbar_expect_tx(&full_v[stage], W::kKVBytes);
        tma_load_rows<D>(v_s, &v_map, vo, &full_v[stage], key, hi, bi,
                         kTileKeys);
      }
    }
  } else {
    // --- consumers: 64 rows per warpgroup --------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int grp = lane / 4, tig = lane % 4;   // fragment coordinates
    const int wrow0 = r0 + wg * kWgRows;
    uint8_t* q_s = smem + wg * W::kQBytes;

    // Q once, 16 bytes a load, into the swizzled K-major layout TMA gives K.
    constexpr int kChunks = D / 8;                   // 16-byte chunks a row
    constexpr int kRowChunks = W::kSwizzle / 16;     // chunks a smem row
    const __nv_bfloat16* qb = q + bi * qs.b;
    for (int idx = tw; idx < kWgRows * kChunks; idx += 128) {
      const int r = idx / kChunks, c = idx % kChunks, row = wrow0 + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (row < n_rows) {
        const int pos = row / g, head = hi * g + row % g;
        x = *reinterpret_cast<const uint4*>(qb + head * qs.h + pos * qs.s +
                                            c * 8);
      }
      const int swz = ((r * W::kSwizzle) >> 7) & (kRowChunks - 1);
      *reinterpret_cast<uint4*>(q_s + (c / kRowChunks) * kWgRows *
                                          W::kSwizzle +
                                r * W::kSwizzle +
                                ((c % kRowChunks) ^ swz) * 16) = x;
    }
    // The generic-proxy stores must be visible to wgmma (async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    const int row_a = wrow0 + warp * 16 + grp, row_b = row_a + 8;
    const int pos_a = row_a / g, pos_b = row_b / g;
    const int wpos_lo = wrow0 / g, wpos_hi = (wrow0 + kWgRows - 1) / g;
    const uint32_t q_addr = smem_u32(q_s);
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    constexpr int kOBlocks = D / W::kPvN, kORegs = W::kPvN / 2;
    float o[kOBlocks][kORegs];
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
      for (int i = 0; i < kORegs; ++i) o[c][i] = 0.f;

    for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
      const int stage = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const uint32_t k_addr = smem_u32(kv_s + stage * 2 * W::kKVBytes);
      const uint32_t v_addr = k_addr + W::kKVBytes;

      // S = Q K^T: 64 rows x 64 keys, float32.
      float s[32];
      mbar_wait(&full_k[stage], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc<D>(q_addr + k_step<D>(kk, kWgRows)),
                     kmajor_desc<D>(k_addr + k_step<D>(kk, kTileKeys)),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Scale into log2 units (soft-capped: cap_post tanh(s cap_pre), with
      // cap_pre = scale / c and cap_post = c log2(e)); mask only where the
      // tile straddles the diagonal, the window's edge or Skv.  s[4j + e]:
      // key 8j + 2 tig + (e & 1), row a for e < 2, row b otherwise.
      const int k0 = t * kTileKeys;
      const bool edge = (causal && k0 + kTileKeys - 1 > wpos_lo) ||
                        (window > 0 && k0 <= wpos_hi - window) ||
                        k0 + kTileKeys > kv_len;
      if (cap_post > 0.f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = cap_post * tanhf(s[i] * cap_pre);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
      }
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i];
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
          const int pos = (i & 2) ? pos_b : pos_a;
          const bool live = key < kv_len && (!causal || key <= pos) &&
                            (window <= 0 || pos - key < window);
          x = live ? x : kNegInf;
        }
        s[i] = x;
        if (i & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
      }
#pragma unroll
      for (int lanes = 1; lanes < 4; lanes <<= 1) {  // the 4 threads of a row
        mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, lanes));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, lanes));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float mref = (i & 2) ? mn_b : mn_a;
        const float p = edge && s[i] == kNegInf ? 0.f : exp2f(s[i] - mref);
        s[i] = p;
        if (i & 2) sum_b += p; else sum_a += p;
      }
      l_a = l_a * al_a + sum_a;   // this thread's columns; summed at the end
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
        for (int i = 0; i < kORegs; ++i) o[c][i] *= (i & 2) ? al_b : al_a;

      // P as the register A operand, 16 keys per step: the score
      // accumulator's layout is the A fragment's.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V, V through the transpose bit.
      mbar_wait(&full_v[stage], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < kOBlocks; ++c) {
          const uint64_t dv = mnmajor_desc<D>(
              v_addr + c * kTileKeys * W::kSwizzle + kk * 16 * W::kSwizzle,
              kTileKeys);
          if constexpr (W::kPvN == 64)
            wgmma_rs_n64(o[c], pa[kk], dv);
          else
            wgmma_rs_n32(o[c], pa[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c) fence_regs(o[c]);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }

#pragma unroll
    for (int lanes = 1; lanes < 4; lanes <<= 1) {
      l_a += __shfl_xor_sync(~0u, l_a, lanes);
      l_b += __shfl_xor_sync(~0u, l_b, lanes);
    }
    // L = ln 2 (m + log2 l): the row's log-sum-exp of the natural-unit
    // logits, for the backward.
    if (tig == 0) {
      const long long lse0 = ((long long)bi * hkv + hi) * g;
      if (row_a < n_rows)
        lse[(lse0 + row_a % g) * s_len + pos_a] =
            l_a > 0.f ? (m_a + log2f(l_a)) * kLn2 : 0.f;
      if (row_b < n_rows)
        lse[(lse0 + row_b % g) * s_len + pos_b] =
            l_b > 0.f ? (m_b + log2f(l_b)) * kLn2 : 0.f;
    }
    l_a = fmaxf(l_a, 1e-30f);
    l_b = fmaxf(l_b, 1e-30f);
    // o[c][4j + e]: dim c kPvN + 8j + 2 tig + (e & 1), row a for e < 2.
    if (row_a < n_rows) {
      __nv_bfloat16* orow = out + bi * os.b + (hi * g + row_a % g) * os.h +
                            pos_a * os.s + tig * 2;
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
        for (int j = 0; j < kORegs / 4; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + c * W::kPvN + 8 * j) =
              __floats2bfloat162_rn(o[c][4 * j] / l_a, o[c][4 * j + 1] / l_a);
    }
    if (row_b < n_rows) {
      __nv_bfloat16* orow = out + bi * os.b + (hi * g + row_b % g) * os.h +
                            pos_b * os.s + tig * 2;
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
        for (int j = 0; j < kORegs / 4; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + c * W::kPvN + 8 * j) =
              __floats2bfloat162_rn(o[c][4 * j + 2] / l_b,
                                    o[c][4 * j + 3] / l_b);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int b, int hkv, int g, int s_len, int kv_len,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int window, float scale, float softcap, cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  TmaOrder ko, vo;
  int err = encode_rows<D>(&k_map, &ko, k, b, hkv, kv_len, ks, kTileKeys);
  if (err != 0) return err;
  err = encode_rows<D>(&v_map, &vo, v, b, hkv, kv_len, vs, kTileKeys);
  if (err != 0) return err;
  const size_t smem = WgTile<D>::kSmem;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_tiles = (s_len * g + kBlockRows - 1) / kBlockRows;
  flash_attention_wgmma_kernel<D><<<n_tiles * b * hkv, kWgmmaThreads, smem,
                                    stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
      lse, k_map, v_map, ko, vo, hkv, b * hkv, n_tiles, g, s_len, kv_len, qs,
      os, causal, window, scale * kLog2e, softcap > 0.f ? scale / softcap : 0.f,
      softcap * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int hkv, int g, int s_len, int kv_len,
           Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_wgmma<D>(q, k, v, out, lse, b, hkv, g, s_len, kv_len, qs,
                           ks, vs, os, causal, window, scale, softcap,
                           stream);
  } else {
    const dim3 grid((s_len * g + kRowsPerTile - 1) / kRowsPerTile, b * hkv);
    const size_t smem = flash_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, hkv, g, s_len,
        kv_len, qs, ks, vs, os, causal, window, scale,
        softcap > 0.f ? scale / softcap : 0.f, softcap);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int hkv, int g, int s_len, int kv_len,
             Strides qs, Strides ks, Strides vs, Strides os, int causal,
             int window, float scale, float softcap, cudaStream_t stream) {
  switch (d) {
#define REPRO_CASE(DIM)                                                    \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, out, lse, b, hkv, g, s_len, kv_len, qs, \
                          ks, vs, os, causal, window, scale, softcap, stream);
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
// float32; softcap > 0 caps the scaled logits (0: off).  s_len is Sq,
// kv_len Skv (equal under the causal mask).  Strides are in elements,
// (batch, head, position) for each of q, k, v and out; the head dim is
// contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype, int b, int hkv, int g, int s_len, int kv_len, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float scale, float softcap, void* stream) {
  using repro::Strides;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_d<float>(d, q, k, v, out, lse, b, hkv, g, s_len,
                                  kv_len, qs, ks, vs, os, causal, window,
                                  scale, softcap, st);
  if (dtype == 1)
    return repro::launch_d<__nv_bfloat16>(d, q, k, v, out, lse, b, hkv, g,
                                          s_len, kv_len, qs, ks, vs, os,
                                          causal, window, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}
