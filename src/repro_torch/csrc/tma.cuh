// tma.cuh: TMA loads, mbarriers and the tile layout shared by B5's bf16
// kernels (the forward in flash_attention.cu, the backward in
// flash_attention_bwd.cu): the device side (mbarrier init / expect_tx /
// arrive / wait, boxes into shared memory, the wgmma descriptors of a tile
// of them) and the host side (the driver's tensor-map encoder, fetched at
// run time, and a map over a strided (batch, head, position, D) bf16
// view).
//
// A box is kCols = kBytes / 2 dims by `box_rows` positions of one head of
// one batch, written 128-byte swizzled (64-byte at D = 32); positions past
// the view's length come in as zeros.  The wgmma descriptors below read a
// tile of such boxes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // smem_u32, desc_field

namespace repro {

struct Strides {
  long long b, h, s;
};

// Which of a tensor map's dims 1-3 holds position, head and batch (the
// host orders them by stride).
struct TmaOrder {
  int s, h, b;
};

// A tile of D-wide bf16 rows as TMA writes it: D / kCols column blocks of
// `rows` rows of kBytes, swizzled, the block 1024-byte aligned; wgmma
// reads it through descriptors of layout type kLayout.
template <int D>
struct RowTile {
  static constexpr int kBytes = D >= 64 ? 128 : 64;  // bytes of a smem row
  static constexpr int kCols = kBytes / 2;            // bf16 per smem row
  static constexpr int kLayout = kBytes == 128 ? 1 : 2;
};

// K-major operand (rows x D, D contiguous): 8-row groups 8 rows apart.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  using T = RowTile<D>;
  return desc_field(addr) | (desc_field(16) << 16) |
         (desc_field(8 * T::kBytes) << 32) | ((uint64_t)T::kLayout << 62);
}
// MN-major B operand (K = the tile's rows, N = D, through the transpose
// bit): column blocks rows x kBytes apart, 8-row groups 8 rows apart.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int rows) {
  using T = RowTile<D>;
  return desc_field(addr) | (desc_field(rows * T::kBytes) << 16) |
         (desc_field(8 * T::kBytes) << 32) | ((uint64_t)T::kLayout << 62);
}
// Byte offset of the k-th 16-element step along D in a K-major tile of
// `rows` rows: 32 bytes within a swizzled row, then the next column block.
template <int D>
__device__ __forceinline__ uint32_t k_step(int kk, int rows) {
  constexpr int kBytes = RowTile<D>::kBytes, kPerRow = kBytes / 32;
  return (kk / kPerRow) * rows * kBytes + (kk % kPerRow) * 32;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The rows [pos, pos + box_rows) of head `head`, batch `batch` of a map
// encoded by encode_rows, D / kCols boxes side by side: column block c at
// dst + c * box_rows * kBytes.
template <int D>
__device__ __forceinline__ void tma_load_rows(uint8_t* dst,
                                              const CUtensorMap* map,
                                              TmaOrder o, uint64_t* bar,
                                              int pos, int head, int batch,
                                              int box_rows) {
  using T = RowTile<D>;
#pragma unroll
  for (int c = 0; c < D / T::kCols; ++c)
    tma_load(dst + c * box_rows * T::kBytes, map, bar, c * T::kCols,
             o.s == 0 ? pos : o.h == 0 ? head : batch,
             o.s == 1 ? pos : o.h == 1 ? head : batch,
             o.s == 2 ? pos : o.h == 2 ? head : batch);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime: no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d tensor map over a strided (batch, head, position, D) bf16 view:
// dim 0 is D, dims 1-3 the other three ordered by stride (a dim of extent
// 1 is never stepped, so it goes last); boxes of kCols x box_rows
// positions, swizzled as the kernels read them, zero-filled past s_len.
template <int D>
int encode_rows(CUtensorMap* map, TmaOrder* order, const void* base, int b,
                int heads, int s_len, Strides st, int box_rows) {
  using T = RowTile<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  struct Dim {
    cuuint64_t extent, stride;
    int which;  // 0 position, 1 head, 2 batch
  } dims[3] = {{(cuuint64_t)s_len, (cuuint64_t)st.s * 2, 0},
               {(cuuint64_t)heads, (cuuint64_t)st.h * 2, 1},
               {(cuuint64_t)b, (cuuint64_t)st.b * 2, 2}};
  cuuint64_t top = D * 2;
  for (const Dim& d : dims)
    if (d.extent > 1 && d.stride > top) top = d.stride;
  for (Dim& d : dims)
    if (d.extent == 1) d.stride = top;
  for (int i = 1; i < 3; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t extent[4] = {D, dims[0].extent, dims[1].extent, dims[2].extent};
  cuuint64_t stride[3] = {dims[0].stride, dims[1].stride, dims[2].stride};
  cuuint32_t box[4] = {T::kCols, 1, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (dims[i].which == 0) {
      order->s = i;
      box[1 + i] = (cuuint32_t)box_rows;
    } else if (dims[i].which == 1) {
      order->h = i;
    } else {
      order->b = i;
    }
  }
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      extent, stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace repro
