// The Hopper (sm_90a) pieces of the flash attention kernels: rank-4 TMA
// loads of [b, heads, s, d] operands, wgmma shared-memory descriptors for
// a 64- or 128-byte swizzle, and the warpgroup products of an attention
// tile, m64n64k16 with both operands in shared memory (SS) and m64nNk16
// (N = 32, 64, 128) with A in registers (RS) and B read MN-major.
//
// Tiles.  A [rows, d] tile of a 16-bit operand lands in shared memory as
// boxes of [rows, kRowBytes / 2] side by side along d, each box's rows
// kRowBytes apart and swizzled over that span: d = 64 and 128 take the
// 128-byte swizzle (one or two boxes), d = 32 the 64-byte swizzle (one box
// of 64-byte rows).  The same bytes serve both ways a tile is read:
// - K-major (the product's depth runs along d: s = q k^T and the like): a
//   k16 step moves 32 bytes along the row, into the next box every
//   kRowBytes; SBO = 8 rows (the swizzle's period) between 8-row groups;
// - MN-major (the depth runs along the rows: dq = ds k, dk = ds^T q, dv =
//   p^T do): a k16 step moves 16 rows; SBO = 8 rows between 8-row groups
//   of the depth, LBO = one box between the boxes along d; the wgmma
//   transpose bit of B is set, so no operand is copied transposed.
// The A operand of an RS product is the accumulator of an earlier one,
// packed in pairs to 16 bits: the m64nNk16 accumulator's layout (warp w
// holds rows 16 w + lane / 4 and 8 more, columns 8 i + 2 (lane % 4) and
// the next) is the m16n8k16 A fragment's, k16 step by k16 step.
//
// The kernels' block: two warpgroups of 64 rows each read the tiles one
// warp streams through a ring of full/empty mbarriers (FlashRing): a
// producer warp of its own in the backward, the first warp of the first
// warpgroup in the forward.
//
// Included by flash_attention_fwd.cu (the forward: s = q k^T by SS, o +=
// p v by RS with v read MN-major), flash_attention_bwd.cu (dq, and dk
// with dv) and, through pair_bias.cuh, pair_bias_attention_fwd.cu and
// pair_bias_attention_bwd.cu (the same products, with the bias tile as a
// third streamed operand); _build.py hashes every .cuh here into each
// library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda.h>   // CUtensorMap and the encoder's argument types only
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_sm90.cuh"

namespace {

// the shared-memory geometry of a [rows, D] tile
template <int D>
struct FlashTile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;   // a box's row: the swizzle span
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = D / kBoxCols;            // boxes side by side along d
  // the descriptor's swizzle field: 1 = 128-byte, 2 = 64-byte
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr int bytes(int rows) { return rows * D * 2; }
};

// box at coordinates (d, row, head, batch) of a rank-4 map -> shared `dst`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// the rows [row0, row0 + rows) of a (b, head) slice, all of d, as
// FlashTile<D>::kBoxes boxes at `dst`; `box_rows` is the map's box height
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, int row0,
                                              int head, int batch, int box_rows, uint32_t bar) {
#pragma unroll
  for (int i = 0; i < FlashTile<D>::kBoxes; ++i)
    tma_load_4d(dst + i * box_rows * FlashTile<D>::kRowBytes, map, i * FlashTile<D>::kBoxCols,
                row0, head, batch, bar);
}

template <int D>
__device__ __forceinline__ uint64_t flash_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (FlashTile<D>::kSwizzle << 62);
}

// k16 step `kk` of a K-major tile at `tile` (boxes of `box_rows` rows),
// from row `row0` (a multiple of 8) on
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int box_rows, int row0, int kk) {
  constexpr int RB = FlashTile<D>::kRowBytes;
  const uint32_t addr = tile + (kk * 32 / RB) * box_rows * RB + row0 * RB + (kk * 32) % RB;
  return flash_desc<D>(addr, 16, 8 * RB);
}

// k16 step `kk` (rows 16 kk ...) of an MN-major tile at `tile` whose boxes
// hold `box_rows` rows
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int box_rows, int kk) {
  constexpr int RB = FlashTile<D>::kRowBytes;
  return flash_desc<D>(tile + kk * 16 * RB, box_rows * RB, 8 * RB);
}

// The barriers of a block's ring of S streamed stages: `once` (the tiles
// loaded once), then full[S] and empty[S].  `once` completes on one
// arrival and its bytes; `full` on the loading warp's 32 lanes (lane 0's
// with the stage's bytes: the other lanes store the stage's vectors
// before they arrive) and `empty` on `releases` arrivals: by default one
// from each of the two warpgroups that read the stage.
template <int S>
struct FlashRing {
  static constexpr int kBytes = (1 + 2 * S) * 8;
  uint32_t bars;
  __device__ uint32_t once() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + S + s); }
};

template <int S>
__device__ __forceinline__ void init_ring(const FlashRing<S>& r, uint32_t releases = 2) {
  if (threadIdx.x == 0) {
    mbar_init(r.once(), 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(r.full(s), 32);
      mbar_init(r.empty(s), releases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// keeps the compiler from moving accumulator reads or writes across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// two fp32 values as one register of two 16-bit T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

#define FLASH_F8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64, 64] (+)= A[64, 16] B[16, 64], both from shared memory, both
// K-major; d is overwritten when `accumulate` is 0
#define FLASH_SS_M64N64K16(TY)                                                               \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, " \
      "0, 0;\n}\n"                                                                           \
      : FLASH_F8(0), FLASH_F8(8), FLASH_F8(16), FLASH_F8(24)                                  \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    FLASH_SS_M64N64K16("bf16");
  } else {
    FLASH_SS_M64N64K16("f16");
  }
}

// d[64, N] += A[64, 16] B[16, N], A from registers (a[4], the m16n8k16 A
// fragment of each warp's 16 rows), B from shared memory, MN-major
#define FLASH_RS_N32(TY)                                                                      \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "               \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                           \
      : FLASH_F8(0), FLASH_F8(8)                                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define FLASH_RS_N64(TY)                                                                      \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                    \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                           \
      : FLASH_F8(0), FLASH_F8(8), FLASH_F8(16), FLASH_F8(24)                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define FLASH_RS_N128(TY)                                                                     \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                               \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                           \
      : FLASH_F8(0), FLASH_F8(8), FLASH_F8(16), FLASH_F8(24), FLASH_F8(32), FLASH_F8(40),     \
        FLASH_F8(48), FLASH_F8(56)                                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  constexpr bool bf = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (N == 32) {
    if constexpr (bf) { FLASH_RS_N32("bf16"); } else { FLASH_RS_N32("f16"); }
  } else if constexpr (N == 64) {
    if constexpr (bf) { FLASH_RS_N64("bf16"); } else { FLASH_RS_N64("f16"); }
  } else {
    static_assert(N == 128, "m64nNk16 with N = 32, 64 or 128");
    if constexpr (bf) { FLASH_RS_N128("bf16"); } else { FLASH_RS_N128("f16"); }
  }
}
#undef FLASH_SS_M64N64K16
#undef FLASH_RS_N32
#undef FLASH_RS_N64
#undef FLASH_RS_N128
#undef FLASH_F8

// k16 step `kc` of a [64, 64] accumulator (columns 16 kc ... 16 kc + 15),
// rounded to T, as the A fragment of an RS product
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[32], int kc) {
  a[0] = pack2<T>(x[8 * kc + 0], x[8 * kc + 1]);
  a[1] = pack2<T>(x[8 * kc + 2], x[8 * kc + 3]);
  a[2] = pack2<T>(x[8 * kc + 4], x[8 * kc + 5]);
  a[3] = pack2<T>(x[8 * kc + 6], x[8 * kc + 7]);
}

// the same for x * keep_scale where bit i of `kept` is set, else 0
template <typename T>
__device__ __forceinline__ void acc_to_a_kept(uint32_t (&a)[4], const float (&x)[32], int kc,
                                              uint32_t kept, float keep_scale) {
  float y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = (kept >> (8 * kc + i)) & 1 ? x[8 * kc + i] * keep_scale : 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack2<T>(y[2 * r], y[2 * r + 1]);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A rank-4 map of a [b, heads, s, d] 16-bit operand at `base` from its
// geometry, 12 values as ops/flash_attention.py's _tma_geometry gives
// them: dims (d, s, heads, b), byte strides of s, heads and b, box (d
// columns, rows, 1, 1), and the swizzle span in bytes.  False if the
// geometry is not the one the kernel's tiles read (box of kBoxCols by
// `box_rows`, swizzle kRowBytes) or the encoder refuses it.
template <typename T, int D>
bool flash_tensor_map(CUtensorMap* map, const void* base, const long long* g, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || g == nullptr) return false;
  if (g[0] != D || g[7] != FlashTile<D>::kBoxCols || g[8] != box_rows || g[9] != 1 ||
      g[10] != 1 || g[11] != FlashTile<D>::kRowBytes)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2],
                              (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5], (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8], 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                FlashTile<D>::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
