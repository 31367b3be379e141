// One Hopper (sm_90a) GEMM mainloop: TMA loads into a ring of 128-byte-
// swizzled shared-memory stages, completion on mbarriers, wgmma from shared
// memory into fp32 registers, the output tile handed to an epilogue functor.
// The fused LM-head backward runs its three products through it (the logits
// H E^T with dlog as their epilogue, dH = dlog E, dE = dlog^T H), and the
// forward its logits H E^T, whose epilogue reduces each row of the tile to
// a (max, sum of exp, target) triple and stores no tile (kStores false).
//
// A block computes one 128 x 256 tile of C[M, N] = sum_k A[m, k] B[k, n] in
// 16-bit operands (bf16 or fp16) with fp32 accumulation, k in steps of 64:
// - warpgroup 0 is the producer: after giving up registers (setmaxnreg) one
//   thread keeps kGemmStages stages of TMA loads in flight, each stage's
//   `full` barrier expecting the whole boxes' bytes (TMA counts a box that
//   runs past the tensor's edge in full and fills that part with zeros, so
//   ragged M, N and K need no masks);
// - warpgroups 1 and 2 each own 64 rows of the tile: for every stage, four
//   wgmma.mma_async m64n256k16 (k 16 each) into 128 fp32 registers a
//   thread, one commit group a stage, at most two groups in flight; a
//   stage goes back to the producer (its `empty` barrier, one arrive per
//   warpgroup) once the group that read it has completed; after the last
//   stage the ring holds the output tile, so a storing epilogue writes
//   whole rows in 16-byte pieces (a warp's stores straight from the wgmma
//   fragments would each write 16 bytes into 8 rows).
// Each output tile is owned by one block: no split-K, no atomics, so a call
// gives the same bits every time.  Blocks walk the tiles in bands of
// kGemmGroupM tile rows so that the blocks resident at once share their A
// rows and B columns in L2.
//
// Operand layouts.  Each operand is a row-major 16-bit matrix in device
// memory, read in boxes 64 elements (128 bytes) wide, which is the span of
// the 128-byte swizzle:
// - K-major (the row runs along k): one box [rows, 64] a stage; the wgmma
//   descriptor steps 32 bytes along the swizzled row for each k16 and
//   strides 1024 bytes from one 8-row group to the next (SBO);
// - MN-major (the row runs along m or n): boxes [64 k, 64] side by side
//   along m or n, 8 KB apart; the descriptor steps 2048 bytes (16 k rows)
//   for each k16, strides 1024 bytes between 8-k-row groups (SBO) and 8 KB
//   between 64-wide groups along m or n (LBO), and the wgmma transpose bit
//   of that operand is set.  So no operand is ever copied transposed.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint: no library beyond the CUDA runtime is
// linked.  Each map is a __grid_constant__ kernel parameter, so a CUDA
// graph captures it by value with the buffers it describes.
//
// Included by the .cu sources; _build.py hashes every .cuh here into each
// library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda.h>   // CUtensorMap and the encoder's argument types only
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kGemmBM = 128;                 // tile rows: two consumer warpgroups of 64
constexpr int kGemmBN = 256;                 // tile columns: one m64n256k16 a k16 step
constexpr int kGemmBK = 64;                  // k a stage: 64 16-bit values, 128 bytes
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 384;            // producer warpgroup + two consumers
constexpr int kGemmGroupM = 16;              // tile rows a raster band
constexpr int kGemmABytes = kGemmBM * kGemmBK * 2;
constexpr int kGemmBBytes = kGemmBN * kGemmBK * 2;
constexpr int kGemmStageBytes = kGemmABytes + kGemmBBytes;
constexpr int kGemmBox = 64 * kGemmBK * 2;   // one [64, 64] box: 8 KB
// the output tile's row pitch in the ring (elements): 528 bytes, so the
// accumulator pairs of a warp land in 32 different banks
constexpr int kGemmTileLd = kGemmBN + 8;
// stages on a 1024-byte boundary (the swizzle's period), then the barriers
constexpr size_t kGemmSmem = 1024 + kGemmStages * kGemmStageBytes + 2 * kGemmStages * 8;

// ---------------------------------------------------------------------------
// device primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA traffic on the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait for the phase of parity `parity` to complete; a phase still open
// after 2^32 clocks (~2 s) traps, so a fault in the ring fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 32)) __trap();
}

// box at coordinates (c0 along the row, c1 across rows) -> shared `dst`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// `addr` (its tile on a 1024-byte boundary); offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across it
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64, 256] += A[64, 16] B[16, 256]; the operand list is written out in
// full, as inline asm needs it
#define APEX_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define APEX_WGMMA_M64N256K16(TY)                                                          \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "    \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "    \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
      "%124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"                       \
      : APEX_F8(0), APEX_F8(8), APEX_F8(16), APEX_F8(24), APEX_F8(32), APEX_F8(40),         \
        APEX_F8(48), APEX_F8(56), APEX_F8(64), APEX_F8(72), APEX_F8(80), APEX_F8(88),       \
        APEX_F8(96), APEX_F8(104), APEX_F8(112), APEX_F8(120)                               \
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB))

template <typename T, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    APEX_WGMMA_M64N256K16("bf16");
  } else {
    APEX_WGMMA_M64N256K16("f16");
  }
}
#undef APEX_WGMMA_M64N256K16
#undef APEX_F8

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// C[M, N] = A[M, K] B[K, N] tile by tile.  A is read K-major (kAMN false:
// A[m, k] at row m, column k of map_a's matrix) or MN-major (kAMN: row k,
// column m); B K-major (kBMN false: row n, column k) or MN-major (kBMN: row
// k, column n).  Each consumer thread hands its 128 accumulators to the
// Epilogue's stage() with the first row of its warpgroup's 64, the tile's
// first column and the thread's index in the warpgroup: element i lies at
// row 16 (tid / 32) + (tid % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (tid % 4) + i % 2.  An Epilogue with kStores true writes the tile to C
// [rows, cols] (its `out`, `rows` and `cols`; cols a multiple of 8, the row
// pitch): stage() also gets the warpgroup's 64 rows of the staged tile in
// shared memory, where it writes each value in the output type, and the
// kernel then stores the tile's rows and columns inside C in 16-byte
// pieces.  One with kStores false reduces the tile in registers itself
// (the head forward's PartialsStore): no barrier, no staging, no store.
template <typename T, bool kAMN, bool kBMN, class Epilogue>
__global__ void __launch_bounds__(kGemmThreads, 1)
wgmma_gemm(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
           const int tiles_m, const int tiles_n, const int nk, const Epilogue epi) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t bars = base + kGemmStages * kGemmStageBytes;   // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kGemmStages + s); };

  const int band = kGemmGroupM * tiles_n;
  const int first = blockIdx.x / band * kGemmGroupM;
  const int rows = min(tiles_m - first, kGemmGroupM);
  const int m0 = (first + blockIdx.x % band % rows) * kGemmBM;
  const int n0 = blockIdx.x % band / rows * kGemmBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int it = 0; it < nk; ++it) {
        if (it >= kGemmStages) mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), kGemmStageBytes);
        const uint32_t a = base + s * kGemmStageBytes, b = a + kGemmABytes;
        const int k0 = it * kGemmBK;
        if (kAMN) {
          tma_load_2d(a, &map_a, m0, k0, full(s));
          tma_load_2d(a + kGemmBox, &map_a, m0 + 64, k0, full(s));
        } else {
          tma_load_2d(a, &map_a, k0, m0, full(s));
        }
        if (kBMN) {
#pragma unroll
          for (int j = 0; j < kGemmBN / 64; ++j)
            tma_load_2d(b + j * kGemmBox, &map_b, n0 + 64 * j, k0, full(s));
        } else {
          tma_load_2d(b, &map_b, k0, n0, full(s));
        }
        if (++s == kGemmStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;            // this warpgroup's 64 rows: A's box or rows 64c..
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0; it < nk; ++it) {
      mbar_wait(full(s), phase);
      const uint32_t a = base + s * kGemmStageBytes + c * kGemmBox;
      const uint32_t b = base + s * kGemmStageBytes + kGemmABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk) {
        const uint64_t da = kAMN ? smem_desc(a + kk * 2048, kGemmBox, 1024)
                                 : smem_desc(a + kk * 32, 16, 1024);
        const uint64_t db = kBMN ? smem_desc(b + kk * 2048, kGemmBox, 1024)
                                 : smem_desc(b + kk * 32, 16, 1024);
        wgmma_m64n256k16<T, kAMN, kBMN>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      // the previous stage's group has completed: hand its stage back
      if (it > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty(s == 0 ? kGemmStages - 1 : s - 1));
      if (++s == kGemmStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if constexpr (Epilogue::kStores) {
      // both consumer warpgroups are past their last wgmma and every load
      // has landed: the ring holds the output tile now, rows kGemmTileLd
      // apart
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      T* tile = reinterpret_cast<T*>(gemm_smem + (base - smem_u32(gemm_smem)));
      epi.stage(acc, static_cast<int64_t>(m0) + 64 * c, n0, threadIdx.x % 128,
                tile + 64 * c * kGemmTileLd);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      // then to C in 16-byte pieces, a warp to 512 bytes of a row
      for (int i = threadIdx.x - 128; i < kGemmBM * kGemmBN / 8; i += 256) {
        const int r = i / (kGemmBN / 8), q = 8 * (i % (kGemmBN / 8));
        const int64_t row = m0 + r;
        if (row < epi.rows && n0 + q < epi.cols)
          *reinterpret_cast<uint4*>(epi.out + row * epi.cols + n0 + q) =
              *reinterpret_cast<const uint4*>(tile + r * kGemmTileLd + q);
      }
    } else {
      // an epilogue that reduces the tile in registers: C is never written
      epi.stage(acc, static_cast<int64_t>(m0) + 64 * c, n0, threadIdx.x % 128);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// a map of the row-major [rows, cols] matrix at `base` (16-bit T, rows
// `cols` elements apart), read in boxes of [box_rows, 64] with the 128-byte
// swizzle; a box past the edge reads zeros.  False if the encoder refuses
// it.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(T)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// launch wgmma_gemm over C[M, N] with K = `depth`; map_a's boxes are
// [128, 64] (K-major) or [64, 64] (MN-major), map_b's [256, 64] or [64, 64]
template <typename T, bool kAMN, bool kBMN, class Epilogue>
cudaError_t launch_wgmma_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b, int64_t M,
                              int64_t N, int64_t depth, const Epilogue& epi,
                              cudaStream_t stream) {
  const auto kernel = wgmma_gemm<T, kAMN, kBMN, Epilogue>;
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kGemmSmem));
  if (err != cudaSuccess) return err;
  const int64_t tiles_m = (M + kGemmBM - 1) / kGemmBM, tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int64_t nk = (depth + kGemmBK - 1) / kGemmBK;
  if (tiles_m * tiles_n > 0x7fffffffLL || nk > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles_m * tiles_n), kGemmThreads, kGemmSmem, stream>>>(
      map_a, map_b, static_cast<int>(tiles_m), static_cast<int>(tiles_n), static_cast<int>(nk),
      epi);
  return cudaGetLastError();
}

}  // namespace
