// LayerNorm / RMSNorm backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py::_bwd_kernel, the Pallas TPU kernel
// launched by _pallas_backward.  Same function: for dy [n, h], the saved
// tensor s [n, h] (x, or y when memory_efficient), mean [n], rstd [n] and
// an optional weight [h] and bias [h],
//   xhat = (x - mean) * rstd   (RMS: x * rstd; memory_efficient: (y - b) / w)
//   wdy  = dy * w              (dy without a weight)
//   c1 = sum(wdy) / h, c2 = sum(wdy * xhat) / h
//   dx = (wdy - c1 - xhat * c2) * rstd          (RMS: (wdy - xhat * c2) * rstd)
//   dw = sum over rows of dy * xhat, db = sum over rows of dy,
// in fp32, with dx cast to x's dtype and dw, db to the weight's and bias's
// dtypes.  x and dy are fp32, bf16 or fp16; weight and bias each fp32, bf16
// or fp16 independently of x (the O2 case: x bf16, weight fp32).
//
// Bound: bytes.  The kernel reads dy and s and writes dx, 3 n h elements
// (plus the stats and dw, db), at about 12 operations per element, far
// below the card's rate: at n 8192, h 2048 in bf16, 100.7 MB, 0.030 ms at
// the H100's 3.35 TB/s.
//
// Design for that bound.  One warp owns one row at a time and sweeps it
// twice in 16-byte vectors: the first sweep sums c1 and c2, the second
// (whose reads hit L1/L2, not device memory) writes dx.  The TPU kernel
// carried dw and db across its sequential grid; here blocks run in any
// order, so each warp adds its rows' dy * xhat and dy into its own fp32
// column sums in shared memory (its own, so no atomics), the block sums its
// warps in a fixed order into one partial row [2, h] per block, and a second
// launch sums the blocks' partials column by column, also in a fixed order:
// the result does not depend on scheduling.  The host picks the warps a
// block holds (so that the per-warp sums fit in shared memory with three
// blocks an SM) and the number of blocks (three an SM; each strides over
// the rows): at n 8192, h 2048 three blocks of 4 warps measured 12% faster
// than two, and blocks of 2 or 8 warps slower.  Without a weight there is nothing to sum and only dx is
// written.
//
// C interface (loaded with ctypes): apex_layer_norm_bwd returns
// cudaGetLastError() after its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kColWarps = 8;      // warps of the column pass, 32 columns a block

struct Args {
  const void* dy;
  const void* s;       // x, or y when memory_efficient
  const float* mean;
  const float* rstd;
  const void* w;
  const void* b;
  void* dx;
  void* dw;
  void* db;
  float* part;         // [blocks, 2, h]
  int64_t n;
  int h;
  bool rms, mem_eff;
  int warps, blocks;
  cudaStream_t stream;
};

// dy, xhat and w*dy of the VEC values of chunk c of one row
template <typename TX, typename TW, typename TB, int VEC>
__device__ __forceinline__ void chunk(const TX* dyr, const TX* sr, const TW* w, const TB* b,
                                      int c, float mean, float rstd, bool rms, bool mem_eff,
                                      bool has_w, bool has_b, float (&g)[VEC],
                                      float (&xh)[VEC], float (&wg)[VEC]) {
  load_f32<TX, VEC>(dyr + (int64_t)c * VEC, g);
  load_f32<TX, VEC>(sr + (int64_t)c * VEC, xh);
  float wv[VEC];
  if (has_w) {
    load_f32<TW, VEC>(w + (int64_t)c * VEC, wv);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) wv[i] = 1.f;
  }
  if (mem_eff) {
    // s is the output y: undo the affine step
    if (has_w) {
      if (has_b) {
        float bv[VEC];
        load_f32<TB, VEC>(b + (int64_t)c * VEC, bv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) xh[i] -= bv[i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) xh[i] /= wv[i];
    }
  } else if (rms) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) xh[i] *= rstd;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) xh[i] = (xh[i] - mean) * rstd;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) wg[i] = has_w ? g[i] * wv[i] : g[i];
}

template <typename TX, typename TW, typename TB, int VEC>
__global__ void __launch_bounds__(32 * kMaxWarps)
ln_bwd_rows(const TX* __restrict__ dy, const TX* __restrict__ s,
            const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
            const TW* __restrict__ w, const TB* __restrict__ b, TX* __restrict__ dx,
            float* __restrict__ part, int64_t n, int h, bool rms, bool mem_eff, bool has_w,
            bool has_b) {
  // [warps][2][h] when has_w; within a warp's [h], column c * VEC + i sits
  // at i * nvec + c, so the 32 lanes of a warp touch 32 banks
  extern __shared__ float acc[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = h / VEC;
  const float fh = (float)h;
  float* aw = acc + (size_t)warp * 2 * h;   // this warp's sums of dy * xhat
  float* ab = aw + h;                       // and of dy
  if (has_w)
    for (int c = lane; c < 2 * h; c += 32) aw[c] = 0.f;
  __syncwarp();

  for (int64_t row = (int64_t)blockIdx.x * warps + warp; row < n;
       row += (int64_t)gridDim.x * warps) {
    const TX* dyr = dy + row * h;
    const TX* sr = s + row * h;
    TX* dxr = dx + row * h;
    const float mean = rms ? 0.f : mean_in[row];
    const float rstd = rstd_in[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      float g[VEC], xh[VEC], wg[VEC];
      chunk<TX, TW, TB, VEC>(dyr, sr, w, b, c, mean, rstd, rms, mem_eff, has_w, has_b, g,
                             xh, wg);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1 += wg[i];
        s2 += wg[i] * xh[i];
      }
    }
    const float c1 = rms ? 0.f : warp_sum(s1) / fh;
    const float c2 = warp_sum(s2) / fh;
    for (int c = lane; c < nvec; c += 32) {
      float g[VEC], xh[VEC], wg[VEC], out[VEC];
      chunk<TX, TW, TB, VEC>(dyr, sr, w, b, c, mean, rstd, rms, mem_eff, has_w, has_b, g,
                             xh, wg);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = (rms ? wg[i] - xh[i] * c2 : wg[i] - c1 - xh[i] * c2) * rstd;
      store_f32<TX, VEC>(dxr + (int64_t)c * VEC, out);
      if (has_w) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          aw[i * nvec + c] += g[i] * xh[i];
          ab[i * nvec + c] += g[i];
        }
      }
    }
  }
  if (!has_w) return;
  __syncthreads();
  // this block's partial row: its warps' sums, in warp order
  float* pw = part + (size_t)blockIdx.x * 2 * h;
  for (int c = threadIdx.x; c < 2 * h; c += blockDim.x) {
    const int half = c >= h, col = c - half * h;
    const int at = half * h + (col % VEC) * nvec + col / VEC;
    float t = 0.f;
    for (int k = 0; k < warps; ++k) t += acc[(size_t)k * 2 * h + at];
    pw[c] = t;
  }
}

// the second pass: dw, db = the blocks' partial rows summed in block order;
// 32 columns a block, its warps take every kColWarps-th partial row
template <typename TW, typename TB>
__global__ void __launch_bounds__(32 * kColWarps)
ln_bwd_cols(const float* __restrict__ part, int blocks, int h, TW* __restrict__ dw,
            TB* __restrict__ db, bool has_b) {
  __shared__ float sw[kColWarps][32], sb[kColWarps][32];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float tw = 0.f, tb = 0.f;
  if (col < h) {
    for (int k = wy; k < blocks; k += kColWarps) {
      tw += part[(size_t)k * 2 * h + col];
      tb += part[(size_t)k * 2 * h + h + col];
    }
  }
  sw[wy][lane] = tw;
  sb[wy][lane] = tb;
  __syncthreads();
  if (wy == 0 && col < h) {
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int k = 0; k < kColWarps; ++k) {
      a += sw[k][lane];
      c += sb[k][lane];
    }
    dw[col] = from_f32<TW>(a);
    if (has_b) db[col] = from_f32<TB>(c);
  }
}

template <typename TX, typename TW, typename TB>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 16 / sizeof(TX);
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
  const bool vec = a.h % VEC == 0 && aligned(a.dy, 16) && aligned(a.s, 16) &&
                   aligned(a.dx, 16) && aligned(a.w, pack_align(sizeof(TW) * VEC)) &&
                   aligned(a.b, pack_align(sizeof(TB) * VEC));
  const size_t smem = has_w ? (size_t)a.warps * 2 * a.h * sizeof(float) : 0;
  const TX* dy = static_cast<const TX*>(a.dy);
  const TX* s = static_cast<const TX*>(a.s);
  const TW* w = static_cast<const TW*>(a.w);
  const TB* b = static_cast<const TB*>(a.b);
  TX* dx = static_cast<TX*>(a.dx);
  auto kernel = vec ? ln_bwd_rows<TX, TW, TB, VEC> : ln_bwd_rows<TX, TW, TB, 1>;
  // the attribute is per device: set it on every launch, for the current one
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.blocks, 32 * a.warps, smem, a.stream>>>(dy, s, a.mean, a.rstd, w, b, dx, a.part,
                                                     a.n, a.h, a.rms, a.mem_eff, has_w, has_b);
  err = cudaGetLastError();
  if (err != cudaSuccess || !has_w) return err;
  ln_bwd_cols<TW, TB><<<(a.h + 31) / 32, 32 * kColWarps, 0, a.stream>>>(
      a.part, a.blocks, a.h, static_cast<TW*>(a.dw), static_cast<TB*>(a.db), has_b);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t by_bias(int b_dtype, const Args& a) {
  switch (b_dtype) {
    case kF32: return launch<TX, TW, float>(a);
    case kBF16: return launch<TX, TW, __nv_bfloat16>(a);
    case kF16: return launch<TX, TW, __half>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t by_weight(int w_dtype, int b_dtype, const Args& a) {
  switch (w_dtype) {
    case kF32: return by_bias<TX, float>(b_dtype, a);
    case kBF16: return by_bias<TX, __nv_bfloat16>(b_dtype, a);
    case kF16: return by_bias<TX, __half>(b_dtype, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dy, s (x or y), dx: [n, h] contiguous, dtype x_dtype; mean, rstd: [n]
// fp32; w, b: [h] contiguous or null, each with its own dtype code (ignored
// when the pointer is null; a bias needs a weight); dw, db: [h] in the
// weight's and bias's dtypes (null without them); part: [blocks, 2, h] fp32
// scratch when there is a weight.  warps (1-8) rows at a time per block,
// blocks striding over the rows.  Dtype codes: 0 fp32, 1 bf16, 2 fp16.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int apex_layer_norm_bwd(const void* dy, const void* s, const void* mean,
                                   const void* rstd, const void* w, const void* b, void* dx,
                                   void* dw, void* db, void* part, long long n, int h, int rms,
                                   int mem_eff, int x_dtype, int w_dtype, int b_dtype,
                                   int warps, int blocks, void* stream) {
  if (n < 1 || h < 1 || warps < 1 || warps > kMaxWarps || blocks < 1) return cudaErrorInvalidValue;
  if (b != nullptr && w == nullptr) return cudaErrorInvalidValue;
  if (w != nullptr && (dw == nullptr || part == nullptr || (b != nullptr && db == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{dy, s, static_cast<const float*>(mean), static_cast<const float*>(rstd), w, b, dx,
               dw, db, static_cast<float*>(part), (int64_t)n, h, rms != 0, mem_eff != 0, warps,
               blocks, static_cast<cudaStream_t>(stream)};
  if (w == nullptr) w_dtype = x_dtype;
  if (b == nullptr) b_dtype = x_dtype;
  cudaError_t err;
  switch (x_dtype) {
    case kF32: err = by_weight<float>(w_dtype, b_dtype, a); break;
    case kBF16: err = by_weight<__nv_bfloat16>(w_dtype, b_dtype, a); break;
    case kF16: err = by_weight<__half>(w_dtype, b_dtype, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
