// Scaled softmax backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/softmax.py::_bwd_kernel, the Pallas TPU kernel
// launched by _pallas_backward.  Same function: for the forward's output y
// and the upstream gradient dy, both [rows, sk] of one dtype,
//   dx = scale * y * (dy - sum_j y_j dy_j)
// in fp32 over each row, stored in dy's dtype.  Masked elements have y == 0
// (a fully masked row is all zeros), so their gradient is exactly 0, as in
// the CUDA original.  fp32, bf16 or fp16; any sk from 1 up to the wrapper's
// maximum.
//
// Causal input.  When the forward was causal (row r of sq sees columns up
// to r + (sk - sq)), every y past a row's edge holds one value, the fill's
// share of the row, and the forward writes it as 0 unless every valid
// score lay within about 104 of the fill.  The kernel reads that value
// once (y at the first column past the edge); when it is 0, the row's
// gradient past the edge is 0 and its terms of the inner product are 0, so
// neither y nor dy is read there and dx is written as zeros.  Otherwise
// the row is read in full.  This is the formula above for every finite
// dy; a non-finite dy past the edge, which the formula would spread over
// the row, gives 0 there (the exact gradient: those inputs do not reach y).
//
// Bound: bytes.  Reads y and dy and writes dx, with about 5 operations an
// element.  At GPT-2-large's attention (bf16 [8, 20, 1024, 1024], causal)
// y's and dy's causal triangles (167.9 MB each) and one y a row are read
// and all of dx (335.5 MB) written: 671.4 MB, 0.200 ms at 3.35 TB/s.  (A
// backward that reads y and dy in full moves 1.007 GB, 0.300 ms.)
//
// Design for that bound: each needed byte read once and every byte written
// once.  One warp owns one row, four rows a block; y and dy of a row of up
// to 1024 fp32 values (32 a lane, each) stay in registers, loaded in
// 16-byte vectors; the row's inner product is a warp shuffle sum in fp32,
// and a last pass over the registers writes dx.  Under the causal triangle
// a vector wholly past the edge is neither read nor computed.  Longer rows
// loop: one read of y and dy for the inner product, a second that writes
// dx.  A row length that is not a multiple of the vector (or an unaligned
// pointer) takes scalar accesses.
//
// C interface (loaded with ctypes): apex_scaled_softmax_bwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // rows a block
constexpr int kRegFloats = 32;     // fp32 values of y (and of dy) a lane keeps

struct Args {
  const void* y;
  const void* dy;
  void* dx;
  int64_t rows;          // b * h * sq
  int sq, sk;
  float scale;
  bool causal;
  cudaStream_t stream;
};

// One warp per row.  KV > 0: y and dy in registers, KV vectors of VEC
// values a lane each (sk <= 32 * KV * VEC); KV == 0: the looping variant.
template <typename T, int VEC, int KV>
__global__ void __launch_bounds__(32 * kWarps)
softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy, T* __restrict__ dx,
                   int64_t rows, int sq, int sk, float scale, bool causal) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                       // whole warps leave together
  const T* yr = y + row * sk;
  const T* dyr = dy + row * sk;
  T* dxr = dx + row * sk;
  const int nvec = sk / VEC;
  // columns [0, limit) are read: all of them, or those up to the causal
  // edge when y past it is 0
  int limit = sk;
  if (causal) {
    const int64_t last = (int64_t)(row % sq) + (sk - sq);   // the last visible column
    limit = last < 0 ? 0 : (last + 1 < sk ? (int)(last + 1) : sk);
    if (limit < sk && to_f32(yr[limit]) != 0.f) limit = sk;
  }
  const int nread = min(nvec, (limit + VEC - 1) / VEC);     // vectors read

  if constexpr (KV > 0) {
    float yv[KV][VEC], gv[KV][VEC];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int c = lane + 32 * k;
      if (c < nread) {
        load_f32<T, VEC>(yr + c * VEC, yv[k]);
        load_f32<T, VEC>(dyr + c * VEC, gv[k]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot += yv[k][i] * gv[k][i];
      }
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) {
        float out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          out[i] = c < nread ? scale * yv[k][i] * (gv[k][i] - dot) : 0.f;
        store_f32<T, VEC>(dxr + c * VEC, out);
      }
    }
  } else {
    float dot = 0.f;
    for (int c = lane; c < nread; c += 32) {
      float yv[VEC], gv[VEC];
      load_f32<T, VEC>(yr + c * VEC, yv);
      load_f32<T, VEC>(dyr + c * VEC, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot += yv[i] * gv[i];
    }
    dot = warp_sum(dot);
    for (int c = lane; c < nvec; c += 32) {
      float yv[VEC], gv[VEC];
      if (c < nread) {
        load_f32<T, VEC>(yr + c * VEC, yv);
        load_f32<T, VEC>(dyr + c * VEC, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) yv[i] = scale * yv[i] * (gv[i] - dot);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) yv[i] = 0.f;
      }
      store_f32<T, VEC>(dxr + c * VEC, yv);
    }
  }
}

template <typename T, int VEC, int KV>
cudaError_t launch(const Args& a) {
  const dim3 grid((unsigned)((a.rows + kWarps - 1) / kWarps));
  softmax_bwd_kernel<T, VEC, KV><<<grid, 32 * kWarps, 0, a.stream>>>(
      static_cast<const T*>(a.y), static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.rows,
      a.sq, a.sk, a.scale, a.causal);
  return cudaGetLastError();
}

// the fewest registers that hold the row, or the looping variant
template <typename T, int VEC>
cudaError_t by_length(const Args& a) {
  const int need = (a.sk / VEC + 31) / 32;        // vectors a lane
  if (need <= 1) return launch<T, VEC, 1>(a);
  if (need <= 2) return launch<T, VEC, 2>(a);
  if constexpr (4 * VEC <= kRegFloats) {
    if (need <= 4) return launch<T, VEC, 4>(a);
  }
  if constexpr (8 * VEC <= kRegFloats) {
    if (need <= 8) return launch<T, VEC, 8>(a);
  }
  return launch<T, VEC, 0>(a);
}

template <typename T>
cudaError_t by_vector(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  if (a.sk % VEC == 0 && aligned(a.y, 16) && aligned(a.dy, 16) && aligned(a.dx, 16))
    return by_length<T, VEC>(a);
  return by_length<T, 1>(a);
}

}  // namespace

// y, dy, dx: [rows, sk] contiguous, one dtype: 0 fp32, 1 bf16, 2 fp16;
// rows = b * h * sq; causal nonzero when y is a causal forward's output.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int apex_scaled_softmax_bwd(const void* y, const void* dy, void* dx, long long rows,
                                       int sq, int sk, float scale, int causal, int dtype,
                                       void* stream) {
  if (rows < 1 || sq < 1 || sk < 1 || rows % sq) return cudaErrorInvalidValue;
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Args a{y, dy, dx, (int64_t)rows, sq, sk, scale, causal != 0,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype) {
    case kF32: err = by_vector<float>(a); break;
    case kBF16: err = by_vector<__nv_bfloat16>(a); break;
    case kF16: err = by_vector<__half>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
