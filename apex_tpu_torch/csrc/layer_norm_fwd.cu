// LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py::_fwd_kernel, the Pallas TPU kernel
// launched by _pallas_forward.  Same function: for x [n, h] and an optional
// weight [h] and bias [h],
//   LN:  mean = sum(x)/h, var = sum((x - mean)^2)/h   (two passes, fp32)
//   RMS: mean = 0,        var = sum(x^2)/h
//   rstd = rsqrt(var + eps), y = (x - mean) * rstd * w + b in fp32,
// y cast to x's dtype; mean [n] and rstd [n] in fp32.  x is fp32, bf16 or
// fp16; weight and bias are each fp32, bf16 or fp16, independently of x.
// Any h and any n >= 1: the kernel masks the ragged edge itself.
//
// Bound: bytes.  The kernel reads n*h elements of x and writes n*h of y (plus
// h of weight and bias and 2n fp32 stats); it does about 6 operations per
// element, far below the card's rate, so its least time is those bytes over
// the H100's 3.35 TB/s.
//
// Design for that bound: every byte of x is read from device memory once and
// every byte of y written once.  One warp owns one row.  It loads the row in
// 16-byte vectors (8 bf16 or 4 fp32 values a lane per load, neighbouring
// lanes on neighbouring addresses) into registers: up to 64 fp32 values a
// lane, a row of 2048 in one pass.  Warp shuffles give the two statistics
// from those registers, and a last pass over the registers writes y, so the
// TPU kernel's 128-row VMEM tile has no counterpart here.  Rows longer than
// the registers hold loop over the row and read it again (from L1/L2).
// Blocks hold 1 to 8 warps, chosen so that a prefill-sized n launches at
// least two blocks per SM; the decode case (n = slots, a handful of rows)
// is bound by the launch, not by bytes.
//
// C interface (loaded with ctypes): apex_layer_norm_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// fp32 values of its row that a lane keeps in registers
constexpr int kRegFloats = 64;
constexpr int kMaxWarpsPerBlock = 8;

// y = (x - mean) * rstd * w + b for the VEC values of chunk c, stored as TX
template <typename TX, typename TW, typename TB, int VEC>
__device__ __forceinline__ void emit(TX* yr, const TW* w, const TB* b, int c,
                                     const float (&xv)[VEC], float mean,
                                     float rstd, bool has_w, bool has_b) {
  float out[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = (xv[i] - mean) * rstd;
  if (has_w) {
    float wv[VEC];
    load_f32<TW, VEC>(w + (int64_t)c * VEC, wv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] *= wv[i];
    if (has_b) {
      float bv[VEC];
      load_f32<TB, VEC>(b + (int64_t)c * VEC, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] += bv[i];
    }
  }
  store_f32<TX, VEC>(yr + (int64_t)c * VEC, out);
}

// One warp per row; VEC values per access (h % VEC == 0 by the host's choice).
template <typename TX, typename TW, typename TB, int VEC>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
ln_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              const TB* __restrict__ b, TX* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int64_t n, int h, float eps, bool rms, bool has_w, bool has_b) {
  constexpr int kMaxVecs = kRegFloats / VEC;   // vectors a lane keeps
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;                        // whole warps leave together
  const TX* xr = x + row * h;
  TX* yr = y + row * h;
  const int nvec = h / VEC;
  const float fh = (float)h;

  float mean = 0.f, rstd;
  if (nvec <= 32 * kMaxVecs) {
    // the row fits in registers: one read of x, one write of y
    float regs[kMaxVecs][VEC];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) {
        load_f32<TX, VEC>(xr + (int64_t)c * VEC, regs[k]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += regs[k][i];
      }
    }
    if (!rms) mean = warp_sum(s) / fh;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      if (lane + 32 * k < nvec) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = regs[k][i] - mean;
          ss += d * d;
        }
      }
    }
    rstd = rsqrtf(warp_sum(ss) / fh + eps);
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) emit<TX, TW, TB, VEC>(yr, w, b, c, regs[k], mean, rstd, has_w, has_b);
    }
  } else {
    // a longer row: three sweeps, the second and third read it again
    float v[VEC];
    float s = 0.f;
    if (!rms) {
      for (int c = lane; c < nvec; c += 32) {
        load_f32<TX, VEC>(xr + (int64_t)c * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += v[i];
      }
      mean = warp_sum(s) / fh;
    }
    float ss = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      load_f32<TX, VEC>(xr + (int64_t)c * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - mean;
        ss += d * d;
      }
    }
    rstd = rsqrtf(warp_sum(ss) / fh + eps);
    for (int c = lane; c < nvec; c += 32) {
      load_f32<TX, VEC>(xr + (int64_t)c * VEC, v);
      emit<TX, TW, TB, VEC>(yr, w, b, c, v, mean, rstd, has_w, has_b);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  float* mean;
  float* rstd;
  int64_t n;
  int h;
  float eps;
  bool rms;
  cudaStream_t stream;
};

template <typename TX, typename TW, typename TB>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 16 / sizeof(TX);
  const bool vec = a.h % VEC == 0 && aligned(a.x, 16) && aligned(a.y, 16) &&
                   aligned(a.w, pack_align(sizeof(TW) * VEC)) &&
                   aligned(a.b, pack_align(sizeof(TB) * VEC));
  // the most warps a block may hold while the grid keeps >= 2 blocks an SM
  static const int sms = sm_count();
  int wpb = kMaxWarpsPerBlock;
  while (wpb > 1 && (a.n + wpb - 1) / wpb < 2 * sms) wpb >>= 1;
  const dim3 block(32 * wpb);
  const dim3 grid((unsigned)((a.n + wpb - 1) / wpb));
  const TX* x = static_cast<const TX*>(a.x);
  const TW* w = static_cast<const TW*>(a.w);
  const TB* b = static_cast<const TB*>(a.b);
  TX* y = static_cast<TX*>(a.y);
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
  if (vec)
    ln_fwd_kernel<TX, TW, TB, VEC><<<grid, block, 0, a.stream>>>(
        x, w, b, y, a.mean, a.rstd, a.n, a.h, a.eps, a.rms, has_w, has_b);
  else
    ln_fwd_kernel<TX, TW, TB, 1><<<grid, block, 0, a.stream>>>(
        x, w, b, y, a.mean, a.rstd, a.n, a.h, a.eps, a.rms, has_w, has_b);
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

// x, y: [n, h] contiguous, dtype x_dtype; w, b: [h] contiguous or null, each
// with its own dtype code (ignored when the pointer is null); mean, rstd: [n]
// fp32.  Dtype codes: 0 fp32, 1 bf16, 2 fp16.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* y, void* mean, void* rstd,
                                   long long n, int h, float eps, int rms,
                                   int x_dtype, int w_dtype, int b_dtype,
                                   void* stream) {
  if (n < 1 || h < 1) return cudaErrorInvalidValue;
  const Args a{x, w, b, y, static_cast<float*>(mean), static_cast<float*>(rstd),
               (int64_t)n, h, eps, rms != 0, static_cast<cudaStream_t>(stream)};
  // an absent weight or bias takes x's dtype: its type is then never read
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
