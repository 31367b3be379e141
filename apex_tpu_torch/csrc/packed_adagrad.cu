// Packed Adagrad update for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/packed_update.py::_adagrad_kernel, the Pallas TPU
// kernel launched by packed_adagrad_update (multi_tensor_adagrad.cu in the
// CUDA original).  Same function, elementwise over flat buffers of n
// elements, with scalars = [lr, eps, wd, noop] read from a small fp32 buffer
// on the device (the Pallas kernel's SMEM operand):
//   g += wd p                                  (adagrad_w_mode = 0: L2 into g)
//   h = h + g g
//   u = g / (sqrt(h) + eps);   u += wd p       (adagrad_w_mode = 1)
//   p = p - lr u
// all in fp32; p is stored back in its own dtype.  noop != 0 (the loss
// scaler's found_inf) makes the step an identity: the Pallas kernel writes
// the old values back, this one returns before it reads a buffer, which
// leaves the same bits and moves none of the buffers' bytes.  g and p are
// each fp32, bf16 or fp16; h is fp32; p and h are updated in place.  Any
// n >= 1.
//
// Bound: bytes.  Each element reads g, p and h and writes p and h: 20 bytes
// with fp32 g and p, against about 8 operations.  At Llama-1B's 1.123 B
// parameters (the fp32 masters packed) that is 22.5 GB: 6.70 ms at
// 3.35 TB/s.
//
// Design for that bound: the grid-stride sweep of lamb_phase1.cu and
// packed_adam.cu, every byte read once and written once, 4 elements a
// thread an iteration as one vector access per buffer, a scalar tail, and
// scalar accesses throughout when a pointer is not aligned for vectors.
//
// C interface (loaded with ctypes): apex_packed_adagrad returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct Scalars {
  float lr, eps, wd;
};

// the Pallas kernel's expressions, term for term
__device__ __forceinline__ void adagrad_element(float g, float& p, float& h, const Scalars& s,
                                                bool adagrad_w_mode) {
  if (!adagrad_w_mode) g = g + s.wd * p;
  h = h + g * g;
  float update = g / (sqrtf(h) + s.eps);
  if (adagrad_w_mode) update = update + s.wd * p;
  p = p - s.lr * update;
}

template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(kThreads)
packed_adagrad_kernel(const TG* __restrict__ g, TP* __restrict__ p, float* __restrict__ h,
                      const float* __restrict__ scalars, int64_t n, bool adagrad_w_mode) {
  // keep = noop == 0, as the Pallas kernel tests it (a NaN flag skips too)
  if (!(scalars[3] == 0.f)) return;
  const Scalars s{scalars[0], scalars[1], scalars[2]};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = n / VEC;
  for (int64_t i = tid; i < nvec; i += stride) {
    const int64_t at = i * VEC;
    float gv[VEC], pv[VEC], hv[VEC];
    load_f32<TG, VEC>(g + at, gv);
    load_f32<TP, VEC>(p + at, pv);
    load_f32<float, VEC>(h + at, hv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) adagrad_element(gv[k], pv[k], hv[k], s, adagrad_w_mode);
    store_f32<TP, VEC>(p + at, pv);
    store_f32<float, VEC>(h + at, hv);
  }
  // the ragged tail, one element a thread
  for (int64_t at = nvec * VEC + tid; at < n; at += stride) {
    float pp = to_f32(p[at]), hh = h[at];
    adagrad_element(to_f32(g[at]), pp, hh, s, adagrad_w_mode);
    p[at] = from_f32<TP>(pp);
    h[at] = hh;
  }
}

struct Args {
  const void* g;
  void* p;
  float* h;
  const float* scalars;
  int64_t n;
  bool adagrad_w_mode;
  cudaStream_t stream;
};

template <typename TG, typename TP>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 4;
  const bool vec = aligned(a.g, pack_align(sizeof(TG) * VEC)) &&
                   aligned(a.p, pack_align(sizeof(TP) * VEC)) && aligned(a.h, 16);
  static const int sms = sm_count();
  const int64_t per = vec ? VEC : 1;
  const int64_t want = (a.n / per + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (int64_t)sms * kBlocksPerSM ? (want > 0 ? want : 1)
                                                             : (int64_t)sms * kBlocksPerSM);
  const TG* g = static_cast<const TG*>(a.g);
  TP* p = static_cast<TP*>(a.p);
  if (vec)
    packed_adagrad_kernel<TG, TP, VEC><<<blocks, kThreads, 0, a.stream>>>(
        g, p, a.h, a.scalars, a.n, a.adagrad_w_mode);
  else
    packed_adagrad_kernel<TG, TP, 1><<<blocks, kThreads, 0, a.stream>>>(
        g, p, a.h, a.scalars, a.n, a.adagrad_w_mode);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t by_param(int p_dtype, const Args& a) {
  switch (p_dtype) {
    case kF32: return launch<TG, float>(a);
    case kBF16: return launch<TG, __nv_bfloat16>(a);
    case kF16: return launch<TG, __half>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// g [n] (g_dtype), p [n] (p_dtype), h [n] fp32, p and h updated in place;
// scalars [4] fp32 (the order above).  Dtype codes: 0 fp32, 1 bf16, 2 fp16.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int apex_packed_adagrad(const void* g, void* p, void* h, const void* scalars,
                                   long long n, int adagrad_w_mode, int g_dtype, int p_dtype,
                                   void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const Args a{g, p, static_cast<float*>(h), static_cast<const float*>(scalars), (int64_t)n,
               adagrad_w_mode != 0, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (g_dtype) {
    case kF32: err = by_param<float>(p_dtype, a); break;
    case kBF16: err = by_param<__nv_bfloat16>(p_dtype, a); break;
    case kF16: err = by_param<__half>(p_dtype, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
