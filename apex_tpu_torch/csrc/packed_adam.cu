// Packed Adam / AdamW update for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/packed_update.py::_adam_kernel, the Pallas TPU
// kernel launched by packed_adam_update (multi_tensor_adam.cu's AdamFunctor
// in the CUDA original).  Same function, elementwise over flat buffers of n
// elements, with scalars = [lr, beta1, beta2, eps, wd, bc1, bc2, noop] read
// from a small fp32 buffer on the device (the Pallas kernel's SMEM operand),
// so neither the bias corrections nor the overflow flag is read on the host:
//   g += wd p                                     (adam_w_mode = 0: L2 into g)
//   m = beta1 m + (1 - beta1) g;   v = beta2 v + (1 - beta2) g g
//   d = sqrt(v / bc2) + eps
//   p = p - lr ((m / bc1) / d + wd p)             (adam_w_mode = 1)
//   p = p - lr (m / bc1) / d                      (adam_w_mode = 0)
// all in fp32; p is stored back in its own dtype.  noop != 0 (the loss
// scaler's found_inf) makes the step an identity: the Pallas kernel writes
// the old values back, this one returns before it reads a buffer, which
// leaves the same bits and moves none of the buffers' bytes.  g and p are
// each fp32, bf16 or fp16; m and v are fp32; p, m and v are updated in
// place.  Any n >= 1.
//
// Bound: bytes.  Each element reads g, p, m and v and writes p, m and v:
// 28 bytes with fp32 g and p, against about 20 operations.  At Llama-1B's
// 1.123 B parameters (the fp32 masters packed) that is 31.4 GB: 9.39 ms at
// 3.35 TB/s.
//
// Design for that bound: the grid-stride sweep of lamb_phase1.cu, every
// byte read once and written once.  Each thread moves 4 elements an
// iteration as one vector access per buffer (16 bytes for fp32, 8 for
// bf16/fp16), neighbouring threads on neighbouring addresses; eight blocks
// of 256 threads an SM keep enough loads in flight to cover the memory's
// latency.  The last n % 4 elements take scalar accesses, as does the whole
// pass when a pointer is not aligned for vectors.  The TPU kernel's
// (rows, 128) VMEM chunks and its n % 1024 == 0 gate have no counterpart.
//
// C interface (loaded with ctypes): apex_packed_adam returns
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
  float lr, beta1, beta2, eps, wd, bc1, bc2;
};

// the Pallas kernel's expressions, term for term
__device__ __forceinline__ void adam_element(float g, float& p, float& m, float& v,
                                             const Scalars& s, bool adam_w_mode) {
  if (!adam_w_mode) g = g + s.wd * p;
  m = s.beta1 * m + (1.f - s.beta1) * g;
  v = s.beta2 * v + (1.f - s.beta2) * g * g;
  const float denom = sqrtf(v / s.bc2) + s.eps;
  if (adam_w_mode)
    p = p - s.lr * ((m / s.bc1) / denom + s.wd * p);
  else
    p = p - s.lr * (m / s.bc1) / denom;
}

template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(kThreads)
packed_adam_kernel(const TG* __restrict__ g, TP* __restrict__ p, float* __restrict__ m,
                   float* __restrict__ v, const float* __restrict__ scalars, int64_t n,
                   bool adam_w_mode) {
  // keep = noop == 0, as the Pallas kernel tests it (a NaN flag skips too)
  if (!(scalars[7] == 0.f)) return;
  const Scalars s{scalars[0], scalars[1], scalars[2], scalars[3],
                  scalars[4], scalars[5], scalars[6]};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = n / VEC;
  for (int64_t i = tid; i < nvec; i += stride) {
    const int64_t at = i * VEC;
    float gv[VEC], pv[VEC], mv[VEC], vv[VEC];
    load_f32<TG, VEC>(g + at, gv);
    load_f32<TP, VEC>(p + at, pv);
    load_f32<float, VEC>(m + at, mv);
    load_f32<float, VEC>(v + at, vv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) adam_element(gv[k], pv[k], mv[k], vv[k], s, adam_w_mode);
    store_f32<TP, VEC>(p + at, pv);
    store_f32<float, VEC>(m + at, mv);
    store_f32<float, VEC>(v + at, vv);
  }
  // the ragged tail, one element a thread
  for (int64_t at = nvec * VEC + tid; at < n; at += stride) {
    float pp = to_f32(p[at]), mm = m[at], vv = v[at];
    adam_element(to_f32(g[at]), pp, mm, vv, s, adam_w_mode);
    p[at] = from_f32<TP>(pp);
    m[at] = mm;
    v[at] = vv;
  }
}

struct Args {
  const void* g;
  void* p;
  float* m;
  float* v;
  const float* scalars;
  int64_t n;
  bool adam_w_mode;
  cudaStream_t stream;
};

template <typename TG, typename TP>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 4;
  const bool vec = aligned(a.g, pack_align(sizeof(TG) * VEC)) &&
                   aligned(a.p, pack_align(sizeof(TP) * VEC)) && aligned(a.m, 16) &&
                   aligned(a.v, 16);
  static const int sms = sm_count();
  const int64_t per = vec ? VEC : 1;
  const int64_t want = (a.n / per + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (int64_t)sms * kBlocksPerSM ? (want > 0 ? want : 1)
                                                             : (int64_t)sms * kBlocksPerSM);
  const TG* g = static_cast<const TG*>(a.g);
  TP* p = static_cast<TP*>(a.p);
  if (vec)
    packed_adam_kernel<TG, TP, VEC><<<blocks, kThreads, 0, a.stream>>>(
        g, p, a.m, a.v, a.scalars, a.n, a.adam_w_mode);
  else
    packed_adam_kernel<TG, TP, 1><<<blocks, kThreads, 0, a.stream>>>(
        g, p, a.m, a.v, a.scalars, a.n, a.adam_w_mode);
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

// g [n] (g_dtype), p [n] (p_dtype), m, v [n] fp32, all but g updated in
// place; scalars [8] fp32 (the order above).  Dtype codes: 0 fp32, 1 bf16,
// 2 fp16.  Launches on `stream` and returns cudaGetLastError().
extern "C" int apex_packed_adam(const void* g, void* p, void* m, void* v, const void* scalars,
                                long long n, int adam_w_mode, int g_dtype, int p_dtype,
                                void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const Args a{g, p, static_cast<float*>(m), static_cast<float*>(v),
               static_cast<const float*>(scalars), (int64_t)n, adam_w_mode != 0,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (g_dtype) {
    case kF32: err = by_param<float>(p_dtype, a); break;
    case kBF16: err = by_param<__nv_bfloat16>(p_dtype, a); break;
    case kF16: err = by_param<__half>(p_dtype, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
