// Packed LAMB phase 1 (moments and raw update) for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/packed_update.py::_lamb_phase1_kernel, the Pallas
// TPU kernel launched by packed_lamb_update (multi_tensor_lamb.cu stage 1
// of the CUDA original).  Same function, elementwise over flat buffers of n
// elements, with scalars = [beta1, beta3, beta2, eps, wd, bc1, bc2, clip]
// read from a small fp32 buffer on the device (the Pallas kernel's SMEM
// operand), so the step needs no value from the host:
//   g = g / clip;               g += wd * p     (adam_w_mode = 0: L2 into g)
//   m = beta1 m + beta3 g;      v = beta2 v + (1 - beta2) g g
//   u = (m / bc1) / (sqrt(v / bc2) + eps);     u += wd * p (adam_w_mode = 1)
// all in fp32.  g and p are each fp32, bf16 or fp16; m, v and u are fp32;
// m and v may be written in place (m_out == m, v_out == v).  Any n >= 1.
//
// Bound: bytes.  Each element reads g, p, m and v and writes m, v and u:
// 28 bytes with fp32 g and p, against about 15 operations.  At GPT-2-large
// (774 M parameters, padded to 1024) that is 21.7 GB: 6.5 ms at 3.35 TB/s.
//
// Design for that bound: one grid-stride pass, every byte read once and
// written once.  Each thread moves 4 elements an iteration as one vector
// access per buffer (16 bytes for fp32, 8 for bf16/fp16), neighbouring
// threads on neighbouring addresses; eight blocks of 256 threads an SM keep
// enough loads in flight to cover the memory's latency.  The last n % 4
// elements take scalar accesses, as does the whole pass when a pointer is
// not aligned for vectors.  The TPU kernel's (rows, 128) VMEM chunks and its
// n % 1024 == 0 gate have no counterpart.
//
// C interface (loaded with ctypes): apex_lamb_phase1 returns
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
  float beta1, beta3, beta2, eps, wd, bc1, bc2, clip;
};

__device__ __forceinline__ void lamb_element(float g, float p, float& m, float& v, float& u,
                                             const Scalars& s, bool adam_w_mode) {
  g = g / s.clip;
  if (!adam_w_mode) g = g + s.wd * p;
  m = s.beta1 * m + s.beta3 * g;
  v = s.beta2 * v + (1.f - s.beta2) * g * g;
  u = (m / s.bc1) / (sqrtf(v / s.bc2) + s.eps);
  if (adam_w_mode) u = u + s.wd * p;
}

template <typename TG, typename TP, int VEC>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const TG* __restrict__ g, const TP* __restrict__ p, const float* m,
                   const float* v, const float* __restrict__ scalars, float* m_out,
                   float* v_out, float* __restrict__ u_out, int64_t n, bool adam_w_mode) {
  const Scalars s{scalars[0], scalars[1], scalars[2], scalars[3],
                  scalars[4], scalars[5], scalars[6], scalars[7]};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = n / VEC;
  for (int64_t i = tid; i < nvec; i += stride) {
    const int64_t at = i * VEC;
    float gv[VEC], pv[VEC], mv[VEC], vv[VEC], uv[VEC];
    load_f32<TG, VEC>(g + at, gv);
    load_f32<TP, VEC>(p + at, pv);
    load_f32<float, VEC>(m + at, mv);
    load_f32<float, VEC>(v + at, vv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) lamb_element(gv[k], pv[k], mv[k], vv[k], uv[k], s, adam_w_mode);
    store_f32<float, VEC>(m_out + at, mv);
    store_f32<float, VEC>(v_out + at, vv);
    store_f32<float, VEC>(u_out + at, uv);
  }
  // the ragged tail, one element a thread
  for (int64_t at = nvec * VEC + tid; at < n; at += stride) {
    float mm = m[at], vv = v[at], uu;
    lamb_element(to_f32(g[at]), to_f32(p[at]), mm, vv, uu, s, adam_w_mode);
    m_out[at] = mm;
    v_out[at] = vv;
    u_out[at] = uu;
  }
}

struct Args {
  const void* g;
  const void* p;
  const float* m;
  const float* v;
  const float* scalars;
  float* m_out;
  float* v_out;
  float* u_out;
  int64_t n;
  bool adam_w_mode;
  cudaStream_t stream;
};

template <typename TG, typename TP>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 4;
  const bool vec = aligned(a.g, pack_align(sizeof(TG) * VEC)) &&
                   aligned(a.p, pack_align(sizeof(TP) * VEC)) && aligned(a.m, 16) &&
                   aligned(a.v, 16) && aligned(a.m_out, 16) && aligned(a.v_out, 16) &&
                   aligned(a.u_out, 16);
  static const int sms = sm_count();
  const int64_t per = vec ? VEC : 1;
  const int64_t want = (a.n / per + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (int64_t)sms * kBlocksPerSM ? (want > 0 ? want : 1)
                                                             : (int64_t)sms * kBlocksPerSM);
  const TG* g = static_cast<const TG*>(a.g);
  const TP* p = static_cast<const TP*>(a.p);
  if (vec)
    lamb_phase1_kernel<TG, TP, VEC><<<blocks, kThreads, 0, a.stream>>>(
        g, p, a.m, a.v, a.scalars, a.m_out, a.v_out, a.u_out, a.n, a.adam_w_mode);
  else
    lamb_phase1_kernel<TG, TP, 1><<<blocks, kThreads, 0, a.stream>>>(
        g, p, a.m, a.v, a.scalars, a.m_out, a.v_out, a.u_out, a.n, a.adam_w_mode);
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

// g [n] (g_dtype), p [n] (p_dtype), m, v [n] fp32, scalars [8] fp32 (the
// order above), m_out, v_out, u_out [n] fp32 (m_out may be m and v_out v).
// Dtype codes: 0 fp32, 1 bf16, 2 fp16.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int apex_lamb_phase1(const void* g, const void* p, const void* m, const void* v,
                                const void* scalars, void* m_out, void* v_out, void* u_out,
                                long long n, int adam_w_mode, int g_dtype, int p_dtype,
                                void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const Args a{g, p, static_cast<const float*>(m), static_cast<const float*>(v),
               static_cast<const float*>(scalars), static_cast<float*>(m_out),
               static_cast<float*>(v_out), static_cast<float*>(u_out), (int64_t)n,
               adam_w_mode != 0, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (g_dtype) {
    case kF32: err = by_param<float>(p_dtype, a); break;
    case kBF16: err = by_param<__nv_bfloat16>(p_dtype, a); break;
    case kF16: err = by_param<__half>(p_dtype, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
