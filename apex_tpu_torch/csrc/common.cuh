// Scalar and vector helpers shared by every kernel in this directory: the
// dtype codes of the C interfaces, fp32 conversions of the three element
// types, 16-byte vector loads and stores, warp sums, the dropout counter
// hash, and the hardware 2^x.  Included by the .cu sources (directly or
// through wgmma_sm90.cuh); _build.py hashes every .cuh here into each
// library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the `dtype` arguments of the C entry points
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

constexpr int pack_align(int bytes) { return bytes > 16 ? 16 : bytes; }

// N consecutive values moved as one (or two) vector accesses
template <typename T, int N>
struct alignas(pack_align(sizeof(T) * N)) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_f32(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// murmur3's 32-bit finalizer.  The dropout keep bit of attention element
// (bh, qpos, kpos) is fmix32(fmix32(fmix32(seed ^ qpos) ^ kpos) ^ bh) >=
// threshold, the JAX counter hash: the flash forward and both backward
// kernels regenerate the same bits from it.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool keep_bit(uint32_t seed, uint32_t qpos, uint32_t kpos,
                                         uint32_t bh, uint32_t threshold) {
  return fmix32(fmix32(fmix32(seed ^ qpos) ^ kpos) ^ bh) >= threshold;
}

// the hardware 2^x (relative error about 2^-22, -inf -> 0, results below
// 2^-126 flushed to 0): the flash kernels take it for p, which they round
// to bf16/fp16 before its products anyway; sums and lse stay within their
// stated bounds
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

inline bool aligned(const void* p, int bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace
