// The multi-tensor walker: one launch over every tensor of a call.
//
// Counterpart of Apex's csrc/multi_tensor_apply.cuh (a table of tensor
// pointers and chunks that one launch walks), shared by the kernels of
// multi_tensor.cu.  Apex passes its table in the kernel's parameters, 4 KB
// at most, and so launches once per 110 tensors; here the table is an
// int64 tensor on the device, built and cached on the host by
// ops/multi_tensor.py (`_table`), so one launch covers any number of
// tensors.  Its words, for T tensors in L lists:
//
//   T rows of L + 3 words: the tensor's pointer in each list (0 where the
//     list has none: an optional list), its element count n, a meta word
//     (4 bits a list: that tensor's dtype code in the list, kF32 / kBF16 /
//     kF16; bit 32: every pointer of the row 16-byte aligned) and the index
//     of its first chunk in the chunk list;
//   then C chunk words, (tensor << 32) | chunk index within the tensor,
//     tensor by tensor, each tensor's chunks in order (a tensor of n = 0
//     has none).
//
// A chunk is `chunk` elements (the last of a tensor fewer), a field of the
// table chosen from the list when it is built (ops/multi_tensor.py
// `choose_chunk`): 65,536 where that gives every resident block a chunk,
// else the largest power of two down to 2,048 that does, so a short list
// (OpenFold's 48 tensors of at most 65,536 elements) still spreads over
// every SM.  Each block takes chunks c = blockIdx.x, blockIdx.x +
// gridDim.x, ... in order.  In a
// chunk, each thread moves kMtVec consecutive elements at a time as 16-byte
// vectors where the row's pointers allow (8 elements: one 16-byte access
// of a 16-bit list, two of an fp32 one), then one element at a time for the
// chunk's tail; a row whose pointers are not aligned goes one element at a
// time throughout.  Every value is converted to fp32 on load and rounded to
// its list's dtype on store (round to nearest even).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMtThreads = 512;
constexpr int kMtVec = 8;
constexpr int kMtMaxLists = 6;

struct MtTable {
  const int64_t* words;
  int T, L, C, chunk;

  __device__ __forceinline__ const int64_t* row(int t) const {
    return words + (int64_t)t * (L + 3);
  }
  __device__ __forceinline__ int64_t chunk_word(int c) const {
    return words[(int64_t)T * (L + 3) + c];
  }
  // the chunks of tensor t: [first, first + count)
  __device__ __forceinline__ int64_t n(int t) const { return row(t)[L]; }
  __device__ __forceinline__ int first_chunk(int t) const { return (int)row(t)[L + 2]; }
  __device__ __forceinline__ int chunk_count(int t) const {
    const int64_t n = row(t)[L];
    return (int)((n + chunk - 1) / chunk);
  }
};

// one chunk of one tensor: its row's pointers in registers (the lists are
// read with constant indices, so the array stays out of local memory)
struct MtChunk {
  int64_t ptr[kMtMaxLists];
  int t;
  int64_t start;  // the chunk's first element in the tensor
  int len;        // its elements
  uint32_t dtypes;
  bool vec;

  __device__ __forceinline__ int dtype(int list) const { return (dtypes >> (4 * list)) & 15; }
  __device__ __forceinline__ bool has(int list) const { return ptr[list] != 0; }
};

__device__ __forceinline__ MtChunk mt_chunk(const MtTable& tb, int c) {
  const int64_t w = tb.chunk_word(c);
  MtChunk k;
  k.t = (int)(w >> 32);
  const int64_t* r = tb.row(k.t);
#pragma unroll
  for (int l = 0; l < kMtMaxLists; ++l) k.ptr[l] = l < tb.L ? r[l] : 0;
  const int64_t n = r[tb.L], meta = r[tb.L + 1];
  k.start = (w & 0xffffffffLL) * (int64_t)tb.chunk;
  const int64_t rest = n - k.start;
  k.len = (int)(rest < tb.chunk ? rest : tb.chunk);
  k.dtypes = (uint32_t)(meta & 0xffffffffLL);
  k.vec = (meta >> 32) & 1;
  return k;
}

// elements [start, start + len) of tensor t, read as mt_chunk reads a chunk
__device__ __forceinline__ MtChunk mt_piece(const MtTable& tb, int t, int64_t start, int len) {
  MtChunk k;
  k.t = t;
  const int64_t* r = tb.row(t);
#pragma unroll
  for (int l = 0; l < kMtMaxLists; ++l) k.ptr[l] = l < tb.L ? r[l] : 0;
  const int64_t meta = r[tb.L + 1];
  k.start = start;
  k.len = len;
  k.dtypes = (uint32_t)(meta & 0xffffffffLL);
  k.vec = (meta >> 32) & 1;
  return k;
}

// N elements of list `l` from element i of the chunk, in fp32
template <int N>
__device__ __forceinline__ void mt_load(const MtChunk& k, int l, int i, float (&o)[N]) {
  const int64_t at = k.start + i;
  switch (k.dtype(l)) {
    case kF32: load_f32<float, N>(reinterpret_cast<const float*>(k.ptr[l]) + at, o); break;
    case kBF16:
      load_f32<__nv_bfloat16, N>(reinterpret_cast<const __nv_bfloat16*>(k.ptr[l]) + at, o);
      break;
    default: load_f32<__half, N>(reinterpret_cast<const __half*>(k.ptr[l]) + at, o); break;
  }
}

template <int N>
__device__ __forceinline__ void mt_store(const MtChunk& k, int l, int i, const float (&v)[N]) {
  const int64_t at = k.start + i;
  switch (k.dtype(l)) {
    case kF32: store_f32<float, N>(reinterpret_cast<float*>(k.ptr[l]) + at, v); break;
    case kBF16:
      store_f32<__nv_bfloat16, N>(reinterpret_cast<__nv_bfloat16*>(k.ptr[l]) + at, v);
      break;
    default: store_f32<__half, N>(reinterpret_cast<__half*>(k.ptr[l]) + at, v); break;
  }
}

// body(std::integral_constant<int, N>{}, i) for every group of N elements
// of the chunk this thread takes: kMtVec at a time where the row is aligned,
// then one at a time.  Each thread's order is fixed by the chunk and
// blockDim, so a sum a thread keeps has the same bits on every launch.
template <class Body>
__device__ __forceinline__ void mt_sweep(const MtChunk& k, Body&& body) {
  int i0 = 0;
  if (k.vec) {
    const int nv = k.len / kMtVec;
    for (int j = threadIdx.x; j < nv; j += blockDim.x)
      body(std::integral_constant<int, kMtVec>{}, j * kMtVec);
    i0 = nv * kMtVec;
  }
  for (int i = i0 + threadIdx.x; i < k.len; i += blockDim.x)
    body(std::integral_constant<int, 1>{}, i);
}

// the block's sum in a fixed order (each warp's lanes by xor shuffles, then
// the warps in order); valid in thread 0.  `red` holds 32 floats.
__device__ __forceinline__ float mt_block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// the kernel's resident blocks of kMtThreads on the whole card
template <class Kernel>
inline int mt_resident(Kernel kernel) {
  static const int sms = sm_count();
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMtThreads, 0) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  return sms * per_sm;
}

// blocks for a walk over C chunks: the kernel's resident blocks on every
// SM, at most one a chunk
template <class Kernel>
inline int mt_grid(Kernel kernel, int C) {
  const int most = mt_resident(kernel);
  return C < most ? (C > 0 ? C : 1) : most;
}

// ---------------------------------------------------------------------------
// L2 eviction hints (Hopper's st .L2::cache_hint with a createpolicy
// policy, and prefetch .L2::evict_last)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// mark the L2 line of p to be evicted last (a prefetch with that priority)
__device__ __forceinline__ void l2_keep(const void* p) {
  asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(p) : "memory");
}

__device__ __forceinline__ void st_hint(void* p, uint4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
               : "memory");
}

template <typename T, int N>
__device__ __forceinline__ void store_f32_hint(T* p, const float (&in)[N], uint64_t pol) {
  constexpr int W = (int)(sizeof(T) * N / 16);
  static_assert(W >= 1 && sizeof(T) * N % 16 == 0, "whole 16-byte accesses");
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_f32<T>(in[i]);
  const uint4* u = reinterpret_cast<const uint4*>(&pk);
#pragma unroll
  for (int w = 0; w < W; ++w) st_hint(reinterpret_cast<uint4*>(p) + w, u[w], pol);
}

// kMtVec elements of list l from element i of the chunk, stored as 16-byte
// accesses under the L2 policy `pol`
__device__ __forceinline__ void mt_store_vec(const MtChunk& k, int l, int i,
                                             const float (&v)[kMtVec], uint64_t pol) {
  const int64_t at = k.start + i;
  switch (k.dtype(l)) {
    case kF32: store_f32_hint<float, kMtVec>(reinterpret_cast<float*>(k.ptr[l]) + at, v, pol); break;
    case kBF16:
      store_f32_hint<__nv_bfloat16, kMtVec>(reinterpret_cast<__nv_bfloat16*>(k.ptr[l]) + at, v,
                                            pol);
      break;
    default:
      store_f32_hint<__half, kMtVec>(reinterpret_cast<__half*>(k.ptr[l]) + at, v, pol);
      break;
  }
}

}  // namespace
