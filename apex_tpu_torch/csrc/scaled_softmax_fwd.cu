// Scaled, masked softmax forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/softmax.py::_fwd_kernel, the Pallas TPU kernel
// launched by _pallas_forward.  Same function: for x [b, h, sq, sk], an
// optional causal triangle and an optional bool mask [b, 1, sq, sk] (true
// means masked out, broadcast over heads),
//   valid = (causal ? col <= row + (sk - sq) : true) && !mask
//   y = softmax(where(valid, x * scale, -10000)) over each row, in fp32,
// stored in x's dtype, and a row with no valid element written as zeros
// (the causal case too: a row with row + (sk - sq) < 0 sees no key).  x is
// fp32, bf16 or fp16; any sq and any sk from 1 up to the wrapper's maximum.
//
// Bound: bytes.  The kernel reads b h sq sk elements of x (and b sq sk mask
// bytes) and writes as many of y; it does about 10 operations an element,
// far below the card's rate.  At GPT-2-large's attention (x bf16 [8, 20,
// 1024, 1024]) that is 335.5 MB each way: 0.200 ms at 3.35 TB/s.
//
// Design for that bound: every byte of y is written once and every needed
// byte of x read once.  One warp owns one row, four rows a block.  A row of
// up to 64 fp32 values a lane (2048 elements) lives in registers, loaded in
// 16-byte vectors (8 bf16 or 4 fp32 values a lane, neighbouring lanes on
// neighbouring addresses); the max and the sum are warp shuffles in fp32,
// and a last pass over the registers writes y as e * (1 / sum).  The TPU
// kernel's (128, sk) VMEM tile has no counterpart.  Under the causal
// triangle a vector wholly past the row's last valid column is never read
// (its values are the fill anyway), so a causal square x costs about half
// its bytes to read; and once the row's max is more than 104 above the
// fill, the fill's exponential is 0 and those vectors are written as zeros
// with no arithmetic.  The exponentials are __expf (ex2.approx of x log2 e:
// a relative error of about |x| 2^-24 plus 2^-22, and 0 below about -87),
// which keeps the kernel's arithmetic under its bytes.  Longer
// rows take a second variant that loops over the row: per-lane online max
// and sum in one read, then a second read that writes y.  A row length
// that is not a multiple of the vector (or an unaligned pointer) takes
// scalar accesses.
//
// C interface (loaded with ctypes): apex_scaled_softmax_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kMaskValue = -10000.f;   // the JAX kernel's fill (softmax.py:35)
constexpr int kWarps = 4;                // rows a block
constexpr int kRegFloats = 64;           // fp32 values of its row a lane keeps
// __expf(x) is exactly 0 for x below about -87.3 (ex2.approx flushes
// results under 2^-126 to zero): a margin above that
constexpr float kUnderflow = 104.f;

struct Args {
  const void* x;
  const uint8_t* mask;   // [b, sq, sk] by (mask_bs, mask_rs, 1) strides, or null
  void* y;
  int64_t rows;          // b * h * sq
  int64_t hsq;           // h * sq: rows of one batch element
  int sq, sk;
  int64_t mask_bs, mask_rs;
  float scale;
  bool causal;
  cudaStream_t stream;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x * scale, or the fill where the element is not valid; `ok` accumulates
// whether any element was valid
template <typename T, int VEC>
__device__ __forceinline__ void load_row_vec(const T* xr, const uint8_t* mr, int col0, int limit,
                                             float scale, float (&v)[VEC], bool& ok) {
  if (col0 < limit) {
    load_f32<T, VEC>(xr + col0, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = kMaskValue;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int col = col0 + i;
    const bool valid = col < limit && (mr == nullptr || mr[col] == 0);
    v[i] = valid ? v[i] * scale : kMaskValue;
    ok = ok || valid;
  }
}

// One warp per row.  KV > 0: the row in registers, KV vectors of VEC values
// a lane (sk <= 32 * KV * VEC); KV == 0: the looping variant, any sk.
template <typename T, int VEC, int KV>
__global__ void __launch_bounds__(32 * kWarps)
softmax_fwd_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   T* __restrict__ y, int64_t rows, int64_t hsq, int sq, int sk,
                   int64_t mask_bs, int64_t mask_rs, float scale, bool causal) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                       // whole warps leave together
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const int r = (int)(row % sq);
  // columns [0, limit) may be valid: the causal triangle's edge
  int limit = sk;
  if (causal) {
    const int64_t last = (int64_t)r + (sk - sq);   // the last visible column
    limit = last < 0 ? 0 : (last + 1 < sk ? (int)(last + 1) : sk);
  }
  const uint8_t* mr = mask == nullptr ? nullptr : mask + (row / hsq) * mask_bs + r * mask_rs;
  const int nvec = sk / VEC;
  bool ok = false;

  if constexpr (KV > 0) {
    float v[KV][VEC];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) {
        load_row_vec<T, VEC>(xr, mr, c * VEC, limit, scale, v[k], ok);
#pragma unroll
        for (int i = 0; i < VEC; ++i) mx = fmaxf(mx, v[k][i]);
      }
    }
    mx = warp_max(mx);
    ok = __any_sync(0xffffffffu, ok);
    // past the causal edge every value is the fill; once the row's max is
    // far above it (any row with a valid element of ordinary size) its
    // exponential is 0 in fp32, so those vectors need no arithmetic
    const bool fill_is_zero = mx - kMaskValue > kUnderflow;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec && !(fill_is_zero && c * VEC >= limit)) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[k][i] = __expf(v[k][i] - mx);
          s += v[k][i];
        }
      }
    }
    const float inv = ok ? 1.f / warp_sum(s) : 0.f;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) {
        const bool zero = fill_is_zero && c * VEC >= limit;
        float out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) out[i] = zero ? 0.f : v[k][i] * inv;
        store_f32<T, VEC>(yr + c * VEC, out);
      }
    }
  } else {
    // one read: each lane's running max and its sum of exp(v - max)
    float mx = -CUDART_INF_F, s = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      float v[VEC];
      load_row_vec<T, VEC>(xr, mr, c * VEC, limit, scale, v, ok);
      float vm = v[0];
#pragma unroll
      for (int i = 1; i < VEC; ++i) vm = fmaxf(vm, v[i]);
      const float mn = fmaxf(mx, vm);
      s = (mx == -CUDART_INF_F ? 0.f : s * __expf(mx - mn));
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += __expf(v[i] - mn);
      mx = mn;
    }
    const float m_all = warp_max(mx);
    s = warp_sum(mx == -CUDART_INF_F ? 0.f : s * __expf(mx - m_all));
    ok = __any_sync(0xffffffffu, ok);
    const float inv = ok ? 1.f / s : 0.f;
    const bool fill_is_zero = m_all - kMaskValue > kUnderflow;
    // a second read writes y
    for (int c = lane; c < nvec; c += 32) {
      float v[VEC];
      if (fill_is_zero && c * VEC >= limit) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = 0.f;
      } else {
        bool unused = false;
        load_row_vec<T, VEC>(xr, mr, c * VEC, limit, scale, v, unused);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = __expf(v[i] - m_all) * inv;
      }
      store_f32<T, VEC>(yr + c * VEC, v);
    }
  }
}

template <typename T, int VEC, int KV>
cudaError_t launch(const Args& a) {
  const dim3 grid((unsigned)((a.rows + kWarps - 1) / kWarps));
  softmax_fwd_kernel<T, VEC, KV><<<grid, 32 * kWarps, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.mask, static_cast<T*>(a.y), a.rows, a.hsq, a.sq, a.sk,
      a.mask_bs, a.mask_rs, a.scale, a.causal);
  return cudaGetLastError();
}

// the fewest registers that hold the row, or the looping variant
template <typename T, int VEC>
cudaError_t by_length(const Args& a) {
  const int need = (a.sk / VEC + 31) / 32;        // vectors a lane
  if (need <= 1) return launch<T, VEC, 1>(a);
  if (need <= 2) return launch<T, VEC, 2>(a);
  if (need <= 4) return launch<T, VEC, 4>(a);
  if constexpr (8 * VEC <= kRegFloats) {
    if (need <= 8) return launch<T, VEC, 8>(a);
  }
  if constexpr (16 * VEC <= kRegFloats) {
    if (need <= 16) return launch<T, VEC, 16>(a);
  }
  return launch<T, VEC, 0>(a);
}

template <typename T>
cudaError_t by_vector(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  if (a.sk % VEC == 0 && aligned(a.x, 16) && aligned(a.y, 16)) return by_length<T, VEC>(a);
  return by_length<T, 1>(a);
}

}  // namespace

// x, y: [b, h, sq, sk] contiguous, dtype 0 fp32, 1 bf16, 2 fp16; mask: bytes
// (0 keep, nonzero mask out) at mask + batch * mask_bs + row * mask_rs + col,
// or null.  rows = b * h * sq.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int apex_scaled_softmax_fwd(const void* x, const void* mask, void* y, long long rows,
                                       int heads, int sq, int sk, long long mask_bs,
                                       long long mask_rs, float scale, int causal, int dtype,
                                       void* stream) {
  if (rows < 1 || heads < 1 || sq < 1 || sk < 1 || rows % ((long long)heads * sq))
    return cudaErrorInvalidValue;
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Args a{x, static_cast<const uint8_t*>(mask), y, (int64_t)rows,
               (int64_t)heads * sq, sq, sk, (int64_t)mask_bs, (int64_t)mask_rs, scale,
               causal != 0, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype) {
    case kF32: err = by_vector<float>(a); break;
    case kBF16: err = by_vector<__nv_bfloat16>(a); break;
    case kF16: err = by_vector<__half>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
