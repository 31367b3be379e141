// LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py::_fwd_kernel, the Pallas TPU kernel
// launched by _pallas_forward.  Same function: for x [n, h] and an optional
// weight [h] and bias [h],
//   LN:  mean = sum(x)/h, var = sum((x - mean)^2)/h   (two passes, fp32)
//   RMS: mean = 0,        var = sum(x^2)/h
//   rstd = rsqrt(var + eps), y = (x - mean) * rstd * w + b in fp32,
// y cast to x's dtype; mean [n] and rstd [n] in fp32.  x is fp32, bf16 or
// fp16; the weight and bias each fp32, bf16 or fp16, independently of x (the
// wrapper hands over a weight and bias of one dtype: where theirs differ it
// widens both to fp32, which changes no value).  Any h and any n >= 1: the
// kernel masks the ragged edge itself.
//
// Bound: bytes.  The kernel reads n*h elements of x and writes n*h of y (plus
// h of weight and bias and 2n fp32 stats); it does about 6 operations per
// element, far below the card's rate, so its least time is those bytes over
// the H100's 3.35 TB/s (0.0201 ms at n 8192, h 2048, bf16).
//
// Design for that bound: every byte of x is read from device memory once and
// every byte of y written once, with enough loads in flight to keep the
// memory system busy.
// - Rows to lane groups: a row belongs to a group of `lanes` lanes (8, 16 or
//   32: several rows a warp where a row is short, OpenFold's h 128 and 256),
//   which loads it in 16-byte vectors (8 bf16 or 4 fp32 values a lane per
//   load, neighbouring lanes on neighbouring addresses) and keeps it packed
//   in its own dtype in registers, NV vectors a lane, converted to fp32 where
//   used (anew in each pass: fp32 copies kept live would double the
//   registers).  Shuffles inside the group give the two statistics from
//   those registers, and a last pass over them writes y.  At 32 lanes a row
//   (h >= 512 in 16 bits) each lane holds the chunks lane + 32 k and sums
//   them in the order the one-warp-a-row kernel this design replaced did,
//   so every row gives the same bits as before: the serving path's greedy
//   streams, which near-tied logits of random weights make sensitive to
//   the last bit, do not move.
// - Persistent warps: the grid is a few blocks an SM (ops/layer_norm.py's
//   fwd_grid chooses lanes, NV, warps and blocks), and each warp walks its
//   rows with a stride.  Before it reduces, scales and stores one row it
//   issues the loads of its next one, so that row's memory latency hides
//   under this row's work.
// - The weight and bias are copied once a block into shared memory, in their
//   own dtype, by cp.async issued together with the first row's loads: a
//   decode step (n 8, one row a warp) waits for one memory round trip, not
//   for x and then the weight.  Each lane reads its chunks of them from
//   shared memory per row (16 contiguous bytes a lane: no bank conflicts).
// - Rows longer than the registers hold (more than 64 values a lane) and
//   inputs off 16-byte alignment take a second kernel: one warp a row, three
//   sweeps, the second and third reading the row again (from L1/L2).
//
// C interface (loaded with ctypes): apex_layer_norm_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kThreads = 32 * kMaxWarpsPerBlock;

// the blocks an SM the register path's registers allow: the current row and
// the next one take 8 NV registers a lane; ops/layer_norm.py's
// _fwd_blocks_per_sm holds the same table and _FWD_VECS the NV that launch
// instantiates (tests/test_torch_layer_norm.py reads both here and holds
// them equal)
constexpr int fwd_blocks_per_sm(int nv) { return nv <= 2 ? 4 : nv <= 4 ? 3 : nv <= 8 ? 2 : 1; }

// the sum over a group of `lanes` neighbouring lanes (a power of two up to 32)
__device__ __forceinline__ float group_sum(float v, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x's element i of a packed vector in fp32, converted anew at every use
// (asm volatile): a row stays packed in registers between the passes, where
// the compiler would otherwise keep its fp32 values live (twice the
// registers, and spills at 128 a thread)
template <typename T, int N>
__device__ __forceinline__ float fresh_f32(const Pack<T, N>& pk, int i) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // a bf16 is the upper half of its fp32: the pair's word shifted or masked
    const uint32_t w = reinterpret_cast<const uint32_t*>(pk.v)[i >> 1];
    uint32_t r;
    if (i & 1)
      asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(r) : "r"(w));
    else
      asm volatile("shl.b32 %0, %1, 16;" : "=r"(r) : "r"(w));
    return __uint_as_float(r);
  } else if constexpr (std::is_same_v<T, __half>) {
    float r;
    asm volatile("cvt.f32.f16 %0, %1;" : "=f"(r)
                 : "h"(reinterpret_cast<const unsigned short*>(pk.v)[i]));
    return r;
  } else {
    return pk.v[i];
  }
}

// 8 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(s), "l"(gmem) : "memory");
}

// y = (x - mean) * rstd * w + b for the VEC values of chunk c, stored as TX;
// w and b (dtype TW) from device memory
template <typename TX, typename TW, int VEC>
__device__ __forceinline__ void emit(TX* yr, const TW* w, const TW* b, int c,
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
      load_f32<TW, VEC>(b + (int64_t)c * VEC, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] += bv[i];
    }
  }
  store_f32<TX, VEC>(yr + (int64_t)c * VEC, out);
}

// The register path: a group of `lanes` lanes a row, NV 16-byte vectors of
// it a lane (h / VEC <= lanes * NV; h % VEC == 0 and x, y, w, b aligned for
// their vectors, by the host's choice).
template <typename TX, typename TW, int NV>
__global__ void __launch_bounds__(kThreads, fwd_blocks_per_sm(NV))
ln_fwd_rows(const TX* __restrict__ x, const TW* __restrict__ w,
            const TW* __restrict__ b, TX* __restrict__ y,
            float* __restrict__ mean_out, float* __restrict__ rstd_out,
            int64_t n, int h, int lanes, float eps, bool rms, bool has_w,
            bool has_b) {
  constexpr int VEC = 16 / sizeof(TX);
  using XPack = Pack<TX, VEC>;
  using WPack = Pack<TW, VEC>;
  extern __shared__ __align__(16) unsigned char ln_smem[];
  TW* const ws = reinterpret_cast<TW*>(ln_smem);   // [h] weight, then [h] bias
  TW* const bs = ws + h;

  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);              // lane within the row's group
  const int per_warp = 32 / lanes;                 // rows a warp takes at once
  const int warps = blockDim.x >> 5;
  const int nvec = h / VEC;
  // the warp's first rows and the step to its next ones (uniform over the
  // warp, so every lane runs every shuffle); this group's row is r0 + group
  const int64_t first = ((int64_t)blockIdx.x * warps + (threadIdx.x >> 5)) * per_warp;
  const int64_t step = (int64_t)gridDim.x * warps * per_warp;
  const int group = lane / lanes;

  XPack cur[NV], nxt[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[k].v[i] = nxt[k].v[i] = from_f32<TX>(0.f);
  }
  auto load_row = [&](XPack (&dst)[NV], int64_t row) {
    if (row < n) {
      const XPack* xr = reinterpret_cast<const XPack*>(x + row * h);
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (sub + lanes * k < nvec) dst[k] = xr[sub + lanes * k];
    }
  };

  // the first row's loads, then the weight's and bias's copy: in flight together
  load_row(cur, first + group);
  if (has_w) {
    const int bytes = h * (int)sizeof(TW);
    const unsigned char* wg = reinterpret_cast<const unsigned char*>(w);
    const unsigned char* bg = reinterpret_cast<const unsigned char*>(b);
    for (int i = threadIdx.x * 8; i < bytes; i += blockDim.x * 8) {
      cp_async8(ln_smem + i, wg + i);
      if (has_b) cp_async8(ln_smem + bytes + i, bg + i);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const float fh = (float)h;
  for (int64_t r0 = first; r0 < n; r0 += step) {
    const int64_t row = r0 + group;
    load_row(nxt, row + step);                     // the next row, ahead of this one's work

    // each lane sums its values in order, vector by vector, then the group
    // sums the lanes: with 32 lanes a row, the order of every operation of
    // the one-warp-a-row kernel this replaces, so the same bits
    float mean = 0.f;
    if (!rms) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (sub + lanes * k < nvec) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) s += fresh_f32(cur[k], i);
        }
      mean = group_sum(s, lanes) / fh;
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (sub + lanes * k < nvec) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = fresh_f32(cur[k], i) - mean;
          ss += d * d;
        }
      }
    const float rstd = rsqrtf(group_sum(ss, lanes) / fh + eps);

    if (row < n) {
      XPack* yr = reinterpret_cast<XPack*>(y + row * h);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = sub + lanes * k;
        if (c < nvec) {
          float out[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) out[i] = (fresh_f32(cur[k], i) - mean) * rstd;
          if (has_w) {
            const WPack wv = *reinterpret_cast<const WPack*>(ws + c * VEC);
#pragma unroll
            for (int i = 0; i < VEC; ++i) out[i] *= to_f32(wv.v[i]);
            if (has_b) {
              const WPack bv = *reinterpret_cast<const WPack*>(bs + c * VEC);
#pragma unroll
              for (int i = 0; i < VEC; ++i) out[i] += to_f32(bv.v[i]);
            }
          }
          XPack pk;
#pragma unroll
          for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<TX>(out[i]);
          yr[c] = pk;
        }
      }
      if (sub == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
}

// Rows longer than the registers, and the scalar path (VEC 1: an unaligned
// input or h % (16 / sizeof(TX)) != 0): one warp a row, the warps striding
// over the rows; three sweeps, the second and third read the row again.
template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_stream(const TX* __restrict__ x, const TW* __restrict__ w,
              const TW* __restrict__ b, TX* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int64_t n, int h, float eps, bool rms, bool has_w, bool has_b) {
  const int lane = threadIdx.x & 31;
  const int nvec = h / VEC;
  const float fh = (float)h;
  const int64_t step = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); row < n;
       row += step) {
    const TX* xr = x + row * h;
    TX* yr = y + row * h;
    float v[VEC];
    float mean = 0.f;
    if (!rms) {
      float s = 0.f;
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
    const float rstd = rsqrtf(warp_sum(ss) / fh + eps);
    for (int c = lane; c < nvec; c += 32) {
      load_f32<TX, VEC>(xr + (int64_t)c * VEC, v);
      emit<TX, TW, VEC>(yr, w, b, c, v, mean, rstd, has_w, has_b);
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
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
  int lanes, vecs, warps, blocks;   // ops/layer_norm.py's fwd_grid
  cudaStream_t stream;
};

template <typename TX, typename TW, int NV>
cudaError_t launch_rows(const Args& a) {
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
  const size_t smem = (has_w + has_b) * (size_t)a.h * sizeof(TW);
  ln_fwd_rows<TX, TW, NV><<<a.blocks, 32 * a.warps, smem, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), static_cast<const TW*>(a.b),
      static_cast<TX*>(a.y), a.mean, a.rstd, a.n, a.h, a.lanes, a.eps, a.rms, has_w, has_b);
  return cudaGetLastError();
}

template <typename TX, typename TW, int VEC>
cudaError_t launch_stream(const Args& a) {
  ln_fwd_stream<TX, TW, VEC><<<a.blocks, 32 * a.warps, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), static_cast<const TW*>(a.b),
      static_cast<TX*>(a.y), a.mean, a.rstd, a.n, a.h, a.eps, a.rms, a.w != nullptr,
      a.b != nullptr);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 16 / sizeof(TX);
  const bool vec = a.h % VEC == 0 && aligned(a.x, 16) && aligned(a.y, 16) &&
                   aligned(a.w, pack_align(sizeof(TW) * VEC)) &&
                   aligned(a.b, pack_align(sizeof(TW) * VEC));
  if (!vec) return launch_stream<TX, TW, 1>(a);
  if (a.vecs == 0) return launch_stream<TX, TW, VEC>(a);
  if ((int64_t)a.lanes * a.vecs < a.h / VEC) return cudaErrorInvalidValue;
  switch (a.vecs) {
    case 1: return launch_rows<TX, TW, 1>(a);
    case 2: return launch_rows<TX, TW, 2>(a);
    case 3: return launch_rows<TX, TW, 3>(a);
    case 4: return launch_rows<TX, TW, 4>(a);
    case 5: return launch_rows<TX, TW, 5>(a);
    case 6: return launch_rows<TX, TW, 6>(a);
    case 8: return launch_rows<TX, TW, 8>(a);
  }
  if constexpr (sizeof(TX) == 4) {   // fp32 rows keep up to 16 vectors a lane
    if (a.vecs == 12) return launch_rows<TX, TW, 12>(a);
    if (a.vecs == 16) return launch_rows<TX, TW, 16>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t by_weight(int w_dtype, const Args& a) {
  switch (w_dtype) {
    case kF32: return launch<TX, float>(a);
    case kBF16: return launch<TX, __nv_bfloat16>(a);
    case kF16: return launch<TX, __half>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: [n, h] contiguous, dtype x_dtype; w, b: [h] contiguous or null, both
// of dtype w_dtype (ignored when w is null; a bias needs a weight); mean,
// rstd: [n] fp32.  Dtype codes: 0 fp32, 1 bf16, 2 fp16.  The grid from
// ops/layer_norm.py's fwd_grid: `lanes` (8, 16 or 32) a row and `vecs` 16-
// byte vectors of it a lane (0: the streaming kernel), `warps` (1-8) a block
// and `blocks`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* y, void* mean, void* rstd,
                                   long long n, int h, float eps, int rms,
                                   int x_dtype, int w_dtype, int lanes, int vecs,
                                   int warps, int blocks, void* stream) {
  if (n < 1 || h < 1 || (b != nullptr && w == nullptr)) return cudaErrorInvalidValue;
  if ((lanes != 8 && lanes != 16 && lanes != 32) || vecs < 0 || warps < 1 ||
      warps > kMaxWarpsPerBlock || blocks < 1)
    return cudaErrorInvalidValue;
  const Args a{x, w, b, y, static_cast<float*>(mean), static_cast<float*>(rstd),
               (int64_t)n, h, eps, rms != 0, lanes, vecs, warps, blocks,
               static_cast<cudaStream_t>(stream)};
  // an absent weight takes x's dtype: its type is then never read
  if (w == nullptr) w_dtype = x_dtype;
  cudaError_t err;
  switch (x_dtype) {
    case kF32: err = by_weight<float>(w_dtype, a); break;
    case kBF16: err = by_weight<__nv_bfloat16>(w_dtype, a); break;
    case kF16: err = by_weight<__half>(w_dtype, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
