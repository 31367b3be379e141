// The multi-tensor kernels under the optimizers, for Hopper (sm_90a):
// mt_l2norm, mt_scale, mt_adam and mt_lamb, each one launch (mt_l2norm and
// mt_lamb two) over every tensor of a call, on the walker of
// multi_tensor_apply.cuh.
//
// Replaces: no Pallas kernel.  The JAX package runs each of these as one
// XLA loop over the pytree (apex_tpu/multi_tensor_apply/__init__.py:73
// multi_tensor_l2norm, :49 multi_tensor_scale;
// apex_tpu/optimizers/fused_adam.py:65 FusedAdam._update and
// apex_tpu/contrib/openfold_triton/fused_adam_swa.py's step;
// apex_tpu/optimizers/fused_lamb.py:134 FusedLAMB._update); the CUDA
// original is Apex's amp_C family (multi_tensor_l2norm_kernel.cu,
// multi_tensor_scale_kernel.cu, multi_tensor_adam.cu, multi_tensor_lamb.cu).
//
// Bound: bytes.  Each element is read once per list and written once per
// output list, against a few dozen operations: Adam over bf16 p, g, m and v
// moves 14 bytes an element, over fp32 masters and moments with an fp16
// gradient and copy-back 30.  The design keeps every byte single-pass: the
// gradient is read in place (multiplied by a device inv_scale, never copied
// to fp32), the master's copy-back into the half parameter is fused into the
// same pass, and a set noop flag (the loss scaler's found_inf) returns
// before any load, so a skipped step moves nothing and changes no bit.
//
// Arithmetic: every value in fp32, each output stored in its own dtype
// (round to nearest even); the expressions follow the plain versions of
// ops/multi_tensor.py term for term.  nvcc contracts a * b + c into FMAs
// where the plain version rounds twice, so the two agree to a few fp32
// roundings, not bit for bit.  mt_lamb's two stages compute the update with
// explicit rounding intrinsics, so stage 2's recomputation has stage 1's
// bits.  Sums are taken in a fixed order (per chunk, then per tensor, then
// over tensors; no atomics): the same inputs give the same bits.
//
// C interface (loaded with ctypes): every entry returns cudaGetLastError()
// after its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "multi_tensor_apply.cuh"

namespace {

// ---------------------------------------------------------------------------
// mt_l2norm: sums of squares per chunk, then per tensor and over all
// ---------------------------------------------------------------------------

// partials[c] = sum over chunk c of (x * inv_scale)^2, in fp32
__global__ void __launch_bounds__(kMtThreads)
mt_l2norm_chunks(MtTable tb, const float* __restrict__ inv_scale, float* __restrict__ partials) {
  __shared__ float red[32];
  const float inv = inv_scale ? *inv_scale : 1.f;
  for (int c = blockIdx.x; c < tb.C; c += gridDim.x) {
    const MtChunk k = mt_chunk(tb, c);
    float acc = 0.f;
    mt_sweep(k, [&](auto w, int i) {
      constexpr int N = decltype(w)::value;
      float x[N];
      mt_load<N>(k, 0, i, x);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float y = x[e] * inv;
        acc = fmaf(y, y, acc);
      }
    });
    const float s = mt_block_sum(acc, red);
    if (threadIdx.x == 0) partials[c] = s;
  }
}

// one block: each tensor's chunk partials summed by one warp (lanes in
// stride, then xor shuffles), the tensors' sums in order by the block;
// out = [global norm, per-tensor norms...], flag = 1 where the global sum
// is not finite (an inf or NaN in the input, or squares past fp32's range,
// as Apex's l2norm flags it).  tensor_sq [T] is scratch.
__global__ void __launch_bounds__(1024)
mt_l2norm_finish(MtTable tb, const float* __restrict__ partials, float* __restrict__ tensor_sq,
                 float* __restrict__ out, int* __restrict__ flag) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int t = warp; t < tb.T; t += warps) {
    const int first = tb.first_chunk(t), count = tb.chunk_count(t);
    float s = 0.f;
    for (int j = lane; j < count; j += 32) s += partials[first + j];
    s = warp_sum(s);
    if (lane == 0) {
      tensor_sq[t] = s;
      out[1 + t] = sqrtf(s);
    }
  }
  __syncthreads();
  float s = 0.f;
  for (int t = threadIdx.x; t < tb.T; t += blockDim.x) s += tensor_sq[t];
  s = mt_block_sum(s, red);
  if (threadIdx.x == 0) {
    out[0] = sqrtf(s);
    *flag = isfinite(s) ? 0 : 1;
  }
}

// ---------------------------------------------------------------------------
// mt_scale: out = in * scale, and a flag on any inf or NaN in the input
// ---------------------------------------------------------------------------

// lists: 0 in, 1 out (absent: the check-only form).  flag (a bool byte,
// zeroed by the caller) is set to 1 by any block that finds an inf or a
// NaN; null: no flag.  scale_ptr: a device fp32 scale, else `scale`.
__global__ void __launch_bounds__(kMtThreads)
mt_scale_kernel(MtTable tb, const float* __restrict__ scale_ptr, float scale,
                uint8_t* __restrict__ flag) {
  const float s = scale_ptr ? *scale_ptr : scale;
  for (int c = blockIdx.x; c < tb.C; c += gridDim.x) {
    const MtChunk k = mt_chunk(tb, c);
    const bool out = tb.L > 1 && k.has(1);
    bool finite = true;
    mt_sweep(k, [&](auto w, int i) {
      constexpr int N = decltype(w)::value;
      float x[N];
      mt_load<N>(k, 0, i, x);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        finite = finite && isfinite(x[e]);
        x[e] = x[e] * s;
      }
      if (out) mt_store<N>(k, 1, i, x);
    });
    if (__syncthreads_or(!finite) && threadIdx.x == 0 && flag) *flag = 1;
  }
}

// ---------------------------------------------------------------------------
// mt_adam: FusedAdam (L2 or decoupled decay) and FusedAdamSWA's three modes
// ---------------------------------------------------------------------------

enum AdamMode { kAdamL2 = 0, kAdamW = 1, kSwaApexAdam = 2, kSwaApexAdamW = 3, kSwaPyTorchAdam = 4 };

struct AdamArgs {
  float lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps, wd;
  float decay;       // 1 - lr wd, AdamW's factor on p
  float swa_weight;  // 1 - swa_decay_rate
  int mode, swa_start;
  const float* inv_scale;
  const float* bc1;
  const float* bc2;
  const bool* noop;
  const int* step;        // SWA: the step this update makes (the old one + 1)
  const int* n_averaged;  // SWA: averages taken before it
};

// lists: 0 g, 1 the target (the parameter or its fp32 master), 2 m, 3 v,
// 4 an optional copy of the new target in the model parameter's dtype, 5
// the fp32 SWA average (SWA modes)
__global__ void __launch_bounds__(kMtThreads) mt_adam_kernel(MtTable tb, AdamArgs a) {
  // a set flag: no load, no store (every bit as it was)
  if (a.noop && *a.noop) return;
  const float inv = a.inv_scale ? *a.inv_scale : 1.f;
  const float bc1 = a.bc1 ? *a.bc1 : 1.f, bc2 = a.bc2 ? *a.bc2 : 1.f;
  const bool swa = a.mode >= kSwaApexAdam;
  const bool do_swa = swa && *a.step > a.swa_start;
  const bool first_average = swa && *a.n_averaged == 0;
  const float lr_bc1 = a.lr / bc1, sqrt_bc2 = sqrtf(bc2);
  for (int c = blockIdx.x; c < tb.C; c += gridDim.x) {
    const MtChunk k = mt_chunk(tb, c);
    const bool copy = tb.L > 4 && k.has(4);
    mt_sweep(k, [&](auto w, int i) {
      constexpr int N = decltype(w)::value;
      float g[N], p[N], m[N], v[N], avg[N];
      mt_load<N>(k, 0, i, g);
      mt_load<N>(k, 1, i, p);
      mt_load<N>(k, 2, i, m);
      mt_load<N>(k, 3, i, v);
      if (do_swa) mt_load<N>(k, 5, i, avg);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float ge = g[e] * inv;
        if (!swa) {
          // FusedAdam (optimizers/fused_adam.py's plain version): bc1
          // folded into the denominator
          if (a.mode == kAdamL2 && a.wd != 0.f) ge = p[e] * a.wd + ge;
          m[e] = m[e] * a.beta1 + a.one_minus_beta1 * ge;
          v[e] = v[e] * a.beta2 + a.one_minus_beta2 * ge * ge;
          const float denom = (sqrtf(v[e] / bc2) + a.eps) * bc1;
          if (a.mode == kAdamW && a.wd != 0.f) p[e] = p[e] * a.decay;
          p[e] = p[e] + (-a.lr) * (m[e] / denom);
        } else {
          // FusedAdamSWA (the JAX function's expressions in its order)
          if (a.mode != kSwaApexAdamW) ge = ge + a.wd * p[e];
          m[e] = a.beta1 * m[e] + a.one_minus_beta1 * ge;
          v[e] = a.beta2 * v[e] + a.one_minus_beta2 * ge * ge;
          if (a.mode == kSwaPyTorchAdam) {
            const float denom = sqrtf(v[e]) / sqrt_bc2 + a.eps;
            p[e] = p[e] - lr_bc1 * (m[e] / denom);
          } else {
            float u = (m[e] / bc1) / (sqrtf(v[e] / bc2) + a.eps);
            if (a.mode == kSwaApexAdamW) u = u + a.wd * p[e];
            p[e] = p[e] - a.lr * u;
          }
          if (do_swa) avg[e] = first_average ? p[e] : avg[e] + a.swa_weight * (p[e] - avg[e]);
        }
      }
      mt_store<N>(k, 1, i, p);
      mt_store<N>(k, 2, i, m);
      mt_store<N>(k, 3, i, v);
      if (copy) mt_store<N>(k, 4, i, p);
      if (do_swa) mt_store<N>(k, 5, i, avg);
    });
  }
}

// ---------------------------------------------------------------------------
// mt_lamb: stage 1 (moments, per-chunk ||p||^2 and ||u||^2), stage 2 (the
// trust ratio and the apply)
// ---------------------------------------------------------------------------

struct LambArgs {
  float beta1, beta3, beta2, one_minus_beta2, eps, wd, lr;
  int adam_w, use_ratio, apply, stage1, n_ratio;
  const float* inv_scale;
  const float* clip;
  const float* bc1;
  const float* bc2;
  const float* lr_ptr;
  const bool* noop;
  const float* norms;  // apply form: [2 n_ratio] p norms, then u norms
};

struct LambScalars {
  float inv, clip, bc1, bc2;
};

// the new moments, from g, p and the old moments; every rounding explicit,
// so both stages compute the same bits
__device__ __forceinline__ void lamb_moments(float g, float p, float& m, float& v,
                                             const LambArgs& a, const LambScalars& s) {
  g = __fdiv_rn(__fmul_rn(g, s.inv), s.clip);
  if (!a.adam_w && a.wd != 0.f) g = __fmaf_rn(a.wd, p, g);
  m = __fmaf_rn(a.beta3, g, __fmul_rn(m, a.beta1));
  v = __fmaf_rn(__fmul_rn(a.one_minus_beta2, g), g, __fmul_rn(v, a.beta2));
}

// the raw update from the new moments and the old p
__device__ __forceinline__ float lamb_update(float p, float m, float v, const LambArgs& a,
                                             const LambScalars& s) {
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), a.eps));
  if (a.adam_w && a.wd != 0.f) u = __fmaf_rn(a.wd, p, u);
  return u;
}

__device__ __forceinline__ LambScalars lamb_scalars(const LambArgs& a) {
  return LambScalars{a.inv_scale ? *a.inv_scale : 1.f, a.clip ? *a.clip : 1.f,
                     a.bc1 ? *a.bc1 : 1.f, a.bc2 ? *a.bc2 : 1.f};
}

// a tensor whose moments are both fp32 keeps stage 1's moments in place;
// stage 2 reads them back.  Other tensors' moments are written by stage 2,
// which recomputes them from the old ones (rounded 16-bit moments could not
// give back stage 1's update).
__device__ __forceinline__ bool lamb_stored(const MtChunk& k) {
  return k.dtype(2) == kF32 && k.dtype(3) == kF32;
}

// lists: 0 g, 1 the target, 2 m, 3 v (4: the copy, stage 2 only)
// partials[2c] = chunk c's sum of p^2, [2c + 1] of u^2
__global__ void __launch_bounds__(kMtThreads)
mt_lamb_stage1(MtTable tb, LambArgs a, float* __restrict__ partials) {
  if (a.noop && *a.noop) return;
  __shared__ float red[32];
  const LambScalars s = lamb_scalars(a);
  for (int c = blockIdx.x; c < tb.C; c += gridDim.x) {
    const MtChunk k = mt_chunk(tb, c);
    const bool stored = lamb_stored(k);
    float pp = 0.f, uu = 0.f;
    mt_sweep(k, [&](auto w, int i) {
      constexpr int N = decltype(w)::value;
      float g[N], p[N], m[N], v[N];
      mt_load<N>(k, 0, i, g);
      mt_load<N>(k, 1, i, p);
      mt_load<N>(k, 2, i, m);
      mt_load<N>(k, 3, i, v);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        lamb_moments(g[e], p[e], m[e], v[e], a, s);
        const float u = lamb_update(p[e], m[e], v[e], a, s);
        pp = fmaf(p[e], p[e], pp);
        uu = fmaf(u, u, uu);
      }
      if (stored) {
        mt_store<N>(k, 2, i, m);
        mt_store<N>(k, 3, i, v);
      }
    });
    const float sp = mt_block_sum(pp, red);
    const float su = mt_block_sum(uu, red);
    if (threadIdx.x == 0) {
      partials[2 * c] = sp;
      partials[2 * c + 1] = su;
    }
  }
}

// the trust ratio of tensor t: ||p|| / ||u|| (1 where either is 0, or
// without use_ratio), from stage 1's chunk partials summed by warp 0 in a
// fixed order, or in the apply form from the given norms
__device__ __forceinline__ float lamb_ratio(const MtTable& tb, int t, const LambArgs& a,
                                            const float* partials, float* shared) {
  if (!a.use_ratio || t >= a.n_ratio) return 1.f;
  if (a.apply) {
    const float pn = a.norms[t], un = a.norms[a.n_ratio + t];
    return (pn > 0.f && un > 0.f) ? pn / un : 1.f;
  }
  __syncthreads();  // every thread is done with the previous ratio
  if (threadIdx.x < 32) {
    const int first = tb.first_chunk(t), count = tb.chunk_count(t);
    float sp = 0.f, su = 0.f;
    for (int j = threadIdx.x; j < count; j += 32) {
      sp += partials[2 * (first + j)];
      su += partials[2 * (first + j) + 1];
    }
    sp = warp_sum(sp);
    su = warp_sum(su);
    if (threadIdx.x == 0) {
      const float pn = sqrtf(sp), un = sqrtf(su);
      shared[0] = (pn > 0.f && un > 0.f) ? pn / un : 1.f;
    }
  }
  __syncthreads();
  return shared[0];
}

// lists: 0 g, 1 the target, 2 m, 3 v, 4 the optional copy; in the apply
// form 0 the target, 1 the update
__global__ void __launch_bounds__(kMtThreads)
mt_lamb_stage2(MtTable tb, LambArgs a, const float* __restrict__ partials) {
  if (a.noop && *a.noop) return;
  __shared__ float ratio_s[1];
  const LambScalars s = lamb_scalars(a);
  const float lr = a.lr_ptr ? *a.lr_ptr : a.lr;
  for (int c = blockIdx.x; c < tb.C; c += gridDim.x) {
    const MtChunk k = mt_chunk(tb, c);
    const float step = lr * lamb_ratio(tb, k.t, a, partials, ratio_s);
    if (a.apply) {
      mt_sweep(k, [&](auto w, int i) {
        constexpr int N = decltype(w)::value;
        float p[N], u[N];
        mt_load<N>(k, 0, i, p);
        mt_load<N>(k, 1, i, u);
#pragma unroll
        for (int e = 0; e < N; ++e) p[e] = __fmaf_rn(-step, u[e], p[e]);
        mt_store<N>(k, 0, i, p);
      });
      continue;
    }
    // moments from stage 1, or recomputed here from the old ones
    const bool recompute = !(a.stage1 && lamb_stored(k));
    const bool copy = tb.L > 4 && k.has(4);
    mt_sweep(k, [&](auto w, int i) {
      constexpr int N = decltype(w)::value;
      float g[N], p[N], m[N], v[N];
      if (recompute) mt_load<N>(k, 0, i, g);
      mt_load<N>(k, 1, i, p);
      mt_load<N>(k, 2, i, m);
      mt_load<N>(k, 3, i, v);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (recompute) lamb_moments(g[e], p[e], m[e], v[e], a, s);
        const float u = lamb_update(p[e], m[e], v[e], a, s);
        p[e] = __fmaf_rn(-step, u, p[e]);
      }
      mt_store<N>(k, 1, i, p);
      if (recompute) {
        mt_store<N>(k, 2, i, m);
        mt_store<N>(k, 3, i, v);
      }
      if (copy) mt_store<N>(k, 4, i, p);
    });
  }
}

MtTable table(const void* words, int T, int L, int C, int chunk) {
  return MtTable{static_cast<const int64_t*>(words), T, L, C, chunk};
}

}  // namespace

// table: the walker's int64 words on the device (multi_tensor_apply.cuh);
// inv_scale: null or a device fp32; partials: fp32 [C + T] scratch; out:
// fp32 [1 + T] (the global norm, then each tensor's); flag: int32 [1].
extern "C" int apex_mt_l2norm(const void* words, int T, int L, int C, int chunk,
                              const void* inv_scale, void* partials, void* out, void* flag,
                              void* stream) {
  if (T < 1 || L != 1 || C < 0) return cudaErrorInvalidValue;
  const MtTable tb = table(words, T, L, C, chunk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (C > 0)
    mt_l2norm_chunks<<<mt_grid(mt_l2norm_chunks, C), kMtThreads, 0, st>>>(
        tb, static_cast<const float*>(inv_scale), part);
  mt_l2norm_finish<<<1, 1024, 0, st>>>(tb, part, part + C, static_cast<float*>(out),
                                        static_cast<int*>(flag));
  return (int)cudaGetLastError();
}

// lists: in, and out (L = 2) or none (L = 1, the check-only form); scale:
// scale_ptr (a device fp32) if not null, else `scale`; flag: a bool byte or
// null.
extern "C" int apex_mt_scale(const void* words, int T, int L, int C, int chunk,
                             const void* scale_ptr, float scale, void* flag, void* stream) {
  if (T < 1 || L < 1 || L > 2 || C < 1) return cudaErrorInvalidValue;
  const MtTable tb = table(words, T, L, C, chunk);
  mt_scale_kernel<<<mt_grid(mt_scale_kernel, C), kMtThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      tb, static_cast<const float*>(scale_ptr), scale, static_cast<uint8_t*>(flag));
  return (int)cudaGetLastError();
}

// lists: g, target, m, v, copy, swa (L = 6; absent lists have 0 pointers).
// mode: 0 Adam with L2 decay, 1 AdamW, 2-4 the SWA modes (ApexAdam,
// ApexAdamW, PyTorchAdam).  The pointers are device scalars or null (inv
// 1, bc 1, no noop); step and n_averaged int32, read by the SWA modes.
extern "C" int apex_mt_adam(const void* words, int T, int L, int C, int chunk, int mode,
                            float lr, float beta1, float beta2, float one_minus_beta1,
                            float one_minus_beta2, float eps, float wd, float decay,
                            float swa_weight, int swa_start, const void* inv_scale,
                            const void* bc1, const void* bc2, const void* noop, const void* step,
                            const void* n_averaged, void* stream) {
  if (T < 1 || L != 6 || C < 1 || mode < kAdamL2 || mode > kSwaPyTorchAdam)
    return cudaErrorInvalidValue;
  if (mode >= kSwaApexAdam && (step == nullptr || n_averaged == nullptr))
    return cudaErrorInvalidValue;
  AdamArgs a{lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps, wd, decay, swa_weight,
             mode, swa_start, static_cast<const float*>(inv_scale),
             static_cast<const float*>(bc1), static_cast<const float*>(bc2),
             static_cast<const bool*>(noop), static_cast<const int*>(step),
             static_cast<const int*>(n_averaged)};
  mt_adam_kernel<<<mt_grid(mt_adam_kernel, C), kMtThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(table(words, T, L, C, chunk), a);
  return (int)cudaGetLastError();
}

// apply = 0: lists g, target, m, v, copy (L = 5); stage 1 runs where
// use_ratio (its partials fp32 [2 C]), then stage 2.  apply = 1: lists
// target, update (L = 2); stage 2 alone, with the norms [2 n_ratio] when
// use_ratio.  Tensors past n_ratio take the ratio 1.  lr_ptr: a device lr,
// or null for `lr`.
extern "C" int apex_mt_lamb(const void* words, int T, int L, int C, int chunk, int apply,
                            float beta1, float beta3, float beta2, float one_minus_beta2,
                            float eps, float wd, float lr, int adam_w, int use_ratio,
                            int n_ratio, const void* inv_scale, const void* clip,
                            const void* bc1, const void* bc2, const void* lr_ptr,
                            const void* noop, const void* norms, void* partials,
                            void* stream) {
  if (T < 1 || C < 1 || L != (apply ? 2 : 5)) return cudaErrorInvalidValue;
  if (use_ratio && (apply ? norms == nullptr : partials == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MtTable tb = table(words, T, L, C, chunk);
  const int stage1 = !apply && use_ratio;
  LambArgs a{beta1, beta3, beta2, one_minus_beta2, eps, wd, lr, adam_w, use_ratio, apply,
             stage1, n_ratio, static_cast<const float*>(inv_scale),
             static_cast<const float*>(clip), static_cast<const float*>(bc1),
             static_cast<const float*>(bc2), static_cast<const float*>(lr_ptr),
             static_cast<const bool*>(noop), static_cast<const float*>(norms)};
  float* part = static_cast<float*>(partials);
  if (stage1) mt_lamb_stage1<<<mt_grid(mt_lamb_stage1, C), kMtThreads, 0, st>>>(tb, a, part);
  mt_lamb_stage2<<<mt_grid(mt_lamb_stage2, C), kMtThreads, 0, st>>>(tb, a, part);
  return (int)cudaGetLastError();
}
