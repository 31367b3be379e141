// The multi-tensor kernels under the optimizers, for Hopper (sm_90a):
// mt_l2norm, mt_scale, mt_adam and mt_lamb, each one launch (mt_l2norm
// two) over every tensor of a call, on the walker of multi_tensor_apply.cuh
// (mt_lamb on its group plan, cooperative).
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
// bits.  Sums are taken in a fixed order (per chunk or span, then per
// tensor, then over tensors; no atomics on values): the same inputs give
// the same bits.
//
// C interface (loaded with ctypes): every entry returns cudaGetLastError()
// after its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
// mt_lamb: both stages in one cooperative launch, group by group
// ---------------------------------------------------------------------------
//
// Bound: bytes.  LAMB needs each whole tensor's ||u|| before any element of
// it is applied, so every element is read twice (stage 1: the moments,
// ||p||^2 and ||u||^2; stage 2: the apply) where the roofline counts one
// pass: at GPT-2-large's list (bf16 matrices, fp32 vectors, bf16 moments)
// about 8 bytes read and 6 written an element, 14, against 22 when stage 2
// comes back from device memory.  The design:
//
// - groups (ops/multi_tensor.py `lamb_plan`): runs of consecutive tensors
//   whose g, p, m and v fit a budget B, a tensor larger than B a group of
//   its own.  A group of at most 16,384 elements (LayerNorm pairs, biases)
//   is narrow: one block walks it whole, stage 1, a block barrier, stage 2,
//   no grid barrier.
// - one persistent launch, one block of 512 an SM (cooperative: every
//   block co-resident, so a barrier among blocks cannot deadlock), the
//   grid cut into teams (LAMB_TEAMS, 6 of 22 blocks on an H100); each wide
//   group goes to the team with the fewest bytes so far, whose blocks split
//   its elements evenly in spans of whole 8-element vectors (16-byte
//   aligned).  Per group: stage 1 over the span, a barrier among the
//   team's blocks whose last arrival sums each tensor's span partials once,
//   in a fixed order, into its trust ratio, then stage 2 over the span in
//   the reverse order, so the bytes stage 1 read last, which L2 still
//   holds, come first.  A group's fixed costs (its pieces' setup, the
//   ring's fill, the barrier: ~9 us of serial latency with every block in
//   every group) weigh less when fewer blocks take longer spans of it and
//   the other teams stream meanwhile (tools/lamb_variants.py at
//   GPT-2-large's 146 wide groups: 1 team 8.3 ms, 6 teams 6.3).
// - the ring: each thread's 8-element vectors of g, p, m and v reach
//   shared memory by cp.async two rounds ahead of its arithmetic (three
//   stages), per thread, with no block barrier; stage 2's first round is
//   issued before the group's barrier.  With plain loads a thread waits on
//   each round's loads between its long arithmetic; 128 registers, no
//   spill: two blocks an SM would cap them at 64 and spill.
// - L2 hints: stage 1 marks the last B bytes of each group (each block's
//   share) evict_last by a prefetch, stage 2 stores with evict_first (no
//   measured effect either way: about 0.1 ms).
//
// Stage 2 recomputes the update: a tensor whose moments are both fp32 keeps
// stage 1's moments in place and stage 2 reads them back; 16-bit moments it
// recomputes from the old ones (the rounded moments could not give back
// stage 1's update).  Both stages call the same functions with every
// rounding explicit, so they compute the same bits.  A tensor from
// n_ratio on, or every tensor without use_ratio, takes ratio 1: no stage 1
// and no barrier for it.  A set noop returns before any load.

struct LambArgs {
  float beta1, beta3, beta2, one_minus_beta2, eps, wd, lr;
  int adam_w, use_ratio, n_ratio;
  int64_t budget;  // B: each group's last B bytes of stage-1 reads are kept in L2
  const float* inv_scale;
  const float* clip;
  const float* bc1;
  const float* bc2;
  const float* lr_ptr;
  const bool* noop;
};

// The plain version divides by clip, bc1 and bc2 element by element; here
// each is one correctly rounded reciprocal a launch, multiplied in (three
// of an element's four divisions gone: the arithmetic binds, 7.1 against
// 6.3 ms by tools/lamb_variants.py's `divisions`).  Each product sits within 3 fp32 roundings of
// the plain version's quotient, inside _mt_lamb_tols (chip_smoke.py): the
// moments' 2^-21 of their gradient term and the update's 2^-22 of its
// terms; stage 1 and stage 2 still compute the same bits.
struct LambScalars {
  float inv, rclip, rbc1, rbc2;
};

// the new moments, from g, p and the old moments; every rounding explicit,
// so both stages compute the same bits
__device__ __forceinline__ void lamb_moments(float g, float p, float& m, float& v,
                                             const LambArgs& a, const LambScalars& s) {
  g = __fmul_rn(__fmul_rn(g, s.inv), s.rclip);
  if (!a.adam_w && a.wd != 0.f) g = __fmaf_rn(a.wd, p, g);
  m = __fmaf_rn(a.beta3, g, __fmul_rn(m, a.beta1));
  v = __fmaf_rn(__fmul_rn(a.one_minus_beta2, g), g, __fmul_rn(v, a.beta2));
}

// the raw update from the new moments and the old p
__device__ __forceinline__ float lamb_update(float p, float m, float v, const LambArgs& a,
                                             const LambScalars& s) {
  float u = __fdiv_rn(__fmul_rn(m, s.rbc1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.rbc2)), a.eps));
  if (a.adam_w && a.wd != 0.f) u = __fmaf_rn(a.wd, p, u);
  return u;
}

__device__ __forceinline__ LambScalars lamb_scalars(const LambArgs& a) {
  return LambScalars{a.inv_scale ? *a.inv_scale : 1.f, a.clip ? __frcp_rn(*a.clip) : 1.f,
                     a.bc1 ? __frcp_rn(*a.bc1) : 1.f, a.bc2 ? __frcp_rn(*a.bc2) : 1.f};
}

__device__ __forceinline__ bool lamb_stored(const MtChunk& k) {
  return k.dtype(2) == kF32 && k.dtype(3) == kF32;
}

// The group plan (ops/multi_tensor.py `lamb_plan`), int64 words after the
// table's, for G blocks:
//   desc    4 a group: first tensor | end tensor << 32, the span S of each
//           block, the group's padded elements E, the bytes of its g, p, m, v
//   offsets T: each tensor's virtual offset in its group (the group's
//           tensors laid end to end, each padded to 8 elements)
//   blocks  T: the blocks whose spans reach the tensor, b_lo | b_end << 32
//           (a wide group's tensors; the ratio pass reads their partials)
//   order   the wide groups, then the narrow ones (E <= LAMB_NARROW,
//           16,384: one block walks each, block b the b-th, b + G-th, ...),
//           each list in table order
//   teams   teams + 1: where each team's wide ordinals start in `mine`
//   mine    the wide ordinals team by team (a team's Gt = G / teams blocks
//           walk each of its groups, a barrier among them each)
//   pieces  Gt a wide group: the tensors [first, end) whose elements reach
//           team block bt's span [bt S, bt S + S), first | end << 32
//
// Block b is block bt = b % Gt of team b / Gt.
struct LambPlan {
  const int64_t* w;
  int groups, wide, teams, T, G;

  __device__ __forceinline__ const int64_t* desc(int gi) const { return w + 4 * (int64_t)gi; }
  __device__ __forceinline__ int64_t vbeg(int t) const { return w[4 * (int64_t)groups + t]; }
  __device__ __forceinline__ int64_t blocks(int t) const {
    return w[4 * (int64_t)groups + T + t];
  }
  __device__ __forceinline__ int order(int q) const {
    return (int)w[4 * (int64_t)groups + 2 * (int64_t)T + q];
  }
  __device__ __forceinline__ int team_first(int tm) const {
    return (int)w[4 * (int64_t)groups + 2 * (int64_t)T + groups + tm];
  }
  __device__ __forceinline__ int mine(int i) const {
    return (int)w[4 * (int64_t)groups + 2 * (int64_t)T + groups + teams + 1 + i];
  }
  __device__ __forceinline__ int64_t pieces(int wi, int bt) const {
    return w[4 * (int64_t)groups + 2 * (int64_t)T + groups + teams + 1 + wide +
             (int64_t)wi * (G / teams) + bt];
  }
};

struct LambGroup {
  int t0, t1, ta, tz;  // the group's tensors, and block b's [ta, tz)
  int64_t S, E, bytes;
};

// wide group wi (its words, and team block bt's tensors)
__device__ __forceinline__ LambGroup lamb_wide(const LambPlan& pl, int wi, int bt) {
  const int64_t* d = pl.desc(pl.order(wi));
  const int64_t r = d[0], pc = pl.pieces(wi, bt);
  return LambGroup{(int)(r & 0xffffffffLL), (int)(r >> 32), (int)(pc & 0xffffffffLL),
                   (int)(pc >> 32), d[1], d[2], d[3]};
}

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }
__device__ __forceinline__ int64_t imax(int64_t x, int64_t y) { return x > y ? x : y; }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// the block's sums of a and b in a fixed order (mt_block_sum's), both in
// one pass through shared memory; valid in thread 0
__device__ __forceinline__ float2 lamb_block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call's readers are done with red
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      s.x += red[w].x;
      s.y += red[w].y;
    }
  return s;
}

__device__ __forceinline__ float lamb_ratio_of(float sp, float su) {
  const float pn = sqrtf(sp), un = sqrtf(su);
  return (pn > 0.f && un > 0.f) ? pn / un : 1.f;
}

// -- the ring: each thread's 8-element vectors of g, p, m and v, one round
// ahead, in shared memory filled by cp.async (per thread: no barrier) -----
//
// Stage d of the ring holds, list by list, each list's 16-byte chunks of
// the vector a thread takes in one round (one chunk of a 16-bit list, two
// of an fp32 one), chunk-major so a warp's 16-byte reads are
// conflict-free: chunk c of thread i at (d * chunks + c) * kLambThreads +
// i, in units of 16 bytes.  A list's chunk count is its widest dtype's
// (ops/multi_tensor.py `lamb_ring` sizes it from the lists' dtypes).
constexpr int kLambRing = 3;
// mt_lamb's block: 512 threads, one block an SM (128 registers a thread,
// no spill; two blocks of 256 from different teams, to fill one's barrier
// wait with the other's stage, measured 3% slower)
constexpr int kLambThreads = 512;

struct LambRing {
  uint4* base;
  int first[4];  // each list's first chunk
  int chunks;    // chunks a stage

  __device__ __forceinline__ uint4* at(int d, int list, int c) const {
    return base + ((int64_t)(d * chunks + first[list] + c) * kLambThreads + threadIdx.x);
  }
};

// (cp.async takes no L2 cache-policy operand here: with one, the card
// raised an illegal instruction; a kept line is marked by l2_keep)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most kLambRing - 2 groups are in flight: the oldest round is in
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kLambRing - 2) : "memory");
}

__device__ __forceinline__ int dtype_bytes(int code) { return code == kF32 ? 4 : 2; }

// issue vector j of the piece (lists [from_list, 4)) into ring stage d;
// `kept`: its lines are marked to stay in L2 (l2_keep)
__device__ __forceinline__ void ring_issue(const LambRing& rg, const MtChunk& k, int d, int j,
                                           int from_list, bool kept) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    if (l < from_list) continue;
    const int nb = dtype_bytes(k.dtype(l));
    const char* src = reinterpret_cast<const char*>(k.ptr[l]) + (k.start + (int64_t)j * kMtVec) * nb;
    cp_async16(rg.at(d, l, 0), src);
    if (nb == 4) cp_async16(rg.at(d, l, 1), src + 16);
    if (kept) l2_keep(src);
  }
}

// list l's vector from ring stage d, in fp32
__device__ __forceinline__ void ring_read(const LambRing& rg, const MtChunk& k, int d, int l,
                                          float (&o)[kMtVec]) {
  switch (k.dtype(l)) {
    case kF32: {
      Pack<float, kMtVec> pk;
      uint4* u = reinterpret_cast<uint4*>(&pk);
      u[0] = *rg.at(d, l, 0);
      u[1] = *rg.at(d, l, 1);
#pragma unroll
      for (int i = 0; i < kMtVec; ++i) o[i] = pk.v[i];
      break;
    }
    case kBF16: {
      Pack<__nv_bfloat16, kMtVec> pk;
      *reinterpret_cast<uint4*>(&pk) = *rg.at(d, l, 0);
#pragma unroll
      for (int i = 0; i < kMtVec; ++i) o[i] = to_f32(pk.v[i]);
      break;
    }
    default: {
      Pack<__half, kMtVec> pk;
      *reinterpret_cast<uint4*>(&pk) = *rg.at(d, l, 0);
#pragma unroll
      for (int i = 0; i < kMtVec; ++i) o[i] = to_f32(pk.v[i]);
      break;
    }
  }
}

// The piece's vectors round by round through the ring (round q: vector
// q * 512 + thread, counted from the end in reverse): issue(d, j) fills
// stage d with vector j, body(d, j) consumes it; rounds q + 1 .. q +
// kLambRing - 1 are in flight while round q is computed, one commit group
// each.  `primed`: round 0's copies were issued (stage 0) and committed
// before the call.
template <class Issue, class Body>
__device__ __forceinline__ void ring_walk(int nv, bool reverse, bool primed, Issue&& issue,
                                          Body&& body) {
  const int rounds = (nv + kLambThreads - 1) / kLambThreads;
  if (rounds == 0) return;
  const int tid = threadIdx.x;
  auto vec = [&](int q) { return (reverse ? rounds - 1 - q : q) * kLambThreads + tid; };
  for (int q = primed ? 1 : 0; q < kLambRing - 1; ++q) {
    if (q < rounds && vec(q) < nv) issue(q % kLambRing, vec(q));
    cp_async_commit();
  }
  for (int q = 0; q < rounds; ++q) {
    const int ahead = q + kLambRing - 1;
    if (ahead < rounds && vec(ahead) < nv) issue(ahead % kLambRing, vec(ahead));
    cp_async_commit();
    cp_async_wait_oldest();
    if (vec(q) < nv) body(q % kLambRing, vec(q));
  }
}

// Stage 1 over elements [from, to) of tensor t (its virtual offset vb):
// the moments (stored in place where both are fp32), and the block's sums
// of p^2 and u^2 (valid in thread 0).  Loads from virtual position
// keep_from on take `keep`, the rest `stream`.
__device__ __forceinline__ float2 lamb_stage1(const MtTable& tb, const LambRing& rg, int t,
                                              int64_t vb, int64_t from, int64_t to,
                                              int64_t keep_from, uint64_t keep, uint64_t stream,
                                              const LambArgs& a, const LambScalars& s,
                                              float2* red) {
  const MtChunk k = mt_piece(tb, t, from - vb, (int)(to - from));
  const bool stored = lamb_stored(k);
  const int64_t keep_at = keep_from - from;  // the piece's first element kept
  float pp = 0.f, uu = 0.f;
  auto element = [&](float g, float p, float& m, float& v) {
    lamb_moments(g, p, m, v, a, s);
    const float u = lamb_update(p, m, v, a, s);
    pp = fmaf(p, p, pp);
    uu = fmaf(u, u, uu);
  };
  const int nv = k.vec ? k.len / kMtVec : 0;
  ring_walk(
      nv, false, false,
      [&](int d, int j) { ring_issue(rg, k, d, j, 0, j * kMtVec >= keep_at); },
      [&](int d, int j) {
        float g[kMtVec], p[kMtVec], m[kMtVec], v[kMtVec];
        ring_read(rg, k, d, 0, g);
        ring_read(rg, k, d, 1, p);
        ring_read(rg, k, d, 2, m);
        ring_read(rg, k, d, 3, v);
#pragma unroll
        for (int e = 0; e < kMtVec; ++e) element(g[e], p[e], m[e], v[e]);
        if (stored) {
          const uint64_t pol = j * kMtVec >= keep_at ? keep : stream;
          mt_store_vec(k, 2, j * kMtVec, m, pol);
          mt_store_vec(k, 3, j * kMtVec, v, pol);
        }
      });
  // the tail past the last whole vector (or a row whose pointers are not
  // 16-byte aligned), one element at a time
  for (int i = nv * kMtVec + (int)threadIdx.x; i < k.len; i += kLambThreads) {
    float g[1], p[1], m[1], v[1];
    mt_load<1>(k, 0, i, g);
    mt_load<1>(k, 1, i, p);
    mt_load<1>(k, 2, i, m);
    mt_load<1>(k, 3, i, v);
    element(g[0], p[0], m[0], v[0]);
    if (stored) {
      mt_store<1>(k, 2, i, m);
      mt_store<1>(k, 3, i, v);
    }
  }
  return lamb_block_sum2(pp, uu, red);
}

// Stage 2's copies of the piece's first round (its last vectors: stage 2
// walks in reverse), issued before the barrier so they arrive while the
// block waits; returns the piece.
__device__ __forceinline__ MtChunk lamb_stage2_prime(const MtTable& tb, const LambRing& rg, int t,
                                                     int64_t vb, int64_t from, int64_t to,
                                                     bool ran_stage1) {
  const MtChunk k = mt_piece(tb, t, from - vb, (int)(to - from));
  const int nv = k.vec ? k.len / kMtVec : 0;
  if (nv > 0) {
    const int j = ((nv + kLambThreads - 1) / kLambThreads - 1) * kLambThreads + (int)threadIdx.x;
    if (j < nv) ring_issue(rg, k, 0, j, ran_stage1 && lamb_stored(k) ? 1 : 0, false);
    cp_async_commit();
  }
  return k;
}

// Stage 2 over the piece k of tensor t, in the reverse order of stage 1:
// p -= lr ratio u (the moments stage 1 stored, or recomputed and stored
// here), and the copy.
__device__ __forceinline__ void lamb_stage2(const MtTable& tb, const LambRing& rg,
                                            const MtChunk& k, bool primed, bool ran_stage1,
                                            float step, uint64_t stream, const LambArgs& a,
                                            const LambScalars& s) {
  const bool recompute = !(ran_stage1 && lamb_stored(k));
  const bool copy = tb.L > 4 && k.has(4);
  const int nv = k.vec ? k.len / kMtVec : 0;
  // the tail first (stage 1 took it last), one element at a time
  for (int i = nv * kMtVec + (int)threadIdx.x; i < k.len; i += kLambThreads) {
    float g[1], p[1], m[1], v[1];
    if (recompute) mt_load<1>(k, 0, i, g);
    mt_load<1>(k, 1, i, p);
    mt_load<1>(k, 2, i, m);
    mt_load<1>(k, 3, i, v);
    if (recompute) lamb_moments(g[0], p[0], m[0], v[0], a, s);
    const float u2 = lamb_update(p[0], m[0], v[0], a, s);
    p[0] = __fmaf_rn(-step, u2, p[0]);
    mt_store<1>(k, 1, i, p);
    if (recompute) {
      mt_store<1>(k, 2, i, m);
      mt_store<1>(k, 3, i, v);
    }
    if (copy) mt_store<1>(k, 4, i, p);
  }
  ring_walk(
      nv, true, primed,
      [&](int d, int j) { ring_issue(rg, k, d, j, recompute ? 0 : 1, false); },
      [&](int d, int j) {
        const int i = j * kMtVec;
        float g[kMtVec], p[kMtVec], m[kMtVec], v[kMtVec];
        if (recompute) ring_read(rg, k, d, 0, g);
        ring_read(rg, k, d, 1, p);
        ring_read(rg, k, d, 2, m);
        ring_read(rg, k, d, 3, v);
#pragma unroll
        for (int e = 0; e < kMtVec; ++e) {
          if (recompute) lamb_moments(g[e], p[e], m[e], v[e], a, s);
          const float u2 = lamb_update(p[e], m[e], v[e], a, s);
          p[e] = __fmaf_rn(-step, u2, p[e]);
        }
        mt_store_vec(k, 1, i, p, stream);
        if (recompute) {
          mt_store_vec(k, 2, i, m, stream);
          mt_store_vec(k, 3, i, v, stream);
        }
        if (copy) mt_store_vec(k, 4, i, p, stream);
      });
}

// the ring's chunks a stage, list by list (1 or 2 each), packed 2 bits a
// list; its bytes
__device__ __host__ __forceinline__ int ring_chunks(int code) {
  return (code & 3) + ((code >> 2) & 3) + ((code >> 4) & 3) + ((code >> 6) & 3);
}
__host__ __forceinline__ size_t ring_bytes(int code) {
  return (size_t)kLambRing * ring_chunks(code) * kLambThreads * sizeof(uint4);
}

// lists: 0 g, 1 the target, 2 m, 3 v, 4 the optional copy.  ring: each
// list's chunks (ring_chunks).  partials: fp32 [2 (wide Gt + T)], the
// (||p||^2, ||u||^2) of team block bt's piece of tensor t in wide group wi
// at wi Gt + bt + t (unique: along a group's virtual elements each next
// piece moves to the next block, the next tensor or both); ratios: fp32 [T];
// bar: two counters a wide group the launch zeroes (its arrivals, and its
// release).
__global__ void __launch_bounds__(kLambThreads, 1)
mt_lamb_kernel(MtTable tb, LambPlan pl, LambArgs a, int ring, float* __restrict__ partials,
               float* __restrict__ ratios, unsigned* __restrict__ bar) {
  // a set flag: no load, no store (every bit as it was); every block
  // returns, so no barrier waits
  if (a.noop && *a.noop) return;
  extern __shared__ uint4 ring_smem[];
  __shared__ float2 red[32];
  __shared__ int last_s;
  LambRing rg;
  rg.base = ring_smem;
  rg.chunks = ring_chunks(ring);
  for (int l = 0, c = 0; l < 4; ++l) {
    rg.first[l] = c;
    c += (ring >> (2 * l)) & 3;
  }
  const LambScalars s = lamb_scalars(a);
  const float lr = a.lr_ptr ? *a.lr_ptr : a.lr;
  const uint64_t keep = l2_evict_last(), stream = l2_evict_first();
  const int G = gridDim.x, b = blockIdx.x;
  const int n_ratio = a.use_ratio ? a.n_ratio : 0;

  // -- the narrow groups: one block each, no grid barrier ------------------
  for (int q = pl.wide + b; q < pl.groups; q += G) {
    const int64_t* d = pl.desc(pl.order(q));
    const int t0 = (int)(d[0] & 0xffffffffLL), t1 = (int)(d[0] >> 32);
    const int ratio_end = min(t1, n_ratio);
    for (int t = t0; t < ratio_end; ++t) {
      const int64_t n = tb.n(t);
      if (n == 0) continue;
      const float2 sum = lamb_stage1(tb, rg, t, 0, 0, n, 0, keep, stream, a, s, red);
      if (threadIdx.x == 0) ratios[t] = lamb_ratio_of(sum.x, sum.y);
    }
    __threadfence();  // stage 1's stored moments before stage 2's copies
    __syncthreads();
    for (int t = t1 - 1; t >= t0; --t) {
      const int64_t n = tb.n(t);
      if (n == 0) continue;
      const bool r = t < ratio_end;
      lamb_stage2(tb, rg, mt_piece(tb, t, 0, (int)n), false, r, lr * (r ? ratios[t] : 1.f),
                  stream, a, s);
    }
  }

  // -- the wide groups: each team walks its own, group by group: stage 1,
  // the team's barrier (its last arrival sums the tensors' partials into
  // their ratios and releases the group), stage 2 in the reverse order ---
  const int Gt = G / pl.teams, tm = b / Gt, bt = b - tm * Gt;
  for (int i = pl.team_first(tm); i < pl.team_first(tm + 1); ++i) {
    const int wi = pl.mine(i);
    const LambGroup gr = lamb_wide(pl, wi, bt);
    const int64_t lo = imin(gr.E, bt * gr.S), hi = imin(gr.E, lo + gr.S);
    const int ratio_end = min(gr.t1, n_ratio);
    const bool barrier = ratio_end > gr.t0;  // a tensor of it takes a ratio
    if (barrier) {
      // stage 1 keeps the last min(B, bytes) / bytes of each block's span
      const int64_t kept =
          gr.bytes <= a.budget
              ? hi - lo
              : (int64_t)((double)(hi - lo) * ((double)a.budget / (double)gr.bytes));
      const int64_t keep_from = (hi - kept) & ~(int64_t)(kMtVec - 1);
      for (int t = gr.ta; t < min(gr.tz, ratio_end); ++t) {
        const int64_t vb = pl.vbeg(t), from = imax(lo, vb), to = imin(hi, vb + tb.n(t));
        if (to <= from) continue;
        const float2 sum =
            lamb_stage1(tb, rg, t, vb, from, to, keep_from, keep, stream, a, s, red);
        if (threadIdx.x == 0) {
          const int64_t at = 2 * ((int64_t)wi * Gt + bt + t);
          partials[at] = sum.x;
          partials[at + 1] = sum.y;
        }
      }
      __threadfence();  // stage 1's stored moments and partials, then arrive
    }

    // stage 2's first piece (the span's last): its first round's copies in
    // flight while the block waits at the barrier
    int t2 = gr.tz - 1;
    int64_t vb2 = 0;
    for (; t2 >= gr.ta; --t2) {
      vb2 = pl.vbeg(t2);
      if (imin(hi, vb2 + tb.n(t2)) > imax(lo, vb2)) break;
    }
    MtChunk first2;
    if (t2 >= gr.ta)
      first2 = lamb_stage2_prime(tb, rg, t2, vb2, imax(lo, vb2), imin(hi, vb2 + tb.n(t2)),
                                 t2 < ratio_end);

    if (barrier) {
      __syncthreads();
      if (threadIdx.x == 0) last_s = atomicAdd(bar + 2 * wi, 1u) + 1 == (unsigned)Gt;
      __syncthreads();
      if (last_s) {
        __threadfence();
        // a warp a tensor: its pieces' partials in a fixed order (lanes in
        // stride, then xor shuffles), so every call gives the same bits
        const int lane = threadIdx.x & 31;
        for (int t = gr.t0 + (threadIdx.x >> 5); t < ratio_end; t += kLambThreads / 32) {
          const int64_t bl = pl.blocks(t);
          float sp = 0.f, su = 0.f;
          for (int64_t j = (bl & 0xffffffffLL) + lane; j < (bl >> 32); j += 32) {
            const int64_t at = 2 * ((int64_t)wi * Gt + j + t);
            sp += __ldcg(partials + at);
            su += __ldcg(partials + at + 1);
          }
          sp = warp_sum(sp);
          su = warp_sum(su);
          if (lane == 0) ratios[t] = lamb_ratio_of(sp, su);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          __threadfence();
          st_release(bar + 2 * wi + 1, 1u);
        }
      } else if (threadIdx.x == 0) {
        while (ld_acquire(bar + 2 * wi + 1) == 0u) __nanosleep(32);
      }
      __syncthreads();
    }

    // -- stage 2 over the span in the reverse order ----------------------
    for (int t = t2; t >= gr.ta; --t) {
      const bool primed = t == t2;
      const int64_t vb = primed ? vb2 : pl.vbeg(t);
      const int64_t from = imax(lo, vb), to = imin(hi, vb + tb.n(t));
      if (to <= from) continue;
      const bool r = t < ratio_end;
      lamb_stage2(tb, rg, primed ? first2 : mt_piece(tb, t, from - vb, (int)(to - from)), primed,
                  r, lr * (r ? __ldcg(ratios + t) : 1.f), stream, a, s);
    }
  }
}

// the apply form (the packed LAMB's phase 2): lists 0 the target, 1 the
// update; p -= lr ratio u in one pass over the chunks, ratio from the given
// norms [2 n_ratio] (1 past n_ratio or without norms)
__global__ void __launch_bounds__(kMtThreads)
mt_lamb_apply_kernel(MtTable tb, float lr, int n_ratio, const float* __restrict__ norms) {
  for (int c = blockIdx.x; c < tb.C; c += gridDim.x) {
    const MtChunk k = mt_chunk(tb, c);
    float ratio = 1.f;
    if (norms && k.t < n_ratio) {
      const float pn = norms[k.t], un = norms[n_ratio + k.t];
      if (pn > 0.f && un > 0.f) ratio = pn / un;
    }
    const float step = lr * ratio;
    mt_sweep(k, [&](auto w, int i) {
      constexpr int N = decltype(w)::value;
      float p[N], u[N];
      mt_load<N>(k, 0, i, p);
      mt_load<N>(k, 1, i, u);
#pragma unroll
      for (int e = 0; e < N; ++e) p[e] = __fmaf_rn(-step, u[e], p[e]);
      mt_store<N>(k, 0, i, p);
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

// The resident blocks of the walker's kernels (the most of any: a list
// cut into at least this many chunks gives each of them a full grid) and
// of the cooperative mt_lamb_kernel (its grid, which its group plan is
// built for).
extern "C" int apex_mt_resident_blocks() {
  static const int most = std::max({mt_resident(mt_l2norm_chunks),
                                    mt_resident(mt_scale_kernel), mt_resident(mt_adam_kernel)});
  return most;
}

// the cooperative grid of mt_lamb_kernel with a ring of `ring` chunks
// (ring_chunks): the SM count times its occupancy at 512 threads
extern "C" int apex_mt_lamb_blocks(int ring) {
  static const int sms = sm_count();
  // the largest ring (every list fp32), or what a block may take
  static const cudaError_t raised = [] {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return cudaFuncSetAttribute(mt_lamb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                std::min((int)ring_bytes(0xaa), most - 1024));
  }();
  int per_sm = 0;
  if (raised != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mt_lamb_kernel, kLambThreads,
                                                    ring_bytes(ring)) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// lists g, target, m, v, copy (L = 5) in the table; plan: the group plan's
// words (`groups` groups, the first `wide` of its order walked by `teams`
// teams of blocks, built for G = apex_mt_lamb_blocks(ring) blocks); ring: each
// list's 16-byte chunks a vector, 2 bits a list (its widest dtype: 1 for
// 16 bits, 2 for fp32); scratch: fp32
// [2 (wide G / teams + T) + T + 2 wide] (partials, ratios, then each wide
// group's two barrier counters, zeroed here).  Tensors from n_ratio on take the
// ratio 1; lr_ptr: a device lr, or null for `lr`.  One cooperative launch.
extern "C" int apex_mt_lamb(const void* words, int T, int L, int C, int chunk,
                            const void* plan, int groups, int wide, int teams, int G,
                            int ring,
                            long long budget,
                            float beta1, float beta3, float beta2, float one_minus_beta2,
                            float eps, float wd, float lr, int adam_w, int use_ratio,
                            int n_ratio, const void* inv_scale, const void* clip,
                            const void* bc1, const void* bc2, const void* lr_ptr,
                            const void* noop, void* scratch, void* stream) {
  if (T < 1 || L != 5 || groups < 1 || wide < 0 || wide > groups || ring < 0 || ring > 0xff ||
      G < 1 || G != apex_mt_lamb_blocks(ring) || teams < 1 || G % teams || scratch == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MtTable tb = table(words, T, L, C, chunk);
  const LambPlan pl{static_cast<const int64_t*>(plan), groups, wide, teams, T, G};
  LambArgs a{beta1, beta3, beta2, one_minus_beta2, eps, wd, lr, adam_w, use_ratio,
             n_ratio, (int64_t)budget, static_cast<const float*>(inv_scale),
             static_cast<const float*>(clip), static_cast<const float*>(bc1),
             static_cast<const float*>(bc2), static_cast<const float*>(lr_ptr),
             static_cast<const bool*>(noop)};
  float* partials = static_cast<float*>(scratch);
  float* ratios = partials + 2 * ((int64_t)wide * (G / teams) + T);
  unsigned* bar = reinterpret_cast<unsigned*>(ratios + T);
  cudaError_t err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned) * (wide > 0 ? wide : 1), st);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(kLambThreads);
  cfg.dynamicSmemBytes = ring_bytes(ring);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mt_lamb_kernel, tb, pl, a, ring, partials, ratios, bar);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the apply form: lists target, update (L = 2); norms [2 n_ratio] or null
// (every ratio 1).
extern "C" int apex_mt_lamb_apply(const void* words, int T, int L, int C, int chunk, float lr,
                                  int n_ratio, const void* norms, void* stream) {
  if (T < 1 || C < 1 || L != 2) return cudaErrorInvalidValue;
  mt_lamb_apply_kernel<<<mt_grid(mt_lamb_apply_kernel, C), kMtThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table(words, T, L, C, chunk), lr, n_ratio, static_cast<const float*>(norms));
  return (int)cudaGetLastError();
}
