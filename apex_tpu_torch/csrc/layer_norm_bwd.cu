// LayerNorm / RMSNorm backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py::_bwd_kernel, the Pallas TPU kernel
// launched by _pallas_backward.  Same function: for dy [n, h], the saved
// tensor s [n, h] (x, or y when memory_efficient), mean [n], rstd [n] and
// an optional weight [h] and bias [h],
//   xhat = (x - mean) * rstd   (RMS: x * rstd; memory_efficient: (y - b) / w)
//   wdy  = dy * w              (dy without a weight)
//   c1 = sum(wdy) / h, c2 = sum(wdy * xhat) / h
//   dx = (wdy - c1 - xhat * c2) * rstd          (RMS: (wdy - xhat * c2) * rstd)
//   dw = sum over rows of dy * xhat, db = sum over rows of dy,
// in fp32, with dx cast to x's dtype and dw, db to the weight's and bias's
// dtypes.  x and dy are fp32, bf16 or fp16; weight and bias each fp32, bf16
// or fp16 independently of x (the O2 case: x bf16, weight fp32).
//
// Bound: bytes.  The kernel reads dy and s and writes dx, 3 n h elements
// (plus the stats and dw, db), at about 12 operations per element, far
// below the card's rate: at n 8192, h 2048 in bf16, 100.7 MB, 0.030 ms at
// the H100's 3.35 TB/s.  So the design is about reading each byte once and
// keeping enough bytes in flight.
//
// Design (the register form, ln_bwd_rows):
// - A row belongs to `lanes` x `wn` threads (ops/layer_norm.py's bwd_grid):
//   a group of 16 lanes for a row of up to 32 vectors (OpenFold's h 128 and
//   256 in 16 bits: two rows a warp, 1 or 2 vectors a thread; 8 lanes below
//   9 vectors), 32 lanes beyond, spread over `wn` warps where a row is
//   longer than 32 lanes x 4 vectors (Llama's h 2048 and GPT-2-large's h
//   1280 in bf16 take two).  Thread `sub` of the row takes its 16-byte
//   chunks sub + lanes wn k, k < NV: neighbouring threads on neighbouring
//   addresses.
// - Rows go through shared memory, each thread copying its own chunks of
//   dy and s (and the row's mean and rstd) by cp.async, bwd_stages(NV)
//   rows deep (about 32 KB ahead a block): since a thread reads back only
//   what it copied itself, the pipeline needs no barrier, and shared
//   memory, not registers, holds the rows in flight, so the registers go to
//   the column sums below.
// - Each row is read from shared memory twice, in its own dtype, and
//   converted where used: once for the row sums c1 and c2 (lanes sum in
//   order, then shuffles inside the group, then, across the row's warps,
//   shared memory in warp order), once to write dx and add the column sums.
//   Device memory sees one read of dy and s and one write of dx.
// - dw and db: a thread covers the same columns on every row it visits, so
//   it keeps their sums in fp32 registers (NV x VEC each: at NV 4 in bf16
//   with a bias, 64 of its 128 registers; NV 5 would spill, so longer rows
//   take more warps).  At the block's end the threads that share columns
//   add them in shared memory in slot order: one partial row [1 or 2, h] a
//   block.  A second launch, ln_bwd_cols, sums the blocks' partial rows
//   column by column, 32 warps over the partial rows of 32 columns, in a
//   fixed order.  No atomics: the same bits on every call.
// - The weight (and, for memory_efficient, the bias) is staged in shared
//   memory as fp32 once a block, so the kernel takes any weight and bias
//   dtype without a template for each.  Its loads are issued ahead of the
//   first rows' copies, so they do not queue behind them (issued after
//   them, they measured within 3% either way).
// - The block's column sums go to shared memory and are added four columns
//   at a time (float4), in slot order.
// - The grid is persistent: as many blocks as the registers
//   (__launch_bounds__ by NV, bwd_blocks_per_sm) and shared memory let be
//   resident, each striding over the rows in steps of the rows it holds,
//   and no more than it takes for each block to walk the same number of
//   strides.
// The choices are measured by tools/norm_bwd_variants.py (see PERF.md):
// 8 lanes, a whole warp, or 4 or 8 warps a row, three or two stages at
// every NV and a scalar epilogue were slower; streaming stores, L2
// prefetch hints and the weight loaded after the rows' copies read within
// 3% either way.
//
// The streaming form (ln_bwd_stream): rows longer than 256 threads x 4
// vectors, an h that is not whole 16-byte vectors, or inputs off their
// alignment (the host's choice, from the shape and the pointers).  One warp
// a row, two sweeps (the second reading the row again from L1/L2), column
// sums in shared memory per warp; the same ln_bwd_cols sums its partials.
//
// Without a weight there is nothing to sum and only dx is written.
//
// C interface (loaded with ctypes): apex_layer_norm_bwd returns
// cudaGetLastError() after its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// the register form: threads a block, the most 16-byte vectors a thread
// takes of a row; the streaming form: the most warps a block; the column
// pass: warps a block (32 columns).  ops/layer_norm.py mirrors the first two,
// bwd_stages and bwd_blocks_per_sm (tests/test_torch_layer_norm.py holds
// them equal)
constexpr int kThreads = 256;
constexpr int kMaxVecs = 4;
constexpr int kMaxWarps = 8;
constexpr int kColWarps = 32;

// rows in shared memory, this one and the rest ahead: about 32 KB ahead a
// block (NV 4: one row of 34 KB; NV 1, 2: two of 10, 18 KB)
__host__ __device__ constexpr int bwd_stages(int nv) { return nv >= 3 ? 2 : 3; }

// the blocks an SM the register form's registers allow (its
// __launch_bounds__): a thread keeps 2 NV VEC fp32 column sums (bf16 with a
// bias: 64 registers at NV 4, which then takes 128 registers in all)
// beside its addresses and one chunk in work
constexpr int bwd_blocks_per_sm(int nv) { return nv <= 2 ? 3 : 2; }

struct Args {
  const void* dy;
  const void* s;       // x, or y when memory_efficient
  const float* mean;
  const float* rstd;
  const void* w;
  const void* b;
  void* dx;
  void* dw;
  void* db;
  float* part;         // [blocks, 1 + has_b, h]
  int64_t n;
  int h;
  bool rms, mem_eff;
  int w_dtype, b_dtype;
  int lanes, wn, vecs, warps, blocks;   // ops/layer_norm.py's bwd_grid
  cudaStream_t stream;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory, read anew at every call (asm volatile): each
// pass over a row reads it again, where the compiler would otherwise keep
// the first pass's values live (as many registers again as the column sums)
__device__ __forceinline__ uint4 lds16(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ float lds_f32(const void* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_addr(p)));
  return v;
}

// the VEC fp32 values at p (16-byte aligned) in shared memory
template <int VEC>
__device__ __forceinline__ void lds_f32x(const float* p, float (&out)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j) {
    const uint4 v = lds16(p + 4 * j);
    out[4 * j] = __uint_as_float(v.x);
    out[4 * j + 1] = __uint_as_float(v.y);
    out[4 * j + 2] = __uint_as_float(v.z);
    out[4 * j + 3] = __uint_as_float(v.w);
  }
}

// the VEC values of one 16-byte chunk of x's dtype in shared memory, in fp32
template <typename TX, int VEC>
__device__ __forceinline__ void lds_x(const void* p, float (&out)[VEC]) {
  const uint4 v = lds16(p);
  Pack<TX, VEC> pk;
  *reinterpret_cast<uint4*>(&pk) = v;
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pk.v[i]);
}

// p[i] of dtype code `dtype` as raw bits, and those bits as fp32: the
// weight's loads are issued before the rows' copies and converted after,
// so that the block's first rows do not wait behind them
__device__ __forceinline__ uint32_t load_bits(const void* p, int dtype, int i) {
  return dtype == kF32 ? static_cast<const uint32_t*>(p)[i]
                       : static_cast<const uint16_t*>(p)[i];
}

__device__ __forceinline__ float bits_f32(uint32_t v, int dtype) {
  return dtype == kF32    ? __uint_as_float(v)
         : dtype == kBF16 ? __uint_as_float(v << 16)
                          : __half2float(__ushort_as_half(static_cast<unsigned short>(v)));
}

// the sum over a group of `lanes` neighbouring lanes (a power of two up to 32)
__device__ __forceinline__ float group_sum(float v, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// the register form's dynamic shared memory: the staged weight (and bias),
// then bwd_stages(nv) rows of each thread's chunks of dy and s and its row's
// mean and rstd; after the rows, the column sums of the block's row slots
// [rows, 1 + has_b, h] take its start.  ops/layer_norm.py's _bwd_smem is
// the same sum.
__host__ __device__ constexpr size_t stage_bytes(int threads, int nv) {
  return (size_t)threads * (32 * nv + 8);
}

__host__ __device__ constexpr size_t rows_smem(int h, int threads, int nv, int rows, bool has_w,
                                              bool has_b, bool stage_b) {
  const size_t loop = align16((size_t)(has_w ? 1 + stage_b : 0) * h * 4) +
                      bwd_stages(nv) * stage_bytes(threads, nv);
  const size_t sums = has_w ? (size_t)rows * (1 + has_b) * h * 4 : 0;
  return loop > sums ? loop : sums;
}

// The register form.  h % VEC == 0, dy, s and dx 16-byte aligned, and
// lanes * wn * NV >= h / VEC, by the host's choice.
template <typename TX, bool HAS_B, int NV>
__global__ void __launch_bounds__(kThreads, bwd_blocks_per_sm(NV))
ln_bwd_rows(const TX* __restrict__ dy, const TX* __restrict__ s,
            const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
            const void* __restrict__ w, const void* __restrict__ b, int w_dtype, int b_dtype,
            TX* __restrict__ dx, float* __restrict__ part, int64_t n, int h, int lanes, int wn,
            bool rms, bool mem_eff, bool has_w) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int kStages = bwd_stages(NV);
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __shared__ float red[2][kMaxWarps][2];           // the row sums across a row's warps

  const int threads = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = lanes * wn;                        // threads a row
  const int per_warp = 32 / lanes;                 // rows a warp (1 when wn > 1)
  const int rows = (threads >> 5) / wn * per_warp; // rows a block holds at once
  const int slot = (warp / wn) * per_warp + lane / lanes;
  const int sub = (warp % wn) * lanes + (lane & (lanes - 1));
  const int nvec = h / VEC;
  const bool stage_b = mem_eff && HAS_B;
  const bool need_mean = !rms && !mem_eff;
  const float fh = (float)h;

  float* const ws = reinterpret_cast<float*>(bwd_smem);   // [h] weight, [h] bias
  float* const bs = ws + h;
  unsigned char* const stages =
      bwd_smem + align16((size_t)(has_w ? 1 + stage_b : 0) * h * 4);
  const size_t sbytes = stage_bytes(threads, NV);
  // this thread's chunk k of dy (of s at NV + k), its row's mean and rstd
  auto chunk_at = [&](int st, int k) {
    return stages + st * sbytes + ((size_t)k * threads + tid) * 16;
  };
  auto stat_at = [&](int st, int which) {
    return stages + st * sbytes + (size_t)32 * NV * threads + ((size_t)which * threads + tid) * 4;
  };

  const int64_t step = (int64_t)gridDim.x * rows;
  const int64_t first = (int64_t)blockIdx.x * rows;
  // copy this thread's part of the rows at `base` into stage st; every
  // thread commits a group (empty past n), so the counts stay uniform
  auto issue = [&](int st, int64_t base) {
    const int64_t row = base + slot;
    if (row < n) {
      const TX* dyr = dy + row * h;
      const TX* sr = s + row * h;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = sub + G * k;
        if (c < nvec) {
          cp_async16(chunk_at(st, k), dyr + (int64_t)c * VEC);
          cp_async16(chunk_at(st, NV + k), sr + (int64_t)c * VEC);
        }
      }
      if (need_mean) cp_async4(stat_at(st, 0), mean_in + row);
      cp_async4(stat_at(st, 1), rstd_in + row);
    }
    cp_async_commit();
  };

  // the weight (and bias) as fp32 in shared memory: a thread's first
  // kWLoads values loaded ahead of the first rows' copies (all of a weight
  // of h <= kWLoads x threads, every path's) and stored once they arrive,
  // the rest of a longer one after
  constexpr int kWLoads = 8;
  uint32_t wbits[kWLoads], bbits[kWLoads];
#pragma unroll
  for (int j = 0; j < kWLoads; ++j) {
    const int i = tid + j * threads;
    wbits[j] = has_w && i < h ? load_bits(w, w_dtype, i) : 0u;
    bbits[j] = stage_b && i < h ? load_bits(b, b_dtype, i) : 0u;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st, first + st * step);
  if (has_w) {
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * threads;
      if (i < h) {
        ws[i] = bits_f32(wbits[j], w_dtype);
        if (stage_b) bs[i] = bits_f32(bbits[j], b_dtype);
      }
    }
    for (int i = tid + kWLoads * threads; i < h; i += threads) {
      ws[i] = bits_f32(load_bits(w, w_dtype, i), w_dtype);
      if (stage_b) bs[i] = bits_f32(load_bits(b, b_dtype, i), b_dtype);
    }
  }
  __syncthreads();

  float aw[NV][VEC], ab[HAS_B ? NV : 1][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      aw[k][i] = 0.f;
      if constexpr (HAS_B) ab[k][i] = 0.f;
    }
  }

  // xhat, w dy of one chunk (column c * VEC + i)
  auto chunk_values = [&](int st, int k, int c, float mean, float rstd, float (&g)[VEC],
                          float (&xh)[VEC], float (&wg)[VEC]) {
    lds_x<TX, VEC>(chunk_at(st, k), g);
    lds_x<TX, VEC>(chunk_at(st, NV + k), xh);
    float wv[VEC];
    if (has_w) {
      lds_f32x<VEC>(ws + c * VEC, wv);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) wv[i] = 1.f;
    }
    if (mem_eff) {
      // s is the output y: undo the affine step
      if (has_w) {
        if (stage_b) {
          float bv[VEC];
          lds_f32x<VEC>(bs + c * VEC, bv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) xh[i] -= bv[i];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) xh[i] /= wv[i];
      }
    } else if (rms) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) xh[i] *= rstd;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) xh[i] = (xh[i] - mean) * rstd;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) wg[i] = has_w ? g[i] * wv[i] : g[i];
  };

  int st = 0;
  int it = 0;
  for (int64_t base = first; base < n; base += step, ++it) {
    // the rows kStages - 1 ahead, into the stage the last iteration read
    issue(st == 0 ? kStages - 1 : st - 1, base + (kStages - 1) * step);
    cp_async_wait<kStages - 1>();                  // this thread's copies of `base`
    const int64_t row = base + slot;
    const bool live = row < n;
    const float mean = live && need_mean ? lds_f32(stat_at(st, 0)) : 0.f;
    const float rstd = live ? lds_f32(stat_at(st, 1)) : 0.f;

    float s1 = 0.f, s2 = 0.f;
    if (live) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = sub + G * k;
        if (c < nvec) {
          float g[VEC], xh[VEC], wg[VEC];
          chunk_values(st, k, c, mean, rstd, g, xh, wg);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            s1 += wg[i];
            s2 += wg[i] * xh[i];
          }
        }
      }
    }
    s1 = group_sum(s1, lanes);
    s2 = group_sum(s2, lanes);
    if (wn > 1) {
      // a row over wn warps: their sums in warp order (two buffers, so the
      // next iteration's writes need no second barrier)
      float(*r)[2] = red[it & 1];
      if (lane == 0) {
        r[warp][0] = s1;
        r[warp][1] = s2;
      }
      __syncthreads();
      const int w0 = warp - warp % wn;
      s1 = 0.f;
      s2 = 0.f;
      for (int j = 0; j < wn; ++j) {
        s1 += r[w0 + j][0];
        s2 += r[w0 + j][1];
      }
    }
    const float c1 = rms ? 0.f : s1 / fh;
    const float c2 = s2 / fh;

    if (live) {
      TX* dxr = dx + row * h;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = sub + G * k;
        if (c < nvec) {
          float g[VEC], xh[VEC], wg[VEC], out[VEC];
          chunk_values(st, k, c, mean, rstd, g, xh, wg);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            out[i] = (rms ? wg[i] - xh[i] * c2 : wg[i] - c1 - xh[i] * c2) * rstd;
          store_f32<TX, VEC>(dxr + (int64_t)c * VEC, out);
          if (has_w) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              aw[k][i] += g[i] * xh[i];
              if constexpr (HAS_B) ab[k][i] += g[i];
            }
          }
        }
      }
    }
    st = st == kStages - 1 ? 0 : st + 1;
  }
  if (!has_w) return;

  // this block's partial row: the slots' column sums added in slot order,
  // four columns at a time ([rows][h] of dw, then of db, in shared memory)
  cp_async_wait<0>();
  __syncthreads();
  float* const sw = reinterpret_cast<float*>(bwd_smem);
  float* const sb = sw + (size_t)rows * h;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = sub + G * k;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        const size_t at = (size_t)slot * h + c * VEC + 4 * j;
        *reinterpret_cast<float4*>(sw + at) =
            make_float4(aw[k][4 * j], aw[k][4 * j + 1], aw[k][4 * j + 2], aw[k][4 * j + 3]);
        if constexpr (HAS_B)
          *reinterpret_cast<float4*>(sb + at) =
              make_float4(ab[k][4 * j], ab[k][4 * j + 1], ab[k][4 * j + 2], ab[k][4 * j + 3]);
      }
    }
  }
  __syncthreads();
  float* const pw = part + (size_t)blockIdx.x * (1 + HAS_B) * h;
  const int h4 = h / 4;
  for (int q = tid; q < (1 + HAS_B) * h4; q += threads) {
    const int half = q >= h4, c4 = q - half * h4;
    const float* src = sw + (size_t)half * rows * h + 4 * c4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < rows; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)j * h);
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    *reinterpret_cast<float4*>(pw + (size_t)half * h + 4 * c4) = t;
  }
}

// dy, xhat and w*dy of the VEC values of chunk c of one row, from device
// memory (the streaming form)
template <typename TX, typename TW, typename TB, int VEC>
__device__ __forceinline__ void chunk(const TX* dyr, const TX* sr, const TW* w, const TB* b,
                                      int c, float mean, float rstd, bool rms, bool mem_eff,
                                      bool has_w, bool has_b, float (&g)[VEC],
                                      float (&xh)[VEC], float (&wg)[VEC]) {
  load_f32<TX, VEC>(dyr + (int64_t)c * VEC, g);
  load_f32<TX, VEC>(sr + (int64_t)c * VEC, xh);
  float wv[VEC];
  if (has_w) {
    load_f32<TW, VEC>(w + (int64_t)c * VEC, wv);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) wv[i] = 1.f;
  }
  if (mem_eff) {
    if (has_w) {
      if (has_b) {
        float bv[VEC];
        load_f32<TB, VEC>(b + (int64_t)c * VEC, bv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) xh[i] -= bv[i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) xh[i] /= wv[i];
    }
  } else if (rms) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) xh[i] *= rstd;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) xh[i] = (xh[i] - mean) * rstd;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) wg[i] = has_w ? g[i] * wv[i] : g[i];
}

// The streaming form: one warp a row, two sweeps, each warp's column sums
// in shared memory ([warps][1 + has_b][h]; within a warp's [h], column
// c * VEC + i sits at i * nvec + c, so the 32 lanes touch 32 banks).
template <typename TX, typename TW, typename TB, int VEC>
__global__ void __launch_bounds__(32 * kMaxWarps)
ln_bwd_stream(const TX* __restrict__ dy, const TX* __restrict__ s,
              const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
              const TW* __restrict__ w, const TB* __restrict__ b, TX* __restrict__ dx,
              float* __restrict__ part, int64_t n, int h, bool rms, bool mem_eff, bool has_w,
              bool has_b) {
  extern __shared__ float acc[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = h / VEC;
  const int nparts = 1 + has_b;
  const float fh = (float)h;
  float* aw = acc + (size_t)warp * nparts * h;   // this warp's sums of dy * xhat
  float* ab = aw + h;                            // and of dy
  if (has_w)
    for (int c = lane; c < nparts * h; c += 32) aw[c] = 0.f;
  __syncwarp();

  for (int64_t row = (int64_t)blockIdx.x * warps + warp; row < n;
       row += (int64_t)gridDim.x * warps) {
    const TX* dyr = dy + row * h;
    const TX* sr = s + row * h;
    TX* dxr = dx + row * h;
    const float mean = rms ? 0.f : mean_in[row];
    const float rstd = rstd_in[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      float g[VEC], xh[VEC], wg[VEC];
      chunk<TX, TW, TB, VEC>(dyr, sr, w, b, c, mean, rstd, rms, mem_eff, has_w, has_b, g,
                             xh, wg);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1 += wg[i];
        s2 += wg[i] * xh[i];
      }
    }
    const float c1 = rms ? 0.f : warp_sum(s1) / fh;
    const float c2 = warp_sum(s2) / fh;
    for (int c = lane; c < nvec; c += 32) {
      float g[VEC], xh[VEC], wg[VEC], out[VEC];
      chunk<TX, TW, TB, VEC>(dyr, sr, w, b, c, mean, rstd, rms, mem_eff, has_w, has_b, g,
                             xh, wg);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = (rms ? wg[i] - xh[i] * c2 : wg[i] - c1 - xh[i] * c2) * rstd;
      store_f32<TX, VEC>(dxr + (int64_t)c * VEC, out);
      if (has_w) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          aw[i * nvec + c] += g[i] * xh[i];
          if (has_b) ab[i * nvec + c] += g[i];
        }
      }
    }
  }
  if (!has_w) return;
  __syncthreads();
  // this block's partial row: its warps' sums, in warp order
  float* pw = part + (size_t)blockIdx.x * nparts * h;
  for (int c = threadIdx.x; c < nparts * h; c += blockDim.x) {
    const int half = c >= h, col = c - half * h;
    const int at = half * h + (col % VEC) * nvec + col / VEC;
    float t = 0.f;
    for (int k = 0; k < warps; ++k) t += acc[(size_t)k * nparts * h + at];
    pw[c] = t;
  }
}

// the second pass: dw, db = the blocks' partial rows summed in block order;
// 32 columns a block, warp j adds the partial rows j + kColWarps m in
// order (loads unrolled, so several are in flight), then warp 0 adds the
// warps' sums in warp order
template <typename TW, typename TB>
__global__ void __launch_bounds__(32 * kColWarps)
ln_bwd_cols(const float* __restrict__ part, int blocks, int h, TW* __restrict__ dw,
            TB* __restrict__ db, bool has_b) {
  __shared__ float sw[kColWarps][32], sb[kColWarps][32];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int nparts = 1 + has_b;
  float tw = 0.f, tb = 0.f;
  if (col < h) {
#pragma unroll 4
    for (int k = wy; k < blocks; k += kColWarps) {
      const float* p = part + (size_t)k * nparts * h + col;
      tw += p[0];
      if (has_b) tb += p[h];
    }
  }
  sw[wy][lane] = tw;
  sb[wy][lane] = tb;
  __syncthreads();
  if (wy == 0 && col < h) {
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int k = 0; k < kColWarps; ++k) {
      a += sw[k][lane];
      c += sb[k][lane];
    }
    dw[col] = from_f32<TW>(a);
    if (has_b) db[col] = from_f32<TB>(c);
  }
}

template <typename TX, bool HAS_B, int NV>
cudaError_t launch_rows_nv(const Args& a) {
  const bool has_w = a.w != nullptr;
  const int threads = 32 * a.warps;
  const int rows = a.warps / a.wn * (32 / a.lanes);
  const size_t smem = rows_smem(a.h, threads, NV, rows, has_w, HAS_B, a.mem_eff && HAS_B);
  auto kernel = ln_bwd_rows<TX, HAS_B, NV>;
  // the attribute is per device: set it on every launch, for the current one
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.blocks, threads, smem, a.stream>>>(
      static_cast<const TX*>(a.dy), static_cast<const TX*>(a.s), a.mean, a.rstd, a.w, a.b,
      a.w_dtype, a.b_dtype, static_cast<TX*>(a.dx), a.part, a.n, a.h, a.lanes, a.wn, a.rms,
      a.mem_eff, has_w);
  return cudaGetLastError();
}

template <typename TX, bool HAS_B>
cudaError_t launch_rows_b(const Args& a) {
  switch (a.vecs) {
    case 1: return launch_rows_nv<TX, HAS_B, 1>(a);
    case 2: return launch_rows_nv<TX, HAS_B, 2>(a);
    case 3: return launch_rows_nv<TX, HAS_B, 3>(a);
    case 4: return launch_rows_nv<TX, HAS_B, 4>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_rows(const Args& a) {
  constexpr int VEC = 16 / sizeof(TX);
  // the host chose this form for whole, aligned vectors that the grid covers
  if (a.h % VEC != 0 || !aligned(a.dy, 16) || !aligned(a.s, 16) || !aligned(a.dx, 16) ||
      (a.lanes != 8 && a.lanes != 16 && a.lanes != 32) || (a.wn > 1 && a.lanes != 32) ||
      a.wn < 1 || a.warps % a.wn != 0 || (int64_t)a.lanes * a.wn * a.vecs < a.h / VEC)
    return cudaErrorInvalidValue;
  return a.b != nullptr ? launch_rows_b<TX, true>(a) : launch_rows_b<TX, false>(a);
}

template <typename TX, typename TW, typename TB>
cudaError_t launch_stream(const Args& a) {
  constexpr int VEC = 16 / sizeof(TX);
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
  const bool vec = a.h % VEC == 0 && aligned(a.dy, 16) && aligned(a.s, 16) &&
                   aligned(a.dx, 16) && aligned(a.w, pack_align(sizeof(TW) * VEC)) &&
                   aligned(a.b, pack_align(sizeof(TB) * VEC));
  const size_t smem = has_w ? (size_t)a.warps * (1 + has_b) * a.h * sizeof(float) : 0;
  const TX* dy = static_cast<const TX*>(a.dy);
  const TX* s = static_cast<const TX*>(a.s);
  const TW* w = static_cast<const TW*>(a.w);
  const TB* b = static_cast<const TB*>(a.b);
  TX* dx = static_cast<TX*>(a.dx);
  auto kernel = vec ? ln_bwd_stream<TX, TW, TB, VEC> : ln_bwd_stream<TX, TW, TB, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.blocks, 32 * a.warps, smem, a.stream>>>(dy, s, a.mean, a.rstd, w, b, dx, a.part,
                                                     a.n, a.h, a.rms, a.mem_eff, has_w, has_b);
  return cudaGetLastError();
}

template <typename TW, typename TB>
cudaError_t launch_cols(const Args& a) {
  ln_bwd_cols<TW, TB><<<(a.h + 31) / 32, 32 * kColWarps, 0, a.stream>>>(
      a.part, a.blocks, a.h, static_cast<TW*>(a.dw), static_cast<TB*>(a.db), a.b != nullptr);
  return cudaGetLastError();
}

// the dtypes of (x,) weight and bias as template arguments: F(TW, TB)
template <typename TX>
struct Stream {
  template <typename TW, typename TB>
  static cudaError_t run(const Args& a) { return launch_stream<TX, TW, TB>(a); }
};
struct Cols {
  template <typename TW, typename TB>
  static cudaError_t run(const Args& a) { return launch_cols<TW, TB>(a); }
};

template <typename F, typename TW>
cudaError_t by_bias(const Args& a) {
  switch (a.b_dtype) {
    case kF32: return F::template run<TW, float>(a);
    case kBF16: return F::template run<TW, __nv_bfloat16>(a);
    case kF16: return F::template run<TW, __half>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t by_weight(const Args& a) {
  switch (a.w_dtype) {
    case kF32: return by_bias<F, float>(a);
    case kBF16: return by_bias<F, __nv_bfloat16>(a);
    case kF16: return by_bias<F, __half>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch(const Args& a) {
  cudaError_t err = a.vecs > 0 ? launch_rows<TX>(a) : by_weight<Stream<TX>>(a);
  if (err != cudaSuccess || a.w == nullptr) return err;
  return by_weight<Cols>(a);
}

}  // namespace

// dy, s (x or y), dx: [n, h] contiguous, dtype x_dtype; mean, rstd: [n]
// fp32; w, b: [h] contiguous or null, each with its own dtype code (ignored
// when the pointer is null; a bias needs a weight); dw, db: [h] in the
// weight's and bias's dtypes (null without them); part: [blocks, 1 + (b
// != null), h] fp32 scratch when there is a weight.  The grid from
// ops/layer_norm.py's bwd_grid: `vecs` 16-byte vectors a thread (1-4, the
// register form: a row to `lanes` (8, 16, 32) x `wn` (1-8) threads) or 0
// (the streaming form: a warp a row), `warps` (1-8) a block and `blocks`.
// Dtype codes: 0 fp32, 1 bf16, 2 fp16.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int apex_layer_norm_bwd(const void* dy, const void* s, const void* mean,
                                   const void* rstd, const void* w, const void* b, void* dx,
                                   void* dw, void* db, void* part, long long n, int h, int rms,
                                   int mem_eff, int x_dtype, int w_dtype, int b_dtype,
                                   int lanes, int wn, int vecs, int warps, int blocks,
                                   void* stream) {
  if (n < 1 || h < 1 || warps < 1 || warps > kMaxWarps || blocks < 1 || vecs < 0 ||
      vecs > kMaxVecs)
    return cudaErrorInvalidValue;
  if (b != nullptr && w == nullptr) return cudaErrorInvalidValue;
  if (w != nullptr && (dw == nullptr || part == nullptr || (b != nullptr && db == nullptr)))
    return cudaErrorInvalidValue;
  // an absent weight or bias takes x's (the weight's) dtype: it is never read
  if (w == nullptr) w_dtype = x_dtype;
  if (b == nullptr) b_dtype = w_dtype;
  const Args a{dy, s, static_cast<const float*>(mean), static_cast<const float*>(rstd), w, b, dx,
               dw, db, static_cast<float*>(part), (int64_t)n, h, rms != 0, mem_eff != 0,
               w_dtype, b_dtype, lanes, wn, vecs, warps, blocks,
               static_cast<cudaStream_t>(stream)};
  switch (x_dtype) {
    case kF32: return (int)launch<float>(a);
    case kBF16: return (int)launch<__nv_bfloat16>(a);
    case kF16: return (int)launch<__half>(a);
  }
  return (int)cudaErrorInvalidValue;
}
