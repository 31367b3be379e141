// Fused LM-head cross-entropy backward for Hopper (sm_90a): dH and dE.
//
// Replaces: apex_tpu/ops/fused_lm_head.py::_dh_kernel and ::_de_kernel, the
// Pallas TPU kernels launched by _pallas_bwd.  Same function: for hidden H
// [T, h], the table E [V, h], int32 labels [T], the forward's lse [T] and
// the per-token upstream cotangent g [T] (fp32),
//   dlog = (exp(H E^T - lse) - [col == label]) * g      (fp32)
//   dH   = dlog E,   dE = dlog^T H
// with dlog rounded to the input dtype before both products, as the Pallas
// kernels round it, and fp32 accumulation.  A label outside [0, V) matches
// no column, so it puts no -1 anywhere (and no gradient into a column).
//
// Bound: operations.  The backward is three products of 2 T V h each: the
// logits recompute H E^T, dH = dlog E and dE = dlog^T H, 1.07 TFLOP each at
// the main path's shape (T 8192, h 2048, V 32000, bf16), 3.26 ms in all at
// the tensor-core rate (989 TFLOP/s): 2.17 ms for the dH call (recompute +
// dH), 1.09 ms for the dE call.  Beside them the bytes: H and E read (33.5
// and 131 MB), and dlog [T, Vp] in the input dtype (Vp = V rounded up to
// 64: 524 MB) written once and read twice, 1.57 GB, about 0.47 ms at 3.35
// TB/s, which the products' time covers.  The Pallas kernels recompute the
// logits in both dH and dE (four products); keeping them from the forward,
// as the library does, would hold [T, V] fp32 logits (1 GB) from the
// forward to the backward, which is what the fused head exists to avoid.
//
// Design for that bound.  A Hopper block has 227 KB of shared memory, so
// the TPU kernels' [tokens, h] or [vocab, h] fp32 accumulator resident
// across a sequential grid has no counterpart: the logits are recomputed
// once and dlog goes through device memory, and every product is one tiled
// GEMM that fills the card on its own.  All three run on wgmma_sm90.cuh's
// mainloop (TMA into a 4-stage ring of 128-byte-swizzled 48 KB stages,
// mbarriers, one producer warp, two consumer warpgroups of m64n256k16
// wgmma, 128 x 256 tiles, fp32 accumulators in registers): the operand
// path that reaches the tensor cores' rate, where mma.sync from ldmatrix
// saturates near two thirds of it.  Operand layouts, no transposed copies:
// - logits H E^T: H and E both K-major; the epilogue turns the accumulators
//   into dlog = (2^(s log2e - lse log2e) - onehot) g (the hardware exp2),
//   zeros in the pad columns [V, Vp), in the input dtype, staged through
//   the free ring and stored in 16-byte pieces (as every product's tile);
// - dH = dlog E (same C call as the logits, counted once): dlog K-major, E
//   MN-major (rows of E run along h);
// - dE = dlog^T H: dlog MN-major (read as [T, Vp] boxes), H MN-major.
// TMA fills ragged T, V and h with zeros; each output tile is owned by one
// block, so a call gives the same bits every time.  fp32 inputs take
// CUDA-core kernels in full fp32 (never TF32), with an fp32 dlog.
//
// C interface (loaded with ctypes): apex_fused_lm_head_dh and
// apex_fused_lm_head_de return cudaGetLastError() after their launches, 0
// on success, and cudaErrorInvalidValue for a shape they do not take or a
// tensor map that cuTensorMapEncodeTiled refuses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

struct DlogArgs {
  const void* h;       // [T, hid]
  const void* e;       // [V, hid]
  const int* labels;   // [T]
  const float* lse;    // [T]
  const float* g;      // [T]
  void* dlog;          // [T, vp]
  int64_t T;
  int V, hid, vp;
};

struct GemmArgs {
  const void* a;       // A[m, k] at a + m * lda + k, or a + k * lda + m (a_kmajor)
  const void* b;       // B[k, n] at b + k * ldb + n
  void* c;             // C[m, n] at c + m * ldc + n
  int M, N, K;         // C is M x N; the loop runs over K
  int a_rows;          // A's valid extent along m (m-major) or k (k-major) ...
  int a_cols;          // ... and along k (m-major) or m (k-major)
  int b_rows;          // B's valid rows (k)
  int64_t lda, ldb, ldc;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;

// dlog for a 64 x 64 tile (grid: token tiles x column tiles over vp)
__global__ void __launch_bounds__(256)
dlog_f32(const DlogArgs a) {
  __shared__ float Hs[kFK][kFM + 4];
  __shared__ float Es[kFK][kFN + 4];
  const int64_t t0 = (int64_t)blockIdx.x * kFM;
  const int v0 = blockIdx.y * kFN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;   // rows ty*4.., cols tx + 16j
  const float* H = static_cast<const float*>(a.h);
  const float* E = static_cast<const float*>(a.e);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.hid; k0 += kFK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + i * 256;
      const int r = idx >> 4, c = idx & 15;
      const bool kin = k0 + c < a.hid;
      Hs[c][r] = (kin && t0 + r < a.T) ? H[(t0 + r) * a.hid + k0 + c] : 0.f;
      Es[c][r] = (kin && v0 + r < a.V) ? E[(int64_t)(v0 + r) * a.hid + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float hv[4], ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = Hs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) ev[j] = Es[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], ev[j], acc[i][j]);
    }
  }
  float* D = static_cast<float*>(a.dlog);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = t0 + ty * 4 + i;
    if (row >= a.T) continue;
    const int lab = a.labels[row];
    const float lse = a.lse[row], gr = a.g[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = v0 + tx + 16 * j;
      if (col < a.vp)
        D[row * a.vp + col] =
            col < a.V ? (expf(acc[i][j] - lse) - (col == lab ? 1.f : 0.f)) * gr : 0.f;
    }
  }
}

// C = A B for a 64 x 64 tile of C
template <bool AK>
__global__ void __launch_bounds__(256)
gemm_f32(const GemmArgs g) {
  __shared__ float As[kFK][kFM + 4];
  __shared__ float Bs[kFK][kFN + 4];
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* A = static_cast<const float*>(g.a);
  const float* B = static_cast<const float*>(g.b);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += kFK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + i * 256;
      // A: 64 m x 16 k; B: 16 k x 64 n
      {
        int r, c;   // r: m, c: k
        if (AK) { c = idx >> 6; r = idx & 63; } else { r = idx >> 4; c = idx & 15; }
        const int m = m0 + r, k = k0 + c;
        const bool in = AK ? (k < g.a_rows && m < g.a_cols) : (m < g.a_rows && k < g.a_cols);
        As[c][r] = in ? (AK ? A[(int64_t)k * g.lda + m] : A[(int64_t)m * g.lda + k]) : 0.f;
      }
      {
        const int r = idx >> 6, c = idx & 63;   // r: k, c: n
        const bool in = k0 + r < g.b_rows && n0 + c < g.N;
        Bs[r][c] = in ? B[(int64_t)(k0 + r) * g.ldb + n0 + c] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float* C = static_cast<float*>(g.c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < g.N) C[(int64_t)row * g.ldc + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the epilogues of the three products on wgmma_sm90.cuh
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// the logits tile's epilogue: dlog [T, vp] from the accumulators; the
// padded columns [V, vp) get zeros
template <typename T>
struct DlogStore {
  static constexpr bool kStores = true;
  T* out;
  int64_t rows;
  int cols;                 // vp
  int V;
  const int* labels;
  const float* lse;
  const float* g;

  __device__ __forceinline__ void stage(float (&acc)[128], int64_t row0, int col0, int tid,
                                        T* tile) const {
    const int lane = tid % 32;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * (tid / 32) + lane / 4 + 8 * half;
      const int64_t row = row0 + r;
      if (row >= rows) continue;      // never stored; its label is not read
      const int lab = labels[row];
      const float shift = lse[row] * kLog2e, gr = g[row];
#pragma unroll
      for (int j = 0; j < kGemmBN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + c + e;
          out[e] = col < V ? (fast_exp2(fmaf(acc[4 * j + 2 * half + e], kLog2e, -shift)) -
                              (col == lab ? 1.f : 0.f)) * gr
                           : 0.f;
        }
        store_f32<T, 2>(tile + r * kGemmTileLd + c, out);
      }
    }
  }
};

// a product's epilogue: the tile rounded to T, into C [rows, cols]
template <typename T>
struct TileStore {
  static constexpr bool kStores = true;
  T* out;
  int64_t rows;
  int cols;

  __device__ __forceinline__ void stage(float (&acc)[128], int64_t, int, int tid, T* tile) const {
    const int lane = tid % 32;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * (tid / 32) + lane / 4 + 8 * half;
#pragma unroll
      for (int j = 0; j < kGemmBN / 8; ++j) {
        const float out[2] = {acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]};
        store_f32<T, 2>(tile + r * kGemmTileLd + 8 * j + 2 * (lane % 4), out);
      }
    }
  }
};

// the logits with dlog as their epilogue, then dh [T, hid] = dlog [T, vp] e
template <typename T>
cudaError_t half_dh(const DlogArgs& a, void* dh, cudaStream_t stream) {
  CUtensorMap h_k, e_k, dlog_k, e_mn;
  if (!tensor_map<T>(&h_k, a.h, a.T, a.hid, kGemmBM) ||
      !tensor_map<T>(&e_k, a.e, a.V, a.hid, kGemmBN) ||
      !tensor_map<T>(&dlog_k, a.dlog, a.T, a.vp, kGemmBM) ||
      !tensor_map<T>(&e_mn, a.e, a.V, a.hid, 64))
    return cudaErrorInvalidValue;
  const DlogStore<T> dlog{static_cast<T*>(a.dlog), a.T, a.vp, a.V, a.labels, a.lse, a.g};
  const cudaError_t err =
      launch_wgmma_gemm<T, false, false>(h_k, e_k, a.T, a.vp, a.hid, dlog, stream);
  if (err != cudaSuccess) return err;
  // e's rows past V read as zeros, as do dlog's pad columns
  return launch_wgmma_gemm<T, false, true>(dlog_k, e_mn, a.T, a.hid, a.vp,
                                           TileStore<T>{static_cast<T*>(dh), a.T, a.hid},
                                           stream);
}

// de [V, hid] = dlog^T [V, T] h [T, hid]
template <typename T>
cudaError_t half_de(const void* dlog, const void* h, void* de, int64_t tokens, int V, int hid,
                    int vp, cudaStream_t stream) {
  CUtensorMap dlog_mn, h_mn;
  if (!tensor_map<T>(&dlog_mn, dlog, tokens, vp, 64) ||
      !tensor_map<T>(&h_mn, h, tokens, hid, 64))
    return cudaErrorInvalidValue;
  return launch_wgmma_gemm<T, true, true>(dlog_mn, h_mn, V, hid, tokens,
                                          TileStore<T>{static_cast<T*>(de), V, hid}, stream);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

cudaError_t gemm_fp32(bool a_kmajor, const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid((g.M + kFM - 1) / kFM, (g.N + kFN - 1) / kFN);
  if (a_kmajor)
    gemm_f32<true><<<grid, 256, 0, stream>>>(g);
  else
    gemm_f32<false><<<grid, 256, 0, stream>>>(g);
  return cudaGetLastError();
}

bool shapes_ok(long long T, int V, int hid, int vp) {
  return T >= 1 && T <= 0x7fffffffLL && V >= 1 && hid >= 8 && hid % 8 == 0 && vp % 64 == 0 &&
         vp >= V && vp < V + 64;
}

}  // namespace

// h [T, hid] and e [V, hid] contiguous, of one dtype (0 fp32, 1 bf16, 2
// fp16), 16-byte aligned, hid % 8 == 0; labels [T] int32; lse and g [T]
// fp32; dlog [T, vp] scratch in the input dtype, vp = V rounded up to 64;
// dh [T, hid] in the input dtype.  Writes dlog, then dh = dlog e.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int apex_fused_lm_head_dh(const void* h, const void* e, const void* labels,
                                     const void* lse, const void* g, void* dlog, void* dh,
                                     long long T, int V, int hid, int vp, int dtype,
                                     void* stream) {
  if (!shapes_ok(T, V, hid, vp)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DlogArgs a{h, e, static_cast<const int*>(labels), static_cast<const float*>(lse),
                   static_cast<const float*>(g), dlog, (int64_t)T, V, hid, vp};
  switch (dtype) {
    case kBF16: return (int)half_dh<__nv_bfloat16>(a, dh, s);
    case kF16: return (int)half_dh<__half>(a, dh, s);
    case kF32: break;
    default: return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((T + kFM - 1) / kFM), (vp + kFN - 1) / kFN);
  dlog_f32<<<grid, 256, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dh [T, hid] = dlog [T, vp] e [vp, hid]; e's rows past V read as 0
  const GemmArgs gm{dlog, e, dh, (int)T, hid, vp, (int)T, vp, V, vp, hid, hid};
  return (int)gemm_fp32(false, gm, s);
}

// dlog [T, vp] as apex_fused_lm_head_dh wrote it; h [T, hid]; de [V, hid]
// in the input dtype.  Writes de = dlog^T h.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int apex_fused_lm_head_de(const void* dlog, const void* h, void* de, long long T,
                                     int V, int hid, int vp, int dtype, void* stream) {
  if (!shapes_ok(T, V, hid, vp)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return (int)half_de<__nv_bfloat16>(dlog, h, de, T, V, hid, vp, s);
    case kF16: return (int)half_de<__half>(dlog, h, de, T, V, hid, vp, s);
    case kF32: break;
    default: return cudaErrorInvalidValue;
  }
  // de [V, hid] = dlog^T [V, T] h [T, hid]; dlog read k-major (row t, column v)
  const GemmArgs gm{dlog, h, de, V, hid, (int)T, (int)T, vp, (int)T, vp, hid, hid};
  return (int)gemm_fp32(true, gm, s);
}
