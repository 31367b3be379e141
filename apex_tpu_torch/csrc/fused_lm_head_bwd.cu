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
// Bound: operations.  At the main path's shape (T 8192, h 2048, V 32000,
// bf16) the logits recompute and each product are 2 T V h = 1.07 TFLOP:
// the Pallas kernels recompute the logits in both, 2.15 TFLOP each, about
// 2.17 ms each at the tensor-core rate (989 TFLOP/s); H and E are 33.5 and
// 131 MB.
//
// Design for that bound.  The TPU kernels keep a [tokens, h] or [vocab, h]
// fp32 accumulator (1-8 MB) in VMEM across a sequential grid and recompute
// the logits in each.  A Hopper block has 227 KB of shared memory and a
// [128, 2048] fp32 tile alone is 1 MB, so a block that owns a slice of dH
// or dE would have to recompute the full-h logits tile once per slice (16
// times at h 2048).  Instead the logits are recomputed once and dlog is
// written to device memory in the input dtype (T x Vp x 2 bytes, Vp = V
// rounded up to 64: 524 MB at the main shape, written once and read twice,
// about 0.47 ms of traffic at 3.35 TB/s), and both gradients are then plain
// tiled products that fill the card on their own (1,024 and 4,000 blocks):
// - dH (one C call, counted once): a logits kernel that computes H E^T
//   tile by tile (128 x 128 a block, h in steps of 64 through a 3-stage
//   cp.async ring, 4 warps of 64 x 64 on mma.sync m16n8k16, the tile in
//   registers, the forward kernel's tiling) and writes dlog from the
//   registers; then the product dH = dlog E.
// - dE: the product dE = dlog^T H, reading dlog transposed.
// Both products are one tiled kernel (128 x 128 a block, k in steps of 32,
// 3-stage cp.async ring, ldmatrix with or without .trans by the operand's
// layout).  So the backward costs three 1.07 TFLOP products in place of the
// Pallas kernels' four, plus the dlog traffic.  fp32 inputs take CUDA-core
// kernels in full fp32 (never TF32), with an fp32 dlog.
//
// C interface (loaded with ctypes): apex_fused_lm_head_dh and
// apex_fused_lm_head_de return cudaGetLastError() after their launches, 0
// on success.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// the logits and dlog: bf16 / fp16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kWarpsN = 2;                 // 2 x 2 warps, each 64 rows x 64 columns
constexpr int kThreads = 32 * 2 * kWarpsN;
constexpr int kNT = kBN / kWarpsN / 8;     // n8 tiles a warp
constexpr int kSK = kBK + 8;   // shared row stride (elements): conflict-free ldmatrix

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
dlog_mma(const DlogArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Hs = reinterpret_cast<T*>(smem_raw);          // [kStages][kBM][kSK]
  T* Es = Hs + kStages * kBM * kSK;                // [kStages][kBN][kSK]

  const int64_t t0 = (int64_t)blockIdx.x * kBM;
  const int v0 = blockIdx.y * kBN;
  const int nk = (a.hid + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int gq = lane >> 2, tig = lane & 3;
  const T* H = static_cast<const T*>(a.h);
  const T* E = static_cast<const T*>(a.e);

  auto load = [&](int it, int stage) {
    const int k0 = it * kBK;
    T* hs = Hs + stage * kBM * kSK;
    T* es = Es + stage * kBN * kSK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
      const bool kin = k0 + c < a.hid;
      const bool hin = kin && t0 + r < a.T;
      cp_async16(hs + r * kSK + c, hin ? H + (t0 + r) * a.hid + k0 + c : H, hin);
      const bool ein = kin && v0 + r < a.V;
      cp_async16(es + r * kSK + c, ein ? E + (int64_t)(v0 + r) * a.hid + k0 + c : E, ein);
    }
  };

  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < nk) load(nxt, nxt % kStages);
    cp_async_commit();
    const T* hs = Hs + (it % kStages) * kBM * kSK;
    const T* es = Es + (it % kStages) * kBN * kSK;
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], hs + (wm * 64 + mt * 16 + (mi & 1) * 8 + (lane & 7)) * kSK +
                                kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, es + (wn * kNT * 8 + np * 16 + (mi >> 1) * 8 + (lane & 7)) * kSK +
                            kk * 16 + (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          MmaOp<T>::run(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          MmaOp<T>::run(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // dlog from the registers; the padded columns [V, vp) get zeros
  T* D = static_cast<T*>(a.dlog);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t row = t0 + wm * 64 + (r >> 1) * 16 + gq + (r & 1) * 8;
    if (row >= a.T) continue;
    const int lab = a.labels[row];
    const float lse = a.lse[row], gr = a.g[row];
    const int mt = r >> 1, half = r & 1;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = v0 + wn * kNT * 8 + nt * 8 + tig * 2;
      if (col >= a.vp) continue;
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col + e;
        out[e] = c < a.V ? (expf(acc[mt][nt][half * 2 + e] - lse) - (c == lab ? 1.f : 0.f)) * gr
                         : 0.f;
      }
      *reinterpret_cast<uint32_t*>(D + row * a.vp + col) = MmaOp<T>::pack(out[0], out[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the products: C[m, n] = sum_k A[m, k] B[k, n], bf16 / fp16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int kGK = 32;                  // k a stage
constexpr int kSA = kGK + 8;             // A tile [kBM][kSA] (A stored m-major)
constexpr int kSAT = kBM + 8;            // A tile [kGK][kSAT] (A stored k-major)
constexpr int kSB = kBN + 8;             // B tile [kGK][kSB]

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

template <typename T, bool AK>
__global__ void __launch_bounds__(kThreads)
gemm_mma(const GemmArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kATile = AK ? kGK * kSAT : kBM * kSA;
  T* As = reinterpret_cast<T*>(smem_raw);          // [kStages][kATile]
  T* Bs = As + kStages * kATile;                   // [kStages][kGK][kSB]

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (g.K + kGK - 1) / kGK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int gq = lane >> 2, tig = lane & 3;
  const T* A = static_cast<const T*>(g.a);
  const T* B = static_cast<const T*>(g.b);

  auto load = [&](int it, int stage) {
    const int k0 = it * kGK;
    T* as = As + stage * kATile;
    T* bs = Bs + stage * kGK * kSB;
    // A: kBM x kGK values, 16-byte chunks along its contiguous dim
#pragma unroll
    for (int i = 0; i < kBM * kGK / 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (AK) {
        const int r = idx / (kBM / 8), c = (idx % (kBM / 8)) * 8;     // r: k, c: m
        const bool in = k0 + r < g.a_rows && m0 + c < g.a_cols;
        cp_async16(as + r * kSAT + c, in ? A + (int64_t)(k0 + r) * g.lda + m0 + c : A, in);
      } else {
        const int r = idx / (kGK / 8), c = (idx % (kGK / 8)) * 8;     // r: m, c: k
        const bool in = m0 + r < g.a_rows && k0 + c < g.a_cols;
        cp_async16(as + r * kSA + c, in ? A + (int64_t)(m0 + r) * g.lda + k0 + c : A, in);
      }
    }
#pragma unroll
    for (int i = 0; i < kGK * kBN / 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;       // r: k, c: n
      const bool in = k0 + r < g.b_rows && n0 + c < g.N;
      cp_async16(bs + r * kSB + c, in ? B + (int64_t)(k0 + r) * g.ldb + n0 + c : B, in);
    }
  };

  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < nk) load(nxt, nxt % kStages);
    cp_async_commit();
    const T* as = As + (it % kStages) * kATile;
    const T* bs = Bs + (it % kStages) * kGK * kSB;
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mrow = wm * 64 + mt * 16;
        if (AK)
          ldmatrix_x4_trans(af[mt], as + (kk * 16 + (mi >> 1) * 8 + (lane & 7)) * kSAT + mrow +
                                        (mi & 1) * 8);
        else
          ldmatrix_x4(af[mt], as + (mrow + (mi & 1) * 8 + (lane & 7)) * kSA + kk * 16 +
                                  (mi >> 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kSB + wn * kNT * 8 +
                                  np * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          MmaOp<T>::run(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          MmaOp<T>::run(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  T* C = static_cast<T*>(g.c);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + wm * 64 + (r >> 1) * 16 + gq + (r & 1) * 8;
    if (row >= g.M) continue;
    const int mt = r >> 1, half = r & 1;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = n0 + wn * kNT * 8 + nt * 8 + tig * 2;
      if (col < g.N)
        *reinterpret_cast<uint32_t*>(C + (int64_t)row * g.ldc + col) =
            MmaOp<T>::pack(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
    }
  }
}

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
// launches
// ---------------------------------------------------------------------------

template <typename T, bool AK>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  constexpr int kATile = AK ? kGK * kSAT : kBM * kSA;
  const size_t smem = (size_t)kStages * (kATile + kGK * kSB) * sizeof(T);
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_mma<T, AK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + kBN - 1) / kBN);
  gemm_mma<T, AK><<<grid, kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <bool AK>
cudaError_t gemm(int dtype, const GemmArgs& g, cudaStream_t stream) {
  switch (dtype) {
    case kF32: {
      const dim3 grid((g.M + kFM - 1) / kFM, (g.N + kFN - 1) / kFN);
      gemm_f32<AK><<<grid, 256, 0, stream>>>(g);
      return cudaGetLastError();
    }
    case kBF16: return launch_gemm<__nv_bfloat16, AK>(g, stream);
    case kF16: return launch_gemm<__half, AK>(g, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dlog(const DlogArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * (kBM + kBN) * kSK * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      dlog_mma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.T + kBM - 1) / kBM), (a.vp + kBN - 1) / kBN);
  dlog_mma<T><<<grid, kThreads, smem, stream>>>(a);
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
  cudaError_t err;
  switch (dtype) {
    case kF32: {
      const dim3 grid((unsigned)((T + kFM - 1) / kFM), (vp + kFN - 1) / kFN);
      dlog_f32<<<grid, 256, 0, s>>>(a);
      err = cudaGetLastError();
      break;
    }
    case kBF16: err = launch_dlog<__nv_bfloat16>(a, s); break;
    case kF16: err = launch_dlog<__half>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  // dh [T, hid] = dlog [T, vp] e [vp, hid]; e's rows past V read as 0
  const GemmArgs gm{dlog, e, dh, (int)T, hid, vp, (int)T, vp, V, vp, hid, hid};
  return (int)gemm<false>(dtype, gm, s);
}

// dlog [T, vp] as apex_fused_lm_head_dh wrote it; h [T, hid]; de [V, hid]
// in the input dtype.  Writes de = dlog^T h.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int apex_fused_lm_head_de(const void* dlog, const void* h, void* de, long long T,
                                     int V, int hid, int vp, int dtype, void* stream) {
  if (!shapes_ok(T, V, hid, vp)) return cudaErrorInvalidValue;
  // de [V, hid] = dlog^T [V, T] h [T, hid]; dlog read k-major (row t, column v)
  const GemmArgs gm{dlog, h, de, V, hid, (int)T, (int)T, vp, (int)T, vp, hid, hid};
  return (int)gemm<true>(dtype, gm, static_cast<cudaStream_t>(stream));
}
