// Fused LM-head cross-entropy forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/fused_lm_head.py::_fwd_kernel, the Pallas TPU kernel
// launched by _pallas_fused_fwd.  Same function: for hidden H [T, h], the
// LM-head table E [V, h] and int32 labels [T],
//   logits = H E^T (fp32 accumulation), lse = logsumexp(logits, axis=-1),
//   loss = lse - logits[label],
// written as per-token fp32 loss [T] and lse [T].  The [T, V] logits never
// reach device memory.  A label outside [0, V) (an ignore id such as -100,
// or V itself) matches no column, so its target logit is exactly 0 and its
// loss is lse, as in the JAX kernel; it is not clamped.
//
// Bound: operations.  At the main path's shape (T 8192, h 2048, V 32000,
// bf16) the product is 2 * T * V * h = 1.07 TFLOP against 4 * 1e6 bytes of
// labels and output and 32 + 131 MB of H and E, so the tensor-core rate
// (989 TFLOP/s in bf16) sets the least time: about 1.09 ms.
//
// Design for that bound.  The vocab is split across blocks so that the grid
// fills the 132 SMs in several waves: block (i, s) owns 128 tokens and one
// chunk of the vocab (a multiple of 128 columns, chosen by the caller; at
// the main shape 64 x 32 blocks, about eight waves of two blocks an SM, so
// the last wave's idle SMs cost little).  It loops over the
// chunk's 128-column vocab tiles, and for each over h in steps of 64: the
// H and E tiles stream through a 3-stage cp.async ring in shared memory, and
// 4 warps (2 x 2, each 64 tokens x 64 columns) run mma.sync m16n8k16 on bf16
// or fp16 operands with fp32 accumulation, so the logits tile lives only in
// registers.  When a vocab tile is complete, each lane folds its logits into
// a running (max, sum of exp, target) per row in registers (the vocab tail
// past V is masked there), and the tile's registers start over.  At the end
// the lanes and warps of a row merge their triples, and the block writes one
// partial (m, l, t) per token for its chunk.  A second pass merges the
// chunks of each token: lse = M + log(sum l exp(m - M)), loss = lse - sum t.
// The partials are 12 bytes per token per chunk, in a workspace the caller
// allocates.  fp32 inputs take a separate CUDA-core kernel in full fp32
// (never TF32), with the same partials and the same second pass.
//
// One call of the C entry point launches the tile kernel and its merge pass.
//
// C interface (loaded with ctypes): apex_fused_lm_head_fwd returns
// cudaGetLastError() after the launches, 0 on success.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

struct Args {
  const void* h;       // [T, hid]
  const void* e;       // [V, hid]
  const int* labels;   // [T]
  float* ws;           // [3, nsplit, T]: m, l, t
  int64_t T;
  int V, hid;
  int chunk;           // vocab columns per split
  int nsplit;
};

// merge the triple (m2, l2, t2) of some columns into (m, l, t) of others
__device__ __forceinline__ void merge(float& m, float& l, float& t, float m2, float l2,
                                      float t2) {
  const float mn = fmaxf(m, m2);
  t += t2;
  if (mn == -CUDART_INF_F) return;                 // both still empty
  l = l * expf(m - mn) + l2 * expf(m2 - mn);       // expf(-inf) = 0
  m = mn;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kWarpsN = 2;                 // 2 x 2 warps, each 64 tokens x 64 columns
constexpr int kThreads = 32 * 2 * kWarpsN;
constexpr int kNT = kBN / kWarpsN / 8;     // n8 tiles a warp
constexpr int kSK = kBK + 8;   // shared row stride (elements): conflict-free ldmatrix

template <typename T>
__global__ void __launch_bounds__(kThreads)
lm_head_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Hs = reinterpret_cast<T*>(smem_raw);          // [kStages][kBM][kSK]
  T* Es = Hs + kStages * kBM * kSK;                // [kStages][kBN][kSK]

  const int64_t t0 = (int64_t)blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int v_begin = split * a.chunk;
  const int v_end = min(a.V, v_begin + a.chunk);
  const int n_vt = (v_end - v_begin + kBN - 1) / kBN;
  const int nk = (a.hid + kBK - 1) / kBK;
  const int total = n_vt * nk;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, tig = lane & 3;
  const T* H = static_cast<const T*>(a.h);
  const T* E = static_cast<const T*>(a.e);

  auto load = [&](int it, int stage) {
    const int v0 = v_begin + (it / nk) * kBN;
    const int k0 = (it % nk) * kBK;
    T* hs = Hs + stage * kBM * kSK;
    T* es = Es + stage * kBN * kSK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
      const bool kin = k0 + c < a.hid;
      const bool hin = kin && t0 + r < a.T;
      cp_async16(hs + r * kSK + c, hin ? H + (t0 + r) * a.hid + k0 + c : H, hin);
      const bool ein = kin && v0 + r < v_end;
      cp_async16(es + r * kSK + c, ein ? E + (int64_t)(v0 + r) * a.hid + k0 + c : E, ein);
    }
  };

  // this lane's 8 rows: row(r) = t0 + wm * 64 + (r >> 1) * 16 + g + (r & 1) * 8
  int lab[8];
  float m[8], l[8], t[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t row = t0 + wm * 64 + (r >> 1) * 16 + g + (r & 1) * 8;
    lab[r] = row < a.T ? a.labels[row] : -1;
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
    t[r] = 0.f;
  }
  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < total) load(nxt, nxt % kStages);
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

    if (it % nk == nk - 1) {
      // a vocab tile is complete: fold it into the rows' running triples
      const int v0 = v_begin + (it / nk) * kBN + wn * kNT * 8;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int mt = r >> 1, half = r & 1;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + nt * 8 + tig * 2 + e;
            const float x = acc[mt][nt][half * 2 + e];
            if (col < v_end) {
              mx = fmaxf(mx, x);
              if (col == lab[r]) t[r] += x;
            }
          }
        if (mx != -CUDART_INF_F) {
          const float mn = fmaxf(m[r], mx);
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = v0 + nt * 8 + tig * 2 + e;
              if (col < v_end) sum += expf(acc[mt][nt][half * 2 + e] - mn);
            }
          l[r] = l[r] * expf(m[r] - mn) + sum;
          m[r] = mn;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the merge

  // merge the four lanes of a row, then the warps (wn) of a row
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float t2 = __shfl_xor_sync(0xffffffffu, t[r], o);
      merge(m[r], l[r], t[r], m2, l2, t2);
    }
  float* Sm = reinterpret_cast<float*>(smem_raw);  // [kWarpsN][kBM] each
  float* Sl = Sm + kWarpsN * kBM;
  float* St = Sl + kWarpsN * kBM;
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = wm * 64 + (r >> 1) * 16 + g + (r & 1) * 8;
      Sm[wn * kBM + row] = m[r];
      Sl[wn * kBM + row] = l[r];
      St[wn * kBM + row] = t[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM && t0 + threadIdx.x < a.T) {
    const int row = threadIdx.x;
    float mm = Sm[row], ll = Sl[row], tt = St[row];
    for (int w = 1; w < kWarpsN; ++w) merge(mm, ll, tt, Sm[w * kBM + row], Sl[w * kBM + row], St[w * kBM + row]);
    const int64_t at = (int64_t)split * a.T + t0 + row;
    a.ws[at] = mm;
    a.ws[(int64_t)a.nsplit * a.T + at] = ll;
    a.ws[2 * (int64_t)a.nsplit * a.T + at] = tt;
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(256)
lm_head_f32(const Args a) {
  __shared__ float Hs[kFK][kFM + 4];
  __shared__ float Es[kFK][kFN + 4];
  const int64_t t0 = (int64_t)blockIdx.x * kFM;
  const int split = blockIdx.y;
  const int v_begin = split * a.chunk;
  const int v_end = min(a.V, v_begin + a.chunk);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;   // rows ty*4.., cols tx + 16j
  const float* H = static_cast<const float*>(a.h);
  const float* E = static_cast<const float*>(a.e);

  int lab[4];
  float m[4], l[4], t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = t0 + ty * 4 + i;
    lab[i] = row < a.T ? a.labels[row] : -1;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
    t[i] = 0.f;
  }
  for (int v0 = v_begin; v0 < v_end; v0 += kFN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < a.hid; k0 += kFK) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = threadIdx.x + i * 256;
        const int r = idx >> 4, c = idx & 15;
        const bool kin = k0 + c < a.hid;
        Hs[c][r] = (kin && t0 + r < a.T) ? H[(t0 + r) * a.hid + k0 + c] : 0.f;
        Es[c][r] = (kin && v0 + r < v_end) ? E[(int64_t)(v0 + r) * a.hid + k0 + c] : 0.f;
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        if (col < v_end) {
          mx = fmaxf(mx, acc[i][j]);
          if (col == lab[i]) t[i] += acc[i][j];
        }
      }
      if (mx != -CUDART_INF_F) {
        const float mn = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v0 + tx + 16 * j < v_end) sum += expf(acc[i][j] - mn);
        l[i] = l[i] * expf(m[i] - mn) + sum;
        m[i] = mn;
      }
    }
  }
  // the 16 lanes of a row (tx) sit in one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o <= 8; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float t2 = __shfl_xor_sync(0xffffffffu, t[i], o);
      merge(m[i], l[i], t[i], m2, l2, t2);
    }
    const int64_t row = t0 + ty * 4 + i;
    if (tx == 0 && row < a.T) {
      const int64_t at = (int64_t)split * a.T + row;
      a.ws[at] = m[i];
      a.ws[(int64_t)a.nsplit * a.T + at] = l[i];
      a.ws[2 * (int64_t)a.nsplit * a.T + at] = t[i];
    }
  }
}

// the second pass: merge each token's chunks
__global__ void lm_head_merge(const float* __restrict__ ws, int nsplit, int64_t T,
                              float* __restrict__ loss, float* __restrict__ lse) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  float m = -CUDART_INF_F, l = 0.f, t = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const int64_t at = (int64_t)s * T + i;
    merge(m, l, t, ws[at], ws[(int64_t)nsplit * T + at], ws[2 * (int64_t)nsplit * T + at]);
  }
  const float out = m + logf(l);
  lse[i] = out;
  loss[i] = out - t;
}

template <typename T>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * (kBM + kBN) * kSK * sizeof(T);
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      lm_head_mma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.T + kBM - 1) / kBM), a.nsplit);
  lm_head_mma<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// h [T, hid] and e [V, hid] contiguous, of one dtype (0 fp32, 1 bf16, 2
// fp16), 16-byte aligned, hid % 8 == 0; labels [T] int32; loss and lse [T]
// fp32; ws [3, nsplit, T] fp32 scratch.  Split s covers vocab columns
// [s * chunk, (s + 1) * chunk); chunk is a multiple of 128 and nsplit *
// chunk >= V.  Launches on `stream` and returns cudaGetLastError().
extern "C" int apex_fused_lm_head_fwd(const void* h, const void* e, const void* labels,
                                      void* loss, void* lse, void* ws, long long T,
                                      int V, int hid, int chunk, int nsplit, int dtype,
                                      void* stream) {
  if (T < 1 || V < 1 || hid < 8 || hid % 8 || chunk < 128 || chunk % 128 || nsplit < 1 ||
      (long long)chunk * (nsplit - 1) >= V || (long long)chunk * nsplit < V ||
      nsplit > 65535)
    return cudaErrorInvalidValue;
  const Args a{h, e, static_cast<const int*>(labels), static_cast<float*>(ws),
               (int64_t)T, V, hid, chunk, nsplit};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32: {
      const dim3 grid((unsigned)((T + kFM - 1) / kFM), nsplit);
      lm_head_f32<<<grid, 256, 0, s>>>(a);
      err = cudaGetLastError();
      break;
    }
    case kBF16: err = launch_mma<__nv_bfloat16>(a, s); break;
    case kF16: err = launch_mma<__half>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  lm_head_merge<<<(unsigned)((T + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), nsplit, (int64_t)T, static_cast<float*>(loss),
      static_cast<float*>(lse));
  return (int)cudaGetLastError();
}
