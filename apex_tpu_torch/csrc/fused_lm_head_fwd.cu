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
// Design for that bound.  The logits product is wgmma_sm90.cuh's GEMM
// mainloop, the one the head backward runs its logits through: H and E
// both K-major, TMA into a 4-stage ring of 128-byte-swizzled stages, one
// producer warp, two consumer warpgroups of wgmma m64n256k16 with fp32
// accumulators in registers, one 128 x 256 tile of the logits a block.
// Its epilogue (PartialsStore) never stores the tile: each thread folds
// its two rows' 64 columns into a (max, sum of exp, target) triple per row
// (2^x in log2 units on the hardware exp2), the four lanes of a row merge
// theirs with quad shuffles, and one lane writes the row's triple for this
// vocab tile to a workspace ws [3, ceil(V / 256), T] (12 bytes a token and
// tile: 12.3 MB at the main shape, 19.4 MB at GPT-2-large's V 50257) that
// the caller allocates.  The two consumer warpgroups own different rows,
// so no merge crosses warpgroups.  A second pass merges each token's tiles:
// lse = M + log(sum l exp(m - M)), loss = lse - sum t; a block takes 32
// tokens, eight warps over the tiles, and merges the eight partials in
// shared memory, in one order, so a call gives the same bits every time.
// fp32 inputs take a separate CUDA-core kernel in full fp32 (never TF32),
// writing the same partials over the same 256-column tiles for the same
// second pass.
//
// What bit, and what the design does about it:
// - The ragged last vocab tile: TMA fills E's rows past V with zeros, whose
//   logits read 0 (GPT-2-large's V = 50257 leaves 175 such columns).  On
//   that tile alone the epilogue masks columns >= V out of the max and the
//   sum, and a label matches a column only inside [0, V).
// - The mainloop's store of the tile to C: the epilogue's compile-time
//   kStores = false removes it, and the two barriers around it, from this
//   instantiation; the head backward's epilogues keep theirs.
// - The merge pass: one thread a token over ceil(V / 256) tiles (125 at the
//   main shape) would loop on 32 blocks; eight warps a token group split
//   the loop, and the eight partials merge in shared memory.
//
// One call of the C entry point launches the tile kernel and its merge pass.
//
// C interface (loaded with ctypes): apex_fused_lm_head_fwd returns
// cudaGetLastError() after the launches, 0 on success, and
// cudaErrorInvalidValue for a shape it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

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
// bf16 / fp16: the logits on wgmma_sm90.cuh, reduced in the epilogue
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// The logits tile's epilogue: no store of C; each row's (max, sum of exp,
// target) over the tile's columns inside [0, V), into ws [3, tiles, rows]
// at the tile's index col0 / kGemmBN.
struct PartialsStore {
  static constexpr bool kStores = false;
  float* ws;
  int64_t rows;             // T
  int V;
  int tiles;                // ceil(V / kGemmBN)
  const int* labels;

  // element i of `acc` lies at row row0 + 16 (tid / 32) + (tid % 32) / 4 +
  // 8 ((i / 2) % 2), column col0 + 8 (i / 4) + 2 (tid % 4) + i % 2
  __device__ __forceinline__ void stage(float (&acc)[128], int64_t row0, int col0,
                                        int tid) const {
    const int lane = tid % 32;
    const int c0 = col0 + 2 * (lane % 4);         // this lane's first column
    // only the last tile reaches past V; there its zero-filled columns drop out
    const bool ragged = col0 + kGemmBN > V;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = row0 + 16 * (tid / 32) + lane / 4 + 8 * half;
      int lab = row < rows ? labels[row] : -1;
      if (lab >= V) lab = -1;                     // matches no column, pad or not
      float mx = -CUDART_INF_F, tgt = 0.f;
      if (ragged) {
#pragma unroll
        for (int j = 0; j < kGemmBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * j + e;
            float& x = acc[4 * j + 2 * half + e];
            x = col < V ? x : -CUDART_INF_F;
            mx = fmaxf(mx, x);
            tgt = col == lab ? x : tgt;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kGemmBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[4 * j + 2 * half + e];
            mx = fmaxf(mx, x);
            tgt = c0 + 8 * j + e == lab ? x : tgt;
          }
      }
      // sum of e^(x - mx) as 2^(x log2e - mx log2e); a lane with no column
      // inside V (mx = -inf) sums zeros
      const float shift = mx == -CUDART_INF_F ? 0.f : mx * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kGemmBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += fast_exp2(fmaf(acc[4 * j + 2 * half + e], kLog2e, -shift));
      float m = mx, l = sum, t = tgt;
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, x);
        const float l2 = __shfl_xor_sync(0xffffffffu, l, x);
        const float t2 = __shfl_xor_sync(0xffffffffu, t, x);
        merge(m, l, t, m2, l2, t2);
      }
      if (lane % 4 == 0 && row < rows) {
        const int64_t at = (int64_t)(col0 / kGemmBN) * rows + row;
        ws[at] = m;
        ws[(int64_t)tiles * rows + at] = l;
        ws[2 * (int64_t)tiles * rows + at] = t;
      }
    }
  }
};

// the logits H E^T over 128 x 256 tiles, each reduced to ws by PartialsStore
template <typename T>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap h_k, e_k;
  if (!tensor_map<T>(&h_k, a.h, a.T, a.hid, kGemmBM) ||
      !tensor_map<T>(&e_k, a.e, a.V, a.hid, kGemmBN))
    return cudaErrorInvalidValue;
  const PartialsStore epi{a.ws, a.T, a.V, a.nsplit, a.labels};
  return launch_wgmma_gemm<T, false, false>(h_k, e_k, a.T, a.V, a.hid, epi, stream);
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

// ---------------------------------------------------------------------------
// the second pass: merge each token's vocab tiles
// ---------------------------------------------------------------------------

constexpr int kMergeTokens = 32;   // tokens a block, one a lane
constexpr int kMergeWays = 8;      // warps a block, each over every eighth tile

__global__ void __launch_bounds__(kMergeTokens * kMergeWays)
lm_head_merge(const float* __restrict__ ws, int nsplit, int64_t T, float* __restrict__ loss,
              float* __restrict__ lse) {
  __shared__ float part[3][kMergeWays][kMergeTokens];
  const int x = threadIdx.x % kMergeTokens, y = threadIdx.x / kMergeTokens;
  const int64_t i = (int64_t)blockIdx.x * kMergeTokens + x;
  float m = -CUDART_INF_F, l = 0.f, t = 0.f;
  if (i < T)
    for (int s = y; s < nsplit; s += kMergeWays) {
      const int64_t at = (int64_t)s * T + i;
      merge(m, l, t, ws[at], ws[(int64_t)nsplit * T + at], ws[2 * (int64_t)nsplit * T + at]);
    }
  part[0][y][x] = m;
  part[1][y][x] = l;
  part[2][y][x] = t;
  __syncthreads();
  if (y != 0 || i >= T) return;
  for (int w = 1; w < kMergeWays; ++w) merge(m, l, t, part[0][w][x], part[1][w][x], part[2][w][x]);
  const float out = m + logf(l);
  lse[i] = out;
  loss[i] = out - t;
}

}  // namespace

// h [T, hid] and e [V, hid] contiguous, of one dtype (0 fp32, 1 bf16, 2
// fp16), 16-byte aligned, hid % 8 == 0; labels [T] int32; loss and lse [T]
// fp32; ws [3, tiles, T] fp32 scratch, tiles = ceil(V / 256): tile s covers
// vocab columns [256 s, 256 (s + 1)).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int apex_fused_lm_head_fwd(const void* h, const void* e, const void* labels,
                                      void* loss, void* lse, void* ws, long long T,
                                      int V, int hid, int tiles, int dtype, void* stream) {
  if (T < 1 || T > 0x7fffffffLL || V < 1 || hid < 8 || hid % 8 ||
      tiles != (V + kGemmBN - 1) / kGemmBN || tiles > 65535)
    return cudaErrorInvalidValue;
  const Args a{h, e, static_cast<const int*>(labels), static_cast<float*>(ws),
               (int64_t)T, V, hid, kGemmBN, tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32: {
      const dim3 grid((unsigned)((T + kFM - 1) / kFM), tiles);
      lm_head_f32<<<grid, 256, 0, s>>>(a);
      err = cudaGetLastError();
      break;
    }
    case kBF16: err = launch_wgmma<__nv_bfloat16>(a, s); break;
    case kF16: err = launch_wgmma<__half>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  lm_head_merge<<<(unsigned)((T + kMergeTokens - 1) / kMergeTokens), kMergeTokens * kMergeWays,
                  0, s>>>(static_cast<const float*>(ws), tiles, (int64_t)T,
                          static_cast<float*>(loss), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}
