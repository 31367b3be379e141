// Flash attention forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_fwd_kernel, the Pallas TPU
// kernel launched by _pallas_fwd.  Same function: for q [b, h, sq, d] and k, v
// [b, hk, sk, d] (query head i reads kv head i / (h / hk)),
//   s = q k^T * scale, masked to -inf where the causal mask (col <= row +
//   sk - sq) or the segment ids (qseg[row] == kseg[col]) say so,
//   o = softmax(s) [dropout] v, lse = logsumexp(s) over the valid keys,
// with o in q's dtype and lse in fp32.  A fully-masked row gives o = 0 and
// lse = +inf.  Dropout applies to the normalised probabilities: the keep bit
// of (bh, qpos, kpos) is fmix32(fmix32(fmix32(seed ^ qpos) ^ kpos) ^ bh) >=
// threshold, the JAX counter hash, and kept values are scaled by 1/(1-rate);
// the softmax denominator sums the undropped values.
//
// Bound: operations.  At the main path's shape (b 4, h 32, s 2048, d 64,
// causal) the two products are 4 * b * h * sq * sk * d / 2 = 68.7 GFLOP while
// q, k, v and o are 4 * 33.5 MB, so the card's tensor-core rate (989 TFLOP/s
// in bf16) and not its 3.35 TB/s sets the least time.
//
// Design for that bound.  One block of 4 warps owns 64 query rows of one
// (batch, head) and loops over key tiles of 64 (the loop takes the place of
// the TPU's sequential k grid axis; the 1024x1024 VMEM tiles have no
// counterpart in 227 KB of shared memory).  Each warp owns 16 query rows:
// its q fragments stay in registers, s = q k^T and o += p v run on the tensor
// cores (mma.sync m16n8k16, bf16 or fp16 operands, fp32 accumulation), and
// the running max, sum and fp32 output accumulator stay in registers, so
// neither the score tile nor p ever reaches shared or device memory: p goes
// from the first product's accumulator registers straight into the second
// product's operand registers.  K and V tiles are double-buffered in shared
// memory with cp.async, so the next tile's load overlaps this tile's
// products.  Key tiles wholly above the causal diagonal are never loaded,
// and under a causal mask the heaviest query tiles are scheduled first.
// The per-element mask runs only on the tiles that need it: the ragged
// edge (sq, sk not multiples of 64), the tiles the causal diagonal crosses,
// and every tile when there are segment ids.
// fp32 inputs take a separate CUDA-core kernel in full fp32 (never TF32):
// one warp per query row, 32 keys a step.
//
// Template parameters are only the element type and the head dim (32, 64
// or 128): nine instantiations.  Causal, segments and dropout are runtime
// arguments.
//
// C interface (loaded with ctypes): apex_flash_attention_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* qseg;   // [b, sq] or null
  const int* kseg;   // [b, sk] or null
  int b, h, hk, sq, sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float scale;
  bool causal;
  bool dropout;
  uint32_t seed;
  uint32_t threshold;
  float keep_scale;
};

// the number of key tiles of width bn a query tile [q0, q_end) must visit
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int q_end, int bn) {
  int kmax = p.sk - 1;
  if (p.causal) {
    const int last = q_end - 1 + (p.sk - p.sq);   // last row's last visible key
    if (last < 0) return 0;
    kmax = min(kmax, last);
  }
  return kmax / bn + 1;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64;        // query rows a block
constexpr int kBN = 64;        // keys a tile
constexpr int kWarps = 4;      // 16 query rows each
constexpr int kPad = 8;        // shared row padding (elements): conflict-free ldmatrix

// rows [row0, row0 + 64) of a [rows, D] operand (row stride `rs` elements)
// into shared memory with row stride D + kPad; rows >= n_rows are zeroed
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* smem, const T* base, int64_t rs, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < kBM * kChunks; c += kWarps * 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool in = row0 + r < n_rows;
    const T* src = in ? base + (int64_t)(row0 + r) * rs + col : base;
    cp_async16(smem + r * (D + kPad) + col, src, in);
  }
}

// at d = 64 the registers are held to 128 a thread so that four blocks (16
// warps) share an SM: measured faster than three blocks at 155 registers;
// d = 32 keeps half the accumulators and the same budget
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, D <= 64 ? 4 : 2)
flash_fwd_mma(const Params p) {
  constexpr int SD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBM * SD;                           // [2][kBN][SD]
  T* Vs = Ks + 2 * kBN * SD;                       // [2][kBN][SD]
  int* Kseg = reinterpret_cast<int*>(Vs + 2 * kBN * SD);   // [2][kBN]

  // blocks start in x-fastest order: x is the (batch, head) and y the
  // query tile, so the heaviest tiles of every head start first (causal:
  // the last query tiles see the most keys) and the light ones fill the
  // tail of the grid
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int khi = hi / (p.h / p.hk);
  const int q_tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kBM;
  const int q_end = min(q0 + kBM, p.sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + khi * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + khi * p.v_sh;
  const bool has_seg = p.qseg != nullptr;

  const int n_tiles = key_tiles(p, q0, q_end, kBN);

  load_tile<T, D>(Qs, qb, p.q_ss, q0, p.sq);
  auto load_kv = [&](int j, int stage) {
    load_tile<T, D>(Ks + stage * kBN * SD, kb, p.k_ss, j * kBN, p.sk);
    load_tile<T, D>(Vs + stage * kBN * SD, vb, p.v_ss, j * kBN, p.sk);
    if (has_seg && threadIdx.x < kBN) {
      const int col = j * kBN + threadIdx.x;
      Kseg[stage * kBN + threadIdx.x] = col < p.sk ? p.kseg[(int64_t)bi * p.sk + col] : 0;
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this lane's two query rows: r0 = g, r1 = g + 8 within the warp's 16
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  int seg_a = 0, seg_b = 0;
  if (has_seg) {
    if (row_a < p.sq) seg_a = p.qseg[(int64_t)bi * p.sq + row_a];
    if (row_b < p.sq) seg_b = p.qseg[(int64_t)bi * p.sq + row_b];
  }
  uint32_t hash_a = 0, hash_b = 0;
  if (p.dropout) {
    hash_a = fmix32(p.seed ^ (uint32_t)row_a);
    hash_b = fmix32(p.seed ^ (uint32_t)row_b);
  }
  const int causal_off = p.sk - p.sq;
  const float scale_log2 = p.scale * 1.4426950408889634f;

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F;   // running max, log2 units
  float l_a = 0.f, l_b = 0.f;                       // this lane's partial sums

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int mi = lane >> 3;
        const T* a = Qs + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * SD + kc * 16 + (mi >> 1) * 8;
        ldmatrix_x4(qf[kc], a);
      }
    }
    const T* Kt = Ks + stage * kBN * SD;
    const T* Vt = Vs + stage * kBN * SD;

    // s = q k^T for this warp's 16 rows x 64 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        uint32_t bfr[4];
        const int mi = lane >> 3;
        const T* b = Kt + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * SD + kc * 16 + (mi & 1) * 8;
        ldmatrix_x4(bfr, b);
        MmaOp<T>::run(s[2 * np], qf[kc], bfr[0], bfr[1]);
        MmaOp<T>::run(s[2 * np + 1], qf[kc], bfr[2], bfr[3]);
      }
    }

    // scale to log2 units and mask: invalid entries become -inf.  Only the
    // ragged last tile, the tiles the causal diagonal crosses and segment
    // ids need the per-element test; the block takes one branch.
    const int k0 = j * kBN;
    const bool need_mask = has_seg || k0 + kBN > p.sk ||
                           (p.causal && k0 + kBN - 1 > q0 + causal_off);
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + n * 8 + tig * 2 + (c & 1);
          const int row = (c < 2) ? row_a : row_b;
          bool ok = col < p.sk;
          if (p.causal) ok = ok && col <= row + causal_off;
          if (has_seg) ok = ok && Kseg[stage * kBN + col - k0] == ((c < 2) ? seg_a : seg_b);
          const float v = ok ? s[n][c] * scale_log2 : -CUDART_INF_F;
          s[n][c] = v;
          if (c < 2) mx_a = fmaxf(mx_a, v); else mx_b = fmaxf(mx_b, v);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = s[n][c] * scale_log2;
          s[n][c] = v;
          if (c < 2) mx_a = fmaxf(mx_a, v); else mx_b = fmaxf(mx_b, v);
        }
      }
    }
    // the four lanes of a row hold its 64 keys between them
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no valid key yet keeps everything at zero
    const float corr_a = mn_a == -CUDART_INF_F ? 1.f : exp2f(m_a - mn_a);
    const float corr_b = mn_b == -CUDART_INF_F ? 1.f : exp2f(m_b - mn_b);
    const float base_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
    const float base_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = fast_exp2(s[n][c] - ((c < 2) ? base_a : base_b));   // -inf -> 0
        float kept = e;
        if (c < 2) sum_a += e; else sum_b += e;
        if (p.dropout) {
          const int col = k0 + n * 8 + tig * 2 + (c & 1);
          const uint32_t hh = fmix32(fmix32(((c < 2) ? hash_a : hash_b) ^ (uint32_t)col) ^
                                     (uint32_t)bh);
          kept = hh >= p.threshold ? e * p.keep_scale : 0.f;
        }
        s[n][c] = kept;
      }
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr_a;
      acc[i][1] *= corr_a;
      acc[i][2] *= corr_b;
      acc[i][3] *= corr_b;
    }

    // o += p v: p's accumulator layout is the A operand layout of m16n8k16
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = MmaOp<T>::pack(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = MmaOp<T>::pack(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = MmaOp<T>::pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = MmaOp<T>::pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bfr[4];
        const int mi = lane >> 3;
        const T* b = Vt + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * SD + dp * 16 + (mi >> 1) * 8;
        ldmatrix_x4_trans(bfr, b);
        MmaOp<T>::run(acc[2 * dp], pa, bfr[0], bfr[1]);
        MmaOp<T>::run(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0 loads q only)

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  T* ob = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + tig * 2;
    if (row_a < p.sq) {
      const uint32_t v = MmaOp<T>::pack(acc[i][0] * inv_a, acc[i][1] * inv_a);
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * p.o_ss + col) = v;
    }
    if (row_b < p.sq) {
      const uint32_t v = MmaOp<T>::pack(acc[i][2] * inv_b, acc[i][3] * inv_b);
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * p.o_ss + col) = v;
    }
  }
  if (tig == 0) {
    // lse in natural-log units: (m + log2 l) * ln 2
    float* lb = p.lse + (int64_t)bh * p.sq;
    if (row_a < p.sq)
      lb[row_a] = l_a > 0.f ? (m_a + log2f(l_a)) * 0.6931471805599453f : CUDART_INF_F;
    if (row_b < p.sq)
      lb[row_b] = l_b > 0.f ? (m_b + log2f(l_b)) * 0.6931471805599453f : CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 8;    // one warp per query row
constexpr int kF32Keys = 32;   // one key per lane a step

template <int D>
__global__ void __launch_bounds__(kF32Rows * 32)
flash_fwd_f32(const Params p) {
  constexpr int E = D / 32;                        // output values a lane
  __shared__ float Kt[kF32Keys][D + 1];            // +1: lane j reads row j
  __shared__ float Vt[kF32Keys][D];
  __shared__ float Qr[kF32Rows][D];
  __shared__ int Kseg[kF32Keys];

  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int khi = hi / (p.h / p.hk);
  const int q0 = blockIdx.x * kF32Rows;
  const int q_end = min(q0 + kF32Rows, p.sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = q0 + warp;
  const bool row_in = row < p.sq;

  const float* qb = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + bi * p.k_sb + khi * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + bi * p.v_sb + khi * p.v_sh;
  const bool has_seg = p.qseg != nullptr;

  for (int c = lane; c < D; c += 32) Qr[warp][c] = row_in ? qb[(int64_t)row * p.q_ss + c] : 0.f;
  const int seg = (has_seg && row_in) ? p.qseg[(int64_t)bi * p.sq + row] : 0;
  const uint32_t hash_q = p.dropout ? fmix32(p.seed ^ (uint32_t)row) : 0u;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  const int n_tiles = key_tiles(p, q0, q_end, kF32Keys);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF32Keys;
    __syncthreads();   // the last tile's reads are done (and Qr is written)
    for (int c = threadIdx.x; c < kF32Keys * D; c += kF32Rows * 32) {
      const int r = c / D, col = c % D;
      const bool in = k0 + r < p.sk;
      Kt[r][col] = in ? kb[(int64_t)(k0 + r) * p.k_ss + col] : 0.f;
      Vt[r][col] = in ? vb[(int64_t)(k0 + r) * p.v_ss + col] : 0.f;
    }
    if (has_seg && threadIdx.x < kF32Keys)
      Kseg[threadIdx.x] = k0 + (int)threadIdx.x < p.sk ? p.kseg[(int64_t)bi * p.sk + k0 + threadIdx.x] : 0;
    __syncthreads();

    const int col = k0 + lane;                     // this lane's key
    float sv = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) sv = fmaf(Qr[warp][c], Kt[lane][c], sv);
    bool ok = col < p.sk;
    if (p.causal) ok = ok && col <= row + (p.sk - p.sq);
    if (has_seg) ok = ok && Kseg[lane] == seg;
    sv = ok ? sv * p.scale : -CUDART_INF_F;
    float mx = sv;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(m, mx);
    const float corr = mn == -CUDART_INF_F ? 1.f : expf(m - mn);
    const float e = expf(sv - (mn == -CUDART_INF_F ? 0.f : mn));   // -inf -> 0
    m = mn;
    float sum = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = l * corr + sum;
    float kept = e;
    if (p.dropout) {
      const uint32_t hh = fmix32(fmix32(hash_q ^ (uint32_t)col) ^ (uint32_t)bh);
      kept = hh >= p.threshold ? e * p.keep_scale : 0.f;
    }
#pragma unroll
    for (int e2 = 0; e2 < E; ++e2) acc[e2] *= corr;
    for (int jj = 0; jj < kF32Keys; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, kept, jj);
#pragma unroll
      for (int e2 = 0; e2 < E; ++e2) acc[e2] = fmaf(pj, Vt[jj][lane + 32 * e2], acc[e2]);
    }
  }
  if (!row_in) return;
  float* ob = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh + (int64_t)row * p.o_ss;
#pragma unroll
  for (int e = 0; e < E; ++e) ob[lane + 32 * e] = l > 0.f ? acc[e] / l : 0.f;
  if (lane == 0) p.lse[(int64_t)bh * p.sq + row] = l > 0.f ? m + logf(l) : CUDART_INF_F;
}

template <typename T, int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int SD = D + kPad;
  const size_t smem = (size_t)(kBM + 4 * kBN) * SD * sizeof(T) + 2 * kBN * sizeof(int);
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.sq + kBM - 1) / kBM);
  flash_fwd_mma<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.sq + kF32Rows - 1) / kF32Rows, p.b * p.h);
  flash_fwd_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_dtype(int dtype, const Params& p, cudaStream_t stream) {
  switch (dtype) {
    case kF32: return launch_f32<D>(p, stream);
    case kBF16: return launch_mma<__nv_bfloat16, D>(p, stream);
    case kF16: return launch_mma<__half, D>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, h, sq, d], k and v [b, hk, sk, d] with element strides (batch, head,
// row) given and a unit last stride; o like q (its own strides); lse
// [b, h, sq] fp32 contiguous; qseg [b, sq] and kseg [b, sk] int32 or both
// null.  16-bit operands start on 16 bytes with strides that are multiples
// of 8.  dtype: 0 fp32, 1 bf16, 2 fp16; d: 32, 64 or 128.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int apex_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qseg, const void* kseg, int b, int h, int hk, int sq, int sk,
    int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int dropout, unsigned seed, unsigned threshold,
    float keep_scale, int dtype, void* stream) {
  if (b < 1 || h < 1 || hk < 1 || h % hk || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  // grid.y: (batch, head) of the fp32 kernel, query tiles of the mma one
  if (b * h > 65535 || (sq + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse),
           static_cast<const int*>(qseg), static_cast<const int*>(kseg),
           b, h, hk, sq, sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal != 0, dropout != 0, seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32: err = by_dtype<32>(dtype, p, s); break;
    case 64: err = by_dtype<64>(dtype, p, s); break;
    case 128: err = by_dtype<128>(dtype, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
