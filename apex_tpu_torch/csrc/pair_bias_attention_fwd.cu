// Pair-bias flash attention forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pair_bias_attention.py::_fwd_kernel, the Pallas TPU
// kernel launched by _pallas_fwd.  Same function: for q, k, v [R, h, s, d]
// (R = r * b rows-major, pair_bias.cuh), the pair bias [b, h, s, s] and an
// optional kv mask [R, s],
//   o   = softmax(q k^T * scale + bias[R_idx % b, head], masked keys out) v
//   lse = logsumexp of the same scores over the valid keys
// with o in q's dtype and lse in fp32; a row with no valid key gives o = 0
// and lse = +inf.  Masked scores never enter a sum (the Pallas kernel fills
// them with -1e30 and zeroes their p; here they are -inf and exp2 gives 0).
//
// Bound.  At the main path's shape (R 128, h 8, s 1024, d 32, bf16) the two
// products are 4 R h s^2 d = 137.4 GFLOP (0.139 ms at 989 TFLOP/s) and the
// softmax takes R h s^2 = 1.07e9 exponentials, 0.257 ms at the SFU rate
// (16 a clock an SM, 132 SMs, 1.98 GHz); q, k, v, o and the bias are 285
// MB (0.085 ms at 3.35 TB/s).  The exponentials bind: at d = 32 each
// score takes 64 multiply-adds on the tensor cores but one exp2 on the
// far slower special-function units.
//
// Design.  The flash forward's (flash_attention_fwd.cu): one block of 4
// warps owns 64 query rows of one (R row, head) and loops over key tiles of
// 64, K and V double-buffered in shared memory with cp.async; each warp's
// q fragments, running max, sum and fp32 output stay in registers, s = q
// k^T and o += p v run on mma.sync m16n8k16, and p goes from the first
// product's accumulators straight into the second's operand registers.
// What pair bias adds: the [64 x 64] bias tile of each key tile comes
// into shared memory with K and V (cp.async, double-buffered), with the
// kv mask as a per-key term of 0 or -inf, and each lane folds both into
// one additive term (pair_bias.cuh).  Where a bias row is not whole
// 16-byte chunks (s * element size % 16 != 0) each lane instead reads its
// 32 values from global memory, two adjacent columns a load, before the
// products so that the loads overlap them.  The blocks start x fastest, x
// being the (R row, head): the blocks in flight at once share a query tile
// and so read the same bias rows, which the 50 MB L2 then serves to all r
// MSA rows.  d is zero-padded in shared memory to the next of
// 16/32/64/128 (mma's k is 16); any s, the ragged tile masked.  No causal
// mask, no dropout, no GQA.  fp32 inputs take a CUDA-core kernel in full
// fp32: one warp a query row, 32 keys a step.
//
// C interface (loaded with ctypes): apex_pair_bias_attention_fwd takes the
// argument list of pair_bias.cuh (o and lse written) and returns
// cudaGetLastError() after the launch, 0 on success.

#include "pair_bias.cuh"

namespace {

// registers held so that 4 (d <= 32), 3 (d 64) or 2 (d 128) blocks share an SM
constexpr int fwd_blocks(int d) { return d <= 32 ? 4 : (d <= 64 ? 3 : 2); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, fwd_blocks(D))
pair_bias_fwd_mma(const Params p) {
  constexpr int SD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBM * SD;                           // [2][kBN][SD]
  T* Vs = Ks + 2 * kBN * SD;                       // [2][kBN][SD]
  // staged bias tiles [2][kBM][kBiasStride] and mask terms [2][kBN]
  unsigned char* Bs = reinterpret_cast<unsigned char*>(Vs + 2 * kBN * SD);
  const int btb = bias_tile_bytes(p.bias_dtype == kF32 ? 4 : 2);
  float* Madd = reinterpret_cast<float*>(Bs + (p.staged ? 2 * btb : 0));

  const int g = blockIdx.x;                        // R_idx * h + head
  const int R_idx = g / p.h, head = g % p.h;
  const int q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;

  const T* qb = static_cast<const T*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1];
  const T* kb = static_cast<const T*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1];
  const T* vb = static_cast<const T*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1];
  const unsigned char* bb = bias_base(p, R_idx, head);
  const uint8_t* mrow = p.mask ? p.mask + (int64_t)R_idx * p.s : nullptr;
  const int n_tiles = (p.s + kBN - 1) / kBN;

  load_tile<T, D>(Qs, qb, p.st[kQ][2], q0, p.s, p.d);
  auto load_kv = [&](int j, int stage) {
    load_tile<T, D>(Ks + stage * kBN * SD, kb, p.st[kK][2], j * kBN, p.s, p.d);
    load_tile<T, D>(Vs + stage * kBN * SD, vb, p.st[kV][2], j * kBN, p.s, p.d);
    if (p.staged) {
      stage_bias_tile(Bs + stage * btb, p, bb, q0, j * kBN);
      stage_mask_term(Madd + stage * kBN, p, mrow, j * kBN);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // this lane's two query rows: row_a = gr, row_b = gr + 8 within the warp's 16
  const int row_a = q0 + warp * 16 + gr, row_b = row_a + 8;
  const float scale_log2 = p.scale * kLog2e;

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
    const int k0 = j * kBN;
    float add[kBN / 8][4];
    if (!p.staged) bias_tile(add, p, bb, mrow, row_a, k0, tig);   // before the wait
    if (j + 1 < n_tiles) {
      load_kv(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (p.staged) bias_tile_smem(add, p, Bs + stage * btb, Madd + stage * kBN, warp, gr, tig);
    if (j == 0) a_frags<T, D>(qf, Qs, warp, lane);
    const T* Kt = Ks + stage * kBN * SD;
    const T* Vt = Vs + stage * kBN * SD;

    float sc[kBN / 8][4];
    mma_abt<T, D>(sc, qf, Kt, lane);
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = fmaf(sc[n][c], scale_log2, add[n][c]);   // -inf where masked
        sc[n][c] = v;
        if (c < 2) mx_a = fmaxf(mx_a, v); else mx_b = fmaxf(mx_b, v);
      }
    // the four lanes of a row hold its 64 keys between them
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no valid key yet keeps everything at zero: its max stays
    // -inf, the correction is 1 and exp2(-inf - 0) = 0
    const float corr_a = mn_a == -CUDART_INF_F ? 1.f : fast_exp2(m_a - mn_a);
    const float corr_b = mn_b == -CUDART_INF_F ? 1.f : fast_exp2(m_b - mn_b);
    const float base_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
    const float base_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = fast_exp2(sc[n][c] - ((c < 2) ? base_a : base_b));
        if (c < 2) sum_a += e; else sum_b += e;
        sc[n][c] = e;
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
    mma_xb<T, D>(acc, sc, Vt, lane);                // o += p v
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  // o = acc / l, 0 on a row with no valid key: rows a and b take their own
  // factor, so store them one at a time
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  T* ob = static_cast<T*>(p.o) + R_idx * p.st[kO][0] + head * p.st[kO][1];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (i * 8 >= p.d) break;
    const int col = i * 8 + tig * 2;
    if (row_a < p.s)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * p.st[kO][2] + col) =
          MmaOp<T>::pack(acc[i][0] * inv_a, acc[i][1] * inv_a);
    if (row_b < p.s)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * p.st[kO][2] + col) =
          MmaOp<T>::pack(acc[i][2] * inv_b, acc[i][3] * inv_b);
  }
  if (tig == 0) {
    // lse in natural-log units: (m + log2 l) * ln 2
    float* lb = p.lse + (int64_t)g * p.s;
    if (row_a < p.s)
      lb[row_a] = l_a > 0.f ? (m_a + log2f(l_a)) * 0.6931471805599453f : CUDART_INF_F;
    if (row_b < p.s)
      lb[row_b] = l_b > 0.f ? (m_b + log2f(l_b)) * 0.6931471805599453f : CUDART_INF_F;
  }
}

// fp32: one warp a query row, one key a lane, 32 keys a step
template <int D>
__global__ void __launch_bounds__(kF32Rows * 32)
pair_bias_fwd_f32(const Params p) {
  constexpr int E = D / 32;                        // output values a lane
  __shared__ float Kt[kF32Cols][D + 1];            // +1: lane j reads row j
  __shared__ float Vt[kF32Cols][D];
  __shared__ float Qr[kF32Rows][D];

  const int g = blockIdx.y;
  const int R_idx = g / p.h, head = g % p.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kF32Rows + warp;
  const bool row_in = row < p.s;

  const float* qb = static_cast<const float*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1];
  const float* kb = static_cast<const float*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1];
  const float* vb = static_cast<const float*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1];
  const unsigned char* bb = bias_base(p, R_idx, head);
  const uint8_t* mrow = p.mask ? p.mask + (int64_t)R_idx * p.s : nullptr;

  for (int c = lane; c < D; c += 32)
    Qr[warp][c] = row_in && c < p.d ? qb[(int64_t)row * p.st[kQ][2] + c] : 0.f;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  const int n_tiles = (p.s + kF32Cols - 1) / kF32Cols;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF32Cols;
    __syncthreads();   // the last tile's reads are done (and Qr is written)
    for (int c = threadIdx.x; c < kF32Cols * D; c += kF32Rows * 32) {
      const int r = c / D, col = c % D;
      const bool in = k0 + r < p.s && col < p.d;
      Kt[r][col] = in ? kb[(int64_t)(k0 + r) * p.st[kK][2] + col] : 0.f;
      Vt[r][col] = in ? vb[(int64_t)(k0 + r) * p.st[kV][2] + col] : 0.f;
    }
    __syncthreads();

    const int col = k0 + lane;                     // this lane's key
    float sv = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) sv = fmaf(Qr[warp][c], Kt[lane][c], sv);
    const bool ok = col < p.s && (mrow == nullptr || mrow[col] != 0);
    sv = ok ? sv * p.scale + (row_in ? load_elem(bb, (int64_t)row * p.s + col, p.bias_dtype) : 0.f)
            : -CUDART_INF_F;
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
#pragma unroll
    for (int e2 = 0; e2 < E; ++e2) acc[e2] *= corr;
    for (int jj = 0; jj < kF32Cols; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, e, jj);
#pragma unroll
      for (int e2 = 0; e2 < E; ++e2) acc[e2] = fmaf(pj, Vt[jj][lane + 32 * e2], acc[e2]);
    }
  }
  if (!row_in) return;
  float* ob = static_cast<float*>(p.o) + R_idx * p.st[kO][0] + head * p.st[kO][1] +
              (int64_t)row * p.st[kO][2];
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < p.d) ob[lane + 32 * e] = l > 0.f ? acc[e] / l : 0.f;
  if (lane == 0) p.lse[(int64_t)g * p.s + row] = l > 0.f ? m + logf(l) : CUDART_INF_F;
}

template <typename T, int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int SD = D + kPad;
  const size_t smem = (size_t)(kBM + 4 * kBN) * SD * sizeof(T) +
                      (p.staged ? 2 * bias_tile_bytes(p.bias_dtype == kF32 ? 4 : 2) +
                                      2 * kBN * sizeof(float)
                                : 0);
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      pair_bias_fwd_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.R * p.h, (p.s + kBM - 1) / kBM);
  pair_bias_fwd_mma<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.s + kF32Rows - 1) / kF32Rows, p.R * p.h);
  pair_bias_fwd_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_d(const Params& p, cudaStream_t stream) {
  if (p.d <= 16) return launch_mma<T, 16>(p, stream);
  if (p.d <= 32) return launch_mma<T, 32>(p, stream);
  if (p.d <= 64) return launch_mma<T, 64>(p, stream);
  return launch_mma<T, 128>(p, stream);
}

}  // namespace

extern "C" int apex_pair_bias_attention_fwd(PAIR_BIAS_ARGS) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (p.d <= 32) return (int)launch_f32<32>(p, st);
      if (p.d <= 64) return (int)launch_f32<64>(p, st);
      return (int)launch_f32<128>(p, st);
    case kBF16: return (int)launch_mma_d<__nv_bfloat16>(p, st);
    case kF16: return (int)launch_mma_d<__half>(p, st);
  }
  return cudaErrorInvalidValue;
}
