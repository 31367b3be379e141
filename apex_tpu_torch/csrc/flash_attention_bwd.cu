// Flash attention backward for Hopper (sm_90a): dq, and dk with dv.
//
// Replaces: apex_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel,
// the Pallas TPU kernels launched by _pallas_bwd.  Same function: for q
// [b, h, sq, d], k and v [b, hk, sk, d] (query head i reads kv head
// i / (h / hk)), the forward's o and lse [b, h, sq], and do like o,
//   delta = rowsum(do * o)                          (fp32)
//   p     = exp(s * scale - lse), s = q k^T, 0 where masked (lse = +inf on
//           a fully-masked row, so its p is 0)
//   dp    = do v^T, times keep / (1 - rate) under dropout
//   ds    = p * (dp - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p_kept^T do
// where p_kept = p * keep / (1 - rate) and the keep bit of (b * h + head,
// qpos, kpos) is the forward's counter hash (common.cuh).  dk and dv of a
// kv head sum over its group's query heads.  Causal masking aligns to the
// last query (col <= row + sk - sq); segment ids mask qseg[row] != kseg[col].
// As in the Pallas kernels, ds and p_kept are rounded to the input dtype
// before their products; the products accumulate in fp32.
//
// Bound: operations.  At the main path's shape (b 4, h 32 over 8 kv heads,
// s 2048, d 64, causal, bf16) dq is three causal products, s, dp and ds k:
// 103.1 GFLOP; dk/dv four, s, dp, p^T do and ds^T q: 137.5 GFLOP.  Their
// operands are 4 * 33.5 MB at most, so the tensor-core rate (989 TFLOP/s)
// and not the 3.35 TB/s sets the least time: 0.104 and 0.139 ms.
//
// Design for that bound.  Both kernels are the forward's tiling turned
// around the loop the TPU ran as its sequential grid axis:
// - dq: a block of 4 warps owns 64 query rows of one (batch, head) and
//   loops over 64-key tiles, K and V double-buffered in shared memory with
//   cp.async.  Each warp keeps its 16 rows of q and do as mma fragments in
//   registers, recomputes s and dp with mma.sync m16n8k16 (fp32
//   accumulation), forms ds in registers and feeds it, rounded, straight
//   into the A operand of ds k; dq accumulates in fp32 registers.  Before
//   the loop the block sums delta for its rows from o and do and writes it
//   to device memory for the dk/dv kernel (launched after it).
// - dk/dv: a block of 4 warps owns 64 keys of one (batch, kv head) and
//   loops over every query tile of every query head of its group, q, do,
//   lse and delta double-buffered.  Each warp computes s^T and dp^T for
//   its 16 keys (k and v as the A operands), and p^T and ds^T in registers
//   become the A operands of p_kept^T do and ds^T q.  dk and dv accumulate
//   in registers over the whole group, so the GQA sum needs no atomics and
//   no repeated copy of k and v.
// Whole tiles above the causal diagonal are skipped in both (the dq loop
// ends at the last visible key tile, the dk/dv loop starts at the first
// query tile that sees the block's keys), and the per-element mask runs
// only on tiles that need it.  fp32 inputs take CUDA-core kernels in full
// fp32 (never TF32): one warp per query row (dq) or key row (dk/dv), 32
// columns a step.
//
// C interface (loaded with ctypes): apex_flash_attention_dq and
// apex_flash_attention_dkv take one argument list and return
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // [b, h, sq]
  float* delta;        // [b, h, sq]: written by dq, read by dk/dv
  const int* qseg;     // [b, sq] or null
  const int* kseg;     // [b, sk] or null
  void* dq;
  void* dk;
  void* dv;
  int b, h, hk, sq, sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  float scale;
  bool causal;
  bool dropout;
  uint32_t seed;
  uint32_t threshold;
  float keep_scale;
};

// the number of key tiles of width bn that query rows [q0, q_end) see
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int q_end, int bn) {
  int kmax = p.sk - 1;
  if (p.causal) {
    const int last = q_end - 1 + (p.sk - p.sq);   // last row's last visible key
    if (last < 0) return 0;
    kmax = min(kmax, last);
  }
  return kmax / bn + 1;
}

// the first query tile of height bm whose rows see any of keys [k0, ...)
__device__ __forceinline__ int first_query_tile(const Params& p, int k0, int bm) {
  if (!p.causal) return 0;
  const int row = k0 - (p.sk - p.sq);             // the first row that sees key k0
  return row <= 0 ? 0 : row / bm;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64;        // rows (queries for dq, keys for dk/dv) a block
constexpr int kBN = 64;        // columns a tile (keys for dq, queries for dk/dv)
constexpr int kWarps = 4;      // 16 rows each
constexpr int kPad = 8;        // shared row padding (elements): conflict-free ldmatrix
// blocks an SM the register budget is set for: at d = 64, three (168
// registers, a few bytes spilled) measured faster than two (230-234
// registers) by 12-19%, and four (128 registers) spilled hundreds of bytes
// and ran slower than both; d = 32 keeps the d = 64 budget
constexpr int min_blocks(int d) { return d <= 64 ? 3 : 2; }

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

// this warp's 16 rows of a [64][SD] tile as m16n8k16 A fragments
template <typename T, int D>
__device__ __forceinline__ void a_frags(uint32_t (&f)[D / 16][4], const T* tile, int warp,
                                        int lane) {
  constexpr int SD = D + kPad;
  const int mi = lane >> 3;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(f[kc], tile + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * SD + kc * 16 +
                           (mi >> 1) * 8);
}

// acc[16 x 64] = A[16 x D] B^T, B a [64][SD] tile of 64 rows of D
template <typename T, int D>
__device__ __forceinline__ void mma_abt(float (&acc)[kBN / 8][4], const uint32_t (&a)[D / 16][4],
                                        const T* bt, int lane) {
  constexpr int SD = D + kPad;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  const int mi = lane >> 3;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < kBN / 16; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, bt + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * SD + kc * 16 + (mi & 1) * 8);
      MmaOp<T>::run(acc[2 * np], a[kc], bfr[0], bfr[1]);
      MmaOp<T>::run(acc[2 * np + 1], a[kc], bfr[2], bfr[3]);
    }
  }
}

// out[16 x D] += X[16 x 64] B, X in accumulator layout (rounded to T here),
// B a [64][SD] tile of 64 rows of D
template <typename T, int D>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4], const float (&x)[kBN / 8][4],
                                       const T* bt, int lane) {
  constexpr int SD = D + kPad;
  const int mi = lane >> 3;
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) {
    uint32_t pa[4];
    pa[0] = MmaOp<T>::pack(x[2 * kc][0], x[2 * kc][1]);
    pa[1] = MmaOp<T>::pack(x[2 * kc][2], x[2 * kc][3]);
    pa[2] = MmaOp<T>::pack(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    pa[3] = MmaOp<T>::pack(x[2 * kc + 1][2], x[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, bt + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * SD + dp * 16 +
                                 (mi >> 1) * 8);
      MmaOp<T>::run(out[2 * dp], pa, bfr[0], bfr[1]);
      MmaOp<T>::run(out[2 * dp + 1], pa, bfr[2], bfr[3]);
    }
  }
}

// rows row_a, row_b (= row_a + 8) of an fp32 accumulator [16 x D], times
// `mul`, stored as T at base + row * rs (rows >= n_rows skipped)
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, int64_t rs, int row_a, int n_rows,
                                           const float (&acc)[D / 8][4], float mul, int tig) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + tig * 2;
    if (row_a < n_rows)
      *reinterpret_cast<uint32_t*>(base + (int64_t)row_a * rs + col) =
          MmaOp<T>::pack(acc[i][0] * mul, acc[i][1] * mul);
    if (row_a + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (int64_t)(row_a + 8) * rs + col) =
          MmaOp<T>::pack(acc[i][2] * mul, acc[i][3] * mul);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(D))
flash_dq_mma(const Params p) {
  constexpr int SD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* DOs = Qs + kBM * SD;
  T* Ks = DOs + kBM * SD;                          // [2][kBN][SD]
  T* Vs = Ks + 2 * kBN * SD;                       // [2][kBN][SD]
  int* Kseg = reinterpret_cast<int*>(Vs + 2 * kBN * SD);   // [2][kBN]
  float* Dl = reinterpret_cast<float*>(Kseg + 2 * kBN);    // [kBM]

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
  const T* ob = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh;
  const T* dob = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + khi * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + khi * p.v_sh;
  const bool has_seg = p.qseg != nullptr;
  const int n_tiles = key_tiles(p, q0, q_end, kBN);

  load_tile<T, D>(Qs, qb, p.q_ss, q0, p.sq);
  load_tile<T, D>(DOs, dob, p.do_ss, q0, p.sq);
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

  // delta = rowsum(do * o) for the block's rows: two threads a row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float acc = 0.f;
    if (row < p.sq) {
      const T* orow = ob + (int64_t)row * p.o_ss;
      const T* drow = dob + (int64_t)row * p.do_ss;
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
        acc += to_f32(orow[c]) * to_f32(drow[c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Dl[r] = acc;
      if (row < p.sq) p.delta[(int64_t)bh * p.sq + row] = acc;
    }
  }

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  int seg_a = 0, seg_b = 0;
  if (has_seg) {
    if (row_a < p.sq) seg_a = p.qseg[(int64_t)bi * p.sq + row_a];
    if (row_b < p.sq) seg_b = p.qseg[(int64_t)bi * p.sq + row_b];
  }
  const float* lrow = p.lse + (int64_t)bh * p.sq;
  // lse in log2 units; a row past sq gets +inf, so its p is 0
  const float lse_a = row_a < p.sq ? lrow[row_a] * kLog2e : CUDART_INF_F;
  const float lse_b = row_b < p.sq ? lrow[row_b] * kLog2e : CUDART_INF_F;
  const int causal_off = p.sk - p.sq;
  const float scale_log2 = p.scale * kLog2e;

  uint32_t qf[D / 16][4], dof[D / 16][4];
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[i][c] = 0.f;
  float delta_a = 0.f, delta_b = 0.f;

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
      a_frags<T, D>(qf, Qs, warp, lane);
      a_frags<T, D>(dof, DOs, warp, lane);
      delta_a = Dl[warp * 16 + g];
      delta_b = Dl[warp * 16 + g + 8];
    }
    const T* Kt = Ks + stage * kBN * SD;
    const T* Vt = Vs + stage * kBN * SD;

    float s[kBN / 8][4], dp[kBN / 8][4];
    mma_abt<T, D>(s, qf, Kt, lane);
    mma_abt<T, D>(dp, dof, Vt, lane);

    const int k0 = j * kBN;
    const bool need_mask = has_seg || k0 + kBN > p.sk ||
                           (p.causal && k0 + kBN - 1 > q0 + causal_off);
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool lo = c < 2;
        const int col = k0 + n * 8 + tig * 2 + (c & 1);
        const int row = lo ? row_a : row_b;
        bool ok = true;
        if (need_mask) {
          ok = col < p.sk;
          if (p.causal) ok = ok && col <= row + causal_off;
          if (has_seg) ok = ok && Kseg[stage * kBN + col - k0] == (lo ? seg_a : seg_b);
        }
        const float pr = ok ? fast_exp2(s[n][c] * scale_log2 - (lo ? lse_a : lse_b)) : 0.f;
        float dpv = dp[n][c];
        if (p.dropout)
          dpv = keep_bit(p.seed, (uint32_t)row, (uint32_t)col, (uint32_t)bh, p.threshold)
                    ? dpv * p.keep_scale
                    : 0.f;
        s[n][c] = pr * (dpv - (lo ? delta_a : delta_b));   // ds
      }
    }
    mma_xb<T, D>(dq, s, Kt, lane);
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();  // no copy outlives the block
  T* dqb = static_cast<T*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh;
  store_rows<T, D>(dqb, p.dq_ss, row_a, p.sq, dq, p.scale, tig);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(D))
flash_dkv_mma(const Params p) {
  constexpr int SD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBM * SD;
  T* Qs = Vs + kBM * SD;                           // [2][kBN][SD]
  T* DOs = Qs + 2 * kBN * SD;                      // [2][kBN][SD]
  float* Ls = reinterpret_cast<float*>(DOs + 2 * kBN * SD);   // [2][kBN], log2 units
  float* Ds = Ls + 2 * kBN;                                    // [2][kBN]
  int* Qg = reinterpret_cast<int*>(Ds + 2 * kBN);              // [2][kBN]

  // x is the (batch, kv head) and y the key tile, so in x-fastest start
  // order the heaviest tiles of every head start first (causal: the first
  // key tiles are seen by the most query tiles)
  const int bkh = blockIdx.x;
  const int bi = bkh / p.hk, khi = bkh % p.hk;
  const int rep = p.h / p.hk;
  const int k0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + khi * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + khi * p.v_sh;
  const bool has_seg = p.qseg != nullptr;
  const int i_start = first_query_tile(p, k0, kBN);
  const int n_qt = (p.sq + kBN - 1) / kBN;
  const int n_iq = max(0, n_qt - i_start);
  const int total = rep * n_iq;

  load_tile<T, D>(Ks, kb, p.k_ss, k0, p.sk);
  load_tile<T, D>(Vs, vb, p.v_ss, k0, p.sk);
  auto load_q = [&](int it, int stage) {
    const int hq = khi * rep + it / n_iq;
    const int i0 = (i_start + it % n_iq) * kBN;
    const int64_t bhq = (int64_t)bi * p.h + hq;
    load_tile<T, D>(Qs + stage * kBN * SD,
                    static_cast<const T*>(p.q) + bi * p.q_sb + hq * p.q_sh, p.q_ss, i0, p.sq);
    load_tile<T, D>(DOs + stage * kBN * SD,
                    static_cast<const T*>(p.dout) + bi * p.do_sb + hq * p.do_sh, p.do_ss, i0,
                    p.sq);
    if (threadIdx.x < kBN) {
      const int row = i0 + threadIdx.x;
      const bool in = row < p.sq;
      Ls[stage * kBN + threadIdx.x] = in ? p.lse[bhq * p.sq + row] * kLog2e : CUDART_INF_F;
      Ds[stage * kBN + threadIdx.x] = in ? p.delta[bhq * p.sq + row] : 0.f;
      if (has_seg) Qg[stage * kBN + threadIdx.x] = in ? p.qseg[(int64_t)bi * p.sq + row] : 0;
    }
  };
  if (total > 0) load_q(0, 0);
  cp_async_commit();

  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  int seg_a = 0, seg_b = 0;
  if (has_seg) {
    if (key_a < p.sk) seg_a = p.kseg[(int64_t)bi * p.sk + key_a];
    if (key_b < p.sk) seg_b = p.kseg[(int64_t)bi * p.sk + key_b];
  }
  const int causal_off = p.sk - p.sq;
  const float scale_log2 = p.scale * kLog2e;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int stage = it & 1;
    if (it + 1 < total) {
      load_q(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int hq = khi * rep + it / n_iq;
    const int q0 = (i_start + it % n_iq) * kBN;
    const uint32_t bhq = (uint32_t)(bi * p.h + hq);
    const T* Qt = Qs + stage * kBN * SD;
    const T* DOt = DOs + stage * kBN * SD;
    const float* lse = Ls + stage * kBN;
    const float* dl = Ds + stage * kBN;

    float s[kBN / 8][4], dp[kBN / 8][4];
    {
      uint32_t kf[D / 16][4];
      a_frags<T, D>(kf, Ks, warp, lane);
      mma_abt<T, D>(s, kf, Qt, lane);              // s^T: keys x queries
      a_frags<T, D>(kf, Vs, warp, lane);
      mma_abt<T, D>(dp, kf, DOt, lane);            // dp^T
    }
    const bool need_mask = has_seg || q0 + kBN > p.sq ||
                           (p.causal && k0 + kBM - 1 > q0 + causal_off);
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool lo = c < 2;
        const int qc = n * 8 + tig * 2 + (c & 1);   // query within the tile
        const int row = q0 + qc;
        const int key = lo ? key_a : key_b;
        bool ok = true;
        if (need_mask) {
          ok = row < p.sq;
          if (p.causal) ok = ok && key <= row + causal_off;
          if (has_seg) ok = ok && Qg[stage * kBN + qc] == (lo ? seg_a : seg_b);
        }
        const float pr = ok ? fast_exp2(s[n][c] * scale_log2 - lse[qc]) : 0.f;
        float pk = pr, dpv = dp[n][c];
        if (p.dropout) {
          const bool keep = keep_bit(p.seed, (uint32_t)row, (uint32_t)key, bhq, p.threshold);
          pk = keep ? pr * p.keep_scale : 0.f;
          dpv = keep ? dpv * p.keep_scale : 0.f;
        }
        s[n][c] = pk;                                // p_kept^T
        dp[n][c] = pr * (dpv - dl[qc]);              // ds^T
      }
    }
    mma_xb<T, D>(dv, s, DOt, lane);
    mma_xb<T, D>(dk, dp, Qt, lane);
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();
  T* dkb = static_cast<T*>(p.dk) + bi * p.dk_sb + khi * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + bi * p.dv_sb + khi * p.dv_sh;
  store_rows<T, D>(dkb, p.dk_ss, key_a, p.sk, dk, p.scale, tig);
  store_rows<T, D>(dvb, p.dv_ss, key_a, p.sk, dv, 1.f, tig);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 8;    // one warp per row
constexpr int kF32Cols = 32;   // one column per lane a step

template <int D>
__global__ void __launch_bounds__(kF32Rows * 32)
flash_dq_f32(const Params p) {
  constexpr int E = D / 32;                        // output values a lane
  __shared__ float Kt[kF32Cols][D + 1];            // +1: lane j reads row j
  __shared__ float Vt[kF32Cols][D + 1];
  __shared__ float Qr[kF32Rows][D];
  __shared__ float DOr[kF32Rows][D];
  __shared__ int Kseg[kF32Cols];

  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int khi = hi / (p.h / p.hk);
  const int q0 = blockIdx.x * kF32Rows;
  const int q_end = min(q0 + kF32Rows, p.sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = q0 + warp;
  const bool row_in = row < p.sq;

  const float* qb = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* ob = static_cast<const float*>(p.o) + bi * p.o_sb + hi * p.o_sh;
  const float* dob = static_cast<const float*>(p.dout) + bi * p.do_sb + hi * p.do_sh;
  const float* kb = static_cast<const float*>(p.k) + bi * p.k_sb + khi * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + bi * p.v_sb + khi * p.v_sh;
  const bool has_seg = p.qseg != nullptr;

  float dsum = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float dov = row_in ? dob[(int64_t)row * p.do_ss + c] : 0.f;
    Qr[warp][c] = row_in ? qb[(int64_t)row * p.q_ss + c] : 0.f;
    DOr[warp][c] = dov;
    dsum += row_in ? dov * ob[(int64_t)row * p.o_ss + c] : 0.f;
  }
  const float delta = warp_sum(dsum);
  if (row_in && lane == 0) p.delta[(int64_t)bh * p.sq + row] = delta;
  const float lse = row_in ? p.lse[(int64_t)bh * p.sq + row] : CUDART_INF_F;
  const int seg = (has_seg && row_in) ? p.qseg[(int64_t)bi * p.sq + row] : 0;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  const int n_tiles = key_tiles(p, q0, q_end, kF32Cols);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF32Cols;
    __syncthreads();   // the last tile's reads are done (and Qr, DOr written)
    for (int c = threadIdx.x; c < kF32Cols * D; c += kF32Rows * 32) {
      const int r = c / D, col = c % D;
      const bool in = k0 + r < p.sk;
      Kt[r][col] = in ? kb[(int64_t)(k0 + r) * p.k_ss + col] : 0.f;
      Vt[r][col] = in ? vb[(int64_t)(k0 + r) * p.v_ss + col] : 0.f;
    }
    if (has_seg && threadIdx.x < kF32Cols)
      Kseg[threadIdx.x] =
          k0 + (int)threadIdx.x < p.sk ? p.kseg[(int64_t)bi * p.sk + k0 + threadIdx.x] : 0;
    __syncthreads();

    const int col = k0 + lane;                     // this lane's key
    float sv = 0.f, dpv = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      sv = fmaf(Qr[warp][c], Kt[lane][c], sv);
      dpv = fmaf(DOr[warp][c], Vt[lane][c], dpv);
    }
    bool ok = row_in && col < p.sk;
    if (p.causal) ok = ok && col <= row + (p.sk - p.sq);
    if (has_seg) ok = ok && Kseg[lane] == seg;
    const float pr = ok ? expf(sv * p.scale - lse) : 0.f;
    if (p.dropout)
      dpv = keep_bit(p.seed, (uint32_t)row, (uint32_t)col, (uint32_t)bh, p.threshold)
                ? dpv * p.keep_scale
                : 0.f;
    const float ds = pr * (dpv - delta);
    for (int jj = 0; jj < kF32Cols; ++jj) {
      const float dj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(dj, Kt[jj][lane + 32 * e], acc[e]);
    }
  }
  if (!row_in) return;
  float* dqb = static_cast<float*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh + (int64_t)row * p.dq_ss;
#pragma unroll
  for (int e = 0; e < E; ++e) dqb[lane + 32 * e] = acc[e] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(kF32Rows * 32)
flash_dkv_f32(const Params p) {
  constexpr int E = D / 32;
  __shared__ float Qt[kF32Cols][D + 1];
  __shared__ float DOt[kF32Cols][D + 1];
  __shared__ float Kr[kF32Rows][D];
  __shared__ float Vr[kF32Rows][D];
  __shared__ float Ls[kF32Cols], Ds[kF32Cols];
  __shared__ int Qg[kF32Cols];

  const int bkh = blockIdx.y;
  const int bi = bkh / p.hk, khi = bkh % p.hk;
  const int rep = p.h / p.hk;
  const int k0 = blockIdx.x * kF32Rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = k0 + warp;
  const bool key_in = key < p.sk;
  const bool has_seg = p.qseg != nullptr;

  const float* kb = static_cast<const float*>(p.k) + bi * p.k_sb + khi * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + bi * p.v_sb + khi * p.v_sh;
  for (int c = lane; c < D; c += 32) {
    Kr[warp][c] = key_in ? kb[(int64_t)key * p.k_ss + c] : 0.f;
    Vr[warp][c] = key_in ? vb[(int64_t)key * p.v_ss + c] : 0.f;
  }
  const int seg = (has_seg && key_in) ? p.kseg[(int64_t)bi * p.sk + key] : 0;

  float dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dk[e] = dv[e] = 0.f;
  const int i_start = first_query_tile(p, k0, kF32Cols);
  const int n_qt = (p.sq + kF32Cols - 1) / kF32Cols;
  for (int g = 0; g < rep; ++g) {
    const int hq = khi * rep + g;
    const int64_t bhq = (int64_t)bi * p.h + hq;
    const float* qb = static_cast<const float*>(p.q) + bi * p.q_sb + hq * p.q_sh;
    const float* dob = static_cast<const float*>(p.dout) + bi * p.do_sb + hq * p.do_sh;
    for (int i = i_start; i < n_qt; ++i) {
      const int q0 = i * kF32Cols;
      __syncthreads();   // the last tile's reads are done (and Kr, Vr written)
      for (int c = threadIdx.x; c < kF32Cols * D; c += kF32Rows * 32) {
        const int r = c / D, col = c % D;
        const bool in = q0 + r < p.sq;
        Qt[r][col] = in ? qb[(int64_t)(q0 + r) * p.q_ss + col] : 0.f;
        DOt[r][col] = in ? dob[(int64_t)(q0 + r) * p.do_ss + col] : 0.f;
      }
      if (threadIdx.x < kF32Cols) {
        const int row = q0 + threadIdx.x;
        const bool in = row < p.sq;
        Ls[threadIdx.x] = in ? p.lse[bhq * p.sq + row] : CUDART_INF_F;
        Ds[threadIdx.x] = in ? p.delta[bhq * p.sq + row] : 0.f;
        if (has_seg) Qg[threadIdx.x] = in ? p.qseg[(int64_t)bi * p.sq + row] : 0;
      }
      __syncthreads();

      const int row = q0 + lane;                   // this lane's query
      float sv = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        sv = fmaf(Kr[warp][c], Qt[lane][c], sv);
        dpv = fmaf(Vr[warp][c], DOt[lane][c], dpv);
      }
      bool ok = key_in && row < p.sq;
      if (p.causal) ok = ok && key <= row + (p.sk - p.sq);
      if (has_seg) ok = ok && Qg[lane] == seg;
      const float pr = ok ? expf(sv * p.scale - Ls[lane]) : 0.f;
      float pk = pr;
      if (p.dropout) {
        const bool keep = keep_bit(p.seed, (uint32_t)row, (uint32_t)key, (uint32_t)bhq,
                                   p.threshold);
        pk = keep ? pr * p.keep_scale : 0.f;
        dpv = keep ? dpv * p.keep_scale : 0.f;
      }
      const float ds = pr * (dpv - Ds[lane]);
      for (int jj = 0; jj < kF32Cols; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pk, jj);
        const float dj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dv[e] = fmaf(pj, DOt[jj][lane + 32 * e], dv[e]);
          dk[e] = fmaf(dj, Qt[jj][lane + 32 * e], dk[e]);
        }
      }
    }
  }
  if (!key_in) return;
  float* dkb = static_cast<float*>(p.dk) + bi * p.dk_sb + khi * p.dk_sh + (int64_t)key * p.dk_ss;
  float* dvb = static_cast<float*>(p.dv) + bi * p.dv_sb + khi * p.dv_sh + (int64_t)key * p.dv_ss;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dkb[lane + 32 * e] = dk[e] * p.scale;
    dvb[lane + 32 * e] = dv[e];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq_mma(const Params& p, cudaStream_t stream) {
  constexpr int SD = D + kPad;
  const size_t smem = (size_t)(2 * kBM + 4 * kBN) * SD * sizeof(T) + 2 * kBN * sizeof(int) +
                      kBM * sizeof(float);
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.sq + kBM - 1) / kBM);
  flash_dq_mma<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const Params& p, cudaStream_t stream) {
  constexpr int SD = D + kPad;
  const size_t smem = (size_t)(2 * kBM + 4 * kBN) * SD * sizeof(T) + 6 * kBN * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.hk, (p.sk + kBM - 1) / kBM);
  flash_dkv_mma<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(int dtype, const Params& p, cudaStream_t stream) {
  switch (dtype) {
    case kF32: {
      const dim3 grid((p.sq + kF32Rows - 1) / kF32Rows, p.b * p.h);
      flash_dq_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
      return cudaGetLastError();
    }
    case kBF16: return launch_dq_mma<__nv_bfloat16, D>(p, stream);
    case kF16: return launch_dq_mma<__half, D>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_dkv(int dtype, const Params& p, cudaStream_t stream) {
  switch (dtype) {
    case kF32: {
      const dim3 grid((p.sk + kF32Rows - 1) / kF32Rows, p.b * p.hk);
      flash_dkv_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
      return cudaGetLastError();
    }
    case kBF16: return launch_dkv_mma<__nv_bfloat16, D>(p, stream);
    case kF16: return launch_dkv_mma<__half, D>(p, stream);
  }
  return cudaErrorInvalidValue;
}

bool make_params(Params& p, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, const void* qseg,
                 const void* kseg, void* dq, void* dk, void* dv, int b, int h, int hk, int sq,
                 int sk, const long long* st, float scale, int causal, int dropout,
                 unsigned seed, unsigned threshold, float keep_scale) {
  if (b < 1 || h < 1 || hk < 1 || h % hk || sq < 1 || sk < 1) return false;
  // grid.y: (batch, head) of the fp32 kernels, tiles of the mma kernels
  if (b * h > 65535 || (sq + kBM - 1) / kBM > 65535 || (sk + kBM - 1) / kBM > 65535)
    return false;
  if ((qseg == nullptr) != (kseg == nullptr)) return false;
  p = Params{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
             static_cast<const int*>(qseg), static_cast<const int*>(kseg), dq, dk, dv,
             b, h, hk, sq, sk,
             st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
             st[11], st[12], st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20],
             st[21], st[22], st[23],
             scale, causal != 0, dropout != 0, seed, threshold, keep_scale};
  return true;
}

}  // namespace

// One argument list for both entry points.  q [b, h, sq, d], k and v
// [b, hk, sk, d], o and do like q, dq like q, dk and dv like k: element
// strides (batch, head, row) in `strides` in the order q, k, v, o, do, dq,
// dk, dv (24 values), unit last stride; 16-bit operands start on 16 bytes
// with strides that are multiples of 8.  lse and delta [b, h, sq] fp32
// contiguous; qseg [b, sq] and kseg [b, sk] int32 or both null.  dtype: 0
// fp32, 1 bf16, 2 fp16; d: 32, 64 or 128.
//
// apex_flash_attention_dq writes dq and delta; apex_flash_attention_dkv
// reads delta as dq wrote it and writes dk and dv.  Each launches on
// `stream` and returns cudaGetLastError().
#define FLASH_BWD_ARGS                                                                    \
  const void *q, const void *k, const void *v, const void *o, const void *dout,           \
      const void *lse, void *delta, const void *qseg, const void *kseg, void *dq, void *dk, \
      void *dv, int b, int h, int hk, int sq, int sk, int d, const long long *strides,      \
      float scale, int causal, int dropout, unsigned seed, unsigned threshold,              \
      float keep_scale, int dtype, void *stream

extern "C" int apex_flash_attention_dq(FLASH_BWD_ARGS) {
  Params p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, qseg, kseg, dq, dk, dv, b, h, hk, sq, sk,
                   strides, scale, causal, dropout, seed, threshold, keep_scale))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dq<32>(dtype, p, s);
    case 64: return (int)launch_dq<64>(dtype, p, s);
    case 128: return (int)launch_dq<128>(dtype, p, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int apex_flash_attention_dkv(FLASH_BWD_ARGS) {
  Params p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, qseg, kseg, dq, dk, dv, b, h, hk, sq, sk,
                   strides, scale, causal, dropout, seed, threshold, keep_scale))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dkv<32>(dtype, p, s);
    case 64: return (int)launch_dkv<64>(dtype, p, s);
    case 128: return (int)launch_dkv<128>(dtype, p, s);
  }
  return cudaErrorInvalidValue;
}
