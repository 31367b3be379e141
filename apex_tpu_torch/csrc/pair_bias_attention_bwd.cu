// Pair-bias flash attention backward for Hopper (sm_90a): dq, dk with dv,
// and d(bias).
//
// Replaces: apex_tpu/ops/pair_bias_attention.py::_dq_kernel, ::_dkv_kernel
// and ::_dbias_kernel, the Pallas TPU kernels launched by _pallas_bwd.  Same
// function: for q, k, v [R, h, s, d] (R = r * b rows-major, pair_bias.cuh),
// the bias [b, h, s, s], the kv mask [R, s], the forward's o and lse and
// the upstream do,
//   delta = rowsum(do * o)                              (fp32)
//   p     = exp(q k^T * scale + bias - lse), 0 at a masked key (lse = +inf
//           on a row with no valid key, so its p is 0)
//   ds    = p * (do v^T - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p^T do
//   dbias[bi, head] = sum over the r MSA rows t of ds[t * b + bi, head]
// As in the Pallas kernels, ds and p are rounded to the input dtype before
// the products dq, dk and dv; the products accumulate in fp32, and dbias
// sums its r terms in fp32 and is rounded once, to the bias's dtype.
//
// Bound.  At the main path's shape (R 128, h 8, s 1024, d 32, bf16) each
// kernel recomputes p, R h s^2 = 1.07e9 exponentials, 0.257 ms at the SFU
// rate (16 a clock an SM, 132 SMs, 1.98 GHz).  Their products: dq three
// (s, dp, ds k: 206 GFLOP, 0.208 ms at 989 TFLOP/s), dk/dv four (275
// GFLOP, 0.278 ms), dbias two (137 GFLOP, 0.139 ms); their bytes 0.07-0.1
// ms.  So the exponentials bind dq and dbias, and the products dk/dv.
//
// Design.  dq and dk/dv are the flash backward's kernels
// (flash_attention_bwd.cu) with the bias term of pair_bias.cuh added to
// each recomputed score tile (the bias tile staged in shared memory with
// the other operands, double-buffered, where its rows are whole 16-byte
// chunks; else read by each lane from global memory): dq, a block of 4
// warps owning 64 query rows of one (R row, head), loops over 64-key tiles
// (K and V double-buffered with cp.async), keeps q, do and dq in
// registers, and first writes delta for the other two kernels; dk/dv, a
// block owning 64 keys, loops over the query tiles, with q, do, lse and
// delta double-buffered, and reads its bias tile transposed; both use
// mma.sync m16n8k16 and feed ds and p from the accumulators straight into
// the next product's operands.
// dbias is the reduction the TPU ran with the MSA-row axis innermost in
// its grid and the sum in VMEM scratch.  Blocks run in no order here, so
// the axis becomes a loop inside one block: a block owns one [64 x 64]
// tile of one (batch element, head) bias plane, reads its bias once, then
// for each of the r rows (q, do, k, v, lse, delta and mask double-buffered)
// recomputes s and dp on the tensor cores and adds ds to fp32 registers;
// it writes its tile once.  No atomics: the sum runs in a fixed order, so
// dbias is the same bits on every call.  d is zero-padded in shared memory
// to the next of 16/32/64/128.  fp32 inputs take CUDA-core kernels in full
// fp32: one warp a row, 32 columns a step.
//
// C interface (loaded with ctypes): apex_pair_bias_attention_dq, _dkv and
// _dbias take the argument list of pair_bias.cuh and return
// cudaGetLastError() after the launch.  dq runs first: it writes delta.

#include "pair_bias.cuh"

namespace {

// the blocks an SM the registers are held for (dbias at d 128 keeps one:
// its double-buffered tiles take 139 KB of shared memory)
constexpr int bwd_blocks(int d) { return d <= 32 ? 3 : 2; }
constexpr int dbias_blocks(int d) { return d <= 32 ? 3 : (d <= 64 ? 2 : 1); }

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, bwd_blocks(D))
pair_bias_dq_mma(const Params p) {
  constexpr int SD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* DOs = Qs + kBM * SD;
  T* Ks = DOs + kBM * SD;                          // [2][kBN][SD]
  T* Vs = Ks + 2 * kBN * SD;                       // [2][kBN][SD]
  float* Dl = reinterpret_cast<float*>(Vs + 2 * kBN * SD);   // [kBM]
  // staged bias tiles [2][kBM][kBiasStride] and mask terms [2][kBN]
  unsigned char* Bs = reinterpret_cast<unsigned char*>(Dl + kBM);
  const int btb = bias_tile_bytes(p.bias_dtype == kF32 ? 4 : 2);
  float* Madd = reinterpret_cast<float*>(Bs + (p.staged ? 2 * btb : 0));

  const int g = blockIdx.x;
  const int R_idx = g / p.h, head = g % p.h;
  const int q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;

  const T* qb = static_cast<const T*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1];
  const T* ob = static_cast<const T*>(p.o) + R_idx * p.st[kO][0] + head * p.st[kO][1];
  const T* dob = static_cast<const T*>(p.dout) + R_idx * p.st[kDO][0] + head * p.st[kDO][1];
  const T* kb = static_cast<const T*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1];
  const T* vb = static_cast<const T*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1];
  const unsigned char* bb = bias_base(p, R_idx, head);
  const uint8_t* mrow = p.mask ? p.mask + (int64_t)R_idx * p.s : nullptr;
  const int n_tiles = (p.s + kBN - 1) / kBN;

  load_tile<T, D>(Qs, qb, p.st[kQ][2], q0, p.s, p.d);
  load_tile<T, D>(DOs, dob, p.st[kDO][2], q0, p.s, p.d);
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

  // delta = rowsum(do * o) for the block's rows: two threads a row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float a = 0.f;
    if (row < p.s) {
      const T* orow = ob + (int64_t)row * p.st[kO][2];
      const T* drow = dob + (int64_t)row * p.st[kDO][2];
      for (int c = half; c < p.d; c += 2) a += to_f32(orow[c]) * to_f32(drow[c]);
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if (half == 0) {
      Dl[r] = a;
      if (row < p.s) p.delta[(int64_t)g * p.s + row] = a;
    }
  }

  const int row_a = q0 + warp * 16 + gr, row_b = row_a + 8;
  const float* lrow = p.lse + (int64_t)g * p.s;
  // lse in log2 units; a row past s gets +inf, so its p is 0
  const float lse_a = row_a < p.s ? lrow[row_a] * kLog2e : CUDART_INF_F;
  const float lse_b = row_b < p.s ? lrow[row_b] * kLog2e : CUDART_INF_F;
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
    float add[kBN / 8][4];
    if (!p.staged) bias_tile(add, p, bb, mrow, row_a, j * kBN, tig);
    if (j + 1 < n_tiles) {
      load_kv(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (p.staged) bias_tile_smem(add, p, Bs + stage * btb, Madd + stage * kBN, warp, gr, tig);
    if (j == 0) {
      a_frags<T, D>(qf, Qs, warp, lane);
      a_frags<T, D>(dof, DOs, warp, lane);
      delta_a = Dl[warp * 16 + gr];
      delta_b = Dl[warp * 16 + gr + 8];
    }
    const T* Kt = Ks + stage * kBN * SD;
    const T* Vt = Vs + stage * kBN * SD;

    float sc[kBN / 8][4], dp[kBN / 8][4];
    mma_abt<T, D>(sc, qf, Kt, lane);
    mma_abt<T, D>(dp, dof, Vt, lane);
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool lo = c < 2;
        const float pr = fast_exp2(fmaf(sc[n][c], scale_log2, add[n][c]) - (lo ? lse_a : lse_b));
        sc[n][c] = pr * (dp[n][c] - (lo ? delta_a : delta_b));   // ds
      }
    mma_xb<T, D>(dq, sc, Kt, lane);
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();
  T* dqb = static_cast<T*>(p.dq) + R_idx * p.st[kDQ][0] + head * p.st[kDQ][1];
  store_rows<T, D>(dqb, p.st[kDQ][2], row_a, p.s, p.d, dq, p.scale, tig);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, bwd_blocks(D))
pair_bias_dkv_mma(const Params p) {
  constexpr int SD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBM * SD;
  T* Qs = Vs + kBM * SD;                           // [2][kBN][SD]
  T* DOs = Qs + 2 * kBN * SD;                      // [2][kBN][SD]
  float* Ls = reinterpret_cast<float*>(DOs + 2 * kBN * SD);   // [2][kBN], log2 units
  float* Ds = Ls + 2 * kBN;                                    // [2][kBN]
  // staged bias tiles [2][queries][kBiasStride] over the block's keys
  unsigned char* Bs = reinterpret_cast<unsigned char*>(Ds + 2 * kBN);
  const int btb = bias_tile_bytes(p.bias_dtype == kF32 ? 4 : 2);

  const int g = blockIdx.x;
  const int R_idx = g / p.h, head = g % p.h;
  const int k0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;

  const T* kb = static_cast<const T*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1];
  const T* vb = static_cast<const T*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1];
  const T* qb = static_cast<const T*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1];
  const T* dob = static_cast<const T*>(p.dout) + R_idx * p.st[kDO][0] + head * p.st[kDO][1];
  const unsigned char* bb = bias_base(p, R_idx, head);
  const int n_qt = (p.s + kBN - 1) / kBN;

  load_tile<T, D>(Ks, kb, p.st[kK][2], k0, p.s, p.d);
  load_tile<T, D>(Vs, vb, p.st[kV][2], k0, p.s, p.d);
  auto load_q = [&](int i, int stage) {
    load_tile<T, D>(Qs + stage * kBN * SD, qb, p.st[kQ][2], i * kBN, p.s, p.d);
    load_tile<T, D>(DOs + stage * kBN * SD, dob, p.st[kDO][2], i * kBN, p.s, p.d);
    if (p.staged) stage_bias_tile(Bs + stage * btb, p, bb, i * kBN, k0);
    if (threadIdx.x < kBN) {
      const int row = i * kBN + threadIdx.x;
      const bool in = row < p.s;
      Ls[stage * kBN + threadIdx.x] = in ? p.lse[(int64_t)g * p.s + row] * kLog2e : CUDART_INF_F;
      Ds[stage * kBN + threadIdx.x] = in ? p.delta[(int64_t)g * p.s + row] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();

  // this lane's two keys and whether each is valid (in range, not masked)
  const int key_a = k0 + warp * 16 + gr, key_b = key_a + 8;
  const uint8_t* mrow = p.mask ? p.mask + (int64_t)R_idx * p.s : nullptr;
  const bool kok_a = key_a < p.s && (mrow == nullptr || mrow[key_a] != 0);
  const bool kok_b = key_b < p.s && (mrow == nullptr || mrow[key_b] != 0);
  const float scale_log2 = p.scale * kLog2e;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const int stage = it & 1;
    const int q0 = it * kBN;
    if (it + 1 < n_qt) {
      load_q(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + stage * kBN * SD;
    const T* DOt = DOs + stage * kBN * SD;
    const float* lse = Ls + stage * kBN;
    const float* dl = Ds + stage * kBN;
    const unsigned char* bs = Bs + stage * btb;

    float sc[kBN / 8][4], dp[kBN / 8][4];
    {
      uint32_t kf[D / 16][4];
      a_frags<T, D>(kf, Ks, warp, lane);
      mma_abt<T, D>(sc, kf, Qt, lane);             // s^T: keys x queries
      a_frags<T, D>(kf, Vs, warp, lane);
      mma_abt<T, D>(dp, kf, DOt, lane);            // dp^T
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool lo = c < 2;
        const int qc = n * 8 + tig * 2 + (c & 1);   // query within the tile
        const int query = q0 + qc;
        const bool kok = lo ? kok_a : kok_b;
        // bias[query, key]: the tile read transposed, one value a load
        // (staged: zero past s; else a query past s reads nothing); a
        // query past s has lse +inf, so its p is 0
        const int key = lo ? key_a : key_b;
        const float b =
            p.staged ? load_elem(bs, qc * kBiasStride + key - k0, p.bias_dtype)
            : kok && query < p.s
                ? load_elem(bb, (int64_t)query * p.s + key, p.bias_dtype)
                : 0.f;
        const float sv = kok ? fmaf(sc[n][c], scale_log2, b * kLog2e) : -CUDART_INF_F;
        const float pr = fast_exp2(sv - lse[qc]);
        sc[n][c] = pr;                                // p^T
        dp[n][c] = pr * (dp[n][c] - dl[qc]);          // ds^T
      }
    mma_xb<T, D>(dv, sc, DOt, lane);
    mma_xb<T, D>(dk, dp, Qt, lane);
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();
  T* dkb = static_cast<T*>(p.dk) + R_idx * p.st[kDK][0] + head * p.st[kDK][1];
  T* dvb = static_cast<T*>(p.dv) + R_idx * p.st[kDV][0] + head * p.st[kDV][1];
  store_rows<T, D>(dkb, p.st[kDK][2], key_a, p.s, p.d, dk, p.scale, tig);
  store_rows<T, D>(dvb, p.st[kDV][2], key_a, p.s, p.d, dv, 1.f, tig);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, dbias_blocks(D))
pair_bias_dbias_mma(const Params p) {
  constexpr int SD = D + kPad;
  constexpr int kStage = 4 * kBM * SD;             // q, do, k, v tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);       // [2][kStage]
  float* Ls = reinterpret_cast<float*>(tiles + 2 * kStage);   // [2][kBM], log2 units
  float* Ds = Ls + 2 * kBM;                                    // [2][kBM]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Ds + 2 * kBM);      // [2][kBN]

  const int k0 = blockIdx.x * kBN, q0 = blockIdx.y * kBM;
  const int gb = blockIdx.z;                       // bi * h + head
  const int bi = gb / p.h, head = gb % p.h;
  const int r = p.R / p.nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int row_a = q0 + warp * 16 + gr, row_b = row_a + 8;

  // MSA row t's q, do, k and v tiles, lse and delta of its query rows, and
  // the mask of its keys (key past s: 0)
  auto load_t = [&](int t, int stage) {
    const int R_idx = t * p.nb + bi;
    const int64_t gq = (int64_t)R_idx * p.h + head;
    T* st = tiles + stage * kStage;
    load_tile<T, D>(st, static_cast<const T*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1],
                    p.st[kQ][2], q0, p.s, p.d);
    load_tile<T, D>(st + kBM * SD,
                    static_cast<const T*>(p.dout) + R_idx * p.st[kDO][0] + head * p.st[kDO][1],
                    p.st[kDO][2], q0, p.s, p.d);
    load_tile<T, D>(st + 2 * kBM * SD,
                    static_cast<const T*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1],
                    p.st[kK][2], k0, p.s, p.d);
    load_tile<T, D>(st + 3 * kBM * SD,
                    static_cast<const T*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1],
                    p.st[kV][2], k0, p.s, p.d);
    if (threadIdx.x < kBM) {
      const int row = q0 + threadIdx.x;
      const bool in = row < p.s;
      Ls[stage * kBM + threadIdx.x] = in ? p.lse[gq * p.s + row] * kLog2e : CUDART_INF_F;
      Ds[stage * kBM + threadIdx.x] = in ? p.delta[gq * p.s + row] : 0.f;
    } else if (threadIdx.x < kBM + kBN) {
      const int kk = threadIdx.x - kBM, col = k0 + kk;
      Ms[stage * kBN + kk] =
          col < p.s && (p.mask == nullptr || p.mask[(int64_t)R_idx * p.s + col] != 0);
    }
  };
  load_t(0, 0);
  cp_async_commit();

  // the block's bias tile, read once for all r rows (mask applied per row)
  const unsigned char* bb = static_cast<const unsigned char*>(p.bias) +
                            (int64_t)gb * p.s * p.s * (p.bias_dtype == kF32 ? 4 : 2);
  float badd[kBN / 8][4];
  bias_tile(badd, p, bb, nullptr, row_a, k0, tig);
  const float scale_log2 = p.scale * kLog2e;

  float acc[kBN / 8][4];
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int t = 0; t < r; ++t) {
    const int stage = t & 1;
    if (t + 1 < r) {
      load_t(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = tiles + stage * kStage;
    float sc[kBN / 8][4], dp[kBN / 8][4];
    {
      uint32_t f[D / 16][4];
      a_frags<T, D>(f, st, warp, lane);
      mma_abt<T, D>(sc, f, st + 2 * kBM * SD, lane);     // s = q k^T
      a_frags<T, D>(f, st + kBM * SD, warp, lane);
      mma_abt<T, D>(dp, f, st + 3 * kBM * SD, lane);     // dp = do v^T
    }
    const float* lse = Ls + stage * kBM;
    const float* dl = Ds + stage * kBM;
    const uint8_t* ms = Ms + stage * kBN;
    const float lse_a = lse[warp * 16 + gr], lse_b = lse[warp * 16 + gr + 8];
    const float dl_a = dl[warp * 16 + gr], dl_b = dl[warp * 16 + gr + 8];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool lo = c < 2;
        const float pr = ms[n * 8 + tig * 2 + (c & 1)]
                             ? fast_exp2(fmaf(sc[n][c], scale_log2, badd[n][c]) -
                                         (lo ? lse_a : lse_b))
                             : 0.f;
        acc[n][c] += pr * (dp[n][c] - (lo ? dl_a : dl_b));   // ds, summed over t
      }
    __syncthreads();   // this stage is refilled two rows on
  }
  cp_async_wait<0>();

  unsigned char* db = static_cast<unsigned char*>(p.dbias) +
                      (int64_t)gb * p.s * p.s * (p.bias_dtype == kF32 ? 4 : 2);
  const bool pairs = (p.s & 1) == 0;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    const int col = k0 + n * 8 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + half * 8;
      if (row >= p.s || col >= p.s) continue;
      const int64_t i = (int64_t)row * p.s + col;
      if (pairs) {
        store_pair(db, i, p.bias_dtype, acc[n][half * 2], acc[n][half * 2 + 1]);
      } else {
        store_elem(db, i, p.bias_dtype, acc[n][half * 2]);
        if (col + 1 < p.s) store_elem(db, i + 1, p.bias_dtype, acc[n][half * 2 + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kF32Rows * 32)
pair_bias_dq_f32(const Params p) {
  constexpr int E = D / 32;                        // output values a lane
  __shared__ float Kt[kF32Cols][D + 1];            // +1: lane j reads row j
  __shared__ float Vt[kF32Cols][D + 1];
  __shared__ float Qr[kF32Rows][D];
  __shared__ float DOr[kF32Rows][D];

  const int g = blockIdx.y;
  const int R_idx = g / p.h, head = g % p.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kF32Rows + warp;
  const bool row_in = row < p.s;

  const float* qb = static_cast<const float*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1];
  const float* ob = static_cast<const float*>(p.o) + R_idx * p.st[kO][0] + head * p.st[kO][1];
  const float* dob =
      static_cast<const float*>(p.dout) + R_idx * p.st[kDO][0] + head * p.st[kDO][1];
  const float* kb = static_cast<const float*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1];
  const float* vb = static_cast<const float*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1];
  const unsigned char* bb = bias_base(p, R_idx, head);
  const uint8_t* mrow = p.mask ? p.mask + (int64_t)R_idx * p.s : nullptr;

  float dsum = 0.f;
  for (int c = lane; c < D; c += 32) {
    const bool in = row_in && c < p.d;
    const float dov = in ? dob[(int64_t)row * p.st[kDO][2] + c] : 0.f;
    Qr[warp][c] = in ? qb[(int64_t)row * p.st[kQ][2] + c] : 0.f;
    DOr[warp][c] = dov;
    dsum += in ? dov * ob[(int64_t)row * p.st[kO][2] + c] : 0.f;
  }
  const float delta = warp_sum(dsum);
  if (row_in && lane == 0) p.delta[(int64_t)g * p.s + row] = delta;
  const float lse = row_in ? p.lse[(int64_t)g * p.s + row] : CUDART_INF_F;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  const int n_tiles = (p.s + kF32Cols - 1) / kF32Cols;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF32Cols;
    __syncthreads();   // the last tile's reads are done (and Qr, DOr written)
    for (int c = threadIdx.x; c < kF32Cols * D; c += kF32Rows * 32) {
      const int r = c / D, col = c % D;
      const bool in = k0 + r < p.s && col < p.d;
      Kt[r][col] = in ? kb[(int64_t)(k0 + r) * p.st[kK][2] + col] : 0.f;
      Vt[r][col] = in ? vb[(int64_t)(k0 + r) * p.st[kV][2] + col] : 0.f;
    }
    __syncthreads();

    const int col = k0 + lane;                     // this lane's key
    float sv = 0.f, dpv = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      sv = fmaf(Qr[warp][c], Kt[lane][c], sv);
      dpv = fmaf(DOr[warp][c], Vt[lane][c], dpv);
    }
    const bool ok = row_in && col < p.s && (mrow == nullptr || mrow[col] != 0);
    const float pr =
        ok ? expf(sv * p.scale + load_elem(bb, (int64_t)row * p.s + col, p.bias_dtype) - lse)
           : 0.f;
    const float ds = pr * (dpv - delta);
    for (int jj = 0; jj < kF32Cols; ++jj) {
      const float dj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(dj, Kt[jj][lane + 32 * e], acc[e]);
    }
  }
  if (!row_in) return;
  float* dqb = static_cast<float*>(p.dq) + R_idx * p.st[kDQ][0] + head * p.st[kDQ][1] +
               (int64_t)row * p.st[kDQ][2];
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < p.d) dqb[lane + 32 * e] = acc[e] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(kF32Rows * 32)
pair_bias_dkv_f32(const Params p) {
  constexpr int E = D / 32;
  __shared__ float Qt[kF32Cols][D + 1];
  __shared__ float DOt[kF32Cols][D + 1];
  __shared__ float Kr[kF32Rows][D];
  __shared__ float Vr[kF32Rows][D];
  __shared__ float Ls[kF32Cols], Ds[kF32Cols];

  const int g = blockIdx.y;
  const int R_idx = g / p.h, head = g % p.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = blockIdx.x * kF32Rows + warp;
  const uint8_t* mrow = p.mask ? p.mask + (int64_t)R_idx * p.s : nullptr;
  const bool key_ok = key < p.s && (mrow == nullptr || mrow[key] != 0);

  const float* kb = static_cast<const float*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1];
  const float* vb = static_cast<const float*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1];
  const float* qb = static_cast<const float*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1];
  const float* dob =
      static_cast<const float*>(p.dout) + R_idx * p.st[kDO][0] + head * p.st[kDO][1];
  const unsigned char* bb = bias_base(p, R_idx, head);
  for (int c = lane; c < D; c += 32) {
    const bool in = key < p.s && c < p.d;
    Kr[warp][c] = in ? kb[(int64_t)key * p.st[kK][2] + c] : 0.f;
    Vr[warp][c] = in ? vb[(int64_t)key * p.st[kV][2] + c] : 0.f;
  }

  float dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dk[e] = dv[e] = 0.f;
  const int n_qt = (p.s + kF32Cols - 1) / kF32Cols;
  for (int i = 0; i < n_qt; ++i) {
    const int q0 = i * kF32Cols;
    __syncthreads();   // the last tile's reads are done (and Kr, Vr written)
    for (int c = threadIdx.x; c < kF32Cols * D; c += kF32Rows * 32) {
      const int r = c / D, col = c % D;
      const bool in = q0 + r < p.s && col < p.d;
      Qt[r][col] = in ? qb[(int64_t)(q0 + r) * p.st[kQ][2] + col] : 0.f;
      DOt[r][col] = in ? dob[(int64_t)(q0 + r) * p.st[kDO][2] + col] : 0.f;
    }
    if (threadIdx.x < kF32Cols) {
      const int row = q0 + threadIdx.x;
      const bool in = row < p.s;
      Ls[threadIdx.x] = in ? p.lse[(int64_t)g * p.s + row] : CUDART_INF_F;
      Ds[threadIdx.x] = in ? p.delta[(int64_t)g * p.s + row] : 0.f;
    }
    __syncthreads();

    const int row = q0 + lane;                     // this lane's query
    float sv = 0.f, dpv = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      sv = fmaf(Kr[warp][c], Qt[lane][c], sv);
      dpv = fmaf(Vr[warp][c], DOt[lane][c], dpv);
    }
    const bool ok = key_ok && row < p.s;
    const float pr =
        ok ? expf(sv * p.scale + load_elem(bb, (int64_t)row * p.s + key, p.bias_dtype) - Ls[lane])
           : 0.f;
    const float ds = pr * (dpv - Ds[lane]);
    for (int jj = 0; jj < kF32Cols; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, pr, jj);
      const float dj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dv[e] = fmaf(pj, DOt[jj][lane + 32 * e], dv[e]);
        dk[e] = fmaf(dj, Qt[jj][lane + 32 * e], dk[e]);
      }
    }
  }
  if (key >= p.s) return;
  float* dkb = static_cast<float*>(p.dk) + R_idx * p.st[kDK][0] + head * p.st[kDK][1] +
               (int64_t)key * p.st[kDK][2];
  float* dvb = static_cast<float*>(p.dv) + R_idx * p.st[kDV][0] + head * p.st[kDV][1] +
               (int64_t)key * p.st[kDV][2];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (lane + 32 * e >= p.d) continue;
    dkb[lane + 32 * e] = dk[e] * p.scale;
    dvb[lane + 32 * e] = dv[e];
  }
}

// one warp a query row, one key a lane; the block loops over the r rows
template <int D>
__global__ void __launch_bounds__(kF32Rows * 32)
pair_bias_dbias_f32(const Params p) {
  __shared__ float Kt[kF32Cols][D + 1];
  __shared__ float Vt[kF32Cols][D + 1];
  __shared__ float Qr[kF32Rows][D];
  __shared__ float DOr[kF32Rows][D];

  const int k0 = blockIdx.x * kF32Cols;
  const int gb = blockIdx.z;
  const int bi = gb / p.h, head = gb % p.h;
  const int r = p.R / p.nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.y * kF32Rows + warp, col = k0 + lane;
  const bool in = row < p.s && col < p.s;
  const unsigned char* bb = static_cast<const unsigned char*>(p.bias) +
                            (int64_t)gb * p.s * p.s * (p.bias_dtype == kF32 ? 4 : 2);
  const float b = in ? load_elem(bb, (int64_t)row * p.s + col, p.bias_dtype) : 0.f;

  float acc = 0.f;
  for (int t = 0; t < r; ++t) {
    const int R_idx = t * p.nb + bi;
    const int64_t g = (int64_t)R_idx * p.h + head;
    const float* qb = static_cast<const float*>(p.q) + R_idx * p.st[kQ][0] + head * p.st[kQ][1];
    const float* dob =
        static_cast<const float*>(p.dout) + R_idx * p.st[kDO][0] + head * p.st[kDO][1];
    const float* kb = static_cast<const float*>(p.k) + R_idx * p.st[kK][0] + head * p.st[kK][1];
    const float* vb = static_cast<const float*>(p.v) + R_idx * p.st[kV][0] + head * p.st[kV][1];
    __syncthreads();   // the last row's reads are done
    for (int c = threadIdx.x; c < kF32Cols * D; c += kF32Rows * 32) {
      const int rr = c / D, cc = c % D;
      const bool ok = k0 + rr < p.s && cc < p.d;
      Kt[rr][cc] = ok ? kb[(int64_t)(k0 + rr) * p.st[kK][2] + cc] : 0.f;
      Vt[rr][cc] = ok ? vb[(int64_t)(k0 + rr) * p.st[kV][2] + cc] : 0.f;
    }
    for (int c = lane; c < D; c += 32) {
      const bool ok = row < p.s && c < p.d;
      Qr[warp][c] = ok ? qb[(int64_t)row * p.st[kQ][2] + c] : 0.f;
      DOr[warp][c] = ok ? dob[(int64_t)row * p.st[kDO][2] + c] : 0.f;
    }
    __syncthreads();
    float sv = 0.f, dpv = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      sv = fmaf(Qr[warp][c], Kt[lane][c], sv);
      dpv = fmaf(DOr[warp][c], Vt[lane][c], dpv);
    }
    if (in && (p.mask == nullptr || p.mask[(int64_t)R_idx * p.s + col] != 0)) {
      const float pr = expf(sv * p.scale + b - p.lse[g * p.s + row]);
      acc += pr * (dpv - p.delta[g * p.s + row]);
    }
  }
  if (!in) return;
  unsigned char* db = static_cast<unsigned char*>(p.dbias) +
                      (int64_t)gb * p.s * p.s * (p.bias_dtype == kF32 ? 4 : 2);
  store_elem(db, (int64_t)row * p.s + col, p.bias_dtype, acc);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq_mma(const Params& p, cudaStream_t stream) {
  constexpr int SD = D + kPad;
  const size_t smem = (size_t)(2 * kBM + 4 * kBN) * SD * sizeof(T) + kBM * sizeof(float) +
                      (p.staged ? 2 * bias_tile_bytes(p.bias_dtype == kF32 ? 4 : 2) +
                                      2 * kBN * sizeof(float)
                                : 0);
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      pair_bias_dq_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pair_bias_dq_mma<T, D><<<dim3(p.R * p.h, (p.s + kBM - 1) / kBM), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const Params& p, cudaStream_t stream) {
  constexpr int SD = D + kPad;
  const size_t smem = (size_t)(2 * kBM + 4 * kBN) * SD * sizeof(T) + 4 * kBN * sizeof(float) +
                      (p.staged ? 2 * bias_tile_bytes(p.bias_dtype == kF32 ? 4 : 2) : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_bias_dkv_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pair_bias_dkv_mma<T, D><<<dim3(p.R * p.h, (p.s + kBM - 1) / kBM), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dbias_mma(const Params& p, cudaStream_t stream) {
  constexpr int SD = D + kPad;
  const size_t smem = (size_t)2 * 4 * kBM * SD * sizeof(T) + 4 * kBM * sizeof(float) + 2 * kBN;
  const cudaError_t err = cudaFuncSetAttribute(
      pair_bias_dbias_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.s + kBM - 1) / kBM;
  pair_bias_dbias_mma<T, D><<<dim3(tiles, tiles, p.nb * p.h), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kWhichDq, kWhichDkv, kWhichDbias };

template <typename T, int D>
cudaError_t launch_mma(Which w, const Params& p, cudaStream_t stream) {
  switch (w) {
    case kWhichDq: return launch_dq_mma<T, D>(p, stream);
    case kWhichDkv: return launch_dkv_mma<T, D>(p, stream);
    case kWhichDbias: return launch_dbias_mma<T, D>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_f32(Which w, const Params& p, cudaStream_t stream) {
  const int rows = (p.s + kF32Rows - 1) / kF32Rows;
  switch (w) {
    case kWhichDq: pair_bias_dq_f32<D><<<dim3(rows, p.R * p.h), kF32Rows * 32, 0, stream>>>(p); break;
    case kWhichDkv: pair_bias_dkv_f32<D><<<dim3(rows, p.R * p.h), kF32Rows * 32, 0, stream>>>(p); break;
    case kWhichDbias:
      pair_bias_dbias_f32<D><<<dim3((p.s + kF32Cols - 1) / kF32Cols, rows, p.nb * p.h),
                               kF32Rows * 32, 0, stream>>>(p);
      break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_d(Which w, const Params& p, cudaStream_t stream) {
  if (p.d <= 16) return launch_mma<T, 16>(w, p, stream);
  if (p.d <= 32) return launch_mma<T, 32>(w, p, stream);
  if (p.d <= 64) return launch_mma<T, 64>(w, p, stream);
  return launch_mma<T, 128>(w, p, stream);
}

int run(Which w, int dtype, const Params& p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (p.d <= 32) return (int)launch_f32<32>(w, p, st);
      if (p.d <= 64) return (int)launch_f32<64>(w, p, st);
      return (int)launch_f32<128>(w, p, st);
    case kBF16: return (int)launch_mma_d<__nv_bfloat16>(w, p, st);
    case kF16: return (int)launch_mma_d<__half>(w, p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int apex_pair_bias_attention_dq(PAIR_BIAS_ARGS) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  return run(kWhichDq, dtype, p, stream);
}

extern "C" int apex_pair_bias_attention_dkv(PAIR_BIAS_ARGS) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  return run(kWhichDkv, dtype, p, stream);
}

extern "C" int apex_pair_bias_attention_dbias(PAIR_BIAS_ARGS) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  return run(kWhichDbias, dtype, p, stream);
}
