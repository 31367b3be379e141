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
// Bound.  At the main path's shape (R 128, h 8, s 1024, d 32, bf16, 10% of
// the keys masked) the two products are 124 GFLOP over the valid keys
// (0.125 ms at 989 TFLOP/s) and the softmax takes 0.97e9 exponentials,
// 0.231 ms at the SFU rate (16 a clock an SM, 132 SMs, 1.98 GHz); q, k, v,
// o and the bias are 285 MB (0.085 ms at 3.35 TB/s).  The exponentials
// bind: at d = 32 each score takes 64 multiply-adds on the tensor cores but
// one exp2 on the far slower special-function units, and some ten more
// scalar instructions (the bias's load, convert and add, the max, the sum,
// the pack) beside it.
//
// Design: the flash forward's (flash_attention_fwd.cu) on flash_sm90.cuh,
// with the bias as a third streamed operand.
// - A block of two consumer warpgroups (256 threads) owns 128 queries of
//   one (R row, head), 64 a warpgroup, so each k and v tile serves 128
//   queries; its first warp also issues the loads.  q arrives once by TMA;
//   k and v stream in 64-key tiles through a FlashRing of kStages stages on
//   full/empty mbarriers, each through a rank-4 map of its own strides
//   (OpenFold's q, k, v are strided views of [R, s, h, d]).  d is zero-
//   filled to D = 32, 64 or 128 by TMA (box columns past d read zeros).
// - The bias tile [128 queries x 64 keys] of each key tile rides in the same
//   stage, by TMA through a rank-4 map of [b, h, s, s] with the 128-byte
//   swizzle (64-row boxes of 128-byte rows: one 16-bit box or two fp32 boxes
//   a 64-row half), so each lane reads its pairs of it without bank
//   conflicts.  Where a bias row is not whole 16-byte chunks (s * element
//   size % 16 != 0: no map can read it) each lane instead loads its 32 values
//   from device memory before it waits on the stage, so the loads overlap
//   the wait.  The kv mask's 64 bytes of each key tile ride in the stage
//   too, by TMA through a rank-2 map of the mask bytes [R, s] (rows padded
//   to 16 bytes on the host where they are not; keys past s read as 0 =
//   masked); each lane turns its bytes into the additive term, 0 or -inf.
//   So shared memory does not grow with s, the loading warp does no work
//   a tile but issue its copies, and the key loop holds no __syncthreads().
// - s = q k^T by SS m64n64k16 (both K-major); each score becomes, in log2
//   units, fma(s, scale log2e, fma(bias, log2e, mask term)); the online
//   softmax runs in fp32 registers with the hardware exp2; p goes from the
//   first product's accumulators into the A registers of o += p v (RS
//   m64nDk16, v read MN-major through the transpose bit).  Neither s nor p
//   reaches shared or device memory.  Tile j - 1's p v is issued behind
//   tile j's s and runs while tile j's softmax does (the first tile peeled
//   off the loop, so no wgmma sits on a branch: ptxas serializes them
//   otherwise, its C7518 note).
// - A row with no valid key: its running max stays -inf, its correction 1
//   and its exponent base 0, so o stays 0 and l 0, and the epilogue writes o
//   = 0, lse = +inf.  TMA's zero-filled keys past s score 0, and their mask
//   term -inf takes them out.
// - Block order: the query tile fastest, then the head, then the R row, so
//   the blocks in flight at once read every query tile of a few R rows
//   (their k and v, 64 KB each an (R row, head), come from device memory
//   once) and between them the whole 16 MB bias plane, which stays in L2.
//
// What bit, and what the design does about it (NVIDIA H100 80GB HBM3 at
// 700 W, the main shape; apex_tpu_torch/tools/pair_bias_fwd_variants.py
// builds the ring and occupancy variants and the diagnostics beside this
// source, PERF.md keeps their times):
// - Latency, not one unit: taking out the exponentials, p v or the bias
//   reads each saves only a few per cent: each tile's chain (s, its wait,
//   the bias and softmax, p v, its wait) is what four warpgroups an SM
//   cannot cover.  Running p v beside the next softmax takes some of it
//   off.  Anything more on the loading warp's path a tile lengthens its
//   warpgroup's chain: the mask terms stored each tile from that warp's
//   own loads ran clearly slower, and even an integer division there
//   showed in the time (so the bias's batch index is worked out once).
// - The mask: its terms for all s keys staged once a block made shared
//   memory grow with s (d 128 with an fp32 bias stopped fitting past s ~
//   450); the 64-byte box a tile, and each lane's conversion of its bytes,
//   cost a few per cent against that.
// - L2 traffic: a block of two R rows that share one bias tile (four
//   warpgroups, one block an SM) moves 2 bytes through L2 a score against
//   3, and ran slower: one block an SM costs more than the traffic saves.
// - Two blocks an SM at d <= 32 (at most 128 registers a thread, all used,
//   no spills); a ring of 3 stages (2 slower, 4 no faster and too large for
//   d 128 with an fp32 bias).
// fp32 inputs take a CUDA-core kernel in full fp32: one warp a query row.
//
// C interface (loaded with ctypes): apex_pair_bias_attention_fwd takes the
// argument list of pair_bias.cuh and, for bf16 and fp16, the geometry of
// the q, k, v, bias and mask maps (ops/pair_bias_attention.py's _tma_maps); it
// returns cudaGetLastError() after the launch, 0 on success, and
// cudaErrorInvalidValue for a shape it does not take or a map that is not
// the kernel's or that cuTensorMapEncodeTiled refuses.

#include "pair_bias.cuh"

namespace {

constexpr int kStages = 3;         // streamed tiles in flight

constexpr int kFwdThreads = 256;   // two consumer warpgroups

// A block: one R row by two 64-query halves, one consumer warpgroup each,
// warp 0 also issuing the loads.  Shared memory, from a 1024-byte boundary
// (the swizzle's period): the q tiles [64, D] of the two warpgroups, the
// ring of kStages stages (the k tile, the v tile, then the bias boxes), the
// stages' mask boxes (kKeys bytes each, 128 apart), the barriers.
template <int D>
struct FwdSmem {
  static constexpr int kQTile = FlashTile<D>::bytes(kWgRows);
  static constexpr int kTile = FlashTile<D>::bytes(kKeys);
  int bias_boxes;   // a stage's: 0 where the bias is not staged
  __host__ __device__ constexpr int stage() const { return 2 * kTile + bias_boxes * kBiasBox; }
  __host__ __device__ constexpr int ring() const { return 2 * kQTile; }
  __host__ __device__ constexpr int k(int st) const { return ring() + st * stage(); }
  __host__ __device__ constexpr int v(int st) const { return k(st) + kTile; }
  __host__ __device__ constexpr int bias(int st) const { return k(st) + 2 * kTile; }
  __host__ __device__ constexpr int mask(int st) const {
    return ring() + kStages * stage() + st * kMaskBox;
  }
  __host__ __device__ constexpr int bars() const { return mask(kStages); }
  __host__ __device__ constexpr int bytes() const {
    return 1024 + bars() + FlashRing<kStages>::kBytes;
  }
};
// the most it takes, whatever s: d 128 with an fp32 bias (four boxes a stage)
static_assert(FwdSmem<128>{4}.bytes() <= kSmemMax, "the ring does not fit");

// two blocks an SM at d <= 32 (at most 128 registers a thread), one above
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads, D <= 32 ? 2 : 1)
pair_bias_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_m, const Params p,
                    const FwdSmem<D> L) {
  extern __shared__ unsigned char pb_smem[];
  const uint32_t base = (smem_u32(pb_smem) + 1023) & ~1023u;
  unsigned char* const gbase = pb_smem + (base - smem_u32(pb_smem));
  const FlashRing<kStages> ring{base + L.bars()};
  init_ring(ring);

  // x the query tile, y the head, z the R row
  const int head = blockIdx.y, Rc = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQueries;
  const int n_tiles = (p.s + kKeys - 1) / kKeys;

  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // this warpgroup
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0c = q0 + c * kWgRows;                        // its first query
  const int bias_batch = Rc % p.nb;
  const bool f32_bias = p.bias_dtype == kF32;
  const int col_boxes = f32_bias ? 2 : 1;
  const uint32_t q_s = base + c * FwdSmem<D>::kQTile;

  // Warp 0 of warpgroup 0 also keeps the ring full: q on `once`, the first
  // kStages tiles, then at the end of each tile j it refills the stage of
  // tile j - 1 once both warpgroups have handed it back.
  const bool producer = threadIdx.x < 32;
  auto produce = [&](int j, int st) {
    if (lane == 0) {
      mbar_expect_tx(ring.full(st), L.stage() + kKeys);
      tma_load_tile<D>(base + L.k(st), &map_k, j * kKeys, head, Rc, kKeys, ring.full(st));
      tma_load_tile<D>(base + L.v(st), &map_v, j * kKeys, head, Rc, kKeys, ring.full(st));
      tma_load_4d(base + L.mask(st), &map_m, j * kKeys, Rc, 0, 0, ring.full(st));
      if (L.bias_boxes)
        for (int hf = 0; hf < 2; ++hf)
          for (int cb = 0; cb < col_boxes; ++cb)
            tma_load_4d(base + L.bias(st) + (hf * col_boxes + cb) * kBiasBox, &map_b,
                        j * kKeys + cb * 32, q0 + hf * kWgRows, head, bias_batch,
                        ring.full(st));
    } else {
      mbar_arrive(ring.full(st));
    }
  };
  if (producer) {
    if (lane == 0) {
      mbar_expect_tx(ring.once(), L.ring());
      for (int wg = 0; wg < 2; ++wg)
        tma_load_tile<D>(base + wg * FwdSmem<D>::kQTile, &map_q, q0 + wg * kWgRows, head, Rc,
                         kWgRows, ring.once());
    }
    for (int j = 0; j < min(kStages, n_tiles); ++j) produce(j, j);
  }
  const bool live = q0c < p.s;                             // rows of its own to compute

  // this thread's two rows of the accumulators: element i lies at row
  // row_a (i & 2 clear) or row_b, column 8 (i / 4) + 2 tig + (i & 1)
  const int row_a = q0c + warp * 16 + g, row_b = row_a + 8;
  const float scale_log2 = p.scale * kLog2e;
  const unsigned char* bb = bias_base(p, Rc, head);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F;   // running max, log2 units
  float l_a = 0.f, l_b = 0.f;                       // this lane's partial sums
  mbar_wait(ring.once(), 0);
  int s = 0, prev = 0;                              // the stages of tiles j and j - 1
  uint32_t phase = 0;
  auto advance = [&] {
    prev = s;
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  };
  if (!live) {
    // (a warpgroup with no rows of its own to compute skips every tile)
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(ring.full(s), phase);
      if (t == 0) mbar_arrive(ring.empty(s));
      advance();
    }
    return;
  }

  // Tile j: s = q k^T; then tile j - 1's o += p v (p its A operand, rounded
  // to T in registers; v that stage's tile read MN-major) runs behind it
  // while tile j's softmax does, and completes before o takes tile j's
  // correction; that hands tile j - 1's stage back.  Tile 0 has no p v
  // before it and the last one's comes after the loop.
  uint32_t a[4][4];
  auto issue_s = [&](float (&sc)[32]) {
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64<T>(sc, desc_kmajor<D>(q_s, kWgRows, 0, kk),
                         desc_kmajor<D>(base + L.k(s), kKeys, 0, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&] {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<T, D>(o, a[kc], desc_mnmajor<D>(base + L.v(prev), kKeys, kc));
    wgmma_commit();
  };
  // the bias words of tile j: an unstaged bias's before the stage's wait,
  // a staged one's from the stage while s runs
  auto bias_global = [&](uint32_t (&bw)[32], int j) {
    if (!p.staged) bias_words_global(bw, p, bb, row_a, j * kKeys, tig);
  };
  auto bias_smem = [&](uint32_t (&bw)[32]) {
    if (p.staged)
      bias_words_smem(bw, gbase + L.bias(s) + c * col_boxes * kBiasBox, f32_bias, warp, g, tig);
  };
  // the online softmax of tile j's scores: p in sc, this tile's
  // corrections of the running sums returned
  auto softmax = [&](float (&sc)[32], const uint32_t (&bw)[32], float& corr_a, float& corr_b) {
    const unsigned char* mb = gbase + L.mask(s);
    // the score in log2 units: one fma of the bias and mask term, one of
    // the product; each dtype's loop free of branches
    auto add_terms = [&](int i, float b0, float b1) {
      const uint32_t m2 = *reinterpret_cast<const uint16_t*>(mb + (i >> 2) * 8 + 2 * tig);
      const float t0 = m2 & 0xffu ? 0.f : -CUDART_INF_F;
      const float t1 = m2 & 0xff00u ? 0.f : -CUDART_INF_F;
      sc[i] = fmaf(sc[i], scale_log2, fmaf(b0, kLog2e, t0));
      sc[i + 1] = fmaf(sc[i + 1], scale_log2, fmaf(b1, kLog2e, t1));
    };
    if (f32_bias) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) add_terms(i, __uint_as_float(bw[i]), __uint_as_float(bw[i + 1]));
    } else {
      const bool bf = p.bias_dtype == kBF16;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 b = pair_f32(bw[i], bf);
        add_terms(i, b.x, b.y);
      }
    }
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i & 2) == 0) mx_a = fmaxf(mx_a, sc[i]); else mx_b = fmaxf(mx_b, sc[i]);
    }
    // the four lanes of a quad hold a row's 64 keys between them
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no valid key yet keeps everything at zero
    corr_a = mn_a == -CUDART_INF_F ? 1.f : fast_exp2(m_a - mn_a);
    corr_b = mn_b == -CUDART_INF_F ? 1.f : fast_exp2(m_b - mn_b);
    const float base_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
    const float base_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool lo = (i & 2) == 0;
      sc[i] = fast_exp2(sc[i] - (lo ? base_a : base_b));   // -inf -> 0
      if (lo) sum_a += sc[i]; else sum_b += sc[i];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
  };
  // o, its last product completed, takes this tile's correction; p becomes
  // the A operand of this tile's p v
  auto rescale_and_pack = [&](const float (&sc)[32], float corr_a, float corr_b) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a<T>(a[kc], sc, kc);
  };
  {
    uint32_t bw[32];
    float sc[32], corr_a, corr_b;
    bias_global(bw, 0);
    mbar_wait(ring.full(s), phase);
    issue_s(sc);
    bias_smem(bw);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, bw, corr_a, corr_b);
    rescale_and_pack(sc, corr_a, corr_b);
    advance();
  }
  for (int j = 1; j < n_tiles; ++j) {
    uint32_t bw[32];
    float sc[32], corr_a, corr_b;
    bias_global(bw, j);
    mbar_wait(ring.full(s), phase);
    issue_s(sc);
    issue_pv();                                     // tile j - 1's
    bias_smem(bw);
    wgmma_wait<1>();                                // s, not yet p v
    fence_regs(sc);
    softmax(sc, bw, corr_a, corr_b);
    wgmma_wait<0>();
    fence_regs(o);
    if (t == 0) mbar_arrive(ring.empty(prev));
    rescale_and_pack(sc, corr_a, corr_b);
    if (producer && j - 1 + kStages < n_tiles) {
      // the stage of tile j - 1, handed back by both warpgroups by now, and
      // the parity of its fill
      mbar_wait(ring.empty(prev), s == 0 ? phase ^ 1 : phase);
      produce(j - 1 + kStages, prev);
    }
    advance();
  }
  fence_regs(o);
  wgmma_fence();
  issue_pv();                                       // the last tile's
  wgmma_wait<0>();
  fence_regs(o);
  if (t == 0) mbar_arrive(ring.empty(prev));

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  T* ob = static_cast<T*>(p.o) + Rc * p.st[kO][0] + head * p.st[kO][1];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n * 8 >= p.d) break;
    const int col = n * 8 + tig * 2;
    if (row_a < p.s)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * p.st[kO][2] + col) =
          pack2<T>(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    if (row_b < p.s)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * p.st[kO][2] + col) =
          pack2<T>(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
  if (tig == 0) {
    // lse in natural-log units: (m + log2 l) * ln 2
    float* lb = p.lse + ((int64_t)Rc * p.h + head) * p.s;
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
cudaError_t launch_wgmma(Params p, int dtype, const long long* maps, cudaStream_t stream) {
  // maps (pair_bias.cuh's encode_maps): q, k, v, the bias, the mask bytes
  CUtensorMap m[5];
  if (!encode_maps<D>(m, 5, p, dtype, maps)) return cudaErrorInvalidValue;
  const FwdSmem<D> L{p.staged ? 2 * (p.bias_dtype == kF32 ? 2 : 1) : 0};
  const auto kernel = pair_bias_fwd_wgmma<T, D>;
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes());
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + kBlockQueries - 1) / kBlockQueries, p.h, p.R);
  kernel<<<grid, kFwdThreads, L.bytes(), stream>>>(m[0], m[1], m[2], m[3], m[4], p, L);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.s + kF32Rows - 1) / kF32Rows, p.R * p.h);
  pair_bias_fwd_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_d(const Params& p, int dtype, const long long* maps,
                           cudaStream_t stream) {
  if (p.d <= 32) return launch_wgmma<T, 32>(p, dtype, maps, stream);
  if (p.d <= 64) return launch_wgmma<T, 64>(p, dtype, maps, stream);
  return launch_wgmma<T, 128>(p, dtype, maps, stream);
}

}  // namespace

// The argument list of pair_bias.cuh, then `maps` for bf16 and fp16 (fp32
// ignores it): the geometry of five tensor maps, 12 values each
// (encode_map): q, k, v [R, h, s, d] in boxes of 64 rows by the padded head
// dim's box columns, the bias [b, h, s, s] in boxes of 64 rows by 128 bytes
// (read only where its rows are whole 16-byte chunks), and the kv mask's
// bytes [R, s] in boxes of 64 (`mask` then points at them, rows 16-byte
// aligned: the host makes them where there is no mask or its rows are not).
extern "C" int apex_pair_bias_attention_fwd(PAIR_BIAS_ARGS, const long long* maps) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (p.d <= 32) return (int)launch_f32<32>(p, st);
      if (p.d <= 64) return (int)launch_f32<64>(p, st);
      return (int)launch_f32<128>(p, st);
    case kBF16: return (int)launch_wgmma_d<__nv_bfloat16>(p, dtype, maps, st);
    case kF16: return (int)launch_wgmma_d<__half>(p, dtype, maps, st);
  }
  return cudaErrorInvalidValue;
}
