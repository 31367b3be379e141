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
// Bound: operations.  At the main path's shape (b 4, h 32 over 8 kv heads, s
// 2048, d 64, causal, bf16) the two products are 4 * b * h * d * s (s + 1) / 2
// = 68.7 GFLOP while q, k, v and o are 33.5 + 8.4 + 8.4 + 33.5 MB, so the
// card's tensor-core rate (989 TFLOP/s in bf16) and not its 3.35 TB/s sets
// the least time: 0.069 ms.
//
// Design for that bound: both products on wgmma, the only path to the
// tensor cores' full rate (mma.sync from ldmatrix stops near two thirds of
// it), fed by TMA, with the pieces of the backward (flash_sm90.cuh).  A
// block owns 128 query rows of one (batch, head): two warpgroups of 64
// rows each (256 threads), whose first warp also issues the loads.  q
// arrives once by TMA; k and v stream in 64-key tiles through a ring of
// kStages stages on full/empty mbarriers (the loop takes the place of the
// TPU's sequential k grid axis), and only the key tiles the block's rows
// can see are loaded.  For each tile a warpgroup computes s = q k^T (SS
// m64n64k16, both K-major), runs the online softmax in fp32 registers (the
// row's max over the raw scores and the four lanes of a quad, then
// 2^(s scale log2e - m) as one FFMA and the hardware exp2), rescales its o
// accumulator, turns p into the A fragments of o += p v (RS m64nDk16, v
// read MN-major through the transpose bit: nothing is copied transposed),
// and hands the stage back.  Neither s nor p ever reaches shared or device
// memory.  The epilogue normalises o by 1/l and stores it from registers
// with o's strides; one lane of each row writes lse.  Causal blocks start
// heaviest first, and a warpgroup skips the tiles its own rows do not see.
// At d <= 64 two blocks share an SM.
//
// What bit, and what the design does about it (times: the main shape,
// bf16, NVIDIA H100 80GB HBM3 at 700 W, from apex_tpu_torch/tools/
// flash_fwd_variants.py, which builds the rejected designs beside this one):
// - Layout: the model hands over [s, b, heads, d] viewed as [b, heads, s,
//   d]; q, k and v are rank-4 maps (d, s, heads, b) from their byte strides
//   (ops/flash_attention.py's _tma_geometry, which raises on a stride off 16
//   bytes), d = 128 read as two 64-column boxes, d = 32 with the 64-byte
//   swizzle.
// - Zero-filled keys: TMA fills rows past sk with zeros, whose scores are
//   0, not -inf: the ragged last tile takes the masked branch.
// - Rows with no valid key (segment ids no key shares, causal sq > sk):
//   while a row's running max is -inf its correction is 1 and its exponent
//   base 0, so o stays 0 and l 0, and the epilogue writes o = 0, lse = +inf.
// - Latency, not the products: the backward's block (two consumer
//   warpgroups and a producer warp, 288 threads, one block an SM) runs
//   0.29 ms, the tensor cores busy about a quarter of the time, and taking
//   out every exponential or p v saves only 8-12% of this design's 0.23.
//   Each tile is a chain (s, its wait, the softmax, p v, its wait) that two
//   warpgroups cannot cover.  Without the producer warp a block is 8 warps,
//   and at 128 registers a thread two blocks fit an SM (16 warps, four on
//   each 16,384-register partition): four warpgroups cover each other's
//   chains and one block's prologue and epilogue, 0.23 ms.  Issuing the
//   loads costs the first warp a wait for the other warpgroup's hand-back
//   of the stage before last: held to one block an SM this design runs
//   0.34 ms.  At d = 128 (168 registers) one block fits.
// - The rescale of o: o belongs to the RS wgmma until its wait; each tile's
//   products complete within the tile, and o is scaled between them behind
//   fence_regs.  Issuing tile j's s with tile j - 1's p v, to run the
//   softmax while p v is in flight, needs more than 128 registers: ptxas
//   runs every wgmma one at a time (its C7512 note), 0.25 ms.
// - Branches: the mask, segment and dropout branches are uniform over a
//   tile and sit outside branch-free element loops (an if-converted hash
//   inside the loop cost the backward's dq 0.27 -> 0.41 ms).
// fp32 inputs take a separate CUDA-core kernel in full fp32 (never TF32):
// one warp per query row, 32 keys a step.
//
// Template parameters are only the element type and the head dim (32, 64
// or 128): nine instantiations.  Causal, segments and dropout are runtime
// arguments.
//
// C interface (loaded with ctypes): apex_flash_attention_fwd returns
// cudaGetLastError() after the launch, 0 on success, and
// cudaErrorInvalidValue for a shape it does not take or a tensor map that is
// not the kernel's or that cuTensorMapEncodeTiled refuses.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_sm90.cuh"

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
// bf16 / fp16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockRows = 128;   // query rows a block owns
constexpr int kWgRows = 64;       // query rows a consumer warpgroup owns
constexpr int kTileRows = 64;     // keys a streamed tile
constexpr int kStages = 4;        // streamed tiles in flight
constexpr int kConsumers = 2;     // consumer warpgroups; warp 0 also issues the loads
constexpr int kThreads = kConsumers * 128;

// Shared memory, from a 1024-byte boundary (the swizzle's period): the q
// tile [kBlockRows, D], the ring of kStages stages of the k and v tiles
// [kTileRows, D], the stages' key segment ids, then the ring's barriers:
// 82 KB at d = 64, so two blocks fit an SM.
template <int D>
struct FwdSmem {
  static constexpr int kQ = FlashTile<D>::bytes(kBlockRows);
  static constexpr int kTile = FlashTile<D>::bytes(kTileRows);
  static constexpr int kStage = 2 * kTile;
  static constexpr int kSeg = kQ + kStages * kStage;           // [kStages][kTileRows] int32
  static constexpr int kBars = kSeg + kStages * kTileRows * 4;
  static constexpr int kBytes = 1024 + kBars + FlashRing<kStages>::kBytes;
};

// two blocks an SM at d <= 64 (four consumer warpgroups, so one block's
// prologue and epilogue overlap the other's tiles), which holds a thread
// to 128 registers; one at d = 128
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const Params p) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t base = (smem_u32(flash_smem) + 1023) & ~1023u;
  unsigned char* const gbase = flash_smem + (base - smem_u32(flash_smem));
  const uint32_t q_s = base;
  auto k_s = [&](int s) { return base + L::kQ + s * L::kStage; };
  auto v_s = [&](int s) { return base + L::kQ + s * L::kStage + L::kTile; };
  int* const kseg_s = reinterpret_cast<int*>(gbase + L::kSeg);   // [kStages][kTileRows]
  const FlashRing<kStages> ring{base + L::kBars};

  // x is the (batch, head) and y the query tile, so in x-fastest start
  // order the heaviest tiles of every head start first (causal: the last
  // query tiles see the most keys) and the light ones fill the tail
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int khi = hi / (p.h / p.hk);
  const int q_tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kBlockRows;
  const int n_tiles = key_tiles(p, q0, min(q0 + kBlockRows, p.sq), kTileRows);
  const bool has_seg = p.qseg != nullptr;
  init_ring(ring);

  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // rows q0 + 64 c ...
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0c = q0 + c * kWgRows;

  // Warp 0 of warpgroup 0 (whose rows see the fewest keys) also keeps the
  // ring full: q on `once`, the first kStages tiles, then at the end of
  // each tile j it refills the stage of tile j - 1, once both warpgroups
  // have handed it back.  Its lanes stage the segment ids of the keys and
  // arrive on `full` (lane 0 with the stage's bytes).
  const bool producer = threadIdx.x < 32;
  auto produce = [&](int j, int st) {
    if (has_seg)
      for (int r = lane; r < kTileRows; r += 32) {
        const int col = j * kTileRows + r;
        kseg_s[st * kTileRows + r] = col < p.sk ? p.kseg[(int64_t)bi * p.sk + col] : 0;
      }
    if (lane == 0) {
      mbar_expect_tx(ring.full(st), L::kStage);
      tma_load_tile<D>(k_s(st), &map_k, j * kTileRows, khi, bi, kTileRows, ring.full(st));
      tma_load_tile<D>(v_s(st), &map_v, j * kTileRows, khi, bi, kTileRows, ring.full(st));
    } else {
      mbar_arrive(ring.full(st));
    }
  };
  if (producer && n_tiles > 0) {
    if (lane == 0) {
      mbar_expect_tx(ring.once(), L::kQ);
      tma_load_tile<D>(q_s, &map_q, q0, hi, bi, kBlockRows, ring.once());
    }
    for (int j = 0; j < min(kStages, n_tiles); ++j) produce(j, j);
  }
  const int my_tiles = q0c < p.sq ? key_tiles(p, q0c, min(q0c + kWgRows, p.sq), kTileRows) : 0;

  // this thread's two rows of the accumulators: element i lies at row
  // row_a (i & 2 clear) or row_b, column 8 (i / 4) + 2 tig + (i & 1)
  const int row_a = q0c + warp * 16 + g, row_b = row_a + 8;
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
  const float scale_log2 = p.scale * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F;   // running max, log2 units
  float l_a = 0.f, l_b = 0.f;                       // this lane's partial sums
  if (n_tiles > 0) mbar_wait(ring.once(), 0);
  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(ring.full(s), phase);
    if (j < my_tiles) {
      // s = q k^T for the warpgroup's 64 rows x 64 keys
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64<T>(sc, desc_kmajor<D>(q_s, kBlockRows, c * kWgRows, kk),
                           desc_kmajor<D>(k_s(s), kTileRows, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask and take the rows' max of the raw scores (the scale, positive,
      // folds into the exponent's FFMA below): each branch is uniform over
      // the tile and its loop free of branches; only the ragged last tile
      // (whose zero-filled keys score 0), the tiles the causal diagonal
      // crosses and segment ids take the per-element test
      const int k0 = j * kTileRows;
      const bool need_mask = has_seg || k0 + kTileRows > p.sk ||
                             (p.causal && k0 + kTileRows - 1 > q0c + causal_off);
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool lo = (i & 2) == 0;
          const int cc = (i >> 2) * 8 + tig * 2 + (i & 1);   // key within the tile
          const int col = k0 + cc;
          bool ok = col < p.sk;
          if (p.causal) ok = ok && col <= (lo ? row_a : row_b) + causal_off;
          if (has_seg) ok = ok && kseg_s[s * kTileRows + cc] == (lo ? seg_a : seg_b);
          sc[i] = ok ? sc[i] : -CUDART_INF_F;
          if (lo) mx_a = fmaxf(mx_a, sc[i]); else mx_b = fmaxf(mx_b, sc[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i & 2) == 0) mx_a = fmaxf(mx_a, sc[i]); else mx_b = fmaxf(mx_b, sc[i]);
        }
      }
      // the four lanes of a quad hold a row's 64 keys between them
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      mx_a *= scale_log2;
      mx_b *= scale_log2;
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
      for (int i = 0; i < 32; ++i) {
        const bool lo = (i & 2) == 0;
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -(lo ? base_a : base_b)));   // -inf -> 0
        if (lo) sum_a += sc[i]; else sum_b += sc[i];
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
      // o's last product has completed: rescale it in place
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;

      // o += p v: p (kept and rescaled under dropout), rounded to T, is the
      // A operand from registers; v the stage's tile read MN-major
      uint32_t a[4][4];
      if (p.dropout) {
        uint32_t kept = 0;                         // bit i: element i's keep bit
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
          const uint32_t hh = fmix32(fmix32(((i & 2) ? hash_b : hash_a) ^ (uint32_t)col) ^
                                     (uint32_t)bh);
          kept |= (uint32_t)(hh >= p.threshold) << i;
        }
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a_kept<T>(a[kc], sc, kc, kept, p.keep_scale);
      } else {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a<T>(a[kc], sc, kc);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<T, D>(o, a[kc], desc_mnmajor<D>(v_s(s), kTileRows, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    // (a warpgroup whose rows see none of the tile's keys skips it)
    if (t == 0) mbar_arrive(ring.empty(s));
    if (producer && j >= 1 && j - 1 + kStages < n_tiles) {
      // the stage of tile j - 1, and the parity of its fill
      const int ps = s == 0 ? kStages - 1 : s - 1;
      mbar_wait(ring.empty(ps), s == 0 ? phase ^ 1 : phase);
      produce(j - 1 + kStages, ps);
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  T* ob = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row_a < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * p.o_ss + col) =
          pack2<T>(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    if (row_b < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * p.o_ss + col) =
          pack2<T>(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
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
cudaError_t launch_wgmma(const Params& p, const long long* maps, cudaStream_t stream) {
  // maps: q in [kBlockRows] boxes, k and v in [kTileRows] boxes
  CUtensorMap mq, mk, mv;
  if (maps == nullptr || !flash_tensor_map<T, D>(&mq, p.q, maps, kBlockRows) ||
      !flash_tensor_map<T, D>(&mk, p.k, maps + 12, kTileRows) ||
      !flash_tensor_map<T, D>(&mv, p.v, maps + 24, kTileRows))
    return cudaErrorInvalidValue;
  const auto kernel = flash_fwd_wgmma<T, D>;
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.sq + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, FwdSmem<D>::kBytes, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.sq + kF32Rows - 1) / kF32Rows, p.b * p.h);
  flash_fwd_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_dtype(int dtype, const Params& p, const long long* maps, cudaStream_t stream) {
  switch (dtype) {
    case kF32: return launch_f32<D>(p, stream);
    case kBF16: return launch_wgmma<__nv_bfloat16, D>(p, maps, stream);
    case kF16: return launch_wgmma<__half, D>(p, maps, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, h, sq, d], k and v [b, hk, sk, d] with element strides (batch, head,
// row) given and a unit last stride; o like q (its own strides); lse
// [b, h, sq] fp32 contiguous; qseg [b, sq] and kseg [b, sk] int32 or both
// null.  16-bit operands start on 16 bytes with strides that are multiples
// of 8.  `maps`, for bf16 and fp16 (fp32 ignores it): the geometry of three
// rank-4 tensor maps, 12 values each (flash_tensor_map), q with boxes of
// kBlockRows rows, then k and v with kTileRows.  dtype: 0 fp32, 1 bf16, 2
// fp16; d: 32, 64 or 128.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int apex_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qseg, const void* kseg, int b, int h, int hk, int sq, int sk,
    int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    const long long* maps, float scale, int causal, int dropout, unsigned seed,
    unsigned threshold, float keep_scale, int dtype, void* stream) {
  if (b < 1 || h < 1 || hk < 1 || h % hk || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  // grid.y: (batch, head) of the fp32 kernel, query tiles of the wgmma one
  if (b * h > 65535 || (sq + kBlockRows - 1) / kBlockRows > 65535) return cudaErrorInvalidValue;
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse),
           static_cast<const int*>(qseg), static_cast<const int*>(kseg),
           b, h, hk, sq, sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal != 0, dropout != 0, seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32: err = by_dtype<32>(dtype, p, maps, s); break;
    case 64: err = by_dtype<64>(dtype, p, maps, s); break;
    case 128: err = by_dtype<128>(dtype, p, maps, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
