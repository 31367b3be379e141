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
// Design for that bound: the products on wgmma, the only path to the
// tensor cores' full rate (mma.sync from ldmatrix stops near two thirds of
// it), fed by TMA (flash_sm90.cuh, on wgmma_sm90.cuh's mbarriers and
// encoder).  A block is two consumer warpgroups of 64 rows each and one
// producer warp, which keeps kStages streamed tiles in flight through a
// ring of full/empty mbarriers.  Both kernels are the forward's tiling
// turned around the loop the TPU ran as its sequential grid axis:
// - dq: a block owns 128 query rows of one (batch, head); q and do arrive
//   once, k and v stream in 64-key tiles.  Each consumer computes s = q k^T
//   and dp = do v^T (SS m64n64k16, both K-major; p's exponentials run while
//   dp is in flight), forms ds in registers and feeds it, rounded, as the A
//   operand of dq += ds k (RS m64nDk16, the k tile read MN-major through
//   the transpose bit: k is never copied transposed); dq accumulates in
//   fp32 registers.  Before its first tile it sums delta for its rows from
//   o and do and writes it to device memory for the dk/dv kernel (launched
//   after it).
// - dk/dv: a block owns 128 keys of one (batch, kv head); k and v arrive
//   once, and q, do, lse and delta stream over every query tile of every
//   query head of the group.  Each consumer computes s^T = k q^T and dp^T
//   = v do^T (SS), and p_kept^T and ds^T in registers become the A
//   operands of dv += p_kept^T do and dk += ds^T q (RS, do and q read
//   MN-major).  dk and dv stay in registers over the whole group, so the
//   GQA sum needs no atomics.
// Each output tile is owned by one block and summed in one order: no
// atomics, the same bits on every call.  Whole tiles above the causal
// diagonal are skipped (the dq loop ends at the last visible key tile, the
// dk/dv loop starts at the first query tile that sees the block's keys, and
// a warpgroup skips the tiles its own rows do not see), the per-element
// mask runs only on tiles that need it, and the grid starts the heaviest
// tiles first.
//
// What bit, and what the design does about it (times: the main shape, bf16,
// NVIDIA H100 80GB HBM3 at 700 W, from apex_tpu_torch/tools/
// flash_bwd_variants.py, which builds the rejected designs beside this one):
// - Layout: the model hands over [s, b, heads, d] viewed as [b, heads, s,
//   d], so a 2-D map cannot describe an operand.  Each is a rank-4 map
//   (d, s, heads, b) from its byte strides (ops/flash_attention.py's
//   _tma_geometry, which raises on a stride that is not a multiple of 16
//   bytes); dq, dk and dv are stored from registers with q's, k's and v's
//   strides.
// - Swizzle against d: a 128-byte row swizzles over 128 bytes; d = 128 is
//   two [rows, 64] boxes side by side (LBO one box between them when read
//   MN-major), d = 32 a 64-byte row with the 64-byte swizzle, its
//   descriptor mode and an SBO of 512 bytes (flash_sm90.cuh).
// - Ragged and dead rows: TMA zero-fills rows past sq or sk and counts
//   whole boxes; p is 0 there because a row past sq (and a fully masked
//   row) has lse = +inf, and a key past sk is masked; stores skip rows past
//   the edge.
// - Dropout: element (row, col) of warp w's accumulator lies at rows 16 w
//   + lane / 4 (+ 8) and columns 8 i + 2 (lane % 4) (+ 1) of its
//   warpgroup's 64, offset by the warpgroup's rows and the tile's origin;
//   the keep bit hashes those coordinates as the forward does (rows are
//   keys and columns queries in dk/dv).
// - Branches in the element loops: with `if (p.dropout)` inside the
//   unrolled loop the compiler if-converts it and hashes every element of
//   every tile, dropout or not (dq 0.41 ms against 0.27); the mask and
//   dropout branches sit outside loops that have none.
// - Registers: a consumer has 168 registers a thread (nine warps, three of
//   them on one of the SM's four 16,384-register partitions).  A producer
//   warpgroup cut to 24 by setmaxnreg (for consumers asking 240) spills on
//   its lse and delta loads and starves the ring, and ptxas gives the
//   consumers no more (dk/dv 0.43 ms against 0.36): no setmaxnreg, and
//   one producer warp.  Where live values and the accumulators of products
//   in flight outgrow the registers, ptxas runs every wgmma of the kernel
//   one at a time (its C7512 note): dk/dv packs both A operands after ds,
//   once s^T and dp^T are dead, and lets each tile's products complete
//   within the tile (overlapping them with the next tile's s^T and dp^T
//   serializes it: 0.43 ms).  At d = 128 (dk and dv, 64 + 64 fp32, beside
//   s^T and dp^T) dk/dv stays serialized: right, and slower.
// fp32 inputs take CUDA-core kernels in full fp32 (never TF32): one warp
// per query row (dq) or key row (dk/dv), 32 columns a step.
//
// C interface (loaded with ctypes): apex_flash_attention_dq and
// apex_flash_attention_dkv take one argument list and return
// cudaGetLastError() after the launch, 0 on success, and
// cudaErrorInvalidValue for a shape they do not take or a tensor map that
// is not the kernel's or that cuTensorMapEncodeTiled refuses.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_sm90.cuh"

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
// bf16 / fp16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int kBlockRows = 128;   // rows a block owns: queries (dq), keys (dk/dv)
constexpr int kWgRows = 64;       // rows a consumer warpgroup owns
constexpr int kTileRows = 64;     // rows a streamed tile: keys (dq), queries (dk/dv)
constexpr int kStages = 3;        // streamed tiles in flight
constexpr int kConsumers = 2;     // consumer warpgroups, warps 0-7
constexpr int kThreads = kConsumers * 128 + 32;   // and one producer warp

// Shared memory, from a 1024-byte boundary (the swizzle's period): the two
// [kBlockRows, D] tiles loaded once (q and do for dq, k and v for dk/dv),
// the ring of kStages stages of two [kTileRows, D] tiles (k and v, or q and
// do), the stages' vectors (dq: the keys' segment ids; dk/dv: the queries'
// lse in log2 units, delta and segment ids), the block's delta (dq), then
// the barriers: `once`, full[kStages], empty[kStages].
template <int D>
struct BwdSmem {
  static constexpr int kBlockTile = FlashTile<D>::bytes(kBlockRows);
  static constexpr int kTile = FlashTile<D>::bytes(kTileRows);
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = 2 * kBlockTile;
  static constexpr int kVecs = kRing + kStages * kStage;      // [3][kStages][kTileRows] 32-bit
  static constexpr int kRowVec = kVecs + 3 * kStages * kTileRows * 4;   // [kBlockRows] fp32
  static constexpr int kBars = kRowVec + kBlockRows * 4;
  static constexpr int kBytes = 1024 + kBars + FlashRing<kStages>::kBytes;
};

using Ring = FlashRing<kStages>;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const Params p) {
  using L = BwdSmem<D>;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t base = (smem_u32(flash_smem) + 1023) & ~1023u;
  unsigned char* const gbase = flash_smem + (base - smem_u32(flash_smem));
  const uint32_t q_s = base, do_s = base + L::kBlockTile;
  auto k_s = [&](int s) { return base + L::kRing + s * L::kStage; };
  auto v_s = [&](int s) { return base + L::kRing + s * L::kStage + L::kTile; };
  int* const kseg_s = reinterpret_cast<int*>(gbase + L::kVecs);     // [kStages][kTileRows]
  float* const dl_s = reinterpret_cast<float*>(gbase + L::kRowVec);  // [kBlockRows]
  const Ring ring{base + L::kBars};

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

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    const int lane = threadIdx.x % 32;
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(ring.once(), 2 * L::kBlockTile);
      tma_load_tile<D>(q_s, &map_q, q0, hi, bi, kBlockRows, ring.once());
      tma_load_tile<D>(do_s, &map_do, q0, hi, bi, kBlockRows, ring.once());
    }
    int s = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      if (j >= kStages) mbar_wait(ring.empty(s), phase ^ 1);
      if (has_seg)
        for (int r = lane; r < kTileRows; r += 32) {
          const int col = j * kTileRows + r;
          kseg_s[s * kTileRows + r] = col < p.sk ? p.kseg[(int64_t)bi * p.sk + col] : 0;
        }
      if (lane == 0) {
        mbar_expect_tx(ring.full(s), L::kStage);
        tma_load_tile<D>(k_s(s), &map_k, j * kTileRows, khi, bi, kTileRows, ring.full(s));
        tma_load_tile<D>(v_s(s), &map_v, j * kTileRows, khi, bi, kTileRows, ring.full(s));
      } else {
        mbar_arrive(ring.full(s));
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int c = wg;                                // rows q0 + 64 c ... of the block
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0c = q0 + c * kWgRows;
  const int my_tiles = q0c < p.sq ? key_tiles(p, q0c, min(q0c + kWgRows, p.sq), kTileRows) : 0;

  // delta = rowsum(do * o) for the warpgroup's rows, two threads a row,
  // while the producer's first loads are in flight
  {
    const int r = t >> 1, half = t & 1, row = q0c + r;
    float acc = 0.f;
    if (row < p.sq) {
      const T* orow = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh +
                      (int64_t)row * p.o_ss + half * (D / 2);
      const T* drow = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh +
                      (int64_t)row * p.do_ss + half * (D / 2);
#pragma unroll
      for (int c8 = 0; c8 < D / 2; c8 += 8) {
        float ov[8], dv[8];
        load_f32<T, 8>(orow + c8, ov);
        load_f32<T, 8>(drow + c8, dv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(ov[i], dv[i], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[c * kWgRows + r] = acc;
      if (row < p.sq) p.delta[(int64_t)bh * p.sq + row] = acc;
    }
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");

  const int row_a = q0c + warp * 16 + g, row_b = row_a + 8;
  const float delta_a = dl_s[c * kWgRows + warp * 16 + g];
  const float delta_b = dl_s[c * kWgRows + warp * 16 + g + 8];
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

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n_tiles > 0) mbar_wait(ring.once(), 0);
  // s and dp are two commit groups, so p's exponentials run while dp is in
  // flight; a stage goes back to the producer once the dq product that
  // reads it has completed
  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(ring.full(s), phase);
    if (j < my_tiles) {
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64<T>(sc, desc_kmajor<D>(q_s, kBlockRows, c * kWgRows, kk),
                           desc_kmajor<D>(k_s(s), kTileRows, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64<T>(dp, desc_kmajor<D>(do_s, kBlockRows, c * kWgRows, kk),
                           desc_kmajor<D>(v_s(s), kTileRows, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();                             // s
      fence_regs(sc);

      // p = 2^(s scale log2e - lse): each branch below is uniform over the
      // tile and its loop free of branches (a masked element's exponent is
      // -inf, whose 2^x is 0); only tiles on the edges take the masks, and
      // only dropout hashes
      const int k0 = j * kTileRows;
      const bool need_mask = has_seg || k0 + kTileRows > p.sk ||
                             (p.causal && k0 + kTileRows - 1 > q0c + causal_off);
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool lo = (i & 2) == 0;
          const int cc = (i >> 2) * 8 + tig * 2 + (i & 1);   // key within the tile
          const int col = k0 + cc;
          bool ok = col < p.sk;
          if (p.causal) ok = ok && col <= (lo ? row_a : row_b) + causal_off;
          if (has_seg) ok = ok && kseg_s[s * kTileRows + cc] == (lo ? seg_a : seg_b);
          sc[i] = fast_exp2(ok ? sc[i] * scale_log2 - (lo ? lse_a : lse_b) : -CUDART_INF_F);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = fast_exp2(sc[i] * scale_log2 - ((i & 2) == 0 ? lse_a : lse_b));
      }
      wgmma_wait<0>();                             // dp
      fence_regs(dp);
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool lo = (i & 2) == 0;
          const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
          const bool keep = keep_bit(p.seed, (uint32_t)(lo ? row_a : row_b), (uint32_t)col,
                                     (uint32_t)bh, p.threshold);
          sc[i] *= (keep ? dp[i] * p.keep_scale : 0.f) - (lo ? delta_a : delta_b);   // ds
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - ((i & 2) == 0 ? delta_a : delta_b);
      }
      // dq += ds k: ds, rounded to T, is the A operand from registers; k
      // the same tile read MN-major
      uint32_t a[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) acc_to_a<T>(a[kc], sc, kc);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<T, D>(dq, a[kc], desc_mnmajor<D>(k_s(s), kTileRows, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    // (a warpgroup whose rows see none of the tile's keys skips it)
    if (t == 0) mbar_arrive(ring.empty(s));
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  T* dqb = static_cast<T*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row_a < p.sq)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)row_a * p.dq_ss + col) =
          pack2<T>(dq[4 * n] * p.scale, dq[4 * n + 1] * p.scale);
    if (row_b < p.sq)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)row_b * p.dq_ss + col) =
          pack2<T>(dq[4 * n + 2] * p.scale, dq[4 * n + 3] * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                const Params p) {
  using L = BwdSmem<D>;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t base = (smem_u32(flash_smem) + 1023) & ~1023u;
  unsigned char* const gbase = flash_smem + (base - smem_u32(flash_smem));
  const uint32_t k_s = base, v_s = base + L::kBlockTile;
  auto q_s = [&](int s) { return base + L::kRing + s * L::kStage; };
  auto do_s = [&](int s) { return base + L::kRing + s * L::kStage + L::kTile; };
  float* const ls_s = reinterpret_cast<float*>(gbase + L::kVecs);   // [kStages][kTileRows], log2 units
  float* const ds_s = ls_s + kStages * kTileRows;                     // delta
  int* const qg_s = reinterpret_cast<int*>(ds_s + kStages * kTileRows);
  const Ring ring{base + L::kBars};

  // x is the (batch, kv head) and y the key tile, so in x-fastest start
  // order the heaviest tiles of every head start first (causal: the first
  // key tiles are seen by the most query tiles)
  const int bkh = blockIdx.x;
  const int bi = bkh / p.hk, khi = bkh % p.hk;
  const int rep = p.h / p.hk;
  const int k0 = blockIdx.y * kBlockRows;
  const bool has_seg = p.qseg != nullptr;
  const int i_start = first_query_tile(p, k0, kTileRows);
  const int n_qt = (p.sq + kTileRows - 1) / kTileRows;
  const int n_iq = max(0, n_qt - i_start);
  const int total = rep * n_iq;                    // (query head, query tile) pairs
  init_ring(ring);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    const int lane = threadIdx.x % 32;
    if (total == 0) return;
    if (lane == 0) {
      mbar_expect_tx(ring.once(), 2 * L::kBlockTile);
      tma_load_tile<D>(k_s, &map_k, k0, khi, bi, kBlockRows, ring.once());
      tma_load_tile<D>(v_s, &map_v, k0, khi, bi, kBlockRows, ring.once());
    }
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0; it < total; ++it) {
      if (it >= kStages) mbar_wait(ring.empty(s), phase ^ 1);
      const int hq = khi * rep + it / n_iq;
      const int i0 = (i_start + it % n_iq) * kTileRows;
      const int64_t bhq = (int64_t)bi * p.h + hq;
      for (int r = lane; r < kTileRows; r += 32) {
        const int row = i0 + r;
        const bool in = row < p.sq;
        ls_s[s * kTileRows + r] = in ? p.lse[bhq * p.sq + row] * kLog2e : CUDART_INF_F;
        ds_s[s * kTileRows + r] = in ? p.delta[bhq * p.sq + row] : 0.f;
        if (has_seg) qg_s[s * kTileRows + r] = in ? p.qseg[(int64_t)bi * p.sq + row] : 0;
      }
      if (lane == 0) {
        mbar_expect_tx(ring.full(s), L::kStage);
        tma_load_tile<D>(q_s(s), &map_q, i0, hq, bi, kTileRows, ring.full(s));
        tma_load_tile<D>(do_s(s), &map_do, i0, hq, bi, kTileRows, ring.full(s));
      } else {
        mbar_arrive(ring.full(s));
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int c = wg;                                // keys k0 + 64 c ... of the block
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0c = k0 + c * kWgRows;
  const int first_c = first_query_tile(p, k0c, kTileRows);
  const int key_a = k0c + warp * 16 + g, key_b = key_a + 8;
  int seg_a = 0, seg_b = 0;
  if (has_seg) {
    if (key_a < p.sk) seg_a = p.kseg[(int64_t)bi * p.sk + key_a];
    if (key_b < p.sk) seg_b = p.kseg[(int64_t)bi * p.sk + key_b];
  }
  const int causal_off = p.sk - p.sq;
  const float scale_log2 = p.scale * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (total > 0) mbar_wait(ring.once(), 0);
  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < total; ++it) {
    mbar_wait(ring.full(s), phase);
    const int ti = i_start + it % n_iq;
    if (ti >= first_c && k0c < p.sk) {
      const int hq = khi * rep + it / n_iq;
      const int q0 = ti * kTileRows;
      const uint32_t bhq = (uint32_t)(bi * p.h + hq);
      // s^T = k q^T and dp^T = v do^T (keys x queries), both operands K-major
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64<T>(sc, desc_kmajor<D>(k_s, kBlockRows, c * kWgRows, kk),
                           desc_kmajor<D>(q_s(s), kTileRows, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64<T>(dp, desc_kmajor<D>(v_s, kBlockRows, c * kWgRows, kk),
                           desc_kmajor<D>(do_s(s), kTileRows, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool need_mask = has_seg || q0 + kTileRows > p.sq ||
                             (p.causal && k0c + kWgRows - 1 > q0 + causal_off);
      const float* lse = ls_s + s * kTileRows;
      const float* dl = ds_s + s * kTileRows;
      // p^T = 2^(s^T scale log2e - lse): as in dq, uniform branches around
      // loops free of branches
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool lo = (i & 2) == 0;
          const int qc = (i >> 2) * 8 + tig * 2 + (i & 1);   // query within the tile
          const int row = q0 + qc;
          bool ok = row < p.sq;
          if (p.causal) ok = ok && (lo ? key_a : key_b) <= row + causal_off;
          if (has_seg) ok = ok && qg_s[s * kTileRows + qc] == (lo ? seg_a : seg_b);
          sc[i] = fast_exp2(ok ? sc[i] * scale_log2 - lse[qc] : -CUDART_INF_F);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = fast_exp2(sc[i] * scale_log2 - lse[(i >> 2) * 8 + tig * 2 + (i & 1)]);
      }
      // ds^T = p^T (dp^T - delta), dp^T kept and rescaled under dropout;
      // then both A operands, p_kept^T and ds^T, rounded to T: s^T and dp^T
      // are dead before the products are issued and the products complete
      // within the tile, which keeps the consumer inside its registers (no
      // serialized wgmma at d <= 64)
      uint32_t ap[4][4], ad[4][4];
      if (p.dropout) {
        uint32_t kept = 0;                         // bit i: element i's keep bit
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qc = (i >> 2) * 8 + tig * 2 + (i & 1);
          const bool keep = keep_bit(p.seed, (uint32_t)(q0 + qc),
                                     (uint32_t)((i & 2) ? key_b : key_a), bhq, p.threshold);
          kept |= (uint32_t)keep << i;
          dp[i] = sc[i] * ((keep ? dp[i] * p.keep_scale : 0.f) - dl[qc]);
        }
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          acc_to_a_kept<T>(ap[kc], sc, kc, kept, p.keep_scale);
          acc_to_a<T>(ad[kc], dp, kc);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dp[i] = sc[i] * (dp[i] - dl[(i >> 2) * 8 + tig * 2 + (i & 1)]);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          acc_to_a<T>(ap[kc], sc, kc);
          acc_to_a<T>(ad[kc], dp, kc);
        }
      }
      // dv += p_kept^T do and dk += ds^T q, do and q the stage's tiles read
      // MN-major
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<T, D>(dv, ap[kc], desc_mnmajor<D>(do_s(s), kTileRows, kc));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<T, D>(dk, ad[kc], desc_mnmajor<D>(q_s(s), kTileRows, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    // (a warpgroup none of whose keys the tile's queries see skips it)
    if (t == 0) mbar_arrive(ring.empty(s));
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  T* dkb = static_cast<T*>(p.dk) + bi * p.dk_sb + khi * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + bi * p.dv_sb + khi * p.dv_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (key_a < p.sk) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key_a * p.dk_ss + col) =
          pack2<T>(dk[4 * n] * p.scale, dk[4 * n + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key_a * p.dv_ss + col) =
          pack2<T>(dv[4 * n], dv[4 * n + 1]);
    }
    if (key_b < p.sk) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key_b * p.dk_ss + col) =
          pack2<T>(dk[4 * n + 2] * p.scale, dk[4 * n + 3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key_b * p.dv_ss + col) =
          pack2<T>(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
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
cudaError_t launch_dq_wgmma(const Params& p, const long long* maps, cudaStream_t stream) {
  // maps: q and do in [kBlockRows] boxes, k and v in [kTileRows] boxes
  CUtensorMap mq, mdo, mk, mv;
  if (maps == nullptr || !flash_tensor_map<T, D>(&mq, p.q, maps, kBlockRows) ||
      !flash_tensor_map<T, D>(&mdo, p.dout, maps + 12, kBlockRows) ||
      !flash_tensor_map<T, D>(&mk, p.k, maps + 24, kTileRows) ||
      !flash_tensor_map<T, D>(&mv, p.v, maps + 36, kTileRows))
    return cudaErrorInvalidValue;
  const auto kernel = flash_dq_wgmma<T, D>;
  // the attribute is per device: set it on every launch, for the current one
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.sq + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, BwdSmem<D>::kBytes, stream>>>(mq, mdo, mk, mv, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_wgmma(const Params& p, const long long* maps, cudaStream_t stream) {
  // maps: k and v in [kBlockRows] boxes, q and do in [kTileRows] boxes
  CUtensorMap mk, mv, mq, mdo;
  if (maps == nullptr || !flash_tensor_map<T, D>(&mk, p.k, maps, kBlockRows) ||
      !flash_tensor_map<T, D>(&mv, p.v, maps + 12, kBlockRows) ||
      !flash_tensor_map<T, D>(&mq, p.q, maps + 24, kTileRows) ||
      !flash_tensor_map<T, D>(&mdo, p.dout, maps + 36, kTileRows))
    return cudaErrorInvalidValue;
  const auto kernel = flash_dkv_wgmma<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.hk, (p.sk + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, BwdSmem<D>::kBytes, stream>>>(mk, mv, mq, mdo, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(int dtype, const Params& p, const long long* maps, cudaStream_t stream) {
  switch (dtype) {
    case kF32: {
      const dim3 grid((p.sq + kF32Rows - 1) / kF32Rows, p.b * p.h);
      flash_dq_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
      return cudaGetLastError();
    }
    case kBF16: return launch_dq_wgmma<__nv_bfloat16, D>(p, maps, stream);
    case kF16: return launch_dq_wgmma<__half, D>(p, maps, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_dkv(int dtype, const Params& p, const long long* maps, cudaStream_t stream) {
  switch (dtype) {
    case kF32: {
      const dim3 grid((p.sk + kF32Rows - 1) / kF32Rows, p.b * p.hk);
      flash_dkv_f32<D><<<grid, kF32Rows * 32, 0, stream>>>(p);
      return cudaGetLastError();
    }
    case kBF16: return launch_dkv_wgmma<__nv_bfloat16, D>(p, maps, stream);
    case kF16: return launch_dkv_wgmma<__half, D>(p, maps, stream);
  }
  return cudaErrorInvalidValue;
}

bool make_params(Params& p, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, const void* qseg,
                 const void* kseg, void* dq, void* dk, void* dv, int b, int h, int hk, int sq,
                 int sk, const long long* st, float scale, int causal, int dropout,
                 unsigned seed, unsigned threshold, float keep_scale) {
  if (b < 1 || h < 1 || hk < 1 || h % hk || sq < 1 || sk < 1) return false;
  // grid.y: (batch, head) of the fp32 kernels, tiles of the wgmma kernels
  if (b * h > 65535 || (sq + kTileRows - 1) / kTileRows > 65535 ||
      (sk + kTileRows - 1) / kTileRows > 65535)
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
// with strides that are multiples of 8.  `maps`, for bf16 and fp16 (fp32
// ignores it): the geometry of four rank-4 tensor maps, 12 values each
// (flash_tensor_map), for dq q and do with boxes of kBlockRows rows then k
// and v with kTileRows, for dk/dv k and v with kBlockRows then q and do
// with kTileRows.  lse and delta [b, h, sq] fp32 contiguous; qseg [b, sq]
// and kseg [b, sk] int32 or both null.  dtype: 0 fp32, 1 bf16, 2 fp16; d:
// 32, 64 or 128.
//
// apex_flash_attention_dq writes dq and delta; apex_flash_attention_dkv
// reads delta as dq wrote it and writes dk and dv.  Each launches on
// `stream` and returns cudaGetLastError().
#define FLASH_BWD_ARGS                                                                    \
  const void *q, const void *k, const void *v, const void *o, const void *dout,           \
      const void *lse, void *delta, const void *qseg, const void *kseg, void *dq, void *dk, \
      void *dv, int b, int h, int hk, int sq, int sk, int d, const long long *strides,      \
      const long long *maps, float scale, int causal, int dropout, unsigned seed,           \
      unsigned threshold, float keep_scale, int dtype, void *stream

extern "C" int apex_flash_attention_dq(FLASH_BWD_ARGS) {
  Params p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, qseg, kseg, dq, dk, dv, b, h, hk, sq, sk,
                   strides, scale, causal, dropout, seed, threshold, keep_scale))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dq<32>(dtype, p, maps, s);
    case 64: return (int)launch_dq<64>(dtype, p, maps, s);
    case 128: return (int)launch_dq<128>(dtype, p, maps, s);
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
    case 32: return (int)launch_dkv<32>(dtype, p, maps, s);
    case 64: return (int)launch_dkv<64>(dtype, p, maps, s);
    case 128: return (int)launch_dkv<128>(dtype, p, maps, s);
  }
  return cudaErrorInvalidValue;
}
