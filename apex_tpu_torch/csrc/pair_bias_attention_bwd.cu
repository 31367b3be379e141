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
// sums its r terms in fp32, in the order of t, and is rounded once, to the
// bias's dtype: the same bits on every call, no atomics.
//
// Bound.  At the main path's shape (R 128, h 8, s 1024, d 32, bf16, 10% of
// the keys masked) each kernel recomputes p over the valid keys, 0.97e9
// exponentials, 0.231 ms at the SFU rate (16 a clock an SM, 132 SMs, 1.98
// GHz).  Their products: dq three (s, dp, ds k: 186 GFLOP, 0.188 ms at 989
// TFLOP/s), dk/dv four (248 GFLOP, 0.250 ms), dbias two (124 GFLOP, 0.125
// ms); their bytes 0.07-0.1 ms.  So the exponentials bind dq and dbias, and
// the products dk/dv, each with some ten scalar instructions a score beside
// its exp2 (the bias's load and convert, the mask term, two fused
// multiply-adds, the rounding to 16 bits).
//
// Design: the flash backward's (flash_attention_bwd.cu) on flash_sm90.cuh,
// with the bias and the mask streamed as the pair-bias forward streams them
// (pair_bias_attention_fwd.cu).  Each kernel's block is two consumer
// warpgroups of 64 rows and one producer warp (288 threads, no setmaxnreg,
// one block an SM), which keeps the stages of a FlashRing of full/empty
// mbarriers filled by TMA through rank-4 maps of each operand's own strides
// (OpenFold's q, k, v are strided views of [R, s, h, d], and do is what
// autograd hands over, copied where no map can step over it); d is
// zero-filled to D = 32, 64 or 128 by TMA (box columns past d read zeros).
// Rings of 3 stages, 2 at D = 128, so that d 128 with an fp32 bias fits.
// The bias tile is 128-byte-swizzled boxes of 64 rows by 128 bytes where
// its rows are whole 16-byte chunks, else each lane loads its values from
// device memory; either way each consumer reads its bias words group by
// group (8 of its 32) as p needs them.  The kv mask arrives as its 64 bytes
// a key tile (a map of the mask bytes, padded on the host), or once a block
// where it is fixed per row.
// - dq (launched first: it writes delta): a block owns 128 queries of one
//   (R row, head); q and do arrive once; each consumer sums delta for its 64
//   rows from o and do (device memory, 16-byte loads), then per 64-key tile
//   (k, v, the bias tile [128 queries x 64 keys] and the mask bytes in the
//   stage) computes s = q k^T and dp = do v^T (SS m64n64k16, both K-major),
//   p from s with the bias and mask terms, ds = p (dp - delta) in
//   registers, and dq += ds k (RS m64nDk16, ds rounded to T as its A
//   operand, k read MN-major).  At D = 32 each tile's dq product is issued
//   behind the next tile's s and dp and runs beside its p (the first tile
//   peeled off the loop, so that no wgmma sits on a branch).
// - dk/dv: a block owns 128 keys of one (R row, head); k and v arrive once
//   and the mask term of each lane's two keys is read once; per 64-query
//   tile (q, do, the bias tile [64 queries x 128 keys], and lse and delta
//   stored by the producer's lanes) it computes s^T = k q^T and dp^T = v
//   do^T (SS), p^T and ds^T in registers, then dv += p^T do and dk += ds^T
//   q (RS, do and q read MN-major).  The accumulator's rows are keys but
//   the bias plane is [query, key], and TMA does not transpose: each lane
//   reads its entries out of the staged [query x key] box transposed, with
//   ldmatrix.trans in 16 bits (four 8 x 8 matrices a load, each row a
//   swizzled 16-byte chunk: no bank conflicts) and one 32-bit load a value
//   in fp32 (the swizzle puts a warp's 32 loads in 32 banks).  At D = 128
//   two blocks share each 128 keys, each keeping 64 columns of dk and dv.
// - dbias: a block owns a [128 queries x 64 keys] tile of one (batch
//   element, head) bias plane and reads its bias words once, into shared
//   memory (each thread's in a column of its own); then for each of the r
//   MSA rows the ring streams q, do (128 rows), k, v (64 rows) and the mask
//   bytes, each consumer loads its rows' lse and delta, computes s and dp
//   on wgmma and adds ds to fp32 registers; it writes its tile once.  The
//   grid walks the tiles of one plane fastest, so the ~130 blocks in flight
//   at once are one plane's, each at about the same row t, so that the
//   operands of row t (256 KB at d 32) come from device memory once and
//   from L2 to the others.  Estimates, not measured (no profiler on the
//   card reports DRAM bytes): the whole grid streams ~3 GB through L2
//   against ~0.27 GB of operands.
// A warpgroup with no rows of its own (past s) walks the ring without
// computing; TMA zero-fills rows past s, whose lse is +inf (p = 0), and
// keys past s take the mask term -inf.
//
// What bit, and what the design does about it (NVIDIA H100 80GB HBM3 at
// 700 W, the main shape; apex_tpu_torch/tools/pair_bias_bwd_variants.py
// builds the rejected designs beside this source, PERF.md keeps their
// times):
// - Registers: a consumer has 168 (nine warps, three on one of the SM's
//   four register partitions); past that ptxas spills, or serializes every
//   wgmma of the kernel (its C7512 note).  Reading a tile's 32 bias words
//   ahead, while the products run, kept them live beside s and dp: dq and
//   dk/dv ran 15% and 24% slower than reading them group by group as p
//   needs them.  dbias keeps its 32 words in shared memory, since beside
//   its 32-register sum and s and dp they spilled.  At D = 128 dk and dv
//   alone take 128 registers: one block a 128-key tile spilled and ran
//   serialized at twice the time of the two blocks that split d.
// - Latency of each tile's chain (s, dp, p, ds, the dq product): the dq
//   product run behind the next tile's products is ~6% faster than waiting
//   on it within the tile; a ring of 2 stages ran dq ~50% slower, 4 within
//   2% of 3.  Two dbias blocks an SM (at most 112 registers) spilled
//   and ran ~50% slower.
// - Bank conflicts of the transposed bias reads: none by the swizzle; 32
//   16-bit loads a tile in place of four ldmatrix.trans ran dk/dv ~4%
//   slower.
// - L2 traffic of dbias: with the planes fastest in the grid (one tile of
//   many planes in flight) it ran ~1% slower at d 32 (a row's operands
//   for all 8 heads are 2 MB, which L2 holds either way) and ~17% slower
//   at d 128 (8 MB).
// - Handing a stage back: a wgmma's completion shows only that every warp
//   issued it, and dbias reads each row's mask bytes after issuing the
//   row's s and dp, so each of its warps hands the stage back itself once
//   past those reads (8 arrivals a stage): ~1% slower than the racy
//   release by thread 0 after dp at d 32, no slower at d 128.  A bar.sync
//   of the warpgroup before thread 0's release ran ~1% slower than this at
//   d 32; releasing row t's stage once row t + 1's s completes (as dq does
//   with its product behind) leaves the 2 stages of d 128 nothing to load
//   ahead (~21% slower there).
// fp32 inputs take CUDA-core kernels in full fp32: one warp a row, 32
// columns a step.
//
// C interface (loaded with ctypes): apex_pair_bias_attention_dq, _dkv and
// _dbias take the argument list of pair_bias.cuh and, for bf16 and fp16,
// the geometry of six maps (ops/pair_bias_attention.py's _tma_maps: q, k,
// v, do, the bias and the mask bytes); each returns cudaGetLastError()
// after the launch, 0 on success, and cudaErrorInvalidValue for a shape it
// does not take or a map that is not the kernel's or that the encoder
// refuses.  dq runs first: it writes delta.

#include "pair_bias.cuh"

namespace {

constexpr int kConsumers = 2;                        // warpgroups, warps 0-7
constexpr int kBwdThreads = kConsumers * 128 + 32;   // and one producer warp

// streamed tiles in flight: 3, or 2 at D = 128, whose stages are twice as
// large (d 128 with an fp32 bias fits no third)
__host__ __device__ constexpr int bwd_stages(int D) { return D == 128 ? 2 : 3; }

// whether dq issues each tile's dq product behind the next tile's s and dp
// (ptxas, bf16, tools/pair_bias_bwd_variants.py on an H100 at 700 W: at
// D = 32, 154 registers against 123 unpipelined and ~6% faster; at D = 64,
// 168 against 139, no spills, and ~3% slower; at D = 128 it spills and
// serializes every wgmma, 0.77 ms against 0.47 at R 32)
template <int D> constexpr bool kDqPipelined = D <= 32;
// the blocks dk/dv splits d over: at D = 128, dk and dv (128 registers a
// thread) beside s^T and dp^T outgrow the registers (ptxas spilled and ran
// every wgmma one at a time), so each of two blocks keeps 64 columns of
// them and computes s^T, dp^T and p^T itself
template <int D> constexpr int kDkvSplit = D == 128 ? 2 : 1;

// the bias boxes a dq or dk/dv stage holds: 128 rows (dq: queries) or 128
// columns (dk/dv: keys) of 128-byte boxes, 0 where the bias is not staged
inline int stage_bias_boxes(const Params& p) {
  return p.staged ? 2 * (p.bias_dtype == kF32 ? 2 : 1) : 0;
}

// Shared memory, each from a 1024-byte boundary (the swizzle's period).
// dq: the q and do tiles [64, D] of the two warpgroups (loaded once), the
// ring (the k tile, the v tile, then the bias boxes [64 queries x 128 bytes],
// two a warpgroup in fp32), the stages' mask boxes, the block's delta
// [128] fp32, the barriers.
template <int D>
struct DqSmem {
  static constexpr int S = bwd_stages(D);
  static constexpr int kTile = FlashTile<D>::bytes(kWgRows);
  int bias_boxes;
  __host__ __device__ constexpr int q(int c) const { return c * kTile; }
  __host__ __device__ constexpr int dout(int c) const { return (2 + c) * kTile; }
  __host__ __device__ constexpr int stage() const { return 2 * kTile + bias_boxes * kBiasBox; }
  __host__ __device__ constexpr int k(int st) const { return 4 * kTile + st * stage(); }
  __host__ __device__ constexpr int v(int st) const { return k(st) + kTile; }
  __host__ __device__ constexpr int bias(int st) const { return k(st) + 2 * kTile; }
  __host__ __device__ constexpr int mask(int st) const { return k(S) + st * kMaskBox; }
  __host__ __device__ constexpr int delta() const { return mask(S); }
  __host__ __device__ constexpr int bars() const { return delta() + kBlockQueries * 4; }
  __host__ __device__ constexpr int bytes() const {
    return 1024 + bars() + FlashRing<S>::kBytes;
  }
};

// dk/dv: the k and v tiles of the two warpgroups (once), the ring (the q
// tile, the do tile, then the bias boxes [64 queries x 128 bytes] of the
// block's 128 keys: one box a warpgroup in 16 bits, two in fp32), the
// stages' lse (log2 units) and delta [64] fp32 each, the barriers.
template <int D>
struct DkvSmem {
  static constexpr int S = bwd_stages(D);
  static constexpr int kTile = FlashTile<D>::bytes(kWgRows);
  int bias_boxes;
  __host__ __device__ constexpr int k(int c) const { return c * kTile; }
  __host__ __device__ constexpr int v(int c) const { return (2 + c) * kTile; }
  __host__ __device__ constexpr int stage() const { return 2 * kTile + bias_boxes * kBiasBox; }
  __host__ __device__ constexpr int q(int st) const { return 4 * kTile + st * stage(); }
  __host__ __device__ constexpr int dout(int st) const { return q(st) + kTile; }
  __host__ __device__ constexpr int bias(int st) const { return q(st) + 2 * kTile; }
  __host__ __device__ constexpr int vecs(int st) const { return q(S) + st * 2 * kKeys * 4; }
  __host__ __device__ constexpr int bars() const { return vecs(S); }
  __host__ __device__ constexpr int bytes() const {
    return 1024 + bars() + FlashRing<S>::kBytes;
  }
};

// dbias: the ring (the q and do tiles of the two warpgroups' queries, the k
// and v tiles of the block's keys), the stages' mask boxes, the block's bias
// words (32 a consumer thread, word i of thread x at [i][x]: its own column,
// free of bank conflicts), the barriers.
template <int D>
struct DbiasSmem {
  static constexpr int S = bwd_stages(D);
  static constexpr int kTile = FlashTile<D>::bytes(kWgRows);
  __host__ __device__ static constexpr int stage() { return 6 * kTile; }
  __host__ __device__ static constexpr int q(int st, int c) { return st * stage() + c * kTile; }
  __host__ __device__ static constexpr int dout(int st, int c) {
    return st * stage() + (2 + c) * kTile;
  }
  __host__ __device__ static constexpr int k(int st) { return st * stage() + 4 * kTile; }
  __host__ __device__ static constexpr int v(int st) { return k(st) + kTile; }
  __host__ __device__ static constexpr int mask(int st) { return S * stage() + st * kMaskBox; }
  __host__ __device__ static constexpr int words() { return mask(S); }
  __host__ __device__ static constexpr int bars() { return words() + 32 * kConsumers * 128 * 4; }
  __host__ __device__ static constexpr int bytes() {
    return 1024 + bars() + FlashRing<S>::kBytes;
  }
};

// the most each takes, whatever s: d 64 and 128 with an fp32 bias
static_assert(DqSmem<128>{4}.bytes() <= kSmemMax && DqSmem<64>{4}.bytes() <= kSmemMax,
              "the dq ring does not fit");
static_assert(DkvSmem<128>{4}.bytes() <= kSmemMax && DkvSmem<64>{4}.bytes() <= kSmemMax,
              "the dk/dv ring does not fit");
static_assert(DbiasSmem<128>::bytes() <= kSmemMax && DbiasSmem<64>::bytes() <= kSmemMax,
              "the dbias ring does not fit");

// a place in a ring of S stages: the stage and the parity of its fill
template <int S>
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
};

// a warpgroup with no rows of its own hands each of n stages back as it
// fills (with `arrivals`, its share of the stage's releases), so that the
// producer's ring keeps turning
template <int S>
__device__ __forceinline__ void walk_ring(const FlashRing<S>& ring, int n, int t,
                                          int arrivals = 1) {
  RingPos<S> pos;
  for (int j = 0; j < n; ++j) {
    mbar_wait(ring.full(pos.s), pos.phase);
    if (t == 0)
      for (int a = 0; a < arrivals; ++a) mbar_arrive(ring.empty(pos.s));
    pos.advance();
  }
}

// two(i, b0, b1) for each pair of this lane's 32 entries (i even), b0 and
// b1 their bias values in fp32 from the words that words(m, w) gives, group
// m (entries 8 m ... 8 m + 7) at a time as bias_group_* give them; each
// dtype's loop is free of branches
template <typename Words, typename Two>
__device__ __forceinline__ void each_bias_pair(Words words, int bias_dtype, Two two) {
  if (bias_dtype == kF32) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t w[8];
      words(m, w);
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        two(8 * m + j, __uint_as_float(w[j]), __uint_as_float(w[j + 1]));
    }
  } else {
    const bool bf = bias_dtype == kBF16;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t w[8];
      words(m, w);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float2 b = pair_f32(w[j], bf);
        two(8 * m + j, b.x, b.y);
      }
    }
  }
}

// p = 2^(s scale log2e + bias log2e + mask term - lse) of this lane's 32
// entries of a [64 queries x 64 keys] score tile, in place: rows row_a (i &
// 2 clear; lse_a) and row_a + 8 (lse_b), in log2 units; the bias from
// words (each_bias_pair); the mask term from the stage's 64 mask bytes
// `mb` (a key's byte 0, or past s: -inf, whose 2^x is 0)
template <typename Words>
__device__ __forceinline__ void probs_cols(float (&sc)[32], Words words, int bias_dtype,
                                           const unsigned char* mb, int tig, float scale_log2,
                                           float lse_a, float lse_b) {
  each_bias_pair(words, bias_dtype, [&](int i, float b0, float b1) {
    const uint32_t m2 = *reinterpret_cast<const uint16_t*>(mb + (i >> 2) * 8 + 2 * tig);
    const float t0 = m2 & 0xffu ? 0.f : -CUDART_INF_F;
    const float t1 = m2 & 0xff00u ? 0.f : -CUDART_INF_F;
    const float l = (i & 2) ? lse_b : lse_a;
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, fmaf(b0, kLog2e, t0)) - l);
    sc[i + 1] = fast_exp2(fmaf(sc[i + 1], scale_log2, fmaf(b1, kLog2e, t1)) - l);
  });
}

// the same for a [64 keys x 64 queries] s^T tile: the mask term a row's
// (term_a, term_b: fixed per key), lse a column's (the stage's `lse`, the
// tile's 64 queries)
template <typename Words>
__device__ __forceinline__ void probs_rows(float (&sc)[32], Words words, int bias_dtype,
                                           float term_a, float term_b, const float* lse, int tig,
                                           float scale_log2) {
  each_bias_pair(words, bias_dtype, [&](int i, float b0, float b1) {
    const float2 l = *reinterpret_cast<const float2*>(lse + (i >> 2) * 8 + 2 * tig);
    const float tm = (i & 2) ? term_b : term_a;
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, fmaf(b0, kLog2e, tm)) - l.x);
    sc[i + 1] = fast_exp2(fmaf(sc[i + 1], scale_log2, fmaf(b1, kLog2e, tm)) - l.y);
  });
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Group m of the bias words of this lane's 32 entries of an s^T tile (rows:
// the warpgroup's keys warp * 16 + g (+ 8); columns: the tile's queries 8 n
// + 2 tig + e, n = 2 m, 2 m + 1) from the staged boxes that hold the
// warpgroup's 64 keys (`box`, shared address; `gbox`, the same as a
// pointer): [64 queries x 128 bytes], 128-byte swizzled, read transposed.
// 16 bits: one ldmatrix.trans of four 8 x 8 matrices (matrix (n, half):
// queries 8 n ..., keys 16 warp + 8 half ..., one swizzled 16-byte chunk a
// row), word 4 n + 2 half holding the pair (e = 0, 1) as bias_group_smem's;
// fp32: two boxes of 32 keys, one word a value.
__device__ __forceinline__ void bias_group_smem_t(uint32_t (&w)[8], uint32_t box,
                                                  const unsigned char* gbox, bool f32, int warp,
                                                  int lane, int m) {
  const int g = lane >> 2, tig = lane & 3;
  if (f32) {
    const unsigned char* b = gbox + (warp >> 1) * kBiasBox;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int chunk = (warp & 1) * 4 + 2 * half + (g >> 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * (2 * m + nn) + 2 * tig + e;
          w[4 * nn + 2 * half + e] = *reinterpret_cast<const uint32_t*>(
              b + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * (g & 3));
        }
      }
  } else {
    const int mi = lane >> 3, rr = lane & 7;
    const int n = 2 * m + (mi >> 1), half = mi & 1;
    uint32_t r[4];
    ldsm_x4_trans(r, box + (8 * n + rr) * 128 + (((2 * warp + half) ^ rr) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * (j >> 1) + 2 * (j & 1)] = r[j];
  }
}

// The same words from device memory, where the bias is not staged:
// queries q0 + 8 n + 2 tig + e, keys key_a (+ 8); zero past s
__device__ __forceinline__ void bias_group_global_t(uint32_t (&w)[8], const Params& p,
                                                    const unsigned char* bb, int q0, int key_a,
                                                    int tig, int m) {
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_a + 8 * half;
      uint32_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int query = q0 + 8 * (2 * m + nn) + 2 * tig + e;
        const int64_t i = (int64_t)query * p.s + key;
        const bool in = query < p.s && key < p.s;
        v[e] = !in                        ? 0u
               : p.bias_dtype == kF32 ? reinterpret_cast<const uint32_t*>(bb)[i]
                                      : reinterpret_cast<const uint16_t*>(bb)[i];
      }
      if (p.bias_dtype == kF32) {
        w[4 * nn + 2 * half] = v[0];
        w[4 * nn + 2 * half + 1] = v[1];
      } else {
        w[4 * nn + 2 * half] = v[0] | (v[1] << 16);
      }
    }
}

// rows row_a and row_a + 8 of a [64, N] fp32 accumulator, times `mul`,
// stored as T at base + row * rs from column col0 on, columns < d only,
// rows < s only
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* base, int64_t rs, int row_a, const Params& p,
                                           const float (&acc)[N / 2], float mul, int tig,
                                           int col0 = 0) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (col0 + n * 8 >= p.d) break;
    const int col = col0 + n * 8 + tig * 2;
    if (row_a < p.s)
      *reinterpret_cast<uint32_t*>(base + (int64_t)row_a * rs + col) =
          pack2<T>(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (row_a + 8 < p.s)
      *reinterpret_cast<uint32_t*>(base + (int64_t)(row_a + 8) * rs + col) =
          pack2<T>(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
pair_bias_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_m, const Params p,
                   const DqSmem<D> L) {
  constexpr int S = DqSmem<D>::S;
  extern __shared__ unsigned char pb_smem[];
  const uint32_t base = (smem_u32(pb_smem) + 1023) & ~1023u;
  unsigned char* const gbase = pb_smem + (base - smem_u32(pb_smem));
  const FlashRing<S> ring{base + L.bars()};
  init_ring(ring);

  // x the query tile, y the head, z the R row (the forward's order: the
  // blocks in flight read a few R rows' k and v and the heads' bias planes)
  const int head = blockIdx.y, Rc = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQueries;
  const int n_tiles = (p.s + kKeys - 1) / kKeys;
  const bool f32_bias = p.bias_dtype == kF32;
  const int col_boxes = f32_bias ? 2 : 1;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    const int lane = threadIdx.x % 32;
    const int bias_batch = Rc % p.nb;
    if (lane == 0) {
      mbar_expect_tx(ring.once(), 4 * DqSmem<D>::kTile);
      for (int c = 0; c < kConsumers; ++c) {
        tma_load_tile<D>(base + L.q(c), &map_q, q0 + c * kWgRows, head, Rc, kWgRows,
                         ring.once());
        tma_load_tile<D>(base + L.dout(c), &map_do, q0 + c * kWgRows, head, Rc, kWgRows,
                         ring.once());
      }
    }
    RingPos<S> pos;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = pos.s;
      if (j >= S) mbar_wait(ring.empty(st), pos.phase ^ 1);
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
      pos.advance();
    }
    return;
  }

  const int c = wg;                                // queries q0 + 64 c ... of the block
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0c = q0 + c * kWgRows;
  const int64_t gq = (int64_t)Rc * p.h + head;     // the (R row, head)'s lse and delta
  float* const dl_s = reinterpret_cast<float*>(gbase + L.delta());

  // delta = rowsum(do * o) for the warpgroup's rows, two threads a row, 8
  // columns a load, while the producer's first loads are in flight
  {
    const int r = t >> 1, half = t & 1, row = q0c + r;
    float acc = 0.f;
    if (row < p.s) {
      const T* orow = static_cast<const T*>(p.o) + Rc * p.st[kO][0] + head * p.st[kO][1] +
                      (int64_t)row * p.st[kO][2];
      const T* drow = static_cast<const T*>(p.dout) + Rc * p.st[kDO][0] +
                      head * p.st[kDO][1] + (int64_t)row * p.st[kDO][2];
      for (int c8 = half * 8; c8 < p.d; c8 += 16) {
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
      if (row < p.s) p.delta[gq * p.s + row] = acc;
    }
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
  if (q0c >= p.s) {
    walk_ring(ring, n_tiles, t);
    return;
  }

  // this thread's two rows of the accumulators: element i lies at row
  // row_a (i & 2 clear) or row_a + 8, column 8 (i / 4) + 2 tig + (i & 1)
  const int row_a = q0c + warp * 16 + g, row_b = row_a + 8;
  const float delta_a = dl_s[c * kWgRows + warp * 16 + g];
  const float delta_b = dl_s[c * kWgRows + warp * 16 + g + 8];
  const float* lrow = p.lse + gq * p.s;
  // lse in log2 units; a row past s gets +inf, so its p is 0
  const float lse_a = row_a < p.s ? lrow[row_a] * kLog2e : CUDART_INF_F;
  const float lse_b = row_b < p.s ? lrow[row_b] * kLog2e : CUDART_INF_F;
  const float scale_log2 = p.scale * kLog2e;
  const unsigned char* bb = bias_base(p, Rc, head);
  const uint32_t q_s = base + L.q(c), do_s = base + L.dout(c);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t a[4][4];     // a tile's ds, rounded to T: the A operand of dq += ds k
  // dq += ds k, k the stage's tile read MN-major
  auto issue_dq = [&](int st) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<T, D>(dq, a[kc], desc_mnmajor<D>(base + L.k(st), kKeys, kc));
    wgmma_commit();
  };
  // Tile j in stage st: s = q k^T and dp = do v^T, p, and ds = p (dp -
  // delta) into `a`.  Behind (pipelined, from the second tile on) the
  // previous tile's dq product, from stage `prev`, is issued after s and dp
  // and runs beside this tile's p; it completes, and hands `prev` back,
  // before `a` takes this tile's ds.
  auto tile_ds = [&](int j, int st, uint32_t phase, int prev, auto behind) {
    constexpr bool kBehind = decltype(behind)::value;
    const unsigned char* tile = gbase + L.bias(st) + c * col_boxes * kBiasBox;
    mbar_wait(ring.full(st), phase);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64<T>(sc, desc_kmajor<D>(q_s, kWgRows, 0, kk),
                         desc_kmajor<D>(base + L.k(st), kKeys, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64<T>(dp, desc_kmajor<D>(do_s, kWgRows, 0, kk),
                         desc_kmajor<D>(base + L.v(st), kKeys, 0, kk), kk > 0);
    wgmma_commit();
    if constexpr (kBehind) issue_dq(prev);
    wgmma_wait<kBehind ? 2 : 1>();                 // s
    fence_regs(sc);
    auto probs = [&](auto words) {
      probs_cols(sc, words, p.bias_dtype, gbase + L.mask(st), tig, scale_log2, lse_a, lse_b);
    };
    // the bias words group by group as p needs them (each dtype's and
    // source's loop free of branches): read all 32 ahead, while s and dp
    // ran, held them live beside s and dp, and the consumer took 1.09 ms
    // against 0.95 at the main shape (tools/pair_bias_bwd_variants.py)
    if (p.staged) {
      probs([&](int m, uint32_t (&w)[8]) { bias_group_smem(w, tile, f32_bias, warp, g, tig, m); });
    } else {
      probs([&](int m, uint32_t (&w)[8]) {
        bias_group_global(w, p, bb, row_a, j * kKeys, tig, m);
      });
    }
    wgmma_wait<kBehind ? 1 : 0>();                 // dp
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - ((i & 2) ? delta_b : delta_a);   // ds
    if constexpr (kBehind) {
      wgmma_wait<0>();                             // the previous tile's dq product
      fence_regs(dq);
      if (t == 0) mbar_arrive(ring.empty(prev));
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a<T>(a[kc], sc, kc);
  };
  mbar_wait(ring.once(), 0);
  RingPos<S> pos;
  if constexpr (kDqPipelined<D>) {
    // the first tile peeled off the loop: no wgmma sits on a branch (ptxas
    // serializes them all otherwise, its C7518 note)
    tile_ds(0, pos.s, pos.phase, 0, std::false_type{});
    int prev = pos.s;
    pos.advance();
    for (int j = 1; j < n_tiles; ++j) {
      tile_ds(j, pos.s, pos.phase, prev, std::true_type{});
      prev = pos.s;
      pos.advance();
    }
    fence_regs(dq);
    wgmma_fence();
    issue_dq(prev);                                // the last tile's
    wgmma_wait<0>();
    fence_regs(dq);
    if (t == 0) mbar_arrive(ring.empty(prev));
  } else {
    for (int j = 0; j < n_tiles; ++j) {
      tile_ds(j, pos.s, pos.phase, 0, std::false_type{});
      fence_regs(dq);
      wgmma_fence();
      issue_dq(pos.s);
      wgmma_wait<0>();
      fence_regs(dq);
      if (t == 0) mbar_arrive(ring.empty(pos.s));
      pos.advance();
    }
  }
  T* dqb = static_cast<T*>(p.dq) + Rc * p.st[kDQ][0] + head * p.st[kDQ][1];
  store_rows<T, D>(dqb, p.st[kDQ][2], row_a, p, dq, p.scale, tig);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
pair_bias_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_b, const Params p,
                    const DkvSmem<D> L) {
  constexpr int S = DkvSmem<D>::S;
  extern __shared__ unsigned char pb_smem[];
  const uint32_t base = (smem_u32(pb_smem) + 1023) & ~1023u;
  unsigned char* const gbase = pb_smem + (base - smem_u32(pb_smem));
  const FlashRing<S> ring{base + L.bars()};
  init_ring(ring);

  // x the key tile (and, split, the half of d, fastest), y the head, z the
  // R row
  constexpr int kN = D / kDkvSplit<D>;             // columns of dk and dv
  const int head = blockIdx.y, Rc = blockIdx.z;
  const int dh = blockIdx.x % kDkvSplit<D>;
  const int k0 = blockIdx.x / kDkvSplit<D> * kBlockQueries;
  const int n_qt = (p.s + kKeys - 1) / kKeys;
  const int64_t gq = (int64_t)Rc * p.h + head;
  const bool f32_bias = p.bias_dtype == kF32;
  const int col_boxes = f32_bias ? 2 : 1;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    const int lane = threadIdx.x % 32;
    const int bias_batch = Rc % p.nb;
    if (lane == 0) {
      mbar_expect_tx(ring.once(), 4 * DkvSmem<D>::kTile);
      for (int c = 0; c < kConsumers; ++c) {
        tma_load_tile<D>(base + L.k(c), &map_k, k0 + c * kWgRows, head, Rc, kWgRows,
                         ring.once());
        tma_load_tile<D>(base + L.v(c), &map_v, k0 + c * kWgRows, head, Rc, kWgRows,
                         ring.once());
      }
    }
    RingPos<S> pos;
    for (int it = 0; it < n_qt; ++it) {
      const int st = pos.s, i0 = it * kKeys;
      if (it >= S) mbar_wait(ring.empty(st), pos.phase ^ 1);
      float* ls = reinterpret_cast<float*>(gbase + L.vecs(st));
      for (int r = lane; r < kKeys; r += 32) {
        const int row = i0 + r;
        const bool in = row < p.s;
        ls[r] = in ? p.lse[gq * p.s + row] * kLog2e : CUDART_INF_F;
        ls[kKeys + r] = in ? p.delta[gq * p.s + row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(ring.full(st), L.stage());
        tma_load_tile<D>(base + L.q(st), &map_q, i0, head, Rc, kKeys, ring.full(st));
        tma_load_tile<D>(base + L.dout(st), &map_do, i0, head, Rc, kKeys, ring.full(st));
        if (L.bias_boxes)
          for (int c = 0; c < kConsumers; ++c)
            for (int cb = 0; cb < col_boxes; ++cb)
              tma_load_4d(base + L.bias(st) + (c * col_boxes + cb) * kBiasBox, &map_b,
                          k0 + c * kWgRows + cb * 32, i0, head, bias_batch, ring.full(st));
      } else {
        mbar_arrive(ring.full(st));
      }
      pos.advance();
    }
    return;
  }

  const int c = wg;                                // keys k0 + 64 c ... of the block
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0c = k0 + c * kWgRows;
  if (k0c >= p.s) {
    walk_ring(ring, n_qt, t);
    return;
  }
  // this thread's two keys (the accumulators' rows) and their mask terms:
  // 0 where the key is valid, -inf where it is masked or past s
  const int key_a = k0c + warp * 16 + g, key_b = key_a + 8;
  const uint8_t* mrow = p.mask + Rc * p.mask_ld;
  const float term_a = key_a < p.s && mrow[key_a] ? 0.f : -CUDART_INF_F;
  const float term_b = key_b < p.s && mrow[key_b] ? 0.f : -CUDART_INF_F;
  const float scale_log2 = p.scale * kLog2e;
  const unsigned char* bb = bias_base(p, Rc, head);
  const uint32_t k_s = base + L.k(c), v_s = base + L.v(c);

  float dk[kN / 2], dv[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dk[i] = dv[i] = 0.f;
  // this block's columns of the stage's do and q tiles: at D = 128 box dh
  // of the two [64 rows x 64 columns] boxes side by side
  const uint32_t cols = dh * kKeys * FlashTile<D>::kRowBytes;
  mbar_wait(ring.once(), 0);
  RingPos<S> pos;
  for (int it = 0; it < n_qt; ++it) {
    const int st = pos.s;
    const uint32_t box = base + L.bias(st) + c * col_boxes * kBiasBox;
    mbar_wait(ring.full(st), pos.phase);
    // s^T = k q^T and dp^T = v do^T (keys x queries), both operands K-major
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64<T>(sc, desc_kmajor<D>(k_s, kWgRows, 0, kk),
                         desc_kmajor<D>(base + L.q(st), kKeys, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64<T>(dp, desc_kmajor<D>(v_s, kWgRows, 0, kk),
                         desc_kmajor<D>(base + L.dout(st), kKeys, 0, kk), kk > 0);
    wgmma_commit();
    const float* ls = reinterpret_cast<const float*>(gbase + L.vecs(st));
    wgmma_wait<1>();                               // s^T
    fence_regs(sc);
    auto probs = [&](auto words) {
      probs_rows(sc, words, p.bias_dtype, term_a, term_b, ls, tig, scale_log2);
    };
    // the bias words group by group as p^T needs them: read all 32 ahead,
    // while s^T and dp^T ran (as the forward does), the consumer held 168
    // registers and took 1.30 ms against 1.05 at the main shape (tools/
    // pair_bias_bwd_variants.py)
    if (p.staged) {
      probs([&](int m, uint32_t (&w)[8]) {
        bias_group_smem_t(w, box, gbase + (box - base), f32_bias, warp, lane, m);
      });
    } else {
      probs([&](int m, uint32_t (&w)[8]) {
        bias_group_global_t(w, p, bb, it * kKeys, key_a, tig, m);
      });
    }
    wgmma_wait<0>();                               // dp^T
    fence_regs(dp);
    // ds^T = p^T (dp^T - delta); then both A operands, p^T and ds^T,
    // rounded to T: s^T and dp^T are dead before the products are issued,
    // and the products complete within the tile
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 dl = *reinterpret_cast<const float2*>(ls + kKeys + (i >> 2) * 8 + 2 * tig);
      dp[i] = sc[i] * (dp[i] - dl.x);
      dp[i + 1] = sc[i + 1] * (dp[i + 1] - dl.y);
    }
    uint32_t ap[4][4], ad[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      acc_to_a<T>(ap[kc], sc, kc);
      acc_to_a<T>(ad[kc], dp, kc);
    }
    // dv += p^T do and dk += ds^T q, do and q the stage's tiles read MN-major
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<T, kN>(dv, ap[kc], desc_mnmajor<D>(base + L.dout(st) + cols, kKeys, kc));
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<T, kN>(dk, ad[kc], desc_mnmajor<D>(base + L.q(st) + cols, kKeys, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (t == 0) mbar_arrive(ring.empty(st));
    pos.advance();
  }
  T* dkb = static_cast<T*>(p.dk) + Rc * p.st[kDK][0] + head * p.st[kDK][1];
  T* dvb = static_cast<T*>(p.dv) + Rc * p.st[kDV][0] + head * p.st[kDV][1];
  store_rows<T, kN>(dkb, p.st[kDK][2], key_a, p, dk, p.scale, tig, dh * kN);
  store_rows<T, kN>(dvb, p.st[kDV][2], key_a, p, dv, 1.f, tig, dh * kN);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
pair_bias_dbias_wgmma(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_m, const Params p) {
  using L = DbiasSmem<D>;
  constexpr int S = L::S;
  extern __shared__ unsigned char pb_smem[];
  const uint32_t base = (smem_u32(pb_smem) + 1023) & ~1023u;
  unsigned char* const gbase = pb_smem + (base - smem_u32(pb_smem));
  const FlashRing<S> ring{base + L::bars()};
  init_ring(ring, kConsumers * 4);                 // each consumer warp releases

  // x the tile of the plane, key tiles fastest; y the plane (bi * h +
  // head): the blocks in flight at once are one plane's, walking t in step
  const int n_kt = (p.s + kKeys - 1) / kKeys;
  const int k0 = (blockIdx.x % n_kt) * kKeys, q0 = (blockIdx.x / n_kt) * kBlockQueries;
  const int gb = blockIdx.y;
  const int bi = gb / p.h, head = gb % p.h;
  const int r = p.R / p.nb;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // MSA row t's q, do, k and v tiles and the mask bytes of its keys
    const int lane = threadIdx.x % 32;
    RingPos<S> pos;
    for (int t = 0; t < r; ++t) {
      const int st = pos.s, R_idx = t * p.nb + bi;
      if (t >= S) mbar_wait(ring.empty(st), pos.phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(ring.full(st), L::stage() + kKeys);
        for (int c = 0; c < kConsumers; ++c) {
          tma_load_tile<D>(base + L::q(st, c), &map_q, q0 + c * kWgRows, head, R_idx, kWgRows,
                           ring.full(st));
          tma_load_tile<D>(base + L::dout(st, c), &map_do, q0 + c * kWgRows, head, R_idx,
                           kWgRows, ring.full(st));
        }
        tma_load_tile<D>(base + L::k(st), &map_k, k0, head, R_idx, kKeys, ring.full(st));
        tma_load_tile<D>(base + L::v(st), &map_v, k0, head, R_idx, kKeys, ring.full(st));
        tma_load_4d(base + L::mask(st), &map_m, k0, R_idx, 0, 0, ring.full(st));
      } else {
        mbar_arrive(ring.full(st));
      }
      pos.advance();
    }
    return;
  }

  const int c = wg;
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0c = q0 + c * kWgRows;
  if (q0c >= p.s) {
    walk_ring(ring, r, t, 4);
    return;
  }
  const int row_a = q0c + warp * 16 + g, row_b = row_a + 8;
  const int esize = p.bias_dtype == kF32 ? 4 : 2;
  // the block's bias words, read once for all r rows (the mask applies
  // per row) and kept in shared memory, each thread's in its own column:
  // beside the sum's 32 registers and s's and dp's 64, 32 more would spill
  const unsigned char* bb = static_cast<const unsigned char*>(p.bias) +
                            (int64_t)gb * p.s * p.s * esize;
  uint32_t* const words_s = reinterpret_cast<uint32_t*>(gbase + L::words()) + threadIdx.x;
  {
    uint32_t bw[32];
    bias_words_global(bw, p, bb, row_a, k0, tig);
#pragma unroll
    for (int i = 0; i < 32; ++i) words_s[i * kConsumers * 128] = bw[i];
  }
  auto words = [&](int m, uint32_t (&w)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = words_s[(8 * m + i) * kConsumers * 128];
  };
  const float scale_log2 = p.scale * kLog2e;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  RingPos<S> pos;
  for (int tt = 0; tt < r; ++tt) {
    const int st = pos.s;
    // row tt's lse (log2 units; a row past s +inf, so its p is 0) and
    // delta, loaded before the stage's wait
    const float* lrow = p.lse + ((int64_t)(tt * p.nb + bi) * p.h + head) * p.s;
    const float* drow = p.delta + ((int64_t)(tt * p.nb + bi) * p.h + head) * p.s;
    const float lse_a = row_a < p.s ? lrow[row_a] * kLog2e : CUDART_INF_F;
    const float lse_b = row_b < p.s ? lrow[row_b] * kLog2e : CUDART_INF_F;
    const float dl_a = row_a < p.s ? drow[row_a] : 0.f;
    const float dl_b = row_b < p.s ? drow[row_b] : 0.f;
    mbar_wait(ring.full(st), pos.phase);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64<T>(sc, desc_kmajor<D>(base + L::q(st, c), kWgRows, 0, kk),
                         desc_kmajor<D>(base + L::k(st), kKeys, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64<T>(dp, desc_kmajor<D>(base + L::dout(st, c), kWgRows, 0, kk),
                         desc_kmajor<D>(base + L::v(st), kKeys, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                               // s
    fence_regs(sc);
    probs_cols(sc, words, p.bias_dtype, gbase + L::mask(st), tig, scale_log2, lse_a, lse_b);
    wgmma_wait<0>();                               // dp
    fence_regs(dp);
    // each warp hands the stage back itself, once past its own reads of
    // the stage's mask bytes: dp's completion shows only that every warp
    // issued it, which they do before those reads
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(st));
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += sc[i] * (dp[i] - ((i & 2) ? dl_b : dl_a));   // ds
    pos.advance();
  }

  unsigned char* db = static_cast<unsigned char*>(p.dbias) + (int64_t)gb * p.s * p.s * esize;
  const bool pairs = (p.s & 1) == 0;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    const int col = k0 + n * 8 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + half * 8;
      if (row >= p.s || col >= p.s) continue;
      const int64_t i = (int64_t)row * p.s + col;
      if (pairs) {
        store_pair(db, i, p.bias_dtype, acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
      } else {
        store_elem(db, i, p.bias_dtype, acc[4 * n + 2 * half]);
        if (col + 1 < p.s) store_elem(db, i + 1, p.bias_dtype, acc[4 * n + 2 * half + 1]);
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

enum Which { kWhichDq, kWhichDkv, kWhichDbias };

// the attribute is per device: set it on every launch, for the current one
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t launch_wgmma(Which w, Params p, int dtype, const long long* maps,
                         cudaStream_t stream) {
  // maps (pair_bias.cuh's encode_maps): q, k, v, do, the bias, the mask bytes
  CUtensorMap m[6];
  if (!encode_maps<D>(m, 6, p, dtype, maps)) return cudaErrorInvalidValue;
  const dim3 rows((p.s + kBlockQueries - 1) / kBlockQueries, p.h, p.R);
  cudaError_t err = cudaSuccess;
  switch (w) {
    case kWhichDq: {
      const DqSmem<D> L{stage_bias_boxes(p)};
      const auto kernel = pair_bias_dq_wgmma<T, D>;
      if ((err = allow_smem(kernel, L.bytes())) != cudaSuccess) return err;
      kernel<<<rows, kBwdThreads, L.bytes(), stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], p, L);
      break;
    }
    case kWhichDkv: {
      const DkvSmem<D> L{stage_bias_boxes(p)};
      const auto kernel = pair_bias_dkv_wgmma<T, D>;
      if ((err = allow_smem(kernel, L.bytes())) != cudaSuccess) return err;
      const dim3 keys(rows.x * kDkvSplit<D>, p.h, p.R);
      kernel<<<keys, kBwdThreads, L.bytes(), stream>>>(m[0], m[1], m[2], m[3], m[4], p, L);
      break;
    }
    case kWhichDbias: {
      const auto kernel = pair_bias_dbias_wgmma<T, D>;
      if ((err = allow_smem(kernel, DbiasSmem<D>::bytes())) != cudaSuccess) return err;
      const int tiles = ((p.s + kKeys - 1) / kKeys) * ((p.s + kBlockQueries - 1) / kBlockQueries);
      kernel<<<dim3(tiles, p.nb * p.h), kBwdThreads, DbiasSmem<D>::bytes(), stream>>>(
          m[0], m[1], m[2], m[3], m[5], p);
      break;
    }
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(Which w, const Params& p, cudaStream_t stream) {
  const int rows = (p.s + kF32Rows - 1) / kF32Rows;
  switch (w) {
    case kWhichDq:
      pair_bias_dq_f32<D><<<dim3(rows, p.R * p.h), kF32Rows * 32, 0, stream>>>(p);
      break;
    case kWhichDkv:
      pair_bias_dkv_f32<D><<<dim3(rows, p.R * p.h), kF32Rows * 32, 0, stream>>>(p);
      break;
    case kWhichDbias:
      pair_bias_dbias_f32<D><<<dim3((p.s + kF32Cols - 1) / kF32Cols, rows, p.nb * p.h),
                               kF32Rows * 32, 0, stream>>>(p);
      break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_d(Which w, const Params& p, int dtype, const long long* maps,
                           cudaStream_t stream) {
  if (p.d <= 32) return launch_wgmma<T, 32>(w, p, dtype, maps, stream);
  if (p.d <= 64) return launch_wgmma<T, 64>(w, p, dtype, maps, stream);
  return launch_wgmma<T, 128>(w, p, dtype, maps, stream);
}

int run(Which w, int dtype, const Params& p, const long long* maps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (p.d <= 32) return (int)launch_f32<32>(w, p, st);
      if (p.d <= 64) return (int)launch_f32<64>(w, p, st);
      return (int)launch_f32<128>(w, p, st);
    case kBF16: return (int)launch_wgmma_d<__nv_bfloat16>(w, p, dtype, maps, st);
    case kF16: return (int)launch_wgmma_d<__half>(w, p, dtype, maps, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The argument list of pair_bias.cuh, then `maps` for bf16 and fp16 (fp32
// ignores it): the geometry of six tensor maps, 12 values each
// (encode_map): q, k, v and do [R, h, s, d] in boxes of 64 rows by the
// padded head dim's box columns, the bias [b, h, s, s] in boxes of 64 rows
// by 128 bytes (read only where its rows are whole 16-byte chunks), and the
// kv mask's bytes [R, s] in boxes of 64 (`mask` then points at them, rows
// 16-byte aligned: the host makes them where there is no mask or its rows
// are not).
extern "C" int apex_pair_bias_attention_dq(PAIR_BIAS_ARGS, const long long* maps) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  return run(kWhichDq, dtype, p, maps, stream);
}

extern "C" int apex_pair_bias_attention_dkv(PAIR_BIAS_ARGS, const long long* maps) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  return run(kWhichDkv, dtype, p, maps, stream);
}

extern "C" int apex_pair_bias_attention_dbias(PAIR_BIAS_ARGS, const long long* maps) {
  Params p;
  if (!PAIR_BIAS_PARAMS(p)) return cudaErrorInvalidValue;
  return run(kWhichDbias, dtype, p, maps, stream);
}
