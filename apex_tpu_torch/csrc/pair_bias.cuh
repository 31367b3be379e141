// What the pair-bias attention kernels (pair_bias_attention_fwd.cu and
// pair_bias_attention_bwd.cu) share: their one argument list, the tile
// loads, the warp-level products, and the bias term of a score tile.
//
// Layout.  q, k, v (and o, do, dq, dk, dv) are [R, h, s, d] with R = r * b
// rows-major: R index t * b + bi is MSA row t of batch element bi, so the
// pair bias [b, h, s, s] of flattened row g = R_idx * h + head is
// bias[R_idx % b, head].  The kv mask is [R, s] bytes (nonzero = attend).
// lse and delta are [R, h, s] fp32.
//
// The bias term.  Every kernel adds, to each score q.k * scale, the term
//   add = bias[row, col]        where key col is valid (col < s, mask set)
//   add = -inf                  elsewhere
// so one fused multiply-add gives the masked score (in log2 units here),
// and exp2 of a masked score is 0 whatever the row's max or lse: no
// -inf - (-inf) ever forms (see the kernels' running max).
// _build.py hashes every .cuh here into each library's name.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// which operand a stride triple (R, head, row) belongs to
enum Operand { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kOperands };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;       // [b, h, s, s] contiguous, bias_dtype
  const uint8_t* mask;    // [R, s] contiguous, or null
  void* o;                // written by the forward, read by dq
  float* lse;             // [R, h, s]
  const void* dout;       // do
  float* delta;           // [R, h, s]: written by dq, read by dk/dv and dbias
  void* dq;
  void* dk;
  void* dv;
  void* dbias;            // [b, h, s, s] contiguous, bias_dtype
  int R, h, s, d, nb;     // nb: the bias's batch b (R % nb == 0)
  int64_t st[kOperands][3];
  float scale;
  int bias_dtype;
  // bias rows are whole 16-byte chunks (s * element size % 16 == 0): the
  // kernels stage bias tiles in shared memory with cp.async; else each
  // lane reads its values from global memory
  bool staged;
};

__device__ __forceinline__ const unsigned char* bias_base(const Params& p, int R_idx, int head) {
  const int64_t plane = (int64_t)((R_idx % p.nb) * p.h + head) * p.s * p.s;
  const int esize = p.bias_dtype == kF32 ? 4 : 2;
  return static_cast<const unsigned char*>(p.bias) + plane * esize;
}

// element i of a tensor of runtime dtype dt, in fp32
__device__ __forceinline__ float load_elem(const unsigned char* base, int64_t i, int dt) {
  if (dt == kF32) return reinterpret_cast<const float*>(base)[i];
  if (dt == kBF16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[i]);
  return __half2float(reinterpret_cast<const __half*>(base)[i]);
}

// elements i and i + 1 (i even, the tensor's start aligned): one load
__device__ __forceinline__ float2 load_pair(const unsigned char* base, int64_t i, int dt) {
  if (dt == kF32) return reinterpret_cast<const float2*>(base)[i >> 1];
  if (dt == kBF16)
    return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(base)[i >> 1]);
  return __half22float2(reinterpret_cast<const __half2*>(base)[i >> 1]);
}

__device__ __forceinline__ void store_elem(unsigned char* base, int64_t i, int dt, float v) {
  if (dt == kF32) reinterpret_cast<float*>(base)[i] = v;
  else if (dt == kBF16) reinterpret_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  else reinterpret_cast<__half*>(base)[i] = __float2half_rn(v);
}

__device__ __forceinline__ void store_pair(unsigned char* base, int64_t i, int dt, float a,
                                           float b) {
  if (dt == kF32) reinterpret_cast<float2*>(base)[i >> 1] = make_float2(a, b);
  else if (dt == kBF16)
    reinterpret_cast<__nv_bfloat162*>(base)[i >> 1] = __floats2bfloat162_rn(a, b);
  else reinterpret_cast<__half2*>(base)[i >> 1] = __floats2half2_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 tiles for mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kBM = 64;        // rows a block (queries; keys in dk/dv)
constexpr int kBN = 64;        // columns a tile
constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // shared row padding (elements): conflict-free ldmatrix

// rows [row0, row0 + 64) of a [rows, d] operand (row stride `rs` elements)
// into shared memory as [64][D + kPad]; rows >= n_rows and columns >= d
// (d a multiple of 8, D the next of 16/32/64/128) are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* smem, const T* base, int64_t rs, int row0,
                                          int n_rows, int d) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < kBM * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool in = row0 + r < n_rows && col < d;
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

// rows row_a and row_a + 8 of an fp32 accumulator [16 x D], times `mul`,
// stored as T at base + row * rs, columns < d only (rows >= n_rows skipped)
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, int64_t rs, int row_a, int n_rows, int d,
                                           const float (&acc)[D / 8][4], float mul, int tig) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (i * 8 >= d) break;
    const int col = i * 8 + tig * 2;
    if (row_a < n_rows)
      *reinterpret_cast<uint32_t*>(base + (int64_t)row_a * rs + col) =
          MmaOp<T>::pack(acc[i][0] * mul, acc[i][1] * mul);
    if (row_a + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (int64_t)(row_a + 8) * rs + col) =
          MmaOp<T>::pack(acc[i][2] * mul, acc[i][3] * mul);
  }
}

// A bias tile staged in shared memory: [64][kBiasStride] elements (8 of
// padding a row keep the lanes' reads below free of bank conflicts)
constexpr int kBiasStride = kBN + 8;

__host__ __device__ constexpr int bias_tile_bytes(int esize) { return kBM * kBiasStride * esize; }

// rows [row0, row0 + 64) x columns [col0, col0 + 64) of the bias plane
// `bb` into shared memory with cp.async (p.staged: a row is whole 16-byte
// chunks, so a chunk lies wholly inside or outside the plane); outside,
// zeros
__device__ __forceinline__ void stage_bias_tile(unsigned char* smem, const Params& p,
                                                const unsigned char* bb, int row0, int col0) {
  const int esize = p.bias_dtype == kF32 ? 4 : 2;
  const int per_chunk = 16 / esize, chunks = kBN / per_chunk;
  for (int c = threadIdx.x; c < kBM * chunks; c += kThreads) {
    const int r = c / chunks, cc = (c % chunks) * per_chunk;
    const bool in = row0 + r < p.s && col0 + cc < p.s;
    const unsigned char* src = in ? bb + ((int64_t)(row0 + r) * p.s + col0 + cc) * esize : bb;
    cp_async16(smem + (r * kBiasStride + cc) * esize, src, in);
  }
}

// the mask term of the 64 columns from col0 of R row mrow (null: no mask):
// 0 where the key is valid, -inf where it is masked or past s; threads
// 0-63 store it (plain loads: read after the next barrier)
__device__ __forceinline__ void stage_mask_term(float* madd, const Params& p,
                                                const uint8_t* mrow, int col0) {
  if (threadIdx.x < kBN) {
    const int col = col0 + threadIdx.x;
    madd[threadIdx.x] =
        col < p.s && (mrow == nullptr || mrow[col] != 0) ? 0.f : -CUDART_INF_F;
  }
}

// bias_tile's term from a staged tile and mask term
__device__ __forceinline__ void bias_tile_smem(float (&add)[kBN / 8][4], const Params& p,
                                               const unsigned char* bs, const float* madd,
                                               int warp, int gr, int tig) {
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    const int col = n * 8 + tig * 2;
    const float2 m = *reinterpret_cast<const float2*>(madd + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 b = load_pair(bs, (warp * 16 + gr + half * 8) * kBiasStride + col,
                                 p.bias_dtype);
      add[n][half * 2] = fmaf(b.x, kLog2e, m.x);
      add[n][half * 2 + 1] = fmaf(b.y, kLog2e, m.y);
    }
  }
}

// The bias term (log2 units) of this lane's entries of a [16 x 64] score
// tile in accumulator layout: rows row_a (c < 2) and row_a + 8 (c >= 2) of
// the bias plane `bb`, columns k0 + n * 8 + tig * 2 + (c & 1).  A column
// past s or masked out (mrow[col] == 0, mrow null = no mask) gets -inf; a
// row past s gets 0 (its lse is +inf, or it is never stored).
__device__ __forceinline__ void bias_tile(float (&add)[kBN / 8][4], const Params& p,
                                          const unsigned char* bb, const uint8_t* mrow,
                                          int row_a, int k0, int tig) {
  const bool pairs = (p.s & 1) == 0;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    const int col = k0 + n * 8 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + half * 8;
      float b0 = 0.f, b1 = 0.f;
      if (row < p.s) {
        const int64_t i = (int64_t)row * p.s + col;
        if (pairs && col < p.s) {
          const float2 v = load_pair(bb, i, p.bias_dtype);
          b0 = v.x;
          b1 = v.y;
        } else {
          if (col < p.s) b0 = load_elem(bb, i, p.bias_dtype);
          if (col + 1 < p.s) b1 = load_elem(bb, i + 1, p.bias_dtype);
        }
      }
      const bool ok0 = col < p.s && (mrow == nullptr || mrow[col] != 0);
      const bool ok1 = col + 1 < p.s && (mrow == nullptr || mrow[col + 1] != 0);
      add[n][half * 2] = ok0 ? b0 * kLog2e : -CUDART_INF_F;
      add[n][half * 2 + 1] = ok1 ? b1 * kLog2e : -CUDART_INF_F;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32 (never TF32)
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 8;    // one warp per row
constexpr int kF32Cols = 32;   // one column per lane a step

bool make_params(Params& p, const void* q, const void* k, const void* v, const void* bias,
                 const void* mask, void* o, void* lse, const void* dout, void* delta, void* dq,
                 void* dk, void* dv, void* dbias, int R, int h, int s, int d, int nb,
                 const long long* strides, float scale, int bias_dtype) {
  if (R < 1 || h < 1 || s < 1 || nb < 1 || R % nb) return false;
  if (d < 8 || d > 128 || d % 8) return false;
  if (bias_dtype < kF32 || bias_dtype > kF16) return false;
  // grid.y / grid.z limits of the launches below
  if ((long long)R * h > 65535 || (s + kF32Rows - 1) / kF32Rows > 65535 ||
      (long long)nb * h > 65535)
    return false;
  p = Params{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.dout = dout;
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dbias = dbias;
  p.R = R;
  p.h = h;
  p.s = s;
  p.d = d;
  p.nb = nb;
  for (int i = 0; i < kOperands; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.bias_dtype = bias_dtype;
  p.staged = ((int64_t)s * (bias_dtype == kF32 ? 4 : 2)) % 16 == 0;
  return true;
}

}  // namespace

// One argument list for the four entry points.  q, k, v, o, do, dq, dk, dv
// [R, h, s, d] with element strides (R, head, row) in `strides` in that
// order (24 values) and a unit last stride; 16-bit operands start on 16
// bytes with strides that are multiples of 8.  bias and dbias [nb, h, s, s]
// contiguous in bias_dtype; mask [R, s] bytes contiguous or null; lse and
// delta [R, h, s] fp32 contiguous.  dtype and bias_dtype: 0 fp32, 1 bf16, 2
// fp16; d a multiple of 8 up to 128.  Pointers a kernel does not use may be
// null.  Each entry point launches on `stream` and returns
// cudaGetLastError(), 0 on success.
#define PAIR_BIAS_ARGS                                                                         \
  const void *q, const void *k, const void *v, const void *bias, const void *mask, void *o,    \
      void *lse, const void *dout, void *delta, void *dq, void *dk, void *dv, void *dbias,      \
      int R, int h, int s, int d, int nb, const long long *strides, float scale, int dtype,     \
      int bias_dtype, void *stream

#define PAIR_BIAS_PARAMS(p)                                                                    \
  make_params(p, q, k, v, bias, mask, o, lse, dout, delta, dq, dk, dv, dbias, R, h, s, d, nb, \
              strides, scale, bias_dtype)
