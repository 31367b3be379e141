// What the pair-bias attention kernels (pair_bias_attention_fwd.cu and
// pair_bias_attention_bwd.cu) share: their one argument list, the bias
// words of a score tile in the wgmma accumulator layout (from a staged
// 128-byte-swizzled box or from device memory), and the TMA maps of the
// 16-bit kernels (on flash_sm90.cuh).
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

#include "flash_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// which operand a stride triple (R, head, row) belongs to
enum Operand { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kOperands };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;       // [b, h, s, s] contiguous, bias_dtype
  const uint8_t* mask;    // [R, s] bytes in rows mask_ld apart, or null
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
  int64_t mask_ld;        // the mask's row stride in bytes: s, or the 16-bit map's
  // bias rows are whole 16-byte chunks (s * element size % 16 == 0): the
  // 16-bit kernels stream bias tiles by TMA; else each lane reads its values
  // from device memory
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
// bf16 / fp16: the tiles the TMA + wgmma kernels stream (flash_sm90.cuh)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;        // rows a consumer warpgroup owns; a box's rows
constexpr int kKeys = 64;          // keys (or queries) a streamed tile
constexpr int kBlockQueries = 2 * kWgRows;
constexpr int kBiasBox = kWgRows * 128;   // one bias box: 64 rows of 128 bytes
constexpr int kMaskBox = 128;             // a stage's mask bytes, 128-byte aligned
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may take on Hopper

// a 16-bit pair (the lower element in the low half) as two fp32 values
__device__ __forceinline__ float2 pair_f32(uint32_t w, bool bf16) {
  if (bf16) return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  return __half22float2(h);
}

// The raw bias words of this lane's 32 accumulator entries (rows row_a and
// row_a + 8 of the plane `bb`, columns k0 + 8 (i / 4) + 2 tig + (i & 1)) from
// device memory: entry i = 4 n + 2 half + e; for fp32 one value a word, for
// 16 bits the pair (e = 0, 1) in word 4 n + 2 half.  Zero past s.  Group m
// holds words 8 m ... 8 m + 7 (n = 2 m, 2 m + 1).
__device__ __forceinline__ void bias_group_global(uint32_t (&w)[8], const Params& p,
                                                  const unsigned char* bb, int row_a, int k0,
                                                  int tig, int m) {
  const bool pairs = (p.s & 1) == 0;
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
    const int col = k0 + (2 * m + nn) * 8 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + half * 8;
      uint32_t w0 = 0, w1 = 0;
      if (row < p.s) {
        const int64_t e = (int64_t)row * p.s + col;
        if (p.bias_dtype == kF32) {
          const uint32_t* src = reinterpret_cast<const uint32_t*>(bb) + e;
          if (pairs && col < p.s) {
            const uint2 v = *reinterpret_cast<const uint2*>(src);
            w0 = v.x;
            w1 = v.y;
          } else {
            if (col < p.s) w0 = src[0];
            if (col + 1 < p.s) w1 = src[1];
          }
        } else {
          const uint16_t* src = reinterpret_cast<const uint16_t*>(bb) + e;
          if (pairs && col < p.s) {
            w0 = *reinterpret_cast<const uint32_t*>(src);
          } else {
            w0 = (col < p.s ? src[0] : 0u) | (col + 1 < p.s ? (uint32_t)src[1] << 16 : 0u);
          }
        }
      }
      w[4 * nn + 2 * half] = w0;
      w[4 * nn + 2 * half + 1] = w1;
    }
  }
}

// The same words from a staged bias tile: 64-row boxes of 128-byte rows,
// 128-byte swizzled (chunk j of row r at j ^ (r % 8)), one box of 64 16-bit
// columns or two of 32 fp32 ones; this warp's rows warp * 16 + g (+ 8)
__device__ __forceinline__ void bias_group_smem(uint32_t (&w)[8], const unsigned char* tile,
                                                bool f32, int warp, int g, int tig, int m) {
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
    const int n = 2 * m + nn;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + half * 8;
      if (f32) {
        const int chunk = 2 * (n & 3) + (tig >> 1);
        const uint2 v = *reinterpret_cast<const uint2*>(
            tile + (n >> 2) * kBiasBox + r * 128 + ((chunk ^ g) << 4) + 8 * (tig & 1));
        w[4 * nn + 2 * half] = v.x;
        w[4 * nn + 2 * half + 1] = v.y;
      } else {
        w[4 * nn + 2 * half] =
            *reinterpret_cast<const uint32_t*>(tile + r * 128 + ((n ^ g) << 4) + 4 * tig);
      }
    }
  }
}

// all 32 words of either
__device__ __forceinline__ void bias_words_global(uint32_t (&w)[32], const Params& p,
                                                  const unsigned char* bb, int row_a, int k0,
                                                  int tig) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t g8[8];
    bias_group_global(g8, p, bb, row_a, k0, tig, m);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[8 * m + j] = g8[j];
  }
}

__device__ __forceinline__ void bias_words_smem(uint32_t (&w)[32], const unsigned char* tile,
                                                bool f32, int warp, int g, int tig) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t g8[8];
    bias_group_smem(g8, tile, f32, warp, g, tig, m);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[8 * m + j] = g8[j];
  }
}

// A rank-4 map from its geometry, 12 values as ops/pair_bias_attention.py's
// _tma_geometry gives them: dims (innermost first), the byte strides of the
// outer three, the box and the swizzle span in bytes (64 or 128; 0 for
// none).  False if the box or span is not the one the kernel reads, or the
// encoder refuses.
inline bool encode_map(CUtensorMap* map, const void* base, const long long* g,
                       CUtensorMapDataType type, int box_cols, int box_rows, int span) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || base == nullptr || g[7] != box_cols || g[8] != box_rows ||
      g[9] != 1 || g[10] != 1 || g[11] != span)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2],
                              (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5], (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8], 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline CUtensorMapDataType map_type(int dtype) {
  return dtype == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// The maps a 16-bit kernel reads, from `maps` (ops/pair_bias_attention.py's
// _tma_maps; 12 values each, `n` of them): q, k, v (and do), [R, h, s, d] in
// boxes of 64 rows by the padded head dim's box columns; the bias [b, h, s,
// s] in boxes of 64 rows by 128 bytes, where it is staged (else q's map
// stands in, never read); the kv mask's bytes [R, s] in boxes of one row of
// kKeys bytes, whose row stride becomes p.mask_ld.  False for a geometry
// that is not the kernels' or that the encoder refuses.
template <int D>
bool encode_maps(CUtensorMap* m, int n, Params& p, int dtype, const long long* maps) {
  constexpr int kCols = FlashTile<D>::kBoxCols, kSpan = FlashTile<D>::kRowBytes;
  const void* bases[4] = {p.q, p.k, p.v, p.dout};
  const long long* mb = maps + 12 * (n - 1);    // the mask's
  const long long* bg = mb - 12;                // the bias's
  if (maps == nullptr || mb[0] != p.s || mb[1] != p.R ||
      !encode_map(&m[n - 1], p.mask, mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, kKeys, 1, 0))
    return false;
  for (int i = 0; i < n - 2; ++i)
    if (maps[12 * i] != p.d || !encode_map(&m[i], bases[i], maps + 12 * i, map_type(dtype),
                                           kCols, kWgRows, kSpan))
      return false;
  const int esize = p.bias_dtype == kF32 ? 4 : 2;
  if (p.staged) {
    if (bg[0] != p.s || bg[1] != p.s ||
        !encode_map(&m[n - 2], p.bias, bg, map_type(p.bias_dtype), 128 / esize, kWgRows, 128))
      return false;
  } else {
    m[n - 2] = m[0];   // never read
  }
  p.mask_ld = mb[4];
  return true;
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
  p.mask_ld = s;
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
