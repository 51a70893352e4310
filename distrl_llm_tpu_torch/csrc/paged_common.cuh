// The body shared by K2 (paged_attention.cu) and K5 (paged_verify.cu):
// attention of a block of query rows over a page table, split over pages.
//
// Function. For row b, kv head k and its R = S * G query rows
// r = i * G + g (draft position i < S, query head h = k * G + g):
//   q      [B, S, H, hd], already scaled by hd^-0.5 (K2: S = 1)
//   base   lengths[b] + lag (K5: lag 0, the tokens resident before the
//          draft block; K2: lag -1, so that S = 1 gives K2's function)
//   s      = q . k^T in f32, masked at positions >= base + i + 1
//   pages  tables[b, j] clipped to [0, total_pages - 1] for the positions
//          below reach = min(base + S, pps * ps); nothing at or past the
//          reach is read
//   int8   k = w * (scale * (1 / 127.5)), the same for v
//   out    online softmax in f32; acc / max(l, 1e-30) in q's dtype, so a
//          row that attends nothing (K2 at length 0) gives exactly 0.
//
// Row tiles. A block serves at most kMaxRows = 64 query rows of a (row, kv
// head): more (K5 past d = 8 at G 7) take `row_tiles` blocks of tile_rows =
// ceil(R / row_tiles) rows each, planned on the host
// (ops/paged_native.py::plan_row_tiles, which also keeps a block's shared
// memory within the card: the CUDA-core body at head_dim 256 needs ~2.2 KB
// a row). Each tile reads the (row, kv head)'s pages again; the tiles of a
// split are neighbours in the grid's x, so they run together and the
// second read comes from the L2. No tile is empty.
//
// The split (flash-decoding). The grid is (splits * row_tiles, B, K),
// block x = z * row_tiles + tile. Split z covers
// the pages [z * pps_split, (z + 1) * pps_split) of the table, a whole
// number of pages; the host plans it from the shapes alone
// (ops/paged_native.py::plan_paged_split) and never reads the lengths. A
// row's live splits are those that start below its reach; a block whose
// split starts at or past it exits at once. A row with one live split
// writes its output directly; otherwise each live split writes f32
// partials (m, l, acc) to a workspace and paged_merge_kernel, the second
// kernel of the call, combines them in split order (no atomics, so two runs
// give identical bits). A split with no valid position for a query row
// leaves m = NEG_INF, l = 0, acc = 0 and adds exactly nothing.
//
// Two bodies, one per operand type:
//   paged_mma_kernel (bf16 q over bf16 or int8 pages, hd 64 or 128): the
//     products on the tensor cores, mma.sync m16n8k16 with f32 sums. The R
//     query rows are padded to MT m16 tiles and held as A fragments in
//     registers for the whole split; the positions stream through a
//     cp.async ring (K and V of the same positions in one stage, 16-byte
//     chunks XOR-swizzled by row so that ldmatrix reads them without bank
//     conflicts). Warp (mt, pw) scores m-tile mt against its share of each
//     stage's positions, runs its own online softmax on the score
//     fragments, and adds p . v with V through ldmatrix.trans; the warps of
//     an m-tile merge in shared memory at the end. MmaCfg sets the ring and
//     the warps by shape: the warps resident per SM decide the speed.
//     p is carried as a bf16 high part plus a bf16 low part (two
//     products), so p . v keeps ~16 bits of p: bf16 p alone moves the
//     output by more than the one-ulp tolerance the plain version is held
//     to. int8 pages: a stage is converted once to bf16 in shared memory
//     (an int8 value is exact in bf16) and the per-position factor
//     scale * (1 / 127.5) multiplies the score column after q . w and p
//     before p . v, never an element of the page.
//   paged_cc_kernel (every other case: f32 q, f32 pages, other head
//     sizes): the same split, ring and epilogue on the CUDA cores in f32,
//     never TF32; 32-position tiles, a warp's lanes on the positions for
//     the scores, a thread per output element for p . v.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr float kInvMaxInt8 = 1.0f / 127.5f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 64;  // query rows a block serves (of S * G); more take row tiles

struct Geometry {
  int batch, s_len, heads, kv_heads, groups, rows, hd;
  int total_pages, ps, pps, splits, pages_per_split, lag;
  int row_tiles, tile_rows;  // blocks a (split, row, kv head), query rows each (the last fewer)
};

// this block's split z and query rows [r0, r0 + nrows)
struct Tile {
  int z, r0, nrows;
};
__device__ __forceinline__ Tile block_tile(const Geometry& g) {
  const int z = blockIdx.x / g.row_tiles, r0 = (blockIdx.x % g.row_tiles) * g.tile_rows;
  return {z, r0, min(g.tile_rows, g.rows - r0)};
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// positions [0, reach) of row b are read
__device__ __forceinline__ int row_reach(const int32_t* __restrict__ lengths, int b,
                                         const Geometry& g) {
  return max(0, min(lengths[b] + g.lag + g.s_len, g.pps * g.ps));
}
__device__ __forceinline__ int live_splits(int reach, const Geometry& g) {
  const int span = g.pages_per_split * g.ps;
  return max(1, (reach + span - 1) / span);
}
// element offset of query row r of (b, kv head k) in q and out
__device__ __forceinline__ size_t q_offset(int b, int r, int kvh, const Geometry& g) {
  return (((size_t)b * g.s_len + r / g.groups) * g.heads + (size_t)kvh * g.groups +
          r % g.groups) * g.hd;
}
// the workspace: acc [splits][B][K][R][hd], then m and l [splits][B][K][R]
__device__ __forceinline__ size_t ws_row(int z, int b, int kvh, int r, const Geometry& g) {
  return (((size_t)z * g.batch + b) * g.kv_heads + kvh) * g.rows + r;
}
__device__ __forceinline__ size_t ws_rows(const Geometry& g) {
  return (size_t)g.splits * g.batch * g.kv_heads * g.rows;
}

// The block's result from shared memory (acc [nrows][ld], m, l [nrows],
// for query rows t.r0 + r): the output itself when the row has one live
// split, else split t.z's partials.
template <typename QT>
__device__ __forceinline__ void write_result(const float* acc, int ld, const float* m_s,
                                             const float* l_s, QT* __restrict__ out,
                                             float* __restrict__ ws, const Tile& t, int b,
                                             int kvh, bool direct, const Geometry& g) {
  const int n = t.nrows * g.hd;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / g.hd, d = e % g.hd;
    const float a = acc[r * ld + d];
    if (direct) {
      out[q_offset(b, t.r0 + r, kvh, g) + d] = from_f32<QT>(a / fmaxf(l_s[r], 1e-30f));
    } else {
      ws[ws_row(t.z, b, kvh, t.r0 + r, g) * g.hd + d] = a;
    }
  }
  if (!direct) {
    float* ws_m = ws + ws_rows(g) * g.hd;
    float* ws_l = ws_m + ws_rows(g);
    for (int r = threadIdx.x; r < t.nrows; r += blockDim.x) {
      ws_m[ws_row(t.z, b, kvh, t.r0 + r, g)] = m_s[r];
      ws_l[ws_row(t.z, b, kvh, t.r0 + r, g)] = l_s[r];
    }
  }
}

// The second kernel of a split call: one warp per output vector (b, i, h)
// of a row with more than one live split; the partials combined in split
// order, acc_z * exp(m_z - M) over l_z * exp(m_z - M).
template <typename QT>
__global__ void __launch_bounds__(256)
paged_merge_kernel(const float* __restrict__ ws, const int32_t* __restrict__ lengths,
                   QT* __restrict__ out, Geometry g) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= g.batch * g.s_len * g.heads) return;
  const int b = w / (g.s_len * g.heads), ih = w % (g.s_len * g.heads);
  const int i = ih / g.heads, h = ih % g.heads;
  const int kvh = h / g.groups, r = i * g.groups + h % g.groups;
  const int nlive = live_splits(row_reach(lengths, b, g), g);
  if (nlive <= 1) return;  // the split wrote the output itself
  const float* ws_m = ws + ws_rows(g) * g.hd;
  const float* ws_l = ws_m + ws_rows(g);
  float mx = kNegInf;
  for (int z = 0; z < nlive; ++z) mx = fmaxf(mx, ws_m[ws_row(z, b, kvh, r, g)]);
  float l = 0.0f;
  for (int z = 0; z < nlive; ++z) {
    const size_t at = ws_row(z, b, kvh, r, g);
    l += ws_l[at] * expf(ws_m[at] - mx);
  }
  const float inv_l = 1.0f / fmaxf(l, 1e-30f);
  QT* dst = out + q_offset(b, r, kvh, g);
  for (int d = lane; d < g.hd; d += 32) {
    float a = 0.0f;
    for (int z = 0; z < nlive; ++z) {
      const size_t at = ws_row(z, b, kvh, r, g);
      a += ws[at * g.hd + d] * expf(ws_m[at] - mx);
    }
    dst[d] = from_f32<QT>(a * inv_l);
  }
}

// ---------------------------------------------------------------------------
// cp.async, ldmatrix and mma.sync (as csrc/flash_attention.cu)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; `pred` false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
// 4 bytes global -> shared; `pred` false writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16 x 16, row-major) . b (16 x 8, column-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}
// x = hi + lo + O(2^-16 x): the two bf16 parts of an f32
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16(x));
  lo = x - hi;
}
// four signed bytes as two bf16x2 words (bytes 0, 1 and 2, 3), exactly: a
// bf16 0x43XX is 128 + XX for XX < 128, so each byte's low seven bits
// under 0x43, less 0x4300 (128) or, for a negative byte, 0x4380 (256)
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t lo7 = w & 0x7f7f7f7fu, sign = w & 0x80808080u;
  const uint32_t x01 = __byte_perm(lo7, 0x43434343u, 0x5140);
  const uint32_t x23 = __byte_perm(lo7, 0x43434343u, 0x7362);
  const uint32_t c01 = __byte_perm(sign, 0x43434343u, 0x5140);
  const uint32_t c23 = __byte_perm(sign, 0x43434343u, 0x7362);
  const __nv_bfloat162 r01 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x01),
                                     *reinterpret_cast<const __nv_bfloat162*>(&c01));
  const __nv_bfloat162 r23 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x23),
                                     *reinterpret_cast<const __nv_bfloat162*>(&c23));
  return make_uint2(*reinterpret_cast<const uint32_t*>(&r01),
                    *reinterpret_cast<const uint32_t*>(&r23));
}

// element offset of (row, 16-byte chunk) in a [rows][HD] bf16 tile whose
// chunks are XOR-swizzled by row & 7 (HD >= 64: eight chunks a row at least)
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * HD + ((chunk ^ (row & 7)) << 3);
}
// ldmatrix lane addresses. A: the 16 x 16 tile at (row0, k step kk) of a
// row-major tile. B: rows n0..n0 + 15 of a [n][k] tile as the column-major
// operand of . ^T. BT: k step kk over the rows of a [k][n] tile, n chunks
// dn and dn + 1 (.trans).
template <int HD>
__device__ __forceinline__ int a_at(int row0, int kk, int lane) {
  return swz<HD>(row0 + (lane & 15), 2 * kk + (lane >> 4));
}
template <int HD>
__device__ __forceinline__ int b_at(int n0, int kk, int lane) {
  return swz<HD>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1));
}
template <int HD>
__device__ __forceinline__ int bt_at(int kk, int dn, int lane) {
  return swz<HD>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3), dn + (lane >> 4));
}

// ---------------------------------------------------------------------------
// The tensor-core body

// The shape of a block of MT m16 tiles: positions a ring stage, stages,
// warps per m-tile (each takes kTile / kPW positions of a stage) and the
// blocks an SM is asked to hold. What decides it is the warps resident per
// SM: few warps leave the copies and the mma chains exposed. NH is the
// number of 8-row halves of the m-tile that hold query rows: NH = 1 (K2 at
// G <= 8) runs p . v transposed, o^T = v^T p^T, with the heads along mma's
// n = 8, so o takes half the registers and half the products, and three
// blocks of 4 warps fit an SM on a 2-stage ring. K5's three m-tiles (35
// rows) take 12 warps on 128-position stages in one block an SM.
template <int MT, int NH> struct MmaCfg {  // MT 2 and 4
  static constexpr int kTile = 64, kStages = 3, kPW = MT == 2 ? 2 : 1, kMinBlocks = 2;
};
template <> struct MmaCfg<1, 1> {
  static constexpr int kTile = 64, kStages = 2, kPW = 4, kMinBlocks = 3;
};
template <> struct MmaCfg<1, 2> {
  static constexpr int kTile = 64, kStages = 3, kPW = 4, kMinBlocks = 2;
};
template <> struct MmaCfg<3, 2> {
  static constexpr int kTile = 128, kStages = 2, kPW = 4, kMinBlocks = 1;
};

template <typename KVT, int HD, int MT, int NH>
struct MmaSmem {
  using C = MmaCfg<MT, NH>;
  static constexpr bool kQuant = sizeof(KVT) == 1;
  static constexpr size_t kQ = (size_t)MT * 16 * HD * 2;                 // bf16 q, swizzled
  static constexpr size_t kKV = (size_t)C::kTile * HD * sizeof(KVT);     // one K or V tile
  static constexpr size_t kStage = 2 * kKV + (kQuant ? 2 * C::kTile * 4 : 0);  // + scales
  static constexpr size_t kWork = kQuant ? (size_t)2 * C::kTile * HD * 2 : 0;  // bf16 K, V
  static constexpr size_t kRed = (size_t)2 * C::kPW * MT * 16 * 4;       // m, l per warp
  static constexpr size_t kFin = (size_t)2 * MT * 16 * 4;                // the block's m, l
  static constexpr size_t kBytes = kQ + C::kStages * kStage + kWork + kRed + kFin;
  // the epilogue's f32 acc [MT * 16][HD] reuses the ring
  static_assert((size_t)MT * 16 * HD * 4 <= C::kStages * kStage, "acc outgrows the ring");
};

template <typename KVT, int HD, int MT, int NH>
__global__ void __launch_bounds__(MT * MmaCfg<MT, NH>::kPW * 32, MmaCfg<MT, NH>::kMinBlocks)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k_pages,
                 const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                 const float* __restrict__ v_scales, const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ tables, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ ws, Geometry g) {
  using L = MmaSmem<KVT, HD, MT, NH>;
  using C = MmaCfg<MT, NH>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kPW = C::kPW, kNt = MT * kPW * 32, kT = C::kTile, kStages = C::kStages;
  constexpr int kPpw = kT / kPW;  // positions a warp takes of each tile
  static_assert(NH == 2 || MT == 1, "the transposed p . v serves one m-tile");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + L::kQ;
  __nv_bfloat16* work = reinterpret_cast<__nv_bfloat16*>(ring + kStages * L::kStage);
  float* red_m = reinterpret_cast<float*>(ring + kStages * L::kStage + L::kWork);
  float* red_l = red_m + kPW * MT * 16;
  float* fin_m = red_l + kPW * MT * 16;
  float* fin_l = fin_m + MT * 16;

  const Tile tile = block_tile(g);
  const int z = tile.z, b = blockIdx.y, kvh = blockIdx.z;
  const int reach = row_reach(lengths, b, g);
  const int nlive = live_splits(reach, g);
  if (z >= nlive) return;  // the split starts past the row's reach
  const int span = g.pages_per_split * g.ps;
  const int lo = z * span, hi = min(lo + span, reach);
  const int ntiles = hi > lo ? (hi - lo + kT - 1) / kT : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp / kPW, pw = warp % kPW;
  const int gq = lane >> 2, c = lane & 3;

  const int32_t* table = tables + (size_t)b * g.pps;
  const size_t head_pages = (size_t)kvh * g.total_pages;
  // a tile starts on a multiple of its length (a split holds whole pages),
  // so with pages of a multiple of it the tile lies in one page: one table
  // entry a tile instead of one a row
  const bool one_page = g.ps % kT == 0;
  // tile `it` of the split: positions lo + it * kT + [0, kT) into its stage
  auto load_tile = [&](int it) {
    unsigned char* st = ring + (it % kStages) * L::kStage;
    constexpr int kChunks = HD * (int)sizeof(KVT) / 16;  // 16-byte chunks a row
    const int t0 = lo + it * kT;
    size_t row0 = 0;
    if (one_page) {
      const int page = min(max(table[t0 / g.ps], 0), g.total_pages - 1);
      row0 = (head_pages + page) * g.ps + t0 % g.ps;
    }
    for (int i = threadIdx.x; i < kT * kChunks; i += kNt) {
      const int t = i / kChunks, ch = i % kChunks, pos = t0 + t;
      const bool ok = pos < hi;
      size_t row = 0;
      if (ok) {
        if (one_page) {
          row = row0 + t;
        } else {
          const int page = min(max(table[pos / g.ps], 0), g.total_pages - 1);
          row = (head_pages + page) * g.ps + pos % g.ps;
        }
      }
      const KVT* ks = k_pages + row * HD + ch * (16 / sizeof(KVT));
      const KVT* vs = v_pages + row * HD + ch * (16 / sizeof(KVT));
      if constexpr (kQuant) {  // plain [kT][HD] int8 tiles, then the scales
        cp_async16(st + t * HD + ch * 16, ks, ok);
        cp_async16(st + L::kKV + t * HD + ch * 16, vs, ok);
        if (ch == 0) {
          float* sc = reinterpret_cast<float*>(st + 2 * L::kKV);
          cp_async4(sc + t, k_scales + row, ok);
          cp_async4(sc + kT + t, v_scales + row, ok);
        }
      } else {
        __nv_bfloat16* kd = reinterpret_cast<__nv_bfloat16*>(st);
        cp_async16(kd + swz<HD>(t, ch), ks, ok);
        cp_async16(kd + kT * HD + swz<HD>(t, ch), vs, ok);
      }
    }
  };

  // the tile's q rows (zero past them) into swizzled m-tiles
  for (int i = threadIdx.x; i < MT * 16 * (HD / 8); i += kNt) {
    const int r = i / (HD / 8), ch = i % (HD / 8);
    const bool ok = r < tile.nrows;
    cp_async16(q_s + swz<HD>(r, ch), ok ? q + q_offset(b, tile.r0 + r, kvh, g) + ch * 8 : q,
               ok);
  }
  cp_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_commit();
  }
  // this thread's two rows (gq and gq + 8 of its m-tile): positions below
  // lim are valid (pad rows: none)
  int lim[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = mt * 16 + gq + 8 * hr;
    lim[hr] = r < tile.nrows ? min(lengths[b] + g.lag + (tile.r0 + r) / g.groups + 1, hi) : -1;
  }
  cp_wait<kStages - 1>();  // q has landed
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], q_s + a_at<HD>(mt * 16, kk, lane));

  // NH = 2: o [16 rows][HD] as HD / 8 m16n8 tiles (rows gq, gq + 8; columns
  // 2c, 2c + 1). NH = 1: o^T [HD][8 rows] as HD / 16 tiles (d = 16 dm + gq,
  // + 8; rows 2c, 2c + 1)
  constexpr int kO = NH == 2 ? HD / 8 : HD / 16;
  float o[kO][4];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile it landed for all; tile it - 1's readers are done
    if (it + kStages - 1 < ntiles) load_tile(it + kStages - 1);
    cp_commit();
    unsigned char* st = ring + (it % kStages) * L::kStage;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* vs;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    const int t_base = lo + it * kT;
    const int w0 = pw * kPpw;  // the warp's first row of the tile
    if constexpr (kQuant) {
      // the stage's int8 K and V as bf16, exactly, into the work tiles: with
      // one m-tile each warp converts the rows it reads, else the block
      // converts the tile for all its m-tiles
      constexpr int kChunks = HD / 16;
      constexpr int kRows = MT == 1 ? kPpw : kT;
      const int r0 = MT == 1 ? w0 : 0;
      const int tid = MT == 1 ? lane : threadIdx.x;
      if (MT > 1 || t_base + w0 < hi) {
        for (int i = tid; i < 2 * kRows * kChunks; i += MT == 1 ? 32 : kNt) {
          const int which = i / (kRows * kChunks), j = i % (kRows * kChunks);
          const int t = r0 + j / kChunks, ch = j % kChunks;
          const uint4 w =
              *reinterpret_cast<const uint4*>(st + which * L::kKV + t * HD + ch * 16);
          const uint2 a0 = i8x4_to_bf16x4(w.x), a1 = i8x4_to_bf16x4(w.y);
          const uint2 a2 = i8x4_to_bf16x4(w.z), a3 = i8x4_to_bf16x4(w.w);
          __nv_bfloat16* dst = work + which * kT * HD;
          *reinterpret_cast<uint4*>(dst + swz<HD>(t, 2 * ch)) =
              make_uint4(a0.x, a0.y, a1.x, a1.y);
          *reinterpret_cast<uint4*>(dst + swz<HD>(t, 2 * ch + 1)) =
              make_uint4(a2.x, a2.y, a3.x, a3.y);
        }
      }
      if constexpr (MT == 1) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      ks = work;
      vs = work + kT * HD;
      ksc = reinterpret_cast<const float*>(st + 2 * L::kKV);
      vsc = ksc + kT;
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(st);
      vs = ks + kT * HD;
    }
    if (t_base + w0 >= hi) continue;  // every position of this warp is past the split

    // s = q k^T over the warp's positions
    float s[kPpw / 8][4];
#pragma unroll
    for (int j = 0; j < kPpw / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < kPpw / 16; ++jj) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + b_at<HD>(w0 + 16 * jj, kk, lane));
        mma16816(s[2 * jj], qf[kk], bf[0], bf[1]);
        mma16816(s[2 * jj + 1], qf[kk], bf[2], bf[3]);
      }
    }
    // the per-row limits (and int8's key factor) on the fragments
#pragma unroll
    for (int j = 0; j < kPpw / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = w0 + 8 * j + 2 * c + (e & 1);
        float x = s[j][e];
        if constexpr (kQuant) x *= ksc[tr] * kInvMaxInt8;
        s[j][e] = t_base + tr < lim[e >> 1] ? x : -INFINITY;
      }
    }
    // online softmax per row: exp(-inf - m) = 0 for a masked position, and
    // m never drops below NEG_INF, so a row with nothing valid yet keeps
    // l = 0 and acc = 0. e^x as 2^(x log2 e); the rescale of o is skipped
    // when no row of the warp raised its maximum
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPpw / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      // (x - m) first: exact 0 when both are NEG_INF, never a huge residue
      alpha[hr] = exp2f((m[hr] - m_new) * kLog2e);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kPpw / 8; ++j) {
        s[j][2 * hr] = exp2f((s[j][2 * hr] - m_new) * kLog2e);
        s[j][2 * hr + 1] = exp2f((s[j][2 * hr + 1] - m_new) * kLog2e);
        rs += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      rs += __shfl_xor_sync(kFull, rs, 1);
      rs += __shfl_xor_sync(kFull, rs, 2);
      l[hr] = l[hr] * alpha[hr] + rs;
      m[hr] = m_new;
    }
    if (__any_sync(kFull, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
      if constexpr (NH == 2) {
#pragma unroll
        for (int dn = 0; dn < HD / 8; ++dn) {
          o[dn][0] *= alpha[0];
          o[dn][1] *= alpha[0];
          o[dn][2] *= alpha[1];
          o[dn][3] *= alpha[1];
        }
      } else {  // o^T's columns are rows 2c and 2c + 1, held by lanes 8c, 8c + 4
        const float a0 = __shfl_sync(kFull, alpha[0], 8 * c);
        const float a1 = __shfl_sync(kFull, alpha[0], 8 * c + 4);
#pragma unroll
        for (int dm = 0; dm < HD / 16; ++dm) {
          o[dm][0] *= a0;
          o[dm][1] *= a1;
          o[dm][2] *= a0;
          o[dm][3] *= a1;
        }
      }
    }
    // o += p v, p (times int8's value factor) as bf16 high + low parts
#pragma unroll
    for (int kk = 0; kk < kPpw / 16; ++kk) {
      float ph[8], pl[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (NH == 1 && (e & 2)) continue;  // rows 8-15: no query row
        float p = s[2 * kk + (e >> 2)][e & 3];
        if constexpr (kQuant) {
          const int tr = w0 + 16 * kk + 8 * (e >> 2) + 2 * c + (e & 1);
          p *= vsc[tr] * kInvMaxInt8;
        }
        split_bf16(p, ph[e], pl[e]);
      }
      if constexpr (NH == 2) {
        uint32_t ah[4], al[4];
        ah[0] = pack_bf16(ph[0], ph[1]);
        ah[1] = pack_bf16(ph[2], ph[3]);
        ah[2] = pack_bf16(ph[4], ph[5]);
        ah[3] = pack_bf16(ph[6], ph[7]);
        al[0] = pack_bf16(pl[0], pl[1]);
        al[1] = pack_bf16(pl[2], pl[3]);
        al[2] = pack_bf16(pl[4], pl[5]);
        al[3] = pack_bf16(pl[6], pl[7]);
#pragma unroll
        for (int dn = 0; dn < HD / 8; dn += 2) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vs + bt_at<HD>(w0 / 16 + kk, dn, lane));
          mma16816(o[dn], ah, bf[0], bf[1]);
          mma16816(o[dn], al, bf[0], bf[1]);
          mma16816(o[dn + 1], ah, bf[2], bf[3]);
          mma16816(o[dn + 1], al, bf[2], bf[3]);
        }
      } else {
        // p's A fragment for rows 0-7 (positions 2c, 2c + 1 and + 8) is
        // p^T's B fragment for heads 0-7; v^T's A fragments by ldmatrix.trans
        const uint32_t bh0 = pack_bf16(ph[0], ph[1]), bh1 = pack_bf16(ph[4], ph[5]);
        const uint32_t bl0 = pack_bf16(pl[0], pl[1]), bl1 = pack_bf16(pl[4], pl[5]);
#pragma unroll
        for (int dm = 0; dm < HD / 16; ++dm) {
          uint32_t av[4];
          ldsm_x4_t(av, vs + b_at<HD>(w0 + 16 * kk, dm, lane));
          mma16816(o[dm], av, bh0, bh1);
          mma16816(o[dm], av, bl0, bl1);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the f32 acc from here

  // the kPW warps of each m-tile merge: M = max m, their acc and l scaled
  // by exp(m - M) and summed in warp order
  if (c == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      red_m[pw * MT * 16 + mt * 16 + gq + 8 * hr] = m[hr];
      red_l[pw * MT * 16 + mt * 16 + gq + 8 * hr] = l[hr];
    }
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = mt * 16 + gq + 8 * hr;
    float mx = kNegInf;
    for (int w = 0; w < kPW; ++w) mx = fmaxf(mx, red_m[w * MT * 16 + r]);
    f[hr] = expf(m[hr] - mx);
    if (pw == 0 && c == 0) {
      float sum = 0.0f;
      for (int w = 0; w < kPW; ++w) sum += red_l[w * MT * 16 + r] * expf(red_m[w * MT * 16 + r] - mx);
      fin_m[r] = mx;
      fin_l[r] = sum;
    }
  }
  if constexpr (NH == 1) {  // the factors of rows 2c and 2c + 1
    const float f0 = __shfl_sync(kFull, f[0], 8 * c), f1 = __shfl_sync(kFull, f[0], 8 * c + 4);
    f[0] = f0;
    f[1] = f1;
  }
  float* acc = reinterpret_cast<float*>(ring);  // [MT * 16][HD]
  for (int w = 0; w < kPW; ++w) {
    if (pw == w) {
#pragma unroll
      for (int i = 0; i < kO; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r, col;
          float x;
          if constexpr (NH == 2) {
            r = mt * 16 + gq + 8 * (e >> 1);
            col = 8 * i + 2 * c + (e & 1);
            x = o[i][e] * f[e >> 1];
          } else {
            r = 2 * c + (e & 1);
            col = 16 * i + gq + 8 * (e >> 1);
            x = o[i][e] * f[e & 1];
          }
          acc[r * HD + col] = w == 0 ? x : acc[r * HD + col] + x;
        }
      }
    }
    __syncthreads();
  }
  write_result(acc, HD, fin_m, fin_l, out, ws, tile, b, kvh, nlive == 1, g);
}

// ---------------------------------------------------------------------------
// The CUDA-core body (f32 q or f32 pages, and head sizes the mma body does
// not take)

constexpr int kCcThreads = 256;
constexpr int kCcWarps = kCcThreads / 32;
constexpr int kCcTile = 32;    // positions per ring stage: one per lane
constexpr int kCcStages = 2;
constexpr int kCcRowsPerWarp = kMaxRows / kCcWarps;

// a K or V row in shared memory: its bytes plus 16, so that the lanes'
// 16-byte reads of 32 rows at one chunk fall in different banks
__host__ __device__ __forceinline__ int cc_row_bytes(int hd, int elem) { return hd * elem + 16; }
__host__ __device__ __forceinline__ size_t cc_stage_bytes(int hd, int elem) {
  return 2 * (size_t)kCcTile * cc_row_bytes(hd, elem) + (elem == 1 ? 2 * kCcTile * 4 : 0);
}
// the ring, then f32 q [R][hd], acc [R][hd], p [R][32], m, l, alpha [R]
// and int lim [R]
__host__ __device__ __forceinline__ size_t cc_smem_bytes(int rows, int hd, int elem) {
  return kCcStages * cc_stage_bytes(hd, elem) + 4 * (size_t)rows * (2 * hd + kCcTile + 4);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kCcThreads)
paged_cc_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pages,
                const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                const float* __restrict__ v_scales, const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ tables, QT* __restrict__ out,
                float* __restrict__ ws, Geometry g) {
  constexpr bool kQuant = sizeof(KVT) == 1;
  constexpr int kE = 16 / sizeof(KVT);  // values per 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tile = block_tile(g);
  const int hd = g.hd, rows = tile.nrows;
  const int row_b = cc_row_bytes(hd, sizeof(KVT));
  const size_t stage_b = cc_stage_bytes(hd, sizeof(KVT));
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + kCcStages * stage_b);
  float* acc = q_s + rows * hd;
  float* p_s = acc + rows * hd;
  float* m_s = p_s + rows * kCcTile;
  float* l_s = m_s + rows;
  float* a_s = l_s + rows;
  int* lim_s = reinterpret_cast<int*>(a_s + rows);

  const int z = tile.z, b = blockIdx.y, kvh = blockIdx.z;
  const int reach = row_reach(lengths, b, g);
  const int nlive = live_splits(reach, g);
  if (z >= nlive) return;
  const int span = g.pages_per_split * g.ps;
  const int lo = z * span, hi = min(lo + span, reach);
  const int ntiles = hi > lo ? (hi - lo + kCcTile - 1) / kCcTile : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int32_t* table = tables + (size_t)b * g.pps;
  const size_t head_pages = (size_t)kvh * g.total_pages;
  auto load_tile = [&](int it) {
    unsigned char* st = ring + (it % kCcStages) * stage_b;
    const int chunks = hd * (int)sizeof(KVT) / 16;
    const int t0 = lo + it * kCcTile;
    for (int i = threadIdx.x; i < kCcTile * chunks; i += kCcThreads) {
      const int t = i / chunks, ch = i % chunks, pos = t0 + t;
      const bool ok = pos < hi;
      size_t row = 0;
      if (ok) {
        const int page = min(max(table[pos / g.ps], 0), g.total_pages - 1);
        row = (head_pages + page) * g.ps + pos % g.ps;
      }
      cp_async16(st + t * row_b + ch * 16, k_pages + row * hd + ch * kE, ok);
      cp_async16(st + (kCcTile + t) * row_b + ch * 16, v_pages + row * hd + ch * kE, ok);
      if (kQuant && ch == 0) {
        float* sc = reinterpret_cast<float*>(st + 2 * kCcTile * row_b);
        cp_async4(sc + t, k_scales + row, ok);
        cp_async4(sc + kCcTile + t, v_scales + row, ok);
      }
    }
  };

  if (ntiles > 0) load_tile(0);
  cp_commit();
  for (int e = threadIdx.x; e < rows * hd; e += kCcThreads) {
    q_s[e] = to_f32(q[q_offset(b, tile.r0 + e / hd, kvh, g) + e % hd]);
    acc[e] = 0.0f;
  }
  for (int r = threadIdx.x; r < rows; r += kCcThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
    lim_s[r] = min(lengths[b] + g.lag + (tile.r0 + r) / g.groups + 1, hi);
  }

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // tile it landed; q, m, l and acc are set
    const unsigned char* st = ring + (it % kCcStages) * stage_b;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * kCcTile * row_b);
    const int t_base = lo + it * kCcTile;
    // scores: lane = position, warp = every kCcWarps-th query row; then the
    // warp's online-softmax update of each of its rows over the tile
    {
      float sc[kCcRowsPerWarp];
#pragma unroll
      for (int a = 0; a < kCcRowsPerWarp; ++a) sc[a] = 0.0f;
      const unsigned char* krow = st + lane * row_b;
      for (int ch = 0; ch < hd / kE; ++ch) {
        const int4 raw = *reinterpret_cast<const int4*>(krow + ch * 16);
        const KVT* kv = reinterpret_cast<const KVT*>(&raw);
        float kf[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) kf[e] = to_f32(kv[e]);
#pragma unroll
        for (int a = 0; a < kCcRowsPerWarp; ++a) {
          const int r = warp + kCcWarps * a;
          if (r < rows) {
            const float* qr = q_s + r * hd + ch * kE;
#pragma unroll
            for (int e = 0; e < kE; ++e) sc[a] += qr[e] * kf[e];
          }
        }
      }
      const int pos = t_base + lane;
      const float kfac = kQuant ? ksc[lane] * kInvMaxInt8 : 1.0f;
      const float vfac = kQuant ? ksc[kCcTile + lane] * kInvMaxInt8 : 1.0f;
#pragma unroll
      for (int a = 0; a < kCcRowsPerWarp; ++a) {
        const int r = warp + kCcWarps * a;
        if (r >= rows) break;
        const float x = pos < lim_s[r] ? sc[a] * kfac : -INFINITY;
        float mx = x;
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p = expf(x - m_new);
        float sum = p;
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        p_s[r * kCcTile + lane] = p * vfac;
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[r] = alpha;
          l_s[r] = alpha * l_s[r] + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();
    // acc = acc * alpha + p v, a thread per element (rows past the split's
    // end hold zeros and p = 0)
    const KVT* vt = reinterpret_cast<const KVT*>(st + kCcTile * row_b);
    const int vld = row_b / (int)sizeof(KVT);
    for (int e = threadIdx.x; e < rows * hd; e += kCcThreads) {
      const int r = e / hd, d = e % hd;
      const float* pr = p_s + r * kCcTile;
      float x = acc[e] * a_s[r];
#pragma unroll 8
      for (int t = 0; t < kCcTile; ++t) x += pr[t] * to_f32(vt[t * vld + d]);
      acc[e] = x;
    }
    __syncthreads();  // the stage and p_s are rewritten next
  }
  cp_wait<0>();
  __syncthreads();
  write_result(acc, hd, m_s, l_s, out, ws, tile, b, kvh, nlive == 1, g);
}

// ---------------------------------------------------------------------------
// The launcher: the body for the operand types, then the merge

struct Args {
  const void *q, *k_pages, *v_pages, *k_scales, *v_scales, *lengths, *tables;
  void *out, *ws;
  int q_dtype, kv_dtype;  // 0 f32, 1 bf16 (q, pages); 2 int8 (pages)
  cudaStream_t stream;
};

template <typename KVT, int HD, int MT, int NH>
int launch_mma(const Args& a, const Geometry& g) {
  const size_t smem = MmaSmem<KVT, HD, MT, NH>::kBytes;
  auto kernel = paged_mma_kernel<KVT, HD, MT, NH>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(g.splits * g.row_tiles, g.batch, g.kv_heads), MT * MmaCfg<MT, NH>::kPW * 32,
           smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const KVT*)a.k_pages, (const KVT*)a.v_pages,
      (const float*)a.k_scales, (const float*)a.v_scales, (const int32_t*)a.lengths,
      (const int32_t*)a.tables, (__nv_bfloat16*)a.out, (float*)a.ws, g);
  return (int)cudaGetLastError();
}

template <typename KVT, int HD>
int launch_mma_rows(const Args& a, const Geometry& g) {
  if (g.tile_rows <= 8) return launch_mma<KVT, HD, 1, 1>(a, g);
  switch ((g.tile_rows + 15) / 16) {
    case 1: return launch_mma<KVT, HD, 1, 2>(a, g);
    case 2: return launch_mma<KVT, HD, 2, 2>(a, g);
    case 3: return launch_mma<KVT, HD, 3, 2>(a, g);
    case 4: return launch_mma<KVT, HD, 4, 2>(a, g);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT, typename KVT>
int launch_cc(const Args& a, const Geometry& g) {
  if (g.hd * (int)sizeof(KVT) % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = cc_smem_bytes(g.tile_rows, g.hd, sizeof(KVT));
  auto kernel = paged_cc_kernel<QT, KVT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(g.splits * g.row_tiles, g.batch, g.kv_heads), kCcThreads, smem, a.stream>>>(
      (const QT*)a.q, (const KVT*)a.k_pages, (const KVT*)a.v_pages, (const float*)a.k_scales,
      (const float*)a.v_scales, (const int32_t*)a.lengths, (const int32_t*)a.tables,
      (QT*)a.out, (float*)a.ws, g);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_cc_kv(const Args& a, const Geometry& g) {
  switch (a.kv_dtype) {
    case 0: return launch_cc<QT, float>(a, g);
    case 1: return launch_cc<QT, __nv_bfloat16>(a, g);
    case 2: return launch_cc<QT, int8_t>(a, g);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT>
int launch_merge(const Args& a, const Geometry& g) {
  const long warps = (long)g.batch * g.s_len * g.heads;
  paged_merge_kernel<QT><<<(unsigned)((warps + 7) / 8), 256, 0, a.stream>>>(
      (const float*)a.ws, (const int32_t*)a.lengths, (QT*)a.out, g);
  return (int)cudaGetLastError();
}

// bf16 q over bf16 or int8 pages at hd 64 or 128: the tensor cores
inline bool takes_mma(int q_dtype, int kv_dtype, int hd) {
  return q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2) && (hd == 64 || hd == 128);
}

inline int launch(const Args& a, Geometry g) {
  if (g.batch <= 0) return (int)cudaGetLastError();
  if (g.kv_heads < 1 || g.heads % g.kv_heads || g.s_len < 1 || g.splits < 1 ||
      g.pages_per_split < 1 || (g.splits > 1) != (a.ws != nullptr))
    return (int)cudaErrorInvalidValue;
  g.groups = g.heads / g.kv_heads;
  g.rows = g.s_len * g.groups;
  if (g.row_tiles < 1) return (int)cudaErrorInvalidValue;
  g.tile_rows = (g.rows + g.row_tiles - 1) / g.row_tiles;
  // at most kMaxRows a block, and no empty tile
  if (g.tile_rows > kMaxRows || (g.row_tiles - 1) * g.tile_rows >= g.rows)
    return (int)cudaErrorInvalidValue;
  int err;
  if (takes_mma(a.q_dtype, a.kv_dtype, g.hd)) {
    if (a.kv_dtype == 1) {
      err = g.hd == 64 ? launch_mma_rows<__nv_bfloat16, 64>(a, g)
                       : launch_mma_rows<__nv_bfloat16, 128>(a, g);
    } else {
      err = g.hd == 64 ? launch_mma_rows<int8_t, 64>(a, g) : launch_mma_rows<int8_t, 128>(a, g);
    }
  } else if (a.q_dtype == 0) {
    err = launch_cc_kv<float>(a, g);
  } else if (a.q_dtype == 1) {
    err = launch_cc_kv<__nv_bfloat16>(a, g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || g.splits == 1) return err;
  return a.q_dtype == 0 ? launch_merge<float>(a, g) : launch_merge<__nv_bfloat16>(a, g);
}

}  // namespace paged
