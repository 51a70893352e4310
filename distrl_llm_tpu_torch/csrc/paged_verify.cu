// Speculative draft-block verify attention for Hopper (sm_90a): an S-query
// block per row, GQA, over a page table of bf16/f32 pages or int8 pages with
// compact per-token f32 scales.
//
// Replaces the TPU kernel distrl_llm_tpu/ops/paged_native.py::
// paged_attention_native_verify (body _make_verify_kernel), the attention of
// one speculative verify forward. For row b, kv head k and query row
// r = i * G + g (draft position i, query head h = k * G + g), G = H / K:
//   q      [B, S, H, hd], already scaled by hd^-0.5
//   pages  tables[b, j] clipped to [0, total_pages - 1], for
//          j * ps < lengths[b] + S (the block's own KV is resident: the
//          verify forward writes it first), never past the table
//   s      = q . k^T in f32, NEG_INF (-1e30) at positions >= lengths[b] + i + 1
//   int8   k = w * (scale * (1 / 127.5)), the same for v
//   out    online softmax in f32; acc / max(l, 1e-30) in q's dtype. Every
//          query attends position 0, so no row is empty.
//
// Design. K2 (paged_attention.cu) with the S draft positions folded into
// the query rows: a block of 256 threads serves a tile of the S * G rows of
// one (row, kv head), 35 at Qwen2.5-7B with d = 4. A thread holds kAcc = 8
// accumulators (K2's count: one output column, every 256 / hd-th row), so a
// tile is up to 8 * (256 / hd) rows, 16 at hd = 128: the 35 rows split into
// 3 balanced tiles of 12 along the grid's fastest axis, so the tiles of one
// (row, kv head) run side by side and each page is read 3 times, the second
// and third mostly from L2 (64 rows x ~600 positions x 2 x 4 heads x 128 x
// 2 bytes = 79 MB read 3 times instead of once), at 127-161 registers. One
// tile of all 35 rows (24 accumulators a thread) reads each byte once but
// took ~180-208 registers, one block per SM, and ran 0.80-0.84 ms against
// 0.46-0.48 for the 3 tiles on the H100 (64 rows x S 5 x ~600, bf16
// pages), so kAcc is fixed at 8.
// Scoring is K2's: each warp takes one position at a time for 8 query rows
// (lanes split hd, one interleaved butterfly), now masked per row at its
// own limit. After `ppb` pages one online-softmax update runs per row, then
// the V pages are staged and every thread accumulates p . v for its column
// and rows, four positions at a time. Pages past lengths + S are not read;
// positions past it inside the last page are neither scored nor
// accumulated, so garbage there is never touched.
//
// What bounds it. The function needs every K/V position some row's block
// reaches once (2 * K * hd elements each, plus int8 scales), q and the
// output; a prompt page shared by a prompt's n candidates counts once. At
// 64 rows of ~600 positions (4 prompts x 16, 28 / 4 heads, hd 128, bf16
// pages) that is ~44 MB, 13 us at 3.35 TB/s; the products, 4 * H * hd per
// (query, position), are ~1.4 GFLOP, 1.4 us on the bf16 tensor cores. So
// the bound is bytes. This first version keeps both products and the
// softmax on the CUDA cores in f32 and stages pages synchronously: with
// S * G = 35 rows, the [35, ps] score tile is the first decode-attention
// shape here with enough rows for mma (and wgmma at 64 rows), and that,
// cp.async/TMA double buffering and split-K are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScore = 8;     // query rows a warp scores per pass
constexpr int kAcc = 8;       // accumulators per thread: a tile is <= 8 * (256 / hd) rows
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr float kInvMaxInt8 = 1.0f / 127.5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Bytes of dynamic shared memory (K2's layout with the tile's query rows in
// place of its heads): the scores of ppb pages [rows, ppb * ps] first (16-byte
// aligned rows for float4 reads), q [rows, hd] and m/l/alpha [rows] in f32,
// one staged page [ps, hd] in its stored type, and that page's scales [ps].
__host__ __device__ __forceinline__ size_t smem_bytes(int rows, int hd, int ps, int ppb,
                                                     size_t elem) {
  const size_t floats = (size_t)rows * ppb * ps + (size_t)rows * hd + 3 * (size_t)rows;
  return align16(4 * floats) + align16((size_t)ps * hd * elem) + 4 * (size_t)ps;
}

// Copy rows [0, rows) of one page (and their int8 scales) into shared
// memory. The page starts 16-byte aligned (the wrapper checks the base and
// that a page is a multiple of 16 bytes), so a rounded-up vector count stays
// inside the page.
template <typename KVT>
__device__ __forceinline__ void stage_page(KVT* dst, float* sc_dst, const KVT* src,
                                           const float* sc_src, int rows, int hd) {
  const int nvec = (int)((size_t(rows) * hd * sizeof(KVT) + 15) / 16);
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < nvec; i += kThreads) d[i] = s[i];
  if (sc_src != nullptr) {
    for (int t = threadIdx.x; t < rows; t += kThreads) sc_dst[t] = sc_src[t];
  }
}

// kLanes = hd / 32 values of a K row per lane (1 for hd <= 32). Grid (tiles, batch, num_kv_heads); the block
// serves query rows [tile * tile_rows, min(+tile_rows, S * G)) of its
// (row, kv head).
template <typename QT, typename KVT, int kLanes>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pages,
                    const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ tables, QT* __restrict__ out, int s_len,
                    int num_q_heads, int groups, int hd, int total_pages, int ps, int pps,
                    int ppb, int tile_rows) {
  constexpr bool kQuant = sizeof(KVT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, kvh = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blk_cols = ppb * ps;
  const int r0 = blockIdx.x * tile_rows;
  const int nrows = min(tile_rows, s_len * groups - r0);  // rows of this tile

  float* s_s = reinterpret_cast<float*>(smem);  // [tile_rows, ppb * ps] scores, then p
  float* q_s = s_s + tile_rows * blk_cols;      // [tile_rows, hd]
  float* m_s = q_s + tile_rows * hd;            // [tile_rows] running max
  float* l_s = m_s + tile_rows;                 // [tile_rows] running denominator
  float* a_s = l_s + tile_rows;                 // [tile_rows] this block's rescale
  const size_t floats =
      (size_t)tile_rows * blk_cols + (size_t)tile_rows * hd + 3 * (size_t)tile_rows;
  KVT* kv_s = reinterpret_cast<KVT*>(smem + align16(4 * floats));  // [ps, hd]
  float* sc_s = reinterpret_cast<float*>(smem + align16(4 * floats) +
                                         align16((size_t)ps * hd * sizeof(KVT)));  // [ps]

  // the thread's output column and rows: d = tid % hd, r = g0 + a * gsplit
  const int gsplit = kThreads / hd;
  const int d = tid % hd;
  const int g0 = tid / hd;

  const int length = lengths[b];
  // the block's own KV is resident: pages are live up to length + S
  const int span = min(length + s_len, pps * ps);
  const int npages = (span + ps - 1) / ps;

  // tile row rr is query row r = r0 + rr: draft position i = r / G, head
  // k * G + r % G; q and out hold it at ((b * S + i) * H + k * G + g) * hd
  for (int e = tid; e < nrows * hd; e += kThreads) {
    const int rr = e / hd, c = e % hd, r = r0 + rr;
    const size_t off = (((size_t)b * s_len + r / groups) * num_q_heads + (size_t)kvh * groups +
                        r % groups) * hd + c;
    q_s[rr * hd + c] = to_f32(q[off]);
  }
  for (int rr = tid; rr < nrows; rr += kThreads) {
    m_s[rr] = kNegInf;
    l_s[rr] = 0.0f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;

  const size_t page_elems = (size_t)ps * hd;
  const size_t head_pages = (size_t)kvh * total_pages;
  const int32_t* table = tables + (size_t)b * pps;

  for (int p0 = 0; p0 < npages; p0 += ppb) {
    const int nb = min(ppb, npages - p0);
    // 1. scores of the block's pages, each query row masked at its limit
    for (int i = 0; i < nb; ++i) {
      const int j = p0 + i;
      const int page = min(max(table[j], 0), total_pages - 1);
      const int rows = min(ps, span - j * ps);  // positions staged
      __syncthreads();  // the previous page's readers are done with kv_s
      stage_page(kv_s, sc_s, k_pages + (head_pages + page) * page_elems,
                 kQuant ? k_scales + (head_pages + page) * ps : nullptr, rows, hd);
      __syncthreads();
      for (int gc = 0; gc < nrows; gc += kScore) {
        float qr[kScore][kLanes];
        int lim[kScore];
#pragma unroll
        for (int a = 0; a < kScore; ++a) {
          const int rr = gc + a;
          lim[a] = length + (r0 + rr) / groups + 1;  // positions < lim are attended
#pragma unroll
          for (int r = 0; r < kLanes; ++r) {
            const int dd = lane + 32 * r;
            qr[a][r] = (rr < nrows && dd < hd) ? q_s[rr * hd + dd] : 0.0f;
          }
        }
        for (int t = warp; t < ps; t += kWarps) {
          float* col = s_s + i * ps + t;
          const int pos = j * ps + t;
          if (t >= rows) {  // past the block: masked, never read
            if (lane < kScore && gc + lane < nrows) col[(gc + lane) * blk_cols] = kNegInf;
            continue;
          }
          const float sc = kQuant ? sc_s[t] * kInvMaxInt8 : 1.0f;
          const KVT* row = kv_s + (size_t)t * hd;
          float kr[kLanes];
#pragma unroll
          for (int r = 0; r < kLanes; ++r) {
            const int dd = lane + 32 * r;
            kr[r] = dd < hd ? (kQuant ? to_f32(row[dd]) * sc : to_f32(row[dd])) : 0.0f;
          }
          float part[kScore];
#pragma unroll
          for (int a = 0; a < kScore; ++a) {
            float sum = 0.0f;
#pragma unroll
            for (int r = 0; r < kLanes; ++r) sum += qr[a][r] * kr[r];
            part[a] = sum;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
            for (int a = 0; a < kScore; ++a) part[a] += __shfl_xor_sync(kFull, part[a], o);
          }
          if (lane == 0) {
#pragma unroll
            for (int a = 0; a < kScore; ++a) {
              if (gc + a < nrows) col[(gc + a) * blk_cols] = pos < lim[a] ? part[a] : kNegInf;
            }
          }
        }
      }
    }
    __syncthreads();
    // 2. one online-softmax update per query row over the block's positions
    const int ncols = nb * ps;
    for (int rr = warp; rr < nrows; rr += kWarps) {
      float* srow = s_s + rr * blk_cols;
      float mx = kNegInf;
      for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, srow[c]);
      mx = warp_max(mx);
      const float m_old = m_s[rr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < ncols; c += 32) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[rr] = alpha;
        l_s[rr] = alpha * l_s[rr] + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int rr = g0 + a * gsplit;
      if (rr < nrows) acc[a] *= a_s[rr];
    }
    // 3. acc += p . v over the block's pages
    for (int i = 0; i < nb; ++i) {
      const int j = p0 + i;
      const int page = min(max(table[j], 0), total_pages - 1);
      const int rows = min(ps, span - j * ps);
      __syncthreads();
      stage_page(kv_s, sc_s, v_pages + (head_pages + page) * page_elems,
                 kQuant ? v_scales + (head_pages + page) * ps : nullptr, rows, hd);
      __syncthreads();
      const float* prow = s_s + i * ps;
      // four positions at a time: one float4 of p per row (the rows of s_s
      // and i * ps are multiples of 4 floats), accumulated in t order
      int t = 0;
      for (; t + 4 <= rows; t += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float raw = to_f32(kv_s[(size_t)(t + u) * hd + d]);
          v[u] = kQuant ? raw * (sc_s[t + u] * kInvMaxInt8) : raw;
        }
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const int rr = g0 + a * gsplit;
          if (rr < nrows) {
            const float4 p = *reinterpret_cast<const float4*>(prow + rr * blk_cols + t);
            acc[a] += p.x * v[0];
            acc[a] += p.y * v[1];
            acc[a] += p.z * v[2];
            acc[a] += p.w * v[3];
          }
        }
      }
      for (; t < rows; ++t) {
        const float raw = to_f32(kv_s[(size_t)t * hd + d]);
        const float v = kQuant ? raw * (sc_s[t] * kInvMaxInt8) : raw;
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const int rr = g0 + a * gsplit;
          if (rr < nrows) acc[a] += prow[rr * blk_cols + t] * v;
        }
      }
    }
    __syncthreads();  // s_s and a_s are rewritten by the next block
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int rr = g0 + a * gsplit;
    if (rr < nrows) {
      const int r = r0 + rr;
      const size_t off = (((size_t)b * s_len + r / groups) * num_q_heads +
                          (size_t)kvh * groups + r % groups) * hd + d;
      out[off] = from_f32<QT>(acc[a] / fmaxf(l_s[rr], 1e-30f));
    }
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *k_scales, *v_scales, *lengths, *tables;
  void* out;
  int batch, s_len, num_q_heads, num_kv_heads, hd, total_pages, ps, pps, ppb, tiles, tile_rows;
  cudaStream_t stream;
};

template <typename QT, typename KVT, int kLanes>
int launch_lanes(const Args& a) {
  const size_t smem = smem_bytes(a.tile_rows, a.hd, a.ps, a.ppb, sizeof(KVT));
  auto kernel = paged_verify_kernel<QT, KVT, kLanes>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.tiles, a.batch, a.num_kv_heads), kThreads, smem, a.stream>>>(
      (const QT*)a.q, (const KVT*)a.k_pages, (const KVT*)a.v_pages, (const float*)a.k_scales,
      (const float*)a.v_scales, (const int32_t*)a.lengths, (const int32_t*)a.tables, (QT*)a.out,
      a.s_len, a.num_q_heads, a.num_q_heads / a.num_kv_heads, a.hd, a.total_pages, a.ps, a.pps,
      a.ppb, a.tile_rows);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int launch(const Args& a) {
  switch (a.hd <= 32 ? 1 : a.hd / 32) {
    case 1: return launch_lanes<QT, KVT, 1>(a);
    case 2: return launch_lanes<QT, KVT, 2>(a);
    case 4: return launch_lanes<QT, KVT, 4>(a);
    case 8: return launch_lanes<QT, KVT, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT>
int launch_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0: return launch<QT, float>(a);
    case 1: return launch<QT, __nv_bfloat16>(a);
    case 2: return launch<QT, int8_t>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch grid (row_tiles, batch, num_kv_heads) on `stream` of `device`;
// returns the first CUDA error (0 = ok). q, out: [batch, s_len, num_q_heads,
// head_dim] in q_dtype (0 = f32, 1 = bf16), contiguous; k_pages, v_pages:
// [num_kv_heads, total_pages, page_size, head_dim] in kv_dtype (0 = f32,
// 1 = bf16, 2 = int8); k_scales, v_scales: f32 [num_kv_heads, total_pages,
// page_size, 1] for int8 pages, else null; lengths: int32 [batch], the tokens
// resident before the block; tables: int32 [batch, pps]. The S * G query
// rows of a (row, kv head) split into row_tiles tiles of tile_rows rows.
// The caller checks: head_dim divides 256, tile_rows <= 8 * (256 / head_dim),
// row_tiles * tile_rows >= s_len * G, page_size is a multiple of
// 4, a page is a multiple of 16 bytes, the pointers are 16-byte aligned,
// 1 <= pages_per_block <= pps, the shared memory fits.
int paged_verify_launch(const void* q, const void* k_pages, const void* v_pages,
                        const void* k_scales, const void* v_scales, const void* lengths,
                        const void* tables, void* out, int batch, int s_len, int num_q_heads,
                        int num_kv_heads, int head_dim, int total_pages, int page_size, int pps,
                        int pages_per_block, int row_tiles, int tile_rows,
                        int q_dtype, int kv_dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (batch <= 0) return (int)cudaGetLastError();
  if (tile_rows > kAcc * (kThreads / head_dim)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, lengths, tables, out,
               batch, s_len, num_q_heads, num_kv_heads, head_dim, total_pages, page_size, pps,
               pages_per_block, row_tiles, tile_rows, (cudaStream_t)stream};
  switch (q_dtype) {
    case 0: return launch_kv<float>(kv_dtype, a);
    case 1: return launch_kv<__nv_bfloat16>(kv_dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_verify_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
