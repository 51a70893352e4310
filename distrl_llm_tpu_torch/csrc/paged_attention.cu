// Paged decode attention for Hopper (sm_90a): one query token per row, GQA,
// over a page table of bf16/f32 pages or int8 pages with compact per-token
// f32 scales.
//
// Replaces the TPU kernels of the JAX package that compute this one function:
//   distrl_llm_tpu/ops/paged_native.py::paged_attention_native   (grid B,K,pps)
//   distrl_llm_tpu/ops/paged_native.py::paged_attention_native_folded (B,pps)
//   distrl_llm_tpu/ops/paged_native.py::paged_attention_native_blocked
//                                                      (B, ceil(pps / ppb))
// and the jaxlib launches distrl_llm_tpu/ops/paged_int8.py::
// paged_attention_gqa / paged_attention_int8. For each row b and kv head k,
// with G = H / K query heads per kv head:
//   q      [G, hd], already scaled by hd^-0.5
//   pages  tables[b, j] clipped to [0, total_pages - 1], for j * ps < length
//   s      = q . k^T in f32, NEG_INF (-1e30) at positions >= length
//   int8   k = w * (scale * (1 / 127.5)), the same for v
//   out    online softmax in f32; acc / max(l, 1e-30) in q's dtype, so a row
//          of length 0 gives 0, never NaN; head h = k * G + g.
//
// Design. Grid (B, K): one block of 256 threads per (row, kv head) serves
// that head's G query heads (G = 7 at Qwen2.5-7B), so each K/V byte of the
// row is read once for all G heads. The block walks the row's pages in
// blocks of `ppb` pages. For each page it stages the K page [ps, hd] in its
// stored type in shared memory (16-byte vector loads; 32 KB at ps = hd = 128
// in bf16), and each warp scores one position at a time for up to 8 heads
// (lanes split hd and hold q in registers; one butterfly, interleaved over
// the heads, sums them all). After the ppb pages one online softmax update
// runs per head (a warp per head), then the V pages are staged the same way
// and every thread accumulates p . v for one hd column and up to 8 heads in
// registers, reading p four positions at a time. Pages past the length are not read at
// all, and positions past the length inside the last page are neither
// scored nor accumulated, so garbage there is never touched.
//
// What bounds it. The function needs every K/V position some row attends to
// once: 2 * K * hd elements per position, plus the int8 scales, q and the
// output. A full prompt page shared by the n candidates of its prompt counts
// once. At B = 64 rows of length 1550 (4 prompts x 16 candidates, 2 shared
// prompt pages each), K = 4, hd = 128 in bf16 that is 172 MB, 52 us at
// 3.35 TB/s; the arithmetic (4 * H * length * hd per row, 1.4 GFLOP) is far
// below the tensor cores' rate, so the bound is bytes. This kernel reads the
// shared pages once per row and leaves their reuse to the 50 MB L2; a later
// version may stage a shared page once for all the rows that read it. This
// first version keeps the softmax and both products
// on the CUDA cores in f32 and stages pages synchronously; split-K over the
// pages (flash-decoding, for few rows at long lengths), cp.async/TMA double
// buffering and mma for the G x ps scores are for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 8;    // accumulators per thread: G <= 8 * (256 / hd)
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

// Bytes of dynamic shared memory: the scores of ppb pages [G, ppb * ps]
// (first, so its rows are 16-byte aligned for float4 reads), q [G, hd] and
// m/l/alpha [G] in f32, one staged page [ps, hd] in its stored type, and
// that page's scales [ps] (int8 only, reserved always).
__host__ __device__ __forceinline__ size_t smem_bytes(int groups, int hd, int ps, int ppb,
                                                     size_t elem) {
  const size_t floats = (size_t)groups * ppb * ps + (size_t)groups * hd + 3 * (size_t)groups;
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

// kLanes = hd / 32 values of a K row per lane (1 for hd <= 32)
template <typename QT, typename KVT, int kLanes>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pages,
                       const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ tables, QT* __restrict__ out, int groups,
                       int hd, int total_pages, int ps, int pps, int ppb) {
  constexpr bool kQuant = sizeof(KVT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blk_cols = ppb * ps;

  float* s_s = reinterpret_cast<float*>(smem);  // [G, ppb * ps] scores, then p
  float* q_s = s_s + groups * blk_cols;         // [G, hd]
  float* m_s = q_s + groups * hd;               // [G] running max
  float* l_s = m_s + groups;                    // [G] running denominator
  float* a_s = l_s + groups;                    // [G] this block's rescale
  const size_t floats = (size_t)groups * blk_cols + (size_t)groups * hd + 3 * (size_t)groups;
  KVT* kv_s = reinterpret_cast<KVT*>(smem + align16(4 * floats));  // [ps, hd]
  float* sc_s = reinterpret_cast<float*>(smem + align16(4 * floats) +
                                         align16((size_t)ps * hd * sizeof(KVT)));  // [ps]

  // this block's G heads, [G, hd] contiguous in q and out
  const size_t head0 = ((size_t)b * gridDim.y + kvh) * groups * hd;
  // the thread's output column and heads: d = tid % hd, g = g0 + a * gsplit
  const int gsplit = kThreads / hd;
  const int d = tid % hd;
  const int g0 = tid / hd;

  const int length = min(lengths[b], pps * ps);  // the table covers pps pages
  if (length <= 0) {
    for (int i = tid; i < groups * hd; i += kThreads) out[head0 + i] = from_f32<QT>(0.0f);
    return;
  }
  const int npages = (length + ps - 1) / ps;

  for (int i = tid; i < groups * hd; i += kThreads) q_s[i] = to_f32(q[head0 + i]);
  for (int g = tid; g < groups; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.0f;

  const size_t page_elems = (size_t)ps * hd;
  const size_t head_pages = (size_t)kvh * total_pages;
  const int32_t* table = tables + (size_t)b * pps;

  for (int p0 = 0; p0 < npages; p0 += ppb) {
    const int nb = min(ppb, npages - p0);
    // 1. scores of the block's pages
    for (int i = 0; i < nb; ++i) {
      const int j = p0 + i;
      const int page = min(max(table[j], 0), total_pages - 1);
      const int rows = min(ps, length - j * ps);
      __syncthreads();  // the previous page's readers are done with kv_s
      stage_page(kv_s, sc_s, k_pages + (head_pages + page) * page_elems,
                 kQuant ? k_scales + (head_pages + page) * ps : nullptr, rows, hd);
      __syncthreads();
      // each warp scores one position at a time for up to kMaxAcc heads:
      // lanes split hd, then one interleaved butterfly sums all the heads
      for (int gc = 0; gc < groups; gc += kMaxAcc) {
        float qr[kMaxAcc][kLanes];
#pragma unroll
        for (int a = 0; a < kMaxAcc; ++a) {
#pragma unroll
          for (int r = 0; r < kLanes; ++r) {
            const int g = gc + a, dd = lane + 32 * r;
            qr[a][r] = (g < groups && dd < hd) ? q_s[g * hd + dd] : 0.0f;
          }
        }
        for (int t = warp; t < ps; t += kWarps) {
          float* col = s_s + i * ps + t;
          if (t >= rows) {  // past the length: masked, never read
            if (lane < kMaxAcc && gc + lane < groups) col[(gc + lane) * blk_cols] = kNegInf;
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
          float part[kMaxAcc];
#pragma unroll
          for (int a = 0; a < kMaxAcc; ++a) {
            float sum = 0.0f;
#pragma unroll
            for (int r = 0; r < kLanes; ++r) sum += qr[a][r] * kr[r];
            part[a] = sum;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
            for (int a = 0; a < kMaxAcc; ++a) part[a] += __shfl_xor_sync(kFull, part[a], o);
          }
          if (lane == 0) {
#pragma unroll
            for (int a = 0; a < kMaxAcc; ++a) {
              if (gc + a < groups) col[(gc + a) * blk_cols] = part[a];
            }
          }
        }
      }
    }
    __syncthreads();
    // 2. one online-softmax update per head over the block's ncols positions
    const int ncols = nb * ps;
    for (int g = warp; g < groups; g += kWarps) {
      float* srow = s_s + g * blk_cols;
      float mx = kNegInf;
      for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, srow[c]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
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
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int g = g0 + a * gsplit;
      if (g < groups) acc[a] *= a_s[g];
    }
    // 3. acc += p . v over the block's pages
    for (int i = 0; i < nb; ++i) {
      const int j = p0 + i;
      const int page = min(max(table[j], 0), total_pages - 1);
      const int rows = min(ps, length - j * ps);
      __syncthreads();
      stage_page(kv_s, sc_s, v_pages + (head_pages + page) * page_elems,
                 kQuant ? v_scales + (head_pages + page) * ps : nullptr, rows, hd);
      __syncthreads();
      const float* prow = s_s + i * ps;
      // four positions at a time: one float4 of p per head (the rows of
      // s_s and i * ps are multiples of 4 floats), accumulated in t order
      int t = 0;
      for (; t + 4 <= rows; t += 4) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float raw = to_f32(kv_s[(size_t)(t + j) * hd + d]);
          v[j] = kQuant ? raw * (sc_s[t + j] * kInvMaxInt8) : raw;
        }
#pragma unroll
        for (int a = 0; a < kMaxAcc; ++a) {
          const int g = g0 + a * gsplit;
          if (g < groups) {
            const float4 p = *reinterpret_cast<const float4*>(prow + g * blk_cols + t);
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
        for (int a = 0; a < kMaxAcc; ++a) {
          const int g = g0 + a * gsplit;
          if (g < groups) acc[a] += prow[g * blk_cols + t] * v;
        }
      }
    }
    __syncthreads();  // s_s and a_s are rewritten by the next block
  }
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int g = g0 + a * gsplit;
    if (g < groups) out[head0 + (size_t)g * hd + d] = from_f32<QT>(acc[a] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename QT, typename KVT, int kLanes>
int launch_lanes(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                 const void* v_scales, const void* lengths, const void* tables, void* out,
                 int batch, int groups, int num_kv_heads, int hd, int total_pages, int ps,
                 int pps, int ppb, cudaStream_t stream) {
  const size_t smem = smem_bytes(groups, hd, ps, ppb, sizeof(KVT));
  auto kernel = paged_attention_kernel<QT, KVT, kLanes>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(batch, num_kv_heads), kThreads, smem, stream>>>(
      (const QT*)q, (const KVT*)k_pages, (const KVT*)v_pages, (const float*)k_scales,
      (const float*)v_scales, (const int32_t*)lengths, (const int32_t*)tables, (QT*)out, groups,
      hd, total_pages, ps, pps, ppb);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
           const void* v_scales, const void* lengths, const void* tables, void* out, int batch,
           int groups, int num_kv_heads, int hd, int total_pages, int ps, int pps, int ppb,
           cudaStream_t stream) {
  switch (hd <= 32 ? 1 : hd / 32) {
    case 1:
      return launch_lanes<QT, KVT, 1>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                                      out, batch, groups, num_kv_heads, hd, total_pages, ps,
                                      pps, ppb, stream);
    case 2:
      return launch_lanes<QT, KVT, 2>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                                      out, batch, groups, num_kv_heads, hd, total_pages, ps,
                                      pps, ppb, stream);
    case 4:
      return launch_lanes<QT, KVT, 4>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                                      out, batch, groups, num_kv_heads, hd, total_pages, ps,
                                      pps, ppb, stream);
    case 8:
      return launch_lanes<QT, KVT, 8>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                                      out, batch, groups, num_kv_heads, hd, total_pages, ps,
                                      pps, ppb, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename QT>
int launch_kv(int kv_dtype, const void* q, const void* k_pages, const void* v_pages,
              const void* k_scales, const void* v_scales, const void* lengths,
              const void* tables, void* out, int batch, int groups, int num_kv_heads, int hd,
              int total_pages, int ps, int pps, int ppb, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, out,
                               batch, groups, num_kv_heads, hd, total_pages, ps, pps, ppb, stream);
    case 1:
      return launch<QT, __nv_bfloat16>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                                       out, batch, groups, num_kv_heads, hd, total_pages, ps,
                                       pps, ppb, stream);
    case 2:
      return launch<QT, int8_t>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, out,
                                batch, groups, num_kv_heads, hd, total_pages, ps, pps, ppb,
                                stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch grid (batch, num_kv_heads) on `stream` of `device`; returns the
// first CUDA error (0 = ok). q, out: [batch, num_q_heads, head_dim] in
// q_dtype (0 = f32, 1 = bf16), contiguous; k_pages, v_pages: [num_kv_heads,
// total_pages, page_size, head_dim] in kv_dtype (0 = f32, 1 = bf16, 2 =
// int8); k_scales, v_scales: f32 [num_kv_heads, total_pages, page_size, 1]
// for int8 pages, else null; lengths: int32 [batch]; tables: int32 [batch,
// pps]. The caller checks: head_dim divides 256, page_size is a multiple of
// 4, a page is a multiple of 16 bytes, the pointers are 16-byte aligned,
// 1 <= pages_per_block <= pps.
int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales, const void* lengths,
                           const void* tables, void* out, int batch, int num_q_heads,
                           int num_kv_heads, int head_dim, int total_pages, int page_size,
                           int pps, int pages_per_block, int q_dtype, int kv_dtype, int device,
                           void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (batch <= 0) return (int)cudaGetLastError();
  const int groups = num_q_heads / num_kv_heads;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                              out, batch, groups, num_kv_heads, head_dim, total_pages, page_size,
                              pps, pages_per_block, s);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales, v_scales, lengths,
                                      tables, out, batch, groups, num_kv_heads, head_dim,
                                      total_pages, page_size, pps, pages_per_block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
