// Paged decode attention for Hopper (sm_90a), K2: one query token per row,
// GQA, over a page table of bf16/f32 pages or int8 pages with compact
// per-token f32 scales.
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
// What bounds it. The function needs every K/V position some row attends to
// once: 2 * K * hd elements per position, plus the int8 scales, q and the
// output. A full prompt page shared by the n candidates of its prompt counts
// once. At B = 64 rows of length 1550 (4 prompts x 16 candidates, 2 shared
// prompt pages each), K = 4, hd = 128 in bf16 that is 172 MB, 52 us at
// 3.35 TB/s (int8: 89 MB, 27 us); the arithmetic (4 * H * length * hd per
// row, 1.4 GFLOP) is far below the tensor cores' rate. So the bound is
// bytes: the kernel has to keep enough of them in flight on every SM.
//
// Design: paged_common.cuh's body with S = 1 (K5's function at one draft
// position, the lengths taken one lower). The grid is (splits, B, K): the
// split over pages (flash-decoding) puts 4 splits of 4 pages under each
// (row, kv head) at 64 rows of a 14-page table and 7 of 2 at 16 rows, so
// the tail of a wave still fills the card; the partials merge in a second
// kernel of the call, in split order. With bf16 q the G <= 8 heads of a
// kv head are one m16 tile of q fragments held in registers; four warps
// each score 16 positions of a 64-position stage on the tensor cores
// (mma.sync m16n8k16) and add p . v transposed, o^T = v^T p^T with the
// heads along n = 8, which halves o's registers and the products, so that
// three blocks fit an SM (140 registers, a 2-stage cp.async ring of 32 KB
// stages). int8 pages: each warp converts the rows it reads to bf16 in
// shared memory (8 instructions per 4 values, exact), and the scales
// multiply score columns and p, not elements. f32 q takes the CUDA-core
// body. The shared prompt pages are read once per row; their reuse is left
// to the 50 MB L2. Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py's
// stanza, a CUDA graph over page copies past the L2; PERF.md): 64 x 1550
// bf16 0.079 ms (0.247 before), int8 0.076 (0.266), against bounds of
// 0.052 and 0.027; int8 is held back by its conversion instructions.

#include "paged_common.cuh"

extern "C" {

// Launch on `stream` of `device`; returns the first CUDA error (0 = ok).
// q, out: [batch, num_q_heads, head_dim] in q_dtype (0 = f32, 1 = bf16),
// contiguous; k_pages, v_pages: [num_kv_heads, total_pages, page_size,
// head_dim] in kv_dtype (0 = f32, 1 = bf16, 2 = int8); k_scales, v_scales:
// f32 [num_kv_heads, total_pages, page_size, 1] for int8 pages, else null;
// lengths: int32 [batch]; tables: int32 [batch, pps]. The table splits into
// `splits` ranges of pages_per_split pages (the last one ends at pps);
// workspace: f32 [splits * batch * num_q_heads * (head_dim + 2)] when
// splits > 1, else null. The query heads of a kv head take `row_tiles`
// blocks (ops/paged_native.py::plan_row_tiles; 1 at every preset). The
// caller checks: a block's rows at most 64, a row of a page a multiple of
// 16 bytes, the pointers 16-byte aligned, the shared memory within the card
// (ops/paged_native.py).
int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales, const void* lengths,
                           const void* tables, void* out, void* workspace, int batch,
                           int num_q_heads, int num_kv_heads, int head_dim, int total_pages,
                           int page_size, int pps, int splits, int pages_per_split,
                           int row_tiles, int q_dtype, int kv_dtype, int device,
                           void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const paged::Geometry g{batch, 1, num_q_heads, num_kv_heads, 0, 0, head_dim,
                          total_pages, page_size, pps, splits, pages_per_split, -1,
                          row_tiles, 0};
  const paged::Args a{q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                      out, workspace, q_dtype, kv_dtype, (cudaStream_t)stream};
  return paged::launch(a, g);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
