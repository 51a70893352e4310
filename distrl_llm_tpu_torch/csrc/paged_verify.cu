// Speculative draft-block verify attention for Hopper (sm_90a), K5: an
// S-query block per row, GQA, over a page table of bf16/f32 pages or int8
// pages with compact per-token f32 scales.
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
// What bounds it. The function needs every K/V position some row's block
// reaches once (2 * K * hd elements each, plus int8 scales), q and the
// output; a prompt page shared by a prompt's n candidates counts once. At
// 64 rows of ~600 positions (4 prompts x 16, 28 / 4 heads, hd 128, bf16
// pages) that is ~44 MB, 13 us at 3.35 TB/s; the products, 4 * H * hd per
// (query, position), are ~1.4 GFLOP, 1.4 us on the bf16 tensor cores. So
// the bound is bytes, and each K/V byte must be read once for all S * G
// query rows of its (row, kv head).
//
// Design: paged_common.cuh's body, K2's with the S draft positions folded
// into the query rows. Up to 64 rows, all S * G rows of a (row, kv head)
// sit in one block (35 at Qwen2.5-7B with d = 4: three m16 tiles held as
// mma A fragments), so each page is read once; the earlier version split
// them into three tiles of 12 rows for its per-thread accumulators and read
// every page three times. Twelve warps, four per m-tile, each on 32
// positions of a 128-position stage, one block an SM: a 2-stage cp.async
// ring of K and V tiles, the scores masked per query at its own limit
// lengths + i + 1 on the fragments; the split over pages and its merge as
// in K2 (a row whose reach fits one split writes its output directly).
// int8 pages: the block converts each stage to bf16 once for its three
// m-tiles. f32 q takes the CUDA-core body.
//
// Past 64 rows (d >= 9 at G 7, d >= 8 at G 8, up to 17 x 8 = 136 rows at
// d = 16) the rows split into the fewest balanced row tiles of at most 64
// (ops/paged_native.py::plan_row_tiles): 91 rows take two blocks of 46, 136
// three of 46, 46 and 44, each on the tuned three-m-tile block above. A
// tile reads its pages again, but the tiles of a split are neighbours in
// the grid and run together, so the second read is meant to come from the
// L2 (chip_smoke.py's K5 stanza times it beside the byte bound). More
// m-tiles in one block (6 at 91 rows, 9 at 136) would read each page once
// but need 18-36 warps' registers a block, and the CUDA-core body at
// head_dim 256 (Gemma) cannot hold 136 rows' q and acc in shared memory at
// all (~2.2 KB a row): one mechanism serves both bodies and every
// existing shape keeps its block.
//
// Measured at S 5 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py's stanza, a
// CUDA graph over page copies past the L2; PERF.md): bf16 0.062 ms (0.440
// before), int8 0.073 (0.478), against the unrolled 5 x K2's 0.19 and 0.22
// and bounds of 0.016 and 0.009.

#include "paged_common.cuh"

extern "C" {

// Launch on `stream` of `device`; returns the first CUDA error (0 = ok).
// q, out: [batch, s_len, num_q_heads, head_dim] in q_dtype (0 = f32, 1 =
// bf16), contiguous; k_pages, v_pages: [num_kv_heads, total_pages,
// page_size, head_dim] in kv_dtype (0 = f32, 1 = bf16, 2 = int8); k_scales,
// v_scales: f32 [num_kv_heads, total_pages, page_size, 1] for int8 pages,
// else null; lengths: int32 [batch], the tokens resident before the block;
// tables: int32 [batch, pps]. The table splits into `splits` ranges of
// pages_per_split pages; workspace: f32 [splits * batch * s_len *
// num_q_heads * (head_dim + 2)] when splits > 1, else null. The s_len *
// (num_q_heads / num_kv_heads) query rows of a (row, kv head) take
// `row_tiles` blocks of at most 64 rows, none empty. The caller checks: a
// row of a page a multiple of 16 bytes, the pointers 16-byte aligned, the
// shared memory of a block within the card (ops/paged_native.py).
int paged_verify_launch(const void* q, const void* k_pages, const void* v_pages,
                        const void* k_scales, const void* v_scales, const void* lengths,
                        const void* tables, void* out, void* workspace, int batch, int s_len,
                        int num_q_heads, int num_kv_heads, int head_dim, int total_pages,
                        int page_size, int pps, int splits, int pages_per_split, int row_tiles,
                        int q_dtype, int kv_dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const paged::Geometry g{batch, s_len, num_q_heads, num_kv_heads, 0, 0, head_dim,
                          total_pages, page_size, pps, splits, pages_per_split, 0,
                          row_tiles, 0};
  const paged::Args a{q, k_pages, v_pages, k_scales, v_scales, lengths, tables,
                      out, workspace, q_dtype, kv_dtype, (cudaStream_t)stream};
  return paged::launch(a, g);
}

const char* paged_verify_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
