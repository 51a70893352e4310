// Causal flash attention with key padding and native GQA for Hopper
// (sm_90a): a forward kernel and a backward of three kernels.
//
// Replaces the TPU kernels the JAX package reaches for learner and prefill
// attention, which compute one function:
//   distrl_llm_tpu/ops/flash_attention.py::flash_attention (jaxlib's Pallas
//     flash kernel, its custom VJP _flash_attention_bwd_dkv / _bwd_dq; K/V
//     repeated to H heads before the call)
//   distrl_llm_tpu/ops/splash.py::splash_attention (jaxlib's splash MQA
//     kernel, _splash_attention_fwd / _bwd_dq / _bwd_dkv; GQA native)
//
// Function. q [B, S, H, hd]; k, v [B, S, K, hd]; key_valid int32 [B, S];
// G = H / K query heads per kv head, head h reads kv head h / G:
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G]) . v
// over the keys j <= i with key_valid[b, j] != 0, scores and softmax in f32,
// the output in q's type. A row with no such key (a left-pad position
// before the row's first real token) gives 0 and its log-sum-exp is stored
// as 0; no -inf or NaN reaches memory. The backward returns dq, dk, dv in
// the input type, each accumulated in f32; dk and dv sum over the G query
// heads of their kv head. Every output element is written by exactly one
// block (no atomics), so two runs give identical bits.
//
// What bounds it. The causal pairs whose key is valid need 4 hd flops each
// forward (q.k and p.v) and 10 hd backward (s, dp, dv, dk, dq); at the
// learner's [8, 1550, 28 / 4, 128] that is 1.38e11 and 3.45e11 flops,
// 0.14 ms and 0.35 ms at the bf16 tensor cores' 989 TFLOP/s. The dq kernel
// recomputes s and dp rather than add into dq from the dk/dv blocks with
// atomics: 4 hd flops more per pair (14 hd in all, 4.83e11), the price of a
// deterministic backward. The bytes (q, k, v, out once, ~100 MB in bf16)
// bound less. So the products must run on the tensor cores.
//
// bf16 (the main path): FlashAttention-2 on mma.sync m16n8k16 (bf16
// operands, f32 sums). Tiles of 64 keys x hd in shared memory, their
// 16-byte chunks XOR-swizzled by row so that ldmatrix reads them without
// bank conflicts, filled by cp.async (16 bytes a thread) in a ring.
//   forward: a block of 8 warps per (128 query rows, head, batch), each warp
//            16 rows with its Q fragments in registers; a 3-stage K/V ring;
//            s = q k^T, the online softmax in f32 registers (exp2 domain,
//            row statistics reduced over the 4 lanes of a row), p rounded
//            to bf16 in registers as the A operand of o += p v (v through
//            ldmatrix.trans); o divided by l once at the end.
//   delta:   one warp per (b, i, h): rowsum(dout * out), f32.
//   dk / dv: a block of 4 warps per (64 keys, kv head, batch), K and V
//            resident in shared memory, dk and dv in registers; over its G
//            heads and the query tiles from the causal start it streams Q,
//            dO, lse and delta through a 2-stage ring and runs the
//            transposed products: s^T = K Q^T, p^T = exp(scale s^T - lse),
//            dv += p^T dO, dp^T = V dO^T, ds^T = p^T (dp^T - delta), dk +=
//            ds^T Q (scaled once at the end); p and ds rounded to bf16 as
//            operands.
//   dq:      a block of 4 warps per (64 query rows, head, batch), Q and dO
//            resident; over the key tiles it recomputes s and dp and adds
//            dq += ds K.
// Masking: a block first lists its causal key tiles that hold a valid key
// (with each tile's 64 validity bits); tiles with none are skipped, as
// jaxlib's splash skips masked blocks, and only tiles that cross the
// diagonal or hold an invalid key are masked element by element. The
// forward's and dq's query tiles, and dk/dv's key tiles, run in the order
// longest first (the slowest grid axis, reversed for the query tiles).
// GQA: the G = 7 heads of a kv head are neighbouring blocks of one launch,
// so their K/V tiles come from L2 after the first read; nothing is packed.
//
// Head dim 256 (the Gemma family): a warp's 16 x 256 f32 accumulator would
// be 128 registers a thread (dk and dv together 256), and the forward's Q
// tile plus three 64-key K/V stages 256 KB. So each warp of the three
// kernels above becomes a warp pair: both warps compute the same scores
// over the full hd and each keeps the P.V, dS.K, P^T.dO and dS^T.Q products
// of its half of the output columns (the score products run twice, 1.5x
// the forward's flops); the forward takes 64 query rows a block and a
// 2-stage ring (160 KB), dk/dv streams 32 query rows a stage (128.5 KB),
// dq keeps 64 rows and its 2 stages (192 KB). The f32 forward keeps its
// 64 x 64 tiles (214,016 bytes); the f32 backward takes 32 x 32 tiles
// (136,064 bytes; 64 x 64 would be 280,320, over the 232,448 a block may
// have).
//
// f32 (full fine-tuning's learner, which trains f32 master weights, and the
// f32 parity runs): every product on the CUDA cores in f32, never TF32 or
// bf16 operands. Tiles of TL query rows by TL keys (64; the backward's 32 at
// hd 256), f32 in shared memory (rows padded to hd + 1 floats), 256 threads
// as a 16 x 16 grid, thread (ty, tx) owning rows ty + 16 i and columns tx +
// 16 j; the same three backward kernels with grids (S / TL, K, B) and
// (S / TL, H, B).
//
// Any S works: tails are masked, never padded in memory.
//
// Measured (chip_smoke.py's K4 stanza at the learner's [8, 1550, 28 / 4,
// 128] bf16, NVIDIA H100 80GB HBM3 at 700 W; the rest in PERF.md): forward
// 0.70-0.74 ms, backward 1.83-1.91 ms, against scaled_dot_product_attention's
// 0.99-1.03 and 3.29-3.53 and this file's earlier CUDA-core f32 tiles, 6.8
// and 28.9 ms; the bf16 learner step fell from ~20.1 s to ~11.2 s. At hd 256
// ([8, 1550, 8 / 1, 256]): bf16 0.53 / 2.44 ms, f32 5.68 / 30.89 ms (SDPA
// 1.14 / 2.85 and 6.15 / 9.58); ptxas spills nothing in any hd 256 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // the f32 forward's query rows and keys per tile
constexpr unsigned kFull = 0xffffffffu;

// the f32 backward's tile: 64 rows, or 32 at head_dim 256, where four
// [64][257] f32 tiles (280,320 bytes) would not fit a block's 232,448
template <int HD>
__host__ __device__ constexpr int f32_bwd_tile() { return HD > 128 ? 32 : 64; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// max / sum over the 16 lanes of a half-warp (xor offsets below 16 stay in it)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// rows [r0, r0 + TL) of head `h` of a [B, S, nh, HD] tensor into shared
// memory rows of `ld` floats; rows at or past S are zero
template <typename T, int HD, int TL>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src, int b,
                                          int r0, int seq, int nh, int h) {
  for (int e = threadIdx.x; e < TL * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int i = r0 + r;
    dst[r * ld + d] = i < seq ? to_f32(src[(((size_t)b * seq + i) * nh + h) * HD + d]) : 0.0f;
  }
}

template <int TL>
__device__ __forceinline__ void load_valid(int* dst, const int32_t* __restrict__ key_valid,
                                           int b, int k0, int seq) {
  for (int c = threadIdx.x; c < TL; c += kThreads) {
    dst[c] = (k0 + c < seq) ? (key_valid[(size_t)b * seq + k0 + c] != 0) : 0;
  }
}

// acc[i][j] += sum_d a[(ty + 16 i) * LD + d] * b[(tx + 16 j) * LD + d]:
// a TL x TL tile (TL = 16 RI) of a . b^T with both operands row-major over hd
template <int HD, int RI>
__device__ __forceinline__ void tile_nt(float (&acc)[RI][RI], const float* a, const float* bm,
                                        int ty, int tx) {
  constexpr int LD = HD + 1;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[RI], bv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < RI; ++j) bv[j] = bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < RI; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// shared memory of the forward: q, k, v tiles [TL][HD + 1], p [TL][TL],
// the tile's key validity [TL]
template <int HD, int TL>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * TL * (HD + 1) + TL * TL) + sizeof(int) * TL;
}

// the backward kernels: four [TL][HD + 1] tiles, one [TL][TL] tile, TL
// key-validity flags and, for dk/dv, lse and delta of a query tile
template <int HD, int TL>
constexpr size_t bwd_smem() {
  return sizeof(float) * (4 * TL * (HD + 1) + TL * TL + 2 * TL) + sizeof(int) * TL;
}

template <typename T, int HD, int TL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ key_valid, T* __restrict__ out,
                 float* __restrict__ lse, int seq, int nh, int nkv, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  constexpr int RI = TL / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + TL * LD;
  float* v_s = k_s + TL * LD;
  float* p_s = v_s + TL * LD;  // [TL][TL]
  int* valid_s = reinterpret_cast<int*>(p_s + TL * TL);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * TL;

  load_tile<T, HD, TL>(q_s, LD, q, b, q0, seq, nh, h);
  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int kend = min(seq, q0 + TL);
  for (int k0 = 0; k0 < kend; k0 += TL) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD, TL>(k_s, LD, k, b, k0, seq, nkv, kvh);
    load_tile<T, HD, TL>(v_s, LD, v, b, k0, seq, nkv, kvh);
    load_valid<TL>(valid_s, key_valid, b, k0, seq);
    __syncthreads();

    float s[RI][RI] = {};
    tile_nt<HD, RI>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool ok = k0 + c <= r && valid_s[c];
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.0f, rs = 0.0f;
      if (m_new != -INFINITY) {  // else no valid key yet: p = 0, nothing rescales
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = 0.0f;
      }
      rs = half_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < RI; ++j) p_s[(ty + 16 * i) * TL + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    // acc += p . v
#pragma unroll 4
    for (int c = 0; c < TL; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = p_s[(ty + 16 * i) * TL + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
    const bool any = l[i] > 0.0f;
    T* o = out + (((size_t)b * seq + r) * nh + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = from_f32<T>(any ? acc[i][j] / l[i] : 0.0f);
    if (tx == 0) lse[((size_t)b * nh + h) * seq + r] = any ? m[i] + logf(l[i]) : 0.0f;
  }
}

// delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d], one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ delta, int batch, int seq, int nh, int hd) {
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)batch * seq * nh) return;
  const T* o = out + row * hd;
  const T* g = dout + row * hd;
  float sum = 0.0f;
  for (int d = lane; d < hd; d += 32) sum = fmaf(to_f32(o[d]), to_f32(g[d]), sum);
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) {
    // row = (b * S + i) * H + h  ->  delta[(b * H + h) * S + i]
    const int h = (int)(row % nh);
    const size_t bi = row / nh;
    const int i = (int)(bi % seq);
    const size_t b = bi / seq;
    delta[(b * nh + h) * seq + i] = sum;
  }
}

template <typename T, int HD, int TL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int32_t* __restrict__ key_valid, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int seq, int nh, int nkv,
                     float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  constexpr int RI = TL / 16;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + TL * LD;
  float* q_s = v_s + TL * LD;
  float* do_s = q_s + TL * LD;
  float* ds_s = do_s + TL * LD;  // [TL q][TL k]: p, then ds
  float* lse_s = ds_s + TL * TL;
  float* delta_s = lse_s + TL;
  int* valid_s = reinterpret_cast<int*>(delta_s + TL);

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int groups = nh / nkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * TL;

  load_tile<T, HD, TL>(k_s, LD, k, b, k0, seq, nkv, kvh);
  load_tile<T, HD, TL>(v_s, LD, v, b, k0, seq, nkv, kvh);
  load_valid<TL>(valid_s, key_valid, b, k0, seq);
  float dk_acc[RI][DJ] = {}, dv_acc[RI][DJ] = {};

  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    const float* lse_h = lse + ((size_t)b * nh + h) * seq;
    const float* delta_h = delta + ((size_t)b * nh + h) * seq;
    for (int q0 = k0; q0 < seq; q0 += TL) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD, TL>(q_s, LD, q, b, q0, seq, nh, h);
      load_tile<T, HD, TL>(do_s, LD, dout, b, q0, seq, nh, h);
      for (int r = threadIdx.x; r < TL; r += kThreads) {
        lse_s[r] = q0 + r < seq ? lse_h[q0 + r] : 0.0f;
        delta_s[r] = q0 + r < seq ? delta_h[q0 + r] : 0.0f;
      }
      __syncthreads();

      // p[q][k] = exp(scale s - lse) on the unmasked pairs, else 0
      float p[RI][RI] = {};
      tile_nt<HD, RI>(p, q_s, k_s, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int c = tx + 16 * j;
          const bool ok = r < seq && k0 + c <= r && valid_s[c];
          p[i][j] = ok ? expf(p[i][j] * scale - lse_s[ty + 16 * i]) : 0.0f;
          ds_s[(ty + 16 * i) * TL + c] = p[i][j];
        }
      }
      __syncthreads();
      // dv[k][d] += sum_q p[q][k] dout[q][d]
#pragma unroll 4
      for (int r = 0; r < TL; ++r) {
        float pk[RI], gv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) pk[i] = ds_s[r * TL + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) gv[j] = do_s[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) dv_acc[i][j] = fmaf(pk[i], gv[j], dv_acc[i][j]);
        }
      }
      // dp[q][k] = dout[q] . v[k]; ds = p (dp - delta)
      float dp[RI][RI] = {};
      tile_nt<HD, RI>(dp, do_s, v_s, ty, tx);
      __syncthreads();  // every reader of p in ds_s is done
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          ds_s[(ty + 16 * i) * TL + tx + 16 * j] =
              p[i][j] * (dp[i][j] - delta_s[ty + 16 * i]);
        }
      }
      __syncthreads();
      // dk[k][d] += sum_q ds[q][k] q[q][d]  (scaled once at the end)
#pragma unroll 4
      for (int r = 0; r < TL; ++r) {
        float sk[RI], qv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) sk[i] = ds_s[r * TL + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) qv[j] = q_s[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) dk_acc[i][j] = fmaf(sk[i], qv[j], dk_acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= seq) continue;
    const size_t base = (((size_t)b * seq + c) * nkv + kvh) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv[base + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int HD, int TL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ key_valid, const float* __restrict__ lse,
                    const float* __restrict__ delta, const T* __restrict__ dout,
                    T* __restrict__ dq, int seq, int nh, int nkv, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  constexpr int RI = TL / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + TL * LD;
  float* k_s = do_s + TL * LD;
  float* v_s = k_s + TL * LD;
  float* ds_s = v_s + TL * LD;  // [TL q][TL k]
  int* valid_s = reinterpret_cast<int*>(ds_s + TL * TL + 2 * TL);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * TL;

  load_tile<T, HD, TL>(q_s, LD, q, b, q0, seq, nh, h);
  load_tile<T, HD, TL>(do_s, LD, dout, b, q0, seq, nh, h);
  float lse_r[RI], delta_r[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    const size_t at = ((size_t)b * nh + h) * seq + r;
    lse_r[i] = r < seq ? lse[at] : 0.0f;
    delta_r[i] = r < seq ? delta[at] : 0.0f;
  }
  float dq_acc[RI][DJ] = {};

  const int kend = min(seq, q0 + TL);
  for (int k0 = 0; k0 < kend; k0 += TL) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD, TL>(k_s, LD, k, b, k0, seq, nkv, kvh);
    load_tile<T, HD, TL>(v_s, LD, v, b, k0, seq, nkv, kvh);
    load_valid<TL>(valid_s, key_valid, b, k0, seq);
    __syncthreads();

    float s[RI][RI] = {}, dp[RI][RI] = {};
    tile_nt<HD, RI>(s, q_s, k_s, ty, tx);
    tile_nt<HD, RI>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool ok = r < seq && k0 + c <= r && valid_s[c];
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        ds_s[(ty + 16 * i) * TL + c] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    // dq[q][d] += sum_k ds[q][k] k[k][d]  (scaled once at the end)
#pragma unroll 4
    for (int c = 0; c < TL; ++c) {
      float sv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = ds_s[(ty + 16 * i) * TL + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq_acc[i][j] = fmaf(sv[i], kv[j], dq_acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
    T* o = dq + (((size_t)b * seq + r) * nh + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = from_f32<T>(dq_acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores. mma.sync m16n8k16 (bf16 in, f32 sums), operands
// through ldmatrix from XOR-swizzled tiles that cp.async fills.

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
// an m16n8 accumulator pair (columns 0-7 and 8-15 of a 16-wide k step) as
// the A fragment of the next product, rounded to bf16 in registers
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// element offset of (row, 16-byte chunk) in a [rows][HD] bf16 tile whose
// chunks are XOR-swizzled by row & 7: the eight rows an ldmatrix reads at
// one logical chunk land in eight different bank groups
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * HD + ((chunk ^ (row & 7)) << 3);
}
// ldmatrix lane addresses. A: the 16 x 16 tile at (row0, k step kk) of a
// row-major tile. B: keys n0..n0 + 15 of a [key][d] tile as the column-major
// operand of . ^T (r[0..1] keys n0..+7, r[2..3] keys n0 + 8..+15). BT: k
// step kk over the rows of a [k][n] tile, n chunks dn and dn + 1 (.trans).
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

// cp.async of rows [r0, r0 + ROWS) of head h of a [B, S, nh, HD] bf16
// tensor into a swizzled tile, 16 bytes a copy; rows at or past S are zero
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                           int r0, int seq, int nh, int h) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < seq;
    const __nv_bfloat16* g = ok ? src + (((size_t)b * seq + r0 + r) * nh + h) * HD + c * 8 : src;
    cp_async16(dst + swz<HD>(r, c), g, ok);
  }
}

// Validity bits of the key tiles 0..last of row b (bit j of word 2t + j / 32:
// key 64 t + j is below S and valid), one warp a tile; then, by thread 0,
// the list of tiles with a valid key and its length. Ends with a barrier.
__device__ __forceinline__ void key_tiles(uint32_t* vmask, int* list, int* count,
                                          const int32_t* __restrict__ key_valid, int b, int seq,
                                          int last, int warps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t <= last; t += warps) {
    const int j0 = t * 64 + lane, j1 = j0 + 32;
    const bool v0 = j0 < seq && key_valid[(size_t)b * seq + j0] != 0;
    const bool v1 = j1 < seq && key_valid[(size_t)b * seq + j1] != 0;
    const uint32_t lo = __ballot_sync(kFull, v0), hi = __ballot_sync(kFull, v1);
    if (lane == 0) {
      vmask[2 * t] = lo;
      vmask[2 * t + 1] = hi;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t <= last; ++t)
      if (vmask[2 * t] | vmask[2 * t + 1]) list[n++] = t;
    *count = n;
  }
  __syncthreads();
}
__device__ __forceinline__ bool key_bit(uint32_t lo, uint32_t hi, int j) {
  return ((j < 32 ? lo >> j : hi >> (j - 32)) & 1u) != 0;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKeys = 64;       // keys per tile (every kernel)
constexpr int kFwdWarps = 8;    // forward: 8 warps, 16 query rows each (per part)
constexpr int kFwdStages = 3;   // K/V ring depth (2 at head_dim 256)
constexpr int kBwdRows = 64;    // backward: 16 keys (dk/dv) or rows (dq) a warp
constexpr int kBwdWarps = 4;    // (per part)
constexpr int kBwdStages = 2;

// Head dim 256 splits each warp's output columns over a warp pair: a
// 16 x 256 f32 accumulator is 128 registers a thread, two of them (dk and
// dv) 256. Both warps of a pair compute the same scores (the full hd
// contraction) and each keeps the products of its half of the columns.
template <int HD>
__host__ __device__ constexpr int parts() { return HD > 128 ? 2 : 1; }
// 128 query rows a forward block, 64 at hd 256
template <int HD>
__host__ __device__ constexpr int fwd_rows() { return 16 * kFwdWarps / parts<HD>(); }
template <int HD>
__host__ __device__ constexpr int fwd_stages() { return HD > 128 ? 2 : kFwdStages; }
// dk/dv's streamed query tile: 64 rows, 32 at hd 256 (s^T and dp^T of 16 x
// 32 keep the warp inside its registers beside its dk and dv halves)
template <int HD>
__host__ __device__ constexpr int dkv_qrows() { return HD > 128 ? 32 : kBwdRows; }
template <int HD>
__host__ __device__ constexpr int bwd_threads() { return kBwdWarps * 32 * parts<HD>(); }

template <int HD>
constexpr size_t fwd_mma_smem(int seq) {
  const int tiles = (seq + kKeys - 1) / kKeys;
  return sizeof(__nv_bfloat16) * HD * (fwd_rows<HD>() + 2 * fwd_stages<HD>() * kKeys) +
         12 * tiles + 16;
}
template <int HD>
constexpr size_t dkv_mma_smem() {
  return sizeof(__nv_bfloat16) * HD * (2 * kKeys + 2 * kBwdStages * dkv_qrows<HD>()) +
         2 * sizeof(float) * kBwdStages * dkv_qrows<HD>();
}
template <int HD>
constexpr size_t dq_mma_smem(int seq) {
  const int tiles = (seq + kKeys - 1) / kKeys;
  return sizeof(__nv_bfloat16) * HD * (2 * kBwdRows + 2 * kBwdStages * kKeys) + 12 * tiles + 16;
}

// A block may take 232,448 bytes (227 KB) of dynamic shared memory. The
// sizes that do not depend on S are held to it here, at every built head
// dim; the forward's and dq's key-tile lists grow with S, and past the limit
// cudaFuncSetAttribute refuses the launch (an error the wrapper raises).
constexpr size_t kMaxSmem = 232448;
template <int HD>
constexpr bool fits_smem() {
  return fwd_smem<HD, kTile>() <= kMaxSmem && bwd_smem<HD, f32_bwd_tile<HD>()>() <= kMaxSmem &&
         fwd_mma_smem<HD>(1) <= kMaxSmem && dkv_mma_smem<HD>() <= kMaxSmem &&
         dq_mma_smem<HD>(1) <= kMaxSmem;
}
static_assert(fits_smem<64>() && fits_smem<128>() && fits_smem<256>(),
              "a K4 kernel's shared memory exceeds a block's");

// Forward, bf16. Block: fwd_rows query rows of one head (8 warps x 16 rows,
// or 4 warp pairs at hd 256); grid (H, B, S / fwd_rows) with the query
// tiles in reverse, so the longest causal rows start first. Online softmax
// in the exp2 domain.
template <int HD>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ key_valid,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int seq, int nh,
              int nkv, float scale) {
  constexpr int kNt = kFwdWarps * 32;
  constexpr int kTile = kKeys * HD;
  constexpr int kRows = fwd_rows<HD>();
  constexpr int kStages = fwd_stages<HD>();
  constexpr int kDn = HD / 8 / parts<HD>();  // the warp's 8-column output chunks
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + kRows * HD;  // stage s: K at 2 s kTile, V after it
  uint32_t* vmask = reinterpret_cast<uint32_t*>(kv_s + 2 * kStages * kTile);
  const int ntiles = (seq + kKeys - 1) / kKeys;
  int* list = reinterpret_cast<int*>(vmask + 2 * ntiles);
  int* count = list + ntiles;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = h / (nh / nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w0 = (warp % (kRows / 16)) * 16;  // the warp's first row in the tile
  const int dn0 = (warp / (kRows / 16)) * kDn;  // its first output chunk

  tile_async<kRows, HD, kNt>(q_s, q, b, q0, seq, nh, h);
  cp_commit();
  key_tiles(vmask, list, count, key_valid, b, seq, min(seq - 1, q0 + kRows - 1) / kKeys,
            kFwdWarps);
  const int n = *count;
  auto load_kv = [&](int i) {
    __nv_bfloat16* st = kv_s + (i % kStages) * 2 * kTile;
    tile_async<kKeys, HD, kNt>(st, k, b, list[i] * kKeys, seq, nkv, kvh);
    tile_async<kKeys, HD, kNt>(st + kTile, v, b, list[i] * kKeys, seq, nkv, kvh);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_kv(s);
    cp_commit();
  }
  cp_wait<kStages - 1>();  // Q has landed
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], q_s + a_at<HD>(w0, kk, lane));

  float o[kDn][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = scale * kLog2e;
  const int row0 = q0 + w0 + g;  // this lane's rows: row0 and row0 + 8
  for (int i = 0; i < n; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile i landed for all; tile i - 1's readers are done
    if (i + kStages - 1 < n) load_kv(i + kStages - 1);
    cp_commit();
    const int t = list[i], k0 = t * kKeys;
    if (k0 > q0 + w0 + 15) continue;  // every key after every row of this warp
    const __nv_bfloat16* ks = kv_s + (i % kStages) * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;

    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + b_at<HD>(16 * nj, kk, lane));
        mma16816(s[2 * nj], qf[kk], bf[0], bf[1]);
        mma16816(s[2 * nj + 1], qf[kk], bf[2], bf[3]);
      }
    }
    const uint32_t lo = vmask[2 * t], hi = vmask[2 * t + 1];
    const bool masked = (lo & hi) != kFull || k0 + kKeys - 1 > q0 + w0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * c + (e & 1);
        const bool ok = !masked || (k0 + kj <= row0 + 8 * (e >> 1) && key_bit(lo, hi, kj));
        s[j][e] = ok ? s[j][e] * sl2 : -INFINITY;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float alpha = 1.0f, rs = 0.0f;
      if (m_new != -INFINITY) {  // else no valid key yet: p = 0, nothing rescales
        alpha = exp2f(m[hr] - m_new);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][2 * hr] = exp2f(s[j][2 * hr] - m_new);
          s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - m_new);
          rs += s[j][2 * hr] + s[j][2 * hr + 1];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][2 * hr] = s[j][2 * hr + 1] = 0.0f;
      }
      rs += __shfl_xor_sync(kFull, rs, 1);
      rs += __shfl_xor_sync(kFull, rs, 2);
      l[hr] = l[hr] * alpha + rs;
      m[hr] = m_new;
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        o[dn][2 * hr] *= alpha;
        o[dn][2 * hr + 1] *= alpha;
      }
    }
    // o += p . v over this warp's columns, p rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDn; dn += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vs + bt_at<HD>(kk, dn0 + dn, lane));
        mma16816(o[dn], pa, bf[0], bf[1]);
        mma16816(o[dn + 1], pa, bf[2], bf[3]);
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    if (r >= seq) continue;
    const bool any = l[hr] > 0.0f;
    __nv_bfloat16* dst = out + (((size_t)b * seq + r) * nh + h) * HD + 8 * dn0 + 2 * c;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      const float x0 = any ? o[dn][2 * hr] / l[hr] : 0.0f;
      const float x1 = any ? o[dn][2 * hr + 1] / l[hr] : 0.0f;
      *reinterpret_cast<uint32_t*>(dst + 8 * dn) = pack_bf16(x0, x1);
    }
    if (c == 0 && dn0 == 0)
      lse[((size_t)b * nh + h) * seq + r] = any ? (m[hr] + log2f(l[hr])) * kLn2 : 0.0f;
  }
}

// dk/dv, bf16. Block: one key tile of 64 keys of one kv head (4 warps x 16
// keys, or 4 warp pairs at hd 256), K and V resident in shared memory, dk
// and dv in registers; it loops over its G query heads and the query tiles
// from the causal start, with Q, dO, lse and delta streamed through a
// cp.async ring. Each warp computes the transposed products: s^T = K Q^T,
// p^T, dv += p^T dO, dp^T = V dO^T, ds^T = p^T (dp^T - delta), dk += ds^T Q.
// Grid (K, B, S / 64): the early key tiles, the longest, start first.
template <int HD>
__global__ void __launch_bounds__(bwd_threads<HD>(), 3 - parts<HD>())
flash_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ key_valid,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int seq, int nh, int nkv, float scale) {
  constexpr int kNt = bwd_threads<HD>();
  constexpr int kQr = dkv_qrows<HD>();  // query rows a ring stage
  constexpr int kTile = kQr * HD;
  constexpr int kDn = HD / 8 / parts<HD>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kKeys * HD;
  __nv_bfloat16* ring = v_s + kKeys * HD;  // stage s: Q at 2 s kTile, dO after it
  float* stats = reinterpret_cast<float*>(ring + 2 * kBwdStages * kTile);  // lse, delta

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kKeys;
  const int groups = nh / nkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w0 = (warp % kBwdWarps) * 16;
  const int dn0 = (warp / kBwdWarps) * kDn;

  // this tile's key validity (every warp takes the same ballots)
  const int j0 = k0 + lane, j1 = j0 + 32;
  const uint32_t lo = __ballot_sync(kFull, j0 < seq && key_valid[(size_t)b * seq + j0] != 0);
  const uint32_t hi = __ballot_sync(kFull, j1 < seq && key_valid[(size_t)b * seq + j1] != 0);
  const int key0 = k0 + w0 + g;  // this lane's keys: key0 and key0 + 8
  if ((lo | hi) == 0) {  // no valid key: dk = dv = 0
    for (int e = threadIdx.x; e < kKeys * HD; e += kNt) {
      const int r = k0 + e / HD;
      if (r >= seq) break;
      const size_t at = (((size_t)b * seq + r) * nkv + kvh) * HD + e % HD;
      dk[at] = dv[at] = __float2bfloat16(0.0f);
    }
    return;
  }
  tile_async<kKeys, HD, kNt>(k_s, k, b, k0, seq, nkv, kvh);
  tile_async<kKeys, HD, kNt>(v_s, v, b, k0, seq, nkv, kvh);
  cp_commit();
  const int qtiles = (seq - k0 + kQr - 1) / kQr;
  const int n = groups * qtiles;
  auto load_q = [&](int i) {
    const int st = i % kBwdStages;
    const int h = kvh * groups + i / qtiles, q0 = k0 + (i % qtiles) * kQr;
    tile_async<kQr, HD, kNt>(ring + 2 * st * kTile, q, b, q0, seq, nh, h);
    tile_async<kQr, HD, kNt>(ring + (2 * st + 1) * kTile, dout, b, q0, seq, nh, h);
    if (threadIdx.x < 2 * kQr) {  // lse by the first kQr threads, delta by the next
      const int r = threadIdx.x % kQr;
      const bool ok = q0 + r < seq;
      const size_t at = ((size_t)b * nh + h) * seq + (ok ? q0 + r : 0);
      cp_async4(stats + 2 * st * kQr + threadIdx.x, threadIdx.x < kQr ? lse + at : delta + at,
                ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (s < n) load_q(s);
    cp_commit();
  }
  const bool kv0 = key_bit(lo, hi, w0 + g), kv1 = key_bit(lo, hi, w0 + g + 8);
  const bool all_valid = (lo & hi) == kFull;
  const float sl2 = scale * kLog2e;
  float dk_acc[kDn][4] = {}, dv_acc[kDn][4] = {};
  for (int i = 0; i < n; ++i) {
    cp_wait<kBwdStages - 2>();
    __syncthreads();
    if (i + kBwdStages - 1 < n) load_q(i + kBwdStages - 1);
    cp_commit();
    const int st = i % kBwdStages;
    const __nv_bfloat16* qs = ring + 2 * st * kTile;
    const __nv_bfloat16* dos = qs + kTile;
    const float* lse_s = stats + 2 * st * kQr;
    const float* del_s = lse_s + kQr;
    const int q0 = k0 + (i % qtiles) * kQr;
    // a tile below the diagonal, all keys valid and inside S needs no mask
    const bool masked = !all_valid || q0 < k0 + kKeys || q0 + kQr > seq;

    float p[kQr / 8][4] = {};  // s^T, then p^T
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4];
      ldsm_x4(ka, k_s + a_at<HD>(w0, kk, lane));
#pragma unroll
      for (int nj = 0; nj < kQr / 16; ++nj) {
        uint32_t bf[4];
        ldsm_x4(bf, qs + b_at<HD>(16 * nj, kk, lane));
        mma16816(p[2 * nj], ka, bf[0], bf[1]);
        mma16816(p[2 * nj + 1], ka, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQr / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qj = 8 * j + 2 * c + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        const bool ok = !masked || ((e >> 1 ? kv1 : kv0) && key <= q0 + qj && q0 + qj < seq);
        p[j][e] = ok ? exp2f(p[j][e] * sl2 - lse_s[qj] * kLog2e) : 0.0f;
      }
    }
    // dv += p^T dO over this warp's columns
#pragma unroll
    for (int kk = 0; kk < kQr / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDn; dn += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, dos + bt_at<HD>(kk, dn0 + dn, lane));
        mma16816(dv_acc[dn], pa, bf[0], bf[1]);
        mma16816(dv_acc[dn + 1], pa, bf[2], bf[3]);
      }
    }
    // dp^T = V dO^T, then ds^T = p^T (dp^T - delta) in place of p
    float dp[kQr / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t va[4];
      ldsm_x4(va, v_s + a_at<HD>(w0, kk, lane));
#pragma unroll
      for (int nj = 0; nj < kQr / 16; ++nj) {
        uint32_t bf[4];
        ldsm_x4(bf, dos + b_at<HD>(16 * nj, kk, lane));
        mma16816(dp[2 * nj], va, bf[0], bf[1]);
        mma16816(dp[2 * nj + 1], va, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQr / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - del_s[8 * j + 2 * c + (e & 1)];
    }
    // dk += ds^T Q over this warp's columns (scaled once at the end)
#pragma unroll
    for (int kk = 0; kk < kQr / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDn; dn += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, qs + bt_at<HD>(kk, dn0 + dn, lane));
        mma16816(dk_acc[dn], da, bf[0], bf[1]);
        mma16816(dk_acc[dn + 1], da, bf[2], bf[3]);
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = key0 + 8 * hr;
    if (r >= seq) continue;
    const size_t at = (((size_t)b * seq + r) * nkv + kvh) * HD + 8 * dn0 + 2 * c;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * dn) =
          pack_bf16(dk_acc[dn][2 * hr] * scale, dk_acc[dn][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * dn) =
          pack_bf16(dv_acc[dn][2 * hr], dv_acc[dn][2 * hr + 1]);
    }
  }
}

// dq, bf16. Block: 64 query rows of one head (4 warps x 16 rows, or 4 warp
// pairs at hd 256), Q and dO resident; over the key tiles with a valid key
// up to the causal limit it recomputes s = Q K^T and dp = dO V^T (the price
// of writing dq without atomics) and accumulates dq += scale ds K. Grid
// (H, B, S / 64), the longest rows first.
template <int HD>
__global__ void __launch_bounds__(bwd_threads<HD>(), 3 - parts<HD>())
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ key_valid,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                 int seq, int nh, int nkv, float scale) {
  constexpr int kNt = bwd_threads<HD>();
  constexpr int kTile = kKeys * HD;
  constexpr int kDn = HD / 8 / parts<HD>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kBwdRows * HD;
  __nv_bfloat16* kv_s = do_s + kBwdRows * HD;  // stage s: K at 2 s kTile, V after it
  uint32_t* vmask = reinterpret_cast<uint32_t*>(kv_s + 2 * kBwdStages * kTile);
  const int ntiles = (seq + kKeys - 1) / kKeys;
  int* list = reinterpret_cast<int*>(vmask + 2 * ntiles);
  int* count = list + ntiles;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBwdRows;
  const int kvh = h / (nh / nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w0 = (warp % kBwdWarps) * 16;
  const int dn0 = (warp / kBwdWarps) * kDn;
  const int row0 = q0 + w0 + g;  // this lane's rows: row0 and row0 + 8

  tile_async<kBwdRows, HD, kNt>(q_s, q, b, q0, seq, nh, h);
  tile_async<kBwdRows, HD, kNt>(do_s, dout, b, q0, seq, nh, h);
  cp_commit();
  key_tiles(vmask, list, count, key_valid, b, seq, min(seq - 1, q0 + kBwdRows - 1) / kKeys,
            kNt / 32);
  const int n = *count;
  auto load_kv = [&](int i) {
    __nv_bfloat16* st = kv_s + (i % kBwdStages) * 2 * kTile;
    tile_async<kKeys, HD, kNt>(st, k, b, list[i] * kKeys, seq, nkv, kvh);
    tile_async<kKeys, HD, kNt>(st + kTile, v, b, list[i] * kKeys, seq, nkv, kvh);
  };
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (s < n) load_kv(s);
    cp_commit();
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    const size_t at = ((size_t)b * nh + h) * seq + r;
    lse2[hr] = r < seq ? lse[at] * kLog2e : 0.0f;
    dl[hr] = r < seq ? delta[at] : 0.0f;
  }
  const float sl2 = scale * kLog2e;
  float dq_acc[kDn][4] = {};
  for (int i = 0; i < n; ++i) {
    cp_wait<kBwdStages - 2>();
    __syncthreads();
    if (i + kBwdStages - 1 < n) load_kv(i + kBwdStages - 1);
    cp_commit();
    const int t = list[i], k0 = t * kKeys;
    if (k0 > q0 + w0 + 15) continue;  // every key after every row of this warp
    const __nv_bfloat16* ks = kv_s + (i % kBwdStages) * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;

    float p[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, q_s + a_at<HD>(w0, kk, lane));
      ldsm_x4(da, do_s + a_at<HD>(w0, kk, lane));
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, ks + b_at<HD>(16 * nj, kk, lane));
        ldsm_x4(bv, vs + b_at<HD>(16 * nj, kk, lane));
        mma16816(p[2 * nj], qa, bk[0], bk[1]);
        mma16816(p[2 * nj + 1], qa, bk[2], bk[3]);
        mma16816(dp[2 * nj], da, bv[0], bv[1]);
        mma16816(dp[2 * nj + 1], da, bv[2], bv[3]);
      }
    }
    const uint32_t lo = vmask[2 * t], hi = vmask[2 * t + 1];
    const bool masked = (lo & hi) != kFull || k0 + kKeys - 1 > q0 + w0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * c + (e & 1);
        const int hr = e >> 1;
        const bool ok = !masked || (k0 + kj <= row0 + 8 * hr && key_bit(lo, hi, kj));
        const float pe = ok ? exp2f(p[j][e] * sl2 - lse2[hr]) : 0.0f;
        p[j][e] = pe * (dp[j][e] - dl[hr]);  // ds
      }
    }
    // dq += ds K over this warp's columns
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDn; dn += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, ks + bt_at<HD>(kk, dn0 + dn, lane));
        mma16816(dq_acc[dn], sa, bf[0], bf[1]);
        mma16816(dq_acc[dn + 1], sa, bf[2], bf[3]);
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    if (r >= seq) continue;
    __nv_bfloat16* dst = dq + (((size_t)b * seq + r) * nh + h) * HD + 8 * dn0 + 2 * c;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
      *reinterpret_cast<uint32_t*>(dst + 8 * dn) =
          pack_bf16(dq_acc[dn][2 * hr] * scale, dq_acc[dn][2 * hr + 1] * scale);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, const void* key_valid, void* out,
        void* lse, int batch, int seq, int nh, int nkv, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD, kTile>;
  const size_t smem = fwd_smem<HD, kTile>();
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid((seq + kTile - 1) / kTile, nh, batch);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                           (const int32_t*)key_valid, (T*)out, (float*)lse,
                                           seq, nh, nkv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd(const void* q, const void* k, const void* v, const void* key_valid, const void* out,
        const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv, int batch,
        int seq, int nh, int nkv, float scale, cudaStream_t stream) {
  constexpr int TL = f32_bwd_tile<HD>();
  const size_t rows = (size_t)batch * seq * nh;
  const int per_block = kThreads / 32;
  flash_delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, stream>>>(
      (const T*)out, (const T*)dout, (float*)delta, batch, seq, nh, HD);
  if (int e = (int)cudaGetLastError()) return e;

  const size_t smem = bwd_smem<HD, TL>();
  const int tiles = (seq + TL - 1) / TL;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, HD, TL>;
  if (int e = set_smem(dkv_kernel, smem)) return e;
  dkv_kernel<<<dim3(tiles, nkv, batch), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)key_valid, (const float*)lse,
      (const float*)delta, (const T*)dout, (T*)dk, (T*)dv, seq, nh, nkv, scale);
  if (int e = (int)cudaGetLastError()) return e;

  auto dq_kernel = flash_bwd_dq_kernel<T, HD, TL>;
  if (int e = set_smem(dq_kernel, smem)) return e;
  dq_kernel<<<dim3(tiles, nh, batch), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)key_valid, (const float*)lse,
      (const float*)delta, (const T*)dout, (T*)dq, seq, nh, nkv, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int fwd_mma(const void* q, const void* k, const void* v, const void* key_valid, void* out,
            void* lse, int batch, int seq, int nh, int nkv, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto kernel = flash_fwd_mma<HD>;
  const size_t smem = fwd_mma_smem<HD>(seq);
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(nh, batch, (seq + fwd_rows<HD>() - 1) / fwd_rows<HD>());
  kernel<<<grid, kFwdWarps * 32, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                 (const int32_t*)key_valid, (T*)out,
                                                 (float*)lse, seq, nh, nkv, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_mma(const void* q, const void* k, const void* v, const void* key_valid,
            const void* out, const void* lse, const void* dout, void* delta, void* dq, void* dk,
            void* dv, int batch, int seq, int nh, int nkv, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t rows = (size_t)batch * seq * nh;
  const int per_block = kThreads / 32;
  flash_delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, stream>>>(
      (const T*)out, (const T*)dout, (float*)delta, batch, seq, nh, HD);
  if (int e = (int)cudaGetLastError()) return e;

  auto dkv_kernel = flash_bwd_dkv_mma<HD>;
  const size_t dkv_smem = dkv_mma_smem<HD>();
  if (int e = set_smem(dkv_kernel, dkv_smem)) return e;
  dkv_kernel<<<dim3(nkv, batch, (seq + kKeys - 1) / kKeys), bwd_threads<HD>(), dkv_smem,
               stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)key_valid, (const float*)lse,
      (const float*)delta, (const T*)dout, (T*)dk, (T*)dv, seq, nh, nkv, scale);
  if (int e = (int)cudaGetLastError()) return e;

  auto dq_kernel = flash_bwd_dq_mma<HD>;
  const size_t dq_smem = dq_mma_smem<HD>(seq);
  if (int e = set_smem(dq_kernel, dq_smem)) return e;
  dq_kernel<<<dim3(nh, batch, (seq + kBwdRows - 1) / kBwdRows), bwd_threads<HD>(), dq_smem,
              stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)key_valid, (const float*)lse,
      (const float*)delta, (const T*)dout, (T*)dq, seq, nh, nkv, scale);
  return (int)cudaGetLastError();
}

// dispatch on (dtype: 0 = f32 on the CUDA cores, 1 = bf16 on the tensor
// cores) and head_dim in {64, 128, 256} (every preset's head dim)
#define FA_DISPATCH(F32, BF16, ...)                                           \
  switch (dtype * 1000 + head_dim) {                                          \
    case 64: return F32<float, 64>(__VA_ARGS__);                              \
    case 128: return F32<float, 128>(__VA_ARGS__);                            \
    case 256: return F32<float, 256>(__VA_ARGS__);                            \
    case 1064: return BF16<64>(__VA_ARGS__);                                  \
    case 1128: return BF16<128>(__VA_ARGS__);                                 \
    case 1256: return BF16<256>(__VA_ARGS__);                                 \
    default: return (int)cudaErrorInvalidValue;                               \
  }

}  // namespace

extern "C" {

// q, out: [batch, seq, num_q_heads, head_dim]; k, v: [batch, seq,
// num_kv_heads, head_dim], all contiguous in `dtype` (0 = f32, 1 = bf16);
// key_valid: int32 [batch, seq]; lse: f32 [batch, num_q_heads, seq]. Runs on
// `stream` of `device`; returns the first CUDA error (0 = ok). The caller
// checks: head_dim in {64, 128, 256}, num_q_heads divisible by num_kv_heads.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* key_valid,
                        void* out, void* lse, int batch, int seq, int num_q_heads,
                        int num_kv_heads, int head_dim, float scale, int dtype, int device,
                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (batch <= 0 || seq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH(fwd, fwd_mma, q, k, v, key_valid, out, lse, batch, seq, num_q_heads, num_kv_heads,
              scale, s)
}

// The backward of flash_attention_fwd: dout like out; delta is f32 scratch
// [batch, num_q_heads, seq]; dq like q, dk and dv like k. Three launches on
// `stream`: delta, then dk/dv, then dq.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* key_valid,
                        const void* out, const void* lse, const void* dout, void* delta,
                        void* dq, void* dk, void* dv, int batch, int seq, int num_q_heads,
                        int num_kv_heads, int head_dim, float scale, int dtype, int device,
                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (batch <= 0 || seq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH(bwd, bwd_mma, q, k, v, key_valid, out, lse, dout, delta, dq, dk, dv, batch, seq,
              num_q_heads, num_kv_heads, scale, s)
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
