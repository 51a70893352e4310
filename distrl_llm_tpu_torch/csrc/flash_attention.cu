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
// Design (simple and right first). Tiles of 64 query rows by 64 keys, f32
// in shared memory (rows padded to hd + 1 floats, so a warp reading one
// column of 16 rows hits 16 banks), 256 threads as a 16 x 16 grid: thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j of every 64-wide tile,
// so a row's statistics reduce over the 16 lanes of a half-warp.
//   forward:   grid (S / 64, H, B), heaviest query tiles first; a loop over
//              the key tiles up to the causal limit with an online softmax;
//              writes out and the row log-sum-exp lse [B, H, S] f32.
//   delta:     one warp per (b, i, h): delta = rowsum(dout * out), f32.
//   dk / dv:   grid (S / 64, K, B): a block per key tile of one kv head
//              loops over its G query heads and the query tiles from the
//              causal start, recomputing p = exp(scale s - lse):
//              dv += p^T dout, ds = p (dp - delta), dk += scale ds^T q.
//   dq:        grid (S / 64, H, B): dq += scale ds k over the key tiles up
//              to the causal limit.
// Any S works: tails are masked, never padded in memory.
//
// What bounds it. The causal pairs whose key is valid need 4 hd flops each
// forward (q.k and p.v) and 10 hd backward (s, dp, dv, dk, dq); at the
// learner's [8, 1550, 28 / 4, 128] with every key valid that is 1.38e11 and
// 3.45e11 flops, 0.14 ms and 0.35 ms at the bf16 tensor cores' 989 TFLOP/s;
// the bytes (q, k, v, out once, ~100 MB in bf16) bound less. This version
// runs every product on the CUDA cores in f32 (67 TFLOP/s peak, and the
// shared-memory reads of the operands cap it below that), so it is far
// from that bound; mma/wgmma on bf16, cp.async/TMA staging and a persistent
// schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and keys per tile
constexpr unsigned kFull = 0xffffffffu;

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

// rows [r0, r0 + 64) of head `h` of a [B, S, nh, HD] tensor into shared
// memory rows of `ld` floats; rows at or past S are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src, int b,
                                          int r0, int seq, int nh, int h) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int i = r0 + r;
    dst[r * ld + d] = i < seq ? to_f32(src[(((size_t)b * seq + i) * nh + h) * HD + d]) : 0.0f;
  }
}

__device__ __forceinline__ void load_valid(int* dst, const int32_t* __restrict__ key_valid,
                                           int b, int k0, int seq) {
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    dst[c] = (k0 + c < seq) ? (key_valid[(size_t)b * seq + k0 + c] != 0) : 0;
  }
}

// acc[i][j] += sum_d a[(ty + 16 i) * LD + d] * b[(tx + 16 j) * LD + d]:
// a 64 x 64 tile of a . b^T with both operands row-major over hd
template <int HD>
__device__ __forceinline__ void tile_nt(float (&acc)[4][4], const float* a, const float* bm,
                                        int ty, int tx) {
  constexpr int LD = HD + 1;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// shared memory of the forward: q, k, v tiles [64][HD + 1], p [64][64],
// the tile's key validity [64]
template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (HD + 1) + kTile * kTile) + sizeof(int) * kTile;
}

// the backward kernels: four [64][HD + 1] tiles, one [64][64] tile, 64
// key-validity flags and, for dk/dv, lse and delta of a query tile
template <int HD>
constexpr size_t bwd_smem() {
  return sizeof(float) * (4 * kTile * (HD + 1) + kTile * kTile + 2 * kTile) + sizeof(int) * kTile;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ key_valid, T* __restrict__ out,
                 float* __restrict__ lse, int seq, int nh, int nkv, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;  // [64][64]
  int* valid_s = reinterpret_cast<int*>(p_s + kTile * kTile);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;

  load_tile<T, HD>(q_s, LD, q, b, q0, seq, nh, h);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int kend = min(seq, q0 + kTile);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(k_s, LD, k, b, k0, seq, nkv, kvh);
    load_tile<T, HD>(v_s, LD, v, b, k0, seq, nkv, kvh);
    load_valid(valid_s, key_valid, b, k0, seq);
    __syncthreads();

    float s[4][4] = {};
    tile_nt<HD>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      }
      rs = half_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty + 16 * i) * kTile + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    // acc += p . v
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kTile + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int32_t* __restrict__ key_valid, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int seq, int nh, int nkv,
                     float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* ds_s = do_s + kTile * LD;  // [64 q][64 k]: p, then ds
  float* lse_s = ds_s + kTile * kTile;
  float* delta_s = lse_s + kTile;
  int* valid_s = reinterpret_cast<int*>(delta_s + kTile);

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int groups = nh / nkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;

  load_tile<T, HD>(k_s, LD, k, b, k0, seq, nkv, kvh);
  load_tile<T, HD>(v_s, LD, v, b, k0, seq, nkv, kvh);
  load_valid(valid_s, key_valid, b, k0, seq);
  float dk_acc[4][DJ] = {}, dv_acc[4][DJ] = {};

  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    const float* lse_h = lse + ((size_t)b * nh + h) * seq;
    const float* delta_h = delta + ((size_t)b * nh + h) * seq;
    for (int q0 = k0; q0 < seq; q0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD>(q_s, LD, q, b, q0, seq, nh, h);
      load_tile<T, HD>(do_s, LD, dout, b, q0, seq, nh, h);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        lse_s[r] = q0 + r < seq ? lse_h[q0 + r] : 0.0f;
        delta_s[r] = q0 + r < seq ? delta_h[q0 + r] : 0.0f;
      }
      __syncthreads();

      // p[q][k] = exp(scale s - lse) on the unmasked pairs, else 0
      float p[4][4] = {};
      tile_nt<HD>(p, q_s, k_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = r < seq && k0 + c <= r && valid_s[c];
          p[i][j] = ok ? expf(p[i][j] * scale - lse_s[ty + 16 * i]) : 0.0f;
          ds_s[(ty + 16 * i) * kTile + c] = p[i][j];
        }
      }
      __syncthreads();
      // dv[k][d] += sum_q p[q][k] dout[q][d]
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pk[4], gv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pk[i] = ds_s[r * kTile + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) gv[j] = do_s[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) dv_acc[i][j] = fmaf(pk[i], gv[j], dv_acc[i][j]);
        }
      }
      // dp[q][k] = dout[q] . v[k]; ds = p (dp - delta)
      float dp[4][4] = {};
      tile_nt<HD>(dp, do_s, v_s, ty, tx);
      __syncthreads();  // every reader of p in ds_s is done
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ds_s[(ty + 16 * i) * kTile + tx + 16 * j] =
              p[i][j] * (dp[i][j] - delta_s[ty + 16 * i]);
        }
      }
      __syncthreads();
      // dk[k][d] += sum_q ds[q][k] q[q][d]  (scaled once at the end)
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float sk[4], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sk[i] = ds_s[r * kTile + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) qv[j] = q_s[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) dk_acc[i][j] = fmaf(sk[i], qv[j], dk_acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ key_valid, const float* __restrict__ lse,
                    const float* __restrict__ delta, const T* __restrict__ dout,
                    T* __restrict__ dq, int seq, int nh, int nkv, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;  // [64 q][64 k]
  int* valid_s = reinterpret_cast<int*>(ds_s + kTile * kTile + 2 * kTile);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;

  load_tile<T, HD>(q_s, LD, q, b, q0, seq, nh, h);
  load_tile<T, HD>(do_s, LD, dout, b, q0, seq, nh, h);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const size_t at = ((size_t)b * nh + h) * seq + r;
    lse_r[i] = r < seq ? lse[at] : 0.0f;
    delta_r[i] = r < seq ? delta[at] : 0.0f;
  }
  float dq_acc[4][DJ] = {};

  const int kend = min(seq, q0 + kTile);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(k_s, LD, k, b, k0, seq, nkv, kvh);
    load_tile<T, HD>(v_s, LD, v, b, k0, seq, nkv, kvh);
    load_valid(valid_s, key_valid, b, k0, seq);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_nt<HD>(s, q_s, k_s, ty, tx);
    tile_nt<HD>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = r < seq && k0 + c <= r && valid_s[c];
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        ds_s[(ty + 16 * i) * kTile + c] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    // dq[q][d] += sum_k ds[q][k] k[k][d]  (scaled once at the end)
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float sv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty + 16 * i) * kTile + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq_acc[i][j] = fmaf(sv[i], kv[j], dq_acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
    T* o = dq + (((size_t)b * seq + r) * nh + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = from_f32<T>(dq_acc[i][j] * scale);
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
  auto kernel = flash_fwd_kernel<T, HD>;
  const size_t smem = fwd_smem<HD>();
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
  const size_t rows = (size_t)batch * seq * nh;
  const int per_block = kThreads / 32;
  flash_delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, stream>>>(
      (const T*)out, (const T*)dout, (float*)delta, batch, seq, nh, HD);
  if (int e = (int)cudaGetLastError()) return e;

  const size_t smem = bwd_smem<HD>();
  const int tiles = (seq + kTile - 1) / kTile;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, HD>;
  if (int e = set_smem(dkv_kernel, smem)) return e;
  dkv_kernel<<<dim3(tiles, nkv, batch), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)key_valid, (const float*)lse,
      (const float*)delta, (const T*)dout, (T*)dk, (T*)dv, seq, nh, nkv, scale);
  if (int e = (int)cudaGetLastError()) return e;

  auto dq_kernel = flash_bwd_dq_kernel<T, HD>;
  if (int e = set_smem(dq_kernel, smem)) return e;
  dq_kernel<<<dim3(tiles, nh, batch), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)key_valid, (const float*)lse,
      (const float*)delta, (const T*)dout, (T*)dq, seq, nh, nkv, scale);
  return (int)cudaGetLastError();
}

// dispatch on (dtype: 0 = f32, 1 = bf16) and head_dim in {64, 128} (the
// presets' head dims but Gemma's 256, whose four f32 tiles would not fit
// shared memory in the backward)
#define FA_DISPATCH(FN, ...)                                                  \
  switch (dtype * 1000 + head_dim) {                                          \
    case 64: return FN<float, 64>(__VA_ARGS__);                               \
    case 128: return FN<float, 128>(__VA_ARGS__);                             \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                     \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;                               \
  }

}  // namespace

extern "C" {

// q, out: [batch, seq, num_q_heads, head_dim]; k, v: [batch, seq,
// num_kv_heads, head_dim], all contiguous in `dtype` (0 = f32, 1 = bf16);
// key_valid: int32 [batch, seq]; lse: f32 [batch, num_q_heads, seq]. Runs on
// `stream` of `device`; returns the first CUDA error (0 = ok). The caller
// checks: head_dim in {64, 128}, num_q_heads divisible by num_kv_heads.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* key_valid,
                        void* out, void* lse, int batch, int seq, int num_q_heads,
                        int num_kv_heads, int head_dim, float scale, int dtype, int device,
                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (batch <= 0 || seq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH(fwd, q, k, v, key_valid, out, lse, batch, seq, num_q_heads, num_kv_heads, scale, s)
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
  FA_DISPATCH(bwd, q, k, v, key_valid, out, lse, dout, delta, dq, dk, dv, batch, seq,
              num_q_heads, num_kv_heads, scale, s)
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
