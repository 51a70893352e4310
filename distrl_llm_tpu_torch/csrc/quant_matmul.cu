// Dequant-matmul over an int8 or int4 weight with the LoRA delta in its
// epilogue, for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the TPU kernel distrl_llm_tpu/ops/quant_matmul.py::quant_matmul
// (pallas_call at :150, body _kernel_body :73), the QLoRA base's projection.
//
// Function. x [M, K] (bf16 or f32, "T"); the weight a quantized container of
// G groups of g input rows: int8 q [G, g, N], or int4 packed two values a
// byte along the group axis, q4 [G, g/2, N] (byte i of a group holds k = 2i
// in its low nibble and k = 2i + 1 in its high nibble, each sign-extended);
// scale f32 [G, 1, N]; optional bias T [N]; optional adapter A [K, r], B [r,
// N] (f32 or bf16, cast to T). With s the LoRA scale already rounded to T,
// and every "T(...)" one rounding to nearest even:
//   w   = T(q * scale[k / g])                 (f32 product, one rounding)
//   y   = T(sum_k x * w)                      (f32 sum)
//   y   = T(y + bias)                         (if a bias)
//   xa  = T(sum_k x * A);  xab = T(sum_r xa * B)
//   y   = T(y + T(xab * s))                   (if an adapter)
// exactly the rounding order of the TPU kernel; only the order of the sums
// differs. The output is T [M, N].
//
// What bounds it. At decode (M = 64) the weight's bytes: an int4 w_gate
// [3584, 18944] moves 33.9 MB of payload and 4.2 MB of scales, 0.0114 ms at
// 3.35 TB/s, and a decode step's 196 calls move 3.67 GB, ~1.1 ms. At the
// learner's M = 12,400 its flops: 2 M K N = 1.68e12 for w_gate, 1.7 ms at
// 989 TFLOP/s. In between, the dequantization: every weight value costs
// ~4 CUDA-core instructions per tile of tokens that reuses it.
//
// bf16 (the main path): the weight is dequantized from staged bytes
// straight into tensor-core operand fragments, never stored at bf16 width.
// A cp.async ring (16 bytes a thread) holds stages of 64 K rows: the x tile
// [tokens][64] bf16 (16-byte chunks XOR-swizzled by row & 7, which is also
// wgmma's 128-byte swizzle), the payload at its storage width and the
// stage's f32 scale rows. A lane turns its bytes into f32 exactly (2^23 + u
// - bias), multiplies by the scale and rounds once to bf16; the tile's
// columns are permuted so that a lane's values sit in one 16- or 32-bit
// shared-memory word. Two kernels, chosen by M on the host
// (ops/quant_matmul.py::plan_split_k), each the faster on its side:
//   above 512 rows (prefill, the learner's 12,400): qmm_wgmma_kernel, the
//            transposed tile y^T = W^T x^T of 128 output columns (two
//            warpgroups of 64) by 256 tokens, the dequantized weight the
//            register A operand of wgmma m64n256k16 and x the shared-memory
//            B operand; four wgmmas a stage, wait_group 1, so a stage's
//            products overlap the next stage's dequantization. Each
//            dequantized value feeds 256 tokens. xa = T(x A) comes from
//            qmm_xa_kernel, once per call (in the K loop it would be
//            repeated by every column block: 148 times for w_gate); xab =
//            xa B runs on mma.sync in the accumulators' layout, and the
//            roundings go through shared memory (a straight-line epilogue
//            over 128 accumulators outgrew the instruction cache).
//   up to 512 rows (decode at 64, the verify step at 320): qmm_mma_kernel,
//            64 x 128 tiles, 4 warps of 64 rows x 32 columns on mma.sync
//            m16n8k16 (wgmma at 64-token tiles measured slower), with K
//            split in two or more, until the grid holds four blocks an SM:
//            each split writes f32 partial sums of y, and the first column
//            block those of x A from its own K loop, into a workspace;
//            qmm_reduce_kernel, in the same call, sums them in split order
//            and applies the epilogue. No atomics.
// f32 (the learner's f32 parity runs): FMA on the CUDA cores, never TF32
// or bf16 operands: blocks of 64 x 128 outputs, 256 threads, a loop over K
// in steps of 32 through two register-staged shared-memory stages, the
// weight dequantized to f32 in shared memory; xa = x A from
// qmm_xa_f32_kernel. Ragged M and N are masked in the kernels, never padded
// in memory. K must be a multiple of 32, the group even (or the whole K).
//
// Any adapter rank, as the TPU kernel takes the whole adapter: every route
// walks the rank in chunks of R columns (R = 32 up to rank 32, else 64; the
// last chunk zero-padded), each chunk on the R-wide tiles a rank of 32 or
// 64 runs on alone. xa is written chunk by chunk (qmm_xa_kernel's and
// qmm_xa_f32_kernel's grids take a chunk a block; a split call's x A takes
// one column block a chunk), and the epilogues sum xa B over the chunks in
// f32 before its one rounding. Padding R to the rank instead would grow
// the registers of a 64-row tile's xa and B^T fragments with the rank.
//
// Measured (chip_smoke.py's K3 stanza, NVIDIA H100 80GB HBM3 at 700 W; the
// rest in PERF.md): w_gate int4 g64 at M = 12,400 5.66-5.76 ms (library
// call 3.34-3.39, bound 1.72; this file's earlier CUDA-core dequant into
// shared memory 14.7); at M = 64 0.112 ms (library 0.070, bound 0.013,
// earlier 0.19-0.24 a single call); every projection of a QLoRA decode step
// summed, 11.9 ms (bound 1.29, earlier 37.8 of profiled device time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 32;   // K per step

struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  const void* bias;  // T [N] or null
  const void* a;     // [K, rank] f32 or bf16, or null
  const void* b;     // [rank, N]
  void* out;
  float* ws;         // bf16: f32 scratch (see quant_matmul_launch), else null
  int m, k, n, group, bits, rank, lora_bf16;
  float lora_scale;  // already rounded to T
  int splits, kchunk, srows;  // split-K: splits of kchunk K rows; scale rows a stage
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// one rounding to T, back in f32
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float lora_at(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// the adapter's rank in chunks of R columns (R = 32 for ranks up to 32,
// else 64): `chunks` of them, padded to chunks * R (ops/quant_matmul.py::
// plan_rank). Every route loops over the chunks, so no rank is refused.
__host__ __device__ __forceinline__ int rank_chunks(int rank, int r) {
  return r > 0 ? (rank + r - 1) / r : 0;
}

// shared-memory geometry of the f32 route: rows padded by 16 bytes, so
// every row stays 16-byte aligned; the epilogue's xa chunk [BM][kAs] and B
// chunk [R][kWs] reuse the loop's stages
template <typename T, int BM, int R>
struct Geo {
  static constexpr int kPad = 16 / (int)sizeof(T);
  static constexpr int kXs = kBK + kPad;  // x tile [BM][kXs]
  static constexpr int kWs = kBN + kPad;  // w tile [kBK][kWs]; B chunk [R][kWs]
  static constexpr int kAs = R + kPad;    // xa chunk [BM][kAs]
  static constexpr int kXElems = BM * kXs;
  static constexpr int kWElems = kBK * kWs;
  static constexpr int kStage = kXElems + kWElems;
  static constexpr int kLoopBytes = 2 * kStage * (int)sizeof(T);
  static constexpr int kEpiBytes = R ? (BM * kAs + R * kWs) * (int)sizeof(T) : 0;
  static constexpr int kBytes = kLoopBytes > kEpiBytes ? kLoopBytes : kEpiBytes;
  static constexpr int kEpc = 16 / (int)sizeof(T);            // x values per 16 bytes
  static constexpr int kXChunks = BM * kBK / kEpc / kThreads;  // per thread
};

// NV f32 values rounded to T and stored with 16-byte stores
template <int NV>
__device__ __forceinline__ void store_vals(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < NV; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}
template <int NV>
__device__ __forceinline__ void store_vals(__nv_bfloat16* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < NV; i += 8) {
    uint4 u;
    u.x = pack_bf16x2(v[i], v[i + 1]);
    u.y = pack_bf16x2(v[i + 2], v[i + 3]);
    u.z = pack_bf16x2(v[i + 4], v[i + 5]);
    u.w = pack_bf16x2(v[i + 6], v[i + 7]);
    *reinterpret_cast<uint4*>(dst + i) = u;
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[4], int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

// one K step's operands, held in registers between the global loads and the
// dequantizing store into shared memory
template <typename T, int BM>
struct Raw {
  uint4 x[Geo<T, BM, 0>::kXChunks];
  uint32_t q[4];
  float s[16];
};

template <typename T, int BM>
__device__ __forceinline__ void load_raw(Raw<T, BM>& raw, const Args& p, int k0, int m0,
                                         int n0) {
  using G = Geo<T, BM, 0>;
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(p.x);
  constexpr int kChunksPerRow = kBK / G::kEpc;
#pragma unroll
  for (int i = 0; i < G::kXChunks; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kChunksPerRow, col = (c % kChunksPerRow) * G::kEpc;
    const int gm = m0 + row;
    raw.x[i] = gm < p.m
        ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)gm * p.k + k0 + col))
        : make_uint4(0u, 0u, 0u, 0u);
  }
  // int8: one k row, 16 columns; int4: 8 packed bytes of one byte row (k
  // rows 2 br and 2 br + 1), 8 columns
  const bool is8 = p.bits == 8;
  const int nq = is8 ? 16 : 8;
  const int qrow = is8 ? tid >> 3 : tid >> 4;
  const int col = is8 ? (tid & 7) * 16 : (tid & 15) * 8;
  const int gn = n0 + col;
  const size_t qrow_g = is8 ? (size_t)(k0 + qrow) : (size_t)(k0 / 2 + qrow);
  const int8_t* src = p.q + qrow_g * p.n + gn;
  const bool full = gn + nq <= p.n;
  raw.q[0] = raw.q[1] = raw.q[2] = raw.q[3] = 0u;
  if (full && is8 && p.n % 16 == 0) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    raw.q[0] = u.x; raw.q[1] = u.y; raw.q[2] = u.z; raw.q[3] = u.w;
  } else if (full && !is8 && p.n % 8 == 0) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    raw.q[0] = u.x; raw.q[1] = u.y;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < nq && gn + j < p.n) raw.q[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
  }
  // the f32 scale of each value's group; both k rows of an int4 byte lie in
  // one group (g is even)
  const int kk = is8 ? k0 + qrow : k0 + 2 * qrow;
  const float* sp = p.scale + (size_t)(kk / p.group) * p.n + gn;
  if (full && p.n % 4 == 0) {
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      if (j >= nq) break;
      const float4 f = __ldg(reinterpret_cast<const float4*>(sp + j));
      raw.s[j] = f.x; raw.s[j + 1] = f.y; raw.s[j + 2] = f.z; raw.s[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) raw.s[j] = j < nq && gn + j < p.n ? __ldg(sp + j) : 0.f;
  }
}

template <typename T, int BM>
__device__ __forceinline__ void store_raw(const Raw<T, BM>& raw, const Args& p, T* xs, T* ws) {
  using G = Geo<T, BM, 0>;
  const int tid = threadIdx.x;
  constexpr int kChunksPerRow = kBK / G::kEpc;
#pragma unroll
  for (int i = 0; i < G::kXChunks; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(xs + (c / kChunksPerRow) * G::kXs +
                              (c % kChunksPerRow) * G::kEpc) = raw.x[i];
  }
  if (p.bits == 8) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = __fmul_rn((float)(int8_t)(uint8_t)byte_of(raw.q, j), raw.s[j]);
    store_vals<16>(ws + (tid >> 3) * G::kWs + (tid & 7) * 16, v);
  } else {
    float lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t u = byte_of(raw.q, j);
      const int even = (int)(int8_t)(uint8_t)(u << 4) >> 4;  // low nibble, sign-extended
      const int odd = (int)(int8_t)(uint8_t)u >> 4;           // high nibble
      lo[j] = __fmul_rn((float)even, raw.s[j]);
      hi[j] = __fmul_rn((float)odd, raw.s[j]);
    }
    const int row = 2 * (tid >> 4), col = (tid & 15) * 8;
    store_vals<8>(ws + row * G::kWs + col, lo);
    store_vals<8>(ws + (row + 1) * G::kWs + col, hi);
  }
}

// The K loop: two shared-memory stages, one barrier per step; `compute(xs,
// ws)` consumes a staged step. Ends with a barrier, so the caller may reuse
// the shared memory.
template <typename T, int BM, typename Compute>
__device__ __forceinline__ void main_loop(const Args& p, T* smem, int m0, int n0,
                                          Compute&& compute) {
  using G = Geo<T, BM, 0>;
  Raw<T, BM> raw;
  const int steps = p.k / kBK;
  load_raw<T, BM>(raw, p, 0, m0, n0);
  for (int kt = 0; kt < steps; ++kt) {
    T* xs = smem + (kt & 1) * G::kStage;
    T* ws = xs + G::kXElems;
    // the stage written here was last read two steps ago, before the
    // barrier of the previous step
    store_raw<T, BM>(raw, p, xs, ws);
    __syncthreads();
    if (kt + 1 < steps) load_raw<T, BM>(raw, p, (kt + 1) * kBK, m0, n0);
    compute(xs, ws);
  }
  __syncthreads();
}

// y, finished for one output element from its f32 sums
template <typename T, int R>
__device__ __forceinline__ float finish(const Args& p, float acc, int gcol, float xab) {
  float y = rnd<T>(acc);
  if (p.bias != nullptr)
    y = rnd<T>(__fadd_rn(y, to_f32(static_cast<const T*>(p.bias)[gcol])));
  if constexpr (R > 0) {
    const float d = rnd<T>(__fmul_rn(rnd<T>(xab), p.lora_scale));
    y = rnd<T>(__fadd_rn(y, d));
  }
  return y;
}

// f32: FMA on the CUDA cores. Thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 i and columns tx + 16 j of the block. xa = x A comes from
// qmm_xa_f32_kernel through the workspace (f32 [M, chunks * R]); the
// epilogue adds xa B one rank chunk at a time.
template <int BM, int R>
__device__ void run_fma(const Args& p, float* smem) {
  using T = float;
  using G = Geo<T, BM, R>;
  constexpr int kRows = BM / 16, kCols = kBN / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float acc[kRows][kCols] = {};
  main_loop<T, BM>(p, smem, m0, n0, [&](const T* xs, const T* ws) {
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) av[i] = xs[(ty + 16 * i) * G::kXs + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float bv = ws[kk * G::kWs + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
      }
    }
  });

  float d[kRows][kCols] = {};
  if constexpr (R > 0) {
    float* xa = smem;
    float* bs = smem + BM * G::kAs;
    const int chunks = rank_chunks(p.rank, R), rpad = chunks * R;
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = ch * R;
      for (int e = threadIdx.x; e < BM * R; e += kThreads) {
        const int r = e / R, j = e % R;
        xa[r * G::kAs + j] = m0 + r < p.m ? p.ws[(size_t)(m0 + r) * rpad + c0 + j] : 0.f;
      }
      for (int e = threadIdx.x; e < R * kBN; e += kThreads) {
        const int r = e / kBN, cc = e % kBN;
        bs[r * G::kWs + cc] = c0 + r < p.rank && n0 + cc < p.n
            ? lora_at(p.b, (size_t)(c0 + r) * p.n + n0 + cc, p.lora_bf16) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          for (int r = 0; r < R; ++r)
            d[i][j] = fmaf(xa[(ty + 16 * i) * G::kAs + r], bs[r * G::kWs + tx + 16 * j], d[i][j]);
      __syncthreads();  // the chunk's readers are done before the next is stored
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (row < p.m && n0 + col < p.n)
        static_cast<float*>(p.out)[(size_t)row * p.n + n0 + col] =
            finish<float, R>(p, acc[i][j], n0 + col, d[i][j]);
    }
  }
}

// xa = x A in f32 for the f32 route, into the workspace as f32 [M, chunks *
// R] (zeros past the rank): grid (M / 64, chunks), a block per 64 rows and
// one rank chunk, thread (ty, tx) on rows ty + 16 i and chunk columns tx + 16
// j, K in steps of 32 through shared memory.
template <int R>
__global__ void __launch_bounds__(kThreads) qmm_xa_f32_kernel(Args p) {
  constexpr int kRows = 64 / 16, kCols = R / 16;
  __shared__ float xs[64][kBK + 1];
  __shared__ float as[kBK][R];
  const int m0 = blockIdx.x * 64, c0 = blockIdx.y * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* x = static_cast<const float*>(p.x);
  float acc[kRows][kCols] = {};
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    for (int e = threadIdx.x; e < 64 * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      xs[r][kk] = m0 + r < p.m ? x[(size_t)(m0 + r) * p.k + k0 + kk] : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * R; e += kThreads) {
      const int kk = e / R, j = e % R;
      as[kk][j] = c0 + j < p.rank
          ? lora_at(p.a, (size_t)(k0 + kk) * p.rank + c0 + j, p.lora_bf16) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(xs[ty + 16 * i][kk], as[kk][tx + 16 * j], acc[i][j]);
    }
    __syncthreads();
  }
  const int rpad = gridDim.y * R;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) p.ws[(size_t)row * rpad + c0 + tx + 16 * j] = acc[i][j];
  }
}

template <typename T, int BM, int R>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  run_fma<BM, R>(p, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int BM, int R>
int launch(const Args& p, cudaStream_t stream) {
  constexpr int kBytes = Geo<T, BM, R>::kBytes;
  // raising the dynamic shared-memory cap once per kernel instance (one
  // device per process)
  static bool cap_set = false;
  if (!cap_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_matmul_kernel<T, BM, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return (int)e;
    cap_set = true;
  }
  if constexpr (R > 0) {
    qmm_xa_f32_kernel<R><<<dim3((p.m + 63) / 64, rank_chunks(p.rank, R)), kThreads, 0,
                           stream>>>(p);
    if (int e = (int)cudaGetLastError()) return e;
  }
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + BM - 1) / BM);
  quant_matmul_kernel<T, BM, R><<<grid, kThreads, kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// the rank's chunk width: 32 up to rank 32, else 64 (any rank, in chunks)
template <typename T, int BM>
int launch_rank(const Args& p, cudaStream_t stream) {
  if (p.rank == 0) return launch<T, BM, 0>(p, stream);
  if (p.rank <= 32) return launch<T, BM, 32>(p, stream);
  return launch<T, BM, 64>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores, with the weight dequantized into the operand
// fragments in registers (see the note at the top).

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared through L2 only; `pred` false writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kStepK = 64;  // K per pipeline stage

// the [BM][64] bf16 x tile, 16-byte chunks XOR-swizzled by row & 7
__device__ __forceinline__ int x_at(int row, int chunk) {
  return row * kStepK + ((chunk ^ (row & 7)) << 3);
}

// dequantized values: v = T(q * scale) with q from its integer bits by
// exact float arithmetic (2^23 + u - bias), then one f32 product and one
// rounding to bf16 (the pair packed, the lower k in the low half)
__device__ __forceinline__ float nib(uint32_t wx, int pos) {  // wx = word ^ 0x88888888
  return __fsub_rn(__uint_as_float(0x4B000000u | ((wx >> pos) & 0xFu)), 8388616.0f);
}
__device__ __forceinline__ float byt(uint32_t wx, int t) {  // wx = word ^ 0x80808080
  return __fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 | t)), 8388736.0f);
}
__device__ __forceinline__ uint32_t dq2(float lo, float hi, float s) {
  return pack_bf16x2(__fmul_rn(lo, s), __fmul_rn(hi, s));
}
__device__ __forceinline__ float sc(const float4& s, int t) {
  return t == 0 ? s.x : t == 1 ? s.y : t == 2 ? s.z : s.w;
}

// Tile geometry of one instance: BM rows x BN = 2 BM columns, BM / 16 warps
// side by side, each owning all BM rows and 32 columns.
template <int BM, int BITS, int R>
struct MmaGeo {
  static constexpr int kThreads = 2 * BM;
  static constexpr int kBN = 2 * BM;
  static constexpr int kMt = BM / 16;  // m16 tiles a warp (also the warp count)
  static constexpr int kWRows = BITS == 4 ? kStepK / 2 : kStepK;  // payload rows a stage
  // payload row stride: the 4 lanes that share a column group read rows
  // 1 (int4) or 2 (int8) apart; the padding puts them 8 banks apart
  static constexpr int kSW = kBN + (BITS == 4 ? 32 : 16);
  static constexpr int kXBytes = BM * kStepK * 2;
  static constexpr int kWBytes = kWRows * kSW;
  static constexpr int kAs = R + 8;  // adapter A tile [64][kAs] bf16 and xa [BM][kAs]
  static constexpr int kABytes = R > 0 ? 2 * kStepK * kAs * 2 : 0;
  static constexpr int kBs = kBN + 8;  // adapter B tile [R][kBs] bf16
  static constexpr int kEpiBytes = R > 0 ? (BM * kAs + R * kBs) * 2 : 0;
  static constexpr int kAVals = R > 0 ? kStepK * R / kThreads : 1;
  __host__ __device__ static int stage_bytes(int srows) { return kXBytes + kWBytes + srows * kBN * 4; }
};

// Main kernel, bf16 x. Grid (N / BN, M / BM, splits): split z covers K rows
// [z kchunk, min(K, (z + 1) kchunk)). One split: the full epilogue here,
// with xa = T(x A) read from the workspace (qmm_xa_kernel wrote it), one
// rank chunk at a time. Several: f32 partial sums of y, and from column
// block c < chunks those of x A's rank chunk c, into the workspace,
// finished by qmm_reduce_kernel (the grid holds at least `chunks` column
// blocks; one past N computes only its chunk of x A).
template <int BM, int BITS, int R, int STAGES>
__global__ void __launch_bounds__(2 * BM, 2) qmm_mma_kernel(Args p) {
  using G = MmaGeo<BM, BITS, R>;
  using T = __nv_bfloat16;
  constexpr int NT = G::kThreads, BN = G::kBN, MT = G::kMt;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const int stage_bytes = G::stage_bytes(p.srows);
  T* a_s = reinterpret_cast<T*>(smem + STAGES * stage_bytes);  // [2][64][kAs]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int kbeg = z * p.kchunk, kend = min(p.k, kbeg + p.kchunk);
  const int steps = (kend - kbeg + kStepK - 1) / kStepK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool split = p.splits > 1;
  // x A in the K loop: split calls, rank chunk blockIdx.x of the first
  // `chunks` column blocks
  constexpr bool kLoopXa = R > 0;
  const int chunks = rank_chunks(p.rank, R), c0 = blockIdx.x * R;
  const bool do_xa = kLoopXa && split && (int)blockIdx.x < chunks;
  const bool vec_q = p.n % 16 == 0, vec_s = p.n % 4 == 0;
  const T* x = static_cast<const T*>(p.x);

  auto load_stage = [&](int j) {
    unsigned char* st = smem + (j % STAGES) * stage_bytes;
    const int k0 = kbeg + j * kStepK;
    T* xs = reinterpret_cast<T*>(st);
    for (int i = tid; i < BM * 8; i += NT) {
      const int r = i >> 3, ch = i & 7;
      const bool ok = m0 + r < p.m && k0 + ch * 8 < kend;
      cp_async16(xs + x_at(r, ch), ok ? x + (size_t)(m0 + r) * p.k + k0 + ch * 8 : x, ok);
    }
    unsigned char* ws = st + G::kXBytes;
    const int qrow0 = BITS == 4 ? k0 / 2 : k0;
    const int qrows = BITS == 4 ? (kend - k0) / 2 : kend - k0;
    if (vec_q) {
      for (int i = tid; i < G::kWRows * (BN / 16); i += NT) {
        const int r = i / (BN / 16), cb = (i % (BN / 16)) * 16;
        const bool ok = r < qrows && n0 + cb < p.n;
        cp_async16(ws + r * G::kSW + cb, ok ? p.q + (size_t)(qrow0 + r) * p.n + n0 + cb : p.q,
                   ok);
      }
    } else {  // ragged N: plain byte loads (edge shapes only)
      for (int i = tid; i < G::kWRows * BN; i += NT) {
        const int r = i / BN, cb = i % BN;
        const bool ok = r < qrows && n0 + cb < p.n;
        ws[r * G::kSW + cb] = ok ? (unsigned char)p.q[(size_t)(qrow0 + r) * p.n + n0 + cb] : 0;
      }
    }
    float* ss = reinterpret_cast<float*>(st + G::kXBytes + G::kWBytes);
    const int gb = k0 / p.group, groups = p.k / p.group;
    if (vec_s) {
      for (int i = tid; i < p.srows * (BN / 4); i += NT) {
        const int r = i / (BN / 4), cb = (i % (BN / 4)) * 4;
        const bool ok = gb + r < groups && n0 + cb < p.n;
        cp_async16(ss + r * BN + cb, ok ? p.scale + (size_t)(gb + r) * p.n + n0 + cb : p.scale,
                   ok);
      }
    } else {
      for (int i = tid; i < p.srows * BN; i += NT) {
        const int r = i / BN, cb = i % BN;
        const bool ok = gb + r < groups && n0 + cb < p.n;
        ss[r * BN + cb] = ok ? p.scale[(size_t)(gb + r) * p.n + n0 + cb] : 0.f;
      }
    }
  };
  // the adapter's A, one stage ahead through registers (any rank, f32 or
  // bf16), rounded to bf16 into a double buffer
  float areg[G::kAVals];
  auto load_a = [&](int j) {
    if constexpr (R > 0) {
      const int k0 = kbeg + j * kStepK;
#pragma unroll
      for (int v = 0; v < G::kAVals; ++v) {
        const int e = tid + v * NT, r = e / R, col = c0 + e % R;
        areg[v] = k0 + r < kend && col < p.rank
            ? lora_at(p.a, (size_t)(k0 + r) * p.rank + col, p.lora_bf16) : 0.f;
      }
    }
  };
  auto store_a = [&](int j) {
    if constexpr (R > 0) {
      T* as = a_s + (j & 1) * kStepK * G::kAs;
#pragma unroll
      for (int v = 0; v < G::kAVals; ++v) {
        const int e = tid + v * NT;
        as[(e / R) * G::kAs + e % R] = __float2bfloat16(areg[v]);
      }
    }
  };

  float acc[MT][4][4] = {};
  float xacc[R > 0 ? R / 8 : 1][4] = {};
  const int cw = warp * 32 + 4 * g;  // this lane's weight columns cw .. cw + 3 in the tile
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_commit();
  }
  if (do_xa && steps > 0) load_a(0);
  for (int i = 0; i < steps; ++i) {
    cp_wait<STAGES - 2>();
    if (do_xa) store_a(i);  // its buffer was last read at step i - 2
    __syncthreads();
    if (i + STAGES - 1 < steps) load_stage(i + STAGES - 1);
    cp_commit();
    if (do_xa && i + 1 < steps) load_a(i + 1);

    const unsigned char* st = smem + (i % STAGES) * stage_bytes;
    const T* xs = reinterpret_cast<const T*>(st);
    const unsigned char* ws = st + G::kXBytes;
    const float* ss = reinterpret_cast<const float*>(st + G::kXBytes + G::kWBytes);
    const int k0 = kbeg + i * kStepK, gb = k0 / p.group;
    const bool one_group = p.group % kStepK == 0;  // the stage lies in one group
#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk) {
      // B fragments of the warp's four n8 tiles: tile t's column j is the
      // tile's column 4 j + t, so one 32-bit word of a payload row holds
      // this lane's byte of all four tiles
      const int kr = k0 + 16 * kk + 2 * c;  // this lane's k rows: kr, kr + 1, kr + 8, kr + 9
      const int r0 = one_group ? 0 : kr / p.group - gb;
      const int r1 = one_group ? 0 : (kr + 8) / p.group - gb;
      const float4 s0 = *reinterpret_cast<const float4*>(ss + r0 * BN + cw);
      const float4 s1 = one_group ? s0 : *reinterpret_cast<const float4*>(ss + r1 * BN + cw);
      uint32_t bq[4][2];
      if constexpr (BITS == 4) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ws + (8 * kk + c) * G::kSW + cw)
                            ^ 0x88888888u;
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ws + (8 * kk + c + 4) * G::kSW + cw)
                            ^ 0x88888888u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          bq[t][0] = dq2(nib(w0, 8 * t), nib(w0, 8 * t + 4), sc(s0, t));
          bq[t][1] = dq2(nib(w1, 8 * t), nib(w1, 8 * t + 4), sc(s1, t));
        }
      } else {
        const unsigned char* wr = ws + (16 * kk + 2 * c) * G::kSW + cw;
        const uint32_t wa = *reinterpret_cast<const uint32_t*>(wr) ^ 0x80808080u;
        const uint32_t wb = *reinterpret_cast<const uint32_t*>(wr + G::kSW) ^ 0x80808080u;
        const uint32_t wc = *reinterpret_cast<const uint32_t*>(wr + 8 * G::kSW) ^ 0x80808080u;
        const uint32_t wd = *reinterpret_cast<const uint32_t*>(wr + 9 * G::kSW) ^ 0x80808080u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          bq[t][0] = dq2(byt(wa, t), byt(wb, t), sc(s0, t));
          bq[t][1] = dq2(byt(wc, t), byt(wd, t), sc(s1, t));
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t af[4];
        ldsm_x4(af, xs + x_at(16 * mi + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_bf16(acc[mi][t], af, bq[t][0], bq[t][1]);
      }
      if constexpr (kLoopXa) {
        if (do_xa) {  // x A for the warp's own m16 tile
          const T* as = a_s + (i & 1) * kStepK * G::kAs;
          uint32_t af[4];
          ldsm_x4(af, xs + x_at(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
          for (int j = 0; j < R / 8; j += 2) {
            uint32_t bf[4];
            ldsm_x4_trans(bf, as + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * G::kAs +
                                  8 * j + (lane >> 4) * 8);
            mma_bf16(xacc[j], af, bf[0], bf[1]);
            mma_bf16(xacc[j + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // lane (g, c) holds, for m16 tile mi and half h, row 16 mi + g + 8 h and
  // the 8 columns 8 c + q of its warp's 32 (q = 4 e + t: tile t, element e)
  const int col0 = n0 + warp * 32 + 8 * c;
  if (split) {
    float* wy = p.ws + (size_t)z * p.m * p.n;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * mi + g + 8 * h;
        if (row >= p.m) continue;
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = acc[mi][q & 3][2 * h + (q >> 2)];
        float* dst = wy + (size_t)row * p.n + col0;
        if (vec_s && col0 + 8 <= p.n) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (col0 + q < p.n) dst[q] = v[q];
        }
      }
    }
    if constexpr (kLoopXa) {
      if (do_xa) {
        float* wxa = p.ws + (size_t)p.splits * p.m * p.n + (size_t)z * p.m * p.rank;
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + 16 * warp + g + 8 * (e >> 1);
            const int r = c0 + 8 * j + 2 * c + (e & 1);
            if (row < p.m && r < p.rank) wxa[(size_t)row * p.rank + r] = xacc[j][e];
          }
        }
      }
    }
    return;
  }

  T* xa_s = reinterpret_cast<T*>(smem);  // [BM][kAs]
  T* b_s = xa_s + BM * G::kAs;           // [R][kBs]
  // xab for all MT m16 tiles, summed over the rank chunks
  float d[MT][4][4] = {};
  if constexpr (R > 0) {
    const T* xa = reinterpret_cast<const T*>(p.ws);
    const int rpad = chunks * R;
    for (int ch = 0; ch < chunks; ++ch) {
      const int r0 = ch * R;
      // the chunk of xa (already rounded to T) and of B cast to T (rows past
      // the rank or M and columns past N are 0)
      for (int e = tid; e < BM * R; e += NT) {
        const int r = e / R, j = e % R;
        xa_s[r * G::kAs + j] =
            m0 + r < p.m ? xa[(size_t)(m0 + r) * rpad + r0 + j] : __float2bfloat16(0.f);
      }
      for (int e = tid; e < R * BN; e += NT) {
        const int r = e / BN, cc = e % BN;
        const float v = r0 + r < p.rank && n0 + cc < p.n
            ? lora_at(p.b, (size_t)(r0 + r) * p.n + n0 + cc, p.lora_bf16) : 0.f;
        b_s[r * G::kBs + cc] = __float2bfloat16(v);
      }
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, xa_s + (16 * mi + (lane & 15)) * G::kAs + 16 * kk + (lane >> 4) * 8);
          const T* br = b_s + (16 * kk + 2 * c) * G::kBs + warp * 32 + 4 * g;
          const uint2 ra = *reinterpret_cast<const uint2*>(br);
          const uint2 rb = *reinterpret_cast<const uint2*>(br + G::kBs);
          const uint2 rc = *reinterpret_cast<const uint2*>(br + 8 * G::kBs);
          const uint2 rd = *reinterpret_cast<const uint2*>(br + 9 * G::kBs);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int sh = 16 * (t & 1);
            const uint32_t a0 = ((t < 2 ? ra.x : ra.y) >> sh) & 0xffffu;
            const uint32_t a1 = ((t < 2 ? rb.x : rb.y) >> sh) & 0xffffu;
            const uint32_t a2 = ((t < 2 ? rc.x : rc.y) >> sh) & 0xffffu;
            const uint32_t a3 = ((t < 2 ? rd.x : rd.y) >> sh) & 0xffffu;
            mma_bf16(d[mi][t], af, a0 | (a1 << 16), a2 | (a3 << 16));
          }
        }
      }
      __syncthreads();  // the chunk's readers are done before the next is stored
    }
  }
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * mi + g + 8 * h;
      if (row >= p.m) continue;
      float y[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = min(col0 + q, p.n - 1);
        y[q] = finish<T, R>(p, acc[mi][q & 3][2 * h + (q >> 2)], col,
                            d[mi][q & 3][2 * h + (q >> 2)]);
      }
      T* dst = out + (size_t)row * p.n + col0;
      if (p.n % 8 == 0 && col0 + 8 <= p.n) {
        uint4 u;
        u.x = pack_bf16x2(y[0], y[1]);
        u.y = pack_bf16x2(y[2], y[3]);
        u.z = pack_bf16x2(y[4], y[5]);
        u.w = pack_bf16x2(y[6], y[7]);
        *reinterpret_cast<uint4*>(dst) = u;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (col0 + q < p.n) dst[q] = __float2bfloat16(y[q]);
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// A fragments that an issued wgmma may still read: an empty asm that
// "uses and redefines" them, so the compiler keeps each in its register
// (and reuses none of them) up to this point
__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile("" : "+r"(a[kk][0]), "+r"(a[kk][1]), "+r"(a[kk][2]), "+r"(a[kk][3]));
}
// the accumulators likewise: no instruction of the compiler's may move or
// redefine them while a wgmma that writes them is in flight
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// wgmma descriptor of a K-major bf16 tile at `p`: rows of 64 values (128
// bytes) XOR-swizzled as x_at does (the 128-byte swizzle; the tile starts
// 1024-aligned, `p` may add a k offset inside a row), 8-row groups 1024 bytes
// apart
__device__ __forceinline__ uint64_t x_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 256, f32) = a (64 x 16 bf16, registers) . b (16 x 256 bf16, shared
// memory, K-major, 128-byte swizzle; `desc`) + (accumulate ? d : 0), one
// warpgroup
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The wgmma kernel's tile: 256 tokens by 128 output columns, two warpgroups
// of 64 columns each.
template <int BITS, int R>
struct WgGeo {
  static constexpr int kTok = 256;
  static constexpr int kThreads = 256;
  static constexpr int kBN = 128;
  static constexpr int kWRows = BITS == 4 ? kStepK / 2 : kStepK;  // payload rows a stage
  // payload row stride: the 4 lanes that share a column pair read rows 1
  // (int4) or 2 (int8) apart; 16 bytes of padding put them 4 or 8 banks apart
  static constexpr int kSW = kBN + 16;
  static constexpr int kXBytes = kTok * kStepK * 2;
  static constexpr int kWBytes = kWRows * kSW;
  static constexpr int kAs = R + 8;  // xa [kTok][kAs] bf16, beside the ring
  static constexpr int kXaBytes = R > 0 ? kTok * kAs * 2 : 0;
  __host__ __device__ static int stage_bytes(int srows) {
    return (kXBytes + kWBytes + srows * kBN * 4 + 1023) / 1024 * 1024;
  }
};

// Main kernel above 512 rows, bf16 x, on wgmma: the transposed tile y^T =
// W^T x^T, with W^T (64 output columns a warpgroup) the register-sourced A
// operand, dequantized from the staged payload, and x^T the shared-memory B
// operand (256 tokens). Grid (N / 128, M / 256), K whole; xa = T(x A) comes
// from qmm_xa_kernel through the workspace.
template <int BITS, int R, int STAGES>
__global__ void __launch_bounds__(256, 1) qmm_wgmma_kernel(Args p) {
  using G = WgGeo<BITS, R>;
  using T = __nv_bfloat16;
  constexpr int NT = G::kThreads, BN = G::kBN, NTOK = G::kTok;
  constexpr int L = STAGES - 2;  // loads run L stages ahead
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  const int stage_bytes = G::stage_bytes(p.srows);
  T* xa_s = reinterpret_cast<T*>(smem + STAGES * stage_bytes);  // [NTOK][kAs]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NTOK;
  const int steps = (p.k + kStepK - 1) / kStepK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool vec_q = p.n % 16 == 0, vec_s = p.n % 4 == 0;
  const T* x = static_cast<const T*>(p.x);
  // this lane's two weight columns: its warpgroup's A rows g and g + 8
  const int cw = 64 * (warp >> 2) + 16 * (warp & 3) + 2 * g;

  // xa's rank chunk r0 for the epilogue (rows past M 0): the first lands
  // during the loop
  const int chunks = rank_chunks(p.rank, R), rpad = chunks * R;
  auto load_xa = [&](int r0) {
    if constexpr (R > 0) {
      const T* xa = reinterpret_cast<const T*>(p.ws);
      for (int e = tid; e < NTOK * (R / 8); e += NT) {
        const int r = e / (R / 8), ch = e % (R / 8);
        const bool ok = m0 + r < p.m;
        cp_async16(xa_s + r * G::kAs + 8 * ch,
                   ok ? xa + (size_t)(m0 + r) * rpad + r0 + 8 * ch : xa, ok);
      }
    }
  };
  load_xa(0);
  cp_commit();
  auto load_stage = [&](int j) {
    unsigned char* st = smem + (j % STAGES) * stage_bytes;
    const int k0 = j * kStepK;
    T* xs = reinterpret_cast<T*>(st);
    for (int i = tid; i < NTOK * 8; i += NT) {
      const int r = i >> 3, ch = i & 7;
      const bool ok = m0 + r < p.m && k0 + ch * 8 < p.k;
      cp_async16(xs + x_at(r, ch), ok ? x + (size_t)(m0 + r) * p.k + k0 + ch * 8 : x, ok);
    }
    unsigned char* ws = st + G::kXBytes;
    const int qrow0 = BITS == 4 ? k0 / 2 : k0;
    const int qrows = BITS == 4 ? (p.k - k0) / 2 : p.k - k0;
    if (vec_q) {
      for (int i = tid; i < G::kWRows * (BN / 16); i += NT) {
        const int r = i / (BN / 16), cb = (i % (BN / 16)) * 16;
        const bool ok = r < qrows && n0 + cb < p.n;
        cp_async16(ws + r * G::kSW + cb, ok ? p.q + (size_t)(qrow0 + r) * p.n + n0 + cb : p.q,
                   ok);
      }
    } else {  // ragged N: plain byte loads (edge shapes only)
      for (int i = tid; i < G::kWRows * BN; i += NT) {
        const int r = i / BN, cb = i % BN;
        const bool ok = r < qrows && n0 + cb < p.n;
        ws[r * G::kSW + cb] = ok ? (unsigned char)p.q[(size_t)(qrow0 + r) * p.n + n0 + cb] : 0;
      }
    }
    float* ss = reinterpret_cast<float*>(st + G::kXBytes + G::kWBytes);
    const int gb = k0 / p.group, groups = p.k / p.group;
    if (vec_s) {
      for (int i = tid; i < p.srows * (BN / 4); i += NT) {
        const int r = i / (BN / 4), cb = (i % (BN / 4)) * 4;
        const bool ok = gb + r < groups && n0 + cb < p.n;
        cp_async16(ss + r * BN + cb, ok ? p.scale + (size_t)(gb + r) * p.n + n0 + cb : p.scale,
                   ok);
      }
    } else {
      for (int i = tid; i < p.srows * BN; i += NT) {
        const int r = i / BN, cb = i % BN;
        const bool ok = gb + r < groups && n0 + cb < p.n;
        ss[r * BN + cb] = ok ? p.scale[(size_t)(gb + r) * p.n + n0 + cb] : 0.f;
      }
    }
  };

  float acc[NTOK / 2];  // the first product overwrites it (accumulate 0)
  const bool one_group = p.group % kStepK == 0;  // a stage lies in one group
#pragma unroll
  for (int s = 0; s < L; ++s) {
    if (s < steps) load_stage(s);
    cp_commit();
  }
  // stage i: its A fragments in `a` (kept in registers until stage i + 1
  // has waited for stage i's products), `prev` those of stage i - 1
  auto run_stage = [&](int i, uint32_t (&a)[kStepK / 16][4], uint32_t (&prev)[kStepK / 16][4]) {
    cp_wait<L - 1>();
    fence_async_smem();
    __syncthreads();  // stage i landed for all; every wgmma of stage i - 2 is done
    if (i + L < steps) load_stage(i + L);
    cp_commit();

    const unsigned char* st = smem + (i % STAGES) * stage_bytes;
    const T* xs = reinterpret_cast<const T*>(st);
    const unsigned char* ws = st + G::kXBytes;
    const float* ss = reinterpret_cast<const float*>(st + G::kXBytes + G::kWBytes);
    const int k0 = i * kStepK, gb = k0 / p.group;
#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk) {
      const int kr = k0 + 16 * kk + 2 * c;  // this lane's k rows: kr, kr + 1, kr + 8, kr + 9
      const int r0 = one_group ? 0 : kr / p.group - gb;
      const int r1 = one_group ? 0 : (kr + 8) / p.group - gb;
      const float2 s0 = *reinterpret_cast<const float2*>(ss + r0 * BN + cw);
      const float2 s1 = one_group ? s0 : *reinterpret_cast<const float2*>(ss + r1 * BN + cw);
      if constexpr (BITS == 4) {
        const uint32_t u0 =
            *reinterpret_cast<const uint16_t*>(ws + (8 * kk + c) * G::kSW + cw) ^ 0x8888u;
        const uint32_t u1 =
            *reinterpret_cast<const uint16_t*>(ws + (8 * kk + c + 4) * G::kSW + cw) ^ 0x8888u;
        a[kk][0] = dq2(nib(u0, 0), nib(u0, 4), s0.x);
        a[kk][1] = dq2(nib(u0, 8), nib(u0, 12), s0.y);
        a[kk][2] = dq2(nib(u1, 0), nib(u1, 4), s1.x);
        a[kk][3] = dq2(nib(u1, 8), nib(u1, 12), s1.y);
      } else {
        const unsigned char* wr = ws + (16 * kk + 2 * c) * G::kSW + cw;
        const uint32_t ua = *reinterpret_cast<const uint16_t*>(wr) ^ 0x8080u;
        const uint32_t ub = *reinterpret_cast<const uint16_t*>(wr + G::kSW) ^ 0x8080u;
        const uint32_t uc = *reinterpret_cast<const uint16_t*>(wr + 8 * G::kSW) ^ 0x8080u;
        const uint32_t ud = *reinterpret_cast<const uint16_t*>(wr + 9 * G::kSW) ^ 0x8080u;
        a[kk][0] = dq2(byt(ua, 0), byt(ub, 0), s0.x);
        a[kk][1] = dq2(byt(ua, 1), byt(ub, 1), s0.y);
        a[kk][2] = dq2(byt(uc, 0), byt(ud, 0), s1.x);
        a[kk][3] = dq2(byt(uc, 1), byt(ud, 1), s1.y);
      }
    }
    keep(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk)
      wgmma_n256(acc, a[kk], x_desc(xs + 16 * kk), i > 0 || kk > 0);
    wg_commit();
    keep(a);
    keep(acc);
    wg_wait<1>();  // stage i - 1's products are done; stage i's may still run
    keep(prev);
    keep(acc);
  };
  uint32_t af0[kStepK / 16][4] = {}, af1[kStepK / 16][4] = {};
  for (int i = 0; i < steps; i += 2) {  // two stages a trip: af0 and af1 stay registers
    run_stage(i, af0, af1);
    if (i + 1 < steps) run_stage(i + 1, af1, af0);
  }
  // B^T rows cw and cw + 1 of rank chunk r0 as mma A fragments
  uint32_t bt[R > 0 ? R / 16 : 1][4] = {};
  auto load_bt = [&](int r0) {
    if constexpr (R > 0) {
      auto b_at = [&](int r, int col) {
        return r < p.rank && n0 + col < p.n
            ? rnd<T>(lora_at(p.b, (size_t)r * p.n + n0 + col, p.lora_bf16)) : 0.f;
      };
#pragma unroll
      for (int kr = 0; kr < R / 16; ++kr) {
        const int r = r0 + 16 * kr + 2 * c;
        bt[kr][0] = pack_bf16x2(b_at(r, cw), b_at(r + 1, cw));
        bt[kr][1] = pack_bf16x2(b_at(r, cw + 1), b_at(r + 1, cw + 1));
        bt[kr][2] = pack_bf16x2(b_at(r + 8, cw), b_at(r + 9, cw));
        bt[kr][3] = pack_bf16x2(b_at(r + 8, cw + 1), b_at(r + 9, cw + 1));
      }
    }
  };
  load_bt(0);  // while the last stage's products finish
  wg_wait<0>();
  keep(af0);
  keep(af1);
  keep(acc);
  cp_wait<0>();

  __syncthreads();  // the ring is free: T(y) and T(T(xab) s) are staged there in bf16

  // acc[4 j + e] holds column cw + (e >> 1) of token 8 j + 2 c + (e & 1);
  // xab^T = B^T xa^T on mma.sync lands in the same layout. A straight-line
  // epilogue over all 128 accumulators outgrows the instruction cache, so
  // this part only rounds and stages; the roundings that remain run in a
  // loop below. T(y) is staged first, so that xab's 128 sums, taken over
  // the rank chunks, have the accumulators' registers.
  constexpr int kYs = BN + 8;
  T* ys = reinterpret_cast<T*>(smem);  // [NTOK][kYs]: T(y)
  T* ds = ys + NTOK * kYs;             // [NTOK][kYs]: T(T(xab) s)
#pragma unroll
  for (int j = 0; j < NTOK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 8 * j + 2 * c + e;
      *reinterpret_cast<uint32_t*>(ys + t * kYs + cw) =
          pack_bf16x2(acc[4 * j + e], acc[4 * j + 2 + e]);
    }
  }
  if constexpr (R > 0) {
    float d[NTOK / 8][4] = {};
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch > 0) {  // the next chunk of xa and of B^T
        __syncthreads();  // every warp is done with the previous chunk of xa
        load_xa(ch * R);
        cp_commit();
        load_bt(ch * R);
        cp_wait<0>();
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < NTOK / 8; ++j) {
#pragma unroll
        for (int kr = 0; kr < R / 16; ++kr) {
          uint32_t xb[2];  // xa^T's k16 x n8 tile: xa rows 8 j .. 8 j + 7
          ldsm_x2(xb, xa_s + (8 * j + (lane & 7)) * G::kAs + 16 * kr + ((lane >> 3) & 1) * 8);
          mma_bf16(d[j], bt[kr], xb[0], xb[1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NTOK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * j + 2 * c + e;
        *reinterpret_cast<uint32_t*>(ds + t * kYs + cw) =
            pack_bf16x2(__fmul_rn(rnd<T>(d[j][e]), p.lora_scale),
                        __fmul_rn(rnd<T>(d[j][2 + e]), p.lora_scale));
      }
    }
  }
  __syncthreads();
  // a thread per column pair and every fourth token: bias, adapter, store
  const int pc = 2 * (tid & 63), col = n0 + pc;
  const bool pair = col + 1 < p.n && p.n % 2 == 0;
  const T* bias = static_cast<const T*>(p.bias);
  const float b0 = bias != nullptr && col < p.n ? to_f32(bias[col]) : 0.f;
  const float b1 = bias != nullptr && col + 1 < p.n ? to_f32(bias[col + 1]) : 0.f;
  T* out = static_cast<T*>(p.out);
  for (int t = tid >> 6; t < NTOK && m0 + t < p.m; t += NT / 64) {
    const __nv_bfloat162 yv = *reinterpret_cast<const __nv_bfloat162*>(ys + t * kYs + pc);
    float y0 = __low2float(yv), y1 = __high2float(yv);
    if (bias != nullptr) {
      y0 = rnd<T>(__fadd_rn(y0, b0));
      y1 = rnd<T>(__fadd_rn(y1, b1));
    }
    if constexpr (R > 0) {
      const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(ds + t * kYs + pc);
      y0 = __fadd_rn(y0, __low2float(dv));
      y1 = __fadd_rn(y1, __high2float(dv));
    }
    T* dst = out + (size_t)(m0 + t) * p.n + col;
    if (pair) {
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(y0, y1);
    } else {
      if (col < p.n) dst[0] = __float2bfloat16(y0);
      if (col + 1 < p.n) dst[1] = __float2bfloat16(y1);
    }
  }
}

// Finishes a split-K call: y summed over the splits in order, xa likewise
// and rounded to T, then the epilogue's roundings as in one split. Grid
// (N / 256, M / row_block): a thread per column over `row_block` (<= 8)
// rows, B's column read once for them.
constexpr int kReduceRows = 8;

template <int R>
__global__ void __launch_bounds__(256) qmm_reduce_kernel(Args p, int row_block) {
  using T = __nv_bfloat16;
  __shared__ float xa_s[kReduceRows][R > 0 ? R : 1];
  const int m0 = blockIdx.y * row_block, col = blockIdx.x * 256 + threadIdx.x;
  const int rows = min(row_block, p.m - m0);
  float xab[kReduceRows] = {};
  if constexpr (R > 0) {  // one rank chunk at a time
    const float* wxa = p.ws + (size_t)p.splits * p.m * p.n;
    const int chunks = rank_chunks(p.rank, R);
    for (int ch = 0; ch < chunks; ++ch) {
      const int r0 = ch * R;
      if (ch > 0) __syncthreads();  // the previous chunk's readers are done
      for (int e = threadIdx.x; e < kReduceRows * R; e += 256) {
        const int r = e / R, j = e % R;
        float s = 0.f;
        if (r < rows && r0 + j < p.rank) {
          for (int z = 0; z < p.splits; ++z)
            s += wxa[((size_t)z * p.m + m0 + r) * p.rank + r0 + j];
        }
        xa_s[r][j] = rnd<T>(s);
      }
      __syncthreads();
      if (col < p.n) {
        float bcol[R];
#pragma unroll
        for (int j = 0; j < R; ++j)
          bcol[j] = r0 + j < p.rank
              ? rnd<T>(lora_at(p.b, (size_t)(r0 + j) * p.n + col, p.lora_bf16)) : 0.f;
#pragma unroll
        for (int r = 0; r < kReduceRows; ++r) {
          if (r < rows) {
#pragma unroll
            for (int j = 0; j < R; ++j) xab[r] = fmaf(xa_s[r][j], bcol[j], xab[r]);
          }
        }
      }
    }
  }
  if (col >= p.n) return;
#pragma unroll
  for (int r = 0; r < kReduceRows; ++r) {
    if (r >= rows) break;
    const int m = m0 + r;
    float acc = 0.f;
#pragma unroll 4
    for (int z = 0; z < p.splits; ++z) acc += p.ws[((size_t)z * p.m + m) * p.n + col];
    static_cast<T*>(p.out)[(size_t)m * p.n + col] =
        from_f32<T>(finish<T, R>(p, acc, col, xab[r]));
  }
}

// xa = T(x A) for the one-split calls, into the workspace as bf16 [M,
// chunks * R] (zeros past the rank), on mma.sync: grid (M / 64, chunks), a
// block of 4 warps per 64 rows and rank chunk, K in steps of 64 through two
// shared-memory stages (x by cp.async in x_at's layout, A rounded to bf16
// on its way in).
constexpr int kXaRows = 64;

template <int R>
__global__ void __launch_bounds__(128) qmm_xa_kernel(Args p) {
  using T = __nv_bfloat16;
  constexpr int kAs = R + 8;
  __shared__ __align__(128) T xs[2][kXaRows * kStepK];
  __shared__ __align__(16) T as[2][kStepK * kAs];
  const int m0 = blockIdx.x * kXaRows, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.y * R, rpad = gridDim.y * R;
  const T* x = static_cast<const T*>(p.x);
  const int steps = (p.k + kStepK - 1) / kStepK;
  auto load = [&](int i) {
    const int k0 = i * kStepK;
    for (int e = tid; e < kXaRows * 8; e += 128) {
      const int r = e >> 3, ch = e & 7;
      const bool ok = m0 + r < p.m && k0 + ch * 8 < p.k;
      cp_async16(xs[i & 1] + x_at(r, ch), ok ? x + (size_t)(m0 + r) * p.k + k0 + ch * 8 : x, ok);
    }
    for (int e = tid; e < kStepK * R; e += 128) {
      const int r = e / R, j = e % R;
      as[i & 1][r * kAs + j] = __float2bfloat16(
          k0 + r < p.k && c0 + j < p.rank
              ? lora_at(p.a, (size_t)(k0 + r) * p.rank + c0 + j, p.lora_bf16) : 0.f);
    }
    cp_commit();
  };
  float acc[R / 8][4] = {};
  load(0);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load(i + 1);  // its buffer's readers passed the last barrier
    if (i + 1 < steps) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();
    const T* xt = xs[i & 1];
    const T* at = as[i & 1];
#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, xt + x_at(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < R / 8; j += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, at + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kAs + 8 * j +
                              (lane >> 4) * 8);
        mma_bf16(acc[j], af, bf[0], bf[1]);
        mma_bf16(acc[j + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  T* xa = reinterpret_cast<T*>(p.ws);
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + g + 8 * h;
      if (row < p.m)
        *reinterpret_cast<uint32_t*>(xa + (size_t)row * rpad + c0 + 8 * j + 2 * c) =
            pack_bf16x2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

template <int BM, int BITS, int R, int STAGES>
int launch_mma(const Args& p, cudaStream_t stream) {
  using G = MmaGeo<BM, BITS, R>;
  const int loop = STAGES * G::stage_bytes(p.srows) + G::kABytes;
  const int smem = loop > G::kEpiBytes ? loop : G::kEpiBytes;
  static int cap = 0;  // the dynamic shared-memory cap set so far (one device per process)
  if (smem > cap) {
    const cudaError_t e = cudaFuncSetAttribute(qmm_mma_kernel<BM, BITS, R, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  const int chunks = rank_chunks(p.rank, R);
  if constexpr (R > 0) {
    if (p.splits == 1) {
      qmm_xa_kernel<R><<<dim3((p.m + kXaRows - 1) / kXaRows, chunks), 128, 0, stream>>>(p);
      if (int e = (int)cudaGetLastError()) return e;
    }
  }
  // a split call's x A takes one column block per rank chunk
  const int col_blocks = (p.n + G::kBN - 1) / G::kBN;
  const dim3 grid(p.splits > 1 ? max(col_blocks, chunks) : col_blocks, (p.m + BM - 1) / BM,
                  p.splits);
  qmm_mma_kernel<BM, BITS, R, STAGES><<<grid, G::kThreads, smem, stream>>>(p);
  if (int e = (int)cudaGetLastError()) return e;
  if (p.splits > 1) {
    // rows a block: enough blocks for two a SM, B's column read by few
    const int col_blocks = (p.n + 255) / 256;
    const int rows = max(1, min(kReduceRows, col_blocks * p.m / (2 * 132)));
    qmm_reduce_kernel<R><<<dim3(col_blocks, (p.m + rows - 1) / rows), 256, 0, stream>>>(p, rows);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <int BM, int STAGES, int R>
int launch_mma_bits(const Args& p, cudaStream_t stream) {
  return p.bits == 4 ? launch_mma<BM, 4, R, STAGES>(p, stream)
                     : launch_mma<BM, 8, R, STAGES>(p, stream);
}

template <int BM, int STAGES>
int launch_mma_rank(const Args& p, cudaStream_t stream) {
  if (p.rank == 0) return launch_mma_bits<BM, STAGES, 0>(p, stream);
  if (p.rank <= 32) return launch_mma_bits<BM, STAGES, 32>(p, stream);
  return launch_mma_bits<BM, STAGES, 64>(p, stream);
}

template <int BITS, int R, int STAGES>
int launch_wg(const Args& p, cudaStream_t stream) {
  using G = WgGeo<BITS, R>;
  const int smem = STAGES * G::stage_bytes(p.srows) + G::kXaBytes + 1024;  // + alignment
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;  // int8 in groups under 4
  static int cap = 0;  // the dynamic shared-memory cap set so far (one device per process)
  if (smem > cap) {
    const cudaError_t e = cudaFuncSetAttribute(qmm_wgmma_kernel<BITS, R, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  if constexpr (R > 0) {
    qmm_xa_kernel<R><<<dim3((p.m + kXaRows - 1) / kXaRows, rank_chunks(p.rank, R)), 128, 0,
                       stream>>>(p);
    if (int e = (int)cudaGetLastError()) return e;
  }
  const dim3 grid((p.n + G::kBN - 1) / G::kBN, (p.m + G::kTok - 1) / G::kTok);
  qmm_wgmma_kernel<BITS, R, STAGES><<<grid, G::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int STAGES, int R>
int launch_wg_bits(const Args& p, cudaStream_t stream) {
  return p.bits == 4 ? launch_wg<4, R, STAGES>(p, stream) : launch_wg<8, R, STAGES>(p, stream);
}

template <int STAGES>
int launch_wg_rank(const Args& p, cudaStream_t stream) {
  if (p.rank == 0) return launch_wg_bits<STAGES, 0>(p, stream);
  if (p.rank <= 32) return launch_wg_bits<STAGES, 32>(p, stream);
  return launch_wg_bits<STAGES, 64>(p, stream);
}

}  // namespace

extern "C" {

// x: [m, k] in `dtype` (0 = f32, 1 = bf16); q: int8 [k, n] (bits 8) or the
// int4 nibble form [k / 2, n] (bits 4), `group` rows of k per scale row;
// scale: f32 [k / group, n]; bias: `dtype` [n] or null; lora_a [k, rank] and
// lora_b [rank, n] in `lora_dtype` (0 = f32, 1 = bf16), or null with rank 0;
// lora_scale already rounded to `dtype`; out: [m, n] in `dtype`. All
// contiguous; x, q and scale 16-byte aligned. bf16 splits K into `splits`
// ranges of `k_per_split` rows (1: no split); with more than one,
// `workspace` is f32 scratch of splits * m * (n + rank) values; with one
// split and an adapter, xa [m, r] in `dtype` (r the rank padded to a
// multiple of 32 up to rank 32, else of 64); else null.
// `block_m` 64 or 256 picks the bf16 tile's tokens (f32: 64, one split). Runs on
// `stream` of `device`; returns the first CUDA error (0 = ok). The caller
// checks: k % 32 == 0, group divides k and is even (or is k), k_per_split a
// multiple of 64 and of the group, splits * k_per_split >= k. Any rank.
int quant_matmul_launch(const void* x, const void* q, const void* scale, const void* bias,
                        const void* lora_a, const void* lora_b, void* out, void* workspace,
                        int m, int k, int n, int group, int bits, int rank, float lora_scale,
                        int dtype, int lora_dtype, int block_m, int splits, int k_per_split,
                        int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  // scale rows one 64-row stage spans
  const int srows = group % kStepK == 0 ? 1 : (kStepK - 1) / group + 2;
  Args p{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale), bias, lora_a,
         lora_b, out, static_cast<float*>(workspace), m, k, n, group, bits, rank, lora_dtype,
         lora_scale, splits, k_per_split, srows};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    return block_m == 256 ? launch_wg_rank<4>(p, s) : launch_mma_rank<64, 4>(p, s);
  }
  p.splits = 1;
  return launch_rank<float, 64>(p, s);
}

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
