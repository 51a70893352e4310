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
// Design (simple and right first). Blocks of BM x 128 outputs (BM 64, or 128
// for bf16 at M > 64), 256 threads, a loop over K in steps of 32 (full K
// does not fit in shared memory: 18944 x 128 bf16 is 4.8 MB). Each step's
// tiles go through registers into one of two shared-memory stages, so the
// global loads of step k + 1 are in flight while step k computes:
//   x     16-byte loads, stored as they are;
//   q     loaded at storage width (16 bytes of int8, or 8 packed bytes =
//         16 int4 values, per thread), unpacked in registers with sign
//         extension, multiplied by the f32 scale of each value's group
//         (scale[k / g, n], so a tile may straddle groups), rounded once to
//         T and stored; the weight never exists at T width in device memory;
//   A     cast to T.
// bf16: the products run on the tensor cores, mma.sync m16n8k16 bf16 -> f32,
// operands from shared memory through ldmatrix (B transposed): 8 warps tile
// the block as 2 x 4 (BM 64) or 4 x 2 (BM 128) warp tiles of 32 rows. f32:
// FMA on the CUDA cores, never TF32. The adapter's x @ A accumulates in the
// same loop from the staged x tile (bf16: mma too). After the loop xa is
// rounded to T into shared memory, B's [r, 128] tile is staged, xab = xa @ B
// runs as a second short product, and the epilogue applies the roundings
// above. Ragged M and N are masked in the kernel, never padded in memory.
// K must be a multiple of 32; the rank is padded to 32 or 64 with zeros.
//
// What bounds it. At decode (M = 64) the weight's bytes: an int4 w_gate
// [3584, 18944] moves 33.9 MB of payload and 4.2 MB of scales, 0.0114 ms at
// 3.35 TB/s. At the learner's M = 12,400 its flops: 2 M K N = 1.68e12 for
// w_gate, 1.7 ms at 989 TFLOP/s. This version reaches neither: the N = 512
// and N = 3584 launches at M = 64 fill few of the 132 SMs, mma.sync without
// TMA or wgmma tops out well below the tensor cores' peak, and the
// dequantization runs on the CUDA cores per block; wgmma, TMA and split-K
// are later work.

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
  int m, k, n, group, bits, rank, lora_bf16;
  float lora_scale;  // already rounded to T
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

// shared-memory geometry: rows padded by 16 bytes, so ldmatrix's eight
// 16-byte rows fall in distinct banks and every row stays 16-byte aligned
template <typename T, int BM, int R>
struct Geo {
  static constexpr int kPad = 16 / (int)sizeof(T);
  static constexpr int kXs = kBK + kPad;  // x tile [BM][kXs]
  static constexpr int kWs = kBN + kPad;  // w tile [kBK][kWs]; B tile [R][kWs]
  static constexpr int kAs = R + kPad;    // A tile [kBK][kAs]; xa [BM][kAs]
  static constexpr int kXElems = BM * kXs;
  static constexpr int kWElems = kBK * kWs;
  static constexpr int kAElems = R ? kBK * kAs : 0;
  static constexpr int kStage = kXElems + kWElems + kAElems;
  static constexpr int kLoopBytes = 2 * kStage * (int)sizeof(T);
  static constexpr int kEpiBytes = R ? (BM * kAs + R * kWs) * (int)sizeof(T) : 0;
  static constexpr int kBytes = kLoopBytes > kEpiBytes ? kLoopBytes : kEpiBytes;
  static constexpr int kEpc = 16 / (int)sizeof(T);            // x values per 16 bytes
  static constexpr int kXChunks = BM * kBK / kEpc / kThreads;  // per thread
  static constexpr int kAVals = R * kBK / kThreads;            // per thread
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
template <typename T, int BM, int R>
struct Raw {
  uint4 x[Geo<T, BM, R>::kXChunks];
  uint32_t q[4];
  float s[16];
  float a[Geo<T, BM, R>::kAVals > 0 ? Geo<T, BM, R>::kAVals : 1];
};

template <typename T, int BM, int R>
__device__ __forceinline__ void load_raw(Raw<T, BM, R>& raw, const Args& p, int k0, int m0,
                                         int n0) {
  using G = Geo<T, BM, R>;
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
  if constexpr (R > 0) {
#pragma unroll
    for (int i = 0; i < G::kAVals; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / R, j = e % R;
      raw.a[i] = j < p.rank ? lora_at(p.a, (size_t)(k0 + r) * p.rank + j, p.lora_bf16) : 0.f;
    }
  }
}

template <typename T, int BM, int R>
__device__ __forceinline__ void store_raw(const Raw<T, BM, R>& raw, const Args& p, T* xs,
                                          T* ws, T* as) {
  using G = Geo<T, BM, R>;
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
  if constexpr (R > 0) {
#pragma unroll
    for (int i = 0; i < G::kAVals; ++i) {
      const int e = tid + i * kThreads;
      as[(e / R) * G::kAs + e % R] = from_f32<T>(raw.a[i]);
    }
  }
}

// The K loop: two shared-memory stages, one barrier per step; `compute(xs,
// ws, as)` consumes a staged step. Ends with a barrier, so the caller may
// reuse the shared memory.
template <typename T, int BM, int R, typename Compute>
__device__ __forceinline__ void main_loop(const Args& p, T* smem, int m0, int n0,
                                          Compute&& compute) {
  using G = Geo<T, BM, R>;
  Raw<T, BM, R> raw;
  const int steps = p.k / kBK;
  load_raw<T, BM, R>(raw, p, 0, m0, n0);
  for (int kt = 0; kt < steps; ++kt) {
    T* xs = smem + (kt & 1) * G::kStage;
    T* ws = xs + G::kXElems;
    T* as = ws + G::kWElems;
    // the stage written here was last read two steps ago, before the
    // barrier of the previous step
    store_raw<T, BM, R>(raw, p, xs, ws, as);
    __syncthreads();
    if (kt + 1 < steps) load_raw<T, BM, R>(raw, p, (kt + 1) * kBK, m0, n0);
    compute(xs, ws, as);
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

// two neighbouring columns of one row of the output
template <typename T, int R>
__device__ __forceinline__ void write_pair(const Args& p, int row, int gcol, float a0, float a1,
                                           float d0, float d1) {
  if (row >= p.m || gcol >= p.n) return;
  T* out = static_cast<T*>(p.out) + (size_t)row * p.n + gcol;
  const float y0 = finish<T, R>(p, a0, gcol, d0);
  if (gcol + 1 < p.n) {
    const float y1 = finish<T, R>(p, a1, gcol + 1, d1);
    if (p.n % 2 == 0) {
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint32_t*>(out) = pack_bf16x2(y0, y1);
      } else {
        *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
      }
      return;
    }
    out[1] = from_f32<T>(y1);
  }
  out[0] = from_f32<T>(y0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// ldmatrix addresses for lane `lane`: the A fragment of the 16 x 16 tile at
// (row0, k0) of a row-major [*, ld] matrix, and the B fragments of two
// neighbouring n8 tiles at (k0, n0) of a [k][n] matrix (transposed load)
template <typename T>
__device__ __forceinline__ const T* a_frag_ptr(const T* base, int ld, int row0, int k0, int lane) {
  return base + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
template <typename T>
__device__ __forceinline__ const T* b_frag_ptr(const T* base, int ld, int k0, int n0, int lane) {
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// bf16: tensor-core products (mma.sync m16n8k16)
template <int BM, int R>
__device__ void run_mma(const Args& p, __nv_bfloat16* smem) {
  using T = __nv_bfloat16;
  using G = Geo<T, BM, R>;
  constexpr int kWarpsM = BM / 32, kWarpsN = 8 / kWarpsM;
  constexpr int kNt = kBN / kWarpsN / 8;  // n8 tiles per warp: 4 or 8
  constexpr int kMtl = BM / 16;           // the adapter's m16 tiles
  constexpr int kPer = R > 0 ? (R / 8) / (8 / kMtl) : 2;  // its n8 tiles per warp
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / kWarpsN) * 32, wn0 = (warp % kWarpsN) * (kNt * 8);
  const int lm = warp % kMtl, ln0 = (warp / kMtl) * kPer;

  float acc[2][kNt][4] = {};
  float xacc[kPer][4] = {};
  main_loop<T, BM, R>(p, smem, m0, n0, [&](const T* xs, const T* ws, const T* as) {
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], a_frag_ptr(xs, G::kXs, wm0 + mi * 16, ks, lane));
#pragma unroll
      for (int nj = 0; nj < kNt; nj += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, b_frag_ptr(ws, G::kWs, ks, wn0 + nj * 8, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][nj], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][nj + 1], af[mi], bf[2], bf[3]);
        }
      }
      if constexpr (R > 0) {
        uint32_t la[4];
        ldsm_x4(la, a_frag_ptr(xs, G::kXs, lm * 16, ks, lane));
#pragma unroll
        for (int j = 0; j < kPer; j += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, b_frag_ptr(as, G::kAs, ks, (ln0 + j) * 8, lane));
          mma_bf16(xacc[j], la, bf[0], bf[1]);
          mma_bf16(xacc[j + 1], la, bf[2], bf[3]);
        }
      }
    }
  });

  const int g = lane >> 2, c = lane & 3;
  T* xa = smem;                 // [BM][kAs]
  T* bs = smem + BM * G::kAs;   // [R][kWs]
  if constexpr (R > 0) {
    // xa rounded to T, and B's tile cast to T (rows past the rank and
    // columns past N are 0)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T* dst = xa + (lm * 16 + g + h * 8) * G::kAs + (ln0 + j) * 8 + 2 * c;
        dst[0] = from_f32<T>(xacc[j][2 * h]);
        dst[1] = from_f32<T>(xacc[j][2 * h + 1]);
      }
    for (int e = threadIdx.x; e < R * kBN; e += kThreads) {
      const int r = e / kBN, cc = e % kBN;
      const float v = r < p.rank && n0 + cc < p.n
          ? lora_at(p.b, (size_t)r * p.n + n0 + cc, p.lora_bf16) : 0.f;
      bs[r * G::kWs + cc] = from_f32<T>(v);
    }
    __syncthreads();
  }
#pragma unroll
  for (int nj = 0; nj < kNt; nj += 2) {
    float d[2][2][4] = {};
    if constexpr (R > 0) {
#pragma unroll
      for (int ks = 0; ks < R; ks += 16) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, b_frag_ptr(bs, G::kWs, ks, wn0 + nj * 8, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t af[4];
          ldsm_x4(af, a_frag_ptr(xa, G::kAs, wm0 + mi * 16, ks, lane));
          mma_bf16(d[mi][0], af, bf[0], bf[1]);
          mma_bf16(d[mi][1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float* a4 = acc[mi][nj + t];
        const int row = m0 + wm0 + mi * 16 + g;
        const int gcol = n0 + wn0 + (nj + t) * 8 + 2 * c;
        write_pair<T, R>(p, row, gcol, a4[0], a4[1], d[mi][t][0], d[mi][t][1]);
        write_pair<T, R>(p, row + 8, gcol, a4[2], a4[3], d[mi][t][2], d[mi][t][3]);
      }
  }
}

// f32: FMA on the CUDA cores. Thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 i and columns tx + 16 j of the block.
template <int BM, int R>
__device__ void run_fma(const Args& p, float* smem) {
  using T = float;
  using G = Geo<T, BM, R>;
  constexpr int kRows = BM / 16, kCols = kBN / 16, kLc = R > 0 ? R / 16 : 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float acc[kRows][kCols] = {};
  float xacc[kRows][kLc] = {};
  main_loop<T, BM, R>(p, smem, m0, n0, [&](const T* xs, const T* ws, const T* as) {
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
      if constexpr (R > 0) {
#pragma unroll
        for (int j = 0; j < kLc; ++j) {
          const float bv = as[kk * G::kAs + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) xacc[i][j] = fmaf(av[i], bv, xacc[i][j]);
        }
      }
    }
  });

  float* xa = smem;
  float* bs = smem + BM * G::kAs;
  if constexpr (R > 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kLc; ++j) xa[(ty + 16 * i) * G::kAs + tx + 16 * j] = xacc[i][j];
    for (int e = threadIdx.x; e < R * kBN; e += kThreads) {
      const int r = e / kBN, cc = e % kBN;
      bs[r * G::kWs + cc] = r < p.rank && n0 + cc < p.n
          ? lora_at(p.b, (size_t)r * p.n + n0 + cc, p.lora_bf16) : 0.f;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      float d = 0.f;
      if constexpr (R > 0) {
        for (int r = 0; r < R; ++r)
          d = fmaf(xa[(ty + 16 * i) * G::kAs + r], bs[r * G::kWs + col], d);
      }
      if (row < p.m && n0 + col < p.n)
        static_cast<float*>(p.out)[(size_t)row * p.n + n0 + col] =
            finish<float, R>(p, acc[i][j], n0 + col, d);
    }
  }
}

template <typename T, int BM, int R>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  if constexpr (sizeof(T) == 2) {
    run_mma<BM, R>(p, smem);
  } else {
    run_fma<BM, R>(p, smem);
  }
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
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + BM - 1) / BM);
  quant_matmul_kernel<T, BM, R><<<grid, kThreads, kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int BM>
int launch_rank(const Args& p, cudaStream_t stream) {
  if (p.rank == 0) return launch<T, BM, 0>(p, stream);
  if (p.rank <= 32) return launch<T, BM, 32>(p, stream);
  return launch<T, BM, 64>(p, stream);
}

}  // namespace

extern "C" {

// x: [m, k] in `dtype` (0 = f32, 1 = bf16); q: int8 [k, n] (bits 8) or the
// int4 nibble form [k / 2, n] (bits 4), `group` rows of k per scale row;
// scale: f32 [k / group, n]; bias: `dtype` [n] or null; lora_a [k, rank] and
// lora_b [rank, n] in `lora_dtype` (0 = f32, 1 = bf16), or null with rank 0;
// lora_scale already rounded to `dtype`; out: [m, n] in `dtype`. All
// contiguous; x, q and scale 16-byte aligned. Runs on `stream` of `device`;
// returns the first CUDA error (0 = ok). The caller checks: k % 32 == 0,
// group divides k (even for bits 4), rank <= 64, `block_m` 64 (or 128, bf16
// only).
int quant_matmul_launch(const void* x, const void* q, const void* scale, const void* bias,
                        const void* lora_a, const void* lora_b, void* out, int m, int k, int n,
                        int group, int bits, int rank, float lora_scale, int dtype,
                        int lora_dtype, int block_m, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  Args p{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale), bias, lora_a,
         lora_b, out, m, k, n, group, bits, rank, lora_dtype, lora_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    return block_m == 128 ? launch_rank<__nv_bfloat16, 128>(p, s)
                          : launch_rank<__nv_bfloat16, 64>(p, s);
  }
  return launch_rank<float, 64>(p, s);
}

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
