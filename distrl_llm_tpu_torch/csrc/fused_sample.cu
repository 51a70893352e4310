// Fused token sampler for Hopper (sm_90a): temperature, bisect top-p,
// Gumbel-max draw and the chosen token's raw-basis logprob, one thread-block
// cluster per row.
//
// Replaces the TPU kernel distrl_llm_tpu/ops/sampling.py::_fused_sample_kernel
// (launched by fused_sample). Same function, column for column:
//   scaled = raw / max(t, 1e-6)            (a division, as on the TPU)
//   probs  = exp(scaled - m_s) / z, m_s = max(scaled), z = sum exp(scaled - m_s)
//   lo     = 16 bisection steps on a probability threshold from lo = 0,
//            hi = max(probs), mid = 0.5f * (lo + hi), keeping lo = mid where
//            the kept mass sum p·[p >= mid] is >= top_p
//   token  = argmax(where(probs >= lo, scaled, -1e30) + gumbel(seed, col))
//            or argmax(raw) when t == 0; ties go to the LOWEST index and NaN
//            counts as the largest value (jnp.argmax semantics)
//   logp   = raw[token] - (log sum exp(raw - m) + m)
// The Gumbel uniforms hash (seed, column) with murmur3's fmix32 in uint32
// wrap-around arithmetic: h = col * 0x9E3779B9 + seed, fmix32(h),
// u = (h >> 9) * 2^-23 + 2^-24, g = -log(-log(u)). Columns are the logits'
// own indices, so the TPU kernel's 128-padding changes nothing. Every
// per-element value rounds as the plain version's does (expf, logf and true
// divisions, no fast-math intrinsics); only the order of the sums differs.
//
// What bounds it: one read of the [B, V] f32 logits (39 MB at B = 64,
// V = 152,064: 11.6 us at 3.35 TB/s). The arithmetic is a few dozen
// instructions per element, most of them in the accurate expf, logf and
// divisions; at 64 x 152,064 that is tens of microseconds of the card's
// instruction throughput, more than the bytes, so the design cuts passes
// and barriers.
//
// Design. A cluster of C blocks takes one row (ops/sampling.py::
// plan_sample_cluster: C = 1 for small vocabularies, 8 blocks of 480
// threads, two to an SM, at V = 152,064 and 64 rows); each block copies its
// slice of `cols` columns into shared memory once (cp.async, 16 bytes a
// thread where the row is aligned) and every later pass reads it there.
// Thread t owns quads t, t + T, ... (at most 10, a bit each in 64-bit masks)
// in every pass, so the passes need no block barrier of their own. The
// blocks combine through distributed shared memory: a block's sums in warp
// order, then, after one cluster barrier, every block reads all C block sums
// and adds them in the same order, so every block holds the same bits and
// takes the same decisions. The passes:
//   1. max/argmax of raw; a cluster round;
//   2. sum exp(raw - m) and sum exp(scaled - m_s); a round;
//   3. the bands: p = exp(scaled - m_s) / z again (storing e would take 8
//      bytes a column and twice the waves), each column's band b(p), the
//      least b <= 16 with p >= hi0 * 2^-b (hi0 = max p = 1 / z), kept as a
//      byte in registers, and each band's mass; a round. While lo is 0 the
//      bisection's mids are exactly hi0 * 2^-(s+1), so step s keeps the
//      bands <= s + 1: the first step whose mass reaches top_p, found by a
//      ballot, sets lo, and from then on only the columns of the band below
//      it (in play) can change sides;
//   4. the remaining steps, K = kLookahead a round: the 2^K - 1 candidate
//      mids of the next K steps, each by the recurrence 0.5f * (lo + hi)
//      along its path, summed over the columns in play in the same order
//      for each, so lo does not depend on K;
//   5. the draw: the hash and the two logs only on the kept columns (the
//      bands above the one in play, and its columns with p >= lo), the
//      lanes of a warp each taking their next kept column. Every other
//      column scores -1e30 + g == -1e30 exactly (|g| < 17), so the lowest
//      of them enters the argmax as (-1e30, its index), and a row where
//      nothing is kept (a NaN row) gives the full scan's token; a round.
// The block that holds the token writes it and its logprob from shared
// memory, and a last cluster barrier keeps every block's shared memory alive
// until the others have read it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxQuads = 10;  // 4-column quads a thread holds: 40 columns
constexpr int kBands = 17;  // bisection bands 0 .. 16 (band_of)
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int kMaxDevices = 64;

// Bisection steps decided per cluster round once lo > 0. 2 was the fastest
// of 1, 2 and 4 at [64, 152064] (distrl_llm_tpu_torch/tools/k1_sweep.py
// builds the others with -DFUSED_SAMPLE_LOOKAHEAD=k and holds them to this
// one bit for bit).
#ifndef FUSED_SAMPLE_LOOKAHEAD
#define FUSED_SAMPLE_LOOKAHEAD 2
#endif
constexpr int kLookahead = FUSED_SAMPLE_LOOKAHEAD;
static_assert(kLookahead == 1 || kLookahead == 2 || kLookahead == 4, "lookahead: 1, 2 or 4");

// The reduction area at the start of dynamic shared memory; raw[cols] and
// the threads' band sums [kBands][threads] follow it. blk_* are what the
// other blocks of the cluster read, double-buffered by round.
struct Reduction {
  float warp_val[kBands][kMaxWarps];
  int warp_idx[kMaxWarps];
  float blk_val[2][32];
  int blk_idx[2];
};
// ops/sampling.py's SAMPLE_RED_BYTES
constexpr int kRedBytes = 2688;
static_assert(sizeof(Reduction) <= kRedBytes, "reduction area");

// (v, i) beats (bv, bi) under jnp.argmax: NaN is the largest value, ties go
// to the lowest index. A total order, so any merge order gives one winner.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

// xor butterflies: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Cluster-wide sums of NV values whose block sums are in red.blk_val[buf]:
// after one cluster barrier, lane l reads value l / C + m * (32 / C) of rank
// l % C (all loads in flight together) and each run of C lanes sums its
// values by an xor butterfly. Every block runs the same code on the same
// layout, so every thread of the cluster ends with the same bits; total(j)
// reads value j's sum, lane_total() value `lane`'s.
template <int NV>
struct ClusterSums {
  static constexpr int kSlots = (NV + 1) / 2;  // C <= 16: at least 2 runs a warp
  float v[kSlots];
  int runs, width;

  __device__ float total(int j) const {
    float x = 0.0f;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) if (m == j / runs) x = v[m];
    return __shfl_sync(kFull, x, (j % runs) * width);
  }

  __device__ float lane_total() const {
    const int j = threadIdx.x & 31;
    float x = 0.0f;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const float y = __shfl_sync(kFull, v[m], (j % runs) * width);
      if (m == j / runs) x = y;
    }
    return j < NV ? x : 0.0f;
  }
};

template <int NV>
__device__ ClusterSums<NV> cluster_gather(cg::cluster_group& cluster, Reduction& red, int buf) {
  cluster.sync();
  const int lane = threadIdx.x & 31;
  ClusterSums<NV> out;
  out.width = (int)cluster.num_blocks();
  out.runs = 32 / out.width;
  const float* remote = cluster.map_shared_rank(&red.blk_val[buf][0], lane % out.width);
  const int first = lane / out.width;
#pragma unroll
  for (int m = 0; m < ClusterSums<NV>::kSlots; ++m) {
    const int j = first + m * out.runs;
    out.v[m] = j < NV ? remote[j] : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < ClusterSums<NV>::kSlots; ++m) {
    for (int o = out.width >> 1; o > 0; o >>= 1) out.v[m] += __shfl_xor_sync(kFull, out.v[m], o);
  }
  return out;
}

// Cluster-wide sums of NV values a thread holds in acc[]: the block's warps
// in warp order, then the blocks (cluster_gather).
template <int NV>
__device__ ClusterSums<NV> cluster_sum(cg::cluster_group& cluster, Reduction& red, int buf,
                                       const float (&acc)[NV]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) red.warp_val[j][warp] = s;
  }
  __syncthreads();
  for (int j = warp; j < NV; j += nwarps) {
    const float s = warp_sum(lane < nwarps ? red.warp_val[j][lane] : 0.0f);
    if (lane == 0) red.blk_val[buf][j] = s;
  }
  return cluster_gather<NV>(cluster, red, buf);
}

// Cluster-wide argmax under `beats`; every thread gets the winner.
__device__ void cluster_argmax(cg::cluster_group& cluster, Reduction& red, int buf,
                               float& v, int& i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) { red.warp_val[0][warp] = v; red.warp_idx[warp] = i; }
  __syncthreads();
  v = lane < nwarps ? red.warp_val[0][lane] : -INFINITY;
  i = lane < nwarps ? red.warp_idx[lane] : INT_MAX;
  warp_argmax(v, i);
  if (threadIdx.x == 0) { red.blk_val[buf][0] = v; red.blk_idx[buf] = i; }
  cluster.sync();
  const int blocks = (int)cluster.num_blocks();
  v = -INFINITY;
  i = INT_MAX;
  if (lane < blocks) {
    v = *cluster.map_shared_rank(&red.blk_val[buf][0], lane);
    i = *cluster.map_shared_rank(&red.blk_idx[buf], lane);
  }
  warp_argmax(v, i);
}

__device__ __forceinline__ float gumbel(uint32_t seed, uint32_t col) {
  uint32_t h = col * 0x9E3779B9u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  // 23 high bits → u in [2^-24, 1 - 2^-24], both ends exact in f32 (u never
  // rounds to 1, where -log(-log(u)) would be +inf)
  const float u = (float)(h >> 9) * 0x1p-23f + 0x1p-24f;
  return -logf(-logf(u));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// p = exp(raw / t - m_s) / z, rounded as the plain version rounds it
__device__ __forceinline__ float prob(float x, float t, float m_s, float z) {
  return expf(x / t - m_s) / z;
}

// The band of probability p below hi0 = max(probs): the least b in [0, 16]
// with p >= hi0 * 2^-b, else kBands (p below hi0 * 2^-16, or NaN). While
// the bisection's lo is 0 its mids are exactly hi0 * 2^-(s+1), so step s
// keeps the bands <= s + 1. Non-negative floats order as their bits, and
// hi0 * 2^-b has hi0's bits less b << 23 (hi0 >= 1 / vocab: no underflow).
__device__ __forceinline__ int band_of(float p, uint32_t hi0_bits) {
  if (!(p >= 0.0f)) return kBands;
  const int d = (int)hi0_bits - (int)__float_as_uint(p);
  if (d <= 0) return 0;
  const int b = (d + (1 << 23) - 1) >> 23;
  return b < kBands ? b : kBands;
}

__global__ void __launch_bounds__(kMaxThreads)
fused_sample_kernel(const float* __restrict__ logits, float t0, float top_p,
                    const int32_t* __restrict__ seeds, int32_t* __restrict__ tok_out,
                    float* __restrict__ logp_out, int vocab, int cols, int iters, int vec) {
  constexpr int NC = (1 << kLookahead) - 1;  // candidate mids a round
  extern __shared__ __align__(16) unsigned char smem[];
  Reduction& red = *reinterpret_cast<Reduction*>(smem);
  float* raw_s = reinterpret_cast<float*>(smem + kRedBytes);
  float* band_s = raw_s + cols;  // [kBands][threads]: each thread's band sums
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row = blockIdx.y;
  const int c0 = (int)cluster.block_rank() * cols;
  const int n = max(0, min(cols, vocab - c0));
  const int quads = (n + 3) >> 2;
  const float* src = logits + (size_t)row * vocab + c0;
  // element e = 4i + k of a thread is column 4 (tid + i T) + k of the slice
  auto col_of = [&](int e) { return 4 * (tid + (e >> 2) * nt) + (e & 3); };
  int round = 0;

  // the one read of the slice: thread t owns quads t, t + T, ... in every pass
  for (int q = tid; q < quads; q += nt) {
    const int c = q * 4;
    if (vec) {
      cp_async16(raw_s + c, src + c);
    } else {
      for (int k = 0; k < 4 && c + k < n; ++k) cp_async4(raw_s + c + k, src + c + k);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // max and argmax of the raw row (the max is the argmax's value). A
  // thread's columns rise, so a later one beats the best so far only by a
  // larger value or as the first NaN: `beats` without its index test.
  float m_raw = -INFINITY;
  int greedy = INT_MAX;
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = tid + i * nt;
    if (q < quads) {
      const float4 x = *reinterpret_cast<const float4*>(raw_s + 4 * q);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * q + k;
        if (c < n && (xs[k] > m_raw || greedy == INT_MAX || (isnan(xs[k]) && !isnan(m_raw)))) {
          m_raw = xs[k];
          greedy = c0 + c;
        }
      }
    }
  }
  cluster_argmax(cluster, red, round++ & 1, m_raw, greedy);

  // sum exp(raw - m) for the logprob and, when sampling, sum exp(scaled - m_s)
  // for the tempered softmax. Division by t > 0 is monotone, so
  // max(raw / t) == max(raw) / t exactly.
  const bool sampling = !(t0 == 0.0f);
  const float t = fmaxf(t0, 1e-6f);
  const float m_s = m_raw / t;
  float z2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = tid + i * nt;
    if (q < quads) {
      const float4 x = *reinterpret_cast<const float4*>(raw_s + 4 * q);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * q + k < n) {
          z2[0] += expf(xs[k] - m_raw);
          if (sampling) z2[1] += expf(xs[k] / t - m_s);
        }
      }
    }
  }
  const ClusterSums<2> zs = cluster_sum<2>(cluster, red, round++ & 1, z2);
  const float logz = logf(zs.total(0)) + m_raw;

  int token = greedy;
  if (sampling) {
    const float z = zs.total(1);
    const float hi0 = 1.0f / z;  // max(probs): exp(0) / z
    // the band pass: each column's band (a byte of bands[]) and each
    // thread's sum of probs per band, in its column order
    for (int b = 0; b < kBands; ++b) band_s[b * nt + tid] = 0.0f;
    uint32_t bands[kMaxQuads];
    uint64_t valid = 0;
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
      bands[i] = 0xffffffffu;
      const int q = tid + i * nt;
      if (q < quads) {
        const float4 x = *reinterpret_cast<const float4*>(raw_s + 4 * q);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * q + k < n) {
            const float p = prob(xs[k], t, m_s, z);
            const int b = band_of(p, __float_as_uint(hi0));
            if (b < kBands) band_s[b * nt + tid] += p;
            bands[i] = (bands[i] & ~(0xffu << (8 * k))) | ((uint32_t)b << (8 * k));
            valid |= 1ull << (4 * i + k);
          }
        }
      }
    }
    // the band round: each band's block sum over the threads in thread
    // order, then over the cluster
    __syncthreads();
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int b = warp; b < kBands; b += nt >> 5) {
        float acc = 0.0f;
        for (int i = lane; i < nt; i += 32) acc += band_s[b * nt + i];
        acc = warp_sum(acc);
        if (lane == 0) red.blk_val[round & 1][b] = acc;
      }
    }
    const ClusterSums<kBands> bsum = cluster_gather<kBands>(cluster, red, round++ & 1);

    // bisection on the keep threshold from lo = 0, hi = max(probs). While lo
    // is 0, step s's mid is hi0 * 2^-(s + 1) and its mass the sum of bands
    // 0 .. s + 1 (cum[s + 1], a scan over lanes): the first step whose mass
    // reaches top_p sets lo, and the band below it stays in play.
    float cum = bsum.lane_total();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, cum, o);
      if ((tid & 31) >= o) cum += y;
    }
    const int banded = min(iters, kBands - 1);
    const uint32_t pass = __ballot_sync(kFull, cum >= top_p) & ((2u << banded) - 2u);
    const int first = pass ? __ffs(pass) - 1 : banded + 1;  // cum index of the first pass
    float lo = 0.0f, hi = hi0;
    for (int s = 1; s < first; ++s) hi = 0.5f * (lo + hi);  // the steps that kept lo = 0
    int step = first - 1;
    int play = kBands;  // the one band whose columns may still change sides
    if (pass) {
      lo = 0.5f * (lo + hi);
      play = first;
      step = first;
    }
    const float above = __shfl_sync(kFull, cum, first - 1);  // mass of the columns >= hi
    // the rest of the steps move lo and hi inside the band in play: only its
    // columns can change sides; kLookahead steps a cluster round
    uint64_t in_play = 0;
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((int)((bands[i] >> (8 * k)) & 0xffu) == play) in_play |= 1ull << (4 * i + k);
      }
    }
    for (; step < iters; step += kLookahead) {
      const int depth = min(kLookahead, iters - step);
      // the candidate tree in breadth-first order: node j's children are
      // 2j + 1 (mass < top_p: hi = mid) and 2j + 2 (lo = mid)
      float mid[NC], nlo[NC], nhi[NC];
      nlo[0] = lo;
      nhi[0] = hi;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        mid[j] = 0.5f * (nlo[j] + nhi[j]);
        if (2 * j + 2 < NC) {
          nlo[2 * j + 1] = nlo[j];
          nhi[2 * j + 1] = mid[j];
          nlo[2 * j + 2] = mid[j];
          nhi[2 * j + 2] = nhi[j];
        }
      }
      float acc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = 0.0f;
      for (uint64_t m = in_play; m; m &= m - 1) {
        const float p = prob(raw_s[col_of(__ffsll((long long)m) - 1)], t, m_s, z);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] += p >= mid[j] ? p : 0.0f;
      }
      const ClusterSums<NC> sums = cluster_sum<NC>(cluster, red, round++ & 1, acc);
      int node = 0;  // walk the decisions; uniform across the cluster
      for (int s = 0; s < depth; ++s) {
        float mnode = 0.0f;
#pragma unroll
        for (int j = 0; j < NC; ++j) if (j == node) mnode = mid[j];
        if (above + sums.total(node) >= top_p) { lo = mnode; node = 2 * node + 2; }
        else { hi = mnode; node = 2 * node + 1; }
      }
    }

    // kept: the bands above the one in play, and its columns with p >= lo
    uint64_t kept = 0;
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((int)((bands[i] >> (8 * k)) & 0xffu) < play) kept |= 1ull << (4 * i + k);
      }
    }
    for (uint64_t m = in_play; m; m &= m - 1) {
      const int e = __ffsll((long long)m) - 1;
      if (prob(raw_s[col_of(e)], t, m_s, z) >= lo) kept |= 1ull << e;
    }
    // the draw: Gumbel-max over the kept columns, the lanes of a warp each
    // taking their next kept column, plus the thread's lowest unkept one
    const uint32_t seed = (uint32_t)seeds[row];
    float best = -INFINITY;
    int arg = INT_MAX;
    uint64_t m = kept;
    while (__any_sync(kFull, m != 0)) {
      if (m) {
        const int c = col_of(__ffsll((long long)m) - 1);
        m &= m - 1;
        const float score = raw_s[c] / t + gumbel(seed, (uint32_t)(c0 + c));
        if (beats(score, c0 + c, best, arg)) { best = score; arg = c0 + c; }
      }
    }
    const uint64_t cut = valid & ~kept;
    if (cut) {
      const int c = c0 + col_of(__ffsll((long long)cut) - 1);
      if (beats(kNegInf, c, best, arg)) { best = kNegInf; arg = c; }
    }
    cluster_argmax(cluster, red, round++ & 1, best, arg);
    token = arg;
  }
  if (tid == 0 && token >= c0 && token < c0 + n) {
    tok_out[row] = token;
    logp_out[row] = raw_s[token - c0] - logz;
  }
  cluster.sync();  // no block leaves while another may still read its partials
}

// The kernel's attributes, set once per device: dynamic shared memory up to
// a block's 227 KB (a launch takes only its own) and clusters of 16.
cudaError_t prepare(int device) {
  static std::atomic<int> ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  const void* fn = (const void*)fused_sample_kernel;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready[device].store(1, std::memory_order_release);
  return e;
}

// The launch configuration of one cluster of `cluster` blocks per row.
cudaLaunchConfig_t make_config(int rows, int cluster, int threads, int cols,
                               cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)rows, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)kRedBytes + 4 * (size_t)cols + 4 * (size_t)kBands * threads;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_shape(int cluster, int threads, int cols) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16) &&
         threads >= 64 && threads <= kMaxThreads && threads % 32 == 0 && cols >= 4 &&
         cols % 4 == 0 && cols / 4 <= kMaxQuads * threads &&
         kRedBytes + 4 * cols + 4 * kBands * threads <= kSmemLimit;
}

}  // namespace

extern "C" {

// Launch one cluster of `cluster` blocks of `threads` threads per row on
// `stream` of `device`, each block holding `cols` columns (a multiple of 4;
// cluster * cols >= vocab); returns the first CUDA error (0 = ok). logits:
// f32 [rows, vocab] contiguous; seeds: int32 [rows]; tok: int32 [rows];
// logp: f32 [rows]. vocab >= 1; cols / 4 <= 10 * threads. rows == 0
// launches nothing. Dynamic shared memory is 2688 + 4 * cols + 68 * threads
// bytes a block, at most 232448 (ops/sampling.py::plan_sample_cluster).
int fused_sample_launch(const void* logits, float temperature, float top_p,
                        const void* seeds, void* tok, void* logp, int rows, int vocab,
                        int iters, int cluster, int threads, int cols, int device,
                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (!valid_shape(cluster, threads, cols) || vocab < 1 || iters < 0 || rows < 0 ||
      rows > 65535 || (long long)cluster * cols < vocab) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  const cudaError_t ready = prepare(device);
  if (ready != cudaSuccess) return (int)ready;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = make_config(rows, cluster, threads, cols, &attr,
                                             (cudaStream_t)stream);
  const int vec = vocab % 4 == 0 && ((uintptr_t)logits & 15) == 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fused_sample_kernel, (const float*)logits, temperature, top_p,
      (const int32_t*)seeds, (int32_t*)tok, (float*)logp, vocab, cols, iters, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out; returns the CUDA error.
int fused_sample_max_active_clusters(int cluster, int threads, int cols, int device,
                                     void* out) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (!valid_shape(cluster, threads, cols)) return (int)cudaErrorInvalidValue;
  const cudaError_t ready = prepare(device);
  if (ready != cudaSuccess) return (int)ready;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = make_config(1, cluster, threads, cols, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters((int*)out, (const void*)fused_sample_kernel, &cfg);
}

const char* fused_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
