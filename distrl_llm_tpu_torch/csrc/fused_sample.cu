// Fused token sampler for Hopper (sm_90a): temperature, bisect top-p,
// Gumbel-max draw and the chosen token's raw-basis logprob, one block per row.
//
// Replaces the TPU kernel distrl_llm_tpu/ops/sampling.py::_fused_sample_kernel
// (launched by fused_sample). Same function, column for column:
//   scaled = raw / max(t, 1e-6)            (a division, as on the TPU)
//   probs  = softmax(scaled)
//   lo     = 16 bisection steps on a probability threshold, keeping the
//            interval's LOW end, so the kept mass Σ p·[p >= lo] is >= top_p
//   token  = argmax(where(probs >= lo, scaled, -1e30) + gumbel(seed, col))
//            or argmax(raw) when t == 0; ties go to the LOWEST index and NaN
//            counts as the largest value (jnp.argmax semantics)
//   logp   = raw[token] - (log Σ exp(raw - m) + m)
// The Gumbel uniforms hash (seed, column) with murmur3's fmix32 in uint32
// wrap-around arithmetic: h = col * 0x9E3779B9 + seed, fmix32(h),
// u = (h >> 9) * 2^-23 + 2^-24, g = -log(-log(u)). Columns are the logits'
// own indices, so the TPU kernel's 128-padding changes nothing.
//
// What bounds it: one read of the [B, V] f32 logits (39 MB at B = 64,
// V = 152,064: about 12 us at 3.35 TB/s); the arithmetic is a few dozen
// operations per element. A row (594 KB at that V) does not fit the 227 KB
// of shared memory, so this simple design streams it from global memory once
// per pass: max/argmax, the two exp sums, the normalized probabilities
// (written once to a caller-allocated f32 scratch row), 16 bisection mass
// sums over that scratch, and the draw. Keeping the probabilities in scratch
// makes each bisection step a load-compare-add instead of a division, an
// exp and a second division per element, which would make the loop
// compute-bound on the row's one SM. After the first pass the rows of a
// 64-row batch are mostly served from the 50 MB L2 cache, which keeps the
// re-reads affordable. Greedy rows (t == 0) stop after the first two passes.
// A later PR can cut the passes (a threshold histogram; a cluster of blocks
// per row holding the row in distributed shared memory).

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// (v, i) beats (bv, bi) under jnp.argmax: NaN is the largest value, ties go
// to the lowest index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

// Block-wide sum; every thread gets the total.
__device__ float block_sum(float v, float* s_val) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction's readers are done with s_val
  if (lane == 0) s_val[warp] = v;
  __syncthreads();
  v = s_val[lane];  // kWarps == 32: every warp reduces all partials
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide argmax under `beats`; every thread gets the winner.
__device__ void block_argmax(float& v, int& i, float* s_val, int* s_idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { s_val[warp] = v; s_idx[warp] = i; }
  __syncthreads();
  v = s_val[lane];
  i = s_idx[lane];
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
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

__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const float* __restrict__ logits, float t0, float top_p,
                    const int32_t* __restrict__ seeds,
                    int32_t* __restrict__ tok_out, float* __restrict__ logp_out,
                    float* __restrict__ probs_scratch, int vocab, int iters) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  const float* raw = logits + (size_t)blockIdx.x * vocab;
  float* probs = probs_scratch + (size_t)blockIdx.x * vocab;

  // pass 1: max and argmax of the raw row (the max is the argmax's value)
  float m_raw = -INFINITY;
  int greedy = INT_MAX;
  for (int c = threadIdx.x; c < vocab; c += kThreads) {
    const float x = raw[c];
    if (beats(x, c, m_raw, greedy)) { m_raw = x; greedy = c; }
  }
  block_argmax(m_raw, greedy, s_val, s_idx);

  // pass 2: Σ exp(raw - m) for the logprob and, when sampling,
  // Σ exp(scaled - m_s) for the tempered softmax. Division by t > 0 is
  // monotone, so max(raw / t) == max(raw) / t exactly.
  const bool sampling = !(t0 == 0.0f);
  const float t = fmaxf(t0, 1e-6f);
  const float m_s = m_raw / t;
  float z_raw = 0.0f, z = 0.0f;
  for (int c = threadIdx.x; c < vocab; c += kThreads) {
    const float x = raw[c];
    z_raw += expf(x - m_raw);
    if (sampling) z += expf(x / t - m_s);
  }
  z_raw = block_sum(z_raw, s_val);
  const float logz = logf(z_raw) + m_raw;

  int token = greedy;
  if (sampling) {
    z = block_sum(z, s_val);
    // each thread writes and later reads back only its own columns, so the
    // scratch row needs no synchronization of its own
    for (int c = threadIdx.x; c < vocab; c += kThreads) {
      probs[c] = expf(raw[c] / t - m_s) / z;
    }
    // bisection on the keep threshold; hi starts at max(probs) = 1 / z
    float lo = 0.0f, hi = 1.0f / z;
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float mass = 0.0f;
      for (int c = threadIdx.x; c < vocab; c += kThreads) {
        const float p = probs[c];
        mass += p >= mid ? p : 0.0f;
      }
      mass = block_sum(mass, s_val);
      if (mass >= top_p) lo = mid; else hi = mid;  // uniform across the block
    }
    // the draw: Gumbel-max over the filtered tempered logits
    const uint32_t seed = (uint32_t)seeds[blockIdx.x];
    float best = -INFINITY;
    int arg = INT_MAX;
    for (int c = threadIdx.x; c < vocab; c += kThreads) {
      const float scaled = raw[c] / t;
      const float score = (probs[c] >= lo ? scaled : kNegInf) + gumbel(seed, (uint32_t)c);
      if (beats(score, c, best, arg)) { best = score; arg = c; }
    }
    block_argmax(best, arg, s_val, s_idx);
    token = arg;
  }
  if (threadIdx.x == 0) {
    tok_out[blockIdx.x] = token;
    logp_out[blockIdx.x] = raw[token] - logz;
  }
}

}  // namespace

extern "C" {

// Launch one block per row on `stream` of `device`; returns the first CUDA
// error (0 = ok). logits: f32 [rows, vocab] contiguous; seeds: int32 [rows];
// tok: int32 [rows]; logp: f32 [rows]; scratch: f32 [rows, vocab]
// (overwritten). vocab >= 1.
int fused_sample_launch(const void* logits, float temperature, float top_p,
                        const void* seeds, void* tok, void* logp, void* scratch,
                        int rows, int vocab, int iters, int device,
                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (rows > 0) {
    fused_sample_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)logits, temperature, top_p, (const int32_t*)seeds,
        (int32_t*)tok, (float*)logp, (float*)scratch, vocab, iters);
  }
  return (int)cudaGetLastError();
}

const char* fused_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
