// Split-K flash-decoding for Hopper (sm_90a): one query token per sequence
// against a (B, S, Hkv, D) KV cache, then a logsumexp merge of the splits.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_kernel (TPU Pallas,
// pallas_call at decode_attention.py:62) and its combine_splits (L89, plain
// jnp there, a second small kernel here). Same function: per split a partial
// (acc, m, l) in fp32 with masked scores at NEG_INF = -1e30 and the safe_m
// guard, then o = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
//
// What differs from the TPU kernel:
// - One block per (split, kv head, batch) computes all `group` query heads
//   that share its kv head, so each cache row is read once. The TPU grid
//   (decode_attention.py:64) had a query-head axis that its body ignored:
//   each program recomputed every head.
// - GQA is indexed, not repeated.
// - Splits that lie wholly at or past kv_len are skipped: their blocks exit
//   at once and the combine reads only the splits that hold a valid key.
// - Any cache length: the ragged last split is masked, where the TPU wrapper
//   asserted S % blk_s == 0.
//
// What bounds it: one token does 4 D operations per cached key and head, far
// below the card's ops-per-byte line, so it is bound by the bytes of K and V
// up to kv_len. The design reads each of those bytes once (coalesced, one
// warp per key row) and keeps q, the scores and the probabilities in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (nsplit, Hkv, B); dynamic shared memory: (G * D + G * blk_s) floats.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splits_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ kv_len, float* __restrict__ acc,
              float* __restrict__ m_out, float* __restrict__ l_out, int S, int Hq,
              int Hkv, int nsplit, int blk_s, float scale) {
  constexpr int PER = (D + 31) / 32;  // head-dim elements per lane
  const int si = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int klen = min(kv_len[b], S);
  const int s0 = si * blk_s;
  if (s0 >= klen) return;  // no valid key in this split
  const int n = min(blk_s, klen - s0);  // valid keys of this split

  extern __shared__ float smem[];
  float* sq = smem;           // G x D, pre-scaled
  float* ss = smem + G * D;   // G x blk_s scores, then probabilities
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < G * D; i += kThreads)
    sq[i] = to_f(q[((size_t)b * Hq + hk * G) * D + i]) * scale;
  __syncthreads();

  // Scores: one warp per key row, lanes across the head dim.
  for (int j = warp; j < blk_s; j += kWarps) {
    const bool valid = j < n;
    float kr[PER];
    const T* krow = k + ((size_t)(b * S + s0 + j) * Hkv + hk) * D;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int d = lane + 32 * e;
      kr[e] = (valid && d < D) ? to_f(krow[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int d = lane + 32 * e;
        if (d < D) part = fmaf(sq[g * D + d], kr[e], part);
      }
      part = warp_sum(part);
      if (lane == 0) ss[g * blk_s + j] = valid ? part : kNegInf;
    }
  }
  __syncthreads();

  // Softmax statistics of the split: one warp per query head.
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < blk_s; j += 32) mx = fmaxf(mx, ss[g * blk_s + j]);
    mx = warp_max(mx);
    // All-masked splits: exp(NEG_INF - NEG_INF) would be 1; p is forced to 0.
    const float safe_m = fmaxf(mx, kNegInf / 2);
    float sum = 0.f;
    for (int j = lane; j < blk_s; j += 32) {
      const float p = j < n ? expf(ss[g * blk_s + j] - safe_m) : 0.f;
      ss[g * blk_s + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const size_t o = ((size_t)b * Hq + hk * G + g) * nsplit + si;
      m_out[o] = mx;
      l_out[o] = sum;
    }
  }
  __syncthreads();

  // acc = P V over the valid keys; consecutive threads on consecutive d.
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const T* vcol = v + ((size_t)(b * S + s0) * Hkv + hk) * D + d;
    float a = 0.f;
    for (int j = 0; j < n; ++j) a = fmaf(ss[g * blk_s + j], to_f(vcol[(size_t)j * Hkv * D]), a);
    acc[(((size_t)b * Hq + hk * G + g) * nsplit + si) * D + d] = a;
  }
}

// grid (Hq, B); one thread per head-dim element (block of >= 32 threads).
template <typename T>
__global__ void combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                               const float* __restrict__ l, const int* __restrict__ kv_len,
                               T* __restrict__ o, int S, int Hq, int D, int nsplit,
                               int blk_s) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int klen = min(kv_len[b], S);
  const int nvalid = min(nsplit, (klen + blk_s - 1) / blk_s);
  const size_t base = ((size_t)b * Hq + h) * nsplit;
  float mg = kNegInf;
  for (int s = 0; s < nvalid; ++s) mg = fmaxf(mg, m[base + s]);
  float lg = 0.f, a = 0.f;
  for (int s = 0; s < nvalid; ++s) {
    const float w = expf(m[base + s] - mg);
    lg = fmaf(l[base + s], w, lg);
    if (d < D) a = fmaf(acc[(base + s) * D + d], w, a);
  }
  if (d < D) o[((size_t)b * Hq + h) * D + d] = from_f<T>(a / fmaxf(lg, 1e-30f));
}

template <typename T, int D>
int launch_splits(const void* q, const void* k, const void* v, const void* kv_len,
                  void* acc, void* m, void* l, int B, int S, int Hq, int Hkv, int nsplit,
                  int blk_s, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * blk_s);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        splits_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(nsplit, Hkv, B);
  splits_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, Hq, Hkv, nsplit, blk_s, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_splits(int D, const void* q, const void* k, const void* v, const void* kv_len,
                    void* acc, void* m, void* l, int B, int S, int Hq, int Hkv, int nsplit,
                    int blk_s, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_splits<T, 16>(q, k, v, kv_len, acc, m, l, B, S, Hq, Hkv, nsplit, blk_s, scale, stream);
    case 64: return launch_splits<T, 64>(q, k, v, kv_len, acc, m, l, B, S, Hq, Hkv, nsplit, blk_s, scale, stream);
    case 128: return launch_splits<T, 128>(q, k, v, kv_len, acc, m, l, B, S, Hq, Hkv, nsplit, blk_s, scale, stream);
    default: return -1;
  }
}

}  // namespace

// q (B,Hq,D); k and v (B,S,Hkv,D), contiguous, one type (dtype 0: float32,
// 1: bfloat16); kv_len (B,) int32; acc (B,Hq,nsplit,D), m and l (B,Hq,nsplit)
// float32. Splits at or past kv_len are left unwritten. Returns a
// cudaError_t, or -1 for an unsupported head dim or type.
extern "C" int decode_attention_splits(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* acc, void* m, void* l,
                                       int B, int S, int Hq, int Hkv, int D, int nsplit,
                                       int blk_s, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_splits<float>(D, q, k, v, kv_len, acc, m, l, B, S, Hq, Hkv, nsplit, blk_s, scale, s);
  if (dtype == 1)
    return dispatch_splits<__nv_bfloat16>(D, q, k, v, kv_len, acc, m, l, B, S, Hq, Hkv, nsplit, blk_s, scale, s);
  return -1;
}

// Merges the valid splits into o (B,Hq,D) of the given type.
extern "C" int decode_attention_combine(const void* acc, const void* m, const void* l,
                                        const void* kv_len, void* o, int B, int S, int Hq,
                                        int D, int nsplit, int blk_s, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(Hq, B);
  const int threads = ((D + 31) / 32) * 32;
  const float* a = static_cast<const float*>(acc);
  const float* mm = static_cast<const float*>(m);
  const float* ll = static_cast<const float*>(l);
  const int* kl = static_cast<const int*>(kv_len);
  if (dtype == 0)
    combine_kernel<float><<<grid, threads, 0, s>>>(a, mm, ll, kl, static_cast<float*>(o), S, Hq, D, nsplit, blk_s);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(a, mm, ll, kl, static_cast<__nv_bfloat16*>(o), S, Hq, D, nsplit, blk_s);
  else
    return -1;
  return (int)cudaGetLastError();
}
