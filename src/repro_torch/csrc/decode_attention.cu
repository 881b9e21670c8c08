// Split-K flash-decoding for Hopper (sm_90a): one query token per sequence
// against a (B, S, Hkv, D) KV cache, in one launch that also merges the
// splits.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_kernel (TPU Pallas,
// pallas_call at decode_attention.py:62) and its combine_splits
// (decode_attention.py:89, plain jnp after the Pallas call there). Same
// function: per split a partial (acc, m, l) in fp32 with masked scores at
// NEG_INF = -1e30 and the safe_m guard, then o = sum_s acc_s e^(m_s - M) /
// sum_s l_s e^(m_s - M).
//
// What differs from the TPU kernel:
// - One block per (kv head, split, batch) computes all `group` query heads
//   that share its kv head (up to 8; a larger group is cut into blocks of
//   8), so each cache row is read once. The TPU grid
//   (decode_attention.py:64) had a query-head axis that its body ignored:
//   each program recomputed every head.
// - GQA is indexed, not repeated.
// - The merge is not a second pass: each block writes its partial to an
//   fp32 workspace and counts itself in on a per-(batch, head block)
//   counter; the block that arrives last merges the valid splits from L2,
//   writes o and resets the counter to 0 for the next launch. So a decode
//   step's attention is one launch per layer and allocates only o.
// - Splits that lie wholly at or past kv_len are never read: their blocks
//   only count themselves in, and the merge reads the splits that hold a
//   valid key. kv_len = 0 gives o = 0, as the Pallas kernel's partials do.
// - Any cache length: the ragged last split is masked, where the TPU wrapper
//   asserted S % blk_s == 0.
//
// What bounds it: one token does 4 D operations per cached key and head, far
// below the card's ops-per-byte line, so it is bound by the bytes of K and V
// up to kv_len, and it reaches the HBM rate only with enough bytes in flight
// (by Little's law ~2 MB across the card at ~600 ns). So the kernel is a
// byte stream:
// - each warp streams its own chunks of the split through a private ring
//   of kStages shared-memory stages with 16-byte cp.async, so each lane has
//   up to kStages x 8 x 16 bytes of K and V requested before it does any
//   math, and only __syncwarp orders the ring. Two stages (16 KB a block)
//   beat four and eight on the card: more blocks fit on an SM, and several
//   blocks' rings together keep enough bytes in flight;
// - a chunk is 4 rows per lane group: 16-byte vectors, so 16 lanes cover a
//   128-wide bf16 row and one warp instruction reads two rows;
// - the scores of all the group's query heads come from one read of each K
//   row; an online softmax per head (running m, l in the exp2 domain, q
//   pre-scaled by scale log2(e)) lets P V follow each chunk's scores with no
//   block-wide barrier; the warps' partial states merge once at the end;
// - splits are long (kernels/decode_attention.py's BLK_S), so the last
//   block merges few partials (5 per head at the serve path's 1056-slot
//   cache), a tail of a few hundred bytes per head read from L2.
// One int kv_len for the whole batch comes as a scalar argument (null
// pointer), so the caller fills no (B,) tensor for it.
//
// The variant with its log-sum-exp (template flag kLse, entry point
// decode_attention_lse): for a cache split over the sequence across ranks,
// each rank's attention over its slice is a partial that the ranks merge by
// combine_splits' rule, so it needs o in fp32 (not rounded to the inputs'
// type) and each row's lse. The last block's merge already holds the running max mg and
// sum lg of every head; with kLse it stores o in fp32, and one thread per
// query head stores lse = ln 2 (mg + log2 lg) (the scores are in the exp2
// domain), or NEG_INF where kv_len = 0 (o = 0 there too). Same grid, same
// reads: the o-only instantiation is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;        // chunks in flight per warp (tools/k4_variants.py)
constexpr int kChunkBytes = 2048;  // one chunk of K (and one of V): 4 steps x 32 lanes x 16 bytes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16-byte vector of a row as fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(float (&o)[4], uint32_t addr) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(o[0]), "=f"(o[1]), "=f"(o[2]), "=f"(o[3])
                 : "r"(addr)
                 : "memory");
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(float (&o)[8], uint32_t addr) {
    uint32_t w[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(addr)
                 : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);          // low bf16 of the pair
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory, asynchronously; zero-filled (and
// nothing read) when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The partial (acc, m, l) of GB query heads of one KV head's group (heads
// past the group are computed with q = 0 and not written) over the n valid
// rows [s0, s0 + n) of split si, into the workspace: m the split's max
// score and l and acc its sums of 2^(s - m) and 2^(s - m) v, in the exp2
// domain. The workspace holds acc (B, Hq, nsplit, D), then m and l
// (B, Hq, nsplit), all fp32.
template <typename T, int D, int GB>
__device__ __forceinline__ void split_partial(const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, float* __restrict__ ws,
                                              int B, int b, int si, int hk, int g0, int G,
                                              int s0, int n, int S, int Hq, int Hkv, int nsplit,
                                              float scale) {
  constexpr int VEC = Vec<T>::N;                    // elements per 16-byte vector
  constexpr int LPR = D / VEC;                      // lanes per row
  constexpr int RPI = 32 / LPR;                     // rows per warp instruction
  constexpr int CR = 4 * RPI;                       // rows per chunk
  static_assert(LPR * 16 * CR == 4 * 32 * 16, "a chunk is 4 vectors per lane");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, slice = lane % LPR;  // row within an instruction, vector of the row
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                        warp * kStages * 2 * kChunkBytes;

  // This warp's chunks: c = warp, warp + kWarps, ... of the split's rows.
  // Their first kStages are requested before anything else is read.
  const int nchunks = (n + CR - 1) / CR;
  const int mine = nchunks > warp ? (nchunks - warp + kWarps - 1) / kWarps : 0;
  const size_t row_stride = (size_t)Hkv * D;
  const T* kbase = k + ((size_t)(b * S + s0) * Hkv + hk) * D + slice * VEC;
  const T* vbase = v + ((size_t)(b * S + s0) * Hkv + hk) * D + slice * VEC;
  auto issue = [&](int i) {
    const int c = warp + i * kWarps;
    const uint32_t st = ring + (i % kStages) * 2 * kChunkBytes;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = c * CR + j * RPI + sub;  // row within the split
      const bool ok = r < n;
      const size_t off = ok ? (size_t)r * row_stride : 0;
      cp_async16(st + (j * 32 + lane) * 16, kbase + off, ok);
      cp_async16(st + kChunkBytes + (j * 32 + lane) * 16, vbase + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();  // empty groups keep the count uniform
  }

  // q of each head, pre-scaled into the exp2 domain, this lane's vector.
  float qv[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qv[g][e] = g0 + g < G
                     ? to_f(q[((size_t)b * Hq + hk * G + g0 + g) * D + slice * VEC + e]) *
                           (scale * kLog2e)
                     : 0.f;

  float m[GB], l[GB], a[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[g][e] = 0.f;
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 1>();  // chunk i has landed (this lane's copies)
    __syncwarp();                  // ... and every lane's
    const int c = warp + i * kWarps;
    const uint32_t st = ring + (i % kStages) * 2 * kChunkBytes;
    float sc[4][GB];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = c * CR + j * RPI + sub < n;
      float kr[VEC];
      Vec<T>::load(kr, st + (j * 32 + lane) * 16);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qv[g][e], kr[e], part);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        sc[j][g] = ok[j] ? part : kNegInf;
      }
    }
    float p[4][GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m_new =
          fmaxf(m[g], fmaxf(fmaxf(sc[0][g], sc[1][g]), fmaxf(sc[2][g], sc[3][g])));
      // All-masked rows: 2^(NEG_INF - NEG_INF) would be 1; p is forced to 0.
      const float safe_m = fmaxf(m_new, kNegInf / 2);
      const float alpha = ex2(m[g] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j][g] = ok[j] ? ex2(sc[j][g] - safe_m) : 0.f;
        rs += p[j][g];
      }
      l[g] = fmaf(l[g], alpha, rs);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[g][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float vr[VEC];
      Vec<T>::load(vr, st + kChunkBytes + (j * 32 + lane) * 16);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[g][e] = fmaf(p[j][g], vr[e], a[g][e]);
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    if (i + kStages < mine) issue(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // Merge the lane groups of the warp (same vector, other rows) ...
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float wa = ex2(m[g] - mn), wb = ex2(mo - mn);
      l[g] = l[g] * wa + lo * wb;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        a[g][e] = a[g][e] * wa + __shfl_xor_sync(0xffffffffu, a[g][e], o) * wb;
    }
  }
  // ... then the warps, through shared memory after the rings.
  float* part = reinterpret_cast<float*>(smem + kWarps * kStages * 2 * kChunkBytes);
  float* pm = part;                       // kWarps x GB
  float* pl = pm + kWarps * GB;           // kWarps x GB
  float* pa = pl + kWarps * GB;           // kWarps x GB x D
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (lane == 0) {
        pm[warp * GB + g] = m[g];
        pl[warp * GB + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) pa[(warp * GB + g) * D + slice * VEC + e] = a[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    if (g0 + g >= G) break;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, pm[w * GB + g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = ex2(pm[w * GB + g] - mx);
      lsum = fmaf(pl[w * GB + g], wt, lsum);
      asum = fmaf(pa[(w * GB + g) * D + d], wt, asum);
    }
    const size_t parts = (size_t)B * Hq * nsplit;
    const size_t o = ((size_t)b * Hq + hk * G + g0 + g) * nsplit + si;
    ws[o * D + d] = asum;
    if (d == 0) {
      ws[parts * D + o] = mx;  // m
      ws[parts * (D + 1) + o] = lsum;  // l
    }
  }
}

// Counts the block in on the counter of its (batch, head block); the block
// that arrives last merges the valid splits of its heads and writes o in OT
// (T, or fp32 for the variant, which also writes each head's lse), then
// resets the counter to 0 for the next launch. Every block of the
// grid counts in, a split past kv_len too, so the last one is the grid's
// nsplit-th whatever kv_len each row has. One thread's acq_rel atomic
// publishes the block's partial (written before the barrier) and, in the
// last block, makes the others' partials visible; they are read through L2.
// The merge is the block's tail on the critical path, so each thread
// issues the loads of C splits of its elements at once and merges them
// online (one L2 round trip per C splits).
template <typename OT, int D, int GB, bool kLse>
__device__ __forceinline__ void count_in_and_merge(const float* __restrict__ ws,
                                                   int* __restrict__ counter, OT* __restrict__ o,
                                                   float* __restrict__ lse, int B, int b, int hk,
                                                   int g0, int G, int klen, int Hq, int nsplit,
                                                   int blk_s) {
  constexpr int E = (GB * D + kThreads - 1) / kThreads;  // output elements per thread
  constexpr int C = E <= 2 ? 8 : 4;                       // splits per round of loads
  // The flag lives in the first word of the ring, idle by now: a static
  // __shared__ int would shift the dynamic shared memory, and so every
  // cp.async destination, 16 bytes off its 128-byte alignment, which costs
  // ~15% of the kernel (tools/k4_variants.py).
  extern __shared__ __align__(16) unsigned char smem[];
  int& last = *reinterpret_cast<int*>(smem);
  __syncthreads();  // the block's partial is written, the ring no longer read
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
    last = old == nsplit - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  const size_t parts = (size_t)B * Hq * nsplit;
  const float* acc = ws;
  const float* m = ws + parts * D;
  const float* l = m + parts;
  const int nvalid = min(nsplit, (klen + blk_s - 1) / blk_s);
  float mg[E], lg[E], a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    mg[e] = kNegInf;
    lg[e] = a[e] = 0.f;
  }
  for (int s0 = 0; s0 < nvalid; s0 += C) {
    float ms[E][C], ls[E][C], as[E][C];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = threadIdx.x + e * kThreads, g = i / D, d = i % D;
      const size_t base = ((size_t)b * Hq + hk * G + g0 + g) * nsplit;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool ok = i < GB * D && g0 + g < G && s0 + c < nvalid;
        ms[e][c] = ok ? __ldcg(m + base + s0 + c) : kNegInf;
        ls[e][c] = ok ? __ldcg(l + base + s0 + c) : 0.f;
        as[e][c] = ok ? __ldcg(acc + (base + s0 + c) * D + d) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float mx = mg[e];
#pragma unroll
      for (int c = 0; c < C; ++c) mx = fmaxf(mx, ms[e][c]);
      const float w0 = ex2(mg[e] - mx);  // 1 while nothing valid was seen
      lg[e] *= w0;
      a[e] *= w0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float w = ex2(ms[e][c] - mx);
        lg[e] = fmaf(ls[e][c], w, lg[e]);
        a[e] = fmaf(as[e][c], w, a[e]);
      }
      mg[e] = mx;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = threadIdx.x + e * kThreads, g = i / D, d = i % D;
    if (i < GB * D && g0 + g < G) {  // kv_len = 0: o = 0 (and lse = NEG_INF)
      const size_t row = (size_t)b * Hq + hk * G + g0 + g;
      o[row * D + d] = from_f<OT>(a[e] / fmaxf(lg[e], 1e-30f));
      if (kLse && d == 0) lse[row] = lg[e] > 0.f ? kLn2 * (mg[e] + log2f(lg[e])) : kNegInf;
    }
  }
}

// grid (Hkv x head blocks, nsplit, B), kThreads threads: the blocks of one
// split's KV heads are launched together, so they read neighbouring bytes
// of the same cache rows at about the same time. A block takes GB query
// heads of one KV head's group and one split: its partial, then its count.
template <typename T, int D, int GB, bool kLse>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ kv_len, int klen_s, float* __restrict__ ws,
              int* __restrict__ counters, void* __restrict__ o, float* __restrict__ lse, int B,
              int S, int Hq, int Hkv, int nsplit, int blk_s, float scale) {
  using OT = typename std::conditional<kLse, float, T>::type;
  const int hb = blockIdx.x, si = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, nhb = (G + GB - 1) / GB;
  const int hk = hb / nhb, g0 = (hb % nhb) * GB;
  const int klen = min(kv_len ? kv_len[b] : klen_s, S);
  const int s0 = si * blk_s;
  if (s0 < klen)  // else no valid key in this split
    split_partial<T, D, GB>(q, k, v, ws, B, b, si, hk, g0, G, s0, min(blk_s, klen - s0), S, Hq,
                            Hkv, nsplit, scale);
  count_in_and_merge<OT, D, GB, kLse>(ws, counters + (size_t)b * Hkv * nhb + hb,
                                      static_cast<OT*>(o), lse, B, b, hk, g0, G, klen, Hq,
                                      nsplit, blk_s);
}

template <int D, int GB>
constexpr size_t smem_bytes() {
  return (size_t)kWarps * kStages * 2 * kChunkBytes + sizeof(float) * kWarps * GB * (D + 2);
}

template <typename T, int D, int GB, bool kLse>
int launch(const void* q, const void* k, const void* v, const void* kv_len, int klen_s, void* ws,
           void* counters, void* o, void* lse, int B, int S, int Hq, int Hkv, int nsplit,
           int blk_s, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, GB>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, D, GB, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int G = Hq / Hkv;
  dim3 grid(Hkv * ((G + GB - 1) / GB), nsplit, B);
  decode_kernel<T, D, GB, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), klen_s, static_cast<float*>(ws),
      static_cast<int*>(counters), o, static_cast<float*>(lse), B, S, Hq, Hkv, nsplit, blk_s,
      scale);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const void*, int, void*, void*,
                         void*, void*, int, int, int, int, int, int, float, cudaStream_t);

// Heads per block: the group rounded up to 1, 2, 4 or 8; larger groups are
// cut into blocks of 8 heads (each reads the cache rows again).
template <typename T, int D, bool kLse>
LaunchFn pick_heads(int G) {
  if (G <= 1) return launch<T, D, 1, kLse>;
  if (G <= 2) return launch<T, D, 2, kLse>;
  if (G <= 4) return launch<T, D, 4, kLse>;
  return launch<T, D, 8, kLse>;
}

template <typename T, bool kLse>
LaunchFn pick(int D, int G) {
  switch (D) {
    case 16: return pick_heads<T, 16, kLse>(G);
    case 64: return pick_heads<T, 64, kLse>(G);
    case 128: return pick_heads<T, 128, kLse>(G);
    default: return nullptr;
  }
}

template <bool kLse>
int run(const void* q, const void* k, const void* v, const void* kv_len, int klen_s, void* ws,
        void* counters, void* o, void* lse, int B, int S, int Hq, int Hkv, int D, int nsplit,
        int blk_s, float scale, int dtype, void* stream) {
  const int G = Hq / Hkv;
  const LaunchFn f = dtype == 0   ? pick<float, kLse>(D, G)
                     : dtype == 1 ? pick<__nv_bfloat16, kLse>(D, G)
                                  : nullptr;
  if (f == nullptr) return -1;
  return f(q, k, v, kv_len, klen_s, ws, counters, o, lse, B, S, Hq, Hkv, nsplit, blk_s, scale,
           static_cast<cudaStream_t>(stream));
}

}  // namespace

// q (B,Hq,D) -> o (B,Hq,D); k and v (B,S,Hkv,D); all contiguous, one type
// (dtype 0: float32, 1: bfloat16); kv_len (B,) int32, or null for the scalar
// klen_s. ws: float32 scratch of B * Hq * nsplit * (D + 2) values; counters:
// int32, one per (batch, head block) (B * Hq suffice), all 0 before the
// call and left 0 after it, so one pair serves every call on one stream,
// never two streams at once. One launch; returns a cudaError_t, or -1 for
// an unsupported head dim or type.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* kv_len,
                                int klen_s, void* ws, void* counters, void* o, int B, int S,
                                int Hq, int Hkv, int D, int nsplit, int blk_s, float scale,
                                int dtype, void* stream) {
  return run<false>(q, k, v, kv_len, klen_s, ws, counters, o, nullptr, B, S, Hq, Hkv, D, nsplit,
                    blk_s, scale, dtype, stream);
}

// The variant: as decode_attention, but o (B,Hq,D) is float32 whatever the
// inputs' type, and lse (B,Hq) float32 receives each row's natural-log
// log-sum-exp of the scaled scores below kv_len (NEG_INF = -1e30 where
// kv_len = 0, with o = 0). Counted as its own launch by the wrapper.
extern "C" int decode_attention_lse(const void* q, const void* k, const void* v,
                                    const void* kv_len, int klen_s, void* ws, void* counters,
                                    void* o, void* lse, int B, int S, int Hq, int Hkv, int D,
                                    int nsplit, int blk_s, float scale, int dtype, void* stream) {
  return run<true>(q, k, v, kv_len, klen_s, ws, counters, o, lse, B, S, Hq, Hkv, D, nsplit,
                   blk_s, scale, dtype, stream);
}
