// Causal / non-causal flash attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (TPU Pallas,
// pallas_call at flash_attention.py:87). Same function: softmax(q k^T * scale)
// v with an online softmax over key tiles, (m, l, acc) in fp32, masked scores
// at NEG_INF = -1e30, o in the input type and lse = m + log(l) in fp32
// (natural log: the backward kernels take exp(s * scale - lse)).
//
// What differs from the TPU kernel:
// - The TPU carried (m, l, acc) across the sequential innermost grid axis.
//   Blocks run in no order here, so one block owns one (batch, query head,
//   q-tile) and loops over the key tiles itself; the state stays in
//   registers.
// - GQA is indexed (kv head = h / group) instead of repeating K and V.
// - Any length: the ragged q and k edges are masked, where the TPU wrapper
//   asserted T % blk == 0.
// - Per-batch q_offset and kv_len with the semantics of
//   repro.models.layers.chunked_attention: query t of batch b is at position
//   q_offset[b] + t, and keys at or past kv_len[b] are hidden. The key loop
//   stops at kv_len and, when causal, at the tile's last query position, so
//   tiles wholly above the diagonal or past kv_len are never loaded. One
//   value for the whole batch comes as a scalar argument (null pointer), so
//   the caller makes no (B,) tensor for it.
//
// What bounds it: at the prompt lengths of the serve path (T = 1024, D = 128)
// attention is far above the card's ops-per-byte line, so it is bound by
// operations, i.e. by the tensor cores. Three kernels, chosen by type and D:
// - bfloat16, D = 64 and 128 (the serve and training paths):
//   fwd_kernel_wgmma, in the FlashAttention-3 manner. Only wgmma reaches
//   Hopper's tensor-core rate, and only if the tiles arrive while the
//   previous ones are multiplied, so:
//   * loads: Q, K and V come in through TMA, one 4-D tensor map per tensor
//     over its (B, T, H, D) layout, in 64-column boxes with the 128-byte
//     swizzle that wgmma reads without bank conflicts. TMA fills rows past
//     T with zeros, so the ragged edges need no code (the masks stay).
//   * pipeline: K and V sit in a ring of kStages = 3 stages with mbarrier
//     full / empty pairs. One producer warp issues the loads and keeps the
//     ring full; its warpgroup gives its registers to the consumers
//     (setmaxnreg 24 / 240).
//   * products: two consumer warpgroups of 64 query rows each, so a block
//     covers 128 rows against 128-key tiles. S = Q K^T is wgmma with Q and
//     K both read from shared memory (K-major). P is rounded to bf16 in
//     registers, where the accumulator layout of S is already the A-operand
//     layout of O += P V; V is the shared-memory B operand read MN-major
//     (transpose bit set).
//   * overlap: tile j's S is issued together with tile j-1's P V, and tile
//     j's softmax runs while P V is on the tensor cores; the two
//     warpgroups take turns to issue (named barriers), so one's softmax
//     runs under the other's products.
//   * softmax: the CUDA cores, not the tensor cores, bound a tile, so a
//     tile that crosses neither kv_len nor the diagonal skips the mask and
//     costs one FFMA and one ex2 per score (max over the raw scores, exp2
//     domain); lse is converted back to the natural log.
//   * epilogue: O / l goes in bf16 through the warpgroup's rows of the Q
//     tile (swizzled) and leaves by TMA store, which also clips rows past Tq.
//   * scheduling: the q-tile index is reversed, so the blocks with the most
//     causal work start first and the short ones fill the tail.
// - bfloat16, D = 16 (the reduced configs): fwd_kernel_mma, four warps of 16
//   query rows on mma.sync m16n8k16 with synchronous tile loads. A 32-byte
//   row is too narrow for the 128-byte swizzled tiles above, and the reduced
//   configs are never timed.
// - float32 (parity checks): fwd_kernel, scalar fp32 FMAs on the CUDA cores
//   with the tiles converted to fp32 in shared memory, so the result differs
//   from an fp32 reference only in the order of sums.
//
// The mbarrier, TMA and wgmma helpers and the tensor-map encoder (from the
// driver through cudaGetDriverEntryPoint, so no libcuda is linked) are
// shared with flash_attention_bwd.cu in hopper.cuh.

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 128;  // 8 row groups x 16 column lanes
constexpr int kRows = kBQ / 8;   // query rows per thread
constexpr int kCols = kBK / 16;  // scores per thread and row

// The 16 lanes of a half-warp share one row group.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

// ------------------------------------------------------------- float32 path

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ q_offset,
           const int* __restrict__ kv_len, int off_s, int klen_s, int Tq, int Tk, int Hq,
           int Hkv, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ x DP, pre-scaled
  float* sK = sQ + kBQ * DP;    // kBK x DP
  float* sV = sK + kBK * DP;    // kBK x D
  float* sP = sV + kBK * D;     // kBQ x (kBK + 1)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = q_offset ? q_offset[b] : off_s;
  const int klen = min(kv_len ? kv_len[b] : klen_s, Tk);
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    sQ[r * DP + d] =
        t < Tq ? q[((size_t)(b * Tq + t) * Hq + h) * D + d] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kend = klen;
  if (causal) kend = min(kend, off + min(q0 + kBQ, Tq));  // last query position + 1

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // Q is loaded and the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, t = k0 + r;
      const size_t g = ((size_t)(b * Tk + t) * Hkv + hk) * D + d;
      const bool in = t < Tk;
      sK[r * DP + d] = in ? k[g] : 0.f;
      sV[r * D + d] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = off + q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= Tk) {
          s[i][j] = -INFINITY;  // past the end of the cache: weight exactly 0
        } else if ((causal && kpos > qpos) || kpos >= klen) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = sP[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty * kRows + i;
    if (t >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)(b * Tq + t) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] / lc;
    if (tx == 0) lse[((size_t)b * Hq + h) * Tq + t] = m[i] + logf(lc);
  }
}


// ------------------------------------------------------ bfloat16, D = 16

constexpr int kMmaBQ = 64;  // query rows per block: 16 per warp
constexpr int kMmaBK = 64;  // keys per tile

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 b16 matrices; lane l gives the row address of matrix
// l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Copies rows [r0, r0 + rows) of one head of a (B, T, H, D) tensor into a
// shared tile of row stride DS, 16 bytes at a time; rows past T become 0.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int r0, int T, int H, int b, int h) {
  constexpr int DS = D + 8, VEC = 8;
  for (int i = threadIdx.x; i < rows * (D / VEC); i += kThreads) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC, t = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + ((size_t)(b * T + t) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * DS + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ q_offset,
               const int* __restrict__ kv_len, int off_s, int klen_s, int Tq, int Tk, int Hq,
               int Hkv, int causal, float scale) {
  constexpr int DS = D + 8;        // padded row stride (bf16) of every tile
  constexpr int KD = D / 16;       // k-steps of Q K^T over the head dim
  constexpr int NT = kMmaBK / 8;   // 8-key column tiles of S
  constexpr int DT = D / 8;        // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMmaBQ x DS
  __nv_bfloat16* sK = sQ + kMmaBQ * DS;                             // kMmaBK x DS
  __nv_bfloat16* sV = sK + kMmaBK * DS;                             // kMmaBK x DS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row group and column pair
  const int q0 = blockIdx.x * kMmaBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = q_offset ? q_offset[b] : off_s;
  const int klen = min(kv_len ? kv_len[b] : klen_s, Tk);
  load_tile<D>(sQ, q, kMmaBQ, q0, Tq, Hq, b, h);
  __syncthreads();
  const int rq = warp * 16 + g;  // this thread's rows: rq and rq + 8
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const __nv_bfloat16* p = sQ + rq * DS + kd * 16 + 2 * t4;
    qf[kd][0] = ld_pair(p);
    qf[kd][1] = ld_pair(p + 8 * DS);
    qf[kd][2] = ld_pair(p + 8);
    qf[kd][3] = ld_pair(p + 8 * DS + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int qpos0 = off + q0 + rq;  // query positions of rows rq and rq + 8
  int kend = klen;
  if (causal) kend = min(kend, off + min(q0 + kMmaBQ, Tq));

  for (int k0 = 0; k0 < kend; k0 += kMmaBK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(sK, k, kMmaBK, k0, Tk, Hkv, b, hk);
    load_tile<D>(sV, v, kMmaBK, k0, Tk, Hkv, b, hk);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* p = sK + (n * 8 + g) * DS + 2 * t4;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma_16816(s[n], qf[kd], ld_pair(p + kd * 16), ld_pair(p + kd * 16 + 8));
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t4 + (e & 1), qpos = qpos0 + (e >> 1) * 8;
        float x = s[n][e] * scale;
        if (kpos >= Tk) {
          x = -INFINITY;  // past the end of the cache: weight exactly 0
        } else if ((causal && kpos > qpos) || kpos >= klen) {
          x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: two 16x8 S tiles make one 16x16 A fragment of P.
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int mi = lane / 8, ri = lane % 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sV + (j * 16 + (mi & 1) * 8 + ri) * DS + (dt + (mi >> 1)) * 8);
        mma_16816(acc[dt], pa, vb[0], vb[1]);
        mma_16816(acc[dt + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + rq + 8 * i;
    if (t >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)(b * Tq + t) * Hq + h) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * i] / lc, acc[dt][2 * i + 1] / lc);
    if (t4 == 0) lse[((size_t)b * Hq + h) * Tq + t] = m[i] + logf(lc);
  }
}

// ------------------------------------------------ bfloat16, D = 64 / 128

constexpr int kWgBQ = 128;  // query rows per block: 64 per consumer warpgroup
constexpr int kWgBK = 128;  // keys per tile
constexpr int kStages = 3;  // K / V ring depth
constexpr int kConsumers = 2;
constexpr int kWgThreads = (kConsumers + 1) * 128;  // + one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Shared memory, in bytes from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes). Every tile is stored as D / 64
// column blocks of (rows x 64) bf16, one TMA box each.
template <int D>
struct WgSmem {
  static constexpr uint32_t q_bytes = kWgBQ * D * 2;
  static constexpr uint32_t kv_bytes = kWgBK * D * 2;  // one K or V stage
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + kStages * kv_bytes;
  static constexpr uint32_t bar_off = v_off + kStages * kv_bytes;
  // q_full, then k_full, v_full and empty per stage
  static constexpr size_t total = bar_off + 8 * (1 + 3 * kStages) + 1024;
};

// Named barriers 1 and 2 order the two consumer warpgroups' products, 3 and
// 4 gather each warpgroup before its output store (barrier 0 is
// __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers * 128) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers * 128) : "memory");
}

// S (64 x kWgBK) = Q K^T for one warpgroup (its 64 rows of the Q tile) and
// O += P V over kWgBK / 16 k-steps of 16 keys: hopper.cuh's product loops.
template <int D>
__device__ __forceinline__ void wgmma_qk(float (&sc)[kWgBK / 2], uint32_t sQw, uint32_t sK) {
  wgmma_abt<D, kWgBK, kWgBQ, kWgBK>(sc, sQw, sK);
}
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2], const uint32_t (&pa)[kWgBK / 16][4],
                                         uint32_t sV) {
  wgmma_ab<D, kWgBK>(acc, pa, sV);
}

// One tile of the online softmax, in place: sc[i] holds the raw score of
// row qpos0 + 8 * ((i >> 1) & 1) and key kbase + 8 * (i / 4) + (i & 1). Takes
// the scores into the exp2 domain (x = s * sl2), masks them where the tile
// crosses kv_len or the diagonal (as the fp32 kernel does), updates the
// running max m, and leaves p = 2^(x - m) in sc, this thread's share of the
// row sums in l and the factor for the previous accumulator in alpha. A tile
// without masking takes the max of the raw scores (sl2 > 0 keeps the order)
// and one FFMA per score before the exponential; the max and the sums run in
// two chains per row.
__device__ __forceinline__ void online_softmax(float (&sc)[kWgBK / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2], bool need_mask,
                                               int kbase, int qpos0, int Tk, int klen,
                                               int causal, float sl2) {
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i) {
      const int kpos = kbase + 8 * (i / 4) + (i & 1);
      const int qpos = qpos0 + 8 * ((i >> 1) & 1);
      float x = sc[i] * sl2;
      if (kpos >= Tk) {
        x = -INFINITY;  // past the end of the cache: weight exactly 0
      } else if ((causal && kpos > qpos) || kpos >= klen) {
        x = kNegInf;
      }
      sc[i] = x;
      mx[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1], x);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i)
      mx[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) mx[r][c] *= sl2;
  }
  float neg_m[2], ls[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(fmaxf(mx[r][0], mx[r][1])));
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    ls[r][0] = l[r] * alpha[r];
    ls[r][1] = 0.f;
  }
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i) sc[i] = ex2(sc[i] + neg_m[(i >> 1) & 1]);
  } else {
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i) sc[i] = ex2(fmaf(sc[i], sl2, neg_m[(i >> 1) & 1]));
  }
#pragma unroll
  for (int i = 0; i < kWgBK / 2; ++i) ls[(i >> 1) & 1][(i >> 2) & 1] += sc[i];
  l[0] = ls[0][0] + ls[0][1];
  l[1] = ls[1][0] + ls[1][1];
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 float* __restrict__ lse, const int* __restrict__ q_offset,
                 const int* __restrict__ kv_len, int off_s, int klen_s, int Tq, int Tk, int Hq,
                 int Hkv, int causal, float scale) {
  using L = WgSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::k_off, sV = base + L::v_off;
  const uint32_t q_full = base + L::bar_off;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;  // + 8 * stage

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal tiles first
  const int q0 = qt * kWgBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = q_offset ? q_offset[b] : off_s;
  const int klen = min(kv_len ? kv_len[b] : klen_s, Tk);
  int kend = klen;
  if (causal) kend = min(kend, off + min(q0 + kWgBQ, Tq));  // last query position + 1
  const int ntiles = kend > 0 ? (kend + kWgBK - 1) / kWgBK : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumers * 4 && lane == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * kWgBQ * 128, &tm_q, q_full, c * 64, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK + s * L::kv_bytes + c * kWgBK * 128, &tm_k, k_full + 8 * s, c * 64, hk,
                      it * kWgBK, b);
        mbar_expect_tx(v_full + 8 * s, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sV + s * L::kv_bytes + c * kWgBK * 128, &tm_v, v_full + 8 * s, c * 64, hk,
                      it * kWgBK, b);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4;
    const int g = lane / 4, t4 = lane % 4;          // accumulator row group, column pair
    const int row0 = wg * 64 + (warp % 4) * 16 + g;  // this thread's rows: row0, row0 + 8
    const int qpos0 = off + q0 + row0;
    const int qmin = off + q0 + wg * 64;  // the warpgroup's first query position
    const uint32_t sQw = sQ + wg * (64 * 128);
    const float sl2 = scale * kLog2e;     // scores in the exp2 domain
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2], acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kWgBK / 2];         // S of the current tile, then its P in fp32
    uint32_t pa[kWgBK / 16][4];  // P of the previous tile in bf16, the A operand of P V
    // The mask is needed only where the tile crosses kv_len or the diagonal.
    auto softmax = [&](int it) {
      const int k0 = it * kWgBK;
      online_softmax(sc, m, l, alpha, k0 + kWgBK > klen || (causal && k0 + kWgBK - 1 > qmin),
                     k0 + 2 * t4, qpos0, Tk, klen, causal, sl2);
    };

    // Tile j's S = Q K^T is issued together with tile j-1's O += P V, and
    // tile j's softmax runs while P V is still on the tensor cores. The two
    // warpgroups take turns to issue (ping-pong on named barriers 1 and 2),
    // so one's softmax overlaps the other's products: ntiles + 1 turns each,
    // and warpgroup 1 lets warpgroup 0 go first.
    const int turn = 1 + wg, other = 2 - wg, last_turn = ntiles;
    if (wg == 1 && ntiles > 0) bar_arrive(other);
    auto take_turn = [&] { bar_sync(turn); };
    auto end_turn = [&](int t) {
      if (wg == 0 || t < last_turn) bar_arrive(other);
    };
    mbar_wait(q_full, 0);
    if (ntiles > 0) {
      mbar_wait(k_full, 0);
      take_turn();
      wg_fence();
      wgmma_qk<D>(sc, sQw, sK);
      wg_commit();
      end_turn(0);
      wg_wait<0>();
      fence_regs(sc);
      softmax(0);
      pack_a(pa, sc);
    }
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % kStages, sp = (it - 1) % kStages;
      mbar_wait(k_full + 8 * s, (it / kStages) & 1);
      mbar_wait(v_full + 8 * sp, ((it - 1) / kStages) & 1);
      fence_regs(acc);
      fence_regs(pa);
      take_turn();
      wg_fence();
      wgmma_qk<D>(sc, sQw, sK + s * L::kv_bytes);
      wg_commit();
      wgmma_pv<D>(acc, pa, sV + sp * L::kv_bytes);
      wg_commit();
      end_turn(it);
      wg_wait<1>();  // S is done; P V may still run
      fence_regs(sc);
      softmax(it);
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sp);  // this warp is done with tile it-1's stage
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_a(pa, sc);
    }
    if (ntiles > 0) {
      const int sl = (ntiles - 1) % kStages;
      mbar_wait(v_full + 8 * sl, ((ntiles - 1) / kStages) & 1);
      fence_regs(acc);
      fence_regs(pa);
      take_turn();
      wg_fence();
      wgmma_pv<D>(acc, pa, sV + sl * L::kv_bytes);
      wg_commit();
      end_turn(ntiles);
      wg_wait<0>();
      fence_regs(acc);
    }

    // Epilogue: O / l in bf16 into this warpgroup's rows of the Q tile (free
    // once its last S = Q K^T is done), in the 128-byte swizzled layout, then
    // one TMA store per column block; rows past Tq are not written.
    const int wrow = (warp % 4) * 16 + g;  // row within the warpgroup's 64
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
      const float inv = 1.f / lc;
      const int row = wrow + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t dst = sQw + (j / 8) * (kWgBQ * 128) + sw128_offset(row, j % 8) + 4 * t4;
        const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
      }
      // m is in the exp2 domain; a row that saw no key keeps NEG_INF as is.
      const int t = q0 + row0 + 8 * r;
      if (t4 == 0 && t < Tq)
        lse[((size_t)b * Hq + h) * Tq + t] = (m[r] == kNegInf ? kNegInf : m[r] * kLn2) + logf(lc);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync_wg(3 + wg);
    if (warp % 4 == 0 && lane == 0 && q0 + wg * 64 < Tq) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_4d(&tm_o, sQw + c * (kWgBQ * 128), c * 64, h, q0 + wg * 64, b);
      tma_store_commit_and_wait();
    }
  }
}

// ------------------------------------------------------------ host side

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                 const void* q_offset, const void* kv_len, int off_s, int klen_s, int B, int Tq,
                 int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = WgSmem<D>::total;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv, to;
  int rc = make_map(&tq, q, B, Tq, Hq, D, kWgBQ);
  if (rc == 0) rc = make_map(&tk, k, B, Tk, Hkv, D, kWgBK);
  if (rc == 0) rc = make_map(&tv, v, B, Tk, Hkv, D, kWgBK);
  if (rc == 0) rc = make_map(&to, o, B, Tq, Hq, D, 64);
  if (rc != 0) return rc;
  dim3 grid((Tq + kWgBQ - 1) / kWgBQ, Hq, B);
  fwd_kernel_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, to, static_cast<float*>(lse),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_len), off_s, klen_s, Tq, Tk,
      Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
               const void* q_offset, const void* kv_len, int off_s, int klen_s, int B, int Tq,
               int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static_assert(smem <= 48 * 1024, "above 48 KB the launch needs the shared-memory attribute");
  dim3 grid((Tq + kMmaBQ - 1) / kMmaBQ, Hq, B);
  fwd_kernel_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), off_s, klen_s, Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- dispatch

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* q_offset, const void* kv_len, int off_s, int klen_s, int B, int Tq,
           int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), off_s, klen_s, Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, void*, const void*,
                         const void*, int, int, int, int, int, int, int, int, float,
                         cudaStream_t);

// float32 -> the scalar kernel; bfloat16 -> wgmma for D = 64 / 128, mma.sync
// for D = 16.
LaunchFn pick(int dtype, int D) {
  if (dtype == 0) {
    switch (D) {
      case 16: return launch<16>;
      case 64: return launch<64>;
      case 128: return launch<128>;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_mma<16>;
      case 64: return launch_wgmma<64>;
      case 128: return launch_wgmma<128>;
    }
  }
  return nullptr;
}

}  // namespace

// q (B,Tq,Hq,D), k and v (B,Tk,Hkv,D), o (B,Tq,Hq,D), all contiguous and of
// one type (dtype 0: float32, 1: bfloat16); lse (B,Hq,Tq) float32.
// q_offset and kv_len are (B,) int32, or null for the scalars off_s and
// klen_s. Returns a cudaError_t, -1 for an unsupported head dim or type, -2
// when the driver has no tensor-map encoder and -3 when a map is refused.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const void* q_offset, const void* kv_len,
                                   int off_s, int klen_s, int B, int Tq, int Tk, int Hq,
                                   int Hkv, int D, int causal, float scale, int dtype,
                                   void* stream) {
  const LaunchFn f = pick(dtype, D);
  if (f == nullptr) return -1;
  return f(q, k, v, o, lse, q_offset, kv_len, off_s, klen_s, B, Tq, Tk, Hq, Hkv, causal, scale,
           static_cast<cudaStream_t>(stream));
}
