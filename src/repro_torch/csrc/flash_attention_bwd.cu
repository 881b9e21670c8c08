// Flash attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (TPU Pallas,
// pallas_call at flash_attention.py:207) and ::_dkv_kernel (pallas_call at
// flash_attention.py:224). Same function: from the forward's lse and
// delta = rowsum(dO * O) (taken by the caller, as JAX does outside its
// kernels), p = exp(s * scale - lse), ds = p * (dp - delta) * scale with
// dp = dO V^T, then dQ = dS K, dK = dS^T Q (Q unscaled), dV = P^T dO. Masked
// pairs (causal, or past a ragged edge) get p = 0 exactly, as NEG_INF did.
// Accumulation in fp32; outputs in the input type.
//
// What differs from the TPU kernels:
// - The TPU carried dQ (resp. dK, dV) in VMEM scratch across the sequential
//   innermost grid axis. Here one block owns one output tile and loops
//   itself: dq_kernel is one block per (q tile, query head, batch) looping
//   over the key tiles up to the tile's last query; dkv_kernel is one block
//   per (k tile, KV head, batch) looping over the group's query heads and
//   the query tiles at or below the diagonal. dQ, dK and dV stay in
//   registers and are written once.
// - GQA: the TPU wrapper repeated K and V per query head and summed dK / dV
//   over the group afterwards (repro/kernels/ops.py:52-64). Here dkv_kernel
//   sums the group inside the block: no repeat copy and no atomics.
// - Any length: ragged q and k edges are masked, where the TPU asserted
//   T % blk == 0.
//
// What bounds it: at the training shape (T = 1024, D = 128) both kernels
// are far above the card's ops-per-byte line, so operations bound them,
// i.e. the tensor cores. Only wgmma reaches Hopper's tensor-core rate, and
// only if the tiles arrive while the previous ones are multiplied. The
// versions, chosen by input type and D:
// - bfloat16 dK/dV at D = 64 and 128 (the training path): dkv_kernel_wgmma,
//   the FlashAttention-3 backward without its dQ:
//   * tiles: 128 keys per block in two consumer warpgroups of 64; K and V
//     come in once by TMA, then (Q, dO) tiles of 64 queries stream through
//     a 3-stage mbarrier ring with their lse and delta, over every (group
//     head, query tile) the key tile sees. A producer warpgroup issues the
//     loads and gives its registers to the consumers (setmaxnreg 24 / 240:
//     dK and dV take 128 fp32 registers per consumer thread at D = 128).
//   * products: S^T = K Q^T and dP^T = V dO^T take K and V as shared A
//     operands and Q and dO as K-major B operands; P^T and dS^T are rounded
//     to bf16 in registers, where the accumulator layout is the A-operand
//     layout of dV += P^T dO and dK += dS^T Q, which read dO and Q MN-major
//     through the same swizzled tiles (as K1 reads V).
//   * softmax work: exp2 domain, one FFMA and one ex2 per score; only the
//     diagonal tile of a causal run tests positions (the ragged edges need
//     no test, see the kernel).
//   * scheduling: the key tile with the most queries below it starts first.
//   * epilogue: dK and dV staged over K and V in shared memory, TMA stores
//     that clip rows past Tk.
// - bfloat16 dQ at D = 64 and 128 (the training path): dq_kernel_wgmma. Its
//   operands are K1's: S = Q K^T is K1's score product, dP = dO V^T the same
//   product with dO and V in Q's and K's places, and dQ += dS K is K1's
//   O += P V with K in V's place (read MN-major through the same swizzled
//   tile); hopper.cuh's product loops serve both kernels. There is no online
//   softmax and no rescaling, since lse comes from the forward. So:
//   * tiles: 128 queries per block in two consumer warpgroups of 64; Q and
//     dO come in once by TMA, then (K, V) tiles of 64 keys stream through a
//     3-stage mbarrier ring from a producer warp (setmaxnreg 24 / 240).
//     64-key tiles leave a consumer thread registers for dQ (64 fp32 at
//     D = 128), S and dP (32 each) and dS in bf16 (16), so:
//   * overlap: tile j's S and dP are issued together with tile j-1's
//     dQ += dS K, and tile j's scores are worked while that product runs.
//   * softmax work: exp2 domain, one FFMA and one ex2 per score, lse and
//     delta of the thread's two rows held in registers; only a tile that
//     crosses the warpgroup's diagonal or Tk tests positions.
//   * scheduling: the query tile with the most keys before it starts first;
//     the heads of one KV head are neighbours in the grid and share K and V
//     through L2 (GQA is indexed, no repeat).
//   * epilogue: dQ staged over the warpgroup's rows of the Q tile, TMA
//     stores that clip rows past Tq.
// - bfloat16 at D = 16 (the reduced configs): dq_kernel_mma / dkv_kernel_mma,
//   four warps of 16 rows (queries in dQ, keys in dK/dV) multiplying with
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate): S and dP come from
//   fragments of shared-memory tiles; P and dS are rounded to bf16 and
//   reused from registers as the A operand of the next product; K, Q and dO
//   reach that product as B operands through ldmatrix.trans. Tile rows are
//   padded by 16 bytes so the fragment loads hit distinct banks. A 32-byte
//   row is too narrow for the 128-byte swizzled tiles above.
// - float32 (parity checks): dq_kernel / dkv_kernel, scalar fp32 FMAs on
//   the CUDA cores, tiles converted to fp32 in shared memory (row stride
//   D + 1, so column walks hit distinct banks), 128 threads as 8 row groups
//   x 16 column lanes; the result differs from an fp32 reference only in
//   the order of sums.

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder (shared with K1)

namespace {

constexpr int kThreads = 128;  // 8 row groups x 16 column lanes
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 32;        // keys per tile

// Copies rows [r0, r0 + rows) of head h of a (B, T, H, D) tensor into a
// shared tile of row stride D + 1; rows past T become 0.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int rows,
                                          int r0, int T, int H, int b, int h) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D, t = r0 + r;
    dst[r * DP + d] = t < T ? src[((size_t)(b * T + t) * H + h) * D + d] : 0.f;
  }
}

// lse and delta of rows [q0, q0 + kBQ) of (b, h), both (B, Hq, Tq) fp32.
__device__ __forceinline__ void load_stats(float* sL, float* sDelta, const float* lse,
                                           const float* delta, int q0, int Tq, int Hq, int b,
                                           int h) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int t = q0 + i;
    const size_t row = ((size_t)b * Hq + h) * Tq + t;
    sL[i] = t < Tq ? lse[row] : 0.f;
    sDelta[i] = t < Tq ? delta[row] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) +
                          (size_t)kBQ * (kBK + 1) + 2 * kBQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBK * (D + 1) + 2 * (size_t)kBQ * (D + 1) +
                          2 * (size_t)kBK * (kBQ + 1) + 2 * kBQ);
}

// ------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk, int Hq,
          int Hkv, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;   // dQ columns per thread
  constexpr int R = kBQ / 8;   // query rows per thread
  constexpr int C = kBK / 16;  // keys per thread and tile
  constexpr int SP = kBK + 1;  // row stride of dS
  extern __shared__ float smem[];
  float* sQ = smem;            // kBQ x DP
  float* sDO = sQ + kBQ * DP;  // kBQ x DP
  float* sK = sDO + kBQ * DP;  // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x DP
  float* sDS = sV + kBK * DP;  // kBQ x SP
  float* sL = sDS + kBQ * SP;  // kBQ
  float* sDelta = sL + kBQ;    // kBQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  load_rows<D>(sQ, q, kBQ, q0, Tq, Hq, b, h);
  load_rows<D>(sDO, dout, kBQ, q0, Tq, Hq, b, h);
  load_stats(sL, sDelta, lse, delta, q0, Tq, Hq, b, h);

  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int kend = Tk;
  if (causal) kend = min(kend, min(q0 + kBQ, Tq));  // last query of the tile + 1

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // Q, dO and stats are loaded; the previous tile is consumed
    load_rows<D>(sK, k, kBK, k0, Tk, Hkv, b, hk);
    load_rows<D>(sV, v, kBK, k0, Tk, Hkv, b, hk);
    __syncthreads();

    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], ov[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = sQ[(ty * R + i) * DP + d];
        ov[i] = sDO[(ty * R + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        kv[j] = sK[(tx + 16 * j) * DP + d];
        vv[j] = sV[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i, t = q0 + r;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float p = 0.f;
        if (t < Tq && kpos < Tk && !(causal && kpos > t)) p = expf(s[i][j] * scale - sL[r]);
        sDS[r * SP + tx + 16 * j] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ds = sDS[(ty * R + i) * SP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty * R + i;
    if (t >= Tq) continue;
    float* row = dq + ((size_t)(b * Tq + t) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------- dK, dV

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
           int Tq, int Tk, int Hq, int Hkv, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;   // dK / dV columns per thread
  constexpr int KR = kBK / 8;  // keys per thread
  constexpr int QC = kBQ / 16; // queries per thread and tile
  constexpr int SP = kBQ + 1;  // row stride of P^T and dS^T
  extern __shared__ float smem[];
  float* sK = smem;            // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x DP
  float* sQ = sV + kBK * DP;   // kBQ x DP
  float* sDO = sQ + kBQ * DP;  // kBQ x DP
  float* sP = sDO + kBQ * DP;  // kBK x SP (P^T)
  float* sDS = sP + kBK * SP;  // kBK x SP (dS^T)
  float* sL = sDS + kBK * SP;  // kBQ
  float* sDelta = sL + kBQ;    // kBQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  load_rows<D>(sK, k, kBK, k0, Tk, Hkv, b, hk);
  load_rows<D>(sV, v, kBK, k0, Tk, Hkv, b, hk);

  float gk[KR][DC], gv[KR][DC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;

  // Causal: only queries at or past k0 see this tile's keys.
  const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int q0 = qstart; q0 < Tq; q0 += kBQ) {
      __syncthreads();  // K and V are loaded; the previous q tile is consumed
      load_rows<D>(sQ, q, kBQ, q0, Tq, Hq, b, h);
      load_rows<D>(sDO, dout, kBQ, q0, Tq, Hq, b, h);
      load_stats(sL, sDelta, lse, delta, q0, Tq, Hq, b, h);
      __syncthreads();

      float s[KR][QC], dp[KR][QC];
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < QC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[KR], vv[KR], qv[QC], ov[QC];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          kv[i] = sK[(ty * KR + i) * DP + d];
          vv[i] = sV[(ty * KR + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          qv[j] = sQ[(tx + 16 * j) * DP + d];
          ov[j] = sDO[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < KR; ++i)
#pragma unroll
          for (int j = 0; j < QC; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int kr = ty * KR + i, kpos = k0 + kr;
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          const int r = tx + 16 * j, t = q0 + r;
          float p = 0.f;
          if (t < Tq && kpos < Tk && !(causal && kpos > t)) p = expf(s[i][j] * scale - sL[r]);
          sP[kr * SP + r] = p;
          sDS[kr * SP + r] = p * (dp[i][j] - sDelta[r]) * scale;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float qv[DC], ov[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          qv[c] = sQ[qq * DP + tx + 16 * c];
          ov[c] = sDO[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          const float p = sP[(ty * KR + i) * SP + qq];
          const float ds = sDS[(ty * KR + i) * SP + qq];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            gv[i][c] = fmaf(p, ov[c], gv[i][c]);
            gk[i][c] = fmaf(ds, qv[c], gk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int t = k0 + ty * KR + i;
    if (t >= Tk) continue;
    const size_t off = ((size_t)(b * Tk + t) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = gk[i][c];
      dv[off + tx + 16 * c] = gv[i][c];
    }
  }
}

// ---------------------------------------------------------------- bf16 path

constexpr int kMmaB = 64;  // rows of every tile: 16 per warp
static_assert(kMmaB == kBQ, "load_stats fills kBQ rows of lse and delta");

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 4 * (size_t)kMmaB * (D + 8) + sizeof(float) * 2 * kMmaB;
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

// Copies rows [r0, r0 + kMmaB) of head h of a (B, T, H, D) tensor into a
// shared tile of row stride D + 8, 16 bytes at a time; rows past T become 0.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int T, int H, int b, int h) {
  constexpr int DS = D + 8, VEC = 8;
  for (int i = threadIdx.x; i < kMmaB * (D / VEC); i += kThreads) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC, t = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + ((size_t)(b * T + t) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * DS + c) = val;
  }
}

// The A fragment (16 x 16, row) of rows r and r + 8 of a shared tile, at
// columns [c, c + 16).
__device__ __forceinline__ void a_frag(uint32_t a[4], const __nv_bfloat16* tile, int DS, int r,
                                       int c) {
  const __nv_bfloat16* p = tile + r * DS + c;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * DS);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * DS + 8);
}

// acc (16 x D) += X (16 x 64, the accumulator tiles x[8][4] rounded to bf16)
// * tile (64 x D, row-major in shared memory).
template <int D>
__device__ __forceinline__ void mma_rows_by_tile(float acc[][4], float x[][4],
                                                 const __nv_bfloat16* tile, int lane) {
  constexpr int DS = D + 8, DT = D / 8;
  const int mi = lane / 8, ri = lane % 8;
#pragma unroll
  for (int j = 0; j < kMmaB / 16; ++j) {  // two 16x8 tiles make one 16x16 A fragment
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t bm[4];
      ldmatrix_x4_trans(bm, tile + (j * 16 + (mi & 1) * 8 + ri) * DS + (dt + (mi >> 1)) * 8);
      mma_16816(acc[dt], a, bm[0], bm[1]);
      mma_16816(acc[dt + 1], a, bm[2], bm[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int Hq, int Hkv, int causal,
              float scale) {
  constexpr int DS = D + 8;       // padded row stride (bf16) of every tile
  constexpr int KD = D / 16;      // k-steps over the head dim
  constexpr int NT = kMmaB / 8;   // 8-key column tiles of S and dP
  constexpr int DT = D / 8;       // 8-wide column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMmaB x DS
  __nv_bfloat16* sDO = sQ + kMmaB * DS;
  __nv_bfloat16* sK = sDO + kMmaB * DS;
  __nv_bfloat16* sV = sK + kMmaB * DS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row group and column pair
  const int q0 = blockIdx.x * kMmaB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int rq = warp * 16 + g;  // this thread's rows: rq and rq + 8
  load_tile<D>(sQ, q, q0, Tq, Hq, b, h);
  load_tile<D>(sDO, dout, q0, Tq, Hq, b, h);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + rq + 8 * i;
    const size_t row = ((size_t)b * Hq + h) * Tq + t;
    lse_r[i] = t < Tq ? lse[row] : 0.f;
    delta_r[i] = t < Tq ? delta[row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int kend = Tk;
  if (causal) kend = min(kend, min(q0 + kMmaB, Tq));
  for (int k0 = 0; k0 < kend; k0 += kMmaB) {
    __syncthreads();  // Q and dO are loaded; the previous tile is consumed
    load_tile<D>(sK, k, k0, Tk, Hkv, b, hk);
    load_tile<D>(sV, v, k0, Tk, Hkv, b, hk);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t aq[4], ao[4];
      a_frag(aq, sQ, DS, rq, kd * 16 + 2 * t4);
      a_frag(ao, sDO, DS, rq, kd * 16 + 2 * t4);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* pk = sK + (n * 8 + g) * DS + kd * 16 + 2 * t4;
        const __nv_bfloat16* pv = sV + (n * 8 + g) * DS + kd * 16 + 2 * t4;
        mma_16816(s[n], aq, ld_pair(pk), ld_pair(pk + 8));
        mma_16816(dp[n], ao, ld_pair(pv), ld_pair(pv + 8));
      }
    }
    // dS = P * (dP - delta) * scale, written over s.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, t = q0 + rq + 8 * i, kpos = k0 + n * 8 + 2 * t4 + (e & 1);
        float p = 0.f;
        if (t < Tq && kpos < Tk && !(causal && kpos > t)) p = expf(s[n][e] * scale - lse_r[i]);
        s[n][e] = p * (dp[n][e] - delta_r[i]) * scale;
      }
    mma_rows_by_tile<D>(acc, s, sK, lane);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + rq + 8 * i;
    if (t >= Tq) continue;
    __nv_bfloat16* row = dq + ((size_t)(b * Tq + t) * Hq + h) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq, int Tk,
               int Hq, int Hkv, int causal, float scale) {
  constexpr int DS = D + 8;
  constexpr int KD = D / 16;
  constexpr int NT = kMmaB / 8;   // 8-query column tiles of S^T and dP^T
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMmaB x DS
  __nv_bfloat16* sV = sK + kMmaB * DS;
  __nv_bfloat16* sQ = sV + kMmaB * DS;
  __nv_bfloat16* sDO = sQ + kMmaB * DS;
  float* sL = reinterpret_cast<float*>(sDO + kMmaB * DS);  // kMmaB
  float* sDelta = sL + kMmaB;                               // kMmaB

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * kMmaB, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int rk = warp * 16 + g;  // this thread's keys: rk and rk + 8 of the tile
  load_tile<D>(sK, k, k0, Tk, Hkv, b, hk);
  load_tile<D>(sV, v, k0, Tk, Hkv, b, hk);

  float gk[DT][4], gv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[dt][e] = gv[dt][e] = 0.f;

  const int qstart = causal ? (k0 / kMmaB) * kMmaB : 0;  // queries at or past k0
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int q0 = qstart; q0 < Tq; q0 += kMmaB) {
      __syncthreads();  // K and V are loaded; the previous q tile is consumed
      load_tile<D>(sQ, q, q0, Tq, Hq, b, h);
      load_tile<D>(sDO, dout, q0, Tq, Hq, b, h);
      load_stats(sL, sDelta, lse, delta, q0, Tq, Hq, b, h);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ak[4], av[4];
        a_frag(ak, sK, DS, rk, kd * 16 + 2 * t4);
        a_frag(av, sV, DS, rk, kd * 16 + 2 * t4);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* pq = sQ + (n * 8 + g) * DS + kd * 16 + 2 * t4;
          const __nv_bfloat16* pd = sDO + (n * 8 + g) * DS + kd * 16 + 2 * t4;
          mma_16816(s[n], ak, ld_pair(pq), ld_pair(pq + 8));
          mma_16816(dp[n], av, ld_pair(pd), ld_pair(pd + 8));
        }
      }
      // P^T over s, dS^T over dp.
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t4 + (e & 1), t = q0 + c, key = k0 + rk + 8 * (e >> 1);
          float p = 0.f;
          if (t < Tq && key < Tk && !(causal && key > t)) p = expf(s[n][e] * scale - sL[c]);
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sDelta[c]) * scale;
        }
      mma_rows_by_tile<D>(gv, s, sDO, lane);  // dV += P^T dO
      mma_rows_by_tile<D>(gk, dp, sQ, lane);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + rk + 8 * i;
    if (t >= Tk) continue;
    const size_t off = ((size_t)(b * Tk + t) * Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8) =
          __floats2bfloat162_rn(gk[dt][2 * i], gk[dt][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8) =
          __floats2bfloat162_rn(gv[dt][2 * i], gv[dt][2 * i + 1]);
    }
  }
}

// ------------------------------------------ dK, dV: bfloat16, D = 64 / 128

constexpr int kDkvBK = 128;          // keys per block: 64 per consumer warpgroup
constexpr int kDkvBQ = 64;           // queries per streamed (Q, dO) tile
constexpr int kDkvStages = 3;        // depth of the (Q, dO, lse, delta) ring
constexpr int kDkvThreads = 3 * 128; // two consumer warpgroups + one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte aligned base. K and V (loaded
// once) and each stage's Q and dO are stored as D / 64 column blocks of
// (rows x 64) bf16, 128-byte swizzled, one TMA box each; each stage also
// holds lse * log2(e) and delta of its 64 queries in fp32.
template <int D>
struct DkvSmem {
  static constexpr uint32_t kv_bytes = kDkvBK * D * 2;    // K or V
  static constexpr uint32_t tile_bytes = kDkvBQ * D * 2;  // Q or dO of one stage
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = kv_bytes;
  static constexpr uint32_t q_off = 2 * kv_bytes;  // stage s: Q at + 2 s tile_bytes, dO after it
  static constexpr uint32_t stat_off = q_off + kDkvStages * 2 * tile_bytes;
  static constexpr uint32_t bar_off = stat_off + kDkvStages * 2 * kDkvBQ * 4;
  // kv_full, then full and empty per stage
  static constexpr size_t total = bar_off + 8 * (1 + 2 * kDkvStages) + 1024;
};

// One block per (128-key tile, KV head, batch), the longest causal tiles
// first: the linear block index takes the key tile slowest, so key tile 0
// of every (head, batch) starts in the first wave.
//
// The producer warpgroup keeps setmaxnreg 24: its first warp issues the
// TMA loads (K and V once, then Q and dO per stage), its second warp copies
// lse * log2(e) and delta of the stage's 64 queries (0 past Tq). A stage is
// full after 1 + 32 arrivals and the TMA bytes, and empty after one arrival
// per consumer warp.
//
// Each consumer warpgroup owns 64 keys and, per (group head, query tile):
//   S^T = K Q^T and dP^T = V dO^T   (wgmma, K / V and Q / dO from shared
//                                    memory, both K-major)
//   P^T = 2^(S^T scale log2(e) - lse log2(e)), 0 above the diagonal
//   dS^T = P^T (dP^T - delta) scale
//   dV += P^T dO, dK += dS^T Q      (wgmma, P^T and dS^T rounded to bf16 in
//                                    registers as the A operand, dO and Q
//                                    read MN-major through the same tiles)
// Only the diagonal tile of a causal run tests positions. Rows past Tq have
// zero Q and dO and lse = delta = 0, so they add exactly 0; rows past Tk are
// computed and never stored. A tile whose queries all lie before the
// warpgroup's first key is skipped.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
                 const float* __restrict__ lse, const float* __restrict__ delta, int B, int Tq,
                 int Tk, int Hq, int Hkv, int causal, float scale) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + L::k_off, sV = base + L::v_off, sQ0 = base + L::q_off;
  float* stats = reinterpret_cast<float*>(smem_raw + (base - raw) + L::stat_off);
  const uint32_t kv_full = base + L::bar_off;
  const uint32_t full = kv_full + 8, empty = full + 8 * kDkvStages;  // + 8 * stage

  const int nhb = Hkv * B;
  const int kt = blockIdx.x / nhb, hk = blockIdx.x % nhb % Hkv, b = blockIdx.x % nhb / Hkv;
  const int k0 = kt * kDkvBK, group = Hq / Hkv;
  const int qstart = causal ? k0 : 0;  // queries before k0 see none of these keys
  const int ntq = qstart < Tq ? (Tq - qstart + kDkvBQ - 1) / kDkvBQ : 0;
  const int n_it = group * ntq;  // (group head, query tile) pairs, head slowest

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 8 && lane == 0 && n_it > 0) {
      mbar_expect_tx(kv_full, 2 * L::kv_bytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sK + c * kDkvBK * 128, &tm_k, kv_full, c * 64, hk, k0, b);
        tma_load_4d(sV + c * kDkvBK * 128, &tm_v, kv_full, c * 64, hk, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kDkvStages, h = hk * group + it / ntq;
        const int q0 = qstart + (it % ntq) * kDkvBQ;
        const uint32_t sq = sQ0 + s * 2 * L::tile_bytes, sdo = sq + L::tile_bytes;
        mbar_wait(empty + 8 * s, ((it / kDkvStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::tile_bytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sq + c * kDkvBQ * 128, &tm_q, full + 8 * s, c * 64, h, q0, b);
          tma_load_4d(sdo + c * kDkvBQ * 128, &tm_do, full + 8 * s, c * 64, h, q0, b);
        }
      }
    } else if (warp == 9) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kDkvStages, h = hk * group + it / ntq;
        const int q0 = qstart + (it % ntq) * kDkvBQ;
        float* st = stats + s * 2 * kDkvBQ;
        mbar_wait(empty + 8 * s, ((it / kDkvStages) & 1) ^ 1);
        for (int i = lane; i < kDkvBQ; i += 32) {
          const int t = q0 + i;
          const size_t row = ((size_t)b * Hq + h) * Tq + t;
          st[i] = t < Tq ? lse[row] * kLog2e : 0.f;
          st[kDkvBQ + i] = t < Tq ? delta[row] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
    const int wrow = (warp % 4) * 16 + g;       // this thread's keys: wrow, wrow + 8 of the 64
    const int kmin = k0 + wg * 64, key0 = kmin + wrow;
    const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;
    const float sl2 = scale * kLog2e;
    float dk[D / 2], dv[D / 2], sc[32], dp[32];
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (n_it > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kDkvStages, q0 = qstart + (it % ntq) * kDkvBQ;
      mbar_wait(full + 8 * s, (it / kDkvStages) & 1);
      if (!(causal && q0 + kDkvBQ - 1 < kmin)) {
        const uint32_t sq = sQ0 + s * 2 * L::tile_bytes, sdo = sq + L::tile_bytes;
        wg_fence();
        wgmma_abt<D, kDkvBQ, kDkvBK, kDkvBQ>(sc, sKw, sq);
        wgmma_abt<D, kDkvBQ, kDkvBK, kDkvBQ>(dp, sVw, sdo);
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // sc[i] and dp[i] belong to key key0 + 8 ((i >> 1) & 1) and query
        // q0 + 8 (i / 4) + 2 t4 + (i & 1).
        const float* st = stats + s * 2 * kDkvBQ;
        const bool need_mask = causal && kmin + 63 > q0;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t4);
          const float2 d2 = *reinterpret_cast<const float2*>(st + kDkvBQ + 8 * n + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e;
            float p = ex2(fmaf(sc[i], sl2, -((e & 1) ? l2.y : l2.x)));
            if (need_mask && key0 + 8 * ((e >> 1) & 1) > q0 + 8 * n + 2 * t4 + (e & 1)) p = 0.f;
            dp[i] = p * (dp[i] - ((e & 1) ? d2.y : d2.x)) * scale;
            sc[i] = p;
          }
        }
        pack_a(pa, sc);
        pack_a(da, dp);

        fence_regs(dk);
        fence_regs(dv);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 queries (2048 bytes of a tile) per k-step
          wgmma_rs<D>(dv, pa[kk], sw128_desc(sdo + kk * 2048, kDkvBQ * 128, 1024));
          wgmma_rs<D>(dk, da[kk], sw128_desc(sq + kk * 2048, kDkvBQ * 128, 1024));
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }

    // Epilogue: dK and dV in bf16 over this warpgroup's rows of the K and V
    // tiles (free once its last product is done), swizzled as TMA reads
    // them, then one TMA store per column block; rows past Tk are not written.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t off = (j / 8) * (kDkvBK * 128) + sw128_offset(row, j % 8) + 4 * t4;
        const uint32_t vk = pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        const uint32_t vv = pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sKw + off), "r"(vk) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sVw + off), "r"(vv) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync_wg(1 + wg);
    if (warp % 4 == 0 && lane == 0 && kmin < Tk) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_store_4d(&tm_dk, sKw + c * (kDkvBK * 128), c * 64, hk, kmin, b);
        tma_store_4d(&tm_dv, sVw + c * (kDkvBK * 128), c * 64, hk, kmin, b);
      }
      tma_store_commit_and_wait();
    }
  }
}

// --------------------------------------------- dQ: bfloat16, D = 64 / 128

constexpr int kDqBQ = 128;          // queries per block: 64 per consumer warpgroup
constexpr int kDqBK = 64;           // keys per streamed (K, V) tile
constexpr int kDqStages = 3;        // depth of the (K, V) ring
constexpr int kDqThreads = 3 * 128; // two consumer warpgroups + one producer warpgroup

// Shared memory, in bytes from a 1024-byte aligned base: Q and dO of the
// block (loaded once), then per stage a K and a V tile, each stored as D / 64
// column blocks of (rows x 64) bf16, 128-byte swizzled, one TMA box each.
template <int D>
struct DqSmem {
  static constexpr uint32_t q_bytes = kDqBQ * D * 2;   // Q or dO
  static constexpr uint32_t kv_bytes = kDqBK * D * 2;  // K or V of one stage
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = q_bytes;
  static constexpr uint32_t k_off = 2 * q_bytes;  // stage s: K at + 2 s kv_bytes, V after it
  static constexpr uint32_t bar_off = k_off + kDqStages * 2 * kv_bytes;
  // q_full, then full and empty per stage
  static constexpr size_t total = bar_off + 8 * (1 + 2 * kDqStages) + 1024;
};

// One block per (128-query tile, query head, batch), the longest causal
// tiles first: the linear block index takes the query tile slowest, in
// reverse, so the last query tile of every (head, batch) starts in the first
// wave; neighbouring blocks are the heads of one KV head, which read the
// same K and V tiles (L2 serves the group).
//
// The producer warpgroup keeps setmaxnreg 24: one thread loads Q and dO
// once and streams the K and V tiles through the ring. A stage is full
// when its TMA bytes have landed, and empty after one arrival per consumer
// warp.
//
// Each consumer warpgroup owns 64 queries; per key tile j:
//   S = Q K^T and dP = dO V^T      (wgmma, Q / dO and K / V from shared
//                                   memory, both K-major)
//   P = 2^(S scale log2(e) - lse log2(e)), 0 where masked
//   dS = P (dP scale - delta scale)
//   dQ += dS K                     (wgmma, dS rounded to bf16 in registers
//                                   as the A operand, K read MN-major)
// Tile j's S and dP are issued together with tile j-1's dQ product, so the
// scores of tile j are worked while that product runs. Only a tile that
// crosses the warpgroup's diagonal (causal) or Tk tests positions: TMA
// fills keys past Tk with 0, and a row whose scores all lie far below 0
// (lse ~ -120) would take P = e^120 = inf there, and inf * 0 = NaN in dQ, so
// those keys are masked and not left to the zeros. Rows past Tq compute
// with Q = dO = 0 and lse = delta = 0 (finite) and are never stored. A
// warpgroup stops after its last needed key tile and then only releases
// the stages the other one still uses.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
dq_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                const float* __restrict__ delta, int B, int Tq, int Tk, int Hq, int Hkv,
                int causal, float scale) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::q_off, sDO = base + L::do_off, sK0 = base + L::k_off;
  const uint32_t q_full = base + L::bar_off;
  const uint32_t full = q_full + 8, empty = full + 8 * kDqStages;  // + 8 * stage

  const int nhb = Hq * B, ntq = (Tq + kDqBQ - 1) / kDqBQ;
  const int qt = ntq - 1 - blockIdx.x / nhb, h = blockIdx.x % nhb % Hq,
            b = blockIdx.x % nhb / Hq;
  const int q0 = qt * kDqBQ, hk = h / (Hq / Hkv);
  // Keys the block needs: up to its last query when causal.
  const int kend = causal ? min(Tk, min(q0 + kDqBQ, Tq)) : Tk;
  const int ntiles = kend > 0 ? (kend + kDqBK - 1) / kDqBK : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, 2 * L::q_bytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sQ + c * kDqBQ * 128, &tm_q, q_full, c * 64, h, q0, b);
        tma_load_4d(sDO + c * kDqBQ * 128, &tm_do, q_full, c * 64, h, q0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kDqStages;
        const uint32_t sk = sK0 + s * 2 * L::kv_bytes, sv = sk + L::kv_bytes;
        mbar_wait(empty + 8 * s, ((it / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kv_bytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sk + c * kDqBK * 128, &tm_k, full + 8 * s, c * 64, hk, it * kDqBK, b);
          tma_load_4d(sv + c * kDqBK * 128, &tm_v, full + 8 * s, c * 64, hk, it * kDqBK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
    const int wrow = (warp % 4) * 16 + g;  // this thread's rows: wrow, wrow + 8 of the 64
    const int qlo = q0 + wg * 64, qrow = qlo + wrow;
    const uint32_t sQw = sQ + wg * 64 * 128, sDOw = sDO + wg * 64 * 128;
    const float sl2 = scale * kLog2e;
    // -lse log2(e) and -delta scale of this thread's two rows (0 past Tq).
    float nl[2], nd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = qrow + 8 * r;
      const size_t row = ((size_t)b * Hq + h) * Tq + t;
      nl[r] = t < Tq ? -lse[row] * kLog2e : 0.f;
      nd[r] = t < Tq ? -delta[row] * scale : 0.f;
    }
    // Key tiles this warpgroup needs; none when all its rows lie past Tq.
    const int kend_wg = qlo >= Tq ? 0 : causal ? min(Tk, min(qlo + 64, Tq)) : Tk;
    const int n = (kend_wg + kDqBK - 1) / kDqBK;
    float dq[D / 2], sc[32], dp[32];
    uint32_t da[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // sc[i] and dp[i] belong to row qrow + 8 ((i >> 1) & 1) and key
    // k0 + 8 (i / 4) + 2 t4 + (i & 1). Leaves dS in dp.
    auto scores = [&](int it) {
      const int k0 = it * kDqBK;
      if (k0 + kDqBK > Tk || (causal && k0 + kDqBK - 1 > qlo)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1, kpos = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          float p = ex2(fmaf(sc[i], sl2, nl[r]));
          if (kpos >= Tk || (causal && kpos > qrow + 8 * r)) p = 0.f;
          dp[i] = p * fmaf(dp[i], scale, nd[r]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          dp[i] = ex2(fmaf(sc[i], sl2, nl[r])) * fmaf(dp[i], scale, nd[r]);
        }
      }
    };
    auto stage_k = [&](int it) { return sK0 + (it % kDqStages) * 2 * L::kv_bytes; };

    mbar_wait(q_full, 0);
    if (n > 0) {
      mbar_wait(full, 0);
      wg_fence();
      wgmma_abt<D, kDqBK, kDqBQ, kDqBK>(sc, sQw, stage_k(0));
      wgmma_abt<D, kDqBK, kDqBQ, kDqBK>(dp, sDOw, stage_k(0) + L::kv_bytes);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      scores(0);
      pack_a(da, dp);
    }
    for (int it = 1; it < n; ++it) {
      const int s = it % kDqStages;
      mbar_wait(full + 8 * s, (it / kDqStages) & 1);
      fence_regs(dq);
      fence_regs(da);
      wg_fence();
      wgmma_abt<D, kDqBK, kDqBQ, kDqBK>(sc, sQw, stage_k(it));
      wgmma_abt<D, kDqBK, kDqBQ, kDqBK>(dp, sDOw, stage_k(it) + L::kv_bytes);
      wg_commit();
      wgmma_ab<D, kDqBK>(dq, da, stage_k(it - 1));
      wg_commit();
      wg_wait<1>();  // S and dP are done; dQ += dS K of tile it-1 may still run
      fence_regs(sc);
      fence_regs(dp);
      scores(it);
      wg_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kDqStages));  // tile it-1 is done
      pack_a(da, dp);
    }
    if (n > 0) {
      fence_regs(dq);
      fence_regs(da);
      wg_fence();
      wgmma_ab<D, kDqBK>(dq, da, stage_k(n - 1));
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((n - 1) % kDqStages));
    }
    // The tiles only the other warpgroup needs: wait for each (so no
    // arrival runs ahead into the stage's next phase) and release it.
    for (int it = n; it < ntiles; ++it) {
      const int s = it % kDqStages;
      mbar_wait(full + 8 * s, (it / kDqStages) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // Epilogue: dQ in bf16 over this warpgroup's rows of the Q tile (free
    // once its last S is done), swizzled as TMA reads them, then one TMA
    // store per column block; rows past Tq are not written.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t dst = sQw + (j / 8) * (kDqBQ * 128) + sw128_offset(row, j % 8) + 4 * t4;
        const uint32_t val = pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(val) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync_wg(1 + wg);
    if (warp % 4 == 0 && lane == 0 && qlo < Tq) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_4d(&tm_dq, sQw + c * (kDqBQ * 128), c * 64, h, qlo, b);
      tma_store_commit_and_wait();
    }
  }
}

// --------------------------------------------------------------- launch

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int Tq, int Tk, int Hq, int Hkv, int causal,
              float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
  using F = float;
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const F*>(q), static_cast<const F*>(k), static_cast<const F*>(v),
      static_cast<const F*>(dout), static_cast<const F*>(lse), static_cast<const F*>(delta),
      static_cast<F*>(dq), Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Tq, int Tk, int Hq, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + kBK - 1) / kBK, Hkv, B);
  using F = float;
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const F*>(q), static_cast<const F*>(k), static_cast<const F*>(v),
      static_cast<const F*>(dout), static_cast<const F*>(lse), static_cast<const F*>(delta),
      static_cast<F*>(dk), static_cast<F*>(dv), Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int Hq,
                  int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dq_kernel_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  dim3 grid((Tq + kMmaB - 1) / kMmaB, Hq, B);
  dq_kernel_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dq), Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
                   int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  dim3 grid((Tk + kMmaB - 1) / kMmaB, Hkv, B);
  dkv_kernel_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dk), static_cast<bf*>(dv), Tq, Tk, Hq,
      Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
                     int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<D>::total;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int rc = make_map(&tq, q, B, Tq, Hq, D, kDkvBQ);
  if (rc == 0) rc = make_map(&tdo, dout, B, Tq, Hq, D, kDkvBQ);
  if (rc == 0) rc = make_map(&tk, k, B, Tk, Hkv, D, kDkvBK);
  if (rc == 0) rc = make_map(&tv, v, B, Tk, Hkv, D, kDkvBK);
  if (rc == 0) rc = make_map(&tdk, dk, B, Tk, Hkv, D, 64);
  if (rc == 0) rc = make_map(&tdv, dv, B, Tk, Hkv, D, 64);
  if (rc != 0) return rc;
  const int grid = (Tk + kDkvBK - 1) / kDkvBK * Hkv * B;
  dkv_kernel_wgmma<D><<<grid, kDkvThreads, smem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B, Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int Hq,
                    int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = DqSmem<D>::total;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int rc = make_map(&tq, q, B, Tq, Hq, D, kDqBQ);
  if (rc == 0) rc = make_map(&tdo, dout, B, Tq, Hq, D, kDqBQ);
  if (rc == 0) rc = make_map(&tk, k, B, Tk, Hkv, D, kDqBK);
  if (rc == 0) rc = make_map(&tv, v, B, Tk, Hkv, D, kDqBK);
  if (rc == 0) rc = make_map(&tdq, dq, B, Tq, Hq, D, 64);
  if (rc != 0) return rc;
  const int grid = (Tq + kDqBQ - 1) / kDqBQ * Hq * B;
  dq_kernel_wgmma<D><<<grid, kDqThreads, smem, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse), static_cast<const float*>(delta), B,
      Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

using DqFn = int (*)(const void*, const void*, const void*, const void*, const void*,
                     const void*, void*, int, int, int, int, int, int, float, cudaStream_t);
using DkvFn = int (*)(const void*, const void*, const void*, const void*, const void*,
                      const void*, void*, void*, int, int, int, int, int, int, float,
                      cudaStream_t);

// float32 -> the scalar kernels; bfloat16 -> the tensor-core kernels: dQ and
// dK/dV on wgmma + TMA for D = 64 / 128 and on mma.sync for D = 16.
DqFn pick_dq(int dtype, int D) {
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_dq<16>;
      case 64: return launch_dq<64>;
      case 128: return launch_dq<128>;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_dq_mma<16>;
      case 64: return launch_dq_wgmma<64>;
      case 128: return launch_dq_wgmma<128>;
    }
  }
  return nullptr;
}

DkvFn pick_dkv(int dtype, int D) {
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_dkv<16>;
      case 64: return launch_dkv<64>;
      case 128: return launch_dkv<128>;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_dkv_mma<16>;
      case 64: return launch_dkv_wgmma<64>;
      case 128: return launch_dkv_wgmma<128>;
    }
  }
  return nullptr;
}

}  // namespace

// q, dout, dq (B,Tq,Hq,D); k, v (B,Tk,Hkv,D); all contiguous and of one type
// (dtype 0: float32, 1: bfloat16); lse and delta (B,Hq,Tq) float32. Each
// function launches one kernel and returns a cudaError_t, or -1 for an
// unsupported head dim or type.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, int B, int Tq, int Tk, int Hq, int Hkv, int D,
                                  int causal, float scale, int dtype, void* stream) {
  const DqFn f = pick_dq(dtype, D);
  if (f == nullptr) return -1;
  return f(q, k, v, dout, lse, delta, dq, B, Tq, Tk, Hq, Hkv, causal, scale,
           static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Tq, int Tk, int Hq, int Hkv,
                                   int D, int causal, float scale, int dtype, void* stream) {
  const DkvFn f = pick_dkv(dtype, D);
  if (f == nullptr) return -1;
  return f(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, Hq, Hkv, causal, scale,
           static_cast<cudaStream_t>(stream));
}
