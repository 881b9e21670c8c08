// Causal / non-causal flash attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (TPU Pallas,
// pallas_call at flash_attention.py:87). Same function: softmax(q k^T * scale)
// v with an online softmax over key tiles, (m, l, acc) in fp32, masked scores
// at NEG_INF = -1e30, o in the input type and lse = m + log(l) in fp32.
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
//   tiles wholly above the diagonal or past kv_len are never loaded.
//
// What bounds it: at the prompt lengths of the serve path (T = 1024, D = 128)
// attention is far above the card's ops-per-byte line, so it is bound by
// operations, i.e. by the tensor cores. Two kernels, chosen by input type:
// - bfloat16 (the serve path): fwd_kernel_mma. Four warps, each owning 16
//   query rows, multiply on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate). Q fragments stay in registers for the whole key loop;
//   the S = Q K^T accumulator is reused in registers as the A operand of
//   P V (P rounded to bf16, as FlashAttention-2 does); V fragments come from
//   row-major shared memory through ldmatrix.trans. Rows of shared memory are
//   padded by 16 bytes so the fragment loads hit distinct banks. Not yet
//   done: wgmma, TMA and double-buffered tile loads (later work).
// - float32 (parity checks): fwd_kernel, scalar fp32 FMAs on the CUDA cores
//   with the tiles converted to fp32 in shared memory, so the result differs
//   from an fp32 reference only in the order of sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
           const int* __restrict__ kv_len, int Tq, int Tk, int Hq, int Hkv, int causal,
           float scale) {
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
  const int off = q_offset[b];
  const int klen = min(kv_len[b], Tk);

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

// ---------------------------------------------------------------- bf16 path

constexpr int kMmaBQ = 64;  // query rows per block: 16 per warp
constexpr int kMmaBK = 64;  // keys per tile

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
               const int* __restrict__ kv_len, int Tq, int Tk, int Hq, int Hkv, int causal,
               float scale) {
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
  const int off = q_offset[b];
  const int klen = min(kv_len[b], Tk);

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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
               const void* q_offset, const void* kv_len, int B, int Tq, int Tk, int Hq,
               int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kMmaBQ - 1) / kMmaBQ, Hq, B);
  fwd_kernel_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- dispatch

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* q_offset, const void* kv_len, int B, int Tq, int Tk, int Hq,
           int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), Tq, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, void*, const void*,
                         const void*, int, int, int, int, int, int, float, cudaStream_t);

// float32 -> the scalar kernel, bfloat16 -> the tensor-core kernel.
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
      case 64: return launch_mma<64>;
      case 128: return launch_mma<128>;
    }
  }
  return nullptr;
}

}  // namespace

// q (B,Tq,Hq,D), k and v (B,Tk,Hkv,D), o (B,Tq,Hq,D), all contiguous and of
// one type (dtype 0: float32, 1: bfloat16); lse (B,Hq,Tq) float32;
// q_offset and kv_len (B,) int32. Returns a cudaError_t, or -1 for an
// unsupported head dim or type.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const void* q_offset, const void* kv_len,
                                   int B, int Tq, int Tk, int Hq, int Hkv, int D,
                                   int causal, float scale, int dtype, void* stream) {
  const LaunchFn f = pick(dtype, D);
  if (f == nullptr) return -1;
  return f(q, k, v, o, lse, q_offset, kv_len, B, Tq, Tk, Hq, Hkv, causal, scale,
           static_cast<cudaStream_t>(stream));
}
