// AdamW's update of one leaf for Hopper (sm_90a), in place and gated by the
// step's commit: the new m, v, fp32 master weights (where kept) and the
// parameter, written in one pass over the leaf, and nothing written where
// the step did not commit.
//
// Replaces no TPU kernel: repro's AdamW (src/repro/optim/adamw.py) is plain
// jnp, which XLA fuses into one loop a leaf. The port's eager version ran
// ~18 elementwise kernels a leaf, and the commit gate one select and one
// copy for each of p, m, v and master: each pass wrote a leaf-sized fp32
// temporary, ~238 bytes moved a bf16 parameter. This pass moves 28 (reads
// g, m, v and master, writes m, v, master and p); it was added for those
// bytes.
//
// Same arithmetic as the plain version (kernels/ref.py::adamw), op for op
// and in its order, so the card's result equals the eager CUDA path's bit
// for bit:
//   g = g * scale;  m = m * b1 + g * (1 - b1);  v = v * b2 + (g * g) * (1 - b2)
//   upd = (m / b1c) / (sqrt(v / b2c) + eps) + p * wd;  p = p - upd * lr
// then p rounded to its type. Every operation is an IEEE round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, ...), which -O3 does not contract into
// an FMA. The Python constants (b1, 1 - b1, ...) arrive rounded once to
// fp32, as torch rounds a Python scalar; the step's scalars (the clip
// scale, lr, the bias corrections b1c and b2c, committed) are read from
// device memory, where the train step computed them: no host read.
//
// What bounds it: bytes. Each thread takes 8 elements at a time (one
// 16-byte load of bf16 g or two of fp32 g; two each of m, v and master; the
// same for a parameter read without master weights), UNROLL such vectors in
// flight before any arithmetic, with streaming cache hints (__ldcs /
// __stcs: nothing is read twice), over a grid-stride loop sized to the
// blocks the SMs hold at once. The ragged tail (n not a multiple of 8) and
// leaves whose pointers are not 16-byte aligned (a shard at an odd offset)
// take the same body one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

struct Consts {  // the Python constants, each rounded once to fp32
  float b1, omb1, b2, omb2, eps, wd;
};

struct Step {  // the step's scalars in device memory
  const float* scale;
  const float* lr;
  const float* b1c;
  const float* b2c;
  const unsigned char* committed;
};

struct Scalars {
  float scale, lr, b1c, b2c;
};

__device__ __forceinline__ void adamw_one(float g, float& m, float& v, float& p,
                                          const Consts& c, const Scalars& s) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.omb1));
  const float sq = __fmul_rn(__fmul_rn(g, g), c.omb2);
  v = __fadd_rn(__fmul_rn(v, c.b2), sq);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), c.eps);
  float upd = __fdiv_rn(__fdiv_rn(m, s.b1c), den);
  upd = __fadd_rn(upd, __fmul_rn(p, c.wd));
  p = __fsub_rn(p, __fmul_rn(upd, s.lr));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 elements from vector i (16-byte aligned), widened to fp32.
__device__ __forceinline__ void load8(const float* x, long long i, float (&f)[8]) {
  const float4* q = reinterpret_cast<const float4*>(x) + 2 * i;
  const float4 a = __ldcs(q), b = __ldcs(q + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* x, long long i, float (&f)[8]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(x) + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}
__device__ __forceinline__ void store8(float* x, long long i, const float (&f)[8]) {
  float4* q = reinterpret_cast<float4*>(x) + 2 * i;
  __stcs(q, make_float4(f[0], f[1], f[2], f[3]));
  __stcs(q + 1, make_float4(f[4], f[5], f[6], f[7]));
}
__device__ __forceinline__ void store8(__nv_bfloat16* x, long long i, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16_rn(f[k]);
  __stcs(reinterpret_cast<uint4*>(x) + i, u);
}

__device__ __forceinline__ Scalars read_step(const Step& st) {
  return Scalars{*st.scale, *st.lr, *st.b1c, *st.b2c};
}

// Element e alone: the ragged tail and every element of a misaligned leaf.
template <typename T, bool MASTER>
__device__ __forceinline__ void scalar_elem(const T* g, float* m, float* v, float* master, T* p,
                                            long long e, const Consts& c, const Scalars& s) {
  float mm = m[e], vv = v[e], pp = MASTER ? master[e] : to_f(p[e]);
  adamw_one(to_f(g[e]), mm, vv, pp, c, s);
  m[e] = mm;
  v[e] = vv;
  if (MASTER) master[e] = pp;
  p[e] = from_f<T>(pp);
}

// Every pointer 16-byte aligned: 8 elements a vector, kUnroll vectors a
// thread in flight, then the tail of n % 8 elements one by one.
template <typename T, bool MASTER>
__global__ void __launch_bounds__(kThreads)
adamw_vec(const T* __restrict__ g, float* __restrict__ m, float* __restrict__ v,
          float* __restrict__ master, T* __restrict__ p, long long n, Consts c, Step st) {
  if (!*st.committed) return;
  const Scalars s = read_step(st);
  const long long nvec = n / 8;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    float fg[kUnroll][8], fm[kUnroll][8], fv[kUnroll][8], fp[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      load8(g, j, fg[u]);
      load8(m, j, fm[u]);
      load8(v, j, fv[u]);
      if (MASTER) load8(master, j, fp[u]);
      else load8(p, j, fp[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) adamw_one(fg[u][k], fm[u][k], fv[u][k], fp[u][k], c, s);
      const long long j = i + u * stride;
      store8(m, j, fm[u]);
      store8(v, j, fv[u]);
      if (MASTER) store8(master, j, fp[u]);
      store8(p, j, fp[u]);
    }
  }
  for (; i < nvec; i += stride) {
    float fg[8], fm[8], fv[8], fp[8];
    load8(g, i, fg);
    load8(m, i, fm);
    load8(v, i, fv);
    if (MASTER) load8(master, i, fp);
    else load8(p, i, fp);
#pragma unroll
    for (int k = 0; k < 8; ++k) adamw_one(fg[k], fm[k], fv[k], fp[k], c, s);
    store8(m, i, fm);
    store8(v, i, fv);
    if (MASTER) store8(master, i, fp);
    store8(p, i, fp);
  }
  const long long e = nvec * 8 + (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < n) scalar_elem<T, MASTER>(g, m, v, master, p, e, c, s);
}

// Some pointer not 16-byte aligned: the same body, one element a thread.
template <typename T, bool MASTER>
__global__ void __launch_bounds__(kThreads)
adamw_scalar(const T* __restrict__ g, float* __restrict__ m, float* __restrict__ v,
             float* __restrict__ master, T* __restrict__ p, long long n, Consts c, Step st) {
  if (!*st.committed) return;
  const Scalars s = read_step(st);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride)
    scalar_elem<T, MASTER>(g, m, v, master, p, e, c, s);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Blocks the SMs hold at once for kernel k (asked once per kernel).
template <typename K>
int resident_blocks(K k, int& cached) {
  if (cached == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    cached = per_sm * sm_count();
  }
  return cached;
}

template <typename T, bool MASTER>
int launch(const void* g, void* m, void* v, void* master, void* p, long long n, bool aligned,
           const Consts& c, const Step& st, cudaStream_t stream) {
  static int vec_blocks = 0, scalar_blocks = 0;
  const T* gg = static_cast<const T*>(g);
  float *mm = static_cast<float*>(m), *vv = static_cast<float*>(v);
  float* ms = static_cast<float*>(master);
  T* pp = static_cast<T*>(p);
  if (aligned) {
    auto k = adamw_vec<T, MASTER>;
    const long long want = (n / 8 + kThreads - 1) / kThreads;
    const long long tail = (n % 8 + kThreads - 1) / kThreads;  // 0 or 1
    long long blocks = want > tail ? want : tail;
    const long long most = resident_blocks(k, vec_blocks);
    blocks = blocks < most ? blocks : most;
    k<<<(unsigned)blocks, kThreads, 0, stream>>>(gg, mm, vv, ms, pp, n, c, st);
  } else {
    auto k = adamw_scalar<T, MASTER>;
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long most = resident_blocks(k, scalar_blocks);
    blocks = blocks < most ? blocks : most;
    k<<<(unsigned)blocks, kThreads, 0, stream>>>(gg, mm, vv, ms, pp, n, c, st);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* g, void* m, void* v, void* master, void* p, long long n,
                 bool aligned, const Consts& c, const Step& st, cudaStream_t stream) {
  return master != nullptr ? launch<T, true>(g, m, v, master, p, n, aligned, c, st, stream)
                           : launch<T, false>(g, m, v, master, p, n, aligned, c, st, stream);
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// One leaf of n elements, in place: g and p of one type (dtype 0 float32,
// 1 bfloat16), m and v float32, master float32 or null where the state
// keeps none (p is then read and widened). scale, lr, b1c and b2c point to
// one float32 each and committed to one bool (byte) in device memory.
// Launches one kernel on the stream and allocates nothing. Returns a
// cudaError_t, or -1 for an unsupported type or size.
extern "C" int adamw_update(const void* g, void* m, void* v, void* master, void* p,
                            long long n, int dtype, const void* scale, const void* lr,
                            const void* b1c, const void* b2c, const void* committed, float b1,
                            float omb1, float b2, float omb2, float eps, float wd,
                            void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 1) return -1;
  const Consts c{b1, omb1, b2, omb2, eps, wd};
  const Step st{static_cast<const float*>(scale), static_cast<const float*>(lr),
                static_cast<const float*>(b1c), static_cast<const float*>(b2c),
                static_cast<const unsigned char*>(committed)};
  const bool aligned = aligned16(g) && aligned16(m) && aligned16(v) && aligned16(p) &&
                       (master == nullptr || aligned16(master));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_typed<float>(g, m, v, master, p, n, aligned, c, st, s)
             : launch_typed<__nv_bfloat16>(g, m, v, master, p, n, aligned, c, st, s);
}
