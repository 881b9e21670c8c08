// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale over
// the last dim d of a row-major (rows, d) tensor.
//
// Replaces src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (TPU Pallas,
// pallas_call at rmsnorm.py:34). Same function: statistics in fp32, scale
// in fp32, y in x's type (float32 or bfloat16).
//
// What differs from the TPU kernel:
// - The TPU tiled rows into blocks of 256 and padded the last block with a
//   copy; here a group of lanes owns one row and a ragged last block is
//   masked.
// - Any d: a row that does not start on a 16-byte boundary (d not a multiple
//   of the vector) reads its first and last few elements one by one.
//
// What bounds it: a few operations per element, so the bytes of reading x
// once and writing y once. The design moves each byte once at full width:
// - 16-byte vector loads and stores, neighbouring lanes on neighbouring
//   vectors;
// - the whole row in registers between the sum and the store, packed as it
//   was loaded: LANES lanes per row (a template parameter: 16 for d = 128
//   in bf16, 256 for d = 2048, ...), VPL vectors per lane, so a lane holds
//   few values and many warps fit on an SM;
// - two rows per lane group where a lane holds few vectors, so each lane
//   keeps several 16-byte loads in flight (measured in a full prefill
//   against one and four rows per group);
// - the sum of squares reduced with warp shuffles inside the lane group,
//   and across the warps of a row (LANES > 32) through shared memory;
// - the lane's slice of scale read once, for all its rows, into registers
//   while the row loads are in flight, so the store phase waits on no
//   second trip to memory (the decode step's 8-row calls are latency, not
//   bytes);
// - 256-thread blocks of 256 / LANES * R rows, so both the (8192, 2048) and
//   the (8192 * 16, 128) calls of the serve path give every SM many blocks.
// Rows longer than 8192 bf16 or 4096 fp32 values go to
// rmsnorm_kernel_long, one warp per row and two passes over x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void to_float(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_float(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ uint4 from_float(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 from_float(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
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

// R rows per LANES lanes; lane l holds vectors l, l + LANES, ... of each
// row's 16-byte aligned body as loaded (packed), and element l of its
// unaligned head and tail. A row of more than 32 lanes adds its warps' sums
// through shared memory. ALIGNED (d a multiple of the vector, as on every
// path) compiles the head and tail away, and the lane's slice of scale is
// then the same for its R rows: it is loaded once, beside the rows.
template <typename T, int LANES, int VPL, int R, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               long long rows, int d, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements per vector
  const int lane = threadIdx.x % LANES;
  const long long row_a = ((long long)blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES) * R;
  uint4 raw[R][VPL];
  float hv[R], tv[R], rs[R];
  int head[R], nbody[R], tail[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const bool valid = row_a + j < rows;
    const size_t r0 = (size_t)(valid ? row_a + j : 0) * d;
    // x and y share their alignment (the wrapper asks both to be 16-byte aligned).
    const int mis = ALIGNED ? 0 : (int)((reinterpret_cast<uintptr_t>(x + r0) % 16) / sizeof(T));
    head[j] = min(mis ? E - mis : 0, d);
    nbody[j] = valid ? (d - head[j]) / E : 0;
    tail[j] = valid && !ALIGNED ? d - head[j] - nbody[j] * E : 0;
    const uint4* xv = reinterpret_cast<const uint4*>(x + r0 + head[j]);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + i * LANES;
      if (vi < nbody[j]) raw[j][i] = __ldg(xv + vi);
    }
    hv[j] = !ALIGNED && valid && lane < head[j] ? to_f(x[r0 + lane]) : 0.f;
    tv[j] = !ALIGNED && lane < tail[j] ? to_f(x[r0 + head[j] + nbody[j] * E + lane]) : 0.f;
  }
  float sc[VPL][E];  // this lane's scale (ALIGNED), loaded while the rows are in flight
  if (ALIGNED) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = (lane + i * LANES) * E;
      if (c < d) {
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + c + e));
          sc[i][e] = s4.x;
          sc[i][e + 1] = s4.y;
          sc[i][e + 2] = s4.z;
          sc[i][e + 3] = s4.w;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float ss = ALIGNED ? 0.f : fmaf(hv[j], hv[j], tv[j] * tv[j]);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + i * LANES < nbody[j]) {
        float f[E];
        to_float(raw[j][i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
#pragma unroll
    for (int o = (LANES < 32 ? LANES : 32) / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    rs[j] = ss;
  }
  if (LANES > 32) {  // a row spans LANES / 32 warps: add their sums
    __shared__ float part[R][kThreads / 32];
    const int warp = threadIdx.x / 32, w0 = warp / (LANES / 32) * (LANES / 32);
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) part[j][warp] = rs[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < LANES / 32; ++w) t += part[j][w0 + w];
      rs[j] = t;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (row_a + j >= rows) break;
    const size_t r0 = (size_t)(row_a + j) * d;
    const float r = rsqrtf(rs[j] / (float)d + eps);
    uint4* yv = reinterpret_cast<uint4*>(y + r0 + head[j]);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + i * LANES;
      if (vi < nbody[j]) {
        float f[E];
        to_float(raw[j][i], f);
#pragma unroll
        for (int e = 0; e < E; ++e)
          f[e] = f[e] * r * (ALIGNED ? sc[i][e] : scale[head[j] + vi * E + e]);
        yv[vi] = from_float(f);
      }
    }
    if (ALIGNED) continue;
    if (lane < head[j]) y[r0 + lane] = from_f<T>(hv[j] * r * scale[lane]);
    if (lane < tail[j]) {
      const int c = head[j] + nbody[j] * E + lane;
      y[r0 + c] = from_f<T>(tv[j] * r * scale[c]);
    }
  }
}

// Rows too long to hold in registers: one warp per row, element by element,
// reading x twice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel_long(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + (size_t)row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float f = to_f(xr[c]);
    ss = fmaf(f, f, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = y + (size_t)row * d;
  for (int c = lane; c < d; c += 32) yr[c] = from_f<T>(to_f(xr[c]) * r * scale[c]);
}

using LaunchFn = void (*)(const void*, const float*, void*, long long, int, float, cudaStream_t);

// Rows per lane group: two, or one where a lane holds 8 or more vectors.
template <typename T, int LANES, int VPL>
void launch(const void* x, const float* scale, void* y, long long rows, int d, float eps,
            cudaStream_t stream) {
  constexpr int R = VPL >= 8 ? 1 : 2;
  constexpr int per_block = kThreads / LANES * R;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (d % (16 / sizeof(T)) == 0)
    rmsnorm_kernel<T, LANES, VPL, R, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), rows, d, eps);
  else
    rmsnorm_kernel<T, LANES, VPL, R, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), rows, d, eps);
}

template <typename T>
void launch_long(const void* x, const float* scale, void* y, long long rows, int d, float eps,
                 cudaStream_t stream) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  rmsnorm_kernel_long<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(y), rows, d, eps);
}

template <typename T>
LaunchFn pick_typed(int d) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = (d + E - 1) / E;
  if (nvec <= 32) {  // one vector per lane, at least E - 1 lanes for an unaligned head or tail
    const int lanes = nvec <= 4 && d % E == 0 ? 4 : nvec <= 8 ? 8 : nvec <= 16 ? 16 : 32;
    switch (lanes) {
      case 4: return launch<T, 4, 1>;
      case 8: return launch<T, 8, 1>;
      case 16: return launch<T, 16, 1>;
      default: return launch<T, 32, 1>;
    }
  }
  if (nvec <= 64) return launch<T, 64, 1>;
  if (nvec <= 128) return launch<T, 128, 1>;
  if (nvec <= 256) return launch<T, 256, 1>;  // d = 2048 in bf16: the block is 4 rows
  if (nvec <= 512) return launch<T, 256, 2>;  // d = 2048 in fp32
  if (nvec <= 1024) return launch<T, 256, 4>;
  return launch_long<T>;
}

}  // namespace

// x and y (rows, d) contiguous, 16-byte aligned, of one type (dtype 0:
// float32, 1: bfloat16); scale (d,) float32. Launches one kernel on the
// stream. Returns a cudaError_t, or -1 for an unsupported type or size.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, long long rows, int d,
                           float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return -1;
  LaunchFn f = dtype == 0 ? pick_typed<float>(d) : dtype == 1 ? pick_typed<__nv_bfloat16>(d)
                                                              : nullptr;
  if (f == nullptr) return -1;
  f(x, static_cast<const float*>(scale), y, rows, d, eps, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
