// Mamba's selective scan for Hopper (sm_90a), with no gradient: for every
// row b and channel c of x (B, T, d_in), over all T tokens from the carried
// state h (B, d_in, N) fp32,
//
//   delta_t = softplus(dt_t + dt_bias)            (fp32; linear above 20)
//   h_t     = exp(delta_t A) h_{t-1} + (delta_t x_t) B_t     A = -exp(A_log)
//   y_t     = bf16(h_t . C_t + x_t D) * silu(z_t)   (in x's type)
//
// and the new h. It takes dt_proj's output (dt), x after the conv and SiLU,
// B and C after the inner norms, each in the model's type, and A_log,
// dt_bias and D in fp32.
//
// Replaces no TPU kernel: repro scans with jax.lax.associative_scan, which
// XLA compiles. The port's plain version (kernels/ref.py::selective_scan,
// a chunked Hillis-Steele doubling scan) materialises a and b x as
// (B, c, d_in, N) fp32 tensors and rebuilds them with a cat in each of its
// log2(c) passes: at jamba's prefill (2 x 8,192 tokens, d_in 8,192, N 16)
// ~0.8 TB moved a layer, ~394 ms. Here nothing of size (B, T, d_in, N), and
// no fp32 copy of delta or x, touches device memory: each input is read
// once and y and h written once (~1.08 GB, ~0.32 ms at 3.35 TB/s).
//
// Same roundings as the plain version where it rounds: delta and the
// products delta x, x D in fp32 as PyTorch computes them (expf, log1pf,
// IEEE division: -O3 without fast math), y + x D rounded to the model's
// type, silu(z) rounded to it, their product rounded once. The sum over
// the N states and the recurrence run in another order than the doubling
// scan: token after token, as bench/reference/hybrid.py's float32 scan.
// exp(delta A) is ex2.approx of delta (A log2 e): ~2 ulp.
//
// What bounds it: at jamba's prefill the bytes (~0.32 ms) and the exp of
// every (token, channel, state), ~2.1 G: ~0.5 ms on the SFU alone (16 a
// clock an SM), less where part of them is a polynomial on the FMA pipes
// (FlashAttention-3 splits its exps so; this kernel does not), so the
// bytes are the floor. The recurrence is sequential in T, so the design
// spreads the rest:
// - a block runs kChannels (32) channels of one row over all T tokens;
//   kLanes (4) lanes share a channel, each holding SPT of its N states in
//   registers (N padded to 4 x SPT with states that stay 0; SPT 2 or 4,
//   so N <= 16: jamba's 16, its reduced configuration's 4). jamba's
//   prefill gives B x d_in / 32 = 512 blocks of 128 threads, ~4 an SM.
//   The lanes trade warps in flight against work done once a lane and
//   token: at jamba's prefill 8 lanes of 2 states took 1.87 ms against
//   1.66 for 4 of 4, and in a first design (a token's y summed by
//   shuffles) 2 lanes of 8 took 2.53 ms against 2.16 (H100 SXM);
// - per token and state a lane issues 5 instructions, one of them the exp:
//   the loop over a tile's tokens reads (delta, delta x) and its states' B
//   and C from shared memory in 8- and 16-byte loads and writes its partial
//   sum of y there, one store a token;
// - the block stages kTile (32) tokens at a time: dt, x and z into delta
//   and delta x in shared memory, computed once a (token, channel) and not
//   once a state, and x D and silu(z) in the registers of the thread that
//   later sums the token's partials and writes its y (coalesced); B and C
//   are shared by the block's 32 channels;
// - the next tile's loads are issued into registers before the current
//   tile's recurrence runs, so the loads overlap the exps; loads are one
//   element a lane, neighbouring lanes on neighbouring channels (64 or 128
//   bytes a warp), so any row and token stride works (z is a view of
//   in_proj's [x | z], B and C may be views of x_proj's [dt | B | C]);
// - a ragged last tile and channels past d_in read as delta = 0 and
//   delta x = 0, which leave h as it was: the recurrence needs no bound.
// T is not split into chunks with a carry pass: that would compute every
// exp twice, and the shapes of the serve path give enough blocks (a
// decode step's T = 1 is one tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;  // channels a block runs
constexpr int kTile = 32;      // tokens a block stages at a time
constexpr int kLanes = 4;      // lanes a channel
constexpr int kThreads = kChannels * kLanes;
constexpr float kLog2e = 1.4426950408889634f;

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
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Args {
  const void* dt;       // (B, T, d) model type, dt_proj's output
  const float* dt_bias; // (d,)
  const void* x;        // (B, T, d) model type
  const float* A_log;   // (d, N)
  const void* Bm;       // (B, T, N) model type
  const void* Cm;       // (B, T, N) model type
  const float* D;       // (d,)
  const void* z;        // (B, T, d) model type
  const float* h0;      // (B, d, N) or null: the zero state
  void* y;              // (B, T, d) model type, contiguous
  float* h;             // (B, d, N), contiguous
  int rows, T, d, N;
  // (row, token) strides in elements; channels and states are contiguous.
  long long dt_b, dt_t, x_b, x_t, z_b, z_t, B_b, B_t, C_b, C_t;
};

// K consecutive floats of shared memory, in 16- or 8-byte loads.
template <int K>
__device__ __forceinline__ void load_states(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int s = 0; s < K; s += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + s);
      v[s] = q.x, v[s + 1] = q.y, v[s + 2] = q.z, v[s + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < K; s += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + s);
      v[s] = q.x, v[s + 1] = q.y;
    }
  }
}

// At most 128 registers a thread: four blocks an SM.
template <typename T, int SPT>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_kernel(const Args a) {
  constexpr int NP = kLanes * SPT;                  // states, padded
  constexpr int PE = kTile * kChannels / kThreads;  // (token, channel) elements a thread stages
  __shared__ float2 s_dd[kTile][kChannels];                     // (delta, delta x)
  __shared__ __align__(16) float s_B[kTile][NP];
  __shared__ __align__(16) float s_C[kTile][NP];
  __shared__ __align__(16) float s_part[kTile][kChannels][kLanes];  // y's partial sums

  const int tid = threadIdx.x;
  const int tiles_d = (a.d + kChannels - 1) / kChannels;
  const long long row = blockIdx.x / tiles_d;
  const int c0 = (blockIdx.x % tiles_d) * kChannels;

  // The recurrence: channel cl of the block, states j SPT .. j SPT + SPT - 1.
  const int cl = tid / kLanes, j = tid % kLanes;
  const int ch = c0 + cl;
  float A2[SPT], h[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int n = j * SPT + s;
    const bool ok = ch < a.d && n < a.N;
    A2[s] = ok ? -expf(a.A_log[(long long)ch * a.N + n]) * kLog2e : 0.f;
    h[s] = ok && a.h0 != nullptr ? a.h0[(row * a.d + ch) * a.N + n] : 0.f;
  }

  // Staging and output: channel lc of the block, tokens tid / 32 + i kLanes
  // of a tile. A thread writes the y of the elements it staged, so x D and
  // silu(z) stay in its registers from one to the other.
  const int lc = c0 + tid % kChannels, lt = tid / kChannels;
  const bool lc_ok = lc < a.d;
  const T* dt = static_cast<const T*>(a.dt) + row * a.dt_b + lc;
  const T* x = static_cast<const T*>(a.x) + row * a.x_b + lc;
  const T* z = static_cast<const T*>(a.z) + row * a.z_b + lc;
  const T* Bm = static_cast<const T*>(a.Bm) + row * a.B_b;
  const T* Cm = static_cast<const T*>(a.Cm) + row * a.C_b;
  T* y = static_cast<T*>(a.y) + row * a.T * a.d + lc;
  const float bias = lc_ok ? a.dt_bias[lc] : 0.f;
  const float Dl = lc_ok ? a.D[lc] : 0.f;
  const T zero = from_f<T>(0.f);
  T r_dt[PE], r_x[PE], r_z[PE], r_B[SPT], r_C[SPT];  // the next tile, in flight
  float xd[PE], sz[PE];

  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      const int t = t0 + i * kLanes + lt;
      const bool ok = lc_ok && t < a.T;
      r_dt[i] = ok ? dt[t * a.dt_t] : zero;
      r_x[i] = ok ? x[t * a.x_t] : zero;
      r_z[i] = ok ? z[t * a.z_t] : zero;
    }
#pragma unroll
    for (int i = 0; i < SPT; ++i) {  // kTile x NP values over kThreads = kTile x NP / SPT
      const int e = i * kThreads + tid;
      const int t = t0 + e / NP, n = e % NP;
      const bool ok = n < a.N && t < a.T;
      r_B[i] = ok ? Bm[t * a.B_t + n] : zero;
      r_C[i] = ok ? Cm[t * a.C_t + n] : zero;
    }
  };

  auto stage = [&](int t0) {
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      const int tt = i * kLanes + lt;
      const bool ok = lc_ok && t0 + tt < a.T;
      const float v = __fadd_rn(to_f(r_dt[i]), bias);
      const float delta = ok ? (v > 20.f ? v : log1pf(expf(v))) : 0.f;
      const float xv = to_f(r_x[i]), zv = to_f(r_z[i]);
      s_dd[tt][tid % kChannels] = make_float2(delta, __fmul_rn(delta, xv));
      xd[i] = __fmul_rn(xv, Dl);
      sz[i] = round_to<T>(__fdiv_rn(zv, __fadd_rn(1.f, expf(-zv))));
    }
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int e = i * kThreads + tid;
      s_B[e / NP][e % NP] = to_f(r_B[i]);
      s_C[e / NP][e % NP] = to_f(r_C[i]);
    }
  };

  auto scan = [&]() {
#pragma unroll 4
    for (int tt = 0; tt < kTile; ++tt) {
      const float2 dd = s_dd[tt][cl];
      float Bv[SPT], Cv[SPT];
      load_states(&s_B[tt][j * SPT], Bv);
      load_states(&s_C[tt][j * SPT], Cv);
      float yv = 0.f;
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        const float an = ex2(__fmul_rn(dd.x, A2[s]));
        h[s] = fmaf(an, h[s], __fmul_rn(dd.y, Bv[s]));
        yv = fmaf(h[s], Cv[s], yv);
      }
      s_part[tt][cl][j] = yv;
    }
  };

  auto store = [&](int t0) {
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      const int tt = i * kLanes + lt;
      float p[kLanes];
      load_states(&s_part[tt][tid % kChannels][0], p);
      float yv = p[0];
#pragma unroll
      for (int k = 1; k < kLanes; ++k) yv = __fadd_rn(yv, p[k]);
      const float o = round_to<T>(__fadd_rn(yv, xd[i]));
      if (lc_ok && t0 + tt < a.T) y[(long long)(t0 + tt) * a.d] = from_f<T>(__fmul_rn(o, sz[i]));
    }
  };

  load(0);
  for (int t0 = 0; t0 < a.T; t0 += kTile) {
    stage(t0);
    __syncthreads();
    if (t0 + kTile < a.T) load(t0 + kTile);  // in flight while this tile's exps run
    scan();
    __syncthreads();
    store(t0);  // reads partials that the next scan writes only after the next barrier
  }

#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int n = j * SPT + s;
    if (ch < a.d && n < a.N) a.h[(row * a.d + ch) * a.N + n] = h[s];
  }
}

template <typename T, int SPT>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (long long)a.rows * ((a.d + kChannels - 1) / kChannels);
  selective_scan_kernel<T, SPT><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const Args& a, cudaStream_t s) {
  return a.N <= 8 ? launch<T, 2>(a, s) : launch<T, 4>(a, s);
}

}  // namespace

// One scan over rows x T tokens x d channels x N <= 16 states (dtype 0
// float32, 1 bfloat16 for dt, x, z, B, C and y; the rest float32). h0 may be
// null (the zero state). Launches one kernel on the stream and allocates
// nothing. Returns a cudaError_t, or -1 for an unsupported type or size.
extern "C" int selective_scan(const void* dt, const float* dt_bias, const void* x,
                              const float* A_log, const void* Bm, const void* Cm,
                              const float* D, const void* z, const float* h0, void* y, float* h,
                              int rows, int T, int d, int N, long long dt_b, long long dt_t,
                              long long x_b, long long x_t, long long z_b, long long z_t,
                              long long B_b, long long B_t, long long C_b, long long C_t,
                              int dtype, void* stream) {
  if (rows <= 0 || T <= 0 || d <= 0 || N <= 0 || N > 16 || dtype < 0 || dtype > 1) return -1;
  const Args a{dt, dt_bias, x, A_log, Bm, Cm, D, z, h0, y, h, rows, T, d, N,
               dt_b, dt_t, x_b, x_t, z_b, z_t, B_b, B_t, C_b, C_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_typed<float>(a, s) : launch_typed<__nv_bfloat16>(a, s);
}
