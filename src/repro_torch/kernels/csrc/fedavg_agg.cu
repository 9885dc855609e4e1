// Fused (staleness-)weighted federated averaging over packed f32 rows.
//
// Replaces the TPU kernels in repro/kernels/fedavg_agg.py:
//   fedavg_agg_flat (_agg_kernel)  ->  fedavg_agg_launch:  out = w @ rows
//   fedavg_mix_flat (_mix_kernel)  ->  fedavg_mix_launch:
//       out = w[0] * server + w[1:] @ rows   (fedavg_delta_flat is w[0] = 1)
//
// Bound on the card: bytes.  Each output element reads W row values (plus
// one server value for the mix) and writes one value, with 2W flops, far
// below the H100's ~20 flops per byte; (W+1)*N*4 bytes read and N*4 written
// is the floor.  Both stream every row exactly once, one output element
// (one float4 when N % 4 == 0: 16-byte loads and stores, neighbouring
// threads on neighbouring addresses) per thread, summing the W rows in the
// fixed order 0..W-1 in f32 registers, with no shared memory and no
// cross-block reduction.
//
// The aggregate (agg_*) keeps enough bytes in flight to approach the
// bound.  At the main path's widths (W = 30, N = 101,888: 25,472 float4s)
// its 64-thread blocks make 398 blocks, three per SM of 132, and each
// thread loads a group of kGroup rows into registers before the group's
// multiply-adds, which still run in row order: 16 loads of 16 bytes in
// flight per thread, ~6.5 MB over the card, where 3.35 TB/s at ~1 us of
// latency wants a few MB.  Rows are read once, so their loads are
// streaming (__ldcs, evict first).  (Measured on an H100: groups of 16 beat
// 8, 12 and 32; 32-, 64-, 96- and 128-thread blocks tie; streaming loads
// are 3-5% faster than __ldg.)  The mix (mix_*) keeps one 16-byte load in
// flight per thread, in 256-thread blocks (100 at that N).
//
// Numerics: every row is read, zero-weight rows included, so a NaN or inf
// in a live row propagates exactly as JAX's 0 * row does.  The explicit
// _rn intrinsics keep nvcc from contracting multiply and add into an FMA,
// so the kernel rounds exactly like the plain PyTorch version (ref.py):
// acc = acc + w[r] * row[r], then s * server + acc.
//
// The mix allows out == server (in-place merge, as the TPU kernel aliases
// its server buffer): neither pointer is __restrict__, and each thread
// reads its own server element before it writes the same element of out.
// The aggregate never reads a server buffer at all (the alpha >= 1 replace
// path must not turn a non-finite server model into NaN via 0 * inf).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float madd(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

constexpr int kAggThreads = 64;
constexpr int kGroup = 16;         // rows loaded before their multiply-adds

__device__ __forceinline__ float4 madd4(float4 acc, float w, float4 x) {
  return make_float4(madd(acc.x, w, x.x), madd(acc.y, w, x.y),
                     madd(acc.z, w, x.z), madd(acc.w, w, x.w));
}

__global__ void __launch_bounds__(kAggThreads)
    agg_vec4(const float4* __restrict__ rows, const float* __restrict__ w,
             float4* __restrict__ out, int W, long long n4) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < W; r0 += kGroup) {
    float4 x[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (r0 + u < W) x[u] = __ldcs(&rows[(r0 + u) * n4 + i]);
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (r0 + u < W) acc = madd4(acc, __ldg(&w[r0 + u]), x[u]);
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(kAggThreads)
    agg_scalar(const float* __restrict__ rows, const float* __restrict__ w,
               float* __restrict__ out, int W, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int r0 = 0; r0 < W; r0 += kGroup) {
    float x[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (r0 + u < W) x[u] = __ldcs(&rows[(r0 + u) * n + i]);
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (r0 + u < W) acc = madd(acc, __ldg(&w[r0 + u]), x[u]);
  }
  out[i] = acc;
}

// w holds W + 1 entries: w[0] scales the server, w[1..W] weight the rows.
__global__ void mix_vec4(const float4* __restrict__ rows,
                         const float* __restrict__ w, const float4* server,
                         float4* out, int W, long long n4) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < W; ++r) {
    const float wr = w[r + 1];
    const float4 x = rows[r * n4 + i];
    acc.x = madd(acc.x, wr, x.x);
    acc.y = madd(acc.y, wr, x.y);
    acc.z = madd(acc.z, wr, x.z);
    acc.w = madd(acc.w, wr, x.w);
  }
  const float s = w[0];
  const float4 sv = server[i];
  out[i] = make_float4(madd(acc.x, s, sv.x), madd(acc.y, s, sv.y),
                       madd(acc.z, s, sv.z), madd(acc.w, s, sv.w));
}

__global__ void mix_scalar(const float* __restrict__ rows,
                           const float* __restrict__ w, const float* server,
                           float* out, int W, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int r = 0; r < W; ++r) acc = madd(acc, w[r + 1], rows[r * n + i]);
  out[i] = madd(acc, w[0], server[i]);
}

inline unsigned blocks_for(long long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

// rows: (W, N) contiguous f32; w: (W,) f32; out: (N,) f32, all on the card.
extern "C" int fedavg_agg_launch(const float* rows, const float* w,
                                 float* out, long long W, long long N,
                                 cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (N % 4 == 0 && aligned16(rows) && aligned16(out)) {
    const long long n4 = N / 4;
    agg_vec4<<<blocks_for(n4, kAggThreads), kAggThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(rows), w,
        reinterpret_cast<float4*>(out), (int)W, n4);
  } else {
    agg_scalar<<<blocks_for(N, kAggThreads), kAggThreads, 0, stream>>>(
        rows, w, out, (int)W, N);
  }
  return (int)cudaGetLastError();
}

// rows: (W, N); w: (W + 1,); server, out: (N,); out may equal server.
extern "C" int fedavg_mix_launch(const float* rows, const float* w,
                                 const float* server, float* out, long long W,
                                 long long N, cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (N % 4 == 0 && aligned16(rows) && aligned16(server) && aligned16(out)) {
    const long long n4 = N / 4;
    mix_vec4<<<blocks_for(n4), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(rows), w,
        reinterpret_cast<const float4*>(server),
        reinterpret_cast<float4*>(out), (int)W, n4);
  } else {
    mix_scalar<<<blocks_for(N), kThreads, 0, stream>>>(rows, w, server, out,
                                                        (int)W, N);
  }
  return (int)cudaGetLastError();
}
