// Fused (staleness-)weighted federated averaging over packed f32 rows, with
// the server optimizer's step in the same launch.
//
// Replaces the TPU kernels in repro/kernels/fedavg_agg.py:
//   fedavg_agg_flat (_agg_kernel)  ->  fedavg_agg_launch:  out = w @ rows
//   fedavg_mix_flat (_mix_kernel)  ->  fedavg_mix_launch:
//       out = w[0] * server + w[1:] @ rows   (fedavg_delta_flat is w[0] = 1)
// and, fused behind either, server_opt_step_flat (_opt_mom_kernel,
// _opt_adam_kernel) -> fedavg_merge_opt_launch: merged = one of the two
// sums, then d = merged - prev and the momentum or adam step, writing new,
// m' and v'.  merged never goes to memory.
//
// One kernel body, merge<ServerTerm, Opt, V>, serves every form:
//   ServerTerm  kNone (the aggregate: the server is never read) or kScaled
//               (the mix: s * server + acc)
//   Opt         NoOpt, Mom or Adam (server_opt_step.cuh's arithmetic)
//   V           float4 when N % 4 == 0 and every pointer is 16-byte aligned
//               (16-byte loads and stores, neighbouring threads on
//               neighbouring addresses), else float.
//
// Bound on the card: bytes.  Each output element reads W row values (plus
// the server, prev, m and v values its form needs) and writes one to three
// values, with 2W + ~10 flops, far below the H100's ~20 flops per byte.
// Every input is read once, so all loads are streaming (__ldcs, evict
// first).  The geometry keeps enough bytes in flight to approach the
// bound: 64-thread blocks (at W = 30, N = 101,888: 398 blocks, three per SM
// of 132), each thread loading a group of kGroup rows into registers
// before the group's multiply-adds, which still run in row order 0..W-1:
// 16 loads of 16 bytes in flight per thread, ~6.5 MB over the card, where
// 3.35 TB/s at ~1 us of latency wants a few MB.  (Measured on an H100 for
// the aggregate: groups of 16 beat 8, 12 and 32; 32-, 64-, 96- and
// 128-thread blocks tie; streaming loads are 3-5% faster than __ldg.)  The
// step's own operands (prev, m, v) are loaded after the rows: loaded
// first, they stay live across the row loop and nvcc then issues each
// row's load right before its multiply-add, with no rows in flight (an
// H100 run: agg + adam at W = 30 0.0204 ms with them first, 0.0128 after).
// At the FL paths' small W (FedAsync merges W = 1) the launch itself, not
// the bytes, sets the time, so the step rides in the merge's launch
// instead of a second one that would read merged back.
//
// Numerics: every row is read, zero-weight rows included, so a NaN or inf
// in a live row propagates exactly as JAX's 0 * row does.  The explicit
// _rn intrinsics keep nvcc from contracting multiply and add into an FMA,
// so each form rounds exactly like its plain PyTorch version (ref.py):
// acc = acc + w[r] * row[r], then s * server + acc, then the step.
//
// Aliasing: out may be server and prev (both the same buffer: the in-place
// merge, as the TPU kernel aliases its server buffer), m_out may be m and
// v_out may be v; nothing else.  Those pointers are not __restrict__, and
// each thread reads all of its element's inputs before it writes any
// output.  The aggregate forms never read a server buffer at all (the
// alpha >= 1 replace path must not turn a non-finite server model into
// NaN via 0 * inf).
#include <cuda_runtime.h>

#include <type_traits>

#include "server_opt_step.cuh"

namespace {

using server_opt_step::Adam;
using server_opt_step::Mom;

constexpr int kThreads = 64;
constexpr int kGroup = 16;         // rows loaded before their multiply-adds

enum class ServerTerm { kNone, kScaled };
struct NoOpt {};

__device__ __forceinline__ float madd(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

__device__ __forceinline__ float4 madd(float4 acc, float w, float4 x) {
  return make_float4(madd(acc.x, w, x.x), madd(acc.y, w, x.y),
                     madd(acc.z, w, x.z), madd(acc.w, w, x.w));
}

template <class V>
__device__ __forceinline__ V zero() {
  if constexpr (std::is_same<V, float4>::value) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return 0.f;
  }
}

__device__ __forceinline__ void step(const Mom s, float p, float g, float m,
                                     float, float& o, float& mo, float&) {
  server_opt_step::mom_one(s, p, g, m, &o, &mo);
}

__device__ __forceinline__ void step(const Adam s, float p, float g, float m,
                                     float v, float& o, float& mo,
                                     float& vo) {
  server_opt_step::adam_one(s, p, g, m, v, &o, &mo, &vo);
}

template <class Opt>
__device__ __forceinline__ void step(const Opt s, float4 p, float4 g,
                                     float4 m, float4 v, float4& o,
                                     float4& mo, float4& vo) {
  step(s, p.x, g.x, m.x, v.x, o.x, mo.x, vo.x);
  step(s, p.y, g.y, m.y, v.y, o.y, mo.y, vo.y);
  step(s, p.z, g.z, m.z, v.z, o.z, mo.z, vo.z);
  step(s, p.w, g.w, m.w, v.w, o.w, mo.w, vo.w);
}

// rows: (W, n) of V; w: the row weights, after the server scale w[0] in
// the kScaled form; the other operands (n,) of V.
template <ServerTerm S, class Opt, class V>
__global__ void __launch_bounds__(kThreads)
    merge(const V* __restrict__ rows, const float* __restrict__ w,
          const V* server, const V* prev, const V* m, const V* v, V* out,
          V* m_out, V* v_out, const Opt opt, int W, long long n) {
  constexpr bool kScaled = S == ServerTerm::kScaled;
  constexpr bool kStep = !std::is_same<Opt, NoOpt>::value;
  constexpr bool kAdam = std::is_same<Opt, Adam>::value;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the server value first, in flight with the first rows
  V sv = zero<V>();
  if constexpr (kScaled) sv = __ldcs(&server[i]);
  const float* __restrict__ wr = kScaled ? w + 1 : w;
  V acc = zero<V>();
  for (int r0 = 0; r0 < W; r0 += kGroup) {
    V x[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (r0 + u < W) x[u] = __ldcs(&rows[(r0 + u) * n + i]);
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (r0 + u < W) acc = madd(acc, __ldg(&wr[r0 + u]), x[u]);
  }
  if constexpr (kScaled) acc = madd(acc, __ldg(&w[0]), sv);
  if constexpr (!kStep) {
    out[i] = acc;
  } else {
    // the step's operands only now (see above); every input of this
    // element is read before any output is written
    const V pv = __ldcs(&prev[i]), mv = __ldcs(&m[i]);
    V vv = zero<V>();
    if constexpr (kAdam) vv = __ldcs(&v[i]);
    V o, mo, vo;
    step(opt, pv, acc, mv, vv, o, mo, vo);
    m_out[i] = mo;
    if constexpr (kAdam) v_out[i] = vo;
    out[i] = o;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <class V>
inline V* as(const float* p) {
  return reinterpret_cast<V*>(const_cast<float*>(p));
}

// One launch of the form (S, Opt); a null pointer is an operand the form
// does not take.
template <ServerTerm S, class Opt>
int launch(const float* rows, const float* w, const float* server,
           const float* prev, const float* m, const float* v, float* out,
           float* m_out, float* v_out, const Opt opt, long long W,
           long long N, cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  const void* ptrs[] = {rows, server, prev, m, v, out, m_out, v_out};
  bool vec = N % 4 == 0;
  for (const void* p : ptrs) vec = vec && aligned16(p);
  if (vec) {
    const long long n4 = N / 4;
    merge<S, Opt, float4>
        <<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>(as<const float4>(rows), w, as<const float4>(server),
                     as<const float4>(prev), as<const float4>(m),
                     as<const float4>(v), as<float4>(out), as<float4>(m_out),
                     as<float4>(v_out), opt, (int)W, n4);
  } else {
    merge<S, Opt, float><<<(unsigned)((N + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(
        rows, w, server, prev, m, v, out, m_out, v_out, opt, (int)W, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (W, N) contiguous f32; w: (W,) f32; out: (N,) f32, all on the card.
extern "C" int fedavg_agg_launch(const float* rows, const float* w,
                                 float* out, long long W, long long N,
                                 cudaStream_t stream) {
  return launch<ServerTerm::kNone>(rows, w, nullptr, nullptr, nullptr,
                                   nullptr, out, nullptr, nullptr, NoOpt{}, W,
                                   N, stream);
}

// rows: (W, N); w: (W + 1,); server, out: (N,); out may equal server.
extern "C" int fedavg_mix_launch(const float* rows, const float* w,
                                 const float* server, float* out, long long W,
                                 long long N, cudaStream_t stream) {
  return launch<ServerTerm::kScaled>(rows, w, server, nullptr, nullptr,
                                     nullptr, out, nullptr, nullptr, NoOpt{},
                                     W, N, stream);
}

// The merge and the optimizer step in one launch.  server null: the
// aggregate (w: (W,)); else the mix (w: (W + 1,), server scale first).
// prev, m, out, m_out: (N,); adam != 0 adds v, v_out (else both null).
// Scalars s0..s3: am, bm, cd, lr (momentum) or b1, b2, lr, tau (adam).
// out may equal server and prev, m_out m, v_out v.
extern "C" int fedavg_merge_opt_launch(
    const float* rows, const float* w, const float* server, const float* prev,
    const float* m, const float* v, float* out, float* m_out, float* v_out,
    int adam, float s0, float s1, float s2, float s3, long long W,
    long long N, cudaStream_t stream) {
  if (adam) {
    const Adam opt{s0, s1, s2, s3};
    return server ? launch<ServerTerm::kScaled>(rows, w, server, prev, m, v,
                                                out, m_out, v_out, opt, W, N,
                                                stream)
                  : launch<ServerTerm::kNone>(rows, w, nullptr, prev, m, v,
                                              out, m_out, v_out, opt, W, N,
                                              stream);
  }
  const Mom opt{s0, s1, s2, s3};
  return server ? launch<ServerTerm::kScaled>(rows, w, server, prev, m,
                                              nullptr, out, m_out, nullptr,
                                              opt, W, N, stream)
                : launch<ServerTerm::kNone>(rows, w, nullptr, prev, m,
                                            nullptr, out, m_out, nullptr, opt,
                                            W, N, stream);
}
