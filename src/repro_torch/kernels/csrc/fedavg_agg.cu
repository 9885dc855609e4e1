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
// m' and v'.  merged never goes to memory.  In front of the mix,
// topk_quant.py's dequant_add (_decode_kernel) -> fedavg_dequant_mix_launch:
// async_delta's delta merge of an int8 response, its decode and the W = 2
// mix in one pass (see dequant_mix below).  The shard_map wrappers of the
// same file (fedavg_mix_flat_sharded, fedavg_agg_flat_sharded,
// server_opt_step_flat_sharded: B7) are these entries over pieces.
//
// Pieces.  Every entry takes n pieces of equal width N, all on one device:
// one piece is the unsharded call; a device of a sharded server's mesh
// passes every piece it holds (on one card that repeats in the mesh, all
// D of them), so a sharded merge costs one launch a device, not one a
// shard.  Each piece's operand pointers travel in a __grid_constant__
// table (pieces.cuh: up to 32 pieces of 8 pointers, 2,048 bytes of
// parameters, inside the classic 4 KB), so nothing is copied to the device
// or allocated; a device with more pieces takes a launch every 32.
// blockIdx.y picks the piece and blockIdx.x the block within it: at
// W = 30, N = 4 x 25,600 on one card one launch has the unsharded launch's
// 400 blocks, where one launch a shard had 100 (of 64 threads, on 132
// SMs), four times over, each paying its ~5 us of launch and ramp.  The
// weights are one vector a device (the pieces share them).  Tensor cores
// and TMA do not help here: the merge is a W-term f32 reduction at ~2W
// flops per 4W bytes, bound by bytes, and at 17.2 GB of rows the body
// runs at ~91% of the byte bound; what the sharded form lost was launches
// and an under-filled grid, which the table removes.
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
// Aliasing, within a piece (pieces never overlap): out may be server and
// prev (both the same buffer: the in-place merge, as the TPU kernel
// aliases its server buffer), m_out may be m and v_out may be v; nothing
// else.  Those pointers are not __restrict__, and
// each thread reads all of its element's inputs before it writes any
// output.  The aggregate forms never read a server buffer at all (the
// alpha >= 1 replace path must not turn a non-finite server model into
// NaN via 0 * inf).
#include <cuda_runtime.h>

#include <type_traits>

#include "pieces.cuh"
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

// A piece's operands, in this order in the pointer table; null where the
// form takes none.
enum Operand { kRows, kServer, kPrev, kM, kV, kOut, kMOut, kVOut, kOperands };

using pieces::operand;

// Piece blockIdx.y of the table g: rows (W, n) of V; w: the row weights,
// after the server scale w[0] in the kScaled form, shared by the pieces;
// the other operands (n,) of V.
template <ServerTerm S, class Opt, class V, class T>
__global__ void __launch_bounds__(kThreads)
    merge(const __grid_constant__ T g, const float* __restrict__ w,
          const Opt opt, int W, long long n) {
  constexpr bool kScaled = S == ServerTerm::kScaled;
  constexpr bool kStep = !std::is_same<Opt, NoOpt>::value;
  constexpr bool kAdam = std::is_same<Opt, Adam>::value;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V* __restrict__ rows = operand<const V>(g, kRows);
  // the server value first, in flight with the first rows
  V sv = zero<V>();
  if constexpr (kScaled) sv = __ldcs(&operand<const V>(g, kServer)[i]);
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
  V* out = operand<V>(g, kOut);
  if constexpr (!kStep) {
    out[i] = acc;
  } else {
    // the step's operands only now (see above); every input of this
    // element is read before any output is written
    const V pv = __ldcs(&operand<const V>(g, kPrev)[i]);
    const V mv = __ldcs(&operand<const V>(g, kM)[i]);
    V vv = zero<V>();
    if constexpr (kAdam) vv = __ldcs(&operand<const V>(g, kV)[i]);
    V o, mo, vo;
    step(opt, pv, acc, mv, vv, o, mo, vo);
    operand<V>(g, kMOut)[i] = mo;
    if constexpr (kAdam) operand<V>(g, kVOut)[i] = vo;
    out[i] = o;
  }
}

// ---- the delta merge of a quantised response ------------------------------
//
// async_delta's merge of an int8 response (q, scale) encoded against base:
// new = base + q * scale (B4's decode), then B1 over the rows (new, base)
// at W = 2 with w = [w0, w1, w2] (the delta merge's [1, 1, -1]): acc = 0 +
// w1 * new, acc = acc + w2 * base, out = acc + w0 * server, each rounded
// as merge<kScaled> rounds it.  One launch where the chain made three (B4,
// torch.stack of (new, base), B1), each at the ~6 us launch floor at the
// MLP's width; base is read once, new never goes to memory: 13 bytes an
// element (q, base, server in; out) where the chain moved 33.  A piece's
// operands in the table: q, base, server, out (out may be server).
enum DqOperand { kDqQ, kDqBase, kDqServer, kDqOut, kDqOperands };

constexpr int kDqThreads = 128;

__device__ __forceinline__ float dq(float b, int8_t q, float s) {
  return __fadd_rn(b, __fmul_rn((float)q, s));
}

__device__ __forceinline__ float4 dq(float4 b, char4 q, float s) {
  return make_float4(dq(b.x, q.x, s), dq(b.y, q.y, s), dq(b.z, q.z, s),
                     dq(b.w, q.w, s));
}

// V float4 with Q char4 (16-byte access), or float with int8_t; piece
// blockIdx.y of the table g; n elements of V a piece
template <class V, class Q, class T>
__global__ void __launch_bounds__(kDqThreads)
    dequant_mix(const __grid_constant__ T g, const float* __restrict__ scale,
                const float* __restrict__ w, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Q qv = __ldcs(&operand<const Q>(g, kDqQ)[i]);
  const V bv = __ldcs(&operand<const V>(g, kDqBase)[i]);
  const V sv = __ldcs(&operand<const V>(g, kDqServer)[i]);
  const V nv = dq(bv, qv, __ldg(scale));
  V acc = madd(zero<V>(), __ldg(&w[1]), nv);
  acc = madd(acc, __ldg(&w[2]), bv);
  // every input of the element is read: out may be server
  operand<V>(g, kDqOut)[i] = madd(acc, __ldg(&w[0]), sv);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// The launches of the form (S, Opt) over n pieces of width N: ops is a host
// array of n * kOperands card pointers, piece-major in Operand order, null
// where the form takes none.  float4 when N % 4 == 0 and every pointer of
// every piece is 16-byte aligned.
template <ServerTerm S, class Opt>
int launch(const void* const* ops, int n, const float* w, const Opt opt,
           long long W, long long N, cudaStream_t stream) {
  if (N <= 0 || n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  bool vec = N % 4 == 0;
  for (long long k = 0; k < (long long)n * kOperands; ++k)
    vec = vec && aligned16(ops[k]);
  const long long len = vec ? N / 4 : N;
  const unsigned gx = (unsigned)((len + kThreads - 1) / kThreads);
  return pieces::each<kOperands>(ops, n, [&](const auto& t, int count) {
    using T = std::decay_t<decltype(t)>;
    const dim3 grid(gx, count);
    if (vec) {
      merge<S, Opt, float4, T><<<grid, kThreads, 0, stream>>>(t, w, opt,
                                                              (int)W, len);
    } else {
      merge<S, Opt, float, T><<<grid, kThreads, 0, stream>>>(t, w, opt,
                                                             (int)W, len);
    }
  });
}

}  // namespace

// Every entry: ops, a host array of n * 8 card pointers, piece by piece
// (rows, server, prev, m, v, out, m_out, v_out; null where the form takes
// none), n pieces of (W, N) rows and (N,) vectors, contiguous f32, all on
// the card of the stream; w on the same card.

// out = w @ rows: rows and out of each piece; w: (W,).
extern "C" int fedavg_agg_launch(const void* const* ops, int n,
                                 const float* w, long long W, long long N,
                                 cudaStream_t stream) {
  return launch<ServerTerm::kNone>(ops, n, w, NoOpt{}, W, N, stream);
}

// out = w[0] * server + w[1:] @ rows: rows, server and out of each piece
// (out may equal server); w: (W + 1,).
extern "C" int fedavg_mix_launch(const void* const* ops, int n,
                                 const float* w, long long W, long long N,
                                 cudaStream_t stream) {
  return launch<ServerTerm::kScaled>(ops, n, w, NoOpt{}, W, N, stream);
}

// async_delta's merge of a quantised response, one launch for n pieces:
// ops, a host array of n * 4 card pointers, piece by piece (q (N,) int8,
// base, server, out (N,) f32; out may equal server); scale: 0-d f32; w:
// (3,) f32, [server weight, new weight, base weight].
extern "C" int fedavg_dequant_mix_launch(const void* const* ops, int n,
                                         const float* scale, const float* w,
                                         long long N, cudaStream_t stream) {
  if (N <= 0 || n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  bool vec = N % 4 == 0;
  for (long long k = 0; k < (long long)n * kDqOperands; ++k)
    vec = vec && (k % kDqOperands == kDqQ
                      ? (reinterpret_cast<unsigned long long>(ops[k]) & 3) == 0
                      : aligned16(ops[k]));
  const long long len = vec ? N / 4 : N;
  const unsigned gx = (unsigned)((len + kDqThreads - 1) / kDqThreads);
  return pieces::each<kDqOperands>(ops, n, [&](const auto& t, int count) {
    using T = std::decay_t<decltype(t)>;
    const dim3 grid(gx, count);
    if (vec)
      dequant_mix<float4, char4, T><<<grid, kDqThreads, 0, stream>>>(
          t, scale, w, len);
    else
      dequant_mix<float, int8_t, T><<<grid, kDqThreads, 0, stream>>>(
          t, scale, w, len);
  });
}

// The merge and the optimizer step in one pass.  server null in every
// piece: the aggregate (w: (W,)); else the mix (w: (W + 1,), server scale
// first).  prev, m, out, m_out of each piece; adam != 0 adds v and v_out
// (else both null).  Scalars s0..s3: am, bm, cd, lr (momentum) or b1, b2,
// lr, tau (adam).  out may equal server and prev, m_out m, v_out v.
extern "C" int fedavg_merge_opt_launch(const void* const* ops, int n,
                                       const float* w, int adam, float s0,
                                       float s1, float s2, float s3,
                                       long long W, long long N,
                                       cudaStream_t stream) {
  const bool mix = n > 0 && ops[kServer] != nullptr;
  if (adam) {
    const Adam opt{s0, s1, s2, s3};
    return mix ? launch<ServerTerm::kScaled>(ops, n, w, opt, W, N, stream)
               : launch<ServerTerm::kNone>(ops, n, w, opt, W, N, stream);
  }
  const Mom opt{s0, s1, s2, s3};
  return mix ? launch<ServerTerm::kScaled>(ops, n, w, opt, W, N, stream)
             : launch<ServerTerm::kNone>(ops, n, w, opt, W, N, stream);
}
