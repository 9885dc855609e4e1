// Fused server-optimizer step over packed f32 vectors, d = merged - prev.
//
// Replaces the TPU kernels of repro/kernels/fedavg_agg.py
// server_opt_step_flat:
//   momentum form (_opt_mom_kernel)  ->  server_opt_mom_launch:
//       m' = am*m + bm*d;  new = (prev + cd*d) + lr*m'
//   adam form (_opt_adam_kernel)     ->  server_opt_adam_launch:
//       m' = b1*m + (1-b1)*d;  v' = b2*v + ((1-b2)*d)*d
//       new = prev + (lr*m') / (sqrt(v') + tau)
//
// Bound on the card: bytes.  The step is elementwise with ~10 flops per
// element against 20 bytes moved (momentum: 3 reads, 2 writes) or 28
// (adam: 4 reads, 3 writes), far below the H100's ~20 flops per byte.  At
// the main path's width (N = 101,888) that is 2.0-2.9 MB, well under a
// microsecond of HBM time, so the launch itself dominates.  The design is
// one pass: one thread per float4 (16-byte loads and stores, neighbouring
// threads on neighbouring addresses) when N % 4 == 0 and every pointer is
// 16-byte aligned, one thread per element otherwise; the four or six
// scalars come by value.
//
// Off the FL paths since the fused merge (fedavg_agg.cu) takes the step
// in the merge's own launch, with the same per-element arithmetic
// (server_opt_step.cuh); this standalone form keeps its check and timing.
//
// Numerics: the explicit _rn intrinsics keep nvcc from contracting a
// multiply and an add into an FMA (and the division and square root are
// IEEE-rounded), so the kernel rounds exactly like the plain PyTorch
// version in ref.py, operation for operation.
//
// m' and v' may be written over m and v (the optimizer's state updates in
// place): those pointers are not __restrict__, and each thread reads its
// own element before writing it.  new must not alias any input.
//
// Pieces, as in fedavg_agg.cu: each entry takes n pieces of equal width N
// on one device (one piece: the unsharded step; every piece a device holds:
// server_opt_step_flat_sharded, B7), their pointers in a __grid_constant__
// table (pieces.cuh: up to 32 pieces of 7 pointers, 1,792 bytes of
// parameters), blockIdx.y the piece: one launch a device, not one a shard.
#include <cuda_runtime.h>

#include <type_traits>

#include "pieces.cuh"
#include "server_opt_step.cuh"

namespace {

using server_opt_step::Adam;
using server_opt_step::adam_one;
using server_opt_step::Mom;
using server_opt_step::mom_one;

constexpr int kThreads = 256;

// A piece's operands, in this order in the pointer table (v and v_out null
// in the momentum form).
enum Operand { kPrev, kMerged, kM, kV, kNew, kMOut, kVOut, kOperands };

using pieces::operand;

__device__ __forceinline__ void one(const Mom s, float p, float g, float m,
                                    float, float& o, float& mo, float&) {
  mom_one(s, p, g, m, &o, &mo);
}

__device__ __forceinline__ void one(const Adam s, float p, float g, float m,
                                    float v, float& o, float& mo, float& vo) {
  adam_one(s, p, g, m, v, &o, &mo, &vo);
}

template <class Opt>
__device__ __forceinline__ void one(const Opt s, float4 p, float4 g, float4 m,
                                    float4 v, float4& o, float4& mo,
                                    float4& vo) {
  one(s, p.x, g.x, m.x, v.x, o.x, mo.x, vo.x);
  one(s, p.y, g.y, m.y, v.y, o.y, mo.y, vo.y);
  one(s, p.z, g.z, m.z, v.z, o.z, mo.z, vo.z);
  one(s, p.w, g.w, m.w, v.w, o.w, mo.w, vo.w);
}

// Piece blockIdx.y of the table g: n elements of V a vector.
template <class Opt, class V, class T>
__global__ void opt_step(const __grid_constant__ T g, const Opt s,
                         long long n) {
  constexpr bool kAdam = std::is_same<Opt, Adam>::value;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V pv = operand<const V>(g, kPrev)[i];
  const V gv = operand<const V>(g, kMerged)[i];
  const V mv = operand<const V>(g, kM)[i];
  V vv{}, o, mo, vo;
  if constexpr (kAdam) vv = operand<const V>(g, kV)[i];
  one(s, pv, gv, mv, vv, o, mo, vo);
  operand<V>(g, kMOut)[i] = mo;
  if constexpr (kAdam) operand<V>(g, kVOut)[i] = vo;
  operand<V>(g, kNew)[i] = o;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// The launches of one form over n pieces of width N: ops is a host array of
// n * kOperands card pointers, piece-major in Operand order.  float4 when
// N % 4 == 0 and every pointer is 16-byte aligned.
template <class Opt>
int launch(const void* const* ops, int n, const Opt s, long long N,
           cudaStream_t stream) {
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
      opt_step<Opt, float4, T><<<grid, kThreads, 0, stream>>>(t, s, len);
    } else {
      opt_step<Opt, float, T><<<grid, kThreads, 0, stream>>>(t, s, len);
    }
  });
}

}  // namespace

// ops: a host array of n * 7 card pointers, piece by piece (prev, merged,
// m, v, new_out, m_out, v_out), each (N,) f32 on the stream's card; v and
// v_out null; m_out may equal m.
extern "C" int server_opt_mom_launch(const void* const* ops, int n, float am,
                                     float bm, float cd, float lr,
                                     long long N, cudaStream_t stream) {
  return launch(ops, n, Mom{am, bm, cd, lr}, N, stream);
}

// As above with v and v_out; v_out may equal v.
extern "C" int server_opt_adam_launch(const void* const* ops, int n,
                                      float b1, float b2, float lr,
                                      float tau, long long N,
                                      cudaStream_t stream) {
  return launch(ops, n, Adam{b1, b2, lr, tau}, N, stream);
}
