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
#include <cuda_runtime.h>

#include "server_opt_step.cuh"

namespace {

using server_opt_step::Adam;
using server_opt_step::adam_one;
using server_opt_step::Mom;
using server_opt_step::mom_one;

constexpr int kThreads = 256;

__global__ void mom_vec4(const Mom s, const float4* __restrict__ prev,
                         const float4* __restrict__ merged, const float4* m,
                         float4* __restrict__ new_out, float4* m_out,
                         long long n4) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 p = prev[i], g = merged[i], mm = m[i];
  float4 o, mo;
  mom_one(s, p.x, g.x, mm.x, &o.x, &mo.x);
  mom_one(s, p.y, g.y, mm.y, &o.y, &mo.y);
  mom_one(s, p.z, g.z, mm.z, &o.z, &mo.z);
  mom_one(s, p.w, g.w, mm.w, &o.w, &mo.w);
  m_out[i] = mo;
  new_out[i] = o;
}

__global__ void mom_scalar(const Mom s, const float* __restrict__ prev,
                           const float* __restrict__ merged, const float* m,
                           float* __restrict__ new_out, float* m_out,
                           long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o, mo;
  mom_one(s, prev[i], merged[i], m[i], &o, &mo);
  m_out[i] = mo;
  new_out[i] = o;
}

__global__ void adam_vec4(const Adam s, const float4* __restrict__ prev,
                          const float4* __restrict__ merged, const float4* m,
                          const float4* v, float4* __restrict__ new_out,
                          float4* m_out, float4* v_out, long long n4) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 p = prev[i], g = merged[i], mm = m[i], vv = v[i];
  float4 o, mo, vo;
  adam_one(s, p.x, g.x, mm.x, vv.x, &o.x, &mo.x, &vo.x);
  adam_one(s, p.y, g.y, mm.y, vv.y, &o.y, &mo.y, &vo.y);
  adam_one(s, p.z, g.z, mm.z, vv.z, &o.z, &mo.z, &vo.z);
  adam_one(s, p.w, g.w, mm.w, vv.w, &o.w, &mo.w, &vo.w);
  m_out[i] = mo;
  v_out[i] = vo;
  new_out[i] = o;
}

__global__ void adam_scalar(const Adam s, const float* __restrict__ prev,
                            const float* __restrict__ merged, const float* m,
                            const float* v, float* __restrict__ new_out,
                            float* m_out, float* v_out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o, mo, vo;
  adam_one(s, prev[i], merged[i], m[i], v[i], &o, &mo, &vo);
  m_out[i] = mo;
  v_out[i] = vo;
  new_out[i] = o;
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

// prev, merged, m, new_out, m_out: (N,) f32 on the card; m_out may equal m.
extern "C" int server_opt_mom_launch(const float* prev, const float* merged,
                                     const float* m, float* new_out,
                                     float* m_out, float am, float bm,
                                     float cd, float lr, long long N,
                                     cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  const Mom s{am, bm, cd, lr};
  if (N % 4 == 0 && aligned16(prev) && aligned16(merged) && aligned16(m) &&
      aligned16(new_out) && aligned16(m_out)) {
    const long long n4 = N / 4;
    mom_vec4<<<blocks_for(n4), kThreads, 0, stream>>>(
        s, reinterpret_cast<const float4*>(prev),
        reinterpret_cast<const float4*>(merged),
        reinterpret_cast<const float4*>(m),
        reinterpret_cast<float4*>(new_out), reinterpret_cast<float4*>(m_out),
        n4);
  } else {
    mom_scalar<<<blocks_for(N), kThreads, 0, stream>>>(s, prev, merged, m,
                                                        new_out, m_out, N);
  }
  return (int)cudaGetLastError();
}

// As above plus v, v_out: (N,) f32; v_out may equal v.
extern "C" int server_opt_adam_launch(const float* prev, const float* merged,
                                      const float* m, const float* v,
                                      float* new_out, float* m_out,
                                      float* v_out, float b1, float b2,
                                      float lr, float tau, long long N,
                                      cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  const Adam s{b1, b2, lr, tau};
  if (N % 4 == 0 && aligned16(prev) && aligned16(merged) && aligned16(m) &&
      aligned16(v) && aligned16(new_out) && aligned16(m_out) &&
      aligned16(v_out)) {
    const long long n4 = N / 4;
    adam_vec4<<<blocks_for(n4), kThreads, 0, stream>>>(
        s, reinterpret_cast<const float4*>(prev),
        reinterpret_cast<const float4*>(merged),
        reinterpret_cast<const float4*>(m), reinterpret_cast<const float4*>(v),
        reinterpret_cast<float4*>(new_out), reinterpret_cast<float4*>(m_out),
        reinterpret_cast<float4*>(v_out), n4);
  } else {
    adam_scalar<<<blocks_for(N), kThreads, 0, stream>>>(
        s, prev, merged, m, v, new_out, m_out, v_out, N);
  }
  return (int)cudaGetLastError();
}
