// One server-optimizer step on one element, d = merged - prev: the
// arithmetic of repro/kernels/fedavg_agg.py's server_opt_step_flat, shared
// by the standalone step (server_opt.cu) and the epilogue of the fused
// merge (fedavg_agg.cu), so that the two cannot drift apart.
//
//   momentum:  m' = am*m + bm*d;  new = (prev + cd*d) + lr*m'
//   adam:      m' = b1*m + (1-b1)*d;  v' = b2*v + ((1-b2)*d)*d
//              new = prev + (lr*m') / (sqrt(v') + tau)
//
// Every operation is an explicit _rn intrinsic in this order, so nvcc
// cannot contract a multiply and an add into an FMA, and the division and
// square root are IEEE-rounded: the step rounds exactly like the plain
// PyTorch version (ref.reference_server_opt), operation for operation.
#pragma once

#include <cuda_runtime.h>

namespace server_opt_step {

struct Mom {
  float am, bm, cd, lr;
};

struct Adam {
  float b1, b2, lr, tau;
};

__device__ __forceinline__ void mom_one(const Mom s, float prev, float merged,
                                        float m, float* new_out,
                                        float* m_out) {
  const float d = __fsub_rn(merged, prev);
  const float mo = __fadd_rn(__fmul_rn(s.am, m), __fmul_rn(s.bm, d));
  *m_out = mo;
  *new_out = __fadd_rn(__fadd_rn(prev, __fmul_rn(s.cd, d)),
                       __fmul_rn(s.lr, mo));
}

__device__ __forceinline__ void adam_one(const Adam s, float prev,
                                         float merged, float m, float v,
                                         float* new_out, float* m_out,
                                         float* v_out) {
  const float d = __fsub_rn(merged, prev);
  const float mo = __fadd_rn(__fmul_rn(s.b1, m),
                             __fmul_rn(__fsub_rn(1.0f, s.b1), d));
  const float vo = __fadd_rn(__fmul_rn(s.b2, v),
                             __fmul_rn(__fmul_rn(__fsub_rn(1.0f, s.b2), d),
                                       d));
  *m_out = mo;
  *v_out = vo;
  *new_out = __fadd_rn(prev, __fdiv_rn(__fmul_rn(s.lr, mo),
                                       __fadd_rn(__fsqrt_rn(vo), s.tau)));
}

}  // namespace server_opt_step
