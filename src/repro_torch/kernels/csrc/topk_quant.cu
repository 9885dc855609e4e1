// Fused top-k threshold mask + int8 quantise (encode) and fused dequantise
// + delta-apply (decode) over a packed f32 vector.
//
// Replaces the TPU kernels in repro/kernels/topk_quant.py:
//   topk_quant_encode (_encode_kernel) -> topk_quant_encode_launch:
//       q = int8(clip(round_half_even(x / scale), -127, 127)) where
//           |x| >= thresh, else 0;   r = x - q * scale
//   dequant_add (_decode_kernel)       -> dequant_add_launch:
//       out = base + q * scale
//
// Bound on the card: bytes.  Encode reads 4 bytes and writes 5 per element,
// decode reads 5 and writes 4, with a handful of flops each.  The design is
// one pass, one thread per element, with both encode outputs written from
// the same registers so x is read once.  The threshold and scale are read
// from device pointers: they are 0-d tensors computed on the card, and
// passing them by value would cost the host a sync per encode.
//
// Numerics: the explicit _rn intrinsics keep nvcc from contracting
// x - q * scale (or base + q * scale) into an FMA, and the division is the
// correctly rounded one; rintf rounds half to even like jnp.round and
// torch.round.  So both kernels are bit-exact against the plain PyTorch
// versions in ref.py, which round the multiply and the add separately.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void encode_kernel(const float* __restrict__ x,
                              const float* __restrict__ thresh,
                              const float* __restrict__ scale,
                              int8_t* __restrict__ q, float* __restrict__ r,
                              long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t = *thresh;
  const float s = *scale;
  const float xv = x[i];
  float qf = rintf(__fdiv_rn(xv, s));
  qf = fminf(fmaxf(qf, -127.f), 127.f);
  if (!(fabsf(xv) >= t)) qf = 0.f;
  const int8_t qi = (int8_t)qf;
  q[i] = qi;
  r[i] = __fsub_rn(xv, __fmul_rn((float)qi, s));
}

__global__ void decode_kernel(const int8_t* __restrict__ q,
                              const float* __restrict__ scale,
                              const float* __restrict__ base,
                              float* __restrict__ out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __fadd_rn(base[i], __fmul_rn((float)q[i], *scale));
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// x, r: (N,) f32; q: (N,) int8; thresh, scale: 0-d f32, all on the card.
extern "C" int topk_quant_encode_launch(const float* x, const float* thresh,
                                        const float* scale, int8_t* q,
                                        float* r, long long N,
                                        cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  encode_kernel<<<blocks_for(N), kThreads, 0, stream>>>(x, thresh, scale, q,
                                                         r, N);
  return (int)cudaGetLastError();
}

// q: (N,) int8; scale: 0-d f32; base, out: (N,) f32, all on the card.
extern "C" int dequant_add_launch(const int8_t* q, const float* scale,
                                  const float* base, float* out, long long N,
                                  cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  decode_kernel<<<blocks_for(N), kThreads, 0, stream>>>(q, scale, base, out,
                                                         N);
  return (int)cudaGetLastError();
}
