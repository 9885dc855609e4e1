// Chunked RWKV-6 WKV recurrence from a zero state (prefill form, no final
// state returned).
//
// Replaces the TPU kernel of repro/kernels/rwkv6_kernel.py wkv_pallas
// (_wkv_kernel).  Same function, per (batch b, head h), chunk after chunk
// of C positions, in f32:
//   lw = log(clip(w, 1e-12, 1));  A = cumsum(lw) - lw (exclusive);
//   Atot = A[C-1] + lw[C-1];
//   y_t = sum_{i<t} [sum_k r_tk exp(A_tk - A_ik - lw_ik) k_ik] v_i
//         + [sum_k r_tk u_k k_tk] v_t + sum_k r_tk exp(A_tk) state_k;
//   state_kj = state_kj exp(Atot_k) + sum_i k_ik exp(Atot_k - A_ik - lw_ik) v_ij
// with y read from the state as it was before the chunk; y in r's dtype.
//
// Bound on the card: operations at the f32 rate.  At rwkv6-3b's width (B=2,
// S=8192, H=40, K=64, chunk 16) r, k, v and y in bf16 and w in f32 move 12
// bytes per element, 0.50 GB, 0.150 ms at 3.35 TB/s; the function needs
// 1.42e10 operations (4e8 of them exps), 0.212 ms at 67 TFLOP/s: the state
// is f32 by contract, which no tensor-core product keeps.  This first
// kernel runs at about 27x that bound (an H100, PERF.md): the state
// carries across S / C = 512 chunks, each a few dependent phases, and the
// column blocks of a head each re-read the chunk's tiles from shared
// memory for the scores.
//
// Design.  The TPU ran the chunks as the sequential grid axis with the state
// in VMEM scratch; here blocks run in no order, so one block walks all the
// chunks of its (b, h) and keeps the state in shared memory.  The value
// columns are independent (column j of y and of the state depends only on
// v[:, j]), so each (b, h) is split over K / VB blocks of VB columns, which
// recompute the C x C scores: at the shape above 320 blocks of 128 threads,
// two or three to an SM, so one block's loads overlap another's arithmetic.
// Chunks are read straight through the (B,S,H,K) strides (no transposed
// copies) and widened to f32 on load; lw is computed from w here, so no
// separate log pass touches device memory.  Per chunk: load, cumsum, then
// the strictly-lower score pairs (one thread each from a table built once;
// the idle threads take the diagonal bonus) with rdec = r exp(A) and kdec,
// then y, then the state update.  K and VB are template parameters, so the
// loops over channels unroll and their loads and exps overlap instead of
// running one iteration after another; each thread updates its K * VB / 128
// state entries together for the same reason.  Rows of the C x K tiles are
// padded to K + 1 floats, so the score phase's column reads hit distinct
// banks.  expf and logf are the accurate library functions (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block can opt in

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;   // (H, K) f32, contiguous
  void* y;
  long long r_sb, r_ss, r_sh;   // strides in elements; unit stride along K
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int S, C;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// shared memory, in floats: six padded C x (K+1) tiles, v's C x VB slice,
// the C x C scores, Atot, exp(Atot), u, the K x VB state; then the pair table
__host__ __device__ inline size_t smem_floats(int C, int K, int VB) {
  return 6 * (size_t)C * (K + 1) + (size_t)C * VB + (size_t)C * C +
         3 * (size_t)K + (size_t)K * VB;
}
inline size_t smem_bytes(int C, int K, int VB) {
  return sizeof(float) * smem_floats(C, K, VB) +
         sizeof(int) * ((size_t)C * (C - 1) / 2);
}

template <int K, int VB, typename T>
__global__ void __launch_bounds__(kThreads) wkv_fwd(const Args a) {
  // state entries per thread (K = 8 leaves half the threads without one)
  constexpr int KP = K + 1, NS = (K * VB + kThreads - 1) / kThreads;
  const int C = a.C;
  extern __shared__ float smem[];
  float* rs = smem;              // r, f32
  float* ks = rs + C * KP;       // k, f32
  float* lws = ks + C * KP;      // log decay
  float* As = lws + C * KP;      // exclusive cumsum of lw
  float* rdec = As + C * KP;     // r exp(A)
  float* kdec = rdec + C * KP;   // k exp(Atot - A - lw)
  float* vs = kdec + C * KP;     // C x VB
  float* sc = vs + C * VB;       // C x C, entries i <= t
  float* atot = sc + C * C;      // K
  float* eatot = atot + K;       // K
  float* us = eatot + K;         // K
  float* st = us + K;            // K x VB
  int* pairs = reinterpret_cast<int*>(st + K * VB);   // (t << 16) | i, i < t
  const int n_pairs = C * (C - 1) / 2;

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z;
  const T* rg = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + v0;
  const float* wg = a.w + b * a.w_sb + h * a.w_sh;
  T* yg = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + v0;

  for (int kk = tid; kk < K; kk += kThreads) us[kk] = a.u[h * K + kk];
  for (int idx = tid; idx < K * VB; idx += kThreads) st[idx] = 0.0f;
  if (tid == 0) {
    int p = 0;
    for (int t = 1; t < C; ++t)
      for (int i = 0; i < t; ++i) pairs[p++] = (t << 16) | i;
  }

  for (int s0 = 0; s0 < a.S; s0 += C) {
    // load the chunk (the previous chunk's readers are past the last sync)
    for (int idx = tid; idx < C * K; idx += kThreads) {
      const int t = idx / K, kk = idx % K;
      const long long pos = s0 + t;
      rs[t * KP + kk] = to_f32(rg[pos * a.r_ss + kk]);
      ks[t * KP + kk] = to_f32(kg[pos * a.k_ss + kk]);
      lws[t * KP + kk] = logf(fminf(fmaxf(wg[pos * a.w_ss + kk], 1e-12f),
                                    1.0f));
    }
    for (int idx = tid; idx < C * VB; idx += kThreads) {
      const int t = idx / VB, jj = idx % VB;
      vs[idx] = to_f32(vg[(s0 + t) * (long long)a.v_ss + jj]);
    }
    __syncthreads();

    // A_t = (lw_0 + ... + lw_t) - lw_t, as the reference spells it
    for (int kk = tid; kk < K; kk += kThreads) {
      float s = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float l = lws[t * KP + kk];
        s += l;
        As[t * KP + kk] = s - l;
      }
      const float at = As[(C - 1) * KP + kk] + lws[(C - 1) * KP + kk];
      atot[kk] = at;
      eatot[kk] = expf(at);
    }
    __syncthreads();

    // scores: the strictly-lower pairs, then the diagonal bonus r . u k
    for (int p = tid; p < n_pairs + C; p += kThreads) {
      float acc = 0.0f;
      if (p < n_pairs) {
        const int t = pairs[p] >> 16, i = pairs[p] & 0xffff;
        const float* rt = rs + t * KP;
        const float* at = As + t * KP;
        const float* ai = As + i * KP;
        const float* li = lws + i * KP;
        const float* ki = ks + i * KP;
#pragma unroll
        for (int kk = 0; kk < K; ++kk)
          acc += rt[kk] * expf(at[kk] - ai[kk] - li[kk]) * ki[kk];
        sc[t * C + i] = acc;
      } else {
        const int t = p - n_pairs;
#pragma unroll
        for (int kk = 0; kk < K; ++kk)
          acc += rs[t * KP + kk] * us[kk] * ks[t * KP + kk];
        sc[t * C + t] = acc;
      }
    }
    for (int idx = tid; idx < C * K; idx += kThreads) {
      const int t = idx / K, kk = idx % K, o = t * KP + kk;
      rdec[o] = rs[o] * expf(As[o]);
      kdec[o] = ks[o] * expf(atot[kk] - As[o] - lws[o]);
    }
    __syncthreads();

    // y: intra-chunk (pairs and bonus), then the carried state
    for (int idx = tid; idx < C * VB; idx += kThreads) {
      const int t = idx / VB, jj = idx % VB;
      float intra = 0.0f, inter = 0.0f;
      for (int i = 0; i <= t; ++i) intra += sc[t * C + i] * vs[i * VB + jj];
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        inter += rdec[t * KP + kk] * st[kk * VB + jj];
      yg[(s0 + t) * (long long)a.y_ss + jj] = from_f32<T>(intra + inter);
    }
    __syncthreads();   // every read of the old state is done

    // entry tid + e * kThreads of the state, NS of them side by side
    float s[NS];
#pragma unroll
    for (int e = 0; e < NS; ++e) s[e] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int idx = tid + e * kThreads, kk = idx / VB, jj = idx % VB;
        if (idx < K * VB) s[e] += kdec[i * KP + kk] * vs[i * VB + jj];
      }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < K * VB) st[idx] = st[idx] * eatot[idx / VB] + s[e];
    }
    __syncthreads();   // the next chunk may overwrite the tiles
  }
}

template <int K, typename T>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  constexpr int VB = K >= 16 ? 16 : K;   // value columns per block
  const size_t smem = smem_bytes(a.C, K, VB);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel has to opt in
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_fwd<K, VB, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid(K / VB, H, B);
  wkv_fwd<K, VB, T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, int H, int K, cudaStream_t stream) {
  switch (K) {
    case 8: return launch<8, T>(a, B, H, stream);
    case 16: return launch<16, T>(a, B, H, stream);
    case 32: return launch<32, T>(a, B, H, stream);
    case 64: return launch<64, T>(a, B, H, stream);
    case 128: return launch<128, T>(a, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y: (B,S,H,K) of dtype 0 = f32 or 1 = bf16; w: (B,S,H,K) f32; u:
// (H,K) f32 contiguous.  Each 4-D tensor is addressed through its (batch,
// sequence, head) strides in elements, unit stride along K.  K in {8, 16,
// 32, 64, 128}; S % C == 0.
extern "C" int wkv_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, void* y, long long B, long long S, long long H,
    long long K, long long C, long long r_sb, long long r_ss,
    long long r_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long w_sb,
    long long w_ss, long long w_sh, long long y_sb, long long y_ss,
    long long y_sh, long long dtype, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > 1024 || S % C != 0 || S > 0x7fffffff || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{r,    k,    v,    w,    u,    y,    r_sb, r_ss, r_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh,
               y_sb, y_ss, y_sh, (int)S, (int)C};
  if (dtype == 0) return dispatch<float>(a, (int)B, (int)H, (int)K, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, (int)B, (int)H, (int)K, stream);
  return (int)cudaErrorInvalidValue;
}
