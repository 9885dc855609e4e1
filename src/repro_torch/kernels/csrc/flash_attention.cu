// Forward flash attention for prefill: causal / sliding-window / softcapped
// GQA attention with an online softmax over KV tiles.
//
// Replaces the TPU kernel of repro/kernels/flash_attention.py
// flash_attention (_attn_kernel).  Same function:
//   q (B,S,H,D), k and v (B,T,Kv,D), T == S, positions from 0; query head h
//   reads KV head h / (H/Kv);
//   s = (f32(q) * 1/sqrt(D)) . f32(k);  s = softcap*tanh(s/softcap) if set;
//   s = -1e30 where masked (causal: q >= k; window: q - k < window);
//   online softmax with (m, l, acc) and P in f32;
//   out = acc / max(l, 1e-30), in q's dtype.
//
// Bound on the card: operations.  A prefill at gemma2-2b's width (B=2,
// S=8192, H=8, D=256) does 4*D flops per (query, visible key) pair, 5.5e11
// flops per causal layer, against ~0.2 GB of q/k/v/o traffic in bf16: about
// 2,700 flops per byte, far above the H100's ~295 (bf16 tensor cores).  This
// first kernel keeps every score, P and accumulator in f32 as the reference
// does, so it runs on the f32 FMA units, not the tensor cores: it is bound by
// f32 FMA throughput and shared-memory bandwidth, far from the bf16 bound.
// A wgmma/TMA version is later work.
//
// Design: one block of 256 threads per (query tile of 64 rows, head, batch).
// The 16 x 16 threads split the tile so that thread (ty, tx) owns query rows
// ty + 16*i (i < 4): for the scores it owns keys tx + 16*j of the KV tile,
// for the output it owns columns of D.  A row's 16 threads are 16 lanes of
// one warp, so the row max and sum are warp shuffles and (m, l) live in
// registers; P reaches the PV product by shuffles too.  The query tile
// (scaled, f32) stays in shared memory; K and V tiles of BK keys are
// streamed through shared memory in f32, read through the (B,S,H,D)
// strides, so no transposed copies are made.  The accumulator stays in
// registers (64 floats per thread at D = 256), which keeps the block at
// 130 KB of shared memory with f32 inputs at D = 256.
//
// The KV loop runs over the tiles the query tile can see, in this kernel's
// tile sizes: lo = max(0, (q0 - window + 1) / BK), hi = min(n_k,
// cdiv(q0 + 64, BK)) when causal (the effective bound of the TPU kernel).
// Near the window's lower edge a row's first tile can be all masked: its
// spurious p = exp(-1e30 - -1e30) = 1 terms are wiped by corr = exp(-1e30 -
// m) = 0 once a real key arrives (every row sees its own position), which
// is why the sentinel stays finite.  A ragged tail (S not a multiple of the
// tile) is handled: rows >= S are neither read nor written, keys >= T are
// masked.  expf and tanhf are the accurate library functions (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;    // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, T, rep, causal, window;
  float scale, softcap;
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

// KV tile: 32 keys at D = 256 (shared memory), 64 below.
template <int D>
struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr int QS = D + 4;              // padded row of Qs and Ks
  static constexpr int VEC = D >= 64 ? 4 : 1;   // output columns per load
  static constexpr int NC = D / (16 * VEC);     // column groups per thread
  // registers: the accumulator is D/4 floats a thread; D = 256 needs ~128
  static constexpr int kMinBlocks = D >= 256 ? 1 : 2;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBQ * QS + (size_t)BK * QS + (size_t)BK * D);
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
    flash_fwd(const Args a) {
  constexpr int BK = Tile<D>::BK, QS = Tile<D>::QS, VEC = Tile<D>::VEC,
                NC = Tile<D>::NC;
  constexpr int RI = kBQ / 16;   // rows per thread
  constexpr int KJ = BK / 16;    // keys per thread in the score tile
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // kBQ x QS, scaled q
  float* Ks = Qs + kBQ * QS;                     // BK x QS
  float* Vs = Ks + BK * QS;                      // BK x D

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.rep;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, pos = q0 + r;
    Qs[r * QS + d] =
        pos < a.S ? to_f32(qg[pos * a.q_ss + d]) * a.scale : 0.0f;
  }

  const int n_k = (a.T + BK - 1) / BK;
  const int hi = a.causal ? min(n_k, (q0 + kBQ + BK - 1) / BK) : n_k;
  const int lo = a.window > 0 ? max(0, (q0 - a.window + 1) / BK) : 0;

  float m[RI], l[RI], acc[RI][NC * VEC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC * VEC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D, pos = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (pos < a.T) {
        kx = to_f32(kg[pos * a.k_ss + d]);
        vx = to_f32(vg[pos * a.v_ss + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RI], kv[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = kpos < a.T;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
        s[i][j] = ok ? x : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off, 16));
      const float m_new = fmaxf(m[i], mt);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off, 16);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * VEC; ++c) acc[i][c] *= corr;
    }

    // acc += P V; P[row][kk] lives in lane (kk % 16) of the row's 16 lanes
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = __shfl_sync(0xffffffffu, s[i][kk / 16], kk % 16, 16);
      const float* vrow = Vs + kk * D + VEC * tx;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vrow + 16 * VEC * c);
          vv[0] = v4.x;
          vv[1] = v4.y;
          vv[2] = v4.z;
          vv[3] = v4.w;
        } else {
          vv[0] = vrow[16 * c];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int i = 0; i < RI; ++i)
            acc[i][c * VEC + e] = fmaf(pv[i], vv[e], acc[i][c * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = og + qpos * a.o_ss + VEC * tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[16 * VEC * c + e] = from_f32<T>(acc[i][c * VEC + e] / den);
  }
}

template <int D, typename T>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmem;
  // above 48 KB of dynamic shared memory a kernel has to opt in, once
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, H, B);
  flash_fwd<D, T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, T>(a, B, H, stream);
    case 32: return launch<32, T>(a, B, H, stream);
    case 64: return launch<64, T>(a, B, H, stream);
    case 128: return launch<128, T>(a, B, H, stream);
    case 256: return launch<256, T>(a, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B,S,H,D); k, v: (B,T,Kv,D) with T == S; each addressed through its
// (batch, sequence, head) strides in elements, unit stride along D.
// dtype: 0 = f32, 1 = bf16 (o has q's dtype).  D in {16, 32, 64, 128, 256}.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long B,
    long long S, long long T, long long H, long long Kv, long long D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long causal, long long window, float scale, float softcap,
    long long dtype, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (Kv <= 0 || H % Kv != 0 || T != S || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    o,    q_sb,        q_ss,   q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss,        v_sh,   o_sb,
               o_ss, o_sh, (int)S, (int)T, (int)(H / Kv), (int)causal,
               (int)window, scale, softcap};
  if (dtype == 0) return dispatch<float>(a, (int)B, (int)H, (int)D, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, (int)B, (int)H, (int)D, stream);
  return (int)cudaErrorInvalidValue;
}
