// The chunked RWKV-6 WKV recurrence, from an initial state to a final state.
//
// Replaces the TPU kernel of repro/kernels/rwkv6_kernel.py wkv_pallas
// (_wkv_kernel), and the chunk loop of repro/models/rwkv6.py wkv_chunked,
// which runs the same chunk step from a given state and returns the final
// one.  Per (batch b, head h), chunk after chunk of C positions, in f32:
//   lw = log(clip(w, 1e-12, 1));  A = cumsum(lw) - lw (exclusive);
//   Atot = A[C-1] + lw[C-1];
//   y_t = [sum_{i<t} (sum_k r_tk exp(A_tk - A_ik - lw_ik) k_ik) v_i
//          + (sum_k r_tk u_k k_tk) v_t] + sum_k r_tk exp(A_tk) S_k;
//   S' = S exp(Atot) + sum_i (k_i exp(Atot - A_i - lw_i))^T v_i,
// y read from the state S as it was before the chunk, S from s0 (zeros
// when none is given); y in r's dtype, the final state in f32.  The terms
// are grouped as the reference groups them; only the order inside f32 sums
// differs.  The pairwise decays are computed per pair and channel, as the
// reference computes them: exp(A_t) exp(-A_i) would overflow, since lw
// reaches log(1e-12) = -27.6 a position.  The cumsum runs in f64 and is
// rounded once a position, as torch's CPU cumsum is: an f32 running sum
// drifts by ulps of |A| (up to 88 at the clip), which the exps of its
// differences turn into relative errors of 1e-5.
//
// Design.  Only the state carries from chunk to chunk, and its update is
// affine, S_{c+1} = S_c exp(Atot_c) + dS_c, with dS_c a function of chunk c
// alone.  So three launches on one stream:
//   1. wkv_state_inc, one block per (b, h, chunk): exp(Atot_c) and dS_c.
//   2. wkv_scan, one thread per 4 state entries of a (b, h): the chain from
//      s0, writing S_c (the state before chunk c) over dS_c, which it has
//      read, and the final state.  The chain carries nothing but the state:
//      4 multiplies and 4 adds a step, its loads issued 8 chunks ahead.
//   3. wkv_out, one block per (b, h, chunk, 64 value columns): A, the C x C
//      scores, the bonus, the intra-chunk y and (r exp(A)) S_c, then y.
// At rwkv6-3b's prefill (B=2, S=8192, H=40, K=64, C=64) steps 1 and 3 run
// 10,240 blocks of 256 threads each (three and two to an SM); the dS / S_c
// scratch is 168 MB.
//
// Step 3 holds the chunk in shared memory in f32, r, k, lw and A channel-
// major (positions contiguous), so that a thread reads 2 or 4 positions of
// one channel as one load.  The strictly-lower scores are cut into halves
// of 4 x 4 tiles of (t, i), 2 rows by 4 columns: at C = 64 the 240 halves
// of the 120 full tiles go one to a thread, and the 16 diagonal tiles (6
// pairs each, and the bonus of their 4 rows) have their channels split over
// the threads with the least to do; at a smaller C the halves' channels are
// split too, so that the block stays busy.  Partial sums are added in a
// fixed order.  Each thread then computes y for 4 rows, 2 from each end of
// the chunk so that the triangular sum costs every thread the same, and 4
// value columns.  A block issues every load of its chunk, and of its slice
// of S_c (into registers, held across the scores), before it uses the
// first; the other block on the SM computes meanwhile.  The chunks are
// independent, so no double buffer is needed.  The cumsum of each channel
// runs in parts of 16 positions on 4 threads, whose sums are added in
// order.
//
// Bound on the card at that shape: bytes (r, k, v, y in bf16, w, s0 and the
// final state in f32) 0.151 ms at 3.35 TB/s; 2.20e10 operations, 0.329 ms
// at 67 TFLOP/s in f32 (the state is f32 by contract, which no bf16
// tensor-core product keeps); and 1.45e9 exps and logs on the SFUs, 16 a
// clock per SM, 0.346 ms, which binds (chip_smoke.py computes all three).
// expf and logf are the accurate library functions (no fast math); the
// state update and y's last two sums are rounded as the reference rounds
// them (__fmul_rn, __fadd_rn: no fused multiply-add).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // steps 1 and 3
constexpr int kScanThreads = 128;   // step 2
constexpr int kMaxChunk = 64;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block can opt in

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;    // (H, K) f32, contiguous
  const float* s0;   // (B, H, K, K) f32, contiguous; null: zeros
  void* y;
  float* state;      // (B, H, K, K) f32, contiguous; null: not written
  float* ds;         // (B, H, nc, K, K) f32 scratch: dS_c, then S_c
  float* ea;         // (B, H, nc, K) f32 scratch: exp(Atot_c)
  long long r_sb, r_ss, r_sh;   // strides in elements; unit stride along K
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int H, C, nc;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N = 4 or 8 consecutive elements of a stream as loaded (the row 16-byte
// aligned), then widened to f32
template <typename T, int N>
struct Vec;
template <>
struct Vec<float, 4> {
  float4 a;
};
template <>
struct Vec<float, 8> {
  float4 a, b;
};
template <>
struct Vec<__nv_bfloat16, 4> {
  uint2 a;
};
template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 a;
};

__device__ __forceinline__ Vec<float, 4> ldg4(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p))};
}
__device__ __forceinline__ Vec<float, 8> ldg8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}
__device__ __forceinline__ Vec<__nv_bfloat16, 4> ldg4(
    const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint2*>(p))};
}
__device__ __forceinline__ Vec<__nv_bfloat16, 8> ldg8(
    const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ void bf16x2(unsigned u, float* o) {
  o[0] = __uint_as_float(u << 16);
  o[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void cvt(const Vec<float, 4>& x, float* o) {
  o[0] = x.a.x, o[1] = x.a.y, o[2] = x.a.z, o[3] = x.a.w;
}
__device__ __forceinline__ void cvt(const Vec<float, 8>& x, float* o) {
  o[0] = x.a.x, o[1] = x.a.y, o[2] = x.a.z, o[3] = x.a.w;
  o[4] = x.b.x, o[5] = x.b.y, o[6] = x.b.z, o[7] = x.b.w;
}
__device__ __forceinline__ void cvt(const Vec<__nv_bfloat16, 4>& x,
                                    float* o) {
  bf16x2(x.a.x, o);
  bf16x2(x.a.y, o + 2);
}
__device__ __forceinline__ void cvt(const Vec<__nv_bfloat16, 8>& x,
                                    float* o) {
  bf16x2(x.a.x, o);
  bf16x2(x.a.y, o + 2);
  bf16x2(x.a.z, o + 4);
  bf16x2(x.a.w, o + 6);
}
// zeros past the chunk's end (``live`` false)
template <int N, typename V>
__device__ __forceinline__ void cvt(const V& x, bool live, float* o) {
  cvt(x, o);
#pragma unroll
  for (int j = 0; j < N; ++j) o[j] = live ? o[j] : 0.0f;
}
// log(clip(w, 1e-12, 1)); zeros past the chunk's end
template <int N, typename V>
__device__ __forceinline__ void log_decay(const V& x, bool live, float* o) {
  cvt(x, o);
#pragma unroll
  for (int j = 0; j < N; ++j)
    o[j] = live ? logf(fminf(fmaxf(o[j], 1e-12f), 1.0f)) : 0.0f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// How steps 1 and 3 cut a chunk.  4 x 4 tiles of (t, i) over Cp = C rounded
// up to 4 positions (the padded rows are zeros); TS, the row stride of the
// channel-major tiles, is a multiple of 4 whose quarter is odd, so that
// neighbouring channels' float4s fall in other banks; ns and ns2 split the
// channels of the full tiles' halves and of the diagonal tiles over the
// block; the cumsum of each channel runs in np parts of pl positions.
struct Geo {
  int nt, Cp, TS, nfull, ns, ns2, np, pl;
};

__host__ __device__ inline int channel_splits(int items, int K, int threads) {
  int n = 1;
  while (2 * n <= K / 4 && items * 2 * n <= threads) n *= 2;
  return n;
}

__host__ __device__ inline Geo geometry(int C, int K) {
  Geo g;
  g.nt = (C + 3) / 4;
  g.Cp = 4 * g.nt;
  g.TS = 4 * (g.nt | 1);
  g.nfull = g.nt * (g.nt - 1) / 2;
  g.ns = channel_splits(2 * g.nfull, K, kThreads);
  g.ns2 = channel_splits(g.nt, K, kThreads / 2);
  const int parts = kThreads / K < g.nt ? kThreads / K : g.nt;
  g.pl = 4 * ((g.nt + parts - 1) / parts);
  g.np = (g.Cp + g.pl - 1) / g.pl;
  return g;
}

// step 3's shared memory, offsets in floats: r (then r exp(A)), k, A, lw
// channel-major; S_c's slice over k, A and lw once the scores are done; v's
// slice; the scores' partial sums [split][i][t]; the diagonal tiles'
// partial sums (the cumsum's part sums before them); the bonus's; u
struct OutSmem {
  int rT, kT, AT, lwT, Ss, vs, sc, dsc, dg, us, total;
};

__host__ __device__ inline int max_int(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline OutSmem out_smem(const Geo& g, int K, int VB) {
  OutSmem o;
  const int tile = K * g.TS, vstride = VB + 4;
  o.rT = 0;
  o.kT = tile;
  o.AT = 2 * tile;
  o.lwT = 3 * tile;
  o.Ss = tile;
  o.vs = tile + max_int(3 * tile, K * vstride);
  o.sc = o.vs + g.Cp * vstride;
  o.dsc = o.sc + g.ns * g.Cp * g.TS;
  o.dg = o.dsc + max_int(g.ns2 * g.nt * 16, 2 * g.np * K);
  o.us = o.dg + g.ns2 * g.Cp;
  o.total = o.us + K;
  return o;
}

// A_t = (lw_0 + ... + lw_t) - lw_t on positions [0, C) of K channels, -inf
// on [C, Cp) (their decays from the chunk's rows are then 0); lw and A at
// [t * ts + kk * ks].  Each channel runs in g.np parts of g.pl positions,
// one thread each: a part's f64 sum, the sums of the parts before it added
// in order, then its running sum rounded once a position.  With ts == 1 the
// positions are read 4 at a time.  Every thread of the block calls it.
__device__ __forceinline__ void exclusive_cumsum(const float* lw, float* A,
                                                 int ts, int ks, int K,
                                                 int C, const Geo& g,
                                                 double* part) {
  const float neg_inf = -__int_as_float(0x7f800000);
  const int kk = threadIdx.x % K, p = threadIdx.x / K;
  const bool on = p < g.np;
  const int t0 = p * g.pl, t1 = min(t0 + g.pl, C);
  const int o = kk * ks;
  if (on) {
    double s = 0.0;
    for (int t = t0; t < t1; ++t) s += lw[t * ts + o];
    part[p * K + kk] = s;
  }
  __syncthreads();
  if (!on) return;
  double s = 0.0;
  for (int q = 0; q < p; ++q) s += part[q * K + kk];
  if (ts == 1) {
    for (int t = t0; t < min(t0 + g.pl, g.Cp); t += 4) {
      const float4 l4 = ld4(lw + o + t);
      const float lq[4] = {l4.x, l4.y, l4.z, l4.w};
      float aq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t + j < C) {
          s += lq[j];
          aq[j] = (float)s - lq[j];
        } else {
          aq[j] = neg_inf;
        }
      }
      st4(A + o + t, aq[0], aq[1], aq[2], aq[3]);
    }
  } else {
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const float l = lw[t * ts + o];
      s += l;
      A[t * ts + o] = (float)s - l;
    }
  }
}

// ---- step 1: exp(Atot_c) and dS_c = kdec^T v --------------------------

template <int K, typename T>
__global__ void __launch_bounds__(kThreads, 3) wkv_state_inc(const Args a) {
  constexpr int KS = K + 4, KQ = K / 4, K8 = K / 8, U = 2;
  const int C = a.C, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const Geo g = geometry(C, K);
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // C x KS: k, then kdec
  float* vs = ks + C * KS;
  float* lws = vs + C * KS;
  float* As = lws + C * KS;
  float* atot = As + C * KS;                      // K
  double* part = reinterpret_cast<double*>(atot + K);

  // rows of 8 channels, U of them a thread in flight at once
  const long long p0 = (long long)c * C;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh +
                p0 * a.k_ss;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh +
                p0 * a.v_ss;
  const float* wg = a.w + b * a.w_sb + h * a.w_sh + p0 * a.w_ss;
  for (int m0 = tid; m0 < C * K8; m0 += U * kThreads) {
    Vec<T, 8> kr[U], vr[U];
    Vec<float, 8> wr[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int m = min(m0 + e * kThreads, C * K8 - 1);
      const int t = m / K8, k0 = 8 * (m % K8);
      kr[e] = ldg8(kg + t * a.k_ss + k0);
      vr[e] = ldg8(vg + t * a.v_ss + k0);
      wr[e] = ldg8(wg + t * a.w_ss + k0);
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int m = m0 + e * kThreads, o = (m / K8) * KS + 8 * (m % K8);
      if (m < C * K8) {
        float q[8];
        cvt(kr[e], q);
        st4(ks + o, q[0], q[1], q[2], q[3]);
        st4(ks + o + 4, q[4], q[5], q[6], q[7]);
        cvt(vr[e], q);
        st4(vs + o, q[0], q[1], q[2], q[3]);
        st4(vs + o + 4, q[4], q[5], q[6], q[7]);
        log_decay<8>(wr[e], true, q);
        st4(lws + o, q[0], q[1], q[2], q[3]);
        st4(lws + o + 4, q[4], q[5], q[6], q[7]);
      }
    }
  }
  __syncthreads();

  exclusive_cumsum(lws, As, KS, 1, K, C, g, part);
  __syncthreads();
  const size_t bhc = ((size_t)b * a.H + h) * a.nc + c;
  for (int kk = tid; kk < K; kk += kThreads) {
    const float at = As[(C - 1) * KS + kk] + lws[(C - 1) * KS + kk];
    atot[kk] = at;
    a.ea[bhc * K + kk] = expf(at);
  }
  __syncthreads();

  for (int m = tid; m < C * K; m += kThreads) {
    const int t = m / K, kk = m % K, o = t * KS + kk;
    ks[o] = ks[o] * expf(atot[kk] - As[o] - lws[o]);
  }
  __syncthreads();

  // dS[k][j] = sum_i kdec[i][k] v[i][j], in 4 x 4 tiles of (k, j)
  float* dsg = a.ds + bhc * K * K;
  for (int o = tid; o < KQ * KQ; o += kThreads) {
    const int k0 = 4 * (o / KQ), j0 = 4 * (o % KQ);
    float acc[4][4] = {};
#pragma unroll 4
    for (int i = 0; i < C; ++i) {
      const float4 kd = ld4(ks + i * KS + k0), vv = ld4(vs + i * KS + j0);
      const float kq[4] = {kd.x, kd.y, kd.z, kd.w};
      const float vq[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] = fmaf(kq[q], vq[j], acc[q][j]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      st4(dsg + (k0 + q) * K + j0, acc[q][0], acc[q][1], acc[q][2],
          acc[q][3]);
  }
}

// ---- step 2: the chain S_{c+1} = S_c exp(Atot_c) + dS_c ---------------

template <int K>
__global__ void __launch_bounds__(kScanThreads) wkv_scan(const Args a) {
  constexpr int N4 = K * K / 4, U = 8;
  const int e4 = blockIdx.x * kScanThreads + threadIdx.x;
  if (e4 >= N4) return;
  const int kk = 4 * e4 / K;
  const size_t bh = (size_t)blockIdx.z * a.H + blockIdx.y;
  float4* ds = reinterpret_cast<float4*>(a.ds + bh * a.nc * K * K) + e4;
  const float* ea = a.ea + bh * a.nc * K + kk;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.s0) s = reinterpret_cast<const float4*>(a.s0 + bh * K * K)[e4];
  for (int c0 = 0; c0 < a.nc; c0 += U) {
    float4 d[U];
    float e[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (c0 + j < a.nc) {
        d[j] = ds[(size_t)(c0 + j) * N4];
        e[j] = ea[(size_t)(c0 + j) * K];
      } else {
        d[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        e[j] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (c0 + j < a.nc) {
        ds[(size_t)(c0 + j) * N4] = s;   // the state before chunk c0 + j
        s.x = __fadd_rn(__fmul_rn(s.x, e[j]), d[j].x);
        s.y = __fadd_rn(__fmul_rn(s.y, e[j]), d[j].y);
        s.z = __fadd_rn(__fmul_rn(s.z, e[j]), d[j].z);
        s.w = __fadd_rn(__fmul_rn(s.w, e[j]), d[j].w);
      }
    }
  }
  if (a.state) reinterpret_cast<float4*>(a.state + bh * K * K)[e4] = s;
}

// ---- step 3: the scores, the bonus and y ------------------------------

// half of a full 4 x 4 tile of scores: rows t0, t0 + 1, columns i0.. (i < t
// throughout), over channels [k0, k0 + kn); written [i][t]
__device__ __forceinline__ void score_half(const float* rT, const float* kT,
                                           const float* AT, const float* lwT,
                                           int TS, int t0, int i0, int k0,
                                           int kn, float* out) {
  float acc[2][4] = {};
#pragma unroll 4
  for (int kk = k0; kk < k0 + kn; ++kk) {
    const int o = kk * TS;
    const float2 r2 = ld2(rT + o + t0), at2 = ld2(AT + o + t0);
    const float4 ai4 = ld4(AT + o + i0), li4 = ld4(lwT + o + i0);
    const float4 ki4 = ld4(kT + o + i0);
    const float rt[2] = {r2.x, r2.y};
    const float at[2] = {at2.x, at2.y};
    const float ai[4] = {ai4.x, ai4.y, ai4.z, ai4.w};
    const float li[4] = {li4.x, li4.y, li4.z, li4.w};
    const float ki[4] = {ki4.x, ki4.y, ki4.z, ki4.w};
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float e = expf(at[tt] - ai[ii] - li[ii]);
        acc[tt][ii] = fmaf(rt[tt] * e, ki[ii], acc[tt][ii]);
      }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
    st2(out + (i0 + ii) * TS + t0, acc[0][ii], acc[1][ii]);
}

// a diagonal tile (rows and columns t0..t0+3): the 6 pairs i < t of rows
// inside the chunk, and the bonus r . u k of its 4 rows, over channels
// [k0, k0 + kn); the pairs written [t][i] into out (zeros where i >= t)
__device__ __forceinline__ void diag_tile(const float* rT, const float* kT,
                                          const float* AT, const float* lwT,
                                          const float* us, int TS, int t0,
                                          int C, int k0, int kn, float* out,
                                          float* bonus) {
  float acc[4][4] = {}, bon[4] = {};
  bool live[4];
#pragma unroll
  for (int tt = 0; tt < 4; ++tt) live[tt] = t0 + tt < C;
  for (int kk = k0; kk < k0 + kn; ++kk) {
    const int o = kk * TS + t0;
    const float4 r4 = ld4(rT + o), a4 = ld4(AT + o);
    const float4 l4 = ld4(lwT + o), k4 = ld4(kT + o);
    const float rt[4] = {r4.x, r4.y, r4.z, r4.w};
    const float at[4] = {a4.x, a4.y, a4.z, a4.w};
    const float li[4] = {l4.x, l4.y, l4.z, l4.w};
    const float ki[4] = {k4.x, k4.y, k4.z, k4.w};
    const float uk = us[kk];
#pragma unroll
    for (int tt = 1; tt < 4; ++tt)
#pragma unroll
      for (int ii = 0; ii < tt; ++ii)
        if (live[tt]) {
          const float e = expf(at[tt] - at[ii] - li[ii]);
          acc[tt][ii] = fmaf(rt[tt] * e, ki[ii], acc[tt][ii]);
        }
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
      bon[tt] = fmaf(rt[tt] * uk, ki[tt], bon[tt]);
  }
#pragma unroll
  for (int tt = 0; tt < 4; ++tt) {
    st4(out + 4 * tt, acc[tt][0], acc[tt][1], acc[tt][2], acc[tt][3]);
    bonus[tt] = bon[tt];
  }
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads, 2) wkv_out(const Args a) {
  constexpr int VB = K < 64 ? K : 64, VS = VB + 4, NJ = K / VB;
  constexpr int VQ = VB / 4;
  constexpr int NS4 = (K * VQ + kThreads - 1) / kThreads;
  const Geo g = geometry(a.C, K);
  const OutSmem L = out_smem(g, K, VB);
  const int C = a.C, Cp = g.Cp, TS = g.TS, nt = g.nt;
  const int c = blockIdx.x / NJ, j00 = (blockIdx.x % NJ) * VB;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* rT = sm + L.rT;
  float* kT = sm + L.kT;
  float* AT = sm + L.AT;
  float* lwT = sm + L.lwT;
  float* Ss = sm + L.Ss;
  float* vs = sm + L.vs;
  float* sc = sm + L.sc;
  float* dsc = sm + L.dsc;
  float* dg = sm + L.dg;
  float* us = sm + L.us;

  // S_c's slice, into registers now and into shared memory after the scores
  const size_t bhc = ((size_t)b * a.H + h) * a.nc + c;
  const float* Sg = a.ds + bhc * K * K + j00;
  float4 sreg[NS4];
#pragma unroll
  for (int e = 0; e < NS4; ++e) {
    const int m = tid + e * kThreads;
    sreg[e] = m < K * VQ ? ld4(Sg + (m / VQ) * K + 4 * (m % VQ))
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // the chunk in blocks of 4 positions x 4 channels, every load of a thread
  // issued before the first is used: r, k and lw written channel-major
  // (neighbouring threads take neighbouring position blocks, so that their
  // float4 stores fall in other banks), v's slice row-major; padded rows
  // zeros
  const long long p0 = (long long)c * C;
  const T* rg = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh +
                p0 * a.r_ss;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh +
                p0 * a.k_ss;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh +
                p0 * a.v_ss + j00;
  const float* wg = a.w + b * a.w_sb + h * a.w_sh + p0 * a.w_ss;
  for (int m = tid; m < nt * (K / 4); m += kThreads) {
    const int t0 = 4 * (m % nt), k0 = 4 * (m / nt);
    const bool with_v = k0 < VB;   // v's slice: columns j00 + k0
    Vec<T, 4> rr[4], kr[4], vr[4];
    Vec<float, 4> wr[4];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int t = t0 + tt < C ? t0 + tt : C - 1;   // padded: any row
      rr[tt] = ldg4(rg + t * a.r_ss + k0);
      kr[tt] = ldg4(kg + t * a.k_ss + k0);
      wr[tt] = ldg4(wg + t * a.w_ss + k0);
      if (with_v) vr[tt] = ldg4(vg + t * a.v_ss + k0);
    }
    float q[4][4];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) cvt<4>(rr[tt], t0 + tt < C, q[tt]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(rT + (k0 + j) * TS + t0, q[0][j], q[1][j], q[2][j], q[3][j]);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) cvt<4>(kr[tt], t0 + tt < C, q[tt]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(kT + (k0 + j) * TS + t0, q[0][j], q[1][j], q[2][j], q[3][j]);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) log_decay<4>(wr[tt], t0 + tt < C, q[tt]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(lwT + (k0 + j) * TS + t0, q[0][j], q[1][j], q[2][j], q[3][j]);
    if (with_v) {
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        cvt<4>(vr[tt], t0 + tt < C, q[tt]);
        st4(vs + (t0 + tt) * VS + k0, q[tt][0], q[tt][1], q[tt][2],
            q[tt][3]);
      }
    }
  }
  for (int kk = tid; kk < K; kk += kThreads) us[kk] = a.u[h * K + kk];
  __syncthreads();

  // A, as step 1 computes it (the part sums in the diagonal tiles' space)
  exclusive_cumsum(lwT, AT, 1, TS, K, C, g, reinterpret_cast<double*>(dsc));
  __syncthreads();

  // the scores: halves of the full tiles (ta, ib), ib < ta, one channel
  // split each...
  const int kf = K / g.ns, nh = 2 * g.nfull;
  for (int wi = tid; wi < nh * g.ns; wi += kThreads) {
    const int item = wi % nh, sp = wi / nh;
    int ta = 1, ib = item / 2;
    while (ib >= ta) {
      ib -= ta;
      ++ta;
    }
    score_half(rT, kT, AT, lwT, TS, 4 * ta + 2 * (item % 2), 4 * ib,
               sp * kf, kf, sc + sp * Cp * TS);
  }
  // ...then the diagonal tiles and the bonus, from the last thread down
  const int kd = K / g.ns2;
  for (int wi = kThreads - 1 - tid; wi < nt * g.ns2; wi += kThreads) {
    const int d = wi % nt, sp = wi / nt;
    diag_tile(rT, kT, AT, lwT, us, TS, 4 * d, C, sp * kd, kd,
              dsc + (sp * nt + d) * 16, dg + sp * Cp + 4 * d);
  }
  __syncthreads();

  // partial sums added in split order, into split 0 ([i][t]); then
  // r exp(A) over r
  for (int e = tid; e < nt * 16; e += kThreads) {
    const int d = e / 16, tt = (e / 4) % 4, ii = e % 4;
    float s = 0.0f;
    for (int sp = 0; sp < g.ns2; ++sp) s += dsc[(sp * nt + d) * 16 + e % 16];
    sc[(4 * d + ii) * TS + 4 * d + tt] = s;
  }
  if (g.ns > 1) {
    for (int e = tid; e < g.nfull * 16; e += kThreads) {
      int ta = 1, ib = e / 16;
      while (ib >= ta) {
        ib -= ta;
        ++ta;
      }
      const int o = (4 * ib + e % 4) * TS + 4 * ta + (e / 4) % 4;
      float s = sc[o];
      for (int sp = 1; sp < g.ns; ++sp) s += sc[sp * Cp * TS + o];
      sc[o] = s;
    }
  }
  for (int t = tid; t < Cp; t += kThreads) {
    float s = 0.0f;
    for (int sp = 0; sp < g.ns2; ++sp) s += dg[sp * Cp + t];
    dg[t] = s;
  }
#pragma unroll 4
  for (int m = tid; m < K * nt; m += kThreads) {
    const int o = (m / nt) * TS + 4 * (m % nt);
    const float4 r4 = ld4(rT + o), a4 = ld4(AT + o);
    st4(rT + o, r4.x * expf(a4.x), r4.y * expf(a4.y), r4.z * expf(a4.z),
        r4.w * expf(a4.w));
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < NS4; ++e) {
    const int m = tid + e * kThreads;
    if (m < K * VQ)
      st4(Ss + (m / VQ) * VS + 4 * (m % VQ), sreg[e].x, sreg[e].y,
          sreg[e].z, sreg[e].w);
  }
  __syncthreads();

  // y for rows (2q, 2q + 1) and (Cp - 2 - 2q, Cp - 1 - 2q), 4 columns
  T* yg = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + p0 * a.y_ss + j00;
  for (int o = tid; o < nt * VQ; o += kThreads) {
    const int j0 = 4 * (o % VQ), q = o / VQ;
    const int row[4] = {2 * q, 2 * q + 1, Cp - 2 - 2 * q, Cp - 1 - 2 * q};
    float acc[4][4] = {};
    // scores @ v: sc is 0 at i >= t, so each pair runs to its lower row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = row[2 * half];
#pragma unroll 4
      for (int i = 0; i <= r0; ++i) {
        const float2 s = ld2(sc + i * TS + r0);
        const float4 vv = ld4(vs + i * VS + j0);
        const float vq[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[2 * half][j] = fmaf(s.x, vq[j], acc[2 * half][j]);
          acc[2 * half + 1][j] = fmaf(s.y, vq[j], acc[2 * half + 1][j]);
        }
      }
    }
    // + diag v, then + (r exp(A)) @ S_c, each rounded as the reference
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float d = dg[row[p]];
      const float4 vv = ld4(vs + row[p] * VS + j0);
      const float vq[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[p][j] = __fadd_rn(acc[p][j], __fmul_rn(d, vq[j]));
    }
    float carry[4][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      const float2 ra = ld2(rT + kk * TS + row[0]);
      const float2 rb = ld2(rT + kk * TS + row[2]);
      const float rq[4] = {ra.x, ra.y, rb.x, rb.y};
      const float4 s4 = ld4(Ss + kk * VS + j0);
      const float sq[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          carry[p][j] = fmaf(rq[p], sq[j], carry[p][j]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (row[p] >= C) continue;
      T* yr = yg + row[p] * a.y_ss + j0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        yr[j] = from_f32<T>(__fadd_rn(acc[p][j], carry[p][j]));
    }
  }
}

template <int K, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int VB = K < 64 ? K : 64;
  const Geo g = geometry(a.C, K);
  const size_t smem1 =
      sizeof(float) * (4 * (size_t)a.C * (K + 4) + K + 2 * (size_t)g.np * K);
  const size_t smem3 = sizeof(float) * (size_t)out_smem(g, K, VB).total;
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel has to opt in; both ask
  // for the largest carveout, so that three and two blocks fit an SM
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaSuccess;
    for (const void* f : {(const void*)wkv_state_inc<K, T>,
                          (const void*)wkv_out<K, T>}) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            f, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  wkv_state_inc<K, T><<<dim3(a.nc, a.H, B), kThreads, smem1, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_scan<K><<<dim3((K * K / 4 + kScanThreads - 1) / kScanThreads, a.H, B),
                kScanThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_out<K, T><<<dim3(a.nc * (K / VB), a.H, B), kThreads, smem3, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, int K, cudaStream_t stream) {
  switch (K) {
    case 8: return launch<8, T>(a, B, stream);
    case 16: return launch<16, T>(a, B, stream);
    case 32: return launch<32, T>(a, B, stream);
    case 64: return launch<64, T>(a, B, stream);
    case 128: return launch<128, T>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y: (B,S,H,K) of dtype 0 = f32 or 1 = bf16; w: (B,S,H,K) f32; u:
// (H,K) f32 contiguous; s0 (may be null) and state (may be null): (B,H,K,K)
// f32 contiguous; ds: B*H*(S/C)*K*K and ea: B*H*(S/C)*K f32 of scratch.
// Each 4-D stream is addressed through its (batch, sequence, head) strides
// in elements, unit stride along K, every row of K starting on 16 bytes.
// K in {8, 16, 32, 64, 128}; C <= 64, S % C == 0.
extern "C" int wkv_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, void* y, float* state, float* ds,
    float* ea, long long B, long long S, long long H, long long K,
    long long C, long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long w_sb, long long w_ss,
    long long w_sh, long long y_sb, long long y_ss, long long y_sh,
    long long dtype, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > kMaxChunk || S % C != 0 || S > 0x7fffffff ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{r,    k,    v,    w,    u,    s0,   y,    state, ds,
               ea,   r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb,  v_ss,
               v_sh, w_sb, w_ss, w_sh, y_sb, y_ss, y_sh, (int)H, (int)C,
               (int)(S / C)};
  if (dtype == 0) return dispatch<float>(a, (int)B, (int)K, stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, (int)B, (int)K, stream);
  return (int)cudaErrorInvalidValue;
}
