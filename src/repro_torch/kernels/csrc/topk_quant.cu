// Fused top-k threshold mask + int8 quantise (encode) and fused dequantise
// + delta-apply (decode) over a packed f32 vector.
//
// Replaces the TPU kernels in repro/kernels/topk_quant.py:
//   topk_quant_encode (_encode_kernel) -> topk_quant_encode_launch:
//       q = int8(clip(round_half_even(x / scale), -127, 127)) where
//           |x| >= thresh, else 0;   r = x - q * scale
//   dequant_add (_decode_kernel)       -> dequant_add_launch:
//       out = base + q * scale
// and, redesigned for Hopper around the paths that call them:
//   ef_encode_cluster_launch (above one cluster's size, between
//   ef_encode_pass1_launch and ef_encode_pass2_launch): the whole error-
//       feedback top-k(+int8) encode of repro/core/transport.py
//       (ef_topk_encode: x = (a - b) + c, the k-th largest |x| as the
//       threshold, max|x| / 127 as the scale, the kept count, then q and r
//       or the masked recon and r), in one launch where the vector fits one
//       thread-block cluster's shared memory;
//   dequant_add_rows_launch: one merge's W decodes base_i + q_i * scale_i
//       straight into rows 0..W-1 of the server's row buffer, with the
//       stale rows after them zeroed, in one launch;
//   the encode's decoded output (dec, quantise only): the cluster sweep
//       and pass 2 also write b + q * scale, B4's decode of what they just
//       quantised against b, re-reading b (8 bytes more an element), so a
//       quantised downlink's encode needs no B4 launch after it.  B4's
//       other path, async_delta's decode before its delta merge, is folded
//       into the merge instead (fedavg_agg.cu, dequant_mix); dequant_add
//       stays for the decodes with no such neighbour.
// Both decodes take pieces (a sharded server's vectors and row buffer,
// N/D elements a piece): every piece a device holds in one launch, the
// piece in blockIdx.y (dequant_add) or blockIdx.z (the rows), its pointers
// among the kernel's parameters; one piece is the unsharded call.  On a
// mesh that repeats one card that is one launch where one a shard ran D in
// series, each at the launch floor (~6 us) with a quarter of the grid.
//
// Bound on the card: bytes.  Encode reads 4 bytes and writes 5 per element,
// decode reads 5 and writes 4, with a handful of flops each.  The single
// forms are one pass, one thread per element, with both encode outputs
// written from the same registers so x is read once.  The threshold and
// scale are read from device pointers: they are 0-d tensors computed on the
// card, and passing them by value would cost the host a sync per encode.
// At the FL paths' N = 101,888 each body moves its 0.9 MB in a fraction of
// a microsecond; the launches around them were the cost.  So:
//
// ef_cluster: one cluster of C CTAs (topk_quant.CLUSTER_CTAS: 16; 8 is
// the portable size) holds x in shared memory, a 1/C slice a CTA (101,888
// f32: 25 KB a CTA at 16).  x is formed while it is loaded, with
// __fsub_rn/__fadd_rn as the two torch ops round.  The threshold is an exact radix select on the bit
// patterns of |x| (non-negative floats order as unsigned integers, NaN
// above +inf as in torch.topk): four 8-bit digit passes from the top, each
// a shared-memory histogram a CTA, summed over the cluster through
// distributed shared memory (DSMEM) after a
// cluster barrier; every CTA finds the same digit, so the k-th largest is
// exact whatever the ties.  Histograms alternate between two buffers, so one
// cluster barrier a pass separates a pass's remote reads from the next
// pass's zeroing.  max|x| is an integer max of the same bit patterns
// (NaN-propagating, as torch.max is; fmaxf would drop a NaN), gathered with
// one DSMEM atomicMax into CTA 0; the kept count an atomicAdd there.  One
// more sweep writes q and r (or recon and r) from shared memory: one launch,
// no HBM round trip between the steps.
//
// Above one cluster's size (the strided-sample threshold of transport.py's
// DGC path, or the int8 codec over a large vector) the encode is two
// streaming passes over x around one small launch, bound by the bytes of
// the passes (at 16.8M with a, b and c: 419 MB, against the 285 MB that
// the function's own operands are):
//   ef_pass1 reads a, b and c once with 16-byte loads on a grid that fills
//   the card (GRID_BLOCKS blocks, two chunks of 48 bytes a thread in
//   flight), stores x where pass 2 is to read it (into the residual's
//   buffer, the loads evict-first so that L2 keeps the x written last; not
//   where x is a itself), writes the select's input
//   x[off::stride] from the same registers (the sampled index tracked by
//   adds) and per-block max keys; for the int8 codec, whose threshold 0 is
//   known before any pass, also per-block kept counts.  It waits for
//   nothing.
//   ef_cluster, without sweep, selects over the gathered sample (stride 1,
//   16-byte loads from one buffer) and reduces the max keys into the scale
//   in the same launch (ef_reduce instead for the int8 codec: the scale
//   and kept, no select).  Only thresh and scale, 8 bytes, go on.
//   ef_pass2 reads x (4 bytes an element when pass 1 stored it; a itself
//   otherwise) from the end, so its first reads hit L2, writes q or recon
//   and r (in place over x), and counts
//   |x| >= thresh: into a counter pass 1 zeroed (one vector) or per-block
//   partials that one ef_reduce sums after every piece's pass 2 (a sharded
//   vector).  The kept count is an output only, so nothing waits for it.
// Three launches for one vector; for a vector sharded over D devices (a
// sharded server's link vectors, JAX's shard-local slices) a pass 1 and a
// pass 2 a shard, each on its shard's device, one select and (top-k) one
// sum of the kept partials on the home device: 2D + 2 (2D + 1 for int8).
// Each shard's pass 1 writes its share of the sample (global index order)
// and its partials straight into one buffer each on the home device where
// the shard lies there (a mesh repeating one card: no copy, no
// concatenation), else into its own buffers, copied there.  The radix
// select over the same multiset gives the same threshold bit for bit, and
// integer max and sum are exact in any order, so every output equals the
// unsharded encode's.
//
// Numerics: the explicit _rn intrinsics keep nvcc from contracting
// x - q * scale (or base + q * scale, in every decode: dequant) into an
// FMA, and x / scale is the
// correctly rounded division; rintf rounds half to even like jnp.round and
// torch.round.  The fused encode rounds as the plain chain does on the
// card: the scale is max(max|x|, 1e-12) times 1/127 rounded to f32, which
// is what PyTorch's CUDA `t / 127.0` (a division by a host scalar) and
// XLA's `x / 127.0` both compute; torch.clamp keeps a NaN, and a NaN cast
// to int8 is 0.  So every kernel is bit-exact against the plain PyTorch
// versions in ref.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pieces.cuh"

namespace cg = cooperative_groups;

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

// A decode launch's pieces (dequant_add on a device's pieces of a sharded
// vector; one piece unsharded): q, base and out of each in the pointer
// table (pieces.cuh: up to 32 pieces of 3 pointers, 768 bytes), blockIdx.y
// the piece, one scale for all.
template <class T>
__global__ void decode_kernel(const __grid_constant__ T g,
                              const float* __restrict__ scale, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int8_t* q = pieces::operand<const int8_t>(g, 0);
  const float* base = pieces::operand<const float>(g, 1);
  float* out = pieces::operand<float>(g, 2);
  // read-only loads (what __restrict__ pointer arguments would give)
  out[i] = __fadd_rn(__ldg(&base[i]), __fmul_rn((float)__ldg(&q[i]),
                                                __ldg(scale)));
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// ---- the fused EF encode ---------------------------------------------------

constexpr int kSelThreads = 1024;      // threads of a cluster CTA
constexpr unsigned kAbs = 0x7fffffffu;
constexpr float kThreshFloor = 1e-30f; // ref.THRESH_FLOOR
constexpr float kScaleFloor = 1e-12f;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr int kMaxSmem = 200 * 1024;   // dynamic shared memory a CTA may use
constexpr int kMaxCtas = 16;           // CTAs a cluster may have

struct EncodeArgs {
  const float* a;      // x = (a - b) + c; b and c may be null
  const float* b;
  const float* c;
  long long n;         // elements of x
  long long stride;    // the select runs over x[0], x[stride], ...
  long long m;         // ... m = ceil(n / stride) of them
  long long k;         // the threshold's rank among them (1: the largest);
                       // 0: no select, the threshold is 0 (the int8 codec)
  long long slice;     // sample elements a CTA holds (a multiple of 4)
  int sweep;           // 1 (stride 1): write the outputs, max and kept too;
                       // 0: write the threshold only
  int quantize;        // outputs q and r, else recon and r
  int vec;             // a, b, c 16-byte aligned and stride 1
  int8_t* q;
  float* recon;
  float* r;
  float* dec;          // quantize with sweep: b + q * scale as B4 decodes
                       // it (b re-read), or null
  float* thresh;       // 0-d outputs
  float* scale;
  int* kept;
};

__device__ __forceinline__ float x_at(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      const float* __restrict__ c,
                                      long long j) {
  float v = a[j];
  if (b) v = __fsub_rn(v, b[j]);
  if (c) v = __fadd_rn(v, c[j]);
  return v;
}

__device__ __forceinline__ float4 x_at4(const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        const float* __restrict__ c,
                                        long long j4) {
  float4 v = reinterpret_cast<const float4*>(a)[j4];
  if (b) {
    const float4 w = reinterpret_cast<const float4*>(b)[j4];
    v = make_float4(__fsub_rn(v.x, w.x), __fsub_rn(v.y, w.y),
                    __fsub_rn(v.z, w.z), __fsub_rn(v.w, w.w));
  }
  if (c) {
    const float4 w = reinterpret_cast<const float4*>(c)[j4];
    v = make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y),
                    __fadd_rn(v.z, w.z), __fadd_rn(v.w, w.w));
  }
  return v;
}

// x_at4 for the grid passes: with `stream`, the loads are evict-first
// (read once: they leave L2 to what pass 1 stores for pass 2)
__device__ __forceinline__ float4 ld4(const float* p, long long j4,
                                      bool stream) {
  const float4* q = reinterpret_cast<const float4*>(p) + j4;
  return stream ? __ldcs(q) : *q;
}

__device__ __forceinline__ float4 x_at4s(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         const float* __restrict__ c,
                                         long long j4, bool stream) {
  float4 v = ld4(a, j4, stream);
  if (b) {
    const float4 w = ld4(b, j4, stream);
    v = make_float4(__fsub_rn(v.x, w.x), __fsub_rn(v.y, w.y),
                    __fsub_rn(v.z, w.z), __fsub_rn(v.w, w.w));
  }
  if (c) {
    const float4 w = ld4(c, j4, stream);
    v = make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y),
                    __fadd_rn(v.z, w.z), __fadd_rn(v.w, w.w));
  }
  return v;
}

__device__ __forceinline__ unsigned key_of(float v) {
  return __float_as_uint(v) & kAbs;
}

// torch.clamp_min(t, lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float t, float lo) {
  return t < lo ? lo : t;
}

// q and r of one element as reference_topk_quant_encode computes them
__device__ __forceinline__ int8_t quant(float v, float t, float s, float* r) {
  float qf = rintf(__fdiv_rn(v, s));
  qf = qf < -127.f ? -127.f : (qf > 127.f ? 127.f : qf);   // NaN stays
  if (!(fabsf(v) >= t)) qf = 0.f;
  const int8_t qi = qf != qf ? (int8_t)0 : (int8_t)qf;
  *r = __fsub_rn(v, __fmul_rn((float)qi, s));
  return qi;
}

// the masked recon (returned) and r of one element (_mask_encode)
__device__ __forceinline__ float mask(float v, float t, float* r) {
  const float rec = fabsf(v) >= t ? v : 0.f;
  *r = __fsub_rn(v, rec);
  return rec;
}

// B4's decode of one element, b + q * scale: no FMA (decode_kernel's
// arithmetic, so a fused decode equals the chain that runs B4 after the
// encode bit for bit)
__device__ __forceinline__ float dequant(float b, int8_t q, float s) {
  return __fadd_rn(b, __fmul_rn((float)q, s));
}

__device__ __forceinline__ float4 dequant4(float4 b, char4 q, float s) {
  return make_float4(dequant(b.x, q.x, s), dequant(b.y, q.y, s),
                     dequant(b.z, q.z, s), dequant(b.w, q.w, s));
}

struct MaxOp {
  __device__ unsigned operator()(unsigned x, unsigned y) const {
    return x > y ? x : y;
  }
};
struct AddOp {
  __device__ unsigned operator()(unsigned x, unsigned y) const {
    return x + y;
  }
};

// the block's reduction of v, valid in every thread; red holds 32 words
template <class Op>
__device__ unsigned block_reduce(unsigned v, unsigned* red, Op op) {
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(~0u, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();                       // red is free
  if (l == 0) red[w] = v;
  __syncthreads();
  v = l < (int)(blockDim.x >> 5) ? red[l] : 0u;   // 0: identity of both
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// one digit pass: count the keys of xs[0..len) that match prefix under
// mask by their digit at shift, four keys a thread at a time, with plain
// shared atomics (on an H100 the hardware serialises a warp's colliding
// lanes faster than __match_any_sync aggregates them)
__device__ void build_hist(const float* xs, int len, unsigned* h,
                           unsigned prefix, unsigned msk, int shift) {
  const int n4 = len >> 2;
  for (int i4 = threadIdx.x; i4 < n4; i4 += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(xs)[i4];
    const unsigned k[4] = {key_of(v.x), key_of(v.y), key_of(v.z),
                           key_of(v.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((k[j] & msk) == prefix) atomicAdd(&h[(k[j] >> shift) & 0xffu], 1u);
  }
  for (int i = (n4 << 2) + threadIdx.x; i < len; i += blockDim.x) {
    const unsigned key = key_of(xs[i]);
    if ((key & msk) == prefix) atomicAdd(&h[(key >> shift) & 0xffu], 1u);
  }
}

// warp 0: the digit d with sum_{b > d} tot[b] < R <= sum_{b >= d} tot[b]
// (R counted from the top, 1-based), and R's rank within digit d
__device__ void find_digit(const unsigned* tot, unsigned R, unsigned* digit,
                           unsigned* rank) {
  const int l = threadIdx.x;             // lane l holds bins 255-8l .. 248-8l
  unsigned s = 0;
  for (int j = 0; j < 8; ++j) s += tot[255 - 8 * l - j];
  unsigned incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(~0u, incl, o);
    if (l >= o) incl += t;
  }
  unsigned cum = incl - s;
  if (cum < R && R <= incl) {
    for (int j = 0; j < 8; ++j) {
      const unsigned b = 255 - 8 * l - j, t = tot[b];
      if (R <= cum + t) {
        *digit = b;
        *rank = R - cum;
        break;
      }
      cum += t;
    }
  }
}

// kScale (the grid form's select, without sweep): the n_part max keys of
// part, pass 1's partials, reduced into the scale by CTA 0 as well; the
// cluster form itself is the kScale = false instance
template <bool kScale>
__global__ void __launch_bounds__(kSelThreads, 1)
    ef_cluster(const __grid_constant__ EncodeArgs p,
               const unsigned* __restrict__ part, long long n_part) {
  extern __shared__ float4 dyn[];
  float* xs = reinterpret_cast<float*>(dyn);
  __shared__ unsigned hist[2][256];
  __shared__ unsigned tot[256];
  __shared__ unsigned red[32];
  __shared__ unsigned s_max, s_kept, s_digit, s_rank;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned me = cluster.block_rank();
  const unsigned C = cluster.num_blocks();
  const int tid = threadIdx.x, T = blockDim.x;
  const long long lo = (long long)me * p.slice;
  const long long left = p.m - lo;
  const int len = (int)(left < 0 ? 0 : (left < p.slice ? left : p.slice));
  for (int i = tid; i < 512; i += T) (&hist[0][0])[i] = 0u;
  if (tid == 0) s_max = s_kept = 0u;

  // x (formed as the torch ops round it) into shared memory; its max key
  unsigned kmax = 0;
  if (p.vec) {
    const int n4 = len >> 2;
    for (int i4 = tid; i4 < n4; i4 += T) {
      const float4 v = x_at4(p.a, p.b, p.c, (lo >> 2) + i4);
      reinterpret_cast<float4*>(xs)[i4] = v;
      kmax = max(kmax, max(max(key_of(v.x), key_of(v.y)),
                           max(key_of(v.z), key_of(v.w))));
    }
    for (int i = (n4 << 2) + tid; i < len; i += T) {
      const float v = x_at(p.a, p.b, p.c, lo + i);
      xs[i] = v;
      kmax = max(kmax, key_of(v));
    }
  } else {
    for (int i = tid; i < len; i += T) {
      const float v = x_at(p.a, p.b, p.c, (lo + i) * p.stride);
      xs[i] = v;
      kmax = max(kmax, key_of(v));
    }
  }
  kmax = block_reduce(kmax, red, MaxOp());   // also publishes xs and hist
  const bool select = p.k > 0;
  if (select) build_hist(xs, len, hist[0], 0u, 0u, 24);
  cluster.sync();       // digit-0 histograms and CTA 0's counters are ready
  if (tid == 0) atomicMax(cluster.map_shared_rank(&s_max, 0), kmax);

  unsigned prefix = 0, msk = 0, R = (unsigned)p.k;
  if (select) {
    for (int d = 0; d < 4; ++d) {
      const int shift = 24 - 8 * d, buf = d & 1;
      if (d > 0) {
        if (d >= 2) {
          // its last remote readers (pass d - 2) passed the last barrier
          for (int i = tid; i < 256; i += T) hist[buf][i] = 0u;
          __syncthreads();
        }
        build_hist(xs, len, hist[buf], prefix, msk, shift);
        cluster.sync();
      }
      // the cluster's sum of bin b: every CTA's count loaded at once
      // (one DSMEM round trip, not one a CTA), then added in rank order
      for (int b = tid; b < 256; b += T) {
        unsigned v[kMaxCtas];
#pragma unroll
        for (int r = 0; r < kMaxCtas; ++r)
          v[r] = r < (int)C ? cluster.map_shared_rank(&hist[buf][0], r)[b]
                            : 0u;
        unsigned s = 0;
#pragma unroll
        for (int r = 0; r < kMaxCtas; ++r) s += v[r];
        tot[b] = s;
      }
      __syncthreads();
      if (tid < 32) find_digit(tot, R, &s_digit, &s_rank);
      __syncthreads();
      prefix |= s_digit << shift;
      msk |= 0xffu << shift;
      R = s_rank;
    }
  }
  const float t = select ? clamp_min_nan(__uint_as_float(prefix),
                                         kThreshFloor)
                         : 0.f;
  if (!p.sweep) {
    if constexpr (kScale) {
      if (me == 0) {
        unsigned km = 0;
        for (long long i = tid; i < n_part; i += T) km = max(km, part[i]);
        km = block_reduce(km, red, MaxOp());
        if (tid == 0)
          *p.scale = __fmul_rn(clamp_min_nan(__uint_as_float(km),
                                             kScaleFloor), kInv127);
      }
    }
    if (me == 0 && tid == 0) *p.thresh = t;
    cluster.sync();     // no CTA leaves while another reads its histograms
    return;
  }
  if (!select) cluster.sync();           // the atomicMax above has landed
  if (tid == 0) red[0] = *cluster.map_shared_rank(&s_max, 0);
  __syncthreads();
  const float s = p.quantize
      ? __fmul_rn(clamp_min_nan(__uint_as_float(red[0]), kScaleFloor),
                  kInv127)
      : 0.f;
  __syncthreads();

  // the sweep: outputs from shared memory, the kept count
  unsigned cnt = 0;
  const int n4 = len >> 2;
  for (int i4 = tid; i4 < n4; i4 += T) {
    const float4 v = reinterpret_cast<const float4*>(xs)[i4];
    const long long j4 = (lo >> 2) + i4;
    cnt += (fabsf(v.x) >= t) + (fabsf(v.y) >= t) + (fabsf(v.z) >= t) +
           (fabsf(v.w) >= t);
    float4 rr;
    if (p.quantize) {
      char4 qq;
      qq.x = quant(v.x, t, s, &rr.x);
      qq.y = quant(v.y, t, s, &rr.y);
      qq.z = quant(v.z, t, s, &rr.z);
      qq.w = quant(v.w, t, s, &rr.w);
      reinterpret_cast<char4*>(p.q)[j4] = qq;
      if (p.dec) {
        const long long j = j4 << 2;
        const float4 bb = p.vec ? reinterpret_cast<const float4*>(p.b)[j4]
                                : make_float4(p.b[j], p.b[j + 1], p.b[j + 2],
                                              p.b[j + 3]);
        reinterpret_cast<float4*>(p.dec)[j4] = dequant4(bb, qq, s);
      }
    } else {
      float4 rec;
      rec.x = mask(v.x, t, &rr.x);
      rec.y = mask(v.y, t, &rr.y);
      rec.z = mask(v.z, t, &rr.z);
      rec.w = mask(v.w, t, &rr.w);
      reinterpret_cast<float4*>(p.recon)[j4] = rec;
    }
    reinterpret_cast<float4*>(p.r)[j4] = rr;
  }
  for (int i = (n4 << 2) + tid; i < len; i += T) {
    const float v = xs[i];
    cnt += fabsf(v) >= t;
    float rr;
    if (p.quantize) {
      const int8_t qi = quant(v, t, s, &rr);
      p.q[lo + i] = qi;
      if (p.dec) p.dec[lo + i] = dequant(p.b[lo + i], qi, s);
    } else {
      p.recon[lo + i] = mask(v, t, &rr);
    }
    p.r[lo + i] = rr;
  }
  cnt = block_reduce(cnt, red, AddOp());
  if (tid == 0) atomicAdd(cluster.map_shared_rank(&s_kept, 0), cnt);
  cluster.sync();       // every count has landed; CTA 0's memory was read
  if (me == 0 && tid == 0) {
    *p.thresh = t;
    if (p.quantize) *p.scale = s;
    *p.kept = (int)s_kept;
  }
}

// ---- the grid form's passes ------------------------------------------------

constexpr int kPassThreads = 256;

struct Pass1Args {
  const float* a;      // x = (a - b) + c over this piece; b and c may be null
  const float* b;
  const float* c;
  long long n;         // elements of the piece
  long long off;       // sample[i] = x[off + i * stride] for i < m
  long long stride;
  long long m;
  float* sample;       // the piece's share of the select's input, or null
  float* x;            // x stored for pass 2, or null
  unsigned* part_max;  // per block max key, or null
  unsigned* part_kept; // per block count of |x| >= 0 (threshold 0), or null
  int* zero;           // set to 0 (the counter pass 2 adds to), or null
  int vec;             // a, b, c and x 16-byte aligned
};

// The sampled elements among the w values v of x at local indices p ..
// p + w - 1, where p - off = q * stride + r with 0 <= r < stride: element
// p + e is sampled when r + e is a multiple of stride (r + e < stride + 4,
// so one of 0, 1, 2, 3 times it), as element q + (r + e) / stride.
__device__ __forceinline__ void put_sample(float* sample, const float* v,
                                           int w, long long q, long long r,
                                           long long stride) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e >= w) break;
    const long long t = r + e;
    const int j = t == 0 ? 0 : t == stride ? 1 : t == 2 * stride ? 2
                : t == 3 * stride ? 3 : -1;
    if (j >= 0) sample[q + j] = v[e];
  }
}

// Pass 1: one streaming read of a, b and c (16-byte loads, U chunks of
// four a thread in flight: 2 with b or c, 4 with a alone), x formed as the
// torch ops round it; x stored where pass 2 is to read it (then a, b and c
// are loaded evict-first, so L2 keeps the x written last; where x is a,
// pass 2 reads a again, and its loads are plain); the piece's share of
// the select's input written from the same registers (the sampled index
// tracked by adds, no division a chunk); the per-block max key and, with
// the threshold known to be 0, the per-block kept count.  Nothing here
// waits for a threshold.
template <int U>
__global__ void __launch_bounds__(kPassThreads, 4)
    ef_pass1(const __grid_constant__ Pass1Args p) {
  __shared__ unsigned red[32];
  const long long T = (long long)gridDim.x * blockDim.x;
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  unsigned kmax = 0, cnt = 0;
  auto one = [&](long long j, float v) {       // a scalar element
    kmax = max(kmax, key_of(v));
    cnt += fabsf(v) >= 0.f;
    if (p.x) p.x[j] = v;
    if (p.sample && j >= p.off && (j - p.off) % p.stride == 0)
      p.sample[(j - p.off) / p.stride] = v;
  };
  if (p.vec) {
    const long long n4 = p.n >> 2;
    // chunk j4 starts at element 4 j4; a thread's chunks step by T
    const long long d = 4 * g - p.off;
    long long q = d >= 0 ? d / p.stride : -((p.stride - 1 - d) / p.stride);
    long long r = d - q * p.stride;       // floor division: 0 <= r < stride
    const long long dq = 4 * T / p.stride, dr = 4 * T - dq * p.stride;
    auto chunk = [&](long long j4, float4 v) {
      kmax = max(kmax, max(max(key_of(v.x), key_of(v.y)),
                           max(key_of(v.z), key_of(v.w))));
      cnt += (fabsf(v.x) >= 0.f) + (fabsf(v.y) >= 0.f) +
             (fabsf(v.z) >= 0.f) + (fabsf(v.w) >= 0.f);
      if (p.x) reinterpret_cast<float4*>(p.x)[j4] = v;
      if (p.sample) {
        const float e[4] = {v.x, v.y, v.z, v.w};
        put_sample(p.sample, e, 4, q, r, p.stride);
      }
      q += dq;
      r += dr;
      if (r >= p.stride) {
        r -= p.stride;
        ++q;
      }
    };
    const bool stream = p.x != nullptr;
    for (long long j4 = g; j4 < n4; j4 += U * T) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j4 + u * T < n4) v[u] = x_at4s(p.a, p.b, p.c, j4 + u * T, stream);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j4 + u * T >= n4) break;
        chunk(j4 + u * T, v[u]);
      }
    }
    for (long long j = (n4 << 2) + g; j < p.n; j += T)
      one(j, x_at(p.a, p.b, p.c, j));
  } else {
    for (long long j = g; j < p.n; j += T) one(j, x_at(p.a, p.b, p.c, j));
  }
  if (p.part_max) {
    kmax = block_reduce(kmax, red, MaxOp());
    if (threadIdx.x == 0) p.part_max[blockIdx.x] = kmax;
  }
  if (p.part_kept) {
    cnt = block_reduce(cnt, red, AddOp());
    if (threadIdx.x == 0) p.part_kept[blockIdx.x] = cnt;
  }
  if (p.zero && g == 0) *p.zero = 0;
}

struct Pass2Args {
  const float* x;      // x (pass 1's store, which r may be, or a itself)
  long long n;
  const float* ts;     // thresh, then scale (quantize): on this device
  int quantize;
  int8_t* q;
  float* recon;
  float* r;
  const float* base;   // quantize: dec = base + q * scale as B4 decodes it,
  float* dec;          // or both null
  unsigned* part_kept; // per block count of |x| >= thresh, or null
  int* kept;           // the count added here (zeroed by pass 1), or null
  int vec;             // x, q, recon, r, base and dec aligned for 16-byte
                       // access
};

// Pass 2: x read once more (4 bytes an element, four 16-byte loads a thread
// in flight), q or recon and r written, the kept count taken on the way.
// The chunks are walked from the end, so the first reads find the x that
// pass 1 wrote last still in L2; x is loaded and q, recon and r stored
// evict-first.  x and r may be one buffer: each element is read before it
// is written, by the same thread.
__global__ void __launch_bounds__(kPassThreads, 4)
    ef_pass2(const __grid_constant__ Pass2Args p) {
  __shared__ unsigned red[32];
  const long long T = (long long)gridDim.x * blockDim.x;
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const float t = p.ts[0];
  const float s = p.quantize ? p.ts[1] : 0.f;
  unsigned cnt = 0;
  long long tail = 0;
  if (p.vec) {
    constexpr int U = 4;
    const long long n4 = p.n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(p.x);
    for (long long j4 = g; j4 < n4; j4 += U * T) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j4 + u * T < n4) v[u] = __ldcs(x4 + (n4 - 1 - j4 - u * T));
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j4 + u * T >= n4) break;
        const long long i4 = n4 - 1 - j4 - u * T;
        cnt += (fabsf(v[u].x) >= t) + (fabsf(v[u].y) >= t) +
               (fabsf(v[u].z) >= t) + (fabsf(v[u].w) >= t);
        float4 rr;
        if (p.quantize) {
          char4 qq;
          qq.x = quant(v[u].x, t, s, &rr.x);
          qq.y = quant(v[u].y, t, s, &rr.y);
          qq.z = quant(v[u].z, t, s, &rr.z);
          qq.w = quant(v[u].w, t, s, &rr.w);
          __stcs(reinterpret_cast<char4*>(p.q) + i4, qq);
          if (p.dec)
            __stcs(reinterpret_cast<float4*>(p.dec) + i4,
                   dequant4(__ldcs(reinterpret_cast<const float4*>(p.base)
                                   + i4), qq, s));
        } else {
          float4 rec;
          rec.x = mask(v[u].x, t, &rr.x);
          rec.y = mask(v[u].y, t, &rr.y);
          rec.z = mask(v[u].z, t, &rr.z);
          rec.w = mask(v[u].w, t, &rr.w);
          __stcs(reinterpret_cast<float4*>(p.recon) + i4, rec);
        }
        __stcs(reinterpret_cast<float4*>(p.r) + i4, rr);
      }
    }
    tail = n4 << 2;
  }
  for (long long j = tail + g; j < p.n; j += T) {
    const float v = p.x[j];
    cnt += fabsf(v) >= t;
    float rr;
    if (p.quantize) {
      const int8_t qi = quant(v, t, s, &rr);
      p.q[j] = qi;
      if (p.dec) p.dec[j] = dequant(p.base[j], qi, s);
    } else {
      p.recon[j] = mask(v, t, &rr);
    }
    p.r[j] = rr;
  }
  if (p.part_kept || p.kept) {
    cnt = block_reduce(cnt, red, AddOp());
    if (threadIdx.x == 0) {
      if (p.part_kept) p.part_kept[blockIdx.x] = cnt;
      if (p.kept) atomicAdd(reinterpret_cast<unsigned*>(p.kept), cnt);
    }
  }
}

// One block: the max of n_max max keys into the scale, the sum of n_kept
// counts into kept, and the threshold 0 (each where its pointer is given).
__global__ void __launch_bounds__(kSelThreads)
    ef_reduce(const unsigned* __restrict__ part_max, long long n_max,
              const unsigned* __restrict__ part_kept, long long n_kept,
              float* thresh, float* scale, int* kept) {
  __shared__ unsigned red[32];
  unsigned kmax = 0, cnt = 0;
  for (long long i = threadIdx.x; i < n_max; i += blockDim.x)
    kmax = max(kmax, part_max[i]);
  for (long long i = threadIdx.x; i < n_kept; i += blockDim.x)
    cnt += part_kept[i];
  kmax = block_reduce(kmax, red, MaxOp());
  cnt = block_reduce(cnt, red, AddOp());
  if (threadIdx.x == 0) {
    if (thresh) *thresh = 0.f;
    if (scale)
      *scale = __fmul_rn(clamp_min_nan(__uint_as_float(kmax), kScaleFloor),
                         kInv127);
    if (kept) *kept = (int)cnt;
  }
}

// ---- one merge's decodes into the row buffer --------------------------------

// (decode, piece) pairs a launch: a merge's W decodes into the rows of one
// piece (unsharded) or of every piece a device holds (a sharded server's
// row buffer: piece j of decode i into piece j's row i), 3,344 bytes of
// parameters with the pieces' row pointers
constexpr int kRowsMax = 128;

struct RowsArgs {
  const int8_t* q[kRowsMax];     // pair e = piece * n_dec + row
  const float* base[kRowsMax];
  const float* scale[kRowsMax];  // by row: one scale a decode
  float4* rows[pieces::kMax];    // each piece's first row of this launch
  long long n4;                  // float4s a row
  int n_dec;  // rows decoded; the grid's rows after them are zeroed
};

// row blockIdx.y of piece blockIdx.z
__global__ void __launch_bounds__(kThreads)
    dequant_rows(const __grid_constant__ RowsArgs p) {
  const int row = blockIdx.y;
  const int piece = blockIdx.z;
  float4* out = p.rows[piece] + row * p.n4;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= p.n_dec) {
    for (; i < p.n4; i += step) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int e = piece * p.n_dec + row;
  const float s = *p.scale[row];
  const char4* q = reinterpret_cast<const char4*>(p.q[e]);
  const float4* b = reinterpret_cast<const float4*>(p.base[e]);
  for (; i < p.n4; i += step) {
    const char4 qq = q[i];
    const float4 bb = b[i];
    out[i] = make_float4(__fadd_rn(bb.x, __fmul_rn((float)qq.x, s)),
                         __fadd_rn(bb.y, __fmul_rn((float)qq.y, s)),
                         __fadd_rn(bb.z, __fmul_rn((float)qq.z, s)),
                         __fadd_rn(bb.w, __fmul_rn((float)qq.w, s)));
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dynamic shared memory of one cluster CTA over a sample of m elements
long long ef_cluster_smem(long long m, int ctas) {
  return ((m + ctas - 1) / ctas + 3) / 4 * 4 * 4;
}

// ef_cluster may take kMaxSmem of dynamic shared memory and 16 CTAs a
// cluster (the attributes persist: set once)
template <bool kScale>
cudaError_t opt_in_one() {
  cudaError_t r = cudaFuncSetAttribute(
      ef_cluster<kScale>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return r != cudaSuccess ? r : cudaFuncSetAttribute(
      ef_cluster<kScale>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaError_t opt_in() {
  static cudaError_t e = [] {
    const cudaError_t r = opt_in_one<false>();
    return r != cudaSuccess ? r : opt_in_one<true>();
  }();
  return e;
}

// the launch configuration of one cluster of ctas CTAs; attr is its storage
cudaLaunchConfig_t cluster_config(int ctas, long long smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kSelThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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

// ops: a host array of n * 3 card pointers, piece by piece (q (N,) int8,
// base (N,) f32, out (N,) f32); scale: 0-d f32; all on the stream's card.
// One launch every pieces::kMax pieces.
extern "C" int dequant_add_launch(const void* const* ops, int n,
                                  const float* scale, long long N,
                                  cudaStream_t stream) {
  if (N <= 0 || n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  return pieces::each<3>(ops, n, [&](const auto& t, int count) {
    using T = std::decay_t<decltype(t)>;
    decode_kernel<T><<<dim3(blocks_for(N), count), kThreads, 0, stream>>>(
        t, scale, N);
  });
}


// How many clusters of `ctas` CTAs with `smem` bytes of dynamic shared
// memory each the card can hold at once (0: none can be scheduled).
extern "C" int ef_cluster_max_active(int ctas, long long smem,
                                     int* clusters) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, ef_cluster<false>,
                                             &cfg);
}

// The cluster form: x = (a - b) + c over N elements (b, c may be null),
// the select over x[::stride]'s m elements at rank k (0: threshold 0), and
// with sweep (stride 1) q or recon, r, scale and kept, and with dec (sweep,
// quantize and b given; 16-byte aligned) the decoded b + q * scale; thresh
// always.  Without sweep, part (n_part max keys: pass 1's partials)
// reduced into the scale where given.  All pointers on the card;
// q/recon, r, dec (N,) and thresh, scale, kept 0-d.
extern "C" int ef_encode_cluster_launch(
    const float* a, const float* b, const float* c, long long N,
    long long stride, long long m, long long k, int sweep, int quantize,
    const unsigned* part, long long n_part, int8_t* q, float* recon,
    float* r, float* dec, float* thresh, float* scale, int* kept, int ctas,
    cudaStream_t stream) {
  const long long smem = ef_cluster_smem(m, ctas);
  if (N <= 0 || m <= 0 || ctas < 1 || ctas > kMaxCtas || k > m || k < 0 ||
      (sweep && (stride != 1 || part)) || (part && n_part < 1) ||
      smem > kMaxSmem ||
      (dec && (!sweep || !quantize || !b || !aligned16(dec))))
    return (int)cudaErrorInvalidValue;
  const int vec = stride == 1 && aligned16(a) && aligned16(b) &&
                  aligned16(c);
  const EncodeArgs p{a, b, c, N, stride, m, k,
                     smem / 4, sweep, quantize, vec, q, recon, r, dec,
                     thresh, scale, kept};
  cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, stream, &attr);
  e = part ? cudaLaunchKernelEx(&cfg, ef_cluster<true>, p, part, n_part)
           : cudaLaunchKernelEx(&cfg, ef_cluster<false>, p,
                                (const unsigned*)nullptr, 0LL);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The grid and sharded forms' passes (the select between them is the
// cluster launch above, without sweep, over the gathered sample).
// ef_encode_pass1_launch: over one piece's N elements (x = (a - b) + c;
// b, c may be null): sample[i] = x[off + i * stride] for i < m (sample
// null or m 0: none), x stored into x (or null), per-block max keys into
// part_max and counts of |x| >= 0 into part_kept (blocks each, or null),
// *zero = 0 (or null).
extern "C" int ef_encode_pass1_launch(
    const float* a, const float* b, const float* c, long long N,
    long long off, long long stride, long long m, float* sample, float* x,
    unsigned* part_max, unsigned* part_kept, int* zero, int blocks,
    cudaStream_t stream) {
  if (N <= 0 || blocks < 1 || off < 0 || stride < 1 || m < 0 ||
      (sample && m && off + (m - 1) * stride >= N))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(a) && aligned16(b) && aligned16(c) &&
                  aligned16(x);
  const Pass1Args p{a, b, c, N, off, stride, m, m ? sample : nullptr, x,
                    part_max, part_kept, zero, vec};
  if (b || c)
    ef_pass1<2><<<blocks, kPassThreads, 0, stream>>>(p);
  else
    ef_pass1<4><<<blocks, kPassThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// ef_encode_pass2_launch: q (int8) or recon and r (N,) from x (N,), which
// may be r itself, at the threshold ts[0] and (quantize) the scale ts[1];
// with quantize, dec = base + q * scale where both are given (N,);
// per-block counts of |x| >= ts[0] into part_kept (blocks, or null) or
// added to *kept (or null).
extern "C" int ef_encode_pass2_launch(
    const float* x, long long N, const float* ts, int quantize, int8_t* q,
    float* recon, float* r, const float* base, float* dec,
    unsigned* part_kept, int* kept, int blocks, cudaStream_t stream) {
  if (N <= 0 || blocks < 1 || !ts || !r || (quantize ? !q : !recon) ||
      (!base != !dec) || (dec && !quantize))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(x) && aligned16(r) && aligned16(recon) &&
                  aligned16(base) && aligned16(dec) &&
                  (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  const Pass2Args p{x, N, ts, quantize, q, recon, r, base, dec, part_kept,
                    kept, vec};
  ef_pass2<<<blocks, kPassThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// ef_encode_reduce_launch: one block; the scale from n_max max keys, kept
// from n_kept counts, thresh = 0 (each where its pointer is not null).
extern "C" int ef_encode_reduce_launch(const unsigned* part_max,
                                       long long n_max,
                                       const unsigned* part_kept,
                                       long long n_kept, float* thresh,
                                       float* scale, int* kept,
                                       cudaStream_t stream) {
  if (n_max < 0 || n_kept < 0 || (scale && !part_max) ||
      (kept && !part_kept))
    return (int)cudaErrorInvalidValue;
  ef_reduce<<<1, kSelThreads, 0, stream>>>(part_max, n_max, part_kept,
                                           n_kept, thresh, scale, kept);
  return (int)cudaGetLastError();
}

// rows: a host array of n_pieces card pointers, each piece's row buffer
// (>= n_dec + n_zero, N) f32, N % 4 == 0, 16-byte aligned; qs, bases: host
// arrays of n_dec * n_pieces card pointers, decode by decode and within
// one its pieces (q (N,) int8 4-byte aligned, base (N,) f32 16-byte
// aligned); scales: a host array of n_dec card pointers (0-d f32).
// Writes piece j's row i = base_ij + q_ij * scale_i and zeroes each
// piece's n_zero rows after them: one launch for every kRowsMax pairs of
// pieces::kMax pieces (the zeroing rides on the last).
extern "C" int dequant_add_rows_launch(const void* const* qs,
                                       const void* const* scales,
                                       const void* const* bases, int n_dec,
                                       int n_zero, const void* const* rows,
                                       int n_pieces, long long N,
                                       cudaStream_t stream) {
  if (N <= 0 || N % 4 || n_dec < 0 || n_zero < 0 || n_pieces < 1)
    return (int)cudaErrorInvalidValue;
  const long long n4 = N / 4;
  const unsigned gx = (unsigned)((n4 + kThreads - 1) / kThreads);
  for (int first = 0; first < n_pieces; first += pieces::kMax) {
    const int np = n_pieces - first < pieces::kMax ? n_pieces - first
                                                   : pieces::kMax;
    const int per = kRowsMax / np;   // decodes a launch
    int start = 0;
    do {
      const int dec = n_dec - start < per ? n_dec - start : per;
      const bool last = start + dec >= n_dec;
      const int height = dec + (last ? n_zero : 0);
      if (height == 0) break;
      if (height > 65535) return (int)cudaErrorInvalidValue;
      RowsArgs p;
      for (int j = 0; j < np; ++j) {
        p.rows[j] = static_cast<float4*>(const_cast<void*>(rows[first + j]))
                    + start * n4;
        if (!aligned16(p.rows[j])) return (int)cudaErrorInvalidValue;
      }
      for (int i = 0; i < dec; ++i) {
        p.scale[i] = static_cast<const float*>(scales[start + i]);
        for (int j = 0; j < np; ++j) {
          const long long src = (long long)(start + i) * n_pieces + first + j;
          const int e = j * dec + i;
          p.q[e] = static_cast<const int8_t*>(qs[src]);
          p.base[e] = static_cast<const float*>(bases[src]);
          if ((reinterpret_cast<uintptr_t>(p.q[e]) & 3) ||
              !aligned16(p.base[e]))
            return (int)cudaErrorInvalidValue;
        }
      }
      p.n4 = n4;
      p.n_dec = dec;
      dequant_rows<<<dim3(gx, height, np), kThreads, 0, stream>>>(p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      start += dec;
    } while (start < n_dec);
  }
  return (int)cudaSuccess;
}
