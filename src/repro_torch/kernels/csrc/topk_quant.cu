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
//   ef_encode_cluster_launch (+ ef_encode_stats_launch and
//   ef_encode_sweep_launch above one cluster's size): the whole error-
//       feedback top-k(+int8) encode of repro/core/transport.py
//       (ef_topk_encode: x = (a - b) + c, the k-th largest |x| as the
//       threshold, max|x| / 127 as the scale, the kept count, then q and r
//       or the masked recon and r), in one launch where the vector fits one
//       thread-block cluster's shared memory;
//   dequant_add_rows_launch: one merge's W decodes base_i + q_i * scale_i
//       straight into rows 0..W-1 of the server's row buffer, with the
//       stale rows after them zeroed, in one launch.
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
// DGC path, or the int8 codec over a large vector), ef_cluster selects over
// the sample only, then ef_grid_stats (per-block max key and kept count) and
// ef_grid_sweep (every block reduces the per-block partials, block 0 writes
// scale and kept) cover the full vector: three launches, no atomics, exact.
//
// A vector sharded over D devices (a sharded server's link vectors, JAX's
// shard-local slices) is encoded by the same pieces, split apart:
// ef_sample copies each shard's share of the select's input x[::stride]
// (global index order, x formed as above) into a small buffer; the pieces
// are concatenated on the home device, where one ef_cluster selects over
// them (stride 1, the same multiset, so the same threshold bit for bit);
// each shard runs ef_grid_stats on its own piece; the D shards' partials,
// concatenated in shard order, go to every device, and each shard's
// ef_grid_sweep reduces all D * blocks of them (n_part, in groups of
// `group` max keys then `group` counts), so every shard derives the same
// scale and kept: integer max and sum are exact in any order.  Only the
// sample (at most 1 MB) and the partials cross devices.
//
// Numerics: the explicit _rn intrinsics keep nvcc from contracting
// x - q * scale (or base + q * scale) into an FMA, and x / scale is the
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

// ---- the fused EF encode ---------------------------------------------------

constexpr int kSelThreads = 1024;      // threads of a cluster CTA
constexpr int kGridThreads = 256;      // threads of a grid-path block
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

__global__ void __launch_bounds__(kSelThreads, 1)
    ef_cluster(const __grid_constant__ EncodeArgs p) {
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
    if (p.quantize)
      p.q[lo + i] = quant(v, t, s, &rr);
    else
      p.recon[lo + i] = mask(v, t, &rr);
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

struct GridArgs {
  const float* a;
  const float* b;
  const float* c;
  long long n;
  const float* thresh_in;  // the selected threshold, or null: threshold 0
  unsigned* part;          // stats: per block max key [G], kept count [G]
  long long n_part;        // sweep: partials reduced, in groups of
  long long group;         // `group` max keys then `group` counts
  int quantize;
  int8_t* q;
  float* recon;
  float* r;
  float* thresh;           // 0-d outputs (thresh only when thresh_in is
  float* scale;            // null), written by block 0 when kept is not
  int* kept;               // null
};

__global__ void __launch_bounds__(kGridThreads)
    ef_grid_stats(const __grid_constant__ GridArgs p) {
  __shared__ unsigned red[32];
  const float t = p.thresh_in ? *p.thresh_in : 0.f;
  unsigned kmax = 0, cnt = 0;
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       j < p.n; j += (long long)gridDim.x * blockDim.x) {
    const float v = x_at(p.a, p.b, p.c, j);
    kmax = max(kmax, key_of(v));
    cnt += fabsf(v) >= t;
  }
  kmax = block_reduce(kmax, red, MaxOp());
  cnt = block_reduce(cnt, red, AddOp());
  if (threadIdx.x == 0) {
    p.part[blockIdx.x] = kmax;
    p.part[gridDim.x + blockIdx.x] = cnt;
  }
}

__global__ void __launch_bounds__(kGridThreads)
    ef_grid_sweep(const __grid_constant__ GridArgs p) {
  __shared__ unsigned red[32];
  const float t = p.thresh_in ? *p.thresh_in : 0.f;
  unsigned kmax = 0, cnt = 0;
  for (long long i = threadIdx.x; i < p.n_part; i += blockDim.x) {
    const long long g = i / p.group;
    const unsigned* pg = p.part + 2 * g * p.group;
    kmax = max(kmax, pg[i - g * p.group]);
    cnt += pg[p.group + i - g * p.group];
  }
  kmax = block_reduce(kmax, red, MaxOp());
  cnt = block_reduce(cnt, red, AddOp());
  const float s = p.quantize
      ? __fmul_rn(clamp_min_nan(__uint_as_float(kmax), kScaleFloor), kInv127)
      : 0.f;
  if (blockIdx.x == 0 && threadIdx.x == 0 && p.kept) {
    if (!p.thresh_in) *p.thresh = 0.f;
    if (p.quantize) *p.scale = s;
    *p.kept = (int)cnt;
  }
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       j < p.n; j += (long long)gridDim.x * blockDim.x) {
    const float v = x_at(p.a, p.b, p.c, j);
    float rr;
    if (p.quantize)
      p.q[j] = quant(v, t, s, &rr);
    else
      p.recon[j] = mask(v, t, &rr);
    p.r[j] = rr;
  }
}

// one shard's share of the select's input: out[i] = x[off + i * stride]
__global__ void __launch_bounds__(kGridThreads)
    ef_sample(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c, long long off, long long stride,
              long long m, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = x_at(a, b, c, off + i * stride);
}

// ---- one merge's decodes into the row buffer --------------------------------

constexpr int kRowsMax = 128;    // decodes a launch: 3 KB of parameters

struct RowsArgs {
  const int8_t* q[kRowsMax];
  const float* scale[kRowsMax];
  const float* base[kRowsMax];
  float4* rows;        // this launch's first row
  long long n4;        // float4s a row
  int n_dec;           // rows decoded; the grid's rows after them are zeroed
};

__global__ void __launch_bounds__(kThreads)
    dequant_rows(const __grid_constant__ RowsArgs p) {
  const int row = blockIdx.y;
  float4* out = p.rows + row * p.n4;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= p.n_dec) {
    for (; i < p.n4; i += step) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float s = *p.scale[row];
  const char4* q = reinterpret_cast<const char4*>(p.q[row]);
  const float4* b = reinterpret_cast<const float4*>(p.base[row]);
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
cudaError_t opt_in() {
  static cudaError_t e = [] {
    cudaError_t r = cudaFuncSetAttribute(
        ef_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    return r != cudaSuccess ? r : cudaFuncSetAttribute(
        ef_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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

// q: (N,) int8; scale: 0-d f32; base, out: (N,) f32, all on the card.
extern "C" int dequant_add_launch(const int8_t* q, const float* scale,
                                  const float* base, float* out, long long N,
                                  cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  decode_kernel<<<blocks_for(N), kThreads, 0, stream>>>(q, scale, base, out,
                                                         N);
  return (int)cudaGetLastError();
}


// How many clusters of `ctas` CTAs with `smem` bytes of dynamic shared
// memory each the card can hold at once (0: none can be scheduled).
extern "C" int ef_cluster_max_active(int ctas, long long smem,
                                     int* clusters) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, ef_cluster, &cfg);
}

// The cluster form: x = (a - b) + c over N elements (b, c may be null),
// the select over x[::stride]'s m elements at rank k (0: threshold 0), and
// with sweep (stride 1) q or recon, r, scale and kept; thresh always.  All
// pointers on the card; q/recon, r (N,) and thresh, scale, kept 0-d.
extern "C" int ef_encode_cluster_launch(
    const float* a, const float* b, const float* c, long long N,
    long long stride, long long m, long long k, int sweep, int quantize,
    int8_t* q, float* recon, float* r, float* thresh, float* scale,
    int* kept, int ctas, cudaStream_t stream) {
  const long long smem = ef_cluster_smem(m, ctas);
  if (N <= 0 || m <= 0 || ctas < 1 || ctas > kMaxCtas || k > m || k < 0 ||
      (sweep && stride != 1) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int vec = stride == 1 && aligned16(a) && aligned16(b) &&
                  aligned16(c);
  const EncodeArgs p{a, b, c, N, stride, m, k,
                     smem / 4, sweep, quantize, vec, q, recon, r,
                     thresh, scale, kept};
  cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, ef_cluster, p);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The grid and sharded forms' pieces.  A vector above one cluster's size
// is encoded, after a select (thresh_in on the card) or with threshold 0
// (thresh_in null), by a stats launch and a sweep launch with n_part =
// group = blocks.  A sharded vector takes a sample launch, a stats launch
// and a sweep launch a shard, each on the shard's device and stream, the
// sweep reducing every shard's partials.
// ef_encode_sample_launch: out[i] = x[off + i * stride] for i < m, over
// the shard's N elements (x = (a - b) + c; b, c may be null).
extern "C" int ef_encode_sample_launch(const float* a, const float* b,
                                       const float* c, long long N,
                                       long long off, long long stride,
                                       long long m, float* out,
                                       cudaStream_t stream) {
  if (N <= 0 || off < 0 || stride < 1 || m < 1 ||
      off + (m - 1) * stride >= N)
    return (int)cudaErrorInvalidValue;
  const long long want = (m + kGridThreads - 1) / kGridThreads;
  const unsigned blocks = (unsigned)(want < 1024 ? want : 1024);
  ef_sample<<<blocks, kGridThreads, 0, stream>>>(a, b, c, off, stride, m,
                                                  out);
  return (int)cudaGetLastError();
}

// ef_encode_stats_launch: the shard's per-block max key and kept count at
// the threshold *thresh_in (null: 0) into part (2 * blocks unsigned).
extern "C" int ef_encode_stats_launch(const float* a, const float* b,
                                      const float* c, long long N,
                                      const float* thresh_in, unsigned* part,
                                      int blocks, cudaStream_t stream) {
  if (N <= 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  const GridArgs p{a, b, c, N, thresh_in, part, 0, 0, 0,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  ef_grid_stats<<<blocks, kGridThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// ef_encode_sweep_launch: the shard's q or recon and r, from the scale and
// kept count that the n_part partials of part give (in groups of `group`
// max keys then `group` counts: every shard's stats, in shard order);
// thresh (when thresh_in is null), scale and kept written when kept is
// not null (the home shard's launch).
extern "C" int ef_encode_sweep_launch(
    const float* a, const float* b, const float* c, long long N,
    const float* thresh_in, const unsigned* part, long long n_part,
    long long group, int blocks, int quantize, int8_t* q, float* recon,
    float* r, float* thresh, float* scale, int* kept, cudaStream_t stream) {
  if (N <= 0 || blocks < 1 || group < 1 || n_part < 1 || n_part % group)
    return (int)cudaErrorInvalidValue;
  const GridArgs p{a, b, c, N, thresh_in, const_cast<unsigned*>(part),
                   n_part, group, quantize, q, recon, r, thresh, scale,
                   kept};
  ef_grid_sweep<<<blocks, kGridThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// rows: (>= n_dec + n_zero, N) f32 on the card, N % 4 == 0, 16-byte
// aligned; qs, scales, bases: host arrays of n_dec card pointers (q (N,)
// int8 4-byte aligned, scale 0-d f32, base (N,) f32 16-byte aligned).
// Writes rows[i] = base_i + q_i * scale_i and zeroes the n_zero rows after
// them: one launch for every kRowsMax decodes (the zeroing rides on the
// last).
extern "C" int dequant_add_rows_launch(const void* const* qs,
                                       const void* const* scales,
                                       const void* const* bases, int n_dec,
                                       int n_zero, float* rows, long long N,
                                       cudaStream_t stream) {
  if (N <= 0 || N % 4 || n_dec < 0 || n_zero < 0 || !aligned16(rows))
    return (int)cudaErrorInvalidValue;
  const long long n4 = N / 4;
  const unsigned gx = (unsigned)((n4 + kThreads - 1) / kThreads);
  int start = 0;
  do {
    const int dec = n_dec - start < kRowsMax ? n_dec - start : kRowsMax;
    const bool last = start + dec >= n_dec;
    const int height = dec + (last ? n_zero : 0);
    if (height == 0) break;
    if (height > 65535) return (int)cudaErrorInvalidValue;
    RowsArgs p;
    for (int i = 0; i < dec; ++i) {
      p.q[i] = static_cast<const int8_t*>(qs[start + i]);
      p.scale[i] = static_cast<const float*>(scales[start + i]);
      p.base[i] = static_cast<const float*>(bases[start + i]);
      if ((reinterpret_cast<uintptr_t>(p.q[i]) & 3) || !aligned16(p.base[i]))
        return (int)cudaErrorInvalidValue;
    }
    p.rows = reinterpret_cast<float4*>(rows) + start * n4;
    p.n4 = n4;
    p.n_dec = dec;
    dequant_rows<<<dim3(gx, height), kThreads, 0, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    start += dec;
  } while (start < n_dec);
  return (int)cudaSuccess;
}
