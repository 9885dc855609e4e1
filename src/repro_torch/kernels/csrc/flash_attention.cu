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
// The training pair (causal attention with a backward, flash_train_*_launch)
// is described at namespace tr, below; it replaces no TPU kernel.
//
// Two bodies.  flash_attention_launch picks one by dtype and head_dim alone
// (wgmma_body), never on a failure:
//   bf16 with D in {64, 112, 128, 256}  ->  flash_wgmma, on the tensor cores;
//   f32, and bf16 with D in {16, 32}  ->  flash_fwd, SIMT f32.
// D = 112 is zamba2-7b's head (3584 / 32): 7 x 16, so its second 64-column
// chunk of the wgmma body is filled to 48 columns, the rest zero (below).
//
// Bound on the card: operations.  A prefill at gemma2-2b's width (B=2,
// S=8192, H=8, D=256) does 4*D flops per (query, visible key) pair, 5.5e11
// flops per causal layer, against ~0.2 GB of q/k/v/o traffic in bf16: about
// 2,700 flops per byte, far above the H100's ~295 (bf16 tensor cores).
//
// flash_wgmma.  Both products run on the tensor cores (wgmma.mma_async
// m64n64k16, bf16 operands, f32 accumulation):
//   S = Q K^T with Q and K in shared memory.  A bf16 x bf16 product is exact
//     in f32, so this is the reference's f32 dot product up to the order of
//     the sum.  1/sqrt(D) is applied to S in f32 afterwards: one rounding
//     away from scaling q first, and none at D = 256, where it is 2^-4.
//   O += P V with P kept to f32 accuracy.  Each p is split in registers
//     into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and two wgmmas (A from
//     registers, V from shared memory with the transpose bit, since V is
//     (keys, D) with D contiguous) add p_hi V and p_lo V into one f32
//     accumulator.  |p - p_hi - p_lo| <= 2^-16 p, so the output stays far
//     inside one bf16 ulp of the plain version.  A single bf16 P computes
//     another function (the card check rejects it); the split costs 1.5x
//     the tensor work of a bf16-P kernel.
// Softcap (the accurate tanhf: tanh.approx's 2^-11 error is 2% of p at cap
// 50), mask, row max and row sum across the quad of threads that own a row
// of the accumulator, expf and the rescale of O stay in f32 registers, as
// do (m, l).  The reference's exp and final division are kept (no fast
// math); s / softcap is taken as s * (1 / softcap), at most an ulp from the
// quotient, since an IEEE division a score cost a fifth of the kernel's
// time at gemma2's shape (H100).  The softcap's tanhf is still ~0.8 ms of
// its ~2.3 (a body without it runs in ~1.5 ms).
//
// Block: per (64 x WGS query rows, head, batch), WGS consumer warpgroups
// of 64 rows each and one producer warpgroup, whose first thread issues
// TMA loads of Q (once) and of K/V tiles of 64 keys into a ring of stages
// in shared memory, each guarded by a full and an empty mbarrier.  TMA
// writes 128-byte rows with the 128-byte swizzle, the layout the wgmma
// descriptors read: K-major for Q and K, MN-major (transposed) for V.  The
// tensor maps are encoded per call through cudaGetDriverEntryPoint, so the
// build needs no -lcuda.  setmaxnreg moves registers from the producer to
// the consumers.  Per consumer thread and per block:
//   D = 256: 2 consumers of 240 registers (producer 24): O 128 + S 32 +
//            P hi/lo 32; Q 64 KB + 2 stages of K and V (64 KB each) =
//            192 KB of shared memory;
//   D = 128: 3 consumers of 160 (producer 32): O 64 + 32 + 32; Q 48 KB +
//            4 stages of 32 KB = 176 KB;
//   D = 112: as D = 128 (two chunks, the second padded);
//   D =  64: 3 consumers of 160: O 32 + 32 + 32; Q 24 KB + 4 stages of
//            16 KB = 88 KB.
// D = 112 (7 x 16 columns) takes whole 128-byte chunks too: the TMA box
// at column 64 reads columns 64..111 and zero-fills 112..127 (the map's
// first dimension is D), and its full box still counts in the stage's
// bytes, as the zero-filled rows >= S and keys >= T do.  S = Q K^T runs
// D / 16 = 7 k-steps, none on the padding.  O += P V runs m64n64k16 on V's
// first chunk and m64n48k16 on its second (an MN-major B of 48 columns
// with the 128-byte swizzle: within one bf16 ulp of the plain version on
// an H100, and 3% faster at zamba2-7b's shape than n64 on both chunks),
// so no tensor work is spent on the padding either; the accumulator's
// padded columns stay zero and are never stored.
// A consumer runs QK^T, softmax and PV in series; the other consumers'
// tensor work overlaps its softmax (a third consumer took yi-9b's shape
// from 1.21 to 1.03 ms on an H100).
// Band: a block loads only the KV tiles its rows can see, lo = max(0,
// (q0 - window + 1) / 64) and, when causal, hi = min(n_k, cdiv(q0 +
// 64 WGS, 64)).  A consumer computes only on the tiles of its own 64
// rows' band (it waits on and releases the others), and masks only the
// tiles that cross the diagonal, the window's edge or T.  Causal blocks
// are numbered longest band first, so the triangle's short tail fills the
// last wave.  Rows >= S are zero-filled by TMA and never written; keys
// >= T are zero-filled and masked.  Strides and the base address must be
// multiples of 16 bytes (the wrapper makes a contiguous copy of an
// operand that is not).
//
// flash_fwd.  Keeps every score, P and accumulator in f32 on the f32 FMA
// units: f32 q/k/v are not exact in bf16, and D < 64 is narrower than the
// swizzled 128-byte rows of the wgmma body.  Bound by f32 FMA throughput
// and shared-memory bandwidth, far from the bf16 bound.
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
#include <cuda.h>          // CUtensorMap and its enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  // output columns per load: float4 where D is a multiple of 64; D = 112
  // (16 lanes x 7 columns, f32 only) and D < 64 load one float at a time
  static constexpr int VEC = D % 64 == 0 ? 4 : 1;
  static constexpr int NC = D / (16 * VEC);     // column groups per thread
  static_assert(D % (16 * VEC) == 0 && D % 4 == 0, "D: 16 lanes x NC x VEC");
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
    case 112: return launch<112, T>(a, B, H, stream);
    case 128: return launch<128, T>(a, B, H, stream);
    case 256: return launch<256, T>(a, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// flash_wgmma: the tensor-core body for bf16 at D in {64, 112, 128, 256}.
namespace tc {

constexpr int kRows = 64;                  // query rows per consumer
constexpr int kBK = 64;                    // keys per KV tile
constexpr int kChunk = 64 * 128;           // 64 rows of 128 bytes (64 bf16)

template <int D>
struct Cfg {
  // consumer warpgroups: D = 256's O takes 128 registers a thread, so two
  // (240 registers each); three below (160 each); one producer warpgroup
  static constexpr int WGS = D >= 256 ? 2 : 3;
  static constexpr int CONSUMER_REGS = WGS == 2 ? 240 : 160;
  static constexpr int PRODUCER_REGS = WGS == 2 ? 24 : 32;
  static constexpr int BQ = kRows * WGS;   // query rows per block
  static constexpr int THREADS = 128 * (WGS + 1);
  // 128-byte column chunks, the last zero-filled past D (D = 112: 2)
  static constexpr int NC = (D + 63) / 64;
  static_assert(D % 64 == 0 || D % 64 == 48,
                "a padded chunk holds 48 columns (mma_rs48)");
  static constexpr int STAGES = D >= 256 ? 2 : 4;
  static constexpr int Q_BYTES = NC * kChunk;     // one consumer's Q tile
  static constexpr int KV_BYTES = NC * kChunk;    // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // 1024 to align the tiles (the swizzle's period), then the mbarriers
  static constexpr size_t SMEM = 1024 + WGS * Q_BYTES +
                                 STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

struct Args {
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;              // strides in elements
  int S, T, H, B, rep, n_qb, causal, window;
  float scale, softcap, inv_softcap;
  float* lse;          // the training form's rows' log-sum-exp, (B, H, S)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of {64 columns, 1 head, 64 rows, 1 batch} into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused, 16; MN-major: the stride between 64-column
// chunks) and stride byte offset (1024: the next 8 rows of 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads of wgmma registers across the wait
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both bf16 from shared
// memory, K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64, bf16 in
// shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same into the first 48 columns of d (a padded chunk: D = 112's
// second); d's last 8 registers are untouched
__device__ __forceinline__ void mma_rs48(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
      "%28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// d += A B over a 64-column chunk of V, or its first 48 when it is padded
__device__ __forceinline__ void pv(float (&d)[32], const uint32_t (&a)[4],
                                   uint64_t db, bool padded) {
  if (padded)
    mma_rs48(d, a, db);
  else
    mma_rs(d, a, db);
}

// An accumulator tile x (64 x 64, f32) as wgmma A fragments (16 columns
// kk each): register r of kk holds row row + 8 (r % 2), columns 16 kk +
// 8 (r / 2) + cq, + 1, the accumulator's 8-column group 2 kk + r / 2.
// frags rounds x to bf16 once; split_frags keeps it to f32 accuracy as
// hi = bf16(x) and lo = bf16(x - hi), |x - hi - lo| <= 2^-16 |x|.
__device__ __forceinline__ int frag_elem(int kk, int r) {
  return 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
}
__device__ __forceinline__ void frags(const float (&x)[32],
                                      uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = frag_elem(kk, r);
      f[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x[e], x[e + 1]));
    }
}
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = frag_elem(kk, r);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[e], x[e + 1]);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(
          x[e] - __low2float(h2), x[e + 1] - __high2float(h2));
      hi[kk][r] = bf16x2_bits(h2);
      lo[kk][r] = bf16x2_bits(l2);
    }
}

// The KV tiles [lo, hi) that the query rows [r0, r0 + rows) can see.
__device__ __forceinline__ void band(const Args& a, int r0, int rows,
                                     int& lo, int& hi) {
  const int n_k = (a.T + kBK - 1) / kBK;
  hi = a.causal ? min(n_k, (r0 + rows + kBK - 1) / kBK) : n_k;
  lo = a.window > 0 ? max(0, (r0 - a.window + 1) / kBK) : 0;
}

template <int D, bool kTrain>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Cfg<D>;
  constexpr int NC = C::NC, ST = C::STAGES, kWGs = C::WGS, kBQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                          // kWGs Q tiles
  const uint32_t kv_s = base + kWGs * C::Q_BYTES;     // ST x (K, V)
  const uint32_t bars = kv_s + ST * C::STAGE_BYTES;   // full, empty, Q
  const uint32_t qbar = bars + 16 * ST;

  // block -> (query tile, head, batch); causal: longest band first
  const int hb = a.H * a.B, bid = blockIdx.x;
  const int qt = a.causal ? a.n_qb - 1 - bid / hb : bid / hb;
  const int h = (bid % hb) % a.H, b = (bid % hb) / a.H, kvh = h / a.rep;
  const int q0 = qt * kBQ;
  int lo_b, hi_b, lo, hi;
  band(a, q0, min(kBQ, a.S - q0), lo_b, hi_b);
  const int n_valid = min(kWGs, (a.S - q0 + kRows - 1) / kRows);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's arrival
      mbar_init(bars + 8 * (ST + s), kWGs * 4);    // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWGs) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     C::PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == kWGs * 128) {
      mbar_expect_tx(qbar, n_valid * C::Q_BYTES);
      for (int w = 0; w < n_valid; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(q_s + w * C::Q_BYTES + c * kChunk, &tq, qbar, 64 * c, h,
                   q0 + kRows * w, b);
      for (int t = lo_b, i = 0; t < hi_b; ++t, ++i) {
        const int s = i % ST, r = i / ST;
        if (r > 0) mbar_wait(bars + 8 * (ST + s), (r - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t ks = kv_s + s * C::STAGE_BYTES;
        mbar_expect_tx(full, C::STAGE_BYTES);
        for (int c = 0; c < NC; ++c) {
          tma_load(ks + c * kChunk, &tk, full, 64 * c, kvh, t * kBK, b);
          tma_load(ks + C::KV_BYTES + c * kChunk, &tv, full, 64 * c, kvh,
                   t * kBK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r0 .. r0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   C::CONSUMER_REGS)
               : "memory");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + kRows * wg;
  const bool valid = wg < n_valid;
  band(a, r0, kRows, lo, hi);
  if (!valid) hi = lo;
  // this thread's accumulator rows row and row + 8; columns cq, cq + 1 of
  // every 8-column group
  const int row = r0 + 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const uint32_t qa = q_s + wg * C::Q_BYTES;

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  if (valid) mbar_wait(qbar, 0);

  for (int t = lo_b, i = 0; t < hi_b; ++t, ++i) {
    const int s = i % ST;
    mbar_wait(bars + 8 * s, (i / ST) & 1);
    if (t >= lo && t < hi) {
      const uint32_t ks = kv_s + s * C::STAGE_BYTES, vs = ks + C::KV_BYTES;
      const int k0 = t * kBK;

      // S = Q K^T: D / 16 steps of k16 (32 bytes along a 128-byte row),
      // so none reads a chunk's zero padding
      float sc[32];
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) sc[i2] = 0.0f;
      wg_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const uint32_t off = (j / 4) * kChunk + (j % 4) * 32;
        mma_ss(sc, sw128_desc(qa + off, 16), sw128_desc(ks + off, 16),
               j > 0);
      }
      wg_commit();
      wg_wait_all();
      hold(sc);

      // scale, softcap, mask; sc[4j + e] is row row + 8 (e / 2), key
      // k0 + 8 j + cq + e % 2
      const bool whole = k0 + kBK <= a.T &&
                         (!a.causal || k0 + kBK - 1 <= r0) &&
                         (a.window <= 0 || r0 + kRows - 1 - k0 < a.window);
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * a.scale;
          if (a.softcap > 0.0f) x = a.softcap * tanhf(x * a.inv_softcap);
          if (!whole) {
            const int qpos = row + 8 * (e >> 1);
            const int kpos = k0 + 8 * j + cq + (e & 1);
            bool ok = kpos < a.T;
            if (a.causal) ok = ok && qpos >= kpos;
            if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
            x = ok ? x : kNegInf;
          }
          sc[4 * j + e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      float corr[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[4 * j + e] - m[e >> 1]);
          sc[4 * j + e] = p;
          ps[e >> 1] += p;
        }
      // l is this thread's share of the row sum; the quad adds at the end
      l[0] = l[0] * corr[0] + ps[0];
      l[1] = l[1] * corr[1] + ps[1];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) o[c][i2] *= corr[(i2 >> 1) & 1];

      // P as wgmma A fragments, p = p_hi + p_lo: for keys 16 kk .. 16 kk +
      // 15, register r holds row row + 8 (r % 2), keys 16 kk + 8 (r / 2) +
      // cq, + 1: the accumulator's 8-column group 2 kk + r / 2
      // (the training form: P rounded to bf16 once, p_hi alone)
      uint32_t phi[4][4], plo[4][4];
      if constexpr (kTrain)
        frags(sc, phi);
      else
        split_frags(sc, phi, plo);

      // O += p_hi V + p_lo V: V's 16 keys kk at 2048 kk bytes, its
      // 64-column chunk c at c * kChunk (D = 112's second chunk: n48)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          pv(o[c], phi[kk], sw128_desc(vs + c * kChunk + kk * 2048, kChunk),
             64 * c + 64 > D);
      if constexpr (!kTrain) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            pv(o[c], plo[kk],
               sw128_desc(vs + c * kChunk + kk * 2048, kChunk),
               64 * c + 64 > D);
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) hold(o[c]);
      hold(phi);
      if constexpr (!kTrain) hold(plo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (ST + s));   // release stage s
  }

  if (!valid) return;
  __nv_bfloat16* og = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = row + 8 * r;
    if (qpos >= a.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    if (kTrain && (lane & 3) == 0)
      a.lse[((long long)b * a.H + h) * a.S + qpos] = m[r] + logf(den);
    __nv_bfloat16* orow = og + qpos * a.o_ss + cq;
    // the 8-column groups below D (D = 112: 6 of chunk 1's 8)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * c + 8 * j < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * j) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * r] / den,
                                    o[c][4 * j + 2 * r + 1] / den);
  }
}

// cuTensorMapEncodeTiled, found at run time (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, heads, D) bf16 with unit stride along D as a 4-d map {D, heads,
// S, B} whose box is 64 columns x 64 rows of one head, 128-byte swizzled;
// columns >= D, rows >= S are zero-filled.
// cuTensorMapEncodeTiled encodes in the calling thread's current context; a
// host thread that has made no runtime call yet has none (the encode
// fails with CUDA_ERROR_INVALID_CONTEXT): autograd's worker thread can
// reach the training pair's backward so.  So the thread is first bound to
// the device that holds ptr, which makes its primary context current.
int make_map(CUtensorMap* map, const void* ptr, long long D,
             long long heads, long long S, long long B, long long s_b,
             long long s_s, long long s_h) {
  cudaPointerAttributes at;
  cudaError_t err = cudaPointerGetAttributes(&at, ptr);
  if (err == cudaSuccess) err = cudaSetDevice(at.device);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, 1, kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool kTrain = false>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, Args a, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::SMEM;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma<D, kTrain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  a.n_qb = (a.S + Cfg<D>::BQ - 1) / Cfg<D>::BQ;
  const unsigned grid = (unsigned)a.n_qb * a.H * a.B;
  flash_wgmma<D, kTrain><<<grid, Cfg<D>::THREADS, smem, stream>>>(tq, tk,
                                                                   tv, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The training pair: causal attention under autograd, bf16 q/k/v at D 64
// and 128, S a multiple of 64, every operand contiguous (B, S, heads, D).
//
// Forward: flash_wgmma<D, true> (above): P rounded to bf16 once before
// P V, as mha_chunked and the reference round it, and the rows'
// log-sum-exp, lse = m + log(l), written f32 (B, H, S) for the backward.
//
// Backward, two launches in stream order, no atomics, every sum in a
// fixed order (bit for bit run to run):
//   flash_bwd_dq, a block per (query tile of 64 WGS rows, head, batch):
//     D = rowsum(dO o O) in f32 (written (B, H, S) for the next launch),
//     then over the KV tiles its rows see: S = Q K^T, dP = dO V^T (both
//     from shared memory), P = exp(S scale - lse), dS = P (dP - D), and
//     dQ += dS K as two wgmmas over dS's hi and lo bf16 terms (dS to f32
//     accuracy, as the parent's autograd multiplies an f32 dS); dQ =
//     scale dQ, cast to bf16 once.
//   flash_bwd_dkv, a block per (KV tile of 64 WGS keys, KV head, batch):
//     K and V stay in shared memory; over the query heads of the KV head
//     and the query tiles that see its keys: S^T = K Q^T, dP^T = V dO^T,
//     P^T = exp(S^T scale - lse), dV += bf16(P^T) dO, dS^T = P^T (dP^T -
//     D), dK += dS^T Q over hi and lo; dK = scale dK and dV cast to bf16
//     once, so GQA's sum over query heads stays in f32 registers.
// Every product is a wgmma m64n64k16 with f32 accumulation on bf16
// operands: the QK^T-shaped ones K-major from shared memory (as B8's S),
// the P V-shaped ones with A from registers (the accumulator's layout,
// frags / split_frags) and B MN-major (the transpose bit, as B8's V).
// Bound: operations.  At musicgen-medium's shape (B 8, S 1024, H 24, D 64)
// a causal GEMM is ~1.4e10 FLOP; the forward does 2 and the backward 9
// (S and dP twice, dV, dQ and dK over hi and lo).
namespace tr {

using tc::kBK;
using tc::kChunk;
using tc::kRows;

template <int D>
struct DqCfg {
  static constexpr int WGS = D >= 128 ? 2 : 3;
  static constexpr int CONSUMER_REGS = WGS == 2 ? 240 : 160;
  static constexpr int PRODUCER_REGS = WGS == 2 ? 24 : 32;
  static constexpr int BQ = kRows * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int NC = D / 64;
  static constexpr int STAGES = 4;
  static constexpr int TILE = NC * kChunk;         // 64 rows of D
  static constexpr int STAGE_BYTES = 2 * TILE;     // K and V
  static constexpr size_t SMEM = 1024 + 2 * WGS * TILE +
                                 STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
struct DkvCfg {
  // dK and dV take 2 D / 2 registers a thread: two consumers of 240
  static constexpr int WGS = 2;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int BK = kRows * WGS;           // keys per block
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int NC = D / 64;
  static constexpr int STAGES = 4;
  static constexpr int TILE = NC * kChunk;
  static constexpr int STAGE_BYTES = 2 * TILE;     // Q and dO
  static constexpr int ROW_BYTES = 2 * kRows * 4;  // lse and D of 64 rows
  static constexpr size_t SMEM = 1024 + 2 * WGS * TILE +
                                 STAGES * (STAGE_BYTES + ROW_BYTES) +
                                 8 * (2 * STAGES + 1);
};

struct Args {
  const __nv_bfloat16* o;        // (B, S, H, D)
  const __nv_bfloat16* dout;     // (B, S, H, D)
  const float* lse;              // (B, H, S)
  float* dlt;                    // (B, H, S): rowsum(dO o O)
  __nv_bfloat16* dq;             // (B, S, H, D)
  __nv_bfloat16* dk;             // (B, S, Kv, D)
  __nv_bfloat16* dv;             // (B, S, Kv, D)
  int S, H, Kv, B, rep, n_blk;
  float scale;
};

// count bytes from global to shared memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// acc (64 x 64) (+)= A B^T over D / 16 k-steps, A and B 64-row tiles of D
// columns in shared memory, K-major (B8's S = Q K^T)
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint32_t off = (j / 4) * kChunk + (j % 4) * 32;
    tc::mma_ss(acc, tc::sw128_desc(a + off, 16), tc::sw128_desc(b + off, 16),
               j > 0);
  }
}

// acc[c] += A B for every 64-column chunk c of B: A (64 x 64) as fragments,
// B 64 rows of D columns in shared memory, MN-major (B8's P V)
template <int NC>
__device__ __forceinline__ void mma_cols(float (&acc)[NC][32],
                                         const uint32_t (&f)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tc::mma_rs(acc[c], f[kk],
                 tc::sw128_desc(b + c * kChunk + kk * 2048, kChunk));
}

// this thread's two rows (row, row + 8) of a 64-column tile, as bf16 pairs
// scaled by s, stored at base + pos * ld (pos the row's position)
template <int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld,
                                           int row, int cq,
                                           const float (&acc)[NC][32],
                                           float s) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* p = base + (long long)(row + 8 * r) * ld + cq;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(p + 64 * c + 8 * j) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * s,
                                  acc[c][4 * j + 2 * r + 1] * s);
  }
}

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const Args a) {
  using C = DqCfg<D>;
  constexpr int NC = C::NC, ST = C::STAGES, kWGs = C::WGS, kBQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                          // kWGs Q tiles
  const uint32_t do_s = q_s + kWGs * C::TILE;         // kWGs dO tiles
  const uint32_t kv_s = do_s + kWGs * C::TILE;        // ST x (K, V)
  const uint32_t bars = kv_s + ST * C::STAGE_BYTES;   // full, empty, Q
  const uint32_t qbar = bars + 16 * ST;

  // block -> (query tile, head, batch), longest band first
  const int hb = a.H * a.B, bid = blockIdx.x;
  const int qt = a.n_blk - 1 - bid / hb;
  const int h = (bid % hb) % a.H, b = (bid % hb) / a.H, kvh = h / a.rep;
  const int q0 = qt * kBQ;
  const int n_valid = min(kWGs, (a.S - q0) / kRows);
  // the causal band of the block's rows: KV tiles [0, hi_b)
  const int hi_b = (q0 + kRows * n_valid) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      tc::mbar_init(bars + 8 * s, 1);
      tc::mbar_init(bars + 8 * (ST + s), kWGs * 4);
    }
    tc::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWGs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     C::PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == kWGs * 128) {
      tc::mbar_expect_tx(qbar, 2 * n_valid * C::TILE);
      for (int w = 0; w < n_valid; ++w)
        for (int c = 0; c < NC; ++c) {
          tc::tma_load(q_s + w * C::TILE + c * kChunk, &tq, qbar, 64 * c, h,
                       q0 + kRows * w, b);
          tc::tma_load(do_s + w * C::TILE + c * kChunk, &tdo, qbar, 64 * c,
                       h, q0 + kRows * w, b);
        }
      for (int t = 0; t < hi_b; ++t) {
        const int s = t % ST, r = t / ST;
        if (r > 0) tc::mbar_wait(bars + 8 * (ST + s), (r - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t ks = kv_s + s * C::STAGE_BYTES;
        tc::mbar_expect_tx(full, C::STAGE_BYTES);
        for (int c = 0; c < NC; ++c) {
          tc::tma_load(ks + c * kChunk, &tk, full, 64 * c, kvh, t * kBK, b);
          tc::tma_load(ks + C::TILE + c * kChunk, &tv, full, 64 * c, kvh,
                       t * kBK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   C::CONSUMER_REGS)
               : "memory");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + kRows * wg;
  const bool valid = wg < n_valid;
  const int hi = valid ? r0 / kBK + 1 : 0;   // the last holds the diagonal
  const int row = r0 + 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const long long ld = (long long)a.H * D;   // a position's row, elements
  const long long hrow = ((long long)b * a.H + h) * a.S;   // lse, dlt

  // D = rowsum(dO o O) and lse of rows row and row + 8: each lane of the
  // quad reads a quarter of the row, the quad sums (the same bits on all)
  float dl[2] = {0.0f, 0.0f}, ls[2] = {0.0f, 0.0f};
  if (valid) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = row + 8 * r;
      const long long off =
          ((long long)b * a.S + pos) * ld + (long long)h * D + (lane % 4) *
          (D / 4);
      const uint4* op = reinterpret_cast<const uint4*>(a.o + off);
      const uint4* gp = reinterpret_cast<const uint4*>(a.dout + off);
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < D / 32; ++u) {
        const uint4 x = op[u], y = gp[u];
        const __nv_bfloat162* xs =
            reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys =
            reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(xs[e]);
          const float2 fy = __bfloat1622float2(ys[e]);
          acc = fmaf(fx.x, fy.x, acc);
          acc = fmaf(fx.y, fy.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dl[r] = acc;
      if ((lane & 3) == 0) a.dlt[hrow + pos] = acc;
      ls[r] = a.lse[hrow + pos];
    }
  }

  float dq[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.0f;
  if (valid) tc::mbar_wait(qbar, 0);
  const uint32_t qa = q_s + wg * C::TILE, da = do_s + wg * C::TILE;

  for (int t = 0; t < hi_b; ++t) {
    const int s = t % ST;
    tc::mbar_wait(bars + 8 * s, (t / ST) & 1);
    if (t < hi) {
      const uint32_t ks = kv_s + s * C::STAGE_BYTES, vs = ks + C::TILE;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
      tc::wg_fence();
      mma_rows<D>(sc, qa, ks);
      mma_rows<D>(dp, da, vs);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::hold(sc);
      tc::hold(dp);

      // sc[4j + e]: row row + 8 (e / 2), key 64 t + 8 j + cq + e % 2
      const bool diag = t == hi - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, rr = e >> 1;
          float p = expf(sc[i] * a.scale - ls[rr]);
          if (diag && kBK * t + 8 * j + cq + (e & 1) > row + 8 * rr)
            p = 0.0f;
          sc[i] = p * (dp[i] - dl[rr]);
        }
      uint32_t shi[4][4], slo[4][4];
      tc::split_frags(sc, shi, slo);
      tc::wg_fence();
      mma_cols<NC>(dq, shi, ks);
      mma_cols<NC>(dq, slo, ks);
      tc::wg_commit();
      tc::wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) tc::hold(dq[c]);
      tc::hold(shi);
      tc::hold(slo);
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(bars + 8 * (ST + s));
  }

  if (!valid) return;
  store_rows<NC>(a.dq + (long long)b * a.S * ld + (long long)h * D, ld, row,
                 cq, dq, a.scale);
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, 1)
    flash_bwd_dkv(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, const Args a) {
  using C = DkvCfg<D>;
  constexpr int NC = C::NC, ST = C::STAGES, kWGs = C::WGS, kBKB = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;                          // kWGs K tiles
  const uint32_t v_s = k_s + kWGs * C::TILE;          // kWGs V tiles
  const uint32_t st_s = v_s + kWGs * C::TILE;         // ST x (Q, dO)
  const uint32_t row_s = st_s + ST * C::STAGE_BYTES;  // ST x (lse, D)
  const uint32_t bars = row_s + ST * C::ROW_BYTES;    // full, empty, K/V
  const uint32_t kvbar = bars + 16 * ST;
  const float* rows_f = reinterpret_cast<const float*>(smem_raw +
                                                       (row_s - raw));

  // block -> (KV tile, KV head, batch), longest band (first keys) first
  const int hb = a.Kv * a.B, bid = blockIdx.x;
  const int kt = bid / hb;
  const int g = (bid % hb) % a.Kv, b = (bid % hb) / a.Kv;
  const int k0 = kt * kBKB;
  const int n_valid = min(kWGs, (a.S - k0) / kRows);
  // the query tiles that see the block's keys: [qt_lo, n_q), each head
  const int qt_lo = k0 / kRows, n_q = a.S / kRows, n_qt = n_q - qt_lo;
  const int n_it = a.rep * n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      tc::mbar_init(bars + 8 * s, 1);
      tc::mbar_init(bars + 8 * (ST + s), kWGs * 4);
    }
    tc::mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWGs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     C::PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == kWGs * 128) {
      tc::mbar_expect_tx(kvbar, 2 * n_valid * C::TILE);
      for (int w = 0; w < n_valid; ++w)
        for (int c = 0; c < NC; ++c) {
          tc::tma_load(k_s + w * C::TILE + c * kChunk, &tk, kvbar, 64 * c, g,
                       k0 + kRows * w, b);
          tc::tma_load(v_s + w * C::TILE + c * kChunk, &tv, kvbar, 64 * c, g,
                       k0 + kRows * w, b);
        }
      for (int i = 0; i < n_it; ++i) {
        const int h = g * a.rep + i / n_qt, qt = qt_lo + i % n_qt;
        const int s = i % ST, r = i / ST;
        if (r > 0) tc::mbar_wait(bars + 8 * (ST + s), (r - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t qs = st_s + s * C::STAGE_BYTES;
        const uint32_t rs = row_s + s * C::ROW_BYTES;
        const long long hrow = ((long long)b * a.H + h) * a.S + qt * kRows;
        tc::mbar_expect_tx(full, C::STAGE_BYTES + C::ROW_BYTES);
        for (int c = 0; c < NC; ++c) {
          tc::tma_load(qs + c * kChunk, &tq, full, 64 * c, h, qt * kRows, b);
          tc::tma_load(qs + C::TILE + c * kChunk, &tdo, full, 64 * c, h,
                       qt * kRows, b);
        }
        bulk_load(rs, a.lse + hrow, kRows * 4, full);
        bulk_load(rs + kRows * 4, a.dlt + hrow, kRows * 4, full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   C::CONSUMER_REGS)
               : "memory");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int kr0 = k0 + kRows * wg;
  const bool valid = wg < n_valid;
  const int q_first = kr0 / kRows;   // its first query tile: the diagonal
  const int key = kr0 + 16 * warp + lane / 4, cq = 2 * (lane % 4);

  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.0f;
  if (valid) tc::mbar_wait(kvbar, 0);
  const uint32_t ka = k_s + wg * C::TILE, va = v_s + wg * C::TILE;

  for (int i = 0; i < n_it; ++i) {
    const int qt = qt_lo + i % n_qt, s = i % ST;
    tc::mbar_wait(bars + 8 * s, (i / ST) & 1);
    if (valid && qt >= q_first) {
      const uint32_t qs = st_s + s * C::STAGE_BYTES, dos = qs + C::TILE;
      const float* lsp = rows_f + s * (C::ROW_BYTES / 4);
      const float* dlp = lsp + kRows;
      float st[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) st[j] = dp[j] = 0.0f;
      tc::wg_fence();
      mma_rows<D>(st, ka, qs);
      mma_rows<D>(dp, va, dos);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::hold(st);
      tc::hold(dp);

      // st[4j + e]: key key + 8 (e / 2), query 64 qt + 8 j + cq + e % 2
      const bool diag = qt == q_first;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e, col = 8 * j + cq + (e & 1);
          float p = expf(st[x] * a.scale - lsp[col]);
          if (diag && key + 8 * (e >> 1) > kRows * qt + col) p = 0.0f;
          st[x] = p;
          dp[x] = p * (dp[x] - dlp[col]);
        }
      uint32_t pf[4][4], shi[4][4], slo[4][4];
      tc::frags(st, pf);
      tc::split_frags(dp, shi, slo);
      tc::wg_fence();
      mma_cols<NC>(dv, pf, dos);
      mma_cols<NC>(dk, shi, qs);
      mma_cols<NC>(dk, slo, qs);
      tc::wg_commit();
      tc::wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tc::hold(dk[c]);
        tc::hold(dv[c]);
      }
      tc::hold(pf);
      tc::hold(shi);
      tc::hold(slo);
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(bars + 8 * (ST + s));
  }

  if (!valid) return;
  const long long ld = (long long)a.Kv * D;
  const long long off = (long long)b * a.S * ld + (long long)g * D;
  store_rows<NC>(a.dk + off, ld, key, cq, dk, a.scale);
  store_rows<NC>(a.dv + off, ld, key, cq, dv, 1.0f);
}

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <int D>
int launch_bwd(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, const CUtensorMap& tdo, Args a,
               cudaStream_t stream) {
  static bool dq_in = false, dkv_in = false;
  int st = opt_in(flash_bwd_dq<D>, DqCfg<D>::SMEM, dq_in);
  if (st == 0) st = opt_in(flash_bwd_dkv<D>, DkvCfg<D>::SMEM, dkv_in);
  if (st != 0) return st;
  a.n_blk = (a.S + DqCfg<D>::BQ - 1) / DqCfg<D>::BQ;
  flash_bwd_dq<D><<<(unsigned)a.n_blk * a.H * a.B, DqCfg<D>::THREADS,
                    DqCfg<D>::SMEM, stream>>>(tq, tk, tv, tdo, a);
  st = (int)cudaGetLastError();
  if (st != 0) return st;
  const unsigned n_kb = (a.S + DkvCfg<D>::BK - 1) / DkvCfg<D>::BK;
  flash_bwd_dkv<D><<<n_kb * a.Kv * a.B, DkvCfg<D>::THREADS,
                     DkvCfg<D>::SMEM, stream>>>(tq, tk, tv, tdo, a);
  return (int)cudaGetLastError();
}

// a contiguous (B, S, heads, D) bf16 tensor's map
int contiguous_map(CUtensorMap* map, const void* p, long long B, long long S,
                   long long heads, long long D) {
  return tc::make_map(map, p, D, heads, S, B, S * heads * D, heads * D, D);
}

bool shape_ok(long long B, long long S, long long H, long long Kv,
              long long D) {
  return B > 0 && S > 0 && S % kRows == 0 && Kv > 0 && H % Kv == 0 &&
         (D == 64 || D == 128) && B * H * S < (1ll << 31);
}

}  // namespace tr

// The one rule that picks the body.
bool wgmma_body(long long dtype, long long D) {
  return dtype == 1 && (D == 64 || D == 112 || D == 128 || D == 256);
}

}  // namespace

// q, o: (B,S,H,D); k, v: (B,T,Kv,D) with T == S; each addressed through its
// (batch, sequence, head) strides in elements, unit stride along D.
// dtype: 0 = f32, 1 = bf16 (o has q's dtype).  D in {16, 32, 64, 112, 128,
// 256}.
// bf16 at D in {64, 112, 128, 256} runs flash_wgmma (its strides and base
// addresses in multiples of 16 bytes), everything else flash_fwd.
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
  if (wgmma_body(dtype, D)) {
    CUtensorMap tq, tk, tv;
    int st = tc::make_map(&tq, q, D, H, S, B, q_sb, q_ss, q_sh);
    if (st == 0) st = tc::make_map(&tk, k, D, Kv, T, B, k_sb, k_ss, k_sh);
    if (st == 0) st = tc::make_map(&tv, v, D, Kv, T, B, v_sb, v_ss, v_sh);
    if (st != 0) return st;
    // n_qb is set by tc::launch, per D
    const tc::Args a{static_cast<__nv_bfloat16*>(o), o_sb, o_ss, o_sh,
                     (int)S, (int)T, (int)H, (int)B, (int)(H / Kv), 0,
                     (int)causal, (int)window, scale, softcap,
                     softcap > 0.0f ? 1.0f / softcap : 0.0f};
    switch (D) {
      case 64: return tc::launch<64>(tq, tk, tv, a, stream);
      case 112: return tc::launch<112>(tq, tk, tv, a, stream);
      case 128: return tc::launch<128>(tq, tk, tv, a, stream);
      default: return tc::launch<256>(tq, tk, tv, a, stream);
    }
  }
  const Args a{q,    k,    v,    o,    q_sb,        q_ss,   q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss,        v_sh,   o_sb,
               o_ss, o_sh, (int)S, (int)T, (int)(H / Kv), (int)causal,
               (int)window, scale, softcap};
  if (dtype == 0) return dispatch<float>(a, (int)B, (int)H, (int)D, stream);
  // bf16 at D 64, 112, 128 and 256 ran flash_wgmma above
  if (dtype == 1 && D == 16)
    return launch<16, __nv_bfloat16>(a, (int)B, (int)H, stream);
  if (dtype == 1 && D == 32)
    return launch<32, __nv_bfloat16>(a, (int)B, (int)H, stream);
  return (int)cudaErrorInvalidValue;
}

// 1 when flash_attention_launch runs flash_wgmma for this dtype and D.
extern "C" int flash_attention_wgmma_body(long long dtype, long long D) {
  return wgmma_body(dtype, D) ? 1 : 0;
}

// The training pair (namespace tr above).  q, o: (B,S,H,D); k, v:
// (B,S,Kv,D); all bf16 and contiguous, D 64 or 128, S a multiple of 64,
// causal, positions from 0.  Forward: o and lse (B,H,S) f32.
extern "C" int flash_train_fwd_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      long long B, long long S, long long H,
                                      long long Kv, long long D, float scale,
                                      cudaStream_t stream) {
  if (!tr::shape_ok(B, S, H, Kv, D)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int st = tr::contiguous_map(&tq, q, B, S, H, D);
  if (st == 0) st = tr::contiguous_map(&tk, k, B, S, Kv, D);
  if (st == 0) st = tr::contiguous_map(&tv, v, B, S, Kv, D);
  if (st != 0) return st;
  tc::Args a{static_cast<__nv_bfloat16*>(o), S * H * D, H * D, D,
             (int)S, (int)S, (int)H, (int)B, (int)(H / Kv), 0, 1, 0, scale,
             0.0f, 0.0f, static_cast<float*>(lse)};
  return D == 64 ? tc::launch<64, true>(tq, tk, tv, a, stream)
                 : tc::launch<128, true>(tq, tk, tv, a, stream);
}

// Backward: dq (B,S,H,D), dk and dv (B,S,Kv,D) written whole; dlt (B,H,S)
// f32 scratch (rowsum(dO o O), written by the first launch, read by the
// second).
extern "C" int flash_train_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dlt, void* dq, void* dk,
    void* dv, long long B, long long S, long long H, long long Kv,
    long long D, float scale, cudaStream_t stream) {
  if (!tr::shape_ok(B, S, H, Kv, D)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int st = tr::contiguous_map(&tq, q, B, S, H, D);
  if (st == 0) st = tr::contiguous_map(&tk, k, B, S, Kv, D);
  if (st == 0) st = tr::contiguous_map(&tv, v, B, S, Kv, D);
  if (st == 0) st = tr::contiguous_map(&tdo, dout, B, S, H, D);
  if (st != 0) return st;
  const tr::Args a{static_cast<const __nv_bfloat16*>(o),
                   static_cast<const __nv_bfloat16*>(dout),
                   static_cast<const float*>(lse), static_cast<float*>(dlt),
                   static_cast<__nv_bfloat16*>(dq),
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), (int)S, (int)H, (int)Kv,
                   (int)B, (int)(H / Kv), 0, scale};
  return D == 64 ? tr::launch_bwd<64>(tq, tk, tv, tdo, a, stream)
                 : tr::launch_bwd<128>(tq, tk, tv, tdo, a, stream);
}
