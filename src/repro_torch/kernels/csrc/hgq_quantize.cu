// HGQ quantizer (Eq. 4) forward, and its Algorithm-1 backward in f.
//
// hgq_quantize_fwd and hgq_quantize_fwd_group replace
// src/repro/kernels/hgq_quantize/kernel.py:59 (`hgq_quantize_2d`, bodies
// _kernel_per_tensor :42, _kernel_per_channel :47, _kernel_per_param :52).
// hgq_quantize_bwd replaces the custom_vjp backward of that kernel,
// src/repro/kernels/hgq_quantize/ops.py:164 (`_bwd`).
//
// Forward: out = floor(x * 2^fi + 1/2) / 2^fi with fi = floor(f + 1/2), in
// float32, written in x's dtype (float32 or bfloat16).  2^fi and 2^-fi are built
// in the exponent field after the clamp to -126..127, the products and sums are
// rounded one by one (__fmul_rn / __fadd_rn: no FMA contraction), and the
// quotient is taken as the product with the exact 2^-fi, which rounds the same
// real number (see Grid): the grid is bit-exact against the plain version.  f is
// one value (per tensor), one value per column (per channel, x viewed as [rows,
// cols]) or one value per element (per parameter).  Any cols works: no lane
// alignment as the TPU kernel needed.
//
// An MoE layer's expert stack x [E, K, N] (x viewed as [E K, N], K rows an
// expert) has its f per expert: [E, 1, N] (per expert channel: row r, column c
// reads f[(r / K) N + c]) or [E, 1, 1] (per expert tensor: row r reads f[r / K]).
// Both are the per-channel and per-tensor bodies run over E groups of K rows, each
// group with its own f: the forward gives each group its own blocks (a block
// finds its group by one division), the backward takes the group from a grid axis
// (per channel z, per tensor y) and reduces it as the plain layouts reduce the
// whole tensor, its clusters and second pass inside the group.  The TPU package
// sends these shapes to its plain reference (src/repro/kernels/hgq_quantize/
// ops.py:60); here they are kernels, with no fallback.
//
// The forward is one kernel for a group of independent tensors: a table in the
// kernel's parameter space (__grid_constant__, no copy to the device) holds each
// member's x, f and out, its [rows, cols], layout and dtype, and its first block;
// a block finds its member by a binary search over those first blocks, which
// follow from the shapes alone.  A training step's weight and bias quantizers
// (none depends on an activation) are one launch; a single tensor is a group of
// one.  Work comes in units of one 16-byte vector of x (4 float32 or 8 bfloat16
// values): per tensor and per parameter over the flat elements, per channel a 2-D
// map in which a thread keeps one column vector (its grid steps computed once)
// and walks the rows by a fixed stride, with no division or modulo per element.
// A member takes a block for every FWD_THREADS units up to FWD_MAX_BLOCKS; past
// that, a thread loads FWD_UNROLL units before it computes and stores them.  Members
// whose x and out (per parameter also f) are 16-byte aligned, and per channel
// whose rows are whole vectors, load and store 16 bytes at a time; others take
// the same units element by element, and so does a ragged last unit.
//
// Backward: dx = g needs no kernel.  df = sum of g * ln2 * (x - xq) over the
// axes f is broadcast along, with xq recomputed from x and f and rounded to x's
// dtype first, exactly as the JAX backward does.  Per parameter the product is
// written elementwise.
//
// The two reductions (per channel, per tensor) are one launch of a thread block
// cluster (cudaLaunchKernelEx) on every shape of the training slice, with no
// scratch and no atomics; the earlier design's two dependent launches, scratch
// and 8-step shared-memory tree took 6.3-9.5 us a training call.
// - The blocks of a cluster split the rows (per channel, 32 columns a cluster)
//   or the flat elements (per tensor); a thread takes BATCH 16-byte steps of g
//   and x, all copied into its own slots of shared memory by cp.async before it
//   waits once (loads into registers were paired by the compiler with each
//   step's arithmetic, a memory latency a step).  Views that are not 16-byte
//   aligned, and rows that are not whole vectors, load the same values one by
//   one into registers.
// - xq multiplies by the exact reciprocal 2^-fi where quant() divides by 2^fi:
//   the same bits (see Grid).
// - A block reduces by a fixed warp-shuffle tree, then its warps by a fixed
//   tree.  Every rank but 0 stores its partial into rank 0's shared memory with
//   st.async, completing bytes on rank 0's mbarrier; rank 0 adds the partials in
//   rank order and writes df.
// - Which thread takes which value, and so the order of every sum, follows from
//   the shape and the dtype alone (hgq_quantize_bwd_plan), never from alignment,
//   batch position or timing: two launches give the same bits.
// - Clusters hold up to 8 blocks, the portable size every part with clusters
//   schedules.  16 needs cudaFuncAttributeNonPortableClusterSizeAllowed and a
//   GPC that holds 16 blocks, which H100 PCIe parts and MIG slices may not; on
//   the H100 SXM it saves ~0.7 us at the 16-block training shape (1024, 64).
//   HGQ_CLUSTER and HGQ_ONE_CLUSTER_BATCHES below set the geometry at build
//   time; torch_kernel_sweep.py builds and times other values (and the
//   forward's HGQ_FWD_*).
//
// Where the line falls.  One cluster (8 SMs) cannot stream a large shape: a qwen2
// activation (8192, 896) float32 is 58.7 MB of g and x.  Past 8 blocks of two
// batches a thread (65536 float32 elements per tensor, 2048 rows per channel),
// the shape is spread over clusters of 8 blocks of one batch, each writes its
// partial to scratch, and a second pass adds the partials in cluster order.  In
// the sweep, float32 at the line runs ~1 us faster as one cluster than as two
// and a second pass, and one cluster of four batches a thread ~1 us slower.
//
// Bound: bytes.  Forward reads x and f and writes out; backward reads g, x and f
// and writes df (a few flops per element either way).  On the training slice's
// shapes (a few thousand elements) every launch is latency-bound: there the
// grouped forward saves launches, and the 16-byte body serves large shapes.
// Later work: fusing the quantizer into its neighbours; a grouped backward.
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

namespace cg = cooperative_groups;

constexpr float LN2F = 0.6931471805599453f;
constexpr int EW_THREADS = 256;       // elementwise kernels
constexpr int EW_MAX_BLOCKS = 132 * 8;
constexpr int RED_THREADS = 256;      // reduction blocks: 8 warps
constexpr int RED_WARPS = RED_THREADS / 32;
constexpr int COL_TILE = 32;          // per channel: columns of a cluster
constexpr int BATCH = 4;              // 16-byte steps a thread loads before it adds
// blocks a cluster (at most 8 unless the kernels may take non-portable sizes)
#ifndef HGQ_CLUSTER
#define HGQ_CLUSTER 8
#endif
// one cluster takes a shape up to CLUSTER blocks of this many batches a thread;
// beyond, clusters of CLUSTER blocks of one batch a thread and a second pass
#ifndef HGQ_ONE_CLUSTER_BATCHES
#define HGQ_ONE_CLUSTER_BATCHES 2
#endif
constexpr int CLUSTER = HGQ_CLUSTER;
constexpr int ONE_CLUSTER_BATCHES = HGQ_ONE_CLUSTER_BATCHES;
// forward: threads a block (a power of two, at least 32), units a thread loads
// before it computes (once a member has its most blocks), and a member's
// blocks at most this many an SM
#ifndef HGQ_FWD_THREADS
#define HGQ_FWD_THREADS 256
#endif
#ifndef HGQ_FWD_UNROLL
#define HGQ_FWD_UNROLL 2
#endif
#ifndef HGQ_FWD_BLOCKS_PER_SM
#define HGQ_FWD_BLOCKS_PER_SM 8
#endif
constexpr int FWD_THREADS = HGQ_FWD_THREADS;
constexpr int FWD_UNROLL = HGQ_FWD_UNROLL;
constexpr int FWD_MAX_BLOCKS = 132 * HGQ_FWD_BLOCKS_PER_SM;
static_assert(FWD_THREADS >= 32 && FWD_THREADS <= 1024 &&
                  (FWD_THREADS & (FWD_THREADS - 1)) == 0,
              "forward threads: a power of two");
// members of one grouped forward launch (the table fits the 4 KB of
// parameter space every CUDA version takes)
constexpr int FWD_MAX_MEMBERS = 64;

// the layouts as the entry points take them; PER_EXPERT_* run as PER_CHANNEL /
// PER_TENSOR over groups of rows (group_rows K an expert)
enum Layout {
  PER_TENSOR = 0,
  PER_CHANNEL = 1,
  PER_PARAM = 2,
  PER_EXPERT_CHANNEL = 3,
  PER_EXPERT_TENSOR = 4
};

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// a float32 value rounded through the storage type and back
__device__ __forceinline__ float as_stored(float v, const float*) { return v; }
__device__ __forceinline__ float as_stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float exact_exp2(float fi) {
  fi = fminf(fmaxf(fi, -126.f), 127.f);
  return __int_as_float((static_cast<int>(fi) + 127) << 23);
}

// Eq. 4 on one value, in float32
__device__ __forceinline__ float quant(float x, float f) {
  const float s = exact_exp2(floorf(__fadd_rn(f, 0.5f)));
  return __fdiv_rn(floorf(__fadd_rn(__fmul_rn(x, s), 0.5f)), s);
}

// one element's share of df: (g * ln2) * (x - xq), xq in T, x's storage type
template <typename T>
__device__ __forceinline__ float term(float gv, float xv, float f) {
  const float delta =
      __fsub_rn(xv, as_stored(quant(xv, f), static_cast<const T*>(nullptr)));
  return __fmul_rn(__fmul_rn(gv, LN2F), delta);
}

template <typename T>
__device__ __forceinline__ float df_term(const T* g, const T* x, float f,
                                         long long i) {
  return term<T>(load(g, i), load(x, i), f);
}

template <typename T>
__global__ void bwd_param_kernel(const T* __restrict__ g,
                                 const T* __restrict__ x,
                                 const float* __restrict__ f,
                                 float* __restrict__ df, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    df[i] = df_term(g, x, f[i], i);
}

// values a thread takes a step: 16 bytes of g (and of x)
template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

// a 16-byte load as float32 values: four float32, or eight bfloat16 widened
__device__ __forceinline__ void widen(const uint4& u, const float*, float* v) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, const __nv_bfloat16*,
                                      float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t bits_of(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ uint32_t bits_of(const __nv_bfloat16* p) {
  return __bfloat16_as_ushort(*p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

// A thread's BATCH 16-byte steps of g and x.  VEC: cp.async copies into the
// thread's own slots of shared memory, all issued before the first is waited
// on, so the batch costs one memory latency (loads into registers were paired
// by the compiler with each step's arithmetic: one latency a step).  Else the
// values element by element into registers (views not 16-byte aligned, rows
// not a whole number of vectors).  Elements at or past `valid` read element
// `safe` instead (a value inside the tensor, whose term the caller drops).
template <typename T, bool VEC>
struct Batch {
  uint4* slots;  // VEC: [2][BATCH][RED_THREADS] uint4 in shared memory
  uint4 rg[VEC ? 1 : BATCH], rx[VEC ? 1 : BATCH];

  __device__ __forceinline__ void fetch(const T* g, const T* x, int b,
                                        long long i, int valid,
                                        long long safe) {
    if constexpr (VEC) {
      const long long k = valid > 0 ? i : safe;
      cp_async16(slots + b * RED_THREADS + threadIdx.x, g + k);
      cp_async16(slots + (BATCH + b) * RED_THREADS + threadIdx.x, x + k);
    } else {
      rg[b] = load16(g, i, valid, safe);
      rx[b] = load16(x, i, valid, safe);
    }
  }
  __device__ __forceinline__ void wait() {
    if constexpr (VEC) asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __device__ __forceinline__ uint4 gb(int b) const {
    if constexpr (VEC) return slots[b * RED_THREADS + threadIdx.x];
    else return rg[b];
  }
  __device__ __forceinline__ uint4 xb(int b) const {
    if constexpr (VEC) return slots[(BATCH + b) * RED_THREADS + threadIdx.x];
    else return rx[b];
  }

 private:
  static __device__ __forceinline__ uint4 load16(const T* p, long long i,
                                                 int valid, long long safe) {
    constexpr int PER = 4 / static_cast<int>(sizeof(T));  // values a word
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0u;
#pragma unroll
      for (int h = 0; h < PER; ++h) {
        const int e = k * PER + h;
        w[k] |= bits_of(p + (e < valid ? i + e : safe)) << (16 * h);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// shared memory a VEC reduction block stages its batch in (no opt-in needed)
constexpr int STAGE_BYTES = 2 * BATCH * RED_THREADS * 16;
static_assert(STAGE_BYTES <= 48 * 1024, "a batch fits default shared memory");

// The cluster's exchange.  Rank 0 keeps a slot per rank and an mbarrier; every
// other rank stores its partials straight into rank 0's slots with st.async,
// which completes their bytes on that mbarrier, and leaves.  Rank 0 waits for
// the bytes and adds the slots in rank order.  The one cluster barrier orders the
// mbarrier's initialisation before the first remote store: it is arrived at when
// the kernel starts and waited on only after the block's own reduction, so its
// latency hides under the loads.  (Two cluster.sync() around rank 0 reading the
// other blocks' shared memory cost more: each a full barrier after the work.)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

struct Exchange {
  // rank 0, one thread: expect `bytes` from the other ranks
  static __device__ __forceinline__ void expect(unsigned long long* mbar,
                                                unsigned bytes) {
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n\t"
        "fence.mbarrier_init.release.cluster;" ::"r"(smem_addr(mbar)),
        "r"(bytes)
        : "memory");
  }
  // every thread of every block, at the start
  static __device__ __forceinline__ void arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }
  // every thread of every block, before the first remote store
  static __device__ __forceinline__ void wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  // a rank other than 0: v into rank 0's copy of `slot`
  static __device__ __forceinline__ void send(float* slot, float v,
                                              unsigned long long* mbar) {
    asm volatile(
        "{\n\t.reg .b32 ra, rb;\n\t"
        "mapa.shared::cluster.u32 ra, %0, 0;\n\t"
        "mapa.shared::cluster.u32 rb, %2, 0;\n\t"
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [ra], %1, "
        "[rb];\n\t}" ::"r"(smem_addr(slot)),
        "r"(__float_as_uint(v)), "r"(smem_addr(mbar))
        : "memory");
  }
  // rank 0: whether every expected byte has landed.  The wait is bounded: bytes
  // that never come (a fault of this file) give false after 2^20 polls, and
  // rank 0 writes NaN, which every check of a gradient sees, where a trap would
  // end the CUDA context.
  static __device__ __forceinline__ bool receive(unsigned long long* mbar) {
    for (int i = 0; i < (1 << 20); ++i) {
      unsigned done;
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "0;\n\tselp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(smem_addr(mbar))
          : "memory");
      if (done) return true;
    }
    return false;
  }
};

// The reductions' grid step and its reciprocal for one f: s = 2^fi and 1 / s =
// 2^-fi, both exact (fi is clamped to -126..127, so 2^-fi lies in 2^-127 ..
// 2^126; 2^-127 is the subnormal 0x00400000).  q * (1 / s) is then the same real
// number as q / s and rounds to the same float: the bits of quant(), with a
// multiply where quant() calls the IEEE division (a thread of the reductions
// takes 32-64 elements).
struct Grid {
  float s, rs;
};
__device__ __forceinline__ Grid grid_of(float f) {
  const float fi = fminf(fmaxf(floorf(__fadd_rn(f, 0.5f)), -126.f), 127.f);
  const int e = static_cast<int>(fi);
  return {__int_as_float((e + 127) << 23),
          e == 127 ? __int_as_float(0x00400000) : __int_as_float((127 - e) << 23)};
}

// Eq. 4 on the grid q: floor(x * 2^fi + 1/2) * 2^-fi, the bits of quant()
__device__ __forceinline__ float quant_on(float x, Grid q) {
  return __fmul_rn(floorf(__fadd_rn(__fmul_rn(x, q.s), 0.5f)), q.rs);
}

// term() with the grid given
template <typename T>
__device__ __forceinline__ float term_on(float gv, float xv, Grid q) {
  const float xq = quant_on(xv, q);
  const float delta = __fsub_rn(xv, as_stored(xq, static_cast<const T*>(nullptr)));
  return __fmul_rn(__fmul_rn(gv, LN2F), delta);
}

// v[0] + ... + v[N - 1] by a fixed pairwise tree
template <int N>
__device__ __forceinline__ float tree_sum(const float* v) {
  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = v[i];
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) s[i] = __fadd_rn(s[i], s[i + w]);
  }
  return s[0];
}

// ---------------------------------------------------------------------------
// Forward: one launch for a group of tensors
// ---------------------------------------------------------------------------

// One member of a grouped forward launch, as the kernel reads it from its
// parameter space.
struct FwdMember {
  const void* x;
  const float* f;
  void* out;
  long long rows;   // x and out as [rows, cols], contiguous
  int cols;
  int block0;       // the member's first block in the grid
  int blocks;       // its blocks; per channel column tiles x row chunks, times
                    // the groups
  int ctiles;       // per channel: tiles of 2^tpr_log2 column vectors, else 1
  unsigned char layout, bf16, vec, tpr_log2;  // layout: PER_TENSOR, _CHANNEL
                                              // or _PARAM
  int groups;       // groups of rows / groups rows, each with its own f (1 but
                    // for the per-expert layouts); blocks / groups a group
};

struct FwdTable {
  FwdMember m[FWD_MAX_MEMBERS];
  int count;
};
static_assert(sizeof(FwdTable) <= 4096, "the table fits the parameter space");

// V float32 values as 16 bytes of x's dtype (the inverse of widen)
__device__ __forceinline__ uint4 narrow(const float* v, const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 narrow(const float* v, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
           (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
            << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// K units of the flat elements, u0, u0 + step, ..., all below the member's end:
// every load issued before the first is used.  Per tensor f0 is the one f.
template <typename T, int L, bool VEC, int K>
__device__ __forceinline__ void flat_round(const T* __restrict__ x,
                                           T* __restrict__ out,
                                           const float* __restrict__ f, float f0,
                                           long long u0, long long step,
                                           long long n) {
  constexpr int V = vec_of<T>();
  uint4 xv[K];
  float fv[K][L == PER_PARAM ? V : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long e = (u0 + k * step) * V;
    if (VEC && e + V <= n) {
      xv[k] = *reinterpret_cast<const uint4*>(x + e);
      if constexpr (L == PER_PARAM) {
#pragma unroll
        for (int h = 0; h < V; h += 4) {
          const float4 f4 = *reinterpret_cast<const float4*>(f + e + h);
          fv[k][h] = f4.x;
          fv[k][h + 1] = f4.y;
          fv[k][h + 2] = f4.z;
          fv[k][h + 3] = f4.w;
        }
      }
    }
  }
  const Grid qt = L == PER_TENSOR ? grid_of(f0) : Grid{0.f, 0.f};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long e = (u0 + k * step) * V;
    if (VEC && e + V <= n) {
      float v[V];
      widen(xv[k], x, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (L == PER_PARAM) v[j] = quant_on(v[j], grid_of(fv[k][j]));
        else v[j] = quant_on(v[j], qt);
      }
      *reinterpret_cast<uint4*>(out + e) = narrow(v, out);
    } else {
      const long long cnt = n - e;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < cnt)
          store(out, e + j,
                quant_on(load(x, e + j),
                         L == PER_PARAM ? grid_of(f[e + j]) : qt));
      }
    }
  }
}

// Per tensor and per parameter: unit u covers the flat elements [u V, u V + V).
// Block b of the member's `blocks` takes units b T + t, then every blocks x T
// further (past FWD_MAX_BLOCKS blocks): FWD_UNROLL at a time while a thread has
// that many left, then one at a time.  Per tensor f is read before the loads
// and its grid made after them, so the two latencies overlap.
template <typename T, int L, bool VEC>
__device__ __forceinline__ void fwd_flat(const FwdMember& m, int b) {
  constexpr int V = vec_of<T>();
  const T* x = static_cast<const T*>(m.x);
  T* out = static_cast<T*>(m.out);
  const long long n = m.rows * m.cols;
  const long long units = (n + V - 1) / V;
  const long long step = static_cast<long long>(m.blocks) * FWD_THREADS;
  const float f0 = L == PER_TENSOR ? m.f[0] : 0.f;
  long long u = static_cast<long long>(b) * FWD_THREADS + threadIdx.x;
  for (; u + (FWD_UNROLL - 1) * step < units; u += FWD_UNROLL * step)
    flat_round<T, L, VEC, FWD_UNROLL>(x, out, m.f, f0, u, step, n);
  for (; u < units; u += step) flat_round<T, L, VEC, 1>(x, out, m.f, f0, u, step, n);
}

// K rows r0, r0 + rstep, ..., all below the member's end, at the thread's column
// vector c0 (width columns, grid f values fc): every load issued before the
// grid steps are made and the first load is used.
template <typename T, bool VEC, int K>
__device__ __forceinline__ void channel_round(const T* __restrict__ x,
                                              T* __restrict__ out, long long r0,
                                              long long rstep, long long cols,
                                              int c0, int width, const float* fc) {
  constexpr int V = vec_of<T>();
  uint4 xv[K];
  if (VEC) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      xv[k] = *reinterpret_cast<const uint4*>(x + (r0 + k * rstep) * cols + c0);
  }
  Grid q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) q[j] = grid_of(fc[j]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long e = (r0 + k * rstep) * cols + c0;
    if (VEC) {
      float v[V];
      widen(xv[k], x, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = quant_on(v[j], q[j]);
      *reinterpret_cast<uint4*>(out + e) = narrow(v, out);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < width) store(out, e + j, quant_on(load(x, e + j), q[j]));
      }
    }
  }
}

// Per channel: unit (r, c) covers columns [c V, c V + V) of row r.  A block is
// one tile of tpr = 2^tpr_log2 column vectors by one chunk of row phases: thread
// t keeps column vector tile * tpr + t % tpr, whose f it reads once, and row
// phase t / tpr, and walks rows phase + chunk * rp, then every chunks x rp
// further (rp = T / tpr), FWD_UNROLL rows at a time while it has that many
// left, then one at a time: no division or modulo per element.
template <typename T, bool VEC>
__device__ __forceinline__ void fwd_channel(const FwdMember& m, int b) {
  constexpr int V = vec_of<T>();
  const int sh = m.tpr_log2;
  const int rp = FWD_THREADS >> sh;
  const int chunks = m.blocks / m.ctiles;
  const int tile = b % m.ctiles, chunk = b / m.ctiles;
  const int c0 = ((tile << sh) + (static_cast<int>(threadIdx.x) & ((1 << sh) - 1))) * V;
  if (c0 >= m.cols) return;
  const int width = m.cols - c0 < V ? m.cols - c0 : V;
  float fc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) fc[j] = m.f[c0 + (j < width ? j : 0)];
  const T* x = static_cast<const T*>(m.x);
  T* out = static_cast<T*>(m.out);
  const long long cols = m.cols, rows = m.rows;
  const long long rstep = static_cast<long long>(chunks) * rp;
  long long r = static_cast<long long>(chunk) * rp + (threadIdx.x >> sh);
  for (; r + (FWD_UNROLL - 1) * rstep < rows; r += FWD_UNROLL * rstep)
    channel_round<T, VEC, FWD_UNROLL>(x, out, r, rstep, cols, c0, width, fc);
  for (; r < rows; r += rstep)
    channel_round<T, VEC, 1>(x, out, r, rstep, cols, c0, width, fc);
}

template <typename T>
__device__ __forceinline__ void fwd_body(const FwdMember& m, int b) {
  if (m.layout == PER_CHANNEL) {
    if (m.vec) fwd_channel<T, true>(m, b);
    else fwd_channel<T, false>(m, b);
  } else if (m.layout == PER_TENSOR) {
    if (m.vec) fwd_flat<T, PER_TENSOR, true>(m, b);
    else fwd_flat<T, PER_TENSOR, false>(m, b);
  } else {
    if (m.vec) fwd_flat<T, PER_PARAM, true>(m, b);
    else fwd_flat<T, PER_PARAM, false>(m, b);
  }
}

// A member over groups of rows (the per-expert layouts): block b serves group
// b / (blocks / groups) as a member of its own, its x, out and f moved to the
// group's rows and f values.
template <typename T>
__device__ __forceinline__ void fwd_member(const FwdMember& m, int b) {
  if (m.groups == 1) {
    fwd_body<T>(m, b);
    return;
  }
  const int per = m.blocks / m.groups;
  const int grp = b / per;
  FwdMember s = m;
  s.rows = m.rows / m.groups;
  s.blocks = per;
  s.groups = 1;
  const long long off = static_cast<long long>(grp) * s.rows * m.cols;
  s.x = static_cast<const T*>(m.x) + off;
  s.out = static_cast<T*>(m.out) + off;
  s.f = m.f + (m.layout == PER_CHANNEL ? static_cast<long long>(grp) * m.cols
                                       : grp);
  fwd_body<T>(s, b - grp * per);
}

// Block b serves the last member whose first block is at or before b.
__global__ void __launch_bounds__(FWD_THREADS)
hgq_fwd_group_kernel(const __grid_constant__ FwdTable t) {
  const int blk = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.m[mid].block0 <= blk) lo = mid;
    else hi = mid - 1;
  }
  const FwdMember& m = t.m[lo];
  if (m.bf16) fwd_member<__nv_bfloat16>(m, blk - m.block0);
  else fwd_member<float>(m, blk - m.block0);
}

// Per channel.  grid (blocks of the clusters along the rows, 32-column tiles,
// groups), clusters of `cs` blocks along x.  Grid z is the group: its `rows` rows
// and cols f values, reduced alone (one group but per expert).  Block b takes
// rows [b * span, (b + 1) * span) of its group; lane: V columns of the tile (TPR
// lanes across it) and one of the block's 8 V row phases (phase p takes rows p,
// p + 8 V, ...).  dst: df [groups, cols], or with several clusters the partials
// [groups, clusters, cols].
template <typename T, bool VEC>
__global__ void __launch_bounds__(RED_THREADS)
hgq_bwd_channel_kernel(const T* __restrict__ g, const T* __restrict__ x,
                       const float* __restrict__ f, float* __restrict__ dst,
                       long long rows, int cols, long long span, int cs) {
  constexpr int V = vec_of<T>();
  {
    const long long grp = blockIdx.z;
    g += grp * rows * cols;
    x += grp * rows * cols;
    f += grp * cols;
    dst += grp * (gridDim.x / cs) * cols;
  }
  constexpr int TPR = COL_TILE / V;
  constexpr int PH = RED_WARPS * V;
  __shared__ float wsum[RED_WARPS][COL_TILE];
  __shared__ float slots[CLUSTER][COL_TILE];  // rank 0: a row a rank
  __shared__ unsigned long long mbar;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  if (cs > 1) {
    if (rank == 0 && threadIdx.x == 0)
      Exchange::expect(&mbar, (cs - 1) * COL_TILE * sizeof(float));
    Exchange::arrive();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pw = lane / TPR;
  const int c0 = blockIdx.y * COL_TILE + (lane % TPR) * V;
  const long long r0 = static_cast<long long>(blockIdx.x) * span;
  const long long r1 = r0 + span < rows ? r0 + span : rows;
  const int width = cols - c0 < V ? cols - c0 : V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (c0 < cols) {
    extern __shared__ uint4 stage[];
    Batch<T, VEC> batch;
    batch.slots = stage;
    for (long long r = r0 + warp * V + pw; r < r1; r += BATCH * PH) {
      int valid[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const long long rb = r + b * PH;
        valid[b] = rb < r1 ? width : 0;
        batch.fetch(g, x, b, rb * cols + c0, valid[b], r * cols + c0);
      }
      Grid q[V];
#pragma unroll
      for (int j = 0; j < V; ++j) q[j] = grid_of(f[c0 + (j < width ? j : 0)]);
      batch.wait();
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        float gv[V], xv[V];
        widen(batch.gb(b), g, gv);
        widen(batch.xb(b), x, xv);
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = __fadd_rn(
              acc[j], j < valid[b] ? term_on<T>(gv[j], xv[j], q[j]) : 0.f);
      }
    }
  }
  // the warp's V phases of each column: lanes TPR apart, a fixed xor tree
#pragma unroll
  for (int off = TPR; off < 32; off *= 2) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xFFFFFFFFu, acc[j], off));
  }
  if (pw == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) wsum[warp][(lane % TPR) * V + j] = acc[j];
  }
  __syncthreads();
  if (cs > 1) Exchange::wait();
  if (threadIdx.x < COL_TILE) {
    float w[RED_WARPS];
#pragma unroll
    for (int k = 0; k < RED_WARPS; ++k) w[k] = wsum[k][threadIdx.x];
    const float part = tree_sum<RED_WARPS>(w);
    if (rank != 0) {
      Exchange::send(&slots[rank][threadIdx.x], part, &mbar);
    } else {
      float s = part;
      if (cs > 1) {
        if (Exchange::receive(&mbar))
          for (int k = 1; k < cs; ++k) s = __fadd_rn(s, slots[k][threadIdx.x]);
        else
          s = __int_as_float(0x7FC00000);
      }
      const int c = blockIdx.y * COL_TILE + threadIdx.x;
      if (c < cols) dst[static_cast<long long>(blockIdx.x / cs) * cols + c] = s;
    }
  }
}

// Per tensor.  grid (blocks of the clusters, groups), clusters of `cs` blocks.
// Grid y is the group: its n elements and its one f, reduced alone.  Block b
// takes elements [b * span, (b + 1) * span) of its group, span a multiple of the
// block's step; a thread V consecutive elements a step, summed by a fixed tree.
// dst: df [groups], or with several clusters the partials [groups, clusters].
template <typename T, bool VEC>
__global__ void __launch_bounds__(RED_THREADS)
hgq_bwd_tensor_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      const float* __restrict__ f, float* __restrict__ dst,
                      long long n, long long span, int cs) {
  constexpr int V = vec_of<T>();
  {
    const long long grp = blockIdx.y;
    g += grp * n;
    x += grp * n;
    f += grp;
    dst += grp * (gridDim.x / cs);
  }
  constexpr long long STEP = static_cast<long long>(RED_THREADS) * V;
  __shared__ float wsum[RED_WARPS];
  __shared__ float slots[CLUSTER];  // rank 0: one a rank
  __shared__ unsigned long long mbar;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  if (cs > 1) {
    if (rank == 0 && threadIdx.x == 0)
      Exchange::expect(&mbar, (cs - 1) * sizeof(float));
    Exchange::arrive();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long e0 = static_cast<long long>(blockIdx.x) * span;
  const long long e1 = e0 + span < n ? e0 + span : n;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  extern __shared__ uint4 stage[];
  Batch<T, VEC> batch;
  batch.slots = stage;
  for (long long e = e0 + threadIdx.x * V; e < e1; e += BATCH * STEP) {
    int valid[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const long long eb = e + b * STEP;
      valid[b] = eb >= e1 ? 0 : e1 - eb < V ? static_cast<int>(e1 - eb) : V;
      batch.fetch(g, x, b, eb, valid[b], e);
    }
    const Grid q = grid_of(f[0]);
    batch.wait();
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      float gv[V], xv[V];
      widen(batch.gb(b), g, gv);
      widen(batch.xb(b), x, xv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] = __fadd_rn(acc[j],
                           j < valid[b] ? term_on<T>(gv[j], xv[j], q) : 0.f);
    }
  }
  float s = tree_sum<V>(acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s = __fadd_rn(s, __shfl_xor_sync(0xFFFFFFFFu, s, off));
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  if (cs > 1) Exchange::wait();
  if (threadIdx.x == 0) {
    const float part = tree_sum<RED_WARPS>(wsum);
    if (rank != 0) {
      Exchange::send(&slots[rank], part, &mbar);
    } else {
      float t = part;
      if (cs > 1) {
        if (Exchange::receive(&mbar))
          for (int k = 1; k < cs; ++k) t = __fadd_rn(t, slots[k]);
        else
          t = __int_as_float(0x7FC00000);
      }
      dst[blockIdx.x / cs] = t;
    }
  }
}

// second pass, per channel: df[grp, c] = the group's clusters' partials of
// column c, in cluster order
__global__ void hgq_bwd_sum_cols_kernel(const float* __restrict__ part,
                                        float* __restrict__ df, long long nc,
                                        int cols, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long grp = i / cols, c = i - grp * cols;
  const float* p = part + grp * nc * cols + c;
  float s = p[0];
  for (long long k = 1; k < nc; ++k) s = __fadd_rn(s, p[k * cols]);
  df[i] = s;
}

// second pass, per tensor: block b writes df[b], the sum of group b's clusters'
// partials, thread t adding t, t + RED_THREADS, ... in order, then the fixed
// trees of the block
__global__ void __launch_bounds__(RED_THREADS)
hgq_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ df,
                   long long nc) {
  __shared__ float wsum[RED_WARPS];
  part += static_cast<long long>(blockIdx.x) * nc;
  df += blockIdx.x;
  float s = 0.f;
  for (long long k = threadIdx.x; k < nc; k += RED_THREADS)
    s = __fadd_rn(s, part[k]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s = __fadd_rn(s, __shfl_xor_sync(0xFFFFFFFFu, s, off));
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) df[0] = tree_sum<RED_WARPS>(wsum);
}

int ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return static_cast<int>(b < EW_MAX_BLOCKS ? b : EW_MAX_BLOCKS);
}

// blocks a cluster, clusters, rows (per channel) or elements (per tensor) a block
struct Plan {
  long long cs, nc, span;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// A layout as the kernels run it: the per-channel, per-tensor or per-parameter
// body over `groups` groups of `rows` rows each (rows the group's, cols the
// tensor's).  The per-expert layouts are the first two over E groups of
// group_rows rows; every other layout takes group_rows == rows, one group.
struct Shape {
  long long rows;  // a group's
  int cols, layout, groups;
};

bool shape_of(long long rows, long long cols, int layout, long long group_rows,
              Shape* sh) {
  if (rows <= 0 || cols <= 0 || cols > INT_MAX || layout < PER_TENSOR ||
      layout > PER_EXPERT_TENSOR || group_rows <= 0 || rows % group_rows)
    return false;
  const bool expert = layout >= PER_EXPERT_CHANNEL;
  if (!expert && group_rows != rows) return false;
  if (rows / group_rows > 65535) return false;  // a grid axis of the backward
  sh->rows = group_rows;
  sh->cols = static_cast<int>(cols);
  sh->layout = layout == PER_EXPERT_CHANNEL  ? PER_CHANNEL
               : layout == PER_EXPERT_TENSOR ? PER_TENSOR
                                             : layout;
  sh->groups = static_cast<int>(rows / group_rows);
  return true;
}

// rows (per channel) or elements (per tensor) one batch of a block covers, and
// the multiple a block's span keeps
long long batch_units(int layout, int bf16) {
  const int v = bf16 ? 8 : 4;
  return layout == PER_CHANNEL ? static_cast<long long>(RED_WARPS) * v * BATCH
                               : static_cast<long long>(RED_THREADS) * v * BATCH;
}
long long span_step(int layout, int bf16) {
  return layout == PER_CHANNEL ? 1 : RED_THREADS * (bf16 ? 8 : 4);
}

// one group's plan: every group of a launch has the same
Plan plan_for(const Shape& sh, int bf16) {
  const long long n = sh.layout == PER_CHANNEL
                          ? sh.rows
                          : sh.rows * static_cast<long long>(sh.cols);
  const long long unit = batch_units(sh.layout, bf16);
  const long long step = span_step(sh.layout, bf16);
  const long long blocks = cdiv(n, unit);
  Plan p;
  if (blocks <= CLUSTER * ONE_CLUSTER_BATCHES) {
    p.nc = 1;
    p.cs = std::min<long long>(CLUSTER, blocks);
    p.span = cdiv(cdiv(n, p.cs), step) * step;
  } else {
    p.cs = CLUSTER;
    p.nc = cdiv(blocks, CLUSTER);
    p.span = unit;
  }
  return p;
}

// the partials of every group's clusters, where a group has more than one
long long scratch_of(const Plan& p, const Shape& sh) {
  return p.nc > 1
             ? sh.groups * p.nc * (sh.layout == PER_CHANNEL ? sh.cols : 1)
             : 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a kernel over thread block clusters of cs blocks along x, with smem bytes of
// dynamic shared memory
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int cs,
                            int smem, cudaStream_t st, Args... args) {
  if constexpr (CLUSTER > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(RED_THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
cudaError_t bwd(const void* g, const void* x, const float* f, float* df,
                float* scratch, const Shape& sh, const Plan& p,
                cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  const long long n = sh.rows * static_cast<long long>(sh.cols);  // a group's
  if (sh.layout == PER_PARAM) {
    bwd_param_kernel<T><<<ew_blocks(n), EW_THREADS, 0, st>>>(gt, xt, f, df, n);
    return cudaGetLastError();
  }
  constexpr int V = vec_of<T>();
  const int cs = static_cast<int>(p.cs);
  const unsigned blocks = static_cast<unsigned>(p.cs * p.nc);
  const unsigned groups = static_cast<unsigned>(sh.groups);
  float* dst = p.nc > 1 ? scratch : df;
  // 16-byte loads where g and x are aligned and every vector lies whole in a
  // row (per tensor: in a group); the same sums either way
  const bool vec = aligned16(g) && aligned16(x) &&
                   (sh.layout == PER_CHANNEL ? sh.cols : n) % V == 0;
  const int smem = vec ? STAGE_BYTES : 0;
  cudaError_t e;
  if (sh.layout == PER_CHANNEL) {
    const dim3 grid(blocks, static_cast<unsigned>(cdiv(sh.cols, COL_TILE)),
                    groups);
    e = launch_clusters(vec ? hgq_bwd_channel_kernel<T, true>
                            : hgq_bwd_channel_kernel<T, false>,
                        grid, cs, smem, st, gt, xt, f, dst, sh.rows, sh.cols,
                        p.span, cs);
    const long long total = static_cast<long long>(sh.groups) * sh.cols;
    if (e == cudaSuccess && p.nc > 1)
      hgq_bwd_sum_cols_kernel<<<static_cast<unsigned>(cdiv(total, RED_THREADS)),
                                RED_THREADS, 0, st>>>(scratch, df, p.nc,
                                                      sh.cols, total);
  } else {
    e = launch_clusters(vec ? hgq_bwd_tensor_kernel<T, true>
                            : hgq_bwd_tensor_kernel<T, false>,
                        dim3(blocks, groups), cs, smem, st, gt, xt, f, dst, n,
                        p.span, cs);
    if (e == cudaSuccess && p.nc > 1)
      hgq_bwd_sum_kernel<<<groups, RED_THREADS, 0, st>>>(scratch, df, p.nc);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Descriptor values a member takes: x, f, out, rows, cols, layout, bf16,
// group_rows.
constexpr int DESC = 8;

// One member of the forward from its descriptor; its blocks follow from rows,
// cols, layout, group rows and dtype.
bool plan_member(const long long* d, long long block0, FwdMember* m) {
  const long long rows = d[3], cols = d[4], layout = d[5], bf16 = d[6];
  Shape sh;
  if (layout < PER_TENSOR || layout > PER_EXPERT_TENSOR ||
      !shape_of(rows, cols, static_cast<int>(layout), d[7], &sh) ||
      (bf16 != 0 && bf16 != 1) || block0 > INT_MAX)
    return false;
  m->x = reinterpret_cast<const void*>(d[0]);
  m->f = reinterpret_cast<const float*>(d[1]);
  m->out = reinterpret_cast<void*>(d[2]);
  m->rows = rows;
  m->cols = sh.cols;
  m->layout = static_cast<unsigned char>(sh.layout);
  m->bf16 = static_cast<unsigned char>(bf16);
  m->groups = sh.groups;
  const long long v = bf16 ? 8 : 4;
  bool vec = aligned16(m->x) && aligned16(m->out);
  // a group's blocks; the groups share the member's most blocks
  const long long most = std::max<long long>(1, FWD_MAX_BLOCKS / sh.groups);
  long long blocks;
  m->ctiles = 1;
  m->tpr_log2 = 0;
  if (sh.layout == PER_CHANNEL) {
    vec = vec && cols % v == 0;
    const long long cvecs = cdiv(cols, v);
    int s = 0;  // lanes across a row: the column vectors, up to a warp
    while ((1LL << s) < cvecs && s < 5) ++s;
    m->tpr_log2 = static_cast<unsigned char>(s);
    const long long ctiles = cdiv(cvecs, 1LL << s);
    const long long rp = FWD_THREADS >> s;
    const long long chunks = std::min(cdiv(sh.rows, rp),
                                      std::max<long long>(1, most / ctiles));
    m->ctiles = static_cast<int>(ctiles);
    blocks = ctiles * chunks;
  } else {
    const long long n = sh.rows * cols;  // a group's
    if (sh.layout == PER_PARAM) vec = vec && aligned16(m->f);
    // a group starts on a 16-byte boundary only if its elements are whole
    // vectors
    if (sh.groups > 1) vec = vec && n % v == 0;
    blocks = std::min<long long>(cdiv(cdiv(n, v), FWD_THREADS), most);
  }
  blocks *= sh.groups;
  if (blocks > INT_MAX) return false;
  m->vec = vec;
  m->block0 = static_cast<int>(block0);
  m->blocks = static_cast<int>(blocks);
  return true;
}

// desc: count rows of DESC values
cudaError_t fwd_group(const long long* desc, int count, cudaStream_t st) {
  if (count < 1 || count > FWD_MAX_MEMBERS) return cudaErrorInvalidValue;
  FwdTable t = {};
  t.count = count;
  long long total = 0;
  for (int i = 0; i < count; ++i) {
    if (!plan_member(desc + DESC * i, total, &t.m[i]))
      return cudaErrorInvalidValue;
    total += t.m[i].blocks;
  }
  if (total > INT_MAX) return cudaErrorInvalidValue;
  hgq_fwd_group_kernel<<<static_cast<unsigned>(total), FWD_THREADS, 0, st>>>(t);
  return cudaGetLastError();
}

}  // namespace

// The backward's geometry for x as [rows, cols] at a per-channel, per-tensor or
// per-expert layout (group_rows rows an expert; rows otherwise) and x's dtype,
// the same for every group: plan[0] blocks a cluster, plan[1] clusters a group
// (above 1, a second pass adds their partials), plan[2] rows (per channel) or
// elements (per tensor) a block.  Returns the floats of scratch it needs (0: one
// launch, none), or -1 for a shape or layout the backward does not take.
extern "C" long long hgq_quantize_bwd_plan(long long rows, int cols, int layout,
                                           int bf16, long long group_rows,
                                           long long* plan) {
  Shape sh;
  if (!shape_of(rows, cols, layout, group_rows, &sh) || sh.layout == PER_PARAM)
    return -1;
  const Plan p = plan_for(sh, bf16);
  plan[0] = p.cs;
  plan[1] = p.nc;
  plan[2] = p.span;
  return scratch_of(p, sh);
}

// x, out: [rows, cols] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// f: float32, 1 value, [cols], [rows, cols], [rows / group_rows, cols] or
// [rows / group_rows] by layout (0 per tensor, 1 per channel, 2 per parameter,
// 3 per expert channel, 4 per expert tensor); group_rows: the rows an expert
// (3, 4), else rows.  A group of one.
extern "C" int hgq_quantize_fwd_launch(const void* x, const float* f, void* out,
                                       long long rows, int cols, int layout,
                                       int bf16, long long group_rows,
                                       void* stream) {
  const long long d[DESC] = {reinterpret_cast<long long>(x),
                             reinterpret_cast<long long>(f),
                             reinterpret_cast<long long>(out),
                             rows, cols, layout, bf16, group_rows};
  return static_cast<int>(fwd_group(d, 1, static_cast<cudaStream_t>(stream)));
}

// The members of one launch: desc holds, for each of `count` (1..64) members,
// x, f and out (device pointers), rows, cols, layout, bf16 and group_rows, each
// as above.
extern "C" int hgq_quantize_fwd_group_launch(const long long* desc, int count,
                                             void* stream) {
  return static_cast<int>(
      fwd_group(desc, count, static_cast<cudaStream_t>(stream)));
}

// The most members one grouped launch takes.
extern "C" int hgq_quantize_fwd_group_max() { return FWD_MAX_MEMBERS; }

// g, x: [rows, cols] contiguous in x's dtype; df: float32 in f's layout;
// group_rows as for the forward; scratch: the floats hgq_quantize_bwd_plan
// returns (null if 0).
extern "C" int hgq_quantize_bwd_launch(const void* g, const void* x,
                                       const float* f, float* df,
                                       float* scratch, long long rows, int cols,
                                       int layout, int bf16,
                                       long long group_rows, void* stream) {
  Shape sh;
  if (!shape_of(rows, cols, layout, group_rows, &sh) ||
      cdiv(cols, COL_TILE) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(sh, bf16);  // unused per parameter
  if (sh.layout != PER_PARAM && scratch_of(p, sh) > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? bwd<__nv_bfloat16>(g, x, f, df, scratch, sh, p, st)
           : bwd<float>(g, x, f, df, scratch, sh, p, st);
  return static_cast<int>(e);
}
