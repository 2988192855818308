// Wire compression kernels of the compressed data-parallel gradient reduce.
//
// wire_quantize_rows replaces src/repro/kernels/wire_pack/kernel.py:88
// (`wire_quantize_rows`, body `_quantize_rows_kernel` :56).
// wire_quantize_sflat replaces src/repro/kernels/wire_pack/kernel.py:117
// (`wire_quantize_sflat`, body `_quantize_sflat_kernel` :65).
// wire_pack_rows replaces src/repro/kernels/wire_pack/kernel.py:141
// (`wire_pack_rows`, body `_pack_kernel` :73).
// wire_dequant_rows replaces src/repro/kernels/wire_pack/kernel.py:161
// (`wire_dequant_rows`, body `_dequant_kernel` :82).
// wire_quantize_bucket and wire_dequant_bucket are the fused reduce's form of
// wire_quantize_sflat and wire_dequant_rows (the calls at
// src/repro/dist/collectives.py:480 and :528): one launch a bucket, reading and
// writing the members' tensors where they lie (below).
//
// quantize_rows.  Per stacked-layer row of P values and its shared amax: the
// 2^-f grid step s (largest f whose grid holds amax inside +-qmax mantissas, one
// lower where rounding would still saturate), q = clip(rint(x / s), +-qmax) as
// int8, s per row, and the error-feedback residual x - q * s, in one pass.
// quantize_sflat: the same with a given scale per position.  pack_rows: two
// int4-range mantissas per byte along a row, the even column in the low nibble,
// a zero high nibble on an odd tail.  dequant_rows: the phase-2 decode
// ((float(q) * 2^shift) * s) / n, with s per position or one row of scales
// shared by every row.
//
// Exactness.  Every result is bit-exact against the plain PyTorch version:
// floor(log2) comes from frexpf (torch.frexp, subnormals included), 2^f is built
// in the exponent field after the clamp to -126..127, rounding is rintf (half to
// even, the semantics of torch.round / jnp.round), the division is IEEE
// (__fdiv_rn, also in qmax / amax and in / n: a multiply by 1/n differs by an ulp
// for n that is not a power of two), and products and differences are rounded one
// by one (__fmul_rn, __fsub_rn: no FMA contraction).  No flush to zero: a
// subnormal residual stays.  The nibble pack works on the unsigned byte.
//
// Layout: one block row of the grid per tensor row (blockIdx.y strides rows),
// the blocks of a row stride its columns, one element per thread per step, so no
// lane alignment or padding is needed and any P works.  Bound: bytes (a few
// operations per element); quantize moves 9 bytes an element, pack 1.5, dequant
// 9 (the scale read per position).
//
// pack_rows with an even C (every shape the fused reduce launches: its chunks are
// padded to an even width) packs the flat R * C bytes as one run, since the packed
// rows then lie back to back.  One-byte loads and stores left it issue-bound at
// ~1.5 TB/s; here a thread packs 16-byte vectors: two 16-byte read-only loads (32
// mantissas), the low nibbles masked and the odd bytes shifted by 4 in each word,
// the bytes gathered with one prmt a word, one 16-byte store.  The output vectors
// start at the first 16-byte-aligned output byte (the bytes before it, and the
// tail, take the scalar path).  The wrapper takes any contiguous view, so the
// input of a vector may sit 1-15 bytes past a 16-byte boundary: then a thread
// reads the three aligned 16-byte pieces that hold its 32 bytes (never beyond
// those pieces) and funnel-shifts them into place.
//
// Geometry: WIRE_PACK_VECS vectors a thread (all loaded before the first is
// stored) and WIRE_PACK_BLOCKS_PER_SM, a cap on the grid (0: none), set at build
// time.  torch_kernel_sweep.py times other values at the qwen2 reduce's large
// shapes: two or four vectors a thread and caps of 4-16 blocks an SM are no
// faster than one vector a thread on an uncapped grid, a cap of 2 blocks an SM
// is slower (too few loads in flight), and a view 1 byte off alignment takes
// the aligned time.  Odd C keeps the per-row kernel.
//
// Bucket kernels.  The fused reduce puts the leaves of a bucket side by side in
// a chunk layout [n, W]: member i (T values, L grid rows of P, C = ceil(T / n),
// ceven = C rounded up to even in a nibble bucket) owns columns off_i .. off_i +
// ceven_i, its flat position t = d * C + c in chunk row d, column c; the rest of
// its columns are padding (a zero mantissa).  Built in PyTorch that layout cost
// pads of the values, a float32 grid step expanded to every position, a cat of
// each, and on the way back per-leaf slices, a zero buffer per leaf for the
// owner's remainder and an add: ~68 bytes an element around 13 + 9 in the
// kernels.  Here the layout is index arithmetic only.
// - quantize_bucket reads each leaf (float32 or bfloat16) where it lies and
//   its [L] steps, writes the int8 payload [n, W] (0 on the padding) and the
//   float32 residual in the leaf's own flat order: 4 (2) bytes read, 5 written
//   an element.
// - dequant_bucket reads the gathered payload as it arrived (int8 [n, W] or
//   nibble pairs [n, W / 2]), the own-chunk remainder err [W] and the
//   residual, and writes each member's delivered mean ((q * 2^shift) * s) / n
//   and residual r + (d == idx ? err * s : 0.0f) in its dtype (the float32
//   residual in place).  The + 0.0f is the plain version's add of a zero
//   buffer: it turns a -0.0 residual into +0.0.  1 (1/2) + 4 read, 8 (4)
//   written an element (float32 leaf; err on 1/n of them).
// A table of up to 64 members sits in the kernel's parameter space
// (__grid_constant__, as hgq_fwd_group_kernel's); a bucket with more is split
// into launches of 64 in member order.  Member i takes n * ceil(ceven / SPAN)
// blocks, one a (chunk row d, span of SPAN columns): t = d * C + c is then
// contiguous along the span, so neither t / C nor t % C is taken per element.
// A block finds its member by binary search over first blocks (from the shapes
// alone).  Work comes in groups of 16 bytes of the leaf's dtype (4 float32 or 8
// bfloat16 values): group g holds t in [V g - a, V g - a + V), a set from where
// the leaf (quantize) or the delivered output (dequant) lies, so the 16-byte
// side is aligned at any offset; the wrapper places the residual (and the
// dequant's outputs) on the same grid, else the member takes every group
// element by element (vec = 0), in the same map.  A group whose t-range leaves
// the span (a chunk row's edge) goes element by element too.  A group finds
// its grid row once (t / P) and walks rows forward from there, reading a step
// at each row change.  Payload bytes move as one word where that word is
// aligned (per chunk row, since W, off and C need not be), else byte by byte.
// A group cut by a span's edge loads its elements first and then computes and
// stores them (a store may alias the residual it read), one memory latency a
// group.  Geometry, set at build time (torch_kernel_sweep.py times others):
// WIRE_BUCKET_QUANT_GROUPS / WIRE_BUCKET_DEQUANT_GROUPS, the 16-byte groups a
// thread loads before it computes (a block spans 256 threads times those
// groups), and WIRE_BUCKET_QUANT_MIN_BLOCKS / WIRE_BUCKET_DEQUANT_MIN_BLOCKS,
// the blocks an SM each kernel is built to hold (__launch_bounds__).  At the
// qwen2 reduce's largest buckets the quantize is fastest at 4 groups and no
// register cap, the decode at 2 groups and 4 blocks an SM (64 registers).  The
// math is quant()'s and dequant_rows'.
// Later work: fusing the pack into the quantize; one launch a bucket for all
// ranks of a LocalMesh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 8;
constexpr long long MAX_GRID_Y = 65535;
constexpr long long SMS = 132;

// the flat pack's geometry: vectors a thread, blocks an SM at most (0: a block
// per THREADS * PACK_VECS vectors)
#ifndef WIRE_PACK_VECS
#define WIRE_PACK_VECS 1
#endif
#ifndef WIRE_PACK_BLOCKS_PER_SM
#define WIRE_PACK_BLOCKS_PER_SM 0
#endif
constexpr int PACK_VECS = WIRE_PACK_VECS;
constexpr long long PACK_BLOCKS_PER_SM = WIRE_PACK_BLOCKS_PER_SM;

__device__ __forceinline__ float exact_exp2(float fi) {
  fi = fminf(fmaxf(fi, -126.f), 127.f);
  return __int_as_float((static_cast<int>(fi) + 127) << 23);
}

// floor(log2 v) for v > 0 as torch.frexp gives it (subnormals included)
__device__ __forceinline__ float floor_log2(float v) {
  int e;
  frexpf(v, &e);
  return static_cast<float>(e - 1);
}

// the wire grid step of a row: 2^-grid_exponent(amax)
__device__ __forceinline__ float grid_scale(float amax, float qmax) {
  const float fcap = floor_log2(__fdiv_rn(qmax, fmaxf(amax, 1e-12f)));
  const float top = floorf(__fadd_rn(__fmul_rn(amax, exact_exp2(fcap)), 0.5f));
  const float f = top > qmax ? fcap - 1.f : fcap;
  return exact_exp2(-f);
}

// q = clip(rint(x / s), +-qmax) as int8, and the residual x - q * s
__device__ __forceinline__ int8_t quant(float x, float s, float qmax,
                                        float* res) {
  const float qv = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -qmax), qmax);
  const int8_t q = static_cast<int8_t>(static_cast<int>(qv));
  *res = __fsub_rn(x, __fmul_rn(static_cast<float>(q), s));
  return q;
}

// blocks per row so that the whole grid holds about MAX_BLOCKS blocks
dim3 grid_for(long long rows, long long cols) {
  const long long gy = rows < MAX_GRID_Y ? rows : MAX_GRID_Y;
  long long gx = (cols + THREADS - 1) / THREADS;
  const long long cap = MAX_BLOCKS / gy > 0 ? MAX_BLOCKS / gy : 1;
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
}

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const float* __restrict__ amax,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ s_out,
                                     float* __restrict__ r, long long L,
                                     long long P, float qmax) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < L; row += gridDim.y) {
    const float s = grid_scale(amax[row], qmax);
    if (blockIdx.x == 0 && threadIdx.x == 0) s_out[row] = s;
    const long long base = row * P;
    for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         c < P; c += stride) {
      float res;
      q[base + c] = quant(x[base + c], s, qmax, &res);
      r[base + c] = res;
    }
  }
}

__global__ void quantize_sflat_kernel(const float* __restrict__ x,
                                      const float* __restrict__ s,
                                      int8_t* __restrict__ q,
                                      float* __restrict__ r, long long n,
                                      float qmax) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float res;
    q[i] = quant(x[i], s[i], qmax, &res);
    r[i] = res;
  }
}

__global__ void pack_rows_kernel(const int8_t* __restrict__ q,
                                 int8_t* __restrict__ out, long long R,
                                 long long C) {
  const long long half = (C + 1) / 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < R; row += gridDim.y) {
    const int8_t* src = q + row * C;
    for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         j < half; j += stride) {
      const uint8_t lo = static_cast<uint8_t>(src[2 * j]);
      const uint8_t hi = 2 * j + 1 < C ? static_cast<uint8_t>(src[2 * j + 1])
                                       : static_cast<uint8_t>(0);
      out[row * half + j] = static_cast<int8_t>(
          static_cast<uint8_t>((lo & 0x0F) | static_cast<uint8_t>(hi << 4)));
    }
  }
}

// two packed bytes from one word of four mantissas: byte 0 holds
// (b0 & 0xF) | (b1 << 4), byte 2 holds (b2 & 0xF) | (b3 << 4)
__device__ __forceinline__ uint32_t pack_pairs(uint32_t w) {
  return (w & 0x000F000Fu) | ((w >> 4) & 0x00F000F0u);
}

// four packed bytes from eight mantissas (two words, in memory order)
__device__ __forceinline__ uint32_t pack_word(uint32_t a, uint32_t b) {
  return __byte_perm(pack_pairs(a), pack_pairs(b), 0x6420);
}

__device__ __forceinline__ int8_t pack_byte(const uint8_t* q, long long j) {
  return static_cast<int8_t>(
      static_cast<uint8_t>((q[2 * j] & 0x0F) | (q[2 * j + 1] << 4)));
}

// the 32 bytes at p as eight words; off = p % 16, the same for every vector
__device__ __forceinline__ void load32(const uint8_t* p, int off,
                                       uint32_t w[8]) {
  if (off == 0) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
  // the three aligned pieces holding bytes p .. p + 31
  const uint4* base = reinterpret_cast<const uint4*>(p - off);
  const uint4 a = __ldg(base), b = __ldg(base + 1), c = __ldg(base + 2);
  const uint32_t u[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                          b.z, b.w, c.x, c.y, c.z, c.w};
  const int ws = off >> 2, sh = (off & 3) * 8;
  uint32_t v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    v[i] = ws == 0 ? u[i] : ws == 1 ? u[i + 1] : ws == 2 ? u[i + 2] : u[i + 3];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = __funnelshift_r(v[i], v[i + 1], sh);
}

// out[j] = pack_byte(q, j) for j < n: bytes [0, head) and [head + 16 nvec, n)
// one a thread, then 16-byte vectors, PACK_VECS a thread a step (all loaded
// before the first is stored); in_off is (q + 2 head) % 16
__global__ void pack_flat_kernel(const uint8_t* __restrict__ q,
                                 int8_t* __restrict__ out, long long n,
                                 long long head, long long nvec, int in_off) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tail = head + 16 * nvec;
  if (t < head) out[t] = pack_byte(q, t);
  if (t < n - tail) out[tail + t] = pack_byte(q, tail + t);
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  for (long long v0 = t; v0 < nvec; v0 += PACK_VECS * threads) {
    uint32_t w[PACK_VECS][8];
#pragma unroll
    for (int k = 0; k < PACK_VECS; ++k) {
      const long long v = v0 + k * threads;
      if (v < nvec) load32(q + 2 * head + 32 * v, in_off, w[k]);
    }
#pragma unroll
    for (int k = 0; k < PACK_VECS; ++k) {
      const long long v = v0 + k * threads;
      if (v < nvec)
        dst[v] = make_uint4(pack_word(w[k][0], w[k][1]),
                            pack_word(w[k][2], w[k][3]),
                            pack_word(w[k][4], w[k][5]),
                            pack_word(w[k][6], w[k][7]));
    }
  }
}

// the flat pack of n output bytes: vectors from the first 16-byte-aligned output
// byte on
void launch_pack_flat(const int8_t* q, int8_t* out, long long n,
                      cudaStream_t st) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(q);
  long long head = static_cast<long long>(
      (16 - reinterpret_cast<uintptr_t>(out) % 16) % 16);
  if (head > n) head = n;
  const long long nvec = (n - head) / 16;
  const int in_off =
      static_cast<int>(reinterpret_cast<uintptr_t>(src + 2 * head) % 16);
  // at least one block: its first threads take the scalar bytes (< 32)
  long long blocks = (nvec + THREADS * PACK_VECS - 1) / (THREADS * PACK_VECS);
  if (PACK_BLOCKS_PER_SM > 0 && blocks > SMS * PACK_BLOCKS_PER_SM)
    blocks = SMS * PACK_BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  pack_flat_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      src, out, n, head, nvec, in_off);
}

// s_stride: C when s holds a scale per position, 0 when one row of C scales
// serves every row
__global__ void dequant_rows_kernel(const int8_t* __restrict__ q,
                                    const float* __restrict__ s,
                                    float* __restrict__ out, long long R,
                                    long long C, long long s_stride, float mul,
                                    float n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < R; row += gridDim.y) {
    const long long base = row * C;
    const float* srow = s + row * s_stride;
    for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         c < C; c += stride) {
      const float v = __fmul_rn(__fmul_rn(static_cast<float>(q[base + c]), mul),
                                srow[c]);
      out[base + c] = __fdiv_rn(v, n);
    }
  }
}


// ---------------------------------------------------------------------------
// Bucket kernels
// ---------------------------------------------------------------------------

constexpr int BUCKET_THREADS = 256;
// members of one bucket launch (each table fits the 4 KB of parameter space
// every CUDA version takes)
constexpr int BUCKET_MAX_MEMBERS = 64;
// 16-byte groups a thread loads before it computes (quantize, dequant), and
// the blocks an SM each kernel is built to hold (__launch_bounds__)
#ifndef WIRE_BUCKET_QUANT_GROUPS
#define WIRE_BUCKET_QUANT_GROUPS 4
#endif
#ifndef WIRE_BUCKET_DEQUANT_GROUPS
#define WIRE_BUCKET_DEQUANT_GROUPS 2
#endif
#ifndef WIRE_BUCKET_QUANT_MIN_BLOCKS
#define WIRE_BUCKET_QUANT_MIN_BLOCKS 1
#endif
#ifndef WIRE_BUCKET_DEQUANT_MIN_BLOCKS
#define WIRE_BUCKET_DEQUANT_MIN_BLOCKS 4
#endif
constexpr int QUANT_GROUPS = WIRE_BUCKET_QUANT_GROUPS;
constexpr int DEQUANT_GROUPS = WIRE_BUCKET_DEQUANT_GROUPS;

template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

// columns of a chunk row one block takes: G groups a thread
template <typename T, int G>
__host__ __device__ constexpr int span_of() {
  return BUCKET_THREADS * vec_of<T>() * G;
}

struct QuantMember {
  const void* x;       // T values, float32 or bfloat16
  const float* step;   // [L] grid steps
  float* res;          // [T] residual
  int T, P, C, off, block0;
  unsigned char a, bf16, vec;
};

struct QuantTable {
  QuantMember m[BUCKET_MAX_MEMBERS];
  int8_t* q;           // [n, W]
  long long W;
  int n, count, nibble;
  float qmax;
};
static_assert(sizeof(QuantTable) <= 4096, "the table fits the parameter space");

struct DequantMember {
  void* dlv;           // [T] delivered, the leaf's dtype
  const float* res_in;  // [T]
  void* res_out;       // [T], the leaf's dtype (float32: res_in itself)
  const float* step;
  int T, P, C, off, block0;
  unsigned char a, bf16, vec;
};

struct DequantTable {
  DequantMember m[BUCKET_MAX_MEMBERS];
  const uint8_t* q;    // [n, W] int8 or [n, W / 2] nibble pairs
  const float* err;    // [W]
  long long W;
  int n, idx, count, nibble;
  float mul, nf;
};
static_assert(sizeof(DequantTable) <= 4096,
              "the table fits the parameter space");

// the grid step of positions t, walked forward: one division where the walk
// starts, a step read at each row change
struct RowWalk {
  const float* step;
  int P, r, next;
  float s;
  __device__ __forceinline__ RowWalk(const float* st, int p, int t)
      : step(st), P(p), r(t / p), next((t / p + 1) * p), s(st[t / p]) {}
  __device__ __forceinline__ float at(int t) {
    if (t >= next) {
      do {
        ++r;
        next += P;
      } while (t >= next);
      s = step[r];
    }
    return s;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes as V float32 values (four float32, or eight bfloat16 widened)
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

// V float32 values as 16 bytes of the dtype (the inverse of widen)
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

// V mantissas to V payload bytes at p: one word where p is V-aligned
template <int V>
__device__ __forceinline__ void store_bytes(int8_t* p, const int8_t* q) {
  if (reinterpret_cast<uintptr_t>(p) % V == 0) {
    uint32_t w[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      w[i] = static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i])) |
             static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i + 1])) << 8 |
             static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i + 2])) << 16 |
             static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i + 3])) << 24;
    if constexpr (V == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
    else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = q[i];
  }
}

// the mantissa at column col of a payload row: int8, or a sign-extended nibble
// (the even column in the low nibble)
__device__ __forceinline__ float mantissa(const uint8_t* row, long long col,
                                          int nibble) {
  if (!nibble) return static_cast<float>(static_cast<int8_t>(row[col]));
  const uint32_t b = row[col >> 1];
  return static_cast<float>(static_cast<int>(b << ((col & 1) ? 24 : 28)) >>
                            28);
}

// V mantissas from columns col .. col + V - 1 of a payload row: one load where
// the bytes are aligned, else one by one
template <int V>
__device__ __forceinline__ void load_mantissas(const uint8_t* row, long long col,
                                               int nibble, float* m) {
  if (!nibble) {
    const uint8_t* p = row + col;
    if (reinterpret_cast<uintptr_t>(p) % V == 0) {
      uint32_t w[V / 4];
      if constexpr (V == 4) {
        w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = u.x;
        w[1] = u.y;
      }
#pragma unroll
      for (int i = 0; i < V; ++i)
        m[i] = static_cast<float>(
            static_cast<int>(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
      return;
    }
  } else if ((col & 1) == 0 &&
             reinterpret_cast<uintptr_t>(row + (col >> 1)) % (V / 2) == 0) {
    const uint8_t* p = row + (col >> 1);
    uint32_t w;
    if constexpr (V == 4) w = __ldg(reinterpret_cast<const uint16_t*>(p));
    else w = __ldg(reinterpret_cast<const uint32_t*>(p));
#pragma unroll
    for (int i = 0; i < V; ++i)
      m[i] = static_cast<float>(static_cast<int>(w << (28 - 4 * i)) >> 28);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = mantissa(row, col + i, nibble);
}

// The block's chunk row d and its columns [c_lo, c_hi) of a member; its valid
// positions t = d C + c for c < cv.
struct Span {
  int d, c_lo, c_hi, cv, row0;
};

template <typename T, int G>
__device__ __forceinline__ Span span_for(int b, int C, int Tn, int nibble) {
  constexpr int SPAN = span_of<T, G>();
  const int ceven = nibble ? C + (C & 1) : C;
  const int spans = (ceven + SPAN - 1) / SPAN;
  Span sp;
  sp.d = b / spans;
  sp.c_lo = (b - sp.d * spans) * SPAN;
  sp.c_hi = min(sp.c_lo + SPAN, ceven);
  sp.row0 = sp.d * C;
  sp.cv = max(0, min(C, Tn - sp.row0));
  return sp;
}

template <typename T>
__device__ void quantize_member(const QuantTable& tb, const QuantMember& m,
                                int b) {
  constexpr int V = vec_of<T>();
  constexpr int G = QUANT_GROUPS;
  const Span sp = span_for<T, G>(b, m.C, m.T, tb.nibble);
  const T* __restrict__ x = static_cast<const T*>(m.x);
  float* __restrict__ res = m.res;
  int8_t* qrow = tb.q + static_cast<long long>(sp.d) * tb.W + m.off - sp.row0;
  const int t_lo = sp.row0 + sp.c_lo;
  const int t_hi = sp.row0 + min(sp.c_hi, sp.cv);
  if (t_lo < t_hi) {
    const int g_lo = (t_lo + m.a) / V, g_hi = (t_hi + m.a + V - 1) / V;
    for (int g0 = g_lo + threadIdx.x; g0 < g_hi;
         g0 += BUCKET_THREADS * G) {
      uint4 raw[G];
      bool full[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int g = g0 + k * BUCKET_THREADS;
        const int t0 = g * V - m.a;
        full[k] = m.vec && g < g_hi && t0 >= t_lo && t0 + V <= t_hi;
        if (full[k]) raw[k] = __ldg(reinterpret_cast<const uint4*>(x + t0));
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int g = g0 + k * BUCKET_THREADS;
        if (g >= g_hi) break;
        const int t0 = g * V - m.a;
        if (full[k]) {
          float v[V], r[V];
          int8_t qv[V];
          widen(raw[k], x, v);
          RowWalk w(m.step, m.P, t0);
#pragma unroll
          for (int j = 0; j < V; ++j)
            qv[j] = quant(v[j], w.at(t0 + j), tb.qmax, &r[j]);
#pragma unroll
          for (int j = 0; j < V / 4; ++j)
            reinterpret_cast<uint4*>(res + t0)[j] = narrow(r + 4 * j, res);
          store_bytes<V>(qrow + t0, qv);
        } else {
          // a group cut by the span's edge (or off the grid): its loads
          // first, then the math and the stores, element by element
          float v[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int t = t0 + j;
            v[j] = t >= t_lo && t < t_hi ? to_f32(x[t]) : 0.f;
          }
          RowWalk w(m.step, m.P, max(t0, t_lo));
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int t = t0 + j;
            if (t < t_lo || t >= t_hi) continue;
            float r;
            qrow[t] = quant(v[j], w.at(t), tb.qmax, &r);
            res[t] = r;
          }
        }
      }
    }
  }
  // the padding: columns past the valid ones (the last rows, and a nibble
  // bucket's odd C)
  int8_t* prow = qrow + sp.row0;
  for (int c = max(sp.c_lo, sp.cv) + threadIdx.x; c < sp.c_hi;
       c += BUCKET_THREADS)
    prow[c] = 0;
}

// Block b serves the last member whose first block is at or before b.
template <typename Table>
__device__ __forceinline__ int member_of(const Table& t, int blk) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.m[mid].block0 <= blk) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(BUCKET_THREADS, WIRE_BUCKET_QUANT_MIN_BLOCKS)
quantize_bucket_kernel(const __grid_constant__ QuantTable t) {
  const int blk = static_cast<int>(blockIdx.x);
  const QuantMember& m = t.m[member_of(t, blk)];
  if (m.bf16) quantize_member<__nv_bfloat16>(t, m, blk - m.block0);
  else quantize_member<float>(t, m, blk - m.block0);
}

template <typename T>
__device__ void dequant_member(const DequantTable& tb, const DequantMember& m,
                               int b) {
  constexpr int V = vec_of<T>();
  constexpr int G = DEQUANT_GROUPS;
  const Span sp = span_for<T, G>(b, m.C, m.T, tb.nibble);
  const int row_bytes = static_cast<int>(tb.nibble ? tb.W / 2 : tb.W);
  const uint8_t* qrow = tb.q + static_cast<long long>(sp.d) * row_bytes;
  // column of position t: m.off + t - row0
  const long long col0 = static_cast<long long>(m.off) - sp.row0;
  const float* err = sp.d == tb.idx ? tb.err + col0 : nullptr;
  // a float32 leaf's residual is written where it is read (rout == rin)
  T* __restrict__ dlv = static_cast<T*>(m.dlv);
  T* rout = static_cast<T*>(m.res_out);
  const float* rin = m.res_in;
  const int t_lo = sp.row0 + sp.c_lo;
  const int t_hi = sp.row0 + min(sp.c_hi, sp.cv);
  if (t_lo >= t_hi) return;
  const int g_lo = (t_lo + m.a) / V, g_hi = (t_hi + m.a + V - 1) / V;
  for (int g0 = g_lo + threadIdx.x; g0 < g_hi; g0 += BUCKET_THREADS * G) {
    uint4 raw[G][V / 4];
    bool full[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int g = g0 + k * BUCKET_THREADS;
      const int t0 = g * V - m.a;
      full[k] = m.vec && g < g_hi && t0 >= t_lo && t0 + V <= t_hi;
      if (full[k]) {
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          raw[k][j] = reinterpret_cast<const uint4*>(rin + t0)[j];
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int g = g0 + k * BUCKET_THREADS;
      if (g >= g_hi) break;
      const int t0 = g * V - m.a;
      float q[V], r[V], e[V], dl[V];
      if (full[k]) {
        load_mantissas<V>(qrow, col0 + t0, tb.nibble, q);
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          widen(raw[k][j], static_cast<const float*>(nullptr), r + 4 * j);
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = err ? err[t0 + j] : 0.f;
        RowWalk w(m.step, m.P, t0);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float s = w.at(t0 + j);
          dl[j] = __fdiv_rn(__fmul_rn(__fmul_rn(q[j], tb.mul), s), tb.nf);
          r[j] = __fadd_rn(r[j], err ? __fmul_rn(e[j], s) : 0.0f);
        }
        *reinterpret_cast<uint4*>(dlv + t0) = narrow(dl, dlv);
        *reinterpret_cast<uint4*>(rout + t0) = narrow(r, rout);
      } else {
        // a group cut by the span's edge (or off the grid): its loads
        // first (rout may be rin), then the math and the stores
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int t = t0 + j;
          const bool in = t >= t_lo && t < t_hi;
          q[j] = in ? mantissa(qrow, col0 + t, tb.nibble) : 0.f;
          r[j] = in ? rin[t] : 0.f;
          e[j] = in && err ? err[t] : 0.f;
        }
        RowWalk w(m.step, m.P, max(t0, t_lo));
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int t = t0 + j;
          if (t < t_lo || t >= t_hi) continue;
          const float s = w.at(t);
          put(dlv + t,
              __fdiv_rn(__fmul_rn(__fmul_rn(q[j], tb.mul), s), tb.nf));
          put(rout + t, __fadd_rn(r[j], err ? __fmul_rn(e[j], s) : 0.0f));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(BUCKET_THREADS,
                                  WIRE_BUCKET_DEQUANT_MIN_BLOCKS)
dequant_bucket_kernel(const __grid_constant__ DequantTable t) {
  const int blk = static_cast<int>(blockIdx.x);
  const DequantMember& m = t.m[member_of(t, blk)];
  if (m.bf16) dequant_member<__nv_bfloat16>(t, m, blk - m.block0);
  else dequant_member<float>(t, m, blk - m.block0);
}

// A member's shape fields and its blocks (spans of G groups a thread) from T,
// L and n; false where a field would leave int range.
template <int G>
bool plan_shape(long long T, long long L, long long n, int nibble, int bf16,
                int* Tp, int* Pp, int* Cp, long long* blocks) {
  if (T < 0 || L < 1 || n < 1 || T % L != 0 || T + 2 * n >= INT32_MAX)
    return false;
  const long long C = (T + n - 1) / n;
  const long long ceven = nibble ? C + (C & 1) : C;
  const long long span =
      bf16 ? span_of<__nv_bfloat16, G>() : span_of<float, G>();
  *Tp = static_cast<int>(T);
  *Pp = static_cast<int>(T / L > 0 ? T / L : 1);
  *Cp = static_cast<int>(C);
  *blocks = T == 0 ? 0 : n * ((ceven + span - 1) / span);
  return true;
}

uintptr_t addr(long long p) { return static_cast<uintptr_t>(p); }

float mantissa_max(int bits) { return static_cast<float>((1 << (bits - 1)) - 1); }

}  // namespace

// x, r: [L, P] float32; amax, s: [L] float32; q: [L, P] int8; all contiguous.
extern "C" int wire_quantize_rows_launch(const float* x, const float* amax,
                                         int8_t* q, float* s, float* r,
                                         long long L, long long P, int bits,
                                         void* stream) {
  if (L < 1 || P < 1 || bits < 2 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<<<grid_for(L, P), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, amax, q, s, r, L, P, mantissa_max(bits));
  return static_cast<int>(cudaGetLastError());
}

// x, s, r: n float32; q: n int8; all contiguous.
extern "C" int wire_quantize_sflat_launch(const float* x, const float* s,
                                          int8_t* q, float* r, long long n,
                                          int bits, void* stream) {
  if (n < 1 || bits < 2 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_for(1, n);
  quantize_sflat_kernel<<<grid.x, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, s, q, r, n, mantissa_max(bits));
  return static_cast<int>(cudaGetLastError());
}

// q: [R, C] int8; out: [R, (C + 1) / 2] int8; both contiguous, at any byte
// offset.  Even C: the flat 16-byte path; odd C: the per-row kernel.
extern "C" int wire_pack_rows_launch(const int8_t* q, int8_t* out, long long R,
                                     long long C, void* stream) {
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 2 == 0)
    launch_pack_flat(q, out, R * (C / 2), st);
  else
    pack_rows_kernel<<<grid_for(R, (C + 1) / 2), THREADS, 0, st>>>(q, out, R,
                                                                   C);
  return static_cast<int>(cudaGetLastError());
}

// q: [R, C] int8; s: [R, C] (s_stride = C) or [C] (s_stride = 0) float32;
// out: [R, C] float32; all contiguous.  mul = 2^shift.
extern "C" int wire_dequant_rows_launch(const int8_t* q, const float* s,
                                        float* out, long long R, long long C,
                                        long long s_stride, float mul, int n,
                                        void* stream) {
  if (R < 1 || C < 1 || n < 1 || (s_stride != 0 && s_stride != C))
    return static_cast<int>(cudaErrorInvalidValue);
  dequant_rows_kernel<<<grid_for(R, C), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, s, out, R, C, s_stride, mul, static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}

// One launch over `count` (1..64) members of a bucket: desc holds, for each,
// x, step, res (device pointers: T values of float32 (bf16 = 0) or bfloat16,
// [L] float32 steps, [T] float32 residual), T, L, the member's first column
// off, bf16.  q: [n, W] int8.  All contiguous.
extern "C" int wire_quantize_bucket_launch(const long long* desc, int count,
                                           int8_t* q, long long n, long long W,
                                           int bits, int nibble, void* stream) {
  if (count < 1 || count > BUCKET_MAX_MEMBERS || bits < 2 || bits > 8 ||
      n < 1 || W < 0 || n >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  QuantTable t = {};
  t.q = q;
  t.W = W;
  t.n = static_cast<int>(n);
  t.count = count;
  t.nibble = nibble;
  t.qmax = mantissa_max(bits);
  long long total = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 7 * i;
    QuantMember& m = t.m[i];
    const int bf16 = static_cast<int>(d[6]);
    long long blocks;
    if (!plan_shape<QUANT_GROUPS>(d[3], d[4], n, nibble, bf16, &m.T, &m.P,
                                  &m.C, &blocks) ||
        d[5] < 0 || d[5] + (nibble ? m.C + (m.C & 1) : m.C) > W ||
        d[5] >= INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    const int esz = bf16 ? 2 : 4, V = 16 / esz;
    m.x = reinterpret_cast<const void*>(d[0]);
    m.step = reinterpret_cast<const float*>(d[1]);
    m.res = reinterpret_cast<float*>(d[2]);
    m.off = static_cast<int>(d[5]);
    m.bf16 = static_cast<unsigned char>(bf16);
    // the group grid from where x lies; the residual must lie on it
    const int a = static_cast<int>((addr(d[0]) / esz) % V);
    m.a = static_cast<unsigned char>(a);
    m.vec = addr(d[0]) % esz == 0 && addr(d[2]) % 4 == 0 &&
            (addr(d[2]) / 4 + 4 - a % 4) % 4 == 0;
    m.block0 = static_cast<int>(total);
    total += blocks;
    if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  quantize_bucket_kernel<<<static_cast<unsigned>(total), BUCKET_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// One launch over `count` (1..64) members: desc holds, for each, dlv, res_in,
// res_out, step (device pointers: [T] delivered in the leaf's dtype, [T]
// float32 residual, [T] new residual in the leaf's dtype, which may be res_in
// itself for a float32 leaf, [L] float32 steps), T, L, off, bf16.  q: the
// gathered payload, [n, W] int8 or with nibble [n, W / 2] pairs; err: [W]
// float32, rank idx's remainder; mul = 2^shift.  All contiguous.
extern "C" int wire_dequant_bucket_launch(const long long* desc, int count,
                                          const int8_t* q, const float* err,
                                          long long n, long long W, int idx,
                                          float mul, int nibble, void* stream) {
  if (count < 1 || count > BUCKET_MAX_MEMBERS || n < 1 || W < 0 ||
      n >= INT32_MAX || idx < 0 || idx >= n || (nibble && W % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  DequantTable t = {};
  t.q = reinterpret_cast<const uint8_t*>(q);
  t.err = err;
  t.W = W;
  t.n = static_cast<int>(n);
  t.idx = idx;
  t.count = count;
  t.nibble = nibble;
  t.mul = mul;
  t.nf = static_cast<float>(n);
  long long total = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 8 * i;
    DequantMember& m = t.m[i];
    const int bf16 = static_cast<int>(d[7]);
    long long blocks;
    if (!plan_shape<DEQUANT_GROUPS>(d[4], d[5], n, nibble, bf16, &m.T, &m.P,
                                    &m.C, &blocks) ||
        d[6] < 0 || d[6] + (nibble ? m.C + (m.C & 1) : m.C) > W ||
        d[6] >= INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    const int esz = bf16 ? 2 : 4, V = 16 / esz;
    m.dlv = reinterpret_cast<void*>(d[0]);
    m.res_in = reinterpret_cast<const float*>(d[1]);
    m.res_out = reinterpret_cast<void*>(d[2]);
    m.step = reinterpret_cast<const float*>(d[3]);
    m.off = static_cast<int>(d[6]);
    m.bf16 = static_cast<unsigned char>(bf16);
    // the group grid from where the delivered output lies; the residuals
    // must lie on it
    const int a = static_cast<int>((addr(d[0]) / esz) % V);
    m.a = static_cast<unsigned char>(a);
    m.vec = addr(d[0]) % esz == 0 && addr(d[2]) % esz == 0 &&
            addr(d[1]) % 4 == 0 && (addr(d[2]) / esz + V - a) % V == 0 &&
            (addr(d[1]) / 4 + 4 - a % 4) % 4 == 0;
    m.block0 = static_cast<int>(total);
    total += blocks;
    if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  dequant_bucket_kernel<<<static_cast<unsigned>(total), BUCKET_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
