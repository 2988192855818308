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
// Later work: fusing the pack into the quantize.
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
