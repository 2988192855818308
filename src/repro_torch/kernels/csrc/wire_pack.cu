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
// Later work: 16-byte vector loads and stores; fusing the pack into the quantize.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 8;
constexpr long long MAX_GRID_Y = 65535;

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

// q: [R, C] int8; out: [R, (C + 1) / 2] int8; both contiguous.
extern "C" int wire_pack_rows_launch(const int8_t* q, int8_t* out, long long R,
                                     long long C, void* stream) {
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  pack_rows_kernel<<<grid_for(R, (C + 1) / 2), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(q, out, R, C);
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
