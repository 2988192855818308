// HGQ quantizer (Eq. 4) forward, and its Algorithm-1 backward in f.
//
// hgq_quantize_fwd replaces src/repro/kernels/hgq_quantize/kernel.py:59
// (`hgq_quantize_2d`, bodies _kernel_per_tensor :42, _kernel_per_channel :47,
// _kernel_per_param :52).  hgq_quantize_bwd replaces the custom_vjp backward of
// that kernel, src/repro/kernels/hgq_quantize/ops.py:164 (`_bwd`).
//
// Forward: out = floor(x * 2^fi + 1/2) / 2^fi with fi = floor(f + 1/2), in
// float32, written in x's dtype (float32 or bfloat16).  2^fi is built in the
// exponent field after the clamp to -126..127, the products and sums are rounded
// one by one (__fmul_rn / __fadd_rn: no FMA contraction) and the division is
// IEEE, so the grid is bit-exact against the plain version.  One grid-stride
// elementwise kernel per layout: f is one value (per tensor), one value per
// column (per channel, x viewed as [rows, cols]) or one value per element (per
// parameter).  Any cols works: no lane alignment as the TPU kernel needed.
//
// Backward: dx = g needs no kernel.  df = sum of g * ln2 * (x - xq) over the
// axes f is broadcast along, with xq recomputed from x and f and rounded to x's
// dtype first, exactly as the JAX backward does.  Per parameter the product is
// written elementwise.  The two reductions are deterministic, with no atomics:
// per channel, block (tile of TILE_ROWS rows, 32 columns) sums its rows in a
// fixed order into a partial [tiles, cols], and a second pass adds each
// column's tiles, 8 strided lanes then a fixed sum of the lanes; per tensor,
// block (tile of TILE_ELEMS elements) reduces its tile by a fixed tree into a
// partial [tiles], and one block adds the tiles by the same tree.  One tile
// writes df directly and skips the second pass.  Tiles are short (4 rows, 8
// elements a thread) so that the dependent float adds of a thread stay few.
//
// Bound: bytes.  Forward reads x and f and writes out; backward reads g, x and f
// and writes df (a few flops per element either way).  On the training slice's
// shapes (a few thousand elements) every launch is latency-bound.
// Later work: 16-byte vector loads, and fusing the quantizer into its neighbours.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LN2F = 0.6931471805599453f;
constexpr int EW_THREADS = 256;       // elementwise kernels
constexpr int EW_MAX_BLOCKS = 132 * 8;
constexpr int COL_TILE = 32;          // per channel: columns of a block
constexpr int ROW_LANES = 8;          // per channel: rows a block walks at once
constexpr int TILE_ROWS = 32;         // per channel: rows of one partial sum
constexpr int SUM_THREADS = 256;      // per tensor
constexpr int TILE_ELEMS = 2048;      // per tensor: elements of one partial sum

enum Layout { PER_TENSOR = 0, PER_CHANNEL = 1, PER_PARAM = 2 };

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

// one element's share of df: (g * ln2) * (x - xq), xq in x's storage type
template <typename T>
__device__ __forceinline__ float df_term(const T* g, const T* x, float f,
                                         long long i) {
  const float xv = load(x, i);
  const float delta = __fsub_rn(xv, as_stored(quant(xv, f), x));
  return __fmul_rn(__fmul_rn(load(g, i), LN2F), delta);
}

template <int L>
__device__ __forceinline__ float f_at(const float* f, long long i, int cols) {
  if (L == PER_TENSOR) return f[0];
  if (L == PER_CHANNEL) return f[i % cols];
  return f[i];
}

template <typename T, int L>
__global__ void fwd_kernel(const T* __restrict__ x, const float* __restrict__ f,
                           T* __restrict__ out, long long n, int cols) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    store(out, i, quant(load(x, i), f_at<L>(f, i, cols)));
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

// grid (row tiles, column blocks), block (COL_TILE, ROW_LANES)
template <typename T>
__global__ void bwd_channel_kernel(const T* __restrict__ g,
                                   const T* __restrict__ x,
                                   const float* __restrict__ f,
                                   float* __restrict__ part, long long rows,
                                   int cols) {
  __shared__ float sh[ROW_LANES][COL_TILE];
  const int c = blockIdx.y * COL_TILE + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * TILE_ROWS;
  const long long r1 = r0 + TILE_ROWS < rows ? r0 + TILE_ROWS : rows;
  float acc = 0.f;
  if (c < cols) {
    const float fv = f[c];
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += ROW_LANES)
      acc = __fadd_rn(acc, df_term(g, x, fv, r * cols + c));
  }
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float s = sh[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < ROW_LANES; ++k) s = __fadd_rn(s, sh[k][threadIdx.x]);
    part[static_cast<long long>(blockIdx.x) * cols + c] = s;
  }
}

// grid (column blocks), block (COL_TILE, ROW_LANES): lane y adds tiles
// y, y + ROW_LANES, ... of its column, then lane 0 adds the lanes in order
__global__ void sum_tiles_kernel(const float* __restrict__ part,
                                 float* __restrict__ df, int tiles, int cols) {
  __shared__ float sh[ROW_LANES][COL_TILE];
  const int c = blockIdx.x * COL_TILE + threadIdx.x;
  float acc = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += ROW_LANES)
      acc = __fadd_rn(acc, part[static_cast<long long>(t) * cols + c]);
  }
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float s = sh[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < ROW_LANES; ++k) s = __fadd_rn(s, sh[k][threadIdx.x]);
    df[c] = s;
  }
}

// fixed-tree sum of one value per thread of a SUM_THREADS block; thread 0 holds it
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float sh[SUM_THREADS];
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = __fadd_rn(sh[threadIdx.x],
                                                     sh[threadIdx.x + s]);
    __syncthreads();
  }
  return sh[0];
}

template <typename T>
__global__ void bwd_tensor_kernel(const T* __restrict__ g,
                                  const T* __restrict__ x,
                                  const float* __restrict__ f,
                                  float* __restrict__ part, long long n) {
  const float fv = f[0];
  const long long e0 = static_cast<long long>(blockIdx.x) * TILE_ELEMS;
  const long long e1 = e0 + TILE_ELEMS < n ? e0 + TILE_ELEMS : n;
  float acc = 0.f;
#pragma unroll 4
  for (long long i = e0 + threadIdx.x; i < e1; i += SUM_THREADS)
    acc = __fadd_rn(acc, df_term(g, x, fv, i));
  const float s = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int n) {
  float acc = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += SUM_THREADS)
    acc = __fadd_rn(acc, part[i]);
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[0] = s;
}

int ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return static_cast<int>(b < EW_MAX_BLOCKS ? b : EW_MAX_BLOCKS);
}

long long channel_tiles(long long rows) {
  return (rows + TILE_ROWS - 1) / TILE_ROWS;
}

long long tensor_tiles(long long n) { return (n + TILE_ELEMS - 1) / TILE_ELEMS; }

template <typename T>
void fwd(const void* x, const float* f, void* out, long long n, int cols,
         int layout, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int nb = ew_blocks(n);
  if (layout == PER_TENSOR)
    fwd_kernel<T, PER_TENSOR><<<nb, EW_THREADS, 0, st>>>(xt, f, ot, n, cols);
  else if (layout == PER_CHANNEL)
    fwd_kernel<T, PER_CHANNEL><<<nb, EW_THREADS, 0, st>>>(xt, f, ot, n, cols);
  else
    fwd_kernel<T, PER_PARAM><<<nb, EW_THREADS, 0, st>>>(xt, f, ot, n, cols);
}

template <typename T>
void bwd(const void* g, const void* x, const float* f, float* df,
         float* scratch, long long rows, int cols, int layout,
         cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  const long long n = rows * cols;
  if (layout == PER_PARAM) {
    bwd_param_kernel<T><<<ew_blocks(n), EW_THREADS, 0, st>>>(gt, xt, f, df, n);
  } else if (layout == PER_CHANNEL) {
    const long long tiles = channel_tiles(rows);
    float* dst = tiles == 1 ? df : scratch;
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>((cols + COL_TILE - 1) / COL_TILE));
    bwd_channel_kernel<T><<<grid, dim3(COL_TILE, ROW_LANES), 0, st>>>(
        gt, xt, f, dst, rows, cols);
    if (tiles > 1)
      sum_tiles_kernel<<<(cols + COL_TILE - 1) / COL_TILE,
                         dim3(COL_TILE, ROW_LANES), 0, st>>>(
          scratch, df, static_cast<int>(tiles), cols);
  } else {
    const long long tiles = tensor_tiles(n);
    float* dst = tiles == 1 ? df : scratch;
    bwd_tensor_kernel<T><<<static_cast<unsigned>(tiles), SUM_THREADS, 0, st>>>(
        gt, xt, f, dst, n);
    if (tiles > 1)
      sum_partials_kernel<<<1, SUM_THREADS, 0, st>>>(scratch, df,
                                                     static_cast<int>(tiles));
  }
}

bool valid(long long rows, int cols, int layout) {
  return rows > 0 && cols > 0 && layout >= PER_TENSOR && layout <= PER_PARAM &&
         channel_tiles(rows) < (1ll << 31) &&
         tensor_tiles(rows * cols) < (1ll << 31) &&
         (cols + COL_TILE - 1) / COL_TILE <= 65535;
}

}  // namespace

// floats of scratch the backward needs for [rows, cols] at this layout (0: none)
extern "C" long long hgq_quantize_bwd_scratch(long long rows, int cols,
                                              int layout) {
  if (layout == PER_CHANNEL) {
    const long long t = channel_tiles(rows);
    return t > 1 ? t * cols : 0;
  }
  if (layout == PER_TENSOR) {
    const long long t = tensor_tiles(rows * cols);
    return t > 1 ? t : 0;
  }
  return 0;
}

// x, out: [rows, cols] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// f: float32, 1 value, [cols] or [rows, cols] by layout.
extern "C" int hgq_quantize_fwd_launch(const void* x, const float* f, void* out,
                                       long long rows, int cols, int layout,
                                       int bf16, void* stream) {
  if (!valid(rows, cols, layout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    fwd<__nv_bfloat16>(x, f, out, rows * cols, cols, layout, st);
  else
    fwd<float>(x, f, out, rows * cols, cols, layout, st);
  return static_cast<int>(cudaGetLastError());
}

// g, x: [rows, cols] contiguous in x's dtype; df: float32 in f's layout;
// scratch: hgq_quantize_bwd_scratch(rows, cols, layout) floats (or null if 0).
extern "C" int hgq_quantize_bwd_launch(const void* g, const void* x,
                                       const float* f, float* df,
                                       float* scratch, long long rows, int cols,
                                       int layout, int bf16, void* stream) {
  if (!valid(rows, cols, layout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    bwd<__nv_bfloat16>(g, x, f, df, scratch, rows, cols, layout, st);
  else
    bwd<float>(g, x, f, df, scratch, rows, cols, layout, st);
  return static_cast<int>(cudaGetLastError());
}
