// Packed-weight dequant matmul for decode: y[M, N] = (x[M, K] @ w[K, N]) * scale[N]
// with int8 mantissas w and a per-output-channel power-of-two scale.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul/kernel.py:40
// (`qmatmul`, body `_qmatmul_kernel` :25).
//
// Bound on the H100: bytes.  At decode M is at most 16 (8 slots x 1 token, or
// one prefill chunk), so every weight byte feeds at most 16 multiply-adds and the
// kernel must stream the int8 weights at the memory rate: 494 MB per qwen2-0.5b
// decode tick, about 0.15 ms at 3.35 TB/s.
//
// Design.  Weights are read once, coalesced, as int8, and converted in registers;
// fp32 accumulators stay in registers; the scale multiplies once at the end (exact:
// a power of two).  w is stored [N, K], each output channel's mantissas
// contiguous: the serving packer stores every layer so, and the tied lm head reads
// the [vocab, d] embedding mantissas through their transpose without a copy.  For
// the layers, blocks of CPW columns split K across their warps, so even N = 128
// puts many loads in flight; for the head (N >= NK_WIDE_N) each warp owns its
// columns over the whole of K.
// Each output's summation order depends only on K, never on M, so a row gives the
// same result in a decode tick and in a prefill chunk.
// Later work: nibble unpacking in the kernel, split-K, and wgmma for larger M.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NK_WARPS = 4;  // warps of a block
constexpr int NK_WIDE_N = 16384;  // from this N on, each [N, K] warp owns its columns

// [N, K] layout.  The block's NK_WARPS warps form NK_WARPS / KSPLIT groups; a
// group owns CPW columns and the MT rows of an M tile, and its KSPLIT warps split
// K into 128-deep segments (segment s goes to warp s % KSPLIT of the group), two
// segments in flight per warp.  KSPLIT = NK_WARPS suits small N, where splitting
// K is the only way to put many loads in flight; KSPLIT = 1 suits large N (the
// tied head), where the grid fills the card anyway and a warp that owns its
// columns over the whole of K pays the reduction once per 896 deep, not 224.  A
// lane reads 4 consecutive mantissas of each column (a warp reads 128 contiguous
// bytes per column) and the matching x float4 of each row through the read-only
// cache, so each x value feeds CPW columns from registers.  Lane sums, a fixed
// shuffle tree and the group's warps in order give each output a summation order
// set by K and KSPLIT, never by M.
template <int MT, int CPW, int KSPLIT>
__global__ void __launch_bounds__(NK_WARPS * 32)
qmatmul_nk_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int M, int K, int N, int vec) {
  constexpr int GROUPS = NK_WARPS / KSPLIT;
  __shared__ float red[NK_WARPS][CPW * MT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks = warp % KSPLIT;
  const int n0 = (blockIdx.x * GROUPS + warp / KSPLIT) * CPW;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  const int ncols = min(CPW, N - n0);  // <= 0 for a group past the last column
  const int nseg = (K + 127) / 128;

  float acc[CPW][MT];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;

  for (int s0 = ks; s0 < nseg; s0 += 2 * KSPLIT) {
    // start the weight loads of both segments before any arithmetic
    float wf[2][CPW][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = (s0 + u * KSPLIT) * 128 + lane * 4;
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int8_t* wr = w + static_cast<size_t>(n0 + c) * K + k;
        if (vec && c < ncols && k + 3 < K) {
          const char4 b = __ldg(reinterpret_cast<const char4*>(wr));
          wf[u][c][0] = b.x; wf[u][c][1] = b.y; wf[u][c][2] = b.z; wf[u][c][3] = b.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wf[u][c][j] = (c < ncols && k + j < K) ? static_cast<float>(wr[j]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = (s0 + u * KSPLIT) * 128 + lane * 4;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xv[4];
        const float* xr = x + static_cast<size_t>(m0 + m) * K + k;
        if (vec && m < mrows && k + 3 < K) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xr));
          xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = (m < mrows && k + j < K) ? xr[j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < CPW; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][m] = fmaf(xv[j], wf[u][c][j], acc[c][m]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[c][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == ((c * MT + m) & 31)) red[warp][c * MT + m] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < GROUPS * CPW * MT; i += blockDim.x) {
    const int g = i / (CPW * MT), j = i - g * (CPW * MT);
    const int c = j / MT, m = j - c * MT;
    const int n = (blockIdx.x * GROUPS + g) * CPW + c;
    if (n < N && m < mrows) {
      float v = red[g * KSPLIT][j];
#pragma unroll
      for (int wv = 1; wv < KSPLIT; ++wv) v += red[g * KSPLIT + wv][j];
      y[static_cast<size_t>(m0 + m) * N + n] = v * scale[n];
    }
  }
}

// One launch: the K split is chosen from N alone (so a row's result never depends
// on M); the head's 151936 columns take KSPLIT = 1.
template <int MT, int CPW>
void launch_nk(const float* x, const int8_t* w, const float* scale, float* y, int M,
               int K, int N, int vec, cudaStream_t s) {
  if (N >= NK_WIDE_N) {
    dim3 grid((N + NK_WARPS * CPW - 1) / (NK_WARPS * CPW), (M + MT - 1) / MT);
    qmatmul_nk_kernel<MT, CPW, 1><<<grid, NK_WARPS * 32, 0, s>>>(x, w, scale, y, M, K, N, vec);
  } else {
    dim3 grid((N + CPW - 1) / CPW, (M + MT - 1) / MT);
    qmatmul_nk_kernel<MT, CPW, NK_WARPS><<<grid, NK_WARPS * 32, 0, s>>>(x, w, scale, y, M, K,
                                                                    N, vec);
  }
}

}  // namespace

// x [M, K] fp32 contiguous; w int8 stored [N, K] contiguous; scale [N] fp32;
// y [M, N] fp32 contiguous.  vec = 1 when the vector loads are aligned: 4-byte
// weight loads (K % 4 == 0, a 4-aligned base) and 16-byte x loads (a 16-aligned
// x).  Returns cudaGetLastError() after the launch.
extern "C" int qmatmul_launch(const float* x, const int8_t* w, const float* scale,
                              float* y, int M, int K, int N, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (M <= 8) {
    launch_nk<8, 8>(x, w, scale, y, M, K, N, vec, s);
  } else {
    launch_nk<16, 4>(x, w, scale, y, M, K, N, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
