// Packed-weight dequant matmul for decode: y[M, N] = (x[M, K] @ w[K, N]) * scale[N]
// with int8 (or nibble-packed int4) mantissas w and a per-output-channel
// power-of-two scale.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul/kernel.py:40
// (`qmatmul`, body `_qmatmul_kernel` :25).
//
// Bound on the H100: bytes.  At decode M is at most 16 (8 slots x 1 token, or
// one prefill chunk), so every weight byte feeds at most 16 multiply-adds and the
// kernel must stream the weights at the memory rate: about 494 MB per qwen2-0.5b
// decode tick in int8 (0.15 ms at 3.35 TB/s), 337 MB with the MLP in nibbles.
// fp32 multiply-adds on the CUDA cores cannot keep up with that stream (16 flops
// a weight byte at M = 8 is 54 TFLOP/s, 80% of their 67), so the products run on
// the tensor cores.
//
// Design.
// * mma.sync m16n8k16 bf16 -> fp32, "swapped": sixteen output channels form the
//   A tile, read row-major from the N-major [N, K] storage (each channel's
//   mantissas contiguous, as the serving packer stores every layer and as the
//   tied head's table.T lies); the activation rows form B's n = 8 columns.  M = 8
//   fills one B tile, M = 16 two.
// * Exact products.  x is split into three bf16 terms hi + mid + lo (RN each, the
//   residuals exact), which equals x for every normal fp32 whose lowest term stays
//   normal (fp32 has 24 significand bits, bf16 8); every int8 and int4 mantissa is
//   exact in bf16; so each product is exact and only the fp32 accumulation
//   rounds.  Each term has its own accumulator; they are added lo + mid, then hi,
//   at the end.  The plain version of the split is
//   src/repro_torch/kernels/qmatmul/ref.py `bf16_split3`.
// * Short tensor-core chains.  The mma's own fp32 accumulation does not round to
//   nearest, and its error grows with the number of mma steps it chains: over a
//   whole unsplit K (a wide head: K 2560 at N 256000, 160 steps) it came past
//   chip_smoke.py's REL_ERR_LIMIT of (|x| @ |w|) * scale.  So each chunk's mma
//   steps (4 for int8, 8 for nibbles) of the hi term accumulate from zero, and
//   the chunk's sums are added into its running sums with round-to-nearest fp32
//   adds, in k order.  The mid and lo terms, 2^-8 and 2^-16 of hi, chain in the
//   tensor cores: their error is that much smaller.
// * Mantissas are widened in registers without I2F.  A nibble is xor-biased to
//   0..15, placed under the exponent of 128.0 (lop3) and the bias 136 taken off in
//   bf16x2: two conversions an instruction.  A byte needs 8 bits under the leading
//   one, which bf16 (7) lacks: it goes under the exponent of 2^23 in fp32 (prmt),
//   the bias comes off in fp32 and one cvt.rn.bf16x2.f32 packs two exact values.
// * Memory parallelism.  A lane moves 16 bytes of each of its four channel rows
//   per stage with cp.async into a 4-stage ring of its own in shared memory (it
//   reads only what it copied, so no block barrier), three stages in flight:
//   24 KB a block.  Blocks of 128 channels (4 warps x 2 tiles of 16); where N
//   alone leaves the SMs idle, K is split across blocks (the parts chosen by the
//   caller from K and N alone) into a workspace that a second kernel sums in part
//   order.  No float atomics.
// * Nibbles are read in the kernel from the packed storage as the serving packer
//   keeps it: N-major [N, K / 2] bytes, the even k in the low nibble.
// Each output's summation order is set by K, N and the split, never by M, so a
// row gives the same bits at M = 1, 8 and 16.
// Later work: wgmma / TMA tiles for prefill shapes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;               // warps of a block
constexpr int TILES = 2;               // 16-channel MMA tiles of a warp
constexpr int BLOCK_N = WARPS * TILES * 16;
constexpr int ROWS = 2 * TILES;        // channel rows a lane loads (g, g + 8 per tile)
constexpr int STAGES = 4;              // ring depth, STAGES - 1 stages in flight
constexpr int CHUNK = 64;              // bytes of a row per stage (4 lanes x 16)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> three bf16x2 terms, hi + mid + lo == (a, b) exactly for normal values
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = __fsub_rn(a, __low2float(h)), rb = __fsub_rn(b, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float sa = __fsub_rn(ra, __low2float(m)), sb = __fsub_rn(rb, __high2float(m));
  hi = bits_of(h);
  mid = bits_of(m);
  lo = bits_of(__floats2bfloat162_rn(sa, sb));
}

// bytes i and i + 1 of an xor-biased word -> bf16x2 of the signed mantissas
__device__ __forceinline__ uint32_t int8_pair(uint32_t u, int i) {
  const float f0 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float f1 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + i)) - 8388736.f;
  return bits_of(__floats2bfloat162_rn(f0, f1));
}

// nibbles c and c + 4 of an xor-biased word -> bf16x2 of the signed mantissas
__device__ __forceinline__ uint32_t nibble_pair(uint32_t u, int c) {
  const uint32_t v = ((u >> (4 * c)) & 0x000F000Fu) | 0x43004300u;  // 128 + nibble
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return bits_of(r);
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x[m][k .. k + 3], zero outside [0, M) x [0, K)
__device__ __forceinline__ float4 load_x4(const float* __restrict__ x, int m, int k, int M,
                                          int K, int xvec) {
  if (m >= M) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = x + static_cast<size_t>(m) * K + k;
  if (xvec && k + 3 < K) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = k + j < K ? __ldg(p + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// MT activation rows (8 or 16) x BLOCK_N channels x one part of K.  A chunk is
// CHUNK bytes of every channel row: lane (g, t) = (lane / 4, lane % 4) owns bytes
// [16 t, 16 t + 16) of rows g, g + 8, g + 16, g + 24 of its warp's 32 channels.
// Those 16 bytes hold 16 int8 (or 32 nibble) k values, which feed 4 (or 8) MMA
// k-steps; the k of each A slot is fixed by t, the same for every row and for
// the matching B slot, so each k-step multiplies matching k.  int8: k-step j uses
// word j, k = 4j + {0, 1 | 2, 3}; nibbles: word j / 2, k = c + {0, 4 | 1, 5} with
// c = 2 (j % 2) (the low and high halves of each bf16x2).
template <int MT, bool NIB>
__global__ void __launch_bounds__(WARPS * 32)
qmatmul_mma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ y,
                   float* __restrict__ ws, int M, int K, int N, int rowbytes,
                   int chunks_per_part, int wvec, int xvec) {
  constexpr int KPC = NIB ? 2 * CHUNK : CHUNK;  // k values of a chunk
  __shared__ uint4 ring[STAGES][ROWS][WARPS * 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nw = blockIdx.x * BLOCK_N + warp * 32;
  const int m0 = blockIdx.y * MT;
  const int part = blockIdx.z;
  const int nchunks = (rowbytes + CHUNK - 1) / CHUNK;
  const int c_begin = part * chunks_per_part;
  const int c_end = min(nchunks, c_begin + chunks_per_part);

  const uint8_t* rowp[ROWS];
  bool live[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int n = nw + 8 * q + g;
    live[q] = n < N;
    rowp[q] = w + static_cast<size_t>(live[q] ? n : 0) * rowbytes;
  }

  auto issue = [&](int c, int slot) {
    const int off = c * CHUNK + 16 * t;
    const int nb = max(0, min(16, rowbytes - off));
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int bytes = live[q] ? nb : 0;
      if (wvec) {
        cp_async16(&ring[slot][q][tid], bytes ? rowp[q] + off : w, bytes);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < bytes; ++j)
          v[j >> 2] |= static_cast<uint32_t>(rowp[q][off + j]) << (8 * (j & 3));
        ring[slot][q][tid] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  float acc[TILES][MT / 8][3][4];  // running sums over the part's chunks
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int j = 0; j < MT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 3; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][e][r] = 0.f;

  int c_issue = c_begin;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s, ++c_issue) {
    if (c_issue < c_end) issue(c_issue, s);
    cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c, ++c_issue) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    const int slot = (c - c_begin) % STAGES;
    uint32_t u[ROWS][4];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const uint4 v = ring[slot][q][tid];
      const uint32_t bias = NIB ? 0x88888888u : 0x80808080u;
      u[q][0] = v.x ^ bias; u[q][1] = v.y ^ bias; u[q][2] = v.z ^ bias; u[q][3] = v.w ^ bias;
    }
    // refill the slot that chunk c - 1 left
    if (c_issue < c_end) issue(c_issue, (c_issue - c_begin) % STAGES);
    cp_async_commit();

    const int kb = c * KPC + (NIB ? 32 : 16) * t;  // first k of this lane's bytes
    float cacc[TILES][MT / 8][4];  // this chunk's sums of the hi term, from zero
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int mt = 0; mt < MT / 8; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) cacc[i][mt][r] = 0.f;
#pragma unroll
    for (int j = 0; j < (NIB ? 8 : 4); ++j) {
      // B: the three terms of x at this k-step's k, per 8-row tile of the M tile
      uint32_t bx[MT / 8][3][2];
#pragma unroll
      for (int mt = 0; mt < MT / 8; ++mt) {
        const int m = m0 + 8 * mt + g;
        float p0, p1, q0, q1;  // (b0 pair, b1 pair)
        if (NIB) {
          const int kw = kb + 8 * (j >> 1);
          const float4 lo4 = load_x4(x, m, kw, M, K, xvec);
          const float4 hi4 = load_x4(x, m, kw + 4, M, K, xvec);
          if (j & 1) { p0 = lo4.z; p1 = hi4.z; q0 = lo4.w; q1 = hi4.w; }
          else       { p0 = lo4.x; p1 = hi4.x; q0 = lo4.y; q1 = hi4.y; }
        } else {
          const float4 v = load_x4(x, m, kb + 4 * j, M, K, xvec);
          p0 = v.x; p1 = v.y; q0 = v.z; q1 = v.w;
        }
        split3(p0, p1, bx[mt][0][0], bx[mt][1][0], bx[mt][2][0]);
        split3(q0, q1, bx[mt][0][1], bx[mt][1][1], bx[mt][2][1]);
      }
#pragma unroll
      for (int i = 0; i < TILES; ++i) {
        uint32_t a[4];  // rows g | g + 8 of tile i, k slots {2t, 2t+1} | {2t+8, 2t+9}
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t* uq = u[2 * i + h];
          if (NIB) {
            const int c0 = 2 * (j & 1);
            a[h] = nibble_pair(uq[j >> 1], c0);
            a[h + 2] = nibble_pair(uq[j >> 1], c0 + 1);
          } else {
            a[h] = int8_pair(uq[j], 0);
            a[h + 2] = int8_pair(uq[j], 2);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT / 8; ++mt) {
          mma(cacc[i][mt], a[0], a[1], a[2], a[3], bx[mt][0][0], bx[mt][0][1]);
#pragma unroll
          for (int e = 1; e < 3; ++e)
            mma(acc[i][mt][e], a[0], a[1], a[2], a[3], bx[mt][e][0], bx[mt][e][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int mt = 0; mt < MT / 8; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][mt][0][r] = __fadd_rn(acc[i][mt][0][r], cacc[i][mt][r]);
  }
  cp_async_wait<0>();

  // D fragment: d0, d1 -> channel g, rows 2t, 2t + 1; d2, d3 -> channel g + 8
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int mt = 0; mt < MT / 8; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = nw + 16 * i + g + 8 * (r >> 1);
        const int m = m0 + 8 * mt + 2 * t + (r & 1);
        if (n >= N || m >= M) continue;
        const float v =
            acc[i][mt][0][r] + __fadd_rn(acc[i][mt][2][r], acc[i][mt][1][r]);
        if (ws)
          ws[(static_cast<size_t>(part) * M + m) * N + n] = v;
        else
          y[static_cast<size_t>(m) * N + n] = v * scale[n];
      }
}

// The second pass of the split: y[m][n] = (sum over parts, in part order, of
// ws[p][m][n]) * scale[n].
__global__ void qmatmul_reduce_kernel(const float* __restrict__ ws,
                                      const float* __restrict__ scale, float* __restrict__ y,
                                      int M, int N, int parts) {
  const long long MN = static_cast<long long>(M) * N;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < MN;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = ws[i];
    for (int p = 1; p < parts; ++p) v = __fadd_rn(v, ws[p * MN + i]);
    y[i] = v * scale[i % N];
  }
}

template <int MT>
void launch_mt(const float* x, const uint8_t* w, const float* scale, float* y, float* ws,
               int M, int K, int N, int nib, int rowbytes, int parts, int cpp, int wvec,
               int xvec, cudaStream_t s) {
  dim3 grid((N + BLOCK_N - 1) / BLOCK_N, (M + MT - 1) / MT, parts);
  if (nib)
    qmatmul_mma_kernel<MT, true><<<grid, WARPS * 32, 0, s>>>(x, w, scale, y, ws, M, K, N,
                                                             rowbytes, cpp, wvec, xvec);
  else
    qmatmul_mma_kernel<MT, false><<<grid, WARPS * 32, 0, s>>>(x, w, scale, y, ws, M, K, N,
                                                              rowbytes, cpp, wvec, xvec);
}

}  // namespace

// x [M, K] fp32 contiguous; w N-major: [N, K] int8 (nib = 0) or [N, K / 2] bytes
// of two int4 mantissas, the even k in the low nibble (nib = 1, K even), each
// channel's row contiguous; scale [N] fp32; y [M, N] fp32 contiguous.  K is cut
// into `parts` ranges of `k_per_part` k (a multiple of 128, chosen by the caller
// from K and N); for parts > 1, ws is a [parts, M, N] fp32 workspace and a second
// kernel sums it.  Returns cudaGetLastError() after the launches.
extern "C" int qmatmul_launch(const float* x, const void* w, const float* scale, float* y,
                              float* ws, int M, int K, int N, int nib, int parts,
                              int k_per_part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || parts < 1 || k_per_part < 1 || k_per_part % 128 ||
      (nib && K % 2) || (parts > 1 && !ws))
    return cudaErrorInvalidValue;
  const int rowbytes = nib ? K / 2 : K;
  const int cpp = k_per_part / (nib ? 2 * CHUNK : CHUNK);  // chunks of a part
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const int wvec = rowbytes % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float* out_ws = parts > 1 ? ws : nullptr;
  if (M <= 8)
    launch_mt<8>(x, wb, scale, y, out_ws, M, K, N, nib, rowbytes, parts, cpp, wvec, xvec, s);
  else
    launch_mt<16>(x, wb, scale, y, out_ws, M, K, N, nib, rowbytes, parts, cpp, wvec, xvec, s);
  if (parts > 1) {
    const long long MN = static_cast<long long>(M) * N;
    const int blocks = static_cast<int>(std::min<long long>((MN + 255) / 256, 132LL * 8));
    qmatmul_reduce_kernel<<<blocks, 256, 0, s>>>(ws, scale, y, M, N, parts);
  }
  return static_cast<int>(cudaGetLastError());
}
