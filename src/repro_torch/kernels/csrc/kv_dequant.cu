// Quantized KV cache kernels for the serving decode path.
//
// kv_quantize_rows replaces src/repro/kernels/kv_dequant/kernel.py:104
// (`kv_quantize_rows`, body `_kv_quantize_kernel` :58).
// kv_attention_rows replaces src/repro/kernels/kv_dequant/kernel.py:154
// (`kv_attention_rows`, body `_kv_attention_kernel` :72).
//
// kv_quantize_rows.  Per row of hd values: amax -> the capped grid exponent f
// (largest f with amax * 2^f inside +-qmax, one lower where rounding would still
// saturate) -> q = clip(rint(x * 2^f), +-qmax).  One warp per row: a shuffle
// amax, then each lane rounds its columns.  Bound: bytes (each row is read twice
// from L1, written once as int8); at decode it moves a few KB and the launch
// dominates, so k and v rows share one launch.  Rounding is rintf (half to even,
// the semantics of jnp.round); 2^f is built in the exponent field after the clamp
// to -126..127 and floor(log2) is read from the exponent bits, so the grid is
// bit-exact against the reference.
//
// kv_attention_rows.  The fused decode read: scores of the query rows against the
// int8 (or nibble) key mantissas with 2^-kf * scale folded in per slot, the mask
// built from qpos / tpos / window, exp(s - max), probabilities on the 2^-pf grid,
// 2^-vf folded into the probabilities, times the value mantissas, divided by the
// probability sum.  Bound: bytes -- the whole ring of the layer is read every
// tick (W x KV x (hd or hd/2) bytes per batch row for K and for V).  The cache is
// read in its native [B, W, KV, hdm] layout through strides: no transpose, no
// padding, no dequantized copy in device memory.  One block per (kv head, batch
// row, tile of RT query rows): RT = 8 covers a decode tick's S * G = 7 rows of a
// qwen2 kv head, RT = 16 a prefill chunk.  The probability grid needs the true row max
// before any probability is rounded, so the block makes two passes over W: pass 1
// finds the max of the scaled scores, pass 2 recomputes each score, rounds the
// probability and accumulates the sum and p * 2^-vf * v.  An online softmax would
// round against a moving max, a different function.  Each pass stages 256 slots
// at a time in shared memory with 16-byte loads where the cache is aligned
// (nibbles sign-extended there with arithmetic shifts).
// Later work: split the ring across blocks (flash-decoding) to fill the 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ATT_NT = 256;    // threads per block = ring slots per chunk
constexpr int ATT_WARPS = ATT_NT / 32;
constexpr int ATT_HDMAX = 128;

__device__ __forceinline__ float exact_exp2(float fi) {
  fi = fminf(fmaxf(fi, -126.f), 127.f);
  return __int_as_float((static_cast<int>(fi) + 127) << 23);
}

__device__ __forceinline__ float floor_log2_pos(float v) {
  return static_cast<float>(((__float_as_int(v) >> 23) & 0xFF) - 127);
}

__device__ __forceinline__ float grid_exponent(float amax, float qmax) {
  const float fcap = floor_log2_pos(qmax / fmaxf(amax, 1e-12f));
  return floorf(amax * exact_exp2(fcap) + 0.5f) > qmax ? fcap - 1.f : fcap;
}

__global__ void kv_quantize_kernel(const float* __restrict__ x,
                                   int8_t* __restrict__ q, int8_t* __restrict__ f,
                                   int R, int hd, float qmax) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // whole warps leave together
  const float* xr = x + static_cast<size_t>(row) * hd;
  float amax = 0.f;
  for (int i = lane; i < hd; i += 32) amax = fmaxf(amax, fabsf(xr[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float fe = grid_exponent(amax, qmax);
  const float sc = exact_exp2(fe);
  int8_t* qr = q + static_cast<size_t>(row) * hd;
  for (int i = lane; i < hd; i += 32) {
    const float v = fminf(fmaxf(rintf(xr[i] * sc), -qmax), qmax);
    qr[i] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (lane == 0) f[row] = static_cast<int8_t>(static_cast<int>(fe));
}

__device__ __forceinline__ uint32_t nibble_pair_bytes(uint32_t b2) {
  // two stored bytes -> four sign-extended mantissas, even column in the low nibble
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int b = static_cast<int8_t>((b2 >> (8 * e)) & 0xFFu);
    const int lo = static_cast<int8_t>(static_cast<uint8_t>((b & 0x0F) << 4)) >> 4;
    const int hi = b >> 4;
    out |= (static_cast<uint32_t>(static_cast<uint8_t>(lo)) << (16 * e)) |
           (static_cast<uint32_t>(static_cast<uint8_t>(hi)) << (16 * e + 8));
  }
  return out;
}

// Copy tn ring rows starting at slot t0 into dst [tn][ldk] as int8 mantissas,
// sign-extending nibble pairs (even column in the low nibble).  vec: rows and
// their stride are 16-byte aligned and hdm % 16 == 0, so each thread moves 16
// stored bytes at a time (ldk % 4 == 0 keeps the shared-memory words aligned).
__device__ __forceinline__ void stage_rows(int8_t* dst, int ldk, const int8_t* src,
                                           long long st, int t0, int tn, int hdm,
                                           int packed, int vec) {
  if (vec) {
    const int pieces = hdm / 16;
    for (int i = threadIdx.x; i < tn * pieces; i += blockDim.x) {
      const int t = i / pieces, j = i - t * pieces;
      const uint4 v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(t0 + t) * st + 16 * j);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t* row = reinterpret_cast<uint32_t*>(dst + t * ldk);
      if (packed) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          row[8 * j + 2 * e] = nibble_pair_bytes(words[e] & 0xFFFFu);
          row[8 * j + 2 * e + 1] = nibble_pair_bytes(words[e] >> 16);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) row[4 * j + e] = words[e];
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < tn * hdm; i += blockDim.x) {
    const int t = i / hdm, j = i - t * hdm;
    const int v = src[static_cast<long long>(t0 + t) * st + j];
    if (packed) {
      // low nibble: move it to the top of a byte, then shift back arithmetically
      const int lo = static_cast<int8_t>(static_cast<uint8_t>((v & 0x0F) << 4)) >> 4;
      dst[t * ldk + 2 * j] = static_cast<int8_t>(lo);
      dst[t * ldk + 2 * j + 1] = static_cast<int8_t>(v >> 4);
    } else {
      dst[t * ldk + j] = static_cast<int8_t>(v);
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(ATT_NT)
kv_attention_kernel(const float* __restrict__ qh,
                    const int8_t* __restrict__ km, const int8_t* __restrict__ vm,
                    long long m_sb, long long m_st, long long m_skv,
                    const int8_t* __restrict__ kf, const int8_t* __restrict__ vf,
                    long long f_sb, long long f_st, long long f_skv,
                    const int* __restrict__ qpos,
                    const int* __restrict__ tpos, long long tp_sb, long long tp_st,
                    const float* __restrict__ pf, float* __restrict__ out,
                    int S, int H, int KV, int W, int hd, int packed, int vec,
                    int window, float scale) {
  constexpr int OPT = RT * ATT_HDMAX / ATT_NT;  // outputs per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / KV, SG = S * G;
  const int r0 = blockIdx.z * RT;
  const int rows = min(RT, SG - r0);
  const int hdm = packed ? hd / 2 : hd;
  const int ldk = hd + 4;  // padded staging row: conflict-free per-slot reads

  float* qs = reinterpret_cast<float*>(smem);       // [RT][hd]
  float* P = qs + RT * hd;                          // [RT][NT]
  float* ks = P + RT * ATT_NT;                      // [NT] 2^-kf * scale
  float* vs = ks + ATT_NT;                          // [NT] 2^-vf
  float* red = vs + ATT_NT;                         // [WARPS][RT]
  float* rowm = red + ATT_WARPS * RT;               // [RT]
  int* qp = reinterpret_cast<int*>(rowm + RT);      // [RT]
  int8_t* Ks = reinterpret_cast<int8_t*>(qp + RT);  // [NT][ldk]
  int8_t* Vs = Ks + ATT_NT * ldk;                   // [NT][ldk]

  const int8_t* kbase = km + b * m_sb + kvh * m_skv;
  const int8_t* vbase = vm + b * m_sb + kvh * m_skv;
  const int8_t* kfb = kf + b * f_sb + kvh * f_skv;
  const int8_t* vfb = vf + b * f_sb + kvh * f_skv;
  const int* tpb = tpos + b * tp_sb;

  // query rows of this tile (row r = s * G + g reads head kvh * G + g)
  for (int i = tid; i < RT * hd; i += ATT_NT) {
    const int r = i / hd, d = i - r * hd;
    float v = 0.f;
    if (r < rows) {
      const int rg = r0 + r, s = rg / G, h = kvh * G + rg % G;
      v = qh[(static_cast<size_t>(b * S + s) * H + h) * hd + d];
    }
    qs[i] = v;
  }
  if (tid < RT) qp[tid] = tid < rows ? qpos[b * S + (r0 + tid) / G] : 0;
  const float pfs = pf ? exact_exp2(floorf(*pf + 0.5f)) : 1.f;

  // ---- pass 1: row max of the scaled, masked scores ----
  float mx[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) mx[r] = NEG_INF;
  for (int t0 = 0; t0 < W; t0 += ATT_NT) {
    const int tn = min(ATT_NT, W - t0);
    __syncthreads();
    stage_rows(Ks, ldk, kbase, m_st, t0, tn, hdm, packed, vec);
    if (tid < tn) ks[tid] = exact_exp2(-static_cast<float>(kfb[(t0 + tid) * f_st])) * scale;
    __syncthreads();
    if (tid < tn) {
      const int tp = tpb[(t0 + tid) * tp_st];
      float dot[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) dot[r] = 0.f;
      const int8_t* kr = Ks + tid * ldk;
      for (int d = 0; d < hd; ++d) {
        const float kv = static_cast<float>(kr[d]);
#pragma unroll
        for (int r = 0; r < RT; ++r) dot[r] = fmaf(qs[r * hd + d], kv, dot[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const bool vis = r < rows && tp >= 0 && tp <= qp[r] &&
                         (window < 0 || qp[r] - tp < window);
        if (vis) mx[r] = fmaxf(mx[r], __fmul_rn(dot[r], ks[tid]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float v = mx[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[warp * RT + r] = v;
  }
  __syncthreads();
  if (tid < RT) {
    float m = NEG_INF;
    for (int w = 0; w < ATT_WARPS; ++w) m = fmaxf(m, red[w * RT + tid]);
    rowm[tid] = m;
  }

  // ---- pass 2: probabilities on the grid, their sum, and p * 2^-vf @ v ----
  float acc[OPT], lsum[OPT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) { acc[k] = 0.f; lsum[k] = 0.f; }
  for (int t0 = 0; t0 < W; t0 += ATT_NT) {
    const int tn = min(ATT_NT, W - t0);
    __syncthreads();
    stage_rows(Ks, ldk, kbase, m_st, t0, tn, hdm, packed, vec);
    stage_rows(Vs, ldk, vbase, m_st, t0, tn, hdm, packed, vec);
    if (tid < tn) {
      ks[tid] = exact_exp2(-static_cast<float>(kfb[(t0 + tid) * f_st])) * scale;
      vs[tid] = exact_exp2(-static_cast<float>(vfb[(t0 + tid) * f_st]));
    }
    __syncthreads();
    if (tid < tn) {
      const int tp = tpb[(t0 + tid) * tp_st];
      float dot[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) dot[r] = 0.f;
      const int8_t* kr = Ks + tid * ldk;
      for (int d = 0; d < hd; ++d) {
        const float kv = static_cast<float>(kr[d]);
#pragma unroll
        for (int r = 0; r < RT; ++r) dot[r] = fmaf(qs[r * hd + d], kv, dot[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const bool vis = r < rows && tp >= 0 && tp <= qp[r] &&
                         (window < 0 || qp[r] - tp < window);
        float p = 0.f;
        if (vis) {
          // __fmul_rn: the same rounded score as pass 1, never fused into the
          // subtraction, so the row's max gives exp(0) = 1 exactly
          p = expf(__fmul_rn(dot[r], ks[tid]) - rowm[r]);
          if (pf) p = floorf(p * pfs + 0.5f) / pfs;
        }
        P[r * ATT_NT + tid] = p;
      }
    } else {
#pragma unroll
      for (int r = 0; r < RT; ++r) P[r * ATT_NT + tid] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < OPT; ++k) {
      const int idx = tid + k * ATT_NT;
      if (idx < rows * hd) {
        const int r = idx / hd, d = idx - r * hd;
        float a = acc[k], l = lsum[k];
        for (int tc = 0; tc < tn; ++tc) {
          const float p = P[r * ATT_NT + tc];
          a = fmaf(p * vs[tc], static_cast<float>(Vs[tc * ldk + d]), a);
          l += p;
        }
        acc[k] = a;
        lsum[k] = l;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int idx = tid + k * ATT_NT;
    if (idx < rows * hd) {
      const int r = idx / hd, d = idx - r * hd;
      const int rg = r0 + r, s = rg / G, h = kvh * G + rg % G;
      out[(static_cast<size_t>(b * S + s) * H + h) * hd + d] =
          acc[k] / fmaxf(lsum[k], 1e-20f);
    }
  }
}

size_t attention_smem_bytes(int hd, int rt) {
  return sizeof(float) * (rt * hd + rt * ATT_NT + 2 * ATT_NT + ATT_WARPS * rt + rt) +
         sizeof(int) * rt + 2 * static_cast<size_t>(ATT_NT) * (hd + 4);
}

template <int RT>
int launch_attention(const float* qh, const int8_t* km, const int8_t* vm, long long m_sb,
                     long long m_st, long long m_skv, const int8_t* kf,
                     const int8_t* vf, long long f_sb, long long f_st, long long f_skv,
                     const int* qpos, const int* tpos, long long tp_sb,
                     long long tp_st, const float* pf, float* out, int B, int S,
                     int H, int KV, int W, int hd, int packed, int vec, int window,
                     float scale, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(hd, RT);
  cudaError_t e = cudaFuncSetAttribute(kv_attention_kernel<RT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int SG = S * (H / KV);
  dim3 grid(KV, B, (SG + RT - 1) / RT);
  kv_attention_kernel<RT><<<grid, ATT_NT, smem, stream>>>(
      qh, km, vm, m_sb, m_st, m_skv, kf, vf, f_sb, f_st, f_skv, qpos, tpos, tp_sb,
      tp_st, pf, out, S, H, KV, W, hd, packed, vec, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [R, hd] fp32 contiguous -> q [R, hd] int8, f [R] int8.
extern "C" int kv_quantize_launch(const float* x, int8_t* q, int8_t* f, int R,
                                  int hd, int bits, void* stream) {
  if (R <= 0 || hd <= 0 || bits < 2 || bits > 8) return cudaErrorInvalidValue;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  constexpr int kWarps = 8;
  const int blocks = (R + kWarps - 1) / kWarps;
  kv_quantize_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, f, R, hd, qmax);
  return static_cast<int>(cudaGetLastError());
}

// qh [B, S, H, hd] fp32 contiguous; km / vm int8 mantissas [B, W, KV, hdm] read
// through (m_sb, m_st, m_skv) with the last axis contiguous (hdm = hd, or hd / 2
// when packed); vec = 1 when the mantissa rows and strides are 16-byte aligned and
// hdm % 16 == 0; kf / vf int8 exponents [B, W, KV] through (f_sb, f_st, f_skv);
// qpos [B, S] int32 contiguous; tpos [B, W] int32 through (tp_sb, tp_st), negative
// = empty slot; pf: device pointer to the fp32 probs exponent, or null for no
// probs grid; window < 0 for none.  out [B, S, H, hd] fp32 contiguous.
extern "C" int kv_attention_launch(const float* qh, const int8_t* km, const int8_t* vm,
                                   long long m_sb, long long m_st, long long m_skv,
                                   const int8_t* kf, const int8_t* vf,
                                   long long f_sb, long long f_st, long long f_skv,
                                   const int* qpos, const int* tpos,
                                   long long tp_sb, long long tp_st, const float* pf,
                                   float* out, int B, int S, int H, int KV, int W,
                                   int hd, int packed, int vec, int window, float scale,
                                   void* stream) {
  if (hd <= 0 || hd > ATT_HDMAX || hd % 2 || KV <= 0 || H % KV || W <= 0 || B <= 0 ||
      S <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S * (H / KV) <= 8)
    return launch_attention<8>(qh, km, vm, m_sb, m_st, m_skv, kf, vf, f_sb, f_st, f_skv,
                               qpos, tpos, tp_sb, tp_st, pf, out, B, S, H, KV, W, hd,
                               packed, vec, window, scale, st);
  return launch_attention<16>(qh, km, vm, m_sb, m_st, m_skv, kf, vf, f_sb, f_st, f_skv,
                              qpos, tpos, tp_sb, tp_st, pf, out, B, S, H, KV, W, hd,
                              packed, vec, window, scale, st);
}
