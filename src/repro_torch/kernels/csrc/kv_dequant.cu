// Quantized KV cache kernels for the serving decode path.
//
// kv_quantize_rows and kv_quantize_store replace
// src/repro/kernels/kv_dequant/kernel.py:104 (`kv_quantize_rows`, body
// `_kv_quantize_kernel` :58), the store with the ring write of
// src/repro/nn/attention.py:196-203 fused in.
// kv_dequant_rows replaces src/repro/kernels/kv_dequant/kernel.py:132
// (`kv_dequant_rows`, body `_kv_dequant_kernel`).
// kv_attention_rows replaces src/repro/kernels/kv_dequant/kernel.py:154
// (`kv_attention_rows`, body `_kv_attention_kernel` :72).
//
// kv_quantize_rows and kv_quantize_store.  Per row of hd values: amax -> the
// capped grid exponent f (largest f with amax * 2^f inside +-qmax, one lower where
// rounding would still saturate) -> q = clip(rint(x * 2^f), +-qmax).  Rounding is
// rintf (half to even, the semantics of jnp.round); 2^f is built in the exponent
// field after the clamp to -126..127 and floor(log2) is read from the exponent
// bits, so the grid is bit-exact against the reference.  One kernel serves both
// entry points: the serving store (kv_store_launch) reads the new k and v rows
// of a layer as they lie ([B, S, KV, hd] float32 or bfloat16 views, through
// strides), and writes the int8 mantissas -- or nibble pairs, the even column in
// the low nibble, when the ring holds hd / 2 bytes a row -- and the int8
// exponents straight into the four ring buffers at slot[b, s], dropping slots
// outside the ring (the reference's .at[b, slot].set(mode="drop")); rows to a
// contiguous destination (kv_quantize_launch) are the case S = KV = W = 1.  The
// stack, the cast copy, the nibble pack and the four scatter writes that
// surrounded the kernel are gone, and with them the boolean mask (and its host
// sync) of a chunk longer than the ring.  One warp per row: a shuffle amax, then
// each lane rounds adjacent columns, 16 bytes of the row at a time where the row
// is 16-byte aligned and hd a whole number of vectors (else two columns at a
// time), and writes its mantissas or nibble pairs with one store where the
// destination is aligned for it (else byte by byte).  A lane issues its row loads
// before it reads the row's slot, so the two latencies overlap, and keeps the
// values in registers for the second pass (hd up to 256 float32 values).  Bound:
// bytes (each row read once, written once as int8); at decode it moves a few KB
// and the launch dominates, so k and v rows share one launch.
//
// kv_dequant_rows.  fp32 q * 2^-f per row, 2^-f built in the exponent field, so
// the product is exact and bit-equal to the reference (__fmul_rn, no fast math).
// Bound: bytes, 5 R hd + R (int8 in, fp32 out): 5.26 MB, 1.57 us at R = 16384,
// hd 64 (one qwen2 layer's K ring).  Where hd % 16 == 0 and the rows are
// 16-byte aligned the kernel walks 16-mantissa pieces a warp tile at a time:
// each lane issues up to KV_DEQUANT_VECS 16-byte loads before any store (that
// many loads in flight a thread, fewer where the grid would leave an SM
// without a block), neighbouring lanes on neighbouring pieces, and
// builds each piece's 2^-f from its row's exponent (row and column advance by
// addition, no division a piece); warp shuffles hand every lane the four
// mantissas of the output float4 it stores, so the stores are as contiguous as
// the loads (a thread storing its own pieces' 64 bytes each left every store
// instruction 64 or 256 bytes a lane apart, and ran at 14-36% of the bound at
// R = 393216).  Indices are 32-bit where R * hd < 2^31; stores are streaming
// (st.global.cs: written once, read by a later kernel); the grid is one wave,
// KV_DEQUANT_BLOCKS_PER_SM blocks an SM at most, each warp striding over the
// rest.  Other hd or unaligned rows take a grid-stride loop over single
// values: any hd, no padding.
//
// kv_attention_rows.  The fused decode read: scores of the query rows against the
// int8 (or nibble) key mantissas with 2^-kf * scale folded in per slot, the mask
// built from qpos / tpos / window, exp(s - max), probabilities on the 2^-pf grid,
// 2^-vf folded into the probabilities, times the value mantissas, divided by the
// probability sum.  Bound: bytes -- the whole ring of the layer is read every
// tick (W x KV x (hd or hd/2) bytes per batch row for K and for V).  The cache is
// read in its native [B, W, KV, hdm] layout through strides: no transpose, no
// padding, no dequantized copy in device memory.
// Design.  A thread block cluster of C blocks (C from W alone: min(8, W / 128
// rounded up), launched with cudaLaunchKernelEx) serves one (kv head, batch row,
// tile of RT query rows); RT = 8 covers a decode tick's S * G = 7 rows of a qwen2
// kv head, RT = 16 a prefill chunk.  At B = 8, KV = 2, W = 1024 that is 16
// clusters of 8 = 128 blocks.  Each block owns a contiguous range of ring slots:
// pass 1 stages its keys (16-byte loads, nibbles sign-extended with arithmetic
// shifts), two threads per slot compute the RT scaled scores and keep them in
// shared memory, so the ring is read once.  Where a block's share of the scores
// does not fit in shared memory (W / C above about 1400 slots at RT = 16, hd = 64),
// pass 1 keeps only the row maxima and pass 2 restages the keys and recomputes the
// scores ATT_SLOTS slots at a time, by the same instructions, so the result has
// the same bits either way and any W is served.  The probability grid needs the true
// row max before any probability is rounded: the blocks' partial maxima are
// exchanged through distributed shared memory (cluster.map_shared_rank), and a max
// is exact in any order, so every probability is rounded against the same max as
// in the plain version.  (An online softmax would round against a moving max, a
// different function.)  Pass 2 turns the stored scores into probabilities, and the
// block's four warps each take a quarter of its slots for p * 2^-vf @ v, lanes
// across the head dim; the warps' partials are summed in warp order.  The cluster
// then sums the blocks' partials and probability sums through distributed shared
// memory in rank order (each block combines every C-th output), divides, and
// writes each output once.  No atomics; every sum's order is set by W and hd, never
// by B or S, so a request's rows are bit-identical in a batch of 8 and alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <algorithm>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ATT_NT = 256;     // threads per block
constexpr int ATT_WARPS = ATT_NT / 32;
constexpr int ATT_SLOTS = 128;  // ring slots staged at a time: two threads a slot
constexpr int ATT_HDMAX = 128;
constexpr size_t SMEM_MAX = 232448;      // a block's shared memory on the H100

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

// One side (k or v) of the store: the rows to read and the ring to write.
struct StoreSide {
  const void* src;           // rows [B, S, KV, hd], the last axis contiguous
  long long s_b, s_s, s_kv;  // their strides, in elements
  int8_t* m;                 // mantissas [B, W, KV, hdm], the last contiguous
  long long m_b, m_w, m_kv;  // strides in bytes
  int8_t* e;                 // exponents [B, W, KV]
  long long e_b, e_w, e_kv;
};

struct StoreArgs {
  StoreSide side[2];
  const long long* slot;  // [B, S] ring slots, or null: slot s
  int B, S, KV, hd, W, nibble;
  float qmax;
};

constexpr int STORE_WARPS = 8;  // rows a block

__device__ __forceinline__ float row_value(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float row_value(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// 16 bytes of a row as float32 values: four float32, or eight bfloat16 widened
__device__ __forceinline__ void widen16(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ int mantissa(float x, float sc, float qmax) {
  return static_cast<int>(fminf(fmaxf(rintf(x * sc), -qmax), qmax));
}

// n (2, 4 or 8) bytes, byte i in bits 8i.. of w, to p: one store where p is
// aligned for it, else byte by byte
__device__ __forceinline__ void put_bytes(int8_t* p, unsigned long long w, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (a % n == 0) {
    if (n == 8) *reinterpret_cast<unsigned long long*>(p) = w;
    else if (n == 4) *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(w);
    else *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w);
  } else {
    for (int i = 0; i < n; ++i) p[i] = static_cast<int8_t>((w >> (8 * i)) & 0xFFu);
  }
}

// a nibble pair: the even column in the low nibble (pack_nibbles)
__device__ __forceinline__ unsigned nibble_pair(int lo, int hi) {
  return (static_cast<unsigned>(lo) & 0xFu) | ((static_cast<unsigned>(hi) & 0xFu) << 4);
}

// 16-byte chunks of a row a lane keeps in registers from the first pass to the
// second (hd up to 32 x STORE_CHUNKS x V values; chunks beyond are read again)
constexpr int STORE_CHUNKS = 2;

// One row: its loads are issued before the slot is read (the slot's load and
// the row's overlap), then a dropped row leaves, the warp's amax, the grid,
// the mantissas (or nibble pairs) and the exponent into the ring.
template <typename T>
__device__ __forceinline__ void store_row(const StoreArgs& a, const StoreSide& sd,
                                          int b, int s, int kv, int lane) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int hd = a.hd;
  const T* row = static_cast<const T*>(sd.src) + b * sd.s_b + s * sd.s_s + kv * sd.s_kv;
  const bool vec = hd % V == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0;
  const int nch = vec ? hd / V : 0;
  float held[STORE_CHUNKS][V];
#pragma unroll
  for (int k = 0; k < STORE_CHUNKS; ++k)
    if (lane + 32 * k < nch) widen16(row + (lane + 32 * k) * V, held[k]);
  const long long slot = a.slot ? a.slot[static_cast<long long>(b) * a.S + s] : s;
  if (slot < 0 || slot >= a.W) return;  // dropped, as the reference drops it
  float amax = 0.f;
  if (vec) {
#pragma unroll
    for (int k = 0; k < STORE_CHUNKS; ++k)
      if (lane + 32 * k < nch) {
#pragma unroll
        for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(held[k][j]));
      }
    for (int c = lane + 32 * STORE_CHUNKS; c < nch; c += 32) {
      float v[V];
      widen16(row + c * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
  } else {
    for (int i = lane; i < hd; i += 32) amax = fmaxf(amax, fabsf(row_value(row, i)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float fe = grid_exponent(amax, a.qmax);
  const float sc = exact_exp2(fe);
  int8_t* mrow = sd.m + b * sd.m_b + slot * sd.m_w + kv * sd.m_kv;
  // the mantissas, or nibble pairs, of chunk c of the row
  auto emit = [&](int c, const float* v) {
    unsigned long long w = 0;
    if (a.nibble) {
#pragma unroll
      for (int j = 0; j < V; j += 2)
        w |= static_cast<unsigned long long>(nibble_pair(
                 mantissa(v[j], sc, a.qmax), mantissa(v[j + 1], sc, a.qmax)))
             << (4 * j);
      put_bytes(mrow + c * (V / 2), w, V / 2);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        w |= static_cast<unsigned long long>(
                 static_cast<uint8_t>(mantissa(v[j], sc, a.qmax)))
             << (8 * j);
      put_bytes(mrow + c * V, w, V);
    }
  };
  if (vec) {
#pragma unroll
    for (int k = 0; k < STORE_CHUNKS; ++k)
      if (lane + 32 * k < nch) emit(lane + 32 * k, held[k]);
    for (int c = lane + 32 * STORE_CHUNKS; c < nch; c += 32) {
      float v[V];
      widen16(row + c * V, v);
      emit(c, v);
    }
  } else {
    // two adjacent columns a lane (the last pair of an odd row has one)
    for (int p = lane; 2 * p < hd; p += 32) {
      const int q0 = mantissa(row_value(row, 2 * p), sc, a.qmax);
      const int q1 = 2 * p + 1 < hd ? mantissa(row_value(row, 2 * p + 1), sc, a.qmax) : 0;
      if (a.nibble) {
        mrow[p] = static_cast<int8_t>(nibble_pair(q0, q1));
      } else {
        mrow[2 * p] = static_cast<int8_t>(q0);
        if (2 * p + 1 < hd) mrow[2 * p + 1] = static_cast<int8_t>(q1);
      }
    }
  }
  if (lane == 0)
    sd.e[b * sd.e_b + slot * sd.e_w + kv * sd.e_kv] = static_cast<int8_t>(static_cast<int>(fe));
}

// grid (row groups of STORE_WARPS, sides); warp w of block x serves row
// x * STORE_WARPS + w of the B x S x KV rows of side blockIdx.y
template <typename T>
__global__ void __launch_bounds__(STORE_WARPS * 32)
kv_store_kernel(const __grid_constant__ StoreArgs a) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * STORE_WARPS + (threadIdx.x >> 5);
  if (r >= a.B * a.S * a.KV) return;  // whole warps leave together
  const int kv = r % a.KV, bs = r / a.KV;
  store_row<T>(a, a.side[blockIdx.y], bs / a.S, bs % a.S, kv, lane);
}

int launch_store(const StoreArgs& a, int sides, int bf16, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.B) * a.S * a.KV;
  if (rows <= 0 || rows > (1LL << 30) || a.hd <= 0 || a.W <= 0 || a.KV <= 0 ||
      (a.nibble && a.hd % 2) || sides < 1 || sides > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((rows + STORE_WARPS - 1) / STORE_WARPS), sides);
  if (bf16)
    kv_store_kernel<__nv_bfloat16><<<grid, STORE_WARPS * 32, 0, st>>>(a);
  else
    kv_store_kernel<float><<<grid, STORE_WARPS * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// One 16-byte piece of a staged row: 16 int8 mantissas, or 16 bytes of nibble
// pairs sign-extended to 32 mantissas (even column in the low nibble).
__device__ __forceinline__ void store_piece(int8_t* dst, int ldk, int t, int j, uint4 v,
                                            int packed) {
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

// Copy tn (<= blockDim.x) ring rows starting at slot t0 of the keys, and of the
// values when vsrc is not null, into kdst / vdst [tn][ldk] as int8 mantissas,
// sign-extending nibble pairs.  vec: rows and their stride are 16-byte aligned and
// hdm % 16 == 0, so each thread moves 16 stored bytes at a time (ldk % 4 == 0
// keeps the shared-memory words aligned).  Every thread issues all its loads
// before its first shared-memory store: the block waits for one memory latency,
// not one per piece.
__device__ __forceinline__ void stage_rows(int8_t* kdst, int8_t* vdst, int ldk,
                                           const int8_t* __restrict__ ksrc,
                                           const int8_t* __restrict__ vsrc, long long st,
                                           int t0, int tn, int hdm, int packed, int vec) {
  if (vec) {
    constexpr int PMAX = ATT_HDMAX / 16;  // pieces of a thread at most
    const int pieces = hdm / 16, n = tn * pieces;
    uint4 kv[PMAX], vv[PMAX];
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n) {
        const int t = i / pieces, j = i - t * pieces;
        const long long off = static_cast<long long>(t0 + t) * st + 16 * j;
        kv[k] = __ldg(reinterpret_cast<const uint4*>(ksrc + off));
        if (vsrc) vv[k] = __ldg(reinterpret_cast<const uint4*>(vsrc + off));
      }
    }
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n) {
        const int t = i / pieces, j = i - t * pieces;
        store_piece(kdst, ldk, t, j, kv[k], packed);
        if (vsrc) store_piece(vdst, ldk, t, j, vv[k], packed);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < tn * hdm; i += blockDim.x) {
    const int t = i / hdm, j = i - t * hdm;
    const long long off = static_cast<long long>(t0 + t) * st + j;
    for (int u = 0; u < (vsrc ? 2 : 1); ++u) {
      const int v = (u ? vsrc : ksrc)[off];
      int8_t* dst = u ? vdst : kdst;
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
}

// The most 16-byte pieces a lane loads before it stores (the launch halves it
// while the grid would leave an SM without a block), threads a block, and the
// grid's blocks an SM at most (torch_kernel_sweep.py --part dequant)
#ifndef KV_DEQUANT_VECS
#define KV_DEQUANT_VECS 8
#endif
#ifndef KV_DEQUANT_THREADS
#define KV_DEQUANT_THREADS 256
#endif
#ifndef KV_DEQUANT_BLOCKS_PER_SM
#define KV_DEQUANT_BLOCKS_PER_SM 8
#endif
constexpr int DQ_SMS = 132;
constexpr int DQ_VECS = KV_DEQUANT_VECS;
constexpr int DQ_THREADS = KV_DEQUANT_THREADS;
constexpr int DQ_WARPS = DQ_THREADS / 32;
constexpr int DQ_MAX_BLOCKS = DQ_SMS * KV_DEQUANT_BLOCKS_PER_SM;
static_assert(DQ_THREADS % 32 == 0 && DQ_THREADS <= 1024, "whole warps");
static_assert(DQ_VECS == 1 || DQ_VECS == 2 || DQ_VECS == 4 || DQ_VECS == 8,
              "1, 2, 4 or 8 pieces a lane");

__device__ __forceinline__ float dequant_scale(int8_t f) {
  return exact_exp2(-static_cast<float>(f));
}

__device__ __forceinline__ float mantissa(uint32_t w, int b) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xFFu));
}

// Rows of hd = 16 * per mantissas, 16-byte aligned; Index is 32-bit where the
// launcher found R * hd < 2^31.  A warp takes a tile of 32 * V consecutive
// pieces: lane l loads pieces l, l + 32, ... (each load instruction of the
// warp reads 512 contiguous bytes), all before any store, and the 2^-f of
// each piece's row (the row and column advance by addition, one division a
// tile).  Output float4 k * 32 + l of the tile -- four mantissas of piece
// 8k + l / 4 -- comes to lane l by shuffles from the lane that loaded it, so
// every store instruction of the warp writes 512 contiguous bytes.
template <typename Index, int V>
__global__ void __launch_bounds__(DQ_THREADS)
    kv_dequant_vec_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ f,
                          float* __restrict__ out, Index R, int per) {
  const Index n = R * static_cast<Index>(per);  // pieces
  const Index tiles = (n + 32 * V - 1) / (32 * V);
  const int lane = threadIdx.x & 31;
  const uint4* qv = reinterpret_cast<const uint4*>(q);
  float4* ov = reinterpret_cast<float4*>(out);
  // a lane's next piece is 32 on: that many rows and columns further
  const int row_step = 32 / per, col_step = 32 % per;
  const Index stride = static_cast<Index>(gridDim.x) * DQ_WARPS;
  for (Index t = static_cast<Index>(blockIdx.x) * DQ_WARPS + (threadIdx.x >> 5); t < tiles;
       t += stride) {
    const Index p0 = t * (32 * V);
    uint4 v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const Index p = p0 + 32 * j + lane;
      v[j] = p < n ? __ldg(qv + p) : make_uint4(0u, 0u, 0u, 0u);
    }
    float s[V];
    Index row = (p0 + lane) / per;
    int col = static_cast<int>(p0 + lane - row * per);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] = p0 + 32 * j + lane < n ? dequant_scale(__ldg(f + row)) : 0.f;
      row += row_step;
      col += col_step;
      if (col >= per) {
        col -= per;
        ++row;
      }
    }
#pragma unroll
    for (int k = 0; k < 4 * V; ++k) {
      const int j = k / 4, src = 8 * (k % 4) + (lane >> 2);
      const uint32_t w0 = __shfl_sync(0xFFFFFFFFu, v[j].x, src);
      const uint32_t w1 = __shfl_sync(0xFFFFFFFFu, v[j].y, src);
      const uint32_t w2 = __shfl_sync(0xFFFFFFFFu, v[j].z, src);
      const uint32_t w3 = __shfl_sync(0xFFFFFFFFu, v[j].w, src);
      const float sc = __shfl_sync(0xFFFFFFFFu, s[j], src);
      const int e = lane & 3;
      const uint32_t w = e == 0 ? w0 : e == 1 ? w1 : e == 2 ? w2 : w3;
      const Index o = 4 * p0 + 32 * k + lane;  // float4 index
      if (o < 4 * n) {
        const float4 r = make_float4(__fmul_rn(mantissa(w, 0), sc),
                                     __fmul_rn(mantissa(w, 1), sc),
                                     __fmul_rn(mantissa(w, 2), sc),
                                     __fmul_rn(mantissa(w, 3), sc));
        __stcs(ov + o, r);
      }
    }
  }
}

// Any hd, any alignment: one value a step.
__global__ void kv_dequant_scalar_kernel(const int8_t* __restrict__ q,
                                         const int8_t* __restrict__ f,
                                         float* __restrict__ out, int R, int hd) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n = static_cast<long long>(R) * hd;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __fmul_rn(static_cast<float>(q[i]), dequant_scale(f[i / hd]));
}

// Nothing: the launch floor of a kernel of this grid on this card.
__global__ void empty_kernel() {}

// The 16-byte path's blocks for R * hd values at V pieces a lane: one a
// DQ_WARPS tiles, DQ_MAX_BLOCKS at most.
inline int dequant_blocks(long long values, int v) {
  const long long tiles = (values / 16 + 32 * v - 1) / (32 * v);
  return static_cast<int>(
      std::min<long long>((tiles + DQ_WARPS - 1) / DQ_WARPS, DQ_MAX_BLOCKS));
}

// Pieces a lane for R * hd values: DQ_VECS, halved while the grid would give
// some SM no block (a small ring wants blocks on every SM more than loads in
// flight: one layer's K ring runs at V = 1, all 24 layers' at V = 8).
inline int dequant_vecs(long long values) {
  int v = DQ_VECS;
  while (v > 1 && dequant_blocks(values, v) < DQ_SMS) v /= 2;
  return v;
}

__device__ __forceinline__ bool visible(int tp, int qp, int window) {
  return tp >= 0 && tp <= qp && (window < 0 || qp - tp < window);
}

// The region that holds P and PV for cap slots, and later the warps' partials.
__host__ __device__ inline size_t attention_union_words(int hd, int rt, int cap) {
  const size_t pp = 2 * static_cast<size_t>(rt) * cap;
  const size_t wp = static_cast<size_t>(ATT_WARPS) * rt * hd + ATT_WARPS * rt;
  return pp > wp ? pp : wp;
}

// Shared memory of one block, in 4-byte words then bytes (see the kernel).
__host__ __device__ inline size_t attention_smem_bytes(int hd, int rt, int cap) {
  return sizeof(float) * (2 * static_cast<size_t>(rt) * hd +
                          attention_union_words(hd, rt, cap) +
                          2 * static_cast<size_t>(cap) + ATT_WARPS * rt + 4 * rt) +
         2 * static_cast<size_t>(ATT_SLOTS) * (hd + 4);
}

// RT query rows a block; DPL head-dim columns a lane in p.v (hd <= 32 * DPL);
// RECOMPUTE: pass 2 recomputes the scores (a separate instance, so the common case
// carries none of its registers).  At most 128 registers a thread, so two blocks
// fit an SM and a cluster of 8 finds room in every GPC: all 16 clusters of a
// decode tick run in one wave.
template <int RT, int DPL, bool RECOMPUTE>
__global__ void __launch_bounds__(ATT_NT, 2)
kv_attention_kernel(const float* __restrict__ qh,
                    const int8_t* __restrict__ km, const int8_t* __restrict__ vm,
                    long long m_sb, long long m_st, long long m_skv,
                    const int8_t* __restrict__ kf, const int8_t* __restrict__ vf,
                    long long f_sb, long long f_st, long long f_skv,
                    const int* __restrict__ qpos,
                    const int* __restrict__ tpos, long long tp_sb, long long tp_st,
                    const float* __restrict__ pf, float* __restrict__ out,
                    int S, int H, int KV, int W, int hd, int packed, int vec,
                    int window, float scale, int ntiles, int chunk) {
  constexpr int CMAX = 8;       // the portable cluster size
  constexpr int RH = RT / 2;    // query rows a thread scores: two threads a slot
  constexpr int QPT = RT * ATT_HDMAX / ATT_NT;  // query values a thread loads at most
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int kvh = blockIdx.y, b = blockIdx.z / ntiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int js = tid % ATT_SLOTS, half = tid / ATT_SLOTS;  // pass 1: slot, row half
  const int G = H / KV, SG = S * G;
  const int r0 = (blockIdx.z - b * ntiles) * RT;
  const int rows = min(RT, SG - r0);
  const int hdm = packed ? hd / 2 : hd;
  const int ldk = hd + 4;  // padded staging row: conflict-free per-slot reads
  const int t_lo = rank * chunk;
  const int n_own = max(0, min(W - t_lo, chunk));  // this block's ring slots
  const int nsub = (n_own + ATT_SLOTS - 1) / ATT_SLOTS;
  // slots whose scores shared memory holds: all the block's, or one staging's
  const int cap = RECOMPUTE ? ATT_SLOTS : chunk;
  constexpr bool keep = !RECOMPUTE;

  // 16-byte aligned first: qs rows (hd % 4 == 0) and the slot-major P / PV rows
  float* qs = reinterpret_cast<float*>(smem);       // [RT][hd] query rows
  float* P = qs + RT * hd;                          // [cap][RT] scores, then probs
  float* PV = P + RT * cap;                         // [cap][RT] p * 2^-vf
  float* wpart = P;                                 // after p.v: [WARPS][RT][hd]
  float* wl = wpart + ATT_WARPS * RT * hd;          //   and [WARPS][RT] prob sums
  float* part = P + attention_union_words(hd, RT, cap);  // [RT][hd] block's p.v
  float* vss = part + RT * hd;                      // [cap] 2^-vf per slot
  int* tps = reinterpret_cast<int*>(vss + cap);     // [cap] tpos per slot
  float* lpart = reinterpret_cast<float*>(tps + cap);  // [RT] block's prob sum
  float* lmax = lpart + RT;                         // [RT] this block's row max
  float* rowm = lmax + RT;                          // [RT] the cluster's row max
  float* red = rowm + RT;                           // [WARPS][RT]
  int* qp = reinterpret_cast<int*>(red + ATT_WARPS * RT);  // [RT]
  int8_t* Ks = reinterpret_cast<int8_t*>(qp + RT);  // [SLOTS][ldk]
  int8_t* Vs = Ks + ATT_SLOTS * ldk;                // [SLOTS][ldk]

  const int8_t* kbase = km + b * m_sb + kvh * m_skv;
  const int8_t* vbase = vm + b * m_sb + kvh * m_skv;
  const int8_t* kfb = kf + b * f_sb + kvh * f_skv;
  const int8_t* vfb = vf + b * f_sb + kvh * f_skv;
  const int* tpb = tpos + b * tp_sb;

  // The query rows of this tile (row r = s * G + g reads head kvh * G + g), their
  // positions and the probs exponent: loaded now, stored once the first staging's
  // loads are in flight, so the block waits for one memory latency.
  float qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * ATT_NT, r = i / hd, d = i - r * hd;
    qv[k] = 0.f;
    if (i < RT * hd && r < rows) {
      const int rg = r0 + r, s = rg / G, h = kvh * G + rg % G;
      qv[k] = __ldg(qh + (static_cast<size_t>(b * S + s) * H + h) * hd + d);
    }
  }
  const int qpv = tid < rows ? qpos[b * S + (r0 + tid) / G] : 0;
  const float pfs = pf ? exact_exp2(floorf(*pf + 0.5f)) : 1.f;

  // ---- scores of the slots [s0, s0 + tn) of this block into P rows pb ..., their
  // tpos and 2^-vf into tps / vss; the values ride along when with_v.  Thread
  // (half, js) scores slot js against rows half * RH ...; with track, the scores
  // of visible slots raise the thread's row maxima mx.  Starts with the staging
  // and ends after the score stores, with no barrier after them.
  float mx[RH];
#pragma unroll
  for (int r = 0; r < RH; ++r) mx[r] = NEG_INF;
  auto score = [&](int s0, int tn, int pb, bool with_v, bool first, bool track) {
    int tp = -1;
    float ks = 0.f, vs = 0.f;
    if (js < tn) {  // the thread's slot: its position and grids
      const int t = t_lo + s0 + js;
      tp = tpb[t * tp_st];
      ks = exact_exp2(-static_cast<float>(kfb[t * f_st])) * scale;
      vs = exact_exp2(-static_cast<float>(vfb[t * f_st]));
    }
    stage_rows(Ks, Vs, ldk, kbase, with_v ? vbase : nullptr, m_st, t_lo + s0, tn, hdm,
               packed, vec);
    if (first) {
#pragma unroll
      for (int k = 0; k < QPT; ++k)
        if (tid + k * ATT_NT < RT * hd) qs[tid + k * ATT_NT] = qv[k];
      if (tid < RT) qp[tid] = qpv;
    }
    if (js < tn && half == 0) {
      tps[pb + js] = tp;
      vss[pb + js] = vs;
    }
    __syncthreads();
    if (js < tn) {
      float dot[RH];
#pragma unroll
      for (int r = 0; r < RH; ++r) dot[r] = 0.f;
      const int8_t* kr = Ks + js * ldk;
      const float* qh0 = qs + half * RH * hd;
      if ((hd & 3) == 0) {  // four mantissas and a float4 of each row at a time
        for (int d = 0; d < hd; d += 4) {
          const uint32_t kw = *reinterpret_cast<const uint32_t*>(kr + d);
          const float k0 = static_cast<float>(static_cast<int8_t>(kw & 0xFFu));
          const float k1 = static_cast<float>(static_cast<int8_t>((kw >> 8) & 0xFFu));
          const float k2 = static_cast<float>(static_cast<int8_t>((kw >> 16) & 0xFFu));
          const float k3 = static_cast<float>(static_cast<int8_t>(kw >> 24));
#pragma unroll
          for (int r = 0; r < RH; ++r) {
            const float4 q4 = *reinterpret_cast<const float4*>(qh0 + r * hd + d);
            dot[r] = fmaf(q4.x, k0, dot[r]);
            dot[r] = fmaf(q4.y, k1, dot[r]);
            dot[r] = fmaf(q4.z, k2, dot[r]);
            dot[r] = fmaf(q4.w, k3, dot[r]);
          }
        }
      } else {
        for (int d = 0; d < hd; ++d) {
          const float kv = static_cast<float>(kr[d]);
#pragma unroll
          for (int r = 0; r < RH; ++r) dot[r] = fmaf(qh0[r * hd + d], kv, dot[r]);
        }
      }
      const int i = pb + js;
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const int rr = half * RH + r;
        // __fmul_rn: never fused into the later subtraction, so the row's max
        // gives exp(0) = 1 exactly
        const float sc = __fmul_rn(dot[r], ks);
        P[i * RT + rr] = sc;
        if (track && rr < rows && visible(tp, qp[rr], window)) mx[r] = fmaxf(mx[r], sc);
      }
    }
  };

  // ---- pass 1: this block's row maxima, and its scores kept in P when they fit
  for (int s0 = 0; s0 < n_own; s0 += ATT_SLOTS) {
    if (s0) __syncthreads();
    score(s0, min(ATT_SLOTS, n_own - s0), keep ? s0 : 0, keep && nsub == 1, s0 == 0, true);
  }
  // a warp holds one half's rows (ATT_SLOTS is a multiple of 32)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float v = NEG_INF;
#pragma unroll
    for (int u = 0; u < RH; ++u)
      if (half * RH + u == r) v = mx[u];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[warp * RT + r] = v;
  }
  __syncthreads();
  if (tid < RT) {
    float m = NEG_INF;
    for (int w = 0; w < ATT_WARPS; ++w) m = fmaxf(m, red[w * RT + tid]);
    lmax[tid] = m;
  }
  cluster.sync();  // every block's lmax is written
  if (tid < RT) {
    float m[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      m[c] = c < C ? *cluster.map_shared_rank(lmax + tid, c) : NEG_INF;
    float v = m[0];
#pragma unroll
    for (int c = 1; c < CMAX; ++c) v = fmaxf(v, m[c]);
    rowm[tid] = v;
  }
  __syncthreads();

  // ---- pass 2: probabilities on the grid, their sum, and p * 2^-vf @ v ----
  float acc[RT][DPL], lsum[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    lsum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  for (int s0 = 0; s0 < n_own; s0 += ATT_SLOTS) {
    const int tn = min(ATT_SLOTS, n_own - s0);
    const int pb = keep ? s0 : 0;
    if (!keep) {  // keys and values restaged, the scores recomputed bit for bit
      __syncthreads();
      score(s0, tn, 0, true, false, false);
    } else if (nsub > 1) {
      __syncthreads();
      stage_rows(Vs, nullptr, ldk, vbase, nullptr, m_st, t_lo + s0, tn, hdm, packed, vec);
    }
    __syncthreads();
    for (int e = tid; e < tn * RT; e += ATT_NT) {
      const int i = pb + e / RT, r = e % RT;
      float p = 0.f;
      if (r < rows && visible(tps[i], qp[r], window)) {
        p = expf(P[i * RT + r] - rowm[r]);
        if (pf) p = floorf(p * pfs + 0.5f) / pfs;
      }
      P[i * RT + r] = p;
      PV[i * RT + r] = p * vss[i];
    }
    __syncthreads();
    // warp w takes the contiguous share [lo, hi) of the staged slots
    const int per = (tn + ATT_WARPS - 1) / ATT_WARPS;
    const int lo = warp * per, hi = min(tn, lo + per);
#pragma unroll 2
    for (int i = lo; i < hi; ++i) {
      const int8_t* vr = Vs + i * ldk;
      float v[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        v[e] = d < hd ? static_cast<float>(vr[d]) : 0.f;
      }
      const float4* p4 = reinterpret_cast<const float4*>(P + (pb + i) * RT);
      const float4* pv4 = reinterpret_cast<const float4*>(PV + (pb + i) * RT);
#pragma unroll
      for (int r4 = 0; r4 < RT / 4; ++r4) {
        const float4 p = p4[r4], pv = pv4[r4];
        const float ps[4] = {p.x, p.y, p.z, p.w}, pvs[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = 4 * r4 + u;
          lsum[r] += ps[u];
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            if (32 * e < hd) acc[r][e] = fmaf(pvs[u], v[e], acc[r][e]);
        }
      }
    }
  }
  // the warps' partials, summed in warp order (they reuse P and PV's space)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) wpart[(warp * RT + r) * hd + d] = acc[r][e];
    }
    if (lane == 0) wl[warp * RT + r] = lsum[r];
  }
  __syncthreads();
  for (int idx = tid; idx < RT * hd; idx += ATT_NT) {
    float a = wpart[idx];
#pragma unroll
    for (int w = 1; w < ATT_WARPS; ++w) a += wpart[w * RT * hd + idx];
    part[idx] = a;
  }
  if (tid < RT) {
    float l = wl[tid];
#pragma unroll
    for (int w = 1; w < ATT_WARPS; ++w) l += wl[w * RT + tid];
    lpart[tid] = l;
  }
  cluster.sync();  // every block's partials are written
  // the blocks' partials in rank order; block c combines every C-th output, every
  // remote load before the first add
  for (int idx = rank * ATT_NT + tid; idx < rows * hd; idx += C * ATT_NT) {
    const int r = idx / hd, d = idx - r * hd;
    float pa[CMAX], pl[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      pa[c] = c < C ? *cluster.map_shared_rank(part + idx, c) : 0.f;
      pl[c] = c < C ? *cluster.map_shared_rank(lpart + r, c) : 0.f;
    }
    float a = pa[0], l = pl[0];
#pragma unroll
    for (int c = 1; c < CMAX; ++c)
      if (c < C) {
        a += pa[c];
        l += pl[c];
      }
    const int rg = r0 + r, s = rg / G, h = kvh * G + rg % G;
    out[(static_cast<size_t>(b * S + s) * H + h) * hd + d] = a / fmaxf(l, 1e-20f);
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <int RT, int DPL>
int launch_attention(const float* qh, const int8_t* km, const int8_t* vm, long long m_sb,
                     long long m_st, long long m_skv, const int8_t* kf,
                     const int8_t* vf, long long f_sb, long long f_st, long long f_skv,
                     const int* qpos, const int* tpos, long long tp_sb,
                     long long tp_st, const float* pf, float* out, int B, int S,
                     int H, int KV, int W, int hd, int packed, int vec, int window,
                     float scale, int cluster, cudaStream_t stream) {
  const int chunk = (W + cluster - 1) / cluster;
  // keep the block's scores where they fit, else recompute them in pass 2
  size_t smem = attention_smem_bytes(hd, RT, chunk);
  auto kernel = kv_attention_kernel<RT, DPL, false>;
  if (smem > SMEM_MAX) {
    smem = attention_smem_bytes(hd, RT, ATT_SLOTS);
    kernel = kv_attention_kernel<RT, DPL, true>;
  }
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntiles = (S * (H / KV) + RT - 1) / RT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KV, B * ntiles);
  cfg.blockDim = dim3(ATT_NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, qh, km, vm, m_sb, m_st, m_skv,
                         kf, vf, f_sb, f_st, f_skv, qpos, tpos, tp_sb, tp_st, pf, out,
                         S, H, KV, W, hd, packed, vec, window, scale, ntiles, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [R, hd] float32 (bf16 = 0) or bfloat16 (bf16 = 1), rows ldx elements apart,
// the last axis contiguous -> q [R, hd] int8 contiguous, f [R] int8.
extern "C" int kv_quantize_launch(const void* x, long long ldx, int8_t* q, int8_t* f,
                                  int R, int hd, int bits, int bf16, void* stream) {
  if (R <= 0 || hd <= 0 || bits < 2 || bits > 8) return cudaErrorInvalidValue;
  StoreArgs a = {};
  a.side[0] = {x, ldx, 0, 0, q, hd, 0, 0, f, 1, 0, 0};
  a.slot = nullptr;
  a.B = R;
  a.S = a.KV = a.W = 1;
  a.hd = hd;
  a.nibble = 0;
  a.qmax = static_cast<float>((1 << (bits - 1)) - 1);
  return launch_store(a, 1, bf16, static_cast<cudaStream_t>(stream));
}

// The serving store of one layer.  k, v: rows [B, S, KV, hd] float32 (bf16 = 0)
// or bfloat16 (bf16 = 1), through strides (k_sb, k_ss, k_skv) and (v_sb, v_ss,
// v_skv) in elements, the last axis contiguous; slot: [B, S] int64 contiguous;
// mk, mv: the mantissa rings [B, W, KV, hdm] (hdm = hd, or hd / 2 nibble pairs
// when nibble = 1), one set of byte strides (m_sb, m_sw, m_skv), the last axis
// contiguous; ek, ev: the exponent rings [B, W, KV], strides (e_sb, e_sw, e_skv).
// Rows whose slot lies outside 0..W-1 are dropped.
extern "C" int kv_store_launch(const void* k, long long k_sb, long long k_ss,
                               long long k_skv, const void* v, long long v_sb,
                               long long v_ss, long long v_skv, const long long* slot,
                               int8_t* mk, int8_t* mv, long long m_sb, long long m_sw,
                               long long m_skv, int8_t* ek, int8_t* ev, long long e_sb,
                               long long e_sw, long long e_skv, int B, int S, int KV,
                               int hd, int W, int nibble, int bits, int bf16,
                               void* stream) {
  if (bits < 2 || bits > 8 || slot == nullptr) return cudaErrorInvalidValue;
  StoreArgs a = {};
  a.side[0] = {k, k_sb, k_ss, k_skv, mk, m_sb, m_sw, m_skv, ek, e_sb, e_sw, e_skv};
  a.side[1] = {v, v_sb, v_ss, v_skv, mv, m_sb, m_sw, m_skv, ev, e_sb, e_sw, e_skv};
  a.slot = slot;
  a.B = B;
  a.S = S;
  a.KV = KV;
  a.hd = hd;
  a.W = W;
  a.nibble = nibble != 0;
  a.qmax = static_cast<float>((1 << (bits - 1)) - 1);
  return launch_store(a, 2, bf16, static_cast<cudaStream_t>(stream));
}

// q [R, hd] int8 contiguous, f [R] int8 -> out [R, hd] fp32 contiguous.  vec = 1
// when hd % 16 == 0 and q and out are 16-byte aligned.
extern "C" int kv_dequant_launch(const int8_t* q, const int8_t* f, float* out, int R,
                                 int hd, int vec, void* stream) {
  if (R <= 0 || hd <= 0 || (vec && hd % 16)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long values = static_cast<long long>(R) * hd;
  if (vec) {
    const int v = dequant_vecs(values), blocks = dequant_blocks(values, v);
    const bool narrow = values < (1LL << 31);
#define KV_DEQUANT_VEC_LAUNCH(V)                                                       \
  if (narrow)                                                                          \
    kv_dequant_vec_kernel<unsigned, V><<<blocks, DQ_THREADS, 0, st>>>(                 \
        q, f, out, static_cast<unsigned>(R), hd / 16);                                 \
  else                                                                                 \
    kv_dequant_vec_kernel<long long, V><<<blocks, DQ_THREADS, 0, st>>>(q, f, out, R,   \
                                                                       hd / 16)
    switch (v) {
      case 8: KV_DEQUANT_VEC_LAUNCH(8); break;
      case 4: KV_DEQUANT_VEC_LAUNCH(4); break;
      case 2: KV_DEQUANT_VEC_LAUNCH(2); break;
      default: KV_DEQUANT_VEC_LAUNCH(1);
    }
#undef KV_DEQUANT_VEC_LAUNCH
  } else {
    constexpr int kThreads = 256;
    const int blocks = static_cast<int>(
        std::min<long long>((values + kThreads - 1) / kThreads, 132LL * 16));
    kv_dequant_scalar_kernel<<<blocks, kThreads, 0, st>>>(q, f, out, R, hd);
  }
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on `blocks` blocks of `threads` (what kv_dequant_launch runs
// at a shape: kv_dequant_grid), for the launch floor beside its times.
extern "C" int kv_empty_launch(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024) return cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// kv_dequant_launch's grid for [R, hd] on the 16-byte path: blocks, threads,
// and the pieces a lane.
extern "C" void kv_dequant_grid(int R, int hd, int* blocks, int* threads, int* vecs) {
  const long long values = static_cast<long long>(R) * hd;
  *vecs = dequant_vecs(values);
  *blocks = dequant_blocks(values, *vecs);
  *threads = DQ_THREADS;
}

// qh [B, S, H, hd] fp32 contiguous; km / vm int8 mantissas [B, W, KV, hdm] read
// through (m_sb, m_st, m_skv) with the last axis contiguous (hdm = hd, or hd / 2
// when packed); vec = 1 when the mantissa rows and strides are 16-byte aligned and
// hdm % 16 == 0; kf / vf int8 exponents [B, W, KV] through (f_sb, f_st, f_skv);
// qpos [B, S] int32 contiguous; tpos [B, W] int32 through (tp_sb, tp_st), negative
// = empty slot; pf: device pointer to the fp32 probs exponent, or null for no
// probs grid; window < 0 for none; cluster: blocks sharing one ring (1..8, chosen
// from W alone by the caller).  out [B, S, H, hd] fp32 contiguous.  Any W: a
// block whose slots' scores do not fit in shared memory recomputes them.
extern "C" int kv_attention_launch(const float* qh, const int8_t* km, const int8_t* vm,
                                   long long m_sb, long long m_st, long long m_skv,
                                   const int8_t* kf, const int8_t* vf,
                                   long long f_sb, long long f_st, long long f_skv,
                                   const int* qpos, const int* tpos,
                                   long long tp_sb, long long tp_st, const float* pf,
                                   float* out, int B, int S, int H, int KV, int W,
                                   int hd, int packed, int vec, int window, float scale,
                                   int cluster, void* stream) {
  if (hd <= 0 || hd > ATT_HDMAX || hd % 2 || KV <= 0 || H % KV || W <= 0 || B <= 0 ||
      S <= 0 || cluster < 1 || cluster > 8)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KV_ATTENTION_LAUNCH(RT, DPL)                                                    \
  return launch_attention<RT, DPL>(qh, km, vm, m_sb, m_st, m_skv, kf, vf, f_sb, f_st, f_skv, \
                                   qpos, tpos, tp_sb, tp_st, pf, out, B, S, H, KV, W, hd,   \
                                   packed, vec, window, scale, cluster, st)
  const bool small = S * (H / KV) <= 8;
  if (hd <= 64) {
    if (small) KV_ATTENTION_LAUNCH(8, 2);
    KV_ATTENTION_LAUNCH(16, 2);
  }
  if (small) KV_ATTENTION_LAUNCH(8, 4);
  KV_ATTENTION_LAUNCH(16, 4);
#undef KV_ATTENTION_LAUNCH
}
