// Shared machinery of the banded short-read kernels K2 (nw.cu) and K3
// (swg.cu) for NVIDIA Hopper (sm_90a).
//
// Both replace a Pallas TPU kernel that lays the DP band of a pair over L
// lanes, b = v - h + C (aim_tpu/ops/nw_pallas.py, swg_pallas.py).  Here one
// warp owns one pair; its L lanes are spread over the warp's 32 threads,
// LPT = max(1, L/32) lanes a thread, band lane b = lane + 32*j in slot j
// (for L < 32 the threads past L compute values nothing reads).  Moving a
// row by d lanes is a pair of warp shuffles; a truncated scan is log2 of
// them.  Every read of another lane is masked to [0, L): a pair's records
// depend on nothing but the pair, so no warp shares state with another.
//
// Per pair the kernels keep one bit a band lane a row for each code
// plane (NW: 2 code bits + is-match; SWG: 4 code bits + is-match), as
// 32-bit words built with __ballot_sync: R rows x planes x max(1, L/32)
// words.  They sit in shared memory while the block's share fits in 48 KB
// (1,344 B a pair for NW at the 100 bp config), else in a global scratch
// the wrapper allocates.  The walk is sequential per pair: every thread of
// the warp runs it on the same scalars (reads are broadcasts), the warp
// together reads up to 32 rows of the is-match plane for a match run with
// one ballot, and lane 0 writes the record.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aimband {

constexpr int kInf = 1 << 20;  // in-band "+infinity" of the reference
constexpr int kWarps = 4;      // pairs a block (WARPS in ops/nw.py)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOpM = 0, kOpX = 1, kOpI = 2, kOpD = 3;

struct BandParams {
  const uint8_t *pats, *txts;
  const int32_t *plens, *tlens;
  int16_t *rec;        // [n][NRL] packed runs
  uint32_t *scratch;   // [n][R][planes][words] when the planes are global
  long n;
  int width;           // bytes per sequence row
  int packed;          // 2-bit codes, 4 a byte, low bits first
  int R, C, L, NRL, DS;
  int words;           // plane words a row: max(1, L/32)
  int planes;          // code planes a cell
  int seq_bytes;       // staged bytes of one sequence: R rounded up to 16
  int warp_bytes;      // shared memory a warp
  int backtrace, check_ovf, planes_smem;
  // NW costs
  int gi, gd, x;
  // SWG costs and cell limits
  int match, mis, go, ge, ms, cmax, margin;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of one warp: pattern and text one code a byte, then the
// code planes when they are kept on chip (ops/nw.py::warp_smem_bytes).
inline long warp_bytes(const BandParams &P, bool planes_in_smem) {
  long b = 2L * round16(P.R);
  if (planes_in_smem && P.backtrace) b += 4L * P.R * P.planes * P.words;
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// v[j] with a warp-uniform j; `fill` when j lies outside [0, LPT).
template <int LPT>
__device__ __forceinline__ int pick(const int (&v)[LPT], int j, int fill) {
  int r = fill;
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    if (k == j) r = v[k];
  return r;
}

// out[j] = the value at band lane b + d (b = lane + 32*j), or `fill` where
// b + d lies outside [0, L).  d is warp-uniform; out must not alias v.
template <int LPT>
__device__ __forceinline__ void lane_shift(const int (&v)[LPT],
                                           int (&out)[LPT], int d, int fill,
                                           int L, int lane) {
  const int q = d >> 5;  // floor(d / 32)
  const int r = d & 31;
  const int src = (lane + r) & 31;
  const bool wrap = lane + r >= 32;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int a = __shfl_sync(kFull, pick(v, j + q, fill), src);
    const int c = __shfl_sync(kFull, pick(v, j + q + 1, fill), src);
    const int sb = lane + 32 * j + d;
    out[j] = (sb < 0 || sb >= L) ? fill : (wrap ? c : a);
  }
}

// The value at band lane pos (warp-uniform, in [0, L)), on every thread.
template <int LPT>
__device__ __forceinline__ int lane_value(const int (&v)[LPT], int pos) {
  return __shfl_sync(kFull, pick(v, pos >> 5, 0), pos & 31);
}

// Truncated prefix min: after steps s = 1, 2, 4, ... <= DS a lane holds the
// min over the DS + 1 lanes ending at it, clipped at lane 0 -- the
// reference's masked-roll scan (nw_pallas.py:231-240), not a full prefix.
template <int LPT>
__device__ __forceinline__ void trunc_min(int (&v)[LPT], int DS, int L,
                                          int lane) {
  for (int s = 1; s <= DS && s < L; s *= 2) {
    int t[LPT];
    lane_shift(v, t, -s, kInf, L, lane);
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = min(v[j], t[j]);
  }
}

// Stage the pair's pattern and text into shared memory, one code a byte:
// raw bytes, or the 2-bit codes of packed rows; zero past the input width.
__device__ __forceinline__ void stage_seqs(const BandParams &P, long pair,
                                           uint8_t *sp, uint8_t *st,
                                           int lane) {
  const uint8_t *gp = P.pats + pair * P.width;
  const uint8_t *gt = P.txts + pair * P.width;
  for (int j = lane; j < P.seq_bytes; j += 32) {
    uint8_t a = 0, b = 0;
    if (P.packed) {
      const int byte = j >> 2, sh = 2 * (j & 3);
      if (byte < P.width) {
        a = (gp[byte] >> sh) & 3;
        b = (gt[byte] >> sh) & 3;
      }
    } else if (j < P.width) {
      a = gp[j];
      b = gt[j];
    }
    sp[j] = a;
    st[j] = b;
  }
}

// Write one row of code planes: bit `p` of codes[j] into plane p, and the
// is-match flags into plane `nbits`.  Only band lanes < L are kept.
template <int LPT>
__device__ __forceinline__ void store_planes(uint32_t *row,
                                             const int (&code)[LPT],
                                             const bool (&ism)[LPT], int nbits,
                                             int words, int L, int lane) {
  const unsigned lmask = L >= 32 ? kFull : ((1u << L) - 1u);
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    for (int p = 0; p < nbits; ++p) {
      const unsigned w = __ballot_sync(kFull, (code[j] >> p) & 1);
      if (lane == 0) row[p * words + j] = w & lmask;
    }
    const unsigned m = __ballot_sync(kFull, ism[j]);
    if (lane == 0) row[nbits * words + j] = m & lmask;
  }
}

__device__ __forceinline__ int plane_bit(const uint32_t *row, int p, int words,
                                         int b) {
  return (row[p * words + (b >> 5)] >> (b & 31)) & 1;
}

// Consecutive is-match rows at band lane b from row hm1 (0-based) down to
// the first row of its 32-row word: the reference's ctz on its descending
// packed is-match word (nw_pallas.py:383-393).  All threads of the warp
// call it; thread t reads row hm1 - t.
__device__ __forceinline__ int match_run(const uint32_t *planes, int stride,
                                         int ism_plane, int words, int hm1,
                                         int b, int lane) {
  const int pos = hm1 & 31;
  bool ok = false;
  if (lane <= pos)
    ok = plane_bit(planes + (long)(hm1 - lane) * stride, ism_plane, words, b);
  const unsigned bits = __ballot_sync(kFull, ok);
  const unsigned u = ~bits & (pos == 31 ? kFull : ((1u << (pos + 1)) - 1u));
  return u == 0 ? pos + 1 : __ffs(u) - 1;
}

// Run emission (reference emit_merge / emit_flush, nw_pallas.py:317-343).
// The top run stays in (top_op, top_len) and is written to lane rc + 1 when
// the next run is pushed; a merge needs top_len + length <= 4095 and
// rc < NRL - 1; rc has no floor (a pair that runs out of lanes is flagged).
// Every thread keeps the same state; only `writer` stores.
struct Runs {
  int16_t *rec;
  int NRL, rc, top_op, top_len;
  bool writer;

  __device__ void emit(bool mask, int op, int length) {
    const bool doit = mask && length > 0;
    const bool can = doit && top_len > 0 && top_op == op &&
                     top_len + length <= 4095 && rc < NRL - 1;
    if (can) top_len += length;
    if (doit && !can) {
      if (writer && top_len > 0 && rc + 1 >= 2 && rc + 1 <= NRL - 1)
        rec[rc + 1] = (int16_t)((top_op << 12) | top_len);
      top_op = op;
      top_len = min(length, 4095);
      rc -= 1;
    }
  }

  __device__ void flush() {
    if (writer && top_len > 0 && rc + 1 <= NRL - 1 && rc + 1 >= 2)
      rec[rc + 1] = (int16_t)((top_op << 12) | top_len);
  }
};

// Record lanes 0 and 1: rc | flag << 8 (int32, wrapped to int16) and the
// score clipped to int16.
__device__ __forceinline__ void finish_record(int16_t *rec, int rc, bool flag,
                                              int score, int lane) {
  if (lane == 0) {
    rec[0] = (int16_t)(rc | ((int)flag << 8));
    rec[1] = (int16_t)max(-32768, min(score, 32767));
  }
}

// Host side: validate, size shared memory and launch `kern` at the LPT its
// L needs.  Returns cudaGetLastError() after the launch (0 on success).
template <typename K1, typename K2, typename K4>
inline int launch(BandParams &P, K1 k1, K2 k2, K4 k4, void *stream) {
  if (P.n <= 0) return 0;
  const bool l_ok = P.L == 8 || P.L == 16 || P.L == 32 || P.L == 64 ||
                    P.L == 128;
  if (!l_ok || P.R <= 0 || P.width <= 0 || P.C < 0 || 2 * P.C + 1 > P.L ||
      P.NRL < 2 || P.NRL > P.L || P.DS < 0 ||
      (P.backtrace && !P.planes_smem && P.scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  P.words = P.L > 32 ? P.L / 32 : 1;
  P.seq_bytes = round16(P.R);
  P.warp_bytes = (int)warp_bytes(P, P.planes_smem != 0);
  const size_t smem = (size_t)P.warp_bytes * kWarps;
  const long blocks = (P.n + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (P.L <= 32) {
    e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    k1<<<(unsigned)blocks, 32 * kWarps, smem, s>>>(P);
  } else if (P.L == 64) {
    e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    k2<<<(unsigned)blocks, 32 * kWarps, smem, s>>>(P);
  } else {
    e = cudaFuncSetAttribute(k4, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    k4<<<(unsigned)blocks, 32 * kWarps, smem, s>>>(P);
  }
  return (int)cudaGetLastError();
}

}  // namespace aimband
